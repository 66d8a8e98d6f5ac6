// Same-host measured baseline: a faithful C++17 + OpenMP twin of the
// reference Fortran engine `dtt_dmrgg` (dmrgg.f90:11-1050).
//
// Purpose (BASELINE.md / SURVEY.md §6): the reference publishes no
// throughput numbers and this image has no Fortran compiler, so the
// baseline the JAX framework is compared against must be MEASURED by an
// equivalent native implementation on the same host.  This program
// re-implements the reference algorithm step by step — greedy DMRG cross
// with lottery-seeded rook pivoting (dmrgg.f90:410-582), the two-threshold
// pivot acceptance (dmrgg.f90:598-600), the compact growing-LU bordered
// inverse (lr.f90:98-215, incremental application with from=r+1 as in
// dmrgg.f90:701-702), per-sweep quadrature value + error reporting
// (dmrgg.f90:969-1008), the strike-3 stop (dmrgg.f90:1010-1019), and the
// final LU application dtt_lua (dmrgg.f90:1169-1258) — in single-process
// form with OpenMP-parallel integrand evaluation exactly where the
// reference has !$OMP PARALLEL DO (same-host single/multi-thread is the
// honest comparable; the MPI layer shards bonds across nodes, which this
// host does not have).
//
// Integrands: Ising C/D/E (test_crs_ising.f90:176-218), product Gaussian
// (test_crs_stdnorm.f90), equicorrelated MVN (mvn_pdf.f90:15-111), and
// the COS coefficient tensor (coefficients.f90:33-65 with s_vectors.f90 +
// funcs.f90).  Quadrature: Gauss-Legendre by Newton iteration on the
// Legendre recurrence (quad.f90:97-131).
//
// This is an independent C++ implementation written from the algorithm,
// not a transliteration: 0-based indexing, std containers, flat
// row-major cores.
//
// Output: per-sweep progress lines mirroring the reference's format, and
// one final JSON line {"config":..., "evals_per_sec":..., ...} consumed
// by run_baseline.py to produce baseline/measured.json.

#include <algorithm>
#include <array>
#include <chrono>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <random>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

using std::size_t;
using std::vector;

static double now_s() {
    using namespace std::chrono;
    return duration<double>(steady_clock::now().time_since_epoch()).count();
}

// ---------------------------------------------------------------------------
// Gauss-Legendre nodes/weights on [-1,1]: Newton iteration on the Legendre
// three-term recurrence (the reference's lgwt, quad.f90:97-131).
static void lgwt(int n, vector<double>& x, vector<double>& w) {
    x.assign(n, 0.0);
    w.assign(n, 0.0);
    const double pi = std::acos(-1.0);
    for (int i = 0; i < (n + 1) / 2; ++i) {
        double t = std::cos(pi * (i + 0.75) / (n + 0.5));
        double dp = 0.0;
        for (int it = 0; it < 100; ++it) {
            double p0 = 1.0, p1 = t;
            for (int k = 2; k <= n; ++k) {
                double p2 = ((2.0 * k - 1.0) * t * p1 - (k - 1.0) * p0) / k;
                p0 = p1;
                p1 = p2;
            }
            dp = n * (t * p1 - p0) / (t * t - 1.0);
            double dt = p1 / dp;
            t -= dt;
            if (std::abs(dt) < 1e-15) break;
        }
        x[i] = -t;
        x[n - 1 - i] = t;
        w[i] = w[n - 1 - i] = 2.0 / ((1.0 - t * t) * dp * dp);
    }
}

// ---------------------------------------------------------------------------
// Integrand protocol: f(ind) with ind[0..d-1] 0-based mode indices.
struct Problem {
    int d = 0;
    int n = 0;                       // uniform mode size
    vector<double> quad_w;           // per-mode rank-1 quadrature entries
    double truth = 0.0;              // analytic value (0 = unknown)
    std::function<double(const int*)> fun;
};

// Ising C/D/E integrand (test_crs_ising.f90:176-218): node ratios uij over
// nested products, telescoping prefix/suffix sums, per-dimension weights.
struct IsingData {
    int kind = 1;                    // 1=C(2b) 2=D(2ab) 3=E(2a)
    int d = 0;
    vector<double> nodes, weights;   // on [0,1]; weights pre-scaled by val
};

static double ising_eval(const IsingData& g, const int* ind) {
    const int d = g.d;
    double f = 2.0;
    if (g.kind == 2 || g.kind == 3) {           // a-term
        double a = 1.0;
        for (int i = -1; i < d; ++i) {          // i over 0..m in the ref (m=d here)
            double uij = 1.0;
            for (int j = i + 1; j < d; ++j) {
                uij *= g.nodes[ind[j]];
                double r = (uij - 1.0) / (uij + 1.0);
                a *= r * r;
            }
        }
        f *= a;
    }
    if (g.kind == 1 || g.kind == 2) {           // b-term
        double v = 1.0, w = 1.0, vk = 1.0, wk = 1.0;
        for (int i = 0; i < d; ++i) {
            vk *= g.nodes[ind[d - 1 - i]];
            wk *= g.nodes[ind[i]];
            v += vk;
            w += wk;
        }
        f /= v * w;
    }
    for (int i = 0; i < d; ++i) f *= g.weights[ind[i]];
    return f;
}

// ---------------------------------------------------------------------------
// Small dense helpers for the MVN covariance (mvn_pdf.f90:85-111 uses
// dgetrf/dgetri; plain Gaussian elimination is plenty at d<=16).
static double invert_and_det(vector<double>& a, int n) {
    vector<double> inv(n * n, 0.0);
    for (int i = 0; i < n; ++i) inv[i * n + i] = 1.0;
    double det = 1.0;
    for (int c = 0; c < n; ++c) {
        int p = c;
        for (int r = c + 1; r < n; ++r)
            if (std::abs(a[r * n + c]) > std::abs(a[p * n + c])) p = r;
        if (p != c) {
            for (int k = 0; k < n; ++k) {
                std::swap(a[p * n + k], a[c * n + k]);
                std::swap(inv[p * n + k], inv[c * n + k]);
            }
            det = -det;
        }
        det *= a[c * n + c];
        double s = 1.0 / a[c * n + c];
        for (int k = 0; k < n; ++k) {
            a[c * n + k] *= s;
            inv[c * n + k] *= s;
        }
        for (int r = 0; r < n; ++r) {
            if (r == c) continue;
            double f = a[r * n + c];
            if (f == 0.0) continue;
            for (int k = 0; k < n; ++k) {
                a[r * n + k] -= f * a[c * n + k];
                inv[r * n + k] -= f * inv[c * n + k];
            }
        }
    }
    a = inv;
    return det;
}

struct MvnData {
    int d = 0;
    vector<double> mu, icov, nodes;  // nodes on the integration box
    double norm = 0.0;               // 1/sqrt((2 pi)^d det)
};

static double mvn_eval(const MvnData& g, const int* ind) {
    double q = 0.0;
    vector<double> x(g.d);
    for (int i = 0; i < g.d; ++i) x[i] = g.nodes[ind[i]] - g.mu[i];
    for (int i = 0; i < g.d; ++i) {
        double s = 0.0;
        for (int j = 0; j < g.d; ++j) s += g.icov[i * g.d + j] * x[j];
        q += x[i] * s;
    }
    return g.norm * std::exp(-0.5 * q);
}

// COS coefficient tensor (coefficients.f90:33-65): 2/(b-a)^d *
// sum_s Re[ exp(-i a sum t) phi(t_s) ], t_j = pi s_j (ind_j)/(b-a),
// phi = Gaussian chf exp(i t.mu - t.Sigma t/2) (funcs.f90:8-26), s over
// all 2^(d-1) sign vectors with s_0 = +1 (s_vectors.f90:7-29).
struct CosData {
    int d = 0;
    double a = 0.0, b = 0.0;
    vector<double> mu, cov;          // d, d*d
};

static double cos_eval(const CosData& g, const int* ind) {
    const int d = g.d;
    const double pi = std::acos(-1.0);
    const double ba = g.b - g.a;
    double acc = 0.0;
    vector<double> t(d);
    for (int sv = 0; sv < (1 << (d - 1)); ++sv) {
        for (int j = 0; j < d; ++j) {
            double sj = (j == 0) ? 1.0 : ((sv >> (j - 1)) & 1 ? -1.0 : 1.0);
            t[j] = pi * sj * ind[j] / ba;  // ind is 0-based = (k-1) in ref
        }
        double tmu = 0.0, tst = 0.0, tsum = 0.0;
        for (int i = 0; i < d; ++i) {
            tmu += t[i] * g.mu[i];
            tsum += t[i];
            double s = 0.0;
            for (int j = 0; j < d; ++j) s += g.cov[i * d + j] * t[j];
            tst += t[i] * s;
        }
        // Re[ exp(-i a tsum) exp(i tmu - tst/2) ]
        acc += std::exp(-0.5 * tst) * std::cos(tmu - g.a * tsum);
    }
    double scale = 2.0 / std::pow(ba, d);
    return scale * acc;
}

// ---------------------------------------------------------------------------
// TT core storage: flat row-major (rl, n, rr) blocks that are re-shaped as
// the rank grows (the reference reallocates per accept, dmrgg.f90:676-713;
// a std::vector resize is the same bookkeeping).
struct Core {
    int rl = 1, n = 0, rr = 1;
    vector<double> a;                // size rl*n*rr, index (i*n + j)*rr + q
    double& at(int i, int j, int q) { return a[(size_t(i) * n + j) * rr + q]; }
    double at(int i, int j, int q) const { return a[(size_t(i) * n + j) * rr + q]; }
    void resize(int rl_, int n_, int rr_) {
        rl = rl_; n = n_; rr = rr_;
        a.assign(size_t(rl) * n * rr, 0.0);
    }
};

// Growing-LU packed inverse, the reference's inv(p)%p layout
// (dmrgg.f90:649-660): block for pivot step p (1-based) spans entries
// (p-1)^2 .. p^2-1 (0-based): first p-1 entries = col-factor values at the
// new pivot's row (the "l" border), next p-1 = row-factor values at the new
// pivot's column (the "u" border), last = the residual pivot value.
struct GrowInv {
    vector<double> g;                // packed, length r^2 for rank r
    int r = 0;
    void init_rank1(double pivot) { g.assign(1, pivot); r = 1; }
    void append(const vector<double>& lrow, const vector<double>& ucol,
                double pivot) {
        // lrow: col-factor at (ii,jj), length r; ucol: row-factor at
        // (kk,qq), length r (dmrgg.f90:653-660)
        g.insert(g.end(), lrow.begin(), lrow.end());
        g.insert(g.end(), ucol.begin(), ucol.end());
        g.push_back(pivot);
        ++r;
    }
    // d2_lual (lr.f90:124-142): col(m, r) <- col * inv(L-part), columns
    // from `from` (1-based) onward: col(:,p) = (col(:,p) - col(:,1:p-1) *
    // u_border(p)) / pivot(p)
    void apply_left(double* col, int m, int from1 = 1) const {
        for (int p = from1; p <= r; ++p) {
            const double* ub = &g[size_t(p) * p - p + 1 - 1];  // g(p^2-p+1..)
            double inv_piv = 1.0 / g[size_t(p) * p - 1];
            double* cp = col + size_t(p - 1) * m;
            for (int s = 0; s < p - 1; ++s) {
                const double* cs = col + size_t(s) * m;
                double u = ub[s];
                if (u == 0.0) continue;
                for (int t = 0; t < m; ++t) cp[t] -= cs[t] * u;
            }
            for (int t = 0; t < m; ++t) cp[t] *= inv_piv;
        }
    }
    // d2_luar (lr.f90:143-154): row(r, n) rows from `from` onward:
    // row(p,:) -= l_border(p)^T * row(1:p-1,:)   (no pivot division)
    void apply_right(double* row, int n, int from1 = 1) const {
        for (int p = from1; p <= r; ++p) {
            const double* lb = &g[size_t(p - 1) * (p - 1)];  // g(p^2-2p+2..)
            double* rp = row + size_t(p - 1) * n;
            for (int s = 0; s < p - 1; ++s) {
                const double* rs = row + size_t(s) * n;
                double l = lb[s];
                if (l == 0.0) continue;
                for (int t = 0; t < n; ++t) rp[t] -= l * rs[t];
            }
        }
    }
};

// ---------------------------------------------------------------------------
// The engine state (single process: own = all bonds).
struct Engine {
    int d = 0, n = 0, piv = 1, maxrank = 20;
    double accuracy = 0.0;
    double truth = 0.0;
    const Problem* prob = nullptr;

    vector<Core> u;                  // d cores (raw fibers, like arg%u)
    vector<Core> colf, rowf;         // col factors (per core p: C Ahat^-1),
                                     // row factors (per core p+1: Ahat^-1 R)
    vector<GrowInv> inv;             // per bond
    vector<vector<std::array<int, 4>>> vip;  // per bond: (i, j, k, q) 0-based
    vector<int> r;                   // bond ranks, length d+1, r[0]=r[d]=1
    int64_t neval = 0;
    std::mt19937_64 rng{0x5EED};

    // dmrgg_fun (dmrgg.f90:1053-1078): reconstruct the full multi-index by
    // walking the vip chains left from bond b via (link,i,j) and right via
    // (k,link).
    void full_index(int i, int j, int k, int q, int b, int* ind) const {
        int t = i;
        for (int s = b - 1; s >= 0; --s) {
            ind[s] = vip[s][t][1];
            t = vip[s][t][0];
        }
        ind[b] = j;
        ind[b + 1] = k;
        t = q;
        for (int s = b + 1; s < d - 1; ++s) {
            ind[s + 1] = vip[s][t][2];
            t = vip[s][t][3];
        }
    }

    double feval(int i, int j, int k, int q, int b) const {
        int ind[2048];  // tt_size bound (tt.f90:16)
        full_index(i, j, k, q, b, ind);
        return prob->fun(ind);
    }

    struct SweepStats {
        double amax = 0.0, pivotmax = -1.0, pivotmin = -1.0;
    };

    double run() {
        const double t0 = now_s();
        // --- initial pivot search over shifted diagonals (dmrgg.f90:151-217)
        const int snum = 8;
        double amax = 0.0;
        int best_k = 0, best_s = 0;
        {
            vector<double> vals(size_t(snum) * n);
#pragma omp parallel for collapse(2)
            for (int s = 0; s < snum; ++s)
                for (int k = 0; k < n; ++k) {
                    int ind[2048];  // tt_size bound (tt.f90:16)
                    for (int p = 0; p < d; ++p) ind[p] = (k + s * p) % n;
                    vals[size_t(s) * n + k] = prob->fun(ind);
                }
            neval += int64_t(snum) * n;
            for (int s = 0; s < snum; ++s)
                for (int k = 0; k < n; ++k)
                    if (std::abs(vals[size_t(s) * n + k]) > amax) {
                        amax = std::abs(vals[size_t(s) * n + k]);
                        best_s = s;
                        best_k = k;
                    }
        }
        vector<int> ind0(d);
        for (int p = 0; p < d; ++p) ind0[p] = (best_k + best_s * p) % n;

        r.assign(d + 1, 1);
        vip.assign(d - 1, {});
        for (int b = 0; b < d - 1; ++b)
            vip[b].push_back({0, ind0[b], ind0[b + 1], 0});

        // --- initial rank-1 cross: one fiber per core (dmrgg.f90:220-248)
        u.assign(d, {});
        for (int c = 0; c < d; ++c) {
            u[c].resize(1, n, 1);
#pragma omp parallel for
            for (int j = 0; j < n; ++j) {
                int jb = std::min(c, d - 2);        // bond owning this fiber
                // core c fiber: indices fixed at the initial pivot except
                // mode c
                int ind[2048];  // tt_size bound (tt.f90:16)
                for (int p = 0; p < d; ++p) ind[p] = ind0[p];
                ind[c] = j;
                u[c].at(0, j, 0) = prob->fun(ind);
                (void)jb;
            }
            neval += n;
            for (int j = 0; j < n; ++j)
                amax = std::max(amax, std::abs(u[c].at(0, j, 0)));
        }
        inv.assign(d - 1, {});
        for (int b = 0; b < d - 1; ++b)
            inv[b].init_rank1(u[b].at(0, ind0[b], 0));

        // --- col/row factors (dmrgg.f90:242-248)
        colf = u;
        rowf = u;
        for (int b = 0; b < d - 1; ++b) {
            inv[b].apply_left(colf[b].a.data(), n);         // col%u(p)
            inv[b].apply_right(rowf[b + 1].a.data(),
                               n * r[b + 2 > d ? d : b + 2]);  // row%u(p+1)
        }

        double val_prev = value();
        double pivotmax_prev = amax;
        report(0, "::", t0, val_prev, -1.0);

        // --- main loop (dmrgg.f90:314-1019)
        int it = 0, strike = 0;
        bool ready = (it + 1 >= maxrank);
        while (!ready) {
            ++it;
            const bool fwd = (it % 2 == 1);
            double pivotmax = -1.0, pivotmin = -1.0;
            for (int bb = 0; bb < d - 1; ++bb) {
                int b = fwd ? bb : d - 2 - bb;
                visit_bond(b, fwd, amax, pivotmax, pivotmin, pivotmax_prev);
            }
            if (pivotmax >= 0.0) pivotmax_prev = pivotmax;
            double val = value();
            double err = truth != 0.0 ? std::abs(1.0 - val / truth)
                                      : std::abs(1.0 - val / val_prev);
            val_prev = val;
            report(it, fwd ? ">>" : "<<", t0, val, err);
            if (it + 1 >= maxrank) ready = true;
            if (accuracy > 0.0) {
                if (pivotmax >= 0.0 && pivotmax <= accuracy * amax)
                    ++strike;
                else
                    strike = 0;
                if (strike >= 3) ready = true;
            }
        }

        finalize_lua();
        return value_final();
    }

    // One bond visit: lottery seed + rook alternation (dmrgg.f90:410-582),
    // two-threshold accept + bordered update (dmrgg.f90:598-757).
    void visit_bond(int b, bool fwd, double& amax, double& pivotmax,
                    double& pivotmin, double pivotmax_prev) {
        const int rl = r[b], rr = r[b + 2], rb = r[b + 1];
        const int nc = n, nk = n;
        const int m_col = rl * nc;       // column fiber length
        const int m_row = nk * rr;       // row fiber length

        // ---- lottery (rnd.f90:105-126): weights 1 except existing pivots 0
        int nlot = rl + nc + nk + rr;
        vector<double> wcol(m_col, 1.0), wrow(m_row, 1.0);
        for (auto& v : vip[b]) {
            wcol[size_t(v[1]) * rl + v[0]] = 0.0;  // (i,j) col-major like ref
            wrow[size_t(v[3]) * nk + v[2]] = 0.0;  // (k,q)
        }
        vector<double> pc(m_col + 1, 0.0), pr(m_row + 1, 0.0);
        for (int i = 0; i < m_col; ++i) pc[i + 1] = pc[i] + wcol[i];
        for (int i = 0; i < m_row; ++i) pr[i + 1] = pr[i] + wrow[i];
        std::uniform_real_distribution<double> U(0.0, 1.0);
        vector<std::array<int, 4>> lot(nlot);
        for (int t = 0; t < nlot; ++t) {
            double yc = U(rng) * pc[m_col], yr = U(rng) * pr[m_row];
            int ic = int(std::upper_bound(pc.begin() + 1, pc.end(), yc)
                         - pc.begin() - 1);
            int ir = int(std::upper_bound(pr.begin() + 1, pr.end(), yr)
                         - pr.begin() - 1);
            ic = std::min(ic, m_col - 1);
            ir = std::min(ir, m_row - 1);
            lot[t] = {ic % rl, ic / rl, ir % nk, ir / nk};
        }
        vector<double> bres(nlot);
#pragma omp parallel for
        for (int t = 0; t < nlot; ++t)
            bres[t] = feval(lot[t][0], lot[t][1], lot[t][2], lot[t][3], b);
        neval += nlot;
        for (int t = 0; t < nlot; ++t)
            amax = std::max(amax, std::abs(bres[t]));
        // subtract current approximation: col(i,j,:) . row(:,k,q)
        for (int t = 0; t < nlot; ++t) {
            double s = 0.0;
            for (int a_ = 0; a_ < rb; ++a_)
                s += colf[b].at(lot[t][0], lot[t][1], a_) *
                     rowf[b + 1].at(a_, lot[t][2], lot[t][3]);
            bres[t] -= s;
        }
        int tbest = 0;
        for (int t = 1; t < nlot; ++t)
            if (std::abs(bres[t]) > std::abs(bres[tbest])) tbest = t;
        int ii = lot[tbest][0], jj = lot[tbest][1];
        int kk = lot[tbest][2], qq = lot[tbest][3];
        double pivot = bres[tbest];

        vector<double> acol(m_col), arow(m_row);
        bool havecol = false, haverow = false;
        bool done = false;
        if (piv == 0) {
            eval_col(b, kk, qq, acol, amax);
            eval_row(b, ii, jj, arow, amax);
            havecol = haverow = done = true;
        }
        int crs = 0;
        bool skipcol = !fwd;               // dmrgg.f90:517
        while (!done) {
            if (!skipcol) {
                eval_col(b, kk, qq, acol, amax);
                havecol = true;
                ++crs;
                done = havecol && haverow && crs >= 2 * piv;
                if (!done) {
                    // residual col: acol - colf . rowf(:,kk,qq)
                    vector<double> res = acol;
                    for (int a_ = 0; a_ < rb; ++a_) {
                        double rv = rowf[b + 1].at(a_, kk, qq);
                        if (rv == 0.0) continue;
                        for (int i = 0; i < rl; ++i)
                            for (int j = 0; j < nc; ++j)
                                res[size_t(j) * rl + i] -=
                                    colf[b].at(i, j, a_) * rv;
                    }
                    int ix = 0;
                    for (int t = 1; t < m_col; ++t)
                        if (std::abs(res[t]) > std::abs(res[ix])) ix = t;
                    int i2 = ix % rl, j2 = ix / rl;
                    done = havecol && haverow && i2 == ii && j2 == jj;
                    ii = i2;
                    jj = j2;
                    pivot = res[ix];
                }
            }
            skipcol = false;
            if (!done) {
                eval_row(b, ii, jj, arow, amax);
                haverow = true;
                ++crs;
                done = havecol && haverow && crs >= 2 * piv;
                if (!done) {
                    vector<double> res = arow;
                    for (int a_ = 0; a_ < rb; ++a_) {
                        double cv = colf[b].at(ii, jj, a_);
                        if (cv == 0.0) continue;
                        for (int k = 0; k < nk; ++k)
                            for (int q = 0; q < rr; ++q)
                                res[size_t(q) * nk + k] -=
                                    cv * rowf[b + 1].at(a_, k, q);
                    }
                    int ix = 0;
                    for (int t = 1; t < m_row; ++t)
                        if (std::abs(res[t]) > std::abs(res[ix])) ix = t;
                    int k2 = ix % nk, q2 = ix / nk;
                    done = havecol && haverow && k2 == kk && q2 == qq;
                    kk = k2;
                    qq = q2;
                    pivot = res[ix];
                }
            }
        }

        // ---- two-threshold accept (dmrgg.f90:598-600); thresholds are the
        // f64 tier of the precision dispatch (dmrgg.f90:62-84)
        const double small_element = 10.0 * 2.220446049250313e-16;
        const double small_pivot = 1e-5;
        bool accept = std::abs(pivot) > small_element * amax &&
                      std::abs(pivot) > small_pivot * pivotmax_prev;
        if (!accept) return;

        pivotmax = pivotmax < 0 ? std::abs(pivot)
                                : std::max(pivotmax, std::abs(pivot));
        pivotmin = pivotmin < 0 ? std::abs(pivot)
                                : std::min(pivotmin, std::abs(pivot));

        // ---- extend inv with the bordered vectors (dmrgg.f90:649-660)
        vector<double> lrow(rb), ucol(rb);
        for (int a_ = 0; a_ < rb; ++a_) {
            lrow[a_] = colf[b].at(ii, jj, a_);
            ucol[a_] = rowf[b + 1].at(a_, kk, qq);
        }
        vip[b].push_back({ii, jj, kk, qq});
        inv[b].append(lrow, ucol, pivot);

        // ---- append raw fibers to cores (dmrgg.f90:663-713)
        grow_core_right(u[b], acol, rl, nc);        // u(p): new right slice
        grow_core_left(u[b + 1], arow, nk, rr);     // u(p+1): new left row

        // ---- extend col/row factors with incremental LU (dmrgg.f90:716-757):
        // append the raw fibers, then run the bordered-LU update on the new
        // slice only (the from=r+1 incremental application)
        grow_core_right(colf[b], acol, rl, nc);
        grow_core_left(rowf[b + 1], arow, nk, rr);
        update_factors(b);

        // neighbor factor refresh (dmrgg.f90:759-787, single process: both
        // sides always local): the left core's ROW factor gains the new
        // right slice of u(p) with inv[b-1]'s row-side update; the right
        // core's COL factor gains the new left row of u(p+1) with
        // inv[b+1]'s col-side update
        int rb_new = r[b + 1] + 1;
        if (b > 0) {
            // slice (rl, nc) of u[b] at right-rank rb_new-1, column-major
            vector<double> slice(size_t(rl) * nc);
            for (int i = 0; i < rl; ++i)
                for (int j = 0; j < nc; ++j)
                    slice[size_t(j) * rl + i] = u[b].at(i, j, rb_new - 1);
            // d2_luar(n(p), r(p-1), inv(p-1), slice): slice viewed as
            // row(rl, nc) ROW-major in the reference's column-major = our
            // (j*rl + i) layout has rows strided; apply per row p over rl
            apply_right_strided(inv[b - 1], slice.data(), rl, nc);
            grow_core_right(rowf[b], slice, rl, nc);
        }
        if (b < d - 2) {
            // slice (nk, rr) of u[b+1] at left-rank rb_new-1, (k + q*nk)
            vector<double> slice(size_t(nk) * rr);
            for (int k = 0; k < nk; ++k)
                for (int q = 0; q < rr; ++q)
                    slice[size_t(q) * nk + k] = u[b + 1].at(rb_new - 1, k, q);
            // d2_lual(n(p+1), r(p+1), inv(p+1), slice): slice viewed as
            // col(nk, rr) column-major = contiguous columns of length nk
            inv[b + 1].apply_left(slice.data(), nk);
            grow_core_left(colf[b + 1], slice, nk, rr);
        }

        r[b + 1] += 1;
    }

    // d2_luar on a row-matrix stored with row index fastest (column-major
    // (rl, nc)): row p is the strided slice v[p + j*rl]
    static void apply_right_strided(const GrowInv& gi, double* v, int rl,
                                    int nc) {
        for (int p = 1; p <= gi.r; ++p) {
            const double* lb = &gi.g[size_t(p - 1) * (p - 1)];
            for (int s = 0; s < p - 1; ++s) {
                double l = lb[s];
                if (l == 0.0) continue;
                for (int j = 0; j < nc; ++j)
                    v[size_t(j) * rl + (p - 1)] -= l * v[size_t(j) * rl + s];
            }
        }
    }

    // --- core growth helpers (flat row-major (rl, n, rr) layout) ---------
    static void grow_core_right(Core& c, const vector<double>& col_slice,
                                int rl, int n_) {
        // append one slice along the RIGHT rank: (rl, n, rr) -> (rl, n, rr+1);
        // col_slice is column-major (i + j*rl) like the reference fibers
        Core nu;
        nu.resize(rl, n_, c.rr + 1);
        for (int i = 0; i < rl; ++i)
            for (int j = 0; j < n_; ++j) {
                for (int q = 0; q < c.rr; ++q) nu.at(i, j, q) = c.at(i, j, q);
                nu.at(i, j, c.rr) = col_slice[size_t(j) * rl + i];
            }
        c = std::move(nu);
    }
    static void grow_core_left(Core& c, const vector<double>& row_slice,
                               int n_, int rr) {
        // append one row along the LEFT rank: (rl, n, rr) -> (rl+1, n, rr);
        // row_slice is (k + q*n) like the reference fibers
        Core nu;
        nu.resize(c.rl + 1, n_, rr);
        for (int i = 0; i < c.rl; ++i)
            for (int j = 0; j < n_; ++j)
                for (int q = 0; q < rr; ++q) nu.at(i, j, q) = c.at(i, j, q);
        for (int j = 0; j < n_; ++j)
            for (int q = 0; q < rr; ++q)
                nu.at(c.rl, j, q) = row_slice[size_t(q) * n_ + j];
        c = std::move(nu);
    }

    // The reference stores col%u(p) as (rl*n, rb) column-major and row%u(p+1)
    // as (rb, n*rr); our Core is (rl, n, rb) row-major, so the incremental LU
    // application is done here directly on the Core layout.
    void update_factors(int b) {
        const int rb_new = inv[b].r;       // rank after append
        const int rl = r[b], nc = n, rr = r[b + 2], nk = n;
        // colf[b]: apply_left for column rb_new only:
        // col(:,:,new) = (col(:,:,new) - sum_s col(:,:,s) u_border[s]) / piv
        {
            const auto& g = inv[b].g;
            const double* ub = &g[size_t(rb_new) * rb_new - rb_new];  // p^2-p..
            double inv_piv = 1.0 / g[size_t(rb_new) * rb_new - 1];
            for (int i = 0; i < rl; ++i)
                for (int j = 0; j < nc; ++j) {
                    double v = colf[b].at(i, j, rb_new - 1);
                    for (int s = 0; s < rb_new - 1; ++s)
                        v -= colf[b].at(i, j, s) * ub[s];
                    colf[b].at(i, j, rb_new - 1) = v * inv_piv;
                }
        }
        // rowf[b+1]: apply_right for row rb_new only:
        // row(new,:,:) -= sum_s l_border[s] row(s,:,:)
        {
            const auto& g = inv[b].g;
            const double* lb = &g[size_t(rb_new - 1) * (rb_new - 1)];
            for (int k = 0; k < nk; ++k)
                for (int q = 0; q < rr; ++q) {
                    double v = rowf[b + 1].at(rb_new - 1, k, q);
                    for (int s = 0; s < rb_new - 1; ++s)
                        v -= lb[s] * rowf[b + 1].at(s, k, q);
                    rowf[b + 1].at(rb_new - 1, k, q) = v;
                }
        }
    }

    void eval_col(int b, int kk, int qq, vector<double>& acol, double& amax) {
        const int rl = r[b], nc = n;
#pragma omp parallel for collapse(2)
        for (int j = 0; j < nc; ++j)
            for (int i = 0; i < rl; ++i)
                acol[size_t(j) * rl + i] = feval(i, j, kk, qq, b);
        neval += int64_t(rl) * nc;
        for (auto v : acol) amax = std::max(amax, std::abs(v));
    }
    void eval_row(int b, int ii, int jj, vector<double>& arow, double& amax) {
        const int rr = r[b + 2], nk = n;
#pragma omp parallel for collapse(2)
        for (int q = 0; q < rr; ++q)
            for (int k = 0; k < nk; ++k)
                arow[size_t(q) * nk + k] = feval(ii, jj, k, q, b);
        neval += int64_t(rr) * nk;
        for (auto v : arow) amax = std::max(amax, std::abs(v));
    }

    // Per-iteration quadrature value (dmrgg.f90:975-1006): contract raw
    // cores against weights, apply the LU inverses (dtt_lua), chain.
    double value() const {
        // ttqq core p: (r[p], r[p+1]) = sum_j u[p](:, j, :) w_j
        vector<vector<double>> q(d);
        for (int c = 0; c < d; ++c) {
            int rl = u[c].rl, rr = u[c].rr;
            q[c].assign(size_t(rl) * rr, 0.0);
            for (int i = 0; i < rl; ++i)
                for (int j = 0; j < n; ++j) {
                    double w = prob->quad_w[j];
                    for (int a_ = 0; a_ < rr; ++a_)
                        q[c][size_t(i) * rr + a_] += u[c].at(i, j, a_) * w;
                }
        }
        // dtt_lua on the contracted chain (dmrgg.f90:1169-1258): for core p,
        // apply_right with inv[p-1] on rows, apply_left with inv[p] on cols
        for (int c = 0; c < d; ++c) {
            int rl = u[c].rl, rr = u[c].rr;
            if (c > 0) inv[c - 1].apply_right(q[c].data(), rr);
            if (c < d - 1) {
                // apply_left expects column-major (m, r) with m = rl here:
                // transpose, apply, transpose back
                vector<double> t(size_t(rr) * rl);
                for (int i = 0; i < rl; ++i)
                    for (int a_ = 0; a_ < rr; ++a_)
                        t[size_t(a_) * rl + i] = q[c][size_t(i) * rr + a_];
                inv[c].apply_left(t.data(), rl);
                for (int i = 0; i < rl; ++i)
                    for (int a_ = 0; a_ < rr; ++a_)
                        q[c][size_t(i) * rr + a_] = t[size_t(a_) * rl + i];
            }
        }
        // chain product 1x r[1] x ... x 1
        vector<double> acc = q[0];
        for (int c = 1; c < d; ++c) {
            int rl = u[c].rl, rr = u[c].rr;
            vector<double> nxt(size_t(1) * rr, 0.0);
            for (int a_ = 0; a_ < rl; ++a_)
                for (int b_ = 0; b_ < rr; ++b_)
                    nxt[b_] += acc[a_] * q[c][size_t(a_) * rr + b_];
            acc = std::move(nxt);
        }
        return acc[0];
    }

    void finalize_lua() {}
    double value_final() const { return value(); }

    void report(int it, const char* dir, double t0, double val,
                double err) const {
        double er = 0.0;
        int cnt = 0;
        for (int b = 1; b < d; ++b) {
            er += r[b];
            ++cnt;
        }
        std::printf("%3d%s rank %5.1f time: %9.3e n_evals: %10lld",
                    it, dir, er / std::max(cnt, 1), now_s() - t0,
                    (long long)neval);
        if (err >= 0.0)
            std::printf(" err %8.3e val %20.14e", err, val);
        std::printf("\n");
        std::fflush(stdout);
    }
};

// ---------------------------------------------------------------------------
int main(int argc, char** argv) {
    std::string config = argc > 1 ? argv[1] : "ising";
    Problem prob;
    IsingData ig;
    MvnData mg;
    CosData cg;

    auto t_setup = now_s();
    if (config == "ising") {
        std::string kind = argc > 2 ? argv[2] : "C";
        int m = argc > 3 ? std::atoi(argv[3]) : 6;
        int n = argc > 4 ? std::atoi(argv[4]) : 65;
        if (n % 2 == 0) ++n;
        int d = m - 1;
        vector<double> x, w;
        lgwt(n, x, w);
        ig.kind = kind == "C" || kind == "c" ? 1
                : kind == "D" || kind == "d" ? 2 : 3;
        ig.d = d;
        ig.nodes.resize(n);
        ig.weights.resize(n);
        bool rescale = ig.kind != 1 && m >= 10;
        double val = rescale ? 5.0 * (n / 2) : double(n / 2);
        for (int i = 0; i < n; ++i) {
            ig.nodes[i] = (x[i] + 1.0) / 2.0;
            ig.weights[i] = 0.5 * w[i] * val;
        }
        prob.d = d;
        prob.n = n;
        prob.quad_w.assign(n, 1.0 / val);
        prob.fun = [&](const int* ind) { return ising_eval(ig, ind); };
        // C_m truths (Bailey; test_crs_ising.f90:70-86, leading digits)
        if (ig.kind == 1 && m == 6) prob.truth = 0.6486342090310070752631498434;
        if (ig.kind == 1 && m == 4) prob.truth = 0.7011998601764299998165139275;
    } else if (config == "stdnorm") {
        int d = argc > 2 ? std::atoi(argv[2]) : 10;
        int n = argc > 3 ? std::atoi(argv[3]) : 33;
        if (n % 2 == 0) ++n;
        vector<double> x, w;
        lgwt(n, x, w);
        mg.d = d;
        mg.nodes.resize(n);
        prob.quad_w.resize(n);
        const double bnd = 10.0;
        for (int i = 0; i < n; ++i) {
            mg.nodes[i] = bnd * x[i];
            prob.quad_w[i] = bnd * w[i];
        }
        prob.d = d;
        prob.n = n;
        prob.truth = std::pow(std::acos(-1.0), d / 2.0);
        prob.fun = [&](const int* ind) {
            double s = 0.0;
            for (int i = 0; i < mg.d; ++i) s += mg.nodes[ind[i]] * mg.nodes[ind[i]];
            return std::exp(-s);
        };
    } else if (config == "mvn" || config == "coscoeff") {
        int d = argc > 2 ? std::atoi(argv[2]) : 6;
        int n = argc > 3 ? std::atoi(argv[3]) : 65;
        if (n % 2 == 0) ++n;
        // equicorrelated lognormal-model covariance (mvn_pdf.f90:15-60):
        // sigma = 0.4, rho = 0.5, X0 = log(100), T = 1
        double sigma = 0.4, rho = 0.5;
        vector<double> cov(size_t(d) * d);
        vector<double> mu(d, std::log(100.0) - 0.5 * sigma * sigma);
        for (int i = 0; i < d; ++i)
            for (int j = 0; j < d; ++j)
                cov[size_t(i) * d + j] = sigma * sigma * (i == j ? 1.0 : rho);
        if (config == "mvn") {
            vector<double> icov = cov;
            double det = invert_and_det(icov, d);
            mg.d = d;
            mg.mu = mu;
            mg.icov = icov;
            mg.norm = 1.0 / std::sqrt(std::pow(2 * std::acos(-1.0), d) * det);
            double lo = 0.52517, hi = 8.52517;
            vector<double> x, w;
            lgwt(n, x, w);
            mg.nodes.resize(n);
            prob.quad_w.resize(n);
            for (int i = 0; i < n; ++i) {
                mg.nodes[i] = lo + (hi - lo) * (x[i] + 1.0) / 2.0;
                prob.quad_w[i] = w[i] * (hi - lo) / 2.0;
            }
            prob.truth = 1.0;
            prob.fun = [&](const int* ind) { return mvn_eval(mg, ind); };
        } else {
            cg.d = d;
            cg.a = 0.52517;
            cg.b = 8.52517;
            cg.mu = mu;
            cg.cov = cov;
            prob.quad_w.assign(n, 1.0);
            prob.truth = 0.0;
            prob.fun = [&](const int* ind) { return cos_eval(cg, ind); };
        }
        prob.d = d;
        prob.n = n;
    } else {
        std::fprintf(stderr, "unknown config %s\n", config.c_str());
        return 2;
    }

    // ising takes (kind, m, n, rank, piv) after the config name, the others
    // (d, n, rank, piv) — mirroring each reference driver's positional CLI
    int base = (config == "ising") ? 5 : 4;
    int maxrank = argc > base ? std::atoi(argv[base]) : 24;
    int piv = argc > base + 1 ? std::atoi(argv[base + 1]) : 1;

    Engine eng;
    eng.d = prob.d;
    eng.n = prob.n;
    eng.piv = piv;
    eng.maxrank = maxrank;
    eng.accuracy = 500 * 2.220446049250313e-16;
    eng.truth = prob.truth;
    eng.prob = &prob;

    double t0 = now_s();
    double val = eng.run();
    double wall = now_s() - t0;
    double digits = prob.truth != 0.0
                        ? -std::log10(std::abs(1.0 - val / prob.truth))
                        : 0.0;
    int nthreads = 1;
#ifdef _OPENMP
#pragma omp parallel
    {
#pragma omp master
        nthreads = omp_get_num_threads();
    }
#endif
    std::printf(
        "{\"config\": \"%s\", \"value\": %.16e, \"correct_digits\": %.2f, "
        "\"n_evals\": %lld, \"wall_time_s\": %.3f, \"evals_per_sec\": %.1f, "
        "\"threads\": %d, \"setup_s\": %.3f}\n",
        config.c_str(), val, digits, (long long)eng.neval, wall,
        eng.neval / wall, nthreads, t0 - t_setup);
    return 0;
}
