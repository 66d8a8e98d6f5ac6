"""The documented public import surface (docs/api.md) resolves.

A migrating user of the reference navigates by docs/api.md; every symbol
listed there must import from the stated module path.  This test pins the
re-export surface so a refactor that moves a function without updating the
package ``__init__`` fails loudly (the reference's analogue is its Makefile
module-dependency list, Makefile:126-134 — link errors at build time).
"""

import importlib

import pytest

pytestmark = pytest.mark.smoke

SURFACE = {
    "ttcross_tpu.cross": [
        "cross", "CrossResult", "cross_batch",
        "extract_skeleton", "skeleton_value_fn", "skeleton_tt_fn",
        "cross_maxvol", "maxvol_refine", "accchk", "make_engine",
        "cross_dd", "cross_qd", "cross_mp",
        "cross_mp_native", "ising_cross_mp_native",
        "cross_defect_corrected", "cross_defect_corrected_qd", "refine_dd",
    ],
    "ttcross_tpu.parallel": [
        "cross_parallel", "cross_dd_parallel", "maxvol_refine_parallel",
        "cross_mp_parallel", "cross_qd_parallel",
        "bond_mesh", "share", "BOND_AXIS",
    ],
    "ttcross_tpu.tt": [
        "TT", "from_cores", "ones", "zeros", "rank1", "from_dense",
        "gather", "value", "full", "sumall", "contract", "dot", "norm",
        "add", "scale", "hadamard", "group",
        "orthogonalize", "svd_round", "chop_rank",
        "save_ttbin", "load_ttbin", "save_ttbin_ref", "load_ttbin_ref",
        "save_hdf5", "load_hdf5", "save_npz", "load_npz",
        "save_state", "load_state",
    ],
    "ttcross_tpu.ops.quadrature": [
        "lgwt", "gauss_legendre", "map_to_interval",
        "quad_rinv", "quad_rinv_error",
    ],
    "ttcross_tpu.ops.dense": [
        "svd_chopped", "matinv", "qr_ort", "gram_schmidt", "orto_block",
        "aca", "greedy_cur", "transpose2d", "transpose3d",
        "table_lookup", "row_lookup", "batched_row_lookup",
    ],
    "ttcross_tpu.ops.lu": [
        "GrowingLU", "lu_append", "solve_cols", "solve_rows",
        "apply_new_col", "apply_new_row",
    ],
    "ttcross_tpu.ops.dd": [
        "DD", "two_sum", "two_prod", "dd_mul", "dd_dot", "dd_matmul",
        "dd_exp", "dd_log", "dd_contract",
    ],
    "ttcross_tpu.ops.sampling": ["weighted_lottery"],
    "ttcross_tpu.apps": [
        "make_ising", "make_ising_dd", "make_ising_qd", "make_ising_mp",
        "ising_truth",
        "make_mvn", "make_mvn_density", "make_mvn_family",
        "make_stdnorm", "make_stdnorm_dd", "make_stdnorm_qd",
        "make_cos_coefficients", "cos_approximate", "gaussian_chf",
        "s_vectors", "basket_chf", "basket_pdf",
        "make_quantics", "quantics_cross",
        "CHF_REFERENCE", "CHF_RHO05",
    ],
    "ttcross_tpu.utils": [
        "readarg", "print_config",
        "say", "saynnz", "say_tt",
        "Timer", "SweepRecord", "write_jsonl", "profile_trace",
        "has_nan", "assert_finite", "tt_check",
        "lin_to_multi", "multi_to_lin", "heartbeat",
    ],
    "ttcross_tpu.native": [
        "available", "gauss_legendre_dd", "contract_q",
        "tt_write_native", "tt_read_native", "gaussian_chf_native",
        "mpfr_available",
    ],
}


# Documented symbols whose implementation needs an optional extra
# (pyproject [project.optional-dependencies]); skipped, not failed, when the
# extra is absent so the surface test still reports real gaps on the base
# jax+numpy dependency set.
OPTIONAL_DEP = {
    "cross_mp": "mpmath", "cross_mp_parallel": "mpmath",
    "save_hdf5": "h5py", "load_hdf5": "h5py",
}


def _has(dep):
    return importlib.util.find_spec(dep) is not None


@pytest.mark.parametrize("module", sorted(SURFACE))
def test_documented_surface_resolves(module):
    mod = importlib.import_module(module)
    missing = [name for name in SURFACE[module]
               if not hasattr(mod, name)
               and (name not in OPTIONAL_DEP or _has(OPTIONAL_DEP[name]))]
    assert not missing, f"{module} lacks documented names: {missing}"


def test_all_exports_resolve():
    """Every name in each package __all__ actually exists (or is a documented
    lazily-resolved optional-dependency symbol in an absent environment)."""
    modules = {"ttcross_tpu", "ttcross_tpu.native"} | set(SURFACE)
    for module in sorted(modules):
        mod = importlib.import_module(module)
        for name in getattr(mod, "__all__", []):
            if name in OPTIONAL_DEP and not _has(OPTIONAL_DEP[name]):
                continue
            assert hasattr(mod, name), f"{module}.__all__ lists missing {name!r}"
