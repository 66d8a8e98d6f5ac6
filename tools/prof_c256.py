import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time, numpy as np, jax, jax.numpy as jnp
from ttcross_tpu.apps.ising import make_ising
from ttcross_tpu.cross.engine import CrossConfig, get_engine, cross
from ttcross_tpu.cross.chains import all_left_tables, all_right_tables
from ttcross_tpu.config import precision_thresholds

p = make_ising("C", m=256, n=17)
d = p.d
se, sp = precision_thresholds(jnp.float64)
cfg = CrossConfig(d=d, n=tuple([p.n]*d), N=p.n, R=10, piv=1,
                  small_element=se, small_pivot=sp, jacobi=True)
kit = get_engine(p.fun, cfg)
w = jnp.asarray(np.tile(np.asarray(p.quad_weights)[None, :], (d, 1)))

key = jax.random.PRNGKey(0)
st = kit.init_fn(key)
# advance 5 sweeps to a realistic mid-run state
for it in range(1, 6):
    st = kit.sweep_fn(st, jnp.asarray(it, jnp.int32))
st = jax.block_until_ready(st)
print("rk mid-run:", np.asarray(st.rk)[:6], "...")

def timeit(name, f, *args, k=5):
    r = jax.block_until_ready(f(*args))   # compile+warm
    ts = []
    for _ in range(k):
        t0 = time.perf_counter()
        r = jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    print(f"{name:24s} med {1e3*ts[k//2]:8.2f} ms  min {1e3*ts[0]:8.2f}")
    return r

noop = jax.jit(lambda x: x + 1)
timeit("noop (dispatch floor)", noop, jnp.zeros((4,)))

tables = jax.jit(lambda vip: (all_left_tables(vip, d), all_right_tables(vip, d)))
timeit("LT+RT tables", tables, st.vip)

NLOT = 2 * (cfg.R + cfg.N)
U = jax.random.uniform(jax.random.PRNGKey(1), (d - 1, 2, NLOT), jnp.float64)
live = jnp.ones((d - 1,), bool)
hunt_fn = jax.jit(lambda st, U: kit.jacobi_hunt(st, U, True, 0, d - 1, live))
hunt, amax, nev, pad = timeit("jacobi_hunt", hunt_fn, st, U)

st2 = st._replace(amax=amax, neval=nev, padded=pad)
apply_fn = jax.jit(lambda st, h: kit.jacobi_apply(st, h))
timeit("jacobi_apply", apply_fn, st2, hunt)

sweep1 = jax.jit(lambda st: kit.sweep_fn(st, jnp.asarray(7, jnp.int32)))
timeit("full sweep", sweep1, st)

B = (d - 1) * cfg.R * cfg.N
ind = jnp.asarray(np.random.default_rng(0).integers(0, p.n, size=(B, d)), jnp.int32)
fcall = jax.jit(p.fun)
timeit(f"fun B={B}", fcall, ind)

timeit("value_fn", kit.value_fn, st, w)
