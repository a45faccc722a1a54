"""``Pallas: force`` settings at the float32 floor, the port against the JAX
package on the CPU (a script, not a pytest module: one 1024^2 solve per
side and dtype takes seconds, more than the tier-1 suite can spare).

    JAX_PLATFORMS=cpu python tests/force_floor_check.py [size] [tol]

One image of BASELINE config 3's generator (``default_rng(3)``, sigma 8,
porosity 0.65, D = 1 on pore pixels and 1e-6 elsewhere) at ``size``^2
(default 1024), solved by the batch pipeline's mgcg settings under
``Pallas: force`` (V(1,1), omega 0.8, 32 coarse sweeps, min_size 8, a check
every 10, mean|r| <= ``tol``, default 1e-7, MaxIter 400) on the fused
"cgstep" engine: the port's plain versions of K1/K2 and the JAX package's
Pallas kernels in interpret mode, in float32 and float64.  Prints Deff,
conv and iterations of each.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy import ndimage

from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.flux import make_flux_spec as jspec
from effectivediffusivityfvm_tpu.solvers import multigrid as jmg
from effectivediffusivityfvm_tpu_torch.ops import fvm
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.solvers import multigrid

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(4)


def main(size=1024, tol=1e-7):
    rng = np.random.default_rng(3)
    noise = ndimage.gaussian_filter(rng.standard_normal((size, size)),
                                    sigma=8.0)
    solid = noise >= np.quantile(noise, 0.65)
    d = np.where(solid, 1e-6, 1.0)[None]
    x0 = np.broadcast_to(np.arange(size) / size, d.shape).copy()
    kw = dict(tol=tol, max_iter=400, check_every=10, criterion="residual",
              nu1=1, nu2=1, mg_omega=0.8, coarse_iters=32, min_size=8,
              over=1.8, first_window=10, use_pallas="cgstep")
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.float64, jnp.float64)):
        t = torch.tensor(d, dtype=dt)
        port = multigrid.solve_mgcg_batched(
            fvm.fvm_coefficients(t, 0.0, 1.0), make_flux_spec(t, 0.0, 1.0),
            torch.tensor(x0, dtype=dt), **kw)
        jd = jnp.asarray(d, dtype=jdt)
        ref = jmg.solve_mgcg_batched(
            jax.vmap(jfvm.fvm_coefficients, in_axes=(0, None, None))(
                jd, 0.0, 1.0),
            jax.vmap(jspec, in_axes=(0, None, None))(jd, 0.0, 1.0),
            jnp.asarray(x0, dtype=jdt), pallas_interpret=True, **kw)
        for name, res in (("port", port), ("jax", ref)):
            print(f"{size}^2 {str(dt)[-7:]} {name}: Deff "
                  f"{float(res.deff[0]):.9f}, conv {float(res.conv[0]):.4e}, "
                  f"iterations {int(res.iters[0])}", flush=True)


if __name__ == "__main__":
    main(*(f(a) for f, a in zip((int, float), sys.argv[1:])))
