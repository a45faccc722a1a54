"""The port's row-sharded 2D path (``parallel/``: the mesh and its
collectives, the sharded hierarchy, K8's cycle and K9's CG steps in their
plain versions, the sharded Jacobi and MGCG solves, the DP/SP batch
pipeline and the dry-run twin) against the JAX package's, in float64 on the
CPU.

The port's mesh is a list of CPU entries (eight, or four); the JAX side
runs ``shard_map`` on the virtual CPU devices of ``tests/conftest.py``, its
Pallas kernels in interpret mode.  Both sides get the same numpy inputs.
The hierarchy is elementwise arithmetic: rtol 1e-12.  One cycle
application adds the coarse tail's sweeps: atol 1e-12 * max|z|.  The CG
steps add dot products summed in other orders (per shard in float64 here,
a psum of per-shard sums there), amplified over k=3 iterations: rtol 1e-10.
Whole solves: identical iteration counts, Deff rtol 1e-9 (MGCG) and 1e-12
(Jacobi, the sweeps and monitors of the JAX sharded code in its order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.flux import make_flux_spec as jspec
from effectivediffusivityfvm_tpu.parallel import fused2d as jfused
from effectivediffusivityfvm_tpu.parallel import fused2d_cg as jfused_cg
from effectivediffusivityfvm_tpu.parallel import halo as jhalo
from effectivediffusivityfvm_tpu.parallel.mesh import make_mesh as jmake_mesh
from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
from effectivediffusivityfvm_tpu_torch.io.images import (
    parallel_slab, three_phase_parallel_slab)
from effectivediffusivityfvm_tpu_torch.ops import fvm
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.ops.kernels import cgstep_sharded
from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle_sharded
from effectivediffusivityfvm_tpu_torch.parallel import fused2d, halo, mesh
from effectivediffusivityfvm_tpu_torch.parallel.dryrun import dryrun_multichip
from effectivediffusivityfvm_tpu_torch.pipeline.batch import (
    batch_sim, batch_sim_3phase)

torch.set_num_threads(1)
CPU = torch.device("cpu")
MG = dict(nu=2, omega=0.8, coarse_iters=8, over=1.8)


def _cpu_mesh(n, dp=1):
    return mesh.make_mesh(n, dp=dp, devices=[CPU] * n)


def _jax_sp_mesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("sp",))


def _medium(seed, shape, contrast=1e3):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(0, np.log(contrast), shape))


def _systems(d):
    """The port's and the JAX package's coefficients, flux spec and linear
    x0 of the diffusivity field ``d`` (``(..., ny, nx)``)."""
    nx = d.shape[-1]
    x0 = np.broadcast_to(np.arange(nx) / nx, d.shape).copy()
    dt = torch.tensor(d)
    port = (fvm.fvm_coefficients(dt, 0.0, 1.0), make_flux_spec(dt, 0.0, 1.0),
            torch.tensor(x0))
    if d.ndim == 3:
        jc = jax.vmap(jfvm.fvm_coefficients, in_axes=(0, None, None))(
            jnp.asarray(d), 0.0, 1.0)
        js = jax.vmap(jspec, in_axes=(0, None, None))(jnp.asarray(d), 0.0,
                                                      1.0)
    else:
        jc = jfvm.fvm_coefficients(jnp.asarray(d), 0.0, 1.0)
        js = jspec(jnp.asarray(d), 0.0, 1.0)
    return port, (jc, js, jnp.asarray(x0))


def _port_row(c, n):
    """The port's coefficients of a ``(B, ny, nx)`` system as one mesh row
    of ``n`` CPU shards."""
    sh = [mesh.shard_rows(_cpu_mesh(n), a)[0] for a in c]
    return [fvm.StencilCoeffs(*(f[s] for f in sh)) for s in range(n)]


def _joined(row):
    return torch.cat(list(row), dim=-2).numpy()


# ----------------------------------------------------------- collectives

def test_collectives_and_placement():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((4, 16, 6)))
    m = _cpu_mesh(8, dp=2)
    rows = mesh.shard_rows(m, a)
    assert len(rows) == 2 and all(len(r) == 4 for r in rows)
    assert rows[1][2].shape == (2, 4, 6)
    torch.testing.assert_close(mesh.gather_rows(rows, CPU), a, rtol=0,
                               atol=0)
    norths, souths = mesh.halo_strips(rows[0], 3)
    assert not norths[0].any() and not souths[-1].any()
    for s in range(1, 4):
        assert torch.equal(norths[s], rows[0][s - 1][..., -3:, :])
        assert torch.equal(souths[s - 1], rows[0][s][..., :3, :])
    parts = [torch.tensor([float(s), 2.0 * s]) for s in range(4)]
    summed = mesh.psum(parts)
    assert all(torch.equal(v, torch.tensor([6.0, 12.0])) for v in summed)
    whole = mesh.all_gather(rows[0])
    assert all(torch.equal(w, a[:2]) for w in whole)
    vals = mesh.shard_batch(m, torch.arange(4.0))
    assert torch.equal(vals[1][3], torch.tensor([2.0, 3.0]))
    assert torch.equal(vals[0][0], torch.tensor([0.0, 1.0]))
    with pytest.raises(ValueError):
        mesh.make_mesh(8, dp=3, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        mesh.shard_rows(_cpu_mesh(3), a)


def test_resolve_mesh_shape():
    cfg = SimulationConfig(devices=8, dp=2, sp=4)
    assert cfg.resolve_mesh_shape(8) == (8, 2, 4)
    assert SimulationConfig(devices=-1, sp=2).resolve_mesh_shape(4) == (4, 2,
                                                                        2)
    with pytest.raises(ValueError, match="requested"):
        cfg.resolve_mesh_shape(4)
    with pytest.raises(ValueError, match="dp\\*sp"):
        SimulationConfig(devices=8, dp=3, sp=2).resolve_mesh_shape(8)


# ------------------------------------------------------------- hierarchy

def test_sharded_hierarchy_matches_jax():
    ny, nx, n = 64, 32, 4
    d = _medium(1, (2, ny, nx))
    (c, _, _), (jc, _, _) = _systems(d)
    hier = halo._build_sharded_hierarchy_2d(_port_row(c, n), ny // n,
                                            min_size=8)
    g3 = P(None, "sp", None)
    n_sh = len(hier.sharded)

    @functools.partial(
        shard_map, mesh=_jax_sp_mesh(n),
        in_specs=(jfvm.StencilCoeffs(*([g3] * 7)),),
        out_specs=([jfvm.StencilCoeffs(*([g3] * 7))] * n_sh,
                   jfvm.StencilCoeffs(*([P()] * 7))),
        check_vma=False)
    def build(c_l):
        sh, rep = jhalo._build_sharded_hierarchy_2d(c_l, ny // n, "sp",
                                                    min_size=8)
        return sh, rep[0]

    j_sh, j_rep0 = jax.jit(build)(jc)
    assert n_sh == 2
    for lvl, jl in zip(hier.sharded, j_sh):
        for f in jfvm.StencilCoeffs._fields:
            np.testing.assert_allclose(
                _joined(getattr(c_, f) for c_ in lvl),
                np.asarray(getattr(jl, f)), rtol=1e-12, atol=0)
    rep0 = hier.replicated[0][0]
    for f in jfvm.StencilCoeffs._fields:
        np.testing.assert_allclose(getattr(rep0, f).numpy(),
                                   np.asarray(getattr(j_rep0, f)),
                                   rtol=1e-12, atol=0)


# --------------------------------------------------- K8: one cycle (plain)

@pytest.mark.parametrize("banded", [False, True], ids=["whole", "banded"])
def test_k8_plain_cycle_matches_jax(banded, monkeypatch):
    """One application of the fused sharded cycle, SP=4 on 64x32, against
    the JAX package's in interpret mode; ``banded`` makes the JAX side run
    its in-shard banded form (the port has one form)."""
    if banded:
        orig = jfused.shard_band
        monkeypatch.setattr(
            jfused, "shard_band",
            lambda ny_l, nx, itemsize=4: (8 if ny_l >= 16
                                          else orig(ny_l, nx, itemsize)))
    ny, nx, n = 64, 32, 4
    d = _medium(2, (1, ny, nx))
    (c, _, _), (jc, _, _) = _systems(d)
    r = np.random.default_rng(3).standard_normal((1, ny, nx))

    row = _port_row(c, n)
    hier = halo._build_sharded_hierarchy_2d(row, ny // n, min_size=8)
    cw = fused2d._coef_windows(hier.sharded)
    tail = fused2d.build_fused_tail(hier.sharded, 8)
    assert tail[0] == 1
    rs = mesh.shard_rows(_cpu_mesh(n), torch.tensor(r))[0]
    z = _joined(fused2d.v_cycle_sharded_fused(hier, cw, rs, tail=tail, **MG))

    g3 = P(None, "sp", None)

    @functools.partial(
        shard_map, mesh=_jax_sp_mesh(n),
        in_specs=(jfvm.StencilCoeffs(*([g3] * 7)), g3), out_specs=g3,
        check_vma=False)
    def cycle(c_l, r_l):
        sh, rep = jhalo._build_sharded_hierarchy_2d(c_l, ny // n, "sp",
                                                    min_size=8)
        jcw = jfused._coef_windows(sh, "sp")
        jtail = jfused.build_fused_tail(sh, "sp", 8)
        return jfused.v_cycle_sharded_fused(
            sh, rep, jcw, r_l, axis_name="sp", interpret=True, tail=jtail,
            **MG)

    zj = np.asarray(jax.jit(cycle)(jc, jnp.asarray(r)))
    np.testing.assert_allclose(z, zj, rtol=0,
                               atol=1e-12 * np.abs(zj).max())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_k8_row_plain_matches_per_shard_plain_and_jax(n):
    """K8's row-wide plain version at SP=n -- each shard reading its
    neighbours' rows in place, T1 writing the restrictions into the
    gathered tail's plane, T2 reading e_c from it -- equals the per-shard
    plain version fed exchanged strips, and one application of the cycle
    equals the JAX package's (interpret mode) to atol 1e-12 * max|z|."""
    hl = vcycle_sharded.HALO
    ny, nx = 64, 32
    d = _medium(6, (1, ny, nx))
    (c, _, _), (jc, _, _) = _systems(d)
    rng = np.random.default_rng(7)
    r = rng.standard_normal((1, ny, nx))
    hier = halo._build_sharded_hierarchy_2d(_port_row(c, n), ny // n,
                                            min_size=8)
    cw = fused2d._coef_windows(hier.sharded)
    tail = fused2d.build_fused_tail(hier.sharded, 8)
    rs = mesh.shard_rows(_cpu_mesh(n), torch.tensor(r))[0]

    row = vcycle_sharded.ShardRow(vcycle_sharded.coef_sources(cw[0]),
                                  gathered=True)
    r_src = vcycle_sharded.neighbour_sources(rs, hl)
    es, rcs = vcycle_sharded.shard_row_t1(row, r_src, omega=0.8, nu=2)
    rn, rss = mesh.halo_strips(rs, hl)
    for s in range(n):
        e_p, rc_p = vcycle_sharded.shard_t1_reference(
            cw[0][s], rs[s], rn[s], rss[s], omega=0.8, nu=2)
        assert torch.equal(es[s], e_p) and torch.equal(rcs[s], rc_p)
    assert torch.equal(row.gathered, torch.cat(rcs, dim=-2))
    ec = torch.tensor(rng.standard_normal(tuple(row.gathered.shape)))
    z = vcycle_sharded.shard_row_t2(
        row, vcycle_sharded.neighbour_sources(es, hl), r_src, ec, omega=0.8,
        nu=2, over=1.8)
    ecs = [t.contiguous() for t in torch.split(ec, ny // n // 2, dim=-2)]
    en, ess = mesh.halo_strips(es, hl)
    ecn, ecss = mesh.halo_strips(ecs, hl // 2)
    for s in range(n):
        z_p = vcycle_sharded.shard_t2_reference(
            cw[0][s], es[s], en[s], ess[s], rs[s], rn[s], rss[s], ecs[s],
            ecn[s], ecss[s], omega=0.8, nu=2, over=1.8)
        assert torch.equal(z[s], z_p)

    rows = {}
    z = _joined(fused2d.v_cycle_sharded_fused(hier, cw, rs, tail=tail,
                                              rows=rows, **MG))
    assert tail[0] == 1 and rows[0].gathered is not None
    g3 = P(None, "sp", None)

    @functools.partial(
        shard_map, mesh=_jax_sp_mesh(n),
        in_specs=(jfvm.StencilCoeffs(*([g3] * 7)), g3), out_specs=g3,
        check_vma=False)
    def cycle(c_l, r_l):
        sh, rep = jhalo._build_sharded_hierarchy_2d(c_l, ny // n, "sp",
                                                    min_size=8)
        jcw = jfused._coef_windows(sh, "sp")
        jtail = jfused.build_fused_tail(sh, "sp", 8)
        return jfused.v_cycle_sharded_fused(
            sh, rep, jcw, r_l, axis_name="sp", interpret=True, tail=jtail,
            **MG)

    zj = np.asarray(jax.jit(cycle)(jc, jnp.asarray(r)))
    np.testing.assert_allclose(z, zj, rtol=0,
                               atol=1e-12 * np.abs(zj).max())


def test_k8_wrappers_take_cpu_plain_and_refuse_other_devices():
    rng = np.random.default_rng(4)
    planes = [torch.tensor(rng.random((1, r, 16)))
              for r in (16, 8, 8) * 4]
    e, rc = vcycle_sharded.shard_t1(planes[:9], *planes[9:12], omega=0.8,
                                    nu=2)
    e_p, rc_p = vcycle_sharded.shard_t1_reference(planes[:9], *planes[9:12],
                                                  omega=0.8, nu=2)
    assert torch.equal(e, e_p) and torch.equal(rc, rc_p)
    assert rc.shape == (1, 8, 8)
    with pytest.raises(ValueError, match="nu"):
        vcycle_sharded.shard_t1(planes[:9], *planes[9:12], omega=0.8, nu=5)
    meta = [p.to("meta") for p in planes]
    with pytest.raises(ValueError, match="device"):
        vcycle_sharded.shard_t1(meta[:9], *meta[9:12], omega=0.8, nu=2)


# ---------------------------------------------------- K9: CG steps (plain)

def _jax_k9_steps(jc, n, ny, k, arrays):
    """JAX's ``_cg_steps_sharded`` (V(2,2), omega 0.8, min_size 8) over
    ``n`` shards of the system ``jc`` on the torch ``arrays`` (x, r, p, rz,
    active, stop, hi)."""
    g3 = P(None, "sp", None)

    @functools.partial(
        shard_map, mesh=_jax_sp_mesh(n),
        in_specs=(jfvm.StencilCoeffs(*([g3] * 7)), g3, g3, g3, P(), P(), P(),
                  P()),
        out_specs=(g3, g3, g3, P(), P()), check_vma=False)
    def steps(c_l, x_l, r_l, p_l, rz_, act, stop_, hi_):
        sh, rep = jhalo._build_sharded_hierarchy_2d(c_l, ny // n, "sp",
                                                    min_size=8)
        jcw = jfused._coef_windows(sh, "sp")
        jtail = jfused.build_fused_tail(sh, "sp", 8)
        return jfused_cg._cg_steps_sharded(
            sh, rep, jcw, x_l, r_l, p_l, rz_, act, stop_, hi_, k, nu=2,
            omega=0.8, coarse_iters=8, over=1.8, axis_name="sp",
            reduce_any=jnp.any, interpret=True, tail=jtail)

    return jax.jit(steps)(jc, *(jnp.asarray(t.numpy()) for t in arrays))


def test_k9_plain_cg_steps_match_jax():
    """k=3 fused sharded CG iterations on 4 images at SP=4: one live, one
    frozen, one that exits at iteration 0 and one tripped by its divergence
    threshold."""
    ny, nx, n, k = 64, 32, 4, 3
    d = _medium(5, (4, ny, nx))
    (c, _, x0), (jc, _, _) = _systems(d)
    x = x0.clone()
    r = c.b - fvm.apply_operator(c, x)
    p = r * c.diag_inv
    rz = torch.sum(r * p, dim=(-2, -1))
    sr0 = torch.sum(r.abs(), dim=(-2, -1))
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=torch.float64)
    stop = torch.zeros(4, dtype=torch.float64)
    stop[2] = 10.0 * sr0[2]
    hi = torch.full((4,), np.inf, dtype=torch.float64)
    rz[3] *= 1e3
    hi[3] = 2.0 * sr0[3]

    row = _port_row(c, n)
    hier = halo._build_sharded_hierarchy_2d(row, ny // n, min_size=8)
    cw = fused2d._coef_windows(hier.sharded)
    tail = fused2d.build_fused_tail(hier.sharded, 8)
    m = _cpu_mesh(n)
    xs, rs, ps = (mesh.shard_rows(m, t)[0] for t in (x, r, p))
    out = cgstep_sharded.cg_steps_sharded(
        cw[0], xs, rs, ps, rz, active, stop, hi, k,
        coarse=lambda rc, live: fused2d.v_cycle_sharded_fused(
            hier, cw, rc, level=1, tail=tail, live=live, **MG),
        omega=0.8, nu=2, over=1.8)

    ref = _jax_k9_steps(jc, n, ny, k, (x, r, p, rz, active, stop, hi))
    assert out[4].tolist() == np.asarray(ref[4]).tolist() == [3, 0, 0, 1]
    for got, want in zip(out[:3], ref[:3]):
        want = np.asarray(want)
        np.testing.assert_allclose(_joined(got), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]),
                               rtol=1e-10)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_k9_plain_on_the_tail_plane_matches_split_form_and_jax(n):
    """K9's plain version in the solver's form (``fused2d.k9_coarse``: each
    shard's restriction written at its rows of the gathered tail's plane,
    K2 on that plane, the correction's rows read in place) against the same
    steps with the shards' own coarse planes (the cycle gathers and splits
    them), bit for bit, and against JAX's ``_cg_steps_sharded`` at SP = n:
    k=2 on two images, one live and one frozen."""
    ny, nx, k = 64, 32, 2
    (c, _, x0), (jc, _, _) = _systems(_medium(9, (2, ny, nx)))
    r = c.b - fvm.apply_operator(c, x0)
    p = r * c.diag_inv
    rz = torch.sum(r * p, dim=(-2, -1))
    active = torch.tensor([1.0, 0.0], dtype=torch.float64)
    stop = torch.zeros(2, dtype=torch.float64)
    hi = torch.full((2,), np.inf, dtype=torch.float64)
    hier = halo._build_sharded_hierarchy_2d(_port_row(c, n), ny // n,
                                            min_size=8)
    cw = fused2d._coef_windows(hier.sharded)
    tail = fused2d.build_fused_tail(hier.sharded, 8)
    m = _cpu_mesh(n)

    def run(kw):
        xs, rs, ps = (mesh.shard_rows(m, t.clone())[0] for t in (x0, r, p))
        out = cgstep_sharded.cg_steps_sharded_reference(
            cw[0], xs, rs, ps, rz, active, stop, hi, k, omega=0.8, nu=2,
            over=1.8, **kw)
        return [_joined(out[i]) for i in range(3)] + [out[3], out[4]]

    kw = fused2d.k9_coarse(hier, cw, mesh.shard_rows(m, x0)[0], tail=tail,
                           **MG)
    assert tail[0] == 1 and tuple(kw["coarse_plane"].shape) == (2, ny // 2,
                                                                 nx // 2)
    on_plane = run(kw)
    split = run(dict(coarse=lambda rc, live: fused2d.v_cycle_sharded_fused(
        hier, cw, rc, level=1, tail=tail, live=live, **MG)))
    for a, b in zip(on_plane[:3], split[:3]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(on_plane[3], split[3])
    assert on_plane[4].tolist() == split[4].tolist() == [k, 0]
    ref = _jax_k9_steps(jc, n, ny, k, (x0, r, p, rz, active, stop, hi))
    for got, want in zip(on_plane[:3], ref[:3]):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(on_plane[3].numpy(), np.asarray(ref[3]),
                               rtol=1e-10)


def test_k9_plain_leaves_the_window_when_none_is_live():
    """Two images that both stop at iteration 2 of a k=10 window (sum|r|
    rises over their ``hi`` there): the plain K9 makes two coarse calls (not
    ten), each with both images live, and returns the x/r/p of a k=2 window
    bit for bit."""
    ny, nx, n = 32, 16, 2
    (c, _, x0), _ = _systems(_medium(12, (2, ny, nx), contrast=10.0))
    r = c.b - fvm.apply_operator(c, x0)
    p = r * c.diag_inv
    rz = torch.sum(r * p, dim=(-2, -1))
    row = _port_row(c, n)
    hier = halo._build_sharded_hierarchy_2d(row, ny // n, min_size=4)
    cw = fused2d._coef_windows(hier.sharded)
    tail = fused2d.build_fused_tail(hier.sharded, 4)
    m = _cpu_mesh(n)
    calls = []

    def run(k, hi):
        def coarse(rc, live):
            calls.append([bool(v) for v in live[0]])
            return fused2d.v_cycle_sharded_fused(hier, cw, rc, level=1,
                                                 tail=tail, live=live, **MG)
        xs, rs, ps = (mesh.shard_rows(m, t.clone())[0] for t in (x0, r, p))
        out = cgstep_sharded.cg_steps_sharded(
            cw[0], xs, rs, ps, rz, torch.ones(2, dtype=torch.float64),
            torch.zeros(2, dtype=torch.float64), hi, k, coarse=coarse,
            omega=0.8, nu=2, over=1.8)
        return [_joined(out[i]) for i in range(3)], out[4].tolist()

    def sum_abs(v):
        return torch.tensor(np.abs(v).sum(axis=(-2, -1)))

    inf = torch.full((2,), np.inf, dtype=torch.float64)
    (_, r1, _), _ = run(1, inf)
    (x2, r2, p2), kd2 = run(2, inf)
    sr0, sr1, sr2 = sum_abs(r.numpy()), sum_abs(r1), sum_abs(r2)
    hi = (torch.maximum(sr0, sr1) + sr2) / 2
    assert bool(torch.all(torch.maximum(sr0, sr1) < hi)) and kd2 == [2, 2]
    assert bool(torch.all(sr2 > hi))
    calls.clear()
    (x10, r10, p10), kd10 = run(10, hi)
    assert kd10 == [2, 2]
    assert calls == [[True, True], [True, True]]
    for got, want in ((x10, x2), (r10, r2), (p10, p2)):
        np.testing.assert_array_equal(got, want)


def test_k9_plain_k40_equals_k10_once_every_image_died():
    """The gating contract K9's graph route relies on: once every image has
    died (here by iteration 8 at the latest: two reach their stops, one is
    frozen), more iterations change nothing -- x, r, p, rz and k_done of a
    k=40 window equal a k=10 window's."""
    ny, nx, n = 32, 16, 2
    (c, _, x0), _ = _systems(_medium(7, (3, ny, nx), contrast=10.0))
    r = c.b - fvm.apply_operator(c, x0)
    p = r * c.diag_inv
    rz = torch.sum(r * p, dim=(-2, -1))
    row = _port_row(c, n)
    hier = halo._build_sharded_hierarchy_2d(row, ny // n, min_size=4)
    cw = fused2d._coef_windows(hier.sharded)
    tail = fused2d.build_fused_tail(hier.sharded, 4)
    m = _cpu_mesh(n)
    active = torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64)
    inf = torch.full((3,), np.inf, dtype=torch.float64)

    def run(k, stop):
        xs, rs, ps = (mesh.shard_rows(m, t.clone())[0] for t in (x0, r, p))
        out = cgstep_sharded.cg_steps_sharded(
            cw[0], xs, rs, ps, rz.clone(), active, stop, inf, k,
            coarse=lambda rc, live: fused2d.v_cycle_sharded_fused(
                hier, cw, rc, level=1, tail=tail, live=live, **MG),
            omega=0.8, nu=2, over=1.8)
        return [_joined(out[i]) for i in range(3)] + [out[3], out[4]]

    # sum|r| after 0..8 iterations; image 0 stops at the first new least
    # value from iteration 2 on, image 1 at the first from iteration 5 on,
    # each halfway between that value and the least before it
    srs = [np.abs(r.numpy()).sum(axis=(-2, -1))]
    for k in range(1, 9):
        srs.append(np.abs(run(k, torch.zeros(3, dtype=torch.float64))[1])
                   .sum(axis=(-2, -1)))
    srs = np.array(srs)
    stop, died = np.zeros(3), [0, 0, 0]
    for b, first in ((0, 2), (1, 5)):
        died[b] = next(i for i in range(first, 9)
                       if srs[i, b] < srs[:i, b].min())
        stop[b] = (srs[died[b], b] + srs[:died[b], b].min()) / 2
    stop = torch.tensor(stop)
    got10, got40 = run(10, stop), run(40, stop)
    assert got10[4].tolist() == got40[4].tolist() == died
    for a, b in zip(got10[:3], got40[:3]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(got10[3], got40[3])


# ----------------------------------------------------------- whole solves

@pytest.mark.parametrize("layout", ["sp4", "dp2_sp2"])
def test_sharded_mgcg_matches_jax(layout):
    if layout == "sp4":
        d = _medium(6, (64, 32))
        pm, jm = _cpu_mesh(4), jmake_mesh(4, dp=1)
    else:
        d = np.stack([_medium(7, (32, 16), 1e1), _medium(8, (32, 16))])
        pm, jm = _cpu_mesh(4, dp=2), jmake_mesh(4, dp=2)
    (c, s, x0), (jc, js, jx0) = _systems(d)
    kw = dict(tol=1e-7, max_iter=400, check_every=10,
              criterion="relresidual", nu1=2, nu2=2)
    got = halo.sharded_solve_mgcg(c, s, x0, pm, **kw)
    ref = jhalo.sharded_solve_mgcg(jc, js, jx0, jm, use_pallas=True,
                                   pallas_interpret=True, **kw)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=1e-9)
    assert np.all(got.conv.numpy() <= 1e-7)
    assert got.x.shape == x0.shape


@pytest.mark.parametrize("layout", ["sp8", "dp2_sp4"])
def test_sharded_jacobi_matches_jax(layout):
    if layout == "sp8":
        d = _medium(9, (32, 12), 1e1)
        pm, jm = _cpu_mesh(8), jmake_mesh(8, dp=1)
    else:
        d = np.stack([_medium(10, (16, 12), 1e1), _medium(11, (16, 12), 3.0)])
        pm, jm = _cpu_mesh(8, dp=2), jmake_mesh(8, dp=2)
    (c, s, x0), (jc, js, jx0) = _systems(d)
    kw = dict(omega=2.0 / 3.0, tol=1e-6, max_iter=20_000, check_every=50,
              criterion="residual")
    got = halo.sharded_solve_jacobi(c, s, x0, pm, **kw)
    ref = jhalo.sharded_solve_jacobi(jc, js, jx0, jm, **kw)
    np.testing.assert_array_equal(np.atleast_1d(got.iters.numpy()),
                                  np.atleast_1d(np.asarray(ref.iters)))
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-12,
                               atol=1e-14)


def test_sharded_mgcg_refuses_unported_modes():
    d = _medium(12, (32, 16))
    (c, s, x0), _ = _systems(d)
    pm = _cpu_mesh(4)
    # use_pallas=False, 4-row shards and V(nu1 != nu2) run under run_pcg
    # (parallel/sharded_pcg.py; tests/test_torch_sharded_pcg.py and
    # tests/test_torch_general_cycle.py against the JAX package)
    kw = dict(tol=1e-7, max_iter=400, check_every=10, coarse_iters=4,
              criterion="relresidual")
    runs = [halo.sharded_solve_mgcg(c, s, x0, pm, use_pallas=False, **kw),
            halo.sharded_solve_mgcg(c, s, x0, _cpu_mesh(8), **kw)]
    for res in runs:
        assert float(res.conv) <= 1e-7
    np.testing.assert_allclose(float(runs[1].deff), float(runs[0].deff),
                               rtol=1e-6)
    unequal = halo.sharded_solve_mgcg(c, s, x0, pm, nu1=1, nu2=2, **kw)
    assert float(unequal.conv) <= 1e-7
    np.testing.assert_allclose(float(unequal.deff), float(runs[0].deff),
                               rtol=1e-6)
    # use_pallas=True runs V(nu1, nu1) whatever nu2, as the JAX package does
    forced = [halo.sharded_solve_mgcg(c, s, x0, pm, nu1=1, nu2=nu2,
                                      use_pallas=True, **kw)
              for nu2 in (2, 1)]
    assert int(forced[0].iters) == int(forced[1].iters)
    assert torch.equal(forced[0].deff, forced[1].deff)
    assert not fused2d.fused_shard_level_ok(6, 16)
    assert fused2d.shard_band(2048, 2048) == 2048


# ------------------------------------------------------------ the pipeline

def _batch_cfg(tmp_path, name, **kw):
    base = dict(
        n_phase=2, batch_flag=True, d_fluid=1.0, d_solid=0.1,
        convergence=1e-7, max_iter=300_000, check_every=200,
        dtype="float64", criterion="residual",
        output_name=str(tmp_path / name), num_images=3,
        incremental_output=False)
    base.update(kw)
    return SimulationConfig(**base)


def _run_batch(tmp_path, name, **kw):
    # mixed shapes, and a group that does not divide dp (edge padding); the
    # JAX test's sizes for Jacobi, and at least 8 rows a shard at SP=4 for
    # the fused MGCG engine
    n1, n2 = (32, 48) if kw.get("solver") == "mgcg" else (24, 16)
    imgs = [parallel_slab(n1, 0.25), parallel_slab(n2, 0.5),
            parallel_slab(n1, 0.75)]
    return batch_sim(_batch_cfg(tmp_path, name, **kw), imgs=imgs,
                     device="cpu", mesh_devices=[CPU] * 8)


@pytest.mark.parametrize("solver", ["jacobi", "mgcg"])
def test_batch_sim_dp_mesh_identical(tmp_path, solver):
    ref = _run_batch(tmp_path, "a.csv", solver=solver)
    got = _run_batch(tmp_path, "b.csv", solver=solver, devices=8)
    cols = [0, 1, 2, 3, 5, 6, 7, 8]     # all but Time
    np.testing.assert_allclose(got[:, cols], ref[:, cols], rtol=1e-12)


@pytest.mark.parametrize("solver", ["jacobi", "mgcg"])
def test_batch_sim_dp_sp_mesh(tmp_path, solver):
    kw = dict(solver=solver, check_every=10 if solver == "mgcg" else 200)
    ref = _run_batch(tmp_path, "a.csv", **kw)
    got = _run_batch(tmp_path, "b.csv", devices=8, dp=2, sp=4, **kw)
    cols = [0, 1, 2, 3, 5, 7, 8]
    np.testing.assert_allclose(got[:, cols], ref[:, cols],
                               rtol=1e-12 if solver == "jacobi" else 1e-9)
    # conv: the sharded monitors sum per-shard partials, in another order
    np.testing.assert_allclose(got[:, 6], ref[:, 6],
                               rtol=1e-9 if solver == "jacobi" else 1e-6)


def test_batch_sim_3phase_dp_mesh_identical(tmp_path):
    imgs = [three_phase_parallel_slab(24, svf=0.25, lvf=0.5),
            three_phase_parallel_slab(24, svf=0.25, lvf=0.25),
            three_phase_parallel_slab(24, svf=0.5, lvf=0.25)]

    def run(name, **kw):
        cfg = SimulationConfig(
            n_phase=3, batch_flag=True, d_fluid=1.0, d_solid=0.0,
            d_gas=100.0, convergence=1e-8, max_iter=200_000, check_every=100,
            dtype="float64", criterion="residual", solver="mgcg",
            output_name=str(tmp_path / name), num_images=3,
            incremental_output=False, **kw)
        return batch_sim_3phase(cfg, imgs=imgs, device="cpu",
                                mesh_devices=[CPU] * 8)

    ref = run("a.csv")
    got = run("b.csv", devices=8)
    cols = [0, 1, 2, 3, 4, 6, 8, 9, 10]   # all but Time (5) and conv (7)
    np.testing.assert_allclose(got[:, cols], ref[:, cols], rtol=1e-12)
    assert (got[:, 7] < 1e-8).all() and (ref[:, 7] < 1e-8).all()


def test_batch_sim_mesh_refusals(tmp_path):
    with pytest.raises(ValueError, match="SP"):
        _run_batch(tmp_path, "c.csv", solver="jacobi_pallas", devices=8,
                   dp=2, sp=4)
    with pytest.raises(ValueError, match="visible"):
        batch_sim(_batch_cfg(tmp_path, "d.csv", devices=16), device="cpu",
                  imgs=[parallel_slab(32, 0.5)], mesh_devices=[CPU] * 8)


def test_dryrun_twin(tmp_path):
    lines = dryrun_multichip([CPU] * 8, device="cpu", out_dir=str(tmp_path))
    # the 3D leg (z-slab sharded CG) is the second line
    assert len(lines) == 5 and "dp x sp Jacobi" in lines[0]
    assert "3D z-slab sharded CG" in lines[1]
