"""The port's multi-process path (mods_tpu_torch/parallel/) against the
JAX package's (mods_tpu/parallel/), on the CPU.

The JAX package shards over the 8 virtual CPU devices of conftest.py; the
port over gloo process groups, one spawned process a rank
(tests/torch_parallel_workers.py), joined with a timeout: a rank still
running then fails the test.  NCCL across cards is tools/mesh_check.py's
(four cards of one host); several hosts are exercised nowhere."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mods_tpu.config import Config as JConfig
from mods_tpu.parallel import distributed as jdist
from mods_tpu.parallel.mesh import batch_match_sharded as jbatch_match_sharded
from mods_tpu.parallel.mesh import make_mesh as jmake_mesh
from mods_tpu.parallel.mesh import sharded_knn as jsharded_knn
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.match.matching import _knn
from mods_tpu_torch.models import flagship
from mods_tpu_torch.parallel import distributed as tdist
from mods_tpu_torch.testing import rolled_pair
from torch_parallel_workers import batch_rank, knn_rank, run_ranks
from torch_parity_helpers import one_torch_thread  # noqa: F401  (autouse)

JOIN_S = 150.0


@pytest.mark.parametrize("n,nproc", [(0, 1), (7, 1), (7, 2), (10, 4), (3, 5)])
def test_shard_list(n, nproc):
    items = [(f"im{i}.png", f"im{i}.npz") for i in range(n)]
    shares = [tdist.shard_list(items, p, nproc) for p in range(nproc)]
    assert shares == [jdist.shard_list(items, p, nproc) for p in range(nproc)]
    assert sorted(x for s in shares for x in s) == sorted(items)


def test_init_distributed_single_process(monkeypatch):
    import torch.distributed as dist
    for k in ("MODS_TPU_COORDINATOR", "MODS_TPU_NUM_PROCESSES", "MODS_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_distributed(device="cpu") == (0, 1)
    monkeypatch.setenv("MODS_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("MODS_TPU_PROCESS_ID", "0")
    assert tdist.init_distributed(device="cpu") == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        tdist.init_distributed(num_processes=2, process_id=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdist.init_distributed()


def test_sharded_knn_matches_jax(tmp_path):
    """A 2 x 2 mesh of gloo ranks against the JAX package's 4 x 2 mesh:
    tie-heavy integer descriptors (distances exact) and uniform ones.  On
    a 4 x 1 mesh (one database block) equal to the dense _knn."""
    if len(jax.devices()) < 8:
        pytest.fail("conftest.py gives the JAX package 8 virtual CPU devices")
    rng = np.random.default_rng(8)
    cases = [(rng.integers(0, 3, (64, 128)).astype(np.float32),
              rng.integers(0, 3, (300, 128)).astype(np.float32), 50),
             (rng.uniform(0, 1, (32, 128)).astype(np.float32),
              rng.uniform(0, 1, (64, 128)).astype(np.float32), 8)]
    run_ranks(knn_rank, 4, (2, 2, cases, str(tmp_path)), JOIN_S)
    ranks = [dict(np.load(tmp_path / f"knn{r}.npz")) for r in range(4)]
    mesh = jmake_mesh(n_data=4, n_model=2)
    for i, (q, db, k) in enumerate(cases):
        td, ti = ranks[0][f"d{i}"], ranks[0][f"idx{i}"]
        for z in ranks[1:]:          # every rank holds the whole result
            np.testing.assert_array_equal(z[f"d{i}"], td)
            np.testing.assert_array_equal(z[f"idx{i}"], ti)
        jd, ji = (np.asarray(a) for a in jsharded_knn(mesh, jnp.asarray(q),
                                                      jnp.asarray(db), k=k))
        dense = np.sum((q[:, None].astype(np.float64) - db[None]) ** 2, -1)
        dd, di = _knn(torch.from_numpy(q), torch.from_numpy(db),
                      torch.ones(len(db), dtype=torch.bool), k, i == 0)
        for z in ranks:
            np.testing.assert_array_equal(z[f"d1_{i}"], dd.numpy())
            np.testing.assert_array_equal(z[f"idx1_{i}"], di.numpy())
        if i == 0:
            # integer distances: exact; the same neighbours below the k-th
            # distance, ties lower index first, as the dense _knn
            np.testing.assert_array_equal(td, jd)
            for r in range(len(q)):
                below = td[r] < td[r, -1]
                assert set(ti[r][below]) == set(ji[r][below])
            np.testing.assert_array_equal(td, dd.numpy())
            np.testing.assert_array_equal(ti, di.numpy())
        else:
            np.testing.assert_allclose(td, jd, atol=1e-4, rtol=0)
            np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(np.take_along_axis(dense, ti, 1), td, atol=1e-4)
    assert all("uneven_raised" in z for z in ranks)


def _flagship_draws(key, cfg, max_kp):
    """The RANSAC uniforms the JAX flagship draws from `key`
    (test_torch_flagship.run_both), under the port's names."""
    (sb, sm), (lb, lm) = flagship.ransac_draw_shapes(cfg, max_kp)
    k1, k2, _ = jax.random.split(key, 3)
    return {"u_sweep": torch.from_numpy(np.array(jax.random.uniform(k1, (sb, sm)))),
            "u_lo": torch.from_numpy(np.array(jax.random.uniform(k2, (lb, lm))))}


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """4 96x128 rolled pairs, pair i with PRNGKey(i): the JAX package's
    batch_match_sharded over "data" on a 4 x 2 mesh of the virtual CPU
    devices, the port's over 2 gloo ranks given each key's uniforms, and
    the port's match_pairs with the same uniforms."""
    if len(jax.devices()) < 8:
        pytest.fail("conftest.py gives the JAX package 8 virtual CPU devices")
    jcfg = JConfig()
    jcfg.max_octave_cands = max_kp = 128
    cfg = from_dict(dataclasses.asdict(jcfg))
    pairs = [rolled_pair(96, 128, 7 + i) for i in range(4)]
    imgs1 = np.stack([p[0] for p in pairs])
    imgs2 = np.stack([p[1] for p in pairs])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4, dtype=jnp.uint32))
    draws = [_flagship_draws(keys[i], cfg, max_kp) for i in range(4)]
    out = tmp_path_factory.mktemp("batch")
    jax_run = lambda: [np.asarray(a) for a in jbatch_match_sharded(
        jmake_mesh(n_data=4, n_model=2), jcfg, jnp.asarray(imgs1),
        jnp.asarray(imgs2), keys, max_kp=max_kp)]
    jH, jinl, jtent = run_ranks(batch_rank, 2, (imgs1, imgs2, cfg, draws, max_kp, str(out)),
                                JOIN_S, during=jax_run)
    ranks = [np.load(out / f"batch{r}.npz") for r in range(2)]
    H, inl, tent, _, _ = flagship.match_pairs(imgs1, imgs2, cfg, max_kp, draws=draws,
                                              device="cpu")
    return ranks, (jH, jinl, jtent), (H.numpy(), inl.numpy(), tent.numpy())


def test_batch_match_sharded_matches_jax(batch):
    """Each rank's result against the JAX package's on the same pairs and
    keys, within test_torch_flagship.py's tolerances: corners within
    0.5 px under H, tentatives within 2 %, inliers within 2 or 3 %."""
    ranks, (jH, jinl, jtent), _ = batch
    c = np.array([[0, 0, 1], [127, 0, 1], [0, 95, 1], [127, 95, 1]], float).T
    assert (jinl >= 5).all()
    for z in ranks:
        for i in range(4):
            pj, pt = jH[i] @ c, z["H"][i].astype(np.float64) @ c
            assert np.abs(pt[:2] / pt[2] - pj[:2] / pj[2]).max() < 0.5, i
            assert abs(int(z["tent"][i]) - int(jtent[i])) <= 0.02 * jtent[i], i
            assert abs(int(z["inl"][i]) - int(jinl[i])) <= max(2, 0.03 * jinl[i]), i


def test_batch_match_sharded_equals_match_pairs(batch):
    """Every rank holds the whole batch, equal to match_pairs with the same
    draws (H to 1e-5, counts equal): a pair's result does not depend on
    the rank that took it; a batch that does not split over the ranks
    raises."""
    ranks, _, (H, inl, tent) = batch
    for z in ranks:
        np.testing.assert_allclose(z["H"], H, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(z["inl"], inl)
        np.testing.assert_array_equal(z["tent"], tent)
        assert "uneven_raised" in z.files
    assert (inl >= 5).all()
