"""The port's data-parallel training step (desc/train.make_sharded_train_step)
on 2 gloo ranks against the JAX package's on a 2 x 1 mesh of the virtual
CPU devices, and against the port's one-process step on the global batch.

Batch 8 with duplicate ids, Adam with the cosine schedule of 1e-3 over 10
steps, one step.  The loss is the global batch's (hardest negatives mined
across both blocks): every rank's equal, within 1e-5 relative of the
one-process loss and 1e-4 relative of JAX's.  The weight gradients every
rank holds after the step are the one-process gradient of the global batch
(1e-4 of each tensor's largest entry; a factor of the world size, which
Adam's first step would hide, fails this) and JAX's (jax.grad of the
global loss, 1e-3, test_torch_train's tolerance).  The weights after the
step, against the one-process step's and JAX's sharded step's: 3e-4 on at
least 99.5 % of the entries, 2 * lr on all (test_torch_train says why)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mods_tpu.desc import train as jtrain
from mods_tpu.parallel.mesh import make_mesh as jmake_mesh
from mods_tpu_torch.desc import train as ttrain
from test_torch_train import _batches, _jax_loss, _jax_params
from torch_parallel_workers import run_ranks, train_rank
from torch_parity_helpers import one_torch_thread  # noqa: F401  (autouse)

JOIN_S = 150.0
LR = 1e-3


def _weights_close(got, ref):
    far, total = 0, 0
    for k, v in ref.items():
        d = np.abs(got[k] - np.asarray(v))
        if k.startswith("bn"):
            assert d.max() == 0.0, k       # eval-mode BN: never updated
            continue
        assert d.max() <= 2 * LR, k
        far, total = far + int((d > 3e-4).sum()), total + d.size
    assert far <= 0.005 * total, (far, total)


def test_sharded_train_step_matches_jax_and_one_process(tmp_path):
    if len(jax.devices()) < 2:
        pytest.fail("conftest.py gives the JAX package 8 virtual CPU devices")
    params = _jax_params(19)
    a, p, ids = _batches(1, 8, 20)[0]
    opt = optax.adam(optax.cosine_decay_schedule(LR, 10))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def jax_run():
        mesh = jmake_mesh(n_data=2, n_model=1)
        step = jtrain.make_sharded_train_step(mesh, opt)
        with mesh:
            out, _, loss = step(jparams, opt.init(jparams), jnp.asarray(a),
                                jnp.asarray(p), jnp.asarray(ids))
        return {k: np.asarray(v) for k, v in out.items()}, float(loss)

    jout, jloss = run_ranks(train_rank, 2, (params, a, p, ids, str(tmp_path)), JOIN_S,
                            during=jax_run)
    ranks = [dict(np.load(tmp_path / f"train{r}.npz")) for r in range(2)]

    # the one-process step on the global batch
    net = ttrain.from_jax_params(params, "cpu")
    topt, sched = ttrain.cosine_adam(net, LR, 10)
    loss1 = float(ttrain.make_train_step(topt, scheduler=sched)(
        net, torch.from_numpy(a), torch.from_numpy(p), torch.from_numpy(ids)))
    grads1 = {k: w.grad.numpy() for k, w in net.named_parameters()}
    _, jgrads = jax.value_and_grad(_jax_loss)(
        jparams, jnp.asarray(a), jnp.asarray(p), jnp.asarray(ids), False)

    for z in ranks:
        assert "uneven_raised" in z
        assert float(z["loss"]) == float(ranks[0]["loss"])
        np.testing.assert_allclose(float(z["loss"]), loss1, rtol=1e-5)
        np.testing.assert_allclose(float(z["loss"]), jloss, rtol=1e-4)
        for k, g in grads1.items():
            scale = np.abs(g).max()
            np.testing.assert_allclose(z[f"g_{k}"], g, rtol=0, atol=1e-4 * scale)
            np.testing.assert_allclose(z[f"g_{k}"], np.asarray(jgrads[k]), rtol=0,
                                       atol=1e-3 * scale)
        got = {k[2:]: v for k, v in z.items() if k.startswith("w_")}
        _weights_close(got, net.params())
        _weights_close(got, jout)
    assert loss1 > 0.0
