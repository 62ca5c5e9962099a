"""The port's descriptor training (mods_tpu_torch/desc/train.py) against
the JAX package's (mods_tpu/desc/train.py and the expressions of
tools/train_hardnet.py), on the CPU, the JAX params carried across with
`from_jax_params`.

Tolerances:
- `hardnet_embed`, `hardnet_embed_train` on 64 seeded patches: embeddings
  and new running statistics 1e-5;
- `triplet_margin_loss`: loss 1e-6, the gradients with respect to anchor
  and positive 1e-5 (ties among the hardest negatives split as in JAX);
- `train_loss` on a batch of 16 with duplicate ids: loss 1e-5 relative,
  each weight gradient 1e-3 of its tensor's largest entry, new running
  statistics 1e-5;
- `cosine_adam` against optax on one gradient sequence: 1e-7;
- 3 steps of `make_train_step` under Adam with the cosine schedule, batch
  16 with duplicate ids: loss 1e-4 relative, running statistics 1e-5 after
  the first step and 1e-3 after the third, weights 3e-4 on at least 99.5 %
  of the entries and 2 * lr * steps on all (test_train_steps_match_jax
  says why);
- npz files both ways: forwards 1e-3 on the 0..255 scale (the CNN tests'
  tolerance), whitening included;
- `compute_whitening`: the mean 1e-5, the whitened embeddings 1e-4;
- `split_by_keypoint`: equal; `fpr95`: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mods_tpu.desc import cnn as jcnn
from mods_tpu.desc import train as jtrain
from mods_tpu_torch.config import Config
from mods_tpu_torch.desc import cnn as tcnn
from mods_tpu_torch.desc import train as ttrain
from torch_parity_helpers import one_torch_thread  # noqa: F401  (autouse)


def _patches(n, seed):
    """n 32x32 patches in 0..255: smooth blobs plus noise (not flat)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:32, :32].astype(np.float32)
    c = rng.uniform(8, 24, (n, 2, 1, 1)).astype(np.float32)
    blob = np.exp(-((xx - c[:, 0]) ** 2 + (yy - c[:, 1]) ** 2)
                  / rng.uniform(20, 80, (n, 1, 1)))
    p = 60 + 150 * blob + rng.normal(0, 12, (n, 32, 32))
    return np.clip(p, 0, 255).astype(np.float32)


def _jax_params(seed=0, stats=True):
    """JAX's init_hardnet_params(PRNGKey(seed)), the running statistics
    made non-trivial (seeded) so that eval-mode BN is exercised."""
    params = {k: np.asarray(v) for k, v in
              jtrain.init_hardnet_params(jax.random.PRNGKey(seed)).items()}
    if stats:
        rng = np.random.default_rng(seed + 100)
        for k, v in list(params.items()):
            if k.endswith("_mean"):
                params[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k.endswith("_var"):
                params[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return params


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(_np(t), _np(j), atol=atol, rtol=rtol)


def test_init_and_layers():
    """init_hardnet_params: the JAX package's shapes and scale (normal /
    sqrt(fan)), running means 0 and variances 1, the same net from the same
    seed; to_layers gives an inference HardNet (cnn.params_from_jax) equal
    to quantize(hardnet_embed)."""
    net = ttrain.init_hardnet_params(torch.Generator().manual_seed(3), "cpu")
    again = ttrain.init_hardnet_params(torch.Generator().manual_seed(3), "cpu")
    ref = jtrain.init_hardnet_params(jax.random.PRNGKey(0))
    params = net.params()
    assert sorted(params) == sorted(ref)
    for k, v in ref.items():
        assert params[k].shape == v.shape and params[k].dtype == np.float32, k
        np.testing.assert_array_equal(params[k], again.params()[k])
        if k.startswith("w"):
            fan = np.prod(v.shape[1:])
            assert abs(params[k].std() * np.sqrt(fan) - 1.0) < 0.1, k
        else:
            np.testing.assert_array_equal(params[k], np.asarray(v))
    assert {k for k, _ in net.named_parameters()} == {k for k in ref if k[0] == "w"}
    p = torch.from_numpy(_patches(16, 1))
    inf = tcnn.params_from_jax(net.to_layers(), "hardnet")
    _close(inf(p), tcnn.quantize(ttrain.hardnet_embed(net, p)), 1e-4)


def test_hardnet_embed_matches_jax():
    params = _jax_params()
    net = ttrain.from_jax_params(params, "cpu")
    p = _patches(64, 2)
    _close(ttrain.hardnet_embed(net, torch.from_numpy(p)),
           jtrain.hardnet_embed(params, jnp.asarray(p)), 1e-5)


def test_hardnet_embed_train_matches_jax():
    """Batch-statistics BN (F.batch_norm in training mode) against JAX's
    explicit biased / unbiased variances; the net's own buffers unchanged."""
    params = _jax_params()
    net = ttrain.from_jax_params(params, "cpu")
    p = _patches(64, 3)
    emb, stats = ttrain.hardnet_embed_train(net, torch.from_numpy(p))
    jemb, jstats = jtrain.hardnet_embed_train(params, jnp.asarray(p))
    _close(emb, jemb, 1e-5)
    assert sorted(stats) == sorted(jstats)
    for k in jstats:
        _close(stats[k], jstats[k], 1e-5)
        np.testing.assert_array_equal(net.params()[k], params[k])


def _loss_case(case):
    rng = np.random.default_rng(4)
    n = 24
    a = rng.normal(0, 1, (n, 128)).astype(np.float32)
    p = (a + rng.normal(0, 0.7, (n, 128))).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    ids = None
    if case == "distinct":
        ids = rng.permutation(1000)[:n].astype(np.int64)
    elif case == "duplicates":
        ids = rng.integers(0, 9, n).astype(np.int64)
        # an exact tie: two positives equal, both the hardest negative of an
        # anchor whose id neither shares
        i = int(np.nonzero(ids != ids[0])[0][0])
        j = int(np.nonzero((ids != ids[i]) & (ids != ids[0]))[0][0])
        p[j] = p[0]
        a[i] = p[0] + 1e-3
        a[i] /= np.linalg.norm(a[i])
    return a, p, ids


@pytest.mark.parametrize("case", ["none", "distinct", "duplicates"])
def test_triplet_margin_loss_matches_jax(case):
    a, p, ids = _loss_case(case)
    jids = None if ids is None else jnp.asarray(ids)
    jl, (ga, gp) = jax.value_and_grad(
        lambda x, y: jtrain.triplet_margin_loss(x, y, ids=jids), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(p))
    ta = torch.from_numpy(a).requires_grad_()
    tp = torch.from_numpy(p).requires_grad_()
    loss = ttrain.triplet_margin_loss(ta, tp, ids=None if ids is None
                                      else torch.from_numpy(ids))
    loss.backward()
    _close(loss, jl, 1e-6)
    _close(ta.grad, ga, 1e-5)
    _close(tp.grad, gp, 1e-5)
    assert float(loss.detach()) > 0.0


def _batches(steps, b, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, b // 2, b).astype(np.int64)     # duplicates
        a = _patches(b, int(rng.integers(1 << 30)))
        p = np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.float32)
        out.append((a, p, ids))
    return out


def _jax_loss(params, a, p, ids, train_bn):
    """The loss of make_train_step's loss_fn (mods_tpu/desc/train.py:124-133)."""
    if train_bn:
        emb, _ = jtrain.hardnet_embed_train(params, jnp.concatenate([a, p], 0))
        ea, ep = jnp.split(emb, 2, axis=0)
    else:
        ea, ep = jtrain.hardnet_embed(params, a), jtrain.hardnet_embed(params, p)
    return jtrain.triplet_margin_loss(ea, ep, ids=ids)


@pytest.mark.parametrize("train_bn", [True, False])
def test_train_loss_gradients_match_jax(train_bn):
    """One batch of 16 with duplicate ids: train_loss and its weight
    gradients against jax.grad of the JAX step's loss; each gradient within
    1e-3 of its tensor's largest entry (XLA's and PyTorch's convolutions
    sum in other orders; ~1e-4 read through batch-statistics BN), the new
    running statistics within 1e-5."""
    params = _jax_params(5, stats=not train_bn)
    a, p, ids = _batches(1, 16, 6)[0]
    # op by op: jit's fusions move JAX's own gradients of the first layers
    # by ~1e-3 of their largest entry, eager JAX and the port agree to ~1e-5
    jl, jg = jax.value_and_grad(_jax_loss)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(a), jnp.asarray(p),
        jnp.asarray(ids), train_bn)
    net = ttrain.from_jax_params(params, "cpu")
    loss, stats = ttrain.train_loss(net, torch.from_numpy(a), torch.from_numpy(p),
                                    torch.from_numpy(ids), train_bn)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k, w in net.named_parameters():
        g = np.asarray(jg[k])
        _close(w.grad, g, 1e-3 * np.abs(g).max())
    if train_bn:
        _, jstats = jtrain.hardnet_embed_train(
            params, jnp.concatenate([jnp.asarray(a), jnp.asarray(p)], 0))
        for k in jstats:
            _close(stats[k], jstats[k], 1e-5)
    else:
        assert stats == {}


def test_cosine_adam_matches_optax():
    """The optimizer alone, on one gradient sequence (near-zero entries
    included): cosine_adam against optax.adam(cosine_decay_schedule) over
    and past the schedule's end, weights within 1e-7."""
    rng = np.random.default_rng(18)
    w0 = rng.normal(0, 1, (64,)).astype(np.float32)
    grads = [(rng.normal(0, 1, 64) * 10.0 ** rng.uniform(-9, 0, 64)).astype(np.float32)
             for _ in range(7)]
    opt = optax.adam(optax.cosine_decay_schedule(1e-3, 5))
    jw, state = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = torch.optim.Adam([w], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    net = torch.nn.Module()
    net.w = w
    topt, sched = ttrain.cosine_adam(net, 1e-3, 5)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        w.grad = torch.from_numpy(g)
        topt.step()
        sched.step()
        _close(w, jw, 1e-7)


@pytest.mark.parametrize("train_bn", [True, False])
def test_train_steps_match_jax(train_bn):
    """3 steps of make_train_step(optax.adam(cosine_decay_schedule(1e-3,
    10))) against the port's step with cosine_adam(1e-3, 10), batch 16 with
    duplicate ids: loss per step within 1e-4 relative, running statistics
    within 1e-5 after the first step (from equal weights) and 1e-3 after the
    others (from weights apart as below; 1.1e-4 read).  The weights: at
    least 99.5 % within 3e-4, all within 2 * lr * steps.  An entry whose gradient is within float32 summation
    noise (~1e-9 against a largest entry of ~1e-2) can take opposite signs
    in the two packages, and Adam, which normalizes each entry by its own
    magnitude, moves it by up to lr either way (measured: 340 and 1394 of
    1,334,560 entries beyond 3e-4 after 3 steps)."""
    params = _jax_params(5, stats=not train_bn)
    opt = optax.adam(optax.cosine_decay_schedule(1e-3, 10))
    jstep = jax.jit(jtrain.make_train_step(opt, train_bn=train_bn))
    jstate = opt.init(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    net = ttrain.from_jax_params(params, "cpu")
    topt, sched = ttrain.cosine_adam(net, 1e-3, 10)
    tstep = ttrain.make_train_step(topt, train_bn=train_bn, scheduler=sched)
    for i, (a, p, ids) in enumerate(_batches(3, 16, 6)):
        jparams, jstate, jl = jstep(jparams, jstate, jnp.asarray(a), jnp.asarray(p),
                                    jnp.asarray(ids))
        tl = tstep(net, torch.from_numpy(a), torch.from_numpy(p), torch.from_numpy(ids))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        got = net.params()
        for k in (k for k in jparams if k.startswith("bn")):
            _close(got[k], jparams[k], 1e-5 if i == 0 else 1e-3)
            if not train_bn:
                np.testing.assert_array_equal(got[k], params[k])
    far, total = 0, 0
    for k, v in jparams.items():
        if k.startswith("bn"):
            continue
        v = np.asarray(v)
        d = np.abs(got[k] - v)
        assert d.max() <= 2 * 1e-3 * 3, k
        far, total = far + int((d > 3e-4).sum()), total + d.size
    assert far <= 0.005 * total, (far, total)
    assert sched.get_last_lr()[0] == pytest.approx(
        float(optax.cosine_decay_schedule(1e-3, 10)(3)), rel=1e-6)


def test_npz_port_to_jax(tmp_path):
    """A file the port writes loads into the JAX package's load_hardnet_npz
    (equal arrays) and its cnn._get_params / hardnet_forward, whitening
    included, forwards equal to the port's get_net within 1e-3."""
    net = ttrain.from_jax_params(_jax_params(7), "cpu")
    rng = np.random.default_rng(8)
    mu = rng.normal(0, 0.05, 128).astype(np.float32)
    W = (np.eye(128) + rng.normal(0, 0.05, (128, 128))).astype(np.float32)
    path = str(tmp_path / "port.npz")
    ttrain.save_hardnet_npz(net, path, whiten=(mu, W))
    back = jtrain.load_hardnet_npz(path)
    for k, v in net.params().items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)
    jcfg_params = jcnn._layers_from_state(dict(np.load(path)))
    jparams = {i: {k: jnp.asarray(v) for k, v in p.items()} for i, p in jcfg_params.items()}
    p = _patches(32, 9)
    cfg = Config()
    cfg.hardnet.weights = path
    tnet = tcnn.get_net(cfg, "hardnet", "cpu")
    assert tnet.whitened
    _close(tnet(torch.from_numpy(p)), jcnn.hardnet_forward(jnp.asarray(p), jparams), 1e-3)
    rt = ttrain.load_hardnet_npz(path, "cpu")
    for k, v in net.params().items():
        np.testing.assert_array_equal(rt.params()[k], v)
    tcnn.invalidate_param_cache(path)


def test_npz_jax_to_port(tmp_path):
    """A file the JAX package writes loads into the port's load_hardnet_npz
    and get_net, whitening included."""
    params = _jax_params(10)
    rng = np.random.default_rng(11)
    mu = rng.normal(0, 0.05, 128).astype(np.float32)
    W = (np.eye(128) + rng.normal(0, 0.05, (128, 128))).astype(np.float32)
    path = str(tmp_path / "jax.npz")
    jtrain.save_hardnet_npz(params, path, whiten=(mu, W))
    net = ttrain.load_hardnet_npz(path, "cpu")
    for k, v in params.items():
        np.testing.assert_array_equal(net.params()[k], v)
    layers, _ = tcnn.load_layers(path, "hardnet")
    p = _patches(32, 12)
    jlayers = {i: {k: jnp.asarray(v) for k, v in q.items()}
               for i, q in jcnn._layers_from_state(dict(np.load(path))).items()}
    _close(tcnn.params_from_jax(layers, "hardnet")(torch.from_numpy(p)),
           jcnn.hardnet_forward(jnp.asarray(p), jlayers), 1e-3)


def test_compute_whitening_matches_jax():
    params = _jax_params(13)
    net = ttrain.from_jax_params(params, "cpu")
    p = _patches(256, 14)
    mu, W = ttrain.compute_whitening(net, p, alpha=0.5, batch=128)
    jmu, jW = jtrain.compute_whitening(params, p, alpha=0.5, batch=128)
    _close(mu, jmu, 1e-5)
    X = np.asarray(jtrain.hardnet_embed(params, jnp.asarray(p[:64])))
    _close((X - mu) @ W.T, (X - jmu) @ np.asarray(jW).T, 1e-4)


def _jax_split(kp_ids):
    """tools/train_hardnet.py:123-139's split, as written there."""
    uids = np.unique(kp_ids)
    rs = np.random.default_rng(123)
    rs.shuffle(uids)
    n_val_ids = max(64, len(uids) // 12)
    val_id_set = set(uids[:n_val_ids].tolist())
    is_val = np.asarray([int(i) in val_id_set for i in kp_ids])
    return np.where(is_val)[0][:4096], np.where(~is_val)[0]


@pytest.mark.parametrize("n,n_ids", [(3000, 900), (60000, 20000)])
def test_split_by_keypoint_matches_jax(n, n_ids):
    rng = np.random.default_rng(n)
    ids = (rng.integers(0, n_ids, n) + 1_000_000 * rng.integers(0, 3, n)).astype(np.int64)
    val, tr = ttrain.split_by_keypoint(ids)
    jval, jtr = _jax_split(ids)
    np.testing.assert_array_equal(val, jval)
    np.testing.assert_array_equal(tr, jtr)
    assert not set(ids[val]) & set(ids[tr])


def test_fpr95_matches_jax():
    """fpr95 against tools/train_hardnet.py:159-176's jnp body."""
    params = _jax_params(15)
    rng = np.random.default_rng(16)
    a = _patches(96, 17)
    p = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.float32)
    ids = rng.integers(0, 70, 96).astype(np.int64)

    @jax.jit
    def jfpr95(params, a, p, ids):
        ea = jtrain.hardnet_embed(params, a)
        ep = jtrain.hardnet_embed(params, p)
        d = jnp.sqrt(jnp.maximum(
            jnp.sum(ea ** 2, 1)[:, None] + jnp.sum(ep ** 2, 1)[None, :]
            - 2.0 * ea @ ep.T, 1e-8))
        pos = jnp.diag(d)
        acc = jnp.mean(ids[jnp.argmin(d, axis=1)] == ids)
        th = jnp.percentile(pos, 95.0)
        same = ids[:, None] == ids[None, :]
        neg_mask = ~same
        neg_below = (jnp.sum((d <= th) & neg_mask)
                     / jnp.maximum(jnp.sum(neg_mask), 1))
        return acc, neg_below

    jacc, jneg = jfpr95(params, jnp.asarray(a), jnp.asarray(p), jnp.asarray(ids))
    acc, neg = ttrain.fpr95(ttrain.from_jax_params(params, "cpu"), torch.from_numpy(a),
                            torch.from_numpy(p), torch.from_numpy(ids))
    assert acc == pytest.approx(float(jacc), abs=1e-6)
    assert neg == pytest.approx(float(jneg), abs=1e-6)
    assert 0.0 < neg < 1.0
