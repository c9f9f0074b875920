"""The port's SASRec serving path against ``repro.models.recsys.sasrec``,
with the JAX weights carried over by ``interop.sasrec_params_from_jax``: at
the smoke config on left-padded histories (as the SASRec paper pads), at
test_models_recsys.py's config on its own histories (pads at the front and
anywhere), and at a two-head variant.  The lookup stage is bit-exact;
everything after it agrees within rtol 1e-5, atol 1e-6 (float32 sums in
another order than XLA's; the floor covers scores near 0)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import sasrec as j_configs  # noqa: E402
from repro.models.recsys import sasrec as J  # noqa: E402
from repro_torch import backend, interop  # noqa: E402
from repro_torch.configs import sasrec as configs  # noqa: E402
from repro_torch.models.recsys import sasrec as M  # noqa: E402

from torch_parity import assert_exact, t  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _left_padded(rng, n_items, B, S):
    """Lengths uniform in S/2..S, as ``repro.data.sasrec_batches`` draws
    them, pads at the front."""
    lens = rng.integers(S // 2, S + 1, B)
    items = rng.integers(1, n_items + 1, (B, S))
    return np.where(np.arange(S)[None, :] >= S - lens[:, None], items,
                    0).astype(np.int32)


def _recsys_test_histories(rng, n_items, B, S):
    """test_models_recsys.py's ``make_batch``: ids in [0, n_items], the
    first three positions padded."""
    seq = rng.integers(0, n_items + 1, (B, S)).astype(np.int32)
    seq[:, :3] = 0
    return seq


CASES = {
    "smoke": (j_configs.smoke_config(), _left_padded),
    "recsys-test": (J.SASRecConfig(n_items=500, embed_dim=16, n_blocks=2,
                                   n_heads=1, seq_len=10),
                    _recsys_test_histories),
    "two-heads": (J.SASRecConfig(n_items=300, embed_dim=16, n_blocks=2,
                                 n_heads=2, seq_len=12), _left_padded),
}


def _port_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name != "dtype"}
    return M.SASRecConfig(**kw)


@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    jcfg, histories = CASES[request.param]
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.sasrec_params_from_jax(jax.tree.map(np.asarray, jparams),
                                            device="cpu")
    rng = np.random.default_rng(1)
    seq = histories(rng, jcfg.n_items, 6, jcfg.seq_len)
    cands = rng.integers(1, jcfg.n_items + 1, (6, 40)).astype(np.int32)
    return jcfg, _port_config(jcfg), jparams, params, seq, cands


def test_config_copies_match():
    for name in ("full_config", "smoke_config"):
        j = getattr(j_configs, name)()
        assert _port_config(j) == getattr(configs, name)()
    assert configs.RECSYS_SHAPES == j_configs.RECSYS_SHAPES
    assert configs.full_config().n_items + 1 == 2 ** 20


def test_lookup_stage_is_bit_exact(model):
    jcfg, cfg, jparams, params, seq, _ = model
    d, S = jcfg.embed_dim, seq.shape[1]
    s = jnp.asarray(seq)
    ref = jparams["item_emb"][s] * (d ** 0.5) + jparams["pos_emb"][None, :S]
    ref = jnp.where((s == 0)[..., None], 0.0, ref)
    for impl in ("cuda", "torch"):
        assert_exact(M.embed(params, cfg, t(seq), impl), ref)


def test_encode_and_scores_match_jax(model):
    jcfg, cfg, jparams, params, seq, cands = model
    s, c = jnp.asarray(seq), jnp.asarray(cands)
    before = dict(backend.LAUNCHES)
    _close(M.encode(params, cfg, t(seq)), J.encode(jparams, jcfg, s))
    _close(M.user_repr(params, cfg, t(seq)), J.user_repr(jparams, jcfg, s))
    full = M.serve_step(params, cfg, t(seq))
    assert full.shape == (6, jcfg.n_items + 1) and full.dtype == torch.float32
    _close(full, J.serve_step(jparams, jcfg, s))
    got = M.score_candidates(params, cfg, t(seq), t(cands))
    _close(got, J.score_candidates(jparams, jcfg, s, c))
    _close(got, np.take_along_axis(full.numpy(), cands, axis=1))
    assert backend.LAUNCHES == before                       # CPU: no launch


def test_routes_agree_bit_for_bit(model):
    _, cfg, _, params, seq, cands = model
    assert torch.equal(M.user_repr(params, cfg, t(seq), impl="cuda"),
                       M.user_repr(params, cfg, t(seq), impl="torch"))
    assert torch.equal(
        M.score_candidates(params, cfg, t(seq), t(cands), impl="cuda"),
        M.score_candidates(params, cfg, t(seq), t(cands), impl="torch"))


def test_topk_matches_jax(model):
    jcfg, cfg, jparams, params, seq, _ = model
    k = 20
    vals, ids = M.serve_step_topk(params, cfg, t(seq), k=k)
    jvals, jids = J.serve_step_topk(jparams, jcfg, jnp.asarray(seq), k=k)
    assert vals.shape == (6, k) and ids.dtype == torch.int32
    _close(vals, jvals)
    # ids agree wherever the value is not tied (within the tolerance) with
    # a neighbour in the ranking
    v = np.asarray(jvals)
    gap = np.minimum(np.abs(np.diff(v, axis=1, prepend=np.inf)),
                     np.abs(np.diff(v, axis=1, append=-np.inf)))
    untied = gap > ATOL + RTOL * np.abs(v)
    assert untied.mean() > 0.5
    np.testing.assert_array_equal(ids.numpy()[untied],
                                  np.asarray(jids)[untied])


def test_right_padded_history_gives_the_zero_user(model):
    """A right-padded history shorter than S: position S - 1 is a pad, its
    hidden state is zeroed, and ln_f of a zero row is ln_f.b (0 at init) --
    in both packages."""
    jcfg, cfg, jparams, params, _, _ = model
    seq = np.zeros((2, jcfg.seq_len), np.int32)
    seq[0, :3] = [5, 9, 2]
    seq[1, :jcfg.seq_len - 1] = 7
    ref = np.asarray(J.user_repr(jparams, jcfg, jnp.asarray(seq)))
    got = M.user_repr(params, cfg, t(seq))
    assert not ref.any()
    assert_exact(got, ref)
    assert not M.serve_step(params, cfg, t(seq)).any()


def test_module_view_shares_the_parameters(model):
    _, cfg, _, params, seq, _ = model
    net = M.SASRec(cfg, params)
    assert net.tree()["blocks"][1]["wq"].data_ptr() == \
        params["blocks"][1]["wq"].data_ptr()
    assert torch.equal(net(t(seq)), M.encode(params, cfg, t(seq)))


def test_init_params_shapes():
    cfg = configs.smoke_config()
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = J.init_params(jax.random.PRNGKey(0), j_configs.smoke_config())
    got_shapes = jax.tree.map(lambda x: tuple(x.shape), p)
    assert got_shapes == jax.tree.map(lambda x: tuple(x.shape), ref)
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(p))
    assert not p["ln_f"]["b"].any() and bool((p["ln_f"]["g"] == 1).all())


def test_sasrec_batches_match_the_reference_layout():
    """The port's (seq, pos, neg) training batches against
    ``repro.data.sasrec_batches``: the same shapes and dtype, right-padded
    histories of lengths in ``seq // 2 .. seq`` (the quirk kept), ``pos``
    the history shifted by one, items in 1..n_items."""
    from repro.data.synthetic import sasrec_batches as j_batches
    from repro_torch.data.synthetic import sasrec_batches
    n_items, B, S = 300, 256, 20
    seq, pos, neg = next(sasrec_batches(n_items, B, S, seed=1, device="cpu"))
    rseq, rpos, rneg = next(j_batches(n_items, B, S, seed=1))
    for got, ref in ((seq, rseq), (pos, rpos), (neg, rneg)):
        assert got.dtype == torch.int32 and got.shape == ref.shape
    lens = (seq > 0).sum(1)
    assert torch.equal(lens, (pos > 0).sum(1))
    assert int(lens.min()) >= S // 2 and int(lens.max()) <= S
    mask = torch.arange(S)[None, :] < lens[:, None]
    assert torch.equal(seq > 0, mask)               # right-padded
    assert torch.equal(pos[:, :-1][mask[:, 1:]], seq[:, 1:][mask[:, 1:]])
    assert int(neg.min()) >= 1 and int(neg.max()) <= n_items
    assert int(seq[mask].min()) >= 1 and int(seq.max()) <= n_items
    assert abs(float(lens.float().mean()) - float((rseq > 0).sum(1).mean())) \
        < 1.0


# ---------------------------------------------------------------------------
# training: loss_fn, its gradients and the lookup plan
# ---------------------------------------------------------------------------

# loss within rtol 1e-5; each gradient leaf's largest difference within
# 1e-4 of its largest |value| (+1e-6): float32 sums in another order
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6


def _train_batch(jcfg, seed=3, B=8):
    from repro.data.synthetic import sasrec_batches as j_batches
    return next(j_batches(jcfg.n_items, B, jcfg.seq_len, seed=seed))


@pytest.fixture(scope="module")
def jax_training():
    """The smoke config's JAX loss and gradients on one ``sasrec_batches``
    batch, with the params and the batch as numpy."""
    jcfg = j_configs.smoke_config()
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    seq, pos, neg = _train_batch(jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: J.loss_fn(p, jcfg, seq, pos, neg)))(jparams)
    return (jcfg, jax.tree.map(np.asarray, jparams), (seq, pos, neg),
            float(loss), [np.asarray(x) for x in jax.tree.leaves(grads)])


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_loss_fn_and_gradients_match_jax(jax_training, impl):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
    the JAX loss at the smoke config; the padding row's gradient is 0 in
    both packages."""
    from repro_torch import tree as T
    from repro_torch.launch.train import value_and_grad
    jcfg, jparams, batch, ref_loss, ref_grads = jax_training
    cfg = _port_config(jcfg)
    params = interop.sasrec_params_from_jax(jparams, device="cpu")
    seq, pos, neg = map(t, batch)
    plan = M.lookup_plan(seq, pos, neg, jcfg.n_items + 1)
    loss, grads = value_and_grad(lambda p, b: M.loss_fn(
        p, cfg, *b, impl=impl, plan=plan))(params, (seq, pos, neg))
    np.testing.assert_allclose(float(loss), ref_loss, rtol=LOSS_RTOL)
    paths, leaves = T.flatten_with_paths(grads)
    assert len(leaves) == len(ref_grads)
    for path, got, ref in zip(paths, leaves, ref_grads):
        diff = float(np.abs(got.numpy() - ref).max())
        assert diff <= GRAD_RTOL * float(np.abs(ref).max()) + GRAD_ATOL, \
            (path, diff)
    row0 = grads["item_emb"][0]
    assert not row0.any() and not ref_grads[paths.index("item_emb")][0].any()


def test_lookup_plan_sum_is_index_add():
    """The plan's sum by item id of the three lookups' lane gradients
    against ``index_add_`` of the same lanes (pads of the history dropped),
    and the plan's layout: the kept lanes stable-sorted by id."""
    from repro_torch.models.plan import lane_sum
    jcfg = j_configs.smoke_config()
    seq, pos, neg = map(t, _train_batch(jcfg, seed=5, B=16))
    V = jcfg.n_items + 1
    plan = M.lookup_plan(seq, pos, neg, V)
    ids = torch.cat([torch.where(seq == 0, -1, seq).reshape(-1),
                     pos.reshape(-1), neg.reshape(-1)])
    lanes = torch.nonzero(ids >= 0).squeeze(1)
    assert torch.equal(plan.dst_order.long(),
                       lanes[torch.sort(ids[lanes], stable=True).indices])
    grad = torch.randn((ids.numel(), 7), generator=torch.Generator()
                       .manual_seed(6))
    ref = torch.zeros((V, 7), dtype=torch.float64).index_add_(
        0, ids[lanes].long(), grad[lanes].double())
    torch.testing.assert_close(lane_sum(plan, "dst", grad).double(), ref,
                               rtol=1e-5, atol=1e-6)


def test_loss_fn_refuses_another_batch_plan(jax_training):
    jcfg, jparams, batch, _, _ = jax_training
    cfg = _port_config(jcfg)
    params = interop.sasrec_params_from_jax(jparams, device="cpu")
    seq, pos, neg = map(t, batch)
    plan = M.lookup_plan(seq, pos, neg, jcfg.n_items + 1)
    with pytest.raises(ValueError, match="another batch"):
        M.loss_fn(params, cfg, seq.clone(), pos, neg, plan=plan)
    # without a plan the kernel route builds one for the call
    np.testing.assert_allclose(
        float(M.loss_fn(params, cfg, seq, pos, neg)),
        float(M.loss_fn(params, cfg, seq, pos, neg, plan=plan)), rtol=0)
