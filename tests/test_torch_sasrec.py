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
