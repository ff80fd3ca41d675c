"""Port parity of the serving path on the smoke Qwen2-0.5B (2 layers,
d_model 256, 4/2 heads of 32, vocab 512, f32) against the reference:
the window helpers, prefill (last logits and the stacked KV cache), a
few decode steps at scalar and per-row positions, the fixed-batch
loop's tokens, and the continuous-batching loop against the fixed one
(the twin of ``tests/test_serve.py``'s parity test, exact).  The
weights are the reference's, carried across as numpy.

Tolerances: 1e-4 on logits and caches (fp32, other sum orders); tokens
are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.launch import serve as jserve
from repro.models.zoo import get_model as j_get_model
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.config import InputShape
from repro_torch.models.zoo import get_model

ARCH = "qwen2-0.5b"


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def pair():
    """Both models on the reference's PRNGKey(0) weights."""
    jcfg = j_get_smoke(ARCH)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    params = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu")
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, cfg=cfg, model=get_model(cfg),
                params=params)


def _prompts(R, P, vocab=512, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(R, P)).astype(np.int32)


@pytest.mark.parametrize("n", (1, 127, 128, 129, 576, 1000))
def test_round_window_matches_reference(n):
    assert serve.round_window(n) == jserve.round_window(n)


@pytest.mark.parametrize("n,window", ((1, 4096), (256, 4096), (257, 4096), (900, 4096),
                                      (5000, 4096), (575, 640), (60, 128)))
def test_live_bucket_matches_reference(n, window):
    assert serve.live_bucket(n, window) == jserve.live_bucket(n, window)


def test_pad_kv_to_window_matches_reference():
    r = np.random.RandomState(0)
    cache = {"k": r.randn(2, 3, 16, 4, 8).astype(np.float32),
             "v": r.randn(2, 3, 16, 4, 8).astype(np.float32),
             "xk": r.randn(2, 3, 50, 4, 8).astype(np.float32),
             "nested": {"k": r.randn(4, 1, 16, 2, 8).astype(np.float32)}}
    want = jserve.pad_kv_to_window(cache, 64)
    got = serve.pad_kv_to_window(interop.params_from_numpy(cache, device="cpu"), 64)
    for path in (("k",), ("v",), ("xk",), ("nested", "k")):
        g, w = got, want
        for key in path:
            g, w = g[key], w[key]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_prefill_and_decode_steps_match_reference(pair):
    """Prefill logits and cache, then three decode steps at a scalar
    position and two at per-row positions (rows at different depths),
    logits and cache against the reference's each step."""
    jm, m = pair["jmodel"], pair["model"]
    prompts = _prompts(3, 20)
    jlogits, jcache = jm.prefill(pair["jparams"], {"tokens": jnp.asarray(prompts)})
    logits, cache = m.prefill(pair["params"], {"tokens": torch.from_numpy(prompts)})
    _close(logits, jlogits)
    assert cache["k"].shape == (2, 3, 20, 2, 32) and cache["k"].dtype == torch.float32
    for leaf in ("k", "v"):
        _close(cache[leaf], jcache[leaf])

    W = 128
    jcache = jserve.pad_kv_to_window(jcache, W)
    cache = serve.pad_kv_to_window(cache, W)
    jtok = jnp.argmax(jlogits[:, -1], -1)[:, None].astype(jnp.int32)
    tok = torch.from_numpy(np.array(jtok))
    positions = [20, 21, 22, np.array([23, 5, 40], np.int32), np.array([24, 6, 41], np.int32)]
    for pos in positions:
        jlogits, jcache = jm.decode_step(pair["jparams"], jcache, jtok, jnp.asarray(pos))
        logits, got = m.decode_step(pair["params"], cache, tok, torch.as_tensor(pos))
        assert got is cache                      # written in place
        _close(logits, jlogits)
        for leaf in ("k", "v"):
            _close(cache[leaf], jcache[leaf])
        jtok = jnp.argmax(jlogits[:, -1], -1)[:, None].astype(jnp.int32)
        tok = torch.from_numpy(np.array(jtok))


@pytest.mark.parametrize("P,gen", ((12, 6), (250, 5)), ids=("window128", "window256"))
def test_run_fixed_tokens_match_reference(pair, P, gen):
    """The fixed-batch loop's tokens equal the reference's; at a window of
    256 both decode through the decode kernel's route (the reference's
    interpreted kernel, the port's plain version of B22)."""
    prompts = _prompts(3, P, seed=P)
    want, wstats = jserve.run_fixed(pair["jcfg"], pair["jmodel"], pair["jparams"],
                                    jnp.asarray(prompts), gen)
    got, stats = serve.run_fixed(pair["cfg"], pair["model"], pair["params"],
                                 torch.from_numpy(prompts), gen)
    assert stats["window"] == wstats["window"] == serve.round_window(P + gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ("auto", "kernel"))
def test_arrival_matches_fixed_batch_tokens(pair, backend):
    """Per-request tokens from the slot loop equal the fixed-batch run,
    with requests arriving mid-decode and slots reused (the twin of
    tests/test_serve.py's parity test)."""
    cfg = pair["cfg"].replace(attn_backend=backend)
    model = get_model(cfg)
    R, P, gen = 5, 12, 6
    prompts = torch.from_numpy(_prompts(R, P))
    fixed, _ = serve.run_fixed(cfg, model, pair["params"], prompts, gen)
    outs, stats = serve.run_arrival(cfg, model, pair["params"], prompts, gen, slots=2,
                                    arrival_every=2)
    assert stats["decode_steps"] >= gen - 1
    for r in range(R):
        assert len(outs[r]) == gen
        np.testing.assert_array_equal(fixed[r].numpy(), np.asarray(outs[r], np.int32))


def test_kept_logits_match_tokens(pair):
    """``keep_logits``: each kept row's argmax is the token emitted, and
    ``first_mismatch`` finds no mismatch between the loops, and the first
    one in a list with a token changed."""
    R, P, gen = 3, 12, 4
    prompts = torch.from_numpy(_prompts(R, P))
    fixed, fs = serve.run_fixed(pair["cfg"], pair["model"], pair["params"], prompts, gen,
                                keep_logits=True)
    outs, st = serve.run_arrival(pair["cfg"], pair["model"], pair["params"], prompts, gen,
                                 slots=2, keep_logits=True)
    assert torch.equal(torch.stack([x.argmax(-1) for x in fs["logits"]], 1), fixed.long())
    for r in range(R):
        assert [int(x.argmax()) for x in st["logits"][r]] == outs[r]
    per_req = serve.per_request(fs["logits"])
    assert serve.first_mismatch(fixed.tolist(), outs, per_req, st["logits"]) is None
    bad = [list(o) for o in outs]
    bad[1][2] += 1
    req, step, gap, diff = serve.first_mismatch(fixed.tolist(), bad, per_req, st["logits"])
    assert (req, step) == (1, 2) and gap >= 0 and diff <= 1e-4


def test_decode_input_specs_are_meta_tensors(pair):
    model, cfg = pair["model"], pair["cfg"]
    specs = model.input_specs(InputShape("d", 300, 4, "decode"))
    assert (tuple(specs["token"].shape), specs["token"].dtype) == ((4, 1), torch.int32)
    assert (tuple(specs["position"].shape), specs["position"].dtype) == ((), torch.int32)
    for leaf in ("k", "v"):
        t = specs["cache"][leaf]
        assert (tuple(t.shape), t.dtype, t.device.type) == ((2, 4, 300, 2, 32), cfg.cdtype,
                                                            "meta")
    assert model.decode_window(InputShape("long", 100_000, 1, "decode")) == cfg.window


def test_unported_families_raise(pair):
    prompts = torch.zeros((1, 4), dtype=torch.int32)
    for family in ("vlm", "moe"):
        with pytest.raises(NotImplementedError, match="A9"):
            serve._prefill_batch(pair["cfg"].replace(family=family), prompts, 4)
    with pytest.raises(ValueError, match="continuous batching"):
        serve.run_arrival(pair["cfg"].replace(family="ssm"), pair["model"], pair["params"],
                          prompts, 4, slots=1)
