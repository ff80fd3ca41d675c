"""Port parity on the cross-silo LLM path, on the smoke Qwen2-0.5B
(2 layers, d_model 256, 4/2 heads of 32, d_ff 1024, vocab 512, f32):
the token stream, the config, the dense model's layers, forward and
loss on the reference's weights carried across as numpy, the feature
probe's projectors, the aggregate, and an AdamW fine-tune step against
the reference's.

Tolerances: 1e-4 on layers, logits, loss and projectors (fp32, other
sum orders), 1e-3 on the aggregate (the reference's aggregate tests),
1e-5 on parameters after two AdamW steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.core.maecho import MAEchoConfig as JCfg
from repro.data.synthetic import lm_token_batches as j_tokens
from repro.fl import llm_adapter as jla
from repro.models import layers as jL
from repro.models.zoo import get_model as j_get_model
from repro.optim import adamw as j_adamw
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.maecho import MAEchoConfig
from repro_torch.data.synthetic import lm_token_batches
from repro_torch.fl import llm_adapter as tla
from repro_torch.models import layers as tL
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.zoo import get_model
from repro_torch.optim.optimizers import adamw
from repro_torch.utils import trees

ARCH = "qwen2-0.5b"


def to_port(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _tree_close(got, want, tol):
    for (path, g), w in zip(trees.tree_paths(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=tol,
                                   err_msg=path)


def _batches(seed, n):
    return list(lm_token_batches(512, 8, 64, n, seed=seed))


@pytest.fixture(scope="module")
def ref_side():
    """The reference's smoke model: two inits as two silos, their
    projectors from two probe batches of each domain."""
    cfg = j_get_smoke(ARCH)
    model = j_get_model(cfg)
    silos = [model.init_params(jax.random.PRNGKey(s)) for s in (0, 1)]
    probes = [_batches(dom, 2) for dom in (101, 202)]
    projs = [jla.build_projections(cfg, p, [{k: jnp.asarray(v) for k, v in b.items()}
                                            for b in pr])
             for p, pr in zip(silos, probes)]
    return dict(cfg=cfg, model=model, silos=silos, probes=probes, projs=projs)


@pytest.mark.parametrize("seed", (0, 101, 202))
def test_lm_token_batches_bit_identical(seed):
    want = list(j_tokens(512, 4, 32, 3, seed=seed))
    got = list(lm_token_batches(512, 4, 32, 3, seed=seed))
    for g, w in zip(got, want, strict=True):
        for k in ("tokens", "labels"):
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


@pytest.mark.parametrize("full", (False, True), ids=("smoke", "full"))
def test_config_fields_equal(full):
    got = (get_config if full else get_smoke_config)(ARCH)
    want = (j_get_config if full else j_get_smoke)(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hd() == want.hd()
    assert got.pdtype == torch.float32
    assert got.cdtype == (torch.bfloat16 if full else torch.float32)


def test_unported_archs_and_families_raise():
    with pytest.raises(NotImplementedError, match="A9"):
        get_config("llama3-8b")
    with pytest.raises(NotImplementedError, match="A9"):
        get_model(ModelConfig(name="m", family="moe", n_layers=1, d_model=8,
                              n_heads=1, n_kv_heads=1, d_ff=8, vocab=8))
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("no-such-model")


def test_layers_match_reference():
    r = np.random.RandomState(3)
    x = r.randn(2, 40, 4, 32).astype(np.float32)
    k = r.randn(2, 40, 2, 32).astype(np.float32)
    v = r.randn(2, 40, 2, 32).astype(np.float32)
    g = (r.rand(32) + 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    _close(tL.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5),
           jL.rms_norm(x, g, 1e-5), 1e-4)
    _close(tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e6),
           jL.apply_rope(x, pos, 1e6), 1e-4)
    qt, kt, vt = map(torch.from_numpy, (x, k, v))
    for causal in (True, False):
        for qc, kc in ((64, 64), (16, 12)):       # one chunk; ragged chunks
            want = jL.chunked_attention(x, k, v, causal=causal, q_chunk=qc, k_chunk=kc)
            _close(tL.chunked_attention(qt, kt, vt, causal=causal, q_chunk=qc,
                                        k_chunk=kc), want, 1e-4)
            _close(tL.prefill_attention(qt, kt, vt, causal=causal, q_chunk=qc,
                                        k_chunk=kc, backend="auto"), want, 1e-4)


def test_prefill_attention_kernel_backend_raises():
    """``"kernel"`` on a CPU tensor runs B21's plain version, equal to
    ``"oracle"``; on a shape B21 cannot express it warns and runs the
    plain chunked path; an unknown backend still raises."""
    r = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(r.randn(1, 40, h, 16).astype(np.float32)) for h in (4, 2, 2))
    for causal in (True, False):
        torch.testing.assert_close(
            tL.prefill_attention(q, k, v, causal=causal, backend="kernel"),
            tL.prefill_attention(q, k, v, causal=causal, backend="oracle"),
            atol=2e-5, rtol=2e-5)
    from repro_torch.kernels import ops
    ops._warned_fallbacks.clear()
    with pytest.warns(RuntimeWarning, match="not expressible"):
        tL.prefill_attention(q, k, v, q_offset=3, backend="kernel")
    with pytest.raises(ValueError, match="unknown attention backend"):
        tL.prefill_attention(q, k, v, backend="flash")


def test_forward_and_loss_match_reference(ref_side):
    cfg, model = get_smoke_config(ARCH), get_model(get_smoke_config(ARCH))
    params = to_port(ref_side["silos"][0])
    batch = _batches(7, 1)[0]
    want_logits = ref_side["model"].forward(ref_side["silos"][0], batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        _close(model.forward(params, tb), want_logits, 1e-4)
        _close(model.loss_fn(params, tb), ref_side["model"].loss_fn(
            ref_side["silos"][0], batch), 1e-4)
    assert cfg.remat is False


def test_build_projections_match_reference(ref_side):
    cfg = get_smoke_config(ARCH)
    got = tla.build_projections(cfg, to_port(ref_side["silos"][1]),
                                ref_side["probes"][1])
    _tree_close(got, ref_side["projs"][1], 1e-4)
    assert tuple(got["layers"]["wq"].shape) == (2, 256, 256)
    assert got["layers"]["wq"] is got["layers"]["wv"]     # one shared stream
    assert tuple(got["embed"].shape) == (512,)
    assert tuple(got["layers"]["wo"].shape) == (2,)


def test_input_specs_are_meta_tensors():
    model = get_model(get_smoke_config(ARCH))
    specs = model.input_specs(InputShape("t", 64, 8, "train"))
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in specs.items()} == {
        k: ((8, 64), torch.int32, "meta") for k in ("tokens", "labels")}
    specs = model.input_specs(InputShape("d", 64, 8, "decode"))
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in
            [("token", specs["token"]), ("position", specs["position"]),
             ("k", specs["cache"]["k"]), ("v", specs["cache"]["v"])]} == {
        "token": ((8, 1), torch.int32, "meta"), "position": ((), torch.int32, "meta"),
        "k": ((2, 8, 64, 2, 32), torch.float32, "meta"),
        "v": ((2, 8, 64, 2, 32), torch.float32, "meta")}


def test_default_llm_projections_shapes():
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init_params(0, device="cpu")
    support = (torch.arange(cfg.vocab) % 3 == 0).float()
    P = tla.default_llm_projections(cfg, params, token_support=support)
    shapes = {p: tuple(x.shape) for p, x in trees.tree_paths(P)}
    assert shapes["embed"] == (512,) and shapes["ln_f"] == ()
    assert all(shapes[p] == (2,) for p in shapes if p.startswith("layers."))
    assert torch.equal(P["embed"], support)
    want = jla.default_llm_projections(
        j_get_smoke(ARCH), interop.params_to_numpy(params),
        token_support=support.numpy())
    assert shapes == {p: tuple(np.shape(x)) for p, x in
                      zip(shapes, jax.tree_util.tree_leaves(want))}


def test_aggregate_llm_matches_reference(ref_side):
    cfg = get_smoke_config(ARCH)
    macfg = dict(tau=3, eta=0.5, mu=20.0)
    want = jla.aggregate_llm(ref_side["cfg"], ref_side["silos"], ref_side["projs"],
                             JCfg(**macfg))
    got = tla.aggregate_llm(cfg, [to_port(p) for p in ref_side["silos"]],
                            [to_port(p) for p in ref_side["projs"]],
                            MAEchoConfig(**macfg), backend="kernel", device="cpu")
    _tree_close(got, want, 1e-3)


@pytest.mark.parametrize("micro", (1, 2))
def test_adamw_finetune_matches_reference(ref_side, micro):
    """Two AdamW(1e-3) fine-tune steps from the reference's weights, with
    and without gradient accumulation over microbatches, against the
    reference's: each train step's loss and gradients (both train steps
    driven with an optimizer that hands the gradients back), and the
    port's ``adamw`` updates on the same gradients, parameters and
    moments.  Parameters are not compared after two independent
    fine-tunes: Adam's first step moves a weight by lr·g/(|g| + 1e-8),
    which turns the ~1e-9 summation-order noise of a gradient near 1e-8
    into ~1e-5 of the weight."""
    from repro.optim import Optimizer as JOpt
    from repro_torch.optim.optimizers import Optimizer

    cfg = get_smoke_config(ARCH).replace(microbatches=micro)
    jcfg = ref_side["cfg"].replace(microbatches=micro)
    jgrad_step = jax.jit(j_get_model(jcfg).make_train_step(
        JOpt(lambda p: {}, lambda g, s, p, t: (g, s))))
    grad_step = get_model(cfg).make_train_step(
        Optimizer(lambda p: {}, lambda g, s, p, t: (g, s)))
    jopt, opt = j_adamw(1e-3), adamw(1e-3)
    jparams = ref_side["silos"][0]
    jstate = jopt.init(jparams)
    params, state = to_port(jparams), to_port(jstate)
    for t, b in enumerate(_batches(101, 2)):
        jgrads, _, jloss = jgrad_step(jparams, {}, b, jnp.int32(t))
        grads, _, loss = grad_step(params, {}, {k: torch.from_numpy(v)
                                                for k, v in b.items()}, t)
        _close(loss, jloss, 1e-5)
        _tree_close(grads, jgrads, 1e-5)
        jparams, jstate = jopt.update(jgrads, jstate, jparams, jnp.int32(t))
        params, state = opt.update(to_port(jgrads), state, params, t)
        _tree_close(params, jparams, 1e-5)
        _tree_close(state, jstate, 1e-5)
    assert not any(p.requires_grad for _, p in trees.tree_paths(params))
