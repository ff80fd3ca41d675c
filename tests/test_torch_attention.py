"""Port parity of the serving path's attention: the flash-attention
kernel B21 and the ring-buffer decode kernel B22 (their plain versions
and the port's front ends, which run them on a CPU tensor) against the
reference's Pallas kernels in interpret mode; the dense decode oracle;
the in-place KV ring buffer against the reference's.  Inputs come from
numpy seeds and go to both sides.

Tolerances: 2e-5 on fp32 flash attention (``tests/test_kernels.py``),
0.05 on bf16 (the same file's bf16 case), 1e-4 on decode attention
(``tests/test_decode_attention.py``); cache updates are exact.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import strategies as strat
from repro.kernels import ops as jops
from repro.models import layers as jL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention, sub_block, window_split
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as tL

FLASH_SHAPES = ((128, 4, 4, 64),     # MHA
                (128, 8, 2, 64),     # GQA 4:1
                (128, 4, 1, 64),     # MQA
                (128, 6, 6, 96),     # head dim 96
                (200, 8, 2, 64))     # ragged S (the reference pads to a block)
FILLS = (1, 77, 130, 256, 300, 640)  # past the wraparound of W = 128 and 256


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, Hq, D).astype(np.float32), r.randn(B, Sk, Hkv, D).astype(np.float32),
            r.randn(B, Sk, Hkv, D).astype(np.float32))


def _decode_case(seed, shape, fill):
    """(q, k_cache, v_cache, valid, position) as numpy: ``fill`` tokens
    written into the W-slot ring buffer, the newest at position
    fill - 1; the mask by the ring-distance formula."""
    B, W, Hq, Hkv, D = shape
    r = np.random.RandomState(seed)
    q = r.randn(B, 1, Hq, D).astype(np.float32)
    kc = r.randn(B, W, Hkv, D).astype(np.float32)
    vc = r.randn(B, W, Hkv, D).astype(np.float32)
    pos = fill - 1
    idx = np.arange(W)
    last = pos - np.mod(pos - idx, W)
    valid = np.broadcast_to((last >= 0) & (last > pos - W), (B, W)).copy()
    return q, kc, vc, valid, pos


@pytest.mark.parametrize("causal", (True, False), ids=("causal", "full"))
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_matches_reference_kernel(shape, causal):
    S, Hq, Hkv, D = shape
    q, k, v = _qkv(S + Hq + D, 2, S, S, Hq, Hkv, D)
    want = np.asarray(jops.flash_attention_auto(q, k, v, causal=causal))
    if S % 128 == 0:     # block multiple: the raw kernel needs no padding
        np.testing.assert_allclose(
            np.asarray(jops.flash_attention(q, k, v, causal=causal, bq=128, bk=128)), want,
            atol=2e-5, rtol=2e-5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(ref.flash_attention_ref(tq, tk, tv, causal=causal), want, 2e-5)
    _close(ops.flash_attention_auto(tq, tk, tv, causal=causal), want, 2e-5)
    _close(flash_attention(tq, tk, tv, causal=causal), want, 2e-5)


def test_flash_attention_bf16_matches_reference_kernel():
    q, k, v = _qkv(9, 1, 256, 256, 4, 2, 64)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=True, bq=128, bk=128)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 0.05)


def _top8(x):
    """The top 8 significant bits of fp32 x (x truncated to bf16), as fp32."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _split3(p):
    """B21's split of an fp32 p into three bf16 terms: hi = the top 8
    significant bits of p, mid those of p - hi, lo = p - hi - mid."""
    hi = _top8(p)
    mid = _top8(p - hi)
    return hi, mid, p - hi - mid


@given(st.integers(-100, -1), st.integers(0, 2 ** 23 - 1))
@settings(max_examples=200, deadline=None)
def test_bf16_split_of_p_is_exact(exponent, mantissa):
    """Any fp32 p in [2^-100, 1] is hi + mid + lo exactly, and each term
    is a bf16 value: the three take p's 24 significant bits 8 at a time."""
    p = torch.tensor([np.ldexp(1.0 + mantissa / 2.0 ** 23, exponent), 1.0, 2.0 ** -100],
                     dtype=torch.float32)
    terms = _split3(p)
    for t in terms:
        assert torch.equal(t.bfloat16().float(), t)
    assert torch.equal(sum(t.double() for t in terms), p.double())


def _emulated_flash_bf16(q, k, v, causal):
    """B21's bf16 scheme in torch on the CPU, fp32 output (before the
    rounding to bf16): 64-row kv tiles up to the causal limit, q.k^T of
    the bf16 operands summed in fp32, the online softmax, and p.v as the
    three products hi.v + mid.v + lo.v into one fp32 accumulator."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                                    # (B, Hq, Sq, D)
    kf, vf = (x.float().repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2) for x in (k, v))
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros(B, Hq, Sq, 1)
    acc = torch.zeros(B, Hq, Sq, D)
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, min(Sk, Sq) if causal else Sk, 64):
        cols = k0 + torch.arange(min(64, Sk - k0))[None, :]
        ok = (cols <= rows) if causal else torch.ones_like(cols, dtype=torch.bool)
        s = torch.where(ok, qf @ kf[:, :, k0:k0 + 64].transpose(2, 3) * (1.0 / D ** 0.5), -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr
        for t in _split3(p):
            acc = acc + t.bfloat16().float() @ vf[:, :, k0:k0 + 64]
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


@pytest.mark.parametrize("causal", (True, False), ids=("causal", "full"))
@pytest.mark.parametrize("shape", ((128, 4, 2, 64), (256, 8, 2, 64), (200, 4, 1, 96),
                                   (64, 2, 2, 40)), ids=lambda s: "x".join(map(str, s)))
def test_bf16_scheme_matches_reference_kernel(shape, causal):
    """The emulated bf16 tensor-core scheme against the reference's
    flash_attention (interpret mode) on the same bf16-valued inputs in
    fp32, at the fp32 tolerance 2e-5, before the output rounding."""
    S, Hq, Hkv, D = shape
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(S + Hq + D, 2, S, S, Hq, Hkv, D))
    jq, jk, jv = (x.float().numpy() for x in (q, k, v))
    want = (jops.flash_attention(jq, jk, jv, causal=causal, bq=128, bk=128) if S % 128 == 0
            else jops.flash_attention_auto(jq, jk, jv, causal=causal))
    _close(_emulated_flash_bf16(q, k, v, causal), np.asarray(want), 2e-5)


def test_flash_attention_has_no_backward():
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv(3, 1, 16, 16, 2, 1, 8))
    out = flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        out.sum().backward()


def test_flash_front_end_on_inexpressible_shapes():
    """Causal with Sq != Sk is not the kernel's: on a CPU tensor it warns
    and runs the plain chunked path, equal to the reference's oracle
    fallback.  Non-causal with a ragged Sk (the reference's oracle at its
    kv block 64) is the kernel's, which masks the edge: no warning, and
    the same values."""
    for causal, Sq, Sk in ((False, 64, 100), (True, 32, 64)):
        q, k, v = _qkv(Sq + Sk, 1, Sq, Sk, 2, 2, 32)
        want = jops.flash_attention_auto(q, k, v, causal=causal, bq=64, bk=64)
        ops._warned_fallbacks.clear()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = ops.flash_attention_auto(*map(torch.from_numpy, (q, k, v)), causal=causal)
        warned = [w for w in seen if "not expressible" in str(w.message)]
        assert len(warned) == int(causal), [str(w.message) for w in seen]
        _close(got, want, 2e-5)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("shape", strat.DECODE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_attention_matches_reference_kernel(shape, fill):
    q, kc, vc, valid, pos = _decode_case(fill + sum(shape), shape, fill)
    W = shape[1]
    want = np.asarray(jops.decode_attention(q, kc, vc, valid, bw=128))
    t = [torch.from_numpy(x) for x in (q, kc, vc, valid)]
    _close(ref.decode_attention_ref(*t), want, 1e-4)
    _close(decode_attention(*t), want, 1e-4)
    _close(ops.decode_attention_auto(*t), want, 1e-4)
    w_live = min(pos + 1, W)
    _close(ops.decode_attention_auto(*t, w_live=w_live), want, 1e-4)
    np.testing.assert_allclose(
        np.asarray(jops.decode_attention_auto(q, kc, vc, valid, w_live=w_live)), want,
        atol=1e-4, rtol=1e-4)
    _close(tL.decode_attention(*t, backend="kernel", w_live=w_live), want, 1e-4)
    _close(tL.decode_attention_oracle(*t), jL.decode_attention_oracle(q, kc, vc, valid), 1e-4)


def _emulated_decode_cluster(q, kc, vc, valid):
    """B22's split in torch on the CPU (fp32 inputs): the window cut into
    the cluster's CTA runs (``window_split``), each run walked in
    sub-blocks (``sub_block``) with an online softmax, a sub-block with no
    valid slot in a batch row skipped for that row, then the runs' (m, l,
    acc) combined in rank order, the sum clamped at 1e-30."""
    B, _, Hq, D = q.shape
    W, Hkv = kc.shape[1], kc.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    ctas, run = window_split(W)
    sub = sub_block(D, q.element_size())
    states = []
    for r in range(ctas):
        m = torch.full((B, Hkv, Hq // Hkv, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, Hq // Hkv, D)
        for w0 in range(r * run, min(W, (r + 1) * run), sub):
            w1 = min(w0 + sub, (r + 1) * run, W)
            ok = valid[:, None, None, w0:w1]
            s = torch.einsum("bhgd,bwhd->bhgw", qg, kc[:, w0:w1]) * (1.0 / D ** 0.5)
            s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(ok, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            live = ok.any(-1, keepdim=True)
            l = torch.where(live, l * corr + p.sum(-1, keepdim=True), l)
            acc = torch.where(live, acc * corr + torch.einsum("bhgw,bwhd->bhgd", p, vc[:, w0:w1]),
                              acc)
            m = torch.where(live, m_new, m)
        states.append((m, l, acc))
    M = torch.stack([m for m, _, _ in states]).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros(B, Hkv, Hq // Hkv, D)
    for m, l, acc in states:
        c = torch.exp(m - M)
        L = L + l * c
        A = A + acc * c
    return (A / L.clamp_min(1e-30)).reshape(B, 1, Hq, D)


def test_window_split_covers_the_window():
    """At most 8 CTAs a cluster, runs of about 64 slots, every slot owned
    by exactly one CTA; at the serving window (640) eight runs of 80."""
    assert window_split(640) == (8, 80)
    assert window_split(4096) == (8, 512)
    for W in (1, 5, 64, 65, 128, 200, 256, 511, 640, 1000, 4096):
        ctas, run = window_split(W)
        assert 1 <= ctas <= 8 and (ctas - 1) * run < W <= ctas * run
    assert (sub_block(64, 2), sub_block(128, 2), sub_block(64, 4), sub_block(96, 4)) == (
        128, 128, 128, 64)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("shape", strat.DECODE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cluster_split_matches_reference_kernel(shape, fill):
    """The emulated cluster split of B22 against the reference's
    decode_attention (interpret mode) at 2e-5, wrapped fills included."""
    q, kc, vc, valid, _ = _decode_case(fill + sum(shape) + 1, shape, fill)
    want = np.asarray(jops.decode_attention(q, kc, vc, valid, bw=128))
    _close(_emulated_decode_cluster(*(torch.from_numpy(x) for x in (q, kc, vc, valid))),
           want, 2e-5)


def test_cluster_split_zeros_an_empty_row():
    """A row with no valid slot: every run's state stays empty and the
    combine gives zeros, as the reference kernel; the other row agrees
    with it at 2e-5."""
    q, kc, vc, _, _ = _decode_case(4, (2, 640, 14, 2, 64), 640)
    valid = np.zeros((2, 640), bool)
    valid[1, 70:600] = True
    got = _emulated_decode_cluster(*(torch.from_numpy(x) for x in (q, kc, vc, valid)))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, jops.decode_attention(q, kc, vc, valid, bw=128), 2e-5)


def test_w_live_crop_is_a_view():
    """The crop reads the cache in place: its batch stride is still W·Hkv·D."""
    q, kc, vc, valid, pos = _decode_case(11, (2, 512, 8, 2, 64), 130)
    assert ops.live_window(pos + 1, 512) == 256
    tk = torch.from_numpy(kc)
    seen = []
    orig = ops.decode_attention

    def spy(q_, k_, v_, m_):
        seen.append((k_.shape, k_.stride(), k_.data_ptr() == tk.data_ptr()))
        return orig(q_, k_, v_, m_)

    ops.decode_attention = spy
    try:
        ops.decode_attention_auto(torch.from_numpy(q), tk, torch.from_numpy(vc),
                                  torch.from_numpy(valid), w_live=pos + 1)
    finally:
        ops.decode_attention = orig
    assert seen == [((2, 256, 2, 64), (512 * 2 * 64, 2 * 64, 64, 1), True)]


def test_all_invalid_rows_zero_and_oracle_mean():
    """A row with no valid slot: zeros from B22's plain version (as the
    reference kernel), mean(v) from the dense oracle (as the reference's
    oracle); the other row agrees between the two."""
    q, kc, vc, _, _ = _decode_case(1, (2, 256, 8, 2, 64), 256)
    valid = np.zeros((2, 256), bool)
    valid[1, :5] = True
    t = [torch.from_numpy(x) for x in (q, kc, vc, valid)]
    got = ref.decode_attention_ref(*t)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, jops.decode_attention(q, kc, vc, valid, bw=128), 1e-4)
    oracle = tL.decode_attention_oracle(*t)
    _close(oracle, jL.decode_attention_oracle(q, kc, vc, valid), 1e-4)
    mean_v = torch.from_numpy(vc[0]).mean(0).repeat_interleave(4, 0)     # (Hq, D)
    _close(oracle[0, 0], mean_v.numpy(), 1e-5)
    _close(got[1], oracle[1].numpy(), 1e-4)


def test_decode_dispatch_follows_the_reference_rule():
    """``"auto"`` on a CPU tensor takes B22's plain version only for a
    blocked window of at least two blocks with a ``w_live`` crop (the
    reference's interpret rule), else the oracle: an all-invalid row
    tells the two apart.  ``"kernel"`` on an unblocked window warns and
    runs the oracle; an unknown backend raises."""
    for W, w_live, kernel in ((256, 256, True), (256, None, False), (128, 128, False)):
        q, kc, vc, _, _ = _decode_case(W, (1, W, 4, 2, 32), W)
        t = [torch.from_numpy(x) for x in (q, kc, vc)] + [torch.zeros(1, W, dtype=torch.bool)]
        got = tL.decode_attention(*t, backend="auto", w_live=w_live)
        assert bool((got == 0).all()) is kernel
    q, kc, vc, valid, _ = _decode_case(5, (1, 100, 4, 2, 32), 60)
    t = [torch.from_numpy(x) for x in (q, kc, vc, valid)]
    ops._warned_fallbacks.clear()
    with pytest.warns(RuntimeWarning, match="not a 128-multiple"):
        got = tL.decode_attention(*t, backend="kernel")
    _close(got, jL.decode_attention_oracle(q, kc, vc, valid), 1e-4)
    with pytest.raises(ValueError, match="unknown attention backend"):
        tL.decode_attention(*t, backend="flash")


def test_cpu_wrappers_count_no_launch():
    q, k, v = map(torch.from_numpy, _qkv(2, 1, 32, 32, 2, 1, 16))
    before = (flash_attention.launches, decode_attention.launches)
    flash_attention(q, k, v)
    decode_attention(q[:, :1], k, v, torch.ones(1, 32, dtype=torch.bool))
    assert (flash_attention.launches, decode_attention.launches) == before


@pytest.mark.parametrize("positions", ((5,), (135,), (3, 130, 0), (260, 7, 64)),
                         ids=("scalar", "scalar-wrapped", "rows", "rows-wrapped"))
def test_update_kv_cache_matches_reference(positions):
    """Scalar and per-row positions: cache and mask equal the reference's
    exactly; the port writes in place and returns the same dict."""
    B, W, Hkv, D = 3, 128, 2, 16
    r = np.random.RandomState(len(positions) + positions[0])
    kc, vc = r.randn(2, B, W, Hkv, D).astype(np.float32)
    kn, vn = r.randn(2, B, 1, Hkv, D).astype(np.float32)
    pos = (np.int32(positions[0]) if len(positions) == 1
           else np.asarray(positions, np.int32))
    want, want_valid = jL.update_kv_cache({"k": kc, "v": vc}, kn, vn, pos)
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    got, valid = tL.update_kv_cache(cache, torch.from_numpy(kn), torch.from_numpy(vn),
                                    torch.from_numpy(np.asarray(pos)))
    assert got is cache
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(got[leaf].numpy(), np.asarray(want[leaf]))
    if len(positions) == 1:       # a python int position writes the same
        again = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
        tL.update_kv_cache(again, torch.from_numpy(kn), torch.from_numpy(vn), positions[0])
        assert torch.equal(again["k"], got["k"])
