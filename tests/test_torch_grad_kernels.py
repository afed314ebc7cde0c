"""The backward kernels' plain versions on the CPU, and the autograd
Functions around the two model kernels.

``flash_attention_bwd_ref`` against ``jax.grad`` of the reference's
``attention_ref_op`` (n_rep 1 and 5, a sliding window, non-causal, D 16
and 64) and against autograd of the port's plain forward
(``flash_attention_ref``); ``linear_scan_bwd_ref`` against ``jax.grad`` of
the reference's ``linear_scan_ref`` (with and without u) and against
autograd of the port's plain forward with ``s0`` and ``dS_T`` (u one row
a bh or one a head), each also at the edges of the card kernels' tiles
(65 tokens, a window of 64 over 130, T 65, Dv 128).  All float32;
limits 2e-5 for attention and 1e-4 for the scan relative to the
gradient's largest magnitude (the forwards' own tolerances: the sums run
in another order).  The plain forward's log-sum-exp (``return_lse``,
which the card's backward reads) equals ``torch.logsumexp`` of the
masked logits, and asking for it leaves the output as it was.  The
backward kernels' phase trace finds every anchor it stamps.  In bfloat16 the plain
attention backward rounds p as the forward does and agrees with its
float32 value within bfloat16's precision.

The Functions (``ops.flash_attention``, ``ops.linear_scan``): with no
input needing a gradient they are the forward op itself (nothing saved,
no backward launch); with one, a CPU tensor's backward runs the plain
backward through the registry (which counts launches only on the card);
a gradient through a cached attention call raises; attention's
gradients through the model's strided ``[B, S, H, D]`` views equal
those of contiguous inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import attention_ref_op
from repro.kernels.linear_scan.ref import linear_scan_ref as j_scan_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.linear_scan.ref import (linear_scan_bwd_ref,
                                                 linear_scan_ref)

ATTN_RTOL = 2e-5
SCAN_RTOL = 1e-4
T = torch.from_numpy


def _close(got, want, rtol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0,
                               err_msg=what)


def _attn(bh_kv, n_rep, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (bh_kv * n_rep, sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (bh_kv, skv, d)).astype(np.float32)
    v = rng.normal(0, 1, (bh_kv, skv, d)).astype(np.float32)
    do = rng.normal(0, 1, (bh_kv * n_rep, sq, d)).astype(np.float32)
    return q, k, v, do


ATTN_CASES = [  # causal, window, sq, skv, n_rep, d
    (True, None, 24, 24, 1, 16), (True, None, 24, 24, 5, 64),
    (True, 8, 40, 40, 5, 16), (True, 16, 33, 33, 1, 64),
    (False, None, 12, 20, 2, 16), (True, None, 6, 30, 1, 16),
    # the wgmma body's 64-row tile edges: one row past a tile, and a
    # window of 64 whose rows span three tiles
    (True, None, 65, 65, 5, 64), (True, 64, 130, 130, 5, 64),
]


@pytest.mark.parametrize("causal,window,sq,skv,n_rep,d", ATTN_CASES)
def test_attention_bwd_ref_matches_jax_grad(causal, window, sq, skv, n_rep,
                                            d):
    q, k, v, do = _attn(2, n_rep, sq, skv, d, sq + 7 * n_rep)

    def loss(q, k, v):
        o = attention_ref_op(q, k, v, causal=causal, window=window,
                             n_rep=n_rep)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    o = flash_attention_ref(T(q), T(k), T(v), causal=causal, window=window,
                            n_rep=n_rep)
    got = flash_attention_bwd_ref(T(q), T(k), T(v), o, T(do), causal=causal,
                                  window=window, n_rep=n_rep)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, ATTN_RTOL, f"d{name}")


@pytest.mark.parametrize("causal,window,sq,skv,n_rep,d", ATTN_CASES + [
    (True, None, 9, 5, 1, 16)])          # rows that see no key
def test_attention_bwd_ref_matches_autograd(causal, window, sq, skv, n_rep,
                                            d):
    q, k, v, do = (T(x).reshape(1, -1, *x.shape[1:])
                   for x in _attn(2, n_rep, sq, skv, d, 3 + sq))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_attention_ref(*leaves, causal=causal, window=window,
                            n_rep=n_rep)
    want = torch.autograd.grad((o * do).sum(), leaves)
    got = flash_attention_bwd_ref(q, k, v, o.detach(), do, causal=causal,
                                  window=window, n_rep=n_rep)
    for name, g, w in zip("qkv", got, want):
        _close(g, w.numpy(), ATTN_RTOL, f"d{name}")


def test_attention_bwd_ref_bfloat16():
    """bfloat16 inputs: gradients in bfloat16, within bfloat16's precision
    of the float32 plain backward on the same (rounded) inputs."""
    q, k, v, do = (T(x).to(torch.bfloat16) for x in _attn(1, 5, 32, 32, 64, 1))
    o = flash_attention_ref(q, k, v, causal=True, n_rep=5)
    got = flash_attention_bwd_ref(q, k, v, o, do, causal=True, n_rep=5)
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                   o.float(), do.float(), causal=True,
                                   n_rep=5)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        _close(g, w.numpy(), 2 ** -6)


@pytest.mark.parametrize("causal,window,sq,skv,n_rep", [
    (True, None, 65, 65, 5), (True, 64, 130, 130, 5),
    (False, None, 12, 20, 2), (True, None, 9, 5, 1)])
def test_attention_lse_is_logsumexp_of_masked_logits(causal, window, sq,
                                                     skv, n_rep):
    """``return_lse``: each row's log-sum-exp of its masked logits (what
    the backward's P is taken from), and the output exactly what a call
    without it returns."""
    q, k, v, _ = (T(x).reshape(1, -1, *x.shape[1:])
                  for x in _attn(2, n_rep, sq, skv, 64, sq + skv))
    kw = dict(causal=causal, window=window, n_rep=n_rep)
    out, lse = flash_ops.flash_attention_op(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, flash_ops.flash_attention_op(q, k, v, **kw))
    kk = k.repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) * 64 ** -0.5
    pos = torch.arange(sq)[:, None] + skv - sq
    key = torch.arange(skv)
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= pos >= key
    if window:
        mask &= pos - key < window
    want = torch.logsumexp(torch.where(mask, s, -1e30), dim=-1)
    assert lse.shape == (1, 2 * n_rep, sq) and lse.dtype == torch.float32
    _close(lse, want.numpy(), 1e-6)


def _scan(bh, t, dk, dv, seed, u_rows=None, s0=False):
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 1, (bh, t, dk)).astype(np.float32)
    k = rng.normal(0, 1, (bh, t, dk)).astype(np.float32)
    v = rng.normal(0, 1, (bh, t, dv)).astype(np.float32)
    w = rng.uniform(0.3, 1.0, (bh, t, dk)).astype(np.float32)
    u = (None if u_rows is None
         else rng.normal(0, 1, (u_rows, dk)).astype(np.float32))
    s = rng.normal(0, 1, (bh, dk, dv)).astype(np.float32) if s0 else None
    do = rng.normal(0, 1, (bh, t, dv)).astype(np.float32)
    ds_t = rng.normal(0, 1, (bh, dk, dv)).astype(np.float32)
    return r, k, v, w, u, s, do, ds_t


@pytest.mark.parametrize("bonus,dk,dv,t", [
    (False, 16, 64, 20), (True, 16, 16, 17), (True, 8, 12, 9),
    # hymba's SSM one step past a power of two; the widest Dv a block owns
    (False, 16, 64, 65), (True, 16, 128, 11)])
def test_scan_bwd_ref_matches_jax_grad(bonus, dk, dv, t):
    bh = 4
    r, k, v, w, u, _, do, _ = _scan(bh, t, dk, dv, t + dk,
                                    u_rows=bh if bonus else None)

    def loss(r, k, v, w, u=None):
        return jnp.sum(j_scan_ref(r, k, v, w, u) * do)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4) if bonus
                    else (0, 1, 2, 3))(r, k, v, w, *((u,) if bonus else ()))
    got = linear_scan_bwd_ref(T(r), T(k), T(v), T(w),
                              None if u is None else T(u), None, T(do))
    names = ("dr", "dk", "dv", "dw", "du")
    for name, g, wnt in zip(names, got, want):
        _close(g, wnt, SCAN_RTOL, name)
    assert (got[4] is None) == (not bonus)


@pytest.mark.parametrize("u_rows,s0,with_ds_t", [
    (None, True, True), (None, False, False), (2, True, True),
    (4, False, True)])
def test_scan_bwd_ref_matches_autograd(u_rows, s0, with_ds_t):
    r, k, v, w, u, s, do, ds_t = _scan(4, 13, 8, 12, 5, u_rows=u_rows,
                                       s0=s0)
    ins = [None if x is None else T(x).requires_grad_()
           for x in (r, k, v, w, u, s)]
    o, s_t = linear_scan_ref(*ins)
    obj = (o * T(do)).sum() + ((s_t * T(ds_t)).sum() if with_ds_t else 0)
    want = torch.autograd.grad(obj, [x for x in ins if x is not None])
    got = linear_scan_bwd_ref(*(None if x is None else x.detach()
                                for x in ins), T(do),
                              T(ds_t) if with_ds_t else None)
    got = [g for g, x in zip(got, ins) if x is not None]
    for i, (g, wnt) in enumerate(zip(got, want)):
        _close(g, wnt.numpy(), SCAN_RTOL, f"input {i}")


def test_scan_bwd_ref_zero_steps():
    r, k, v, w, u, s, _, ds_t = _scan(2, 0, 8, 4, 0, u_rows=2, s0=True)
    dr, dk, dv, dw, du, ds0 = linear_scan_bwd_ref(
        T(r), T(k), T(v), T(w), T(u), T(s), T(np.zeros((2, 0, 4),
                                                       np.float32)),
        T(ds_t))
    assert dr.shape == (2, 0, 8) and dv.shape == (2, 0, 4)
    assert torch.equal(ds0, T(ds_t)) and not du.any()


# ------------------------------------------------------ the Functions --

def test_no_grad_calls_are_the_forward_op(monkeypatch):
    """Without an input that needs a gradient the entries call the
    forward op directly: no Function, so nothing is saved."""
    seen = []
    monkeypatch.setattr(flash_ops._FlashAttention, "apply",
                        lambda *a: seen.append("attn"))
    monkeypatch.setattr(scan_ops._LinearScan, "apply",
                        lambda *a: seen.append("scan"))
    q, k, v, _ = (T(x) for x in _attn(1, 2, 8, 8, 16, 0))
    out = flash_ops.flash_attention(q, k, v, n_rep=2)
    assert torch.equal(out, flash_attention_ref(q, k, v, n_rep=2))
    r, kk, vv, w, *_ = (None if x is None else T(x)
                        for x in _scan(2, 5, 8, 4, 0))
    with torch.no_grad():
        flash_ops.flash_attention(q.requires_grad_(), k, v, n_rep=2)
        scan_ops.linear_scan(r.requires_grad_(), kk, vv, w)
    assert seen == []


def test_functions_backprop_the_plain_backward():
    before = {n: kern.launches for n, kern in dispatch.registered().items()}
    q, k, v, do = (T(x).reshape(1, -1, *x.shape[1:])
                   for x in _attn(2, 5, 16, 16, 64, 4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_ops.flash_attention(*leaves, causal=True, window=6, n_rep=5)
    got = torch.autograd.grad((o * do).sum(), leaves)
    want = flash_attention_bwd_ref(q, k, v, o.detach(), do, causal=True,
                                   window=6, n_rep=5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    r, kk, vv, w, u, s, dout, ds_t = (None if x is None else T(x) for x in
                                      _scan(6, 11, 16, 8, 2, u_rows=3,
                                            s0=True))
    ins = [x.clone().requires_grad_() for x in (r, kk, vv, w, u, s)]
    o, s_t = scan_ops.linear_scan(*ins)
    got = torch.autograd.grad((o * dout).sum() + (s_t * ds_t).sum(), ins)
    want = linear_scan_bwd_ref(r, kk, vv, w, u, s, dout, ds_t)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    # the final state unused: dS_T arrives as None, no zeros made
    o, _ = scan_ops.linear_scan(*ins[:4])
    got = torch.autograd.grad((o * dout).sum(), ins[:4])
    want = linear_scan_bwd_ref(r, kk, vv, w, None, None, dout, None)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    after = {n: kern.launches for n, kern in dispatch.registered().items()}
    assert after == before                      # CPU tensors: no launch


def test_strided_views_take_the_same_gradient():
    """The model's training call passes ``[B, S, H, D]`` activations
    transposed to ``[B, H, S, D]``: the gradients equal a contiguous
    call's, in the views' shapes."""
    rng = np.random.default_rng(9)
    q = T(rng.normal(0, 1, (2, 12, 10, 16)).astype(np.float32))
    k = T(rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32))
    v = T(rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32))
    do = T(rng.normal(0, 1, (2, 10, 12, 16)).astype(np.float32))
    lv = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_ops.flash_attention(*(x.transpose(1, 2) for x in lv), n_rep=5)
    got = torch.autograd.grad((o * do).sum(), lv)
    lc = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
    o2 = flash_ops.flash_attention(*lc, n_rep=5)
    want = torch.autograd.grad((o2 * do).sum(), lc)
    for g, w in zip(got, want):
        assert torch.equal(g, w.transpose(1, 2))


def test_cached_call_refuses_a_gradient():
    q, k, v, _ = (T(x)[None] for x in _attn(1, 1, 1, 8, 16, 0))
    q.requires_grad_()
    with pytest.raises(NotImplementedError, match="cached call"):
        flash_ops.flash_attention(q, k, v,
                                  q_offset=torch.tensor([7], dtype=torch.int32))


def test_backward_kernels_are_registered():
    reg = dispatch.registered()
    for name, fwd in (("flash_attention_bwd", "flash_attention"),
                      ("linear_scan_bwd", "linear_scan")):
        kern = reg[name]
        assert kern.replaces.startswith("jax.grad of src/repro/")
        assert kern.source.endswith(f"csrc/{name}.cu")
        assert reg[fwd].source != kern.source


@pytest.mark.parametrize("kernel,source", [
    ("flash", "flash_attention_bwd.cu"), ("scan", "linear_scan_bwd.cu")])
def test_bwd_trace_stamps_every_phase(kernel, source):
    """The backward kernels' phase trace (``kernels/bwd_trace.py``) finds
    each of its anchors once in the sources, so a card run stamps every
    phase it names."""
    import re
    from repro_torch.kernels import build, bwd_trace
    text = bwd_trace.instrument((build.CSRC / source).read_text(), kernel)
    stamps = {int(j) for j in re.findall(r"STAMP\((\d+)\);", text)}
    named = {j for pair in bwd_trace.PHASES[kernel] for j in pair}
    assert named <= stamps
    assert text.count("int trace_n = 0;") == (2 if kernel == "flash" else 1)
