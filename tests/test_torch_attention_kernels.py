"""The port's flash_attention and linear_scan on the CPU: each plain PyTorch
version against the reference kernels' references (``attention_ref_op``,
``linear_scan_ref_op``) over the reference sweep's cases
(``tests/test_kernels.py``), one small case each against the Pallas kernel
under ``pallas-interpret``, and the port's extensions (``q_offset``,
``kv_index``, ragged lengths, ``s0``/``S_T``, u per head) against a
straightforward loop.  Tolerances are the reference's: 2e-5 and 1e-4.
The CUDA kernels run only on the card (``chip_smoke.py``, against these
plain versions); here the registry must send CPU tensors to the plain
version and count no launch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import (attention_ref_op,
                                               flash_attention_op as j_flash)
from repro.kernels.linear_scan.ops import (linear_scan_op as j_scan,
                                           linear_scan_ref_op)
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.linear_scan.ops import linear_scan_op

T = torch.from_numpy


def _attn_inputs(sq, skv, n_rep, seed, bh_kv=2, d=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (bh_kv * n_rep, sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (bh_kv, skv, d)).astype(np.float32)
    v = rng.normal(0, 1, (bh_kv, skv, d)).astype(np.float32)
    return q, k, v


def _scan_inputs(bh, t, dk, dv, bonus, seed):
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 1, (bh, t, dk)).astype(np.float32)
    k = rng.normal(0, 1, (bh, t, dk)).astype(np.float32)
    v = rng.normal(0, 1, (bh, t, dv)).astype(np.float32)
    w = rng.uniform(0.5, 0.99, (bh, t, dk)).astype(np.float32)
    u = rng.normal(0, 1, (bh, dk)).astype(np.float32) if bonus else None
    return r, k, v, w, u


# ------------------------------------------- against the reference's refs --

@pytest.mark.parametrize("causal,window,sq,skv,n_rep", [
    (True, None, 64, 64, 1), (True, 16, 64, 64, 1), (False, None, 32, 64, 1),
    (True, None, 1, 128, 1),                     # decode
    (True, None, 64, 64, 4), (True, 32, 64, 64, 2),  # GQA
])
def test_flash_attention_plain_matches_reference(causal, window, sq, skv,
                                                 n_rep):
    q, k, v = _attn_inputs(sq, skv, n_rep, sq + skv)
    want = attention_ref_op(q, k, v, causal=causal, window=window,
                            n_rep=n_rep)
    got = flash_attention_op(T(q), T(k), T(v), causal=causal, window=window,
                             n_rep=n_rep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("bh,t,dk,dv,bonus", [
    (2, 64, 8, 8, True), (3, 128, 16, 24, True),
    (2, 64, 8, 8, False), (1, 256, 32, 32, False),
])
def test_linear_scan_plain_matches_reference(bh, t, dk, dv, bonus):
    r, k, v, w, u = _scan_inputs(bh, t, dk, dv, bonus, t + dk)
    want = linear_scan_ref_op(r, k, v, w, u)
    got, _ = linear_scan_op(T(r), T(k), T(v), T(w),
                            None if u is None else T(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_flash_attention_plain_matches_pallas_interpret():
    q, k, v = _attn_inputs(32, 64, 2, 7)
    want = j_flash(q, k, v, causal=True, window=24, n_rep=2, blk_q=16,
                   blk_k=32, backend="pallas-interpret")
    got = flash_attention_op(T(q), T(k), T(v), window=24, n_rep=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_linear_scan_plain_matches_pallas_interpret():
    r, k, v, w, u = _scan_inputs(2, 32, 8, 8, True, 8)
    want = j_scan(r, k, v, w, u, chunk=16, backend="pallas-interpret")
    got, _ = linear_scan_op(T(r), T(k), T(v), T(w), T(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# -------------------------------------------------- the port's extensions --

def _loop_attention(q, k, v, *, causal, window, n_rep, q_offset, kv_index):
    """One query row at a time, one key at a time: [B, H, Sq, D] numpy."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    out = np.zeros_like(q)
    for bi in range(b):
        kb = kv_index[bi]
        for h in range(hq):
            for i in range(sq):
                pos = q_offset[bi * hq + h] + i
                s = np.full(skv, -1e30)
                for j in range(skv):
                    see = (not causal or pos >= j) and \
                        (window is None or pos - j < window)
                    if see:
                        s[j] = q[bi, h, i] @ k[kb, h // n_rep, j] / np.sqrt(d)
                p = np.exp(s - s.max())
                out[bi, h, i] = p @ v[kb, h // n_rep] / p.sum()
    return out


@pytest.mark.parametrize("sq,skv,window,causal", [
    (1, 37, None, True),           # decode lanes at mixed depths
    (5, 37, 6, True),              # ragged prefill with a window
    (3, 20, None, False),
])
def test_flash_attention_offsets_and_kv_index(sq, skv, window, causal):
    rng = np.random.default_rng(sq * 100 + skv)
    b, hkv, n_rep, d = 3, 2, 3, 16
    q = rng.normal(0, 1, (b, hkv * n_rep, sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (5, hkv, skv, d)).astype(np.float32)   # 5 slots
    v = rng.normal(0, 1, (5, hkv, skv, d)).astype(np.float32)
    off = np.repeat(rng.integers(0, skv - sq + 1, b), hkv * n_rep)
    kv_index = np.array([4, 0, 2], np.int32)
    want = _loop_attention(q, k, v, causal=causal, window=window,
                           n_rep=n_rep, q_offset=off, kv_index=kv_index)
    got = flash_attention_op(T(q), T(k), T(v), causal=causal, window=window,
                             n_rep=n_rep, q_offset=T(off.astype(np.int32)),
                             kv_index=T(kv_index))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_flash_attention_strided_views_equal_contiguous():
    """The model hands over [B, S, H, D] tensors transposed, not copied."""
    rng = np.random.default_rng(3)
    q = T(rng.normal(0, 1, (2, 7, 4, 16)).astype(np.float32))
    k = T(rng.normal(0, 1, (2, 9, 2, 16)).astype(np.float32))
    v = T(rng.normal(0, 1, (2, 9, 2, 16)).astype(np.float32))
    views = [x.transpose(1, 2) for x in (q, k, v)]
    a = flash_attention_op(*views, n_rep=2)
    b = flash_attention_op(*(x.contiguous() for x in views), n_rep=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    flat = flash_attention_op(*(x.reshape(-1, *x.shape[2:]).contiguous()
                                for x in views), n_rep=2)
    torch.testing.assert_close(a.reshape(-1, 7, 16), flat, rtol=0, atol=0)


def test_linear_scan_state_carries_across_calls():
    """Running T steps as a prefill of T1 and T - T1 single-step decodes
    (each starting from the last call's S_T) equals one T-step scan, and
    both equal a straightforward loop; u given per head is broadcast over
    the batch."""
    rng = np.random.default_rng(11)
    b, h, t, dk, dv = 2, 3, 9, 8, 12
    r, k, v, w, _ = _scan_inputs(b * h, t, dk, dv, False, 12)
    u_head = rng.normal(0, 1, (h, dk)).astype(np.float32)
    s0 = rng.normal(0, 1, (b * h, dk, dv)).astype(np.float32)
    want = np.zeros((b * h, t, dv), np.float32)
    s = s0.astype(np.float64).copy()
    for bh in range(b * h):
        for i in range(t):
            kv = np.outer(k[bh, i], v[bh, i])
            want[bh, i] = r[bh, i] @ (s[bh] + u_head[bh % h][:, None] * kv)
            s[bh] = w[bh, i][:, None] * s[bh] + kv
    full, s_full = linear_scan_op(T(r), T(k), T(v), T(w), T(u_head), T(s0))
    np.testing.assert_allclose(full.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(s_full.numpy(), s, atol=1e-4)
    outs, st = [], T(s0)
    for lo, hi in [(0, 5)] + [(i, i + 1) for i in range(5, t)]:
        o, st = linear_scan_op(*(T(a[:, lo:hi].copy()) for a in (r, k, v, w)),
                               T(u_head), st)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), s, atol=1e-4)


# ------------------------------------------------------ registry, wrappers --

def test_registry_entries_and_no_launch_on_the_cpu():
    reg = dispatch.registered()
    assert reg["flash_attention"].source.endswith("csrc/flash_attention.cu")
    assert reg["linear_scan"].source.endswith("csrc/linear_scan.cu")
    before = {n: k.launches for n, k in reg.items()}
    x = torch.zeros(2, 3, 16)
    flash_attention_op(x, x, x)
    linear_scan_op(x, x, x, x)
    assert {n: k.launches for n, k in reg.items()} == before


@pytest.mark.parametrize("case", ["head_dim", "n_rep", "dtype", "window",
                                  "batch", "stride"])
def test_flash_attention_wrapper_refuses_what_the_kernel_cannot_take(case):
    """The CUDA wrapper validates before any pointer reaches C (checked
    here on CPU tensors: the checks precede the launch)."""
    q = torch.zeros(2, 4, 3, 16)
    k = v = torch.zeros(2, 2, 5, 16)
    kw = dict(n_rep=2)
    if case == "head_dim":
        q, k, v = (torch.zeros(*x.shape[:3], 24) for x in (q, k, v))
    elif case == "n_rep":
        kw["n_rep"] = 3
    elif case == "dtype":
        q = q.half()
    elif case == "window":
        kw["window"] = 0
    elif case == "batch":
        k = v = torch.zeros(3, 2, 5, 16)
    elif case == "stride":
        q = torch.zeros(2, 4, 3, 32)[..., ::2]
    with pytest.raises((ValueError, TypeError)):
        flash_ops._cuda(q, k, v, **kw)


@pytest.mark.parametrize("case", ["dk", "u_rows", "s0", "dtype"])
def test_linear_scan_wrapper_refuses_what_the_kernel_cannot_take(case):
    x = torch.zeros(6, 4, 8)
    args = dict(r=x, k=x, v=torch.zeros(6, 4, 5), w=x, u=None, s0=None)
    if case == "dk":
        args.update(r=torch.zeros(6, 4, 12), k=torch.zeros(6, 4, 12),
                    w=torch.zeros(6, 4, 12))
    elif case == "u_rows":
        args["u"] = torch.zeros(4, 8)
    elif case == "s0":
        args["s0"] = torch.zeros(6, 5, 8)
    elif case == "dtype":
        args["r"] = x.double()
    with pytest.raises((ValueError, TypeError)):
        scan_ops._cuda(**args)
