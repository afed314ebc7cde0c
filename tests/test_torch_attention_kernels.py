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
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.linear_scan.ops import (linear_scan_op as j_scan,
                                           linear_scan_ref_op)
from repro_torch import configs as pconfigs
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.linear_scan.ops import linear_scan_op
from repro_torch.kernels.linear_scan.ref import (CHUNK,
                                                 linear_scan_chunked_ref,
                                                 linear_scan_ref)

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


@pytest.mark.parametrize("variant", ["s0_u_per_head", "u_per_row", "no_u"])
@pytest.mark.parametrize("t", [1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5])
@pytest.mark.parametrize("decay", ["uniform", "mixed"])
def test_linear_scan_chunked_decomposition(decay, t, variant):
    """The CUDA kernel's chunked body, rendered in plain PyTorch with its
    chunk length, equals the JAX reference (``linear_scan_ref_op``, which
    starts from zeros) and the port's sequential plain version within
    1e-4: decays uniform on (0, 1] or mixed from {0, 1e-30, 1e-6, 0.5, 1}
    (zeros forget the state exactly, 1e-30 underflows in two steps), T
    short of, at and past the chunk and ragged, a carried s0, u per head
    or per row, and no u.  Nothing is NaN."""
    rng = np.random.default_rng(t * 7 + len(decay) + len(variant))
    b, h, dk, dv = 2, 3, 8, 12
    bh = b * h
    r, k, v, _, _ = _scan_inputs(bh, t, dk, dv, False, t)
    if decay == "uniform":
        w = (1.0 - rng.random((bh, t, dk))).astype(np.float32)
    else:
        w = rng.choice(np.array([0, 1e-30, 1e-6, 0.5, 1], np.float32),
                       (bh, t, dk))
    u = s0 = None
    if variant == "s0_u_per_head":
        u = rng.normal(0, 1, (h, dk)).astype(np.float32)
        s0 = rng.normal(0, 1, (bh, dk, dv)).astype(np.float32)
    elif variant == "u_per_row":
        u = rng.normal(0, 1, (bh, dk)).astype(np.float32)
    opt = lambda x: None if x is None else T(x)
    got, s_got = linear_scan_chunked_ref(T(r), T(k), T(v), T(w), opt(u),
                                         opt(s0))
    want, s_want = linear_scan_ref(T(r), T(k), T(v), T(w), opt(u), opt(s0))
    assert torch.isfinite(got).all() and torch.isfinite(s_got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    np.testing.assert_allclose(s_got.numpy(), s_want.numpy(), atol=1e-4)
    if s0 is None:
        u_rows = None if u is None else np.tile(u, (bh // u.shape[0], 1))
        ref = linear_scan_ref_op(r, k, v, w, u_rows)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


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


@pytest.mark.parametrize("case", ["dk", "u_rows", "s0", "dtype", "chunk"])
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
    elif case == "chunk":                  # sweep lengths only at Dk 64
        args["chunk"] = 16
    with pytest.raises((ValueError, TypeError)):
        scan_ops._cuda(**args)


DENSE = [a for a, c in pconfigs.all_configs().items() if c.kind == "dense"]


@pytest.mark.parametrize("arch", DENSE)
def test_flash_attention_wrapper_takes_every_dense_configs_heads(arch):
    """Every dense config's head size, query/KV head pair and window pass
    the CUDA wrapper's checks (run here on CPU tensors, before any
    launch), in bfloat16 as served and in float32 as checked: decode
    lanes over a slot pool and a prefill."""
    cfg = pconfigs.get_config(arch)
    d, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    window = None if cfg.window_pattern is None else cfg.window_pattern[0]
    for dt in (torch.bfloat16, torch.float32):
        pool = torch.zeros(3, 8, hkv, d, dtype=dt).transpose(1, 2)
        dec = torch.zeros(2, 1, hq, d, dtype=dt).transpose(1, 2)
        flash_ops.validate(dec, pool, pool, window=window, n_rep=hq // hkv,
                           q_offset=torch.full((2 * hq,), 4,
                                               dtype=torch.int32),
                           kv_index=torch.tensor([2, 0], dtype=torch.int32))
        pre = torch.zeros(1, hq, 8, d, dtype=dt)
        kv = torch.zeros(1, hkv, 8, d, dtype=dt)
        flash_ops.validate(pre, kv, kv, window=window, n_rep=hq // hkv)


def test_flash_attention_wrapper_takes_a_grid_past_65535_kv_rows():
    """8,193 decode lanes at 8 KV heads (B x H_kv = 65,544, past grid
    axis y's limit, which bound the kernel before) pass the CUDA
    wrapper's checks (on CPU tensors, before any launch), in bfloat16 and
    float32; a grid past axis x's 2^31 - 1 blocks is refused."""
    for dt in (torch.bfloat16, torch.float32):
        q = torch.zeros(8193, 40, 1, 16, dtype=dt)
        kv = torch.zeros(8193, 8, 3, 16, dtype=dt)
        flash_ops.validate(q, kv, kv, n_rep=5,
                           q_offset=torch.full((8193,), 2, dtype=torch.int32))
    q = torch.zeros(1, 1, 1, 16).expand(2 ** 28, 1, 1, 16)
    kv = torch.zeros(1, 1, 1, 16).expand(2 ** 28, 1, 1, 16)
    with pytest.raises(ValueError):
        flash_ops.validate(q, kv, kv)


def _split_kv_model(q, k, v, pos, *, causal, window, chunk):
    """The bfloat16 decode body's arithmetic, in float32 numpy: rows
    ``q`` [R, D] at positions ``pos`` over keys ``k``/``v`` [S, D], cut
    into chunks of ``chunk`` keys.  Only the chunks some row sees are
    walked (all of them if some row sees no key); each gives a partial
    (m, l, acc) with masked logits at -1e30, and the partials merge by
    log-sum-exp: out = sum_c e^(m_c - m) acc_c / sum_c e^(m_c - m) l_c."""
    r, d = q.shape
    kp = np.arange(k.shape[0])
    see = np.ones((r, k.shape[0]), bool)
    if causal:
        see &= pos[:, None] >= kp
    if window is not None:
        see &= pos[:, None] - kp < window
    lo, hi = 0, k.shape[0] - 1
    if see.any(1).all():
        lo, hi = kp[see.any(0)].min(), kp[see.any(0)].max()
    parts = []
    for c0 in range(lo // chunk * chunk, hi + 1, chunk):
        sl = slice(c0, c0 + chunk)
        logit = np.where(see[:, sl], (q @ k[sl].T) * np.float32(d ** -0.5),
                         np.float32(-1e30)).astype(np.float32)
        m = logit.max(1)
        p = np.exp(logit - m[:, None])
        parts.append((m, p.sum(1), p @ v[sl]))
    m = np.max([pm for pm, _, _ in parts], axis=0)
    w = [np.exp(pm - m) for pm, _, _ in parts]
    l = sum(wc * pl for wc, (_, pl, _) in zip(w, parts))
    acc = sum(wc[:, None] * pa for wc, (_, _, pa) in zip(w, parts))
    return acc / np.maximum(l, 1e-30)[:, None]


@pytest.mark.parametrize("chunk", [5, 8, 32])
@pytest.mark.parametrize("sq,window,causal", [
    (1, None, True), (1, 6, True), (2, 9, True), (1, None, False)])
def test_split_kv_decode_arithmetic(chunk, sq, window, causal):
    """The split-KV decomposition of the decode body equals the plain
    version and, row by row, the JAX reference (``attention_ref`` over the
    keys up to the row's position) within 2e-5, for GQA rows at their own
    depths (q_offset per row), chunk sizes that cut the 37 keys unevenly,
    and rows that see no key (a whole lane past its window, and one head
    of a lane), which get the mean of v."""
    rng = np.random.default_rng(chunk * 10 + sq)
    b, hkv, n_rep, d, skv = 3, 2, 3, 16, 37
    hq = hkv * n_rep
    q = rng.normal(0, 1, (b, hq, sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, skv, d)).astype(np.float32)
    off = np.repeat(np.array([0, 20, skv - sq]), hq)
    off[2 * hq + 4] = 3
    if window is not None:
        off[hq:2 * hq] = skv + window + 5        # lane 1 sees no key
        off[2 * hq + 1] = skv + window           # one head of lane 2
    got = np.zeros_like(q)
    for bi in range(b):
        for g in range(hkv):
            heads = range(g * n_rep, (g + 1) * n_rep)
            rows = np.concatenate([q[bi, h] for h in heads])
            pos = np.concatenate([off[bi * hq + h] + np.arange(sq)
                                  for h in heads])
            out = _split_kv_model(rows, k[bi, g], v[bi, g], pos,
                                  causal=causal, window=window, chunk=chunk)
            got[bi, g * n_rep:(g + 1) * n_rep] = out.reshape(n_rep, sq, d)
    want = flash_attention_ref(T(q), T(k), T(v), causal=causal,
                               window=window, n_rep=n_rep,
                               q_offset=T(off.astype(np.int32)))
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5)
    for bi in range(b):
        for h in range(hq):
            for i in range(sq):
                pos = off[bi * hq + h] + i
                kv = slice(0, pos + 1) if causal else slice(0, skv)
                lo = 0 if window is None else max(0, pos - window + 1)
                if not causal and window is not None:
                    continue        # the reference places q at the end
                if lo > min(pos, skv - 1):
                    np.testing.assert_allclose(
                        got[bi, h, i], v[bi, h // n_rep].mean(0), atol=2e-5)
                    continue
                ref = attention_ref(q[bi, h, i][None, None],
                                    k[bi, h // n_rep][None, kv],
                                    v[bi, h // n_rep][None, kv],
                                    causal=causal, window=window)
                np.testing.assert_allclose(got[bi, h, i],
                                           np.asarray(ref)[0, 0], atol=2e-5)


def test_q_offset_per_batch_row_equals_per_head_rows():
    """``q_offset`` of ``i32[B]`` (one depth per lane, as the model passes
    it) gives what the reference-shaped ``i32[B * H_q]`` gives; other
    sizes are refused before a launch."""
    q, k, v = (T(a) for a in _attn_inputs(1, 30, 4, 5))
    q, k, v = (x.reshape(2, -1, *x.shape[1:]) for x in (q, k, v))
    lanes = torch.tensor([7, 29], dtype=torch.int32)
    a = flash_attention_op(q, k, v, n_rep=4, q_offset=lanes)
    b = flash_attention_op(q, k, v, n_rep=4,
                           q_offset=lanes.repeat_interleave(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        flash_ops.validate(q, k, v, n_rep=4,
                           q_offset=torch.zeros(3, dtype=torch.int32))
