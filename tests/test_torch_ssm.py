"""The port's SSM heads (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on the CPU, float32, at hymba-1.5b's
reduced widths: ``ssm_forward`` from a carried state at prompt lengths 1
(the reference's one-step branch), 12 and 128 (its chunked SSD form) and
130 (its ``lax.scan``), outputs and final state within 1e-4; and the
port's mapping of the recurrence onto ``linear_scan`` (one call, ``o_t =
C_t S_{t-1}`` completed to ``C_t S_t``) against the recurrence written
out step by step."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
import torch.nn.functional as F

from repro.configs import get_config, reduced
from repro.models import ssm as RSSM
from repro_torch import configs as pconfigs
from repro_torch.kernels import dispatch
from repro_torch.models import ssm as PSSM

ATOL = 1e-4


def _cfgs():
    cfg = dataclasses.replace(reduced(get_config("hymba-1.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(
        pconfigs.reduced(pconfigs.get_config("hymba-1.5b")), dtype="float32")
    return cfg, pcfg


def _inputs(cfg, t, seed):
    """The reference's parameters (``a_log`` drawn, so heads decay at
    different rates), x [2, t, D] and a carried state."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray,
                     RSSM.init_ssm(jax.random.PRNGKey(seed), cfg,
                                   jnp.float32))
    p["a_log"] = rng.normal(0, 1, p["a_log"].shape).astype(np.float32)
    x = rng.normal(0, 1, (2, t, cfg.d_model)).astype(np.float32)
    state = rng.normal(0, 0.5, (2, cfg.ssm_heads, cfg.ssm_state,
                                cfg.head_dim)).astype(np.float32)
    return p, x, state


@pytest.mark.parametrize("t", [1, 12, 128, 130])
def test_ssm_forward_matches_reference(t):
    cfg, pcfg = _cfgs()
    p, x, state = _inputs(cfg, t, t)
    want_y, want_s = RSSM.ssm_forward(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg,
        jnp.asarray(state))
    pp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got_y, got_s = PSSM.ssm_forward(pp, torch.from_numpy(x), pcfg,
                                    torch.from_numpy(state))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=ATOL)
    # no state: the reference's zeros
    want_y0, _ = RSSM.ssm_forward(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), cfg)
    got_y0, _ = PSSM.ssm_forward(pp, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got_y0.numpy(), np.asarray(want_y0),
                               atol=ATOL)


def _recurrence(pp, x, cfg, state):
    """The SSM as written: S_t = a_t S_{t-1} + B_t^T x_t, y_t = C_t S_t,
    one step at a time, gated and projected out."""
    xv, z, bb, cc, decay = PSSM._proj(pp, x, cfg)
    s = state.clone()
    ys = []
    for i in range(x.shape[1]):
        s = (decay[:, i, :, None, None] * s
             + bb[:, i, :, :, None].float() * xv[:, i, :, None, :].float())
        ys.append(torch.einsum("bhs,bhsp->bhp", cc[:, i].float(), s))
    y = torch.stack(ys, 1) * F.silu(z.float())
    b, t = x.shape[:2]
    return y.reshape(b, t, -1) @ pp["w_out"], s


@pytest.mark.parametrize("t", [1, 5, 130])
def test_the_linear_scan_mapping_is_the_recurrence(t):
    """One ``linear_scan`` call a forward, whatever the length, and its
    completed output equals the step-by-step recurrence."""
    cfg, pcfg = _cfgs()
    p, x, state = _inputs(cfg, t, 100 + t)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    scan = dispatch.registered()["linear_scan"]
    calls = []
    plain = scan.plain
    scan.plain = lambda *a, **kw: calls.append(a[0].shape) or plain(*a, **kw)
    try:
        got_y, got_s = PSSM.ssm_forward(pp, torch.from_numpy(x), pcfg,
                                        torch.from_numpy(state))
    finally:
        scan.plain = plain
    assert calls == [(2 * cfg.ssm_heads, t, cfg.ssm_state)]
    want_y, want_s = _recurrence(pp, torch.from_numpy(x), pcfg,
                                 torch.from_numpy(state))
    torch.testing.assert_close(got_y, want_y, atol=ATOL, rtol=0)
    torch.testing.assert_close(got_s, want_s, atol=ATOL, rtol=0)
