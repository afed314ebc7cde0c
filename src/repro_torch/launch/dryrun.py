"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a
placeholder mesh.

Held against ``src/repro/launch/dryrun.py``.  Proves the distribution
config is coherent without hardware.  The reference lowers and compiles
each cell's step on 512 placeholder host devices and reads XLA's memory
and cost analyses.  Here the production mesh is a ``DeviceMesh`` over a
fake process group of 256 or 512 ranks (``launch.mesh.
make_production_mesh``); the parameters, optimizer state, batch and
caches are meta ``DTensor``s placed by ``launch.specs``, and the step
(``train_step``, ``prefill_step`` or ``decode_step``) runs once on them
under the installed rules, with plain tensors taken as replicated.
Nothing is allocated and nothing is launched.  One dispatch mode sees
every aten operation at its local (per-device) shapes, and records:

* ``flops``: FLOPs by ``torch.utils.flop_counter``'s formulas, per device;
* ``hlo_bytes``: each operation's input and output bytes (views and
  allocations without data move none), the counterpart of XLA's
  ``bytes accessed``;
* ``collective_bytes``: each ``c10d_functional`` collective by kind
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``),
  summing its output bytes as the reference sums the output shapes of
  the HLO's collectives (``collective_operand_bytes`` sums its inputs);
* ``temp_bytes_per_device``: the high-water mark of the bytes of the
  live tensors the step allocated, less the outputs it allocated (not
  its arguments updated in place and returned).  What a kernel's
  plain version allocates inside the call is not counted: the card's
  kernel keeps it in registers and shared memory;
* ``kernels``: each kernel entry's calls.  On meta a kernel runs its
  plain version (``flash_attention``, its backward) or, where that is a
  loop of one step per token (``linear_scan`` and its backward), its
  ``meta`` form, the output shapes of one launch
  (``kernels/dispatch.py``).  How a call splits over the shards is
  ``models/sharding.py``'s: ``attention_blocks`` here, ``local_blocks``
  at the scans' call sites.

Argument and output bytes are the local shards' exact sizes.  ``peak =
arguments + outputs + temporaries - donated``, the reference's formula,
with the reference's donation: parameters and optimizer state in train,
the caches and states in decode (the port updates those in place).  The
process group exists only inside a cell and is destroyed before it
returns.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape decode_32k --multi-pod single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--json out.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import weakref

import torch

from repro_torch.configs import ARCHS, canon, get_config
from repro_torch.kernels import dispatch
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M, sharding as shd, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

META = torch.device("meta")

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs;
# full-attention archs record the skip.
LONG_OK_KINDS = ("rwkv", "hybrid")

COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_coalesced":
               "all-reduce", "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
# operations that move no data: allocations without a value, aliases
_NO_DATA = {"empty", "empty_strided", "new_empty", "new_empty_strided",
            "empty_like", "detach", "alias", "lift_fresh"}


def input_specs(cfg: ModelConfig, shape: dict):
    """Meta tensors for every model input (no allocation)."""
    b, s = shape["batch"], shape["seq"]
    if shape["kind"] == "train":
        return M.make_train_batch_shapes(cfg, b, s)
    if shape["kind"] == "prefill":
        if cfg.frontend == "token":
            return {"inputs": torch.empty((b, s), dtype=torch.int32,
                                          device=META)}
        return {"inputs": torch.empty((b, s, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)}
    # decode: one new token against a seq_len KV cache
    if cfg.frontend == "token":
        tok = torch.empty((b,), dtype=torch.int32, device=META)
    else:
        tok = torch.empty((b, cfg.d_model), dtype=torch.bfloat16,
                          device=META)
    caches, states = transformer.init_caches(cfg, b, s, device=META)
    return {"token": tok, "caches": caches, "states": states}


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def local_bytes(tree) -> int:
    """The bytes one device holds of a tree of (D)Tensors."""
    return sum(_bytes(_local(t)) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def place(tree, specs, mesh):
    """Each meta tensor of ``tree`` as a ``DTensor`` on ``mesh`` placed by
    its spec (``specs``: a spec tree of ``tree``'s structure)."""
    from torch.distributed.tensor import distribute_tensor

    def one(spec, t):
        return distribute_tensor(t, mesh.device_mesh, shd.placements(
            mesh, spec, t.dim()))
    return S.map_specs(one, specs, tree)


def build_step(cfg: ModelConfig, shape: dict, mesh, opt_cfg=None):
    """-> (fn, placed args, indices of the donated args)."""
    rules = S.make_rules(cfg, tp=mesh.shape["model"])
    aparams = M.abstract_params(cfg)
    pspecs = S.fit_tree(S.param_specs(cfg), aparams, mesh)
    with shd.use_rules(mesh, rules):
        dp = shd.resolve("batch")
    dp_axes = dp[0] if len(dp) and dp[0] is not None else None
    batch_spec = shd.P(dp_axes)
    params = place(aparams, pspecs, mesh)

    if shape["kind"] == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        aopt = M.abstract_opt(aparams)
        dp_group = (("data",) if "pod" not in mesh.shape
                    else ("pod", "data"))
        dp_size = 1
        for a in dp_group:
            dp_size *= mesh.shape[a]
        zspec = S.opt_specs(aparams, pspecs, dp_size, dp_group)
        opt = adamw.OptState(mu=place(aopt.mu, zspec, mesh),
                             nu=place(aopt.nu, zspec, mesh),
                             step=place(aopt.step, shd.P(), mesh))
        batch = input_specs(cfg, shape)
        batch = place(batch, S.fit_tree({k: batch_spec for k in batch},
                                        batch, mesh), mesh)

        def fn(params, opt_state, batch):
            with shd.use_rules(mesh, rules):
                return M.train_step(params, opt_state, batch, cfg=cfg,
                                    opt_cfg=opt_cfg)
        return fn, (params, opt, batch), (0, 1)
    if shape["kind"] == "prefill":
        inputs = input_specs(cfg, shape)["inputs"]
        inputs = place(inputs, S.fit_spec(batch_spec, inputs.shape, mesh),
                       mesh)

        def fn(params, inputs):
            with shd.use_rules(mesh, rules), torch.no_grad():
                return M.prefill_step(params, inputs, cfg=cfg)
        return fn, (params, inputs), ()
    inp = input_specs(cfg, shape)
    cspec, sspec = S.cache_specs(cfg, rules)
    caches, states = inp["caches"], inp["states"]
    if caches is not None:
        caches = place(caches, S.fit_tree(cspec, caches, mesh), mesh)
    if states is not None:
        if isinstance(sspec, shd.P):
            states = place(states, S.fit_spec(sspec, states.shape, mesh),
                           mesh)
        else:
            states = place(states, S.fit_tree(sspec, states, mesh), mesh)
    token = place(inp["token"], S.fit_spec(batch_spec, inp["token"].shape,
                                           mesh), mesh)

    def fn(params, caches, states, token):
        with shd.use_rules(mesh, rules), torch.no_grad():
            return M.decode_step(params, caches, states, token,
                                 shape["seq"] - 1, cfg=cfg)
    return fn, (params, caches, states, token), (1, 2)


class Trace:
    """The dispatch mode and kernel hook of one cell's trace (see the
    module docstring).  Operations on ``DTensor``s are handed back to
    ``DTensor``, which calls them again on the local shards: only those
    local calls are counted."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0.0
        self.bytes = 0
        self.coll = {}
        self.coll_operand = {}
        self.kernels = {}
        self.live = 0
        self.high = 0
        self.inside = 0            # depth of kernel calls being traced

    def _alloc(self, t):
        n = _bytes(t)
        self.live += n
        self.high = max(self.high, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    def op(self, func, args, kwargs, out):
        ns, _, name = func._schema.name.partition("::")
        tensors = lambda tree: [t for t in tree_leaves(tree)
                                if isinstance(t, torch.Tensor)]
        outs = tensors(out)
        if ns == "_c10d_functional":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                self.coll[kind] = self.coll.get(kind, 0) + sum(
                    _bytes(t) for t in outs)
                self.coll_operand[kind] = self.coll_operand.get(
                    kind, 0) + sum(_bytes(t) for t in tensors(args))
            return
        if func.is_view or name in _NO_DATA:
            return
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs,
                                                out_val=out)
        ins = tensors((args, kwargs))
        self.bytes += sum(_bytes(t) for t in ins + outs)
        if not self.inside:
            for t in outs:
                if not any(t is i for i in ins):
                    self._alloc(t)

    def kernel(self, k, fn, args, kwargs):
        """``dispatch.tracing``'s hook: count the call, run ``fn`` (an
        attention kernel on ``DTensor``s through
        ``sharding.attention_blocks``; a scan sees local blocks), keep only
        its outputs live."""
        self.kernels[k.name] = self.kernels.get(k.name, 0) + 1
        self.inside += 1
        try:
            out = shd.attention_blocks(fn, args, kwargs)
        finally:
            self.inside -= 1
        if not self.inside:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._alloc(_local(t))
        return out

    def mode(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        trace = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                # DTensor infers output shapes on fake tensors of the
                # global shapes: that is planning, not the step's work
                if not any(isinstance(t, FakeTensor)
                           for t in tree_leaves((args, kwargs, out))):
                    trace.op(func, args, kwargs, out)
                return out
        return Mode()


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg: ModelConfig = None, mesh_shape=None) -> dict:
    """One cell.  ``mesh_shape`` overrides the production mesh's sizes
    (the tests trace reduced configs on ``(2, 2)`` and ``(2, 2, 2)``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod}
    if shape_name == "long_500k" and cfg.kind not in LONG_OK_KINDS:
        return {**head, "status": "skipped (full attention)"}
    t0 = time.time()
    with make_production_mesh(multi_pod=multi_pod, shape=mesh_shape) as mesh:
        if shape["kind"] == "train":
            # each microbatch must still split evenly over the dp group;
            # clamp so batch / microbatches % dp == 0
            dp_total = mesh.shape["data"] * mesh.shape.get("pod", 1)
            max_mb = max(shape["batch"] // dp_total, 1)
            if cfg.n_microbatches > max_mb:
                cfg = dataclasses.replace(cfg, n_microbatches=max_mb)
        fn, args, donate = build_step(cfg, shape, mesh)
        arg_bytes = local_bytes(args)
        donated = local_bytes([args[i] for i in donate])
        trace = Trace()
        with trace.mode(), dispatch.tracing(trace.kernel), \
                implicit_replication():
            out = fn(*args)
        out_bytes = local_bytes(out)
        # outputs the step allocated (not its arguments updated in place)
        given = {id(t) for t in tree_leaves(args)}
        fresh = local_bytes([t for t in tree_leaves(out)
                             if id(t) not in given])
        temp = max(trace.high - fresh, 0)
        del out
    return {
        **head, "status": "ok",
        "compile_s": round(time.time() - t0, 1),
        "flops": float(trace.flops),
        "hlo_bytes": float(trace.bytes),
        "collective_bytes": dict(trace.coll),
        "collective_operand_bytes": dict(trace.coll_operand),
        "argument_bytes_per_device": arg_bytes,
        "output_bytes_per_device": out_bytes,
        "temp_bytes_per_device": temp,
        "alias_bytes_per_device": donated,
        "peak_bytes_per_device": arg_bytes + out_bytes + temp - donated,
        "kernels": dict(trace.kernels),
    }


def row(r: dict) -> str:
    tag = "2x16x16" if r["multi_pod"] else "16x16"
    coll = r.get("collective_bytes", {})
    return (f"{r['arch']:20s} {r['shape']:12s} {tag:8s} {r['status']:28s} "
            f"flops={r.get('flops', 0):.3e} "
            f"peakGB={(r.get('peak_bytes_per_device') or 0) / 2**30:.2f} "
            f"coll={ {k: f'{v / 2**20:.0f}MB' for k, v in coll.items()} }")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [canon(args.arch)]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                try:
                    r = run_cell(arch, shape, mp)
                except Exception as e:  # a failing cell is a bug: surface it
                    r = {"arch": arch, "shape": shape, "multi_pod": mp,
                         "status": f"FAIL {type(e).__name__}: {e}"}
                results.append(r)
                print(row(r), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"].startswith("FAIL")]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells passed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
