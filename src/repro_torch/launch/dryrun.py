"""Dry run of the train and serve steps on the production meshes; port
of repro.launch.dryrun.

A cell is one (architecture x input shape) on the single-pod mesh (data
16 x model 16 = 256 ranks) or the two-pod one (pod 2 x data 16 x model 16
= 512).  It is built for one rank of that mesh, in this process, with no
device behind it: a ``fake`` process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg.FakeStore``: collectives
return at once), and the rank's state, weights and inputs as fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage).  The cell
then runs one real step of the port on them:

* ``train_4k`` — ``runtime.train.train_step`` on the rank's FSDP x TP
  state and batch rows (bf16-dense weights, the reference's
  ``TRAIN_OVERRIDES``);
* ``prefill_32k`` — ``transformer.prefill`` over the prompt, no cache
  (the reference's prefill cell lowers the forward alone);
* ``decode_32k`` and ``long_500k`` — one ``transformer.decode_step``
  against a ``seq_len``-deep bf16 cache (the reference's default).

A serve cell's weights are the reference's ``serve_quant_config``
default (msgemm, d = 3, scale_block 36, ``packed_idx``), cut by
``runtime.serve.shard_params`` under the 'default' rules, as the
reference's CLI lowers its serve cells: each rank stores its 'data'
block of the leaves whose model dim takes 'data' (FSDP storage) and
gathers a block's at the top of the block (``--serve-rules serve``
keeps every rank's whole 'model' shard instead); the rows split over
'pod' x 'data' as ``sharding.batch_specs`` splits them, the cache as
``runtime.serve.mesh_specs`` does.  On fake tensors the GeMM kernels
allocate what their CUDA launch does (``kernels.msgemm.msgemm_fake``,
``kernels.int4_matmul.int4_matmul_fake``), never the plain version's
tables.  Every cell records:

* ``memory.argument_bytes_per_device`` — the rank's arguments: its
  state (or weights, plus the cache) and its input rows, exactly;
* ``memory.peak_bytes_per_device`` — the peak of the tensors the step
  holds, ``torch.distributed._tools.mem_tracker.MemTracker`` around it
  (XLA's ``memory_analysis`` in the reference);
* ``collectives`` — by kind, the count and result bytes of what the step
  issues (``distributed.collectives.counts`` / ``nbytes``; where the
  query heads cannot take 'model', the query blocks' K/V gathers as
  ``seq_kv_gather``; where the sequence divides 'model', the residual's
  block entry gathers and exit reduce-scatters as ``seq_in_gather`` and
  ``seq_out_scatter``);
* ``step_s`` — the seconds the step took here (Python's, not a device's).

A recurrence that steps position by position runs, on fake tensors,
through its allocations alone (the sLSTM's ``xlstm._SLSTMFake``), so
xlstm's cells finish in minutes.

Train cells run for every architecture; a cell whose config a mesh
cannot split (``transformer.check_train_mesh``) or that does not apply
(``configs.shapes.applicable``) is reported ``skipped`` with the
reason.  A cell that raises is ``failed``, and the CLI exits 1.
Results go to ``--out`` (default ``dryrun_out/``), one JSON
file a cell:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma_2b \\
        --shape decode_32k --mesh both --out dryrun_out
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs import shapes as shp
from repro_torch.core.spec import QuantSpec
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import serve as SV
from repro_torch.runtime import train as RT

DEFAULT_OUT = "dryrun_out"

# Per-arch train-cell memory policy, the reference's.
TRAIN_OVERRIDES = {
    "llama4_maverick": {"param_dtype": "bfloat16", "opt_dtype": "bfloat16",
                        "grad_dtype": "bfloat16", "microbatches": 8},
    "jamba_v01": {"microbatches": 8},
}
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
# the reference's serve_quant_config default (DRYRUN_D=3, packed_idx)
SERVE_QUANT = QuantSpec(mode="msgemm", d=3, scale_block=36,
                        storage="packed_idx")
SERVE_RULES = "default"  # the reference CLI's; --serve-rules serve too
CACHE_DTYPE = torch.bfloat16  # the reference's DRYRUN_CACHE_DTYPE default


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def state_bytes(state: dict, batch: dict) -> int:
    """The bytes of a rank's state (model buffers, optimizer trees, count,
    step) and batch rows."""
    from repro_torch.distributed.sharding import MOMENTS

    n = sum(_nbytes(b) for b in state["params"].buffers())
    for key, v in state["opt"].items():
        n += sum(_nbytes(t) for t in v.values()) if key in MOMENTS \
            else _nbytes(v)
    return n + _nbytes(state["step"]) + sum(_nbytes(t)
                                            for t in batch.values())


def _to_fake(state: dict, batch_shapes: dict) -> dict:
    """Every tensor of a (meta) state (a MoE block's routed-slot counters
    too), and the batch, as a fake tensor of its shape and dtype (called
    inside the ``FakeTensorMode``)."""
    from repro_torch.distributed.sharding import MOMENTS

    def fake(t):
        return torch.empty(t.shape, dtype=t.dtype)

    _fake_module(state["params"])
    state["opt"] = {k: ({n: fake(t) for n, t in v.items()}
                        if k in MOMENTS else fake(v))
                    for k, v in state["opt"].items()}
    state["step"] = fake(state["step"])
    return {k: torch.empty(s.shape, dtype=s.dtype)
            for k, s in batch_shapes.items()}


def measure(cfg, tcfg, batch_shapes: dict, mesh_shape: tuple, axes: tuple,
            *, rank: int = 0, seed: int = 0) -> dict:
    """One train step of ``cfg`` for rank ``rank`` of a fake mesh of
    ``mesh_shape`` / ``axes``: the rank's state (whole model drawn on the
    meta device, cut to its blocks, then faked) and its rows of a batch
    of ``batch_shapes`` ({name: shapes.Spec} of the whole batch).
    Returns the memory, collectives and seconds (the module doc)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import batch_rows
    from repro_torch.launch.mesh import make_mesh

    world = math.prod(mesh_shape)
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own (fake) process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(mesh_shape, axes)
        state = RT.init_state(cfg, tcfg, generator=torch.Generator(
        ).manual_seed(seed), device="meta", mesh=mesh)
        B = next(iter(batch_shapes.values())).shape[0]
        _, rows = batch_rows(B, mesh)
        local = {k: shp.Spec((rows,) + tuple(s.shape[1:]), s.dtype)
                 for k, s in batch_shapes.items()}
        with FakeTensorMode():
            batch = _to_fake(state, local)
            args = state_bytes(state, batch)
            tracker = MemTracker()
            tracker.track_external(state["params"], *batch.values(),
                                   *[t for k, v in state["opt"].items()
                                     if isinstance(v, dict)
                                     for t in v.values()])
            coll.reset_counts()
            t0 = time.perf_counter()
            with tracker:
                RT.train_step(state, batch, cfg, tcfg)
            step_s = time.perf_counter() - t0
            peak = tracker.get_tracker_snapshot("peak")
        counts = {k: {"count": coll.counts[k], "bytes": coll.nbytes[k]}
                  for k in sorted(coll.counts)}
    finally:
        dist.destroy_process_group()
    total = max((v.get("Total", 0) for v in peak.values()), default=0)
    return {"memory": {"argument_bytes_per_device": args,
                       "peak_bytes_per_device": total,
                       "total_per_device_gb": round(total / 2**30, 3),
                       "peak_by_category": {str(d): dict(v)
                                            for d, v in peak.items()}},
            "collectives": counts, "step_s": step_s,
            "local_batch": rows, "rank": rank}


def _fake_module(model: torch.nn.Module) -> None:
    """Every buffer of ``model``, and a MoE block's routed-slot counters,
    as a fake tensor of its shape and dtype (called inside the
    ``FakeTensorMode``)."""
    from repro_torch.models import moe

    for mod in model.modules():
        for n, b in mod._buffers.items():
            mod._buffers[n] = torch.empty(b.shape, dtype=b.dtype)
        if isinstance(mod, moe.MoE):
            mod.route_counts = torch.zeros(2, dtype=torch.int64)


def serve_inputs(cfg, shape, mesh, rules: str = SERVE_RULES, *,
                 make=None):
    """(this rank's inputs of a serve cell of ``shape`` (a
    ``configs.shapes.Shape`` or its name), the mesh axis or axes its rows
    split over): a prefill's batch rows, or a decode's token, position
    and cache block (``runtime.serve.mesh_specs`` of the whole
    seq_len-deep cache).  ``make(dims, dtype, name)`` builds a tensor
    (default ``torch.empty``: no values)."""
    from repro_torch.distributed import sharding

    make = make or (lambda dims, dtype, name: torch.empty(dims,
                                                          dtype=dtype))
    shape = shp.SHAPES[shape] if isinstance(shape, str) else shape
    whole = (shp.prefill_input_specs(cfg, shape) if shape.kind == "prefill"
             else shp.decode_input_specs(cfg, shape))
    lead = "token" if shape.kind == "decode" else "tokens"
    B = whole[lead].shape[0]
    row = sharding.batch_specs({lead: whole[lead].shape}, mesh,
                               rules)[lead][0]
    rows = sharding.local_shape((B,), (row,), mesh)[0]
    if shape.kind == "prefill":
        return {k: make((rows,) + tuple(v.shape[1:]), v.dtype, k)
                for k, v in whole.items()}, row
    ccfg = cfg
    max_len = shape.seq_len
    if cfg.is_encdec:
        src, max_len = shp._whisper_lens(cfg, shape)
        ccfg = cfg.replace(max_source_len=src)
    proto, specs = SV.mesh_specs(ccfg, B, max_len, CACHE_DTYPE, mesh, rules)
    cache = [{n: make(sharding.local_shape(tuple(t.shape), spec[n], mesh),
                      t.dtype, n) for n, t in layer.items()}
             for layer, spec in zip(proto, specs)]
    return {"token": make((rows,), torch.int32, "token"),
            "pos": make((rows,), torch.int32, "pos"), "cache": cache}, row


def serve_step(params, cfg, kind: str, inputs: dict, mesh, row,
               rules: str = SERVE_RULES):
    """One step of a serve cell on this rank: ``transformer.prefill`` over
    its prompt rows (no cache) or one ``decode_step`` against its cache
    block."""
    from repro_torch.distributed import sharding

    with torch.no_grad(), sharding.use(mesh, rules), \
            sharding.split_rows(row):
        if kind == "prefill":
            return transformer.prefill(params, cfg, inputs, None)[0]
        return transformer.decode_step(params, cfg, inputs["token"],
                                       inputs["cache"], inputs["pos"])[0]


def serve_bytes(params, inputs: dict) -> int:
    """The bytes of a rank's serve arguments: its weights and its inputs
    (a decode's cache included)."""
    n = sum(_nbytes(b) for b in params.buffers())
    for v in inputs.values():
        n += (sum(_nbytes(t) for layer in v for t in layer.values())
              if isinstance(v, list) else _nbytes(v))
    return n


def measure_serve(cfg, shape, mesh_shape: tuple, axes: tuple, *,
                  rank: int = 0, seed: int = 0,
                  rules: str = SERVE_RULES) -> dict:
    """One serve step of ``shape`` (a ``configs.shapes.Shape`` or its
    name) of ``cfg`` (quantized weights: ``cfg.quant``) for
    rank ``rank`` of a fake mesh: the whole model drawn and quantized on
    the meta device, cut to the rank's shard (``shard_params``), then
    faked with the rank's inputs (:func:`serve_inputs`).  Returns the
    memory, collectives and seconds (the module doc)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_mesh

    world = math.prod(mesh_shape)
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own (fake) process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(mesh_shape, axes)
        whole = transformer.init_params(
            cfg, generator=torch.Generator().manual_seed(seed),
            device="meta", quant=cfg.quant)
        params = SV.shard_params(whole, cfg, mesh, rules)
        del whole
        shape = shp.SHAPES[shape] if isinstance(shape, str) else shape
        kind = shape.kind
        with FakeTensorMode():
            _fake_module(params)
            inputs, row = serve_inputs(cfg, shape, mesh, rules)
            args = serve_bytes(params, inputs)
            tracker = MemTracker()
            cache = [t for layer in inputs.get("cache", ())
                     for t in layer.values()]
            tracker.track_external(params, *[v for v in inputs.values()
                                             if torch.is_tensor(v)],
                                   *cache)
            coll.reset_counts()
            t0 = time.perf_counter()
            with tracker:
                serve_step(params, cfg, kind, inputs, mesh, row, rules)
            step_s = time.perf_counter() - t0
            peak = tracker.get_tracker_snapshot("peak")
        counts = {k: {"count": coll.counts[k], "bytes": coll.nbytes[k]}
                  for k in sorted(coll.counts)}
    finally:
        dist.destroy_process_group()
    total = max((v.get("Total", 0) for v in peak.values()), default=0)
    rows = (inputs["token"] if kind == "decode" else inputs["tokens"]
            ).shape[0]
    return {"memory": {"argument_bytes_per_device": args,
                       "peak_bytes_per_device": total,
                       "total_per_device_gb": round(total / 2**30, 3),
                       "peak_by_category": {str(d): dict(v)
                                            for d, v in peak.items()}},
            "collectives": counts, "step_s": step_s,
            "local_batch": rows, "rank": rank}


def serve_config(arch: str, *, smoke: bool = False):
    """An arch's serve-cell config: its weights under :data:`SERVE_QUANT`."""
    base = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    return base.replace(quant=SERVE_QUANT)


def train_configs(arch: str, *, smoke: bool = False):
    """(model config, train config) of an arch's train cell: the
    reference's ``TRAIN_OVERRIDES`` (4 microbatches by default)."""
    base = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    ov = TRAIN_OVERRIDES.get(arch, {})
    cfg = base.replace(**{k: v for k, v in ov.items() if k == "param_dtype"})
    tcfg = RT.TrainConfig(
        optimizer=AdamWConfig(state_dtype=ov.get("opt_dtype", "float32")),
        grad_accum_dtype=ov.get("grad_dtype", "float32"),
        microbatches=ov.get("microbatches", 4))
    return cfg, tcfg


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             smoke: bool = False, verbose: bool = True,
             rules: str = SERVE_RULES) -> dict:
    """One cell: ``ok`` with its figures, or ``skipped`` with the reason.
    ``rules``: a serve cell's rule set.  Raises where the step fails (the
    CLI records ``failed``)."""
    shape = shp.SHAPES[shape_name]
    train = shape.kind == "train"
    quant = "bf16" if train else SERVE_QUANT.mode
    label = (f"{arch}/{shape_name}/{'multi' if multi_pod else 'single'}/"
             f"{quant}")
    cfg, tcfg = train_configs(arch, smoke=smoke)
    ok, reason = shp.applicable(cfg, shape_name)
    if ok and train:
        try:
            shape, axes = MESHES[multi_pod]
            transformer.check_train_mesh(cfg, MeshShape(dict(zip(axes,
                                                                 shape))))
        except NotImplementedError as e:
            ok, reason = False, str(e)
    if not ok:
        if verbose:
            print(f"[dryrun] {label}: skipped ({reason})", flush=True)
        return {"cell": label, "status": "skipped", "reason": reason}
    mesh_shape, axes = MESHES[multi_pod]
    if train:
        res = measure(cfg, tcfg, shp.input_specs(cfg, shape_name),
                      mesh_shape, axes)
        extra = {"microbatches": tcfg.microbatches}
    else:
        res = measure_serve(serve_config(arch, smoke=smoke), shape_name,
                            mesh_shape, axes, rules=rules)
        extra = {"rules": rules, "d": SERVE_QUANT.d,
                 "scale_block": SERVE_QUANT.scale_block,
                 "storage": SERVE_QUANT.storage}
    out = {"cell": label, "status": "ok", "arch": arch,
           "shape": shape_name, "smoke": smoke,
           "mesh": "x".join(map(str, mesh_shape)),
           "devices": math.prod(mesh_shape), "quant": quant, **extra,
           **res}
    if verbose:
        mem = res["memory"]
        print(f"[dryrun] {label}: step {res['step_s']:.1f}s (host), "
              f"arguments {mem['argument_bytes_per_device'] / 2**30:.3f} "
              f"GiB/device, peak {mem['total_per_device_gb']} GiB/device; "
              "collectives "
              + ", ".join(f"{k}:{v['count']}({v['bytes'] / 2**20:.1f}MiB)"
                          for k, v in res["collectives"].items()),
              flush=True)
    return out


def save_result(res: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, res["cell"].replace("/", "__") + ".json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path


def main(argv=None) -> list[dict]:
    """Run the CLI on ``argv``; returns the cells' results.  SystemExit(1)
    when a cell failed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (a quick check)")
    ap.add_argument("--serve-rules", default=SERVE_RULES,
                    choices=["default", "serve"],
                    help="the serve cells' rule set (default: "
                         "%(default)s, FSDP weight storage)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"result directory (default {DEFAULT_OUT}/)")
    args = ap.parse_args(argv)

    archs = configs.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(shp.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results, failures = [], 0
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                try:
                    res = run_cell(arch, shape_name, multi_pod=multi,
                                   smoke=args.smoke,
                                   rules=args.serve_rules)
                except Exception as e:  # a failure here is a system bug
                    traceback.print_exc()
                    quant = "bf16" if shp.SHAPES[shape_name].kind == \
                        "train" else SERVE_QUANT.mode
                    res = {"cell": f"{arch}/{shape_name}/"
                                   f"{'multi' if multi else 'single'}/"
                                   f"{quant}",
                           "status": "failed",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                save_result(res, args.out)
                results.append(res)
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    print(f"[dryrun] done: {ok} ok, {sk} skipped, {failures} FAILED "
          f"(results in {args.out}/)")
    if failures:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
