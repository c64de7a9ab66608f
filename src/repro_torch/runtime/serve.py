"""Serving runtime over the port's model; port of repro.runtime.serve.

Two cache layouts share the model code:

* static — dense (batch, max_len, ...) caches, fixed batch
  (``init_cache`` / ``prefill_step`` / ``decode_step`` / ``generate``);
* paged  — a shared block pool + per-sequence view indices
  (``init_paged_cache`` / ``paged_step``), driven by
  ``repro_torch.serving.Engine``.

``paged_step`` is phase-agnostic: a prefill chunk is a (1, C) call and a
decode batch a (B, 1) call of the same function.  ``generate`` is greedy;
:func:`sample` draws from an explicit ``torch.Generator`` (the reference
draws with a ``jax.random`` key, so the two give different numbers from
one seed).  The serving engine samples on the host with the reference's
numpy draws instead, so its sampled tokens match the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device=None):
    return transformer.init_cache(cfg, batch, max_len, dtype, device=device)


def prefill_step(params, cfg: ModelConfig, batch, cache):
    """Prompt ingestion; ``batch`` as ``transformer.prefill`` takes it.
    Returns (last logits, cache)."""
    return transformer.prefill(params, cfg, batch, cache)


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    return transformer.decode_step(params, cfg, token, cache, pos)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, *, device=None, kv_spec=None,
                     mesh=None, rules: str = "serve"):
    """Paged KV block pool; ``kv_spec`` (default ``cfg.kv_quant``) selects
    the quantized codes + scales layout (repro_torch.kvq).  With ``mesh``
    each leaf is this rank's shard under ``rules``
    (``distributed.sharding.paged_cache_specs``: kv heads over 'model'
    when they divide, block and slot dims whole), zero-filled as the
    whole pool is."""
    if mesh is None:
        return transformer.init_paged_cache(cfg, num_blocks, block_size,
                                             dtype, device=device,
                                             kv_spec=kv_spec)
    from repro_torch.distributed import sharding

    # one (1, 1)-slot pool gives each leaf's name, dtype and tail dims
    proto = transformer.init_paged_cache(cfg, 1, 1, dtype, device="cpu",
                                         kv_spec=kv_spec)
    whole = [{name: (num_blocks, block_size, *t.shape[2:])
              for name, t in layer.items()} for layer in proto]
    specs = sharding.paged_cache_specs(whole, mesh, rules)
    dev = resolve(device)
    return [{name: torch.zeros(sharding.local_shape(shape, spec[name], mesh),
                               dtype=p[name].dtype, device=dev)
             for name, shape in layer.items()}
            for layer, spec, p in zip(whole, specs, proto)]


def served_on(mesh, rules: str) -> tuple:
    """What a rank's copy of a model is for: the mesh's axes and the rule
    set (a copy's ``served_on``)."""
    from repro_torch.distributed import compat

    return tuple(compat.axes_of(mesh).items()), rules


def shard_params(params, cfg: ModelConfig, mesh, rules: str = "serve"):
    """This rank's copy of a model for serving on ``mesh``, in the layout
    the model code runs there (``models.transformer``'s docstring), each
    cut leaf a contiguous copy.  The layout is decided here and recorded
    on the modules, which the model code reads: a linear's ``axes`` (the
    plan shards it by them; a linear left whole has none) and ``out_dim``
    (its whole m, where its rows are cut), ``Attention.layout``,
    ``Experts.layout``, ``Mamba.tp`` and ``MLSTM.tp``:

    * attention (``layers.head_layout``): wq holds this rank's heads, wk
      and wv its kv heads (whole where there is one kv head), wo the
      heads' columns, where the heads split; otherwise all four whole (a
      full sequence splits its query positions over 'model' instead,
      ``HeadLayout.q_whole``);
    * every other linear the layout ``dispatch.shard.shard_spec_for``
      derives: an MLP's up, gate (column-parallel) and down (row-parallel
      where its packed storage splits on the boundary, else whole), an
      untied ``lm_head``;
    * a MoE block (``moe.expert_layout``): this rank's experts, or its
      block of each expert's hidden dim; the router whole;
    * a Mamba (``mamba.tensor_parallel``) and an mLSTM
      (``xlstm.mlstm_tensor_parallel``): this rank's channels of every
      leaf that has them, ``in_proj``'s and ``xl_up``'s rows taken from
      both halves, so its block is [its channels of the first half, its
      channels of the second]; the projections that contract over the
      channels row-parallel where they split there;
    * the embedding its rows under ``sharding.param_specs`` (the vocab
      over 'model' when it divides); norms, an sLSTM's W and R, and
      every leaf of a mixer that does not split stay whole.

    ``rules`` 'default' (FSDP storage) stores, on top of that layout,
    this rank's 'data' block of every leaf whose model dim takes 'data'
    under ``sharding.param_specs(params, mesh, "default")``
    (``sharding.fsdp_store``); the model code gathers a block's for each
    step (``sharding.gather_fsdp``), and the embedding table's columns
    are read in their blocks (``models.transformer``).  The activation
    rules of 'default' and 'serve' are the same, so everything else is
    the 'serve' layout.  An expert stack cut so stays cut at every step
    (its out dim is 'data': ``Experts.data_out``, the tokens move).

    ``params`` is left as it was: the copy shares every leaf it does not
    cut, and a MoE block's routed-slot counters; a rank that must never
    hold the whole model draws its copy with :func:`init_shard` instead.
    The copy records what it is for (``served_on``, :func:`served_on`),
    so ``Engine(mesh=)`` and ``generate(mesh=)`` take it as it is."""
    import copy

    from repro_torch.distributed import sharding
    from repro_torch.models import moe

    if getattr(params, "served_on", None) is not None:
        raise ValueError(f"params is already a rank's copy (for "
                         f"{params.served_on}), not the whole model")
    fsdp = sharding.param_specs(params, mesh, "default") \
        if rules == "default" else None
    memo = {id(t): t for t in params.buffers()}
    memo.update({id(m.route_counts): m.route_counts
                 for m in params.modules() if isinstance(m, moe.MoE)})
    out = copy.deepcopy(params, memo)
    _cut_layout(out, cfg, mesh)
    out.register_buffer("embedding", _cut_table(params.embedding, cfg,
                                                mesh))
    if fsdp is not None:
        sharding.fsdp_store(out, fsdp, mesh)
    out.served_on = served_on(mesh, rules)
    return out


def init_shard(cfg: ModelConfig, mesh, rules: str = "serve", *,
               generator: torch.Generator, device=None, quant=None):
    """This rank's copy of ``transformer.init_params(cfg, generator=,
    device=, quant=)`` for serving on ``mesh`` under ``rules``, equal to
    :func:`shard_params` of that whole model, without ever holding it:
    the model is drawn as ``init_params`` draws it (the same draws, so
    the same values), and each part is cut to this rank's copy as soon
    as it is whole (``init_params``'s ``place``).  At most one whole
    block and the whole embedding table (until it is cut, before the
    first block is drawn) are on ``device`` beside the copy.  The copy's
    config is ``cfg.replace(quant=quant)``."""
    from repro_torch.distributed import compat, sharding

    qcfg = cfg if quant is None else cfg.replace(quant=quant)
    fsdp = rules == "default" and \
        compat.axes_of(mesh).get(sharding.FSDP_AXIS, 1) > 1
    table_cut = {}

    def place(name, part):
        if name == "embedding":
            holder = torch.nn.Module()
            holder.register_buffer("embedding", _cut_table(part, qcfg, mesh))
            if fsdp:
                table_cut.update(sharding.fsdp_cut(holder, sharding.param_specs(
                    {"embedding": tuple(part.shape)}, mesh, "default"), mesh))
            return holder.embedding
        specs = sharding.param_specs(part, mesh, "default") if fsdp else None
        _cut_layout(part, qcfg, mesh)
        if specs is not None:
            cut = sharding.fsdp_cut(part, specs, mesh)
            if name == "lm_head":  # the holder's head owns its record
                sharding.fsdp_record(part.lm_head, {
                    k.partition(".")[2]: d for k, d in cut.items()})
            else:
                sharding.fsdp_record(part, cut)
        return part

    model = transformer.init_params(cfg, generator=generator, device=device,
                                    quant=quant, place=place)
    if fsdp:
        model.fsdp = table_cut
    model.served_on = served_on(mesh, rules)
    return model


def _cut_table(table: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """This rank's rows of the embedding ``table`` (whole): its vocab
    block over 'model' where the vocab takes it
    (``transformer.vocab_axis``), else the table itself."""
    from repro_torch.distributed import sharding

    with sharding.use(mesh, "serve"):
        axis = transformer.vocab_axis(cfg)
    if axis is None:
        return table
    return sharding.local_slice(table, (axis, None), mesh).contiguous() \
        .clone()


def _cut_layout(root, cfg: ModelConfig, mesh) -> None:
    """Cut, in place, every module of ``root`` (a model, a block, or a
    module holding ``lm_head``) to this rank's part of the 'serve'
    layout (:func:`shard_params`), and record the layout on the
    modules."""
    from repro_torch.core.spec import expert_spec
    from repro_torch.dispatch.shard import _quant_aligned, shard_linear
    from repro_torch.distributed import sharding
    from repro_torch.models import common, layers, mamba, moe, xlstm

    rules = "serve"
    M = sharding.tp_size(mesh)
    r = sharding.coord(mesh, sharding.TP_AXIS) if M > 1 else 0

    def cut(lin, name, k):
        """``lin`` cut as ``shard_spec_for`` lays out a linear ``name`` of
        whole in-dim ``k``, its axes recorded for the plan."""
        leaves = lin.params()
        m = common.out_rows(lin)
        lin.axes = sharding.LINEAR_AXES[name]
        local = shard_linear(cfg.quant, lin.axes, leaves, m, k, mesh,
                             rules=rules)
        if local is not leaves:
            lin.load(local)
            lin.out_dim = m

    def block(t, dim, n):
        """This rank's block of ``n`` along ``dim`` of ``t``."""
        return t.narrow(dim, r * n, n).contiguous().clone()

    def halves(lin, name, half):
        """Rows of this rank's channels of both halves (2 x ``half``) of
        the column-parallel linear ``name``."""
        m = common.out_rows(lin)
        n = half // M
        lin.load({leaf: t if leaf == "codebook" else torch.cat(
            [block(t, 0, n), t.narrow(0, half + r * n, n)]).contiguous()
            for leaf, t in lin.params().items()})
        lin.axes, lin.out_dim = sharding.LINEAR_AXES[name], m

    def channels(tree, names, dim, n):
        for name in names:
            tree._buffers[name] = block(tree._buffers[name], dim, n)

    d = cfg.d_model
    for mod in root.modules():
        if isinstance(mod, layers.Attention):
            mod.layout = layers.head_layout(cfg, mesh)
            if mod.layout.q_whole:  # a full sequence splits its positions
                continue
            cut(mod.wq, "wq", d)
            if not mod.layout.kv_whole:
                cut(mod.wk, "wk", d)
                cut(mod.wv, "wv", d)
            cut(mod.wo, "wo", cfg.num_heads * cfg.head_dim)
        elif isinstance(mod, common.MLP):
            dff = common.out_rows(mod.up)
            for name in ("up", "gate"):
                if hasattr(mod, name):
                    cut(getattr(mod, name), name, d)
            cut(mod.down, "down", dff)
        elif isinstance(mod, moe.MoE):
            ex = mod.experts
            lay = ex.layout = moe.expert_layout(cfg, mesh)
            lins = [getattr(ex, n) for n in ("up", "gate", "down")
                    if hasattr(ex, n)]
            if lay == "ep":
                for lin in lins:
                    lin.load({n: block(t, 0, cfg.num_experts // M)
                              for n, t in lin.params().items()})
            elif lay == "tp":
                mdff = cfg.moe_d_ff or cfg.d_ff
                n = mdff // M
                for lin in lins[:-1]:  # up, gate: their rows
                    lin.load({name: t if name == "codebook" else
                              block(t, 1, n)
                              for name, t in lin.params().items()})
                spec = expert_spec(cfg.quant)
                if _quant_aligned(spec, n):  # down: its contraction
                    per = {"w": 1, "u8": 2, "idx": 1 if spec.mode == "bf16"
                           else int(spec.d), "scales": spec.scale_block}
                    ex.down.load({name: t if name == "codebook" else
                                  block(t, 2, n // per[name])
                                  for name, t in ex.down.params().items()})
                    ex.down_local = True
        elif isinstance(mod, mamba.Mamba) and mamba.tensor_parallel(
                cfg, mesh):
            di = cfg.mamba_d_inner
            n = di // M
            mod.tp = True
            halves(mod.in_proj, "in_proj", di)
            channels(mod, ("conv_w",), 1, n)
            channels(mod, ("conv_b", "A_log", "D"), 0, n)
            channels(mod.dt_proj, ("w", "b"), 0, n)
            cut(mod.x_proj, "x_proj", di)
            cut(mod.out_proj, "out_proj", di)
        elif isinstance(mod, xlstm.MLSTM) and xlstm.mlstm_tensor_parallel(
                cfg, mesh):
            di, H, _ = xlstm._dims(cfg)
            n = di // M
            mod.tp = True
            halves(mod.xl_up, "xl_up", di)
            channels(mod, ("xl_conv_w",), 1, n)
            channels(mod, ("xl_conv_b", "lskip"), 0, n)
            channels(mod.xl_gates, ("w",), 1, n)
            for name in ("xl_q", "xl_k", "xl_v"):
                channels(getattr(mod, name), ("w",), 0, H // M)
            cut(mod.xl_o, "xl_o", d)
            cut(mod.xl_down, "xl_down", di)
    if hasattr(root, "lm_head"):
        cut(root.lm_head, "lm_head", d)


def paged_step(params, cfg: ModelConfig, tokens, pool, positions,
               write_slots, view_slots, last_idx):
    """One serving step over the paged pool.  ``last_idx`` (B,) picks the
    chunk position whose next-token logits each row returns.
    Returns (logits (B, V), pool)."""
    logits, pool = transformer.forward_paged(
        params, cfg, tokens, pool, positions, write_slots, view_slots)
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, last_idx.long()], pool


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator | None = None,
           temperature: float = 1.0) -> torch.Tensor:
    """Greedy at temperature 0, else one draw per row of ``logits`` (..., V)
    from softmax(logits / temperature), int32 of shape (...)."""
    if temperature == 0.0:
        return greedy(logits)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    draw = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                             generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


def decode_positions(cfg: ModelConfig, batch: int, seq_len: int, *,
                     device=None) -> torch.Tensor:
    """Positions (batch,) int32 of a decode_step at context length
    ``seq_len``."""
    return torch.full((batch,), seq_len - 1, dtype=torch.int32,
                      device=device)


def static_cache(cfg: ModelConfig, batch, max_new_tokens: int, *,
                 max_len: int | None = None, cache_dtype=torch.float32,
                 mesh=None, rules: str = "serve"):
    """(cache, pos0) of a static generation of ``max_new_tokens`` over
    ``batch`` (as :func:`generate` takes it): the dense cache on the
    tokens' device and the first decode position.

    A vision frontend's ``num_patches`` count in the cache length and in
    ``pos0``.  An encoder-decoder config's cross K/V are allocated at the
    frames' length (the reference allocates them at ``max_source_len``
    and prefill replaces them, which at whisper's 32768 would be 25.8 GB
    of zeros at B = 4 with an f32 cache), and its last decode position,
    ``pos0 + max_new_tokens - 2``, is checked here against its learned
    positions, once, so that no decode step syncs to check its own.

    With ``mesh`` the cache is this rank's block of the whole batch's
    under ``sharding.static_cache_specs`` (:func:`mesh_cache`)."""
    batch = transformer.as_batch(batch)
    tokens = batch["tokens"]
    B, S = tokens.shape
    extra = cfg.num_patches if cfg.frontend == "image_patches" else 0
    pos0 = S + extra
    max_len = max_len or (pos0 + max_new_tokens)
    if cfg.is_encdec:
        transformer._check_positions(cfg, pos0 + max_new_tokens - 2)
        cfg = cfg.replace(max_source_len=batch["frames"].shape[1])
    if mesh is not None:
        return mesh_cache(cfg, B, max_len, cache_dtype, mesh, rules,
                          device=tokens.device), pos0
    return init_cache(cfg, B, max_len, cache_dtype,
                      device=tokens.device), pos0


def mesh_specs(cfg: ModelConfig, batch: int, max_len: int, dtype, mesh,
               rules: str = "serve"):
    """(whole shapes, specs) of a static cache of ``batch`` rows on
    ``mesh``: ``sharding.static_cache_specs``, with the mixers a rank runs
    whole there.  Where the cache splits its sequence (the kv heads
    cannot take 'model', ``layers.HeadLayout.seq_split``), ``max_len`` is
    rounded up to a multiple of the axis (positions past it are masked)
    and the cross K/V's source length must divide by it."""
    from repro_torch.distributed import sharding
    from repro_torch.models import layers, mamba, xlstm

    lay = layers.head_layout(cfg, mesh)
    kinds = [cfg.kind(i) for i in range(cfg.num_layers)]
    if lay.seq_split and set(kinds) & set(transformer.ATTENTION_KINDS):
        max_len = -(-max_len // lay.M) * lay.M
        if cfg.is_encdec and cfg.max_source_len % lay.M:
            raise ValueError(
                f"{cfg.name}: {cfg.max_source_len} source positions do not "
                f"split over the {lay.M} ranks of 'model' (the cross K/V's "
                "kv heads cannot take it)")
    whole = []
    if not mamba.tensor_parallel(cfg, mesh):
        whole += ["mamba", "mamba_moe"]
    if not xlstm.mlstm_tensor_parallel(cfg, mesh):
        whole.append("mlstm")
    proto = transformer.init_cache(cfg, batch, max_len, dtype,
                                   device="meta")
    return proto, sharding.static_cache_specs(
        [{n: tuple(t.shape) for n, t in layer.items()} for layer in proto],
        kinds, mesh, rules, whole=tuple(whole))


def mesh_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, mesh,
               rules: str = "serve", *, device=None) -> list[dict]:
    """This rank's blocks of ``init_cache(cfg, batch, max_len)`` on
    ``mesh`` (:func:`mesh_specs`), as ``init_cache`` fills them: zero,
    the recurrent stabilizers ``m`` at -inf."""
    from repro_torch.distributed import sharding

    proto, specs = mesh_specs(cfg, batch, max_len, dtype, mesh, rules)
    dev = resolve(device)
    return [{n: torch.full(sharding.local_shape(tuple(t.shape), spec[n],
                                                mesh),
                           -torch.inf if n == "m" else 0.0, dtype=t.dtype,
                           device=dev)
             for n, t in layer.items()}
            for layer, spec in zip(proto, specs)]


@torch.no_grad()
def generate(params, cfg: ModelConfig, batch, *, max_new_tokens: int,
             max_len: int | None = None, cache_dtype=torch.float32,
             mesh=None, rules: str = "serve",
             step_logits: list | None = None) -> torch.Tensor:
    """Batched greedy generation (prefill + decode loop) on the tokens'
    device.  batch: tokens (B, S), + frames or patch_embeds (a bare tokens
    tensor is the batch of its tokens) -> (B, max_new_tokens) int32.  The
    cache and the first decode position are :func:`static_cache`'s.

    With ``mesh`` every rank calls it (SPMD, under ``sharding.use(mesh,
    rules)``) with ``params`` its :func:`shard_params` (or
    :func:`init_shard`) copy and the whole
    batch: each runs the rows ``sharding.batch_specs`` gives it (split
    over 'data' where they divide), on its block of the cache, and the
    ranks' tokens are gathered, so every rank returns the run's.
    ``step_logits``: each step's logits (this rank's rows) are appended
    to it."""
    batch = transformer.as_batch(batch)
    if mesh is not None:
        from repro_torch.distributed import sharding

        with sharding.use(mesh, rules):
            row = sharding.batch_specs(
                {"tokens": tuple(batch["tokens"].shape)}, mesh,
                rules)["tokens"][0]
            cache, pos0 = static_cache(cfg, batch, max_new_tokens,
                                       max_len=max_len,
                                       cache_dtype=cache_dtype, mesh=mesh,
                                       rules=rules)
            mine = {k: sharding.local_slice(v, (row,), mesh)
                    for k, v in batch.items()}
            with sharding.split_rows(row):
                return sharding.gather_rows(_greedy_loop(
                    params, cfg, mine, cache, pos0, max_new_tokens,
                    step_logits))
    cache, pos0 = static_cache(cfg, batch, max_new_tokens, max_len=max_len,
                               cache_dtype=cache_dtype)
    return _greedy_loop(params, cfg, batch, cache, pos0, max_new_tokens,
                        step_logits)


def _greedy_loop(params, cfg: ModelConfig, batch: dict, cache, pos0: int,
                 max_new_tokens: int, step_logits=None) -> torch.Tensor:
    keep = step_logits.append if step_logits is not None else \
        (lambda t: None)
    tokens = batch["tokens"]
    logits, cache = prefill_step(params, cfg, batch, cache)
    keep(logits)
    tok = greedy(logits)
    out = [tok]
    for i in range(max_new_tokens - 1):
        # tok was produced for position pos0 + i; decode it there for the
        # next
        pos = torch.full((tokens.shape[0],), pos0 + i, dtype=torch.int64,
                         device=tokens.device)
        logits, cache = decode_step(params, cfg, tok, cache, pos)
        keep(logits)
        tok = greedy(logits)
        out.append(tok)
    return torch.stack(out, dim=1)
