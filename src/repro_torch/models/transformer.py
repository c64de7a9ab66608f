"""Model assembly — embeddings, the block stack of any ``BLOCK_KINDS``
mix, the encoder of an encoder-decoder config, dense and paged caches,
forward / prefill / decode; port of repro.models.transformer.

Blocks live in an ``nn.ModuleList`` (one module per layer) where the
reference stacks them ``(G, ...)`` for ``lax.scan``; caches are a list of
per-layer dicts: ``{"k", "v"}`` for an attention layer (and
``{"cross_k", "cross_v"}``, the projected source, in an encoder-decoder
config), the recurrent state otherwise (``{"ssm", "conv"}`` Mamba,
``{"C", "n", "m", "conv"}`` mLSTM, ``{"h", "c", "n", "m"}`` sLSTM).
Functions take the model as ``params``, like the reference's param
trees, and update caches in place.  The paged pool holds K/V only:
recurrent kinds, encoder-decoder configs and frontends are refused in
paged mode, as in the reference.

A batch is the reference's dict: ``tokens`` (B, S), plus ``frames`` (B,
S_src, d) for an encoder-decoder config or ``patch_embeds`` (B, P, d)
for an 'image_patches' frontend (stubs: precomputed embeddings).  A bare
tokens tensor stands for ``{"tokens": t}``.  The decoder of an
encoder-decoder config adds learned positions (``pos_embedding``, one row
for each of ``max_seq_len`` positions); a position past them raises
ValueError (the reference reads NaN rows there).

Under an active mesh (``distributed.sharding.use``: the paged engine,
static ``runtime.serve.generate``, the dry run's serve cells) every
serving mode (``prefill``, ``decode``, ``paged``, ``encode``) runs every
block kind on this rank's shard of a model cut by
``runtime.serve.shard_params``, in the training layout: attention on this
rank's heads (where they cannot take 'model', on whole weights, a full
sequence's query positions split over 'model' instead), the MLP and a
MoE block's experts (expert-parallel, or each expert tensor-parallel) on
its block of the hidden dim, a Mamba and an mLSTM on its channels, each
row-parallel projection ending in one collective; an sLSTM runs whole.  The embedding table may hold this
rank's vocab rows (:func:`vocab_axis`): the lookup sums the ranks' rows
and the tied head gathers the ranks' logit columns; a vision frontend's
patch embeddings enter whole on every rank.  Under the 'default' rules
(FSDP storage, ``sharding.fsdp_store``) each block's leaves stored cut
over 'data' are gathered at the top of the block for the step
(``sharding.gather_fsdp``; an expert stack stays cut and the tokens move
to it, ``models.moe``) and an untied head's before it runs; the
table's columns are gathered only where that moves fewer bytes than
the activations: a decode step's lookup gathers the looked-up
activations over 'data' and its tied head sums partial logits over
'data' (:func:`_embed_fsdp`, :func:`_tied_head_fsdp`).

:func:`forward` under an active mesh is a training step's, on a model
cut by ``sharding.shard_model`` (FSDP x TP, the 'default' rules): the
top-level leaves and, at the top of each layer group, the group's are
gathered over 'data' (``sharding.constrain_params``; the expert stacks
stay cut, the tokens move to them; with
``cfg.save_gathered_weights`` outside the group's remat, so the
backward pass does not gather them again); the blocks run
tensor-parallel over 'model' (``layers.attn_apply_tp``,
``common.mlp_apply_tp``; attention whose query heads cannot take 'model'
splits its query positions there); the vocab-split embedding's lookup
ends in a psum, and the logits stay split over the vocab into the loss.

Where the sequence divides 'model' (``sharding.residual_axis``: the
reference's 'seq' rule, as it pins the residual after the embedding and
after each block) a training step, a full-sequence prefill and the
encoder carry each rank's block [r·S/M, (r+1)·S/M) of the residual's
positions between blocks: the lookup's sum becomes a reduce-scatter over
them, the norms act on the block (their scales' gradients summed over
'model'), each sequence mixer and FFN gathers its normed block whole at
entry (``seq_in_gather``) and reduce-scatters its row-parallel partial
sums back onto the block at exit (``seq_out_scatter``; a whole output is
cut to it), and the head reads the gathered final norm (a prefill's last
position alone).  Decode (S = 1), a sequence that does not divide and
the paged engine's steps keep the residual whole (ROADMAP A13c).  Every
block kind trains so (:func:`_block_apply_tp`: a MoE block's experts
expert-parallel or each tensor-parallel, a Mamba on its channels, an
mLSTM on its heads, an sLSTM whole), and so do the encoder, the cross
attention, a vision frontend's patches and qk-norm; a mesh that cannot
split a layout is refused (:func:`check_train_mesh`).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch import kvq
from repro_torch.device import is_fake, resolve
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.models import common, layers, mamba, moe, xlstm
from repro_torch.models.config import ModelConfig

ATTENTION_KINDS = ("attn", "local", "moe")


class Block(common.Tree):
    """Pre-norm block: ``ln1``, the sequence mixer (``attn`` for the
    attention kinds, ``mamba`` for ``mamba``/``mamba_moe``), ``ln2`` and
    the FFN (``mlp``, or ``moe`` for ``moe``/``mamba_moe``); a decoder
    block of an encoder-decoder config also ``ln_cross`` and ``cross``."""


class Encoder(common.Tree):
    """An encoder-decoder config's encoder: ``blocks`` (``encoder_layers``
    plain 'attn' blocks, no cross attention) and its own ``final_norm``."""


def block_init(cfg: ModelConfig, kind: str = "attn", *,
               generator: torch.Generator, device=None, quant=None,
               cross: bool = False) -> nn.Module:
    """A block of ``kind``; a ``moe`` or ``mamba_moe`` block's experts are
    drawn and, with ``quant``, quantized one expert at a time
    (``moe.moe_init``).  ``cross``: an attention block also gets a cross
    attention (``ln_cross``, ``cross``)."""
    kw = dict(generator=generator, device=device)
    if kind == "mlstm":
        return xlstm.mlstm_init(cfg, **kw)
    if kind == "slstm":
        return xlstm.slstm_init(cfg, **kw)

    def norm():
        return common.norm_init(cfg.d_model, cfg.norm, device=device)

    def ffn():
        return (dict(moe=moe.moe_init(cfg, quant=quant, **kw))
                if kind in ("moe", "mamba_moe")
                else dict(mlp=common.mlp_init(cfg, cfg.d_ff, **kw)))

    if kind in ("mamba", "mamba_moe"):
        return Block(ln1=norm(), mamba=mamba.mamba_init(cfg, **kw),
                     ln2=norm(), **ffn())
    f = ffn()  # an attention block draws its FFN before its attention
    blk = Block(ln1=norm(), attn=layers.attn_init(cfg, **kw), ln2=norm(),
                **f)
    if cross:
        blk.ln_cross = norm()
        blk.cross = layers.attn_init(cfg, **kw)
    return blk


def block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                dtype, *, device=None) -> dict:
    """One layer's decode cache.  ``dtype`` applies to the K/V tensors; a
    recurrent state's conv tail takes the activations' dtype
    (``cfg.dtype``) and the rest of it stays f32, as in the reference.
    An encoder-decoder config's cross K/V hold ``cfg.max_source_len``
    positions (``max_len`` when 0); prefill replaces them with the
    projected source, so ``runtime.serve.generate`` sizes them at the
    batch's source length.  ``device="meta"`` gives the shapes and dtypes
    without storage."""
    if kind in ATTENTION_KINDS:
        def zeros(n):
            return torch.zeros((batch, n, cfg.num_kv_heads, cfg.head_dim),
                               dtype=dtype, device=device)

        c = {"k": zeros(max_len), "v": zeros(max_len)}
        if cfg.is_encdec:
            src = cfg.max_source_len or max_len
            c["cross_k"], c["cross_v"] = zeros(src), zeros(src)
        return c
    state_dt = getattr(torch, cfg.dtype)
    if kind in ("mamba", "mamba_moe"):
        return mamba.init_state(cfg, batch, state_dt, device=device)
    if kind == "mlstm":
        return xlstm.mlstm_state(cfg, batch, state_dt, device=device)
    if kind == "slstm":
        return xlstm.slstm_state(cfg, batch, state_dt, device=device)
    raise ValueError(kind)


class Transformer(nn.Module):
    """embedding (vocab, d) f32, final_norm, blocks, lm_head when the
    embeddings are not tied, and for an encoder-decoder config the
    ``encoder`` and the decoder's learned ``pos_embedding`` (max_seq_len,
    d) f32."""

    def __init__(self, embedding: torch.Tensor, final_norm: common.Norm,
                 blocks: list[Block], lm_head=None, encoder=None,
                 pos_embedding=None):
        super().__init__()
        self.register_buffer("embedding", embedding)
        self.final_norm = final_norm
        self.blocks = nn.ModuleList(blocks)
        if lm_head is not None:
            self.lm_head = lm_head
        if encoder is not None:
            self.encoder = encoder
            self.register_buffer("pos_embedding", pos_embedding)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, quant=None, place=None) -> Transformer:
    """Random weights from ``generator`` (which must live on ``device``).

    With ``quant`` (a QuantSpec), every block (the encoder's too) — and
    an untied lm_head — is quantized by ``quant.quantize_model`` right
    after it is drawn, so no more than one block's dense weights exist at
    a time (this is how a full-width model fits the card); a MoE block's
    experts, one expert's dense weights at a time.  A recurrent block's plain weights (conv,
    dt_proj, A_log, D; the mLSTM's q/k/v and gates; the sLSTM's W and R)
    stay f32.  The caller then serves with
    ``cfg.replace(quant=quant)``.

    ``place(name, part)`` returns what the model keeps of each part as
    soon as it is whole: the embedding table (``embedding``), each block
    once quantized (``blocks.i``, ``encoder.blocks.i``) and a module
    holding the untied head (``lm_head``); ``runtime.serve.init_shard``
    cuts each to a mesh rank's copy there, so no whole model exists.
    The generator's draws do not depend on it.
    """
    from repro_torch.quant import quantize_model

    dev = resolve(device)
    kw = dict(generator=generator, device=dev)
    place = place or (lambda name, part: part)
    emb = torch.empty((cfg.vocab_size, cfg.d_model), device=dev)
    nn.init.trunc_normal_(emb, a=-2.0, b=2.0, generator=generator)
    emb = place("embedding", emb)

    def blocks(n, kind=None, cross=False, prefix="blocks"):
        out = []
        for layer in range(n):
            blk = block_init(cfg, kind or cfg.kind(layer), quant=quant,
                             cross=cross, **kw)
            if quant is not None:
                quantize_model(blk, quant)
            out.append(place(f"{prefix}.{layer}", blk))
        return out

    decoder = blocks(cfg.num_layers, cross=cfg.is_encdec)
    head = None
    if not cfg.tie_embeddings:
        holder = nn.Module()
        holder.lm_head = common.linear_init(cfg.d_model, cfg.vocab_size,
                                            cfg, cfg.quant, **kw)
        if quant is not None:
            quantize_model(holder, quant)
        head = place("lm_head", holder).lm_head
    encoder = pos = None
    if cfg.is_encdec:
        encoder = Encoder(
            blocks=nn.ModuleList(blocks(cfg.encoder_layers, "attn",
                                        prefix="encoder.blocks")),
            final_norm=common.norm_init(cfg.d_model, cfg.norm, device=dev))
        pos = common.truncated_normal((cfg.max_seq_len, cfg.d_model), 0.02,
                                      **kw)
    return Transformer(emb, common.norm_init(cfg.d_model, cfg.norm,
                                             device=dev), decoder, head,
                       encoder, pos)


def _ffn(p, cfg: ModelConfig, x, aux: dict | None = None, seq=None):
    """The block's second half: the MLP with the block input riding the
    down projection's fused residual epilogue, or the MoE FFN's output
    added to it (the reference's ``_ffn``); a MoE FFN's aux terms are
    added into ``aux`` when given.  ``seq``: ``x`` is this rank's block
    of the positions over that axis, and so is the output."""
    h = common.norm_apply(p.ln2, x, cfg.norm, rms_offset=cfg.rms_offset)
    if hasattr(p, "moe"):
        y, a = moe.moe_apply(p.moe, h, cfg, seq=seq)
        if aux is not None:
            for k, v in a.items():
                aux[k] = aux[k] + v
        return x + y
    return common.mlp_apply(p.mlp, h, cfg, residual=x, seq=seq)


def block_apply(p: nn.Module, cfg: ModelConfig, kind: str, x, positions, *,
                mode: str = "train", cache: dict | None = None, pos=None,
                paged=None, enc_out=None, aux: dict | None = None,
                seq: str | None = None):
    """One block.  mode: ``train`` (full sequence, no cache), ``prefill``
    (full sequence, writes the prompt's K/V at 0, or the state after it),
    ``decode`` (one token at ``pos``), ``paged`` (``paged`` =
    (write_slots, view_slots) over the layer's block pool; attention
    kinds only), ``encode`` (an encoder block: non-causal, no cache).  An
    attention block's input rides the out-projection's and the
    down-projection's fused residual epilogues; a recurrent block writes
    its new state into ``cache``.  A decoder block with a cross attention
    attends to ``enc_out`` (the encoder's output), projecting it at
    prefill into ``cache["cross_k"/"cross_v"]`` (replaced, so their
    length becomes the source's) and reading them at decode.  A MoE
    FFN's ``load_balance`` and ``dropped_frac`` are added into ``aux``
    when given.  ``seq`` (a full-sequence mode on a mesh): ``x`` is this
    rank's block of the residual's positions over that axis
    (``sharding.residual_axis``), and so is the output; ``positions``
    and ``enc_out`` are whole.  Returns x."""
    if mode == "train" and sharding.active_mesh() is not None:
        return _block_apply_tp(p, cfg, kind, x, positions, enc_out=enc_out,
                               aux=aux, seq=seq)
    if mode == "paged" and kind not in ATTENTION_KINDS:
        raise NotImplementedError(
            f"paged serving supports attention block kinds only, got {kind!r}")
    if kind not in ATTENTION_KINDS:
        if kind in ("mamba", "mamba_moe"):
            h = common.norm_apply(p.ln1, x, cfg.norm,
                                  rms_offset=cfg.rms_offset)
            y, state = mamba.mamba_apply(p.mamba, cfg, h, state=cache,
                                         seq=seq)
            x = _ffn(p, cfg, x + y, aux, seq)
        elif kind == "mlstm":
            x, state = xlstm.mlstm_block_apply(p, cfg, x, state=cache,
                                               seq=seq)
        elif kind == "slstm":
            x, state = xlstm.slstm_block_apply(p, cfg, x, state=cache,
                                               seq=seq)
        else:
            raise ValueError(kind)
        if cache is not None:
            cache.update(state)
        return x
    window = cfg.sliding_window if kind == "local" else 0
    h = common.norm_apply(p.ln1, x, cfg.norm, rms_offset=cfg.rms_offset)
    if mode == "paged":
        write_slots, view_slots = paged
        x, _ = layers.attn_paged(p.attn, cfg, h, cache, positions,
                                 write_slots, view_slots, window=window,
                                 residual=x)
    elif mode == "decode":
        x, _, _ = layers.attn_decode(p.attn, cfg, h, cache["k"], cache["v"],
                                     pos, window=window, residual=x)
    elif cache is not None:  # prefill: every position's K/V, whatever
        # block of the queries this rank ran; it writes its cache block
        x, k, v = layers.attn_apply(p.attn, cfg, h, positions, window=window,
                                    return_kv=True, residual=x, seq=seq)
        layers.write_prefill(cache, "k", k, p.attn.layout)
        layers.write_prefill(cache, "v", v, p.attn.layout)
    else:
        x = layers.attn_apply(p.attn, cfg, h, positions, window=window,
                              causal=mode != "encode", residual=x, seq=seq)
    if mode != "encode" and hasattr(p, "cross"):
        hc = common.norm_apply(p.ln_cross, x, cfg.norm,
                               rms_offset=cfg.rms_offset)
        split = False
        if mode == "decode":
            ck, cv = cache["cross_k"], cache["cross_v"]
            split = p.cross.layout.seq_split
        else:
            ck, cv = layers.cross_kv(p.cross, cfg, enc_out)
            if cache is not None:  # prefill: this rank's block, if split
                lay = p.cross.layout
                cache["cross_k"] = layers.seq_block(ck, lay).to(
                    cache["cross_k"].dtype)
                cache["cross_v"] = layers.seq_block(cv, lay).to(
                    cache["cross_v"].dtype)
        x = layers.cross_attn_apply(p.cross, cfg, hc, ck, cv, residual=x,
                                    split=split, seq=seq)
    return _ffn(p, cfg, x, aux, seq)


def check_train_mesh(cfg: ModelConfig, mesh=None) -> None:
    """NotImplementedError (naming ROADMAP A13c) where a training step of
    ``cfg`` cannot run on ``mesh`` (a ``DeviceMesh``, or any object whose
    ``shape`` is its {axis: size}; None: no check): a two-halves leaf
    (``sharding.HALVES``: Mamba's ``in_proj``, the mLSTM's ``xl_up``)
    whose rows split over 'model' while its halves do not.  Every block
    kind, an encoder, a frontend and qk-norm train on a mesh; query heads
    that cannot split over 'model' (their count, or an uneven grouping
    over the kv heads) split the query positions instead
    (``layers.attn_apply_tp``)."""
    M = sharding.tp_size(mesh) if mesh is not None else 1
    if M == 1:
        return
    halves = {"mamba": (cfg.mamba_d_inner, ("mamba", "mamba_moe")),
              "mLSTM": (xlstm._dims(cfg)[0], ("mlstm",))}
    for name, (half, kinds) in halves.items():
        if set(kinds) & set(cfg.block_pattern) and (2 * half) % M == 0 \
                and half % M:
            raise NotImplementedError(
                f"{cfg.name}: the {name} block's two halves of {half} "
                f"channels do not split over model={M} while its rows do "
                "(ROADMAP A13c)")


def _ffn_tp(p, cfg: ModelConfig, x, aux: dict | None, seq=None):
    """:func:`_ffn` of a training step on a mesh: the MLP
    tensor-parallel, or the MoE FFN's (``moe.moe_apply_tp``), its aux
    shares added into ``aux``; ``seq`` as :func:`_block_apply_tp`'s."""
    h = common.norm_block(p.ln2, x, cfg.norm, seq, rms_offset=cfg.rms_offset)
    if hasattr(p, "moe"):
        y, a = moe.moe_apply_tp(p.moe, h, cfg, seq=seq)
        if aux is not None:
            for k, v in a.items():
                aux[k] = aux[k] + v
        return x + y
    return common.mlp_apply_tp(p.mlp, h, cfg, residual=x, d_ff=cfg.d_ff,
                               seq=seq)


def _block_apply_tp(p, cfg: ModelConfig, kind: str, x, positions, *,
                    enc_out=None, aux: dict | None = None,
                    causal: bool = True, seq: str | None = None):
    """A block of a training step on a mesh, on its weights gathered over
    'data', tensor-parallel over 'model' where its layout splits: the
    attention kinds (``layers.attn_apply_tp``, over the query positions
    where the heads cannot split; ``causal=False`` for an encoder block,
    and a decoder block's cross attention over ``enc_out``), the MLP or
    the MoE FFN, a Mamba on its channels, an
    mLSTM on its heads, an sLSTM whole (``mamba.mamba_apply_tp``,
    ``xlstm.*_block_apply_tp``).  A MoE FFN's aux shares are added into
    ``aux``.  ``seq``: ``x`` and the output are this rank's block of the
    residual's positions over that axis, as the reference pins the
    residual: the norms act on the block (``common.norm_block``), each
    sequence mixer and FFN gathers its normed block at entry and
    reduce-scatters (or cuts) its output back onto the block."""
    def norm(n, x):
        return common.norm_block(n, x, cfg.norm, seq,
                                 rms_offset=cfg.rms_offset)

    if kind in ("mamba", "mamba_moe"):
        y = mamba.mamba_apply_tp(p.mamba, cfg, norm(p.ln1, x), seq=seq)
        return _ffn_tp(p, cfg, x + y, aux, seq)
    if kind == "mlstm":
        return xlstm.mlstm_block_apply_tp(p, cfg, x, seq=seq)
    if kind == "slstm":
        return xlstm.slstm_block_apply_tp(p, cfg, x, seq=seq)
    if kind not in ATTENTION_KINDS:
        raise ValueError(kind)
    window = cfg.sliding_window if kind == "local" else 0
    x = layers.attn_apply_tp(p.attn, cfg, norm(p.ln1, x), positions,
                             window=window, residual=x, causal=causal,
                             seq=seq)
    if causal and hasattr(p, "cross"):
        x = layers.attn_apply_tp(p.cross, cfg, norm(p.ln_cross, x), None,
                                 residual=x, kv=enc_out, seq=seq)
    return _ffn_tp(p, cfg, x, aux, seq)


def _stack_apply(blocks: nn.ModuleList, cfg: ModelConfig, x, positions, *,
                 mode="train", cache=None, pos=None, paged=None,
                 enc_out=None, seq: str | None = None):
    """The decoder's ``blocks``, each of its pattern's kind, or in
    ``encode`` mode the encoder's, all 'attn'.  Returns (x, aux): in
    ``train`` mode the MoE blocks' ``load_balance`` and ``dropped_frac``
    (0-d f32), summed within each group of ``len(block_pattern)`` layers
    and then over the groups, as the reference's scan; None in the other
    modes.  In ``train`` mode with a backward pass to come and
    ``cfg.remat``, each group is rematerialized (``common.remat`` under
    ``cfg.remat_policy``); serving modes never are.  ``seq``: ``x`` is
    this rank's block of the residual's positions over that axis
    between blocks (:func:`block_apply`)."""
    period = 1 if mode == "encode" else len(cfg.block_pattern)
    train = mode == "train"
    do_remat = cfg.remat and train and common.needs_grad(x)
    mesh = sharding.active_mesh() if train else None
    rules = sharding.active_rules()

    def gather(first):
        """The group's blocks with their weights gathered over 'data'."""
        return [sharding.constrain_params(
            blocks[i], int8_gather=cfg.fsdp_int8_gather)
            for i in range(first, min(first + period, len(blocks)))]

    def group(x, first, gathered=None):
        if mesh is not None:
            # a remat recompute may run on autograd's own thread, where
            # the (thread-local) mesh context is not set
            with sharding.use(mesh, rules):
                return run_group(x, first, gathered or gather(first))
        return run_group(x, first, None)

    def run_group(x, first, gathered):
        # the sums start at 0.0, as the reference's zeros (0 + v == v)
        aux = {"load_balance": 0.0, "dropped_frac": 0.0} if train else None
        for i in range(first, min(first + period, len(blocks))):
            kind = "attn" if mode == "encode" else cfg.kind(i)
            # serving: a block stored cut over 'data' is gathered for this
            # step (freed after it); training's groups come gathered
            blk = sharding.gather_fsdp(blocks[i]) if gathered is None \
                else gathered[i - first]
            x = block_apply(blk, cfg, kind, x, positions, mode=mode,
                            cache=cache[i] if cache is not None else None,
                            pos=pos, paged=paged, enc_out=enc_out, aux=aux,
                            seq=seq)
        return x, aux

    total = {"load_balance": 0.0, "dropped_frac": 0.0}
    for first in range(0, len(blocks), period):
        if do_remat:
            # saved gathered weights come from outside the remat, so its
            # recompute reads them instead of gathering again
            kept = gather(first) if mesh is not None \
                and cfg.save_gathered_weights else None
            x, aux = common.remat(functools.partial(group, gathered=kept),
                                  x, first, policy=cfg.remat_policy)
        else:
            x, aux = group(x, first)
        if train:
            total = {k: total[k] + aux[k] for k in total}
    if not train:
        return x, None
    return x, {k: torch.as_tensor(v, dtype=torch.float32, device=x.device)
               for k, v in total.items()}


def as_batch(batch) -> dict:
    """The reference's batch dict; a bare tokens tensor stands for
    ``{"tokens": batch}``."""
    return batch if isinstance(batch, dict) else {"tokens": batch}


def vocab_axis(cfg: ModelConfig) -> str | None:
    """The mesh axis the embedding table's rows (the vocab) are split
    over under the active mesh (``sharding.param_specs``' rule for it),
    or None: no mesh, or a table each rank holds whole."""
    if sharding.active_mesh() is None:
        return None
    return sharding.spec_for(sharding.VECTOR_AXES["embedding"],
                             (cfg.vocab_size, cfg.d_model), kind="param")[0]


def _embed(table: torch.Tensor, cfg: ModelConfig, tokens,
           axis: str | None, *, scale: bool = True, seq: str | None = None,
           lead=None) -> torch.Tensor:
    """Rows of the embedding ``table`` for ``tokens``, in f32 and scaled
    by sqrt(d) for gemma, after ``lead`` (B, P, d), a vision frontend's
    patch embeddings, when given.  With ``axis`` the table holds this
    rank's block of the vocab along it: each rank looks up the tokens in
    its rows, zeros the others, and the ranks' rows are summed (exact:
    one is nonzero; ``ad_psum``, so a training step differentiates it).
    ``seq``: the rank keeps its block of the positions (``lead``'s
    counted) over that axis: the sum becomes a reduce-scatter over them
    (``lead`` entering on the first rank alone, zeros on the others), or
    from a whole table the rank looks up every token and keeps its block
    (``collectives.ad_block``: the table's gradient stays whole on every
    rank, and the backward gathers the rows' cotangent, not the table's
    sum)."""
    tokens = tokens.long()
    if axis is None:
        x = table[tokens]
    else:
        rows = table.shape[0]
        local = tokens - sharding.coord(sharding.active_mesh(), axis) * rows
        mine = (local >= 0) & (local < rows)
        x = torch.where(mine[..., None], table[torch.where(mine, local, 0)],
                        0.0)
    if cfg.embed_scale and scale:
        x = x * cfg.d_model**0.5
    if axis is not None and seq is not None:
        if lead is not None:  # the patches' rows on the first rank alone
            first = sharding.coord(sharding.active_mesh(), axis) == 0
            x = torch.cat([(lead if first else torch.zeros_like(lead))
                           .to(x.dtype), x], dim=1)
        return coll.ad_psum_scatter(x, seq, dim=1, kind=coll.SEQ_OUT)
    if axis is not None:
        x = coll.ad_psum(x, axis)
    if lead is not None:
        x = torch.cat([lead.to(x.dtype), x], dim=1)
    return x if seq is None else coll.ad_block(x, seq, dim=1)


def _fsdp_table(table: torch.Tensor, cfg: ModelConfig) -> bool:
    """Whether a serving copy stores the embedding ``table``'s columns (its
    model dim) cut over 'data' (the 'default' rules' FSDP storage)."""
    return table.shape[1] != cfg.d_model


def _gather_table(table: torch.Tensor) -> torch.Tensor:
    """The table's columns gathered whole over 'data' (its rows stay this
    rank's vocab block)."""
    return coll.all_gather(table, sharding.FSDP_AXIS, dim=1,
                           kind="fsdp_gather")


def _embed_fsdp(table: torch.Tensor, cfg: ModelConfig, tokens,
                axis: str | None, *, seq: str | None = None,
                lead=None) -> torch.Tensor:
    """:func:`_embed` from a table whose columns are this rank's block over
    'data', by whichever moves fewer bytes: where the whole step has
    fewer tokens than the table has rows here (decode), every rank looks
    up the whole step's tokens in its columns, the looked-up columns are
    gathered over 'data' and the rank keeps its rows; otherwise (a long
    prefill) the table's columns are gathered and the rank looks up its
    own tokens.  Both are exact.  ``seq`` and ``lead`` as
    :func:`_embed`'s (the first way, with patches, cuts the positions'
    block from the whole rows)."""
    if tokens.numel() * sharding.rows_factor() >= table.shape[0]:
        return _embed(_gather_table(table), cfg, tokens, axis, seq=seq,
                      lead=lead)
    whole = sharding.gather_rows(tokens)
    x = coll.all_gather(_embed(table, cfg, whole, axis, scale=False,
                               seq=seq if lead is None else None),
                        sharding.FSDP_AXIS, dim=-1)
    x = sharding.rows_block(x)
    x = x * cfg.d_model**0.5 if cfg.embed_scale else x
    if lead is None:
        return x
    x = torch.cat([lead.to(x.dtype), x], dim=1)
    return x.narrow(1, *sharding.seq_block(x.shape[1], seq))


def embed_inputs(params: Transformer, cfg: ModelConfig, tokens, *,
                 patch_embeds=None, seq: str | None = None):
    """tokens (B, S) -> (B, S, d): gathered in f32, scaled by sqrt(d) for
    gemma, with a vision frontend's ``patch_embeds`` (B, P, d), cast to
    f32, prepended; then cast to ``cfg.dtype``.  ``seq``: this rank's
    block of the positions (the patches' counted) over that axis."""
    embed = _embed_fsdp if _fsdp_table(params.embedding, cfg) else _embed
    x = embed(params.embedding, cfg, tokens, vocab_axis(cfg), seq=seq,
              lead=patch_embeds)
    return x.to(getattr(torch, cfg.dtype))


def _sinusoidal(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) f32 encoder positions: sin in the even columns, cos in the
    odd ones, the reference's divisor ``d // 2 - 1``."""
    f32 = dict(device=device, dtype=torch.float32)
    pos = torch.arange(S, **f32)[:, None]
    rate = -torch.log(torch.tensor(10000.0, **f32)) / (d // 2 - 1)
    div = torch.exp(torch.arange(0, d, 2, **f32) * rate)
    pe = torch.zeros((S, d), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def encode(params: Transformer, cfg: ModelConfig, frames) -> torch.Tensor:
    """The encoder over ``frames`` (B, S_src, d) from the stub frontend:
    cast to ``cfg.dtype``, plus sinusoidal positions cast alike, the
    non-causal blocks, the encoder's final norm.  On a mesh whose
    residual splits S_src (``sharding.residual_axis``) a rank carries
    its block of the frames through the blocks and the norm, and the
    output is gathered whole."""
    x = frames.to(getattr(torch, cfg.dtype))
    B, S = x.shape[:2]
    x = x + _sinusoidal(S, cfg.d_model, x.device).to(x.dtype)
    seq = sharding.residual_axis(S)
    x = x.narrow(1, *sharding.seq_block(S, seq))
    enc = params.encoder
    x, _ = _stack_apply(enc.blocks, cfg, x, _positions(B, S, x.device),
                        mode="encode", seq=seq)  # the encoder's aux dropped
    return common.seq_gather(common.norm_apply(
        enc.final_norm, x, cfg.norm, rms_offset=cfg.rms_offset), seq)


def _check_positions(cfg: ModelConfig, last: int) -> None:
    if last >= cfg.max_seq_len:
        raise ValueError(
            f"{cfg.name}: decoder position {last} past the "
            f"{cfg.max_seq_len} learned positions")


def _seq_len(b: dict) -> int:
    """A batch's full-sequence length: its tokens and patches."""
    patches = b.get("patch_embeds")
    return b["tokens"].shape[1] + (0 if patches is None
                                   else patches.shape[1])


def _inputs(params: Transformer, cfg: ModelConfig, batch,
            seq: str | None = None):
    """(x (B, S, d), enc_out or None) of a full-sequence pass: the encoder
    over ``frames``, the embedded tokens (patches prepended), and the
    decoder's learned positions 0..S-1.  ``seq``: x is this rank's block
    of the positions over that axis."""
    b = as_batch(batch)
    enc_out = encode(params, cfg, b["frames"]) if cfg.is_encdec else None
    x = embed_inputs(params, cfg, b["tokens"],
                     patch_embeds=b.get("patch_embeds"), seq=seq)
    if cfg.is_encdec:
        S = _seq_len(b)
        _check_positions(cfg, S - 1)
        x = x + params.pos_embedding.narrow(
            0, *sharding.seq_block(S, seq)).to(x.dtype)
    return x, enc_out


def _tied_head(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits of a tied head: ``x`` against the embedding ``table`` (or
    this rank's vocab rows of it) in f32."""
    return torch.matmul(x.to(torch.float32), table.to(torch.float32).t())


def _tied_head_fsdp(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """:func:`_tied_head` against a table whose columns are this rank's
    block over 'data', by whichever moves fewer bytes: where the whole
    step has fewer rows than the model dim (the head sees a step's last
    positions), the whole step's rows against those columns, the
    partial logits summed over 'data' and this rank's rows kept;
    otherwise against the table's columns gathered over 'data'."""
    d = x.shape[-1]
    if x[..., 0].numel() * sharding.rows_factor() >= d:
        return _tied_head(x, _gather_table(table))
    whole = sharding.gather_rows(x)
    n = table.shape[1]
    c = sharding.coord(sharding.active_mesh(), sharding.FSDP_AXIS)
    part = _tied_head(whole.narrow(-1, c * n, n), table)
    return sharding.rows_block(coll.psum(part, sharding.FSDP_AXIS))


def logits_from_hidden(params: Transformer, cfg: ModelConfig, x):
    """The head over the final norm of ``x``: the tied table (this rank's
    vocab rows of it gathered over their axis; its columns summed over
    'data' where they are stored cut), or the untied ``lm_head``
    (gathered over 'data' first where it is stored cut)."""
    x = common.norm_apply(params.final_norm, x, cfg.norm,
                          rms_offset=cfg.rms_offset)
    if cfg.tie_embeddings:
        table = params.embedding
        logits = (_tied_head_fsdp if _fsdp_table(table, cfg)
                  else _tied_head)(x, table)
        axis = vocab_axis(cfg)
        if axis is not None:  # this rank's vocab columns: gather them
            logits = coll.all_gather(logits, axis, dim=-1)
    else:
        logits = common.linear_apply(sharding.gather_fsdp(params.lm_head),
                                     x, cfg.quant, in_dim=cfg.d_model,
                                     tag="lm_head").to(torch.float32)
    return common.softcap(logits, cfg.final_logit_softcap)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward(params: Transformer, cfg: ModelConfig, batch, *,
            return_aux: bool = False):
    """Full-sequence forward of a batch (tokens, + frames / patch_embeds)
    -> logits (B, S, V), S counting the patches; with ``return_aux``
    (logits, aux), aux the MoE terms ``load_balance`` and
    ``dropped_frac`` (0-d f32, zero without MoE blocks), as the
    reference's forward returns.  Under an active mesh, a training
    step's forward on this rank's rows: logits (B, S, V / model) when
    the vocab splits over 'model' (:func:`_forward_tp`)."""
    if sharding.active_mesh() is not None:
        return _forward_tp(params, cfg, batch, return_aux)
    x, enc_out = _inputs(params, cfg, batch)
    B, S = x.shape[:2]
    x, aux = _stack_apply(params.blocks, cfg, x, _positions(B, S, x.device),
                          enc_out=enc_out)
    logits = logits_from_hidden(params, cfg, x)
    return (logits, aux) if return_aux else logits


def _forward_tp(params: Transformer, cfg: ModelConfig, batch,
                return_aux: bool):
    """:func:`forward` of a training step on a mesh (a model cut by
    ``sharding.shard_model``), taking what :func:`_inputs` takes.  The
    top-level leaves (the encoder's final norm among them) are gathered
    over 'data' once (the tied table serves the lookup and the head, so
    its gradient sums both before the reduce-scatter).  A table split
    over the vocab looks up this rank's rows and sums them over 'model'
    (one rank holds each token's); a vision frontend's patch embeddings
    go ahead of the text, whole on every rank; an encoder-decoder
    config's ``frames`` run through the encoder's blocks, each gathered
    over 'data' and run tensor-parallel and non-causal, and the decoder
    adds its learned positions.  The head's input enters through
    ``ad_identity`` and its logits keep this rank's vocab columns.

    Where the sequence (the patches counted) divides 'model'
    (``sharding.residual_axis``, the reference's pin of the residual),
    each rank carries its block [r·S/M, (r+1)·S/M) of the positions
    between blocks: the lookup's sum becomes a reduce-scatter over them
    (or a whole table looks up the block's tokens), the decoder's
    learned positions are the block's, every block gathers its normed
    input and reduce-scatters its output (``_block_apply_tp``), the
    final norm acts on the block and the head's input is gathered whole
    (``common.seq_gather``: its backward reduce-scatters where the vocab
    splits)."""
    mesh = sharding.active_mesh()
    check_train_mesh(cfg, mesh)
    axis = "model"
    top = sharding.constrain_params(
        {n: t for n, t in params.named_buffers()
         if not n.startswith(("blocks.", "encoder.blocks."))},
        specs=params.shard_specs, int8_gather=cfg.fsdp_int8_gather)
    b = as_batch(batch)
    enc_out = _encode_tp(params, cfg, b["frames"], top) \
        if cfg.is_encdec else None
    emb, V = top["embedding"], cfg.vocab_size
    S = _seq_len(b)
    seq = sharding.residual_axis(S, mesh=mesh)
    x = _embed(emb, cfg, b["tokens"], axis if emb.shape[0] != V else None,
               seq=seq, lead=b.get("patch_embeds"))
    x = x.to(getattr(torch, cfg.dtype))
    B = x.shape[0]
    if cfg.is_encdec:  # the block's rows of every rank's whole positions
        _check_positions(cfg, S - 1)
        pos = top["pos_embedding"][:S]
        if seq is not None:
            pos = coll.ad_block(pos, seq, dim=0)
        x = x + pos.to(x.dtype)
    x, aux = _stack_apply(params.blocks, cfg, x, _positions(B, S, x.device),
                          enc_out=enc_out, seq=seq)
    x = common.norm_block(
        common.Norm(top["final_norm.scale"], top.get("final_norm.bias")), x,
        cfg.norm, seq, rms_offset=cfg.rms_offset)
    w = emb if cfg.tie_embeddings else top["lm_head.w"]
    if seq is not None:
        x = common.seq_gather(x, seq, partial=w.shape[0] != V)
    elif w.shape[0] != V:
        x = coll.ad_identity(x, axis)
    if cfg.tie_embeddings:
        logits = _tied_head(x, w)
    else:
        logits = common.local_linear(w, x, tag="lm_head").to(torch.float32)
    logits = common.softcap(logits, cfg.final_logit_softcap)
    return (logits, aux) if return_aux else logits


def _encode_tp(params: Transformer, cfg: ModelConfig, frames, top: dict):
    """:func:`encode` of a training step on a mesh: each encoder block
    gathered over 'data' and run non-causal and tensor-parallel (over
    the frames where the heads cannot split; no remat, as the single
    device's encoder), then its final norm (from the gathered top-level
    leaves ``top``).  Where the frames divide 'model' a rank carries its
    block of them through the blocks and the norm, and the output is
    gathered whole for the cross attentions (its backward takes this
    rank's block of the whole gradient every rank holds)."""
    x = frames.to(getattr(torch, cfg.dtype))
    B, S = x.shape[:2]
    x = x + _sinusoidal(S, cfg.d_model, x.device).to(x.dtype)
    seq = sharding.residual_axis(S)
    x = x.narrow(1, *sharding.seq_block(S, seq))
    positions = _positions(B, S, x.device)
    for blk in params.encoder.blocks:
        x = _block_apply_tp(sharding.constrain_params(
            blk, int8_gather=cfg.fsdp_int8_gather), cfg, "attn", x,
            positions, causal=False, seq=seq)
    return common.seq_gather(common.norm_block(
        common.Norm(top["encoder.final_norm.scale"],
                    top.get("encoder.final_norm.bias")), x, cfg.norm, seq,
        rms_offset=cfg.rms_offset), seq)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device=None) -> list[dict]:
    """Per-layer decode caches (:func:`block_cache`): dense (batch,
    max_len, Hk, Dh) K/V for an attention layer, the zero recurrent state
    (whose size does not depend on ``max_len``) otherwise."""
    dev = resolve(device)
    return [block_cache(cfg, cfg.kind(i), batch, max_len, dtype, device=dev)
            for i in range(cfg.num_layers)]


def prefill(params: Transformer, cfg: ModelConfig, batch, cache):
    """Run the prompt (a batch: tokens, + frames / patch_embeds), filling
    ``cache`` (None: the forward over the prompt alone, as the dry run's
    prefill cell lowers it).  Returns (logits_last (B, V), cache).  On
    a mesh whose residual splits the prompt's positions
    (``sharding.residual_axis``) each rank carries its block through the
    blocks; the last position, on the last rank's block, is gathered
    alone for the head (every rank's last, of which the last is kept)."""
    S = _seq_len(as_batch(batch))
    seq = sharding.residual_axis(S)
    x, enc_out = _inputs(params, cfg, batch, seq)
    B = x.shape[0]
    x, _ = _stack_apply(params.blocks, cfg, x, _positions(B, S, x.device),
                        mode="prefill", cache=cache, enc_out=enc_out,
                        seq=seq)
    last = x[:, -1:, :]
    if seq is not None:
        last = coll.all_gather(last, seq, dim=1)[:, -1:]
    return logits_from_hidden(params, cfg, last)[:, 0], cache


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, *, device=None,
                     kv_spec=None) -> list[dict]:
    """Per-layer (num_blocks, bs, Hk, Dh) K/V block pools for paged serving;
    sequences own disjoint blocks through host-side block tables.
    ``kv_spec`` (default ``cfg.kv_quant``) lays each pool out as the
    quantized {"k", "k_scale", "v", "v_scale"} of repro_torch.kvq.pool:
    the same block and slot indexing, fewer bytes per token.  Recurrent
    (attention-free) block kinds, encoder-decoder configs and modality
    frontends are not paged: NotImplementedError, as in the reference, so
    the continuous engine refuses their models."""
    if cfg.is_encdec or cfg.frontend:
        raise NotImplementedError(
            "paged serving supports plain decoder-only models")
    for kind in cfg.block_pattern:
        if kind not in ATTENTION_KINDS:
            raise NotImplementedError(
                f"paged KV cache for block kind {kind!r}")
    dev = resolve(device)
    if kv_spec is None:
        kv_spec = cfg.kv_quant
    if kv_spec is not None:
        return [kvq.init_kv_pool(kv_spec, num_blocks, block_size,
                                 cfg.num_kv_heads, cfg.head_dim, device=dev)
                for _ in range(cfg.num_layers)]
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.num_layers)]


def forward_paged(params: Transformer, cfg: ModelConfig, tokens, pool,
                  positions, write_slots, view_slots):
    """One paged serving step — a prefill chunk (C > 1) or a decode batch
    (C == 1) through the same code.  tokens/positions/write_slots (B, C);
    view_slots (B, W).  Returns (logits (B, C, V), pool)."""
    x = embed_inputs(params, cfg, tokens)
    x, _ = _stack_apply(params.blocks, cfg, x, positions, mode="paged",
                        cache=pool, paged=(write_slots, view_slots))
    return logits_from_hidden(params, cfg, x), pool


def decode_step(params: Transformer, cfg: ModelConfig, token, cache, pos):
    """One decode step.  token (B,), pos (B,).  Returns (logits (B, V),
    cache).  An encoder-decoder config adds the learned positions of
    ``pos``: checked here when ``pos`` lies on the host; positions on the
    card are the caller's to check (``runtime.serve.static_cache`` does,
    once for a whole generation), so a step needs no sync."""
    x = embed_inputs(params, cfg, token[:, None])
    if cfg.is_encdec:
        if pos.device.type == "cpu" and not is_fake(pos):
            _check_positions(cfg, int(pos.max()))
        x = x + params.pos_embedding[pos.long()][:, None].to(x.dtype)
    x, _ = _stack_apply(params.blocks, cfg, x, pos[:, None], mode="decode",
                        cache=cache, pos=pos)
    return logits_from_hidden(params, cfg, x)[:, 0], cache
