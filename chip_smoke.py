#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as on the card
    python3 chip_smoke.py --profile  # also profile the engine on both
                                     # step routes (CUDA graph, eager):
                                     # msgemm weights with the f32 and the
                                     # kv8 pool, and int4 weights
    python3 chip_smoke.py --sweep    # only: build, then time every msGeMM
                                     # variant (rows per block) at the
                                     # engine's shapes, every flash tile
                                     # variant at the 8k prefill shapes,
                                     # every paged-attention chunk length
                                     # and int4 split count (--sweep
                                     # msgemm, attention or int4: one)

Phases, any failure exits non-zero before the last line is printed:

1. build   — compile every ``kernels/csrc/*.cu`` for sm_90a from the
   checkout, one ``nvcc`` per source, all started together, and print
   ``-Xptxas -v``'s registers, shared memory and spills.
2. kernels — each kernel against its plain PyTorch version on the card:
   * msGeMM at every gemma-2b GeMM shape (b = 1, 4, 8) and every gemma2-9b
     GeMM shape (b = 4) with each shape's own epilogue and the operands as
     the engine passes them (x and residual transposed views of the
     (b, .) activations, bfloat16 output), a vocab-sized (256000 x 2048)
     GeMM, and small d = 1, 2, 4 and learned-codebook cases with
     contiguous operands; the engine shapes and the vocab case once with
     f32 and once with bf16 x and residual (the engine's), each line
     with its tiles, kernel/matmul and PR 13's kernel/matmul;
   * the int4 GeMM at the same gemma shapes and layout, once with f32 and
     once with bf16 x and residual (the engine's), the vocab-sized GeMM
     with the identity epilogue (the legacy grid's counterpart) and small
     ragged cases with bias, relu/silu/gelu and a residual, each line with
     its tiles (contraction splits) and its time before the redesign
     (``OLD_INT4_MS``); the none/relu epilogues bit-exact on random
     floats too;
   * the int4 GeMM over an expert stack, one launch for all experts, at
     qwen2-moe's expert shapes (60 experts, 1408 x 2048 up and gate,
     2048 x 1408 down, b = 16 at decode and 4 at a prefill chunk) and
     llama4-maverick's (128 experts, 8192 x 5120, 5120 x 8192, b = 16),
     bf16 x as the dispatch passes it: bit-exact against the plain version
     (a per-expert loop of the one-linear plain version) on exact and on
     random inputs (silu within one bf16 ulp), timed against its bound
     (bytes, or the multiply-adds at the bf16 tensor-core rate) and
     ``torch.matmul`` of the dequantized f32 stack; jamba-v0.1's 16-expert
     stack too (14336 x 4096 up and gate, 4096 x 14336 down, b = 16: the
     static path's 4 rows x capacity 4);
   * both GeMMs, not timed, at every GeMM shape the other architectures'
     serve paths run (``arch_gemms``: qwen2-moe's, llama4-maverick's,
     codeqwen1.5-7b's, starcoder2-15b's and gpt3-175b's attention
     projections, dense and shared-expert MLPs, and untied vocab heads;
     jamba-v0.1's Mamba in/x/out projections (x_proj 288 x 8192 with f32
     x and out), MLP, attention and head; xlstm-1.3b's mLSTM up, o-gate
     and down projections, its sLSTM MLP (2730 x 2048, 2048 x 2730: a
     ragged last scale block) and head), bf16 x and residual in the
     engine's layout, the layers at b = 1, 4, 8, 15 and the heads at
     b = 1, 4, 8 (the recurrent models': static generate's b = 1, 4, 16,
     64 and 1, 4; whisper-medium's and phi-3-vision's attention
     projections, MLPs and heads at 1, 4, 64 and 1, 4);
   * both GeMMs at the enc-dec and vision prefill widths
     (``wide_case``): whisper's encoder and cross K/V GeMMs at b = 6000
     (4 x 1500 frames) and phi-3-vision's prefill GeMMs at b = 2368 (4 x
     592: 576 patches, 16 tokens), exact inputs against a float64
     product of the dequantized weight (bit-exact without an activation),
     random floats against the plain version on the first, a middle and
     the last column tile, timed against f32 and bf16 ``torch.matmul``
     on the dequantized weight;
   Both GeMMs: bit-exact on exact inputs (integer activations,
   power-of-two scales); rtol = atol = 1e-5 on random floats with f32
   output, one bf16 ulp (rtol = 2^-7) with bf16 output (kernel and plain
   version share one op order, so only gelu/silu's tanh/exp may differ).
   * paged attention over the quantized pool at gemma-2b decode
     (B=4, C=1) and prefill-chunk (B=1, C=8) shapes, each at kv8, kv4 and
     kv4 with a codebook, a long context (B=8, W=4096) at kv8 and kv4, a
     soft-capped windowed GQA case, gemma2-9b's served kv8 decode
     step, and head dim 128 at kv8: qwen2-moe's and codeqwen's decode
     (one query head a kv head), llama4's (5) and starcoder2's (12), and
     qwen2-moe's prefill chunk.  The kernel, its plain version and the
     torch backend (gather, dequantize, sdpa) agree within rtol = atol =
     2e-5 on f32 outputs, one bf16 ulp on bf16 outputs.
   Each case is timed: kernel, plain version, one PyTorch call as a
   yardstick (``torch.matmul`` on the dequantized weight; sdpa on the
   dequantized view) and the least time the card could take.
3. flash   — the flash-attention op (``kernels.ops.flash_attention``, the
   reference's public layout) at gemma-2b's and gemma2-9b's 8k prefill
   shapes (global and 4096-window local layers, soft-cap 50), a 32k
   sequence and a ragged windowed one, in bf16 and f32: the op's path is
   driven once with the launch counts at 0 (flash launches only), then
   each output is held against the plain version (f32 within 2e-5, bf16
   within one bf16 ulp) and kernel, plain version and sdpa are timed.
4. main    — full-width gemma-2b with random weights from a seed, quantized
   on the card (msgemm, d=3, scale_block=36), served by the continuous
   engine with the serve CLI's defaults (4 slots, block 8, prefill chunk 8)
   on 6 requests of 4-16 prompt tokens and 16 new tokens.  Every engine
   run here and in phase 5 takes the default route, each step shape a
   captured CUDA graph replayed, and its launch counts are the replays'
   (each replay adds the launches its capture recorded).  Every request
   must finish, match the static ``generate`` path token for token, and the
   msGeMM launch count must be exactly 126 (7 GeMMs x 18 layers) per step.
   The same stream then runs on the eager route (``cuda_graph=False``):
   the same tokens and steps, 126 launches a step.
   The same model and stream are then served with a quantized KV pool, kv8
   and kv4, each once through the paged-attention kernel (auto-selected)
   and once forced to the torch backend: every request finishes, the two
   routes give the same tokens, paged-attention launches are exactly 18
   per step on the kernel run and 0 on the torch run, msGeMM launches stay
   126 per step; the kv8 kernel run again on the eager route, with the
   same tokens.  Then gemma-2b is built again from seed 0 with int4
   weights (``int4_dequant``, the same codes and scales) and serves the
   stream: every request finishes and matches static ``generate``, int4
   launches are exactly 126 per step and msGeMM launches 0; then on the
   eager route, with the same tokens.
   Then the plan phase (``repro_torch.dispatch``, ``obs.perfmodel``), on
   the msgemm model and again on the int4 one, its plan cache and
   calibration in ``chiprun_out/``: an engine built with
   ``autotune=True`` times every candidate tile choice of the kernel at
   every GeMM key of both step shapes (decode b = 4, prefill chunk b = 8:
   8 keys a model), one line per key (the heuristic's tiles and device
   ms, the winner's, the candidates, whether the winner is the
   heuristic); every candidate of every key tuned is bit-exact against
   the plain version at the same tiles on exact inputs; the stream is
   served through the tuned plans on the graph and then the eager route
   (tokens == static generate under the same policy and cache, 126
   launches a step), with step ms and tokens/s beside phase 4's untuned
   run; a second engine from the reloaded cache, traced, times no
   candidate.  Then the slice's entry points, in process, at full-width
   gemma-2b msgemm with a fresh plan cache: ``python -m
   repro_torch.launch.serve --autotune --autotune-cache P --metrics-json
   M --check --check-regressions`` tunes the keys of both step shapes and
   of the static check, serves them (tokens == static generate) and skips
   the sentinel (no calibration yet); ``python -m repro_torch.obs
   --calibrate`` fits the perf model from both plan caches' timing rows
   and M's ``kernel_gemm_s`` series (the fitted constants and the fit's
   relative errors are printed); the calibration and M validate; the
   serve CLI again with ``--calibration`` times no candidate, gives the
   same tokens and passes the sentinel at 3x over its own series; ``python
   -m repro_torch.obs --check-regressions`` exits 0 on the training
   sources and 1 with the slowest timing row x100.  Every timing (the
   tuner's, phase 2's, the sweeps') is ``kernels.ops.time_call``: calls
   back to back over copies of the weights past the L2, behind a sleep
   (a window the host fell behind is timed again).  A failing sentinel
   echoes its ranked report to standard error.
   Then the calibration phase (``repro_torch.calib``, ``kvq.fit``): dense
   full-width gemma-2b from seed 0 is calibrated on the card at full
   depth to learned per-layer msgemm tables (``Recipe()``, 4 batches of
   4 x 128 tokens of the lcg ``SyntheticStream``); the stats and fit
   times, the aggregate uniform and learned weighted errors (the learned
   must be lower), the linears with learned <= uniform and the peak
   memory are printed.  The GPTQ and model-scope recipes run at full
   width on 1 layer (2 before the mesh phases' cut); the quality report
   (perplexity with the mean CE, logit MSE, top-1 agreement) covers the dense model, uniform msgemm from
   the same weights and the learned model; the learned K/V table and its
   reconstruction error against the uniform grid's are printed.  The
   learned model serves the stream on the graph route (tokens == static
   generate, 126 msGeMM launches a step, every linear on its own learned
   table), a learned int4 model at 1 layer serves it on ``int4_torch``
   (every plan, tokens == static generate, no kernel launched), and the
   serve CLI runs ``--kv-bits 4 --kv-codebook learned --check`` through
   ``paged_attn_cuda`` and ``paged_attn_torch`` (the direct fit's table,
   the same tokens, 18 attention launches a step on the kernel route).
   Every fault-free engine run of these phases and of phase 5 must use no
   rung of the resilience layer (``check_clean``: no shed, retry, NaN
   quarantine, replan or KV rebuild, no fault plan armed, no backend
   quarantined).  Then the resilience phase (``repro_torch.faults``, the
   engine's retry, NaN guard, replan ladder, watchdog, deadlines and
   shedding, ``repro_torch.checkpoint``), full-width gemma-2b msgemm on
   the graph route, the stream above, the reference chaos benchmark's
   schedules with seed 0: a clean run; ``latency``, ``oom``,
   ``step_fail`` and ``disconnect`` each alone (survivors == the clean
   run, retries == ``step_fail``'s fires, one ``disconnected`` request,
   126 msGeMM launches every replayed step); ``nan_logits`` (2
   quarantined requests, a replan that quarantines ``msgemm_cuda`` and
   captures both step shapes again on ``msgemm_torch``: 126 launches a
   step before it, 0 after; step ms before and after, both captures'
   times, survivors == clean reported); ``nan_logits`` again on that
   engine, down to ``dense_fallback``; on a fresh engine back on the
   kernel, ``hang`` under ``Watchdog(min_steps=3, min_timeout_s=0.5)``
   after a warm run (a hang, a replan, every request ok); the artifact
   classes on copies in ``chiprun_out/resilience/`` (the plan phase's
   cache and the fitted calibration quarantined on load and rebuilt; a
   checkpoint of full-width gemma-2b msgemm cut to 2 layers, step 2
   corrupted, step 1 restored bit for bit and served with the saved
   model's tokens); all six serving classes at once with
   ``max_queue=8``, ``deadline_s=30`` and the watchdog (every request
   terminal; SLO attainment, shed rate, retries, replans); and the serve
   CLI with ``--faults ... --watchdog --max-queue 64 --deadline-s 600
   --check``.  Every armed run disarms and clears the quarantine after.
5. gemma2-9b — full-width gemma2-9b (42 layers, d_model 3584, vocab
   256000) from seed 0 through the port's serve CLI
   (``repro_torch.launch.serve.main``, in process): msgemm weights with
   ``--check`` (294 msGeMM launches per step, no other kernel); the same
   model at ``--kv-bits 8`` through the paged-attention kernel (one
   launch a layer and step) and through the torch route (same tokens),
   that run
   writing ``--metrics-json`` and ``--trace-out`` (both kv8 runs cut to
   ``CUT_LAYERS`` = 8 layers, 8 attention and 56 msGeMM launches a step,
   for the mesh-training phases' time; both valid under the
   port's validators, the reference's series names, one ``gemm.*`` device
   event per GeMM and step from the graph replays); int4 weights with
   ``--check`` and one request of 4,440 prompt tokens, past the
   4096-token window, with int4 weights and ``--check``, and that one
   again with ``--no-cuda-graph``: the same tokens (these three cut to 8
   layers, 56 int4 launches a step, for the mesh-training phases' time).  (The msgemm and int4 runs' ``--no-cuda-graph`` twins were
   cut for the mesh phases' time: gemma-2b holds graph == eager.)
6. arch    — the other architectures at full width from seed 0 through
   the serve CLI (``repro_torch.launch.serve.main``, in process, the graph
   route, the 6-request stream): qwen2-moe-a2.7b cut to 8 of its 24
   layers with msgemm weights (57 msGeMM launches a step: 7 a layer and
   the untied vocab head; 24 int4 launches, one a layer and expert
   projection over its 60-expert stack; its ``dropped_frac``), then on the same weights
   the eager route (the same tokens) and a kv8 pool through the
   paged-attention kernel (24 launches a step, head dim 128; its eager
   twin was cut for the mesh phases' time) and through the torch route
   (its agreement with the kernel route reported: a top-k router turns
   the routes' last-bit differences into other experts); llama4-maverick
   cut to 2 layers (one dense, one MoE block: top-1 of 128 experts,
   qk-norm) the same way; codeqwen1.5-7b cut to 8 layers with msgemm
   and with int4 weights, starcoder2-15b cut to 8 layers (these cuts and
   qwen2-moe's pay for the mesh-training phases) and
   gpt3-175b cut to 2 layers with msgemm weights through the CLI (bf16
   activations; tokens
   == static generate up to static generate's first near-tie, a top-two
   gap of at most one bf16 ulp: an untied head's bf16 logits often tie
   at full width), then each on the same weights with f32 activations
   through the engine, tokens == static generate; codeqwen's f32 model
   also with a kv8 pool through the paged-attention kernel (32 launches
   a step at 8 layers, head dim 128) and through the torch route, the
   same tokens.  ``--profile`` adds both MoE models' step profile and the device ms a
   step of the vocab head and of the expert stacks (GeMM marks).
7. recurrent — jamba-v0.1-52b cut to 8 of its 32 layers (one period of
   its pattern: Mamba, attention and 16-expert MoE; the cut pays for the
   mesh-training phases) and xlstm-1.3b cut to 16 of its 48 layers (two
   periods of 7 mLSTM and an sLSTM; the cut pays for the mesh-serving
   phases) at full width from seed 0 through the serve CLI's static
   engine (batch 4,
   16-token prompts, 16 new tokens; the paged engine refuses recurrent
   models, as the reference's does): jamba and xlstm with msgemm weights,
   xlstm cut to 8 layers (one period) with int4 weights.  Each run:
   exactly its weight launches a step (jamba at 32 layers: 149 msGeMM
   and 48 int4; at 8: 38 and 12), 145 msGeMM (xlstm at 48 layers; 49
   at 16) or 25 int4 (xlstm int4 at 8 layers),
   times the 16 steps; weights GiB, build s, peak GiB, then static
   generate again on the CLI's prompts, timed (prefill ms, decode ms a
   step, tokens/s; the CLI's tokens); the teacher-forced check (static
   generate's step-by-step logits against one forward of the same
   tokens, a MoE model at a drop-free capacity: with f32 activations on
   the same weights within ``F32_STATE_TOL``; in bf16 the difference and
   the greedy tokens' agreement reported); where a
   decode step's device time goes (GeMM marks: experts, head, other
   weight GeMMs; torch.profiler: device busy ms, the weight kernels and
   the rest, the scans among it); jamba's ``dropped_frac``.
8. enc-dec — whisper-medium (24 encoder and 24 decoder layers, cross
   attention, learned decoder positions) at full depth and
   phi-3-vision-4.2b cut to 8 of its 32 layers (576 patch embeddings
   ahead of the text; the cut pays for the mesh-training phases) at full
   width from seed 0 through the serve CLI's static engine (batch 4,
   16-token prompts, 16 new tokens, the CLI's stub frames (16) or
   patches; the paged engine refuses both, as the reference's does):
   whisper with msgemm weights and, its decoder cut to 8 layers (a cut
   for the mesh-training phases), with int4 weights, phi-3 with msgemm
   weights; then whisper with msgemm weights at 1500 frames (its
   30-second window) through ``runtime.serve.generate``.  Each run:
   exactly 385 weight-kernel launches at a whisper prefill (encoder 24 x
   6, decoder 24 x 10, head) and 193 a decode step (225 and 65 with 8
   decoder layers), 7 a phi-3 layer and step and its head (57 at 8
   layers); weights GiB,
   build s, peak GiB; static generate again, timed (whisper's encoder
   alone, prefill ms, decode ms a step, tokens/s); the teacher-forced
   check (f32 within ``F32_STATE_TOL``, bf16 tokens up to the first
   near-tie); a decode step's device time by part (the profiler's
   kernel timeline: decoder GeMMs, cross attention, head, the rest).
9. train   — training (``repro_torch.optim``, ``runtime.train``,
   ``runtime.driver``, ``launch.train``): full-width, full-depth gemma-2b
   (18 layers, f32 params and moments, bf16 activations, remat on) from
   seed 0 takes 20 train steps of 8 x 128 tokens of the lcg
   ``SyntheticStream`` under the train CLI's config (AdamW,
   warmup_cosine(3e-3, 10, 20), clip 1.0): step ms (median of steps
   2-20), tokens/s, peak GiB, loss and grad_norm at steps 1 and 20; every
   loss finite, the last below the first, no hand-written kernel
   launched (the train path's products are plain f32 matmuls, as the
   reference's).  The optimizer state freed, the trained model's
   held-out CE, the lcg rule's share of 16 greedy tokens after lcg
   prompts and static generate's bf16 near-ties are reported, dense and
   after ``quantize_model`` to msgemm (d=3, scale_block=36) in place;
   the msgemm model serves the stream on the graph route (126 msGeMM
   launches a step, tokens == static generate) and with a kv8 pool
   through the paged-attention kernel (18 launches a step) and the
   torch route (the same tokens).  Then gemma-2b cut to 1 layer takes
   one step from the same weights and batch on the card and on the CPU:
   loss and grad_norm within 1e-4 relative with f32 activations (gated;
   the bf16 step was cut for the mesh phases' time).  Then
   ``runtime.driver.run`` at 1 layer (f32 activations), checkpoints under
   ``chiprun_out/train/``: a crash at step 3, a restart that resumes at
   the step-2 checkpoint with the uninterrupted losses (rtol 1e-5); and
   ``python -m repro_torch.launch.train --arch gemma_2b --smoke --steps
   12`` on its default device, the card.  The directory is removed
   after.  ``--only train`` runs the build and this phase alone.
10. mesh    — tensor-parallel serving (``dispatch.shard``, the
   training layout: column-parallel outputs kept sharded into their
   row-parallel consumer) and the calibration of expert stacks.
   ``[mesh-kernels ...]``: gemma-2b's 7 GeMMs at b = 4, msgemm and int4
   weights, under the model=2 and model=4 specs ``shard_spec_for``
   derives (d=3 / scale_block=36, the served spec: wq, wk, wv, gate, up
   column-parallel, wo and down whole; wo and down row-parallel at d=2 /
   scale_block=32, also at ``pipeline_chunks = 2``), and the Mamba and
   mLSTM projections at their model=2 shard shapes (jamba's in_proj,
   x_proj, out_proj, xlstm's xl_up, xl_o, xl_down; the row-parallel ones
   at d=2 / scale_block=32): every rank's local kernel call against its
   plain version, the combined output within 1e-5 of max |y| of the
   unsharded kernel's, device ms of a local call beside the unsharded
   one; qwen2-moe's up and down expert stacks at E/2 = 30 (a rank's
   experts at model=2) through the int4 kernel against its plain
   version.  ``[mesh ...]``: two ranks on ``cuda:0``
   (``launch.mesh.run_ranks``, gloo, host-staged collectives) each
   holding its shards of full-width gemma-2b msgemm, serving the main
   phase's stream eagerly on a model=2 mesh: tokens == the main phase's
   (a differing step must be a single-device near-tie, top two within
   1e-4 relative; counted), 126 msGeMM launches a step on each rank, the
   collectives a step by kind, each rank's step ms and peak GiB.
   ``[mesh-tune ...]``: the shard-variant tuner, two ranks sharing
   ``cuda:0`` on model=2, full-width gemma-2b at 1 layer with msgemm at
   d=2 / scale_block=32 (so wo and down are row-parallel), an engine
   with ``shard_pipeline=0`` and the kernel tiles untuned: every tuned
   key (wo's and down's at the decode and prefill rows) with its
   variants' seconds, hops, bytes and winner; both ranks hold the same
   winners and plans, the tokens equal the single device's on the same
   weights but at a near-tie, each rank's msGeMM launches what the
   winners imply, a rebuild from the cache times no candidate; then
   ``python -m repro_torch.obs --calibrate`` on that cache (in process,
   beside a few tuned kernel keys) fits the collective term, and a
   build with it and ``autotune="model"`` times at most 3 variants a
   key.  ``[mesh-fsdp ...]``: FSDP weight storage, two ranks sharing
   ``cuda:0`` on data=2, the same model under the 'default' rules and
   then 'serve': tokens equal the single device's, launches equal the
   'serve' run's, each cut leaf half its 'serve' bytes; each rank's
   resident weight bytes under both, the gathers a step by kind and
   bytes, step ms and peak GiB; whisper's static engine (2 + 2 layers,
   16 frames, batch 4, f32) under 'default', its logits within the
   ``[mesh-static ...]`` gate of one device's.
   ``[mesh-moe ...]``: full-width qwen2-moe at 2 layers through the
   paged engine on two ranks sharing ``cuda:0`` (expert-parallel: 30
   experts a rank, one int4 launch a projection a rank): tokens == the
   single-device engine's on the same weights but at a near-tie (as
   ``[mesh ...]``), every rank's ``dropped_frac`` equal to the single
   device's.  ``[mesh-fsdp qwen2-moe ...]`` (under ``--only mesh``
   only, moved there to pay for ``[mesh-seq ...]``): the same model
   under the 'default' rules on data=2 and (data=2, model=2), its expert
   stacks held cut over 'data' and the tokens moved to them.
   ``[mesh-static ...]``: the static engine on a model=2 mesh, two
   ranks sharing ``cuda:0``: full-width gemma-2b (its decode cache split
   over the sequence), jamba (8 layers: one period of its pattern, each
   block kind), xlstm (8: its mLSTM and sLSTM), whisper (16 frames) and
   phi-3-vision at 2
   layers, and gemma-2b with two kv heads (no split: the split's
   control), msgemm weights, f32 activations, against the single-device
   static ``generate``: every step's logits within 1e-3 (the static
   path's gate) and within 1e-5 of the largest |logit|, tokens equal
   but at a near-tie, each rank's weight launches the single device's;
   the split softmax alone against one device's within 1e-5 of |v|.
   ``[mesh-nccl ...]``: the same engine with its two ranks on ``cuda:0``
   and ``cuda:1``, joined by NCCL, when two cards are visible (skipped
   on one card, as the script runs with no arguments).
   ``[calib-moe ...]``: qwen2-moe at full width and 2 layers calibrated
   (learned aggregate error <= uniform, a (60, 16) table an expert
   stack), served (its learned expert stacks on ``int4_torch``), the
   experts' device ms a step.  ``[train-mesh ...]``: training on a mesh
   (FSDP x TP): full-width gemma-2b cut to 1 layer (f32, remat, AdamW,
   the train phase's 8 x 128 lcg tokens) from four ranks sharing
   ``cuda:0`` over host-staged gloo on (data=2, model=2), 1 step, a
   checkpoint of whole leaves, 1 more: each step's loss and grad_norm
   within 1e-4 of the same steps on the card alone, every rank's the
   same, no hand-written kernel launched; one forward and backward with
   the int8 FSDP gather (loss within 1e-3 of the f32 gather's), one step
   with ``int8_pod`` on (pod=2, data=1, model=2) (its loss the f32
   step's, its grad_norm within 1e-3 of the card alone's, its residual
   nonzero); the checkpoint restored onto one device here, whose
   next step equals the mesh's within 1e-4; the residual's positions
   split over 'model' between blocks (each step's ``seq_in_gather`` and
   ``seq_out_scatter`` counted); each rank's step ms, tokens/s and peak
   GiB, the collectives a step by kind, bytes and seconds.  ``[mesh-seq ...]``: sequence-parallel attention where the
   query heads cannot take 'model', full-width gemma-2b (8 heads) on
   model=3 from three ranks sharing ``cuda:0``: ``[mesh-seq serve]`` the
   static ``generate`` at 2 layers, msgemm weights, f32, 2 x 6,144
   prompt tokens (2,048 query positions a rank) and 16 new, against one
   device's on the same weights (the static path's gate; tokens equal
   but at a near-tie; each rank's msGeMM launches one device's; each
   layer's prefill gathers its block's K and V, and its MLP its block of
   the residual, which splits too), each rank's prefill ms and peak GiB
   beside one device's;
   ``[mesh-seq train]`` two steps at 1 layer, f32, no remat, 8 x 132
   lcg tokens on (data=1, model=3): losses and grad norms within 1e-4 of
   the card alone, every rank's alike, no hand-written kernel, the
   collectives a step by kind and bytes.  ``--only mesh-seq`` runs the build and this phase
   alone.  ``[train-mesh-families ...]`` (under ``--only mesh``
   only since the layout-tuner and FSDP-serving phases, which it pays
   for): every family trains on
   that mesh, full width, one step each, all in one spawn of the four
   ranks: qwen2-moe at 1 layer (expert-parallel, 30 experts a rank),
   jamba at 1 (its Mamba block on each rank's channels), xlstm-1.3b at 8
   (7 mLSTM on each rank's heads, the sLSTM whole), whisper-medium at 2
   + 2 over 1500 stub frames (the encoder and the cross attention on
   each rank's heads), phi-3-vision at 2 with 576 patches: loss,
   grad_norm, load_balance and dropped_frac within 1e-4 of one step on
   the card alone, every rank's alike, no hand-written kernel launched;
   step ms, peak GiB a rank, the collectives by kind and bytes.
   ``[train-mesh-nccl ...]``: the same mesh at full depth
   (18 layers), one rank a card over NCCL, 3 steps, held to the card
   alone within 1e-4, where four cards are visible.  ``[dryrun ...]``
   (under ``--only mesh`` only, after the mesh phases, with no other
   phase running; a whole run leaves it out since the every-family
   mesh-training phase): ``python -m repro_torch.launch.dryrun --arch
   gemma_2b --shape train_4k`` on the 256- and the 512-device
   production mesh, and
   ``--shape prefill_32k`` and ``decode_32k`` (msgemm weights, the
   'default' rules: FSDP weight storage) on the 256-device one, the four cells side by side on the host
   (fake process group, fake tensors): each ``ok``, arguments and peak
   GiB a device, the collectives by kind.  ``--only mesh`` runs the
   build and this phase alone (with the main phase's reference run
   first), then the dry run.
11. report — the seconds of every phase (each phase also prints a
   ``[phase] <name> <s>`` line when it ends), the card's name and power
   limit, then a ``kernels`` JSON line.

The last line is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Needs no network; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=1e-5)  # one bf16 ulp
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kvq.py's, two routes
# the depth cut (widths stay the config's) that pays for the mesh-training
# phases: jamba's and phi-3's static runs, qwen2-moe's, codeqwen's and
# starcoder2's engine runs, xlstm's int4 run, gemma2-9b's two kv8 runs
CUT_LAYERS = 8


def cut(cfg, extra):
    """``cfg`` at the depth ``--num-layers`` of ``extra`` asks for."""
    extra = list(extra)
    if "--num-layers" in extra:
        return cfg.replace(
            num_layers=int(extra[extra.index("--num-layers") + 1]))
    return cfg


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card():
    """The H100 SXM row of ``repro_torch.obs.costs`` (HBM bytes/s, f32
    ops/s outside the tensor cores, bf16 tensor-core FLOP/s): the one
    source of the kernels' bounds and of the perf model's roofline."""
    from repro_torch.obs import costs

    return costs.DEVICES["cuda"]


# ----------------------------------------------------------------- timing
def device_ms(fns, reps: int) -> float:
    """Device ms per call, cycling over ``fns``: ``kernels.ops.time_call``,
    the autotuner's timer (calls back to back behind a sleep, so the
    events bracket the kernels, not host gaps)."""
    import torch

    from repro_torch.kernels import ops

    return ops.time_call(fns, torch.device("cuda"), reps) * 1e3


def wall_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# ----------------------------------------------------------------- phase 2
def work(m, k, b, d, sb, has_bias, has_res, out_bytes, x_bytes=4):
    """(bytes, ops, mma_ops) the function needs: each input read once (x
    and the residual at ``x_bytes`` an element, the type the kernel
    reads), the output written once.  The product at the least time any
    algorithm takes for it: with bf16 x (2 bytes), as ``int4_work`` prices
    it, one multiply-add per (weight, column) on the bf16 tensor cores
    (an int4 value times a bf16 value is exact there) and one lookup and
    scale per weight at the f32 rate; with f32 x, at the f32 rate, the
    fewer of the LUT algorithm's operations (per chunk and column the
    LUT's 16·d distinct products and one add per entry of each length
    2..d (entries that share a prefix share its sum), one gather-add per
    (row, chunk, column), one multiply-add per (row, scale block,
    column)) and the dequantized product's (one lookup and scale per
    weight, one multiply-add per (weight, column)).  The epilogue's adds
    at the f32 rate in every case."""
    kc, nsb = -(-k // d), -(-k // sb)
    nbytes = (m * kc * 4 + m * nsb * 4 + k * b * x_bytes + 16 * 4
              + m * b * out_bytes + (m * 4 if has_bias else 0)
              + (m * b * x_bytes if has_res else 0))
    epilogue = m * b * (int(has_bias) + int(has_res))
    fma = 2 * m * k * b
    if x_bytes == 2:
        return nbytes, m * k + epilogue, fma
    produce = 16 * d + sum(16**i for i in range(2, d + 1))
    lut = produce * kc * b + m * kc * b + 2 * m * nsb * b
    return nbytes, min(lut, m * k + fma) + epilogue, 0


def with_bound(result, nbytes, nops, mma_ops=0):
    """Add the least time the card could take: bytes over the HBM rate or
    operations over their peak rate, whichever is larger: ``nops`` at the
    f32 rate outside the tensor cores, ``mma_ops`` (multiply-adds that the
    bf16 tensor cores do exactly, with f32 accumulation) at their rate."""
    dev = card()
    t_bytes = nbytes / dev.mem_bw * 1e3
    t_ops = (nops / dev.vector_flops + mma_ops / dev.matmul_flops) * 1e3
    result.update(bytes=nbytes, ops=nops, mma_ops=mma_ops,
                  bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
    return result


def gemm_case(result, g, weight, kernel, plain, dense, *, m, k, b, nsb,
              act, bias, residual, out_dtype, engine_layout,
              x_dtype=None, timed=True, **kw):
    """Check ``kernel(weight, x, scales, **kw)`` against ``plain`` on exact
    inputs (integer x, power-of-two scales: bit-exact unless gelu/silu)
    and on random floats (within one ulp of the output type: the two share
    one op order), then time it: kernel with its weight cycled past the
    L2, plain version, and one ``torch.matmul`` on ``dense(weight,
    scales)``, the dequantized f32 weight.  ``engine_layout``: x (k, b)
    and the residual (m, b) are transposed views of (b, k) and (b, m)
    buffers, as the dispatch backends pass the model's activations.
    ``x_dtype``: the type of x and the residual (float32 when None).
    ``timed=False``: the two checks only."""
    import torch

    from repro_torch.kernels import ops

    name = result["name"]
    tol = FLOAT_TOL if out_dtype == torch.float32 else BF16_TOL
    x_dtype = x_dtype or torch.float32

    def cols(rows, draw):
        """A (rows, b) operand, in the engine's layout when asked."""
        return (draw(b, rows).to(x_dtype).t() if engine_layout
                else draw(rows, b).to(x_dtype))

    for exact in (True, False):
        if exact:
            sc = 2.0 ** torch.randint(-2, 3, (m, nsb), generator=g,
                                      device="cuda").float()
            rnd = lambda *s: torch.randint(  # noqa: E731
                -4, 5, s, generator=g, device="cuda").float()
        else:
            sc = torch.rand((m, nsb), generator=g, device="cuda") + 0.1
            rnd = lambda *s: torch.randn(  # noqa: E731
                s, generator=g, device="cuda")
        x = cols(k, rnd)
        kw.update(act=act, bias=rnd(m) if bias else None,
                  residual=cols(m, rnd) if residual else None,
                  out_dtype=out_dtype)
        got = kernel(weight, x, sc, **kw)
        torch.cuda.synchronize()
        want = plain(weight, x, sc, **kw)
        err = float((got.float() - want.float()).abs().max())
        if exact and act in ("none", "relu"):
            check(err == 0.0, f"{name}: kernel != plain on exact inputs "
                              f"(max abs err {err})")
        else:
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda s: f"{name}: {s}")
        result["exact_max_abs_err" if exact else "max_abs_err"] = err
    if not timed:
        return result
    # timing, on the random-float inputs
    wbytes = weight.numel() * weight.element_size()
    copies = ops.copies_past_l2(wbytes)
    weights = [weight] + [weight.clone() for _ in range(copies - 1)]
    result["weight_cycled_bytes"] = copies * wbytes
    result["weight_l2_resident"] = copies * wbytes <= ops.L2_BYTES
    calls = [lambda w=w: kernel(w, x, sc, **kw) for w in weights]
    result["ms"] = device_ms(calls, reps=max(20, 2 * copies))
    result["host_ms"] = wall_ms(calls[0], reps=20)
    del weights, calls
    result["plain_ms"] = wall_ms(lambda: plain(weight, x, sc, **kw), reps=2)
    w = dense(weight, sc)
    wcopies = ops.copies_past_l2(w.numel() * 4, cap=8)
    ws = [w] + [w.clone() for _ in range(wcopies - 1)]
    xf = x.float()  # the yardstick multiplies in f32, as PR 13's did
    result["library_ms"] = device_ms(
        [lambda w_=w_: torch.matmul(w_, xf) for w_ in ws], reps=20)
    return result


def kernel_case(name, m, k, b, *, d=3, sb=36, act="none", bias=False,
                residual=False, codebook=False, out_dtype=None,
                engine_layout=False, x_dtype=None, seed=0, timed=True):
    """One msGeMM kernel-vs-plain case (see :func:`gemm_case`)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels import msgemm as ms
    from repro_torch.kernels import ops

    out_dtype = out_dtype or torch.float32
    x_dtype = x_dtype or torch.float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    kc, nsb = -(-k // d), -(-k // sb)
    codes = torch.randint(0, 16, (m, k), generator=g, device="cuda",
                          dtype=torch.uint8)
    idx = packing.pack_indices(codes, d).contiguous()
    if codebook:
        values = torch.cat([torch.zeros(1, device="cuda"), torch.sort(
            torch.rand(15, generator=g, device="cuda") * 14 - 7).values])
    else:
        values = packing.b_values(torch.float32, "cuda")
    tiles = ops.msgemm_tiles(m, kc, b, d, sb)
    result = dict(name=name, m=m, k=k, b=b, d=d, scale_block=sb, act=act,
                  bias=bias, residual=residual, codebook=codebook,
                  out_dtype=str(out_dtype).removeprefix("torch."),
                  engine_layout=engine_layout,
                  x_dtype=str(x_dtype).removeprefix("torch."),
                  tiles=tiles._asdict())
    gemm_case(
        result, g, idx,
        lambda i, x, sc, **kw: ms.msgemm_cuda(i, x, sc, values, **kw),
        lambda i, x, sc, **kw: ms.msgemm_plain(i, x, sc, values, **kw),
        lambda i, sc: (values[codes.long()]
                       * torch.repeat_interleave(sc, sb, 1)[:, :k]),
        m=m, k=k, b=b, nsb=nsb, act=act, bias=bias, residual=residual,
        out_dtype=out_dtype, engine_layout=engine_layout, x_dtype=x_dtype,
        timed=timed, d=d, scale_block=sb, tiles=tiles)
    return with_bound(result, *work(
        m, k, b, d, sb, bias, residual,
        torch.empty((), dtype=out_dtype).element_size(),
        torch.empty((), dtype=x_dtype).element_size()))


GEMMA_GEMMS = [  # (name, m, k, epilogue kwargs) of one gemma-2b block
    ("wq", 2048, 2048, {}),
    ("wk", 256, 2048, {}),
    ("wv", 256, 2048, {}),
    ("wo", 2048, 2048, dict(residual=True)),
    ("gate", 16384, 2048, dict(act="gelu")),
    ("up", 16384, 2048, {}),
    ("down", 2048, 16384, dict(residual=True)),
]
GEMMA2_GEMMS = [  # the same for one gemma2-9b block (wv as wk)
    ("g2-wq", 4096, 3584, {}),
    ("g2-wk", 2048, 3584, {}),
    ("g2-wo", 3584, 4096, dict(residual=True)),
    ("g2-gate", 14336, 3584, dict(act="gelu")),
    ("g2-up", 14336, 3584, {}),
    ("g2-down", 3584, 14336, dict(residual=True)),
]


# kernel/matmul of the msGeMM kernel before its redesign, per (case, b):
# PR 13's final chip_smoke.py call, NVIDIA H100 80GB HBM3, 700.00 W
# (f32 x and residual, the matmul yardstick on the dequantized f32 weight)
PR13_RATIO = {
    ("wq", 1): 3.92, ("wk", 1): 5.24, ("wo", 1): 3.92, ("gate", 1): 4.43,
    ("up", 1): 4.04, ("down", 1): 4.02,
    ("wq", 4): 3.38, ("wk", 4): 5.09, ("wo", 4): 3.37, ("gate", 4): 3.01,
    ("up", 4): 2.98, ("down", 4): 2.93,
    ("wq", 8): 6.03, ("wk", 8): 7.97, ("wo", 8): 5.89, ("gate", 8): 5.80,
    ("up", 8): 5.85, ("down", 8): 5.89,
    ("vocab", 8): 3.40, ("small-d1", 4): 1.25, ("small-d2", 5): 1.55,
    ("small-d4", 4): 42.75, ("small-d4-b1", 1): 27.48,
    ("codebook-bf16", 3): 3.47,
    ("g2-wq", 4): 2.69, ("g2-wk", 4): 2.65, ("g2-wo", 4): 2.75,
    ("g2-gate", 4): 3.94, ("g2-up", 4): 3.94, ("g2-down", 4): 3.84,
}


def engine_specs(gemms, widths, x_dtype=None):
    """(name, m, k, b, kwargs) of ``gemms`` at each batch width, as the
    engine runs them: x and residual transposed views, bf16 out; x and
    the residual in ``x_dtype`` (float32 when None; the engine's are
    bfloat16); a GeMM's own kwargs (Mamba's f32 x_proj) take precedence."""
    import torch

    xd = {} if x_dtype is None else dict(x_dtype=x_dtype)
    return [(n, m, k, b, dict(dict(out_dtype=torch.bfloat16,
                                   engine_layout=True, **xd), **e))
            for b in widths for n, m, k, e in gemms if n != "wv"]


def tiles_str(t):
    return f"tb={t['tb']} rows={t['rows']} stage={t['stage']} tj={t['tj']}"


def phase_kernels():
    import torch

    bf16 = torch.bfloat16
    cases = []
    specs = engine_specs(GEMMA_GEMMS, (1, 4, 8)) + [
        ("vocab", 256000, 2048, 8, {}),
        ("small-d1", 512, 1000, 4, dict(d=1, sb=12, bias=True, act="relu")),
        ("small-d2", 512, 1000, 5, dict(d=2, sb=24, act="silu",
                                        residual=True)),
        ("small-d4", 512, 1000, 4, dict(d=4, sb=48, bias=True)),
        ("small-d4-b1", 100, 300, 1, dict(d=4, sb=48)),
        ("codebook-bf16", 1000, 777, 3,
         dict(codebook=True, act="gelu", bias=True, residual=True,
              out_dtype=torch.bfloat16)),
    ] + engine_specs(GEMMA2_GEMMS, (4,)) + (
        engine_specs(GEMMA_GEMMS, (1, 4, 8), bf16)
        + [("vocab", 256000, 2048, 8, dict(x_dtype=bf16))]
        + engine_specs(GEMMA2_GEMMS, (4,), bf16))
    for i, (name, m, k, b, ep) in enumerate(specs):
        t0 = time.perf_counter()
        r = kernel_case(name, m, k, b, seed=i, **ep)
        r["ratio"] = r["ms"] / r["library_ms"]
        r["pr13_ratio"] = PR13_RATIO.get((name, b))
        cases.append(r)
        print(f"[kernels] {name:14s} m={m:6d} k={k:5d} b={b} d={r['d']} "
              f"x={r['x_dtype']:8s} act={r['act']:4s} "
              f"kernel={r['ms']:.4f}ms host={r['host_ms']:.4f}ms "
              f"plain={r['plain_ms']:.2f}ms matmul={r['library_ms']:.4f}ms "
              f"kernel/matmul={r['ratio']:.2f} (PR 13: {r['pr13_ratio']}) "
              f"bound={r['bound_ms']:.4f}ms ({r['bound_by']}) "
              f"err={r['max_abs_err']:.3g} "
              f"exact_err={r['exact_max_abs_err']:.3g} "
              f"[{tiles_str(r['tiles'])}] "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    f32 = [c for c in cases if c["x_dtype"] == "float32"
           and c["pr13_ratio"] is not None]
    below = [c for c in f32 if c["ratio"] < c["pr13_ratio"]]
    print(f"[kernels] kernel/matmul below PR 13's at {len(below)} of "
          f"{len(f32)} f32 cases", flush=True)
    return cases


def phase_sweep():
    """Time every msGeMM variant the autotuner weighs
    (``ops.msgemm_variants``: rows per block, the best splits of each) at
    the engine's shapes, with bf16 x as the engine passes it; each
    variant's output is checked bit for bit against the plain version at
    the same tiles on exact inputs first.  Returns the rows of
    chiprun_out/sweep.json."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels import msgemm as ms
    from repro_torch.kernels import ops

    bf16 = torch.bfloat16
    values = packing.b_values(torch.float32, "cuda")
    specs = ([(n, m, k, b) for n, m, k, b, _ in
              engine_specs(GEMMA_GEMMS, (1, 4, 8))
              + engine_specs(GEMMA2_GEMMS, (4,))]
             + [("vocab", 256000, 2048, 8)])
    rows_of = []
    for name, m, k, b in specs:
        d, sb = 3, 36
        kc, nsb = -(-k // d), -(-k // sb)
        g = torch.Generator(device="cuda").manual_seed(m + k + b)
        codes = torch.randint(0, 16, (m, k), generator=g, device="cuda",
                              dtype=torch.uint8)
        idx = packing.pack_indices(codes, d).contiguous()
        del codes
        x = torch.randint(-4, 5, (b, k), generator=g, device="cuda") \
            .to(bf16).t()
        sc = 2.0 ** torch.randint(-2, 3, (m, nsb), generator=g,
                                  device="cuda").float()
        kw = dict(d=d, scale_block=sb, out_dtype=bf16)
        wbytes = idx.numel() * 4
        copies = ops.copies_past_l2(wbytes)
        idxs = [idx] + [idx.clone() for _ in range(copies - 1)]
        picked = ops.msgemm_tiles(m, kc, b, d, sb)
        line = []
        for t in ops.msgemm_variants(m, kc, b, d, sb):
            got = ms.msgemm_cuda(idx, x, sc, values, tiles=t, **kw)
            want = ms.msgemm_plain(idx, x, sc, values, tiles=t, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"sweep {name} b={b} {t}: kernel != plain")
            t_ms = device_ms([lambda i=i: ms.msgemm_cuda(
                i, x, sc, values, tiles=t, **kw) for i in idxs],
                reps=max(20, 2 * copies))
            rows_of.append(dict(name=name, m=m, k=k, b=b,
                                tiles=t._asdict(), ms=t_ms,
                                picked=t == picked))
            line.append(f"{t.rows}/{t.tj}:{t_ms:.4f}"
                        + ("*" if t == picked else ""))
        print(f"[sweep] {name:8s} b={b} (rows/tj:ms) " + " ".join(line),
              flush=True)
        del idxs, idx
    return rows_of


FLASH_SWEEP = ("gemma-2b-prefill-8k", "gemma2-9b-local-8k")
ATTN_SWEEP = ("decode-kv8", "prefill-kv8", "long-kv8", "long-kv4",
              "gemma2-9b-decode-kv8", "gemma2-9b-long-kv8")
ATTN_CHUNKS = (32, 64, 128, 256)


def phase_sweep_attention():
    """Time every compiled bf16 flash variant at head-dim class 256
    (tiles, warps, ring depth) at the 8k prefill shapes, and the
    paged-attention kernel at each chunk length (rows a block as the
    wrapper picks them) and at each other rows-a-block count at the
    default chunk, at the engine's and the long-view shapes; each variant
    is checked against the plain version at the same tiles or chunk first
    (one bf16 ulp; 2e-5 for f32 q)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    rows_of = []
    g = torch.Generator(device="cuda").manual_seed(301)
    for name, H, hk, S, window, softcap in FLASH_CASES:
        if name not in FLASH_SWEEP:
            continue
        q, k, v = (torch.randn((1, h, S, 256), generator=g, device="cuda")
                   .to(torch.bfloat16) for h in (H, hk, hk))
        kw = dict(causal=True, window=window, softcap=softcap)
        nops = 4 * 256 * H * visible_pairs(S, S, window)
        line = []
        for dt, dc, tq, tk, st in fa.MMA_VARIANTS:
            if dt != torch.bfloat16 or dc != 256:
                continue
            tiles = dict(tq=tq, tk=tk)
            got = fa.flash_attention_cuda(q, k, v, stages=st, **tiles, **kw)
            want = fa.flash_attention_plain(q, k, v, **tiles, **kw)
            torch.testing.assert_close(
                got.float(), want.float(), **BF16_TOL,
                msg=lambda m: f"[sweep] flash {name} {tq}/{tk}/{st}: {m}")
            del got, want
            ms = device_ms([lambda: fa.flash_attention_cuda(
                q, k, v, stages=st, **tiles, **kw)], reps=10)
            picked = (tq, tk, st) == fa.MMA_TILES[256]
            rows_of.append(dict(kernel="flash_attention", name=name, tq=tq,
                                tk=tk, stages=st, ms=ms,
                                tflops=nops / (ms * 1e-3) / 1e12,
                                picked=picked))
            line.append(f"{tq}/{tk}/{st}:{ms:.3f}" + ("*" if picked else ""))
        print(f"[sweep] flash {name} (tq/tk/stages:ms) " + " ".join(line),
              flush=True)
        del q, k, v
    for i, (name, spec) in enumerate(attn_specs()):
        if name not in ATTN_SWEEP:
            continue
        a = attn_inputs(seed=400 + i, **spec)
        tol = ATTN_TOL if a["q"].dtype == torch.float32 else BF16_TOL
        args = (a["q"], *a["leaves"], a["tables"], a["positions"])
        pool_bytes = sum(t.numel() * t.element_size() for t in a["leaves"])
        copies = ops.copies_past_l2(pool_bytes)
        pools = [a["leaves"]] + [tuple(t.clone() for t in a["leaves"])
                                 for _ in range(copies - 1)]
        line = []
        rows = spec["C"] * spec["H"] // spec["hk"]
        dhp = a["leaves"][0].shape[3]
        auto = {}
        for chunk in ATTN_CHUNKS:
            nch = -(-spec["W"] // chunk)
            auto[chunk] = pa.rows_per_block(
                rows, nch * spec["hk"] * spec["B"])
        variants = [(chunk, None) for chunk in ATTN_CHUNKS] + [
            (pa.CHUNK, rb) for rb in (1, 2, 4, 8)
            if rb < 2 * rows and rb != auto[pa.CHUNK]]
        for chunk, rb in variants:
            if pa.smem_bytes(dhp, spec["bits"], chunk,
                             rb or auto[chunk]) > pa.MAX_SMEM:
                continue
            kw = dict(a["kw"], chunk=chunk)
            got = pa.paged_attention_cuda(*args, rows=rb, **kw)
            want = pa.paged_attention_plain(*args, **kw)
            torch.testing.assert_close(
                got.float(), want.float(), **tol,
                msg=lambda m: f"[sweep] attn {name} chunk {chunk}: {m}")
            ms = device_ms([lambda lv=lv: pa.paged_attention_cuda(
                a["q"], *lv, a["tables"], a["positions"], rows=rb, **kw)
                for lv in pools], reps=max(20, 2 * copies))
            picked = chunk == pa.CHUNK and rb is None
            rb = rb or auto[chunk]
            rows_of.append(dict(kernel="paged_attention", name=name,
                                chunk=chunk, rows_per_block=rb, ms=ms,
                                picked=picked))
            line.append(f"{chunk}/{rb}:{ms:.4f}" + ("*" if picked else ""))
        print(f"[sweep] attn {name} (chunk/rows a block:ms) " + " ".join(line),
              flush=True)
        del pools, a
    return rows_of


def int4_work(m, k, b, sb, has_bias, has_res, out_bytes, x_bytes=4):
    """(bytes, ops, mma_ops) the int4 GeMM needs: packed codes, scales, x
    and the residual (at ``x_bytes`` an element, the type the kernel
    reads) read once, the output written once; one scale multiply per
    weight and the epilogue's adds at the f32 rate; one multiply-add per
    (weight, column), on the bf16 tensor cores when x is 2 bytes (a 4-bit
    code times a bf16 value is exact there), else at the f32 rate."""
    nsb = -(-k // sb)
    nbytes = (m * -(-k // 2) + m * nsb * 4 + k * b * x_bytes
              + m * b * out_bytes + (m * 4 if has_bias else 0)
              + (m * b * x_bytes if has_res else 0))
    ops = m * k + m * b * (int(has_bias) + int(has_res))
    fma = 2 * m * k * b
    return (nbytes, ops, fma) if x_bytes == 2 else (nbytes, ops + fma, 0)


# Device ms of the int4 kernel before its redesign (32-row blocks walking
# all of k, the scale before every product), per (case, b), f32 x and
# residual: chip_smoke.py on commit 5c970e3, NVIDIA H100 80GB HBM3 at
# 700.00 W (quoted in PERF.md section 6)
OLD_INT4_MS = {
    ("wq", 1): 0.0142, ("wk", 1): 0.0137, ("wo", 1): 0.0142,
    ("gate", 1): 0.0298, ("up", 1): 0.0294, ("down", 1): 0.0895,
    ("wq", 4): 0.0214, ("wk", 4): 0.0207, ("wo", 4): 0.0215,
    ("gate", 4): 0.0503, ("up", 4): 0.0489, ("down", 4): 0.1322,
    ("wq", 8): 0.0330, ("wk", 8): 0.0317, ("wo", 8): 0.0332,
    ("gate", 8): 0.0823, ("up", 8): 0.0808, ("down", 8): 0.1994,
    ("vocab", 8): 1.1866, ("small-relu-bias", 4): 0.0141,
    ("small-silu-res", 3): 0.0098, ("small-gelu-bf16", 9): 0.0245,
    ("g2-wq", 4): 0.0342, ("g2-wk", 4): 0.0342, ("g2-wo", 4): 0.0376,
    ("g2-gate", 4): 0.0833, ("g2-up", 4): 0.0817, ("g2-down", 4): 0.1193,
}


def int4_case(name, m, k, b, *, sb=36, act="none", bias=False,
              residual=False, out_dtype=None, engine_layout=False,
              x_dtype=None, seed=0, timed=True):
    """One int4 kernel-vs-plain case (see :func:`gemm_case`); the
    none/relu epilogues bit-exact on random floats too."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import ops

    out_dtype = out_dtype or torch.float32
    x_dtype = x_dtype or torch.float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    nsb = -(-k // sb)
    codes = torch.randint(0, 16, (m, k), generator=g, device="cuda",
                          dtype=torch.uint8)
    u8 = packing.pack_storage(codes).contiguous()
    tiles = ops.int4_tiles(m, k, b)
    result = dict(name=name, m=m, k=k, b=b, scale_block=sb, act=act,
                  bias=bias, residual=residual,
                  out_dtype=str(out_dtype).removeprefix("torch."),
                  engine_layout=engine_layout,
                  x_dtype=str(x_dtype).removeprefix("torch."),
                  tiles=tiles._asdict(), old_ms=OLD_INT4_MS.get((name, b)))
    gemm_case(
        result, g, u8,
        lambda u, x, sc, **kw: i4.int4_matmul_cuda(u, sc, x, **kw),
        lambda u, x, sc, **kw: i4.int4_matmul_plain(u, sc, x, **kw),
        lambda u, sc: i4.dequantize(u, sc, k, sb),
        m=m, k=k, b=b, nsb=nsb, act=act, bias=bias, residual=residual,
        out_dtype=out_dtype, engine_layout=engine_layout, x_dtype=x_dtype,
        timed=timed, scale_block=sb, tiles=tiles)
    # kernel and plain version round every sum alike: none/relu bit-exact
    # on the random floats too
    check(act not in ("none", "relu") or result["max_abs_err"] == 0.0,
          f"{name}: kernel != plain on random inputs "
          f"(max abs err {result['max_abs_err']})")
    return with_bound(result, *int4_work(
        m, k, b, sb, bias, residual,
        torch.empty((), dtype=out_dtype).element_size(),
        torch.empty((), dtype=x_dtype).element_size()))


def int4_tiles_str(t):
    return f"tb={t['tb']} tk={t['tk']} nsplit={t['nsplit']}"


def phase_int4_kernels():
    import torch

    bf16 = torch.bfloat16
    specs = engine_specs(GEMMA_GEMMS, (1, 4, 8)) + [
        ("vocab", 256000, 2048, 8, {}),
        ("small-relu-bias", 512, 1000, 4, dict(sb=12, bias=True,
                                                act="relu")),
        ("small-silu-res", 100, 301, 3, dict(sb=36, act="silu",
                                             residual=True)),
        ("small-gelu-bf16", 1000, 777, 9,
         dict(sb=32, act="gelu", bias=True, residual=True,
              out_dtype=torch.bfloat16)),
    ] + engine_specs(GEMMA2_GEMMS, (4,)) + (
        engine_specs(GEMMA_GEMMS, (1, 4, 8), bf16)
        + engine_specs(GEMMA2_GEMMS, (4,), bf16))
    cases = []
    for i, (name, m, k, b, ep) in enumerate(specs):
        t0 = time.perf_counter()
        r = int4_case(name, m, k, b, seed=100 + i, **ep)
        cases.append(r)
        print(f"[int4] {name:15s} m={m:6d} k={k:5d} b={b} "
              f"x={r['x_dtype']:8s} act={r['act']:4s} "
              f"kernel={r['ms']:.4f}ms (before, f32 x: {r['old_ms']}) "
              f"host={r['host_ms']:.4f}ms "
              f"plain={r['plain_ms']:.2f}ms matmul={r['library_ms']:.4f}ms "
              f"bound={r['bound_ms']:.4f}ms ({r['bound_by']}) "
              f"err={r['max_abs_err']:.3g} "
              f"exact_err={r['exact_max_abs_err']:.3g} "
              f"[{int4_tiles_str(r['tiles'])}] "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    old = [c for c in cases if c["old_ms"] is not None]
    slower = [f"{c['name']} b={c['b']} x={c['x_dtype']}" for c in old
              if c["ms"] > c["old_ms"]]
    print(f"[int4] faster than before the redesign at "
          f"{len(old) - len(slower)} of "
          f"{len(old)} cases; slower: {slower or 'none'}", flush=True)
    return cases


def phase_sweep_int4():
    """Time the int4 kernel at each contraction split count the autotuner
    weighs (``ops.int4_variants``) at the engine's shapes, with bf16 x
    and residual as the engine passes them;
    each split count's output is checked bit for bit against the plain
    version on exact inputs first.  Returns the rows of
    chiprun_out/sweep.json."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import ops

    bf16 = torch.bfloat16
    rows_of = []
    for name, m, k, b, ep in (engine_specs(GEMMA_GEMMS, (1, 4, 8), bf16)
                              + engine_specs(GEMMA2_GEMMS, (4,), bf16)):
        sb = 36
        nsb = -(-k // sb)
        g = torch.Generator(device="cuda").manual_seed(m + k + b)
        codes = torch.randint(0, 16, (m, k), generator=g, device="cuda",
                              dtype=torch.uint8)
        u8 = packing.pack_storage(codes).contiguous()
        del codes
        x = torch.randint(-4, 5, (b, k), generator=g, device="cuda") \
            .to(bf16).t()
        res = (torch.randint(-4, 5, (b, m), generator=g, device="cuda")
               .to(bf16).t() if ep.get("residual") else None)
        sc = 2.0 ** torch.randint(-2, 3, (m, nsb), generator=g,
                                  device="cuda").float()
        kw = dict(scale_block=sb, act=ep.get("act", "none"), residual=res,
                  out_dtype=bf16)
        copies = ops.copies_past_l2(u8.numel())
        u8s = [u8] + [u8.clone() for _ in range(copies - 1)]
        picked = ops.int4_tiles(m, k, b)
        line = []
        for t in ops.int4_variants(m, k, b):
            got = i4.int4_matmul_cuda(u8, sc, x, tiles=t, **kw)
            want = i4.int4_matmul_plain(u8, sc, x, tiles=t, **kw)
            torch.cuda.synchronize()
            if kw["act"] == "none":
                check(torch.equal(got, want),
                      f"sweep int4 {name} b={b} {t}: kernel != plain")
            else:  # gelu: tanh's last ulps
                torch.testing.assert_close(
                    got.float(), want.float(), **BF16_TOL,
                    msg=lambda s: f"sweep int4 {name} b={b} {t}: {s}")
            t_ms = device_ms([lambda u=u: i4.int4_matmul_cuda(
                u, sc, x, tiles=t, **kw) for u in u8s],
                reps=max(20, 2 * copies))
            rows_of.append(dict(kernel="int4_matmul", name=name, m=m, k=k,
                                b=b, tiles=t._asdict(), ms=t_ms,
                                old_ms=OLD_INT4_MS.get((name, b)),
                                picked=t == picked))
            line.append(f"{t.nsplit}:{t_ms:.4f}"
                        + ("*" if t == picked else ""))
        print(f"[sweep] int4 {name:8s} b={b} (nsplit:ms; before "
              f"{OLD_INT4_MS.get((name, b))}) " + " ".join(line), flush=True)
        del u8s, u8
    return rows_of


def attn_work(positions, B, C, H, hk, dh, dhp, bs, nseq, window, q_bytes):
    """(bytes, ops) one paged-attention call needs for this run's
    positions: the codes and scales (k and v) of the view blocks that
    hold a position some query of the row may attend to (from the
    window's first to the largest query position), q, the output, the
    block tables and positions read or written once; per needed slot
    2·Dh multiply-adds per (query, head) for q·k and p·v, and one scale
    multiply per dequantized K/V element."""
    import torch

    hi = ((positions.clamp(min=0).amax(1) // bs) + 1).clamp(max=nseq)
    lo = ((positions.amin(1) - window + 1).clamp(min=0) // bs if window
          else torch.zeros_like(hi))
    slots = int((hi - lo).clamp(min=0).sum()) * bs
    nbytes = (2 * slots * hk * (dhp + 4) + 2 * B * C * H * dh * q_bytes
              + B * nseq * 4 + B * C * 4)
    ops = slots * (C * H * 4 * dh + 2 * hk * dh)
    return nbytes, ops


def attn_inputs(B, C, H, hk, dh, bs, W, *, bits, codebook=False,
                softcap=0.0, window=0, q_dtype=None, seed=0):
    """One quantized pool and its call: each row's last query in its
    view's last block, the block tables a random permutation."""
    import torch

    from repro_torch import kvq

    q_dtype = q_dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    nseq = W // bs
    nb = 1 + B * nseq
    cb = None
    if codebook:
        cb = tuple([0.0] + sorted(torch.randn(15, generator=g,
                                              device="cuda").tolist()))
    spec = kvq.KVQuantSpec(bits, codebook=cb)
    pool = {}
    for n in ("k", "v"):
        vals = torch.randn((nb, bs, hk, dh), generator=g, device="cuda")
        pool[n], pool[f"{n}_scale"] = kvq.kv_quantize(vals, spec)
    tables = (torch.randperm(nb - 1, generator=g, device="cuda") + 1) \
        .reshape(B, nseq).to(torch.int32)
    last = W - 1 - torch.randint(0, bs, (B, 1), generator=g, device="cuda")
    positions = (last - (C - 1) + torch.arange(C, device="cuda")) \
        .to(torch.int32)
    view_slots = (tables.long()[:, :, None] * bs
                  + torch.arange(bs, device="cuda")).reshape(B, W)
    q = torch.randn((B, C, H, dh), generator=g, device="cuda").to(q_dtype)
    kw = dict(bits=bits, block_size=bs, window=window, softcap=softcap,
              codebook=None if cb is None else torch.tensor(cb,
                                                            device="cuda"))
    leaves = (pool["k"], pool["k_scale"], pool["v"], pool["v_scale"])
    return dict(q=q, leaves=leaves, tables=tables, positions=positions,
                view_slots=view_slots, pool=pool, spec=spec, kw=kw, nb=nb,
                nseq=nseq)


def attn_case(name, B, C, H, hk, dh, bs, W, *, bits, codebook=False,
              softcap=0.0, window=0, q_dtype=None, seed=0):
    """One paged-attention case: the kernel, its plain version and the
    torch backend (kvq.attention.run_torch) on one quantized pool."""
    import torch

    from repro_torch import kvq
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kvq import attention as kv_attn
    from repro_torch.models import layers

    q_dtype = q_dtype or torch.bfloat16
    a = attn_inputs(B, C, H, hk, dh, bs, W, bits=bits, codebook=codebook,
                    softcap=softcap, window=window, q_dtype=q_dtype,
                    seed=seed)
    q, leaves, tables, positions = (a["q"], a["leaves"], a["tables"],
                                    a["positions"])
    view_slots, pool, spec, kw = (a["view_slots"], a["pool"], a["spec"],
                                  a["kw"])
    nb, nseq = a["nb"], a["nseq"]

    class Cfg:
        num_heads, num_kv_heads, head_dim = H, hk, dh
        attn_logit_softcap = softcap

    got = pa.paged_attention_cuda(q, *leaves, tables, positions, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q, *leaves, tables, positions, **kw)
    ref = kv_attn.run_torch(spec, Cfg, q, pool, view_slots, positions,
                            window=window).reshape(B, C, H, dh)
    tol = ATTN_TOL if q_dtype == torch.float32 else BF16_TOL
    for a, b_, what in ((got, want, "kernel vs plain"),
                        (got, ref, "kernel vs torch backend"),
                        (want, ref, "plain vs torch backend")):
        torch.testing.assert_close(a.float(), b_.float(), **tol,
                                   msg=lambda s: f"{name} {what}: {s}")
    result = dict(
        name=name, B=B, C=C, H=H, Hk=hk, Dh=dh, block_size=bs, W=W,
        bits=bits, codebook=codebook, softcap=softcap, window=window,
        q_dtype=str(q_dtype).removeprefix("torch."),
        max_abs_err=float((got.float() - want.float()).abs().max()),
        torch_backend_max_abs_err=float((got.float() - ref.float())
                                        .abs().max()))
    # timing: whole pools cycled past the L2, as a layer's pool would be
    # cold after the other 17 layers ran
    pool_bytes = sum(t.numel() * t.element_size() for t in leaves)
    copies = ops.copies_past_l2(pool_bytes)
    pools = [leaves] + [tuple(t.clone() for t in leaves)
                        for _ in range(copies - 1)]
    result["pool_cycled_bytes"] = copies * pool_bytes
    calls = [lambda lv=lv: pa.paged_attention_cuda(q, *lv, tables,
                                                   positions, **kw)
             for lv in pools]
    result["ms"] = device_ms(calls, reps=max(20, 2 * copies))
    result["host_ms"] = wall_ms(calls[0], reps=20)
    del pools, calls
    result["plain_ms"] = wall_ms(lambda: pa.paged_attention_plain(
        q, *leaves, tables, positions, **kw), reps=2)
    # yardstick: one sdpa on the already-dequantized f32 view (no softcap;
    # the query heads of a group folded into its kv head's query axis)
    g_ = H // hk
    dq = lambda c, s: kvq.kv_dequantize(  # noqa: E731
        c.view(nb * bs, hk, -1)[view_slots], s.view(nb * bs, hk)[view_slots],
        spec, dh).permute(0, 2, 1, 3).contiguous()  # (B, Hk, W, Dh)
    kf, vf = dq(pool["k"], pool["k_scale"]), dq(pool["v"], pool["v_scale"])
    qf = q.float().reshape(B, C, hk, g_, dh).permute(0, 2, 3, 1, 4) \
        .reshape(B, hk, g_ * C, dh)
    mask = layers.view_mask(W, positions, window=window)[:, None] \
        .repeat(1, 1, g_, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    result["library_ms"] = device_ms(
        [lambda: sdpa(qf, kf, vf, attn_mask=mask, scale=dh**-0.5)], reps=20)
    return with_bound(result, *attn_work(
        positions, B, C, H, hk, dh, spec.packed_dim(dh), bs, nseq, window,
        q.element_size()))


# Device ms of the paged-attention kernel before its redesign (one CUDA
# block per (row, kv head) walking the block table), NVIDIA H100 80GB
# HBM3 at 700.00 W: chip_smoke.py at commit 60ca82e (its PERF.md table);
# gemma2-9b-decode-kv8 at commit bdb566c (its PERF.md kernel table).
OLD_ATTN_MS = {
    "decode-kv8": 0.0336, "decode-kv4": 0.0358, "decode-kv4cb": 0.0357,
    "prefill-kv8": 0.0568, "prefill-kv4": 0.0589, "prefill-kv4cb": 0.0587,
    "long-kv8": 3.826, "long-kv4": 4.321,
    "gemma2-9b-softcap-window": 0.1237, "gemma2-9b-decode-kv8": 0.0194,
}


def attn_specs():
    """(name, attn_case kwargs) of every paged-attention case."""
    import torch

    gemma = dict(H=8, hk=1, dh=256, bs=8)
    kvs = [("kv8", dict(bits=8)), ("kv4", dict(bits=4)),
           ("kv4cb", dict(bits=4, codebook=True))]
    specs = [(f"decode-{n}", dict(gemma, B=4, C=1, W=32, **kv))
             for n, kv in kvs]
    specs += [(f"prefill-{n}", dict(gemma, B=1, C=8, W=32, **kv))
              for n, kv in kvs]
    specs += [(f"long-{n}", dict(gemma, B=8, C=1, W=4096, **kv))
              for n, kv in kvs[:2]]
    specs += [("gemma2-9b-softcap-window",
               dict(B=4, C=1, H=16, hk=8, dh=256, bs=8, W=256, bits=8,
                    softcap=50.0, window=64, q_dtype=torch.float32))]
    # gemma2-9b's served decode step at kv8 (window 4096, softcap 50)
    specs += [("gemma2-9b-decode-kv8",
               dict(B=4, C=1, H=16, hk=8, dh=256, bs=8, W=32, bits=8,
                    softcap=50.0, window=4096))]
    # and the same over a long view, where the split over chunks pays most
    specs += [("gemma2-9b-long-kv8",
               dict(B=4, C=1, H=16, hk=8, dh=256, bs=8, W=4096, bits=8,
                    softcap=50.0, window=4096))]
    # head dim 128, the arch phase's served kv8 steps: qwen2-moe and
    # codeqwen (one query head a kv head) at decode and a prefill chunk,
    # llama4-maverick (5) and starcoder2 (12) at decode
    for name, H, hk in (("qwen2-moe", 16, 16), ("codeqwen", 32, 32),
                        ("llama4", 40, 8), ("starcoder2", 48, 4)):
        specs += [(f"{name}-decode-kv8",
                   dict(B=4, C=1, H=H, hk=hk, dh=128, bs=8, W=32, bits=8))]
    specs += [("qwen2-moe-prefill-kv8",
               dict(B=1, C=8, H=16, hk=16, dh=128, bs=8, W=32, bits=8))]
    return specs


def phase_attn_kernels():
    specs = attn_specs()
    cases = []
    for i, (name, kw) in enumerate(specs):
        t0 = time.perf_counter()
        r = attn_case(name, seed=200 + i, **kw)
        r["old_ms"] = OLD_ATTN_MS.get(name)
        cases.append(r)
        old = "-" if r["old_ms"] is None else f"{r['old_ms']:.4f}ms"
        print(f"[attn] {name:26s} B={r['B']} C={r['C']} W={r['W']:5d} "
              f"kernel={r['ms']:.4f}ms (before the redesign: {old}) "
              f"host={r['host_ms']:.4f}ms "
              f"plain={r['plain_ms']:.2f}ms sdpa={r['library_ms']:.4f}ms "
              f"bound={r['bound_ms']:.5f}ms ({r['bound_by']}) "
              f"err={r['max_abs_err']:.3g} "
              f"vs_torch={r['torch_backend_max_abs_err']:.3g} "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    return cases


# ----------------------------------------------------------------- phase 3
NEW_TOKENS, PROMPT_LEN = 16, 16


def request_stream(cfg):
    """The 6-request stream every engine run of the main paths serves."""
    from repro_torch.serving import poisson_stream

    return poisson_stream(6, cfg.vocab_size, max_new_tokens=NEW_TOKENS,
                          rate=50.0, min_prompt=PROMPT_LEN // 4,
                          max_prompt=PROMPT_LEN, seed=0)


def make_engine(model, cfg, **engine_kw):
    """A continuous engine with the serve CLI's defaults."""
    from repro_torch.serving import Engine

    return Engine(model, cfg, max_slots=4, block_size=8, prefill_chunk=8,
                  max_model_len=PROMPT_LEN + NEW_TOKENS, **engine_kw)


def check_clean(tag, m):
    """A fault-free run took no rung of the degradation ladder: no shed,
    retry, NaN quarantine, replan or KV rebuild in its metrics ``m``, no
    fault plan armed, no backend quarantined.  A kernel that produced
    NaNs would otherwise pass a phase by being replanned away."""
    from repro_torch import dispatch, obs

    used = {k: m[k] for k in ("shed", "step_retries", "nan_quarantined",
                              "replans", "kv_rebuilds") if m[k]}
    check(not used, f"[{tag}] a fault-free run used the resilience "
                    f"layer: {used}")
    armed = obs.registry().gauge("faults_armed").value
    check(armed == 0, f"[{tag}] {armed} fault classes armed")
    check(not dispatch.quarantined(),
          f"[{tag}] backends quarantined: {dispatch.quarantined()}")


def serve(tag, model, cfg, keep_logits=False, **engine_kw):
    """Serve the request stream once through the continuous engine with
    the serve CLI's defaults.  Every kernel's launch count (and a MoE
    model's routed-slot counts, read into ``dropped_frac``) is set to 0
    just before the run and read just after it.  Checks that every
    request finished with all its tokens and that the run used no rung of
    the resilience layer (:func:`check_clean`).  ``keep_logits``: the
    run also returns each request's logits, one (V,) row a token."""
    import torch

    from repro_torch.launch.serve import KERNELS as counters
    from repro_torch.models import moe as M

    reqs = request_stream(cfg)
    engine = make_engine(model, cfg, **engine_kw)
    logits = {}
    if keep_logits:
        pick = engine._pick

        def keep(seq, tok, row):
            # a copy: row may be a graph's static output
            logits.setdefault(seq.req.rid, []).append(row.float().clone())
            return pick(seq, tok, row)

        engine._pick = keep
    route = "graph" if engine.runner.cuda_graph else "eager"
    check(route == ("eager" if engine_kw.get("cuda_graph") is False
                    else "graph"), f"[{tag}] engine took the {route} route")
    for mod in counters.values():
        mod.launches = 0
    M.reset_route_counts(model)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    dropped = M.dropped_frac(model)
    steps = engine.num_steps
    check(steps > 0, f"[{tag}] the engine took no step")
    check(launches["flash_attention"] == 0,
          f"[{tag}] the engine launched the flash kernel: {launches}")
    check(sorted(results) == list(range(len(reqs))),
          f"[{tag}] finished {sorted(results)} of {len(reqs)} requests")
    for rid, seq in sorted(results.items()):
        check(seq.status == "ok" and len(seq.generated) == NEW_TOKENS,
              f"[{tag}] request {rid}: status {seq.status}, "
              f"{len(seq.generated)} tokens")
    s = engine.metrics()
    check_clean(tag, s)
    print(f"[{tag}] {route} route: served {len(results)} requests, "
          f"{s['generated_tokens']} tokens in {run_s:.2f}s over {steps} steps "
          f"({run_s * 1e3 / steps:.2f} ms a step) "
          f"({s['prefill_steps']} prefill, {s['decode_steps']} decode): "
          f"{s['tok_per_s']:.1f} tok/s, latency p50 "
          f"{s['latency_p50_s'] * 1e3:.1f}ms p95 "
          f"{s['latency_p95_s'] * 1e3:.1f}ms; launches {launches}",
          flush=True)
    return dict(reqs=reqs, run_s=run_s, steps=steps, launches=launches,
                metrics=s, route=route, step_ms=run_s * 1e3 / steps,
                dropped_frac=dropped, logits=logits,
                tokens={rid: seq.generated for rid, seq in results.items()},
                exec_plans=engine.exec_plans)


def check_eager(tag, model, cfg, graph_run, per_step, **engine_kw):
    """The same stream through the eager route (``cuda_graph=False``):
    the graph route's tokens (which the caller held to static
    ``generate``'s), the same steps, and ``per_step`` launches a step of
    each named kernel, 0 of the others, as the graph run's replays
    counted them."""
    run = serve(f"{tag}-eager", model, cfg, cuda_graph=False, **engine_kw)
    check(run["tokens"] == graph_run["tokens"],
          f"[{tag}] eager route tokens {run['tokens']} != graph route "
          f"{graph_run['tokens']}")
    check(run["steps"] == graph_run["steps"],
          f"[{tag}] eager route took {run['steps']} steps, graph route "
          f"{graph_run['steps']}")
    want = {name: per_step.get(name, 0) * run["steps"]
            for name in run["launches"]}
    check(run["launches"] == want,
          f"[{tag}] eager route launches {run['launches']} != {want}")
    print(f"[{tag}] eager route == graph route, token for token; step "
          f"{run['step_ms']:.2f} ms eager, {graph_run['step_ms']:.2f} ms "
          f"graph", flush=True)
    run.pop("reqs")
    return run


def check_static(tag, model, cfg, run, policy=None):
    """Engine tokens == the static ``generate`` path for every request,
    run under ``policy`` (the engine's, with tuned plans)."""
    import torch

    from repro_torch import dispatch
    from repro_torch.runtime import serve as SV

    for rid, toks in sorted(run["tokens"].items()):
        prompt = torch.tensor([run["reqs"][rid].prompt], dtype=torch.int32,
                              device="cuda")
        with dispatch.using_policy(policy):
            ref = [int(t) for t in SV.generate(
                model, cfg, prompt, max_new_tokens=NEW_TOKENS)[0]]
        check(ref == toks, f"[{tag}] request {rid}: engine tokens {toks} "
                           f"!= static {ref}")


def build_gemma(spec):
    """Full-width gemma-2b from seed 0, quantized on the card per spec."""
    import torch

    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.device import generator
    from repro_torch.models import transformer
    from repro_torch.quant import quantized_size_bytes

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = transformer.init_params(CONFIG, generator=generator(0, "cuda"),
                                    device="cuda", quant=spec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    size = quantized_size_bytes(model)
    print(f"[main] gemma-2b built and quantized ({spec.mode}, "
          f"{spec.storage}) on the card in {build_s:.1f}s "
          f"({size / 2**30:.2f} GiB of buffers, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", flush=True)
    return model, CONFIG.replace(quant=spec), build_s, size


def phase_main():
    import torch

    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import transformer

    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    model, cfg, build_s, size = build_gemma(spec)
    run = serve("main", model, cfg, keep_logits=True)
    # each token's top-two gap: the mesh phase's near-tie allowance
    run["top2_rel"] = top2_gaps(run.pop("logits"))
    steps, launches = run["steps"], run["launches"]
    check(launches["msgemm"] == 126 * steps,
          f"msgemm launches {launches['msgemm']} != 126 x {steps} engine "
          "steps")
    check(launches["int4_matmul"] == 0 and launches["paged_attention"] == 0,
          f"full-precision msgemm run launched other kernels: {launches}")
    check_static("main", model, cfg, run)
    eager = check_eager("main", model, cfg, run, dict(msgemm=126))
    with torch.no_grad():
        toks = torch.tensor([run["reqs"][0].prompt], dtype=torch.int32,
                            device="cuda")
        logits = transformer.forward(model, cfg, toks)
    check(tuple(logits.shape) == (1, toks.shape[1], cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"forward logits {tuple(logits.shape)} not finite/expected")
    print("[main] engine tokens == static generate for every request; "
          "forward logits finite", flush=True)
    run.pop("reqs")
    return dict(run, eager=eager, build_s=build_s, model_bytes=size,
                model=model, cfg=cfg)


def phase_main_kvq(model, cfg, kv16_tokens):
    """The msgemm model served with a quantized KV pool: kv8 and kv4, each
    through the paged-attention kernel (auto-selected) and forced to the
    torch backend."""
    import torch

    from repro_torch import kvq

    out = {}
    for bits in (8, 4):
        runs = {}
        for route, backend in (("kernel", None), ("torch", "paged_attn_torch")):
            spec = kvq.KVQuantSpec(bits, backend=backend)
            want = "paged_attn_cuda" if backend is None else backend
            check(kvq.attention.select(spec, "cuda") == want,
                  f"kv{bits} {route}: selected "
                  f"{kvq.attention.select(spec, 'cuda')}, want {want}")
            tag = f"kv{bits}-{route}"
            run = serve(tag, model, cfg, kv_quant=spec)
            steps, launches = run["steps"], run["launches"]
            want_pa = 18 * steps if route == "kernel" else 0
            check(launches["paged_attention"] == want_pa,
                  f"[{tag}] paged-attention launches "
                  f"{launches['paged_attention']} != {want_pa}")
            check(launches["msgemm"] == 126 * steps,
                  f"[{tag}] msgemm launches {launches['msgemm']} != 126 x "
                  f"{steps}")
            if bits == 8 and route == "kernel":
                runs["kernel-eager"] = check_eager(
                    tag, model, cfg, run,
                    dict(msgemm=126, paged_attention=18), kv_quant=spec)
            run.pop("reqs")
            runs[route] = run
        for rid, toks in runs["kernel"]["tokens"].items():
            check(toks == runs["torch"]["tokens"][rid],
                  f"kv{bits} request {rid}: kernel route {toks} != torch "
                  f"route {runs['torch']['tokens'][rid]}")
        spec = kvq.KVQuantSpec(bits)
        bpt = kvq.bytes_per_token(cfg, spec)
        f32 = kvq.bytes_per_token(cfg, None, torch.float32)
        bf16 = kvq.bytes_per_token(cfg, None, torch.bfloat16)
        same = sum(toks == kv16_tokens[rid]
                   for rid, toks in runs["kernel"]["tokens"].items())
        print(f"[kv{bits}] kernel and torch routes agree on every request; "
              f"pool {bpt} B/token vs {f32} (f32 pool, the engine's "
              f"default) and {bf16} (bf16): {f32 / bpt:.2f}x and "
              f"{bf16 / bpt:.2f}x; {same}/{len(kv16_tokens)} requests "
              f"equal the full-precision pool's tokens", flush=True)
        out[f"kv{bits}"] = dict(runs, bytes_per_token=bpt,
                                f32_bytes_per_token=f32,
                                bf16_bytes_per_token=bf16,
                                same_as_kv16=same)
    return out


def phase_main_int4(msgemm_tokens):
    """gemma-2b from the same seed with int4 weights (the msgemm run's
    codes and scales) through the int4 kernel."""
    from repro_torch.core.spec import QuantSpec

    spec = QuantSpec(mode="int4_dequant", d=3, scale_block=36,
                     storage="packed_u8")
    model, cfg, build_s, size = build_gemma(spec)
    run = serve("int4", model, cfg)
    steps, launches = run["steps"], run["launches"]
    check(launches["int4_matmul"] == 126 * steps,
          f"[int4] int4 launches {launches['int4_matmul']} != 126 x {steps}")
    check(launches["msgemm"] == 0 and launches["paged_attention"] == 0,
          f"[int4] other kernels launched: {launches}")
    check_static("int4", model, cfg, run)
    run["eager"] = check_eager("int4", model, cfg, run,
                               dict(int4_matmul=126))
    same = sum(toks == msgemm_tokens[rid]
               for rid, toks in run["tokens"].items())
    print(f"[int4] engine tokens == static generate for every request; "
          f"{same}/{len(msgemm_tokens)} requests equal the msgemm run's "
          "tokens", flush=True)
    run.pop("reqs")
    return dict(run, build_s=build_s, model_bytes=size, same_as_msgemm=same,
                model=model, cfg=cfg)


def phase_profile(tag, model, cfg, **engine_kw):
    """Where an engine step's time goes, on both step routes: the same
    request stream, all arriving at once, first unprofiled (wall ms a
    step and tokens/s), then again through the same engine under
    torch.profiler (device time by kernel name, and device busy ms against
    the profiled wall; the profiler slows the host side, most on the eager
    route).  The graph run's kernels are the replays' own: the profiler
    sees each kernel of a graph.  ``engine_kw`` as for :func:`serve`
    (``kv_quant``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Engine, poisson_stream

    reqs = poisson_stream(6, cfg.vocab_size, max_new_tokens=16, rate=0.0,
                          min_prompt=4, max_prompt=16, seed=1)
    out = {}
    for route, graph in (("graph", True), ("eager", False)):
        engine = Engine(model, cfg, max_slots=4, block_size=8,
                        prefill_chunk=8, max_model_len=32, cuda_graph=graph,
                        **engine_kw)
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        steps, tok_s = engine.num_steps, engine.metrics()["tok_per_s"]
        engine.reset_metrics()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run(reqs)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        check(engine.num_steps == steps,
              f"[profile {tag} {route}] {engine.num_steps} steps profiled, "
              f"{steps} unprofiled")
        check_clean(f"profile {tag} {route}", engine.metrics())
        # device-side events only (kernels, copies): a CPU op's device time
        # would count its kernels a second time
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        check(busy_ms > 0, f"[profile {tag} {route}] profiler saw no "
                           "device time")
        r = out[route] = dict(
            steps=steps, prefill_steps=engine.num_prefill_steps,
            step_ms=plain_s * 1e3 / steps, tok_per_s=tok_s,
            wall_ms=wall_s * 1e3, device_busy_ms=busy_ms,
            busy_share=busy_ms / (wall_s * 1e3),
            busy_share_unprofiled=min(1.0, busy_ms / (plain_s * 1e3)),
            top=[dict(name=n[:120], device_ms=t, count=c)
                 for n, t, c in rows[:12]])
        print(f"[profile {tag} {route}] {steps} steps, unprofiled "
              f"{r['step_ms']:.2f} ms a step, {tok_s:.1f} tok/s; profiled "
              f"{wall_s * 1e3:.1f} ms wall, device busy {busy_ms:.1f} ms "
              f"({r['busy_share']:.1%}; {r['busy_share_unprofiled']:.1%} "
              "of the unprofiled wall)", flush=True)
        for t in r["top"]:
            print(f"[profile {tag} {route}]   {t['device_ms']:9.3f}ms "
                  f"x{t['count']:5d} {t['name'][:90]}")
    return out


# ------------------------------------------------------------ plan phase
PLAN_CACHE = ROOT / "chiprun_out" / "plan_cache.json"
PLAN_CLI = ROOT / "chiprun_out" / "plan_cli.json"
PLAN_METRICS = ROOT / "chiprun_out" / "plan_metrics.json"
CALIBRATION = ROOT / "chiprun_out" / "calibration.json"


def plan_key_line(key, plan, rows):
    """One tuned key: the heuristic's tiles and device ms, the winner's,
    the number of candidates, and whether the winner is the heuristic."""
    from repro_torch import dispatch
    from repro_torch.core.spec import QuantSpec
    from repro_torch.dispatch import autotune as at
    from repro_torch.obs import perfmodel as pm

    info = pm.parse_plan_key(key)
    spec = QuantSpec(mode=info["mode"], d=info["d"],
                     scale_block=info["scale_block"], storage=info["storage"])
    base = dispatch.heuristic_plan(spec, info["d"], info["m"], info["k"],
                                   info["b"], info["backend"]).tiles
    by = {at.tiles_from(r): r["s"] * 1e3 for r in rows}
    won = next(at.tiles_from(r) for r in rows if r["winner"])
    check(won == plan.tiles, f"[plan] {key}: winner row {won} != cached "
                             f"plan {plan.tiles}")
    line = dict(key=key, backend=info["backend"], m=info["m"],
                k=info["k"], b=info["b"], heuristic=base._asdict(),
                heuristic_ms=by[base], winner=won._asdict(),
                winner_ms=by[won], candidates=len(rows),
                winner_is_heuristic=won == base,
                gain=1.0 - by[won] / by[base])
    print(f"[plan] {info['backend']:11s} m={info['m']:5d} k={info['k']:5d} "
          f"b={info['b']:2d}: heuristic {tuple(base)} {by[base]:.4f} ms, "
          f"winner {tuple(won)} {by[won]:.4f} ms ({line['gain']:+.1%}), "
          f"{len(rows)} candidates, winner "
          f"{'is' if won == base else 'is not'} the heuristic", flush=True)
    return line


def check_candidates(key):
    """Every candidate of a tuned key against the plain version at the
    same tiles on exact inputs (integer bf16 x in the engine's transposed
    layout, power-of-two scales): bit for bit."""
    import torch

    from repro_torch import dispatch
    from repro_torch.core import packing
    from repro_torch.core.spec import QuantSpec
    from repro_torch.dispatch import autotune as at
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import msgemm as ms
    from repro_torch.obs import perfmodel as pm

    info = pm.parse_plan_key(key)
    m, k, b, d, sb = (info[f] for f in ("m", "k", "b", "d", "scale_block"))
    spec = QuantSpec(mode=info["mode"], d=d, scale_block=sb,
                     storage=info["storage"])
    g = torch.Generator(device="cuda").manual_seed(m + k + b)
    codes = torch.randint(0, 16, (m, k), generator=g, device="cuda",
                          dtype=torch.uint8)
    x = torch.randint(-4, 5, (b, k), generator=g, device="cuda") \
        .to(torch.bfloat16).t()
    sc = 2.0 ** torch.randint(-2, 3, (m, -(-k // sb)), generator=g,
                              device="cuda").float()
    kw = dict(scale_block=sb, out_dtype=torch.bfloat16)
    cands = at.candidate_plans(spec, d, m, k, b, info["backend"], "cuda")
    if info["backend"] == "msgemm_cuda":
        idx = packing.pack_indices(codes, d).contiguous()
        values = packing.b_values(torch.float32, "cuda")
        run = lambda f, t: f(idx, x, sc, values, d=d, tiles=t, **kw)  # noqa
        kernel, plain = ms.msgemm_cuda, ms.msgemm_plain
    else:
        u8 = packing.pack_storage(codes).contiguous()
        run = lambda f, t: f(u8, sc, x, tiles=t, **kw)  # noqa: E731
        kernel, plain = i4.int4_matmul_cuda, i4.int4_matmul_plain
    for p in cands:
        got = run(kernel, p.tiles)
        want = run(plain, p.tiles)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"[plan] {key} {p.tiles}: kernel != plain on exact inputs")
    check(dispatch.heuristic_plan(spec, d, m, k, b, info["backend"])
          in cands, f"[plan] {key}: the heuristic is no candidate")
    return len(cands)


def phase_plan(tag, model, cfg, untuned, per_step, n_keys=8):
    """The plan layer on one gemma-2b model: autotune every GeMM key of
    both step shapes at engine build (into chiprun_out/plan_cache.json),
    one line per key, every candidate bit-exact against the plain
    version; serve the stream through the tuned plans on the graph and
    then the eager route (tokens == static generate under the same
    policy and cache, ``per_step`` launches a step); then a second engine
    from the reloaded cache, traced (its kernel_gemm_s series feed the
    calibration), must time no candidate and give the same tokens.
    ``n_keys``: the distinct GeMM keys the two step shapes request."""
    from repro_torch import dispatch, obs
    from repro_torch.dispatch import autotune as at

    policy = dispatch.ExecPolicy(autotune=True)
    before = set(dispatch.cache().timing_keys())
    at.num_timed_candidates = 0
    t0 = time.perf_counter()
    run = serve(f"{tag}-tuned", model, cfg, autotune=True)
    timed = at.num_timed_candidates
    plans = run.pop("exec_plans")
    gemm_keys = sorted(k for k, p in plans.items() if p.tiles is not None)
    check(len(gemm_keys) == n_keys,
          f"[{tag}] {len(gemm_keys)} GeMM keys, not {n_keys} (gemma-2b: 4 "
          f"shapes x 2 step shapes): {gemm_keys}")
    lines = [plan_key_line(key, plans[key], dispatch.cache().timings(key))
             for key in gemm_keys]
    check(timed == sum(ln["candidates"] for ln in lines),
          f"[{tag}] timed {timed} candidates, the keys list "
          f"{sum(ln['candidates'] for ln in lines)}")
    steps, launches = run["steps"], run["launches"]
    want = {name: per_step.get(name, 0) * steps for name in launches}
    check(launches == want, f"[{tag}-tuned] launches {launches} != {want}")
    check_static(f"{tag}-tuned", model, cfg, run, policy)
    tuned_keys = sorted(set(dispatch.cache().timing_keys()) - before)
    checked = sum(check_candidates(key) for key in tuned_keys)
    eager = check_eager(f"{tag}-tuned", model, cfg, run, per_step,
                        autotune=True)
    eager.pop("exec_plans")
    moved = [ln for ln in lines if not ln["winner_is_heuristic"]]
    print(f"[{tag}] {len(gemm_keys)} keys tuned ({timed} candidates) and "
          f"served in {time.perf_counter() - t0:.1f}s; {len(moved)} moved "
          f"off the heuristic; {checked} candidates of "
          f"{len(tuned_keys)} tuned keys bit-exact; "
          f"tuned: {run['step_ms']:.2f} ms a step, "
          f"{run['metrics']['tok_per_s']:.1f} tok/s (graph), "
          f"{eager['step_ms']:.2f} ms eager; untuned (phase 4): "
          f"{untuned['step_ms']:.2f} ms, "
          f"{untuned['metrics']['tok_per_s']:.1f} tok/s, "
          f"{untuned['eager']['step_ms']:.2f} ms eager", flush=True)

    dispatch.set_cache_path(PLAN_CACHE)  # a fresh view of the file
    at.num_timed_candidates = 0
    obs.enable_tracing(clear=True)
    try:
        traced = serve(f"{tag}-reloaded", model, cfg, autotune=True)
    finally:
        obs.disable_tracing()
    check(at.num_timed_candidates == 0,
          f"[{tag}] the reloaded build timed {at.num_timed_candidates} "
          "candidates")
    check(traced.pop("exec_plans") == plans,
          f"[{tag}] the reloaded build resolved other plans")
    check(traced["tokens"] == run["tokens"],
          f"[{tag}] the reloaded, traced run gave other tokens")
    print(f"[{tag}] reloaded cache: 0 candidates timed, same plans and "
          "tokens (traced run)", flush=True)
    run.pop("reqs")
    traced.pop("reqs")
    return dict(run, eager=eager, traced=traced, keys=lines,
                timed=timed, checked_candidates=checked)


def obs_cli(tag, argv, want_rc):
    """One in-process run of ``python -m repro_torch.obs``; its exit code
    must be ``want_rc``."""
    from repro_torch.obs.__main__ import main as obs_main

    print(f"[{tag}] python -m repro_torch.obs {' '.join(argv)}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_main(argv)
    print(buf.getvalue(), end="", flush=True)
    if rc != want_rc:  # the report's ranked rows, beside the traceback
        print(buf.getvalue(), end="", file=sys.stderr, flush=True)
    check(rc == want_rc, f"[{tag}] exit {rc}, want {want_rc}")


def phase_plan_cli():
    """The slice's own entry points at full-width gemma-2b msgemm, the
    serve CLI's plan cache ``PLAN_CLI`` fresh: ``python -m
    repro_torch.launch.serve --autotune --autotune-cache PLAN_CLI
    --metrics-json PLAN_METRICS --check --check-regressions`` tunes every
    key of both step shapes and of the static check, serves (tokens ==
    static generate under the same policy and cache) and skips the
    sentinel (no calibration yet); ``python -m repro_torch.obs
    --calibrate`` fits the perf model from both plan caches and that
    snapshot (whose kernel_gemm_s series hold the plan phase's traced runs
    and this one); the calibration and snapshot validate; the serve CLI
    again with ``--calibration`` times no candidate, gives the same tokens
    and passes the sentinel over its own kernel_gemm_s series; ``python
    -m repro_torch.obs --check-regressions`` exits 0 on the training
    sources and 1 once the slowest timing row is x100."""
    from repro_torch import obs
    from repro_torch.dispatch import autotune as at
    from repro_torch.kernels import ops
    from repro_torch.obs import perfmodel as pm

    PLAN_CLI.unlink(missing_ok=True)
    tune = ["--quant", "msgemm", "--autotune", "--autotune-cache",
            str(PLAN_CLI)]
    at.num_timed_candidates = 0
    tuned = serve_cli("plan-cli tune", [
        *tune, "--check", "--metrics-json", str(PLAN_METRICS),
        "--check-regressions"], dict(msgemm=126), arch="gemma_2b")
    timed = at.num_timed_candidates
    check(tuned["checked"] == 6, "[plan-cli tune] --check did not run")
    check(timed > 0 and tuned["autotuned"] == tuned["plans"] == 8,
          f"[plan-cli tune] {tuned['autotuned']} of {tuned['plans']} plans "
          f"autotuned at build ({timed} candidates timed), want 8 of 8")
    check(tuned["regressions"] is None,
          "[plan-cli tune] the sentinel ran without a calibration")
    sources = ["--plan-cache", str(PLAN_CACHE), "--plan-cache",
               str(PLAN_CLI), "--metrics", str(PLAN_METRICS)]
    obs_cli("plan-cli calibrate", ["--calibrate", *sources,
                                   "--calibration", str(CALIBRATION)], 0)
    obs_cli("plan-cli validate", [
        "--validate-calibration", str(CALIBRATION),
        "--validate-snapshot", str(PLAN_METRICS)], 0)
    device, interpret = pm.current_partition("cuda")
    snap = json.loads(PLAN_METRICS.read_text())
    check(pm.samples_from_snapshot(snap),
          f"[plan-cli] the snapshot has no kernel_gemm_s sample of {device}")
    cal = pm.load_calibration(CALIBRATION, device=device,
                              interpret=interpret)
    check(cal is not None, f"[plan-cli] no calibration of ({device}, "
                           f"interpret={interpret}) at {CALIBRATION}")
    for bk, consts in sorted(cal.constants.items()):
        print(f"[fit] {bk:11s} " + " ".join(
            f"{n}={v:.4g}" for n, v in consts.items()), flush=True)
    print(f"[fit] {cal.fit['n_samples']} samples on {device}: median "
          f"relative error {cal.fit['median_abs_rel_err']:.3f}, rms "
          f"{cal.fit['rms_rel_err']:.3f}, max "
          f"{cal.fit['max_abs_rel_err']:.3f}", flush=True)

    obs.registry().reset(prefix="kernel_")
    at.num_timed_candidates = 0
    again = serve_cli("plan-cli sentinel", [
        *tune, "--check-regressions", "--calibration", str(CALIBRATION)],
        dict(msgemm=126), arch="gemma_2b")
    report = again["regressions"]
    check(at.num_timed_candidates == 0,
          f"[plan-cli sentinel] timed {at.num_timed_candidates} candidates "
          "from the warm cache")
    check(again["tokens"] == tuned["tokens"],
          "[plan-cli sentinel] other tokens than the tuning run's")
    check(report is not None and report["ok"] and report["n_samples"] > 0,
          f"[plan-cli sentinel] the sentinel did not pass: {report}")
    obs_cli("plan-cli check", ["--check-regressions", *sources,
                               "--calibration", str(CALIBRATION)], 0)
    doc = json.loads(PLAN_CLI.read_text())
    doc.pop("crc", None)  # a hand edit: the stale stamp would quarantine it
    key, row = max(((k, r) for k, rows in doc["timings"].items()
                    for r in rows), key=lambda kr: kr[1]["s"])
    row["s"] *= 100
    bad = PLAN_CLI.with_name("plan_cli_x100.json")
    bad.write_text(json.dumps(doc))
    obs_cli("plan-cli x100", [
        "--check-regressions", "--plan-cache", str(PLAN_CACHE),
        "--plan-cache", str(bad), "--metrics", str(PLAN_METRICS),
        "--calibration", str(CALIBRATION)], 1)
    print(f"[plan-cli] serve --autotune tuned {tuned['plans']} keys "
          f"({timed} candidates) and matched static generate; calibrated "
          f"from {cal.fit['n_samples']} samples; the sentinel passed "
          f"{report['n_samples']} series of the next run (0 candidates "
          f"timed) and the training sources at {pm.DEFAULT_TOLERANCE:g}x, "
          f"and flagged {key}'s slowest row x100; {ops.time_call_retries} "
          "timing windows of this run re-timed after a host stall",
          flush=True)
    obs.registry().reset(prefix="kernel_")
    return dict(tune=tuned, sentinel=again, timed=timed,
                calibration=cal.as_dict(), x100_key=key)


# ------------------------------------------------------- flash attention
# Device ms of the flash kernel before its redesign (f32 FMA on 64 x 64
# tiles whatever the input type), NVIDIA H100 80GB HBM3 at 700.00 W: the
# first full chip_smoke.py run of commit bdb566c (its PERF.md table)
OLD_FLASH_MS = {
    ("gemma-2b-prefill-8k", "bfloat16"): 20.65,
    ("gemma-2b-prefill-8k", "float32"): 29.78,
    ("gemma2-9b-global-8k", "bfloat16"): 45.50,
    ("gemma2-9b-global-8k", "float32"): 64.93,
    ("gemma2-9b-local-8k", "bfloat16"): 32.59,
    ("gemma2-9b-local-8k", "float32"): 43.56,
    ("prefill_32k-b1", "bfloat16"): 347.4,
    ("prefill_32k-b1", "float32"): 532.3,
    ("ragged-1000-window-100", "bfloat16"): 0.137,
    ("ragged-1000-window-100", "float32"): 0.181,
}
FLASH_CASES = [  # (name, H, Hk, S, window, softcap), B = 1, dh = 256
    ("gemma-2b-prefill-8k", 8, 1, 8192, 0, 0.0),
    ("gemma2-9b-global-8k", 16, 8, 8192, 0, 50.0),
    ("gemma2-9b-local-8k", 16, 8, 8192, 4096, 50.0),
    ("prefill_32k-b1", 8, 1, 32768, 0, 0.0),
    ("ragged-1000-window-100", 8, 1, 1000, 100, 0.0),
]


def visible_pairs(sq: int, skv: int, window: int) -> int:
    """Causal (q, k) pairs the mask lets through, positions from 0."""
    import numpy as np

    q = np.arange(sq)
    hi = np.minimum(q, skv - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    return int(np.maximum(0, hi - lo + 1).sum())


def sdpa_yardstick(q, k, v, window: int):
    """Device ms of one sdpa call on bf16 copies of the native-layout
    inputs (is_causal, or an explicit boolean mask for a window) and the
    name of the kernel it ran, from a profile of one call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    kw = dict(enable_gqa=True)
    if window:
        S = q.shape[2]
        pos = torch.arange(S, device="cuda")
        kw["attn_mask"] = ((pos[None, :] <= pos[:, None])
                           & (pos[None, :] > pos[:, None] - window))
    else:
        kw["is_causal"] = True
    call = lambda: sdpa(qb, kb, vb, **kw)  # noqa: E731
    ms = device_ms([call], reps=10)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    return ms, rows[0].key[:100] if rows else "not measured"


def phase_flash():
    """The flash-attention op at the prefill shapes of gemma-2b and
    gemma2-9b, a 32k sequence and a ragged windowed one, in bf16 and f32,
    through ``ops.flash_attention``'s public layout.  The op's path is
    driven once with the launch counts set to 0 just before and read just
    after; its outputs are then held against the plain version (f32
    within 2e-5, bf16 within one bf16 ulp), and kernel, plain version and
    sdpa are timed."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as cli

    g = torch.Generator(device="cuda").manual_seed(300)
    inputs = []
    for name, H, hk, S, window, softcap in FLASH_CASES:
        shapes = ((1, S, H, 256), (1, S, hk, 256), (1, S, hk, 256))
        f32 = [torch.randn(s, generator=g, device="cuda") for s in shapes]
        for dtype in (torch.bfloat16, torch.float32):
            inputs.append((name, dtype, [t.to(dtype) for t in f32],
                           dict(causal=True, window=window,
                                softcap=softcap)))
    # the op's path, as a caller runs it
    for mod in cli.KERNELS.values():
        mod.launches = 0
    outs = [ops.flash_attention(*qkv, **kw) for _, _, qkv, kw in inputs]
    torch.cuda.synchronize()
    launches = cli.launch_counts()
    check(launches == dict(msgemm=0, int4_matmul=0, paged_attention=0,
                           flash_attention=len(inputs)),
          f"[flash] launches {launches} != {len(inputs)} flash only")
    cases, yard = [], {}
    for (name, dtype, qkv, kw), got in zip(inputs, outs):
        t0 = time.perf_counter()
        want = ops.flash_attention(*qkv, kernel=fa.flash_attention_plain,
                                   **kw)
        tol = ATTN_TOL if dtype == torch.float32 else BF16_TOL
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda m: f"[flash] {name}: {m}")
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()), f"[flash] {name}: not finite")
        del want
        native = [t.transpose(1, 2).contiguous() for t in qkv]
        one = lambda: fa.flash_attention_cuda(*native, **kw)  # noqa: E731
        t_one = wall_ms(one, reps=1)
        reps = max(3, min(50, math.ceil(300 / max(t_one, 1e-3))))
        ms = device_ms([one], reps=reps)
        plain_ms = wall_ms(lambda: fa.flash_attention_plain(*native, **kw),
                           reps=1)
        B, S, H, dh = qkv[0].shape
        hk = qkv[1].shape[2]
        pairs = visible_pairs(S, S, kw["window"])
        elt = qkv[0].element_size()
        nbytes = (2 * B * S * H * dh + 2 * B * S * hk * dh) * elt
        nops = 4 * dh * H * pairs * B
        dev = card()
        peak = (dev.matmul_flops if dtype == torch.bfloat16
                else dev.vector_flops)
        t_bytes, t_ops = nbytes / dev.mem_bw * 1e3, nops / peak * 1e3
        if kw["softcap"]:
            library_ms, library = None, "no single call (soft-cap)"
        else:
            if name not in yard:
                yard[name] = sdpa_yardstick(*native, kw["window"])
            library_ms, library = yard[name]
        r = dict(name=name, dtype=str(dtype).removeprefix("torch."), B=B,
                 S=S, H=H, Hk=hk, dh=dh, window=kw["window"],
                 softcap=kw["softcap"], pairs=pairs, max_abs_err=err,
                 ms=ms, reps=reps, plain_ms=plain_ms, library_ms=library_ms,
                 library=library, bytes=nbytes, ops=nops,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
        r["tflops"] = nops / (ms * 1e-3) / 1e12
        r["old_ms"] = OLD_FLASH_MS.get((name, r["dtype"]))
        cases.append(r)
        del native
        sdpa_txt = "-" if library_ms is None else f"{library_ms:.3f}ms"
        print(f"[flash] {name:24s} {r['dtype']:8s} kernel={ms:.3f}ms "
              f"({r['tflops']:.1f} TFLOP/s; before the redesign "
              f"{r['old_ms']}ms) plain={plain_ms:.1f}ms "
              f"sdpa={sdpa_txt} ({library}) bound={r['bound_ms']:.4f}ms "
              f"({r['bound_by']}) err={err:.3g} "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    del outs, inputs
    return dict(cases=cases, launches=launches)


# ------------------------------------------------------- calibration phase
CALIB_DATA = dict(vocab_size=256000, seq_len=129, global_batch=4, mode="lcg")
CALIB_REDUCED_LAYERS = 1  # the gptq and model-scope recipes' depth


def calib_line(tag, res, stats_s, fit_s):
    """Print and return one calibration's figures: times, the aggregate
    weighted errors, how many linears have learned <= uniform."""
    import torch

    agg = res.report["aggregate"]
    leaves = {p: e for p, e in res.report.items() if p != "aggregate"}
    better = sum(e["learned_weighted_err"] <= e["uniform_weighted_err"]
                 for e in leaves.values())
    line = dict(stats_s=stats_s, fit_s=fit_s,
                num_linears=agg["num_linears"],
                uniform_weighted_err=agg["uniform_weighted_err"],
                learned_weighted_err=agg["learned_weighted_err"],
                learned_le_uniform=better,
                peak_bytes=torch.cuda.max_memory_allocated())
    print(f"[{tag}] stats {stats_s:.2f}s, fit {fit_s:.2f}s; weighted error "
          f"uniform {agg['uniform_weighted_err']:.6e}, learned "
          f"{agg['learned_weighted_err']:.6e} "
          f"({agg['learned_weighted_err'] / agg['uniform_weighted_err']:.4f}"
          f"x); learned <= uniform at {better} of {len(leaves)} linears; "
          f"peak {line['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    # an expert stack counts one linear an expert, with one table each
    tables = sum(t.shape[0] if t.dim() == 2 else 1
                 for t in res.codebooks.values())
    check(len(leaves) == len(res.codebooks)
          and agg["num_linears"] == tables,
          f"[{tag}] the report lists {len(leaves)} leaves and "
          f"{agg['num_linears']} linears; {len(res.codebooks)} codebooks "
          f"hold {tables} tables")
    check(math.isfinite(agg["learned_weighted_err"]),
          f"[{tag}] learned error not finite")
    return line


def timed_calibrate(tag, model, cfg, stream, recipe, quant):
    """``calib.calibrate`` on the card, its stats timed by a separate
    ``calib.collect`` over the same batches first (the fit is the rest)."""
    import torch

    from repro_torch import calib
    from repro_torch.calib.stats import batches_from

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    calib.collect(model, cfg, batches_from(stream, recipe.calib_steps),
                  mode=recipe.stats_mode)
    torch.cuda.synchronize()
    stats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = calib.calibrate(model, cfg, stream, recipe, quant=quant)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    return res, calib_line(tag, res, stats_s, total_s - stats_s)


def check_learned_tables(tag, res):
    """Every linear of the calibrated model holds its own learned table
    (the fitted one, not the uniform grid)."""
    import torch

    from repro_torch.core import packing

    uniform = packing.b_values(torch.float32, "cuda")
    mods = dict(res.params.named_modules())
    for path, table in res.codebooks.items():
        held = mods[path].params().get("codebook")
        check(held is not None and held.is_cuda and torch.equal(held, table),
              f"[{tag}] {path} does not hold its fitted table")
        check(not torch.equal(held, uniform),
              f"[{tag}] {path} holds the uniform grid")


def phase_calib(untuned=None, untuned_int4=None):
    """Calibration (``repro_torch.calib``, ``kvq.fit``) at full-width
    gemma-2b on the card: dense weights from seed 0, learned per-layer
    msgemm tables at full depth (gate: aggregate learned error below
    uniform's); the gptq and model-scope recipes at 1 layer; the quality
    report of dense, uniform and learned models; the learned model served
    on the graph route (tokens == static generate, 126 msGeMM launches a
    step, every linear on its own table); a learned int4 model at 1 layer
    on int4_torch; and ``--kv-codebook learned`` kv4 through the serve CLI on
    both attention routes.  ``untuned``/``untuned_int4``: phase 4's
    uniform msgemm and int4 runs, printed beside."""
    import torch

    from repro_torch import calib, dispatch, kvq
    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.core.spec import QuantSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.device import generator
    from repro_torch.calib.stats import batches_from
    from repro_torch.kvq.fit import kv_reconstruction_error
    from repro_torch.models import transformer
    from repro_torch.runtime import serve as SV
    from repro_torch.runtime.train import cross_entropy

    t_phase = time.perf_counter()
    out = {}
    stream = SyntheticStream(DataConfig(**CALIB_DATA))
    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    dense = transformer.init_params(CONFIG, generator=generator(0, "cuda"),
                                    device="cuda")
    res, out["msgemm"] = timed_calibrate(
        "calib msgemm", dense, CONFIG, stream, calib.Recipe(), spec)
    check(out["msgemm"]["num_linears"] == 7 * CONFIG.num_layers,
          f"[calib msgemm] {out['msgemm']['num_linears']} linears, not 126")
    check(out["msgemm"]["learned_weighted_err"]
          < out["msgemm"]["uniform_weighted_err"],
          "[calib msgemm] the learned tables' aggregate error is not below "
          "the uniform grid's")
    check_learned_tables("calib msgemm", res)

    # other recipes at reduced depth (the first two layers' weights)
    small_cfg = CONFIG.replace(num_layers=CALIB_REDUCED_LAYERS)
    small = transformer.init_params(
        small_cfg, generator=generator(0, "cuda"), device="cuda")
    for name, recipe in (("gptq", calib.Recipe(rounding="gptq")),
                         ("model", calib.Recipe(scope="model"))):
        r, out[name] = timed_calibrate(
            f"calib {name} ({CALIB_REDUCED_LAYERS} layers)", small,
            small_cfg, stream, recipe, spec)
        if name == "model":
            first = next(iter(r.codebooks.values()))
            check(all(torch.equal(t, first) for t in r.codebooks.values()),
                  "[calib model] the linears do not share one table")
        del r
    del small

    # quality: dense, uniform msgemm from the same weights, learned
    qcfg = CONFIG.replace(quant=res.quant)
    uniform = transformer.init_params(CONFIG, generator=generator(0, "cuda"),
                                      device="cuda", quant=spec)
    variants = {"uniform": (uniform, CONFIG.replace(quant=spec)),
                "learned": (res.params, qcfg)}
    rep = calib.quality.compare(dense, CONFIG, variants, stream, steps=1)
    # random weights at full width give a CE of hundreds of nats, past
    # float64's exp: print the mean CE (log-perplexity) beside it
    batch = batches_from(stream, 1)[0]
    with torch.no_grad():
        for name, (m, c) in {"bf16": (dense, CONFIG), **variants}.items():
            ce, _ = cross_entropy(transformer.forward(m, c, batch["tokens"]),
                                  batch["labels"])
            rep[name]["mean_ce"] = float(ce)
    for name, m in rep.items():
        print(f"[calib quality] {name:8s} perplexity {m['perplexity']:.4g} "
              f"(mean CE {m['mean_ce']:.4f} nats), logit MSE "
              f"{m['logit_mse']:.6e}, top-1 agreement "
              f"{m['top1_agree']:.4f}", flush=True)
    out["quality"] = {name: {k: (v if math.isfinite(v) else str(v))
                             for k, v in m.items()}
                      for name, m in rep.items()}

    # the learned K/V table the serve CLI fits (the same model and draw)
    g = torch.Generator(device="cuda").manual_seed(0)
    kv_tokens = torch.randint(0, CONFIG.vocab_size,
                              (2, min(32, CONFIG.max_seq_len)), generator=g,
                              device="cuda", dtype=torch.int32)
    kv_batches = [{"tokens": kv_tokens}]
    ucfg = CONFIG.replace(quant=spec)
    kv_table = kvq.fit_kv_codebook(uniform, ucfg, kv_batches)
    kv_err = {name: kv_reconstruction_error(
        uniform, ucfg, kv_batches, kvq.KVQuantSpec(4, codebook=cb))
        for name, cb in (("uniform", None), ("learned", kv_table))}
    print(f"[calib kv] table fitted from gemma-2b's K/V: "
          + " ".join(f"{v:.4f}" for v in kv_table)
          + f"; reconstruction error uniform {kv_err['uniform']:.6e}, "
          f"learned {kv_err['learned']:.6e}", flush=True)
    check(kv_err["learned"] <= kv_err["uniform"],
          "[calib kv] the learned KV table reconstructs worse than uniform")
    out["kv_fit"] = dict(table=kv_table, reconstruction_error=kv_err)
    del uniform, dense
    gc.collect()
    torch.cuda.empty_cache()

    # serve the learned msgemm model on both routes
    run = serve("calib-msgemm", res.params, qcfg)
    steps, launches = run["steps"], run["launches"]
    check(launches == dict(launches, msgemm=126 * steps, int4_matmul=0,
                           paged_attention=0),
          f"[calib-msgemm] launches {launches} != 126 msGeMM x {steps} "
          "steps and no other kernel")
    check_static("calib-msgemm", res.params, qcfg, run)
    run.pop("reqs")
    run.pop("exec_plans")
    base = (f"; uniform msgemm (phase 4): {untuned['step_ms']:.2f} ms, "
            f"{untuned['metrics']['tok_per_s']:.1f} tok/s"
            if untuned else "")
    print(f"[calib-msgemm] learned tables: engine tokens == static "
          f"generate, 126 msGeMM launches a step; "
          f"{run['step_ms']:.2f} ms a step, "
          f"{run['metrics']['tok_per_s']:.1f} tok/s (graph){base}",
          flush=True)
    out["serve"] = run
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # learned int4: int4_torch (the int4 kernel takes the uniform grid),
    # at the reduced depth
    dense = transformer.init_params(
        small_cfg, generator=generator(0, "cuda"), device="cuda")
    spec4 = QuantSpec(mode="int4_dequant", d=3, scale_block=36,
                      storage="packed_u8")
    res4, out["int4"] = timed_calibrate(
        f"calib int4 ({CALIB_REDUCED_LAYERS} layers)", dense, small_cfg,
        stream, calib.Recipe(), spec4)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    check_learned_tables("calib int4", res4)
    q4 = small_cfg.replace(quant=res4.quant)
    run4 = serve("calib-int4", res4.params, q4)
    check(all(n == 0 for n in run4["launches"].values()),
          f"[calib-int4] a kernel launched: {run4['launches']}")
    with dispatch.collecting() as reqs:
        SV.generate(res4.params, q4, torch.tensor(
            [run4["reqs"][0].prompt], dtype=torch.int32, device="cuda"),
            max_new_tokens=2)
    backends = {r.backend for r in reqs}
    check(backends == {"int4_torch"},
          f"[calib-int4] the plans picked {backends}, not int4_torch")
    check_static("calib-int4", res4.params, q4, run4)
    run4.pop("reqs")
    run4.pop("exec_plans")
    base = (f"; uniform int4 at full depth (phase 4, the kernel): "
            f"{untuned_int4['step_ms']:.2f} ms, "
            f"{untuned_int4['metrics']['tok_per_s']:.1f} tok/s"
            if untuned_int4 else "")
    print(f"[calib-int4] {CALIB_REDUCED_LAYERS} layer(s): learned tables "
          f"on int4_torch for all "
          f"{len(reqs)} GeMM plans: engine tokens == static generate; "
          f"{run4['step_ms']:.2f} ms a step, "
          f"{run4['metrics']['tok_per_s']:.1f} tok/s (graph){base}",
          flush=True)
    out["int4"]["serve"] = run4
    del res4
    gc.collect()
    torch.cuda.empty_cache()

    # the serve CLI fits the KV table itself: both attention routes
    cli = {}
    for route, backend, attn in (("kernel", "paged_attn_cuda", 18),
                                 ("torch", "paged_attn_torch", 0)):
        cli[route] = serve_cli(
            f"calib kv4-learned {route}",
            ["--quant", "msgemm", "--kv-bits", "4", "--kv-codebook",
             "learned", "--backend", backend, "--check"],
            dict(msgemm=126, paged_attention=attn), arch="gemma_2b")
        check(cli[route]["checked"] == 6,
              f"[calib kv4-learned {route}] --check did not run")
        check(cli[route]["kv_codebook"] == kv_table,
              f"[calib kv4-learned {route}] the CLI fitted "
              f"{cli[route]['kv_codebook']}, not {kv_table}")
    check(cli["kernel"]["tokens"] == cli["torch"]["tokens"],
          f"[calib kv4-learned] kernel route {cli['kernel']['tokens']} != "
          f"torch route {cli['torch']['tokens']}")
    print("[calib kv4-learned] the CLI's fitted table serves both routes "
          "with the same tokens, --check 6/6 each", flush=True)
    out["kv4_learned"] = cli
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[calib] phase {out['phase_s']:.1f}s", flush=True)
    return out


# ------------------------------------------------------- resilience phase
# the reference chaos benchmark's per-class schedules
# (benchmarks/chaos_serve.py), with its seed
RES_SPECS = {
    "latency": "latency:p=1.0,after=2,max=3,mag=0.02",
    "oom": "oom:p=0.5,after=1,max=4",
    "nan_logits": "nan_logits:p=1.0,after=3,max=2",
    "step_fail": "step_fail:p=1.0,after=2,max=2",
    "hang": "hang:p=1.0,after=4,max=1,mag=0.1",
    "disconnect": "disconnect:p=1.0,after=2,max=1",
}
RES_SEED = 0
TERMINAL = {"ok", "shed", "deadline", "disconnected", "quarantined"}


def serve_armed(tag, engine, reqs, spec=None):
    """Serve ``reqs`` through ``engine`` with ``spec`` armed (seed
    RES_SEED; None: disarmed), disarming in a ``finally``; the quarantine
    is left to the caller.  Each step's wall ms and msGeMM launches are
    recorded around ``engine._run_step`` (which returns once the step's
    tokens reach the host), each replan's wall ms around
    ``engine._replan``.  Every request must reach a terminal status."""
    import torch

    from repro_torch import faults
    from repro_torch.kernels.ops import KERNELS

    ms = KERNELS["msgemm"]
    steps, replans = [], []
    for mod in KERNELS.values():
        mod.launches = 0
    run_step, replan = engine._run_step, engine._replan

    def timed_step(name, *arrays):
        before, t0 = ms.launches, time.perf_counter()
        out = run_step(name, *arrays)
        steps.append(dict(kind=name, ms=(time.perf_counter() - t0) * 1e3,
                          msgemm=ms.launches - before))
        return out

    def timed_replan(reason):
        t0 = time.perf_counter()
        replan(reason)
        torch.cuda.synchronize()
        replans.append(dict(reason=reason, at_step=len(steps),
                            ms=(time.perf_counter() - t0) * 1e3))

    engine._run_step, engine._replan = timed_step, timed_replan
    plan = faults.arm(spec, seed=RES_SEED) if spec else None
    t0 = time.perf_counter()
    try:
        results = engine.run(reqs)
        torch.cuda.synchronize()
    finally:
        faults.disarm()
        del engine._run_step, engine._replan
    run_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in KERNELS.items()}
    statuses = {rid: seq.status for rid, seq in results.items()}
    check(sorted(results) == sorted(r.rid for r in reqs)
          and set(statuses.values()) <= TERMINAL,
          f"[{tag}] requests not terminal: {statuses}")
    fires = {} if plan is None else {c: plan.fires(c)
                                     for c in plan.armed_classes()}
    m = engine.metrics()
    return dict(tag=tag, spec=spec, fires=fires, statuses=statuses,
                tokens={rid: seq.generated for rid, seq in results.items()},
                metrics=m, steps=steps, replans=replans, run_s=run_s,
                launches=launches,
                backends=sorted({p.backend
                                 for p in engine.exec_plans.values()}))


def step_ms(steps, kind=None):
    """Median wall ms of the recorded steps (of one kind; nan if none)."""
    xs = sorted(s["ms"] for s in steps if kind in (None, s["kind"]))
    return xs[len(xs) // 2] if xs else float("nan")


def kinds_ms(steps):
    """Median prefill and decode step ms, as one string and a dict."""
    d = {k: step_ms(steps, k) for k in ("prefill", "decode")}
    return f"prefill {d['prefill']:.2f} / decode {d['decode']:.2f} ms", d


def res_line(run, card, extra=""):
    m = run["metrics"]
    print(f"[res {run['tag']}] {run['spec'] or 'disarmed'}: fires "
          f"{run['fires']}, statuses {sorted(run['statuses'].values())}, "
          f"{len(run['steps'])} steps (median {step_ms(run['steps']):.2f} "
          f"ms), shed {m['shed']}, cancelled {m['cancelled']}, retries "
          f"{m['step_retries']}, nan {m['nan_quarantined']}, replans "
          f"{m['replans']}, backends {run['backends']}{extra} ({card})",
          flush=True)


def phase_resilience(card):
    """The resilience layer at full-width gemma-2b msgemm on the graph
    route, the stream of :func:`serve`; ``card`` is the report line
    (name, power limit) every figure here is taken on.  Clean run, each
    transient class (tokens == clean, launches 126 a replayed step), NaN
    guard and replan (re-capture onto msgemm_torch, 0 msGeMM launches a
    step), the second replan onto dense_fallback, the watchdog's hang
    escalation, the artifact classes (plan cache, calibration, a 2-layer
    checkpoint restored and served), every class at once, and the serve
    CLI with --faults --check."""
    import gc

    import torch

    from repro_torch import dispatch
    from repro_torch.core.spec import QuantSpec
    from repro_torch.distributed.watchdog import Watchdog

    t_phase = time.perf_counter()
    print(f"[res] card: {card}", flush=True)
    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    model, cfg, build_s, _ = build_gemma(spec)
    gemms = 7 * cfg.num_layers
    reqs = request_stream(cfg)
    out = {}

    t0 = time.perf_counter()
    clean_eng = make_engine(model, cfg)
    capture_ms = (time.perf_counter() - t0) * 1e3
    clean = serve_armed("clean", clean_eng, reqs)
    check_clean("res clean", clean["metrics"])
    check(all(st["msgemm"] == gemms for st in clean["steps"]),
          f"[res clean] msGeMM launches a step {clean['steps']}")
    del clean_eng
    res_line(clean, card, f"; build capture {capture_ms:.1f} ms")
    out["clean"] = dict(clean, capture_ms=capture_ms)

    # transient classes: survivors token-identical, every replayed step on
    # the kernel
    for cls in ("latency", "oom", "step_fail", "disconnect"):
        try:
            run = serve_armed(cls, make_engine(model, cfg), reqs,
                              RES_SPECS[cls])
        finally:
            dispatch.clear_quarantine()
        m, fires = run["metrics"], run["fires"][cls]
        check(fires > 0, f"[res {cls}] the plan never fired")
        live = {r: t for r, t in run["tokens"].items()
                if run["statuses"][r] == "ok"}
        check(all(t == clean["tokens"][r] for r, t in live.items()),
              f"[res {cls}] survivors differ from the clean run")
        check(all(st["msgemm"] == gemms for st in run["steps"]),
              f"[res {cls}] a replayed step launched other than {gemms} "
              "msGeMM kernels")
        check(m["step_retries"] == (fires if cls == "step_fail" else 0),
              f"[res {cls}] {m['step_retries']} retries, {fires} fires")
        check(m["replans"] == m["nan_quarantined"] == 0,
              f"[res {cls}] replanned")
        lost = sorted(s for s in run["statuses"].values() if s != "ok")
        check(lost == (["disconnected"] if cls == "disconnect" else []),
              f"[res {cls}] non-ok statuses {lost}")
        res_line(run, card,
                 f"; {len(live)}/{len(reqs)} finished, all == clean")
        out[cls] = run

    # NaN guard: two quarantined sequences, then a replan that captures
    # both step shapes again on msgemm_torch; then a second replan on the
    # same engine reaches the bottom rung, dense_fallback
    eng = make_engine(model, cfg)
    runner = eng.runner
    captures = runner.captures
    recaptures = []
    recapture = runner.recapture

    def timed_recapture():
        t0 = time.perf_counter()
        recapture()
        torch.cuda.synchronize()
        recaptures.append((time.perf_counter() - t0) * 1e3)

    runner.recapture = timed_recapture
    try:
        nan = serve_armed("nan_logits", eng, reqs, RES_SPECS["nan_logits"])
        m, fires = nan["metrics"], nan["fires"]["nan_logits"]
        quarantined = sum(s == "quarantined"
                          for s in nan["statuses"].values())
        check(fires == 2 and quarantined == fires == m["nan_quarantined"],
              f"[res nan] {quarantined} quarantined, {fires} fires")
        check(m["replans"] >= 1 and dispatch.is_quarantined("msgemm_cuda"),
              f"[res nan] replans {m['replans']}, quarantine "
              f"{dispatch.quarantined()}")
        check(runner.captures == captures + 2 and nan["backends"] ==
              ["msgemm_torch"], f"[res nan] captures {captures} -> "
              f"{runner.captures}, backends {nan['backends']}")
        at = nan["replans"][0]["at_step"]
        before, after = nan["steps"][:at], nan["steps"][at:]
        check(before and after
              and all(st["msgemm"] == gemms for st in before)
              and all(st["msgemm"] == 0 for st in after),
              f"[res nan] msGeMM launches a step around the replan: "
              f"{[st['msgemm'] for st in nan['steps']]}")
        same = sum(t == clean["tokens"][r] for r, t in nan["tokens"].items()
                   if nan["statuses"][r] == "ok")
        (b_txt, b_ms), (a_txt, a_ms) = kinds_ms(before), kinds_ms(after)
        nan.update(same_as_clean=same, recapture_ms=list(recaptures),
                   before_ms=b_ms, after_ms=a_ms)
        res_line(nan, card,
                 f"; step {b_txt} on msgemm_cuda -> {a_txt} on "
                 f"msgemm_torch; replan {nan['replans'][0]['ms']:.1f} ms "
                 f"(re-capture {recaptures[0]:.1f} ms, build capture "
                 f"{capture_ms:.1f} ms); {same} survivors == clean "
                 "(reported, not gated)")
        out["nan_logits"] = nan

        eng.reset_metrics()
        ladder = serve_armed("ladder", eng, reqs, RES_SPECS["nan_logits"])
        check(ladder["metrics"]["replans"] >= 1
              and ladder["backends"] == ["dense_fallback"]
              and dispatch.is_quarantined("msgemm_torch"),
              f"[res ladder] backends {ladder['backends']}, quarantine "
              f"{dispatch.quarantined()}")
        at = ladder["replans"][0]["at_step"]
        tail = ladder["steps"][at:]
        check(tail and all(st["msgemm"] == 0 for st in ladder["steps"]),
              "[res ladder] msGeMM launched on the torch rungs")
        (t_txt, t_ms), (d_txt, d_ms) = (kinds_ms(ladder["steps"][:at]),
                                        kinds_ms(tail))
        ladder.update(torch_ms=t_ms, dense_ms=d_ms,
                      recapture_ms=recaptures[-1])
        res_line(ladder, card,
                 f"; step {t_txt} on msgemm_torch -> {d_txt} on "
                 f"dense_fallback (re-capture {recaptures[-1]:.1f} ms)")
        out["ladder"] = ladder
    finally:
        dispatch.clear_quarantine()
        del eng, runner
        gc.collect()
        torch.cuda.empty_cache()

    # the next engine is back on the kernel; a hang escalates to a replan
    wd = Watchdog(min_steps=3, min_timeout_s=0.5)
    eng = make_engine(model, cfg, watchdog=wd)
    try:
        warm = serve_armed("hang-warm", eng, reqs)
        check_clean("res hang-warm", warm["metrics"])
        check(warm["backends"] == [] and
              all(st["msgemm"] == gemms for st in warm["steps"]),
              "[res hang-warm] not back on msgemm_cuda at 126 a step")
        eng.reset_metrics()
        hang = serve_armed("hang", eng, reqs, RES_SPECS["hang"])
        check(wd.hang_count >= 1 and hang["metrics"]["replans"] >= 1,
              f"[res hang] hangs {wd.hang_count}, replans "
              f"{hang['metrics']['replans']}")
        check(set(hang["statuses"].values()) == {"ok"},
              f"[res hang] statuses {hang['statuses']}")
        hang["hang_count"] = wd.hang_count
        res_line(hang, card, f"; watchdog hangs {wd.hang_count}, replan "
                 f"{hang['replans'][0]['ms']:.1f} ms")
        out["hang"] = hang
    finally:
        dispatch.clear_quarantine()
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    out["artifacts"] = res_artifacts(reqs, card)

    # every serving class at once, under a deadline and a bounded queue
    eng = make_engine(model, cfg, max_queue=8, deadline_s=30.0,
                      watchdog=True)
    try:
        serve_armed("combined-warm", eng, reqs[:1])
        eng.reset_metrics()
        combined = serve_armed(
            "combined", eng, reqs,
            ";".join(RES_SPECS[c] for c in RES_SPECS))
    finally:
        dispatch.clear_quarantine()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    m = combined["metrics"]
    ok = sum(s == "ok" for s in combined["statuses"].values())
    combined.update(slo_attainment=ok / len(reqs),
                    shed_rate=m["shed"] / len(reqs))
    check(sum(combined["fires"].values()) > 0,
          "[res combined] the plan never fired")
    res_line(combined, card,
             f"; SLO attainment {combined['slo_attainment']:.3f}, shed "
             f"rate {combined['shed_rate']:.3f}")
    out["combined"] = combined
    del model
    gc.collect()
    torch.cuda.empty_cache()

    cli = serve_cli("res cli", [
        "--quant", "msgemm", "--faults", RES_CLI_FAULTS, "--fault-seed",
        str(RES_SEED), "--watchdog", "--max-queue", "64", "--deadline-s",
        "600", "--check"], dict(msgemm=gemms), arch="gemma_2b", clean=False)
    check(cli["checked"] == len(reqs) and cli["metrics"]["step_retries"] == 2,
          f"[res cli] checked {cli['checked']}, retries "
          f"{cli['metrics']['step_retries']}")
    print(f"[res cli] --faults with --check: {cli['checked']}/{len(reqs)} "
          f"== static generate, {cli['metrics']['step_retries']} retries, "
          f"{cli['step_ms']:.2f} ms a step ({card})", flush=True)
    out["cli"] = cli
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[res] phase {out['phase_s']:.1f}s ({card})", flush=True)
    return out


RES_CLI_FAULTS = ("latency:p=1.0,after=2,max=3,mag=0.02;"
                  "oom:p=0.5,after=1,max=4;step_fail:p=1.0,after=2,max=2")
RES_DIR = ROOT / "chiprun_out" / "resilience"


def res_artifacts(reqs, card):
    """The artifact classes on copies in chiprun_out/resilience/: the plan
    phase's cache and the fitted calibration, each corrupted by its fault
    class on save, quarantined aside on load (empty / None), and
    round-tripping after a rebuild; a checkpoint of full-width gemma-2b
    msgemm cut to 2 layers, step 2 corrupted, restored from step 1 bit for
    bit, and the restored model serving the stream's first two requests
    with the saved model's tokens.  The checkpoint is deleted after."""
    import shutil

    import torch

    from repro_torch import dispatch, faults
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.core.spec import QuantSpec
    from repro_torch.device import generator
    from repro_torch.models import transformer
    from repro_torch.obs import perfmodel as pm

    shutil.rmtree(RES_DIR, ignore_errors=True)
    RES_DIR.mkdir(parents=True)
    out = {}

    path = RES_DIR / "plan_cache.json"
    shutil.copy(PLAN_CACHE, path)
    cache = dispatch.set_cache_path(path)
    plans = {k: cache.get(k)
             for k in sorted(json.loads(path.read_text())["plans"])}
    check(plans, f"[res plan cache] {PLAN_CACHE} holds no plan")
    try:
        faults.arm("corrupt_plan_cache", seed=RES_SEED)
        cache.save()
    finally:
        faults.disarm()
    empty = len(dispatch.set_cache_path(path))
    aside = sorted(p.name for p in RES_DIR.glob("plan_cache.json.quar*"))
    cache = dispatch.set_cache_path(path)
    for k, p in plans.items():
        cache.put(k, p, persist=False)
    cache.save()
    back = dispatch.set_cache_path(path)
    check(empty == 0 and aside and len(back) == len(plans) and all(
        back.get(k) == p for k, p in plans.items()),
        f"[res plan cache] read back {empty} plans, quarantined {aside}, "
        f"rebuilt {len(back)} of {len(plans)}")
    dispatch.set_cache_path(PLAN_CACHE)
    print(f"[res plan cache] corrupt save -> 0 plans read, {aside[0]} "
          f"aside; rebuilt {len(plans)} plans round-trip", flush=True)
    out["plan_cache"] = dict(plans=len(plans), quarantined=aside)

    path = RES_DIR / "calibration.json"
    shutil.copy(CALIBRATION, path)
    cal = pm.load_calibration(path)
    check(cal is not None, f"[res calibration] {CALIBRATION} did not load")
    try:
        faults.arm("corrupt_calibration", seed=RES_SEED)
        cal.save(path)
    finally:
        faults.disarm()
    gone = pm.load_calibration(path)
    aside = sorted(p.name for p in RES_DIR.glob("calibration.json.quar*"))
    cal.save(path)
    back = pm.load_calibration(path)
    check(gone is None and aside and back is not None
          and back.as_dict() == cal.as_dict(),
          f"[res calibration] read back {gone}, quarantined {aside}")
    print(f"[res calibration] corrupt save -> None, {aside[0]} aside; "
          "rebuilt calibration round-trips", flush=True)
    out["calibration"] = dict(quarantined=aside)

    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    small = CONFIG.replace(num_layers=2)
    saved = transformer.init_params(small, generator=generator(0, "cuda"),
                                    device="cuda", quant=spec)
    state = saved.state_dict()
    ckpt = RES_DIR / "checkpoint"
    t0 = time.perf_counter()
    mgr = CheckpointManager(str(ckpt), keep=3)
    mgr.save(1, state)
    try:
        faults.arm("corrupt_checkpoint", seed=RES_SEED)
        mgr.save(2, state)
    finally:
        faults.disarm()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, restored = mgr.restore_latest(state, device="cuda")
    restore_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    check(step == 1 and mgr.all_steps() == [1]
          and (ckpt / "step_000000002.quarantined").is_dir()
          and list(restored) == list(state)
          and all(torch.equal(restored[k], v) for k, v in state.items()),
          f"[res checkpoint] restored step {step}, steps {mgr.all_steps()}")
    model2 = transformer.init_params(small, generator=generator(1, "cuda"),
                                     device="cuda", quant=spec)
    model2.load_state_dict(restored)
    qcfg = small.replace(quant=spec)
    toks = {}
    for name, m in (("saved", saved), ("restored", model2)):
        eng = make_engine(m, qcfg)
        res = eng.run(reqs[:2])
        check_clean(f"res checkpoint {name}", eng.metrics())
        check(all(res[r.rid].status == "ok" for r in reqs[:2]),
              f"[res checkpoint] {name} model did not finish")
        toks[name] = {r.rid: res[r.rid].generated for r in reqs[:2]}
    check(toks["saved"] == toks["restored"],
          f"[res checkpoint] restored model tokens {toks['restored']} != "
          f"saved {toks['saved']}")
    shutil.rmtree(ckpt)
    print(f"[res checkpoint] gemma-2b msgemm, full width, 2 layers "
          f"({nbytes / 2**30:.2f} GiB, {len(state)} leaves): steps 1 and 2 "
          f"saved in {save_s:.1f}s, step 2 corrupted and quarantined, step "
          f"1 restored bit for bit in {restore_s:.1f}s; the restored model "
          f"serves requests 0-1 with the saved model's tokens ({card})",
          flush=True)
    out["checkpoint"] = dict(bytes=nbytes, leaves=len(state), save_s=save_s,
                             restore_s=restore_s, tokens=toks["restored"])
    return out


# ------------------------------------------------- gemma2-9b, the serve CLI
LONG_PROMPT = dict(prompt_len=5000, seed=0)  # draws one 4,440-token prompt


def serve_cli(tag, argv, per_step, arch="gemma2_9b", clean=True,
              keep=False):
    """One in-process run of ``repro_torch.launch.serve.main`` with
    ``arch``, every launch count set to 0 just before and read just
    after.  Checks full width (the depth ``--num-layers`` asks for, else
    the config's), that every request finished, and that the engine's run
    launched each kernel exactly ``per_step[name]`` times a step (0 if
    unnamed); with ``clean`` (a run without ``--faults``) that it used no
    rung of the resilience layer.  Returns what chip_smoke.json keeps of
    the run; the model is freed unless ``keep`` (then the run holds it
    under ``model`` and ``cfg``)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve as cli

    CONFIG = configs.get_config(arch)
    argv = ["--arch", arch, "--engine", "continuous", *argv]
    print(f"[{tag}] python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    for mod in cli.KERNELS.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    total = cli.launch_counts()
    cfg = out.pop("cfg")
    model = out.pop("params")
    steps, launches, m = out["steps"], out["launches"], out["metrics"]
    depth = (int(argv[argv.index("--num-layers") + 1])
             if "--num-layers" in argv else CONFIG.num_layers)
    check(cfg.replace(quant=CONFIG.quant) == CONFIG.replace(num_layers=depth),
          f"[{tag}] not {arch} at full width and {depth} layers: {cfg}")
    check(steps > 0 and all(s.status == "ok"
                            for s in out["results"].values()),
          f"[{tag}] not every request finished")
    if clean:
        check_clean(tag, m)
    want = {name: per_step.get(name, 0) * steps for name in cli.KERNELS}
    check(launches == want, f"[{tag}] engine launches {launches} != {want} "
                            f"({per_step} a step over {steps} steps)")
    route = "graph" if out["cuda_graph"] else "eager"
    check(route == ("eager" if "--no-cuda-graph" in argv else "graph"),
          f"[{tag}] the engine took the {route} route")
    run = dict(steps=steps, run_s=out["run_s"], wall_s=wall_s, route=route,
               step_ms=out["run_s"] * 1e3 / steps,
               launches=launches, total_launches=total, metrics=m,
               build=out["build"],
               peak_bytes=torch.cuda.max_memory_allocated(),
               checked=out.get("checked", 0),
               plans=len(out["exec_plans"]),
               autotuned=sum(p.source == "autotuned"
                             for p in out["exec_plans"].values()),
               regressions=out.get("regressions"),
               prompts=[len(s.req.prompt) for s in out["results"].values()],
               kv_codebook=(None if out.get("kv_spec") is None
                            else out["kv_spec"].codebook),
               dropped_frac=out.get("dropped_frac"), layers=cfg.num_layers,
               tokens={rid: s.generated for rid, s in out["results"].items()})
    del out
    if keep:
        run.update(model=model, cfg=cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] build {run['build']['build_s']:.1f}s, buffers "
          f"{run['build']['buffer_bytes'] / 2**30:.2f} GiB, peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB; {route} route "
          f"{m['tok_per_s']:.2f} tok/s, latency p50 "
          f"{m['latency_p50_s'] * 1e3:.1f}ms p95 "
          f"{m['latency_p95_s'] * 1e3:.1f}ms over {steps} steps "
          f"({run['step_ms']:.2f} ms a step); engine "
          f"launches {launches}; with the check {total}"
          + ("" if run["dropped_frac"] is None
             else f"; moe dropped_frac {run['dropped_frac']:.6f}")
          + f" [{wall_s:.1f}s]", flush=True)
    return run


def check_artifacts(run, metrics_path, trace_path, steps_per_kind):
    """The serve CLI's --metrics-json and --trace-out files: valid under
    the port's validators, with the reference's series names, and the
    graph replays' device marks (``gemm.*`` and ``kv_dequant``, one per
    call a step) in the trace."""
    from repro_torch import obs

    for path, errs in ((metrics_path, obs.validate_snapshot_file(
            metrics_path)), (trace_path, obs.validate_trace_file(
                trace_path))):
        check(errs == [], f"[artifacts] {path} invalid: {errs[:5]}")
    snap = json.loads(Path(metrics_path).read_text())
    names = {r["name"] for kind in ("counters", "gauges", "histograms")
             for r in snap[kind]}
    want = {"serving_requests_submitted_total",
            "serving_requests_finished_total", "serving_ttft_s",
            "serving_request_latency_s", "serving_intertoken_s",
            "serving_step_s", "kv_pool_bytes", "kv_bytes_per_token",
            "kv_capacity_seqs", "kv_dequant_hbm_bytes", "kernel_gemm_s",
            "kv_dequant_s"}
    check(want <= names, f"[artifacts] snapshot lacks {want - names}")
    doc = json.loads(Path(trace_path).read_text())
    count = {}
    for ev in doc["traceEvents"]:
        key = ev["name"].split(".")[0]
        count[key] = count.get(key, 0) + (ev["ph"] == "X")
    steps = run["steps"]
    for key, per_step in steps_per_kind.items():
        check(count.get(key, 0) == per_step * steps,
              f"[artifacts] {count.get(key, 0)} {key} events in the trace, "
              f"want {per_step} x {steps} steps")
    check(count.get("engine", 0) == steps,
          f"[artifacts] {count.get('engine', 0)} engine spans, {steps} steps")
    print(f"[artifacts] {metrics_path} and {trace_path} valid: "
          f"{len(names)} series, {len(doc['traceEvents'])} trace events "
          f"({count})", flush=True)
    return dict(series=len(names), events=len(doc["traceEvents"]),
                complete_events=count)


def cli_eager(tag, argv, per_step, graph_run):
    """The same CLI run with ``--no-cuda-graph``: the graph route's tokens
    (held to static ``generate``'s by its ``--check``) and steps."""
    argv = [a for a in argv if a != "--check"]
    run = serve_cli(f"{tag} eager", [*argv, "--no-cuda-graph"], per_step)
    check(run["tokens"] == graph_run["tokens"] and
          run["steps"] == graph_run["steps"],
          f"[{tag}] eager route tokens {run['tokens']} != graph route "
          f"{graph_run['tokens']}")
    print(f"[{tag}] eager route == graph route, token for token; "
          f"{run['metrics']['tok_per_s']:.2f} tok/s eager, "
          f"{graph_run['metrics']['tok_per_s']:.2f} graph", flush=True)
    return run


def phase_gemma2_9b():
    """gemma2-9b at full width (42 layers, d_model 3584, vocab 256000) from
    seed 0 through the port's serve CLI: msgemm weights with --check; the
    same weights cut to ``CUT_LAYERS`` layers at kv8 through the
    paged-attention kernel and through the torch route (that run writes
    --metrics-json and --trace-out); int4, cut alike,
    weights with --check; and one request longer than the 4096-token
    window, int4 weights, --check, and again on the eager route
    (--no-cuda-graph): the one eager run of local, soft-capped attention
    past the window.  (The msgemm and int4 runs' eager twins were cut to
    make room for the mesh phases: the eager route's tokens equal the
    graph route's on gemma-2b's main, int4 and plan phases.)"""
    from repro_torch.configs.gemma2_9b import CONFIG

    gemms = 7 * CONFIG.num_layers  # weight GeMMs per engine step
    msgemm = ["--quant", "msgemm", "--check"]
    out = {"msgemm": serve_cli("gemma2-9b msgemm", msgemm,
                               dict(msgemm=gemms))}
    check(out["msgemm"]["checked"] == 6,
          "[gemma2-9b msgemm] --check did not run")
    runs = {}
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    paths = (str(outdir / "serve_metrics.json"),
             str(outdir / "serve_trace.json"))
    for route, extra, attn in (
            ("kernel", [], CUT_LAYERS),
            ("torch", ["--backend", "paged_attn_torch", "--metrics-json",
                       paths[0], "--trace-out", paths[1]], 0)):
        runs[route] = serve_cli(
            f"gemma2-9b kv8 {route}",
            ["--quant", "msgemm", "--kv-bits", "8", "--num-layers",
             str(CUT_LAYERS), *extra],
            dict(msgemm=7 * CUT_LAYERS, paged_attention=attn))
    for rid, toks in runs["kernel"]["tokens"].items():
        check(toks == runs["torch"]["tokens"][rid],
              f"[gemma2-9b kv8] request {rid}: kernel route {toks} != torch "
              f"route {runs['torch']['tokens'][rid]}")
    print(f"[gemma2-9b kv8] kernel and torch routes agree on every request "
          f"({CUT_LAYERS} layers)", flush=True)
    out["kv8"] = dict(runs)
    out["artifacts"] = check_artifacts(
        runs["torch"], *paths, dict(gemm=7 * CUT_LAYERS,
                                    kv_dequant=CUT_LAYERS))

    cut_gemms = 7 * CUT_LAYERS
    int4 = ["--quant", "int4_dequant", "--check", "--num-layers",
            str(CUT_LAYERS)]
    out["int4"] = serve_cli("gemma2-9b int4", int4,
                            dict(int4_matmul=cut_gemms))
    check(out["int4"]["checked"] == 6, "[gemma2-9b int4] --check did not run")

    # past the window: int4 weights (3x faster a layer than msGeMM), the
    # prompt in 256-token prefill chunks, one slot
    long_argv = [
        "--quant", "int4_dequant", "--check", "--num-requests", "1",
        "--max-slots", "1", "--prefill-chunk", "256",
        "--prompt-len", str(LONG_PROMPT["prompt_len"]),
        "--seed", str(LONG_PROMPT["seed"]), "--num-layers", str(CUT_LAYERS)]
    long = serve_cli("gemma2-9b long", long_argv,
                     dict(int4_matmul=cut_gemms))
    check(long["prompts"][0] > CONFIG.sliding_window and long["checked"] == 1,
          f"[gemma2-9b long] prompt {long['prompts']} not past the window "
          f"{CONFIG.sliding_window}, or unchecked")
    out["long"] = long
    out["long-eager"] = cli_eager("gemma2-9b long", long_argv,
                                  dict(int4_matmul=cut_gemms), long)
    print(f"[gemma2-9b long] a {long['prompts'][0]}-token prompt (window "
          f"{CONFIG.sliding_window}) served, tokens == static generate",
          flush=True)
    return out


# -------------------------------------------- the archs' GeMMs (phase 2)
ARCH_NAMES = ("qwen2_moe", "llama4_maverick", "codeqwen15_7b",
              "starcoder2_15b", "gpt3_175b", "jamba_v01", "xlstm_1b3",
              "whisper_medium", "phi3_vision")
# b of the layers' GeMMs: static generate's decode, the engine's decode (4
# slots) and prefill chunk (8), and static generate's prefill of the
# stream's longest prompt (15: a ragged column tile); the vocab head runs
# the last position only in static generate (b = 1)
ARCH_WIDTHS, HEAD_WIDTHS = (1, 4, 8, 15), (1, 4, 8)
# the recurrent models serve through static generate alone: decode at the
# serve CLI's batch (4) and at 1 (the teacher-forced check), prefill at
# 4 x 16 and 1 x 16 prompt tokens; the head at 1 and 4
RECURRENT = ("jamba_v01", "xlstm_1b3")
RECURRENT_WIDTHS, RECURRENT_HEAD_WIDTHS = (1, 4, 16, 64), (1, 4)
# the enc-dec and vision models serve through static generate too: decode
# at 4 and 1, whisper's decoder prefill and 16-frame encoder at 4 x 16;
# the head at 1 and 4.  Their wide GeMMs (:func:`wide_case`): whisper's
# encoder and cross K/V over 1500 frames (4 x 1500), phi-3-vision's
# prefill over 576 patches and 16 tokens (4 x 592)
ENCDEC = ("whisper_medium", "phi3_vision")
ENCDEC_WIDTHS, ENCDEC_HEAD_WIDTHS = (1, 4, 64), (1, 4)
WIDE = {"whisper_medium": 4 * 1500, "phi3_vision": 4 * 592}


def arch_gemms(arch):
    """(layer GeMMs, head GeMMs) of ``arch`` at full width, each (name, m,
    k, kwargs): the distinct GeMMs its serve path runs through the weight
    kernel.  The attention projections (wv as wk), the dense MLP's (down
    with the block's residual), the shared experts' MLP (no residual),
    Mamba's in/x/out projections (x_proj reads the conv branch's f32
    activations and writes f32), the mLSTM's up, o-gate and down
    projections, the sLSTM's GeGLU MLP (no residual) and the untied vocab
    head; shapes among ``GEMMA_GEMMS`` (held at b = 1, 4, 8 already) left
    out."""
    import torch

    from repro_torch import configs

    cfg = configs.get_config(arch)
    short = arch.split("_")[0]
    kinds = set(cfg.block_pattern)
    d = cfg.d_model
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    act = {"swiglu": "silu", "geglu": "gelu",
           "gelu": "gelu"}[cfg.mlp_activation]
    mlps = []  # (prefix, d_ff, activation, gated, down takes the residual)
    if kinds & {"attn", "local", "mamba"}:
        mlps.append(("", cfg.d_ff, act,
                     cfg.mlp_activation in ("swiglu", "geglu"), True))
    if cfg.num_shared_experts:
        mlps.append(("shared-", cfg.shared_expert_d_ff
                     or cfg.num_shared_experts * (cfg.moe_d_ff or cfg.d_ff),
                     act, cfg.mlp_activation in ("swiglu", "geglu"), False))
    if "slstm" in kinds:
        mlps.append(("sl-", int(d * cfg.slstm_mlp_factor), "gelu", True,
                     False))
    gemms = []
    if kinds & {"attn", "local", "moe"}:
        gemms += [("wq", q, d, {}), ("wk", kv, d, {}),
                  ("wo", d, q, dict(residual=True))]
    if kinds & {"mamba", "mamba_moe"}:
        di = cfg.mamba_d_inner
        f32 = dict(x_dtype=torch.float32, out_dtype=torch.float32)
        gemms += [("in_proj", 2 * di, d, {}),
                  ("x_proj", cfg.dt_rank + 2 * cfg.mamba_d_state, di, f32),
                  ("out_proj", d, di, {})]
    if "mlstm" in kinds:
        di = int(d * cfg.xlstm_proj_factor)
        gemms += [("xl_up", 2 * di, d, {}), ("xl_o", di, d, {}),
                  ("xl_down", d, di, {})]
    for pre, ff, a, gated, res in mlps:
        gemms += ([(f"{pre}gate", ff, d, dict(act=a)),
                   (f"{pre}up", ff, d, {})]
                  if gated else [(f"{pre}up", ff, d, dict(act=a))])
        gemms.append((f"{pre}down", d, ff, dict(residual=True) if res
                      else {}))
    seen = {(m, k, tuple(sorted(e.items()))) for _, m, k, e in GEMMA_GEMMS}
    layer = []
    for name, m, k, e in gemms:
        key = (m, k, tuple(sorted(e.items())))
        if key not in seen:
            seen.add(key)
            layer.append((f"{short}-{name}", m, k, e))
    head = ([] if cfg.tie_embeddings
            else [(f"{short}-head", cfg.vocab_size, d, {})])
    return layer, head


def phase_arch_gemms():
    """Both weight kernels against their plain versions at every GeMM
    shape of the other architectures' serve paths (:func:`arch_gemms`),
    bf16 x and residual in the engine's layout, bf16 out (as the serve
    CLI runs them; Mamba's x_proj f32): the layers at ``ARCH_WIDTHS``
    (the recurrent models' at ``RECURRENT_WIDTHS``), the vocab heads at
    ``HEAD_WIDTHS`` (``RECURRENT_HEAD_WIDTHS``).  Held as the gemma cases
    are: bit-exact on exact inputs, within one bf16 ulp on random floats
    (the int4 kernel's none/relu epilogues bit-exact there too).  Not
    timed: the gemma cases time both kernels."""
    import torch

    bf16 = torch.bfloat16
    out = dict(msgemm=[], int4=[])
    seed = 500
    for arch in ARCH_NAMES:
        layer, head = arch_gemms(arch)
        widths, head_widths = ((RECURRENT_WIDTHS, RECURRENT_HEAD_WIDTHS)
                               if arch in RECURRENT else
                               (ENCDEC_WIDTHS, ENCDEC_HEAD_WIDTHS)
                               if arch in ENCDEC
                               else (ARCH_WIDTHS, HEAD_WIDTHS))
        for name, m, k, b, ep in (engine_specs(layer, widths, bf16)
                                  + engine_specs(head, head_widths, bf16)):
            for kind, case, tiles in (("msgemm", kernel_case, tiles_str),
                                      ("int4", int4_case, int4_tiles_str)):
                t0 = time.perf_counter()
                r = case(name, m, k, b, seed=seed, timed=False, **ep)
                seed += 1
                out[kind].append(r)
                print(f"[arch-gemm] {kind:6s} {name:20s} m={m:6d} k={k:5d} "
                      f"b={b:2d} act={r['act']:4s} "
                      f"res={int(r['residual'])} "
                      f"err={r['max_abs_err']:.3g} "
                      f"exact_err={r['exact_max_abs_err']:.3g} "
                      f"[{tiles(r['tiles'])}] "
                      f"[{time.perf_counter() - t0:.1f}s]", flush=True)
        torch.cuda.empty_cache()
    print(f"[arch-gemm] {len(out['msgemm'])} msGeMM and {len(out['int4'])} "
          f"int4 cases agree with their plain versions", flush=True)
    out["wide"] = []
    for arch in ENCDEC:
        layer, _ = arch_gemms(arch)
        for name, m, k, b, ep in engine_specs(layer, (WIDE[arch],),
                                              torch.bfloat16):
            for kind in ("msgemm", "int4"):
                out["wide"].append(wide_case(kind, name, m, k, b, seed=seed,
                                             **ep))
                seed += 1
        torch.cuda.empty_cache()
    return out


def wide_case(kind, name, m, k, b, *, act="none", residual=False,
              out_dtype=None, x_dtype=None, engine_layout=True, seed=0,
              d=3, sb=36):
    """One weight kernel (``kind``: msgemm or int4) at a prefill width of
    thousands of columns, where the plain version would take minutes:
    on exact inputs (integer x and residual, power-of-two scales) against
    a float64 product of the dequantized weight (exact at any width, so
    bit-exact without an activation); on random floats against the plain
    version on three column tiles of the same launch, the first, one in
    the middle and the last (a column's result depends on no other, and
    the plain version takes the kernel's tiles, so its contraction
    splits).  Then timed against ``torch.matmul`` on the dequantized
    weight, in f32 (no TF32) and in bf16 on the tensor cores."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import msgemm as ms
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    out_dtype = out_dtype or torch.float32
    x_dtype = x_dtype or torch.float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    nsb = -(-k // sb)
    codes = torch.randint(0, 16, (m, k), generator=g, device="cuda",
                          dtype=torch.uint8)
    if kind == "msgemm":
        values = packing.b_values(torch.float32, "cuda")
        weight = packing.pack_indices(codes, d).contiguous()
        tiles = ops.msgemm_tiles(m, -(-k // d), b, d, sb)
        kw = dict(d=d, scale_block=sb, tiles=tiles)
        kernel = lambda x, sc, **e: ms.msgemm_cuda(  # noqa: E731
            weight, x, sc, values, **kw, **e)
        plain = lambda x, sc, **e: ms.msgemm_plain(  # noqa: E731
            weight, x, sc, values, **kw, **e)
        dense = lambda sc: (values[codes.long()]  # noqa: E731
                            * torch.repeat_interleave(sc, sb, 1)[:, :k])
        nbytes, nops, mma = work(
            m, k, b, d, sb, False, residual,
            torch.empty((), dtype=out_dtype).element_size(),
            torch.empty((), dtype=x_dtype).element_size())
    else:
        weight = packing.pack_storage(codes).contiguous()
        tiles = ops.int4_tiles(m, k, b)
        kw = dict(scale_block=sb, tiles=tiles)
        kernel = lambda x, sc, **e: i4.int4_matmul_cuda(  # noqa: E731
            weight, sc, x, **kw, **e)
        plain = lambda x, sc, **e: i4.int4_matmul_plain(  # noqa: E731
            weight, sc, x, **kw, **e)
        dense = lambda sc: i4.dequantize(weight, sc, k, sb)  # noqa: E731
        nbytes, nops, mma = int4_work(
            m, k, b, sb, False, residual,
            torch.empty((), dtype=out_dtype).element_size(),
            torch.empty((), dtype=x_dtype).element_size())

    def cols(rows, draw):
        return (draw(b, rows).to(x_dtype).t() if engine_layout
                else draw(rows, b).to(x_dtype))

    tol = FLOAT_TOL if out_dtype == torch.float32 else BF16_TOL
    last = (b - 1) // tiles.tb * tiles.tb
    mid = b // (2 * tiles.tb) * tiles.tb
    picks = [list(range(c, min(c + tiles.tb, b))) for c in (0, mid, last)]
    result = dict(name=name, kind=kind, m=m, k=k, b=b, act=act,
                  residual=residual, tiles=tiles._asdict(),
                  x_dtype=str(x_dtype).removeprefix("torch."),
                  out_dtype=str(out_dtype).removeprefix("torch."),
                  checked_columns=[p[0] for p in picks])
    for exact in (True, False):
        if exact:
            sc = 2.0 ** torch.randint(-2, 3, (m, nsb), generator=g,
                                      device="cuda").float()
            rnd = lambda *s: torch.randint(  # noqa: E731
                -4, 5, s, generator=g, device="cuda").float()
        else:
            sc = torch.rand((m, nsb), generator=g, device="cuda") + 0.1
            rnd = lambda *s: torch.randn(  # noqa: E731
                s, generator=g, device="cuda")
        x = cols(k, rnd)
        res = cols(m, rnd) if residual else None
        got = kernel(x, sc, act=act, residual=res, out_dtype=out_dtype)
        torch.cuda.synchronize()
        if exact:
            acc = (dense(sc).double() @ x.double()).float()
            want = ms.epilogue_cols(acc, act, None, res, out_dtype)
            err = float((got.float() - want.float()).abs().max())
            if act == "none":
                check(err == 0.0, f"{name} {kind} b={b}: kernel != float64 "
                                  f"product on exact inputs ({err})")
            else:
                torch.testing.assert_close(
                    got.float(), want.float(), **tol,
                    msg=lambda s_: f"{name} {kind} b={b}: {s_}")
            result["exact_max_abs_err"] = err
            continue
        err = 0.0
        for pick in picks:
            c = torch.tensor(pick, device="cuda")
            want = plain(x[:, c], sc, act=act,
                         residual=res[:, c] if res is not None else None,
                         out_dtype=out_dtype)
            part = got[:, c].float()
            err = max(err, float((part - want.float()).abs().max()))
            if kind == "int4" and act == "none":
                check(err == 0.0, f"{name} {kind} b={b}: kernel != plain "
                                  f"on random inputs ({err})")
            torch.testing.assert_close(
                part, want.float(), **tol,
                msg=lambda s_: f"{name} {kind} b={b} cols {pick}: {s_}")
        result["max_abs_err"] = err
    result["ms"] = device_ms([lambda: kernel(x, sc, act=act, residual=res,
                                             out_dtype=out_dtype)], reps=3)
    w = dense(sc)
    xf = x.float()
    result["library_ms"] = device_ms([lambda: torch.matmul(w, xf)], reps=5)
    wb, xb = w.to(torch.bfloat16), x.to(torch.bfloat16)
    result["bf16_matmul_ms"] = device_ms([lambda: torch.matmul(wb, xb)],
                                         reps=10)
    del w, wb, xf, xb, got
    with_bound(result, nbytes, nops, mma)
    print(f"[wide-gemm] {kind:6s} {name:14s} m={m:6d} k={k:5d} b={b:5d} "
          f"act={act:4s} res={int(residual)} exact_err="
          f"{result['exact_max_abs_err']:.3g} err={result['max_abs_err']:.3g}"
          f" (cols {result['checked_columns']}): kernel {result['ms']:.3f} "
          f"ms, f32 matmul {result['library_ms']:.3f}, bf16 matmul "
          f"{result['bf16_matmul_ms']:.3f}, bound {result['bound_ms']:.4f} "
          f"({result['bound_by']}) [{time.perf_counter() - t0:.1f}s]",
          flush=True)
    return result


# ------------------------------------------------------ experts (phase 2)
# (name, E, m, k, b, act) of the MoE configs' expert linears: qwen2-moe's
# at decode (4 slots x capacity 4) and its gate at a prefill chunk (1 x 4);
# llama4-maverick's at decode; jamba's on the static path (batch 4 x
# capacity 4, at decode and at a 16-token prefill alike)
EXPERT_CASES = [
    ("qwen2-moe-up", 60, 1408, 2048, 16, "none"),
    ("qwen2-moe-gate", 60, 1408, 2048, 16, "silu"),
    ("qwen2-moe-down", 60, 2048, 1408, 16, "none"),
    ("qwen2-moe-gate-prefill", 60, 1408, 2048, 4, "silu"),
    ("llama4-up", 128, 8192, 5120, 16, "none"),
    ("llama4-down", 128, 5120, 8192, 16, "none"),
    ("jamba-up", 16, 14336, 4096, 16, "none"),
    ("jamba-gate", 16, 14336, 4096, 16, "silu"),
    ("jamba-down", 16, 4096, 14336, 16, "none"),
]


def expert_case(name, E, m, k, b, act, *, sb=36, seed=0):
    """The int4 kernel over an expert stack (u8 (E, m, k/2), scales (E, m,
    nsb), x (E, k, b) as transposed views of the dispatch's (E, b, k)
    bf16 buffer, bf16 out, one launch) against its plain version (a loop
    of the one-linear plain version over the experts), at the tiles the
    engine picks: bit-exact on exact inputs, and on random floats too
    unless the epilogue is silu (one bf16 ulp).  Timed: kernel, plain
    version, and ``torch.matmul`` of the dequantized f32 stack (one
    batched call, a matmul an expert) as the yardstick."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import ops

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    nsb = -(-k // sb)
    u8 = torch.empty((E, m, -(-k // 2)), dtype=torch.uint8, device="cuda")
    for e in range(E):  # one expert's codes at a time
        u8[e] = packing.pack_storage(torch.randint(
            0, 16, (m, k), generator=g, device="cuda", dtype=torch.uint8))
    tiles = ops.int4_tiles(m, k, b, E)
    kw = dict(scale_block=sb, tiles=tiles, act=act, out_dtype=bf16)
    r = dict(name=name, experts=E, m=m, k=k, b=b, scale_block=sb, act=act,
             x_dtype="bfloat16", out_dtype="bfloat16", tiles=tiles._asdict())
    for exact in (True, False):
        if exact:
            sc = 2.0 ** torch.randint(-2, 3, (E, m, nsb), generator=g,
                                      device="cuda").float()
            x = torch.randint(-4, 5, (E, b, k), generator=g, device="cuda")
        else:
            sc = torch.rand((E, m, nsb), generator=g, device="cuda") + 0.1
            x = torch.randn((E, b, k), generator=g, device="cuda")
        x = x.to(bf16).transpose(1, 2)
        before = i4.launches
        got = i4.int4_matmul_cuda(u8, sc, x, **kw)
        torch.cuda.synchronize()
        check(i4.launches == before + 1,
              f"[experts] {name}: {i4.launches - before} launches, not one")
        want = i4.int4_matmul_plain(u8, sc, x, **kw)
        err = float((got.float() - want.float()).abs().max())
        if act == "none":
            check(err == 0.0, f"[experts] {name}: kernel != plain "
                              f"({'exact' if exact else 'random'} inputs, "
                              f"max abs err {err})")
        else:
            torch.testing.assert_close(got.float(), want.float(), **BF16_TOL,
                                       msg=lambda s: f"[experts] {name}: {s}")
        r["exact_max_abs_err" if exact else "max_abs_err"] = err
        del want
    r["ms"] = device_ms([lambda: i4.int4_matmul_cuda(u8, sc, x, **kw)],
                        reps=20)
    r["plain_ms"] = wall_ms(lambda: i4.int4_matmul_plain(u8, sc, x, **kw),
                            reps=1)
    w = torch.empty((E, m, k), device="cuda")
    for e in range(E):
        w[e] = i4.dequantize(u8[e], sc[e], k, sb)
    xf = x.float()
    r["library_ms"] = device_ms([lambda: torch.matmul(w, xf)], reps=20)
    del w, xf, u8
    torch.cuda.empty_cache()
    return with_bound(r, *(E * n for n in int4_work(m, k, b, sb, False,
                                                     False, 2, 2)))


def phase_int4_experts():
    cases = []
    for i, spec in enumerate(EXPERT_CASES):
        t0 = time.perf_counter()
        r = expert_case(*spec, seed=300 + i)
        cases.append(r)
        print(f"[experts] {r['name']:22s} E={r['experts']:3d} m={r['m']:5d} "
              f"k={r['k']:5d} b={r['b']:2d} act={r['act']:4s} "
              f"kernel={r['ms']:.4f}ms plain={r['plain_ms']:.1f}ms "
              f"matmul={r['library_ms']:.4f}ms bound={r['bound_ms']:.4f}ms "
              f"({r['bound_by']}, {r['ms'] / r['bound_ms']:.1f}x) "
              f"err={r['max_abs_err']:.3g} exact_err="
              f"{r['exact_max_abs_err']:.3g} [{int4_tiles_str(r['tiles'])}] "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    return cases


# ------------------------------------------------------- the arch phase
def moe_profile(tag, model, cfg):
    """A MoE model's stream once more on the graph route with tracing on:
    the device ms (CUDA events around each GeMM, recorded by the graph's
    replays) of the untied vocab head, of the expert stacks and of the
    other GeMMs, summed over the run, from ``kernel_gemm_s``."""
    import torch

    from repro_torch import obs

    obs.registry().reset(prefix="kernel_")
    obs.enable_tracing(clear=True)
    try:
        engine = make_engine(model, cfg)
        engine.run(request_stream(cfg))
        torch.cuda.synchronize()
        obs.tracer().resolve_marks(obs.tracer().take_marks())
    finally:
        obs.disable_tracing()
    sums = dict(head=0.0, experts=0.0, other=0.0)
    calls = dict(head=0, experts=0, other=0)
    for row in obs.registry().snapshot()["histograms"]:
        if row["name"] != "kernel_gemm_s" or not row["count"]:
            continue
        lb = row["labels"]
        part = ("experts" if "e" in lb else
                "head" if int(lb["m"]) == cfg.vocab_size else "other")
        sums[part] += row["sum"] * 1e3
        calls[part] += row["count"]
    steps = engine.num_steps
    check(calls["head"] == steps and calls["experts"] > 0,
          f"[{tag} profile] {calls} GeMM marks over {steps} steps")
    out = dict(steps=steps, device_ms=sums, calls=calls,
               ms_a_step={p: v / steps for p, v in sums.items()})
    print(f"[{tag} profile] device ms a step (GeMM marks, {steps} steps): "
          f"vocab head {out['ms_a_step']['head']:.3f}, experts "
          f"{out['ms_a_step']['experts']:.3f} ({calls['experts']} calls), "
          f"other GeMMs {out['ms_a_step']['other']:.3f}", flush=True)
    return out


def moe_launches(cfg):
    """(msGeMM, int4) launches of one engine step of a msgemm-weight MoE
    model: an attention block's four projections in every layer, the
    dense MLP's three (or two) or the shared experts' in every layer,
    the untied head; one int4 launch for each expert projection of each
    MoE layer (the whole stack in one)."""
    mlp = 3 if cfg.mlp_activation in ("swiglu", "geglu") else 2
    moe_layers = sum(cfg.kind(i) == "moe" for i in range(cfg.num_layers))
    dense = cfg.num_layers - moe_layers
    shared = mlp if cfg.num_shared_experts else 0
    msgemm = (4 * cfg.num_layers + mlp * dense + shared * moe_layers
              + (0 if cfg.tie_embeddings else 1))
    return msgemm, mlp * moe_layers


def dense_launches(cfg):
    """msGeMM (or int4) launches of one engine step of a dense model."""
    mlp = 3 if cfg.mlp_activation in ("swiglu", "geglu") else 2
    return (4 + mlp) * cfg.num_layers + (0 if cfg.tie_embeddings else 1)


def serve_moe(tag, arch, extra, profile):
    """A MoE model through the serve CLI (graph route, f32 pool, msgemm
    weights, no --check: capacity drops may differ from static generate,
    in the reference too), then on the same weights through the engine:
    the eager route (the CLI run's tokens); the kv8 pool through the
    paged-attention kernel (one launch a layer and step) and through the
    torch route (the kv8 kernel route's eager twin was cut for the mesh
    phases' time: the f32 pool's graph == eager stands).
    The kernel and the torch route differ in the last bits (phase 2 holds
    them within a bf16 ulp at these shapes), and a top-k router turns a
    last-bit difference into another expert, so their tokens are
    reported, not gated; codeqwen holds them equal at head dim 128 with
    f32 activations (:func:`serve_dense`)."""
    import torch

    from repro_torch import configs, kvq

    cfg0 = configs.get_config(arch)
    if "--num-layers" in extra:
        cfg0 = cfg0.replace(
            num_layers=int(extra[extra.index("--num-layers") + 1]))
    ms, i4 = moe_launches(cfg0)
    per = dict(msgemm=ms, int4_matmul=i4)
    run = serve_cli(tag, ["--quant", "msgemm", *extra], per, arch=arch,
                    keep=True)
    model, cfg = run.pop("model"), run.pop("cfg")
    check(run["dropped_frac"] is not None,
          f"[{tag}] no dropped_frac for a MoE model")
    eager = serve(f"{tag}-eager", model, cfg, cuda_graph=False)
    check(eager["tokens"] == run["tokens"]
          and eager["steps"] == run["steps"]
          and eager["dropped_frac"] == run["dropped_frac"],
          f"[{tag}] eager route tokens {eager['tokens']} (dropped_frac "
          f"{eager['dropped_frac']}) != graph route {run['tokens']} "
          f"({run['dropped_frac']})")
    want = {n: per.get(n, 0) * eager["steps"] for n in eager["launches"]}
    check(eager["launches"] == want,
          f"[{tag}] eager route launches {eager['launches']} != {want}")
    print(f"[{tag}] eager route == graph route (the CLI's), token for "
          f"token; step {eager['step_ms']:.2f} ms eager, "
          f"{run['step_ms']:.2f} ms graph", flush=True)
    eager.pop("reqs")
    kv = {}
    for route, backend in (("kernel", None), ("torch", "paged_attn_torch")):
        r = serve(f"{tag}-kv8-{route}", model, cfg,
                  kv_quant=kvq.KVQuantSpec(8, backend=backend))
        attn = cfg.num_layers if backend is None else 0
        want = dict(msgemm=ms * r["steps"], int4_matmul=i4 * r["steps"],
                    paged_attention=attn * r["steps"], flash_attention=0)
        check(r["launches"] == want,
              f"[{tag} kv8 {route}] launches {r['launches']} != {want}")
        r.pop("reqs")
        kv[route] = r
    toks, other = kv["kernel"]["tokens"], kv["torch"]["tokens"]
    same = sum(toks[rid] == other[rid] for rid in toks)
    lead = [next((i for i, (a, b) in enumerate(zip(toks[rid], other[rid]))
                  if a != b), len(toks[rid])) for rid in sorted(toks)]
    kv["same_as_torch_route"], kv["leading_agreement"] = same, lead
    print(f"[{tag} kv8] kernel route: "
          f"{cfg.num_layers} attention launches a step (head dim "
          f"{cfg.head_dim}, {cfg.num_heads // cfg.num_kv_heads} query heads "
          f"a kv head); {same}/{len(toks)} requests equal the torch "
          f"route's tokens, tokens agreeing before the first difference "
          f"{lead}; dropped_frac {kv['kernel']['dropped_frac']:.6f}",
          flush=True)
    run.update(eager=eager, kv8=kv, per_step=per)
    if profile:
        run["profile"] = phase_profile(tag, model, cfg)
        run["gemm_profile"] = moe_profile(tag, model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return run


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at ``v`` (8 significant bits)."""
    return 2.0 ** (math.frexp(abs(v))[1] - 8) if v else 2.0**-133


def card_batch(prompts):
    """The batch of static ``generate`` on ``prompts`` (a (B, S) token
    array or list, or a batch dict that also holds the stub frontend's
    ``frames`` or ``patch_embeds``), its tokens on the card.  Its cache
    and first decode position are ``runtime.serve.static_cache``'s, as
    ``generate`` sizes them."""
    import torch

    from repro_torch.models import transformer

    batch = dict(transformer.as_batch(prompts))
    batch["tokens"] = torch.as_tensor(batch["tokens"], dtype=torch.int32,
                                      device="cuda")
    return batch


def static_logits(model, cfg, prompts, n):
    """Static ``generate``'s greedy tokens for ``prompts`` (B, S tokens, or
    a batch dict with frames or patches: :func:`card_batch`), its logits
    (B, n, V) step by step, and the largest difference between those and
    one full-sequence ``transformer.forward`` of the same inputs and the
    tokens (teacher-forced), with the forward's logits (B, n, V): two
    correct evaluations of the same logits at other batch widths, so
    their difference is the model's rounding scale at this precision
    (and, for a recurrent model, the proof that the state decode carries
    is the one a full pass computes; for an enc-dec or vision model, that
    the cross cache and the patch offset are the forward's)."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.runtime import serve as SV

    batch = card_batch(prompts)
    B = batch["tokens"].shape[0]
    # n decode steps after the prefill: generate's cache for n + 1 tokens
    cache, pos0 = SV.static_cache(cfg, batch, n + 1)
    with torch.no_grad():
        logits, cache = SV.prefill_step(model, cfg, batch, cache)
        out, rows = [], []
        for i in range(n):
            rows.append(logits.float())
            tok = SV.greedy(logits)
            out.append(tok)
            pos = torch.full((B,), pos0 + i, dtype=torch.int64,
                             device="cuda")
            logits, cache = SV.decode_step(model, cfg, tok, cache, pos)
        steps = torch.stack(rows, dim=1)
        out = torch.stack(out, dim=1)
        seq = torch.cat([batch["tokens"], out[:, :-1]], dim=1)
        full = transformer.forward(model, cfg, dict(batch, tokens=seq))[
            :, pos0 - 1:].float()
    return out.tolist(), steps, float((full - steps).abs().max()), full


def static_agreement(tag, model, cfg, tokens):
    """The engine's bf16 tokens against static ``generate``'s.  The untied
    head writes bf16 logits, and the engine rounds otherwise than static
    generate (other GeMM batch widths, so other contraction splits, and
    attention shapes): two logits that round one ulp each the other way
    swap where static generate's top two are at most two bf16 ulps of
    its top logit apart (a near-tie).  Every request must agree at least
    up to static generate's first near-tie; where they part is reported
    with the gap in ulps, beside D, the largest difference between static
    generate's step-by-step logits and a teacher-forced forward of the
    same tokens over the six requests: how far two correct evaluations
    of this model's logits differ."""
    import torch

    reqs = request_stream(cfg)
    rows, scale = [], 0.0
    for rid, toks in sorted(tokens.items()):
        ref, logits, d, _ = static_logits(model, cfg, [reqs[rid].prompt],
                                          NEW_TOKENS)
        ref, logits = ref[0], logits[0]
        top = torch.topk(logits, 2, dim=-1).values
        tops, gaps = top[:, 0].tolist(), (top[:, 0] - top[:, 1]).tolist()
        ulps = [g / bf16_ulp(t) for g, t in zip(gaps, tops)]
        scale = max(scale, d / bf16_ulp(max(tops)))
        n = len(ref)
        lead = next((i for i, (a, b) in enumerate(zip(toks, ref))
                     if a != b), n)
        rows.append(dict(rid=rid, agree=lead, rounding=d,
                         first_tie=next((i for i, u in enumerate(ulps)
                                         if u <= 2), n),
                         ulps_at_part=ulps[lead] if lead < n else None,
                         min_ulps=min(ulps)))
    print(f"[{tag}] bf16: engine == static generate on "
          f"{sum(r['agree'] == NEW_TOKENS for r in rows)}/{len(rows)} "
          f"requests; steps agreeing {[r['agree'] for r in rows]}, static "
          f"generate's first near-tie (top two <= 2 ulps apart) "
          f"{[r['first_tie'] for r in rows]}, its top-two gap in ulps "
          f"where they part {[r['ulps_at_part'] for r in rows]}; D "
          f"{scale:.2f} ulps of the top logit", flush=True)
    bad = [r["rid"] for r in rows if r["agree"] < r["first_tie"]]
    check(not bad, f"[{tag}] bf16 engine tokens part from static generate "
                   f"before its first near-tie on requests {bad}")
    return dict(rounding_ulps=scale, rows=rows)


# f32 logits (about 5 in size) of two attention routes over a kv8 pool:
# a last-bit difference can flip a K/V entry's int8 code by one step (1/127
# of its slot's largest value), which moves later logits by a few 1e-2; a
# route that reads the wrong head, slot or scale moves them by units
LOGIT_TOL = 0.1


def route_agreement(tag, a, b):
    """Two engine runs on the same model and stream that differ only in
    their attention route (runs with ``keep_logits``): per request, the
    steps their tokens agree; at every step both saw the same tokens
    (up to and including the first that parts) their f32 logits must
    agree within ``LOGIT_TOL``, so tokens part only where the second
    route's top two logits are closer than the routes' difference."""
    import torch

    agree, gaps, diff = [], [], 0.0
    for rid in sorted(a["tokens"]):
        ta, tb = a["tokens"][rid], b["tokens"][rid]
        lead = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                    len(ta))
        agree.append(lead)
        for i in range(min(lead + 1, len(ta))):
            diff = max(diff, float((a["logits"][rid][i]
                                    - b["logits"][rid][i]).abs().max()))
        if lead < len(ta):
            top = torch.topk(b["logits"][rid][lead], 2).values
            gaps.append(float(top[0] - top[1]))
        else:
            gaps.append(None)
    check(diff <= LOGIT_TOL, f"[{tag}] the routes' logits differ by {diff} "
                             f"(> {LOGIT_TOL}) before their tokens part")
    for r in (a, b):
        r.pop("logits")
    return dict(kernel=a, torch=b, agree=agree, gap_at_part=gaps,
                same=sum(n == NEW_TOKENS for n in agree),
                max_logit_diff=diff)


def serve_dense(tag, arch, quant, extra=(), kv8=False):
    """A dense model through the serve CLI (bf16 activations, the graph
    route), its weight kernel launched once a linear and step, held to
    static ``generate`` up to its first near-tie
    (:func:`static_agreement`); then the same weights with f32
    activations through the engine, whose tokens must equal static
    ``generate``'s, and the same launches a step.  With ``kv8``, the f32
    model again with a kv8 pool through the paged-attention kernel (one
    launch a layer and step) and through the torch route: the same
    tokens."""
    import torch

    from repro_torch import configs, kvq

    cfg0 = configs.get_config(arch)
    if "--num-layers" in extra:
        cfg0 = cfg0.replace(
            num_layers=int(extra[extra.index("--num-layers") + 1]))
    kernel = "msgemm" if quant == "msgemm" else "int4_matmul"
    per = dense_launches(cfg0)
    run = serve_cli(tag, ["--quant", quant, *extra], {kernel: per},
                    arch=arch, keep=True)
    model, cfg = run.pop("model"), run.pop("cfg")
    run["bf16_vs_static"] = static_agreement(tag, model, cfg, run["tokens"])
    f32 = cfg.replace(dtype="float32")
    r32 = serve(f"{tag}-f32", model, f32)
    check(r32["launches"][kernel] == per * r32["steps"],
          f"[{tag}-f32] {kernel} launches {r32['launches'][kernel]} != "
          f"{per} x {r32['steps']}")
    check_static(f"{tag}-f32", model, f32, r32)
    print(f"[{tag}-f32] engine tokens == static generate for every request",
          flush=True)
    r32.pop("reqs")
    run["f32"] = r32
    if kv8:
        kv = {}
        for route, backend in (("kernel", None),
                               ("torch", "paged_attn_torch")):
            r = serve(f"{tag}-f32-kv8-{route}", model, f32, keep_logits=True,
                      kv_quant=kvq.KVQuantSpec(8, backend=backend))
            want = {n: 0 for n in r["launches"]}
            want[kernel] = per * r["steps"]
            want["paged_attention"] = (cfg.num_layers * r["steps"]
                                       if backend is None else 0)
            check(r["launches"] == want, f"[{tag}-f32 kv8 {route}] "
                                         f"launches {r['launches']} != {want}")
            r.pop("reqs")
            kv[route] = r
        kv.update(route_agreement(f"{tag}-f32 kv8", kv.pop("kernel"),
                                  kv.pop("torch")))
        print(f"[{tag}-f32 kv8] paged-attention kernel against the torch "
              f"route ({cfg.num_layers} launches a step, head dim "
              f"{cfg.head_dim}, {cfg.num_heads // cfg.num_kv_heads} query "
              f"head a kv head): {kv['same']}/{len(kv['agree'])} requests "
              f"token for token, steps agreeing {kv['agree']}; logits "
              f"within {kv['max_logit_diff']:.3g} of each other wherever "
              f"both routes had read the same tokens (at most "
              f"{LOGIT_TOL}); the torch route's top-two gap where they "
              f"part {kv['gap_at_part']}", flush=True)
        run["f32_kv8"] = kv
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase_arch(profile=False):
    """The other architectures at full width from seed 0 through the serve
    CLI: qwen2-moe-a2.7b cut to ``CUT_LAYERS`` layers (graph == eager,
    with the f32 and the kv8 pool), llama4-maverick cut to 2 layers (one
    dense, one MoE block: top-1 of 128 experts, qk-norm), codeqwen1.5-7b
    cut to ``CUT_LAYERS`` layers with msgemm and with int4,
    starcoder2-15b cut to ``CUT_LAYERS`` layers and gpt3-175b to 2
    (msgemm), the dense models' tokens held to static generate
    (:func:`serve_dense`; codeqwen's kv8 kernel == the torch route)."""
    cut_depth = ["--num-layers", str(CUT_LAYERS)]
    out = {"qwen2-moe": serve_moe("arch qwen2-moe", "qwen2_moe", cut_depth,
                                  profile)}
    out["llama4"] = serve_moe("arch llama4", "llama4_maverick",
                              ["--num-layers", "2"], profile)
    out["codeqwen-msgemm"] = serve_dense(
        "arch codeqwen msgemm", "codeqwen15_7b", "msgemm", cut_depth,
        kv8=True)
    out["codeqwen-int4"] = serve_dense("arch codeqwen int4",
                                       "codeqwen15_7b", "int4_dequant",
                                       cut_depth)
    out["starcoder2"] = serve_dense("arch starcoder2", "starcoder2_15b",
                                    "msgemm", cut_depth)
    out["gpt3"] = serve_dense("arch gpt3", "gpt3_175b", "msgemm",
                              ["--num-layers", "2"])
    return out


# -------------------------------------------------- the recurrent phase
# f32 activations: the largest difference allowed between static
# generate's step-by-step logits and a teacher-forced forward of the same
# tokens.  Two correct evaluations differ by the rounding of other batch
# widths (other contraction splits) over the depth: 1.2e-5 at jamba-v0.1
# and 1.8e-5 at xlstm-1.3b (full depth, logits about 5; this phase on an
# H100 at 700 W); a decode state that is not the one a full pass computes
# moves SMOKE logits by 0.26-0.86 (the reference's padded sLSTM)
F32_STATE_TOL = 1e-3


def recurrent_launches(cfg):
    """(msGeMM, int4) launches of one static step of a recurrent model
    with msgemm weights: 3 a Mamba layer (in, x, out projections), 3 a
    dense MLP (Mamba and attention layers), 4 an attention layer, 3 an
    mLSTM layer (up, o-gate, down), 3 an sLSTM layer (its GeGLU MLP), the
    untied head; one int4 launch for each expert projection of a
    ``mamba_moe`` layer (the whole stack in one)."""
    per = {"attn": 4 + 3, "mamba": 3 + 3, "mamba_moe": 3, "mlstm": 3,
           "slstm": 3}
    kinds = [cfg.kind(i) for i in range(cfg.num_layers)]
    msgemm = sum(per[k] for k in kinds) + (0 if cfg.tie_embeddings else 1)
    return msgemm, 3 * kinds.count("mamba_moe")


def timed_generate(model, cfg, prompts, n):
    """Static ``generate`` on ``prompts`` (B, S tokens, or a batch dict:
    :func:`card_batch`), timed on the host clock with a synchronise after
    the prefill and after the last decode step: (tokens (B, n) list,
    prefill ms, decode ms a step)."""
    import torch

    from repro_torch.runtime import serve as SV

    batch = card_batch(prompts)
    B = batch["tokens"].shape[0]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, pos0 = SV.static_cache(cfg, batch, n)
        logits, cache = SV.prefill_step(model, cfg, batch, cache)
        tok = SV.greedy(logits)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [tok]
        for i in range(n - 1):
            pos = torch.full((B,), pos0 + i, dtype=torch.int64,
                             device="cuda")
            logits, cache = SV.decode_step(model, cfg, tok, cache, pos)
            tok = SV.greedy(logits)
            out.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (torch.stack(out, dim=1).tolist(), (t1 - t0) * 1e3,
            (t2 - t1) * 1e3 / (n - 1))


def decode_breakdown(tag, model, cfg, prompts, n=4):
    """Where a static decode step's time goes: ``n`` decode steps after a
    prefill (one prefill, its cache copied for the second pass), once with
    tracing on (the device ms of the GeMMs by GeMM
    marks: the expert stacks, the vocab head, the other weight GeMMs) and
    once under torch.profiler (device busy ms, the two weight kernels'
    device ms, the rest: the scans, element-wise ops and copies; for an
    enc-dec or vision model also :func:`timeline_parts`).  The profiler
    traces one decode step first as its warm-up cycle, which it drops:
    the first kernels after it starts can go unrecorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import obs
    from repro_torch.runtime import serve as SV

    batch = card_batch(prompts)
    B = batch["tokens"].shape[0]

    def prefill():
        # a warm-up decode step and n more: generate's cache for n + 2
        cache, pos0 = SV.static_cache(cfg, batch, n + 2)
        logits, cache = SV.prefill_step(model, cfg, batch, cache)
        torch.cuda.synchronize()
        return logits, cache, pos0

    def decode(logits, cache, pos0, first=0, count=n):
        for i in range(first, first + count):
            pos = torch.full((B,), pos0 + i, dtype=torch.int64,
                             device="cuda")
            logits, cache = SV.decode_step(model, cfg, SV.greedy(logits),
                                           cache, pos)
        torch.cuda.synchronize()
        return logits, cache, pos0

    def snapshot(state):
        """The prefill's (logits, cache, pos0) with every tensor copied:
        the profiled pass decodes from it without a second prefill."""
        logits, cache, pos0 = state
        return (logits.clone(),
                [{k: v.clone() if torch.is_tensor(v) else v
                  for k, v in layer.items()} for layer in cache], pos0)

    with torch.no_grad():
        obs.enable_tracing(clear=True)
        try:
            state = prefill()
            saved = snapshot(state)
            obs.tracer().resolve_marks(obs.tracer().take_marks())
            obs.registry().reset(prefix="kernel_")
            decode(*state)
            obs.tracer().resolve_marks(obs.tracer().take_marks())
        finally:
            obs.disable_tracing()
        gemm = dict(head=0.0, experts=0.0, other=0.0)
        for row in obs.registry().snapshot()["histograms"]:
            if row["name"] != "kernel_gemm_s" or not row["count"]:
                continue
            lb = row["labels"]
            part = ("experts" if "e" in lb else
                    "head" if int(lb["m"]) == cfg.vocab_size else "other")
            gemm[part] += row["sum"] * 1e3 / n
        state = saved
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            state = decode(*state, count=1)  # the warm-up cycle
            prof.step()
            t0 = time.perf_counter()
            decode(*state, first=1)
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            prof.step()
    # the schedule's step annotation shows on the device lane too
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    check(busy > 0, f"[{tag} breakdown] the profiler saw no device time")
    # the two weight kernels and their split reductions (not PyTorch's
    # own reduce kernels, which live in at::native)
    weight = sum(t for name, t, _ in rows
                 if any(w in name for w in (
                     "msgemm_kernel", "int4_kernel",
                     "(anonymous namespace)::reduce_kernel")))
    out = dict(steps=n, gemm_ms=gemm, profiled_wall_ms=wall_ms,
               device_busy_ms=busy, weight_kernels_ms=weight,
               other_device_ms=busy - weight,
               top=[dict(name=k[:120], device_ms=t, count=c)
                    for k, t, c in rows[:10]])
    print(f"[{tag} breakdown] a decode step ({n} steps): GeMM marks: "
          f"experts {gemm['experts']:.3f} ms, vocab head {gemm['head']:.3f}, "
          f"other weight GeMMs {gemm['other']:.3f}; profiled: wall "
          f"{wall_ms:.2f} ms, device busy {busy:.3f} (weight kernels "
          f"{weight:.3f}, the rest {busy - weight:.3f})", flush=True)
    if cfg.is_encdec or cfg.frontend:
        part = out["device_parts_ms"] = timeline_parts(cfg, prof, n)
        print(f"[{tag} breakdown] device ms a step by part (profiler "
              f"timeline): decoder GeMMs {part['decoder']:.3f}"
              + (f", cross attention (q GeMM, attention over the source, "
                 f"o GeMM) {part['cross']:.3f}" if cfg.is_encdec else "")
              + f", vocab head {part['head']:.3f}, the rest "
              f"{part['rest']:.3f}", flush=True)
    for t in out["top"]:
        print(f"[{tag} breakdown]   {t['device_ms']:8.3f}ms a step "
              f"x{t['count']:5d} {t['name'][:90]}")
    return out


def teacher_forced(tag, model, cfg, prompts, n, gate_bf16=False):
    """Static ``generate``'s logits step by step against one teacher-forced
    forward of the same tokens (:func:`static_logits`), on the served
    prompts.  The gate is the f32 run: with f32 activations on the same
    weights the largest difference D must stay within ``F32_STATE_TOL``,
    the proof that the state decode carries is the one a full pass
    computes.  The model's bf16 run is reported, not gated: D in ulps of
    the top logit, and per row the steps before the forward's greedy
    token first differs from the step path's, beside the row's first
    near-tie (top two at most two bf16 ulps apart).  The forward's GeMMs
    run at other batch widths (other contraction splits) and its mLSTM
    in other chunks, so bf16 roundings part the two by several ulps over
    48 recurrent layers (7 at xlstm-1.3b), more than a near-tie, and a
    router turns a last-bit difference into another expert (jamba).
    A MoE model runs both at a drop-free capacity (``capacity_factor`` =
    E: C = S·K slots an expert): at the served capacity the forward over
    S + n tokens would drop slots that the steps keep.  ``gate_bf16``
    (the enc-dec and vision models: no router, no recurrence) gates the
    bf16 run too: every row's tokens agree at least up to its first
    near-tie, as :func:`static_agreement` holds the engine's.  At random
    weights the near-ties come early, so that gate holds few steps a row
    (printed as ``held``); the f32 check carries the proof.
    ``prompts``: tokens, or a batch dict with frames or patches."""
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    toks, steps, d16, full = static_logits(model, cfg, prompts, n)
    check(bool(steps.isfinite().all() and full.isfinite().all()),
          f"[{tag}] non-finite logits")
    top = steps.topk(2, dim=-1).values
    rows = []
    for r in range(len(toks)):
        ulps = [(a - b) / bf16_ulp(a) for a, b in top[r].tolist()]
        part = next((i for i, (a, b) in enumerate(
            zip(toks[r], full[r].argmax(-1).tolist())) if a != b), n)
        rows.append(dict(agree=part, first_tie=next(
            (i for i, u in enumerate(ulps) if u <= 2), n),
            min_ulps=min(ulps)))
    ulps16 = d16 / bf16_ulp(float(top[..., 0].abs().max()))
    f32 = cfg.replace(dtype="float32")
    toks32, _, d32, _ = static_logits(model, f32, prompts, n)
    print(f"[{tag}] teacher-forced forward against static generate's steps: "
          f"f32 D {d32:.3g} (at most {F32_STATE_TOL}); bf16 "
          f"({'gated' if gate_bf16 else 'reported'}) D "
          f"{d16:.4g} ({ulps16:.2f} ulps of the top logit), tokens agreeing "
          f"{[r['agree'] for r in rows]} of {n}, first near-ties "
          f"{[r['first_tie'] for r in rows]}"
          + (f"; the bf16 gate held {[r['first_tie'] for r in rows]} steps "
             f"a row, {sum(r['first_tie'] for r in rows)} of "
             f"{n * len(rows)}" if gate_bf16 else ""), flush=True)
    check(d32 <= F32_STATE_TOL,
          f"[{tag}] f32: static generate's logits differ from the "
          f"teacher-forced forward's by {d32} (> {F32_STATE_TOL})")
    bad = [r for r, row in enumerate(rows) if row["agree"] < row["first_tie"]]
    check(not (gate_bf16 and bad),
          f"[{tag}] bf16: the forward's tokens part from static generate's "
          f"before the first near-tie on rows {bad}")
    return dict(bf16_max_diff=d16, bf16_rounding_ulps=ulps16, rows=rows,
                f32_max_diff=d32, f32_tokens=toks32)


def serve_recurrent(tag, arch, quant, extra=()):
    """A recurrent model at full width from seed 0 through the serve CLI's
    static engine (``repro_torch.launch.serve.main``, in process; the
    CLI's batch 4, 16-token prompts, 16 new tokens), at full depth or the
    ``--num-layers`` of ``extra``: every
    kernel count set to 0 just before and read just after, exactly the
    per-step weight-kernel launches (:func:`recurrent_launches`) times the
    16 steps, no attention kernel; then on the same weights: static
    generate again, timed (prefill ms, decode ms a step; the CLI's
    tokens), the teacher-forced check (:func:`teacher_forced`) and the
    decode step's breakdown (:func:`decode_breakdown`)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve as cli

    CONFIG = cut(configs.get_config(arch), extra)
    argv = ["--arch", arch, "--engine", "static", "--quant", quant, *extra]
    print(f"[{tag}] python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    for mod in cli.KERNELS.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    total = cli.launch_counts()
    model, cfg = out.pop("params"), out.pop("cfg")
    check(cfg.replace(quant=CONFIG.quant) == CONFIG,
          f"[{tag}] not {arch} at full width and {CONFIG.num_layers} "
          f"layers: {cfg}")
    prompts, tokens = out["prompts"], out["tokens"]
    B, n = tokens.shape
    ms, i4 = recurrent_launches(cfg)
    per = (dict(msgemm=ms, int4_matmul=i4) if quant == "msgemm"
           else dict(int4_matmul=ms + i4))
    want = {name: per.get(name, 0) * n for name in cli.KERNELS}
    check(out["launches"] == want and total == want,
          f"[{tag}] launches {out['launches']} (all of the CLI's {total}) "
          f"!= {want} ({per} a step over {n} steps)")
    check(0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size,
          f"[{tag}] tokens out of the vocabulary")
    check((out["dropped_frac"] is not None) == (i4 > 0),
          f"[{tag}] dropped_frac {out['dropped_frac']}")
    peak = torch.cuda.max_memory_allocated()
    toks, prefill_ms, decode_ms = timed_generate(model, cfg, prompts, n)
    check(toks == tokens.tolist(), f"[{tag}] a second static generate "
                                   f"gave {toks}, the CLI {tokens.tolist()}")
    tok_s = B * n / (prefill_ms + decode_ms * (n - 1)) * 1e3
    b = out["build"]
    run = dict(arch=arch, quant=quant, layers=cfg.num_layers, batch=B,
               prompt_len=prompts.shape[1], new_tokens=n, steps=n,
               launches=out["launches"], per_step=per,
               build_s=b["build_s"], buffer_bytes=b["buffer_bytes"],
               build_peak_bytes=b["build_peak_bytes"], peak_bytes=peak,
               cli_run_s=out["run_s"], wall_s=wall_s, prefill_ms=prefill_ms,
               decode_ms=decode_ms, tok_per_s=tok_s,
               dropped_frac=out["dropped_frac"], tokens=toks)
    print(f"[{tag}] {cfg.num_layers} layers, d_model {cfg.d_model}: build "
          f"{b['build_s']:.1f}s, weights {b['buffer_bytes'] / 2**30:.2f} GiB "
          f"(build peak {b['build_peak_bytes'] / 2**30:.2f}), run peak "
          f"{peak / 2**30:.2f} GiB; static generate B={B}, {n} steps: "
          f"prefill {prefill_ms:.2f} ms, decode {decode_ms:.2f} ms a step, "
          f"{tok_s:.2f} tok/s (the CLI's run {out['run_s']:.2f}s); launches "
          f"{out['launches']} ({per} a step)"
          + ("" if out["dropped_frac"] is None
             else f"; moe dropped_frac {out['dropped_frac']:.6f}")
          + f" [{wall_s:.1f}s]", flush=True)
    run["teacher_forced"] = teacher_forced(tag, model, cfg, prompts, n)
    run["breakdown"] = decode_breakdown(tag, model, cfg, prompts)
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase_recurrent():
    """The recurrent blocks at full width from seed 0 through the serve
    CLI's static engine: jamba-v0.1 cut to ``CUT_LAYERS`` layers (one
    period of its pattern: Mamba, attention, 16-expert MoE) and
    xlstm-1.3b cut to ``2 * CUT_LAYERS`` of its 48 layers (two periods
    of 7 mLSTM and an sLSTM; the cut pays for the mesh-serving phases)
    with msgemm weights, xlstm-1.3b cut to ``CUT_LAYERS`` layers (one
    period) with int4 weights (:func:`serve_recurrent`)."""
    return {"jamba": serve_recurrent("rec jamba", "jamba_v01", "msgemm",
                                     ["--num-layers", str(CUT_LAYERS)]),
            "xlstm": serve_recurrent("rec xlstm", "xlstm_1b3", "msgemm",
                                     ["--num-layers", str(2 * CUT_LAYERS)]),
            "xlstm-int4": serve_recurrent("rec xlstm int4", "xlstm_1b3",
                                          "int4_dequant",
                                          ["--num-layers", str(CUT_LAYERS)])}


# ---------------------------------------------------- the enc-dec phase
def encdec_launches(cfg):
    """(prefill, decode step) weight-kernel launches of static generate on
    an enc-dec or vision model: 4 a self-attention and 2 an MLP (gelu: up,
    down) or 3 (swiglu: gate too) a layer; an enc-dec model's decoder
    layers also 2 for the cross attention (q, o) and at prefill its k and
    v over the source, and its encoder layers at prefill; the untied head
    once a step."""
    layer = 4 + (3 if cfg.mlp_activation in ("swiglu", "geglu") else 2)
    cross = 2 if cfg.is_encdec else 0
    decode = cfg.num_layers * (layer + cross) + (0 if cfg.tie_embeddings
                                                 else 1)
    prefill = decode + cfg.encoder_layers * layer + cfg.num_layers * cross
    return prefill, decode


WEIGHT_KERNELS = ("msgemm_kernel", "int4_kernel")
SPLIT_REDUCE = "(anonymous namespace)::reduce_kernel"  # not at::native's


def timeline_parts(cfg, prof, n):
    """An enc-dec or vision model's static decode step by part, device ms
    from the profiler's kernel timeline over ``n`` steps: each weight
    kernel launch with its split reduction, in call order (a layer's
    self q, k, v, o, an enc-dec model's cross q and o, the MLP's; the
    head last in a step); the decoder's GeMMs, the cross attention (every
    kernel from its q GeMM's start to its o GeMM's reduction, the
    attention over the source between them), the head, and the rest of
    the device time.  GeMM marks cannot split an eager, host-bound step:
    an event pair also spans the device's waits for the host.  The steps
    are read back from the timeline's end, each checked by its head (its
    longest weight kernel), so a kernel record the profiler lost at its
    start costs that step alone; ``steps`` says how many were read."""
    from torch.autograd import DeviceType

    ks = sorted(((e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.name.startswith("ProfilerStep")),
                key=lambda k: k[1])
    starts = [i for i, k in enumerate(ks)
              if any(w in k[0] for w in WEIGHT_KERNELS)]
    _, dec = encdec_launches(cfg)
    n_read = min(n, len(starts) // dec)
    check(n_read >= n - 1,
          f"the profiler saw {len(starts)} weight kernels over {n} steps, "
          f"want {dec} a step")
    starts = starts[len(starts) - n_read * dec:]

    def end(i):  # past launch i's split reduction
        j = i + 1
        while j < len(ks) and SPLIT_REDUCE in ks[j][0]:
            j += 1
        return j

    def dur(a, b):
        return sum(k[2] - k[1] for k in ks[a:b])

    per_layer = (dec - 1) // cfg.num_layers
    out = dict(decoder=0.0, cross=0.0, head=0.0)
    for step in range(n_read):
        w = starts[step * dec:(step + 1) * dec]
        longest = max(w, key=lambda i: ks[i][2] - ks[i][1])
        check(longest == w[-1], f"step {step} of the profiler's timeline "
                                f"does not end in the head")
        out["head"] += dur(w[-1], end(w[-1]))
        for layer in range(cfg.num_layers):
            g = w[layer * per_layer:(layer + 1) * per_layer]
            for at, i in enumerate(g):
                if cfg.is_encdec and at == 4:
                    out["cross"] += dur(i, end(g[5]))
                elif not (cfg.is_encdec and at == 5):
                    out["decoder"] += dur(i, end(i))
    out = {k: v / 1e3 / n_read for k, v in out.items()}
    first = 0 if n_read == n else starts[0]  # a partial step: its GeMMs'
    out["rest"] = dur(first, len(ks)) / 1e3 / n_read - sum(out.values())
    out["steps"] = n_read
    return out


def static_run(tag, model, cfg, batch, want, run):
    """The figures of a static ``generate`` run on ``batch`` whose tokens
    and launches ``run`` already holds: exactly ``want`` launches, tokens
    in the vocabulary; then on the same weights and inputs static
    generate again, timed (prefill ms, decode ms a step, tokens/s; the
    same tokens), the encoder alone (an enc-dec model's: wall ms of
    ``transformer.encode``, synchronised), the teacher-forced check
    (:func:`teacher_forced`) and the decode step's breakdown
    (:func:`decode_breakdown`).  Adds them to ``run``."""
    import torch

    from repro_torch.models import transformer

    tokens = run["tokens_out"]
    B, n = tokens.shape
    check(run["launches"] == want,
          f"[{tag}] launches {run['launches']} != {want}")
    check(0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size,
          f"[{tag}] tokens out of the vocabulary")
    run["peak_bytes"] = torch.cuda.max_memory_allocated()
    toks, prefill_ms, decode_ms = timed_generate(model, cfg, batch, n)
    check(toks == tokens.tolist(), f"[{tag}] a second static generate "
                                   f"gave {toks}, the first {tokens.tolist()}")
    run.update(tokens=toks, prefill_ms=prefill_ms, decode_ms=decode_ms,
               tok_per_s=B * n / (prefill_ms + decode_ms * (n - 1)) * 1e3,
               encoder_ms=None)
    if cfg.is_encdec:  # one encode, synchronised, after a warm one
        frames = batch["frames"]
        with torch.no_grad():
            run["encoder_ms"] = wall_ms(
                lambda: transformer.encode(model, cfg, frames),
                1 if frames.shape[1] > 64 else 3)
    del run["tokens_out"]
    src = (f"{batch['frames'].shape[1]} frames" if cfg.is_encdec
           else f"{cfg.num_patches} patches")
    print(f"[{tag}] static generate B={B}, {tokens.shape[1]} steps, "
          f"{batch['tokens'].shape[1]}-token prompts, {src}: "
          + (f"encoder {run['encoder_ms']:.2f} ms, " if cfg.is_encdec
             else "")
          + f"prefill {prefill_ms:.2f} ms, decode {decode_ms:.2f} ms a step, "
          f"{run['tok_per_s']:.2f} tok/s; run peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB; launches {run['launches']}",
          flush=True)
    run["teacher_forced"] = teacher_forced(tag, model, cfg, batch, n,
                                           gate_bf16=True)
    run["breakdown"] = decode_breakdown(tag, model, cfg, batch)
    return run


def serve_encdec(tag, arch, quant, extra=()):
    """An enc-dec or vision model at full width from seed 0, at full depth
    or the ``--num-layers`` of ``extra``, through the serve CLI's static
    engine (``repro_torch.launch.serve.main``, in process: batch 4,
    16-token prompts, 16 new tokens, the
    CLI's stub frames or patches): every kernel count set to 0 just
    before and read just after, exactly :func:`encdec_launches` (the
    prefill's, then 15 decode steps'), no attention kernel; then
    :func:`static_run` on the CLI's own inputs.  Returns (run, model)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve as cli

    CONFIG = cut(configs.get_config(arch), extra)
    argv = ["--arch", arch, "--engine", "static", "--quant", quant, *extra]
    print(f"[{tag}] python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    for mod in cli.KERNELS.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    total = cli.launch_counts()
    model, cfg = out.pop("params"), out.pop("cfg")
    check(cfg.replace(quant=CONFIG.quant) == CONFIG,
          f"[{tag}] not {arch} at full width and {CONFIG.num_layers} "
          f"layers: {cfg}")
    check(total == out["launches"],
          f"[{tag}] the CLI launched {total}, its run {out['launches']}")
    n = out["tokens"].shape[1]
    pre, dec = encdec_launches(cfg)
    kernel = "msgemm" if quant == "msgemm" else "int4_matmul"
    want = {name: 0 for name in cli.KERNELS}
    want[kernel] = pre + (n - 1) * dec
    b = out["build"]
    run = dict(arch=arch, quant=quant, layers=cfg.num_layers,
               encoder_layers=cfg.encoder_layers,
               batch=out["tokens"].shape[0],
               prompt_len=out["prompts"].shape[1], new_tokens=n,
               frames=(out["batch"]["frames"].shape[1] if cfg.is_encdec
                       else None),
               patches=cfg.num_patches or None, launches=out["launches"],
               per_prefill=pre, per_decode=dec, build_s=b["build_s"],
               buffer_bytes=b["buffer_bytes"],
               build_peak_bytes=b["build_peak_bytes"],
               cli_run_s=out["run_s"], wall_s=wall_s,
               tokens_out=out["tokens"])
    print(f"[{tag}] {cfg.num_layers} layers"
          + (f" + {cfg.encoder_layers} encoder" if cfg.is_encdec else "")
          + f", d_model {cfg.d_model}: build {b['build_s']:.1f}s, weights "
          f"{b['buffer_bytes'] / 2**30:.2f} GiB (build peak "
          f"{b['build_peak_bytes'] / 2**30:.2f}); the CLI's run "
          f"{out['run_s']:.2f}s, {pre} {kernel} launches at prefill, {dec} a "
          f"decode step [{wall_s:.1f}s]", flush=True)
    static_run(tag, model, cfg, out["batch"], want, run)
    return run, model, cfg


def whisper_long(tag, model, cfg, frames=1500):
    """whisper through ``runtime.serve.generate`` directly at its
    30-second window, ``frames`` encoder frames (3000 mel frames after the
    stride-2 conv; the frontend a stub): batch 4, 16-token prompts and
    ``frames`` frames from a generator seeded 0, 16 new tokens, the counts
    set to 0 just before and read just after; then :func:`static_run`."""
    import torch

    from repro_torch.device import generator
    from repro_torch.launch import serve as cli
    from repro_torch.runtime import serve as SV

    g = generator(0, "cuda")
    B, S, n = 4, 16, NEW_TOKENS
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda", dtype=torch.int32),
             "frames": torch.randn((B, frames, cfg.d_model), generator=g,
                                   device="cuda")}
    print(f"[{tag}] runtime.serve.generate: B={B}, {S}-token prompts, "
          f"{frames} frames, {n} new tokens", flush=True)
    for mod in cli.KERNELS.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = SV.generate(model, cfg, batch, max_new_tokens=n)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = cli.launch_counts()
    pre, dec = encdec_launches(cfg)
    kernel = "msgemm" if cfg.quant.mode == "msgemm" else "int4_matmul"
    want = {name: 0 for name in cli.KERNELS}
    want[kernel] = pre + (n - 1) * dec
    run = dict(arch="whisper_medium", quant=cfg.quant.mode,
               layers=cfg.num_layers, encoder_layers=cfg.encoder_layers,
               batch=B, prompt_len=S, new_tokens=n, frames=frames,
               launches=launches, per_prefill=pre, per_decode=dec,
               run_s=run_s, tokens_out=out)
    return static_run(tag, model, cfg, batch, want, run)


def phase_encdec():
    """The encoder-decoder and the vision frontend at full width from seed
    0 through the static path: whisper-medium (24 + 24 layers) with
    msgemm weights, its decoder cut to ``CUT_LAYERS`` layers with int4
    weights, and phi-3-vision-4.2b cut to
    ``CUT_LAYERS`` of its 32 layers with msgemm weights through the serve
    CLI (:func:`serve_encdec`), and
    whisper with msgemm weights at 1500 frames through
    ``runtime.serve.generate`` (:func:`whisper_long`)."""
    import torch

    out = {}
    out["whisper"], model, cfg = serve_encdec("encdec whisper",
                                              "whisper_medium", "msgemm")
    out["whisper-1500"] = whisper_long("encdec whisper 1500", model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for key, arch, quant, extra in (
            ("whisper-int4", "whisper_medium", "int4_dequant",
             ("--num-layers", str(CUT_LAYERS))),
            ("phi3", "phi3_vision", "msgemm",
             ("--num-layers", str(CUT_LAYERS)))):
        out[key], model, _ = serve_encdec(f"encdec {key}", arch, quant,
                                          extra)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------- main
# ----------------------------------------------------------------- train
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 128, 3e-3
TRAIN_DIR = ROOT / "chiprun_out" / "train"
# the card against the CPU: one step of gemma-2b cut to 1 layer (2
# before the every-family mesh-training phase was paid for)
CARD_CPU = dict(layers=1, batch=2, seq=64)
CARD_CPU_TOL = 1e-4  # relative, loss and grad_norm with f32 activations
DRIVER = dict(layers=1, steps=4, every=2, crash=3, batch=2, seq=64)
LCG_PROMPT, LCG_ROWS = 32, 4


def train_stream(seed=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """The lcg ``SyntheticStream`` the train phase draws from."""
    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.data.pipeline import DataConfig, SyntheticStream

    return SyntheticStream(DataConfig(vocab_size=CONFIG.vocab_size,
                                      seq_len=seq + 1, global_batch=batch,
                                      seed=seed))


def train_config(steps):
    """The train CLI's config: AdamW under warmup_cosine(lr, 10, steps),
    clip 1.0; the model config's remat (on) applies."""
    from repro_torch.optim import AdamWConfig, schedules
    from repro_torch.runtime import train as RT

    return RT.TrainConfig(optimizer=AdamWConfig(
        lr=schedules.warmup_cosine(TRAIN_LR, 10, steps)))


def train_full():
    """Full-width, full-depth gemma-2b (bf16 activations, f32 params) from
    seed 0: ``TRAIN_STEPS`` train steps of the lcg stream, each timed
    (host clock, synchronised by reading the loss).  The train path runs
    no hand-written kernel (the reference trains with plain products)."""
    import torch

    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.device import generator
    from repro_torch.launch.serve import KERNELS
    from repro_torch.runtime import train as RT

    cfg, tcfg = CONFIG, train_config(TRAIN_STEPS)
    data = train_stream()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = RT.init_state(cfg, tcfg, generator=generator(0, "cuda"),
                          device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in state["opt"]["m"].values())
    for mod in KERNELS.values():
        mod.launches = 0
    losses, gnorms, times = [], [], []
    for step in range(TRAIN_STEPS):
        batch = data.device_batch(step)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = RT.train_step(state, batch, cfg, tcfg)
        losses.append(float(met["loss"]))  # waits for the step
        times.append(time.perf_counter() - t)
        gnorms.append(float(met["grad_norm"]))
    launches = {name: mod.launches for name, mod in KERNELS.items()}
    check(not any(launches.values()),
          f"[train] the train steps launched hand-written kernels: "
          f"{launches}")
    check(all(math.isfinite(v) for v in losses + gnorms),
          f"[train] non-finite loss or grad norm: {losses} {gnorms}")
    check(losses[-1] < losses[0],
          f"[train] loss did not fall: {losses[0]} -> {losses[-1]}")
    step_ms = statistics.median(times[1:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(params=n_params, init_s=init_s, step_ms=step_ms,
               first_step_ms=times[0] * 1e3,
               tokens_per_s=tokens / (step_ms / 1e3), peak_gib=peak,
               losses=losses, grad_norms=gnorms, step_s=times)
    print(f"[train] gemma-2b full width and depth ({n_params:,} params, "
          f"f32 params and moments, bf16 activations, remat on): state "
          f"built in {init_s:.1f}s; {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, step {step_ms:.1f} ms (median of steps "
          f"2-{TRAIN_STEPS}; step 1 {times[0] * 1e3:.1f} ms), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GiB; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad_norm "
          f"{gnorms[0]:.4f} -> {gnorms[-1]:.4f}", flush=True)
    return state, out


def lcg_follow(model, cfg, stream, step=0):
    """Greedy tokens of static ``generate`` after ``LCG_PROMPT``-token lcg
    prompts (``LCG_ROWS`` rows of ``stream``'s batch ``step``), and how
    many of them follow the lcg rule of their row (``stream.lcg_rule``)."""
    import numpy as np
    import torch

    from repro_torch.runtime import serve as SV

    prompts = stream.host_batch(step)["tokens"][:LCG_ROWS, :LCG_PROMPT]
    with torch.no_grad():
        out = SV.generate(model, cfg, torch.as_tensor(prompts, device="cuda"),
                          max_new_tokens=NEW_TOKENS).cpu().numpy()
    pos = np.arange(LCG_PROMPT, LCG_PROMPT + NEW_TOKENS)[None, :]
    want = stream.lcg_rule(step)(pos)[:LCG_ROWS]
    return int((out == want).sum()), out.size


def heldout_ce(model, cfg, stream, steps=2):
    """Mean CE (nats) over ``steps`` batches of a held-out stream."""
    import torch

    from repro_torch.calib.stats import batches_from
    from repro_torch.models import transformer
    from repro_torch.runtime.train import cross_entropy

    ces = []
    with torch.no_grad():
        for b in batches_from(stream, steps):
            ce, _ = cross_entropy(transformer.forward(model, cfg,
                                                      b["tokens"]),
                                  b["labels"])
            ces.append(float(ce))
    return sum(ces) / len(ces)


def near_ties(model, cfg):
    """Static ``generate``'s top-two gaps, in bf16 ulps of the top logit,
    at every step of the 6-request stream: the steps where they are at
    most 2 ulps apart (near-ties) and each request's first one."""
    import torch

    gaps, first = [], []
    for req in request_stream(cfg):
        _, logits, _, _ = static_logits(model, cfg, [req.prompt], NEW_TOKENS)
        top = torch.topk(logits[0], 2, dim=-1).values
        ulps = [(t - s) / bf16_ulp(t) for t, s in top.tolist()]
        gaps += ulps
        first.append(next((i for i, u in enumerate(ulps) if u <= 2),
                          NEW_TOKENS))
    return dict(near_ties=sum(u <= 2 for u in gaps), steps=len(gaps),
                first_tie=first, min_ulps=min(gaps),
                median_ulps=statistics.median(gaps))


def train_serve(model, cfg):
    """The trained model, its optimizer state freed: held-out CE and the
    lcg rule dense, then quantized in place to msgemm (d=3,
    scale_block=36) and served: the stream on the graph route (126
    msGeMM launches a step, tokens == static generate), then with a kv8
    pool through the paged-attention kernel (18 launches a step) and the
    torch route (the same tokens)."""
    import torch

    from repro_torch import kvq
    from repro_torch.core.spec import QuantSpec
    from repro_torch.quant import quantize_model

    heldout = train_stream(seed=1, batch=4)
    lcg = train_stream(seed=1, batch=LCG_ROWS, seq=LCG_PROMPT)
    out = {"dense": dict(heldout_ce=heldout_ce(model, cfg, heldout),
                         lcg=lcg_follow(model, cfg, lcg),
                         ties=near_ties(model, cfg))}
    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    t0 = time.perf_counter()
    quantize_model(model, spec)
    torch.cuda.synchronize()
    qcfg = cfg.replace(quant=spec)
    out["quantize_s"] = time.perf_counter() - t0
    out["msgemm"] = dict(heldout_ce=heldout_ce(model, qcfg, heldout),
                         lcg=lcg_follow(model, qcfg, lcg),
                         ties=near_ties(model, qcfg))
    for k in ("dense", "msgemm"):
        r = out[k]
        t = r["ties"]
        print(f"[train-serve] {k}: held-out mean CE {r['heldout_ce']:.4f} "
              f"nats (perplexity {math.exp(min(r['heldout_ce'], 700)):.4g}), "
              f"lcg rule followed by {r['lcg'][0]}/{r['lcg'][1]} greedy "
              f"tokens; static generate's near-ties (top two <= 2 bf16 ulps "
              f"apart) {t['near_ties']}/{t['steps']} steps, first "
              f"{t['first_tie']}, top-two gap median {t['median_ulps']:.1f} "
              f"ulps, min {t['min_ulps']:.2f}", flush=True)
    run = serve("train-msgemm", model, qcfg)
    steps, launches = run["steps"], run["launches"]
    check(launches["msgemm"] == 126 * steps
          and launches["paged_attention"] == 0
          and launches["int4_matmul"] == 0,
          f"[train-msgemm] launches {launches} != 126 msgemm x {steps}")
    check_static("train-msgemm", model, qcfg, run)
    print("[train-msgemm] engine tokens == static generate for every "
          "request", flush=True)
    run.pop("reqs")
    out["engine"] = run
    kv = {}
    for route, backend in (("kernel", None), ("torch", "paged_attn_torch")):
        tag = f"train-kv8-{route}"
        r = serve(tag, model, qcfg, kv_quant=kvq.KVQuantSpec(
            8, backend=backend))
        want = 18 * r["steps"] if route == "kernel" else 0
        check(r["launches"]["paged_attention"] == want
              and r["launches"]["msgemm"] == 126 * r["steps"],
              f"[{tag}] launches {r['launches']}: want {want} paged "
              f"attention, 126 msgemm x {r['steps']}")
        r.pop("reqs")
        kv[route] = r
    check(kv["kernel"]["tokens"] == kv["torch"]["tokens"],
          f"[train-kv8] kernel route {kv['kernel']['tokens']} != torch "
          f"route {kv['torch']['tokens']}")
    print("[train-kv8] kernel route == torch route on every request; step "
          f"{kv['kernel']['step_ms']:.2f} ms (the f32 pool's "
          f"{run['step_ms']:.2f})", flush=True)
    out["kv8"] = kv
    return out


def train_card_cpu():
    """One train step of full-width gemma-2b cut to ``CARD_CPU['layers']``
    layers from the same seed-0 weights and batch, on the card and on the
    CPU with the same port code: loss and grad_norm with f32 activations
    within ``CARD_CPU_TOL`` (gated).  (The bf16-activation step, reported
    only, was cut for the mesh phases' time.)"""
    import copy

    import torch

    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.device import generator
    from repro_torch.models import transformer
    from repro_torch.runtime import train as RT

    small = CONFIG.replace(num_layers=CARD_CPU["layers"])
    data = train_stream(batch=CARD_CPU["batch"], seq=CARD_CPU["seq"])
    card = transformer.init_params(small, generator=generator(0, "cuda"),
                                   device="cuda")
    pristine = {k: v.to("cpu", copy=True)
                for k, v in card.state_dict().items()}
    host = copy.deepcopy(card).cpu()
    out = {}
    for dtype in ("float32",):
        cfg = small.replace(dtype=dtype)
        got = {}
        for key, dev, model in (("card", "cuda", card),
                                ("cpu", "cpu", host)):
            model.load_state_dict(pristine)
            state = RT.state_for(model, train_config(TRAIN_STEPS))
            t = time.perf_counter()
            _, met = RT.train_step(state, data.device_batch(0, device=dev),
                                   cfg, train_config(TRAIN_STEPS))
            got[key] = {k: float(met[k]) for k in ("loss", "grad_norm")}
            got[key]["s"] = time.perf_counter() - t
            del state, met
        rel = {k: abs(got["card"][k] - got["cpu"][k]) / abs(got["cpu"][k])
               for k in ("loss", "grad_norm")}
        out[dtype] = dict(got, rel=rel)
        print(f"[train-card-cpu] {dtype} activations, {CARD_CPU['layers']} "
              f"layers, {CARD_CPU['batch']} x {CARD_CPU['seq']} tokens: loss "
              f"card {got['card']['loss']:.7f} cpu {got['cpu']['loss']:.7f} "
              f"(rel {rel['loss']:.2e}), grad_norm card "
              f"{got['card']['grad_norm']:.7f} cpu {got['cpu']['grad_norm']:.7f}"
              f" (rel {rel['grad_norm']:.2e}); step {got['card']['s']:.2f}s "
              f"card, {got['cpu']['s']:.2f}s cpu", flush=True)
        if dtype == "float32":
            check(max(rel.values()) <= CARD_CPU_TOL,
                  f"[train-card-cpu] card and CPU differ by {rel} (f32 "
                  f"activations; tolerance {CARD_CPU_TOL})")
    del card, host, pristine
    return out


def train_driver():
    """``runtime.driver.run`` at full width cut to ``DRIVER['layers']``
    layers (f32 activations):
    a crash at step ``DRIVER['crash']`` after the checkpoint at
    ``DRIVER['every']``, then a restart that resumes there; its losses
    against a plain ``train_step`` loop's within rtol 1e-5 (the embedding
    gather's backward adds with atomics on the card).  Then the train CLI
    at smoke width with its default device (the card)."""
    import shutil

    import torch

    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.device import generator
    from repro_torch.launch import train as LT
    from repro_torch.runtime import train as RT
    from repro_torch.runtime.driver import CrashInjector, DriverConfig, run

    cfg = CONFIG.replace(num_layers=DRIVER["layers"], dtype="float32")
    tcfg = train_config(DRIVER["steps"])
    data = train_stream(batch=DRIVER["batch"], seq=DRIVER["seq"])
    step_fn = RT.make_train_step(cfg, tcfg)

    def fresh():
        return RT.init_state(cfg, tcfg, generator=generator(0, "cuda"),
                             device="cuda")

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    state = fresh()
    want = []
    for step in range(DRIVER["steps"]):
        state, met = step_fn(state, data.device_batch(step))
        want.append(float(met["loss"]))
    del state, met
    dcfg = DriverConfig(total_steps=DRIVER["steps"],
                        checkpoint_every=DRIVER["every"], keep=1,
                        checkpoint_dir=str(TRAIN_DIR / "driver"))
    crash = CrashInjector(at_step=DRIVER["crash"])
    state = fresh()
    t0 = time.perf_counter()
    crashed = None
    try:
        run(state, step_fn, data, dcfg, crash=crash, log=lambda *a: None)
    except RuntimeError as e:
        crashed = str(e)
    check(crashed == f"injected crash at step {DRIVER['crash']}",
          f"[train-driver] the injected crash did not fire as it should: "
          f"{crashed!r}")
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run(state, step_fn, data, dcfg, crash=crash, log=lambda *a: None)
    second_s = time.perf_counter() - t0
    got = {m["step"]: m["loss"] for m in res["metrics"]}
    check(res["resumed_at"] == DRIVER["every"]
          and sorted(got) == list(range(DRIVER["every"] + 1,
                                        DRIVER["steps"] + 1)),
          f"[train-driver] resumed at {res['resumed_at']}, steps "
          f"{sorted(got)}")
    for step, loss in got.items():
        check(abs(loss - want[step - 1]) <= 1e-5 * abs(want[step - 1]),
              f"[train-driver] step {step}: loss {loss} != uninterrupted "
              f"{want[step - 1]} (rtol 1e-5)")
    size = sum(f.stat().st_size for f in (TRAIN_DIR / "driver").rglob("*")
               if f.is_file())
    print(f"[train-driver] {DRIVER['layers']} layers: crash at step "
          f"{DRIVER['crash']}, restart resumed at {res['resumed_at']}; losses "
          f"{[got[s] for s in sorted(got)]} == uninterrupted "
          f"{want[DRIVER['every']:]} (rtol 1e-5); run {first_s:.1f}s to the "
          f"crash, {second_s:.1f}s resumed; checkpoint {size / 2**30:.2f} GiB",
          flush=True)
    resumed_at = res["resumed_at"]
    del state, res
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = LT.main(["--arch", "gemma_2b", "--smoke", "--steps", "12",
                   "--checkpoint-dir", str(TRAIN_DIR / "cli")])
    cli_s = time.perf_counter() - t0
    dev = next(iter(cli["state"]["opt"]["m"].values())).device
    losses = [m["loss"] for m in cli["metrics"]]
    check(dev.type == "cuda" and len(losses) == 12
          and all(math.isfinite(v) for v in losses),
          f"[train-cli] ran on {dev}, losses {losses}")
    print(f"[train-cli] python -m repro_torch.launch.train --arch gemma_2b "
          f"--smoke --steps 12: on {dev}, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} in {cli_s:.1f}s", flush=True)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return dict(uninterrupted=want, resumed=got, resumed_at=resumed_at,
                crash_s=first_s, resume_s=second_s, checkpoint_bytes=size,
                cli=dict(losses=losses, s=cli_s))


def phase_train():
    """Training (``repro_torch.optim``, ``runtime.train``, ``runtime.driver``,
    ``launch.train``): full-width gemma-2b trained, quantized and served;
    the card against the CPU; the driver and the CLI."""
    import torch

    from repro_torch.configs.gemma_2b import CONFIG

    t0 = time.perf_counter()
    state, out = train_full()
    model = state.pop("params")
    del state  # the moments: the served model keeps only its weights
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = train_serve(model, CONFIG)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["card_cpu"] = train_card_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    out["driver"] = train_driver()
    out["phase_s"] = time.perf_counter() - t0
    print(f"[train] phase {out['phase_s']:.1f}s", flush=True)
    return out


# ------------------------------------------------------- the mesh phases
MESH_SIZES = (2, 4)  # the model axis of the in-process kernel check
# d=3 / scale_block=36 splits no gemma-2b contraction on a shard boundary
# (1024 and 8192 are no multiples of 36), so every row-parallel check
# also runs at d=2 / scale_block=32, where shard_spec_for does derive
# k-sharded wo and down
MESH_ROW_SPEC = dict(d=2, scale_block=32)
MESH_NEAR_TIE = 1e-4  # relative gap of the single-device top two


class ShapeMesh:
    """A mesh's axis sizes alone (what shard_spec_for reads)."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def mesh_gemm_case(mode, name, m, k, n, *, d, sb, seed=0):
    """One gemma-2b GeMM at b = 4 under the ``model=n`` spec that
    ``shard_spec_for`` derives: every rank's local kernel call held to its
    plain version (the existing gate), the row-parallel ones also at
    ``pipeline_chunks = 2``; the ranks' outputs concatenated
    (column-parallel) or their partials summed in rank order
    (row-parallel), within 1e-5 of max |y| of the unsharded kernel's
    output; device ms of a local call (every rank's, and every chunk's,
    has the same shape: rank 0's first is timed) beside the unsharded
    call's.  None when the spec leaves the linear whole (nothing local to
    run)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.core.spec import QuantSpec
    from repro_torch.dispatch.shard import shard_spec_for
    from repro_torch.distributed.sharding import LINEAR_AXES
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import msgemm as ms
    from repro_torch.kernels import ops

    b = 4
    storage = "packed_u8" if mode == "int4_dequant" else "packed_idx"
    spec = QuantSpec(mode=mode, d=d, scale_block=sb, storage=storage)
    s = shard_spec_for(spec, LINEAR_AXES[name], m, k, b,
                       ShapeMesh(model=n), rules="serve")
    if s is None:
        return None
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, 16, (m, k), generator=g, device="cuda",
                          dtype=torch.uint8)
    sc = torch.rand((m, -(-k // sb)), generator=g, device="cuda") + 0.1
    x = torch.randn((k, b), generator=g, device="cuda")
    kw = dict(act="none", bias=None, residual=None, out_dtype=torch.float32)
    if mode == "msgemm":
        w = packing.pack_indices(codes, d).contiguous()
        values = packing.b_values(torch.float32, "cuda")
        per = d  # k per weight column

        def kernel(w_, sc_, x_):
            return ms.msgemm_cuda(w_, x_, sc_, values, d=d, scale_block=sb,
                                  tiles=ops.msgemm_tiles(
                                      w_.shape[0], w_.shape[1], b, d, sb),
                                  **kw)

        def plain(w_, sc_, x_):
            return ms.msgemm_plain(w_, x_, sc_, values, d=d, scale_block=sb,
                                   tiles=ops.msgemm_tiles(
                                       w_.shape[0], w_.shape[1], b, d, sb),
                                   **kw)
    else:
        w = packing.pack_storage(codes).contiguous()
        per = 2

        def kernel(w_, sc_, x_):
            return i4.int4_matmul_cuda(
                w_, sc_, x_, scale_block=sb,
                tiles=ops.int4_tiles(w_.shape[0], x_.shape[0], b), **kw)

        def plain(w_, sc_, x_):
            return i4.int4_matmul_plain(
                w_, sc_, x_, scale_block=sb,
                tiles=ops.int4_tiles(w_.shape[0], x_.shape[0], b), **kw)

    def timed(w_, sc_, x_):
        nbytes = w_.numel() * w_.element_size()
        copies = ops.copies_past_l2(nbytes)
        ws = [w_] + [w_.clone() for _ in range(copies - 1)]
        return device_ms([lambda a=a: kernel(a, sc_, x_) for a in ws],
                         reps=max(20, 2 * copies))

    whole = kernel(w, sc, x)
    out = dict(mode=mode, name=name, m=m, k=k, b=b, d=d, scale_block=sb,
               model=n, spec=s.tag(), ms=timed(w, sc, x), local=[])
    # pipeline_chunks=2 as shard_spec_for clamps it for this local k
    chunkings = sorted({1, shard_spec_for(
        spec, LINEAR_AXES[name], m, k, b, ShapeMesh(model=n), rules="serve",
        pipeline_chunks=2).pipeline_chunks}) if s.k else (1,)
    ymax = float(whole.abs().max())
    for pc in chunkings:
        parts, errs, local_ms = [], [], []
        for r in range(n):
            if s.m:
                ml = m // n
                w_r, sc_r, x_r = (w[r * ml:(r + 1) * ml],
                                  sc[r * ml:(r + 1) * ml], x)
                pieces = [(w_r, sc_r, x_r)]
            else:
                kl = k // n
                w_r = w[:, r * kl // per:(r + 1) * kl // per]
                sc_r = sc[:, r * kl // sb:(r + 1) * kl // sb]
                x_r = x[r * kl:(r + 1) * kl]
                kc = kl // pc
                pieces = [(w_r[:, c * kc // per:(c + 1) * kc // per]
                           .contiguous(),
                           sc_r[:, c * kc // sb:(c + 1) * kc // sb]
                           .contiguous(),
                           x_r[c * kc:(c + 1) * kc].contiguous())
                          for c in range(pc)]
            y_r = None
            for w_c, sc_c, x_c in pieces:
                w_c, sc_c = w_c.contiguous(), sc_c.contiguous()
                got = kernel(w_c, sc_c, x_c)
                want = plain(w_c, sc_c, x_c)
                torch.testing.assert_close(
                    got, want, **FLOAT_TOL,
                    msg=lambda m_: f"[mesh-kernels {mode} {name} model={n} "
                                   f"rank {r} pc={pc}] kernel vs plain: {m_}")
                errs.append(float((got - want).abs().max()))
                if not local_ms:  # every rank's call has this shape
                    local_ms.append(timed(w_c, sc_c, x_c))
                y_r = got if y_r is None else y_r + got
            parts.append(y_r)
        comb = torch.cat(parts, 0) if s.m else sum(parts[1:], parts[0])
        err = float((comb - whole).abs().max())
        check(err <= 1e-5 * ymax,
              f"[mesh-kernels {mode} {name} model={n} pc={pc}] combined "
              f"output {err:.3e} from the unsharded kernel's (max |y| "
              f"{ymax:.3e})")
        out["local"].append(dict(pipeline_chunks=pc, calls=len(errs),
                                 max_abs_err=max(errs), combined_err=err,
                                 ymax=ymax, local_ms=local_ms[0]))
        print(f"[mesh-kernels {mode} d{d} {name:4s} model={n} pc={pc}] "
              f"{s.tag()}: {len(errs)} local calls, kernel vs plain "
              f"{max(errs):.2e}, combined vs unsharded {err:.2e} (max |y| "
              f"{ymax:.2e}); ms: unsharded {out['ms']:.4f}, a local call "
              f"{local_ms[0]:.4f}", flush=True)
    return out


def phase_mesh_kernels():
    """The kernels at the local shapes a tensor-parallel gemma-2b gives them
    (:func:`mesh_gemm_case`): msGeMM and int4 weights, d=3 /
    scale_block=36 (the served spec: column-parallel wq, wk, wv, gate,
    up; wo and down whole) and the row-parallel wo and down at
    ``MESH_ROW_SPEC``, under model=2 and model=4."""
    cases, whole = [], []
    for mode in ("msgemm", "int4_dequant"):
        for name, m, k, _ in GEMMA_GEMMS:
            for n in MESH_SIZES:
                c = mesh_gemm_case(mode, name, m, k, n, d=3, sb=36)
                if c is None:
                    whole.append(f"{mode} {name} model={n}")
                else:
                    cases.append(c)
                if name in ("wo", "down"):
                    c = mesh_gemm_case(mode, name, m, k, n,
                                       **{"d": MESH_ROW_SPEC["d"],
                                          "sb": MESH_ROW_SPEC["scale_block"]})
                    check(c is not None and "k=model" in c["spec"],
                          f"[mesh-kernels] {mode} {name} model={n} is not "
                          f"row-parallel at {MESH_ROW_SPEC}")
                    cases.append(c)
    # the recurrent blocks' msGeMM projections at their shard shapes
    # (model=2): jamba's Mamba (d_inner 8192) and xlstm's mLSTM (xl_inner
    # 4096), the served d=3 spec, the row-parallel ones also at
    # MESH_ROW_SPEC (at d=3 their local contraction splits no scale block)
    for name, m, k in (("in_proj", 16384, 4096), ("x_proj", 288, 8192),
                       ("out_proj", 4096, 8192), ("xl_up", 8192, 2048),
                       ("xl_o", 4096, 2048), ("xl_down", 2048, 4096)):
        c = mesh_gemm_case("msgemm", name, m, k, 2, d=3, sb=36)
        if c is None:
            whole.append(f"msgemm {name} model=2")
            c = mesh_gemm_case("msgemm", name, m, k, 2,
                               d=MESH_ROW_SPEC["d"],
                               sb=MESH_ROW_SPEC["scale_block"])
            check(c is not None and "k=model" in c["spec"],
                  f"[mesh-kernels] msgemm {name} is not row-parallel at "
                  f"{MESH_ROW_SPEC}")
        cases.append(c)
    print(f"[mesh-kernels] {len(cases)} sharded cases held; whole (no "
          f"aligned split): {', '.join(whole)}", flush=True)
    # the expert stack a rank holds where 'model' splits the experts:
    # qwen2-moe's up and down at E/2 = 30; then the stacks the 'default'
    # rules keep cut over 'data' along their out dim (the tokens move to
    # them), at the shapes param_specs gives a rank, with the 16 slots of
    # a decode step that every 'data' rank's tokens fill
    specs = [(f"qwen2-moe-{name}-E30", (30, m, k))
             for name, m, k in (("up", 1408, 2048), ("down", 2048, 1408))]
    for mesh_name, stacks in moe_shard_shapes().items():
        specs += [(f"qwen2-moe-{name}-{mesh_name}", shape)
                  for name, shape in stacks.items()]
    experts = [expert_case(name, E, m, k, 16, "none", seed=700 + i)
               for i, (name, (E, m, k)) in enumerate(specs)]
    for r in experts:
        print(f"[mesh-kernels experts] {r['name']} E={r['experts']} "
              f"m={r['m']} k={r['k']} b={r['b']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms, "
              f"kernel vs plain {r['max_abs_err']:.3g} (exact inputs "
              f"{r['exact_max_abs_err']:.3g})", flush=True)
    return dict(cases=cases, whole=whole, experts=experts)


# the meshes qwen2-moe is served on under the 'default' rules: its expert
# stacks' out dim takes 'data' on both (no 'model' axis; 'ep' on model=2)
MESH_MOE_FSDP = (((2,), ("data",)), ((2, 2), ("data", "model")))


def mesh_name(shape, axes) -> str:
    return ",".join(f"{a}={n}" for a, n in zip(axes, shape))


def moe_shard_shapes() -> dict:
    """{mesh: {'up/gate' | 'down': (E, m, k)}}: the block of qwen2-moe's
    dense expert stacks a rank holds under the 'default' rules on each
    mesh of ``MESH_MOE_FSDP`` (``sharding.param_specs``, the out dim cut
    over 'data', the experts over 'model')."""
    from repro_torch.configs.qwen2_moe import CONFIG
    from repro_torch.distributed import sharding

    E, d, f = CONFIG.num_experts, CONFIG.d_model, CONFIG.moe_d_ff
    whole = {"blocks.0.moe.experts.up.w": (E, f, d),
             "blocks.0.moe.experts.down.w": (E, d, f)}
    out = {}
    for shape, axes in MESH_MOE_FSDP:
        mesh = ShapeMesh(**dict(zip(axes, shape)))
        specs = sharding.param_specs(whole, mesh, "default")
        local = {n.split(".")[-2]: sharding.local_shape(s, specs[n], mesh)
                 for n, s in whole.items()}
        out[mesh_name(shape, axes)] = {"up/gate": local["up"],
                                       "down": local["down"]}
    return out


def mesh_reference():
    """The main phase's run (msgemm gemma-2b, f32 pool, graph route) with
    each token's single-device logits, for ``--only mesh``."""
    import gc

    import torch

    from repro_torch.core.spec import QuantSpec

    model, cfg, _, _ = build_gemma(QuantSpec(mode="msgemm", d=3,
                                             scale_block=36))
    run = serve("mesh-ref", model, cfg, keep_logits=True)
    run["top2_rel"] = top2_gaps(run.pop("logits"))
    run.pop("reqs")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return run


def top2_gaps(logits):
    """{rid: [(top1 - top2) / |top1| of each token's logits row]}."""
    import torch

    out = {}
    for rid, rows in logits.items():
        top = torch.stack(rows).topk(2, dim=-1).values
        out[rid] = ((top[:, 0] - top[:, 1]) / top[:, 0].abs()).tolist()
    return out


MESH_COLL_SHAPE = (4, 2048)  # a decode step's rows of a gemma-2b width


def mesh_coll_input(rank):
    """Rank ``rank``'s integer-valued input to the collective check (sums
    of such values are exact in any order)."""
    import torch

    g = torch.Generator().manual_seed(1000 + rank)
    return torch.randint(-64, 65, MESH_COLL_SHAPE, generator=g).float()


def mesh_collectives(device):
    """Every collective of ``distributed.collectives`` on a CUDA tensor
    over the model axis (the group's own and the rings), on this rank's
    :func:`mesh_coll_input`: {name: result on the host}."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding

    mesh = sharding.active_mesh()
    y = mesh_coll_input(sharding.coord(mesh, "model")).to(device)
    out = {}
    for name in ("psum", "ring_psum"):
        out[name] = getattr(coll, name)(y, "model")
    for name in ("psum_scatter", "ring_reduce_scatter", "all_gather",
                 "ring_all_gather"):
        out[name] = getattr(coll, name)(y, "model", dim=-1)
    check(all(t.device == y.device for t in out.values()),
          "[mesh] a collective returned off the rank's device")
    return {k: v.cpu() for k, v in out.items()}


def mesh_rank(rank, device, seed):
    """One rank of the two-rank engine (``launch.mesh.run_ranks``): its
    copy of full gemma-2b with msgemm weights from ``seed``, drawn on
    ``device`` a block at a time for a model=2 mesh
    (``runtime.serve.init_shard``), serving the main phase's stream
    eagerly.  Every kernel's launches and the collectives are counted
    over the run alone."""
    import torch

    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.core.spec import QuantSpec
    from repro_torch.device import generator
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import serve as SV

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    t0 = time.perf_counter()
    mesh = make_mesh((2,), ("model",))
    model = SV.init_shard(CONFIG, mesh, generator=generator(seed, device),
                          device=device, quant=spec)
    cfg = CONFIG.replace(quant=spec)
    with sharding.use(mesh, "serve"):
        collectives = mesh_collectives(device)
    engine = make_engine(model, cfg, mesh=mesh, cuda_graph=False)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    n_plans = len(engine.exec_plans)
    n_sharded = sum(p.shard is not None for p in engine.exec_plans.values())
    return dict(rank=rank, device=str(device), build_s=build_s,
                transport=coll.transport(), collective_check=collectives,
                plans=n_plans, sharded=n_sharded,
                **_engine_run(engine, cfg, device))


def phase_mesh_engine(ref, card, devices=("cuda:0", "cuda:0"),
                      tag="mesh"):
    """Two ranks on ``devices`` with a model=2 mesh (one process each):
    sharing ``cuda:0``, joined by gloo with host-staged collectives; on
    two cards, by NCCL.  Each holds its shards of full-width gemma-2b
    msgemm (f32 pool) and serves the main phase's 6-request stream
    eagerly: tokens == the main phase's (a step where they differ must be
    a single-device near-tie, top two within ``MESH_NEAR_TIE`` relative;
    counted), 126 msGeMM launches a step on each rank and no
    paged-attention one; collectives a step by kind, each rank's step ms
    and peak GiB beside the card."""
    from repro_torch.distributed.collectives import NCCL, STAGED
    from repro_torch.launch.mesh import run_ranks

    devices = list(devices)
    want_transport = STAGED if len(set(devices)) == 1 else NCCL
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, 2, 0, devices=devices, timeout=600)
    wall_s = time.perf_counter() - t0
    lead = ranks[0]
    check([r["device"] for r in ranks] == devices,
          f"[{tag}] ranks ran on {[r['device'] for r in ranks]}")
    check(all(r["transport"] == want_transport for r in ranks),
          f"[{tag}] transport {[r['transport'] for r in ranks]} != "
          f"{want_transport}")
    import torch

    xs = [mesh_coll_input(r) for r in range(2)]
    total, half = xs[0] + xs[1], MESH_COLL_SHAPE[-1] // 2
    for r in ranks:
        want = dict(psum=total, ring_psum=total,
                    psum_scatter=total[:, r["rank"] * half:
                                       (r["rank"] + 1) * half],
                    all_gather=torch.cat(xs, dim=-1))
        want["ring_reduce_scatter"] = want["psum_scatter"]
        want["ring_all_gather"] = want["all_gather"]
        got = r.pop("collective_check")  # tensors: not for the report
        for name, t in want.items():
            check(torch.equal(got[name], t),
                  f"[{tag}] rank {r['rank']}: {name} over {lead['transport']}"
                  " differs from the sum or concatenation of the inputs")
    print(f"[{tag}] every collective (psum, psum_scatter, all_gather and "
          f"the three rings) on a {MESH_COLL_SHAPE} CUDA tensor == the "
          f"sum or concatenation of the ranks' inputs, exactly", flush=True)
    diff_steps = _near_ties(tag, ref, lead["tokens"], lead["status"])
    ties = len(diff_steps)
    for r in ranks:
        check(r["tokens"] == lead["tokens"],
              f"[{tag}] rank {r['rank']} returned other tokens")
        want = dict(msgemm=126 * r["steps"], paged_attention=0,
                    int4_matmul=0, flash_attention=0)
        check(r["launches"] == want,
              f"[{tag}] rank {r['rank']} launches {r['launches']} != {want} "
              f"over {r['steps']} steps")
    per_step = {k: v / lead["steps"] for k, v in lead["collectives"].items()}
    for r in ranks:
        print(f"[{tag}] rank {r['rank']} on {r['device']}: build "
              f"{r['build_s']:.1f}s, {r['steps']} steps in {r['run_s']:.2f}s "
              f"({r['step_ms']:.2f} ms a step), peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; launches {r['launches']}",
              flush=True)
    where = "one card" if len(set(devices)) == 1 else "two cards"
    print(f"[{tag}] 2 ranks on {where} ({card}), transport "
          f"{lead['transport']}: {lead['plans']} plans resolved at build, "
          f"{lead['sharded']} sharded; collectives a step "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(per_step.items()))
          + f"; tokens == the main phase's on {6 - ties}/6 requests, "
          f"{ties} near-tie steps {diff_steps}; phase wall {wall_s:.1f}s",
          flush=True)
    return dict(ranks=ranks, wall_s=wall_s, near_ties=ties,
                near_tie_steps=diff_steps, collectives_a_step=per_step,
                launches=dict(msgemm=sum(r["launches"]["msgemm"]
                                         for r in ranks)))


def phase_calib_moe():
    """Calibration of expert stacks (the repair of this slice) on the card:
    qwen2-moe at full width, 2 layers (the serve CLI's ``--num-layers``
    cut), dense weights from seed 0; the learned aggregate weighted error
    at most the uniform one, one (60, 16) table an expert stack; the
    calibrated model served through the engine (graph route), its dense
    linears on msGeMM with their tables and its learned expert stacks on
    ``int4_torch`` (no int4 kernel launch); the experts' device ms a step
    from GeMM marks, beside the kernel's 43.36 ms of a full 24-layer
    qwen2-moe step (PERF.md §5)."""
    import gc

    import torch

    from repro_torch import calib
    from repro_torch.configs.qwen2_moe import CONFIG
    from repro_torch.core.spec import QuantSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.device import generator
    from repro_torch.models import transformer

    cfg = CONFIG.replace(num_layers=2)
    dense = transformer.init_params(cfg, generator=generator(0, "cuda"),
                                    device="cuda")
    stream = SyntheticStream(DataConfig(**dict(
        CALIB_DATA, vocab_size=cfg.vocab_size)))
    res, line = timed_calibrate(
        "calib-moe", dense, cfg, stream,
        calib.Recipe(calib_steps=2, kmeans_iters=8, sample_limit=1 << 17),
        QuantSpec(mode="msgemm", d=3, scale_block=36))
    del dense
    gc.collect()
    check(line["learned_weighted_err"] <= line["uniform_weighted_err"],
          "[calib-moe] learned aggregate error above the uniform grid's")
    for layer in range(cfg.num_layers):
        for lin in ("up", "gate", "down"):
            cb = res.codebooks[f"blocks.{layer}.moe.experts.{lin}"]
            check(tuple(cb.shape) == (cfg.num_experts, 16),
                  f"[calib-moe] {lin} of layer {layer}: tables "
                  f"{tuple(cb.shape)}")
    check_learned_tables("calib-moe", res)
    qcfg = cfg.replace(quant=res.quant)
    ms_step, i4_step = moe_launches(cfg)
    run = serve("calib-moe", res.params, qcfg)
    want = dict(msgemm=ms_step * run["steps"], int4_matmul=0,
                paged_attention=0, flash_attention=0)
    check(run["launches"] == want,
          f"[calib-moe] launches {run['launches']} != {want} (learned "
          "expert stacks run int4_torch)")
    run.pop("reqs")
    prof = moe_profile("calib-moe", res.params, qcfg)
    experts = prof["ms_a_step"]["experts"]
    print(f"[calib-moe] served: {run['steps']} steps, {run['step_ms']:.2f} "
          f"ms a step; learned expert stacks on int4_torch "
          f"{experts:.3f} ms a step over {cfg.num_layers} layers "
          f"({experts / cfg.num_layers:.3f} a layer), the uniform stacks' "
          f"int4 kernel 43.36 ms a 24-layer step ({43.36 / 24:.3f} a layer; "
          "PERF.md §5)", flush=True)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return dict(calib=line, serve=run, profile=prof)


# -------------------------------------------- every family served on a mesh
# qwen2-moe at full width, 2 layers: the paged engine on two ranks sharing
# cuda:0 (60 experts at model=2: expert-parallel, 30 a rank)
MESH_MOE_LAYERS = 2
# (arch, depth) of the static engine on a mesh, full width: 2 layers, or
# the one period of a block pattern that holds each block kind (jamba's 8:
# Mamba, Mamba + MoE, attention; xlstm's 8: 7 mLSTM and an sLSTM; a
# depth must be a whole number of periods); whisper's encoder at 2 too
MESH_STATIC = (("gemma_2b", 2), ("jamba_v01", 8), ("xlstm_1b3", 8),
               ("whisper_medium", 2), ("phi3_vision", 2))
# gemma-2b with two kv heads: they take 'model', so the decode cache splits
# its heads, not its sequence: the same step without the split softmax
MESH_STATIC_KV2 = "gemma_2b kv2"
# a family's logits on the mesh within this share of the single device's
# largest |logit| too (readings on an NVIDIA H100 80GB HBM3 at 700 W:
# 1.35e-7 to 7.54e-7, one or two f32 ulps; gemma-2b's logits reach 3,610,
# so its F32_STATE_TOL binds, the others' this)
MESH_STATIC_REL_TOL = 1e-5
# the split softmax (layers._sdpa_split) against layers._sdpa on the same
# inputs, at gemma-2b's decode shapes with logits in the hundreds: within
# this share of the largest |v| (an attention output is a convex
# combination of v's rows)
SPLIT_SOFTMAX_TOL = 1e-5
MESH_STATIC_BATCH, MESH_STATIC_PROMPT, MESH_STATIC_NEW = 4, 16, 8
MESH_STATIC_FRAMES = 16  # whisper's stub frames, the serve CLI's


def moe_mesh_cfg(layers=MESH_MOE_LAYERS):
    from repro_torch.configs.qwen2_moe import CONFIG
    from repro_torch.core.spec import QuantSpec

    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    return CONFIG.replace(num_layers=layers), spec


def mesh_moe_rank(rank, device, seed):
    """One rank of the two-rank MoE engine: its copy of full-width
    qwen2-moe at ``MESH_MOE_LAYERS`` layers with msgemm weights from
    ``seed``, drawn on ``device`` a block at a time for a model=2 mesh
    (expert-parallel), serving the main phase's stream eagerly;
    launches, collectives and the routed-slot counters over the run
    alone."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as M
    from repro_torch.runtime import serve as SV

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg0, spec = moe_mesh_cfg()
    t0 = time.perf_counter()
    mesh = make_mesh((2,), ("model",))
    counted = SV.init_shard(cfg0, mesh, generator=generator(seed, device),
                            device=device, quant=spec)
    cfg = cfg0.replace(quant=spec)
    engine = make_engine(counted, cfg, mesh=mesh, cuda_graph=False)
    build_s = time.perf_counter() - t0
    for mod in KERNELS.values():
        mod.launches = 0
    M.reset_route_counts(counted)
    coll.reset_counts()
    steps0 = engine.runner.steps_run
    t0 = time.perf_counter()
    results = engine.run(request_stream(cfg))
    torch.cuda.synchronize(device)
    run_s = time.perf_counter() - t0
    steps = engine.runner.steps_run - steps0
    return dict(rank=rank, build_s=build_s, run_s=run_s, steps=steps,
                step_ms=run_s * 1e3 / max(steps, 1),
                launches={n: mod.launches for n, mod in KERNELS.items()},
                collectives=dict(coll.counts),
                dropped_frac=M.dropped_frac(counted),
                experts_a_rank=engine.params.blocks[0].moe.experts.up
                .scales.shape[0],
                tokens={rid: s.generated for rid, s in results.items()},
                status={rid: s.status for rid, s in results.items()})


def phase_mesh_moe(card, devices=("cuda:0", "cuda:0"), tag="mesh-moe"):
    """qwen2-moe served by the paged engine on two ranks on ``devices``
    (sharing cuda:0: gloo, host-staged; on two cards: NCCL): each rank
    holds 30 of the 60 experts and runs them in one int4 launch
    a projection (its dense linears msGeMM, as on one device); tokens ==
    the single-device engine's on the same weights (graph route), a
    differing step a single-device near-tie (top two within
    ``MESH_NEAR_TIE`` relative); every rank's ``dropped_frac`` equal to
    the single device's."""
    import torch

    from repro_torch.device import generator
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer

    cfg0, spec = moe_mesh_cfg()
    model = transformer.init_params(cfg0, generator=generator(0, "cuda"),
                                    device="cuda", quant=spec)
    cfg = cfg0.replace(quant=spec)
    ref = serve(f"{tag}-ref", model, cfg, keep_logits=True)
    gaps = ref["top2_rel"] = top2_gaps(ref.pop("logits"))
    ref.pop("reqs")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_moe_rank, 2, 0, devices=list(devices),
                      timeout=600)
    wall_s = time.perf_counter() - t0
    lead = ranks[0]
    ms, i4 = moe_launches(cfg)
    ties = []
    for rid, want in sorted(ref["tokens"].items()):
        got = lead["tokens"][rid]
        check(lead["status"][rid] == "ok" and len(got) == NEW_TOKENS,
              f"[{tag}] request {rid}: status {lead['status'][rid]}")
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
        if first is not None:
            gap = gaps[rid][first]
            check(gap <= MESH_NEAR_TIE,
                  f"[{tag}] request {rid} step {first}: token "
                  f"{got[first]} != {want[first]}, single-device top two "
                  f"{gap:.2e} apart (more than {MESH_NEAR_TIE})")
            ties.append((rid, first, gap))
    for r in ranks:
        check(r["tokens"] == lead["tokens"],
              f"[{tag}] rank {r['rank']} returned other tokens")
        check(r["dropped_frac"] == ref["dropped_frac"],
              f"[{tag}] rank {r['rank']} dropped_frac {r['dropped_frac']} "
              f"!= the single device's {ref['dropped_frac']}")
        check(r["experts_a_rank"] == cfg.num_experts // 2,
              f"[{tag}] rank {r['rank']} holds {r['experts_a_rank']} "
              "experts")
        want = dict(msgemm=ms * r["steps"], int4_matmul=i4 * r["steps"],
                    paged_attention=0, flash_attention=0)
        check(r["launches"] == want,
              f"[{tag}] rank {r['rank']} launches {r['launches']} != "
              f"{want} over {r['steps']} steps")
    per_step = {k: v / lead["steps"] for k, v in lead["collectives"].items()}
    where = "one card" if len(set(devices)) == 1 else "two cards"
    print(f"[{tag}] qwen2-moe {cfg.num_layers} layers, 2 ranks on {where} "
          f"({card}): {cfg.num_experts // 2} experts a rank, one int4 "
          f"launch a projection ({i4} a step), {ms} msGeMM a step; "
          f"{lead['steps']} steps at {lead['step_ms']:.2f} ms (single "
          f"device graph route {ref['step_ms']:.2f}); collectives a step "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(per_step.items()))
          + f"; dropped_frac {lead['dropped_frac']:.6f} (== single device "
          f"{ref['dropped_frac']:.6f}); tokens == the single device's on "
          f"{6 - len(ties)}/6 requests, near-tie steps {ties}; phase wall "
          f"{wall_s:.1f}s", flush=True)
    return dict(ranks=ranks, ref=ref, near_tie_steps=ties, wall_s=wall_s,
                collectives_a_step=per_step)


def mesh_moe_fsdp_rank(rank, device, seed, shape, axes):
    """One rank of qwen2-moe (``moe_mesh_cfg``, the mesh-moe phase's
    weights) under the 'default' rules on a ``shape`` / ``axes`` mesh: its
    copy drawn a block at a time (``runtime.serve.init_shard``), the
    expert stacks kept cut over 'data' along their out dim, serving the
    main stream eagerly.  Returns the run (``_engine_run``: tokens,
    launches, collectives by kind and bytes, step ms, peak), the build's
    bytes and peak, ``dropped_frac``, each stack's shape a rank and its
    ``data_out``, the leaves a step gathers (the blocks' and the head's
    ``fsdp`` records: their bytes a step, and any of them a stack's)."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as M
    from repro_torch.runtime import serve as SV

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg0, spec = moe_mesh_cfg()
    mesh = make_mesh(shape, axes)
    torch.cuda.reset_peak_memory_stats(device)
    model = SV.init_shard(cfg0, mesh, "default", generator=generator(
        seed, device), device=device, quant=spec)
    torch.cuda.synchronize(device)
    out = dict(rank=rank, built_bytes=torch.cuda.memory_allocated(device),
               build_peak_bytes=torch.cuda.max_memory_allocated(device))
    cfg = cfg0.replace(quant=spec)
    n = dict(zip(axes, shape))["data"]
    gathered = [f"{p}.{k}" for p, mod in model.named_modules()
                for k in getattr(mod, "fsdp", {}) if p]
    ex = model.blocks[0].moe.experts
    out.update(
        gathered_a_step=n * _resident(model, gathered),
        stacks_gathered=[k for k in gathered if sharding.is_stack(k)],
        data_out=[m.data_out for m in model.modules()
                  if isinstance(m, M.Experts)],
        stack_rows={name: tuple(getattr(ex, name).scales.shape[:2])
                    for name in ("up", "gate", "down")},
        resident=_resident(model))
    engine = make_engine(model, cfg, mesh=mesh, cuda_graph=False,
                         mesh_rules="default")
    M.reset_route_counts(model)  # the build's idle steps route too
    out.update(_engine_run(engine, cfg, device))
    out["dropped_frac"] = M.dropped_frac(model)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_mesh_moe_fsdp(card, ref):
    """qwen2-moe (``MESH_MOE_LAYERS``, msgemm dense linears, int4 expert
    stacks, f32 pool) served under the 'default' rules by ranks sharing ``cuda:0``
    over host-staged gloo, on data=2 (two ranks) and on (data=2,
    model=2) (four ranks, expert-parallel): each rank draws only its
    copy, and its expert stacks stay cut over 'data' along their out dim
    while the tokens move to them (``models.moe``).  Gates, each run:
    tokens == the single device's (``ref``, the mesh-moe phase's, under
    the near-tie rule), ``dropped_frac`` equal; a rank's launches a step
    the single device's (an int4 launch a stack and MoE layer, msGeMM as
    one device); no stack leaf among the leaves gathered for a step (the
    ``fsdp`` records), each stack held cut (``data_out``), and the
    ``fsdp_gather`` bytes of the run exactly those records' over its
    steps; the token collectives issued.  Prints each run's token
    collectives by kind and bytes a step, the step ms, the build and
    run peaks."""
    from repro_torch.launch.mesh import run_ranks

    cfg, _ = moe_mesh_cfg()
    ms, i4 = moe_launches(cfg)
    moved = ("expert_tokens", "expert_hidden", "expert_return")
    out = {}
    for shape, axes in MESH_MOE_FSDP:
        name = mesh_name(shape, axes)
        tag = f"mesh-fsdp qwen2-moe {name}"
        n = math.prod(shape)
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_moe_fsdp_rank, n, 0, shape, axes,
                          devices=["cuda:0"] * n, timeout=900)
        wall_s = time.perf_counter() - t0
        lead = ranks[0]
        ties = _near_ties(tag, ref, lead["tokens"], lead["status"])
        for r in ranks:
            check(r["tokens"] == lead["tokens"],
                  f"[{tag}] rank {r['rank']} returned other tokens")
            check(r["dropped_frac"] == ref["dropped_frac"],
                  f"[{tag}] rank {r['rank']} dropped_frac "
                  f"{r['dropped_frac']} != the single device's "
                  f"{ref['dropped_frac']}")
            want = dict(msgemm=ms * r["steps"], int4_matmul=i4 * r["steps"],
                        paged_attention=0, flash_attention=0)
            check(r["launches"] == want,
                  f"[{tag}] rank {r['rank']} launches {r['launches']} != "
                  f"{want} over {r['steps']} steps")
            check(not r["stacks_gathered"] and all(
                d == ("up", "gate", "down") for d in r["data_out"]),
                f"[{tag}] rank {r['rank']}: stacks gathered "
                f"{r['stacks_gathered']}, held cut {r['data_out']}")
            check(r["coll_bytes"].get("fsdp_gather", 0)
                  == r["steps"] * r["gathered_a_step"],
                  f"[{tag}] rank {r['rank']}: fsdp_gather "
                  f"{r['coll_bytes'].get('fsdp_gather', 0)} bytes over "
                  f"{r['steps']} steps, the records' "
                  f"{r['gathered_a_step']} a step")
            check(all(r["collectives"].get(k, 0) > 0 for k in moved),
                  f"[{tag}] rank {r['rank']}: token collectives "
                  f"{ {k: r['collectives'].get(k, 0) for k in moved} }")
        steps = lead["steps"]
        per_step = {k: (v / steps, lead["coll_bytes"][k] / steps)
                    for k, v in sorted(lead["collectives"].items())}
        for r in ranks:
            print(f"[{tag}] rank {r['rank']} ({card}): stacks a rank "
                  "(experts, rows) "
                  + ", ".join(f"{k} {v}" for k, v in r["stack_rows"].items())
                  + f", held cut {r['data_out'][0]}; resident "
                  f"{r['resident'] / 2**30:.3f} GiB; built "
                  f"{r['built_bytes'] / 2**30:.3f} GiB, build peak "
                  f"{r['build_peak_bytes'] / 2**30:.3f}, run peak "
                  f"{r['peak_bytes'] / 2**30:.3f}; {r['steps']} steps at "
                  f"{r['step_ms']:.2f} ms; launches {r['launches']}",
                  flush=True)
        print(f"[{tag}] {n} ranks on one card ({card}): a step "
              + ", ".join(f"{k} {c:.2f} ({b / 2**20:.3f} MiB)"
                          for k, (c, b) in per_step.items())
              + f"; fsdp_gather = the blocks' and head's records "
              f"({lead['gathered_a_step'] / 2**20:.2f} MiB a step, no "
              f"stack); dropped_frac {lead['dropped_frac']:.6f} (== single "
              f"device); tokens == the single device's on "
              f"{6 - len(ties)}/6 requests, near-tie steps {ties}; "
              f"{steps} steps at {lead['step_ms']:.2f} ms (single device "
              f"graph route {ref['step_ms']:.2f}); phase wall "
              f"{wall_s:.1f}s", flush=True)
        out[name] = dict(ranks=ranks, near_tie_steps=ties, wall_s=wall_s,
                         collectives_a_step=per_step)
    return out


def mesh_static_cfg(arch, layers, kv_heads=None):
    """(full-width config at ``layers`` layers, f32 activations, msgemm
    weights; the spec) of a ``MESH_STATIC`` entry, with ``kv_heads`` kv
    heads where given."""
    from repro_torch import configs
    from repro_torch.core.spec import QuantSpec

    cfg = configs.get_config(arch).replace(num_layers=layers,
                                           dtype="float32")
    if kv_heads is not None:
        cfg = cfg.replace(num_kv_heads=kv_heads)
    if cfg.is_encdec:
        cfg = cfg.replace(encoder_layers=layers)
    return cfg, QuantSpec(mode="msgemm", d=3, scale_block=36)


def mesh_static_batch(cfg, device, seed=1):
    import torch

    from repro_torch.device import generator

    g = generator(seed, device)
    B = MESH_STATIC_BATCH
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (B, MESH_STATIC_PROMPT), generator=g,
                                     device=device, dtype=torch.int32)}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((B, MESH_STATIC_FRAMES, cfg.d_model),
                                      generator=g, device=device)
    elif cfg.frontend == "image_patches":
        batch["patch_embeds"] = torch.randn((B, cfg.num_patches,
                                             cfg.d_model), generator=g,
                                            device=device)
    return batch


def mesh_static_rank(rank, device, seed):
    """One rank of the static engine on a model=2 mesh, for every
    ``MESH_STATIC`` model: the whole model from ``seed``, static
    ``generate`` on one device (rank 0 alone: its tokens and step
    logits), then this rank's ``shard_params`` copy through ``generate``
    on the mesh (launches and collectives over it alone)."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.runtime import serve as SV

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2,), ("model",))
    out = {"split_softmax": split_softmax_case(mesh, device)}
    cases = [(arch, arch, layers, None) for arch, layers in MESH_STATIC]
    cases.append((MESH_STATIC_KV2, "gemma_2b", 2, 2))
    for name, arch, layers, kv_heads in cases:
        cfg0, spec = mesh_static_cfg(arch, layers, kv_heads)
        t0 = time.perf_counter()
        model = transformer.init_params(
            cfg0, generator=generator(seed, device), device=device,
            quant=spec)
        cfg = cfg0.replace(quant=spec)
        batch = mesh_static_batch(cfg, device)
        r = dict(arch=arch, layers=layers)
        if rank == 0:
            one = []
            for mod in KERNELS.values():
                mod.launches = 0
            r["single"] = SV.generate(model, cfg, batch,
                                      max_new_tokens=MESH_STATIC_NEW,
                                      step_logits=one).tolist()
            r["single_launches"] = {n: m.launches
                                    for n, m in KERNELS.items()}
        local = SV.shard_params(model, cfg, mesh)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        r["build_s"] = time.perf_counter() - t0
        for mod in KERNELS.values():
            mod.launches = 0
        coll.reset_counts()
        many = []
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        r["mesh"] = SV.generate(local, cfg, batch,
                                max_new_tokens=MESH_STATIC_NEW, mesh=mesh,
                                step_logits=many).tolist()
        torch.cuda.synchronize(device)
        r["run_s"] = time.perf_counter() - t0
        r["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        r["launches"] = {n: m.launches for n, m in KERNELS.items()}
        r["collectives"] = dict(coll.counts)
        if rank == 0:
            # step 0 is the prefill's logits, the others decode steps'
            diffs = [float((a - b).abs().max()) for a, b in zip(many, one)]
            top = torch.stack(one, dim=1).float().topk(2, dim=-1).values
            r["diffs"] = diffs
            r["max_abs_diff"] = max(diffs)
            r["scale"] = max(float(t.abs().max()) for t in one)
            r["top2_gap"] = (top[..., 0] - top[..., 1]).tolist()
            r["finite"] = bool(all(t.isfinite().all() for t in many))
        del local, many
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = r
    return out


def split_softmax_case(mesh, device, seed=5):
    """``layers._sdpa_split`` on this rank's half of the key positions
    against ``layers._sdpa`` on all of them, the same inputs on both
    ranks: gemma-2b's decode shapes (4 rows, 8 query heads over its one
    kv head of 256, the mesh-static cache's 24 positions), q scaled so the
    logits reach the hundreds, each row's last position drawn (a rank's
    block fully masked in some rows).  Returns the largest difference and
    the largest |v|."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed import sharding
    from repro_torch.models import layers as L

    cfg, _ = mesh_static_cfg("gemma_2b", 2)
    g = generator(seed, device)
    B, H, dh = MESH_STATIC_BATCH, cfg.num_heads, cfg.head_dim
    S = MESH_STATIC_PROMPT + MESH_STATIC_NEW
    q = 100 * torch.randn((B, 1, H, dh), generator=g, device=device)
    k = torch.randn((B, S, 1, dh), generator=g, device=device)
    v = torch.randn((B, S, 1, dh), generator=g, device=device)
    pos = torch.randint(0, S, (B,), generator=g, device=device)
    r, n = sharding.coord(mesh, sharding.TP_AXIS), S // 2
    whole = L.view_mask(S, pos[:, None])[:, None, None, 0]
    mine = L.view_mask(n, pos[:, None] - r * n)[:, None, None, 0]
    with sharding.use(mesh, "serve"):
        got = L._sdpa_split(cfg, q, k[:, r * n:(r + 1) * n],
                            v[:, r * n:(r + 1) * n], mine,
                            sharding.TP_AXIS)
    want = L._sdpa(cfg, q, k, v, whole)
    top = (q.reshape(B, H, dh) @ k[:, :, 0].transpose(1, 2)).abs().max()
    return dict(max_abs_err=float((got - want).abs().max()),
                v_max=float(v.abs().max()),
                logit_max=float(top) * dh**-0.5)


def phase_mesh_static(card, devices=("cuda:0", "cuda:0"),
                      tag="mesh-static"):
    """The static engine on a mesh (``runtime.serve.generate(mesh=)``),
    two ranks sharing cuda:0: full-width gemma-2b (one kv head: the
    decode cache splits its sequence), jamba (each block kind once), xlstm
    (7 mLSTM and the sLSTM), whisper (16 frames) and phi-3-vision, at 2
    layers or the depth named in ``MESH_STATIC``, msgemm weights, f32
    activations, batch 4 x 16, and gemma-2b with two kv heads (its cache
    split by heads: the same step without the split softmax).  Held
    against the single-device static ``generate`` on the same weights with
    the static path's gate (§2 of PERF.md): every step's logits within
    ``F32_STATE_TOL`` and within ``MESH_STATIC_REL_TOL`` of the largest
    |logit|, finite; its tokens equal, a differing token only where the
    single-device top two are within ``2 * F32_STATE_TOL``; each rank
    launches the weight kernels the single device does.  The split
    softmax alone is held against one device's within
    ``SPLIT_SOFTMAX_TOL`` (:func:`split_softmax_case`).  Every rank's
    prefill splits the residual's positions over 'model' (its blocks'
    ``seq_in_gather`` counted, no output gathered).  Printed: each
    rank's peak GiB over the run, the collectives by kind."""
    from repro_torch.distributed.collectives import SEQ_IN
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(mesh_static_rank, 2, 0, devices=list(devices),
                      timeout=900)
    wall_s = time.perf_counter() - t0
    lead = ranks[0]
    sm = [r["split_softmax"] for r in ranks]
    for r, s in enumerate(sm):
        check(s["max_abs_err"] <= SPLIT_SOFTMAX_TOL * s["v_max"],
              f"[{tag}] rank {r}: the split softmax {s['max_abs_err']:.3g} "
              f"from one device's (more than {SPLIT_SOFTMAX_TOL} of "
              f"|v| {s['v_max']:.3g})")
    print(f"[{tag}] split softmax (2 ranks' halves of 24 positions) vs "
          f"one device's, logits up to {sm[0]['logit_max']:.1f}: "
          f"{max(s['max_abs_err'] for s in sm):.3g} (at most "
          f"{SPLIT_SOFTMAX_TOL} of |v| {sm[0]['v_max']:.3g})", flush=True)
    for arch in [a for a, _ in MESH_STATIC] + [MESH_STATIC_KV2]:
        r = lead[arch]
        check(r["finite"], f"[{tag} {arch}] non-finite logits")
        limit = min(F32_STATE_TOL, MESH_STATIC_REL_TOL * r["scale"])
        check(r["max_abs_diff"] <= limit,
              f"[{tag} {arch}] logits {r['max_abs_diff']:.3g} from "
              f"the single device's (more than {limit:.3g}: "
              f"{F32_STATE_TOL}, or {MESH_STATIC_REL_TOL} of the largest "
              f"|logit| {r['scale']:.4g})")
        for row, (got, want) in enumerate(zip(r["mesh"], r["single"])):
            first = next((i for i, (a, b) in enumerate(zip(got, want))
                          if a != b), None)
            check(first is None or r["top2_gap"][row][first]
                  <= 2 * F32_STATE_TOL,
                  f"[{tag} {arch}] row {row} step {first}: token "
                  f"{got[first] if first is not None else None} != "
                  f"{want[first] if first is not None else None}, not a "
                  "near-tie")
        for other in ranks:
            check(other[arch]["mesh"] == r["mesh"],
                  f"[{tag} {arch}] ranks returned other tokens")
            c = other[arch]["collectives"]
            check(c.get(SEQ_IN, 0) > 0 and "seq_out_gather" not in c,
                  f"[{tag} {arch}] the prefill did not split the residual "
                  f"over 'model' ({c})")
            check(other[arch]["launches"] == r["single_launches"],
                  f"[{tag} {arch}] rank launches "
                  f"{other[arch]['launches']} != one device's "
                  f"{r['single_launches']}")
        same = sum(a == b for a, b in zip(r["mesh"], r["single"]))
        steps = MESH_STATIC_NEW
        print(f"[{tag} {arch}] {r['layers']} layers, 2 ranks on "
              f"{'one card' if len(set(devices)) == 1 else 'two cards'} "
              f"({card}): tokens == one device's on {same}/"
              f"{len(r['mesh'])} rows, logits within "
              f"{r['max_abs_diff']:.3g} (at most {limit:.3g}; "
              f"prefill step {r['diffs'][0]:.3g}, decode steps "
              f"{max(r['diffs'][1:]):.3g}; largest |logit| "
              f"{r['scale']:.4g}, diff/|logit| "
              f"{r['max_abs_diff'] / r['scale']:.3g}); "
              f"generate {r['run_s'] * 1e3 / steps:.2f} ms a token step "
              f"({r['run_s']:.2f}s for {steps} tokens, build "
              f"{r['build_s']:.1f}s), peak "
              + "/".join(f"{o[arch]['peak_bytes'] / 2**30:.3f}"
                         for o in ranks)
              + f" GiB a rank; launches {r['launches']}; "
              "collectives "
              + ", ".join(f"{k} {v}" for k, v in
                          sorted(r["collectives"].items())), flush=True)
    print(f"[{tag}] 5 families and {MESH_STATIC_KV2} held; phase wall "
          f"{wall_s:.1f}s", flush=True)
    return dict(ranks=ranks, wall_s=wall_s)


# --------------------------- the layout tuner and FSDP storage (on a mesh)
# full-width gemma-2b cut to 1 layer (the cut from 2 pays for
# [mesh-seq ...]) with msgemm weights at MESH_ROW_SPEC (at d=3 /
# scale_block 36 neither wo's nor down's contraction splits on model=2,
# so no linear would be row-parallel and nothing would be tuned), the
# main stream, an f32 pool; its own single-device reference
MESH_TUNE_LAYERS = 1
MESH_TUNE_DIR = ROOT / "chiprun_out" / "mesh_tune"


def mesh_tune_cfg():
    """:data:`MESH_TUNE_LAYERS`-layer gemma-2b with msgemm weights at
    :data:`MESH_ROW_SPEC`."""
    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.core.spec import QuantSpec

    return CONFIG.replace(num_layers=MESH_TUNE_LAYERS,
                          quant=QuantSpec(mode="msgemm", **MESH_ROW_SPEC))


def mesh_tune_rows(cfg) -> dict:
    """{(linear, step kind): (its contraction a rank on model=2, the
    step's rows)} of the row-parallel keys the tuner times: wo over the
    heads, down over the hidden dim, at the decode rows (the engine's 4
    slots) and the prefill rows (one 8-position chunk)."""
    hd = cfg.num_heads * cfg.head_dim
    return {(lin, kind): (k // 2, b)
            for lin, k in (("wo", hd), ("down", cfg.d_ff))
            for kind, b in (("decode", 4), ("prefill", 8))}


def mesh_tune_model(device, seed=0, mesh=None, rules="serve"):
    """(model, cfg) of :func:`mesh_tune_cfg` from ``seed`` on ``device``:
    the whole model, or with ``mesh`` this rank's copy for ``rules``
    (``runtime.serve.init_shard``: no whole model on the device)."""
    from repro_torch.device import generator
    from repro_torch.models import transformer
    from repro_torch.runtime import serve as SV

    cfg = mesh_tune_cfg()
    if mesh is None:
        model = transformer.init_params(cfg, generator=generator(
            seed, device), device=device, quant=cfg.quant)
    else:
        model = SV.init_shard(cfg, mesh, rules, generator=generator(
            seed, device), device=device, quant=cfg.quant)
    return model, cfg


def mesh_tune_reference():
    """The single device's run of :func:`mesh_tune_model` (graph route):
    its tokens, launches and each token's top-two gap."""
    import torch

    model, cfg = mesh_tune_model("cuda")
    run = serve("mesh-tune-ref", model, cfg, keep_logits=True)
    run["top2_rel"] = top2_gaps(run.pop("logits"))
    run.pop("reqs")
    run.pop("exec_plans")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return run


def _engine_run(engine, cfg, device):
    """Serve the main stream on a mesh engine with every kernel's launches
    and the collectives counted over the run alone: tokens, status,
    steps by kind (the leader's), launches, collectives (count and bytes
    by kind), seconds, peak bytes."""
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels.ops import KERNELS

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    for mod in KERNELS.values():
        mod.launches = 0
    coll.reset_counts()
    steps0 = engine.runner.steps_run
    t0 = time.perf_counter()
    results = engine.run(request_stream(cfg))
    torch.cuda.synchronize(device)
    run_s = time.perf_counter() - t0
    steps = engine.runner.steps_run - steps0
    return dict(tokens={rid: s.generated for rid, s in results.items()},
                status={rid: s.status for rid, s in results.items()},
                steps=steps, prefill_steps=engine.num_prefill_steps,
                decode_steps=engine.num_decode_steps, run_s=run_s,
                step_ms=run_s * 1e3 / max(steps, 1),
                launches={n: mod.launches for n, mod in KERNELS.items()},
                collectives=dict(coll.counts), coll_bytes=dict(coll.nbytes),
                peak_bytes=torch.cuda.max_memory_allocated(device))


def mesh_tune_rank(rank, device, seed, paths):
    """One rank of the layout tuner on a model=2 mesh: an engine with
    ``shard_pipeline=0`` (kernel tiles untuned) times every row-parallel
    key's collective layouts at build, then serves the main stream; a
    rebuild from the cache file; rank 0 then tunes a few unsharded
    kernel keys into that file and fits a calibration from it
    (``python -m repro_torch.obs --calibrate``, in process), and both
    ranks build a third engine with it and ``autotune="model"`` on a
    fresh cache file."""
    import torch

    from repro_torch import dispatch, obs
    from repro_torch.dispatch import autotune as at
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2,), ("model",))
    model, cfg = mesh_tune_model(device, seed, mesh)

    def build(cache, **kw):
        at.num_timed_candidates = 0
        t0 = time.perf_counter()
        eng = make_engine(model, cfg, mesh=mesh, cuda_graph=False,
                          shard_pipeline=0, autotune_cache=str(cache), **kw)
        torch.cuda.synchronize(device)
        plans = {k: (p.backend, p.shard.tag() if p.shard else None,
                     str(p.tiles)) for k, p in eng.exec_plans.items()}
        return eng, plans, at.num_timed_candidates, \
            time.perf_counter() - t0

    eng, plans, timed, build_s = build(paths["cache"])
    table = dispatch.cache()
    out = dict(rank=rank, device=str(device), timed=timed, build_s=build_s,
               plans=plans, variants={k: table.shard_variant(k)
                                      for k in table.variant_keys()})
    out.update(_engine_run(eng, cfg, device))
    del eng
    gc.collect()
    eng, again, out["rebuilt_timed"], _ = build(paths["cache"])
    out["rebuilt_same"] = again == plans
    del eng
    gc.collect()
    fit = None
    if rank == 0:
        # the kernel constants --calibrate fits beside the collective
        # term: wo's and down's one-shot and 2-chunk shapes, unsharded
        for k, b in mesh_tune_rows(cfg).values():
            for kc in (k, k // 2):
                at.autotune(cfg.quant, cfg.d_model, kc, b, "msgemm_cuda",
                            device_type=torch.device(device).type)
        from repro_torch.obs.__main__ import main as obs_main

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = obs_main(["--calibrate", "--plan-cache",
                           str(paths["cache"]), "--calibration",
                           str(paths["calibration"])])
        from repro_torch.obs import perfmodel as pm

        cal = pm.load_calibration(paths["calibration"])
        fit = dict(rc=rc, text=buf.getvalue(),
                   collective=None if cal is None else cal.collective)
    fit = coll.broadcast_object(fit)  # and a barrier
    os.environ["REPRO_CALIBRATION"] = str(paths["calibration"])
    pruned = obs.registry().counter("dispatch_autotune_model_pruned_total",
                                    backend="shard_variants")
    before = pruned.value
    eng, model_plans, out["model_timed"], out["model_build_s"] = build(
        paths["cache3"], autotune="model")
    table = dispatch.cache()
    out.update(fit=fit, model_plans=model_plans,
               model_pruned=pruned.value - before,
               model_variants={k: [(r["pipeline_chunks"],
                                    r["collective_impl"])
                                   for r in table.shard_variant(k)["rows"]]
                               for k in table.variant_keys()})
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _near_ties(tag, ref, tokens, status=None):
    """Hold ``tokens`` ({rid: generated}) to the single-device ``ref``: a
    request whose tokens differ must differ first at a single-device
    near-tie (top two within ``MESH_NEAR_TIE`` relative).  Returns the
    differing (rid, step, gap)."""
    diff = []
    for rid, want in sorted(ref["tokens"].items()):
        got = tokens[rid]
        check(len(got) == NEW_TOKENS and (status is None
                                          or status[rid] == "ok"),
              f"[{tag}] request {rid}: {len(got)} tokens, status "
              f"{None if status is None else status[rid]}")
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
        if first is not None:
            gap = ref["top2_rel"][rid][first]
            check(gap <= MESH_NEAR_TIE,
                  f"[{tag}] request {rid} step {first}: token {got[first]} "
                  f"!= {want[first]}, single-device top two {gap:.2e} apart "
                  f"(more than {MESH_NEAR_TIE})")
            diff.append((rid, first, gap))
    return diff


def phase_mesh_tune(card):
    """The shard-variant tuner on the card: two ranks sharing cuda:0 over
    host-staged gloo on model=2, :func:`mesh_tune_model` served with
    ``shard_pipeline=0`` and kernel-tile tuning off (so the comparison
    isolates the collective layout).  Prints every tuned key (wo's and
    down's, decode and prefill rows) with its rows (chunks, implementation,
    seconds, hops, bytes) and winner.  Gates: both ranks hold the same
    winners and plans; the tokens equal the single device's (the
    near-tie rule); each rank's msGeMM launches equal what the winners
    imply (a layer: 5 + wo's chunks + down's chunks, by step kind); a
    rebuild from the cache times no candidate and gives the same plans;
    the calibration fitted from the cache file has a collective block,
    and a third build with it and ``autotune="model"`` times at most
    ``MODEL_TOP_K`` variants a key, the one-shot among them."""
    import shutil

    import torch

    from repro_torch.dispatch.autotune import MODEL_TOP_K
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.obs.perfmodel import parse_plan_key

    ref = mesh_tune_reference()
    shutil.rmtree(MESH_TUNE_DIR, ignore_errors=True)
    MESH_TUNE_DIR.mkdir(parents=True)
    paths = {n: str(MESH_TUNE_DIR / f) for n, f in (
        ("cache", "plans.json"), ("cache3", "plans_model.json"),
        ("calibration", "calibration.json"))}
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_tune_rank, 2, 0, paths,
                      devices=["cuda:0", "cuda:0"], timeout=900)
    wall_s = time.perf_counter() - t0
    lead = ranks[0]
    table = json.loads(Path(paths["cache"]).read_text())["shard_variants"]
    rows = {v: n for n, v in mesh_tune_rows(mesh_tune_cfg()).items()}
    tuned = {(parse_plan_key(k)["k"], parse_plan_key(k)["b"]): k
             for k in table}
    check(set(tuned) == set(rows) and set(table) == set(lead["variants"]),
          f"[mesh-tune] tuned keys {sorted(table)}: want wo's and down's "
          "at the decode and prefill rows")
    winners = {}
    for kb, key in sorted(tuned.items()):
        var, info = table[key], parse_plan_key(key)
        lin, kind = rows[kb]
        winners[(lin, kind)] = int(var["pipeline_chunks"])
        check(sum(r["winner"] for r in var["rows"]) == 1,
              f"[mesh-tune] {key}: not one winner")
        print(f"[mesh-tune] {lin} {kind} (m={info['m']}, k={info['k']} a "
              f"rank, b={info['b']}): winner {var['pipeline_chunks']} x "
              f"{var['collective_impl']}; rows " + "; ".join(
                  f"{r['pipeline_chunks']} x {r['collective_impl']} "
                  f"{r['s'] * 1e3:.3f} ms, {r['hops']} hops, "
                  f"{r['bytes'] / 1024:.1f} KiB" for r in var["rows"]),
              flush=True)
    for r in ranks:
        check(r["variants"] == lead["variants"] and r["plans"] ==
              lead["plans"], f"[mesh-tune] rank {r['rank']} chose other "
              "winners or plans")
        check(r["rebuilt_timed"] == 0 and r["rebuilt_same"],
              f"[mesh-tune] rank {r['rank']}: the rebuild timed "
              f"{r['rebuilt_timed']} candidates (same plans: "
              f"{r['rebuilt_same']})")
        check(r["tokens"] == lead["tokens"],
              f"[mesh-tune] rank {r['rank']} returned other tokens")
    ties = _near_ties("mesh-tune", ref, lead["tokens"], lead["status"])
    L = MESH_TUNE_LAYERS
    want = sum(lead[f"{kind}_steps"] * L * (5 + winners[("wo", kind)]
                                            + winners[("down", kind)])
               for kind in ("prefill", "decode"))
    for r in ranks:
        got = r["launches"]
        check(got == dict(msgemm=want, paged_attention=0, int4_matmul=0,
                          flash_attention=0),
              f"[mesh-tune] rank {r['rank']} launches {got}, want {want} "
              f"msGeMM ({lead['prefill_steps']} prefill and "
              f"{lead['decode_steps']} decode steps, winners {winners})")
    fit = lead["fit"]
    check(fit["rc"] == 0 and fit["collective"],
          f"[mesh-tune] --calibrate exit {fit['rc']}, collective block "
          f"{fit['collective']}: {fit['text']}")
    c = fit["collective"]
    print(f"[mesh-tune] python -m repro_torch.obs --calibrate --plan-cache "
          f"{paths['cache']}: " + fit["text"].strip().splitlines()[-1],
          flush=True)
    print(f"[mesh-tune] collective term: coll_call_s {c['coll_call_s']:.4g}, "
          f"coll_hop_s {c['coll_hop_s']:.4g}, coll_byte_s "
          f"{c['coll_byte_s']:.4g}; n_samples {c['n_samples']}, rms_err_s "
          f"{c['rms_err_s']:.4g}", flush=True)
    for r in ranks:
        check(r["model_variants"] == lead["model_variants"]
              and r["model_plans"] == lead["model_plans"],
              f"[mesh-tune] rank {r['rank']}: the model-guided build chose "
              "other winners or plans")
    for key, rows in sorted(lead["model_variants"].items()):
        check(len(rows) <= MODEL_TOP_K and (1, "xla") in rows,
              f"[mesh-tune] model-guided build timed {rows} for {key}")
    print(f"[mesh-tune] model-guided build (autotune='model', the fitted "
          f"calibration): variants timed a key "
          f"{sorted(len(v) for v in lead['model_variants'].values())}, "
          f"{int(lead['model_pruned'])} pruned, {lead['model_timed']} candidates "
          f"in all (tiles too), build {lead['model_build_s']:.1f}s",
          flush=True)
    print(f"[mesh-tune] 2 ranks on one card ({card}): build "
          f"{lead['build_s']:.1f}s timing {lead['timed']} candidates; "
          f"{lead['steps']} steps at {lead['step_ms']:.2f} ms (single "
          f"device graph route {ref['step_ms']:.2f}); launches "
          f"{lead['launches']} ({want} implied by the winners); rebuild "
          f"timed 0; tokens == the single device's on {6 - len(ties)}/6 "
          f"requests, near-tie steps {ties}; peak "
          f"{max(r['peak_bytes'] for r in ranks) / 2**30:.2f} GiB; phase "
          f"wall {wall_s:.1f}s", flush=True)
    torch.cuda.empty_cache()
    return dict(ranks=ranks, ref=ref, winners={f"{a} {b}": v for (a, b), v
                                               in winners.items()},
                near_tie_steps=ties, wall_s=wall_s)


def _resident(params, names=None) -> int:
    """Bytes of ``params``' buffers (those named in ``names`` only)."""
    return sum(t.numel() * t.element_size()
               for n, t in params.named_buffers()
               if names is None or n in names)


def mesh_fsdp_rank(rank, device, seed):
    """One rank of FSDP weight storage on a data=2 mesh:
    :func:`mesh_tune_model` served under 'default' (each rank stores its
    'data' block of every leaf whose model dim takes 'data') and then
    under 'serve', the rows split over 'data', each from this rank's copy
    drawn for those rules (no whole model on the card; its bytes after
    the build and the build's peak kept); then whisper's static
    engine (2 + 2 layers, 16 frames, batch 4, f32) under 'default'
    against one device's ``generate`` of the same weights (every rank
    runs both; its rows of the step logits)."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.runtime import serve as SV

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2,), ("data",))
    out = dict(rank=rank, device=str(device))
    cut = None
    for rules in ("default", "serve"):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        model, cfg = mesh_tune_model(device, seed, mesh, rules)
        torch.cuda.synchronize(device)
        r = dict(built_bytes=torch.cuda.memory_allocated(device),
                 build_peak_bytes=torch.cuda.max_memory_allocated(device))
        eng = make_engine(model, cfg, mesh=mesh, cuda_graph=False,
                          mesh_rules=rules)
        check(eng.params is model, f"[mesh-fsdp] rank {rank}: the engine "
              "cut another copy of its rank's copy")
        del model
        if cut is None:
            cut = {(f"{p}." if p else "") + k
                   for p, mod in eng.params.named_modules()
                   for k in getattr(mod, "fsdp", {})}
        r.update(resident=_resident(eng.params),
                 resident_cut=_resident(eng.params, cut), cut_leaves=len(cut))
        r.update(_engine_run(eng, cfg, device))
        out[rules] = r
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    wcfg, spec = mesh_static_cfg("whisper_medium", 2)
    wmodel = transformer.init_params(wcfg, generator=generator(seed, device),
                                     device=device, quant=spec)
    wcfg = wcfg.replace(quant=spec)
    batch = mesh_static_batch(wcfg, device)
    one, many = [], []
    for mod in KERNELS.values():
        mod.launches = 0
    single = SV.generate(wmodel, wcfg, batch,
                         max_new_tokens=MESH_STATIC_NEW, step_logits=one)
    single_launches = {n: m.launches for n, m in KERNELS.items()}
    local = SV.shard_params(wmodel, wcfg, mesh, "default")
    del wmodel
    gc.collect()
    for mod in KERNELS.values():
        mod.launches = 0
    coll.reset_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tokens = SV.generate(local, wcfg, batch, max_new_tokens=MESH_STATIC_NEW,
                         mesh=mesh, rules="default", step_logits=many)
    torch.cuda.synchronize(device)
    run_s = time.perf_counter() - t0
    n = many[0].shape[0]
    first = sharding.coord(mesh, "data") * n
    diffs = [float((a - b[first:first + n]).abs().max())
             for a, b in zip(many, one)]
    top = torch.stack(one, dim=1).float().topk(2, dim=-1).values
    out["whisper"] = dict(
        single=single.tolist(), mesh=tokens.tolist(), diffs=diffs,
        max_abs_diff=max(diffs), run_s=run_s,
        scale=max(float(t.abs().max()) for t in one),
        top2_gap=(top[..., 0] - top[..., 1]).tolist(),
        finite=bool(all(t.isfinite().all() for t in many)),
        launches={n_: m.launches for n_, m in KERNELS.items()},
        single_launches=single_launches, collectives=dict(coll.counts))
    del local, many, one
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_mesh_fsdp(card, ref):
    """FSDP weight storage on the card: two ranks sharing cuda:0 over
    host-staged gloo on data=2, :func:`mesh_tune_model` serving the main
    stream under 'default' and then 'serve' (the rows split over
    'data'), and whisper's static engine under 'default'.  Gates: the
    tokens equal the single device's (``ref``, the near-tie rule) under
    both rules; each rank's launches under 'default' equal the 'serve'
    run's, over the same steps; every leaf the rules cut holds half its
    'serve' bytes; whisper's logits within the static gate of
    ``[mesh-static ...]`` and its tokens equal one device's but at a
    near-tie; the 'default' run's peak at most the 'serve' run's on each
    rank (each rank draws only its copy, so the whole model is never on
    the card).  Prints each rank's resident weight bytes under both
    rules, the gathers a step by kind and bytes, the step ms, and each
    rule's build and run peaks."""
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(mesh_fsdp_rank, 2, 0, devices=["cuda:0", "cuda:0"],
                      timeout=900)
    wall_s = time.perf_counter() - t0
    lead = ranks[0]
    ties = {}
    for rules in ("default", "serve"):
        ties[rules] = _near_ties(f"mesh-fsdp {rules}", ref,
                                 lead[rules]["tokens"], lead[rules]["status"])
    for r in ranks:
        d, sv = r["default"], r["serve"]
        for rules in ("default", "serve"):
            check(r[rules]["tokens"] == lead[rules]["tokens"],
                  f"[mesh-fsdp {rules}] rank {r['rank']} returned other "
                  "tokens")
        check(d["launches"] == sv["launches"] and d["steps"] == sv["steps"],
              f"[mesh-fsdp] rank {r['rank']} launches {d['launches']} over "
              f"{d['steps']} steps under 'default', {sv['launches']} over "
              f"{sv['steps']} under 'serve'")
        check(d["cut_leaves"] > 0 and 2 * d["resident_cut"]
              == sv["resident_cut"],
              f"[mesh-fsdp] rank {r['rank']}: the {d['cut_leaves']} cut "
              f"leaves hold {d['resident_cut']} bytes, 'serve' "
              f"{sv['resident_cut']}")
        check(d["peak_bytes"] <= sv["peak_bytes"],
              f"[mesh-fsdp] rank {r['rank']}: the 'default' run's peak "
              f"{d['peak_bytes'] / 2**30:.3f} GiB is above the 'serve' "
              f"run's {sv['peak_bytes'] / 2**30:.3f}")
        per_step = {k: (v / d["steps"], d["coll_bytes"][k] / d["steps"])
                    for k, v in d["collectives"].items()}
        print(f"[mesh-fsdp] rank {r['rank']} ({card}): resident weights "
              f"{d['resident'] / 2**30:.3f} GiB under 'default', "
              f"{sv['resident'] / 2**30:.3f} under 'serve' (the "
              f"{d['cut_leaves']} leaves with a model dim: "
              f"{d['resident_cut'] / 2**20:.1f} / "
              f"{sv['resident_cut'] / 2**20:.1f} MiB); a step: "
              + ", ".join(f"{k} {c:.2f} ({b / 2**20:.2f} MiB)"
                          for k, (c, b) in sorted(per_step.items()))
              + f"; {d['steps']} steps at {d['step_ms']:.2f} ms ('serve' "
              f"{sv['step_ms']:.2f}); built "
              f"{d['built_bytes'] / 2**30:.3f} GiB, build peak "
              f"{d['build_peak_bytes'] / 2**30:.3f}, run peak "
              f"{d['peak_bytes'] / 2**30:.3f} ('serve' "
              f"{sv['built_bytes'] / 2**30:.3f}, "
              f"{sv['build_peak_bytes'] / 2**30:.3f}, "
              f"{sv['peak_bytes'] / 2**30:.3f}); launches "
              f"{d['launches']}", flush=True)
    w = lead["whisper"]
    check(w["finite"], "[mesh-fsdp whisper] non-finite logits")
    limit = min(F32_STATE_TOL, MESH_STATIC_REL_TOL * w["scale"])
    for r in ranks:
        wr = r["whisper"]
        check(wr["max_abs_diff"] <= limit,
              f"[mesh-fsdp whisper] rank {r['rank']}: logits "
              f"{wr['max_abs_diff']:.3g} from one device's (more than "
              f"{limit:.3g})")
        check(wr["mesh"] == w["mesh"] and wr["launches"] ==
              wr["single_launches"],
              f"[mesh-fsdp whisper] rank {r['rank']}: tokens or launches "
              f"{wr['launches']} != one device's {wr['single_launches']}")
    for row, (got, want) in enumerate(zip(w["mesh"], w["single"])):
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
        check(first is None or w["top2_gap"][row][first]
              <= 2 * F32_STATE_TOL,
              f"[mesh-fsdp whisper] row {row} step {first}: not a near-tie")
    same = sum(a == b for a, b in zip(w["mesh"], w["single"]))
    print(f"[mesh-fsdp whisper] 2 + 2 layers under 'default' on data=2: "
          f"tokens == one device's on {same}/{len(w['mesh'])} rows, logits "
          f"within {max(r['whisper']['max_abs_diff'] for r in ranks):.3g} "
          f"(at most {limit:.3g}; largest |logit| {w['scale']:.4g}); "
          f"{w['run_s'] * 1e3 / MESH_STATIC_NEW:.2f} ms a token step; "
          f"launches {w['launches']}; collectives "
          + ", ".join(f"{k} {v}" for k, v in sorted(w["collectives"].items())),
          flush=True)
    print(f"[mesh-fsdp] 2 ranks on one card: tokens == the single device's "
          f"on {6 - len(ties['default'])}/6 ('default') and "
          f"{6 - len(ties['serve'])}/6 ('serve') requests, near-tie steps "
          f"{ties}; phase wall {wall_s:.1f}s", flush=True)
    return dict(ranks=ranks, near_tie_steps=ties, wall_s=wall_s)


# ------------------------------- sequence-parallel attention (on a mesh)
# full-width gemma-2b (8 query heads over its one kv head) on model=3, the
# smallest mesh whose size does not divide its heads, three ranks sharing
# cuda:0 over host-staged gloo.  Serving: 2 layers, msgemm weights (the
# main path's), f32 activations, 2 prompts of 6,144 tokens (2,048 query
# positions a rank), 16 new tokens through the static ``generate``.
# Training: 1 layer, f32, two steps of 8 x 132 lcg tokens on (data=1,
# model=3).
MESH_SEQ = dict(layers=2, batch=2, prompt=6144, new=16, train_layers=1,
                train_batch=8, train_seq=132)


def mesh_seq_train_cfg():
    """``MESH_SEQ``'s train config, remat off (the CPU tests hold the
    split under remat)."""
    return train_mesh_cfg(MESH_SEQ["train_layers"]).replace(remat=False)


class _StepClock(list):
    """A ``generate`` ``step_logits`` list that also keeps, as each step's
    logits arrive, the host clock after a device sync and the device's
    peak allocated bytes so far (its first entries: the prefill's)."""

    def __init__(self, device):
        super().__init__()
        self.device, self.at, self.peak = device, [], []

    def append(self, t):
        import torch

        torch.cuda.synchronize(self.device)
        self.at.append(time.perf_counter())
        self.peak.append(torch.cuda.max_memory_allocated(self.device))
        super().append(t)


def mesh_seq_generate(model, cfg, batch, device, mesh=None):
    """Static ``generate`` of ``MESH_SEQ['new']`` tokens (on ``mesh``
    with ``model`` a rank's copy), launches and collectives counted from
    0: its tokens, step logits, prefill ms (the cache's set-up
    included), decode ms a step, the bytes allocated before it and the
    peak to the prefill's end."""
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.runtime import serve as SV

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)
    for mod in KERNELS.values():
        mod.launches = 0
    coll.reset_counts()
    steps = _StepClock(device)
    t0 = time.perf_counter()
    tokens = SV.generate(model, cfg, batch, max_new_tokens=MESH_SEQ["new"],
                         mesh=mesh, step_logits=steps)
    return dict(tokens=tokens.tolist(), logits=list(steps),
                prefill_ms=(steps.at[0] - t0) * 1e3,
                decode_ms=(steps.at[-1] - steps.at[0]) * 1e3
                / (len(steps.at) - 1),
                resident_bytes=resident, prefill_peak_bytes=steps.peak[0],
                launches={n: m.launches for n, m in KERNELS.items()},
                collectives={k: [coll.counts[k], coll.nbytes[k]]
                             for k in sorted(coll.counts)})


def mesh_seq_serve_rank(rank, device, seed):
    """One rank of the sequence-parallel prefill on model=3: rank 0 first
    runs the whole model's static ``generate`` alone (the single
    device's tokens, logits, prefill ms and peak) and cuts its copy from
    that model (``shard_params``); the others draw theirs
    (``init_shard``: the same draws).  The attention stays whole, as the
    heads cannot take 'model'.  After a barrier the ranks run
    ``generate(mesh=)`` together.  Rank 0 compares the step logits;
    tensors stay in the rank."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.runtime import serve as SV

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((3,), ("model",))
    cfg0, spec = mesh_static_cfg("gemma_2b", MESH_SEQ["layers"])
    cfg = cfg0.replace(quant=spec)
    g = generator(1, device)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (MESH_SEQ["batch"], MESH_SEQ["prompt"]),
        generator=g, device=device, dtype=torch.int32)}
    out = dict(rank=rank, device=str(device))
    single = None
    if rank == 0:
        model = transformer.init_params(
            cfg0, generator=generator(seed, device), device=device,
            quant=spec)
        single = mesh_seq_generate(model, cfg, batch, device)
        local = SV.shard_params(model, cfg, mesh)
        del model
    else:
        local = SV.init_shard(cfg0, mesh, generator=generator(seed, device),
                              device=device, quant=spec)
    lay = local.blocks[0].attn.layout
    out["q_whole"] = lay.q_whole
    sharding.mesh_barrier(mesh)
    run = mesh_seq_generate(local, cfg, batch, device, mesh)
    del local
    many = run.pop("logits")
    if single is not None:
        one = single.pop("logits")
        diffs = [float((a - b).abs().max()) for a, b in zip(many, one)]
        top = torch.stack(one, dim=1).float().topk(2, dim=-1).values
        out.update(diffs=diffs, max_abs_diff=max(diffs),
                   scale=max(float(t.abs().max()) for t in one),
                   top2_gap=(top[..., 0] - top[..., 1]).tolist(),
                   finite=bool(all(t.isfinite().all() for t in many)),
                   single=single)
        del one
    del many
    gc.collect()
    torch.cuda.empty_cache()
    out["mesh"] = run
    return out


def mesh_seq_rank(rank, device, seed):
    """One rank of ``phase_mesh_seq``: :func:`mesh_seq_serve_rank`, then
    two train steps of ``MESH_SEQ``'s gemma-2b on (data=1, model=3)
    from ``seed``: their losses, grad norms and ms, the peak bytes, the
    collectives of each step by kind (count, bytes, seconds) and the
    launches over both."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import train as RT

    out = {"serve": mesh_seq_serve_rank(rank, device, seed)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    coll.set_timing(True)
    for mod in KERNELS.values():
        mod.launches = 0
    cfg = mesh_seq_train_cfg()
    tcfg = train_config(TRAIN_STEPS)
    data = train_stream(batch=MESH_SEQ["train_batch"],
                        seq=MESH_SEQ["train_seq"])
    mesh = make_mesh((1, 3), ("data", "model"))
    state = RT.init_state(cfg, tcfg, generator=generator(seed, device),
                          device=device, mesh=mesh)
    torch.cuda.reset_peak_memory_stats(device)
    losses, gnorms, ms, colls = train_mesh_steps(state, cfg, tcfg, data, 2,
                                                 device, mesh)
    out["train"] = dict(
        rank=rank, losses=losses, grad_norms=gnorms, ms=ms,
        collectives=colls,
        peak_bytes=torch.cuda.max_memory_allocated(device),
        launches={n: m.launches for n, m in KERNELS.items()})
    return out


def phase_mesh_seq(card):
    """Sequence-parallel attention where the query heads cannot take
    'model' (``layers.HeadLayout.q_whole``, ``layers.attn_apply_tp``):
    ``MESH_SEQ``'s gemma-2b on model=3, three ranks sharing cuda:0, one
    spawn (:func:`mesh_seq_rank`).

    Serving: the static ``generate`` held to one device's on the same
    weights with the static path's gate (§2 of PERF.md): every step's
    logits within ``F32_STATE_TOL`` and within ``MESH_STATIC_REL_TOL`` of
    the largest |logit|, finite; tokens equal, a differing token only at
    a near-tie (top two within ``2 * F32_STATE_TOL``); every rank returns
    the same tokens and launches the msGeMM kernel as one device does
    (the attention's at its block's width); each layer's prefill gathers
    its block's K and V, its MLP the normed block of the residual
    (``seq_in_gather``: the residual splits too), and no output is
    gathered.  Printed: each rank's prefill ms and peak GiB beside the
    single device's.

    Training: two steps' losses and grad norms within ``TRAIN_MESH_TOL``
    of the card alone's, every rank's losses the same and grad norms
    within it too; no hand-written kernel launched; the query positions
    and the residual split (``seq_kv_gather``, ``seq_in_gather``).
    Printed: each rank's step ms (step 1 pays the process's first
    backward), peak GiB, the collectives a step by kind and bytes."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import layers as L
    from repro_torch.runtime import train as RT

    tag, gib = "mesh-seq", 2**30
    cfg, tcfg = mesh_seq_train_cfg(), train_config(TRAIN_STEPS)
    data = train_stream(batch=MESH_SEQ["train_batch"],
                        seq=MESH_SEQ["train_seq"])
    state = RT.init_state(cfg, tcfg, generator=generator(0, "cuda"),
                          device="cuda")
    torch.cuda.reset_peak_memory_stats()
    one = train_mesh_steps(state, cfg, tcfg, data, 2, "cuda")
    one_peak = torch.cuda.max_memory_allocated()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    both = run_ranks(mesh_seq_rank, 3, 0, devices=["cuda:0"] * 3,
                     timeout=900)
    ranks_s = time.perf_counter() - t0
    ranks, tranks = [r["serve"] for r in both], [r["train"] for r in both]
    lead = ranks[0]
    single = lead["single"]
    layers = MESH_SEQ["layers"]
    limit = min(F32_STATE_TOL, MESH_STATIC_REL_TOL * lead["scale"])
    check(lead["finite"], f"[{tag} serve] non-finite logits")
    check(lead["max_abs_diff"] <= limit,
          f"[{tag} serve] logits {lead['max_abs_diff']:.3g} from the single "
          f"device's (more than {limit:.3g}: {F32_STATE_TOL}, or "
          f"{MESH_STATIC_REL_TOL} of the largest |logit| "
          f"{lead['scale']:.4g})")
    got, want = lead["mesh"]["tokens"], single["tokens"]
    for row, (a, b) in enumerate(zip(got, want)):
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        check(first is None or lead["top2_gap"][row][first]
              <= 2 * F32_STATE_TOL,
              f"[{tag} serve] row {row} step {first}: token "
              f"{a[first] if first is not None else None} != "
              f"{b[first] if first is not None else None}, not a near-tie")
    for r in ranks:
        run = r["mesh"]
        check(r["q_whole"], f"[{tag} serve] rank {r['rank']}: the heads "
              "split over model=3")
        check(run["tokens"] == got,
              f"[{tag} serve] rank {r['rank']} returned other tokens")
        check(run["launches"] == single["launches"],
              f"[{tag} serve] rank {r['rank']} launches {run['launches']} "
              f"!= one device's {single['launches']}")
        coll_ = run["collectives"]
        check(coll_.get(L.SEQ_KV, [0])[0] == 2 * layers
              and coll_.get(coll.SEQ_IN, [0])[0] == layers
              and "seq_out_gather" not in coll_,
              f"[{tag} serve] rank {r['rank']}: the prefill did not split "
              f"its query positions and its residual ({coll_})")
    same = sum(a == b for a, b in zip(got, want))
    B, S = MESH_SEQ["batch"], MESH_SEQ["prompt"]
    print(f"[{tag} serve] gemma-2b full width, {layers} layers, msgemm, "
          f"f32, {B} x {S} prompt tokens + {MESH_SEQ['new']} on model=3 "
          f"({S // 3} query positions a rank), 3 ranks on one card "
          f"({card}): tokens == one device's on {same}/{B} rows; logits "
          f"within {lead['max_abs_diff']:.3g} (at most {limit:.3g}; "
          f"prefill step {lead['diffs'][0]:.3g}, decode steps "
          f"{max(lead['diffs'][1:]):.3g}; largest |logit| "
          f"{lead['scale']:.4g})", flush=True)
    print(f"[{tag} serve] prefill: one device {single['prefill_ms']:.1f} "
          f"ms, peak {single['prefill_peak_bytes'] / gib:.3f} GiB "
          f"(resident {single['resident_bytes'] / gib:.3f}); "
          + "; ".join(f"rank {r['rank']} {r['mesh']['prefill_ms']:.1f} ms, "
                      f"peak {r['mesh']['prefill_peak_bytes'] / gib:.3f} "
                      f"GiB (resident "
                      f"{r['mesh']['resident_bytes'] / gib:.3f})"
                      for r in ranks)
          + f"; decode {lead['mesh']['decode_ms']:.2f} ms a step (one "
          f"device {single['decode_ms']:.2f}); launches "
          f"{lead['mesh']['launches']}; collectives a run "
          + ", ".join(f"{k} {c} ({b / 2**20:.1f} MiB)"
                      for k, (c, b) in lead["mesh"]["collectives"].items()),
          flush=True)
    tl = tranks[0]
    rel = max(max(abs(a - b) / abs(b) for a, b in zip(tl["losses"], one[0])),
              max(abs(a - b) / abs(b)
                  for a, b in zip(tl["grad_norms"], one[1])))
    check(rel <= TRAIN_MESH_TOL,
          f"[{tag} train] losses {tl['losses']} / grad norms "
          f"{tl['grad_norms']} vs the card alone's {one[0]} / {one[1]}: "
          f"rel {rel:.2e} > {TRAIN_MESH_TOL}")
    for r in tranks:
        check(r["losses"] == tl["losses"] and all(
            abs(a - b) <= TRAIN_MESH_TOL * abs(b)
            for a, b in zip(r["grad_norms"], tl["grad_norms"])),
              f"[{tag} train] rank {r['rank']}'s metrics {r['losses']} / "
              f"{r['grad_norms']} differ from rank 0's")
        check(r["launches"] == {n: 0 for n in r["launches"]},
              f"[{tag} train] rank {r['rank']} launched hand-written "
              f"kernels: {r['launches']}")
        check(all(c.get(L.SEQ_KV, [0])[0] > 0
                  and c.get(coll.SEQ_IN, [0])[0] > 0
                  and "seq_out_gather" not in c for c in r["collectives"]),
              f"[{tag} train] rank {r['rank']}: a step did not split its "
              "query positions and its residual")
    per_step = tl["collectives"][-1]
    print(f"[{tag} train] gemma-2b full width, "
          f"{MESH_SEQ['train_layers']} layer, f32, no remat, "
          f"{MESH_SEQ['train_batch']} x {MESH_SEQ['train_seq']} tokens on "
          f"(data=1, model=3), 3 ranks on one card ({card}): losses "
          f"{tl['losses']}, grad norms {tl['grad_norms']} vs the card "
          f"alone's {one[0]} / {one[1]} (rel {rel:.2e}, tol "
          f"{TRAIN_MESH_TOL}); step 2 "
          + ", ".join(f"rank {r['rank']} {r['ms'][1]:.1f} ms (step 1 "
                      f"{r['ms'][0]:.1f}), peak "
                      f"{r['peak_bytes'] / gib:.2f} GiB" for r in tranks)
          + f" (card alone {one[2][1]:.1f} ms, peak {one_peak / gib:.2f}); "
          "collectives of step 2 (rank 0): "
          + ", ".join(f"{k} {c} ({b / 2**20:.1f} MiB, {t * 1e3:.0f} ms)"
                      for k, (c, b, t) in per_step.items())
          + f"; ranks' run {ranks_s:.1f}s", flush=True)
    return dict(serve=ranks, train=dict(ranks=tranks, one_card=dict(
        losses=one[0], grad_norms=one[1], ms=one[2], peak_bytes=one_peak),
        rel=rel), ranks_s=ranks_s)


def phase_mesh(card, ref=None, only=False):
    """The mesh phases: the in-process kernel check, the two-rank engine
    against ``ref`` (the main phase's run with its top-two gaps; built
    here when None), FSDP storage, the two-rank MoE engine, each on two
    cards joined by NCCL too where two are visible, training on a mesh,
    sequence-parallel attention.  With ``only`` (``--only mesh``) also
    the layout tuner, qwen2-moe under the 'default' rules (tokens moved
    to the expert stacks), the static engine, the calibration of expert
    stacks and every family's training (moved there from the whole run
    to pay for newer phases)."""
    import torch

    out = {"kernels": phase("mesh-kernels", phase_mesh_kernels)}
    if ref is None:
        ref = phase("mesh-ref", mesh_reference)
    out["engine"] = phase("mesh", phase_mesh_engine, ref, card)
    if only:
        out["tune"] = phase("mesh-tune", phase_mesh_tune, card)
        tune_ref = out["tune"]["ref"]
    else:
        print("[mesh-tune] runs under --only mesh (moved there to pay for "
              "[mesh-fsdp qwen2-moe ...])", flush=True)
        tune_ref = phase("mesh-tune-ref", mesh_tune_reference)
    out["fsdp"] = phase("mesh-fsdp", phase_mesh_fsdp, card, tune_ref)
    if torch.cuda.device_count() >= 2:
        out["engine_nccl"] = phase("mesh-nccl", phase_mesh_engine, ref,
                                   card, ("cuda:0", "cuda:1"), "mesh-nccl")
    else:
        print("[mesh-nccl] skipped: one card (two ranks on two cards, "
              "joined by NCCL, run where two are visible)", flush=True)
    out["moe"] = phase("mesh-moe", phase_mesh_moe, card)
    if only:
        out["moe_fsdp"] = phase("mesh-fsdp-moe", phase_mesh_moe_fsdp, card,
                                out["moe"]["ref"])
    else:
        print("[mesh-fsdp qwen2-moe ...] runs under --only mesh (moved "
              "there to pay for [mesh-seq ...])", flush=True)
    two = ("cuda:0", "cuda:1")
    if torch.cuda.device_count() >= 2:
        out["moe_nccl"] = phase("mesh-moe-nccl", phase_mesh_moe, card, two,
                                "mesh-moe-nccl")
    if only:
        out["static"] = phase("mesh-static", phase_mesh_static, card)
        if torch.cuda.device_count() >= 2:
            out["static_nccl"] = phase("mesh-static-nccl",
                                       phase_mesh_static, card, two,
                                       "mesh-static-nccl")
        out["calib_moe"] = phase("calib-moe", phase_calib_moe)
    else:
        print("[mesh-static] and [calib-moe] run under --only mesh (moved "
              "there to pay for [mesh-fsdp qwen2-moe ...])", flush=True)
    out["train_mesh"] = phase("train-mesh", phase_train_mesh, card)
    out["seq"] = phase("mesh-seq", phase_mesh_seq, card)
    if only:
        out["train_families"] = phase("train-mesh-families",
                                      phase_train_families, card)
    else:
        print("[train-mesh-families] runs under --only mesh (moved there "
              "to pay for [mesh-tune ...] and [mesh-fsdp ...])", flush=True)
    if torch.cuda.device_count() >= 4:
        out["train_mesh_nccl"] = phase("train-mesh-nccl",
                                       phase_train_mesh_nccl, card)
    else:
        print("[train-mesh-nccl] skipped: fewer than 4 cards (the 2x2 mesh "
              "one rank a card over NCCL runs where four are visible)",
              flush=True)
    return out


# ------------------------------------------------------- training on a mesh
# full-width gemma-2b cut to 1 layer (the cut pays for the mesh-serving
# phases), the train phase's batch (8 x 128 lcg tokens, seed 0), f32
# activations, AdamW, remat; 1 step on (data=2, model=2), a checkpoint,
# 1 more
TRAIN_MESH = dict(layers=1, steps=1, more=1)
TRAIN_MESH_TOL = 1e-4  # relative: loss and grad_norm, mesh vs one card
# relative limits of the int8 paths against f32, each between its sound
# reading on the card (1.9e-5 and 6.4e-5) and a broken path's: a gather
# without its scale, or a mean over 2 pods without its /2 (1.0)
INT8_GATHER_TOL = 1e-3  # the int8 FSDP gather's loss vs the f32 gather's
INT8_POD_TOL = 1e-3  # int8_pod's step-1 grad_norm vs the card alone's
TRAIN_MESH_DIR = ROOT / "chiprun_out" / "train_mesh"


def train_mesh_cfg(layers=TRAIN_MESH["layers"]):
    from repro_torch.configs.gemma_2b import CONFIG

    return CONFIG.replace(num_layers=layers, dtype="float32")


def train_mesh_steps(state, cfg, tcfg, data, steps, device, mesh=None,
                     first=0):
    """``steps`` train steps from batch ``first``: (losses, grad norms,
    step ms (host clock, synchronised), collectives of each step by kind:
    {kind: [count, bytes, seconds]}, the seconds with
    ``collectives.set_timing`` on)."""
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.runtime import train as RT

    losses, gnorms, ms, colls = [], [], [], []
    for step in range(first, first + steps):
        batch = data.device_batch(step, device=device, mesh=mesh)
        torch.cuda.synchronize(device)
        coll.reset_counts()
        t = time.perf_counter()
        state, met = RT.train_step(state, batch, cfg, tcfg)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t) * 1e3)
        colls.append({k: [coll.counts[k], coll.nbytes[k], coll.seconds[k]]
                      for k in sorted(coll.counts)})
    return losses, gnorms, ms, colls


def train_mesh_rank(rank, device, layers, steps, more):
    """One rank of the mesh training run (``launch.mesh.run_ranks``):
    full-width gemma-2b at ``layers`` layers from seed 0 cut to this
    rank's blocks of a (data=2, model=2) mesh; one forward and backward
    with the int8 FSDP gather from the initial state; ``steps`` steps, a
    checkpoint (whole leaves, rank 0 writes), ``more`` steps; then one
    step of a fresh state on (pod=2, data=1, model=2) with
    ``grad_compression="int8_pod"``.  Hand-written kernel launches are
    counted over the whole run."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.device import generator
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import driver
    from repro_torch.runtime import train as RT

    from repro_torch.distributed import collectives as coll

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    coll.set_timing(True)  # staged collectives synchronise anyway
    for mod in KERNELS.values():
        mod.launches = 0
    cfg = train_mesh_cfg(layers)
    tcfg = train_config(TRAIN_STEPS)
    data = train_stream()
    mesh = make_mesh((2, 2), ("data", "model"))
    t0 = time.perf_counter()
    state = RT.init_state(cfg, tcfg, generator=generator(0, device),
                          device=device, mesh=mesh)
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    names = list(state["opt"]["m"])
    b0 = data.device_batch(0, device=device, mesh=mesh)
    t0 = time.perf_counter()
    i8_loss, _, i8_grads = RT._grads(
        state["params"], names, cfg.replace(fsdp_int8_gather=True), tcfg, b0,
        mesh=mesh, specs=state["specs"])
    i8 = dict(loss=float(i8_loss), finite=bool(all(
        torch.isfinite(g).all() for g in i8_grads.values())),
        s=time.perf_counter() - t0)
    del i8_grads, b0
    torch.cuda.reset_peak_memory_stats(device)
    losses, gnorms, ms, colls = train_mesh_steps(state, cfg, tcfg, data,
                                                 steps, device, mesh)
    peak = torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    CheckpointManager(str(TRAIN_MESH_DIR), keep=1).save(
        steps, driver._tree(state), shardings=driver.shardings(state))
    save_s = time.perf_counter() - t0
    more_losses, more_gnorms, more_ms, _ = train_mesh_steps(
        state, cfg, tcfg, data, more, device, mesh, first=steps)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    pod_mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    ptcfg = RT.TrainConfig(optimizer=tcfg.optimizer,
                           grad_compression="int8_pod")
    pstate = RT.init_state(cfg, ptcfg, generator=generator(0, device),
                           device=device, mesh=pod_mesh)
    pod = train_mesh_steps(pstate, cfg, ptcfg, data, 1, device, pod_mesh)
    residual = max(float(t.abs().max())
                   for t in pstate["opt"]["residual"].values())
    del pstate
    from repro_torch.distributed.collectives import transport

    return dict(rank=rank, device=str(device), init_s=init_s, losses=losses,
                grad_norms=gnorms, step_ms=ms, collectives=colls,
                peak_bytes=peak, save_s=save_s, more_losses=more_losses,
                more_grad_norms=more_gnorms, more_ms=more_ms, int8_gather=i8,
                int8_pod=dict(loss=pod[0][0], grad_norm=pod[1][0],
                              ms=pod[2][0], collectives=pod[3][0],
                              residual_max=residual),
                transport=transport(),
                launches={n: mod.launches for n, mod in KERNELS.items()})


def phase_train_mesh(card):
    """Training on a mesh (FSDP x TP: ``init_state(..., mesh=)``,
    ``constrain_params``, the tensor-parallel blocks, ``int8_all_gather``,
    ``optim.compression``, the checkpoint of whole leaves): full-width
    gemma-2b at ``TRAIN_MESH``'s depth, four ranks sharing ``cuda:0``
    over host-staged gloo (``train_mesh_rank``), held to the same run on
    the card alone: each step's loss and grad_norm within
    ``TRAIN_MESH_TOL``; the int8 FSDP gather's loss within
    ``INT8_GATHER_TOL`` of the f32 gather's; the mesh's checkpoint after
    its first steps restored onto one device (1x1) here, whose next steps
    equal the mesh's within ``TRAIN_MESH_TOL``; the
    int8_pod step's loss the f32 step's (the loss precedes the gradient
    mean), its grad_norm within ``INT8_POD_TOL`` of the card alone's
    and its residual nonzero; the residual's 128 positions split over
    'model' between blocks (each step's ``seq_in_gather`` and
    ``seq_out_scatter`` counted).  Per rank: step ms, tokens/s, peak
    GiB; the collectives a step by kind and bytes.  No hand-written
    kernel runs."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.device import generator
    from repro_torch.distributed.collectives import SEQ_IN, SEQ_OUT
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.runtime import driver
    from repro_torch.runtime import train as RT

    cfg, tcfg, data = train_mesh_cfg(), train_config(TRAIN_STEPS), \
        train_stream()
    steps, more = TRAIN_MESH["steps"], TRAIN_MESH["more"]
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    state = RT.init_state(cfg, tcfg, generator=generator(0, "cuda"),
                          device="cuda")
    one = train_mesh_steps(state, cfg, tcfg, data, steps + more, "cuda")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(train_mesh_rank, 4, TRAIN_MESH["layers"], steps, more,
                      devices=["cuda:0"] * 4, timeout=900)
    ranks_s = time.perf_counter() - t0
    lead = ranks[0]
    for r in ranks:
        check(r["launches"] == {n: 0 for n in r["launches"]},
              f"[train-mesh] rank {r['rank']} launched hand-written kernels: "
              f"{r['launches']}")
        check([r["losses"], r["more_losses"]] == [lead["losses"],
                                                  lead["more_losses"]],
              f"[train-mesh] rank {r['rank']}'s losses differ from rank 0's")
        check([{k: v[:2] for k, v in c.items()} for c in r["collectives"]]
              == [{k: v[:2] for k, v in c.items()}
                  for c in lead["collectives"]],
              f"[train-mesh] rank {r['rank']} issued other collectives")
        check(all(c.get(SEQ_IN, [0])[0] > 0 and c.get(SEQ_OUT, [0])[0] > 0
                  and "seq_out_gather" not in c
                  for c in r["collectives"]),
              f"[train-mesh] rank {r['rank']}: a step did not split the "
              f"residual over 'model' ({r['collectives']})")
    got = lead["losses"] + lead["more_losses"]
    got_gn = lead["grad_norms"] + lead["more_grad_norms"]
    rel = max(max(abs(a - b) / abs(b) for a, b in zip(got, one[0])),
              max(abs(a - b) / abs(b) for a, b in zip(got_gn, one[1])))
    check(rel <= TRAIN_MESH_TOL,
          f"[train-mesh] mesh losses {got} / grad norms {got_gn} vs one "
          f"card's {one[0]} / {one[1]}: rel {rel:.2e} > {TRAIN_MESH_TOL}")
    i8 = lead["int8_gather"]
    i8_rel = abs(i8["loss"] - got[0]) / abs(got[0])
    check(i8["finite"] and i8_rel <= INT8_GATHER_TOL,
          f"[train-mesh] int8 FSDP gather: loss {i8['loss']} vs f32 "
          f"{got[0]} (rel {i8_rel:.2e}), finite {i8['finite']}")
    pod = lead["int8_pod"]
    pod_rel = abs(pod["loss"] - got[0]) / abs(got[0])
    pod_gn_rel = abs(pod["grad_norm"] - one[1][0]) / abs(one[1][0])
    check(all(math.isfinite(v) for v in (pod["loss"], pod["grad_norm"]))
          and pod_rel <= TRAIN_MESH_TOL and pod_gn_rel <= INT8_POD_TOL
          and pod["residual_max"] > 0,
          f"[train-mesh] int8_pod step: loss {pod['loss']} vs {got[0]}, "
          f"grad_norm {pod['grad_norm']} vs {one[1][0]} (rel "
          f"{pod_gn_rel:.2e}, tol {INT8_POD_TOL}), residual max "
          f"{pod['residual_max']}")
    # the mesh's checkpoint onto one device, the steps after it
    t0 = time.perf_counter()
    state = RT.init_state(cfg, tcfg, generator=generator(1, "cuda"),
                          device="cuda")
    state = driver._restore(CheckpointManager(str(TRAIN_MESH_DIR)), steps,
                            state)
    restore_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in TRAIN_MESH_DIR.rglob("*")
               if f.is_file())
    after = train_mesh_steps(state, cfg, tcfg, data, more, "cuda",
                             first=steps)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    rel11 = max(abs(a - b) / abs(b)
                for a, b in zip(after[0], lead["more_losses"]))
    check(rel11 <= TRAIN_MESH_TOL,
          f"[train-mesh] restored onto 1x1: losses {after[0]} vs the mesh's "
          f"{lead['more_losses']} (rel {rel11:.2e})")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for r in ranks:
        step_ms = statistics.median(r["step_ms"][1:] + r["more_ms"])
        r["median_step_ms"] = step_ms
        print(f"[train-mesh] rank {r['rank']} on {r['device']} ({card}, "
              f"{r['transport']}): step {step_ms:.1f} ms (median of steps "
              f"2-{steps + more}; step 1 {r['step_ms'][0]:.1f} ms), "
              f"{tokens / (step_ms / 1e3):.0f} tokens/s, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; state built in "
              f"{r['init_s']:.1f}s, checkpoint saved in {r['save_s']:.1f}s",
              flush=True)
    per_step = lead["collectives"][-1]
    coll_s = sum(v[2] for v in per_step.values())
    print(f"[train-mesh] collectives a step (rank 0, step {steps}): "
          + ", ".join(f"{k} {c} ({b / 2**20:.1f} MiB, {t * 1e3:.0f} ms)"
                      for k, (c, b, t) in per_step.items())
          + f"; {coll_s * 1e3:.0f} ms of the step's "
          f"{lead['step_ms'][-1]:.0f} in collectives", flush=True)
    one_ms = statistics.median(one[2][1:])
    print(f"[train-mesh] gemma-2b full width, {TRAIN_MESH['layers']} layers, "
          f"f32, remat, {TRAIN_BATCH} x {TRAIN_SEQ} tokens on (data=2, "
          f"model=2), 4 ranks sharing one card ({card}): losses {got} == one "
          f"card's {one[0]}, grad norms within rel {rel:.2e} (tol "
          f"{TRAIN_MESH_TOL}); one card {one_ms:.1f} ms a step; ranks' run "
          f"{ranks_s:.1f}s", flush=True)
    print(f"[train-mesh] int8 FSDP gather: loss {i8['loss']:.6f} vs f32 "
          f"{got[0]:.6f} (rel {i8_rel:.2e}, tol {INT8_GATHER_TOL}); int8_pod "
          f"on (pod=2, data=1, model=2): loss {pod['loss']:.6f}, grad_norm "
          f"{pod['grad_norm']:.6f} vs {one[1][0]:.6f} (rel {pod_gn_rel:.2e}, "
          f"tol {INT8_POD_TOL}), step {pod['ms']:.1f} ms, residual max "
          f"{pod['residual_max']:.3e}; collectives "
          + ", ".join(f"{k} {v[0]}" for k, v in pod["collectives"].items()),
          flush=True)
    print(f"[train-mesh] step-{steps} checkpoint ({size / 2**30:.2f} GiB, "
          f"whole leaves) restored onto one device in {restore_s:.1f}s: "
          f"losses {after[0]} == the mesh's {lead['more_losses']} (rel "
          f"{rel11:.2e})", flush=True)
    return dict(ranks=ranks, one_card=dict(losses=one[0], grad_norms=one[1],
                                           step_ms=one[2]),
                rel=rel, int8_rel=i8_rel, int8_pod_rel=pod_gn_rel,
                restored=dict(
                    losses=after[0], rel=rel11, s=restore_s),
                checkpoint_bytes=size, ranks_s=ranks_s)


# ------------------------------------------- every family trains on a mesh
# full width, at a depth that fits beside the other phases, one step each
# on the train phase's batch (8 x 128 lcg tokens, seed 0), f32
# activations, AdamW, remat: qwen2-moe 1 layer (~1.19 B parameters, 60
# experts over model=2: expert-parallel), jamba 1 layer (the first of its
# pattern, a Mamba block and MLP), xlstm-1.3b 8 (7 mLSTM and the sLSTM),
# whisper-medium 2 + 2
# over 1500 stub frames, phi-3-vision 2 with 576 patches.  llama4 (one
# MoE layer is ~16 B parameters) and jamba's mamba_moe layer (~2.8 B,
# ~45 GB of f32 AdamW state) train on a mesh in the CPU tests at SMOKE
# width only.
TRAIN_FAMILIES = (("qwen2_moe", dict(num_layers=1)),
                  ("jamba_v01", dict(num_layers=1,
                                     block_pattern=("mamba",))),
                  ("xlstm_1b3", dict(num_layers=8)),
                  ("whisper_medium", dict(num_layers=2, encoder_layers=2)),
                  ("phi3_vision", dict(num_layers=2)))
FAMILY_FRAMES = 1500  # whisper's 30-second window of stub frames
FAMILY_METRICS = ("loss", "grad_norm", "load_balance", "dropped_frac")


def family_cfg(arch, extra):
    from repro_torch import configs

    return configs.get_config(arch).replace(dtype="float32", **extra)


def family_step(cfg, device, mesh=None):
    """One train step of ``cfg`` from seed 0 on batch 0 of the train
    phase's lcg stream (whisper's frames, phi-3's patches added; on
    ``mesh``, this rank's rows): its ``FAMILY_METRICS``, step ms (host
    clock, synchronised), peak bytes allocated, the collectives by kind
    ([count, bytes])."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.device import generator
    from repro_torch.distributed import collectives as coll
    from repro_torch.runtime import train as RT

    tcfg = train_config(TRAIN_STEPS)
    state = RT.init_state(cfg, tcfg, generator=generator(0, device),
                          device=device, mesh=mesh)
    data = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ + 1,
        global_batch=TRAIN_BATCH, seed=0, frontend=cfg.frontend,
        d_model=cfg.d_model, num_frames=FAMILY_FRAMES,
        num_patches=cfg.num_patches))
    batch = data.device_batch(0, device=device, mesh=mesh)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    coll.reset_counts()
    t0 = time.perf_counter()
    state, met = RT.train_step(state, batch, cfg, tcfg)
    met = {k: float(met[k]) for k in FAMILY_METRICS}
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    out = dict(metrics=met, ms=ms,
               peak_bytes=torch.cuda.max_memory_allocated(device),
               params=sum(t.numel() for t in state["params"].buffers()),
               collectives={k: [coll.counts[k], coll.nbytes[k]]
                            for k in sorted(coll.counts)})
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_families_rank(rank, device, families):
    """One rank of the (data=2, model=2) mesh: one step of each of
    ``families`` ({arch, config fields}) from seed 0 (:func:`family_step`);
    hand-written kernel launches counted over the whole run."""
    import torch

    from repro_torch.distributed.collectives import transport
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mod in KERNELS.values():
        mod.launches = 0
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {arch: family_step(family_cfg(arch, extra), device, mesh)
           for arch, extra in families}
    return dict(rank=rank, device=str(device), families=out,
                transport=transport(),
                launches={n: mod.launches for n, mod in KERNELS.items()})


def phase_train_families(card):
    """Every model family trains on a mesh (``moe.moe_apply_tp``,
    ``mamba.mamba_apply_tp``, ``xlstm.*_block_apply_tp``, the encoder and
    cross attention, the patches ahead of the text): each of
    ``TRAIN_FAMILIES`` at full width, one step on the card alone, then
    one step on (data=2, model=2), four ranks sharing ``cuda:0`` over
    host-staged gloo, all families in one spawn of the ranks.  Each
    family's loss, grad_norm, load_balance and dropped_frac within
    ``TRAIN_MESH_TOL`` of the card alone's (relative; a zero must stay
    zero), every rank's metrics and collectives alike, no hand-written
    kernel launched; the residual split over 'model' between blocks
    (``seq_in_gather`` counted).  Per family: step ms, peak GiB a rank,
    the collectives by kind and bytes."""
    from repro_torch.distributed.collectives import SEQ_IN
    from repro_torch.launch.mesh import run_ranks

    one = {arch: family_step(family_cfg(arch, extra), "cuda")
           for arch, extra in TRAIN_FAMILIES}
    t0 = time.perf_counter()
    ranks = run_ranks(train_families_rank, 4, TRAIN_FAMILIES,
                      devices=["cuda:0"] * 4, timeout=900)
    ranks_s = time.perf_counter() - t0
    lead = ranks[0]
    out = dict(one_card=one, ranks=ranks, ranks_s=ranks_s, rel={})
    for r in ranks:
        check(r["launches"] == {n: 0 for n in r["launches"]},
              f"[train-mesh-families] rank {r['rank']} launched "
              f"hand-written kernels: {r['launches']}")
    for arch, extra in TRAIN_FAMILIES:
        fam = [r["families"][arch] for r in ranks]
        for r, f in zip(ranks, fam):
            check(f["metrics"] == fam[0]["metrics"]
                  and f["collectives"] == fam[0]["collectives"],
                  f"[train-mesh-families] {arch}: rank {r['rank']}'s "
                  "metrics or collectives differ from rank 0's")
        c = fam[0]["collectives"]
        check(c.get(SEQ_IN, [0])[0] > 0 and "seq_out_gather" not in c,
              f"[train-mesh-families] {arch}: the step did not split the "
              f"residual over 'model' ({c})")
        got, want = fam[0]["metrics"], one[arch]["metrics"]
        rel = max(abs(got[k] - want[k]) / abs(want[k]) if want[k]
                  else abs(got[k]) * math.inf if got[k] else 0.0
                  for k in FAMILY_METRICS)
        out["rel"][arch] = rel
        check(rel <= TRAIN_MESH_TOL,
              f"[train-mesh-families] {arch}: mesh {got} vs one card's "
              f"{want}: rel {rel:.2e} > {TRAIN_MESH_TOL}")
        cfg = family_cfg(arch, extra)
        print(f"[train-mesh-families] {arch} full width, {cfg.num_layers} "
              f"layer(s)"
              + (f" + {cfg.encoder_layers} encoder" if cfg.is_encdec else "")
              + f", {one[arch]['params']:,} params, f32, remat, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens on (data=2, model=2), 4 "
              f"ranks sharing one card ({card}, {lead['transport']}): "
              + ", ".join(f"{k} {got[k]:.6g}" for k in FAMILY_METRICS)
              + f" == one card's within rel {rel:.2e} (tol "
              f"{TRAIN_MESH_TOL}); step "
              + "/".join(f"{f['ms']:.0f}" for f in fam)
              + f" ms a rank (one card {one[arch]['ms']:.0f}), peak "
              + "/".join(f"{f['peak_bytes'] / 2**30:.2f}" for f in fam)
              + f" GiB a rank (one card "
              f"{one[arch]['peak_bytes'] / 2**30:.2f}); collectives (rank 0) "
              + ", ".join(f"{k} {c} ({b / 2**20:.1f} MiB)"
                          for k, (c, b) in fam[0]["collectives"].items()),
              flush=True)
    print(f"[train-mesh-families] {len(TRAIN_FAMILIES)} families, one spawn "
          f"of 4 ranks: {ranks_s:.1f}s; no hand-written kernel launched",
          flush=True)
    return out


def train_nccl_rank(rank, device, steps):
    """One rank of the (data=2, model=2) run at full depth, one card a
    rank over NCCL: ``steps`` steps."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed.collectives import transport
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import train as RT

    from repro_torch.distributed import collectives as coll

    torch.backends.cuda.matmul.allow_tf32 = False
    coll.set_timing(True)
    cfg = train_mesh_cfg(18)
    tcfg = train_config(TRAIN_STEPS)
    mesh = make_mesh((2, 2), ("data", "model"))
    state = RT.init_state(cfg, tcfg, generator=generator(0, device),
                          device=device, mesh=mesh)
    torch.cuda.reset_peak_memory_stats(device)
    losses, gnorms, ms, colls = train_mesh_steps(
        state, cfg, tcfg, train_stream(), steps, device, mesh)
    return dict(rank=rank, device=str(device), losses=losses,
                grad_norms=gnorms, step_ms=ms, collectives=colls[-1],
                peak_bytes=torch.cuda.max_memory_allocated(device),
                transport=transport())


def phase_train_mesh_nccl(card):
    """The (data=2, model=2) run at full depth (18 layers) one rank a card
    over NCCL, 3 steps, held to the same steps on ``cuda:0`` alone: each
    step's loss and grad_norm within ``TRAIN_MESH_TOL``, every rank
    alike; step ms, tokens/s and peak GiB per rank, the collectives a
    step."""
    import torch

    from repro_torch.device import generator
    from repro_torch.distributed.collectives import NCCL
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.runtime import train as RT

    cfg, tcfg = train_mesh_cfg(18), train_config(TRAIN_STEPS)
    state = RT.init_state(cfg, tcfg, generator=generator(0, "cuda"),
                          device="cuda")
    one = train_mesh_steps(state, cfg, tcfg, train_stream(),
                           TRAIN_MESH["steps"], "cuda")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_ranks(train_nccl_rank, 4, TRAIN_MESH["steps"],
                      devices=[f"cuda:{i}" for i in range(4)], timeout=900)
    lead = ranks[0]
    for r in ranks:
        check(r["transport"] == NCCL and r["losses"] == lead["losses"]
              and r["grad_norms"] == lead["grad_norms"],
              f"[train-mesh-nccl] rank {r['rank']}: {r['transport']}, "
              f"losses {r['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(lead["losses"] + lead["grad_norms"], one[0] + one[1]))
    check(rel <= TRAIN_MESH_TOL,
          f"[train-mesh-nccl] losses {lead['losses']} / grad norms "
          f"{lead['grad_norms']} vs one card's {one[0]} / {one[1]}: rel "
          f"{rel:.2e} > {TRAIN_MESH_TOL}")
    print(f"[train-mesh-nccl] 18 layers: losses {lead['losses']} == one "
          f"card's {one[0]}, grad norms within rel {rel:.2e} (tol "
          f"{TRAIN_MESH_TOL}); one card {statistics.median(one[2][1:]):.1f} "
          "ms a step", flush=True)
    for r in ranks:
        step_ms = statistics.median(r["step_ms"][1:])
        print(f"[train-mesh-nccl] rank {r['rank']} on {r['device']} "
              f"({card}): step {step_ms:.1f} ms, "
              f"{TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3):.0f} tokens/s, "
              f"peak {r['peak_bytes'] / 2**30:.2f} GiB; losses {r['losses']}",
              flush=True)
    print("[train-mesh-nccl] collectives a step: " + ", ".join(
        f"{k} {c} ({b / 2**20:.1f} MiB, {t * 1e3:.0f} ms)"
        for k, (c, b, t) in lead["collectives"].items()), flush=True)
    return dict(ranks=ranks, one_card=dict(losses=one[0],
                                           grad_norms=one[1],
                                           step_ms=one[2]), rel=rel)


DRYRUN_DIR = ROOT / "chiprun_out" / "dryrun"


# the dry run's cells: (shape, mesh, quant) of gemma-2b, each a process
DRYRUN_CELLS = (("train_4k", "single", "bf16"), ("train_4k", "multi", "bf16"),
                ("prefill_32k", "single", "msgemm"),
                ("decode_32k", "single", "msgemm"))


def start_dryrun():
    """Start the dry run's cells (``DRYRUN_CELLS``), each a process of its
    own on the host alone (no card: a fake process group and fake
    tensors): ``python -m repro_torch.launch.dryrun --arch gemma_2b
    --shape S --mesh M``, the train step on the single (16 x 16) and the
    multi-pod (2 x 16 x 16) production mesh, a prefill and a decode step
    (msgemm weights, the serve rules) on the single-pod one.  Returns
    ({cell: process}, the start time)."""
    import shutil

    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma_2b", "--shape", cell[0], "--mesh", cell[1], "--out",
         str(DRYRUN_DIR)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for cell in DRYRUN_CELLS}
    return procs, time.perf_counter()


def phase_dryrun():
    """The dry run's cells (:func:`start_dryrun`), with no other phase
    running: each ``ok``, its GiB per device and collectives by kind; the
    seconds from their start to their collection."""
    procs, t0 = start_dryrun()
    out = {}
    for (shape, mesh, quant), proc in procs.items():
        name = f"{shape}/{mesh}"
        text, _ = proc.communicate(timeout=900)
        check(proc.returncode == 0,
              f"[dryrun] {name}: exit {proc.returncode}\n{text[-4000:]}")
        cell = json.loads((DRYRUN_DIR / f"gemma_2b__{shape}__{mesh}__{quant}"
                           ".json").read_text())
        check(cell["status"] == "ok", f"[dryrun] {name}: {cell}")
        mem = cell["memory"]
        how = (f"in {cell['microbatches']} microbatches" if shape ==
               "train_4k" else f"msgemm d={cell['d']} weights, "
               f"'{cell['rules']}' rules")
        print(f"[dryrun] gemma-2b {shape} on {cell['mesh']} "
              f"({cell['devices']} ranks, one rank faked on the host): "
              f"arguments {mem['argument_bytes_per_device'] / 2**30:.3f} "
              f"GiB/device, peak {mem['peak_bytes_per_device'] / 2**30:.3f} "
              f"GiB/device (MemTracker), {cell['local_batch']} rows a rank "
              f"{how}, step {cell['step_s']:.1f}s on the host; collectives "
              + ", ".join(f"{k} {v['count']} ({v['bytes'] / 2**30:.3f} GiB)"
                          for k, v in cell["collectives"].items()),
              flush=True)
        out[name] = cell
    out["wall_s"] = time.perf_counter() - t0
    print(f"[dryrun] {len(DRYRUN_CELLS)} cells done, collected "
          f"{out['wall_s']:.1f}s after they started", flush=True)
    return out


PHASE_S: dict = {}


def phase(name, fn, *args, **kw):
    """Run one phase; print and keep its seconds (``[phase] name s``)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[name] = time.perf_counter() - t0
    print(f"[phase] {name} {PHASE_S[name]:.1f}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the engine (torch.profiler) with "
                         "msgemm weights at kv16 and kv8, and int4 weights")
    ap.add_argument("--sweep", nargs="?", const="all",
                    choices=("all", "msgemm", "attention", "int4"),
                    help="only build and time the kernel variants: msGeMM "
                         "rows per block, flash tiles and stages, "
                         "paged-attention chunk lengths, int4 GeMM split "
                         "counts, or one of those (chiprun_out/sweep.json)")
    ap.add_argument("--only", choices=("train", "mesh", "mesh-seq"),
                    help="only build, then run this phase (a probe: no "
                         "kernels line and no ok line); 'mesh' runs the "
                         "mesh phases (kernels at local shapes, the "
                         "two-rank engine, the calibration of expert "
                         "stacks, training on a mesh, sequence-parallel "
                         "attention, the dry run); 'mesh-seq' the "
                         "sequence-parallel attention alone")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import nvcc
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    # every plan lookup of this run, from the first engine on, reads the
    # plan cache in chiprun_out/, empty at the start, never the user's;
    # no calibration yet, so the plan phase's tuner sweeps in full
    from repro_torch import dispatch, obs

    PLAN_CACHE.parent.mkdir(exist_ok=True)
    for path in (PLAN_CACHE, PLAN_CLI, PLAN_METRICS, CALIBRATION):
        path.unlink(missing_ok=True)
    os.environ["REPRO_PLAN_CACHE"] = str(PLAN_CACHE)
    os.environ["REPRO_CALIBRATION"] = str(CALIBRATION)
    dispatch.set_cache_path(PLAN_CACHE)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"

    t0 = time.perf_counter()
    libs = nvcc.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(p.name for p in libs.values())} in "
          f"{build_s:.1f}s", flush=True)
    PHASE_S["build"] = build_s
    print(f"[phase] build {build_s:.1f}", flush=True)

    if args.sweep:
        rows = []
        if args.sweep in ("all", "msgemm"):
            rows += phase_sweep()
        if args.sweep in ("all", "attention"):
            rows += phase_sweep_attention()
        if args.sweep in ("all", "int4"):
            rows += phase_sweep_int4()
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "sweep.json").write_text(json.dumps(rows, indent=1))
        return 0
    if args.only:
        if args.only == "train":
            res = phase(args.only, phase_train)
        elif args.only == "mesh-seq":
            res = phase(args.only, phase_mesh_seq, card)
        else:
            res = phase_mesh(card, only=True)
            res["dryrun"] = phase("dryrun", phase_dryrun)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / f"chip_smoke_{args.only}.json").write_text(json.dumps(
            dict(result=res, phase_s=PHASE_S), indent=1, default=str))
        print(f"[report] total {time.perf_counter() - t_start:.1f}s")
        return 0
    cases = phase("kernels", phase_kernels)
    int4_cases = phase("int4-kernels", phase_int4_kernels)
    expert_cases = phase("int4-experts", phase_int4_experts)
    arch_gemm = phase("arch-gemms", phase_arch_gemms)
    attn_cases = phase("attn-kernels", phase_attn_kernels)
    flash = phase("flash", phase_flash)
    main_path = phase("main", phase_main)
    model, cfg = main_path.pop("model"), main_path.pop("cfg")
    kvq_path = phase("main-kvq", phase_main_kvq, model, cfg,
                     main_path["tokens"])
    if args.profile:
        from repro_torch.kvq import KVQuantSpec

        main_path["profile"] = phase_profile("msgemm", model, cfg)
        kvq_path["kv8"]["profile"] = phase_profile(
            "msgemm-kv8", model, cfg, kv_quant=KVQuantSpec(8))
    # the plan phase; every later path runs without a tuning policy
    check(len(dispatch.cache()) == 0,
          "[plan] the untuned paths wrote the plan cache")
    obs.registry().reset(prefix="kernel_")
    plan_path = {"msgemm": phase("plan-msgemm", phase_plan, "plan-msgemm",
                                 model, cfg, main_path, dict(msgemm=126))}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    int4_path = phase("main-int4", phase_main_int4, main_path["tokens"])
    model, cfg = int4_path.pop("model"), int4_path.pop("cfg")
    if args.profile:
        int4_path["profile"] = phase_profile("int4", model, cfg)
    plan_path["int4"] = phase("plan-int4", phase_plan, "plan-int4", model,
                              cfg, int4_path, dict(int4_matmul=126))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    plan_path["cli"] = phase("plan-cli", phase_plan_cli)
    dispatch.set_cache_path(PLAN_CACHE)  # the serve CLI pointed it away
    calib_path = phase("calib", phase_calib, main_path, int4_path)
    res_path = phase("resilience", phase_resilience, card)
    gemma2 = phase("gemma2-9b", phase_gemma2_9b)
    arch = phase("arch", phase_arch, profile=args.profile)
    recurrent = phase("recurrent", phase_recurrent)
    encdec = phase("encdec", phase_encdec)
    train = phase("train", phase_train)
    mesh = phase_mesh(card, main_path)

    def layer_entry(gemm_cases, gemms=GEMMA_GEMMS, model="gemma-2b",
                    x_dtype="float32"):
        """Timing keys summed over one layer's seven GeMMs at the engine's
        decode shape (b = max_slots = 4; wv is timed as wk), x and the
        residual in ``x_dtype``."""
        names = {n for n, *_ in gemms}
        layer = [c for c in gemm_cases if c["b"] == 4 and c["name"] in names
                 and c.get("x_dtype", x_dtype) == x_dtype]
        layer += [dict(c, name=c["name"].replace("wk", "wv"))
                  for c in layer if c["name"].endswith("wk")]
        tot = {key: sum(c[key] for c in layer)
               for key in ("ms", "plain_ms", "library_ms", "bytes", "ops",
                           "mma_ops")}
        return with_bound(
            {"max_abs_err": max(c["max_abs_err"] for c in gemm_cases),
             "ms": tot["ms"], "plain_ms": tot["plain_ms"],
             "library_ms": tot["library_ms"],
             "shape": f"sum of one {model} layer's 7 GeMMs at b=4, "
                      f"{x_dtype} x"},
            tot["bytes"], tot["ops"], tot["mma_ops"])

    # the MoE models' runs: their int4 launches are the expert stacks'
    moe_runs = [r for key in ("qwen2-moe", "llama4") for r in (
        arch[key], arch[key]["eager"], *(arch[key]["kv8"][r] for r in (
            "kernel", "torch")))] + [recurrent["jamba"]] + [
        r for key in ("moe", "moe_nccl") for r in mesh.get(key, {}).get(
            "ranks", [])] + [
        r for run in mesh.get("moe_fsdp", {}).values()
        for r in run["ranks"]] + [
        r["jamba_v01"] for key in ("static", "static_nccl")
        for r in mesh.get(key, {}).get("ranks", [])]
    # the static mesh runs of the families without experts
    static_runs = [r[arch_] for key in ("static", "static_nccl")
                   for r in mesh.get(key, {}).get("ranks", [])
                   for arch_, _ in MESH_STATIC if arch_ != "jamba_v01"]
    # every path's engine runs, each read with the counts set to 0 before
    runs = ([main_path, main_path["eager"], int4_path, int4_path["eager"],
             kvq_path["kv8"]["kernel-eager"]]
            + [kvq_path[kv][r] for kv in ("kv8", "kv4")
               for r in ("kernel", "torch")]
            + [plan_path[mode][r] if r else plan_path[mode]
               for mode in ("msgemm", "int4") for r in ("", "eager",
                                                        "traced")]
            + [plan_path["cli"][r] for r in ("tune", "sentinel")]
            + [calib_path["serve"],
               calib_path["int4"]["serve"]]
            + [calib_path["kv4_learned"][r] for r in ("kernel", "torch")]
            + [gemma2[k] for k in ("msgemm", "int4", "long", "long-eager")]
            + [gemma2["kv8"][r] for r in ("kernel", "torch")]
            + [res_path[k] for k in ("clean", "latency", "oom", "step_fail",
                                     "disconnect", "nan_logits", "ladder",
                                     "hang", "combined", "cli")]
            + moe_runs + [arch[k] for k in ("codeqwen-msgemm",
                                            "codeqwen-int4", "starcoder2",
                                            "gpt3")]
            + [arch[k]["f32"] for k in ("codeqwen-msgemm", "codeqwen-int4",
                                        "starcoder2", "gpt3")]
            + [arch["codeqwen-msgemm"]["f32_kv8"][r]
               for r in ("kernel", "torch")]
            + [recurrent[k] for k in ("xlstm", "xlstm-int4")]
            + [encdec[k] for k in ("whisper", "whisper-1500", "whisper-int4",
                                   "phi3")]
            + [train["serve"]["engine"]]
            + [train["serve"]["kv8"][r] for r in ("kernel", "torch")]
            + [mesh[k]["serve"] for k in ("calib_moe",) if k in mesh]
            + mesh["engine"]["ranks"]
            + ([mesh["tune"]["ref"]] + mesh["tune"]["ranks"]
               if "tune" in mesh else [])
            + [r[k] for r in mesh["fsdp"]["ranks"]
               for k in ("default", "serve", "whisper")]
            + mesh.get("engine_nccl", {}).get("ranks", []) + static_runs
            + [r["mesh"] for r in mesh["seq"]["serve"]]
            + [mesh["seq"]["serve"][0]["single"]])
    launched = {name: sum(r["launches"][name] for r in runs
                          if name in r["launches"])
                for name in ("msgemm", "int4_matmul", "paged_attention")}
    decode = next(c for c in attn_cases if c["name"] == "decode-kv8")
    up = next(c for c in expert_cases if c["name"] == "qwen2-moe-up")
    fl = next(c for c in flash["cases"] if c["dtype"] == "bfloat16"
              and c["name"] == "gemma-2b-prefill-8k")
    kernels = [
        {"name": "msgemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/msgemm.cu",
         "replaces": "src/repro/kernels/msgemm.py:252",
         "launches": launched["msgemm"],
         **layer_entry(cases + arch_gemm["msgemm"])},
        {"name": "int4_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/int4_matmul.cu",
         "replaces": "src/repro/kernels/int4_matmul.py:165",
         "launches": launched["int4_matmul"],
         **layer_entry(int4_cases + arch_gemm["int4"])},
        {"name": "int4_matmul_experts", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/int4_matmul.cu",
         "replaces": "src/repro/kernels/int4_matmul.py:165",
         "launches": sum(r["launches"]["int4_matmul"] for r in moe_runs),
         "max_abs_err": max(c["max_abs_err"] for c in expert_cases),
         "ms": up["ms"], "plain_ms": up["plain_ms"],
         "bound_ms": up["bound_ms"], "bound_by": up["bound_by"],
         "library_ms": up["library_ms"],
         "shape": "qwen2-moe's up over its 60-expert stack at decode, one "
                  "launch: E=60, m=1408, k=2048, b=16 (4 slots x capacity "
                  "4), bf16 x and out; launches are the MoE engine runs' "
                  "and jamba's static runs' int4 launches, on one device "
                  "and on a mesh (experts only: their dense linears run "
                  "msGeMM); library_ms is torch.matmul of the dequantized "
                  "f32 stack"},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:157",
         "launches": launched["paged_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in attn_cases),
         "ms": decode["ms"], "plain_ms": decode["plain_ms"],
         "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
         "library_ms": decode["library_ms"],
         "shape": "gemma-2b decode at kv8: B=4, C=1, H=8, Hk=1, Dh=256, "
                  "block 8, 32 view slots; library_ms is sdpa on the "
                  "dequantized f32 view"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:104",
         "launches": flash["launches"]["flash_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in flash["cases"]),
         "ms": fl["ms"], "plain_ms": fl["plain_ms"],
         "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
         "library_ms": fl["library_ms"],
         "shape": "gemma-2b prefill, bf16: B=1, H=8, Hk=1, dh=256, S=8192, "
                  "causal; launches are the op's path (5 shapes x bf16, "
                  "f32); library_ms is sdpa(is_causal, enable_gqa)"},
    ]
    layers = {"gemma2-9b msgemm": layer_entry(cases, GEMMA2_GEMMS,
                                              "gemma2-9b"),
              "gemma-2b msgemm bf16": layer_entry(cases, x_dtype="bfloat16"),
              "gemma2-9b msgemm bf16": layer_entry(
                  cases, GEMMA2_GEMMS, "gemma2-9b", "bfloat16"),
              "gemma2-9b int4": layer_entry(int4_cases, GEMMA2_GEMMS,
                                            "gemma2-9b"),
              "gemma-2b int4 bf16": layer_entry(int4_cases,
                                                x_dtype="bfloat16"),
              "gemma2-9b int4 bf16": layer_entry(
                  int4_cases, GEMMA2_GEMMS, "gemma2-9b", "bfloat16")}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, ptxas=nvcc.reports, cases=cases,
        int4_cases=int4_cases, expert_cases=expert_cases,
        arch_gemm_cases=arch_gemm,
        attn_cases=attn_cases, flash=flash, arch=arch,
        main=main_path, kvq=kvq_path,
        int4=int4_path, plan=plan_path, calib=calib_path,
        resilience=res_path, gemma2_9b=gemma2, recurrent=recurrent,
        encdec=encdec, train=train, mesh=mesh,
        phase_s=PHASE_S,
        gemma2_9b_layers=layers,
        kernels=kernels, total_s=time.perf_counter() - t_start), indent=1))
    for key, e in ([("gemma-2b msgemm", kernels[0]),
                    ("gemma-2b int4", kernels[1])] + list(layers.items())):
        print(f"[report] {key} layer: kernel {e['ms']:.4f} ms, matmul "
              f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['shape']})")
    print("[report] phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_S.items()))
    print(f"[report] total {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
