#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile]

Drives the port's serving and training paths at the full CTC-3L-421H-UNI
width (123 MFCC features -> 3x421 peephole LSTM -> 62 CTC outputs, random
weights from a seed), serves Qwen3-14B at full width (11e) and trains
MiniCPM-2B at full width (11f), serves and trains the other LM families
(11g-11j), and checks them:

1. builds every CUDA kernel of the path from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together) and prints the build time;
2. holds K1 (``lstm_seq``) and K2 (``lstm_stack_seq_kernel``) against their
   plain PyTorch versions on the card at the serving shape (B = slots,
   T = chunk) and the training shape (B = 8, T = 64), ragged masks, nonzero
   h0/c0, and times both with CUDA events, with their launch geometry and
   the one-off cost of stacking K2's weights (``stack_kernel_weights``);
3. checks chunked == monolithic bit for bit (``torch.equal``) on both kernel
   backends;
4. serves ragged utterances through ``launch.serve.StreamServer`` on
   ``cuda_seq``, ``cuda_seq_fused`` and ``torch_scan``: the streams must
   agree across backends and with the monolithic ``forward``, and the
   launch counters must show L K1 launches per engine step on ``cuda_seq``
   and one K2 launch per step on ``cuda_seq_fused``; then serves them again
   on both kernel backends with async dispatch, and with the chunk-size
   policy (boundaries stepping down 16, 8, 4, ...) sync and async: every
   stream bit-equal to the sync fixed-chunk run, the launches per step
   unchanged, no speculation squashed, and chunks launched before the one
   ahead was committed in async mode only (``count_overlap``, which also
   counts those launched before the chunk ahead's read-back completed);
   then times the engine sync against async on both kernel backends, in
   ``ENGINE_PAIRS`` pairs of turns, order alternating (``engine_timing``),
   and, after 4a, on ``cuda_seq`` at 105 slots over 110 utterances of
   50-300 frames;
4a. F4, batch blocks (``f4_checks``): K1 at B = 105 and K2 at B = 25 (one
   stream past their largest single launch) allclose to their plain
   versions, every row bit-equal to a B = 8 launch that holds it; K3 on the
   inner plan at B = 121 and K4 at B = 97 ``torch.equal`` to theirs; each
   call two launches; and ``StreamingEngine(max_streams=105)`` on ``auto``
   built and drained, every stream allclose to ``forward``;
4b. the serving fault runtime on the main cell (``fault_runs``): the ladder
   ``cuda_seq_fused`` (K2) -> ``cuda_seq`` (K1) -> ``torch_scan`` by two
   permanent engine failures and back by two heals (``FAULT_LADDER``),
   under the bitwise canary, under ``canary_rtol`` and without the canary,
   sync and async: every chunk call logged with its rung and its K1/K2
   launches (the canary's shadow replays too), no stream lost, every
   stream allclose to a clean K2 engine and to ``forward``, async == sync
   (event trail, calls and bits), and the climb back to K2 landing without
   the canary; a transient fault and a poisoned slot at chunk
   ``FAULT_STEP`` on K2 and on K1 (one ``fault`` and no ``degrade``; one
   quarantined stream), every other stream ``torch.equal`` to a clean run;
   a stream preempted to disk and resumed in a second engine, its suffix
   ``torch.equal`` to the uninterrupted run; an int8 stream's K4 carries
   through the stream checkpointer between two chunks, ``torch.equal``;
   and the non-finite guard's cost: device ops per chunk from one traced
   drain with and without it, frames/s in ``FAULT_PAIRS`` pairs of turns
   (``fault_guard``), the bits equal;

and then the int8 silicon path (the deployment of the reference's
``examples/speech_ctc.py``) on the same f32 weights, each layer quantized
on ``SystolicPlan(n_x, 421, 96)``:

5. holds K3 (``lstm_seq_quantized``, on both layer plans) and K4
   (``lstm_stack_seq_kernel_q``, at the serving shape and at T = 64)
   against their plain versions, bit for bit (``torch.equal`` on the h and
   c codes; ``int8_case``), and times both, with their launch geometry and
   the one-off cost of building both kernels' weight layouts
   (``stack_kernel_weights_q``);
6. checks int8 chunked == monolithic bit for bit over 3 ragged chunks on
   both ``lstm_stack_seq_quantized_auto`` backends, and fused == layerwise
   == the reference chain ``systolic_layer_quantized`` x L;
7. runs 8 utterances of 50-300 frames through the int8 stack in chunks of
   16 on ``auto`` (which must pick ``fused``) and on ``layerwise``: the
   codes must agree, and the launch counters must show one K4 launch per
   chunk and L K3 launches per chunk; times further passes of both,
   interleaved; then dequantizes, applies the f32 read-out and
   ``log_softmax``, greedy-decodes, and prints the decode agreement with
   the f32 ``forward`` (reported, not asserted: the weights are random).

and then the training path (the reference CLI's batch 8 and sequence 64,
the same f32 weights' configuration from seed 0):

8. holds K5 (``lstm_gates_rec``, one recurrent step) against its plain
   version at the training shape (B = 8, N_h = 421, nonzero h and c) and
   times it (one launch; a launch of a 16-step ``cuda_step`` chain, whose
   launches 2 .. 16 stage their weights before the launch ahead has
   finished; and a launch of the same chain of public-op launches, which
   do not), its plain version, and the product alone (``torch.addmm``),
   with the geometry its timed launch used; checks ``lstm_layer_fused`` on
   ``cuda_step`` against ``cuda_seq`` over 16 steps;
9. compares every leaf's gradient of ``loss_fn`` (T = 16, B = 8) on
   ``cuda_step``, ``cuda_seq`` and ``cuda_seq_fused`` with the
   ``torch_scan`` Function's on the card, by relative Frobenius error;
10. runs six ``make_train_step`` steps on each of the three kernel backends
    from the same weights and ``SyntheticCTC`` batches: every loss finite,
    the loss histories in agreement, the launch counters at T*L K5
    launches per step on ``cuda_step``, L K1 on ``cuda_seq`` and one K2 on
    ``cuda_seq_fused``; the median step time after the first; then
    restores the step-3 checkpoint into a fresh state and checks that the
    next step's loss equals the uninterrupted run's bit for bit;
11. runs the trainer's entry point (``launch.train.main``) on ``cuda_step``
    as a user does: six steps with checkpoints every three, then
    ``--resume`` for two more; the losses printed must be finite, the
    resume must start at step 6, K5 must launch T*L times per step, and
    the runner's heartbeat file must name the last step; then one
    ``FaultTolerantRunner.run_step`` on ``cuda_seq_fused`` with a fault
    injected and a ``restore_fn`` (``fault_train``): the restored step
    bit-equal to the uninterrupted one (else within the gradient
    tolerance, and it says which);
11a. measured dispatch (``tune_phase``, ``repro_torch.tune``) at the
    serving shape: K4 against the K3 chain at tile 96
    (``tune_quantized_backend``, the candidates ``torch.equal`` before
    timing; ``TUNE_TRIALS`` trials, and once past K4's single launch at
    B = 97) and the serving loop at chunk depths 4, 8 and 16
    (``tune_serving_config``, the streams ``torch.equal`` across depths;
    ``TUNE_TRIALS // 2`` trials), ``TUNE_ITERS`` interleaved turns each,
    the medians printed; the last trials' cache
    saved, loaded to the same JSON and replayed; with it installed the
    int8 deploy's ``auto`` launches the kernel its entry names (and each
    backend under a cache naming it), and a ``--deadline-slo`` server's
    policy takes the tuned ceiling, its streams bit-equal to fixed
    chunks; then ``python -m repro_torch.tune --measure`` and ``python -m
    repro_torch.launch.serve --tune --schedule-cache`` as subprocesses;
11b. the lifecycle examples as subprocesses (``examples_phase``):
    ``repro_torch.examples.speech_ctc --steps 4`` at full width (train,
    quantize, int8 deploy equal to the plain chain with its kernel
    launched, streaming, Table 2) and ``repro_torch.examples.quickstart``;
11c. the paper's systolic scale-out with every engine on the card
    (``systolic_phase``): at T = 16, B = 8 the layerwise f32
    ``systolic_lstm_seq`` on ``2x2`` and ``5x7`` allclose to K1 (its
    masked chunks bit-equal to one masked call), the int8 form on ``5x5``
    ``torch.equal`` to K3, on ``graves-75`` the staged f32 form allclose
    to K2 (outputs, every layer's h_T and c_T) and placed once bit-equal
    to placed per call, the staged int8 form ``torch.equal`` to K4, and
    each form on the all-1
    ``single`` preset launching its single-engine kernel once; the f32
    engine cell with ``graves-75`` installed on ``auto`` (which must
    resolve to ``cuda_seq_fused_systolic``, launching no K1-K4) allclose
    to the ``cuda_seq_fused`` engine, with frames/s, p50 chunk ms and the
    device launches of one traced chunk, then its fault ladder down onto
    K2 and K1; the gradients of ``loss_fn`` under ``2x2`` (layerwise) and
    ``graves-75`` (staged) against ``cuda_seq_fused``'s; and ``python -m repro_torch.launch.serve
    --systolic-topology graves-75 --requests 2`` as a subprocess;
11d. die fault domains and the staged tuner (``die_phase``), every engine
    on the card: ``build_rungs`` for ``graves-3x25`` at full width held to
    3d, 2d, the layerwise 1d rung, K2, K1, the scan (needs 3, 2, 1, 0, 0,
    0); the f32 engine cell on ``auto`` under ``graves-3x25`` unfaulted,
    then with die 2 lost at chunk 2 and healed at 5 (hysteresis 2), sync
    and async: the trail degrade, heal, promote_canary, promote, the
    degrade onto the 2-stage mesh (no K1-K4 launch there), every stream
    ``torch.equal`` to the unfaulted drain, async event counts equal to
    sync; all three dies lost (onto K2, then K1 at chunk 4, both launched
    and counted); two dies lost and one healed, the canary from the 1d
    rung back to 2d printed (a rejection is an outcome); ms a chunk and
    the device ops of one traced chunk on each die rung; then
    ``tune_staged_stack`` measured on ``graves-75``, the reference's
    arithmetic class probed (bit-equal to (3, 5, 5) or not),
    ``tune_geometry`` measured at 75 engines with ref (3, 5, 5) (in the
    port's class and with ``allow_reassoc``), the winner's cache installed
    and one chunk served on its mesh (its split and Tc taken), and
    ``python -m repro_torch.tune --staged-devices 75 --geometry`` as a
    subprocess;
11e. the dense LM family (``lm_phase``, TF32 and bf16 reduced-precision
    reductions off): Qwen3-14B built at full width on the card from a
    seeded CUDA generator (40 layers, d_model 5120, 40 heads on 8 kv
    heads, bf16; its 14,768,307,200 parameters and 29.54 GB checked
    against its shapes); K8 against its plain version on q, k, v captured
    from its layer 0 (decode rows at positions 127, 63 and 0 of a 128-key
    cache, the split schedule; a 64-token prefill, tiled), bf16 tolerance;
    64 tokens through ``forward_lm`` and through ``decode_step`` on
    ``attn_backend`` 'auto' (K8) and 'torch' (the plain attention), every
    logit row within ``LM_LOGIT_REL`` of the logit scale, argmax agreement
    printed; the main path with every kernel counter set to 0 just before
    and read just after: 6 requests through ``launch.serve.SlotServer``
    (4 slots, 16 new tokens, prompts fed token by token, K8's decode),
    K8 launched 40 times a call and nothing else; then, counted apart,
    each served sequence scored by ``forward_lm`` (K8's prefill, 40
    launches a sequence; its argmax must reproduce at least
    ``LM_AGREE_MIN`` of the served tokens); a decode step's wall, host
    issue and traced device time on both backends beside its bound; the
    model freed; ``python -m
    repro_torch.launch.serve --arch qwen3-14b --requests 6 --slots 4
    --max-new 16`` as a subprocess (K8 launches > 0); and one replay each
    of ``qwen2.5-14b`` (qkv bias), ``codeqwen1.5-7b`` (MHA) and
    ``minicpm-2b`` (tied embeddings) at their smoke size;
11f. the dense LM trained (``lm_train_phase``, after Qwen3-14B is freed):
    K8's forward with its log-sum-exp and its two backward kernels
    (``flash_attention_bwd_kv``: dk, dv; ``flash_attention_bwd_q``: dq)
    against their plain versions at MiniCPM-2B's shape (B 2, 36 heads, S
    4096, D 64, f32) and Qwen3-14B's (40 on 8 heads, D 128, S 1024, bf16,
    causal and with a window of 256), each timed beside its bound and
    SDPA (forward; backward from a kept graph); MiniCPM-2B built at full
    width from a seeded CUDA generator (2,724,880,896 parameters, f32,
    checked against its shapes); one batch's gradients on K8 against the
    plain attention within ``LM_GRAD_REL``; the main path with every
    kernel counter set to 0 just before and read just after: three
    donating ``make_train_step`` steps (AdamW + WSD, remat 'full') under
    ``FaultTolerantRunner`` over ``HostLoader`` and ``SyntheticLM`` at 2 x
    4096 tokens (the repo's train_4k shape with batch cut from 256), each
    step's loss and gradient norm finite, its wall ms and launches (K8
    forward twice a layer, each backward kernel once, nothing else), the
    resident state and the peak memory; a traced step; ``lm_100m`` of
    ``examples.train_lm`` 2 + 2 steps through a checkpoint ``torch.equal``
    to 4 straight; and the train CLI (``--arch minicpm-2b --smoke``, then
    ``--resume``) and ``examples.train_lm --tiny`` as subprocesses (K8's
    forward and backward launched; the small sizes because a full-width
    final checkpoint is 32.7 GB).
11g. the MoE family served (``moe_phase``, after MiniCPM-2B is freed;
    bf16 reduced-precision reductions off): Mixtral 8x22B at full width
    cut by depth alone to 12 of its 56 layers (30,451,390,464 parameters,
    60,903,960,576 bytes, checked against its shapes), built from a
    seeded CUDA generator; K8 against its plain version on q, k, v of its
    layer 0: decode rows over a ring of the window's 4096 slots at
    positions 4095 and 5000 (wrapped), the same rows against the linear
    cache with the window (the two K8 outputs held to each other), and a
    64-token windowed prefill; layer 0's ``moe_block`` on 80 tokens (cap
    32) against the same call on a CPU copy (routes, keep masks and slots
    equal, the output within ``MOE_OUT_REL``, the pairs dropped printed);
    a 64-token replay of ``decode_step`` against ``forward_lm`` on 'auto'
    and 'torch' at the no-drop capacity factor, rows whose experts
    flipped counted apart, the others within ``LM_LOGIT_REL``; the main
    path with every kernel counter set to 0 just before and read just
    after: 6 requests through ``SlotServer`` (K8 launched 12 times a
    decode call and nothing else), then each served sequence re-scored by
    ``forward_lm``; a decode step's wall, host issue and traced device
    time beside the bounds of the top-2 and of all 8 experts' bytes; the
    model freed; Kimi-K2 cut to 1 of its 61 layers (19,378,623,488
    parameters, 38,762,752,000 bytes): K8 at D 112, ``moe_block`` on 8
    tokens against the CPU, 2 requests served, a step traced beside its
    top-8 and all-384 bounds; then ``serve --arch mixtral-8x22b --smoke``
    and ``serve --arch kimi-k2-1t-a32b --smoke`` as subprocesses (K8
    launched);
11h. the cross-attention families served (``cross_phase``): whisper-base
    at full width and depth and Llama-3.2-Vision-90B at full width cut by
    depth to ``CROSS_VLM_LAYERS`` of 100 layers, K8 at their encoder,
    cross prefill and cross decode shapes, decode == forward at f32
    activations, 4 requests through ``precompute_cross_kv`` +
    ``decode_step(cross_kv=)`` with every counter reset, a traced step;
11i. the recurrent families served (``recurrent_phase``, bf16
    reduced-precision reductions off): xLSTM-1.3B (3,605,817,680 f32
    parameters) and then Hymba-1.5B (1,403,601,600), each at full width
    and depth, built from a seeded CUDA generator and freed before the
    next; xLSTM's decode == ``forward_xlstm`` within 2e-3 of the logit
    scale at f32 activations (the reference's own contract); K8 against
    its plain version at Hymba's shapes (D 64, GQA 25/5): the f32 prefill
    of 128 meta + 64 tokens on a global layer, the f32 forward of 128 +
    2,048 with the window of 1,024, and the bf16 decode rows over a
    windowed layer's full ring and a global layer's cache; Hymba's decode
    and forward on K8 against the plain attention within
    ``LM_LOGIT_REL`` (its decode is not its forward: R5, printed); the
    main path with every kernel counter set to 0 just before and read
    just after: 6 requests through ``SlotServer`` (4 slots, 16 new
    tokens), K8 launched once a layer a Hymba decode call and never for
    xLSTM, no other kernel; xLSTM's served sequences re-scored by
    ``forward_xlstm``; a decode step each traced beside its byte bound;
    ``serve --arch xlstm-1.3b`` and ``--arch hymba-1.5b`` at full width as
    subprocesses;
11j. the families one card holds whole, trained (``family_train_phase``):
    K8's forward with lse and its backward pair against their plain
    versions at the new shapes (``FAMILY_TRAIN_ATTN``: whisper's 1500 x
    1500 encoder, 448 x 1500 cross and 448 causal self attention, B 8 x 8
    heads; Hymba's 2,176 rows with the window of 1,024 and without, GQA
    25/5; a 37 x 1500 non-causal case with partial tiles on both grids; all
    f32 D 64), each timed beside its bound, its plain version and SDPA;
    then whisper-base (B 8 x 448 tokens, 1,500-frame sources), Hymba-1.5B
    (B 2 x 2,048) and xLSTM-1.3B (B 2 x 1,024) at full width and depth,
    each drawn on the card from a seed and freed before the next: one
    batch's gradients on K8 against the plain attention at f32
    activations within ``GRAD_REL_TOL`` (at the configs' bf16 activations
    printed beside the plain attention's own bf16 rounding), three donating AdamW steps under
    ``FaultTolerantRunner`` with every kernel counter set to 0 just before
    (losses finite; K8's launches a step ``FAMILY_LAUNCHES`` and nothing
    else; step ms, tokens/s, resident state and peak against the card's
    memory), one step at the trained shape traced (device busy, idle share, ops, the top ops,
    host ms under the train phases' labels and the sLSTM loop's); and the
    train CLI (``launch.train.main``) on each smoke config, 4 steps and
    ``--resume`` to 6;
11k. the MoE and VLM families trained at full width, cut by depth
    (``depth_train_phase``): K8's forward with lse and its backward pair
    against their plain versions at their shapes (``DEPTH_TRAIN_ATTN``,
    bf16 D 128: Mixtral's 2 x 4,096 rows, GQA 48/8, window 4,096;
    Llama-3.2-Vision's 4,096 rows, GQA 64/8, causal and across to its
    1,024 patches); then Mixtral 8x22B cut to 6 of 56 layers (B 2 x 4,096)
    and Llama-3.2-Vision-90B to 15 of 100 (three groups; B 1 x 4,096), each
    drawn on the card from a seed (parameters and bytes against the
    shapes, the experts counted): three donating Adafactor steps under
    ``FaultTolerantRunner`` with every kernel counter set to 0 just before
    (losses finite; K8 twice a layer, each backward kernel once, nothing
    else; step ms, tokens/s, resident state, peak under
    ``DEPTH_PEAK_MAX``), a traced step (device busy, idle share, the top
    ops, the MoE's expert-count reads: twice a layer, with their host ms),
    and K8's gradients against the plain attention's at f32 weights and
    activations on a cut of one layer or group at 1,024 tokens (the routes
    compared first, none flipped; every leaf within ``GRAD_REL_TOL``); and
    the train CLI on the Mixtral, Kimi-K2 and Llama smoke configs, 4 steps
    and ``--resume`` to 6;

and then the sharding slice (``dryrun_phase``, 11l; one budget of
``DRYRUN_BUDGET_S``):

11l. the production-mesh dry run of the reference: CTC-3L-421H-UNI's
    train_4k on the (16, 16) mesh and Qwen3-14B's decode_32k on
    (2, 16, 16), each ``python -m repro_torch.launch.dryrun`` in a process
    of its own on the machine's CPU (fake DTensors over a fake process
    group), both at once: status, the bytes one rank holds against the
    card's 80 GB, the bottleneck and the wall seconds (a failed cell fails
    the phase); the cost model's ranking of the stack backends at the
    serving shape (``op_cost.rank_stack_backends``, 123 -> 3 x 421, T =
    chunk, B = slots), each estimate beside that backend's launch timed on
    the card, which must be at or above its lower bound
    (``roofline.analyze``'s ``step_time_lower_bound_s``); MiniCPM-2B's
    train step at 2 x 4096 traced by the cost model (no step run), its
    lower bound against the step the LM training phase measured, the
    ratio printed and at least 1; K8 under DTensor (q, k, v placed on
    ``launch.train.local_mesh()``, (1, 1) on one card): one launch on the
    local shards, ``torch.equal`` to the plain call; and
    ``optim.compress_tensor``'s int8 codes of a tensor on the card
    ``torch.equal`` to those of its copy on the CPU;
11m. K2's layer block ``lb`` (``stack_lb_phase``) at the full widths (123
    -> 3x421, the seed weights): K2 at every candidate ``lb``
    (``enumerate_lb_candidates`` on the card: [1, 3]) at T = 16 and 64, B
    = 8 and 105, masked by ragged lengths and unmasked, ``torch.equal`` to
    ``lb = 3`` (hs and cs, so the finals), within ``KERNEL_ATOL`` of the
    plain version, launching (L / lb) x its batch blocks, each timed; a
    6x421 stack at B = 8, which K2 refuses whole (``lb = 6`` raises by
    name, launching nothing), run at ``lb`` 1, 2 and 3, ``torch.equal``
    to each other and within ``KERNEL_ATOL`` of the plain version, each
    timed; the unmasked autograd path's gradients at ``lb = 1`` and 3
    ``torch.equal``; ``tune_stack_lb(measure=True)`` at T = 16, B = 8 and
    105, its medians and winner printed; and the f32 engine drain of
    4 (``cuda_seq_fused``, sync) under a cache holding the measured entry
    and under one naming ``lb = 1``, with the K2 launch counter set to 0
    just before each drain and read just after: log-probs ``torch.equal``
    to the drain with no cache, (L / lb) K2 launches a chunk;

and then the two kernels that no path of the system reaches, each on its
public op, and K8 also on its own, each held against its plain version and
timed beside its bound and a PyTorch yardstick, each op driven once per
shape with its launch counter set to 0 just before and read just after
(K8's row in the ``kernels`` line leads with its Mixtral case, adds the LM
phase's cases and the training phase's forward cases, takes ``launches``
from the LM's serve path and reports the re-score's prefill launches as
``prefill_launches``, MiniCPM-2B's training launches as
``train_launches``, the MoE serve paths' (Mixtral's and Kimi-K2's) as
``moe_launches``, the cross serve paths' as ``cross_launches``, the
recurrent ones' (0 for xLSTM) as ``recurrent_launches``, the trained
families' as ``family_train_launches`` and the MoE and VLM configs' as
``depth_train_launches``, and adds the cross, Hymba, family and depth
training cases; the backward kernels' rows follow, with their launches on
MiniCPM-2B's training path, the trained families' and the MoE and VLM
configs'):

12. K6 (``lstm_gates``, the fused cell) on layer 0 (N_in = 123 + 421) and
    an inner layer (421 + 421) at B = 8, atol 1e-4, with the geometry
    its timed launch used;
    ``lstm_cell_fused`` against ``core.lstm.lstm_cell``;
13. K7 (``quant_matmul``) ``torch.equal`` to its plain version in f32 and
    bf16 at Mixtral 8x22B's expert up-projection (256 x 6144 x 16384) and
    the reference bench's 256 x 512 x 512; ``quantized_linear`` there and
    on the ragged (3, 5, 100) x (100, 75), within 3 % of the f32 product;
    each case records its launch geometry (``qmm_geometry``: its tiles);
14. K8 (``flash_attention``) at Mixtral 8x22B's attention (48 heads on 8
    kv heads, D 128, window 4096) as an 8192-token prefill and as a decode
    row against an 8192 cache, and at the reference bench's causal 8 x 1024
    x 64, in bf16 (one output rounding, rtol 2**-7, atol 1e-5) and f32
    (atol 1e-4); ``mha`` on each; each case records its schedule
    (``attention_geometry``: ``tiled`` with 64 or 128 rows a tile, or
    ``split`` with n_splits), and a case in 128-row tiles also its time in
    64-row tiles.

``--profile`` also traces one engine drain per f32 kernel backend, sync
and async (with ``readback_overlap``: the host's waits, and the chunks
whose successor's LSTM kernel was enqueued before their log-prob copy
completed), and at 105 slots on ``cuda_seq``, several
int8 deploy passes per int8 backend, and one train step per kernel backend
with ``torch.profiler``.  Two measurement modes run instead of the phases:
``--ab PARENT_SRC`` times K1 and K2 at the serving and training shapes
(``seq_case``), the f32 engine on ``cuda_seq`` and ``cuda_seq_fused``
(``engine_case``: p50 chunk ms and frames/s, medians of 5 drains), K3 on
both layer plans and K4 at T = 16 and 64 (``int8_case``), the int8 deploy
on ``auto`` and ``layerwise`` (``int8_deploy_case``: frames/s, medians of
5 passes) and K5-K8 at the cases of 8 and 12-14 (the same ``gates_case``,
``qmm_case`` and ``attn_case`` as those phases) against the tree whose
``src`` is given, each turn a process of its own (parent, change, change,
parent); ``--clock-stamps`` rebuilds K1-K8 with ``-DCLOCK_STAMPS`` and
prints the cycles of each phase (to stamp another tree, run a copy of this
script from that tree's root).

Any failed check raises (nonzero exit).  The line before the last is the
``kernels`` JSON; the last line is the device JSON.  Without a CUDA device,
or without the repository's ``src/repro_torch`` beside it, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

# the card's peak rates, read from ``repro_torch.launch.mesh`` (the one
# set the roofline reads too) by ``load_card_rates`` before any phase
HBM_BYTES_PER_S = F32_FLOPS_PER_S = INT8_OPS_PER_S = None
BF16_FLOPS_PER_S = TF32_FLOPS_PER_S = HBM_BYTES = None
KERNEL_ATOL = 1e-4            # kernel vs plain version, f32 state/outputs
ENGINE_ATOL = 1e-4            # log-probs across backends / vs forward
ENGINE_RTOL = 1e-4
SLOTS, CHUNK = 8, 16          # the serving shape: B = slots, T = chunk
REQUESTS, SEED = 12, 0        # utterances of 50-300 frames, weights seed
ENGINE_DRAINS = 5             # timed drains per turn of ``engine_timing``
ENGINE_PAIRS = 10             # (sync, async) pairs of turns, order alternating
# F4: one stream past each kernel's largest single launch at N_h 421 (K1
# 104, K2 24; K3 on the inner plan 120, K4 96), and an engine past K1's
F4_BATCH = {'lstm_seq': 105, 'lstm_stack_seq_kernel': 25,
            'lstm_seq_quantized': 121, 'lstm_stack_seq_kernel_q': 97}
F4_SLOTS, F4_UTTERANCES = 105, 110
F4_PAIRS = 5                  # engine_timing pairs at F4_SLOTS slots
# the fault phase: the ladder K2 -> K1 -> torch_scan and back on the main
# cell, a transient fault and a poisoned slot at FAULT_STEP, and the
# guard's (on / off) timing pairs
FAULT_LADDER = dict(fail_at={2: 1, 5: 1}, recover_at={8: 1, 14: 1},
                    promote_hysteresis=2, backoff_s=0.0)
FAULT_ONE_RUNG = dict(fail_at={2: 1}, recover_at={5: 1},
                      promote_hysteresis=2, backoff_s=0.0)
FAULT_STEP = 3
FAULT_PAIRS = 5
INT8_UTTERANCES = 8           # int8 deploy phase: utterances of 50-300 frames
INT8_REPEATS = 7              # timed int8 deploy passes per backend
INT8_PROFILE_PASSES = 10      # int8 deploy passes per traced window
TRAIN_BATCH, TRAIN_SEQ = 8, 64   # the reference train CLI's defaults
TRAIN_STEPS = 6               # train steps per kernel backend
TRAIN_CKPT_STEP = 3           # checkpoint taken after this many steps
TRAIN_RESUME_STEPS = 2        # train CLI steps after its --resume
TRAIN_BACKENDS = ('cuda_step', 'cuda_seq', 'cuda_seq_fused')
GRAD_T = 16                   # sequence of the on-card gradient check
GRAD_REL_TOL = 1e-4           # relative Frobenius error per gradient leaf
LOSS_RTOL = 1e-4              # loss histories across kernel backends
# the dry-run phase: its cells (arch, shape, multi-pod), each process's
# time limit, and the phase's budget
DRYRUN_CELLS = (('chipmunk-ctc', 'train_4k', False),
                ('qwen3-14b', 'decode_32k', True))
DRYRUN_TIMEOUT_S = 100
DRYRUN_BUDGET_S = 120
# the tune phase: interleaved turns of each timed trial (K4 against the K3
# chain; the serving loop at each chunk depth), and the deadline factor of
# its server and of the serve CLI's run
TUNE_ITERS = 11
TUNE_TRIALS = 5               # K4 vs K3 trials (and 3 serving trials) a run
TUNE_SLO = 1.0
SUBPROCESS_TIMEOUT_S = 300    # each CLI run of the tune and examples phases
CELL_BATCH = 8                # K6: the training batch, on layers 0 and 1
# K2's layer block (``stack_lb_phase``): its (T, B) cases on the main
# stack, the depth of a stack K2 refuses whole, the trials' batches
LB_SHAPES = ((16, 8), (64, 8), (16, 105), (64, 105))
LB_DEEP = 6
LB_TRIAL_B = (8, 105)
LB_REPS = 20                  # timed calls of each case (``cuda_ms``)
GATES_T = 16                  # steps of the timed K5 chain (``chain_ms``)
# K7 (label, M, K, N): kernel_bench.py:147 and Mixtral 8x22B's expert
# up-projection (256 tokens, d_model 6144 -> d_ff 16384); the first is the
# kernels line's row, the ragged case goes through ``quantized_linear`` only
QMM_SHAPES = (('mixtral-8x22b up-proj', 256, 6144, 16384),
              ('kernel_bench', 256, 512, 512))
QMM_RAGGED = ((3, 5, 100), 75)
QMM_REL_TOL = 0.03            # quantized_linear vs the f32 product
# the phases ``--clock-stamps`` reads (csrc/clock_stamps.cuh, clk.lap), of
# a row of kParts = 5 phases, the loop's cycles and the saved value
STAMP_COLS = 7
SEQ_PARTS = ('prologue', 'wait', 'staging', 'dot', 'epilogue')
# K3/K4, for the first dot warp's lane 0: the tiles summed before the
# step's own h_{t-1} lands (K3's x region, K4's below-h region or layer 0's
# acc_x), the wait for that plane, its tiles, the epilogue and the publish
SEQ_Q_PARTS = ('prologue', 'early dot', 'wait', 'dot', 'epilogue')
STAMP_PARTS = {'quant_matmul': ('wait', 'loads', 'transpose', 'wgmma'),
               'flash_attention': ('loads+wait', 'S+softmax', 'PV'),
               'lstm_gates_rec': ('staging', 'dot', 'reduce', 'epilogue'),
               'lstm_seq': SEQ_PARTS, 'lstm_stack_seq': SEQ_PARTS,
               'lstm_seq_q': SEQ_Q_PARTS, 'lstm_stack_seq_q': SEQ_Q_PARTS}
# K1/K2 (T, B) of ``--ab`` and ``--clock-stamps``: the serving chunk and the
# training sequence; the first is the kernels line's row
SEQ_SHAPES = ((CHUNK, SLOTS), (TRAIN_SEQ, TRAIN_BATCH))
# K8 (label, B, H, Hkv, Sq, Sk, D, window, dtype), all causal through
# ``mha``: kernel_bench.py:158, and Mixtral 8x22B's attention (48 heads on
# 8 kv heads, D 128, sliding window 4096) as an 8192-token prefill and as
# one decode row against an 8192 cache; the first is the kernels line's row
ATTN_CASES = (
    ('mixtral-8x22b prefill', 1, 48, 8, 8192, 8192, 128, 4096, 'bfloat16'),
    ('mixtral-8x22b prefill', 1, 48, 8, 8192, 8192, 128, 4096, 'float32'),
    ('mixtral-8x22b decode', 1, 48, 8, 1, 8192, 128, 4096, 'bfloat16'),
    ('mixtral-8x22b decode', 1, 48, 8, 1, 8192, 128, 4096, 'float32'),
    ('kernel_bench', 1, 8, 8, 1024, 1024, 64, None, 'float32'),
    ('kernel_bench', 1, 8, 8, 1024, 1024, 64, None, 'bfloat16'),
)
# K8 kernel vs plain version.  Both compute in f32 and round the output to
# q's dtype, so in bf16 they may differ by one rounding of the output
# (2**-7 relative) and by the f32 arithmetic's own slack (under 1e-6 in f32)
# the systolic phase: the scale-outs at the serving shape, full width
SYSTOLIC_T, SYSTOLIC_B = 16, 8
SYSTOLIC_TOL = 1e-4           # scale-out vs K1/K2, f32 hidden and cell state
SYSTOLIC_LAYERWISE = ('2x2', '5x7')
SYSTOLIC_STAGED = 'graves-75'
SYSTOLIC_DRAINS = 3           # timed drains of the graves-75 engine cell
SYSTOLIC_TURNS = 3            # timed calls of each scale-out after a warm one
SYSTOLIC_LADDER = dict(fail_at={2: 1, 4: 1})   # staged -> K2 -> K1
# the die phase: graves-3x25's ladder at full width on one card (L2 / the
# engines of each rung: 699,050 B a 3d engine, 1,048,576 a 2d one, 2,097,152
# a 1d one), its fault schedules on the f32 engine cell, and the tuner
DIE_TOPOLOGY = 'graves-3x25'
DIE_RUNGS = (('cuda_seq_fused_systolic@3d', 3), ('cuda_seq_fused_systolic@2d',
                                                 2),
             ('cuda_seq_systolic@1d', 1), ('cuda_seq_fused', 0),
             ('cuda_seq', 0), ('torch_scan', 0))
# die 2 lost at chunk 2, healed at chunk 5: 3d -> 2d -> canary -> 3d
DIE_SCHEDULE = dict(fail_at={2: {'n_dead': 1, 'domain': 2}},
                    recover_at={5: 1}, promote_hysteresis=2, backoff_s=0.0)
# all three dies lost at chunk 2 (onto K2), one more fault at 4 (onto K1)
DIE_TAIL = dict(fail_at={2: {'n_dead': 3}, 4: 1}, backoff_s=0.0)
# two dies lost at chunk 2 (onto the layerwise 1d rung), one healed at 5:
# the canary from 1d back to 2d
DIE_ONE = dict(fail_at={2: {'n_dead': 2}}, recover_at={5: 1},
               promote_hysteresis=2, backoff_s=0.0)
DIE_TUNE_ITERS = 5            # interleaved turns of the staged trials
# the geometries the reference's class (n_h_p, bk) puts with graves-75's
# (3, 5, 5) at 421 hidden: a row split of one changes bn (85 -> 425)
DIE_CLASS_PROBE = ((3, 5, 5), (3, 1, 5), (2, 1, 5))
ATTN_TOL = {'float32': dict(rtol=0.0, atol=1e-4),
            'bfloat16': dict(rtol=2.0 ** -7, atol=1e-5)}
# the dense LM phase: Qwen3-14B at full width (40 layers, d_model 5120,
# 40 heads on 8 kv heads, head_dim 128, d_ff 17408, vocab 151,936, bf16;
# nothing cut), then the other dense configs at their smoke size
# (qkv_bias; MHA with qkv_bias; tied embeddings)
LM_ARCH = 'qwen3-14b'
LM_SMOKE = ('qwen2.5-14b', 'codeqwen1.5-7b', 'minicpm-2b')
LM_PREFILL = 64               # tokens of K8's prefill case and the replay
LM_MAX_SEQ = 128              # SlotServer's cache (the reference's default)
LM_DECODE_POS = (0, 63, 127)  # K8's decode rows against that cache
LM_REQUESTS, LM_SLOTS, LM_MAX_NEW = 6, 4, 16
LM_SMOKE_TOKENS = 16
LM_STEP_REPS = 10             # timed decode steps a backend
# logits with bf16 activations, K8 against its plain version and decode
# against forward: max |difference| within this share of the logit scale
# (max |logit|). bf16 keeps 8 bits and K8 multiplies P in bf16; decode
# (one row) and forward (a block) reach cuBLAS at other shapes, so every
# layer rounds differently and 40 layers carry it on
LM_LOGIT_REL = 5e-2
# forward_lm's argmax must reproduce at least this share of the served
# greedy tokens: a sanity floor (a broken cache or position gives ~1/V);
# bf16 rounding flips near-ties, so not 1
LM_AGREE_MIN = 0.5
# the LM training phase: MiniCPM-2B at full width (40 layers, d_model
# 2304, 36 heads, head_dim 64, d_ff 5760, vocab 122,753, tied embeddings,
# f32 weights, a bf16 residual stream, remat 'full'); the repo's train_4k
# shape is 256 x 4096 tokens, cut to batch 2 (8,192 tokens a step)
LM_TRAIN_ARCH = 'minicpm-2b'
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 4096, 3
# K8's training kernels: (label, B, H, Hkv, S, D, window, dtype), causal
LM_TRAIN_ATTN = (('minicpm-2b', 2, 36, 36, 4096, 64, None, 'float32'),
                 ('qwen3-14b', 1, 40, 8, 1024, 128, None, 'bfloat16'),
                 ('qwen3-14b windowed', 1, 40, 8, 1024, 128, 256,
                  'bfloat16'))
# K8's backward against its plain version: max |error| over the gradient's
# scale (max |want|); f32 sums of up to S terms in another order, and in
# bf16 one rounding of the output (2**-8) with room for a tie
BWD_TOL = {'float32': 1e-4, 'bfloat16': 2.0 ** -7}
LSE_ATOL = 1e-5               # the log-sum-exp: f32 logs of other-order sums
# one step's gradients on K8 against attn_backend='torch', relative
# Frobenius error per leaf: the two attentions differ at ~1e-6, but the
# residual stream and its gradient are bf16, so an f32 difference flips a
# rounding (2**-8 relative) now and then, and 40 layers carry the flips
LM_GRAD_REL = 2.0 ** -7
# the MoE phase: Mixtral 8x22B at full width (d_model 6144, 48 heads on 8
# kv heads of 128, 8 experts top-2 of d_ff 16384, window 4096, vocab
# 32,768, bf16) cut by depth alone to MOE_LAYERS of its 56 layers (281 GB
# of weights -> 60.9 GB); then Kimi-K2 at full width (d_model 7168, 64
# heads on 8 of 112, 384 experts top-8 of d_ff 2048, vocab 163,840, bf16)
# cut to KIMI_LAYERS of its 61 (38.76 GB)
MOE_ARCH, MOE_LAYERS = 'mixtral-8x22b', 12
KIMI_ARCH, KIMI_LAYERS = 'kimi-k2-1t-a32b', 1
MOE_RING_POS = (4095, 5000)   # K8's ring decode rows: the ring full, wrapped
MOE_TOKENS = 80               # moe_block on the card against the CPU (cap 32)
KIMI_MOE_TOKENS = 8           # Kimi's, its live experts copied to the CPU
KIMI_REQUESTS = 2
# moe_block's bf16 output on the card against the CPU's: max |error| over
# the output's scale.  bf16 keeps 8 bits, the expert products accumulate
# in other orders on cuBLAS and on the CPU, and each is rounded twice
# (SwiGLU's h, then y) before the gate sum
MOE_OUT_REL = 2.0 ** -6
# the replay's rows whose expert set flipped in some layer between two
# runs, at most this share of the rows: bf16 moves the router's inputs by
# ~1e-3 between K8 and the plain attention (or decode and forward), and a
# top-2 of 8 has near-ties in 12 layers, so 12-17 % of Mixtral's rows flip
# on an H100; a sanity floor like LM_AGREE_MIN (a broken cache or attention
# moves every logit and flips nearly every row)
MOE_FLIP_MAX = 1 / 2
# the cross-attention phase: whisper-base at full width and depth (6
# encoder + 6 decoder layers, d_model 512, 8 heads of 64, d_ff 2048, vocab
# 51,865, f32 weights, bf16 activations; nothing cut), then
# Llama-3.2-Vision-90B at full width (d_model 8192, 64 heads on 8 kv heads
# of 128, d_ff 28,672, vocab 128,256, bf16, one cross layer in 5) cut by
# depth alone to CROSS_VLM_LAYERS of its 100 (7 of 20 groups: 175 GB of
# weights -> 64.1 GB)
CROSS_AUDIO = 'whisper-base'
CROSS_VLM, CROSS_VLM_LAYERS = 'llama-3.2-vision-90b', 35
CROSS_BATCH = 4               # requests decoded together, one source each
CROSS_PROMPT, CROSS_MAX_NEW = 8, 16
CROSS_PREFILL = 64            # queries of K8's cross prefill case
# decode == forward at f32 activations, over the logit scale: the
# reference's own bound (tests/test_models.py, rtol = atol = 2e-3)
CROSS_F32_REL = 2e-3
# the VLM's init peak: its stack (64.1 GB), one layer (1.7 GB), one f32
# draw (0.9 GB) and the allocator's rounding
CROSS_PEAK_MAX = 68e9
# the recurrent phase: xLSTM-1.3B (48 blocks: 42 mLSTM and 6 sLSTM, d_model
# 2048, 4 heads, vocab 50,304) and Hymba-1.5B (32 layers, d_model 1600, 25
# heads on 5 kv heads of 64, a window of 1,024 but on layers 0/15/31, a
# Mamba state of 16, d_ff 5504, vocab 32,001), f32 weights under bf16
# activations, each at full width and depth (nothing cut).  Their parameter
# counts are the reference's init's (``jax.eval_shape`` of
# ``get_bundle(cfg).init``)
XLSTM_ARCH, HYMBA_ARCH = 'xlstm-1.3b', 'hymba-1.5b'
RECURRENT_PARAMS = {XLSTM_ARCH: 3_605_817_680, HYMBA_ARCH: 1_403_601_600}
HYMBA_PREFILL = 64            # tokens behind them in K8's prefill case
HYMBA_FORWARD = 2048          # and in its windowed forward case
HYMBA_GLOBAL_FILL = 100       # tokens in the global layer's decode case
RECURRENT_REPLAY = 16         # tokens of the decode replays
RECURRENT_CLI_REQUESTS, RECURRENT_CLI_MAX_NEW = 2, 4
# the families trained whole (``family_train_phase``): (arch, batch,
# tokens), each cut from train_4k (256 x 4096) by batch, and whisper and
# xLSTM by sequence too: whisper to its published 448-token decoder
# context (sources of its 1,500 frames); Hymba keeps 2,048 tokens (2,176
# rows with its 128 meta tokens), so the window of 1,024 bites; xLSTM
# 1,024 (four 256-step mLSTM chunks; 1,024 steps of the sLSTM's per-step
# loop, which sets its host-bound step)
FAMILY_TRAIN = (('whisper-base', 8, 448), (HYMBA_ARCH, 2, 2048),
                (XLSTM_ARCH, 2, 1024))
FAMILY_TRAIN_STEPS = 3
# The families' gradients on K8 against the plain attention are held at
# f32 activations (f32 throughout: the two attentions' ~1e-6 alone) to
# GRAD_REL_TOL on every leaf: that check fails a wrong kernel.  At the
# configs' bf16 activations the errors are printed beside the plain
# attention's own bf16 rounding (bf16 against f32) and gate nothing:
# Hymba's Mamba dt path (w_dt, b_dt, w_bdt) moves 1.3-1.8e-2 by bf16
# rounding alone, past LM_GRAD_REL, so a ~1e-6 attention difference that
# flips a rounding moves it as far (measured on one H100).
# K8's launches a step: (forward, dk/dv, dq). whisper: 6 encoder + 6
# decoder self + 6 cross, no remat; Hymba: 32 layers, the forward again in
# the remat recompute; xLSTM has no attention
FAMILY_LAUNCHES = {'whisper-base': (18, 18, 18), HYMBA_ARCH: (64, 32, 32),
                   XLSTM_ARCH: (0, 0, 0)}
# K8's training kernels at the new shapes, all D 64 and f32 (the f32 norm
# scales promote the bf16 activations): (label, B, H, Hkv, Sq, D, window,
# dtype, Sk, causal)
FAMILY_TRAIN_ATTN = (
    ('whisper encoder', 8, 8, 8, 1500, 64, None, 'float32', 1500, False),
    ('whisper cross', 8, 8, 8, 448, 64, None, 'float32', 1500, False),
    ('whisper decoder self', 8, 8, 8, 448, 64, None, 'float32', 448, True),
    ('hymba windowed', 2, 25, 5, 2176, 64, 1024, 'float32', 2176, True),
    ('hymba global', 2, 25, 5, 2176, 64, None, 'float32', 2176, True),
    ('partial tiles', 2, 8, 8, 37, 64, None, 'float32', 1500, False))
# the MoE and VLM families trained at full width, cut by depth alone
# (``depth_train_phase``): (arch, layers kept, batch, tokens).  No full
# train state fits one card: Mixtral 8x22B's bf16 weights and gradients
# are 10.0 GB a layer (the embedding and unembedding 1.6 GB), so it keeps
# 6 of its 56 layers; Llama-3.2-Vision-90B's 17.1 GB a group of four self
# blocks and a cross block (8.4 GB of embedding and unembedding), so it
# keeps 15 of its 100 layers, three of its 20 groups.  Each at train_4k's
# 4,096 tokens, cut by batch (Mixtral 2, Llama 1; Llama's sources are its
# 1,024 patch embeddings); Adafactor, remat full, as configured
DEPTH_TRAIN = (('mixtral-8x22b', 6, 2, 4096),
               ('llama-3.2-vision-90b', 15, 1, 4096))
# the depth above is the most whose training peak stays under this (the
# card allocates 85.02 GB): 70.17 GB for Mixtral and 72.75 GB for Llama
# on an H100 80GB HBM3 at 700 W, where one more layer (10.0 GB of weights
# and gradients) or group (17.1 GB) would pass it
DEPTH_PEAK_MAX = 75e9
# K8's gradients against the plain attention's at f32 weights and
# activations (bf16 weights round each gradient leaf, and a 1e-6
# difference flips roundings of 2**-8), every leaf within GRAD_REL_TOL.
# Two f32 gradient trees do not fit beside the cut above, so the check
# runs on (layers, batch, tokens): one Mixtral layer, one Llama group, at
# 1,024 tokens, with the first run's gradients on the host meanwhile
DEPTH_GRAD = {'mixtral-8x22b': (1, 1, 1024),
              'llama-3.2-vision-90b': (5, 1, 1024)}
# K8's training kernels at the families' shapes, bf16 D 128 (label, B, H,
# Hkv, Sq, D, window, dtype, Sk, causal): Mixtral's GQA 48/8 with its
# window of 4,096 over 4,096 tokens, Llama's GQA 64/8 self layers and its
# cross layers over the 1,024 patches
DEPTH_TRAIN_ATTN = (
    ('mixtral self', 2, 48, 8, 4096, 128, 4096, 'bfloat16', 4096, True),
    ('llama self', 1, 64, 8, 4096, 128, None, 'bfloat16', 4096, True),
    ('llama cross', 1, 64, 8, 4096, 128, None, 'bfloat16', 1024, False))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls,
    from CUDA events after ``warmup`` calls.  The stream is first held by
    ``torch.cuda._sleep`` for twice the host time of the ``reps`` calls, so
    every launch is queued before the first runs and the events see device
    time, not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * reps * host_s * 2e9))   # <= 2 GHz SM clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean host time of ``fn`` in ms over ``reps`` calls that are issued
    without waiting for the device (the cost the calls add to the host's
    launch path)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


# the functions ``main`` calls as its phases, each timed (``time_phases``)
PHASES = ('kernel_checks', 'chunked_checks', 'engine_runs', 'engine_timing',
          'profile_engine', 'f4_checks', 'fault_runs', 'quantize_stack',
          'int8_kernel_checks', 'int8_chunked_checks', 'int8_deploy',
          'gates_kernel_checks', 'grad_checks', 'train_runs', 'train_cli',
          'fault_train', 'tune_phase', 'examples_phase', 'systolic_phase',
          'die_phase', 'lm_phase', 'lm_train_phase', 'moe_phase',
          'cross_phase', 'recurrent_phase', 'family_train_phase',
          'depth_train_phase', 'dryrun_phase', 'stack_lb_phase',
          'cell_checks',
          'quant_matmul_checks', 'attention_checks', '_bwd_rows')


def time_phases(module_globals: dict) -> dict:
    """Wrap each of ``PHASES`` in ``module_globals`` so that its wall
    seconds add up, under its name, in the dict returned (a phase called
    inside another counts toward the outer one alone)."""
    seconds, depth = {}, [0]

    def timed(name, fn):
        def run(*args, **kwargs):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    seconds[name] = seconds.get(name, 0.0) + (
                        time.perf_counter() - t0)
        return run

    for name in PHASES:
        if name in module_globals:
            module_globals[name] = timed(name, module_globals[name])
    return seconds


def load_card_rates() -> None:
    """Set the card's peak rates from ``repro_torch.launch.mesh``."""
    global HBM_BYTES_PER_S, F32_FLOPS_PER_S, INT8_OPS_PER_S
    global BF16_FLOPS_PER_S, TF32_FLOPS_PER_S, HBM_BYTES
    from repro_torch.launch import mesh
    HBM_BYTES_PER_S, F32_FLOPS_PER_S = mesh.HBM_BW, mesh.PEAK_FLOPS_F32
    INT8_OPS_PER_S, BF16_FLOPS_PER_S = mesh.PEAK_OPS_INT8, \
        mesh.PEAK_FLOPS_BF16
    TF32_FLOPS_PER_S, HBM_BYTES = mesh.PEAK_FLOPS_TF32, mesh.HBM_BYTES


def bound(nbytes: float, flops: float, ops_per_s: float = None):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of their type (f32 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (ops_per_s or F32_FLOPS_PER_S) * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def ragged_lens(rng, T: int, B: int) -> np.ndarray:
    """Valid lengths with a full, an empty and partial streams."""
    lens = rng.randint(1, T, size=B)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    return lens


def seq_case(kernel: str, params, wts, pre_x, mask, h0, c0):
    """One K1 (``kernel`` 'lstm_seq': layer 0's weights, ``h0[0]``,
    ``c0[0]``) or K2 ('lstm_stack_seq_kernel': the stacked weights ``wts``,
    every layer's h0/c0) case on the given inputs: max abs error against
    its plain version, the kernel's ms, its plain version's, and the bound
    (bytes: every input read and every output written once; operations:
    the live steps' products and epilogues).  Only calls that the parent
    tree has too, so ``--ab`` runs it on either."""
    from repro_torch.kernels import lstm_seq as ks
    T, B, _, N = pre_x.shape
    L = wts.w_h.shape[0]
    n_live = int(mask.sum())
    if kernel == 'lstm_seq':
        lp = params.layers[0]
        fn, ref, layers, families = ks.lstm_seq, ks.lstm_seq_ref, 1, 1
        args = (pre_x, lp.w_h, lp.w_peep, lp.b, h0[0], c0[0], mask)
        weights = lp.w_h.numel()
    else:
        fn, ref = ks.lstm_stack_seq_kernel, ks.lstm_stack_seq_ref
        layers, families = L, 2 * L - 1
        args = (pre_x, wts.w_in, wts.w_h, wts.peep, wts.b, h0, c0, mask)
        weights = wts.w_in.numel() + wts.w_h.numel()
    got, want = fn(*args), ref(*args)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    nbytes = 4 * (pre_x.numel() + weights + layers * (7 * N + 2 * B * N
                                                       + 2 * T * B * N)
                  ) + mask.numel()
    flops = n_live * (families * 2 * 4 * N * N + layers * 30 * N)
    case = dict(kernel=kernel, shape=f'T={T} B={B} N_h={N} L={layers}',
                live_steps=n_live, max_abs_err=err, tol=KERNEL_ATOL,
                ok=err <= KERNEL_ATOL, ms=cuda_ms(lambda: fn(*args), 50),
                plain_ms=cuda_ms(lambda: ref(*args), 3, warmup=1),
                bytes=nbytes, flops=flops, library_ms=None)
    case['bound_ms'], case['bound_by'] = bound(nbytes, flops)
    return case


def seq_inputs(params, T: int, B: int, g, dev):
    """K1/K2 inputs at (T, B) from ``g`` (x 0.5): layer 0's hoisted input
    of random frames, a ragged mask (a full, an empty and partial streams),
    nonzero h0/c0 of every layer, and the stacked weights."""
    from repro_torch.core.lstm import hoisted_input, valid_len_mask
    from repro_torch.kernels.lstm_seq import stack_kernel_weights
    r = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.5
    lp, L = params.layers[0], len(params.layers)
    lens = torch.randint(1, T, (B,), generator=g, device=dev)
    lens[0], lens[1] = T, 0
    pre_x = hoisted_input(lp.w_x, r(T, B, lp.n_x))
    return (stack_kernel_weights(params), pre_x, valid_len_mask(T, lens, B),
            r(L, B, lp.n_h), r(L, B, lp.n_h))


def kernel_checks(cfg, params, B: int, T: int, rng, dev):
    """K1 and K2 against their plain versions (``seq_case``) at the serving
    shape (the kernels line's numbers) and at the training shape
    (``SEQ_SHAPES``), each row with its launch geometry."""
    from repro_torch.core.lstm import hoisted_input, valid_len_mask
    from repro_torch.kernels.lstm_seq import (seq_geometry, stack_geometry,
                                              stack_kernel_weights)
    from repro_torch.kernels.lstm_seq.kernel import seq_threads
    N, L, NX = cfg.lstm_hidden, cfg.n_layers, cfg.lstm_inputs
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    xs = f32(rng.randn(T, B, NX) * 0.5)
    lens = torch.from_numpy(ragged_lens(rng, T, B)).to(dev)
    mask = valid_len_mask(T, lens, B)
    pre_x = hoisted_input(params.layers[0].w_x, xs)
    h0, c0 = f32(rng.randn(B, N) * 0.5), f32(rng.randn(B, N) * 0.5)

    build = lambda: stack_kernel_weights(params)
    wts = build()
    stacking = dict(mbytes=4e-6 * sum(
        a.numel() for a in (wts.w_in, wts.w_h, wts.peep, wts.b)),
        device_ms=cuda_ms(build, 20), host_ms=host_ms(build, 20))
    print(f"stack_kernel_weights: {stacking['mbytes']:.2f} MB stacked once "
          f"per engine, device {stacking['device_ms']:.4f} ms, host "
          f"{stacking['host_ms']:.4f} ms per build", flush=True)
    h0s, c0s = f32(rng.randn(L, B, N) * 0.5), f32(rng.randn(L, B, N) * 0.5)
    serving = {'lstm_seq': (pre_x, mask, h0[None], c0[None]),
               'lstm_stack_seq_kernel': (pre_x, mask, h0s, c0s)}
    g = torch.Generator(device=dev).manual_seed(SEED)
    wts_t, *training = seq_inputs(params, *SEQ_SHAPES[1], g, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, file, replaces, geom in (
            ('lstm_seq', 'lstm_seq.cu', 'kernel.py:113',
             seq_geometry(N, B, sms)),
            ('lstm_stack_seq_kernel', 'lstm_stack_seq.cu',
             'stack_kernel.py:185', stack_geometry(N, L, B, sms))):
        cases = [seq_case(name, params, wts, *serving[name]),
                 seq_case(name, params, wts_t, *training)]
        for c in cases:
            print(f"{name}: {c['shape']} live steps {c['live_steps']}: "
                  f"max_abs_err {c['max_abs_err']:.3e} (tol {KERNEL_ATOL}), "
                  f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.3f} ms, "
                  f"bound {c['bound_ms']:.5f} ms ({c['bound_by']})",
                  flush=True)
        cases[0]['geometry'] = dict(dataclasses.asdict(geom),
                                    threads=seq_threads(geom.rows))
        rows.append(_case_row(
            name, f'src/repro_torch/csrc/{file}',
            f'src/repro/kernels/lstm_seq/{replaces}', cases))
        print(f"{name}: geometry at the serving shape "
              f"{cases[0]['geometry']}", flush=True)
        check(rows[-1]['ok'], f'{name} disagrees with its plain version')
    return rows, stacking


def chunked_checks(params, B: int, chunk: int, rng, dev):
    """Chunked == monolithic, bit for bit, on both kernel backends."""
    from repro_torch.core.lstm import lstm_stack_chunk
    T = 3 * chunk
    NX = params.layers[0].n_x
    xs = torch.from_numpy((rng.randn(T, B, NX) * 0.5).astype(np.float32)).to(dev)
    lens = ragged_lens(rng, T, B)
    for backend in ('cuda_seq', 'cuda_seq_fused'):
        mono, fin_m = lstm_stack_chunk(
            params, xs, None, valid_len=torch.from_numpy(lens).to(dev),
            backend=backend)
        states, outs = None, []
        for lo in range(0, T, chunk):
            vl = np.clip(lens - lo, 0, chunk)
            o, states = lstm_stack_chunk(params, xs[lo:lo + chunk], states,
                                         valid_len=torch.from_numpy(vl).to(dev),
                                         backend=backend)
            outs.append(o)
        got = torch.cat(outs)
        same = torch.equal(got, mono) and all(
            torch.equal(a, b) for (a, b) in
            zip(sum(map(list, states), []), sum(map(list, fin_m), [])))
        print(f'chunked == monolithic [{backend}] T={T} in {T // chunk} '
              f'chunks, B={B}: {same}', flush=True)
        check(same, f'chunked != monolithic on {backend}')


def count_overlap(engine):
    """Wrap ``engine``'s ``_launch`` and ``_commit`` to count, over a drain,
    the chunks launched while the chunk launched just before was not yet
    committed (the pipeline at work: under async dispatch every chunk but
    the first of a fill; in sync mode none), and of those, the ones
    launched while its log-prob copy had not yet completed on the device
    (its event not fired: host issue overlapped device work).  Returns the
    live counts."""
    launch, commit = engine._launch, engine._commit
    state = dict(prev=None, launched=0, pipelined=0, before_readback=0)

    def counted_launch(*args, **kw):
        rec = launch(*args, **kw)
        prev = state['prev']
        if prev is not None and not getattr(prev, 'committed', False):
            state['pipelined'] += 1
            state['before_readback'] += (prev.done is not None
                                         and not prev.done.query())
        state['prev'] = rec
        state['launched'] += 1
        return rec

    def counted_commit(rec):
        rec.committed = True
        return commit(rec)

    engine._launch, engine._commit = counted_launch, counted_commit
    return state


def serve_once(cfg, params, backend: str, utts, slots: int, chunk: int,
               async_dispatch: bool = False, policy: bool = False):
    """One drain of ``utts`` through ``launch.serve.StreamServer`` on
    ``backend`` (``policy``: the chunk-size policy with an infinite budget,
    ``ChunkSizePolicy(chunk_max=chunk, slack=1e9, patience=2)``, whose
    boundaries step down 16, 8, 4, ...), the launch counters set to 0 just
    before the drain and read just after.  Returns (log-probs per stream,
    the run's numbers)."""
    from repro_torch.kernels.lstm_seq import lstm_seq, lstm_stack_seq_kernel
    from repro_torch.launch.serve import StreamServer
    from repro_torch.runtime import ChunkSizePolicy
    pol = (ChunkSizePolicy(chunk_max=chunk, slack=1e9, patience=2)
           if policy else None)
    server = StreamServer(cfg.replace(lstm_backend=backend), params,
                          num_slots=slots, chunk=chunk,
                          async_dispatch=async_dispatch, chunk_policy=pol)
    eng = server.engine
    check(eng.backend == backend, f'engine pinned {eng.backend}, asked for '
          f'{backend}')
    check(eng.async_dispatch == async_dispatch, 'engine dispatch mode')
    overlap = count_overlap(eng) if backend != 'torch_scan' else None
    sessions = [server.submit(u) for u in utts]
    torch.cuda.synchronize()
    lstm_seq.launches = 0
    lstm_stack_seq_kernel.launches = 0
    t0 = time.perf_counter()
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lstm_seq=lstm_seq.launches,
                    lstm_stack_seq_kernel=lstm_stack_seq_kernel.launches)
    stats = eng.stats()
    lps = [s.full_log_probs() for s in sessions]
    for s, u, lp in zip(sessions, utts, lps):
        check(lp.shape == (len(u), cfg.n_outputs) and
              bool(np.isfinite(lp).all()), f'stream {s.sid} output')
    res = dict(launches=launches, steps=stats['steps'],
               frames=stats['frames'], wall_s=wall,
               frames_per_s=stats['frames'] / wall,
               p50_chunk_ms=stats['p50_chunk_s'] * 1e3,
               events=stats['event_counts'])
    if overlap is not None:
        res.update(chunks_launched=overlap['launched'],
                   launched_before_previous_commit=overlap['pipelined'],
                   launched_before_previous_readback=overlap[
                       'before_readback'])
    if policy:
        res['chunk_lens'] = sorted({c for c, _ in eng._policy.history},
                                   reverse=True)
    label = ('async' if async_dispatch else 'sync') + (
        ', policy' if policy else '')
    print(f'engine [{backend}, {label}]: {len(utts)} utterances, '
          f'{stats["frames"]} frames, {slots} slots, chunk {chunk}, '
          f'{stats["steps"]} steps in {wall:.3f} s: '
          f'{stats["frames"] / wall:.1f} frames/s, p50 chunk '
          f'{stats["p50_chunk_s"] * 1e3:.3f} ms, launches {launches}, '
          f'events {stats["event_counts"]}'
          + (f', chunk lengths {res["chunk_lens"]}' if policy else '')
          + (f'; of {overlap["launched"]} chunks, {overlap["pipelined"]} '
             f'launched before the previous one was committed, '
             f'{overlap["before_readback"]} before its read-back completed'
             if overlap is not None else ''), flush=True)
    return lps, res


def engine_runs(cfg, params, slots: int, chunk: int, utts):
    """Serve the same utterances on the three backends (sync), then on
    both kernel backends async, and with the chunk-size policy sync and
    async: async == sync and policy == fixed chunk bit for bit, the launch
    counts per engine step unchanged, no speculation squashed.  Returns
    per-run results with the launch counts of each run."""
    from repro_torch.models import chipmunk_net
    runs, lps = {}, {}
    for backend in ('cuda_seq', 'cuda_seq_fused', 'torch_scan'):
        lps[backend], runs[backend] = serve_once(cfg, params, backend, utts,
                                                 slots, chunk)
    L = cfg.n_layers
    per_step = {'cuda_seq': lambda n: dict(lstm_seq=L * n,
                                           lstm_stack_seq_kernel=0),
                'cuda_seq_fused': lambda n: dict(lstm_seq=0,
                                                 lstm_stack_seq_kernel=n)}
    check(runs['cuda_seq']['launches'] == per_step['cuda_seq'](
        runs['cuda_seq']['steps']),
        'cuda_seq must launch K1 L times per engine step')
    check(runs['cuda_seq_fused']['launches'] == per_step['cuda_seq_fused'](
        runs['cuda_seq_fused']['steps']),
        'cuda_seq_fused must launch K2 once per engine step')
    check(runs['torch_scan']['launches'] == dict(
        lstm_seq=0, lstm_stack_seq_kernel=0), 'torch_scan launched a kernel')

    for backend in ('cuda_seq', 'cuda_seq_fused'):
        for name, mode, policy in (('async', True, False),
                                   ('sync, policy', False, True),
                                   ('async, policy', True, True)):
            got, r = serve_once(cfg, params, backend, utts, slots, chunk,
                                async_dispatch=mode, policy=policy)
            runs[f'{backend} {name}'] = r
            same = all(np.array_equal(a, b)
                       for a, b in zip(got, lps[backend]))
            check(same, f'{backend} {name} differs from sync at a fixed '
                        f'chunk')
            check(r['launches'] == per_step[backend](r['steps']),
                  f'{backend} {name}: launches per engine step changed')
            check(r['events'].get('squash', 0) == 0,
                  f'{backend} {name}: a speculation was squashed')
            check((r['launched_before_previous_commit'] > 0) == mode,
                  f'{backend} {name}: chunks launched before the previous '
                  f'one was committed: {r["launched_before_previous_commit"]}'
                  f' (async pipelines, sync never)')
            if policy:
                check(len(r['chunk_lens']) > 2, f'{backend} {name}: the '
                      f'policy never moved the chunk boundaries')
        print(f'engine [{backend}]: async == sync and policy == fixed chunk, '
              f'bit for bit on every stream', flush=True)

    fwd_cfg = cfg.replace(lstm_backend='cuda_seq_fused')
    worst = {}
    for i, u in enumerate(utts):
        frames = torch.from_numpy(u)[None].to(params.layers[0].w_h.device)
        mono = chipmunk_net.forward(fwd_cfg, params, frames)[:, 0].cpu().numpy()
        ref = lps['cuda_seq_fused'][i]
        for name, other in (('forward', mono),
                            ('cuda_seq', lps['cuda_seq'][i]),
                            ('torch_scan', lps['torch_scan'][i])):
            worst[name] = max(worst.get(name, 0.0),
                              float(np.abs(ref - other).max()))
            check(np.allclose(ref, other, rtol=ENGINE_RTOL, atol=ENGINE_ATOL),
                  f'utterance {i}: cuda_seq_fused vs {name} differ')
    print('engine streams allclose (rtol/atol '
          f'{ENGINE_RTOL}/{ENGINE_ATOL}), max abs diff vs cuda_seq_fused: '
          + ', '.join(f'{k} {v:.3e}' for k, v in worst.items()), flush=True)
    return runs, worst


def readback_overlap(events):
    """From the trace of one engine drain (``torch.profiler`` events): the
    host's CUDA runtime calls by name (its waits are the calls named
    ``*Synchronize``), and, pairing chunk k's log-prob copy to the host
    (its device ``Memcpy DtoH``, one a chunk) with chunk k+1's first K1/K2
    launch (its host ``cudaLaunchCooperativeKernel``, L or 1 a chunk), the
    chunks whose successor's LSTM kernel was enqueued before the copy
    completed (None where the launches do not divide evenly by chunk)."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith('cuda')]
    calls: dict = {}
    for e in host:
        calls[e.name] = calls.get(e.name, 0) + 1
    copies = sorted(e.time_range.end for e in events
                    if e.device_type == DeviceType.CUDA and 'DtoH' in e.name)
    launches = sorted(e.time_range.start for e in host
                      if e.name == 'cudaLaunchCooperativeKernel')
    n = len(copies)
    per = len(launches) // n if n else 0
    early = (sum(launches[(k + 1) * per] < copies[k] for k in range(n - 1))
             if n > 1 and per and len(launches) == per * n else None)
    return dict(chunks=n, runtime_calls=calls,
                host_waits={k: v for k, v in calls.items()
                            if 'Synchronize' in k},
                next_kernel_before_readback=early)


def trace(fn, label: str, readback: bool = False, warm: bool = True):
    """One traced call of ``fn`` (after a warm call): device busy time from
    ``torch.profiler`` over the host wall time of the traced call, device
    time by kernel name, and the host ms and count under each
    ``record_function`` label (a train step's phases,
    ``launch.train.PHASES``; MoE's expert reads); with
    ``readback`` (an engine drain), ``readback_overlap``.  The tracer's own
    cost inflates the wall time, so the idle share is an upper bound.
    ``warm=False``: no warm call (a caller that has just run ``fn``'s
    work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the profiler's raw events, read once: ``key_averages`` first builds
    # the tree of every host op, ~1 ms a device op (minutes for a training
    # step of 10^5 ops).  Device-side entries only (kernels, copies, sets):
    # a host op's entry repeats the time of the kernels it launched, and a
    # label's device-side span covers kernels already counted
    dev_ns, host_ns, host_n = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and e.duration_ns() > 0:
                t, n = dev_ns.get(e.name(), (0, 0))
                dev_ns[e.name()] = (t + e.duration_ns(), n + 1)
        elif e.is_user_annotation():
            host_ns[e.name()] = host_ns.get(e.name(), 0) + e.duration_ns()
            host_n[e.name()] = host_n.get(e.name(), 0) + 1
    by_name = sorted(((k, t / 1e3, n) for k, (t, n) in dev_ns.items()),
                     key=lambda r: -r[1])
    busy_us = sum(r[1] for r in by_name)
    res = dict(backend=label, wall_ms=wall_us / 1e3,
               device_busy_ms=busy_us / 1e3,
               idle_share=1.0 - busy_us / wall_us,
               device_ops=sum(r[2] for r in by_name),
               ops_by_name={k: n for k, _, n in by_name},
               top=[dict(name=k[:80], device_ms=t / 1e3, count=n)
                    for k, t, n in by_name[:10]],
               phases_host_ms={k: t / 1e6 for k, t in host_ns.items()},
               phases_count=host_n,
               readback=(readback_overlap(prof.events()) if readback
                         else None))
    print(f'profile [{label}]: wall {res["wall_ms"]:.2f} ms, device busy '
          f'{res["device_busy_ms"]:.2f} ms in {res["device_ops"]} device '
          f'ops, idle share {res["idle_share"]:.3f}; top: ' + '; '.join(
              f'{r["name"][:40]} {r["device_ms"]:.2f} ms x{r["count"]}'
              for r in res['top'][:5]), flush=True)
    if res['readback'] is not None:
        rb = res['readback']
        print(f'profile [{label}]: of {rb["chunks"]} chunks, '
              f'{rb["next_kernel_before_readback"]} had the next chunk\'s '
              f'LSTM kernel enqueued before their log-prob copy completed; '
              f'host waits {rb["host_waits"]}; runtime calls '
              f'{rb["runtime_calls"]}', flush=True)
    if res['phases_host_ms']:
        print(f'profile [{label}]: host ms by phase: ' + ', '.join(
            f'{k} {v:.3f}' for k, v in res['phases_host_ms'].items()),
            flush=True)
    return res


def profile_engine(cfg, params, slots: int, chunk: int, utts, backend: str,
                   async_dispatch: bool = False):
    """One traced engine drain on ``backend``, sync or async (``trace``)."""
    from repro_torch.launch.serve import StreamServer

    def drain():
        server = StreamServer(cfg.replace(lstm_backend=backend), params,
                              num_slots=slots, chunk=chunk,
                              async_dispatch=async_dispatch)
        for u in utts:
            server.submit(u)
        server.drain()

    return trace(drain, backend + (' async' if async_dispatch else ''),
                 readback=True)


def quantize_stack(params):
    """Every layer on its silicon plan ``SystolicPlan(n_x, N_h, 96)``:
    ``pack_lstm`` -> ``quantize_packed`` (the reference example's deploy
    step), on the weights' device."""
    from repro_torch.core import systolic as sy
    return [sy.quantize_packed(sy.pack_lstm(lp, sy.SystolicPlan(
        lp.n_x, lp.n_h, sy.N_LSTM_SILICON))) for lp in params.layers]


def int8_inputs(qps, T: int, B: int, rng, dev):
    """K3 and K4 inputs at (T, B) from ``rng``: quantized random frames, a
    ragged mask (a full, an empty and partial streams), nonzero carried
    codes (padded rows zero).  Returns (k3, k4): k3 a list of (plan, args,
    kw) on layer 0's plan and on an inner plan (frame codes of its width),
    k4 (plan, args, kw) on the stack's weights (``stack_kernel_weights_q``)
    with layer 0's hoisted x-region prefix."""
    from repro_torch.core import quant, systolic as sy
    from repro_torch.core.lstm import valid_len_mask
    from repro_torch.kernels.lstm_seq import stack_kernel_weights_q
    from repro_torch.kernels.lstm_seq.ops import _dense_from_tiles
    L, p0 = len(qps), qps[0].plan
    N, P_h = p0.n_h, p0.padded_h
    xq = quant.quantize(torch.from_numpy(
        (rng.randn(T, B, p0.n_x) * 0.5).astype(np.float32)).to(dev))
    mask = valid_len_mask(T, torch.from_numpy(ragged_lens(rng, T, B)).to(dev),
                          B)

    def codes(*shape):   # nonzero carried codes; padded rows stay zero
        c = torch.from_numpy(rng.randint(-64, 64, shape).astype(np.int8))
        c[..., N:] = 0
        return c.to(dev)

    k3 = []
    for qp in qps[:2]:                       # layer 0's plan, an inner plan
        plan = qp.plan
        xs_pad = torch.zeros((T, B, plan.padded_x), dtype=torch.int8,
                             device=dev)
        xs_pad[..., :plan.n_x] = (xq if plan.n_x == p0.n_x else
                                  codes(T, B, plan.n_x))
        k3.append((plan, (xs_pad, *_dense_from_tiles(qp), qp.sig_lut,
                          qp.tanh_lut, codes(B, P_h), codes(B, P_h), mask),
                   dict(tile=plan.tile, cols_x=plan.cols_x)))
    wts = stack_kernel_weights_q(qps)
    k4 = (p0, (sy.quantized_x_prefix(qps[0], xq).contiguous(), wts.w_in,
               wts.w_h, wts.peep, wts.bias, wts.sig_lut, wts.tanh_lut,
               codes(L, B, P_h), codes(L, B, P_h), mask),
          dict(tile=p0.tile))
    return k3, k4


def int8_case(kernel: str, plan, args, kw, reps: int = 50):
    """One K3 (``kernel`` 'lstm_seq_quantized', ``args`` on ``plan``) or K4
    ('lstm_stack_seq_kernel_q') case from ``int8_inputs``: ``torch.equal``
    to its plain version on the h and c codes, the largest code difference,
    the kernel's ms, its plain version's, and the bound (bytes: unpadded
    codes and weights, each input read once and each output written once,
    padding being the kernels' choice; operations: the live steps' MACs and
    epilogues at the int8 peak).  Only calls that the parent tree has too,
    so ``--ab`` runs it on either."""
    from repro_torch.kernels import lstm_seq as ks
    mask = args[-1]
    T, B = mask.shape
    n_live, N = int(mask.sum()), plan.n_h
    if kernel == 'lstm_seq_quantized':
        fn, ref, L = ks.lstm_seq_quantized, ks.lstm_seq_quantized_ref, 1
        nbytes = (T * B * plan.n_x + 4 * N * (plan.n_x + N) + 3 * N
                  + 2 * 4 * N + 512 + 2 * B * N + T * B + 2 * T * B * N)
        flops = n_live * (8 * N * (plan.n_x + N) + 30 * N)
    else:
        fn, ref = ks.lstm_stack_seq_kernel_q, ks.lstm_stack_seq_quantized_ref
        L = args[2].shape[0]
        # acc_x's N rows, layer 0's own-h weights, the inner layers' below-h
        # and own-h weights, codes and outputs
        nbytes = (4 * T * B * 4 * N + 4 * N * N * (2 * L - 1) + 3 * L * N
                  + 8 * L * N + 512 + 2 * L * B * N + T * B
                  + 2 * L * T * B * N)
        flops = n_live * ((2 * L - 1) * 8 * N * N + 30 * L * N)
    got, want = fn(*args, **kw), ref(*args, **kw)
    equal = {k: torch.equal(g, w) for k, g, w in zip('hc', got, want)}
    case = dict(kernel=kernel, shape=f'T={T} B={B} n_x={plan.n_x} N_h={N} '
                                     f'L={L} tile={plan.tile}',
                live_steps=n_live, equal=equal, max_abs_err=max(
                    int((g.int() - w.int()).abs().max())
                    for g, w in zip(got, want)),
                tol=0, ok=all(equal.values()),
                ms=cuda_ms(lambda: fn(*args, **kw), reps),
                plain_ms=cuda_ms(lambda: ref(*args, **kw), 3, warmup=1),
                bytes=nbytes, flops=flops, library_ms=None)
    case['bound_ms'], case['bound_by'] = bound(nbytes, flops, INT8_OPS_PER_S)
    return case


def int8_kernel_checks(qps, B: int, T: int, rng, dev):
    """K3 (on both layer plans) and K4 against their plain versions at the
    serving shape, bit for bit (``int8_case``), with their launch geometry;
    K4 also at ``TRAIN_SEQ`` steps.  The kernels line's numbers are K3's on
    layer 0's plan and K4's at T = ``T``."""
    from repro_torch.kernels.lstm_seq import (seq_q_geometry,
                                              stack_kernel_weights_q,
                                              stack_q_geometry)
    from repro_torch.kernels.lstm_seq.kernel import q_threads
    L, p0 = len(qps), qps[0].plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k3, (_, k4_args, k4_kw) = int8_inputs(qps, T, B, rng, dev)
    _, (_, k4_long, _) = int8_inputs(qps, TRAIN_SEQ, B, rng, dev)
    geoms = {'lstm_seq_quantized': seq_q_geometry(
        p0.padded_x, p0.padded_h, p0.tile, B, sms),
             'lstm_stack_seq_kernel_q': stack_q_geometry(
        p0.padded_h, p0.tile, L, B, sms)}
    cases = {'lstm_seq_quantized': [int8_case('lstm_seq_quantized', *c)
                                    for c in k3],
             'lstm_stack_seq_kernel_q': [
                 int8_case('lstm_stack_seq_kernel_q', p0, k4_args, k4_kw),
                 int8_case('lstm_stack_seq_kernel_q', p0, k4_long, k4_kw)]}
    rows = []
    for name, file, replaces in (
            ('lstm_seq_quantized', 'lstm_seq_q.cu', 'kernel.py:258'),
            ('lstm_stack_seq_kernel_q', 'lstm_stack_seq_q.cu',
             'stack_kernel.py:382')):
        geom = geoms[name]
        cases[name][0]['geometry'] = dict(dataclasses.asdict(geom),
                                          threads=q_threads(geom.rows, B))
        for c in cases[name]:
            print(f"{name}: {c['shape']} live steps {c['live_steps']}: "
                  f"torch.equal to plain version {c['ok']}, kernel "
                  f"{c['ms']:.4f} ms, plain {c['plain_ms']:.3f} ms, bound "
                  f"{c['bound_ms']:.5f} ms ({c['bound_by']}; "
                  f"{c['bytes'] / 1e6:.3f} MB)", flush=True)
            check(c['ok'], f"{name} disagrees with its plain version at "
                           f"{c['shape']}")
        print(f"{name}: geometry at the serving shape "
              f"{cases[name][0]['geometry']}", flush=True)
        rows.append(_case_row(
            name, f'src/repro_torch/csrc/{file}',
            f'src/repro/kernels/lstm_seq/{replaces}', cases[name]))

    build = lambda: stack_kernel_weights_q(qps)
    wts = build()
    stacking = dict(mbytes=1e-6 * sum(
        a.numel() * a.element_size() for a in
        (wts.w_in, wts.w_h, wts.peep, wts.bias,
         *(a for lw in wts.layers for a in lw))),
                    device_ms=cuda_ms(build, 20), host_ms=host_ms(build, 20))
    print(f"stack_kernel_weights_q: {stacking['mbytes']:.2f} MB (K3 and K4 "
          f"layouts) built once per set of quantized layers, device "
          f"{stacking['device_ms']:.4f} ms, host {stacking['host_ms']:.4f} ms "
          f"per build", flush=True)
    return rows, stacking


def int8_chunks(qps, xq, lens, chunk: int, weights, backend: str):
    """The int8 stack over ``xq`` (T, B, n_x) in chunks of ``chunk`` frames
    with the stack-layout carry and per-chunk valid lengths from ``lens``.
    Returns (top-layer codes (T, B, n_h), final (h_q, c_q))."""
    from repro_torch.kernels.lstm_seq import lstm_stack_seq_quantized_auto
    state, outs = None, []
    for lo in range(0, xq.shape[0], chunk):
        vl = torch.from_numpy(np.clip(lens - lo, 0, chunk)).to(xq.device)
        o, state = lstm_stack_seq_quantized_auto(
            qps, xq[lo:lo + chunk], state=state, valid_len=vl,
            return_state=True, weights=weights, backend=backend)
        outs.append(o)
    return torch.cat(outs), state


def int8_chunked_checks(qps, B: int, chunk: int, rng, dev):
    """int8 chunked == monolithic over 3 ragged chunks on both backends,
    and fused == layerwise == the reference chain on the valid prefix."""
    from repro_torch.core import quant, systolic as sy
    from repro_torch.kernels.lstm_seq import (lstm_stack_seq_quantized_auto,
                                              stack_kernel_weights_q)
    T = 3 * chunk
    xq = quant.quantize(torch.from_numpy(
        (rng.randn(T, B, qps[0].plan.n_x) * 0.5).astype(np.float32)).to(dev))
    lens = ragged_lens(rng, T, B)
    weights = stack_kernel_weights_q(qps)
    monos = {}
    for backend in ('fused', 'layerwise'):
        mono, fin = lstm_stack_seq_quantized_auto(
            qps, xq, valid_len=torch.from_numpy(lens).to(dev),
            return_state=True, weights=weights, backend=backend)
        got, state = int8_chunks(qps, xq, lens, chunk, weights, backend)
        same = (torch.equal(got, mono)
                and torch.equal(state[0], fin[0])
                and torch.equal(state[1], fin[1]))
        print(f'int8 chunked == monolithic [{backend}] T={T} in '
              f'{T // chunk} chunks, B={B}: {same}', flush=True)
        check(same, f'int8 chunked != monolithic on {backend}')
        monos[backend] = (mono, fin)
    chain = xq
    for qp in qps:
        chain = sy.systolic_layer_quantized(qp, chain)
    (fu, fu_fin), (lw, lw_fin) = monos['fused'], monos['layerwise']
    same = (torch.equal(fu, lw) and torch.equal(fu_fin[0], lw_fin[0])
            and torch.equal(fu_fin[1], lw_fin[1])
            and all(torch.equal(fu[:n, b], chain[:n, b])
                    for b, n in enumerate(lens)))
    print(f'int8 fused == layerwise == systolic_layer_quantized x'
          f'{len(qps)}: {same}', flush=True)
    check(same, 'int8 fused, layerwise and the reference chain disagree')


def int8_batch(cfg, utts, chunk: int, dev):
    """The utterances as one ragged batch of frame codes, (T, B, n_x) with
    T rounded up to whole chunks, and their lengths."""
    from repro_torch.core import quant
    lens = np.array([len(u) for u in utts])
    T = -(-int(lens.max()) // chunk) * chunk
    frames = np.zeros((T, len(utts), cfg.lstm_inputs), np.float32)
    for b, u in enumerate(utts):
        frames[:len(u), b] = u
    return quant.quantize(torch.from_numpy(frames).to(dev)), lens


def int8_deploy_case(cfg, qps, utts, dev, passes: int = 5):
    """The int8 deploy's wall time (``int8_chunks`` over the utterances as
    one batch, chunks of ``CHUNK``) on ``auto`` and ``layerwise``: a warm
    pass each, then ``passes`` timed passes each, interleaved, each ending
    in a synchronize; the median frames/s and mean chunk ms of each.  Only
    calls that the parent tree has too."""
    from repro_torch.kernels.lstm_seq import stack_kernel_weights_q
    xq, lens = int8_batch(cfg, utts, CHUNK, dev)
    weights = stack_kernel_weights_q(qps)
    n_chunks, backends = xq.shape[0] // CHUNK, ('auto', 'layerwise')
    walls = {b: [] for b in backends}
    for i in range(passes + 1):
        for b in backends:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            int8_chunks(qps, xq, lens, CHUNK, weights, b)
            torch.cuda.synchronize()
            if i:
                walls[b].append(time.perf_counter() - t0)
    return [dict(kernel=f'int8 deploy {b}',
                 shape=f'{len(utts)} utterances, {int(lens.sum())} frames, '
                       f'{n_chunks} chunks',
                 chunk_ms=float(np.median(walls[b])) / n_chunks * 1e3,
                 frames_per_s=float(np.median(
                     [lens.sum() / w for w in walls[b]])))
            for b in backends]


def int8_deploy(cfg, params, qps, chunk: int, utts, dev,
                profile: bool = False):
    """The int8 main path: the utterances as one ragged batch, in chunks of
    ``chunk`` frames with the stack-layout carry, on ``auto`` (must resolve
    to ``fused``) and ``layerwise``; launch counts of each backend's first
    pass, the wall times of ``INT8_REPEATS`` more passes of each,
    interleaved, (with ``profile``) a trace of ``INT8_PROFILE_PASSES``
    passes of each, then the f32 read-out of the dequantized codes and
    greedy decode against the f32 ``forward``."""
    from repro_torch.core import quant
    from repro_torch.core.ctc import ctc_greedy_decode
    from repro_torch.core.lstm import readout
    from repro_torch.kernels.lstm_seq import (lstm_seq_quantized,
                                              lstm_stack_seq_kernel_q,
                                              stack_kernel_weights_q)
    from repro_torch.models import chipmunk_net
    B, L = len(utts), len(qps)
    xq, lens = int8_batch(cfg, utts, chunk, dev)
    n_frames, T = int(lens.sum()), xq.shape[0]
    weights = stack_kernel_weights_q(qps)
    n_chunks = T // chunk
    backends = ('auto', 'layerwise')

    def deploy(backend):
        return int8_chunks(qps, xq, lens, chunk, weights, backend)[0]

    def timed(backend):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = deploy(backend)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    runs, codes = {}, {}
    for backend in backends:
        lstm_seq_quantized.launches = 0
        lstm_stack_seq_kernel_q.launches = 0
        codes[backend], wall = timed(backend)
        launches = dict(lstm_seq_quantized=lstm_seq_quantized.launches,
                        lstm_stack_seq_kernel_q=lstm_stack_seq_kernel_q
                        .launches)
        runs[backend] = dict(launches=launches, chunks=n_chunks,
                             frames=n_frames, first_wall_s=wall, walls_s=[])
        print(f'int8 deploy [{backend}]: {B} utterances, {n_frames} frames, '
              f'{n_chunks} chunks of {chunk}: first pass {wall:.4f} s, '
              f'launches {launches}', flush=True)
    for _ in range(INT8_REPEATS):
        for backend in backends:
            runs[backend]['walls_s'].append(timed(backend)[1])
    for backend in backends:
        r = runs[backend]
        rates = sorted(n_frames / w for w in r['walls_s'])
        r.update(frames_per_s=float(np.median(rates)),
                 frames_per_s_min=rates[0], frames_per_s_max=rates[-1])
        print(f'int8 deploy [{backend}]: {INT8_REPEATS} timed passes, '
              f'interleaved: median {r["frames_per_s"]:.0f} frames/s '
              f'(min {rates[0]:.0f}, max {rates[-1]:.0f})', flush=True)
    profiles = [trace(lambda b=b: [deploy(b)
                                   for _ in range(INT8_PROFILE_PASSES)],
                      f'int8 {b} x{INT8_PROFILE_PASSES}')
                for b in (backends if profile else ())]
    check(runs['auto']['launches'] == dict(
        lstm_seq_quantized=0, lstm_stack_seq_kernel_q=n_chunks),
        'int8 auto must resolve to fused: one K4 launch per chunk')
    check(runs['layerwise']['launches'] == dict(
        lstm_seq_quantized=L * n_chunks, lstm_stack_seq_kernel_q=0),
        'int8 layerwise must launch K3 L times per chunk')
    check(torch.equal(codes['auto'], codes['layerwise']),
          'int8 fused and layerwise deploy codes differ')

    h = quant.dequantize(codes['auto'], quant.STATE_FMT)
    lp_q = torch.log_softmax(readout(params.w_out, params.b_out, h), dim=-1)
    check(bool(torch.isfinite(lp_q).all()) and lp_q.shape == (
        T, B, cfg.n_outputs), 'int8 log-probs not finite or misshapen')
    agree, frame_agree = [], []
    for b, u in enumerate(utts):
        n = len(u)
        lp_f = chipmunk_net.forward(cfg.replace(lstm_backend='cuda_seq_fused'),
                                    params, torch.from_numpy(u)[None].to(dev))
        dq, nq = ctc_greedy_decode(lp_q[:n, b:b + 1])
        df, nf = ctc_greedy_decode(lp_f)
        agree.append(torch.equal(dq[0, :int(nq[0])], df[0, :int(nf[0])]))
        frame_agree.append(float((lp_q[:n, b].argmax(-1)
                                  == lp_f[:, 0].argmax(-1)).float().mean()))
    res = dict(runs=runs, profiles=profiles,
               decode_agreement=float(np.mean(agree)),
               frame_argmax_agreement=float(np.mean(frame_agree)))
    print(f'int8 systolic deployment: greedy decode agreement with f32 '
          f'{res["decode_agreement"] * 100:.0f}% across {B} utterances '
          f'(frame argmax agreement {res["frame_argmax_agreement"]:.3f}; '
          f'random weights: reported, not asserted)', flush=True)
    return res


def f4_checks(cfg, params, qps, rng, dev):
    """Batch blocks past each kernel's largest single launch (``F4_BATCH``,
    T = ``CHUNK``): K1 and K2 allclose to their plain versions (atol
    ``KERNEL_ATOL``) with every row bit-equal to the same row of a B = 8
    launch that holds it, K3 (inner plan) and K4 ``torch.equal`` to theirs;
    each call two launches.  Then ``StreamingEngine(max_streams=
    F4_SLOTS)`` on ``auto`` builds (K1 in two blocks a layer) and drains
    ``F4_UTTERANCES`` utterances, each stream allclose to the monolithic
    ``forward``.  The launch counters are set to 0 just before each call
    and read just after."""
    from repro_torch.kernels import lstm_seq as ks
    from repro_torch.models import chipmunk_net
    from repro_torch.serving import StreamingEngine
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    for name in ('lstm_seq', 'lstm_stack_seq_kernel'):
        B = F4_BATCH[name]
        wts, pre_x, mask, h0, c0 = seq_inputs(params, CHUNK, B, g, dev)
        if name == 'lstm_seq':
            lp = params.layers[0]
            fn, ref, bdim = ks.lstm_seq, ks.lstm_seq_ref, 0
            args = [pre_x, lp.w_h, lp.w_peep, lp.b, h0[0], c0[0], mask]
        else:
            fn, ref, bdim = (ks.lstm_stack_seq_kernel, ks.lstm_stack_seq_ref,
                             1)
            args = [pre_x, wts.w_in, wts.w_h, wts.peep, wts.b, h0, c0, mask]
        fn.launches = 0
        got = fn(*args)
        torch.cuda.synchronize()
        launches = fn.launches
        err = max(float((a - b).abs().max())
                  for a, b in zip(got, ref(*args)))
        rows_equal = True
        for lo in sorted({*range(0, B - 8, 8), B - 8}):
            part = list(args)
            part[0], part[-1] = args[0][:, lo:lo + 8], args[-1][:, lo:lo + 8]
            for i in (-3, -2):
                part[i] = args[i].narrow(bdim, lo, 8)
            part = [a.contiguous() for a in part]
            rows_equal &= all(torch.equal(a.narrow(bdim + 1, lo, 8), b)
                              for a, b in zip(got, fn(*part)))
        res[name] = dict(batch=B, launches=launches, max_abs_err=err,
                         rows_equal_b8=rows_equal)
        print(f'F4 {name}: B={B} T={CHUNK} in {launches} launches: max_abs_err '
              f'{err:.3e} (tol {KERNEL_ATOL}), every row equal to a B=8 '
              f'launch: {rows_equal}', flush=True)
        check(launches == 2 and err <= KERNEL_ATOL and rows_equal,
              f'F4: {name} at B={B}')
    for name in ('lstm_seq_quantized', 'lstm_stack_seq_kernel_q'):
        B = F4_BATCH[name]
        k3, k4 = int8_inputs(qps, CHUNK, B, rng, dev)
        plan, args, kw = k3[1] if name == 'lstm_seq_quantized' else k4
        fn = getattr(ks, name)
        ref = (ks.lstm_seq_quantized_ref if name == 'lstm_seq_quantized'
               else ks.lstm_stack_seq_quantized_ref)
        fn.launches = 0
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        launches = fn.launches
        equal = all(torch.equal(a, b) for a, b in zip(got, ref(*args, **kw)))
        res[name] = dict(batch=B, launches=launches, equal=equal,
                         plan=f'n_x={plan.n_x} padded_x={plan.padded_x}')
        print(f'F4 {name}: B={B} T={CHUNK} ({res[name]["plan"]}) in '
              f'{launches} launches: torch.equal to plain version {equal}',
              flush=True)
        check(launches == 2 and equal, f'F4: {name} at B={B}')

    eng = StreamingEngine(cfg, params, max_streams=F4_SLOTS, chunk=CHUNK)
    check(eng.backend == 'cuda_seq', f'F4 engine on auto pinned '
          f'{eng.backend}')
    utts = [(rng.randn(rng.randint(8, 48), cfg.lstm_inputs) * 0.5).astype(
        np.float32) for _ in range(F4_UTTERANCES)]
    sess = [eng.submit(u) for u in utts]
    torch.cuda.synchronize()
    ks.lstm_seq.launches = ks.lstm_stack_seq_kernel.launches = 0
    eng.run()
    torch.cuda.synchronize()
    launches = ks.lstm_seq.launches
    steps = eng.stats()['steps']
    check(launches == 2 * cfg.n_layers * steps and
          ks.lstm_stack_seq_kernel.launches == 0,
          f'F4 engine: {launches} K1 launches in {steps} steps')
    fwd = cfg.replace(lstm_backend='cuda_seq_fused')
    worst = 0.0
    for s, u in zip(sess, utts):
        mono = chipmunk_net.forward(fwd, params, torch.from_numpy(u)[None]
                                    .to(dev))[:, 0].cpu().numpy()
        lp = s.full_log_probs()
        check(lp.shape == mono.shape and np.allclose(
            lp, mono, rtol=ENGINE_RTOL, atol=ENGINE_ATOL),
            f'F4 engine: stream {s.sid} differs from forward')
        worst = max(worst, float(np.abs(lp - mono).max()))
    res['engine'] = dict(slots=F4_SLOTS, utterances=len(utts), steps=steps,
                         backend=eng.backend, k1_launches=launches,
                         max_abs_diff_forward=worst)
    print(f'F4 engine: StreamingEngine(max_streams={F4_SLOTS}) on auto -> '
          f'{eng.backend}, {len(utts)} utterances in {steps} steps, '
          f'{launches} K1 launches (2 blocks x {cfg.n_layers} layers a '
          f'step), max abs diff vs forward {worst:.3e}', flush=True)
    return res


def fault_engine(cfg, params, backend: str, faults, async_dispatch=False,
                 slots: int = SLOTS):
    """A ``StreamingEngine`` on ``backend`` with ``faults`` whose chunk
    calls are logged: for each call its role (``launch``: a chunk's first
    attempt; ``retry``: its recompute under the runner; ``canary``: a
    promotion's shadow replay), the chunk (for a canary, the committed
    step), the rung, and the K1 and K2 launches it made (counter deltas
    around the call).  Each canary comparison also records its largest
    absolute and relative difference (``engine.canary_diffs``), then
    compares as the engine does.  Returns (engine, log)."""
    from repro_torch.kernels.lstm_seq import (lstm_seq, lstm_seq_quantized,
                                              lstm_stack_seq_kernel,
                                              lstm_stack_seq_kernel_q)
    from repro_torch.serving import StreamingEngine
    eng = StreamingEngine(cfg.replace(lstm_backend=backend), params,
                          max_streams=slots, chunk=CHUNK, faults=faults,
                          async_dispatch=async_dispatch)
    kernels = (lstm_seq, lstm_stack_seq_kernel, lstm_seq_quantized,
               lstm_stack_seq_kernel_q)
    log, ctx = [], []
    make, launch, commit = eng._make_fwd, eng._launch, eng._commit
    promote = eng._maybe_promote

    def traced(c, *placement):
        fwd = make(c, *placement)
        # the stages of a systolic call's mesh (its own placement's, else
        # the home one's; None on a flat rung)
        pl = (placement[0] if placement and placement[0] is not None
              else eng.placement)
        stages = (pl.mesh.stage if c.lstm_backend.endswith('_systolic')
                  and pl is not None else None)

        def call(*args):
            before = [k.launches for k in kernels]
            out = fwd(*args)
            k1, k2, k3, k4 = (k.launches - b for k, b in zip(kernels, before))
            role, chunk = ctx[-1]
            log.append(dict(role=role, chunk=chunk, backend=c.lstm_backend,
                            stages=stages, k1=k1, k2=k2, k3=k3, k4=k4))
            return out
        return call

    def within(role, fn, chunk_of):
        def run(*args):
            ctx.append((role, chunk_of(*args)))
            try:
                return fn(*args)
            finally:
                ctx.pop()
        return run

    equal = eng._canary_equal

    def compared(a, b):
        x, y = (torch.as_tensor(t).detach().cpu().double() for t in (a, b))
        diff = (x - y).abs()
        canary.append((float(diff.max()), float((diff / y.abs()).nan_to_num(
            0.0, posinf=float('inf')).max())))
        return equal(a, b)

    canary = []
    eng._canary_equal = compared
    eng.canary_diffs = canary
    eng._make_fwd = traced
    eng._fwd = traced(eng.cfg)
    eng._launch = within('launch', launch, lambda s, p, k, n: k)
    eng._commit = within('retry', commit, lambda rec: rec.chunk_idx)
    eng._maybe_promote = within('canary', promote, lambda: eng._step_idx)
    return eng, log


def fault_serve(cfg, params, backend: str, utts, faults,
                async_dispatch=False):
    """One drain of ``utts`` on ``fault_engine``.  Returns (log-probs per
    stream, sessions, engine, call log)."""
    eng, log = fault_engine(cfg, params, backend, faults, async_dispatch)
    sessions = [eng.submit(u) for u in utts]
    eng.run()
    torch.cuda.synchronize()
    return [s.full_log_probs() for s in sessions], sessions, eng, log


def _trail(stats):
    """The engine's and runner's events without wall times, the wall-time
    classification (``straggler``) and the async engine's ``squash``."""
    return [{k: v for k, v in e.items() if k != 'dt'}
            for e in stats['events']
            if e['kind'] not in ('straggler', 'squash')]


def _calls_per_rung_ok(log, L: int) -> bool:
    """Every logged call launched what its rung launches: K2 once on
    ``cuda_seq_fused``, K1 L times on ``cuda_seq``, neither on
    ``torch_scan``."""
    want = {'cuda_seq_fused': (0, 1), 'cuda_seq': (L, 0),
            'torch_scan': (0, 0)}
    return all((c['k1'], c['k2']) == want[c['backend']] for c in log)


def fault_ladder(cfg, params, utts, clean, mono):
    """The ladder on the K2 home (``FAULT_LADDER``): K2 -> K1 -> torch_scan
    by two permanent failures, then the two heals, under the bitwise
    canary, under ``canary_rtol`` = ``ENGINE_RTOL``, and without the
    canary (where both promotions must land), each sync and async.  Per
    run: the rung of each chunk call with its launches, the canary's
    outcome per promotion, no stream lost, every stream allclose to the
    clean K2 engine and to ``forward``, async == sync (event trail and
    bits)."""
    from repro_torch.runtime import ServingFaultConfig
    L = cfg.n_layers
    # chunks 0-1 on K2; chunk 2 launched on K2 and recomputed on K1; 3-4 on
    # K1; chunk 5 launched on K1 and recomputed on the scan; 6-7 on the scan
    head = ([('launch', k, 'cuda_seq_fused') for k in (0, 1, 2)]
            + [('retry', 2, 'cuda_seq')]
            + [('launch', k, 'cuda_seq') for k in (3, 4, 5)]
            + [('retry', 5, 'torch_scan')]
            + [('launch', k, 'torch_scan') for k in (6, 7)])
    # the one-rung schedule (``FAULT_ONE_RUNG``) drops to K1 only, so the
    # bitwise canary of K1 -> K2 runs too
    variants = (('bitwise', FAULT_LADDER, {}, head),
                ('canary_rtol', FAULT_LADDER,
                 dict(canary_rtol=ENGINE_RTOL), head),
                ('no_canary', FAULT_LADDER, dict(canary=False), head),
                ('bitwise, one rung', FAULT_ONE_RUNG, {}, head[:6]))
    out = {}
    for name, schedule, extra, want in variants:
        runs = {}
        for mode in (False, True):
            lps, sess, eng, log = fault_serve(
                cfg, params, 'cuda_seq_fused', utts,
                ServingFaultConfig(**schedule, **extra), mode)
            stats = eng.stats()
            runs[mode] = (lps, stats, log)
            chunks = [c for c in log if c['role'] != 'canary']
            check([(c['role'], c['chunk'], c['backend'])
                   for c in chunks[:len(want)]] == want,
                  f'ladder [{name}]: chunk calls {chunks[:len(want)]}')
            check(_calls_per_rung_ok(log, L),
                  f'ladder [{name}]: launches per call {log}')
            check(stats['streams'] == len(utts)
                  and all(s.error is None for s in sess),
                  f'ladder [{name}]: a stream was lost')
        (lps, stats, log), (alps, astats, alog) = runs[False], runs[True]
        same = (_trail(stats) == _trail(astats)
                and all(np.array_equal(a, b) for a, b in zip(lps, alps))
                and log == alog)
        check(same, f'ladder [{name}]: async differs from sync')
        worst = dict(clean=0.0, forward=0.0)
        for i, lp in enumerate(lps):
            for ref_name, ref in (('clean', clean[i]), ('forward', mono[i])):
                worst[ref_name] = max(worst[ref_name],
                                      float(np.abs(lp - ref).max()))
                check(np.allclose(lp, ref, rtol=ENGINE_RTOL,
                                  atol=ENGINE_ATOL),
                      f'ladder [{name}]: stream {i} vs {ref_name}')
        promos = [dict(step=e['step'], kind=e['kind'],
                       candidate=e['to_backend'],
                       **({'backoff': e['backoff']}
                          if 'backoff' in e else {}))
                  for e in stats['events'] if e['kind'] in (
                      'promote_canary', 'promote', 'promote_rejected')]
        canary_calls = [c for c in log if c['role'] == 'canary']
        per_rung = {}
        for c in log:
            if c['role'] != 'canary':
                r = per_rung.setdefault(c['backend'], dict(calls=0, k1=0,
                                                           k2=0))
                r['calls'] += 1
                r['k1'] += c['k1']
                r['k2'] += c['k2']
        out[name] = dict(
            steps=stats['steps'], final_backend=stats['backend'],
            event_counts=stats['event_counts'], promotions=promos,
            canary_calls=canary_calls, canary_diffs=eng.canary_diffs,
            per_rung=per_rung,
            chunk_calls=[(c['role'], c['chunk'], c['backend'])
                         for c in log],
            max_abs_diff=worst, async_equals_sync=same)
        print(f'fault ladder [{name}]: {stats["steps"]} steps, ends on '
              f'{stats["backend"]}; promotions {promos}; canary shadow '
              f'calls (step, rung, K1, K2) '
              f'{[(c["chunk"], c["backend"], c["k1"], c["k2"]) for c in canary_calls]}'
              f', their largest (abs, rel) differences per comparison '
              f'{[(f"{a:.3e}", f"{r:.3e}") for a, r in eng.canary_diffs]}; '
              f'chunk calls per rung {per_rung}; max abs diff vs clean '
              f'K2 {worst["clean"]:.3e}, vs forward {worst["forward"]:.3e}; '
              f'async == sync {same}', flush=True)
    check(out['no_canary']['final_backend'] == 'cuda_seq_fused'
          and out['no_canary']['event_counts'].get('promote') == 2,
          'ladder without the canary did not climb back to K2')
    return out


def fault_runs(cfg, params, utts, dev):
    """The serving fault runtime at full width on the main cell (``SLOTS``
    slots, chunks of ``CHUNK``, ``utts``): the ladder (``fault_ladder``),
    a transient fault and a poisoned slot at chunk ``FAULT_STEP`` on K2
    and on K1, sync and async, a cross-engine checkpoint resume on both,
    an int8 stream's carries through the checkpointer between two K4
    chunks, and the guard's cost (``fault_guard``)."""
    import tempfile
    from repro_torch.models import chipmunk_net
    from repro_torch.runtime import ServingFaultConfig
    res, clean = {}, {}
    for backend in ('cuda_seq_fused', 'cuda_seq'):
        clean[backend] = fault_serve(cfg, params, backend, utts, None)[0]
    fwd = cfg.replace(lstm_backend='cuda_seq_fused')
    mono = [chipmunk_net.forward(fwd, params, torch.from_numpy(u)[None].to(
        dev))[:, 0].cpu().numpy() for u in utts]
    res['ladder'] = fault_ladder(cfg, params, utts, clean['cuda_seq_fused'],
                                 mono)

    for backend in ('cuda_seq_fused', 'cuda_seq'):
        for name, faults in (
                ('transient', dict(fail_at={FAULT_STEP: {'transient': True}},
                                   backoff_s=0.0)),
                ('quarantine', dict(poison_at={FAULT_STEP: 1}))):
            for mode in (False, True):
                lps, sess, eng, log = fault_serve(
                    cfg, params, backend, utts, ServingFaultConfig(**faults),
                    mode)
                stats = eng.stats()
                counts = stats['event_counts']
                errored = [i for i, s in enumerate(sess)
                           if s.error is not None]
                equal = all(np.array_equal(lp, ref) for i, (lp, ref) in
                            enumerate(zip(lps, clean[backend]))
                            if i not in errored)
                if name == 'transient':
                    ok = (counts.get('fault') == 1 and 'degrade' not in counts
                          and not errored and {c['backend'] for c in log}
                          == {backend} and _calls_per_rung_ok(
                              log, cfg.n_layers))
                else:
                    ok = (counts.get('quarantine') == 1 and len(errored) == 1
                          and all(bool(torch.isfinite(t).all())
                                  for pair in eng.states for t in pair))
                key = f'{name} {backend}' + (' async' if mode else '')
                res[key] = dict(event_counts=counts, errored=errored,
                                others_equal_clean=equal,
                                calls=len(log), steps=stats['steps'])
                print(f'fault [{key}]: events {counts}, errored streams '
                      f'{errored}, every other stream torch.equal to a clean '
                      f'run: {equal}', flush=True)
                check(ok and equal, f'fault [{key}]')

    with tempfile.TemporaryDirectory() as tmp:
        for backend in ('cuda_seq_fused', 'cuda_seq'):
            faults = ServingFaultConfig(checkpoint_dir=f'{tmp}/{backend}')
            eng, _ = fault_engine(cfg, params, backend, faults)
            sess = [eng.submit(u) for u in utts]
            eng.step()
            eng.step()
            eng.evict(sess[0].sid)
            eng.run()
            second, _ = fault_engine(cfg, params, backend, faults)
            resumed = second.resume_from_checkpoint(utts[0], sess[0].sid)
            cursor = resumed.cursor
            second.run()
            equal = np.array_equal(resumed.full_log_probs(),
                                   clean[backend][0][cursor:])
            res[f'checkpoint {backend}'] = dict(cursor=cursor, equal=equal)
            print(f'fault [checkpoint {backend}]: stream 0 preempted to disk '
                  f'at frame {cursor}, resumed in a second engine: suffix '
                  f'torch.equal to the uninterrupted run: {equal}',
                  flush=True)
            check(cursor == 2 * CHUNK and equal,
                  f'checkpoint resume on {backend}')
        res['checkpoint int8'] = fault_int8_checkpoint(cfg, params, utts,
                                                       tmp, dev)
    res['guard'] = fault_guard(cfg, params, utts)
    return res


def fault_int8_checkpoint(cfg, params, utts, tmp: str, dev):
    """One int8 stream (the first utterance's first two chunks on the
    silicon plans of ``quantize_stack``) through K4 in two chunks, its
    ``(h_q, c_q)`` carries saved and loaded through the stream
    checkpointer between them: both chunks ``torch.equal`` to one launch
    over both, the carries int8 and equal after the round trip."""
    from repro_torch.kernels.lstm_seq import (lstm_stack_seq_kernel_q,
                                              lstm_stack_seq_quantized_auto,
                                              stack_kernel_weights_q)
    from repro_torch.runtime import StreamStateCheckpointer
    qps = quantize_stack(params)
    weights = stack_kernel_weights_q(qps)
    xq, lens = int8_batch(cfg, utts[:1], CHUNK, dev)
    xq = xq[:2 * CHUNK].contiguous()
    lens = np.minimum(lens, 2 * CHUNK)

    def run(lo, hi, state=None):
        vl = torch.from_numpy(np.clip(lens - lo, 0, hi - lo)).to(dev)
        return lstm_stack_seq_quantized_auto(
            qps, xq[lo:hi], state=state, valid_len=vl, return_state=True,
            weights=weights, backend='fused')

    want, _ = run(0, 2 * CHUNK)
    lstm_stack_seq_kernel_q.launches = 0
    head, carry = run(0, CHUNK)
    ckpt = StreamStateCheckpointer(f'{tmp}/int8')
    ckpt.save(0, (tuple(carry),), cursor=CHUNK)
    (restored,), cursor = ckpt.load(
        0, (tuple(torch.zeros_like(t) for t in carry),))
    tail, _ = run(CHUNK, 2 * CHUNK, tuple(restored))
    torch.cuda.synchronize()
    launches = lstm_stack_seq_kernel_q.launches
    kept = all(r.dtype == torch.int8 and torch.equal(r, t)
               for r, t in zip(restored, carry))
    equal = bool(torch.equal(torch.cat([head, tail]), want))
    print(f'fault [checkpoint int8]: K4 carries {tuple(carry[0].shape)} '
          f'int8 through the checkpointer at frame {cursor}: kept '
          f'{kept}; two chunks torch.equal to one launch: {equal}; K4 '
          f'launches {launches}', flush=True)
    check(kept and equal and cursor == CHUNK and launches == 2,
          'int8 carries through the stream checkpointer')
    return dict(cursor=cursor, carries_kept=kept, equal=equal,
                k4_launches=launches)


def fault_guard_case(cfg, params, backend: str, utts, guard: bool,
                     drains: int):
    """``engine_case`` with the guard on (``faults=ServingFaultConfig()``,
    nothing injected) or off (``faults=None``): one warm drain, then
    ``drains`` timed ones; the medians of frames/s and p50 chunk ms."""
    from repro_torch.runtime import ServingFaultConfig
    from repro_torch.serving import StreamingEngine
    rate, p50 = [], []
    for i in range(drains + 1):
        eng = StreamingEngine(cfg.replace(lstm_backend=backend), params,
                              max_streams=SLOTS, chunk=CHUNK,
                              faults=ServingFaultConfig() if guard else None)
        for u in utts:
            eng.submit(u)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if i:
            stats = eng.stats()
            rate.append(stats['frames'] / wall)
            p50.append(stats['p50_chunk_s'] * 1e3)
    return float(np.median(rate)), float(np.median(p50))


def fault_guard(cfg, params, utts):
    """The guard's cost on each kernel backend: the device ops a drain
    issues with ``faults=None`` and with ``ServingFaultConfig()`` (one
    traced drain each, ``trace``) and the difference per chunk; frames/s
    and p50 chunk ms in ``FAULT_PAIRS`` pairs of turns (order alternating,
    ``ENGINE_DRAINS`` drains a turn) with quartiles; and the two drains'
    outputs bit for bit."""
    from repro_torch.runtime import ServingFaultConfig
    res = {}
    for backend in ('cuda_seq_fused', 'cuda_seq'):
        outs, ops = {}, {}
        for guard in (False, True):
            faults = ServingFaultConfig() if guard else None
            outs[guard], _, eng, _ = fault_serve(cfg, params, backend, utts,
                                                 faults)
            steps = eng.stats()['steps']

            def drain():
                fault_serve(cfg, params, backend, utts,
                            ServingFaultConfig() if guard else None)

            ops[guard] = trace(drain, f'{backend} guard '
                               + ('on' if guard else 'off'))
        equal = all(np.array_equal(a, b)
                    for a, b in zip(outs[False], outs[True]))
        turns = {False: [], True: []}
        for i in range(FAULT_PAIRS):
            for guard in ((False, True) if i % 2 == 0 else (True, False)):
                turns[guard].append(fault_guard_case(
                    cfg, params, backend, utts, guard, ENGINE_DRAINS))
        on, off = ops[True]['ops_by_name'], ops[False]['ops_by_name']
        added = {k: on.get(k, 0) - off.get(k, 0) for k in {*on, *off}
                 if on.get(k, 0) != off.get(k, 0)}
        r = dict(steps=steps, device_ops_off=ops[False]['device_ops'],
                 device_ops_on=ops[True]['device_ops'],
                 ops_per_chunk=(ops[True]['device_ops']
                                - ops[False]['device_ops']) / steps,
                 ops_added_by_name=added, bits_equal=equal,
                 pairs=FAULT_PAIRS)
        for name, guard in (('off', False), ('on', True)):
            rate = [t[0] for t in turns[guard]]
            p50 = [t[1] for t in turns[guard]]
            r[name] = dict(
                frames_per_s=float(np.median(rate)),
                frames_per_s_quartiles=[float(q) for q in
                                        np.percentile(rate, [25, 75])],
                p50_chunk_ms=float(np.median(p50)),
                p50_chunk_ms_quartiles=[float(q) for q in
                                        np.percentile(p50, [25, 75])],
                turns_frames_per_s=rate)
        r['on_wins'] = sum(a > b for a, b in zip(
            r['on']['turns_frames_per_s'], r['off']['turns_frames_per_s']))
        res[backend] = r
        print(f'fault guard [{backend}]: {r["device_ops_off"]} device ops '
              f'a drain without the fault runtime, {r["device_ops_on"]} with '
              f'the guard on: {r["ops_per_chunk"]:.2f} a chunk over {steps} '
              f'chunks ({added}); bits equal {equal}; ' + '; '.join(
                  f'{name} {r[name]["frames_per_s"]:.1f} frames/s '
                  f'(quartiles {r[name]["frames_per_s_quartiles"][0]:.1f}-'
                  f'{r[name]["frames_per_s_quartiles"][1]:.1f}), p50 chunk '
                  f'{r[name]["p50_chunk_ms"]:.3f} ms'
                  for name in ('off', 'on'))
              + f'; guard on served more frames/s in {r["on_wins"]} of '
                f'{FAULT_PAIRS} pairs', flush=True)
        check(equal, f'guard on changed the bits on {backend}')
    return res


def gates_case(kernel: str, lp, B: int, g, dev):
    """One K5 (``kernel`` 'lstm_gates_rec': layer ``lp``'s W_h, ``pre``) or
    K6 ('lstm_gates': the packed [W_x | W_h] and [x; h]) case at B streams,
    inputs from ``g`` (x 0.5): max abs error against its plain version, the
    kernel's ms, its plain version's, the product alone (``torch.addmm`` /
    ``torch.mm``), the bound and the geometry of the timed launch (where
    the wrapper records it); for K5 also the ms per launch of a
    ``GATES_T``-step ``_step_forward`` chain (the ``cuda_step`` layer, its
    two stacks included) and of the same chain of public-op launches
    (``chain_no_early_ms``: no launch stages anything before the one ahead
    has finished).  Only calls that the parent tree has too, so ``--ab``
    runs it on either.  Returns (case, inputs)."""
    from repro_torch.kernels import lstm_gates as kg
    from repro_torch.kernels.lstm_gates.ops import _step_forward
    r = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.5
    N = lp.n_h
    if kernel == 'lstm_gates_rec':
        K, fn, ref = N, kg.lstm_gates_rec, kg.lstm_gates_rec_ref
        h, pre, c = r(B, N), r(B, 4, N), r(B, N)
        args = (h, lp.w_h, pre, lp.w_peep, lp.b, c)
        w_rows, pre_rows = lp.w_h.reshape(4 * N, N), pre.reshape(B, 4 * N)
        product = lambda: torch.addmm(pre_rows, h, w_rows.T)
        inputs = args
        # inputs h, W_h, pre, peep, bias, c once; outputs h, c once
        nbytes = 4 * (4 * N * N + 7 * N + B * N + 4 * B * N + B * N
                      + 2 * B * N)
    else:
        K, fn, ref = lp.n_x + N, kg.lstm_gates, kg.lstm_gates_ref
        x, h, c = r(B, lp.n_x), r(B, N), r(B, N)
        xh = torch.cat([x, h], dim=-1)
        w = torch.cat([lp.w_x, lp.w_h], dim=-1)
        args = (xh, w, lp.w_peep, lp.b, c)
        w_rows = w.reshape(4 * N, K)
        product = lambda: torch.mm(xh, w_rows.T)
        inputs = (lp, x, h, c)
        # inputs xh, W, peep, bias, c once; outputs h, c once
        nbytes = 4 * (B * K + 4 * N * K + 7 * N + B * N + 2 * B * N)
    err = max(float((a - b).abs().max()) for a, b in zip(fn(*args),
                                                         ref(*args)))
    case = dict(
        kernel=kernel, shape=f'B={B} N_in={K} N_h={N}', max_abs_err=err,
        tol=KERNEL_ATOL, ok=err <= KERNEL_ATOL,
        ms=cuda_ms(lambda: fn(*args), 200))
    launched = getattr(fn, 'last_launch', None)
    if launched is not None:
        case['geometry'] = dict(dataclasses.asdict(launched[0]),
                                early=launched[1])
    case.update(plain_ms=cuda_ms(lambda: ref(*args), 50), library_ms=None,
                product_only_ms=cuda_ms(product, 200), bytes=nbytes,
                flops=8 * B * N * K + 30 * B * N)
    if kernel == 'lstm_gates_rec':
        pre_x = r(GATES_T, B, 4, N)

        def no_early_chain():
            hh, cc, hs, cs = h, c, [], []
            for pre_t in pre_x:
                hh, cc = fn(hh, lp.w_h, pre_t, lp.w_peep, lp.b, cc)
                hs.append(hh)
                cs.append(cc)
            return torch.stack(hs), torch.stack(cs)
        case['chain_ms'] = cuda_ms(lambda: _step_forward(
            lp.w_h, lp.w_peep, lp.b, pre_x, h, c), 20) / GATES_T
        case['chain_no_early_ms'] = cuda_ms(no_early_chain, 20) / GATES_T
    case['bound_ms'], case['bound_by'] = bound(nbytes, case['flops'])
    return case, inputs


def _print_gates_case(case, lib: str) -> None:
    chain = (f", {case['chain_ms']:.5f} ms a launch in a {GATES_T}-step "
             f"chain ({case['chain_no_early_ms']:.5f} ms with no early "
             f"staging)" if 'chain_ms' in case else '')
    print(f"{case['kernel']}: {case['shape']}: max_abs_err "
          f"{case['max_abs_err']:.3e} (tol {KERNEL_ATOL}), kernel "
          f"{case['ms']:.5f} ms{chain}, plain {case['plain_ms']:.4f} ms, "
          f"bound {case['bound_ms']:.6f} ms ({case['bound_by']}; "
          f"{case['bytes'] / 1e6:.3f} MB), library none (product only, "
          f"{lib}: {case['product_only_ms']:.5f} ms); geometry of the "
          f"timed launch {case['geometry']}", flush=True)


def gates_kernel_checks(cfg, params, B: int, T: int, rng, dev):
    """K5 against its plain version at the training shape (``gates_case``:
    B streams, an inner layer's weights), with the geometry its timed
    launch used; then
    ``cuda_step`` against ``cuda_seq`` over ``T`` steps."""
    from repro_torch.core.lstm import lstm_layer_fused
    lp = params.layers[1]
    g = torch.Generator(device=dev).manual_seed(SEED)
    row, _ = gates_case('lstm_gates_rec', lp, B, g, dev)
    row.update(name='lstm_gates_rec', route='cuda',
               source='src/repro_torch/csrc/lstm_gates_rec.cu',
               replaces='src/repro/kernels/lstm_gates/kernel.py:79')
    _print_gates_case(row, 'torch.addmm')
    check(row['ok'], 'lstm_gates_rec disagrees with its plain version')

    f32 = lambda *s: torch.from_numpy(
        (rng.randn(*s) * 0.5).astype(np.float32)).to(dev)
    xs, h0, c0 = f32(T, B, lp.n_x), f32(B, lp.n_h), f32(B, lp.n_h)
    step, seq = (lstm_layer_fused(lp, xs, h0, c0, backend=b)
                 for b in ('cuda_step', 'cuda_seq'))
    err = max(float((a - b).abs().max()) for a, b in
              ((step[0], seq[0]), (step[1][0], seq[1][0]),
               (step[1][1], seq[1][1])))
    print(f'lstm_layer_fused cuda_step vs cuda_seq: T={T} B={B}: max abs '
          f'diff {err:.3e} (tol {KERNEL_ATOL})', flush=True)
    check(err <= KERNEL_ATOL, 'cuda_step and cuda_seq layers disagree')
    return row


def _train_batch(cfg, T: int, B: int, step: int, dev):
    """``SyntheticCTC``'s batch ``step`` at (T, B), on ``dev``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticCTC
    host = SyntheticCTC(cfg, ShapeConfig('smoke', 'train', T, B)).host_batch(
        step, 0, B)
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def grad_checks(cfg, dev):
    """Every leaf's gradient of ``loss_fn`` on each kernel backend against
    the ``torch_scan`` Function's, by relative Frobenius error."""
    from repro_torch.launch.train import _grads_of, init_train_state
    from repro_torch.models import chipmunk_net
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.tree import flatten_with_paths
    params = init_train_state(cfg, adamw(cosine_schedule(1e-3, 1, 2)),
                              dev, seed=SEED)['params']
    batch = _train_batch(cfg, GRAD_T, TRAIN_BATCH, 0, dev)
    grads = {}
    for b in ('torch_scan',) + TRAIN_BACKENDS:
        loss_fn = lambda p, x, c=cfg.replace(lstm_backend=b): \
            chipmunk_net.loss_fn(c, p, x)
        grads[b] = flatten_with_paths(_grads_of(loss_fn, params, batch)[1])
    worst = {}
    for b in TRAIN_BACKENDS:
        rel = [float(torch.linalg.vector_norm(g - r)
                     / torch.linalg.vector_norm(r))
               for (_, g), (_, r) in zip(grads[b], grads['torch_scan'])]
        finite = all(bool(torch.isfinite(g).all()) for _, g in grads[b])
        worst[b] = max(rel)
        print(f'grads [{b}] vs torch_scan: T={GRAD_T} B={TRAIN_BATCH}, '
              f'{len(rel)} leaves: max relative Frobenius error '
              f'{worst[b]:.3e} (tol {GRAD_REL_TOL}), finite {finite}',
              flush=True)
        check(finite and worst[b] <= GRAD_REL_TOL,
              f'{b} gradients disagree with torch_scan')
    return worst


def train_runs(cfg, dev, profile: bool = False):
    """``TRAIN_STEPS`` train steps at (``TRAIN_SEQ``, ``TRAIN_BATCH``) on
    each kernel backend from the same weights and batches, with per-step
    launch counts and host-clock step times; the checkpoint round trip on
    ``cuda_step``; (with ``profile``) one traced step per backend."""
    import functools
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.lstm_gates import lstm_gates_rec
    from repro_torch.kernels.lstm_seq import lstm_seq, lstm_stack_seq_kernel
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import chipmunk_net
    from repro_torch.optim import cosine_schedule, make_optimizer
    counters = (lstm_gates_rec, lstm_seq, lstm_stack_seq_kernel)
    L, T, B = cfg.n_layers, TRAIN_SEQ, TRAIN_BATCH
    want = dict(cuda_step=dict(lstm_gates_rec=T * L, lstm_seq=0,
                               lstm_stack_seq_kernel=0),
                cuda_seq=dict(lstm_gates_rec=0, lstm_seq=L,
                              lstm_stack_seq_kernel=0),
                cuda_seq_fused=dict(lstm_gates_rec=0, lstm_seq=0,
                                    lstm_stack_seq_kernel=1))
    batches = [_train_batch(cfg, T, B, k, dev) for k in range(TRAIN_STEPS)]
    runs, profiles = {}, []
    for backend in TRAIN_BACKENDS:
        c = cfg.replace(lstm_backend=backend)
        opt = make_optimizer(c.optimizer, cosine_schedule(1e-3, 10,
                                                          TRAIN_STEPS))
        step_fn = make_train_step(functools.partial(chipmunk_net.loss_fn, c),
                                  opt)
        state = init_train_state(c, opt, dev, seed=SEED)
        losses, walls, launches, ckpt = [], [], [], None
        tmp = tempfile.TemporaryDirectory()
        mgr = CheckpointManager(tmp.name)
        for k, batch in enumerate(batches):
            if k == TRAIN_CKPT_STEP:
                mgr.save(k, state, blocking=True)
            torch.cuda.synchronize()
            for f in counters:
                f.launches = 0
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append({f.__name__: f.launches for f in counters})
            losses.append(m['loss'])
        check(all(n == want[backend] for n in launches),
              f'{backend}: launches per train step {launches[-1]}, '
              f'expected {want[backend]}')
        check(all(bool(torch.isfinite(x)) for x in losses),
              f'{backend}: a loss is not finite')
        if backend == TRAIN_BACKENDS[0]:
            fresh = init_train_state(c, opt, dev, seed=SEED + 1)
            restored = mgr.restore(fresh)
            _, m = step_fn(restored, batches[TRAIN_CKPT_STEP])
            ckpt = bool(torch.equal(m['loss'], losses[TRAIN_CKPT_STEP]))
            print(f'train [{backend}]: restored step {TRAIN_CKPT_STEP} '
                  f'into a fresh state; next loss {float(m["loss"])!r} vs '
                  f'uninterrupted {float(losses[TRAIN_CKPT_STEP])!r}: '
                  f'bit-equal {ckpt}', flush=True)
            check(ckpt, 'resumed loss differs from the uninterrupted run')
        tmp.cleanup()
        if profile:
            profiles.append(trace(lambda: step_fn(state, batches[-1]),
                                  f'train {backend}'))
        step_ms = float(np.median(walls[1:])) * 1e3
        runs[backend] = dict(
            losses=[float(x) for x in losses], step_ms=step_ms,
            step_ms_all=[w * 1e3 for w in walls],
            frames_per_s=B * T / step_ms * 1e3, launches=launches[-1],
            checkpoint_bit_equal=ckpt)
        print(f'train [{backend}]: {TRAIN_STEPS} steps of B={B} T={T}: '
              f'losses {[round(x, 4) for x in runs[backend]["losses"]]}, '
              f'median step {step_ms:.3f} ms after the first '
              f'({B * T / step_ms * 1e3:.1f} frames/s), launches per step '
              f'{launches[-1]}', flush=True)
    ref = np.array(runs[TRAIN_BACKENDS[0]]['losses'])
    for backend in TRAIN_BACKENDS[1:]:
        got = np.array(runs[backend]['losses'])
        diff = float(np.max(np.abs(got - ref) / np.abs(ref)))
        runs[backend]['max_rel_loss_diff'] = diff
        print(f'train loss histories {backend} vs {TRAIN_BACKENDS[0]}: max '
              f'relative difference {diff:.3e} (rtol {LOSS_RTOL})',
              flush=True)
        check(diff <= LOSS_RTOL, f'{backend} loss history disagrees')
    return runs, profiles


def train_cli(cfg):
    """The trainer's entry point on the card, as a user runs it:
    ``launch.train.main`` on ``cuda_step`` for ``TRAIN_STEPS`` steps at its
    default batch and sequence with a checkpoint every ``TRAIN_CKPT_STEP``
    steps, then again with ``--resume`` for ``TRAIN_RESUME_STEPS`` more.
    Checks the printed losses are finite, the resume line, the final
    checkpoint's step, and K5's launches per step on both runs."""
    import contextlib
    import io
    import re
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.lstm_gates import lstm_gates_rec
    from repro_torch.launch import train
    per_step = TRAIN_SEQ * cfg.n_layers
    end = TRAIN_STEPS + TRAIN_RESUME_STEPS
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, steps, extra in (('fresh', TRAIN_STEPS, []),
                                   ('resume', end, ['--resume'])):
            argv = ['--lstm-backend', 'cuda_step', '--steps', str(steps),
                    '--ckpt-every', str(TRAIN_CKPT_STEP), '--ckpt-dir', tmp,
                    '--log-every', '1'] + extra
            out = io.StringIO()
            lstm_gates_rec.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = lstm_gates_rec.launches
            text = out.getvalue()
            losses = [float(x) for x in re.findall(r' loss +(\S+)', text)]
            ran = steps - (TRAIN_STEPS if extra else 0)
            res[name] = dict(argv=argv, wall_s=wall, losses=losses,
                             lstm_gates_rec=launches)
            print(f'train CLI [{name}]: {ran} steps in {wall:.2f} s, '
                  f'losses {losses}, K5 launches {launches}', flush=True)
            check('done' in text, f'train CLI [{name}] did not finish')
            check(len(losses) == ran and all(np.isfinite(losses)),
                  f'train CLI [{name}]: losses {losses}')
            check(launches == ran * per_step,
                  f'train CLI [{name}]: {launches} K5 launches, expected '
                  f'{ran * per_step}')
        check(f'resumed at step {TRAIN_STEPS}' in text,
              'train CLI did not resume from its checkpoint')
        check(CheckpointManager(tmp).latest_step() == end,
              'train CLI did not checkpoint its last step')
        beat = json.loads(pathlib.Path(tmp, 'heartbeat.json').read_text())
        res['heartbeat'] = beat
        print(f'train CLI: heartbeat {beat}', flush=True)
        check(beat['step'] == end - 1, 'train CLI heartbeat is not at its '
              'last step')
    return res


def fault_train(cfg, dev):
    """One train step under ``FaultTolerantRunner.run_step`` on
    ``cuda_seq_fused`` at (``TRAIN_SEQ``, ``TRAIN_BATCH``): a fault
    injected at step 1 restores the step-1 checkpoint (``restore_fn``) and
    recomputes the step; its loss, gradient norm and every state leaf
    against the uninterrupted step's, bit for bit, else by relative
    Frobenius error (``GRAD_REL_TOL``)."""
    import functools
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.lstm_seq import lstm_stack_seq_kernel
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import chipmunk_net
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.runtime import FaultConfig, FaultTolerantRunner
    from repro_torch.tree import leaves
    c = cfg.replace(lstm_backend='cuda_seq_fused')
    opt = make_optimizer(c.optimizer, cosine_schedule(1e-3, 10, TRAIN_STEPS))
    step_fn = make_train_step(functools.partial(chipmunk_net.loss_fn, c), opt)
    state = init_train_state(c, opt, dev, seed=SEED)
    batches = [_train_batch(c, TRAIN_SEQ, TRAIN_BATCH, k, dev)
               for k in range(2)]
    state, _ = step_fn(state, batches[0])
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(1, state, blocking=True)
        want_state, want = step_fn(state, batches[1])
        runner = FaultTolerantRunner(
            step_fn, ckpt_manager=mgr,
            cfg=FaultConfig(backoff_s=0.0,
                            heartbeat_path=f'{tmp}/heartbeat.json'),
            restore_fn=lambda: mgr.restore(state),
            fail_schedule=lambda step: step == 1)
        torch.cuda.synchronize()
        lstm_stack_seq_kernel.launches = 0
        got_state, got = runner.run_step(1, state, batches[1])
        torch.cuda.synchronize()
        launches = lstm_stack_seq_kernel.launches
        beat = json.loads(pathlib.Path(tmp, 'heartbeat.json').read_text())
    pairs = list(zip(leaves(got_state), leaves(want_state)))
    pairs += [(got['loss'], want['loss']), (got['grad_norm'],
                                             want['grad_norm'])]
    bit_equal = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                    for a, b in pairs)
    rel = max(float(torch.linalg.norm((torch.as_tensor(a) - torch.as_tensor(
        b)).double()) / max(float(torch.linalg.norm(
            torch.as_tensor(b).double())), 1e-30)) for a, b in pairs)
    kinds = [e['kind'] for e in runner.events]
    print(f'fault train [cuda_seq_fused]: run_step with a fault injected at '
          f'step 1: events {kinds}, K2 launches {launches}, heartbeat step '
          f'{beat["step"]}; restored step bit-equal to the uninterrupted '
          f'one: {bit_equal} (largest relative Frobenius error {rel:.3e})',
          flush=True)
    check(kinds == ['fault', 'restore'] and launches == 1
          and beat['step'] == 1, 'train run_step under the runner')
    check(bit_equal or rel <= GRAD_REL_TOL,
          'restored train step disagrees with the uninterrupted one')
    return dict(events=kinds, k2_launches=launches, bit_equal=bit_equal,
                max_rel_err=rel, heartbeat_step=beat['step'])


def _run_cli(label: str, args, cwd: str) -> str:
    """``python -m <args>`` as a subprocess with this checkout's ``src`` on
    its path, from ``cwd``, within ``SUBPROCESS_TIMEOUT_S`` (killed past
    it): fails unless it exits 0; prints its last lines, returns its
    standard output."""
    import os
    env = dict(os.environ, PYTHONPATH=str(
        pathlib.Path(__file__).resolve().parent / 'src'))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', *args], cwd=cwd, env=env,
                          capture_output=True, text=True,
                          timeout=SUBPROCESS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-6:]
    print(f'{label}: `python -m {" ".join(args)}` exit {proc.returncode} in '
          f'{wall:.1f} s', flush=True)
    for line in tail:
        print(f'  | {line}', flush=True)
    check(proc.returncode == 0, f'{label} failed:\n{proc.stdout[-2000:]}'
                                f'\n{proc.stderr[-4000:]}')
    return proc.stdout


def _kernel_launches(run):
    """``run()`` with the K1-K4 launch counters set to 0 just before and
    read just after: (its result, the counts)."""
    from repro_torch.kernels.lstm_seq import (lstm_seq, lstm_seq_quantized,
                                              lstm_stack_seq_kernel,
                                              lstm_stack_seq_kernel_q)
    kernels = (lstm_seq, lstm_stack_seq_kernel, lstm_seq_quantized,
               lstm_stack_seq_kernel_q)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kernels}


def tune_phase(cfg, params, qps, q_utts, dev):
    """Measured dispatch on the card (``repro_torch.tune``) at the serving
    shape (``CHUNK``, ``SLOTS``) of the full-width model: ``TUNE_TRIALS``
    K4 against K3-chain trials at tile 96 (``tune_quantized_backend``, the
    candidates ``torch.equal`` before timing), one more past K4's single
    launch (B = 97, ``quantized_trial``, no prune), ``TUNE_TRIALS // 2``
    serving-loop depth trials (``tune_serving_config``: its own int8
    trial, then depths 4/8/16 with the streams' log-probs ``torch.equal``
    across depths), each with ``TUNE_ITERS`` interleaved turns; the cache
    (the last trials' entries) saved, loaded back to the same JSON and
    replayed; then, with the loaded cache installed, the int8
    deploy's ``auto`` (over ``q_utts``) launches the kernel its entry names
    (so does a cache naming each backend in turn), with codes equal to the
    cold-cache run's, and a ``deadline_policy`` server's ceiling is the
    tuned depth, with its streams bit-equal to a fixed-chunk server's;
    last, the tune CLI (``--measure``: its int8 and layer-block entries
    measured) and the serve CLI (``--tune --schedule-cache``) as
    subprocesses."""
    import tempfile
    from repro_torch.core.systolic import N_LSTM_SILICON
    from repro_torch.kernels.lstm_seq import (lstm_stack_seq_kernel,
                                              stack_kernel_weights_q)
    from repro_torch.launch.serve import StreamServer, deadline_policy
    from repro_torch.tune import (ScheduleCache, ScheduleEntry,
                                  quantized_trial, replay_check,
                                  serving_depths, tune_quantized_backend,
                                  tune_serving_config, using_schedule_cache)
    n_x, n_h, L = cfg.lstm_inputs, cfg.lstm_hidden, cfg.n_layers
    card = torch.cuda.get_device_name(dev)
    res = dict(card=card, shape=dict(n_x=n_x, n_h=n_h, n_layers=L, T=CHUNK,
                                     B=SLOTS, tile=N_LSTM_SILICON),
               iters=TUNE_ITERS)

    def medians(records):
        return {(r.params.get('backend') if r.suite == 'q_stack_backend'
                 else f"tc={r.params['tc']}"): r.metrics['measured_us']
                for r in records}

    cache = ScheduleCache()
    res['q_trials'] = []
    for _ in range(TUNE_TRIALS):
        q_ent, q_recs = tune_quantized_backend(
            n_x, n_h, L, CHUNK, SLOTS, tile=N_LSTM_SILICON, cache=cache,
            iters=TUNE_ITERS, device=dev)
        res['q_trials'].append(dict(backend=q_ent.backend,
                                    medians_us=medians(q_recs)))
        print(f'tune: K4 vs K3 chain at T={CHUNK} B={SLOTS} '
              f'{n_x}->{L}x{n_h} tile {N_LSTM_SILICON} ({card}; '
              f'torch.equal before timing; medians of {TUNE_ITERS} '
              f'interleaved turns, us): {medians(q_recs)} -> '
              f'{q_ent.backend}', flush=True)
        check(q_ent.source == 'measured' and len(q_recs) == 2,
              'tune: the int8 trial did not measure both candidates')
    # past K4's single launch (96 streams): fused in two batch blocks
    # against the K3 chain (one launch a layer up to 120), no prune
    B_past = F4_BATCH['lstm_stack_seq_kernel_q']
    us_lw, us_fu = quantized_trial(n_x, n_h, L, CHUNK, B_past,
                                   N_LSTM_SILICON, iters=TUNE_ITERS,
                                   device=dev)
    res['q_past_single_launch'] = dict(B=B_past, layerwise_us=us_lw,
                                       fused_us=us_fu)
    print(f'tune: K4 in blocks vs K3 chain at B={B_past} (medians, us): '
          f'layerwise {us_lw:.1f}, fused {us_fu:.1f}', flush=True)
    res['serving_trials'] = []
    for _ in range(max(1, TUNE_TRIALS // 2)):
        entries, recs = tune_serving_config(cfg, chunk=CHUNK, slots=SLOTS,
                                            cache=cache, iters=TUNE_ITERS,
                                            params=params, device=dev)
        q2, _, sc = entries     # the int8, predicted staged, serving
        trial = dict(
            q_backend=q2.backend, q_medians_us=medians(
                [r for r in recs if r.suite == 'q_stack_backend']),
            tc=sc.tc, f32_backend=recs[-1].params['backend'],
            depth_medians_us=medians([r for r in recs
                                      if r.suite == 'serving_chunk']))
        res['serving_trials'].append(trial)
        print(f'tune: serving config (depths bit-equal before timing): int8 '
              f'{trial["q_medians_us"]} -> {q2.backend}; serving loop '
              f'[{trial["f32_backend"]}] {trial["depth_medians_us"]} -> '
              f'Tc={sc.tc}', flush=True)
        check([r.params['tc'] for r in recs if r.suite == 'serving_chunk']
              == list(serving_depths(CHUNK)) and sc.source == 'measured',
              f'tune: the serving trial did not time depths '
              f'{serving_depths(CHUNK)}')

    with tempfile.TemporaryDirectory() as tmp:
        loaded = ScheduleCache.load(cache.save(pathlib.Path(tmp)
                                               / 'sched.json'))
        same = loaded.to_json() == cache.to_json()
        checked, unchecked = replay_check(loaded, device=dev,
                                          tile=N_LSTM_SILICON)
        res['cache'] = dict(entries=[dataclasses.asdict(e)
                                     for e in loaded.entries()],
                            json_identical=same, replay_checked=checked)
        print(f'tune: save -> load gives the same JSON: {same}; replay check '
              f'{checked} of {len(loaded)} entries, {len(unchecked)} '
              f'unchecked', flush=True)
        # the predicted staged entry is for any mesh: reported, unchecked
        check(same and checked == 2 and len(loaded) == 3
              and [(e.kind, e.mesh) for e in unchecked] == [('stack_f32',
                                                              'any')],
              'tune: the cache did not round-trip or replay')

        xq, lens = int8_batch(cfg, q_utts, CHUNK, dev)
        n_chunks = xq.shape[0] // CHUNK
        weights = stack_kernel_weights_q(qps)
        deploy = lambda: int8_chunks(qps, xq, lens, CHUNK, weights,
                                     'auto')[0]
        cold, cold_launches = _kernel_launches(deploy)
        f32 = dict(lstm_seq=0, lstm_stack_seq_kernel=0)
        want = {'fused': dict(f32, lstm_seq_quantized=0,
                              lstm_stack_seq_kernel_q=n_chunks),
                'layerwise': dict(f32, lstm_seq_quantized=L * n_chunks,
                                  lstm_stack_seq_kernel_q=0)}
        key = dict(kind='q_stack_backend', n_x=n_x, n_h=n_h, n_layers=L,
                   T=CHUNK, B=len(q_utts), source='measured')
        deploys = {}
        for label, c in (('measured', loaded),
                         *((f'forced {b}', ScheduleCache([ScheduleEntry(
                             backend=b, **key)])) for b in want)):
            named = c.lookup('q_stack_backend', n_x=n_x, n_h=n_h,
                             n_layers=L, T=CHUNK, B=len(q_utts)).backend
            with using_schedule_cache(c):
                codes, launches = _kernel_launches(deploy)
            deploys[label] = dict(backend=named, launches=launches,
                                  equal=torch.equal(codes, cold))
            print(f'tune: int8 deploy on auto under the {label} cache '
                  f'({named}): launches {launches}, codes == cold cache '
                  f'run: {deploys[label]["equal"]}', flush=True)
            check(launches == want[named] and deploys[label]['equal'],
                  f'tune: the int8 deploy under the {label} cache did not '
                  f'launch {named} alone, or changed its codes')
        res['int8_deploy'] = dict(cold_launches=cold_launches, **deploys)

        def serve(policy):
            server = StreamServer(cfg, params, num_slots=SLOTS, chunk=CHUNK,
                                  chunk_policy=policy)
            for u in q_utts:
                server.submit(u)
            lstm_stack_seq_kernel.launches = 0
            done = sorted(server.drain(), key=lambda s: s.sid)
            torch.cuda.synchronize()
            return server, done, lstm_stack_seq_kernel.launches

        with using_schedule_cache(loaded):
            policy = deadline_policy(cfg, CHUNK, SLOTS, TUNE_SLO)
            server, done, k2 = serve(policy)
        _, fixed, _ = serve(None)
        bits = len(done) == len(fixed) and all(
            np.array_equal(a.full_log_probs(), b.full_log_probs())
            for a, b in zip(done, fixed))
        stats = server.engine.stats()
        res['deadline_server'] = dict(
            chunk_max=policy.chunk_max, tuned_tc=sc.tc, steps=stats['steps'],
            chunk_len=stats['chunk_len'],
            deadline_misses=stats['deadline_misses'], k2_launches=k2,
            bit_equal_to_fixed=bits)
        print(f'tune: deadline_slo server under the cache: chunk_max '
              f'{policy.chunk_max} (tuned Tc {sc.tc}), {stats["steps"]} '
              f'steps, {k2} K2 launches, misses {stats["deadline_misses"]}; '
              f'streams bit-equal to a fixed-chunk server: {bits}',
              flush=True)
        check(policy.chunk_max == min(CHUNK, sc.tc)
              and server.engine._policy is policy and bits
              and k2 == stats['steps'],
              'tune: the deadline server did not take the tuned ceiling')

        out = _run_cli('tune CLI', [
            'repro_torch.tune', '--measure', '--n-x', str(n_x), '--n-h',
            str(n_h), '--layers', str(L), '--T', str(CHUNK), '--B',
            str(SLOTS), '--tile', str(N_LSTM_SILICON), '--out',
            f'{tmp}/cli.json', '--csv', f'{tmp}/cli.csv'], tmp)
        cli = [e for e in ScheduleCache.load(f'{tmp}/cli.json').entries()
               if e.kind == 'q_stack_backend']
        lb_cli = [e for e in ScheduleCache.load(f'{tmp}/cli.json').entries()
                  if e.kind == 'stack_lb']
        check(len(cli) == 1 and cli[0].source == 'measured'
              and 'q_stack_backend -> ' in out and len(lb_cli) == 1
              and lb_cli[0].source == 'measured'
              and f'stack_lb -> lb={lb_cli[0].lb} (measured' in out,
              'tune CLI wrote no entry')
        out = _run_cli('serve CLI --tune', [
            'repro_torch.launch.serve', '--tune', '--schedule-cache',
            f'{tmp}/serve.json', '--slots', str(SLOTS), '--chunk',
            str(CHUNK), '--requests', str(SLOTS), '--deadline-slo',
            str(TUNE_SLO)], tmp)
        saved = ScheduleCache.load(f'{tmp}/serve.json')
        sc_cli = saved.lookup('serving_chunk', n_x=n_x, n_h=n_h,
                              n_layers=L, T=CHUNK, B=SLOTS)
        check(sc_cli is not None and sc_cli.source == 'measured'
              and f'chunk_max={sc_cli.tc} ' in out,
              'serve CLI --tune did not save or apply its ceiling')
        res['cli'] = dict(tune=dataclasses.asdict(cli[0]),
                          serve=[dataclasses.asdict(e)
                                 for e in saved.entries()])
    return res


def _lb_runs(wts, lbs, args, n_layers, N, B, sms):
    """K2 at each ``lb`` of ``lbs`` on ``args`` (pre_x, h0, c0, mask), the
    launch counter set to 0 just before each call and read just after:
    lb -> (hs, cs), lb -> launches, lb -> the launches it should take,
    (L / lb) x its batch blocks."""
    from repro_torch.kernels.lstm_seq import (lstm_stack_seq_kernel,
                                              stack_geometry)
    from repro_torch.kernels.lstm_seq.kernel import (batch_blocks,
                                                     largest_batch)
    pre_x, h0, c0, mask = args
    outs, launches, want = {}, {}, {}
    for lb in lbs:
        block = largest_batch(
            lambda b: stack_geometry(N, n_layers, b, sms, lb=lb), B, sms)
        want[lb] = n_layers // lb * len(batch_blocks(B, block))
        torch.cuda.synchronize()
        lstm_stack_seq_kernel.launches = 0
        outs[lb] = lstm_stack_seq_kernel(pre_x, wts.w_in, wts.w_h, wts.peep,
                                         wts.b, h0, c0, mask, lb=lb)
        torch.cuda.synchronize()
        launches[lb] = lstm_stack_seq_kernel.launches
    return outs, launches, want


def _lb_case(label, wts, lbs, args, n_layers, N, sms, same_as, time_it):
    """One (T, B, mask) case of ``stack_lb_phase``: every ``lb`` of
    ``lbs`` ``torch.equal`` to ``lb = same_as``, the largest error against
    the plain version, the launches against (L / lb) x blocks, and with
    ``time_it`` each ``lb``'s ms (``cuda_ms``) beside its bound
    (``stack_launch_costs``: every launch's bytes and products)."""
    from repro_torch.kernels.lstm_seq import (lstm_stack_seq_kernel,
                                              lstm_stack_seq_ref)
    from repro_torch.kernels.lstm_seq.stack_kernel import stack_launch_costs
    pre_x, h0, c0, mask = args
    T, B = pre_x.shape[0], pre_x.shape[1]
    outs, launches, want = _lb_runs(wts, lbs, args, n_layers, N, B, sms)
    plain_mask = (mask if mask is not None else
                  torch.ones((T, B), dtype=torch.bool, device=pre_x.device))
    ref = lstm_stack_seq_ref(pre_x, wts.w_in, wts.w_h, wts.peep, wts.b, h0,
                             c0, plain_mask)
    equal = all(torch.equal(outs[lb][i], outs[same_as][i])
                for lb in lbs for i in (0, 1))
    err = max(float((outs[lb][i] - ref[i]).abs().max())
              for lb in lbs for i in (0, 1))
    case = dict(label=label, T=T, B=B, n_layers=n_layers,
                masked=mask is not None, lbs=list(lbs), equal=equal,
                max_abs_err=err, launches=launches, want_launches=want)
    if time_it:
        case['ms'], case['bound_ms'] = {}, {}
        for lb in lbs:
            case['ms'][lb] = cuda_ms(lambda lb=lb: lstm_stack_seq_kernel(
                pre_x, wts.w_in, wts.w_h, wts.peep, wts.b, h0, c0, mask,
                lb=lb), LB_REPS)
            costs = stack_launch_costs(T, B, N, n_layers, lb)
            case['bound_ms'][lb] = bound(sum(b for _, b in costs),
                                         sum(f for f, _ in costs))[0]
    print(f"stack_lb: {label} T={T} B={B} "
          f"{'masked' if mask is not None else 'unmasked'}: lb {list(lbs)} "
          f"torch.equal to lb={same_as}: {equal}, max_abs_err {err:.3e} "
          f"(tol {KERNEL_ATOL}), launches {launches} (want {want})"
          + (f", ms {case['ms']}, bound ms {case['bound_ms']}"
             if time_it else ''), flush=True)
    check(equal and err <= KERNEL_ATOL and launches == want,
          f'stack_lb: K2 at {label} T={T} B={B} disagrees across lb or with '
          f'its plain version, or launched other than (L / lb) x blocks')
    return case


def stack_lb_phase(cfg, params, utts, card, dev):
    """K2's layer block ``lb`` on the card (11m of the module docstring):
    the main stack at every candidate ``lb`` and ``LB_SHAPES``, a stack of
    ``LB_DEEP`` layers that K2 refuses whole, the gradients at ``lb`` 1
    and 3, ``tune_stack_lb`` measured at ``LB_TRIAL_B``, and the f32
    engine's drain under its entry and under one naming ``lb = 1``."""
    from repro_torch.core.lstm import (LSTMParams, LSTMStackParams,
                                       hoisted_input, init_lstm_stack,
                                       stack_params_to, valid_len_mask)
    from repro_torch.kernels.lstm_seq import (lstm_stack_seq,
                                              lstm_stack_seq_kernel,
                                              stack_kernel_weights)
    from repro_torch.tune import (ScheduleCache, ScheduleEntry,
                                  enumerate_lb_candidates, tune_stack_lb,
                                  using_schedule_cache)
    N, L, NX = cfg.lstm_hidden, cfg.n_layers, cfg.lstm_inputs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    r = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.5

    def inputs(n_layers, T, B):
        lens = torch.randint(1, T, (B,), generator=g, device=dev)
        lens[0], lens[1] = T, 0
        return (hoisted_input(params.layers[0].w_x, r(T, B, NX)),
                r(n_layers, B, N), r(n_layers, B, N),
                valid_len_mask(T, lens, B))

    lbs = enumerate_lb_candidates(NX, N, L, SLOTS, device=dev)
    check(lbs == [1, L], f'stack_lb: candidates {lbs} at {NX} -> {L}x{N}, '
                         f'expected [1, {L}]')
    res = dict(card=card, candidates=lbs, cases=[])
    wts = stack_kernel_weights(params)
    for T, B in LB_SHAPES:
        pre_x, h0, c0, mask = inputs(L, T, B)
        for m in (mask, None):
            res['cases'].append(_lb_case(
                f'{NX}->{L}x{N}', wts, lbs, (pre_x, h0, c0, m), L, N, sms,
                L, time_it=m is not None))

    # a stack K2 refuses whole, in groups
    deep = stack_params_to(init_lstm_stack(
        NX, N, LB_DEEP, None, torch.Generator().manual_seed(SEED + 6)), dev)
    dwts = stack_kernel_weights(deep)
    deep_lbs = enumerate_lb_candidates(NX, N, LB_DEEP, SLOTS, device=dev)
    check(deep_lbs == [1, 2, 3], f'stack_lb: candidates {deep_lbs} at '
                                 f'{LB_DEEP}x{N}, expected [1, 2, 3]')
    pre_x = hoisted_input(deep.layers[0].w_x, r(CHUNK, SLOTS, NX))
    args = (pre_x, r(LB_DEEP, SLOTS, N), r(LB_DEEP, SLOTS, N),
            inputs(L, CHUNK, SLOTS)[3])
    lstm_stack_seq_kernel.launches = 0
    try:
        lstm_stack_seq_kernel(pre_x, dwts.w_in, dwts.w_h, dwts.peep, dwts.b,
                              *args[1:])
        refused = ''
    except RuntimeError as e:
        refused = str(e)
    print(f'stack_lb: {LB_DEEP}x{N} at lb={LB_DEEP}: {refused}', flush=True)
    check(refused.startswith('lstm_stack_seq_kernel: ')
          and lstm_stack_seq_kernel.launches == 0,
          f'stack_lb: K2 did not refuse the whole {LB_DEEP}x{N} stack')
    res['deep'] = dict(refused=refused, case=_lb_case(
        f'{NX}->{LB_DEEP}x{N}', dwts, deep_lbs, args, LB_DEEP, N, sms,
        deep_lbs[-1], time_it=True))

    # the unmasked autograd path's gradients at lb = 1 and lb = L
    xs, g_ys = r(CHUNK, SLOTS, NX), r(CHUNK, SLOTS, N)
    grads = []
    for lb in (1, L):
        p = LSTMStackParams(tuple(LSTMParams(*(
            getattr(lp, f.name).detach().clone().requires_grad_()
            for f in dataclasses.fields(LSTMParams)))
            for lp in params.layers), None, None)
        leaves = [getattr(lp, f.name) for lp in p.layers
                  for f in dataclasses.fields(LSTMParams)]
        ys, finals = lstm_stack_seq(p, xs, lb=lb)
        loss = (ys * g_ys).sum() + sum(h.sum() + 0.5 * c.sum()
                                       for h, c in finals)
        grads.append(torch.autograd.grad(loss, leaves))
    same = all(torch.equal(a, b) for a, b in zip(*grads))
    res['gradients_equal'] = same
    print(f'stack_lb: gradients of {len(grads[0])} leaves at lb=1 '
          f'torch.equal to lb={L}: {same}', flush=True)
    check(same, 'stack_lb: the gradients differ across lb')

    # the tuner's trial, and the main path under its entry
    cache = ScheduleCache()
    res['trials'] = []
    for B in LB_TRIAL_B:
        ent, recs = tune_stack_lb(NX, N, L, CHUNK, B, cache=cache,
                                  iters=TUNE_ITERS, device=dev)
        med = {r.params['lb']: r.metrics['measured_us'] for r in recs}
        res['trials'].append(dict(B=B, medians_us=med, lb=ent.lb))
        print(f'stack_lb: tune_stack_lb at T={CHUNK} B={B} ({card}; '
              f'torch.equal before timing; medians of {TUNE_ITERS} '
              f'interleaved turns, us): {med} -> lb={ent.lb}', flush=True)
        check(ent.source == 'measured' and sorted(med) == lbs
              and all(v > 0 for v in med.values()),
              'stack_lb: the trial did not measure every candidate')
    key = dict(kind='stack_lb', n_x=NX, n_h=N, n_layers=L, T=CHUNK,
               B=SLOTS)
    cold, cold_run = serve_once(cfg, params, 'cuda_seq_fused', utts, SLOTS,
                                CHUNK)
    res['engine'] = {}
    for label, c in (('measured', cache), ('lb=1', ScheduleCache(
            [ScheduleEntry(lb=1, source='measured', **key)]))):
        lb = c.lookup(**key).lb
        with using_schedule_cache(c):
            lps, run = serve_once(cfg, params, 'cuda_seq_fused', utts,
                                  SLOTS, CHUNK)
        equal = len(lps) == len(cold) and all(
            np.array_equal(a, b) for a, b in zip(lps, cold))
        k2 = run['launches']['lstm_stack_seq_kernel']
        res['engine'][label] = dict(lb=lb, k2_launches=k2,
                                    steps=run['steps'], equal=equal)
        print(f'stack_lb: engine drain under the {label} cache (lb={lb}): '
              f'{k2} K2 launches over {run["steps"]} chunks, log-probs '
              f'torch.equal to the drain without a cache: {equal}',
              flush=True)
        check(equal and k2 == L // lb * run['steps']
              and cold_run['launches']['lstm_stack_seq_kernel']
              == cold_run['steps'],
              f'stack_lb: the engine under the {label} cache changed its '
              f'bits or did not launch (L / lb) K2 a chunk')
    return res


def examples_phase():
    """The paper's lifecycle examples as users run them, each a process of
    its own: ``repro_torch.examples.speech_ctc --steps 4`` at full width
    (its int8 deploy must equal the plain chain, and the kernel it names
    must have launched) and ``repro_torch.examples.quickstart`` (K3 equal
    to the plain chain)."""
    import ast
    import re
    import tempfile
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = _run_cli('example speech_ctc', [
            'repro_torch.examples.speech_ctc', '--steps', '4'], tmp)
        m = re.search(r"int8 deploy on '(\w+)' .*launches (\{[^}]*\})\): "
                      r"codes == plain chain .*: (True|False)", out)
        check(m is not None, 'speech_ctc printed no int8 deploy line')
        backend, launches = m.group(1), ast.literal_eval(m.group(2))
        kernel = ('lstm_stack_seq_kernel_q' if backend == 'fused'
                  else 'lstm_seq_quantized')
        res['speech_ctc'] = dict(backend=backend, launches=launches,
                                 chain_equal=m.group(3) == 'True',
                                 lines=out.strip().splitlines())
        check(res['speech_ctc']['chain_equal'] and launches[kernel] > 0,
              'speech_ctc: the int8 deploy is not the plain chain, or its '
              'kernel did not launch')
        out = _run_cli('example quickstart',
                       ['repro_torch.examples.quickstart'], tmp)
        res['quickstart'] = dict(lines=out.strip().splitlines())
        check('== plain chain: True' in out,
              'quickstart: K3 disagrees with the plain chain')
    return res


def _wall_ms(run):
    """One call of ``run`` on the host clock, ending in a synchronize:
    (its result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _turns_ms(runs: dict, turns: int = SYSTOLIC_TURNS):
    """Each of ``runs`` (name -> call) once to warm, then ``turns`` rounds
    of one call each, the order alternating between rounds, on the host
    clock (each call ending in a synchronize): (name -> the last result,
    name -> the median ms)."""
    out, times = {}, {k: [] for k in runs}
    for run in runs.values():
        run()
    names = list(runs)
    for i in range(turns):
        for k in (names if i % 2 == 0 else names[::-1]):
            out[k], ms = _wall_ms(runs[k])
            times[k].append(ms)
    return out, {k: float(np.median(v)) for k, v in times.items()}


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def systolic_checks(params, qps, rng, dev):
    """The scale-outs at (``SYSTOLIC_T``, ``SYSTOLIC_B``), full width, every
    engine on the card, against K1-K4 on the same inputs: the layerwise
    f32 ``systolic_lstm_seq`` on each of ``SYSTOLIC_LAYERWISE`` allclose
    to K1 (h and c, ``SYSTOLIC_TOL``), its masked chunks bit-equal to its
    monolithic masked call and an all-ones mask to the unmasked call; the
    int8 ``systolic_lstm_seq_quantized`` on ``5x5`` ``torch.equal`` to K3;
    on ``graves-75`` the staged f32 ``systolic_lstm_stack_seq`` allclose
    to K2 (the top layer's outputs, every layer's h_T and c_T), its masked
    chunks bit-equal to one masked call, a stack placed once
    (``place_stack``) bit-equal to placing per call, and the staged int8
    form ``torch.equal`` to K4; on the all-1 ``single`` preset each form
    runs its single-engine kernel once.  Each form timed on the host clock
    after a warm call (``_turns_ms``); one staged call traced for its
    device ops (launches per time step), placed per call and placed
    once."""
    from repro_torch.core import quant, systolic as sy
    from repro_torch.kernels import lstm_seq as ks
    from repro_torch.launch.mesh import make_systolic_topology
    T, B = SYSTOLIC_T, SYSTOLIC_B
    lp = params.layers[0]
    xs = torch.from_numpy((rng.randn(T, B, lp.n_x) * 0.5).astype(
        np.float32)).to(dev)
    lens = torch.from_numpy(ragged_lens(rng, T, B)).to(dev)
    full = torch.full((B,), T, device=dev)
    pieces = ((0, 5), (5, 10), (10, T))

    def chunked(call):
        """``call(lo, hi, state, valid_len)`` over ``pieces``, the masked
        carry threaded: (outputs concatenated, last state)."""
        outs, st = [], None
        for lo, hi in pieces:
            o, st = call(lo, hi, st,
                         torch.clamp(lens - lo, 0, hi - lo))
            outs.append(o)
        return torch.cat(outs), st

    res = {}
    (k1, (_, k1_c)), k1_n = _kernel_launches(
        lambda: ks.lstm_layer_seq(lp, xs))
    for name in SYSTOLIC_LAYERWISE:
        mesh = make_systolic_topology(name, devices=dev)
        out, ms = _turns_ms({name: lambda: sy.systolic_lstm_seq(lp, mesh,
                                                                 xs)})
        (hs, (_, c_T)), ms = out[name], ms[name]
        err = max(_max_err(hs, k1), _max_err(c_T, k1_c))
        mono = sy.systolic_lstm_seq(lp, mesh, xs, valid_len=lens)
        got, st = chunked(lambda lo, hi, s, vl: sy.systolic_lstm_seq(
            lp, mesh, xs[lo:hi], *(s or ()), valid_len=vl))
        ones = sy.systolic_lstm_seq(lp, mesh, xs, valid_len=full)
        res[name] = dict(max_abs_err_vs_k1=err, ms=ms,
                         chunked_equal=bool(torch.equal(got, mono[0])
                                            and torch.equal(st[1], mono[1][1])),
                         all_ones_equal=bool(torch.equal(ones[0], hs)))
        print(f'systolic [{name} f32 layerwise]: T={T} B={B} vs K1 max abs '
              f'err {err:.3e} (tol {SYSTOLIC_TOL}), {ms:.1f} ms a call; '
              f'chunked == monolithic {res[name]["chunked_equal"]}, '
              f'all-ones mask == unmasked {res[name]["all_ones_equal"]}',
              flush=True)
        check(err <= SYSTOLIC_TOL, f'{name}: systolic_lstm_seq vs K1')
        check(res[name]['chunked_equal'] and res[name]['all_ones_equal'],
              f'{name}: chunked or masked != monolithic')

    xq = quant.quantize(xs)
    k3, k3_n = _kernel_launches(lambda: ks.lstm_layer_seq_quantized(qps[0],
                                                                    xq))
    mesh = make_systolic_topology('5x5', devices=dev)
    out, ms = _turns_ms({'5x5': lambda: sy.systolic_lstm_seq_quantized(
        qps[0], mesh, xq)})
    got, ms = out['5x5'], ms['5x5']
    res['5x5 int8'] = dict(equal_k3=bool(torch.equal(got, k3)), ms=ms)
    print(f'systolic [5x5 int8 layerwise]: == K3 '
          f'{res["5x5 int8"]["equal_k3"]}, {ms:.1f} ms a call', flush=True)
    check(res['5x5 int8']['equal_k3'], '5x5: int8 scale-out != K3')

    mesh = make_systolic_topology(SYSTOLIC_STAGED, devices=dev)
    (k2, k2_fin), k2_n = _kernel_launches(lambda: ks.lstm_stack_seq(params,
                                                                    xs))
    placement = sy.place_stack(params, mesh, staged=True, T=T, batch=B)
    out, f32_ms = _turns_ms({
        'placed per call': lambda: sy.systolic_lstm_stack_seq(params, mesh,
                                                              xs),
        'placed once': lambda: sy.systolic_lstm_stack_seq(
            params, mesh, xs, placement=placement)})
    ys_, fs = out['placed per call']
    err = max([_max_err(ys_, k2)]
              + [max(_max_err(a[0], b[0]), _max_err(a[1], b[1]))
                 for a, b in zip(fs, k2_fin)])
    mono = sy.systolic_lstm_stack_seq(params, mesh, xs, valid_len=lens)
    got, st = chunked(lambda lo, hi, s, vl: sy.systolic_lstm_stack_seq(
        params, mesh, xs[lo:hi], s, valid_len=vl))
    pgot, pst = chunked(lambda lo, hi, s, vl: sy.systolic_lstm_stack_seq(
        params, mesh, xs[lo:hi], s, valid_len=vl, placement=placement))
    ops = trace(lambda: sy.systolic_lstm_stack_seq(params, mesh, xs),
                f'{SYSTOLIC_STAGED} f32 staged call, placed per call')
    pops = trace(lambda: sy.systolic_lstm_stack_seq(params, mesh, xs,
                                                    placement=placement),
                 f'{SYSTOLIC_STAGED} f32 staged call, placed once')
    res[f'{SYSTOLIC_STAGED} f32'] = dict(
        max_abs_err_vs_k2=err, ms=f32_ms,
        chunked_equal=bool(torch.equal(got, mono[0]) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(st, mono[1]))),
        placed_equal=bool(torch.equal(pgot, got) and torch.equal(
            out['placed once'][0], ys_) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(pst, st))),
        device_ops=ops['device_ops'], device_ops_placed=pops['device_ops'],
        launches_per_step=pops['device_ops'] / T,
        idle_share=pops['idle_share'],
        device_busy_ms=pops['device_busy_ms'], wall_ms=pops['wall_ms'])
    r = res[f'{SYSTOLIC_STAGED} f32']
    print(f'systolic [{SYSTOLIC_STAGED} f32 staged]: vs K2 max abs err '
          f'{err:.3e} (tol {SYSTOLIC_TOL}, ys and every layer\'s h_T, c_T), '
          f'chunked == monolithic {r["chunked_equal"]}, placed once == '
          f'placed per call {r["placed_equal"]}; ms a call '
          + ', '.join(f'{m} {v:.1f}' for m, v in r['ms'].items())
          + f'; device ops a call of {T} steps: placed per call '
          f'{r["device_ops"]}, placed once {r["device_ops_placed"]} '
          f'({r["launches_per_step"]:.1f} a step)', flush=True)
    check(err <= SYSTOLIC_TOL, f'{SYSTOLIC_STAGED}: staged f32 vs K2')
    check(r['chunked_equal'], f'{SYSTOLIC_STAGED}: chunked != monolithic')
    check(r['placed_equal'], f'{SYSTOLIC_STAGED}: placed once != per call')

    k4, k4_n = _kernel_launches(lambda: ks.lstm_stack_seq_quantized(qps, xq))
    out, q = _turns_ms({'int8': lambda: sy.systolic_lstm_stack_seq_quantized(
        qps, mesh, xq)})
    check(torch.equal(out['int8'], k4), f'{SYSTOLIC_STAGED} int8 != K4')
    res[f'{SYSTOLIC_STAGED} int8'] = dict(equal_k4=True, ms=q['int8'])
    print(f'systolic [{SYSTOLIC_STAGED} int8 staged]: == K4; '
          f'{q["int8"]:.1f} ms a call', flush=True)

    # the all-1 preset runs the single-engine kernels, one launch each
    single = make_systolic_topology('single', devices=dev)
    n = {}
    for label, run in (
            ('f32 layer', lambda: sy.systolic_lstm_seq(lp, single, xs)),
            ('int8 layer', lambda: sy.systolic_lstm_seq_quantized(
                qps[0], single, xq)),
            ('f32 stack', lambda: sy.systolic_lstm_stack_seq(params, single,
                                                             xs)),
            ('int8 stack', lambda: sy.systolic_lstm_stack_seq_quantized(
                qps, single, xq))):
        n[label] = _kernel_launches(run)[1]
    res['single'] = n
    print(f'systolic [single]: launches {n}', flush=True)
    for (label, kernel), want in zip(n.items(), (k1_n, k3_n, k2_n, k4_n)):
        check(kernel == want, f'single {label}: launches {kernel}, the '
                              f'kernel alone {want}')
    return res


def systolic_engine(cfg, params, utts, dev):
    """The f32 engine cell (``SLOTS`` slots, chunk ``CHUNK``, the 12
    utterances) with ``graves-75`` installed on the card, through
    ``launch.serve.StreamServer`` on ``auto``, which must resolve to
    ``cuda_seq_fused_systolic``: no K1-K4 launch in the drain, every
    stream allclose to a ``cuda_seq_fused`` engine's; frames/s and p50
    chunk ms (median of ``SYSTOLIC_DRAINS`` drains after a warm one) and
    one chunk call traced for its device ops.  Then the fault ladder from
    the systolic rung (``SYSTOLIC_LADDER``): down to K2 and to K1, both
    launched, every stream still allclose."""
    from repro_torch.core import systolic as sy
    from repro_torch.launch.mesh import install_systolic_topology
    from repro_torch.launch.serve import StreamServer
    from repro_torch.models import chipmunk_net
    from repro_torch.runtime import ServingFaultConfig
    want, base = serve_once(cfg, params, 'cuda_seq_fused', utts, SLOTS, CHUNK)
    mesh = install_systolic_topology(SYSTOLIC_STAGED, devices=dev)
    try:
        def drain(faults=None):
            server = StreamServer(cfg.replace(lstm_backend='auto'), params,
                                  num_slots=SLOTS, chunk=CHUNK, faults=faults)
            sess = [server.submit(u) for u in utts]
            (_, ms) = _wall_ms(server.drain)
            return server.engine, [s.full_log_probs() for s in sess], ms

        eng, _, _ = drain()
        check(eng.backend == 'cuda_seq_fused_systolic',
              f'auto under {SYSTOLIC_STAGED} resolved to {eng.backend}')
        rates, p50s = [], []
        for _ in range(SYSTOLIC_DRAINS):
            (eng, got, ms), n = _kernel_launches(drain)
            stats = eng.stats()
            rates.append(stats['frames'] / ms * 1e3)
            p50s.append(stats['p50_chunk_s'] * 1e3)
        worst = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        check(all(np.allclose(a, b, rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
                  for a, b in zip(got, want)),
              f'{SYSTOLIC_STAGED} engine vs cuda_seq_fused engine')
        check(not any(n.values()), f'the staged drain launched {n}')
        st = chipmunk_net.init_state(cfg, SLOTS, dev)
        frames = torch.from_numpy(np.stack([
            utts[i % len(utts)][:CHUNK] for i in range(SLOTS)])).to(dev)
        valid = torch.full((SLOTS,), CHUNK, device=dev)
        check(eng.placement is not None
              and eng.placement.mesh is mesh, 'the engine has no placement')
        ops = trace(lambda: eng._fwd(st, frames, valid),
                    f'{SYSTOLIC_STAGED} engine chunk')
        per_call = trace(lambda: chipmunk_net.stream_forward(
            cfg.replace(lstm_backend='cuda_seq_fused_systolic'), params, st,
            frames, valid_len=valid),
            f'{SYSTOLIC_STAGED} chunk, stack placed per call')
        res = dict(backend=eng.backend, steps=stats['steps'],
                   frames=stats['frames'],
                   frames_per_s=float(np.median(rates)),
                   p50_chunk_ms=float(np.median(p50s)),
                   drains_frames_per_s=rates,
                   max_abs_diff_vs_cuda_seq_fused=worst,
                   device_ops_per_chunk=ops['device_ops'],
                   device_ops_per_chunk_placed_per_call=per_call[
                       'device_ops'],
                   launches_per_step=ops['device_ops'] / CHUNK,
                   chunk_trace=dict(wall_ms=ops['wall_ms'],
                                    device_busy_ms=ops['device_busy_ms'],
                                    idle_share=ops['idle_share']),
                   cuda_seq_fused=dict(frames_per_s=base['frames_per_s'],
                                       p50_chunk_ms=base['p50_chunk_ms']))
        print(f'systolic engine [{SYSTOLIC_STAGED}, auto -> {eng.backend}]: '
              f'{len(utts)} utterances, {stats["frames"]} frames, '
              f'{stats["steps"]} chunks: {res["frames_per_s"]:.1f} frames/s, '
              f'p50 chunk {res["p50_chunk_ms"]:.2f} ms (cuda_seq_fused '
              f'{base["frames_per_s"]:.1f} frames/s, p50 chunk '
              f'{base["p50_chunk_ms"]:.3f} ms); {ops["device_ops"]} device '
              f'launches a chunk ({res["launches_per_step"]:.1f} a step; '
              f'{per_call["device_ops"]} with the stack placed per call); '
              f'max abs diff vs cuda_seq_fused {worst:.3e}', flush=True)

        faults = ServingFaultConfig(backoff_s=0.0, **SYSTOLIC_LADDER)
        (eng, got, _), n = _kernel_launches(lambda: drain(faults))
        moves = [e['to_backend'] for e in eng.events
                 if e['kind'] == 'degrade']
        check(all(np.allclose(a, b, rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
                  for a, b in zip(got, want)), 'the ladder lost a stream')
        check(moves == ['cuda_seq_fused', 'cuda_seq']
              and n['lstm_stack_seq_kernel'] > 0 and n['lstm_seq'] > 0,
              f'ladder from the systolic rung: {moves}, launches {n}')
        res['ladder'] = dict(moves=moves, launches=n)
        print(f'systolic engine ladder {SYSTOLIC_LADDER}: moves {moves}, '
              f'launches {n}, every stream allclose', flush=True)
        check(sy.current_mesh() is None, 'the K1 rung left a mesh installed')
    finally:
        sy.clear_mesh()
    return res


def systolic_grads(cfg, dev):
    """Every leaf's gradient of ``loss_fn`` (``GRAD_T``, ``TRAIN_BATCH``)
    through the layerwise scale-out under ``2x2`` and the staged one under
    ``graves-75`` (their gate-recompute backwards) against
    ``cuda_seq_fused``'s, by relative Frobenius error.  Returns the worst
    error of each."""
    from repro_torch.core import systolic as sy
    from repro_torch.launch.mesh import install_systolic_topology
    from repro_torch.launch.train import _grads_of, init_train_state
    from repro_torch.models import chipmunk_net
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.tree import flatten_with_paths
    params = init_train_state(cfg, adamw(cosine_schedule(1e-3, 1, 2)),
                              dev, seed=SEED)['params']
    batch = _train_batch(cfg, GRAD_T, TRAIN_BATCH, 0, dev)
    def grads_of(backend):
        loss_fn = lambda p, x, c=cfg.replace(lstm_backend=backend): \
            chipmunk_net.loss_fn(c, p, x)
        return flatten_with_paths(_grads_of(loss_fn, params, batch)[1])

    want = grads_of('cuda_seq_fused')
    worst = {}
    for topology, backend in (('2x2', 'cuda_seq_systolic'),
                              (SYSTOLIC_STAGED, 'cuda_seq_fused_systolic')):
        install_systolic_topology(topology, devices=dev)
        try:
            got = grads_of(backend)
        finally:
            sy.clear_mesh()
        rel = [float(torch.linalg.vector_norm(g - r)
                     / torch.linalg.vector_norm(r))
               for (_, g), (_, r) in zip(got, want)]
        finite = all(bool(torch.isfinite(g).all()) for _, g in got)
        print(f'systolic grads [{topology} {backend}] vs cuda_seq_fused: '
              f'T={GRAD_T} B={TRAIN_BATCH}, {len(rel)} leaves: max relative '
              f'Frobenius error {max(rel):.3e} (tol {GRAD_REL_TOL}), finite '
              f'{finite}', flush=True)
        check(finite and max(rel) <= GRAD_REL_TOL,
              f'{backend} gradients disagree with cuda_seq_fused')
        worst[f'{topology} {backend}'] = max(rel)
    return worst


def systolic_phase(cfg, params, qps, utts, dev):
    """The paper's systolic scale-out on the card (``systolic_checks``,
    ``systolic_engine``, ``systolic_grads``) and the serve CLI with
    ``--systolic-topology graves-75`` as a subprocess."""
    import tempfile
    res = dict(checks=systolic_checks(params, qps,
                                      np.random.RandomState(SEED + 2), dev),
               engine=systolic_engine(cfg, params, utts, dev),
               grad_rel_err=systolic_grads(cfg, dev))
    with tempfile.TemporaryDirectory() as tmp:
        out = _run_cli('serve graves-75', [
            'repro_torch.launch.serve', '--systolic-topology',
            SYSTOLIC_STAGED, '--requests', '2'], tmp)
    check(f'installed systolic topology {SYSTOLIC_STAGED}' in out
          and '[cuda_seq_fused_systolic]' in out,
          'serve --systolic-topology did not serve on the staged scale-out')
    res['serve_cli'] = out.strip().splitlines()
    return res


def die_rungs(params, dev):
    """``build_rungs`` for ``DIE_TOPOLOGY`` at full width on the card, held
    to ``DIE_RUNGS``, with each die rung's resident bytes an engine beside
    its budget (``engine_budget`` of the rung's submesh)."""
    from repro_torch.core import systolic as sy
    from repro_torch.launch.mesh import make_die_topology
    from repro_torch.runtime import build_rungs
    dm = make_die_topology(DIE_TOPOLOGY, devices=dev)
    lp = params.layers[0]
    L = len(params.layers)
    rungs = build_rungs('cuda_seq_fused_systolic', n_layers=L, n_h=lp.n_h,
                        die_mesh=dm, n_x=lp.n_x, T=CHUNK, batch=SLOTS)
    got = [(r.label(), r.need) for r in rungs]
    sizes = []
    for r in rungs:
        if r.n_dies is None:
            continue
        sub = dm.submesh(range(r.n_dies))
        _, bn, bk = sy._scaleout_blocks(lp.n_h, sub.rows, sub.cols)
        layers = (-(-L // sub.stage) if r.backend.endswith('fused_systolic')
                  else 1)
        fams = 2 if r.backend.endswith('fused_systolic') else 1
        sizes.append(dict(rung=r.label(), engines=len(sub.devices),
                          resident_bytes=layers * (fams * 4 * bn * bk * 4
                                                   + 7 * bn * 4),
                          budget_bytes=sy.engine_budget(sub)))
    print(f'die rungs [{DIE_TOPOLOGY}, n_h {lp.n_h}, every engine on '
          f'{dev}]: {got}; resident bytes an engine vs budget '
          + ', '.join(f"{x['rung']} {x['resident_bytes']} / "
                      f"{x['budget_bytes']}" for x in sizes), flush=True)
    check(got == list(DIE_RUNGS), f'{DIE_TOPOLOGY} rungs {got}')
    return dict(rungs=got, sizes=sizes)


def _die_serve(cfg, params, utts, dev, faults, async_dispatch=False):
    """One drain of ``utts`` on ``auto`` with ``DIE_TOPOLOGY`` installed on
    ``dev``, every chunk call logged (``fault_engine``)."""
    from repro_torch.launch.mesh import install_die_topology
    install_die_topology(DIE_TOPOLOGY, devices=dev)
    return fault_serve(cfg, params, 'auto', utts, faults, async_dispatch)


def die_engine(cfg, params, utts, dev):
    """The f32 engine cell on ``auto`` under ``DIE_TOPOLOGY``: an unfaulted
    drain (the staged scale-out on all 75 engines, no K1-K4), then
    ``DIE_SCHEDULE`` sync and async: the trail degrade, heal,
    promote_canary, promote, the degrade onto the 2d rung (its chunk calls
    on a 2-stage mesh, no K1-K4 launch), every stream ``torch.equal`` to
    the unfaulted drain, async event counts equal to sync; ``DIE_TAIL``
    onto K2 and K1 (their launches counted, streams allclose); and
    ``DIE_ONE``'s canary from the layerwise 1d rung back to 2d (its outcome
    printed, a rejection is no failure)."""
    from repro_torch.core import systolic as sy
    from repro_torch.launch.mesh import clear_die_mesh
    from repro_torch.runtime import ServingFaultConfig
    res = {}
    try:
        (clean, _, eng, log), n = _kernel_launches(
            lambda: _die_serve(cfg, params, utts, dev, None))
        check(eng.backend == 'cuda_seq_fused_systolic'
              and eng.placement.mesh.stage == 3,
              f'auto under {DIE_TOPOLOGY}: {eng.backend}')
        check(not any(n.values()), f'the unfaulted drain launched {n}')
        trails, counts = {}, {}
        for mode in (False, True):
            lps, sess, eng, log = _die_serve(
                cfg, params, utts, dev, ServingFaultConfig(**DIE_SCHEDULE),
                mode)
            stats = eng.stats()
            trail = [e['kind'] for e in stats['events'] if e['kind'] in (
                'degrade', 'heal', 'promote_canary', 'promote',
                'promote_rejected')]
            deg = next(e for e in stats['events'] if e['kind'] == 'degrade')
            two = [c for c in log if c['stages'] == 2]
            equal = all(np.array_equal(a, b) for a, b in zip(lps, clean))
            trails[mode] = trail
            counts[mode] = {k: v for k, v in stats['event_counts'].items()
                            if k != 'squash'}
            res['async' if mode else 'sync'] = dict(
                trail=trail, rung=stats['rung'],
                healthy=stats['healthy_domains'],
                degrade_to=(deg['to_backend'], deg['domain']),
                calls_2d=len(two),
                launches_2d=[sum(c[k] for c in two)
                             for k in ('k1', 'k2', 'k3', 'k4')],
                canary_diffs=eng.canary_diffs, equal_unfaulted=equal,
                event_counts=counts[mode])
            r = res['async' if mode else 'sync']
            print(f'die engine [{DIE_TOPOLOGY}, {DIE_SCHEDULE}, '
                  f'{"async" if mode else "sync"}]: trail {trail}, degrade '
                  f'onto {deg["to_backend"]} (domain {deg["domain"]}), '
                  f'{len(two)} chunk calls on the 2-stage mesh launching '
                  f'K1-K4 {r["launches_2d"]}, ends on {stats["rung"]} '
                  f'healthy {stats["healthy_domains"]}; canary (abs, rel) '
                  f'diffs {eng.canary_diffs}; streams == unfaulted {equal}',
                  flush=True)
            check(trail == ['degrade', 'heal', 'promote_canary', 'promote'],
                  f'die trail {trail}')
            check(deg['to_backend'] == 'cuda_seq_fused_systolic'
                  and two and not any(r['launches_2d']),
                  f'the degrade did not land on the 2d rung: {deg}, {two}')
            check(stats['rung'] == 'cuda_seq_fused_systolic@3d'
                  and stats['healthy_domains'] == [0, 1, 2],
                  f'die engine ends on {stats["rung"]}')
            check(equal, 'a die-faulted stream differs from the unfaulted '
                         'drain')
        check(counts[False] == counts[True],
              f'async event counts {counts[True]} != sync {counts[False]}')

        (lps, sess, eng, log), n = _kernel_launches(lambda: _die_serve(
            cfg, params, utts, dev, ServingFaultConfig(**DIE_TAIL)))
        moves = [e['to_backend'] for e in eng.events
                 if e['kind'] == 'degrade']
        worst = max(float(np.abs(a - b).max()) for a, b in zip(lps, clean))
        res['tail'] = dict(moves=moves, launches=n, max_abs_diff=worst)
        print(f'die engine [{DIE_TAIL}]: moves {moves}, launches {n} (K2 '
              f'{n["lstm_stack_seq_kernel"]}, K1 {n["lstm_seq"]}), max abs '
              f'diff vs unfaulted {worst:.3e}', flush=True)
        check(moves == ['cuda_seq_fused', 'cuda_seq']
              and n['lstm_stack_seq_kernel'] > 0 and n['lstm_seq'] > 0,
              f'the die ladder tail: {moves}, {n}')
        check(all(np.allclose(a, b, rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
                  for a, b in zip(lps, clean))
              and all(x.error is None for x in sess),
              'the die ladder tail lost or changed a stream')

        lps, sess, eng, log = _die_serve(cfg, params, utts, dev,
                                         ServingFaultConfig(**DIE_ONE))
        stats = eng.stats()
        trail = [(e['kind'], e.get('to_backend')) for e in stats['events']
                 if e['kind'] in ('degrade', 'heal', 'promote_canary',
                                  'promote', 'promote_rejected')]
        worst = max(float(np.abs(a - b).max()) for a, b in zip(lps, clean))
        res['one_die'] = dict(trail=trail, rung=stats['rung'],
                              canary_diffs=eng.canary_diffs,
                              max_abs_diff=worst)
        print(f'die engine [{DIE_ONE}]: trail {trail}, ends on '
              f'{stats["rung"]}; canary 1d -> 2d '
              f'{"passed" if ("promote", "cuda_seq_fused_systolic") in trail else "rejected"}'
              f', (abs, rel) diffs {eng.canary_diffs}; max abs diff vs '
              f'unfaulted {worst:.3e}', flush=True)
        check(trail[0] == ('degrade', 'cuda_seq_systolic')
              and all(x.error is None for x in sess)
              and all(np.allclose(a, b, rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
                      for a, b in zip(lps, clean)),
              f'the 1d rung: {trail}')
    finally:
        sy.clear_mesh()
        clear_die_mesh()
    return res


def die_rung_times(cfg, params, utts, dev):
    """One engine chunk on each die rung of ``DIE_TOPOLOGY`` (the stack
    placed once on the rung's submesh, as the engine places it): ms a
    chunk (median of ``SYSTOLIC_TURNS`` after a warm call), device ops of
    one traced chunk, K1-K4 launches (none)."""
    from repro_torch.core import systolic as sy
    from repro_torch.launch.mesh import make_die_topology
    from repro_torch.models import chipmunk_net
    dm = make_die_topology(DIE_TOPOLOGY, devices=dev)
    st = chipmunk_net.init_state(cfg, SLOTS, dev)
    frames = torch.from_numpy(np.stack([
        utts[i % len(utts)][:CHUNK] for i in range(SLOTS)])).to(dev)
    valid = torch.full((SLOTS,), CHUNK, device=dev)
    res = {}
    for label, k in DIE_RUNGS[:3]:
        backend = label.split('@')[0]
        pl = sy.place_stack(params, dm.submesh(range(k)),
                            staged=backend == 'cuda_seq_fused_systolic',
                            T=CHUNK, batch=SLOTS)
        c = cfg.replace(lstm_backend=backend)
        run = lambda: chipmunk_net.stream_forward(c, params, st, frames,
                                                  valid_len=valid,
                                                  placement=pl)
        _, n = _kernel_launches(run)
        _, ms = _turns_ms({label: run})
        ops = trace(run, f'{label} chunk')
        res[label] = dict(ms=ms[label], device_ops=ops['device_ops'],
                          device_busy_ms=ops['device_busy_ms'],
                          idle_share=ops['idle_share'], launches=n)
        print(f'die rung [{label}]: {ms[label]:.2f} ms a chunk of {CHUNK} '
              f'(median of {SYSTOLIC_TURNS}), {ops["device_ops"]} device ops '
              f'({ops["device_ops"] / CHUNK:.1f} a step), busy '
              f'{ops["device_busy_ms"]:.2f} ms, idle {ops["idle_share"]:.3f}'
              f'; K1-K4 {n}', flush=True)
        check(not any(n.values()), f'{label} launched {n}')
    return res


def die_tune(cfg, params, dev):
    """The staged half of the tuner on the card at (``CHUNK``, ``SLOTS``):
    ``tune_staged_stack`` measured on ``graves-75``; the reference's
    arithmetic class probed (``DIE_CLASS_PROBE``: bit-equal to (3, 5, 5)
    or not, and ms a call); ``tune_geometry`` measured at 75 engines with
    ref (3, 5, 5), in the port's class and with ``allow_reassoc``, the
    winner beside the balanced reference; that cache installed, an engine
    on the winner's mesh built and one chunk served (its split, ``Tc``,
    device ops a step, no K1-K4); and the tune CLI with
    ``--staged-devices 75 --geometry`` as a subprocess."""
    import tempfile
    from repro_torch.core import systolic as sy
    from repro_torch.launch.mesh import make_systolic_topology
    from repro_torch.models import chipmunk_net
    from repro_torch.serving import StreamingEngine
    from repro_torch.tune import (ScheduleCache, reference_geometry,
                                  tune_geometry, tune_staged_stack,
                                  using_schedule_cache)
    g = torch.Generator().manual_seed(SEED + 3)
    lp = params.layers[0]
    L = len(params.layers)
    xs = (torch.randn((CHUNK, SLOTS, lp.n_x), generator=g) * 0.5).to(dev)
    res = {}
    mesh = make_systolic_topology(SYSTOLIC_STAGED, devices=dev)
    ent, recs = tune_staged_stack(params, mesh, xs, iters=DIE_TUNE_ITERS,
                                  device=dev)
    res['staged'] = dict(tc=ent.tc, measured_us=ent.measured_us, trial=[
        (r.params['tc'], r.metrics['predicted_us'], r.metrics['measured_us'])
        for r in recs])
    print(f'tune_staged_stack [{SYSTOLIC_STAGED}, T={CHUNK} B={SLOTS}]: Tc '
          f'{ent.tc} ({ent.measured_us / 1e3:.2f} ms); (Tc, predicted us, '
          f'measured us) {res["staged"]["trial"]}', flush=True)

    with torch.no_grad():
        ref = reference_geometry(lp.n_h, L, CHUNK, DIE_CLASS_PROBE[0])
        runs, outs = {}, {}
        for s_, r_, c_ in DIE_CLASS_PROBE:
            m = sy.make_systolic_mesh(r_, c_, stage=s_, devices=dev)
            pl = sy.place_stack(params, m, staged=True)
            runs[(s_, r_, c_)] = (lambda m=m, pl=pl: sy.systolic_lstm_stack_seq(
                params, m, xs, chunk=ref.tc, placement=pl))
        outs, ms = _turns_ms(runs)
    base = outs[DIE_CLASS_PROBE[0]]
    probe = {}
    for key, out in outs.items():
        same = bool(torch.equal(out[0], base[0]) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(out[1], base[1])))
        probe['x'.join(map(str, key))] = dict(
            equal=same, max_abs_diff=_max_err(out[0], base[0]), ms=ms[key])
    res['class_probe'] = probe
    held = all(p['equal'] for p in probe.values())
    print(f'reference arithmetic class (n_h_p, bk) = (425, 85) on the card: '
          f'{"held" if held else "did not hold"} bit for bit; vs (3, 5, 5) '
          f'at Tc {ref.tc}: ' + ', '.join(
              f"{k} equal {p['equal']} max abs {p['max_abs_diff']:.3e} "
              f"{p['ms']:.1f} ms" for k, p in probe.items()), flush=True)
    res['class_held'] = held

    for reassoc in (False, True):
        cache = ScheduleCache()
        ent, recs, base_us = tune_geometry(
            params, xs, devices=75, ref=DIE_CLASS_PROBE[0], cache=cache,
            iters=DIE_TUNE_ITERS, allow_reassoc=reassoc, device=dev)
        trial = [(r.params['stages'], r.params['rows'], r.params['cols'],
                  r.params['blocks'], r.params['tc'],
                  round(r.metrics['measured_us'] / 1e3, 3))
                 for r in recs if r.metrics['measured_us'] > 0]
        key = 'geometry_reassoc' if reassoc else 'geometry'
        res[key] = dict(winner=(ent.stages, ent.rows, ent.cols, ent.blocks,
                                ent.tc), ms=ent.measured_us / 1e3,
                        reference_ms=base_us / 1e3, trial=trial)
        print(f'tune_geometry [75 engines, ref {DIE_CLASS_PROBE[0]}, '
              f'allow_reassoc={reassoc}]: winner {ent.stages}x({ent.rows}x'
              f'{ent.cols}) blocks {ent.blocks} Tc {ent.tc} '
              f'{ent.measured_us / 1e3:.2f} ms beside the balanced reference '
              f'{base_us / 1e3:.2f} ms; trial (S, R, C, blocks, Tc, ms) '
              f'{trial}', flush=True)
        if reassoc:
            continue
        win_mesh = sy.make_systolic_mesh(ent.rows, ent.cols,
                                         stage=ent.stages, devices=dev)
        sy.install_mesh(win_mesh)
        try:
            with using_schedule_cache(cache):
                eng = StreamingEngine(cfg.replace(lstm_backend='auto'),
                                      params, max_streams=SLOTS, chunk=CHUNK)
                tc = sy.resolve_staged_chunk(
                    L, CHUNK, ent.stages, n_h=lp.n_h, n_x=lp.n_x,
                    batch=SLOTS, mesh=win_mesh)
                st = chipmunk_net.init_state(cfg, SLOTS, dev)
                frames = xs.transpose(0, 1).contiguous()
                valid = torch.full((SLOTS,), CHUNK, device=dev)
                _, n = _kernel_launches(lambda: eng._fwd(st, frames, valid))
                ops = trace(lambda: eng._fwd(st, frames, valid),
                            'tuned geometry chunk')
        finally:
            sy.clear_mesh()
        split = ','.join(map(str, eng.placement.split))
        res['tuned_engine'] = dict(backend=eng.backend, split=split, tc=tc,
                                   device_ops=ops['device_ops'],
                                   launches_per_step=ops['device_ops']
                                   / CHUNK, kernel_launches=n)
        print(f'tuned engine [{ent.stages}x({ent.rows}x{ent.cols}) on auto '
              f'-> {eng.backend}]: split {split} (tuned {ent.blocks}), Tc '
              f'{tc} (tuned {ent.tc}); {ops["device_ops"]} device ops a '
              f'chunk ({ops["device_ops"] / CHUNK:.1f} a step); K1-K4 {n}',
              flush=True)
        check(eng.backend == 'cuda_seq_fused_systolic'
              and split == ent.blocks and tc == ent.tc
              and not any(n.values()),
              'the engine did not take the tuned geometry')

    with tempfile.TemporaryDirectory() as tmp:
        out = _run_cli('tune --staged-devices 75 --geometry', [
            'repro_torch.tune', '--staged-devices', '75', '--geometry',
            '--n-x', str(lp.n_x), '--n-h', str(lp.n_h), '--layers', str(L),
            '--T', str(CHUNK), '--B', str(SLOTS), '--stages', '3', '--rows',
            '5', '--cols', '5', '--iters', '3', '--out',
            str(pathlib.Path(tmp) / 'geo.json')], tmp)
    check('geometry -> ' in out and '(measured, ' in out
          and 'replay check: ' in out, 'the tune CLI did not measure')
    res['cli'] = out.strip().splitlines()
    return res


def die_phase(cfg, params, utts, dev):
    """Die fault domains and the staged tuner on the card (``die_rungs``,
    ``die_engine``, ``die_rung_times``, ``die_tune``), every engine on
    ``cuda``."""
    return dict(rungs=die_rungs(params, dev),
                engine=die_engine(cfg, params, utts, dev),
                rung_times=die_rung_times(cfg, params, utts, dev),
                tune=die_tune(cfg, params, dev))


def lm_param_count(cfg) -> int:
    """Parameters of a dense or cross-attention LM config (no MoE),
    counted from its shapes: what ``init_lm`` must allocate.  A block is
    attention, two norms (RMSNorm: a scale; LayerNorm: scale and bias) and
    the MLP (SwiGLU: three matrices; GELU: two and their biases); a self
    block adds ``qkv_bias``'s biases and ``qk_norm``'s scales, a cross
    block neither.  The VLM has (groups, per - 1) self blocks and a cross
    block a group; the encoder-decoder its encoder's self blocks, a cross
    block a decoder layer and ``enc_norm``."""
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    h, hk = cfg.n_heads, cfg.n_kv_heads
    norm = d * (2 if cfg.norm == 'layernorm' else 1)
    mlp = 3 * d * ff if cfg.act == 'silu' else 2 * d * ff + ff + d
    block = 2 * d * h * hd + 2 * d * hk * hd + 2 * norm + mlp
    extra = ((h + 2 * hk) * hd if cfg.qkv_bias else 0) + (
        2 * hd if cfg.qk_norm else 0)
    if cfg.cross_attn_every:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        n_self = n_cross * (cfg.cross_attn_every - 1)
    else:
        n_self = cfg.n_layers + cfg.n_encoder_layers
        n_cross = cfg.n_layers if cfg.n_encoder_layers else 0
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    norms = norm * (2 if cfg.n_encoder_layers else 1)
    return embed + n_self * (block + extra) + n_cross * block + norms


def _kernel_counters():
    """Every kernel wrapper of the port (K1-K8 and K8's two backward
    kernels), each with its launch counter."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_kv,
                                                     flash_attention_bwd_q)
    from repro_torch.kernels.lstm_gates import lstm_gates, lstm_gates_rec
    from repro_torch.kernels.lstm_seq import (lstm_seq, lstm_seq_quantized,
                                              lstm_stack_seq_kernel,
                                              lstm_stack_seq_kernel_q)
    from repro_torch.kernels.quant_matmul import quant_matmul
    return (lstm_seq, lstm_stack_seq_kernel, lstm_seq_quantized,
            lstm_stack_seq_kernel_q, lstm_gates_rec, lstm_gates,
            quant_matmul, flash_attention, flash_attention_bwd_kv,
            flash_attention_bwd_q)


def lm_attention_cases(cfg, params, dev, label: str = LM_ARCH):
    """K8 against its plain version (``attn_measure``, bf16 tolerance
    ``ATTN_TOL``) at the model's own shapes, on q, k, v captured from layer
    0 over ``LM_MAX_SEQ`` seeded tokens: decode rows at each
    ``LM_DECODE_POS`` against the whole cache (no causal mask, ``kv_len =
    pos + 1``, as ``attention_decode`` calls it) and the causal prefill of
    the first ``LM_PREFILL`` tokens; each with the schedule it ran."""
    from repro_torch.kernels.flash_attention import attention_geometry
    from repro_torch.models import layers, transformer
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_MAX_SEQ), generator=g,
                           device=dev)
    blk = transformer.layer(params, 0)
    x = layers.apply_norm(cfg, blk['ln1'],
                          layers.embed(cfg, params['embed'], tokens))
    cos_sin = layers.rope_cos_sin(torch.arange(LM_MAX_SEQ, device=dev),
                                  cfg.resolved_head_dim, cfg.rope_theta)
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in layers._project_qkv(blk['attn'], x, cos_sin))
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cases = []
    for pos in sorted(LM_DECODE_POS, reverse=True):
        case = attn_measure(f'{label} decode pos={pos} bfloat16',
                            q[:, :, pos:pos + 1].contiguous(), k, v,
                            kv_len=pos + 1, causal=False)
        geom = attention_geometry(1, H, Hkv, 1, LM_MAX_SEQ, None, pos + 1,
                                  0, D, sms, causal=False)
        cases.append((case, geom))
    qp, kp, vp = (t[:, :, :LM_PREFILL].contiguous() for t in (q, k, v))
    case = attn_measure(f'{label} prefill bfloat16', qp, kp, vp)
    cases.append((case, attention_geometry(1, H, Hkv, LM_PREFILL,
                                           LM_PREFILL, None, None, 0, D,
                                           sms)))
    for case, geom in cases:
        case['geometry'] = dataclasses.asdict(geom)
        _print_attn_case(case, geom)
        check(case['ok'], f'flash_attention disagrees with its plain version '
                          f'at {case["shape"]}')
    return [case for case, _ in cases]


def _logit_diff(a, b, scale: float):
    """max |a - b| over the logit scale, and the share of rows whose argmax
    agrees."""
    return dict(max_abs=float((a - b).abs().max()),
                rel=float((a - b).abs().max()) / scale,
                argmax_agree=float((a.argmax(-1) == b.argmax(-1)).float()
                                   .mean()))


def lm_replay(cfg, params, tokens, dev, source=None):
    """``tokens`` (1, S) through ``forward_lm`` and through ``decode_step``
    token by token from an empty cache, every logit row, on
    ``attn_backend`` 'auto' (K8) and 'torch' (its plain version) with the
    same weights: each pair's max-abs difference relative to the logit
    scale (max |logit| of the plain forward) and its argmax agreement;
    every pair within ``LM_LOGIT_REL``, every logit finite.  A cross
    family's ``source`` (1, F, d) goes to ``forward_lm`` and, through
    ``precompute_cross_kv``, to every ``decode_step``."""
    from repro_torch.models import transformer
    S = tokens.shape[1]
    out = {}
    for backend in ('auto', 'torch'):
        c = cfg.replace(attn_backend=backend)
        full = transformer.forward_lm(c, params, tokens,
                                      source)[0][0].float()
        cache = transformer.init_cache(c, 1, max(S, LM_MAX_SEQ), dev)
        kv = (None if source is None
              else transformer.precompute_cross_kv(c, params, source))
        dec = torch.stack([transformer.decode_step(
            c, params, cache, tokens[:, t:t + 1], t,
            cross_kv=kv)[0][0, 0].float() for t in range(S)])
        out[backend] = (full, dec)
    scale = float(out['torch'][0].abs().max())
    pairs = {'decode vs forward (K8)': (out['auto'][1], out['auto'][0]),
             'decode vs forward (plain)': (out['torch'][1], out['torch'][0]),
             'decode: K8 vs plain': (out['auto'][1], out['torch'][1]),
             'forward: K8 vs plain': (out['auto'][0], out['torch'][0])}
    res = dict(tokens=S, logit_scale=scale, tol_rel=LM_LOGIT_REL,
               finite=all(bool(torch.isfinite(t).all())
                          for p in out.values() for t in p),
               pairs={k: _logit_diff(a, b, scale)
                      for k, (a, b) in pairs.items()})
    print(f'{cfg.name} replay of {S} tokens (logit scale {scale:.4f}, tol '
          f'{LM_LOGIT_REL} of it): ' + '; '.join(
              f'{k} {v["rel"]:.3e} (argmax {v["argmax_agree"]:.3f})'
              for k, v in res['pairs'].items()), flush=True)
    check(res['finite'] and all(v['rel'] <= LM_LOGIT_REL
                                for v in res['pairs'].values()),
          f'{cfg.name}: decode replay outside {LM_LOGIT_REL} of the logit '
          f'scale, or not finite')
    return res


def lm_serve(cfg, params, dev, requests: int = LM_REQUESTS,
             rescore_cfg=None):
    """The LM's main path, with every kernel counter set to 0 just before
    and read just after: ``requests`` seeded prompts of 3-7 tokens
    served through ``SlotServer`` (``LM_SLOTS`` slots, ``LM_MAX_NEW``
    tokens each; K8's split decode).  Then, counted apart, each served
    sequence scored whole by ``forward_lm`` on ``rescore_cfg`` (default
    ``cfg``; K8's tiled prefill), whose argmax must reproduce the served
    tokens at a share of at least ``LM_AGREE_MIN``.  Returns (numbers, the
    serve's launches by kernel, the re-score's)."""
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models import transformer
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, size=rng.randint(3, 8)).tolist()
               for _ in range(requests)]
    kernels = _kernel_counters()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    server = SlotServer(cfg, params, num_slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    for r, prompt in enumerate(prompts):
        server.submit(Request(rid=r, prompt=prompt, max_new=LM_MAX_NEW))
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    done = sorted(server.done, key=lambda r: r.rid)
    agree = []
    for r in done:
        seq = torch.tensor([r.prompt + r.out[:-1]], device=dev)
        logits = transformer.forward_lm(rescore_cfg or cfg, params,
                                        seq)[0][0]
        best = logits[len(r.prompt) - 1:].argmax(-1).cpu().numpy()
        agree += (best == np.array(r.out)).tolist()
    torch.cuda.synchronize()
    rescore = {k.__name__: k.launches - launches[k.__name__]
               for k in kernels}
    toks = sum(len(r.out) for r in done)
    calls = sum(len(r.prompt) + len(r.out) - 1 for r in done)
    lat = [r.t_done - r.t_enqueue for r in done]
    res = dict(requests=len(done), tokens=toks, decode_calls=calls,
               wall_s=wall, tok_per_s=toks / wall,
               p50_latency_s=float(np.median(lat)),
               ms_per_decode_call=wall / calls * 1e3,
               greedy_agree=float(np.mean(agree)),
               outputs={r.rid: r.out for r in done})
    print(f'{cfg.name} SlotServer: {len(done)} requests, {toks} tokens in '
          f'{wall:.2f} s ({res["tok_per_s"]:.2f} tok/s, '
          f'{res["ms_per_decode_call"]:.2f} ms a decode call over {calls} '
          f'calls); p50 latency {res["p50_latency_s"]:.3f} s; forward_lm '
          f'argmax == served token at {res["greedy_agree"]:.3f}; serve '
          f'launches {launches}; re-score launches {rescore}', flush=True)
    check(toks == requests * LM_MAX_NEW
          and all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          f'{cfg.name}: served {toks} tokens')
    for what, got, want in (('serve', launches, calls * cfg.n_layers),
                            ('re-score', rescore, len(done) * cfg.n_layers)):
        check(got['flash_attention'] == want and sum(got.values()) == want,
              f'{cfg.name}: {what} launched {got}, expected {want} of K8')
    check(res['greedy_agree'] >= LM_AGREE_MIN,
          f'{cfg.name}: forward_lm reproduces {res["greedy_agree"]:.3f} of '
          f'the served tokens')
    return res, launches, rescore


def lm_step_times(cfg, params, dev, nbytes: int, cross_kv=None,
                  batch: int = 1):
    """One decode step of ``batch`` rows at position ``LM_PREFILL`` of an
    ``LM_MAX_SEQ``-slot cache (and a cross family's ``cross_kv``) on
    'auto' (K8) and 'torch': the wall of a synchronized step
    (median of ``LM_STEP_REPS``, the backends in turns), the host's issue
    ms (``host_ms``) and one traced step (``trace``: device busy ms, device
    ops, idle share), beside the bound of the bytes a step must read
    (``nbytes``: every weight but the embedding table, one table row, the
    cache's live rows).  Device time comes from the trace: a step issues
    ~2,600 kernels, more than the launch queue holds, so ``cuda_ms``'s
    queued run would time the host's issue instead."""
    from repro_torch.models import transformer
    tok = torch.ones((batch, 1), dtype=torch.long, device=dev)
    steps = {}
    for backend in ('auto', 'torch'):
        c = cfg.replace(attn_backend=backend)
        cache = transformer.init_cache(c, batch, LM_MAX_SEQ, dev)
        steps[backend] = lambda c=c, cache=cache: transformer.decode_step(
            c, params, cache, tok, LM_PREFILL, cross_kv=cross_kv)
    walls = {b: [] for b in steps}
    for i in range(LM_STEP_REPS):
        for b in (steps if i % 2 == 0 else reversed(list(steps))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[b]()
            torch.cuda.synchronize()
            walls[b].append((time.perf_counter() - t0) * 1e3)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    res = dict(bound_ms=bound_ms, bytes=nbytes)
    for b, fn in steps.items():
        t = trace(fn, f'{cfg.name} decode step [{b}]')
        res[b] = dict(wall_ms=float(np.median(walls[b])),
                      host_issue_ms=host_ms(fn, LM_STEP_REPS),
                      device_busy_ms=t['device_busy_ms'],
                      device_ops=t['device_ops'],
                      idle_share=t['idle_share'], top=t['top'])
    print(f'{cfg.name} decode step (bound {bound_ms:.3f} ms: '
          f'{nbytes / 1e9:.3f} GB at 3.35 TB/s): ' + '; '.join(
              f'{b}: wall {res[b]["wall_ms"]:.3f} ms, host issue '
              f'{res[b]["host_issue_ms"]:.3f} ms, device busy '
              f'{res[b]["device_busy_ms"]:.3f} ms in '
              f'{res[b]["device_ops"]} ops' for b in steps), flush=True)
    return res


def lm_smoke_replay(name: str, dev):
    """``name``'s smoke configuration (bf16 activations, f32 weights,
    seeded) on the card: ``lm_replay`` of ``LM_SMOKE_TOKENS`` tokens."""
    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = configs.get_smoke_config(name)
    params = transformer.init_lm(cfg, torch.Generator(dev).manual_seed(SEED),
                                 dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_SMOKE_TOKENS),
                           generator=torch.Generator(dev).manual_seed(SEED),
                           device=dev)
    return lm_replay(cfg, params, tokens, dev)


def lm_phase(dev):
    """The dense LM family on the card: ``LM_ARCH`` built at full width
    from a seeded CUDA generator (parameters and resident bytes checked
    against its shapes), K8 at its shapes (``lm_attention_cases``), a
    decode replay against ``forward_lm`` on K8 and on the plain attention
    (``lm_replay``), the served main path (``lm_serve``), a decode step's
    times (``lm_step_times``, one step traced a backend); the model freed;
    the serve CLI at full width as a subprocess; and a replay of each
    ``LM_SMOKE`` config at its smoke size.  TF32 is off for all of it and
    bf16 reduced-precision reductions in this process (the flag is
    restored after the phase; the CLI subprocess runs on the defaults)."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        return _lm_phase(dev)
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


def _lm_phase(dev):
    import gc
    import re
    import tempfile
    from repro_torch import configs
    from repro_torch.models import get_bundle
    from repro_torch.tree import leaves
    cfg = configs.get_config(LM_ARCH)
    bundle = get_bundle(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = bundle.param_count(params)
    nbytes = sum(p.numel() * p.element_size() for p in leaves(params))
    peak = torch.cuda.max_memory_allocated(dev) - before
    print(f'{LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, '
          f'{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab '
          f'{cfg.vocab_size}, {cfg.param_dtype}: {n} parameters, {nbytes} '
          f'bytes resident ({nbytes / 1e9:.2f} GB), init {init_s:.2f} s, '
          f'peak {peak / 1e9:.2f} GB', flush=True)
    check(n == lm_param_count(cfg) and all(
        p.dtype == torch.bfloat16 and p.device.type == 'cuda'
        for p in leaves(params)), f'{LM_ARCH}: {n} parameters')
    res = dict(arch=LM_ARCH, params=n, bytes=nbytes, init_s=init_s,
               init_peak_bytes=peak)
    res['attn_cases'] = lm_attention_cases(cfg, params, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_PREFILL),
                           generator=torch.Generator(dev).manual_seed(SEED),
                           device=dev)
    res['replay'] = lm_replay(cfg, params, tokens, dev)
    res['serve'], res['launches'], res['rescore_launches'] = lm_serve(
        cfg, params, dev)
    table = params['embed']['table']
    step_bytes = (nbytes - table.numel() * table.element_size()
                  + cfg.d_model * table.element_size()
                  + 2 * cfg.n_layers * cfg.n_kv_heads * (LM_PREFILL + 1)
                  * cfg.resolved_head_dim * 2)
    res['step'] = lm_step_times(cfg, params, dev, step_bytes)
    del params, table
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = _run_cli('serve qwen3-14b', [
            'repro_torch.launch.serve', '--arch', LM_ARCH, '--requests',
            str(LM_REQUESTS), '--slots', str(LM_SLOTS), '--max-new',
            str(LM_MAX_NEW)], tmp)
    m = re.search(r'served (\d+) requests, (\d+) tokens in ([0-9.]+)s '
                  r'\(([0-9.]+) tok/s\); p50 latency ([0-9.]+)s', out)
    k8 = re.search(r'K8 launches (\d+)', out)
    check(m is not None and k8 is not None and int(m.group(2))
          == LM_REQUESTS * LM_MAX_NEW and int(k8.group(1)) > 0,
          'serve --arch qwen3-14b did not serve on K8')
    res['cli'] = dict(tokens=int(m.group(2)), wall_s=float(m.group(3)),
                      tok_per_s=float(m.group(4)),
                      p50_latency_s=float(m.group(5)),
                      k8_launches=int(k8.group(1)),
                      lines=out.strip().splitlines())
    res['smoke'] = {name: lm_smoke_replay(name, dev) for name in LM_SMOKE}
    return res


# ------------------------------------------------------------- LM training
def train_attn_case(label: str, B: int, H: int, Hkv: int, S: int, D: int,
                    window, dt: str, g, dev, sk=None,
                    causal: bool = True):
    """K8's training kernels on normal data drawn from ``g`` (offset 0; S
    query rows, ``sk`` keys, S when None; ``causal``): the forward with its
    log-sum-exp against ``attention_ref`` (output at ``ATTN_TOL``, lse at
    ``LSE_ATOL``) and the two backward kernels against
    ``attention_bwd_ref`` (max |error| within ``BWD_TOL`` of the
    gradient's scale), from the plain forward's o and lse; each timed
    (CUDA events) beside its plain version, its bound and SDPA (forward,
    and its backward alone from a kept graph).  Returns one case a
    kernel: (forward, dk/dv, dq)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_delta, attention_ref, flash_attention,
        flash_attention_bwd_kv, flash_attention_bwd_q)
    dtype = getattr(torch, dt)
    sk = S if sk is None else sk
    q, do = (torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, sk, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, offset=0)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    o_r, lse_r = attention_ref(q, k, v, return_lse=True, **kw)
    delta = attention_delta(o_r, do)
    args = (q, k, v, do, lse_r, delta)
    dq = flash_attention_bwd_q(*args, **kw)
    dk, dv = flash_attention_bwd_kv(*args, **kw)
    want = attention_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    big = max(S, sk) >= 4096
    reps = 3 if big else 10
    pos = torch.arange(S, device=dev)[:, None]
    key = torch.arange(sk, device=dev)[None, :]
    mask = pos >= key if causal else torch.ones_like(pos >= key)
    if window is not None:
        mask &= (pos - key) < window
    sdpa = lambda *t: F.scaled_dot_product_attention(*t, attn_mask=mask,
                                                     enable_gqa=True)
    lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = sdpa(lq, lk, lv)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (lq, lk, lv), do, retain_graph=True), reps)
    del out
    pairs, keys = _needed(S, sk, 0, window, causal=causal)
    es, n_q, n_kv, rows = q.element_size(), B * H * S * D, B * Hkv, B * H * S
    peak = BF16_FLOPS_PER_S if dt == 'bfloat16' else F32_FLOPS_PER_S
    shape = (f'{label} {dt} B={B} H={H} Hkv={Hkv} S={S} D={D} '
             f'window={window}' + ('' if sk == S else f' Sk={sk}')
             + ('' if causal else ' not causal'))
    plain_bwd_ms = cuda_ms(lambda: attention_bwd_ref(*args, **kw), 1,
                           warmup=1)
    cases = []
    # (name, got, want, tol, ms of a launch, bytes, flops): bytes read and
    # written once, flops 4 D a valid pair forward, 8 D for dk/dv (s, dp,
    # dv, dk) and 6 D for dq (s, dp, dq)
    fwd_err = float((o.float() - o_r.float()).abs().max())
    fin = lse_r > -1e29
    lse_err = float((lse[fin] - lse_r[fin]).abs().max()) if bool(
        fin.any()) else 0.0
    fwd = dict(
        kernel='flash_attention (training, with lse)', shape=shape,
        max_abs_err=fwd_err, lse_max_abs_err=lse_err,
        tol=dict(ATTN_TOL[dt], lse_atol=LSE_ATOL),
        ok=bool(torch.allclose(o.float(), o_r.float(), **ATTN_TOL[dt]))
        and lse_err <= LSE_ATOL and bool(torch.equal(lse[~fin],
                                                     lse_r[~fin])),
        ms=cuda_ms(lambda: flash_attention(q, k, v, return_lse=True, **kw),
                   reps),
        plain_ms=cuda_ms(lambda: attention_ref(q, k, v, return_lse=True,
                                               **kw), 1, warmup=1),
        library_ms=cuda_ms(lambda: sdpa(q, k, v), reps),
        bytes=es * (2 * n_q + 2 * n_kv * keys * D) + 4 * rows,
        flops=4 * D * pairs * B * H)
    cases.append(fwd)
    for name, got, ref, ms, nbytes, flops in (
            ('flash_attention_bwd_kv', (dk, dv), want[1:],
             cuda_ms(lambda: flash_attention_bwd_kv(*args, **kw), reps),
             es * (2 * n_q + 4 * n_kv * keys * D) + 8 * rows,
             8 * D * pairs * B * H),
            ('flash_attention_bwd_q', (dq,), want[:1],
             cuda_ms(lambda: flash_attention_bwd_q(*args, **kw), reps),
             es * (3 * n_q + 2 * n_kv * keys * D) + 8 * rows,
             6 * D * pairs * B * H)):
        errs = [float((a.float() - b.float()).abs().max()) for a, b in
                zip(got, ref)]
        scales = [float(b.float().abs().max()) for b in ref]
        again = (flash_attention_bwd_kv(*args, **kw)
                 if name.endswith('kv') else
                 (flash_attention_bwd_q(*args, **kw),))
        cases.append(dict(
            kernel=name, shape=shape, max_abs_err=max(errs),
            err_over_scale=max(e / s for e, s in zip(errs, scales)),
            tol=dict(rel_to_scale=BWD_TOL[dt]),
            ok=all(e <= BWD_TOL[dt] * s for e, s in zip(errs, scales)),
            deterministic=all(bool(torch.equal(a, b))
                              for a, b in zip(got, again)),
            ms=ms, plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            library='SDPA backward (dq, dk, dv together)', bytes=nbytes,
            flops=flops))
    for c in cases:
        c['pairs'] = pairs * B * H
        # the bound of the arithmetic each kernel runs: the forward's f32
        # on the CUDA cores, the backward's f32 as three TF32 products
        # (3xTF32) on the tensor cores beside the CUDA-core one; bf16 on
        # the bf16 tensor cores
        c['bound_ms'], c['bound_by'] = bound(c['bytes'], c['flops'], peak)
        c['bound_arithmetic'] = 'bf16 tensor cores' if dt == 'bfloat16' \
            else 'f32 CUDA cores'
        if dt == 'float32' and c['kernel'].startswith(
                'flash_attention_bwd'):
            c['bound_f32_cores_ms'] = c['bound_ms']
            c['bound_ms'], c['bound_by'] = bound(c['bytes'], 3 * c['flops'],
                                                 TF32_FLOPS_PER_S)
            c['bound_arithmetic'] = '3xTF32 tensor cores'
        cores = (f", {c['bound_f32_cores_ms']:.4f} ms on the f32 CUDA "
                 f"cores" if 'bound_f32_cores_ms' in c else '')
        print(f"{c['kernel']}: {shape}: max_abs_err {c['max_abs_err']:.3e}"
              + (f" (lse {c['lse_max_abs_err']:.3e})" if 'lse_max_abs_err'
                 in c else f" ({c['err_over_scale']:.3e} of the scale, "
                 f"deterministic {c['deterministic']})")
              + f", kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"library {c['library_ms']:.4f} ms, bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']}, "
              f"{c['bound_arithmetic']}: {c['flops'] / 1e9:.1f} GFLOP, "
              f"{c['bytes'] / 1e6:.1f} MB{cores})", flush=True)
        check(c['ok'] and c.get('deterministic', True),
              f"{c['kernel']} disagrees with its plain version at {shape}")
    return cases


def lm_train_attention(dev):
    """``train_attn_case`` at each ``LM_TRAIN_ATTN`` shape; with SDPA's
    forward + backward beside the sum of K8's three launches."""
    from repro_torch.kernels.flash_attention import attention_bwd_geometry
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for case in LM_TRAIN_ATTN:
        cases = train_attn_case(*case, g, dev)
        _, B, H, Hkv, S, D, window, dt = case
        geom = dataclasses.asdict(attention_bwd_geometry(
            B, H, Hkv, S, S, D, getattr(torch, dt), window, 0, sms))
        for c in cases[1:]:
            c['geometry'] = geom
        print(f'K8 backward schedule {cases[0]["shape"]}: {geom}',
              flush=True)
        total = sum(c['ms'] for c in cases)
        lib = cases[0]['library_ms'] + cases[1]['library_ms']
        print(f'K8 training attention {cases[0]["shape"]}: forward + '
              f'backward {total:.4f} ms (SDPA {lib:.4f} ms)', flush=True)
        out.append(cases)
    return out


def _grad_rel_errors(cfg, params, batch):
    """One batch's gradients on ``cfg.attn_backend`` 'auto' (K8 and its
    backward kernels) and 'torch' (the plain attention), every leaf's
    relative Frobenius error; and the 'auto' run's kernel launches."""
    from repro_torch.launch.train import _grad_leaves, loss_fn_for
    from repro_torch.tree import flatten_with_paths
    kernels = _kernel_counters()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    loss, grads = _grad_leaves(loss_fn_for(cfg), params, batch)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    loss_t, grads_t = _grad_leaves(
        loss_fn_for(cfg.replace(attn_backend='torch')), params, batch)
    rel = {}
    for (path, _), a, b in zip(flatten_with_paths(params), grads, grads_t):
        rel[path] = float(torch.linalg.vector_norm(a - b)
                          / torch.linalg.vector_norm(b))
    return dict(loss=float(loss), loss_torch=float(loss_t), rel=rel,
                worst=max(rel.values()), launches=launches)


def lm_train_run(cfg, dev):
    """The LM's training main path at full width: ``cfg``'s weights drawn
    on the card from a seeded generator (parameters and bytes checked
    against its shapes), one batch's gradients on K8 against the plain
    attention (``_grad_rel_errors``, within ``LM_GRAD_REL``), then
    ``LM_TRAIN_STEPS`` donating ``make_train_step`` steps (AdamW + WSD from
    ``lr_schedule_for``) under ``FaultTolerantRunner`` over ``HostLoader``
    and ``SyntheticLM`` at ``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ``, every
    kernel counter set to 0 just before and read just after: each step's
    loss and gradient norm finite, its wall ms and launches (K8's forward
    twice a layer, its forward and its recompute under remat, and each
    backward kernel once a layer; nothing else), the peak memory; then
    one more step traced (``trace``).  No fault is injected and no
    checkpoint kept (a full-width one is 32.7 GB of host writes), so the
    runner has no ``restore_fn``."""
    import gc
    from repro_torch.data import HostLoader, source_for
    from repro_torch.launch.train import (loss_fn_for, lr_schedule_for,
                                          make_train_step)
    from repro_torch.models import get_bundle
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import FaultTolerantRunner
    from repro_torch.tree import leaves
    from repro_torch import configs
    shape = configs.ShapeConfig('train_4k, batch cut to 2', 'train',
                                LM_TRAIN_SEQ, LM_TRAIN_BATCH)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    bundle = get_bundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = bundle.param_count(params)
    nbytes = sum(p.numel() * p.element_size() for p in leaves(params))
    print(f'{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, '
          f'{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, '
          f'{cfg.param_dtype} weights, {cfg.activation_dtype} activations, '
          f'remat {cfg.remat}: {n} parameters, {nbytes} bytes '
          f'({nbytes / 1e9:.2f} GB), init {init_s:.2f} s', flush=True)
    check(n == lm_param_count(cfg) and nbytes == 4 * n and all(
        p.dtype == torch.float32 and p.device.type == dev.type
        for p in leaves(params)), f'{cfg.name}: {n} parameters')
    res = dict(arch=cfg.name, params=n, bytes=nbytes, init_s=init_s,
               batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
               tokens_per_step=LM_TRAIN_BATCH * LM_TRAIN_SEQ)
    loader = HostLoader(source_for(cfg, shape, seed=SEED), shape, dev)
    _, batch0 = next(loader)
    res['grad_check'] = g = _grad_rel_errors(cfg, params, batch0)
    print(f'{cfg.name} gradients on K8 vs the plain attention: loss '
          f'{g["loss"]:.6f} vs {g["loss_torch"]:.6f}, worst leaf relative '
          f'Frobenius error {g["worst"]:.3e} (tol {LM_GRAD_REL}): '
          + ', '.join(f'{k} {v:.2e}' for k, v in g['rel'].items())
          + f'; launches {g["launches"]}', flush=True)
    check(g['worst'] <= LM_GRAD_REL and np.isfinite(g['loss']),
          f'{cfg.name}: gradients on K8 off the plain attention\'s by '
          f'{g["worst"]:.3e}')
    gc.collect()
    torch.cuda.empty_cache()

    opt = make_optimizer(cfg.optimizer, lr_schedule_for(cfg))
    state = {'params': params, 'opt': opt.init(params),
             'step': torch.zeros((), dtype=torch.int32)}
    resident = sum(t.numel() * t.element_size() for t in leaves(state))
    runner = FaultTolerantRunner(make_train_step(loss_fn_for(cfg), opt,
                                                 donate=True))
    kernels = _kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    steps, before = [], {k.__name__: 0 for k in kernels}
    for _, (step, batch) in zip(range(LM_TRAIN_STEPS), loader):
        t0 = time.perf_counter()
        state, m = runner.run_step(step, state, batch)
        loss, gnorm = float(m['loss']), float(m['grad_norm'])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        now = {k.__name__: k.launches for k in kernels}
        steps.append(dict(step=step, loss=loss, grad_norm=gnorm,
                          wall_ms=wall, launches={
                              k: now[k] - before[k] for k in now}))
        before = now
        print(f'{cfg.name} train step {step}: loss {loss:.6f}, grad norm '
              f'{gnorm:.6f}, {wall:.1f} ms, launches '
              f'{steps[-1]["launches"]}', flush=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    launches = {k.__name__: k.launches for k in kernels}
    L = cfg.n_layers
    want = dict(flash_attention=2 * L, flash_attention_bwd_kv=L,
                flash_attention_bwd_q=L)
    res.update(resident_bytes=resident, peak_bytes=peak, steps=steps,
               launches=launches, events=list(runner.events))
    print(f'{cfg.name}: {LM_TRAIN_STEPS} steps of {LM_TRAIN_BATCH} x '
          f'{LM_TRAIN_SEQ} tokens: resident state {resident / 1e9:.2f} GB '
          f'(parameters and AdamW moments), peak {peak / 1e9:.2f} GB '
          f'above the phase\'s start; launches {launches}', flush=True)
    check(all(np.isfinite([s['loss'], s['grad_norm']]).all()
              for s in steps), f'{cfg.name}: a loss or norm not finite')
    for s in steps:
        check({k: v for k, v in s['launches'].items() if v} == want,
              f'{cfg.name} step {s["step"]}: launches {s["launches"]}, '
              f'expected {want}')
    _, batch = next(loader)
    res['trace'] = trace(lambda: runner.run_step(LM_TRAIN_STEPS, state,
                                                 batch),
                         f'{cfg.name} train step')
    del state, params, runner, batch, batch0, m
    gc.collect()
    torch.cuda.empty_cache()
    return res


def lm_train_resume(dev):
    """``examples.train_lm``'s ``lm_100m`` (8 layers, d_model 512, f32) at
    the example's batch 8 x 256: 4 donating steps straight against 2
    steps, a checkpoint, a restore into a state drawn from another seed
    and 2 more; every leaf of the two final states ``torch.equal``."""
    import tempfile
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import HostLoader, source_for
    from repro_torch.examples.train_lm import lm_100m
    from repro_torch.launch.train import (init_train_state, loss_fn_for,
                                          make_train_step)
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.tree import flatten_with_paths
    cfg = lm_100m()
    shape = configs.ShapeConfig('lm', 'train', 256, 8)
    opt = make_optimizer(cfg.optimizer, cosine_schedule(3e-4, 20, 4))
    step_fn = make_train_step(loss_fn_for(cfg), opt, donate=True)

    def run(state, lo, hi, losses):
        loader = HostLoader(source_for(cfg, shape), shape, dev,
                            start_step=lo)
        for _, (_, batch) in zip(range(lo, hi), loader):
            state, m = step_fn(state, batch)
            losses.append(float(m['loss']))
        return state

    straight, split = [], []
    full = run(init_train_state(cfg, opt, dev, seed=SEED), 0, 4, straight)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(2, run(init_train_state(cfg, opt, dev, seed=SEED), 0, 2,
                        split), blocking=True)
        fresh = init_train_state(cfg, opt, dev, seed=SEED + 1)
        resumed = run(mgr.restore(fresh), 2, 4, split)
    diff = [(path, float((a.double() - b.double()).abs().max()))
            for (path, a), (_, b) in zip(flatten_with_paths(full),
                                         flatten_with_paths(resumed))
            if not torch.equal(a, b)]
    res = dict(arch=cfg.name, losses_straight=straight, losses_resumed=split,
               leaves_differing=diff)
    print(f'{cfg.name} resume: losses straight {straight}, 2 + 2 through a '
          f'checkpoint {split}; leaves differing {diff[:5]}', flush=True)
    check(not diff and straight == split,
          f'{cfg.name}: the resumed run is not bit-equal to the straight '
          f'one ({len(diff)} leaves differ, first {diff[:3]})')
    return res


def lm_train_clis():
    """The train CLI on MiniCPM's smoke configuration (4 steps with
    checkpoints, then ``--resume`` to 6) and ``examples.train_lm --tiny``
    as subprocesses on the card: losses finite, the resume at step 4, and
    K8's forward and backward launched.  The smoke and tiny sizes: a
    full-width MiniCPM-2B's final checkpoint is 32.7 GB of host writes."""
    import re
    import tempfile
    res = {}

    def parse(label, out, steps):
        losses = [float(x) for x in re.findall(r' loss +(\S+)', out)]
        k8 = re.search(r'K8 launches: forward (\d+), backward dk/dv (\d+), '
                       r'dq (\d+)', out)
        check(len(losses) == steps and all(np.isfinite(losses))
              and k8 is not None and min(map(int, k8.groups())) > 0,
              f'{label}: losses {losses}, {k8 and k8.group(0)}')
        res[label] = dict(losses=losses, k8=list(map(int, k8.groups())),
                          lines=out.strip().splitlines()[-4:])

    with tempfile.TemporaryDirectory() as tmp:
        base = ['repro_torch.launch.train', '--arch', LM_TRAIN_ARCH,
                '--smoke', '--batch', '4', '--seq', '256', '--ckpt-every',
                '2', '--log-every', '1', '--ckpt-dir', tmp]
        parse('train --smoke', _run_cli('train minicpm-2b --smoke',
                                        base + ['--steps', '4'], tmp), 4)
        out = _run_cli('train minicpm-2b --smoke --resume',
                       base + ['--steps', '6', '--resume'], tmp)
        check('resumed at step 4' in out, 'train CLI did not resume')
        parse('train --smoke --resume', out, 2)
    with tempfile.TemporaryDirectory() as tmp:
        out = _run_cli('examples.train_lm --tiny', [
            'repro_torch.examples.train_lm', '--tiny', '--steps', '4',
            '--batch', '4', '--seq', '128', '--ckpt-dir', tmp], tmp)
        parse('train_lm --tiny', out, 2)   # it prints steps 0 and 3
    return res


def lm_train_phase(dev):
    """The dense LM trained on the card (after ``lm_phase`` has freed
    Qwen3-14B): K8's training kernels at MiniCPM-2B's and Qwen3-14B's
    shapes (``lm_train_attention``), MiniCPM-2B's main path at full width
    (``lm_train_run``), a bit-equal resume (``lm_train_resume``) and the
    two training entry points as subprocesses (``lm_train_clis``)."""
    from repro_torch import configs
    res = dict(attention=lm_train_attention(dev))
    res['run'] = lm_train_run(configs.get_config(LM_TRAIN_ARCH), dev)
    res['resume'] = lm_train_resume(dev)
    res['cli'] = lm_train_clis()
    return res


# ------------------------------------------------------------------ MoE
def moe_param_count(cfg):
    """(parameters, bytes) of an MoE config from its shapes: per layer
    attention, the f32 router (d, E), three expert matrices of E experts
    and two norms; the untied embedding and unembedding and the final
    norm; every leaf in the parameter dtype but the router."""
    d, hd, m = cfg.d_model, cfg.resolved_head_dim, cfg.moe
    h, hk = cfg.n_heads, cfg.n_kv_heads
    router = d * m.n_experts
    block = (2 * d * h * hd + 2 * d * hk * hd + router
             + 3 * m.n_experts * d * m.d_ff + 2 * d)
    n = 2 * cfg.vocab_size * d + cfg.n_layers * block + d
    es = torch.finfo(cfg.dtype()).bits // 8
    return n, n * es + cfg.n_layers * router * (4 - es)


def _nodrop(cfg):
    """``cfg`` with the no-drop capacity factor E (cap >= every group's
    pairs): the reference's own decode-vs-forward test raises the factor
    so, since a full sequence may drop pairs at capacity and one decoded
    token never does."""
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def _init_on_card(cfg, dev):
    """``bundle.init`` of ``cfg`` from a seeded CUDA generator: (params,
    parameters, resident bytes, init seconds, the peak of allocated memory
    above what was allocated before)."""
    from repro_torch.models import get_bundle
    from repro_torch.tree import leaves
    bundle = get_bundle(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in leaves(params))
    return (params, bundle.param_count(params), nbytes, init_s,
            torch.cuda.max_memory_allocated(dev) - before)


def moe_build(name: str, n_layers: int, dev, card: str):
    """``name`` at full width cut to ``n_layers`` layers (the one cut),
    built by ``bundle.init`` from a seeded CUDA generator; its parameters
    and resident bytes checked against ``moe_param_count``; init seconds
    and peak memory printed.  Returns (cfg, params, numbers)."""
    from repro_torch import configs
    from repro_torch.models import get_bundle
    from repro_torch.tree import leaves
    full = configs.get_config(name)
    cfg = full.replace(n_layers=n_layers)
    bundle = get_bundle(cfg)
    params, n, nbytes, init_s, peak = _init_on_card(cfg, dev)
    want_n, want_bytes = moe_param_count(cfg)
    full_n, full_bytes = moe_param_count(full)
    m = cfg.moe
    print(f'{name}: cut to {n_layers} of {full.n_layers} layers (the one '
          f'cut: {full_n} parameters, {full_bytes / 1e9:.1f} GB at full '
          f'depth, do not fit one card); d_model {cfg.d_model}, '
          f'{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}'
          f', {m.n_experts} experts top-{m.top_k} of d_ff {m.d_ff}, window '
          f'{cfg.sliding_window}, vocab {cfg.vocab_size}, '
          f'{cfg.param_dtype}: {n} parameters '
          f'({bundle.active_param_count(params)} active), {nbytes} bytes '
          f'resident ({nbytes / 1e9:.2f} GB), init {init_s:.2f} s, peak '
          f'{peak / 1e9:.2f} GB [{card}]', flush=True)
    check(n == want_n and nbytes == want_bytes and all(
        p.device == dev for p in leaves(params)),
        f'{name}: {n} parameters, {nbytes} bytes (want {want_n}, '
        f'{want_bytes})')
    return cfg, params, dict(arch=name, layers=n_layers,
                             full_layers=full.n_layers, params=n,
                             active=bundle.active_param_count(params),
                             bytes=nbytes, init_s=init_s,
                             init_peak_bytes=peak)


def moe_attention_cases(cfg, params, dev):
    """K8 against its plain version (``attn_measure``, bf16 ``ATTN_TOL``)
    on q, k, v captured from layer 0 over max(``MOE_RING_POS``) + 1
    seeded tokens: at each ``MOE_RING_POS`` a decode row over a ring of
    the window's W slots filled with that layer's rows (position t in
    slot t % W; ``attention_decode``'s call: no causal mask, kv_len =
    min(pos + 1, W)); the same query against the linear cache of pos + 1
    keys with the window (the same key set; the two K8 outputs also held
    to each other within ``ATTN_TOL``); and the windowed causal prefill of
    the first ``LM_PREFILL`` tokens; each with the schedule it ran."""
    from repro_torch.kernels.flash_attention import (attention_geometry,
                                                     flash_attention)
    from repro_torch.models import layers, transformer
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    W, S = cfg.sliding_window, max(MOE_RING_POS) + 1
    tokens = torch.randint(0, cfg.vocab_size, (1, S), device=dev,
                           generator=torch.Generator(dev).manual_seed(
                               SEED + 1))
    blk = transformer.layer(params, 0)
    x = layers.apply_norm(cfg, blk['ln1'],
                          layers.embed(cfg, params['embed'], tokens))
    cos_sin = layers.rope_cos_sin(torch.arange(S, device=dev),
                                  cfg.resolved_head_dim, cfg.rope_theta)
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in layers._project_qkv(blk['attn'], x, cos_sin))
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cases, tol = [], ATTN_TOL['bfloat16']
    for pos in MOE_RING_POS:
        t = torch.arange(max(0, pos - W + 1), pos + 1, device=dev)
        ring = []
        for a in (k, v):
            r = torch.zeros((1, Hkv, W, D), dtype=a.dtype, device=dev)
            r[:, :, t % W] = a[:, :, t]
            ring.append(r)
        qp = q[:, :, pos:pos + 1].contiguous()
        kv = min(pos + 1, W)
        case = attn_measure(f'{MOE_ARCH} ring decode pos={pos} W={W} '
                            f'bfloat16', qp, *ring, kv_len=kv, causal=False)
        kl, vl = (a[:, :, :pos + 1].contiguous() for a in (k, v))
        lin = attn_measure(f'{MOE_ARCH} linear decode pos={pos} bfloat16',
                           qp, kl, vl, window=W, offset=pos)
        a = flash_attention(qp, *ring, causal=False, kv_len=kv).float()
        b = flash_attention(qp, kl, vl, window=W, offset=pos).float()
        case['ring_vs_linear_max_abs'] = float((a - b).abs().max())
        case['ring_vs_linear_ok'] = bool(torch.allclose(a, b, **tol))
        print(f'flash_attention: {MOE_ARCH} decode pos={pos}: ring of {W} '
              f'slots against the linear cache of {pos + 1} keys with '
              f'window {W} (the same keys): max abs '
              f'{case["ring_vs_linear_max_abs"]:.3e}', flush=True)
        check(case['ring_vs_linear_ok'], f'{MOE_ARCH}: K8 on the ring and '
                                         f'on the linear cache disagree')
        cases += [(case, attention_geometry(1, H, Hkv, 1, W, None, kv, 0,
                                            D, sms, causal=False)),
                  (lin, attention_geometry(1, H, Hkv, 1, pos + 1, W, None,
                                           pos, D, sms))]
    qp, kp, vp = (a[:, :, :LM_PREFILL].contiguous() for a in (q, k, v))
    case = attn_measure(f'{MOE_ARCH} prefill window={W} bfloat16', qp, kp,
                        vp, window=W)
    cases.append((case, attention_geometry(1, H, Hkv, LM_PREFILL,
                                           LM_PREFILL, W, None, 0, D, sms)))
    for case, geom in cases:
        case['geometry'] = dataclasses.asdict(geom)
        _print_attn_case(case, geom)
        check(case['ok'], f'flash_attention disagrees with its plain version '
                          f'at {case["shape"]}')
    return [case for case, _ in cases]


def moe_route_check(cfg, params, dev, n_tokens: int, live_only=False):
    """Layer 0's ``moe_route`` and ``moe_block`` on the card against the
    same calls on a CPU copy of the layer (bf16), x the normed embeddings
    of ``n_tokens`` seeded tokens: top-k experts, keep masks and slots
    equal, the output within ``MOE_OUT_REL`` of its scale, the aux loss
    within 1e-4 of it; the pairs dropped printed.  ``live_only``: the CPU
    copy holds the router and the experts the card's routes use (the
    others left unwritten; ``moe_block`` reads no other)."""
    from repro_torch.models import layers, transformer
    tokens = torch.randint(0, cfg.vocab_size, (1, n_tokens), device=dev,
                           generator=torch.Generator(dev).manual_seed(
                               SEED + 2))
    blk = transformer.layer(params, 0)
    x = layers.apply_norm(cfg, blk['ln2'],
                          layers.embed(cfg, params['embed'], tokens))
    p = blk['moe']
    r = layers.moe_route(cfg, p, x)
    out, ce = layers.moe_block(cfg, p, x)
    card_ms = cuda_ms(lambda: layers.moe_block(cfg, p, x), 3, warmup=1)
    live = layers._live_experts(r.counts)
    pc = {'router': p['router'].cpu()}
    for name in ('w_gate', 'w_up', 'w_down'):
        if live_only:
            pc[name] = torch.empty(p[name].shape, dtype=p[name].dtype)
            for e in live:
                pc[name][e] = p[name][e].cpu()
        else:
            pc[name] = p[name].cpu()
    xc = x.cpu()
    rc = layers.moe_route(cfg, pc, xc)
    t0 = time.perf_counter()
    outc, cec = layers.moe_block(cfg, pc, xc)
    cpu_s = time.perf_counter() - t0
    equal = {f: bool(torch.equal(getattr(r, f).cpu(), getattr(rc, f)))
             for f in ('idx', 'keep', 'slot')}
    scale = float(outc.float().abs().max())
    err = float((out.cpu().float() - outc.float()).abs().max())
    res = dict(tokens=n_tokens, cap=r.cap, pairs=int(r.keep.numel()),
               dropped=int((~r.keep).sum()), live_experts=len(live),
               routes_equal=equal, out_dtype=str(out.dtype),
               out_max_abs=err, out_rel=err / scale, tol_rel=MOE_OUT_REL,
               aux=float(ce), aux_cpu=float(cec), card_ms=card_ms,
               cpu_s=cpu_s, copied='live experts' if live_only else 'all')
    print(f'{cfg.name} moe_block layer 0, {n_tokens} tokens: cap '
          f'{r.cap}, {res["dropped"]} of {res["pairs"]} pairs dropped, '
          f'{len(live)} live experts; routes on the card == CPU: {equal}; '
          f'output {out.dtype} max abs {err:.3e} ({err / scale:.3e} of '
          f'its scale, tol {MOE_OUT_REL}); aux {float(ce):.6f} / '
          f'{float(cec):.6f}; card {card_ms:.3f} ms a call, CPU '
          f'{cpu_s:.2f} s', flush=True)
    check(all(equal.values()), f'{cfg.name}: moe routes on the card differ '
                               f'from the CPU\'s: {equal}')
    check(bool(torch.isfinite(out).all()) and err <= MOE_OUT_REL * scale
          and abs(float(ce) - float(cec)) <= 1e-4 * abs(float(cec)),
          f'{cfg.name}: moe_block on the card strays from the CPU')
    return res


def moe_replay(cfg, params, tokens, dev):
    """``lm_replay`` for an MoE config: ``tokens`` (1, S) through
    ``forward_lm`` and ``decode_step`` on 'auto' (K8) and 'torch', at the
    no-drop capacity factor (``_nodrop``), every MoE call's top-k experts
    recorded.  A row whose expert set differs between the two runs of a
    pair in some layer (a bf16 near-tie in the router: another expert
    moves the row's logits far) is counted apart, at most
    ``MOE_FLIP_MAX`` of the rows (a broken attention would flip most);
    every other row within ``LM_LOGIT_REL`` of the logit scale, every
    logit finite."""
    from unittest import mock
    from repro_torch.models import layers, transformer
    c0 = _nodrop(cfg)
    S, L, k = tokens.shape[1], cfg.n_layers, cfg.moe.top_k
    route, log, out = layers.moe_route, [], {}

    def record(c, p, x):
        r = route(c, p, x)
        log.append(r.idx.reshape(-1, k).sort(-1).values.cpu())
        return r

    with mock.patch.object(layers, 'moe_route', record):
        for backend in ('auto', 'torch'):
            c = c0.replace(attn_backend=backend)
            log.clear()
            full = transformer.forward_lm(c, params, tokens)[0][0].float()
            fwd = torch.stack(log)                      # (L, S, k)
            log.clear()
            cache = transformer.init_cache(c, 1, max(S, LM_MAX_SEQ), dev)
            dec = torch.stack([transformer.decode_step(
                c, params, cache, tokens[:, t:t + 1], t)[0][0, 0].float()
                for t in range(S)])
            drt = torch.stack(log).reshape(S, L, k).transpose(0, 1)
            out[backend] = ((full, fwd), (dec, drt))
    scale = float(out['torch'][0][0].abs().max())
    pairs = {'decode vs forward (K8)': (out['auto'][1], out['auto'][0]),
             'decode vs forward (plain)': (out['torch'][1],
                                           out['torch'][0]),
             'decode: K8 vs plain': (out['auto'][1], out['torch'][1]),
             'forward: K8 vs plain': (out['auto'][0], out['torch'][0])}
    res = dict(tokens=S, logit_scale=scale, tol_rel=LM_LOGIT_REL,
               capacity_factor=c0.moe.capacity_factor,
               finite=all(bool(torch.isfinite(t[0]).all())
                          for p in out.values() for t in p), pairs={})
    for name, ((a, ra), (b, rb)) in pairs.items():
        flipped = (ra != rb).any(-1).any(0)
        kept = ~flipped.to(a.device)
        check(bool(kept.any()), f'{cfg.name}: {name}: every row flipped')
        d = _logit_diff(a[kept], b[kept], scale)
        d['flipped_rows'] = int(flipped.sum())
        d['argmax_agree_all'] = float((a.argmax(-1) == b.argmax(-1)).float()
                                      .mean())
        res['pairs'][name] = d
    print(f'{cfg.name} replay of {S} tokens at capacity factor '
          f'{c0.moe.capacity_factor} (logit scale {scale:.4f}, tol '
          f'{LM_LOGIT_REL} of it on rows whose experts did not flip): '
          + '; '.join(f'{k} {v["rel"]:.3e}, {v["flipped_rows"]} rows '
                      f'flipped (argmax {v["argmax_agree_all"]:.3f})'
                      for k, v in res['pairs'].items()), flush=True)
    check(res['finite'] and all(
        v['rel'] <= LM_LOGIT_REL and v['flipped_rows'] <= MOE_FLIP_MAX * S
        for v in res['pairs'].values()),
        f'{cfg.name}: decode replay outside {LM_LOGIT_REL} of the logit '
        f'scale, too many route flips, or not finite')
    return res


def moe_step_times(cfg, params, dev, card: str):
    """``lm_step_times`` beside two bounds of the bytes a step at position
    ``LM_PREFILL`` must read: every weight but the embedding table and the
    experts, one table row, the cache's live rows, and the top-k experts'
    three matrices a layer (what ``moe_block`` reads: it runs the experts
    that hold a pair) or all E (the reference's (E, cap, d) buffer)."""
    from repro_torch.tree import leaves
    m, es = cfg.moe, 2
    total = sum(p.numel() * p.element_size() for p in leaves(params))
    table = params['embed']['table']
    experts = sum(params['blocks']['moe'][n].numel() * es
                  for n in ('w_gate', 'w_up', 'w_down'))
    base = (total - table.numel() * table.element_size() - experts
            + cfg.d_model * es + 2 * cfg.n_layers * cfg.n_kv_heads
            * (LM_PREFILL + 1) * cfg.resolved_head_dim * es)
    top = base + experts * m.top_k // m.n_experts
    res = lm_step_times(cfg, params, dev, top)
    res['bound_all_ms'] = (base + experts) / HBM_BYTES_PER_S * 1e3
    res['bytes_all'] = base + experts
    print(f'{cfg.name} decode step against its bounds: top-{m.top_k} '
          f'experts read {top / 1e9:.2f} GB, {res["bound_ms"]:.3f} ms; all '
          f'{m.n_experts} read {(base + experts) / 1e9:.2f} GB, '
          f'{res["bound_all_ms"]:.3f} ms; traced device busy '
          f'{res["auto"]["device_busy_ms"]:.3f} ms on K8 (the port reads '
          f'the routed experts only, so the top-{m.top_k} bound is its '
          f'own) [{card}]', flush=True)
    return res


def _moe_clis():
    """``serve --arch <MoE> --smoke`` for both MoE configs as subprocesses
    (Mixtral's smoke window of 16 wraps its ring): tokens served, K8
    launched."""
    import re
    import tempfile
    out = {}
    for name in (MOE_ARCH, KIMI_ARCH):
        with tempfile.TemporaryDirectory() as tmp:
            text = _run_cli(f'serve {name} --smoke', [
                'repro_torch.launch.serve', '--arch', name, '--smoke',
                '--requests', str(LM_REQUESTS), '--slots', str(LM_SLOTS),
                '--max-new', str(LM_MAX_NEW)], tmp)
        m = re.search(r'served (\d+) requests, (\d+) tokens in ([0-9.]+)s '
                      r'\(([0-9.]+) tok/s\); p50 latency ([0-9.]+)s', text)
        k8 = re.search(r'K8 launches (\d+)', text)
        check(m is not None and k8 is not None and int(m.group(2))
              == LM_REQUESTS * LM_MAX_NEW and int(k8.group(1)) > 0,
              f'serve --arch {name} --smoke did not serve on K8')
        out[name] = dict(tokens=int(m.group(2)), wall_s=float(m.group(3)),
                         tok_per_s=float(m.group(4)),
                         k8_launches=int(k8.group(1)),
                         lines=text.strip().splitlines())
    return out


def moe_phase(dev, card: str):
    """The MoE family served on the card (after ``lm_train_phase``): Mixtral
    8x22B at full width cut to ``MOE_LAYERS`` layers, then Kimi-K2 cut to
    ``KIMI_LAYERS`` (``_moe_phase``).  bf16 reduced-precision reductions
    are off in this process for its checks (restored after)."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        return _moe_phase(dev, card)
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


def _moe_phase(dev, card: str):
    import gc
    t0 = time.perf_counter()
    print(f'moe phase on {card}', flush=True)
    res = {}
    cfg, params, mix = moe_build(MOE_ARCH, MOE_LAYERS, dev, card)
    mix['attn_cases'] = moe_attention_cases(cfg, params, dev)
    mix['moe_block'] = moe_route_check(cfg, params, dev, MOE_TOKENS)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_PREFILL), device=dev,
                           generator=torch.Generator(dev).manual_seed(SEED))
    mix['replay'] = moe_replay(cfg, params, tokens, dev)
    mix['serve'], mix['launches'], mix['rescore_launches'] = lm_serve(
        cfg, params, dev, rescore_cfg=_nodrop(cfg))
    mix['step'] = moe_step_times(cfg, params, dev, card)
    res[MOE_ARCH] = mix
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, kimi = moe_build(KIMI_ARCH, KIMI_LAYERS, dev, card)
    kimi['attn_cases'] = lm_attention_cases(cfg, params, dev, KIMI_ARCH)
    kimi['moe_block'] = moe_route_check(cfg, params, dev, KIMI_MOE_TOKENS,
                                        live_only=True)
    kimi['serve'], kimi['launches'], kimi['rescore_launches'] = lm_serve(
        cfg, params, dev, requests=KIMI_REQUESTS, rescore_cfg=_nodrop(cfg))
    kimi['step'] = moe_step_times(cfg, params, dev, card)
    res[KIMI_ARCH] = kimi
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res['cli'] = _moe_clis()
    res['seconds'] = time.perf_counter() - t0
    print(f'moe phase: {res["seconds"]:.1f} s [{card}]', flush=True)
    return res


# ------------------------------------------------ the cross-attention families
def cross_build(name: str, n_layers, dev, card: str):
    """``name`` at full width (cut by depth alone to ``n_layers`` layers
    when given: the one cut), built by ``bundle.init`` from a seeded CUDA
    generator; its parameters and resident bytes checked against
    ``lm_param_count``; init seconds and peak memory printed.  Returns
    (cfg, params, numbers)."""
    from repro_torch import configs
    from repro_torch.tree import leaves
    full = configs.get_config(name)
    cfg = full if n_layers is None else full.replace(n_layers=n_layers)
    params, n, nbytes, init_s, peak = _init_on_card(cfg, dev)
    want_n = lm_param_count(cfg)
    want_bytes = want_n * torch.finfo(cfg.dtype()).bits // 8
    full_n = lm_param_count(full)
    cut = ('nothing cut' if n_layers is None else
           f'cut by depth to {n_layers} of {full.n_layers} layers, the one '
           f'cut ({full_n} parameters, '
           f'{full_n * torch.finfo(cfg.dtype()).bits // 8 / 1e9:.1f} GB at '
           f'full depth, do not fit one card)')
    print(f'{name}: {cut}; {cfg.n_encoder_layers} encoder + '
          f'{cfg.n_layers} decoder layers (cross every '
          f'{cfg.cross_attn_every or 1}), d_model {cfg.d_model}, '
          f'{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}'
          f', d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype} '
          f'weights, {cfg.activation_dtype} activations: {n} parameters, '
          f'{nbytes} bytes resident ({nbytes / 1e9:.3f} GB), init '
          f'{init_s:.2f} s, peak {peak / 1e9:.2f} GB [{card}]', flush=True)
    check(n == want_n and nbytes == want_bytes and all(
        p.device == dev and p.dtype == cfg.dtype() for p in leaves(params)),
        f'{name}: {n} parameters, {nbytes} bytes (want {want_n}, '
        f'{want_bytes})')
    return cfg, params, dict(arch=name, layers=cfg.n_layers,
                             full_layers=full.n_layers, params=n,
                             bytes=nbytes, init_s=init_s,
                             init_peak_bytes=peak)


def _cross_stack(cfg, params):
    """The cross blocks' stack: ``enc_cross`` (audio) or ``cross`` (VLM)."""
    return params['enc_cross' if cfg.n_encoder_layers else 'cross']


def cross_attention_cases(cfg, params, source, dev):
    """K8 against its plain version (``attn_measure``, ``ATTN_TOL`` of the
    inputs' dtype) at a cross family's shapes, on q, k, v from layer 0:
    whisper's bidirectional encoder attention over the F frames (RoPE,
    ``_encoder``'s first layer); the cross prefill of ``CROSS_PREFILL``
    queries (seeded tokens through the first cross block's ``wq``) against
    the first cross layer's K/V of ``precompute_cross_kv``; the cross
    decode row (its first query) against them.  At the VLM's served B the
    decode row takes the tiled schedule (B x H fills the card), so the
    split schedule is also checked at B = 1, and the served row is also
    timed with the split forced (``ms_split_forced``)."""
    from unittest import mock
    from repro_torch.kernels.flash_attention import (attention_geometry,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import layers, transformer
    from repro_torch.tree import tree_map
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, F = source.shape[:2]
    name = cfg.name
    cases = []

    def add(label, q, k, v, causal=False):
        dt = str(q.dtype).split('.')[-1]
        case = attn_measure(f'{name} {label} {dt}', q, k, v, causal=causal)
        geom = attention_geometry(q.shape[0], H, Hkv, q.shape[2], k.shape[2],
                                  None, None, 0, D, sms, causal=causal,
                                  wide=dt == 'bfloat16')
        cases.append((case, geom))
        return case

    if cfg.n_encoder_layers:
        blk = tree_map(lambda a: a[0], params['enc_blocks'])
        x = layers.apply_norm(cfg, blk['ln1'], source.to(cfg.adtype()))
        cos_sin = layers.rope_cos_sin(torch.arange(F, device=dev),
                                      D, cfg.rope_theta)
        q, k, v = (t.transpose(1, 2).contiguous()
                   for t in layers._project_qkv(blk['attn'], x, cos_sin))
        add(f'encoder F={F}', q, k, v)
        del q, k, v, x
    kv = transformer.precompute_cross_kv(cfg, params, source)
    k, v = kv['k'][0], kv['v'][0]
    xblk = tree_map(lambda a: a[0], _cross_stack(cfg, params))
    tokens = torch.randint(0, cfg.vocab_size, (B, CROSS_PREFILL), device=dev,
                           generator=torch.Generator(dev).manual_seed(
                               SEED + 4))
    x = layers.apply_norm(cfg, xblk['ln1'],
                          layers.embed(cfg, params['embed'], tokens))
    q = layers._project_q(xblk['attn'], x).transpose(1, 2).contiguous()
    check(q.dtype == k.dtype, f'{name}: cross q {q.dtype}, K/V {k.dtype}')
    add(f'cross prefill F={F}', q, k, v)
    q1 = q[:, :, :1].contiguous()
    case = add(f'cross decode F={F}', q1, k, v)
    if cases[-1][1].path != 'split':
        orig = fa_kernel.attention_geometry
        # every other argument as flash_attention passes it; an SM count
        # no grid reaches makes the rule take its split schedule
        forced = lambda *a, **kw: orig(*a[:9], 1 << 20, **kw)
        with mock.patch.object(fa_kernel, 'attention_geometry', forced):
            got = flash_attention(q1, k, v, causal=False).float()
            case['ms_split_forced'] = cuda_ms(
                lambda: flash_attention(q1, k, v, causal=False), 20)
        case['split_forced_ok'] = bool(torch.allclose(
            got, flash_attention(q1, k, v, causal=False).float(),
            **ATTN_TOL[str(q.dtype).split('.')[-1]]))
        print(f'flash_attention: {name} cross decode B={B}: tiled '
              f'{case["ms"]:.4f} ms, split forced '
              f'{case["ms_split_forced"]:.4f} ms (agree: '
              f'{case["split_forced_ok"]})', flush=True)
        check(case['split_forced_ok'], f'{name}: forced split disagrees')
        add(f'cross decode F={F}', q1[:1].contiguous(), k[:1].contiguous(),
            v[:1].contiguous())
    for case, geom in cases:
        case['geometry'] = dataclasses.asdict(geom)
        _print_attn_case(case, geom)
        check(case['ok'], f'flash_attention disagrees with its plain version '
                          f'at {case["shape"]}')
    return [case for case, _ in cases]


def cross_precompute(cfg, params, source):
    """``precompute_cross_kv`` at f32 activations on 'auto' (K8 runs the
    encoder) against 'torch', within the f32 ``ATTN_TOL``; K8's launches
    on 'auto' (one an encoder layer, none for the VLM)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer
    c = cfg.replace(activation_dtype='float32')
    torch.cuda.synchronize()
    n0 = flash_attention.launches
    got = transformer.precompute_cross_kv(c, params, source)
    torch.cuda.synchronize()
    launches = flash_attention.launches - n0
    want = transformer.precompute_cross_kv(c.replace(attn_backend='torch'),
                                           params, source)
    err = max(float((got[n] - want[n]).abs().max()) for n in ('k', 'v'))
    ok = all(torch.allclose(got[n], want[n], **ATTN_TOL['float32'])
             for n in ('k', 'v'))
    res = dict(shape=list(got['k'].shape), dtype=str(got['k'].dtype),
               max_abs_err=err, tol=ATTN_TOL['float32'], ok=ok,
               launches=launches)
    print(f'{cfg.name} precompute_cross_kv (f32 activations): K/V '
          f'{tuple(got["k"].shape)} {got["k"].dtype}, K8 against plain '
          f'max abs {err:.3e} (tol {ATTN_TOL["float32"]}), K8 launches '
          f'{launches}', flush=True)
    check(ok and launches == cfg.n_encoder_layers,
          f'{cfg.name}: precompute_cross_kv {res}')
    return res


def cross_generate(cfg, params, source, prompts):
    """The cross families' serving path: ``precompute_cross_kv`` of the
    batch's sources once, the prompts (B, P) fed token by token through
    ``decode_step(cross_kv=)``, then ``CROSS_MAX_NEW`` greedy tokens a
    request (the argmax stays on the card).  Returns (the tokens (B,
    CROSS_MAX_NEW), every decode call's logits (B, P + CROSS_MAX_NEW - 1,
    V), the decode calls)."""
    from repro_torch.models import transformer
    B, P = prompts.shape
    calls = P + CROSS_MAX_NEW - 1
    kv = transformer.precompute_cross_kv(cfg, params, source)
    cache = transformer.init_cache(cfg, B, calls, source.device)
    rows, out, tok = [], [], prompts[:, :1]
    for t in range(calls):
        logits, cache = transformer.decode_step(cfg, params, cache, tok, t,
                                                cross_kv=kv)
        rows.append(logits[:, 0])
        if t + 1 < P:
            tok = prompts[:, t + 1:t + 2]
        else:
            tok = logits[:, 0].argmax(-1, keepdim=True)
            out.append(tok)
    return torch.cat(out, 1), torch.stack(rows, 1), calls


def _cross_prompts(cfg, B: int, dev):
    return torch.randint(1, cfg.vocab_size, (B, CROSS_PROMPT), device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED + 5))


def cross_contract(cfg, params, source, dev):
    """The reference's own contract (``tests/test_models.py``) on the card
    at full width: with f32 activations, ``cross_generate``'s every logit
    row within ``CROSS_F32_REL`` of the logit scale of ``forward_lm(tokens,
    source)`` on the same tokens."""
    from repro_torch.models import transformer
    c = cfg.replace(activation_dtype='float32')
    prompts = _cross_prompts(cfg, source.shape[0], dev)
    out, rows, _ = cross_generate(c, params, source, prompts)
    seq = torch.cat([prompts, out[:, :-1]], 1)
    full = transformer.forward_lm(c, params, seq, source)[0].float()
    d = _logit_diff(rows.float(), full, float(full.abs().max()))
    d.update(tol_rel=CROSS_F32_REL, tokens=list(seq.shape),
             finite=bool(torch.isfinite(rows).all()))
    print(f'{cfg.name} decode == forward at f32 activations over '
          f'{tuple(seq.shape)} tokens: max abs {d["max_abs"]:.3e} = '
          f'{d["rel"]:.3e} of the logit scale (tol {CROSS_F32_REL}), argmax '
          f'{d["argmax_agree"]:.3f}', flush=True)
    check(d['finite'] and d['rel'] <= CROSS_F32_REL,
          f'{cfg.name}: decode strays from forward at f32: {d}')
    return d


def cross_serve(cfg, params, source, dev):
    """A cross family's main path at its own activation dtype, every kernel
    counter set to 0 just before and read just after: ``cross_generate``
    of ``CROSS_BATCH`` requests (one source each; prompts of
    ``CROSS_PROMPT`` seeded tokens, ``CROSS_MAX_NEW`` greedy tokens each).
    K8 must launch once a self and a cross layer a decode call, plus once
    an encoder layer for the precompute, and no other kernel at all.
    Then, counted apart, each sequence re-scored by ``forward_lm``: every
    served logit row within ``LM_LOGIT_REL`` of the logit scale, the
    argmax reproducing the served tokens at a share of at least
    ``LM_AGREE_MIN``.  Returns (numbers, the serve's launches by kernel,
    the re-score's)."""
    from repro_torch.models import transformer
    B = source.shape[0]
    prompts = _cross_prompts(cfg, B, dev)
    kernels = _kernel_counters()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out, rows, calls = cross_generate(cfg, params, source, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    seq = torch.cat([prompts, out[:, :-1]], 1)
    full = transformer.forward_lm(cfg, params, seq, source)[0]
    torch.cuda.synchronize()
    rescore = {k.__name__: k.launches - launches[k.__name__]
               for k in kernels}
    P = prompts.shape[1]
    d = _logit_diff(rows.float(), full.float(), float(full.float().abs()
                                                      .max()))
    agree = float((full[:, P - 1:].argmax(-1) == out).float().mean())
    layers_a_call = transformer.n_self_layers(cfg) + (
        cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every
        else cfg.n_layers)
    toks = int(out.numel())
    res = dict(requests=B, tokens=toks, decode_calls=calls, wall_s=wall,
               tok_per_s=toks / wall, p50_latency_s=wall,
               ms_per_decode_call=wall / calls * 1e3, greedy_agree=agree,
               rows_vs_forward=d, tol_rel=LM_LOGIT_REL,
               outputs=out.cpu().tolist())
    print(f'{cfg.name} served: {B} requests (one source each), {toks} '
          f'tokens in {wall:.3f} s ({res["tok_per_s"]:.2f} tok/s, '
          f'{res["ms_per_decode_call"]:.3f} ms a decode call over {calls} '
          f'calls, precompute_cross_kv included); p50 latency {wall:.3f} s '
          f'(the requests decode together); rows vs forward_lm '
          f'{d["rel"]:.3e} of the logit scale (tol {LM_LOGIT_REL}), argmax '
          f'== served token at {agree:.3f}; serve launches {launches}; '
          f're-score launches {rescore}', flush=True)
    check(toks == B * CROSS_MAX_NEW and bool(torch.isfinite(rows).all())
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f'{cfg.name}: served {toks} tokens')
    for what, got, want in (
            ('serve', launches,
             calls * layers_a_call + cfg.n_encoder_layers),
            ('re-score', rescore, layers_a_call + cfg.n_encoder_layers)):
        check(got['flash_attention'] == want and sum(got.values()) == want,
              f'{cfg.name}: {what} launched {got}, expected {want} of K8')
    check(d['rel'] <= LM_LOGIT_REL and agree >= LM_AGREE_MIN,
          f'{cfg.name}: forward_lm re-score {d}, argmax {agree:.3f}')
    return res, launches, rescore


def cross_step_times(cfg, params, source, dev, card: str):
    """``lm_step_times`` of ``CROSS_BATCH`` rows with the sources' cross
    K/V, beside the bound of the bytes a step must read: the decoder's
    self blocks, its cross blocks without ``wk``/``wv`` (the cross K/V
    are precomputed), the final norm and the unembedding (the encoder and
    the embedding table but B rows are not read), the cross K/V and the
    cache's live rows."""
    from repro_torch.models import transformer
    from repro_torch.tree import flatten_with_paths
    kv = transformer.precompute_cross_kv(cfg, params, source)
    B = source.shape[0]
    cross = "['enc_cross']" if cfg.n_encoder_layers else "['cross']"
    weights = sum(
        a.numel() * a.element_size() for path, a in flatten_with_paths(params)
        if not path.startswith(("['enc_blocks']", "['enc_norm']",
                                "['embed']['table']"))
        and not (path.startswith(cross) and path.endswith(("['wk']",
                                                           "['wv']"))))
    table = params['embed']['table']
    kv_bytes = sum(a.numel() * a.element_size() for a in kv.values())
    es = torch.finfo(cfg.adtype()).bits // 8
    cache = (2 * transformer.n_self_layers(cfg) * B * cfg.n_kv_heads
             * (LM_PREFILL + 1) * cfg.resolved_head_dim * es)
    nbytes = weights + B * cfg.d_model * table.element_size() + kv_bytes \
        + cache
    res = lm_step_times(cfg, params, dev, nbytes, cross_kv=kv, batch=B)
    res.update(weight_bytes=weights, cross_kv_bytes=kv_bytes,
               cache_bytes=cache)
    print(f'{cfg.name} decode step of {B} rows against its bound: weights '
          f'{weights / 1e6:.1f} MB, cross K/V {kv_bytes / 1e6:.1f} MB, '
          f'cache rows {cache / 1e6:.2f} MB: {res["bound_ms"]:.4f} ms; '
          f'traced device busy {res["auto"]["device_busy_ms"]:.4f} ms on K8, '
          f'{res["torch"]["device_busy_ms"]:.4f} ms plain [{card}]',
          flush=True)
    return res


def cross_phase(dev, card: str):
    """The cross-attention families served on the card (after
    ``moe_phase``): whisper-base at full width and depth, then
    Llama-3.2-Vision-90B at full width cut to ``CROSS_VLM_LAYERS`` layers
    (``_cross_phase``).  bf16 reduced-precision reductions are off in this
    process for its checks (restored after)."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        return _cross_phase(dev, card)
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


def _cross_source(cfg, dev):
    """``CROSS_BATCH`` seeded f32 sources (B, F, d): the stub frontend's
    frames or patches."""
    return torch.randn((CROSS_BATCH, cfg.n_source_tokens, cfg.d_model),
                       device=dev,
                       generator=torch.Generator(dev).manual_seed(SEED + 3))


def _cross_phase(dev, card: str):
    import gc
    t0 = time.perf_counter()
    print(f'cross phase on {card}', flush=True)
    res = {}
    cfg, params, w = cross_build(CROSS_AUDIO, None, dev, card)
    source = _cross_source(cfg, dev)
    w['attn_cases'] = cross_attention_cases(cfg, params, source, dev)
    w['precompute'] = cross_precompute(cfg, params, source)
    w['contract'] = cross_contract(cfg, params, source, dev)
    w['serve'], w['launches'], w['rescore_launches'] = cross_serve(
        cfg, params, source, dev)
    w['step'] = cross_step_times(cfg, params, source, dev, card)
    res[CROSS_AUDIO] = w
    del params, source
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, v = cross_build(CROSS_VLM, CROSS_VLM_LAYERS, dev, card)
    check(v['init_peak_bytes'] <= CROSS_PEAK_MAX,
          f'{CROSS_VLM}: init peak {v["init_peak_bytes"]} bytes')
    source = _cross_source(cfg, dev)
    v['attn_cases'] = cross_attention_cases(cfg, params, source, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_PREFILL), device=dev,
                           generator=torch.Generator(dev).manual_seed(SEED))
    v['replay'] = lm_replay(cfg, params, tokens, dev, source=source[:1])
    v['serve'], v['launches'], v['rescore_launches'] = cross_serve(
        cfg, params, source, dev)
    v['step'] = cross_step_times(cfg, params, source, dev, card)
    res[CROSS_VLM] = v
    del params, source
    gc.collect()
    torch.cuda.empty_cache()
    res['seconds'] = time.perf_counter() - t0
    print(f'cross phase: {res["seconds"]:.1f} s [{card}]', flush=True)
    return res


# ---------------------------------------------------- the recurrent families
def recurrent_build(name: str, dev, card: str):
    """``name`` at full width and depth, built by ``bundle.init`` from a
    seeded CUDA generator: its parameters checked against the reference's
    count (``RECURRENT_PARAMS``), every leaf f32 on the card; init seconds
    and peak memory printed.  Returns (cfg, params, numbers)."""
    from repro_torch import configs
    from repro_torch.tree import leaves
    cfg = configs.get_config(name)
    params, n, nbytes, init_s, peak = _init_on_card(cfg, dev)
    print(f'{name}: nothing cut; {cfg.n_layers} layers, d_model '
          f'{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab '
          f'{cfg.vocab_size}, {cfg.param_dtype} weights, '
          f'{cfg.activation_dtype} activations: {n} parameters (want '
          f'{RECURRENT_PARAMS[name]}), {nbytes} bytes resident '
          f'({nbytes / 1e9:.3f} GB), init {init_s:.2f} s, peak '
          f'{peak / 1e9:.2f} GB [{card}]', flush=True)
    check(n == RECURRENT_PARAMS[name] and nbytes == 4 * n and all(
        p.device == dev and p.dtype == torch.float32
        for p in leaves(params)), f'{name}: {n} parameters, {nbytes} bytes')
    return cfg, params, dict(arch=name, layers=cfg.n_layers, params=n,
                             bytes=nbytes, init_s=init_s,
                             init_peak_bytes=peak)


def hymba_attention_cases(cfg, params, dev):
    """K8 against its plain version (``attn_measure``) at Hymba's shapes,
    on q, k, v of its own layers over seeded tokens behind the 128 meta
    tokens, RoPE at their positions: the causal prefill of 128 +
    ``HYMBA_PREFILL`` rows on global layer 0 and the causal forward of
    128 + ``HYMBA_FORWARD`` rows on layer 1 with its window of 1,024, both
    f32 as the model runs them (the f32 norm scales promote the bf16
    activations); then the decode rows as ``attention_decode`` calls K8
    (q rounded to the cache's bf16, kv_len, no causal mask): the last
    forward row against layer 1's full ring of 1,024 slots, and row
    ``HYMBA_GLOBAL_FILL`` - 1 against layer 0's 128-slot cache holding
    ``HYMBA_GLOBAL_FILL`` tokens.  Each with its schedule."""
    from repro_torch.kernels.flash_attention import attention_geometry
    from repro_torch.models import layers
    from repro_torch.models.recurrent import N_META
    from repro_torch.tree import tree_map
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    tokens = torch.randint(0, cfg.vocab_size, (1, HYMBA_FORWARD), device=dev,
                           generator=torch.Generator(dev).manual_seed(
                               SEED + 6))
    x = layers.embed(cfg, params['embed'], tokens)
    x = torch.cat([params['meta'].to(x.dtype)[None], x], 1)
    n = x.shape[1]
    cos, sin = layers.rope_cos_sin(torch.arange(n, device=dev), D,
                                   cfg.rope_theta)

    def qkv(layer: int, rows: int):
        blk = tree_map(lambda a: a[layer], params['blocks'])
        h = layers.apply_norm(cfg, blk['ln1'], x[:, :rows])
        return [t.transpose(1, 2).contiguous() for t in layers._project_qkv(
            blk['attn'], h, (cos[:rows], sin[:rows]))]

    def ring(k, t, slots):
        out = k.new_zeros((1, Hkv, slots, D), dtype=torch.bfloat16)
        out[:, :, t % slots] = k[:, :, t].to(torch.bfloat16)
        return out

    cases = []

    def add(label, q, k, v, window=None, kv_len=None):
        dt = str(q.dtype).split('.')[-1]
        causal = kv_len is None
        case = attn_measure(f'{cfg.name} {label} {dt}', q, k, v,
                            window=window, kv_len=kv_len, causal=causal)
        cases.append((case, attention_geometry(
            1, H, Hkv, q.shape[2], k.shape[2], window, kv_len, 0, D, sms,
            causal=causal, wide=dt == 'bfloat16')))

    q, k, v = qkv(0, N_META + HYMBA_PREFILL)
    check(q.dtype == torch.float32, f'{cfg.name}: q is {q.dtype}')
    add(f'prefill {N_META}+{HYMBA_PREFILL}', q, k, v)
    fill = HYMBA_GLOBAL_FILL
    t = torch.arange(fill, device=dev)
    glob = (q[:, :, fill - 1:fill].to(torch.bfloat16),
            ring(k, t, LM_MAX_SEQ), ring(v, t, LM_MAX_SEQ))
    q, k, v = qkv(1, n)
    W = cfg.sliding_window
    add(f'windowed forward {N_META}+{HYMBA_FORWARD}', q, k, v, window=W)
    t = torch.arange(n - W, n, device=dev)
    add(f'decode ring of {W} at position {n - 1}',
        q[:, :, n - 1:].to(torch.bfloat16), ring(k, t, W), ring(v, t, W),
        kv_len=W)
    add(f'decode global {LM_MAX_SEQ} slots at position {fill - 1}', *glob,
        kv_len=fill)
    for case, geom in cases:
        case['geometry'] = dataclasses.asdict(geom)
        _print_attn_case(case, geom)
        check(case['ok'], f'flash_attention disagrees with its plain version '
                          f'at {case["shape"]}')
    return [case for case, _ in cases]


def _recurrent_decode(cfg, params, tokens, dev):
    """The bundle's ``decode_step`` over ``tokens`` (1, S) from an empty
    cache (``LM_MAX_SEQ`` slots): every logit row (S, V), f32."""
    from repro_torch.models import get_bundle
    b = get_bundle(cfg)
    cache = b.init_cache(1, LM_MAX_SEQ, dev)
    rows = []
    for t in range(tokens.shape[1]):
        logits, cache = b.decode_step(params, cache, tokens[:, t:t + 1], t)
        rows.append(logits[0, 0].float())
    return torch.stack(rows)


def xlstm_contract(cfg, params, tokens, dev):
    """The reference's own contract (``tests/test_models.py``) on the card
    at full width: with f32 activations, ``decode_step`` token by token
    from ``init_xlstm_state`` equals ``forward_xlstm`` within
    ``CROSS_F32_REL`` (the reference's 2e-3) of the logit scale."""
    from repro_torch.models import get_bundle
    c = cfg.replace(activation_dtype='float32')
    dec = _recurrent_decode(c, params, tokens, dev)
    full = get_bundle(c).forward(params, {'tokens': tokens})[0].float()
    d = _logit_diff(dec, full, float(full.abs().max()))
    d.update(tol_rel=CROSS_F32_REL, tokens=tokens.shape[1],
             finite=bool(torch.isfinite(dec).all()))
    print(f'{cfg.name} decode == forward at f32 activations over '
          f'{tokens.shape[1]} tokens: max abs {d["max_abs"]:.3e} = '
          f'{d["rel"]:.3e} of the logit scale (tol {CROSS_F32_REL}), argmax '
          f'{d["argmax_agree"]:.3f}', flush=True)
    check(d['finite'] and d['rel'] <= CROSS_F32_REL,
          f'{cfg.name}: decode strays from forward at f32: {d}')
    return d


def hymba_replay(cfg, params, tokens, dev):
    """Hymba's decode over ``tokens`` (1, S) from an empty cache and its
    forward, each on 'auto' (K8) and 'torch' (the plain attention), at its
    own bf16 activations: decode K8 against plain and forward K8 against
    plain, each within ``LM_LOGIT_REL`` of the plain run's logit scale,
    every logit finite.  Decode is not held to forward (R5: no meta token
    reaches the reference's caches or Mamba state); their gap is
    printed."""
    from repro_torch.models import get_bundle
    out = {}
    for backend in ('auto', 'torch'):
        c = cfg.replace(attn_backend=backend)
        out[backend] = (_recurrent_decode(c, params, tokens, dev),
                        get_bundle(c).forward(params,
                                              {'tokens': tokens})[0].float())
    pairs = {'decode: K8 vs plain': (out['auto'][0], out['torch'][0]),
             'forward: K8 vs plain': (out['auto'][1], out['torch'][1])}
    res = dict(tokens=tokens.shape[1], tol_rel=LM_LOGIT_REL,
               finite=all(bool(torch.isfinite(t).all())
                          for p in out.values() for t in p),
               pairs={k: _logit_diff(a, b, float(b.abs().max()))
                      for k, (a, b) in pairs.items()},
               r5_decode_vs_forward=_logit_diff(
                   out['torch'][0], out['torch'][1],
                   float(out['torch'][1].abs().max())))
    print(f'{cfg.name} replay of {tokens.shape[1]} tokens (tol '
          f'{LM_LOGIT_REL} of the logit scale): ' + '; '.join(
              f'{k} {v["rel"]:.3e} (argmax {v["argmax_agree"]:.3f})'
              for k, v in res['pairs'].items())
          + f'; R5, decode vs forward (plain): '
            f'{res["r5_decode_vs_forward"]["rel"]:.3f} of the scale, argmax '
            f'{res["r5_decode_vs_forward"]["argmax_agree"]:.3f}', flush=True)
    check(res['finite'] and all(v['rel'] <= LM_LOGIT_REL
                                for v in res['pairs'].values()),
          f'{cfg.name}: K8 strays from the plain attention: {res}')
    return res


def recurrent_serve(cfg, params, dev, card: str):
    """A recurrent family's main path, with every kernel counter set to 0
    just before and read just after: ``LM_REQUESTS`` seeded prompts of 3-7
    tokens served through ``SlotServer`` (``LM_SLOTS`` slots of
    ``LM_MAX_SEQ`` positions, ``LM_MAX_NEW`` tokens each), the reference's
    ``_run_token_serving``.  K8 must launch once a layer a decode call for
    Hymba and never for xLSTM, and no other kernel at all.  xLSTM's served
    sequences are then re-scored by ``forward_xlstm`` (counted apart:
    nothing launched), its argmax reproducing at least ``LM_AGREE_MIN`` of
    the served tokens; Hymba's decode is not its forward (R5), so it has
    no re-score.  Returns (numbers, the serve's launches by kernel, the
    re-score's)."""
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models import get_bundle
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, size=rng.randint(3, 8)).tolist()
               for _ in range(LM_REQUESTS)]
    kernels = _kernel_counters()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    server = SlotServer(cfg, params, num_slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    for r, prompt in enumerate(prompts):
        server.submit(Request(rid=r, prompt=prompt, max_new=LM_MAX_NEW))
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    done = sorted(server.done, key=lambda r: r.rid)
    hymba = cfg.family == 'hybrid'
    agree = []
    if not hymba:
        fwd = get_bundle(cfg).forward
        for r in done:
            seq = torch.tensor([r.prompt + r.out[:-1]], device=dev)
            best = fwd(params, {'tokens': seq})[0][len(r.prompt) - 1:]
            agree += (best.argmax(-1).cpu().numpy() == np.array(r.out)
                      ).tolist()
    torch.cuda.synchronize()
    rescore = {k.__name__: k.launches - launches[k.__name__]
               for k in kernels}
    toks = sum(len(r.out) for r in done)
    calls = sum(len(r.prompt) + len(r.out) - 1 for r in done)
    lat = [r.t_done - r.t_enqueue for r in done]
    res = dict(requests=len(done), tokens=toks, decode_calls=calls,
               wall_s=wall, tok_per_s=toks / wall,
               p50_latency_s=float(np.median(lat)),
               ms_per_decode_call=wall / calls * 1e3,
               greedy_agree=float(np.mean(agree)) if agree else None,
               outputs={r.rid: r.out for r in done})
    print(f'{cfg.name} SlotServer: {len(done)} requests, {toks} tokens in '
          f'{wall:.2f} s ({res["tok_per_s"]:.2f} tok/s, '
          f'{res["ms_per_decode_call"]:.2f} ms a decode call over {calls} '
          f'calls); p50 latency {res["p50_latency_s"]:.3f} s; '
          + ('no re-score (R5)' if hymba else
             f'forward_xlstm argmax == served token at '
             f'{res["greedy_agree"]:.3f}')
          + f'; serve launches {launches}; re-score launches {rescore} '
            f'[{card}]', flush=True)
    check(toks == LM_REQUESTS * LM_MAX_NEW
          and all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          f'{cfg.name}: served {toks} tokens')
    want = calls * cfg.n_layers if hymba else 0
    check(launches['flash_attention'] == want
          and sum(launches.values()) == want and sum(rescore.values()) == 0,
          f'{cfg.name}: serve launched {launches}, expected {want} of K8; '
          f're-score {rescore}')
    check(hymba or res['greedy_agree'] >= LM_AGREE_MIN,
          f'{cfg.name}: forward reproduces {res["greedy_agree"]} of the '
          f'served tokens')
    return res, launches, rescore


def recurrent_step_times(cfg, params, dev, card: str):
    """One decode step at B = 1 (``SlotServer``'s) at position
    ``LM_PREFILL``, on 'auto' and 'torch' for Hymba (xLSTM has no
    attention: 'auto' alone): the wall of a synchronized step (median of
    ``LM_STEP_REPS``, the backends in turns), the host's issue ms and one
    traced step (device busy ms, ops, idle share), beside the bound of the
    bytes the step must move: every weight but the embedding table, one
    table row; xLSTM's recurrent state read and written (the 42 mLSTM
    memories: 1.41 GB); Hymba's live K/V rows read (``LM_PREFILL`` + 1 of
    each ring) and its conv and ssm states read and written."""
    from repro_torch.models import get_bundle
    from repro_torch.tree import leaves
    size = lambda ts: sum(a.numel() * a.element_size() for a in ts)
    tok = torch.ones((1, 1), dtype=torch.long, device=dev)
    table = params['embed']['table']
    weights = size(leaves(params)) - size([table]) \
        + cfg.d_model * table.element_size()
    steps, state_bytes = {}, 0
    backends = ('auto', 'torch') if cfg.family == 'hybrid' else ('auto',)
    for backend in backends:
        c = cfg.replace(attn_backend=backend)
        b = get_bundle(c)
        cache = b.init_cache(1, LM_MAX_SEQ, dev)
        steps[backend] = lambda b=b, cache=cache: b.decode_step(
            params, cache, tok, LM_PREFILL)
        _, cache = steps[backend]()
        if cfg.family == 'hybrid':
            es = torch.finfo(cfg.adtype()).bits // 8
            state_bytes = sum(
                2 * cfg.n_kv_heads * min(LM_PREFILL + 1, lc['k'].shape[2])
                * cfg.resolved_head_dim * es
                + 2 * size([lc['conv'], lc['ssm']]) for lc in cache)
        else:
            state_bytes = 2 * size(leaves(cache))
    walls = {b: [] for b in steps}
    for i in range(LM_STEP_REPS):
        for b in (steps if i % 2 == 0 else reversed(list(steps))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[b]()
            torch.cuda.synchronize()
            walls[b].append((time.perf_counter() - t0) * 1e3)
    nbytes = weights + state_bytes
    res = dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
               weight_bytes=weights, state_bytes=state_bytes)
    for b, fn in steps.items():
        t = trace(fn, f'{cfg.name} decode step [{b}]')
        res[b] = dict(wall_ms=float(np.median(walls[b])),
                      host_issue_ms=host_ms(fn, LM_STEP_REPS),
                      device_busy_ms=t['device_busy_ms'],
                      device_ops=t['device_ops'],
                      idle_share=t['idle_share'], top=t['top'])
    print(f'{cfg.name} decode step (bound {res["bound_ms"]:.3f} ms: weights '
          f'{weights / 1e9:.3f} GB, state {state_bytes / 1e9:.4f} GB at 3.35 '
          f'TB/s): ' + '; '.join(
              f'{b}: wall {res[b]["wall_ms"]:.3f} ms, host issue '
              f'{res[b]["host_issue_ms"]:.3f} ms, device busy '
              f'{res[b]["device_busy_ms"]:.3f} ms in {res[b]["device_ops"]} '
              f'ops, idle {res[b]["idle_share"]:.3f}' for b in steps)
          + f' [{card}]', flush=True)
    return res


def _recurrent_clis():
    """``serve --arch xlstm-1.3b`` and ``--arch hymba-1.5b`` at full width
    and depth on the card as subprocesses (``RECURRENT_CLI_REQUESTS``
    requests of ``RECURRENT_CLI_MAX_NEW`` tokens): tokens served, K8
    launched for Hymba and never for xLSTM."""
    import re
    import tempfile
    out = {}
    for name in (XLSTM_ARCH, HYMBA_ARCH):
        with tempfile.TemporaryDirectory() as tmp:
            text = _run_cli(f'serve {name}', [
                'repro_torch.launch.serve', '--arch', name, '--requests',
                str(RECURRENT_CLI_REQUESTS), '--slots', str(LM_SLOTS),
                '--max-new', str(RECURRENT_CLI_MAX_NEW)], tmp)
        m = re.search(r'served (\d+) requests, (\d+) tokens in ([0-9.]+)s '
                      r'\(([0-9.]+) tok/s\); p50 latency ([0-9.]+)s', text)
        k8 = re.search(r'K8 launches (\d+)', text)
        check(m is not None and k8 is not None and int(m.group(2))
              == RECURRENT_CLI_REQUESTS * RECURRENT_CLI_MAX_NEW
              and (int(k8.group(1)) > 0) == (name == HYMBA_ARCH),
              f'serve --arch {name}: {text[-1000:]}')
        out[name] = dict(tokens=int(m.group(2)), wall_s=float(m.group(3)),
                         tok_per_s=float(m.group(4)),
                         k8_launches=int(k8.group(1)),
                         lines=text.strip().splitlines())
    return out


def recurrent_phase(dev, card: str):
    """The recurrent families served on the card (after ``cross_phase``):
    xLSTM-1.3B, then Hymba-1.5B, each at full width and depth and freed
    before the next (``_recurrent_phase``).  bf16 reduced-precision
    reductions are off in this process for its checks (restored
    after)."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        return _recurrent_phase(dev, card)
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


def _recurrent_phase(dev, card: str):
    import gc
    t0 = time.perf_counter()
    print(f'recurrent phase on {card}', flush=True)
    res = {}
    cfg, params, x = recurrent_build(XLSTM_ARCH, dev, card)
    tokens = lambda: torch.randint(
        0, cfg.vocab_size, (1, RECURRENT_REPLAY), device=dev,
        generator=torch.Generator(dev).manual_seed(SEED))
    x['contract'] = xlstm_contract(cfg, params, tokens(), dev)
    x['serve'], x['launches'], x['rescore_launches'] = recurrent_serve(
        cfg, params, dev, card)
    x['step'] = recurrent_step_times(cfg, params, dev, card)
    res[XLSTM_ARCH] = x
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, h = recurrent_build(HYMBA_ARCH, dev, card)
    h['attn_cases'] = hymba_attention_cases(cfg, params, dev)
    h['replay'] = hymba_replay(cfg, params, tokens(), dev)
    h['serve'], h['launches'], h['rescore_launches'] = recurrent_serve(
        cfg, params, dev, card)
    h['step'] = recurrent_step_times(cfg, params, dev, card)
    res[HYMBA_ARCH] = h
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res['cli'] = _recurrent_clis()
    res['seconds'] = time.perf_counter() - t0
    print(f'recurrent phase: {res["seconds"]:.1f} s [{card}]', flush=True)
    return res


def family_train_attention(dev, shapes=FAMILY_TRAIN_ATTN, seed=SEED + 3):
    """``train_attn_case`` at each of ``shapes`` (K8's forward with lse
    and its backward pair against their plain versions, timed beside
    their bounds, their plain versions and SDPA), with each backward
    schedule (``attention_bwd_geometry``), on data from ``seed``."""
    from repro_torch.kernels.flash_attention import attention_bwd_geometry
    g = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for label, B, H, Hkv, S, D, window, dt, sk, causal in shapes:
        cases = train_attn_case(label, B, H, Hkv, S, D, window, dt, g, dev,
                                sk=sk, causal=causal)
        geom = dataclasses.asdict(attention_bwd_geometry(
            B, H, Hkv, S, sk, D, getattr(torch, dt), window, 0, sms,
            causal=causal))
        for c in cases[1:]:
            c['geometry'] = geom
        print(f'K8 backward schedule {cases[0]["shape"]}: {geom}',
              flush=True)
        total = sum(c['ms'] for c in cases)
        lib = cases[0]['library_ms'] + cases[1]['library_ms']
        print(f'K8 training attention {cases[0]["shape"]}: forward + '
              f'backward {total:.4f} ms (SDPA {lib:.4f} ms)', flush=True)
        out.append(cases)
        torch.cuda.empty_cache()
    return out


def _family_grad_check(cfg, params, batch):
    """One batch's gradients four ways: on K8 ('auto') and the plain
    attention ('torch'), each at the config's activations and at f32.
    Per leaf: K8's relative Frobenius error against the plain attention
    at both (``rel``, ``rel_f32``; the second is the gate), and the plain
    attention's own bf16 rounding difference (bf16 against f32,
    ``noise``); the first run's kernel launches."""
    from repro_torch.launch.train import _grad_leaves, loss_fn_for
    from repro_torch.tree import flatten_with_paths
    kernels = _kernel_counters()
    paths = [p for p, _ in flatten_with_paths(params)]
    f32 = cfg.replace(activation_dtype='float32')
    runs, launches = {}, None
    for label, c in (('auto', cfg), ('torch', cfg.replace(
            attn_backend='torch')), ('auto f32', f32),
            ('torch f32', f32.replace(attn_backend='torch'))):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        loss, grads = _grad_leaves(loss_fn_for(c), params, batch)
        torch.cuda.synchronize()
        if launches is None:
            launches = {k.__name__: k.launches for k in kernels}
        runs[label] = (float(loss), grads)

    def rel(a, b):
        return {p: float(torch.linalg.vector_norm(x.float() - y.float())
                         / torch.linalg.vector_norm(y.float()))
                for p, x, y in zip(paths, runs[a][1], runs[b][1])}

    res = dict(losses={k: v[0] for k, v in runs.items()},
               rel=rel('auto', 'torch'), rel_f32=rel('auto f32', 'torch f32'),
               noise=rel('torch', 'torch f32'), launches=launches)
    res['worst'] = max(res['rel'].values())
    res['worst_f32'] = max(res['rel_f32'].values())
    return res


def _family_param_count(cfg) -> int:
    return RECURRENT_PARAMS.get(cfg.name) or lm_param_count(cfg)


def family_train_run(name: str, B: int, S: int, dev, card: str):
    """``name``'s training main path at full width and depth: the weights
    drawn on the card from a seed (parameters and bytes against the
    shapes), one batch's gradients on K8 against the plain attention
    (``_family_grad_check``: every leaf within ``GRAD_REL_TOL`` at f32
    activations; the bf16 errors printed beside their own rounding), then
    ``FAMILY_TRAIN_STEPS`` donating ``make_train_step`` steps (AdamW under
    ``lr_schedule_for``'s cosine) under ``FaultTolerantRunner`` over
    ``HostLoader`` and ``SyntheticLM`` (whisper's with its sources), every
    kernel counter set to 0 just before and read just after: losses
    finite, each step's launches ``FAMILY_LAUNCHES`` and nothing else,
    step ms (the median of steps 2-3), tokens/s, the resident state and
    the peak against the card's memory; then one more step at the same
    shape traced (no warm call: three steps ran): ``_donating_steps``."""
    import gc
    from repro_torch import configs
    from repro_torch.data import HostLoader, source_for
    from repro_torch.tree import leaves
    cfg = configs.get_config(name)
    shape = configs.ShapeConfig('train_4k cut', 'train', S, B)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    params, n, nbytes, init_s, init_peak = _init_on_card(cfg, dev)
    print(f'{name}: {cfg.n_layers} layers (+{cfg.n_encoder_layers} '
          f'encoder), d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} '
          f'heads, vocab {cfg.vocab_size}, {cfg.param_dtype} weights, '
          f'{cfg.activation_dtype} activations, remat {cfg.remat}: {n} '
          f'parameters, {nbytes} bytes ({nbytes / 1e9:.2f} GB), init '
          f'{init_s:.2f} s, init peak {init_peak / 1e9:.2f} GB; batch {B} x '
          f'{S} tokens [{card}]', flush=True)
    check(n == _family_param_count(cfg) and nbytes == 4 * n and all(
        p.dtype == torch.float32 and p.device == dev
        for p in leaves(params)), f'{name}: {n} parameters, {nbytes} bytes')
    res = dict(arch=name, params=n, bytes=nbytes, init_s=init_s,
               init_peak_bytes=init_peak, batch=B, seq=S,
               tokens_per_step=B * S)
    loader = HostLoader(source_for(cfg, shape, seed=SEED), shape, dev)
    want = dict(zip(('flash_attention', 'flash_attention_bwd_kv',
                     'flash_attention_bwd_q'), FAMILY_LAUNCHES[name]))
    want = {k: v for k, v in want.items() if v}
    if want:
        _, batch0 = next(loader)
        res['grad_check'] = g = _family_grad_check(cfg, params, batch0)
        worst = sorted(g['rel'], key=lambda k: -g['rel'][k])[:6]
        print(f'{name} gradients on K8 vs the plain attention: losses '
              f'{g["losses"]}; worst leaf relative Frobenius error at f32 '
              f'activations {g["worst_f32"]:.3e} (tol {GRAD_REL_TOL}); at '
              f'{cfg.activation_dtype}, not a gate, {g["worst"]:.3e} ('
              + ', '.join(f'{k} {g["rel"][k]:.2e} [its bf16 rounding '
                          f'{g["noise"][k]:.2e}]' for k in worst)
              + f'); launches {g["launches"]}', flush=True)
        check(g['worst_f32'] <= GRAD_REL_TOL
              and np.isfinite(list(g['losses'].values())).all(),
              f'{name}: gradients on K8 off the plain attention\'s by '
              f'{g["worst_f32"]:.3e} at f32 activations')
        check({k: v for k, v in g['launches'].items() if v} == want,
              f'{name}: gradient launches {g["launches"]}, expected '
              f'{want}')
        del batch0
    else:
        # no attention: 'auto' and 'torch' run the same ops, so the check
        # would compare a step with itself; the steps below count K8's 0
        res['grad_check'] = None
        print(f'{name}: no attention, so no K8 gradient check; its steps '
              f'launch no kernel', flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    res.update(_donating_steps(cfg, params, loader, want, B, S, dev, card,
                               base))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _donating_steps(cfg, params, loader, want, B: int, S: int, dev,
                    card: str, base: int):
    """``FAMILY_TRAIN_STEPS`` donating ``make_train_step`` steps of ``cfg``
    from ``params`` (updated in place) on its optimizer under
    ``lr_schedule_for``'s schedule, under ``FaultTolerantRunner`` over
    ``loader``'s B x S batches, every kernel counter set to 0 just before
    and read just after: losses finite, each step's launches ``want`` and
    nothing else, step ms (the median of steps 2-3), tokens/s, the
    resident state and the peak above ``base`` against the card's memory;
    then one more step at the same shape traced (no warm call: three
    steps ran).  Returns their numbers."""
    import gc
    from repro_torch.launch.train import (loss_fn_for, lr_schedule_for,
                                          make_train_step)
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import FaultTolerantRunner
    from repro_torch.tree import leaves
    name = cfg.name
    opt = make_optimizer(cfg.optimizer, lr_schedule_for(cfg))
    state = {'params': params, 'opt': opt.init(params),
             'step': torch.zeros((), dtype=torch.int32)}
    del params
    resident = sum(t.numel() * t.element_size() for t in leaves(state))
    runner = FaultTolerantRunner(make_train_step(loss_fn_for(cfg), opt,
                                                 donate=True))
    kernels = _kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    steps, before = [], {k.__name__: 0 for k in kernels}
    for _, (step, batch) in zip(range(FAMILY_TRAIN_STEPS), loader):
        t0 = time.perf_counter()
        state, m = runner.run_step(step, state, batch)
        loss, gnorm = float(m['loss']), float(m['grad_norm'])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        now = {k.__name__: k.launches for k in kernels}
        steps.append(dict(step=step, loss=loss, grad_norm=gnorm,
                          wall_ms=wall, launches={
                              k: now[k] - before[k] for k in now}))
        before = now
        print(f'{name} train step {step}: loss {loss:.6f}, grad norm '
              f'{gnorm:.6f}, {wall:.1f} ms, launches '
              f'{ {k: v for k, v in steps[-1]["launches"].items() if v} }',
              flush=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    total = torch.cuda.get_device_properties(dev).total_memory
    step_ms = float(np.median([s['wall_ms'] for s in steps[1:]]))
    res = dict(resident_bytes=resident, peak_bytes=peak, card_bytes=total,
               steps=steps, step_ms=step_ms,
               tokens_per_s=B * S / step_ms * 1e3,
               launches={k.__name__: k.launches for k in kernels},
               events=list(runner.events))
    print(f'{name}: {FAMILY_TRAIN_STEPS} steps of {B} x {S} tokens: step '
          f'{step_ms:.1f} ms (median of steps 2-{FAMILY_TRAIN_STEPS}), '
          f'{res["tokens_per_s"]:.1f} tokens/s; resident state '
          f'{resident / 1e9:.2f} GB (parameters and {cfg.optimizer} '
          f'state), peak {peak / 1e9:.2f} GB of the card\'s '
          f'{total / 1e9:.2f} GB [{card}]', flush=True)
    check(all(np.isfinite([s['loss'], s['grad_norm']]).all()
              for s in steps), f'{name}: a loss or norm not finite')
    check(peak < total, f'{name}: peak {peak} bytes')
    for s in steps:
        check({k: v for k, v in s['launches'].items() if v} == want,
              f'{name} step {s["step"]}: launches {s["launches"]}, '
              f'expected {want}')
    _, batch = next(loader)
    t0 = time.perf_counter()
    res['trace'] = trace(
        lambda: runner.run_step(FAMILY_TRAIN_STEPS, state, batch),
        f'{name} train step, {B} x {S} tokens [{card}]', warm=False)
    res['trace_s'] = time.perf_counter() - t0
    del state, runner, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return res


def family_train_clis(tmp_root: str, names=None):
    """The train CLI (``launch.train.main``, in this process) on the smoke
    configuration of each of ``names`` (default ``FAMILY_TRAIN``'s) on
    the card: 4 steps with checkpoints, then ``--resume`` to 6; losses
    finite, the resume at step 4, and K8's launches printed (and non-zero)
    for the families with attention (all but xLSTM)."""
    import contextlib
    import io
    import re
    import tempfile
    from repro_torch.launch.train import main as train_main
    res = {}
    for name in names or [n for n, _, _ in FAMILY_TRAIN]:
        with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
            base = ['--arch', name, '--smoke', '--batch', '2', '--seq',
                    '64', '--ckpt-every', '2', '--log-every', '1',
                    '--ckpt-dir', tmp]
            outs = []
            for extra in (['--steps', '4'], ['--steps', '6', '--resume']):
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    train_main(base + extra)
                outs.append(buf.getvalue())
                print(f'train --arch {name} --smoke {" ".join(extra)}: '
                      f'{time.perf_counter() - t0:.1f} s; '
                      + ' | '.join(buf.getvalue().strip().splitlines()[-3:]),
                      flush=True)
        losses = [float(x) for x in re.findall(r' loss +(\S+)',
                                               ''.join(outs))]
        k8 = [re.search(r'K8 launches: forward (\d+), backward dk/dv '
                        r'(\d+), dq (\d+)', o) for o in outs]
        attn = name != XLSTM_ARCH
        check(len(losses) == 6 and all(np.isfinite(losses))
              and 'resumed at step 4' in outs[1]
              and all((m is not None and min(map(int, m.groups())) > 0)
                      if attn else m is None for m in k8),
              f'train --arch {name} --smoke: {outs}')
        res[name] = dict(losses=losses, k8=[list(map(int, m.groups()))
                                            if m else None for m in k8])
    return res


def family_train_phase(dev, card: str):
    """The families one card holds whole, trained (after
    ``recurrent_phase``): K8's training kernels at their new shapes
    (``family_train_attention``), then whisper-base, Hymba-1.5B and
    xLSTM-1.3B at full width and depth (``family_train_run``), each freed
    before the next, then the train CLI on each smoke config
    (``family_train_clis``)."""
    import tempfile
    t0 = time.perf_counter()
    print(f'family training phase on {card}', flush=True)
    res = dict(attention=family_train_attention(dev))
    for name, B, S in FAMILY_TRAIN:
        res[name] = family_train_run(name, B, S, dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        res['cli'] = family_train_clis(tmp)
    res['seconds'] = time.perf_counter() - t0
    print(f'family training phase: {res["seconds"]:.1f} s [{card}]',
          flush=True)
    return res


# ------------------------------------------- MoE and VLM training, cut
def _routes_of(fn):
    """(``fn()``, the sorted top-k experts of every ``moe_route`` call it
    made, on the host)."""
    from unittest import mock
    from repro_torch.models import layers
    real, seen = layers.moe_route, []

    def spy(cfg, p, x):
        r = real(cfg, p, x)
        seen.append(torch.sort(r.idx, dim=-1).values.cpu())
        return r

    with mock.patch.object(layers, 'moe_route', spy):
        out = fn()
    return out, seen


def depth_grad_check(name: str, dev, card: str):
    """K8's gradients against the plain attention's on ``name`` at full
    width cut to ``DEPTH_GRAD``'s depth, batch and tokens, at f32 weights
    and activations, drawn on the card from a seed: the MoE routes of the
    two runs compared first (forward and recompute; the tokens whose
    expert set differs are printed and none may), then every leaf's
    relative Frobenius error within ``GRAD_REL_TOL``, and the K8 run's
    launches (twice a layer forward, with the recompute; once a layer
    each backward kernel).  The K8 run's gradients wait on the host while
    the plain run's are made."""
    import gc
    from repro_torch import configs
    from repro_torch.data import HostLoader, source_for
    from repro_torch.launch.train import _grad_leaves, loss_fn_for
    from repro_torch.tree import flatten_with_paths
    L, B, S = DEPTH_GRAD[name]
    cfg = configs.get_config(name).replace(
        n_layers=L, param_dtype='float32', activation_dtype='float32')
    gc.collect()
    torch.cuda.empty_cache()
    params, n, nbytes, init_s, _ = _init_on_card(cfg, dev)
    shape = configs.ShapeConfig('gradient check', 'train', S, B)
    _, batch = next(HostLoader(source_for(cfg, shape, seed=SEED), shape,
                               dev))
    kernels = _kernel_counters()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    (loss, grads), routes = _routes_of(
        lambda: _grad_leaves(loss_fn_for(cfg), params, batch))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels if k.launches}
    on_host = [g.cpu() for g in grads]
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    (loss_t, grads_t), routes_t = _routes_of(lambda: _grad_leaves(
        loss_fn_for(cfg.replace(attn_backend='torch')), params, batch))
    flips = sum(int((a != b).any(dim=-1).sum())
                for a, b in zip(routes, routes_t))
    rel = {}
    for (path, _), a, b in zip(flatten_with_paths(params), on_host,
                               grads_t):
        rel[path] = float(torch.linalg.vector_norm(a.to(dev) - b)
                          / torch.linalg.vector_norm(b).clamp(min=1e-30))
    res = dict(layers=L, batch=B, seq=S, params=n, bytes=nbytes,
               loss=float(loss), loss_torch=float(loss_t), rel=rel,
               worst=max(rel.values()), route_calls=len(routes),
               routed_tokens=sum(r.shape[0] * r.shape[1] for r in routes),
               route_flips=flips, launches=launches)
    worst = sorted(rel, key=lambda k: -rel[k])[:5]
    print(f'{name} gradients on K8 vs the plain attention, cut to {L} '
          f'layers, {B} x {S} tokens, f32 weights and activations ({n} '
          f'parameters): losses {res["loss"]:.6f} / '
          f'{res["loss_torch"]:.6f}; routes of {len(routes)} moe_route '
          f'calls, {flips} of {res["routed_tokens"]} tokens flipped; '
          f'worst leaf relative Frobenius error {res["worst"]:.3e} (tol '
          f'{GRAD_REL_TOL}: ' + ', '.join(f'{k} {rel[k]:.2e}' for k in worst)
          + f'); launches {launches} [{card}]', flush=True)
    check(flips == 0, f'{name}: {flips} tokens routed otherwise on K8 than '
                      f'on the plain attention at f32')
    check(res['worst'] <= GRAD_REL_TOL and np.isfinite(
        [res['loss'], res['loss_torch']]).all(),
        f'{name}: gradients on K8 off the plain attention\'s by '
        f'{res["worst"]:.3e} at f32')
    check(launches == dict(flash_attention=2 * L, flash_attention_bwd_kv=L,
                           flash_attention_bwd_q=L),
          f'{name}: gradient check launches {launches}')
    del params, grads_t, on_host, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def depth_train_run(name: str, n_layers: int, B: int, S: int, dev,
                    card: str):
    """``name``'s training main path at full width cut by depth alone to
    ``n_layers`` (``moe_build`` / ``cross_build``: the weights drawn on
    the card from a seed, parameters and bytes against the shapes), then
    ``_donating_steps`` on Adafactor at B x S tokens (the VLM's batches
    with their patches): each step launches K8's forward twice a layer
    (forward and remat recompute) and each backward kernel once, nothing
    else; the traced step reads the MoE's expert counts to the host twice
    a layer (``LIVE_EXPERTS_LABEL``, with their host ms); the peak under
    ``DEPTH_PEAK_MAX``."""
    import gc
    from repro_torch import configs
    from repro_torch.data import HostLoader, source_for
    from repro_torch.models.layers import LIVE_EXPERTS_LABEL
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    moe = configs.get_config(name).moe is not None
    cfg, params, res = (moe_build if moe else cross_build)(
        name, n_layers, dev, card)
    shape = configs.ShapeConfig('train_4k cut', 'train', S, B)
    loader = HostLoader(source_for(cfg, shape, seed=SEED), shape, dev)
    L = cfg.n_layers
    want = dict(flash_attention=2 * L, flash_attention_bwd_kv=L,
                flash_attention_bwd_q=L)
    res.update(batch=B, seq=S, tokens_per_step=B * S)
    res.update(_donating_steps(cfg, params, loader, want, B, S, dev, card,
                               base))
    del params
    tr = res['trace']
    res['moe_reads'] = tr['phases_count'].get(LIVE_EXPERTS_LABEL, 0)
    res['moe_read_host_ms'] = tr['phases_host_ms'].get(LIVE_EXPERTS_LABEL,
                                                       0.0)
    print(f'{name} at {L} layers: traced step {tr["wall_ms"]:.1f} ms, '
          f'device busy {tr["device_busy_ms"]:.1f} ms, idle share '
          f'{tr["idle_share"]:.3f}; {res["moe_reads"]} host reads of the '
          f'expert counts, {res["moe_read_host_ms"]:.2f} ms of host under '
          f'them; peak {res["peak_bytes"] / 1e9:.2f} GB (target '
          f'{DEPTH_PEAK_MAX / 1e9:.0f} GB) [{card}]', flush=True)
    check(res['moe_reads'] == (2 * L if moe else 0),
          f'{name}: {res["moe_reads"]} expert-count reads in a step')
    check(res['peak_bytes'] < DEPTH_PEAK_MAX,
          f'{name}: peak {res["peak_bytes"]} bytes at {L} layers')
    gc.collect()
    torch.cuda.empty_cache()
    return res


def depth_train_phase(dev, card: str):
    """The MoE and VLM families trained, cut by depth (after
    ``family_train_phase``): K8's training kernels at their shapes
    (``DEPTH_TRAIN_ATTN``), then for Mixtral 8x22B and
    Llama-3.2-Vision-90B the main path at the ``DEPTH_TRAIN`` cut
    (``depth_train_run``) and the f32 gradient check on a cut of one
    layer or group (``depth_grad_check``), each freed before the next;
    then the train CLI on the three smoke configs (Mixtral's, Kimi-K2's,
    Llama's) with ``--resume``."""
    import tempfile
    t0 = time.perf_counter()
    print(f'MoE and VLM training phase on {card}', flush=True)
    res = dict(attention=family_train_attention(dev, DEPTH_TRAIN_ATTN,
                                                SEED + 4))
    for name, L, B, S in DEPTH_TRAIN:
        res[name] = depth_train_run(name, L, B, S, dev, card)
        res[name]['grad_check'] = depth_grad_check(name, dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        res['cli'] = family_train_clis(tmp, [MOE_ARCH, KIMI_ARCH,
                                             CROSS_VLM])
    res['seconds'] = time.perf_counter() - t0
    print(f'MoE and VLM training phase: {res["seconds"]:.1f} s [{card}]',
          flush=True)
    return res


def _family_launches(fam, name: str):
    """A kernel's launches in each trained family's three steps."""
    return {a: fam[a]['launches'][name] for a, _, _ in FAMILY_TRAIN}


def _depth_launches(depth, name: str):
    """A kernel's launches in each MoE and VLM config's three steps."""
    return {a: depth[a]['launches'][name] for a, _, _, _ in DEPTH_TRAIN}


def _bwd_rows(train, fam, depth):
    """The kernels-line rows of K8's two backward kernels: their cases at
    every ``LM_TRAIN_ATTN`` shape (MiniCPM-2B's first), every
    ``FAMILY_TRAIN_ATTN`` and every ``DEPTH_TRAIN_ATTN`` shape, their
    launches on MiniCPM-2B's training path and, as
    ``family_train_launches`` and ``depth_train_launches``, on the trained
    families' and the MoE and VLM configs'."""
    rows = []
    for i, name in ((1, 'flash_attention_bwd_kv'),
                    (2, 'flash_attention_bwd_q')):
        row = _case_row(name, 'src/repro_torch/csrc/flash_attention_bwd.cu',
                        'none: the reference\'s backward (_ca_bwd, '
                        'src/repro/models/layers.py:173) is plain jnp',
                        [cases[i] for cases in train['attention']
                         + fam['attention'] + depth['attention']])
        row['launches'] = train['run']['launches'][name]
        row['family_train_launches'] = _family_launches(fam, name)
        row['depth_train_launches'] = _depth_launches(depth, name)
        rows.append(row)
    return rows

def _case_row(name: str, source: str, replaces: str, cases):
    """A kernels-line row from the measured cases of one kernel: the first
    case's numbers, the worst error and every case under ``cases``."""
    first = cases[0]
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                shape=first['shape'], max_abs_err=max(
                    c['max_abs_err'] for c in cases),
                tol=first['tol'], ok=all(c['ok'] for c in cases),
                **{k: first[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                         'bound_by', 'library_ms',
                                         'geometry') if k in first},
                cases=cases)


def cell_checks(params, B: int, dev):
    """K6 (``lstm_gates``, the fused cell) against its plain version on
    layer 0 (N_in = 123 + 421) and an inner layer (421 + 421) at B streams
    (``gates_case``), with the geometry its timed launch used; then
    drives the public op
    ``lstm_cell_fused`` once per layer with the launch counter set to 0,
    against ``core.lstm.lstm_cell``."""
    from repro_torch.core.lstm import lstm_cell
    from repro_torch.kernels.lstm_gates import lstm_cell_fused, lstm_gates
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases, inputs = [], []
    for lp in params.layers[:2]:
        case, ins = gates_case('lstm_gates', lp, B, g, dev)
        _print_gates_case(case, 'torch.mm')
        check(case['ok'], 'lstm_gates disagrees with its plain version')
        cases.append(case)
        inputs.append(ins)

    torch.cuda.synchronize()
    lstm_gates.launches = 0
    outs = [lstm_cell_fused(*a) for a in inputs]
    torch.cuda.synchronize()
    launches = lstm_gates.launches
    err = max(float((g - r).abs().max()) for a, o in zip(inputs, outs)
              for g, r in zip(o, lstm_cell(*a)))
    print(f'lstm_cell_fused: {len(inputs)} calls, {launches} K6 launches; '
          f'max abs diff vs lstm_cell {err:.3e} (tol {KERNEL_ATOL})',
          flush=True)
    check(launches == len(inputs), 'lstm_cell_fused must launch K6 once')
    check(err <= KERNEL_ATOL, 'lstm_cell_fused disagrees with lstm_cell')
    row = _case_row('lstm_gates', 'src/repro_torch/csrc/lstm_gates_rec.cu',
                    'src/repro/kernels/lstm_gates/kernel.py:115', cases)
    row['launches'] = launches
    return row


def qmm_case(label: str, M: int, K: int, N: int, g, dev):
    """One K7 case on per-row and per-column quantized normal data drawn
    from ``g``: ``torch.equal`` to its plain version in f32 and bf16, the
    kernel's ms (f32 and bf16 out), its plain version's, the product alone
    (``torch._int_mm``, the faster of a row-major and a column-major
    weight) and the bound (f32 out).  Only public calls that the parent
    tree has too, so ``--ab`` runs it on either.  Returns (case, inputs)."""
    from repro_torch.core import quant
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_ref,
                                                  quantize_weights)
    x = torch.randn(M, K, generator=g, device=dev)
    w = torch.randn(K, N, generator=g, device=dev)
    w_q, ws = quantize_weights(w)
    xs = quant.abs_max_scale(x, axis=-1)
    args = (quant.quantize_scaled(x, xs), w_q, xs, ws[None, :])
    got, want = quant_matmul(*args), quant_matmul_ref(*args)
    err = float((got - want).abs().max())
    same = dict(float32=torch.equal(got, want), bfloat16=torch.equal(
        quant_matmul(*args, out_dtype=torch.bfloat16),
        quant_matmul_ref(*args, out_dtype=torch.bfloat16)))
    reps = 20 if M * K * N > 1e10 else 200
    w_cm = w_q.t().contiguous().t()          # column-major (K, N)
    int_mm = {layout: cuda_ms(lambda: torch._int_mm(args[0], wl), reps)
              for layout, wl in (('row-major', w_q), ('column-major', w_cm))}
    case = dict(
        shape=f'{label} M={M} K={K} N={N}', max_abs_err=err, tol=0,
        ok=all(same.values()), equal=same,
        ms=cuda_ms(lambda: quant_matmul(*args), reps),
        ms_bf16=cuda_ms(lambda: quant_matmul(
            *args, out_dtype=torch.bfloat16), reps),
        plain_ms=cuda_ms(lambda: quant_matmul_ref(*args), 3, warmup=1),
        library_ms=None,
        product_only_ms=min(int_mm.values()), int_mm_ms=int_mm,
        # codes and scales in once, f32 out once
        bytes=M * K + K * N + 4 * M + 4 * N + 4 * M * N,
        flops=2 * M * K * N)
    case['bound_ms'], case['bound_by'] = bound(
        case['bytes'], case['flops'], INT8_OPS_PER_S)
    return case, (x, w, w_q, ws)


def quant_matmul_checks(dev):
    """K7 (``quant_matmul``) at each ``QMM_SHAPES`` shape (``qmm_case``),
    with its launch geometry; then drives the public op
    ``quantized_linear`` once at each shape and at ``QMM_RAGGED`` with the
    launch counter set to 0, against the f32 product."""
    from repro_torch.kernels.quant_matmul import (qmm_geometry,
                                                  quant_matmul,
                                                  quantize_weights,
                                                  quantized_linear)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases, inputs = [], []
    for label, M, K, N in QMM_SHAPES:
        case, ins = qmm_case(label, M, K, N, g, dev)
        inputs.append(ins)
        case['geometry'] = dataclasses.asdict(qmm_geometry(M, N, sms))
        print(f"quant_matmul: {case['shape']}: torch.equal to plain version "
              f"{case['equal']}, kernel {case['ms']:.4f} ms (bf16 out "
              f"{case['ms_bf16']:.4f}), plain {case['plain_ms']:.4f} ms, "
              f"bound {case['bound_ms']:.5f} ms ({case['bound_by']}; "
              f"{case['bytes'] / 1e6:.2f} MB), library none (product only, "
              f"torch._int_mm: row-major weight "
              f"{case['int_mm_ms']['row-major']:.4f} ms, column-major "
              f"{case['int_mm_ms']['column-major']:.4f} ms); geometry "
              f"{case['geometry']}", flush=True)
        check(case['ok'], f'quant_matmul differs from its plain version at '
                          f'{case["shape"]}')
        cases.append(case)
    lead, N = QMM_RAGGED
    x = torch.randn(*lead, generator=g, device=dev)
    w = torch.randn(lead[-1], N, generator=g, device=dev)
    inputs.append((x, w, *quantize_weights(w)))

    torch.cuda.synchronize()
    quant_matmul.launches = 0
    outs = [quantized_linear(x, w_q, ws) for x, _, w_q, ws in inputs]
    torch.cuda.synchronize()
    launches = quant_matmul.launches
    rel = []
    for (x, w, _, _), out in zip(inputs, outs):
        exact = x @ w
        check(out.shape == exact.shape and bool(torch.isfinite(out).all()),
              'quantized_linear output misshapen or not finite')
        rel.append(float((out - exact).abs().max() / exact.abs().max()))
    print(f'quantized_linear: {len(inputs)} calls (the shapes above and '
          f'{tuple(lead)} x ({lead[-1]}, {N})), {launches} K7 launches; max '
          f'error relative to the f32 product {max(rel):.4f} (tol '
          f'{QMM_REL_TOL})', flush=True)
    check(launches == len(inputs), 'quantized_linear must launch K7 once')
    check(max(rel) < QMM_REL_TOL, 'quantized_linear strays from f32')
    row = _case_row('quant_matmul', 'src/repro_torch/csrc/quant_matmul.cu',
                    'src/repro/kernels/quant_matmul/kernel.py:41', cases)
    row['launches'] = launches
    return row


def _needed(sq: int, sk: int, offset: int, window, kv_len=None,
            causal: bool = True):
    """(valid query-key pairs, keys any query sees) of one head."""
    pos = np.arange(sq) + offset
    kv = sk if kv_len is None else min(sk, kv_len)
    hi = np.minimum(kv, pos + 1) if causal else np.full_like(pos, kv)
    lo = np.zeros_like(pos) if window is None else np.maximum(
        0, pos - window + 1)
    seen = np.zeros(sk + 1, np.int64)
    live = hi > lo
    np.add.at(seen, lo[live], 1)
    np.add.at(seen, hi[live], -1)
    return (int(np.maximum(hi - lo, 0).sum()),
            int((np.cumsum(seen)[:sk] > 0).sum()))


def attn_case(label: str, B: int, H: int, Hkv: int, Sq: int, Sk: int,
              D: int, window, dt: str, g, dev):
    """One K8 case with ``mha``'s arguments (causal, offset Sk - Sq) on
    normal data drawn from ``g`` (``attn_measure``).  Only public calls
    that the parent tree has too, so ``--ab`` runs it on either.  Returns
    (case, inputs)."""
    dtype = getattr(torch, dt)
    q = torch.randn(B, H, Sq, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    return attn_measure(f'{label} {dt}', q, k, v, window=window,
                        offset=Sk - Sq), (q, k, v, window)


def attn_measure(label: str, q, k, v, window=None, offset=0, kv_len=None,
                 causal: bool = True):
    """K8 on q, k, v (``causal``, ``window``, ``offset``, ``kv_len``): its
    error against the plain version and the share of the tolerance used,
    the kernel's ms, its plain version's, that of
    ``scaled_dot_product_attention`` with ``enable_gqa`` and an explicit
    boolean mask (its ``is_causal`` is top-left aligned, wrong for Sq !=
    Sk) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dt = str(q.dtype).split('.')[-1]
    kw = dict(causal=causal, window=window, offset=offset, kv_len=kv_len)
    got = flash_attention(q, k, v, **kw).float()
    want = attention_ref(q, k, v, **kw).float()
    err = float((got - want).abs().max())
    tol = ATTN_TOL[dt]
    ok = bool(torch.allclose(got, want, **tol))
    # the largest share of the limit any element uses (<= 1 passes)
    used = float(((got - want).abs() / (
        tol['atol'] + tol['rtol'] * want.abs())).max())
    pos = torch.arange(Sq, device=q.device)[:, None] + offset
    key = torch.arange(Sk, device=q.device)[None, :]
    mask = pos >= key if causal else torch.ones_like(pos >= key)
    if window is not None:
        mask &= (pos - key) < window
    if kv_len is not None:
        mask &= key < kv_len
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
    lib_err = float((sdpa().float() - want).abs().max())
    pairs, keys = _needed(Sq, Sk, offset, window, kv_len, causal)
    big = pairs * H > 1e8
    es = q.element_size()
    extra = '' if kv_len is None else f' kv_len={kv_len} offset={offset}'
    extra += '' if causal else ' not causal'
    case = dict(
        shape=f'{label} B={B} H={H} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} '
              f'window={window}{extra}', max_abs_err=err, tol=tol, ok=ok,
        tol_used=used,
        ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), 3 if big else 20),
        plain_ms=cuda_ms(lambda: attention_ref(q, k, v, **kw),
                         1 if big else 5, warmup=1),
        library_ms=cuda_ms(sdpa, 3 if big else 20, warmup=1),
        library_max_abs_diff=lib_err,
        # q in and out once; the keys and values some query sees, once
        bytes=es * (2 * B * H * Sq * D + 2 * B * Hkv * keys * D),
        flops=4 * D * pairs * B * H, pairs=pairs * B * H)
    # operations at the peak of the inputs' type; the kernel's own f32
    # arithmetic on the CUDA cores beside it
    case['bound_ms'], case['bound_by'] = bound(
        case['bytes'], case['flops'],
        BF16_FLOPS_PER_S if dt == 'bfloat16' else F32_FLOPS_PER_S)
    case['bound_f32_cores_ms'] = bound(case['bytes'], case['flops'])[0]
    return case


def _print_attn_case(case, geom, narrow: str = '') -> None:
    print(f"flash_attention: {case['shape']}: max_abs_err "
          f"{case['max_abs_err']:.3e} (tol {case['tol']}, "
          f"{case['tol_used']:.3f} of the limit), kernel "
          f"{case['ms']:.4f} ms{narrow}, plain {case['plain_ms']:.4f} "
          f"ms, sdpa {case['library_ms']:.4f} ms (max abs diff "
          f"{case['library_max_abs_diff']:.3e}), bound "
          f"{case['bound_ms']:.5f} ms ({case['bound_by']}: "
          f"{case['flops'] / 1e9:.2f} GFLOP, {case['bytes'] / 1e6:.2f} "
          f"MB; at the f32 CUDA-core peak "
          f"{case['bound_f32_cores_ms']:.5f} ms); schedule {geom.path} "
          f"({geom.tile_rows} rows a tile, n_splits {geom.n_splits})",
          flush=True)


def attention_checks(dev, lm, train, moe, cross, rec, fam, depth):
    """K8 (``flash_attention``) at each ``ATTN_CASES`` case (``attn_case``),
    with its schedule, and where that is 128-row tiles also the time of
    the 64-row tiles on the same inputs; then drives the public op ``mha``
    once per case with the launch counter set to 0.  The kernels-line row
    leads with the Mixtral cases, adds the LM phase's cases (``lm``:
    Qwen3-14B's decode and prefill, its main path) and the training
    phase's forward-with-lse cases (``train``) and the MoE phase's cases
    (``moe``: Mixtral's ring and windowed cases, Kimi-K2's at D 112) and
    the cross phase's cases (``cross``: whisper's encoder, cross prefill
    and decode at 1,500 keys, f32 D 64; Llama-3.2-Vision's at 1,024 keys,
    bf16 D 128, GQA 64/8) and the recurrent phase's (``rec``: Hymba's f32
    prefill and windowed forward and its bf16 decode rows, D 64, GQA
    25/5) and the family training phase's forward-with-lse cases
    (``fam``: whisper's encoder, cross and decoder self, Hymba's windowed
    and global, and a partial-tile case, f32 D 64) and the MoE and VLM
    training phase's (``depth``: Mixtral's windowed GQA 48/8, Llama's
    self and cross GQA 64/8, bf16 D 128), takes its launches from
    the LM's serve path, reports MiniCPM-2B's training launches as
    ``train_launches``, the MoE serve paths' as ``moe_launches``, the
    cross serve paths' as ``cross_launches``, the recurrent ones' as
    ``recurrent_launches``, the three trained families' (three steps
    each) as ``family_train_launches`` and the MoE and VLM families' as
    ``depth_train_launches``."""
    from unittest import mock
    from repro_torch.kernels.flash_attention import (attention_geometry,
                                                     flash_attention, mha)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases, inputs = [], []
    for label, B, H, Hkv, Sq, Sk, D, window, dt in ATTN_CASES:
        case, (q, k, v, _) = attn_case(label, B, H, Hkv, Sq, Sk, D, window,
                                       dt, g, dev)
        inputs.append((q, k, v, window))
        geom = attention_geometry(B, H, Hkv, Sq, Sk, window, None, Sk - Sq,
                                  D, sms, wide=dt == 'bfloat16')
        case['geometry'] = dataclasses.asdict(geom)
        narrow = ''
        if geom.tile_rows == fa_kernel.WIDE_ROWS:
            # the same launch in 64-row tiles, for the choice of width
            with mock.patch.object(fa_kernel, 'WIDE_ROWS',
                                   fa_kernel.TILE_ROWS):
                case['ms_64_rows'] = cuda_ms(lambda: flash_attention(
                    q, k, v, causal=True, window=window), 3)
            narrow = f", {case['ms_64_rows']:.4f} ms in 64-row tiles"
        _print_attn_case(case, geom, narrow)
        check(case['ok'], f'flash_attention disagrees with its plain version '
                          f'at {case["shape"]}')
        cases.append(case)

    torch.cuda.synchronize()
    flash_attention.launches = 0
    outs = [mha(q, k, v, causal=True, window=w) for q, k, v, w in inputs]
    torch.cuda.synchronize()
    launches = flash_attention.launches
    check(all(o.shape == q.shape and o.dtype == q.dtype
              and bool(torch.isfinite(o).all())
              for o, (q, _, _, _) in zip(outs, inputs)),
          'mha output misshapen or not finite')
    print(f'mha: {len(inputs)} calls, {launches} K8 launches', flush=True)
    check(launches == len(inputs), 'mha must launch K8 once')
    row = _case_row('flash_attention',
                    'src/repro_torch/csrc/flash_attention.cu',
                    'src/repro/kernels/flash_attention/kernel.py:79',
                    cases + lm['attn_cases']
                    + [c[0] for c in train['attention']]
                    + moe[MOE_ARCH]['attn_cases']
                    + moe[KIMI_ARCH]['attn_cases']
                    + cross[CROSS_AUDIO]['attn_cases']
                    + cross[CROSS_VLM]['attn_cases']
                    + rec[HYMBA_ARCH]['attn_cases']
                    + [c[0] for c in fam['attention']]
                    + [c[0] for c in depth['attention']])
    row['launches'] = lm['launches']['flash_attention']
    row['train_launches'] = train['run']['launches']['flash_attention']
    row['prefill_launches'] = lm['rescore_launches']['flash_attention']
    row['moe_launches'] = {a: moe[a]['launches']['flash_attention']
                           for a in (MOE_ARCH, KIMI_ARCH)}
    row['cross_launches'] = {a: cross[a]['launches']['flash_attention']
                             for a in (CROSS_AUDIO, CROSS_VLM)}
    row['recurrent_launches'] = {a: rec[a]['launches']['flash_attention']
                                 for a in (XLSTM_ARCH, HYMBA_ARCH)}
    row['family_train_launches'] = _family_launches(fam, 'flash_attention')
    row['depth_train_launches'] = _depth_launches(depth, 'flash_attention')
    row['mha_launches'] = launches
    return row


def engine_case(cfg, params, backend: str, utts, drains: int = 5,
                async_dispatch: bool = False, slots: int = SLOTS):
    """The f32 engine on ``backend`` (``slots`` slots, chunks of
    ``CHUNK``, sync or ``async_dispatch``): one warm drain of ``utts``, then
    ``drains`` timed ones, each ending in a synchronize; the medians of the
    drains' p50 chunk ms and frames/s.  In sync mode only calls that the
    parent tree has too."""
    from repro_torch.launch.serve import StreamServer
    mode = dict(async_dispatch=True) if async_dispatch else {}
    p50, rate = [], []
    for i in range(drains + 1):
        server = StreamServer(cfg.replace(lstm_backend=backend), params,
                              num_slots=slots, chunk=CHUNK, **mode)
        for u in utts:
            server.submit(u)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = server.engine.stats()
        if i:
            p50.append(stats['p50_chunk_s'] * 1e3)
            rate.append(stats['frames'] / wall)
    return dict(kernel=f'engine {backend}' + (' async' if async_dispatch
                                              else ''),
                shape=f'{len(utts)} utterances, {stats["frames"]} frames, '
                      f'{stats["steps"]} chunks',
                p50_chunk_ms=float(np.median(p50)),
                frames_per_s=float(np.median(rate)))


def engine_timing(cfg, params, utts, slots: int = SLOTS,
                  backends=('cuda_seq_fused', 'cuda_seq'),
                  pairs: int = ENGINE_PAIRS):
    """The f32 engine sync against async on each of ``backends`` in
    ``pairs`` pairs of turns, sync first in even pairs and async first in
    odd ones, each turn ``engine_case`` over ``ENGINE_DRAINS`` drains: per
    mode the median and quartiles of the turns' frames/s and p50 chunk ms,
    and the pairs in which async served more frames a second."""
    out = {}
    for backend in backends:
        turns = {False: [], True: []}
        for i in range(pairs):
            for mode in ((False, True) if i % 2 == 0 else (True, False)):
                turns[mode].append(engine_case(cfg, params, backend, utts,
                                               ENGINE_DRAINS, mode, slots))
        res = dict(shape=f'{turns[False][0]["shape"]}, {slots} slots',
                   pairs=pairs)
        for name, mode in (('sync', False), ('async', True)):
            rate = [t['frames_per_s'] for t in turns[mode]]
            p50 = [t['p50_chunk_ms'] for t in turns[mode]]
            res[name] = dict(
                frames_per_s=float(np.median(rate)),
                frames_per_s_quartiles=[float(q) for q in
                                        np.percentile(rate, [25, 75])],
                p50_chunk_ms=float(np.median(p50)),
                p50_chunk_ms_quartiles=[float(q) for q in
                                        np.percentile(p50, [25, 75])],
                turns_frames_per_s=rate, turns_p50_chunk_ms=p50)
        res['async_wins'] = sum(
            a > b for a, b in zip(res['async']['turns_frames_per_s'],
                                  res['sync']['turns_frames_per_s']))
        out[backend] = res
        print(f'engine timing [{backend}] ({res["shape"]}; {pairs} pairs '
              f'of turns of {ENGINE_DRAINS} drains, order alternating): '
              + '; '.join(
                  f'{name} {res[name]["frames_per_s"]:.1f} frames/s '
                  f'(quartiles {res[name]["frames_per_s_quartiles"][0]:.1f}'
                  f'-{res[name]["frames_per_s_quartiles"][1]:.1f}), p50 '
                  f'chunk {res[name]["p50_chunk_ms"]:.3f} ms (quartiles '
                  f'{res[name]["p50_chunk_ms_quartiles"][0]:.3f}-'
                  f'{res[name]["p50_chunk_ms_quartiles"][1]:.3f})'
                  for name in ('sync', 'async'))
              + f'; async served more frames/s in {res["async_wins"]} of '
                f'{pairs} pairs', flush=True)
    return out


def int8_times(cfg, params, dev):
    """``int8_case`` for K3 on layer 0's and an inner plan and for K4, at
    the serving shape, K4 also at ``TRAIN_SEQ`` steps (``int8_inputs``, seed
    ``SEED``), then the int8 deploy on ``auto`` and ``layerwise``
    (``int8_deploy_case``, the main run's utterances)."""
    qps = quantize_stack(params)
    rng = np.random.RandomState(SEED)
    k3, k4 = int8_inputs(qps, CHUNK, SLOTS, rng, dev)
    _, k4_long = int8_inputs(qps, TRAIN_SEQ, SLOTS, rng, dev)
    cases = [int8_case('lstm_seq_quantized', *c) for c in k3]
    cases += [int8_case('lstm_stack_seq_kernel_q', *c) for c in (k4, k4_long)]
    utts = [(rng.randn(rng.randint(50, 301), cfg.lstm_inputs) * 0.5
             ).astype(np.float32) for _ in range(INT8_UTTERANCES)]
    return cases + int8_deploy_case(cfg, qps, utts, dev)


def op_times(dev):
    """``gates_case`` at K5's training case and K6's two layers,
    ``seq_case`` for K1 and K2 at every ``SEQ_SHAPES`` shape, the f32
    engine on ``cuda_seq`` and ``cuda_seq_fused`` (``engine_case``),
    ``int8_times`` (K3, K4 and the int8 deploy), ``qmm_case`` at every
    ``QMM_SHAPES`` shape, ``attn_case`` at every ``ATTN_CASES`` case and
    ``train_attn_case`` (K8's forward with lse and its two backward
    kernels) at every ``LM_TRAIN_ATTN`` shape, on the phases' inputs (same
    seeds, same order), for one turn of ``--ab``."""
    from repro_torch import configs
    from repro_torch.models import chipmunk_net
    cfg = configs.get_config('chipmunk-ctc')
    params = chipmunk_net.init(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [gates_case('lstm_gates_rec', params.layers[1], TRAIN_BATCH, g,
                        dev)[0]]
    g = torch.Generator(device=dev).manual_seed(SEED)
    for T, B in SEQ_SHAPES:
        inputs = seq_inputs(params, T, B, g, dev)
        for kernel in ('lstm_seq', 'lstm_stack_seq_kernel'):
            cases.append(seq_case(kernel, params, *inputs))
    rng = np.random.RandomState(SEED)
    utts = [(rng.randn(rng.randint(50, 301), cfg.lstm_inputs) * 0.5
             ).astype(np.float32) for _ in range(REQUESTS)]
    for backend in ('cuda_seq', 'cuda_seq_fused'):
        cases.append(engine_case(cfg, params, backend, utts))
    cases += int8_times(cfg, params, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    for lp in params.layers[:2]:
        cases.append(gates_case('lstm_gates', lp, CELL_BATCH, g, dev)[0])
    g = torch.Generator(device=dev).manual_seed(SEED)
    for shape in QMM_SHAPES:
        cases.append(dict(qmm_case(*shape, g, dev)[0],
                          kernel='quant_matmul'))
    g = torch.Generator(device=dev).manual_seed(SEED)
    for spec in ATTN_CASES:
        cases.append(dict(attn_case(*spec, g, dev)[0],
                          kernel='flash_attention'))
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    for spec in LM_TRAIN_ATTN:
        cases += train_attn_case(*spec, g, dev)
        torch.cuda.empty_cache()
    return cases


def ab(parent_src: str):
    """Parent against this tree in one call, in turns (parent, change,
    change, parent): each turn a process of its own that imports one
    tree's ``src`` and prints ``op_times``.  Returns the turns' rows."""
    here = str(pathlib.Path(__file__).resolve().parent / 'src')
    turns = []
    for side, src in (('parent', parent_src), ('change', here),
                      ('change', here), ('parent', parent_src)):
        proc = subprocess.run(
            [sys.executable, __file__, '--op-times', src],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f'--op-times {side} failed:\n{proc.stdout}'
                               f'\n{proc.stderr}')
        turns.append(dict(side=side, rows=json.loads(
            proc.stdout.strip().splitlines()[-1])))
    for i, row in enumerate(turns[0]['rows']):
        got = turns[1]['rows'][i]
        if 'frames_per_s' in got:
            chunk = 'p50_chunk_ms' if 'p50_chunk_ms' in got else 'chunk_ms'
            print(f"ab: {row['kernel']} ({row['shape']}): " + '; '.join(
                f"{t['side']} {chunk} {t['rows'][i][chunk]:.3f}, "
                f"{t['rows'][i]['frames_per_s']:.1f} frames/s"
                for t in turns), flush=True)
            continue
        lib = (f"product only {got['product_only_ms']:.5f} ms"
               if 'product_only_ms' in got else
               f"library {got['library_ms']:.5f} ms"
               if got.get('library_ms') is not None else 'library none')
        if 'equal' in got:
            extra = 'equal ' + str(all(all(t['rows'][i]['equal'].values())
                                       for t in turns))
        elif 'tol_used' in got:
            used = max(t['rows'][i]['tol_used'] for t in turns)
            extra = f'tol_used {used:.3f}'
            lib = f"library {got['library_ms']:.5f} ms"
        else:
            err = max(t['rows'][i]['max_abs_err'] for t in turns)
            extra = f'max_abs_err {err:.3e}'
        for key in ('ms', 'ms_bf16', 'chain_ms', 'chain_no_early_ms'):
            if key not in got:
                continue
            ms = {s: [t['rows'][i][key] for t in turns if t['side'] == s]
                  for s in ('parent', 'change')}
            print(f"ab: {row['kernel']} {row['shape']} {key}: parent "
                  f"{ms['parent'][0]:.5f} / {ms['parent'][1]:.5f} ms, change "
                  f"{ms['change'][0]:.5f} / {ms['change'][1]:.5f} ms "
                  f"({min(ms['parent']) / min(ms['change']):.2f}x), {lib}, "
                  f"plain {got['plain_ms']:.5f} ms, bound "
                  f"{got['bound_ms']:.5f} ms; {extra}", flush=True)
    return turns


def clock_stamps(dev):
    """Debug builds (``-DCLOCK_STAMPS``) of K5 and K6 (library
    ``lstm_gates_rec``: K5 at the training case, K6 at both layers, each
    timed on its third launch, with W in L2 as on the ``cuda_step`` chain),
    K1, K2, K3 (layer 0's plan) and K4 (third launch, at each
    ``SEQ_SHAPES`` shape; K3/K4 on ``int8_inputs``), K7 and K8 (one
    launch each at Mixtral's up-projection, f32 out, and bf16 prefill).
    Per CTA, thread 0's cycles in each phase
    (``STAMP_PARTS``), summed over the loop, and the whole kernel's or
    loop's time; printed as means over CTAs."""
    import ctypes
    from repro_torch import configs
    from repro_torch.core import quant
    from repro_torch.kernels import _build
    from repro_torch.kernels import lstm_gates as kg
    from repro_torch.kernels import lstm_seq as ks
    from repro_torch.kernels.flash_attention import (attention_geometry,
                                                     flash_attention)
    from repro_torch.kernels.quant_matmul import (qmm_geometry,
                                                  quant_matmul,
                                                  quantize_weights)
    from repro_torch.models import chipmunk_net
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    params = chipmunk_net.init(configs.get_config('chipmunk-ctc'),
                               torch.Generator().manual_seed(SEED),
                               device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    r = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.5
    B, inner = TRAIN_BATCH, params.layers[1]
    N = inner.n_h
    k5 = (r(B, N), inner.w_h, r(B, 4, N), inner.w_peep, inner.b, r(B, N))
    runs = [('lstm_gates_rec', 'lstm_gates_rec',
             kg.gates_geometry(N, N, B, sms).ctas, 3,
             lambda: kg.lstm_gates_rec(*k5))]
    L = len(params.layers)
    for T, Bs in SEQ_SHAPES:
        wts, pre_x, mask, h0, c0 = seq_inputs(params, T, Bs, g, dev)
        lp = params.layers[0]
        runs += [(f'lstm_seq T={T} B={Bs}', 'lstm_seq',
                  ks.seq_geometry(N, Bs, sms).ctas, 3,
                  lambda a=(pre_x, lp.w_h, lp.w_peep, lp.b, h0[0], c0[0],
                            mask): ks.lstm_seq(*a)),
                 (f'lstm_stack_seq_kernel T={T} B={Bs}', 'lstm_stack_seq',
                  ks.stack_geometry(N, L, Bs, sms).ctas, 3,
                  lambda a=(pre_x, wts.w_in, wts.w_h, wts.peep, wts.b, h0, c0,
                            mask): ks.lstm_stack_seq_kernel(*a))]
    qps = quantize_stack(params)
    p0 = qps[0].plan
    rng = np.random.RandomState(SEED)
    for T, Bs in SEQ_SHAPES:
        k3, (_, k4, kw) = int8_inputs(qps, T, Bs, rng, dev)
        runs += [(f'lstm_seq_quantized T={T} B={Bs}', 'lstm_seq_q',
                  ks.seq_q_geometry(p0.padded_x, p0.padded_h, p0.tile, Bs,
                                    sms).ctas, 3,
                  lambda a=k3[0][1], kw=k3[0][2]: ks.lstm_seq_quantized(
                      *a, **kw)),
                 (f'lstm_stack_seq_kernel_q T={T} B={Bs}', 'lstm_stack_seq_q',
                  ks.stack_q_geometry(p0.padded_h, p0.tile, L, Bs, sms).ctas,
                  3, lambda a=k4, kw=kw: ks.lstm_stack_seq_kernel_q(*a, **kw))]
    for lp in params.layers[:2]:
        K = lp.n_x + lp.n_h
        k6 = (r(B, K), torch.cat([lp.w_x, lp.w_h], dim=-1), lp.w_peep, lp.b,
              r(B, N))
        runs.append((f'lstm_gates N_in={K}', 'lstm_gates_rec',
                     kg.gates_geometry(N, K, B, sms).ctas, 3,
                     lambda k6=k6: kg.lstm_gates(*k6)))
    g = torch.Generator(device=dev).manual_seed(SEED)
    _, M, K, N = QMM_SHAPES[0]
    x = torch.randn(M, K, generator=g, device=dev)
    w_q, ws = quantize_weights(torch.randn(K, N, generator=g, device=dev))
    xs = quant.abs_max_scale(x, axis=-1)
    _, B, H, Hkv, Sq, Sk, D, window, dt = ATTN_CASES[0]
    q = torch.randn(B, H, Sq, D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    runs += [('quant_matmul', 'quant_matmul', qmm_geometry(M, N, sms).ctas,
              1, lambda: quant_matmul(quant.quantize_scaled(x, xs), w_q, xs,
                                      ws[None, :])),
             ('flash_attention', 'flash_attention', attention_geometry(
                 B, H, Hkv, Sq, Sk, window, None, Sk - Sq, D, sms).ctas, 1,
              lambda: flash_attention(q, k, v, causal=True, window=window))]
    out = {}
    for label, name, ctas, calls, fn in runs:
        _build.DEFINES[name] = ('-DCLOCK_STAMPS',)
        try:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            lib = _build.load(name, {})
            copy = getattr(lib, f'{name}_clock_stamps')
            copy.argtypes, copy.restype = [ctypes.c_void_p, ctypes.c_int], \
                ctypes.c_int
            host = np.zeros((ctas, STAMP_COLS), np.int64)
            _build.check(lib, copy(host.ctypes.data, ctas), 'stamps')
        finally:
            del _build.DEFINES[name]
        n = min(ctas, 8192)
        mean = host[:n].mean(axis=0)
        total = mean[-2]
        out[label] = dict(ctas=int(n), loop_cycles=float(total),
                          max_cycles=float(host[:n, -2].max()),
                          stages=float(mean[-1]), parts={
                              part: float(c) for part, c in
                              zip(STAMP_PARTS[name], mean)})
        print(f'clock stamps: {label}: {n} CTAs, {mean[-1]:.1f} stages, '
              f'{total:.0f} cycles a CTA (most {host[:n, -2].max()}): '
              + ', '.join(
                  f'{part} {c:.0f} ({c / total:.3f})' for part, c in
                  zip(STAMP_PARTS[name], mean)), flush=True)
    return out


# ------------------------------------------------------- the dry run
def dryrun_cells():
    """``DRYRUN_CELLS``, each ``python -m repro_torch.launch.dryrun`` in a
    process of its own (one process group a process) on the CPU, all at
    once: their records (``results/dryrun_torch``), a failed cell raising
    with its error."""
    import os
    from repro_torch.launch.dryrun import cell_path
    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / 'src'),
               CUDA_VISIBLE_DEVICES='')
    procs = []
    for arch, shape, mp in DRYRUN_CELLS:
        args = ['--arch', arch, '--shape', shape, '--force'] + (
            ['--multi-pod'] if mp else [])
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'repro_torch.launch.dryrun', *args],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    recs = []
    for (arch, shape, mp), p in zip(DRYRUN_CELLS, procs):
        try:
            out, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        path = cell_path(arch, shape, mp)
        check(p.returncode == 0 and path.exists(),
              f'dry run {arch} x {shape}: exit {p.returncode}\n'
              f'{out[-2000:]}\n{err[-3000:]}')
        rec = json.loads(path.read_text())
        check(rec['status'] == 'ok', f'dry run {arch} x {shape}: '
                                     f'{rec.get("error", "")[-2000:]}')
        m, r = rec['memory'], rec['roofline']
        rank_bytes = m['argument_size_bytes'] + m['temp_size_bytes']
        print(f'dry run {arch} x {shape} ({rec["mesh"]}, {rec["n_chips"]} '
              f'ranks): {rec["status"]}, {rank_bytes / 1e9:.2f} GB a rank '
              f'(arguments {m["argument_size_bytes"] / 1e9:.2f}, temporaries '
              f'{m["temp_size_bytes"] / 1e9:.2f}) of the card\'s '
              f'{HBM_BYTES / 1e9:.0f} GB, '
              f'bottleneck {r["bottleneck"]}, lower bound '
              f'{max(r["compute_s"], r["memory_s"], r["collective_s"]):.6f} '
              f's, roofline fraction {r["roofline_fraction"]}, '
              f'{rec["wall_s"]} s wall', flush=True)
        recs.append(dict(rec, rank_bytes=rank_bytes))
    return recs


def dryrun_ranking(cfg, params, dev):
    """``op_cost.rank_stack_backends`` at the serving shape (the stack
    without its read-out, T = ``CHUNK``, B = ``SLOTS``) beside each
    backend's launch timed on the card, each at or above its lower bound
    (``roofline.analyze``)."""
    from repro_torch import op_cost
    from repro_torch.core.lstm import LSTMStackParams, lstm_stack_apply
    from repro_torch.roofline import analyze
    n_x, n_h, L = cfg.lstm_inputs, cfg.lstm_hidden, cfg.n_layers
    stack = LSTMStackParams(params.layers, None, None)
    g = torch.Generator(device=dev).manual_seed(SEED)
    xs = torch.randn((CHUNK, SLOTS, n_x), generator=g, device=dev)
    rows = []
    for backend, est_us in op_cost.rank_stack_backends(n_x, n_h, L, CHUNK,
                                                       SLOTS):
        lb_ms = analyze(op_cost.stack_launch_cost(
            backend, n_x, n_h, L, CHUNK, SLOTS)).step_time_lower_bound_s * 1e3
        with torch.no_grad():
            ms = cuda_ms(lambda: lstm_stack_apply(stack, xs, backend=backend),
                         20)
        rows.append(dict(backend=backend, estimate_us=est_us, cuda_ms=ms,
                         lower_bound_ms=lb_ms, ratio=ms / lb_ms))
        print(f'stack backend {backend}: cost-model estimate {est_us:.2f} us, '
              f'on the card {ms * 1e3:.2f} us, lower bound '
              f'{lb_ms * 1e3:.2f} us (x{ms / lb_ms:.2f})', flush=True)
        check(ms >= lb_ms, f'{backend}: {ms} ms below its lower bound '
                           f'{lb_ms} ms')
    return rows


def dryrun_minicpm_bound(lm_train):
    """MiniCPM-2B's train step at ``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ``
    traced by the cost model on fake tensors (one card, the donating step
    of ``lm_train_run``; no step runs): its lower bound against the median
    measured step of the LM training phase."""
    from repro_torch import configs, op_cost
    from repro_torch.launch.train import (init_train_state, loss_fn_for,
                                          lr_schedule_for, make_train_step)
    from repro_torch.optim import make_optimizer
    from repro_torch.roofline import analyze
    cfg = configs.get_config(LM_TRAIN_ARCH)
    opt = make_optimizer(cfg.optimizer, lr_schedule_for(cfg))
    t0 = time.perf_counter()
    with op_cost.traced() as mode:
        with mode.hidden():
            state = init_train_state(cfg, opt, 'cpu', seed=SEED)
            batch = {k: torch.zeros((LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                                    dtype=torch.int32)
                     for k in ('tokens', 'labels')}
        make_train_step(loss_fn_for(cfg), opt, donate=True)(state, batch)
    terms = analyze(mode.record)
    lb_ms = terms.step_time_lower_bound_s * 1e3
    ms = float(np.median([s['wall_ms'] for s in lm_train['run']['steps'][1:]]))
    res = dict(terms=terms.to_dict(), kernels=mode.record.kernels,
               lower_bound_ms=lb_ms, step_ms=ms, ratio=ms / lb_ms,
               trace_s=time.perf_counter() - t0)
    print(f'{cfg.name} train step {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: cost '
          f'model {terms.flops:.4e} FLOPs, {terms.hbm_bytes:.4e} B, lower '
          f'bound {lb_ms:.1f} ms ({terms.bottleneck}); measured {ms:.1f} ms, '
          f'x{ms / lb_ms:.3f} ({res["trace_s"]:.1f} s to trace)', flush=True)
    check(ms >= lb_ms, f'{cfg.name}: step {ms} ms below its bound {lb_ms}')
    return res


def dryrun_sharded_attention(dev):
    """K8 under DTensor on the card: q, k, v placed on the trainer's
    ``local_mesh()`` ((1, 1) over a one-rank ``gloo`` group) under
    ``TRAIN_RULES``; ``layers.attention`` runs K8 on each rank's local
    shards (here the whole tensors): one launch, counted, its output
    ``torch.equal`` to the plain call's."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch import sharding as shd
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import resolve_rules
    from repro_torch.launch.train import local_mesh
    from repro_torch.models import layers
    mesh = local_mesh('cuda')
    rules = shd.ShardingRules(mesh, resolve_rules(shd.TRAIN_RULES, mesh))
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((2, h, 256, 64), generator=g, device=dev,
                           dtype=torch.bfloat16) for h in (8, 2, 2))
    want = flash_attention(q, k, v)
    before = flash_attention.launches
    with shd.use_rules(rules), torch.no_grad():
        o = layers.attention('auto', *(distribute_tensor(
            t, mesh, [Replicate(), Replicate()]) for t in (q, k, v)))
    res = dict(mesh=tuple(mesh.shape), placements=str(o.placements),
               launches=flash_attention.launches - before,
               equal=bool(torch.equal(o.to_local(), want)))
    dist.destroy_process_group()
    print(f'K8 under DTensor on the card: mesh {res["mesh"]}, output '
          f'{res["placements"]}, {res["launches"]} launch, equal to the '
          f'plain call: {res["equal"]}', flush=True)
    check(res['launches'] == 1 and res['equal'],
          f'K8 under DTensor: {res}')
    return res


def dryrun_phase(cfg, params, lm_train, card: str, dev):
    """The sharding slice on the card machine (11l): ``dryrun_cells``,
    ``dryrun_ranking``, ``dryrun_minicpm_bound``,
    ``dryrun_sharded_attention`` and ``compress_tensor``'s codes on the
    card against the CPU's."""
    from repro_torch.optim import compress_tensor
    t0 = time.perf_counter()
    res = dict(card=card, cells=dryrun_cells(),
               ranking=dryrun_ranking(cfg, params, dev),
               minicpm=dryrun_minicpm_bound(lm_train),
               sharded_attention=dryrun_sharded_attention(dev))
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((4096, 1024), generator=g, device=dev) * 3e-3
    q, s = compress_tensor(x)
    q_cpu, s_cpu = compress_tensor(x.cpu())
    res['compress_equal'] = bool(torch.equal(q.cpu(), q_cpu)
                                 and float(s) == float(s_cpu))
    check(res['compress_equal'], 'compress_tensor: the card\'s int8 codes '
                                 'differ from the CPU\'s')
    res['s'] = time.perf_counter() - t0
    print(f'dry-run phase: {res["s"]:.1f} s of its {DRYRUN_BUDGET_S} s '
          f'budget; int8 codes on the card equal the CPU\'s', flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description='chip smoke test of the port')
    ap.add_argument('--out', default=None,
                    help='also write the full results to this JSON file')
    ap.add_argument('--profile', action='store_true',
                    help='also trace one engine drain per f32 kernel '
                         'backend, int8 deploy passes per int8 backend and '
                         'one train step per kernel backend with '
                         'torch.profiler (device busy/idle share, time by '
                         'kernel)')
    ap.add_argument('--ab', metavar='PARENT_SRC', default=None,
                    help='only time K1-K8, K8\'s training kernels, the '
                         'f32 engine and the int8 deploy against the tree '
                         'whose src directory is given, in turns (parent, '
                         'change, change, parent)')
    ap.add_argument('--op-times', metavar='SRC', default=None,
                    help=argparse.SUPPRESS)   # one turn of --ab
    ap.add_argument('--clock-stamps', action='store_true',
                    help='only run debug builds of K1-K8 with clock64() '
                         'stamps of their phases')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    if args.op_times:
        sys.path.insert(0, args.op_times)
        load_card_rates()
        print(json.dumps(op_times(dev)), flush=True)
        return 0
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / 'src'))
    load_card_rates()
    if args.ab or args.clock_stamps:
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f'card: {card}', flush=True)
        res = dict(card=card)
        if args.clock_stamps:
            res['clock_stamps'] = clock_stamps(dev)
        if args.ab:
            res['ab'] = ab(args.ab)
        if args.out:
            out = pathlib.Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(res, indent=1))
        return 0
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import chipmunk_net

    t_start = time.perf_counter()
    phase_s = time_phases(globals())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)

    t0 = time.perf_counter()
    names = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f'build: {len(names)} kernels ({", ".join(names)}) in '
          f'{build_s:.1f} s', flush=True)

    cfg = configs.get_config('chipmunk-ctc')
    params = chipmunk_net.init(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    rng = np.random.RandomState(SEED)
    rows, stacking = kernel_checks(cfg, params, SLOTS, CHUNK, rng, dev)
    chunked_checks(params, SLOTS, CHUNK, rng, dev)
    utts = [(rng.randn(rng.randint(50, 301), cfg.lstm_inputs) * 0.5
             ).astype(np.float32) for _ in range(REQUESTS)]
    runs, worst = engine_runs(cfg, params, SLOTS, CHUNK, utts)
    timing = engine_timing(cfg, params, utts)
    profiles = [profile_engine(cfg, params, SLOTS, CHUNK, utts, b, mode)
                for b in (('cuda_seq_fused', 'cuda_seq') if args.profile
                          else ()) for mode in (False, True)]
    f4_rng = np.random.RandomState(SEED + 1)
    f4 = f4_checks(cfg, params, quantize_stack(params), f4_rng, dev)
    # the same engine with utterances of the main cell's lengths: the
    # device's share per chunk grows with the batch (K1 in two blocks)
    wide = [(f4_rng.randn(f4_rng.randint(50, 301), cfg.lstm_inputs) * 0.5
             ).astype(np.float32) for _ in range(F4_UTTERANCES)]
    timing.update({f'{b} {F4_SLOTS} slots': r for b, r in engine_timing(
        cfg, params, wide, F4_SLOTS, ('cuda_seq',), F4_PAIRS).items()})
    profiles += [profile_engine(cfg, params, F4_SLOTS, CHUNK, wide,
                                'cuda_seq', mode)
                 for mode in ((False, True) if args.profile else ())]
    fault = fault_runs(cfg, params, utts, dev)

    qps = quantize_stack(params)
    q_rows, q_stacking = int8_kernel_checks(qps, SLOTS, CHUNK, rng, dev)
    int8_chunked_checks(qps, SLOTS, CHUNK, rng, dev)
    q_utts = [(rng.randn(rng.randint(50, 301), cfg.lstm_inputs) * 0.5
               ).astype(np.float32) for _ in range(INT8_UTTERANCES)]
    deploy = int8_deploy(cfg, params, qps, CHUNK, q_utts, dev,
                         profile=args.profile)
    rows += q_rows

    train_cfg = configs.get_config('chipmunk-ctc')
    rows.append(gates_kernel_checks(train_cfg, params, TRAIN_BATCH, CHUNK,
                                    rng, dev))
    grad_err = grad_checks(train_cfg, dev)
    train, train_profiles = train_runs(train_cfg, dev, profile=args.profile)
    profiles += train_profiles
    cli = train_cli(train_cfg)
    fault['train'] = fault_train(train_cfg, dev)
    tuned = tune_phase(cfg, params, qps, q_utts, dev)
    examples = examples_phase()
    systolic = systolic_phase(cfg, params, qps, utts, dev)
    die = die_phase(cfg, params, utts, dev)

    # the dense LM served at full width, its attention on K8
    lm = lm_phase(dev)
    # and trained at MiniCPM-2B's full width, through K8's backward
    lm_train = lm_train_phase(dev)
    # the MoE family served: Mixtral 8x22B and Kimi-K2 at full width, cut
    # by depth
    moe = moe_phase(dev, card)
    # the cross-attention families served: whisper-base at full width and
    # depth, Llama-3.2-Vision-90B at full width cut by depth
    cross = cross_phase(dev, card)
    # the recurrent families served: xLSTM-1.3B and Hymba-1.5B at full
    # width and depth, Hymba's attention on K8
    rec = recurrent_phase(dev, card)
    # the families one card holds whole, trained at full width and depth:
    # whisper-base, Hymba-1.5B and xLSTM-1.3B
    fam = family_train_phase(dev, card)
    # the MoE and VLM families trained at full width, cut by depth:
    # Mixtral 8x22B and Llama-3.2-Vision-90B
    depth = depth_train_phase(dev, card)

    # the sharding slice: the production-mesh dry run on the CPU, the cost
    # model's bounds against launches and MiniCPM-2B's step on the card
    dry = dryrun_phase(cfg, params, lm_train, card, dev)
    # K2's layer block: the main stack in groups, a stack K2 refuses
    # whole, the tuner's trial and the engine under its entry
    stack_lb = stack_lb_phase(cfg, params, utts, card, dev)

    # K6 and K7 on their public ops (no path of the system reaches them);
    # K8 at Mixtral's shapes and on mha beside the LM path's cases
    op_rows = [cell_checks(params, CELL_BATCH, dev),
               quant_matmul_checks(dev),
               attention_checks(dev, lm, lm_train, moe, cross, rec, fam,
                                depth)]
    op_rows += _bwd_rows(lm_train, fam, depth)

    launches = dict(lstm_seq=runs['cuda_seq']['launches']['lstm_seq'],
                    lstm_stack_seq_kernel=runs['cuda_seq_fused']['launches']
                    ['lstm_stack_seq_kernel'],
                    lstm_seq_quantized=deploy['runs']['layerwise']
                    ['launches']['lstm_seq_quantized'],
                    lstm_stack_seq_kernel_q=deploy['runs']['auto']
                    ['launches']['lstm_stack_seq_kernel_q'],
                    lstm_gates_rec=train['cuda_step']['launches']
                    ['lstm_gates_rec'])
    for r in rows:
        r['launches'] = launches[r['name']]
        if r['name'] == 'lstm_stack_seq_kernel':
            r['lb_cases'] = [dict(T=c['T'], B=c['B'], n_layers=c['n_layers'],
                                  ms=c['ms'], bound_ms=c['bound_ms'],
                                  launches=c['launches'])
                             for c in stack_lb['cases'] + [
                                 stack_lb['deep']['case']] if 'ms' in c]
    rows += op_rows
    for r in rows:
        check(r['launches'] > 0, f"{r['name']} never launched on the path")
    keys = ('name', 'route', 'source', 'replaces', 'launches',
            'train_launches', 'moe_launches', 'cross_launches',
            'recurrent_launches', 'family_train_launches',
            'depth_train_launches', 'max_abs_err', 'ms', 'plain_ms',
            'bound_ms', 'bound_by', 'library_ms', 'tol', 'ok', 'shape',
            'geometry', 'cases', 'lb_cases')
    kernels = {'kernels': [{k: r[k] for k in keys if k in r} for r in rows]}
    phase_s['build'] = build_s
    phase_s['total'] = time.perf_counter() - t_start
    print('phase seconds: ' + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            card=card, build_s=build_s, slots=SLOTS, chunk=CHUNK,
            torch=torch.__version__, cuda=torch.version.cuda,
            kernels=rows, stack_kernel_weights=stacking, engine=runs,
            engine_max_abs_diff=worst, engine_timing=timing, f4=f4,
            fault=fault,
            profiles=profiles,
            stack_kernel_weights_q=q_stacking, int8_deploy=deploy,
            train_grad_rel_err=grad_err, train=train, train_cli=cli,
            tune=tuned, examples=examples, systolic=systolic, die=die,
            lm=lm, lm_train=lm_train, moe=moe, cross=cross, recurrent=rec,
            family_train=fam, depth_train=depth, dryrun=dry,
            stack_lb=stack_lb, phase_seconds=phase_s),
            indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
