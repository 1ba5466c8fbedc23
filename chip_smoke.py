#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero without
them. Phases, each printed on its own line with its wall time:

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. hold every kernel against its plain PyTorch version on the card at the
     main path's shapes: the fused inject+scrub (single-rail arena at 0.56 V
     and 0.54 V, both re-encode settings) and its per-domain form
     (multi-rail arena) and the SECDED decode (faulty embedding) bit for bit,
     the fused decode+matmul at every qwen3-0.6b (K, N) within
     1e-4 * max|plain| (the tensor cores sum in another order) at M = batch
     (its decode kernel), M = 20 (a speculative verify block) and M = batch
     x prompt (its tiled kernel), each with its byte bound, its bf16 MMA
     bound (three pieces of x) and the old float32 FFMA bound, the M = batch
     rows equal to the same rows of the M = batch x prompt call (one chunk
     order in both kernels), and the
     per-domain form with out-of-range domain ids; the SECDED encode over
     the weight arena and a 64-page KV arena and in its token-commit form,
     and the paged scrub-on-read over that arena at 0.54 V with duplicated
     and scratch page ids, bit for bit; then every codec variant (parity65,
     ileave88, dected79) of the inject+scrub in both forms, the encode in
     both forms, the decode and the paged scrub, bit for bit: at the codec
     path's shapes (its three weight groups and the 55 M-word arena under
     dected79 at 0.56 V and 0.54 V with masks from the device field
     (``VARIANT_MASKS``), both re-encode settings; the decode over the parity65 and dected79 groups; a 64-page
     KV arena under each codec with duplicate and scratch page ids), and
     the variants no path runs (inject+scrub under parity65 and ileave88,
     its domain form and the decode under ileave88) on masks drawn on the
     card; then, for every codec, the edge cases of the token commit (one
     row, a verify block, a 4 x 32-token prompt, an odd row width, row bases
     off a quad boundary) and of the inject+scrub in both forms (planes cut
     at word offsets 1-3, one plane off 16 bytes, 1, 3, 5 and 4,097 words,
     domain boundaries inside quads and out-of-range ids), of the decode
     (1, 3, 5 and 4,099 words, planes at word offsets 1-3, a stacked 3-D
     leaf, on words with 0-3 flipped bits, so every status) and of the fault
     injection (the same, and whole 4,096-word blocks with a tail that is
     not a multiple of 16), bit for bit. The fault injection is timed beside
     its library call (three torch.bitwise_xor), and every decode entry
     names the loop its timed call took (quad or word) and the loops the
     decodes of phases 4-9 took. Every token-commit row carries the floor of one
     launch in the same timing loop (a one-element in-place add). The
     paged scrub is timed with its faults restored before every call (and
     the L2 filled with clean lines), so each timed call scrubs
     the same faulty words; its row gives the (clean, corrected, detected)
     counts of those words, the words that change, its bound at those
     counts and the earlier two-pass design's bound of 26 / 32 B a word
     beside it;
  3. the tiny config through the port on the card and on the CPU, SECDED
     and per-domain-codec engines: equal tokens and equal counters;
  4. the full-width qwen3-0.6b engine, single-rail: nominal generate,
     0.56 V generate, prefill and decode step wall times, DED-canary
     autotune from ``HOST_WALK_START_V`` = 0.60 V (host masks), power report;
  5. the same on a multi-rail engine (per-domain locks), without the 0.56 V
     step (``HOST_STEP_VOLTS``);
  6. paged SECDED KV serving (``ServingEngine.serve``) at full width on an
     inline single-rail engine: nominal paged serve against dense
     ``generate`` (equal tokens), a stream of 8 mixed requests at a 0.56 V
     kv rail in an arena small enough to preempt (corrections required),
     shared prefixes against private pages and speculative decoding
     against greedy (equal tokens); then a multi-rail engine walking its
     kv rail; and a breakdown of a stream's decode step, token commit,
     fault interval and scrub;
  7. the paper's Fig. 3 NN accelerator at full width (784-256-128-10, 600
     training steps on 20,000 synthetic-MNIST images, 4,000 test images):
     a rail sweep from V_nom and from V_min down to V_crash with ECC on and
     off (error, divergence from the clean predictions, coverage, power,
     BRAM saving), fused against naive reads, per-leaf against batched
     steps, and the fused matmul at the MLP's M = 4,000 (its rows 0-3 equal
     to an M = 4 call's);
  8. the per-leaf inline engine (``batched=False``) at 0.56 V against
     phase 4's batched engine (planes, counters, tokens), and a domain-mode
     engine at nominal (read-back bit for bit the params it wrote, tokens
     of the unprotected model) and at 0.56 V (every array and the counters
     held against B7 + B5's plain versions on the same masks);
  9. the per-domain-codec engine at full width (multi-rail, attention under
     parity65, MLP under dected79, embedding under secded72, KV pages under
     ileave88): nominal tokens equal to phase 5's SECDED engine, a 0.56 V
     step whose counters equal the plain versions' on the same masks, the
     DED-canary autotune from ``HOST_WALK_START_V`` (per-domain locks, codecs and check
     bits of the power report), generate at the locks, paged serve equal to
     dense generate and an 8-request stream at a 0.56 V kv rail
     (corrections required); then a single-rail dected79 engine (one 0.56 V
     step, generate). Each rail step must launch the domain inject+scrub
     once per codec group (the single-rail engine: the inject+scrub once),
     each refresh the decode once per leaf under a codec other than SECDED
     and once for the embedding and the SECDED encode once per re-encoded
     leaf;
  10. the device fault field (``DeviceFaultField``, the fault-field
     kernel, ``csrc/fault_field.cu``): phases 4-5's engines with
     ``mask_source="device"``: a 0.56 V step (one field launch per codec
     group, none at nominal; no host-to-device copy of 1 MiB or more, by a
     dispatch mode over its PyTorch operations, first shown to see an
     arena-size copy), the DED-canary autotune from 0.62 V with its locks
     beside phases 4-5's host-mask locks, a DED-free final scrub and
     generate at the locks; then the kernel against its plain version bit
     for bit for every check width (1, 8, 15, 24): scalar and per-word rates
     (a third of the words at rate 0) at 0, 1, 3, 4,097 and 2^20 + 5 words,
     and at the main path's sizes: the single-rail arena's and a KV
     interval's word counts at 0.56 V and the multi-rail store's own field
     with the per-word rates it builds at mixed rails (one domain at rate
     0); its SASS size (cuobjdump) and its time at those three sizes beside
     its bound and the plain version's; the device field against the host
     field over 4 M words at 0.56/0.55/0.54 V (total flips within 0.6-1.6x,
     multi-bit share of faulty words within 0.1); FIP from 0.58 to 0.54 V
     over the full arena;
  11. the flight recorder (``repro_torch.obs``) on phase 6's engine and
     stream (8 requests, 4 lanes, 14 pages, one preemption, kv rail 0.56 V,
     the prefix trie on), then a speculative serve of the shared-prefix
     requests: the same run without a recorder, with one and with one
     under the dispatch profiler gives equal tokens, KV counters, kv
     voltages, steps and launches per kernel and codec; the two traced
     runs give byte-identical JSONL that the schema validates (events by
     kind per serve: an admission per request and per preemption, a
     retirement per request, a ``kv_scrub`` and three gauges per interval);
     the profiler's rows (CUDA events, tagged ``cuda``) and the serve wall
     times with and without the recorder (printed, not gated);
  12. codec escalation (ladder secded72 -> dected79) on a multi-rail engine
     with device masks: the DED-canary autotune from 0.62 V (an arena rail
     escalates at an unchanged voltage, each domain's store code equals its
     rail's, the power report's check bits follow the codes), then phase
     6's stream with ``walk_kv`` and the prefix trie on, whose kv rail
     escalates mid-stream (every request completes at its length, a
     ``kv_codec_change`` in the trace, the arena's code = the rail's, token
     commits and interval scrubs under both codes and none under the new
     code before the change, the kv power under the new code, and
     ``scrub_overlap=None`` shown to run serialized: no overlap gauge under
     the dispatch profiler); its launches per codec are path
     ``escalation`` (E in ``PERF.md``); then ``KVPageArena.change_codec``
     on the 64-page arena with committed payload, secded72 to each other
     code: refused over a planted uncorrectable word on a shared page (the
     page named, code and planes unchanged, the DED still counted), then
     one encode under the new code, contents bit for bit and no DED; and
     phase 6's stream on a ``walk_kv`` engine with ``scrub_overlap`` True
     and False: equal tokens, counters, kv voltages, steps and launches;
  13. environment scenarios (``repro_torch.core.scenario``; the fault-field
     kernel's burst expansion): the burst kernel against its plain version
     bit for bit for every check width, each single-class profile and each
     environment's burst, scalar and per-word rates (every third word at
     rate 0) at 0, 1, 3, 4,097 and 2^20 + 5 words; under the avionics burst
     at its scenario voltage, at the single-rail arena's, a KV interval's and
     the multi-rail store's word counts, timed beside the burst-free kernel
     and its integer bound (what the function needs: the kernel's
     re-derivation of the word before is reported apart, not counted), a
     superset of the burst-free masks; the device burst field against the
     host burst field over 4 M words at each environment's scenario voltage
     (phase 10's bounds), FIP over the full arena; single-rail device-mask
     engines under avionics at the scenario voltage (ileave88 corrects more
     and detects less than secded72), the autotune from 0.62 V without an
     environment, under consumer and under avionics (the avionics lock at or
     above the lock without one); ``SCEN_REQUESTS`` of phase 6's stream, at
     most ``SCEN_NEW_TOKENS`` new tokens each, on 4 lanes under avionics at a kv
     rail at the scenario voltage (every request at its length, each
     interval's rate fault_rate x aging multiplier, one burst field and one
     paged scrub per interval), then under a neutral environment with drift
     0 and without one (equal tokens, counters and launches);
  14. the accuracy canary, the campaign and the sweeps. Q: qwen2-7b at full
     width (28 layers, d 3584, 28/4 heads, d_ff 18944, vocab 152064, bf16,
     untied, seeded nonzero QKV biases; 815,661,056 protected words, device
     masks): the fused matmul at its four (K, N) at M = batch, 20 and batch
     x prompt against the plain version (w2's K = 18,944 takes the tiled
     kernel at every M) beside torch.matmul and its bound, the M = batch
     rows equal to the same rows at M = batch x prompt, the encode over the
     whole arena bit for bit; then generate, ``sequence_logits`` (its last
     position equal to prefill's logits bit for bit), the canary at nominal
     (exactly 0.0) and three autotune walks from V_min: with ECC and the
     canary, without ECC (the DED counters are blind: the walk must reach
     the floor with no DED) and without ECC with the canary (it must back
     off on divergence alone, above the blind lock). CA: ``run_campaign``
     at qwen3-0.6b's width (parity65, secded72, ileave88 at ``CA_VOLTAGES``,
     1.0 and 0.57 V; host masks): nominal rows clean, faulty words growing
     down the rail. SW: the sweep CLI over the paper grid at 512 Ki words (every
     point equal to the per-point device field + inject+scrub loop), rail
     schedules on the multi-rail store's geometry (equal to the store's own
     device-path telemetry) and the codec schemes at V_crash (the stronger
     codes correct more);
  15. the rest of the dense family. MN: minitron-8b at full width (32
     layers, d 4096, 32/8 heads, d_ff 16384 non-gated relu^2, vocab 256000,
     bf16, untied; 704,643,072 protected words, device masks): the fused
     matmul at its four (K, N) at M = batch, 20 and batch x prompt against
     the plain version (w2's K = 16,384 takes the tiled kernel at every M),
     a traced prefill (192 tiled events) and decode step (160 decode-kernel
     and 32 tiled events, each the wrapper's count), generate,
     ``sequence_logits`` (its last position = prefill's bit for bit), an
     ECC walk from V_min, then an engine with the int8 KV cache
     (``kv_quant``): its prefill logits equal the bf16 cache's bit for bit
     (prefill attends unquantised K/V), its cache bytes, first-step logit
     difference and token agreement printed. QP: qwen1.5-4b at full width
     (40 layers, d 2560, 20/20 heads, seeded QKV biases; 396,492,800 words,
     device masks) through ``serve`` on phase 6's stream at a nominal kv
     rail (every request equal to dense ``generate``) and at a 0.56 V kv
     rail (token agreement printed, not required: SECDED leaves DED words
     as they are), B4's commit and
     B6's interval scrub at its 819,200-word pages, and ``serve`` refusing
     a ``sliding_window`` and a ``kv_quant`` config before any page. W:
     qwen3-0.6b with a 4,096-token sliding window (mixtral-8x22b's), depth
     cut to ``W_LAYERS`` = 2 layers: a
     4,608-token prompt and 16 decode steps through the 4,096-slot ring
     against a position-indexed cache with the window as a mask: prefill
     and every step's logits and the ring's slots (slot j = position p,
     p % 4,096 = j) bit for bit, the decode loop from the ring's prefill
     state = the ring's tokens;
  16. the MoE family at full width, 2 layers each (``MOE_LAYERS``; device
     masks; an MoE layer's experts, router and shared expert stay plain, so
     B3 runs on the four attention matrices of a layer). MX: mixtral-8x22b
     (d 6144, 48/8 heads, d_ff 16384, 8 experts top-2, window 4096, vocab
     32768, bf16; 2,415,919,104 expert weights a layer): the fused matmul at
     its (K, N) at M = batch, 20 and batch x prompt against the plain version,
     a traced prefill (4 tiled events a layer) and decode step (4
     decode-kernel events a layer, each the wrapper's count) and the
     decode step's device time split into B3, the cuBLAS GEMMs and the
     rest; the card's top-k and sort dispatch over every layer's router
     logits of a prefill and a decode step equal to the CPU's over the same
     logits (the dropped share at the
     published capacity factor printed); layer 0's MoE at cf = E / k: each
     row alone = the batch bit for bit, and = a plain per-token mixture
     (each token through its top-k experts, the same expert products, the
     bf16 combine in expert order) bit for bit, the float32 mixture's
     difference printed; generate, ``sequence_logits`` (its last position =
     prefill's), an ECC walk; domain mode on one layer (every leaf, the 4-D
     bf16 experts included, written and read at nominal; tokens = the
     unprotected engine's). LS: llama4-scout-17b-a16e (d 5120, 40/8 heads,
     d_ff 8192, 16 experts top-1 + a shared expert, vocab 202048) through the
     same checks, then phase 6's stream through ``serve`` at a nominal kv
     rail: at cf 16 (nothing drops) every request = dense ``generate``; at
     the published cf 1.25 the agreement printed and two runs equal. EX: the
     port's ``examples/torch_quickstart.py`` (its numbers = a CPU run's) and
     ``torch_serve_lm_ecc.py`` (``main`` and ``--share-demo``) on the card,
     their lines printed;
  17. the recurrent families (``models/rwkv6.py``, ``models/mamba.py``).
     RW: rwkv6-3b at its published width and depth (32 layers, d 2560, 40
     heads of 64, d_ff 8960, vocab 65536, LayerNorm, bf16; 3,099,857,920
     parameters): a. the plain model's generate (tokens/s, peak memory,
     prefill wall, the decode step's wall and traced busy time); b. in
     float32, prefill(33)'s last logits = prefill(32) + one decode step
     within 1e-3 x max |logits| (the chunked scan against the step path),
     layer 0's time-mix at S = 128 (two chunks) and over 16 decode steps
     against a float64 recurrence within 1e-4 x max, and a timed 4 x
     2,048-token bf16 prefill (32 chunks); c. a domain-mode engine writing
     all 774,964,480 raw words (B4), its nominal read-back = the params bit
     for bit and its tokens = the plain model's, then a 2-layer cut
     (127,079,680 words) read at 0.56 V with every array and the counters
     held against B7 + B5's plain versions on the same masks; d. the
     single-rail inline engine, whose key rule protects no leaf: 0 words, no
     launch, tokens at 0.56 V = the plain model's; e. a multi-rail inline
     engine with device masks protecting the embedding alone (20,971,520
     words): nominal tokens = the plain model's on the int8 embedding, a
     0.56 V step and generate, the walk from 0.62 V, its locks and power.
     JB: jamba's smoke config (one 8-layer period) through an inline engine
     at 0.56 V with host masks on the card and on the CPU: 14 protected
     leaves, equal tokens and counters, logits within 1e-4 x max; then one
     mamba layer at jamba's published width (d 8192, d_inner 16384, d_state
     16, dt_rank 512, bf16 parameters, batch 4) at S = 128 and over 16
     decode steps against a float64 recurrence, computed in float32 (1e-4)
     and in bf16 (``MAMBA_BF16_RTOL``);
  18. the vlm and audio families (``lm.prefill(img=)``, (B, K, S) tokens,
     ``make_serve_step``). V: llama-3.2-vision-11b at its published width
     (40 layers in periods of 4 self- and 1 cross-attention layers, d 4096,
     32/8 heads, d_ff 14336, vocab 128256, bf16; 9,775,157,264 parameters;
     cross gates seeded to tanh near +-0.5, image embeddings (4, 6,404,
     4,096) from a seeded generator in place of the vision frontend): a.
     the plain model through ``make_prefill_step(img=)`` and 16
     ``make_serve_step`` steps (tokens/s, prefill wall, the decode step's
     wall and traced busy time, peak memory, the image K/V cache's
     839,385,088 B); b. in float32 on the one-period cut (p0-p3 self, p4
     cross): prefill(33) = prefill(32) + a decode step within 1e-3 x max,
     p4's cross attention over the 6,404 cached keys batch-invariant (a lane
     alone and a one-query call bit for bit) and within 1e-4 of a float64
     softmax(QK^T / sqrt(Dh))V, zero gates = the identity bit for bit; c.
     domain mode on the cut (535,309,314 raw words; read-back bit for bit,
     tokens = the plain cut's); d. the inline single-rail engine on the cut
     (136,314,880 words, device masks): a 0.56 V step, then the prefill
     refused naming ``blocks.p4.attn.wk`` with no launch. A: musicgen-medium
     at its published width and depth (48 layers, d 1536, 24/24 heads of 64,
     d_ff 6144 non-gated gelu, LayerNorm, 4 codebooks of 2048, bf16;
     1,384,418,304 parameters): a. the fused matmul at its (K, N) at M =
     batch, 20 and batch x prompt against the plain version beside
     torch.matmul and its bound, and a traced prefill and decode step (288
     tiled / decode-kernel launches); b. float32 prefill(33) = prefill(32) +
     a decode step within 1e-3 x max (the sinusoid swap and RoPE); c. the
     inline single-rail engine (169,869,312 words, device masks): generate
     through the serving steps at nominal and 0.56 V, the walk from 0.62 V;
     d. a multi-rail engine with the codebook tables on the embedding rail
     (1,572,864 words): one B2 and one B5 launch a rail step, the walk's
     locks. Each path first runs its smoke config (cross gates seeded)
     through an inline engine at 0.56 V with host masks on the card and on
     the CPU: equal keys, counters and tokens, logits within 1e-4 x max;
  19. training and checkpoints (path T; ``repro_torch.train``,
     ``optim.adamw``, ``checkpoint.manager``, ``data.pipeline``): a.
     qwen3-0.6b at its published width and depth (28 layers, d 1024, 16/8
     heads of 128, d_ff 3072, vocab 151,936, bf16 parameters, float32
     moments) trained by ``Trainer`` for 8 steps of 4 x 512 tokens from
     ``TokenPipeline`` (remat "full"), with ``RailPolicy(scrub_every=2,
     start_v=0.60, mask_source="device")``: every loss finite, each scrub
     one B4 launch a packed matrix (197), one B2 and one field launch where
     a rail lies below V_min; the same 8 steps without the policy give the
     same losses and final params bit for bit and launch no kernel but the
     checkpoints' B4; the step wall (median of steps 2-8), tokens/s, peak
     memory, one traced step's device busy time and heaviest kernels; b. an
     ECC save (one B4 a leaf) and load (one B5 a leaf) of the 40-leaf
     state, read back bit for bit, their seconds and GB; c. a trainer
     restored from the step-4 checkpoint and run to step 8, whether it is
     bitwise in this process (printed), and the same check, depth cut to a
     step-2 checkpoint of a 4-step run (``T_CHILD_STEPS``), required bit
     for bit in a child process under ``torch.use_deterministic_algorithms``
     and ``CUBLAS_WORKSPACE_CONFIG=:4096:8``; d. the tiny config trained on
     the card and on the CPU from the same params (12 steps, ECC
     checkpoints every 5, ``FaultInjected`` at step 7): one recovery to
     step 5, a falling loss, card = CPU within 1e-3 relative; a flipped bit
     in a saved leaf corrected and two in one word detected, ``restore()``
     falling back, each load through B5 on the card; e.
     ``examples/torch_train_lm.py --steps 40 --fail-at 25`` on the card, its
     lines printed; the path's launches into the kernels line;
  20. the reliability mesh (path MH; ``launch.mesh``, ``distributed.
     {sharding,collectives,meshrel}``, ``ServingEngine(mesh=)``): qwen3-0.6b
     at its published width and depth on an inline multi-rail SECDED
     engine with device masks, seed 0, voltage and walk start 0.60 V,
     phase 6's 8-request stream. a. ``make_reliability_mesh(1)`` against
     the unsharded engine: the reference's three rail schedules
     (planes and counters), ``autotune_voltage(max_rounds=8)``,
     ``serve(walk_kv=True, kv_voltage=0.57, scrub_interval=2)`` (tokens and
     kv counters) bit for bit, ``power_report`` totals within 1e-9; b. 4
     ``per_shard`` shards on the one card (``devices=[card] * 4``): the
     stream at nominal rails = the unsharded engine's tokens, a 0.56 V step
     whose shard rows differ and sum to ``reduced()``, the walk's locks per
     shard, ``serve(walk_kv=True, scrub_interval=1)`` at the locks (every
     request once, round-robin ``shard_of``, kv rows tagged 0-3, kv locks,
     tokens/s), the fleet's power at 0.56 V within 2% of 4 x the
     unsharded engine's; c. 4 ``uniform`` shards: one schedule, each
     domain's lock the highest of b's per-shard locks; d. one 4-shard rail
     step at 0.55 V and one KV scrub step over b's four arenas: every
     shard's field (F) and B2, and B6, = their plain versions on the card
     bit for bit; e. ``examples/torch_serve_lm_ecc.py --mesh-demo``, its
     lines printed. The rail step at 0.56 V is timed unsharded, at 1 and at
     4 shards (wall of the engine step, and the queued store step by CUDA
     events). The mesh engines' launches are the path's: B2 once per shard
     a rail step, B5 once an engine rail step (the embedding), B4 once a
     pack and a token commit, B6 once an interval, B3 once a protected
     matrix of each forward, F at most once a shard step and an interval;
  21. the training mesh (path MT; ``launch.mesh.make_host_mesh``,
     ``distributed.{sharding,collectives}``, ``Trainer(mesh=)``,
     ``checkpoint.load(shardings=)``): MT_WORLD = 2 ranks, processes of this
     script (``--train-mesh-child``) in a ``gloo`` group with both ranks on
     the one card (NCCL refuses two ranks on one card; with a card per rank
     they take NCCL), payloads copied card to card through per-rank
     mailboxes mapped once by CUDA IPC, deterministic algorithms; qwen3-0.6b at its published width and depth,
     phase 19's batch 4 x 512 (2 rows a rank). a. one int8-compressed
     data-parallel step against the plain step (losses within 1e-5
     relative, params within 5e-3: the reference's bounds), a non-zero
     error feedback, and the step bit for bit its one-process emulation
     (both halves' gradients, quantised, summed in rank order, / 2) on
     every rank; the step wall and the collective's bytes and ms (and the
     share of its barriers), beside the card's free memory and the host's
     load when the ranks start; b. 3 steps
     of ``Trainer(mesh=)`` rescaled onto the FSDP shardings of the (2, 1)
     mesh, with ``RailPolicy(scrub_every=1, start_v=0.60, device masks)``
     (rank 0 scrubs the gathered params) and ECC saves every step (rank 0
     writes): losses within 1e-3 relative of phase 19's trainer, rank 0's
     launches B4 a packed matrix and a saved leaf, one B2 a scrub, the
     field below V_min, none on rank 1; c. ``checkpoint.load(shardings=)``
     of the last checkpoint on each rank and on a one-rank mesh in this
     process: each local shard its slice of the saved leaf bit for bit, one
     B5 a leaf on each rank's card; d. a rescale back to whole tensors keeps
     params, m and v bit for bit; e. sub-path MTP, the same ranks on a
     (1, W) mesh whose "model" axis computes (tensor-parallel attention and
     MLP, vocab-parallel embedding and loss; ``collectives.ModelAxis``):
     MT_STEPS steps of ``Trainer(mesh=)`` on the rules' shardings from phase
     19's start, losses within 1e-3 relative of phase 19's, the first step
     its one-process emulation (``train_step.emulate_model_step``, each rank
     in turn) bit for bit, nothing gathered over "model", every
     model-sharded local shard 1 / W of its leaf, no kernel launched by a
     step; the later steps' rank-order sums and barrier waits, each rank's
     peak memory and the step walls; an ECC save at (1, W) (B4 a leaf on
     rank 0) loaded onto (W, 1)'s shardings (B5 a leaf a rank), each rank's
     shards its slices of the saved state bit for bit; f. the same ranks'
     model axis for the other families (slice 24; ``_mtf_part``): MTR,
     rwkv6-3b at its width cut to ``MTR_LAYERS`` = 4 of its 32 layers,
     MT_STEPS steps of ``Trainer(mesh=)``, the first its emulation bit for
     bit, each step's loss within 1e-5 of the unsharded loss at the same
     params and batch on rank 0 (the unsharded trainer's free-running
     losses reported beside them),
     nothing gathered over "model", every model-sharded local leaf half its
     leaf, the activations ``ModelAxis.gather`` moves counted; MTJ, one
     mamba layer at jamba-1.5-large's width, and MTV, one cross-attention
     layer at llama-3.2-vision-11b's width over 6,404 image tokens, each on
     1 x ``MTF_SEQ`` tokens forward and backward: in bf16 output, input
     gradient and local parameter gradients their emulation's bit for bit,
     in float32 output and input gradient within ``MTF_RTOL`` x max|whole|
     of the whole layer; MTA, musicgen-medium cut to ``MTA_LAYERS`` = 4 of
     its 48 layers: one step's loss, params and moments its emulation's bit
     for bit, the loss within 1e-3 of the whole step's; no kernel launched
     in any of them;
  4-21 each zero the kernel launch counts at the start of a path and read
     them at its end, and fail unless every voltage step launched its scrub
     kernel once (B1 single-rail, B2 and the embedding's B5 multi-rail,
     none of the other path's), every forward pass of the protected model
     launched the fused matmul once per protected matrix of each layer
     (7 x 28 = 196 at qwen3-0.6b; the matrices a layer protects and the
     kernel each takes come from ``protected`` and ``b3_split``), every
     weight pack and token commit launched the
     encode once, every fault interval and prefix-hit admission launched
     the paged scrub once, every KV fault interval below V_min and every
     device-mask step of a codec group below V_min launched the fault field
     once, every per-leaf step and every domain read launched the fault
     injection and the decode once per leaf, and the plain codec never ran
     on the card;
  22. one prefill and one decode step of paths 4-5 under torch.profiler
     (device busy time, idle share, fused-matmul time inside the step, which
     must come from the decode kernel in a decode step and the tiled kernel
     in a prefill), tokens/s, voltage-step times and one
     ``{"kernels": [...]}`` line with times, bounds and per-path launch
     counts. The fused matmul has two entries, one per kernel behind its
     one launcher: decode (``ecc_matmul_decode_kernel``, timed at M = batch)
     and prefill (``ecc_matmul_kernel``, timed at M = batch x prompt); its
     count is split between them by the kernel each call took
     (``ecc_matmul.kernel_for``: at most ``DECODE_MAX_M`` rows and K up to
     8,832 take the decode kernel); the codec-generic kernels have one
     entry per (kernel, codec), their launches counted per codec (the fault
     field's by check width, its burst launches in entries of their own). Phases 6 and 9 time the stream's interval
     scrub the same way as phase 2, and the interval's mask draw.

The last line is ``{"ok": true, "device": {...}}``; any failed check raises.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
BATCH, PROMPT_LEN, NEW_TOKENS = 4, 32, 16
VERIFY_M = 20  # a speculative verify block: 4 lanes x 5 positions
MATMUL_RTOL = 1e-4  # |kernel - plain| <= MATMUL_RTOL * max|plain|
PAGED_MAX_LEN, STREAM_PAGES, KV_PAGES = 80, 14, 64
MLP_TRAIN, MLP_TEST = 20000, 4000  # the Fig. 3 benchmark's split
# the per-domain-codec engine of phase 9 (embedding keeps secded72)
CODEC_MIX = {"attention": "parity65", "mlp": "dected79", "kv": "ileave88"}
POPC_PER_SM_CLK = 16  # Hopper's popc issue rate (CUDA guide throughput table)
INT_PER_SM_CLK = 64  # Hopper's 32-bit integer multiply and logic rates (same table)
# One fault-field Philox4x32-10 call and its four planes: 10 rounds of two
# 32 x 32 -> 64-bit multiplies (one IMAD.WIDE each, on the FMA pipe) and
# two three-input XORs (LOP3, on the integer ALU pipe), then a compare and
# a merge per plane on the ALU pipe. The pipes run side by side, so the
# bound is the busier one's: the ALU's.
FIELD_MULS_PER_GROUP = 10 * 2
FIELD_ALU_OPS_PER_GROUP = 10 * 2 + 4 * 2
FIELD_SIZES = (0, 1, 3, 4097, 2**20 + 5)
FIELD_N_CHECKS = (1, 8, 15, 24)  # parity65, secded72, dected79, ileave88
FIELD_STATS_WORDS = 1 << 22
# phase 10's multi-rail rails for the per-word-rate check: two domains below
# V_min, the embedding above it (rate 0, a run of words that draw nothing)
MIXED_RAILS = {"attention": 0.56, "mlp": 0.55, "embedding": 1.0}
# phase 2's codec variants: the masks of their 0.56 and 0.54 V faults on
# phase 9's codec arena and the single-rail dected79 arena, drawn on the
# card by the device field (path F; ~8 s a draw of the numpy field);
# phases 2, 4, 5 and 9 keep the host masks of their main paths
VARIANT_MASKS = "device"
# phase 14: the campaign's rail grid (nominal and one point below V_min)
CA_VOLTAGES = (1.0, 0.57)
# phases 4, 5 and 9: the host-mask DED-canary walks start here: each
# voltage step draws the numpy field of the whole arena (6.4-9.4 s), so the
# walk is cut to lower, trip and lock near V_min (the controller holds its
# start at or above V_min, 0.60 V); phase 10's device-mask walks start at
# 0.62 V
HOST_WALK_START_V = 0.60
# phases 4 and 5: the rails each engine steps to before its walk. The
# multi-rail engine takes no 0.56 V host-mask step: phase 9 steps a
# multi-rail host-mask engine to 0.56 V against the plain versions and
# phase 10 steps this one there with device masks
HOST_STEP_VOLTS = {False: (1.0, 0.56), True: (1.0,)}
# phase 13: its three streams (avionics, neutral, none) serve the first
# SCEN_REQUESTS of phase 6's 8 requests on 4 lanes, each cut to at most
# SCEN_NEW_TOKENS new tokens (phase 6 asks 8-24), so two requests wait for a
# lane
SCEN_REQUESTS, SCEN_NEW_TOKENS = 6, 8
# phase 15: the published full-width arenas (32 x (2 x 4096^2 + 2 x 4096 x
# 1024 + 2 x 4096 x 16384) / 8 and 40 x (4 x 2560^2 + 3 x 2560 x 6912) / 8
# words), and the ring at mixtral-8x22b's window
MN_WORDS, QP_WORDS = 704_643_072, 396_492_800
# the ring's config: qwen3-0.6b at its width, depth cut to W_LAYERS layers
W_WINDOW, W_DECODE, W_LAYERS = 4096, 16, 2
# phase 16: the MoE models' depth cut, and mixtral-8x22b's expert weights a
# layer (8 experts x 3 x 6144 x 16384)
MOE_LAYERS, MX_EXPERT_WEIGHTS = 2, 2_415_919_104
# phase 17: rwkv6-3b's parameters and raw bf16 words (four to a 64-bit word),
# the depth cut of the 0.56 V domain read and its words, the embedding's
# protected int8 words; the tolerances of the recurrent checks (each of max
# |reference|): a chunked float32 prefill against the float32 step path,
# float32 time-mix and float32 mamba against a float64 recurrence, and the
# mamba layer in bf16, its published compute dtype, against the same
# float64 recurrence. In bf16 a decay within 2^-9 of 1 rounds to 1 (the
# slowest of jamba's decays, exp(-delta exp(-6)), lie there) and every
# state to an 8-bit mantissa, so over 144 steps the slow state components
# drift by up to ~1 - 0.998^144 = 25% and the output, their weighted sum,
# by a few percent: its gates are 0.1 (output) and 0.35 (state)
RW_PARAMS, RW_WORDS = 3_099_857_920, 774_964_480
RW_CUT_LAYERS, RW_CUT_WORDS, RW_EMBED_WORDS = 2, 127_079_680, 20_971_520
RW_STEP_RTOL, F64_RTOL = 1e-3, 1e-4
MAMBA_BF16_RTOL, MAMBA_BF16_STATE_RTOL = 0.1, 0.35
RW_LONG = 2048  # the timed long prefill: 32 chunks
# phase 18: llama-3.2-vision-11b's parameters, its image K/V cache (8 cross
# layers x 4 lanes x 6,404 tokens x 8 heads x 128 x K and V x 2 B), the raw
# bf16 words of its one-period cut (p0-p3 self, p4 cross) and the cut's
# inline arena (5 x 27,262,976 words, the cross wk / wv among them);
# musicgen-medium's parameters, its inline arena (48 x 6 matrices) and its
# four codebook tables' int8 words
V_PARAMS, V_IMG_KV_BYTES = 9_775_157_264, 839_385_088
V_CUT_WORDS, V_CUT_INLINE_WORDS = 535_309_314, 136_314_880
A_PARAMS, A_WORDS, A_EMBED_WORDS = 1_384_418_304, 169_869_312, 1_572_864

T0 = time.perf_counter()


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        print(f"[phase] {self.name}: start at {self.t - T0:.1f} s", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            print(
                f"[phase] {self.name}: done in {time.perf_counter() - self.t:.2f} s "
                f"| {gpu_line()}",
                flush=True,
            )
        return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- path T
# phase 19: qwen3-0.6b trained at full width (path T): steps, batch, sequence
# length and the step its checkpoint is resumed from; the tiny trainer's
# steps, fault step and card-against-CPU tolerance (the CPU tests' 12-step
# trajectory tolerance); the example's arguments
T_STEPS, T_BATCH, T_SEQ, T_RESUME_AT = 8, 4, 512, 4
T_CHILD_STEPS, T_CHILD_RESUME_AT = 4, 2  # the deterministic child's run, depth cut
T_TINY_STEPS, T_TINY_FAULT, T_TINY_RTOL = 12, 7, 1e-3
T_EXAMPLE_ARGS = ["--steps", "40", "--fail-at", "25"]
T_CHILD_FLAG = "--train-resume-child"
T_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=64, head_dim=16)


def _train_setup(cfg):
    """Path T's trainer configuration and data: AdamW warming up over 2 of
    the 8 steps, full remat, the pipeline at batch 4 x 512 tokens."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=T_STEPS),
                     remat="full")
    return tc, TokenPipeline(DataConfig(vocab=cfg.vocab, global_batch=T_BATCH, seq_len=T_SEQ))


def _losses(hist) -> list:
    return [r["loss"] for r in hist if "loss" in r]


def _bits_equal(a, b) -> bool:
    """Two trees of tensors equal in keys, dtype, shape and bits."""
    import torch

    from repro_torch.models import base

    fa, fb = base.flatten(a), base.flatten(b)
    return len(fa) == len(fb) and all(
        ka == kb and x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for (ka, x), (kb, y) in zip(fa, fb))


def _resume_run(cfg, dev, ckpt_dir, steps: int, at: int) -> dict:
    """An uninterrupted run of ``steps`` steps that checkpoints at ``at``,
    and a second trainer restored from that checkpoint and run to
    ``steps``: the resumed steps' losses and the final states compared bit
    for bit."""
    from repro_torch.train.trainer import Trainer

    tc, pipe = _train_setup(cfg)
    full = Trainer(cfg, tc, pipe, ckpt_dir, ckpt_every=at, device=dev)
    full.run(at)
    full.ckpt_every = 10**9
    full.run(steps - at)
    res = Trainer(cfg, tc, pipe, ckpt_dir, ckpt_every=10**9, device=dev)
    require(res.restore(at) and res.step == at, "T resume: restore")
    res.run(steps - at)
    a, b = _losses(full.history)[at:], _losses(res.history)
    return {"losses_uninterrupted": a, "losses_resumed": b,
            "bitwise": a == b and _bits_equal(full._state(), res._state())}


def train_resume_child(argv) -> int:
    """Path T's resume check in deterministic mode (the parent starts this
    process with CUBLAS_WORKSPACE_CONFIG=:4096:8), checkpointing under
    ``argv[0]``; prints one JSON line and exits 0 when the resumed run
    equals the uninterrupted one bit for bit."""
    import tempfile

    import torch

    from repro_torch.configs import get_config

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="child_", dir=argv[0]) as d:
        try:
            out = _resume_run(get_config("qwen3-0.6b"), torch.device("cuda"), d,
                              T_CHILD_STEPS, T_CHILD_RESUME_AT)
        except RuntimeError as e:  # an operation without a deterministic form
            out = {"bitwise": False, "error": str(e).splitlines()[0]}
    print(json.dumps(out), flush=True)
    return 0 if out["bitwise"] else 1


def _flip(path: str, offset: int, bits: int) -> None:
    """XOR ``bits`` into the byte ``offset`` (from the end) of a file."""
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[offset] ^= bits
    with open(path, "wb") as f:
        f.write(bytes(raw))


def _traced_step(fn, dev, top: int = 6) -> dict:
    """Wall time of ``fn`` (synchronised) and, from torch.profiler's CUDA
    trace of one more call, the device's busy time (the union of its
    events), idle share and the ``top`` kernels by device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == cuda)
    if not evs:
        return {"wall_ms": 1e3 * wall, "device": "not measured (no device event traced)"}
    busy, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in evs:
        if e > end:
            busy += e - max(s, end)
            end = e
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": 1e3 * wall, "device_events": len(evs), "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / (1e3 * wall),
            "top_kernels_ms": {n[:80]: t / 1e3 for n, t in heavy}}


def train_phase(dev, cfg, tiny_cfg) -> tuple:
    """Path T on ``dev``: a. ``cfg`` trained with a device-mask RailPolicy
    and without it, bit for bit; b. an ECC checkpoint of the state saved
    and loaded back bit for bit; c. the state resumed from step T_RESUME_AT,
    here and in a deterministic child process; d. ``tiny_cfg`` trained on
    ``dev`` and on the CPU with a fault, a recovery and corrupt checkpoints;
    e. the example. Returns (results, the path's record for the kernels
    line)."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.voltage import PLATFORMS
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import base, lm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import FaultInjected, RailPolicy, Trainer

    card = dev.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if card else float("nan")

    t_phase = time.perf_counter()
    out = {}
    total = dict.fromkeys(ops.launch_counts(), 0)
    by_codec = {k: {} for k in ops.launch_counts_by_codec()}
    packs = [0]

    def harvest() -> dict:
        """The launches since the last reset, added to the path's totals."""
        counts = ops.launch_counts()
        for k, n in counts.items():
            total[k] += n
        for k, per in ops.launch_counts_by_codec().items():
            for c, n in per.items():
                by_codec[k][c] = by_codec[k].get(c, 0) + n
        ops.reset_launch_count()
        return counts

    def expect(**kw) -> dict:
        """The launches ``kw``, none of any other kernel (off the card, where
        the plain versions run: none at all)."""
        want = dict.fromkeys(total, 0)
        if card:
            want.update(kw)
        return want

    real_pack = ops.pack_ecc_weights

    def counted_pack(*a, **kw):
        packs[0] += 1
        return real_pack(*a, **kw)

    ops.pack_ecc_weights = counted_pack
    root = tempfile.mkdtemp(prefix=".train_ckpt_", dir=ROOT)
    try:
        tc, pipe = _train_setup(cfg)
        tokens = T_BATCH * T_SEQ
        print(f"  T {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
              f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
              f"{str(cfg.param_dtype).split('.')[-1]} parameters ({lm.param_count(cfg)[0]}), "
              f"float32 moments; batch {T_BATCH} x {T_SEQ} tokens, remat {tc.remat!r}")

        # a. the device-mask rail policy, then the same steps without it
        ops.reset_launch_count()
        pol = RailPolicy(scrub_every=2, start_v=0.60, mask_source="device")
        if card:
            torch.cuda.reset_peak_memory_stats()
        railed = Trainer(cfg, tc, pipe, os.path.join(root, "a"), ckpt_every=10**9, rails=pol,
                         device=dev)
        scrubs, real_scrub = [], railed._rail_scrub

        def traced_scrub():
            """One scrub's rails (start_v before the controller exists) and
            launches."""
            ctl, prof = railed.rail_controller, PLATFORMS[pol.platform]
            # the controller starts at start_v, held within [V_min, V_nom]
            rails = dict(ctl.voltages) if ctl is not None else {
                "all": min(prof.v_nom, max(pol.start_v, prof.v_min))}
            before, p0 = ops.launch_counts(), packs[0]
            real_scrub()
            after = ops.launch_counts()
            scrubs.append({"rails": rails, "packs": packs[0] - p0,
                           "launches": {k: after[k] - before[k] for k in after}})

        railed._rail_scrub = traced_scrub
        t0 = time.perf_counter()
        railed.run(T_STEPS)
        sync()
        wall_a, peak_a = time.perf_counter() - t0, peak_gb()
        la = _losses(railed.history)
        events = [r for r in railed.history if r.get("event") == "rails"]
        counts_a, packs_a = harvest(), packs[0]
        vmin = PLATFORMS[pol.platform].v_min
        for s in scrubs:  # B4 per packed matrix, one B2, the field below V_min
            below = any(v < vmin for v in s["rails"].values())
            want = expect(encode=s["packs"], inject_scrub_domains=1, fault_field=int(below))
            require(s["launches"] == want, f"T a. a scrub at rails {s['rails']} launched "
                    f"{s['launches']}, expected {want}; scrubs {scrubs}")
        below = sum(s["launches"]["fault_field"] for s in scrubs)
        per_scrub = packs_a // len(events)
        require(len(events) == len(scrubs) == T_STEPS // pol.scrub_every
                and all(s["packs"] == per_scrub for s in scrubs)
                and counts_a == expect(encode=packs_a, inject_scrub_domains=len(events),
                                       fault_field=below),
                f"T a. {len(events)} scrubs launched {counts_a} ({packs_a} packs)")
        used = [s["rails"] for s in scrubs]
        require(len(la) == T_STEPS and all(np.isfinite(la)), f"T a. losses {la}")
        railed_params = railed.params
        del railed

        packs[0] = 0
        if card:
            torch.cuda.reset_peak_memory_stats()
        plain = Trainer(cfg, tc, pipe, os.path.join(root, "b"), ckpt_every=T_RESUME_AT,
                        ecc_checkpoints=True, device=dev)
        saves = []
        real_save = plain.save

        def timed_save():
            sync()
            t_ = time.perf_counter()
            real_save()
            sync()
            saves.append(time.perf_counter() - t_)

        plain.save = timed_save
        t0 = time.perf_counter()
        plain.run(T_STEPS)
        sync()
        wall_b, peak_b = time.perf_counter() - t0, peak_gb()
        lb = _losses(plain.history)
        step_s = [r["seconds"] for r in plain.history if "loss" in r]
        med = float(np.median(step_s[1:]))
        counts_b = harvest()
        state = plain._state()
        n_leaves = len(base.flatten(state))
        want = expect(encode=n_leaves * len(saves))
        require(counts_b == want and packs[0] == 0, f"T a. {T_STEPS} steps and {len(saves)} "
                f"saves launched {counts_b}, expected {want}: a train step launches none")
        read_only = la == lb and _bits_equal(railed_params, plain.params)
        require(read_only, "T a. the rail policy changed training: losses "
                f"{la} against {lb}, or the final params differ")
        del railed_params
        out["a"] = {
            "losses_railed": la, "losses": lb, "read_only_bitwise": read_only,
            "step_s": step_s, "median_step_s": med, "tokens_per_step": tokens,
            "tokens_per_s": tokens / med, "peak_gb": peak_b, "peak_gb_railed": peak_a,
            "wall_railed_s": wall_a, "wall_s": wall_b, "rails": events,
            "launches_railed": counts_a, "packs_per_scrub": per_scrub,
            "scrubs_below_vmin": below}
        print(f"  T a. with RailPolicy(scrub_every=2, start_v=0.60, device masks): losses "
              f"{la}; {len(events)} scrubs at rails {used}, DED "
              f"{[e['detected'] for e in events]}, locked {events[-1]['locked']}; each scrub "
              f"{per_scrub} B4 packs + 1 B2 (+ 1 field launch below V_min: {below} of "
              f"{len(events)}); {wall_a:.2f} s, peak {peak_a:.2f} GB")
        print(f"  T a. without it: the same losses and final params bit for bit; step wall "
              f"median (steps 2-{T_STEPS}) {med * 1e3:.1f} ms = {tokens / med:.0f} tokens/s; "
              f"steps {[round(s * 1e3, 1) for s in step_s]} ms; peak {peak_b:.2f} GB (ECC "
              f"saves at steps {T_RESUME_AT} and {T_STEPS} included); {wall_b:.2f} s")

        # one more step traced: device busy time and the kernels that take it
        step_batch = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(T_STEPS).items()}
        run_step = lambda: plain._step_fn(plain.params, plain.opt_state, step_batch)[2]["loss"]
        out["a"]["traced_step"] = _traced_step(run_step, dev) if card else "not measured"
        print(f"  T a. one traced train step: {json.dumps(out['a']['traced_step'])}")

        # b. the ECC checkpoint of the final state, loaded back
        sync()
        t0 = time.perf_counter()
        back = ckpt.load(os.path.join(root, "b"), T_STEPS, state)
        sync()
        load_s = time.perf_counter() - t0
        counts = harvest()
        require(counts == expect(decode=n_leaves) and _bits_equal(back, state),
                f"T b. load launches {counts} ({n_leaves} leaves) or the read-back differs")
        del back
        gb = sum(t.numel() * t.element_size() for _, t in base.flatten(state)) / 1e9
        parity_gb = sum(-(-t.numel() * t.element_size() // 8) for _, t in
                        base.flatten(state)) / 1e9
        out["b"] = {"leaves": n_leaves, "gb": gb, "parity_gb": parity_gb,
                    "save_s": saves[-1], "saves_s": saves, "load_s": load_s,
                    "save_gb_per_s": gb / saves[-1], "load_gb_per_s": gb / load_s}
        print(f"  T b. ECC checkpoint of the step-{T_STEPS} state ({n_leaves} leaves, {gb:.3f} "
              f"GB + {parity_gb:.3f} GB of check bits): save {saves[-1]:.2f} s (one B4 a leaf; "
              f"{gb / saves[-1]:.2f} GB/s), load {load_s:.2f} s (one B5 a leaf; "
              f"{gb / load_s:.2f} GB/s); read-back = the state bit for bit")

        # c. resumed from step T_RESUME_AT: here, then in a deterministic child
        res = Trainer(cfg, tc, pipe, os.path.join(root, "b"), ckpt_every=10**9, device=dev)
        require(res.restore(T_RESUME_AT) and res.step == T_RESUME_AT, "T c. restore")
        res.run(T_STEPS - T_RESUME_AT)
        lc = _losses(res.history)
        main_bitwise = lc == lb[T_RESUME_AT:] and _bits_equal(res._state(), state)
        counts = harvest()
        require(counts == expect(decode=n_leaves), f"T c. resume launches {counts}")
        del res, state, plain
        sync()
        if card:
            torch.cuda.empty_cache()
        det, child_s, rc, err = {"bitwise": None, "error": "not run off the card"}, 0.0, 0, ""
        if card:  # a dry run off the card runs no child
            t0 = time.perf_counter()
            env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
            child = subprocess.run([sys.executable, os.path.abspath(__file__), T_CHILD_FLAG,
                                    root], capture_output=True, text=True, timeout=900, env=env)
            child_s, rc, err = time.perf_counter() - t0, child.returncode, child.stderr[-2000:]
            lines = child.stdout.strip().splitlines()
            det = json.loads(lines[-1]) if lines else {"bitwise": False, "error": err}
        out["c"] = {"main_process_bitwise": main_bitwise, "losses_resumed_main": lc,
                    "deterministic_child": det, "child_s": child_s}
        print(f"  T c. resumed from step {T_RESUME_AT} in this process (default algorithms): "
              f"{'bitwise' if main_bitwise else 'NOT bitwise'} (losses {lc}); in a child with "
              f"use_deterministic_algorithms and CUBLAS_WORKSPACE_CONFIG=:4096:8: "
              f"{json.dumps(det)} ({child_s:.1f} s)")
        require(not card or (rc == 0 and det.get("bitwise")),
                f"T c. the deterministic resume is not bitwise (rc {rc}): {json.dumps(det)} "
                f"{err}")

        # d. the tiny trainer on the card and on the CPU: a fault, a recovery
        tc_t = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100),
                           remat=None)
        dc_t = DataConfig(vocab=tiny_cfg.vocab, global_batch=8, seq_len=32)
        p0 = lm.init_params(tiny_cfg, 0, "cpu")

        def tiny_run(d_, path):
            armed = [True]

            def chaos(step):
                if armed[0] and step == T_TINY_FAULT:
                    armed[0] = False
                    raise FaultInjected("node lost")

            tr = Trainer(tiny_cfg, tc_t, TokenPipeline(dc_t), path, ckpt_every=5,
                         ecc_checkpoints=True, fault_hook=chaos, device=d_)
            tr.params = base.tree_map(lambda t: t.to(tr.device), p0)
            tr.opt_state = adamw.init(tr.params, tc_t.optimizer)
            tr.run(T_TINY_STEPS)
            rec = [r for r in tr.history if r.get("event") == "recovery"]
            require(tr.recoveries == 1 and [r["step"] for r in rec] == [5]
                    and tr.step == T_TINY_STEPS, f"T d. recoveries {rec} on {tr.device}")
            return tr

        tiny_dir = os.path.join(root, "d")
        tr_d = tiny_run(dev, tiny_dir)
        counts = harvest()
        tiny_leaves = len(base.flatten(tr_d._state()))
        require(counts == expect(encode=2 * tiny_leaves, decode=tiny_leaves),
                f"T d. launches {counts}: two saves and one restore of {tiny_leaves} leaves")
        tr_cpu = tiny_run(torch.device("cpu"), os.path.join(root, "d_cpu"))
        l_d, l_cpu = _losses(tr_d.history), _losses(tr_cpu.history)
        rel = max(abs(a - b) / abs(b) for a, b in zip(l_d, l_cpu))
        require(l_d[-1] < l_d[0] and len(l_d) == len(l_cpu) and rel <= T_TINY_RTOL,
                f"T d. losses card {l_d} CPU {l_cpu} (max rel {rel:.2e})")

        # corrupt the step-10 checkpoint's largest leaf: one flipped bit is
        # corrected, two in one word are detected and restore() falls back
        like = tr_d._state()
        flat = base.flatten(like)
        big = max(range(len(flat)), key=lambda i: flat[i][1].numel())
        require(flat[big][1].numel() * flat[big][1].element_size() % 8 == 0, "T d. leaf")
        leaf_file = os.path.join(tiny_dir, "step_000010", f"leaf_{big:05d}.npy")
        clean = ckpt.load(tiny_dir, 10, like)
        _flip(leaf_file, -100, 0x04)
        require(_bits_equal(ckpt.load(tiny_dir, 10, like), clean),
                "T d. a single flipped bit was not corrected")
        _flip(leaf_file, -8, 0x03)
        detected = False
        try:
            ckpt.load(tiny_dir, 10, like)
        except ckpt.CheckpointCorruption as e:
            detected = str(e)
        require(bool(detected), "T d. two flipped bits in one word were not detected")
        require(tr_d.restore() and tr_d.step == 5, f"T d. restore fell back to {tr_d.step}")
        counts = harvest()
        want = expect(decode=3 * tiny_leaves + 2 * (big + 1))
        require(counts == want, f"T d. corrupt-checkpoint launches {counts}, expected {want}")
        out["d"] = {"losses_card": l_d, "losses_cpu": l_cpu, "max_rel": rel,
                    "recovered_to": 5, "detected": detected, "fallback_step": tr_d.step}
        print(f"  T d. tiny trainer ({T_TINY_STEPS} steps, ECC checkpoints every 5, a fault at "
              f"step {T_TINY_FAULT}): one recovery to step 5 on the card and on the CPU; "
              f"losses {l_d[0]:.4f} -> {l_d[-1]:.4f}, card vs CPU max rel {rel:.2e} (<= "
              f"{T_TINY_RTOL}); one flipped bit corrected, two in one word detected "
              f"({detected!r}) and restore() fell back to step 5, each load through B5")
        del tr_d, tr_cpu, clean

        # e. the example on the card
        spec = importlib.util.spec_from_file_location(
            "torch_train_lm", os.path.join(ROOT, "examples", "torch_train_lm.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ex = mod.main(T_EXAMPLE_ARGS + ([] if card else ["--device", "cpu"]))
        for line in buf.getvalue().strip().splitlines():
            print(f"  T e. | {line}")
        counts = harvest()
        # one save (step 25) and one restore of the smoke config's state
        ex_params = len(base.flatten(lm.init_specs(get_smoke_config("qwen3-0.6b")),
                                     is_leaf=lambda x: isinstance(x, base.Spec)))
        want = expect(encode=3 * ex_params + 1, decode=3 * ex_params + 1)
        require(ex["recoveries"] == 1 and counts == want,
                f"T e. example: {ex['recoveries']} recoveries, launches {counts}, expected "
                f"{want}")
        out["e"] = {"losses_first_last": [ex["losses"][0], ex["losses"][-1]],
                    "recoveries": ex["recoveries"], "stragglers": ex["stragglers"],
                    "launches": counts}
    finally:
        ops.pack_ecc_weights = real_pack
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = total
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  T launches {json.dumps(total)}; T in {out['wall_s']:.1f} s")
    record = {"launches": total, "launches_by_codec": by_codec, "kv_codec": "secded72",
              "matmuls_per_forward": 0, "packs": packs_a, "commits": 0,
              "forwards": {"prefill": 0, "decode": 0, "decode_kernel": 0}}
    return out, record


# ---------------------------------------------------------------- path MH
# phase 20: the reliability mesh (path MH): the shard count of the
# multi-shard engines on one card, the reference's three rail schedules of
# the one-shard anchor (tests/test_meshrel.py), the timed rail steps, the
# reference's fleet-power acceptance (tests/test_mesh_serve.py), the voltage
# of part d's rail step, and the fused matmuls of one qwen3-0.6b forward
MH_SHARDS = 4
MH_SCHEDULES = ({"attention": 0.58, "mlp": 0.58, "embedding": 0.58},
                {"attention": 0.55, "mlp": 0.60, "embedding": 0.57},
                {"attention": 0.545, "mlp": 0.545, "embedding": 0.58})
MH_TIMED, MH_POWER_RTOL, MH_CHECK_V = 7, 0.02, 0.55
MH_MAX_LEN = 80  # PAGED_MAX_LEN: the stream's longest request fits


def mesh_phase(dev, cfg, params, stream) -> tuple:
    """Path MH on ``dev``: the reliability mesh of ``cfg`` (inline,
    multi-rail, SECDED, device masks, seed 0, voltage and walk start 0.60),
    ``stream`` its requests. a. a one-shard mesh engine against the
    unsharded engine: the three schedules' planes and counters, the walk,
    a ``walk_kv`` serve and the power report bit for bit; b. MH_SHARDS
    shards, ``per_shard``, on one device: nominal tokens = the unsharded
    engine's, a 0.56 V step whose shard rows differ and sum to the reduced
    view, the walk, a ``walk_kv`` serve at the locks, fleet power within
    MH_POWER_RTOL of MH_SHARDS x one chip; c. ``uniform``: one schedule, each
    domain's lock the highest of b's; d. one rail step at MH_CHECK_V and one
    KV scrub step: F, B2 and B6 on every shard = their plain versions on
    ``dev`` bit for bit; e. the example's ``--mesh-demo``. The launches of
    the mesh engines' runs are the path's (the unsharded engine's and d's
    are not). Returns (results, the path's record for the kernels line)."""
    import contextlib
    import gc
    import importlib.util

    import numpy as np
    import torch

    from repro_torch.core import kvpages
    from repro_torch.core.planestore import PlaneStore
    from repro_torch.distributed import meshrel
    from repro_torch.kernels import ecc_matmul as b3_kernel
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_reliability_mesh
    from repro_torch.models import lm
    from repro_torch.models.base import flatten as base_flatten
    from repro_torch.serving import steps as serve_steps
    from repro_torch.serving.engine import (
        FaultModelConfig, RailsConfig, ReliabilityConfig, ServingEngine,
    )

    card = dev.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {}
    total = dict.fromkeys(ops.launch_counts(), 0)
    by_codec = {k: {} for k in ops.launch_counts_by_codec()}
    b3 = {"decode": 0, "tiled": 0}
    n = dict(packs=0, commits=0, prefill=0, decode=0, decode_kernel=0, matmuls=0,
             matmuls_decode_kernel=0, engine_steps=0, shard_steps=0, field_draws=0, ticks=0,
             kv_draws=0)
    active = [False]

    def sync():
        if card:
            torch.cuda.synchronize()

    def count(key, k_=1):
        if active[0]:
            n[key] += k_

    undo = []

    def wrap(obj, name, on_call):
        real = getattr(obj, name)

        def wrapped(*a, **kw):
            on_call(*a, **kw)
            return real(*a, **kw)

        setattr(obj, name, wrapped)
        undo.append((obj, name, real))

    def forward_kind(params_, tokens, *a, **kw):
        """A forward on the card of a model with protected block leaves: its
        kind, and its fused matmuls (one a protected matrix of a layer)."""
        eccs = [w for _, w in base_flatten(params_["blocks"]) if isinstance(w, ops.EccWeight)]
        if not tokens.is_cuda or not eccs:
            return
        mm = sum(w.lo.shape[0] if w.lo.ndim == 3 else 1 for w in eccs)
        count("decode" if tokens.shape[-1] == 1 else "prefill")
        count("matmuls", mm)
        if tokens.shape[0] * tokens.shape[-1] <= b3_kernel.DECODE_MAX_M:
            count("decode_kernel")
            count("matmuls_decode_kernel", mm)

    wrap(ops, "pack_ecc_weights", lambda *a, **kw: count("packs"))
    wrap(kvpages, "_commit_tokens", lambda *a, **kw: count("commits"))
    wrap(serve_steps, "_commit_tokens", lambda *a, **kw: count("commits"))
    def tick_counts(arena):
        """A KV interval: one scrub, and one field launch below V_min."""
        count("ticks")
        count("kv_draws", int(arena.profile.fault_rate(arena.voltage) > 0))

    def rail_step_counts(store, schedule, ecc=True):
        """A mesh rail step: one B2 launch per (shard, codec group) slice,
        and one field launch per slice holding a domain whose rail on that
        shard lies below V_min (read from the slice's domain ids)."""
        count("shard_steps", store.n_shards * len(store.groups))
        if not active[0]:
            return
        volts, k = store._normalize_schedule(schedule), len(store.domains)
        for g in store.groups:
            L = g.sharded.local_words
            for s in range(store.n_shards):
                held = torch.bincount(g.sharded.dom[s * L:(s + 1) * L].long(),
                                      minlength=k + 1)[:k].tolist()
                count("field_draws", int(any(
                    held[i] and store.domain_profile(d).fault_rate(volts[s][d]) > 0
                    for i, d in enumerate(store.domains))))

    wrap(kvpages.KVPageArena, "tick", tick_counts)
    wrap(lm, "forward", forward_kind)
    wrap(ServingEngine, "_set_rails_mesh", lambda *a, **kw: count("engine_steps"))
    wrap(PlaneStore, "set_rails_sharded_async", rail_step_counts)

    @contextlib.contextmanager
    def path():
        """What runs inside is path MH: its launches join the path's."""
        ops.reset_launch_count()
        active[0] = True
        try:
            yield
        finally:
            active[0] = False
            for k, v in ops.launch_counts().items():
                total[k] += v
            for k, per in ops.launch_counts_by_codec().items():
                for c, v in per.items():
                    by_codec[k][c] = by_codec[k].get(c, 0) + v
            for k, v in ops.ecc_matmul_launches_by_kernel().items():
                b3[k] += v
            ops.reset_launch_count()

    def release():
        """Give back the memory of the engines just deleted."""
        gc.collect()
        if card:
            torch.cuda.empty_cache()

    def rel(policy):
        return ReliabilityConfig(mode="inline", voltage=0.60, seed=0,
                                 fault_model=FaultModelConfig(mask_source="device"),
                                 rails=RailsConfig(multi_rail=True, policy=policy, start_v=0.60))

    def shards_on_dev(k):
        return make_reliability_mesh(k, devices=[dev] * k)

    def engine(policy, mesh=None):
        return ServingEngine(cfg, params, rel(policy), max_len=MH_MAX_LEN, device=dev, mesh=mesh)

    def step_ms(fn) -> list:
        """Wall ms of MH_TIMED synchronous calls (after one warm-up)."""
        fn()
        times = []
        for _ in range(MH_TIMED):
            sync()
            t_ = time.perf_counter()
            fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t_))
        return times

    def queued_ms(fn) -> float:
        """Device ms of one queued call (CUDA events; host clock off the
        card), median of MH_TIMED."""
        times = []
        for _ in range(MH_TIMED):
            sync()
            if card:
                s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s_.record()
                fn()
                e_.record()
                e_.synchronize()
                times.append(s_.elapsed_time(e_))
            else:
                t_ = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t_))
        return float(np.median(times))

    def same_leaves(a, b) -> bool:
        return all(torch.equal(x.lo, y.lo) and torch.equal(x.hi, y.hi)
                   and torch.equal(x.parity, y.parity) for x, y in zip(a, b))

    at056 = lambda e: {d: 0.56 for d in e._store.domains}
    try:
        # a. one shard = unsharded
        t_a = time.perf_counter()
        e0 = engine("uniform")
        mesh1 = make_reliability_mesh(1) if card else shards_on_dev(1)
        with path():
            e1 = engine("per_shard", mesh1)
        require(e1._store.n_shards == 1 and e1._store.groups[0].sharded.pad == 0,
                "MH a. one shard, no pad")
        a_rows = []
        for sched in MH_SCHEDULES:
            l0, d0 = e0._store.set_rails(sched)
            with path():
                l1, s1 = e1._store.set_rails_sharded(sched)
            require(same_leaves(l0, l1), f"MH a. planes at {sched}")
            for d in d0.domains:
                require(d0[d].counters().tolist() == s1[0][d].counters().tolist(),
                        f"MH a. {d} counters at {sched}")
            a_rows.append(d0.total().to_dict())
            del l0, l1
        require(a_rows[-1]["faulty_words"] > 0, "MH a. no fault in the schedules")
        v0, _ = e0.autotune_voltage(max_rounds=8)
        with path():
            v1, h1 = e1.autotune_voltage(max_rounds=8)
        require(v1 == [v0], f"MH a. walk {v1} against {v0}")
        kw = dict(walk_kv=True, kv_voltage=0.57, scrub_interval=2)
        r0 = e0.serve(stream, **kw)
        with path():
            r1 = e1.serve(stream, **kw)
        require(set(r0.outputs) == set(r1.outputs) and all(
            np.array_equal(r0.outputs[i], r1.outputs[i]) for i in r0.outputs),
            "MH a. serve tokens")
        require(r0.kv_stats.counters().tolist() == r1.kv_stats.counters().tolist(),
                f"MH a. kv counters {r0.kv_stats} against {r1.kv_stats}")
        p0, p1 = e0.power_report(), e1.power_report()
        require(abs(p0["total_w"] - p1["total_w"]) < 1e-9
                and abs(p0["saving_vs_nominal"] - p1["saving_vs_nominal"]) < 1e-9,
                f"MH a. power {p0['total_w']} against {p1['total_w']}")
        timing = {"unsharded": {"wall_ms": step_ms(lambda: e0.set_rails(at056(e0))),
                                "queued_ms": queued_ms(
                                    lambda: e0._store.set_rails_async(at056(e0)))},
                  "1": {"wall_ms": step_ms(lambda: e1.set_rails(at056(e1))),
                        "queued_ms": queued_ms(
                            lambda: e1._store.set_rails_sharded_async(at056(e1)))}}
        out["a"] = {"schedules": a_rows, "locks": v0, "kv_stats": r0.kv_stats.to_dict(),
                    "total_w": p0["total_w"], "wall_s": time.perf_counter() - t_a}
        print(f"  MH a. 1 shard = unsharded bit for bit: 3 schedules (last {a_rows[-1]}), "
              f"walk locks {json.dumps(v0)}, walk_kv serve ({len(r0.outputs)} requests, kv "
              f"{r0.kv_stats.to_dict()}), power {p0['total_w']:.9f} W; "
              f"{out['a']['wall_s']:.1f} s")
        # what part b holds the mesh to: the unsharded engine's nominal tokens
        # and its power at 0.56 V
        e0.set_rails({d: 1.0 for d in e0._store.domains})
        nominal = e0.serve(stream, kv_voltage=1.0).outputs
        e0.set_rails(at056(e0))
        e0.rails["kv"] = 0.56
        p0_056 = e0.power_report()["total_w"]
        del e0, e1, r0, r1
        release()

        # b. MH_SHARDS shards, per_shard, on one device
        t_b = time.perf_counter()
        mesh4 = shards_on_dev(MH_SHARDS)
        with path():
            e4 = engine("per_shard", mesh4)
            e4.set_rails({d: 1.0 for d in e4._store.domains})
            rn = e4.serve(stream, kv_voltage=1.0)
        require(all(np.array_equal(rn.outputs[i], nominal[i]) for i in nominal)
                and set(rn.outputs) == set(nominal), "MH b. nominal tokens")
        with path():
            e4.set_rails(at056(e4))
        st = e4._last_scrub
        rows = {tuple(st[s].total().counters().tolist()) for s in range(MH_SHARDS)}
        require(len(rows) >= 2, f"MH b. shard rows all equal: {rows}")
        for d in st.domains:
            block = sum(st[s][d].counters() for s in range(MH_SHARDS))
            require(block.tolist() == st.reduced()[d].counters().tolist(),
                    f"MH b. {d}: block sum against reduced()")
        timing[str(MH_SHARDS)] = {
            "wall_ms": step_ms(lambda: e4.set_rails(at056(e4))),
            "queued_ms": queued_ms(lambda: e4._store.set_rails_sharded_async(at056(e4)))}
        with path():
            locks, _ = e4.autotune_voltage(max_rounds=12)
        require(e4.controller.locked_for(e4._store.domains), f"MH b. walk did not lock: {locks}")
        for s, sch in enumerate(locks):
            print(f"  MH b. shard {s} locks {json.dumps(sch)}")
        with path():
            t_ = time.perf_counter()
            rs = e4.serve(stream, walk_kv=True, scrub_interval=1)
            sync()
            serve_s = time.perf_counter() - t_
        toks = sum(len(v) for v in rs.outputs.values())
        require(sorted(rs.outputs) == list(range(len(stream)))
                and all(len(rs.outputs[i]) == k for i, (_, k) in enumerate(stream)),
                "MH b. serve at the locks: every request once, at its length")
        require(rs.shard_of == {i: i % MH_SHARDS for i in range(len(stream))},
                f"MH b. shard_of {rs.shard_of}")
        require([x.shard for x in rs.kv_stats_by_shard] == list(range(MH_SHARDS)),
                "MH b. kv_stats_by_shard tags")
        kv_locks = [e4.rails[s]["kv"] for s in range(MH_SHARDS)]
        print(f"  MH b. serve at the locks (walk_kv, scrub every step): {toks} tokens in "
              f"{serve_s:.2f} s = {toks / serve_s:.1f} tokens/s, {rs.steps} steps, kv locks "
              f"{kv_locks}, kv by shard {[x.to_dict() for x in rs.kv_stats_by_shard]}")
        e4.set_rails(at056(e4))
        for s in range(MH_SHARDS):
            e4.rails[s]["kv"] = 0.56
        p4 = e4.power_report()["total_w"]
        require(abs(p4 - MH_SHARDS * p0_056) <= MH_POWER_RTOL * MH_SHARDS * p0_056,
                f"MH b. fleet {p4} W against {MH_SHARDS} x {p0_056} W")
        out["b"] = {"locks": locks, "kv_locks": kv_locks, "serve_s": serve_s, "tokens": toks,
                    "tokens_per_s": toks / serve_s, "steps": rs.steps,
                    "kv_stats_by_shard": [x.to_dict() for x in rs.kv_stats_by_shard],
                    "fleet_w": p4, "one_chip_w": p0_056,
                    "fleet_ratio": p4 / (MH_SHARDS * p0_056),
                    "rows_056": [list(r) for r in rows], "wall_s": time.perf_counter() - t_b}
        print(f"  MH b. {MH_SHARDS} shards on one device: nominal tokens = unsharded; 0.56 V "
              f"rows differ ({len(rows)} distinct) and sum to reduced(); fleet {p4:.6f} W = "
              f"{out['b']['fleet_ratio']:.6f} x {MH_SHARDS} x {p0_056:.6f} W; "
              f"{out['b']['wall_s']:.1f} s")

        # d. F, B2 and B6 on the new callers against their plain versions
        t_d = time.perf_counter()
        store = e4._store
        rates = meshrel.schedule_rates({d: MH_CHECK_V for d in store.domains}, store.domains,
                                       {d: store.domain_profile(d) for d in store.domains},
                                       MH_SHARDS)
        worst = 0
        for g in store.groups:
            sg = g.sharded
            step = meshrel.make_rail_step(mesh4, sg.local_words, len(store.domains), g.name,
                                          sg.fields, sg.present)
            flo, fhi, fchk, cnt = step(sg.lo, sg.hi, sg.check, sg.dom, rates)
            L = sg.local_words
            for s, f in enumerate(sg.fields):
                cut = slice(s * L, (s + 1) * L)
                rate_w = torch.index_select(torch.as_tensor(rates[s], device=dev), 0,
                                            sg.dom[cut])
                got = ops.fault_field(f.f_row, rate_w, f.key, g.codec.n_check)
                want = ref.fault_field_plain(f.f_row, rate_w, f.key, g.codec.n_check,
                                             ref.burst_thresholds(None), chunk_words=1 << 22)
                require(all(torch.equal(x, y) for x, y in zip(got, want)),
                        f"MH d. shard {s} field")
                plain = ref.inject_scrub_domains_ref(sg.lo[cut], sg.hi[cut], sg.check[cut],
                                                     *want, sg.dom[cut], len(store.domains),
                                                     codec=g.name)
                require(all(torch.equal(x, y) for x, y in zip(
                    (flo[cut], fhi[cut], fchk[cut], cnt[s]), plain)),
                    f"MH d. shard {s} B2 against its plain version")
                worst = max(worst, int(cnt[s][:, 1:3].sum()))
                del got, want, plain
        require(worst > 0, "MH d. no corrected or detected word at the check voltage")
        arenas = e4.kv_arenas
        wpp = arenas[0].geom.words_per_page
        for a in arenas:
            a.set_voltage(MH_CHECK_V)
            a.tick()
        planes = [torch.cat([getattr(a, k) for a in arenas]) for k in ("lo", "hi", "parity")]
        saved = [p.clone() for p in planes]
        table = np.tile(np.arange(arenas[0].n_pages + 1, dtype=np.int32), (MH_SHARDS, 1))
        kv_step = meshrel.make_kv_scrub_step(mesh4, wpp, arenas[0]._total_words, table.shape[1])
        klo, khi, kpar, kpay, kcnt = kv_step(*planes, table)
        Lk = arenas[0]._total_words
        for s in range(MH_SHARDS):
            cut = slice(s * Lk, (s + 1) * Lk)
            w = [p[cut].clone() for p in saved]
            ppay, pcnt = ref.gather_scrub_ref(*w, torch.as_tensor(table[s], device=dev), wpp,
                                              arenas[s].codec_name)
            require(all(torch.equal(x, y) for x, y in zip((klo[cut], khi[cut], kpar[cut]), w))
                    and torch.equal(kpay[s].view(torch.int32), ppay.view(torch.int32))
                    and torch.equal(kcnt[s], pcnt),
                    f"MH d. shard {s} B6 against its plain version")
        kv_fixed = int(kcnt[:, :, 1:3].sum())
        require(kv_fixed > 0, "MH d. the KV scrub step found no fault")
        out["d"] = {"b2_words_corrected_or_detected_max": worst, "kv_corrected_detected": kv_fixed,
                    "max_abs_err": 0, "wall_s": time.perf_counter() - t_d}
        print(f"  MH d. F, B2 ({len(store.groups)} group x {MH_SHARDS} shards at {MH_CHECK_V} V) "
              f"and B6 ({MH_SHARDS} arenas, {table.shape[1]} pages each, {kv_fixed} words "
              f"corrected or detected) = their plain versions bit for bit; "
              f"{out['d']['wall_s']:.1f} s")
        del planes, saved, klo, khi, kpar, kpay, kcnt, flo, fhi, fchk, store, arenas, step
        del e4, rs, rn
        release()

        # c. uniform: one schedule at the worst shard's lock
        t_c = time.perf_counter()
        with path():
            eu = engine("uniform", shards_on_dev(MH_SHARDS))
            ulocks, uhist = eu.autotune_voltage(max_rounds=12)
        require(all(x == ulocks[0] for x in ulocks), f"MH c. uniform schedules {ulocks}")
        worst_lock = {d: max(x[d] for x in locks) for d in ulocks[0]}
        require(ulocks[0] == worst_lock, f"MH c. uniform {ulocks[0]} against the highest "
                f"per-shard locks {worst_lock}")
        require(all(s == -1 for s, _ in uhist), "MH c. a uniform walk carries no shard")
        out["c"] = {"locks": ulocks[0], "wall_s": time.perf_counter() - t_c}
        print(f"  MH c. uniform: one schedule {json.dumps(ulocks[0])} = the highest per-shard "
              f"lock of each domain; {out['c']['wall_s']:.1f} s")
        del eu
        release()

        # e. the example
        spec = importlib.util.spec_from_file_location(
            "torch_serve_lm_ecc", os.path.join(ROOT, "examples", "torch_serve_lm_ecc.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        with path(), contextlib.redirect_stdout(buf):
            ex = mod.main(["--mesh-demo"] + ([] if card else ["--device", "cpu"]))
        for line in buf.getvalue().strip().splitlines():
            print(f"  MH e. | {line}")
        require(ex["requests"] == 3 * ex["n_shards"], f"MH e. example {ex}")
        out["e"] = {"n_shards": ex["n_shards"], "requests": ex["requests"],
                    "saving": ex["saving"]}
    finally:
        for obj, name, real in reversed(undo):
            setattr(obj, name, real)

    out["rail_step"] = timing
    for k, v in timing.items():
        print(f"  MH rail step at 0.56 V, {k} shard(s): wall median "
              f"{float(np.median(v['wall_ms'])):.3f} ms (calls {[round(x, 3) for x in v['wall_ms']]}), "
              f"queued device {v['queued_ms']:.3f} ms")
    if card:
        want = {"inject_scrub_domains": n["shard_steps"], "decode": n["engine_steps"],
                "encode": n["packs"] + n["commits"], "ecc_matmul": n["matmuls"],
                "gather_scrub": n["ticks"], "inject_scrub": 0, "inject": 0}
        got = {k: total[k] for k in want}
        require(got == want, f"MH launches {got}, expected {want}")
        require(total["fault_field"] == n["field_draws"] + n["kv_draws"],
                f"MH field launches {total['fault_field']}, expected "
                f"{n['field_draws']} + {n['kv_draws']}")
        require(b3["decode"] == n["matmuls_decode_kernel"], f"MH B3 by kernel {b3}")
        require(all(total[k] > 0 for k in ("inject_scrub_domains", "decode", "encode",
                                           "ecc_matmul", "gather_scrub", "fault_field")),
                f"MH: a kernel of the path never launched: {total}")
    out["launches"] = total
    out["counts"] = dict(n)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  MH launches {json.dumps(total)} ({json.dumps(n)}); MH in {out['wall_s']:.1f} s")
    record = {"launches": total, "launches_by_codec": by_codec, "kv_codec": "secded72",
              "b3_by_kernel": dict(b3), "packs": n["packs"], "commits": n["commits"],
              "forwards": {"prefill": n["prefill"], "decode": n["decode"],
                           "decode_kernel": n["decode_kernel"]}}
    return out, record


# ---------------------------------------------------------------- path MT
# phase 21: the training mesh (paths MT and MTP): W ranks of a process group (gloo
# with every rank on the one card, NCCL with a card per rank), phase 19's
# trainer configuration; the sharded trainer's steps; the tolerances: the
# compressed step's loss against the plain step's and its params (the
# reference's own bounds, tests/test_train_ckpt.py), the sharded trainer's
# losses against phase 19's one-card trainer (the CPU tests' trajectory
# tolerance)
MT_WORLD, MT_STEPS = 2, 3
MT_LOSS_RTOL, MT_PARAM_ATOL, MT_TRAJ_RTOL = 1e-5, 5e-3, 1e-3
MT_CHILD_FLAG = "--train-mesh-child"


def _mt_config(spec: dict):
    from repro_torch.configs import get_config
    from repro_torch.models import base

    return get_config(spec["arch"]) if "arch" in spec else base.ModelConfig(**spec["tiny"])


def _counts_since(ops) -> dict:
    """The launches since the last reset (by kernel and by codec); resets."""
    out = {"launches": ops.launch_counts(), "by_codec": ops.launch_counts_by_codec()}
    ops.reset_launch_count()
    return out


def _peak_gb(card: bool) -> dict:
    """The device memory peak since the last call, in GB; the cache emptied
    for the next part."""
    import torch

    if not card:
        return {"peak_gb": None}
    out = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def _shards_match_files(tree, path: str, dev) -> bool:
    """Whether every DTensor leaf of ``tree`` (loaded from the checkpoint
    at ``path``) holds, on ``dev``, its slice of the saved leaf bit for
    bit."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import base

    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f)["dtypes"]
    ok = True
    for i, (_, leaf) in enumerate(base.flatten(tree)):
        full = ckpt._tensor_of(np.load(os.path.join(path, f"leaf_{i:05d}.npy")), dtypes[i])
        mine = shd.local_slice(full, leaf.device_mesh, leaf.placements)
        local = leaf.to_local()
        ok &= (local.device == dev and local.shape == mine.shape and torch.equal(
            local.cpu().reshape(-1).view(torch.uint8), mine.reshape(-1).view(torch.uint8)))
    return bool(ok)


def train_mesh_child(argv) -> int:
    """One rank of path MT: ``RANK WORLD WORKDIR DEVICE CONFIG-JSON``. Joins
    the group (``file://WORKDIR/pg``), runs parts a-d, writes
    ``WORKDIR/mt_r{RANK}.json`` and exits 0 when every check passed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import base, lm
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import _value_and_grad, make_loss_fn
    from repro_torch.train.trainer import RailPolicy, Trainer

    rank, world, work, device = int(argv[0]), int(argv[1]), argv[2], argv[3]
    cfg = _mt_config(json.loads(argv[4]))
    card = device == "cuda"
    if card:  # the deterministic algorithms make the two ranks' halves reproducible
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    backend = "nccl" if card and torch.cuda.device_count() >= world else "gloo"
    dist.init_process_group(backend, init_method=f"file://{os.path.join(work, 'pg')}",
                            world_size=world, rank=rank)
    out = {"rank": rank, "backend": backend, "parts": {}}
    try:
        mesh = make_host_mesh(device=device)
        dev = mesh.device

        def sync():
            if card:
                torch.cuda.synchronize()

        tc, pipe = _train_setup(cfg)
        tokens = T_BATCH * T_SEQ
        ops.reset_launch_count()

        # a. one compressed data-parallel step, the plain step, the emulation
        params = lm.init_params(cfg, 0, dev)
        opt, ef0 = adamw.init(params, tc.optimizer), coll.init_error_feedback(params)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(0).items()}
        step_c = coll.make_dp_compressed_train_step(cfg, tc, mesh, compress=True)
        step_u = coll.make_dp_compressed_train_step(cfg, tc, mesh, compress=False)
        walls, coll_log, bar_log = {}, [], []
        real_gather, real_barrier = coll.all_gather, dist.barrier

        def timed_barrier(*args, **kw):
            t0_ = time.perf_counter()
            real_barrier(*args, **kw)
            bar_log.append(time.perf_counter() - t0_)

        def timed_gather(t, group=None):
            sync()
            t0_ = time.perf_counter()
            parts = real_gather(t, group)
            sync()
            coll_log.append((t.numel() * t.element_size(), time.perf_counter() - t0_))
            return parts

        res = {}
        for tag, step in (("c", step_c), ("u", step_u)):
            step(params, opt, ef0, batch)  # warm
            sync()
            t0_ = time.perf_counter()
            p_, _, ef_, loss_ = step(params, opt, ef0, batch)
            sync()
            walls[tag] = time.perf_counter() - t0_
            res[tag] = (p_, ef_ if tag == "c" else None, float(loss_))
            del p_, ef_
            coll_log.clear()
            bar_log.clear()
            coll.all_gather, dist.barrier = timed_gather, timed_barrier
            try:
                again = step(params, opt, ef0, batch)[0]
            finally:
                coll.all_gather, dist.barrier = real_gather, real_barrier
            require(_bits_equal(again, res[tag][0]), f"MT a. rank {rank}: a repeated {tag} "
                    "step gave other params")
            walls[f"{tag}_collective_bytes"] = sum(b for b, _ in coll_log)
            walls[f"{tag}_collective_ms"] = 1e3 * sum(s for _, s in coll_log)
            walls[f"{tag}_collectives"] = len(coll_log)
            walls[f"{tag}_barrier_ms"] = 1e3 * sum(bar_log)
            del again
        (pc, efc, lc), (pu, _, lu) = res["c"], res["u"]
        diff = max(float((a.float() - b.float()).abs().max())
                   for (_, a), (_, b) in zip(base.flatten(pc), base.flatten(pu)))
        ef_max = max(float(e.abs().max()) for _, e in base.flatten(efc))
        require(abs(lc - lu) <= MT_LOSS_RTOL * abs(lu) and diff < MT_PARAM_ATOL and ef_max > 0,
                f"MT a. rank {rank}: losses {lc} / {lu}, param diff {diff}, ef max {ef_max}")
        # the emulation: both halves on this rank, quantised, summed in rank
        # order, / W; one rank at a time, so that only one holds its memory
        loss_fn = make_loss_fn(cfg, tc)
        del res["u"], pu
        for turn in range(world):
            dist.barrier()
            if turn != rank:
                continue
            halves = [_value_and_grad(loss_fn, params, coll.local_rows(batch, r, world))
                      for r in range(world)]
            flat_g = [[g for _, g in base.flatten(h[2])] for h in halves]
            avg, ef_mine = [], []
            for i in range(len(flat_g[0])):
                total = None
                for r in range(world):
                    target = flat_g[r][i].to(torch.float32)  # + a zero error feedback
                    q, scale = coll.quantize_int8(target)
                    sent = q.to(torch.float32) * scale
                    total = sent if total is None else total + sent
                    if r == rank:
                        ef_mine.append(target - sent)
                avg.append(total / world)
            loss_e = sum((h[0] for h in halves[1:]), halves[0][0]) / world
            pe, _, _ = adamw.update(base.unflatten(params, avg), opt, params, tc.optimizer)
            emulated = (_bits_equal(pe, pc) and float(loss_e) == lc
                        and _bits_equal(base.unflatten(params, ef_mine), efc))
            del halves, flat_g, avg, ef_mine, pe
            if card:  # the cache emptied for the other rank's turn
                torch.cuda.empty_cache()
        dist.barrier()
        require(emulated, f"MT a. rank {rank}: the {world}-rank step differs from its "
                "one-process emulation")
        del res, pc, efc, params, opt, ef0
        out["parts"]["a"] = {"loss_compressed": lc, "loss_plain": lu, "param_diff": diff,
                             "ef_max": ef_max, "emulation_bitwise": emulated,
                             "step_wall_s": walls, **_peak_gb(card), **_counts_since(ops)}

        # b. the sharded trainer: rescaled onto FSDP shardings, RailPolicy, ECC saves
        packs = [0]
        real_pack = ops.pack_ecc_weights

        def counted_pack(*a, **kw):
            packs[0] += 1
            return real_pack(*a, **kw)

        ops.pack_ecc_weights = counted_pack
        ps = shd.param_shardings(cfg, mesh, fsdp=True)
        d_b = os.path.join(work, "b")
        pol = RailPolicy(scrub_every=1, start_v=0.60, mask_source="device")
        try:
            tr = Trainer(cfg, tc, pipe, d_b, mesh=mesh, ckpt_every=1, ecc_checkpoints=True,
                         rails=pol)
            tr.rescale(mesh, ps)
            t0_ = time.perf_counter()
            tr.run(MT_STEPS)
            sync()
            wall_b = time.perf_counter() - t0_
        finally:
            ops.pack_ecc_weights = real_pack
        hist = tr.history
        losses = _losses(hist)
        step_s = [r["seconds"] for r in hist if "loss" in r]
        events = [r for r in hist if r.get("event") == "rails"]
        n_leaves = len(base.flatten(tr._state()))
        out["parts"]["b"] = {
            "losses": losses, "step_s": step_s,
            "median_step_s": float(np.median(step_s[1:])), "tokens_per_step": tokens,
            "tokens_per_s": tokens / float(np.median(step_s[1:])), "wall_s": wall_b,
            "rails": [{k: e[k] for k in ("step", "voltages", "locked", "detected")}
                      for e in events],
            "packs": packs[0], "leaves": n_leaves, "saves": MT_STEPS,
            "local_embed_shape": list(tr.params["embed"].to_local().shape),
            **_peak_gb(card), **_counts_since(ops)}

        # c. load the last checkpoint onto the trainer's shardings
        shardings = {"params": ps, "opt": {"m": ps, "v": ps, "step": shd.replicated(mesh)}}
        sync()
        t0_ = time.perf_counter()
        back = ckpt.load(d_b, MT_STEPS, tr._state(), shardings=shardings)
        sync()
        load_s = time.perf_counter() - t0_
        counts_c = _counts_since(ops)
        slices_equal = _shards_match_files(back, os.path.join(d_b, f"step_{MT_STEPS:06d}"), dev)
        require(slices_equal and counts_c["launches"]["decode"] == (n_leaves if card else 0),
                f"MT c. rank {rank}: local shards equal {slices_equal}, launches "
                f"{counts_c['launches']}")
        del back
        out["parts"]["c"] = {"load_s": load_s, "slices_bitwise": slices_equal, **counts_c}

        # d. rescale from the data-sharded mesh to whole tensors on every rank
        before = {k: shd.gather_leaf(v).clone() for k, v in base.flatten(tr._state())}
        tr.rescale(mesh)
        kept = all(type(v) is torch.Tensor for _, v in base.flatten(tr._state())) and \
            _bits_equal(base.unflatten(tr._state(), list(before.values())), tr._state())
        require(kept, f"MT d. rank {rank}: the rescale changed the state")
        out["parts"]["d"] = {"bitwise": kept, **_counts_since(ops)}
        del tr, before
        out["parts"]["e"] = _mtp_part(cfg, tc, pipe, mesh, ps, work, device, card, sync)
        out["parts"]["f"] = _mtf_part(json.loads(argv[4]), work, device, card, sync)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"mt_r{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _mtp_part(cfg, tc, pipe, mesh21, ps21, work, device, card, sync) -> dict:
    """Part e of path MT, sub-path MTP: the same ranks on a (1, W) mesh,
    whose "model" axis computes (``make_mesh_train_step``'s model-axis
    step on the rules' shardings). MT_STEPS steps of ``Trainer(mesh=)`` from
    phase 19's start, the first against its one-process emulation
    (``train_step.emulate_model_step``, run by each rank in turn) bit for
    bit, nothing gathered over "model", every model-sharded leaf a 1 / W
    shard; the later steps' rank-order sums counted (bytes, barrier
    waits); an ECC save at (1, W) loaded onto (W, 1)'s shardings bit for
    bit."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import base, lm
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_host_mesh(model=world, device=device)
    dev = mesh.device
    ps = shd.param_shardings(cfg, mesh, fsdp=True)
    out = {"mesh": [mesh.n_batch, mesh.n_model]}
    _counts_since(ops)
    _peak_gb(card)

    # the trainer's first step, then its emulation by each rank in turn
    d_e = os.path.join(work, "e")
    tr = Trainer(cfg, tc, pipe, d_e, mesh=mesh, ckpt_every=10 ** 6, ecc_checkpoints=True)
    tr.rescale(mesh, ps)
    require(shd.placed_by_rules(tr.params, cfg, mesh), f"MTP rank {rank}: not placed by the rules")
    shd.reset_gathered_bytes()
    tr.run(1)
    sync()
    first = {"p": shd.to_local(tr.params), "m": shd.to_local(tr.opt_state["m"]),
             "v": shd.to_local(tr.opt_state["v"])}
    loss1 = tr.history[-1]["loss"]
    emulated = None
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            full = lm.init_params(cfg, 0, dev)
            opt_full = adamw.init(full, tc.optimizer)
            batch = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(0).items()}
            _peak_gb(card)
            t0_ = time.perf_counter()
            loss_e, ranks_e = ts.emulate_model_step(cfg, tc, world, full, opt_full, batch)
            sync()
            out["emulation_s"] = time.perf_counter() - t0_
            pe, oe = ranks_e[rank]
            emulated = (float(loss_e) == loss1 and _bits_equal(pe, first["p"])
                        and _bits_equal(oe["m"], first["m"]) and _bits_equal(oe["v"], first["v"]))
            del loss_e, ranks_e, pe, oe, full, opt_full, batch
            out["emulation_peak_gb"] = _peak_gb(card)["peak_gb"]
    dist.barrier()
    require(emulated, f"MTP rank {rank}: the {world}-rank step differs from its one-process "
            "emulation")
    del first

    # the later steps, their rank-order sums counted
    sums, waits = [], []
    real_gather, real_barrier = coll.all_gather, dist.barrier

    def counted_gather(t, group=None):
        sums.append(t.numel() * t.element_size())
        return real_gather(t, group)

    def timed_barrier(*args, **kw):
        t0_ = time.perf_counter()
        real_barrier(*args, **kw)
        waits.append(time.perf_counter() - t0_)

    coll.all_gather, dist.barrier = counted_gather, timed_barrier
    try:
        tr.run(MT_STEPS - 1)
    finally:
        coll.all_gather, dist.barrier = real_gather, real_barrier
    sync()
    out["gathered"] = shd.gathered_bytes()
    hist = tr.history
    step_s = [r["seconds"] for r in hist if "loss" in r]
    halves = []
    for (_, leaf), (_, sp) in zip(base.flatten(tr.params), base.flatten(lm.param_struct(cfg))):
        d = shd.model_dim(leaf)
        if d is not None:
            halves.append(leaf.to_local().shape[d] * world == sp.shape[d])
    out.update(loss=loss1, emulation_bitwise=emulated, losses=_losses(hist), step_s=step_s,
               median_step_s=float(np.median(step_s[1:])),
               sums_a_step=len(sums) / (MT_STEPS - 1), sum_bytes_a_step=sum(sums) / (MT_STEPS - 1),
               barrier_ms_a_step=1e3 * sum(waits) / (MT_STEPS - 1),
               model_sharded_leaves=len(halves), shards_are_halves=all(halves),
               train_peak_gb=_peak_gb(card)["peak_gb"], trainer_launches=_counts_since(ops))
    require(out["gathered"].get("model", 0) == 0 and all(halves) and len(halves) > 0,
            f"MTP rank {rank}: gathered {out['gathered']}, {len(halves)} sharded leaves, "
            f"halves {all(halves)}")

    # an ECC save at (1, W) and its load onto (W, 1)'s shardings
    sync()
    t0_ = time.perf_counter()
    tr.save()
    sync()
    save = {"save_s": time.perf_counter() - t0_, **_counts_since(ops)}
    saved = {k: shd.gather_leaf(v) for k, v in base.flatten(tr._state())}
    n_leaves = len(saved)
    sh21 = {"params": ps21, "opt": {"m": ps21, "v": ps21, "step": shd.replicated(mesh21)}}
    t0_ = time.perf_counter()
    back = ckpt.load(d_e, tr.step, tr._state(), shardings=sh21)
    sync()
    load = {"load_s": time.perf_counter() - t0_, **_counts_since(ops)}
    reshard = all(
        v.placements == tuple(shd.placements(mesh21, s.spec)) and torch.equal(
            v.to_local().reshape(-1).view(torch.uint8),
            shd.local_slice(saved[k], v.device_mesh, v.placements).contiguous()
            .reshape(-1).view(torch.uint8))
        for (k, v), (_, s) in zip(base.flatten(back), base.flatten(
            sh21, is_leaf=lambda x: isinstance(x, shd.NamedSharding))))
    require(reshard and load["launches"]["decode"] == (n_leaves if card else 0)
            and save["launches"]["encode"] == (n_leaves if card and rank == 0 else 0),
            f"MTP rank {rank}: resharded load bitwise {reshard}, save launches "
            f"{save['launches']}, load launches {load['launches']}")
    out.update(save=save, load=load, reshard_bitwise=reshard, leaves=n_leaves)
    del tr, saved, back
    return out


# phase 21 part f, the model axis of the families beyond dense and MoE at
# their published widths, depth cut: MTR trains rwkv6-3b cut to MTR_LAYERS of
# its 32 layers, with float32 master parameters and its bf16 compute. Its
# losses are held within MT_LOSS_RTOL of the unsharded loss at the same
# params and batch, step by step; the free-running unsharded trainer's
# losses are reported, not held: at this width and depth rounding alone
# spreads the trajectory past MT_TRAJ_RTOL within three steps. Its first
# step's gradient, computed in float32 on the ranks, is held leaf by leaf
# (max|diff| / max|reference|) within MTR_GRAD_RTOL of the unsharded float32
# gradient and of the float64 one: rounding alone puts the unsharded float32
# gradient ~2.4e-3 off float64 on its worst leaf, a lost or misplaced
# gradient part is off by O(1). MTJ runs one mamba layer at
# jamba-1.5-large's width and MTV one cross-attention layer at
# llama-3.2-vision-11b's width over its 6,404 image tokens, each on batch 1
# x MTF_SEQ tokens; MTA steps musicgen-medium cut to MTA_LAYERS of its 48
# layers. A float32 layer on the ranks is held within MTF_RTOL x max|whole|
# of the whole layer (the CPU tests' gradient tolerance); MTA's loss against
# the whole step within MT_TRAJ_RTOL
MTR_LAYERS, MTA_LAYERS, MTF_SEQ, MTF_RTOL, MTR_GRAD_RTOL = 4, 4, 512, 1e-4, 1e-2
# the dry run's part f: the CPU tests' tiny families (tests/_torch_tp_families_ranks.py)
F_TINY = {"rwkv": dict(family="ssm", n_kv_heads=4, rwkv_head_dim=16, norm_type="layernorm"),
          "jamba": dict(family="hybrid", n_layers=8, attn_every=8, n_experts=4, top_k=2),
          "vlm": dict(family="vlm", n_layers=5, cross_attn_every=5, n_img_tokens=8),
          "audio": dict(family="audio", n_codebooks=4, n_kv_heads=4, norm_type="layernorm",
                        gated_mlp=False)}


def _mtf_configs(spec: dict) -> dict:
    """Part f's configs: the published ones (depth cut), or the dry run's
    tiny families when ``spec`` names no architecture."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import base

    if "arch" not in spec:
        return {k: base.ModelConfig(**{**T_TINY, **kw}) for k, kw in F_TINY.items()}
    return {"rwkv": dataclasses.replace(get_config("rwkv6-3b"), n_layers=MTR_LAYERS,
                                        param_dtype=torch.float32),
            "jamba": get_config("jamba-1.5-large-398b"),
            "vlm": get_config("llama-3.2-vision-11b"),
            "audio": dataclasses.replace(get_config("musicgen-medium"), n_layers=MTA_LAYERS)}


def _layer_params(spec, dev, seed: int):
    """One layer's float32 parameters from its spec tree
    (``base.materialize``), each constant leaf (norms, biases, the cross
    gates) moved off its constant by seeded numbers in [-0.3, 0.3), so
    every path carries a gradient."""
    import torch

    from repro_torch.models import base

    gen = torch.Generator(device=dev).manual_seed(seed)
    tree = base.materialize(spec, gen, torch.float32, dev)
    inits = [s.init for _, s in base.flatten(spec, is_leaf=lambda x: isinstance(x, base.Spec))]
    return base.unflatten(tree, [
        t + (torch.rand(t.shape, generator=gen, device=dev) - 0.5) * 0.6
        if i in ("zeros", "ones") else t for (_, t), i in zip(base.flatten(tree), inits)])


def _mtf_region(cfg, spec, layer, n_img: int, mesh, sync) -> dict:
    """MTJ / MTV: one layer, ``layer(x, p, model, img)`` -> its output (``p``
    one local tree a branch with a ``model``, the whole tree without), on
    the ranks of the (1, W) mesh. In bf16 the ranks' output, input gradient
    and local parameter gradients equal the layer's emulation bit for bit
    (every branch in one process, ``ModelAxis.emulated``); in float32 the
    output and the input gradient are within MTF_RTOL x max|whole| of the
    whole layer. Each rank runs its emulation and the whole layer in turn."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import base

    rank, world, dev = dist.get_rank(), dist.get_world_size(), mesh.device
    amesh = abstract_mesh((1, world), ("data", "model"))
    dims = [next((d for d, e in enumerate(shd.spec_for(s.axes, s.shape, amesh, False))
                  if e == "model"), None)
            for _, s in base.flatten(spec, is_leaf=lambda x: isinstance(x, base.Spec))]
    whole32 = _layer_params(spec, dev, 0)
    g = torch.Generator(device=dev).manual_seed(1)
    x32 = torch.randn((1, MTF_SEQ, cfg.d_model), generator=g, device=dev)
    gy32 = torch.randn((1, MTF_SEQ, cfg.d_model), generator=g, device=dev)
    img32 = (torch.randn((1, n_img, cfg.d_model), generator=g, device=dev) if n_img else None)

    def cut(t, d, r):
        n = t.shape[d] // world
        return t.narrow(d, r * n, n).contiguous()

    def grads(whole, ranks, model, dt):
        """(output, input gradient, {rank: its leaves' gradients}) of the
        layer in ``dt`` on the branches ``ranks`` (None: whole)."""
        n_br = 1 if ranks is None else len(ranks)
        per = [[t.to(dt).detach().requires_grad_(True)] * n_br if d is None or ranks is None
               else [cut(t.to(dt), d, r).detach().requires_grad_(True) for r in ranks]
               for (_, t), d in zip(base.flatten(whole), dims)]
        trees = [base.unflatten(whole, [ts[i] for ts in per]) for i in range(n_br)]
        x = x32.to(dt).detach().requires_grad_(True)
        img = None if img32 is None else img32.to(dt)
        y = layer(x, trees[0] if ranks is None else trees, model, img)
        uniq = list({id(t): t for ts in per for t in ts}.values())
        gs = torch.autograd.grad(y, [x] + uniq, gy32.to(dt))
        of = {id(t): gg for t, gg in zip(uniq, gs[1:])}
        by_rank = {r: [of[id(ts[i])] for ts in per]
                   for i, r in enumerate([None] if ranks is None else ranks)}
        return y.detach(), gs[0], by_rank

    out = {}
    coll.reset_activation_gathered_bytes()
    sync()
    t0_ = time.perf_counter()
    y16, gx16, g16 = grads(whole32, [mesh.model_index], coll.ModelAxis.of_mesh(mesh),
                           torch.bfloat16)
    sync()
    out["ranks_bf16_s"] = time.perf_counter() - t0_
    out["activation_bytes_bf16"] = coll.activation_gathered_bytes()
    y32, gx32, _ = grads(whole32, [mesh.model_index], coll.ModelAxis.of_mesh(mesh),
                         torch.float32)
    out["local_leaves_halved"] = all(
        gg.shape[d] * world == t.shape[d] for gg, ((_, t), d) in zip(
            g16[mesh.model_index], zip(base.flatten(whole32), dims)) if d is not None)
    out["sharded_leaves"] = sum(d is not None for d in dims)
    _peak_gb(dev.type == "cuda")
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            ye, gxe, ge = grads(whole32, list(range(world)), coll.ModelAxis.emulated(world),
                                torch.bfloat16)
            out["emulation_bitwise"] = (_bits_equal({"y": y16, "x": gx16}, {"y": ye, "x": gxe})
                                        and _bits_equal(dict(enumerate(g16[rank])),
                                                        dict(enumerate(ge[rank]))))
            del ye, gxe, ge
            yw, gxw, _ = grads(whole32, None, None, torch.float32)
            out["max_rel_out"] = float((y32 - yw).abs().max() / yw.abs().max())
            out["max_rel_dx"] = float((gx32 - gxw).abs().max() / gxw.abs().max())
            del yw, gxw
            sync()
    dist.barrier()
    out["peak_gb"] = _peak_gb(dev.type == "cuda")["peak_gb"]
    return out


def _mtf_part(spec, work, device, card, sync) -> dict:
    """Part f of path MT: MTR, MTJ, MTV and MTA on a (1, W) mesh of the same
    ranks (see the constants above); no kernel launches in any of them."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import base, lm, mamba
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    cfgs = _mtf_configs(spec)
    mesh = make_host_mesh(model=world, device=device)
    dev = mesh.device
    out = {}

    def halves(params, cfg) -> list:
        return [leaf.to_local().shape[shd.model_dim(leaf)] * world == sp.shape[shd.model_dim(leaf)]
                for (_, leaf), (_, sp) in zip(base.flatten(params),
                                              base.flatten(lm.param_struct(cfg)))
                if shd.model_dim(leaf) is not None]

    # MTR: rwkv6's trainer on the model axis, its first step against the
    # emulation, its losses against the unsharded trainer's
    cfg = cfgs["rwkv"]
    tc, pipe = _train_setup(cfg)
    ps = shd.param_shardings(cfg, mesh, fsdp=True)
    _counts_since(ops)
    _peak_gb(card)
    t0_ = time.perf_counter()
    tr = Trainer(cfg, tc, pipe, os.path.join(work, "f_rwkv"), mesh=mesh, ckpt_every=10 ** 6)
    tr.rescale(mesh, ps)
    require(shd.placed_by_rules(tr.params, cfg, mesh), f"MTR rank {rank}: not placed by the rules")
    # the first step's gradient in float32 on the ranks (the model-axis
    # step's loss and sums), joined whole for rank 0's check below
    t_grad = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    batch0 = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(0).items()}
    axis = coll.ModelAxis.of_mesh(mesh)
    g = ts._value_and_grad(lambda p, b: lm.train_loss({mesh.model_index: p}, b, cfg32,
                                                      remat=tc.remat, model=axis),
                           shd.to_local(tr.params), batch0)[2]
    g = ts._sum_over_model(g, set(lm.model_partial_keys(cfg, world)),
                           lambda t: coll.psum(t, mesh.model_group))
    g = base.tree_map(lambda t: t.cpu(), shd.gather(shd.like(g, tr.params)))
    g_ranks = g if rank == 0 else None
    del g
    sync()
    grad = {"grad_s": time.perf_counter() - t_grad, "grad_peak_gb": _peak_gb(card)["peak_gb"]}
    gathered: dict = {}
    peaks = []  # each step's device peak, GB

    def step_once():
        shd.reset_gathered_bytes()
        if card:
            torch.cuda.reset_peak_memory_stats()
        tr.run(1)
        sync()
        if card:
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        for ax, n in shd.gathered_bytes().items():
            gathered[ax] = gathered.get(ax, 0) + n

    coll.reset_activation_gathered_bytes()
    step_once()
    act1 = coll.activation_gathered_bytes()
    first = {"p": shd.to_local(tr.params), "m": shd.to_local(tr.opt_state["m"]),
             "v": shd.to_local(tr.opt_state["v"])}
    loss1 = tr.history[-1]["loss"]
    r = {"setup_and_first_step_s": time.perf_counter() - t0_ - grad["grad_s"], **grad}
    snaps = []  # the whole params before each later step, on the host, for rank 0's check
    for _ in range(MT_STEPS - 1):
        snap = base.tree_map(lambda t: t.cpu(), shd.gather(tr.params))
        snaps.append(snap if rank == 0 else None)
        del snap
        step_once()
    r["gathered"] = gathered
    r["activation_bytes_first_step"] = act1
    _peak_gb(card)
    r["train_peak_gb"] = max(peaks) if card else None
    r["launches"] = _counts_since(ops)
    step_s = [h["seconds"] for h in tr.history if "loss" in h]
    hv = halves(tr.params, cfg)
    r.update(loss=loss1, losses=_losses(tr.history), step_s=step_s,
             median_step_s=float(np.median(step_s[1:])), model_sharded_leaves=len(hv),
             shards_are_halves=all(hv))
    del tr
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            full = lm.init_params(cfg, 0, dev)
            batch = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(0).items()}
            t0_ = time.perf_counter()
            loss_e, ranks_e = ts.emulate_model_step(cfg, tc, world, full,
                                                    adamw.init(full, tc.optimizer), batch)
            sync()
            r["emulation_s"] = time.perf_counter() - t0_
            pe, oe = ranks_e[rank]
            r["emulation_bitwise"] = (float(loss_e) == loss1 and _bits_equal(pe, first["p"])
                                      and _bits_equal(oe["m"], first["m"])
                                      and _bits_equal(oe["v"], first["v"]))
            del loss_e, ranks_e, pe, oe, full, batch
            r["emulation_peak_gb"] = _peak_gb(card)["peak_gb"]
            if rank == 0:  # the same trainer unsharded, on this rank's card
                whole = Trainer(cfg, tc, pipe, os.path.join(work, "f_rwkv_whole"),
                                ckpt_every=10 ** 6, device=dev)
                whole.run(MT_STEPS)
                r["whole_losses"] = _losses(whole.history)
                r["whole_step_s"] = [h["seconds"] for h in whole.history if "loss" in h]
                del whole
                r["whole_peak_gb"] = _peak_gb(card)["peak_gb"]
                # each later step's loss against the unsharded loss at the
                # same params and batch
                loss_fn = ts.make_loss_fn(cfg, tc)
                r["whole_losses_same_params"] = [r["whole_losses"][0]]
                with torch.no_grad():
                    for k, snap in enumerate(snaps, start=1):
                        batch = {kk: torch.as_tensor(v).to(dev)
                                 for kk, v in pipe.batch_at(k).items()}
                        snap = base.tree_map(lambda t: t.to(dev), snap)
                        r["whole_losses_same_params"].append(float(loss_fn(snap, batch)[0]))
                del batch
                # the ranks' float32 gradient against the unsharded float32
                # gradient, and both against the float64 one, leaf by leaf
                t_grad = time.perf_counter()
                full = lm.init_params(cfg, 0, dev)
                g32 = ts._value_and_grad(ts.make_loss_fn(cfg32, tc), full, batch0)[2]
                cfg64 = dataclasses.replace(cfg, param_dtype=torch.float64,
                                            compute_dtype=torch.float64)
                g64 = ts._value_and_grad(ts.make_loss_fn(cfg64, tc),
                                         base.tree_map(lambda t: t.double(), full), batch0)[2]
                del full
                worst = {k: (0.0, None) for k in ("ranks_vs_whole", "ranks_vs_f64",
                                                  "whole_vs_f64")}
                for (key, a), (_, w), (_, e) in zip(base.flatten(g_ranks), base.flatten(g32),
                                                    base.flatten(g64)):
                    a, w = a.to(dev, torch.float64), w.double()
                    for k, (x, y) in (("ranks_vs_whole", (a, w)), ("ranks_vs_f64", (a, e)),
                                      ("whole_vs_f64", (w, e))):
                        rel = float((x - y).abs().max() / y.abs().max())
                        if rel >= worst[k][0]:
                            worst[k] = (rel, key)
                r["grad_rel"] = {k: v[0] for k, v in worst.items()}
                r["grad_worst_leaf"] = {k: v[1] for k, v in worst.items()}
                del g32, g64, a, w
                sync()
                r["witness_s"] = time.perf_counter() - t_grad
                r["witness_peak_gb"] = _peak_gb(card)["peak_gb"]  # and the cache emptied
    dist.barrier()
    del first, snaps, g_ranks, batch0
    require(r["emulation_bitwise"], f"MTR rank {rank}: the {world}-rank step differs from its "
            "one-process emulation")
    require(r["gathered"].get("model", 0) == 0 and all(hv) and hv,
            f"MTR rank {rank}: gathered {r['gathered']}, halves {hv}")
    require(rank or (r["grad_rel"]["ranks_vs_whole"] <= MTR_GRAD_RTOL
                     and r["grad_rel"]["ranks_vs_f64"] <= MTR_GRAD_RTOL),
            f"MTR: the ranks' first-step gradient is off by {r.get('grad_rel')} on "
            f"{r.get('grad_worst_leaf')} (limit {MTR_GRAD_RTOL})")
    out["MTR"] = r

    # MTJ and MTV: one mamba layer and one cross layer
    jcfg, vcfg = cfgs["jamba"], cfgs["vlm"]
    regions = {
        "MTJ": (jcfg, lm._mamba_spec(jcfg), lambda x, p, model, img: (
            mamba.mamba_layer(x, p, jcfg)[0] if model is None
            else mamba.mamba_layer_sharded(x, p, jcfg, model)), 0),
        "MTV": (vcfg, lm._layer_spec(vcfg, vcfg.period - 1), lambda x, p, model, img:
                lm._cross_layer(x, p, vcfg, img, model)[0], vcfg.n_img_tokens)}
    for label, (c, spec_, layer, n_img) in regions.items():
        t0_ = time.perf_counter()
        r = _mtf_region(c, spec_, layer, n_img, mesh, sync)
        r["wall_s"] = time.perf_counter() - t0_
        r["launches"] = _counts_since(ops)
        require(r["emulation_bitwise"] and r["max_rel_out"] <= MTF_RTOL
                and r["max_rel_dx"] <= MTF_RTOL and r["local_leaves_halved"],
                f"{label} rank {rank}: {r}")
        out[label] = r

    # MTA: one step of musicgen-medium against its emulation and the whole step
    cfg = cfgs["audio"]
    tc, _ = _train_setup(cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, global_batch=T_BATCH, seq_len=T_SEQ,
                                    n_codebooks=cfg.n_codebooks))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(0).items()}
    ps = shd.param_shardings(cfg, mesh, fsdp=True)
    full = lm.init_params(cfg, 0, dev)
    opt = adamw.init(full, tc.optimizer)
    params = shd.place(full, ps)
    opt_p = {"m": shd.place(opt["m"], ps), "v": shd.place(opt["v"], ps), "step": opt["step"]}
    require(shd.placed_by_rules(params, cfg, mesh), f"MTA rank {rank}: not placed by the rules")
    del full, opt
    shd.reset_gathered_bytes()
    sync()
    t0_ = time.perf_counter()
    p1, o1, m1 = ts.make_mesh_train_step(cfg, tc, mesh)(params, opt_p, batch)
    sync()
    r = {"step_s": time.perf_counter() - t0_, "gathered": shd.gathered_bytes(),
         "loss": float(m1["loss"])}
    hv = halves(params, cfg)
    mine = {"p": shd.to_local(p1), "m": shd.to_local(o1["m"]), "v": shd.to_local(o1["v"])}
    del p1, o1, params, opt_p
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            full = lm.init_params(cfg, 0, dev)
            loss_e, ranks_e = ts.emulate_model_step(cfg, tc, world, full,
                                                    adamw.init(full, tc.optimizer), batch)
            pe, oe = ranks_e[rank]
            r["emulation_bitwise"] = (float(loss_e) == r["loss"] and _bits_equal(pe, mine["p"])
                                      and _bits_equal(oe["m"], mine["m"])
                                      and _bits_equal(oe["v"], mine["v"]))
            del loss_e, ranks_e, pe, oe
            _, _, mw = ts.make_train_step(cfg, tc)(full, adamw.init(full, tc.optimizer), batch)
            r["whole_loss"] = float(mw["loss"])
            del full, mw
            sync()
    dist.barrier()
    r.update(model_sharded_leaves=len(hv), shards_are_halves=all(hv), peak_gb=_peak_gb(card)["peak_gb"],
             launches=_counts_since(ops))
    require(r["emulation_bitwise"] and abs(r["loss"] - r["whole_loss"]) <= MT_TRAJ_RTOL * abs(
        r["whole_loss"]) and r["gathered"].get("model", 0) == 0 and hv and all(hv),
            f"MTA rank {rank}: {r}")
    out["MTA"] = r
    return out


def train_mesh_phase(dev, cfg_spec: dict, t_losses: list) -> tuple:
    """Path MT on ``dev``: MT_WORLD ranks (``train_mesh_child`` processes)
    run a. one compressed data-parallel step against the plain step and
    against its one-process emulation, b. MT_STEPS steps of a sharded
    ``Trainer(mesh=)`` with a device-mask RailPolicy and ECC saves every
    step, whose losses must be within MT_TRAJ_RTOL of ``t_losses`` (phase
    19's one-card trainer), c. ``checkpoint.load(shardings=)`` of its last
    checkpoint onto the ranks, d. a rescale back to whole tensors, e. path
    MTP (``_mtp_part``) on a (1, MT_WORLD) mesh, whose losses must be
    within MT_TRAJ_RTOL of ``t_losses`` too; then this process loads the
    checkpoint of b onto a one-rank mesh; f. part f (``_mtf_part``): MTR,
    MTJ, MTV and MTA. Returns (results, {path: its record for the kernels
    line} of MT, MTP and part f's sub-paths)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import base, lm
    from repro_torch.optim import adamw

    card = dev.type == "cuda"
    cfg = _mt_config(cfg_spec)
    t_phase = time.perf_counter()
    if card:
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    # what the ranks start beside: this process's card memory and the host's load
    at_spawn = {"load_avg_1m": os.getloadavg()[0]}
    if card:
        free_b, _ = torch.cuda.mem_get_info(dev)
        at_spawn.update(card_free_gb=free_b / 1e9,
                        this_process_allocated_gb=torch.cuda.memory_allocated(dev) / 1e9,
                        this_process_reserved_gb=torch.cuda.memory_reserved(dev) / 1e9)
    print(f"  MT at the ranks' start {json.dumps(at_spawn)}", flush=True)
    work = tempfile.mkdtemp(prefix=".train_ckpt_mt_", dir=ROOT)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src")]
                                          + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs, outs = [], {}
    try:
        for r in range(MT_WORLD):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), MT_CHILD_FLAG, str(r), str(MT_WORLD),
                 work, dev.type, json.dumps(cfg_spec)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
        errs = [p.communicate(timeout=900)[1] for p in procs]
        require(all(p.returncode == 0 for p in procs), "MT: " + " | ".join(
            f"rank {r} exited {p.returncode}: {e[-2500:]}" for r, (p, e) in
            enumerate(zip(procs, errs)) if p.returncode))
        for r in range(MT_WORLD):
            with open(os.path.join(work, f"mt_r{r}.json")) as f:
                outs[r] = json.load(f)
        spawn_s = time.perf_counter() - t_phase

        # the one-rank load of the same checkpoint, in this process
        ops.reset_launch_count()
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'pg1')}",
                                world_size=1, rank=0)
        try:
            mesh1 = make_host_mesh(device=dev)
            ps1 = shd.param_shardings(cfg, mesh1, fsdp=True)
            pstruct = lm.param_struct(cfg)
            like = {"params": pstruct, "opt": adamw.init(pstruct, _train_setup(cfg)[0].optimizer)}
            sh1 = {"params": ps1, "opt": {"m": ps1, "v": ps1, "step": shd.replicated(mesh1)}}
            t0_ = time.perf_counter()
            back = ckpt.load(os.path.join(work, "b"), MT_STEPS, like, shardings=sh1)
            if card:
                torch.cuda.synchronize()
            load1_s = time.perf_counter() - t0_
            counts_w1 = _counts_since(ops)
            n_leaves = len(base.flatten(back))
            w1_equal = _shards_match_files(
                back, os.path.join(work, "b", f"step_{MT_STEPS:06d}"), mesh1.device)
            del back
        finally:
            dist.destroy_process_group()
        require(w1_equal and counts_w1["launches"]["decode"] == (n_leaves if card else 0),
                f"MT c. one rank: local = full {w1_equal}, launches {counts_w1['launches']}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(work, ignore_errors=True)

    res = {r: o["parts"] for r, o in outs.items()}
    b0 = res[0]["b"]
    losses = b0["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, t_losses))
    require(all(res[r]["b"]["losses"] == losses for r in res)
            and len(losses) == MT_STEPS and rel <= MT_TRAJ_RTOL,
            f"MT b. losses {[res[r]['b']['losses'] for r in res]} against phase 19's "
            f"{t_losses[:MT_STEPS]} (max rel {rel:.2e})")
    # launches: rank 0 scrubs (B4 a packed matrix, one B2, the field below
    # V_min) and writes the saves (B4 a leaf); every rank's load is one B5 a leaf
    total = dict.fromkeys(ops.launch_counts(), 0)
    by_codec = {k: {} for k in ops.launch_counts_by_codec()}
    for counts in [res[r][p] for r in res for p in "abcd"] + [counts_w1]:
        for k, n in counts["launches"].items():
            total[k] += n
        for k, per in counts["by_codec"].items():
            for c, n in per.items():
                by_codec[k][c] = by_codec[k].get(c, 0) + n
    if card:
        n_scrubs = len(b0["rails"])
        want0 = dict.fromkeys(total, 0)
        want0.update(encode=b0["packs"] + b0["saves"] * b0["leaves"],
                     inject_scrub_domains=n_scrubs,
                     fault_field=res[0]["b"]["launches"]["fault_field"])
        require(n_scrubs == MT_STEPS and b0["launches"] == want0
                and b0["launches"]["fault_field"] <= n_scrubs
                and all(sum(res[r]["b"]["launches"].values()) == 0 for r in res if r),
                f"MT b. launches {[res[r]['b']['launches'] for r in res]}, expected rank 0 "
                f"{want0} and none elsewhere")
        require(all(sum(res[r][p]["launches"].values()) == 0 for r in res for p in "ad"),
                "MT a./d. a train step or a rescale launched a kernel")
        require(all(total[k] > 0 for k in ("inject_scrub_domains", "encode", "decode")),
                f"MT: a kernel of the path never launched: {total}")
    # e. MTP: the model axis computes; losses against phase 19's, launches
    e0 = res[0]["e"]
    rel_e = max(abs(a - b) / abs(b) for a, b in zip(e0["losses"], t_losses))
    require(all(res[r]["e"]["losses"] == e0["losses"] for r in res)
            and len(e0["losses"]) == MT_STEPS and rel_e <= MT_TRAJ_RTOL,
            f"MTP losses {[res[r]['e']['losses'] for r in res]} against phase 19's "
            f"{t_losses[:MT_STEPS]} (max rel {rel_e:.2e})")
    total_p = dict.fromkeys(ops.launch_counts(), 0)
    by_codec_p = {k: {} for k in ops.launch_counts_by_codec()}
    for r in res:
        for part in [res[r]["e"][p] for p in ("trainer_launches", "save", "load")]:
            for k, n in part["launches"].items():
                total_p[k] += n
            for k, per in part["by_codec"].items():
                for c, n in per.items():
                    by_codec_p[k][c] = by_codec_p[k].get(c, 0) + n
    if card:
        require(all(sum(res[r]["e"]["trainer_launches"]["launches"].values()) == 0
                    for r in res), "MTP: a model-axis train step launched a kernel")
        require(total_p["encode"] > 0 and total_p["decode"] > 0,
                f"MTP: a kernel of the path never launched: {total_p}")
    # f. MTR, MTJ, MTV, MTA: the model axis of the other families
    print(f"  MT f. ranks' records {json.dumps({r: res[r]['f'] for r in res}, default=str)}")
    f0 = res[0]["f"]
    mtr = f0["MTR"]
    rel_of = lambda xs, ys: max(abs(a - b) / abs(b) for a, b in zip(xs, ys))
    rel_s = rel_of(mtr["losses"], mtr["whole_losses_same_params"])
    rel_r = rel_of(mtr["losses"], mtr["whole_losses"])  # reported: see MTR_LAYERS' note
    require(all(res[r]["f"]["MTR"]["losses"] == mtr["losses"] for r in res)
            and len(mtr["losses"]) == MT_STEPS and rel_s <= MT_LOSS_RTOL,
            f"MTR losses {[res[r]['f']['MTR']['losses'] for r in res]} against the unsharded "
            f"loss at the same params {mtr['whole_losses_same_params']} (max rel {rel_s:.2e})")
    require(all(res[r]["f"]["MTA"]["loss"] == f0["MTA"]["loss"] for r in res),
            "MTA: the ranks' losses differ")
    records_f = {}
    for sub in ("MTR", "MTJ", "MTV", "MTA"):
        total_f = dict.fromkeys(ops.launch_counts(), 0)
        by_codec_f = {k: {} for k in ops.launch_counts_by_codec()}
        for r in res:
            for k, n in res[r]["f"][sub]["launches"]["launches"].items():
                total_f[k] += n
            for k, per in res[r]["f"][sub]["launches"]["by_codec"].items():
                for c_, n in per.items():
                    by_codec_f[k][c_] = by_codec_f[k].get(c_, 0) + n
        require(sum(total_f.values()) == 0, f"{sub}: a step or region launched a kernel {total_f}")
        records_f[sub] = {"launches": total_f, "launches_by_codec": by_codec_f,
                          "kv_codec": "secded72", "matmuls_per_forward": 0, "packs": 0,
                          "commits": 0, "forwards": {"prefill": 0, "decode": 0, "decode_kernel": 0}}
    a0 = res[0]["a"]
    w = a0["step_wall_s"]
    out = {"world": MT_WORLD, "backend": outs[0]["backend"], "ranks": res,
           "load_one_rank_s": load1_s, "spawn_s": spawn_s, "launches": total,
           "launches_mtp": total_p, "at_spawn": at_spawn, "max_rel_vs_phase_19": rel,
           "mtp_max_rel_vs_phase_19": rel_e, "wall_s": time.perf_counter() - t_phase}
    print(f"  MT {cfg.name} on {MT_WORLD} ranks ({outs[0]['backend']}, "
          f"{'one card' if card and torch.cuda.device_count() < MT_WORLD else dev.type}), "
          f"batch {T_BATCH} x {T_SEQ} ({T_BATCH // MT_WORLD} rows a rank) | "
          f"{gpu_line() if card else 'cpu'}; at the ranks' start "
          f"{json.dumps({k: round(v, 3) for k, v in at_spawn.items()})}")
    print(f"  MT a. compressed step: loss {a0['loss_compressed']:.6f} vs plain "
          f"{a0['loss_plain']:.6f}, params within {a0['param_diff']:.2e} (< {MT_PARAM_ATOL}), "
          f"error feedback max {a0['ef_max']:.3e}, = the one-process emulation bit for bit on "
          f"every rank; step wall {1e3 * w['c']:.1f} ms compressed ({T_BATCH * T_SEQ / w['c']:.0f} "
          f"tokens/s), {1e3 * w['u']:.1f} ms plain; collective a step and rank: compressed "
          f"{w['c_collective_bytes'] / 1e6:.1f} MB in {w['c_collectives']} all-gathers, "
          f"{w['c_collective_ms']:.1f} ms ({w['c_barrier_ms']:.1f} of it barriers); plain "
          f"{w['u_collective_bytes'] / 1e6:.1f} MB in {w['u_collectives']}, "
          f"{w['u_collective_ms']:.1f} ms ({w['u_barrier_ms']:.1f} of it barriers)")
    print(f"  MT b. Trainer(mesh=) rescaled onto FSDP shardings (local embed "
          f"{b0['local_embed_shape']}), RailPolicy(scrub_every=1, start_v=0.60, device masks), "
          f"ECC saves every step: losses {losses} vs phase 19's {t_losses[:MT_STEPS]} (max rel "
          f"{rel:.2e} <= {MT_TRAJ_RTOL}); step wall median {1e3 * b0['median_step_s']:.1f} ms = "
          f"{b0['tokens_per_s']:.0f} tokens/s; rails {[e['voltages'] for e in b0['rails']]}; "
          f"rank 0 launches {json.dumps(b0['launches'])} ({b0['packs']} packs); peak "
          f"{b0['peak_gb']} GB a rank")
    print(f"  MT c. load(shardings=) of the step-{MT_STEPS} checkpoint: each rank's shards its "
          f"slices bit for bit, one B5 a leaf on its card "
          f"({[res[r]['c']['launches']['decode'] for r in res]}; "
          f"{[round(res[r]['c']['load_s'], 2) for r in res]} s); one rank "
          f"{counts_w1['launches']['decode']} B5, {load1_s:.2f} s")
    print(f"  MT d. rescale to whole tensors: params, m, v bit for bit on every rank; "
          f"MT launches {json.dumps(total)}")
    ranks_e = [res[r]["e"] for r in res]
    print(f"  MTP {cfg.name} on a {tuple(e0['mesh'])} mesh of the same ranks (the model axis "
          f"computes; {gpu_line() if card else 'cpu'}): Trainer(mesh=) from phase 19's start, "
          f"its first step = its one-process emulation bit for bit on every rank (emulation "
          f"{[round(x['emulation_s'], 2) for x in ranks_e]} s); losses {e0['losses']} vs "
          f"phase 19's {t_losses[:MT_STEPS]} (max rel {rel_e:.2e} <= {MT_TRAJ_RTOL}); step "
          f"walls {[round(1e3 * x, 1) for x in e0['step_s']]} ms, median of the later "
          f"{1e3 * e0['median_step_s']:.1f} ms = {T_BATCH * T_SEQ / e0['median_step_s']:.0f} "
          f"tokens/s; a later step and rank {e0['sums_a_step']:.0f} rank-order sums of "
          f"{e0['sum_bytes_a_step'] / 1e6:.1f} MB, "
          f"{[round(x['barrier_ms_a_step'], 1) for x in ranks_e]} ms in barriers; gathered "
          f"over \"model\" {e0['gathered'].get('model', 0)} B (over \"data\" "
          f"{e0['gathered'].get('data', 0)} B); {e0['model_sharded_leaves']} model-sharded "
          f"leaves, every local shard half the leaf; peak GB a rank: trainer "
          f"{[x['train_peak_gb'] for x in ranks_e]}, emulation "
          f"{[x['emulation_peak_gb'] for x in ranks_e]}")
    print(f"  MTP ECC save at {tuple(e0['mesh'])} ({e0['save']['save_s']:.2f} s, rank 0 B4 "
          f"{e0['save']['launches']['encode']}) loaded onto ({MT_WORLD}, 1)'s shardings: each "
          f"rank's shards its slices of the saved state bit for bit (B5 "
          f"{[x['load']['launches']['decode'] for x in ranks_e]}, "
          f"{[round(x['load']['load_s'], 2) for x in ranks_e]} s); MTP launches "
          f"{json.dumps(total_p)}")
    cfgs = _mtf_configs(cfg_spec)
    rf = [res[r]["f"] for r in res]
    out["mtr_max_rel_vs_unsharded"] = rel_r
    out["mtr_max_rel_same_params"] = rel_s
    out["mtr_grad_rel"] = mtr["grad_rel"]
    rc = cfgs["rwkv"]
    print(f"  MTR {rc.name} cut to {rc.n_layers} of its layers ({rc.param_dtype} parameters, "
          f"{rc.compute_dtype} compute; d {rc.d_model}, "
          f"{rc.d_model // rc.rwkv_head_dim} heads, d_ff {rc.d_ff}, vocab {rc.vocab}) on the "
          f"(1, {MT_WORLD}) mesh: Trainer(mesh=), its first step = its one-process emulation bit "
          f"for bit on every rank (emulation {[round(x['MTR']['emulation_s'], 2) for x in rf]} "
          f"s); losses {mtr['losses']} vs the unsharded loss at the same params and batch "
          f"{mtr['whole_losses_same_params']} (max rel {rel_s:.2e} <= {MT_LOSS_RTOL}); the "
          f"unsharded trainer's own losses {mtr['whole_losses']} (max rel {rel_r:.2e}, not held: "
          f"the trajectory's rounding spread); the first step's float32 gradient on the ranks, "
          f"worst leaf max|diff| / max|reference|: against the unsharded float32 gradient "
          f"{mtr['grad_rel']['ranks_vs_whole']:.2e} ({mtr['grad_worst_leaf']['ranks_vs_whole']}), "
          f"against float64 {mtr['grad_rel']['ranks_vs_f64']:.2e} "
          f"({mtr['grad_worst_leaf']['ranks_vs_f64']}; both <= {MTR_GRAD_RTOL}), the unsharded "
          f"float32 against float64 {mtr['grad_rel']['whole_vs_f64']:.2e} "
          f"({mtr['grad_worst_leaf']['whole_vs_f64']}; the ranks' gradient "
          f"{[round(x['MTR']['grad_s'], 2) for x in rf]} s, the witness {mtr['witness_s']:.2f} s); "
          f"step walls "
          f"{[round(1e3 * x, 1) for x in mtr['step_s']]} ms (unsharded "
          f"{[round(1e3 * x, 1) for x in mtr['whole_step_s']]} ms), median of the later "
          f"{1e3 * mtr['median_step_s']:.1f} ms = {T_BATCH * T_SEQ / mtr['median_step_s']:.0f} "
          f"tokens/s; gathered over \"model\" {mtr['gathered'].get('model', 0)} B, activations "
          f"gathered a rank in the first step "
          f"{[x['MTR']['activation_bytes_first_step'] for x in rf]} B; "
          f"{mtr['model_sharded_leaves']} model-sharded leaves, every local shard half the leaf; "
          f"peak GB a rank: training steps {[x['MTR']['train_peak_gb'] for x in rf]}, emulation "
          f"{[x['MTR']['emulation_peak_gb'] for x in rf]}, unsharded trainer {mtr['whole_peak_gb']}, "
          f"float32 gradient on the ranks {[x['MTR']['grad_peak_gb'] for x in rf]}, the float32 "
          f"and float64 witness {mtr['witness_peak_gb']}")
    for sub, c_ in (("MTJ", cfgs["jamba"]), ("MTV", cfgs["vlm"])):
        x0 = f0[sub]
        what = (f"one mamba layer of {c_.name} (d {c_.d_model}, d_inner {c_.d_inner}, d_state "
                f"{c_.d_state})" if sub == "MTJ" else
                f"one cross-attention layer of {c_.name} (d {c_.d_model}, {c_.n_heads}/"
                f"{c_.n_kv_heads} heads, d_ff {c_.d_ff}) over {c_.n_img_tokens} image tokens")
        print(f"  {sub} {what}, batch 1 x {MTF_SEQ}, forward and backward on the (1, {MT_WORLD}) "
              f"mesh: bf16 output, input gradient and local parameter gradients = the emulation "
              f"bit for bit on every rank; float32 against the whole layer: output "
              f"{max(x[sub]['max_rel_out'] for x in rf):.2e}, input gradient "
              f"{max(x[sub]['max_rel_dx'] for x in rf):.2e} of max|whole| (<= {MTF_RTOL}); "
              f"{x0['sharded_leaves']} sharded leaves, halves; bf16 region on the ranks "
              f"{[round(x[sub]['ranks_bf16_s'], 3) for x in rf]} s, activations gathered "
              f"{[x[sub]['activation_bytes_bf16'] for x in rf]} B a rank; peak "
              f"{[x[sub]['peak_gb'] for x in rf]} GB; {x0['wall_s']:.1f} s")
    ma, ac = f0["MTA"], cfgs["audio"]
    print(f"  MTA {ac.name} cut to {ac.n_layers} of its layers ({ac.n_codebooks} codebooks, vocab "
          f"{ac.vocab}, d {ac.d_model}) on the (1, {MT_WORLD}) mesh, batch {T_BATCH} x "
          f"{ac.n_codebooks} x {T_SEQ}: one step's loss {ma['loss']:.6f}, params and moments = the "
          f"emulation bit for bit on every rank; the whole step's loss {ma['whole_loss']:.6f} "
          f"(rel {abs(ma['loss'] - ma['whole_loss']) / abs(ma['whole_loss']):.2e} <= "
          f"{MT_TRAJ_RTOL}); gathered over \"model\" {ma['gathered'].get('model', 0)} B; "
          f"{ma['model_sharded_leaves']} model-sharded leaves, halves; step "
          f"{[round(x['MTA']['step_s'], 2) for x in rf]} s; peak "
          f"{[x['MTA']['peak_gb'] for x in rf]} GB; no kernel launched in MTR, MTJ, MTV or MTA; "
          f"MT in {out['wall_s']:.1f} s")
    record = {"launches": total, "launches_by_codec": by_codec, "kv_codec": "secded72",
              "matmuls_per_forward": 0, "packs": b0["packs"], "commits": 0,
              "forwards": {"prefill": 0, "decode": 0, "decode_kernel": 0}}
    record_mtp = {"launches": total_p, "launches_by_codec": by_codec_p, "kv_codec": "secded72",
                  "matmuls_per_forward": 0, "packs": 0, "commits": 0,
                  "forwards": {"prefill": 0, "decode": 0, "decode_kernel": 0}}
    return out, {"MT": record, "MTP": record_mtp, **records_f}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 2

    import dataclasses

    import numpy as np
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import codes
    from repro_torch.codes.base import Codec
    from repro_torch.configs import get_config, get_smoke_config, paper_nn, shapes
    from repro_torch.core import faultsim, kvpages, memory, quantize, scenario
    from repro_torch.core.kvpages import KVGeometry, KVPageArena
    from repro_torch.core.nn_accel import EccMLP
    from repro_torch.core.planestore import PlaneStore
    from repro_torch.core.telemetry import FaultStats
    from repro_torch.core.voltage import PLATFORMS, power_saving
    from repro_torch.data import mnist
    from repro_torch.kernels import backend, ops, ref
    from repro_torch.kernels import ecc_matmul as b3_kernel
    from repro_torch.kernels import fault_field as field_kernel
    from repro_torch.kernels import secded as b5_kernel
    from repro_torch.models import base, layers, lm
    from repro_torch.serving import steps as serve_steps
    from repro_torch.serving.engine import (
        FaultModelConfig, ProtectionConfig, RailsConfig, ReliabilityConfig, ServingEngine,
        protect_params_inline,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    b3_names = b3_kernel.GLOBAL_KERNELS
    print(f"device: {torch.cuda.get_device_name(0)} | {gpu_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # A queue of large matmuls ahead of a timed window keeps the card busy
    # (and at its working clock) while the host enqueues every launch of the
    # window, so the window measures device time only.
    busy = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    busy_out = torch.empty_like(busy)

    def preroll(n: int) -> None:
        for _ in range(n):
            torch.mm(busy, busy, out=busy_out)

    preroll(10)
    torch.cuda.synchronize()
    _s, _e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _s.record()
    preroll(50)
    _e.record()
    _e.synchronize()
    busy_mm_ms = _s.elapsed_time(_e) / 50

    def sync_ms(fn, iters: int, warmup: int = 1) -> float:
        """Device time per call (CUDA events), the window queued behind
        ~50 ms of matmuls (its launches must fit the launch queue)."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        preroll(int(50.0 / busy_mm_ms) + 1)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t_)

    sm_clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    popc_per_s = (POPC_PER_SM_CLK * torch.cuda.get_device_properties(0).multi_processor_count
                  * sm_clock_hz)
    print(f"popc rate {popc_per_s:.3e}/s ({POPC_PER_SM_CLK} per SM per clock at "
          f"{sm_clock_hz / 1e6:.0f} MHz max SM clock)")

    def bounds(words, codec, b_u8, b_u32, popc_extra=0, encodes=1, changed=0, c_u8=0, c_u32=0,
               reencoded=0, extra_bytes=0):
        """Bytes (``b_u8`` or ``b_u32`` per word by the check plane's width,
        plus ``c_u8`` or ``c_u32`` per ``changed`` word, plus
        ``extra_bytes``) and popc (one per check bit per encode, ``encodes``
        a word and one per ``reencoded`` word, plus ``popc_extra`` a word)
        over this card's rates; the larger bounds."""
        c = codes.get(codec)
        u8 = c.n_check <= 8
        bpw = b_u8 if u8 else b_u32
        bt = 1e3 * (bpw * words + (c_u8 if u8 else c_u32) * changed + extra_bytes) / HBM_BYTES_PER_S
        ot = 1e3 * ((encodes * c.n_check + popc_extra) * words + c.n_check * reencoded) / popc_per_s
        return {"n_words": words, "codec": codec, "bytes_per_word": bpw, "bytes_ms": bt,
                "ops_ms": ot, "bound_ms": max(bt, ot),
                "bound_by": "bytes" if bt >= ot else "operations"}

    l2_flush = torch.zeros(32 * 2**20, device=dev)  # 128 MB, 2.5x the L2

    def restored_ms(fn, planes, saved, iters: int) -> float:
        """Device time of ``fn`` alone (CUDA events around each call), each
        call on ``planes`` restored from ``saved`` first and the L2 then
        filled with clean lines (a read of 128 MB), both outside its window;
        the calls queued behind ~50 ms of matmuls. ``planes`` end
        restored."""
        def restore():
            for p_, s_ in zip(planes, saved):
                p_.copy_(s_)

        fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        preroll(int(50.0 / busy_mm_ms) + 1)
        for start, end in evs:
            restore()
            l2_flush.sum()
            start.record()
            fn()
            end.record()
        restore()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in evs) / iters

    def gather_scrub_row(name, planes, ids_d, wpp, codec="secded72", iters=20, p_iters=2):
        """B6 over the pages ``ids_d`` of the faulty arena ``planes`` (left
        as they are): the kernel and its plain version timed on a copy
        restored before every call, so each timed call scrubs the same
        faults. The row holds the (clean, corrected, detected) counts of the
        timed row words (duplicate rows included, as the kernel reports
        them) and of the words of the distinct page ids, the distinct words
        that change, the bound at those counts (9 / 12 B read per distinct
        word, 8 B of payload per row word, 9 / 12 B written back per changed
        distinct word; one encode per distinct word and one per corrected
        one) and the earlier two-pass design's bound (26 / 32 B a row
        word, two encodes) beside it."""
        work = [t_.clone() for t_ in planes]
        counts = ops.gather_scrub_pages(*work, ids_d, wpp, codec=codec)[1][:, :3].sum(0).tolist()
        uniq = torch.unique(ids_d)
        once = [t_.clone() for t_ in planes]
        u_counts = ops.gather_scrub_pages(*once, uniq, wpp, codec=codec)[1][:, :3].sum(0).tolist()
        idx = uniq.long()[:, None] * wpp + torch.arange(wpp, device=dev)
        changed = int(sum((a[idx] != b[idx]).int() for a, b in zip(planes, once)).bool().sum())
        words, distinct = ids_d.numel() * wpp, idx.numel()
        del idx, once
        old = bounds(words, codec, 26, 32, encodes=2)
        row = {"name": name, **bounds(distinct, codec, 9, 12, changed=changed, c_u8=9, c_u32=12,
                                      reencoded=u_counts[1], extra_bytes=8 * words),
               "n_words": words, "distinct_words": distinct, "counts": counts,
               "distinct_counts": u_counts, "changed_words": changed,
               "bound_26_32_ms": old["bound_ms"], "bound_26_32_by": old["bound_by"]}
        row["ms"] = restored_ms(
            lambda: ops.gather_scrub_pages(*work, ids_d, wpp, codec=codec), work, planes, iters)
        row["plain_ms"] = restored_ms(
            lambda: ref.gather_scrub_ref(*work, ids_d, wpp, codec), work, planes, p_iters)
        print(f"  {name} ({words} row words, {distinct} distinct; faults restored before each "
              f"call; (clean, corrected, detected) = {counts}, distinct {u_counts}, {changed} "
              f"words change): {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; bytes {row['bytes_ms']:.4f}, popc {row['ops_ms']:.4f}; "
              f"two-pass 26/32 B bound {old['bound_ms']:.4f}), plain {row['plain_ms']:.3f} ms")
        return row

    def interval_scrub_times(arena, table, table_d, name) -> dict:
        """A stream's interval scrub of ``table`` on ``arena`` as it stands
        (faulty): wall time of ``scrub_pages`` (best of 3) and the B6 row,
        each call on the planes restored first."""
        faulty = [t_.clone() for t_ in (arena.lo, arena.hi, arena.parity)]

        def scrub_wall():
            for p_, s_ in zip((arena.lo, arena.hi, arena.parity), faulty):
                p_.copy_(s_)
            return wall_ms(lambda: arena.scrub_pages(table))

        out = {"interval_scrub_ms": min(scrub_wall() for _ in range(3))}
        row = gather_scrub_row(name, faulty, table_d, arena.geom.words_per_page,
                               arena.codec_name)
        out.update(interval_scrub_kernel_ms=row["ms"], interval_scrub_kernel=row)
        return out

    def device_events(fn, lead: int = 0) -> list:
        """(name, start_us, end_us) of every device event (kernels, copies)
        that ``fn`` causes, from torch.profiler's CUDA activity trace, after
        ``lead`` one-element kernels that open the window (their events
        are in the list)."""
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        one = torch.zeros(1, device=dev)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(lead):
                one.add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        return [(e.name, e.time_range.start, e.time_range.end)
                for e in prof.events() if e.device_type == cuda]

    def busy_us(evs) -> float:
        """Length of the union of the events' intervals."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(evs, key=lambda t: t[1]):
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def step_breakdown(params_, fwd, walls=None) -> dict:
        """Without ``walls``: the wall time of one prefill and one decode
        step (best of 3). With them (these wall times): the device time
        inside one more such step, traced by torch.profiler: the fused ECC
        matmul kernels' time and launches, all device work, and the idle
        share of the wall time. A trace can slow the host work that
        follows it in the process, so every traced step runs after the
        timed paths. Counts the forward passes it runs into ``fwd``."""
        toks_ = torch.as_tensor(prompts, device=dev)
        cache = lm.init_cache(cfg, BATCH, 64)

        def pre():
            fwd["prefill"] += 1
            return lm.prefill(params_, toks_, cfg, cache)

        logits_, _ = pre()
        tok = torch.argmax(logits_, dim=-1)[:, None]

        def dec():
            fwd["decode"] += 1
            return lm.decode_step(params_, tok, cfg, cache, PROMPT_LEN)

        out = {}
        for name, f in (("prefill", pre), ("decode", dec)):
            if walls is None:
                out[name] = {"wall_ms": min(wall_ms(f) for _ in range(3))}
                continue
            wall = walls[name]["wall_ms"]
            evs = device_events(f)
            mm = {k: [e for e in evs if v in e[0]] for k, v in b3_names.items()}
            row = {"wall_ms": wall, "traced_device_events": len(evs)}
            if evs:
                row.update({
                    "device_busy_ms": busy_us(evs) / 1e3,
                    "device_idle_share": 1.0 - busy_us(evs) / 1e3 / wall,
                    "ecc_matmul_ms": sum(e - s for v in mm.values() for _, s, e in v) / 1e3,
                    "ecc_matmul_launches": sum(map(len, mm.values())),
                    "ecc_matmul_launches_by_kernel": {k: len(v) for k, v in mm.items()},
                })
                row["ecc_matmul_share"] = row["ecc_matmul_ms"] / wall
            out[name] = row
        return out

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def same_bits(a, b) -> bool:
        """Equal dtype, shape and bits (NaNs included)."""
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))

    class Tally:
        """While active, counts what a path does that must launch a kernel:
        weight packs and token commits (B4), fault intervals and prefix-hit
        admission scrubs (B6), forward passes of the protected model by kind
        (B3, 196 each) and those of at most DECODE_MAX_M rows (B3's decode
        kernel); and every call of the plain codec on a CUDA tensor, which
        must stay 0."""

        def __init__(self):
            self.n = dict(packs=0, commits=0, intervals=0, draws=0, prefix_scrubs=0,
                          prefill=0, decode=0, decode_kernel=0, plain_on_card=0)
            self._undo = []

        def _wrap(self, obj, name, key):
            real = getattr(obj, name)

            def wrapped(*a, **kw):
                k = key(*a, **kw) if callable(key) else key
                for k_ in (k,) if isinstance(k, str) else k or ():
                    self.n[k_] = self.n.get(k_, 0) + 1
                return real(*a, **kw)

            setattr(obj, name, wrapped)
            self._undo.append((obj, name, real))

        def __enter__(self):
            on_card = lambda *a, **kw: "plain_on_card" if any(
                isinstance(t, torch.Tensor) and t.is_cuda for t in a) else None

            def kind(params, tokens, *a, **kw):
                # a forward on the card of a model with protected block leaves
                if not tokens.is_cuda or not any(isinstance(w, ops.EccWeight)
                                                 for _, w in base.flatten(params["blocks"])):
                    return None
                k = "decode" if tokens.shape[-1] == 1 else "prefill"
                small = tokens.shape[0] * tokens.shape[-1] <= b3_kernel.DECODE_MAX_M
                return (k, "decode_kernel") if small else k

            self._wrap(ops, "pack_ecc_weights", "packs")
            self._wrap(kvpages, "_commit_tokens", "commits")
            self._wrap(serve_steps, "_commit_tokens", "commits")
            self._wrap(KVPageArena, "tick", "intervals")
            self._wrap(KVPageArena, "_masks", "draws")
            self._wrap(KVPageArena, "scrub_pages", "prefix_scrubs")
            self._wrap(lm, "forward", kind)
            self._wrap(Codec, "encode", on_card)
            self._wrap(Codec, "decode", on_card)
            return self

        def __exit__(self, *exc):
            for obj, name, real in reversed(self._undo):
                setattr(obj, name, real)
            return False

        @contextlib.contextmanager
        def outside(self):
            """A check that is not part of the path (the plain versions on
            the card): what it counts is dropped."""
            saved = dict(self.n)
            yield
            self.n = saved

    def protected(c):
        """(K, N) of every protected matrix of a layer (K % 8 == 0 and both
        at least 64, as ``protect_params_inline`` takes them): wq, wk, wv,
        wo, and of a dense layer w1, w3 where the MLP is gated, w2 (an MoE
        layer's experts, router and shared expert stay plain)."""
        d_, hq, hkv = c.d_model, c.n_heads * c.hd, c.n_kv_heads * c.hd
        mats = [(d_, hq), (d_, hkv), (d_, hkv), (hq, d_)]
        if c.family != "moe":
            mats += [(d_, c.d_ff)] + [(d_, c.d_ff)] * c.gated_mlp + [(c.d_ff, d_)]
        return [(k_, n_) for k_, n_ in mats if k_ % 8 == 0 and min(k_, n_) >= 64]

    def b3_split(c, m: int) -> dict:
        """A forward's protected matmuls at ``m`` rows by the B3 kernel each
        takes (``ecc_matmul_kernel_for``: the decode kernel for at most
        DECODE_MAX_M rows and K within its shared memory)."""
        kinds = [b3_kernel.kernel_for(m, k_) for k_, _ in protected(c)]
        return {k_: kinds.count(k_) * c.n_layers for k_ in ("decode", "tiled")}

    def b3_by_kernel_check(name, tally, counts, c):
        """The fused matmul's launches by the kernel each took, as the
        wrapper counted them: each forward of at most DECODE_MAX_M rows puts
        ``b3_split(c, 1)["decode"]`` matmuls on the decode kernel, the rest
        go tiled."""
        got = ops.ecc_matmul_launches_by_kernel()
        want = b3_split(c, 1)["decode"] * tally.n.get("decode_kernel", 0)
        require(sum(got.values()) == counts["ecc_matmul"] and got["decode"] == want,
                f"{name}: B3 launches by kernel {got}, expected {want} on the decode "
                f"kernel of {counts['ecc_matmul']}")
        return got

    def peak_gb() -> float:
        return torch.cuda.max_memory_allocated() / 1e9

    # ---------------------------------------------------------------- 1
    with Phase("1 build kernels"):
        built = backend.build()
        for name in backend.SOURCES:
            print(f"  built {name}.cu in {built.get(name, 0.0):.1f} s -> "
                  f"{backend.library_path(name).name}")
            for line in backend.BUILD_LOG.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    ptxas {line.strip()}")
        # B3's two kernels: at qwen3-0.6b's widths decode forwards (M = BATCH)
        # run the decode kernel, prefill forwards (M = BATCH x PROMPT_LEN) the
        # tiled one.
        require(all(b3_kernel.kernel_for(BATCH, k_) == "decode"
                    and b3_kernel.kernel_for(BATCH * PROMPT_LEN, k_) == "tiled"
                    for k_ in (1024, 2048, 3072)), "B3 kernel choice vs shapes")

    cfg = get_config("qwen3-0.6b")
    platform = PLATFORMS["vc707"]
    report: dict = {}

    def b3_shape_rows(label, leaves, n_groups) -> list:
        """B3 at a model's four (K, N) (wq, wk, w1, w2 of ``leaves``, the
        protected leaves by name; the engine at 0.56 V, so the planes carry
        faults) at M = batch, 20 and batch x prompt against the plain
        version on two layers, timed beside the plain version and
        torch.matmul on the dequantised weights, with its bound; the M =
        batch rows equal to the same rows at M = batch x prompt. Only w2
        takes the tiled kernel at M = batch."""
        gen = torch.Generator(device=dev).manual_seed(2)
        b3_rows = []
        for wname in (w_ for w_ in ("wq", "wk", "w1", "w2") if w_ in leaves):
            ew = leaves[wname]
            layers_ = [ew.layer(g) for g in range(n_groups)]
            w_deq = []
            for lw in layers_[:2]:
                dlo, dhi, _ = ref.decode_ref(lw.lo, lw.hi, lw.parity)
                w_deq.append(ref.unpack_ecc_weights(dlo, dhi).to(torch.float32) * lw.scale)
            x_all = torch.randn(BATCH * PROMPT_LEN, ew.k, generator=gen, device=dev)
            for lw in layers_[:2]:
                require(torch.equal(ops.ecc_matmul(x_all[:BATCH], lw),
                                    ops.ecc_matmul(x_all, lw)[:BATCH]),
                        f"{label} {wname}: the M={BATCH} rows differ from the same rows at "
                        f"M={BATCH * PROMPT_LEN}")
            for m in (BATCH, VERIFY_M, BATCH * PROMPT_LEN):
                x = x_all[:m]
                worst, rel_ = 0.0, 0.0
                for lw in layers_[:2]:
                    k_o = ops.ecc_matmul(x, lw)
                    p_o = ref.ecc_matmul_ref(x, lw.lo, lw.hi, lw.parity, lw.scale)
                    err, scale = float((k_o - p_o).abs().max()), float(p_o.abs().max())
                    require(bool(torch.isfinite(k_o).all()), f"{label} {wname} non-finite")
                    require(err <= MATMUL_RTOL * scale,
                            f"{label} {wname} M={m}: err {err} > {MATMUL_RTOL} * {scale}")
                    worst, rel_ = max(worst, err), max(rel_, err / scale)
                ms = sync_ms(lambda: [ops.ecc_matmul(x, lw) for lw in layers_], 5) / len(layers_)
                pms = sync_ms(lambda: [ref.ecc_matmul_ref(x, lw.lo, lw.hi, lw.parity, lw.scale)
                                       for lw in layers_[:2]], 2) / 2
                lib = sync_ms(lambda: [torch.matmul(x, w) for w in w_deq], 20) / len(w_deq)
                k, nn = ew.k, ew.n
                nbytes = 4 * m * k + 9 * k * nn // 8 + 4 * nn + 4 * m * nn
                bt, ot = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * 3 * 2 * m * k * nn / BF16_TC_FLOPS
                row = {"key": wname, "M": m, "K": k, "N": nn,
                       "function": b3_names[b3_kernel.kernel_for(m, k)], "ms": ms,
                       "plain_ms": pms, "library_ms": lib, "bound_ms": max(bt, ot),
                       "bound_by": "bytes" if bt >= ot else "operations", "bytes_ms": bt,
                       "ops_ms": ot, "max_abs_err": worst, "max_rel_err": rel_}
                b3_rows.append(row)
                print(f"  {label} ecc_matmul {wname} M={m} K={k} N={nn} ({row['function']}): "
                      f"max err {worst:.3e} (rel {rel_:.2e}), {ms:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {pms:.4f} ms, "
                      f"torch.matmul {lib:.4f} ms")
            del w_deq, x_all, layers_
        tiled_at_batch = sum(b3_kernel.kernel_for(BATCH, leaves[w_].k) == "tiled"
                             for w_ in ("wq", "wk", "w1", "w2") if w_ in leaves)
        require(sum(r["function"] == b3_names["tiled"] for r in b3_rows if r["M"] == BATCH)
                == tiled_at_batch, f"{label} at M = batch: only the leaves of K past the "
                "decode kernel's shared memory (w2) take the tiled kernel")
        print(f"  {label} ecc_matmul rows: the M={BATCH} rows equal the same rows at "
              f"M={BATCH * PROMPT_LEN}, every (K, N)")
        return b3_rows

    def b3_traced(label, params_, c, prompts_) -> dict:
        """Which B3 kernel each matmul of a forward ran, as the profiler saw
        it: a prefill's all tiled, a decode step's by ``b3_split`` (w2 tiled
        where its K is past the decode kernel's shared memory); the wrapper
        counts the same. torch.profiler can lose device records from a
        window: late in this process it loses one or two near the start of
        every window of a step (minitron-8b's decode step: layer 0's w1
        launch, in every window), fewer the more kernels open the window.
        So a window that saw fewer launches than the wrapper counted is
        traced again (up to 5 windows), each opened by 4x more one-element
        kernels (0, 4, 16, 64, 256), which take the losses; a window that
        saw more, or the other kernel, fails."""
        toks_ = torch.as_tensor(prompts_, device=dev)
        cache_ = lm.init_cache(c, BATCH, 64)
        logits_, _ = lm.prefill(params_, toks_, c, cache_)
        tok_ = torch.argmax(logits_, dim=-1)[..., None]
        traced = {}
        for kind_, f_, want in (
                ("prefill", lambda: lm.prefill(params_, toks_, c, cache_),
                 b3_split(c, BATCH * PROMPT_LEN)),
                ("decode", lambda: lm.decode_step(params_, tok_, c, cache_, PROMPT_LEN),
                 b3_split(c, BATCH))):
            for lead in (0, 4, 16, 64, 256):
                ops.reset_launch_count()
                evs = device_events(f_, lead)
                ran = {k_: sum(v in e[0] for e in evs) for k_, v in b3_names.items()}
                counted = ops.ecc_matmul_launches_by_kernel()
                require(counted == want and all(ran[k_] <= want[k_] for k_ in want),
                        f"{label} traced {kind_}: B3 kernels {ran}, counted {counted}, "
                        f"expected {want}")
                traced.setdefault(kind_, []).append(ran)
                if ran == want:
                    break
            require(ran == want, f"{label} traced {kind_}: no window saw every B3 launch "
                    f"{traced[kind_]}, expected {want}")
        print(f"  {label} traced forwards, B3 launches by kernel in each window "
              f"(the last = the wrapper's count): {json.dumps(traced)}")
        return traced

    # ---------------------------------------------------------------- 17
    # The recurrent families: rwkv6-3b at its published width and depth
    # (path RW) and jamba's smoke config on the card against the CPU with
    # one mamba layer at jamba's published width (path JB).
    def time_mix_f64(x, p, c):
        """RWKV-6 time-mix as the plain recurrence, one token at a time, in
        float64: token shift, the five-way data-dependent lerp, r / k / v /
        g, the decay exp(-exp(wlog)), y_t = r_t (S + diag(u) k_t v_t^T), S =
        diag(w_t) S + k_t v_t^T, the per-head norm, the output projection."""
        b_, s_, d_ = x.shape
        n_ = c.rwkv_head_dim
        h_ = d_ // n_
        prev = torch.zeros(b_, d_, dtype=x.dtype, device=x.device)
        st = torch.zeros(b_, h_, n_, n_, dtype=x.dtype, device=x.device)
        u = p["u"].reshape(h_, n_, 1)
        outs = []
        for t in range(s_):
            xt = x[:, t]
            xx = prev - xt
            k5 = torch.tanh((xt + xx * p["mu_base"]) @ p["mix_a"]).reshape(b_, 5, -1)
            dyn = torch.einsum("bfr,frd->bfd", k5, p["mix_b"])
            xr, xk, xv, xg, xw = (xt[:, None] + xx[:, None] * (p["mu_five"] + dyn)).unbind(1)
            r, k, v = ((z @ p[w]).reshape(b_, h_, n_) for z, w in
                       ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
            g = xg @ p["w_g"]
            w = torch.exp(-torch.exp(p["w_base"] + torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]))
            kv = k[..., :, None] * v[..., None, :]
            y = torch.einsum("bhi,bhij->bhj", r, st + u * kv)
            st = w.reshape(b_, h_, n_, 1) * st + kv
            yc = y - y.mean(-1, keepdim=True)
            yn = yc / torch.sqrt((yc * yc).mean(-1, keepdim=True) + 64e-5)
            yn = yn.reshape(b_, d_) * p["ln_x_g"] + p["ln_x_b"]
            outs.append((yn * torch.nn.functional.silu(g)) @ p["w_o"])
            prev = xt
        return torch.stack(outs, 1), st

    def mamba_f64(x, p, c):
        """The selective SSM as the plain recurrence, one token at a time, in
        float64: the causal convolution over the last d_conv inputs, delta
        = softplus(dt_proj(.) + dt_bias), h = exp(delta A) h + delta x B,
        y = C . h + D x, gated by silu(z)."""
        b_, s_, _ = x.shape
        di, ds, kc = c.d_inner, c.d_state, c.d_conv
        xs, z = torch.split(x @ p["in_proj"], di, dim=-1)
        win = torch.zeros(b_, kc, di, dtype=x.dtype, device=x.device)
        h = torch.zeros(b_, di, ds, dtype=x.dtype, device=x.device)
        a = -torch.exp(p["a_log"])
        dtr = p["dt_proj"].shape[0]
        ys = []
        for t in range(s_):
            win = torch.cat([win[:, 1:], xs[:, t:t + 1]], dim=1)
            xc = torch.nn.functional.silu((win * p["conv_w"].T[None]).sum(1) + p["conv_b"])
            delta, bm, cm = torch.split(xc @ p["x_proj"], [dtr, ds, ds], dim=-1)
            delta = torch.nn.functional.softplus(delta @ p["dt_proj"] + p["dt_bias"])
            h = torch.exp(delta[..., None] * a) * h + (delta * xc)[..., None] * bm[:, None, :]
            ys.append((h * cm[:, None, :]).sum(-1) + xc * p["d_skip"])
        y = torch.stack(ys, 1)
        return (y * torch.nn.functional.silu(z)) @ p["out_proj"], h

    def recurrent_phase(report: dict, paths_extra: dict) -> dict:
        from repro_torch.models import mamba, rwkv6

        out: dict = {}
        rng_ = np.random.default_rng(7)
        gen = torch.Generator(device=dev).manual_seed(7)
        f32, f64 = torch.float32, torch.float64
        below = lambda eng_, v, *a, **kw: ("steps", "steps_below") if \
            platform.fault_rate(float(v)) > 0.0 else "steps"
        rails_below = lambda eng_, volts, *a, **kw: ("rail_steps", "rail_steps_below") if any(
            platform.fault_rate(float(v)) > 0.0 for v in volts.values()) else "rail_steps"

        def record(counts, n_) -> dict:
            by_k = ops.ecc_matmul_launches_by_kernel()
            require(sum(by_k.values()) == counts["ecc_matmul"], f"B3 by kernel {by_k}")
            return {"launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
                    "kv_codec": None, "b3_by_kernel": by_k, "matmuls_per_forward": 0,
                    "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                                 "decode_kernel": n_.get("decode_kernel", 0)},
                    "packs": n_["packs"], "commits": n_["commits"]}

        # RW: rwkv6-3b, nothing cut
        rcfg = get_config("rwkv6-3b")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rparams = lm.init_params(rcfg, seed=0, device=dev)
        torch.cuda.synchronize()
        n_par = sum(v_.numel() for _, v_ in base.flatten(rparams))
        require(n_par == RW_PARAMS, f"rwkv6-3b parameters {n_par}")
        rw = out["RW"] = {"params": n_par, "init_s": time.perf_counter() - t0}
        print(f"  RW rwkv6-3b at its published width and depth ({rcfg.n_layers} layers, d "
              f"{rcfg.d_model}, {rcfg.d_model // rcfg.rwkv_head_dim} heads of "
              f"{rcfg.rwkv_head_dim}, d_ff {rcfg.d_ff}, vocab {rcfg.vocab}, LayerNorm, bf16): "
              f"{n_par} parameters ({2 * n_par / 1e9:.2f} GB), drawn in {rw['init_s']:.1f} s")
        r_prompts = rng_.integers(0, rcfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)

        # a. the plain model
        t_ = time.perf_counter()
        toks_plain = ServingEngine(rcfg, rparams, rel=None, max_len=64).generate(
            r_prompts, NEW_TOKENS)
        gen_s = time.perf_counter() - t_
        require(toks_plain.shape == (BATCH, NEW_TOKENS)
                and bool(((toks_plain >= 0) & (toks_plain < rcfg.vocab)).all()), "RW tokens")
        toks_d = torch.as_tensor(r_prompts, device=dev)
        cache_ = lm.init_cache(rcfg, BATCH, 64)
        pre = lambda: lm.prefill(rparams, toks_d, rcfg, cache_)
        logits_, _ = pre()
        require(bool(torch.isfinite(logits_).all()), "RW prefill logits")
        tok_ = torch.argmax(logits_, dim=-1)[:, None]
        dec = lambda: lm.decode_step(rparams, tok_, rcfg, cache_, PROMPT_LEN)
        rw["a"] = {"generate_s": gen_s, "tokens_per_s": BATCH * NEW_TOKENS / gen_s,
                   "prefill_wall_ms": min(wall_ms(pre) for _ in range(3)),
                   "decode_wall_ms": min(wall_ms(dec) for _ in range(3))}
        class OpCount(TorchDispatchMode):
            """PyTorch (aten) operations dispatched inside the window."""

            def __init__(self):
                super().__init__()
                self.n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                self.n += 1
                return func(*args, **(kwargs or {}))

        with OpCount() as ops_:
            dec()
        rw["a"]["decode_ops"] = ops_.n
        evs = device_events(dec)
        if evs:
            rw["a"]["decode_busy_ms"] = busy_us(evs) / 1e3
            rw["a"]["decode_idle_share"] = (1.0 - rw["a"]["decode_busy_ms"]
                                            / rw["a"]["decode_wall_ms"])
        rw["a"]["peak_gb"] = peak_gb()
        print(f"  RW a. plain model: generate {BATCH} x {PROMPT_LEN} -> {NEW_TOKENS} tokens in "
              f"{gen_s:.2f} s = {rw['a']['tokens_per_s']:.1f} tokens/s; prefill wall "
              f"{rw['a']['prefill_wall_ms']:.2f} ms, decode step wall "
              f"{rw['a']['decode_wall_ms']:.2f} ms, traced device busy "
              f"{rw['a'].get('decode_busy_ms', float('nan')):.2f} ms (idle share "
              f"{rw['a'].get('decode_idle_share', float('nan')):.3f}), "
              f"{rw['a']['decode_ops']} PyTorch operations "
              f"({rw['a']['decode_ops'] / rcfg.n_layers:.0f} a layer); peak "
              f"{rw['a']['peak_gb']:.1f} GB")

        # b. float32 at full width and depth: the chunked path against the
        # step path, time-mix against a float64 recurrence; the long prefill
        c32 = dataclasses.replace(rcfg, param_dtype=f32, compute_dtype=f32)
        p32 = base.tree_map(lambda t_: t_.to(f32), rparams)
        t33 = torch.as_tensor(rng_.integers(0, rcfg.vocab, (BATCH, PROMPT_LEN + 1)), device=dev)
        l33, _ = lm.prefill(p32, t33, c32, lm.init_cache(c32, BATCH, 64))
        c_ = lm.init_cache(c32, BATCH, 64)
        lm.prefill(p32, t33[:, :PROMPT_LEN], c32, c_)
        l1, _ = lm.decode_step(p32, t33[:, PROMPT_LEN:], c32, c_, PROMPT_LEN)
        step_err, step_scale = float((l33 - l1).abs().max()), float(l33.abs().max())
        require(bool(torch.isfinite(l33).all()) and step_err <= RW_STEP_RTOL * step_scale,
                f"RW float32: prefill({PROMPT_LEN + 1}) differs from prefill({PROMPT_LEN}) + a "
                f"decode step by {step_err} (max |logits| {step_scale})")
        del l33, l1, c_
        p_tm = {k_: v_[0] for k_, v_ in p32["blocks"]["p0"]["tm"].items()}
        g32 = torch.Generator(device=dev).manual_seed(8)
        for k_ in ("mu_base", "mu_five", "u", "ln_x_b"):  # init_params draws them as zeros
            p_tm[k_] = 0.3 * torch.randn(p_tm[k_].shape, generator=g32, device=dev)
        s_scan, s_dec = 128, 16
        require(rwkv6.chunks_of(s_scan) == (2, 64), "RW time-mix chunks")
        xs_ = torch.randn(BATCH, s_scan + s_dec, rcfg.d_model, generator=g32, device=dev)
        y_, st_ = rwkv6.time_mix(xs_[:, :s_scan], p_tm, c32)
        ys_ = [y_]
        for t in range(s_scan, s_scan + s_dec):
            y_, st_ = rwkv6.time_mix(xs_[:, t:t + 1], p_tm, c32, st_)
            ys_.append(y_)
        got = torch.cat(ys_, 1)
        want, st64 = time_mix_f64(xs_.to(f64), {k_: v_.to(f64) for k_, v_ in p_tm.items()}, c32)
        tm_err = float((got.to(f64) - want).abs().max() / want.abs().max())
        wkv_err = float((st_["wkv"].to(f64) - st64).abs().max() / st64.abs().max())
        require(tm_err <= F64_RTOL and wkv_err <= F64_RTOL,
                f"RW float32 time-mix against the float64 recurrence: {tm_err} / {wkv_err} > "
                f"{F64_RTOL}")
        del p32, got, want, xs_, st_, st64, ys_, y_
        torch.cuda.empty_cache()
        long_t = torch.as_tensor(rng_.integers(0, rcfg.vocab, (BATCH, RW_LONG)), device=dev)
        require(rwkv6.chunks_of(RW_LONG) == (32, 64), "RW long prefill chunks")
        long_l = []
        long_ms = min(wall_ms(lambda: long_l.append(lm.prefill(
            rparams, long_t, rcfg, lm.init_cache(rcfg, BATCH, RW_LONG))[0])) for _ in range(2))
        require(bool(torch.isfinite(long_l[-1]).all()), "RW long prefill logits")
        del long_l, long_t
        rw["b"] = {"step_max_abs_diff": step_err, "max_abs_logit": step_scale,
                   "step_rtol": RW_STEP_RTOL, "time_mix_rel_err": tm_err,
                   "wkv_rel_err": wkv_err, "f64_rtol": F64_RTOL,
                   "long_prefill_tokens": RW_LONG, "long_prefill_ms": long_ms,
                   "long_prefill_tokens_per_s": BATCH * RW_LONG / long_ms * 1e3}
        print(f"  RW b. float32 at full width and depth: prefill({PROMPT_LEN + 1}) = "
              f"prefill({PROMPT_LEN}) + a decode step within {step_err:.3e} (max |logits| "
              f"{step_scale:.3e}, tolerance {RW_STEP_RTOL} x max); layer 0's time-mix at S = "
              f"{s_scan} (2 chunks) and {s_dec} decode steps against a float64 recurrence: "
              f"rel err {tm_err:.3e}, wkv state {wkv_err:.3e} (tolerance {F64_RTOL}); "
              f"bf16 prefill of {BATCH} x {RW_LONG} tokens (32 chunks) {long_ms:.1f} ms = "
              f"{rw['b']['long_prefill_tokens_per_s']:.0f} tokens/s")

        ops.reset_launch_count()  # path RW: engines c-e
        with Tally() as tally:
            tally._wrap(memory, "decode_read", "reads")
            tally._wrap(memory.EccMemoryDomain, "write", "writes")
            tally._wrap(ServingEngine, "set_rails", rails_below)
            # c. domain mode at full width, then the depth cut at 0.56 V
            t_ = time.perf_counter()
            deng = ServingEngine(rcfg, rparams, rel=ReliabilityConfig(mode="domain", voltage=1.0),
                                 max_len=64)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t_
            words = sum(deng.domain.entry(k_).n_words for k_ in deng.domain.names())
            n_arrays = len(deng.domain.names())
            require(words == RW_WORDS, f"RW domain words {words}")
            require(all(same_bits(a_, b_) for (_, a_), (_, b_) in
                        zip(base.flatten(deng.params), base.flatten(rparams))),
                    "RW domain mode's nominal read-back differs from the params it wrote")
            require(np.array_equal(deng.generate(r_prompts, NEW_TOKENS), toks_plain),
                    "RW domain mode at nominal: tokens differ from the plain model's")
            del deng
            torch.cuda.empty_cache()
            c2 = dataclasses.replace(rcfg, n_layers=RW_CUT_LAYERS)
            p2 = {**rparams, "blocks": base.tree_map(lambda t_: t_[:RW_CUT_LAYERS],
                                                     rparams["blocks"])}
            ceng = ServingEngine(c2, p2, rel=ReliabilityConfig(mode="domain", voltage=1.0),
                                 max_len=64)
            cwords = sum(ceng.domain.entry(k_).n_words for k_ in ceng.domain.names())
            require(cwords == RW_CUT_WORDS, f"RW cut domain words {cwords}")
            mask_s = []
            real_gather = memory.gather_masks

            def timed_gather(*a, **kw):
                t1 = time.perf_counter()
                r_ = real_gather(*a, **kw)
                mask_s.append(time.perf_counter() - t1)
                return r_

            memory.gather_masks = timed_gather
            try:
                before = ceng.stats.counters()
                t_ = time.perf_counter()
                ceng.set_voltage(0.56)
                torch.cuda.synchronize()
                read_s = time.perf_counter() - t_
            finally:
                memory.gather_masks = real_gather
            step_cnt = ceng.stats.counters() - before
            with tally.outside():
                plain_cnt = np.zeros_like(step_cnt)
                for key, arr in base.flatten(ceng.params):
                    e_ = ceng.domain.entry("w" + key)
                    m_ = faultsim.device_masks(e_.field, 0.56, dev)
                    plo, phi, pst = ref.decode_ref(*ref.inject_ref(e_.lo, e_.hi, e_.parity, *m_))
                    require(same_bits(arr, quantize.words_to_array(plo, phi, e_.nbytes, e_.shape,
                                                                   e_.dtype)),
                            f"RW domain read-back of {key} at 0.56 V differs from the plain read")
                    plain_cnt += FaultStats.from_decode(pst, faultsim.flip_counts(*m_)).counters()
                    del m_, plo, phi, pst
            require(np.array_equal(plain_cnt, step_cnt),
                    f"RW domain counters {step_cnt.tolist()} differ from the plain read's "
                    f"{plain_cnt.tolist()}")
            stats_056 = dict(zip(("clean", "corrected", "detected", "silent", "words_1bit",
                                  "words_2bit", "words_multi", "faulty_bits"),
                                 step_cnt.tolist()))
            require(stats_056["corrected"] > 0, f"RW 0.56 V read {stats_056}")
            rw["c"] = {"arrays": n_arrays, "words": words, "write_and_read_s": build_s,
                       "cut_layers": RW_CUT_LAYERS, "cut_words": cwords, "read_056_s": read_s,
                       "host_mask_s": sum(mask_s), "stats_056": stats_056}
            del ceng, p2
            torch.cuda.empty_cache()
            print(f"  RW c. domain mode: {n_arrays} arrays, {words} raw words written and read "
                  f"at nominal in {build_s:.1f} s, the read-back = the params bit for bit, tokens "
                  f"= the plain model's; {RW_CUT_LAYERS}-layer cut ({cwords} words) read at "
                  f"0.56 V in {read_s:.1f} s (host masks {sum(mask_s):.1f} s): every array and "
                  f"the counters = B7 + B5's plain versions on the same masks; "
                  f"{json.dumps(stats_056)}")

            # d. single-rail inline: the key rule protects no leaf
            before = ops.launch_counts()
            ieng = ServingEngine(rcfg, rparams, rel=ReliabilityConfig(mode="inline", voltage=1.0),
                                 max_len=64)
            require(ieng._store.n_words == 0 and ieng._store.groups == (),
                    f"RW single-rail arena of {ieng._store.n_words} words")
            ieng.set_voltage(0.56)
            require(np.array_equal(ieng.generate(r_prompts, NEW_TOKENS), toks_plain),
                    "RW single-rail inline at 0.56 V: tokens differ from the plain model's")
            require(ops.launch_counts() == before, f"RW empty arena launched "
                    f"{ops.launch_counts()} (before {before})")
            rw["d"] = {"protected_words": 0, "power_report": ieng.power_report()}
            del ieng
            print(f"  RW d. single-rail inline engine: 0 protected words (the leaves are keyed "
                  f"tm / cm), no launch; tokens at 0.56 V = the plain model's; power "
                  f"{json.dumps(rw['d']['power_report'])}")

            # e. multi-rail inline with device masks: the embedding alone
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    fault_model=FaultModelConfig(mask_source="device"),
                                    rails=RailsConfig(multi_rail=True, start_v=0.62))
            meng = ServingEngine(rcfg, rparams, rel=rel, max_len=64)
            require(meng._store.domains == ("embedding",)
                    and meng._store.n_words == RW_EMBED_WORDS,
                    f"RW multi-rail arena {meng._store.domains} of {meng._store.n_words} words")
            m_nom = meng.generate(r_prompts, NEW_TOKENS)
            with tally.outside():
                qw, sc = quantize.quantize(rparams["embed"].to(f32), axis=1)
                q_toks = ServingEngine(rcfg, {**rparams, "embed": qw.to(f32) * sc.reshape(-1)},
                                       rel=None, max_len=64).generate(r_prompts, NEW_TOKENS)
                del qw, sc
            require(np.array_equal(m_nom, q_toks), "RW multi-rail at nominal: tokens differ "
                    "from the plain model's on the int8 embedding")
            meng.set_rails({"embedding": 0.56})
            scrub = meng._last_scrub.total()
            require(scrub.corrected > 0, f"RW 0.56 V embedding step {scrub}")
            m56 = meng.generate(r_prompts, NEW_TOKENS)
            t_ = time.perf_counter()
            locks, hist = meng.autotune_voltage()
            torch.cuda.synchronize()
            require(meng.controller.locked, "RW multi-rail walk did not lock")
            rw["e"] = {"protected_words": meng._store.n_words,
                       "agreement_nominal_with_bf16": float((m_nom == toks_plain).mean()),
                       "agreement_056_with_nominal": float((m56 == m_nom).mean()),
                       "scrub_056": scrub.to_dict(), "walk_s": time.perf_counter() - t_,
                       "locks": locks, "power_report": meng.power_report(),
                       "history": {d: [(r.voltage, r.corrected, r.detected, r.action)
                                       for r in h] for d, h in hist.items()}}
            del meng
            print(f"  RW e. multi-rail inline engine, device masks: the embedding alone "
                  f"({RW_EMBED_WORDS} words); nominal tokens = the plain model's on the int8 "
                  f"embedding (agreement with the bf16 embedding's "
                  f"{rw['e']['agreement_nominal_with_bf16']:.4f}); 0.56 V scrub "
                  f"{json.dumps(rw['e']['scrub_056'])}, agreement with nominal "
                  f"{rw['e']['agreement_056_with_nominal']:.4f}; walk from 0.62 V in "
                  f"{rw['e']['walk_s']:.2f} s: locks {json.dumps(locks)}, modelled power "
                  f"{rw['e']['power_report']['total_w']:.4f} W, saving "
                  f"{rw['e']['power_report']['saving_vs_nominal']:.4f}")
            counts, n_ = ops.launch_counts(), dict(tally.n)
        want = dict.fromkeys(counts, 0)
        want.update(encode=n_["writes"] + n_["packs"], inject=n_["reads"],
                    decode=n_["reads"] + n_["rail_steps"],
                    inject_scrub_domains=n_["rail_steps"],
                    fault_field=n_.get("rail_steps_below", 0))
        require(counts == want and n_["packs"] == 1 and n_["plain_on_card"] == 0,
                f"RW launches {counts}, expected {want} (tally {n_})")
        paths_extra["RW"] = record(counts, n_)
        rw["launches"], rw["peak_gb"] = counts, peak_gb()
        print(f"  RW launches: {json.dumps(counts)} = {n_['writes']} domain writes + 1 "
              f"embedding pack, {n_['reads']} domain array reads, {n_['rail_steps']} rail "
              f"steps ({n_.get('rail_steps_below', 0)} below V_min); peak {rw['peak_gb']:.1f} GB")
        del rparams
        torch.cuda.empty_cache()

        # JB: jamba's smoke config on the card against the CPU at 0.56 V
        jcfg = get_smoke_config("jamba-1.5-large-398b")
        jp = lm.init_params(jcfg, seed=0, device="cpu")
        j_prompts = rng_.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
        jrel = ReliabilityConfig(mode="inline", voltage=1.0)
        jb = out["JB"] = {}
        res = {}

        def jamba_run(d):
            e_ = ServingEngine(jcfg, jp, rel=jrel, max_len=32, device=d)
            e_.set_voltage(0.56)
            toks = e_.generate(j_prompts, 8)
            logits = lm.prefill(e_.params, torch.as_tensor(j_prompts, device=d), jcfg,
                                lm.init_cache(jcfg, 2, 32, device=d))[0]
            keys = sorted(k_ for k_, w in base.flatten(e_.params) if isinstance(w, ops.EccWeight))
            return toks, dataclasses.asdict(e_._last_scrub), logits.cpu(), keys

        res["cpu"] = jamba_run("cpu")
        ops.reset_launch_count()  # path JB: the card's engine
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_voltage", below)
            res["cuda"] = jamba_run("cuda")
            counts, n_ = ops.launch_counts(), dict(tally.n)
        (ct, cs, cl, ck), (gt, gs, gl, gk) = res["cpu"], res["cuda"]
        n_prot = len(ck)
        require(ck == gk and n_prot == 14, f"JB protected leaves {gk}")
        require(cs == gs and gs["corrected"] > 0, f"JB counters: card {gs}, CPU {cs}")
        require(np.array_equal(ct, gt), "JB tokens: the card's differ from the CPU's")
        j_err, j_scale = float((gl - cl).abs().max()), float(cl.abs().max())
        require(j_err <= MATMUL_RTOL * j_scale, f"JB logits differ by {j_err} (max {j_scale})")
        want = dict.fromkeys(counts, 0)
        want.update(inject_scrub=n_["steps"], encode=n_["packs"],
                    ecc_matmul=n_prot * (n_["prefill"] + n_["decode"]))
        by_k = ops.ecc_matmul_launches_by_kernel()
        require(counts == want and n_["packs"] == n_prot and n_["steps"] == 2
                and by_k["decode"] == n_prot * n_["decode_kernel"] and n_["plain_on_card"] == 0,
                f"JB launches {counts}, expected {want}; by kernel {by_k}; tally {n_}")
        paths_extra["JB"] = record(counts, n_)
        jb.update({"protected_leaves": n_prot, "scrub_056": gs, "logit_max_abs_diff": j_err,
                   "max_abs_logit": j_scale, "launches": counts, "b3_by_kernel": by_k})
        print(f"  JB jamba smoke (8 layers = one period, p4 attention, MoE at odd positions) "
              f"through an inline engine at 0.56 V, host masks: {n_prot} protected leaves, "
              f"tokens and counters card = CPU, logits within {j_err:.3e} (max {j_scale:.3e}); "
              f"launches {json.dumps(counts)}, B3 by kernel {json.dumps(by_k)}")

        # one mamba layer at jamba's published width against a float64
        # recurrence on the card: in float32 (the chunked lowering's
        # exactness) and in bf16 (the published compute dtype)
        wcfg = get_config("jamba-1.5-large-398b")
        pm = base.materialize(lm._mamba_spec(wcfg), torch.Generator(device=dev).manual_seed(0),
                              torch.bfloat16, dev)
        for k_ in ("conv_b", "dt_bias"):  # init_params draws them as zeros
            pm[k_] = (0.1 * torch.randn(pm[k_].shape, generator=gen, device=dev)).to(
                torch.bfloat16)
        require(pm["dt_proj"].shape[0] == 512 and pm["in_proj"].shape == (8192, 2 * 16384)
                and pm["a_log"].shape == (16384, 16), "JB mamba shapes")
        xm = torch.randn(BATCH, s_scan + s_dec, wcfg.d_model, generator=gen,
                         device=dev).to(torch.bfloat16)
        want_m, h64 = mamba_f64(xm.to(f64), {k_: v_.to(f64) for k_, v_ in pm.items()}, wcfg)
        mw = jb["mamba_width"] = {"d_model": wcfg.d_model, "d_inner": wcfg.d_inner,
                                  "d_state": wcfg.d_state, "dt_rank": 512, "batch": BATCH,
                                  "scan": s_scan, "decode_steps": s_dec}
        for dt, rtol, s_rtol in ((f32, F64_RTOL, F64_RTOL),
                                 (torch.bfloat16, MAMBA_BF16_RTOL, MAMBA_BF16_STATE_RTOL)):
            c_m = dataclasses.replace(wcfg, param_dtype=dt, compute_dtype=dt)
            p_m = {k_: v_.to(dt) for k_, v_ in pm.items()}
            t_ = time.perf_counter()
            y_, st_ = mamba.mamba_layer(xm[:, :s_scan].to(dt), p_m, c_m)
            ys_ = [y_]
            for t in range(s_scan, s_scan + s_dec):
                y_, st_ = mamba.mamba_layer(xm[:, t:t + 1].to(dt), p_m, c_m, st_)
                ys_.append(y_)
            got = torch.cat(ys_, 1)
            torch.cuda.synchronize()
            layer_s = time.perf_counter() - t_
            m_err = float((got.to(f64) - want_m).abs().max() / want_m.abs().max())
            h_err = float((st_["ssm"].to(f64) - h64).abs().max() / h64.abs().max())
            tag = str(dt).split(".")[-1]
            require(bool(torch.isfinite(got).all()) and m_err <= rtol and h_err <= s_rtol,
                    f"JB mamba layer at jamba's width in {tag} against the float64 recurrence: "
                    f"{m_err} / {h_err} > {rtol} / {s_rtol}")
            mw[tag] = {"rel_err": m_err, "ssm_state_rel_err": h_err, "rtol": rtol,
                       "state_rtol": s_rtol, "wall_s": layer_s}
            print(f"  JB one mamba layer at jamba's published width (d {wcfg.d_model}, d_inner "
                  f"{wcfg.d_inner}, d_state {wcfg.d_state}, dt_rank 512, bf16 parameters, batch "
                  f"{BATCH}) computed in {tag}: S = {s_scan} (2 chunks) and {s_dec} decode steps "
                  f"in {layer_s:.2f} s against a float64 recurrence: rel err {m_err:.3e} "
                  f"(tolerance {rtol}), ssm state {h_err:.3e} (tolerance {s_rtol})")
            del p_m, got, ys_, y_, st_
        del pm, xm, want_m, h64
        torch.cuda.empty_cache()
        return out

    # ---------------------------------------------------------------- 18
    # The last model families: llama-3.2-vision-11b (path V; its smoke
    # config card = CPU) and musicgen-medium (path A; its smoke config card
    # = CPU), each at its published width.
    def cross_f64(q, k, v):
        """softmax(q k^T / sqrt(Dh)) v over every key, in float64, each kv
        head shared by n_heads / n_kv_heads query heads."""
        r_ = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(r_, dim=2), v.repeat_interleave(r_, dim=2)
        s_ = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, dim=-1), v)

    def step_tokens(params_, c, toks_, n, img_=None, max_len=64):
        """Greedy tokens through ``make_prefill_step`` (with ``img_``) and
        ``n`` steps of ``make_serve_step``: (prefill logits, tokens (B, n +
        1) or an audio config's (B, K, n + 1) as numpy, the cache)."""
        d_ = toks_.device
        cache_ = lm.init_cache(c, toks_.shape[0], max_len, device=d_)
        logits_, cache_ = lm.prefill(params_, toks_, c, cache_, img=img_)
        tok_ = torch.argmax(logits_, dim=-1)[..., None]
        serve = serve_steps.make_serve_step(c)
        out_ = [tok_]
        for i in range(n):
            tok_, cache_ = serve(params_, tok_, cache_, toks_.shape[-1] + i)
            out_.append(tok_)
        return logits_, torch.cat(out_, dim=-1).cpu().numpy(), cache_

    def vlm_audio_phase(report: dict, paths_extra: dict) -> dict:
        out: dict = {}
        rng_ = np.random.default_rng(11)
        f32, f64 = torch.float32, torch.float64
        # a single-rail store's step; a device-mask step below V_min draws the field
        below = lambda store_, v, *a, **kw: ("steps", "steps_below") if \
            platform.fault_rate(float(v)) > 0.0 and store_.mask_source == "device" else "steps"
        rails_below = lambda eng_, volts, *a, **kw: ("rail_steps", "rail_steps_below") if any(
            platform.fault_rate(float(v)) > 0.0 for v in volts.values()) else "rail_steps"

        def record(counts, n_) -> dict:
            by_k = ops.ecc_matmul_launches_by_kernel()
            require(sum(by_k.values()) == counts["ecc_matmul"], f"B3 by kernel {by_k}")
            return {"launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
                    "kv_codec": None, "b3_by_kernel": by_k, "matmuls_per_forward": 0,
                    "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                                 "decode_kernel": n_.get("decode_kernel", 0)},
                    "packs": n_["packs"], "commits": n_["commits"]}

        def gate(params_, seed):
            """Cross gates (drawn as zeros, which make every cross layer the
            identity) set to +-0.45..0.65, tanh near +-0.5."""
            g_ = torch.Generator().manual_seed(seed)
            for j in range(len(params_["blocks"])):
                p_ = params_["blocks"][f"p{j}"]
                for k_ in ("gate_attn", "gate_ffn"):
                    if k_ in p_:
                        mag = 0.45 + 0.2 * torch.rand(p_[k_].shape, generator=g_)
                        sign = torch.where(torch.rand(p_[k_].shape, generator=g_) < 0.5, -1.0, 1.0)
                        p_[k_].copy_(mag * sign)

        def inline_engine(c, params_, **rails):
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    fault_model=FaultModelConfig(mask_source="device"),
                                    rails=RailsConfig(**rails))
            return ServingEngine(c, params_, rel=rel, max_len=64)

        def smoke_card_vs_cpu(label, arch, with_img, tally):
            """The smoke config through an inline engine at 0.56 V with host
            masks on the card and on the CPU (outside the tally): protected
            keys, counters and tokens equal, prefill logits within
            MATMUL_RTOL x max. Returns (its row, fused matmuls a forward)."""
            sc = get_smoke_config(arch)
            sp = lm.init_params(sc, seed=0, device="cpu")
            gate(sp, 5)
            shape = (2, sc.n_codebooks, 8) if sc.n_codebooks else (2, 8)
            s_toks = rng_.integers(0, sc.vocab, shape)
            s_img = (torch.from_numpy(rng_.standard_normal((2, sc.n_img_tokens, sc.d_model))
                                      .astype(np.float32)) if with_img else None)
            res = {}

            def run(d_):
                e_ = ServingEngine(sc, sp, rel=ReliabilityConfig(mode="inline", voltage=1.0),
                                   max_len=32, device=d_)
                e_.set_voltage(0.56)
                lg, tk, _ = step_tokens(e_.params, sc, torch.as_tensor(s_toks, device=d_), 6,
                                        None if s_img is None else s_img.to(d_), max_len=32)
                keys = sorted(k_ for k_, w in base.flatten(e_.params)
                              if isinstance(w, ops.EccWeight))
                res[d_] = (tk, dataclasses.asdict(e_._last_scrub), lg.cpu(), keys)

            with tally.outside():
                run("cpu")
            run("cuda")
            (ct, cs, cl, ck), (gt, gs, gl, gk) = res["cpu"], res["cuda"]
            require(ck == gk and cs == gs and gs["corrected"] > 0,
                    f"{label} smoke: keys / counters card {gk} {gs}, CPU {ck} {cs}")
            require(np.array_equal(ct, gt),
                    f"{label} smoke tokens: the card's differ from the CPU's")
            err, scale = float((gl - cl).abs().max()), float(cl.abs().max())
            require(err <= MATMUL_RTOL * scale,
                    f"{label} smoke logits differ by {err} (max {scale})")
            gates = ", cross gates seeded" if with_img else ""
            print(f"  {label} smoke ({sc.n_layers} layers{gates}) through an inline engine at "
                  f"0.56 V, host masks: {len(gk)} protected leaves, tokens and counters card = "
                  f"CPU, prefill logits within {err:.3e} (max {scale:.3e})")
            return {"protected_leaves": len(gk), "scrub_056": gs, "logit_max_abs_diff": err,
                    "max_abs_logit": scale}, len(gk) * sc.n_groups

        # V: llama-3.2-vision-11b at its published width
        vcfg = get_config("llama-3.2-vision-11b")
        v_prompts = rng_.integers(0, vcfg.vocab, (BATCH, PROMPT_LEN + 1))
        v_toks = torch.as_tensor(v_prompts[:, :PROMPT_LEN], device=dev)
        vt = out["V"] = {}
        ops.reset_launch_count()  # path V
        with Tally() as tally:
            tally._wrap(memory, "decode_read", "reads")
            tally._wrap(memory.EccMemoryDomain, "write", "writes")
            tally._wrap(PlaneStore, "set_voltage", below)
            vt["smoke"], v_smoke_mm = smoke_card_vs_cpu("V", "llama-3.2-vision-11b", True, tally)
            n_smoke = dict(tally.n)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t_ = time.perf_counter()
            vparams = lm.init_params(vcfg, seed=0, device=dev)
            gate(vparams, 6)
            gen = torch.Generator(device=dev).manual_seed(12)
            img = torch.randn(BATCH, vcfg.n_img_tokens, vcfg.d_model, generator=gen,
                              device=dev).to(torch.bfloat16)  # the vision frontend's stand-in
            torch.cuda.synchronize()
            n_par = sum(v_.numel() for _, v_ in base.flatten(vparams))
            require(n_par == V_PARAMS == lm.param_count(vcfg)[0], f"V parameters {n_par}")
            vt["params"], vt["init_s"] = n_par, time.perf_counter() - t_
            print(f"  V llama-3.2-vision-11b at its published width and depth ({vcfg.n_layers} "
                  f"layers in {vcfg.n_groups} periods of {vcfg.period}, p4 cross-attention over "
                  f"{vcfg.n_img_tokens} image tokens, d {vcfg.d_model}, {vcfg.n_heads}/"
                  f"{vcfg.n_kv_heads} heads, d_ff {vcfg.d_ff}, vocab {vcfg.vocab}, bf16): {n_par} "
                  f"parameters ({2 * n_par / 1e9:.2f} GB), drawn in {vt['init_s']:.1f} s; image "
                  f"embeddings {tuple(img.shape)} bf16 from a seeded generator")

            # a. the plain model through the serving steps
            t_ = time.perf_counter()
            logits_, toks_plain, cache_ = step_tokens(vparams, vcfg, v_toks, NEW_TOKENS, img)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t_
            require(bool(torch.isfinite(logits_).all()) and toks_plain.shape == (
                BATCH, NEW_TOKENS + 1) and bool(((toks_plain >= 0) & (toks_plain < vcfg.vocab))
                                                .all()), "V plain tokens")
            kv_bytes = cache_["p4"]["k"].nbytes + cache_["p4"]["v"].nbytes
            require(kv_bytes == V_IMG_KV_BYTES, f"V image K/V cache of {kv_bytes} B")
            pre_step = serve_steps.make_prefill_step(vcfg)
            serve_step = serve_steps.make_serve_step(vcfg)
            tok_ = torch.as_tensor(toks_plain[:, :1], device=dev)
            pre = lambda: pre_step(vparams, v_toks, cache_, img=img)
            dec = lambda: serve_step(vparams, tok_, cache_, PROMPT_LEN)
            va = vt["a"] = {"tokens": BATCH * (NEW_TOKENS + 1), "generate_s": gen_s,
                            "tokens_per_s": BATCH * (NEW_TOKENS + 1) / gen_s,
                            "prefill_wall_ms": min(wall_ms(pre) for _ in range(2)),
                            "decode_wall_ms": min(wall_ms(dec) for _ in range(3)),
                            "image_kv_cache_bytes": kv_bytes}
            evs = device_events(dec)
            if evs:
                va["decode_busy_ms"] = busy_us(evs) / 1e3
                va["decode_idle_share"] = 1.0 - va["decode_busy_ms"] / va["decode_wall_ms"]
            va["peak_gb"] = peak_gb()
            print(f"  V a. plain model: a {BATCH} x {PROMPT_LEN}-token prefill "
                  f"(make_prefill_step, img=) and {NEW_TOKENS} make_serve_step steps: "
                  f"{BATCH * (NEW_TOKENS + 1)} tokens in {gen_s:.2f} s = "
                  f"{va['tokens_per_s']:.1f} tokens/s; prefill wall "
                  f"{va['prefill_wall_ms']:.2f} ms, decode step wall "
                  f"{va['decode_wall_ms']:.2f} ms, traced device busy "
                  f"{va.get('decode_busy_ms', float('nan')):.2f} ms (idle share "
                  f"{va.get('decode_idle_share', float('nan')):.3f}); image K/V cache "
                  f"{kv_bytes} B; peak {va['peak_gb']:.1f} GB")
            # the one-period cut (p0-p3 self-attention, p4 cross), copied so
            # the full model can go
            c5 = dataclasses.replace(vcfg, n_layers=vcfg.period)
            p5 = {**{k_: v_ for k_, v_ in vparams.items() if k_ != "blocks"},
                  "blocks": base.tree_map(lambda t0: t0[:1].clone(), vparams["blocks"])}
            del vparams, cache_, logits_, pre, dec
            torch.cuda.empty_cache()

            # b. float32 on the cut
            c32 = dataclasses.replace(c5, param_dtype=f32, compute_dtype=f32)
            p32 = base.tree_map(lambda t0: t0.to(f32), p5)
            img32 = img.to(f32)
            t33 = torch.as_tensor(v_prompts, device=dev)
            l33, _ = lm.prefill(p32, t33, c32, lm.init_cache(c32, BATCH, 64), img=img32)
            cb = lm.init_cache(c32, BATCH, 64)
            lm.prefill(p32, t33[:, :PROMPT_LEN], c32, cb, img=img32)
            l1, _ = lm.decode_step(p32, t33[:, PROMPT_LEN:], c32, cb, PROMPT_LEN)
            step_err, step_scale = float((l33 - l1).abs().max()), float(l33.abs().max())
            require(bool(torch.isfinite(l33).all()) and step_err <= RW_STEP_RTOL * step_scale,
                    f"V float32: prefill({PROMPT_LEN + 1}) differs from prefill({PROMPT_LEN}) + a "
                    f"decode step by {step_err} (max |logits| {step_scale})")
            p4 = lm._layer(p32["blocks"]["p4"], 0)
            ck, cv = cb["p4"]["k"][0], cb["p4"]["v"][0]
            xg = torch.randn(BATCH, PROMPT_LEN, c32.d_model, generator=gen, device=dev)
            hq = layers.apply_norm(xg, p4["ln1"], c32.norm_type)
            q = (hq @ p4["attn"]["wq"]).reshape(BATCH, PROMPT_LEN, c32.n_heads, c32.hd)
            att = lm.cross_attention(q, ck, cv)
            lanes_equal = all(torch.equal(lm.cross_attention(q[b:b + 1], ck[b:b + 1], cv[b:b + 1]),
                                          att[b:b + 1]) for b in range(BATCH))
            rows_equal = torch.equal(lm.cross_attention(q[:, -1:], ck, cv), att[:, -1:])
            require(lanes_equal and rows_equal, "V: the cross attention over the image keys is "
                    "not batch-invariant (a lane alone, or a decode row, differs)")
            want = cross_f64(q.to(f64), ck.to(f64), cv.to(f64))
            att_err = float((att.to(f64) - want).abs().max() / want.abs().max())
            require(att_err <= F64_RTOL, f"V p4 cross attention against float64: {att_err}")
            p0g = {**p4, "gate_attn": torch.zeros_like(p4["gate_attn"]),
                   "gate_ffn": torch.zeros_like(p4["gate_ffn"])}
            cz = lm.init_cache(c32, BATCH, 64)["p4"]
            require(torch.equal(lm._cross_block(xg, p0g, c32, cache=cz, g=0, img=img32,
                                                prefill=True), xg),
                    "V: with both gates 0 the cross layer does not return its input")
            vt["b"] = {"step_max_abs_diff": step_err, "max_abs_logit": step_scale,
                       "step_rtol": RW_STEP_RTOL, "cross_attention_rel_err": att_err,
                       "f64_rtol": F64_RTOL, "lanes_bit_equal": lanes_equal,
                       "decode_row_bit_equal": rows_equal}
            print(f"  V b. float32 on the one-period cut ({c5.n_layers} layers: p0-p3 self, p4 "
                  f"cross): prefill({PROMPT_LEN + 1}) = prefill({PROMPT_LEN}) + a decode step "
                  f"within {step_err:.3e} (max |logits| {step_scale:.3e}, tolerance "
                  f"{RW_STEP_RTOL} x max); p4's cross attention over {vcfg.n_img_tokens} keys: "
                  f"each lane alone and a one-query call = the batch bit for bit, against a "
                  f"float64 softmax(QK^T/sqrt(Dh))V rel err {att_err:.3e} (tolerance "
                  f"{F64_RTOL}); gates 0: the layer returns its input bit for bit")
            del p32, img32, l33, l1, cb, cz, p4, p0g, ck, cv, q, att, want, xg, hq
            torch.cuda.empty_cache()

            # c. domain mode on the cut
            _, toks_cut, _ = step_tokens(p5, c5, v_toks, NEW_TOKENS, img)
            t_ = time.perf_counter()
            deng = ServingEngine(c5, p5, rel=ReliabilityConfig(mode="domain", voltage=1.0),
                                 max_len=64)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t_
            words = sum(deng.domain.entry(k_).n_words for k_ in deng.domain.names())
            require(words == V_CUT_WORDS, f"V domain words {words}")
            require(all(same_bits(a_, b_) for (_, a_), (_, b_) in
                        zip(base.flatten(deng.params), base.flatten(p5))),
                    "V domain mode's nominal read-back differs from the params it wrote")
            _, toks_dom, _ = step_tokens(deng.params, c5, v_toks, NEW_TOKENS, img)
            require(np.array_equal(toks_dom, toks_cut), "V domain mode at nominal: tokens differ "
                    "from the plain model's on the cut")
            vt["c"] = {"arrays": len(deng.domain.names()), "words": words,
                       "write_and_read_s": build_s}
            del deng
            torch.cuda.empty_cache()
            print(f"  V c. domain mode on the cut: {vt['c']['arrays']} arrays, {words} raw words "
                  f"written (B4) and read at nominal (B7 + B5) in {build_s:.1f} s, the read-back "
                  f"= the params bit for bit, tokens with img = the plain cut's")

            # d. the inline single-rail engine on the cut: its rail steps,
            # then the forward refused before any fused matmul
            ieng = inline_engine(c5, p5)
            require(ieng._store.n_words == V_CUT_INLINE_WORDS,
                    f"V inline arena of {ieng._store.n_words} words")
            require(isinstance(ieng.params["blocks"]["p4"]["attn"]["wk"], ops.EccWeight),
                    "V: the cross wk is not protected at the published width")
            ieng.set_voltage(0.56)
            scrub = ieng._last_scrub
            require(scrub.corrected > 0, f"V 0.56 V step {scrub}")
            before = ops.launch_counts()
            refused = None
            with tally.outside():
                try:
                    lm.prefill(ieng.params, v_toks, c5, lm.init_cache(c5, BATCH, 64), img=img)
                except ValueError as e:
                    refused = str(e)
            require(refused is not None and "blocks.p4.attn.wk" in refused
                    and ops.launch_counts() == before,
                    f"V inline prefill: {refused!r}, launches {ops.launch_counts()} (before "
                    f"{before})")
            vt["d"] = {"protected_words": ieng._store.n_words, "scrub_056": scrub.to_dict(),
                       "refusal": refused}
            del ieng, p5, img
            torch.cuda.empty_cache()
            print(f"  V d. inline single-rail engine on the cut, device masks: "
                  f"{V_CUT_INLINE_WORDS} protected words (the cross wk / wv among them); 0.56 V "
                  f"step {json.dumps(vt['d']['scrub_056'])}; prefill refused before any launch: "
                  f"{refused}")
            counts, n_ = ops.launch_counts(), dict(tally.n)
        want = dict.fromkeys(counts, 0)
        want.update(encode=n_["writes"] + n_["packs"], inject=n_["reads"], decode=n_["reads"],
                    inject_scrub=n_["steps"], fault_field=n_.get("steps_below", 0),
                    ecc_matmul=v_smoke_mm * (n_smoke["prefill"] + n_smoke["decode"]))
        require(counts == want and n_["plain_on_card"] == 0
                and n_["prefill"] + n_["decode"] == n_smoke["prefill"] + n_smoke["decode"],
                f"V launches {counts}, expected {want} (tally {n_})")
        paths_extra["V"] = record(counts, n_)
        vt["launches"], vt["peak_gb"] = counts, peak_gb()
        print(f"  V launches: {json.dumps(counts)} = {n_['writes']} domain writes + {n_['packs']} "
              f"packs, {n_['reads']} domain reads, {n_['steps']} rail steps "
              f"({n_.get('steps_below', 0)} below V_min), the smoke engine's "
              f"{v_smoke_mm} fused matmuls a forward; peak {vt['peak_gb']:.1f} GB")

        # A: musicgen-medium at its published width and depth
        acfg = get_config("musicgen-medium")
        kb = acfg.n_codebooks
        at = out["A"] = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        aparams = lm.init_params(acfg, seed=0, device=dev)
        n_par = sum(v_.numel() for _, v_ in base.flatten(aparams))
        require(n_par == A_PARAMS == lm.param_count(acfg)[0], f"A parameters {n_par}")
        a_prompts = rng_.integers(0, acfg.vocab, (BATCH, kb, PROMPT_LEN + 1))
        a_toks = torch.as_tensor(a_prompts[..., :PROMPT_LEN], device=dev)
        print(f"  A musicgen-medium at its published width and depth ({acfg.n_layers} layers, d "
              f"{acfg.d_model}, {acfg.n_heads}/{acfg.n_kv_heads} heads of {acfg.hd}, d_ff "
              f"{acfg.d_ff} non-gated gelu, LayerNorm, {kb} codebooks of {acfg.vocab}, bf16): "
              f"{n_par} parameters ({2 * n_par / 1e9:.2f} GB); tokens {tuple(a_toks.shape)}")

        # a. B3 at its three (K, N) against the plain version, and the
        # traced kernel split, on an engine of its own at 0.56 V
        require(b3_split(acfg, BATCH) == {"decode": 288, "tiled": 0}
                and b3_split(acfg, BATCH * PROMPT_LEN) == {"decode": 0, "tiled": 288},
                f"musicgen-medium B3 split {b3_split(acfg, BATCH)}")
        eng = inline_engine(acfg, aparams)
        eng.set_voltage(0.56)
        leaves = {k.split("[")[-1].strip("']"): w for k, w in base.flatten(eng.params)
                  if isinstance(w, ops.EccWeight)}
        require(sorted(leaves) == ["w1", "w2", "wk", "wo", "wq", "wv"],
                f"musicgen-medium protected leaves {sorted(leaves)}")
        b3_rows = b3_shape_rows("musicgen-medium", leaves, acfg.n_groups)
        at["b3"] = b3_rows
        at["b3_traced"] = b3_traced("musicgen-medium", eng.params, acfg, a_toks.cpu().numpy())
        report["ecc_matmul_decode"]["musicgen_medium"] = [
            r for r in b3_rows if r["function"] == b3_names["decode"]]
        report["ecc_matmul_prefill"]["musicgen_medium"] = [
            r for r in b3_rows if r["function"] == b3_names["tiled"]]
        del eng, leaves
        torch.cuda.empty_cache()

        # b. float32 at full width and depth: the sinusoid swap and RoPE of
        # a decode step against a longer prefill
        c32 = dataclasses.replace(acfg, param_dtype=f32, compute_dtype=f32)
        p32 = base.tree_map(lambda t0: t0.to(f32), aparams)
        t33 = torch.as_tensor(a_prompts, device=dev)
        l33, _ = lm.prefill(p32, t33, c32, lm.init_cache(c32, BATCH, 64))
        cb = lm.init_cache(c32, BATCH, 64)
        lm.prefill(p32, t33[..., :PROMPT_LEN], c32, cb)
        l1, _ = lm.decode_step(p32, t33[..., PROMPT_LEN:], c32, cb, PROMPT_LEN)
        step_err, step_scale = float((l33 - l1).abs().max()), float(l33.abs().max())
        require(tuple(l33.shape) == (BATCH, kb, acfg.vocab) and bool(torch.isfinite(l33).all())
                and step_err <= RW_STEP_RTOL * step_scale,
                f"A float32: prefill({PROMPT_LEN + 1}) differs from prefill({PROMPT_LEN}) + a "
                f"decode step by {step_err} (max |logits| {step_scale})")
        at["b"] = {"step_max_abs_diff": step_err, "max_abs_logit": step_scale,
                   "step_rtol": RW_STEP_RTOL}
        del p32, l33, l1, cb
        torch.cuda.empty_cache()
        print(f"  A b. float32, all {acfg.n_layers} layers: prefill({PROMPT_LEN + 1})'s last "
              f"(B, K, V) logits = prefill({PROMPT_LEN}) + a decode step (sinusoid swap and "
              f"RoPE) within {step_err:.3e} (max |logits| {step_scale:.3e}, tolerance "
              f"{RW_STEP_RTOL} x max)")

        ops.reset_launch_count()  # path A
        with Tally() as tally:
            tally._wrap(PlaneStore, "set_voltage", below)
            tally._wrap(ServingEngine, "set_rails", rails_below)
            at["smoke"], a_smoke_mm = smoke_card_vs_cpu("A", "musicgen-medium", False, tally)
            n_smoke = dict(tally.n)
            # c. the inline single-rail engine: generate through the serving
            # steps at nominal and 0.56 V, then the walk from 0.62 V
            t_ = time.perf_counter()
            eng = inline_engine(acfg, aparams, start_v=0.62)
            torch.cuda.synchronize()
            require(eng._store.n_words == A_WORDS, f"A arena of {eng._store.n_words} words")
            ac = at["c"] = {"protected_words": A_WORDS, "build_s": time.perf_counter() - t_}
            for v in (1.0, 0.56):
                eng.set_voltage(v)
                t_ = time.perf_counter()
                _, tk, _ = step_tokens(eng.params, acfg, a_toks, NEW_TOKENS)
                torch.cuda.synchronize()
                s_ = time.perf_counter() - t_
                require(tk.shape == (BATCH, kb, NEW_TOKENS + 1)
                        and bool(((tk >= 0) & (tk < acfg.vocab)).all()), f"A tokens at {v} V")
                ac[f"{v}V"] = {"generate_s": s_, "tokens_per_s": BATCH * (NEW_TOKENS + 1) / s_,
                               "scrub": eng._last_scrub.to_dict()}
                ac.setdefault("tokens", []).append(tk)
            ac["agreement_056_with_nominal"] = float((ac["tokens"][0] == ac["tokens"][1]).mean())
            del ac["tokens"]
            eng.set_voltage(0.62)
            t_ = time.perf_counter()
            lock, hist = eng.autotune_voltage()
            torch.cuda.synchronize()
            require(eng.controller.locked, "A walk did not lock")
            ac["walk"] = {"walk_s": time.perf_counter() - t_, "lock": lock,
                          "power_w": eng.power_w(),
                          "saving_vs_nominal": eng.power_report()["saving_vs_nominal"],
                          "history": [(r.voltage, r.corrected, r.detected, r.action)
                                      for r in hist]}
            del eng
            torch.cuda.empty_cache()
            print(f"  A c. inline single-rail engine, device masks, {A_WORDS} protected words: "
                  f"prefill + {NEW_TOKENS} make_serve_step steps of (B, K, 1) tokens at nominal "
                  f"{ac['1.0V']['tokens_per_s']:.1f} tokens/s, at 0.56 V "
                  f"{ac['0.56V']['tokens_per_s']:.1f} tokens/s (agreement "
                  f"{ac['agreement_056_with_nominal']:.4f}, scrub "
                  f"{json.dumps(ac['0.56V']['scrub'])}); the DED-canary walk from 0.62 V locks at "
                  f"{lock:.2f} V in {len(hist)} rounds ({ac['walk']['walk_s']:.1f} s), "
                  f"{ac['walk']['power_w']:.4f} W (saving {ac['walk']['saving_vs_nominal']:.4f})")

            # d. multi-rail: the codebook tables on the embedding rail
            meng = inline_engine(acfg, aparams, multi_rail=True, start_v=0.62)
            emb_words = sum(s_.size for s_ in meng._store.slots if s_.domain == "embedding")
            require(emb_words == A_EMBED_WORDS and meng._store.n_words == A_WORDS + A_EMBED_WORDS,
                    f"A multi-rail embedding of {emb_words} words")
            before = dict(ops.launch_counts())
            meng.set_rails({d: 0.56 for d in meng._store.domains})
            step = {k_: ops.launch_counts()[k_] - before[k_] for k_ in before}
            require(step["inject_scrub_domains"] == 1 and step["decode"] == 1,
                    f"A multi-rail step launches {step}")
            require(tuple(meng.params["embed"].shape) == (kb, acfg.vocab, acfg.d_model),
                    "A multi-rail embedding table")
            locks, mhist = meng.autotune_voltage()
            require(meng.controller.locked, "A multi-rail walk did not lock")
            at["d"] = {"embedding_words": emb_words, "step_launches": step, "locks": locks,
                       "power_report": meng.power_report(),
                       "history": {d: [(r.voltage, r.corrected, r.detected, r.action) for r in h]
                                   for d, h in mhist.items()}}
            del meng
            torch.cuda.empty_cache()
            print(f"  A d. multi-rail engine, the {kb} codebook tables on the embedding rail "
                  f"({emb_words} words): a rail step launches B2 once and B5 once; walk from "
                  f"0.62 V, locks {json.dumps(locks)}, modelled power "
                  f"{at['d']['power_report']['total_w']:.4f} W")
            counts, n_ = ops.launch_counts(), dict(tally.n)
        per_fwd = len(protected(acfg)) * acfg.n_layers
        require(per_fwd == 288, f"A: {per_fwd} protected matmuls a forward")
        fwd_smoke = n_smoke["prefill"] + n_smoke["decode"]
        want = dict.fromkeys(counts, 0)
        want.update(inject_scrub=n_["steps"], inject_scrub_domains=n_.get("rail_steps", 0),
                    decode=n_.get("rail_steps", 0), encode=n_["packs"],
                    fault_field=n_.get("steps_below", 0) + n_.get("rail_steps_below", 0),
                    ecc_matmul=a_smoke_mm * fwd_smoke
                    + per_fwd * (n_["prefill"] + n_["decode"] - fwd_smoke))
        require(counts == want and n_["plain_on_card"] == 0,
                f"A launches {counts}, expected {want} (tally {n_})")
        paths_extra["A"] = record(counts, n_)
        at["launches"], at["peak_gb"] = counts, peak_gb()
        print(f"  A launches: {json.dumps(counts)} = {n_['steps']} single-rail steps + "
              f"{n_['rail_steps']} rail steps ({n_.get('steps_below', 0)} + "
              f"{n_.get('rail_steps_below', 0)} below V_min), {per_fwd} fused matmuls x "
              f"{n_['prefill'] + n_['decode'] - fwd_smoke} full-width forwards, {n_['packs']} "
              f"packs; peak {at['peak_gb']:.1f} GB")
        del aparams
        torch.cuda.empty_cache()
        return out

    # ---------------------------------------------------------------- 14
    # The accuracy canary on qwen2-7b at full width (path Q), the accuracy
    # campaign at qwen3-0.6b's (path CA) and the sweeps (path SW).
    def accuracy_phase(report: dict, paths_extra: dict) -> dict:
        from repro_torch.core import campaign, sweep
        from repro_torch.serving.engine import CanaryConfig

        acc: dict = {}
        qcfg = get_config("qwen2-7b")
        v_min = platform.v_min
        torch.cuda.reset_peak_memory_stats()

        def q_params():
            """Random qwen2-7b weights from seed 0 with seeded nonzero biases
            (``init_params`` draws them as zeros)."""
            p = lm.init_params(qcfg, seed=0, device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            for b in ("bq", "bk", "bv"):
                t_ = p["blocks"]["p0"]["attn"][b]
                t_.copy_(0.5 * torch.randn(t_.shape, generator=gen, device=dev))
            return p

        def q_engine(**kw):
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    fault_model=FaultModelConfig(mask_source="device"),
                                    rails=RailsConfig(start_v=v_min), **kw)
            t_ = time.perf_counter()
            eng_ = ServingEngine(qcfg, q_params(), rel=rel, max_len=64)
            torch.cuda.synchronize()
            return eng_, time.perf_counter() - t_

        # a. qwen2-7b: B3 at its four (K, N) and B4's pack of the whole arena
        # against the plain versions, on an engine of its own (these launches
        # are no part of path Q)
        eng, build_s = q_engine()
        n_q = eng._store.n_words
        require(n_q == qcfg.n_layers * sum(k_ * n_ for k_, n_ in protected(qcfg)) // 8,
                f"qwen2-7b arena of {n_q} words")
        print(f"  qwen2-7b ({qcfg.n_layers} layers, d {qcfg.d_model}, {qcfg.n_heads}/"
              f"{qcfg.n_kv_heads} heads, d_ff {qcfg.d_ff}, vocab {qcfg.vocab}, bf16, untied, "
              f"biases N(0, 0.5^2) from seed 1): {n_q} protected words, engine built in "
              f"{build_s:.1f} s, peak {peak_gb():.1f} GB")
        store = eng._store
        k_chk = ops.encode(store.lo, store.hi)
        require(torch.equal(k_chk, store.parity), "B4 over the arena differs from the packs")
        chunk = 1 << 27
        t = time.perf_counter()
        for a in range(0, n_q, chunk):
            p_chk = ref.encode_ref(store.lo[a:a + chunk], store.hi[a:a + chunk])
            require(torch.equal(k_chk[a:a + chunk], p_chk), f"B4 differs at words {a}+")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        del k_chk, p_chk
        acc["encode_arena"] = {"n_words": n_q, "ms": sync_ms(lambda: ops.encode(store.lo, store.hi),
                                                              10),
                               "plain_ms": 1e3 * plain_s, "bound_ms": 1e3 * 9 * n_q / HBM_BYTES_PER_S}
        print(f"  B4 over the qwen2-7b arena ({n_q} words): bit-identical to the plain version "
              f"and to the packed check planes, {acc['encode_arena']['ms']:.3f} ms, bound "
              f"{acc['encode_arena']['bound_ms']:.3f} ms (bytes), plain "
              f"{acc['encode_arena']['plain_ms']:.1f} ms ({-(-n_q // chunk)} pieces)")
        eng.set_voltage(0.56)
        require(eng._last_scrub.corrected > 0, f"qwen2-7b 0.56 V scrub {eng._last_scrub}")
        leaves = {k.split("[")[-1].strip("']"): w for k, w in base.flatten(eng.params)
                  if isinstance(w, ops.EccWeight)}
        n_leaves = len(leaves)
        b3_rows = b3_shape_rows("qwen2-7b", leaves, qcfg.n_groups)
        rng_ = np.random.default_rng(0)
        q_prompts = rng_.integers(0, qcfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
        acc["b3_traced"] = b3_traced("qwen2-7b", eng.params, qcfg, q_prompts)
        acc["b3"] = b3_rows
        report["ecc_matmul_decode"]["qwen2_7b"] = [
            r for r in b3_rows if r["function"] == b3_names["decode"]]
        report["ecc_matmul_prefill"]["qwen2_7b"] = [
            r for r in b3_rows if r["function"] == b3_names["tiled"]]
        del eng, store, leaves
        torch.cuda.empty_cache()

        # path Q: every engine build, voltage step, rollout and walk counts
        q = acc["Q"] = {}
        ops.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        below = lambda eng_, v, *a, **kw: ("steps", "steps_below") if \
            platform.fault_rate(float(v)) > 0.0 else "steps"
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_voltage", below)
            canary = CanaryConfig(prompts=2, tokens=12, divergence_slo=0.05)
            eng, q["build_s"] = q_engine(canary=canary)
            t = time.perf_counter()
            toks = eng.generate(q_prompts, NEW_TOKENS)
            q["generate_s"] = time.perf_counter() - t
            q["tokens_per_s"] = BATCH * NEW_TOKENS / q["generate_s"]
            require(toks.shape == (BATCH, NEW_TOKENS)
                    and bool(((toks >= 0) & (toks < qcfg.vocab)).all()), "qwen2-7b tokens")
            seq = torch.as_tensor(np.concatenate([q_prompts, toks], axis=1), device=dev)
            sl = lm.sequence_logits(eng.params, seq, qcfg)
            pl, _ = lm.prefill(eng.params, seq, qcfg, lm.init_cache(qcfg, BATCH, 64))
            require(tuple(sl.shape) == (BATCH, PROMPT_LEN + NEW_TOKENS, qcfg.vocab)
                    and bool(torch.isfinite(sl).all()), "sequence_logits shape or values")
            require(torch.equal(sl[:, -1], pl), "sequence_logits' last position differs "
                    "from prefill's logits")
            del sl, pl
            t = time.perf_counter()
            d0 = eng.canary_divergence()
            q["canary_nominal_s"] = time.perf_counter() - t
            require(d0 == 0.0, f"canary divergence at nominal {d0}")
            print(f"  Q: generate {BATCH} x {PROMPT_LEN} -> {NEW_TOKENS} tokens in "
                  f"{q['generate_s']:.2f} s = {q['tokens_per_s']:.1f} tokens/s; "
                  f"sequence_logits ({BATCH} x {PROMPT_LEN + NEW_TOKENS}): last position = "
                  f"prefill's logits bit for bit; canary divergence at nominal 0.0 "
                  f"(clean rollout + probe {q['canary_nominal_s']:.2f} s)")
            walks = q["walks"] = {}

            def walk(name, eng_, build_s_):
                t_ = time.perf_counter()
                lock_, hist_ = eng_.autotune_voltage(max_rounds=16)
                torch.cuda.synchronize()
                walks[name] = {
                    "build_s": build_s_, "walk_s": time.perf_counter() - t_, "lock": lock_,
                    "locked": eng_.controller.locked, "power_w": eng_.power_w(),
                    "saving_vs_nominal": eng_.power_report()["saving_vs_nominal"],
                    "history": [(r.voltage, r.corrected, r.detected, r.action,
                                 round(r.divergence, 6)) for r in hist_]}
                print(f"  Q walk {name}: lock {lock_:.2f} V in {len(hist_)} rounds, "
                      f"{walks[name]['walk_s']:.1f} s, {walks[name]['power_w']:.4f} W; "
                      f"history {json.dumps(walks[name]['history'])}")
                return hist_

            hist_ecc = walk("ecc+canary", eng, q["build_s"])
            q["ecc_lock_signal"] = hist_ecc[-1].action
            print(f"  Q: with ECC and the canary the walk locked on {hist_ecc[-1].action} "
                  f"(detected {hist_ecc[-1].detected}, divergence {hist_ecc[-1].divergence})")
            del eng
            torch.cuda.empty_cache()
            eng, b_s = q_engine(ecc=False)
            hist_ctl = walk("blind", eng, b_s)
            del eng
            torch.cuda.empty_cache()
            eng, b_s = q_engine(ecc=False, canary=canary)
            hist_can = walk("blind+canary", eng, b_s)
            del eng
            torch.cuda.empty_cache()
        require(all(h.detected == 0 for h in hist_ctl) and hist_ctl[-1].action == "floor"
                and not any("backoff" in h.action for h in hist_ctl),
                "the blind walk without a canary must descend to the floor with no DED")
        require(all(h.detected == 0 for h in hist_can)
                and any(h.action == "acc+backoff" for h in hist_can),
                "the blind walk with the canary must back off on divergence alone")
        require(walks["blind+canary"]["locked"]
                and walks["blind+canary"]["lock"] > walks["blind"]["lock"] + 1e-9,
                f"canary lock {walks['blind+canary']['lock']} not above the blind lock "
                f"{walks['blind']['lock']}")
        q["peak_gb"] = peak_gb()
        counts, n_ = ops.launch_counts(), tally.n
        per_fwd = len(protected(qcfg)) * qcfg.n_layers
        require(per_fwd == n_leaves * qcfg.n_layers,
                f"{per_fwd} protected matmuls per forward, {n_leaves} protected leaves")
        want = {"inject_scrub": n_["steps"], "inject_scrub_domains": 0, "decode": 0,
                "ecc_matmul": per_fwd * (n_["prefill"] + n_["decode"]),
                "encode": n_["packs"], "gather_scrub": 0, "inject": 0,
                "fault_field": n_.get("steps_below", 0)}
        require(counts == want, f"Q launches {counts}, expected {want}")
        require(n_["packs"] == 3 * per_fwd, f"Q: {n_['packs']} weight packs")
        require(n_["plain_on_card"] == 0, "the plain codec ran on the card")
        # w2's K = 18,944 takes the tiled kernel at every M
        by_k = b3_by_kernel_check("Q", tally, counts, qcfg)
        paths_extra["Q"] = {
            "launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
            "kv_codec": None, "matmuls_per_forward": per_fwd, "b3_by_kernel": by_k,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_.get("decode_kernel", 0)},
            "packs": n_["packs"], "commits": 0, "voltage_steps": n_["steps"]}
        q["launches"], q["b3_by_kernel"] = counts, by_k
        print(f"  Q launches: {json.dumps(counts)} = {n_['steps']} voltage steps "
              f"({n_.get('steps_below', 0)} below V_min, one field launch each), {per_fwd} fused "
              f"matmuls x ({n_['prefill']} prefill + {n_['decode']} decode forwards), by kernel "
              f"{json.dumps(by_k)}, {n_['packs']} weight packs; peak {q['peak_gb']:.1f} GB")

        # b. the campaign at qwen3-0.6b's full width (host masks)
        spec = campaign.CampaignSpec(model="qwen3-0.6b", codecs=("parity65", "secded72",
                                                                "ileave88"),
                                     voltages=CA_VOLTAGES, n_prompts=4, prompt_len=8,
                                     n_tokens=24, proxy_words=1 << 16)
        ops.reset_launch_count()
        sweep.reset_dispatch_count()
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_voltage", below)
            tally._wrap(sweep, "_classify", "classify")
            t = time.perf_counter()
            rows = campaign.run_campaign(spec)
            torch.cuda.synchronize()
            ca_s = time.perf_counter() - t
        contract = ("model", "arch", "platform", "codec", "voltage", "nominal", "divergence",
                    "match_len", "kl", "ppl_delta", "scorer_version", "detected", "faulty_words",
                    "bram_saving_vs_nominal", "seed", "proxy_words", "proxy_faulty_words")
        require(len(rows) == len(spec.codecs) * len(CA_VOLTAGES)
                and all(all(c in r for c in contract) for r in rows),
                "campaign rows or their columns")
        for codec in spec.codecs:
            by_v = [r for r in rows if r["codec"] == codec]
            nom = by_v[0]
            require(nom["nominal"] and nom["divergence"] == 0.0 and nom["kl"] == 0.0
                    and nom["ppl_delta"] == 0.0 and nom["faulty_words"] == 0,
                    f"campaign {codec}: the nominal row is not clean {nom}")
            fw = [r["faulty_words"] for r in by_v]
            require(all(a < b for a, b in zip(fw, fw[1:])), f"campaign {codec}: faulty words "
                    f"{fw}")
        for r in rows:
            print(f"  CA {r['codec']} {r['voltage']:.2f} V: divergence {r['divergence']:.4f}, "
                  f"match {r['match_len']:.2f}/{r['n_tokens']}, kl {r['kl']:.4e}, ppl "
                  f"{r['ppl_clean']:.2f} -> {r['ppl_faulty']:.2f}, corrected {r['corrected']}, "
                  f"detected {r['detected']}, silent {r['silent']}, faulty words "
                  f"{r['faulty_words']} (proxy {r['proxy_faulty_words']} of "
                  f"{r['proxy_words']}), BRAM saving {r['bram_saving_vs_nominal']:.4f}, "
                  f"{r['us'] / 1e6:.2f} s")
        counts, n_ = ops.launch_counts(), tally.n
        per_fwd = len(protected(cfg)) * cfg.n_layers
        require(counts["inject_scrub"] == n_["steps"] + n_["classify"]
                and counts["fault_field"] == sweep.dispatch_count()
                and counts["ecc_matmul"] == per_fwd * (n_["prefill"] + n_["decode"])
                and counts["encode"] >= n_["packs"] and counts["gather_scrub"] == 0
                and counts["inject"] == 0 and counts["inject_scrub_domains"] == 0,
                f"CA launches {counts}: {n_['steps']} steps, {n_['classify']} proxy points, "
                f"{sweep.dispatch_count()} proxy draws, {n_['prefill']} + {n_['decode']} forwards")
        require(n_["plain_on_card"] == 0, "the plain codec ran on the card")
        by_k = b3_by_kernel_check("CA", tally, counts, cfg)
        paths_extra["CA"] = {
            "launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
            "kv_codec": None, "matmuls_per_forward": per_fwd, "b3_by_kernel": by_k,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_.get("decode_kernel", 0)},
            "packs": n_["packs"], "commits": 0, "voltage_steps": n_["steps"]}
        acc["CA"] = {"wall_s": ca_s, "rows": rows, "launches": counts}
        print(f"  CA: {len(rows)} rows in {ca_s:.1f} s; launches {json.dumps(counts)} = "
              f"{n_['steps']} engine steps + {n_['classify']} proxy points "
              f"({sweep.dispatch_count()} field draws), {n_['prefill']} + {n_['decode']} "
              f"forwards, by kernel {json.dumps(by_k)}")

        # c. the sweeps, then the same points by the per-point loop and the
        # schedules by a device-mask store (comparisons, not path SW)
        params_ = lm.init_params(cfg, seed=0, device=dev)
        clean_, _ = protect_params_inline(params_, cfg, include_embed=True)
        eccs_ = [(k, w) for k, w in base.flatten(clean_) if isinstance(w, ops.EccWeight)]
        mstore = PlaneStore([w for _, w in eccs_], [k for k, _ in eccs_], platform,
                            mask_source="device", domain_key=shapes.domain_of, device=dev)
        del params_, clean_, eccs_
        schedules = [dict(MIXED_RAILS), {d: 0.55 for d in mstore.domains}]
        profiles = {d: mstore.domain_profile(d) for d in mstore.domains}
        main_out = io.StringIO()  # the CLI's JSON rows, written to stdout
        crash = [(platform, platform.v_crash)]
        ops.reset_launch_count()
        sweep.reset_dispatch_count()
        with Tally() as tally:
            tally._wrap(sweep, "_classify", lambda masks, codec, dom_ids=None, n_domains=1:
                        "classify" if dom_ids is None else "classify_domains")
            t = time.perf_counter()
            with contextlib.redirect_stdout(main_out):
                sweep.main([])
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t
            t = time.perf_counter()
            sched = sweep.sweep_rail_schedules(schedules, mstore.domains, mstore.dom_ids,
                                               profiles, seed=mstore.seed)
            torch.cuda.synchronize()
            sched_s = time.perf_counter() - t
            t = time.perf_counter()
            schemes = sweep.sweep_codec_schemes(codes.names(), crash, 1 << 19)
            torch.cuda.synchronize()
            schemes_s = time.perf_counter() - t
        counts, n_ = ops.launch_counts(), tally.n
        draws = sweep.dispatch_count()
        grid = sweep.paper_grid()
        main_rows = json.loads(main_out.getvalue())
        require(len(main_rows) == len(grid) and all(r["words"] == 512 * 1024 for r in main_rows),
                "sweep main rows")
        want = {"inject_scrub": n_["classify"],
                "inject_scrub_domains": n_["classify_domains"]
                * -(-mstore.n_words // sweep.CLASSIFY_WORDS),
                "decode": 0, "ecc_matmul": 0, "encode": 0, "gather_scrub": 0, "inject": 0,
                "fault_field": draws}
        require(counts == want, f"SW launches {counts}, expected {want}")
        require(n_["classify"] == len(grid) + len(codes.names())
                and n_["classify_domains"] == len(schedules), f"SW classify calls {n_}")
        paths_extra["SW"] = {
            "launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
            "kv_codec": None, "matmuls_per_forward": 0, "b3_by_kernel": {"decode": 0, "tiled": 0},
            "forwards": {"prefill": 0, "decode": 0, "decode_kernel": 0},
            "packs": 0, "commits": 0, "voltage_steps": 0}
        # every main row equals the per-point loop on the device field and B1
        fields_, loop_rows = {}, []
        zeros = faultsim.zero_masks(512 * 1024, 8, dev)
        for p_, v_ in grid:
            f_ = fields_.setdefault(p_.name, faultsim.DeviceFaultField(p_, 512 * 1024, seed=0))
            c_ = ops.inject_scrub(*zeros, *f_.masks(v_))[3].cpu().numpy()
            loop_rows.append(FaultStats.from_counters(c_, 512 * 1024).coverage_row())
        require([{k: r[k] for k in lr} for r, lr in zip(main_rows, loop_rows)] == loop_rows,
                "a sweep point differs from the per-point device field + inject_scrub loop")
        # the schedules equal the store's own device-path telemetry
        for s_, got in zip(schedules, sched):
            _, want_st = mstore.set_rails(s_)
            require({d: st.to_dict() for d, st in got.by_domain.items()}
                    == {d: st.to_dict() for d, st in want_st.by_domain.items()},
                    f"sweep_rail_schedules differs from the store at {s_}")
        cov = {r["codec"]: r["coverage_correctable"] for r in schemes}
        require(cov["parity65"] < cov["secded72"] < min(cov["ileave88"], cov["dected79"]),
                f"coverage at V_crash {cov}")
        deepest = {p_.name: max((r for r in main_rows if r["platform"] == p_.name),
                                key=lambda r: r["faulty_bits"]) for p_, _ in grid}
        acc["SW"] = {"main_s": main_s, "schedules_s": sched_s, "schemes_s": schemes_s,
                     "points": len(grid), "draws": draws, "launches": counts,
                     "schedules": [{d: st.to_dict() for d, st in g.by_domain.items()}
                                   for g in sched],
                     "schemes": schemes,
                     "deepest": {k: {c: r[c] for c in ("voltage", "faulty_bits", "corrected",
                                                       "detected", "silent")}
                                 for k, r in deepest.items()}}
        print(f"  SW main: {len(grid)} points of the paper grid over 512 Ki words in "
              f"{main_s:.2f} s ({draws} field draws in all), each equal to the per-point "
              f"device field + inject_scrub loop; deepest per platform "
              f"{json.dumps(acc['SW']['deepest'])}")
        print(f"  SW schedules on the multi-rail store ({mstore.n_words} words) in "
              f"{sched_s:.3f} s: equal to the store's device-path telemetry; "
              f"{json.dumps(acc['SW']['schedules'][0])}")
        print(f"  SW codec schemes at V_crash {platform.v_crash} V over 512 Ki words in "
              f"{schemes_s:.3f} s: correctable coverage {json.dumps(cov)}")
        print(f"  SW launches: {json.dumps(counts)}")
        del mstore, zeros, fields_
        torch.cuda.empty_cache()
        return acc

    # ---------------------------------------------------------------- 2
    with Phase("2 kernels vs plain versions at main-path shapes"):
        params = lm.init_params(cfg, seed=0, device=dev)
        clean, _ = protect_params_inline(params, cfg)
        flat = base.flatten(clean)
        eccs = [(k, w) for k, w in flat if isinstance(w, ops.EccWeight)]
        store = PlaneStore([w for _, w in eccs], [k for k, _ in eccs], platform, device=dev)
        n = store.n_words
        print(f"  single-rail arena: {n} words in {len(eccs)} leaves")

        b1 = {"n_words": n}
        for v in (0.56, 0.54):
            t = time.perf_counter()
            masks = store.host_masks(v)
            mask_s = time.perf_counter() - t
            for reencode in (False, True):
                args = (store.lo, store.hi, store.parity, *masks)
                k_out = ops.inject_scrub(*args, reencode=reencode)
                p_out = ref.inject_scrub_ref(*args, reencode=reencode)
                torch.cuda.synchronize()
                require(same(k_out, p_out), f"inject_scrub differs at {v} V reencode={reencode}")
                print(f"  inject_scrub {v} V reencode={reencode}: bit-identical, "
                      f"counters {k_out[3].tolist()}, host masks {mask_s:.2f} s")
                if v == 0.56 and not reencode:
                    faulty = store._slice_leaves([k_out[:3]])
            if v == 0.56:
                b1["ms"] = sync_ms(lambda: ops.inject_scrub(*args), 20)
                b1["plain_ms"] = sync_ms(lambda: ref.inject_scrub_ref(*args), 3)
                b1["host_mask_s"] = mask_s
        b1["bound_ms"] = 1e3 * 27 * n / HBM_BYTES_PER_S
        report["inject_scrub"] = b1

        # Read-time fault injection (B7) at the 0.54 V draw over the whole
        # arena, then over the paper MLP's planes (784-256-128-10).
        def inject_row(args_, words, iters):
            require(same(ops.inject(*args_), ref.inject_ref(*args_)),
                    f"inject differs over {words} words")
            xor3 = lambda: [torch.bitwise_xor(a_, m_) for a_, m_ in zip(args_[:3], args_[3:])]
            return {"n_words": words, "ms": sync_ms(lambda: ops.inject(*args_), iters),
                    "plain_ms": sync_ms(lambda: ref.inject_ref(*args_), 3),
                    "library_ms": sync_ms(xor3, iters),
                    "bound_ms": 1e3 * 27 * words / HBM_BYTES_PER_S}

        report["inject"] = inject_row((store.lo, store.hi, store.parity, *masks), n, 20)
        pcfg = paper_nn.config()
        mlp_store = EccMLP(pcfg.layer_sizes, platform=pcfg.platform, seed=0, device=dev)
        mlp_store.store()
        ms_ = mlp_store._store
        report["inject"]["mlp"] = inject_row(
            (ms_.lo, ms_.hi, ms_.parity, *ms_.host_masks(0.54)), ms_.n_words, 200)
        for r_ in (report["inject"], report["inject"]["mlp"]):
            print(f"  inject at 0.54 V over {r_['n_words']} words: bit-identical, "
                  f"{r_['ms']:.4f} ms, bound {r_['bound_ms']:.4f} ms (bytes), "
                  f"plain {r_['plain_ms']:.3f} ms, three torch.bitwise_xor "
                  f"{r_['library_ms']:.4f} ms")
        del mlp_store, ms_

        # SECDED encode (B4) over the whole weight arena: the check plane of
        # every weight pack, in one launch.
        require(same([ops.encode(store.lo, store.hi)], [ref.encode_ref(store.lo, store.hi)]),
                "encode differs on the weight arena")
        report["encode"] = {
            "n_words": n, "ms": sync_ms(lambda: ops.encode(store.lo, store.hi), 20),
            "plain_ms": sync_ms(lambda: ref.encode_ref(store.lo, store.hi), 2),
            "bound_ms": 1e3 * 9 * n / HBM_BYTES_PER_S,
        }
        print(f"  encode over the weight arena ({n} words): bit-identical, "
              f"{report['encode']['ms']:.3f} ms, bound {report['encode']['bound_ms']:.3f} ms, "
              f"plain {report['encode']['plain_ms']:.2f} ms")

        # Fused decode+matmul on the faulty 0.56 V planes of layer 0.
        by_key = dict(zip((k for k, _ in eccs), faulty))
        names = ("wq", "wk", "wv", "wo")
        mm_keys = [f"['blocks']['p0']['attn'][{w!r}]" for w in names] + [
            f"['blocks']['p0']['mlp'][{w!r}]" for w in ("w1", "w3", "w2")
        ]
        # One entry per M, its times summed over the seven matmuls of a layer:
        # M = BATCH runs the decode kernel, M = VERIFY_M and BATCH x PROMPT_LEN
        # the tiled one, and the decode kernel's rows must equal the tiled
        # kernel's. Bounds: the bytes, the bf16 MMAs of the three-piece split
        # (3 x 2MKN on the tensor cores; "ops_ms", the operations bound) and,
        # beside them, the float32 FFMA bound of one product per weight.
        b3 = {m: {"M": m, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                  "ffma_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0,
                  "shapes": [],
                  "function": b3_names[b3_kernel.kernel_for(m, cfg.d_ff)]}
              for m in (BATCH, VERIFY_M, BATCH * PROMPT_LEN)}
        gen = torch.Generator(device=dev).manual_seed(1)
        for key in (k for k in mm_keys if k in by_key):
            ew = by_key[key]
            layers_ = [ew.layer(g) for g in range(cfg.n_groups)]
            w_deq = [ref.ecc_matmul_ref(torch.eye(ew.k, device=dev), lw.lo, lw.hi,
                                        lw.parity, lw.scale) for lw in layers_[:2]]
            x_all = torch.randn(BATCH * PROMPT_LEN, ew.k, generator=gen, device=dev)
            for lw in layers_[:2]:
                require(torch.equal(ops.ecc_matmul(x_all[:BATCH], lw),
                                    ops.ecc_matmul(x_all, lw)[:BATCH]),
                        f"ecc_matmul {key}: the M={BATCH} rows differ from the same rows at "
                        f"M={BATCH * PROMPT_LEN}")
            for m in b3:
                x = x_all[:m]
                worst = 0.0
                for lw in layers_[:2]:
                    k_o = ops.ecc_matmul(x, lw)
                    p_o = ref.ecc_matmul_ref(x, lw.lo, lw.hi, lw.parity, lw.scale)
                    torch.cuda.synchronize()
                    err = float((k_o - p_o).abs().max())
                    scale = float(p_o.abs().max())
                    require(bool(torch.isfinite(k_o).all()), f"ecc_matmul non-finite {key}")
                    require(err <= MATMUL_RTOL * scale,
                            f"ecc_matmul {key} M={m}: err {err} > {MATMUL_RTOL} * {scale}")
                    worst = max(worst, err)
                    b3[m]["max_rel_err"] = max(b3[m]["max_rel_err"], err / scale)
                # Cycle through all layers so the planes come from HBM, as in
                # the decode loop (28 layers of planes exceed the 50 MB L2).
                ms = sync_ms(lambda: [ops.ecc_matmul(x, lw) for lw in layers_], 5) / len(layers_)
                pms = sync_ms(lambda: [ref.ecc_matmul_ref(x, lw.lo, lw.hi, lw.parity, lw.scale)
                                       for lw in layers_[:4]], 2) / 4
                lib = sync_ms(lambda: [torch.matmul(x, w) for w in w_deq], 20) / len(w_deq)
                k, nn = ew.k, ew.n
                nbytes = 4 * m * k + 9 * k * nn // 8 + 4 * nn + 4 * m * nn
                bt, ot = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * 3 * 2 * m * k * nn / BF16_TC_FLOPS
                ft = 1e3 * 2 * m * k * nn / FP32_FLOPS
                row = {"key": key, "M": m, "K": k, "N": nn, "ms": ms, "plain_ms": pms,
                       "library_ms": lib, "bound_ms": max(bt, ot),
                       "bound_by": "bytes" if bt >= ot else "operations",
                       "bytes_ms": bt, "ops_ms": ot, "ffma_ms": ft, "max_abs_err": worst}
                b3[m]["shapes"].append(row)
                for f in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms", "ffma_ms"):
                    b3[m][f] += row[f]
                b3[m]["max_abs_err"] = max(b3[m]["max_abs_err"], worst)
                print(f"  ecc_matmul M={m} K={k} N={nn} ({b3[m]['function']}): max err "
                      f"{worst:.3e} (<= {MATMUL_RTOL}*max|plain|), {ms:.4f} ms, bound "
                      f"{max(bt, ot):.4f} ms ({row['bound_by']}; bytes {bt:.4f}, bf16 MMAs "
                      f"{ot:.4f}, FFMA {ft:.4f}), plain {pms:.4f} ms, torch.matmul {lib:.4f} ms")
        print(f"  ecc_matmul rows: the M={BATCH} rows of {b3_names['decode']} equal the same "
              f"rows of {b3_names['tiled']} at M={BATCH * PROMPT_LEN}, every layer shape")
        for r in b3.values():
            r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
            r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
            print(f"  ecc_matmul M={r['M']} ({r['function']}), a layer's 7 matmuls: "
                  f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; bytes "
                  f"{r['bytes_ms']:.4f}, bf16 MMAs {r['ops_ms']:.4f}, FFMA {r['ffma_ms']:.4f}), "
                  f"max rel err {r['max_rel_err']:.2e}, plain {r['plain_ms']:.4f} ms, "
                  f"torch.matmul {r['library_ms']:.4f} ms")
        report["ecc_matmul_decode"] = b3[BATCH]
        report["ecc_matmul_prefill"] = b3[BATCH * PROMPT_LEN]
        report["ecc_matmul_prefill"]["verify"] = b3[VERIFY_M]
        del store, faulty, by_key, masks, args, k_out, p_out, w_deq, layers_
        torch.cuda.empty_cache()

        # Multi-rail arena (embedding protected as its own domain).
        clean, _ = protect_params_inline(params, cfg, include_embed=True)
        eccs = [(k, w) for k, w in base.flatten(clean) if isinstance(w, ops.EccWeight)]
        mstore = PlaneStore([w for _, w in eccs], [k for k, _ in eccs], platform,
                            domain_key=shapes.domain_of, device=dev)
        n = mstore.n_words
        volts = {"attention": 0.56, "mlp": 0.55, "embedding": 0.54}
        t = time.perf_counter()
        masks = mstore.host_masks(volts)
        mask_s = time.perf_counter() - t
        args = (mstore.lo, mstore.hi, mstore.parity, *masks, mstore.dom_ids, len(mstore.domains))
        k_out = ops.inject_scrub_domains(*args)
        p_out = ref.inject_scrub_domains_ref(*args)
        torch.cuda.synchronize()
        require(same(k_out, p_out), "inject_scrub_domains differs")
        print(f"  inject_scrub_domains {volts}: bit-identical over {n} words, rows "
              f"{dict(zip(mstore.domains, k_out[3].tolist()))}, host masks {mask_s:.2f} s")
        # Domain ids outside [0, n_domains) between in-range runs count in
        # no row; the kernel must match the plain version there too.
        n_small = 1 << 20
        small = [a[:n_small] for a in args[:6]]
        odd = torch.tensor([0, -1, 1, 5, 2, 3, 1], device=dev, dtype=torch.int32)
        odd_ids = odd.repeat_interleave(n_small // len(odd) + 1)[:n_small].contiguous()
        k_odd = ops.inject_scrub_domains(*small, odd_ids, len(mstore.domains))
        p_odd = ref.inject_scrub_domains_ref(*small, odd_ids, len(mstore.domains))
        torch.cuda.synchronize()
        require(same(k_odd, p_odd), "inject_scrub_domains differs with out-of-range ids")
        print(f"  inject_scrub_domains with ids {odd.tolist()} over {n_small} words: "
              f"bit-identical, rows {k_odd[3].tolist()}")
        report["inject_scrub_domains"] = {
            "n_words": n, "host_mask_s": mask_s,
            "ms": sync_ms(lambda: ops.inject_scrub_domains(*args), 20),
            "plain_ms": sync_ms(lambda: ref.inject_scrub_domains_ref(*args), 3),
            "bound_ms": 1e3 * 31 * n / HBM_BYTES_PER_S,
        }
        emb = mstore._slice_leaves([k_out[:3]])[-1]
        require(mstore.slots[-1].key == "['embed']", mstore.slots[-1].key)
        e_args = (emb.lo, emb.hi, emb.parity)
        k_dec, p_dec = ops.decode(*e_args), ref.decode_ref(*(a.reshape(-1) for a in e_args))
        torch.cuda.synchronize()
        require(same([t_.reshape(-1) for t_ in k_dec], p_dec), "decode differs")
        st = torch.bincount(k_dec[2].reshape(-1), minlength=3).tolist()
        print(f"  decode embedding at 0.54 V: bit-identical over {emb.lo.numel()} words, "
              f"status counts {st}")
        ne = emb.lo.numel()
        report["decode"] = {
            "n_words": ne, "path": b5_kernel.decode_path(*(a.reshape(-1) for a in e_args)),
            "ms": sync_ms(lambda: ops.decode(*e_args), 50),
            "plain_ms": sync_ms(lambda: ref.decode_ref(*e_args), 3),
            "bound_ms": 1e3 * 21 * ne / HBM_BYTES_PER_S,
        }
        del mstore, masks, args, k_out, p_out, emb, e_args, k_dec, p_dec, clean, eccs
        del small, odd_ids, k_odd, p_odd
        torch.cuda.empty_cache()

        # A 64-page KV arena at full width: random words, encoded by B4, one
        # 0.54 V fault interval of the device field, then B6 over a table
        # with duplicated ids (a faulty page among them) and scratch ids.
        geom = KVGeometry.from_config(cfg)
        arena = KVPageArena(geom, platform, KV_PAGES, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(2)
        word = lambda: torch.randint(-2**31, 2**31, arena.lo.shape, generator=g, device=dev,
                                     dtype=torch.int64).to(torch.int32)
        arena.lo, arena.hi = word(), word()
        nk = arena.n_words
        real_lo, real_hi = arena.lo[:nk], arena.hi[:nk]
        k_enc = ops.encode(real_lo, real_hi)
        require(torch.equal(k_enc, ref.encode_ref(real_lo, real_hi)), "encode differs on the KV arena")
        arena.parity[:nk] = k_enc
        # the scratch row a codeword too, as in serving (zeroed, then written
        # only by encoded commits), so its syndromes are the faults' alone
        arena.parity[nk:] = ops.encode(arena.lo[nk:], arena.hi[nk:])
        arena.set_voltage(0.54)
        arena.tick()
        ids = np.concatenate([np.arange(0, KV_PAGES, 2), [5, 5, 6, 6, 6, KV_PAGES, KV_PAGES, 0]])
        ids_d = torch.as_tensor(ids.astype(np.int32), device=dev)
        wpp = geom.words_per_page
        k_pl = [t.clone() for t in (arena.lo, arena.hi, arena.parity)]
        p_pl = [t.clone() for t in (arena.lo, arena.hi, arena.parity)]
        k_gs = ops.gather_scrub_pages(*k_pl, ids_d, wpp)
        p_gs = ref.gather_scrub_ref(*p_pl, ids_d, wpp)
        torch.cuda.synchronize()
        require(torch.equal(k_gs[0].view(torch.int32), p_gs[0].view(torch.int32))
                and torch.equal(k_gs[1], p_gs[1]), "gather_scrub payload or counters differ")
        require(same(k_pl, p_pl), "gather_scrub write-back differs")
        cnt = k_gs[1].sum(dim=0).tolist()
        require(cnt[1] > 0 and cnt[2] > 0, f"no corrected or detected words at 0.54 V: {cnt}")
        print(f"  gather_scrub over {len(ids)} page ids ({len(ids) * wpp} words, ids {ids.tolist()}) "
              f"of a {KV_PAGES}-page arena ({nk} words) at 0.54 V: bit-identical, "
              f"(clean, corrected, detected) = {cnt[:3]}")
        payload = torch.randn(BATCH, geom.token_f32, generator=g, device=dev)
        commit_base = torch.as_tensor(
            kvpages.row_bases(np.arange(BATCH) * 3, np.arange(BATCH) % 8, geom), device=dev)
        ops.encode_commit(payload, commit_base, geom.token_words, *k_pl)
        ref.encode_commit_ref(payload, commit_base, geom.token_words, *p_pl)
        torch.cuda.synchronize()
        require(same(k_pl, p_pl), "encode_commit differs")
        print(f"  encode over the KV arena ({nk} words) and a {BATCH}-token commit: bit-identical")
        report["gather_scrub"] = {
            **gather_scrub_row("gather_scrub", (arena.lo, arena.hi, arena.parity), ids_d, wpp),
            "arena_words": nk, "page_ids": ids.tolist()}
        report["encode_kv_arena"] = {
            "n_words": nk, "ms": sync_ms(lambda: ops.encode(real_lo, real_hi), 20),
            "plain_ms": sync_ms(lambda: ref.encode_ref(real_lo, real_hi), 2),
            "bound_ms": 1e3 * 9 * nk / HBM_BYTES_PER_S,
        }
        # The floor of one launch in this timing loop: a one-element
        # in-place add, beside every commit entry (whose bound lies below it).
        one = torch.zeros(1, device=dev)
        launch_floor_ms = sync_ms(lambda: one.add_(1), 50)
        print(f"  launch floor (one-element add_ in the same loop): {launch_floor_ms:.4f} ms")
        cw = BATCH * geom.token_words
        report["encode_commit"] = {
            "rows": BATCH, "launch_floor_ms": launch_floor_ms,
            **bounds(cw, "secded72", 17, 20, extra_bytes=8 * BATCH),
            "ms": sync_ms(lambda: ops.encode_commit(payload, commit_base, geom.token_words,
                                                    *k_pl), 50),
            "plain_ms": sync_ms(lambda: ref.encode_commit_ref(payload, commit_base,
                                                              geom.token_words, *p_pl), 5),
        }
        for key in ("encode_kv_arena", "encode_commit"):
            r = report[key]
            print(f"  {key} ({r['n_words']} words): {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"(bytes), plain {r['plain_ms']:.3f} ms")
        del arena, k_pl, p_pl, k_gs, p_gs, real_lo, real_hi, k_enc
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 2, codecs
    with Phase("2 codec variants vs plain versions"):
        def timed(row, k_fn, p_fn, iters, p_iters=2):
            row["ms"] = sync_ms(k_fn, iters)
            row["plain_ms"] = sync_ms(p_fn, p_iters)
            print(f"  {row['name']} ({row['n_words']} words): bit-identical, {row['ms']:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
                  f"{row['bytes_ms']:.4f}, popc {row['ops_ms']:.4f}), plain {row['plain_ms']:.3f} ms")
            report[row["name"]] = row
            return row

        cg = torch.Generator(device=dev).manual_seed(3)

        def rand_words(n):
            return torch.randint(-2**31, 2**31, (n,), generator=cg, device=dev,
                                 dtype=torch.int64).to(torch.int32)

        def card_masks(n, codec):
            """Flip masks drawn on the card (each bit flips with probability
            2^-10: the AND of ten random words), for variants that no path
            runs; the check mask in the codec's dtype."""
            c = codes.get(codec)

            def sparse():
                w = rand_words(n)
                for _ in range(9):
                    w &= rand_words(n)
                return w

            chk = sparse() & ((1 << c.n_check) - 1)
            return sparse(), sparse(), chk.to(c.check_torch_dtype)

        # a. the codec engine's three weight groups (phase 9's arena)
        clean, _ = protect_params_inline(params, cfg, include_embed=True)
        eccs = [(k, w) for k, w in base.flatten(clean) if isinstance(w, ops.EccWeight)]
        cstore = PlaneStore([w for _, w in eccs], [k for k, _ in eccs], platform,
                            domain_key=shapes.domain_of, codecs=shapes.domain_codecs(CODEC_MIX),
                            device=dev, mask_source=VARIANT_MASKS)
        del clean, eccs
        nd = len(cstore.domains)
        print(f"  codec arena: {cstore.n_words} words, groups "
              f"{[(g.name, g.n_words) for g in cstore.groups]}")
        for g in cstore.groups:
            require(torch.equal(g.check, ref.encode_ref(g.lo, g.hi, g.name)),
                    f"encode differs on the {g.name} group")
            if g.name != "secded72":
                timed({"name": f"encode_{g.name}", **bounds(g.n_words, g.name, 9, 12)},
                      lambda g=g: ops.encode(g.lo, g.hi, codec=g.name),
                      lambda g=g: ref.encode_ref(g.lo, g.hi, g.name), 20)
        faulty_groups = {}
        for v in (0.56, 0.54):
            t = time.perf_counter()
            gm = cstore.group_masks(v)
            torch.cuda.synchronize()
            mask_s = time.perf_counter() - t
            for g, m in zip(cstore.groups, gm):
                for reencode in (True, False):
                    args = (g.lo, g.hi, g.check, *m, g.dom_ids, nd)
                    k_out = ops.inject_scrub_domains(*args, codec=g.name, reencode=reencode)
                    p_out = ref.inject_scrub_domains_ref(*args, codec=g.name, reencode=reencode)
                    torch.cuda.synchronize()
                    require(same(k_out, p_out),
                            f"inject_scrub_domains {g.name} differs at {v} V reencode={reencode}")
                print(f"  inject_scrub_domains {g.name} at {v} V ({g.n_words} words, "
                      f"{VARIANT_MASKS} masks of all groups {mask_s:.2f} s): bit-identical with "
                      f"and without re-encode, "
                      f"rows {dict(zip(cstore.domains, k_out[3].tolist()))}")
                if v == 0.56:
                    faulty_groups[g.name] = k_out[:3]
                    if g.name != "secded72":
                        timed({"name": f"inject_scrub_domains_{g.name}", "masks": VARIANT_MASKS,
                               "mask_s": mask_s,
                               **bounds(g.n_words, g.name, 31, 40, popc_extra=3)},
                              lambda g=g, m=m: ops.inject_scrub_domains(
                                  g.lo, g.hi, g.check, *m, g.dom_ids, nd, codec=g.name),
                              lambda g=g, m=m: ref.inject_scrub_domains_ref(
                                  g.lo, g.hi, g.check, *m, g.dom_ids, nd, codec=g.name), 20)
            del gm
        # the refresh's decode over the faulty parity65 and dected79 leaves
        for name in ("parity65", "dected79"):
            planes = faulty_groups[name]
            k_dec, p_dec = ops.decode(*planes, codec=name), ref.decode_ref(*planes, codec=name)
            torch.cuda.synchronize()
            require(same(k_dec, p_dec), f"decode {name} differs")
            print(f"  decode {name} at 0.56 V: status counts "
                  f"{torch.bincount(k_dec[2], minlength=3).tolist()}")
            timed({"name": f"decode_{name}", "path": b5_kernel.decode_path(*planes),
                   **bounds(planes[0].numel(), name, 21, 24)},
                  lambda p_=planes, c_=name: ops.decode(*p_, codec=c_),
                  lambda p_=planes, c_=name: ref.decode_ref(*p_, codec=c_), 20)
        # no path: the domain form under ileave88 over the whole arena
        ichk = ops.encode(cstore.lo, cstore.hi, codec="ileave88")
        require(torch.equal(ichk, ref.encode_ref(cstore.lo, cstore.hi, "ileave88")),
                "encode ileave88 differs on the weight arena")
        im = card_masks(cstore.n_words, "ileave88")
        for reencode in (False, True):
            args = (cstore.lo, cstore.hi, ichk, *im, cstore.dom_ids, nd)
            require(same(ops.inject_scrub_domains(*args, codec="ileave88", reencode=reencode),
                         ref.inject_scrub_domains_ref(*args, codec="ileave88",
                                                      reencode=reencode)),
                    f"inject_scrub_domains ileave88 differs reencode={reencode}")
        args = (cstore.lo, cstore.hi, ichk, *im, cstore.dom_ids, nd)
        timed({"name": "inject_scrub_domains_ileave88", "masks": "card",
               **bounds(cstore.n_words, "ileave88", 31, 40, popc_extra=3)},
              lambda: ops.inject_scrub_domains(*args, codec="ileave88"),
              lambda: ref.inject_scrub_domains_ref(*args, codec="ileave88"), 20)
        del cstore, faulty_groups, planes, k_dec, p_dec, ichk, im, args, k_out, p_out
        torch.cuda.empty_cache()

        # b. the single-rail arena under dected79 (phase 9's second engine),
        # then the inject+scrub under parity65 and ileave88 (no path) over it
        clean, _ = protect_params_inline(params, cfg)
        eccs = [(k, w) for k, w in base.flatten(clean) if isinstance(w, ops.EccWeight)]
        dstore = PlaneStore([w for _, w in eccs], [k for k, _ in eccs], platform,
                            codecs="dected79", device=dev, mask_source=VARIANT_MASKS)
        del clean, eccs
        (g,) = dstore.groups
        n = g.n_words
        require(torch.equal(g.check, ref.encode_ref(g.lo, g.hi, "dected79")),
                "encode dected79 differs on the single-rail arena")
        for v in (0.56, 0.54):
            t = time.perf_counter()
            m = dstore.group_masks(v)[0]
            torch.cuda.synchronize()
            mask_s = time.perf_counter() - t
            for reencode in (False, True):
                k_out = ops.inject_scrub(g.lo, g.hi, g.check, *m, codec="dected79",
                                         reencode=reencode)
                p_out = ref.inject_scrub_ref(g.lo, g.hi, g.check, *m, codec="dected79",
                                             reencode=reencode)
                torch.cuda.synchronize()
                require(same(k_out, p_out), f"inject_scrub dected79 differs at {v} V "
                                            f"reencode={reencode}")
                print(f"  inject_scrub dected79 {v} V reencode={reencode} ({n} words): "
                      f"bit-identical, counters {k_out[3].tolist()}, {VARIANT_MASKS} masks "
                      f"{mask_s:.2f} s")
            if v == 0.56:
                timed({"name": "inject_scrub_dected79", "masks": VARIANT_MASKS, "mask_s": mask_s,
                       **bounds(n, "dected79", 27, 36, popc_extra=3)},
                      lambda m=m: ops.inject_scrub(g.lo, g.hi, g.check, *m, codec="dected79"),
                      lambda m=m: ref.inject_scrub_ref(g.lo, g.hi, g.check, *m,
                                                       codec="dected79"), 20)
            if v == 0.54:  # dected79's tables are read only where the syndrome is not 0
                zm = dstore.group_host_masks(1.0)[0]
                report["inject_scrub_dected79"]["ms_054"] = sync_ms(
                    lambda m=m: ops.inject_scrub(g.lo, g.hi, g.check, *m, codec="dected79"), 20)
                report["inject_scrub_dected79"]["ms_nominal"] = sync_ms(
                    lambda: ops.inject_scrub(g.lo, g.hi, g.check, *zm, codec="dected79"), 20)
                del zm
                print(f"  inject_scrub dected79: {report['inject_scrub_dected79']['ms_054']:.4f} "
                      f"ms at 0.54 V, {report['inject_scrub_dected79']['ms_nominal']:.4f} ms at "
                      "nominal (zero masks)")
            del m
        for name in ("parity65", "ileave88"):
            chk = ops.encode(g.lo, g.hi, codec=name)
            require(torch.equal(chk, ref.encode_ref(g.lo, g.hi, name)),
                    f"encode {name} differs on the single-rail arena")
            m = card_masks(n, name)
            for reencode in (False, True):
                args = (g.lo, g.hi, chk, *m)
                require(same(ops.inject_scrub(*args, codec=name, reencode=reencode),
                             ref.inject_scrub_ref(*args, codec=name, reencode=reencode)),
                        f"inject_scrub {name} differs reencode={reencode}")
            args = (g.lo, g.hi, chk, *m)
            timed({"name": f"inject_scrub_{name}", "masks": "card",
                   **bounds(n, name, 27, 36, popc_extra=3)},
                  lambda a_=args, c_=name: ops.inject_scrub(*a_, codec=c_),
                  lambda a_=args, c_=name: ref.inject_scrub_ref(*a_, codec=c_), 20)
            del chk, m, args
        del dstore, g, k_out, p_out
        torch.cuda.empty_cache()

        # c. a 64-page KV arena under each other codec: encode, one 0.54 V
        # fault interval, the decode, the paged scrub over duplicate and
        # scratch ids, and a token commit
        geom = KVGeometry.from_config(cfg)
        wpp = geom.words_per_page
        ids = np.concatenate([np.arange(0, KV_PAGES, 2), [5, 5, 6, 6, 6, KV_PAGES, KV_PAGES, 0]])
        ids_d = torch.as_tensor(ids.astype(np.int32), device=dev)
        for name in ("parity65", "ileave88", "dected79"):
            arena = KVPageArena(geom, platform, KV_PAGES, seed=0, codec=name, device=dev)
            arena.lo, arena.hi = rand_words(arena.lo.numel()), rand_words(arena.lo.numel())
            nk = arena.n_words
            real_lo, real_hi = arena.lo[:nk], arena.hi[:nk]
            k_enc = ops.encode(real_lo, real_hi, codec=name)
            require(torch.equal(k_enc, ref.encode_ref(real_lo, real_hi, name)),
                    f"encode {name} differs on the KV arena")
            arena.parity[:nk] = k_enc
            arena.parity[nk:] = ops.encode(arena.lo[nk:], arena.hi[nk:], codec=name)  # scratch
            if name == "ileave88":
                timed({"name": "encode_ileave88", **bounds(nk, name, 9, 12)},
                      lambda: ops.encode(real_lo, real_hi, codec="ileave88"),
                      lambda: ref.encode_ref(real_lo, real_hi, "ileave88"), 20)
            arena.set_voltage(0.54)
            arena.tick()
            fplanes = (arena.lo[:nk], arena.hi[:nk], arena.parity[:nk])
            k_dec, p_dec = ops.decode(*fplanes, codec=name), ref.decode_ref(*fplanes, codec=name)
            torch.cuda.synchronize()
            require(same(k_dec, p_dec), f"decode {name} differs on the KV arena")
            if name == "ileave88":
                timed({"name": "decode_ileave88", "path": b5_kernel.decode_path(*fplanes),
                       **bounds(nk, name, 21, 24)},
                      lambda: ops.decode(*fplanes, codec="ileave88"),
                      lambda: ref.decode_ref(*fplanes, codec="ileave88"), 20)
            k_pl = [t.clone() for t in (arena.lo, arena.hi, arena.parity)]
            p_pl = [t.clone() for t in (arena.lo, arena.hi, arena.parity)]
            k_gs = ops.gather_scrub_pages(*k_pl, ids_d, wpp, codec=name)
            p_gs = ref.gather_scrub_ref(*p_pl, ids_d, wpp, codec=name)
            torch.cuda.synchronize()
            require(torch.equal(k_gs[0].view(torch.int32), p_gs[0].view(torch.int32))
                    and torch.equal(k_gs[1], p_gs[1]), f"gather_scrub {name} differs")
            require(same(k_pl, p_pl), f"gather_scrub {name} write-back differs")
            cnt = k_gs[1].sum(dim=0).tolist()
            require(cnt[2] > 0 and (cnt[1] > 0) == (name != "parity65"),
                    f"gather_scrub {name} at 0.54 V: {cnt}")
            print(f"  {name} KV arena ({nk} words) at 0.54 V: encode, decode (status "
                  f"{torch.bincount(k_dec[2], minlength=3).tolist()}) and gather_scrub over "
                  f"{len(ids)} page ids bit-identical, (clean, corrected, detected) = {cnt[:3]}")
            report[f"gather_scrub_{name}"] = gather_scrub_row(
                f"gather_scrub_{name}", (arena.lo, arena.hi, arena.parity), ids_d, wpp, name)
            payload = torch.randn(BATCH, geom.token_f32, generator=cg, device=dev)
            commit_base = torch.as_tensor(
                kvpages.row_bases(np.arange(BATCH) * 3, np.arange(BATCH) % 8, geom), device=dev)
            ops.encode_commit(payload, commit_base, geom.token_words, *k_pl, codec=name)
            ref.encode_commit_ref(payload, commit_base, geom.token_words, *p_pl, codec=name)
            torch.cuda.synchronize()
            require(same(k_pl, p_pl), f"encode_commit {name} differs")
            timed({"name": f"encode_commit_{name}", "rows": BATCH,
                   "launch_floor_ms": launch_floor_ms,
                   **bounds(BATCH * geom.token_words, name, 17, 20, extra_bytes=8 * BATCH)},
                  lambda c_=name: ops.encode_commit(payload, commit_base, geom.token_words,
                                                    *k_pl, codec=c_),
                  lambda c_=name: ref.encode_commit_ref(payload, commit_base, geom.token_words,
                                                        *p_pl, codec=c_), 50, 5)
            del arena, real_lo, real_hi, k_enc, fplanes, k_dec, p_dec, k_pl, p_pl, k_gs, p_gs
        torch.cuda.empty_cache()

        # d. every codec, bit for bit: B4's commit form at the full token
        # width into a 64-page arena (one row, a verify block, a 4 x 32-token
        # prompt, an odd row width, row bases off a quad boundary), and B1 and
        # B2 (both re-encode settings) on planes cut at word offsets 1-3 and
        # on one plane off 16 bytes (the word loop), on 1, 3, 5 and 4,097
        # words, and with domain boundaries inside quads and out-of-range ids
        tw, slots = geom.token_words, KV_PAGES * geom.page_tokens
        commit_cases = {  # name -> (row words, rows, row shifts)
            "one_row": (tw, 1, 0), "verify_block": (tw, VERIFY_M, 0),
            "prompt_4x32": (tw, BATCH * 32, 0), "odd_row_words": (tw - 1, 6, 0),
            "bases_off_quad": (tw - 4, 6, np.arange(6) % 3 + 1)}

        def at_offset(t_, k):
            buf = torch.empty(t_.numel() + k, dtype=t_.dtype, device=dev)
            buf[k:] = t_
            return buf[k:]

        inject_cases = {  # name -> (words, offsets of lo, hi, check, 3 masks, ids)
            "word_1": (4097, (1,) * 7), "word_2": (4097, (2,) * 7),
            "word_3": (4097, (3,) * 7), "n_1": (1, (0,) * 7), "n_3": (3, (0,) * 7),
            "n_5": (5, (0,) * 7), "n_4097": (4097, (0,) * 7),
            "one_plane_off_16_bytes": (4097, (0, 0, 0, 0, 0, 0, 3))}
        runs = torch.tensor([0, 1, 2, 0, -1, 1, 3, 2], device=dev, dtype=torch.int32)
        run_len = torch.tensor([5, 3, 7, 1, 2, 6, 3, 9], device=dev)
        # B5 and B7: 1, 3, 5 and 4,099 words, planes cut at word offsets 1-3
        # (the word loop), a stacked 3-D leaf; B5 on words with 0-3 flipped
        # bits (every status), B7 also on a length with whole 4,096-word
        # blocks and a tail that is not a multiple of 16
        plane_cases = {  # name -> (shape, offset of every plane)
            "n_1": ((1,), 0), "n_3": ((3,), 0), "n_5": ((5,), 0), "n_4099": ((4099,), 0),
            "word_1": ((4099,), 1), "word_2": ((4099,), 2), "word_3": ((4099,), 3),
            "stacked_3d": ((3, 17, 70), 0)}
        fg = np.random.default_rng(9)

        def flipped(n_, codec):
            """Codewords of n_ random words with 0-3 random codeword bits
            flipped in each."""
            c_ = codes.get(codec)
            w_ = 64 + c_.n_check
            bits = np.zeros((n_, w_), bool)
            for i_, k_ in enumerate(fg.integers(0, 4, n_)):
                bits[i_, fg.choice(w_, k_, replace=False)] = True
            pack = lambda b_: torch.as_tensor((b_.astype(np.uint64) @ (
                1 << np.arange(b_.shape[1], dtype=np.uint64))).astype(np.uint32).view(np.int32),
                device=dev)
            lo_, hi_ = rand_words(n_), rand_words(n_)
            chk_ = ops.encode(lo_, hi_, codec=codec)
            mchk_ = pack(bits[:, 64:]).to(c_.check_torch_dtype)
            return lo_ ^ pack(bits[:, :32]), hi_ ^ pack(bits[:, 32:64]), chk_ ^ mchk_

        for name in codes.names():
            c = codes.get(name)
            n_arena = (KV_PAGES + 1) * wpp
            base_pl = [rand_words(n_arena), rand_words(n_arena)]
            base_pl.append(ops.encode(*base_pl, codec=name))
            for case, (rw, rows, shift) in commit_cases.items():
                dest = torch.randperm(slots, generator=cg, device=dev)[:rows]
                rb = (dest * tw + torch.as_tensor(shift, device=dev)).contiguous()
                pay = torch.randn(rows, 2 * rw, generator=cg, device=dev)
                k_pl = [t_.clone() for t_ in base_pl]
                p_pl = [t_.clone() for t_ in base_pl]
                ops.encode_commit(pay, rb, rw, *k_pl, codec=name)
                ref.encode_commit_ref(pay, rb, rw, *p_pl, codec=name)
                torch.cuda.synchronize()
                require(same(k_pl, p_pl), f"encode_commit {name} differs: {case}")
            del base_pl, k_pl, p_pl
            for case, (n_, offs) in inject_cases.items():
                planes = [rand_words(n_), rand_words(n_)]
                planes += [ops.encode(*planes, codec=name), *card_masks(n_, name)]
                dom = runs.repeat_interleave(run_len).repeat(n_ // int(run_len.sum()) + 1)[:n_]
                *planes, dom = [at_offset(t_, o) for t_, o in zip((*planes, dom), offs)]
                for reencode in (False, True):
                    require(same(ops.inject_scrub(*planes, codec=name, reencode=reencode),
                                 ref.inject_scrub_ref(*planes, codec=name, reencode=reencode)),
                            f"inject_scrub {name} differs: {case} reencode={reencode}")
                    require(same(ops.inject_scrub_domains(*planes, dom, 3, codec=name,
                                                          reencode=reencode),
                                 ref.inject_scrub_domains_ref(*planes, dom, 3, codec=name,
                                                              reencode=reencode)),
                            f"inject_scrub_domains {name} differs: {case} reencode={reencode}")
            statuses = set()
            for case, (shape, off) in plane_cases.items():
                n_ = int(np.prod(shape))
                planes = [at_offset(t_, off).reshape(shape) for t_ in flipped(n_, name)]
                k_dec = ops.decode(*planes, codec=name)
                require(same(k_dec, ref.decode_ref(*planes, codec=name)),
                        f"decode {name} differs: {case}")
                statuses |= set(torch.unique(k_dec[2]).tolist())
            require(statuses == ({0, 2} if name == "parity65" else {0, 1, 2}),
                    f"decode {name} edge cases: statuses {statuses}")
            print(f"  {name} edge cases bit-identical: commit {list(commit_cases)} "
                  f"({c.n_check} check bits, {tw}-word tokens); inject_scrub and its domain "
                  f"form {list(inject_cases)}, domain runs {run_len.tolist()} of ids "
                  f"{runs.tolist()} (3 rows), both re-encode settings; decode "
                  f"{list(plane_cases)} on words with 0-3 flipped bits, statuses "
                  f"{sorted(statuses)}")
        for case, (shape, off) in {**plane_cases, "blocks_and_tail": ((3 * 4096 + 1005,), 0),
                                   "blocks_and_tail_word_1": ((3 * 4096 + 1005,), 1)}.items():
            n_ = int(np.prod(shape))
            planes = [rand_words(n_), rand_words(n_),
                      (rand_words(n_) & 255).to(torch.uint8), *card_masks(n_, "secded72")]
            planes = [at_offset(t_, off).reshape(shape) for t_ in planes]
            require(same(ops.inject(*planes), ref.inject_ref(*planes)),
                    f"inject differs: {case}")
        print(f"  inject edge cases bit-identical: {list(plane_cases)}, blocks_and_tail "
              f"({3 * 4096 + 1005} words) at offsets 0 and 1")
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 3
    with Phase("3 tiny config: card vs CPU"):
        tcfg = get_smoke_config("qwen3-0.6b")
        tparams = lm.init_params(tcfg, seed=0, device="cpu")
        prompts = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 8)).astype(np.int32)
        for multi, cdx in ((False, None), (True, None), (False, "dected79"), (True, CODEC_MIX)):
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    rails=RailsConfig(multi_rail=multi),
                                    protection=ProtectionConfig(codecs=cdx))
            engs = {d: ServingEngine(tcfg, tparams, rel=rel, max_len=32, device=d)
                    for d in ("cpu", "cuda")}
            for v in (1.0, 0.56, 0.54):
                outs = {}
                for d, e in engs.items():
                    e.set_voltage(v)
                    outs[d] = (e.generate(prompts, 8), e._last_scrub)
                require(outs["cpu"][1] == outs["cuda"][1],
                        f"counters differ multi={multi} codecs={cdx} {v} V")
                require(np.array_equal(outs["cpu"][0], outs["cuda"][0]),
                        f"tokens differ multi={multi} codecs={cdx} {v} V")
            print(f"  multi_rail={multi} codecs={cdx}: equal tokens and counters at "
                  "1.0/0.56/0.54 V")
        # The smoke-size paper MLP with the same weights on both devices.
        scfg = paper_nn.smoke_config()
        carried = [(l_.w.numpy(), l_.b.numpy()) for l_ in EccMLP(
            scfg.layer_sizes, platform=scfg.platform, seed=1, device="cpu").layers]
        xs_s = np.random.default_rng(3).standard_normal((512, scfg.layer_sizes[0])).astype(np.float32)
        mlps = {}
        for d in ("cpu", "cuda"):
            mlps[d] = EccMLP(scfg.layer_sizes, platform=scfg.platform, seed=1, device=d)
            mlps[d].load_params(carried)
            mlps[d].store()
        unclear = 0
        for v in (0.56, 0.54):
            for ecc in (True, False):
                for batched in (True, False):
                    outs = {}
                    for d, m in mlps.items():
                        m.set_voltage(v, ecc=ecc, batched=batched)
                        planes = [t_.cpu() for l_ in m.layers
                                  for t_ in (l_.faulty.lo, l_.faulty.hi, l_.faulty.parity)]
                        outs[d] = (planes, m.stats.counters(), m.logits(xs_s).cpu())
                    tag = f"{v} V ecc={ecc} batched={batched}"
                    require(same(outs["cpu"][0], outs["cuda"][0]), f"MLP planes differ at {tag}")
                    require(np.array_equal(outs["cpu"][1], outs["cuda"][1]),
                            f"MLP counters differ at {tag}")
                    lc, lg = outs["cpu"][2], outs["cuda"][2]
                    tol = MATMUL_RTOL * float(lc.abs().max())
                    require(float((lc - lg).abs().max()) <= tol, f"MLP logits differ at {tag}")
                    top2 = torch.topk(lc, 2, dim=-1).values
                    clear = (top2[:, 0] - top2[:, 1]) > tol
                    unclear += int((~clear).sum())
                    require(torch.equal(lc.argmax(-1)[clear], lg.argmax(-1)[clear]),
                            f"MLP predictions differ at {tag}")
        print(f"  paper MLP {scfg.layer_sizes}: equal planes, counters and predictions "
              f"(logits within {MATMUL_RTOL} x max|cpu|; {unclear} rows within that of a tie) "
              f"at 0.56/0.54 V, ECC on and off, batched and per-leaf")
        del mlps

    # Every decode (B5) launch of phases 4-9 by the loop it takes: the
    # callers hand it whole planes or views at leaf offsets.
    decode_loops: dict = {}
    b5_launch = b5_kernel.decode

    def b5_counted(lo_, hi_, chk_, *, codec):
        key_ = f"{codec.name}:{b5_kernel.decode_path(lo_, hi_, chk_)}"
        decode_loops[key_] = decode_loops.get(key_, 0) + 1
        return b5_launch(lo_, hi_, chk_, codec=codec)

    b5_kernel.decode = b5_counted

    # ---------------------------------------------------------------- 4-5
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
    runs, traced_params, paths_extra, nominal_tokens = {}, {}, {}, {}
    for multi in (False, True):
        name = "multi-rail" if multi else "single-rail"
        with Phase(f"{4 + multi} full-width qwen3-0.6b {name} engine"), Tally() as tally:
            ops.reset_launch_count()
            run = runs[name] = {}
            fwd = {"prefill": 0, "decode": 0}  # forward passes of this path
            t = time.perf_counter()
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    rails=RailsConfig(multi_rail=multi,
                                                      start_v=HOST_WALK_START_V))
            eng = ServingEngine(cfg, params, rel=rel, max_len=64)  # one voltage step
            torch.cuda.synchronize()
            run["build_s"] = time.perf_counter() - t
            mask_s = []  # one entry per later voltage step
            host_masks = eng._store.group_host_masks

            def timed_masks(v, _f=host_masks, _acc=mask_s):
                t_ = time.perf_counter()
                out = _f(v)
                _acc.append(time.perf_counter() - t_)
                return out

            eng._store.group_host_masks = timed_masks
            toks = {}
            for v in HOST_STEP_VOLTS[multi]:
                t = time.perf_counter()
                eng.set_voltage(v)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t
                t = time.perf_counter()
                toks[v] = eng.generate(prompts, NEW_TOKENS)
                gen_s = time.perf_counter() - t
                fwd["prefill"] += 1
                fwd["decode"] += NEW_TOKENS - 1
                require(toks[v].shape == (BATCH, NEW_TOKENS), str(toks[v].shape))
                require(bool(((toks[v] >= 0) & (toks[v] < cfg.vocab)).all()), "token range")
                if v == 0.56 and not multi:  # held against the per-leaf engine (phase 8)
                    batched_056 = {
                        "planes": [(w.lo, w.hi, w.parity) for _, w in base.flatten(eng.params)
                                   if isinstance(w, ops.EccWeight)],
                        "scrub": dataclasses.asdict(eng._last_scrub), "tokens": toks[v]}
                nominal_tokens.setdefault(name, toks[1.0])
                agree = float((toks[v] == toks[1.0]).mean())
                run[f"{v}V"] = {"step_s": step_s, "host_mask_s": mask_s[-1],
                                "generate_s": gen_s,
                                "tokens_per_s": BATCH * NEW_TOKENS / gen_s,
                                "agreement_with_nominal": agree,
                                "scrub": eng._last_scrub.total().to_dict() if multi
                                else eng._last_scrub.to_dict()}
                print(f"  {v} V: step {step_s:.3f} s (host masks {mask_s[-1]:.3f} s), "
                      f"generate {gen_s:.2f} s = {BATCH * NEW_TOKENS / gen_s:.1f} tokens/s, "
                      f"agreement {agree:.3f}, scrub {run[f'{v}V']['scrub']}")
            run["steps"] = step_breakdown(eng.params, fwd)
            for k_, r_ in run["steps"].items():
                print(f"  {k_} step (batch {BATCH}): wall {r_['wall_ms']:.2f} ms")
            logits, _ = lm.prefill(eng.params, torch.as_tensor(prompts, device=dev), cfg,
                                   lm.init_cache(cfg, BATCH, 64))
            fwd["prefill"] += 1
            require(tuple(logits.shape) == (BATCH, cfg.vocab)
                    and bool(torch.isfinite(logits).all()), "prefill logits")
            # Start the canary walk from a clean interval at its start voltage.
            if not multi:
                eng.set_voltage(eng.controller.voltage)
            n_masks = len(mask_s)
            t = time.perf_counter()
            lock, hist = eng.autotune_voltage()
            torch.cuda.synchronize()
            run["autotune_s"] = time.perf_counter() - t
            run["autotune_steps"] = len(mask_s) - n_masks
            run["autotune_host_mask_s"] = sum(mask_s[n_masks:])
            run["lock"] = lock
            run["power_report"] = eng.power_report()
            if multi:
                run["history"] = {d: [(r.voltage, r.detected, r.action) for r in h]
                                  for d, h in hist.items()}
                require(eng.controller.locked, "multi-rail walk did not lock")
            else:
                run["history"] = [(r.voltage, r.detected, r.action) for r in hist]
                require(eng.controller.locked, "single-rail walk did not lock")
            print(f"  autotune: lock {lock} in {run['autotune_steps']} voltage steps, "
                  f"{run['autotune_s']:.1f} s (host masks {run['autotune_host_mask_s']:.1f} s)")
            print(f"  history {json.dumps(run['history'])}")
            print(f"  power_report {json.dumps(run['power_report'])}")

            # This path's launches: every voltage step and every matmul went
            # through the kernels, and none of the other path's ran.
            counts = ops.launch_counts()
            steps = 1 + len(mask_s)
            per_fwd = sum(w.lo.shape[0] if w.lo.ndim == 3 else 1
                          for _, w in base.flatten(eng.params) if isinstance(w, ops.EccWeight))
            require(per_fwd == 7 * cfg.n_layers, f"{per_fwd} protected matmuls per forward")
            want = {"inject_scrub": 0 if multi else steps,
                    "inject_scrub_domains": steps if multi else 0,
                    "decode": steps if multi else 0,
                    "ecc_matmul": per_fwd * (fwd["prefill"] + fwd["decode"]),
                    "encode": tally.n["packs"], "gather_scrub": 0, "inject": 0,
                    "fault_field": 0}
            require(counts == want, f"{name} launches {counts}, expected {want}")
            require(tally.n["packs"] == per_fwd + multi, f"{tally.n['packs']} weight packs")
            require(tally.n["plain_on_card"] == 0, "the plain codec ran on the card")
            run.update(launches=counts, launches_by_codec=ops.launch_counts_by_codec(),
                       voltage_steps=steps, arena_words=eng._store.n_words,
                       forwards=dict(fwd, decode_kernel=fwd["decode"]),
                       matmuls_per_forward=per_fwd, packs=tally.n["packs"], commits=0,
                       scrubs=0)
            print(f"  launches: {json.dumps(counts)} = {steps} voltage steps, "
                  f"{per_fwd} fused matmuls x {fwd['prefill']} prefill + "
                  f"{fwd['decode']} decode forward passes, {tally.n['packs']} weight packs")
            traced_params[name] = eng.params
            del eng, logits
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6
    rng = np.random.default_rng(1)
    stream = [(rng.integers(0, cfg.vocab, int(rng.integers(16, 49))).astype(np.int32),
               int(rng.integers(8, 25))) for _ in range(8)]
    prefix = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    shared_reqs = [(np.concatenate([prefix, rng.integers(0, cfg.vocab, int(rng.integers(4, 17)))])
                    .astype(np.int32), int(rng.integers(8, 17))) for _ in range(8)]
    paged = {}

    def check_paged_launches(name, tally, counts, multi, c=None, into=None):
        """The paged path's launch formulas, from the path's own tally, for
        the model ``c`` (qwen3-0.6b); its record goes into ``into``
        (``paged``)."""
        n = tally.n
        c = c or cfg
        per_fwd = len(protected(c)) * c.n_layers
        want = {"inject_scrub": 0 if multi else 1, "inject_scrub_domains": int(multi),
                "decode": int(multi), "ecc_matmul": per_fwd * (n["prefill"] + n["decode"]),
                "encode": n["packs"] + n["commits"],
                "gather_scrub": n["intervals"] + n["prefix_scrubs"], "inject": 0,
                "fault_field": n["draws"]}
        require(counts == want, f"{name} launches {counts}, expected {want}")
        require(n["packs"] == per_fwd + multi, f"{n['packs']} weight packs")
        require(n["plain_on_card"] == 0, "the plain codec ran on the card")
        print(f"  {name} launches: {json.dumps(counts)} = 1 voltage step, {per_fwd} fused "
              f"matmuls x ({n['prefill']} prefill/chunk + {n['decode']} decode forwards), "
              f"{n['packs']} packs + {n['commits']} commits, {n['intervals']} fault intervals "
              f"({n['draws']} field draws) + "
              f"{n['prefix_scrubs']} prefix-hit admission scrubs")
        (paged if into is None else into)[name] = {
                       "launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
                       "kv_codec": "secded72", "matmuls_per_forward": per_fwd,
                       "forwards": {"prefill": n["prefill"], "decode": n["decode"],
                                    "decode_kernel": n["decode_kernel"]},
                       "packs": n["packs"], "commits": n["commits"],
                       "scrubs": n["intervals"] + n["prefix_scrubs"], "voltage_steps": 1}

    def outputs_equal(a, b) -> bool:
        return sorted(a) == sorted(b) and all(np.array_equal(a[r], b[r]) for r in a)

    with Phase("6 paged SECDED KV serving, full width"):
        ops.reset_launch_count()
        with Tally() as tally:
            t = time.perf_counter()
            eng = ServingEngine(cfg, params, rel=ReliabilityConfig(mode="inline", voltage=1.0),
                                max_len=PAGED_MAX_LEN)
            torch.cuda.synchronize()
            print(f"  inline single-rail engine built in {time.perf_counter() - t:.2f} s")
            # a. nominal paged serve against dense generate, same batch
            dense = eng.generate(prompts, NEW_TOKENS)
            t = time.perf_counter()
            rep = eng.serve([(p, NEW_TOKENS) for p in prompts], n_lanes=BATCH)
            nominal_s = time.perf_counter() - t
            got = np.stack([rep.outputs[i] for i in range(BATCH)])
            require(np.array_equal(got, dense), "paged serve differs from dense generate")
            require(rep.kv_stats.clean == rep.kv_stats.words > 0, f"nominal scrub {rep.kv_stats}")
            print(f"  nominal: {BATCH} x {PROMPT_LEN}-token prompts, {NEW_TOKENS} new tokens: "
                  f"equal to dense generate; {rep.steps} steps, {len(rep.kv_voltages)} scrub "
                  f"intervals in {nominal_s:.2f} s")
            # b. a mixed stream at a 0.56 V kv rail, arena small enough to preempt
            t = time.perf_counter()
            srep = eng.serve(stream, n_lanes=4, kv_voltage=0.56, n_pages=STREAM_PAGES)
            torch.cuda.synchronize()
            stream_s = time.perf_counter() - t
            n_tok = sum(len(v) for v in srep.outputs.values())
            require(len(srep.outputs) == len(stream), "stream did not finish")
            require(srep.preemptions >= 1, f"no preemption with {STREAM_PAGES} pages")
            require(srep.kv_stats.corrected > 0, f"no corrected word at 0.56 V: {srep.kv_stats}")
            require(all(bool(((v >= 0) & (v < cfg.vocab)).all()) for v in srep.outputs.values()),
                    "token range")
            paged["stream"] = {
                "requests": len(stream), "prompt_lens": [len(p) for p, _ in stream],
                "new_tokens": [n for _, n in stream], "n_pages": STREAM_PAGES,
                "wall_s": stream_s, "tokens": n_tok, "tokens_per_s": n_tok / stream_s,
                "steps": srep.steps, "preemptions": srep.preemptions,
                "scrub_intervals": len(srep.kv_voltages), "kv_stats": srep.kv_stats.to_dict(),
            }
            print(f"  stream of {len(stream)} requests at 0.56 V kv rail, {STREAM_PAGES} pages: "
                  f"{n_tok} tokens in {stream_s:.2f} s = {n_tok / stream_s:.1f} tokens/s, "
                  f"{srep.steps} steps, {srep.preemptions} preemptions, "
                  f"{len(srep.kv_voltages)} scrub intervals, kv {srep.kv_stats.to_dict()}")
            # c. shared prefixes against private pages
            priv = eng.serve(shared_reqs, n_lanes=4)
            shr = eng.serve(shared_reqs, n_lanes=4, share_prefix=True)
            require(outputs_equal(priv.outputs, shr.outputs), "shared differs from private")
            require(shr.prefix_hit_tokens > 0, "no prefix hit")
            require(shr.pages_free_at_end == shr.arena.n_pages, "pages leaked")
            print(f"  share_prefix: equal to private, {shr.prefix_hit_tokens} prefix-hit tokens, "
                  f"scrubbed words {shr.kv_stats.words} vs {priv.kv_stats.words} private")
            # d. speculative decoding with a 2-layer qwen3-width draft
            dcfg = dataclasses.replace(cfg, n_layers=2)
            dparams = lm.init_params(dcfg, seed=1, device=dev)
            reqs = [(p, NEW_TOKENS) for p in prompts]
            greedy = eng.serve(reqs, n_lanes=BATCH, scrub_interval=4)
            spec = eng.serve(reqs, n_lanes=BATCH, scrub_interval=4, speculative=4,
                             draft_params=dparams, draft_cfg=dcfg)
            require(outputs_equal(greedy.outputs, spec.outputs), "speculative differs from greedy")
            require(spec.spec_dispatches > 0, "no speculative block ran")
            print(f"  speculative=4: equal to greedy; {spec.spec_dispatches} verify blocks emitted "
                  f"{spec.spec_emitted} tokens ({greedy.steps} greedy steps)")
        check_paged_launches("paged", tally, ops.launch_counts(), multi=False)

        # Where a stream's time goes: one decode step, commit, fault
        # interval and interval scrub at the stream's shapes.
        arena = srep.arena
        geom = arena.geom
        live = np.arange(min(STREAM_PAGES, 4 * 4), dtype=np.int32)
        table = np.full((4, 4), arena.scratch_page, np.int32)
        table.reshape(-1)[: len(live)] = live
        table_d = torch.as_tensor(table.reshape(-1), device=dev)
        cache = lm.init_cache(cfg, 4, PAGED_MAX_LEN)
        tok4 = torch.zeros(4, 1, dtype=torch.int64, device=dev)
        pos4 = torch.tensor([40, 33, 20, 57], device=dev)
        kv4 = 57 + 1  # the scheduler's host bound on the keys a step reads
        payload4 = torch.randn(4, geom.token_f32, device=dev)
        pages4, slots4 = np.array([0, 3, 6, 9]), np.array([1, 2, 3, 4])
        arena.set_voltage(0.56)
        tick_s = []

        def timed_tick():
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            arena.tick()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t_)

        parts = {
            "decode_step_ms": min(wall_ms(lambda: lm.decode_step(eng.params, tok4, cfg, cache,
                                                                 pos4, kv4)) for _ in range(3)),
            "commit_ms": min(wall_ms(lambda: arena.commit_tokens(payload4, pages4, slots4))
                             for _ in range(3)),
            "tick_ms": min(wall_ms(timed_tick) for _ in range(3)),
            "interval_pages": int(table.size), "arena_words": arena.n_words,
            "words_per_page": geom.words_per_page,
            "draw_ms": min(wall_ms(lambda: arena._masks(arena.profile.fault_rate(0.56)))
                           for _ in range(3)),
        }
        # the scrubs are timed against the faults of those intervals
        parts.update(interval_scrub_times(arena, table, table_d, "interval_scrub"))
        # Traced after every timed part of this engine's path: device time
        # inside one decode step and one fault interval + scrub.
        for key, fn in (("decode_step", lambda: lm.decode_step(eng.params, tok4, cfg, cache, pos4, kv4)),
                        ("interval", lambda: (arena.tick(), arena.scrub_pages(table)))):
            evs = device_events(fn)
            if evs:
                busy_ms_ = busy_us(evs) / 1e3
                parts[f"{key}_device_busy_ms"] = busy_ms_
                parts[f"{key}_device_events"] = len(evs)
                wall = parts["decode_step_ms" if key == "decode_step" else "tick_ms"]
                if key == "interval":
                    wall += parts["interval_scrub_ms"]
                parts[f"{key}_device_idle_share"] = 1.0 - busy_ms_ / wall
        paged["breakdown"] = parts
        print(f"  stream breakdown (4 lanes): decode step {parts['decode_step_ms']:.2f} ms, "
              f"commit {parts['commit_ms']:.3f} ms, fault interval (device masks) "
              f"{parts['tick_ms']:.2f} ms (its draw {parts['draw_ms']:.2f} ms), interval scrub of {table.size} pages "
              f"{parts['interval_scrub_ms']:.2f} ms wall (kernel "
              f"{parts['interval_scrub_kernel_ms']:.3f} ms)")
        if "decode_step_device_busy_ms" in parts:
            print(f"  traced: decode step device busy {parts['decode_step_device_busy_ms']:.2f} ms "
                  f"(idle share {parts['decode_step_device_idle_share']:.3f}); interval device "
                  f"busy {parts.get('interval_device_busy_ms', 0.0):.2f} ms")
        else:
            print("  traced: device time not measured (the profiler traced no device event)")
        del eng, srep, priv, shr, greedy, spec, dparams, arena, cache
        torch.cuda.empty_cache()

        # e. the multi-rail engine walks its kv rail on the scrubs' DED counters
        ops.reset_launch_count()
        with Tally() as tally:
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    rails=RailsConfig(multi_rail=True, start_v=0.62))
            meng = ServingEngine(cfg, params, rel=rel, max_len=PAGED_MAX_LEN)
            wrep = meng.serve(stream, n_lanes=4, walk_kv=True)
        check_paged_launches("paged-multi-rail", tally, ops.launch_counts(), multi=True)
        kv = meng.controller.rails["kv"]
        walk = [(r.voltage, r.corrected, r.detected, r.action) for r in kv.history]
        # the rail's record ends at its lock; the stream's intervals go on
        require(0 < len(walk) <= len(wrep.kv_voltages), "the kv rail did not walk")
        paged["walk_kv"] = {"locked": kv.locked, "voltage": kv.voltage, "history": walk,
                            "power_report": meng.power_report(),
                            "kv_stats": wrep.kv_stats.to_dict()}
        print(f"  walk_kv: kv rail {'locked' if kv.locked else 'not locked'} at {kv.voltage:.2f} V "
              f"after {len(walk)} intervals; walk (V, corrected, detected, action) "
              f"{json.dumps(walk)}")
        print(f"  power_report {json.dumps(paged['walk_kv']['power_report'])}")
        del meng, wrep
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7
    fig3 = {}
    with Phase("7 paper Fig. 3 NN accelerator, full width"):
        ops.reset_launch_count()
        with Tally() as tally:
            tally._wrap(EccMLP, "set_voltage", lambda self_, v, ecc=True, batched=True: (
                "mlp_batched" if batched else "mlp_per_leaf" if ecc else "mlp_per_leaf_no_ecc"))
            tally._wrap(EccMLP, "logits",
                        lambda self_, xs, fuse=True: "mlp_fused" if fuse else "mlp_naive")
            xtr, ytr = mnist.make_dataset(MLP_TRAIN, split="train")
            xte, yte = mnist.make_dataset(MLP_TEST, split="test")
            mlp = EccMLP(pcfg.layer_sizes, platform=pcfg.platform, seed=0, device=dev)
            t = time.perf_counter()
            loss = mlp.train(xtr, ytr, steps=pcfg.train_steps, batch=pcfg.batch_size, lr=pcfg.lr)
            torch.cuda.synchronize()
            fig3.update(layer_sizes=list(pcfg.layer_sizes), train=MLP_TRAIN, test=MLP_TEST,
                        steps=pcfg.train_steps, train_s=time.perf_counter() - t, final_loss=loss,
                        words=mlp._store.n_words)
            prof = PLATFORMS[pcfg.platform]
            mlp.set_voltage(prof.v_nom, ecc=True)
            pred0 = mlp.predict(xte)
            err_free = float((pred0 != yte).mean())
            print(f"  trained {pcfg.layer_sizes} for {pcfg.train_steps} steps in "
                  f"{fig3['train_s']:.2f} s (loss {loss:.4f}); {fig3['words']} protected words; "
                  f"fault-free test error {err_free:.4f}")
            require(err_free < 0.10, f"fault-free error {err_free} >= 0.10")
            volts = [prof.v_nom] + [round(prof.v_min - 0.01 * i, 2) for i in
                                    range(int(round((prof.v_min - prof.v_crash) / 0.01)) + 1)]
            rows = []
            for v in volts:
                for ecc in (True, False):
                    t = time.perf_counter()
                    mlp.set_voltage(v, ecc=ecc)
                    pred = mlp.predict(xte)
                    row = {"voltage": v, "ecc": ecc, "err": float((pred != yte).mean()),
                           "divergence_vs_clean": float((pred != pred0).mean()),
                           **mlp.stats.coverage_row(), "power_w": mlp.power_w(),
                           "bram_power_w": mlp.bram_power_w(),
                           "bram_saving_vs_vmin": power_saving(prof.v_min, v, ecc=ecc),
                           "step_and_predict_ms": 1e3 * (time.perf_counter() - t)}
                    rows.append(row)
                    print(f"  fig3 {v:.2f} V ecc={int(ecc)}: err {row['err']:.4f}, divergence "
                          f"{row['divergence_vs_clean']:.4f}, faulty words {row['faulty_words']}, "
                          f"corrected {row['corrected']}, detected {row['detected']}, silent "
                          f"{row['silent']}, coverage correctable "
                          f"{row['coverage_correctable']:.4f} detectable "
                          f"{row['coverage_detectable']:.4f} silent {row['coverage_silent']:.4f}, "
                          f"power {row['power_w']:.4f} W, BRAM saving vs V_min "
                          f"{row['bram_saving_vs_vmin']:.4f}, step+predict "
                          f"{row['step_and_predict_ms']:.1f} ms")
            fig3["rows"] = rows
            at_crash = {r["ecc"]: r["err"] for r in rows if r["voltage"] == prof.v_crash}
            require(at_crash[True] <= at_crash[False],
                    f"err with ECC {at_crash[True]} > without {at_crash[False]} at V_crash")
            # Fused and naive reads at V_crash, with ECC on and off.
            for ecc in (True, False):
                mlp.set_voltage(prof.v_crash, ecc=ecc)
                require(np.array_equal(mlp.predict(xte, fuse=True), mlp.predict(xte, fuse=False)),
                        f"fused and naive predictions differ at V_crash ecc={ecc}")
            # Per-leaf steps against batched ones, bit for bit.
            for v, ecc in ((0.56, True), (0.55, False), (0.54, True)):
                mlp.set_voltage(v, ecc=ecc, batched=False)
                per = [t_ for l_ in mlp.layers for t_ in (l_.faulty.lo, l_.faulty.hi, l_.faulty.parity)]
                per_cnt = mlp.stats.counters()
                mlp.set_voltage(v, ecc=ecc, batched=True)
                bat = [t_ for l_ in mlp.layers for t_ in (l_.faulty.lo, l_.faulty.hi, l_.faulty.parity)]
                require(same(per, bat) and np.array_equal(per_cnt, mlp.stats.counters()),
                        f"per-leaf differs from batched at {v} V ecc={ecc}")
            print(f"  V_crash: error {at_crash[True]:.4f} with ECC <= {at_crash[False]:.4f} without; "
                  "fused = naive predictions; per-leaf = batched planes and counters at "
                  "(0.56 V, ECC), (0.55 V, no ECC), (0.54 V, ECC)")
        n_ = tally.n
        n_layers = len(mlp.layers)
        per_leaf = n_.get("mlp_per_leaf", 0) + n_.get("mlp_per_leaf_no_ecc", 0)
        counts = ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(inject_scrub=n_.get("mlp_batched", 0), inject=n_layers * per_leaf,
                    decode=n_layers * (per_leaf + n_.get("mlp_naive", 0)),
                    encode=n_["packs"] + n_layers * n_.get("mlp_per_leaf_no_ecc", 0),
                    ecc_matmul=n_layers * n_.get("mlp_fused", 0))
        require(counts == want, f"fig3 launches {counts}, expected {want}")
        require(n_["packs"] == n_layers, f"{n_['packs']} weight packs")
        require(n_["plain_on_card"] == 0, "the plain codec ran on the card")
        print(f"  fig3 launches: {json.dumps(counts)} = {n_.get('mlp_batched', 0)} batched steps, "
              f"{per_leaf} per-leaf steps ({n_.get('mlp_per_leaf_no_ecc', 0)} without ECC), "
              f"{n_.get('mlp_fused', 0)} fused + {n_.get('mlp_naive', 0)} naive predicts, "
              f"{n_['packs']} packs, x {n_layers} layers")
        paths_extra["fig3"] = {"launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
                               "matmuls_per_forward": n_layers,
                               "forwards": {"prefill": n_.get("mlp_fused", 0), "decode": 0,
                                            "decode_kernel": 0},
                               "packs": want["encode"], "commits": 0}
        # The fused matmul at the MLP's shapes (M = test images), held
        # against its plain version and timed after the path's count.
        mlp.set_voltage(prof.v_crash, ecc=True)
        h, acts = torch.as_tensor(xte, device=dev), []
        for i, l_ in enumerate(mlp.layers):
            acts.append(h)
            h = ops.ecc_matmul(h, l_.faulty) + l_.b
            h = torch.relu(h) if i < len(mlp.layers) - 1 else h
        deq = [ref.ecc_matmul_ref(torch.eye(l_.faulty.k, device=dev), l_.faulty.lo,
                                  l_.faulty.hi, l_.faulty.parity, l_.faulty.scale)
               for l_ in mlp.layers]
        worst = worst_rel = 0.0
        for x_, l_ in zip(acts, mlp.layers):
            k_o, p_o = ops.ecc_matmul(x_, l_.faulty), ref.ecc_matmul_ref(
                x_, l_.faulty.lo, l_.faulty.hi, l_.faulty.parity, l_.faulty.scale)
            err = float((k_o - p_o).abs().max())
            require(err <= MATMUL_RTOL * float(p_o.abs().max()), f"MLP ecc_matmul err {err}")
            worst_rel = max(worst_rel, err / float(p_o.abs().max()))
            require(torch.equal(ops.ecc_matmul(x_[:BATCH], l_.faulty), k_o[:BATCH]),
                    f"MLP ecc_matmul K={l_.faulty.k}: the M={BATCH} rows differ from the "
                    f"same rows at M={MLP_TEST}")
            worst = max(worst, err)
        flop = sum(2 * MLP_TEST * l_.faulty.k * l_.faulty.n for l_ in mlp.layers)
        nbytes = sum(4 * MLP_TEST * (l_.faulty.k + l_.faulty.n)
                     + 9 * l_.faulty.k * l_.faulty.n // 8 + 4 * l_.faulty.n for l_ in mlp.layers)
        bt, ot = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * 3 * flop / BF16_TC_FLOPS
        report["ecc_matmul_prefill"]["mlp"] = {
            "M": MLP_TEST, "shapes": [[l_.faulty.k, l_.faulty.n] for l_ in mlp.layers],
            "per": "the 3 layers of one predict", "max_abs_err": worst,
            "max_rel_err": worst_rel, "bytes_ms": bt, "ops_ms": ot,
            "ffma_ms": 1e3 * flop / FP32_FLOPS,
            "ms": sync_ms(lambda: [ops.ecc_matmul(x_, l_.faulty)
                                   for x_, l_ in zip(acts, mlp.layers)], 20),
            "plain_ms": sync_ms(lambda: [ref.ecc_matmul_ref(
                x_, l_.faulty.lo, l_.faulty.hi, l_.faulty.parity, l_.faulty.scale)
                for x_, l_ in zip(acts, mlp.layers)], 5),
            "library_ms": sync_ms(lambda: [torch.matmul(x_, w_) for x_, w_ in zip(acts, deq)], 20),
            "bound_ms": max(bt, ot), "bound_by": "bytes" if bt >= ot else "operations",
        }
        r_ = report["ecc_matmul_prefill"]["mlp"]
        print(f"  ecc_matmul at M={MLP_TEST} over the MLP's 3 layers: max err {worst:.3e} "
              f"(rel {worst_rel:.2e}), the M={BATCH} rows equal ({b3_names['decode']} vs "
              f"{b3_names['tiled']}), {r_['ms']:.4f} ms, bound {r_['bound_ms']:.4f} ms "
              f"({r_['bound_by']}; bytes {bt:.4f}, bf16 MMAs {ot:.4f}, FFMA "
              f"{r_['ffma_ms']:.4f}), plain {r_['plain_ms']:.3f} ms, torch.matmul "
              f"{r_['library_ms']:.4f} ms")
        del mlp, acts, deq, h, xtr, xte

    # ---------------------------------------------------------------- 8
    with Phase("8 per-leaf and domain-mode engines, full width"):
        ops.reset_launch_count()
        with Tally() as tally:
            t = time.perf_counter()
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    fault_model=FaultModelConfig(batched=False))
            leng = ServingEngine(cfg, params, rel=rel, max_len=64)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
            t = time.perf_counter()
            leng.set_voltage(0.56)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            ltoks = leng.generate(prompts, NEW_TOKENS)
        leaves = [w for _, w in base.flatten(leng.params) if isinstance(w, ops.EccWeight)]
        require(len(leaves) == len(batched_056["planes"]) and all(
            same((w.lo, w.hi, w.parity), p_) for w, p_ in zip(leaves, batched_056["planes"])),
            "per-leaf planes differ from the batched engine's at 0.56 V")
        require(dataclasses.asdict(leng._last_scrub) == batched_056["scrub"],
                f"per-leaf counters {leng._last_scrub} differ from the batched engine's")
        require(np.array_equal(ltoks, batched_056["tokens"]),
                "per-leaf tokens differ from the batched engine's at 0.56 V")
        n_ = tally.n
        per_fwd = 7 * cfg.n_layers
        counts = ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(inject=2 * len(leaves), decode=2 * len(leaves), encode=n_["packs"],
                    ecc_matmul=per_fwd * (n_["prefill"] + n_["decode"]))
        require(counts == want, f"per-leaf launches {counts}, expected {want}")
        require(n_["packs"] == per_fwd and n_["plain_on_card"] == 0, f"per-leaf tally {n_}")
        per_leaf_run = {"build_s": build_s, "step_056_s": step_s,
                        "scrub_056": leng._last_scrub.to_dict(), "leaves": len(leaves)}
        print(f"  per-leaf engine: built in {build_s:.2f} s; 0.56 V step {step_s:.2f} s "
              f"({len(leaves)} inject + {len(leaves)} scrub launches); planes, counters and "
              f"tokens equal to phase 4's batched engine; scrub {per_leaf_run['scrub_056']}")
        print(f"  per-leaf launches: {json.dumps(counts)} = 2 voltage steps x {len(leaves)} leaves, "
              f"{n_['packs']} packs, {per_fwd} fused matmuls x ({n_['prefill']} prefill + "
              f"{n_['decode']} decode forwards)")
        paths_extra["per-leaf"] = {"launches": counts,
                                   "launches_by_codec": ops.launch_counts_by_codec(),
                                   "matmuls_per_forward": per_fwd,
                                   "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                                                "decode_kernel": n_["decode_kernel"]},
                                   "packs": n_["packs"], "commits": 0}
        del leng, leaves, batched_056
        torch.cuda.empty_cache()

        ops.reset_launch_count()
        mask_s = []
        real_gather = memory.gather_masks

        def timed_gather(*a, **kw):
            t_ = time.perf_counter()
            out = real_gather(*a, **kw)
            mask_s.append(time.perf_counter() - t_)
            return out

        memory.gather_masks = timed_gather
        try:
            with Tally() as tally:
                t = time.perf_counter()
                deng = ServingEngine(cfg, params, rel=ReliabilityConfig(voltage=1.0), max_len=64)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t
                n_arrays, n_words = len(deng.domain.names()), sum(
                    deng.domain.entry(k).n_words for k in deng.domain.names())
                require(all(same_bits(a_, b_) for (_, a_), (_, b_) in
                            zip(base.flatten(deng.params), base.flatten(params))),
                        "domain mode's nominal read-back differs from the params it wrote")
                dtoks = deng.generate(prompts, NEW_TOKENS)
                plain_toks = ServingEngine(cfg, params, rel=None, max_len=64).generate(
                    prompts, NEW_TOKENS)
                require(np.array_equal(dtoks, plain_toks),
                        "domain mode at nominal differs from the unprotected model")
                before = deng.stats.counters()
                t = time.perf_counter()
                deng.set_voltage(0.56)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t
                step_cnt = deng.stats.counters() - before
                t = time.perf_counter()
                d56 = deng.generate(prompts, NEW_TOKENS)
                gen_s = time.perf_counter() - t
        finally:
            memory.gather_masks = real_gather
        require(d56.shape == (BATCH, NEW_TOKENS) and bool(((d56 >= 0) & (d56 < cfg.vocab)).all()),
                "domain-mode tokens at 0.56 V")
        step_stats = dict(zip(("clean", "corrected", "detected", "silent", "words_1bit",
                               "words_2bit", "words_multi", "faulty_bits"), step_cnt.tolist()))
        require(step_stats["corrected"] > 0, f"no corrected word at 0.56 V: {step_stats}")
        # The 0.56 V read-back against the plain read on the same masks (the
        # fields keep their draw): every array bit for bit, and the counters.
        require(deng.rel.ecc, "the domain engine reads with ECC")
        plain_cnt = np.zeros_like(step_cnt)
        for key, arr in base.flatten(deng.params):
            e_ = deng.domain.entry("w" + key)
            m_ = faultsim.device_masks(e_.field, 0.56, dev)
            plo, phi, pst = ref.decode_ref(*ref.inject_ref(e_.lo, e_.hi, e_.parity, *m_))
            require(same_bits(arr, quantize.words_to_array(plo, phi, e_.nbytes, e_.shape,
                                                           e_.dtype)),
                    f"domain read-back of {key} at 0.56 V differs from the plain read")
            plain_cnt += FaultStats.from_decode(pst, faultsim.flip_counts(*m_)).counters()
            del m_, plo, phi, pst
        require(np.array_equal(plain_cnt, step_cnt),
                f"domain counters {step_cnt.tolist()} differ from the plain read's "
                f"{plain_cnt.tolist()}")
        print(f"  domain 0.56 V read-back: {n_arrays} arrays bit-identical to B7 + B5's plain "
              "versions on the same masks, counters equal")
        n_ = tally.n
        counts = ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(inject=2 * n_arrays, decode=2 * n_arrays, encode=n_arrays)
        require(counts == want, f"domain launches {counts}, expected {want}")
        require(n_["prefill"] == n_["decode"] == 0 and n_["plain_on_card"] == 0,
                f"domain tally {n_}")
        domain_run = {"build_s": build_s, "arrays": n_arrays, "words": n_words,
                      "step_056_s": step_s, "host_mask_s": sum(mask_s),
                      "generate_056_s": gen_s, "agreement_056_with_nominal":
                      float((d56 == dtoks).mean()), "stats_056": step_stats}
        print(f"  domain engine: {n_arrays} arrays, {n_words} words, built (write + nominal "
              f"read) in {build_s:.2f} s; nominal tokens equal the unprotected model's")
        print(f"  domain 0.56 V step {step_s:.2f} s (host masks {sum(mask_s):.2f} s), "
              f"generate {gen_s:.2f} s, agreement with nominal "
              f"{domain_run['agreement_056_with_nominal']:.3f}, stats {json.dumps(step_stats)}")
        print(f"  domain launches: {json.dumps(counts)} = 2 reads x {n_arrays} arrays, "
              f"{n_arrays} writes")
        paths_extra["domain"] = {"launches": counts,
                                 "launches_by_codec": ops.launch_counts_by_codec(),
                                 "matmuls_per_forward": per_fwd,
                                 "forwards": {"prefill": 0, "decode": 0, "decode_kernel": 0},
                                 "packs": n_arrays,
                                 "commits": 0}
        del deng
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 9
    codec_run = {}

    def codec_launch_check(name, counts, by_codec, want_codec, want_total):
        """Per-codec launch formulas of a codec path, and its totals."""
        got = {k: v for k, v in by_codec.items() if v}
        want = {k: {c: n for c, n in v.items() if n} for k, v in want_codec.items()}
        require(got == {k: v for k, v in want.items() if v},
                f"{name} launches by codec {by_codec}, expected {want}")
        require(counts == want_total, f"{name} launches {counts}, expected {want_total}")
        print(f"  {name} launches: {json.dumps(counts)}; by codec {json.dumps(by_codec)}")

    with Phase("9 per-domain-codec engine, full width"):
        per_fwd = 7 * cfg.n_layers
        ops.reset_launch_count()
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_rails", "rail_steps")
            t = time.perf_counter()
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    rails=RailsConfig(multi_rail=True,
                                                      start_v=HOST_WALK_START_V),
                                    protection=ProtectionConfig(codecs=CODEC_MIX))
            ceng = ServingEngine(cfg, params, rel=rel, max_len=PAGED_MAX_LEN)
            torch.cuda.synchronize()
            codec_run["build_s"] = time.perf_counter() - t
            store = ceng._store
            codec_run["groups"] = {g.name: {"words": g.n_words, "leaves": len(g.slot_ids),
                                            "check_bits": g.codec.n_check} for g in store.groups}
            print(f"  engine built in {codec_run['build_s']:.2f} s; domains {store.domains}, "
                  f"codec groups {json.dumps(codec_run['groups'])}")
            mask_s, refresh_ms, kept = [], [], {}
            real_gm, real_re = store.group_host_masks, ceng._reassemble_params

            def timed_gm(v, _f=real_gm, _acc=mask_s, _kept=kept):
                t_ = time.perf_counter()
                out = _f(v)
                _acc.append(time.perf_counter() - t_)
                if _kept.pop("next", False):  # the masks the next step injects, kept
                    _kept["masks"] = out
                return out

            def timed_re(leaves, _f=real_re, _acc=refresh_ms):
                out = []
                _acc.append(wall_ms(lambda: out.append(_f(leaves))))
                return out[0]

            store.group_host_masks, ceng._reassemble_params = timed_gm, timed_re
            ctoks = {1.0: ceng.generate(prompts, NEW_TOKENS)}
            require(np.array_equal(ctoks[1.0], nominal_tokens["multi-rail"]),
                    "the codec engine's nominal tokens differ from phase 5's SECDED engine")
            print("  nominal generate: tokens equal to phase 5's multi-rail SECDED engine")
            # a 0.56 V step on every rail, held against the plain versions
            kept["next"] = True
            t = time.perf_counter()
            ceng.set_rails(dict.fromkeys(store.domains, 0.56))
            torch.cuda.synchronize()
            codec_run["step_056_s"] = time.perf_counter() - t
            codec_run["step_056_host_mask_s"] = mask_s[-1]
            codec_run["refresh_056_ms"] = refresh_ms[-1]
            with tally.outside():
                gm = kept.pop("masks")  # the masks the step injected
                plain = sum(ref.inject_scrub_domains_ref(g.lo, g.hi, g.check, *m, g.dom_ids,
                                                         len(store.domains), codec=g.name)[3]
                            for g, m in zip(store.groups, gm))
                got = np.stack([ceng._last_scrub[d].counters() for d in store.domains])
                require(np.array_equal(plain.cpu().numpy(), got),
                        f"codec engine 0.56 V counters {got.tolist()} differ from the plain "
                        f"versions' {plain.tolist()}")
                del gm, plain
            codec_run["scrub_056"] = {d: ceng._last_scrub[d].to_dict() for d in store.domains}
            ctoks[0.56] = ceng.generate(prompts, NEW_TOKENS)
            print(f"  0.56 V step {codec_run['step_056_s']:.2f} s (host masks "
                  f"{codec_run['step_056_host_mask_s']:.2f} s, refresh "
                  f"{codec_run['refresh_056_ms']:.1f} ms); counters equal to the plain versions' "
                  f"on the same masks: {json.dumps(codec_run['scrub_056'])}; tokens agree with "
                  f"nominal {float((ctoks[0.56] == ctoks[1.0]).mean()):.3f}")
            # the DED-canary walk from its warm start
            n_masks = len(mask_s)
            t = time.perf_counter()
            lock, hist = ceng.autotune_voltage()
            torch.cuda.synchronize()
            codec_run.update(autotune_s=time.perf_counter() - t,
                             autotune_steps=len(mask_s) - n_masks,
                             autotune_host_mask_s=sum(mask_s[n_masks:]), lock=lock,
                             history={d: [(r.voltage, r.corrected, r.detected, r.action,
                                           r.codec) for r in h] for d, h in hist.items()})
            require(ceng.controller.locked, "the codec engine's walk did not lock")
            pr = codec_run["power_report"] = ceng.power_report()
            want_codecs = {"attention": "parity65", "mlp": "dected79", "embedding": "secded72"}
            require({d: pr["codecs"][d] for d in want_codecs} == want_codecs,
                    f"power_report codecs {pr['codecs']}")
            require({d: pr["check_bits"][d] for d in want_codecs}
                    == {"attention": 1, "mlp": 15, "embedding": 8},
                    f"power_report check bits {pr['check_bits']}")
            print(f"  autotune: lock {lock} in {codec_run['autotune_steps']} voltage steps, "
                  f"{codec_run['autotune_s']:.1f} s (host masks "
                  f"{codec_run['autotune_host_mask_s']:.1f} s)")
            print(f"  history (V, corrected, detected, action, codec) "
                  f"{json.dumps(codec_run['history'])}")
            print(f"  power_report {json.dumps(pr)}")
            ctoks["lock"] = ceng.generate(prompts, NEW_TOKENS)
            codec_run["agreement_at_lock"] = float((ctoks["lock"] == ctoks[1.0]).mean())
            print(f"  generate at the locks: agreement with nominal "
                  f"{codec_run['agreement_at_lock']:.3f}")
            # paged serve with ileave88 kv pages
            rep = ceng.serve([(p_, NEW_TOKENS) for p_ in prompts], n_lanes=BATCH, kv_voltage=1.0)
            got = np.stack([rep.outputs[i] for i in range(BATCH)])
            require(np.array_equal(got, ceng.generate(prompts, NEW_TOKENS)),
                    "paged serve with ileave88 pages differs from dense generate")
            require(rep.arena.codec_name == "ileave88" and rep.arena.parity.dtype == torch.int32
                    and rep.kv_stats.clean == rep.kv_stats.words > 0,
                    f"nominal ileave88 serve: {rep.arena.codec_name} {rep.kv_stats}")
            print(f"  serve at a nominal kv rail (ileave88 pages, weights at the locks): equal to "
                  f"dense generate; {rep.steps} steps")
            t = time.perf_counter()
            srep = ceng.serve(stream, n_lanes=4, kv_voltage=0.56, n_pages=STREAM_PAGES)
            torch.cuda.synchronize()
            stream_s = time.perf_counter() - t
            n_tok = sum(len(v) for v in srep.outputs.values())
            require(len(srep.outputs) == len(stream) and srep.preemptions >= 1,
                    f"ileave88 stream: {len(srep.outputs)} finished, {srep.preemptions} preempted")
            require(srep.kv_stats.corrected > 0, f"no corrected kv word: {srep.kv_stats}")
            codec_run["stream"] = {"wall_s": stream_s, "tokens": n_tok,
                                   "tokens_per_s": n_tok / stream_s, "steps": srep.steps,
                                   "preemptions": srep.preemptions,
                                   "kv_stats": srep.kv_stats.to_dict()}
            print(f"  stream of {len(stream)} requests at a 0.56 V kv rail (ileave88, "
                  f"{STREAM_PAGES} pages): {n_tok} tokens in {stream_s:.2f} s = "
                  f"{n_tok / stream_s:.1f} tokens/s, {srep.steps} steps, {srep.preemptions} "
                  f"preemptions, kv {srep.kv_stats.to_dict()}")
            power_after = ceng.power_report()
        n_ = tally.n
        steps = n_["rail_steps"]
        leaves = {g.name: len(g.slot_ids) for g in store.groups}
        refreshed = sum(n for c, n in leaves.items() if c != "secded72")
        counts, by_codec = ops.launch_counts(), ops.launch_counts_by_codec()
        intervals = n_["intervals"] + n_["prefix_scrubs"]
        want_codec = {
            "inject_scrub": {},
            "inject_scrub_domains": {c: steps for c in leaves},
            "decode": {c: steps * n for c, n in leaves.items()},  # the embedding is secded72
            "encode": {"secded72": n_["packs"] + 1 + steps * refreshed, "parity65": 1,
                       "dected79": 1, "ileave88": n_["commits"]},
            "gather_scrub": {"ileave88": intervals},
            "fault_field": {"ileave88": n_["draws"]},
        }
        want_total = {k: sum(v.values()) for k, v in want_codec.items()}
        want_total.update(ecc_matmul=per_fwd * (n_["prefill"] + n_["decode"]), inject=0)
        require(leaves == {"parity65": 4, "dected79": 3, "secded72": 1}, f"groups {leaves}")
        require(n_["packs"] == per_fwd + 1 and n_["plain_on_card"] == 0, f"codec tally {n_}")
        codec_launch_check("codec-multi-rail", counts, by_codec, want_codec,
                           {k: want_total[k] for k in counts})
        print(f"  = {steps} rail steps x {len(leaves)} codec groups, {refreshed} refreshed + 1 "
              f"embedding decodes and {refreshed} re-encodes per step, {n_['packs']} packs + "
              f"{n_['commits']} ileave88 commits, {intervals} ileave88 scrubs, {per_fwd} fused "
              f"matmuls x ({n_['prefill']} prefill + {n_['decode']} decode forwards)")
        paths_extra["codec-multi-rail"] = {
            "launches": counts, "launches_by_codec": by_codec, "kv_codec": "ileave88",
            "matmuls_per_forward": per_fwd,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_["decode_kernel"]},
            "packs": n_["packs"], "commits": n_["commits"], "voltage_steps": steps}
        codec_run.update(launches=counts, launches_by_codec=by_codec, rail_steps=steps,
                         refresh_ms=refresh_ms, power_report_after_serve=power_after)
        # a fault interval (88 bitplanes drawn on the card) and an interval
        # scrub of the stream's ileave88 arena, as phase 6 times SECDED's
        arena = srep.arena
        table = np.full((4, 4), arena.scratch_page, np.int32)
        table.reshape(-1)[: min(STREAM_PAGES, 16)] = np.arange(min(STREAM_PAGES, 16))
        table_d = torch.as_tensor(table.reshape(-1), device=dev)
        arena.set_voltage(0.56)
        codec_run["stream_breakdown"] = {
            "tick_ms": min(wall_ms(arena.tick) for _ in range(3)),
            "draw_ms": min(wall_ms(lambda: arena._masks(arena.profile.fault_rate(0.56)))
                           for _ in range(3)),
            "interval_pages": int(table.size), "arena_words": arena.n_words,
            **interval_scrub_times(arena, table, table_d, "interval_scrub_ileave88")}
        print(f"  ileave88 stream breakdown: fault interval (device masks, 88 bitplanes) "
              f"{codec_run['stream_breakdown']['tick_ms']:.2f} ms (its draw "
              f"{codec_run['stream_breakdown']['draw_ms']:.2f} ms), interval scrub of "
              f"{table.size} pages {codec_run['stream_breakdown']['interval_scrub_ms']:.2f} ms "
              f"wall (kernel {codec_run['stream_breakdown']['interval_scrub_kernel_ms']:.3f} ms)")
        del ceng, store, rep, srep, real_gm, real_re, arena
        torch.cuda.empty_cache()

        # the single-rail dected79 engine: one 0.56 V step and generate
        ops.reset_launch_count()
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_voltage", "voltage_steps")
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    protection=ProtectionConfig(codecs="dected79"))
            deng = ServingEngine(cfg, params, rel=rel, max_len=64)
            dtoks = {1.0: deng.generate(prompts, NEW_TOKENS)}
            require(np.array_equal(dtoks[1.0], nominal_tokens["single-rail"]),
                    "the dected79 engine's nominal tokens differ from phase 4's SECDED engine")
            t = time.perf_counter()
            deng.set_voltage(0.56)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            dtoks[0.56] = deng.generate(prompts, NEW_TOKENS)
            scrub = deng._last_scrub.to_dict()
        n_ = tally.n
        steps = n_["voltage_steps"]
        counts, by_codec = ops.launch_counts(), ops.launch_counts_by_codec()
        want_codec = {
            "inject_scrub": {"dected79": steps}, "inject_scrub_domains": {},
            "decode": {"dected79": 7 * steps},
            "encode": {"secded72": n_["packs"] + 7 * steps, "dected79": 1}, "gather_scrub": {},
            "fault_field": {},
        }
        want_total = {k: sum(v.values()) for k, v in want_codec.items()}
        want_total.update(ecc_matmul=per_fwd * (n_["prefill"] + n_["decode"]), inject=0)
        require(n_["packs"] == per_fwd and n_["plain_on_card"] == 0, f"dected79 tally {n_}")
        codec_launch_check("codec-single-dected79", counts, by_codec, want_codec,
                           {k: want_total[k] for k in counts})
        codec_run["single_dected79"] = {
            "step_056_s": step_s, "scrub_056": scrub, "voltage_steps": steps,
            "agreement_056": float((dtoks[0.56] == dtoks[1.0]).mean())}
        print(f"  single-rail dected79 engine: nominal tokens equal to phase 4's; 0.56 V step "
              f"{step_s:.2f} s, scrub {json.dumps(scrub)}, tokens agree with nominal "
              f"{codec_run['single_dected79']['agreement_056']:.3f}")
        paths_extra["codec-single-dected79"] = {
            "launches": counts, "launches_by_codec": by_codec, "kv_codec": None,
            "matmuls_per_forward": per_fwd,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_["decode_kernel"]},
            "packs": n_["packs"], "commits": 0, "voltage_steps": steps}
        del deng
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 10
    # The device fault field: the fault-field kernel against its plain
    # version, the device field against the host field, and the engines of
    # phases 4-5 with masks drawn on the card.
    int_per_s = INT_PER_SM_CLK * torch.cuda.get_device_properties(0).multi_processor_count \
        * sm_clock_hz
    device_runs = {}

    def field_groups(nc: int) -> int:
        return (64 + nc + 3) // 4

    def field_bound(words, drawn, nc, per_word) -> dict:
        """Bytes (f_row, per-word rates, the three masks) at HBM rate and the
        integer operations of the drawn words (a word at threshold 0 draws
        nothing) on the busier of the FMA pipe (multiplies) and the ALU
        pipe, each INT_PER_SM_CLK a clock per SM; the larger."""
        bpw = 4 + 4 * per_word + 8 + (1 if nc <= 8 else 4)
        bt = 1e3 * bpw * words / HBM_BYTES_PER_S
        ops_word = field_groups(nc) * max(FIELD_MULS_PER_GROUP, FIELD_ALU_OPS_PER_GROUP)
        ot = 1e3 * ops_word * drawn / int_per_s
        return {"n_words": words, "drawn_words": drawn, "bytes_per_word": bpw,
                "ops_per_drawn_word": ops_word,
                "multiplies_per_drawn_word": field_groups(nc) * FIELD_MULS_PER_GROUP,
                "bytes_ms": bt, "ops_ms": ot,
                "bound_ms": max(bt, ot), "bound_by": "bytes" if bt >= ot else "operations"}

    def drawn_words(f_row, rate) -> int:
        p = torch.clamp(torch.as_tensor(rate, dtype=torch.float32, device=dev) * f_row, 0.0,
                        faultsim.P_MAX)
        return int(((p * 4294967296.0).to(torch.int64) > 0).sum())

    def mask_err(got, want) -> float:
        """Largest |kernel - plain| over the words of the three masks, as
        integers (0 iff every bit agrees); a dtype or shape mismatch fails."""
        require(all(a.dtype == b.dtype and a.shape == b.shape for a, b in zip(got, want)),
                f"fault field dtypes/shapes {[(a.dtype, a.shape) for a in got]} vs "
                f"{[(b.dtype, b.shape) for b in want]}")
        return max(float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel()
                   else 0.0 for a, b in zip(got, want))

    def kernel_key(name: str):
        """'n_check[/rates][/burst]' of a fault-field kernel's mangled name,
        else None."""
        m = re.search(r"(field|burst)_kernelILi(\d+)ELb([01])E", name)
        return (f"{m.group(2)}{'/rates' if m.group(3) == '1' else ''}"
                f"{'/burst' if m.group(1) == 'burst' else ''}") if m else None

    def sass_sizes() -> dict:
        """Instructions of each fault-field kernel in the SASS (cuobjdump),
        by (n_check, per-word rates, burst): the burst-free kernels have no
        loop, so this is what a drawn word's thread runs, its early exit
        aside; the burst kernels loop over a run's iterations and, inside
        them, over the anchored groups."""
        cuobjdump = os.path.join(os.path.dirname(backend.nvcc_path()), "cuobjdump")
        if not os.path.exists(cuobjdump):
            return {}
        text = subprocess.run([cuobjdump, "-sass", str(backend.library_path("fault_field"))],
                              capture_output=True, text=True, timeout=120).stdout
        out, cur = {}, None
        for line in text.splitlines():
            if "Function :" in line:
                cur = kernel_key(line)
                if cur:
                    out[cur] = {"instructions": 0, "integer_multiplies": 0}
            elif cur and re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", line):
                op = line.split("*/", 1)[1].split()[0]
                if op.startswith("@"):
                    op = line.split("*/", 1)[1].split()[1]
                if op == "NOP":
                    continue
                out[cur]["instructions"] += 1
                out[cur]["integer_multiplies"] += op.startswith("IMAD")
        return out

    def ptxas_registers() -> dict:
        """Registers per thread of each fault-field kernel, by kernel_key,
        from the build's ptxas report (phase 1)."""
        out, cur = {}, None
        for line in backend.BUILD_LOG.get("fault_field", "").splitlines():
            if "Compiling entry function" in line:
                cur = kernel_key(line)
            elif cur and "Used" in line and "registers" in line:
                out[cur] = int(re.search(r"Used (\d+) registers", line).group(1))
                cur = None
        return out

    class HostToDevice(TorchDispatchMode):
        """The bytes of every PyTorch operation run inside it that copies a
        host tensor to the card (``to``, ``copy_``, ``as_tensor``...)."""

        def __init__(self):
            super().__init__()
            self.copies = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            into = func is torch.ops.aten.copy_.default
            src = args[1] if into else (args[0] if args else None)
            dst = args[0] if into else out
            if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                    and src.device.type == "cpu" and dst.device.type == "cuda"):
                self.copies.append((str(func), src.numel() * src.element_size()))
            return out

    with Phase("10 device fault field and device-mask engines, full width"):
        n_arena = runs["single-rail"]["arena_words"]
        n_multi = runs["multi-rail"]["arena_words"]
        interval_words = (STREAM_PAGES + 1) * paged["breakdown"]["words_per_page"]
        key = faultsim.philox_key(0xECC ^ 0xF00D)  # both 32-bit halves nonzero
        # the copy check sees an arena-size copy from the host
        arena_host = torch.from_numpy(np.zeros(n_arena, np.int32))
        with HostToDevice() as h2d:
            arena_host.to(dev)
        require(h2d.copies and max(b for _, b in h2d.copies) == 4 * n_arena,
                f"the copy check missed a host copy: {h2d.copies}")
        print(f"  copy check on a {4 * n_arena}-byte host-to-device copy: {h2d.copies}")
        del arena_host
        # a. the engines of phases 4-5 with device masks
        for multi in (False, True):
            name = "device-multi-rail" if multi else "device-single-rail"
            host_name = "multi-rail" if multi else "single-rail"
            run = device_runs[name] = {}
            ops.reset_launch_count()
            with Tally() as tally:
                tally._wrap(PlaneStore, "group_masks", lambda store, v, *a, **kw: [
                    "field_draws" for g in store.groups if any(
                        store.domain_profile(store.slots[si].domain).fault_rate(float(
                            (v if isinstance(v, dict) else dict.fromkeys(store.domains, v))
                            [store.slots[si].domain])) > 0.0 for si in g.slot_ids)])
                tally._wrap(PlaneStore, "set_voltage_async", "store_steps")
                tally._wrap(PlaneStore, "set_rails_async", "store_steps")
                t = time.perf_counter()
                rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                        fault_model=FaultModelConfig(mask_source="device"),
                                        rails=RailsConfig(multi_rail=multi, start_v=0.62))
                eng = ServingEngine(cfg, params, rel=rel, max_len=64)
                torch.cuda.synchronize()
                run["build_s"] = time.perf_counter() - t
                groups = len(eng._store.groups)
                before = ops.launch_counts()["fault_field"]
                run["step_056_s"] = wall_ms(lambda: eng.set_voltage(0.56)) / 1e3
                step_launches = ops.launch_counts()["fault_field"] - before
                require(step_launches == groups, f"{name}: {step_launches} field launches in a "
                        f"0.56 V step of {groups} groups")
                run["scrub_056"] = (eng._last_scrub.total() if multi else eng._last_scrub).to_dict()
                require(run["scrub_056"]["faulty_bits"] > 0, f"{name}: no fault at 0.56 V")
                before = ops.launch_counts()["fault_field"]
                run["step_nominal_s"] = wall_ms(lambda: eng.set_voltage(1.0)) / 1e3
                require(ops.launch_counts()["fault_field"] == before,
                        f"{name}: the field launched at nominal")
                # no copy of arena size from the host: every PyTorch copy of
                # the step
                with HostToDevice() as h2d:
                    eng.set_voltage(0.56)
                require(all(b < 1 << 20 for _, b in h2d.copies),
                        f"{name}: host-to-device copies in a device-mask step: {h2d.copies}")
                run["htod_copies"] = h2d.copies
                if not multi:
                    eng.set_voltage(eng.controller.voltage)
                t = time.perf_counter()
                lock, hist = eng.autotune_voltage()
                torch.cuda.synchronize()
                run["autotune_s"] = time.perf_counter() - t
                require(eng.controller.locked, f"{name} walk did not lock")
                run["lock"] = lock
                run["history"] = ({d: [(r.voltage, r.detected, r.action) for r in h]
                                   for d, h in hist.items()} if multi
                                  else [(r.voltage, r.detected, r.action) for r in hist])
                final = ([eng._last_scrub[d] for d in eng._store.domains] if multi
                         else [eng._last_scrub])
                require(all(s.detected == 0 for s in final), f"{name}: DED in the final scrub")
                toks_ = eng.generate(prompts, NEW_TOKENS)
                require(toks_.shape == (BATCH, NEW_TOKENS)
                        and bool(((toks_ >= 0) & (toks_ < cfg.vocab)).all()), "token range")
                run["agreement_at_lock_with_nominal"] = float(
                    (toks_ == nominal_tokens[host_name]).mean())
                run["power_report"] = eng.power_report()
            counts, n_ = ops.launch_counts(), tally.n
            steps = n_.get("store_steps", 0)
            per_fwd = 7 * cfg.n_layers
            want = {"inject_scrub": 0 if multi else steps,
                    "inject_scrub_domains": steps if multi else 0,
                    "decode": steps if multi else 0,
                    "ecc_matmul": per_fwd * (n_["prefill"] + n_["decode"]),
                    "encode": n_["packs"], "gather_scrub": 0, "inject": 0,
                    "fault_field": n_.get("field_draws", 0)}
            require(counts == want, f"{name} launches {counts}, expected {want}")
            require(n_["plain_on_card"] == 0, "the plain codec ran on the card")
            run.update(launches=counts, voltage_steps=steps, field_draws=n_.get("field_draws", 0))
            paths_extra[name] = {
                "launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
                "kv_codec": None, "matmuls_per_forward": per_fwd,
                "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                             "decode_kernel": n_["decode_kernel"]},
                "packs": n_["packs"], "commits": 0, "voltage_steps": steps}
            hrun = runs[host_name]
            host_056 = (f"; host masks, phase 4: {hrun['0.56V']['step_s'] * 1e3:.1f} ms"
                        if "0.56V" in hrun else "")
            print(f"  {name}: built in {run['build_s']:.2f} s; 0.56 V step "
                  f"{run['step_056_s'] * 1e3:.2f} ms ({step_launches} field launch(es)"
                  f"{host_056}), nominal step {run['step_nominal_s'] * 1e3:.2f} ms; scrub "
                  f"{run['scrub_056']}")
            print(f"  {name}: autotune lock {json.dumps(lock)} in {run['autotune_s']:.3f} s "
                  f"(host masks, phase {4 + multi}: lock {json.dumps(hrun['lock'])} in "
                  f"{hrun['autotune_s']:.1f} s); final scrub DED-free; tokens at the lock agree "
                  f"with nominal {run['agreement_at_lock_with_nominal']:.3f}")
            print(f"  {name}: history {json.dumps(run['history'])}")
            print(f"  {name}: host-to-device copies in a 0.56 V step: "
                  f"{json.dumps(run['htod_copies'])}")
            print(f"  {name} launches: {json.dumps(counts)} = {steps} voltage steps, "
                  f"{n_.get('field_draws', 0)} field draws, {n_['packs']} packs, "
                  f"{per_fwd} fused matmuls x ({n_['prefill']} + {n_['decode']}) forwards")
            if multi:
                # the per-word rates the store hands its field at mixed
                # rails, the embedding's above V_min (rate 0), kept with the
                # field's row factor and key for part b
                store = eng._store
                require(len(store.groups) == 1, f"{name}: {len(store.groups)} codec groups")
                field_ = store.groups[0].field
                require(set(store.domains) == set(MIXED_RAILS),
                        f"{name}: domains {store.domains}")
                kept = []
                field_.masks_for_rates = kept.append
                store.group_masks(MIXED_RAILS)
                del field_.masks_for_rates
                require(len(kept) == 1 and kept[0].shape == (n_multi,),
                        f"{name}: the store drew no per-word rates")
                store_draw = (field_.f_row, kept[0], field_.key)
                del store, field_, kept
            del eng
            torch.cuda.empty_cache()

        # b. the kernel against its plain version, bit for bit: every width,
        # scalar and per-word rates (a third of the words at rate 0, a third
        # at another rail), several sizes
        r056, r054 = platform.fault_rate(0.56), platform.fault_rate(0.54)
        checked = 0
        for n in FIELD_SIZES:
            f_row = faultsim.row_factor(n, platform.row_sigma, 0x5EED + n, dev)
            rates = torch.full((n,), r054, device=dev)
            rates[n // 3: 2 * n // 3] = 0.0
            rates[2 * n // 3:] = r056
            for nc in FIELD_N_CHECKS:
                for rate in (r054, rates):
                    got = ops.fault_field(f_row, rate, key, nc)
                    want = ref.fault_field_ref(f_row, rate, key, nc)
                    require(all(same_bits(a, b) for a, b in zip(got, want)),
                            f"fault field n={n} n_check={nc} "
                            f"{'per-word' if isinstance(rate, torch.Tensor) else 'scalar'}")
                    if isinstance(rate, torch.Tensor) and n >= 3:
                        require(not any(m_[n // 3: 2 * n // 3].any() for m_ in got),
                                "a word at rate 0 drew a fault")
                    checked += 1
        print(f"  fault field: kernel = plain version bit for bit in {checked} cases "
              f"(n in {FIELD_SIZES}, n_check in {FIELD_N_CHECKS}, scalar rate and per-word "
              f"rates with a zero range)")
        sass = sass_sizes()
        print(f"  SASS instructions per kernel (n_check[/rates]): {json.dumps(sass)}")
        # the kernel against its plain version at the main path's sizes, bit
        # for bit (the single-rail arena, a KV interval, and the multi-rail
        # store's own field at mixed rails), and times and bounds per width
        f55 = faultsim.row_factor(n_arena, platform.row_sigma, 0xECC, dev)
        f_int = f55[:interval_words]
        f_multi, rates_multi, key_multi = store_draw
        drawn55, drawn_int = drawn_words(f55, r056), drawn_words(f_int, r056)
        drawn_multi = drawn_words(f_multi, rates_multi)

        def plain_kept(*args):
            """(the plain version's masks, its device time) from one call."""
            box = []
            ms = sync_ms(lambda: box.append(ref.fault_field_plain(*args, chunk_words=1 << 22)),
                         iters=1, warmup=0)
            return box[-1], ms

        for nc in FIELD_N_CHECKS:
            codec = next(c for c in codes.names() if codes.get(c).n_check == nc)
            name = "fault_field" if codec == "secded72" else f"fault_field_{codec}"
            row = {**field_bound(n_arena, drawn55, nc, False), "codec": codec,
                   "library_ms": None,
                   "sass_instructions": sass.get(str(nc), {}).get("instructions")}
            errs = {}
            for size, f_, rate_, key_ in (("arena", f55, r056, key),
                                          ("interval", f_int, r056, key),
                                          ("multi_rail", f_multi, rates_multi, key_multi)):
                want, plain_ms = plain_kept(f_, rate_, key_, nc)
                errs[size] = mask_err(ops.fault_field(f_, rate_, key_, nc), want)
                require(errs[size] == 0.0, f"{name} at the {size} size: kernel differs from "
                        f"its plain version by {errs[size]}")
                row["plain_ms" if size == "arena" else f"plain_ms_{size}"] = plain_ms
            row["max_abs_err"] = max(errs.values())
            row["max_abs_err_by_size"] = errs
            row["ms"] = sync_ms(lambda: ops.fault_field(f55, r056, key, nc), iters=10)
            row["ms_interval"] = sync_ms(lambda: ops.fault_field(f_int, r056, key, nc), iters=20)
            row["interval"] = field_bound(interval_words, drawn_int, nc, False)
            row["ms_multi_rail"] = sync_ms(
                lambda: ops.fault_field(f_multi, rates_multi, key_multi, nc), iters=5)
            row["multi_rail"] = field_bound(n_multi, drawn_multi, nc, True)
            report[name] = row
            print(f"  {name} at 0.56 V: kernel = plain version bit for bit at {n_arena}, "
                  f"{interval_words} and {n_multi} words; {n_arena} words {row['ms']:.3f} ms "
                  f"(bound {row['bound_ms']:.3f} ms, {row['bound_by']}; bytes "
                  f"{row['bytes_ms']:.3f}, integer ops {row['ops_ms']:.3f}), plain "
                  f"{row['plain_ms']:.1f} ms; {interval_words} words (a KV interval) "
                  f"{row['ms_interval']:.4f} ms (bound {row['interval']['bound_ms']:.4f}), plain "
                  f"{row['plain_ms_interval']:.2f} ms; {n_multi} words, the store's per-word "
                  f"rates at {json.dumps(MIXED_RAILS)} ({drawn_multi} words drawn) "
                  f"{row['ms_multi_rail']:.3f} ms (bound {row['multi_rail']['bound_ms']:.3f}), "
                  f"plain {row['plain_ms_multi_rail']:.1f} ms")
        draw_ms = {c: min(wall_ms(lambda: faultsim.interval_masks(
            0, 1, interval_words, r056, platform.row_sigma, codes.get(c).n_check))
            for _ in range(3)) for c in ("secded72", "ileave88")}
        device_runs["interval_draw_wall_ms"] = draw_ms
        print(f"  interval_masks at 0.56 V, {interval_words} words (row factor + kernel), wall: "
              f"{json.dumps(draw_ms)} ms")
        del f_row, rates, got, want, f_int, f_multi, rates_multi
        torch.cuda.empty_cache()

        # c. the device field against the host field (the model's oracle)
        stats_rows = []
        host = faultsim.FaultField(platform, FIELD_STATS_WORDS, seed=11)
        dfield = faultsim.DeviceFaultField(platform, FIELD_STATS_WORDS, seed=11)
        for v in (0.56, 0.55, 0.54):
            hc = faultsim.gather_masks([(host, v)])[0].flip_counts()
            dc = faultsim.flip_counts(*dfield.masks(v))
            frac = lambda ge2, ge1: float(ge2) / max(float(ge1), 1.0)
            h_frac = frac((hc >= 2).sum(), (hc >= 1).sum())
            d_frac = frac((dc >= 2).sum(), (dc >= 1).sum())
            ratio = float(dc.sum()) / float(hc.sum())
            require(hc.sum() > 100 and 0.6 < ratio < 1.6,
                    f"device/host flips at {v} V: {int(dc.sum())} / {int(hc.sum())}")
            require(abs(h_frac - d_frac) < 0.1, f"multi-bit share at {v} V: {d_frac} vs {h_frac}")
            stats_rows.append({"voltage": v, "host_flips": int(hc.sum()),
                               "device_flips": int(dc.sum()), "ratio": ratio,
                               "host_multibit_share": h_frac, "device_multibit_share": d_frac})
        device_runs["statistics"] = stats_rows
        print(f"  statistics over {FIELD_STATS_WORDS} words (device / host flips in 0.6-1.6, "
              f"multi-bit share within 0.1): {json.dumps(stats_rows)}")
        del host, dfield

        # d. FIP at full arena width
        field = faultsim.DeviceFaultField(platform, n_arena, seed=0)
        prev = None
        for v in (0.58, 0.57, 0.56, 0.55, 0.54):
            cur = field.masks(v)
            if prev is not None:
                require(not any(bool((p_ & ~c_).any()) for p_, c_ in zip(prev, cur)),
                        f"FIP broken between {v + 0.01:.2f} and {v} V")
            prev = cur
        require(not any(m_.any() for m_ in field.masks(0.8)), "faults inside the guardband")
        fip_flips = int(faultsim.flip_counts(*prev).sum())
        print(f"  FIP holds 0.58 -> 0.54 V over {n_arena} words ({fip_flips} flips at 0.54 V); "
              f"none at 0.8 V")
        del field, prev, cur
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 11
    # The flight recorder on phase 6's stream: recorder off against on,
    # two traced runs byte for byte, the schema, and the dispatch profiler.
    with Phase("11 flight recorder, full width"):
        from repro_torch.obs import KernelProfiler, TraceRecorder, validate_events
        from repro_torch.obs import profile as obs_profile

        dparams = lm.init_params(dcfg, seed=1, device=dev)

        def recorder_run(recorder, profiler=None):
            """Phase 6's engine built with ``recorder``; the stream at a 0.56 V
            kv rail in STREAM_PAGES pages with the prefix trie on, then a
            speculative serve of the shared-prefix requests (a scrub every 4
            steps, so blocks of 4 tokens verify). Launch counts
            and the path's tally from the engine build to the last serve."""
            ops.reset_launch_count()
            if profiler is not None:
                obs_profile.enable(profiler)
            try:
                with Tally() as tally:
                    eng_ = ServingEngine(cfg, params, rel=ReliabilityConfig(mode="inline",
                                                                            voltage=1.0),
                                         max_len=PAGED_MAX_LEN, recorder=recorder)
                    torch.cuda.synchronize()
                    walls_, reps_ = {}, {}
                    for key_, kw_ in (
                            ("stream", dict(requests=stream, n_pages=STREAM_PAGES)),
                            ("speculative", dict(requests=shared_reqs, speculative=4,
                                                 scrub_interval=4, draft_params=dparams,
                                                 draft_cfg=dcfg))):
                        t_ = time.perf_counter()
                        reps_[key_] = eng_.serve(kw_.pop("requests"), n_lanes=4, kv_voltage=0.56,
                                                 share_prefix=True, **kw_)
                        torch.cuda.synchronize()
                        walls_[key_] = time.perf_counter() - t_
            finally:
                obs_profile.disable()
            del eng_
            torch.cuda.empty_cache()
            return {"reps": reps_, "walls": walls_, "tally": tally,
                    "launches": ops.launch_counts(), "by_codec": ops.launch_counts_by_codec()}

        def serve_view(rep_):
            return {"outputs": {r: rep_.outputs[r].tolist() for r in sorted(rep_.outputs)},
                    "kv_counters": rep_.kv_stats.counters().tolist(),
                    "kv_voltages": rep_.kv_voltages, "steps": rep_.steps,
                    "preemptions": rep_.preemptions}

        rec_on, rec_again, prof = TraceRecorder(), TraceRecorder(), KernelProfiler()
        off = recorder_run(None)
        on = recorder_run(rec_on)
        check_paged_launches("recorder", on["tally"], on["launches"], multi=False)
        again = recorder_run(rec_again, profiler=prof)
        # a. recorder off against on: tokens, counters, rail walk, steps, launches
        for key_ in ("stream", "speculative"):
            require(serve_view(off["reps"][key_]) == serve_view(on["reps"][key_]),
                    f"{key_}: the recorder changed the serve")
            require(serve_view(on["reps"][key_]) == serve_view(again["reps"][key_]),
                    f"{key_}: the profiled serve differs")
        require(off["launches"] == on["launches"] == again["launches"]
                and off["by_codec"] == on["by_codec"] == again["by_codec"],
                f"launches off {off['by_codec']} / on {on['by_codec']} / profiled "
                f"{again['by_codec']}")
        srep_, prep_ = on["reps"]["stream"], on["reps"]["speculative"]
        require(srep_.preemptions >= 1, f"no preemption with {STREAM_PAGES} pages")
        require(srep_.kv_stats.corrected > 0, f"no corrected word at 0.56 V: {srep_.kv_stats}")
        require(prep_.spec_dispatches > 0 and prep_.prefix_hit_tokens > 0,
                "the speculative serve ran no verify block or no prefix hit")
        print(f"  recorder off = on = on + profiler: equal tokens, kv counters, kv voltages, "
              f"steps (stream {srep_.steps}, {srep_.preemptions} preemption(s); speculative "
              f"{prep_.steps}, {prep_.spec_dispatches} verify blocks) and launches "
              f"{json.dumps(on['by_codec'])}")
        # b. two traced runs, byte for byte; the schema
        jsonl = rec_on.to_jsonl()
        require(jsonl == rec_again.to_jsonl(), "two traced runs gave different JSONL")
        events_ = [json.loads(line_) for line_ in jsonl.splitlines()]
        require(validate_events(events_) == len(rec_on.events) > 0, "schema")
        begins = [i for i, e in enumerate(events_) if e["kind"] == "serve_begin"]
        kinds_by_serve = {}
        for key_, lo_, hi_ in zip(("stream", "speculative"), begins, begins[1:] + [None]):
            kinds_ = {}
            for e in events_[lo_:hi_]:
                kinds_[e["kind"]] = kinds_.get(e["kind"], 0) + 1
            rep_, n_req = on["reps"][key_], len(stream if key_ == "stream" else shared_reqs)
            require(kinds_["admit"] == n_req + rep_.preemptions
                    and kinds_["retire"] == n_req == len(rep_.outputs)
                    and kinds_.get("preempt", 0) == rep_.preemptions
                    and kinds_["kv_scrub"] == len(rep_.kv_voltages)
                    and kinds_["gauge"] == 3 * len(rep_.kv_voltages)
                    and kinds_.get("spec_block", 0) == rep_.spec_dispatches,
                    f"{key_} events {kinds_}")
            kinds_by_serve[key_] = dict(sorted(kinds_.items()))
        # the clock is decode progress: the stream's serve_end sits at its steps
        ends = [e["step"] for e in events_ if e["kind"] == "serve_end"]
        require(ends[0] == srep_.steps and all(
            a_["step"] <= b_["step"] for a_, b_ in zip(events_, events_[1:])), f"clock {ends}")
        print(f"  two traced runs: byte-identical JSONL ({len(jsonl)} bytes, "
              f"{len(events_)} events, schema valid); events by kind {json.dumps(kinds_by_serve)}")
        # c. the dispatch profiler: CUDA-event rows, tagged cuda
        rows = prof.to_rows()
        names = {r["name"] for r in rows}
        want_rows = {"decode.prefill", "decode.multistep", "decode.chunk_prefill",
                     "decode.spec_multistep", "kv.inject_masks", "kv.commit_tokens",
                     "kv.paged_gather_scrub"}
        require(want_rows <= names, f"profiler rows {sorted(names)}")
        require(all(r["backend"] == "cuda" for r in rows), f"profiler backends {rows}")
        for r in rows:
            print(f"  profile {r['name']}: {r['calls']} calls, mean {r['mean_ms']:.3f} ms, "
                  f"min {r['min_ms']:.3f}, max {r['max_ms']:.3f} ({r['backend']}, CUDA events)")
        for g in prof.gauge_rows():
            print(f"  profile gauge {g['name']}: n {g['n']}, mean {g['mean']:.3f}, "
                  f"min {g['min']:.3f}, max {g['max']:.3f}")
        recorder_report = {
            "walls_s": {"off": off["walls"], "on": on["walls"], "profiled": again["walls"]},
            "traced_over_untraced": {k: off["walls"][k] / on["walls"][k] for k in off["walls"]},
            "events": kinds_by_serve, "jsonl_bytes": len(jsonl), "profile": rows,
            "profile_gauges": prof.gauge_rows(), "gpu": gpu_line()}
        print(f"  serve wall s (not gated): untraced {json.dumps(off['walls'])}, traced "
              f"{json.dumps(on['walls'])}, traced + profiler {json.dumps(again['walls'])}; "
              f"untraced / traced {json.dumps(recorder_report['traced_over_untraced'])} "
              f"| {gpu_line()}")
        print(f"  recorder {json.dumps(recorder_report)}")
        del off, on, again, dparams, srep_, prep_
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 12
    # Codec escalation: the rail's ladder through the re-protected stores
    # (path E: an escalating autotune with device masks, then a walk_kv
    # stream whose kv rail escalates), change_codec at full size, and the
    # scrub harvest's two orders.
    esc_run = {}
    with Phase("12 codec escalation, full width"):
        from repro_torch.core.kvpages import SharedPageDEDError
        from repro_torch.obs import KernelProfiler, TraceRecorder
        from repro_torch.obs import profile as obs_profile

        ladder = ("secded72", "dected79")
        per_fwd = 7 * cfg.n_layers

        def step_keys(eng_, volts):
            """What one rail step of ``eng_`` launches, by codec: the domain
            inject+scrub per codec group, the decode of the embedding and of
            every other leaf under a code other than SECDED, and the SECDED
            re-encode of those other leaves."""
            keys = []
            for g in eng_._store.groups:
                keys.append(f"b2:{g.name}")
                for si in g.slot_ids:
                    if "embed" in eng_._store.slots[si].key:
                        keys.append(f"b5:{g.name}")
                    elif g.name != "secded72":
                        keys += [f"b5:{g.name}", "refresh:secded72"]
            return keys

        def field_keys(store, v, *a, **kw):
            """One field launch per codec group with a domain below V_min."""
            volts = v if isinstance(v, dict) else dict.fromkeys(store.domains, v)
            return [f"field:{g.name}" for g in store.groups if any(
                store.domain_profile(store.slots[si].domain).fault_rate(
                    float(volts[store.slots[si].domain])) > 0.0 for si in g.slot_ids)]

        def rebuild_keys(store):
            """A regrouping encodes each group's check plane under its code
            (a lone SECDED group aliases the packed planes)."""
            names = sorted({store.codec_of(s.domain) for s in store.slots})
            return [] if names == ["secded72"] else [f"rebuild:{c}" for c in names]

        changes_at = []  # the path's tally when the arena's code first changes
        real_change = KVPageArena.change_codec

        def change_codec(self_, codec, shared_pages=None):
            if codec != self_.codec_name and not changes_at:
                changes_at.append({k: v for k, v in tally.n.items() if ":" in k})
            return real_change(self_, codec, shared_pages)

        # a. the escalating autotune and the walk_kv stream (path E)
        ops.reset_launch_count()
        rec = TraceRecorder()
        prof = KernelProfiler()
        KVPageArena.change_codec = change_codec
        try:
            with Tally() as tally:
                tally._wrap(ServingEngine, "set_rails", step_keys)
                tally._wrap(PlaneStore, "group_masks", field_keys)
                tally._wrap(PlaneStore, "_build_groups", rebuild_keys)
                for name_ in ("kvpages", "steps"):
                    tally._wrap(kvpages if name_ == "kvpages" else serve_steps, "_commit_tokens",
                                lambda *a, codec, **kw: f"commit:{codec}")
                tally._wrap(KVPageArena, "tick", lambda a_: f"interval:{a_.codec_name}")
                tally._wrap(KVPageArena, "_masks", lambda a_, r_: f"draw:{a_.codec_name}")
                tally._wrap(KVPageArena, "scrub_pages",
                            lambda a_, ids_: f"scrub:{a_.codec_name}")
                t = time.perf_counter()
                rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                        fault_model=FaultModelConfig(mask_source="device"),
                                        rails=RailsConfig(multi_rail=True, start_v=0.62),
                                        protection=ProtectionConfig(escalation=ladder))
                eng = ServingEngine(cfg, params, rel=rel, max_len=PAGED_MAX_LEN, recorder=rec)
                torch.cuda.synchronize()
                esc_run["build_s"] = time.perf_counter() - t
                t = time.perf_counter()
                lock, hist = eng.autotune_voltage()
                torch.cuda.synchronize()
                esc_run["autotune_s"] = time.perf_counter() - t
                require(all(eng.controller.rails[d].locked for d in eng._store.domains),
                        "the escalating walk did not lock")
                esc_run["history"] = {d: [(r.voltage, r.detected, r.action, r.codec) for r in h]
                                      for d, h in hist.items()}
                escalated = {}
                for d, h in hist.items():
                    for i, r in enumerate(h):
                        if r.action == "escalate":
                            require(i > 0 and r.voltage == h[i - 1].voltage,
                                    f"{d} escalated at {r.voltage} V: {esc_run['history'][d]}")
                            escalated.setdefault(d, []).append((r.voltage, r.codec))
                require(escalated, f"no arena rail escalated: {esc_run['history']}")
                store_codecs = {d: eng._store.codec_of(d) for d in eng._store.domains}
                rail_codecs = {d: eng.controller.rails[d].codec for d in eng._store.domains}
                require(store_codecs == rail_codecs,
                        f"store codecs {store_codecs} != rail codecs {rail_codecs}")
                pr = esc_run["power_report"] = eng.power_report()
                require(pr["check_bits"] == {d: codes.get(c).n_check
                                             for d, c in pr["codecs"].items()}
                        and {d: pr["codecs"][d] for d in rail_codecs} == rail_codecs,
                        f"power_report {pr['codecs']} {pr['check_bits']}")
                # a regrouped domain draws from its new group's field, so the
                # final scrub at the lock is printed, not required clean
                esc_run.update(lock=lock, escalated=escalated, codecs=rail_codecs,
                               groups={g.name: len(g.slot_ids) for g in eng._store.groups},
                               final_scrub={d: eng._last_scrub[d].to_dict()
                                            for d in eng._store.domains})
                print(f"  autotune (device masks, ladder {ladder}): lock {json.dumps(lock)} in "
                      f"{esc_run['autotune_s']:.3f} s; escalations {json.dumps(escalated)}; "
                      f"codecs {json.dumps(rail_codecs)} = the store's; groups "
                      f"{json.dumps(esc_run['groups'])}; final scrub "
                      f"{json.dumps(esc_run['final_scrub'])}")
                print(f"  history (V, detected, action, codec) {json.dumps(esc_run['history'])}")
                print(f"  power_report {json.dumps(pr)}")
                # the stream, its kv rail walked from V_min under the ladder
                obs_profile.enable(prof)
                try:
                    t = time.perf_counter()
                    erep = eng.serve(stream, n_lanes=4, walk_kv=True, share_prefix=True,
                                     n_pages=STREAM_PAGES)
                    torch.cuda.synchronize()
                    esc_run["stream_s"] = time.perf_counter() - t
                finally:
                    obs_profile.disable()
        finally:
            KVPageArena.change_codec = real_change
        counts, by_codec, n_ = ops.launch_counts(), ops.launch_counts_by_codec(), tally.n
        kv = eng.controller.rails["kv"]
        events = [json.loads(line_) for line_ in rec.to_jsonl().splitlines()]
        kinds = {}
        for e in events:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        kv_changes = [e["codec"] for e in events if e["kind"] == "kv_codec_change"]
        require(sorted(erep.outputs) == list(range(len(stream))) and all(
            len(erep.outputs[i]) == n for i, (_, n) in enumerate(stream)),
            "the escalating stream did not finish every request at its length")
        require(kv_changes and erep.arena.codec_name == kv.codec == kv_changes[-1] == "dected79",
                f"kv codec changes {kv_changes}, arena {erep.arena.codec_name}, rail {kv.codec}")
        # the None mode took the serialized path: the deferred harvest alone
        # leaves the overlap gauge
        require(not prof.gauge_rows(), f"scrub_overlap=None under a ladder deferred: "
                f"{prof.gauge_rows()}")
        old_, new_ = "secded72", "dected79"
        require(len(changes_at) == 1 and not any(
            changes_at[0].get(f"{k}:{new_}") for k in ("commit", "interval", "scrub")),
            f"kv commits or scrubs under {new_} before the change: {changes_at}")
        for key_ in ("commit", "interval"):
            require(n_.get(f"{key_}:{old_}", 0) > 0 and n_.get(f"{key_}:{new_}", 0) > 0,
                    f"{key_}s by code {json.dumps({k: v for k, v in n_.items() if ':' in k})}")
        epr = eng.power_report()
        require(epr["codecs"]["kv"] == new_ and epr["check_bits"]["kv"] == codes.get(new_).n_check,
                f"kv power under {epr['codecs']['kv']} ({epr['check_bits']['kv']} check bits)")
        # path E's launches, by codec, from its tally
        cs = sorted(codes.names())
        get = lambda k_: n_.get(k_, 0)
        want_codec = {
            "inject_scrub": {},
            "inject_scrub_domains": {c: get(f"b2:{c}") for c in cs},
            "decode": {c: get(f"b5:{c}") for c in cs},
            "encode": {c: (n_["packs"] if c == "secded72" else 0) + get(f"refresh:{c}")
                       + get(f"rebuild:{c}") + get(f"commit:{c}") + kv_changes.count(c)
                       for c in cs},
            "gather_scrub": {c: get(f"interval:{c}") + get(f"scrub:{c}") for c in cs},
            "fault_field": {c: get(f"field:{c}") + get(f"draw:{c}") for c in cs},
        }
        want_total = {k: sum(v.values()) for k, v in want_codec.items()}
        want_total.update(ecc_matmul=per_fwd * (n_["prefill"] + n_["decode"]), inject=0)
        require(n_["packs"] == per_fwd + 1 and n_["plain_on_card"] == 0, f"escalation tally {n_}")
        codec_launch_check("escalation", counts, by_codec, want_codec,
                           {k: want_total[k] for k in counts})
        commits_by_codec = {c: get(f"commit:{c}") for c in cs if get(f"commit:{c}")}
        paths_extra["escalation"] = {
            "launches": counts, "launches_by_codec": by_codec, "kv_codec": None,
            "commits_by_codec": commits_by_codec, "matmuls_per_forward": per_fwd,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_["decode_kernel"]},
            "packs": n_["packs"], "commits": sum(commits_by_codec.values()),
            "voltage_steps": sum(get(f"b2:{c}") for c in cs)}
        n_tok = sum(len(v) for v in erep.outputs.values())
        esc_run["stream"] = {
            "wall_s": esc_run["stream_s"], "tokens": n_tok, "steps": erep.steps,
            "preemptions": erep.preemptions, "kv_changes": kv_changes,
            "kv_history": [(r.voltage, r.corrected, r.detected, r.action, r.codec)
                           for r in kv.history],
            "kv_stats": erep.kv_stats.to_dict(), "events": {k: kinds.get(k, 0) for k in (
                "codec_escalate", "kv_codec_change", "shared_ded_recovery", "trie_evict",
                "preempt")},
            "by_code": {k: v for k, v in n_.items() if ":" in k}, "power_report": epr,
            "tally_at_change": changes_at[0],
            "profile": {r["name"]: (r["calls"], r["mean_ms"]) for r in prof.to_rows()}}
        print(f"  stream of {len(stream)} requests (walk_kv, prefix trie on, {STREAM_PAGES} "
              f"pages): {n_tok} tokens in {esc_run['stream_s']:.2f} s (profiled dispatches), "
              f"{erep.steps} steps, {erep.preemptions} preemption(s); kv codec changes "
              f"{kv_changes}; events {json.dumps(esc_run['stream']['events'])}")
        print(f"  kv walk (V, corrected, detected, action, codec) "
              f"{json.dumps(esc_run['stream']['kv_history'])}")
        print(f"  by code: {json.dumps(esc_run['stream']['by_code'])}; at the kv change "
              f"{json.dumps(changes_at[0])}; scrub_overlap=None ran serialized (no overlap "
              f"gauge); kv power under {new_}: {json.dumps(epr)}")
        del eng, erep
        torch.cuda.empty_cache()

        # b. change_codec at full size: the kernel checks' 64-page arena,
        # committed payload, from secded72 to each other code
        geom = KVGeometry.from_config(cfg)
        wpp = geom.words_per_page
        n_tok_kv = KV_PAGES * geom.page_tokens
        gen = torch.Generator(device=dev).manual_seed(23)
        payload = torch.randn(n_tok_kv, geom.token_f32, device=dev, generator=gen)
        pages_kv = np.repeat(np.arange(KV_PAGES), geom.page_tokens)
        slots_kv = np.tile(np.arange(geom.page_tokens), KV_PAGES)
        word = 5 * wpp + wpp // 3  # on page 5
        esc_run["change_codec"] = {}
        for dst in ("parity65", "ileave88", "dected79"):
            arena = KVPageArena(geom, platform, KV_PAGES, seed=0, device=dev)
            arena.commit_tokens(payload, pages_kv, slots_kv)
            arena.hi[word] ^= 0b11  # uncorrectable under secded72
            saved = [p_.clone() for p_ in (arena.lo, arena.hi, arena.parity)]
            try:
                arena.change_codec(dst, shared_pages=[3, 5, 7])
                raise AssertionError(f"change_codec to {dst} over a latched DED did not refuse")
            except SharedPageDEDError as err:
                require(err.pages == (5,) and err.codec == dst, f"refused with {err}")
            require(arena.codec_name == "secded72" and all(
                same_bits(a_, b_) for a_, b_ in zip((arena.lo, arena.hi, arena.parity), saved)),
                f"a refused change to {dst} changed the arena")
            _, cnt_ = arena.scrub_pages([5])
            require(int(cnt_[0, 2]) == 1, f"the DED on page 5 is no longer latched: {cnt_[0]}")
            arena.hi[word] ^= 0b11  # clean again
            before = ops.launch_counts_by_codec()
            torch.cuda.synchronize()
            t = time.perf_counter()
            arena.change_codec(dst, shared_pages=[3, 5, 7])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            after = ops.launch_counts_by_codec()
            delta = {k: {c: after[k].get(c, 0) - before[k].get(c, 0) for c in after[k]
                         if after[k].get(c, 0) != before[k].get(c, 0)} for k in after}
            require(delta["encode"] == {dst: 1} and delta["gather_scrub"] == {"secded72": 1}
                    and not any(v for k, v in delta.items()
                                if k not in ("encode", "gather_scrub")),
                    f"change_codec to {dst} launched {delta}")
            require(arena.codec_name == dst
                    and arena.parity.dtype == codes.get(dst).check_torch_dtype,
                    f"{arena.codec_name} {arena.parity.dtype}")
            back, cnt_ = arena.scrub_pages(np.arange(KV_PAGES))
            require(same_bits(back.reshape(n_tok_kv, -1), payload),
                    f"contents under {dst} differ from the committed payload")
            require(int(cnt_[:, 1].sum()) == 0 and int(cnt_[:, 2].sum()) == 0,
                    f"scrub under {dst}: corrected {cnt_[:, 1].sum()}, DED {cnt_[:, 2].sum()}")
            esc_run["change_codec"][dst] = {"wall_ms": wall * 1e3, "launches": delta,
                                            "words": arena.n_words + wpp}
            del arena, saved, back
        del payload
        torch.cuda.empty_cache()
        print(f"  change_codec on the {KV_PAGES}-page arena ({(KV_PAGES + 1) * wpp} words, "
              f"committed payload): refused over a latched DED on shared page 5 (code and "
              f"planes unchanged, the DED still counted), then one encode under the new code "
              f"(+ the flush scrub under secded72), contents bit for bit, no correction, no DED: "
              f"{json.dumps(esc_run['change_codec'])}")

        # c. the scrub harvest's two orders on phase 6's stream, a multi-rail
        # engine walking its kv rail (one fresh engine each)
        overlap_runs = {}
        for mode in (True, False):
            eng = ServingEngine(cfg, params, rel=ReliabilityConfig(
                mode="inline", voltage=1.0, fault_model=FaultModelConfig(mask_source="device"),
                rails=RailsConfig(multi_rail=True, start_v=0.62)), max_len=PAGED_MAX_LEN)
            prof_ = KernelProfiler()
            ops.reset_launch_count()
            obs_profile.enable(prof_)
            try:
                t = time.perf_counter()
                rep_ = eng.serve(stream, n_lanes=4, walk_kv=True, n_pages=STREAM_PAGES,
                                 scrub_overlap=mode)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            finally:
                obs_profile.disable()
            kvr = eng.controller.rails["kv"]
            overlap_runs[mode] = {
                "outputs": {r: rep_.outputs[r].tolist() for r in sorted(rep_.outputs)},
                "kv_counters": rep_.kv_stats.counters().tolist(),
                "kv_voltages": rep_.kv_voltages, "steps": rep_.steps,
                "preemptions": rep_.preemptions,
                "kv_rail": [(r.voltage, r.detected, r.action) for r in kvr.history],
                "launches": ops.launch_counts_by_codec()}
            require(bool(prof_.gauge_rows()) == mode,
                    f"scrub_overlap={mode}: overlap gauge rows {prof_.gauge_rows()}")
            esc_run[f"overlap_{mode}_wall_s"] = wall
            del eng, rep_
            torch.cuda.empty_cache()
        require(overlap_runs[True] == overlap_runs[False],
                "scrub_overlap True and False differ")
        print(f"  scrub_overlap True = False on phase 6's stream (walk_kv): equal tokens, kv "
              f"counters, kv voltages ({len(overlap_runs[True]['kv_voltages'])} intervals), "
              f"steps, kv walk and launches {json.dumps(overlap_runs[True]['launches'])}; the "
              f"deferred harvest ran only under True (overlap gauge); walls (profiled, not "
              f"gated) True {esc_run['overlap_True_wall_s']:.2f} s, False "
              f"{esc_run['overlap_False_wall_s']:.2f} s | {gpu_line()}")
        print(f"  escalation {json.dumps(esc_run)}")

    # ---------------------------------------------------------------- 13
    # Environment scenarios: the fault-field kernel's burst expansion against
    # its plain version, the device burst field against the host burst
    # field, and the engines and phase 6's stream under an environment.
    avionics = scenario.ENVIRONMENTS["avionics"]
    scen_run: dict = {}
    run_words = field_kernel.RUN_WORDS  # the words a run of the burst kernel stores

    def anchored_groups(masks) -> int:
        """Groups of four planes that hold a flip, over every word of the
        (lo, hi, check) masks."""
        total = 0
        for m_ in masks:
            x = m_.to(torch.int64) & 0xFFFFFFFF
            total += sum(int(((x >> (4 * q)) & 0xF).ne(0).sum()) for q in range(8))
        return total

    def burst_bound(f_row, rate, nc, burst, anchors) -> dict:
        """``field_bound``'s bytes (a halo word's f_row and rate are the
        same inputs, read once), and the integer operations the function
        needs on this run's data: one base Philox per group of every drawn
        word, and one Philox per anchored group of four planes for its class
        draw and, for the words before the last, its word draw (``anchors``
        the burst-free masks of the same key). The companion draws, one per
        word with a random double, are left out: a bound may count less. The
        kernel draws the base anchors of each run's halo word (the word
        before the run, ``RUN_WORDS`` words a run) a second time when the
        burst spills across words: this design's choice, not the function's,
        reported apart (``redundant_philox_calls``, ``neighbour_words`` the
        halo words that draw) and not counted."""
        per_word = isinstance(rate, torch.Tensor)
        th = ref.burst_thresholds(burst)
        p = torch.clamp(torch.as_tensor(rate, dtype=torch.float32, device=dev) * f_row, 0.0,
                        faultsim.P_MAX)
        drawn_ = (p * 4294967296.0).to(torch.int64) > 0
        drawn = int(drawn_.sum())
        prev = int(drawn_[run_words - 1:f_row.numel() - 1:run_words].sum()) if th[3] else 0
        cls = anchored_groups(anchors) if th[2] else 0
        word = anchored_groups(tuple(m_[:-1] for m_ in anchors)) if th[3] else 0
        calls = field_groups(nc) * drawn + cls + word
        out = field_bound(f_row.numel(), drawn, nc, per_word)
        out["ops_ms"] = 1e3 * calls * max(FIELD_MULS_PER_GROUP, FIELD_ALU_OPS_PER_GROUP) / int_per_s
        out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
        out["bound_by"] = "bytes" if out["bytes_ms"] >= out["ops_ms"] else "operations"
        out.update(philox_calls=calls, redundant_philox_calls=field_groups(nc) * prev,
                   neighbour_words=prev, class_draws=cls, word_draws=word)
        del out["ops_per_drawn_word"]
        return out

    with Phase("13 environment scenarios, full width"):
        sv = scenario.scenario_voltage(platform, avionics)
        aprof = avionics.scale_profile(platform)
        r_sv = aprof.fault_rate(sv)
        key = faultsim.philox_key(0xECC ^ 0xF00D)
        profiles = {c: scenario.BurstProfile(**{c: 1.0}) for c in (
            "double_adjacent", "triple_adjacent", "random_double", "word_adjacent")}
        profiles.update({f"env_{e}": p_.burst for e, p_ in scenario.ENVIRONMENTS.items()})
        scen_run.update(environment="avionics", scenario_voltage=sv, rate=r_sv)
        print(f"  avionics: scenario voltage {sv} V (flux x{avionics.rate_multiplier}, rate "
              f"{r_sv:.4e}), burst {json.dumps(dataclasses.asdict(avionics.burst))}")
        # a. the burst kernel against its plain version, bit for bit: every
        # width, each single-class profile and each environment's burst,
        # scalar and per-word rates (every third word at rate 0, so spills
        # run from and into words that draw nothing), several sizes; around
        # the kernel's run length, dense anchors (rate 0.1) with each run's
        # halo word, then its first stored word, at rate 0 and at 0.02
        r054, r056 = platform.fault_rate(0.54), platform.fault_rate(0.56)
        edge_sizes = (31, 32, 33, run_words - 1, run_words, run_words + 1,
                      3 * run_words + 5)
        checked = 0
        for n in FIELD_SIZES + edge_sizes:
            f_row = faultsim.row_factor(n, platform.row_sigma, 0xB0057 + n, dev)
            rates = torch.full((n,), r054, device=dev)
            rates[1::3] = 0.0
            rates[2::3] = r056
            cases = [r054, rates]
            if n in edge_sizes:
                for where in (-1, 0):
                    for value in (0.0, 0.02):
                        cases.append(torch.full((n,), 0.1, device=dev))
                        cases[-1][run_words + where::run_words] = value
            for nc in FIELD_N_CHECKS:
                for pname, burst in profiles.items():
                    th = ref.burst_thresholds(burst)
                    for rate in cases:
                        got = ops.fault_field(f_row, rate, key, nc, burst=burst)
                        want = ref.fault_field_plain(f_row, rate, key, nc, th, chunk_words=1 << 22)
                        require(all(same_bits(a, b) for a, b in zip(got, want)),
                                f"burst field n={n} n_check={nc} {pname} "
                                f"{'per-word' if isinstance(rate, torch.Tensor) else 'scalar'}")
                        if n > 4097:
                            free = ops.fault_field(f_row, rate, key, nc)
                            require(all(bool(((f_ & g_) == f_).all()) for f_, g_ in zip(free, got))
                                    and not same(free, got), f"{pname}: not a strict superset")
                        checked += 1
        print(f"  burst field: kernel = plain version bit for bit in {checked} cases (n in "
              f"{FIELD_SIZES + edge_sizes}, n_check in {FIELD_N_CHECKS}, {len(profiles)} burst "
              f"profiles {sorted(profiles)}, scalar rate and per-word rates with every third "
              f"word at 0; at the run edges (run {run_words} words) also rate 0.1 with each run's "
              f"halo word, then its first word, at 0 and at 0.02); at 2^20 + 5 words a strict "
              f"superset of the burst-free masks")
        del f_row, rates, cases, got, want, free
        # b. at the main path's sizes under the avionics burst at its
        # scenario voltage: the single-rail arena, a KV interval and the
        # multi-rail store's field with its per-word rates (the embedding at
        # rate 0); times beside the burst-free kernel's and the bounds
        sass, regs = sass_sizes(), ptxas_registers()
        print(f"  SASS instructions per kernel (n_check[/rates][/burst]): {json.dumps(sass)}")
        print(f"  registers per thread (ptxas): {json.dumps(regs)}")
        f55 = faultsim.row_factor(n_arena, platform.row_sigma, 0xECC, dev)
        f_int = f55[:interval_words]
        f_multi, rates_multi, key_multi = store_draw
        rates_sv = torch.where(rates_multi > 0, torch.full_like(rates_multi, r_sv),
                               torch.zeros_like(rates_multi))
        th = ref.burst_thresholds(avionics.burst)
        for nc in FIELD_N_CHECKS:
            codec = next(c for c in codes.names() if codes.get(c).n_check == nc)
            name = "fault_field_burst" if codec == "secded72" else f"fault_field_burst_{codec}"
            row = {"codec": codec, "library_ms": None,
                   "scenario": {"environment": "avionics", "voltage": sv, "rate": r_sv},
                   "sass_instructions": sass.get(f"{nc}/burst", {}).get("instructions"),
                   "registers": {"scalar_rate": regs.get(f"{nc}/burst"),
                                 "per_word_rates": regs.get(f"{nc}/rates/burst")}}
            errs = {}
            for size, f_, rate_, key_, iters in (("arena", f55, r_sv, key, 10),
                                                 ("interval", f_int, r_sv, key, 20),
                                                 ("multi_rail", f_multi, rates_sv, key_multi, 5)):
                box = []
                plain_ms = sync_ms(lambda: box.append(ref.fault_field_plain(
                    f_, rate_, key_, nc, th, chunk_words=1 << 22)), iters=1, warmup=0)
                got = ops.fault_field(f_, rate_, key_, nc, burst=avionics.burst)
                errs[size] = mask_err(got, box[-1])
                require(errs[size] == 0.0, f"{name} at the {size} size: kernel differs from its "
                        f"plain version by {errs[size]}")
                free = ops.fault_field(f_, rate_, key_, nc)
                require(all(bool(((f2 & g2) == f2).all()) for f2, g2 in zip(free, got)),
                        f"{name} at the {size} size: not a superset of the burst-free masks")
                part = burst_bound(f_, rate_, nc, avionics.burst, free)
                require(part["redundant_philox_calls"] < 0.01 * part["philox_calls"],
                        f"{name} at the {size} size: the halos re-draw "
                        f"{part['redundant_philox_calls']} of {part['philox_calls']} Philox calls")
                part["flips"] = int(faultsim.flip_counts(*got).sum())
                part["flips_burst_free"] = int(faultsim.flip_counts(*free).sum())
                del got, free, box
                part["ms"] = sync_ms(lambda: ops.fault_field(f_, rate_, key_, nc,
                                                             burst=avionics.burst), iters=iters)
                part["ms_burst_free"] = sync_ms(lambda: ops.fault_field(f_, rate_, key_, nc),
                                                iters=iters)
                part["plain_ms"] = plain_ms
                if size == "arena":
                    row.update(part)
                else:
                    row[size] = part
            row["max_abs_err"] = max(errs.values())
            row["max_abs_err_by_size"] = errs
            report[name] = row
            ratio = lambda p_: p_["ms"] / p_["ms_burst_free"]
            print(f"  {name} (avionics burst, {sv} V): kernel = plain version bit for bit, a "
                  f"superset of the burst-free masks, at {n_arena}, {interval_words} and "
                  f"{n_multi} words; {n_arena} words {row['ms']:.3f} ms (burst-free "
                  f"{row['ms_burst_free']:.3f} ms, x{ratio(row):.2f}; bound {row['bound_ms']:.3f} "
                  f"ms, {row['bound_by']}: {row['philox_calls']} Philox calls, "
                  f"the kernel at {row['bound_ms'] / row['ms']:.1%} of it; the halos' "
                  f"re-draws, not counted: {row['redundant_philox_calls']} "
                  f"({row['redundant_philox_calls'] / row['philox_calls']:.2%}), "
                  f"{row['neighbour_words']} halo words), {row['registers']} registers, plain "
                  f"{row['plain_ms']:.1f} ms, flips {row['flips']} vs {row['flips_burst_free']}; "
                  f"KV interval {row['interval']['ms']:.4f} ms (burst-free "
                  f"{row['interval']['ms_burst_free']:.4f}, bound {row['interval']['bound_ms']:.4f}"
                  f"); multi-rail {row['multi_rail']['ms']:.3f} ms (burst-free "
                  f"{row['multi_rail']['ms_burst_free']:.3f}, bound "
                  f"{row['multi_rail']['bound_ms']:.3f})")
        del f55, f_int, f_multi, rates_multi, rates_sv, store_draw
        torch.cuda.empty_cache()

        # c. the device burst field against the host burst field (the
        # reference's stream, bit for bit) at each environment's scenario
        # voltage, phase 10's bounds; FIP and the superset over the arena
        stats_rows = []
        for ename, env in scenario.ENVIRONMENTS.items():
            v_e, prof_e = scenario.scenario_voltage(platform, env), env.scale_profile(platform)
            host = faultsim.FaultField(prof_e, FIELD_STATS_WORDS, seed=11, burst=env.burst)
            dfield = faultsim.DeviceFaultField(prof_e, FIELD_STATS_WORDS, seed=11, burst=env.burst)
            t = time.perf_counter()
            hc = faultsim.gather_masks([(host, v_e)])[0].flip_counts()
            host_s = time.perf_counter() - t
            dc = faultsim.flip_counts(*dfield.masks(v_e))
            frac = lambda ge2, ge1: float(ge2) / max(float(ge1), 1.0)
            h_frac, d_frac = frac((hc >= 2).sum(), (hc >= 1).sum()), frac((dc >= 2).sum(),
                                                                            (dc >= 1).sum())
            ratio = float(dc.sum()) / float(hc.sum())
            require(hc.sum() > 100 and 0.6 < ratio < 1.6,
                    f"{ename}: device/host burst flips {int(dc.sum())} / {int(hc.sum())}")
            require(abs(h_frac - d_frac) < 0.1, f"{ename}: multi-bit share {d_frac} vs {h_frac}")
            stats_rows.append({"environment": ename, "voltage": v_e, "host_flips": int(hc.sum()),
                               "device_flips": int(dc.sum()), "ratio": ratio,
                               "host_multibit_share": h_frac, "device_multibit_share": d_frac,
                               "host_draw_s": host_s})
        scen_run["statistics"] = stats_rows
        print(f"  burst statistics over {FIELD_STATS_WORDS} words at each environment's scenario "
              f"voltage (device / host flips in 0.6-1.6, multi-bit share within 0.1): "
              f"{json.dumps(stats_rows)}")
        del host, dfield
        field = faultsim.DeviceFaultField(aprof, n_arena, seed=0, burst=avionics.burst)
        prev = None
        for v in (sv + 0.02, sv + 0.01, sv, sv - 0.01, sv - 0.02):
            cur = field.masks(v)
            if prev is not None:
                require(not any(bool((p_ & ~c_).any()) for p_, c_ in zip(prev, cur)),
                        f"burst FIP broken at {v} V")
            if v == sv:
                free = faultsim.DeviceFaultField(aprof, n_arena, seed=0).masks(sv)
                require(all(bool(((f_ & c_) == f_).all()) for f_, c_ in zip(free, cur)),
                        "the burst field lost a burst-free flip")
                sv_flips = (int(faultsim.flip_counts(*cur).sum()),
                            int(faultsim.flip_counts(*free).sum()))
                del free
            prev = cur
        print(f"  burst FIP holds {sv + 0.02:.4f} -> {sv - 0.02:.4f} V over {n_arena} words; at "
              f"{sv} V {sv_flips[0]} flips, a superset of the burst-free field's {sv_flips[1]}")
        del field, prev, cur
        torch.cuda.empty_cache()

        # d. full-width single-rail engines with device masks under avionics:
        # secded72 and ileave88 at the scenario voltage, then the autotune
        # from 0.62 V without an environment, under consumer and avionics
        per_fwd = 7 * cfg.n_layers
        rate_of = lambda store, v, si: store.domain_profile(store.slots[si].domain).fault_rate(
            float((v if isinstance(v, dict) else dict.fromkeys(store.domains, v))
                  [store.slots[si].domain]))
        ops.reset_launch_count()
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_voltage",
                        lambda eng_, v: f"steps:{eng_._store.groups[0].name}")
            tally._wrap(PlaneStore, "group_masks", lambda store, v, *a, **kw: [
                k_ for g in store.groups if any(rate_of(store, v, si) > 0.0 for si in g.slot_ids)
                for k_ in (f"draw:{g.name}",) + ((f"burst:{g.name}",) if store._burst else ())])
            steps_ = {}
            for codec in ("secded72", "ileave88"):
                rel = ReliabilityConfig(
                    mode="inline", voltage=1.0, protection=ProtectionConfig(codecs=codec),
                    fault_model=FaultModelConfig(mask_source="device", environment="avionics"))
                eng = ServingEngine(cfg, params, rel=rel, max_len=64)
                steps_[codec] = wall_ms(lambda: eng.set_voltage(sv))
                steps_[codec] = {"step_ms": steps_[codec], "scrub": eng._last_scrub.to_dict()}
                del eng
            sec, ilv = steps_["secded72"]["scrub"], steps_["ileave88"]["scrub"]
            require(ilv["corrected"] > sec["corrected"] and ilv["detected"] < sec["detected"],
                    f"ileave88 does not beat secded72 under avionics: {ilv} vs {sec}")
            locks, hists = {}, {}
            for env in (None, "consumer", "avionics"):
                rel = ReliabilityConfig(
                    mode="inline", voltage=1.0, rails=RailsConfig(start_v=0.62),
                    fault_model=FaultModelConfig(mask_source="device", environment=env))
                eng = ServingEngine(cfg, params, rel=rel, max_len=64)
                eng.set_voltage(eng.controller.voltage)
                lock, hist = eng.autotune_voltage()
                require(eng.controller.locked, f"the {env} walk did not lock")
                require(eng._last_scrub.detected == 0, f"{env}: DED in the final scrub")
                locks[str(env)] = lock
                hists[str(env)] = [(r.voltage, r.detected, r.action) for r in hist]
                if env == "avionics":
                    toks_ = eng.generate(prompts, NEW_TOKENS)
                    require(toks_.shape == (BATCH, NEW_TOKENS)
                            and bool(((toks_ >= 0) & (toks_ < cfg.vocab)).all()), "token range")
                del eng
            require(locks["avionics"] >= locks["None"],
                    f"the avionics lock {locks['avionics']} is below the lock without an "
                    f"environment {locks['None']}")
        n_ = tally.n
        g_ = lambda k_: n_.get(k_, 0)
        counts, by_codec = ops.launch_counts(), ops.launch_counts_by_codec()
        want_codec = {
            "inject_scrub": {c: g_(f"steps:{c}") for c in ("secded72", "ileave88")},
            "inject_scrub_domains": {}, "decode": {"ileave88": 7 * g_("steps:ileave88")},
            "encode": {"secded72": n_["packs"] + 7 * g_("steps:ileave88"), "ileave88": 1},
            "gather_scrub": {},
            "fault_field": {c: g_(f"draw:{c}") for c in ("secded72", "ileave88")},
        }
        want_total = {k: sum(v.values()) for k, v in want_codec.items()}
        want_total.update(ecc_matmul=per_fwd * (n_["prefill"] + n_["decode"]), inject=0)
        require(n_["packs"] == 5 * per_fwd and n_["plain_on_card"] == 0, f"scenario tally {n_}")
        codec_launch_check("scenario-engines", counts, by_codec, want_codec,
                           {k: want_total[k] for k in counts})
        bursts = ops.burst_launch_counts()
        want_bursts = {c: g_(f"burst:{c}") for c in ("secded72", "ileave88") if g_(f"burst:{c}")}
        require(bursts == want_bursts, f"burst launches {bursts}, expected {want_bursts}")
        scen_run.update(steps=steps_, locks=locks, histories=hists, launches=counts,
                        burst_launches=bursts)
        paths_extra["scenario-engines"] = {
            "launches": counts, "launches_by_codec": by_codec, "burst_by_codec": bursts,
            "kv_codec": None, "matmuls_per_forward": per_fwd,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_["decode_kernel"]},
            "packs": n_["packs"], "commits": 0,
            "voltage_steps": g_("steps:secded72") + g_("steps:ileave88")}
        print(f"  avionics at {sv} V, one device-mask step each: secded72 {json.dumps(sec)} "
              f"({steps_['secded72']['step_ms']:.2f} ms); ileave88 {json.dumps(ilv)} "
              f"({steps_['ileave88']['step_ms']:.2f} ms): ileave88 corrects more and detects less")
        print(f"  autotune from 0.62 V (device masks): locks {json.dumps(locks)}; histories "
              f"{json.dumps(hists)}; burst launches {json.dumps(bursts)}")
        torch.cuda.empty_cache()

        # e. phase 6's stream under avionics at a kv rail at the scenario
        # voltage (each interval's rate aged by the interval count), then
        # under a neutral environment with drift 0 and without one at 0.56 V
        seen = []
        real_interval_masks = faultsim.interval_masks
        scen_stream = [(p_, min(n_, SCEN_NEW_TOKENS)) for p_, n_ in stream[:SCEN_REQUESTS]]

        def recording(seed, interval, n, rate, sigma, n_check=8, device=None, burst=None):
            seen.append((interval, rate, burst))
            return real_interval_masks(seed, interval, n, rate, sigma, n_check, device=device,
                                       burst=burst)

        faultsim.interval_masks = recording
        streams = {}
        try:
            for label, fm, kv_v in (
                    ("avionics", FaultModelConfig(mask_source="device", environment="avionics"),
                     sv),
                    ("neutral", FaultModelConfig(mask_source="device", drift=0.0), 0.56),
                    ("none", FaultModelConfig(mask_source="device"), 0.56)):
                seen.clear()
                ops.reset_launch_count()
                with Tally() as tally:
                    eng = ServingEngine(cfg, params, max_len=PAGED_MAX_LEN,
                                        rel=ReliabilityConfig(mode="inline", voltage=1.0,
                                                              fault_model=fm))
                    t = time.perf_counter()
                    rep = eng.serve(scen_stream, n_lanes=4, kv_voltage=kv_v,
                                    n_pages=STREAM_PAGES)
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t
                name = f"scenario-stream-{label}"
                check_paged_launches(name, tally, ops.launch_counts(), multi=False)
                require(tally.n["draws"] == tally.n["intervals"] == len(seen) > 0,
                        f"{name}: {tally.n['draws']} draws in {tally.n['intervals']} intervals")
                require(all(len(rep.outputs[i]) == n_new
                            for i, (_, n_new) in enumerate(scen_stream)),
                        f"{name}: a request did not complete at its length")
                require(rep.kv_stats.corrected > 0, f"{name}: no corrected word {rep.kv_stats}")
                paged[name]["burst_by_codec"] = ops.burst_launch_counts()
                streams[label] = {"outputs": rep.outputs, "kv_stats": rep.kv_stats.to_dict(),
                                  "kv_voltages": list(rep.kv_voltages), "steps": rep.steps,
                                  "launches": ops.launch_counts(), "wall_s": wall_s,
                                  "rates": [r_ for _, r_, _ in seen],
                                  "bursts": ops.burst_launch_counts()}
                if label == "avionics":
                    want_r = [aprof.fault_rate(sv) * scenario.aging_multiplier(0, i_, avionics, 0)
                              for i_, _, _ in seen]
                    require([r_ for _, r_, _ in seen] == want_r,
                            "avionics: an interval's rate is not fault_rate x aging_multiplier")
                    require(all(b_ == avionics.burst for _, _, b_ in seen), "avionics: burst")
                    require(streams[label]["bursts"] == {"secded72": len(seen)},
                            f"avionics: burst launches {streams[label]['bursts']}")
                else:
                    require(all(b_ is None for _, _, b_ in seen), f"{label}: a burst was drawn")
                del eng, rep
        finally:
            faultsim.interval_masks = real_interval_masks
        a_, n_n, n_0 = streams["avionics"], streams["neutral"], streams["none"]
        require(outputs_equal(n_n["outputs"], n_0["outputs"])
                and all(n_n[k] == n_0[k] for k in ("kv_stats", "kv_voltages", "steps",
                                                    "launches", "rates")),
                "the neutral environment's stream differs from the one without an environment")
        scen_run["streams"] = {k: {k2: v2 for k2, v2 in v.items() if k2 != "outputs"}
                               for k, v in streams.items()}
        print(f"  stream of {SCEN_REQUESTS} requests ({SCEN_NEW_TOKENS} new tokens at most) on 4 "
              f"lanes under avionics at a {sv} V kv rail: every "
              f"request complete at its length; {len(a_['rates'])} intervals, each one field "
              f"launch (burst) and one interval scrub, rate = fault_rate x aging multiplier "
              f"({a_['rates'][0]:.4e} -> {a_['rates'][-1]:.4e}); kv {json.dumps(a_['kv_stats'])} "
              f"in {a_['wall_s']:.2f} s")
        print(f"  neutral environment (drift 0) = no environment at a 0.56 V kv rail: equal "
              f"tokens, kv counters {json.dumps(n_0['kv_stats'])}, kv voltages, steps and "
              f"launches {json.dumps(n_0['launches'])}")
        print(f"  scenario {json.dumps(scen_run)}")

    # ---------------------------------------------------------------- 15
    # The rest of the dense family at full width: minitron-8b's non-gated
    # relu^2 MLP and its int8 KV cache (path MN), qwen1.5-4b's 20/20-head KV
    # pages through serve (path QP) and the sliding-window ring at
    # qwen3-0.6b's width (W).
    def dense_family_phase(report: dict, paths_extra: dict) -> dict:
        out: dict = {}
        v_min = platform.v_min
        below = lambda eng_, v, *a, **kw: ("steps", "steps_below") if \
            platform.fault_rate(float(v)) > 0.0 else "steps"
        rng_ = np.random.default_rng(3)

        def seeded(c):
            """Random weights from seed 0, QKV biases N(0, 0.5^2) from seed 1
            (``init_params`` draws them as zeros)."""
            p = lm.init_params(c, seed=0, device=dev)
            if c.qkv_bias:
                gen = torch.Generator(device=dev).manual_seed(1)
                for b in ("bq", "bk", "bv"):
                    t_ = p["blocks"]["p0"]["attn"][b]
                    t_.copy_(0.5 * torch.randn(t_.shape, generator=gen, device=dev))
            return p

        def engine(c, max_len):
            """An inline single-rail engine at nominal, device masks, its
            walk starting at V_min."""
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    fault_model=FaultModelConfig(mask_source="device"),
                                    rails=RailsConfig(start_v=v_min))
            t_ = time.perf_counter()
            eng_ = ServingEngine(c, seeded(c), rel=rel, max_len=max_len)
            torch.cuda.synchronize()
            return eng_, time.perf_counter() - t_

        def ecc_leaves(eng_) -> dict:
            return {k.split("[")[-1].strip("']"): w for k, w in base.flatten(eng_.params)
                    if isinstance(w, ops.EccWeight)}

        # a. minitron-8b: the arena, B3 at its four (K, N) against the plain
        # version and the traced kernel split, on an engine of its own
        mcfg = get_config("minitron-8b")
        require(not mcfg.gated_mlp and mcfg.mlp_act == "relu2" and not mcfg.tie_embeddings,
                f"minitron-8b config {mcfg}")
        torch.cuda.empty_cache()
        out["allocated_gb_at_start"] = torch.cuda.memory_allocated() / 1e9
        print(f"  allocated at the start: {out['allocated_gb_at_start']:.1f} GB (earlier "
              f"phases' engines freed)")
        torch.cuda.reset_peak_memory_stats()
        eng, build_s = engine(mcfg, 64)
        n_m = eng._store.n_words
        require(n_m == MN_WORDS == mcfg.n_layers * sum(k_ * n_ for k_, n_ in protected(mcfg)) // 8,
                f"minitron-8b arena of {n_m} words")
        leaves = ecc_leaves(eng)
        n_leaves = len(leaves)
        require(sorted(leaves) == ["w1", "w2", "wk", "wo", "wq", "wv"],
                f"minitron-8b protected leaves {sorted(leaves)}")
        print(f"  minitron-8b ({mcfg.n_layers} layers, d {mcfg.d_model}, {mcfg.n_heads}/"
              f"{mcfg.n_kv_heads} heads, d_ff {mcfg.d_ff} non-gated relu^2, vocab {mcfg.vocab}, "
              f"bf16, untied): {n_m} protected words in {len(leaves)} leaves (no w3), engine "
              f"built in {build_s:.1f} s, peak {peak_gb():.1f} GB")
        require(b3_split(mcfg, BATCH) == {"decode": 160, "tiled": 32}
                and b3_split(mcfg, BATCH * PROMPT_LEN) == {"decode": 0, "tiled": 192},
                f"minitron-8b B3 split {b3_split(mcfg, BATCH)}")
        eng.set_voltage(0.56)
        require(eng._last_scrub.corrected > 0, f"minitron-8b 0.56 V scrub {eng._last_scrub}")
        b3_rows = b3_shape_rows("minitron-8b", leaves, mcfg.n_groups)
        m_prompts = rng_.integers(0, mcfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
        mn = out["MN"] = {"n_words": n_m, "b3": b3_rows,
                          "b3_traced": b3_traced("minitron-8b", eng.params, mcfg, m_prompts)}
        report["ecc_matmul_decode"]["minitron_8b"] = [
            r for r in b3_rows if r["function"] == b3_names["decode"]]
        report["ecc_matmul_prefill"]["minitron_8b"] = [
            r for r in b3_rows if r["function"] == b3_names["tiled"]]
        del eng, leaves
        torch.cuda.empty_cache()

        # path MN: generate, sequence_logits, a walk, then the int8 KV cache
        ops.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        toks_d = torch.as_tensor(m_prompts, device=dev)
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_voltage", below)
            eng, mn["build_s"] = engine(mcfg, 64)
            t = time.perf_counter()
            toks = eng.generate(m_prompts, NEW_TOKENS)
            mn["generate_s"] = time.perf_counter() - t
            mn["tokens_per_s"] = BATCH * NEW_TOKENS / mn["generate_s"]
            require(toks.shape == (BATCH, NEW_TOKENS)
                    and bool(((toks >= 0) & (toks < mcfg.vocab)).all()), "minitron-8b tokens")
            seq = torch.as_tensor(np.concatenate([m_prompts, toks], axis=1), device=dev)
            sl = lm.sequence_logits(eng.params, seq, mcfg)
            pl, _ = lm.prefill(eng.params, seq, mcfg, lm.init_cache(mcfg, BATCH, 64))
            require(tuple(sl.shape) == (BATCH, PROMPT_LEN + NEW_TOKENS, mcfg.vocab)
                    and bool(torch.isfinite(sl).all()), "sequence_logits shape or values")
            require(torch.equal(sl[:, -1], pl), "minitron-8b: sequence_logits' last position "
                    "differs from prefill's logits")
            del sl, pl
            # the bf16 cache's prefill and first decode step, for the int8 cache
            cache16 = lm.init_cache(mcfg, BATCH, 64)
            pre16, _ = lm.prefill(eng.params, toks_d, mcfg, cache16)
            tok0 = torch.argmax(pre16, dim=-1)[:, None]
            dec16, _ = lm.decode_step(eng.params, tok0, mcfg, cache16, PROMPT_LEN)
            bytes16 = sum(t_.nbytes for t_ in cache16["p0"].values())
            del cache16
            print(f"  MN: generate {BATCH} x {PROMPT_LEN} -> {NEW_TOKENS} tokens in "
                  f"{mn['generate_s']:.2f} s = {mn['tokens_per_s']:.1f} tokens/s; "
                  f"sequence_logits ({BATCH} x {PROMPT_LEN + NEW_TOKENS}): last position = "
                  f"prefill's logits bit for bit")
            t = time.perf_counter()
            lock, hist = eng.autotune_voltage(max_rounds=16)
            torch.cuda.synchronize()
            mn["walk"] = {
                "walk_s": time.perf_counter() - t, "lock": lock, "locked": eng.controller.locked,
                "rounds": len(hist), "power_w": eng.power_w(),
                "saving_vs_nominal": eng.power_report()["saving_vs_nominal"],
                "history": [(r.voltage, r.corrected, r.detected, r.action) for r in hist]}
            require(eng.controller.locked, f"minitron-8b walk did not lock: {mn['walk']}")
            print(f"  MN walk (ECC, from V_min {v_min} V): lock {lock:.2f} V in {len(hist)} "
                  f"rounds, {mn['walk']['walk_s']:.1f} s, {mn['walk']['power_w']:.4f} W "
                  f"(saving {mn['walk']['saving_vs_nominal']:.4f}); history "
                  f"{json.dumps(mn['walk']['history'])}")
            del eng
            torch.cuda.empty_cache()
            qmcfg = dataclasses.replace(mcfg, kv_quant=True)
            eng, mn["kv_quant_build_s"] = engine(qmcfg, 64)
            toks8 = eng.generate(m_prompts, NEW_TOKENS)
            cache8 = lm.init_cache(qmcfg, BATCH, 64)
            pre8, _ = lm.prefill(eng.params, toks_d, qmcfg, cache8)
            require(torch.equal(pre8, pre16), "minitron-8b: the int8-cache prefill logits differ "
                    "from the bf16 cache's (prefill attends unquantised K/V)")
            dec8, _ = lm.decode_step(eng.params, tok0, qmcfg, cache8, PROMPT_LEN)
            require(cache8["p0"]["k"].dtype == torch.int8 and bool(torch.isfinite(dec8).all()),
                    "int8 cache")
            bytes8 = sum(t_.nbytes for t_ in cache8["p0"].values())
            mn["kv_quant"] = {
                "cache_bytes_bf16": bytes16, "cache_bytes_int8": bytes8,
                "first_decode_max_abs_dlogits": float((dec8 - dec16).abs().max()),
                "first_decode_max_abs_logits": float(dec16.abs().max()),
                "token_agreement": float((toks8 == toks).mean()),
                "tokens_equal": bool(np.array_equal(toks8, toks))}
            print(f"  MN kv_quant: prefill logits = the bf16 cache's bit for bit; cache bytes "
                  f"(batch {BATCH}, 64 positions) {bytes16} bf16 -> {bytes8} int8 + scales; first "
                  f"decode step max |dlogits| {mn['kv_quant']['first_decode_max_abs_dlogits']:.4e}"
                  f" (max |logits| {mn['kv_quant']['first_decode_max_abs_logits']:.4e}); token "
                  f"agreement {mn['kv_quant']['token_agreement']:.4f}")
            del eng, cache8, pre8, dec8, pre16, dec16
            torch.cuda.empty_cache()
        mn["peak_gb"] = peak_gb()
        counts, n_ = ops.launch_counts(), tally.n
        per_fwd = len(protected(mcfg)) * mcfg.n_layers
        require(per_fwd == n_leaves * mcfg.n_layers,
                f"{per_fwd} protected matmuls per forward, {n_leaves} protected leaves")
        want = {"inject_scrub": n_["steps"], "inject_scrub_domains": 0, "decode": 0,
                "ecc_matmul": per_fwd * (n_["prefill"] + n_["decode"]),
                "encode": n_["packs"], "gather_scrub": 0, "inject": 0,
                "fault_field": n_.get("steps_below", 0)}
        require(counts == want, f"MN launches {counts}, expected {want}")
        require(n_["packs"] == 2 * per_fwd, f"MN: {n_['packs']} weight packs")
        require(n_["plain_on_card"] == 0, "the plain codec ran on the card")
        by_k = b3_by_kernel_check("MN", tally, counts, mcfg)
        paths_extra["MN"] = {
            "launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
            "kv_codec": None, "matmuls_per_forward": per_fwd, "b3_by_kernel": by_k,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_.get("decode_kernel", 0)},
            "packs": n_["packs"], "commits": 0, "voltage_steps": n_["steps"]}
        mn["launches"], mn["b3_by_kernel"] = counts, by_k
        print(f"  MN launches: {json.dumps(counts)} = {n_['steps']} voltage steps "
              f"({n_.get('steps_below', 0)} below V_min, one field launch each), {per_fwd} fused "
              f"matmuls x ({n_['prefill']} prefill + {n_['decode']} decode forwards), by kernel "
              f"{json.dumps(by_k)}, {n_['packs']} weight packs; peak {mn['peak_gb']:.1f} GB")

        # path QP: qwen1.5-4b through serve, paged = dense, at nominal and
        # at a 0.56 V kv rail
        qpcfg = get_config("qwen1.5-4b")
        require(qpcfg.n_kv_heads == qpcfg.n_heads == 20 and qpcfg.qkv_bias, f"{qpcfg}")
        qp = out["QP"] = {}
        ops.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_voltage", below)
            eng, qp["build_s"] = engine(qpcfg, PAGED_MAX_LEN)
            n_qp = eng._store.n_words
            require(n_qp == QP_WORDS
                    == qpcfg.n_layers * sum(k_ * n_ for k_, n_ in protected(qpcfg)) // 8,
                    f"qwen1.5-4b arena of {n_qp} words")
            geom = KVGeometry.from_config(qpcfg)
            qp.update(n_words=n_qp, words_per_page=geom.words_per_page,
                      token_words=geom.token_words)
            print(f"  qwen1.5-4b ({qpcfg.n_layers} layers, d {qpcfg.d_model}, {qpcfg.n_heads}/"
                  f"{qpcfg.n_kv_heads} heads, d_ff {qpcfg.d_ff}, vocab {qpcfg.vocab}, bf16, "
                  f"untied, biases N(0, 0.5^2) from seed 1): {n_qp} protected words, engine "
                  f"built in {qp['build_s']:.1f} s; KV pages of {geom.words_per_page} words "
                  f"({geom.page_tokens} tokens x {geom.token_words})")
            dense = {i: eng.generate(p_[None], n)[0] for i, (p_, n) in enumerate(stream)}
            reps = {}
            for label, kv_v in (("nominal", None), ("0.56V", 0.56)):
                t = time.perf_counter()
                rep = eng.serve(stream, n_lanes=4, kv_voltage=kv_v, n_pages=STREAM_PAGES)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                require(len(rep.outputs) == len(stream) and rep.preemptions >= 1,
                        f"QP {label}: {len(rep.outputs)} requests, {rep.preemptions} preemptions")
                eq = [bool(np.array_equal(np.asarray(rep.outputs[i]), dense[i]))
                      for i in range(len(stream))]
                n_tok = sum(len(v) for v in rep.outputs.values())
                reps[label] = rep
                qp[label] = {"wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
                             "steps": rep.steps, "preemptions": rep.preemptions,
                             "scrub_intervals": len(rep.kv_voltages),
                             "kv_stats": rep.kv_stats.to_dict(), "equal_to_dense": eq}
                print(f"  QP stream of {len(stream)} requests, {label} kv rail, {STREAM_PAGES} "
                      f"pages: {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s, "
                      f"{rep.steps} steps, {rep.preemptions} preemptions, kv "
                      f"{rep.kv_stats.to_dict()}; requests equal to dense generate: "
                      f"{sum(eq)} of {len(eq)}")
            require(all(qp["nominal"]["equal_to_dense"]),
                    "QP: paged serve differs from dense generate at a nominal kv rail")
            require(reps["0.56V"].kv_stats.corrected > 0, "QP: no corrected word at 0.56 V")
            arena = reps["0.56V"].arena
        counts = ops.launch_counts()
        check_paged_launches("QP", tally, counts, multi=False, c=qpcfg, into=paths_extra)
        paths_extra["QP"]["b3_by_kernel"] = b3_by_kernel_check("QP", tally, counts, qpcfg)
        qp["launches"] = counts
        # B4's commit and B6's interval scrub at this page width
        wpp = geom.words_per_page
        live = np.arange(STREAM_PAGES, dtype=np.int32)
        table = np.full((4, 4), arena.scratch_page, np.int32)
        table.reshape(-1)[: len(live)] = live
        table_d = torch.as_tensor(table.reshape(-1), device=dev)
        scrub = interval_scrub_times(arena, table, table_d, "qwen1.5-4b interval_scrub")
        g = torch.Generator(device=dev).manual_seed(4)
        payload = torch.randn(BATCH, geom.token_f32, generator=g, device=dev)
        commit_base = torch.as_tensor(
            kvpages.row_bases(np.arange(BATCH) * 3, np.arange(BATCH) % geom.page_tokens, geom),
            device=dev)
        k_pl = [t_.clone() for t_ in (arena.lo, arena.hi, arena.parity)]
        p_pl = [t_.clone() for t_ in (arena.lo, arena.hi, arena.parity)]
        ops.encode_commit(payload, commit_base, geom.token_words, *k_pl)
        ref.encode_commit_ref(payload, commit_base, geom.token_words, *p_pl)
        torch.cuda.synchronize()
        require(same(k_pl, p_pl), "encode_commit differs at qwen1.5-4b's page width")
        commit = {"rows": BATCH, **bounds(BATCH * geom.token_words, "secded72", 17, 20,
                                          extra_bytes=8 * BATCH),
                  "ms": sync_ms(lambda: ops.encode_commit(payload, commit_base, geom.token_words,
                                                          *k_pl), 50),
                  "plain_ms": sync_ms(lambda: ref.encode_commit_ref(
                      payload, commit_base, geom.token_words, *p_pl), 5),
                  "commit_wall_ms": min(wall_ms(lambda: arena.commit_tokens(
                      payload, np.arange(BATCH) * 3, np.arange(BATCH) % geom.page_tokens))
                      for _ in range(3))}
        report["encode_commit"]["qwen1_5_4b"] = commit
        report["gather_scrub"]["qwen1_5_4b"] = scrub["interval_scrub_kernel"]
        qp["commit"], qp["interval_scrub"] = commit, scrub
        print(f"  QP page width {wpp} words: B4 commit of {BATCH} tokens ({commit['n_words']} "
              f"words) bit-identical, {commit['ms']:.4f} ms, bound {commit['bound_ms']:.4f} ms "
              f"(bytes), plain {commit['plain_ms']:.3f} ms, commit_tokens wall "
              f"{commit['commit_wall_ms']:.3f} ms; interval scrub of {table.size} page ids "
              f"{scrub['interval_scrub_ms']:.2f} ms wall (B6 {scrub['interval_scrub_kernel_ms']:.4f}"
              f" ms)")
        del eng, reps, arena, k_pl, p_pl
        torch.cuda.empty_cache()
        # paged serving refuses a ring or an int8 cache before any page exists
        for opts in ({"sliding_window": W_WINDOW}, {"kv_quant": True}):
            refusing = ServingEngine(dataclasses.replace(qpcfg, **opts), {}, rel=None,
                                     max_len=PAGED_MAX_LEN)
            before = torch.cuda.memory_allocated()
            try:
                refusing.serve(stream, n_lanes=4)
                raise AssertionError(f"serve accepted {opts}")
            except ValueError as e:
                require("paged KV" in str(e) and torch.cuda.memory_allocated() == before,
                        f"serve with {opts}: {e}")
        print(f"  QP: serve refuses sliding_window={W_WINDOW} and kv_quant before any page; "
              f"launches {json.dumps(counts)}; peak {peak_gb():.1f} GB")

        # W: the sliding-window ring at qwen3-0.6b's width against a
        # position-indexed cache with the window as a mask (a cache of
        # max_len > window slots, built for the config without its window).
        # The window is a power of two, so the key sums' tree levels above
        # it fold position p onto slot p % window by adding exact zeros: the
        # two give the same floats.
        wcfg = dataclasses.replace(cfg, sliding_window=W_WINDOW, n_layers=W_LAYERS)
        w_len, max_len = W_WINDOW + W_WINDOW // 8, W_WINDOW + W_WINDOW // 8 + W_DECODE
        t0 = time.perf_counter()
        eng, _ = engine(wcfg, max_len)
        w_prompt = rng_.integers(0, wcfg.vocab, (1, w_len)).astype(np.int32)
        toks_w = torch.as_tensor(w_prompt, device=dev)
        ring = lm.init_cache(wcfg, 1, max_len)
        full = lm.init_cache(dataclasses.replace(wcfg, sliding_window=0), 1, max_len)
        require(ring["p0"]["k"].shape[2] == W_WINDOW and full["p0"]["k"].shape[2] == max_len,
                "ring and full cache slots")
        t = time.perf_counter()
        rl, _ = lm.prefill(eng.params, toks_w, wcfg, ring)
        torch.cuda.synchronize()
        ring_prefill_s = time.perf_counter() - t
        fl, _ = lm.prefill(eng.params, toks_w, wcfg, full)
        require(torch.equal(rl, fl), "W: the ring's prefill logits differ from the full cache's")

        def layout(layers_, n):
            pos = torch.arange(n - W_WINDOW, n, device=dev)
            return all(torch.equal(ring["p0"][k_][layers_, :, pos % W_WINDOW],
                                   full["p0"][k_][layers_, :, pos]) for k_ in ("k", "v"))

        require(layout(slice(None), w_len), "W: after prefill, slot j does not hold the "
                "position p with p % window = j")
        # the decode loop (generate's, after its prefill) from the ring's
        # prefill state
        after_prefill = {k_: v_.clone() for k_, v_ in ring["p0"].items()}
        w_toks = [int(torch.argmax(rl[0]))]
        t = time.perf_counter()
        for i in range(W_DECODE):
            tok = torch.tensor([[w_toks[-1]]], device=dev)
            rl, _ = lm.decode_step(eng.params, tok, wcfg, ring, w_len + i)
            fl, _ = lm.decode_step(eng.params, tok, wcfg, full, w_len + i)
            require(bool(torch.isfinite(rl).all()) and torch.equal(rl, fl),
                    f"W decode {i}: the ring's logits differ from the full cache's by "
                    f"{float((rl - fl).abs().max())}")
            w_toks.append(int(torch.argmax(rl[0])))
        decode_s = time.perf_counter() - t
        require(layout(slice(None), w_len + W_DECODE), "W: after decode, slot j does not hold "
                "the position p with p % window = j")
        loop_toks, _ = lm.greedy_decode_loop(eng.params, torch.tensor([[w_toks[0]]], device=dev),
                                             wcfg, {"p0": after_prefill}, w_len, W_DECODE)
        require(loop_toks[0].tolist() == w_toks[1:],
                "W: the decode loop's tokens differ from the ring's decode steps")
        del eng, ring, full, rl, fl, after_prefill
        torch.cuda.empty_cache()
        out["W"] = {"window": W_WINDOW, "prompt": w_len, "decode_steps": W_DECODE,
                    "ring_prefill_s": ring_prefill_s, "decode_pair_s": decode_s,
                    "wall_s": time.perf_counter() - t0}
        print(f"  W (qwen3-0.6b, sliding_window {W_WINDOW}, depth cut to {W_LAYERS} of "
              f"{cfg.n_layers} layers): prompt {w_len} tokens, ring of "
              f"{W_WINDOW} slots against a {max_len}-slot position-indexed cache with the window "
              f"mask: prefill and {W_DECODE} decode steps' logits and every layer's slots (slot "
              f"j = position p, p % {W_WINDOW} = j) bit for bit, the decode loop from the ring's "
              f"prefill state = the ring's tokens; ring prefill {ring_prefill_s:.2f} s, W in "
              f"{out['W']['wall_s']:.1f} s")
        return out

    # ---------------------------------------------------------------- 16
    # The MoE family at full width, depth cut: mixtral-8x22b (path MX,
    # domain mode on one layer included), llama4-scout through serve (LS),
    # and the port's examples on the card (EX).
    def moe_phase(report: dict, paths_extra: dict) -> dict:
        import importlib.util

        from repro_torch.models import moe

        out: dict = {}
        v_min = platform.v_min
        below = lambda eng_, v, *a, **kw: ("steps", "steps_below") if \
            platform.fault_rate(float(v)) > 0.0 else "steps"
        rng_ = np.random.default_rng(6)

        def engine(c, params_, max_len, **rel_kw):
            """An inline single-rail engine at nominal, device masks, its walk
            starting at V_min."""
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    fault_model=FaultModelConfig(mask_source="device"),
                                    rails=RailsConfig(start_v=v_min), **rel_kw)
            t_ = time.perf_counter()
            eng_ = ServingEngine(c, params_, rel=rel, max_len=max_len)
            torch.cuda.synchronize()
            return eng_, time.perf_counter() - t_

        def ecc_leaves(eng_) -> dict:
            return {k.split("[")[-1].strip("']"): w for k, w in base.flatten(eng_.params)
                    if isinstance(w, ops.EccWeight)}

        @contextlib.contextmanager
        def routes():
            """Record every ``moe.route_topk`` call of the MoE layers (router
            logits, experts, probabilities, the group's capacity)."""
            seen, real = [], moe.route_topk

            def spy(x, router_w, e, k):
                idx, probs, logits = real(x, router_w, e, k)
                seen.append({"x": x, "logits": logits, "idx": idx, "probs": probs})
                return idx, probs, logits

            moe.route_topk = spy
            try:
                yield seen
            finally:
                moe.route_topk = real

        def routing_check(label, c, seen, kind) -> dict:
            """Every recorded call: the CPU's top-k and dispatch over the card's
            router logits equal the card's; the share of dropped assignments
            at the config's capacity factor."""
            kept = total = 0
            for r_ in seen:
                g_, t_ = r_["idx"].shape[:2]
                cap = moe.capacity(t_, c.top_k, c.n_experts, c.capacity_factor)
                card = moe.sort_dispatch(r_["idx"], c.n_experts, cap)
                idx_c, probs_c = moe.topk_from_logits(r_["logits"].cpu(), c.top_k,
                                                      r_["probs"].dtype)
                cpu = moe.sort_dispatch(idx_c, c.n_experts, cap)
                require(torch.equal(r_["idx"].cpu(), idx_c)
                        and all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)),
                        f"{label} {kind}: routing on the card differs from the CPU's")
                kept += int(card[2].sum())
                total += card[2].numel()
            return {"calls": len(seen), "assignments": total, "dropped": total - kept,
                    "dropped_share": (total - kept) / max(total, 1)}

        def plain_mixture(x, p, c):
            """Each token alone through its top-k experts (no capacity, no slot
            grid): the same row-invariant expert products, each output times
            its probability in the compute dtype, added in expert order; the
            shared expert after. And the same mixture in float32."""
            d_ = x.shape[-1]
            rows = x.reshape(-1, d_)
            idx, probs, _ = moe.route_topk(rows, p["router"], c.n_experts, c.top_k)
            mix, f32 = [], []
            for r in range(rows.shape[0]):
                acc, acc32 = rows.new_zeros(d_), torch.zeros(d_, device=dev)
                for j in torch.argsort(idx[r]).tolist():
                    e_ = int(idx[r, j])
                    pe = {k_: v_[e_][None] for k_, v_ in p.items() if k_ in ("w1", "w2", "w3")}
                    acc = acc + moe._expert_ffn(rows[r].reshape(1, 1, 1, d_), pe,
                                                c).reshape(d_) * probs[r, j]
                    x32 = rows[r].float()
                    h = x32 @ p["w1"][e_].float()
                    h = (torch.nn.functional.silu(h) * (x32 @ p["w3"][e_].float()) if c.gated_mlp
                         else torch.nn.functional.gelu(h, approximate="tanh"))
                    acc32 = acc32 + (h @ p["w2"][e_].float()) * probs[r, j].float()
                if c.shared_expert:
                    h = torch.nn.functional.silu(moe._rows(rows[r:r + 1], p["shared_w1"]))
                    acc = acc + moe._rows(h * moe._rows(rows[r:r + 1], p["shared_w3"]),
                                          p["shared_w2"])[0]
                    x32 = rows[r].float()
                    h = torch.nn.functional.silu(x32 @ p["shared_w1"].float())
                    acc32 = acc32 + (h * (x32 @ p["shared_w3"].float())) @ p["shared_w2"].float()
                mix.append(acc)
                f32.append(acc32)
            return torch.stack(mix).reshape(x.shape), torch.stack(f32).reshape(x.shape)

        def moe_checks(label, c, params_, seen_pre, seen_dec) -> dict:
            """Layer 0's MoE at the recorded prefill and decode inputs, at a
            no-drop capacity (cf = E / k): each row alone = the batch bit for
            bit, and the output = the plain per-token mixture bit for bit
            (the decode batch and the prefill's first row); the largest
            difference from the float32 mixture, printed."""
            p = {k_: v_[0] for k_, v_ in params_["blocks"]["p0"]["moe"].items()}
            nd = dataclasses.replace(c, capacity_factor=c.n_experts / c.top_k)
            x_dec = seen_dec[0]["x"].reshape(BATCH, 1, c.d_model)
            x_pre = seen_pre[0]["x"]
            res = {}
            for kind, xs in (("decode", x_dec), ("prefill", x_pre)):
                full = moe.moe_ffn(xs, p, nd)
                require(bool(torch.isfinite(full).all()), f"{label} {kind} moe_ffn non-finite")
                for r in range(BATCH):
                    require(torch.equal(moe.moe_ffn(xs[r:r + 1], p, nd)[0], full[r]),
                            f"{label} {kind}: row {r} alone differs from the batch of {BATCH}")
                xs1 = xs if kind == "decode" else xs[:1]
                mix, f32 = plain_mixture(xs1, p, nd)
                got = full if kind == "decode" else full[:1]
                require(torch.equal(got, mix), f"{label} {kind}: moe_ffn differs from the plain "
                        f"per-token mixture by {float((got.float() - mix.float()).abs().max())}")
                res[kind] = {"rows": xs.shape[0] * xs.shape[1], "mixture_rows": xs1.shape[0]
                             * xs1.shape[1], "max_abs_diff_f32": float((got.float() - f32)
                                                                        .abs().max()),
                             "max_abs_f32": float(f32.abs().max())}
            print(f"  {label} moe_ffn at cf = E / k: each row alone = the batch of {BATCH} "
                  f"(decode group and per-row groups) and = the plain per-token mixture bit for "
                  f"bit; against the float32 mixture: decode max |diff| "
                  f"{res['decode']['max_abs_diff_f32']:.4e} (max |out| "
                  f"{res['decode']['max_abs_f32']:.4e}), prefill row 0 "
                  f"{res['prefill']['max_abs_diff_f32']:.4e} ("
                  f"{res['prefill']['max_abs_f32']:.4e})")
            return res

        def decode_split(label, params_, c, prompts_) -> dict:
            """One traced decode step of batch 4: device busy time split into
            B3 (the attention), the expert and other dense products (cuBLAS
            GEMMs) and the rest, beside its wall time and the bound of reading
            every expert once."""
            toks_ = torch.as_tensor(prompts_, device=dev)
            cache_ = lm.init_cache(c, BATCH, 64)
            logits_, _ = lm.prefill(params_, toks_, c, cache_)
            tok_ = torch.argmax(logits_, dim=-1)[:, None]
            f_ = lambda: lm.decode_step(params_, tok_, c, cache_, PROMPT_LEN)
            wall = min(wall_ms(f_) for _ in range(3))
            evs = device_events(f_)
            b3 = [e for e in evs if "ecc_matmul" in e[0]]
            gemm = [e for e in evs if "ecc_matmul" not in e[0] and any(
                t_ in e[0].lower() for t_ in ("gemm", "xmma", "cutlass", "sm90", "nvjet"))]
            ms = lambda es: sum(e_ - s_ for _, s_, e_ in es) / 1e3
            by_name: dict = {}
            for n_, s_, e_ in evs:
                if "ecc_matmul" not in n_:
                    t_, k_ = by_name.get(n_, (0.0, 0))
                    by_name[n_] = (t_ + (e_ - s_) / 1e3, k_ + 1)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
            expert_bytes = sum(v_.nbytes for k_, v_ in base.flatten(params_)
                               if "['moe']" in k_ and "router" not in k_)
            row = {"wall_ms": wall, "traced_device_events": len(evs),
                   "device_busy_ms": busy_us(evs) / 1e3 if evs else None,
                   "b3_ms": ms(b3), "b3_events": len(b3), "gemm_ms": ms(gemm),
                   "gemm_events": len(gemm), "other_ms": ms(evs) - ms(b3) - ms(gemm),
                   "expert_bytes": expert_bytes,
                   "expert_bytes_bound_ms": 1e3 * expert_bytes / HBM_BYTES_PER_S,
                   "top_other_kernels": [(n_[:80], t_, k_) for n_, (t_, k_) in top]}
            if evs:
                row["device_idle_share"] = 1.0 - row["device_busy_ms"] / wall
            print(f"  {label} decode step (batch {BATCH}): wall {wall:.2f} ms; traced device "
                  f"busy {row['device_busy_ms'] or 0.0:.2f} ms (idle share "
                  f"{row.get('device_idle_share', float('nan')):.3f}): B3 {row['b3_ms']:.2f} ms "
                  f"({len(b3)} launches), cuBLAS GEMMs (experts, router, shared expert) "
                  f"{row['gemm_ms']:.2f} ms ({len(gemm)} launches), other {row['other_ms']:.2f} "
                  f"ms; every expert read once: {expert_bytes / 1e9:.2f} GB, bound "
                  f"{row['expert_bytes_bound_ms']:.2f} ms; the longest kernels outside B3 (name, "
                  f"ms, launches): {json.dumps(row['top_other_kernels'])}")
            return row

        def model_path(label, c, params_, prompts_, extra=None) -> dict:
            """B3 rows, the traced kernel split, routing, the MoE checks, a
            generate, ``sequence_logits``, the decode-step split and an ECC
            walk, on one inline engine; the path's launches."""
            res: dict = {}
            eng, res["build_s"] = engine(c, params_, 64)
            leaves = ecc_leaves(eng)
            require(sorted(leaves) == ["wk", "wo", "wq", "wv"],
                    f"{label}: protected leaves {sorted(leaves)} (the experts stay plain)")
            n_w = eng._store.n_words
            require(n_w == c.n_layers * sum(k_ * n_ for k_, n_ in protected(c)) // 8,
                    f"{label} arena of {n_w} words")
            require(b3_split(c, BATCH) == {"decode": 4 * c.n_layers, "tiled": 0}
                    and b3_split(c, BATCH * PROMPT_LEN) == {"decode": 0,
                                                            "tiled": 4 * c.n_layers},
                    f"{label} B3 split {b3_split(c, BATCH)}")
            res["n_words"] = n_w
            eng.set_voltage(0.56)
            require(eng._last_scrub.corrected > 0, f"{label} 0.56 V scrub {eng._last_scrub}")
            res["b3"] = b3_shape_rows(label, leaves, c.n_groups)
            res["b3_traced"] = b3_traced(label, eng.params, c, prompts_)
            res["decode_split"] = decode_split(label, eng.params, c, prompts_)
            del eng, leaves
            torch.cuda.empty_cache()
            ops.reset_launch_count()
            with Tally() as tally:
                tally._wrap(ServingEngine, "set_voltage", below)
                eng, res["path_build_s"] = engine(c, params_, 64)
                toks_d = torch.as_tensor(prompts_, device=dev)
                with routes() as seen_pre:
                    pre_l, _ = lm.prefill(eng.params, toks_d, c, lm.init_cache(c, BATCH, 64))
                tok0 = torch.argmax(pre_l, dim=-1)[:, None]
                with routes() as seen_dec:
                    lm.decode_step(eng.params, tok0, c, lm.init_cache(c, BATCH, 64), 0)
                with tally.outside():
                    res["routing"] = {"prefill": routing_check(label, c, seen_pre, "prefill"),
                                      "decode": routing_check(label, c, seen_dec, "decode")}
                    require(len(seen_pre) == len(seen_dec) == c.n_layers,
                            f"{label}: {len(seen_pre)} / {len(seen_dec)} routed layers")
                    print(f"  {label} routing: the card's top-k and sort dispatch = the CPU's "
                          f"over the same router logits, every layer of a prefill and a decode "
                          f"step; dropped assignments at cf {c.capacity_factor}: prefill "
                          f"{res['routing']['prefill']['dropped']} of "
                          f"{res['routing']['prefill']['assignments']} "
                          f"({res['routing']['prefill']['dropped_share']:.4f}), decode "
                          f"{res['routing']['decode']['dropped']} of "
                          f"{res['routing']['decode']['assignments']} "
                          f"({res['routing']['decode']['dropped_share']:.4f})")
                    res["moe"] = moe_checks(label, c, eng.params, seen_pre, seen_dec)
                del seen_pre, seen_dec
                t_ = time.perf_counter()
                toks = eng.generate(prompts_, NEW_TOKENS)
                res["generate_s"] = time.perf_counter() - t_
                res["tokens_per_s"] = BATCH * NEW_TOKENS / res["generate_s"]
                require(toks.shape == (BATCH, NEW_TOKENS)
                        and bool(((toks >= 0) & (toks < c.vocab)).all()), f"{label} tokens")
                seq = torch.as_tensor(np.concatenate([prompts_, toks], axis=1), device=dev)
                sl = lm.sequence_logits(eng.params, seq, c)
                pl, _ = lm.prefill(eng.params, seq, c, lm.init_cache(c, BATCH, 64))
                require(tuple(sl.shape) == (BATCH, PROMPT_LEN + NEW_TOKENS, c.vocab)
                        and bool(torch.isfinite(sl).all()), f"{label} sequence_logits")
                require(torch.equal(sl[:, -1], pl), f"{label}: sequence_logits' last position "
                        "differs from prefill's logits")
                del sl, pl
                print(f"  {label}: generate {BATCH} x {PROMPT_LEN} -> {NEW_TOKENS} tokens in "
                      f"{res['generate_s']:.2f} s = {res['tokens_per_s']:.1f} tokens/s; "
                      f"sequence_logits' last position = prefill's logits bit for bit")
                t_ = time.perf_counter()
                lock, hist = eng.autotune_voltage(max_rounds=16)
                torch.cuda.synchronize()
                res["walk"] = {
                    "walk_s": time.perf_counter() - t_, "lock": lock,
                    "locked": eng.controller.locked, "rounds": len(hist),
                    "power_w": eng.power_w(),
                    "saving_vs_nominal": eng.power_report()["saving_vs_nominal"],
                    "history": [(r.voltage, r.corrected, r.detected, r.action) for r in hist]}
                require(eng.controller.locked, f"{label} walk did not lock: {res['walk']}")
                print(f"  {label} walk (ECC, from V_min {v_min} V): lock {lock:.2f} V in "
                      f"{len(hist)} rounds, {res['walk']['walk_s']:.1f} s, "
                      f"{res['walk']['power_w']:.4f} W; history "
                      f"{json.dumps(res['walk']['history'])}")
                del eng
                torch.cuda.empty_cache()
                if extra is not None:
                    extra(res, tally)
            counts, n_ = ops.launch_counts(), tally.n
            per_fwd = len(protected(c)) * c.n_layers
            want = {"inject_scrub": n_["steps"], "inject_scrub_domains": 0, "decode": 0,
                    "ecc_matmul": per_fwd * (n_["prefill"] + n_["decode"]),
                    "encode": n_["packs"] + n_["commits"],
                    "gather_scrub": n_["intervals"] + n_["prefix_scrubs"], "inject": 0,
                    "fault_field": n_.get("steps_below", 0) + n_["draws"]}
            require(counts == want, f"{label} launches {counts}, expected {want}")
            require(n_["packs"] == per_fwd * (1 + res.get("serve_engines", 0)),
                    f"{label}: {n_['packs']} weight packs")
            require(n_["plain_on_card"] == 0, "the plain codec ran on the card")
            by_k = b3_by_kernel_check(label, tally, counts, c)
            paths_extra[label] = {
                "launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
                "kv_codec": "secded72" if n_["commits"] else None,
                "matmuls_per_forward": per_fwd, "b3_by_kernel": by_k,
                "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                             "decode_kernel": n_.get("decode_kernel", 0)},
                "packs": n_["packs"], "commits": n_["commits"], "voltage_steps": n_["steps"]}
            res["launches"], res["b3_by_kernel"] = counts, by_k
            print(f"  {label} launches: {json.dumps(counts)} = {n_['steps']} voltage steps "
                  f"({n_.get('steps_below', 0)} below V_min), {per_fwd} fused matmuls x "
                  f"({n_['prefill']} prefill + {n_['decode']} decode forwards), by kernel "
                  f"{json.dumps(by_k)}, {n_['packs']} weight packs")
            return res

        torch.cuda.empty_cache()
        out["allocated_gb_at_start"] = torch.cuda.memory_allocated() / 1e9
        print(f"  allocated at the start: {out['allocated_gb_at_start']:.1f} GB")

        # MX: mixtral-8x22b, 8 of its 56 layers; domain mode on one layer
        full_mx = get_config("mixtral-8x22b")
        xcfg = dataclasses.replace(full_mx, n_layers=MOE_LAYERS)
        require(xcfg.n_experts == 8 and xcfg.top_k == 2 and xcfg.sliding_window == 4096
                and xcfg.gated_mlp and xcfg.capacity_factor == 1.25, f"{xcfg}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        xparams = lm.init_params(xcfg, seed=0, device=dev)
        torch.cuda.synchronize()
        expert_w = sum(v_.numel() for k_, v_ in base.flatten(xparams)
                       if "['moe']['w" in k_) // MOE_LAYERS
        require(expert_w == MX_EXPERT_WEIGHTS, f"mixtral expert weights a layer {expert_w}")
        print(f"  MX mixtral-8x22b at full width (d {xcfg.d_model}, {xcfg.n_heads}/"
              f"{xcfg.n_kv_heads} heads, d_ff {xcfg.d_ff}, {xcfg.n_experts} experts top-"
              f"{xcfg.top_k}, window {xcfg.sliding_window}, vocab {xcfg.vocab}, bf16), depth cut "
              f"to {MOE_LAYERS} of {full_mx.n_layers} layers: {expert_w} expert weights a layer "
              f"({MOE_LAYERS * expert_w * 2 / 1e9:.2f} GB bf16), drawn in "
              f"{time.perf_counter() - t0:.1f} s")
        x_prompts = rng_.integers(0, xcfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)

        mx = out["MX"] = model_path("MX", xcfg, xparams, x_prompts)
        mx["peak_gb"] = peak_gb()
        report["ecc_matmul_decode"]["mixtral_8x22b"] = [
            r for r in mx["b3"] if r["function"] == b3_names["decode"]]
        report["ecc_matmul_prefill"]["mixtral_8x22b"] = [
            r for r in mx["b3"] if r["function"] == b3_names["tiled"]]
        print(f"  MX peak {mx['peak_gb']:.1f} GB")
        del xparams
        torch.cuda.empty_cache()

        # MX, domain mode on one layer (its launches join path MX's): the
        # whole tree, the 4-D experts included, written into the memory
        # domain and read back at nominal; its tokens = the unprotected
        # engine's
        c1 = dataclasses.replace(xcfg, n_layers=1)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_count()
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_voltage", below)
            p1 = lm.init_params(c1, seed=1, device=dev)
            plain = ServingEngine(c1, p1, rel=None, max_len=64).generate(x_prompts, NEW_TOKENS)
            t_ = time.perf_counter()
            deng = ServingEngine(c1, p1, rel=ReliabilityConfig(mode="domain", voltage=1.0),
                                 max_len=64)
            torch.cuda.synchronize()
            build = time.perf_counter() - t_
            names = deng.domain.names()
            experts = [k_ for k_ in names if "['moe']['w" in k_]
            words = sum(deng.domain.entry(k_).n_words for k_ in names)
            ex_words = sum(deng.domain.entry(k_).n_words for k_ in experts)
            require(8 * ex_words == 2 * MX_EXPERT_WEIGHTS and all(
                len(deng.domain.entry(k_).shape) == 4
                and deng.domain.entry(k_).dtype == torch.bfloat16 for k_ in experts),
                    f"domain mode expert words {ex_words}")
            toks_ = deng.generate(x_prompts, NEW_TOKENS)
            require(np.array_equal(toks_, plain), "MX domain mode at nominal: tokens differ "
                    "from the unprotected engine's")
            require(deng.stats.words == words and deng.stats.faulty_words == 0,
                    f"domain read {deng.stats}")
            del deng, p1
            torch.cuda.empty_cache()
        counts = ops.launch_counts()
        want = {k_: 0 for k_ in counts}
        want.update(encode=len(names), inject=len(names), decode=len(names))
        require(counts == want and tally.n["steps"] == 1 and tally.n["plain_on_card"] == 0,
                f"MX domain mode launches {counts}, expected {want} (one write and one read "
                f"of every leaf)")
        mx["domain"] = {"layers": 1, "leaves": len(names), "reads": 1, "words": words,
                        "expert_words": ex_words, "build_and_read_s": build,
                        "launches": counts, "peak_gb": peak_gb()}
        rec = paths_extra["MX"]
        for k_, n_ in counts.items():
            rec["launches"][k_] += n_
        for k_, by_c in ops.launch_counts_by_codec().items():
            for c_, n_ in by_c.items():
                rec["launches_by_codec"][k_][c_] = rec["launches_by_codec"][k_].get(c_, 0) + n_
        print(f"  MX domain mode, 1 layer: {len(names)} leaves, {words} raw words ({ex_words} of "
              f"them the 4-D bf16 experts), written and read at nominal in {build:.1f} s; "
              f"tokens = the unprotected engine's; launches {json.dumps(counts)}; peak "
              f"{mx['domain']['peak_gb']:.1f} GB")

        # LS: llama4-scout, MOE_LAYERS of its 48 layers, through serve
        full_ls = get_config("llama4-scout-17b-a16e")
        lcfg = dataclasses.replace(full_ls, n_layers=MOE_LAYERS)
        require(lcfg.n_experts == 16 and lcfg.top_k == 1 and lcfg.shared_expert
                and shapes.supports_paged_kv(lcfg), f"{lcfg}")
        torch.cuda.reset_peak_memory_stats()
        lparams = lm.init_params(lcfg, seed=0, device=dev)
        torch.cuda.synchronize()
        moe_gb = sum(v_.nbytes for v_ in lparams["blocks"]["p0"]["moe"].values()) / 1e9
        print(f"  LS llama4-scout-17b-a16e at full width (d {lcfg.d_model}, {lcfg.n_heads}/"
              f"{lcfg.n_kv_heads} heads, d_ff {lcfg.d_ff}, {lcfg.n_experts} experts top-1 + "
              f"shared, vocab {lcfg.vocab}, bf16), depth cut to {MOE_LAYERS} of "
              f"{full_ls.n_layers} layers: {moe_gb:.2f} GB of MoE weights")
        l_prompts = rng_.integers(0, lcfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)

        def ls_serve(res, tally):
            """Phase 6's stream through serve at a nominal kv rail: at cf 16
            (nothing drops) every request = dense generate; at the published
            cf 1.25 the agreement printed and two runs equal."""
            res["serve_engines"] = 2
            for cf, tag in ((16.0, "cf16"), (lcfg.capacity_factor, "cf1.25")):
                c = dataclasses.replace(lcfg, capacity_factor=cf)
                eng, _ = engine(c, lparams, PAGED_MAX_LEN)
                dense = {i: eng.generate(p_[None], n)[0] for i, (p_, n) in enumerate(stream)}
                reps = []
                for _ in range(1 if cf == 16.0 else 2):
                    t_ = time.perf_counter()
                    rep = eng.serve(stream, n_lanes=4, n_pages=STREAM_PAGES)
                    torch.cuda.synchronize()
                    reps.append((rep, time.perf_counter() - t_))
                rep, wall = reps[0]
                require(len(rep.outputs) == len(stream) and rep.preemptions >= 1,
                        f"LS {tag}: {len(rep.outputs)} requests, {rep.preemptions} preemptions")
                eq = [bool(np.array_equal(np.asarray(rep.outputs[i]), dense[i]))
                      for i in range(len(stream))]
                n_tok = sum(len(v_) for v_ in rep.outputs.values())
                res[tag] = {"wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
                            "steps": rep.steps, "preemptions": rep.preemptions,
                            "kv_stats": rep.kv_stats.to_dict(), "equal_to_dense": eq,
                            "agreement": float(np.mean([np.mean(np.asarray(rep.outputs[i])
                                                                == dense[i])
                                                        for i in range(len(stream))]))}
                if len(reps) == 2:
                    res[tag]["two_runs_equal"] = outputs_equal(reps[0][0].outputs,
                                                               reps[1][0].outputs)
                    require(res[tag]["two_runs_equal"], f"LS {tag}: two serves differ")
                print(f"  LS serve at cf {cf} (stream of {len(stream)} requests, nominal kv "
                      f"rail, {STREAM_PAGES} pages): {n_tok} tokens in {wall:.2f} s = "
                      f"{n_tok / wall:.1f} tokens/s, {rep.steps} steps, {rep.preemptions} "
                      f"preemptions; requests equal to dense generate: {sum(eq)} of {len(eq)} "
                      f"(token agreement {res[tag]['agreement']:.4f})"
                      + ("; two runs equal" if len(reps) == 2 else ""))
                if cf == 16.0:
                    require(all(eq), "LS: paged serve differs from dense generate at cf 16 "
                            "(nothing drops)")
                del eng, reps, rep
                torch.cuda.empty_cache()

        ls = out["LS"] = model_path("LS", lcfg, lparams, l_prompts, extra=ls_serve)
        ls["peak_gb"] = peak_gb()
        report["ecc_matmul_decode"]["llama4_scout"] = [
            r for r in ls["b3"] if r["function"] == b3_names["decode"]]
        report["ecc_matmul_prefill"]["llama4_scout"] = [
            r for r in ls["b3"] if r["function"] == b3_names["tiled"]]
        print(f"  LS peak {ls['peak_gb']:.1f} GB")
        del lparams
        torch.cuda.empty_cache()

        # EX: the port's examples on the card
        def example(name):
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(ROOT, "examples", f"{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod

        ex = out["EX"] = {}
        t0 = time.perf_counter()
        quick = example("torch_quickstart")
        with contextlib.redirect_stdout(io.StringIO()):
            on_cpu = quick.main(["--device", "cpu"])
        serve_ex = example("torch_serve_lm_ecc")
        ops.reset_launch_count()
        with Tally() as tally:
            tally._wrap(memory, "decode_read", "reads")
            print("  EX torch_quickstart on the card:")
            on_card = quick.main([])
            q_counts, q_reads = ops.launch_counts(), tally.n.get("reads", 0)
            print("  EX torch_serve_lm_ecc on the card:")
            ex["serve_main"] = serve_ex.main([])
            print("  EX torch_serve_lm_ecc --share-demo on the card:")
            ex["share_demo"] = serve_ex.main(["--share-demo"])
            counts, n_ = ops.launch_counts(), dict(tally.n)
        require(on_card == on_cpu, "EX quickstart: the card's numbers differ from the CPU's")
        want = {k_: 0 for k_ in q_counts}
        want.update(encode=1, inject=q_reads, decode=q_reads)
        require(q_counts == want, f"EX quickstart launches {q_counts}, expected {want}")
        ex["quickstart"] = {**on_card, "launches": q_counts}
        require(ex["share_demo"]["shared_identical"] and ex["share_demo"]["spec_identical"],
                "EX share demo")
        require(all(counts[k_] > 0 for k_ in ("inject_scrub", "inject_scrub_domains", "decode",
                                              "ecc_matmul", "encode", "gather_scrub", "inject",
                                              "fault_field")), f"EX launches {counts}")
        require(counts["gather_scrub"] == n_["intervals"] + n_["prefix_scrubs"]
                and counts["inject"] == n_["reads"] and n_["plain_on_card"] == 0,
                f"EX launches {counts}, tally {n_}")
        by_k = ops.ecc_matmul_launches_by_kernel()
        require(sum(by_k.values()) == counts["ecc_matmul"], f"EX B3 by kernel {by_k}")
        paths_extra["EX"] = {
            "launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
            "kv_codec": "secded72", "b3_by_kernel": by_k, "matmuls_per_forward": 0,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_.get("decode_kernel", 0)},
            "packs": n_["packs"], "commits": n_["commits"]}
        ex["launches"], ex["wall_s"] = counts, time.perf_counter() - t0
        print(f"  EX launches: {json.dumps(counts)} (quickstart {json.dumps(q_counts)}: "
              f"{q_reads} reads of one written array, its numbers = the CPU run's); EX in "
              f"{ex['wall_s']:.1f} s")
        return out

    with Phase("14 accuracy canary (qwen2-7b), campaign and sweeps"):
        accuracy_run = accuracy_phase(report, paths_extra)

    with Phase("15 dense family: minitron-8b, qwen1.5-4b, the sliding-window ring"):
        dense_run = dense_family_phase(report, paths_extra)

    with Phase("16 MoE family: mixtral-8x22b, llama4-scout, the examples"):
        moe_run = moe_phase(report, paths_extra)

    with Phase("17 recurrent families: rwkv6-3b, jamba's mamba"):
        recurrent_run = recurrent_phase(report, paths_extra)

    with Phase("18 vlm and audio families: llama-3.2-vision-11b, musicgen-medium"):
        vlm_audio_run = vlm_audio_phase(report, paths_extra)

    with Phase("19 training and checkpoints (path T): qwen3-0.6b at full width"):
        train_run, paths_extra["T"] = train_phase(dev, get_config("qwen3-0.6b"),
                                                  base.ModelConfig(**T_TINY))

    with Phase(f"20 reliability mesh (path MH): qwen3-0.6b on {MH_SHARDS} shards of one card"):
        mesh_run, paths_extra["MH"] = mesh_phase(dev, cfg, params, stream)

    with Phase(f"21 training mesh (paths MT, MTP, MTR, MTJ, MTV, MTA) on {MT_WORLD} ranks"):
        train_mesh_run, mt_records = train_mesh_phase(dev, {"arch": "qwen3-0.6b"},
                                                      train_run["a"]["losses"])
        paths_extra.update(mt_records)

    # ---------------------------------------------------------------- 22
    with Phase("22 traced steps, timings and the kernels line"):
        for name, run in runs.items():
            run["steps"] = step_breakdown(traced_params.pop(name), {"prefill": 0, "decode": 0},
                                          walls=run["steps"])
            for k_, r_ in run["steps"].items():
                if r_["traced_device_events"]:
                    # a decode step's matmuls ran the decode kernel, a
                    # prefill's the tiled one (the trace may drop events, so
                    # no count is required)
                    want_ = "decode" if k_ == "decode" else "tiled"
                    by_k = r_["ecc_matmul_launches_by_kernel"]
                    require(by_k[want_] == r_["ecc_matmul_launches"] > 0,
                            f"{name} {k_} step traced B3 launches {by_k}")
                    print(f"  {name} {k_} step (batch {BATCH}): wall {r_['wall_ms']:.2f} ms; "
                          f"traced: device busy {r_['device_busy_ms']:.2f} ms (idle share "
                          f"{r_['device_idle_share']:.3f}), fused ECC matmuls "
                          f"{r_['ecc_matmul_ms']:.2f} ms in {r_['ecc_matmul_launches']} "
                          f"launches of {b3_names[want_]} (share {r_['ecc_matmul_share']:.3f})")
                else:
                    print(f"  {name} {k_} step (batch {BATCH}): wall {r_['wall_ms']:.2f} ms; "
                          "device time not measured (the profiler traced no device event)")
        for name, run in runs.items():
            step = run.get("0.56V")
            kernel = report["inject_scrub_domains" if name == "multi-rail" else "inject_scrub"]
            print(f"  {name}: {run['1.0V']['tokens_per_s']:.1f} tokens/s at nominal "
                  f"(batch {BATCH}, {NEW_TOKENS} new tokens); nominal step "
                  f"{run['1.0V']['step_s']:.3f} s" + (
                      f"; 0.56 V step {step['step_s']:.2f} s = host masks "
                      f"{step['host_mask_s']:.2f} s + rest "
                      f"{step['step_s'] - step['host_mask_s']:.3f} s (scrub kernel "
                      f"{kernel['ms']:.3f} ms of it)" if step else ""))
        print(f"  runs {json.dumps(runs)}")
        print(f"  paged {json.dumps(paged)}")
        print(f"  fig3 {json.dumps(fig3)}")
        print(f"  per_leaf {json.dumps(per_leaf_run)}")
        print(f"  domain {json.dumps(domain_run)}")
        print(f"  device {json.dumps(device_runs)}")
        print(f"  accuracy {json.dumps(accuracy_run)}")
        print(f"  dense {json.dumps(dense_run)}")
        print(f"  moe {json.dumps(moe_run)}")
        print(f"  recurrent {json.dumps(recurrent_run)}")
        print(f"  vlm_audio {json.dumps(vlm_audio_run)}")
        print(f"  train {json.dumps(train_run)}")
        print(f"  mesh {json.dumps(mesh_run)}")
        print(f"  train_mesh {json.dumps(train_mesh_run)}")
        paths = {**runs, **{k: v for k, v in paged.items() if "launches" in v}, **paths_extra}

        print(f"  codec {json.dumps(codec_run)}")
        print(f"  decode launches of phases 4-9 by codec and loop: {decode_loops}")

        def by_path(kernel, kind=None, codec="secded72"):
            """A kernel's launches per path: the fused matmul's split between
            its decode kernel (forward passes of at most DECODE_MAX_M rows)
            and its tiled kernel (the others); a codec-generic kernel's
            launches under ``codec``, the encode's split into its plain form
            and its token-commit form (the commits of a path's kv codec)."""
            if kind in ("decode", "tiled"):
                # the launches by the kernel each took where the path counted
                # them (its forwards mix the kernels), else by forward kind
                fwd_ = {p: r["forwards"]["decode_kernel"] if kind == "decode" else
                        r["forwards"]["prefill"] + r["forwards"]["decode"]
                        - r["forwards"]["decode_kernel"] for p, r in paths.items()}
                return {p: paths[p]["b3_by_kernel"][kind] if "b3_by_kernel" in paths[p]
                        else paths[p]["matmuls_per_forward"] * f for p, f in fwd_.items()}
            if kernel not in ops.launch_counts_by_codec():
                return {p: r["launches"][kernel] for p, r in paths.items()}
            out = {}
            for p, r in paths.items():
                n = r["launches_by_codec"][kernel].get(codec, 0)
                if kernel == "fault_field":  # the burst kernel's launches, and the others'
                    bursts = r.get("burst_by_codec", {}).get(codec, 0)
                    n = bursts if kind == "burst" else n - bursts
                if kernel == "encode":
                    commits = (r["commits_by_codec"].get(codec, 0) if "commits_by_codec" in r
                               else r["commits"] if r.get("kv_codec", "secded72") == codec
                               else 0)
                    n = commits if kind == "commits" else n - commits
                out[p] = n
            return out

        src = "src/repro_torch/kernels/csrc/"
        generic = {  # entry -> (source, reference kernel, kernel, encode form)
            "inject_scrub": ("inject_scrub.cu", "src/repro/kernels/inject_scrub.py:203",
                             "inject_scrub", None),
            "inject_scrub_domains": ("inject_scrub.cu", "src/repro/kernels/inject_scrub.py:239",
                                     "inject_scrub_domains", None),
            "decode": ("secded.cu", "src/repro/kernels/secded.py:92", "decode", None),
            "encode": ("secded.cu", "src/repro/kernels/secded.py:76", "encode", "packs"),
            "encode_commit": ("secded.cu", "src/repro/kernels/secded.py:76", "encode",
                              "commits"),
            "gather_scrub": ("paged_gather.cu", "src/repro/kernels/paged_gather.py:108",
                             "gather_scrub", None),
            # no pallas_call: the reference draws with jax.random
            "fault_field": ("fault_field.cu", "src/repro/core/faultsim.py:204",
                            "fault_field", None),
            # the same launcher with a burst: the reference expands its
            # jax.random draw with scenario.expand_bursts
            "fault_field_burst": ("fault_field.cu", "src/repro/core/faultsim.py:204",
                                  "fault_field", "burst"),
        }
        meta, kernel_of = {}, {}
        for entry, (source, replaces, kernel, kind) in generic.items():
            for codec in codes.names():
                name = entry if codec == "secded72" else f"{entry}_{codec}"
                meta[name] = (source, replaces, by_path(kernel, kind, codec), codec)
                kernel_of[name] = kernel
        meta.update({
            "ecc_matmul_decode": ("ecc_matmul.cu", "src/repro/kernels/ecc_matmul.py:98",
                                  by_path("ecc_matmul", "decode"), "secded72"),
            "ecc_matmul_prefill": ("ecc_matmul.cu", "src/repro/kernels/ecc_matmul.py:98",
                                   by_path("ecc_matmul", "tiled"), "secded72"),
            "inject": ("fault_inject.cu", "src/repro/kernels/fault_inject.py:25",
                       by_path("inject"), None),
        })
        for p_, r_ in paths.items():  # the two B3 kernels split each path's count
            require(sum(meta[k][2][p_] for k in ("ecc_matmul_decode", "ecc_matmul_prefill"))
                    == r_["launches"]["ecc_matmul"], f"B3 launch split of {p_}")
            for kernel in ops.launch_counts_by_codec():  # the variants split each count
                require(sum(meta[n][2][p_] for n, k in kernel_of.items() if k == kernel)
                        == r_["launches"][kernel], f"{kernel} launch split of {p_}")
        kernels = []
        for name, (source, replaces, launches, codec) in meta.items():
            r = report[name]
            if kernel_of.get(name) == "decode":
                r["loops_phases_4_9"] = {
                    loop: decode_loops.get(f"{codec}:{loop}", 0) for loop in ("quad", "word")}
            mm = name.startswith("ecc_matmul")
            kernels.append({
                "name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches, "codec": codec,
                "max_abs_err": r.get("max_abs_err", 0.0), "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r.get("bound_by", "bytes"),
                "library_ms": r.get("library_ms"),
                **({"M": r["M"], "per": "one layer's 7 matmuls", "shapes": r["shapes"],
                    "max_rel_err": r["max_rel_err"], "function": r["function"]}
                   if mm else {"n_words": r["n_words"]}),
                **({k: r[k] for k in ("bytes_ms", "ops_ms", "ffma_ms", "masks", "ms_054",
                                      "launch_floor_ms", "path", "loops_phases_4_9",
                                      "ms_nominal", "counts", "distinct_words", "distinct_counts",
                                      "changed_words", "bound_26_32_ms", "bound_26_32_by",
                                      "drawn_words", "ops_per_drawn_word", "bytes_per_word",
                                      "sass_instructions", "ms_interval", "plain_ms_interval",
                                      "interval", "ms_multi_rail", "multi_rail",
                                      "ms_burst_free", "scenario", "philox_calls",
                                      "redundant_philox_calls", "neighbour_words", "class_draws",
                                      "word_draws", "flips", "flips_burst_free", "registers")
                    if k in r}),
                **({k: r[k] for k in ("mlp", "verify", "qwen2_7b", "minitron_8b", "qwen1_5_4b",
                                      "mixtral_8x22b", "llama4_scout", "musicgen_medium")
                    if k in r}),
            })
        kernels[[k["name"] for k in kernels].index("encode")]["kv_arena"] = report["encode_kv_arena"]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [T_CHILD_FLAG]:
        sys.exit(train_resume_child(sys.argv[2:]))
    if sys.argv[1:2] == [MT_CHILD_FLAG]:
        sys.exit(train_mesh_child(sys.argv[2:]))
    sys.exit(main())
