#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
result line is printed:

1. device   — the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
              exits 1 when no CUDA device is present.
2. build    — nvcc builds every kernel in ``src/repro_torch/kernels/csrc``
              (four sources, one nvcc each, all started together).
3. kernels  — each kernel against its plain PyTorch version on the card at
              the shapes of the paths below, in bf16 and fp32, with the
              reference's tolerances (``tests/test_kernels.py::_tol``:
              fp32 2e-5, bf16 2e-2, as ``torch.allclose`` rtol = atol);
              kernel, plain-version and one library call's device times
              (event pairs queued behind a device sleep, so they hold no
              host enqueue time); the kernel variant each call took and,
              where a call took a wgmma variant, the time of the route it
              took before (``earlier_ms``: the GEMMs' and the conv's WMMA
              tile, flash attention's SIMT kernel) at the same shape,
              forced through the wrapper's ``_launch``. Flash attention
              also runs a ragged S, a sliding window and a non-causal
              call, each held to the plain version, and h2o-danube-1.8b's
              heads (32 / 8 of 80, window 4096) at the shapes [window]
              launches (B = 4, S = 4160 and 4064; B = 1, S = 4160, 1024,
              256) and a ragged B = 4, S = 200; and [families]' shapes:
              every distinct packed GEMM of pixtral-12b (M = 4 and
              4 096), hubert-xlarge (M = 12 000, ``w_up`` with GELU),
              granite-3-2b and phi4-mini-3.8b (M = 4, 512, 2 048), and
              their prefills' flash calls (hubert's bidirectional at hd
              80 and a ragged S = 1 500), checked in bf16 and fp32 and
              timed in bf16 only; and [moe]'s: the packed GEMMs of
              qwen2-moe-a2.7b (M = 4, 64, 200, 512, 2 048; head 1, 4) and
              deepseek-moe-16b (M = 4, 512, 2 048), and the MHA 16 / 16
              hd-128 flash calls at B = 4, S = 128 and 512 and B = 1,
              S = 64, 200 and 512, the same way; and [ssm]'s: hymba-1.5b's
              packed GEMMs at block_p 64 (M = 1, 4, 64, 200, 512, 2 048),
              xlstm-1.3b's head (M = 4, 512, 2 048) and hymba's 25 / 5
              hd-64 flash calls with window 2 048 (B = 4, S = 512 and 128;
              B = 1, S = 2 048, 512, 200 and 64), the same way.
4. serve    — qwen2-1.5b at full width (28 layers, d_model 1536, vocab
              151 936, bf16), seeded random weights, greedy tile-pattern
              prune (4 of 8 lanes, block_p 128), packed, saved to a
              temporary directory and loaded back on the card (save and
              load seconds, bytes on disk; every leaf bit-equal), then
              served by the launcher's engine (``launch.serve.make_engine``:
              ``batch_size=4, max_seq_len=544``, CUDA graphs for decode
              and each prompt length's prefill, captured first) for 8
              requests (4 x 512-token and 4 x 128-token prompts, 32 new
              tokens each). Launch counts (graph replays add what their
              capture recorded) are zeroed just before the served run and
              read just after; every flash call must take the wgmma route.
              The tokens must equal those of the in-memory artifact; a
              seeded temperature request must get the same tokens in two
              batch compositions. Each chunk then runs through the graphs
              and through ``LM.prefill`` / ``LM.decode_many`` called
              eagerly: logits and tokens bit-identical, wall times (median
              of 3) eager against graph, launches per graph run, the
              engine's one graph memory pool (and what each capture
              added to it), and profiles (wall clock against device busy
              time, the kernels that hold it) of both prefills and, at
              S = 512, of both decodes; in each profile the launches the
              wrappers counted (graph replays included) must equal the
              trace's launches of their device functions, a trace that
              lost records retaken up to 3 times (``exact_trace``: only
              an exact trace passes, one that counts more fails).
5. identity — the same model in fp32, served dense-pruned and packed: the
              greedy tokens must be identical.
6. cnn      — VGG-16 (ImageNet head, 224 x 224, batch 32) and ResNet-18
              (CIFAR stem, 32 x 32, batch 256) at full width, seeded random
              weights, pruned ``pattern_shared`` at alpha 0.25, packed and
              bound; counts zeroed just before one bf16 forward and read
              just after (one ``pattern_conv`` launch per stride-1 3x3
              conv, each on the route ``conv_variant`` names for it, and
              at least one on the wgmma route); the median
              of 3 timed bf16 forwards; then in fp32 the
              dense-pruned forward (``F.conv2d``, no TF32) against the
              packed one: max |logit difference| and top-1 identity on
              every image whose dense top-2 gap exceeds twice it.
7. column   — qwen2-1.5b pruned by column at alpha 0.5, packed, its first
              4 layers saved and loaded (every leaf bit-equal) and served
              to the in-memory cut's tokens, the whole served as
              in phase 4 (``column_gemm`` on every packed GEMM, prefill
              and decode); then fp32 dense-pruned
              against packed greedy tokens at 4 layers of full width,
              which must be identical.
7b. roofline — the port's roofline attribution (``roofline/``) at full
              width in bf16 (activations modeled at 2 bytes): every
              distinct packed leaf of [serve]'s tile artifact and
              [column]'s artifact at M = 4, 512 and 2 048, and of VGG-16
              ``pattern_shared`` (224 x 224) on one 64 x 64 and one
              256 x 256 image, each leaf profiled alone through the
              registry (``profile_packed_tree``, counts zeroed around
              them; each dispatch queued behind an L2 flush and a device
              sleep, so a wall is the kernel's cold device time, not the
              host's enqueue) and attributed alone (``attribute``):
              measured and modeled us, achieved fraction, bound, beside the
              ``[kernels]`` row of the same shape (a cross-check, not a
              gate); gate: every row modeled, every fraction in (0,
              1.05]; the report written to
              ``experiments/bench_torch/attribution.json``.
8. continuous — the [serve] phase's loaded artifact through
              ``ContinuousEngine(batch_size=4, max_seq_len=544,
              chunk_steps=8)``: slot prefill graphs of S = 512, 200 and 64
              and the slot decode graph captured (seconds, pool bytes);
              the main path, 12 requests with prompt lengths 512 / 200 / 64
              and budgets 32 / 8 / 16 cycling, arriving at seeded
              exponential gaps of about one decode chunk, counts zeroed
              around it, with a trace and a registry: wall, tokens/s,
              occupancy, chunks, decode ms per chunk step, TTFT / TPOT
              from the registry and per S from the trace; gates: every
              admission on flash's wgmma route (28 x 12 launches, no
              fallback), ``pattern_gemm`` on skinny and wgmma, the trace
              recomputing the registry (``runtime.trace_analysis``), each
              request bit-identical to its solo run through the same
              engine, graphs against eager on one scripted schedule
              (every chunk's tokens and flags), a KV poison / deadline /
              cancel run and a bounded queue with their typed statuses
              (mates bit-identical to solo; ``stats`` equal to the
              registry); the chunked ``ServeEngine`` on the same requests
              as a reading; at 4 layers in fp32, continuous greedy tokens
              equal to ``ServeEngine(batch_size=1)``'s. The main path's
              trace is kept as
              ``experiments/bench_torch/trace_telemetry.jsonl``.
8b. analyze — ``python -m repro_torch.launch.analyze`` on that trace and
              [roofline]'s report with ``--out``: exit 0, the analysis
              counts the 12 requests, all ok, and holds the attribution
              rows; a missing trace exits 2.
9. speculative — qwen2-1.5b, bf16, batch 4, 4 x 128-token prompts, 64
              new tokens, ``draft_k`` 4, ``SpeculativeEngine`` over CUDA
              graphs (a round: both snapshots, K drafter steps, the
              verify chunk, acceptance, both rollbacks): arm (a) the
              [serve] artifact bound packed drafts for its pruned weights
              bound dense; (b) the unpruned weights' first 14 layers
              draft for all 28 (demotion off); (c) a re-initialised
              drafter that must demote. Each arm: a first generate
              captures, counts zeroed around a second; gates: tokens
              valid, demoted as expected, launches by route as designed
              (flash on every prefill, all wgmma; a packed drafter's
              layer GEMMs on wgmma in its prefill, every GEMM on skinny
              in each of its K steps a round; no blockwise fallback),
              round graph against eager bit for bit (both caches, the
              pending tokens, the round blocks); readings: tokens/s,
              rounds, acceptance, bf16 agreement with plain decoding,
              plain ``ServeEngine`` tokens/s and decode-step device ms on
              the pruned-dense, packed and unpruned weights, device ms
              of a round, a drafter step and a verify chunk (graph
              replays) and a profile of one round. At 4 layers in fp32
              every arm's greedy tokens equal plain decoding's.
9b. tune    — the plan tuner, the plan-cached registry and the profiler
              on the [serve] artifact (qwen2-1.5b, tile 4 of 8, bf16):
              (b) every candidate plan ``torch.equal`` to the untuned call
              for the tile and column GEMMs at qwen2-1.5b's shapes (M = 4,
              17, 24, 32, 512, 2 048) and VGG-16's convs at batch 32; (a)
              the artifact tuned for M = 4, 512 and 2 048 (each geometry's
              candidates' ms, winner, heuristic's ms and search seconds;
              one search per geometry and bucket); (c) the tuned artifact
              through the launcher's engine (graphs), counts zeroed around
              its main path, tokens equal to [serve]'s untuned ones,
              prefill ms a chunk and decode ms a step tuned and untuned;
              (d) its first 4 layers saved and loaded: plans kept,
              served under ``REPRO_AUTOTUNE=1`` with no search and the
              in-memory cut's tokens; (e)
              ``profiler_scope(sample_rate=1.0)`` over an eager decode
              (its rows beside the [kernels] rows' mix, tokens unchanged)
              and the graph path's tokens/s off and at full sampling
              (overhead printed, not gated). Every search runs before the
              counted window.
10. window  — sliding-window serving on a ring cache: h2o-danube-1.8b at
              full width (24 layers, d_model 2560, 32 / 8 heads of 80,
              window 4096, bf16), seeded random weights, greedy
              tile-pattern 4 of 8 at block_p 128, packed, its first 4
              layers saved and loaded (seconds, bytes) and served to the
              in-memory cut's tokens. (a)
              ``ServeEngine`` through its
              graphs at batch 4, ``max_seq_len`` 4352 (a ring of 4096):
              4 x 4160-token prompts (the prefill wraps) and 4 x 4064
              (the decode wraps), 64 new; (b) ``ContinuousEngine``, 8
              requests (prompts 4160 / 1024 / 256, budgets 64 / 32 / 48)
              at seeded arrivals; (c) ``SpeculativeEngine``, the artifact
              packed drafting for its pruned weights bound dense, 4 x
              4064 prompts, 64 new, ``draft_k`` 4, rounds across the wrap.
              Counts zeroed around each main path; gates: every prefill
              flash call on wgmma at hd 80 (24 a forward), no blockwise
              fallback, ``pattern_gemm`` on skinny and wgmma, graph ≡
              eager (each (a) chunk's logits and 63 decode tokens, 20
              speculative rounds), continuous ≡ solo at batch 4, and at 4
              layers in fp32 packed tokens ≡ dense-pruned for (a) and (c).
              Readings: prefill ms per chunk, decode ms per step (graph
              medians), tokens/s, acceptance, peak device memory, a
              profile of a decode step on the wrapped ring.
11. families — (a) pixtral-12b at full width and depth (40 layers,
              d_model 5120, 32 / 8 heads of 128, vocab 131 072, bf16),
              seeded random weights pruned greedily a layer at a time
              (tile 4 of 8, block_p 128), packed and bound; the main
              path, counts zeroed around it: a 4 x 1 024 prefill on
              seeded patch embeddings (``max_seq_len`` 1 088), then 32
              ``decode_step``s on seeded (4, 1, 5 120) embeddings, as the
              reference's dry run decodes (the engines refuse a model
              fed embeddings: decoding feeds token ids back); gates:
              launches as designed, flash on wgmma (40 a prefill), no
              fallback; readings: weight bytes dense and packed, prefill
              ms, decode ms a step, profiles of a prefill and a decode
              step, peak memory; at 4 of 40 layers in fp32 the same
              argmax and logits within 2e-5 packed against dense-pruned
              at the prefill and every step; the artifact at 2 of 40
              layers saved, loaded, every leaf bit-equal, no ``embed``.
              (b) hubert-xlarge at full width and depth (48 layers,
              16 / 16 heads of 80, GELU, bidirectional), its 504-wide
              head left dense: one encoder forward (``hidden_states``
              with flash, ``lm_logits``) on 8 x 1 500 seeded frames, the
              same gates (flash 48 a forward), ms, a profile; the fp32
              bar at 4 of 48 layers on every frame. (c) layer-wise ADMM
              on N(0, 1) synthetic embeddings, pixtral-12b at 2 of 40
              layers, ``[admm]``'s settings: seconds per iteration, busy
              share, peak memory; packed, one prefill. (d) granite-3-2b
              (hd 64, its 49 155-wide head dense) and phi4-mini-3.8b
              (its 3 072 x 200 064 head packed) at full width and depth
              served as ``[serve]`` serves qwen2-1.5b: prefill ms a
              chunk and decode ms a step from graph replays, fp32 token
              identity at 4 layers. Each part prints its ``[time]``.
12. moe     — the MoE family, each part with its ``[time]``: (a)
              qwen2-moe-a2.7b at full width and depth (24 layers,
              d_model 2048, 16 / 16 heads of 128, 60 routed experts of
              1 408 top-4 + 4 shared, vocab 151 936, bf16), seeded random
              weights; tile-pattern with the routed experts not excluded
              raises (the reference's ``ValueError``); pruned a layer at a
              time with them excluded (tile 4 of 8, block_p 128), packed
              (attention, shared SwiGLU and head; the experts stay dense
              and must be the init's tensors, not copies), served by the
              launcher's engine as ``[serve]`` serves qwen2-1.5b (8
              requests, 32 new): launches 2 x 32 x (7 L + 1)
              ``pattern_gemm`` and 2 L flash, all wgmma, graph ≡ eager on
              the S = 512 chunk; readings: weight bytes, peak memory,
              prefill ms a chunk and decode ms a step (graph replays), a
              profile of a decode replay and a split of an eager decode
              step (router, dispatch / combine, expert einsums,
              ``pattern_gemm``, attention); (b) the same model through
              ``ContinuousEngine`` (6 requests of S 512 / 200 / 64, each
              bit-identical to its solo run) and ``SpeculativeEngine``
              (the artifact packed drafting for its pruned weights bound
              dense, ``[speculative]``'s settings; round graph ≡ eager);
              (c) deepseek-moe-16b (7 of its 28 layers, full width: 64
              routed top-6 + 2 shared, vocab 102 400) as (a); (d) at 4 layers of full
              width in fp32, both configs: packed tokens ≡ dense-pruned,
              continuous ≡ ``ServeEngine(batch_size=1)``; (e) the
              artifact at 2 layers saved, loaded bit-equal and served;
              (f) one layer-wise ADMM iteration at 2 of 24 layers on
              uniform synthetic tokens (batch 16 x 64): seconds, busy
              share, launches; packed, one prefill gated.
13. ssm     — the recurrent families, each part with its ``[time]``:
              (a) hymba-1.5b at full width, 16 of 32 layers (d_model
              1600, 25 / 5 heads of 64, d_ff 5504, mamba 25 x 64 with
              N 16, window 2048, bf16): tile with the mamba leaves in
              raises (the reference's ``ValueError``); pruned a layer at
              a time (tile 4 of 8, block_p 64, mamba and the 32 001-wide
              head excluded), packed (its first 4 layers saved and
              loaded, every leaf bit-equal, served to the in-memory cut's
              tokens) and bound; served as
              ``[moe]`` serves (8
              requests, 32 new: 2 x 32 x 7 L ``pattern_gemm``, 2 L flash
              on wgmma), each prefill graph's capture seconds, graph ≡
              eager, readings (prefill ms a chunk, decode ms a step,
              state and KV bytes), a profile of a decode replay, the
              device split of an eager prefill and decode step (mamba
              against the rest; the prefill's launches are its graph's
              nodes); a 2 048-token prompt + 64 new tokens on a 2 048
              ring through the graphs (its capture seconds);
              ``ContinuousEngine`` on 8 requests of S 512 /
              200 / 64 (flash on wgmma per admission, each ≡ its solo
              run); ``SpeculativeEngine`` refuses. (b) xlstm-1.3b (16 of
              its 48 blocks: 2 of 6 groups of 7 mLSTM + 1 sLSTM, d_model
              2048, 4 heads of 512): tile with the cells in raises; greedy tile
              with the cells excluded packs the head alone; served as
              (a) (2 x 32 head launches, no flash), graph ≡ eager; the
              continuous and speculative engines refuse; the device
              split of an eager prefill (mLSTM chunks against the sLSTM
              time loop) and decode step. (c) ADMM at full width on
              uniform synthetic tokens (batch 16 x 64): hymba layer-wise
              at 2 of 32 layers (packed, one prefill gated), xlstm
              whole-model at one group of 8 blocks: seconds, busy share,
              launches, peak. (d) fp32 at full width: hymba at 4 layers
              (packed ≡ dense-pruned tokens, continuous ≡
              ``ServeEngine(batch_size=1)``), xlstm at one group (packed
              ≡ dense-pruned).
14. admm    — the paper's algorithm: qwen2-1.5b at full width (bf16,
              seeded random teacher) pruned by layer-wise ADMM on
              synthetic tokens (``PrivacyPreservingPruner`` with
              ``launch.prune.prune_config_for(scheme="tile_pattern",
              rate=2, iters=8, batch=16)``, ``LMAdapter(seq_len=64)``):
              loss and residuals per iteration, seconds per iteration
              (median of the last 6), peak device memory, one more
              iteration profiled (device busy share) and one split by
              phase (teacher pass, primal steps, projection + dual; each
              phase must have been timed);
              gates: finite metrics, exactly 4 of 8 lanes per tile in
              every pruned leaf, ``privacy.data == "synthetic"``. The
              greedy prune's layer-wise loss is printed beside ADMM's.
              Then packed and served by the launcher's engine (4 x 128
              prompt tokens, 16 new; counts zeroed around it): every
              flash call on wgmma, no blockwise fallback, ``pattern_gemm``
              launched, every packed leaf exact. In bf16 the primal
              steps round back to the weights (the reference's dtype
              rules), so at 2 layers the params are fp32: whole-model
              ADMM (2 iterations, finite); a run stopped by its callback
              after iteration 2 and resumed (checkpoints every 2), bit-
              equal to an uninterrupted one, with some pruned leaf off
              the greedy projection (the weights moved), and the greedy
              loss printed beside ADMM's; ``launch.prune --reduced``
              then ``launch.serve --reduced --artifact --packed`` as
              subprocesses: both exit 0, serve prefilling on flash's
              SIMT route (head_dim 16), no blockwise fallback.
15. admm_cnn — VGG-16 at full width (ImageNet head, 224 x 224, fp32)
              pruned by layer-wise ADMM ``pattern_shared`` alpha 0.25
              (batch 32, 4 iterations; some pruned leaf off the greedy
              projection), retrained by 10 masked AdamW steps on
              ``data.ClassificationPipeline`` batches of 10 classes:
              masked-out weights stay exactly 0 and the loss falls by
              at least 0.01 (mean of the last 3 against the first); packed, one bf16 forward with one
              ``pattern_conv`` launch per stride-1 3x3 conv (counts zeroed
              around it); the fp32 top-1 gate of ``[cnn]``. Seconds per
              iteration and per step, peak memory.
16. pipeline — the privacy-preserving pruning service
              (``launch.pipeline.main`` in process, full scale, quick
              budgets, no stage retries: every stage must succeed on
              its one attempt): VGG-16 at width 1.0 on 32 x 32 x 3
              (batch 64), each stage's seconds, attempts and peak device
              memory (the pipeline's telemetry.json), the three
              MIA rows (dense / ADMM-real / ADMM-synthetic: AUC with its
              CI, shadow AUC, loss gap) and the manifest's deltas beside
              the reference's limits (readings, not gates); the saved
              artifact loaded (every CRC32 checked), one packed bf16
              forward (counts zeroed around it: one ``pattern_conv``
              launch per stride-1 3x3 conv on its route, no bind
              fallback) and the fp32 top-1 gate of ``[cnn]``. Then a run
              whose retrain fails once under ``--stage-retries 0`` (a
              ``StageError`` naming ``retrain``; teacher and prune ok on
              the ledger) and its ``--resume`` (both restored with 0
              attempts, params bit-equal to the first run's). Then
              qwen2-1.5b at full width, 2 of 28 layers: its saved
              artifact served through the CUDA graphs (4 x 128 prompt
              tokens, 16 new; counts zeroed around it: ``pattern_gemm``
              launched, every flash call on wgmma, no fallback) and fp32
              dense-pruned vs packed greedy tokens identical.
16b. train  — ``launch.train.run_training`` on qwen2-1.5b at full width,
              4 of 28 layers, batch 8 x 512 tokens, bf16, with the masks of
              a greedy tile prune (4 of 8) of the same seed's init: 4
              steps (s per step, losses, the straggler monitor's snapshot,
              peak memory); gates: every pruned weight still exactly 0; a
              run stopped once its step-2 checkpoint committed, resumed
              from it for the 2 steps left, ends bit-equal to the
              uninterrupted run; 3 steps with int8 gradient compression give
              finite losses and every residual within half its scale.
              Beside it ``python -m repro_torch.launch.train --arch
              qwen2-1.5b --reduced --steps 20 --batch 8 --seq 128`` as a
              subprocess: exit 0 and the reference's line.
16c. examples — ``examples/torch_quickstart.py``,
              ``torch_prune_then_serve_lm.py``,
              ``torch_privacy_pruning_cnn.py`` and
              ``torch_distributed_masked_retraining.py`` with the
              reference's defaults (the last at world size 1: one rank
              on the card, NCCL, its 1 × 1 -> 1 × 1 meshes), four
              subprocesses started together just before [pipeline], run
              beside it and waited for before [train] (the ``[time]``
              line: the longest one's own seconds, under contention),
              each printing the kernel launches it made: exit 0, packed
              tokens identical to dense (``pattern_gemm`` and flash
              launched, no blockwise fallback), the quickstart's packed
              accuracy equal to its retrained accuracy (``pattern_conv``
              launched), the distributed example's resumed and elastic
              loss paths equal.
16d. scaleout — an NCCL process group of one rank (a ``FileStore`` in a
              temporary directory, no TCP port) and a 1 × 1 ("data",
              "model") mesh: (a) ``run_training(mesh=...)`` with [train]'s
              int8-compressed run's config, masks, seed and steps; gates:
              every loss, grad norm and residual ratio and every final
              param bit-equal to [train]'s unsharded run (whose numbers
              it reuses), pruned weights 0; s per step beside [train]'s.
              (b) at 2 of 28 layers, a train state saved on the mesh and
              restored through ``CheckpointManager.restore(...,
              shardings=...)`` onto the mesh and onto no mesh: every leaf
              bit-equal. (c) started after (a)'s steps, beside (b),
              ``python -m repro_torch.launch.dryrun --arch qwen2-1.5b
              --shape all --mesh both --jobs 6`` on the fake process
              group: every
              applicable cell OK, long_500k SKIP with the reference's
              reason; per cell the per-device argument bytes, FLOPs,
              collective bytes by type, the roofline report's dominant
              term and useful ratio (gate: at most 1.05) and seconds.
              (d) after (a), on the same mesh, beside (c): the MoE,
              hybrid and ssm families at full width, cut in depth
              (qwen2-moe-a2.7b 1 of 24 layers, hymba-1.5b 2 of 32,
              xlstm-1.3b 8 of 48 blocks: one mLSTM group and its sLSTM
              block), seeded random bf16 weights: ``run_training`` for 2
              steps with [train]'s batch and int8 config and a seeded
              50% mask of every 2-D leaf but the embedding (the cells'
              and the heads; xlstm-1.3b's grouped mLSTM per-layer
              vectors too, so half its forget biases are 0), on the
              mesh and on none; gates: every metric and final param bit-equal,
              every metric finite, pruned weights 0. Then a sharded
              ``prefill`` of 4 x 512 prompts and 8 greedy
              ``decode_step``s against the
              unsharded ones: every step's logits and tokens bit-equal;
              the sharded MoE and hymba prefills launch
              ``flash_attention`` on their local shards once a layer,
              with no blockwise fallback (the shapes of [kernels]' 16 /
              16 hd-128 and 25 / 5 hd-64 window-2 048 cases at B = 4,
              S = 512). Seconds and peak device memory per family. Then
              the process group is destroyed.
17. report  — one ``{"kernels": [...]}`` JSON line covering all four
              kernels (each a sum over the bf16 shapes its served path
              launches; the GEMMs' ``lm_head`` at M = 512 and 2048, which
              prefill never launches, and every GEMM at a verify chunk's
              M = 16, which [speculative]'s dense targets never launch,
              listed apart under ``not_on_path``,
              and their per-layer sums at the prefill chunks' M under
              ``per_layer_m512`` and ``per_layer_m2048``; flash
              attention's S = 200, window and non-causal rows apart too;
              ``earlier_ms`` the same shapes on the routes they took
              before their wgmma route), the
              card's name and power limit, then as the last line
              ``{"ok": true, "device": {...}}``.

Imports nothing of ``jax`` or ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint import CheckpointManager, load_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import LayerSpec, PruneConfig, greedy_prune  # noqa: E402
from repro_torch.core import (  # noqa: E402
    LMAdapter,
    PrivacyPreservingPruner,
    as_key,
    cross_entropy,
    frobenius_distance,
    make_retrain_step,
)
from repro_torch.core import admm as admm_mod  # noqa: E402
from repro_torch.core.projections import (  # noqa: E402
    project,
    project_column,
    project_tile_pattern,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import column_gemm as cg_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import pattern_conv as pc_mod  # noqa: E402
from repro_torch.kernels import pattern_gemm as pg_mod  # noqa: E402
from repro_torch.data import ClassificationPipeline, DataConfig  # noqa: E402
from repro_torch.launch import analyze as launch_analyze  # noqa: E402
from repro_torch.launch import pipeline as launch_pipeline  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.prune import prune_config_for  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.shapes import skip_reason  # noqa: E402
from repro_torch.launch.train import init_state, run_training  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    axis_rules,
    batch_spec,
    default_rules,
    gather_full,
    is_dtensor,
    param_shardings,
    shard,
    shard_tree,
    shardings_of,
)
from repro_torch.roofline import report as roofline_report  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.privacy import report as privacy_report  # noqa: E402
from repro_torch.roofline import attribution, hw  # noqa: E402
from repro_torch.runtime import StageError  # noqa: E402
from repro_torch.models import LM, attention, resnet18, vgg16  # noqa: E402
from repro_torch.runtime import trace_analysis  # noqa: E402
from repro_torch.runtime import profiler_scope  # noqa: E402
from repro_torch.runtime.telemetry import (  # noqa: E402
    MetricsRegistry,
    Telemetry,
    read_trace,
    registry_scope,
)
from repro_torch.serve import (  # noqa: E402
    CancelToken,
    ContinuousEngine,
    Request,
    ServeEngine,
)
from repro_torch.serve.graphs import CountedGraph  # noqa: E402
from repro_torch.serve.sampler import fold_key_grid  # noqa: E402
from repro_torch.serve.speculative import (  # noqa: E402
    SpeculativeEngine,
    shallow_drafter,
)
from repro_torch.sparse import PrunedArtifact, is_packed  # noqa: E402
from repro_torch.sparse import tune as tune_mod  # noqa: E402
from repro_torch.sparse.packed import tree_packed_bytes  # noqa: E402
from repro_torch.sparse.registry import (  # noqa: E402
    SCHEMES,
    conv_gemm_runner,
    handler_for,
)
from repro_torch.utils.tree import reference_path  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    ScriptedClock,
    chunk_action_hook,
    kv_poison_hook,
)
from repro_torch.utils.tree import (  # noqa: E402
    tree_items,
    tree_leaves,
    tree_map,
    unflatten,
)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# H100 SXM data-sheet peaks (dense, ``roofline/hw.py``): HBM bytes/s; bf16
# tensor-core and fp32 CUDA-core FLOP/s (the kernels' fp32 paths run on
# the CUDA cores)
HBM_BPS = hw.HBM_BW
PEAK_FLOPS = {torch.bfloat16: hw.PEAK_FLOPS_BF16,
              torch.float32: hw.PEAK_FLOPS_FP32}
L2_FLUSH_BYTES = 64 << 20          # > the 50 MB L2: every timed call starts cold
SLEEP_HZ = 2.0e9                   # >= the H100's top SM clock: a device sleep
                                   # of n cycles lasts at least n / SLEEP_HZ s

# (name, Q, P, bias, activation) — every distinct qwen2-1.5b packed GEMM
QWEN2_GEMMS = (
    ("wq", 1536, 1536, True, None),
    ("wk/wv", 1536, 256, True, None),
    ("wo", 1536, 1536, False, None),
    ("w_gate", 1536, 8960, False, "silu"),
    ("w_up", 1536, 8960, False, None),
    ("w_down", 8960, 1536, False, None),
    ("lm_head", 1536, 151936, False, None),
)
GEMM_MS = (4, 512, 2048)            # decode (M = batch); prefill chunks of
                                    # 4 x 128 and 4 x 512 tokens
# [continuous] prefills each admission alone: its layer GEMMs run at M = S
# (64, 200 and 512 above) and its head at M = 1 (the last token); the fp32
# bar's ServeEngine(batch_size=1) decodes at M = 1
SOLO_MS = (1, 64, 200)
# a speculative verify chunk runs a packed target's GEMMs, the head too,
# at M = batch x draft_k = 16 (skinny); [speculative]'s targets are dense,
# so these rows are checked and timed apart from the served path
VERIFY_MS = (16,)
# every distinct h2o-danube-1.8b packed GEMM ([window]); its layer GEMMs
# run at M = 4 (decode, drafter steps), 256 / 1024 / 4160 (continuous
# admissions), 16 256 / 16 640 (4 x 4064 and 4 x 4160 prefill chunks), its
# head at M = 4 and 1 (the last token of a chunk, of an admission)
DANUBE_GEMMS = (
    ("wq", 2560, 2560, False, None),
    ("wk/wv", 2560, 640, False, None),
    ("wo", 2560, 2560, False, None),
    ("w_gate", 2560, 6912, False, "silu"),
    ("w_up", 2560, 6912, False, None),
    ("w_down", 6912, 2560, False, None),
    ("lm_head", 2560, 32000, False, None),
)
DANUBE_MS = (4, 256, 1024, 4160, 16256, 16640)
DANUBE_HEAD_MS = (1, 4)
# [families]' packed GEMMs, each model's distinct ones. pixtral-12b (a):
# its layer GEMMs at M = 4 (a decode step) and 4 096 (a 4 x 1 024
# prefill), its head at M = 4 (the prefill's last positions, each step)
PIXTRAL_GEMMS = (
    ("wq", 5120, 4096, False, None),
    ("wk/wv", 5120, 1024, False, None),
    ("wo", 4096, 5120, False, None),
    ("w_gate", 5120, 14336, False, "silu"),
    ("w_up", 5120, 14336, False, None),
    ("w_down", 14336, 5120, False, None),
    ("lm_head", 5120, 131072, False, None),
)
PIXTRAL_MS = (4, 4096)
# hubert-xlarge (b): one encoder forward of 8 x 1 500 frames (M = 12 000);
# its 504-wide head stays dense
HUBERT_GEMMS = (
    ("wq/wk/wv/wo", 1280, 1280, False, None),
    ("w_up", 1280, 5120, False, "gelu"),
    ("w_down", 5120, 1280, False, None),
)
HUBERT_MS = (12000,)
# granite-3-2b and phi4-mini-3.8b (d), served as [serve] serves qwen2:
# layer GEMMs at M = 4, 512 and 2 048, the head at M = 4; granite's
# 49 155-wide head stays dense
GRANITE_GEMMS = (
    ("wq", 2048, 2048, False, None),
    ("wk/wv", 2048, 512, False, None),
    ("wo", 2048, 2048, False, None),
    ("w_gate", 2048, 8192, False, "silu"),
    ("w_up", 2048, 8192, False, None),
    ("w_down", 8192, 2048, False, None),
)
PHI4_GEMMS = (
    ("wq", 3072, 3072, False, None),
    ("wk/wv", 3072, 1024, False, None),
    ("wo", 3072, 3072, False, None),
    ("w_gate", 3072, 8192, False, "silu"),
    ("w_up", 3072, 8192, False, None),
    ("w_down", 8192, 3072, False, None),
    ("lm_head", 3072, 200064, False, None),
)
# [moe]'s packed GEMMs: qwen2-moe-a2.7b's attention projections (all four
# 2 048 x 2 048) and shared SwiGLU (4 x 1 408 wide) at M = 4 (decode, the
# drafter's steps), 64 / 200 / 512 (continuous admissions, the drafter's
# 4 x 128 prefill) and 2 048 (a 4 x 512 chunk), its head at M = 1 and 4;
# deepseek-moe-16b's shared SwiGLU (2 x 1 408) and head at M = 4, 512 and
# 2 048 (its attention is qwen2-moe's shape). The routed experts stay
# dense einsums.
QWEN2_MOE_GEMMS = (
    ("wq/wk/wv/wo", 2048, 2048, False, None),
    ("w_gate", 2048, 5632, False, "silu"),
    ("w_up", 2048, 5632, False, None),
    ("w_down", 5632, 2048, False, None),
    ("lm_head", 2048, 151936, False, None),
)
QWEN2_MOE_MS = (4, 64, 200, 512, 2048)
DEEPSEEK_MOE_GEMMS = (
    ("w_gate", 2048, 2816, False, "silu"),
    ("w_up", 2048, 2816, False, None),
    ("w_down", 2816, 2048, False, None),
    ("lm_head", 2048, 102400, False, None),
)
# [ssm]'s packed GEMMs. hymba-1.5b (a) at block_p 64 (1 600 / 128 is not
# whole; Kp = 800 is no multiple of the 64-wide K tile): its attention and
# SwiGLU at M = 4 (decode), 64 / 200 / 512 (continuous admissions), 1
# (the wrap request's decode), 512 / 2 048 (4 x 128 and 4 x 512 chunks, the
# 2 048-token wrap prompt); its 32 001-wide head stays dense. xlstm-1.3b
# (b): only its head packs (the cells stay dense), run on the last token
# at M = 4 in prefill and decode; M = 512 and 2 048 are checked and timed
# beside it.
HYMBA_BLOCK_P = 64
HYMBA_GEMMS = (
    ("wq/wo", 1600, 1600, False, None),
    ("wk/wv", 1600, 320, False, None),
    ("w_gate", 1600, 5504, False, "silu"),
    ("w_up", 1600, 5504, False, None),
    ("w_down", 5504, 1600, False, None),
)
HYMBA_MS = (1, 4, 64, 200, 512, 2048)
XLSTM_HEAD = (("lm_head", 2048, 50304, False, None),)
XLSTM_HEAD_MS = (4, 512, 2048)
FLASH_SHAPES = dict(H=12, KV=2, hd=128)
# (B, S, causal, window): the served prefill chunks (B = 4, S = 128, 512),
# the ragged edge (S = 200), a sliding window, a non-causal call, and
# [continuous]'s solo admissions (B = 1, S = 64, 200, 512)
FLASH_CASES = ((4, 128, True, None), (4, 200, True, None),
               (4, 512, True, None), (4, 512, True, 128),
               (4, 512, False, None), (1, 64, True, None),
               (1, 200, True, None), (1, 512, True, None))
FLASH_SERVED = ((4, 128), (4, 512), (1, 64), (1, 200), (1, 512))
# h2o-danube-1.8b's heads (32 / 8 of 80, window 4096), every call causal
# with the window: [window]'s chunked prefills (B = 4, S = 4160 and 4064),
# its continuous admissions (B = 1, S = 4160, 1024, 256) and a ragged
# B = 4, S = 200 that no phase launches
WINDOW = 4096
FLASH_HD80 = dict(H=32, KV=8, hd=80)
FLASH_HD80_CASES = tuple((B, S, True, WINDOW) for B, S in (
    (4, 4160), (4, 4064), (1, 4160), (1, 1024), (1, 256), (4, 200)))
FLASH_HD80_SERVED = ((4, 4160), (4, 4064), (1, 4160), (1, 1024), (1, 256))
# [families]' prefills: pixtral-12b (32 / 8 of 128) on 4 x 1 024 patches,
# causal; hubert-xlarge (16 / 16 of 80) on 8 x 1 500 frames, both ways (S
# no multiple of any tile); granite-3-2b (32 / 8 of 64) and phi4-mini-3.8b
# (24 / 8 of 128) on [serve]'s chunks; [moe]'s MHA (16 / 16 of 128) on
# those chunks and on [continuous]'s solo admissions
FAMILY_FLASH = (
    (dict(H=32, KV=8, hd=128), ((4, 1024, True, None),)),
    (dict(H=16, KV=16, hd=80), ((8, 1500, False, None),)),
    (dict(H=32, KV=8, hd=64), ((4, 128, True, None), (4, 512, True, None))),
    (dict(H=24, KV=8, hd=128), ((4, 128, True, None), (4, 512, True, None))),
    (dict(H=16, KV=16, hd=128), ((4, 128, True, None), (4, 512, True, None),
                                 (1, 64, True, None), (1, 200, True, None),
                                 (1, 512, True, None))),
    # [ssm]'s hymba-1.5b (25 / 5 of 64, a GQA group of 5, window 2 048):
    # its chunks, the 2 048-token wrap prompt, its continuous admissions
    (dict(H=25, KV=5, hd=64), tuple((B, S, True, 2048) for B, S in (
        (4, 512), (4, 128), (1, 2048), (1, 512), (1, 200), (1, 64)))),
    # the reduced qwen2 (4 / 2 of 16, the SIMT route): [examples]' LM
    # example (8 prompts of 8..15 tokens) and [admm]'s ``launch.serve
    # --reduced`` (8 x 16)
    (dict(H=4, KV=2, hd=16), ((8, 15, True, None), (8, 16, True, None))),
)
# (batch, H = W, C, A): every distinct stride-1 3x3 conv of VGG-16 at
# 224 x 224, batch 32, and of ResNet-18 (CIFAR stem) at 32 x 32, batch 256
VGG16_CONVS = tuple((32, h, c, a) for h, c, a in (
    (224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
    (56, 128, 256), (56, 256, 256), (28, 256, 512), (28, 512, 512),
    (14, 512, 512)))
RESNET18_CONVS = tuple((256, h, c, a) for h, c, a in (
    (32, 3, 64), (32, 64, 64), (16, 128, 128), (8, 256, 256), (4, 512, 512)))
CNN_PATHS = (
    # (tag, constructor, kwargs, batch, packed convs per forward)
    ("vgg16", vgg16, dict(num_classes=1000, image_hwc=(224, 224, 3)), 32, 13),
    # 17 3x3 convs less the 3 strided ones, which bind keeps dense
    ("resnet18", resnet18, dict(num_classes=10, image_hwc=(32, 32, 3)), 256,
     14),
)
COLUMN_IDENTITY_LAYERS = 4
# an artifact's save-and-load round trip beside a served path that has
# already made one ([serve]'s) runs on its first layers, at full width
ROUND_TRIP_LAYERS = 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


_FLUSH = None


def timed_ms(fn, iters: int = 10) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, each after an L2 flush
    (CUDA events around the call only). The timed calls queue behind a
    device-side sleep longer than the host takes to enqueue them, so the
    card never waits on the host inside an event pair."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _FLUSH.zero_()
    fn()
    enqueue_s = time.perf_counter() - t0        # host time to enqueue one
    torch.cuda.synchronize()
    torch.cuda._sleep(int((2 * iters * enqueue_s + 2e-3) * SLEEP_HZ))
    pairs = []
    for _ in range(iters):
        _FLUSH.zero_()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(ms, "bytes" or "operations"): the larger roofline term of the
    work, at the peak rate of its type."""
    t = hw.roofline_terms(flops, nbytes, 0.0, peak_flops=PEAK_FLOPS[dtype])
    t_bytes, t_ops = t.memory_s * 1e3, t.compute_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------------ phases

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs an NVIDIA card",
              file=sys.stderr)
        sys.exit(1)
    smi = smi_line()
    print(smi, flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {nvcc[-1]}", flush=True)
    # fp32 stays fp32: no TF32 in the library yardsticks or dense fp32 path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s "
          f"(compiled: {json.dumps({k: round(v, 2) for k, v in secs.items()})})",
          flush=True)
    for name in _build.SIGNATURES:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            regs = re.findall(r"Used (\d+) registers", log.read_text())
            spills = re.findall(r"(\d+) bytes spill stores", log.read_text())
            print(f"[build] {name}: registers per entry {regs}, spill "
                  f"stores {spills}", flush=True)


def qwen2_gemm_ms(name: str) -> list:
    # the head runs on one token in an admission, never at M = 64 or 200
    return [M for M in sorted(GEMM_MS + SOLO_MS + VERIFY_MS)
            if not (name == "lm_head" and M in SOLO_MS[1:])]


def qwen2_gemm_on_path(name: str, M: int) -> bool:
    # the prefills compute the last token's logits only: the head runs at
    # M = batch ([serve], decode) or 1 (an admission); bf16 layer GEMMs
    # never at M = 1
    return M not in VERIFY_MS and (M in (1, 4) if name == "lm_head"
                                   else M > 1)


def check_pattern_gemm(gen) -> list:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows += check_pattern_gemm_cases(gen, dtype, "", QWEN2_GEMMS,
                                         qwen2_gemm_ms, qwen2_gemm_on_path)
        rows += check_pattern_gemm_cases(
            gen, dtype, "danube ", DANUBE_GEMMS,
            lambda name: DANUBE_HEAD_MS if name == "lm_head" else DANUBE_MS,
            lambda name, M: True, earlier_route=False)
        for prefix, gemms, ms in (("pixtral ", PIXTRAL_GEMMS, PIXTRAL_MS),
                                  ("hubert ", HUBERT_GEMMS, HUBERT_MS),
                                  ("granite ", GRANITE_GEMMS, GEMM_MS),
                                  ("phi4 ", PHI4_GEMMS, GEMM_MS)):
            rows += check_pattern_gemm_cases(
                gen, dtype, prefix, gemms,
                lambda name, ms=ms: (4,) if name == "lm_head" else ms,
                lambda name, M: True, earlier_route=False,
                timed=dtype == torch.bfloat16)
        for prefix, gemms, ms, head in (
                ("qwen2moe ", QWEN2_MOE_GEMMS, QWEN2_MOE_MS, (1, 4)),
                ("deepseekmoe ", DEEPSEEK_MOE_GEMMS, GEMM_MS, (4,))):
            rows += check_pattern_gemm_cases(
                gen, dtype, prefix, gemms,
                lambda name, ms=ms, head=head: (head if name == "lm_head"
                                                else ms),
                lambda name, M: True, earlier_route=False,
                timed=dtype == torch.bfloat16)
        rows += check_pattern_gemm_cases(
            gen, dtype, "hymba ", HYMBA_GEMMS, lambda name: HYMBA_MS,
            lambda name, M: True, earlier_route=False,
            timed=dtype == torch.bfloat16, block_p=HYMBA_BLOCK_P)
        rows += check_pattern_gemm_cases(
            gen, dtype, "xlstm ", XLSTM_HEAD, lambda name: XLSTM_HEAD_MS,
            lambda name, M: M == 4, earlier_route=False,
            timed=dtype == torch.bfloat16)
    return rows


def check_pattern_gemm_cases(gen, dtype, prefix: str, gemms, ms_of,
                             on_path, earlier_route: bool = True,
                             timed: bool = True, block_p: int = 128) -> list:
    """``pattern_gemm`` for each (name, Q, P, bias, activation) of
    ``gemms`` at each M of ``ms_of(name)`` in ``dtype``, the shape named
    ``prefix + name``, panels of ``block_p`` columns; ``earlier_route``:
    time the WMMA tile beside a wgmma call; ``timed``: time the calls
    (else only check them)."""
    rows = []
    tol = TOL[dtype]
    for name, Q, P, has_bias, act in gemms:
        w = torch.empty((Q, P), device="cuda")
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w = (w / math.sqrt(Q)).to(dtype)
        w = project_tile_pattern(w.T, block_p=block_p).T.contiguous()
        wpb, li = pg_mod.pack_tile_pattern_blocked(w, block_p=block_p)
        b = (torch.randn(P, generator=gen, device="cuda") * 0.1).to(dtype) \
            if has_bias else None
        for M in ms_of(name):
            x = torch.randn((M, Q), generator=gen, device="cuda").to(dtype)
            y = pg_mod.pattern_gemm(x, wpb, li, b, activation=act)
            torch.cuda.synchronize()
            r = pg_mod.pattern_gemm_ref(x, wpb, li, b, activation=act)
            err = (y.float() - r.float()).abs().max().item()
            if not torch.allclose(y.float(), r.float(), rtol=tol, atol=tol):
                fail(f"pattern_gemm {prefix}{name} M={M} {dtype}: max err "
                     f"{err}")
            del r
            variant = pg_mod.tiled_variant(M, Q, wpb.shape[1], dtype)
            ms = plain = earlier = lib = None
            if timed:
                ms = timed_ms(lambda: pg_mod.pattern_gemm(
                    x, wpb, li, b, activation=act), 20)
                plain = timed_ms(lambda: pg_mod.pattern_gemm_ref(
                    x, wpb, li, b, activation=act), 3)
                if variant == "wgmma" and earlier_route:  # the WMMA tile
                    earlier = timed_ms(lambda: pg_mod._launch(
                        x, wpb, li, b, act, "wmma"), 20)
                lib = timed_ms(lambda: torch.matmul(x, w), 20)
            nb, Kp, bp = wpb.shape
            t_b, by = bound(nbytes(x, wpb, li, b, y),
                            2.0 * M * Kp * nb * bp, dtype)
            rows.append(dict(kernel="pattern_gemm",
                             shape=f"{prefix}{name} M={M}",
                             on_path=on_path(name, M),
                             dtype=str(dtype).split(".")[-1],
                             variant=variant, max_abs_err=err, ms=ms,
                             earlier_ms=earlier, plain_ms=plain,
                             bound_ms=t_b, bound_by=by, library_ms=lib))
            print("[kernels] " + json.dumps(rows[-1]), flush=True)
        del w, wpb, li
    return rows


def check_flash(gen) -> list:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for heads, cases, served in (
                (FLASH_SHAPES, FLASH_CASES,
                 [(B, S, True, None) for B, S in FLASH_SERVED]),
                (FLASH_HD80, FLASH_HD80_CASES,
                 [(B, S, True, WINDOW) for B, S in FLASH_HD80_SERVED])):
            rows += check_flash_cases(gen, dtype, heads, cases, served)
        for heads, cases in FAMILY_FLASH:
            rows += check_flash_cases(gen, dtype, heads, cases, cases,
                                      earlier_route=False,
                                      timed=dtype == torch.bfloat16)
    return rows


def check_flash_cases(gen, dtype, heads: dict, cases, served,
                      earlier_route: bool = True,
                      timed: bool = True) -> list:
    """``flash_attention`` at each (B, S, causal, window) of ``cases``
    with ``heads`` (H, KV, hd) in ``dtype``; ``served``: the cases a
    phase's main path launches; ``earlier_route``: check and time the
    SIMT kernel beside a wgmma call; ``timed``: time the calls."""
    rows = []
    H, KV, hd = (heads[k] for k in ("H", "KV", "hd"))
    tol = TOL[dtype]
    for B, S, causal, window in cases:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window)
        o = fa_mod.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        r = fa_mod.flash_attention_ref(q, k, v, **kw)
        err = (o.float() - r.float()).abs().max().item()
        if not torch.allclose(o.float(), r.float(), rtol=tol, atol=tol):
            fail(f"flash_attention B={B} S={S} {kw} {dtype}: max err "
                 f"{err}")
        del r
        variant = fa_mod.flash_variant(S, hd, dtype, window, causal)
        earlier = ms = plain = lib = None   # earlier: the SIMT kernel
        if variant == "wgmma" and earlier_route:
            simt = fa_mod._launch(q, k, v, causal, window, None, "simt")
            torch.cuda.synchronize()
            r = fa_mod.flash_attention_ref(q, k, v, **kw)
            if not torch.allclose(simt.float(), r.float(), rtol=tol,
                                  atol=tol):
                fail(f"flash_attention simt B={B} S={S} {kw}: max err "
                     f"{(simt.float() - r.float()).abs().max().item()}")
            del r, simt
            earlier = timed_ms(lambda: fa_mod._launch(
                q, k, v, causal, window, None, "simt"))
        if timed:
            ms = timed_ms(lambda: fa_mod.flash_attention(q, k, v, **kw))
            plain = timed_ms(lambda: fa_mod.flash_attention_ref(
                q, k, v, **kw), 3)
        pos = torch.arange(S, device="cuda")
        seen = torch.ones((S, S), dtype=torch.bool, device="cuda")
        if causal:
            seen &= pos[:, None] >= pos[None, :]
        if window is not None:
            seen &= pos[:, None] - pos[None, :] < window
        pairs = int(seen.sum())                 # (q, k) pairs computed
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if not timed:
            pass
        elif window is None:
            lib = timed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
        else:                          # SDPA takes a window as a mask
            lib = timed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=seen, enable_gqa=True))
        t_b, by = bound(nbytes(q, k, v, o), 4.0 * B * H * hd * pairs, dtype)
        shape = (f"B={B} S={S} H={H} KV={KV} hd={hd} "
                 + ("causal" if causal else "non-causal")
                 + (f" window={window}" if window else ""))
        rows.append(dict(kernel="flash_attention", shape=shape,
                         on_path=(B, S, causal, window) in served,
                         dtype=str(dtype).split(".")[-1], variant=variant,
                         max_abs_err=err, ms=ms, earlier_ms=earlier,
                         plain_ms=plain, bound_ms=t_b, bound_by=by,
                         library_ms=lib))
        print("[kernels] " + json.dumps(rows[-1]), flush=True)
    return rows


def check_pattern_conv(gen) -> list:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[dtype]
        for B, H, C, A in VGG16_CONVS + RESNET18_CONVS:
            w4 = torch.empty((A, C, 3, 3), device="cuda")
            torch.nn.init.trunc_normal_(w4, 0.0, 1.0, -2.0, 2.0, generator=gen)
            w4 = project((w4 * math.sqrt(2.0 / (9 * C))).to(dtype),
                         "pattern_shared", alpha=0.25)
            pt = handler_for("pattern_shared").pack(w4, PATTERN_SPEC)
            wp, taps = pt.buf("w_packed"), pt.buf("taps")
            b = (torch.randn(A, generator=gen, device="cuda") * 0.1).to(dtype)
            x = torch.randn((B, H, H, C), generator=gen, device="cuda").to(dtype)
            y = pc_mod.pattern_conv(x, wp, taps, b, activation="relu")
            torch.cuda.synchronize()
            r = pc_mod.pattern_conv_ref(x, wp, taps, b, activation="relu")
            err = (y.float() - r.float()).abs().max().item()
            if not torch.allclose(y.float(), r.float(), rtol=tol, atol=tol):
                fail(f"pattern_conv B={B} H={H} C={C} A={A} {dtype}: max "
                     f"err {err}")
            del r
            variant = pc_mod.conv_variant(C, A, dtype)
            earlier = None                  # the WMMA tile at this shape
            if variant == "wgmma":
                earlier = timed_ms(lambda: pc_mod._launch(
                    x, wp, taps, b, "relu", "wmma"))
            ms = timed_ms(lambda: pc_mod.pattern_conv(
                x, wp, taps, b, activation="relu"))
            plain = timed_ms(lambda: pc_mod.pattern_conv_ref(
                x, wp, taps, b, activation="relu"), 2)
            xn = x.permute(0, 3, 1, 2)             # channels-last NCHW view
            lib = timed_ms(lambda: F.conv2d(xn, w4, padding=1))
            t_b, by = bound(nbytes(x, wp, taps, b, y),
                            2.0 * B * H * H * 4 * C * A, dtype)
            rows.append(dict(kernel="pattern_conv",
                             shape=f"B={B} {H}x{H} {C}->{A}", on_path=True,
                             dtype=str(dtype).split(".")[-1],
                             variant=variant, max_abs_err=err, ms=ms,
                             earlier_ms=earlier, plain_ms=plain,
                             bound_ms=t_b, bound_by=by, library_ms=lib))
            print("[kernels] " + json.dumps(rows[-1]), flush=True)
            del x, y, w4, wp, taps
    torch.cuda.empty_cache()
    return rows


def check_column_gemm(gen) -> list:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[dtype]
        for name, Q, P, has_bias, act in QWEN2_GEMMS:
            w = torch.empty((Q, P), device="cuda")
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            w = (w / math.sqrt(Q)).to(dtype)
            w = project_column(w.T, alpha=0.5).T.contiguous()
            wp, kept = cg_mod.pack_columns(w)
            b = (torch.randn(P, generator=gen, device="cuda") * 0.1).to(dtype) \
                if has_bias else None
            for M in sorted(GEMM_MS + VERIFY_MS):
                x = torch.randn((M, Q), generator=gen, device="cuda").to(dtype)
                y = cg_mod.column_gemm(x, wp, kept, b, activation=act)
                torch.cuda.synchronize()
                r = cg_mod.column_gemm_ref(x, wp, kept, b, activation=act)
                err = (y.float() - r.float()).abs().max().item()
                if not torch.allclose(y.float(), r.float(), rtol=tol, atol=tol):
                    fail(f"column_gemm {name} M={M} {dtype}: max err {err}")
                ms = timed_ms(lambda: cg_mod.column_gemm(
                    x, wp, kept, b, activation=act), 20)
                plain = timed_ms(lambda: cg_mod.column_gemm_ref(
                    x, wp, kept, b, activation=act), 3)
                variant = cg_mod.tiled_variant(M, *wp.shape, dtype)
                earlier = None                  # the WMMA tile at this shape
                if variant == "wgmma":
                    earlier = timed_ms(lambda: cg_mod._launch(
                        x, wp, kept, b, act, "wmma"), 20)
                lib = timed_ms(lambda: torch.matmul(x, w), 20)
                K = wp.shape[0]
                t_b, by = bound(nbytes(x, wp, kept, b, y), 2.0 * M * K * P,
                                dtype)
                rows.append(dict(kernel="column_gemm", shape=f"{name} M={M}",
                                 # LM.prefill computes the last token's
                                 # logits only: the head runs at M = batch
                                 on_path=M not in VERIFY_MS and (
                                     name != "lm_head" or M == 4),
                                 dtype=str(dtype).split(".")[-1],
                                 variant=variant, max_abs_err=err, ms=ms,
                                 earlier_ms=earlier, plain_ms=plain,
                                 bound_ms=t_b, bound_by=by, library_ms=lib))
                print("[kernels] " + json.dumps(rows[-1]), flush=True)
            del w, wp, kept
    return rows


def make_requests(vocab: int) -> list:
    g = torch.Generator().manual_seed(1)
    lens = (512,) * 4 + (128,) * 4
    return [Request(uid=i, prompt=torch.randint(0, vocab, (n,), generator=g),
                    max_new_tokens=32) for i, n in enumerate(lens)]


KERNEL_MODS = {"pattern_gemm": pg_mod, "flash_attention": fa_mod,
               "column_gemm": cg_mod, "pattern_conv": pc_mod}


def reset_launches() -> None:
    for mod in KERNEL_MODS.values():
        mod.LAUNCHES = 0
    for mod in (pg_mod, fa_mod, pc_mod):
        mod.ROUTE_LAUNCHES.update(dict.fromkeys(mod.ROUTE_LAUNCHES, 0))
    attention.PREFILL_FALLBACKS = 0


def launch_counts(names) -> dict:
    return {n: KERNEL_MODS[n].LAUNCHES for n in names}


TILE_PCFG = PruneConfig(scheme="tile_pattern", overrides={
    ".*": {"tile_block_p": 128, "tile_group_q": 8, "tile_keep": 4}})
COLUMN_PCFG = PruneConfig(scheme="column", alpha=0.5)
PATTERN_PCFG = PruneConfig(scheme="pattern_shared", alpha=0.25)
PATTERN_SPEC = LayerSpec(scheme="pattern_shared", alpha=0.25)


def build_engine(cfg, pcfg=TILE_PCFG):
    model = LM(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    art = greedy_prune(params, pcfg)
    del params
    art = art.pack()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    dense = ServeEngine(model, art, packed=False, batch_size=4,
                        max_seq_len=544)
    eng = ServeEngine(model, art, packed=True, batch_size=4, max_seq_len=544)
    return art, dense, eng, t_setup


def check_exact(tag: str, art) -> None:
    """Every packed leaf must reproduce its pruned weight exactly."""
    dense = dict(tree_items(art.params))
    packed_leaves = [(p, pt) for p, pt in tree_items(art.packed)
                     if is_packed(pt)]
    exact = sum(torch.equal(handler_for(pt.scheme).to_dense(pt), dense[p])
                for p, pt in packed_leaves)
    print(f"[{tag}] packed leaves that reproduce the pruned weight exactly: "
          f"{exact}/{len(packed_leaves)}", flush=True)
    if exact != len(packed_leaves) or not packed_leaves:
        fail(f"[{tag}] a packed leaf does not encode its pruned weight")


def disk_bytes(directory: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(directory) for f in files)


def median_s(fn, reps: int = 3) -> float:
    """Median wall seconds of ``fn`` (a synchronize after each call)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def leaf_equal(a, b) -> bool:
    if is_packed(a) or is_packed(b):
        return (is_packed(a) and is_packed(b) and a.names == b.names
                and tuple(a.shape) == tuple(b.shape)
                and all(x.dtype == y.dtype and torch.equal(x, y)
                        for x, y in zip(a.buffers, b.buffers)))
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a, b)


def first_layers(art, cfg, n: int):
    """(``art`` cut to its first ``n`` decoder layers, ``cfg`` with
    ``num_layers=n``): every other leaf, and every width, as they are."""
    def cut(tree):
        return None if tree is None else {**tree,
                                          "blocks": tree["blocks"][:n]}

    return (dataclasses.replace(art, params=cut(art.params),
                                masks=cut(art.masks), specs=cut(art.specs),
                                packed=cut(art.packed)),
            dataclasses.replace(cfg, num_layers=n))


def save_and_load(tag: str, art, cfg):
    """Save ``art`` to a temporary directory, load it back on the card
    (every buffer's CRC32 checked) and hold every leaf to the original."""
    with tempfile.TemporaryDirectory(prefix="artifact-") as d:
        path = os.path.join(d, "artifact")
        t0 = time.perf_counter()
        art.save(path)
        t_save = time.perf_counter() - t0
        size = disk_bytes(path)
        t0 = time.perf_counter()
        loaded = PrunedArtifact.load(path, cfg=cfg)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    pairs = []
    for name in ("params", "packed", "masks"):
        back = dict(tree_items(getattr(loaded, name)))   # keys sorted on disk
        pairs += [(p, a, back.get(p)) for p, a in tree_items(getattr(art,
                                                                     name))]
    same = [p for p, a, b in pairs if leaf_equal(a, b)]
    print(f"[{tag}] artifact saved in {t_save:.2f} s, {size} bytes on disk; "
          f"loaded on the card in {t_load:.2f} s; leaves bit-equal after "
          f"the round trip (params, packed, masks): {len(same)}/"
          f"{len(pairs)}", flush=True)
    if len(same) != len(pairs):
        fail(f"[{tag}] leaves differ after save and load: "
             f"{[p for p, _, _ in pairs if p not in same][:6]}")
    return loaded


def round_trip(tag: str, art, cfg, reqs, layers: int = ROUND_TRIP_LAYERS,
               serving=contextlib.nullcontext):
    """``art`` cut to its first ``layers`` decoder layers (every width as
    it is) serves ``reqs`` through the launcher's engine (CUDA graphs),
    is saved and loaded back (every leaf bit-equal), and the loaded cut
    serves them again, inside ``serving()``: the same tokens. -> (the
    cut, the loaded cut)."""
    cut, cut_cfg = first_layers(art, cfg, layers)
    model = LM(cut_cfg, device=DEV)

    def serve(a):
        return [r.tokens for r in launch_serve.make_engine(
            model, a, batch=4, max_seq=544, packed=True,
            device=DEV).generate(reqs)]

    tokens = serve(cut)
    loaded = save_and_load(tag, cut, cut_cfg)
    with serving():
        same = serve(loaded) == tokens
    print(f"[{tag}] tokens of the loaded artifact ({layers} of "
          f"{cfg.num_layers} layers) identical to the in-memory artifact's: "
          f"{same}", flush=True)
    if not same:
        fail(f"[{tag}] the loaded artifact serves other tokens")
    return cut, loaded


def eager_against_graph(tag: str, eng, chunk, S: int, gemm: str) -> dict:
    """One chunk through the engine's graphs and through ``LM.prefill`` /
    ``LM.decode_many`` called eagerly: bit-identical logits and tokens,
    then wall time of each (median of 3) and launches per graph run."""
    model, params = eng.model, eng.params
    names = (gemm, "flash_attention")
    prompts, mask = eng.pad_prompts(chunk)
    eng.set_rows(chunk, mask)
    keys = fold_key_grid(eng.rows["keys"], torch.zeros_like(
        eng.rows["keys"]), 32)
    logits = eng.prefill(prompts)[1].clone()
    cache, want = model.prefill(params, prompts, eng.max_seq_len)
    tok0 = eng.sample(logits, keys[0])
    toks = eng.decode(tok0, 31).clone()
    _, rest = model.decode_many(params, cache, tok0, 31, sampler=eng.sample,
                                keys=keys[1:])
    same = (torch.equal(logits, want), torch.equal(
        toks, torch.cat([tok0, rest], dim=1)))
    print(f"[{tag}] chunk S={S}: graph against eager, prefill logits "
          f"bit-identical {same[0]}, decode tokens (31 steps) bit-identical "
          f"{same[1]}", flush=True)
    if not all(same):
        fail(f"[{tag}] S={S}: the graphs disagree with the eager path")
    reset_launches()
    eng.prefill(prompts)
    torch.cuda.synchronize()
    pre = launch_counts(names)
    if fa_mod.ROUTE_LAUNCHES["wgmma"] != pre["flash_attention"]:
        fail(f"prefill at S={S} launched flash_attention off the wgmma "
             f"route: {fa_mod.ROUTE_LAUNCHES}")
    reset_launches()
    eng.decode(tok0, 31)
    torch.cuda.synchronize()
    dec = launch_counts(names)
    if pre[gemm] == 0 or pre["flash_attention"] == 0 or dec[gemm] == 0:
        fail(f"kernels not launched on the served path at S={S}: "
             f"prefill {pre}, decode {dec}")

    def eager_decode():
        model.decode_many(params, cache, tok0, 31, sampler=eng.sample,
                          keys=keys[1:])

    def graph_decode():
        eng.decode(tok0, 31)

    t = {"prefill_eager_ms": median_s(lambda: model.prefill(
             params, prompts, eng.max_seq_len)) * 1e3,
         "prefill_graph_ms": median_s(lambda: eng.prefill(prompts)) * 1e3}
    model.prefill(params, prompts, eng.max_seq_len, cache=cache)
    t["decode_eager_ms_per_step"] = median_s(eager_decode) * 1e3 / 31
    eng.prefill(prompts)
    t["decode_graph_ms_per_step"] = median_s(graph_decode) * 1e3 / 31
    t["decode_graph_tok_s"] = 4 / (t["decode_graph_ms_per_step"] / 1e3)
    split = dict(t, prefill_graph_launches=pre, decode_graph_launches=dec)
    print(f"[{tag}] chunk S={S}: " + json.dumps(split), flush=True)
    profile(tag, f"prefill (S={S} chunk), eager", lambda: model.prefill(
        params, prompts, eng.max_seq_len), names=names)
    profile(tag, f"prefill (S={S} chunk), graph", lambda: eng.prefill(prompts),
            names=names)
    if S == 512:
        model.prefill(params, prompts, eng.max_seq_len, cache=cache)
        profile(tag, "decode step (S=512 chunk), eager",
                lambda: model.decode_many(params, cache, tok0, 8,
                                          sampler=eng.sample, keys=keys[1:9]),
                per=8, names=(gemm,))
        eng.prefill(prompts)
        profile(tag, "decode step (S=512 chunk), graph",
                lambda: eng.decode(tok0, 8), per=8, names=(gemm,))
    return split


def seeded_across_batches(tag: str, eng, reqs) -> None:
    """A seeded temperature request served in two batch compositions (other
    batch-mates, temperatures and seeds, one with an empty slot): its
    tokens must agree."""
    seeded = dataclasses.replace(reqs[4], uid=100, temperature=0.8,
                                 seed=2024)
    mates_a = [dataclasses.replace(r, uid=101 + i)
               for i, r in enumerate(reqs[5:7])]
    mates_b = [dataclasses.replace(reqs[7], uid=110, temperature=1.2)]
    a = eng.generate([seeded] + mates_a)[0].tokens
    b = eng.generate([seeded] + mates_b)[0].tokens
    print(f"[{tag}] seeded temperature request (T=0.8, seed 2024) in two "
          f"batch compositions: tokens identical {a == b} ({len(a)} tokens, "
          f"first {a[:6]})", flush=True)
    if a != b or len(a) != 32:
        fail(f"[{tag}] a seeded request's tokens depend on its batch-mates")


def drive_serve(tag: str, smi: str, pcfg, gemm: str,
                layers: int = 28):
    """Serve qwen2-1.5b packed under ``pcfg`` through the launcher's engine
    (CUDA graphs): ``round_trip`` at ``layers`` of 28, then the main path
    (8 requests, counts zeroed around it) on the loaded artifact when it
    is whole, else on the in-memory one, a seeded temperature request,
    then each chunk eager against graph. Returns the main path's launch
    counts and the served artifact."""
    names = (gemm, "flash_attention")
    cfg = get_config("qwen2-1.5b")
    model = LM(cfg)
    t0 = time.perf_counter()
    art = greedy_prune(model.init(torch.Generator(device="cuda").manual_seed(
        0)), pcfg).pack()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    reqs = make_requests(cfg.vocab_size)
    print(f"[{tag}] qwen2-1.5b L={cfg.num_layers} d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} {cfg.param_dtype}; init+prune+pack "
          f"{t_setup:.2f} s; weight bytes dense {art.dense_bytes()} packed "
          f"{art.packed_bytes()} ({smi})", flush=True)
    check_exact(tag, art)
    loaded = round_trip(tag, art, cfg, reqs, layers)[1]
    if layers < cfg.num_layers:
        loaded = art
    eng = launch_serve.make_engine(model, loaded, batch=4, max_seq=544,
                                   packed=True)
    t0 = time.perf_counter()
    for r in (reqs[0], reqs[4]):          # captures: decode, S = 512 and 128
        eng.generate([r])
    torch.cuda.synchronize()
    print(f"[{tag}] graphs captured in {time.perf_counter() - t0:.2f} s "
          f"(first use); one shared pool of {eng.graph_pool.reserved} bytes, "
          f"reserved by each capture in turn: prefill S=512, decode, "
          f"prefill S=128 " + json.dumps(
              [eng.prefill_graphs[512].graph.pool_bytes,
               eng.decode_graph.graph.pool_bytes,
               eng.prefill_graphs[128].graph.pool_bytes]), flush=True)

    reset_launches()                                    # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(names)
    print(f"[{tag}] generate(8 requests) {wall * 1e3:.1f} ms; launches "
          f"(graph replays counted) {json.dumps(launches)}; flash_attention "
          f"by route {json.dumps(fa_mod.ROUTE_LAUNCHES)}, blockwise "
          f"fallbacks {attention.PREFILL_FALLBACKS}", flush=True)
    if (launches["flash_attention"] == 0 or fa_mod.ROUTE_LAUNCHES["wgmma"]
            != launches["flash_attention"] or attention.PREFILL_FALLBACKS):
        fail(f"[{tag}] generate launched flash_attention off the wgmma "
             f"route: {fa_mod.ROUTE_LAUNCHES}, "
             f"{attention.PREFILL_FALLBACKS} blockwise fallbacks")
    if not all(launches.values()):
        fail(f"a kernel never launched on the main path: {launches}")
    for r in results:
        if len(r.tokens) != 32 or not all(0 <= t < cfg.vocab_size
                                          for t in r.tokens):
            fail(f"request {r.uid}: bad tokens {r.tokens[:8]}...")
    SERVED_TOKENS[tag] = [r.tokens for r in results]
    del art
    torch.cuda.empty_cache()
    seeded_across_batches(tag, eng, reqs)
    for S, chunk in ((128, reqs[4:]), (512, reqs[:4])):
        eager_against_graph(tag, eng, chunk, S, gemm)
    return launches, loaded


SERVED_TOKENS: dict = {}    # each drive_serve tag's main-path tokens


def phase_serve(smi: str):
    """-> (launch counts, the loaded artifact, which ``[continuous]``
    serves again)."""
    return drive_serve("serve", smi, TILE_PCFG, "pattern_gemm")


# each launch of a wrapper runs exactly one of these device functions (a
# K-split reduce or a column gather beside it is not counted)
TRACED_KERNEL = {
    "pattern_gemm": r"(^|[ :])(pg_skinny|pg_wmma_bf16|pg_simt_f32|gemm_bf16)"
                    r"[<(]",
    "column_gemm": r"(^|[ :])(cg_skinny|cg_wmma_bf16|cg_simt_f32|gemm_bf16)"
                   r"[<(]",
    "flash_attention": r"(^|[ :])(flash_fwd|flash_wgmma)[<(]",
}


PROFILE_RETAKES = 3        # traces retaken after one that lost records
RETAKE_S: dict = {}        # seconds spent on retakes, by phase tag


def exact_trace(tag: str, what: str, take, retakes: int = PROFILE_RETAKES,
                first=None):
    """The launch gate against torch.profiler, with its retake rule.

    ``take()`` traces the path once -> ``(counted, traced, out)``: by
    kernel, the launches its wrapper counted during the trace and the
    trace's launches of its device functions. The profiler drops device
    records on the card (0 to thousands per whole-path trace, PR 18), so a
    trace that counts fewer launches of some kernel than its wrapper did
    is retaken, up to ``retakes`` times, each printed with its loss by
    kernel. Passes on the first trace whose counts equal the counted ones
    exactly -> its ``out``. Fails when none does, when a trace counts MORE
    launches than were counted (no lost record explains that), or when a
    kernel was never launched. ``first``: a trace already taken, tried
    before any retake."""
    for attempt in range(retakes + 1):
        t0 = time.perf_counter()
        counted, traced, out = (first if attempt == 0 and first is not None
                                else take())
        if attempt:
            RETAKE_S[tag] = RETAKE_S.get(tag, 0.0) + (time.perf_counter()
                                                      - t0)
        over = {n: traced[n] - c for n, c in counted.items() if traced[n] > c}
        if over:
            fail(f"[{tag}] {what}: the trace counts more launches than the "
                 f"wrappers did, by {over} (counted {counted}, traced "
                 f"{traced})")
        if not all(counted.values()):
            fail(f"[{tag}] {what}: a kernel was not launched: counted "
                 f"{counted}")
        if traced == counted:
            return out
        lost = {n: c - traced[n] for n, c in counted.items() if traced[n] < c}
        print(f"[profile] {tag} {what}: trace {attempt + 1} lost device "
              f"records of {json.dumps(lost)} (counted {json.dumps(counted)})"
              + (f"; retake {attempt + 1} of {retakes}" if attempt < retakes
                 else ""), flush=True)
    fail(f"[{tag}] {what}: no trace of {retakes + 1} counted the launches "
         f"the wrappers did (the last: counted {counted}, traced {traced})")


WARM_SPINS = 64            # device sleeps that open a gated trace


def _trace(fn, per: int, names: tuple, warm: bool = False):
    """One torch.profiler trace of ``fn`` -> (profile, wall s per ``per``,
    the launches the wrappers counted during it). ``warm``: the trace
    opens with ``WARM_SPINS`` short device sleeps (``spin_kernel``) and a
    synchronize before ``fn``: a trace drops its first device records
    (on the card, hubert-xlarge's forward lost the same 3 of its first
    layer's GEMM records in each of 4 traces, its first GEMMs a dozen
    kernels after the trace opened)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    reset_launches()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        if warm:
            for _ in range(WARM_SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / per
    return prof, wall, launch_counts(names)


def profile(tag: str, what: str, fn, per: int = 1, names: tuple = (),
            quiet: bool = False) -> list:
    """Where the time of ``fn`` goes, per ``per`` (decode steps): wall
    clock against the device's busy time (sum of kernel self times under
    torch.profiler) and the kernels that hold most of it. For each kernel
    in ``names`` the launches its wrapper counted during ``fn`` (graph
    replays included) must equal the trace's launches of its device
    functions, under ``exact_trace``'s retake rule (``fn`` runs again for
    a retake). Returns the trace's raw events; ``quiet``: one trace,
    printed, summed and gated nothing."""
    if quiet:
        return _trace(fn, per, names)[0].profiler.kineto_results.events()

    def take():
        prof, wall, counted = _trace(fn, per, names, warm=True)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.key]
        traced = {n: sum(e.count for e in kernels
                         if re.search(TRACED_KERNEL[n], e.key))
                  for n in names}
        return counted, traced, (prof, wall, kernels, counted, traced)

    prof, wall, kernels, counted, traced = exact_trace(tag, what, take)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / per
    launches = sum(e.count for e in kernels) / per
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    attn = [e for e in kernels if "flash" in e.key]

    def ms(events):
        return {e.key[:60]: [round(e.self_device_time_total / 1e3 / per, 3),
                             e.count // per] for e in events}

    print(f"[profile] {tag} {what}, profiled: wall {wall * 1e3:.2f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), "
          f"{launches:.0f} kernel launches; top device ms (launches): "
          + json.dumps(ms(top)) + "; attention: " + json.dumps(ms(attn))
          + f"; launches counted {json.dumps(counted)}, traced "
          + json.dumps(traced), flush=True)
    return prof.profiler.kineto_results.events()


def token_identity(tag: str, cfg, pcfg, note: str = "") -> None:
    """Serve ``cfg`` in fp32 dense-pruned and packed: identical tokens."""
    _, dense, packed, _ = build_engine(cfg, pcfg)
    reqs = make_requests(cfg.vocab_size)
    td = [r.tokens for r in dense.generate(reqs)]
    tp = [r.tokens for r in packed.generate(reqs)]
    same = td == tp
    print(f"[{tag}] fp32 dense-pruned vs packed greedy tokens identical: "
          f"{same} ({sum(len(t) for t in tp)} tokens{note})", flush=True)
    if not same:
        divergence_report(dense, packed, reqs, td, tp)
        fail("packed fp32 tokens differ from dense-pruned fp32 tokens")


def phase_identity() -> None:
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), param_dtype="float32")
    token_identity("identity", cfg, TILE_PCFG)


def divergence_report(dense, packed, reqs, td, tp) -> None:
    """Replay the first diverging request's chunk with the dense tokens
    forced on both engines; print the logit gap at the diverging step."""
    bad = [i for i in range(len(reqs)) if td[i] != tp[i]]
    i = bad[0]
    pos = next(t for t, (a, b) in enumerate(zip(td[i], tp[i])) if a != b)
    order = sorted(range(len(reqs)), key=lambda k: len(reqs[k].prompt))
    chunk = next(order[c:c + 4] for c in range(0, len(order), 4)
                 if i in order[c:c + 4])
    row = chunk.index(i)
    prompts, _ = dense.pad_prompts([reqs[k] for k in chunk])
    forced = torch.tensor([td[k] for k in chunk], device="cuda")
    out = {}
    for tag, eng in (("dense", dense), ("packed", packed)):
        cache, logits = eng.prefill(prompts)
        steps = [logits[row, 0].float()]
        for t in range(pos):
            cache, logits = eng.model.decode_step(eng.params, cache,
                                                  forced[:, t:t + 1])
            steps.append(logits[row, 0].float())
        out[tag] = torch.stack(steps)
    diff = (out["dense"] - out["packed"]).abs().amax(dim=-1)
    top = torch.topk(out["dense"][pos], 2).values
    print(f"[identity] requests differing: {bad}; request {i} first differs "
          f"at token {pos}; max |dense - packed| logit per step "
          f"{diff.tolist()}; dense top-2 at that step {top.tolist()} "
          f"(gap {float(top[0] - top[1])})", flush=True)


def build_cnn(ctor, kwargs: dict, dtype: str):
    model = ctor(**kwargs, param_dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    art = greedy_prune(params, PATTERN_PCFG)
    del params
    art = art.pack()
    torch.cuda.synchronize()
    return model, art, time.perf_counter() - t0


def conv_routes(tree) -> dict:
    """The pattern_conv launches per route one forward of the bound ``tree``
    makes: one per packed (stride-1 3x3) conv, on its ``conv_variant``."""
    want = dict.fromkeys(pc_mod.CONV_ROUTES, 0)
    for _, pt in tree_items(tree):
        if is_packed(pt) and handler_for(pt.scheme).conv is not None:
            wp = pt.buf("w_packed")
            want[pc_mod.conv_variant(wp.shape[0] // 4, wp.shape[1],
                                     wp.dtype)] += 1
    return want


def phase_cnn(smi: str, tag: str, ctor, kwargs: dict, batch: int,
              want_launches: int) -> int:
    """One CNN path in bf16 (the main path: one packed forward, counts
    zeroed around it; then 3 timed), and its fp32 dense-vs-packed check.
    Returns the main path's pattern_conv launches."""
    model, art, t_setup = build_cnn(ctor, kwargs, "bfloat16")
    s = art.summary()
    print(f"[cnn] {tag} {kwargs['image_hwc']} batch {batch} bf16; "
          f"init+prune+pack {t_setup:.2f} s; weight bytes dense "
          f"{s['dense_bytes']} packed {s['packed_bytes']} "
          f"({s['bytes_ratio']:.3f}x, {s['packed_leaves']}/"
          f"{s['total_leaves']} leaves packed) ({smi})", flush=True)
    check_exact("cnn", art)
    tree = art.bind(model, packed=True)
    want_routes = conv_routes(tree)
    x = model.synthetic_batch(torch.Generator(device="cuda").manual_seed(1),
                              batch)
    model.apply(tree, x)                                # warm-up
    torch.cuda.synchronize()

    reset_launches()                                    # the main path
    logits = model.apply(tree, x)
    torch.cuda.synchronize()
    launches = pc_mod.LAUNCHES
    routes = dict(pc_mod.ROUTE_LAUNCHES)
    if tuple(logits.shape) != (batch, model.num_classes) or not bool(
            torch.isfinite(logits).all()):
        fail(f"[cnn] {tag}: bad logits {tuple(logits.shape)}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.apply(tree, x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    fwd_ms = sorted(times)[1] * 1e3
    print(f"[cnn] {tag}: pattern_conv launches per forward {launches} "
          f"(want {want_launches}: one per stride-1 3x3 conv; by route "
          f"{json.dumps(routes)}, want {json.dumps(want_routes)}); bf16 "
          f"forward "
          f"{fwd_ms:.2f} ms (median of 3), {batch / (fwd_ms / 1e3):.1f} "
          f"images/s", flush=True)
    if launches != want_launches:
        fail(f"[cnn] {tag}: {launches} pattern_conv launches, want "
             f"{want_launches}")
    if routes != want_routes or routes["wgmma"] == 0:
        fail(f"[cnn] {tag}: pattern_conv launches by route {routes}, want "
             f"{want_routes} (conv_variant of each packed conv)")
    del model, art, tree, x, logits
    torch.cuda.empty_cache()

    model, art, _ = build_cnn(ctor, kwargs, "float32")
    x = model.synthetic_batch(torch.Generator(device="cuda").manual_seed(1),
                              batch)
    dense = model.apply(art.bind(model, packed=False), x)
    packed = model.apply(art.bind(model, packed=True), x)
    diff = (dense - packed).abs().max().item()
    top2 = torch.topk(dense, 2, dim=1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
    same = bool((dense.argmax(1) == packed.argmax(1))[sure].all())
    print(f"[cnn] {tag} fp32 dense-pruned (F.conv2d, no TF32) vs packed: "
          f"max |logit diff| {diff:.3e} (logits up to "
          f"{dense.abs().max().item():.3e}); top-1 identical on the "
          f"{int(sure.sum())} of {batch} images whose dense top-2 gap "
          f"exceeds twice that: {same}", flush=True)
    if not same or not bool(torch.isfinite(packed).all()):
        fail(f"[cnn] {tag}: fp32 packed top-1 differs from dense-pruned")
    del model, art, x, dense, packed
    torch.cuda.empty_cache()
    return launches


def phase_column(smi: str):
    """-> (launch counts, the served artifact, which ``[roofline]``
    attributes)."""
    launches, served = drive_serve("column", smi, COLUMN_PCFG, "column_gemm",
                                   layers=ROUND_TRIP_LAYERS)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), param_dtype="float32",
                              num_layers=COLUMN_IDENTITY_LAYERS)
    token_identity("column", cfg, COLUMN_PCFG,
                   f"; reduced depth: {COLUMN_IDENTITY_LAYERS} of 28 layers "
                   "at full width")
    return launches, served


# ------------------------------------------------ continuous batching

# ContinuousEngine(batch_size=4, max_seq_len=544, chunk_steps=8) on the
# [serve] phase's loaded artifact; 12 requests, prompt lengths and budgets
# cycling, arrivals at seeded exponential gaps of about one decode chunk
CONT = dict(batch=4, max_seq=544, chunk=8, requests=12, lens=(512, 200, 64),
            new=(32, 8, 16), gap_s=0.055, fp32_layers=4, fp32_requests=6,
            eager_requests=6)


def continuous_requests(vocab: int) -> list:
    g = torch.Generator().manual_seed(2)
    lens, new = CONT["lens"], CONT["new"]
    return [Request(uid=i, prompt=torch.randint(0, vocab, (lens[i % 3],),
                                                generator=g),
                    max_new_tokens=new[i % 3])
            for i in range(CONT["requests"])]


def continuous_engine(model, art) -> ContinuousEngine:
    return ContinuousEngine(model, art, packed=True,
                            batch_size=CONT["batch"],
                            max_seq_len=CONT["max_seq"],
                            chunk_steps=CONT["chunk"], device=DEV)


def outcome(results) -> list:
    return [(r.uid, r.tokens, r.status) for r in results]


def recorded_run(eng, reqs, **kw):
    """``eng.generate(reqs, **kw)`` -> (outcome, every decode chunk's host
    tokens and flags)."""
    chunks = []
    inner = eng._decode_chunk

    def record(K, table):
        toks, flags = inner(K, table)
        chunks.append((toks.tolist(), flags.tolist()))
        return toks, flags

    eng._decode_chunk = record
    try:
        return outcome(eng.generate(reqs, **kw)), chunks
    finally:
        del eng._decode_chunk


def prefix_of(got: list, full: list) -> bool:
    return 0 < len(got) < len(full) and got == full[:len(got)]


def continuous_main(tag: str, smi: str, eng, reqs: list) -> dict:
    """The main path: ``reqs`` at seeded arrivals, counts zeroed around it,
    a trace and a registry recording it; its readings and the kernel and
    trace gates. Returns the run's results, launches and trace analysis."""
    n = len(reqs)
    g = torch.Generator().manual_seed(3)
    gaps = torch.empty(n - 1, dtype=torch.float64).exponential_(
        1.0 / CONT["gap_s"], generator=g)
    arrivals = [0.0] + torch.cumsum(gaps, 0).tolist()
    L = eng.model.config.num_layers
    with tempfile.TemporaryDirectory(prefix="trace-") as d:
        path = os.path.join(d, "continuous.jsonl")
        reg = MetricsRegistry()
        eng.telemetry = Telemetry(metrics=reg, trace_path=path)
        reset_launches()                                # the main path
        t0 = time.perf_counter()
        results = eng.generate(reqs, arrivals=arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(("pattern_gemm", "flash_attention"))
        routes = {"pattern_gemm": dict(pg_mod.ROUTE_LAUNCHES),
                  "flash_attention": dict(fa_mod.ROUTE_LAUNCHES)}
        fallbacks = attention.PREFILL_FALLBACKS
        eng.telemetry.close()
        eng.telemetry = None
        events = read_trace(path)
        os.makedirs(BENCH_TORCH, exist_ok=True)     # [analyze] reads it
        shutil.copyfile(path, CONT_TRACE)
    st = eng.stats
    n_tok = sum(len(r.tokens) for r in results)
    E = {"engine": "continuous"}
    h = {k: reg.histogram(f"serve.{k}_seconds", **E)
         for k in ("ttft", "tpot", "queue_wait", "chunk")}
    analysis = trace_analysis.analyze(events)
    lens = {r.uid: len(r.prompt) for r in reqs}
    by_s = {}
    for p in analysis.requests:
        by_s.setdefault(lens[p.uid], []).append(
            (p.first_token_ts - p.arrival, p.prefill_s))
    chunks = analysis.chunks
    chunk_s = sum(c["dur"] for c in chunks)
    admit_s = sum(p.prefill_s for p in analysis.requests)
    step_ms = chunk_s / max(1, sum(c["steps"] for c in chunks)) * 1e3
    print(f"[{tag}] {n} requests (prompt lengths {CONT['lens']} and budgets "
          f"{CONT['new']} cycling; arrivals at seeded exponential gaps, mean "
          f"{CONT['gap_s'] * 1e3:.0f} ms, last at {arrivals[-1] * 1e3:.1f} "
          f"ms): wall {wall * 1e3:.1f} ms, {n_tok} tokens, "
          f"{n_tok / wall:.1f} tok/s, occupancy {st['occupancy']:.4f}, "
          f"{st['chunks']} chunks, {st['total_slot_steps'] // eng.batch_size}"
          f" decode steps; decode {step_ms:.3f} ms per chunk step (host "
          f"clock, chunk spans); of the wall, decode chunks "
          f"{chunk_s * 1e3:.1f} ms, admissions {admit_s * 1e3:.1f} ms "
          f"(admit spans), the rest {(wall - chunk_s - admit_s) * 1e3:.1f} "
          f"ms ({smi})", flush=True)
    print(f"[{tag}] registry: TTFT p50 {h['ttft'].quantile(0.5) * 1e3:.2f}"
          f" / p99 {h['ttft'].quantile(0.99) * 1e3:.2f} ms, TPOT p50 "
          f"{h['tpot'].quantile(0.5) * 1e3:.2f} / p99 "
          f"{h['tpot'].quantile(0.99) * 1e3:.2f} ms (bucket upper bounds); "
          f"means TTFT {h['ttft'].sum / h['ttft'].count * 1e3:.3f}, TPOT "
          f"{h['tpot'].sum / max(1, h['tpot'].count) * 1e3:.3f}, queue wait "
          f"{h['queue_wait'].sum / h['queue_wait'].count * 1e3:.3f}, chunk "
          f"{h['chunk'].sum / max(1, h['chunk'].count) * 1e3:.3f} ms; from "
          "the trace per prompt length, TTFT mean / max and admit span "
          "(solo prefill + first token) mean, ms: " + json.dumps(
              {S: [round(sum(t for t, _ in v) / len(v) * 1e3, 3),
                   round(max(t for t, _ in v) * 1e3, 3),
                   round(sum(a for _, a in v) / len(v) * 1e3, 3)]
               for S, v in sorted(by_s.items())}) + f" ({smi})", flush=True)
    print(f"[{tag}] launches (graph replays counted) {json.dumps(launches)};"
          f" by route {json.dumps(routes)}; blockwise fallbacks {fallbacks}",
          flush=True)
    for r, q in zip(results, reqs):
        if (r.status != "ok" or len(r.tokens) != q.max_new_tokens
                or not all(0 <= t < eng.model.config.vocab_size
                           for t in r.tokens)):
            fail(f"[{tag}] request {r.uid}: {r.status}, tokens "
                 f"{r.tokens[:8]}...")
    if (launches["flash_attention"] != L * n
            or routes["flash_attention"]["wgmma"] != L * n or fallbacks):
        fail(f"[{tag}] every admission must run flash on wgmma ({L} x {n}):"
             f" {routes['flash_attention']}, {fallbacks} fallbacks")
    if not (routes["pattern_gemm"]["skinny"]
            and routes["pattern_gemm"]["wgmma"]):
        fail(f"[{tag}] pattern_gemm must launch on skinny (decode) and "
             f"wgmma (admissions): {routes['pattern_gemm']}")
    check = analysis.crosscheck(reg)
    t_first = {e["uid"]: e["ts"] for e in events
               if e["name"] == "first_token"}
    tpot = sum((e["ts"] - t_first[e["uid"]]) / (e["tokens"] - 1)
               for e in events if e["name"] == "retire" and e["tokens"] > 1)
    ok = (check["matches"] and analysis.occupancy == st["occupancy"]
          and math.isclose(tpot, h["tpot"].sum, rel_tol=1e-9))
    print(f"[{tag}] trace ({len(events)} events) recomputes the registry: "
          f"TTFT, queue wait, occupancy {check['matches']}, TPOT sum "
          f"{tpot:.9f} against {h['tpot'].sum:.9f}, occupancy "
          f"{analysis.occupancy:.4f}: {ok}", flush=True)
    if not ok:
        fail(f"[{tag}] the trace does not recompute the registry: {check}")
    trace_loss(tag, eng, reqs, arrivals)
    # the busy share; trace_loss gates the launches on this path
    profile(tag, f"generate ({n} requests, the same arrivals)",
            lambda: eng.generate(reqs, arrivals=arrivals))
    return {"results": results, "launches": launches}


TRACE_REPEATS = 1
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def trace_loss(tag: str, eng, reqs: list, arrivals: list) -> None:
    """Does the profiler lose kernel records, and where? The main path
    under one scripted schedule, traced ``TRACE_REPEATS`` times as
    ``profile`` traces, and as often behind a 20 ms device spin (a trace
    opened by the spin then a sync, the spin left out). The schedule is
    the same each run (the counted launches must agree), so a run's
    missing records against the fullest run are trace loss; they are
    placed by the first record where the run departs from the fullest.
    ``orphans``: kernel-launch calls on the host whose device record is
    missing (a kernel of a graph replay shares its replay's call, so its
    loss is not one). Gate: every run counts the same launches, and
    ``exact_trace``'s rule holds over the runs: no run traces more
    launches of a counted kernel than were counted, and the run that
    lost least is exact, or else a retake of the plain run is."""
    from collections import Counter

    CUDA = torch.autograd.DeviceType.CUDA
    names = ("pattern_gemm", "flash_attention")

    def run():
        eng.generate(reqs, arrivals=arrivals,
                     clock=ScriptedClock([], tail_step=0.02))

    def spun():
        torch.cuda._sleep(int(0.02 * SLEEP_HZ))
        torch.cuda.synchronize()
        run()

    def traced(fn):
        events = profile(tag, "", fn, quiet=True)
        dev = sorted((e for e in events if e.device_type() == CUDA
                      and "spin_kernel" not in e.name()),
                     key=lambda e: e.start_ns())
        seq = [e.name() for e in dev]
        return events, dev, seq, launch_counts(names), {
            n: sum(1 for k in seq if re.search(TRACED_KERNEL[n], k))
            for n in names}

    runs = []
    for spin in (False, True):
        for _ in range(TRACE_REPEATS):
            events, dev, seq, counted, seen_n = traced(spun if spin else run)
            seen = {e.correlation_id() for e in dev}
            orphans = sum(1 for e in events if e.device_type() != CUDA
                          and e.name() in LAUNCH_CALLS
                          and e.correlation_id() not in seen)
            runs.append((spin, counted, seen_n, seq, orphans))
    full = max((r[3] for r in runs), key=len)
    for spin, counted, seen_n, seq, orphans in runs:
        m = len(full) - len(seq)
        lost = Counter(full) - Counter(seq)
        i = next((i for i, (a, b) in enumerate(zip(seq, full)) if a != b),
                 len(seq))
        j = len(full) - next((j for j, (a, b) in enumerate(
            zip(seq[::-1], full[::-1])) if a != b), len(seq))
        # the fullest run's records [0, i) and [j, end) match this run's
        # ends; a run of one kernel's records blurs the edges by up to m
        where = (f"{m} fewer than the fullest run, lost within its "
                 f"records [{min(i, j - m)}, {max(i + m, j)})" if m or lost
                 else "as many as the fullest")
        print(f"[{tag}] trace loss, whole path on a scripted schedule"
              f"{', behind the spin' if spin else ''}: {len(seq)} device "
              f"records, {where}; lost by kernel "
              + json.dumps({k[:48]: v for k, v in lost.most_common(6)})
              + f"; orphan launch calls {orphans}; launches counted "
              + json.dumps(counted) + ", traced " + json.dumps(seen_n),
              flush=True)
    if any(r[1] != runs[0][1] for r in runs):
        fail(f"[{tag}] one scripted schedule counted different launches: "
             f"{[r[1] for r in runs]}")
    what = "whole path on a scripted schedule"
    for _, counted, seen_n, _, _ in runs:
        if any(seen_n[n] > counted[n] for n in names):
            fail(f"[{tag}] {what}: the trace counts more launches than the "
                 f"wrappers did (counted {counted}, traced {seen_n})")
    best = min(runs, key=lambda r: sum(r[1][n] - r[2][n] for n in names))
    exact_trace(tag, what, lambda: traced(run)[3:] + (None,),
                first=(best[1], best[2], None))


def continuous_reliability(tag: str, eng, reqs: list, solo: dict) -> None:
    """Under a scripted clock, on the main engine: a KV poison, a deadline
    and a cancel in one run (mates bit-identical to solo), then a bounded
    queue that sheds; ``stats`` statuses equal the registry's."""
    rel = [dataclasses.replace(reqs[i], uid=100 + i, max_new_tokens=32,
                               cancel_token=CancelToken()) for i in range(4)]
    want = {r.uid: eng.generate([r])[0].tokens for r in rel}
    rel[2] = dataclasses.replace(rel[2], deadline=0.2)
    poison = kv_poison_hook(0, at_chunk=1)
    cancel = chunk_action_hook({2: rel[3].cancel})
    eng.fault_hook = lambda cache, sched: (poison(cache, sched),
                                           cancel(cache, sched))[0]
    reg = MetricsRegistry()
    eng.telemetry = Telemetry(metrics=reg)
    try:
        out = eng.generate(rel, clock=ScriptedClock([], tail_step=0.01))
    finally:
        eng.fault_hook = eng.telemetry = None
    st = eng.stats
    counts = {s: reg.value("serve.requests_total", engine="continuous",
                           status=s) for s in st["statuses"]}
    good = ([r.status for r in out] == ["failed", "ok", "timeout",
                                        "cancelled"]
            and st["quarantined_slots"] == [0]
            and out[1].tokens == want[101]
            and all(prefix_of(out[i].tokens, want[100 + i])
                    for i in (0, 2, 3))
            and counts == st["statuses"])
    print(f"[{tag}] reliability (scripted clock): KV poison in slot 0, a "
          f"deadline, a cancel at chunk edge 2 -> "
          f"{[(r.status, len(r.tokens)) for r in out]}, quarantined "
          f"{st['quarantined_slots']}, the mate bit-identical to solo "
          f"{out[1].tokens == want[101]}, partial outputs prefixes of solo; "
          f"stats statuses {st['statuses']} == registry's "
          f"{counts == st['statuses']}: {good}", flush=True)
    if not good:
        fail(f"[{tag}] reliability statuses or tokens wrong")
    shed = [dataclasses.replace(reqs[i], uid=200 + i,
                                cancel_token=CancelToken())
            for i in (2, 5, 8, 11)]
    eng.max_queue = 2
    try:
        out = eng.generate(shed)
    finally:
        eng.max_queue = None
    good = ([r.status for r in out] == ["ok", "ok", "shed", "shed"]
            and [r.tokens for r in out[:2]] == [solo[2], solo[5]]
            and eng.stats["statuses"]["shed"] == 2)
    print(f"[{tag}] max_queue=2 with 4 requests at once: "
          f"{[r.status for r in out]}, served ones bit-identical to solo: "
          f"{good}", flush=True)
    if not good:
        fail(f"[{tag}] the bounded queue did not shed typed")


def continuous_fp32(tag: str, cfg, reqs: list, pcfg=TILE_PCFG) -> None:
    """At ``fp32_layers`` layers of full width in fp32: the continuous
    engine's greedy tokens equal ``ServeEngine(batch_size=1)``'s."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                num_layers=CONT["fp32_layers"])
    model = LM(cfg32, device=DEV)
    art = greedy_prune(model.init(torch.Generator(device=DEV).manual_seed(
        0)), pcfg, device=DEV).pack(device=DEV)
    sub = reqs[:CONT["fp32_requests"]]
    cont = [r.tokens for r in continuous_engine(model, art).generate(sub)]
    solo_eng = ServeEngine(model, art, packed=True, batch_size=1,
                           max_seq_len=CONT["max_seq"], device=DEV)
    solo = [solo_eng.generate([r])[0].tokens for r in sub]
    print(f"[{tag}] fp32, {CONT['fp32_layers']} of {cfg.num_layers} layers "
          f"at full width: continuous greedy tokens identical to "
          f"ServeEngine(batch_size=1) for {len(sub)} mixed-length requests: "
          f"{cont == solo} ({sum(len(t) for t in cont)} tokens)", flush=True)
    if cont != solo:
        fail(f"[{tag}] fp32 continuous tokens differ from solo serving")


def phase_continuous(smi: str, art) -> dict:
    """qwen2-1.5b's loaded artifact through ``ContinuousEngine``: captures,
    the main path, solo identity, graph against eager, reliability, the
    fp32 bar and the chunked engine's reading on the same requests."""
    tag = "continuous"
    cfg = get_config("qwen2-1.5b")
    model = LM(cfg, device=DEV)
    reqs = continuous_requests(cfg.vocab_size)
    eng = continuous_engine(model, art)
    t0 = time.perf_counter()
    eng.generate(reqs[:len(CONT["lens"])])     # captures each S, decode
    torch.cuda.synchronize()
    caps = {f"prefill S={S}": eng.prefill_graphs[S].graph.pool_bytes
            for S in CONT["lens"]} if eng.graphs else {}
    if eng.graphs:
        caps["decode"] = eng.decode_graph.graph.pool_bytes
    print(f"[{tag}] qwen2-1.5b L={cfg.num_layers} d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} {cfg.param_dtype}, the [serve] phase's "
          f"loaded artifact; ContinuousEngine(batch_size={CONT['batch']}, "
          f"max_seq_len={CONT['max_seq']}, chunk_steps={CONT['chunk']}); "
          f"{len(caps)} graphs captured in {time.perf_counter() - t0:.2f} s "
          f"(first use, with {len(CONT['lens'])} requests served); one pool "
          f"of {eng.graph_pool.reserved if eng.graphs else 0} bytes, by "
          f"capture " + json.dumps(caps) + f" ({smi})", flush=True)
    main = continuous_main(tag, smi, eng, reqs)

    solo = {r.uid: eng.generate([r])[0].tokens for r in reqs}
    same = [r.tokens == solo[r.uid] for r in main["results"]]
    print(f"[{tag}] each request bit-identical to its solo run through the "
          f"same engine (batch {CONT['batch']}, other rows idle): "
          f"{sum(same)}/{len(same)}", flush=True)
    if not all(same):
        fail(f"[{tag}] continuous tokens depend on chunk-mates: "
             f"{[r.uid for r, s in zip(main['results'], same) if not s]}")

    sub = reqs[:CONT["eager_requests"]]
    sched = [0.3 * i for i in range(len(sub))]
    eager = continuous_engine(model, art)
    eager.graphs = False
    runs = [recorded_run(e, sub, arrivals=sched,
                         clock=ScriptedClock([], tail_step=0.05))
            for e in (eng, eager)]
    same = runs[0] == runs[1]
    print(f"[{tag}] graphs against eager, one scripted schedule "
          f"({len(sub)} requests, {len(runs[0][1])} chunks): tokens, "
          f"statuses and every chunk's tokens and flags bit-identical "
          f"{same}", flush=True)
    if not same:
        fail(f"[{tag}] the slot graphs disagree with the eager path")
    del eager
    continuous_reliability(tag, eng, reqs, solo)

    chunked = launch_serve.make_engine(model, art, batch=CONT["batch"],
                                       max_seq=CONT["max_seq"], packed=True,
                                       device=DEV)
    chunked.generate(reqs)                          # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = chunked.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    order = sorted(range(len(reqs)), key=lambda i: len(reqs[i].prompt))
    B = CONT["batch"]
    total = sum(B * max(reqs[i].max_new_tokens for i in order[c:c + B])
                for c in range(0, len(order), B))
    n_tok = sum(len(r.tokens) for r in out)
    print(f"[{tag}] reading, not a claim: the chunked ServeEngine on the "
          f"same {len(reqs)} requests submitted at once (length-bucketed, "
          f"no arrivals): wall {wall * 1e3:.1f} ms, {n_tok / wall:.1f} "
          f"tok/s, occupancy {n_tok / total:.4f} ({smi})", flush=True)
    del chunked, eng, model
    torch.cuda.empty_cache()
    continuous_fp32(tag, cfg, reqs)
    return main["launches"]


# ------------------------------------------------------ speculative serving

SPEC = dict(batch=4, prompt=128, new=64, draft_k=4, max_seq=256,
            shallow=14, fp32_layers=4)


def spec_requests(vocab: int) -> list:
    g = torch.Generator().manual_seed(3)
    return [Request(uid=i, prompt=torch.randint(0, vocab, (SPEC["prompt"],),
                                                generator=g),
                    max_new_tokens=SPEC["new"]) for i in range(SPEC["batch"])]


def spec_engine(model, target, draft, draft_model=None, **kw):
    return SpeculativeEngine(model, target, draft, draft_model=draft_model,
                             batch_size=SPEC["batch"],
                             max_seq_len=SPEC["max_seq"],
                             draft_k=SPEC["draft_k"], device=DEV, **kw)


def plain_engine(model, params, packed: bool = False):
    return launch_serve.make_engine(model, params, batch=SPEC["batch"],
                                    max_seq=SPEC["max_seq"], packed=packed,
                                    device=DEV)


def spec_state(eng) -> list:
    """Clones of both caches, the pending tokens and the round blocks."""
    out = []
    for cache in (eng.target.cache, eng.drafter.cache):
        out += [t.clone() for t in cache["k"] + cache["v"]]
        out += [cache["slot_pos"].clone(), cache["pos"].clone()]
    return out + [eng.bufs[k].clone() for k in ("token", "out", "keep",
                                                 "acc")]


def spec_restore(eng, state: list) -> None:
    live = []
    for cache in (eng.target.cache, eng.drafter.cache):
        live += cache["k"] + cache["v"] + [cache["slot_pos"], cache["pos"]]
    live += [eng.bufs[k] for k in ("token", "out", "keep", "acc")]
    for t, saved in zip(live, state):
        t.copy_(saved)


def round_against_eager(tag: str, eng, reqs: list, rounds: int = 2) -> None:
    """From one prefilled chunk: ``rounds`` replays of the round graph
    against the same rounds run eagerly from the same state, both caches,
    the pending tokens and the round blocks bit for bit."""
    eng.prefill_chunk(reqs)
    start = spec_state(eng)
    eng.greedy_rounds(rounds)
    graph = spec_state(eng)
    spec_restore(eng, start)
    eng.graphs = False
    try:
        eng.greedy_rounds(rounds)
    finally:
        eng.graphs = True
    same = all(torch.equal(a, b) for a, b in zip(graph, spec_state(eng)))
    print(f"[{tag}] round graph against eager, {rounds} rounds from one "
          f"prefilled chunk: both caches, pending tokens and round blocks "
          f"bit-identical {same}", flush=True)
    if not same:
        fail(f"[{tag}] the speculative round graph disagrees with the "
             f"eager round")


def agreement(got: list, want: list) -> dict:
    """Requests identical, and each request's first diverging position."""
    first = [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                  None if len(g) == len(w) else min(len(g), len(w)))
             for g, w in zip(got, want)]
    return {"identical": sum(f is None for f in first), "of": len(got),
            "first_divergence": first}


def packed_split(params) -> tuple:
    """Packed leaves in the blocks and outside them (the head)."""
    paths = [p for p, x in tree_items(params) if is_packed(x)]
    layer = sum(p.startswith("blocks/") for p in paths)
    return layer, len(paths) - layer


def spec_arm(tag: str, arm: str, smi: str, eng, reqs: list, plain: list,
             expect_demoted: bool) -> dict:
    """One arm's main path: a first generate captures the graphs (and
    demotes a collapsing drafter: later chunks decode plainly), then the
    counts are zeroed around a second; its gates and readings. Returns the
    run's launches and readings."""
    first = [r.tokens for r in eng.generate(reqs)]          # captures
    torch.cuda.synchronize()
    st = eng.stats
    print(f"[{tag}] arm {arm}, first generate (captures): rounds "
          f"{st['rounds']}, acceptance {st['acceptance_rate']:.4f}, "
          f"demotions {json.dumps(st['demotions'])}, bf16 agreement with "
          f"plain " + json.dumps(agreement(first, plain)), flush=True)
    if st["demoted"] is not expect_demoted:
        fail(f"[{tag}] arm {arm}: demoted {st['demoted']}, expected "
             f"{expect_demoted} ({st['demotions']})")
    drafting = not eng.demoted
    reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    names = ("pattern_gemm", "flash_attention")
    launches = launch_counts(names)
    routes = {"pattern_gemm": dict(pg_mod.ROUTE_LAUNCHES),
              "flash_attention": dict(fa_mod.ROUTE_LAUNCHES),
              "blockwise_fallbacks": attention.PREFILL_FALLBACKS}
    toks = [r.tokens for r in out]
    n_tok = sum(len(t) for t in toks)
    agree = agreement(toks, plain)
    reading = {"wall_ms": wall * 1e3, "tokens": n_tok,
               "tok_s": n_tok / wall,
               "ms_per_round": (wall * 1e3 / st["rounds"]
                                if st["rounds"] else None),
               **{k: st[k] for k in ("rounds", "dispatches", "drafted",
                                     "accepted", "acceptance_rate",
                                     "demoted")},
               "demotions": [d["at"] for d in st["demotions"]],
               "bf16_agreement_with_plain": agree}
    print(f"[{tag}] arm {arm}: " + json.dumps(reading) + "; launches "
          + json.dumps(launches) + " by route " + json.dumps(routes)
          + f" ({smi})", flush=True)
    for r in out:
        if len(r.tokens) != SPEC["new"] or not all(
                0 <= t < eng.model.config.vocab_size for t in r.tokens):
            fail(f"[{tag}] arm {arm} request {r.uid}: bad tokens "
                 f"{r.tokens[:8]}...")
    if st["demoted"] is not expect_demoted:
        fail(f"[{tag}] arm {arm}: demoted {st['demoted']}, expected "
             f"{expect_demoted} ({st['demotions']})")
    # the design's route counts: flash on every prefill (target, and the
    # drafter's unless demoted), all wgmma, no blockwise fallback;
    # a packed drafter launches its layer GEMMs on wgmma at M = B * S and
    # its head on skinny at M = B in the prefill, then every GEMM on
    # skinny at M = B in each of its K steps of every round
    layers = eng.model.config.num_layers + (
        eng.draft_model.config.num_layers if drafting else 0)
    layer_p, head_p = (packed_split(eng.drafter.params) if drafting
                       else (0, 0))
    want = {"flash": layers,
            "pattern_gemm skinny": head_p + st["rounds"] * SPEC["draft_k"]
            * (layer_p + head_p),
            "pattern_gemm wgmma": layer_p}
    got = {"flash": fa_mod.ROUTE_LAUNCHES["wgmma"],
           "pattern_gemm skinny": pg_mod.ROUTE_LAUNCHES["skinny"],
           "pattern_gemm wgmma": pg_mod.ROUTE_LAUNCHES["wgmma"]}
    print(f"[{tag}] arm {arm}: launches by route, counted "
          + json.dumps(got) + ", by design " + json.dumps(want), flush=True)
    if (got != want or launches["flash_attention"] != layers
            or launches["pattern_gemm"] != want["pattern_gemm skinny"]
            + want["pattern_gemm wgmma"] or attention.PREFILL_FALLBACKS):
        fail(f"[{tag}] arm {arm}: launches {got} / {launches} are not the "
             f"design's {want} (blockwise fallbacks "
             f"{attention.PREFILL_FALLBACKS})")
    return dict(reading, launches=launches)


def plain_reading(tag: str, what: str, smi: str, eng, reqs: list) -> list:
    eng.generate(reqs)                          # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [r.tokens for r in eng.generate(reqs)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(t) for t in out)
    step = timed_ms(eng.decode_graph.graph.replay, 10)
    print(f"[{tag}] plain ServeEngine on {what}: wall {wall * 1e3:.1f} ms, "
          f"{n_tok / wall:.1f} tok/s ({n_tok} tokens); decode step (graph "
          f"replay, device) {step:.4f} ms ({smi})", flush=True)
    return out


def spec_device_times(tag: str, smi: str, eng, reqs: list) -> None:
    """Device ms, from a prefilled chunk, of one round (a replay of the
    round graph), one drafter decode step and one verify chunk (each
    captured alone for this; CUDA events behind a device sleep), then a
    profile of one round. Leaves the engine's caches dirty."""
    eng.prefill_chunk(reqs)
    tc, dc = eng.target.cache, eng.drafter.cache
    t_pos, d_pos = tc["pos"].clone(), dc["pos"].clone()
    tok = eng.bufs["token"].clone()
    chunk = tok.repeat(1, SPEC["draft_k"])

    def rnd():
        eng.bufs["col"].zero_()
        tc["pos"].copy_(t_pos)
        dc["pos"].copy_(d_pos)
        eng.round_graph.graph.replay()

    def step():
        dc["pos"].copy_(d_pos)
        eng.draft_model.decode_step(eng.drafter.params, dc, tok)

    def verify():
        tc["pos"].copy_(t_pos)
        eng.model.verify_chunk(eng.params, tc, chunk)

    pool = eng.target.graph_pool
    t = {"round_ms": timed_ms(rnd, 10),
         "draft_step_ms": timed_ms(CountedGraph(step, pool).replay, 10),
         "verify_chunk_ms": timed_ms(CountedGraph(verify, pool).replay, 10)}
    t["round_rest_ms"] = (t["round_ms"] - SPEC["draft_k"]
                          * t["draft_step_ms"] - t["verify_chunk_ms"])
    print(f"[{tag}] arm a device times, graph replays (CUDA events behind "
          f"a device sleep; round_rest: snapshots, acceptance, rollbacks): "
          + json.dumps(t) + f" ({smi})", flush=True)
    profile(tag, "one speculative round (graph replay)", rnd, names=())


def spec_fp32(tag: str, cfg) -> None:
    """At ``fp32_layers`` layers of full width in fp32, speculative greedy
    tokens equal the plain ServeEngine's on the same target, every arm."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                num_layers=SPEC["fp32_layers"])
    model = LM(cfg32, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    art = greedy_prune(params, TILE_PCFG, device=DEV).pack(device=DEV)
    garbage = model.init(torch.Generator(device=DEV).manual_seed(99))
    d_model, d_params = shallow_drafter(model, params,
                                        SPEC["fp32_layers"] // 2)
    reqs = spec_requests(cfg.vocab_size)
    pruned = [r.tokens for r in plain_engine(model, art).generate(reqs)]
    dense = [r.tokens for r in plain_engine(model, params).generate(reqs)]
    arms = {"a": (spec_engine(model, art, art), pruned, False),
            "b": (spec_engine(model, params, d_params, d_model,
                              demote_below=0.0), dense, False),
            "c": (spec_engine(model, params, garbage, demote_after=8,
                              demote_below=0.5), dense, True)}
    for arm, (eng, want, demoted) in arms.items():
        got = [r.tokens for r in eng.generate(reqs)]
        print(f"[{tag}] fp32, {SPEC['fp32_layers']} of {cfg.num_layers} "
              f"layers at full width, arm {arm}: speculative greedy tokens "
              f"identical to the plain ServeEngine's {got == want} "
              f"({sum(len(t) for t in got)} tokens, acceptance "
              f"{eng.stats['acceptance_rate']:.4f}, demoted "
              f"{eng.stats['demoted']})", flush=True)
        if got != want:
            fail(f"[{tag}] fp32 arm {arm}: speculative tokens differ from "
                 f"plain decoding: " + json.dumps(agreement(got, want)))
        if eng.stats["demoted"] is not demoted:
            fail(f"[{tag}] fp32 arm {arm}: demoted {eng.stats['demoted']}")


def phase_speculative(smi: str, art) -> dict:
    """qwen2-1.5b at full width, bf16: (a) the [serve] artifact's pruned
    weights bound dense verify, the same artifact bound packed drafts;
    (b) unpruned dense weights verify, their first 14 layers draft; (c) a
    re-initialised drafter demotes ((b) never does: ``demote_below``
    0). Round graph against eager, launch
    counts by design, readings against plain decoding, the fp32 bar."""
    tag = "speculative"
    cfg = get_config("qwen2-1.5b")
    model = LM(cfg, device=DEV)
    reqs = spec_requests(cfg.vocab_size)
    print(f"[{tag}] qwen2-1.5b L={cfg.num_layers} d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} {cfg.param_dtype}; batch {SPEC['batch']}"
          f", {SPEC['batch']} x {SPEC['prompt']}-token prompts, "
          f"{SPEC['new']} new, draft_k {SPEC['draft_k']}, max_seq_len "
          f"{SPEC['max_seq']} ({smi})", flush=True)
    pruned = plain_reading(tag, "the pruned weights, dense", smi,
                           plain_engine(model, art), reqs)
    plain_reading(tag, "the packed artifact", smi,
                  plain_engine(model, art, packed=True), reqs)
    eng = spec_engine(model, art, art)
    a = spec_arm(tag, "a (pruned dense target, the artifact packed drafts)",
                 smi, eng, reqs, pruned, expect_demoted=False)
    round_against_eager(tag, eng, reqs)
    spec_device_times(tag, smi, eng, reqs)
    del eng
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    dense = plain_reading(tag, "the unpruned dense weights", smi,
                          plain_engine(model, params), reqs)
    d_model, d_params = shallow_drafter(model, params, SPEC["shallow"])
    # demotion off: with random weights half the layers rarely agree
    # with all of them, and this arm is there to roll back every round
    eng = spec_engine(model, params, d_params, d_model, demote_below=0.0)
    b = spec_arm(tag, f"b (unpruned dense target, its first "
                 f"{SPEC['shallow']} layers draft)", smi, eng, reqs, dense,
                 expect_demoted=False)
    round_against_eager(tag, eng, reqs)
    del eng, d_params
    garbage = model.init(torch.Generator(device=DEV).manual_seed(99))
    eng = spec_engine(model, params, garbage, demote_after=8,
                      demote_below=0.5)
    spec_arm(tag, "c (a re-initialised drafter, demote_after 8 below 0.5)",
             smi, eng, reqs, dense, expect_demoted=True)
    del eng, garbage, params
    torch.cuda.empty_cache()
    spec_fp32(tag, cfg)
    return {k: a["launches"][k] + b["launches"][k]
            for k in ("pattern_gemm", "flash_attention")}


# --------------------------------------------------------- the plan tuner

# (a) the served Ms: decode at batch 4, a 4 x 128 and a 4 x 512 chunk; (b)
# the Ms every candidate is held bitwise to the untuned call at (both
# routes of bucket m32: skinny to 16, wgmma above); (e) an eager decode
TUNE = dict(ms=(4, 512, 2048), iters=3, check_ms=(4, 17, 24, 32, 512, 2048),
            eager_prompt=128, eager_new=8, reps=3)


def tune_bitwise(tag: str) -> int:
    """(b) Every candidate plan against the untuned call, ``torch.equal``:
    the tile and column GEMMs at qwen2-1.5b's shapes (their bias and
    activation) at each M of ``TUNE["check_ms"]``, and VGG-16's convs at
    batch 32 (ReLU). Returns the calls compared."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    cuda = torch.device(DEV).type == "cuda"
    n = 0
    for name, Q, P, has_bias, act in QWEN2_GEMMS:
        w = torch.randn((Q, P), generator=gen, device=DEV) / math.sqrt(Q)
        b = (torch.randn(P, generator=gen, device=DEV) * 0.1).bfloat16() \
            if has_bias else None
        wt = project_tile_pattern(w.T, block_p=128).T.contiguous()
        wc = project_column(w.T, alpha=0.5).T.contiguous()
        leaves = (SCHEMES["tile_pattern"].pack(wt.bfloat16(), LayerSpec(
            scheme="tile_pattern", tile_block_p=128, tile_group_q=8,
            tile_keep=4)), SCHEMES["column"].pack(
            wc.bfloat16(), LayerSpec(scheme="column", alpha=0.5)))
        del w, wt, wc
        for pt in leaves:
            handler = SCHEMES[pt.scheme]
            for M in TUNE["check_ms"]:
                x = torch.randn((M, Q), generator=gen,
                                device=DEV).bfloat16()
                want = handler.plan(pt, M, act, None)(x, pt, b)
                for c in tune_mod.candidate_plans(pt, "matmul", M,
                                                  cuda=cuda):
                    got = handler.plan(pt, M, act, c)(x, pt, b)
                    n += 1
                    if not torch.equal(got, want):
                        fail(f"[{tag}] (b) {pt.scheme} {name} M={M}: plan "
                             f"{c.to_str()} differs from the untuned call")
                del x, want, got
        del leaves
    for B, H, C, A in VGG16_CONVS:
        w4 = torch.randn((A, C, 3, 3), generator=gen, device=DEV)
        w4 = project((w4 * math.sqrt(2.0 / (9 * C))).bfloat16(),
                     "pattern_shared", alpha=0.25)
        pt = handler_for("pattern_shared").pack(w4, PATTERN_SPEC)
        wp, taps = pt.buf("w_packed"), pt.buf("taps")
        b = (torch.randn(A, generator=gen, device=DEV) * 0.1).bfloat16()
        x = torch.randn((B, H, H, C), generator=gen, device=DEV).bfloat16()
        want = conv_gemm_runner(pt, None, activation="relu")(x, wp, taps, b)
        for c in tune_mod.candidate_plans(pt, "conv", B * H * H, cuda=cuda):
            got = conv_gemm_runner(pt, c, activation="relu")(x, wp, taps, b)
            n += 1
            if not torch.equal(got, want):
                fail(f"[{tag}] (b) conv B={B} {H}x{H} {C}->{A}: plan "
                     f"{c.to_str()} differs from the untuned call")
        del x, want, got, w4, pt, wp, taps
    torch.cuda.empty_cache()
    return n


def tune_artifact(tag: str, smi: str, art):
    """(a) Tune the artifact for ``TUNE["ms"]``: per geometry every
    candidate's ms, the winner, the heuristic's ms and the search's
    seconds. Returns (the tuned artifact, seconds in all)."""
    searches = []
    search = tune_mod.tune_plan

    def timed_search(pt, kind, M, **kw):
        t0 = time.perf_counter()
        out = search(pt, kind, M, **kw)
        torch.cuda.synchronize()
        searches.append((pt, M, time.perf_counter() - t0, out))
        return out

    tune_mod.tune_plan = timed_search
    try:
        with registry_scope() as reg:
            t0 = time.perf_counter()
            tuned = art.tune(TUNE["ms"], iters=TUNE["iters"])
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            n_cands = reg.sum_counter("tune.candidates_total")
    finally:
        tune_mod.tune_plan = search
    names: dict = {}
    for path, pt in tree_items(tuned.packed):
        if is_packed(pt):
            names.setdefault(tuple(pt.shape), set()).add(
                reference_path(path).split("/")[-1])
    dev = torch.device(DEV)
    cuda = dev.type == "cuda"
    sms = tune_mod.sm_count(dev) if cuda else 0
    for pt, M, secs, (plan, times) in searches:
        heur = tune_mod.heuristic_plan(pt, "matmul", M, cuda=cuda, sms=sms)
        print(f"[{tag}] (a) {'/'.join(sorted(names[tuple(pt.shape)]))} "
              f"{pt.shape[0]}x{pt.shape[1]} M={M}: candidates ms "
              f"{json.dumps(times)}; winner {plan.to_str()} "
              f"{times[plan.to_str()]} ms; heuristic {heur.to_str()} "
              f"{times[heur.to_str()]} ms; search {secs:.3f} s ({smi})",
              flush=True)
    # one search per geometry (shape, buffer shapes and dtypes) and bucket
    geometries = {(tuple(pt.shape), tuple((tuple(b.shape), b.dtype)
                                          for b in pt.buffers))
                  for _, pt in tree_items(art.packed) if is_packed(pt)}
    want = len(geometries) * len({tune_mod.m_bucket(M) for M in TUNE["ms"]})
    print(f"[{tag}] (a) tuned in {total:.2f} s: {len(searches)} searches "
          f"for {len(geometries)} geometries x {len(TUNE['ms'])} buckets, "
          f"{n_cands:.0f} candidates timed ({smi})", flush=True)
    if len(searches) != want or not searches:
        fail(f"[{tag}] (a) {len(searches)} searches for {want} geometries")
    return tuned, total


def tuned_serve(tag: str, smi: str, model, art, tuned) -> dict:
    """(c) The tuned artifact through the launcher's engine (graphs): its
    main path with counts zeroed around it, tokens equal to [serve]'s
    untuned ones; prefill ms a chunk and decode ms a step, tuned and
    untuned (graph replays). Returns the main path's launch counts."""
    reqs = make_requests(model.config.vocab_size)
    engines = {}
    for which, a in (("untuned", art), ("tuned", tuned)):
        eng = launch_serve.make_engine(model, a, batch=4, max_seq=544,
                                       packed=True, device=DEV)
        for r in (reqs[0], reqs[4]):      # captures: decode, S = 512 and 128
            eng.generate([r])
        engines[which] = eng
    torch.cuda.synchronize()
    names = ("pattern_gemm", "flash_attention")
    reset_launches()                                    # the main path
    t0 = time.perf_counter()
    results = engines["tuned"].generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(names)
    L = model.config.num_layers
    print(f"[{tag}] (c) tuned generate(8 requests) {wall * 1e3:.1f} ms; "
          f"launches (graph replays counted) {json.dumps(launches)}; "
          f"pattern_gemm by route {json.dumps(pg_mod.ROUTE_LAUNCHES)} "
          f"({smi})", flush=True)
    if launches != {"pattern_gemm": 2 * 32 * (7 * L + 1),
                    "flash_attention": 2 * L}:
        fail(f"[{tag}] (c) launches {launches}")
    tokens = [r.tokens for r in results]
    untuned = [r.tokens for r in engines["untuned"].generate(reqs)]
    same = tokens == SERVED_TOKENS["serve"] == untuned
    print(f"[{tag}] (c) tuned tokens identical to [serve]'s untuned ones "
          f"and to an untuned engine's: {same} ({smi})", flush=True)
    if not same:
        fail(f"[{tag}] (c) the tuned artifact serves other tokens")
    readings = {}
    for which, eng in engines.items():
        for S, chunk in ((128, reqs[4:]), (512, reqs[:4])):
            prompts, mask = eng.pad_prompts(chunk)
            eng.set_rows(chunk, mask)
            readings[f"{which}_prefill_ms_S{S}"] = median_s(
                lambda: eng.prefill(prompts), 5) * 1e3
        tok0 = eng.prefill(prompts)[1].argmax(-1)
        readings[f"{which}_decode_ms_per_step"] = median_s(
            lambda: eng.decode(tok0, 31), 5) * 1e3 / 31
    print(f"[{tag}] (c) " + json.dumps(readings) + f" ({smi})", flush=True)
    return launches, engines["tuned"], reqs, tokens


@contextlib.contextmanager
def autotune_on(found: list):
    """First-dispatch search on (``REPRO_AUTOTUNE=1``, no plan memoized)
    inside; appends to ``found`` the candidates it timed."""
    tune_mod.clear_tuned_cache()
    os.environ["REPRO_AUTOTUNE"] = "1"
    try:
        with registry_scope() as reg:
            yield
            found.append(reg.sum_counter("tune.candidates_total"))
    finally:
        del os.environ["REPRO_AUTOTUNE"]


def tuned_reload(tag: str, smi: str, model, tuned, reqs) -> None:
    """(d) ``round_trip`` of the tuned artifact's first 4 layers, the
    loaded cut served with first-dispatch search on: the plans survive,
    and the loaded cut runs no search and serves the in-memory cut's
    tokens."""
    found = []
    cut, loaded = round_trip(tag, tuned, model.config, reqs,
                             serving=lambda: autotune_on(found))
    plans = tune_mod.describe_plans(loaded.packed)
    same = plans == tune_mod.describe_plans(cut.packed)
    print(f"[{tag}] (d) plans of {len(plans)} leaves identical after save "
          f"and load: {same} ({smi})", flush=True)
    if not same or not plans:
        fail(f"[{tag}] (d) plans lost in save and load")
    print(f"[{tag}] (d) the loaded artifact served with REPRO_AUTOTUNE=1: "
          f"{found[0]:.0f} candidates timed ({smi})", flush=True)
    if found[0]:
        fail(f"[{tag}] (d) serving the loaded artifact searched "
             f"({found[0]})")
    del loaded


def tune_profile(tag: str, smi: str, model, tuned, graph_eng, reqs,
                 kernel_rows: list) -> None:
    """(e) The profiler at full sampling: an eager decode of a few steps
    (its rows beside the [kernels] rows at the same shapes; tokens on ==
    off), then the graph path's tokens/s off and on."""
    eager = ServeEngine(model, tuned, packed=True, batch_size=4,
                        max_seq_len=544, device=DEV)
    eager.graphs = False
    g = torch.Generator().manual_seed(5)
    ereqs = [Request(uid=i, prompt=torch.randint(
        0, model.config.vocab_size, (TUNE["eager_prompt"],), generator=g),
        max_new_tokens=TUNE["eager_new"]) for i in range(4)]
    off = [r.tokens for r in eager.generate(ereqs)]
    with profiler_scope(sample_rate=1.0) as prof:
        # the first wall of each key is the profiler's warm-up, discarded
        on = [[r.tokens for r in eager.generate(ereqs)] for _ in range(2)]
        rows = prof.report()
    print(f"[{tag}] (e) eager decode, {TUNE['eager_new']} steps, profiler "
          f"at full sampling: tokens identical on and off: "
          f"{on == [off, off]} ({smi})", flush=True)
    if on != [off, off]:
        fail(f"[{tag}] (e) the profiler changed tokens")
    for r in rows:
        print(f"[{tag}] (e) report " + json.dumps(r) + f" ({smi})",
              flush=True)
    # the [kernels] rows' device ms (cold L2) at the same shapes, mixed as
    # the path launches them: per layer LAYER_GEMMS, the head once a step
    mine = {r["shape"]: r["ms"] for r in kernel_rows
            if r["kernel"] == "pattern_gemm" and r["dtype"] == "bfloat16"}
    L = model.config.num_layers
    for M, bucket in ((4, 32), (512, 512)):
        layer = sum(n * mine[f"{g} M={M}"] for g, n in LAYER_GEMMS.items())
        head = mine["lm_head M=4"] if M == 4 else 0.0
        calls = 7 * L + (M == 4)
        got = [r for r in rows if r["kind"] == "matmul"
               and r["bucket"] == bucket]
        print(f"[{tag}] (e) matmul bucket m{bucket}: profiler median "
              f"{[round(r['measured_ns'] * 1e-6, 4) for r in got]} ms a "
              f"call (plans {[r['plan'] for r in got]}) beside [kernels] "
              f"{(L * layer + head) / calls:.4f} ms a call at M={M} "
              f"(the path's mix, cold L2) ({smi})", flush=True)
    kinds = {(r["kind"], r["scheme"]) for r in rows}
    if not {("matmul", "tile_pattern"), ("prefill", "engine:chunked"),
            ("decode_many", "engine:chunked")} <= kinds:
        fail(f"[{tag}] (e) report rows {sorted(kinds)}")
    del eager
    n_tok = sum(r.max_new_tokens for r in reqs)
    rates = {}
    tokens = {}
    for which in ("off", "full sampling", "off again"):
        times = []
        for _ in range(TUNE["reps"]):
            if which == "full sampling":
                with profiler_scope(sample_rate=1.0) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = graph_eng.generate(reqs)
                    prof.report()
                    times.append(time.perf_counter() - t0)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = graph_eng.generate(reqs)
                times.append(time.perf_counter() - t0)
        rates[which] = n_tok / statistics.median(times)
        tokens[which] = [r.tokens for r in out]
    overhead = 1.0 - rates["full sampling"] / rates["off"]
    print(f"[{tag}] (e) graph path tokens/s (median of {TUNE['reps']}) "
          f"{json.dumps({k: round(v, 1) for k, v in rates.items()})}; "
          f"overhead at full sampling {overhead * 100:.2f}% (the "
          f"reference's target 2%; not gated); tokens identical: "
          f"{tokens['off'] == tokens['full sampling']} ({smi})", flush=True)
    if tokens["off"] != tokens["full sampling"]:
        fail(f"[{tag}] (e) the profiler changed the graph path's tokens")


def phase_tune(smi: str, art, kernel_rows: list) -> dict:
    """The plan tuner, the plan-cached registry and the profiler on the
    [serve] artifact (qwen2-1.5b, tile 4 of 8, bf16): (b) candidates
    bitwise, (a) tuning, (c) tuned serving through the graphs, (d) save,
    load and a re-serve with no search, (e) the profiler. Every search
    runs before the main path's counted window."""
    tag = "tune"
    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    model = LM(cfg, device=DEV)
    n = tune_bitwise(tag)
    print(f"[{tag}] (b) every candidate bit-equal to the untuned call: "
          f"{n} calls (tile and column GEMMs at M = "
          f"{list(TUNE['check_ms'])}, VGG-16's convs at batch 32) in "
          f"{time.perf_counter() - t0:.2f} s ({smi})", flush=True)
    tuned, _ = tune_artifact(tag, smi, art)
    launches, graph_eng, reqs, _ = tuned_serve(tag, smi, model, art,
                                               tuned)
    tuned_reload(tag, smi, model, tuned, reqs)
    tune_profile(tag, smi, model, tuned, graph_eng, reqs, kernel_rows)
    del graph_eng, tuned
    torch.cuda.empty_cache()
    print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s ({smi})",
          flush=True)
    return launches


# ------------------------------------------- sliding-window (ring) serving

WIN = dict(batch=4, max_seq=4352, wrap_prompt=4160, decode_prompt=4064,
           new=64, cont_lens=(4160, 1024, 256), cont_new=(64, 32, 48),
           cont_requests=8, cont_chunk=8, gap_s=0.05, draft_k=4,
           fp32_layers=4)


def window_requests(vocab: int, lens, new, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [Request(uid=i, prompt=torch.randint(0, vocab, (n,), generator=g),
                    max_new_tokens=m) for i, (n, m) in enumerate(zip(lens,
                                                                     new))]


def window_serve_requests(vocab: int) -> list:
    """(a): 4 prompts of 4 160 tokens (the prefill wraps the ring) and 4 of
    4 064 (the decode wraps it), 64 new tokens each."""
    B = WIN["batch"]
    return window_requests(
        vocab, (WIN["wrap_prompt"],) * B + (WIN["decode_prompt"],) * B,
        (WIN["new"],) * (2 * B), 10)


def window_flash_gate(tag: str, what: str, L: int, prefills: int) -> None:
    """Every prefill attention call on flash's wgmma route, ``L`` a
    forward, no blockwise fallback."""
    want = L * prefills
    if (fa_mod.LAUNCHES != want or fa_mod.ROUTE_LAUNCHES["wgmma"] != want
            or attention.PREFILL_FALLBACKS):
        fail(f"[{tag}] {what}: flash must launch {L} x {prefills} times on "
             f"wgmma: {fa_mod.LAUNCHES} launches, by route "
             f"{fa_mod.ROUTE_LAUNCHES}, {attention.PREFILL_FALLBACKS} "
             f"blockwise fallbacks")


def ring_graph_against_eager(tag: str, eng, chunk) -> dict:
    """One chunk through the engine's graphs and through ``LM.prefill`` /
    ``LM.decode_many`` called eagerly: logits and tokens bit-identical;
    then the graphs' prefill ms and decode ms a step (medians of 3)."""
    model, params = eng.model, eng.params
    steps = WIN["new"] - 1
    prompts, mask = eng.pad_prompts(chunk)
    eng.set_rows(chunk, mask)
    keys = fold_key_grid(eng.rows["keys"], torch.zeros_like(
        eng.rows["keys"]), steps + 1)
    logits = eng.prefill(prompts)[1].clone()
    tok0 = eng.sample(logits, keys[0])
    toks = eng.decode(tok0, steps).clone()
    cache, want = model.prefill(params, prompts, eng.max_seq_len)
    _, rest = model.decode_many(params, cache, tok0, steps,
                                sampler=eng.sample, keys=keys[1:])
    S = prompts.shape[1]
    same = (torch.equal(logits, want),
            torch.equal(toks, torch.cat([tok0, rest], dim=1)))
    print(f"[{tag}] chunk S={S}: graph against eager, prefill logits "
          f"bit-identical {same[0]}, decode tokens ({steps} steps, positions"
          f" {S} .. {S + steps}, ring of {cache['slot_pos'].shape[1]}) "
          f"bit-identical {same[1]}", flush=True)
    if not all(same):
        fail(f"[{tag}] S={S}: the ring graphs disagree with the eager path")
    del cache
    prefill_ms = median_s(lambda: eng.prefill(prompts)) * 1e3
    decode_ms = median_s(lambda: eng.decode(tok0, steps)) * 1e3 / steps
    return {"S": S, "prefill_graph_ms": prefill_ms,
            "decode_graph_ms_per_step": decode_ms,
            "decode_graph_tok_s": len(chunk) / (decode_ms / 1e3)}


def window_a(tag: str, smi: str, model, art) -> dict:
    """(a) the loaded artifact through the launcher's ``ServeEngine``: the
    main path (counts zeroed around it), graph against eager per chunk,
    readings and a profile of a decode step on the wrapped ring."""
    cfg = model.config
    L = cfg.num_layers
    reqs = window_serve_requests(cfg.vocab_size)
    eng = launch_serve.make_engine(model, art, batch=WIN["batch"],
                                   max_seq=WIN["max_seq"], packed=True,
                                   device=DEV)
    t0 = time.perf_counter()
    eng.generate(reqs)                 # captures: decode, S = 4064, 4160
    torch.cuda.synchronize()
    print(f"[{tag}] (a) ServeEngine(batch_size={WIN['batch']}, max_seq_len="
          f"{WIN['max_seq']}): ring cache of {eng.cache['slot_pos'].shape[1]}"
          f" slots; graphs captured in {time.perf_counter() - t0:.2f} s "
          f"(first use), one pool of {eng.graph_pool.reserved} bytes",
          flush=True)
    reset_launches()                                    # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(("pattern_gemm", "flash_attention"))
    routes = {"pattern_gemm": dict(pg_mod.ROUTE_LAUNCHES),
              "flash_attention": dict(fa_mod.ROUTE_LAUNCHES)}
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[{tag}] (a) generate({len(reqs)} requests: 4 x "
          f"{WIN['wrap_prompt']} + 4 x {WIN['decode_prompt']} prompt tokens,"
          f" {WIN['new']} new) wall {wall * 1e3:.1f} ms, {n_tok} tokens, "
          f"{n_tok / wall:.1f} tok/s; launches {json.dumps(launches)} by "
          f"route {json.dumps(routes)}, blockwise fallbacks "
          f"{attention.PREFILL_FALLBACKS} ({smi})", flush=True)
    window_flash_gate(tag, "(a) generate", L, 2)
    if not (routes["pattern_gemm"]["skinny"]
            and routes["pattern_gemm"]["wgmma"]):
        fail(f"[{tag}] pattern_gemm must launch on skinny (decode) and "
             f"wgmma (prefill): {routes['pattern_gemm']}")
    for r in results:
        if len(r.tokens) != WIN["new"] or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"[{tag}] request {r.uid}: bad tokens {r.tokens[:8]}...")
    B = WIN["batch"]
    chunks = [ring_graph_against_eager(tag, eng, reqs[i:i + B])
              for i in (B, 0)]                  # S = 4064, then 4160
    print(f"[{tag}] (a) graph readings: " + json.dumps(chunks)
          + f" ({smi})", flush=True)
    prompts, mask = eng.pad_prompts(reqs[:B])
    eng.set_rows(reqs[:B], mask)
    tok0 = eng.sample(eng.prefill(prompts)[1], fold_key_grid(
        eng.rows["keys"], torch.zeros_like(eng.rows["keys"]), 1)[0])
    profile(tag, "(a) decode step on the wrapped ring (C = 4096), graph",
            lambda: eng.decode(tok0, 8), per=8)
    return dict(launches, chunks=chunks, tok_s=n_tok / wall)


def window_b(tag: str, smi: str, model, art) -> dict:
    """(b) the loaded artifact through ``ContinuousEngine``: 8 requests at
    seeded arrivals (counts zeroed around them), each bit-identical to
    its solo run through the same engine."""
    cfg = model.config
    L = cfg.num_layers
    n, lens, new = (WIN["cont_requests"], WIN["cont_lens"],
                    WIN["cont_new"])
    reqs = window_requests(cfg.vocab_size, [lens[i % 3] for i in range(n)],
                           [new[i % 3] for i in range(n)], 11)
    g = torch.Generator().manual_seed(12)
    gaps = torch.empty(n - 1, dtype=torch.float64).exponential_(
        1.0 / WIN["gap_s"], generator=g)
    arrivals = [0.0] + torch.cumsum(gaps, 0).tolist()
    eng = ContinuousEngine(model, art, packed=True, batch_size=WIN["batch"],
                           max_seq_len=WIN["max_seq"],
                           chunk_steps=WIN["cont_chunk"], device=DEV)
    eng.generate(reqs[:3])                    # captures each S, decode
    torch.cuda.synchronize()
    reset_launches()                                    # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs, arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(("pattern_gemm", "flash_attention"))
    routes = {"pattern_gemm": dict(pg_mod.ROUTE_LAUNCHES),
              "flash_attention": dict(fa_mod.ROUTE_LAUNCHES)}
    st = eng.stats
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[{tag}] (b) ContinuousEngine(batch_size={WIN['batch']}, "
          f"max_seq_len={WIN['max_seq']}, chunk_steps={WIN['cont_chunk']}):"
          f" {n} requests (prompts {lens}, budgets {new} cycling; seeded "
          f"exponential gaps, mean {WIN['gap_s'] * 1e3:.0f} ms) wall "
          f"{wall * 1e3:.1f} ms, {n_tok} tokens, {n_tok / wall:.1f} tok/s, "
          f"occupancy {st['occupancy']:.4f}, {st['chunks']} chunks, "
          f"statuses {json.dumps(st['statuses'])}; launches "
          f"{json.dumps(launches)} by route {json.dumps(routes)}, blockwise "
          f"fallbacks {attention.PREFILL_FALLBACKS} ({smi})", flush=True)
    window_flash_gate(tag, "(b) admissions", L, n)
    if not (routes["pattern_gemm"]["skinny"]
            and routes["pattern_gemm"]["wgmma"]):
        fail(f"[{tag}] (b) pattern_gemm must launch on skinny and wgmma: "
             f"{routes['pattern_gemm']}")
    for r, q in zip(results, reqs):
        if r.status != "ok" or len(r.tokens) != q.max_new_tokens:
            fail(f"[{tag}] (b) request {r.uid}: {r.status}, "
                 f"{len(r.tokens)} tokens")
    same = [r.tokens == eng.generate([q])[0].tokens
            for r, q in zip(results, reqs)]
    print(f"[{tag}] (b) each request bit-identical to its solo run through "
          f"the same engine (batch {WIN['batch']}, other rows idle): "
          f"{sum(same)}/{len(same)}", flush=True)
    if not all(same):
        fail(f"[{tag}] (b) continuous tokens depend on chunk-mates on the "
             f"ring")
    return dict(launches, tok_s=n_tok / wall)


def window_c(tag: str, smi: str, model, art) -> dict:
    """(c) ``SpeculativeEngine``: the artifact bound packed drafts for its
    pruned weights bound dense, 4 x 4 064-token prompts, rounds crossing
    the wrap; counts zeroed around the main path, rounds graph against
    eager."""
    cfg = model.config
    L = cfg.num_layers
    B = WIN["batch"]
    reqs = window_requests(cfg.vocab_size, (WIN["decode_prompt"],) * B,
                           (WIN["new"],) * B, 13)
    eng = SpeculativeEngine(model, art.params, art, batch_size=B,
                            max_seq_len=WIN["max_seq"],
                            draft_k=WIN["draft_k"], device=DEV)
    eng.generate(reqs)                                 # captures
    torch.cuda.synchronize()
    reset_launches()                                   # the main path
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(("pattern_gemm", "flash_attention"))
    routes = {"pattern_gemm": dict(pg_mod.ROUTE_LAUNCHES),
              "flash_attention": dict(fa_mod.ROUTE_LAUNCHES)}
    st = eng.stats
    n_tok = sum(len(r.tokens) for r in out)
    reading = {"wall_ms": wall * 1e3, "tokens": n_tok,
               "tok_s": n_tok / wall,
               **{k: st[k] for k in ("rounds", "drafted", "accepted",
                                     "acceptance_rate", "demoted")}}
    print(f"[{tag}] (c) SpeculativeEngine(draft_k={WIN['draft_k']}, "
          f"max_seq_len={WIN['max_seq']}), 4 x {WIN['decode_prompt']} "
          f"prompt tokens, {WIN['new']} new: " + json.dumps(reading)
          + f"; launches {json.dumps(launches)} by route "
          + json.dumps(routes) + f" ({smi})", flush=True)
    window_flash_gate(tag, "(c) target and drafter prefills", L, 2)
    if st["demoted"] or not (routes["pattern_gemm"]["skinny"]
                             and routes["pattern_gemm"]["wgmma"]):
        fail(f"[{tag}] (c) the packed drafter must draft (skinny) and "
             f"prefill (wgmma), undemoted: {routes['pattern_gemm']}, "
             f"{st['demotions']}")
    for r in out:
        if len(r.tokens) != WIN["new"]:
            fail(f"[{tag}] (c) request {r.uid}: {len(r.tokens)} tokens")
    round_against_eager(tag, eng, reqs, rounds=20)
    return dict(launches, **reading)


def window_fp32(tag: str, cfg) -> None:
    """At ``fp32_layers`` layers of full width in fp32, on the same ring
    shapes: (a) packed greedy tokens equal the dense-pruned ones; (c)
    speculative tokens (the packed artifact drafting) equal plain
    decoding of the dense-pruned weights."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                num_layers=WIN["fp32_layers"])
    model = LM(cfg32, device=DEV)
    art = greedy_prune(model.init(torch.Generator(device=DEV).manual_seed(
        0)), TILE_PCFG, device=DEV).pack(device=DEV)
    reqs = window_serve_requests(cfg.vocab_size)
    engine = lambda p, packed: launch_serve.make_engine(  # noqa: E731
        model, p, batch=WIN["batch"], max_seq=WIN["max_seq"], packed=packed,
        device=DEV)
    dense = [r.tokens for r in engine(art, False).generate(reqs)]
    packed = [r.tokens for r in engine(art, True).generate(reqs)]
    plain = dense[WIN["batch"]:]                  # the 4 x 4 064 prompts
    spec = SpeculativeEngine(model, art.params, art,
                             batch_size=WIN["batch"],
                             max_seq_len=WIN["max_seq"],
                             draft_k=WIN["draft_k"], device=DEV)
    got = [r.tokens for r in spec.generate(reqs[WIN["batch"]:])]
    print(f"[{tag}] fp32, {WIN['fp32_layers']} of {cfg.num_layers} layers "
          f"at full width, the (a) requests: packed greedy tokens identical "
          f"to dense-pruned {packed == dense} ({sum(len(t) for t in packed)}"
          f" tokens); (c) on the 4 x {WIN['decode_prompt']} prompts, "
          f"speculative tokens identical to plain dense-pruned decoding "
          f"{got == plain} (acceptance "
          f"{spec.stats['acceptance_rate']:.4f})", flush=True)
    if packed != dense:
        fail(f"[{tag}] fp32 packed tokens differ from dense-pruned on the "
             f"ring: " + json.dumps(agreement(packed, dense)))
    if got != plain:
        fail(f"[{tag}] fp32 speculative tokens differ from plain decoding "
             f"on the ring: " + json.dumps(agreement(got, plain)))


def phase_window(smi: str) -> dict:
    """h2o-danube-1.8b at full width (24 layers, d_model 2560, 32 / 8 heads
    of 80, window 4096), bf16, seeded random weights, greedy tile-pattern
    4 of 8 at block_p 128 on the card, packed (``round_trip`` of its first
    4 layers); then (a)
    ``ServeEngine``, (b) ``ContinuousEngine``, (c) ``SpeculativeEngine``
    on a ring cache of 4 096 slots, and the fp32 bar at 4 layers."""
    tag = "window"
    cfg = get_config("h2o-danube-1.8b")
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, device=DEV)
    t0 = time.perf_counter()
    art = greedy_prune(model.init(torch.Generator(device=DEV).manual_seed(
        0)), TILE_PCFG, device=DEV).pack(device=DEV)
    torch.cuda.synchronize()
    print(f"[{tag}] h2o-danube-1.8b L={cfg.num_layers} d_model={cfg.d_model}"
          f" heads {cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} window "
          f"{cfg.sliding_window} {cfg.param_dtype}; init+prune+pack "
          f"{time.perf_counter() - t0:.2f} s; weight bytes dense "
          f"{art.dense_bytes()} packed {art.packed_bytes()} ({smi})",
          flush=True)
    check_exact(tag, art)
    round_trip(tag, art, cfg, make_requests(cfg.vocab_size))
    torch.cuda.empty_cache()
    a = window_a(tag, smi, model, art)
    torch.cuda.empty_cache()
    b = window_b(tag, smi, model, art)
    torch.cuda.empty_cache()
    c = window_c(tag, smi, model, art)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] readings: prefill ms per chunk (graph) "
          + json.dumps({ch["S"]: ch["prefill_graph_ms"]
                        for ch in a["chunks"]})
          + ", decode ms per step (graph) "
          + json.dumps({ch["S"]: ch["decode_graph_ms_per_step"]
                        for ch in a["chunks"]})
          + f", tokens/s (a) {a['tok_s']:.1f} (b) {b['tok_s']:.1f} (c) "
          f"{c['tok_s']:.1f}, acceptance (c) {c['acceptance_rate']:.4f}, "
          f"peak device memory {peak} bytes ({smi})", flush=True)
    del art, model
    torch.cuda.empty_cache()
    window_fp32(tag, cfg)
    return {k: a[k] + b[k] + c[k] for k in ("pattern_gemm",
                                             "flash_attention")}


# ------------------------------------------------ the paper's ADMM pruning

DEV = "cuda"
ADMM_ITERS = 8            # prune_config_for(..., iters=8): rho steps every 2
ADMM_BATCH, ADMM_SEQ = 16, 64
ADMM_SERVE = dict(requests=4, prompt=128, new=16)
ADMM_SHORT_LAYERS = 2     # whole-model, kill-and-resume: 2 of 28 layers
# retraining draws its labels from the first 10 of the head's 1000 classes,
# so 10 AdamW steps visibly lower the loss (from ln 1000); at lr 1e-3 the
# full-width VGG-16's loss jumps between steps, at 3e-4 it falls steadily
ADMM_CNN = dict(iters=4, batch=32, retrain_steps=10, retrain_lr=3e-4,
                retrain_classes=10)
ADMM_VGG = dict(num_classes=1000, image_hwc=(224, 224, 3))


class Stop(Exception):
    """The kill-and-resume check's callback stops its run with this."""


def finite_history(tag: str, history: dict) -> None:
    bad = {k: v for k, v in history.items()
           if not all(math.isfinite(x) for x in v)}
    if bad or not history["loss"]:
        fail(f"[{tag}] non-finite or empty ADMM history: {bad or history}")


def lanes_exact(tag: str, art, keep: int = 4, group: int = 8) -> int:
    """Every pruned leaf keeps exactly ``keep`` of every ``group`` lanes in
    each (block_p x group) tile of its paper view (out, in). Returns the
    number of leaves checked."""
    masks = dict(tree_items(art.masks))
    n = 0
    for path, spec in tree_items(art.specs):
        if spec is None:
            continue
        m = masks[path].T                        # (P = out, Q = in)
        P, Q = m.shape
        lanes = m.reshape(P // spec.tile_block_p, spec.tile_block_p,
                          Q // group, group).ne(0).any(dim=1).sum(dim=-1)
        if not bool((lanes == keep).all()):
            fail(f"[{tag}] {path}: lanes kept per tile {lanes.unique()}, "
                 f"want exactly {keep} of {group}")
        n += 1
    return n


def layerwise_distance(pruner, teacher, student, batch) -> float:
    """Problem (3)'s loss summed over layers: each layer of ``student``
    fed the student's previous output, against the teacher's output."""
    adapter = pruner.adapter
    acts = pruner.teacher_acts(teacher, batch)
    x = adapter.embed(student, batch)
    total = 0.0
    for n in range(adapter.num_layers):
        x = adapter.apply_layer(n, adapter.layer_params(student, n), x)
        total += float(frobenius_distance(x, acts[n]))
    return total


def profiled_iteration(tag: str, pruner, params) -> dict:
    """One layer-wise iteration (a fresh ``run_layerwise`` of 1): the
    device busy share under torch.profiler (device activity only),
    started by the fault hook and stopped by the callback so it holds that
    iteration alone; then, in another such run, its wall split by phase
    (a synchronize around each phase): the teacher pass, the per-layer
    primal steps and the projection + dual steps (the rest: the student's
    forward and the residuals)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    # the device's kernels only: the host side of ~30 k launches would
    # take the profiler longer to digest than the iteration takes
    prof = trace(activities=[ProfilerActivity.CUDA])
    mark = {}

    def start(it, p, av):
        torch.cuda.synchronize()
        prof.start()
        mark["t0"] = time.perf_counter()

    def stop(it, metrics):
        torch.cuda.synchronize()
        mark["wall"] = time.perf_counter() - mark["t0"]
        prof.stop()

    pruner.run_layerwise(as_key(2), params, iterations=1, fault_hook=start,
                         callback=stop)
    wall = mark["wall"]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]

    clock = dict.fromkeys(("teacher", "primal", "project_dual"), 0.0)

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            clock[name] += time.perf_counter() - t
            return out
        return run

    saved = (admm_mod.primal_step, admm_mod.proximal_step, admm_mod.dual_step)
    admm_mod.primal_step = timed("primal", saved[0])
    admm_mod.proximal_step = timed("project_dual", saved[1])
    admm_mod.dual_step = timed("project_dual", saved[2])
    pruner.teacher_acts = timed("teacher", pruner.teacher_acts)
    try:
        pruner.run_layerwise(as_key(2), params, iterations=1,
                             fault_hook=start, callback=stop)
    finally:
        admm_mod.primal_step, admm_mod.proximal_step, admm_mod.dual_step = (
            saved)
        del pruner.teacher_acts
    idle = [k for k, v in clock.items() if not v]
    if idle:
        fail(f"[{tag}] the split timed no call of {idle}: admm_iteration no "
             f"longer calls the names this function wraps")
    split = dict(clock, rest=mark["wall"] - sum(clock.values()))
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_device_ms": {e.key[:50]: e.self_device_time_total / 1e3
                              for e in top},
            "split_wall_s": mark["wall"], "split_s": split}


def admm_serve(tag: str, model, art) -> dict:
    """The main path: the ADMM-pruned artifact packed, bound and served by
    the launcher's engine (CUDA graphs); counts zeroed around the served
    run. Every flash call on wgmma, no blockwise fallback, pattern_gemm
    launched."""
    cfg = model.config
    g = torch.Generator().manual_seed(3)
    reqs = [Request(uid=i, prompt=torch.randint(
        0, cfg.vocab_size, (ADMM_SERVE["prompt"],), generator=g),
        max_new_tokens=ADMM_SERVE["new"])
        for i in range(ADMM_SERVE["requests"])]
    eng = launch_serve.make_engine(
        model, art, batch=4, packed=True,
        max_seq=ADMM_SERVE["prompt"] + ADMM_SERVE["new"])
    eng.generate(reqs[:1])                         # captures the graphs
    torch.cuda.synchronize()
    reset_launches()                               # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(("pattern_gemm", "flash_attention"))
    routes = dict(fa_mod.ROUTE_LAUNCHES,
                  blockwise_fallbacks=attention.PREFILL_FALLBACKS)
    print(f"[{tag}] served {len(reqs)} requests x {ADMM_SERVE['prompt']} "
          f"prompt tokens x {ADMM_SERVE['new']} new in {wall * 1e3:.1f} ms; "
          f"launches {json.dumps(launches)}; prefill attention by route "
          f"{json.dumps(routes)}", flush=True)
    if (launches["flash_attention"] == 0 or routes["wgmma"]
            != launches["flash_attention"] or routes["blockwise_fallbacks"]):
        fail(f"[{tag}] served prefill off flash's wgmma route: {routes}")
    if launches["pattern_gemm"] == 0:
        fail(f"[{tag}] pattern_gemm never launched: {launches}")
    for r in results:
        if len(r.tokens) != ADMM_SERVE["new"] or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"[{tag}] request {r.uid}: bad tokens {r.tokens[:8]}")
    return launches


def moved_from_greedy(tag: str, what: str, pruned, teacher, pcfg, *,
                      gate: bool = True) -> None:
    """Layer-wise fp32 ADMM moves the weights before its last projection
    (from layer 1 on, the student's input is the pruned student's
    output), so with ``gate`` some pruned leaf must differ from the
    greedy (magnitude) projection of the teacher; if none does, the
    primal steps did nothing. Whole-model ADMM starts at the teacher,
    where the distillation gradient is 0 and rho's pull is below fp32's
    resolution for its first iterations: a reading there."""
    greedy = greedy_prune(teacher, pcfg, device=DEV)
    want = dict(tree_items(greedy.params))
    pruned_paths = [p for p, m in tree_items(greedy.masks) if m is not None]
    got = dict(tree_items(pruned))
    moved = sum(not torch.equal(got[p], want[p]) for p in pruned_paths)
    print(f"[{tag}] {what}: {moved} of {len(pruned_paths)} pruned leaves "
          f"differ from the greedy projection of the teacher", flush=True)
    if gate and not moved:
        fail(f"[{tag}] {what}: the primal steps moved no weight")


def kill_and_resume(tag: str, model, params) -> None:
    """4 iterations, a checkpoint every 2: a run stopped by its callback
    after iteration 2 and resumed must end bit-equal (params, Z, U, key,
    history) to an uninterrupted run (which checkpoints its final step
    only), whose weights moved (fp32)."""
    import filecmp

    pcfg = prune_config_for(scheme="tile_pattern", rate=2, iters=4,
                            batch=ADMM_BATCH)

    def stop(it, metrics):
        if it == 1:
            raise Stop

    with tempfile.TemporaryDirectory(prefix="admm-ckpt-") as d:
        def run(sub, save_every=2, **kw):
            pr = PrivacyPreservingPruner(LMAdapter(model, seq_len=ADMM_SEQ),
                                         pcfg)
            return pr.run(as_key(1), params, save_every=save_every,
                          checkpoint_dir=os.path.join(d, sub), **kw)

        t0 = time.perf_counter()
        whole = run("a", save_every=4)      # only the step compared
        t_run = time.perf_counter() - t0
        try:
            run("b", callback=stop)
            fail(f"[{tag}] the stopping callback did not stop the run")
        except Stop:
            pass
        resumed = run("b", resume=True)
        secs = time.perf_counter() - t0
        # the final steps' leaf files, byte for byte, and their extras
        final = [os.path.join(d, sub, "step_000000004") for sub in "ab"]
        files = sorted(f for f in os.listdir(final[0]) if f.endswith(".npy"))
        extras = [json.load(open(os.path.join(f, "manifest.json")))["extra"]
                  for f in final]
        same = (files == sorted(f for f in os.listdir(final[1])
                                if f.endswith(".npy"))
                and all(filecmp.cmp(os.path.join(final[0], f),
                                    os.path.join(final[1], f), shallow=False)
                        for f in files)
                and extras[0] == extras[1]
                and whole.history == resumed.history)
        size = disk_bytes(final[0])
    print(f"[{tag}] kill after iteration 2 and resume (4 iterations, "
          f"checkpoint every 2, {size} bytes a step): params, Z, U, key and "
          f"history bit-equal to the uninterrupted run: {same} "
          f"({len(files)} leaf files; 3 runs {secs:.1f} s, the "
          f"uninterrupted one {t_run:.1f} s)", flush=True)
    if not same:
        fail(f"[{tag}] the resumed run differs from the uninterrupted one")
    moved_from_greedy(tag, "layer-wise, 4 iterations", whole.params, params,
                      pcfg)
    batch = LMAdapter(model, seq_len=ADMM_SEQ).synthetic_batch(
        torch.Generator(device=DEV).manual_seed(9), ADMM_BATCH)
    pruner = PrivacyPreservingPruner(LMAdapter(model, seq_len=ADMM_SEQ),
                                     pcfg)
    d_admm = layerwise_distance(pruner, params, whole.params, batch)
    d_greedy = layerwise_distance(
        pruner, params, greedy_prune(params, pcfg, device=DEV).params, batch)
    print(f"[{tag}] fp32, {model.config.num_layers} layers: layer-wise "
          f"distillation loss on one synthetic batch ADMM {d_admm:.6g}, "
          f"greedy magnitude {d_greedy:.6g} (a reading, not a gate)",
          flush=True)


def launcher_pair(tag: str) -> None:
    """``launch.prune --reduced`` then ``launch.serve --reduced --artifact
    --packed`` as subprocesses on the card: both exit 0, and the reduced
    config's head_dim 16 prefills on flash's SIMT route, with no blockwise
    fallback."""
    env = port_env()
    with tempfile.TemporaryDirectory(prefix="admm-launch-") as d:
        art = os.path.join(d, "artifact")
        cmds = (["repro_torch.launch.prune", "--arch", "qwen2-1.5b",
                 "--reduced", "--scheme", "tile_pattern", "--rate", "2",
                 "--tile-block", "32", "--iters", "2", "--out",
                 os.path.join(d, "out"), "--artifact-out", art],
                ["repro_torch.launch.serve", "--arch", "qwen2-1.5b",
                 "--reduced", "--artifact", art, "--packed", "--requests",
                 "2", "--max-new", "6"])
        outs = []
        for cmd in cmds:
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", *cmd], env=env,
                                 capture_output=True, text=True,
                                 timeout=300)
            print(f"[{tag}] python -m {' '.join(cmd[:1])} --reduced: exit "
                  f"{out.returncode} in {time.perf_counter() - t0:.1f} s; "
                  f"{out.stdout.strip().splitlines()[-2:]}", flush=True)
            if out.returncode != 0:
                fail(f"[{tag}] {cmd[0]} failed: {out.stderr[-3000:]}")
            outs.append(out.stdout)
    line = [ln for ln in outs[1].splitlines()
            if ln.startswith("prefill attention {")]
    routes = json.loads(line[0][line[0].index("{"):]) if line else {}
    if routes.get("blockwise_fallbacks", 1) or not routes.get(
            "flash", {}).get("simt"):
        fail(f"[{tag}] the reduced serve did not prefill on flash's SIMT "
             f"route: {routes}")


def phase_admm(smi: str) -> dict:
    """qwen2-1.5b at full width pruned by layer-wise ADMM on synthetic
    tokens, served packed; then at ``ADMM_SHORT_LAYERS`` layers the
    whole-model formulation, kill and resume, and the launcher pair.
    Returns the served run's launch counts."""
    tag = "admm"
    t_phase = time.perf_counter()

    def lap(what):
        print(f"[{tag}] {what} done at {time.perf_counter() - t_phase:.1f} "
              f"s into the phase", flush=True)

    cfg = get_config("qwen2-1.5b")
    model = LM(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    pcfg = prune_config_for(scheme="tile_pattern", rate=2, iters=ADMM_ITERS,
                            batch=ADMM_BATCH)
    pruner = PrivacyPreservingPruner(LMAdapter(model, seq_len=ADMM_SEQ), pcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = [time.perf_counter()]

    def report(it, m):
        stamps.append(time.perf_counter())
        print(f"[{tag}] iteration {it}: loss {m['loss']:.6g} primal "
              f"residual {m['residual']:.6g} dual residual "
              f"{m['dual_residual']:.6g} rho {m['rho']:.3g} "
              f"({stamps[-1] - stamps[-2]:.3f} s)", flush=True)

    result = pruner.run_layerwise(as_key(1), params, callback=report)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    per_iter = [b - a for a, b in zip(stamps, stamps[1:])]
    med = statistics.median(per_iter[-6:])
    finite_history(tag, result.history)
    print(f"[{tag}] qwen2-1.5b L={cfg.num_layers} d_model={cfg.d_model} "
          f"{cfg.param_dtype}, layer-wise ADMM tile_pattern 4 of 8 "
          f"(block_p 128), batch {ADMM_BATCH} x {ADMM_SEQ} synthetic tokens, "
          f"{ADMM_ITERS} iterations: {med:.4f} s per iteration (median of "
          f"the last 6; each {json.dumps(per_iter)}); "
          f"peak device memory {peak} bytes ({smi})", flush=True)
    lap("8 iterations")
    split = profiled_iteration(tag, pruner, params)
    print(f"[{tag}] one iteration: device busy {split['device_busy_s']:.4f}"
          f" of {split['profiled_wall_s']:.4f} s profiled "
          f"({100 * split['busy_share']:.1f}%); " + json.dumps(split),
          flush=True)

    art = result.to_artifact(arch="qwen2-1.5b", scheme="tile_pattern",
                             rate=2.0)
    n_leaves = lanes_exact(tag, art)
    if (art.privacy or {}).get("data") != "synthetic":
        fail(f"[{tag}] manifest privacy block {art.privacy}")
    print(f"[{tag}] {n_leaves} pruned leaves keep exactly 4 of every 8 "
          f"lanes per tile; manifest privacy {json.dumps(art.privacy)}",
          flush=True)
    batch = pruner.adapter.synthetic_batch(
        torch.Generator(device=DEV).manual_seed(9), ADMM_BATCH)
    greedy = greedy_prune(params, pcfg, device=DEV)
    d_admm = layerwise_distance(pruner, params, result.params, batch)
    d_greedy = layerwise_distance(pruner, params, greedy.params, batch)
    print(f"[{tag}] layer-wise distillation loss on one synthetic batch "
          f"(summed over {cfg.num_layers} layers): ADMM {d_admm:.6g}, greedy "
          f"magnitude {d_greedy:.6g} (a reading, not a gate)", flush=True)
    del greedy
    lap("profiled iterations, gates, greedy reading")
    art = art.pack(device=DEV)
    check_exact(tag, art)
    launches = admm_serve(tag, model, art)
    lap("pack and serve")
    del art, result, pruner
    torch.cuda.empty_cache()

    # fp32 params: the primal steps' updates survive the rounding back to
    # the param dtype (in bf16 they round to the weights they started at)
    cfg4 = dataclasses.replace(cfg, num_layers=ADMM_SHORT_LAYERS,
                               param_dtype="float32")
    model4 = LM(cfg4, device=DEV)
    params4 = model4.init(torch.Generator(device=DEV).manual_seed(0))
    whole_cfg = prune_config_for(scheme="tile_pattern", rate=2, iters=2,
                                 batch=ADMM_BATCH, layerwise=False)
    t0 = time.perf_counter()
    whole = PrivacyPreservingPruner(LMAdapter(model4, seq_len=ADMM_SEQ),
                                    whole_cfg).run(as_key(1), params4)
    finite_history(tag, whole.history)
    print(f"[{tag}] whole-model ADMM (problem 2) at {ADMM_SHORT_LAYERS} "
          f"layers fp32, 2 iterations in {time.perf_counter() - t0:.2f} s: "
          f"{json.dumps(whole.history)}", flush=True)
    moved_from_greedy(tag, "whole-model, 2 iterations", whole.params,
                      params4, whole_cfg, gate=False)
    del whole
    kill_and_resume(tag, model4, params4)
    del model4, params4
    torch.cuda.empty_cache()
    lap(f"{ADMM_SHORT_LAYERS}-layer whole-model and kill-and-resume")
    launcher_pair(tag)
    return launches


def phase_admm_cnn(smi: str) -> int:
    """VGG-16 at full width (ImageNet head, 224 x 224) pruned by layer-wise
    ADMM ``pattern_shared`` on synthetic images, retrained with masks on
    the client's pipeline, packed: one bf16 forward (counts zeroed around
    it) and the fp32 top-1 gate of ``[cnn]``. Returns its pattern_conv
    launches."""
    tag = "admm_cnn"
    kw = ADMM_VGG
    model = vgg16(**kw, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    iters = ADMM_CNN["iters"]
    pcfg = PruneConfig(scheme="pattern_shared", alpha=0.25, iterations=iters,
                       batch_size=ADMM_CNN["batch"], lr=1e-3,
                       rho_every_iters=max(iters // 3, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = [time.perf_counter()]

    def report(it, m):
        stamps.append(time.perf_counter())
        print(f"[{tag}] iteration {it}: loss {m['loss']:.6g} primal "
              f"residual {m['residual']:.6g} dual residual "
              f"{m['dual_residual']:.6g} ({stamps[-1] - stamps[-2]:.3f} s)",
              flush=True)

    result = PrivacyPreservingPruner(model, pcfg).run_layerwise(
        as_key(1), params, callback=report)
    finite_history(tag, result.history)
    admm_s = [b - a for a, b in zip(stamps[1:], stamps[2:])]
    admm_peak = torch.cuda.max_memory_allocated()
    moved_from_greedy(tag, f"layer-wise, {iters} iterations", result.params,
                      params, pcfg)
    del params

    data = ClassificationPipeline(DataConfig(
        global_batch=ADMM_CNN["batch"],
        num_classes=ADMM_CNN["retrain_classes"],
        image_hwc=kw["image_hwc"]), device=DEV)
    masks = result.masks
    opt = adamw(ADMM_CNN["retrain_lr"])
    step = make_retrain_step(model.apply, cross_entropy, opt, masks)
    p, state = result.params, opt.init(result.params)
    losses, times = [], []
    for i in range(ADMM_CNN["retrain_steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, loss = step(p, state, data.batch_at(i))
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    zeros = all(bool((w[m == 0] == 0).all()) for w, m in zip(
        tree_leaves(tree_map(lambda w, m: None if m is None else w, p,
                             masks)),
        tree_leaves(masks)))
    print(f"[{tag}] VGG-16 {kw['image_hwc']} fp32, layer-wise ADMM "
          f"pattern_shared alpha 0.25, batch {ADMM_CNN['batch']}: "
          f"{statistics.median(admm_s):.4f} s per iteration (median of "
          f"{len(admm_s)} after the first); {ADMM_CNN['retrain_steps']} "
          f"masked AdamW steps: {statistics.median(times[1:]):.4f} s per "
          f"step (median after the first), labels of "
          f"{ADMM_CNN['retrain_classes']} classes, loss by step "
          f"{json.dumps([round(x, 5) for x in losses])}; masked-out weights still exactly 0: {zeros}; "
          f"peak device memory ADMM {admm_peak}, retrain {peak} bytes "
          f"({smi})", flush=True)
    if not zeros or not all(math.isfinite(x) for x in losses):
        fail(f"[{tag}] retraining broke the mask or diverged: {losses}")
    if statistics.mean(losses[-3:]) > losses[0] - 0.01:
        fail(f"[{tag}] retraining did not lower the loss by 0.01: {losses}")
    retrained = result.to_artifact(arch="vgg16").with_params(p)
    del result, state, data
    torch.cuda.empty_cache()

    bf16 = vgg16(**kw, param_dtype="bfloat16", device=DEV)
    art = retrained.with_params(tree_map(
        lambda w: w.to(torch.bfloat16), p)).pack(device=DEV)
    check_exact(tag, art)
    tree = art.bind(bf16, packed=True)
    want_routes = conv_routes(tree)
    x = bf16.synthetic_batch(torch.Generator(device=DEV).manual_seed(1),
                             ADMM_CNN["batch"])
    bf16.apply(tree, x)                                # warm-up
    torch.cuda.synchronize()
    reset_launches()                                   # the main path
    logits = bf16.apply(tree, x)
    torch.cuda.synchronize()
    launches, routes = pc_mod.LAUNCHES, dict(pc_mod.ROUTE_LAUNCHES)
    print(f"[{tag}] packed bf16 forward: pattern_conv launches {launches} "
          f"(want 13; by route {json.dumps(routes)}, want "
          f"{json.dumps(want_routes)})", flush=True)
    if launches != 13 or routes != want_routes or not bool(
            torch.isfinite(logits).all()):
        fail(f"[{tag}] packed forward: {launches} launches, {routes}")
    del art, tree, logits
    torch.cuda.empty_cache()

    x = x.to(torch.float32)
    dense = model.apply(retrained.bind(model, packed=False), x)
    packed = model.apply(retrained.pack(device=DEV).bind(model, packed=True),
                         x)
    diff = (dense - packed).abs().max().item()
    top2 = torch.topk(dense, 2, dim=1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
    same = bool((dense.argmax(1) == packed.argmax(1))[sure].all())
    print(f"[{tag}] fp32 retrained dense-pruned (F.conv2d, no TF32) vs "
          f"packed: max |logit diff| {diff:.3e}; top-1 identical on the "
          f"{int(sure.sum())} of {ADMM_CNN['batch']} images whose dense "
          f"top-2 gap exceeds twice that: {same}", flush=True)
    if not same or not bool(torch.isfinite(packed).all()):
        fail(f"[{tag}] fp32 packed top-1 differs from dense-pruned")
    return launches


# ------------------------------------- the privacy-preserving pruning service

PIPE_LM_LAYERS = 2        # the LM arm at full width, 2 of 28 layers
PIPE_SERVE = dict(requests=4, prompt=128, new=16)
# the reference's gate on the MIA report (benchmarks/check_regression.py):
# synthetic-data pruning leaks no more than real-data pruning (+0.05) or the
# dense model (+0.15); here a reading, not a gate
MIA_LIMITS = {"auc_delta_vs_real": 0.05, "auc_delta_vs_dense": 0.15}


def run_pipeline(tag: str, arch: str, out: str, *extra: str,
                 restored: int = 0) -> list:
    """``launch.pipeline.main`` in process at full scale with the quick
    budgets and no stage retries (a fault fails the phase, it is not
    retried away); its stages read back from progress.json, each run once
    but the first ``restored`` (restored from disk: 0 attempts)."""
    argv = ["--arch", arch, "--quick", "--out", out, "--device", DEV,
            "--bench-path", os.path.join(out, "bench.json"),
            "--stage-retries", "0", *extra]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = launch_pipeline.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = json.load(open(os.path.join(out, arch, "progress.json")))[
        "stages"]
    peaks = {g["labels"]["stage"]: g["value"] for g in json.load(open(
        os.path.join(out, arch, "telemetry.json")))["metrics"]["gauges"]
        if g["name"] == "pipeline.stage_peak_device_bytes"}
    print(f"[{tag}] pipeline {' '.join(argv[:3] + list(extra))}: exit {rc} "
          f"in {wall:.1f} s; stage (seconds, attempts) {json.dumps(
              {r['name']: (r['seconds'], r['attempts']) for r in stages})}; "
          f"peak device memory by stage {json.dumps(peaks)} bytes, max "
          f"{max(peaks.values(), default=0)}", flush=True)
    want = [("ok", 0)] * restored + [("ok", 1)] * (6 - restored)
    if rc != 0 or [(r["status"], r["attempts"]) for r in stages] != want:
        fail(f"[{tag}] pipeline failed: exit {rc}, stages {stages}")
    return stages


def mia_readings(tag: str, out: str, arch: str) -> None:
    """The three MIA rows and the manifest's deltas beside the reference's
    limits (readings of seeded training: printed, not gated)."""
    rows = json.load(open(os.path.join(out, "bench.json")))
    for r in rows:
        print(f"[{tag}] MIA {r['arch']} {r['method']}: comp "
              f"{r['comp_rate']}x, AUC {r['mia_auc']} (95% CI "
              f"{r['mia_auc_ci']}), attack accuracy {r['mia_acc']}, shadow "
              f"AUC {r['mia_auc_shadow']} (CI {r['mia_auc_shadow_ci']}), "
              f"loss member {r['member_loss']} non-member "
              f"{r['nonmember_loss']} gap {r['loss_gap']} "
              f"(n {r['n_member']}/{r['n_nonmember']})", flush=True)
    doc = json.load(open(os.path.join(out, arch, "artifact",
                                      "artifact.json")))
    priv = doc["meta"]["privacy"]
    deltas = {k: (priv["mia"][k], f"limit {v}") for k, v in
              MIA_LIMITS.items()}
    print(f"[{tag}] manifest privacy: data {priv['data']}, method "
          f"{priv['method']}, retrained_on {priv['retrained_on']}, pipeline "
          f"{priv['pipeline']}; deltas (reading) {json.dumps(deltas)}",
          flush=True)
    if (priv["data"], priv["retrained_on"]) != ("synthetic",
                                                "client_confidential"):
        fail(f"[{tag}] manifest privacy block wrong: {priv}")


def params_bit_equal(a_dir: str, b_dir: str) -> bool:
    a = dict(tree_items(load_pytree(os.path.join(a_dir, "params"),
                                    device="cpu")))
    b = dict(tree_items(load_pytree(os.path.join(b_dir, "params"),
                                    device="cpu")))
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def pipeline_cnn(tag: str, out: str) -> int:
    """VGG-16 at full width through the service; the saved artifact loaded
    (every CRC32 checked), one packed bf16 forward (counts zeroed around
    it) and the fp32 top-1 gate. Returns its pattern_conv launches."""
    run_pipeline(tag, "vgg16", out)
    mia_readings(tag, out, "vgg16")
    art_dir = os.path.join(out, "vgg16", "artifact")
    t0 = time.perf_counter()
    art = PrunedArtifact.load(art_dir, device=DEV)
    disk = art.verify_integrity()["disk"]
    width, hwc = privacy_report.CNN_GEOMETRY[False]
    kw = dict(num_classes=10, width_mult=width, image_hwc=hwc, device=DEV)
    print(f"[{tag}] artifact loaded in {time.perf_counter() - t0:.2f} s, "
          f"CRC32 re-checked {json.dumps(disk)}; VGG-16 {hwc} width "
          f"{width}", flush=True)

    bf16 = vgg16(**kw, param_dtype="bfloat16")
    packed = art.with_params(tree_map(lambda w: w.to(torch.bfloat16),
                                      art.params)).pack(device=DEV)
    tree = packed.bind(bf16, packed=True)
    want_routes = conv_routes(tree)
    data = ClassificationPipeline(DataConfig(
        num_classes=10, global_batch=64, image_hwc=hwc, seed=7), noise=0.35,
        device=DEV)
    x, y = data.eval_batch()
    bf16.apply(tree, x.to(torch.bfloat16))             # warm-up
    torch.cuda.synchronize()
    reset_launches()                                   # the main path
    logits = bf16.apply(tree, x.to(torch.bfloat16))
    torch.cuda.synchronize()
    launches, routes = pc_mod.LAUNCHES, dict(pc_mod.ROUTE_LAUNCHES)
    print(f"[{tag}] packed bf16 forward of the loaded artifact: pattern_conv "
          f"launches {launches} (want 13; by route {json.dumps(routes)}, "
          f"want {json.dumps(want_routes)}); bind fallbacks "
          f"{packed.bind_report['fallbacks']}", flush=True)
    if (launches != 13 or routes != want_routes or packed.bind_report[
            "fallbacks"] or not bool(torch.isfinite(logits).all())):
        fail(f"[{tag}] packed forward: {launches} launches, {routes}")
    del packed, tree, logits, bf16

    model = vgg16(**kw)
    dense = model.apply(art.bind(model, packed=False), x)
    out32 = model.apply(art.bind(model, packed=True), x)
    diff = (dense - out32).abs().max().item()
    top2 = torch.topk(dense, 2, dim=1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
    same = bool((dense.argmax(1) == out32.argmax(1))[sure].all())
    acc = float((out32.argmax(1) == y).float().mean())
    print(f"[{tag}] fp32 loaded artifact dense-pruned (F.conv2d, no TF32) "
          f"vs packed: max |logit diff| {diff:.3e}; top-1 identical on the "
          f"{int(sure.sum())} of {len(y)} held-out images whose dense top-2 "
          f"gap exceeds twice that: {same}; their top-1 accuracy (reading) "
          f"{acc:.4f}; bind fallbacks {art.bind_report['fallbacks']}",
          flush=True)
    if not same or art.bind_report["fallbacks"] or not bool(
            torch.isfinite(out32).all()):
        fail(f"[{tag}] fp32 packed top-1 differs from dense-pruned")
    return launches


def pipeline_resume(tag: str, out: str, uninterrupted: str) -> None:
    """A run whose retrain fails once with no retries stops on a
    ``StageError`` naming ``retrain`` with teacher and prune on the ledger;
    ``--resume`` restores both (0 attempts) and saves params bit-equal to
    the uninterrupted run's."""
    real_make_ops = privacy_report.make_ops
    fails = [1]

    def make_ops(*args, **kw):
        ops = real_make_ops(*args, **kw)
        inner = ops.retrain

        def retrain(params, masks):
            if fails:
                fails.pop()
                raise RuntimeError("injected fault in retrain")
            return inner(params, masks)

        ops.retrain = retrain
        return ops

    privacy_report.make_ops = make_ops
    try:
        launch_pipeline.main(["--arch", "vgg16", "--quick", "--no-mia",
                              "--out", out, "--device", DEV,
                              "--stage-retries", "0"])
    except StageError as e:
        stopped = (e.stage, e.attempts)
    else:
        fail(f"[{tag}] the injected retrain fault did not stop the run")
    finally:
        privacy_report.make_ops = real_make_ops
    ledger = [(r["name"], r["status"]) for r in json.load(open(os.path.join(
        out, "vgg16", "progress.json")))["stages"]]
    print(f"[{tag}] retrain failed once with --stage-retries 0: StageError "
          f"{stopped}; ledger {ledger}", flush=True)
    if stopped != ("retrain", 1) or ledger != [
            ("teacher", "ok"), ("prune", "ok"), ("retrain", "failed")]:
        fail(f"[{tag}] stage failure not recorded: {stopped}, {ledger}")
    stages = run_pipeline(tag, "vgg16", out, "--no-mia", "--resume",
                          restored=2)
    restored = [(r["name"], r["attempts"]) for r in stages[:2]]
    same = params_bit_equal(os.path.join(out, "vgg16", "artifact"),
                            os.path.join(uninterrupted, "vgg16",
                                         "artifact"))
    print(f"[{tag}] --resume: restored {restored}; saved params bit-equal "
          f"to the uninterrupted run's: {same}", flush=True)
    if restored != [("teacher", 0), ("prune", 0)] or not same:
        fail(f"[{tag}] resume gate: restored {restored}, bit-equal {same}")


def pipeline_lm(tag: str, out: str) -> dict:
    """qwen2-1.5b at full width (``PIPE_LM_LAYERS`` layers) through the
    service; the saved artifact served through the CUDA graphs (counts
    zeroed around the served run; flash all on wgmma, no fallback), then
    fp32 dense-pruned vs packed greedy tokens. Returns the launch counts."""
    real_get_config = privacy_report.get_config
    privacy_report.get_config = lambda name: dataclasses.replace(
        real_get_config(name), num_layers=PIPE_LM_LAYERS)
    try:
        run_pipeline(tag, "qwen2-1.5b", out)
        cfg = privacy_report.get_config("qwen2-1.5b")
    finally:
        privacy_report.get_config = real_get_config
    mia_readings(tag, out, "qwen2-1.5b")
    art_dir = os.path.join(out, "qwen2-1.5b", "artifact")
    t0 = time.perf_counter()
    art = PrunedArtifact.load(art_dir, cfg=cfg, device=DEV)
    model = LM(cfg, device=DEV)
    print(f"[{tag}] qwen2-1.5b L={cfg.num_layers} d_model={cfg.d_model} "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim} d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab_size} {cfg.param_dtype} (cut: depth "
          f"{PIPE_LM_LAYERS} of {real_get_config('qwen2-1.5b').num_layers} "
          f"layers; widths as published): artifact loaded in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({art.summary()['packed_leaves']} packed leaves)", flush=True)
    g = torch.Generator().manual_seed(3)
    reqs = [Request(uid=i, prompt=torch.randint(
        0, cfg.vocab_size, (PIPE_SERVE["prompt"],), generator=g),
        max_new_tokens=PIPE_SERVE["new"])
        for i in range(PIPE_SERVE["requests"])]
    eng = launch_serve.make_engine(
        model, art, batch=4, packed=True,
        max_seq=PIPE_SERVE["prompt"] + PIPE_SERVE["new"])
    eng.generate(reqs[:1])                         # captures the graphs
    torch.cuda.synchronize()
    reset_launches()                               # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(("pattern_gemm", "flash_attention"))
    routes = dict(fa_mod.ROUTE_LAUNCHES,
                  blockwise_fallbacks=attention.PREFILL_FALLBACKS)
    print(f"[{tag}] served {len(reqs)} requests x {PIPE_SERVE['prompt']} "
          f"prompt tokens x {PIPE_SERVE['new']} new in {wall * 1e3:.1f} ms "
          f"(graphs); launches {json.dumps(launches)}; prefill attention by "
          f"route {json.dumps(routes)}; bind fallbacks "
          f"{eng.bind_report['fallbacks']}", flush=True)
    if (launches["flash_attention"] == 0 or routes["wgmma"]
            != launches["flash_attention"] or routes["blockwise_fallbacks"]):
        fail(f"[{tag}] served prefill off flash's wgmma route: {routes}")
    if launches["pattern_gemm"] == 0 or eng.bind_report["fallbacks"]:
        fail(f"[{tag}] pattern_gemm launches {launches}, fallbacks "
             f"{eng.bind_report['fallbacks']}")
    for r in results:
        if len(r.tokens) != PIPE_SERVE["new"] or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"[{tag}] request {r.uid}: bad tokens {r.tokens[:8]}")
    del eng, results
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    model32 = LM(cfg32, device=DEV)
    art32 = art.with_params(tree_map(lambda w: w.to(torch.float32),
                                     art.params)).pack(device=DEV)
    tokens = [[r.tokens for r in ServeEngine(
        model32, art32, packed=packed, batch_size=4,
        max_seq_len=PIPE_SERVE["prompt"] + PIPE_SERVE["new"]).generate(reqs)]
        for packed in (False, True)]
    same = tokens[0] == tokens[1]
    print(f"[{tag}] fp32 loaded artifact dense-pruned vs packed greedy "
          f"tokens identical: {same} ({sum(map(len, tokens[1]))} tokens)",
          flush=True)
    if not same:
        fail(f"[{tag}] fp32 packed tokens differ from dense-pruned")
    return launches


def phase_pipeline(smi: str) -> dict:
    """The service end to end: VGG-16 at full width with its MIA report,
    the retrain fault and ``--resume``, then qwen2-1.5b at full width (4
    layers). Returns the main paths' launch counts."""
    tag = "pipeline"
    print(f"[{tag}] {smi}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        conv = pipeline_cnn(tag, os.path.join(tmp, "cnn"))
        pipeline_resume(tag, os.path.join(tmp, "resume"),
                        os.path.join(tmp, "cnn"))
        torch.cuda.empty_cache()
        lm = pipeline_lm(tag, os.path.join(tmp, "lm"))
    return dict(lm, pattern_conv=conv)


# ------------------------------------------------------------- families

FAM = dict(batch=4, patches=1024, max_seq=1088, steps=32,   # pixtral (a)
           frames=8, frame_len=1500,                        # hubert (b)
           fp32_layers=4, artifact_layers=2, admm_layers=2)
GEMM_NAMES = ("pattern_gemm", "flash_attention")


def tile_pcfg_for(cfg) -> PruneConfig:
    """``TILE_PCFG``, the head left out where its width is no multiple of
    block_p 128: both packages' tile projection refuses such a head
    (hubert-xlarge's 504, granite-3-2b's 49 155), so it stays dense."""
    if cfg.vocab_size % 128 == 0:
        return TILE_PCFG
    return dataclasses.replace(TILE_PCFG, exclude=tuple(TILE_PCFG.exclude)
                               + (r"lm_head",))


def prune_by_layer(params: dict, pcfg) -> PrunedArtifact:
    """``greedy_prune`` one block at a time, each unpruned block dropped as
    soon as it is pruned, and no masks kept (serving reads none): the
    whole-tree call holds the unpruned tree, the pruned one and their bf16
    masks at once, 3 x 23.2 GB for pixtral-12b. Empties ``params``."""
    blocks = params.pop("blocks")
    rest = greedy_prune(params, pcfg, device=DEV)
    params.clear()
    pruned, specs = [], []
    for i in range(len(blocks)):
        one = greedy_prune({"blocks": [blocks[i]]}, pcfg, device=DEV)
        blocks[i] = None
        pruned.append(one.params["blocks"][0])
        specs.append(one.specs["blocks"][0])
    return PrunedArtifact(params={"blocks": pruned, **rest.params},
                          masks=None, specs={"blocks": specs, **rest.specs},
                          meta=rest.meta)


def launch_gate(tag: str, what: str, launches: dict, want: dict) -> None:
    """A main path's launches: each kernel exactly as often as ``want``
    says, every flash call on the wgmma route, no blockwise fallback."""
    routes = dict(fa_mod.ROUTE_LAUNCHES,
                  blockwise_fallbacks=attention.PREFILL_FALLBACKS)
    print(f"[{tag}] {what}: launches {json.dumps(launches)} (designed "
          f"{json.dumps(want)}); flash by route {json.dumps(routes)}",
          flush=True)
    if launches != want:
        fail(f"[{tag}] {what}: launches {launches}, designed {want}")
    if routes["wgmma"] != launches["flash_attention"] or \
            routes["blockwise_fallbacks"]:
        fail(f"[{tag}] {what}: flash off the wgmma route: {routes}")


def logits_bar(tag: str, what: str, got: torch.Tensor,
               want: torch.Tensor) -> float:
    """fp32 packed against dense-pruned logits: the same argmax at every
    position and ``allclose`` at 2e-5 -> max |difference|."""
    err = (got - want).abs().max().item()
    same = torch.equal(got.argmax(-1), want.argmax(-1))
    close = torch.allclose(got, want, rtol=TOL[torch.float32],
                           atol=TOL[torch.float32])
    if not (same and close and bool(torch.isfinite(got).all())):
        fail(f"[{tag}] fp32 {what}: argmax identical {same}, within 2e-5 "
             f"{close}, max |packed - dense-pruned| {err}")
    return err


def fp32_arm(cfg, layers: int, pcfg):
    """(model, packed params, dense-pruned params) at ``layers`` layers of
    full width in fp32."""
    cfg32 = dataclasses.replace(cfg, num_layers=layers, param_dtype="float32")
    model = LM(cfg32, device=DEV)
    art = greedy_prune(model.init(torch.Generator(device=DEV).manual_seed(
        0)), pcfg, device=DEV).pack(device=DEV)
    return model, art.bind(model, packed=True), art.params


def pixtral_main(tag: str, smi: str) -> dict:
    """(a) pixtral-12b at full width and depth, bf16: prune a layer at a
    time, pack, bind; the main path a 4 x 1 024 prefill on seeded patch
    embeddings, then 32 decode steps on seeded (4, 1, 5 120) embeddings,
    as the reference's dry run decodes; readings and profiles."""
    cfg = get_config("pixtral-12b")
    model = LM(cfg, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    dense_bytes = sum(nbytes(w) for _, w in tree_items(params))
    art = prune_by_layer(params, TILE_PCFG).pack(device=DEV)
    check_exact(tag, art)
    packed = art.bind(model, packed=True)
    packed_bytes = art.packed_bytes()
    del art                                  # the dense-pruned tree
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[{tag}] (a) pixtral-12b L={cfg.num_layers} d_model="
          f"{cfg.d_model} attn_dim={cfg.attn_dim} heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads} of {cfg.head_dim} d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab_size} {cfg.param_dtype}: init + prune by layer + "
          f"pack {t_setup:.2f} s; weight bytes dense {dense_bytes} packed "
          f"{packed_bytes} (lane-index tables included); peak device memory "
          f"while pruning and packing {peak_setup} bytes ({smi})",
          flush=True)
    g = torch.Generator(device=DEV).manual_seed(1)
    B, S, D = FAM["batch"], FAM["patches"], cfg.d_model
    x = torch.randn((B, S, D), generator=g, device=DEV).to(torch.bfloat16)
    steps = torch.randn((FAM["steps"], B, 1, D), generator=g,
                        device=DEV).to(torch.bfloat16)

    def main_path():
        cache, logits = model.prefill(packed, x, FAM["max_seq"])
        out = [logits]
        for e in steps:
            cache, logits = model.decode_step(packed, cache, e)
            out.append(logits)
        return out

    main_path()                                      # first use
    torch.cuda.synchronize()
    reset_launches()                                 # the main path
    out = main_path()
    torch.cuda.synchronize()
    launches = launch_counts(GEMM_NAMES)
    L = cfg.num_layers
    launch_gate(tag, f"(a) prefill {B} x {S} + {FAM['steps']} decode steps",
                launches, {"pattern_gemm": (1 + FAM["steps"]) * (7 * L + 1),
                           "flash_attention": L})
    logits = torch.stack([o[:, 0] for o in out])
    if logits.shape != (1 + FAM["steps"], B, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail(f"[{tag}] (a) logits {tuple(logits.shape)} not finite")
    prefill_ms = median_s(lambda: model.prefill(packed, x, FAM["max_seq"]))
    cache, _ = model.prefill(packed, x, FAM["max_seq"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e in steps:
        model.decode_step(packed, cache, e)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / FAM["steps"]
    profile(tag, f"(a) prefill {B} x {S}", lambda: model.prefill(
        packed, x, FAM["max_seq"]), names=GEMM_NAMES)
    cache, _ = model.prefill(packed, x, FAM["max_seq"])
    profile(tag, "(a) decode step", lambda: model.decode_step(
        packed, cache, steps[0]), names=("pattern_gemm",))
    print(f"[{tag}] (a) prefill {B} x {S} patch embeddings "
          f"{prefill_ms * 1e3:.2f} ms (eager, median of 3); decode {decode_ms * 1e3:.3f} ms a step "
          f"(eager, mean of {FAM['steps']}); peak device memory serving "
          f"{torch.cuda.max_memory_allocated()} bytes ({smi})", flush=True)
    del packed, cache, out
    torch.cuda.empty_cache()
    return launches


def pixtral_checks(tag: str) -> None:
    """(a) the fp32 bar at 4 of 40 layers (packed against dense-pruned:
    the same argmax at the prefill and every decode step, logits within
    2e-5) and the artifact round trip at 2 of 40 layers."""
    cfg = get_config("pixtral-12b")
    model, packed, dense = fp32_arm(cfg, FAM["fp32_layers"], TILE_PCFG)
    g = torch.Generator(device=DEV).manual_seed(1)
    B, S, D = FAM["batch"], FAM["patches"], cfg.d_model
    x = torch.randn((B, S, D), generator=g, device=DEV)
    steps = torch.randn((FAM["steps"], B, 1, D), generator=g, device=DEV)
    cd, ld = model.prefill(dense, x, FAM["max_seq"])
    cp, lp = model.prefill(packed, x, FAM["max_seq"])
    errs = [logits_bar(tag, "(a) prefill", lp, ld)]
    for i, e in enumerate(steps):
        ld = model.decode_step(dense, cd, e)[1]
        lp = model.decode_step(packed, cp, e)[1]
        errs.append(logits_bar(tag, f"(a) decode step {i}", lp, ld))
    print(f"[{tag}] (a) fp32, {FAM['fp32_layers']} of {cfg.num_layers} "
          f"layers at full width: packed argmax identical to dense-pruned "
          f"at the prefill and all {FAM['steps']} decode steps, max |logit "
          f"difference| {max(errs):.3g} (2e-5)", flush=True)
    del model, packed, dense, cd, cp
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, num_layers=FAM["artifact_layers"])
    model2 = LM(cfg2, device=DEV)
    art = greedy_prune(model2.init(torch.Generator(device=DEV).manual_seed(
        0)), TILE_PCFG, device=DEV).pack(device=DEV)
    loaded = save_and_load(tag, art, cfg2)
    if "embed" in loaded.params or "embed" in loaded.packed:
        fail(f"[{tag}] the artifact grew an embed leaf")
    print(f"[{tag}] (a) artifact at {FAM['artifact_layers']} of "
          f"{cfg.num_layers} layers: no embed leaf, every leaf bit-equal "
          f"after the round trip", flush=True)
    del art, loaded
    torch.cuda.empty_cache()


def hubert_main(tag: str, smi: str) -> dict:
    """(b) hubert-xlarge at full width and depth, bf16: pruned and packed
    (its 504-wide head dense), one encoder forward (``hidden_states`` with
    flash, then ``lm_logits``) on 8 x 1 500 seeded frame embeddings; then
    the fp32 bar at 4 of 48 layers."""
    cfg = get_config("hubert-xlarge")
    model = LM(cfg, device=DEV)
    pcfg = tile_pcfg_for(cfg)
    t0 = time.perf_counter()
    art = greedy_prune(model.init(torch.Generator(device=DEV).manual_seed(
        0)), pcfg, device=DEV).pack(device=DEV)
    check_exact(tag, art)
    packed = art.bind(model, packed=True)
    head = art.params["lm_head"]
    head_dense = not is_packed(packed["lm_head"]) and handler_for(
        "tile_pattern").pack(head, LayerSpec(scheme="tile_pattern",
                                             tile_block_p=128)) is None
    print(f"[{tag}] (b) hubert-xlarge L={cfg.num_layers} d_model="
          f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.head_dim} d_ff={cfg.d_ff} {cfg.ffn_type} causal="
          f"{cfg.causal}: init + prune + pack {time.perf_counter() - t0:.2f}"
          f" s; weight bytes dense {art.dense_bytes()} packed "
          f"{art.packed_bytes()}; lm_head {tuple(head.shape)} dense (504 % "
          f"128 = {cfg.vocab_size % 128}: the tile projection and packer "
          f"refuse it): {head_dense}", flush=True)
    if not head_dense:
        fail(f"[{tag}] (b) hubert's lm_head was packed")
    del art
    torch.cuda.empty_cache()
    g = torch.Generator(device=DEV).manual_seed(2)
    x = torch.randn((FAM["frames"], FAM["frame_len"], cfg.d_model),
                    generator=g, device=DEV).to(torch.bfloat16)

    def forward():
        h, _ = model.hidden_states(packed, x, use_flash=True)
        return model.lm_logits(packed, h)

    forward()
    torch.cuda.synchronize()
    reset_launches()                                 # the main path
    logits = forward()
    torch.cuda.synchronize()
    launches = launch_counts(GEMM_NAMES)
    L = cfg.num_layers
    launch_gate(tag, f"(b) encoder forward {FAM['frames']} x "
                f"{FAM['frame_len']}", launches,
                {"pattern_gemm": 6 * L, "flash_attention": L})
    want = (FAM["frames"], FAM["frame_len"], cfg.vocab_size)
    if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
        fail(f"[{tag}] (b) logits {tuple(logits.shape)}, want {want}")
    ms = median_s(forward) * 1e3
    profile(tag, "(b) encoder forward", forward, names=GEMM_NAMES)
    print(f"[{tag}] (b) encoder forward of {FAM['frames']} x "
          f"{FAM['frame_len']} frames -> logits {want}: {ms:.2f} ms (median "
          f"of 3); peak device memory {torch.cuda.max_memory_allocated()} "
          f"bytes ({smi})", flush=True)
    del packed, logits
    torch.cuda.empty_cache()
    model4, packed4, dense4 = fp32_arm(cfg, FAM["fp32_layers"], pcfg)
    x32 = x.float()
    got = model4.lm_logits(packed4, model4.hidden_states(
        packed4, x32, use_flash=True)[0])
    want_l = model4.lm_logits(dense4, model4.hidden_states(
        dense4, x32, use_flash=True)[0])
    err = logits_bar(tag, "(b) encoder forward", got, want_l)
    print(f"[{tag}] (b) fp32, {FAM['fp32_layers']} of {L} layers at full "
          f"width: packed argmax identical to dense-pruned on every one of "
          f"{FAM['frames'] * FAM['frame_len']} frames, max |logit "
          f"difference| {err:.3g} (2e-5)", flush=True)
    return launches


def pixtral_admm(tag: str, smi: str) -> dict:
    """(c) the paper's algorithm on synthetic embeddings: pixtral-12b at
    full width, 2 of 40 layers, layer-wise ADMM at ``[admm]``'s settings
    on N(0, 1) embeddings; then packed, one 4 x 1 024 prefill."""
    cfg = dataclasses.replace(get_config("pixtral-12b"),
                              num_layers=FAM["admm_layers"])
    model = LM(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    adapter = LMAdapter(model, seq_len=ADMM_SEQ)
    if adapter.synthetic_kind != "normal_embeddings":
        fail(f"[{tag}] (c) the adapter draws {adapter.synthetic_kind}")
    pcfg = prune_config_for(scheme="tile_pattern", rate=2, iters=ADMM_ITERS,
                            batch=ADMM_BATCH)
    pruner = PrivacyPreservingPruner(adapter, pcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = [time.perf_counter()]
    result = pruner.run_layerwise(
        as_key(1), params, callback=lambda it, m: stamps.append(
            time.perf_counter()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    per_iter = [b - a for a, b in zip(stamps, stamps[1:])]
    finite_history(tag, result.history)
    split = profiled_iteration(tag, pruner, params)
    art = result.to_artifact(arch="pixtral-12b", scheme="tile_pattern",
                             rate=2.0)
    if (art.privacy or {}).get("generator") != "normal_embeddings":
        fail(f"[{tag}] (c) manifest privacy block {art.privacy}")
    print(f"[{tag}] (c) pixtral-12b {FAM['admm_layers']} of 40 layers at "
          f"full width, layer-wise ADMM tile_pattern 4 of 8, batch "
          f"{ADMM_BATCH} x {ADMM_SEQ} N(0, 1) embeddings, {ADMM_ITERS} "
          f"iterations: {statistics.median(per_iter[-6:]):.4f} s per "
          f"iteration (median of the last 6; each {json.dumps(per_iter)}); "
          f"one iteration's device busy share "
          f"{100 * split['busy_share']:.1f}% ({split['kernel_launches']} "
          f"launches); peak device memory {peak} bytes; manifest privacy "
          f"{json.dumps(art.privacy)} ({smi})", flush=True)
    art = art.pack(device=DEV)
    check_exact(tag, art)
    packed = art.bind(model, packed=True)
    x = torch.randn((FAM["batch"], FAM["patches"], cfg.d_model),
                    generator=torch.Generator(device=DEV).manual_seed(3),
                    device=DEV).to(torch.bfloat16)
    model.prefill(packed, x, FAM["max_seq"])
    torch.cuda.synchronize()
    reset_launches()                                 # the main path
    _, logits = model.prefill(packed, x, FAM["max_seq"])
    torch.cuda.synchronize()
    launches = launch_counts(GEMM_NAMES)
    L = cfg.num_layers
    launch_gate(tag, "(c) prefill of the ADMM-pruned model", launches,
                {"pattern_gemm": 7 * L + 1, "flash_attention": L})
    if not bool(torch.isfinite(logits).all()):
        fail(f"[{tag}] (c) prefill logits not finite")
    del pruner, result, art, packed, params
    torch.cuda.empty_cache()
    return launches


def served_family(tag: str, smi: str, name: str) -> dict:
    """(d) ``name`` at full width and depth, bf16, tile packed, served by
    the launcher's engine through its CUDA graphs as ``[serve]`` serves
    qwen2-1.5b (4 x 512 + 4 x 128 prompt tokens, 32 new): the main path
    with counts zeroed around it; prefill ms per chunk and decode ms per
    step from graph replays; then fp32 token identity at 4 layers."""
    cfg = get_config(name)
    model = LM(cfg, device=DEV)
    pcfg = tile_pcfg_for(cfg)
    t0 = time.perf_counter()
    art = greedy_prune(model.init(torch.Generator(device=DEV).manual_seed(
        0)), pcfg, device=DEV).pack(device=DEV)
    check_exact(tag, art)
    head = art.packed["lm_head"]
    print(f"[{tag}] (d) {name} L={cfg.num_layers} d_model={cfg.d_model} "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim} "
          f"vocab={cfg.vocab_size}: init + prune + pack "
          f"{time.perf_counter() - t0:.2f} s; weight bytes dense "
          f"{art.dense_bytes()} packed {art.packed_bytes()}; lm_head "
          f"{tuple(head.shape)} packed {is_packed(head)} (vocab % 128 = "
          f"{cfg.vocab_size % 128}); prefill flash route at S = 512: "
          f"{fa_mod.flash_variant(512, cfg.head_dim, torch.bfloat16)} (hd "
          f"{cfg.head_dim})", flush=True)
    if is_packed(head) != (cfg.vocab_size % 128 == 0):
        fail(f"[{tag}] (d) {name}'s lm_head packed {is_packed(head)}")
    reqs = make_requests(cfg.vocab_size)
    eng = launch_serve.make_engine(model, art, batch=4, max_seq=544,
                                   packed=True, device=DEV)
    for r in (reqs[0], reqs[4]):          # captures: decode, S = 512 and 128
        eng.generate([r])
    torch.cuda.synchronize()
    reset_launches()                                 # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(GEMM_NAMES)
    L = cfg.num_layers
    # two chunks, each a prefill and 31 decode steps (graph replays), each
    # forward 7 GEMMs a layer and the head where it is packed
    launch_gate(tag, f"(d) {name} generate(8 requests) in "
                f"{wall * 1e3:.1f} ms", launches,
                {"pattern_gemm": 2 * 32 * (7 * L + is_packed(head)),
                 "flash_attention": 2 * L})
    for r in results:
        if len(r.tokens) != 32 or not all(0 <= t < cfg.vocab_size
                                          for t in r.tokens):
            fail(f"[{tag}] (d) request {r.uid}: bad tokens {r.tokens[:8]}")
    readings = {}
    for S, chunk in ((128, reqs[4:]), (512, reqs[:4])):
        prompts, mask = eng.pad_prompts(chunk)
        eng.set_rows(chunk, mask)
        readings[f"prefill_graph_ms_S{S}"] = median_s(
            lambda: eng.prefill(prompts)) * 1e3
    tok0 = eng.prefill(prompts)[1].argmax(-1)
    readings["decode_graph_ms_per_step"] = median_s(
        lambda: eng.decode(tok0, 31)) * 1e3 / 31
    print(f"[{tag}] (d) {name}: " + json.dumps(readings) + f" ({smi})",
          flush=True)
    del eng, art
    torch.cuda.empty_cache()
    token_identity(tag, dataclasses.replace(
        cfg, num_layers=FAM["fp32_layers"], param_dtype="float32"), pcfg,
        note=f", {name} at {FAM['fp32_layers']} of {L} layers")
    return launches


def phase_families(smi: str) -> dict:
    """The embedding-input families and the two dense configs new to the
    card. Returns the main paths' launch counts, summed."""
    tag = "families"
    parts = (("(a) pixtral-12b", lambda: pixtral_main(tag, smi)),
             ("(a) pixtral-12b fp32 bar and artifact",
              lambda: pixtral_checks(tag) or {}),
             ("(b) hubert-xlarge", lambda: hubert_main(tag, smi)),
             ("(c) ADMM on synthetic embeddings",
              lambda: pixtral_admm(tag, smi)),
             ("(d) granite-3-2b",
              lambda: served_family(tag, smi, "granite-3-2b")),
             ("(d) phi4-mini-3.8b",
              lambda: served_family(tag, smi, "phi4-mini-3.8b")))
    total = dict.fromkeys(GEMM_NAMES, 0)
    for what, fn in parts:
        t0 = time.perf_counter()
        for k, v in fn().items():
            total[k] += v
        torch.cuda.empty_cache()
        print(f"[time] {tag} {what} {time.perf_counter() - t0:.1f} s",
              flush=True)
    return total


# ------------------------------------------------------------------- moe

# deepseek-moe-16b is served at 7 of its 28 layers (full width)
MOE = dict(fp32_layers=4, artifact_layers=2, admm_layers=2,
           cont_requests=6, split_steps=4, deepseek_layers=7)
MOE_EXPERTS = (r".*experts.*",)
MOE_NAMES = ("qwen2-moe-a2.7b", "deepseek-moe-16b")


def moe_pcfg(cfg) -> PruneConfig:
    """``tile_pcfg_for`` with the routed experts left out: both packages'
    final tile projection takes a layer's (E, D, F) expert leaf whole, as
    (E, D * F), and refuses it (E is no multiple of block_p); no scheme
    packs a 3-D leaf, so the experts stay dense."""
    base = tile_pcfg_for(cfg)
    return dataclasses.replace(base, exclude=tuple(base.exclude)
                               + MOE_EXPERTS)


def expert_ptrs(tree) -> dict:
    return {p: w.data_ptr() for p, w in tree_items(tree) if "/experts/" in p}


def moe_tile_refused(tag: str, cfg, params) -> None:
    """tile_pattern with the experts in, on one layer: the reference's
    ``ValueError``."""
    try:
        greedy_prune({"blocks": [params["blocks"][0]]}, tile_pcfg_for(cfg),
                     device=DEV)
    except ValueError as e:
        print(f"[{tag}] {cfg.name}: tile_pattern with the experts not "
              f"excluded raises, as the reference's: {e}", flush=True)
        return
    fail(f"[{tag}] {cfg.name}: tile_pattern pruned the expert leaves")


def moe_prepare(tag: str, smi: str, name: str, layers: int = 0):
    """``name`` at full width, at full depth or ``layers`` of it, bf16:
    init, prune a block at a time (tile 4 of 8, experts left out), pack.
    The expert leaves of the packed tree must be the init's tensors, not
    copies. -> (model, art)."""
    cfg = get_config(name)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = LM(cfg, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    dense_bytes = sum(nbytes(w) for _, w in tree_items(params))
    expert_bytes = sum(nbytes(w) for p, w in tree_items(params)
                       if "/experts/" in p)
    moe_tile_refused(tag, cfg, params)
    ptrs = expert_ptrs(params)
    art = prune_by_layer(params, moe_pcfg(cfg)).pack(device=DEV)
    check_exact(tag, art)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    shared = expert_ptrs(art.packed) == ptrs == expert_ptrs(art.params)
    head = art.packed["lm_head"]
    print(f"[{tag}] {name} L={cfg.num_layers} d_model={cfg.d_model} heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim} experts "
          f"{cfg.num_experts} (top-{cfg.moe_top_k}, width "
          f"{cfg.expert_d_ff}) + {cfg.num_shared_experts} shared, vocab "
          f"{cfg.vocab_size} {cfg.param_dtype}: init + prune by layer + "
          f"pack {t_setup:.2f} s; weight bytes dense {dense_bytes} (routed "
          f"experts {expert_bytes}) packed {art.packed_bytes()}; expert "
          f"leaves shared with the init, not copied: {shared} "
          f"({len(ptrs)} leaves); lm_head packed {is_packed(head)}; peak "
          f"device memory while pruning and packing "
          f"{torch.cuda.max_memory_allocated()} bytes ({smi})", flush=True)
    if not shared or not ptrs:
        fail(f"[{tag}] {name}: the expert leaves were copied")
    if not is_packed(head):
        fail(f"[{tag}] {name}: lm_head left dense")
    return model, art


def moe_decode_split(tag: str, smi: str, model, packed, cache,
                     tok) -> None:
    """Where one eager decode step's device time goes: torch.profiler
    kernels, attributed to the router and slot positions, the dispatch
    and combine einsums, the expert einsums and decode attention through
    ``record_function`` ranges wrapped around those functions for the
    trace, ``pattern_gemm`` by its kernels' names; the rest (norms,
    rope, cache inserts, residuals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as trace
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf_mod

    labels = {"route": [(moe_mod, "_route")],
              "dispatch/combine": [(moe_mod, "_dispatch"),
                                   (moe_mod, "_combine")],
              "experts": [(moe_mod, "_experts")],
              "attention": [(tf_mod, "decode_attention")]}
    saved = []

    def ranged(label, fn):
        def run(*a, **kw):
            with record_function(f"moe_split:{label}"):
                return fn(*a, **kw)
        return run

    for label, sites in labels.items():
        for mod, attr in sites:
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, ranged(label, getattr(mod, attr)))
    steps = MOE["split_steps"]
    start = cache["pos"].clone()
    try:
        model.decode_step(packed, cache, tok)              # first use
        cache["pos"].copy_(start)
        torch.cuda.synchronize()
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                cache["pos"].copy_(start)
                model.decode_step(packed, cache, tok)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("moe_split:")]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / steps
    split = {label: sum(e.device_time_total for e in events
                        if e.name == f"moe_split:{label}"
                        and e.device_type == DeviceType.CPU) / 1e3 / steps
             for label in labels}
    split["pattern_gemm"] = sum(
        e.device_time_total for e in kernels
        if re.search(TRACED_KERNEL["pattern_gemm"], e.name)) / 1e3 / steps
    split["rest"] = busy - sum(split.values())
    print(f"[{tag}] one eager decode step of {model.config.name}, profiled"
          f" ({steps} steps): wall {wall * 1e3:.2f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%), "
          f"{len(kernels) / steps:.0f} kernel launches; device ms by part "
          + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f" ({smi})", flush=True)


def moe_serve(tag: str, smi: str, model, art) -> dict:
    """The main path: the packed model through the launcher's engine
    (CUDA graphs, batch 4, ``max_seq_len`` 544): 4 x 512 + 4 x 128
    prompts, 32 new tokens; launch gate, graph against eager on the
    S = 512 chunk, prefill and decode graph readings, a profile of a
    decode replay and the split of an eager decode step."""
    cfg = model.config
    L = cfg.num_layers
    reqs = make_requests(cfg.vocab_size)
    eng = launch_serve.make_engine(model, art, batch=4, max_seq=544,
                                   packed=True, device=DEV)
    t0 = time.perf_counter()
    for r in (reqs[0], reqs[4]):          # captures: decode, S = 512 and 128
        eng.generate([r])
    torch.cuda.synchronize()
    t_cap = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                                 # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(GEMM_NAMES)
    # two chunks, each a prefill and 31 decode steps (graph replays), each
    # forward 7 packed GEMMs a layer (wq, wk, wv, wo and the shared
    # SwiGLU's three) and the head; the experts run as einsums
    launch_gate(tag, f"{cfg.name} generate(8 requests) in "
                f"{wall * 1e3:.1f} ms", launches,
                {"pattern_gemm": 2 * 32 * (7 * L + 1),
                 "flash_attention": 2 * L})
    for r in results:
        if len(r.tokens) != 32 or not all(0 <= t < cfg.vocab_size
                                          for t in r.tokens):
            fail(f"[{tag}] {cfg.name} request {r.uid}: bad tokens "
                 f"{r.tokens[:8]}")
    n_tok = sum(len(r.tokens) for r in results)
    readings = {"captures_s": t_cap, "generate_ms": wall * 1e3,
                "tok_s": n_tok / wall,
                "peak_bytes_serving": torch.cuda.max_memory_allocated()}
    chunk = reqs[:4]
    prompts, mask = eng.pad_prompts(chunk)
    eng.set_rows(chunk, mask)
    keys = fold_key_grid(eng.rows["keys"], torch.zeros_like(
        eng.rows["keys"]), 9)
    logits = eng.prefill(prompts)[1].clone()
    cache, want = model.prefill(eng.params, prompts, eng.max_seq_len)
    tok0 = eng.sample(logits, keys[0])
    toks = eng.decode(tok0, 8).clone()
    _, rest = model.decode_many(eng.params, cache, tok0, 8,
                                sampler=eng.sample, keys=keys[1:])
    same = (torch.equal(logits, want),
            torch.equal(toks, torch.cat([tok0, rest], dim=1)))
    print(f"[{tag}] {cfg.name} S=512 chunk, graph against eager: prefill "
          f"logits bit-identical {same[0]}, 8 decode tokens bit-identical "
          f"{same[1]}", flush=True)
    if not all(same):
        fail(f"[{tag}] {cfg.name}: the graphs disagree with the eager path")
    for S, ch in ((128, reqs[4:]), (512, reqs[:4])):
        prompts, mask = eng.pad_prompts(ch)
        eng.set_rows(ch, mask)
        readings[f"prefill_graph_ms_S{S}"] = median_s(
            lambda: eng.prefill(prompts)) * 1e3
    readings["decode_graph_ms_per_step"] = median_s(
        lambda: eng.decode(tok0, 31)) * 1e3 / 31
    readings["decode_graph_device_ms"] = timed_ms(
        eng.decode_graph.graph.replay, 10)
    print(f"[{tag}] {cfg.name}: " + json.dumps(readings) + f" ({smi})",
          flush=True)
    profile(tag, f"{cfg.name} decode step (graph replay)",
            lambda: eng.decode(tok0, 4), per=4, names=("pattern_gemm",))
    cache, _ = model.prefill(eng.params, prompts, eng.max_seq_len)
    moe_decode_split(tag, smi, model, eng.params, cache, tok0)
    del eng, cache
    torch.cuda.empty_cache()
    return launches


def moe_continuous(tag: str, smi: str, model, art) -> dict:
    """(b) the packed model through ``ContinuousEngine`` (``[continuous]``'s
    batch 4, ``max_seq_len`` 544, chunks of 8): requests of S 512 / 200 /
    64 submitted at once, counts zeroed around them; each bit-identical
    to its solo run through the same engine."""
    cfg = model.config
    L = cfg.num_layers
    g = torch.Generator().manual_seed(2)
    lens, new = CONT["lens"], CONT["new"]
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size,
                                                (lens[i % 3],), generator=g),
                    max_new_tokens=new[i % 3])
            for i in range(MOE["cont_requests"])]
    eng = continuous_engine(model, art)
    eng.generate(reqs[:len(lens)])               # captures each S, decode
    torch.cuda.synchronize()
    reset_launches()                                 # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(GEMM_NAMES)
    routes = {"pattern_gemm": dict(pg_mod.ROUTE_LAUNCHES),
              "flash_attention": dict(fa_mod.ROUTE_LAUNCHES),
              "blockwise_fallbacks": attention.PREFILL_FALLBACKS}
    st = eng.stats
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[{tag}] (b) {cfg.name} ContinuousEngine, {len(reqs)} requests "
          f"(prompt lengths {lens}, budgets {new}) at once: wall "
          f"{wall * 1e3:.1f} ms, {n_tok} tokens, {n_tok / wall:.1f} tok/s, "
          f"occupancy {st['occupancy']:.4f}, {st['chunks']} chunks; "
          f"launches {json.dumps(launches)} by route {json.dumps(routes)} "
          f"({smi})", flush=True)
    for r, q in zip(results, reqs):
        if r.status != "ok" or len(r.tokens) != q.max_new_tokens:
            fail(f"[{tag}] (b) request {r.uid}: {r.status}, "
                 f"{len(r.tokens)} tokens")
    if (launches["flash_attention"] != L * len(reqs)
            or routes["flash_attention"]["wgmma"] != L * len(reqs)
            or routes["blockwise_fallbacks"]):
        fail(f"[{tag}] (b) every admission must run flash on wgmma "
             f"({L} x {len(reqs)}): {routes}")
    if not (routes["pattern_gemm"]["skinny"]
            and routes["pattern_gemm"]["wgmma"]):
        fail(f"[{tag}] (b) pattern_gemm must launch on skinny and wgmma: "
             f"{routes['pattern_gemm']}")
    solo = [eng.generate([r])[0].tokens for r in reqs]
    same = [r.tokens == s for r, s in zip(results, solo)]
    print(f"[{tag}] (b) each request bit-identical to its solo run through "
          f"the same engine: {sum(same)}/{len(same)}", flush=True)
    if not all(same):
        fail(f"[{tag}] (b) continuous tokens depend on chunk-mates")
    del eng
    torch.cuda.empty_cache()
    return launches


def moe_speculative(tag: str, smi: str, model, art) -> dict:
    """(b) ``SpeculativeEngine`` at ``[speculative]``'s settings: the
    pruned weights bound dense verify, the artifact packed drafts (its
    attention, shared experts and head packed; the routed experts the
    same tensors as the target's); readings beside plain decoding; the
    round graph against eager."""
    cfg = model.config
    reqs = spec_requests(cfg.vocab_size)
    plain = plain_reading(tag, f"{cfg.name}, the pruned weights, dense",
                          smi, plain_engine(model, art), reqs)
    torch.cuda.empty_cache()
    eng = spec_engine(model, art, art)
    a = spec_arm(tag, f"(b) {cfg.name}, the pruned dense target, the "
                 "artifact packed drafts", smi, eng, reqs, plain,
                 expect_demoted=False)
    round_against_eager(tag, eng, reqs)
    del eng
    torch.cuda.empty_cache()
    return a["launches"]


def moe_fp32(tag: str) -> dict:
    """(d) each config at 4 layers of full width in fp32: packed greedy
    tokens equal the dense-pruned ones, and the continuous engine's equal
    ``ServeEngine(batch_size=1)``'s."""
    for name in MOE_NAMES:
        cfg = get_config(name)
        pcfg = moe_pcfg(cfg)
        token_identity(tag, dataclasses.replace(
            cfg, num_layers=MOE["fp32_layers"], param_dtype="float32"),
            pcfg, note=f", {name} at {MOE['fp32_layers']} of "
            f"{cfg.num_layers} layers")
        torch.cuda.empty_cache()
        continuous_fp32(tag, cfg, continuous_requests(cfg.vocab_size), pcfg)
        torch.cuda.empty_cache()
    return {}


def moe_artifact(tag: str, name: str) -> None:
    """(e) ``name`` at 2 layers of full width, bf16: saved, loaded back
    bit-equal (the expert leaves in the reference's stacked layout) and
    served to the in-memory artifact's tokens."""
    cfg = dataclasses.replace(get_config(name),
                              num_layers=MOE["artifact_layers"])
    model = LM(cfg, device=DEV)
    art = greedy_prune(model.init(torch.Generator(device=DEV).manual_seed(
        0)), moe_pcfg(cfg), device=DEV).pack(device=DEV)
    loaded = save_and_load(tag, art, cfg)
    reqs = make_requests(cfg.vocab_size)[4:]

    def served(a):
        eng = launch_serve.make_engine(model, a, batch=4, max_seq=544,
                                       packed=True, device=DEV)
        return [r.tokens for r in eng.generate(reqs)]

    same = served(loaded) == served(art)
    print(f"[{tag}] (e) {name} at {cfg.num_layers} layers: the loaded "
          f"artifact serves the in-memory artifact's tokens: {same}",
          flush=True)
    if not same:
        fail(f"[{tag}] (e) the loaded artifact serves other tokens")
    del art, loaded
    torch.cuda.empty_cache()


def moe_admm(tag: str, smi: str, name: str) -> dict:
    """(f) one layer-wise ADMM iteration (tile 4 of 8, experts left out)
    of ``name`` at 2 layers of full width, bf16, on uniform synthetic
    tokens at ``[admm]``'s batch: seconds, busy share, launches, peak;
    then packed and one prefill, launches gated."""
    cfg = dataclasses.replace(get_config(name),
                              num_layers=MOE["admm_layers"])
    model = LM(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    adapter = LMAdapter(model, seq_len=ADMM_SEQ)
    pcfg = prune_config_for(scheme="tile_pattern", rate=2, iters=1,
                            batch=ADMM_BATCH,
                            exclude=tuple(PruneConfig().exclude)
                            + MOE_EXPERTS)
    pruner = PrivacyPreservingPruner(adapter, pcfg)
    pruner.run_layerwise(as_key(1), params)              # first use
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = pruner.run_layerwise(as_key(1), params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    finite_history(tag, result.history)
    split = profiled_iteration(tag, pruner, params)
    print(f"[{tag}] (f) {name} {cfg.num_layers} of "
          f"{get_config(name).num_layers} layers at full width, layer-wise "
          f"ADMM tile_pattern 4 of 8 (experts left out), batch {ADMM_BATCH} "
          f"x {ADMM_SEQ} uniform synthetic tokens: {secs:.4f} s an "
          f"iteration; profiled: device busy share "
          f"{100 * split['busy_share']:.1f}%, {split['kernel_launches']} "
          f"launches, split (s) {json.dumps(split['split_s'])}; peak device "
          f"memory {peak} bytes ({smi})", flush=True)
    art = result.to_artifact(arch=name, scheme="tile_pattern",
                             rate=2.0).pack(device=DEV)
    check_exact(tag, art)
    packed = art.bind(model, packed=True)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128),
                           generator=torch.Generator().manual_seed(3)).to(DEV)
    model.prefill(packed, tokens, 160)
    torch.cuda.synchronize()
    reset_launches()                                 # the main path
    _, logits = model.prefill(packed, tokens, 160)
    torch.cuda.synchronize()
    launches = launch_counts(GEMM_NAMES)
    L = cfg.num_layers
    launch_gate(tag, "(f) prefill of the ADMM-pruned model", launches,
                {"pattern_gemm": 7 * L + 1, "flash_attention": L})
    if not bool(torch.isfinite(logits).all()):
        fail(f"[{tag}] (f) prefill logits not finite")
    del pruner, result, art, packed, params
    torch.cuda.empty_cache()
    return launches


def phase_moe(smi: str) -> dict:
    """The MoE family: (a) qwen2-moe-a2.7b at full width and depth and (c)
    deepseek-moe-16b at full width, 7 of 28 layers, served through the
    graphs, (b) qwen2-moe-a2.7b through
    the continuous and speculative engines, (d) the fp32 bars, (e) the
    artifact, (f) one ADMM iteration. Returns the main paths' launch
    counts, summed."""
    tag = "moe"
    total = dict.fromkeys(GEMM_NAMES, 0)
    held = {}

    def qwen_serve():
        held["model"], held["art"] = moe_prepare(tag, smi, MOE_NAMES[0])
        return moe_serve(tag, smi, held["model"], held["art"])

    def qwen_engines():
        out = moe_continuous(tag, smi, held["model"], held["art"])
        spec = moe_speculative(tag, smi, held["model"], held["art"])
        held.clear()
        return {k: out[k] + spec[k] for k in out}

    def deepseek_serve():
        model, art = moe_prepare(tag, smi, MOE_NAMES[1],
                                 layers=MOE["deepseek_layers"])
        return moe_serve(tag, smi, model, art)

    parts = (("(a) qwen2-moe-a2.7b", qwen_serve),
             ("(b) qwen2-moe-a2.7b continuous and speculative",
              qwen_engines),
             ("(c) deepseek-moe-16b", deepseek_serve),
             ("(d) fp32 bars", lambda: moe_fp32(tag)),
             ("(e) artifact", lambda: moe_artifact(tag, MOE_NAMES[0]) or {}),
             ("(f) ADMM", lambda: moe_admm(tag, smi, MOE_NAMES[0])))
    for what, fn in parts:
        t0 = time.perf_counter()
        for k, v in fn().items():
            total[k] += v
        torch.cuda.empty_cache()
        print(f"[time] {tag} {what} {time.perf_counter() - t0:.1f} s",
              flush=True)
    return total


# ---------------------------------------------------------------- [ssm]

# served at full width and cut in depth: hymba-1.5b 16 of 32 layers,
# xlstm-1.3b 16 of 48 blocks (2 of its 6 groups)
SSM = dict(batch=4, max_seq=544, new=32, wrap_prompt=2048, wrap_new=64,
           cont_requests=8, fp32_layers=4, admm_layers=2, hymba_layers=16,
           xlstm_layers=16)
SSM_NAMES = ("hymba-1.5b", "xlstm-1.3b")
HYMBA_EXCLUDE = (r".*mamba.*", r"lm_head")     # lm_head: 32 001 columns
XLSTM_EXCLUDE = (r".*mlstm.*", r".*slstm.*")


def ssm_pcfg(exclude: tuple, block_p: int) -> PruneConfig:
    """Greedy tile_pattern 4 of 8 at ``block_p`` with ``exclude`` added to
    the default exclusions: the cells take dense leaves only (both
    packages' forwards), and tile refuses the mamba leaves (w_bcdt has
    2N + 1 columns), a grouped mLSTM leaf ((per - 1, D * F)) and hymba's
    32 001-wide head."""
    return PruneConfig(scheme="tile_pattern",
                       exclude=tuple(PruneConfig().exclude) + exclude,
                       overrides={".*": {"tile_block_p": block_p,
                                         "tile_group_q": 8, "tile_keep": 4}})


HYMBA_PCFG = ssm_pcfg(HYMBA_EXCLUDE, HYMBA_BLOCK_P)
XLSTM_PCFG = ssm_pcfg(XLSTM_EXCLUDE, 128)


def tile_refused(tag: str, what: str, tree: dict, pcfg) -> None:
    """``greedy_prune`` of ``tree`` under ``pcfg`` raises the reference's
    ``ValueError``."""
    try:
        greedy_prune(tree, pcfg, device=DEV)
    except ValueError as e:
        print(f"[{tag}] {what}: tile_pattern raises, as the reference's: "
              f"{e}", flush=True)
        return
    fail(f"[{tag}] {what}: tile_pattern pruned a leaf the reference refuses")


def graph_ms(fn, reps: int = 3) -> float:
    """Device ms of one ``fn()`` captured alone in a CUDA graph, the mean
    of ``reps`` back-to-back replays between one CUDA event pair (warm
    L2, as in the call sequence it came from): its kernels without the
    host's launch gaps an eager call leaves on the device."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):                # warm-up off the capture
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def device_split(tag: str, smi: str, what: str, fn, fns: dict) -> dict:
    """Where ``fn``'s device time goes. One call under torch.profiler
    (device activity only): wall, busy share and kernel launches (an
    eager prefill's launches are the nodes its graph holds). The parts:
    each ``models.ssm`` function of ``fns`` (label -> name), counted over
    a first (warm-up) call, its first call replayed alone as a graph
    (``graph_ms``) times its calls; ``pattern_gemm`` and flash by their
    kernels' names in the trace; the rest beside them."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace
    from repro_torch.models import ssm as ssm_mod

    calls = {label: [] for label in fns}
    saved = {label: getattr(ssm_mod, name) for label, name in fns.items()}

    def recorded(label):
        def run(*a, **kw):
            calls[label].append((a, kw))
            return saved[label](*a, **kw)
        return run

    for label, name in fns.items():
        setattr(ssm_mod, name, recorded(label))
    try:
        fn()                                   # first use, counting calls
    finally:
        for label, name in fns.items():
            setattr(ssm_mod, name, saved[label])
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = {}
    for label, seen in calls.items():
        a, kw = seen[0]
        split[label] = graph_ms(lambda: saved[label](*a, **kw)) * len(seen)
    for name in ("pattern_gemm", "flash_attention"):
        split[name] = sum(e.self_device_time_total for e in kernels
                          if re.search(TRACED_KERNEL[name], e.key)) / 1e3
    split["rest"] = busy - sum(split.values())
    calls = {k: len(v) for k, v in calls.items()}
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
           "busy_share": busy / (wall * 1e3),
           "kernel_launches": sum(e.count for e in kernels),
           "calls": calls,
           "device_ms_by_part": {k: round(v, 3) for k, v in split.items()}}
    print(f"[{tag}] {what}, profiled: " + json.dumps(out) + f" ({smi})",
          flush=True)
    return out


def cache_bytes(cache: dict, keys=None) -> int:
    return sum(nbytes(t) for p, t in tree_items(cache)
               if keys is None or p.split("/")[0] in keys)


def graph_against_eager(tag: str, eng, chunk: list) -> None:
    """The engine's prefill graph logits and 8 decode-graph tokens against
    eager ``LM.prefill`` / ``decode_many`` on the same chunk, bit for
    bit."""
    model = eng.model
    prompts, mask = eng.pad_prompts(chunk)
    eng.set_rows(chunk, mask)
    keys = fold_key_grid(eng.rows["keys"], torch.zeros_like(
        eng.rows["keys"]), 9)
    logits = eng.prefill(prompts)[1].clone()
    cache, want = model.prefill(eng.params, prompts, eng.max_seq_len)
    tok0 = eng.sample(logits, keys[0])
    toks = eng.decode(tok0, 8).clone()
    _, rest = model.decode_many(eng.params, cache, tok0, 8,
                                sampler=eng.sample, keys=keys[1:])
    same = (torch.equal(logits, want),
            torch.equal(toks, torch.cat([tok0, rest], dim=1)))
    print(f"[{tag}] {model.config.name} S={prompts.shape[1]} chunk, graph "
          f"against eager: prefill logits bit-identical {same[0]}, 8 decode "
          f"tokens bit-identical {same[1]}", flush=True)
    if not all(same):
        fail(f"[{tag}] {model.config.name}: the graphs disagree with the "
             "eager path")


def ssm_serve(tag: str, smi: str, model, art, pf_per_layer: int) -> dict:
    """The main path of (a) / (b): ``art`` packed through the launcher's
    engine (CUDA graphs, batch 4, ``max_seq_len`` 544), 4 x 512 + 4 x 128
    prompts, 32 new tokens; the captures timed and their nodes counted,
    the launch gate, graph against eager, readings and a profile of a
    decode replay. ``pf_per_layer``: packed GEMMs a layer runs per
    forward."""
    cfg = model.config
    L = cfg.num_layers if cfg.family == "hybrid" else 0
    reqs = make_requests(cfg.vocab_size)
    eng = launch_serve.make_engine(model, art, batch=SSM["batch"],
                                   max_seq=SSM["max_seq"], packed=True,
                                   device=DEV)
    captures = {}
    for r in (reqs[0], reqs[4]):            # captures: S = 512, 128, decode
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate([r])
        torch.cuda.synchronize()
        S = len(r.prompt)
        captures[f"S{S}"] = {
            "s": time.perf_counter() - t0,
            "pool_bytes": eng.prefill_graphs[S].graph.pool_bytes}
    print(f"[{tag}] {cfg.name} graph captures (the first generate of each "
          f"prompt length, its seconds; the decode graph's in the first): "
          + json.dumps(captures), flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                                 # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(GEMM_NAMES)
    heads = 1 if is_packed(eng.params.get("lm_head")) else 0
    launch_gate(tag, f"{cfg.name} generate(8 requests) in "
                f"{wall * 1e3:.1f} ms", launches,
                {"pattern_gemm": 2 * SSM["new"] * (pf_per_layer * L + heads),
                 "flash_attention": 2 * L})
    for r in results:
        if len(r.tokens) != SSM["new"] or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"[{tag}] {cfg.name} request {r.uid}: bad tokens "
                 f"{r.tokens[:8]}")
    graph_against_eager(tag, eng, reqs[:4])
    n_tok = sum(len(r.tokens) for r in results)
    readings = {"generate_ms": wall * 1e3, "tok_s": n_tok / wall,
                "peak_bytes_serving": torch.cuda.max_memory_allocated(),
                "weight_bytes_packed": tree_packed_bytes(eng.params),
                "recurrent_state_bytes": cache_bytes(
                    eng.cache, ("mamba", "mlstm", "slstm")),
                "kv_bytes": cache_bytes(eng.cache, ("k", "v"))}
    for S, ch in ((128, reqs[4:]), (512, reqs[:4])):
        prompts, mask = eng.pad_prompts(ch)
        eng.set_rows(ch, mask)
        readings[f"prefill_graph_ms_S{S}"] = median_s(
            lambda: eng.prefill(prompts)) * 1e3
    tok0 = torch.zeros((SSM["batch"], 1), dtype=torch.int64, device=DEV)
    readings["decode_graph_ms_per_step"] = median_s(
        lambda: eng.decode(tok0, 31)) * 1e3 / 31
    readings["decode_graph_device_ms"] = timed_ms(
        eng.decode_graph.graph.replay, 10)
    print(f"[{tag}] {cfg.name}: " + json.dumps(readings) + f" ({smi})",
          flush=True)
    profile(tag, f"{cfg.name} decode step (graph replay)",
            lambda: eng.decode(tok0, 4), per=4, names=("pattern_gemm",))
    del eng
    torch.cuda.empty_cache()
    return launches


def hymba_prepare(tag: str, smi: str):
    """(a) hymba-1.5b at full width, 16 of 32 layers, bf16: init, the tile
    refusal with the mamba leaves in, prune a layer at a time (4 of 8,
    block_p 64, mamba and the head left out), pack, ``round_trip`` of its
    first 4 layers -> (model, the artifact)."""
    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              num_layers=SSM["hymba_layers"])
    model = LM(cfg, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    dense_bytes = sum(nbytes(w) for _, w in tree_items(params))
    mamba_bytes = sum(nbytes(w) for p, w in tree_items(params)
                      if "/mamba/" in p)
    tile_refused(tag, "hymba-1.5b layer 0 with the mamba leaves in",
                 {"blocks": [params["blocks"][0]]},
                 ssm_pcfg((r"lm_head",), HYMBA_BLOCK_P))
    art = prune_by_layer(params, HYMBA_PCFG).pack(device=DEV)
    check_exact(tag, art)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    packed = {reference_path(p) for p, x in tree_items(art.packed)
              if is_packed(x)}
    print(f"[{tag}] (a) hymba-1.5b L={cfg.num_layers} d_model={cfg.d_model} "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim} "
          f"d_ff={cfg.d_ff} mamba {cfg.mamba_heads} x {cfg.mamba_head_dim} "
          f"(N {cfg.ssm_state}) window {cfg.sliding_window} vocab "
          f"{cfg.vocab_size} {cfg.param_dtype}: init + prune by layer + pack "
          f"{t_setup:.2f} s; weight bytes dense {dense_bytes} (mamba "
          f"{mamba_bytes}) packed {art.packed_bytes()}; packed leaves "
          f"{sorted(packed)}; peak device memory while pruning and packing "
          f"{torch.cuda.max_memory_allocated()} bytes ({smi})", flush=True)
    want = {f"blocks/attn/w{n}" for n in "qkvo"} | {
        f"blocks/mlp/{n}" for n in ("w_gate", "w_up", "w_down")}
    if packed != want:
        fail(f"[{tag}] (a) packed leaves {sorted(packed)}, designed "
             f"{sorted(want)}")
    round_trip(tag, art, cfg, make_requests(cfg.vocab_size))
    art.bind(model, packed=True)
    if art.bind_report["fallbacks"]:
        fail(f"[{tag}] (a) bind fell back: {art.bind_report}")
    torch.cuda.empty_cache()
    return model, art


def hymba_wrap(tag: str, smi: str, model, art) -> dict:
    """(a) one request whose 2 048-token prompt and 64 new tokens wrap the
    2 048-slot ring (batch 1, ``max_seq_len`` 2 112), through the graphs
    (the ring wraps at the first decode step); the prefill graph's capture
    seconds."""
    cfg = model.config
    L = cfg.num_layers
    g = torch.Generator().manual_seed(5)
    S, new = SSM["wrap_prompt"], SSM["wrap_new"]
    req = Request(uid=0, prompt=torch.randint(0, cfg.vocab_size, (S,),
                                              generator=g),
                  max_new_tokens=new)
    eng = launch_serve.make_engine(model, art, batch=1, max_seq=S + new,
                                   packed=True, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate([req])                            # captures S = 2048, decode
    torch.cuda.synchronize()
    cap = {"s": time.perf_counter() - t0,
           "pool_bytes": eng.prefill_graphs[S].graph.pool_bytes}
    ring = eng.cache["slot_pos"].shape[1]
    reset_launches()                                 # the main path
    t0 = time.perf_counter()
    got = eng.generate([req])[0].tokens
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(GEMM_NAMES)
    launch_gate(tag, f"(a) the {S}-token prompt + {new} new tokens on a "
                f"ring of {ring} in {wall * 1e3:.1f} ms", launches,
                {"pattern_gemm": new * 7 * L, "flash_attention": L})
    print(f"[{tag}] (a) wrap: ring {ring}, prefill graph capture "
          + json.dumps(cap) + f"; {len(got)} tokens through the graphs in "
          f"{wall * 1e3:.1f} ms ({smi})", flush=True)
    if ring != S or len(got) != new or not all(
            0 <= t < cfg.vocab_size for t in got):
        fail(f"[{tag}] (a) the wrap request: ring {ring}, {len(got)} "
             f"tokens {got[:8]}")
    del eng
    torch.cuda.empty_cache()
    return launches


def hymba_continuous(tag: str, smi: str, model, art) -> dict:
    """(a) ``ContinuousEngine`` (batch 4, ``max_seq_len`` 544, chunks of
    8) on 8 requests of S 512 / 200 / 64 submitted at once, counts zeroed
    around them; each bit-identical to its solo run; the speculative
    engine refuses."""
    cfg = model.config
    L = cfg.num_layers
    g = torch.Generator().manual_seed(2)
    lens, new = CONT["lens"], CONT["new"]
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size,
                                                (lens[i % 3],), generator=g),
                    max_new_tokens=new[i % 3])
            for i in range(SSM["cont_requests"])]
    eng = continuous_engine(model, art)
    eng.generate(reqs[:len(lens)])               # captures each S, decode
    torch.cuda.synchronize()
    reset_launches()                                 # the main path
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(GEMM_NAMES)
    routes = {"flash_attention": dict(fa_mod.ROUTE_LAUNCHES),
              "blockwise_fallbacks": attention.PREFILL_FALLBACKS}
    st = eng.stats
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[{tag}] (a) hymba-1.5b ContinuousEngine, {len(reqs)} requests "
          f"(prompt lengths {lens}, budgets {new}) at once: wall "
          f"{wall * 1e3:.1f} ms, {n_tok} tokens, {n_tok / wall:.1f} tok/s, "
          f"occupancy {st['occupancy']:.4f}, {st['chunks']} chunks; "
          f"launches {json.dumps(launches)} by route {json.dumps(routes)} "
          f"({smi})", flush=True)
    for r, q in zip(results, reqs):
        if r.status != "ok" or len(r.tokens) != q.max_new_tokens:
            fail(f"[{tag}] (a) request {r.uid}: {r.status}, "
                 f"{len(r.tokens)} tokens")
    if (launches["flash_attention"] != L * len(reqs)
            or routes["flash_attention"]["wgmma"] != L * len(reqs)
            or routes["blockwise_fallbacks"]):
        fail(f"[{tag}] (a) every admission must run flash on wgmma "
             f"({L} x {len(reqs)}): {routes}")
    solo = [eng.generate([r])[0].tokens for r in reqs]
    same = [r.tokens == s for r, s in zip(results, solo)]
    print(f"[{tag}] (a) each request bit-identical to its solo run through "
          f"the same engine: {sum(same)}/{len(same)}", flush=True)
    if not all(same):
        fail(f"[{tag}] (a) continuous tokens depend on chunk-mates")
    try:
        SpeculativeEngine(model, art, art, batch_size=4, max_seq_len=544,
                          device=DEV)
    except NotImplementedError as e:
        print(f"[{tag}] (a) SpeculativeEngine refuses hymba-1.5b: {e}",
              flush=True)
    else:
        fail(f"[{tag}] (a) SpeculativeEngine took a recurrent model")
    del eng
    torch.cuda.empty_cache()
    return launches


def hymba_split(tag: str, smi: str, model, art) -> None:
    """(a) where an eager prefill of a 4 x 512 chunk and an eager decode
    step spend their device time: the mamba heads (``mamba_apply`` /
    ``mamba_step``) against ``pattern_gemm``, flash and the rest; the
    prefill's kernel launches are the nodes its graph holds."""
    packed = art.bind(model, packed=True)
    tokens = torch.randint(0, model.config.vocab_size, (4, 512),
                           generator=torch.Generator().manual_seed(3)).to(DEV)
    cache = model.init_cache(4, SSM["max_seq"])
    device_split(tag, smi, "(a) hymba-1.5b eager prefill 4 x 512",
                 lambda: model.prefill(packed, tokens, SSM["max_seq"],
                                       cache=cache),
                 {"mamba": "mamba_apply"})
    tok = tokens[:, :1]
    device_split(tag, smi, "(a) hymba-1.5b eager decode step",
                 lambda: model.decode_step(packed, cache, tok),
                 {"mamba": "mamba_step"})
    del cache
    torch.cuda.empty_cache()


def xlstm_prepare(tag: str, smi: str):
    """(b) xlstm-1.3b at full width, 16 of 48 blocks (2 of its 6 groups of
    7 mLSTM + 1 sLSTM blocks), bf16: init, the tile refusal on a grouped
    mLSTM leaf, greedy tile 4 of 8 (block_p 128) with the cells left out,
    so only the head packs -> (model, artifact)."""
    cfg = dataclasses.replace(get_config("xlstm-1.3b"),
                              num_layers=SSM["xlstm_layers"])
    model = LM(cfg, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    dense_bytes = sum(nbytes(w) for _, w in tree_items(params))
    tile_refused(tag, "xlstm-1.3b group 0 with the cells in",
                 {"blocks": [params["blocks"][0]]}, TILE_PCFG)
    art = greedy_prune(params, XLSTM_PCFG, device=DEV).pack(device=DEV)
    del params
    check_exact(tag, art)
    torch.cuda.synchronize()
    packed = [p for p, x in tree_items(art.packed) if is_packed(x)]
    print(f"[{tag}] (b) xlstm-1.3b {cfg.num_layers} blocks (groups of "
          f"{cfg.slstm_every}) d_model={cfg.d_model} heads {cfg.num_heads} "
          f"of {cfg.head_dim} vocab {cfg.vocab_size} {cfg.param_dtype}: init "
          f"+ prune + pack {time.perf_counter() - t0:.2f} s; weight bytes "
          f"dense {dense_bytes} packed {art.packed_bytes()}; packed leaves "
          f"{packed}; peak device memory {torch.cuda.max_memory_allocated()} "
          f"bytes ({smi})", flush=True)
    if packed != ["lm_head"]:
        fail(f"[{tag}] (b) packed leaves {packed}, designed ['lm_head']")
    art.bind(model, packed=True)
    return model, art


def xlstm_checks(tag: str, smi: str, model, art) -> None:
    """(b) the refusals (the continuous and speculative engines) and the
    prefill's device split between the mLSTM chunks and the sLSTM time
    loop on a 4 x 512 chunk."""
    for what, make in (
            ("ContinuousEngine", lambda: continuous_engine(model, art)),
            ("SpeculativeEngine", lambda: SpeculativeEngine(
                model, art, art, batch_size=4, max_seq_len=544,
                device=DEV))):
        try:
            make()
        except NotImplementedError as e:
            print(f"[{tag}] (b) {what} refuses xlstm-1.3b: {e}", flush=True)
        else:
            fail(f"[{tag}] (b) {what} took xlstm-1.3b")
    packed = art.bind(model, packed=True)
    tokens = torch.randint(0, model.config.vocab_size, (4, 512),
                           generator=torch.Generator().manual_seed(3)).to(DEV)
    cache = model.init_cache(4, SSM["max_seq"])
    device_split(tag, smi, "(b) xlstm-1.3b eager prefill 4 x 512",
                 lambda: model.prefill(packed, tokens, SSM["max_seq"],
                                       cache=cache),
                 {"mlstm": "mlstm_apply", "slstm": "slstm_apply"})
    tok = tokens[:, :1]
    device_split(tag, smi, "(b) xlstm-1.3b eager decode step",
                 lambda: model.decode_step(packed, cache, tok),
                 {"mlstm": "mlstm_step", "slstm": "slstm_step"})
    del cache
    torch.cuda.empty_cache()


def busy_run(tag: str, smi: str, what: str, fn) -> dict:
    """``fn`` once under torch.profiler (device activity only): wall, busy
    share and launches; then the peak device memory of a second run."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0, "profiled_wall_s": wall,
           "device_busy_s": busy, "busy_share": busy / wall,
           "kernel_launches": sum(e.count for e in kernels),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"[{tag}] {what}: " + json.dumps(out) + f" ({smi})", flush=True)
    return out


def ssm_admm(tag: str, smi: str) -> dict:
    """(c) ADMM at full width, bf16, on uniform synthetic tokens at
    ``[admm]``'s batch: hymba-1.5b layer-wise at 2 of 32 layers (the mamba
    branch in every stage; tile 4 of 8 at block_p 64, mamba and the head
    left out), xlstm-1.3b whole-model at one group of 8 blocks (the head
    alone prunable: tile 4 of 8); one iteration each after a first use,
    seconds, busy share, launches, peak; the hymba result packed and
    prefilled, launches gated."""
    out = {}
    for name, layers, excl, block, layerwise in (
            ("hymba-1.5b", SSM["admm_layers"], HYMBA_EXCLUDE,
             HYMBA_BLOCK_P, True),
            ("xlstm-1.3b", get_config("xlstm-1.3b").slstm_every,
             XLSTM_EXCLUDE, 128, False)):
        cfg = dataclasses.replace(get_config(name), num_layers=layers)
        model = LM(cfg, device=DEV)
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        adapter = LMAdapter(model, seq_len=ADMM_SEQ)
        pcfg = prune_config_for(scheme="tile_pattern", rate=2, iters=1,
                                batch=ADMM_BATCH, tile_block=block,
                                layerwise=layerwise,
                                exclude=tuple(PruneConfig().exclude) + excl)
        pruner = PrivacyPreservingPruner(adapter, pcfg)
        result = pruner.run(as_key(1), params)           # first use
        finite_history(tag, result.history)
        reading = busy_run(
            tag, smi, f"(c) {name} {layers} of {get_config(name).num_layers} "
            f"layers at full width, {'layer-wise' if layerwise else 'whole-model'}"
            f" ADMM tile 4 of 8, batch {ADMM_BATCH} x {ADMM_SEQ}, one "
            "iteration", lambda: pruner.run(as_key(1), params))
        out[name] = reading
        if name == "hymba-1.5b":
            art = result.to_artifact(arch=name, scheme="tile_pattern",
                                     rate=2.0).pack(device=DEV)
            check_exact(tag, art)
            packed = art.bind(model, packed=True)
            tokens = torch.randint(0, cfg.vocab_size, (4, 128),
                                   generator=torch.Generator().manual_seed(
                                       3)).to(DEV)
            model.prefill(packed, tokens, 160)
            torch.cuda.synchronize()
            reset_launches()                         # the main path
            _, logits = model.prefill(packed, tokens, 160)
            torch.cuda.synchronize()
            out["launches"] = launch_counts(GEMM_NAMES)
            launch_gate(tag, "(c) prefill of the ADMM-pruned hymba-1.5b",
                        out["launches"], {"pattern_gemm": 7 * layers,
                                          "flash_attention": layers})
            if not bool(torch.isfinite(logits).all()):
                fail(f"[{tag}] (c) prefill logits not finite")
            del art, packed
        del pruner, result, params, model
        torch.cuda.empty_cache()
    return out["launches"]


def ssm_fp32(tag: str) -> dict:
    """(d) fp32 at full width: hymba-1.5b at 4 of 32 layers, dense-pruned
    against packed greedy tokens identical and continuous tokens equal to
    ``ServeEngine(batch_size=1)``'s; xlstm-1.3b at one group of 8 blocks,
    dense-pruned against packed (the head) identical."""
    hymba = get_config("hymba-1.5b")
    token_identity(tag, dataclasses.replace(
        hymba, num_layers=SSM["fp32_layers"], param_dtype="float32"),
        HYMBA_PCFG, note=f", hymba-1.5b at {SSM['fp32_layers']} of "
        f"{hymba.num_layers} layers")
    torch.cuda.empty_cache()
    continuous_fp32(tag, hymba, continuous_requests(hymba.vocab_size),
                    HYMBA_PCFG)
    torch.cuda.empty_cache()
    xlstm = get_config("xlstm-1.3b")
    token_identity(tag, dataclasses.replace(
        xlstm, num_layers=xlstm.slstm_every, param_dtype="float32"),
        XLSTM_PCFG, note=f", xlstm-1.3b at one group of "
        f"{xlstm.slstm_every} of {xlstm.num_layers} blocks")
    torch.cuda.empty_cache()
    return {}


def phase_ssm(smi: str) -> dict:
    """The recurrent families: (a) hymba-1.5b and (b) xlstm-1.3b at full
    width, cut in depth, pruned, packed and served through the graphs, (c)
    ADMM of each, (d) the fp32 bars. Returns the main paths' launch
    counts, summed."""
    tag = "ssm"
    total = dict.fromkeys(GEMM_NAMES, 0)
    held = {}

    def hymba_main():
        held["model"], held["art"] = hymba_prepare(tag, smi)
        launches = ssm_serve(tag, smi, held["model"], held["art"], 7)
        hymba_split(tag, smi, held["model"], held["art"])
        return launches

    def hymba_rest():
        out = hymba_wrap(tag, smi, held["model"], held["art"])
        cont = hymba_continuous(tag, smi, held["model"], held["art"])
        held.clear()
        return {k: out[k] + cont[k] for k in out}

    def xlstm_main():
        model, art = xlstm_prepare(tag, smi)
        launches = ssm_serve(tag, smi, model, art, 0)
        xlstm_checks(tag, smi, model, art)
        return launches

    parts = (("(a) hymba-1.5b", hymba_main),
             ("(a) hymba-1.5b wrap, continuous, speculative", hymba_rest),
             ("(b) xlstm-1.3b", xlstm_main),
             ("(c) ADMM", lambda: ssm_admm(tag, smi)),
             ("(d) fp32 bars", lambda: ssm_fp32(tag)))
    for what, fn in parts:
        t0 = time.perf_counter()
        for k, v in fn().items():
            total[k] += v
        torch.cuda.empty_cache()
        print(f"[time] {tag} {what} {time.perf_counter() - t0:.1f} s",
              flush=True)
    return total


# ------------------------------------- roofline, analysis, training, examples

BENCH_TORCH = os.path.join(ROOT, "experiments", "bench_torch")
ATTRIBUTION = os.path.join(BENCH_TORCH, "attribution.json")
CONT_TRACE = os.path.join(BENCH_TORCH, "trace_telemetry.jsonl")
# [roofline]: every distinct packed leaf (one per reference path) through
# the registry under the profiler, the GEMMs at [kernels]' M, VGG-16's convs
# on one image of 64 x 64 and of 256 x 256 (M a power of two, so the
# profiler's bucket is the M dispatched); bf16, activations modeled at 2
# bytes; a fraction above FRACTION_MAX means the model leaves out bytes
ROOF = dict(gemm_ms=GEMM_MS, conv_ms=(4096, 65536), samples=8, warmup=2)
FRACTION_MAX = 1.05
# [train]: qwen2-1.5b at full width, 4 of 28 layers, batch 8 x 512 tokens,
# bf16, masks of a greedy tile prune of the same seed's init; a run of
# ``steps``, the same run stopped after its step-``every`` checkpoint and
# resumed for the steps left, a run with int8 gradient compression. Every
# step is inside TrainConfig's 10 warmup steps, whose learning rates do not
# depend on a run's length, so the resumed run can be given the steps left
TRAIN = dict(layers=4, batch=8, seq=512, steps=4, every=2, compressed=3)
TRAIN_CLI = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "20",
             "--batch", "8", "--seq", "128"]
EXAMPLES_DIR = os.path.join(ROOT, "examples")
EXAMPLES = ("torch_quickstart.py", "torch_prune_then_serve_lm.py",
            "torch_privacy_pruning_cnn.py",
            "torch_distributed_masked_retraining.py")
# runs an example as __main__ in this subprocess, then prints on a line of
# its own the kernel launches it made (graph replays counted), its prefills
# that fell back to blockwise attention, and its seconds
EXAMPLE_WRAP = (
    "import json, runpy, sys, time\n"
    "from repro_torch.kernels import column_gemm, flash_attention, "
    "pattern_conv, pattern_gemm\n"
    "from repro_torch.models import attention\n"
    "t0 = time.perf_counter()\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "print('[launches] ' + json.dumps({'seconds': time.perf_counter() - t0, "
    "'fallbacks': attention.PREFILL_FALLBACKS, "
    "'launches': {m.__name__.split('.')[-1]: m.LAUNCHES for m in "
    "(pattern_gemm, flash_attention, column_gemm, pattern_conv)}}))\n")


def port_env() -> dict:
    """The environment of a subprocess that imports the port."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))


def kernels_row(rows: list, kernel: str, shape: str):
    """The bf16 ``[kernels]`` row of ``kernel`` at ``shape``, if timed."""
    for r in rows:
        if (r["kernel"], r["shape"], r["dtype"]) == (
                kernel, shape, "bfloat16") and r["ms"] is not None:
            return r
    return None


def gemm_row_name(path: str) -> str:
    name = path.split("/")[-1]
    return "wk/wv" if name in ("wk", "wv") else name


def roofline_tree(tag: str, what: str, tree, ms, kernel: str,
                  kernel_rows: list) -> list:
    """Attribute each distinct packed leaf of ``tree`` alone (its own
    profile rows, its own model: a row is one kernel shape), print each
    row beside the ``[kernels]`` row of the same shape, gate the row."""
    out = []
    for path, leaf in attribution.packed_leaves(tree):
        sub = {path: leaf}
        prof = attribution.profile_packed_tree(
            sub, ms, samples=ROOF["samples"], warmup=ROOF["warmup"],
            device=DEV, dtype=torch.bfloat16)
        for r in attribution.attribute(prof, sub, itemsize=2):
            r["leaf"] = f"{what} {path}"
            out.append(r)
            if kernel == "pattern_conv":
                A, C = leaf.shape[0], leaf.shape[1]
                ref = next((k for k in kernel_rows if k["kernel"] == kernel
                            and k["dtype"] == "bfloat16" and k["shape"]
                            .startswith("B=32 ") and k["shape"].endswith(
                                f" {C}->{A}")), None)
            else:
                ref = kernels_row(kernel_rows, kernel,
                                  f"{gemm_row_name(path)} M={r['bucket']}"
                                  if r["bucket"] > 32 else
                                  f"{gemm_row_name(path)} M=4")
            cross = ("no [kernels] row" if ref is None else
                     f"[kernels] {ref['shape']}: bound "
                     f"{ref['bound_ms'] * 1e3:.2f} us ({ref['bound_by']}), "
                     f"{ref['ms'] * 1e3:.2f} us")
            frac = r["achieved_fraction"]
            print(f"[{tag}] {r['leaf']} {r['kind']} m{r['bucket']} "
                  f"({r['samples']} samples): measured "
                  f"{r['measured_ns'] / 1e3:.2f} us, modeled "
                  f"{(r['modeled_ns'] or 0) / 1e3:.2f} us ({r['bound']}), "
                  f"achieved {frac}; cross-check {cross}", flush=True)
            if r["modeled_ns"] is None or not 0.0 < frac <= FRACTION_MAX:
                fail(f"[{tag}] {r['leaf']} m{r['bucket']}: achieved "
                     f"fraction {frac} outside (0, {FRACTION_MAX}]")
    return out


def phase_roofline(smi: str, tile_art, column_art, kernel_rows: list
                   ) -> dict:
    """The port's roofline attribution at full width in bf16: qwen2-1.5b's
    tile artifact from [serve] and column artifact from [column] at M = 4,
    512, 2 048, VGG-16 ``pattern_shared`` at 224 x 224; counts zeroed
    around the profiles. Writes ``attribution.json``. Returns the
    launches."""
    tag = "roofline"
    _, cnn, _ = build_cnn(*CNN_PATHS[0][1:3], "bfloat16")
    trees = (("qwen2-1.5b tile", tile_art.packed, ROOF["gemm_ms"],
              "pattern_gemm"),
             ("qwen2-1.5b column", column_art.packed, ROOF["gemm_ms"],
              "column_gemm"),
             ("vgg16 pattern_shared", cnn.packed, ROOF["conv_ms"],
              "pattern_conv"))
    names = ("pattern_gemm", "column_gemm", "pattern_conv")
    reset_launches()                              # the main path
    t0 = time.perf_counter()
    rows = [r for what, tree, ms, kernel in trees
            for r in roofline_tree(tag, what, tree, ms, kernel, kernel_rows)]
    launches = launch_counts(names)
    os.makedirs(BENCH_TORCH, exist_ok=True)
    attribution.write_report(ATTRIBUTION, rows, device=smi,
                             itemsize=2, dtype="bfloat16")
    fracs = [r["achieved_fraction"] for r in rows]
    print(f"[{tag}] {len(rows)} rows in {time.perf_counter() - t0:.1f} s "
          f"(achieved fraction min {min(fracs):.4f}, max {max(fracs):.4f}); "
          f"launches {json.dumps(launches)}; wrote {ATTRIBUTION} ({smi})",
          flush=True)
    if not all(launches.values()):
        fail(f"[{tag}] a kernel never launched: {launches}")
    del cnn
    return launches


def phase_analyze(smi: str) -> None:
    """``python -m repro_torch.launch.analyze`` on [continuous]'s trace and
    [roofline]'s report: exit 0, the 12 requests counted; a missing trace
    exits 2 (``main`` in process)."""
    tag = "analyze"
    out = os.path.join(BENCH_TORCH, "analysis.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.analyze", "--trace",
           CONT_TRACE, "--attribution", ATTRIBUTION, "--out", out]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=port_env(), capture_output=True, text=True,
                       timeout=300)
    print(f"[{tag}] python -m repro_torch.launch.analyze: exit "
          f"{p.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
    if p.returncode != 0:
        fail(f"[{tag}] analyze failed: {p.stdout[-2000:]} {p.stderr[-2000:]}")
    doc = json.load(open(out))
    s = doc["summary"]
    rows = doc.get("attribution", {}).get("rows", [])
    print(f"[{tag}] summary {json.dumps(s)}; SLO {json.dumps(doc['slo'])}; "
          f"attribution rows {len(rows)}", flush=True)
    for line in p.stdout.splitlines()[:3]:
        print(f"[{tag}] | {line}", flush=True)
    if s["requests"] != CONT["requests"] or s["status_counts"] != {
            "ok": CONT["requests"]} or not doc.get("attribution"):
        fail(f"[{tag}] the analysis does not count [continuous]'s "
             f"{CONT['requests']} requests: {s}")
    rc = launch_analyze.main(["--trace", os.path.join(BENCH_TORCH,
                                                      "missing.jsonl")])
    print(f"[{tag}] a missing trace: exit {rc}", flush=True)
    if rc != 2:
        fail(f"[{tag}] a missing trace exits {rc}, not 2")


def train_cfg(tmp: str, name: str, **kw) -> TrainConfig:
    base = dict(steps=TRAIN["steps"], learning_rate=3e-4,
                checkpoint_every=10 ** 6,
                checkpoint_dir=os.path.join(tmp, name), keep_checkpoints=1)
    base.update(kw)
    return TrainConfig(**base)


class TrainStop(Exception):
    pass


def stop_at(k: int):
    def hook(res):
        if res.step == k:
            raise TrainStop
    return hook


def phase_train(smi: str) -> dict:
    """``run_training`` on qwen2-1.5b at full width, 4 layers, masked:
    s per step, the straggler monitor, peak memory; gates: pruned weights
    stay 0, stopped-and-resumed ≡ uninterrupted, int8 compression finite
    with every residual within half its scale; the CLI in a subprocess.
    Returns the int8 run's config, masks, metrics, step seconds and final
    params, which [scaleout] holds its sharded run to."""
    tag = "train"
    cli_dir = tempfile.TemporaryDirectory(prefix="train-cli-")
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
         "--ckpt-dir", cli_dir.name], env=port_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              num_layers=TRAIN["layers"])
    model = LM(cfg, device=DEV)
    masks = greedy_prune(model.init(torch.Generator(device=DEV).manual_seed(
        0)), TILE_PCFG, device=DEV).masks
    del model
    kw = dict(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"],
              masks=masks, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="train-") as tmp:
        t0 = time.perf_counter()
        whole = run_training(cfg, train_cfg(tmp, "whole"), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        secs = [r.seconds for r in whole["metrics"]]
        losses = [r.metrics["loss"] for r in whole["metrics"]]
        print(f"[{tag}] qwen2-1.5b L={cfg.num_layers} of 28 d_model="
              f"{cfg.d_model} {cfg.param_dtype}, batch {TRAIN['batch']} x "
              f"{TRAIN['seq']} tokens, masked (greedy tile 4 of 8): "
              f"{len(secs)} steps in {wall:.2f} s, s per step "
              f"{json.dumps([round(s, 4) for s in secs])} (after the first: "
              f"median {statistics.median(secs[1:]):.4f}); losses "
              f"{json.dumps([round(v, 4) for v in losses])}; straggler "
              f"{json.dumps(whole['straggler'])}; peak device memory {peak} "
              f"bytes ({smi})", flush=True)
        if not all(math.isfinite(v) for v in losses):
            fail(f"[{tag}] non-finite losses {losses}")
        params = dict(tree_items(whole["state"]["params"]))
        bad = [p for p, m in tree_items(masks)
               if m is not None and bool(params[p][m == 0].any())]
        kept = sum(int((m == 0).sum()) for _, m in tree_items(masks)
                   if m is not None)
        print(f"[{tag}] pruned weights still exactly 0 after "
              f"{len(secs)} steps: {not bad} ({kept} pruned)", flush=True)
        if bad or not kept:
            fail(f"[{tag}] pruned weights moved: {bad[:4]}")

        cut = train_cfg(tmp, "cut", checkpoint_every=TRAIN["every"])
        t0 = time.perf_counter()
        try:                                  # stops once step 2 committed
            run_training(cfg, cut, on_step=stop_at(TRAIN["every"]), **kw)
        except TrainStop:
            pass
        if CheckpointManager(cut.checkpoint_dir).latest_step() != TRAIN[
                "every"]:
            fail(f"[{tag}] the stopped run left no step-{TRAIN['every']} "
                 "checkpoint")
        resumed = run_training(cfg, dataclasses.replace(
            cut, steps=TRAIN["steps"] - TRAIN["every"],
            checkpoint_every=10 ** 6), **kw)["state"]
        a, b = tree_items(whole["state"]), dict(tree_items(resumed))
        same = [p for p, x in a if x.dtype == b[p].dtype
                and torch.equal(x, b[p])]
        n = len(b)
        print(f"[{tag}] stopped after the step-{TRAIN['every']} checkpoint "
              f"and resumed for the {TRAIN['steps'] - TRAIN['every']} steps "
              f"left ({time.perf_counter() - t0:.1f} s with one save and one "
              f"restore): the step-{TRAIN['steps']} state bit-equal to the "
              f"uninterrupted run's in {len(same)}/{n} leaves", flush=True)
        if len(same) != n:
            fail(f"[{tag}] the resumed run differs from the uninterrupted")
        del whole, resumed, params
        torch.cuda.empty_cache()

        comp = run_training(cfg, train_cfg(
            tmp, "int8", steps=TRAIN["compressed"], grad_compression=True),
            **kw)
        losses = [r.metrics["loss"] for r in comp["metrics"]]
        ratio = max(r.metrics["ef_residual_ratio"] for r in comp["metrics"])
        print(f"[{tag}] --grad-compression: losses "
              f"{json.dumps([round(v, 4) for v in losses])}; largest "
              f"|residual| / scale {ratio:.6f} (at most 1/2)", flush=True)
        if not all(math.isfinite(v) for v in losses) or ratio > 0.5 + 1e-5:
            fail(f"[{tag}] int8 compression: losses {losses}, residual "
                 f"ratio {ratio}")
        ref = {"cfg": cfg, "kw": kw, "metrics": [r.metrics for r in
                                                 comp["metrics"]],
               "secs": [r.seconds for r in comp["metrics"]],
               "params": comp["state"]["params"]}
        del comp
    torch.cuda.empty_cache()
    out, err = cli.communicate(timeout=600)
    cli_dir.cleanup()
    last = out.strip().splitlines()[-1:] if out.strip() else []
    print(f"[{tag}] python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_CLI)}: exit {cli.returncode}; {last}",
          flush=True)
    if cli.returncode != 0 or not last or not re.match(
            r"arch=qwen2-1\.5b steps=20 loss: first=\S+ last=\S+$", last[0]):
        fail(f"[{tag}] the training CLI failed: {err[-3000:]}")
    return ref


# [scaleout]: the train state of (b) at 2 of 28 layers; the dry-run's cells
# traced in DRYRUN_JOBS processes on the host beside (a) and (b)
SCALEOUT = dict(ckpt_layers=2, dryrun_jobs=6, useful_max=1.05)
DRYRUN_CELLS = {(shape, mesh) for shape in ("train_4k", "prefill_32k",
                                            "decode_32k")
                for mesh in ("16x16", "2x16x16")}


def scaleout_train(tag: str, smi: str, mesh, ref: dict) -> None:
    """(a) ``run_training(mesh=...)`` on the 1 × 1 mesh with [train]'s
    int8 run's config, masks, seed and steps: bit-equal to it."""
    cfg, kw = ref["cfg"], ref["kw"]
    with tempfile.TemporaryDirectory(prefix="scaleout-train-") as tmp:
        t0 = time.perf_counter()
        res = run_training(cfg, train_cfg(
            tmp, "mesh", steps=TRAIN["compressed"], grad_compression=True),
            mesh=mesh, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = [r.metrics for r in res["metrics"]]
    secs = [r.seconds for r in res["metrics"]]
    placed = {str(tuple(x.placements)) for x in
              tree_leaves(res["state"]["params"])}
    params = {p: x.full_tensor() for p, x in
              tree_items(res["state"]["params"])}
    want = dict(tree_items(ref["params"]))
    same = [p for p, x in params.items() if x.dtype == want[p].dtype
            and torch.equal(x, want[p])]
    masks = kw["masks"]
    moved = [p for p, m in tree_items(masks)
             if m is not None and bool(params[p][m == 0].any())]
    print(f"[{tag}] (a) run_training(mesh=1x1 (data, model), NCCL) "
          f"qwen2-1.5b L={cfg.num_layers} of 28, batch {TRAIN['batch']} x "
          f"{TRAIN['seq']}, masked, int8 compression, {len(got)} steps in "
          f"{wall:.2f} s: s per step {json.dumps([round(x, 4) for x in secs])}"
          f" against [train]'s unsharded "
          f"{json.dumps([round(x, 4) for x in ref['secs']])}; param "
          f"placements {sorted(placed)} ({smi})", flush=True)
    print(f"[{tag}] (a) metrics bit-equal to [train]'s unsharded run at "
          f"every step: {got == ref['metrics']} (losses "
          f"{json.dumps([m['loss'] for m in got])}, grad norms "
          f"{json.dumps([m['grad_norm'] for m in got])}); final params "
          f"bit-equal in {len(same)}/{len(want)} leaves; pruned weights "
          f"still 0: {not moved}", flush=True)
    if got != ref["metrics"]:
        fail(f"[{tag}] (a) the sharded run's metrics {got} differ from the "
             f"unsharded run's {ref['metrics']}")
    if len(same) != len(want) or set(params) != set(want):
        fail(f"[{tag}] (a) final params differ from the unsharded run's in "
             f"{sorted(set(want) - set(same))[:6]}")
    if moved:
        fail(f"[{tag}] (a) pruned weights moved: {moved[:4]}")


def scaleout_checkpoint(tag: str, mesh, cfg) -> None:
    """(b) a train state at ``SCALEOUT["ckpt_layers"]`` layers, built on
    the mesh, saved, restored onto the mesh and onto no mesh."""
    cfg2 = dataclasses.replace(cfg, num_layers=SCALEOUT["ckpt_layers"])
    model, opt = LM(cfg2, device=DEV), adamw(3e-4)
    gen = lambda: torch.Generator(device=DEV).manual_seed(0)
    with axis_rules(default_rules(mesh)):
        state = init_state(model, opt, gen())
    plain_like = init_state(model, opt, gen())
    with tempfile.TemporaryDirectory(prefix="scaleout-ckpt-") as tmp:
        manager = CheckpointManager(tmp, keep=1)
        t0 = time.perf_counter()
        manager.save(1, state)
        t_save = time.perf_counter() - t0
        size = disk_bytes(tmp)
        t0 = time.perf_counter()
        on_mesh = manager.restore(state, shardings=shardings_of(state))
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = manager.restore(plain_like)
        t_plain = time.perf_counter() - t0
    want = dict(tree_items(state))
    a, b = dict(tree_items(on_mesh)), dict(tree_items(plain))
    same_mesh = [p for p, x in a.items() if is_dtensor(x)
                 == is_dtensor(want[p]) and torch.equal(
                     gather_full(x), gather_full(want[p]))
                 and (not is_dtensor(x) or x.placements
                      == want[p].placements)]
    same_plain = [p for p, x in b.items() if not is_dtensor(x)
                  and torch.equal(x, gather_full(want[p]))]
    print(f"[{tag}] (b) qwen2-1.5b L={cfg2.num_layers} of 28 train state "
          f"({len(want)} leaves, {size} bytes on disk) saved on the 1x1 "
          f"mesh in {t_save:.2f} s, restored onto it in {t_mesh:.2f} s and "
          f"onto no mesh in {t_plain:.2f} s: bit-equal on the mesh in "
          f"{len(same_mesh)}/{len(want)} leaves, unsharded in "
          f"{len(same_plain)}/{len(want)}", flush=True)
    if len(same_mesh) != len(want) or len(same_plain) != len(want):
        fail(f"[{tag}] (b) restored leaves differ: on the mesh "
             f"{sorted(set(want) - set(same_mesh))[:6]}, unsharded "
             f"{sorted(set(want) - set(same_plain))[:6]}")


def scaleout_dryrun(tag: str, smi: str, proc, out: str, t0: float) -> None:
    """(c) waits for the dry-run subprocess: its lines, its records and
    the roofline report of both meshes."""
    text, err = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    lines = [l for l in text.splitlines()
             if l[:4] in ("OK  ", "SKIP", "FAIL")]
    for line in lines:
        print(f"[{tag}] (c) | {line}", flush=True)
    ok = {tuple(l.split()[1].rstrip(":").split("__")[1:]) for l in lines
          if l.startswith("OK")}
    reason = skip_reason(get_config("qwen2-1.5b"), SHAPES["long_500k"])
    skips = [l for l in lines if l.startswith("SKIP")]
    if (proc.returncode != 0 or ok != DRYRUN_CELLS or len(skips) != 2
            or any(not l.endswith(f": {reason}") for l in skips)):
        fail(f"[{tag}] (c) the dry-run (exit {proc.returncode}) left cells "
             f"not OK or skipped for another reason: {lines} "
             f"{err[-3000:]}")
    worst = 0.0
    for mesh in ("16x16", "2x16x16"):
        for rec in roofline_report.load_cells(out, mesh):
            if rec.get("status") != "ok":
                continue
            coll = {k: v for k, v in rec["collectives"].items() if v}
            worst = max(worst, rec["useful_flop_ratio"])
            print(f"[{tag}] (c) qwen2-1.5b {rec['shape']} on {mesh} "
                  f"({roofline_report.MESH_DEVICES[mesh]} cards), per "
                  f"device: argument bytes "
                  f"{rec['memory']['argument_bytes']}, temp bytes "
                  f"{rec['memory']['temp_bytes']}, FLOPs {rec['flops']:.4e}"
                  f", bytes {rec['bytes_accessed']:.4e}, collective bytes "
                  f"{json.dumps(coll)}; dominant {rec['dominant']} "
                  f"(compute {rec['compute_s']:.4e} s, memory "
                  f"{rec['memory_s']:.4e} s, collective "
                  f"{rec['collective_s']:.4e} s), useful ratio "
                  f"{rec['useful_flop_ratio']:.4f}, roofline fraction "
                  f"{rec['roofline_fraction']:.4f}; traced in "
                  f"{rec['trace_seconds']:.1f} s (H100 terms; {smi})",
                  flush=True)
    print(f"[{tag}] (c) the dry-run: {len(ok)} OK, {len(skips)} SKIP in "
          f"{wall:.1f} s wall ({SCALEOUT['dryrun_jobs']} processes on the "
          f"host, beside (b)); largest useful ratio {worst:.4f} "
          f"(at most {SCALEOUT['useful_max']})", flush=True)
    if worst > SCALEOUT["useful_max"]:
        fail(f"[{tag}] (c) a useful ratio of {worst} counts fewer traced "
             "FLOPs than the model needs")


# [scaleout] (d): each family at full width and this many layers, trained
# for 2 steps and serving 4 x 512 prompts 8 greedy steps. qwen2-moe-a2.7b
# at 1 layer: 1.19 B params (its untied 151 936-row embedding and head
# 0.62 B, a layer's 60 experts 0.52 B); at 2 layers (1.76 B) an int8 step
# holds the old and the new params, AdamW moments and residuals, the fp32
# gradients and updates at once and ran out of the card's 80 GB
SCALEOUT_FAMILIES = (("qwen2-moe-a2.7b", 1), ("hymba-1.5b", 2),
                     ("xlstm-1.3b", 8))
SCALEOUT_SERVE = dict(batch=4, prompt=512, new=8, steps=2)


def family_masks(model: LM) -> dict:
    """A seeded 50% mask (bf16 {0, 1}) of every 2-D leaf but the
    embedding, None elsewhere: the cells' matrices and the heads; an
    expert's (E, D, F) leaf is left whole. xlstm-1.3b's grouped mLSTM
    leaves are (7, ...), so its per-layer vectors are masked too: half
    its forget biases are 0 and those gates near 0.5, whose chunk
    exponents pass fp32's exp (the gradients stay finite only through
    ``ssm._mlstm_chunk``'s masked exponents)."""
    g = torch.Generator(device=DEV).manual_seed(11)
    return unflatten({
        p: ((torch.rand(s, generator=g, device=DEV) < 0.5).to(torch.bfloat16)
            if len(s) == 2 and p != "embed" else None)
        for p, s in model.param_shapes().items()})


def family_serve(model: LM, params, prompts, mesh=None):
    """The prefill of ``prompts`` and ``SCALEOUT_SERVE["new"]`` greedy
    decode steps, sharded on ``mesh`` if given -> (each step's logits,
    gathered whole; the tokens; the prefill's flash launches and
    blockwise fallbacks)."""
    rules = default_rules(mesh) if mesh is not None else None
    place = lambda t: t
    with axis_rules(rules):
        if rules is not None:
            params = shard_tree(params, param_shardings(
                rules, model.param_logical_axes(), params))
            place = lambda t: shard(t, batch_spec(rules, 2, shape=t.shape))
        reset_launches()
        cache, logits = model.prefill(params, place(prompts),
                                      prompts.shape[1] + SCALEOUT_SERVE["new"])
        torch.cuda.synchronize()
        flash = (fa_mod.LAUNCHES, attention.PREFILL_FALLBACKS)
        steps, toks = [gather_full(logits)], []
        for _ in range(SCALEOUT_SERVE["new"]):
            tok = steps[-1].argmax(-1).to(torch.int32)
            toks.append(tok)
            cache, logits = model.decode_step(params, cache, place(tok))
            steps.append(gather_full(logits))
    return steps, torch.cat(toks, dim=1), flash


def family_train(tag: str, smi: str, mesh, cfg, full: int) -> None:
    """(d) ``run_training`` unsharded, then on the mesh: bit for bit."""
    model = LM(cfg, device=DEV)
    masks = family_masks(model)
    kw = dict(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"],
              masks=masks, device=DEV)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="scaleout-fam-") as tmp:
        for what, m in (("plain", None), ("mesh", mesh)):
            res = run_training(cfg, train_cfg(
                tmp, what, steps=SCALEOUT_SERVE["steps"],
                grad_compression=True), mesh=m, **kw)
            runs[what] = ([r.metrics for r in res["metrics"]],
                          [r.seconds for r in res["metrics"]],
                          {p: gather_full(x) for p, x in
                           tree_items(res["state"]["params"])})
            del res
            torch.cuda.empty_cache()
    (got, secs, params), (want, want_secs, plain) = runs["mesh"], runs["plain"]
    same = [p for p, x in params.items() if x.dtype == plain[p].dtype
            and torch.equal(x, plain[p])]
    moved = [p for p, m in tree_items(masks)
             if m is not None and bool(params[p][m == 0].any())]
    kept = sum(int((m == 0).sum()) for _, m in tree_items(masks)
               if m is not None)
    print(f"[{tag}] (d) {cfg.name} L={cfg.num_layers} of {full} d_model="
          f"{cfg.d_model} {cfg.param_dtype} "
          f"({sum(x.numel() for x in plain.values())} params), batch "
          f"{TRAIN['batch']} x {TRAIN['seq']}, masked ({kept} pruned), int8 "
          f"compression, {len(got)} steps: s per step on the 1x1 mesh "
          f"{json.dumps([round(x, 4) for x in secs])} against unsharded "
          f"{json.dumps([round(x, 4) for x in want_secs])}; metrics "
          f"bit-equal at every step: {got == want} (losses "
          f"{json.dumps([m['loss'] for m in got])}); final params bit-equal "
          f"in {len(same)}/{len(plain)} leaves; pruned weights still 0: "
          f"{not moved} ({smi})", flush=True)
    if got != want or not all(math.isfinite(v) for m in got
                              for v in m.values()):
        fail(f"[{tag}] (d) {cfg.name}: the sharded run's metrics {got} "
             f"differ from the unsharded run's {want} or are not finite")
    if len(same) != len(plain) or set(params) != set(plain):
        fail(f"[{tag}] (d) {cfg.name}: final params differ in "
             f"{sorted(set(plain) - set(same))[:6]}")
    if moved or not kept:
        fail(f"[{tag}] (d) {cfg.name}: pruned weights moved: {moved[:4]}")


def scaleout_family(tag: str, smi: str, mesh, name: str, layers: int
                    ) -> int:
    """(d) one family: sharded training and serving against unsharded,
    bit for bit -> the sharded prefill's flash launches."""
    full = get_config(name).num_layers
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    family_train(tag, smi, mesh, cfg, full)
    t_train = time.perf_counter() - t0
    model = LM(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    prompts = torch.randint(
        0, cfg.vocab_size, (SCALEOUT_SERVE["batch"], SCALEOUT_SERVE["prompt"]),
        generator=torch.Generator(device=DEV).manual_seed(5), device=DEV,
        dtype=torch.int32)
    t1 = time.perf_counter()
    want, want_toks, _ = family_serve(model, params, prompts)
    got, toks, (flash, fallbacks) = family_serve(model, params, prompts, mesh)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    same = sum(torch.equal(a, b) for a, b in zip(got, want))
    attn = cfg.family != "ssm"
    print(f"[{tag}] (d) {cfg.name} serving {SCALEOUT_SERVE['batch']} x "
          f"{SCALEOUT_SERVE['prompt']} prompts and "
          f"{SCALEOUT_SERVE['new']} greedy steps on the 1x1 mesh and "
          f"unsharded: logits bit-equal at {same}/{len(want)} steps, tokens "
          f"equal: {torch.equal(toks, want_toks)}; the sharded prefill's "
          f"flash_attention launches {flash} (layers {cfg.num_layers}), "
          f"blockwise fallbacks {fallbacks}; training {t_train:.1f} s, "
          f"serving {t_serve:.1f} s, peak device memory {peak} bytes "
          f"({smi})", flush=True)
    if same != len(want) or not torch.equal(toks, want_toks):
        fail(f"[{tag}] (d) {cfg.name}: sharded serving differs from "
             f"unsharded ({same}/{len(want)} steps' logits equal)")
    if attn and (flash != cfg.num_layers or fallbacks):
        fail(f"[{tag}] (d) {cfg.name}: the sharded prefill launched flash "
             f"{flash} times for {cfg.num_layers} layers, {fallbacks} "
             "fallbacks")
    return flash


def phase_scaleout(smi: str, ref: dict) -> int:
    """[scaleout]: one NCCL rank, a 1 × 1 mesh; (a) sharded training
    bit-equal to [train]'s, (b) a checkpoint across the mesh and none,
    (c) the dry-run on the fake group, started once (a)'s timed steps
    are done (so they run on a quiet host, as [train]'s did) and run
    beside (b) and (d), the families sharded. Returns (d)'s sharded
    prefills' flash launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    tag = "scaleout"
    work = tempfile.TemporaryDirectory(prefix="scaleout-")
    out = os.path.join(work.name, "dryrun")
    t0 = time.perf_counter()
    dry, flash = None, 0
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(work.name, "store"), 1), rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            scaleout_train(tag, smi, mesh, ref)
            t_dry = time.perf_counter()
            dry = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", "qwen2-1.5b", "--shape", "all", "--mesh",
                 "both", "--jobs", str(SCALEOUT["dryrun_jobs"]), "--out",
                 out], env=port_env(), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            scaleout_checkpoint(tag, mesh, ref["cfg"])
            t_fam = time.perf_counter()
            flash = sum(scaleout_family(tag, smi, mesh, name, layers)
                        for name, layers in SCALEOUT_FAMILIES)
            print(f"[{tag}] (d) the families in "
                  f"{time.perf_counter() - t_fam:.1f} s (beside (c)); the "
                  f"sharded prefills' flash launches {flash}", flush=True)
        finally:
            dist.destroy_process_group()
        print(f"[{tag}] (a), (b) and (d) done {time.perf_counter() - t0:.1f} "
              "s into the phase; the process group destroyed", flush=True)
        scaleout_dryrun(tag, smi, dry, out, t_dry)
    finally:
        if dry is not None and dry.poll() is None:
            dry.kill()
            dry.wait()
        work.cleanup()
    return flash


def start_examples() -> tuple:
    """The four ``examples/torch_*.py`` with the reference's defaults, in
    subprocesses started together -> (their start time, the processes).
    They are small (width-0.125 CNNs on 16 x 16, a 2-layer LM), so they
    run beside [pipeline], whose gates are exact: the seconds of both are
    taken under that contention."""
    return time.perf_counter(), {name: subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_WRAP,
         os.path.join(EXAMPLES_DIR, name)], env=port_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES}


def phase_examples(smi: str, started: tuple) -> dict:
    """Waits for ``start_examples``' processes: exit 0, packed tokens
    identical to dense, the LM example's prefills all on the flash kernel,
    the quickstart's packed accuracy equal to its retrained one, the
    distributed example's resumed and elastic loss paths equal (one rank:
    1 × 1 both times, so bit for bit). Returns the kernel launches they
    made."""
    tag = "examples"
    t0, procs = started
    launches = dict.fromkeys(KERNEL_MODS, 0)
    outs = {}
    longest = 0.0
    for name, p in procs.items():
        out, err = p.communicate(timeout=900)
        lines = out.strip().splitlines()
        for line in lines:
            print(f"[{tag}] | {line}", flush=True)
        if p.returncode != 0 or not lines or not lines[-1].startswith(
                "[launches] "):
            fail(f"[{tag}] {name} failed (exit {p.returncode}): "
                 f"{err[-3000:]}")
        doc = json.loads(lines[-1][len("[launches] "):])
        got = doc["launches"]
        print(f"[{tag}] {name}: exit 0, its main {doc['seconds']:.1f} s "
              f"(beside [pipeline]); launches {json.dumps(got)}, blockwise "
              f"fallbacks {doc['fallbacks']}", flush=True)
        longest = max(longest, doc["seconds"])
        for k, v in got.items():
            launches[k] += v
        outs[name] = (out, got, doc["fallbacks"])
    lm, lm_launches, lm_fallbacks = outs["torch_prune_then_serve_lm.py"]
    if ("[serve] packed tokens identical to dense: True" not in lm
            or not lm_launches["pattern_gemm"]
            or not lm_launches["flash_attention"] or lm_fallbacks):
        fail(f"[{tag}] the LM example's packed tokens differ from dense, or "
             f"it never ran pattern_gemm or flash_attention, or a prefill "
             f"fell back to blockwise attention ({lm_fallbacks}): "
             f"{lm_launches}")
    qs, qs_launches, _ = outs["torch_quickstart.py"]
    retrained = re.search(r"retrained pruned model accuracy: (\S+)", qs)
    packed = re.search(r"packed accuracy: (\S+)", qs)
    if (not retrained or not packed or packed.group(1) != retrained.group(1)
            or not qs_launches["pattern_conv"]):
        fail(f"[{tag}] the quickstart's packed accuracy differs from its "
             f"retrained accuracy or never ran pattern_conv: {qs_launches}")
    dx, _, _ = outs["torch_distributed_masked_retraining.py"]
    paths = {k: re.search(rf"^\[{k} 1x1\] .*loss path (\[.*\])$", dx, re.M)
             for k in ("train", "resume", "elastic")}
    if (not all(paths.values()) or "[check]" not in dx
            or paths["resume"].group(1) != paths["elastic"].group(1)):
        fail(f"[{tag}] the distributed example did not train, resume and "
             f"reshard at world size 1 to equal loss paths: {paths}")
    print(f"[time] examples {longest:.1f} s (the longest of the four, run "
          f"together beside [pipeline]: under contention; all done "
          f"{time.perf_counter() - t0:.1f} s after their start)", flush=True)
    print(f"[{tag}] launches {json.dumps(launches)} ({smi})", flush=True)
    return launches


META = {
    "pattern_gemm": ("src/repro_torch/kernels/csrc/pattern_gemm.cu",
                     "src/repro/kernels/pattern_gemm.py:124"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:110"),
    "column_gemm": ("src/repro_torch/kernels/csrc/column_gemm.cu",
                    "src/repro/kernels/column_gemm.py:89"),
    "pattern_conv": ("src/repro_torch/kernels/csrc/pattern_conv.cu",
                     "src/repro/kernels/pattern_conv.py:128"),
}


# one decoder layer's packed GEMMs (wk and wv: two launches)
LAYER_GEMMS = {"wq": 1, "wk/wv": 2, "wo": 1, "w_gate": 1, "w_up": 1,
               "w_down": 1}
TIMES = ("ms", "plain_ms", "bound_ms", "library_ms")


def per_layer(rows: list, M: int) -> dict:
    """One layer's sums of the bf16 GEMM rows at M (``earlier_ms``: the
    WMMA tile's time at the same shapes, in this run)."""
    mine = {r["shape"].split(" ")[0]: r for r in rows
            if r["dtype"] == "bfloat16" and r["shape"].endswith(f" M={M}")}
    return {k: sum(n * (mine[g][k] or 0.0) for g, n in LAYER_GEMMS.items())
            for k in TIMES + ("earlier_ms",)}


def summarize(rows: list, launches: dict, runs: dict) -> list:
    out = []
    for name, (source, replaces) in META.items():
        mine = [r for r in rows if r["kernel"] == name]
        bf16 = [r for r in mine if r["dtype"] == "bfloat16"]
        served = [r for r in bf16 if r["on_path"]]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: sum(r[k] for r in served) for k in TIMES},
            # the same shapes on their routes before wgmma, timed here
            "earlier_ms": sum(r["ms"] if r["earlier_ms"] is None
                              else r["earlier_ms"] for r in served),
            "variants": sorted({r["variant"] for r in served}),
            "bound_by": max(("bytes", "operations"), key=lambda k: sum(
                r["bound_ms"] for r in served if r["bound_by"] == k)),
            "workload": "sum of one bf16 call at each shape its served path "
                        "launches: " + ", ".join(r["shape"] for r in served)
                        + "; launches: " + runs[name],
        }
        off = [r for r in bf16 if not r["on_path"]]
        if off:
            entry["not_on_path"] = [
                {k: r[k] for k in ("shape", "variant", "earlier_ms", *TIMES)}
                for r in off]
        if name.endswith("_gemm"):
            for M in GEMM_MS[1:]:
                entry[f"per_layer_m{M}"] = per_layer(mine, M)
        out.append(entry)
    return out


def main() -> int:
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()

    def timed(tag, fn, *args, note=""):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        print(f"[time] {tag} {time.perf_counter() - t:.1f} s (profile "
              f"retakes {RETAKE_S.get(tag, 0.0):.1f} s{note})", flush=True)
        return out

    with torch.no_grad():
        rows = [r for check in (check_pattern_gemm, check_flash,
                                check_pattern_conv, check_column_gemm)
                for r in timed(check.__name__, check, gen)]
        launches, served = timed("serve", phase_serve, smi)
        timed("identity", phase_identity)
        conv = [timed(path[0], phase_cnn, smi, *path) for path in CNN_PATHS]
        column, column_art = timed("column", phase_column, smi)
        roof = timed("roofline", phase_roofline, smi, served, column_art,
                     rows)
        del column_art
        cont = timed("continuous", phase_continuous, smi, served)
        timed("analyze", phase_analyze, smi)
        spec = timed("speculative", phase_speculative, smi, served)
        tuned = timed("tune", phase_tune, smi, served, rows)
        del served
        win = timed("window", phase_window, smi)
        fam = timed("families", phase_families, smi)
        moe = timed("moe", phase_moe, smi)
        ssm = timed("ssm", phase_ssm, smi)
        admm = timed("admm", phase_admm, smi)
        admm_conv = timed("admm_cnn", phase_admm_cnn, smi)
        examples = start_examples()
        pipe = timed("pipeline", phase_pipeline, smi,
                     note="; beside [examples]: under contention")
        ex = phase_examples(smi, examples)            # prints its [time]
        train_ref = timed("train", phase_train, smi)
    scaleout = timed("scaleout", phase_scaleout, smi, train_ref)
    print(f"[time] all phases {time.perf_counter() - t0:.1f} s", flush=True)
    runs = {
        "pattern_gemm": "tile-pattern qwen2-1.5b serving 8 requests "
                        f"({launches['pattern_gemm']}) + the same artifact "
                        "through ContinuousEngine serving 12 "
                        f"({cont['pattern_gemm']}) + the same artifact "
                        "drafting for its pruned weights, speculative, "
                        f"serving 4 ({spec['pattern_gemm']}) + the same "
                        "artifact tuned, serving 8 "
                        f"({tuned['pattern_gemm']}) + "
                        "h2o-danube-1.8b on a ring cache, chunked, "
                        "continuous and speculative serving 8 + 8 + 4 "
                        f"({win['pattern_gemm']}) + [families]: pixtral-12b "
                        "prefilling 4 x 1024 patch embeddings and decoding "
                        "32 steps, hubert-xlarge encoding 8 x 1500 frames, "
                        "the ADMM-pruned 2-layer pixtral-12b prefilling, "
                        "granite-3-2b and phi4-mini-3.8b serving 8 requests "
                        f"each ({fam['pattern_gemm']}) + [moe]: "
                        "qwen2-moe-a2.7b and deepseek-moe-16b serving 8 "
                        "requests each, qwen2-moe-a2.7b through "
                        "ContinuousEngine serving 6 and speculative serving "
                        "4 with its packed drafter, the ADMM-pruned 2-layer "
                        f"one prefilling ({moe['pattern_gemm']}) + [ssm]: "
                        "hymba-1.5b (block_p 64) and xlstm-1.3b (its head) "
                        "serving 8 requests each, hymba-1.5b's 2 048-token "
                        "prompt wrapping its ring and 8 requests through "
                        "ContinuousEngine, the ADMM-pruned 2-layer hymba "
                        f"prefilling ({ssm['pattern_gemm']}) + the "
                        "ADMM-pruned "
                        f"one serving 4 ({admm['pattern_gemm']}) + the "
                        "pipeline's saved 2-layer one serving 4 "
                        f"({pipe['pattern_gemm']}) + [roofline]: the "
                        "[serve] artifact's 8 distinct leaves profiled at "
                        f"M = 4, 512, 2048 ({roof['pattern_gemm']}) + "
                        "[examples]: the LM example serving 8 requests "
                        f"packed ({ex['pattern_gemm']})",
        "flash_attention": "tile-pattern qwen2-1.5b serving 8 requests "
                           f"({launches['flash_attention']}) + the same "
                           "artifact through ContinuousEngine serving 12 "
                           f"({cont['flash_attention']}) + speculative "
                           "serving of 4 requests, two arms "
                           f"({spec['flash_attention']}) + the tuned "
                           "artifact serving 8 "
                           f"({tuned['flash_attention']}) + "
                           "h2o-danube-1.8b (hd 80, window 4096) on a ring "
                           "cache, chunked, continuous and speculative "
                           f"serving 8 + 8 + 4 ({win['flash_attention']}) "
                           "+ [families]: pixtral-12b (hd 128, causal), "
                           "hubert-xlarge (hd 80, bidirectional, S 1500), "
                           "the ADMM-pruned pixtral-12b, granite-3-2b (hd "
                           "64) and phi4-mini-3.8b "
                           f"({fam['flash_attention']}) + [moe]: "
                           "qwen2-moe-a2.7b and deepseek-moe-16b (MHA 16 / "
                           "16 of 128) serving, continuous and speculative, "
                           "the ADMM-pruned 2-layer one "
                           f"({moe['flash_attention']}) + [ssm]: hymba-1.5b "
                           "(25 / 5 of 64, window 2 048) serving, the "
                           "2 048-token wrap prompt, continuous admissions, "
                           "the ADMM-pruned 2-layer one "
                           f"({ssm['flash_attention']}) "
                           "+ the ADMM-pruned one serving 4 "
                           f"({admm['flash_attention']}) + the pipeline's "
                           f"saved 2-layer one serving 4 "
                           f"({pipe['flash_attention']}) + [examples]: the "
                           "LM example's prefills (4 / 2 heads of 16, the "
                           f"SIMT route) ({ex['flash_attention']}) + "
                           "[scaleout] (d): the 1-layer qwen2-moe-a2.7b's "
                           "and 2-layer hymba-1.5b's sharded prefills on "
                           f"the 1 x 1 mesh ({scaleout})",
        "pattern_conv": "one bf16 forward of VGG-16 at batch 32 "
                        f"({conv[0]}) + one of ResNet-18 at batch 256 "
                        f"({conv[1]}) + one of the ADMM-pruned, retrained "
                        f"VGG-16 at batch 32 ({admm_conv}) + one of the "
                        "pipeline's saved VGG-16 (32 x 32) at batch 64 "
                        f"({pipe['pattern_conv']}) + [roofline]: VGG-16's "
                        "13 packed convs profiled on one 64 x 64 and one "
                        f"256 x 256 image ({roof['pattern_conv']}) + "
                        "[examples]: the quickstart's packed VGG-16 "
                        f"(width 0.125) on 3 batches ({ex['pattern_conv']})",
        "column_gemm": "column-pruned qwen2-1.5b serving 8 requests "
                       f"({column['column_gemm']}) + [roofline]: the "
                       "[column] artifact's 8 distinct leaves profiled at "
                       f"M = 4, 512, 2048 ({roof['column_gemm']})",
    }
    launches = {k: launches[k] + cont[k] + spec[k] + tuned[k] + win[k]
                + fam[k] + moe[k] + ssm[k] + admm[k] + pipe[k] + ex[k]
                + roof.get(k, 0) for k in launches}
    launches["flash_attention"] += scaleout
    launches.update(pattern_conv=sum(conv) + admm_conv
                    + pipe["pattern_conv"] + roof["pattern_conv"]
                    + ex["pattern_conv"],
                    column_gemm=column["column_gemm"] + roof["column_gemm"]
                    + ex["column_gemm"])
    print(smi, flush=True)
    print(json.dumps({"kernels": summarize(rows, launches, runs)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
