#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure raises and exits nonzero:

1. device: the card's name and power limit (nvidia-smi) and the torch
   version; no CUDA device is a failure, never a CPU run.
2. build: the six CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   each, in parallel), ptxas's registers and spills of each kernel, a
   ``[ptxas]`` line per instantiation of the decode GEMM, and the
   ``[sass]`` line: the count of Hopper's wgmma instructions in the SASS
   of the six wgmma kernels (cuobjdump -sass of ``build/torch_ext/``:
   HGMMA in flash_attention, IGMMA in quant_matmul, ternary_matmul,
   split_ternary and ternary_packed, both in split_precision); a count of
   0 or a spill in any kernel fails.
3. kernels vs their plain versions on the card at the serving paths'
   shapes: M in {4, 512} x (K, N) in {(4096, 4096), (4096, 512),
   (4096, 11008), (11008, 4096), (4096, 64000)}.  quant_matmul,
   ternary_matmul and ternary_packed bit for bit, quant_matmul on both
   weight layouts (row-major, and the K-major view the serving paths
   hold) and also at M {17, 100, 300} off its 128-row tile and at N 1000
   off its column tiles; split_ternary bit for bit at boundaries {0, 7,
   128, 300, N} through the op (aligned to the N-block) and at 7 and 300
   through the kernel itself (a column tile that reads both streams);
   ternary_matmul, split_ternary and ternary_packed also on their wgmma
   GEMM at M {17, 100, 300, 512} x the five (K, N) and (11008, 1000), with
   the K-major codes (ternary_matmul at the K split its plan gives), and
   at the long prefill's M 12288 x (4096, 512); split_precision
   at raw boundaries {0, 7, 128, 342, N}, its int8 columns bit for bit and
   its bf16 columns within the float32 summation bound ``K * 2**-24 *
   sum_k |x w| + 2**-24 * |y|``, also at M {16, 17, 100, 300} on the
   K-major codes.  The decode GEMM (M <= 16) of all five int8 kernels at M
   {1, 2, 4, 8, 16} x the five (K, N) and (11008, 1000) on the layouts the
   serving paths hold (split_ternary at every boundary above,
   split_precision at every one of its own), and at K 1000, where the
   K-major codes take the counted pad route.  Split probes: the split
   kernels get garbage in the int8 codes at and above the boundary
   (split_ternary also 0xFF in its packed bytes below it, split_precision
   NaN in its bf16 weights below it), which must not reach the output.
   At the paged engine's chunk rows (`CHUNK_MS`: M 4 x 32 and 4 x 512) x
   the five (K, N) on the K-major codes: quant_matmul, ternary_matmul and
   split_ternary (boundary 7, both probes) bit for bit, split_precision
   (boundary 342) within its bound.
   flash_attention at yi-9b's head shapes (B 4, H 32, KVH 4, D 128): Sq =
   Sk in {128, 3072}, Sq 3072 against Sk 4096 with kv_len 3072, a ragged
   Sq 3000, and one non-causal case whose keys the op pads (Sk 1000 to
   1024), each within `flash_error_bound` (the bf16 rounding of p and of
   the output, and the float32 sums; stated in its docstring).  zamba2-1.2b's
   shapes (phase 10): split_ternary at its five (K, N) (`ZAMBA_RAW`) x M
   {4, 128, 512} at its planned raw boundaries, through the op (aligned)
   and the kernel itself, with both garbage probes, and quant_matmul there
   and at its head (2048, 32000); flash at its heads (B 4, H = KVH 32, D
   64): Sq = Sk 3072, Sq 3000, kv_len 3072 in a 4096 cache, and the long
   leg's Sq = Sk = kv_len 4096, within the bound.  h2o-danube-3-4b's
   shapes (phase 12): split_ternary at its four (K, N) (`DANUBE_RAW`) x M
   {4, 128, 512} at its planned raw boundaries, through the op and the
   kernel itself, with both garbage probes, and quant_matmul there and at
   its head (3840, 32000); flash at its heads (B 2, H 32, KVH 8, D 120) at
   `DANUBE_FLASH_CASES` (Sq = Sk 8192 with the window 4096, a ragged Sq
   3000, kv_len 3072 in a 4096 cache, window 1000, no window), within the
   bound.  nemotron-4-15b's and command-r-35b's new shapes
   (`DENSE_FIXED_KN`: their FFN projections, K up to 24576, which the
   decode GEMM stages in slices of up to 48 chunks, and nemotron's
   (6144, 256000) head) x M {4, 128}: split_ternary at the planned raw
   boundary and quant_matmul, bit for bit.  deepseek-v2-lite-16b's
   shapes (phase 13): split_ternary at its nine (K, N) (`DEEPSEEK_RAW`:
   wq, kv_a, kv_b, wo, the router, the shared experts' up and down, the
   first layer's up and down) x M {4, 128, 512} at its planned raw
   boundaries, through the op and the kernel itself, with both garbage
   probes, and kv_b also at the rows of the gathered latent it expands on
   the paged path (`DEEPSEEK_GATHER_MS`); quant_matmul at its head (2048,
   102400) at M {4, 128}; flash at query / key dim 192 and value dim 128
   (B 4 and 1, H = KVH 16; `DEEPSEEK_FLASH_CASES`: Sq = Sk 3072, Sq 3000,
   kv_len 3072 in a 4096 cache), within the bound.  xlstm-1.3b's shapes
   (phase 14): split_ternary at its four (K, N) (`XLSTM_RAW`: mLSTM's up,
   w_if and down, sLSTM's w_in; sLSTM's down is mLSTM's shape) x M {4,
   128, 512} at its planned raw boundaries, through the op and the kernel
   itself, with both garbage probes (w_if's N 8 lies below every column
   tile: the op's aligned boundary makes all 8 columns int8, the kernel
   splits at 7), ternary_matmul there at M 4 (the bank leg's draft), and
   quant_matmul at its head (2048, 50304) at M {4, 128}; arctic-480b's
   (phase 15): split_ternary at its five (K, N) (`ARCTIC_RAW`: wq and wo,
   wk and wv, the router, the residual FFN's gate / up and down) x M {4,
   128, 512} in the same way, and quant_matmul at its head (7168, 32000);
   llama-3.2-vision-11b's and seamless-m4t-large-v2's (phases 16-17):
   split_ternary at their (K, N) (`FRONTEND`: llama's wq / wo, wk / wv,
   gate / up, down; seamless's attentions', up and down) x M {4, 128, 512,
   4096} (`FRONTEND_MS`: 4 x 1024 frontend rows reach the cross wk / wv
   and every encoder projection) in the same way, and quant_matmul at both
   heads, (4096, 128256) and seamless's odd (1024, 256206), at M {4, 128}.
   Then the entry point of ternary_packed, which no serving path calls, is
   driven once at each of the ten (M, K, N) with the launch counts read
   around that run.
4. times of each kernel and its library yardstick in ROUNDS = 5
   interleaved rounds (kernel, library, kernel, library, ...; the median
   and the range of each printed, share and the factor kernel / library
   from the medians), each round the replay of a CUDA graph of the calls
   between two CUDA events (device time without the host's time between
   launches, which at decode shapes exceeds the kernels'; the eager,
   host-paced time per call is printed beside it), and of its plain
   version once (eager): the
   yardstick is torch._int_mm with the same epilogue, timed on the
   row-major and on the column-major (K-major) int8 weight, the faster
   median taken; on the unpacked codes for ternary_packed; the int8
   kernels read the K-major codes of the serving paths; for
   split_precision "two calls": _int_mm on the int8 columns and a bf16
   torch.matmul on the rest; for flash_attention
   scaled_dot_product_attention with is_causal and enable_gqa.  Beside
   the bound max(bytes / 3.35 TB/s, int8 ops / 1979 TOP/s + bf16 flops /
   989 TFLOP/s) of the H100 SXM data sheet, at the M each layer has on
   the path (the head projects only the last position: M = B at prefill
   as at decode), the diana layers also at the long prefill's M = 4 x
   3072 = 12288, and, for flash_attention, at the long prefill's call (q
   (4, 3072, 32, 128), k / v (4, 4096, 4, 128), causal, kv_len 3072);
   zamba2's split_ternary calls at M {4, 128, 512} and its head, summed
   per decode, chunk and prefill forward (`zamba_layers`), and flash at
   its long leg's call (q (4, 4096, 32, 1, 64), kv_len 4096) x 6 uses;
   h2o's long leg's call (q (2, 8192, 8, 4, 120), k / v (2, 9216, 8, 120),
   kv_len 8192, window 4096) x 24 layers and each of `DANUBE_FLASH_CASES`,
   with SDPA through a boolean window mask where there is a window (PyTorch
   picks a backend that takes a mask; its kernel's name is printed);
   deepseek's long leg's call (q (1, 2560, 16, 1, 192), k (1, 4096, 16,
   192), v (1, 4096, 16, 128) the value half of a (1, 4096, 16, 256) kv_b
   output as `attention.mla` passes it, kv_len 2560) x 27 layers, SDPA on
   the same shapes (the kernel its backend ran is printed: PyTorch's flash backend
   takes no value head dim of its own); xlstm-1.3b's split_ternary calls at
   M {4, 128} and its head, summed per decode and chunk forward.
   Then the split sweep: the wgmma GEMM of split_precision and of
   ternary_matmul at M 512 x (4096, 512) at each K split of SWEEP_SPLITS,
   each checked against the plain version and timed as above.
5. serving: full-width 48-layer yi-9b with random weights from --seed
   (one set of params), mapped three ways and served with ``serve_batch``
   (4 requests x 128 prompt + 16 generated tokens, greedy), which runs the
   paged engine: 4 chunk calls of 4 x 32 tokens, then 15 decode steps;
   one bound backend at a time:
     diana          static min-cost DIANA split: quant_matmul:241
                    split_ternary:96
     gpu_tc_like    static min-cost int8 + fp16 split: quant_matmul:241
                    split_precision:96
     diana_ternary  diana biased ("aimc", 1.0), the all-ternary baseline
                    on the searchable layers: quant_matmul:241
                    ternary_matmul:96
   each at full coverage with launch counts = histogram x 19 forwards,
   and no per-call copy of a weight (the ``transposed_copies`` of
   quant_matmul, split_ternary, ternary_matmul and split_precision and
   ``ternary_packed_matmul.padded_copies`` stay 0 on every serving path
   and in ternary_packed's entry-point run);
   then served again with the plain versions (``reference=True``, no
   launch): tokens and prefill logits identical on the integer paths (the
   logits of every forward are recorded by wrapping the model's
   ``prefill`` / ``prefill_chunk`` / ``decode_step``; the prefill logits
   are those of the chunk call that completes the prompts).  On
   gpu_tc_like, whose bf16 columns sum in another order than the plain
   version, every split_precision call of the kernel run's first chunk is
   checked against the plain version on its own inputs (int8 columns bit
   for bit, bf16 columns within the summation bound), and a third run,
   plain with the bf16 columns summed in float32, measures how far another
   valid summation order moves the prefill logits: the kernel run must lie
   within SENSITIVITY_FACTOR times that of the float64 plain run (tokens
   compared per row up to the first step whose plain top-2 margin is
   below that tolerance).  Then a warm run, and a profiled one: the
   device busy time and idle share of each path.
   diana_long: the same params and diana artifact, 4 requests x 3072
   prompt + 16 generated tokens in a 4096-slot int8 cache, through the
   dense engine (``Engine(kv_layout="dense", max_batch=4, max_len=4096,
   prefill_bucket=3072)``: one admission group, one prefill at M 12288),
   so the prefill (Sq > 2048) takes the chunked path: launch counts
   flash_attention 48 (all in prefill),
   quant_matmul 241 x 16, split_ternary 96 x 16.  Every quant_matmul and
   split_ternary call of the prefill (M 12288) is held bit for bit against
   its plain version on its own inputs as it is made, and each of the 48
   flash calls against the plain version on its own q / k / v within
   `flash_error_bound`.  The matmul kernels being bit-exact, the kernel
   run differs from the plain run (``reference=True``, which also selects
   the flash kernel's plain version) only in flash's summation order; a
   second plain run evaluates attention in float64, another valid
   summation: the kernel run's prefill logits must lie within
   SENSITIVITY_FACTOR times the two plain runs' distance, in max |diff| and
   in RMS, and tokens are compared under the margin rule above (printed
   beside the distance of another request's logits, what an unrelated
   output would show).  Then a warm run (prefill ms, decode ms/step, peak
   GiB).
6. engine: the continuous-batching engine (``repro_torch.serving.Engine``,
   dense KV layout) on the same params and diana artifact, two legs
   (`ENGINE_MIXED`, `ENGINE_LONG`):
     engine_mixed  ``synthetic_trace(6, vocab=64000, min_prompt=64,
                   max_prompt=512, min_new=4, max_new=16, seed=--seed)``
                   restamped by ``poisson_arrivals(rate=0.5)``, 4 slots of
                   1024 positions: slots retire and refill while others
                   decode;
     engine_long   2 requests of 3000 prompt tokens and 2 of 200, 8 new
                   each, all at step 0, 4 slots of 4096: one admission
                   group whose prefill pads to 4096 tokens and takes the
                   chunked (flash) attention with an int kv_len.
   Each leg: every request finishes with its max_new_tokens (or eos);
   launches = histogram x (prefill calls + decode steps), flash 48 per
   long prefill group; 0 weight copies; the same run with the plain
   versions (``reference=True``) gives identical tokens for every request
   on engine_mixed, and on engine_long agrees under the margin rule (flash
   sums in another order); each request alone through a one-slot dense
   engine (the same max_len) agrees under the margin rule.  The margin rule
   compares each request up to its first step whose reference top-2 logit
   margin is below SENSITIVITY_FACTOR times the distance of its prefill
   logits from the reference's (every step where they are bit-identical),
   prints how many tokens it compared, and fails below half of them.  Then
   a warm run (TTFT p50 / p95, decode tok/s, decode steps, prefill calls,
   wall, peak GiB) and a profiled one (device busy time, idle share).
7. paged engine: ``Engine(kv_layout="paged")`` (page_size 16, the prefix
   cache on) on the same params and diana artifact, three legs
   (`ENGINE_PAGED_MIXED`, `ENGINE_PAGED_PREFIX`, `ENGINE_PAGED_LONG`):
     engine_paged_mixed   engine_mixed's trace, 4 slots of 1024, chunks
                          of 32: prefill interleaves with decode;
     engine_paged_prefix  ``synthetic_trace(8, vocab=64000,
                          min_prompt=64, max_prompt=256, min_new=4,
                          max_new=16, seed, shared_prefix=512)`` at step
                          0, 4 slots of 1024, run cold and then warm on
                          one engine (the pool resident), and once with
                          the prefix cache off;
     engine_paged_long    engine_long's requests in chunks of 512 (M
                          2048): the short prompts complete in the first
                          chunk call and decode while the long ones
                          stream in.
   Each recorded run: launches = histogram x (chunk calls + decode steps),
   flash 0 (chunks attend through full attention, as in the JAX package);
   0 weight copies; every request finishes; each request's prefill logits
   and per-step margins are read from the recorded chunk and decode
   calls (its slot is the row whose chunk completes its prompt; every
   token is checked to be its logits' argmax); one `paged_update` call
   (`CAPTURE_CALL`) and its `paged_gather` are repeated on the CPU on the
   same inputs: the pool outside the trash page and the gathered mapped
   rows equal.  Tokens: engine_paged_mixed against engine_mixed's (dense)
   under the margin rule, with the one-slot runs' margins; the prefix
   runs against the prefix-cache-off run under the margin rule; the cold
   run must hit the prefix; engine_paged_long against engine_long's
   kernel run by its distance rule (prefill logits within engine_long's
   tolerance, max and RMS; tokens under the margin rule with its plain
   run's margins), and each short request's first token before each
   long one's.  Then an unrecorded warm run (TTFT, tok/s, chunk calls,
   decode steps x ms/step, kv_peak_bytes against kv_capacity_bytes, peak
   GiB; engine_paged_mixed also profiled: idle share), printed beside the
   dense leg of this run.
8. cnn: the paper's CNNs at full width (`CNN_LEGS`: resnet20 at batch 1
   and 256, resnet18 at 256 and mobilenetv1_025 at 256, on ``diana``;
   resnet20 and mobilenetv1_025 also on ``gpu_tc_like``), random weights
   from --seed, through `launch.serve.serve_cnn`'s path: the artifact
   emitted with the model's plan hints, lowered and bound at full
   coverage, conv layers im2col'd onto the planned kernels (mobilenet's
   depthwise convs zero-embedded, K and N held padded).  Each leg: one
   forward with the launch counts reset just before and read just after
   (= the JAX lowering's histogram, `CNN_HIST`), 0 weight copies, every
   kernel call held against its plain version on its own inputs as it is
   made (bit for bit); logits finite and bit-identical to the plain run's
   (``reference=True``); the distance to the unplanned fp forward
   (F.conv2d) printed, not gated; each kernel's recorded calls of the
   forward replayed as one CUDA graph (device ms per forward, ROUNDS
   rounds) beside their summed bound; CNN_WARM warm forwards (median and
   range, img/s, peak GiB) and a profiled one (device busy, idle share),
   on ``[cnn:<model>:<platform>:B<n>]`` lines beside the nvidia-smi line.
   Each kernel's calls are also timed through PyTorch's library on the
   same inputs (`cnn_library_call`: ``torch._int_mm`` + the epilogue,
   split_precision's two calls) in the same graph rounds.
9. planset: the precision bank (`runtime.PlanSet`) over the same params
   at full width and their first `PLANSET_LAYERS` (12) of 48 layers (the
   stacked leaves' first 12 repeats, views), ``{"target": diana, "draft":
   diana_ternary}`` from phase 5's artifacts filtered to those layers
   (`cut_depth`; `PLANSET_HISTS`: 61 quant_matmul + 24 split_ternary or
   ternary_matmul), served with the config's bf16 KV cache (`PLANSET`: one
   seeded trace of 5 requests, prompts 64-256, 8-16 new tokens, Poisson
   arrivals at 0.5 per step, 4 slots of 1024, pages of 16, chunks of 32):
     bank         bind time, peak memory, `memory_report()`; every layer
                  bound in both variants (`PLANSET_HISTS`) and
                  dedup_saved_bytes > 0;
     target_only  the trace on the bank's default; launches = each
                  forward's variant histogram; a profiled run (device
                  busy; the idle share against the recorded run's wall,
                  whose TTFT and tok/s are the leg's);
     draft_only   the trace under ``plan_variant("draft")``;
     spec         ``speculate=("draft", "target"), draft_k=4``: launches
                  per round 61 (k + 1) quant_matmul + 24 k ternary_matmul
                  + 24 split_ternary beyond the chunk calls, spec_committed
                  = the tokens committed, tokens against target-only under
                  the margin rule (the distance read from each verify
                  chunk's logits against target-only's at the same
                  position and history); acceptance, rounds, TTFT and
                  decode tok/s beside target-only's (no profiled run, for
                  the script's time limit: its idle share is not
                  measured);
     slo          ``slo_routes={"interactive": "draft", "batch":
                  "target"}``, classes alternating by request: each
                  request against its variant's run, ``by_slo`` with both
                  classes;
     degrade      ``degrade_to="draft"`` at a TTFT target a tenth of the
                  target-only p50: at least one transition, degraded
                  requests on the draft and against draft-only, the others
                  against target-only;
     faults       nonfinite_logits, corrupt_page and a 40-step stuck
                  fault on three slots decoding through three steps of the
                  target-only run (`fault_spec`), heartbeat_steps 4:
                  faults_detected >= 2, heartbeat_trips >= 1, every
                  request finished against target-only or shed with
                  reason "fault".
   Each leg's tokens follow its reference under `follow_rule`: the margin
   rule with each request's tolerance SENSITIVITY_FACTOR times its logits'
   distance from the reference over the steps where their histories agree
   (`request_logits` reads each committed token's logits from the
   recorded calls).
10. zamba2: full-width zamba2-1.2b (38 blocks, d_model 2048: 6 x five
   Mamba2 blocks + the shared attention block, and 2 remainder Mamba2
   blocks; vocab 32000), one set of bf16 params from --seed, its diana
   artifact emitted at ``max_cout=ZAMBA_MAX_COUT`` (8384: every
   projection but the head searched; 71 split_ternary layers + the head
   on quant_matmul, the shared block's 7 bound once and run 6 times:
   `ZAMBA_LONG_HIST` = 106 + 1 launches per forward), int8 KV.  For the
   script's time limit every leg but the long one serves the first
   `ZAMBA_REPEATS` (2) repeats and the 2 remainder blocks (14 blocks,
   `cut_depth`: views, the artifacts filtered; `ZAMBA_HIST` = 38 + 1):
     fixed               ``serve_batch`` 4 x 128 + 16 (19 forwards), every
                         planned call held bit for bit against its plain
                         version as it is made (`checking_matmuls`),
                         launches = 19 x `ZAMBA_HIST`, 0 weight copies,
                         tokens against the plain run by the margin rule;
                         a warm run;
     engine_paged_mixed  engine_mixed's trace (at vocab 32000) cut to 4
                         requests (`ZAMBA_MIXED`) through the
                         paged engine (the prefix cache off: recurrent
                         state is not page-resident), and engine_mixed
                         through the dense one: launches = forwards x
                         `ZAMBA_HIST`, each held against its plain run
                         (paged by the margin rule, dense identical), the
                         layouts compared for the record; a warm paged run
                         and a profiled one (idle share);
     long                engine_long's requests (2 x 3000 + 2 x 200, 8
                         new) through the dense engine, 4 slots of 4096,
                         all 38 blocks: one group padded to 4096 tokens
                         whose shared block launches flash at D 64 six
                         times, each call held
                         against the plain version within the bound; the
                         prefill logits within SENSITIVITY_FACTOR x the
                         float64-attention plain run's distance, tokens by
                         the margin rule;
     bank, spec          ``PlanSet({"target": digital 1.0, "draft": aimc
                         0.05})`` (`ZAMBA_BANK_HISTS`), the planset phase's
                         trace shape: target-only, the same with the SSM
                         summed in float64 (its logit distance is the
                         spread), then ``speculate=("draft", "target"),
                         draft_k=4``: against target-only by
                         `spec_step_rule` (the first token's logits
                         equal, every later step's within
                         SENSITIVITY_FACTOR x the spread while the
                         histories agree, tokens by the margin rule),
                         rounds, acceptance and the replay chunks (counted
                         by wrapping ``Engine._replay``; at least one).
11. search: the ODiMO search (`phase_search`) on full-width ResNet20
   (``RESNET20_CFG``: 32 x 32 x 3, widths 16 / 32 / 64, 10 classes) on
   ``diana``: ``SearchPipeline(cnn_handle(cfg), "diana",
   config=SearchConfig(lam, objective="latency"), device="cuda")`` with
   the port's synthetic image stream drawn on the card, SearchConfig's
   batch 64 and 8 eval batches and a quarter of its steps (`SEARCH_STEPS`:
   75 pretrain, 100 search, 75 finetune), at lambda 5e-7 and 1e-9 (same
   seed): per stage its wall and
   first / last loss, the search's last task / reg losses and tau, then
   accuracy, exact latency (cycles), energy, the aimc channel share and
   the mixed layers; latency at 5e-7 must be <= 1.05 x latency at 1e-9.
   The 5e-7 mapping is lowered strictly with the handle, bound at full
   coverage, and one deploy-mode forward of 256 eval images runs with the
   launch counts reset just before and read just after (= the plan's
   histogram), every kernel call held against its plain version as it is
   made, the plain versions' run bit-identical; the deployed accuracy and
   the distance from the finetune-mode logits are printed; then ``python
   -m repro_torch.launch.serve --arch cnn:resnet20 --mapping
   build/chip_smoke/resnet20_searched.json --require-full-coverage`` must
   exit 0.
12. the rest of the dense family, each model freed before the next:
     danube     h2o-danube-3-4b at full width (24 layers, head dim
                120, window 4096, 3.96 B random bf16 params from --seed,
                int8 KV), emitted on diana at ``max_cout=10240`` (every
                projection but the head mixed: `DANUBE_HIST` = 168
                split_ternary + 1 quant_matmul per forward); the legs but
                the long one at its first `DANUBE_LAYERS` (6) layers
                (`cut_depth`: `DANUBE_CUT_HIST` = 42 split_ternary + 1);
                legs fixed
                (serve_batch 4 x 128 + 16: launches = 19 x the histogram,
                the first forward's calls checked as made, tokens and
                prefill logits identical to the plain run's),
                engine_paged_mixed (prefix cache on; `DANUBE_MIXED`:
                engine_mixed's trace cut to 4 requests, against its plain
                run by the margin rule), and long (`DANUBE_LONG`: 1 x 8192
                + 8 in a 9216-slot cache at all 24 layers, one dense
                prefill at M 8192: 24 flash calls at D 120 with the
                window, each within the bound
                on its own inputs; the prefill logits within
                SENSITIVITY_FACTOR x the float64-attention plain run's
                distance, tokens by the margin rule; the window's controls,
                `WINDOW_CONTROLS`: each call's output and the prefill
                logits farther from the plain version and run with another
                window than from the right one);
     nemotron   nemotron-4-15b at full width and depth (15.6 B params) on
                diana at ``max_cout=24576``, the fixed batch only (192
                split_ternary + 1 quant_matmul per forward);
     command_r  command-r-35b at full width, 8 of its 40 layers (all 40
                do not fit the card with their codes), on diana at
                ``max_cout=22528``, the fixed batch only (56 split_ternary
                per forward; the tied head on torch.matmul).
   Each fixed batch: launches = 19 x the histogram, 0 weight copies, the
   first chunk's calls bit-identical to the plain versions, tokens and
   prefill logits identical to the plain run's.
13. deepseek: deepseek-v2-lite-16b at full width and depth (27 layers:
   layer 0 a dense FFN of 10944, then 26 MLA + MoE blocks of 64 routed
   experts top-6 and 2 shared; ~15.7 B random bf16 params from --seed,
   int8 latent cache), emitted on diana at ``max_cout=10944`` (every
   projection but the head mixed: `DEEPSEEK_HIST` = 215 split_ternary + 1
   quant_matmul per prefill or chunk forward, `DEEPSEEK_DECODE_HIST` =
   188 + 1 per decode forward, whose absorbed MLA folds kv_b's weight);
   legs fixed (serve_batch 4 x 128 + 16: launches = 4 x the chunk
   histogram + 15 x the decode one, the first chunk's calls checked as
   made, tokens and prefill logits identical to the plain run's),
   engine_paged_mixed (`DEEPSEEK_MIXED`, 4 requests; the prefix cache
   off, as in the JAX package under MoE; the (token, k) pairs capacity
   dropped over the recorded run; against its plain run by the margin
   rule) and long (`DEEPSEEK_LONG`: 1 x 2560 + 4 in a 4096-slot cache, one
   dense prefill whose 27 layers launch flash at 192 / 128, each call
   within the bound on its own inputs; the prefill logits within
   SENSITIVITY_FACTOR x the float64-attention plain run's distance, tokens
   by the margin rule).  The model is freed before the next phase.
14. xlstm: xlstm-1.3b at full width, `XLSTM_REPEATS` (2) of its 6 repeats
   (16 of 48 blocks: 2 x seven mLSTM blocks + one sLSTM block, d_model
   2048, 4 heads of 1024, vocab 50304; cut for the script's time limit,
   its shapes and kernels the whole model's; random bf16 params from
   --seed; ~235 MB of mLSTM memory per slot), emitted on diana at
   ``max_cout=16384`` (every projection but the head mixed: `XLSTM_HIST` =
   46 split_ternary + 1 quant_matmul per forward); legs fixed (serve_batch 4 x 128 + 16: launches = 19 x the
   histogram, EVERY planned call held bit for bit against its plain
   version as it is made, tokens and prefill logits identical to the plain
   run's, 0 weight copies), engine_paged_mixed (`XLSTM_MIXED`, 4 requests,
   the prefix cache off: recurrent state; against its plain run by the
   margin rule; a warm and a profiled run: idle share) and the bank
   (``PlanSet({"target": diana, "draft": diana biased all-ternary})``,
   `XLSTM_BANK`: target-only, the same with the mLSTM summed in float64
   (its logit distance is the spread), then ``speculate=("draft",
   "target"), draft_k=4`` against target-only by `spec_step_rule`, with
   the replay chunks counted by wrapping ``Engine._replay``: at least one
   replays a partial accept over the restored mLSTM and sLSTM state).
15. arctic: arctic-480b at full width, `ARCTIC_LAYERS` (2) of its 35
   layers (each layer's 128 experts are ~26.8 GB of bf16; the expert
   products are bf16 einsums over all experts, as in the JAX package),
   emitted on diana at ``max_cout=7168`` (`ARCTIC_HIST` = 16 split_ternary
   + 1 quant_matmul per forward), the fixed batch only: every planned call
   checked as it is made, tokens and prefill logits identical to the plain
   run's, the (token, k) pairs capacity dropped in the kernel run, the
   init and serving peak memory.
16. llama: llama-3.2-vision-11b at full width and depth (40 layers: 8 x
   four attention blocks + one gated cross-attention block over the
   request's frontend rows; ~9.8 B random bf16 params from --seed, every
   cross gate set to `LLAMA_GATE` (JAX's init 0 would add nothing); one
   stub frontend row of 1024 x 4096 per request, from --seed), emitted on
   diana at ``max_cout=14336`` (`FRONTEND["llama"]`: 280 split_ternary + 1
   quant_matmul per chunk forward, 264 + 1 per decode forward, whose cross
   blocks read the cached memory); legs fixed (serve_batch 4 x 128 + 16
   with the rows: every planned call held bit for bit against its plain
   version as it is made, tokens and prefill logits identical to the plain
   run's, 0 weight copies; the same batch with zeroed rows must move the
   prefill logits) and engine_paged_mixed (`FRONTEND_MIXED`: engine_mixed's
   trace at 4 requests and prompts 64-256, the prefix cache off, against
   its plain run by the margin rule; a warm and a profiled run: idle
   share).
17. seamless: seamless-m4t-large-v2 at full width and depth (a 24-layer
   encoder over the frontend rows and 24 decoder layers, d_model 1024, 16
   heads of 64, vocab 256206; ~1.6 B random bf16 params), emitted on diana
   at ``max_cout=8192`` (`FRONTEND["seamless"]`: 384 split_ternary + 1
   quant_matmul per chunk forward, the encoder's 144 included: the paged
   engine reruns the encoder over every slot's rows at each chunk, as the
   JAX package does; 192 + 1 per decode forward); the legs of phase 16,
   and the encoder's time over the 4 slots' rows (M 4096).
18. train: the training entry point (``repro_torch.launch.train.main``)
   on zamba2-1.2b at full width and depth (random weights from --seed,
   bf16, float32 AdamW moments; the token task at batch 8 x 512, remat
   on), legs (a) `TRAIN_STEPS` (6) steps, (b) `TRAIN_RESUME_AT` (3) steps
   into an atomic checkpoint under ``build/chip_smoke/train_ckpt``, (c)
   ``--resume`` to step 6 with ``--emit-mapping`` on diana, (d) 3 steps
   with ``--compress-grads``: every loss and grad norm finite, from the
   second step on no gradient leaf all zero (AdamW's input read through a
   shim), (c)'s losses equal to (a)'s steps 3-5 within `TRAIN_RTOL`; step
   ms, tokens/s, peak GiB, the checkpoint's snapshot / write / restore
   times; then the step-6 checkpoint restored onto the card (hashes
   verified), the trained mapping lowered by ``repro_torch.runtime.lower
   .main --arch`` (72 quant_matmul layers: every projection is wider than
   the CLI's max_cout 512) and served at the fixed batch (`fixed_batch`:
   107 launches per forward, every call bit-identical, tokens and prefill
   logits identical to the plain run's), the checkpoint deleted; then
   ResNet20 at full width trained 40 steps at batch 128 with
   ``--emit-mapping`` (the mean loss of the last 5 steps below the first
   5's), its mapping lowered and served through ``launch.serve.main
   --require-full-coverage`` at batch 256, every call held against its
   plain version (`checking_cnn_calls`), launches the plan's.
19. dryrun: the dry run (``repro_torch.launch.dryrun.run_cell``) on the
   card's (1, 1) mesh (`DRY_OVER`, `DRY_FIT`): fake tensors on the card,
   nothing allocated or launched; yi-9b x decode_32k (with ``mapping=``
   phase 5's diana artifact, the report's lines printed) and x
   prefill_32k must need more than the card's 80 GiB; then the roofline
   table of the records at the H100 constants.  Each cell that fits
   (xlstm-1.3b, zamba2-1.2b, h2o-danube-3-4b x long_500k, and xlstm's
   kvwq8) runs for real at full width and depth (`dry_real_step`: params
   from --seed, caches zeroed at 1 x 524,288, one token at 524,287):
   FLOPs and argument bytes equal to the dry run's, the temp within 10 %
   or 256 MiB, the warm step against the roofline's memory term; each
   base cell is then served once planned on diana at that cache length
   (`dry_planned_step`, the plans of phases 10, 12 and 14 at full depth:
   every call bit for bit against its plain version, the launches the
   plan's); the partition plan of yi-9b's diana artifact at tp 8 on the
   DIANA cost model (host only).
20. paper: the paper's deployment and experiments (`phase_paper`).  (a)
   ``ops.odimo_deployed_dense`` (the Fig. 3 reorg: a stable sort of the
   columns by domain on the host, int8 quantization of x and w at
   per-tensor scales, the split_precision kernel, the inverse
   permutation) at yi-9b's widths (`PAPER_KN`: (4096, 4096) and (4096,
   11008)) x M {4, 128, 512} (`PAPER_MS`), each with a seeded random
   assignment (about half the columns bf16, the raw boundary off the
   128-column block), an all-int8 and an all-bf16 one (`PAPER_KINDS`):
   the launch counts reset just before each call and read just after (one
   split_precision, no weight copy), the output held against the plain
   version in the ORIGINAL column order (the columns the aligned boundary
   runs int8 bit for bit, the others within the float32 summation bound);
   the random assignment timed in ROUNDS rounds of CUDA-graph replays
   (the op's device half, its kernel, the library's two calls), beside the
   kernel's bound and the whole op's eager time.  (b)
   ``examples/torch_quickstart.py --fast`` on the card: search on diana,
   artifact round trip, the head deployed through the op (one
   split_precision launch), ``quickstart OK``.  (c) the experiments script
   (``examples/torch_paper_experiments.py``) on full-geometry ResNet20 at
   `PAPER_PRESET` (the medium preset's model, cut steps):
   `PAPER_BASELINE` and one lambda per objective on diana, then Table I;
   every record has the JAX script's keys, the baseline's latency and
   energy equal the port's cost model on its counts, and each Table I
   row's digital + AIMC utilization is at least 1 (the domains run in
   parallel).
21. partitioned: the dry run's partitioned step on the production mesh
   (`start_partitioned`, `phase_partitioned`): ``python -m
   repro_torch.launch.dryrun --mesh production --device cuda`` in
   subprocesses of its own, all started together before phase 19 and read
   after phase 20 (host work on fake tensors, which runs beside those
   phases for the script's time limit; its fake process group of 256 /
   512 ranks never meets phase 19's NCCL group), for `PART_CELLS`: yi-9b x
   decode_32k on the (16, 16) and (2, 16, 16) meshes,
   deepseek-v2-lite-16b x prefill_32k (MoE, the flash stand-in at D 192 /
   Dv 128) and zamba2-1.2b x long_500k.  Each record is ``status`` "ok"
   over 256 / 512 devices with per-device FLOPs, temp, peak and
   collectives; its argument bytes (each shard of the shape DTensor
   computes for the rank) equal the specs-only record's (`run_cell` on the
   mesh shape: `sharding.local_shape` of the specs); zamba2's per-device
   FLOPs are below its phase-19 (1, 1) record's and at least that over
   the device count; then the roofline table of the records with their
   collective term (one device's bytes over the link rate).
22. one JSON line of kernel records, the nvidia-smi line, and the contract
   line ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS picks deterministic algorithms only with a fixed workspace; set
# before torch initialises CUDA so both serving runs execute identically
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12           # H100 SXM data sheet, dense
BF16_FLOPS_PER_S = 989e12          # H100 SXM data sheet, dense
L2_BYTES = 50 * 2**20              # H100 L2 cache
KN_SHAPES = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
             (4096, 64000)]
REQUESTS, PROMPT_LEN, GEN_LEN = 4, 128, 16   # the served traffic
DECODE_M, PREFILL_M = REQUESTS, REQUESTS * PROMPT_LEN
M_SHAPES = [DECODE_M, PREFILL_M]
# the long-prompt traffic (diana_long): yi-9b's whole 4K context; the
# chunked prefill needs a cache length that is a multiple of 1024
LONG_PROMPT, LONG_CACHE = 3072, 4096
LONG_M = REQUESTS * LONG_PROMPT          # rows of its prefill's projections
#: quant_matmul checks off its wgmma tiles (128 rows, 128 or 256 columns)
RAGGED_M = (17, 100, 300)
RAGGED_KN = [(4096, 4096), (11008, 1000)]
#: ternary_matmul / split_ternary / ternary_packed checks on their wgmma
#: GEMM (M > 16): every served (K, N) and N 1000 (padded to 1008 for the
#: packed ones), at these M beside PREFILL_M; and the long prefill's (M, K,
#: N)
PACKED_M = RAGGED_M
PACKED_KN = KN_SHAPES + [(11008, 1000)]
PACKED_LONG = (LONG_M, 4096, 512)
#: raw boundaries the split_ternary kernel also takes unaligned (a column
#: tile the boundary falls in reads both streams)
RAW_BOUNDARIES = (7, 300)
BOUNDARIES = [0, 7, 128, 300, None]      # split_ternary; None = N
SP_BOUNDARIES = [0, 7, 128, 342, None]   # split_precision; None = N
#: the decode GEMM (M <= 16) of the five int8 kernels, checked bit for bit
#: at these M on the layouts the serving paths hold, at every served (K, N)
#: and N 1000 off its column tiles; and its K-padding route at K 1000
DECODE_MS = (1, 2, 4, 8, 16)
DECODE_KN = KN_SHAPES + [(11008, 1000)]
PAD_KN = (1000, 1000)
#: split_precision also at these M (its decode GEMM at 16, its wgmma GEMM
#: above), on the K-major codes, beside M_SHAPES
SP_MS = (16, 17, 100, 300)
#: the paged engine's chunk rows (B x prefill_chunk): 4 x 32 (the default
#: chunk, 2 x page_size 16) on phase 5 and engine_paged_mixed, 4 x 512 on
#: engine_paged_long; the four int8 kernels of the serving paths are
#: checked and the diana path's timed there
CHUNK = 32
CHUNK_MS = (REQUESTS * CHUNK, REQUESTS * 512)
# flash_attention checks at yi-9b's heads (B, H, KVH, D) = (4, 32, 4,
# 128): (Sq, Sk, causal, kv_len); the last one runs through the op, which
# pads Sk to its 512-key block and masks the padded keys
FLASH_HEADS = (REQUESTS, 32, 4, 128)
FLASH_CASES = [(128, 128, True, None), (3072, 3072, True, None),
               (LONG_PROMPT, LONG_CACHE, True, LONG_PROMPT),
               (3000, 3000, True, None), (1000, 1000, False, None)]
KERNELS = {  # name -> (source, the TPU kernel it replaces, ops attribute)
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:49",
                     "quant_matmul"),
    "split_ternary": ("src/repro_torch/csrc/split_ternary.cu",
                      "src/repro/kernels/split_ternary.py:91",
                      "split_ternary"),
    "ternary_matmul": ("src/repro_torch/csrc/ternary_matmul.cu",
                       "src/repro/kernels/ternary_matmul.py:44",
                       "ternary_matmul"),
    "split_precision": ("src/repro_torch/csrc/split_precision.cu",
                        "src/repro/kernels/split_precision.py:71",
                        "split_precision"),
    "ternary_packed": ("src/repro_torch/csrc/ternary_packed.cu",
                       "src/repro/kernels/ternary_packed.py:66",
                       "ternary_packed_matmul"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:81",
                        "flash_attention"),
}
#: the wgmma instructions each wgmma kernel's SASS must hold
SASS_OPS = {"flash_attention": ("HGMMA",), "quant_matmul": ("IGMMA",),
            "ternary_matmul": ("IGMMA",), "split_ternary": ("IGMMA",),
            "ternary_packed": ("IGMMA",),
            "split_precision": ("IGMMA", "HGMMA")}
# serving paths: platform, emission bias, kernel of wk / wv, raw boundary
# of wk / wv (None: one domain)
PATHS = {
    "diana": ("diana", None, "split_ternary", 7),
    "gpu_tc_like": ("gpu_tc_like", None, "split_precision", 342),
    "diana_ternary": ("diana", ("aimc", 1.0), "ternary_matmul", None),
}
#: kernel -> the run its record in the JSON line takes its launches from
LAUNCH_PATH = {"quant_matmul": "diana", "split_ternary": "diana",
               "split_precision": "gpu_tc_like",
               "ternary_matmul": "diana_ternary",
               "ternary_packed": "entry point",
               "flash_attention": "diana_long"}
#: the engine phase's traffic on the diana artifact (engine_mixed: mixed
#: prompt lengths and Poisson arrivals, slots retire and refill while
#: others decode; engine_long: one admission group whose prefill pads to
#: 4096 tokens and takes the chunked (flash) attention).  engine_mixed is
#: cut from 12 requests to 6 for the script's time limit, after the newest
#: phases' traffic was cut: with 12 the script ran 1229.4 s on one H100
#: host and 1041.8 s on another; with 8 (and the cuts below) 1148.5 s on a
#: host whose phases ran 1.3x those of the 1041.8 s one
ENGINE_MIXED = dict(requests=6, min_prompt=64, max_prompt=512, min_new=4,
                    max_new=16, rate=0.5, max_batch=4, max_len=1024,
                    kv_layout="dense")
ENGINE_LONG = dict(prompts=(3000, 3000, 200, 200), new=8, max_batch=4,
                   max_len=4096, kv_layout="dense")
#: the paged engine's legs (phase 7): engine_mixed's traffic under the
#: JAX package's defaults (page_size 16, prefill_chunk 32, prefix cache
#: on); one system prompt of 512 tokens shared by 8 chats, served cold and
#: then warm on one engine; engine_long's requests in chunks of 512
ENGINE_PAGED_MIXED = dict(ENGINE_MIXED, kv_layout="paged")
ENGINE_PAGED_PREFIX = dict(requests=8, min_prompt=64, max_prompt=256,
                           min_new=4, max_new=16, shared_prefix=512,
                           max_batch=4, max_len=1024, kv_layout="paged")
ENGINE_PAGED_LONG = dict(ENGINE_LONG, kv_layout="paged", prefill_chunk=512)
#: the CNN phase (phase 8): the paper's CNNs (Sec. IV-A) at full width,
#: random weights from --seed, served as `launch.serve.serve_cnn` serves
#: them: (model, platform, batch); batch 1 is the edge latency case, 256 a
#: batch of CIFAR-10 (32 x 32), Tiny-ImageNet (64 x 64) or VWW (96 x 96)
#: images
CNN_LEGS = [("resnet20", "diana", 1), ("resnet20", "diana", 256),
            ("resnet20", "gpu_tc_like", 1), ("resnet20", "gpu_tc_like", 256),
            ("resnet18", "diana", 256), ("mobilenetv1_025", "diana", 256),
            ("mobilenetv1_025", "gpu_tc_like", 256)]
#: the JAX package's lowering of each CNN artifact (emitted with the
#: model's plan hints): planned layers per kernel, one launch each per
#: forward
CNN_HIST = {
    ("resnet20", "diana"): {"ternary_matmul": 19, "split_ternary": 3},
    ("resnet20", "gpu_tc_like"): {"split_precision": 22},
    ("resnet18", "diana"): {"ternary_matmul": 20, "split_ternary": 1},
    ("mobilenetv1_025", "diana"): {"quant_matmul": 15, "ternary_matmul": 5,
                                   "split_ternary": 8},
    ("mobilenetv1_025", "gpu_tc_like"): {"quant_matmul": 14,
                                         "split_precision": 14},
}
#: the int8 kernels a CNN path runs, and its timed warm forwards
#: the planset phase's traffic: one seeded trace for every leg (5
#: requests, cut from 8 to hold the phase near 150 s on the card, then
#: from 6 for the script's time limit; fewer would leave the degrade leg
#: no request admitted after its transition; prompts
#: 64-256, 8-16 new tokens, Poisson arrivals at 0.5 per step), 4 slots of
#: 1024 positions in pages of 16, chunks of 32; the faults leg's
#: heartbeat deadline in steps
PLANSET = dict(requests=5, min_prompt=64, max_prompt=256, min_new=8,
               max_new=16, rate=0.5, max_batch=4, max_len=1024,
               page_size=16, prefill_chunk=32, draft_k=4,
               heartbeat_steps=4)
#: the bank's variants: the artifacts of phase 5 they are lowered from,
#: and the kernel histogram each lowers to at the bank's depth
PLANSET_VARIANTS = {"target": "diana", "draft": "diana_ternary"}
#: the bank serves yi-9b at full width and its first 12 of 48 layers (the
#: stacked leaves' first 12 repeats, views; the artifacts filtered to
#: those layers' names): the script's time limit (at all 48 the phase ran
#: 252-299 s on two H100 hosts, host-paced); its shapes and kernels are
#: full width's
PLANSET_LAYERS = 12


def planset_hists(layers):
    """The bank's variants' histograms at ``layers`` yi-9b layers: per
    layer wq, wo, gate, up and down pinned to quant_matmul (c_out > 512),
    wk and wv on the variant's kernel, and the head on quant_matmul."""
    pinned = {"quant_matmul": 5 * layers + 1}
    return {"target": dict(pinned, split_ternary=2 * layers),
            "draft": dict(pinned, ternary_matmul=2 * layers)}


PLANSET_HISTS = planset_hists(PLANSET_LAYERS)
#: zamba2-1.2b (phase 10), full width.  Emitted with max_cout 8384, the
#: widest non-head projection (in_proj: 2 x 4096 + 2 x 64 + 64): with the
#: default 512 every projection (all >= 2048 wide) is pinned to int8, a
#: bias changes nothing, the bank's target and draft coincide and the
#: speculative replay never runs.  At 8384 diana's min-cost split searches
#: every projection but the 32000-wide head.
ZAMBA = "zamba2-1.2b"
ZAMBA_MAX_COUT = 8384
#: its planned projections per forward, (K, N) -> count (32 Mamba2 blocks:
#: in_proj, out_proj; the shared block's 7 projections at 6 uses), and the
#: int8 columns of diana's min-cost split at each (the raw boundary)
ZAMBA_USES = 6
ZAMBA_LAYERS = {(2048, 8384): 32, (4096, 2048): 32,
                (2048, 2048): 4 * ZAMBA_USES, (2048, 8192): 2 * ZAMBA_USES,
                (8192, 2048): ZAMBA_USES}
ZAMBA_RAW = {(2048, 8384): 128, (4096, 2048): 30, (2048, 2048): 30,
             (2048, 8192): 120, (8192, 2048): 30}
ZAMBA_HEAD = (2048, 32000)
#: the long leg serves the whole model (38 blocks): 106 + 1 launches per
#: forward on diana, whose plan holds 60 stacked Mamba2 projections, 4 of
#: the remainder blocks, the shared block's 7 (bound once, run 6 times)
#: and the head
ZAMBA_LONG_HIST = {"quant_matmul": 1, "split_ternary": 106}
ZAMBA_PLAN_HIST = {"quant_matmul": 1, "split_ternary": 71}
#: the other legs serve the first 2 of its 6 repeats and the 2 remainder
#: blocks (14 of 38 blocks; `cut_depth`) at full width, their shapes and
#: kernels those of the whole model (the script's time limit, once phases
#: 16 and 17 came; ROADMAP item 6a).  Cut to 2 repeats the long leg too
#: failed its sensitivity rule on an H100 (the kernel run's prefill logits
#: 4.21 x the float64-attention run's RMS distance, at 2 flash calls), so
#: it keeps all 38 blocks
ZAMBA_REPEATS = 2
_ZAMBA_MAMBA = 2 * (5 * ZAMBA_REPEATS + 2)      # in_proj + out_proj
#: launches per forward of the cut legs: diana, and the bank's digital
#: target and 5 % ternary draft (the head pinned to quant_matmul in all
#: three); the shared block's 7 run once per repeat
ZAMBA_HIST = {"quant_matmul": 1,
              "split_ternary": _ZAMBA_MAMBA + 7 * ZAMBA_REPEATS}
ZAMBA_BANK_HISTS = {"target": {"quant_matmul": sum(ZAMBA_HIST.values())},
                    "draft": dict(ZAMBA_HIST)}
#: the cut plans' layers per kernel
ZAMBA_PLAN_HISTS = {"diana": {"quant_matmul": 1,
                              "split_ternary": _ZAMBA_MAMBA + 7},
                    "target": {"quant_matmul": _ZAMBA_MAMBA + 8},
                    "draft": {"quant_matmul": 1,
                              "split_ternary": _ZAMBA_MAMBA + 7}}
#: split_ternary checked and timed at these M: decode, a paged chunk (4 x
#: 32) and the fixed batch's 512
ZAMBA_MS = (DECODE_M, REQUESTS * CHUNK, PREFILL_M)
#: flash_attention at zamba2's heads (B, H, KVH, D) = (4, 32, 32, 64):
#: (Sq, Sk, causal, kv_len) as for yi-9b, and the long leg's call (its
#: 3000-token group pads to 4096 in a 4096-slot cache)
ZAMBA_FLASH_HEADS = (REQUESTS, 32, 32, 64)
ZAMBA_LONG_SQ = 4096
ZAMBA_FLASH_CASES = [(3072, 3072, True, None), (3000, 3000, True, None),
                     (LONG_PROMPT, LONG_CACHE, True, LONG_PROMPT),
                     (ZAMBA_LONG_SQ, ZAMBA_LONG_SQ, True, ZAMBA_LONG_SQ)]
#: the zamba2 phase's traffic: the fixed batch is phase 5's; the engine
#: legs are engine_paged_mixed's and engine_mixed's cut to 4 requests
#: (the script's time limit: to 8 once phase 12 came, to 4 once phase 13
#: came, each after the newer phase's traffic was cut); the long leg is
#: engine_long's; the bank serves the planset phase's trace shape at its
#: 6 requests
ZAMBA_MIXED = dict(ENGINE_MIXED, requests=4)
ZAMBA_LONG = dict(ENGINE_LONG)
ZAMBA_BANK = dict(PLANSET, requests=6)
#: h2o-danube-3-4b (phase 12), full width and depth: 24 layers, d_model
#: 3840, 32 heads / 8 KV of head dim 120, d_ff 10240, vocab 32000, the
#: sliding window 4096.  Emitted with max_cout 10240 (the FFN's width):
#: diana's min-cost split then searches every projection but the
#: 32000-wide head and mixes all of them (the raw boundary: int8 columns
#: below it, ternary above), so a forward is 7 x 24 split_ternary + 1
#: quant_matmul
DANUBE = "h2o-danube-3-4b"
DANUBE_MAX_COUT = 10240
DANUBE_RAW = {(3840, 3840): 60, (3840, 960): 15, (3840, 10240): 150,
              (10240, 3840): 60}
DANUBE_HEAD = (3840, 32000)
DANUBE_HIST = {"quant_matmul": 1, "split_ternary": 168}
#: the fixed and engine legs at this many of the 24 layers (`cut_depth`;
#: the script's time limit: at full depth they took 53 s of the phase's
#: 79.5 in a call of 1140.2 s of 1200), the long leg at all 24
DANUBE_LAYERS = 6
DANUBE_CUT_HIST = {"quant_matmul": 1, "split_ternary": 7 * DANUBE_LAYERS}
#: split_ternary / quant_matmul checked at these M: decode, a paged chunk
#: (4 x 32) and the fixed batch's 512
DANUBE_MS = (DECODE_M, REQUESTS * CHUNK, PREFILL_M)
#: the phase's engine traffic: engine_mixed's trace cut to 4 requests,
#: through the paged engine only (the script's time limit: with 12
#: requests through both layouts and 2 long prompts the script ran 1128 s
#: and 1290 s of its 1200 s on two H100 hosts; cut from 6 to 4 once phase
#: 13 came)
DANUBE_MIXED = dict(ENGINE_MIXED, requests=4)
#: the long leg: 1 request x 8192 prompt + 8 new in a 9216-slot cache (a
#: multiple of 1024, as the chunked prefill needs), one dense admission
#: group bucketed at 8192: one prefill at M 8192 whose 24 layers launch
#: flash at D 120 with the window
DANUBE_LONG = dict(prompts=(8192,), new=8, max_batch=1, max_len=9216,
                   prefill_bucket=8192, kv_layout="dense")
DANUBE_WINDOW = 4096
#: flash_attention at the long leg's call: (B, H, KVH, D)
DANUBE_LONG_HEADS = (len(DANUBE_LONG["prompts"]), 32, 8, 120)
#: the long leg's controls of the window, name -> (window, factor per
#: flash call, factor on the prefill logits or None): the plain version
#: with the control's window must lie the call's factor x farther from
#: each call's output than the plain version with the right one, and a
#: plain run with it the logits' factor x farther from the kernel run's
#: prefill logits than the plain run.  A kernel that ignored the window,
#: or put its edge a key tile (128 keys) too low, fails them.  Measured
#: on an H100 (PERF.md): per call at least 15.7x (none) and 3.4x (tile),
#: the logits 8.8x (none); a window a tile wider moves the logits only
#: 1.5x the kernel run's distance, so the logits hold the no-window
#: control
WINDOW_CONTROLS = {"none": (None, 4.0, 4.0),
                   "tile": (DANUBE_WINDOW + 128, 2.0, None)}
#: flash_attention at h2o's heads (B, H, KVH, D) = (2, 32, 8, 120):
#: (Sq, Sk, kv_len, window), all causal: the long leg's shape, a ragged
#: Sq, kv_len 3072 in a 4096 cache, a window that is no multiple of the
#: 128-key tile, and D 120 without a window
DANUBE_FLASH_HEADS = (2, 32, 8, 120)
DANUBE_FLASH_CASES = [(8192, 8192, None, DANUBE_WINDOW),
                      (3000, 3000, None, DANUBE_WINDOW),
                      (3072, 4096, 3072, DANUBE_WINDOW),
                      (4096, 4096, None, 1000),
                      (4096, 4096, None, None)]
#: nemotron-4-15b (full width and depth: 32 layers, d_model 6144, 48 / 8
#: heads, d_ff 24576 squared-ReLU ungated, vocab 256000; LayerNorm) and
#: command-r-35b (full width, 8 of its 40 layers: all 40 are ~30.3 B
#: params, ~60.6 GB in bf16, and their int8 codes ~28 GB more, over the
#: card's 80 GB; d_model 8192, 64 / 8 heads, d_ff 22528, vocab 256000,
#: LayerNorm, parallel block, the head tied to the embedding and run by
#: torch.matmul).  Each emitted at max_cout = its d_ff (every projection
#: but the head searched and mixed) and served at the fixed batch:
#: (config name, layers served, max_cout, launches per forward, raw
#: boundary per (K, N), the (K, N) checked in phase 3 beside its head)
DENSE_FIXED = {
    "nemotron": ("nemotron-4-15b", 32, 24576,
                 {"quant_matmul": 1, "split_ternary": 192},
                 {(6144, 6144): 90, (6144, 1024): 15, (6144, 24576): 361,
                  (24576, 6144): 90}),
    "command_r": ("command-r-35b", 8, 22528, {"split_ternary": 56},
                  {(8192, 8192): 120, (8192, 1024): 15, (8192, 22528): 331,
                   (22528, 8192): 120}),
}
#: the (K, N) of phase 3's checks at the fixed-batch models' shapes at M
#: {4, 128}: split_ternary at the raw boundary where DENSE_FIXED has one,
#: quant_matmul at each, nemotron's (6144, 256000) head
DENSE_FIXED_KN = [(6144, 24576), (24576, 6144), (6144, 256000),
                  (8192, 22528), (22528, 8192)]
DENSE_FIXED_MS = (DECODE_M, REQUESTS * CHUNK)
#: deepseek-v2-lite-16b (phase 13), full width and depth: 27 layers (layer
#: 0 a dense FFN of 10944, then 26 MLA + MoE blocks: 64 routed experts
#: top-6 of d_ff 1408 and 2 shared), d_model 2048, 16 heads, MLA latent
#: 512 + rope 64 (query / key dim 128 + 64, value dim 128), vocab 102400.
#: Emitted with max_cout 10944 (the first layer's FFN width): diana's
#: min-cost split searches every projection but the 102400-wide head and
#: mixes all of them (raw boundaries from the cost model, computed on the
#: CPU), so a prefill or chunk forward is 26 x 8 (wq, kv_a, kv_b, wo, the
#: router, the shared experts' gate / up / down) + 7 (the first layer's
#: attention and FFN) split_ternary + 1 quant_matmul; the absorbed decode
#: folds kv_b's weight instead of running its planned layer, so a decode
#: forward launches 27 split_ternary fewer.  The routed experts' einsums
#: are torch.einsum in bf16, as in the JAX package (jnp, no Pallas kernel)
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_MAX_COUT = 10944
DEEPSEEK_RAW = {(2048, 3072): 45, (2048, 576): 15, (512, 4096): 60,
                (2048, 2048): 30, (2048, 64): 7, (2048, 2816): 45,
                (2816, 2048): 30, (2048, 10944): 165, (10944, 2048): 30}
#: the planned layer of repeat 0 (or of the first layer) each (K, N) of
#: `DEEPSEEK_RAW` is read from
DEEPSEEK_LAYERS = ("units/0/attn/wq@0", "units/0/attn/kv_a@0",
                   "units/0/attn/kv_b@0", "units/0/attn/wo@0",
                   "units/0/moe/router@0", "units/0/moe/shared/up@0",
                   "units/0/moe/shared/down@0", "first_dense/ffn/up",
                   "first_dense/ffn/down")
DEEPSEEK_HEAD = (2048, 102400)
DEEPSEEK_HIST = {"quant_matmul": 1, "split_ternary": 215}
DEEPSEEK_DECODE_HIST = {"quant_matmul": 1, "split_ternary": 188}
#: split_ternary checked at these M (decode, a paged chunk, the fixed
#: batch's 512) and kv_b also at the rows of the latent it expands on the
#: paged path: slots x slot capacity (the fixed batch's 4 x 144, the mixed
#: leg's 4 x 1024)
DEEPSEEK_MS = (DECODE_M, REQUESTS * CHUNK, PREFILL_M)
DEEPSEEK_GATHER_MS = (REQUESTS * (PROMPT_LEN + GEN_LEN), REQUESTS * 1024)
#: the phase's engine traffic: engine_mixed's trace cut to 4 requests,
#: through the paged engine only (prefix cache off under MoE); the
#: script's time limit: with h2o's 6 requests the phase ran 73.9 s on an
#: H100, 60 s of it in the engine legs, which put the script at ~1085 s
#: on the host of PR 25's final 1000.9 s call, over its ~1080 s budget
DEEPSEEK_MIXED = dict(ENGINE_MIXED, requests=4)
#: the long leg: 1 request x 2560 prompt + 4 new in a 4096-slot cache, one
#: dense admission group bucketed at 2560: one prefill at M 2560 (over
#: 2048, so chunked) whose 27 layers launch flash at query / key dim 192,
#: value dim 128; cut from 3072 for the script's time limit (with 3072 and
#: the 4-request trace the script ran 1081.5 s on an H100, over its ~1080 s
#: budget)
DEEPSEEK_LONG = dict(prompts=(2560,), new=4, max_batch=1, max_len=4096,
                     prefill_bucket=2560, kv_layout="dense")
DEEPSEEK_DIMS = (192, 128)
#: MLA's rope part of the query / key dim (192 = 128 nope + 64 rope)
DEEPSEEK_ROPE = 64
#: flash_attention at deepseek's heads (H = KVH 16, D 192, Dv 128), B 4
#: and 1: (Sq, Sk, kv_len), causal: Sq = Sk 3072, a ragged Sq 3000, kv_len
#: 3072 in a 4096 cache
DEEPSEEK_FLASH_HEADS = [(REQUESTS, 16, 16, 192), (1, 16, 16, 192)]
DEEPSEEK_FLASH_CASES = [(3072, 3072, None), (3000, 3000, None),
                        (3072, 4096, 3072)]
#: xlstm-1.3b (phase 14), full width and depth: 48 blocks, 6 repeats of
#: seven mLSTM blocks and one sLSTM block, d_model 2048, 4 heads of
#: d_inner / 4 = 1024, vocab 50304.  Emitted with max_cout 16384 (sLSTM's
#: w_in, the widest projection but the head; at the default 512 every
#: projection would be pinned to int8): diana's min-cost split then
#: searches every projection but the 50304-wide head and mixes all of
#: them, raw boundaries from the cost model (computed on the CPU, equal in
#: the JAX package's min_cost): mLSTM's up (2048, 8192), w_if (4096, 8)
#: and down (4096, 2048), sLSTM's w_in (2048, 16384) and down (4096,
#: 2048); a forward is 42 x 3 + 6 x 2 = 138 split_ternary + 1 quant_matmul
#: (w_if's 8 columns lie below every column tile: the aligned boundary
#: makes all 8 int8, through split_ternary).  The block-diagonal q / k / v,
#: the conv and sLSTM's recurrent mixing are plain PyTorch, as in the JAX
#: package (jnp, no Pallas kernel)
XLSTM = "xlstm-1.3b"
XLSTM_MAX_COUT = 16384
XLSTM_RAW = {(2048, 8192): 120, (4096, 8): 7, (4096, 2048): 30,
             (2048, 16384): 240}
#: the planned layers of repeat 0 the raw boundaries are read from, and the
#: layers per forward at each (K, N)
XLSTM_NAMES = ("units/0/core/up@0", "units/0/core/w_if@0",
               "units/0/core/down@0", "units/7/core/w_in@0",
               "units/7/core/down@0")
XLSTM_LAYERS = {(2048, 8192): 42, (4096, 8): 42, (4096, 2048): 48,
                (2048, 16384): 6}
XLSTM_HEAD = (2048, 50304)
#: the phase serves the first 2 of the 6 repeats (16 of 48 blocks) at full
#: width, their shapes and kernels those of the whole model (the script's
#: time limit, once phases 16 and 17 came; ROADMAP item 6a): 23
#: split_ternary per repeat (7 mLSTM blocks x 3 + sLSTM's 2)
XLSTM_REPEATS = 2
XLSTM_HIST = {"quant_matmul": 1, "split_ternary": 23 * XLSTM_REPEATS}
#: the bank leg's draft, diana biased all-ternary: its searchable layers on
#: ternary_matmul (its decode steps at M <= 4 on xLSTM's (K, N))
XLSTM_DRAFT_HIST = {"quant_matmul": 1,
                    "ternary_matmul": 23 * XLSTM_REPEATS}
#: split_ternary checked at these M (decode, a paged chunk, the fixed
#: batch's 512) and timed at the first two; ternary_matmul checked at the
#: draft's decode M
XLSTM_MS = (DECODE_M, REQUESTS * CHUNK, PREFILL_M)
#: the engine leg: engine_mixed's trace cut to 4 requests, paged only
#: (the prefix cache off: recurrent state); the bank leg: the planset
#: phase's trace shape at 4 requests (each slot's snapshot clones ~707 MB
#: of recurrent state).  At 2 requests the rounds replayed partial accepts
#: on an H100, but one request's tokens parted from target-only's at its
#: first small-margin step, which left `spec_step_rule` 11 of 25 tokens to
#: compare, under its half
XLSTM_MIXED = dict(ENGINE_MIXED, requests=4)
XLSTM_BANK = dict(PLANSET, requests=4)
#: arctic-480b (phase 15), full width, 2 of its 35 layers: each layer's 128
#: experts x 3 x 7168 x 4864 are ~26.8 GB of bf16 (as the JAX package's
#: jnp einsums, the port's expert products read all of them), so the card
#: holds 2 layers (~55 GB with attention, the dense residual FFN, the
#: embedding and the head; 3 are ~83 GB).  d_model 7168, 56 heads / 8 KV of
#: head dim 128, 128 experts top-2 of d_ff 4864 beside a dense residual
#: FFN of 4864, vocab 32000.  Emitted with max_cout 7168 (d_model, the
#: widest projection but the head): a forward is 2 x 8 split_ternary (wq,
#: wk, wv, wo, the router, the residual FFN's gate, up and down) + 1
#: quant_matmul
ARCTIC = "arctic-480b"
ARCTIC_LAYERS = 2
ARCTIC_MAX_COUT = 7168
ARCTIC_RAW = {(7168, 7168): 105, (7168, 1024): 15, (7168, 128): 7,
              (7168, 4864): 75, (4864, 7168): 105}
ARCTIC_NAMES = ("units/0/attn/wq@0", "units/0/attn/wk@0",
                "units/0/moe/router@0", "units/0/ffn/up@0",
                "units/0/ffn/down@0")
ARCTIC_HEAD = (7168, 32000)
ARCTIC_HIST = {"quant_matmul": 1, "split_ternary": 16}
ARCTIC_MS = (DECODE_M, REQUESTS * CHUNK, PREFILL_M)
#: the frontend archs (phases 16 and 17), full width and depth, each
#: request with one stub frontend row of 1024 x d_model drawn from --seed.
#: llama-3.2-vision-11b: 40 layers (8 repeats of four attention blocks and
#: one gated cross-attention block), d_model 4096, 32 heads / 8 KV of 128,
#: d_ff 14336, vocab 128256.  seamless-m4t-large-v2: a 24-layer encoder
#: over the rows and 24 decoder layers (self-attention, cross-attention to
#: the encoder's memory, FFN), d_model 1024, 16 heads of 64, d_ff 8192
#: (GELU, LayerNorm), vocab 256206 (odd: the head's N is no multiple of a
#: column tile or of a 16-byte row).  Each is emitted on diana at max_cout
#: its widest non-head projection, so every projection but the head mixes:
#: (name, max_cout, launches per prefill / chunk forward, per decode
#: forward, raw boundaries by (K, N), the plan layers they are read from,
#: the head's (K, N)).  A decode forward runs no cross wk / wv: the
#: memory is cached (llama 8 x 2, seamless 24 x 2 fewer); a seamless chunk
#: forward runs the encoder (24 x 6) over every slot's rows
FRONTEND = {
    "llama": ("llama-3.2-vision-11b", 14336,
              {"quant_matmul": 1, "split_ternary": 280},
              {"quant_matmul": 1, "split_ternary": 264},
              {(4096, 4096): 60, (4096, 1024): 15, (4096, 14336): 210,
               (14336, 4096): 60},
              ("units/0/attn/wq@0", "units/3/attn/wk@0", "units/0/ffn/up@0",
               "units/0/ffn/down@0"),
              (4096, 128256)),
    "seamless": ("seamless-m4t-large-v2", 8192,
                 {"quant_matmul": 1, "split_ternary": 384},
                 {"quant_matmul": 1, "split_ternary": 192},
                 {(1024, 1024): 15, (1024, 8192): 120, (8192, 1024): 15},
                 ("enc_units/0/attn/wq@0", "units/0/xattn/wk@0",
                  "units/0/ffn/up@0", "units/0/ffn/down@0"),
                 (1024, 256206))}
#: split_ternary checked at these M: decode, a paged chunk, the fixed
#: batch's 512, and the frontend rows' 4 x 1024 (cross wk / wv, and every
#: encoder projection)
FRONTEND_MS = (DECODE_M, REQUESTS * CHUNK, PREFILL_M, REQUESTS * 1024)
#: llama's cross-attention gates: JAX's init (0) adds nothing, so both
#: runs set every gate to this value, where the rows move the logits
LLAMA_GATE = 1.0
#: each phase's engine leg: engine_mixed's trace cut to 4 requests and
#: prompts of at most 256 tokens (the script's time limit: with xlstm cut
#: to 2 repeats and zamba2's legs but the long one, the script still ran
#: ~900 s on an H100; 256 halves the chunk calls), paged (the prefix cache
#: off, as in the JAX package for frontend archs)
FRONTEND_MIXED = dict(ENGINE_MIXED, requests=4, max_prompt=256)
CNN_KERNELS = ("quant_matmul", "ternary_matmul", "split_ternary",
               "split_precision")
CNN_WARM = 5
#: the search phase: full-width ResNet20 on diana, the latency objective
#: at two lambdas (the deployed mapping's first), SearchConfig's batch 64
#: and 8 eval batches, a quarter of its steps (300 / 400 / 300) in both
#: runs: an eager search step is ~21,500 ATen calls, ~100 ms of host time
#: on the card (at four fifths of the steps the phase took 132 s; halved,
#: 91.7-131.8 s over four H100 hosts, before the script's time limit asked
#: for the second halving; a CPU run at a quarter keeps the lambda check's
#: latency ratio at 0.25); and the deploy forward's batch
SEARCH_LAMS = (5e-7, 1e-9)
SEARCH_STEPS = dict(pretrain_steps=75, search_steps=100,
                    finetune_steps=75)
SEARCH_DEPLOY_BATCH = 256
#: the training phase (18): zamba2-1.2b at full width and depth through
#: ``repro_torch.launch.train.main``, the token task at batch 8 x 512
#: tokens (under 2048: no flash under autograd), (a) `TRAIN_STEPS`
#: uninterrupted steps, (b) `TRAIN_RESUME_AT` steps into a checkpoint,
#: (c) a resume to `TRAIN_STEPS`, (d) `TRAIN_RESUME_AT` steps with int8
#: gradient compression.  The warmup covers (b)'s steps, so their learning
#: rates do not depend on the run's length and (c) continues (a)'s run.
#: (c) emits the diana mapping at the CLI's default max_cout 512, where
#: every zamba2 projection is wider: 107 quant_matmul per forward (72
#: plan layers: the shared block's seven serve its 6 uses)
TRAIN_SHAPE = dict(batch=8, seq=512)
TRAIN_STEPS, TRAIN_RESUME_AT, TRAIN_WARMUP = 6, 3, 3
TRAIN_RTOL = 2e-4                  # tests/test_elastic.py's resume tolerance
TRAIN_ZAMBA_PLAN = {"quant_matmul": 72}
TRAIN_ZAMBA_HIST = {"quant_matmul": 107}
#: ResNet20 at full width on the image task, then served at batch 256
TRAIN_CNN = dict(name="resnet20", steps=40, batch=128, lr=1e-3, warmup=5,
                 serve_batch=256)
#: the paged_update call (0-based, 96 per forward: k and v of 48 layers)
#: whose inputs each paged leg holds against the CPU: layer 5's k in the
#: third forward
CAPTURE_CALL = 2 * 96 + 10
# Kernel vs plain prefill logits on gpu_tc_like.  A bf16 column of
# split_precision differs from the plain value by ~1e-6 relative, which
# moves a bf16-rounded wk / wv output by one bf16 step now and then; every
# layer requantizes its activations and the KV cache to int8, where such a
# step can move a code, so the difference cascades through the 48 layers.
# Its size is the model's, not the kernel's: another valid summation order
# (float32 instead of float64, in the plain version) moves the logits as
# far.  The kernel run must stay within this factor of that distance.
SENSITIVITY_FACTOR = 4.0


def path_layers(path, prefill_m=PREFILL_M):
    """yi-9b layers per forward on ``path``: (K, N) -> (kernel, count, rows
    at a prefill of ``prefill_m`` tokens); every layer has M = B rows at
    decode."""
    kv = PATHS[path][2]
    return {(4096, 4096): ("quant_matmul", 96, prefill_m),    # wq, wo
            (4096, 512): (kv, 96, prefill_m),                 # wk, wv
            (4096, 11008): ("quant_matmul", 96, prefill_m),   # gate, up
            (11008, 4096): ("quant_matmul", 48, prefill_m),   # down
            # the head projects only each row's last position
            (4096, 64000): ("quant_matmul", 1, DECODE_M)}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(log):
    """[(entry function, registers, spill bytes)] of one ``nvcc -Xptxas -v``
    report, in the order ptxas compiled them."""
    import re
    out, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
            fn = None
    return out


def entry_name(mangled):
    """A short name of a kernel entry: ``gemv<MT, Src>`` for the decode
    GEMM's instantiations, else the mangled name's first 48 characters."""
    import re
    if "i8gemv4gemv" in mangled:
        mt = re.search(r"gemvILi(\d+)E", mangled)
        src = re.search(r"(KMajorCodes|PackedStream|SplitTernary|"
                        r"SplitPrecision)", mangled)
        return (f"gemv<{mt.group(1) if mt else '?'}, "
                f"{src.group(1) if src else '?'}>")
    return mangled[:48]


def phase_sass(torch):
    """The ``[sass]`` line: Hopper's wgmma instructions in the SASS of the
    wgmma kernels' libraries as built (HGMMA in flash_attention, IGMMA in
    quant_matmul, ternary_matmul, split_ternary and ternary_packed, both in
    split_precision), with ptxas's registers and spills of their kernels,
    and a ``[ptxas]`` line per decode GEMM instantiation (registers,
    spills); fails if an instruction count is 0 or any kernel of any
    library spills."""
    import shutil
    from repro_torch.kernels import _build
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    paths = _build.build_all(tuple(KERNELS))
    parts, counts, spilled = [], {}, []
    for kernel in KERNELS:
        entries = ptxas_entries(_build.PTXAS_REPORT.get(kernel, ""))
        spilled += [(kernel, entry_name(f), b) for f, _, b in entries if b]
        for fn, regs, spill in entries:
            if "i8gemv4gemv" in fn:
                print(f"[ptxas] {kernel:<15s} {entry_name(fn):<28s} "
                      f"registers {regs}, spill bytes {spill}")
        if kernel not in SASS_OPS:
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(paths[kernel])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts[kernel] = {op: sass.count(op + ".") for op in SASS_OPS[kernel]}
        parts.append(f"{kernel} " + " ".join(
            f"{op} {n}" for op, n in counts[kernel].items()) +
            f" (ptxas: registers "
            f"{'/'.join(str(r) for _, r, _ in entries) or 'not rebuilt'} "
            f"per kernel, spill bytes {sum(b for _, _, b in entries)})")
        if not all(counts[kernel].values()):
            raise AssertionError(f"{kernel}: {counts[kernel]} in the SASS")
    print("[sass] " + "; ".join(parts))
    if spilled:
        raise AssertionError(f"kernels spill: {spilled}")
    return counts


#: phase 4 times each kernel and its yardstick in this many interleaved
#: rounds (kernel, library, kernel, library, ...) and keeps the medians
ROUNDS = 5


def cuda_ms(fn, iters):
    """Mean ms of ``fn()`` over ``iters`` launches, after 3 warm-up calls
    (eager: the host's time between launches included)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_timer(fn, calls):
    """``(timer, graph)``: ``calls`` calls of ``fn`` captured as one CUDA
    graph (after two warm-up calls); ``timer()`` replays it between two
    CUDA events and returns the ms per call -- the device time of the
    calls' launches back to back, without the host's time between them,
    which at small shapes exceeds the kernels' (the eager times).  The
    warm-up runs on the current stream: PyTorch keeps a cuBLAS workspace
    for every stream that runs a matmul, so a side stream per timer would
    hold memory through the serving phases (their peak)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()

    def timer():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / calls
    timer()
    return timer, graph


def graph_rounds(fns, calls):
    """``{name: [ms per call of each round]}``: each ``fns[name]`` captured
    once (`graph_timer`), then ROUNDS rounds replaying every graph in turn
    (kernel, library, kernel, library, ...)."""
    timers = {name: graph_timer(fn, calls) for name, fn in fns.items()}
    out = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, (timer, _) in timers.items():
            out[name].append(timer())
    del timers
    return out


def median(xs):
    ys = sorted(xs)
    return ys[len(ys) // 2] if len(ys) % 2 else \
        (ys[len(ys) // 2 - 1] + ys[len(ys) // 2]) / 2


def spread(rec, key, xs):
    """rec[key] = the median of ``xs``; its range under the key with "ms"
    replaced by "min_ms" / "max_ms"."""
    pre = key[:-len("ms")]
    rec[key] = median(xs)
    rec[pre + "min_ms"], rec[pre + "max_ms"] = min(xs), max(xs)


def operands(m, k, n, raw_boundary, gen):
    """int8 activations, per-domain weight codes (int8 below the raw
    boundary, ternary at and above it), the packed ternary stream and
    positive steps, as `runtime.execute.prepare_layer` lays them out."""
    import torch
    from repro_torch.kernels.ternary_packed import pack_ternary
    dev = gen.device
    x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w8 = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)
    wt = torch.randint(-1, 2, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)
    cols = torch.arange(n, device=dev)[None, :]
    w_q = torch.where(cols < raw_boundary, w8, wt)
    w_p = pack_ternary(torch.where(cols >= raw_boundary, wt, 0))
    sx = torch.rand((), generator=gen, device=dev) * 0.1 + 0.01
    sw = torch.rand((n,), generator=gen, device=dev) * 0.5 + 1e-3
    return x, w_q, w_p, sx.to(torch.float32), sw.to(torch.float32)


def bound_ms(m, k, n, weight_bytes, int8_cols=None, bf16_cols=0):
    """Least time of the H100 SXM for the call, and what bounds it: each
    input read once (the int8 activations if any column is int8, the bf16
    ones if any is bf16, the weights, sw, sx), the output written once,
    against 2*M*K int8 operations per int8 column plus 2*M*K bf16
    operations per bf16 column."""
    int8_cols = n if int8_cols is None else int8_cols
    act = (m * k if int8_cols else 0) + (2 * m * k if bf16_cols else 0)
    nbytes = act + weight_bytes + 4 * n + 4 + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2.0 * m * k * int8_cols / INT8_OPS_PER_S +
             2.0 * m * k * bf16_cols / BF16_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound_ms(B, H, KVH, Sq, kv_end, D, causal=True, window=None,
                   Dv=None):
    """Least time of the H100 SXM for one flash_attention call, and what
    bounds it: 2 * (D + Dv) bf16 flops per attended (query, key) pair
    (``sum_i min(i + 1, window, kv_end)`` per head when causal; D the real
    query / key head dim, 120 for h2o-danube, not the 128 the kernel lays
    it out as; Dv the value head dim, D unless given: 128 beside MLA's
    192) against q read and o written once plus the k / v rows some query
    reads (``min(kv_end, Sq)`` when causal), all bf16."""
    Dv = D if Dv is None else Dv
    if causal:
        full = min(Sq, kv_end)
        rows = full
        if window is None:
            pairs = full * (full + 1) // 2 + (Sq - full) * kv_end
        else:   # row i reads keys max(0, i - window + 1) .. min(i, kv_end - 1)
            pairs = sum(max(0, min(i, kv_end - 1) - max(0, i - window + 1)
                            + 1) for i in range(Sq))
    else:
        pairs, rows = Sq * kv_end, kv_end
    t_ops = 2.0 * (D + Dv) * B * H * pairs / BF16_FLOPS_PER_S * 1e3
    nbytes = 2 * (B * H * Sq * (D + Dv) + B * KVH * rows * (D + Dv))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_operands(torch, B, H, KVH, Sq, Sk, D, gen, layout="bhsd",
                   Dv=None):
    """bf16 q, k, v with q ~ N(0, 9) (so that each softmax row is peaked,
    as a trained model's are, and a wrong key or mask moves the output by
    far more than the bound), k, v ~ N(0, 1); ``layout`` "bhsd": q (B, H,
    Sq, D), k / v (B, KVH, Sk, D); "model": q (B, Sq, KVH, G, D), k / v
    (B, Sk, KVH, D).  v's head dim is ``Dv`` when given (MLA: 128 beside
    D 192)."""
    dev = gen.device
    shapes = ((B, H, Sq, D), (B, KVH, Sk, D)) if layout == "bhsd" else \
        ((B, Sq, KVH, H // KVH, D), (B, Sk, KVH, D))
    q = torch.randn(shapes[0], generator=gen, device=dev) * 3.0
    k = torch.randn(shapes[1], generator=gen, device=dev)
    v = torch.randn(shapes[1][:-1] + (Dv or D,), generator=gen, device=dev)
    return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)


def check_flash(torch, q, k, v, got, causal, kv_len, what, window=None):
    """One flash_attention output against the plain version on the same
    (B, H, S, D) operands within `flash_error_bound`; returns (max |err|,
    max err / bound)."""
    from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                     flash_error_bound)
    want = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                 window=window)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    bound = flash_error_bound(q, k, v, want, kv_len=kv_len)
    ratio = float((err / bound).max())
    if not bool(torch.isfinite(got).all()) or not bool((err <= bound).all()):
        raise AssertionError(f"flash_attention {what}: max error / bound "
                             f"{ratio:.4g} (max |err| {float(err.max())})")
    return float(err.max()), ratio


def aligned(raw, n):
    """The boundary the ops split at: rounded up to the N-block, clamped."""
    from repro_torch.kernels import ops
    return min(ops.align_boundary(raw, ops.block_n(128, n)), n)


def split_precision_case(torch, m, k, n, raw, gen):
    """Operands of one split_precision check or timing: the clean ones and
    the split probe (w_q 99 at and above the aligned boundary, w_bf16 NaN
    below it); returns (args before the weights, clean w, probe w, sw,
    aligned boundary).  The bf16 operands have yi-9b's magnitudes
    (unit-scale activations, 0.02-scale weights)."""
    x_q, w_q, _, sx, sw = operands(m, k, n, n, gen)
    x = torch.randn((m, k), generator=gen, device=gen.device)
    w_b = torch.randn((k, n), generator=gen, device=gen.device) * 0.02
    x, w_b = x.to(torch.bfloat16), w_b.to(torch.bfloat16)
    b_al = aligned(raw, n)
    cols = torch.arange(n, device=x.device)[None, :]
    probe_q = torch.where(cols < b_al, w_q, 99).to(torch.int8)
    probe_b = torch.where(cols >= b_al, w_b,
                          float("nan")).to(torch.bfloat16)
    return (x, x_q, sx), (w_b, w_q), (probe_b, probe_q), sw, b_al


def phase_kernels(torch, gen):
    """Checks at every listed shape; returns {kernel: max |error|}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_precision import (bf16_error_bound,
                                                     split_precision_plain)
    from repro_torch.kernels.split_ternary import (split_ternary,
                                                   split_ternary_plain)
    from repro_torch.kernels.ternary_matmul import ternary_matmul_plain
    from repro_torch.kernels.ternary_packed import ternary_packed_plain
    worst = dict.fromkeys(KERNELS, 0.0)

    def exact(kernel, got, want, what, quiet=False):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst[kernel] = max(worst[kernel], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {what}: max |err| {err}")
        if not quiet:
            print(f"[kernels] {kernel:<15s} {what} bit-identical")

    def split_probes(m, k, n, raw, layout, quiet=False, kernel_raw=False):
        """split_ternary through the op (boundary aligned to the N-block)
        and, at a raw boundary of RAW_BOUNDARIES (or with ``kernel_raw``),
        the kernel itself at that column; w_q holds 99 at and above the
        boundary, the packed stream 0xFF (a 2 in every 2-bit field) below
        it: neither may reach the output."""
        shape = f"M={m:<5d} K={k:<6d} N={n:<6d}"
        x, w_q, w_p, sx, sw = operands(m, k, n, raw, gen)
        cols = torch.arange(n, device=x.device)[None, :]
        calls = [(aligned(raw, n), ops.split_ternary_op, raw, "aligned")]
        if raw in RAW_BOUNDARIES or kernel_raw:
            calls.append((raw, split_ternary, raw, "raw"))
        for b, fn, arg, what in calls:
            probe = torch.where(cols < b, w_q, 99).to(torch.int8)
            if layout == "K-major":
                probe = probe.t().contiguous().t()
            probe_p = torch.where(cols < b, 0xFF, w_p).to(torch.uint8)
            exact("split_ternary", fn(x, probe, probe_p, sx, sw, arg),
                  split_ternary_plain(x, w_q, w_p, sx, sw, b),
                  f"{shape} {layout} boundary={raw:<5d} ({what} {b}), w_q "
                  f"garbage at cols >= {b}, packed garbage below:",
                  quiet)

    def packed_case(m, k, n, quiet=False):
        x, w_t, w_p, sx, sw = operands(m, k, n, 0, gen)
        exact("ternary_packed", ops.ternary_packed_matmul_op(x, w_p, sx, sw),
              ternary_packed_plain(x, w_p, sx, sw),
              f"M={m:<5d} K={k:<6d} N={n:<6d}", quiet)

    def split_precision_check(m, k, n, raw, layout, quiet=False):
        """split_precision through the op (boundary aligned to the N-block)
        with the split probe (w_q 99 at and above the aligned boundary,
        w_bf16 NaN below it): int8 columns bit for bit, bf16 columns within
        the summation bound."""
        shape = f"M={m:<4d} K={k:<6d} N={n:<6d}"
        acts, (w_b, w_q), (p_b, p_q), sw, b_al = \
            split_precision_case(torch, m, k, n, raw, gen)
        if layout == "K-major":
            p_q = p_q.t().contiguous().t()
        got = ops.split_precision_op(*acts, p_b, p_q, sw, raw)
        want = split_precision_plain(*acts, w_b, w_q, sw, b_al)
        torch.cuda.synchronize()
        if not torch.equal(got[:, :b_al], want[:, :b_al]):
            raise AssertionError(
                f"split_precision {shape} {layout} boundary={raw}: int8 "
                f"columns differ")
        err = (got[:, b_al:].double() - want[:, b_al:].double()).abs()
        bound = bf16_error_bound(acts[0], w_b[:, b_al:], want[:, b_al:])
        ratio = (float((err / bound.clamp_min(1e-300)).max())
                 if err.numel() else 0.0)
        worst["split_precision"] = max(
            worst["split_precision"],
            float(err.max()) if err.numel() else 0.0)
        if not bool((err <= bound).all()):
            raise AssertionError(
                f"split_precision {shape} {layout} boundary={raw}: bf16 "
                f"columns outside the summation bound (worst error / bound "
                f"{ratio:.3g})")
        if not quiet:
            print(f"[kernels] split_precision {shape} boundary="
                  f"{raw:<5d} (aligned {b_al}) int8 columns "
                  f"bit-identical, bf16 columns max |err| "
                  f"{float(err.max()) if err.numel() else 0.0:.3g} = "
                  f"{ratio:.3g} of the bound; w_q garbage at cols >= "
                  f"{b_al}, w_bf16 NaN below")
        return ratio

    def ternary_split(m, k, n):
        from repro_torch.kernels.ternary_matmul import launch_args
        return launch_args(m, -(-k // 16) * 16, n, gen.device)[1]

    def ternary_k_major(m, k, n, quiet=True):
        x, w_t, _, sx, sw = operands(m, k, n, 0, gen)
        exact("ternary_matmul", ops.ternary_matmul_op(
            x, w_t.t().contiguous().t(), sx, sw),
            ternary_matmul_plain(x, w_t, sx, sw),
            f"M={m:<5d} K={k:<6d} N={n:<6d} K-major, K split "
            f"{ternary_split(m, k, n)}", quiet)

    def quant_both_layouts(m, k, n):
        shape = f"M={m:<4d} K={k:<6d} N={n:<6d}"
        x, w_q, _, sx, sw = operands(m, k, n, n, gen)
        for layout, w in (("row-major", w_q),
                          ("K-major", w_q.t().contiguous().t())):
            exact("quant_matmul", ops.quant_matmul_op(x, w, sx, sw),
                  quant_matmul_plain(x, w, sx, sw), f"{shape} {layout:9s}")

    for m in M_SHAPES:
        for k, n in KN_SHAPES:
            shape = f"M={m:<4d} K={k:<6d} N={n:<6d}"
            quant_both_layouts(m, k, n)
            x, w_t, w_p, sx, sw = operands(m, k, n, 0, gen)
            exact("ternary_matmul", ops.ternary_matmul_op(x, w_t, sx, sw),
                  ternary_matmul_plain(x, w_t, sx, sw), shape)
            exact("ternary_packed",
                  ops.ternary_packed_matmul_op(x, w_p, sx, sw),
                  ternary_packed_plain(x, w_p, sx, sw), shape)
            for b in BOUNDARIES:
                split_probes(m, k, n, n if b is None else min(b, n),
                             "row-major")
            for b in SP_BOUNDARIES:
                split_precision_check(m, k, n, n if b is None else min(b, n),
                                      "row-major")
    for m in RAGGED_M:
        for k, n in RAGGED_KN:
            quant_both_layouts(m, k, n)
    # the wgmma GEMM of ternary_matmul, split_ternary and ternary_packed (M
    # > 16) on the K-major codes the serving paths hold (ternary_matmul at
    # the split its plan gives), one line per (M, K, N)
    for m in PACKED_M + (PREFILL_M,):
        for k, n in PACKED_KN:
            ternary_k_major(m, k, n)
            if m == PREFILL_M and (k, n) in KN_SHAPES:
                print(f"[kernels] wgmma M={m:<5d} K={k:<6d} N={n:<6d}: "
                      f"ternary_matmul (K split {ternary_split(m, k, n)}) "
                      f"bit-identical")
                continue          # the others checked above
            packed_case(m, k, n, quiet=True)
            raws = [n if b is None else min(b, n) for b in BOUNDARIES]
            for raw in raws:
                split_probes(m, k, n, raw, "K-major", quiet=True)
            print(f"[kernels] wgmma M={m:<5d} K={k:<6d} N={n:<6d}: "
                  f"ternary_matmul (K split {ternary_split(m, k, n)}), "
                  f"ternary_packed and split_ternary (boundaries {raws}, "
                  f"aligned and raw {list(RAW_BOUNDARIES)}, both garbage "
                  f"probes) bit-identical")
    # the decode GEMM of the five int8 kernels on the layouts the serving
    # paths hold (K-major codes, the packed stream as stored)
    for m in DECODE_MS:
        for k, n in DECODE_KN:
            shape = f"M={m} K={k} N={n} K-major"
            x, w_q, w_p, sx, sw = operands(m, k, n, n, gen)
            exact("quant_matmul", ops.quant_matmul_op(
                x, w_q.t().contiguous().t(), sx, sw),
                quant_matmul_plain(x, w_q, sx, sw), shape, quiet=True)
            x, w_t, w_p, sx, sw = operands(m, k, n, 0, gen)
            exact("ternary_matmul", ops.ternary_matmul_op(
                x, w_t.t().contiguous().t(), sx, sw),
                ternary_matmul_plain(x, w_t, sx, sw), shape, quiet=True)
            packed_case(m, k, n, quiet=True)
            raws = [n if b is None else min(b, n) for b in BOUNDARIES]
            for raw in raws:
                split_probes(m, k, n, raw, "K-major", quiet=True)
            ratio = max(split_precision_check(
                m, k, n, n if b is None else min(b, n), "K-major", quiet=True)
                for b in SP_BOUNDARIES)
            print(f"[kernels] decode M={m:<3d} K={k:<6d} N={n:<6d}: "
                  f"quant_matmul, ternary_matmul, ternary_packed, "
                  f"split_ternary (boundaries {raws}, aligned and raw "
                  f"{list(RAW_BOUNDARIES)}, both garbage probes) "
                  f"bit-identical; split_precision int8 columns "
                  f"bit-identical, bf16 columns at most {ratio:.3g} of the "
                  f"bound (both probes)")
    # K off 16: the K-major codes take the counted pad route (one copy)
    m, (k, n) = DECODE_M, PAD_KN
    reset_launches()
    shape = f"M={m} K={k} N={n} K-major"
    x, w_q, w_p, sx, sw = operands(m, k, n, 7, gen)
    exact("quant_matmul", ops.quant_matmul_op(
        x, w_q.t().contiguous().t(), sx, sw),
        quant_matmul_plain(x, w_q, sx, sw), shape, quiet=True)
    x, w_t, w_p, sx, sw = operands(m, k, n, 0, gen)
    exact("ternary_matmul", ops.ternary_matmul_op(
        x, w_t.t().contiguous().t(), sx, sw),
        ternary_matmul_plain(x, w_t, sx, sw), shape, quiet=True)
    packed_case(m, k, n, quiet=True)
    split_probes(m, k, n, 7, "K-major", quiet=True)
    split_precision_check(m, k, n, 7, "K-major", quiet=True)
    copies = weight_copies()
    want = {"quant_matmul.transposed_copies": 1,
            "split_ternary.transposed_copies": 2,   # aligned and raw calls
            "ternary_packed_matmul.padded_copies": 0,
            "ternary_matmul.transposed_copies": 1,
            "split_precision.transposed_copies": 2}  # w_q and w_bf16
    if copies != want:
        raise AssertionError(f"K {k}: weight copies {copies}, expected "
                             f"{want}")
    print(f"[kernels] decode M={m} K={k} N={n} (K off 16): the five kernels "
          f"bit-identical (split_precision's bf16 columns within the "
          f"bound), weight copies {copies}")
    # split_precision at more M (16: decode GEMM; above: wgmma GEMM)
    for m in SP_MS:
        for k, n in KN_SHAPES:
            raws = [n if b is None else min(b, n) for b in SP_BOUNDARIES]
            ratio = max(split_precision_check(m, k, n, raw, "K-major",
                                              quiet=True) for raw in raws)
            print(f"[kernels] split_precision M={m:<4d} K={k:<6d} "
                  f"N={n:<6d} K-major, boundaries {raws}: int8 columns "
                  f"bit-identical, bf16 columns at most {ratio:.3g} of the "
                  f"bound (both probes)")
    # the paged engine's chunk rows, on the layouts the serving paths hold
    for m in CHUNK_MS:
        for k, n in KN_SHAPES:
            x, w_q, _, sx, sw = operands(m, k, n, n, gen)
            exact("quant_matmul", ops.quant_matmul_op(
                x, w_q.t().contiguous().t(), sx, sw),
                quant_matmul_plain(x, w_q, sx, sw),
                f"chunk M={m} K={k} N={n} K-major", quiet=True)
            ternary_k_major(m, k, n)
            split_probes(m, k, n, min(PATHS["diana"][3], n), "K-major",
                         quiet=True)
            ratio = split_precision_check(m, k, n,
                                          min(PATHS["gpu_tc_like"][3], n),
                                          "K-major", quiet=True)
            print(f"[kernels] chunk M={m:<5d} K={k:<6d} N={n:<6d} K-major: "
                  f"quant_matmul, ternary_matmul, split_ternary (boundary "
                  f"{PATHS['diana'][3]}, both garbage probes) bit-identical; "
                  f"split_precision int8 columns bit-identical, bf16 "
                  f"columns at most {ratio:.3g} of the bound")
    m, k, n = PACKED_LONG
    ternary_k_major(m, k, n, quiet=False)
    packed_case(m, k, n)
    for raw in (PATHS["diana"][3], 300):
        split_probes(m, k, n, raw, "K-major")
    # zamba2-1.2b's projections on diana (phase 10): split_ternary at its
    # planned raw boundaries, through the op and the kernel itself, with
    # both garbage probes; quant_matmul at its head and, for the bank's
    # digital target, at the same (K, N)
    for m in ZAMBA_MS:
        for (k, n), raw in ZAMBA_RAW.items():
            split_probes(m, k, n, raw, "K-major", quiet=True,
                         kernel_raw=True)
            x, w_q, _, sx, sw = operands(m, k, n, n, gen)
            exact("quant_matmul", ops.quant_matmul_op(
                x, w_q.t().contiguous().t(), sx, sw),
                quant_matmul_plain(x, w_q, sx, sw),
                f"zamba2 M={m} K={k} N={n} K-major", quiet=True)
            print(f"[kernels] zamba2 M={m:<4d} K={k:<5d} N={n:<5d}: "
                  f"split_ternary at raw boundary {raw} (aligned "
                  f"{aligned(raw, n)}, and raw through the kernel), both "
                  f"garbage probes, and quant_matmul bit-identical")
    quant_both_layouts(DECODE_M, *ZAMBA_HEAD)
    # h2o-danube-3-4b's projections on diana (phase 12), as zamba2's; and
    # the fixed-batch models' new shapes
    for m in DANUBE_MS:
        for (k, n), raw in DANUBE_RAW.items():
            split_probes(m, k, n, raw, "K-major", quiet=True,
                         kernel_raw=True)
            x, w_q, _, sx, sw = operands(m, k, n, n, gen)
            exact("quant_matmul", ops.quant_matmul_op(
                x, w_q.t().contiguous().t(), sx, sw),
                quant_matmul_plain(x, w_q, sx, sw),
                f"h2o M={m} K={k} N={n} K-major", quiet=True)
            print(f"[kernels] h2o M={m:<4d} K={k:<5d} N={n:<5d}: "
                  f"split_ternary at raw boundary {raw} (aligned "
                  f"{aligned(raw, n)}, and raw through the kernel), both "
                  f"garbage probes, and quant_matmul bit-identical")
        x, w_q, _, sx, sw = operands(m, *DANUBE_HEAD, DANUBE_HEAD[1], gen)
        exact("quant_matmul", ops.quant_matmul_op(
            x, w_q.t().contiguous().t(), sx, sw),
            quant_matmul_plain(x, w_q, sx, sw),
            f"h2o head M={m} K={DANUBE_HEAD[0]} N={DANUBE_HEAD[1]} K-major")
    raws = {kn: raw for *_, bounds in DENSE_FIXED.values()
            for kn, raw in bounds.items()}
    for m in DENSE_FIXED_MS:
        for k, n in DENSE_FIXED_KN:
            what = "quant_matmul"
            if (k, n) in raws:
                split_probes(m, k, n, raws[(k, n)], "K-major", quiet=True,
                             kernel_raw=True)
                what = (f"split_ternary at raw boundary {raws[(k, n)]} "
                        f"(both garbage probes) and quant_matmul")
            x, w_q, _, sx, sw = operands(m, k, n, n, gen)
            exact("quant_matmul", ops.quant_matmul_op(
                x, w_q.t().contiguous().t(), sx, sw),
                quant_matmul_plain(x, w_q, sx, sw),
                f"M={m} K={k} N={n} K-major", quiet=True)
            del x, w_q
            print(f"[kernels] dense family M={m:<4d} K={k:<5d} N={n:<6d}: "
                  f"{what} bit-identical")
    B, H, KVH, D = DANUBE_FLASH_HEADS
    for Sq, Sk, kv_len, window in DANUBE_FLASH_CASES:
        q, k, v = flash_operands(torch, B, H, KVH, Sq, Sk, D, gen)
        got = ops.flash_attention(q, k, v, causal=True, kv_len=kv_len,
                                  window=window)
        what = (f"B={B} H={H} KVH={KVH} D={D} Sq={Sq} Sk={Sk} causal "
                f"kv_len={kv_len} window={window}")
        err, ratio = check_flash(torch, q, k, v, got, True, kv_len, what,
                                 window)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        print(f"[kernels] flash_attention {what}: max |err| {err:.4g} = "
              f"{ratio:.4g} of the bound")
        del q, k, v, got
    # deepseek-v2-lite's projections on diana (phase 13): split_ternary at
    # its planned raw boundaries, through the op and the kernel itself,
    # with both garbage probes; kv_b also at the gathered latent's rows;
    # quant_matmul at its head; flash at query / key dim 192, value 128
    for m in DEEPSEEK_MS:
        for (k, n), raw in DEEPSEEK_RAW.items():
            split_probes(m, k, n, raw, "K-major", quiet=True,
                         kernel_raw=True)
        print(f"[kernels] deepseek M={m:<4d}: split_ternary at "
              f"{len(DEEPSEEK_RAW)} (K, N) at their raw boundaries "
              + ", ".join(f"{k}x{n}:{raw}" for (k, n), raw in
                          DEEPSEEK_RAW.items()) +
              " (aligned, and raw through the kernel), both garbage probes, "
              "bit-identical")
    for m in DEEPSEEK_GATHER_MS:
        split_probes(m, 512, 4096, DEEPSEEK_RAW[(512, 4096)], "K-major",
                     quiet=True, kernel_raw=True)
        print(f"[kernels] deepseek kv_b over the gathered latent M={m}: "
              f"split_ternary bit-identical")
    for m in (DECODE_M, REQUESTS * CHUNK):
        x, w_q, _, sx, sw = operands(m, *DEEPSEEK_HEAD, DEEPSEEK_HEAD[1],
                                     gen)
        exact("quant_matmul", ops.quant_matmul_op(
            x, w_q.t().contiguous().t(), sx, sw),
            quant_matmul_plain(x, w_q, sx, sw),
            f"deepseek head M={m} K={DEEPSEEK_HEAD[0]} "
            f"N={DEEPSEEK_HEAD[1]} K-major")
        del x, w_q
    dv = DEEPSEEK_DIMS[1]
    for (B, H, KVH, D), (Sq, Sk, kv_len) in itertools.product(
            DEEPSEEK_FLASH_HEADS, DEEPSEEK_FLASH_CASES):
        q, k, v = flash_operands(torch, B, H, KVH, Sq, Sk, D, gen, Dv=dv)
        got = ops.flash_attention(q, k, v, causal=True, kv_len=kv_len)
        what = (f"B={B} H={H} KVH={KVH} D={D} Dv={dv} Sq={Sq} Sk={Sk} "
                f"causal kv_len={kv_len}")
        err, ratio = check_flash(torch, q, k, v, got, True, kv_len, what)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        print(f"[kernels] flash_attention {what}: max |err| {err:.4g} = "
              f"{ratio:.4g} of the bound")
        del q, k, v, got
    # xlstm-1.3b's projections on diana (phase 14) and arctic-480b's
    # (phase 15): split_ternary at their planned raw boundaries, through
    # the op and the kernel itself, with both garbage probes (xLSTM's w_if
    # at N 8, below every column tile); the xLSTM bank leg's all-ternary
    # draft on ternary_matmul at its decode M; quant_matmul at both heads
    for tag, raws, ms in (("xlstm", XLSTM_RAW, XLSTM_MS),
                          ("arctic", ARCTIC_RAW, ARCTIC_MS)):
        for m in ms:
            for (k, n), raw in raws.items():
                split_probes(m, k, n, raw, "K-major", quiet=True,
                             kernel_raw=True)
            print(f"[kernels] {tag} M={m:<4d}: split_ternary at "
                  f"{len(raws)} (K, N) at their raw boundaries "
                  + ", ".join(f"{k}x{n}:{raw}" for (k, n), raw in
                              raws.items()) +
                  " (aligned, and raw through the kernel), both garbage "
                  "probes, bit-identical")
    for k, n in XLSTM_RAW:
        ternary_k_major(DECODE_M, k, n)
    print(f"[kernels] xlstm draft M={DECODE_M}: ternary_matmul K-major at "
          + ", ".join(f"{k}x{n}" for k, n in XLSTM_RAW) + " bit-identical")
    for tag, (k, n) in (("xlstm", XLSTM_HEAD), ("arctic", ARCTIC_HEAD)):
        for m in (DECODE_M, REQUESTS * CHUNK):
            x, w_q, _, sx, sw = operands(m, k, n, n, gen)
            exact("quant_matmul", ops.quant_matmul_op(
                x, w_q.t().contiguous().t(), sx, sw),
                quant_matmul_plain(x, w_q, sx, sw),
                f"{tag} head M={m} K={k} N={n} K-major")
            del x, w_q
    # the frontend archs' projections on diana (phases 16 and 17):
    # split_ternary at their planned raw boundaries, through the op and the
    # kernel itself, with both garbage probes, also at the frontend rows'
    # M; quant_matmul at both heads (seamless's N 256206 is odd) on the
    # decode GEMM and on the wgmma GEMM
    for tag, (_, _, _, _, raws, _, head) in FRONTEND.items():
        for m in FRONTEND_MS:
            for (k, n), raw in raws.items():
                split_probes(m, k, n, raw, "K-major", quiet=True,
                             kernel_raw=True)
            print(f"[kernels] {tag} M={m:<4d}: split_ternary at "
                  f"{len(raws)} (K, N) at their raw boundaries "
                  + ", ".join(f"{k}x{n}:{raw}" for (k, n), raw in
                              raws.items()) +
                  " (aligned, and raw through the kernel), both garbage "
                  "probes, bit-identical")
        for m in (DECODE_M, REQUESTS * CHUNK):
            x, w_q, _, sx, sw = operands(m, *head, head[1], gen)
            exact("quant_matmul", ops.quant_matmul_op(
                x, w_q.t().contiguous().t(), sx, sw),
                quant_matmul_plain(x, w_q, sx, sw),
                f"{tag} head M={m} K={head[0]} N={head[1]} K-major")
            del x, w_q
    flash_sets = [(FLASH_HEADS, FLASH_CASES),
                  (ZAMBA_FLASH_HEADS, ZAMBA_FLASH_CASES)]
    for (B, H, KVH, D), Sq, Sk, causal, kv_len in (
            (heads, *case) for heads, cases in flash_sets
            for case in cases):
        q, k, v = flash_operands(torch, B, H, KVH, Sq, Sk, D, gen)
        if causal:
            got = ops.flash_attention(q, k, v, causal=True, kv_len=kv_len)
        else:   # through the op, which pads the keys and masks them
            got = ops.flash_attention_op(q, k, v, causal=False)
        what = (f"B={B} H={H} KVH={KVH} D={D} Sq={Sq} Sk={Sk} "
                f"causal={causal} kv_len={kv_len}")
        err, ratio = check_flash(torch, q, k, v, got, causal, kv_len, what)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        print(f"[kernels] flash_attention {what}: max |err| {err:.4g} = "
              f"{ratio:.4g} of the bound")
        del q, k, v, got
    return worst


def phase_packed_entry(torch, gen):
    """ternary_packed's own run: its entry point (no serving path calls
    it) once at each (M, K, N) of the serving paths, launch counts read
    around the run; returns the launches."""
    from repro_torch.kernels import ops
    reset_launches()
    for m in M_SHAPES:
        for k, n in KN_SHAPES:
            x, _, w_p, sx, sw = operands(m, k, n, 0, gen)
            y = ops.ternary_packed_matmul_op(x, w_p, sx, sw)
            if tuple(y.shape) != (m, n) or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"ternary_packed entry point M={m} "
                                     f"K={k} N={n}: wrong shape or not "
                                     f"finite")
    launches = kernel_launches()
    want = dict.fromkeys(KERNELS, 0)
    want["ternary_packed"] = len(M_SHAPES) * len(KN_SHAPES)
    if launches != want:
        raise AssertionError(f"ternary_packed entry point: launches "
                             f"{launches}, expected {want}")
    check_no_weight_copies("ternary_packed entry point")
    print(f"[entry] ternary_packed_matmul_op at {want['ternary_packed']} "
          f"(M, K, N): {launches['ternary_packed']} launches")
    return launches


def phase_times(torch, gen):
    """Times of every (M, K, N) call the serving paths make; returns
    {kernel: {(m, k, n): record}}.  Each timed call reads the next of
    several copies of the weights, whose total exceeds twice the 50 MB L2
    cache, so every call streams its weights from device memory as in a
    forward pass.  quant_matmul and split_ternary read the K-major codes
    the serving paths hold; the library yardstick runs torch._int_mm on the
    row-major and on the K-major (column-major) int8 weight, and the faster
    is the record's ``library_ms``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_precision import split_precision_plain
    from repro_torch.kernels.split_ternary import split_ternary_plain
    from repro_torch.kernels.ternary_matmul import ternary_matmul_plain
    from repro_torch.kernels.ternary_packed import ternary_packed_plain
    times = {kernel: {} for kernel in KERNELS}
    calls = {}
    for path, (_, _, _, raw) in PATHS.items():
        for (k, n), (kernel, _, pm) in path_layers(path).items():
            for m in M_SHAPES:
                key = (kernel, m if m == DECODE_M else pm, k, n)
                calls[key] = raw if kernel == PATHS[path][2] else None
    # the long prefill's calls (diana_long: the diana layers at LONG_M)
    # and the paged engine's chunks on the diana path
    raw = PATHS["diana"][3]
    for rows in (LONG_M,) + CHUNK_MS:
        for (k, n), (kernel, _, pm) in path_layers("diana", rows).items():
            calls[(kernel, pm, k, n)] = (raw if kernel == "split_ternary"
                                         else None)
    for m in M_SHAPES:       # the calls of ternary_packed's entry-point run
        for k, n in KN_SHAPES:
            calls[("ternary_packed", m, k, n)] = None
    # zamba2-1.2b's calls on diana (phase 10)
    for m in ZAMBA_MS:
        for (k, n), raw in ZAMBA_RAW.items():
            calls[("split_ternary", m, k, n)] = raw
    calls[("quant_matmul", DECODE_M) + ZAMBA_HEAD] = None
    # xlstm-1.3b's calls on diana (phase 14) at decode and a paged chunk
    for m in (DECODE_M, REQUESTS * CHUNK):
        for (k, n), raw in XLSTM_RAW.items():
            calls[("split_ternary", m, k, n)] = raw
    calls[("quant_matmul", DECODE_M) + XLSTM_HEAD] = None
    for (kernel, m, k, n), raw in calls.items():
        raw = n if raw is None else raw
        b_al = aligned(raw, n)
        iters = 20 if n * k >= 4096 * 11008 else 50
        # torch._int_mm takes M > 16 only: fewer rows are zero-padded to 32
        pad_rows = (lambda t: torch.cat([t, t.new_zeros(32 - m, k)])
                    if m <= 16 else t)
        if kernel == "split_precision":
            acts, (w_b, w_q), _, sw, _ = split_precision_case(
                torch, m, k, n, raw, gen)
            x, x_q, sx = acts
            wbytes = k * b_al + 2 * k * (n - b_al)
            lo = w_q[:, :b_al].contiguous()
            # the kernel reads the K-major codes the layers hold
            weights = (w_b, w_q.t().contiguous().t(), lo,
                       w_b[:, b_al:].contiguous(), lo.t().contiguous().t())
            lib_int8 = (2, 4)     # int8 operand: row-major, K-major
            x_lib = pad_rows(x_q)

            def run(w):
                return ops.split_precision_op(x, x_q, sx, w[0], w[1], sw,
                                              raw)

            def plain(w):
                return split_precision_plain(x, x_q, sx, w[0], w[1], sw,
                                             b_al)

            def lib(w, i):   # two calls, no concatenation
                lo = torch._int_mm(x_lib, w[i])[:m].to(torch.float32) * \
                    sx * sw[None, :b_al]
                return lo, torch.matmul(x, w[3]).to(torch.float32)
            bound = bound_ms(m, k, n, wbytes, int8_cols=b_al,
                             bf16_cols=n - b_al)
        else:
            x, w_q, w_p, sx, sw = operands(
                m, k, n, 0 if kernel in ("ternary_matmul", "ternary_packed")
                else raw, gen)
            w_col = w_q.t().contiguous().t()
            # the library call reads the codes w[0] (row-major) or w[-1]
            # (K-major); quant_matmul, ternary_matmul and split_ternary read
            # w[-1] as the serving paths hold it (split_ternary beside the
            # packed stream w[1]), ternary_packed w[1]
            weights = (w_q, w_col)
            lib_int8 = (0, -1)
            x_lib = pad_rows(x)
            if kernel == "ternary_packed":
                weights = (w_q, w_p, w_col)
                wbytes = (k // 4) * n

                def run(w):
                    return ops.ternary_packed_matmul_op(x, w[1], sx, sw)

                def plain(w):
                    return ternary_packed_plain(x, w[1], sx, sw)
            elif kernel == "split_ternary":
                weights = (w_q, w_p, w_col)
                wbytes = k * b_al + (k // 4) * (n - b_al)

                def run(w):
                    return ops.split_ternary_op(x, w[2], w[1], sx, sw, raw)

                def plain(w):
                    return split_ternary_plain(x, w[0], w[1], sx, sw, b_al)
            else:
                wbytes = k * n
                op, plain_fn, wi = {
                    "quant_matmul": (ops.quant_matmul_op,
                                     quant_matmul_plain, -1),
                    "ternary_matmul": (ops.ternary_matmul_op,
                                       ternary_matmul_plain, -1)}[kernel]

                def run(w, op=op, wi=wi):
                    return op(x, w[wi], sx, sw)

                def plain(w, plain_fn=plain_fn, wi=wi):
                    return plain_fn(x, w[wi], sx, sw)

            def lib(w, i):
                return (torch._int_mm(x_lib, w[i])[:m].to(torch.float32) *
                        sx * sw[None, :])
            bound = bound_ms(m, k, n, wbytes)
        copies = -(-2 * L2_BYTES // wbytes)
        ring = [weights] + [tuple(t.clone() for t in weights)
                            for _ in range(copies - 1)]
        turn = itertools.cycle(ring)
        # a graph holds at least one call per weight copy: each replay
        # streams its weights from device memory
        rounds = graph_rounds(
            {"ms": lambda: run(next(turn)),
             "library_row_ms": lambda: lib(next(turn), lib_int8[0]),
             "library_col_ms": lambda: lib(next(turn), lib_int8[1])},
            max(iters, copies))
        rec = {"plain_ms": cuda_ms(lambda: plain(next(turn)),
                                   max(3, iters // 5)),
               "eager_ms": cuda_ms(lambda: run(next(turn)), iters)}
        for key, xs in rounds.items():
            spread(rec, key, xs)
        lib_key = min(("library_row_ms", "library_col_ms"),
                      key=lambda key: rec[key])
        spread(rec, "library_ms", rounds[lib_key])
        rec["bound_ms"], rec["bound_by"] = bound
        times[kernel][(m, k, n)] = rec
        del ring, turn, weights
        lib_name = "two calls" if kernel == "split_precision" else "_int_mm"
        print(f"[times] {kernel:<15s} M={m:<5d} K={k:<6d} N={n:<6d} "
              f"kernel {rec['ms']:.4f} ms ({rec['min_ms']:.4f}-"
              f"{rec['max_ms']:.4f}; eager {rec['eager_ms']:.4f})  plain "
              f"{rec['plain_ms']:.4f} ms  "
              f"{lib_name} {rec['library_ms']:.4f} ms "
              f"({rec['library_min_ms']:.4f}-{rec['library_max_ms']:.4f}; "
              f"int8 weight row-major {rec['library_row_ms']:.4f}, K-major "
              f"{rec['library_col_ms']:.4f})  bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})  share {rec['bound_ms'] / rec['ms']:.3f}"
              f"  factor {rec['ms'] / rec['library_ms']:.3f}")
    return times


#: the K splits the wgmma GEMM of split_precision and ternary_matmul is
#: timed at (the sweep)
SWEEP_SPLITS = (1, 2, 4, 8)


def phase_split_sweep(torch, gen):
    """The wgmma GEMM of split_precision and of ternary_matmul at their
    served prefill call (M 512, K 4096, N 512; split_precision at raw
    boundary 342) with each K split of SWEEP_SPLITS in place of the
    wrapper's plan: each checked against the plain version (ternary_matmul
    and split_precision's int8 columns bit for bit, its bf16 columns within
    the bound) and timed as the kernels of phase 4 (graph replays, ROUNDS
    rounds, weights cold in L2); returns {kernel: {split: median ms}}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import split_precision as sp
    from repro_torch.kernels import ternary_matmul as tm
    m, (k, n), raw = PREFILL_M, (4096, 512), PATHS["gpu_tc_like"][3]
    acts, (w_b, w_q), _, sw_p, b_al = split_precision_case(torch, m, k, n,
                                                           raw, gen)
    x, w_t, _, sx, sw = operands(m, k, n, 0, gen)
    cases = {
        "split_precision": (sp, (w_b, w_q.t().contiguous().t()),
                            k * b_al + 2 * k * (n - b_al)),
        "ternary_matmul": (tm, (w_t.t().contiguous().t(),), k * n)}
    out = {}
    for kernel, (module, weights, wbytes) in cases.items():
        copies = -(-2 * L2_BYTES // wbytes)
        ring = itertools.cycle([weights] + [
            tuple(t.clone() for t in weights) for _ in range(copies - 1)])
        if kernel == "split_precision":
            def call(w):
                return ops.split_precision_op(*acts, *w, sw_p, raw)
        else:
            def call(w):
                return ops.ternary_matmul_op(x, w[0], sx, sw)
        plan, out[kernel] = module.wgmma_split, {}
        try:
            for split in SWEEP_SPLITS:
                module.wgmma_split = lambda *_, split=split: split
                got = call(weights)
                if kernel == "split_precision":
                    ratio = check_split_precision_calls(
                        torch, [((*acts, *weights, sw_p, raw), {"bn": 128},
                                 got)])
                    check = (f"int8 columns bit-identical, bf16 columns "
                             f"{ratio:.3g} of the bound")
                else:
                    torch.cuda.synchronize()
                    if not torch.equal(got, tm.ternary_matmul_plain(
                            x, w_t, sx, sw)):
                        raise AssertionError(f"ternary_matmul K split "
                                             f"{split}: differs")
                    check = "bit-identical"
                xs = graph_rounds({"ms": lambda: call(next(ring))},
                                  copies)["ms"]
                out[kernel][split] = median(xs)
                print(f"[times] {kernel} M={m} K={k} N={n} wgmma K split "
                      f"{split}: kernel {out[kernel][split]:.4f} ms "
                      f"({min(xs):.4f}-{max(xs):.4f}); {check}")
        finally:
            module.wgmma_split = plan
        del ring
    return out


def sdpa_masked(torch, q, k, v, kv_end, window):
    """The library yardstick of a windowed call: scaled_dot_product_attention
    (GQA) over the ``kv_end`` keys the call reads with a boolean (Sq,
    kv_end) causal-window mask, (B, H, S, D) operands; returns (fn, the
    name of its longest device kernel in one profiled call: PyTorch's
    flash backend takes no mask, so another backend runs it)."""
    import torch.nn.functional as F
    Sq = q.shape[2]
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(kv_end, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    kh, vh = k[:, :, :kv_end], v[:, :, :kv_end]

    def lib():
        return F.scaled_dot_product_attention(q, kh, vh, attn_mask=mask,
                                              enable_gqa=True)
    return lib, longest_kernel(torch, lib)


def longest_kernel(torch, fn):
    """The name of the device kernel that takes the longest in one
    profiled call of ``fn`` (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            kernels[e.name()] = kernels.get(e.name(), 0) + e.duration_ns()
    return max(kernels, key=kernels.get) if kernels else "not measured"


def phase_flash_times(torch, gen, heads=FLASH_HEADS, sq=LONG_PROMPT,
                      sk=LONG_CACHE, window=None, dv=None):
    """Times of a long prefill's flash_attention call as the path makes it
    (`attention.chunked_attention` on the model layout, bf16, causal,
    kv_len ``sq``, the sliding ``window`` if any, value head dim ``dv`` if
    it is not D, with v the value half of a (B, Sk, H, (D - 64) + dv)
    buffer, as `attention.mla` slices it from kv_b's output; by default
    diana_long's: q (4, 3072, 4, 8, 128), k / v (4, 4096, 4, 128)), its
    plain version on the same layout, and
    scaled_dot_product_attention (causal, GQA; with a window through a
    boolean mask, `sdpa_masked`) over the ``sq`` keys the call reads; with
    ``dv`` the name of the kernel SDPA's backend ran (its flash backend
    may refuse Ev != E); returns the record."""
    import torch.nn.functional as F
    from repro_torch.models import attention as A
    B, H, KVH, D = heads
    q, k, v = flash_operands(torch, B, H, KVH, sq, sk, D, gen,
                             layout="model", Dv=dv)
    if dv is not None:   # MLA: kv_b's output is k_nope ‖ v per head
        v = torch.cat([k[..., :D - DEEPSEEK_ROPE], v], dim=-1)[
            ..., D - DEEPSEEK_ROPE:]

    def run():
        return A.chunked_attention(q, k, v, kv_len=sq, window=window)

    def plain():
        return A.attention_plain(q, k, v, causal=True, kv_len=sq,
                                 window=window)
    qh = q.reshape(B, sq, H, D).transpose(1, 2)
    kh = k[:, :sq].transpose(1, 2)
    vh = v[:, :sq].transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)
    rec = {"plain_ms": cuda_ms(plain, 3)}
    if window is not None:
        lib, rec["library_kernel"] = sdpa_masked(torch, qh, kh, vh, sq,
                                                 window)
    elif dv is not None:
        rec["library_kernel"] = longest_kernel(torch, lib)
    for key, xs in graph_rounds({"ms": run, "library_ms": lib}, 5).items():
        spread(rec, key, xs)
    rec["bound_ms"], rec["bound_by"] = flash_bound_ms(B, H, KVH, sq, sq, D,
                                                      window=window, Dv=dv)
    lib_what = ("" if "library_kernel" not in rec else
                f" ({'masked, ' if window else ''}kernel "
                f"{rec['library_kernel'][:60]})")
    print(f"[times] flash_attention B={B} H={H} KVH={KVH} D={D} Dv="
          f"{dv or D} Sq="
          f"{sq} Sk={sk} kv_len={sq} window={window} causal{lib_what}: "
          f"kernel {rec['ms']:.4f} ms ({rec['min_ms']:.4f}-"
          f"{rec['max_ms']:.4f})  plain {rec['plain_ms']:.4f} ms  sdpa "
          f"{rec['library_ms']:.4f} ms ({rec['library_min_ms']:.4f}-"
          f"{rec['library_max_ms']:.4f})  bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})  share {rec['bound_ms'] / rec['ms']:.3f}"
          f"  factor {rec['ms'] / rec['library_ms']:.3f}")
    return rec


def phase_danube_flash_times(torch, gen):
    """Times of flash_attention at each of `DANUBE_FLASH_CASES` (h2o's
    heads, D 120; (B, H, S, D) operands), the plain version once after a
    warm-up, and scaled_dot_product_attention over the keys the call
    reads (causal; with a window through a boolean mask, `sdpa_masked`),
    beside the bound; returns {case: record}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    B, H, KVH, D = DANUBE_FLASH_HEADS
    out = {}
    for Sq, Sk, kv_len, window in DANUBE_FLASH_CASES:
        q, k, v = flash_operands(torch, B, H, KVH, Sq, Sk, D, gen)
        kv_end = Sk if kv_len is None else kv_len
        kw = dict(causal=True, kv_len=kv_len, window=window)

        def run():
            return ops.flash_attention(q, k, v, **kw)

        def plain():
            return flash_attention_plain(q, k, v, **kw)
        rec = {"plain_ms": cuda_ms(plain, 1)}
        if window is None:
            kh, vh = k[:, :, :kv_end], v[:, :, :kv_end]

            def lib():
                return F.scaled_dot_product_attention(
                    q, kh, vh, is_causal=True, enable_gqa=True)
        else:
            lib, rec["library_kernel"] = sdpa_masked(torch, q, k, v, kv_end,
                                                     window)
        for key, xs in graph_rounds({"ms": run, "library_ms": lib},
                                    3).items():
            spread(rec, key, xs)
        rec["bound_ms"], rec["bound_by"] = flash_bound_ms(
            B, H, KVH, Sq, kv_end, D, window=window)
        lib_what = ("" if window is None else
                    f" (masked, kernel {rec['library_kernel'][:60]})")
        print(f"[times] flash_attention B={B} H={H} KVH={KVH} D={D} Sq={Sq}"
              f" Sk={Sk} kv_len={kv_len} window={window} causal: kernel "
              f"{rec['ms']:.4f} ms ({rec['min_ms']:.4f}-{rec['max_ms']:.4f})"
              f"  plain {rec['plain_ms']:.4f} ms  sdpa{lib_what} "
              f"{rec['library_ms']:.4f} ms ({rec['library_min_ms']:.4f}-"
              f"{rec['library_max_ms']:.4f})  bound {rec['bound_ms']:.4f} ms"
              f" ({rec['bound_by']})  share "
              f"{rec['bound_ms'] / rec['ms']:.3f}  factor "
              f"{rec['ms'] / rec['library_ms']:.3f}")
        out[f"Sq={Sq} Sk={Sk} kv_len={kv_len} window={window}"] = rec
        del q, k, v
    return out


#: record keys summed over a forward pass or a run (medians, and the
#: rounds' extremes summed: the range of a forward's time)
MIX_KEYS = ("ms", "min_ms", "max_ms", "eager_ms", "plain_ms", "library_ms",
            "library_min_ms", "library_max_ms", "library_row_ms",
            "library_col_ms", "bound_ms")


def entry_mix(times, only_m=None):
    """Sum of ternary_packed's records over its entry-point run (one call
    at each (M, K, N)), or over its calls at M = ``only_m``."""
    recs = [times["ternary_packed"][(m, k, n)] for m in M_SHAPES
            for k, n in KN_SHAPES if only_m in (None, m)]
    tot = {key: sum(r[key] for r in recs) for key in MIX_KEYS}
    by_bytes = sum(r["bound_ms"] for r in recs if r["bound_by"] == "bytes")
    tot["bound_by"] = ("bytes" if by_bytes >= tot["bound_ms"] / 2
                       else "operations")
    return tot


def zamba_layers(prefill_m=PREFILL_M, layers=None, head=ZAMBA_HEAD):
    """zamba2-1.2b's planned layers per forward on diana (`ZAMBA_LAYERS`,
    the head), or those of ``layers`` and ``head`` (xlstm-1.3b's): (K, N)
    -> (kernel, count, rows at a prefill of ``prefill_m`` tokens); every
    layer has M = B rows at decode."""
    out = {kn: ("split_ternary", count, prefill_m)
           for kn, count in (layers or ZAMBA_LAYERS).items()}
    out[head] = ("quant_matmul", 1, DECODE_M)
    return out


def forward_mix(times, path, kernel, phase, prefill_m=PREFILL_M,
                layers=None):
    """Sum of per-layer records over one ``"prefill"`` (of ``prefill_m``
    tokens) or ``"decode"`` forward pass of yi-9b on ``path`` (or of the
    model whose `path_layers` counterpart gives ``layers``), each layer at
    the M the path gives it."""
    tot = dict.fromkeys(MIX_KEYS + ("bytes_ms",), 0.0)
    layers = layers if layers is not None else path_layers(path, prefill_m)
    for (k, n), (kern, count, prefill_m) in layers.items():
        if kern != kernel:
            continue
        m = prefill_m if phase == "prefill" else DECODE_M
        rec = times[kernel][(m, k, n)]
        for key in MIX_KEYS:
            tot[key] += count * rec[key]
        if rec["bound_by"] == "bytes":
            tot["bytes_ms"] += count * rec["bound_ms"]
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["bound_ms"] / 2
                       else "operations")
    del tot["bytes_ms"]
    return tot


def print_mix(what, kernel, mix):
    """The ``[times]`` line of a sum over a forward pass or a run: medians
    (the rounds' extremes summed), share and the rule-2 factor kernel /
    library from the medians."""
    row = (f" (int8 weight row-major {mix['library_row_ms']:.4f}, K-major "
           f"{mix['library_col_ms']:.4f})" if "library_row_ms" in mix else "")
    eager = f"; eager {mix['eager_ms']:.4f}" if "eager_ms" in mix else ""
    print(f"[times] {what}: {kernel} kernel {mix['ms']:.4f} ms "
          f"({mix['min_ms']:.4f}-{mix['max_ms']:.4f}{eager})  plain "
          f"{mix['plain_ms']:.4f} ms  library {mix['library_ms']:.4f} ms "
          f"({mix['library_min_ms']:.4f}-{mix['library_max_ms']:.4f}){row}"
          f"  bound {mix['bound_ms']:.4f} ms ({mix['bound_by']})  share "
          f"{mix['bound_ms'] / mix['ms']:.3f}  factor "
          f"{mix['ms'] / mix['library_ms']:.3f}")


def recording_split_precision(calls, limit):
    """Context: `ops.split_precision_op` keeps the operands and output of
    its first ``limit`` calls in ``calls`` (the layer check of
    gpu_tc_like); the kernel launches as before."""
    import contextlib
    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def ctx():
        orig = ops.split_precision_op

        def recording(*args, **kw):
            out = orig(*args, **kw)
            if len(calls) < limit:
                calls.append((args, kw, out))
            return out
        ops.split_precision_op = recording
        try:
            yield
        finally:
            ops.split_precision_op = orig
    return ctx()


def check_split_precision_calls(torch, calls):
    """Each recorded call against the plain version on its own inputs;
    returns the largest bf16-column error / bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.split_precision import (bf16_error_bound,
                                                     split_precision_plain)
    worst = 0.0
    for (x, x_q, sx, w_b, w_q, sw, boundary), kw, got in calls:
        n = w_q.shape[1]
        b_al = min(ops.align_boundary(boundary, ops.block_n(kw["bn"], n)),
                   n)
        want = split_precision_plain(x, x_q, sx, w_b, w_q, sw, b_al)
        if not torch.equal(got[:, :b_al], want[:, :b_al]):
            raise AssertionError("split_precision on the path: int8 "
                                 "columns differ from the plain version")
        if b_al == n:
            continue
        err = (got[:, b_al:].double() - want[:, b_al:].double()).abs()
        bound = bf16_error_bound(x, w_b[:, b_al:], want[:, b_al:])
        if not bool((err <= bound).all()):
            raise AssertionError("split_precision on the path: bf16 "
                                 "columns outside the summation bound")
        worst = max(worst, float((err / bound.clamp_min(1e-300)).max()))
    return worst


def plain_float32_split_precision():
    """Context: the plain split_precision oracle sums its bf16 columns in
    float32 (cuBLAS; TF32 is off) instead of float64 -- another valid
    order, for the sensitivity run of gpu_tc_like."""
    import contextlib
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_matmul import quant_matmul_plain

    def plain32(x, x_q, sx, w_bf16, w_q, sw, boundary):
        lo = quant_matmul_plain(x_q, w_q, sx, sw)
        hi = x.to(torch.float32) @ w_bf16.to(torch.float32)
        cols = torch.arange(w_q.shape[1], device=w_q.device)[None, :]
        return torch.where(cols < boundary, lo, hi)

    @contextlib.contextmanager
    def ctx():
        orig = ref.split_precision_matmul_ref
        ref.split_precision_matmul_ref = plain32
        try:
            yield
        finally:
            ref.split_precision_matmul_ref = orig
    return ctx()


def kernel_launches():
    from repro_torch.kernels import ops
    return {k: getattr(ops, attr).launches
            for k, (_, _, attr) in KERNELS.items()}


#: (ops attribute, counter) of each count of per-call weight copies
COPY_COUNTERS = (("quant_matmul", "transposed_copies"),
                 ("split_ternary", "transposed_copies"),
                 ("ternary_packed_matmul", "padded_copies"),
                 ("ternary_matmul", "transposed_copies"),
                 ("split_precision", "transposed_copies"))


def reset_launches():
    """Launch counts and the counts of per-call weight copies to 0."""
    from repro_torch.kernels import ops
    for _, _, attr in KERNELS.values():
        getattr(ops, attr).launches = 0
    for attr, counter in COPY_COUNTERS:
        setattr(getattr(ops, attr), counter, 0)


def weight_copies():
    from repro_torch.kernels import ops
    return {f"{attr}.{counter}": getattr(getattr(ops, attr), counter)
            for attr, counter in COPY_COUNTERS}


def check_no_weight_copies(path):
    """A serving path holds every int8 kernel's codes K-major and its
    packed streams and bf16 weights aligned: no call may have copied a
    weight."""
    copies = weight_copies()
    if any(copies.values()):
        raise AssertionError(f"{path}: weights copied per call {copies}")


def phase_serving(torch, path, cfg, params, prompts):
    """Serve ``cfg`` planned on ``path`` with the kernels, then with the
    plain versions, then warm; returns (launches of the kernel run,
    serving record)."""
    from repro_torch.launch.serve import (check_coverage, kv_cache_for,
                                          plan_mapping_execution,
                                          serve_batch)
    from repro_torch.launch.train import emit_static_mapping
    platform, bias, kv_kernel, _ = PATHS[path]
    expected = {}
    for kernel, count, _ in path_layers(path).values():
        expected[kernel] = expected.get(kernel, 0) + count
    torch.cuda.reset_peak_memory_stats()
    out = ROOT / "build" / "chip_smoke" / f"{cfg.name}_{path}.json"
    t0 = time.perf_counter()
    art = emit_static_mapping(params, cfg, platform, out, act_log_scale=2.0,
                              bias=bias)
    plan, backend = plan_mapping_execution(params, art)
    check_coverage("serve", backend, require_full=True)
    hist = plan.kernel_histogram()
    for line in plan.histogram_lines():
        print(f"[serve:{path}] {line}")
    print(f"[serve:{path}] {backend.coverage()} (map, lower and bind "
          f"{time.perf_counter() - t0:.1f} s)")
    if hist != expected:
        raise AssertionError(f"{path}: kernel histogram {hist}, expected "
                             f"{expected}")
    wk = plan["units/0/attn/wk@0"]
    print(f"[serve:{path}] wk/wv: counts {wk.counts}, raw boundaries "
          f"{wk.boundaries}, aligned {wk.aligned_boundaries}")
    cfg = kv_cache_for(cfg, art)

    # serve_batch runs the paged engine: the prompts stream in chunks of
    # CHUNK tokens, then GEN_LEN - 1 decode steps
    chunks = -(-PROMPT_LEN // CHUNK)
    forwards = chunks + GEN_LEN - 1
    calls, logit_calls = [], []
    reset_launches()
    with recording_split_precision(calls, expected.get("split_precision",
                                                       0)), \
            recording_logits(logit_calls):
        tokens, stats = serve_batch(cfg, params, prompts, GEN_LEN,
                                    backend=backend)
    launches = kernel_launches()
    want = {k: expected.get(k, 0) * forwards for k in KERNELS}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, expected "
                             f"{want} ({forwards} forwards)")
    check_no_weight_copies(path)
    peak = torch.cuda.max_memory_allocated() / 2**30
    logits, _ = batch_logits(torch, tokens, logit_calls)
    del logit_calls
    if tuple(tokens.shape) != (REQUESTS, GEN_LEN) or \
            tuple(logits.shape) != (REQUESTS, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{path}: serving output has the wrong shape "
                             f"or is not finite")
    print(f"[serve:{path}] {REQUESTS} requests x prompt {PROMPT_LEN} + "
          f"gen {GEN_LEN}, kv {cfg.kv_cache_dtype}, through the paged "
          f"engine: prefill ({chunks} chunk calls at M {REQUESTS * CHUNK}) "
          f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
          f"{stats['decode_s'] * 1e3:.3f} ms "
          f"({stats['tok_per_s']:.2f} tok/s, "
          f"{stats['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step), "
          f"peak memory {peak:.2f} GiB")
    print(f"[serve:{path}] launches: " + " ".join(
        f"{k} {v} ({v // forwards} per forward)"
        for k, v in launches.items() if v) +
        "; weights copied per call: " + ", ".join(
            f"{k} 0" for k in weight_copies()))
    print(f"[serve:{path}] sample tokens: {tokens[:2, :8].tolist()}")

    backend.reference = True
    ref_calls = []
    with recording_logits(ref_calls):
        ref_tokens, ref_stats = serve_batch(cfg, params, prompts, GEN_LEN,
                                            backend=backend)
    if kernel_launches() != want:
        raise AssertionError(f"{path}: the plain-version run launched a "
                             f"kernel")
    ref_logits, ref_margins = batch_logits(torch, ref_tokens, ref_calls)
    del ref_calls
    same_tokens = torch.equal(tokens, ref_tokens)
    same_logits = torch.equal(logits, ref_logits)
    diff = float((logits.float() - ref_logits.float()).abs().max())
    print(f"[serve:{path}] plain-version run: prefill "
          f"{ref_stats['prefill_s'] * 1e3:.3f} ms, decode "
          f"{ref_stats['decode_s'] * 1e3:.3f} ms; tokens identical "
          f"{same_tokens}, prefill logits bit-identical {same_logits} "
          f"(max |diff| {diff:.4g})")
    record = {"prefill_ms": stats["prefill_s"] * 1e3,
              "decode_tok_per_s": stats["tok_per_s"],
              "plain_prefill_ms": ref_stats["prefill_s"] * 1e3,
              "peak_gib": peak, "kv_cache_dtype": cfg.kv_cache_dtype,
              "tokens_identical": same_tokens,
              "prefill_logits_identical": same_logits,
              "prefill_logits_max_abs_diff": diff}
    if kv_kernel != "split_precision":
        if not (same_tokens and same_logits):
            raise AssertionError(f"{path}: kernel and plain-version "
                                 f"serving disagree")
    else:
        ratio = check_split_precision_calls(torch, calls)
        print(f"[serve:{path}] the {len(calls)} split_precision calls of "
              f"the first chunk agree with the plain version on their own "
              f"inputs: int8 columns bit-identical, bf16 columns within "
              f"{ratio:.3g} of the summation bound")
        del calls
        calls32 = []
        with plain_float32_split_precision(), recording_logits(calls32):
            tok32, st32 = serve_batch(cfg, params, prompts, GEN_LEN,
                                      backend=backend)
        if kernel_launches() != want:
            raise AssertionError(f"{path}: the float32 plain run launched "
                                 f"a kernel")
        logits32, _ = batch_logits(torch, tok32, calls32)
        del calls32
        spread = float((logits32 - ref_logits).abs().max())
        print(f"[serve:{path}] plain run with float32 sums: prefill "
              f"logits max |diff| {spread:.4g} from the float64 plain run, "
              f"tokens identical {torch.equal(tok32, ref_tokens)}")
        tol = SENSITIVITY_FACTOR * spread
        compared, _ = compare_requests(path, tokens.tolist(),
                                       ref_tokens.tolist(),
                                       ref_margins.tolist(),
                                       [tol] * len(tokens))
        print(f"[serve:{path}] tolerance {tol:.4g} = {SENSITIVITY_FACTOR:g}"
              f" x {spread:.4g}: kernel prefill logits max |diff| "
              f"{diff:.4g} (ratio {diff / max(spread, 1e-30):.3g}); tokens "
              f"identical over {compared} of {REQUESTS * GEN_LEN} "
              f"(row, step) pairs before the first plain top-2 margin "
              f"below it")
        if diff > tol:
            raise AssertionError(f"{path}: prefill logits differ by "
                                 f"{diff} > {tol}")
        record.update(tolerance=tol, tokens_compared=compared,
                      float32_plain_max_abs_diff=spread,
                      path_calls_worst_error_over_bound=ratio)
    backend.reference = False

    _, warm = serve_batch(cfg, params, prompts, GEN_LEN, backend=backend)
    check_no_weight_copies(path)    # over every run of the path
    warm_ms = (warm["prefill_s"] + warm["decode_s"]) * 1e3
    print(f"[serve:{path}] warm run: prefill {warm['prefill_s'] * 1e3:.3f} "
          f"ms, decode {warm['decode_s'] * 1e3:.3f} ms "
          f"({warm['tok_per_s']:.2f} tok/s, "
          f"{warm['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step)")
    record.update(warm_prefill_ms=warm["prefill_s"] * 1e3,
                  warm_decode_tok_per_s=warm["tok_per_s"],
                  warm_wall_ms=warm_ms)
    def profiled():
        _, st = serve_batch(cfg, params, prompts, GEN_LEN, backend=backend)
        return (st["prefill_s"] + st["decode_s"]) * 1e3
    busy_ms = profile_device(torch, path, profiled)
    print(f"[profile:{path}] device busy {busy_ms:.3f} ms of the warm "
          f"run's {warm_ms:.3f} ms wall: idle share "
          f"{1.0 - busy_ms / warm_ms:.3f}")
    record["device_busy_ms"] = busy_ms
    del plan, backend
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


def recording_flash(calls):
    """Context: the flash_attention calls of `attention.chunked_attention`
    keep their operands and output in ``calls``; the kernel launches as
    before."""
    import contextlib
    from repro_torch.models import attention as A

    @contextlib.contextmanager
    def ctx():
        orig = A.flash_attention

        def recording(q, k, v, **kw):
            out = orig(q, k, v, **kw)
            calls.append((q, k, v, kw, out))
            return out
        A.flash_attention = recording
        try:
            yield
        finally:
            A.flash_attention = orig
    return ctx()


def checking_matmuls(checked, limits):
    """Context: the first ``limits[kernel]`` calls of `ops.quant_matmul_op`
    and `ops.split_ternary_op` (one forward pass: the prefill) are held bit
    for bit against the plain version on their own inputs as they are made;
    ``checked[kernel]`` is (calls checked, largest M).  The kernels launch
    as before; the plain versions launch nothing."""
    import contextlib
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_ternary import split_ternary_plain

    def quant_plain(x, w_q, sx, sw):
        return quant_matmul_plain(x, w_q, sx, sw)

    def split_plain(x, w_q, w_p, sx, sw, boundary, bn=128):
        n = w_q.shape[1]
        b_al = min(ops.align_boundary(boundary, ops.block_n(bn, n)), n)
        return split_ternary_plain(x, w_q, w_p, sx, sw, b_al)
    plains = {"quant_matmul": ("quant_matmul_op", quant_plain),
              "split_ternary": ("split_ternary_op", split_plain)}

    def checking(kernel, orig, plain):
        def call(*args, **kw):
            out = orig(*args, **kw)
            n, rows = checked[kernel]
            if n < limits[kernel]:
                want = plain(*args, **kw)
                if not torch.equal(out, want):
                    raise AssertionError(
                        f"{kernel} call {n} on the path (M "
                        f"{args[0].shape[0]}): max |err| "
                        f"{float((out - want).abs().max())} against the "
                        f"plain version")
                checked[kernel] = (n + 1, max(rows, int(args[0].shape[0])))
            return out
        return call

    @contextlib.contextmanager
    def ctx():
        origs = {k: getattr(ops, attr) for k, (attr, _) in plains.items()}
        for k, (attr, plain) in plains.items():
            checked[k] = (0, 0)
            setattr(ops, attr, checking(k, origs[k], plain))
        try:
            yield
        finally:
            for k, (attr, _) in plains.items():
                setattr(ops, attr, origs[k])
    return ctx()


def plain_float64_attention():
    """Context: the plain attention of a ``reference=True`` run evaluates
    the flash kernel's function in float64 (scores, exponentials, sums and
    the PV product; ``p`` still rounded to bf16 before PV) instead of
    float32 -- another valid summation, for the sensitivity run of
    diana_long, as the float32 plain run is for gpu_tc_like."""
    import contextlib
    import torch
    from repro_torch.kernels.flash_attention import PLAIN_Q_BLOCK
    from repro_torch.models import attention as A

    def plain64(q, k, v, *, causal, kv_len, window=None):
        B, Sq, KVH, G, hd = q.shape
        Sk = k.shape[1]
        f64 = torch.float64
        kd, vd = k.to(f64), v.to(f64)
        out = torch.empty(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype,
                          device=q.device)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        for q0 in range(0, Sq, PLAIN_Q_BLOCK):
            qb = q[:, q0:q0 + PLAIN_Q_BLOCK].to(f64)
            n = qb.shape[1]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kd) * hd ** -0.5
            qpos = q0 + torch.arange(n, device=q.device)[:, None]
            mask = torch.ones((n, Sk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos <= qpos
            if kv_len is not None:
                mask &= kpos < kv_len
            if window is not None:
                mask &= kpos > qpos - window
            s = s.masked_fill(~mask, float("-inf"))
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
            acc = torch.einsum("bkgqs,bskd->bqkgd",
                               p.to(v.dtype).to(f64), vd)
            out[:, q0:q0 + n] = (acc / l.clamp_min(1e-30)).to(q.dtype)
            del s, p, acc
        return out

    @contextlib.contextmanager
    def ctx():
        orig = A.attention_plain
        A.attention_plain = plain64
        try:
            yield
        finally:
            A.attention_plain = orig
    return ctx()


def plain_float64_ssm():
    """Context: the Mamba2 blocks sum their SSM in float64 (the chunked
    SSD and the per-step recurrence, `ssm._ssd_chunked` / `ssm._ssd_step`,
    on float64 copies of their float32 inputs; the state and outputs
    rounded back to float32), and so do the mLSTM blocks (`ssm.
    _mlstm_chunked` / `ssm._mlstm_step`, gates and state in float64) --
    another valid summation, for the sensitivity run of zamba2's and
    xlstm's speculative legs (sLSTM steps alike in verify and decode)."""
    import contextlib
    import torch
    from repro_torch.models import ssm

    def f64(fn):
        def run(xs, Bt, Ct, dt, la, h0, *args, **kw):
            h, y = fn(xs, Bt, Ct, dt.double(), la.double(), h0.double(),
                      *args, **kw)
            return h.to(torch.float32), y.to(torch.float32)
        return run

    def mlstm_f64(fn):
        def run(q, k, v, ig, fg, state, *args, **kw):
            st, h = fn(q, k, v, ig.double(), fg.double(),
                       tuple(t.double() for t in state), *args, **kw)
            return (tuple(t.to(torch.float32) for t in st),
                    h.to(torch.float32))
        return run

    names = ("_ssd_chunked", "_ssd_step", "_mlstm_chunked", "_mlstm_step")

    @contextlib.contextmanager
    def ctx():
        orig = [getattr(ssm, name) for name in names]
        for name, fn in zip(names, orig):
            setattr(ssm, name, (f64 if "ssd" in name else mlstm_f64)(fn))
        try:
            yield
        finally:
            for name, fn in zip(names, orig):
                setattr(ssm, name, fn)
    return ctx()


def logit_distance(torch, a, b):
    """(max |a - b|, RMS of a - b) over (B, vocab) logits."""
    d = a.double() - b.double()
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def phase_long(torch, cfg, params, prompts):
    """diana_long: the long-prompt traffic on the diana artifact of the
    diana phase (module docstring); returns (launches of the kernel run,
    serving record, largest |error| of the prefill's flash calls)."""
    from repro_torch.api import MappingArtifact
    from repro_torch.launch.serve import (check_coverage, kv_cache_for,
                                          plan_mapping_execution)
    from repro_torch.serving import Engine, Request
    path = "diana_long"
    art = MappingArtifact.load(
        str(ROOT / "build" / "chip_smoke" / f"{cfg.name}_diana.json"))
    t0 = time.perf_counter()
    plan, backend = plan_mapping_execution(params, art)
    check_coverage("serve", backend, require_full=True)
    cfg = kv_cache_for(cfg, art)
    print(f"[serve:{path}] {backend.coverage()} (lower and bind "
          f"{time.perf_counter() - t0:.1f} s)")
    want = dict.fromkeys(KERNELS, 0)
    for kernel, count, _ in path_layers("diana").values():
        want[kernel] += count * GEN_LEN
    want["flash_attention"] = cfg.n_layers      # one per layer, in prefill
    B, P = prompts.shape
    reqs = [Request(rid=b, prompt=row, max_new_tokens=GEN_LEN)
            for b, row in enumerate(prompts.cpu().numpy())]

    def serve(calls=None):
        """The dense engine, one admission group of the B prompts (one
        prefill at M B x P), then GEN_LEN - 1 decode steps: (tokens,
        stats, prefill logits, top-2 margins per step) with ``calls``,
        (tokens, stats) without."""
        import contextlib
        engine = Engine(cfg, params, max_batch=B, max_len=LONG_CACHE,
                        backend=backend, kv_layout="dense", prefill_bucket=P)
        with (recording_logits(calls) if calls is not None
              else contextlib.nullcontext()):
            results = engine.run(reqs)
        tokens = torch.tensor([r.tokens for r in results])
        if calls is None:
            return tokens, engine.stats
        return (tokens, engine.stats) + batch_logits(torch, tokens, calls)

    calls, checked = [], {}
    limits = dict.fromkeys(KERNELS, 0)
    for kernel, count, _ in path_layers("diana").values():
        limits[kernel] += count       # one forward pass: the prefill
    reset_launches()
    with recording_flash(calls), checking_matmuls(checked, limits):
        tokens, stats, logits, _ = serve([])
    launches = kernel_launches()
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, expected "
                             f"{want}")
    check_no_weight_copies(path)
    if tuple(tokens.shape) != (B, GEN_LEN) or \
            tuple(logits.shape) != (B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{path}: serving output has the wrong shape "
                             f"or is not finite")
    print(f"[serve:{path}] {B} requests x prompt {P} + gen {GEN_LEN} in a "
          f"{LONG_CACHE}-slot {cfg.kv_cache_dtype} cache (dense engine, one "
          f"admission group): prefill "
          f"{stats['prefill_s'] * 1e3:.3f} ms with the matmul checks inline,"
          f" decode {stats['decode_s'] * 1e3:.3f} ms "
          f"({stats['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step)")
    print(f"[serve:{path}] launches: " + " ".join(
        f"{k} {v}" for k, v in launches.items() if v) +
        "; weights copied per call: " + ", ".join(
            f"{k} 0" for k in weight_copies()))
    for kernel, (n, rows) in checked.items():
        if n != limits[kernel] or (n and rows != B * P):
            raise AssertionError(f"{path}: {n} {kernel} calls of the "
                                 f"prefill checked (largest M {rows}), "
                                 f"expected {limits[kernel]} at M {B * P}")
    print(f"[serve:{path}] the " + " and the ".join(
        f"{n} {k}" for k, (n, _) in checked.items()) +
        f" calls of the prefill (M {B * P}; the head's M {B}) are "
        f"bit-identical to the plain version on their own inputs")

    if len(calls) != cfg.n_layers:
        raise AssertionError(f"{path}: {len(calls)} flash calls recorded")
    worst_err = worst_ratio = 0.0
    for i, (q, k, v, kw, out) in enumerate(calls):
        err, ratio = check_flash(torch, q, k, v, out, kw["causal"],
                                 kw["kv_len"], f"{path} layer {i}")
        worst_err, worst_ratio = max(worst_err, err), max(worst_ratio, ratio)
    shapes = calls[0]
    print(f"[serve:{path}] the {len(calls)} flash_attention calls of the "
          f"prefill (q {tuple(shapes[0].shape)}, k {tuple(shapes[1].shape)},"
          f" kv_len {shapes[3]['kv_len']}) agree with the plain version on "
          f"their own inputs: max |err| {worst_err:.4g}, at most "
          f"{worst_ratio:.4g} of the bound")
    del calls, shapes
    gc.collect()

    # the kernel run differs from the plain run only in flash's summation
    # order (the matmul kernels are bit-identical to their plain
    # versions); a plain run in float64 attention differs from it by
    # another valid one
    backend.reference = True
    ref_tokens, ref_stats, ref_logits, margins = serve([])
    with plain_float64_attention():
        tok64, st64, logits64, _ = serve([])
    if kernel_launches() != want:
        raise AssertionError(f"{path}: a plain run launched a kernel")
    spread, spread_rms = logit_distance(torch, logits64, ref_logits)
    diff, diff_rms = logit_distance(torch, logits, ref_logits)
    tol, tol_rms = SENSITIVITY_FACTOR * spread, SENSITIVITY_FACTOR * spread_rms
    # what an output unrelated to the plain run's would give: the plain
    # logits of another request
    other, other_rms = logit_distance(torch, ref_logits.roll(1, dims=0),
                                      ref_logits)
    print(f"[serve:{path}] plain run: prefill "
          f"{ref_stats['prefill_s'] * 1e3:.3f} ms, max |logit| "
          f"{float(ref_logits.abs().max()):.4g}; plain run in float64 "
          f"attention: prefill logits max |diff| {spread:.4g}, RMS "
          f"{spread_rms:.4g} from it, tokens identical "
          f"{torch.equal(tok64, ref_tokens)}; another request's logits: max "
          f"|diff| {other:.4g}, RMS {other_rms:.4g}")
    compared, _ = compare_requests(path, tokens.tolist(), ref_tokens.tolist(),
                                   margins.tolist(), [tol] * B)
    print(f"[serve:{path}] tolerance {SENSITIVITY_FACTOR:g} x the float64 "
          f"run's distance: max {tol:.4g}, RMS {tol_rms:.4g}; kernel "
          f"prefill logits max |diff| {diff:.4g} (ratio "
          f"{diff / max(spread, 1e-30):.3g}), RMS {diff_rms:.4g} (ratio "
          f"{diff_rms / max(spread_rms, 1e-30):.3g}); tokens identical over "
          f"{compared} of {B * GEN_LEN} (row, step) pairs before the first "
          f"plain top-2 margin below the max tolerance")
    if diff > tol or diff_rms > tol_rms:
        raise AssertionError(f"{path}: prefill logits differ by max {diff} "
                             f"> {tol} or RMS {diff_rms} > {tol_rms}")
    backend.reference = False

    torch.cuda.reset_peak_memory_stats()
    _, warm = serve()
    check_no_weight_copies(path)    # over every run of the path
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve:{path}] warm run: prefill {warm['prefill_s'] * 1e3:.3f} "
          f"ms, decode {warm['decode_s'] * 1e3:.3f} ms "
          f"({warm['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step), peak "
          f"memory {peak:.2f} GiB")
    record = {"checked_prefill_ms": stats["prefill_s"] * 1e3,
              "decode_ms_per_step": stats["decode_s"] * 1e3 / (GEN_LEN - 1),
              "plain_prefill_ms": ref_stats["prefill_s"] * 1e3,
              "warm_prefill_ms": warm["prefill_s"] * 1e3,
              "warm_decode_ms_per_step":
                  warm["decode_s"] * 1e3 / (GEN_LEN - 1),
              "peak_gib": peak, "kv_cache_dtype": cfg.kv_cache_dtype,
              "matmul_calls_checked": {k: n for k, (n, _) in checked.items()},
              "flash_calls_worst_error_over_bound": worst_ratio,
              "max_abs_logit": float(ref_logits.abs().max()),
              "float64_plain_max_abs_diff": spread,
              "float64_plain_rms_diff": spread_rms,
              "other_request_max_abs_diff": other,
              "other_request_rms_diff": other_rms,
              "tolerance": tol, "tolerance_rms": tol_rms,
              "prefill_logits_max_abs_diff": diff,
              "prefill_logits_rms_diff": diff_rms,
              "tokens_compared": compared}
    del plan, backend
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record, worst_err


def profile_device(torch, tag, run):
    """Device time by kernel over one call of ``run`` (which returns its
    wall ms), from torch.profiler's device activity (kernels, copies; the
    host's operators are not recorded, which keeps the profiler's own cost
    low), summed straight from the profiler's raw events (its per-event
    Python objects cost minutes at the engine's 400k launches); returns
    the summed device time in ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = run()
    t0 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6
    print(f"[profile:{tag}] profiled run: wall {wall_ms:.3f} ms, device "
          f"kernels {busy_ms:.3f} ms in "
          f"{sum(n for _, n in by_name.values())} launches (events read in "
          f"{time.perf_counter() - t0:.1f} s)")
    for name, (ns, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile:{tag}]   {ns / 1e6:10.3f} ms {n:7d}x  {name[:90]}")
    return busy_ms


def recording_logits(calls):
    """Context: `transformer.prefill`, `prefill_chunk` and `decode_step`
    keep the logits of every call in ``calls`` as ``(kind, logits,
    inputs)``, kind "prefill", "chunk" or "decode"; ``inputs`` is a chunk
    call's (tokens, fill positions, valid counts) on the host, else None.
    The engine looks all three up on the module, so every call of its
    goes through."""
    import contextlib
    from repro_torch.models import transformer as T
    names = {"prefill": "prefill", "chunk": "prefill_chunk",
             "decode": "decode_step"}

    @contextlib.contextmanager
    def ctx():
        orig = {kind: getattr(T, name) for kind, name in names.items()}

        def wrap(kind, fn):
            def recording(*args, **kw):
                logits, caches = fn(*args, **kw)
                inputs = (tuple(args[i].cpu() for i in (2, 4, 5))
                          if kind == "chunk" else None)
                calls.append((kind, logits.float(), inputs))
                return logits, caches
            return recording
        for kind, name in names.items():
            setattr(T, name, wrap(kind, orig[kind]))
        try:
            yield
        finally:
            for kind, name in names.items():
                setattr(T, name, orig[kind])
    return ctx()


def batch_logits(torch, tokens, calls):
    """(prefill logits (B, V), top-2 margins (B, steps)) of a run whose B
    requests, in slots 0..B-1, complete their prompts in one call and then
    decode together until all retire (``serve_batch``; a dense engine's
    single admission group): the last prefill or chunk call before the
    first decode call, then the decode calls.  Each request's tokens are
    checked to be the argmax of its logits."""
    kinds = [kind for kind, _, _ in calls]
    start = kinds.index("decode") if "decode" in kinds else len(calls)
    seq = [calls[start - 1][1]] + [lg for kind, lg, _ in calls[start:]
                                   if kind == "decode"]
    steps = tokens.shape[1]
    if len(seq) != steps or not torch.equal(
            torch.stack([lg.argmax(-1) for lg in seq], 1).cpu(),
            tokens.cpu()):
        raise AssertionError("recorded logits do not give the run's tokens")
    return seq[0], torch.stack([top2_margin(torch, lg) for lg in seq], 1)


def top2_margin(torch, logits):
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def engine_first_logits(torch, results, calls):
    """Each request's prefill logits in an engine run, from its recorded
    prefill calls: one per admission step, whose rows are the group's
    requests in trace order (the continuous policy admits FCFS)."""
    prefills = [lg for kind, lg, _ in calls if kind == "prefill"]
    steps = sorted({r.admitted_step for r in results})
    if len(prefills) != len(steps):
        raise AssertionError(f"{len(prefills)} prefill calls for "
                             f"{len(steps)} admission steps")
    first = [None] * len(results)
    for step, lg in zip(steps, prefills):
        members = [i for i, r in enumerate(results)
                   if r.admitted_step == step]
        for row, i in enumerate(members):
            first[i] = lg[row]
            if int(torch.argmax(lg[row])) != results[i].tokens[0]:
                raise AssertionError(f"request {results[i].rid}: first "
                                     f"token is not its prefill argmax")
    return first


def compare_requests(what, tokens, ref_tokens, ref_margins, tols):
    """Each request's tokens against the reference run's, up to its first
    step whose reference top-2 margin is below the request's tolerance in
    ``tols``; returns (pairs compared, pairs in all)."""
    compared = total = 0
    for i, (got, want, margins, tol) in enumerate(zip(
            tokens, ref_tokens, ref_margins, tols)):
        if len(got) != len(want):
            raise AssertionError(f"{what}: request {i} made {len(got)} "
                                 f"tokens, the reference {len(want)}")
        low = [t for t, m in enumerate(margins) if m < tol]
        upto = low[0] if low else len(want)
        if got[:upto] != want[:upto]:
            raise AssertionError(f"{what}: request {i} tokens differ "
                                 f"before step {upto}")
        compared += upto
        total += len(want)
    return compared, total


def margin_rule(torch, what, tokens, first, ref_tokens, ref_first,
                ref_margins):
    """The margin rule against a reference run: each request's tolerance
    is SENSITIVITY_FACTOR times the distance of its prefill logits from
    the reference's (0 where they are bit-identical: then every token must
    agree); fails when fewer than half of all tokens were compared.
    Returns (pairs compared, pairs in all, largest distance)."""
    dists = [float((a - b).abs().max()) for a, b in zip(first, ref_first)]
    tols = [SENSITIVITY_FACTOR * d for d in dists]
    compared, total = compare_requests(what, tokens, ref_tokens,
                                       ref_margins, tols)
    print(f"[engine:{what}] prefill logits max |diff| per request "
          f"{' '.join(f'{d:.4g}' for d in dists)}; tolerance "
          f"{SENSITIVITY_FACTOR:g} x each; tokens identical over {compared} "
          f"of {total} (request, step) pairs before each request's first "
          f"reference top-2 margin below its tolerance (identical "
          f"everywhere: {tokens == ref_tokens})")
    if 2 * compared < total:
        raise AssertionError(f"{what}: only {compared} of {total} tokens "
                             f"compared, too few for the check to say "
                             f"anything")
    return compared, total, max(dists)


def per_request_serving(torch, cfg, params, requests, backend, max_len):
    """Each request alone through a one-slot dense engine (the leg's cache
    length): (tokens, per-step top-2 margins, prefill logits) per
    request."""
    from repro_torch.serving import Engine, Request
    tokens, margins, first = [], [], []
    for r in requests:
        calls = []
        engine = Engine(cfg, params, max_batch=1, max_len=max_len,
                        backend=backend, kv_layout="dense")
        with recording_logits(calls):
            (res,) = engine.run([Request(rid=r.rid, prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens,
                                         eos_id=r.eos_id)])
        tokens.append(res.tokens)
        margins.append([float(top2_margin(torch, lg)[0])
                        for _, lg, _ in calls])
        first.append(calls[0][1][0])
    return tokens, margins, first


def engine_run(torch, cfg, params, backend, trace, leg, calls=None,
               engine=None):
    """One run of ``trace`` on ``engine``, or on a new engine of the leg's
    configuration (logits recorded into ``calls`` when given); returns
    (engine, results, launches)."""
    import contextlib
    from repro_torch.serving import Engine
    if engine is None:
        engine = Engine(cfg, params, max_batch=leg["max_batch"],
                        max_len=leg["max_len"], backend=backend,
                        **{key: leg[key] for key in
                           ("kv_layout", "prefill_chunk", "prefix_cache",
                            "prefill_bucket") if key in leg})
    reset_launches()
    with (recording_logits(calls) if calls is not None
          else contextlib.nullcontext()):
        results = engine.run(trace)
    return engine, results, kernel_launches()


def print_engine_run(tag, engine, results, smi):
    """TTFT p50/p95, decode tok/s, steps, prefill calls, wall; returns the
    record."""
    from repro_torch.serving import summarize
    st = engine.stats
    summ = summarize(results, st["wall_s"])
    decoded = sum(r.n_tokens - 1 for r in results)
    rec = {"ttft_p50_s": summ["ttft_p50_s"], "ttft_p95_s": summ["ttft_p95_s"],
           "decode_tok_s_p50": summ["decode_tok_s_p50"],
           "decode_tok_s": decoded / max(st["decode_s"], 1e-9),
           "total_tok_s": summ["total_tok_s"],
           "decode_steps": st["decode_steps"],
           "prefill_calls": st["prefill_calls"], "wall_s": st["wall_s"],
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "tokens": summ["total_tokens"],
           "kv_peak_bytes": st["kv_peak_bytes"],
           "kv_capacity_bytes": st["kv_capacity_bytes"]}
    print(f"[engine:{tag}] {len(results)} requests, {rec['tokens']} tokens: "
          f"TTFT p50 {rec['ttft_p50_s'] * 1e3:.3f} ms / p95 "
          f"{rec['ttft_p95_s'] * 1e3:.3f} ms, decode {rec['decode_tok_s']:.3f}"
          f" tok/s over all slots (per-request p50 "
          f"{rec['decode_tok_s_p50']:.3f}), {rec['decode_steps']} decode "
          f"steps ({st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.3f} "
          f"ms/step), {rec['prefill_calls']} prefill calls "
          f"({st['prefill_s'] * 1e3:.3f} ms), wall {st['wall_s']:.3f} s "
          f"({smi})")
    return rec


def phase_engine(torch, cfg, params, seed, smi):
    """The continuous-batching engine (dense KV layout) on the diana
    artifact of phase 5: legs engine_mixed and engine_long (module
    docstring); returns ({leg: record}, {leg: what the paged legs are
    held against})."""
    from repro_torch.api import MappingArtifact
    from repro_torch.launch.serve import (check_coverage, kv_cache_for,
                                          plan_mapping_execution)
    from repro_torch.serving import (Request, poisson_arrivals,
                                     synthetic_trace)
    import numpy as np
    art = MappingArtifact.load(
        str(ROOT / "build" / "chip_smoke" / f"{cfg.name}_diana.json"))
    plan, backend = plan_mapping_execution(params, art)
    check_coverage("engine", backend, require_full=True)
    cfg = kv_cache_for(cfg, art)
    hist = plan.kernel_histogram()
    print(f"[engine] diana artifact: {backend.coverage()}, kernels "
          f"{hist}, kv {cfg.kv_cache_dtype}")
    mixed = dict(ENGINE_MIXED)
    trace = poisson_arrivals(synthetic_trace(
        mixed["requests"], vocab=cfg.vocab, min_prompt=mixed["min_prompt"],
        max_prompt=mixed["max_prompt"], min_new=mixed["min_new"],
        max_new=mixed["max_new"], seed=seed), mixed["rate"], seed=seed)
    rng = np.random.default_rng(seed)
    long = dict(ENGINE_LONG)
    long_trace = [Request(rid=f"l{i}", prompt=rng.integers(0, cfg.vocab, n),
                          max_new_tokens=long["new"])
                  for i, n in enumerate(long["prompts"])]
    out, refs = {}, {}
    for tag, leg, reqs in (("engine_mixed", mixed, trace),
                           ("engine_long", long, long_trace)):
        print_traffic(tag, reqs, leg)
        out[tag], refs[tag] = engine_leg(torch, tag, cfg, params, backend,
                                         hist, reqs, leg, smi)
    del plan, backend
    gc.collect()
    torch.cuda.empty_cache()
    return out, refs


def print_traffic(tag, reqs, leg):
    print(f"[engine:{tag}] {len(reqs)} requests, prompts "
          f"{sorted(r.prompt_len for r in reqs)}, new "
          f"{sorted(r.max_new_tokens for r in reqs)}, arrival steps "
          f"{sorted(r.arrival_step for r in reqs)}; max_batch "
          f"{leg['max_batch']}, max_len {leg['max_len']}, "
          + ", ".join(f"{k} {leg[k]}" for k in
                      ("kv_layout", "prefill_chunk", "shared_prefix")
                      if k in leg))


def engine_leg(torch, tag, cfg, params, backend, hist, trace, leg, smi):
    """One leg: the kernel run (launch counts, weight copies, finish
    reasons), the plain run (``reference=True``), each request alone
    through a one-slot dense engine, a warm run and a profiled one;
    returns the leg's record and its reference for the paged legs (the
    kernel run's tokens and prefill logits, the per-request runs'
    margins; with flash, the tolerances and the plain run's margins).  Without flash on the path the plain run must give
    identical tokens and the one-slot runs agree under the per-request margin
    rule (`margin_rule`).  With flash, whose sums run in another order
    than its plain version's, the check is diana_long's: a plain run with
    float64 attention measures how far another valid summation moves the
    prefill logits, and the kernel run must lie within SENSITIVITY_FACTOR
    times that of the plain run and of the one-slot runs (max and RMS),
    tokens compared under the margin rule at that tolerance."""
    from repro_torch.models import transformer as T
    t_leg = time.perf_counter()

    def at():
        return f"{time.perf_counter() - t_leg:.1f} s into the leg"
    calls = []
    engine, results, launches = engine_run(torch, cfg, params, backend,
                                           trace, leg, calls)
    st = dict(engine.stats)
    forwards = st["prefill_calls"] + st["decode_steps"]
    # admission groups whose padded prompt takes the chunked attention
    group_prompt = {}
    for r in results:
        group_prompt[r.admitted_step] = max(
            group_prompt.get(r.admitted_step, 0), r.prompt_len)
    long_groups = sum(engine._bucket(p) > T.CHUNKED_ABOVE
                      for p in group_prompt.values())
    want = dict.fromkeys(KERNELS, 0)
    for kernel, count in hist.items():
        want[kernel] += count * forwards
    want["flash_attention"] = cfg.n_layers * long_groups
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want} "
                             f"({st['prefill_calls']} prefill calls + "
                             f"{st['decode_steps']} decode steps)")
    check_no_weight_copies(tag)
    for req, res in zip(trace, results):
        if res.finish_reason not in ("max_new_tokens", "eos") or \
                (res.finish_reason == "max_new_tokens"
                 and res.n_tokens != req.max_new_tokens):
            raise AssertionError(f"{tag}: request {res.rid} finished "
                                 f"{res.finish_reason} with {res.n_tokens} "
                                 f"tokens")
    print(f"[engine:{tag}] first run {st['wall_s']:.3f} s: every request "
          f"finished ({sorted({r.finish_reason for r in results})}); "
          f"launches " + " ".join(f"{k} {v} ({v // forwards} per forward)"
                                  for k, v in launches.items()
                                  if v and k != "flash_attention") +
          (f" flash_attention {launches['flash_attention']} "
           f"({cfg.n_layers} per long prefill group x {long_groups})"
           if long_groups else "") +
          f" over {st['prefill_calls']} prefill calls + {st['decode_steps']}"
          f" decode steps; weights copied per call: " +
          ", ".join(f"{k} 0" for k in weight_copies()))
    if long_groups:
        print(f"[engine:{tag}] {long_groups} admission group(s) prefilled "
              f"through the chunked (flash) attention with an int kv_len; "
              f"no engine path reached the per-slot kv_len "
              f"NotImplementedError")
    first = engine_first_logits(torch, results, calls)
    tokens = [r.tokens for r in results]
    del calls
    rec = {"first_run_s": st["wall_s"], "launches": launches,
           "forwards": forwards, "long_prefill_groups": long_groups}

    backend.reference = True
    ref_calls = []
    ref_engine, ref_results, ref_launches = engine_run(
        torch, cfg, params, backend, trace, leg, ref_calls)
    if any(ref_launches.values()):
        raise AssertionError(f"{tag}: the plain run launched a kernel "
                             f"{ref_launches}")
    ref_tokens = [r.tokens for r in ref_results]
    ref_first = engine_first_logits(torch, ref_results, ref_calls)
    print(f"[engine:{tag}] plain-version run "
          f"({ref_engine.stats['wall_s']:.3f} s; {at()}): tokens identical "
          f"for every request {tokens == ref_tokens}")
    rec["tokens_identical_to_plain"] = tokens == ref_tokens
    tol = tol_rms = None
    if long_groups:
        # margins of the plain run: all its requests sit in slots 0..B-1
        # from step 0 and decode every step
        decodes = [lg for kind, lg, _ in ref_calls if kind == "decode"]
        ref_margins = [[float(top2_margin(torch, ref_first[i]))] +
                       [float(top2_margin(torch, lg[i]))
                        for lg in decodes[:len(ref_tokens[i]) - 1]]
                       for i in range(len(ref_tokens))]
        f64_calls = []
        with plain_float64_attention():
            _, f64_results, _ = engine_run(torch, cfg, params, backend,
                                           trace, leg, f64_calls)
        f64_first = engine_first_logits(torch, f64_results, f64_calls)
        del f64_calls
        ref_stack = torch.stack(ref_first)
        spread, spread_rms = logit_distance(torch, torch.stack(f64_first),
                                            ref_stack)
        other, other_rms = logit_distance(torch, ref_stack.roll(1, dims=0),
                                          ref_stack)
        tol, tol_rms = SENSITIVITY_FACTOR * spread, \
            SENSITIVITY_FACTOR * spread_rms
        print(f"[engine:{tag}] plain run in float64 attention ({at()}): "
              f"prefill logits max |diff| {spread:.4g}, RMS "
              f"{spread_rms:.4g} from the plain run's; another request's "
              f"logits: max |diff| {other:.4g}, RMS {other_rms:.4g}; "
              f"tolerance {SENSITIVITY_FACTOR:g} x: max {tol:.4g}, RMS "
              f"{tol_rms:.4g}")
        diff, diff_rms = logit_distance(torch, torch.stack(first),
                                        ref_stack)
        compared, total = compare_requests(f"{tag} vs plain", tokens,
                                           ref_tokens, ref_margins,
                                           [tol] * len(tokens))
        print(f"[engine:{tag}] kernel run vs plain run: prefill logits max "
              f"|diff| {diff:.4g} (ratio {diff / max(spread, 1e-30):.3g}),"
              f" RMS {diff_rms:.4g} (ratio "
              f"{diff_rms / max(spread_rms, 1e-30):.3g}); tokens identical "
              f"over {compared} of {total} (request, step) pairs before the "
              f"first plain top-2 margin below the max tolerance")
        if diff > tol or diff_rms > tol_rms:
            raise AssertionError(f"{tag}: prefill logits differ from the "
                                 f"plain run's by max {diff} > {tol} or RMS "
                                 f"{diff_rms} > {tol_rms}")
        rec.update(float64_plain_max_abs_diff=spread,
                   float64_plain_rms_diff=spread_rms,
                   other_request_max_abs_diff=other,
                   other_request_rms_diff=other_rms,
                   plain_prefill_logits_max_abs_diff=diff,
                   plain_prefill_logits_rms_diff=diff_rms,
                   plain_tokens_compared=compared)
    elif tokens != ref_tokens:
        # the integer kernels are bit-exact and the plain run has the same
        # schedule and shapes: every request's tokens must be identical
        raise AssertionError(f"{tag}: kernel and plain-version engine runs "
                             f"disagree")
    backend.reference = False
    del ref_calls

    sb_tokens, sb_margins, sb_first = per_request_serving(
        torch, cfg, params, trace, backend, leg["max_len"])
    print(f"[engine:{tag}] each request alone through a one-slot dense "
          f"engine (max_len {leg['max_len']}; {at()}):")
    if long_groups:
        diff, diff_rms = logit_distance(torch, torch.stack(first),
                                        torch.stack(sb_first))
        dists = [float((a - b).abs().max()) for a, b in zip(first, sb_first)]
        compared, total = compare_requests(f"{tag} vs alone", tokens,
                                           sb_tokens, sb_margins,
                                           [tol] * len(tokens))
        print(f"[engine:{tag} vs alone] prefill logits max |diff| "
              f"{diff:.4g} (per request {' '.join(f'{d:.4g}' for d in dists)}"
              f"), RMS {diff_rms:.4g}; tolerance max {tol:.4g}, RMS "
              f"{tol_rms:.4g}; tokens identical over {compared} of {total} "
              f"(request, step) pairs before the first top-2 margin below "
              f"the max tolerance (identical everywhere: "
              f"{tokens == sb_tokens})")
        if diff > tol or diff_rms > tol_rms:
            raise AssertionError(f"{tag}: prefill logits differ from "
                                 f"the one-slot runs' by max {diff} > {tol} or "
                                 f"RMS {diff_rms} > {tol_rms}")
    else:
        compared, total, diff = margin_rule(
            torch, f"{tag} vs alone", tokens, first, sb_tokens,
            sb_first, sb_margins)
    rec.update(alone_prefill_logits_max_abs_diff=diff,
               alone_tokens_compared=compared, tokens_total=total)
    ref = {"tokens": tokens, "first": first, "sb_margins": sb_margins}
    if long_groups:
        ref.update(tol=tol, tol_rms=tol_rms, ref_margins=ref_margins)

    torch.cuda.reset_peak_memory_stats()
    engine, results, _ = engine_run(torch, cfg, params, backend, trace, leg)
    check_no_weight_copies(tag)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if [r.tokens for r in results] != tokens:
        raise AssertionError(f"{tag}: the warm run's tokens differ from "
                             f"the first run's")
    rec.update(print_engine_run(tag, engine, results, smi), peak_gib=peak)
    print(f"[engine:{tag}] warm run peak memory {peak:.2f} GiB ({smi})")

    def profiled():
        eng, _, _ = engine_run(torch, cfg, params, backend, trace, leg)
        return eng.stats["wall_s"] * 1e3
    busy_ms = profile_device(torch, tag, profiled)
    wall_ms = rec["wall_s"] * 1e3
    rec.update(device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms)
    print(f"[profile:{tag}] device busy {busy_ms:.3f} ms of the warm run's "
          f"{wall_ms:.3f} ms wall: idle share {rec['idle_share']:.3f} "
          f"({at()})")
    return rec, ref


def paged_request_logits(torch, requests, results, calls):
    """Each request's prefill logits and per-step top-2 margins in a paged
    engine run without preemption: its prompt completes in the chunk call
    whose row b (its slot) holds the prompt's last tokens at fill + valid
    == prompt length, and it decodes in slot b in each decode call after
    that until it retires.  Every token is checked to be the argmax of its
    logits (greedy), which holds the mapping.  Returns (first, margins)."""
    import numpy as np
    first, margins = [], []
    for req, res in zip(requests, results):
        plen = req.prompt_len
        hits = []
        for i, (kind, lg, inputs) in enumerate(calls):
            if kind != "chunk":
                continue
            tokens, index, valid = inputs
            for b in range(len(valid)):
                v = int(valid[b])
                if v and int(index[b]) + v == plen and np.array_equal(
                        tokens[b, :v].numpy(), req.prompt[plen - v:]) and \
                        int(torch.argmax(lg[b])) == res.tokens[0]:
                    hits.append((i, b))
        if len(hits) != 1:
            raise AssertionError(f"request {res.rid}: {len(hits)} chunk "
                                 f"rows complete its prompt")
        i, b = hits[0]
        seq = [calls[i][1][b]] + [lg[b] for kind, lg, _ in calls[i + 1:]
                                  if kind == "decode"][:res.n_tokens - 1]
        got = [int(torch.argmax(lg)) for lg in seq]
        if got != res.tokens:
            raise AssertionError(f"request {res.rid}: recorded logits give "
                                 f"{got}, the run {res.tokens}")
        first.append(seq[0])
        margins.append([float(top2_margin(torch, lg)) for lg in seq])
    return first, margins


def capturing_paged_update(store, at):
    """Context: call ``at`` (0-based) of `attention.paged_update` keeps
    its inputs, the pool before and after the write and the gathered view
    in ``store`` (clones on the card); every call writes as before."""
    import contextlib
    from repro_torch.models import attention as A

    @contextlib.contextmanager
    def ctx():
        orig = A.paged_update
        count = [0]

        def capture(pool, val, pages, index, mask=None):
            hit = count[0] == at
            count[0] += 1
            if hit:
                store.update(pool=pool.clone(), val=val.clone(),
                             pages=pages.clone(), index=index.clone(),
                             mask=None if mask is None else mask.clone())
            out = orig(pool, val, pages, index, mask)
            if hit:
                store.update(after=out.clone(),
                             view=A.paged_gather(out, pages))
            return out
        A.paged_update = capture
        try:
            yield
        finally:
            A.paged_update = orig
    return ctx()


def check_paged_capture(torch, tag, store, at=CAPTURE_CALL):
    """The captured `paged_update` / `paged_gather` call ``at`` on the
    card against the same calls on the CPU: the pool outside the trash
    page and the gathered rows of mapped pages equal."""
    from repro_torch.models import attention as A
    if "after" not in store:
        raise AssertionError(f"{tag}: paged_update call {at} never made")
    cpu = {k: (v.cpu() if v is not None else None)
           for k, v in store.items()}
    want = A.paged_update(cpu["pool"], cpu["val"], cpu["pages"],
                          cpu["index"], cpu["mask"])
    ps = want.shape[1]
    mapped = (cpu["pages"] > 0).repeat_interleave(ps, dim=1)
    if not torch.equal(cpu["after"][1:], want[1:]) or not torch.equal(
            cpu["view"][mapped], A.paged_gather(want, cpu["pages"])[mapped]):
        raise AssertionError(f"{tag}: paged_update / paged_gather on the "
                             f"card differ from the CPU")
    B, S = cpu["val"].shape[:2]
    live = int(cpu["mask"].sum()) if cpu["mask"] is not None else B * S
    print(f"[engine:{tag}] paged_update call {at} (pool "
          f"{tuple(want.shape)} {want.dtype}, {B} x {S} rows, {live} "
          f"unmasked) and its paged_gather (B {B}, {int(mapped.sum())} "
          f"mapped positions) equal the same calls on the CPU outside the "
          f"trash page")


def paged_run(torch, tag, cfg, params, backend, hist, trace, leg,
              engine=None, decode_hist=None, capture=CAPTURE_CALL):
    """A recorded paged run: launch counts (each planned kernel once per
    chunk call and decode step, flash never; ``decode_hist`` per decode
    step where it is not ``hist``), weight copies, finish reasons, the
    captured paged_update call against the CPU (an arch without attention
    KV, xlstm's, makes none); returns (engine, results, tokens, first,
    margins, stats).  ``capture``: the index of the paged_update call held
    against the CPU."""
    from repro_torch.models import transformer as T
    calls, store = [], {}
    with capturing_paged_update(store, capture):
        engine, results, launches = engine_run(
            torch, cfg, params, backend, trace, leg, calls, engine)
    st = dict(engine.stats)
    forwards = st["prefill_calls"] + st["decode_steps"]
    want = forward_launches(hist, st["prefill_calls"], st["decode_steps"],
                            decode_hist)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want} "
                             f"({st['prefill_calls']} chunk calls + "
                             f"{st['decode_steps']} decode steps)")
    check_no_weight_copies(tag)
    for req, res in zip(trace, results):
        if res.finish_reason not in ("max_new_tokens", "eos") or \
                (res.finish_reason == "max_new_tokens"
                 and res.n_tokens != req.max_new_tokens):
            raise AssertionError(f"{tag}: request {res.rid} finished "
                                 f"{res.finish_reason} with {res.n_tokens} "
                                 f"tokens")
    first, margins = paged_request_logits(torch, trace, results, calls)
    del calls
    print(f"[engine:{tag}] recorded run {st['wall_s']:.3f} s: every request "
          f"finished; launches " + " ".join(
              f"{k} {v} ({v / forwards:g} per forward)"
              for k, v in launches.items() if v) +
          f" over {st['prefill_calls']} chunk calls + {st['decode_steps']} "
          f"decode steps (flash 0: chunks attend through full_attention); "
          f"weights copied per call: 0")
    if any(ax.startswith("page")
           for ax in T.tree_leaves(T.cache_kv_axes(cfg))):
        check_paged_capture(torch, tag, store, capture)
    elif store:
        raise AssertionError(f"{tag}: a paged_update call on an arch "
                             f"without page-resident KV")
    else:
        print(f"[engine:{tag}] no paged_update call: the arch holds no "
              f"attention KV, only per-slot recurrent state")
    return engine, results, [r.tokens for r in results], first, margins, st


def print_paged(tag, st, smi):
    print(f"[engine:{tag}] paged kv: {st['prefill_calls']} chunk calls, "
          f"{st['decode_steps']} decode steps, kv_peak_pages "
          f"{st['kv_peak_pages']} x {st['kv_page_bytes']} B = kv_peak_bytes "
          f"{st['kv_peak_bytes']} of kv_capacity_bytes "
          f"{st['kv_capacity_bytes']} (ratio "
          f"{st['kv_peak_bytes'] / max(st['kv_capacity_bytes'], 1):.3f}; "
          f"0 of 0 where the arch holds no attention KV); prefix "
          f"lookups {st['prefix_lookups']}, hit requests "
          f"{st['prefix_hit_requests']}, hit tokens "
          f"{st['prefix_hit_tokens']}, cow copies {st['cow_copies']}, "
          f"evictions {st['page_evictions']} ({smi})")


def paged_record(st):
    return {k: st[k] for k in ("kv_peak_pages", "kv_page_bytes",
                               "kv_peak_bytes", "kv_capacity_bytes",
                               "prefix_lookups", "prefix_hit_requests",
                               "prefix_hit_tokens", "cow_copies",
                               "page_evictions")}


def warm_paged(torch, tag, cfg, params, backend, trace, leg, tokens, smi,
               engine=None):
    """An unrecorded run for the served metrics (same tokens as the
    recorded run); returns (engine, results, record)."""
    torch.cuda.reset_peak_memory_stats()
    engine, results, _ = engine_run(torch, cfg, params, backend, trace, leg,
                                    engine=engine)
    check_no_weight_copies(tag)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if [r.tokens for r in results] != tokens:
        raise AssertionError(f"{tag}: the warm run's tokens differ from "
                             f"the recorded run's")
    rec = print_engine_run(tag, engine, results, smi)
    print_paged(tag, engine.stats, smi)
    print(f"[engine:{tag}] warm run peak memory {peak:.2f} GiB ({smi})")
    rec.update(paged_record(engine.stats), peak_gib=peak)
    return engine, results, rec


def phase_paged(torch, cfg, params, seed, smi, refs, dense):
    """The paged engine on the diana artifact: legs engine_paged_mixed,
    engine_paged_prefix and engine_paged_long (module docstring), held
    against the dense legs' ``refs``; ``dense`` holds their records for
    the side-by-side lines.  Returns {leg: record}."""
    from repro_torch.api import MappingArtifact
    from repro_torch.launch.serve import (check_coverage, kv_cache_for,
                                          plan_mapping_execution)
    from repro_torch.serving import (Request, poisson_arrivals,
                                     synthetic_trace)
    import numpy as np
    art = MappingArtifact.load(
        str(ROOT / "build" / "chip_smoke" / f"{cfg.name}_diana.json"))
    plan, backend = plan_mapping_execution(params, art)
    check_coverage("engine", backend, require_full=True)
    cfg = kv_cache_for(cfg, art)
    hist = plan.kernel_histogram()
    out = {}

    # engine_paged_mixed: engine_mixed's trace under the JAX defaults
    tag, leg = "engine_paged_mixed", dict(ENGINE_PAGED_MIXED)
    t_leg = time.perf_counter()
    trace = poisson_arrivals(synthetic_trace(
        leg["requests"], vocab=cfg.vocab, min_prompt=leg["min_prompt"],
        max_prompt=leg["max_prompt"], min_new=leg["min_new"],
        max_new=leg["max_new"], seed=seed), leg["rate"], seed=seed)
    print_traffic(tag, trace, leg)
    _, _, tokens, first, _, _ = paged_run(torch, tag, cfg, params, backend,
                                          hist, trace, leg)
    ref = refs["engine_mixed"]
    compared, total, diff = margin_rule(
        torch, f"{tag} vs engine_mixed", tokens, first, ref["tokens"],
        ref["first"], ref["sb_margins"])
    _, _, rec = warm_paged(torch, tag, cfg, params, backend, trace, leg,
                           tokens, smi)

    def profiled():
        eng, _, _ = engine_run(torch, cfg, params, backend, trace, leg)
        return eng.stats["wall_s"] * 1e3
    busy_ms = profile_device(torch, tag, profiled)
    wall_ms = rec["wall_s"] * 1e3
    rec.update(device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
               dense_prefill_logits_max_abs_diff=diff,
               dense_tokens_compared=compared, tokens_total=total)
    d = dense["engine_mixed"]
    print(f"[profile:{tag}] device busy {busy_ms:.3f} ms of the warm run's "
          f"{wall_ms:.3f} ms wall: idle share {rec['idle_share']:.3f}")
    print(f"[engine:{tag}] paged vs dense (engine_mixed, this run): TTFT "
          f"p50 {rec['ttft_p50_s'] * 1e3:.3f} / {d['ttft_p50_s'] * 1e3:.3f} "
          f"ms, p95 {rec['ttft_p95_s'] * 1e3:.3f} / "
          f"{d['ttft_p95_s'] * 1e3:.3f} ms; decode tok/s "
          f"{rec['decode_tok_s']:.3f} / {d['decode_tok_s']:.3f}; forwards "
          f"{rec['prefill_calls']} + {rec['decode_steps']} / "
          f"{d['prefill_calls']} + {d['decode_steps']}; kv_peak_bytes "
          f"{rec['kv_peak_bytes']} / {d['kv_peak_bytes']} "
          f"({time.perf_counter() - t_leg:.1f} s)")
    out[tag] = rec

    # engine_paged_prefix: one system prompt shared by every chat, served
    # cold and then warm on one engine, against the prefix cache off
    tag, leg = "engine_paged_prefix", dict(ENGINE_PAGED_PREFIX)
    t_leg = time.perf_counter()
    trace = synthetic_trace(
        leg["requests"], vocab=cfg.vocab, min_prompt=leg["min_prompt"],
        max_prompt=leg["max_prompt"], min_new=leg["min_new"],
        max_new=leg["max_new"], seed=seed,
        shared_prefix=leg["shared_prefix"])
    print_traffic(tag, trace, leg)
    runs = {}
    engine = None
    for run in ("cold", "warm"):
        engine, results, tokens, first, _, st = paged_run(
            torch, f"{tag}:{run}", cfg, params, backend, hist, trace, leg,
            engine)
        prev = runs.get("cold", {}).get("stats", dict.fromkeys(st, 0))
        hits = {k: st[k] - prev[k] for k in
                ("prefix_lookups", "prefix_hit_requests",
                 "prefix_hit_tokens", "cow_copies", "page_evictions")}
        rec = print_engine_run(f"{tag}:{run}", engine, results, smi)
        print(f"[engine:{tag}:{run}] this run's prefix lookups "
              f"{hits['prefix_lookups']}, hit requests "
              f"{hits['prefix_hit_requests']} of {len(trace)}, hit tokens "
              f"{hits['prefix_hit_tokens']} of "
              f"{sum(r.prompt_len for r in trace)} prompt tokens, cow "
              f"copies {hits['cow_copies']}, evictions "
              f"{hits['page_evictions']}")
        print_paged(f"{tag}:{run}", st, smi)
        rec.update(paged_record(st), run=hits)
        runs[run] = dict(rec=rec, stats=st, tokens=tokens, first=first)
    if runs["cold"]["rec"]["run"]["prefix_hit_tokens"] <= 0:
        raise AssertionError(f"{tag}: the cold run hit no prefix")
    off = dict(leg, prefix_cache=False)
    _, _, ref_tokens, ref_first, ref_margins, ref_st = paged_run(
        torch, f"{tag}:off", cfg, params, backend, hist, trace, off)
    if ref_st["prefix_hit_tokens"]:
        raise AssertionError(f"{tag}: the prefix cache was not off")
    for run in ("cold", "warm"):
        compared, total, diff = margin_rule(
            torch, f"{tag}:{run} vs prefix cache off", runs[run]["tokens"],
            runs[run]["first"], ref_tokens, ref_first, ref_margins)
        runs[run]["rec"].update(off_prefill_logits_max_abs_diff=diff,
                                off_tokens_compared=compared,
                                tokens_total=total)
    print(f"[engine:{tag}] TTFT p50 / p95: cold "
          f"{runs['cold']['rec']['ttft_p50_s'] * 1e3:.3f} / "
          f"{runs['cold']['rec']['ttft_p95_s'] * 1e3:.3f} ms, warm "
          f"{runs['warm']['rec']['ttft_p50_s'] * 1e3:.3f} / "
          f"{runs['warm']['rec']['ttft_p95_s'] * 1e3:.3f} ms; chunk calls "
          f"cold {runs['cold']['rec']['prefill_calls']}, warm "
          f"{runs['warm']['rec']['prefill_calls']}, prefix cache off "
          f"{ref_st['prefill_calls']} ({time.perf_counter() - t_leg:.1f} s)")
    out[tag] = {run: runs[run]["rec"] for run in runs}
    out[tag]["off_prefill_calls"] = ref_st["prefill_calls"]

    # engine_paged_long: engine_long's requests in chunks of 512
    tag, leg = "engine_paged_long", dict(ENGINE_PAGED_LONG)
    t_leg = time.perf_counter()
    rng = np.random.default_rng(seed)
    trace = [Request(rid=f"l{i}", prompt=rng.integers(0, cfg.vocab, n),
                     max_new_tokens=leg["new"])
             for i, n in enumerate(leg["prompts"])]
    print_traffic(tag, trace, leg)
    _, _, tokens, first, _, _ = paged_run(torch, tag, cfg, params, backend,
                                          hist, trace, leg)
    ref = refs["engine_long"]
    diff, diff_rms = logit_distance(torch, torch.stack(first),
                                    torch.stack(ref["first"]))
    compared, total = compare_requests(f"{tag} vs engine_long", tokens,
                                       ref["tokens"], ref["ref_margins"],
                                       [ref["tol"]] * len(tokens))
    print(f"[engine:{tag}] vs engine_long's kernel run (flash in one "
          f"group): prefill logits max |diff| {diff:.4g}, RMS "
          f"{diff_rms:.4g}; engine_long's tolerance max {ref['tol']:.4g}, "
          f"RMS {ref['tol_rms']:.4g}; tokens identical over {compared} of "
          f"{total} (request, step) pairs before the first plain top-2 "
          f"margin below the max tolerance (identical everywhere: "
          f"{tokens == ref['tokens']})")
    if diff > ref["tol"] or diff_rms > ref["tol_rms"]:
        raise AssertionError(f"{tag}: prefill logits differ from "
                             f"engine_long's by max {diff} > {ref['tol']} "
                             f"or RMS {diff_rms} > {ref['tol_rms']}")
    _, results, rec = warm_paged(torch, tag, cfg, params, backend, trace,
                                 leg, tokens, smi)
    ttft = {r.rid: r.ttft_s for r in results}
    short = [ttft[r.rid] for r in trace if r.prompt_len < 1000]
    longs = [ttft[r.rid] for r in trace if r.prompt_len >= 1000]
    d = dense["engine_long"]
    print(f"[engine:{tag}] TTFT of the short requests (prompts "
          f"{sorted(r.prompt_len for r in trace if r.prompt_len < 1000)}) "
          f"{' '.join(f'{t * 1e3:.3f}' for t in short)} ms, of the long "
          f"ones {' '.join(f'{t * 1e3:.3f}' for t in longs)} ms; "
          f"engine_long (dense, this run) {d['ttft_p50_s'] * 1e3:.3f} ms "
          f"for all four ({time.perf_counter() - t_leg:.1f} s)")
    if not max(short) < min(longs):
        raise AssertionError(f"{tag}: a short request's first token came "
                             f"no earlier than a long one's")
    rec.update(ttft_short_s=short, ttft_long_s=longs,
               dense_prefill_logits_max_abs_diff=diff,
               dense_prefill_logits_rms_diff=diff_rms,
               dense_tokens_compared=compared, tokens_total=total)
    out[tag] = rec
    del plan, backend
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recording_variant_calls(calls):
    """Context: `transformer.prefill_chunk` and `decode_step` keep every
    call in ``calls`` as ``(kind, logits, inputs, variant)``: kind "chunk"
    (inputs: tokens, fill positions and valid counts on the host; logits
    (B, V), or (B, C, V) for a speculative verify chunk) or "decode"
    (inputs: the active mask on the host), and the variant the call
    selected (None: the bank's default, or a surrounding selection)."""
    import contextlib
    from repro_torch.models import _backend
    from repro_torch.models import transformer as T

    @contextlib.contextmanager
    def ctx():
        orig = {name: getattr(T, name) for name in ("prefill_chunk",
                                                    "decode_step")}

        def wrap(kind, fn):
            def recording(*args, **kw):
                logits, caches = fn(*args, **kw)
                if kind == "chunk":
                    inputs = tuple(args[i].cpu() for i in (2, 4, 5))
                else:
                    inputs = kw["active"].cpu()
                variant = kw.get("variant") or \
                    _backend.current_plan_variant()
                calls.append((kind, logits.float(), inputs, variant))
                return logits, caches
            return recording
        T.prefill_chunk = wrap("chunk", orig["prefill_chunk"])
        T.decode_step = wrap("decode", orig["decode_step"])
        try:
            yield
        finally:
            for name, fn in orig.items():
                setattr(T, name, fn)
    return ctx()


def request_logits(torch, results, calls, check=True, injected=()):
    """Each request's logits for every token it committed, in a recorded
    run (`planset_run`): the "slots" markers give the request in each slot
    at each chunk step (with its effective prompt's length: a resume
    prefills prompt + committed tokens) and decode step; a chunk row that
    completes its prompt gives the logits of the token after it, and a
    decode call's rows of its active slots (one call per variant group)
    the next; a row that is not finite committed nothing (a contained
    fault) and is skipped, as is a row whose logits the engine made NaN
    after the model (``injected``: (step, slot) pairs).  A speculative run's draft steps carry no
    marker and are skipped: only its first tokens' logits are read there
    (``check=False``).  With ``check``, every token is checked to be the
    argmax of its logits.  Returns {rid: [logits per token]}."""
    seqs = {r.rid: [] for r in results}
    owners = {"chunk": {}, "decode": {}}
    at = None
    for kind, lg, inputs, _ in calls:
        if kind == "slots":
            step, slots, at = lg
            owners = {"chunk": {}, "decode": {}, step: slots}
            continue
        rows = []
        if kind == "chunk" and lg.dim() == 2:
            _, index, valid = inputs
            rows = [(b, rid) for b, (rid, plen) in owners["chunk"].items()
                    if int(valid[b]) and int(index[b] + valid[b]) == plen]
        elif kind == "decode":
            rows = [(b, rid) for b, rid in owners["decode"].items()
                    if bool(inputs[b]) and (at, b) not in injected]
        for b, rid in rows:
            if bool(torch.isfinite(lg[b]).all()):
                seqs[rid].append(lg[b])
    for r in results if check else ():
        got = [int(torch.argmax(lg)) for lg in seqs[r.rid]]
        if got != list(getattr(r, "tokens", got)):
            raise AssertionError(f"request {r.rid}: recorded logits give "
                                 f"{got}, the run {r.tokens}")
    return seqs


def matched_distance(torch, tokens, ref_tokens, seq, ref_seq):
    """The largest max |diff| between two runs' logits of one request over
    the steps before their tokens first differ (each step's logits come
    from the same history in both runs)."""
    dist = 0.0
    for t, (a, b) in enumerate(zip(seq, ref_seq)):
        dist = max(dist, float((a - b).abs().max()))
        if t >= len(tokens) or t >= len(ref_tokens) or \
                tokens[t] != ref_tokens[t]:
            break
    return dist


def follow_rule(torch, what, results, ref, dists):
    """The margin rule against a reference run ``ref`` ({"tokens": {rid:
    tokens}, "margins": {rid: top-2 margins}}): each request's tokens must
    equal the reference's up to its first step whose reference top-2
    margin is below SENSITIVITY_FACTOR times the request's measured
    distance ``dists[rid]`` between the two computations (0 where they
    are bit-identical: then every token must agree); fails when fewer than
    half of all tokens were compared.  Returns (compared, total)."""
    rids = [r.rid for r in results]
    compared, total = compare_requests(
        what, [r.tokens for r in results],
        [ref["tokens"][rid] for rid in rids],
        [ref["margins"][rid] for rid in rids],
        [SENSITIVITY_FACTOR * dists[rid] for rid in rids])
    print(f"[planset:{what}] logits max |diff| per request "
          f"{' '.join(f'{dists[rid]:.4g}' for rid in rids)}; tolerance "
          f"{SENSITIVITY_FACTOR:g} x each; tokens identical over {compared} "
          f"of {total} (request, step) pairs before each request's first "
          f"reference top-2 margin below its tolerance (identical "
          f"everywhere: {all(r.tokens == ref['tokens'][r.rid] for r in results)})")
    if 2 * compared < total:
        raise AssertionError(f"{what}: only {compared} of {total} tokens "
                             f"compared, too few for the check to say "
                             f"anything")
    return compared, total


def spec_step_rule(torch, what, trace, results, seqs, calls, rounds, ref,
                   k, spread):
    """A speculative run's tokens and logits against its target-only
    reference ``ref`` (as `follow_rule` takes it, with ``"seqs"``: {rid:
    logits per token}), step by step.  The logits of each committed token
    (the first from its prompt's chunk call, each later one from the
    verify row of the round that committed it, whose history is the
    committed tokens) lie at max |diff| d_t from the reference's at the
    same step.  The first token's logits come from the prompt's chunk
    calls, the same path in both runs, so d_0 must be 0.  Over the steps
    where the two histories agree, every d_t must stay within
    SENSITIVITY_FACTOR x ``spread``, the distance by
    which a plain run of the same trace with the SSM summed in float64
    (`plain_float64_ssm`) moves the reference's logits: the verify chunk's
    SSD over k + 1 steps and the reference's per-step recurrence are two
    valid summations of one function, so their distance is of that size.
    A replay or restore that leaves a slot's recurrent state wrong moves
    the next step's logits by about another request's distance, far
    beyond it.  Tokens: where the reference's top-2 margin exceeds 2 d_t
    the argmax cannot move, so the committed token must be the
    reference's; each request is compared up to its first token that
    differs.  Fails when a distance passes its bound or when fewer than
    half of all tokens were compared.  Returns (compared, total,
    largest d_t)."""
    plens = {r.rid: r.prompt_len for r in trace}
    spec = {r.rid: {0: seqs[r.rid][0]} for r in results}
    verifies = [c for c in calls if c[0] == "chunk" and c[1].dim() == 3]
    for (_, lg, (tokens, _, _), _), slots in zip(verifies, rounds):
        for b, (rid, length) in slots.items():
            got = next(r.tokens for r in results if r.rid == rid)
            n_gen = length - plens[rid] + 1
            for j in range(k + 1):
                t = n_gen + j
                if t >= len(got) or (j and int(tokens[b, j]) != got[t - 1]):
                    break
                spec[rid][t] = lg[b, j]
    tol = SENSITIVITY_FACTOR * spread
    compared = held = total = 0
    worst = 0.0
    for r in results:
        want = ref["tokens"][r.rid]
        total += len(want)
        for t in range(len(want)):
            d = float((spec[r.rid][t] - ref["seqs"][r.rid][t]).abs().max())
            if t == 0 and d:
                raise AssertionError(
                    f"{what}: request {r.rid}: the prompt's chunk logits "
                    f"differ from the reference's by {d:.4g}")
            if d > tol:
                raise AssertionError(
                    f"{what}: request {r.rid} token {t}: logits {d:.4g} "
                    f"from the reference's, beyond {SENSITIVITY_FACTOR:g} x "
                    f"the float64-SSM run's {spread:.4g}")
            worst = max(worst, d)
            held += 1
            same = t < len(r.tokens) and r.tokens[t] == want[t]
            if ref["margins"][r.rid][t] > 2 * d:
                if not same:
                    raise AssertionError(
                        f"{what}: request {r.rid} token {t} differs at "
                        f"margin {ref['margins'][r.rid][t]:.4g} > 2 x "
                        f"{d:.4g}")
                compared += 1
            if not same:
                break
    print(f"[planset:{what}] step by step: logits within {tol:.4g} = "
          f"{SENSITIVITY_FACTOR:g} x the float64-SSM run's distance "
          f"{spread:.4g} at all {held} (request, step) pairs before each "
          f"request's first differing token (largest {worst:.4g}; 0 at the "
          f"prompts' chunk calls, the same path in both runs); "
          f"tokens identical at {compared} of {total} pairs whose reference "
          f"top-2 margin exceeds twice that step's distance (identical "
          f"everywhere: "
          f"{all(r.tokens == ref['tokens'][r.rid] for r in results)})")
    if 2 * compared < total:
        raise AssertionError(f"{what}: only {compared} of {total} tokens "
                             f"compared, too few for the check to say "
                             f"anything")
    return compared, total, worst


def planset_run(torch, tag, cfg, params, bank, hists, trace, smi, *,
                record=True, variant=None, leg=PLANSET, on_engine=None,
                **kw):
    """One run of ``trace`` on a new paged engine of ``leg``'s sizes over
    ``bank`` (engine arguments ``kw``; ``variant`` selects a variant around
    the whole run; ``on_engine(engine)`` is called before the run) with the
    launch counts reset just before and read just after: each recorded
    forward launches its variant's histogram (``hists``), and a run that is
    not recorded is held to the totals of the calls it made.  Returns
    (engine, results, {rid: logits per token} or None, launches,
    record)."""
    import contextlib
    import numpy as np
    from repro_torch.models import _backend
    from repro_torch.serving import Engine
    engine = Engine(cfg, params, max_batch=leg["max_batch"],
                    max_len=leg["max_len"], page_size=leg["page_size"],
                    prefill_chunk=leg["prefill_chunk"], backend=bank, **kw)
    calls = []
    rounds = []
    if record:
        # "slots" markers: the request in each busy slot before each chunk
        # step (with its effective prompt's length) and decode step, and
        # the engine step
        def marking(method, step, owners):
            def run(batch, at, *a):
                calls.append(("slots", (step, owners(batch), at), None,
                              None))
                return method(batch, at, *a)
            return run
        engine._chunk_step = marking(engine._chunk_step, "chunk",
                                     lambda batch: {
            int(b): (batch.pending[b].request.rid,
                     len(batch.pending[b].prompt))
            for b in np.nonzero(batch.prefilling)[0]})
        engine._decode_paged = marking(engine._decode_paged, "decode",
                                       lambda batch: {
            int(b): batch.slots[b].request.rid
            for b in np.nonzero(batch.active)[0]})
    if "speculate" in kw:
        # each round's active slots -> (request, length): its verify
        # chunk's rows
        orig = engine._spec_round

        def spec_round(batch, step, results):
            rounds.append({int(b): (batch.slots[b].request.rid,
                                    int(batch.lengths[b]))
                           for b in np.nonzero(batch.active)[0]})
            return orig(batch, step, results)
        engine._spec_round = spec_round
    if on_engine is not None:
        on_engine(engine)
    reset_launches()
    with (recording_variant_calls(calls) if record
          else contextlib.nullcontext()), _backend.plan_variant(variant):
        results = engine.run(trace)
    torch.cuda.synchronize()
    launches = kernel_launches()
    check_no_weight_copies(tag)
    st = engine.stats
    if record:
        want = dict.fromkeys(KERNELS, 0)
        forwards = [c for c in calls if c[0] != "slots"]
        for kind, _, _, var in forwards:
            for kernel, n in hists[var or bank.default].items():
                want[kernel] += n
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches}, expected "
                                 f"{want} from its {len(forwards)} recorded "
                                 f"forwards")
    rec = print_engine_run(f"planset:{tag}", engine, results, smi)
    rec["launches"] = {k: v for k, v in launches.items() if v}
    injected = {(at, b) for at, b, kind in
                getattr(kw.get("injector"), "fired", ())
                if kind == "nonfinite_logits"}
    seqs = (request_logits(torch, results, calls,
                           check="speculate" not in kw, injected=injected)
            if record else None)
    engine.recorded = (calls, rounds)
    return engine, results, seqs, launches, rec


def cut_depth(cfg, params, art, repeats):
    """``cfg`` and ``params`` at the first ``repeats`` repeats of the block
    pattern (an attention-only model's first ``repeats`` layers; the
    stacked leaves' first repeats, as views: no copy; zamba2's remainder
    and shared blocks kept), and ``art`` (a `MappingArtifact`) filtered to
    those layers' names (``units/...@r`` with r < ``repeats``; the head and
    the other unstacked layers kept)."""
    from repro_torch.models import transformer as T

    def kept(name):
        return "@" not in name or int(name.rsplit("@", 1)[1]) < repeats
    params = dict(params, units=T._tree_map(lambda t: t[:repeats],
                                            params["units"]))
    art = dataclasses.replace(art, layers=[lay for lay in art.layers
                                           if kept(lay["name"])])
    n_layers = repeats * len(cfg.pattern) + T._zamba_remainder(cfg)
    return dataclasses.replace(cfg, n_layers=n_layers), params, art


def phase_planset(torch, cfg, params, seed, smi):
    """The precision bank and the engine features on it (module docstring,
    phase 9): legs bank, target-only, draft-only, spec, slo, degrade and
    faults, on the first `PLANSET_LAYERS` layers of ``params``.  Returns
    {leg: record}."""
    from repro_torch.api import MappingArtifact
    from repro_torch.launch.serve import (build_planset, check_coverage,
                                          print_planset_report)
    from repro_torch.serving import (FaultInjector, ShedResult,
                                     poisson_arrivals, summarize,
                                     synthetic_trace)
    leg = PLANSET
    out = {}
    layers = min(PLANSET_LAYERS, cfg.n_layers)
    arts = {}
    full = cfg.n_layers
    for v, path in PLANSET_VARIANTS.items():
        art = MappingArtifact.load(str(ROOT / "build" / "chip_smoke" /
                                       f"{cfg.name}_{path}.json"))
        pcfg, pparams, arts[v] = cut_depth(cfg, params, art, layers)
    cfg, params = pcfg, pparams
    print(f"[planset] {cfg.name} at full width, its first {layers} of "
          f"{full} layers (views of the stacked repeats; the artifacts "
          f"filtered to their {len(arts['target'].layers)} layers); kv "
          f"cache {cfg.kv_cache_dtype} (the config's default: corrupt_page "
          f"faults write NaN into float KV); {smi}")

    # bank: one PlanSet over the params, the pinned layers shared
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    plans, bank = build_planset(params, arts, "target")
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print_planset_report("planset:bank", plans, bank)
    check_coverage("planset:bank", bank, require_full=True)
    hists = {v: plans[v].kernel_histogram() for v in plans}
    if hists != PLANSET_HISTS:
        raise AssertionError(f"bank histograms {hists}, expected "
                             f"{PLANSET_HISTS}")
    rep = bank.memory_report()
    shared = rep["shared_layers"]
    shared_n = sum(len(bank.variant("target").by_name[name])
                   if isinstance(bank.variant("target").by_name[name], list)
                   else 1 for name in shared)
    print(f"[planset:bank] variants {list(bank.variant_names)} (default "
          f"{bank.default!r}): {bank.coverage()}; bind {bind_s:.1f} s; "
          f"prepared_bytes {rep['prepared_bytes']} (target "
          f"{rep['variants']['target']}, draft {rep['variants']['draft']}), "
          f"sum_variant_bytes {rep['sum_variant_bytes']}, "
          f"dedup_saved_bytes {rep['dedup_saved_bytes']}; "
          f"{len(shared)} shared entries {sorted(shared)} holding "
          f"{shared_n} layers; bank device bytes "
          f"{torch.cuda.memory_allocated() - base}, peak memory "
          f"{peak:.2f} GiB ({smi})")
    if not bank.fully_covered or rep["dedup_saved_bytes"] <= 0:
        raise AssertionError(f"bank: covered {bank.fully_covered}, "
                             f"dedup_saved_bytes {rep['dedup_saved_bytes']}")
    out["bank"] = {k: rep[k] for k in ("variants", "prepared_bytes",
                                       "sum_variant_bytes",
                                       "dedup_saved_bytes")}
    out["bank"].update(shared_entries=len(shared), shared_layers=shared_n,
                       bind_s=bind_s, peak_gib=peak, layers=layers,
                       layers_in_config=full)

    trace = poisson_arrivals(synthetic_trace(
        leg["requests"], vocab=cfg.vocab, min_prompt=leg["min_prompt"],
        max_prompt=leg["max_prompt"], min_new=leg["min_new"],
        max_new=leg["max_new"], seed=seed), leg["rate"], seed=seed)
    print(f"[planset] trace: {len(trace)} requests, prompts "
          f"{[r.prompt_len for r in trace]}, new "
          f"{[r.max_new_tokens for r in trace]}, arrival steps "
          f"{[r.arrival_step for r in trace]}; max_batch "
          f"{leg['max_batch']}, max_len {leg['max_len']}, page_size "
          f"{leg['page_size']}, prefill_chunk {leg['prefill_chunk']}")

    def profiled():
        def run():
            _, _, _, _, r = planset_run(torch, "profiled", cfg, params,
                                        bank, hists, trace, smi,
                                        record=False)
            return r["wall_s"] * 1e3
        return run

    def reference(results, seqs):
        return {"tokens": {r.rid: r.tokens for r in results},
                "margins": {rid: [float(top2_margin(torch, lg))
                                  for lg in seq]
                            for rid, seq in seqs.items()},
                "seqs": seqs, "calls": [c for c in eng.recorded[0]
                                        if c[0] == "slots"]}

    # target-only and draft-only: the references of every leg below
    refs = {}
    for name, variant in (("target_only", None), ("draft_only", "draft")):
        t_leg = time.perf_counter()
        eng, res, seqs, _, rec = planset_run(
            torch, name, cfg, params, bank, hists, trace, smi,
            variant=variant)
        refs[name] = reference(res, seqs)
        if name == "target_only":
            for r in res:
                if r.finish_reason not in ("max_new_tokens", "eos"):
                    raise AssertionError(f"{name}: {r.rid} finished "
                                         f"{r.finish_reason}")
            busy = profile_device(torch, f"planset:{name}", profiled())
            rec.update(device_busy_ms=busy,
                       idle_share=1.0 - busy / (rec["wall_s"] * 1e3))
            print(f"[profile:planset:{name}] device busy {busy:.3f} ms of "
                  f"the recorded run's {rec['wall_s'] * 1e3:.3f} ms wall: "
                  f"idle share {rec['idle_share']:.3f}")
        out[name] = rec
        print(f"[planset:{name}] ({time.perf_counter() - t_leg:.1f} s)")

    # spec: draft k with the draft, verify with the target
    t_leg = time.perf_counter()
    k = leg["draft_k"]
    spec_kw = dict(speculate=("draft", "target"), draft_k=k)
    eng, res, seqs, launches, rec = planset_run(torch, "spec", cfg, params,
                                                bank, hists, trace, smi,
                                                **spec_kw)
    st = dict(eng.stats)
    calls, rounds = eng.recorded
    chunks = [c for c in calls if c[0] == "chunk" and c[1].dim() == 2]
    pinned, wkv = hists["target"]["quant_matmul"], \
        hists["target"]["split_ternary"]
    per_round = {"quant_matmul": pinned * (k + 1),
                 "ternary_matmul": hists["draft"]["ternary_matmul"] * k,
                 "split_ternary": wkv}
    got = {kernel: launches[kernel] - len(chunks) * hists["target"].get(
        kernel, 0) for kernel in per_round}
    want = {kernel: n * st["spec_rounds"] for kernel, n in per_round.items()}
    if got != want or len(chunks) != st["prefill_calls"] or \
            len(rounds) != st["spec_rounds"]:
        raise AssertionError(f"spec: launches beyond the chunk calls {got}, "
                             f"expected {want} ({st['spec_rounds']} rounds, "
                             f"{st['prefill_calls']} chunk calls)")
    committed = sum(r.n_tokens - 1 for r in res)
    if st["spec_committed"] != committed:
        raise AssertionError(f"spec: spec_committed {st['spec_committed']}, "
                             f"tokens committed {committed}")
    # each verify chunk's target logits against the target-only run's at
    # the same position, where the history agrees
    ref = refs["target_only"]
    spec_tok = {r.rid: r.tokens for r in res}
    verifies = [c for c in calls if c[0] == "chunk" and c[1].dim() == 3]
    dists = {r.rid: 0.0 for r in res}
    for r in res:
        dists[r.rid] = float((seqs[r.rid][0] - ref["seqs"][r.rid][0])
                             .abs().max())
    plens = {r.rid: r.prompt_len for r in trace}
    for (_, lg, (tokens, _, _), _), slots in zip(verifies, rounds):
        for b, (rid, length) in slots.items():
            # row b holds [t0, d1..dk] at positions length..length + k;
            # logits j predict generated token n_gen + j, from the target
            # run's history while the drafts d1..dj are its tokens
            n_gen = length - plens[rid] + 1
            want_tok, got_tok = ref["tokens"][rid], spec_tok[rid]
            if got_tok[:n_gen] != want_tok[:n_gen]:
                continue
            for j in range(k + 1):
                t = n_gen + j
                if t >= len(want_tok) or (
                        j and int(tokens[b, j]) != want_tok[t - 1]):
                    break
                dists[rid] = max(dists[rid], float(
                    (lg[b, j] - ref["seqs"][rid][t]).abs().max()))
    compared, total = follow_rule(torch, "spec vs target_only", res, ref,
                                  dists)
    # no profiled run of this leg (the script's time limit: ~70 s on a
    # slow host, the events of ~1.2 M launches included); its idle share
    # is not measured
    rec.update(spec_rounds=st["spec_rounds"],
               spec_drafted=st["spec_drafted"],
               spec_accepted=st["spec_accepted"],
               spec_committed=st["spec_committed"],
               spec_acceptance=st["spec_acceptance"],
               spec_tokens_per_round=st["spec_tokens_per_round"],
               launches_per_round=per_round,
               tokens_compared=compared, tokens_total=total,
               max_logit_distance=max(dists.values()))
    t_only = out["target_only"]
    print(f"[planset:spec] launches per round " + " ".join(
        f"{kk} {v}" for kk, v in per_round.items()) +
        f" (= {pinned} (k+1) + {wkv} k + {wkv}, k {k}) over "
        f"{st['spec_rounds']} rounds + {st['prefill_calls']} chunk calls; "
        f"spec_acceptance {st['spec_acceptance']}, tokens per round "
        f"{st['spec_tokens_per_round']}, spec_committed "
        f"{st['spec_committed']}; spec vs target-only (recorded runs): TTFT "
        f"p50 {rec['ttft_p50_s'] * 1e3:.3f} / "
        f"{t_only['ttft_p50_s'] * 1e3:.3f} ms, p95 "
        f"{rec['ttft_p95_s'] * 1e3:.3f} / {t_only['ttft_p95_s'] * 1e3:.3f} "
        f"ms, decode tok/s {rec['decode_tok_s']:.3f} / "
        f"{t_only['decode_tok_s']:.3f} ({time.perf_counter() - t_leg:.1f} "
        f"s; {smi})")
    out["spec"] = rec

    # slo: interactive -> draft, batch -> target, alternating by request
    t_leg = time.perf_counter()
    routes = {"interactive": "draft", "batch": "target"}
    for i, r in enumerate(trace):
        r.slo = ("interactive", "batch")[i % 2]
    try:
        eng, res, seqs, _, rec = planset_run(torch, "slo", cfg, params,
                                             bank, hists, trace, smi,
                                             slo_routes=routes)
    finally:
        for r in trace:
            r.slo = None
    of = {r.rid: ("draft_only" if routes[("interactive", "batch")[i % 2]]
                  == "draft" else "target_only")
          for i, r in enumerate(trace)}
    for name in ("target_only", "draft_only"):
        group = [r for r in res if of[r.rid] == name]
        ref = refs[name]
        dists = {r.rid: matched_distance(torch, r.tokens,
                                         ref["tokens"][r.rid], seqs[r.rid],
                                         ref["seqs"][r.rid])
                 for r in group}
        follow_rule(torch, f"slo vs {name}", group, ref, dists)
    by_slo = summarize(res, eng.stats["wall_s"]).get("by_slo", {})
    if set(by_slo) != set(routes):
        raise AssertionError(f"slo: by_slo has {sorted(by_slo)}")
    rec["by_slo"] = by_slo
    print(f"[planset:slo] by_slo " + "; ".join(
        f"{cls} -> {routes[cls]}: {v['requests']} requests, TTFT p50 "
        f"{v['ttft_p50_s'] * 1e3:.3f} ms" for cls, v in sorted(
            by_slo.items())) + f" ({time.perf_counter() - t_leg:.1f} s)")
    out["slo"] = rec

    # degrade: a TTFT target a tenth of the target-only p50
    t_leg = time.perf_counter()
    target_s = out["target_only"]["ttft_p50_s"] / 10
    eng, res, seqs, _, rec = planset_run(
        torch, "degrade", cfg, params, bank, hists, trace, smi,
        degrade_to="draft", ttft_target_s=target_s)
    st = eng.stats
    if st["degrade_transitions"] < 1:
        raise AssertionError("degrade: no transition")
    for flag, name in ((True, "draft_only"), (False, "target_only")):
        group = [r for r in res if r.degraded == flag]
        if any(r.variant != ("draft" if flag else None) for r in group):
            raise AssertionError(f"degrade: variants "
                                 f"{[r.variant for r in group]}")
        ref = refs[name]
        dists = {r.rid: matched_distance(torch, r.tokens,
                                         ref["tokens"][r.rid], seqs[r.rid],
                                         ref["seqs"][r.rid])
                 for r in group}
        if group:
            follow_rule(torch, f"degrade vs {name}", group, ref, dists)
    degraded = sum(r.degraded for r in res)
    rec.update(degrade_transitions=st["degrade_transitions"],
               degraded=degraded, ttft_target_s=target_s,
               degrade_log=list(eng.degrade_log))
    print(f"[planset:degrade] ttft_target_s {target_s:.6f} (a tenth of "
          f"the target-only p50); degrade_transitions "
          f"{st['degrade_transitions']} {eng.degrade_log}; {degraded} of "
          f"{len(res)} requests degraded ({time.perf_counter() - t_leg:.1f} "
          f"s)")
    if not degraded:
        raise AssertionError("degrade: no request was served degraded")
    out["degrade"] = rec

    # faults: each event on a slot decoding at that step in the
    # target-only run's schedule
    t_leg = time.perf_counter()
    spec_str = fault_spec(refs["target_only"]["calls"])
    inj = FaultInjector.parse(spec_str, seed)
    print(f"[planset:faults] fault spec {spec_str!r}, heartbeat_steps "
          f"{leg['heartbeat_steps']}")
    eng, res, seqs, _, rec = planset_run(
        torch, "faults", cfg, params, bank, hists, trace, smi,
        injector=inj, heartbeat_steps=leg["heartbeat_steps"])
    st = eng.stats
    if st["faults_detected"] < 2 or st["heartbeat_trips"] < 1:
        raise AssertionError(f"faults: faults_detected "
                             f"{st['faults_detected']}, heartbeat_trips "
                             f"{st['heartbeat_trips']}, fired {inj.fired}")
    done = [r for r in res if not isinstance(r, ShedResult)]
    shed = [r for r in res if isinstance(r, ShedResult)]
    if any(r.reason != "fault" for r in shed):
        raise AssertionError(f"faults: shed {[r.reason for r in shed]}")
    # a resumed request re-prefills its committed tokens through a chunk:
    # its distance includes that chunk row against the decode step
    ref = refs["target_only"]
    compared, total = follow_rule(
        torch, "faults vs target_only", done, ref,
        {r.rid: matched_distance(torch, r.tokens, ref["tokens"][r.rid],
                                 seqs[r.rid], ref["seqs"][r.rid])
         for r in done})
    rec.update({key: st[key] for key in (
        "faults_injected", "faults_detected", "heartbeat_trips",
        "straggler_events", "resumes", "shed_requests")},
        fired=inj.fired, spec=spec_str, requeued=sum(
            r.requeues for r in done), tokens_compared=compared,
        tokens_total=total)
    print(f"[planset:faults] fired {inj.fired}; faults_injected "
          f"{st['faults_injected']}, faults_detected "
          f"{st['faults_detected']}, heartbeat_trips "
          f"{st['heartbeat_trips']}, straggler_events "
          f"{st['straggler_events']}, resumes {st['resumes']}; "
          f"{len(done)} requests finished ({rec['requeued']} requeued), "
          f"{len(shed)} shed (fault) ({time.perf_counter() - t_leg:.1f} s; "
          f"{smi})")
    out["faults"] = rec
    del bank, plans
    gc.collect()
    torch.cuda.empty_cache()
    return out


def forward_launches(hist, calls, steps, decode_hist=None):
    """Launches of ``calls`` prefill or chunk forwards at ``hist`` and
    ``steps`` decode steps at ``decode_hist`` (``hist`` unless given:
    deepseek's absorbed decode runs no kv_b)."""
    want = dict.fromkeys(KERNELS, 0)
    for h, n in ((hist, calls), (decode_hist or hist, steps)):
        for kernel, count in h.items():
            want[kernel] += count * n
    return want


def counting_drops(counts):
    """Context: every MoE dispatch (`moe.dispatch`) adds the (token, k)
    pairs of valid tokens that capacity dropped to ``counts["dropped"]``
    and all valid pairs to ``counts["pairs"]`` (device tensors, read once
    after the run); the dispatch is unchanged."""
    import contextlib
    from repro_torch.models import moe as M

    @contextlib.contextmanager
    def ctx():
        orig = M.dispatch

        def counting(probs, cfg, length_mask=None):
            out = orig(probs, cfg, length_mask)
            onehot, keep = out[2], out[4]
            valid = onehot.sum(-1) > 0
            counts["dropped"] = counts.get("dropped", 0) + \
                (valid & ~keep).sum()
            counts["pairs"] = counts.get("pairs", 0) + valid.sum()
            return out
        M.dispatch = counting
        try:
            yield
        finally:
            M.dispatch = orig
    return ctx()


def zamba_launches(tag, launches, want, forwards):
    """Launches of a run against ``want``; 0 weight copies."""
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want} "
                             f"({forwards} forwards)")
    check_no_weight_copies(tag)
    return " ".join(f"{k} {v}" for k, v in launches.items() if v)


def spec_replay_legs(torch, tag, cfg, params, bank, hists, leg, seed, smi,
                     at):
    """A recurrent arch's bank legs (phases 10 and 14): ``leg``'s trace
    target-only, the same with the SSM / mLSTM summed in float64 (its
    logit distance is the spread), then ``speculate=("draft", "target")``
    against target-only by `spec_step_rule`, with each replay chunk
    counted by wrapping ``Engine._replay``.  The verify chunk sums the
    recurrences over k + 1 steps where target-only steps them one at a
    time: in bf16 their logits part, so the rule holds each step within
    the float64 run's distance.  Returns (target-only record, spec
    record) with the replay counts (slot replays; those after a partial
    accept, at least one draft accepted and one rejected)."""
    from repro_torch.serving import poisson_arrivals, synthetic_trace
    trace = poisson_arrivals(synthetic_trace(
        leg["requests"], vocab=cfg.vocab, min_prompt=leg["min_prompt"],
        max_prompt=leg["max_prompt"], min_new=leg["min_new"],
        max_new=leg["max_new"], seed=seed), leg["rate"], seed=seed)
    print_traffic(f"{tag}:bank", trace, leg)
    _, res, seqs, _, trec = planset_run(
        torch, f"{tag}:target_only", cfg, params, bank, hists, trace, smi,
        leg=leg)
    ref = {"tokens": {r.rid: r.tokens for r in res},
           "margins": {rid: [float(top2_margin(torch, lg)) for lg in seq]
                       for rid, seq in seqs.items()},
           "seqs": seqs}
    with plain_float64_ssm():
        _, res64, seqs64, _, _ = planset_run(
            torch, f"{tag}:target_only:float64_ssm", cfg, params, bank,
            hists, trace, smi, leg=leg)
    spread = max(matched_distance(torch, r.tokens, ref["tokens"][r.rid],
                                  seqs64[r.rid], seqs[r.rid])
                 for r in res64)
    same64 = sum(r.tokens == ref["tokens"][r.rid] for r in res64)
    print(f"[{tag}:target_only] float64-SSM run: logits max |diff| "
          f"{spread:.4g} from the target-only run's over the steps where "
          f"their histories agree; {same64} of {len(res64)} requests' "
          f"tokens identical ({at()})")
    del seqs64
    replays = []

    def count_replays(engine):
        replay = engine._replay

        def counting(x, drafted, caches, snap, valid):
            replays.append(valid.copy())
            return replay(x, drafted, caches, snap, valid)
        engine._replay = counting
    k = leg["draft_k"]
    eng, res, seqs, launches, srec = planset_run(
        torch, f"{tag}:spec", cfg, params, bank, hists, trace, smi, leg=leg,
        on_engine=count_replays, speculate=("draft", "target"), draft_k=k)
    st = dict(eng.stats)
    calls, rounds = eng.recorded
    compared, total, dist = spec_step_rule(
        torch, f"{tag}:spec vs target_only", trace, res, seqs, calls,
        rounds, ref, k, spread)
    del calls, eng
    slots = sum(int((v > 0).sum()) for v in replays)
    partial = sum(int((v > 1).sum()) for v in replays)
    print(f"[{tag}:spec] k {k}: {st['spec_rounds']} rounds, acceptance "
          f"{st['spec_acceptance']}, {st['spec_tokens_per_round']} tokens per"
          f" round, launches "
          f"{' '.join(f'{kk} {v}' for kk, v in launches.items() if v)}; "
          f"{len(replays)} replay chunks ({slots} slot replays, {partial} "
          f"after a partial accept: at least one draft accepted, then one "
          f"rejected) of the restored recurrent state; decode "
          f"{srec['decode_tok_s']:.3f} tok/s against target-only's "
          f"{trec['decode_tok_s']:.3f} ({at()})")
    return trec, dict(srec, spec_rounds=st["spec_rounds"],
                      spec_acceptance=st["spec_acceptance"],
                      spec_tokens_per_round=st["spec_tokens_per_round"],
                      replay_chunks=len(replays), slot_replays=slots,
                      partial_accept_replays=partial,
                      tokens_compared=compared, tokens_total=total,
                      max_logit_distance=dist,
                      float64_ssm_max_abs_diff=spread)


def phase_zamba(torch, seed, smi, device="cuda"):
    """zamba2-1.2b at full width (module docstring, phase 10): legs
    fixed, engine_paged_mixed, engine_mixed, long, bank and spec; returns
    {leg: record}.  ``device`` "cpu" serves a rehearsal, with the config
    reduced and the CUDA-only calls stubbed by the caller."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.serve import (build_planset, check_coverage,
                                          kv_cache_for,
                                          plan_mapping_execution,
                                          print_planset_report, serve_batch)
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()

    def at():
        return f"{time.perf_counter() - t_phase:.1f} s into the phase"
    cfg = cfgbase.get(ZAMBA)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(gen, cfg)
    print(f"[zamba] {cfg.name}: {cfg.n_layers} blocks ({cfg.pattern_repeats}"
          f" x {cfg.pattern} + {len(params['rem'])} mamba), d_model "
          f"{cfg.d_model}, mamba2 d_state {cfg.ssm_state} expand 2 head_dim "
          f"64 conv 4, shared block {cfg.n_heads} heads / {cfg.n_kv_heads} "
          f"kv, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"params {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
          f"({smi})")
    arts = {}
    for name, bias in (("diana", None), ("target", ("digital", 1.0)),
                       ("draft", ("aimc", 0.05))):
        arts[name] = emit_static_mapping(
            params, cfg, "diana",
            ROOT / "build" / "chip_smoke" / f"{cfg.name}_{name}.json",
            max_cout=ZAMBA_MAX_COUT, act_log_scale=2.0, bias=bias)
    plan, backend = plan_mapping_execution(params, arts["diana"])
    check_coverage("zamba", backend, require_full=True)
    hist = plan.kernel_histogram()
    for line in plan.histogram_lines():
        print(f"[zamba] {line}")
    if hist != ZAMBA_PLAN_HIST:
        raise AssertionError(f"zamba diana: kernel histogram {hist}")
    for (k, n), raw in ZAMBA_RAW.items():
        name = {(2048, 8384): "units/0/mamba/in_proj@0",
                (4096, 2048): "rem/0/mamba/out_proj",
                (2048, 2048): "shared/attn/wq",
                (2048, 8192): "shared/ffn/gate",
                (8192, 2048): "shared/ffn/down"}[(k, n)]
        lp = plan[name]
        if lp.boundaries[0] != raw:
            raise AssertionError(f"zamba {name}: raw boundary "
                                 f"{lp.boundaries}, expected {raw}")
        print(f"[zamba] {name} ({k} x {n}): counts {lp.counts}, raw "
              f"boundary {lp.boundaries}, aligned {lp.aligned_boundaries}")
    kcfg = kv_cache_for(cfg, arts["diana"])
    print(f"[zamba] diana: {backend.coverage()}; {len(plan.layers)} planned "
          f"layers, {sum(ZAMBA_LONG_HIST.values())} launches per forward "
          f"{ZAMBA_LONG_HIST}; kv {kcfg.kv_cache_dtype} ({at()})")
    # every leg but the long one at the first ZAMBA_REPEATS repeats
    full_cfg, full_params, full_plan, full_backend = cfg, params, plan, \
        backend
    cfg, params, cart = cut_depth(cfg, params, arts["diana"], ZAMBA_REPEATS)
    plan, backend = plan_mapping_execution(params, cart)
    check_coverage("zamba", backend, require_full=True)
    if plan.kernel_histogram() != ZAMBA_PLAN_HISTS["diana"]:
        raise AssertionError(f"zamba diana at {cfg.n_layers} blocks: kernel "
                             f"histogram {plan.kernel_histogram()}")
    long_kcfg, kcfg = kcfg, kv_cache_for(cfg, cart)
    print(f"[zamba] legs fixed, mixed, bank and spec at {cfg.n_layers} of "
          f"{full_cfg.n_layers} blocks ({ZAMBA_REPEATS} repeats + "
          f"{len(params['rem'])} remainder blocks, views), the long leg at "
          f"all {full_cfg.n_layers}: {backend.coverage()}, "
          f"{sum(ZAMBA_HIST.values())} launches per forward {ZAMBA_HIST}")
    out = {}

    # fixed batch: serve_batch, every planned call checked as it is made
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device=dev)
    forwards = -(-PROMPT_LEN // CHUNK) + GEN_LEN - 1
    checked, calls = {}, []
    limits = dict.fromkeys(ZAMBA_HIST, 10**9)
    reset_launches()
    with checking_matmuls(checked, limits), recording_logits(calls):
        tokens, stats = serve_batch(kcfg, params, prompts, GEN_LEN,
                                    backend=backend)
    want = {k: ZAMBA_HIST.get(k, 0) * forwards for k in KERNELS}
    got = zamba_launches("zamba:fixed", kernel_launches(), want, forwards)
    if {k: n for k, (n, _) in checked.items()} != {
            k: v for k, v in want.items() if v}:
        raise AssertionError(f"zamba:fixed: calls checked {checked}")
    first, margins = batch_logits(torch, tokens, calls)
    del calls
    if tuple(tokens.shape) != (REQUESTS, GEN_LEN) or \
            tuple(first.shape) != (REQUESTS, cfg.vocab) or \
            not bool(torch.isfinite(first).all()):
        raise AssertionError("zamba:fixed: output has the wrong shape or is "
                             "not finite")
    print(f"[zamba:fixed] {REQUESTS} x {PROMPT_LEN} + {GEN_LEN} through "
          f"serve_batch (paged engine, {forwards} forwards): launches {got} "
          f"({ZAMBA_HIST} per forward), weights copied per call 0; every "
          f"planned call bit-identical to its plain version on its own "
          f"inputs (" + ", ".join(f"{n} {k}, largest M {m}"
                                  for k, (n, m) in checked.items()) + ")")
    backend.reference = True
    ref_calls = []
    with recording_logits(ref_calls):
        ref_tokens, _ = serve_batch(kcfg, params, prompts, GEN_LEN,
                                    backend=backend)
    backend.reference = False
    if any(kernel_launches()[k] != want[k] for k in KERNELS):
        raise AssertionError("zamba:fixed: the plain run launched a kernel")
    ref_first, ref_margins = batch_logits(torch, ref_tokens, ref_calls)
    del ref_calls
    compared, total, dist = margin_rule(
        torch, "zamba:fixed vs plain", tokens.tolist(), list(first),
        ref_tokens.tolist(), list(ref_first), ref_margins.tolist())
    _, warm = serve_batch(kcfg, params, prompts, GEN_LEN, backend=backend)
    print(f"[zamba:fixed] warm run: prefill {warm['prefill_s'] * 1e3:.3f} "
          f"ms, decode {warm['decode_s'] * 1e3:.3f} ms "
          f"({warm['tok_per_s']:.2f} tok/s, "
          f"{warm['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step); sample "
          f"tokens {tokens[:2, :8].tolist()} ({at()})")
    out["fixed"] = {"forwards": forwards, "launches": want,
                    "calls_checked": {k: n for k, (n, _) in checked.items()},
                    "tokens_identical_to_plain": tokens.equal(ref_tokens),
                    "prefill_logits_max_abs_diff": dist,
                    "tokens_compared": compared, "tokens_total": total,
                    "warm_prefill_ms": warm["prefill_s"] * 1e3,
                    "warm_decode_ms_per_step":
                        warm["decode_s"] * 1e3 / (GEN_LEN - 1),
                    "warm_decode_tok_per_s": warm["tok_per_s"]}
    del prompts

    # the shared block's k and v once per repeat: 4 paged_update calls
    # per forward; the third forward's second
    out.update(mixed_legs(torch, "zamba", kcfg, params, backend, ZAMBA_HIST,
                          seed, smi, ZAMBA_MIXED, prefix_cache=False,
                          capture=2 * 2 * ZAMBA_REPEATS + 1))
    print(f"[zamba] engine legs done ({at()})")
    del plan, backend
    gc.collect()
    torch.cuda.empty_cache()
    # long: one dense admission group padded to 4096 tokens, its shared
    # block's 6 uses through flash at head dim 64, at full depth
    out["long"] = dense_long_leg(torch, "zamba", long_kcfg, full_params,
                                 full_backend, ZAMBA_LONG_HIST, ZAMBA_LONG,
                                 seed, smi, ZAMBA_USES, ZAMBA_LONG_SQ)
    print(f"[zamba] long done ({at()})")
    del full_plan, full_backend
    gc.collect()
    torch.cuda.empty_cache()

    # bank: the JAX CI's pair, speculative against target-only
    plans, bank = build_planset(
        params, {v: cut_depth(full_cfg, full_params, arts[v],
                              ZAMBA_REPEATS)[2] for v in ("target", "draft")},
        "target")
    print_planset_report("zamba:bank", plans, bank)
    check_coverage("zamba:bank", bank, require_full=True)
    plan_hists = {v: plans[v].kernel_histogram() for v in plans}
    if plan_hists != {v: ZAMBA_PLAN_HISTS[v] for v in plans}:
        raise AssertionError(f"zamba bank histograms {plan_hists}")
    bcfg = kv_cache_for(cfg, arts["target"])
    trec, srec = spec_replay_legs(torch, "zamba", bcfg, params, bank,
                                  ZAMBA_BANK_HISTS, ZAMBA_BANK, seed, smi,
                                  at)
    if not srec["replay_chunks"]:
        raise AssertionError("zamba:spec: no round replayed a partial "
                             "accept")
    out["target_only"], out["spec"] = trec, srec
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[zamba] phase {out['seconds']:.1f} s, peak memory "
          f"{out['peak_gib']:.2f} GiB ({smi})")
    del plans, bank, params, full_params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fixed_batch(torch, tag, cfg, params, backend, hist, prompts, limits,
                decode_hist=None, drops=None, frontend=None, keep=None):
    """``serve_batch`` of the fixed traffic (REQUESTS x PROMPT_LEN +
    GEN_LEN, the paged engine: 4 chunk calls and 15 decode steps) with the
    first ``limits[kernel]`` calls of each int8 kernel held bit for bit
    against the plain version as they are made, launches = ``hist`` x the
    chunk calls + ``decode_hist`` (default ``hist``) x the decode steps, 0
    weight copies; then the plain run (``reference=True``): tokens and
    prefill logits identical.  ``drops`` (a dict): the kernel run's MoE
    capacity drops (`counting_drops`).  ``frontend``: each request's
    frontend row (a frontend arch); ``keep`` (a dict) receives the kernel
    run's prefill logits under "first".  Returns the record."""
    import contextlib
    from repro_torch.launch.serve import serve_batch
    chunks = -(-PROMPT_LEN // CHUNK)
    forwards = chunks + GEN_LEN - 1
    checked, calls = {}, []
    reset_launches()
    with checking_matmuls(checked, limits), recording_logits(calls), \
            (counting_drops(drops) if drops is not None
             else contextlib.nullcontext()):
        tokens, stats = serve_batch(cfg, params, prompts, GEN_LEN,
                                    frontend=frontend, backend=backend)
    want = forward_launches(hist, chunks, GEN_LEN - 1, decode_hist)
    got = zamba_launches(tag, kernel_launches(), want, forwards)
    if {k: n for k, (n, _) in checked.items() if n} != {
            k: limits[k] for k in hist}:
        raise AssertionError(f"{tag}: calls checked {checked}")
    first, _ = batch_logits(torch, tokens, calls)
    del calls
    if tuple(tokens.shape) != (REQUESTS, GEN_LEN) or \
            tuple(first.shape) != (REQUESTS, cfg.vocab) or \
            not bool(torch.isfinite(first).all()):
        raise AssertionError(f"{tag}: output has the wrong shape or is not "
                             f"finite")
    backend.reference = True
    ref_calls = []
    with recording_logits(ref_calls):
        ref_tokens, ref_stats = serve_batch(cfg, params, prompts, GEN_LEN,
                                            frontend=frontend,
                                            backend=backend)
    backend.reference = False
    if kernel_launches() != want:
        raise AssertionError(f"{tag}: the plain run launched a kernel")
    ref_first, _ = batch_logits(torch, ref_tokens, ref_calls)
    del ref_calls
    if not (torch.equal(tokens, ref_tokens) and torch.equal(first,
                                                            ref_first)):
        raise AssertionError(f"{tag}: kernel and plain runs disagree (max "
                             f"|diff| of the prefill logits "
                             f"{float((first - ref_first).abs().max())})")
    per = (f"{hist} per forward" if decode_hist is None else
           f"{hist} per chunk call, {decode_hist} per decode step")
    print(f"[{tag}] {REQUESTS} x {PROMPT_LEN} + {GEN_LEN} through "
          f"serve_batch (paged engine, {forwards} forwards): launches {got} "
          f"({per}), weights copied per call 0; the first "
          + " and the first ".join(f"{n} {k} calls (largest M {m})"
                                   for k, (n, m) in checked.items() if n) +
          f" bit-identical to the plain version on their own inputs; "
          f"tokens and prefill logits identical to the plain run's; prefill "
          f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
          f"{stats['decode_s'] * 1e3:.3f} ms "
          f"({stats['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step) with "
          f"the checks inline; plain run prefill "
          f"{ref_stats['prefill_s'] * 1e3:.3f} ms; sample tokens "
          f"{tokens[:2, :8].tolist()}")
    if keep is not None:
        keep["first"] = first
    return {"forwards": forwards, "launches": want,
            "calls_checked": {k: n for k, (n, _) in checked.items()},
            "tokens_identical_to_plain": True,
            "prefill_logits_identical_to_plain": True,
            "checked_prefill_ms": stats["prefill_s"] * 1e3,
            "checked_decode_ms_per_step":
                stats["decode_s"] * 1e3 / (GEN_LEN - 1),
            "plain_prefill_ms": ref_stats["prefill_s"] * 1e3}


def mixed_legs(torch, tag, cfg, params, backend, hist, seed, smi, leg,
               prefix_cache, dense=True, decode_hist=None, frontend=None,
               capture=CAPTURE_CALL):
    """``leg``'s trace (engine_mixed's shape) through the paged engine
    (engine_paged_mixed, whose prefix cache must be on exactly when
    ``prefix_cache``: attention KV is page-resident, recurrent state is
    not) and, when ``dense``, through the dense one (engine_mixed), each
    against its plain run: the integer kernels are bit-exact and neither
    leg reaches flash, so the margin rule compares every paged token and
    the dense runs are identical.  The layouts are compared for the record
    (zamba2's SSD sums in other chunks in the two, so in bf16 their logits
    part).  Then a warm paged run and a profiled one (idle share).  Under
    MoE (``cfg.moe``) the recorded paged run also counts the (token, k)
    pairs capacity dropped (`counting_drops`).  ``decode_hist``: the
    launches per decode step where they are not ``hist``.  ``frontend``
    (a frontend arch): ``frontend(n)`` gives n requests' rows;
    ``capture``: the paged_update call held against the CPU.  Returns
    {leg: record}."""
    import contextlib
    from repro_torch.serving import poisson_arrivals, synthetic_trace
    t0 = time.perf_counter()
    paged = dict(leg, kv_layout="paged")
    trace = poisson_arrivals(synthetic_trace(
        leg["requests"], vocab=cfg.vocab, min_prompt=leg["min_prompt"],
        max_prompt=leg["max_prompt"], min_new=leg["min_new"],
        max_new=leg["max_new"], seed=seed), leg["rate"], seed=seed)
    if frontend is not None:
        for req, row in zip(trace, frontend(len(trace))):
            req.frontend = row
    print_traffic(f"{tag}:engine_paged_mixed", trace, paged)
    drops = {}
    with (counting_drops(drops) if cfg.moe is not None
          else contextlib.nullcontext()):
        engine, _, ptok, pfirst, _, st = paged_run(
            torch, f"{tag}:engine_paged_mixed", cfg, params, backend, hist,
            trace, paged, decode_hist=decode_hist, capture=capture)
    if engine.prefix_cache != prefix_cache:
        raise AssertionError(f"{tag}: the prefix cache is "
                             f"{'on' if engine.prefix_cache else 'off'}")
    print(f"[engine:{tag}:engine_paged_mixed] prefix cache "
          f"{'on' if engine.prefix_cache else 'off'}"
          + ("" if prefix_cache or cfg.moe is None else
             " (as in the JAX package under MoE: dispatch couples a "
             "batch's slots)"))
    if drops:
        drops = {k: int(v) for k, v in drops.items()}
        print(f"[engine:{tag}:engine_paged_mixed] MoE dispatch over the "
              f"recorded run: {drops['dropped']} of {drops['pairs']} valid "
              f"(token, k) pairs dropped by capacity (factor "
              f"{cfg.moe.capacity_factor})")
    backend.reference = True
    calls = []
    _, rres, _ = engine_run(torch, cfg, params, backend, trace, paged,
                            calls)
    rfirst, rmargins = paged_request_logits(torch, trace, rres, calls)
    compared, total, _ = margin_rule(
        torch, f"{tag}:engine_paged_mixed vs plain", ptok, pfirst,
        [r.tokens for r in rres], rfirst, rmargins)
    backend.reference = False
    out = {"engine_paged_mixed": warm_profiled(
        torch, tag, cfg, params, backend, trace, paged, ptok, smi, st, t0)}
    out["engine_paged_mixed"].update(plain_tokens_compared=compared,
                                     tokens_total=total,
                                     prefix_cache=engine.prefix_cache,
                                     **{f"moe_{k}": v
                                        for k, v in drops.items()})
    if dense:
        out["engine_mixed"] = dense_mixed(torch, tag, cfg, params, backend,
                                          hist, trace, leg, ptok, pfirst,
                                          smi, t0)
    return out


def dense_mixed(torch, tag, cfg, params, backend, hist, trace, leg, ptok,
                pfirst, smi, t0):
    """`mixed_legs`' dense leg: ``trace`` through the dense engine, held
    against its plain run (identical) and, for the record, against the
    paged run's tokens ``ptok`` and prefill logits ``pfirst``; returns the
    record."""
    calls = []
    dense, dres, dl = engine_run(torch, cfg, params, backend, trace, leg,
                                 calls)
    dst = dense.stats
    dforwards = dst["prefill_calls"] + dst["decode_steps"]
    zamba_launches(f"{tag}:engine_mixed", dl,
                   {k: hist.get(k, 0) * dforwards for k in KERNELS},
                   dforwards)
    dfirst = engine_first_logits(torch, dres, calls)
    dtok = [r.tokens for r in dres]
    backend.reference = True
    calls = []
    _, rres, _ = engine_run(torch, cfg, params, backend, trace, leg, calls)
    backend.reference = False
    rdfirst = engine_first_logits(torch, rres, calls)
    del calls
    if dtok != [r.tokens for r in rres] or not all(
            torch.equal(a, b) for a, b in zip(dfirst, rdfirst)):
        raise AssertionError(f"{tag}:engine_mixed: kernel and plain-version "
                             f"runs disagree")
    dist = max(float((a - b).abs().max()) for a, b in zip(dfirst, pfirst))
    same = sum(a == b for a, b in zip(dtok, ptok))
    print(f"[{tag}:engine_mixed] dense: {dst['prefill_calls']} prefill "
          f"calls + {dst['decode_steps']} decode steps, launches {hist} per "
          f"forward; tokens and prefill logits identical to the plain run's;"
          f" against the paged layout: {same} of {len(dtok)} requests' "
          f"tokens identical, prefill logits max |diff| {dist:.4g} "
          f"({time.perf_counter() - t0:.1f} s into the legs)")
    return dict(print_engine_run(f"{tag}:engine_mixed", dense, dres, smi),
                forwards=dforwards, vs_paged_max_abs_diff=dist,
                vs_paged_requests_identical=same)


def warm_profiled(torch, tag, cfg, params, backend, trace, paged, ptok, smi,
                  st, t0):
    """`mixed_legs`' warm paged run and its profiled one (idle share);
    returns the warm run's record."""
    _, _, prec = warm_paged(torch, f"{tag}:engine_paged_mixed", cfg, params,
                            backend, trace, paged, ptok, smi)

    def profiled():
        eng, _, _ = engine_run(torch, cfg, params, backend, trace, paged)
        return eng.stats["wall_s"] * 1e3
    busy = profile_device(torch, f"{tag}:engine_paged_mixed", profiled)
    prec.update(device_busy_ms=busy,
                idle_share=1.0 - busy / (prec["wall_s"] * 1e3),
                forwards=st["prefill_calls"] + st["decode_steps"])
    print(f"[profile:{tag}:engine_paged_mixed] device busy {busy:.3f} ms of "
          f"the warm run's {prec['wall_s'] * 1e3:.3f} ms wall: idle share "
          f"{prec['idle_share']:.3f} ({time.perf_counter() - t0:.1f} s into "
          f"the legs)")
    return prec


def dense_long_leg(torch, tag, cfg, params, backend, hist, leg, seed, smi,
                   flash_calls, sq, decode_hist=None, dims=None):
    """``leg``'s requests (``leg["prompts"]``, ``leg["new"]`` new tokens
    each, at step 0) through the dense engine: one admission group whose
    prefill (Sq ``sq`` > 2048) takes the chunked path and launches flash
    ``flash_calls`` times at head dims ``dims`` (query / key, value;
    ``cfg.hd`` both unless given) with ``cfg``'s sliding window, each call
    held against the plain version on its own inputs within the bound;
    the matmul kernels ``hist`` per prefill, ``decode_hist`` (default
    ``hist``) per decode step.  The matmul kernels being bit-exact, the
    kernel run differs from the plain run (``reference=True``) only in
    flash's summation order; a plain run in float64 attention differs from it by
    another valid one: the prefill logits must lie within
    SENSITIVITY_FACTOR times that distance (max and RMS), tokens by the
    margin rule.  With a window, `WINDOW_CONTROLS` are the controls: each
    call's output must lie the control's factor x farther from the plain
    version with the control's window than from the right one's, and the
    prefill logits (where the control has a factor for them) farther from
    a plain run with it than from the plain run.  Then a warm run.
    Returns the record."""
    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.serving import Request
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    trace = [Request(rid=f"l{i}", prompt=rng.integers(0, cfg.vocab, n),
                     max_new_tokens=leg["new"])
             for i, n in enumerate(leg["prompts"])]
    print_traffic(f"{tag}:long", trace, leg)
    recorded, calls = [], []
    with recording_flash(recorded):
        eng, res, launches = engine_run(torch, cfg, params, backend, trace,
                                        leg, calls)
    st = dict(eng.stats)
    forwards = st["prefill_calls"] + st["decode_steps"]
    want = forward_launches(hist, st["prefill_calls"], st["decode_steps"],
                            decode_hist)
    want["flash_attention"] = flash_calls
    got = zamba_launches(f"{tag}:long", launches, want, forwards)
    dims = dims or (cfg.hd, cfg.hd)
    worst = worst_ratio = 0.0
    # per control: the least over the calls of max |out - control| /
    # max |out - plain|
    control = dict.fromkeys(WINDOW_CONTROLS, float("inf"))
    for i, (q, k, v, kw, o) in enumerate(recorded):
        if (q.shape[-1], v.shape[-1]) != dims or q.shape[2] != sq or \
                kw["window"] != cfg.sliding_window:
            raise AssertionError(f"{tag}:long flash call {i}: q "
                                 f"{tuple(q.shape)}, v {tuple(v.shape)}, "
                                 f"window {kw['window']}")
        err, ratio = check_flash(torch, q, k, v, o, kw["causal"],
                                 kw["kv_len"], f"{tag}:long call {i}",
                                 kw["window"])
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        for key, (window, _, _) in (WINDOW_CONTROLS.items() if kw["window"]
                                    else ()):
            far = float((o.double() - flash_attention_plain(
                q, k, v, causal=kw["causal"], kv_len=kw["kv_len"],
                window=window).double()).abs().max())
            control[key] = min(control[key], far / max(err, 1e-30))
    print(f"[{tag}:long] {st['prefill_calls']} prefill + "
          f"{st['decode_steps']} decode steps: launches {got}; the "
          f"{len(recorded)} flash calls (q {tuple(recorded[0][0].shape)}, D "
          f"{dims[0]}, Dv {dims[1]}, kv_len {recorded[0][3]['kv_len']}, "
          f"window "
          f"{recorded[0][3]['window']}) within the bound of the plain "
          f"version on their own inputs: max |err| {worst:.4g}, at most "
          f"{worst_ratio:.4g} of it ({time.perf_counter() - t0:.1f} s into "
          f"the leg)")
    if cfg.sliding_window:
        print(f"[{tag}:long] window controls: each call's output at least "
              + ", ".join(f"{control[key]:.4g} x (window {w}; at least "
                          f"{f} required)" for key, (w, f, _) in
                          WINDOW_CONTROLS.items()) +
              f" farther from the plain version with that window than "
              f"from the right one's")
    del recorded
    first = engine_first_logits(torch, res, calls)
    tokens = [r.tokens for r in res]
    del calls
    backend.reference = True
    ref_calls = []
    _, rres, _ = engine_run(torch, cfg, params, backend, trace, leg,
                            ref_calls)
    ref_first = engine_first_logits(torch, rres, ref_calls)
    decodes = [lg for kind, lg, _ in ref_calls if kind == "decode"]
    ref_tokens = [r.tokens for r in rres]
    ref_margins = [[float(top2_margin(torch, ref_first[i]))] +
                   [float(top2_margin(torch, lg[i]))
                    for lg in decodes[:len(ref_tokens[i]) - 1]]
                   for i in range(len(ref_tokens))]
    del ref_calls, decodes
    f64_calls = []
    with plain_float64_attention():
        _, f64_res, _ = engine_run(torch, cfg, params, backend, trace, leg,
                                   f64_calls)
    backend.reference = False
    if kernel_launches() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"{tag}:long: a plain run launched a kernel")
    f64_first = engine_first_logits(torch, f64_res, f64_calls)
    del f64_calls
    ref_stack = torch.stack(ref_first)
    spread_max, spread_rms = logit_distance(torch, torch.stack(f64_first),
                                            ref_stack)
    diff, diff_rms = logit_distance(torch, torch.stack(first), ref_stack)
    other, other_rms = logit_distance(torch, ref_stack.roll(1, dims=0),
                                      ref_stack)
    # per control: the prefill logits' max |diff| from the plain run's
    others = {}
    for key, (window, _, factor) in (WINDOW_CONTROLS.items()
                                     if cfg.sliding_window else ()):
        if factor is None:
            continue
        backend.reference = True
        ctrl_calls = []
        _, ctrl_res, _ = engine_run(
            torch, dataclasses.replace(cfg, sliding_window=window), params,
            backend, trace, leg, ctrl_calls)
        backend.reference = False
        others[key] = logit_distance(torch, torch.stack(engine_first_logits(
            torch, ctrl_res, ctrl_calls)), ref_stack)[0]
        del ctrl_calls
    tol = SENSITIVITY_FACTOR * spread_max
    tol_rms = SENSITIVITY_FACTOR * spread_rms
    compared, total = compare_requests(f"{tag}:long vs plain", tokens,
                                       ref_tokens, ref_margins,
                                       [tol] * len(tokens))
    print(f"[{tag}:long] plain run in float64 attention: prefill logits max "
          f"|diff| {spread_max:.4g}, RMS {spread_rms:.4g} from the plain "
          f"run; " + (f"another request's: {other:.4g}, RMS {other_rms:.4g}; "
                      if len(trace) > 1 else "") +
          "".join(f"a plain run with window {WINDOW_CONTROLS[key][0]}: "
                  f"{d:.4g} ({d / max(diff, 1e-30):.3g} x the kernel "
                  f"run's); " for key, d in others.items()) +
          f"kernel run vs plain: max {diff:.4g} (ratio "
          f"{diff / max(spread_max, 1e-30):.3g}), RMS {diff_rms:.4g} (ratio "
          f"{diff_rms / max(spread_rms, 1e-30):.3g}); tokens identical over "
          f"{compared} of {total} (request, step) pairs before the first "
          f"plain top-2 margin below {tol:.4g} "
          f"({time.perf_counter() - t0:.1f} s into the leg)")
    if diff > tol or diff_rms > tol_rms:
        raise AssertionError(f"{tag}:long: prefill logits differ from the "
                             f"plain run's by max {diff} > {tol} or RMS "
                             f"{diff_rms} > {tol_rms}")
    if cfg.sliding_window and (
            any(control[key] < f for key, (_, f, _) in
                WINDOW_CONTROLS.items()) or
            any(d < WINDOW_CONTROLS[key][2] * diff
                for key, d in others.items())):
        raise AssertionError(f"{tag}:long: the checks do not tell the "
                             f"window from another: calls {control}, "
                             f"logits {others} against {diff}")
    torch.cuda.reset_peak_memory_stats()
    eng, wres, _ = engine_run(torch, cfg, params, backend, trace, leg)
    if [r.tokens for r in wres] != tokens:
        raise AssertionError(f"{tag}:long: the warm run's tokens differ")
    return dict(print_engine_run(f"{tag}:long", eng, wres, smi),
                flash_calls=flash_calls, flash_worst_error=worst,
                flash_worst_error_over_bound=worst_ratio,
                float64_plain_max_abs_diff=spread_max,
                float64_plain_rms_diff=spread_rms,
                prefill_logits_max_abs_diff=diff,
                prefill_logits_rms_diff=diff_rms,
                tokens_compared=compared, tokens_total=total,
                window_control_call_ratios=(control if cfg.sliding_window
                                            else None),
                window_control_logits_max_abs_diff=others or None,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def plan_dense(torch, tag, cfg, params, max_cout, hist, raws, names=None):
    """Emit ``cfg``'s diana artifact at ``max_cout`` (static activation
    scales), lower and bind it at full coverage; the plan's histogram must
    be ``hist`` and each (K, N)'s raw boundary ``raws[(K, N)]``, read from
    the plan layers ``names`` (by default wq, wk, wo, up and down of
    repeat 0).  Returns (artifact, plan, backend, KV config)."""
    from repro_torch.launch.serve import (check_coverage, kv_cache_for,
                                          plan_mapping_execution)
    from repro_torch.launch.train import emit_static_mapping
    t0 = time.perf_counter()
    art = emit_static_mapping(
        params, cfg, "diana",
        ROOT / "build" / "chip_smoke" / f"{cfg.name}_diana.json",
        max_cout=max_cout, act_log_scale=2.0)
    plan, backend = plan_mapping_execution(params, art)
    check_coverage(tag, backend, require_full=True)
    for line in plan.histogram_lines():
        print(f"[{tag}] {line}")
    if plan.kernel_histogram() != hist:
        raise AssertionError(f"{tag}: kernel histogram "
                             f"{plan.kernel_histogram()}, expected {hist}")
    seen = {}
    for name in names or [
            f"units/0/{'attn' if n.startswith('w') else 'ffn'}/{n}@0"
            for n in ("wq", "wk", "wo", "up", "down")]:
        lp = plan[name]
        seen[(lp.c_in, lp.c_out)] = lp
    for (k, n), raw in raws.items():
        lp = seen[(k, n)]
        if lp.boundaries[0] != raw:
            raise AssertionError(f"{tag} ({k} x {n}): raw boundary "
                                 f"{lp.boundaries}, expected {raw}")
        print(f"[{tag}] {lp.name} ({k} x {n}): counts {lp.counts}, raw "
              f"boundary {lp.boundaries}, aligned {lp.aligned_boundaries}")
    kcfg = kv_cache_for(cfg, art)
    print(f"[{tag}] diana at max_cout {max_cout}: {backend.coverage()}; "
          f"{len(plan.layers)} planned layers, {sum(hist.values())} "
          f"launches per forward {hist}; kv {kcfg.kv_cache_dtype} (map, "
          f"lower and bind {time.perf_counter() - t0:.1f} s)")
    return art, plan, backend, kcfg


def phase_danube(torch, seed, smi, device="cuda"):
    """h2o-danube-3-4b at full width (module docstring, phase 12): legs
    fixed and engine_paged_mixed at `DANUBE_LAYERS` layers, long at full
    depth; returns
    {leg: record}.  ``device`` "cpu" serves a rehearsal, with the config
    reduced and the CUDA-only calls stubbed by the caller."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.serve import (check_coverage, kv_cache_for,
                                          plan_mapping_execution)
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()

    def at():
        return f"{time.perf_counter() - t_phase:.1f} s into the phase"
    cfg = cfgbase.get(DANUBE)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(gen, cfg)
    print(f"[danube] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"head_dim {cfg.hd}, sliding window {cfg.sliding_window}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; params "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B ({smi})")
    hist = DANUBE_HIST
    art, plan, backend, kcfg = plan_dense(torch, "danube", cfg, params,
                                          DANUBE_MAX_COUT, hist, DANUBE_RAW)
    # the fixed and engine legs at the first DANUBE_LAYERS layers
    ccfg, cparams, cart = cut_depth(cfg, params, art, DANUBE_LAYERS)
    chist = DANUBE_CUT_HIST
    cplan, cbackend = plan_mapping_execution(cparams, cart)
    check_coverage("danube", cbackend, require_full=True)
    if cplan.kernel_histogram() != chist:
        raise AssertionError(f"danube at {ccfg.n_layers} layers: kernel "
                             f"histogram {cplan.kernel_histogram()}, "
                             f"expected {chist}")
    ckcfg = kv_cache_for(ccfg, cart)
    print(f"[danube] legs fixed and engine_paged_mixed at {ccfg.n_layers} "
          f"of {cfg.n_layers} layers (views of the stacked repeats): "
          f"{cbackend.coverage()}, {sum(chist.values())} launches per "
          f"forward {chist}; the long leg at all {cfg.n_layers}")
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device=dev)
    out = {"fixed": fixed_batch(torch, "danube:fixed", ckcfg, cparams,
                                cbackend, chist, prompts, dict(chist))}
    del prompts
    print(f"[danube] fixed done ({at()})")

    # the captured paged_update: layer 5's k in the third forward, as at
    # full depth
    out.update(mixed_legs(torch, "danube", ckcfg, cparams, cbackend, chist,
                          seed, smi, DANUBE_MIXED, prefix_cache=True,
                          dense=False, capture=2 * 2 * DANUBE_LAYERS + 10))
    out.update(layers=ccfg.n_layers, layers_in_config=cfg.n_layers)
    del cplan, cbackend, cparams
    gc.collect()
    print(f"[danube] engine legs done ({at()})")
    # long: one dense admission group of 2 x 8192 tokens; each layer's
    # attention through flash at D 120 with the window
    out["long"] = dense_long_leg(torch, "danube", kcfg, params, backend,
                                 hist, DANUBE_LONG, seed, smi, cfg.n_layers,
                                 DANUBE_LONG["prompts"][0])
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[danube] phase {out['seconds']:.1f} s, long-leg peak memory "
          f"{out['long']['peak_gib']:.2f} GiB ({smi})")
    del plan, backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_dense_fixed(torch, key, seed, smi, device="cuda"):
    """nemotron-4-15b or command-r-35b (``key`` of `DENSE_FIXED`; module
    docstring, phase 12) at full width on diana, the fixed batch only;
    returns its record.  ``device`` "cpu" serves a rehearsal."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    name, layers, max_cout, hist, raws = DENSE_FIXED[key]
    t_phase = time.perf_counter()
    cfg = cfgbase.get(name)
    full = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=min(layers, full))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(gen, cfg)
    print(f"[{key}] {cfg.name}: {cfg.n_layers} of {full} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"head_dim {cfg.hd}, d_ff {cfg.d_ff} ({cfg.act}, "
          f"{'gated' if cfg.gated_ffn else 'ungated'}), vocab {cfg.vocab}, "
          f"{cfg.norm}, parallel block {cfg.parallel_block}, tied head "
          f"{cfg.tie_embeddings}; params "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B (init "
          f"{time.perf_counter() - t_phase:.1f} s; {smi})")
    _, plan, backend, kcfg = plan_dense(torch, key, cfg, params, max_cout,
                                        hist, raws)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device=dev)
    rec = fixed_batch(torch, f"{key}:fixed", kcfg, params, backend, hist,
                      prompts, dict(hist))
    rec.update(layers=cfg.n_layers, layers_in_config=full,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               seconds=time.perf_counter() - t_phase)
    print(f"[{key}] phase {rec['seconds']:.1f} s, peak memory "
          f"{rec['peak_gib']:.2f} GiB ({smi})")
    del prompts, plan, backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_deepseek(torch, seed, smi, device="cuda"):
    """deepseek-v2-lite-16b at full width and depth (module docstring,
    phase 13): legs fixed, engine_paged_mixed and long; returns {leg:
    record}.  ``device`` "cpu" serves a rehearsal, with the config reduced
    and the CUDA-only calls stubbed by the caller."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()

    def at():
        return f"{time.perf_counter() - t_phase:.1f} s into the phase"
    cfg = cfgbase.get(DEEPSEEK)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(gen, cfg)
    m, moe = cfg.mla, cfg.moe
    print(f"[deepseek] {cfg.name}: {cfg.n_layers} layers (layer 0 a dense "
          f"FFN of {cfg.dense_ff}), d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, MLA latent {m.kv_lora_rank} + rope {m.qk_rope_dim}, "
          f"query / key dim {m.qk_nope_dim + m.qk_rope_dim}, value dim "
          f"{m.v_head_dim}; {moe.n_experts} routed experts top-{moe.top_k} "
          f"of d_ff {moe.d_ff} + {moe.n_shared} shared, capacity factor "
          f"{moe.capacity_factor}; vocab {cfg.vocab}; params "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B (init "
          f"{time.perf_counter() - t_phase:.1f} s; {smi})")
    hist, dhist = DEEPSEEK_HIST, DEEPSEEK_DECODE_HIST
    _, plan, backend, kcfg = plan_dense(torch, "deepseek", cfg, params,
                                        DEEPSEEK_MAX_COUT, hist, DEEPSEEK_RAW,
                                        names=DEEPSEEK_LAYERS)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device=dev)
    out = {"fixed": fixed_batch(torch, "deepseek:fixed", kcfg, params,
                                backend, hist, prompts, dict(hist),
                                decode_hist=dhist)}
    del prompts
    print(f"[deepseek] fixed done ({at()})")
    out.update(mixed_legs(torch, "deepseek", kcfg, params, backend, hist,
                          seed, smi, DEEPSEEK_MIXED, prefix_cache=False,
                          dense=False, decode_hist=dhist))
    print(f"[deepseek] engine legs done ({at()})")
    # long: one dense admission group of 1 x 2560 tokens; each layer's MLA
    # through flash at query / key dim 192, value dim 128
    out["long"] = dense_long_leg(torch, "deepseek", kcfg, params, backend,
                                 hist, DEEPSEEK_LONG, seed, smi,
                                 cfg.n_layers, DEEPSEEK_LONG["prompts"][0],
                                 decode_hist=dhist, dims=DEEPSEEK_DIMS)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[deepseek] phase {out['seconds']:.1f} s, long-leg peak memory "
          f"{out['long']['peak_gib']:.2f} GiB ({smi})")
    del plan, backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_xlstm(torch, seed, smi, device="cuda"):
    """xlstm-1.3b at full width and depth (module docstring, phase 14):
    legs fixed, engine_paged_mixed and the bank's target-only and spec;
    returns {leg: record}.  ``device`` "cpu" serves a rehearsal, with the
    config reduced and the CUDA-only calls stubbed by the caller."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.serve import (build_planset, check_coverage,
                                          kv_cache_for,
                                          print_planset_report)
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()

    def at():
        return f"{time.perf_counter() - t_phase:.1f} s into the phase"
    cfg = cfgbase.get(XLSTM)
    full = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=XLSTM_REPEATS * len(cfg.pattern))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(gen, cfg)
    xc = T._xlstm_cfg(cfg)
    specs = T.cache_specs(cfg, 1, 1)
    state = sum(t.numel() * t.element_size() for t in T.tree_leaves(specs))
    print(f"[xlstm] {cfg.name}: {cfg.n_layers} of {full} blocks "
          f"({cfg.pattern_repeats} x {cfg.pattern.count('mlstm')} mLSTM + "
          f"{cfg.pattern.count('slstm')} sLSTM), d_model {cfg.d_model}, "
          f"{xc.n_heads} heads of head dim {xc.head_dim} (d_inner "
          f"{xc.d_inner}), conv {xc.conv_kernel}, vocab {cfg.vocab}; params "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B; recurrent "
          f"state {state / 1e6:.1f} MB per slot (init "
          f"{time.perf_counter() - t_phase:.1f} s; {smi})")
    hist = XLSTM_HIST
    art, plan, backend, kcfg = plan_dense(torch, "xlstm", cfg, params,
                                          XLSTM_MAX_COUT, hist, XLSTM_RAW,
                                          names=XLSTM_NAMES)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device=dev)
    forwards = -(-PROMPT_LEN // CHUNK) + GEN_LEN - 1
    # every planned call of the fixed batch checked as it is made
    out = {"fixed": fixed_batch(torch, "xlstm:fixed", kcfg, params, backend,
                                hist, prompts,
                                {k: v * forwards for k, v in hist.items()})}
    del prompts
    print(f"[xlstm] fixed done ({at()})")
    out.update(mixed_legs(torch, "xlstm", kcfg, params, backend, hist, seed,
                          smi, XLSTM_MIXED, prefix_cache=False, dense=False))
    print(f"[xlstm] engine legs done ({at()})")
    del plan, backend
    gc.collect()
    torch.cuda.empty_cache()

    # bank: diana's target and its all-ternary draft, speculative against
    # target-only
    arts = {"target": art, "draft": emit_static_mapping(
        params, cfg, "diana",
        ROOT / "build" / "chip_smoke" / f"{cfg.name}_diana_ternary.json",
        max_cout=XLSTM_MAX_COUT, act_log_scale=2.0, bias=("aimc", 1.0))}
    plans, bank = build_planset(params, arts, "target")
    print_planset_report("xlstm:bank", plans, bank)
    check_coverage("xlstm:bank", bank, require_full=True)
    hists = {"target": XLSTM_HIST, "draft": XLSTM_DRAFT_HIST}
    plan_hists = {v: plans[v].kernel_histogram() for v in plans}
    if plan_hists != hists:
        raise AssertionError(f"xlstm bank histograms {plan_hists}, expected "
                             f"{hists}")
    bcfg = kv_cache_for(cfg, arts["target"])
    trec, srec = spec_replay_legs(torch, "xlstm", bcfg, params, bank, hists,
                                  XLSTM_BANK, seed, smi, at)
    if not srec["partial_accept_replays"]:
        raise AssertionError("xlstm:spec: no round replayed a partial "
                             "accept")
    out["target_only"], out["spec"] = trec, srec
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[xlstm] phase {out['seconds']:.1f} s, peak memory "
          f"{out['peak_gib']:.2f} GiB ({smi})")
    del plans, bank, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_arctic(torch, seed, smi, device="cuda"):
    """arctic-480b at full width, `ARCTIC_LAYERS` of its 35 layers (module
    docstring, phase 15), on diana: the fixed batch, every planned call
    checked as it is made, with the MoE's capacity drops and the peak
    memory; returns its record.  ``device`` "cpu" serves a rehearsal."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = cfgbase.get(ARCTIC)
    full = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=min(ARCTIC_LAYERS, full))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = T.init_lm(gen, cfg)
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    moe = cfg.moe
    experts = sum(params["units"][0]["moe"][key].numel()
                  for key in ("up", "gate", "down"))
    print(f"[arctic] {cfg.name}: {cfg.n_layers} of {full} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"head_dim {cfg.hd}; {moe.n_experts} experts top-{moe.top_k} of "
          f"d_ff {moe.d_ff} (capacity factor {moe.capacity_factor}) beside a "
          f"dense residual FFN of {cfg.dense_ff}; vocab {cfg.vocab}; params "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B, of them "
          f"expert weights {experts * 2 / 1e9:.2f} GB bf16; device bytes "
          f"{(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB (beside "
          f"{base / 1e9:.2f} GB of earlier phases'), init "
          f"peak {init_peak:.2f} GiB (init "
          f"{time.perf_counter() - t_phase:.1f} s; {smi})")
    hist = ARCTIC_HIST
    _, plan, backend, kcfg = plan_dense(torch, "arctic", cfg, params,
                                        ARCTIC_MAX_COUT, hist, ARCTIC_RAW,
                                        names=ARCTIC_NAMES)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device=dev)
    forwards = -(-PROMPT_LEN // CHUNK) + GEN_LEN - 1
    drops = {}
    rec = fixed_batch(torch, "arctic:fixed", kcfg, params, backend, hist,
                      prompts, {k: v * forwards for k, v in hist.items()},
                      drops=drops)
    drops = {k: int(v) for k, v in drops.items()}
    rec.update(layers=cfg.n_layers, layers_in_config=full,
               init_peak_gib=init_peak,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               moe_dropped=drops["dropped"], moe_pairs=drops["pairs"],
               seconds=time.perf_counter() - t_phase)
    print(f"[arctic:fixed] MoE dispatch over the kernel run: "
          f"{drops['dropped']} of {drops['pairs']} valid (token, k) pairs "
          f"dropped by capacity ({drops['dropped'] / drops['pairs']:.4f}; "
          f"factor {moe.capacity_factor}: {moe.n_experts} experts, top-"
          f"{moe.top_k})")
    print(f"[arctic] phase {rec['seconds']:.1f} s, peak memory "
          f"{rec['peak_gib']:.2f} GiB (init {init_peak:.2f}; {smi})")
    del prompts, plan, backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_frontend(torch, key, seed, smi, device="cuda"):
    """llama-3.2-vision-11b (``key`` "llama", phase 16) or
    seamless-m4t-large-v2 ("seamless", phase 17) at full width and depth on
    diana (`FRONTEND`), each request with one stub frontend row drawn from
    --seed: the fixed batch (every planned call checked as it is made,
    tokens and prefill logits identical to the plain run's), the same
    batch with the rows zeroed (its prefill logits must move: the
    frontend path is live), engine_paged_mixed against its plain run; for
    seamless also the encoder's time over the 4 slots' rows, which every
    chunk step reruns.  Returns {leg: record}.  ``device`` "cpu" serves a
    rehearsal, with the config reduced and the CUDA-only calls stubbed by
    the caller."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.serve import frontend_rows, serve_batch
    from repro_torch.models import _backend
    from repro_torch.models import transformer as T
    name, max_cout, hist, dhist, raws, names, _ = FRONTEND[key]
    t_phase = time.perf_counter()

    def at():
        return f"{time.perf_counter() - t_phase:.1f} s into the phase"
    cfg = cfgbase.get(name)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(gen, cfg)
    if "cross" in cfg.pattern:
        params["units"][cfg.pattern.index("cross")]["gate"].fill_(LLAMA_GATE)
    print(f"[{key}] {cfg.name}: {cfg.n_layers} layers {cfg.pattern} x "
          f"{cfg.pattern_repeats}" + (f" + a {cfg.encoder_layers}-layer "
                                      f"encoder" if cfg.encoder_layers
                                      else "") +
          f", d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
          f"kv of {cfg.hd}, d_ff {cfg.d_ff} ({cfg.act}, {cfg.norm}), vocab "
          f"{cfg.vocab}, {cfg.frontend} frontend rows of "
          f"{cfg.frontend_tokens} x {cfg.d_model}"
          + (f", cross gates {LLAMA_GATE}" if "cross" in cfg.pattern else "")
          + f"; params {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B"
          f" (init {time.perf_counter() - t_phase:.1f} s; {smi})")
    _, plan, backend, kcfg = plan_dense(torch, key, cfg, params, max_cout,
                                        hist, raws, names=names)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device=dev)
    rows = frontend_rows(cfg, REQUESTS, gen)
    chunks = -(-PROMPT_LEN // CHUNK)
    keep = {}
    # every planned call of the fixed batch checked as it is made
    out = {"fixed": fixed_batch(
        torch, f"{key}:fixed", kcfg, params, backend, hist, prompts,
        forward_launches(hist, chunks, GEN_LEN - 1, dhist),
        decode_hist=dhist, frontend=rows, keep=keep)}
    calls = []
    with recording_logits(calls):
        zeroed, _ = serve_batch(kcfg, params, prompts, GEN_LEN,
                                frontend=torch.zeros_like(rows),
                                backend=backend)
    moved = float((batch_logits(torch, zeroed, calls)[0]
                   - keep["first"]).abs().max())
    del calls
    if not moved > 0:
        raise AssertionError(f"{key}: zeroed frontend rows left the prefill "
                             f"logits as they were")
    out["fixed"]["zeroed_rows_logits_max_abs_diff"] = moved
    print(f"[{key}:fixed] the same batch with its frontend rows zeroed: "
          f"prefill logits move by max |diff| {moved:.4f} (the frontend "
          f"path is live; {at()})")
    del prompts, zeroed
    out.update(mixed_legs(
        torch, key, kcfg, params, backend, hist, seed, smi, FRONTEND_MIXED,
        prefix_cache=False, dense=False, decode_hist=dhist,
        frontend=lambda n: frontend_rows(cfg, n, gen)))
    print(f"[{key}] engine legs done ({at()})")
    if cfg.encoder_layers:
        # the encoder over every slot's rows, as each chunk step runs it
        ms = []
        with _backend.use(backend):
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                T.encode(params, cfg, rows)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        out["encoder_ms_per_chunk"] = median(ms[1:])
        print(f"[{key}] the encoder over {REQUESTS} slots' rows (M "
              f"{REQUESTS * cfg.frontend_tokens}, {cfg.encoder_layers} "
              f"layers, {6 * cfg.encoder_layers} planned launches), as "
              f"every chunk step reruns it: median "
              f"{out['encoder_ms_per_chunk']:.3f} ms of 3 warm runs "
              f"({', '.join(f'{t:.3f}' for t in ms[1:])}; {smi})")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{key}] phase {out['seconds']:.1f} s, peak memory "
          f"{out['peak_gib']:.2f} GiB ({smi})")
    del rows, plan, backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fault_spec(markers):
    """The faults leg's spec: ``nonfinite_logits`` at step S on slot b1,
    ``corrupt_page`` at S + 1 on b2 and a 40-step ``stuck`` fault at S + 2
    on b3, where the target-only run (its decode-step ``markers``) has b1,
    b2 and b3 decoding one request each through steps S..S + 2
    (`FaultInjector.draw` fires only on occupied slots; a fault changes
    the schedule of its own request only, so the later events still land);
    S is the middle such step."""
    active = {at: set(slots) for _, (kind, slots, at), _, _ in markers
              if kind == "decode"}
    common = {at: active[at] & active.get(at + 1, set()) &
              active.get(at + 2, set()) for at in active}
    cands = sorted(at for at, slots in common.items() if len(slots) >= 3)
    if not cands:
        raise AssertionError(f"faults: no three slots decode through three "
                             f"steps in the target-only run ({active})")
    step = cands[len(cands) // 2]
    b1, b2, b3 = sorted(common[step])[:3]
    return (f"nonfinite_logits@{step}:{b1},corrupt_page@{step + 1}:{b2},"
            f"stuck@{step + 2}:{b3}x40")


def checking_cnn_calls(torch, calls):
    """Context: every call of the four int8 ops is held against its plain
    version on its own inputs as it is made -- bit for bit, and
    split_precision's bf16 columns (where the boundary leaves any) within
    the summation bound -- and kept in ``calls[kernel]`` as (args, kw) for
    the timing.  The kernels launch as before; the plain versions launch
    nothing."""
    import contextlib
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_ternary import split_ternary_plain
    from repro_torch.kernels.ternary_matmul import ternary_matmul_plain

    def split_plain(x, w_q, w_p, sx, sw, boundary, bn=128):
        n = w_q.shape[1]
        b_al = min(ops.align_boundary(boundary, ops.block_n(bn, n)), n)
        return split_ternary_plain(x, w_q, w_p, sx, sw, b_al)
    plains = {"quant_matmul": quant_matmul_plain,
              "ternary_matmul": ternary_matmul_plain,
              "split_ternary": split_plain}

    def checking(kernel, orig):
        def call(*args, **kw):
            out = orig(*args, **kw)
            calls[kernel].append((args, kw))
            if kernel == "split_precision":
                check_split_precision_calls(torch, [(args, kw, out)])
                return out
            want = plains[kernel](*args, **kw)
            if not torch.equal(out, want):
                raise AssertionError(
                    f"{kernel} call {len(calls[kernel]) - 1} (M "
                    f"{args[0].shape[0]}): max |err| "
                    f"{float((out - want).abs().max())} against the plain "
                    f"version")
            return out
        return call

    @contextlib.contextmanager
    def ctx():
        origs = {k: getattr(ops, f"{k}_op") for k in CNN_KERNELS}
        for k in CNN_KERNELS:
            calls[k] = []
            setattr(ops, f"{k}_op", checking(k, origs[k]))
        try:
            yield
        finally:
            for k in CNN_KERNELS:
                setattr(ops, f"{k}_op", origs[k])
    return ctx()


def cnn_call_bound(kernel, args, kw):
    """(bound ms, what bounds it) of one recorded int8 op call of a CNN
    forward, at its padded (M, K, N): the bytes of the weights it reads
    (int8 codes; split_ternary's packed stream above the aligned
    boundary, split_precision's bf16 weight above it)."""
    from repro_torch.kernels import ops
    if kernel == "split_precision":
        x, x_q, sx, w_b, w_q, sw, raw = args
    else:
        x_q, w_q = args[0], args[1]
        raw = args[5] if kernel == "split_ternary" else None
    m, k = x_q.shape
    n = w_q.shape[1]
    if raw is None:
        return bound_ms(m, k, n, k * n)
    b_al = min(ops.align_boundary(raw, ops.block_n(kw.get("bn", 128), n)),
               n)
    if kernel == "split_ternary":
        return bound_ms(m, k, n, k * b_al + (k // 4) * (n - b_al))
    return bound_ms(m, k, n, k * b_al + 2 * k * (n - b_al), int8_cols=b_al,
                    bf16_cols=n - b_al)


def cnn_library_call(torch, kernel, args, kw):
    """A function computing one recorded int8 op call of a CNN forward
    with PyTorch's library: ``torch._int_mm`` on the call's codes and the
    same epilogue (split_precision: its two calls, ``_int_mm`` on the int8
    columns and a bf16 matmul on the rest).  ``_int_mm`` takes more than
    16 rows and N a multiple of 8, so fewer rows are zero-padded to 32 and
    N to 8, once, before the timing."""
    from repro_torch.kernels import ops
    if kernel == "split_precision":
        x, x_q, sx, w_b, w_q, sw, raw = args
        n = w_q.shape[1]
        b_al = min(ops.align_boundary(raw, ops.block_n(kw.get("bn", 128),
                                                       n)), n)
        hi_w = w_b[:, b_al:].contiguous() if b_al < n else None
        w_q, sw = w_q[:, :b_al], sw[:b_al]
    else:
        x_q, w_q, sx, sw = (args[:2] + args[3:5] if kernel == "split_ternary"
                            else args[:4])
        hi_w = None
    m, n = x_q.shape[0], w_q.shape[1]
    x_lib = torch.cat([x_q, x_q.new_zeros(32 - m, x_q.shape[1])]) \
        if m <= 16 else x_q
    if n % 8:
        w_q = torch.cat([w_q, w_q.new_zeros(w_q.shape[0], 8 - n % 8)], 1)
    elif not (w_q.is_contiguous() or w_q.t().is_contiguous()):
        w_q = w_q.contiguous()

    def lib():
        lo = torch._int_mm(x_lib, w_q)[:m, :n].to(torch.float32) * sx * \
            sw[None, :]
        return lo if hi_w is None else (lo, torch.matmul(x, hi_w))
    return lib


def cnn_kernel_times(torch, calls):
    """{kernel: record} of one CNN forward: the device ms of the recorded
    calls of each kernel replayed as one CUDA graph, and of the same calls
    through PyTorch's library (`cnn_library_call`), median and range of
    ROUNDS rounds interleaved (kernel, library, ...), beside the summed
    bound of the calls."""
    from repro_torch.kernels import ops
    fns = {}
    for kernel, recorded in calls.items():
        if recorded:
            op = getattr(ops, f"{kernel}_op")
            fns[kernel] = (lambda op=op, recorded=recorded:
                           [op(*a, **kw) for a, kw in recorded])
            libs = [cnn_library_call(torch, kernel, a, kw)
                    for a, kw in recorded]
            fns[f"{kernel}:library"] = (lambda libs=libs:
                                        [lib() for lib in libs])
    rounds = graph_rounds(fns, 1)
    out = {}
    for kernel, xs in rounds.items():
        if kernel.endswith(":library"):
            continue
        rec = {"calls": len(calls[kernel])}
        spread(rec, "ms", xs)
        spread(rec, "library_ms", rounds[f"{kernel}:library"])
        bounds = [cnn_call_bound(kernel, a, kw) for a, kw in calls[kernel]]
        rec["bound_ms"] = sum(b for b, _ in bounds)
        by_bytes = sum(b for b, what in bounds if what == "bytes")
        rec["bound_by"] = ("bytes" if by_bytes >= rec["bound_ms"] / 2
                           else "operations")
        out[kernel] = rec
    return out


def phase_cnn(torch, seed, smi, device="cuda"):
    """The paper's CNNs served on the card (`CNN_LEGS`): each leg emits
    the (model, platform) artifact with the model's plan hints, lowers
    and binds it at full coverage, and runs one forward with the kernels
    on ``batch`` random images of the model's size (launch counts = the
    JAX lowering's histogram; 0 weight copies; every kernel call held
    against its plain version on its own inputs), then the plain versions
    (``reference=True``; logits bit-identical) and the unplanned fp
    forward (its distance printed, not gated); then the recorded calls'
    device times against their bounds, CNN_WARM timed warm forwards
    (median, range, img/s, peak GiB) and a profiled one (device busy,
    idle share).  Returns {leg: record}."""
    from repro_torch.launch.serve import (check_coverage,
                                          plan_mapping_execution)
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import cnn as C
    from repro_torch.models import managed as mg
    dev = torch.device(device)
    out, models = {}, {}
    for name, platform, batch in CNN_LEGS:
        tag = f"cnn:{name}:{platform}:B{batch}"
        cfg = C.get_config(name)
        init_fn, apply_fn, _ = C.get_model(cfg)
        if name not in models:
            models.clear()
            gc.collect()
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev).manual_seed(seed)
            models[name] = (init_fn(gen, cfg), gen, {})
        params, gen, images = models[name]
        if batch not in images:
            images[batch] = torch.randn((batch, *cfg.img_hw, cfg.in_ch),
                                        generator=gen, device=dev)
        x = images[batch]
        t0 = time.perf_counter()
        art = emit_static_mapping(
            params, cfg, platform,
            ROOT / "build" / "chip_smoke" / f"{name}_{platform}.json",
            plan_hints=C.plan_hints(cfg))
        plan, backend = plan_mapping_execution(params, art)
        check_coverage(tag, backend, require_full=True)
        hist = plan.kernel_histogram()
        if hist != CNN_HIST[name, platform]:
            raise AssertionError(f"{tag}: kernel histogram {hist}, the JAX "
                                 f"lowering's {CNN_HIST[name, platform]}")
        print(f"[{tag}] {sum(t.numel() for t in _leaves(params))} params, "
              f"{len(plan.layers)} planned layers {hist}, "
              f"{backend.coverage()} (map, lower and bind "
              f"{time.perf_counter() - t0:.1f} s); {smi}")

        calls = {}
        reset_launches()
        with checking_cnn_calls(torch, calls), \
                mg.matmul_backend(backend):
            logits = apply_fn(params, x, cfg)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernel_launches().items() if v}
        if launches != hist:
            raise AssertionError(f"{tag}: launches {launches} per forward, "
                                 f"expected {hist}")
        check_no_weight_copies(tag)
        if tuple(logits.shape) != (batch, cfg.n_classes) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{tag}: logits of shape "
                                 f"{tuple(logits.shape)} or not finite")
        if backend.runtime_declines:
            raise AssertionError(f"{tag}: declined {backend.runtime_declines}")
        backend.reference = True
        with mg.matmul_backend(backend):
            ref_logits = apply_fn(params, x, cfg)
        backend.reference = False
        if kernel_launches() != {k: hist.get(k, 0) for k in KERNELS}:
            raise AssertionError(f"{tag}: the plain-version run launched a "
                                 f"kernel")
        if not torch.equal(logits, ref_logits):
            raise AssertionError(
                f"{tag}: kernel logits differ from the plain run's by "
                f"{float((logits - ref_logits).abs().max())}")
        fp_logits = apply_fn(params, x, cfg)
        fp_diff = float((logits - fp_logits).abs().max())
        fp_rel = float((logits - fp_logits).norm() /
                       fp_logits.norm().clamp_min(1e-30))
        print(f"[{tag}] launches per forward: " + " ".join(
            f"{k} {v}" for k, v in sorted(launches.items())) +
            f"; weights copied per call 0; {sum(map(len, calls.values()))} "
            f"kernel calls bit-identical to their plain versions; logits "
            f"{tuple(logits.shape)} bit-identical to the plain run's; "
            f"unplanned fp forward (F.conv2d) max |diff| {fp_diff:.4g}, "
            f"relative {fp_rel:.4g}")
        del ref_logits, fp_logits

        ktimes = cnn_kernel_times(torch, calls)
        del calls
        gc.collect()
        torch.cuda.empty_cache()
        for kernel, rec in sorted(ktimes.items()):
            lib_name = ("two calls" if kernel == "split_precision"
                        else "_int_mm")
            print(f"[{tag}] {kernel}: {rec['calls']} calls per forward, "
                  f"device {rec['ms']:.4f} ms ({rec['min_ms']:.4f}-"
                  f"{rec['max_ms']:.4f}) per forward, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), share "
                  f"{rec['bound_ms'] / rec['ms']:.3f}; library ({lib_name}) "
                  f"{rec['library_ms']:.4f} ms ({rec['library_min_ms']:.4f}-"
                  f"{rec['library_max_ms']:.4f}), factor kernel / library "
                  f"{rec['ms'] / rec['library_ms']:.3f}")

        def forward_ms():
            torch.cuda.synchronize()
            t = time.perf_counter()
            with mg.matmul_backend(backend):
                apply_fn(params, x, cfg)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3
        forward_ms()
        torch.cuda.reset_peak_memory_stats()
        walls = [forward_ms() for _ in range(CNN_WARM)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec = {"batch": batch, "launches_per_forward": launches,
               "kernels": ktimes, "peak_gib": peak,
               "fp_max_abs_diff": fp_diff, "fp_rel_diff": fp_rel}
        spread(rec, "forward_ms", walls)
        rec["img_per_s"] = batch / rec["forward_ms"] * 1e3
        print(f"[{tag}] warm forward {rec['forward_ms']:.3f} ms (median of "
              f"{CNN_WARM}, {rec['forward_min_ms']:.3f}-"
              f"{rec['forward_max_ms']:.3f}), {rec['img_per_s']:.1f} img/s, "
              f"peak {peak:.3f} GiB; {smi}")
        busy = profile_device(torch, tag, forward_ms)
        rec["device_busy_ms"] = busy
        rec["idle_share"] = 1.0 - busy / rec["forward_ms"]
        print(f"[profile:{tag}] device busy {busy:.3f} ms of the warm "
              f"forward's {rec['forward_ms']:.3f} ms: idle share "
              f"{rec['idle_share']:.3f}")
        check_no_weight_copies(tag)
        out[tag] = rec
        del plan, backend, logits
    models.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return out


class StageClock:
    """`SearchPipeline` callback: each stage's wall time (the device
    synchronised at both ends)."""

    def __init__(self, torch):
        self.torch, self.walls, self._t = torch, {}, 0.0

    def on_stage_start(self, stage, state):
        self.torch.cuda.synchronize()
        self._t = time.perf_counter()

    def on_stage_end(self, stage, state):
        self.torch.cuda.synchronize()
        self.walls[stage.name] = time.perf_counter() - self._t

    def on_step(self, stage, step, metrics):
        pass


def search_run(torch, handle, data_fn, lam, seed, smi, device):
    """One `SearchPipeline` run of ``handle`` on diana at ``lam``; prints
    each stage's wall and first / last loss, the search's last task and
    regularizer losses and tau, and the result (accuracy, exact latency in
    cycles and energy, the aimc share of the searchable channels, mixed
    layers).  Returns (result, record)."""
    from repro_torch import api as A
    from repro_torch.core import odimo
    scfg = A.SearchConfig(lam=lam, objective="latency", seed=seed,
                          **SEARCH_STEPS)
    clock = StageClock(torch)
    t0 = time.perf_counter()
    res = A.SearchPipeline(handle, "diana", config=scfg, data_fn=data_fn,
                           callbacks=[clock], device=device).run()
    wall = time.perf_counter() - t0
    tag = f"search:{handle.name}:diana:lam{lam:g}"
    rec = {"lam": lam, "wall_s": wall, "stage_s": clock.walls,
           "steps": {k: len(v) for k, v in res.history.items()}}
    for stage in ("pretrain", "search", "finetune"):
        h = res.history[stage]
        first, last = ((h[0][0] + lam * h[0][1], h[-1][0] + lam * h[-1][1])
                       if stage == "search" else (h[0], h[-1]))
        rec[f"{stage}_loss"] = (first, last)
        print(f"[{tag}] {stage}: {len(h)} steps in "
              f"{clock.walls[stage]:.2f} s, loss {first:.4f} -> "
              f"{last:.4f}")
    task, reg = res.history["search"][-1]
    tau = float(odimo.tau_schedule(len(res.history["search"]) - 1,
                                   len(res.history["search"]),
                                   odimo.ODiMOSpec()))
    rec.update(search_last_task=task, search_last_reg=reg, tau_last=tau)
    searchable = [s for (_, _, s) in handle.plan()]
    counts = [c for c, s in zip(res.counts, searchable) if s]
    aimc = sum(int(c[1]) for c in counts) / sum(int(c.sum()) for c in counts)
    mixed = sum(1 for c in res.counts if (c > 0).sum() > 1)
    rec.update(accuracy=res.accuracy, latency_cycles=res.latency,
               energy=res.energy, aimc_fraction=aimc, mixed_layers=mixed,
               counts=[c.tolist() for c in res.counts])
    print(f"[{tag}] search: last task {task:.4f}, reg {reg:.6g}, tau "
          f"{tau:.4f}; discretize {clock.walls['discretize']:.3f} s, "
          f"evaluate {clock.walls['evaluate']:.2f} s; total {wall:.1f} s")
    print(f"[{tag}] accuracy {res.accuracy:.4f}, latency {res.latency:.0f} "
          f"cycles, energy {res.energy:.6g}, aimc channels {aimc:.4f}, "
          f"mixed layers {mixed} of {len(res.counts)}; {smi}")
    return res, rec


def phase_search(torch, seed, smi, device="cuda"):
    """The ODiMO search on the card (phase 11): full-width ResNet20
    (`RESNET20_CFG`) on diana through `SearchPipeline` with the port's
    image stream on the card, at each of `SEARCH_LAMS` (same seed and
    steps): larger lambda must not give a dearer mapping (latency at 5e-7
    <= 1.05 x at 1e-9).  The 5e-7 mapping is deployed: lowered strictly
    with the handle, bound at full coverage, one deploy-mode forward on
    `SEARCH_DEPLOY_BATCH` eval images with the launch counts reset just
    before and read just after (= the plan's histogram), every kernel call
    held against its plain version as it is made, the plain versions' run
    bit-identical, the deployed accuracy and the distance from the
    finetune-mode logits printed; then the artifact served by ``python -m
    repro_torch.launch.serve --arch cnn:resnet20 --mapping ...
    --require-full-coverage``.  Returns the phase's record."""
    from repro_torch import api as A
    from repro_torch import runtime as rt
    from repro_torch.api.pipeline import EVAL_DATA_OFFSET
    from repro_torch.data.pipeline import ImageTaskConfig, image_batch
    from repro_torch.models import cnn as C
    from repro_torch.models import managed as mg
    t_phase = time.perf_counter()
    cfg = C.RESNET20_CFG
    handle = A.cnn_handle(cfg)
    task = ImageTaskConfig(n_classes=cfg.n_classes, img_hw=cfg.img_hw,
                           in_ch=cfg.in_ch)

    def data_fn(step, batch):
        return image_batch(task, step, batch, device=device)
    runs, recs = {}, {}
    for lam in SEARCH_LAMS:
        runs[lam], recs[lam] = search_run(torch, handle, data_fn, lam, seed,
                                          smi, device)
    hi, lo = SEARCH_LAMS
    if not runs[hi].latency <= 1.05 * runs[lo].latency:
        raise AssertionError(f"search: latency {runs[hi].latency} at lambda "
                             f"{hi:g} against {runs[lo].latency} at {lo:g}")
    print(f"[search] lambda {hi:g}: latency {runs[hi].latency:.0f} cycles "
          f"<= 1.05 x {runs[lo].latency:.0f} at lambda {lo:g} (ratio "
          f"{runs[hi].latency / runs[lo].latency:.4f})")

    res = runs[hi]
    tag = f"search:deploy:{cfg.name}:diana:B{SEARCH_DEPLOY_BATCH}"
    path = ROOT / "build" / "chip_smoke" / f"{cfg.name}_searched.json"
    res.artifact.save(path)
    spec = A.Platform.get("diana").spec()
    t0 = time.perf_counter()
    plan = rt.lower(res.artifact, params=res.params, handle=handle,
                    strict=True)
    backend = rt.PlannedBackend(plan, res.params, handle=handle)
    if not backend.fully_covered:
        raise AssertionError(f"{tag}: unbound {backend.unbound}")
    hist = plan.kernel_histogram()
    print(f"[{tag}] {len(plan.layers)} planned layers {hist}, "
          f"{backend.coverage()} (lower and bind "
          f"{time.perf_counter() - t0:.2f} s)"
          + ("" if "split_ternary" in hist else
             "; no layer came out mixed: split_ternary not reached"))
    x, y = image_batch(task, EVAL_DATA_OFFSET, SEARCH_DEPLOY_BATCH,
                       device=device)
    calls = {}
    reset_launches()
    with checking_cnn_calls(torch, calls), mg.matmul_backend(backend), \
            torch.no_grad():
        logits = handle.apply(res.params, x, spec, "deploy", 1.0)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernel_launches().items() if v}
    if launches != hist:
        raise AssertionError(f"{tag}: launches {launches} per forward, "
                             f"expected the plan's {hist}")
    check_no_weight_copies(tag)
    if tuple(logits.shape) != (SEARCH_DEPLOY_BATCH, cfg.n_classes) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: logits of shape "
                             f"{tuple(logits.shape)} or not finite")
    if backend.runtime_declines:
        raise AssertionError(f"{tag}: declined {backend.runtime_declines}")
    backend.reference = True
    with mg.matmul_backend(backend), torch.no_grad():
        ref_logits = handle.apply(res.params, x, spec, "deploy", 1.0)
    backend.reference = False
    if kernel_launches() != {k: hist.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"{tag}: the plain-version run launched a "
                             f"kernel")
    if not torch.equal(logits, ref_logits):
        raise AssertionError(
            f"{tag}: kernel logits differ from the plain run's by "
            f"{float((logits - ref_logits).abs().max())}")
    with torch.no_grad():
        ft_logits = handle.apply(res.params, x, spec, "finetune", 1.0)
    acc = float((logits.argmax(-1) == y).float().mean())
    ft_acc = float((ft_logits.argmax(-1) == y).float().mean())
    ft_diff = float((logits - ft_logits).abs().max())
    ft_rel = float((logits - ft_logits).norm() /
                   ft_logits.norm().clamp_min(1e-30))
    print(f"[{tag}] launches per forward: " + " ".join(
        f"{k} {v}" for k, v in sorted(launches.items())) +
        f"; {sum(map(len, calls.values()))} kernel calls bit-identical to "
        f"their plain versions; logits bit-identical to the plain run's; "
        f"deployed accuracy {acc:.4f} (finetune mode {ft_acc:.4f}); "
        f"finetune-mode logits max |diff| {ft_diff:.4g}, relative "
        f"{ft_rel:.4g}; {smi}")

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           f"cnn:{cfg.name}", "--mapping", str(path),
           "--require-full-coverage"]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print(f"[{tag}] serve: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: serve exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    serve_s = time.perf_counter() - t0
    print(f"[{tag}] serve --arch cnn:{cfg.name} --mapping {path.name} "
          f"--require-full-coverage exits 0 ({serve_s:.1f} s)")
    rec = {"runs": {f"{lam:g}": recs[lam] for lam in SEARCH_LAMS},
           "deploy": {"histogram": hist, "launches": launches,
                      "accuracy": acc, "finetune_accuracy": ft_acc,
                      "finetune_max_abs_diff": ft_diff,
                      "finetune_rel_diff": ft_rel, "serve_s": serve_s},
           "phase_s": time.perf_counter() - t_phase}
    del runs, res, plan, backend, logits, ref_logits, ft_logits
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def watching_train(torch, rec):
    """Context: the trainer observed through shims on the module functions
    it calls.  Each AdamW update records its gradient norm and how many
    gradient leaves are all zero; each step's time is the one the trainer
    hands `StragglerPolicy`; `AsyncCheckpointer.save` (the host snapshot),
    `checkpoint.save` (the write, on the background thread) and
    `checkpoint.restore` are timed."""
    import contextlib
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import tree as T
    from repro_torch.launch import train as TRN
    from repro_torch.optim import adamw
    rec.update(gnorms=[], zero_leaves=[], leaves=0, step_s=[], snapshot_s=[],
               save_s=[], restore_s=[])
    orig = {"update": adamw.update, "save": ckpt.save,
            "restore": ckpt.restore, "async": ckpt.AsyncCheckpointer.save,
            "policy": TRN.StragglerPolicy}

    def update(grads, *args, **kw):
        leaves = T.leaves(grads)
        rec["leaves"] = len(leaves)
        nonzero = torch.stack([g.ne(0).any() for g in leaves])
        rec["zero_leaves"].append(int((~nonzero).sum()))
        out = orig["update"](grads, *args, **kw)
        rec["gnorms"].append(float(out[2]))
        return out

    def timed(fn, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if key == "restore_s":
                torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t0)
            return out
        return call

    class Policy(orig["policy"]):
        def observe(self, step, dt):
            rec["step_s"].append(dt)
            return super().observe(step, dt)

    @contextlib.contextmanager
    def ctx():
        adamw.update = update
        ckpt.save = timed(orig["save"], "save_s")
        ckpt.restore = timed(orig["restore"], "restore_s")
        ckpt.AsyncCheckpointer.save = timed(orig["async"], "snapshot_s")
        TRN.StragglerPolicy = Policy
        try:
            yield
        finally:
            adamw.update, ckpt.save, ckpt.restore = \
                orig["update"], orig["save"], orig["restore"]
            ckpt.AsyncCheckpointer.save = orig["async"]
            TRN.StragglerPolicy = orig["policy"]
    return ctx()


def check_train_leg(tag, rec, steps, first):
    """A training leg's gates: ``steps`` logged losses (a skipped step
    would drop one), every loss and gradient norm finite, and from update
    ``first`` on (1: after the trainer's first step) no gradient leaf all
    zero (a detached path gives zeros)."""
    import math
    if len(rec["losses"]) != steps or len(rec["gnorms"]) != steps:
        raise AssertionError(f"{tag}: {len(rec['losses'])} losses and "
                             f"{len(rec['gnorms'])} updates, expected "
                             f"{steps}")
    if not all(map(math.isfinite, rec["losses"] + rec["gnorms"])):
        raise AssertionError(f"{tag}: losses {rec['losses']} or grad norms "
                             f"{rec['gnorms']} not finite")
    if any(rec["zero_leaves"][first:]):
        raise AssertionError(f"{tag}: all-zero gradient leaves per step "
                             f"{rec['zero_leaves']} of {rec['leaves']}")


def profiled_train_step(torch, seed, smi, device):
    """Where a zamba2 training step's time goes: one warm step of
    ``launch.train.make_step`` (leg a's shape and optimiser) under the
    profiler; returns {wall_ms, busy_ms, idle_share}."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.data.pipeline import ShardedLoader, TokenTaskConfig
    from repro_torch.launch import train as TRN
    from repro_torch.models import transformer as TR
    from repro_torch.optim import adamw
    cfg = cfgbase.get(ZAMBA)
    dev = torch.device(device)
    ocfg = adamw.AdamWConfig(lr=3e-4, weight_decay=0.01)
    state = [TR.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg)]
    state.append(adamw.init(state[0], ocfg))
    tokens, targets = ShardedLoader(
        "token", TokenTaskConfig(vocab=cfg.vocab), TRAIN_SHAPE["batch"],
        TRAIN_SHAPE["seq"], device=dev).get(0)
    batch = {"tokens": tokens, "targets": targets}
    step_fn = TRN.make_step(cfg, ocfg, False)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, metrics = step_fn(state[0], state[1], None, batch,
                                          1e-4)
        float(metrics["grad_norm"])
        torch.cuda.synchronize()
        state[:] = [params, opt]
        return (time.perf_counter() - t0) * 1e3
    run()
    busy = profile_device(torch, f"train:{ZAMBA}", run)
    wall = run()
    # where the step's peak falls: the gradient pass, then the update
    gib = 2**30
    resident = torch.cuda.memory_allocated() / gib
    torch.cuda.reset_peak_memory_stats()
    _, grads = TRN.value_and_grad(
        lambda p: TR.lm_loss(p, cfg, batch, remat=True), state[0])
    grad_peak = torch.cuda.max_memory_allocated() / gib
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        adamw.update(grads, state[1], state[0], ocfg, lr=1e-4)
    update_peak = torch.cuda.max_memory_allocated() / gib
    del state, grads
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[profile:train:{ZAMBA}] device busy {busy:.3f} ms of a warm "
          f"step's {wall:.3f} ms: idle share {1.0 - busy / wall:.3f}; "
          f"memory: params + AdamW state {resident:.2f} GiB, peak of the "
          f"gradient pass {grad_peak:.2f} GiB, of the update "
          f"{update_peak:.2f} GiB ({smi})")
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "resident_gib": resident, "grad_peak_gib": grad_peak,
            "update_peak_gib": update_peak}


def phase_train(torch, seed, smi, device="cuda"):
    """Phase 18 (module docstring): zamba2-1.2b trained at full width and
    depth through ``repro_torch.launch.train.main`` (legs a-d of
    `TRAIN_STEPS` / `TRAIN_RESUME_AT`), its step `TRAIN_STEPS` checkpoint
    restored, its trained mapping lowered by ``repro_torch.runtime.lower
    .main --arch`` and served at the fixed batch with every planned call
    checked; then ResNet20 trained with ``--emit-mapping`` and served
    through ``launch.serve.main`` at batch 256 with every call checked.
    Returns {leg: record}.  ``device`` "cpu" rehearses with the CUDA-only
    calls stubbed by the caller."""
    import shutil
    from repro_torch.api import MappingArtifact
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TRN
    from repro_torch.models import transformer as TR
    from repro_torch.optim import adamw
    from repro_torch.runtime.lower import main as lower_main
    t_phase = time.perf_counter()

    def at():
        return f"{time.perf_counter() - t_phase:.1f} s into the phase"
    dev = torch.device(device)
    work = ROOT / "build" / "chip_smoke"
    ck = work / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    art_path = work / f"{ZAMBA}_trained.json"
    n, k = TRAIN_STEPS, TRAIN_RESUME_AT
    B, S = TRAIN_SHAPE["batch"], TRAIN_SHAPE["seq"]
    common = ["--arch", ZAMBA, "--batch", str(B), "--seq", str(S),
              "--warmup", str(TRAIN_WARMUP), "--log-every", "1", "--seed",
              str(seed), "--device", device]
    ckpt_args = ["--ckpt-dir", str(ck), "--ckpt-every", str(10 * n)]
    legs = {"a": (n, ["--steps", str(n)]),
            "b": (k, ["--steps", str(k)] + ckpt_args),
            "c": (n - k, ["--steps", str(n), "--resume", "--emit-mapping",
                          str(art_path), "--platform", "diana",
                          "--mapping-act-scale", "2.0"] + ckpt_args),
            "d": (k, ["--steps", str(k), "--compress-grads"])}
    what = {"a": f"{n} steps", "b": f"{k} steps into a checkpoint",
            "c": f"resumed at step {k} to {n}, mapping emitted",
            "d": f"{k} steps with int8 gradient compression"}
    out = {}
    for leg, (steps, extra) in legs.items():
        tag = f"train:{ZAMBA}:{leg}"
        rec = {}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with watching_train(torch, rec):
            rec["losses"] = TRN.main(common + extra)
        rec["wall_s"] = time.perf_counter() - t0
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        check_train_leg(tag, rec, steps, first=0 if leg == "c" else 1)
        warm = rec["step_s"][1:] or rec["step_s"]
        rec["step_ms"] = median(warm) * 1e3
        rec["tokens_per_s"] = B * S / median(warm)
        ck_line = ""
        if rec["save_s"] or rec["restore_s"]:
            ck_line = (f"; checkpoint snapshot {sum(rec['snapshot_s']):.2f} "
                       f"s, write {sum(rec['save_s']):.2f} s, restore "
                       f"{sum(rec['restore_s']):.2f} s (hashes verified)")
        print(f"[{tag}] {what[leg]}: losses "
              f"{[round(x, 4) for x in rec['losses']]}, grad norms "
              f"{[round(x, 3) for x in rec['gnorms']]}; all-zero gradient "
              f"leaves per step {rec['zero_leaves']} of {rec['leaves']}; "
              f"step {rec['step_ms']:.1f} ms (median of {len(warm)}; first "
              f"{rec['step_s'][0] * 1e3:.1f}), {rec['tokens_per_s']:.0f} "
              f"tokens/s, peak {rec['peak_gib']:.2f} GiB{ck_line}; wall "
              f"{rec['wall_s']:.1f} s ({smi})")
        out[leg] = rec
    out["profile"] = profiled_train_step(torch, seed, smi, device)
    ref = out["a"]["losses"][k:]
    dist = max(abs(c - a) / abs(a) for c, a in zip(out["c"]["losses"], ref))
    if dist > TRAIN_RTOL:
        raise AssertionError(
            f"train:{ZAMBA}: resumed losses {out['c']['losses']} against the "
            f"uninterrupted run's {ref}: relative {dist:.3g} > {TRAIN_RTOL}")
    out["resume_rel_dist"] = dist
    print(f"[train:{ZAMBA}] the resumed run's losses equal the uninterrupted "
          f"run's steps {k}..{n - 1} within relative {dist:.3g} (rtol "
          f"{TRAIN_RTOL}) ({at()})")

    # the step-n checkpoint back on the card, its mapping lowered and served
    cfg = cfgbase.get(ZAMBA)
    meta = TR.param_shapes(cfg)
    like = (meta, adamw.init(meta, adamw.AdamWConfig()))
    step = ckpt.latest_step(ck)
    ck_bytes = (ck / f"step_{step:08d}" / "arrays.npz").stat().st_size
    t0 = time.perf_counter()
    params, _ = ckpt.restore(ck, step, like, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ck)
    gc.collect()
    torch.cuda.empty_cache()
    if step != n:
        raise AssertionError(f"train:{ZAMBA}: latest committed step {step}")
    plan = lower_main([str(art_path), "--arch", ZAMBA, "--out",
                    str(work / f"{ZAMBA}_trained_plan.json")])
    if plan.kernel_histogram() != TRAIN_ZAMBA_PLAN:
        raise AssertionError(f"train:{ZAMBA}: lowered plan "
                             f"{plan.kernel_histogram()}")
    art = MappingArtifact.load(art_path)
    _, backend = SV.plan_mapping_execution(params, art)
    SV.check_coverage(f"train:{ZAMBA}", backend, require_full=True)
    kcfg = SV.kv_cache_for(cfg, art)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device=dev)
    forwards = -(-PROMPT_LEN // CHUNK) + GEN_LEN - 1
    limits = {kn: v * forwards for kn, v in TRAIN_ZAMBA_HIST.items()}
    out["serve"] = fixed_batch(torch, f"train:{ZAMBA}:serve", kcfg, params,
                               backend, TRAIN_ZAMBA_HIST, prompts, limits)
    check_no_weight_copies(f"train:{ZAMBA}:serve")
    out["checkpoint_gb"] = ck_bytes / 1e9
    out["restore_s"] = restore_s
    print(f"[train:{ZAMBA}] step {step} checkpoint {ck_bytes / 1e9:.3f} GB "
          f"(params + AdamW state) restored onto the card in {restore_s:.2f} "
          f"s, hashes verified; the trained diana mapping lowered by "
          f"runtime.lower.main --arch ({plan.kernel_histogram()}) and served "
          f"at full depth: launches "
          f"{ {kn: v for kn, v in out['serve']['launches'].items() if v} } "
          f"({at()})")
    del params, backend, prompts
    gc.collect()
    torch.cuda.empty_cache()

    # ResNet20: trained, its mapping emitted, lowered and served at B 256
    c = TRAIN_CNN
    tag = f"train:{c['name']}"
    cart = work / f"{c['name']}_trained.json"
    rec = {}
    t0 = time.perf_counter()
    with watching_train(torch, rec):
        rec["losses"] = TRN.main(
            ["--arch", f"cnn:{c['name']}", "--steps", str(c["steps"]),
             "--batch", str(c["batch"]), "--lr", str(c["lr"]), "--warmup",
             str(c["warmup"]), "--log-every", "10", "--seed", str(seed),
             "--device", device, "--emit-mapping", str(cart), "--platform",
             "diana"])
    rec["wall_s"] = time.perf_counter() - t0
    first5, last5 = (sum(rec["losses"][:5]) / 5, sum(rec["losses"][-5:]) / 5)
    if not last5 < first5:
        raise AssertionError(f"{tag}: the mean loss of the last 5 steps "
                             f"{last5:.4f} is not below the first 5's "
                             f"{first5:.4f}")
    plan = lower_main([str(cart), "--out",
                       str(work / f"{c['name']}_plan.json")])
    hist = plan.kernel_histogram()
    if hist != CNN_HIST[c["name"], "diana"]:
        raise AssertionError(f"{tag}: lowered plan {hist}")
    calls = {}
    reset_launches()
    with checking_cnn_calls(torch, calls):
        logits, st = SV.main(["--arch", f"cnn:{c['name']}", "--mapping",
                              str(cart), "--require-full-coverage",
                              "--requests", str(c["serve_batch"]), "--seed",
                              str(seed), "--device", device])
    torch.cuda.synchronize()
    launches = {kn: v for kn, v in kernel_launches().items() if v}
    if launches != hist:
        raise AssertionError(f"{tag}: served launches {launches}, the "
                             f"plan's {hist}")
    check_no_weight_copies(tag)
    checked = sum(map(len, calls.values()))
    rec.update(first5=first5, last5=last5, launches=launches,
               calls_checked=checked, serve_forward_ms=st["forward_s"] * 1e3)
    print(f"[{tag}] {c['steps']} steps at batch {c['batch']}: mean loss "
          f"{first5:.4f} over the first 5, {last5:.4f} over the last 5 "
          f"(losses {rec['losses'][0]:.4f} -> {rec['losses'][-1]:.4f}), "
          f"{rec['wall_s'] / c['steps'] * 1e3:.1f} ms per step with the "
          f"mapping emitted; served at B {c['serve_batch']} through "
          f"launch.serve.main --require-full-coverage: launches {launches} "
          f"(the plan's), {checked} kernel calls bit-identical to their "
          f"plain versions, 0 weight copies, forward "
          f"{rec['serve_forward_ms']:.1f} ms with the checks inline ({at()})")
    out[c["name"]] = rec
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[train] phase {out['seconds']:.1f} s ({smi})")
    return out


# --------------------------------------------------------------------------
# phase 19: the dry run (`repro_torch.launch.dryrun`) held against real steps
# --------------------------------------------------------------------------

#: (arch, shape, variant) dry-run cells that fit the card, each also run
#: for real at full width and depth
DRY_FIT = [(XLSTM, "long_500k", "base"), (ZAMBA, "long_500k", "base"),
           (DANUBE, "long_500k", "base"), (XLSTM, "long_500k", "kvwq8")]
#: dry-run cells that do not fit; the first one also with ``mapping=``
DRY_OVER = [("yi-9b", "decode_32k", "base"), ("yi-9b", "prefill_32k", "base")]
CARD_GIB = 80
#: the real step's max_memory_allocated less its arguments' bytes against
#: the dry run's temp: within 10 % or 256 MiB
DRY_TEMP_RTOL, DRY_TEMP_ATOL = 0.10, 256 * 2**20
DRY_TIMED = 5
#: each base cell's diana plan at full depth, as phases 10, 12 and 14
#: lower theirs: (max_cout, plan histogram, launches per forward, raw
#: boundaries, the plan layers that hold them)
DRY_PLANNED = {
    XLSTM: (XLSTM_MAX_COUT, {"quant_matmul": 1, "split_ternary": 138},
            {"quant_matmul": 1, "split_ternary": 138}, XLSTM_RAW,
            XLSTM_NAMES),
    ZAMBA: (ZAMBA_MAX_COUT, ZAMBA_PLAN_HIST, ZAMBA_LONG_HIST, ZAMBA_RAW,
            ("units/0/mamba/in_proj@0", "rem/0/mamba/out_proj",
             "shared/attn/wq", "shared/ffn/gate", "shared/ffn/down")),
    DANUBE: (DANUBE_MAX_COUT, DANUBE_HIST, DANUBE_HIST, DANUBE_RAW, None),
}
PARTITION_TP = 8


def dry_real_step(torch, tag, cfg, shape, rec, seed, smi, device="cuda"):
    """The dry run's cell ``rec`` for real on the card: params drawn from
    ``seed`` (`dryrun.concrete_args`: bf16, `quantize_for_serve` for wq8),
    caches zeroed, one token at index seq - 1.  The step's FLOPs
    (``FlopCounterMode``) must equal the dry run's, the arguments' bytes
    too, and max_memory_allocated less the arguments' bytes lie within 10 %
    or 256 MiB of the dry run's temp (what was allocated before the step
    is printed beside it); then the warm step is timed with CUDA events
    (median of `DRY_TIMED`) against the roofline's memory term.  Returns
    (record, params)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    from repro_torch.roofline import analysis as RA
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    step, _ = D.cell_step(cfg, shape)
    args = D.concrete_args(cfg, shape, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem = rec["memory_analysis"]
    arg_bytes = D.tree_bytes(args)
    if arg_bytes != mem["argument_size_in_bytes"]:
        raise AssertionError(f"{tag}: arguments {arg_bytes} B on the card, "
                             f"{mem['argument_size_in_bytes']} B in the dry "
                             f"run")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        logits, _ = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flops = fc.get_total_flops()
    if flops != rec["cost_analysis"]["flops"]:
        raise AssertionError(f"{tag}: the step counted {flops} FLOPs, the "
                             f"dry run {rec['cost_analysis']['flops']}")
    temp, dry_temp = peak - before, mem["temp_size_in_bytes"]
    if abs(peak - arg_bytes - dry_temp) > max(DRY_TEMP_RTOL * dry_temp,
                                              DRY_TEMP_ATOL):
        raise AssertionError(f"{tag}: max_memory_allocated less the "
                             f"arguments {peak - arg_bytes} B on the card, "
                             f"temp {dry_temp} B in the dry run")
    if tuple(logits.shape) != (SP.SHAPES[shape]["batch"], cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: logits {tuple(logits.shape)} not "
                             f"finite or of the wrong shape")
    times = []
    for _ in range(DRY_TIMED):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        step(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ms = median(times)
    bound_ms = RA.hlo_bytes(cfg, shape) / RA.HBM_BW * 1e3
    print(f"[dryrun:{tag}] real step on the card: FLOPs {flops:.6e} = the "
          f"dry run's; arguments {arg_bytes / 2**30:.3f} GiB = the dry "
          f"run's; max_memory_allocated {peak / 2**30:.3f} GiB, less the "
          f"arguments {(peak - arg_bytes) / 2**30:.3f} GiB, less what was "
          f"allocated before the step {temp / 2**30:.3f} GiB against the "
          f"dry run's temp {dry_temp / 2**30:.3f} GiB; warm step "
          f"{ms:.3f} ms (median of {DRY_TIMED}, {min(times):.3f}-"
          f"{max(times):.3f}) against the roofline's memory term "
          f"{bound_ms:.3f} ms (hlo_bytes / 3.35 TB/s): {bound_ms / ms:.3f} "
          f"of it; params and caches drawn in {init_s:.1f} s ({smi})")
    out = {"flops": flops, "argument_bytes": arg_bytes, "peak_bytes": peak,
           "temp_bytes": temp, "dry_temp_bytes": dry_temp, "ms": ms,
           "min_ms": min(times), "max_ms": max(times),
           "memory_term_ms": bound_ms, "share_of_memory_term": bound_ms / ms}
    params = args[0]
    del args, logits
    return out, params


def dry_planned_step(torch, tag, cfg, params, shape, seed, smi,
                     device="cuda"):
    """The base cell served once more on diana at its `DRY_PLANNED`
    max_cout (`plan_dense`: the plan phases 10, 12 and 14 lower, at full
    depth): one decode step at the cell's cache length, every planned
    call held bit for bit against its plain version as it is made, the
    launches per forward the plan's, the logits finite."""
    from repro_torch.launch import specs as SP
    from repro_torch.models import _backend
    from repro_torch.models import transformer as T
    max_cout, plan_hist, hist, raws, names = DRY_PLANNED[cfg.name]
    t0 = time.perf_counter()
    _, plan, backend, kcfg = plan_dense(torch, f"dryrun:{tag}:diana", cfg,
                                        params, max_cout, plan_hist, raws,
                                        names=names)
    meta = SP.SHAPES[shape]
    B, S = meta["batch"], meta["seq"]
    caches = T.init_cache(kcfg, B, S, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    token = torch.randint(0, cfg.vocab, (B,), generator=gen, device=device)
    checked = {}
    reset_launches()
    with checking_matmuls(checked, dict(hist)), _backend.use(backend), \
            torch.no_grad():
        logits, _ = T.decode_step(params, kcfg, token, caches, S - 1)
    torch.cuda.synchronize()
    got = {k: v for k, v in kernel_launches().items() if v}
    if got != hist:
        raise AssertionError(f"{tag}: launches {got} per forward, the plan "
                             f"gives {hist}")
    if {k: n for k, (n, _) in checked.items() if n} != hist:
        raise AssertionError(f"{tag}: calls checked {checked}")
    check_no_weight_copies(tag)
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: planned logits not finite")
    cache_gib = sum(t.numel() * t.element_size()
                    for t in T.tree_leaves(caches)) / 2**30
    print(f"[dryrun:{tag}:diana] one decode step at cache {S} (kv "
          f"{kcfg.kv_cache_dtype}, {cache_gib:.2f} GiB): launches {got} per "
          f"forward, every call bit-identical to its plain version "
          + ", ".join(f"({n} {k}, largest M {m})"
                      for k, (n, m) in checked.items() if n)
          + f"; logits finite; weights copied per call 0 "
          f"({time.perf_counter() - t0:.1f} s with the lowering; {smi})")
    out = {"launches": got, "calls_checked": {k: n for k, (n, _) in
                                              checked.items()},
           "kv_cache_dtype": kcfg.kv_cache_dtype, "cache_gib": cache_gib}
    del plan, backend, caches, logits
    return out


def dry_partition(art_path):
    """The yi-9b diana artifact's per-layer counts planned over a
    tensor-parallel group of `PARTITION_TP` with the DIANA cost model
    (`core.partition.plan_network`), each plan checked.  Host only."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import partition as P
    from repro_torch.core.cost_models import DianaCostModel, LayerGeometry
    from repro_torch.models import transformer as T
    from repro_torch.runtime import lower
    t0 = time.perf_counter()
    cfg = cfgbase.get("yi-9b")
    plan = lower(json.loads(Path(art_path).read_text()),
                 params=T.param_shapes(cfg))
    geoms = [LayerGeometry(c_in=lp.c_in, c_out=lp.c_out)
             for lp in plan.layers]
    counts = [lp.counts for lp in plan.layers]
    plans = P.plan_network(DianaCostModel(), geoms, counts, PARTITION_TP)
    for p in plans:
        p.check(PARTITION_TP)
    for lp, p in list(zip(plan.layers, plans))[:4]:
        print(f"[dryrun:partition] {lp.name} ({lp.c_in} x {lp.c_out}, "
              f"counts {lp.counts}): " + ", ".join(
                  f"domain {s.domain} {s.devices} devices cols "
                  f"[{s.col_start}, {s.col_end})" for s in p.shards))
    devs = {}
    for p in plans:
        key = tuple(s.devices for s in p.shards)
        devs[key] = devs.get(key, 0) + 1
    print(f"[dryrun:partition] {len(plans)} layers of yi-9b's diana "
          f"artifact over tp {PARTITION_TP}, every plan checked (tiling, "
          f"device count); devices per (digital, aimc): {devs} "
          f"({time.perf_counter() - t0:.1f} s, host only)")
    return {"layers": len(plans), "devices": {str(k): v for k, v in
                                              devs.items()}}


def phase_dryrun(torch, seed, smi, device="cuda"):
    """Phase 19 (module docstring): (a) the dry run on the card's (1, 1)
    mesh of `DRY_FIT` and `DRY_OVER` (yi-9b x decode_32k also with
    ``mapping=`` yi-9b's diana artifact), the roofline table of their
    records at the H100 constants; (b) each fitting cell run for real
    (`dry_real_step`); (c) each base cell planned on diana at that size
    (`dry_planned_step`); (d) the partition plan (`dry_partition`).
    Returns the phase's record.  ``device`` "cpu" runs a rehearsal on the
    CPU's (1, 1) mesh, with the configs reduced and the CUDA-only calls
    stubbed by the caller."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import single_gpu_mesh, smoke_mesh
    from repro_torch.roofline import analysis as RA
    t_phase = time.perf_counter()
    mesh = single_gpu_mesh() if device == "cuda" else smoke_mesh()
    out_dir = ROOT / "build" / "chip_smoke" / "dryrun_torch"
    art = ROOT / "build" / "chip_smoke" / "yi-9b_diana.json"
    out, recs = {}, []
    for arch, shape, variant in DRY_OVER:
        rec = D.run_cell(arch, shape, mesh, out_dir, variant=variant,
                         mapping=(str(art) if shape == "decode_32k"
                                  else None))
        if "error" in rec.get("mapping_plan", {}):
            raise AssertionError(f"dryrun: {art} does not lower onto {arch}")
        need = rec["memory_analysis"]["peak_bytes"] / 2**30
        if need <= CARD_GIB:
            raise AssertionError(f"dryrun {arch} x {shape}: {need:.1f} GiB "
                                 f"fits {CARD_GIB}")
        print(f"[dryrun] {arch} x {shape}: needs {need:.1f} GiB against the "
              f"card's {CARD_GIB} (arguments "
              f"{rec['memory_analysis']['argument_size_in_bytes'] / 2**30:.1f}"
              f" GiB); record {json.dumps(rec)[:400]}")
        out[f"{arch}:{shape}"] = rec
        recs.append(rec)
    for arch, shape, variant in DRY_FIT:
        tag = f"{arch}:{shape}:{variant}"
        cfg = D.cell_config(arch, variant)
        rec = D.run_cell(arch, shape, mesh, out_dir, variant=variant)
        need = rec["memory_analysis"]["peak_bytes"] / 2**30
        if need > CARD_GIB:
            raise AssertionError(f"dryrun {tag}: {need:.1f} GiB")
        print(f"[dryrun:{tag}] record {json.dumps(rec)}")
        real, params = dry_real_step(torch, tag, cfg, shape, rec, seed, smi,
                                     device)
        gc.collect()
        torch.cuda.empty_cache()
        if variant == "base":
            real["planned"] = dry_planned_step(torch, tag, cfg, params,
                                               shape, seed, smi, device)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out[tag] = {"record": rec, "real": real}
        recs.append(rec)
    print("[dryrun] roofline of the records at the H100 SXM constants "
          f"({RA.PEAK_BF16:.3g} FLOP/s bf16, {RA.HBM_BW:.3g} B/s, "
          f"{RA.LINK_BW:.3g} B/s; this card: {smi}):")
    for line in RA.markdown_table([RA.analyze_cell(r) for r in recs]) \
            .splitlines():
        print(f"[dryrun] {line}")
    out["partition"] = dry_partition(art)
    torch.distributed.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[dryrun] phase {out['seconds']:.1f} s ({smi})")
    return out



# ------------------------------------------------------------------ phase 21
#: the partitioned dry run's cells: (arch, shape, multi-pod)
PART_CELLS = [("yi-9b", "decode_32k", False), ("yi-9b", "decode_32k", True),
              ("deepseek-v2-lite-16b", "prefill_32k", False),
              (ZAMBA, "long_500k", False)]
PART_TIMEOUT = 300


#: where phase 21's subprocesses write their records
PART_OUT = ROOT / "build" / "chip_smoke" / "dryrun_production"


def start_partitioned(device="cuda"):
    """Phase 21's subprocesses (module docstring), one per `PART_CELLS`
    cell of ``python -m repro_torch.launch.dryrun --mesh production
    --device DEVICE``, all started now; `phase_partitioned` reads them.
    Returns (the processes, their start time)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    PART_OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for arch, shape, mp in PART_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
               "production", "--device", device, "--arch", arch, "--shape",
               shape, "--out", str(PART_OUT)] + (["--multi-pod"] if mp
                                                 else [])
        # each log to a file: a pipe nobody reads until phase 21 would
        # fill and stall the trace
        with open(PART_OUT / f"{arch}__{shape}__{'mp' if mp else 'sp'}.log",
                  "w") as log:
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs, time.perf_counter()


def phase_partitioned(torch, seed, smi, single, started):
    """Phase 21 (module docstring): the records of ``started`` (from
    `start_partitioned`), each against its specs-only record, zamba2's
    FLOPs against ``single`` (phase 19's (1, 1) record of the cell), and
    the roofline table of the records.  Returns the phase's record."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import production_shape
    from repro_torch.roofline import analysis as RA
    t_phase = time.perf_counter()
    procs, t_start = started
    out_dir = PART_OUT
    try:
        for p in procs:
            p.wait(timeout=max(
                1.0, PART_TIMEOUT - (time.perf_counter() - t_start)))
        logs = [(out_dir / f"{arch}__{shape}__{'mp' if mp else 'sp'}.log")
                .read_text() for arch, shape, mp in PART_CELLS]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"[partitioned] subprocesses done {time.perf_counter() - t_start:.1f}"
          f" s after their start ({t_phase - t_start:.1f} s of it beside "
          f"phases 19 and 20)")
    result, recs = {}, []
    for (arch, shape, mp), p, log in zip(PART_CELLS, procs, logs):
        tag = f"{arch}:{shape}:{'mp' if mp else 'sp'}"
        if p.returncode != 0:
            raise AssertionError(f"partitioned {tag}: exit {p.returncode}: "
                                 f"{log[-2000:]}")
        path = out_dir / f"{arch}__{shape}__{'mp' if mp else 'sp'}.json"
        rec = json.loads(path.read_text())
        mem = rec["memory_analysis"]
        if rec["status"] != "ok" or rec["n_devices"] != (512 if mp else 256):
            raise AssertionError(f"partitioned {tag}: {rec['status']} on "
                                 f"{rec.get('n_devices')} devices")
        if None in (rec["cost_analysis"]["flops"], mem["temp_size_in_bytes"],
                    mem["peak_bytes"]) or not rec["collectives"]:
            raise AssertionError(f"partitioned {tag}: a null count")
        spec = D.run_cell(arch, shape, production_shape(multi_pod=mp),
                          ROOT / "build" / "chip_smoke" / "dryrun_specs")
        want = spec["memory_analysis"]["argument_size_in_bytes"]
        if mem["argument_size_in_bytes"] != want:
            raise AssertionError(
                f"partitioned {tag}: argument bytes "
                f"{mem['argument_size_in_bytes']} against the specs' {want}")
        counts = {op: s["top"] for op, s in
                  rec["collectives"]["counts"].items()}
        sent = {op: s["top"] for op, s in rec["collectives"]["bytes"].items()}
        print(f"[partitioned:{tag}] {rec['n_devices']} devices, trace "
              f"{rec['trace_s']:.1f} s; per device: flops "
              f"{rec['cost_analysis']['flops']:.4e}, args "
              f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB (= specs), "
              f"temp {mem['temp_size_in_bytes'] / 2**30:.3f} GiB, peak "
              f"{mem['peak_bytes'] / 2**30:.3f} GiB; collectives {counts}, "
              f"bytes {sent}")
        key = f"{arch}:{shape}:base"
        if key in single:
            whole = single[key]["record"]["cost_analysis"]["flops"]
            per = rec["cost_analysis"]["flops"]
            if not per < whole <= per * rec["n_devices"]:
                raise AssertionError(
                    f"partitioned {tag}: per-device flops {per:.4e} against "
                    f"the (1, 1) record's {whole:.4e}")
            print(f"[partitioned:{tag}] per-device flops {per:.4e} x "
                  f"{rec['n_devices']} = {per * rec['n_devices']:.4e} >= "
                  f"the (1, 1) record's {whole:.4e} (phase 19)")
        result[tag] = rec
        recs.append(rec)
    print("[partitioned] roofline of the records at the H100 SXM constants "
          f"({RA.PEAK_BF16:.3g} FLOP/s bf16, {RA.HBM_BW:.3g} B/s, "
          f"{RA.LINK_BW:.3g} B/s link; this card: {smi}):")
    for line in RA.markdown_table([RA.analyze_cell(r) for r in recs]) \
            .splitlines():
        print(f"[partitioned] {line}")
    result["seconds"] = time.perf_counter() - t_phase
    print(f"[partitioned] phase {result['seconds']:.1f} s after phase 20 "
          f"({smi})")
    return result


# ------------------------------------------------------------------ phase 20
#: the deploy op (`ops.odimo_deployed_dense`) at yi-9b's widths and the
#: served M (decode, a paged chunk, the prefill), each at `PAPER_KINDS`:
#: a seeded random assignment with about half the columns bf16 and an int8
#: count off the 128-column block, all int8, all bf16; the random one is
#: timed
PAPER_KN = [(4096, 4096), (4096, 11008)]
PAPER_MS = (DECODE_M, REQUESTS * CHUNK, PREFILL_M)
PAPER_KINDS = ("random", "int8", "bf16")
#: the experiments script (``examples/torch_paper_experiments.py``) on
#: full-geometry ResNet20, the medium preset's model, at a cut step count:
#: one baseline and one lambda per objective, then its Table I
PAPER_PRESET = dict(pretrain=20, search=30, finetune=20, batch=48, evalb=2,
                    lambdas=(1e-6,), models=("resnet20",))
PAPER_BASELINE = "min_cost_lat"
#: the JAX script's record keys, by kind (``benchmarks/
#: paper_experiments.py``)
PAPER_RECORD_KEYS = {
    "baseline": {"kind", "model", "name", "accuracy", "latency", "energy",
                 "aimc_ch", "wall_s"},
    "odimo_diana": {"kind", "model", "objective", "lam", "accuracy",
                    "latency", "energy", "aimc_ch", "counts", "wall_s"},
    "table1": {"kind", "model", "objective", "lam", "acc", "lat_ms",
               "energy", "dig_util", "aimc_util", "aimc_ch"},
}


def load_example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def deploy_assignment(n, kind, rng):
    """All int8, all bf16, or a random half bf16 whose int8 count (the
    raw boundary) is off the 128-column block."""
    import numpy as np
    if kind in ("int8", "bf16"):
        return np.full(n, int(kind == "bf16"), np.int64)
    a = np.ones(n, np.int64)
    a[rng.choice(n, n // 2 + 37, replace=False)] = 0
    return a


def check_deploy(torch, tag, x, w, assign, wls, xls, got):
    """One deployed call against the plain version in the ORIGINAL column
    order: the columns the aligned boundary runs int8 bit for bit against
    `quant_matmul_plain` of the codes, the others within `bf16_error_bound`
    of the bf16 product in float64.  Returns (int8 columns, max bf16
    error / bound)."""
    import numpy as np
    from repro_torch.core import quant
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_precision import bf16_error_bound
    n = w.shape[1]
    perm = np.argsort(assign, kind="stable")
    b_al = aligned(int((assign == 0).sum()), n)
    int8 = torch.from_numpy(np.argsort(perm) < b_al).to(got.device)
    levels = quant.qlevels(8)
    sx = (torch.exp(xls) / levels).reshape(1)
    sw = (torch.exp(wls) / levels).reshape(1).expand(n)
    lo = quant_matmul_plain(quant.quantize_int(x, xls, 8),
                            quant.quantize_int(w, wls, 8), sx, sw)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    hi = (xb.double() @ wb.double()).float()
    torch.cuda.synchronize()
    if tuple(got.shape) != (x.shape[0], n) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: output {tuple(got.shape)} not finite "
                             f"or of the wrong shape")
    if not torch.equal(got[:, int8], lo[:, int8]):
        raise AssertionError(f"{tag}: int8 columns differ from the plain "
                             f"version by "
                             f"{float((got - lo)[:, int8].abs().max())}")
    ratio = 0.0
    if not bool(int8.all()):
        err = (got.double() - hi.double()).abs()[:, ~int8]
        bound = bf16_error_bound(xb, wb, hi)[:, ~int8]
        if not bool((err <= bound).all()):
            raise AssertionError(f"{tag}: bf16 columns outside the "
                                 f"summation bound")
        ratio = float((err / bound.clamp_min(1e-300)).max())
    return int(int8.sum()), ratio


def deploy_times(torch, m, k, n, x, w, assign, wls, xls, call):
    """Times of one deployed call at (M, K, N) in ROUNDS interleaved rounds
    of CUDA-graph replays: the op's device half (`ops.deploy_dense`, which
    quantizes x and the permuted weight per call; graph "deploy_ms"), its
    split_precision kernel on the operands it made (``call``, "ms"), and
    the library's two calls on those operands (``torch._int_mm`` + the
    epilogue on the int8 columns, row-major and K-major, and a bf16
    ``torch.matmul`` on the rest); the plain version and the whole op
    (host sort included) eagerly.  Each timed call reads the next of
    several weight copies, over twice the L2 in all."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.split_precision import split_precision_plain
    (xb, x_q, sx, w_b, w_q, sw, boundary), kw, _ = call
    plan = ops.deploy_plan(assign, x.device)
    b_al = aligned(boundary, n)
    wbytes = k * b_al + 2 * k * (n - b_al)
    lo = w_q[:, :b_al].contiguous()
    weights = (w_b, w_q, lo, w_b[:, b_al:].contiguous(),
               lo.t().contiguous().t())
    copies = -(-2 * L2_BYTES // wbytes)
    ring = itertools.cycle([weights] + [tuple(t.clone() for t in weights)
                                        for _ in range(copies - 1)])
    w_copies = -(-2 * L2_BYTES // (4 * k * n))
    w_ring = itertools.cycle([w] + [w.clone() for _ in range(w_copies - 1)])
    x_lib = (torch.cat([x_q, x_q.new_zeros(32 - m, k)]) if m <= 16
             else x_q)

    def lib(t, i):
        lo = torch._int_mm(x_lib, t[i])[:m].to(torch.float32) * sx * \
            sw[None, :b_al]
        return lo, torch.matmul(xb, t[3]).to(torch.float32)
    iters = 20
    rounds = graph_rounds(
        {"deploy_ms": lambda: ops.deploy_dense(x, next(w_ring), plan, wls,
                                               xls),
         "ms": lambda: ops.split_precision_op(
             xb, x_q, sx, *next(ring)[:2], sw, boundary, **kw),
         "library_row_ms": lambda: lib(next(ring), 2),
         "library_col_ms": lambda: lib(next(ring), 4)},
        max(iters, copies, w_copies))
    rec = {"plain_ms": cuda_ms(lambda: split_precision_plain(
               xb, x_q, sx, *next(ring)[:2], sw, b_al), 5),
           "eager_ms": cuda_ms(lambda: ops.odimo_deployed_dense(
               x, next(w_ring), assign, wls, xls), iters)}
    for key, xs in rounds.items():
        spread(rec, key, xs)
    lib_key = min(("library_row_ms", "library_col_ms"),
                  key=lambda key: rec[key])
    spread(rec, "library_ms", rounds[lib_key])
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        m, k, n, wbytes, int8_cols=b_al, bf16_cols=n - b_al)
    # the deploy's own inputs and output: float32 x, w and y, two steps
    t_bytes = (4 * m * k + 4 * k * n + 4 * m * n + 8) / HBM_BYTES_PER_S * 1e3
    rec["deploy_bound_ms"] = max(t_bytes, rec["bound_ms"])
    return rec


def phase_paper(torch, seed, smi, device="cuda"):
    """Phase 20 (module docstring): the paper's deployment and experiments
    on the card.  (a) `ops.odimo_deployed_dense` at `PAPER_KN` x
    `PAPER_MS` x `PAPER_KINDS`: each call with the counts reset just
    before and read just after (one split_precision launch, no weight
    copy), held against the plain version in the original column order
    (`check_deploy`), the random assignment timed (`deploy_times`); (b)
    ``examples/torch_quickstart.py --fast`` on the card (prints
    ``quickstart OK``; one split_precision launch, its head deploy); (c)
    the experiments script on full-geometry ResNet20 at `PAPER_PRESET`:
    `PAPER_BASELINE` and one lambda per objective on diana, then its
    Table I: JAX's record keys, the baseline's latency and energy equal to
    the port's cost model on its counts, each Table I row's digital +
    AIMC utilization at least 1.  Returns the phase's record."""
    import contextlib
    import io
    import numpy as np
    from repro_torch.api import Platform, cnn_handle
    from repro_torch.core import losses, quant
    from repro_torch.core.baselines import counts_from_assignments
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = {"deploy": {}}
    for k, n in PAPER_KN:
        w = torch.randn((k, n), generator=gen, device=device) * 0.02
        wls = quant.init_log_scale(w)
        for m in PAPER_MS:
            x = torch.randn((m, k), generator=gen, device=device)
            xls = quant.init_log_scale(x)
            for kind in PAPER_KINDS:
                tag = f"paper:deploy:M{m}:K{k}:N{n}:{kind}"
                assign = deploy_assignment(n, kind, rng)
                calls = []
                reset_launches()
                with recording_split_precision(calls, 1):
                    got = ops.odimo_deployed_dense(x, w, assign, wls, xls)
                torch.cuda.synchronize()
                launches = {kk: v for kk, v in kernel_launches().items()
                            if v}
                if launches != {"split_precision": 1}:
                    raise AssertionError(f"{tag}: launches {launches}")
                check_no_weight_copies(tag)
                int8_cols, ratio = check_deploy(torch, tag, x, w, assign,
                                                wls, xls, got)
                rec = {"launches": launches, "boundary":
                       int((assign == 0).sum()), "int8_columns": int8_cols,
                       "bf16_err_over_bound": ratio}
                line = (f"[{tag}] raw boundary {rec['boundary']}, "
                        f"{int8_cols} of {n} columns int8 bit-identical to "
                        f"the plain version, the rest within the bound "
                        f"(max err / bound {ratio:.3g}); original column "
                        f"order; launches split_precision 1, 0 weight "
                        f"copies")
                if kind == "random":
                    rec.update(deploy_times(torch, m, k, n, x, w, assign,
                                            wls, xls, calls[0]))
                    line += (
                        f"; kernel {rec['ms']:.4f} ms ({rec['min_ms']:.4f}-"
                        f"{rec['max_ms']:.4f}), deploy (device half: "
                        f"quantize x and w, permute, kernel, unpermute) "
                        f"{rec['deploy_ms']:.4f} ms, whole op eager "
                        f"{rec['eager_ms']:.4f} ms, plain "
                        f"{rec['plain_ms']:.4f} ms, two calls "
                        f"{rec['library_ms']:.4f} ms (int8 weight row-major "
                        f"{rec['library_row_ms']:.4f}, K-major "
                        f"{rec['library_col_ms']:.4f}), bound "
                        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                        f"deploy bound {rec['deploy_bound_ms']:.4f} ms; "
                        f"{smi}")
                print(line)
                out["deploy"][tag] = rec
                del got, calls
            del x
        del w
        gc.collect()
        torch.cuda.empty_cache()
    deploy_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    qs = load_example("torch_quickstart")
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        qs.main(["--fast", "--device", device, "--artifact",
                 str(ROOT / "build" / "chip_smoke" /
                     "torch_quickstart_mapping.json")])
    torch.cuda.synchronize()
    launches = {kk: v for kk, v in kernel_launches().items() if v}
    for line in buf.getvalue().splitlines():
        print(f"[paper:quickstart] {line}")
    if not buf.getvalue().rstrip().endswith("quickstart OK"):
        raise AssertionError("paper:quickstart: no 'quickstart OK'")
    if launches != {"split_precision": 1}:
        raise AssertionError(f"paper:quickstart: launches {launches}")
    out["quickstart"] = {"launches": launches,
                         "seconds": time.perf_counter() - t0}
    print(f"[paper:quickstart] launches split_precision 1 (the head's "
          f"deploy); {out['quickstart']['seconds']:.1f} s")

    t0 = time.perf_counter()
    drv = load_example("torch_paper_experiments")
    drv.PRESETS["chip_smoke"] = dict(PAPER_PRESET)
    recs, stages = [], []
    model = PAPER_PRESET["models"][0]
    drv.run_baselines(model, "chip_smoke", "diana", recs,
                      names=(PAPER_BASELINE,), device=device, stages=stages)
    for obj in ("latency", "energy"):
        drv.run_odimo_sweep(model, "chip_smoke", "diana", obj, recs,
                            tag="diana", device=device, stages=stages)
    drv.table1(recs)
    for rec in recs:
        if set(rec) != PAPER_RECORD_KEYS[rec["kind"]]:
            raise AssertionError(f"paper:experiments: {rec['kind']} record "
                                 f"keys {sorted(rec)}")
    base = recs[0]
    cm = Platform.get("diana").cost_model()
    geoms = cnn_handle(drv.MODEL_CFGS[model]).geometries()
    counts = counts_from_assignments(
        drv.baseline_assignments(model, "diana", (PAPER_BASELINE,))
        [PAPER_BASELINE], 2)
    lat = float(losses.exact_latency(cm, geoms, counts))
    en = float(losses.exact_energy(cm, geoms, counts))
    if not (np.isclose(base["latency"], lat, rtol=1e-6, atol=0) and
            np.isclose(base["energy"], en, rtol=1e-6, atol=0)):
        raise AssertionError(f"paper:experiments: baseline latency / energy "
                             f"{base['latency']} / {base['energy']} against "
                             f"the cost model's {lat} / {en}")
    rows = [r for r in recs if r["kind"] == "table1"]
    if len(rows) != 2 or any(r["dig_util"] + r["aimc_util"] < 1.0
                             for r in rows):
        raise AssertionError(f"paper:experiments: Table I rows {rows}")
    for rec, st in zip(recs, stages):
        stages = " ".join(f"{name} {s['steps']} x {s['ms_per_step']:.1f} ms"
                          for name, s in st["stages"].items()
                          if "ms_per_step" in s)
        print(f"[paper:experiments] {json.dumps(rec)[:300]}; stages {stages}")
    for row in rows:
        print(f"[paper:experiments] {json.dumps(row)}")
    out["experiments"] = {"records": recs, "stages": stages,
                     "seconds": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[paper] phase {out['seconds']:.1f} s (deploy {deploy_s:.1f} s, "
          f"quickstart {out['quickstart']['seconds']:.1f} s, experiments "
          f"{out['experiments']['seconds']:.1f} s; {smi})")
    return out

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check needs one",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all(tuple(KERNELS))
    for kname, log in sorted(_build.PTXAS_REPORT.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kname}: {line.strip()}")
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    print("kernels: " + " ".join(KERNELS))
    phase_sass(torch)

    def mark(what):
        print(f"[phase] {what} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    mark("build")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    worst = phase_kernels(torch, gen)
    mark("kernel checks")
    print(f"[times] bounds from the H100 SXM data sheet (3.35 TB/s, 1979 "
          f"int8 TOP/s and 989 bf16 TFLOP/s dense, at 700 W); this card: "
          f"{smi}")
    entry_launches = phase_packed_entry(torch, gen)
    times = phase_times(torch, gen)
    sweep = phase_split_sweep(torch, gen)
    flash_rec = phase_flash_times(torch, gen)
    zamba_flash = phase_flash_times(torch, gen, ZAMBA_FLASH_HEADS,
                                    ZAMBA_LONG_SQ, ZAMBA_LONG_SQ)
    danube_sq = DANUBE_LONG["prompts"][0]
    danube_flash = phase_flash_times(torch, gen, DANUBE_LONG_HEADS,
                                     danube_sq, DANUBE_LONG["max_len"],
                                     window=DANUBE_WINDOW)
    danube_cases = phase_danube_flash_times(torch, gen)
    deepseek_flash = phase_flash_times(
        torch, gen, DEEPSEEK_FLASH_HEADS[1], DEEPSEEK_LONG["prompts"][0],
        DEEPSEEK_LONG["max_len"], dv=DEEPSEEK_DIMS[1])
    mark("kernel times")
    for kernel in KERNELS:
        path = LAUNCH_PATH[kernel]
        if path not in PATHS:
            continue
        for phase in ("decode", "prefill"):
            print_mix(f"per {phase} forward on {path}", kernel,
                      forward_mix(times, path, kernel, phase))
    for kernel in ("quant_matmul", "split_ternary"):
        for rows in CHUNK_MS:
            print_mix(f"per chunk forward (M {rows}) on diana", kernel,
                      forward_mix(times, "diana", kernel, "prefill", rows))
    zamba_mix = {}
    for kernel in ZAMBA_HIST:
        for what, phase, rows in (("decode", "decode", PREFILL_M),
                                  (f"chunk (M {REQUESTS * CHUNK})",
                                   "prefill", REQUESTS * CHUNK),
                                  (f"prefill (M {PREFILL_M})", "prefill",
                                   PREFILL_M)):
            mix = forward_mix(times, None, kernel, phase, rows,
                              layers=zamba_layers(rows))
            zamba_mix[f"{kernel} {what}"] = mix
            print_mix(f"per {what} forward of {ZAMBA} on diana", kernel, mix)
    xlstm_mix = {}
    for kernel in XLSTM_HIST:
        for what, phase, rows in (("decode", "decode", PREFILL_M),
                                  (f"chunk (M {REQUESTS * CHUNK})",
                                   "prefill", REQUESTS * CHUNK)):
            mix = forward_mix(times, None, kernel, phase, rows,
                              layers=zamba_layers(rows, XLSTM_LAYERS,
                                                  XLSTM_HEAD))
            xlstm_mix[f"{kernel} {what}"] = mix
            print_mix(f"per {what} forward of {XLSTM} on diana", kernel, mix)
    # the long leg's dense prefill makes one flash call per shared-block use
    uses = ZAMBA_USES
    zamba_mix["flash_attention long prefill"] = {
        key: zamba_flash[key] * uses for key in
        ("ms", "min_ms", "max_ms", "plain_ms", "library_ms",
         "library_min_ms", "library_max_ms", "bound_ms")}
    zamba_mix["flash_attention long prefill"]["bound_by"] = \
        zamba_flash["bound_by"]
    print_mix(f"per long prefill forward of {ZAMBA} ({uses} uses)",
              "flash_attention", zamba_mix["flash_attention long prefill"])
    # h2o's long prefill makes one windowed flash call per layer
    danube_mix = {key: danube_flash[key] * 24 for key in
                  ("ms", "min_ms", "max_ms", "plain_ms", "library_ms",
                   "library_min_ms", "library_max_ms", "bound_ms")}
    danube_mix["bound_by"] = danube_flash["bound_by"]
    print_mix(f"per long prefill forward of {DANUBE} (24 layers, window "
              f"{DANUBE_WINDOW}; sdpa masked, kernel "
              f"{danube_flash['library_kernel'][:60]})", "flash_attention",
              danube_mix)

    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    cfg = cfgbase.get("yi-9b")
    dev = torch.device("cuda")
    sgen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = T.init_lm(sgen, cfg)
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"params {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
          f"(init {time.perf_counter() - t0:.1f} s)")
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=sgen, device=dev)
    launches, serving = {"entry point": entry_launches}, {}
    for path in PATHS:
        launches[path], serving[path] = phase_serving(
            torch, path, cfg, params, prompts)
        mark(f"serving {path}")
    del prompts
    long_prompts = torch.randint(0, cfg.vocab, (REQUESTS, LONG_PROMPT),
                                 generator=sgen, device=dev)
    launches["diana_long"], serving["diana_long"], long_err = phase_long(
        torch, cfg, params, long_prompts)
    mark("serving diana_long")
    worst["flash_attention"] = max(worst["flash_attention"], long_err)
    engine_recs, refs = phase_engine(torch, cfg, params, args.seed, smi)
    serving.update(engine_recs)
    mark("engine")
    serving.update(phase_paged(torch, cfg, params, args.seed, smi, refs,
                               engine_recs))
    del refs
    mark("paged engine")
    serving["planset"] = phase_planset(torch, cfg, params, args.seed, smi)
    mark("planset")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    serving["zamba"] = phase_zamba(torch, args.seed, smi)
    serving["zamba"]["kernel_mix"] = zamba_mix
    mark("zamba")
    serving.update(phase_cnn(torch, args.seed, smi))
    mark("cnn")
    serving["search"] = phase_search(torch, args.seed, smi)
    mark("search")
    serving["danube"] = phase_danube(torch, args.seed, smi)
    serving["danube"]["flash_long_call"] = danube_flash
    serving["danube"]["flash_long_prefill"] = danube_mix
    serving["danube"]["flash_cases"] = danube_cases
    mark("danube")
    for key in DENSE_FIXED:
        serving[key] = phase_dense_fixed(torch, key, args.seed, smi)
        mark(key)
    serving["deepseek"] = phase_deepseek(torch, args.seed, smi)
    layers = cfgbase.get(DEEPSEEK).n_layers
    serving["deepseek"]["flash_long_call"] = deepseek_flash
    serving["deepseek"]["flash_long_prefill"] = {
        key: deepseek_flash[key] * layers for key in
        ("ms", "min_ms", "max_ms", "plain_ms", "library_ms",
         "library_min_ms", "library_max_ms", "bound_ms")}
    print_mix(f"per long prefill forward of {DEEPSEEK} ({layers} layers, "
              f"D 192 / Dv 128; sdpa kernel "
              f"{deepseek_flash['library_kernel'][:60]})", "flash_attention",
              dict(serving["deepseek"]["flash_long_prefill"],
                   bound_by=deepseek_flash["bound_by"]))
    mark("deepseek")
    serving["xlstm"] = phase_xlstm(torch, args.seed, smi)
    serving["xlstm"]["kernel_mix"] = xlstm_mix
    mark("xlstm")
    serving["arctic"] = phase_arctic(torch, args.seed, smi)
    mark("arctic")
    for key in FRONTEND:
        serving[key] = phase_frontend(torch, key, args.seed, smi)
        mark(key)
    serving["train"] = phase_train(torch, args.seed, smi)
    mark("train")
    # phase 21's host-only traces run beside phases 19 and 20
    started = start_partitioned()
    try:
        serving["dryrun"] = phase_dryrun(torch, args.seed, smi)
        mark("dryrun")
        serving["paper"] = phase_paper(torch, args.seed, smi)
        mark("paper")
    except BaseException:
        for p in started[0]:
            p.kill()
            p.wait()
        raise
    serving["partitioned"] = phase_partitioned(torch, args.seed, smi,
                                               serving["dryrun"], started)
    mark("partitioned")
    # one prefill forward of diana_long makes one flash call per layer
    flash_mix = {key: flash_rec[key] * cfg.n_layers
                 for key in ("ms", "min_ms", "max_ms", "plain_ms",
                             "library_ms", "library_min_ms",
                             "library_max_ms", "bound_ms")}
    flash_mix["bound_by"] = flash_rec["bound_by"]
    print_mix("per prefill forward on diana_long", "flash_attention",
              flash_mix)
    long_mix = {}
    for kernel in ("quant_matmul", "split_ternary"):
        long_mix[kernel] = forward_mix(times, "diana", kernel, "prefill",
                                       LONG_M)
        print_mix("per prefill forward on diana_long", kernel,
                  long_mix[kernel])
    serving["diana_long"]["prefill_forward_mix"] = dict(
        long_mix, flash_attention=flash_mix)
    packed_mix = entry_mix(times)
    print_mix("over the entry-point run", "ternary_packed", packed_mix)
    for m in M_SHAPES:
        print_mix(f"over the entry-point run's M {m} calls",
                  "ternary_packed", entry_mix(times, m))

    records = []
    for kernel, (source, replaces, _) in KERNELS.items():
        path = LAUNCH_PATH[kernel]
        if kernel == "flash_attention":
            mix = flash_mix
        elif kernel == "ternary_packed":
            mix = packed_mix
        else:
            mix = forward_mix(times, path, kernel, "prefill")
        records.append({"name": kernel, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[path][kernel],
                        "max_abs_err": worst[kernel], "ms": mix["ms"],
                        "plain_ms": mix["plain_ms"],
                        "bound_ms": mix["bound_ms"],
                        "bound_by": mix["bound_by"],
                        "library_ms": mix["library_ms"]})
    result = {"kernels": records, "serving": serving,
              "split_sweep_ms": sweep,
              "seconds": time.perf_counter() - t_start}
    out = ROOT / "build" / "chip_smoke" / "result.json"
    out.write_text(json.dumps(result, indent=1))
    print(f"[done] {result['seconds']:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
