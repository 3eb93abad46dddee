#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: build the kernels, hold each
against its plain version at the serving shapes, then serve command-r-35b
at full width (depth cut to 4 layers) through the engine, at the policy's
defaults, activation-coded, speculatively and behind the async front end;
command-r-35b (2 layers) under the bit-exact PDPU plan; and
qwen3-moe-235b at full width (4 of 94 layers) at the defaults; then train
minitron-8b at full width (4 of 32 layers) under paper_mixed fused; then
serve gemma3-4b (12 of 34 layers) and command-r-plus-104b (2 of 64) at
full width, command-r-35b over the dense KV cache, and the serving
example; then train qwen3-moe-235b (1 of 94 layers) and deepseek-moe-16b
(4 of 28) at full width, and run the remaining example twins; then serve
mamba2-1.3b at full width and all 48 layers, and the jamba-1.5-large and
mamba2 smoke engines on the card against the CPU; then paligemma-3b (all
18 layers: its image-prefix prefill and decode, its text-only engine) and
hubert-xlarge (all 48 layers: a forward and QAT) at full width, and QAT
of mamba2-1.3b at full width and depth; then K3 / K7 and command-r's
engine on pages of 256-1024 tokens, mamba2-1.3b's posit-compressed
cross-pod training step on a (2, 2, 1) mesh of the card, and a sweep of
the autotune cache; and each serving configuration's decode steps as CUDA
graph replays against eager dispatch.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):
  1. device: name, count, `nvidia-smi` name and power limit;
  2. build: nvcc for sm_90a of every source in src/repro_torch/csrc/, with
     the -Xptxas -v register / shared-memory report;
  3. kernels: K1-K7 against their plain versions at the main path's shapes
     (K1 bitwise on every container pattern of P(16,2), P(13,2), P(8,2)
     (each on its compile-time variant) and P(16,1) (the run-time one), and
     timed beside its bytes bound at [8192, 22528], [12288, 33792],
     [4096, 256000] and a dense KV cache layer's [4, 256, 1024] int8 rows;
     the float GEMV (the float weight path at decode rows) within
     `sum_bound(x, w, None, fmt)` at every projection shape of a layer at
     M 4 with bf16 activations and over the tied [256000, 8192] head's
     transpose, a limit two planted faults (bf16 weights, one K split
     left out) must fail, bitwise equal on a second call, timed beside K1
     + torch.matmul and torch.matmul on pre-decoded f32;
     K2 bitwise at the tied head's [256000, 8192] into
     P(16,2) and P(13,2), each on its compile-time variant, and on every
     rounding boundary between adjacent codes and its f32 neighbours for
     P(16,2), P(13,2) and P(8,2); K3 within 2e-5, also at lengths 1, 32, 33, 256 and
     1100 that end on and span its 2-page key splits, over int8, bf16 and
     f32 pages, with K7's rows bitwise K3 there, and its grid wider than
     B x Hkv; K4 equal tokens, or a score within
     1e-5 of the largest |logit| where the plain top two are that close,
     and its first 4 rows' tokens equal over 16 rows and over 4, and the
     sampler's temperature division bitwise the host's; the same over
     qwen3's [D, V] head at 16 rows; both heads timed at 4 and 16 rows
     with the two passes apart, every launch on the p16_2 variant; K5 pages
     bitwise and attention within 2e-5 (f32, `tc_f32`) or one bf16 ulp
     (bf16, `tc`) at both span branches and at 64 / 4 heads (G = 16) over
     P(8,2) and bf16 pages, each case on the variant its dtype picks;
     `tc_f32` at the serving shape, the long span and gemma3-4b's chunk
     (head_dim 256, window 1024 and global), each A/B against the SIMT
     kernel in the same call and beside masked SDPA in f32 and the exact
     form's bound, and an exactness probe whose rows hang on one bf16
     term of q * scale, k, v or p (chunk and f32-pool history); K6
     within 16 u sqrt(K) ||a_i . b_j||_2 at every
     projection shape of a layer at M 4 (split-K GEMV) and M 256 (split-bf16
     tensor cores), a limit two planted
     faults must fail, bitwise equal on a second call, timed per shape
     and for the layer beside torch.matmul on decoded f32 with both the
     f32 and the tensor-core bound at M 256; K7 within
     2e-5, each of its rows
     bitwise K3 at the row's own length, T = 1 bitwise K3, t_block 1/2/4
     bitwise equal; K8's compile-time variant bitwise at M 4, K 8192, N
     1024, B also transposed, ragged with special codes, at M 64, and over
     the tied head (N_out 256000, B a transposed view, 256 columns
     checked), every step shape timed beside its operations bound
     (integer operations counted from the built kernel's SASS,
     scripts/count_k8_sass.py) and latency floor; K8 at every Table I
     configuration of formats.py on its compile-time variant and at two
     off the table (N 2 without guard bits or sticky, N 16) on the
     run-time one, bitwise at M 4, K 1024, N 256, each timed at M 4 and
     M 64 (K 8192, N 1024) beside its SASS-counted bound and a lone
     chain's latency floor (the W_m 256 quire refused, as the reference
     refuses it);
     K9 within the sum bound at qwen3's expert
     shapes with float and coded activations and a fmt_out encode, a limit
     the two planted faults must fail, and at a decode step's routing (4
     tokens top-8 of 128 experts, zeros elsewhere) within the same limit,
     each routed expert bitwise an E = 1 call, timed beside the routed
     experts' bytes and torch.bmm over the routed and over all experts'
     decoded stacks, every launch on p16_2; K3 and K7 at 64 / 4 heads (G =
     16) over P(8,2) and bf16 float pages, K3 with its bound and SDPA),
     with the device time per launch (CUDA-graph replay timed by CUDA
     events; the per-call time with host overhead is printed beside it),
     the plain version's time, the bound from bytes and FLOPs at the H100
     SXM data-sheet rates, and one PyTorch call as a yardstick where one
     exists;
  4. correctness on a small input: the smoke configs' prefill logits
     (within 1e-4), KV pages (codes equal, or at a rounding boundary the
     adjacent code; float pages within 1e-5) and decode logits over the
     same prefill pages (within 1e-4, or 1e-3 of the largest where a code
     the step wrote is the adjacent one) on the card against the port's
     plain CPU path: command-r under serve_fused_p16
     (fused prefill), serve_fused_p16_a13 and validate_bit_exact, qwen3-moe
     under serve_fused_p16 and validate_bit_exact, gemma3 (20 tokens past
     its 8-token smoke window) and command-r-plus under serve_fused_p16;
  5. serving at the policy's defaults (prefix sharing, fused prefill): 8
     requests sharing a 64-token system prompt, greedy and sampled (T 0.8,
     top-k 40), greedy again with sharing off (streams must be equal) and
     with the decomposed prefill (agreement printed), then one run at
     max_seq 1280 with an 1100-token prompt so a chunk's span crosses
     FLASH_CHUNK; 5b. the same 8 requests under serve_fused_p16_a13;
     5c. the same 8 requests with speculative decoding (k = 4, the draft
     policy `with_draft()`), greedy and sampled: streams equal to phase
     5's, or a difference only at a near-tie the verify's summation order
     flips (shown with the gap and the verify-vs-sequential logit
     difference); 5d. the async front end over a speculative engine: batch
     work fills the slots, an interactive request preempts one, streamed
     tokens equal final tokens equal plain decode, the pool ends clean;
     then the front end over a plain engine, whose decode steps, driven
     from the front end's event loop, capture the decode graph once and
     replay it every later step, streams equal plain decode.
     Each main-path run (defaults greedy and sampled, long prompt, a13,
     speculative greedy and sampled, front end) counts its launches from
     0, and its kernels must launch in it; every page must come back;
     each run prints its prefill steps' share of the wall time; the
     defaults runs' decode steps must run their 7 x layers projections on
     the float GEMV's p16_2 variant and no K1 (K1 keeps the prefill chunk
     groups, every launch on a compile-time variant); a13's
     decode-step K6 launches must take the P(16,2) split-K GEMV and its
     prefill launches the split-bf16 tensor-core GEMM;
  6. profile: torch.profiler over a few decode steps with four slots busy,
     at the defaults and under a13, and over one speculative round, device
     time per step by kernel and the device's busy share; then phase 5's
     queue greedy with f32 activations on its weights (`_f32_serving`:
     every K5 launch on `tc_f32`, each K5 call replayed against its plain
     version, the same queue with K5 on SIMT for the tokens/s and prefill
     share beside it);
  7. bit_exact: command-r-35b at full width, 2 layers, validate_bit_exact
     (every projection and the tied head through K8, bf16 float pages, no
     fused head): 4 requests of 16-32 tokens, 8 new tokens each, greedy;
     every K8 launch on the compile-time variant p13_16_n4, every K2
     launch on p13_2; then the same weights and queue at
     PDPU_P13_16_N8_W10 (pdpu_n 8, pdpu_w_m 10), counted from 0, every K8
     launch on p13_16_n8_w10 and each K8 call replayed bitwise against
     the plain version on 64 of its columns (W_m + 1 rejected);
  8. MoE: qwen3-moe-235b at full width (4 of 94 layers; weights drawn and
     packed layer by layer), serve_fused_p16 defaults: 8 requests sharing a
     64-token system prompt, 16 new tokens each, greedy, every expert GEMM
     through K9; then two of its decode steps profiled.
     Phases 7 and 8 count their own launches from 0 and need K8 (K9)
     launched 7 L + 1 (3 L) times per decode step.  Every K9 and K4 launch
     of the MoE run, and every K4 launch of the defaults runs, must take
     the p16_2 variant (the compile-time P(16,2) decode).  Every main path runs
     bf16 activations, so all of its K5 launches must take a
     tensor-core variant ("prefill_attention:tc" at head_dim 128,
     ":tc256" for gemma3's 256), and every K3 launch of
     a main path must split its key span and merge ("paged_attention:merge"),
     and every K2 launch of a main path must take a compile-time variant
     (none "posit_encode:posit").
  9. training: minitron-8b at full width (d_model 4096, 32 / 8 heads of
     128, d_ff 16384, vocab 256000, untied; 4 of 32 layers), paper_mixed
     fused, 4 steps of 8 x 128 tokens in 2 microbatches through Pipeline
     and Trainer (AdamW, cosine schedule, remat per layer), counted from 0:
     finite losses, every K6 launch on `tc` (P(13,2) x P(13,2)), 7 x
     layers x microbatches x 2 of them (forward and recompute), every K2
     launch on `p13_2`, every K1 launch on `p13_2`; median step time,
     tokens/s, peak memory and one
     step profiled (device time by kernel, host share); 9b the STE
     function at each distinct shape of minitron's projections (M 512):
     forward within `sum_bound` of `ops.ste_plain` (a limit two planted
     faults must fail), dx and dw bitwise it and the fake_quant plan's;
     the training shapes of K6 (M 512, minitron's 7 projections, the same
     limit and faults), K2 and K1 (the head, [4096, 256000], bitwise)
     against their plain versions and timed; 9c 3 Trainer steps of minitron's smoke
     config on the card against the CPU (losses within 1e-3); 9d the
     training example's `run` at smoke size, float and paper_mixed fused,
     50 steps each, losses falling; 9e a checkpoint round trip of a
     train state on the card (async save, restore) bitwise.
 10. the rest of the dense family's serving, each run counting its own
     launches from 0 (`launches_by_path`):
     10a gemma3-4b at full width (d_model 2560, 8 / 4 heads of 256, d_ff
     10240, vocab 262144, tied, qk_norm, a 1024-token window on 5 of 6
     layers; 12 of 34 layers, layers 5 and 11 global), serve_fused_p16:
     K3 at its decode shape (lengths 1024-1320, window 1024 and 2^30)
     within 2e-5 of the plain version with its bound and masked SDPA; K5's
     tc256 variant (bf16, head_dim 256, a 64-token chunk at starts >= 1024,
     window 1024 and 2^30) within one bf16 ulp, pages bitwise, timed beside
     masked SDPA and its bound (the exact form: one bf16 product a q.k
     multiply-add and three a p.v one, or the bytes); K4 over the tied
     [262144, 2560] head; then 8 requests (a shared 64-token system prompt
     plus 1040-1240 of their own, so every span passes the window) at
     max_seq 1536, 16 new tokens, greedy and sampled, every K5 launch on
     `tc256`; greedy again with f32 activations (every K5 launch on
     `tc_f32` at head_dim 256, each K5 call replayed against its plain
     version; the same queue with K5 on SIMT for the tokens/s beside it);
     and the window bites: the first decode step's logits with and
     without the window differ by more than 1e-3;
     10b command-r-plus-104b at full width (d_model 12288, 96 / 8 heads of
     128, d_ff 33792, vocab 256000; 2 of 64 layers): K1 at [12288, 33792],
     K3 / K7 and K5 (`tc`) at G 12, K4 over the tied [256000, 12288] head,
     then phase 5's 8 requests greedy on the float weight path (the float
     GEMV at decode steps as in phase 5, no K6), every K5 launch on `tc`;
     10c (run right after phase 6, on phase 5's weights and requests)
     ServingEngine(paged=False): every request served, kv_cache_bytes()
     the [L, B, max_seq, F] int8 rows plus `length`, no attention kernel
     launched, each decode step's projections on the float GEMV and its
     unfused tied head on the GEMV's transposed variant (K1 only on the KV
     rows, p8_2); streams and first-step logits against phase 5's paged run
     printed;
     10d examples/serve_posit_lm_torch.py (4 requests, 4 new tokens) in a
     subprocess on the card, exit 0.  10a, 10b and 10c each profile two
     decode steps with four slots busy, as phase 6 does.
 11. MoE training at full width, paper_mixed fused (peak learning rate
     4.2e-4), phase 9's 4 steps of 8 x 128 tokens in 2 microbatches, each
     run counted from 0:
     11a qwen3-moe-235b (d_model 4096, 64 / 4 heads of 128, 128 experts of
     1536 top-8, vocab 151936, untied; 1 of 94 layers, adafactor: AdamW's
     state would not fit); 11b deepseek-moe-16b (d_model 2048, 16 heads
     of 128, 64 routed experts of 1408 top-6 and 2 shared, vocab 102400;
     4 of 28 layers, AdamW).  Each: finite losses, every K9 launch on the
     tensor-core variant with the P(13,2) decode table (`tc_p13_2`: 40 /
     64 capacity rows of coded activations), 3 x layers x microbatches x 2 of them
     (forward and remat recompute), K6 (attention projections and shared
     experts, `tc`), K2 (`p13_2`) and K1 counted against their formulas;
     median step, tokens/s, peak memory, one step profiled.  11c the
     grouped STE at both models' training shapes (qwen3: E 128, 40
     capacity rows; deepseek: E 64, 64 rows): the forward within
     `sum_bound` of `ops.ste_plain` (two planted faults must fail it), dx
     and dw bitwise it; K9 over a layer's three expert GEMMs on
     `tc_p13_2`, bitwise equal on a second call and expert 0 bitwise its
     E = 1 call, timed beside its plain version, torch.bmm on the decoded
     stacks and its bound (bytes, or the exact form's 4 bf16 products a
     multiply-add).
     11d for each model, phase 9's checks at its own shapes: the STE and K6
     at M 512 over its attention projections (qwen3: wq / wo [4096, 8192]
     / [8192, 4096], wk / wv [4096, 512]; deepseek: [2048, 2048]) and
     deepseek's shared experts ([2048, 2816], [2816, 2048]), K2 / K1 over
     its untied head ([4096, 151936], [2048, 102400]), and 3 Trainer steps
     of its smoke config on the card against the CPU.  Every shape and
     capacity comes from the model's config (`_dense_kn`, `_expert_kn`,
     `moe.capacity`).  Each training record of the kernels line counts
     the launches of its own run.
 12. the example twins examples/quickstart_torch.py,
     wm_sensitivity_study_torch.py, ptq_study_torch.py (20 steps) and
     serve_async_torch.py (2 + 1 requests, 4 tokens) on the card, in
     processes started together; each must exit 0.
 13. the SSM and hybrid families:
     13a mamba2-1.3b at full width and depth (48 layers, d_model 2048,
     d_inner 4096, 64 SSM heads of 64, state 128, vocab 50280, tied; no
     cut), seeded random weights packed to P(16,2): its kernels at its
     shapes (`_mamba_kernels`: the float GEMV over in_proj [2048, 8512] and
     out_proj [4096, 2048] at M 4 and over the tied head's transpose, K1 at
     in_proj, K2 re-encoding the head, each against its plain version and
     timed); phase 5's queue greedy and sampled, the greedy again with
     prefill interleaved (streams equal), a 2048-token prompt in chunks of
     256; the launches against their formulas (`_ssm_path_checks`: 2 x 48
     GEMV launches, one K2 and one `p16_2_t` a decode step, no K3 / K4 / K5
     / K6 / K9); the SSD's chunk form chunked and as a recurrence against
     the whole prompt with f32 activations within MAMBA_SSD_TOL of the
     largest |logit| (bf16's gaps printed); where those gaps come from
     (`_ssd_layer_gaps`: the residual's gap layer by layer, and at layer 0
     in_proj by row groups against all rows at once, the SSD chunked
     against whole on the same inputs and its recurrence against its
     chunk form); one decode step profiled.
     13b the jamba and mamba2 smoke engines (f32 activations) with the same
     packed weights on the card and the CPU, greedy, 6 requests sharing a
     prefix: equal streams; jamba's K5 (`tc_f32`), K3, K4, K9 and GEMV
     launches, mamba2's GEMV / K1 / K2 only, printed by variant; every
     kernel the card run launched replayed at each signature the run
     called it with, on copies of that call's inputs, against its plain
     version (K1 / K2 bitwise, the GEMV and K9 within `sum_bound`, K3 / K5
     within 2e-5, K4 tokens) with planted faults the limits must reject,
     and timed; these records count the smoke runs' launches.
 14. the stub-frontend configs at full width and the SSM family's QAT,
     each run counted from 0:
     14a paligemma-3b (18 of 18 layers, d_model 2048, 8 query heads on 1
     KV head of 256, d_ff 16384, vocab 257216, tied, 256 patches of 1152),
     serve_fused_p16: `api.prefill` of 4 rows of 256 random patches + 64
     tokens into the dense cache and 16 greedy decode steps (the prefill's
     projections and head on K1 p16_2, its KV on K2 p8_2; each decode step
     `_float_path_checks` with the tied head on the GEMV's p16_2_t); the
     smoke config's image prefix on the card against the CPU; the
     text-only engine on phase 5's queue, greedy and sampled (`_path_checks`
     with K5 on tc256, the float GEMV's decode steps), and greedy again
     with every kernel call recorded (streams equal) and replayed against
     its plain version with planted faults (K3 / K5 tc256 at G 8, K4 over
     the tied head, the GEMV at wk / wv N 256, K1, K2); one decode step
     profiled;
     14b hubert-xlarge (48 of 48 layers, d_model 1280, 16 heads of 80,
     d_ff 5120, vocab 504, untied, bidirectional): a packed
     serve_fused_p16 forward of 8 clips x 500 frames twice (K1 p16_2 on
     every projection and the head, nothing else), the last frame moves the
     first frame's logits, the smoke config on the card against the CPU;
     then 4 steps of paper_mixed fused QAT on the same shape (AdamW, remat,
     2 microbatches: phase 9's launch formulas, median step, tokens/s, peak
     memory, one step profiled), the STE and K6 / K2 / K1 at its training
     shapes (M 2000), 3 smoke steps on the card against the CPU;
     14c mamba2-1.3b (48 of 48 layers) paper_mixed fused QAT, phase 9's 4
     steps of 8 x 128 tokens (K6 on in_proj [2048, 8512] and out_proj
     [4096, 2048]), the STE and K6 / K2 / K1 at those shapes, and 3 smoke
     steps of mamba2 and of jamba on the card against the CPU.
 15. kv_pages-sharded page pools on phase 5's weights (command-r-35b, full
     width, 4 of 40 layers, serve_fused_p16), right after 10c, each run
     counted from 0: 15a two shards of cuda:0 (`make_serving_mesh(2)`),
     the default pool, phase 5's queue greedy: every K3 launch per shard
     with its ownership mask and partials, one merge a layer and decode
     step, one K5 launch a layer and chunk group on the home shard reading
     history from the gathered global pool (`prefill_attention:
     global_hist`, on `tc`); the streams of slots whose pages lie on one
     shard bitwise phase 5's greedy streams; each slot's shards printed;
     15b four shards, 3 usable pages each, phase 5's queue plus a
     170-token prompt that needs all 12 (a slot spans all four shards):
     how many of the 8 streams equal phase 5's, every shard's pages back
     after the drain; that prompt on the engine's own pages of it: its
     prefill logits and pool bytes bitwise the single pool's, K3 over the
     gathered pool bitwise the single pool's first-step logits, the
     merged first step within SHARD_LOGIT_TOL and one shard's partials
     dropped outside it; a sharded decode step profiled; for each run,
     every K5 and K3 signature it called (K5 keyed by masked writes and
     the shards one slot's history spans, K3 by its shard's ownership)
     replayed against the plain versions (K5's page writes bitwise, its
     attention within its limit and bitwise the unsharded launch over
     the global pool) and the merge at each K3 shape with the run's shard
     count against the unsharded K3 (bitwise for a slot on one shard),
     each record counting its own run's launches; 15c `python -m
     repro_torch.launch.serve --mesh-model 2` at smoke width in a
     subprocess, exit 0.
 16. large pages, the compressed cross-pod reduction, the autotune cache:
     16a (on phase 5's weights, after phase 15) K3 and K7 (T = 4) at
     pages of 256, 512 and 1024 tokens (64 / 8 heads of 128; 8 / 4 heads
     of 256 with a 1024-token window), int8 and bf16 pages, within 2e-5
     of the plain version, every K7 row bitwise K3 at its own length, two
     shards' merged partials bitwise K3 for a slot on one shard; K3 / K7
     records at pages of 256 and 1024 with their bounds and SDPA; phase
     4's small-input check of command-r's smoke config at pages of 256
     (300-token prompts); then phase 5's queue greedy at pages of 256
     (max_seq 512), counted from 0 (phase 5's path rules, every K3 launch
     merged), its tok/s beside a page-16 run at the same max_seq, and
     speculatively (k = 4, every K7 launch merged), counted from 0; the
     streams' agreement printed;
     16b mamba2-1.3b at full width and depth, paper_mixed fused, through
     `make_train_step_compressed` on a (pod 2, data 2, model 1) mesh of
     cuda:0, 3 steps of 8 x 128 tokens, counted from 0: per step the
     loss, the step time, K1 / K2 `p8_2` launches (2 n and n^2 + 3 n a
     leaf) and the int8 bytes handed between pods against `wire_bytes`;
     losses finite and falling; step 0's reduction of every leaf within
     P(8,2)'s rounding bound of the pods' f32 mean and conserving the sum
     with its residuals (`_compress_checks`, which a residual left out
     fails), small leaves bitwise their CPU reduction, K2 / K1 `p8_2`
     bitwise their plain versions on the step's g + e and timed at the
     largest leaf's shape; one more step profiled;
     16c K7's t_block swept by `launch/autotune.py`'s runner at the
     verify's serving shape (each candidate's time printed), the cache
     written to a temporary path, and a launch through it: the tuned tile
     counted, the output bitwise the untuned launch's.
 17. the dry run (`launch/dryrun.py`) against the card: three cells at full
     width, each reckoned on a one-position mesh of the meta device
     (`build_cell`, `analyze`), then run for real on cuda:0:
     17a train, minitron-8b (4 of 32 layers), phase 9's 8 x 128 tokens in
     2 microbatches, AdamW, paper_mixed fused; 17b prefill, mamba2-1.3b
     (all 48 layers, packed P(16,2)), one 2048-token prompt through
     `api.prefill`; 17c decode, qwen3-moe-235b (4 of 94 layers, packed),
     `api.decode_step` over the dense cache at 4 rows.  Each must meet
     two exact gates: the reckoned `memory.port` bytes equal the bytes of
     the params, optimizer state, batch and cache the run holds on the
     card, and the reckoned launches equal `ops.launch_counts()` over one
     step, kernel by kernel and variant by variant.  Printed beside them,
     ungated: the reckoned peak of live bytes beside
     `torch.cuda.max_memory_allocated()` over that step, and the roofline
     terms beside the median of 3 more steps.
 18. the compiled decode step.  Every single-pool engine above already
     decodes by replaying CUDA graphs (runtime/step_graph.py: the first
     decode step a warm-up, the second captured, every later one a
     replay), so every earlier phase's gates hold over replays.  Phase 18
     serves each configuration's queue once more graphed and once inside
     `disable_graphs()`, each run counted from 0, where its weights live:
     defaults greedy and sampled, a13 and the dense cache (after phase 6,
     on phase 5's weights), bit_exact (after phase 7), MoE (after phase 8),
     gemma3 (in 10a), mamba2-1.3b (after 13a: 4 requests, 16 decode steps
     of 48 layers) and paligemma-3b (in 14a).  Each must show the streams
     bitwise equal, the launches equal kernel by kernel and variant by
     variant, 1 decode program a step fused (2 unfused: the decode and the
     sampler) and every step after the first replaying them
     (`_graph_mismatches`); printed beside each other: the mean and median
     decode step on the host clock, the device-busy share of 4 steps under
     the profiler (`_profile`) and the peak allocated memory.  Last, an
     `.item()` planted in a smoke engine's decode body must make its
     capture raise, the graph left uncaptured.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _hw(key: str):
    """The card's data-sheet figure `key` (`launch/mesh.py`'s `HW`)."""
    from repro_torch.launch.mesh import HW
    return HW[key]


def _bound(w):
    """(ms, "bytes" or "operations"): the least time for a kernel's work
    `w`, a `kernels/work.py` `Work` (the formulas the dry run adds up):
    its bytes over the HBM rate or its operations over the peak rate of
    their class, whichever is larger."""
    from repro_torch.launch.mesh import HW
    s, by = w.bound_s(HW)
    return s * 1e3, by


def _f32_form(w):
    """`w` with its math flops run as f32 FMA (the SIMT yardstick beside a
    tensor-core variant's exact form)."""
    return dataclasses.replace(w, ops=w.flops, rate="f32")


def _bytes_ms(w) -> float:
    """`w`'s bytes alone over the HBM rate, ms."""
    return _bound(dataclasses.replace(w, ops=0.0))[0]


def _ops_ms(w) -> float:
    """`w`'s operations alone over their peak rate, ms."""
    return _bound(dataclasses.replace(w, read=0.0, written=0.0))[0]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, launches: int, replays: int = 3) -> float:
    """Device time per call: `launches` calls captured in one CUDA graph,
    replayed and timed with CUDA events (no host overhead in the figure)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as graph capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * launches)
    del graph
    return ms


def _time_once_ms(fn) -> float:
    """One call's time on the host clock ending in a synchronize, after
    one untimed call (a first call pays for allocations and setup)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _release():
    """Free what dropped objects held on the card (engines keep reference
    cycles, so collect them first)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _check(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _units(gap, bound) -> float:
    """The largest gap in units of u sqrt(K) ||a_i . b_j||_2 (the
    `sum_bound` over its SUM_TOL)."""
    from repro_torch.kernels import posit_matmul as pm
    return float((gap / (bound / pm.SUM_TOL).clamp(min=1e-30)).max())


def _planted_faults(what: str, A, B, want, bound) -> str:
    """Two faults the `sum_bound` limit must reject against the plain
    version's `want` from the decoded operands A, B ([..., M, K] and
    [..., K, N]): both operands rounded to bf16, and one 64-wide K tile
    left out.  (P(13,2) weights below 2^-4 in magnitude carry at most 7
    fraction bits, so rounding them alone to bf16 can change nothing.)
    Returns each fault's largest gap in `_units`."""
    import torch
    seen = []
    for fault, bad in (("bf16 operands",
                        torch.matmul(A.to(torch.bfloat16).float(),
                                     B.to(torch.bfloat16).float())),
                       ("K tile left out",
                        want - torch.matmul(A[..., :64], B[..., :64, :]))):
        bad_gap = (bad - want).abs()
        _check(bool((bad_gap > bound).any()),
               f"{what}: the limit rejects the planted fault '{fault}'")
        seen.append(f"{fault} {_units(bad_gap, bound):.4g}")
        del bad, bad_gap
    return ", ".join(seen)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# the weight shapes K1 is timed at (the bytes bound beside each): prefill
# chunk groups' widest projections (command-r-35b, command-r-plus-104b),
# the training head, the run-time variant, a dense KV cache layer's rows;
# the label of each shape whose time is a record of the kernels line
_K1_SHAPES = (("P16_2", (8192, 22528)), ("P16_2", (12288, 33792)),
              ("P13_2", (4096, 256000)), ("P16_1", (8192, 22528)),
              ("P8_2", (4, 256, 1024)))
_K1_RECORDS = {("P16_2", (8192, 22528)):
               "command-r-35b's gate / up, prefill chunk groups",
               ("P8_2", (4, 256, 1024)): "a dense KV cache layer's int8 rows"}


def _k1_decode(dev):
    """K1 on every code of each format with a compile-time variant
    (P(16,2) and P(13,2) from int16, P(8,2) from int8: every container
    pattern, bits above n ignored) and of P(16,1) (the run-time variant),
    bitwise the plain decode; then timed at the weight shapes that keep K1
    (prefill chunk groups, the heads, training) beside the bytes bound.
    Returns a record per compile-time variant a main path runs."""
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import ops, posit_codec
    from repro_torch.kernels import work
    for name in ("P16_2", "P13_2", "P8_2", "P16_1"):
        fmt = getattr(formats, name)
        dtype = posit.storage_dtype(fmt)
        bits = 8 * dtype.itemsize
        every = torch.arange(-(1 << (bits - 1)), 1 << (bits - 1),
                             dtype=torch.int64).to(dtype).to(dev)
        variant = posit_codec.decode_variant(fmt, dtype)
        before = ops.launch_counts()[f"posit_decode:{variant}"]
        _check(_bits_equal(posit_codec.decode(every, fmt),
                           posit_codec.decode_plain(every, fmt)),
               f"K1 posit_decode ({variant}) on all 2^{bits} {name} "
               f"container patterns")
        _check(ops.launch_counts()[f"posit_decode:{variant}"] == before + 1,
               f"K1 takes its {variant} variant for {name} in {dtype}")
    g = torch.Generator(device=dev).manual_seed(1)
    records = []
    for name, shape in _K1_SHAPES:
        fmt = getattr(formats, name)
        codes = posit_codec.encode(
            torch.randn(*shape, generator=g, device=dev)
            * (1.0 / math.sqrt(shape[-2])), fmt)
        got = posit_codec.decode(codes, fmt)
        want = posit_codec.decode_plain(codes, fmt)
        _check(_bits_equal(got, want),
               f"K1 posit_decode at {name} {list(shape)}")
        del got, want
        call_ms = _time_ms(lambda: posit_codec.decode(codes, fmt), reps=10)
        ms = _device_ms(lambda: posit_codec.decode(codes, fmt), launches=5)
        label = _K1_RECORDS.get((name, shape))
        plain_ms = (_time_once_ms(lambda: posit_codec.decode_plain(codes, fmt))
                    if label else None)
        bound, by = _bound(work.decode(codes.numel(), codes.element_size()))
        variant = posit_codec.decode_variant(fmt, codes.dtype)
        print(f"K1 {name} {list(shape)} ({variant}): ms {ms:.4f}, call_ms "
              f"{call_ms:.4f}, plain_ms "
              f"{'not measured' if plain_ms is None else f'{plain_ms:.3f}'}"
              f", bound_ms {bound:.4f} ({by}), {bound / ms:.3f} of the "
              f"bound")
        del codes
        torch.cuda.empty_cache()
        if label:
            records.append(dict(
                name=f"posit_decode:{variant} ({label})",
                counter=f"posit_decode:{variant}",
                source="src/repro_torch/csrc/posit_codec.cu",
                replaces="src/repro/kernels/posit_codec.py:55",
                max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"{list(shape)} {name} codes -> f32"))
    return records


def _gemv_f_faults(what: str, x, W, want, bound, ks: int) -> str:
    """Two faults the float GEMV's `sum_bound(x, w, None, fmt)` limit must
    reject against the plain version's `want` from the f32 activations x
    [M, K] and the decoded weights W [K, N]: W rounded to bf16, and the
    first K split (ks rows) left out.  Returns each fault's largest gap in
    `_units`."""
    import torch
    seen = []
    for fault, bad in (("bf16 weights",
                        torch.matmul(x, W.to(torch.bfloat16).float())),
                       ("K split left out",
                        want - torch.matmul(x[:, :ks], W[:ks]))):
        bad_gap = (bad - want).abs()
        _check(bool((bad_gap > bound).any()),
               f"{what}: the limit rejects the planted fault '{fault}'")
        seen.append(f"{fault} {_units(bad_gap, bound):.4g}")
        del bad, bad_gap
    return ", ".join(seen)


def _gemv_f_ks(variant: str, N: int, K: int) -> int:
    """The codes of the float GEMV's first K split."""
    from repro_torch.kernels import posit_matmul as pm
    return (pm.split_k_t(N, K) if variant.endswith("_t")
            else pm.gemv_f_split_k(N, K))[0]


def _gemv_f_rows_check(gemv, x, w, fmt, what: str):
    """Row m of `gemv` at M 1 .. len(x) must be bitwise row m of the call
    over all of x's rows: the float GEMV's sums do not depend on M."""
    full = gemv(x, w, fmt)
    differ = [M for M in range(1, x.shape[0] + 1)
              if not _bits_equal(gemv(x[:M], w, fmt), full[:M])]
    _check(not differ, f"{what}: rows at M 1-{x.shape[0]} bitwise the rows "
                       f"of the M {x.shape[0]} call (they differ at M "
                       f"{differ})")


def _device_kernels(fn) -> list:
    """The names of the device kernels one call of `fn` runs (after one
    untimed call), by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _check_one_launch(names, kernel: str, what: str):
    """`names` (`_device_kernels`) must be one kernel, named `kernel`."""
    _check(len(names) == 1 and kernel in names[0],
           f"{what}: one launch a call (the device ran {names})")


def gemv_f_sass_ops() -> dict:
    """The float GEMV's instructions a code in its hot loops, by pipe,
    counted from the SASS of the library just built
    (scripts/time_gemv_decode.py's `count`), at M 4 with bf16 activations
    and the P(16,2) table decode: the [K, N] kernel's ring loop (32 codes
    a lane a slot) and register loop (64), the transposed kernel's (32)."""
    from repro_torch.kernels import _build
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import time_gemv_decode
    text = time_gemv_decode.sass(str(_build.build_all()["posit_gemv_f"]))
    return {label: time_gemv_decode.count(
        text, (kernel, "ILi4E", "ActBf16", "DecodeP16_2Table"), 4, 1,
        codes=codes)
        for label, kernel, codes in (
            ("kn", "posit_gemv_f_kernel", 32),
            ("kn_registers", "posit_gemv_f_kernel", 64),
            ("t", "posit_gemv_f_t_kernel", 32))}


# command-r-35b's tied head: [vocab, d_model] codes read as [d_model, vocab]
_HEAD_VD = (256000, 8192)
# the other layers the float GEMV is timed at, M 4: (label, arch)
_GEMV_F_LAYERS = (("mamba2-1.3b", "mamba2_1_3b"),
                  ("paligemma-3b", "paligemma_3b"))


def _gemv_f_case(x, x8, w, fmt, what: str):
    """The float GEMV's gates on one weight: each launch on its variant,
    bitwise equal on a second call, rows independent of M (x8: 8 rows),
    one launch a call, within `sum_bound(x, w, None, fmt)` of the plain
    version.  Returns (|got - plain|, the bound, plain, variant)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_matmul as pm
    M = x.shape[0]
    variant = pm.gemv_f_variant(M, fmt, w)
    before = ops.launch_counts()[f"posit_gemv_f:{variant}"]
    got = pm.posit_gemv_f(x, w, fmt)
    _check(ops.launch_counts()[f"posit_gemv_f:{variant}"] == before + 1,
           f"{what}: the float GEMV takes its {variant} variant")
    _check(_bits_equal(pm.posit_gemv_f(x, w, fmt), got),
           f"{what}: the float GEMV bitwise deterministic")
    _gemv_f_rows_check(pm.posit_gemv_f, x8, w, fmt, f"{what}: float GEMV")
    _check_one_launch(_device_kernels(lambda: pm.posit_gemv_f(x, w, fmt)),
                      "posit_gemv_f", f"{what}: float GEMV")
    want = torch.matmul(x.to(torch.float32), ops.decode(w, fmt))
    bound = pm.sum_bound(x, w, None, fmt)
    gap = (got - want).abs()
    _check(bool((gap <= bound).all()),
           f"{what}: the float GEMV within {pm.SUM_TOL} u sqrt(K) ||x w|| "
           f"({variant})")
    return gap, bound, want, variant


def _gemv_f(dev):
    """The float GEMV (the float weight path at decode rows) at every
    command-r-35b projection shape, over the tied head's transpose, and at
    mamba2-1.3b's and paligemma-3b's layers, at M 4 with bf16 activations
    (the serving path's): within `sum_bound(x, w, None, fmt)` of its plain
    version, a limit two planted faults must fail, bitwise equal on a
    second call, each launch on its variant, rows at M 1-8 bitwise the M 8
    call's, one device kernel a call (torch.profiler); timed beside K1 +
    torch.matmul (the path it replaces), torch.matmul on pre-decoded f32
    weights, its plain version and its bytes bound; its instructions a
    code from the SASS.  Returns the records of the command-r layer
    ([K, N], `p16_2`), the head (transposed, `p16_2_t`) and the other two
    layers."""
    import torch
    from repro_torch import configs
    from repro_torch.core import formats
    from repro_torch.kernels import ops, posit_codec
    from repro_torch.kernels import posit_matmul as pm
    from repro_torch.kernels import work
    sass = gemv_f_sass_ops()
    print(f"float GEMV SASS a code (scripts/time_gemv_decode.py; alu the "
          f"integer pipe): {json.dumps(sass)}")
    fmt, M = formats.P16_2, 4
    g = torch.Generator(device=dev).manual_seed(7)
    xs = {K: torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
          for K in {K for K, _ in _LAYER_KN}}
    weights = {(K, N): posit_codec.encode(
        torch.randn(K, N, generator=g, device=dev) / math.sqrt(K), fmt)
        for K, N in sorted(set(_LAYER_KN))}
    V, D = _HEAD_VD
    head = posit_codec.encode(torch.randn(V, D, generator=g, device=dev)
                              / math.sqrt(D), fmt)
    cases = [((K, N), weights[(K, N)]) for K, N in sorted(set(_LAYER_KN))]
    cases.append(((D, V), head.T))
    err = ratio = 0.0
    per = {}
    for (K, N), w in cases:
        x = xs[K]
        x8 = torch.cat([x, torch.randn(4, K, generator=g, device=dev)
                        .to(torch.bfloat16)])
        gap, bound, want, variant = _gemv_f_case(x, x8, w, fmt,
                                                 f"K={K} N={N}")
        err = max(err, float(gap.max()))
        ratio = max(ratio, _units(gap, bound))
        xf = x.to(torch.float32)
        W = ops.decode(w, fmt)
        faults = _gemv_f_faults(f"float GEMV K={K} N={N}", xf, W, want,
                                bound, _gemv_f_ks(variant, N, K))
        del want, gap, bound, x8
        ms = _device_ms(lambda: pm.posit_gemv_f(x, w, fmt), launches=5)
        k1_mm = _device_ms(lambda: torch.matmul(
            x.to(torch.float32), ops.decode(w, fmt)), launches=3)
        mm = _device_ms(lambda: torch.matmul(xf, W), launches=5)
        del W
        torch.cuda.empty_cache()
        bound_ms, by = _bound(work.gemv_f(M, K, N, x.element_size(),
                                          w.element_size()))
        per[(K, N)] = (ms, k1_mm, mm, bound_ms, by)
        print(f"float GEMV M={M} K={K} N={N} ({variant}, bf16 activations): "
              f"largest err in u sqrt(K) ||x w|| so far {ratio:.4g} (limit "
              f"{pm.SUM_TOL}; planted: {faults}), bitwise equal on a second "
              f"call, rows at M 1-8 bitwise the M 8 call's, one launch a "
              f"call, ms {ms:.4f}, K1 + torch.matmul {k1_mm:.4f}, "
              f"torch.matmul on decoded f32 {mm:.4f}, bound_ms "
              f"{bound_ms:.4f} ({by}), {bound_ms / ms:.3f} of the bound")

    def layer_run():
        for K, N in _LAYER_KN:
            pm.posit_gemv_f(xs[K], weights[(K, N)], fmt)

    layer_ms = _device_ms(layer_run, launches=3)
    call_ms = _time_ms(layer_run, reps=5)
    plain_ms = _time_once_ms(lambda: [pm.posit_gemv_f_plain(
        xs[K], weights[(K, N)], fmt) for K, N in _LAYER_KN])
    k1_mm = sum(per[kn][1] for kn in _LAYER_KN)
    mm = sum(per[kn][2] for kn in _LAYER_KN)
    bound, by = _bound(work.total(work.gemv_f(M, K, N, 2, 2)
                                  for K, N in _LAYER_KN))
    print(f"kernel posit_gemv_f (float GEMV, M={M}, one command-r layer's 7 "
          f"projections): ms {layer_ms:.4f}, K1 + torch.matmul {k1_mm:.4f} "
          f"(sum of the projections), torch.matmul on decoded f32 {mm:.4f}, "
          f"bound_ms {bound:.4f} ({by}), {bound / layer_ms:.3f} of the "
          f"bound; largest err {ratio:.4g} units (limit {pm.SUM_TOL})")
    hms, hk1, hmm, hbound, hby = per[(D, V)]
    x = xs[D]
    head_call = _time_ms(lambda: pm.posit_gemv_f(x, head.T, fmt), reps=5)
    head_plain = _time_once_ms(lambda: pm.posit_gemv_f_plain(x, head.T, fmt))
    del head, weights
    torch.cuda.empty_cache()
    common = dict(source="src/repro_torch/csrc/posit_gemv_f.cu",
                  replaces="src/repro/kernels/posit_codec.py:55",
                  max_abs_err=err)
    records = [dict(common, name="posit_gemv_f:p16_2 (float weight path, "
                                 "M 4, a command-r layer's 7 projections)",
                    counter="posit_gemv_f:p16_2", ms=layer_ms,
                    call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=by, library_ms=mm, k1_matmul_ms=k1_mm,
                    sass_ops_a_code=sass["kn"],
                    shape="M=4 bf16 x [K, N] int16 P(16,2), 7 launches"),
               dict(common, name="posit_gemv_f:p16_2_t (float weight path, "
                                 "M 4, the tied head's transpose)",
                    counter="posit_gemv_f:p16_2_t", ms=hms,
                    call_ms=head_call, plain_ms=head_plain, bound_ms=hbound,
                    bound_by=hby, library_ms=hmm, k1_matmul_ms=hk1,
                    sass_ops_a_code=sass["t"],
                    shape=f"M=4 bf16 x [{V}, {D}]^T int16 P(16,2)")]
    for label, arch in _GEMV_F_LAYERS:
        kns = [(K, N) for _, K, N in _dense_kn(configs.get(arch))]
        ws = {kn: posit_codec.encode(torch.randn(*kn, generator=g,
                                                 device=dev)
                                     / math.sqrt(kn[0]), fmt)
              for kn in sorted(set(kns))}
        lx = {K: torch.randn(8, K, generator=g, device=dev)
              .to(torch.bfloat16) for K, _ in kns}
        lerr, lmm, lper = 0.0, 0.0, []
        for K, N in sorted(set(kns)):
            x, w = lx[K][:M], ws[(K, N)]
            gap, bound_kn, want, variant = _gemv_f_case(
                x, lx[K], w, fmt, f"{label} K={K} N={N}")
            xf, W = x.to(torch.float32), ops.decode(w, fmt)
            faults = _gemv_f_faults(f"{label} float GEMV K={K} N={N}", xf,
                                    W, want, bound_kn,
                                    _gemv_f_ks(variant, N, K))
            lerr = max(lerr, float(gap.max()))
            ms = _device_ms(lambda: pm.posit_gemv_f(x, w, fmt), launches=5)
            lib = _device_ms(lambda: torch.matmul(xf, W), launches=5)
            b_ms, b_by = _bound(work.gemv_f(M, K, N, 2, 2))
            lmm += lib * kns.count((K, N))
            lper.append(f"{K}x{N} {ms:.4f} ({b_ms / ms:.3f} of {b_ms:.4f})")
            print(f"float GEMV {label} M={M} K={K} N={N} ({variant}): ms "
                  f"{ms:.4f}, torch.matmul on decoded f32 {lib:.4f}, "
                  f"bound_ms {b_ms:.4f} ({b_by}), {b_ms / ms:.3f} of the "
                  f"bound; planted: {faults}")
            del gap, bound_kn, want, W
        run = lambda: [pm.posit_gemv_f(lx[K][:M], ws[(K, N)], fmt)  # noqa: E731
                       for K, N in kns]
        lms = _device_ms(run, launches=3)
        lcall = _time_ms(run, reps=5)
        lplain = _time_once_ms(lambda: [pm.posit_gemv_f_plain(
            lx[K][:M], ws[(K, N)], fmt) for K, N in kns])
        lbound, lby = _bound(work.total(work.gemv_f(M, K, N, 2, 2)
                                        for K, N in kns))
        print(f"kernel posit_gemv_f (float GEMV, M={M}, one {label} layer's "
              f"{len(kns)} projections): ms {lms:.4f}, bound_ms {lbound:.4f} "
              f"({lby}), {lbound / lms:.3f} of the bound; "
              f"{', '.join(lper)}")
        records.append(dict(common, max_abs_err=lerr,
                            name=f"posit_gemv_f:p16_2 (float weight path, "
                                 f"M 4, a {label} layer's {len(kns)} "
                                 f"projections)",
                            counter="posit_gemv_f:p16_2", ms=lms,
                            call_ms=lcall, plain_ms=lplain, bound_ms=lbound,
                            bound_by=lby, library_ms=lmm,
                            shape=f"M=4 bf16 x [K, N] int16 P(16,2), "
                                  f"{len(kns)} launches"))
        del ws, lx
        torch.cuda.empty_cache()
    return records


def _k2_encode(dev):
    """K2 at the tied head's shape, [256000, 8192] f32, into P(16,2) (the
    defaults' re-encode) and P(13,2) (bit_exact's), bitwise, each launch
    on its compile-time variant; every rounding boundary between adjacent
    codes and its two f32 neighbours (both signs) for each compile-time
    variant, bitwise."""
    import torch
    from repro_torch.core import formats
    from repro_torch.kernels import ops, posit_codec
    from repro_torch.kernels import work
    g = torch.Generator(device=dev).manual_seed(2)
    emb = torch.randn(256000, 8192, generator=g, device=dev)
    flat = emb.view(-1)
    special = torch.tensor(
        [0.0, -0.0, 1e-45, -3e-39, 1.17e-38, float("inf"), float("-inf"),
         float("nan"), 1e20, -1e20, 3.4e38, 2.0 ** 60, -2.0 ** -70],
        dtype=torch.float32, device=dev)
    flat[:special.numel()] = special
    # bf16-rounded values and a spread of raw bit patterns
    flat[1000:1000 + (1 << 20)] = flat[1000:1000 + (1 << 20)].to(
        torch.bfloat16).float()
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 22,), generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)
    flat[-(1 << 22):] = bits.view(torch.float32)
    times = {}
    for fmt in (formats.P16_2, formats.P13_2):
        variant = posit_codec.encode_variant(fmt, torch.int16)
        before = ops.launch_counts()[f"posit_encode:{variant}"]
        got = posit_codec.encode(emb, fmt)
        _check(ops.launch_counts()[f"posit_encode:{variant}"] == before + 1,
               f"K2 {fmt} took its variant {variant}")
        want = posit_codec.encode_plain(emb, fmt)
        _check(_bits_equal(got, want), f"K2 posit_encode {fmt} at "
                                       f"[256000, 8192]")
        del got, want
        times[fmt] = _device_ms(lambda: posit_codec.encode(emb, fmt),
                                launches=2)
        print(f"K2 {fmt} [256000, 8192] ({variant}): ms {times[fmt]:.4f}")
    for fmt in (formats.P16_2, formats.P13_2, formats.P8_2):
        b = posit_codec.rounding_boundaries(fmt).to(dev)
        v = torch.cat([b, torch.nextafter(b, torch.zeros_like(b)),
                       torch.nextafter(b, torch.full_like(b, float("inf")))])
        v = torch.cat([v, -v])
        _check(_bits_equal(posit_codec.encode(v, fmt),
                           posit_codec.encode_plain(v, fmt)),
               f"K2 {fmt}: every rounding boundary and its neighbours")
        print(f"K2 {fmt}: {b.numel()} rounding boundaries and their f32 "
              f"neighbours, both signs, bitwise")
    fmt = formats.P16_2
    call_ms = _time_ms(lambda: posit_codec.encode(emb, fmt), reps=5)
    plain_ms = _time_once_ms(lambda: posit_codec.encode_plain(emb, fmt))
    bound, by = _bound(work.encode(emb.numel(), 2))
    del emb, flat
    return dict(name="posit_encode", source="src/repro_torch/csrc/posit_codec.cu",
                replaces="src/repro/kernels/posit_codec.py:78",
                max_abs_err=0.0, ms=times[fmt], call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, shape="[256000, 8192] f32 -> int16 P(16,2)")


# lengths that end on a split boundary of K3 / K7 (2 pages of 16 tokens)
# and span several splits
SPLIT_LENGTHS = (1, 32, 33, 256, 1100)


def _attention_splits_check(dev, Hq, Hkv, kv: str):
    """K3 and K7 (T = 4) over one block table of 70 pages at
    SPLIT_LENGTHS, full window, window 100 + softcap 30, and page_ok +
    partials: within 2e-5 of the plain version, every K7 row bitwise K3
    at its length, each call on the merge kernel.  Returns max |err|."""
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    fmt = formats.P8_2 if kv == "int8" else None
    B, M, ps, Dh, T = len(SPLIT_LENGTHS), 70, 16, 128, 4
    P = B * M + 1
    g = torch.Generator(device=dev).manual_seed(Hq + Hkv)
    kvp = torch.randn(2, P, ps, Hkv * Dh, generator=g, device=dev)
    kvp = posit.pack(kvp, fmt) if fmt else kvp.to(
        {"bf16": torch.bfloat16, "f32": torch.float32}[kv])
    kp, vp = kvp[0], kvp[1]
    bt = torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, M)
    ln = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    q3 = torch.randn(B, Hq, Dh, generator=g, device=dev)
    q4 = torch.randn(B, T, Hq, Dh, generator=g, device=dev)
    ok = (torch.rand(B, M, generator=g, device=dev) > 0.2).to(torch.int32)
    tup = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    err = 0.0
    for win, kw in ((1 << 30, {}), (100, dict(softcap_val=30.0)),
                    (1 << 30, dict(page_ok=ok, partials=True))):
        w = torch.tensor([win], dtype=torch.int32, device=dev)
        for q in (q3, q4):
            name = "paged_attention_mq" if q.ndim == 4 else "paged_attention"
            before = ops.launch_counts()[f"{name}:merge"]
            got = tup(pa.paged_attention(q, kp, vp, bt, ln, w, fmt_kv=fmt,
                                         **kw))
            _check(ops.launch_counts()[f"{name}:merge"] == before + 1,
                   f"{name} merges its splits")
            want = tup(pa.paged_attention_plain(q, kp, vp, bt, ln, w,
                                                fmt_kv=fmt, **kw))
            for a, b in zip(got, want):
                _check(bool(torch.isfinite(a).all())
                       and bool(torch.allclose(a, b, rtol=2e-5, atol=2e-5)),
                       f"{name} within 2e-5 at split-boundary lengths "
                       f"(G={Hq // Hkv}, {kv} pages, window {win}, {kw})")
                err = max(err, float((a - b).abs().max()))
        for i in range(T):
            k3 = tup(pa.paged_attention(q4[:, i].contiguous(), kp, vp, bt,
                                        ln - T + i + 1, w, fmt_kv=fmt, **kw))
            _check(all(_bits_equal(a[:, i].contiguous(), b)
                       for a, b in zip(got, k3)),
                   f"K7 row {i} bitwise K3 at split-boundary lengths "
                   f"(G={Hq // Hkv}, {kv} pages)")
    print(f"K3 / K7 at lengths {SPLIT_LENGTHS} (G={Hq // Hkv}, {kv} pages, "
          f"{pa.attention_splits(M, ps, Dh)[1]} splits): max |err| "
          f"{err:.3g}, "
          f"K7 rows bitwise K3")
    return err


def _k3_attention(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.core import formats, posit
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    fmt = formats.P8_2
    B, Hq, Hkv, Dh, ps, M = 4, 64, 8, 128, 16, 16
    P = B * M + 1
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, Hq, Dh, generator=g, device=dev)
    kp = posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g, device=dev), fmt)
    vp = posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g, device=dev), fmt)
    bt = (torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, M))
    lengths = torch.tensor([256, 137, 0, 64], dtype=torch.int32, device=dev)
    full = torch.tensor([1 << 30], dtype=torch.int32, device=dev)
    ok = torch.ones(B, M, dtype=torch.int32, device=dev)
    ok[1, 3] = 0
    err = 0.0
    cases = [dict(window=full, softcap_val=0.0, page_ok=None, partials=False),
             dict(window=torch.tensor([100], dtype=torch.int32, device=dev),
                  softcap_val=30.0, page_ok=None, partials=False),
             dict(window=full, softcap_val=0.0, page_ok=ok, partials=True)]
    for kw in cases:
        got = pa.paged_attention(q, kp, vp, bt, lengths, fmt_kv=fmt, **kw)
        want = pa.paged_attention_plain(q, kp, vp, bt, lengths, fmt_kv=fmt,
                                        **kw)
        if not kw["partials"]:
            got, want = (got,), (want,)
        for a, b in zip(got, want):
            _check(bool(torch.isfinite(a).all()), "K3 finite outputs")
            _check(bool(torch.allclose(a, b, rtol=2e-5, atol=2e-5)),
                   f"K3 paged_attention within 2e-5 ({kw['softcap_val']=})")
            err = max(err, float((a - b).abs().max()))
        _check(bool((got[0][2] == 0).all()), "K3 zero-length slot")
    for kv in ("int8", "bf16", "f32"):
        err = max(err, _attention_splits_check(dev, Hq, Hkv, kv))
    ks, n_splits = pa.attention_splits(M, ps, Dh)
    _check(n_splits * Hkv * B > B * Hkv,
           "K3 launches more than B x Hkv blocks at the serving shape")
    print(f"K3 grid at the serving shape: {n_splits} splits of {ks} keys x "
          f"{Hkv} KV heads x {B} slots = {n_splits * Hkv * B} blocks "
          f"(B x Hkv = {B * Hkv})")
    args = (q, kp, vp, bt, lengths, full)
    call_ms = _time_ms(lambda: pa.paged_attention(*args, fmt_kv=fmt),
                       reps=200)
    ms = _device_ms(lambda: pa.paged_attention(*args, fmt_kv=fmt),
                    launches=50)
    plain_ms = _time_ms(lambda: pa.paged_attention_plain(*args, fmt_kv=fmt),
                        reps=5)
    # yardstick: SDPA over the same K/V already gathered and decoded
    kd = posit.decode(kp[bt.long()], fmt).reshape(B, M * ps, Hkv, Dh)
    vd = posit.decode(vp[bt.long()], fmt).reshape(B, M * ps, Hkv, Dh)
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    q4 = q[:, :, None, :]
    library_ms = _device_ms(
        lambda: F.scaled_dot_product_attention(q4, kd, vd), launches=50)
    pages = sum(-(-int(n) // ps) for n in lengths.tolist())
    bound, by = _bound(work.paged_attention(
        B, 1, Hq, Hkv, Dh, pages * ps, kp.element_size(), bt.shape[1],
        int(lengths.sum())))
    return dict(name="paged_attention",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:266",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                shape="B=4 Hq=64 Hkv=8 Dh=128 ps=16 L<=256 int8 pages")


def _k7_attention_mq(dev):
    """K7 at the verify's shape: 4 slots, T = 4 new tokens each, 64 / 8
    heads of 128, P(8,2) pages of 16, lengths up to 256."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import formats, posit
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    fmt = formats.P8_2
    B, T, Hq, Hkv, Dh, ps, M = 4, 4, 64, 8, 128, 16, 16
    P = B * M + 1
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(B, T, Hq, Dh, generator=g, device=dev)
    kp = posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g, device=dev), fmt)
    vp = posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g, device=dev), fmt)
    bt = torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, M)
    lengths = torch.tensor([256, 137, 3, 64], dtype=torch.int32, device=dev)
    full = torch.tensor([1 << 30], dtype=torch.int32, device=dev)
    ok = torch.ones(B, M, dtype=torch.int32, device=dev)
    ok[1, 3] = 0
    err = 0.0
    cases = [dict(window=full, softcap_val=0.0, page_ok=None, partials=False),
             dict(window=torch.tensor([100], dtype=torch.int32, device=dev),
                  softcap_val=30.0, page_ok=None, partials=False),
             dict(window=full, softcap_val=0.0, page_ok=ok, partials=True)]
    tup = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    for kw in cases:
        got = tup(pa.paged_attention(q, kp, vp, bt, lengths, fmt_kv=fmt,
                                     **kw))
        want = tup(pa.paged_attention_plain(q, kp, vp, bt, lengths,
                                            fmt_kv=fmt, **kw))
        for a, b in zip(got, want):
            _check(bool(torch.isfinite(a).all()), "K7 finite outputs")
            _check(bool(torch.allclose(a, b, rtol=2e-5, atol=2e-5)),
                   f"K7 paged_attention_mq within 2e-5 of its plain version "
                   f"({kw['softcap_val']=}, partials={kw['partials']})")
            err = max(err, float((a - b).abs().max()))
        # each row i bitwise K3 at length L - T + i + 1; T = 1 is K3
        for i in range(T):
            k3 = tup(pa.paged_attention(q[:, i].contiguous(), kp, vp, bt,
                                        lengths - T + i + 1, fmt_kv=fmt,
                                        **kw))
            _check(all(_bits_equal(a[:, i].contiguous(), b)
                       for a, b in zip(got, k3)),
                   f"K7 row {i} bitwise equal to K3 at its own length")
        one = tup(pa.paged_attention(q[:, :1], kp, vp, bt, lengths - T + 1,
                                     fmt_kv=fmt, **kw))
        k3 = tup(pa.paged_attention(q[:, 0].contiguous(), kp, vp, bt,
                                    lengths - T + 1, fmt_kv=fmt, **kw))
        _check(all(_bits_equal(a[:, 0].contiguous(), b)
                   for a, b in zip(one, k3)), "K7 at T = 1 bitwise K3")
        tiles = [tup(pa.paged_attention(q, kp, vp, bt, lengths, fmt_kv=fmt,
                                        t_block=tb, **kw)) for tb in (1, 2, 4)]
        _check(all(_bits_equal(a, b) for t in tiles[1:]
                   for a, b in zip(tiles[0], t)),
               "K7 t_block 1 / 2 / 4 bitwise equal")
    _check(bool((got[0][2, 0] == 0).all()),
           "K7: a row with nothing to attend gives zeros")
    err = max(err, _attention_splits_check(dev, Hq, Hkv, "int8"))
    args = (q, kp, vp, bt, lengths, full)
    call_ms = _time_ms(lambda: pa.paged_attention(*args, fmt_kv=fmt),
                       reps=200)
    ms = _device_ms(lambda: pa.paged_attention(*args, fmt_kv=fmt),
                    launches=50)
    plain_ms = _time_ms(lambda: pa.paged_attention_plain(*args, fmt_kv=fmt),
                        reps=5)
    # yardstick: SDPA over the same K/V already gathered and decoded, with
    # the causal-offset mask (row i sees positions <= L - T + i)
    S = M * ps
    kd = posit.decode(kp[bt.long()], fmt).reshape(B, S, Hkv, Dh)
    vd = posit.decode(vp[bt.long()], fmt).reshape(B, S, Hkv, Dh)
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    q_pos = lengths.long()[:, None] - T + torch.arange(T, device=dev)
    mask = torch.arange(S, device=dev)[None, None, :] <= q_pos[..., None]
    qt = q.permute(0, 2, 1, 3)
    library_ms = _device_ms(lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask[:, None]), launches=50)
    # bytes: q and the output once, each page a slot's rows reach once (K
    # and V codes), the block tables and lengths; operations: q.k and p.v
    # over the (row, key) pairs this data attends
    rows = [[max(int(n) - T + i + 1, 0) for i in range(T)]
            for n in lengths.tolist()]
    pages = sum(-(-max(r) // ps) for r in rows)
    bound, by = _bound(work.paged_attention(
        B, T, Hq, Hkv, Dh, pages * ps, kp.element_size(), bt.shape[1],
        sum(sum(r) for r in rows)))
    return dict(name="paged_attention_mq",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:195",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                shape="B=4 T=4 Hq=64 Hkv=8 Dh=128 ps=16 L<=256 int8 pages")


def _kernel_device_ms(fn, calls: int = 3) -> dict:
    """Device time per call of each kernel `fn` launches, by kernel name
    (torch.profiler; host overhead excluded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {evt.key: evt.self_device_time_total / calls / 1e3
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total}


def _k4_times(label, x, w, noise, transpose):
    """K4 at 4 and at 16 batch rows over one head (T 0.8, top-k 40): device
    time per call, its two passes apart (torch.profiler), and the bytes
    bound (weights, activations, noise and tokens once)."""
    from repro_torch.core import formats
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    V, D = (w.shape if transpose else w.shape[::-1])
    for B in (4, 16):
        xb, nb = x[:B].contiguous(), noise[:B].contiguous()
        run = lambda: pa.decode_sample(  # noqa: E731
            xb, w, nb, 0.8, plan="fused", fmt_w=formats.P16_2,
            transpose=transpose, greedy=False, top_k=40)
        ms = _device_ms(run, launches=3)
        passes = {"pass 1": 0.0, "pass 2": 0.0}
        for key, t in _kernel_device_ms(run).items():
            if "ds_logits" in key:
                passes["pass 1"] += t
            elif "ds_select" in key:
                passes["pass 2"] += t
        bound, by = _bound(work.decode_sample(B, D, V, w.element_size(),
                                              xb.element_size(), False))
        print(f"K4 {label} (V {V}, D {D}) B={B}: ms {ms:.4f} (pass 1 "
              f"{passes['pass 1']:.4f}, pass 2 {passes['pass 2']:.4f}, "
              f"torch.profiler), bound_ms {bound:.4f} ({by}), "
              f"{bound / ms:.3f} of the bound")


def _k4_decode_sample(dev):
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    fmt = formats.P16_2
    B, D, V = 4, 8192, 256000
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
    w = posit.pack(torch.randn(V, D, generator=g, device=dev), fmt)
    u = torch.rand(B, V, generator=g, device=dev).clamp(1e-9, 1 - 1e-7)
    noise = -torch.log(-torch.log(u))
    kw = dict(plan="fused", fmt_w=fmt, transpose=True)
    logits = pa.head_logits_plain(x, w, softcap_val=0.0, **kw)
    err = 0.0
    # the kernel sums the D = 8192 products in another order than the
    # plain matmul: a token may differ only where the plain top-two scores
    # lie within 1e-5 of the largest |logit|
    tol = 1e-5 * float(logits.abs().max())
    ops.reset_launches()
    for greedy, top_k, temp in ((True, 0, 1.0), (False, 40, 0.8),
                                (False, 0, 0.8)):
        tok = pa.decode_sample(x, w, None if greedy else noise, temp,
                               greedy=greedy, top_k=top_k, **kw)
        want = pa.sample_logits(logits, noise, temp, greedy=greedy,
                                top_k=top_k)
        l = logits if greedy else pa.scale_logits(logits, temp)
        if top_k:
            kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
            l = torch.where(l >= kth, l, torch.full_like(l, -1e30))
        score = l if greedy else noise + l
        rows = torch.arange(B, device=dev)
        gap = (score[rows, want.long()] - score[rows, tok.long()]).abs()
        _check(bool(((tok == want) | (gap <= tol)).all()),
               f"K4 decode_sample tokens (greedy={greedy}, top_k={top_k})")
        err = max(err, float(gap.max()))
    # the sampler's l / max(T, 1e-6) on the card against the host's f32
    # division; the former expression divided by a Python float
    import numpy as np
    host = logits.cpu().numpy()
    for temp in (0.8, 0.7, 1e-7):
        want_bits = (host / np.float32(max(temp, 1e-6))).view(np.int32)
        got = pa.scale_logits(logits, temp).cpu().numpy().view(np.int32)
        old = (logits / max(float(temp), 1e-6)).cpu().numpy().view(np.int32)
        _check(bool(np.array_equal(got, want_bits)),
               f"the sampler's temperature division at T {temp} is bitwise "
               f"the host's f32 division")
        print(f"temperature {temp}: scale_logits bitwise the host's f32 "
              f"division on {host.size} logits; the former Python-float "
              f"division differs on {int((old != want_bits).sum())}")
    # the verify runs K4 over B * T = 16 rows where plain decode runs 4:
    # a row's token must not depend on the other rows
    x16 = torch.cat([x, torch.randn(12, D, generator=g, device=dev)
                     .to(x.dtype)])
    n16 = torch.cat([noise, -torch.log(-torch.log(
        torch.rand(12, V, generator=g, device=dev).clamp(1e-9, 1 - 1e-7)))])
    for greedy, top_k in ((True, 0), (False, 40)):
        t16 = pa.decode_sample(x16, w, n16, 0.8, greedy=greedy, top_k=top_k,
                               **kw)
        t4 = pa.decode_sample(x, w, noise, 0.8, greedy=greedy, top_k=top_k,
                              **kw)
        _check(bool(torch.equal(t16[:4], t4)),
               f"K4 tokens of rows 0-3 equal over 16 rows and over 4 "
               f"(greedy={greedy})")
    # every launch above decoded the P(16,2) head at compile time
    counts = ops.launch_counts()
    _check(counts["decode_sample:p16_2"] == counts["decode_sample"] > 0,
           "K4 takes its p16_2 variant for an int16 P(16,2) head")
    run = lambda: pa.decode_sample(x, w, noise, 0.8, greedy=False,  # noqa: E731
                                   top_k=40, **kw)
    call_ms = _time_ms(run, reps=10)
    ms = _device_ms(run, launches=3)
    plain_ms = _time_once_ms(lambda: pa.decode_sample_plain(
        x, w, noise, 0.8, greedy=False, top_k=40, **kw))
    bound, by = _bound(work.decode_sample(B, D, V, w.element_size(),
                                          x.element_size(), False))
    _k4_times("[V, D] command-r head", x16, w, n16, True)
    del w, logits
    # qwen3-moe's untied [D, V] head
    Dq, Vq = 4096, 151936
    wq = posit.pack(torch.randn(Dq, Vq, generator=g, device=dev) / 64, fmt)
    xq = torch.randn(16, Dq, generator=g, device=dev)
    nq = -torch.log(-torch.log(torch.rand(16, Vq, generator=g, device=dev)
                               .clamp(1e-9, 1 - 1e-7)))
    lq = pa.head_logits_plain(xq, wq, plan="fused", fmt_w=fmt,
                              transpose=False, softcap_val=0.0)
    tq = pa.decode_sample(xq, wq, nq, 0.8, plan="fused", fmt_w=fmt,
                          greedy=False, top_k=40)
    want = pa.sample_logits(lq, nq, 0.8, greedy=False, top_k=40)
    sq = pa.scale_logits(lq, 0.8)
    kth = torch.topk(sq, 40, dim=-1).values[..., -1:]
    sq = nq + torch.where(sq >= kth, sq, torch.full_like(sq, -1e30))
    rows = torch.arange(16, device=dev)
    gap = (sq[rows, want.long()] - sq[rows, tq.long()]).abs()
    _check(bool(((tq == want) | (gap <= 1e-5 * float(lq.abs().max()))).all()),
           "K4 tokens over qwen3's [D, V] head at 16 rows")
    _check(bool(torch.equal(tq[:4], pa.decode_sample(
        xq[:4].contiguous(), wq, nq[:4].contiguous(), 0.8, plan="fused",
        fmt_w=fmt, greedy=False, top_k=40))),
        "K4 [D, V]: rows 0-3 equal over 16 rows and over 4")
    err = max(err, float(gap.max()))
    del lq, sq
    _k4_times("[D, V] qwen3 head", xq, wq, nq, False)
    del wq
    return dict(name="decode_sample",
                source="src/repro_torch/csrc/decode_sample.cu",
                replaces="src/repro/kernels/paged_attention.py:467",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape="B=4 D=8192 V=256000 int16 [V, D], T=0.8 top-k 40")


def _k5_case(dev, act, M, starts, reps, Hkv=8, paged_fmt="P8_2", Hq=64,
             Dh=128, window=1 << 30, force=None):
    """K5 against its plain version at the serving geometry (4 slots, a
    64-token chunk, Hq query heads of Dh over Hkv KV heads, 16-token pages,
    M pages per slot, a sliding window), P(8,2) pages or (paged_fmt None)
    float pages in act.  Slots 0 and 1 share their history pages; slot 3
    has page_ok all 0.  Checks the variant the wrapper took
    (`prefill_variant`; `force` names another one to run instead, for an
    A/B on one card).  Returns a dict: the variant, max |err|, times,
    bounds and the library time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import formats, posit
    from repro_torch.kernels import ops
    from repro_torch.kernels import prefill_attention as pf
    from repro_torch.kernels import work
    if force is not None:
        chosen = pf.prefill_variant
        pf.prefill_variant = lambda dtype, head_dim: force
        try:
            return _k5_case(dev, act, M, starts, reps, Hkv, paged_fmt, Hq,
                            Dh, window)
        finally:
            pf.prefill_variant = chosen
    fmt = getattr(formats, paged_fmt) if paged_fmt else None
    B, C, ps = 4, 64, 16
    P = B * M + 1
    g = torch.Generator(device=dev).manual_seed(5 + M)
    kp, vp = (torch.randn(P, ps, Hkv * Dh, generator=g, device=dev)
              for _ in range(2))
    kp, vp = ((posit.pack(x, fmt) for x in (kp, vp)) if fmt
              else (x.to(act) for x in (kp, vp)))
    bt = torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, M)
    shared = starts[0] // ps
    bt[1, :shared] = bt[0, :shared]
    q = torch.randn(B, C, Hq, Dh, generator=g, device=dev).to(act)
    k = torch.randn(B, C, Hkv, Dh, generator=g, device=dev).to(act)
    v = torch.randn(B, C, Hkv, Dh, generator=g, device=dev).to(act)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    win = torch.tensor([window], dtype=torch.int32, device=dev)
    ok = torch.ones(B, M, dtype=torch.int32, device=dev)
    ok[3] = 0
    kw = dict(fmt_kv=fmt, compute_dtype=act, flash_chunk=1024, page_ok=ok)
    kp0, vp0 = kp.clone(), vp.clone()
    variant = pf.prefill_variant(act, Dh)
    before = ops.launch_counts()[f"prefill_attention:{variant}"]
    got, _, _ = pf.prefill_attention_paged(q, k, v, kp, vp, bt, st, win, **kw)
    _check(ops.launch_counts()[f"prefill_attention:{variant}"] == before + 1,
           f"K5 takes its {variant} variant for {act}")
    want, _, _ = pf.prefill_attention_paged_plain(q, k, v, kp0.clone(),
                                                  vp0.clone(), bt, st, win,
                                                  **kw)
    kp2, vp2 = kp0.clone(), vp0.clone()
    pf.prefill_attention_paged_plain(q, k, v, kp2, vp2, bt, st, win, **kw)
    _check(_bits_equal(kp[1:], kp2[1:]) and _bits_equal(vp[1:], vp2[1:]),
           f"K5 page writes bitwise (M={M}, {act})")
    _check(_bits_equal(kp[bt[3].long()], kp0[bt[3].long()]),
           "K5 leaves page_ok == 0 pages untouched")
    _check(bool(torch.isfinite(got.float()).all()), "K5 finite outputs")
    if act == torch.float32:
        close = torch.allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        close = torch.allclose(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-6)
    _check(bool(close), f"K5 attention within tolerance (M={M}, {act})")
    err = float((got.float() - want.float()).abs().max())
    run = lambda: pf.prefill_attention_paged(q, k, v, kp, vp, bt, st, win,  # noqa: E731
                                             **kw)
    call_ms = _time_ms(run, reps=reps)
    ms = _device_ms(run, launches=reps)
    plain_ms = _time_once_ms(lambda: pf.prefill_attention_paged_plain(
        q, k, v, kp2, vp2, bt, st, win, **kw))
    # yardstick: SDPA over history already gathered and decoded, plus the
    # chunk, with the causal / unwritten-history mask
    S_h = M * ps
    hk, hv = ((posit.decode(x[bt.long()], fmt) if fmt else x[bt.long()])
              .reshape(B, S_h, Hkv, Dh).to(act) for x in (kp0, vp0))
    keys = torch.cat([hk, k], 1).permute(0, 2, 1, 3).repeat_interleave(
        Hq // Hkv, dim=1)
    vals = torch.cat([hv, v], 1).permute(0, 2, 1, 3).repeat_interleave(
        Hq // Hkv, dim=1)
    kv_pos = torch.cat([torch.where(torch.arange(S_h, device=dev)[None] <
                                    st[:, None].long(),
                                    torch.arange(S_h, device=dev)[None], -1),
                        st[:, None].long() + torch.arange(C, device=dev)], 1)
    q_pos = st[:, None].long() + torch.arange(C, device=dev)
    mask = ((kv_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= kv_pos[:, None, :])
            & (q_pos[:, :, None] - kv_pos[:, None, :] < window))
    qt = q.permute(0, 2, 1, 3)
    library_ms = _device_ms(lambda: F.scaled_dot_product_attention(
        qt, keys, vals, attn_mask=mask[:, None]), launches=reps)
    # work.prefill: the history rows the window reaches read once (slot 1
    # reads slot 0's shared pages), the chunk's codes written (slot 3's
    # not), q.k and p.v over the (query, key) pairs this data attends
    # (causal, within the window): the exact bf16 products on the
    # tensor-core variants, f32 FMA on the SIMT one; the f32 FMA form is
    # printed beside
    table = bt.tolist()
    hist_rows = {(table[b][r // ps], r % ps) for b, s in enumerate(starts)
                 for r in range(max(0, s - window + 1), s)}
    pairs = sum(min(s + j + 1, window) for s in starts for j in range(C))
    kernel_work = work.prefill(
        B, C, Hq, Hkv, Dh, q.element_size(), kp.element_size(),
        len(hist_rows), (B - 1) * C, pairs, variant,
        chunk_pairs=B * sum(min(j + 1, window) for j in range(C)),
        kv_terms=pf.prefill_kv_terms(kp.dtype, fmt, act == torch.bfloat16))
    bound, by = _bound(kernel_work)
    return dict(variant=variant, err=err, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, bound=bound, by=by, library_ms=library_ms,
                f32_fma_ms=_bound(_f32_form(kernel_work))[0],
                bytes_ms=_bytes_ms(kernel_work))


# K5's f32 shapes (PERF.md §6): the serving shape, the long span (two
# flash chunks of history before the tail) and gemma3-4b's chunk (head_dim
# 256, G 2) with its local layers' window and its global layers'
K5_F32_SHAPES = (
    ("serving shape", dict(M=16, starts=[64, 64, 130, 190])),
    ("long span", dict(M=128, starts=[1024, 1024, 1500, 1984])),
    ("gemma3-4b head_dim 256, window 1024",
     dict(M=128, starts=[1024, 1100, 1500, 1960], Hkv=4, Hq=8, Dh=256,
          window=1024)),
    ("gemma3-4b head_dim 256, global",
     dict(M=128, starts=[1024, 1100, 1500, 1960], Hkv=4, Hq=8, Dh=256)))
# the runs whose K5 launches the tc_f32 records count, and the bit_exact
# run at PDPU_P13_16_N8_W10 (phase 7) whose K8 launches the Table I
# records count
F32_RUNS = ("command-r f32 greedy", "gemma3 f32 greedy")
BIT_EXACT_W10 = "bit_exact w10 greedy"


def _k5_f32(dev):
    """tc_f32 at K5_F32_SHAPES against its plain version, and A/B against
    the SIMT kernel (the parent's f32 path) in the same call; the exactness
    probe (`_k5_probe`).  Returns one kernel record a shape."""
    import torch
    records = []
    for label, kw in K5_F32_SHAPES:
        new = _k5_case(dev, torch.float32, reps=10, **kw)
        _check(new["variant"] == "tc_f32", f"K5 f32 {label}: tc_f32")
        old = _k5_case(dev, torch.float32, reps=3, force="simt", **kw)
        print(f"kernel prefill_attention tc_f32 {label}: ms {new['ms']:.4f} "
              f"(A/B: simt {old['ms']:.4f}, {old['ms'] / new['ms']:.2f}x), "
              f"plain_ms {new['plain_ms']:.3f}, bound_ms {new['bound']:.4f} "
              f"({new['by']}, the exact form; f32 FMA "
              f"{new['f32_fma_ms']:.4f}), library_ms (SDPA f32, masked) "
              f"{new['library_ms']:.4f} ({new['ms'] / new['library_ms']:.2f}x"
              f": target "
              f"{'met' if new['ms'] <= new['library_ms'] else 'not met'}"
              f"), max_abs_err {new['err']:.3g} (simt {old['err']:.3g})")
        records.append(dict(
            name=f"prefill_attention (tc_f32, {label})",
            counter="prefill_attention:tc_f32", paths=F32_RUNS,
            source="src/repro_torch/csrc/prefill_attention.cu",
            replaces="src/repro/kernels/prefill_attention.py:251",
            max_abs_err=new["err"], ms=new["ms"], call_ms=new["call_ms"],
            plain_ms=new["plain_ms"], bound_ms=new["bound"],
            bound_by=new["by"], library_ms=new["library_ms"],
            simt_ms=old["ms"], shape=label))
    gaps = _k5_probe(dev)
    print("K5 tc_f32 exactness probe (rows whose outputs hang on one bf16 "
          "term of a chunk / history key or value, of q * scale or of p): "
          "max |gap| to the plain version " + json.dumps(gaps))
    return records


def _k5_probe_inputs(dev):
    """K5's exactness probe at tc_f32: two slots of f32 activations over an
    f32 pool (every key and value three bf16 terms), head_dim 64 (scale
    1/8: q * scale exact), one KV head.  Four probes, a query row each in
    slot 0's chunk (rows 1, 3, 5, 7) and in slot 1's (rows 0-3, over
    slot 1's history page, which holds slot 0's 8 chunk rows): each row
    sees exactly two keys of its probe (a -1000 score on its sentinel dim
    hides every other key), tied in exact arithmetic only when every term
    of the probed operand counts:
      0  keys 1 + 2^-9 + 2^-18 and (1, 2^-9, 2^-18) in three dims: k's
         terms; values +-256, the output 0;
      1  equal keys, values 1024 (1 + 2^-9 + 2^-18) and -1024 (1 + 2^-9):
         v's terms, the output 2^-9;
      2  q * scale 1 + 2^-9 + 2^-18 on one key, (1, 2^-9, 2^-18) on the
         other: q's terms; the output 0;
      3  scores 1 and 30/64 (p = exp(-34/64), whose lo term is 2^-18 of
         it), values 64 and -37.625: p's terms.
    Every probe's sums are exact in f32.  Returns the wrapper's kwargs."""
    import torch
    B, C, Dh, ps, M = 2, 8, 64, 16, 4
    lo3 = 1 + 2.0 ** -9 + 2.0 ** -18
    keys = torch.zeros(8, Dh)
    vals = torch.zeros(8, Dh)
    qs = torch.zeros(4, Dh)
    keys[:, 60:64] = -1000.0
    for i in range(8):
        keys[i, 60 + i // 2] = 0.0
    qs[torch.arange(4), 60 + torch.arange(4)] = 1.0
    keys[0, 0] = lo3
    keys[1, :3] = torch.tensor([1, 2.0 ** -9, 2.0 ** -18])
    qs[0, :3] = 1.0
    vals[0], vals[1] = 256.0, -256.0
    keys[2, 3] = keys[3, 3] = 1.0
    qs[1, 3] = 1.0
    vals[2], vals[3] = 1024.0 * lo3, -1024.0 * (1 + 2.0 ** -9)
    keys[4, 4] = 1.0
    keys[5, 5:8] = torch.tensor([1, 2.0 ** -9, 2.0 ** -18])
    qs[2, 4], qs[2, 5:8] = lo3, 1.0
    vals[4], vals[5] = 256.0, -256.0
    keys[6, 8], keys[7, 8] = 30 / 64, 1.0
    qs[3, 8] = 1.0
    vals[6], vals[7] = 64.0, -37.625
    junk = torch.zeros(Dh)
    junk[60:64] = -1000.0
    q = torch.zeros(B, C, 1, Dh)
    k = junk.expand(B, C, 1, Dh).clone()
    v = torch.zeros(B, C, 1, Dh)
    k[0, :, 0], v[0, :, 0] = keys, vals
    q[0, 1::2, 0] = qs * 8.0           # q * scale = qs
    q[1, :4, 0] = qs * 8.0
    kp = junk.expand(1 + B * M, ps, Dh).clone()
    vp = torch.zeros(1 + B * M, ps, Dh)
    bt = (torch.arange(B * M, dtype=torch.int32) + 1).reshape(B, M)
    kp[int(bt[1, 0]), :8], vp[int(bt[1, 0]), :8] = keys, vals
    f = dict(device=dev)
    return dict(q=q.to(**f), k=k.to(**f), v=v.to(**f), k_pages=kp.to(**f),
                v_pages=vp.to(**f), block_tables=bt.to(**f),
                starts=torch.tensor([0, 16], dtype=torch.int32, **f),
                window=torch.tensor([1 << 30], dtype=torch.int32, **f),
                fmt_kv=None, compute_dtype=torch.float32)


# the probe's rows (slot, chunk row), one each of probes 0-3, in slot 0's
# chunk and over slot 1's history
K5_PROBE_ROWS = {"chunk": [(0, 1), (0, 3), (0, 5), (0, 7)],
                 "history": [(1, 0), (1, 1), (1, 2), (1, 3)]}


def _k5_probe_gaps(got, want) -> dict:
    """Each probe row's largest |got - want| (its 64 dims), by where its
    keys lie; `_attention_close` holds the whole output."""
    return {where: [float((got[b, j] - want[b, j]).abs().max())
                    for b, j in rows] for where, rows in K5_PROBE_ROWS.items()}


def _k5_probe(dev, run=None) -> dict:
    """The exactness probe through `run` (K5's wrapper by default) against
    the plain version: within K5's f32 limit, which drops every probe row
    that loses a term (the planted faults of tests/test_torch_smoke_checks
    .py drop each of q's, k's, v's and p's lo terms).  Returns the gaps."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import prefill_attention as pf
    a = _k5_probe_inputs(dev)
    before = ops.launch_counts()["prefill_attention:tc_f32"]
    got = (run or pf.prefill_attention_paged)(
        **dict(a, k_pages=a["k_pages"].clone(),
               v_pages=a["v_pages"].clone()))[0]
    _check(run is not None or ops.launch_counts()["prefill_attention:tc_f32"]
           == before + 1, "K5 probe: launched on tc_f32")
    want = pf.prefill_attention_paged_plain(
        **dict(a, k_pages=a["k_pages"].clone(),
               v_pages=a["v_pages"].clone()))[0]
    gaps = _k5_probe_gaps(got, want)
    _check(_attention_close(got, want),
           f"K5 exactness probe within 2e-5 of the plain version: {gaps}")
    return gaps


def _k5_prefill(dev):
    import torch
    # serving geometry (max_seq 256: one flash pass), in bf16 as the model
    # runs it and in f32; a long span (M 128: two whole flash chunks of
    # history stream before the tail); qwen3's G = 16 over P(8,2) and bf16
    # pages
    serving = _k5_case(dev, torch.bfloat16, 16, [64, 64, 130, 190], reps=50)
    long = _k5_case(dev, torch.bfloat16, 128, [1024, 1024, 1500, 1984],
                    reps=10)
    print(f"kernel prefill_attention serving shape: bound_ms at the f32 FMA "
          f"rate {serving['f32_fma_ms']:.4f}")
    print(f"kernel prefill_attention long span (M 128, starts >= 1024, two "
          f"streamed flash chunks): ms {long['ms']:.4f}, plain_ms "
          f"{long['plain_ms']:.3f}, bound_ms {long['bound']:.4f} "
          f"({long['by']}), bound_ms at the f32 FMA rate "
          f"{long['f32_fma_ms']:.4f}, library_ms {long['library_ms']:.4f}, "
          f"max_abs_err {long['err']:.3g}")
    errs = [serving["err"], long["err"]]
    for paged_fmt in ("P8_2", None):
        g16 = _k5_case(dev, torch.bfloat16, 16, [64, 64, 130, 190], reps=20,
                       Hkv=4, paged_fmt=paged_fmt)
        errs.append(g16["err"])
        print(f"kernel prefill_attention G=16 (64 / 4 heads, "
              f"{paged_fmt or 'bf16'} pages): ms {g16['ms']:.4f}, plain_ms "
              f"{g16['plain_ms']:.3f}, bound_ms {g16['bound']:.4f} "
              f"({g16['by']}), library_ms {g16['library_ms']:.4f}, "
              f"max_abs_err {g16['err']:.3g}")
    return [dict(name="prefill_attention",
                 source="src/repro_torch/csrc/prefill_attention.cu",
                 replaces="src/repro/kernels/prefill_attention.py:251",
                 max_abs_err=max(errs), ms=serving["ms"],
                 call_ms=serving["call_ms"], plain_ms=serving["plain_ms"],
                 bound_ms=serving["bound"], bound_by=serving["by"],
                 library_ms=serving["library_ms"],
                 shape="B=4 C=64 Hq=64 Hkv=8 Dh=128 ps=16 M=16 bf16, int8 "
                       "P(8,2) pages")] + _k5_f32(dev)


# one layer's projections of command-r-35b, (K, N): wq, wk, wv, wo, gate,
# up, down
_LAYER_KN = ((8192, 8192), (8192, 1024), (8192, 1024), (8192, 8192),
             (8192, 22528), (8192, 22528), (22528, 8192))


def _k6_matmul(dev):
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import ops, posit_codec
    from repro_torch.kernels import posit_matmul as pm
    from repro_torch.kernels import work
    fa, fb = formats.P13_2, formats.P16_2
    g = torch.Generator(device=dev).manual_seed(6)
    weights = {}
    for K, N in sorted(set(_LAYER_KN)):
        weights[(K, N)] = posit_codec.encode(
            torch.randn(K, N, generator=g, device=dev) / math.sqrt(K), fb)
    acts = {(M, K): posit_codec.encode(
        torch.randn(M, K, generator=g, device=dev), fa)
        for M in (4, 256) for K in {K for K, _ in _LAYER_KN}}
    err = ratio = 0.0
    checks = [(M, K, N, formats.P16_2 if (M, K, N) == (256, 8192, 1024)
               else None)
              for M in (4, 256) for K, N in sorted(set(_LAYER_KN))]

    for M, K, N, fo in checks:
        a, b = acts[(M, K)], weights[(K, N)]
        variant = pm.matmul_variant(M, fa, fb, b.dtype)
        before = ops.launch_counts()[f"posit_matmul:{variant}"]
        got = pm.posit_matmul(a, b, fa, fb)
        _check(ops.launch_counts()[f"posit_matmul:{variant}"] == before + 1,
               f"K6 takes its {variant} variant at M={M}")
        _check(_bits_equal(pm.posit_matmul(a, b, fa, fb), got),
               f"K6 bitwise deterministic at M={M} K={K} N={N}")
        want = pm.posit_matmul_plain(a, b, fa, fb)
        bound = pm.sum_bound(a, b, fa, fb)
        gap = (got - want).abs()
        _check(bool((gap <= bound).all()),
               f"K6 posit_matmul within {pm.SUM_TOL} u sqrt(K) ||ab|| at "
               f"M={M} K={K} N={N}")
        err = max(err, float(gap.max()))
        ratio = max(ratio, _units(gap, bound))
        if fo is not None:
            codes = pm.posit_matmul(a, b, fa, fb, fo)
            _check(_bits_equal(codes, posit.pack(got, fo)),
                   "K6 fmt_out codes are the rounding of its f32 sums")
        # planted faults the tolerance must reject: weights rounded to
        # bf16, and one 32-wide K tile left out
        A, B = posit.decode(a, fa), posit.decode(b, fb)
        faults = {"bf16 weights": torch.matmul(A, B.to(torch.bfloat16).float()),
                  "K tile left out": want - torch.matmul(A[:, :32], B[:32])}
        seen = []
        for what, bad in faults.items():
            bad_gap = (bad - want).abs()
            _check(bool((bad_gap > bound).any()),
                   f"K6 tolerance rejects the planted fault '{what}' at "
                   f"M={M} K={K} N={N}")
            seen.append(f"{what} {_units(bad_gap, bound):.4g}")
        del faults
        ms = _device_ms(lambda: pm.posit_matmul(a, b, fa, fb), launches=5)
        lib = _device_ms(lambda: torch.matmul(A, B), launches=5)
        pb, pby = _bound(work.matmul(M, K, N, 2, 2, 4, variant))
        del A, B
        print(f"K6 M={M} K={K} N={N} fmt_out={fo} ({variant}): max |err| "
              f"{float(gap.max()):.3g}, largest err in u sqrt(K) ||ab|| "
              f"{_units(gap, bound):.4g} (limit {pm.SUM_TOL}; planted: "
              f"{', '.join(seen)}), bitwise equal on a second call, ms "
              f"{ms:.4f}, bound_ms {pb:.4f} ({pby}), library_ms (torch.matmul, "
              f"decoded f32) {lib:.4f}")

    def layer_record(M):
        """Device time of one layer's 7 projections at M rows, with the
        plain version, bound and torch.matmul on decoded f32 beside it."""
        layer = [(acts[(M, K)], weights[(K, N)]) for K, N in _LAYER_KN]

        def run():
            for a, b in layer:
                pm.posit_matmul(a, b, fa, fb)

        reps = 5 if M <= pm.GEMV_MAX_M else 1
        call_ms = _time_ms(run, reps=reps)
        ms = _device_ms(run, launches=3 if reps > 1 else 1)
        plain_ms = _time_once_ms(lambda: [pm.posit_matmul_plain(a, b, fa, fb)
                                          for a, b in layer])
        decoded = [(posit.decode(a, fa), posit.decode(b, fb)) for a, b in layer]
        library_ms = _device_ms(
            lambda: [torch.matmul(a, b) for a, b in decoded],
            launches=3 if reps > 1 else 1)
        del decoded
        variant = pm.matmul_variant(M, fa, fb, torch.int16)
        w = work.total(work.matmul(M, K, N, 2, 2, 4, variant)
                       for K, N in _LAYER_KN)
        return ms, call_ms, plain_ms, library_ms, w

    ms, call_ms, plain_ms, library_ms, w4 = layer_record(4)
    bound, by = _bound(w4)
    m256 = layer_record(256)
    # the exact tensor-core form does four bf16 products per multiply-add
    tc_bound, tc_by = _bound(m256[4])
    m256 = m256[:4] + _bound(_f32_form(m256[4]))
    print(f"kernel posit_matmul M=256 (a13 prefill, "
          f"{pm.matmul_variant(256, fa, fb, torch.int16)} variant), one "
          f"layer's 7 projections: ms {m256[0]:.4f}, plain_ms {m256[2]:.3f}, "
          f"bound_ms {m256[4]:.4f} ({m256[5]}, f32), bound_ms of the exact "
          f"split-bf16 form {tc_bound:.4f} ({tc_by}, 4 bf16 products a "
          f"multiply-add at 989 TFLOP/s), library_ms (torch.matmul, decoded "
          f"f32) {m256[3]:.4f}")
    print(f"K6: largest |err| in u sqrt(K) ||ab|| over the checks "
          f"{ratio:.4g} (limit {pm.SUM_TOL})")
    return dict(name="posit_matmul", source="src/repro_torch/csrc/posit_matmul.cu",
                replaces="src/repro/kernels/posit_matmul.py:168",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                shape="M=4, one layer's 7 projections (7 launches), int16 "
                      "P(13,2) x P(16,2) -> f32")


# ---------------------------------------------------------------------------
# phase 3, slice 4: the chunked-PDPU GEMM (K8), the grouped posit GEMM (K9),
# and attention at 16 query heads per KV head and over float pages
# ---------------------------------------------------------------------------

# K8's kernels in the built library's SASS: each variant's instantiation
# of pdpu_fields_kernel (its mangled template argument), and the chunk
# steps a slab unrolls; the run-time kernel counted at N 8, S6 in 32 bits
K8_SASS_KERNELS = {
    "p13_16_n4": ("PdpuFixedILi13ELi16ELi2ELi4ELi14ELi2ELb1EE", 8),
    "p16_16_n4": ("PdpuFixedILi16ELi16ELi2ELi4ELi14ELi2ELb1EE", 8),
    "p13_16_n8": ("PdpuFixedILi13ELi16ELi2ELi8ELi14ELi2ELb1EE", 4),
    "p10_16_n8": ("PdpuFixedILi10ELi16ELi2ELi8ELi14ELi2ELb1EE", 4),
    "p13_16_n8_w10": ("PdpuFixedILi13ELi16ELi2ELi8ELi10ELi2ELb1EE", 4),
    "posit": ("PdpuRTILi8ELb0EE", 4)}
_K8_SASS: dict = {}


def k8_sass_ops(variant: str = "p13_16_n4") -> dict:
    """A K8 variant's integer operations a chunk step and a decoded code,
    counted from the SASS of the library just built
    (scripts/count_k8_sass.py): its bound uses these, the least count of
    its datapath as compiled."""
    from repro_torch.kernels import _build
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import count_k8_sass
    if "text" not in _K8_SASS:
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()),
                                 "cuobjdump")
        _K8_SASS["text"] = subprocess.run(
            [cuobjdump, "-sass", str(_build.build_all()["pdpu_dot"])],
            check=True, capture_output=True, text=True, timeout=120).stdout
    kernel, steps = K8_SASS_KERNELS[variant]
    return count_k8_sass.count(_K8_SASS["text"], kernel, steps)


# command-r's projections under bit_exact at a decode step (2 layers):
# (name, K, N_out, launches a step); the tied head, B transposed, is one
# more launch at K 8192, N_out 256000
K8_STEP_SHAPES = (("wq / wo", 8192, 8192, 4), ("wk / wv", 8192, 1024, 4),
                  ("gate / up", 8192, 22528, 4), ("down", 22528, 8192, 2),
                  ("head", 8192, 256000, 1))


def _k8_pdpu(dev):
    """K8 under bit_exact (P(13,2) codes in, P(16,2) out, N 4, W_m 14): the
    compile-time variant bitwise against its plain version at M 4, K 8192,
    N 1024 (B also transposed), ragged with special codes, at a prefill M
    (64), and over the tied head's 256000 columns (B a transposed view;
    256 columns checked, the first and last column tiles among them); the
    run-time variant on a second configuration.  Each step shape timed
    beside its operations bound (from the SASS count) and, at M 4, its
    latency floor: a lone 32-column, one-row call at the same K, which
    runs each chain alone on its SM."""
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops, pdpu_dot
    from repro_torch.kernels import work
    cfg = policy_by_name("validate_bit_exact").pdpu_config()
    _check(pdpu_dot.pdpu_variant(cfg) == "p13_16_n4",
           "the bit_exact PDPU takes the compile-time variant")
    sass = k8_sass_ops()
    step_ops, decode_ops = sass["step_ops"], sass["decode_ops"]
    print(f"K8 SASS (scripts/count_k8_sass.py): {json.dumps(sass)}")
    g = torch.Generator(device=dev).manual_seed(8)

    def codes(shape, scale=1.0, fmt=cfg.fmt_in):
        return posit.pack(torch.randn(*shape, generator=g, device=dev)
                          * scale, fmt)

    def bitwise(a, b, c, what):
        variant = pdpu_dot.pdpu_variant(c)
        before = ops.launch_counts()[f"pdpu_matmul:{variant}"]
        got = pdpu_dot.pdpu_matmul(a, b, c)
        _check(ops.launch_counts()[f"pdpu_matmul:{variant}"] == before + 1,
               f"K8 {what}: launched on {variant}")
        t0 = time.perf_counter()
        want = pdpu_dot.pdpu_matmul_plain(a, b, c)
        torch.cuda.synchronize()
        _check(_bits_equal(got, want), f"K8 {what} bitwise its plain version")
        return got, (time.perf_counter() - t0) * 1e3

    M, K, N = 4, 8192, 1024
    a = codes((M, K))
    b = codes((K, N), 1 / math.sqrt(K))
    got, plain_ms = bitwise(a, b, cfg, f"M={M} K={K} N={N}")
    # the tied head's layout: B given transposed
    bitwise(a, b.T.contiguous().T, cfg, "with B transposed")
    # ragged M and N, and special codes (zero, NaR, maxpos, minpos)
    a2, b2 = a[:3, :64].clone(), b[:64, :45].clone()
    a2[0, :4] = torch.tensor([0, cfg.fmt_in.nar_code, cfg.fmt_in.maxpos_code,
                              cfg.fmt_in.minpos_code], device=dev)
    bitwise(a2, b2, cfg, "ragged, special codes")
    # a prefill M
    a64 = codes((64, K))
    bitwise(a64, b, cfg, "M=64 (prefill)")
    out = posit.decode(got.to(torch.int16), cfg.fmt_out)
    ref = torch.matmul(posit.decode(a, cfg.fmt_in), posit.decode(b, cfg.fmt_in))
    print(f"K8: fmt_out values vs the f32 matmul of the same codes: max |diff| "
          f"{float((out - ref).abs().max()):.4g} (max |value| "
          f"{float(ref.abs().max()):.4g}; the W_m = {cfg.w_m} datapath and "
          f"the P(16,2) accumulator round, by design)")
    # the tied head: [256000, 8192] codes read as B = head.T
    head = codes((256000, K), 1 / math.sqrt(K))
    got = pdpu_dot.pdpu_matmul(a, head.T, cfg)
    cols = torch.cat([torch.arange(32, device=dev),
                      torch.arange(256000 - 32, 256000, device=dev),
                      torch.randperm(256000, generator=g, device=dev)[:192]])
    _check(_bits_equal(got[:, cols],
                       pdpu_dot.pdpu_matmul_plain(a, head[cols].T, cfg)),
           "K8 the head (B transposed, N_out 256000): 256 columns bitwise")
    print("K8 head: 256 of 256000 columns bitwise, the first and the last "
          "column tiles among them")
    del got
    # times per step shape, bounds, latency floors
    lone = {}
    for kk in sorted({k for _, k, _, _ in K8_STEP_SHAPES}):
        x1, w1 = codes((1, kk)), codes((kk, 32), 1 / math.sqrt(kk))
        lone[kk] = _device_ms(lambda: pdpu_dot.pdpu_matmul(x1, w1, cfg),
                              launches=3)
    step_ms = step_bound = 0.0
    for name, kk, nn, per_step in K8_STEP_SHAPES:
        x = a if kk == K else codes((M, kk))
        w = head.T if name == "head" else codes((kk, nn), 1 / math.sqrt(kk))
        ms = _device_ms(lambda: pdpu_dot.pdpu_matmul(x, w, cfg),
                        launches=1 if name == "head" else 3)
        bound, by = _bound(work.pdpu(M, kk, nn, cfg.N, step_ops,
                                     decode_ops))
        step_ms += per_step * ms
        step_bound += per_step * bound
        print(f"K8 {name} (M {M}, K {kk}, N_out {nn}{', B transposed' if name == 'head' else ''}): "
              f"ms {ms:.4f}, bound {bound:.4f} ({by}), latency floor "
              f"{lone[kk]:.4f} (a lone chain, {kk // 4} steps), "
              f"{per_step} a bit_exact decode step")
        del x, w
    print(f"K8 a bit_exact decode step (2 layers + head, 15 launches): "
          f"{step_ms:.4f} ms, bound {step_bound:.4f} ms")
    del head
    ms64 = _device_ms(lambda: pdpu_dot.pdpu_matmul(a64, b, cfg), launches=2)
    bound64, by64 = _bound(work.pdpu(64, K, N, cfg.N, step_ops, decode_ops))
    print(f"K8 M 64, K {K}, N_out {N} (prefill): ms {ms64:.4f}, bound "
          f"{bound64:.4f} ({by64})")
    call_ms = _time_ms(lambda: pdpu_dot.pdpu_matmul(a, b, cfg), reps=10)
    ms = _device_ms(lambda: pdpu_dot.pdpu_matmul(a, b, cfg), launches=5)
    bound, by = _bound(work.pdpu(M, K, N, cfg.N, step_ops, decode_ops))
    print(f"K8: {M * N * (K // cfg.N)} chunk steps x {step_ops:.1f} integer "
          f"operations + {M * K + K * N} operand decodes x {decode_ops:.1f} "
          f"(SASS): bound {bound:.4f} ms ({by}) at "
          f"{_hw('peak_int32_ops'):.3g} "
          f"INT32 op/s; {M * N * (K // cfg.N) / ms / 1e6:.4g} G chunk "
          f"steps/s; the source count (work.pdpu_step_ops) "
          f"{work.pdpu_step_ops(cfg.N)} a step")
    return dict(name="pdpu_matmul", source="src/repro_torch/csrc/pdpu_dot.cu",
                replaces="src/repro/kernels/pdpu_dot.py:47",
                max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"M={M} K={K} N={N}, int16 P(13,2) codes -> int32 "
                      f"P(16,2), N=4 W_m=14, p13_16_n4")


# the K8 configurations phase 3 checks and times beside the bit_exact
# policy's: the other Table I configurations the reference names, and two
# off the table (the run-time variant)
def k8_table1_configs():
    """{label: PDPUConfig}: formats.py's PDPU_* (the W_m 256 quire among
    them, which pdpu._validate refuses), N 2 with no guard bits or sticky,
    N 16."""
    import dataclasses
    from repro_torch.core import formats
    base = formats.PDPU_P13_16_N4_W14
    out = {n: getattr(formats, n) for n in sorted(dir(formats))
           if n.startswith("PDPU_")}
    out["N 2, no guard bits, no sticky"] = dataclasses.replace(
        base, N=2, guard_bits=0, sticky=False)
    out["N 16"] = dataclasses.replace(base, N=16)
    return out


def _k8_table1(dev):
    """K8 at every configuration of `k8_table1_configs`: bitwise its plain
    version at M 4, K 1024, N 256 on the variant `pdpu_variant` picks (the
    quire refused before any launch); each timed at M 4 and M 64, K 8192,
    N 1024 beside its operations bound from its own SASS count and, at
    M 4, the latency floor of a lone chain (one row, 32 columns, the same
    K): the target is half of the larger of the two or better.  Returns a
    kernel record a named configuration."""
    import torch
    from repro_torch.core import pdpu, posit
    from repro_torch.kernels import ops, pdpu_dot
    from repro_torch.kernels import work
    g = torch.Generator(device=dev).manual_seed(88)
    records = []
    M, K, N = 4, 8192, 1024
    for label, cfg in k8_table1_configs().items():
        def codes(shape, scale=1.0):
            return posit.pack(torch.randn(*shape, generator=g, device=dev)
                              * scale, cfg.fmt_in)
        a, b = codes((4, 1024)), codes((1024, 256), 1 / 32)
        try:
            pdpu._validate(cfg)
        except ValueError as e:
            raised = False
            try:
                pdpu_dot.pdpu_matmul(a, b, cfg)
            except ValueError:
                raised = True
            _check(raised, f"K8 {label}: refused by pdpu._validate")
            print(f"K8 {label}: refused before any launch ({e})")
            continue
        variant = pdpu_dot.pdpu_variant(cfg)
        _check((variant == "posit") == label.startswith("N "),
               f"K8 {label}: its variant ({variant})")
        key = f"pdpu_matmul:{variant}"
        before = ops.launch_counts()[key]
        got = pdpu_dot.pdpu_matmul(a, b, cfg)
        _check(ops.launch_counts()[key] == before + 1,
               f"K8 {label}: launched on {variant}")
        t0 = time.perf_counter()
        want = pdpu_dot.pdpu_matmul_plain(a, b, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        _check(_bits_equal(got, want), f"K8 {label} ({variant}) bitwise its "
                                       f"plain version at K 1024, N 256")
        a4, bk = codes((M, K)), codes((K, N), 1 / math.sqrt(K))
        a64 = codes((64, K))
        ms4 = _device_ms(lambda: pdpu_dot.pdpu_matmul(a4, bk, cfg),
                         launches=3)
        call_ms = _time_ms(lambda: pdpu_dot.pdpu_matmul(a4, bk, cfg), reps=3)
        ms64 = _device_ms(lambda: pdpu_dot.pdpu_matmul(a64, bk, cfg),
                          launches=2)
        x1, w1 = codes((1, K)), codes((K, 32), 1 / math.sqrt(K))
        floor = _device_ms(lambda: pdpu_dot.pdpu_matmul(x1, w1, cfg),
                           launches=3)
        step, dec, counted = _k8_ops(cfg)
        b4, by4 = _bound(work.pdpu(M, K, N, cfg.N, step, dec))
        b64, by64 = _bound(work.pdpu(64, K, N, cfg.N, step, dec))
        target = max(b4, floor)
        print(f"K8 {label} ({variant}): M 4: ms {ms4:.4f}, bound {b4:.4f} "
              f"({by4}; {step:.1f} integer operations a chunk step, "
              f"{dec:.1f} a decode, {counted}), latency floor "
              f"{floor:.4f} (a lone chain, {K // cfg.N} steps: "
              f"{floor / (K // cfg.N) * 1e6:.2f} ns a step; at the down "
              f"projection's K 22528 "
              f"{work.pdpu_floor_s(22528, cfg.N, floor / (K // cfg.N)):.4f}), "
              f"{target / ms4:.2f} of max(bound, floor): target "
              f"{'met' if ms4 <= 2 * target else 'not met'}; M 64: ms "
              f"{ms64:.4f}, bound {b64:.4f} ({by64}); plain_ms at K 1024, "
              f"N 256 {plain_ms:.1f}")
        if variant == "posit":
            continue
        records.append(dict(
            name=f"pdpu_matmul ({variant}: {label})",
            counter=key, paths=(BIT_EXACT_W10,),
            source="src/repro_torch/csrc/pdpu_dot.cu",
            replaces="src/repro/kernels/pdpu_dot.py:47", max_abs_err=0.0,
            ms=ms4, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b4,
            bound_by=by4, library_ms=None, floor_ms=floor, ms_m64=ms64,
            shape=f"M={M} K={K} N={N}, {cfg.name} (plain_ms at K 1024, "
                  f"N 256)"))
        del a4, bk, a64, x1, w1
    return records


def _k8_ops(cfg):
    """(operations a chunk step, a decode, "SASS" or "source count") of
    K8 at `cfg`: its variant's SASS count where K8_SASS_KERNELS has its
    instantiation (the run-time kernel's at N 8), else work.py's source
    count."""
    from repro_torch.kernels import pdpu_dot
    from repro_torch.kernels import work
    variant = pdpu_dot.pdpu_variant(cfg)
    if variant in K8_SASS_KERNELS and (variant != "posit" or cfg.N == 8):
        sass = k8_sass_ops(variant)
        return sass["step_ops"], sass["decode_ops"], "SASS"
    return (work.pdpu_step_ops(cfg.N, cfg.sticky), work.PDPU_DECODE_OPS,
            "source count")


# qwen3-moe-235b's expert stacks, (K, N) per GEMM: gate, up, down
_EXPERT_KN = ((4096, 1536), (4096, 1536), (1536, 4096))


def _k9_routed(dev, weights, g) -> float:
    """K9 at a decode step's routing: 4 tokens, top-8 of 128 experts,
    capacity 8, each token's f32 row in its experts' next free row and
    zeros elsewhere (as `moe._dispatch` fills the buffer).  Held to
    sum_bound, each routed expert bitwise equal to an E = 1 call, every
    launch on the p16_2 variant; the layer's 3 GEMMs timed beside the
    bound over the routed experts' bytes and torch.bmm over the routed and
    over all experts' decoded stacks.  Returns the largest |err|."""
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_matmul as pm
    from repro_torch.kernels import work
    fb = formats.P16_2
    E, M, T, k = 128, 8, 4, 8
    choice = torch.stack([torch.randperm(E, generator=g, device=dev)[:k]
                          for _ in range(T)])
    acts = {}
    for K in {K for K, _ in _EXPERT_KN}:
        x = torch.randn(T, K, generator=g, device=dev)
        buf = torch.zeros(E, M, K, device=dev)
        fill = [0] * E
        for t in range(T):
            for e in choice[t].tolist():
                buf[e, fill[e]] = x[t]
                fill[e] += 1
        acts[K] = buf
    routed = [e for e in range(E) if fill[e]]
    _check(bool(torch.equal(pm.occupied_rows_plain(acts[4096], None).cpu(),
                            torch.tensor(fill, dtype=torch.int32))),
           "K9 routed buffer: occupied rows as dispatched")
    layer = [(acts[K], weights[(K, N)]) for K, N in _EXPERT_KN]
    err = 0.0
    ops.reset_launches()
    for a, b in layer:
        got = pm.posit_matmul_grouped(a, b, None, fb)
        want = pm.posit_matmul_grouped_plain(a, b, None, fb)
        gap = (got - want).abs()
        _check(bool((gap <= pm.sum_bound(a, b, None, fb)).all()),
               f"K9 routed decode shape within {pm.SUM_TOL} u sqrt(K) ||ab|| "
               f"at K={a.shape[2]} N={b.shape[2]}")
        err = max(err, float(gap.max()))
        for e in routed:
            alone = pm.posit_matmul_grouped(a[e:e + 1], b[e:e + 1], None, fb)
            _check(_bits_equal(alone[0], got[e]),
                   f"K9 expert {e} bitwise equal to an E = 1 call")
        del want
    counts = ops.launch_counts()
    _check(counts["posit_matmul_grouped:p16_2"]
           == counts["posit_matmul_grouped"] == 3 * (1 + len(routed)),
           "K9 takes its p16_2 variant for int16 P(16,2) expert stacks")

    def run():
        for a, b in layer:
            pm.posit_matmul_grouped(a, b, None, fb)

    ms = _device_ms(run, launches=3)
    idx = torch.tensor(routed, device=dev)
    dec_all = [(a, posit.decode(b, fb)) for a, b in layer]
    dec_routed = [(a[idx], d[idx]) for a, d in dec_all]
    bmm_all = _device_ms(lambda: [torch.bmm(a, d) for a, d in dec_all],
                         launches=3)
    bmm_routed = _device_ms(lambda: [torch.bmm(a, d) for a, d in dec_routed],
                            launches=3)
    del dec_all, dec_routed
    code_bytes = sum(len(routed) * K * N * 2 for K, N in _EXPERT_KN)
    bound, by = _bound(work.total(
        work.grouped(E, M, K, N, 4, 2, 4, "p16_2", experts=len(routed))
        for K, N in _EXPERT_KN))
    print(f"K9 decode routing ({T} tokens top-{k}: {len(routed)} of {E} "
          f"experts, {sum(fill)} rows): one layer's 3 GEMMs ms {ms:.4f}, "
          f"bound_ms {bound:.4f} ({by}; the routed experts' codes "
          f"{code_bytes} B), torch.bmm over the routed experts' decoded "
          f"stacks {bmm_routed:.4f}, over all {E} {bmm_all:.4f}; every routed "
          f"expert bitwise its E = 1 call; max |err| {err:.3g}")
    return err


def _k9_grouped(dev):
    """K9 at qwen3's expert shapes (E 128, capacity 8 rows at decode):
    float activations (the serving path), coded activations and a fmt_out
    encode, held to sum_bound, with the two planted faults."""
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import posit_codec
    from repro_torch.kernels import posit_matmul as pm
    from repro_torch.kernels import work
    fb, fa = formats.P16_2, formats.P13_2
    E, M = 128, 8
    g = torch.Generator(device=dev).manual_seed(9)
    weights = {kn: posit_codec.encode(
        torch.randn(E, *kn, generator=g, device=dev) / math.sqrt(kn[0]), fb)
        for kn in sorted(set(_EXPERT_KN))}
    acts = {K: torch.randn(E, M, K, generator=g, device=dev)
            for K in {K for K, _ in _EXPERT_KN}}
    err = ratio = 0.0
    for (K, N), b in weights.items():
        for fmt_a in (None, fa):
            a = acts[K] if fmt_a is None else posit_codec.encode(acts[K], fa)
            got = pm.posit_matmul_grouped(a, b, fmt_a, fb)
            want = pm.posit_matmul_grouped_plain(a, b, fmt_a, fb)
            bound = pm.sum_bound(a, b, fmt_a, fb)
            gap = (got - want).abs()
            _check(bool((gap <= bound).all()),
                   f"K9 posit_matmul_grouped within {pm.SUM_TOL} u sqrt(K) "
                   f"||ab|| at E={E} M={M} K={K} N={N} fmt_a={fmt_a}")
            err = max(err, float(gap.max()))
            sound = _units(gap, bound)
            ratio = max(ratio, sound)
            if fmt_a is not None and K == 4096:
                codes = pm.posit_matmul_grouped(a, b, fmt_a, fb, fb)
                _check(_bits_equal(codes, posit.pack(got, fb)),
                       "K9 fmt_out codes are the rounding of its f32 sums")
            planted = _planted_faults(
                f"K9 at K={K} N={N} fmt_a={fmt_a}",
                a.float() if fmt_a is None else posit.decode(a, fmt_a),
                posit.decode(b, fb), want, bound)
            del bound, want
            torch.cuda.empty_cache()
            print(f"K9 E={E} M={M} K={K} N={N} fmt_a={fmt_a}: max |err| "
                  f"{float(gap.max()):.3g}, largest err in u sqrt(K) ||ab|| "
                  f"{sound:.4g} (limit {pm.SUM_TOL}; planted: {planted})")
    layer = [(acts[K], weights[(K, N)]) for K, N in _EXPERT_KN]
    err = max(err, _k9_routed(dev, weights, g))

    def run():
        for a, b in layer:
            pm.posit_matmul_grouped(a, b, None, fb)

    call_ms = _time_ms(run, reps=5)
    ms = _device_ms(run, launches=3)
    plain_ms = _time_once_ms(lambda: [pm.posit_matmul_grouped_plain(
        a, b, None, fb) for a, b in layer])
    decoded = [(a, posit.decode(b, fb)) for a, b in layer]
    library_ms = _device_ms(lambda: [torch.bmm(a, b) for a, b in decoded],
                            launches=3)
    del decoded
    layer_work = work.total(work.grouped(E, M, K, N, 4, 2, 4, "p16_2")
                            for K, N in _EXPERT_KN)
    bound, by = _bound(layer_work)
    bytes_moved = int(layer_work.bytes)
    print(f"K9: largest |err| in u sqrt(K) ||ab|| over the checks "
          f"{ratio:.4g} (limit {pm.SUM_TOL}); one layer's expert GEMMs move "
          f"{bytes_moved} B: {bytes_moved / ms / 1e6:.4g} GB/s")
    return dict(name="posit_matmul_grouped",
                source="src/repro_torch/csrc/posit_matmul_grouped.cu",
                replaces="src/repro/kernels/posit_matmul.py:99",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                shape="E=128 M=8, one layer's 3 expert GEMMs (3 launches), "
                      "f32 activations x int16 P(16,2) -> f32")


def _attention_g16_float_pages(dev):
    """K3 and K7 at qwen3's 64 / 4 heads (G = 16) over P(8,2) pages and
    over bf16 float pages (validate_bit_exact has no KV format): K3 and K7
    within 2e-5 and each K7 row bitwise K3; K3's device time, bound and
    SDPA time printed.  (K5 at G = 16 is a case of `_k5_prefill`.)"""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import formats, posit
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    B, Hq, Hkv, Dh, ps, M, T = 4, 64, 4, 128, 16, 16, 4
    P = B * M + 1
    g = torch.Generator(device=dev).manual_seed(16)
    full = torch.tensor([1 << 30], dtype=torch.int32, device=dev)
    bt = torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, M)
    lengths = torch.tensor([256, 137, 4, 64], dtype=torch.int32, device=dev)
    bf16 = torch.bfloat16
    for fmt in (formats.P8_2, None):
        kv = torch.randn(2, P, ps, Hkv * Dh, generator=g, device=dev)
        kv = posit.pack(kv, fmt) if fmt else kv.to(bf16)
        kp, vp = kv[0], kv[1]
        what = f"G=16 {'P(8,2)' if fmt else 'bf16'} pages"
        q = torch.randn(B, Hq, Dh, generator=g, device=dev)
        got = pa.paged_attention(q, kp, vp, bt, lengths, full, fmt_kv=fmt)
        want = pa.paged_attention_plain(q, kp, vp, bt, lengths, full,
                                        fmt_kv=fmt)
        _check(bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5)),
               f"K3 within 2e-5 at {what}")
        q4 = torch.randn(B, T, Hq, Dh, generator=g, device=dev)
        got4 = pa.paged_attention(q4, kp, vp, bt, lengths, full, fmt_kv=fmt)
        want4 = pa.paged_attention_plain(q4, kp, vp, bt, lengths, full,
                                         fmt_kv=fmt)
        _check(bool(torch.allclose(got4, want4, rtol=2e-5, atol=2e-5)),
               f"K7 within 2e-5 at {what}")
        for t in range(T):
            row = pa.paged_attention(q4[:, t].contiguous(), kp, vp, bt,
                                     lengths - (T - 1 - t), full, fmt_kv=fmt)
            _check(_bits_equal(got4[:, t].contiguous(), row),
                   f"K7 row {t} bitwise K3 at {what}")
        ms3 = _device_ms(lambda: pa.paged_attention(q, kp, vp, bt, lengths,
                                                    full, fmt_kv=fmt),
                         launches=50)
        # bound and yardstick as for the main K3 row (`_k3_attention`)
        kd, vd = ((posit.decode(x[bt.long()], fmt) if fmt
                   else x[bt.long()].float()).reshape(B, M * ps, Hkv, Dh)
                  .permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
                  for x in (kp, vp))
        library_ms = _device_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd), launches=50)
        pages = sum(-(-int(n) // ps) for n in lengths.tolist())
        bound, by = _bound(work.paged_attention(
            B, 1, Hq, Hkv, Dh, pages * ps, kp.element_size(), bt.shape[1],
            int(lengths.sum())))
        _attention_splits_check(dev, Hq, Hkv, "int8" if fmt else "bf16")
        print(f"attention at {what}: K3 ms {ms3:.4f} (B 4, L <= 256), "
              f"bound_ms {bound:.4f} ({by}), library_ms {library_ms:.4f}: "
              f"within tolerance, K7 rows bitwise K3")


# ---------------------------------------------------------------------------
# phase 4: small-input agreement with the plain CPU path
# ---------------------------------------------------------------------------

# a small-input run may show at most this many differing KV codes; each
# must come from a value within the float pages' tolerance (rtol 1e-5,
# atol 1e-6) of the rounding boundary between the two codes
_KV_FLIP_LIMIT = 8
_KV_RTOL, _KV_ATOL = 1e-5, 1e-6


class _KVValues:
    """While active, every KV write of the plain CPU path into `cache`'s
    page pools also records the f32 value that was encoded (`shadow`, the
    pools' layout) and where it went (`written`).  The values come from
    the codec call just before the write; each write checks that they
    encode to the codes it stores.  With `forced` (pools of codes in the
    same layout) each write then stores the forced codes at its positions
    instead, so that the CPU goes on from the card's codes."""

    def __init__(self, cache, fmt, forced=None):
        import torch
        self.fmt, self.forced = fmt, forced
        self.shadow = {n: torch.zeros(cache[n].shape, dtype=torch.float32)
                       for n in ("k", "v")}
        self.written = {n: torch.zeros(cache[n].shape, dtype=torch.bool)
                        for n in ("k", "v")}
        self.layers = {cache[n][i].data_ptr(): (n, i)
                       for n in ("k", "v") for i in range(cache[n].shape[0])}

    def __enter__(self):
        import torch
        from repro_torch.kernels import posit_codec, prefill_attention
        from repro_torch.models import paged
        self.patched = [(posit_codec, "encode_plain"),
                        (prefill_attention, "encode_plain"),
                        (paged, "insert_tokens"),
                        (paged, "insert_chunk_batched")]
        self.saved = [getattr(m, n) for m, n in self.patched]
        encode, last = posit_codec.encode_plain, {}

        def record(values, fmt):
            last["x"] = values.float()
            return encode(values, fmt)

        def shadowed(insert):
            def write(pages, table, where, vals, shard=None):
                _check(shard is None, "small input: a single page pool")
                x = last.pop("x").reshape(vals.shape)
                _check(_bits_equal(encode(x, self.fmt), vals),
                       "small input: the recorded KV values encode to the "
                       "codes written")
                name, i = self.layers[pages.data_ptr()]
                insert(self.shadow[name][i], table, where, x)
                insert(self.written[name][i], table, where,
                       torch.ones_like(x, dtype=torch.bool))
                if self.forced is not None:
                    vals = _codes_at(self.forced[name][i], table, where,
                                     vals.shape)
                insert(pages, table, where, vals)
                return pages
            return write

        for (m, n), fn in zip(self.patched,
                              (record, record,
                               shadowed(self.saved[2]),
                               shadowed(self.saved[3]))):
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.patched, self.saved):
            setattr(m, n, fn)


def _codes_at(pool, table, where, shape):
    """The entries of `pool` [P, ps, F] that a write of `shape` ([B, F] one
    token, or [B, C, F] a chunk) at positions `where` [B] + [0, C) goes to
    through block table `table` (as models/paged.py's inserts place it)."""
    import torch
    ps = pool.shape[1]
    C = shape[1] if len(shape) == 3 else 1
    pos = where.long()[:, None] + torch.arange(C)[None]
    page = torch.gather(table.long(), 1,
                        torch.clamp(pos // ps, 0, table.shape[1] - 1))
    return pool[page, pos % ps].reshape(shape)


def _kv_flips(card, values, cfg, what: str) -> int:
    """Compare the card's KV codes with the CPU's wherever `values` (a
    _KVValues) saw the CPU write, and return how many differ.  A code may
    differ only by one, where the CPU's pre-encode value lies within
    rtol _KV_RTOL / atol _KV_ATOL of the rounding boundary between the
    two codes (two summation orders straddle it there)."""
    import torch
    from repro_torch.kernels import posit_codec
    fmt = cfg.quant.kv_cache
    bounds = posit_codec.rounding_boundaries(fmt)
    flips = 0
    for name in ("k", "v"):
        m = values.written[name]
        x = values.shadow[name][m]
        ca = card[name].cpu()[m].long()
        cb = posit_codec.encode_plain(x, fmt).long()
        diff = ca != cb
        if not bool(diff.any()):
            continue
        ca, cb, x = ca[diff], cb[diff], x[diff]
        lo = torch.minimum(ca.abs(), cb.abs())
        edge = bounds[(lo - 1).clamp(0, bounds.numel() - 1)]
        gap = (x.abs() - edge).abs()
        ok = (((ca - cb).abs() == 1) & (ca.sign() == cb.sign())
              & (x.sign() == cb.sign()) & (lo >= 1)
              & (gap <= _KV_ATOL + _KV_RTOL * edge))
        where = torch.nonzero(m)[diff]
        for j in range(int(diff.sum())):
            print(f"{what}: {name} code at [layer, page, row, entry] "
                  f"{where[j].tolist()} card {int(ca[j])} CPU {int(cb[j])}; "
                  f"CPU value {float(x[j])!r}, boundary {float(edge[j])!r} "
                  f"(relative gap {float(gap[j] / edge[j]):.3g})")
        _check(bool(ok.all()), f"{what}: every KV code that differs on the "
                               f"card is the adjacent one, across a rounding "
                               f"boundary the CPU's value lies on")
        flips += int(diff.sum())
    return flips


def _small_reference(dev, policy: str, arch: str = "command_r_35b",
                     page_size: int = 16, prompt: int = 20):
    """Prefill two `prompt`-token prompts (pages of `page_size` tokens) and
    take one decode step of `arch`'s
    smoke config on the card and on the CPU (the plain versions), each side
    over its own pages.  The prefill logits agree within 1e-4.  KV pages:
    float pages agree within 1e-5; posit codes are equal except where a
    value lies at a rounding boundary that the two sides' summation orders
    straddle (`_kv_flips`: the adjacent code, the value within the float
    tolerance of the boundary, at most _KV_FLIP_LIMIT of them).  The CPU
    takes the decode step twice: over its own pages, held to the card's
    logits within 1e-4 where no code differs and within 1e-3 of the largest
    |logit| where one does (an adjacent P(8,2) code moves a short window's
    attention by about that much); and over the card's codes (its prefill
    pages, and each code the card's step wrote in place of the CPU's own,
    whose values are held as above), within 1e-4.  Returns (max |logit
    diff|, codes that differ)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing
    from repro_torch.models.paged import PagedLayout
    what = f"small input ({arch}, {policy}, pages of {page_size})"
    cfg = configs.get_smoke(arch)
    cfg = cfg.replace(quant=policy_by_name(policy))
    fmt = cfg.quant.kv_cache
    cpu = torch.device("cpu")
    params = packing.pack_params(
        api.init(torch.Generator().manual_seed(7), cfg, device=cpu), cfg)
    sides = (("cpu", cpu), ("card", dev))
    on, toks, pre, step, logits = {}, {}, {}, {}, {}

    def recording(cache, forced=None):
        return (contextlib.nullcontext() if fmt is None
                else _KVValues(cache, fmt, forced))

    for side, d in sides:
        on[side] = {k: ({kk: vv.to(d) for kk, vv in v.items()}
                        if isinstance(v, dict) else v.to(d))
                    for k, v in params.items()}
        # each slot's prompt and decode token on its own run of pages
        used = -(-(prompt + 1) // page_size)
        per = max(4, used)
        max_seq = per * page_size
        cache = api.init_cache(cfg, 2, max_seq,
                               PagedLayout.for_slots(2, max_seq, page_size),
                               device=d)
        cache["block_table"] = torch.tensor(
            [[1 + s * used + j if j < used else 0 for j in range(per)]
             for s in range(2)], dtype=torch.int32, device=d)
        toks[side] = torch.arange(2 * prompt, dtype=torch.int32,
                                  device=d).reshape(2, prompt) \
            % cfg.vocab_size
        if side == "cpu":
            pre_rec = recording(cache)
        with pre_rec if side == "cpu" else contextlib.nullcontext():
            lp, pre[side] = api.prefill_chunk_batched(
                on[side], toks[side], cache,
                torch.ones(2, dtype=torch.bool, device=d), cfg)
        logits[side] = [lp.cpu()]
    card_pre = {n: pre["card"][n].cpu() for n in ("k", "v")}
    if fmt is None:
        for name in ("k", "v"):
            _check(bool(torch.allclose(card_pre[name].float(),
                                       pre["cpu"][name].float(),
                                       rtol=_KV_RTOL, atol=_KV_ATOL)),
                   f"{what}: float KV entries within 1e-5")
        flips = 0
    else:
        flips = _kv_flips(card_pre, pre_rec, cfg, what)
    forced = dict(pre["cpu"], k=card_pre["k"].clone(),
                  v=card_pre["v"].clone())
    for side, _ in sides:
        ld, step[side] = api.decode_step(on[side], toks[side][:, -1],
                                         pre[side], cfg)
        logits[side].append(ld.cpu())
    card_step = {n: step["card"][n].cpu() for n in ("k", "v")}
    if fmt is None:
        for name in ("k", "v"):
            _check(bool(torch.allclose(card_step[name].float(),
                                       step["cpu"][name].float(),
                                       rtol=_KV_RTOL, atol=_KV_ATOL)),
                   f"{what}: float KV entries within 1e-5")
        forced_logits = logits["cpu"][1]
    else:
        rec = recording(forced, card_step)
        with rec:
            forced_logits, _ = api.decode_step(on["cpu"], toks["cpu"][:, -1],
                                               forced, cfg)
        flips += _kv_flips(card_step, rec, cfg, what)
    _check(flips <= _KV_FLIP_LIMIT, f"{what}: {flips} KV codes differ "
                                    f"(limit {_KV_FLIP_LIMIT})")
    err = 0.0
    for i, (a, b) in enumerate(zip(logits["card"], logits["cpu"])):
        _check(bool(torch.isfinite(a).all()), "small-input logits finite")
        if i == 1 and flips:
            close = float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
        else:
            close = bool(torch.allclose(a, b, rtol=1e-4, atol=1e-4))
        _check(close, f"small-input logits on the card vs the plain CPU "
                      f"path ({arch}, {policy})")
        err = max(err, float((a - b).abs().max()))
    _check(bool(torch.allclose(logits["card"][1], forced_logits, rtol=1e-4,
                               atol=1e-4)),
           f"{what}: decode logits on the card vs the plain CPU path over "
           f"the card's codes")
    forced_err = float((logits["card"][1] - forced_logits).abs().max())
    return err, forced_err, flips


# ---------------------------------------------------------------------------
# phase 5: serving the main path
# ---------------------------------------------------------------------------

# label -> (tokens/s, prefill ms, prefill share of the wall) of each
# `_run_engine` run
RUN_TIMES: dict = {}


def _run_engine(cfg, params, prompts, label: str, new_tokens: int = 16,
                **kw):
    """Serve `prompts` (`new_tokens` each) on a fresh 4-slot engine, one
    step at a time; checks every request and every page, prints the run's
    numbers, and returns ({rid: tokens}, engine, launches per pure decode
    step summed over those steps, number of pure decode steps).  A pure
    decode step of a speculative engine is a round (or a plain step where
    the span falls below 2); the rounds' times are printed."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServingEngine
    engine = ServingEngine(cfg, params, batch_slots=4, **kw)
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=new_tokens))
    torch.cuda.reset_peak_memory_stats()
    decode_ms = []
    prefill_ms = []   # steps that ran a prefill chunk group
    round_ms = []
    per_step: dict = {}
    t0 = time.perf_counter()
    while engine.queue or (engine.slot_phase != 0).any():
        chunks = engine.stats["prefill_chunks"]
        rounds = engine.stats["spec_rounds"]
        before = dict(ops.launch_counts())
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        if not engine.step():
            break
        torch.cuda.synchronize()
        if engine.stats["prefill_chunks"] != chunks:
            prefill_ms.append((time.perf_counter() - s0) * 1e3)
        else:
            decode_ms.append((time.perf_counter() - s0) * 1e3)
            if engine.stats["spec_rounds"] > rounds:
                round_ms.append(decode_ms[-1])
            for k, v in ops.launch_counts().items():
                per_step[k] = per_step.get(k, 0) + v - before[k]
    wall = time.perf_counter() - t0
    done = sorted(engine.done, key=lambda r: r.rid)
    n_tok = sum(len(r.out_tokens) for r in done)
    _check(len(done) == len(prompts)
           and all(len(r.out_tokens) == new_tokens for r in done),
           f"{label}: every request served {new_tokens} tokens")
    _check(all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens),
           f"{label}: tokens in the vocabulary")
    _check(not engine.paged or engine.pages_free == engine.allocator.capacity,
           f"{label}: every page reclaimed")
    n_steps = max(len(decode_ms), 1)
    RUN_TIMES[label] = (n_tok / wall, sum(prefill_ms),
                        sum(prefill_ms) / 1e3 / wall)
    print(f"{label}: tokens {n_tok}, wall {wall:.3f} s, "
          f"{n_tok / wall:.2f} tok/s, mean decode step "
          f"{float(np.mean(decode_ms)):.3f} ms over {len(decode_ms)} "
          f"steps, peak memory {torch.cuda.max_memory_allocated()} B")
    print(f"{label}: prefill steps {len(prefill_ms)}, "
          f"{sum(prefill_ms):.3f} ms (mean "
          f"{float(np.mean(prefill_ms)) if prefill_ms else 0.0:.3f} ms a "
          f"step), {100 * sum(prefill_ms) / 1e3 / wall:.1f}% of the wall "
          f"time")
    print(f"{label}: launches per pure decode step " + json.dumps(
        {k: v / n_steps for k, v in per_step.items()}))
    print(f"{label}: stats " + json.dumps(
        {k: engine.stats[k] for k in ("shared_admissions", "pages_shared",
                                      "cow_forks", "prefill_chunks",
                                      "prefill_device_programs",
                                      "decode_steps")}
        | ({"total_allocs": engine.allocator.total_allocs,
            "peak_pages": engine.allocator.peak_in_use} if engine.paged
           else {})))
    print(f"{label}: execution_summary "
          f"{json.dumps(engine.execution_summary())}")
    if engine.speculate_k:
        s = engine.execution_summary()
        print(f"{label}: speculation k {engine.speculate_k}: rounds "
              f"{s['speculation_rounds']}, accept rate "
              f"{s['speculation_accept_rate']}, committed tokens "
              f"{s['speculation_committed_tokens']}, mean round "
              f"{float(np.mean(round_ms)) if round_ms else float('nan'):.3f}"
              f" ms over {len(round_ms)} rounds without prefill")
    print(f"{label}: first tokens {done[0].out_tokens[:8]}")
    return ({r.rid: list(map(int, r.out_tokens)) for r in done}, engine,
            per_step, len(decode_ms))


def _agreement(a: dict, b: dict):
    """(share of streams identical, share of tokens equal position-wise)."""
    same = sum(a[r] == b[r] for r in a) / len(a)
    toks = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    return same, toks / sum(len(a[r]) for r in a)


def _prefill_logit_gap(cfg, params, prompt, dev):
    """Prefill one request's prompt in the engine's chunks on a fresh cache,
    fused and decomposed; prints max |logit difference| / max |logit| and
    the kernel launches of the fused run's first chunk group."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.paged import PagedLayout
    out = []
    for fused in (True, False):
        c = cfg.replace(quant=dataclasses.replace(cfg.quant,
                                                  fused_prefill=fused))
        layout = PagedLayout.for_slots(4, 256, 16)
        cache = api.init_cache(c, 4, 256, layout, device=dev)
        cache["block_table"][0] = torch.arange(1, 17, dtype=torch.int32,
                                               device=dev)
        active = torch.tensor([True, False, False, False], device=dev)
        lo = 0
        for size in (64, 16, 16, 16, 4, 4, 1, 1, 1):
            if lo + size > len(prompt):
                continue
            toks = torch.zeros(4, size, dtype=torch.int32, device=dev)
            toks[0] = torch.from_numpy(prompt[lo:lo + size]).to(dev)
            before = dict(ops.launch_counts())
            logits, cache = api.prefill_chunk_batched(params, toks, cache,
                                                      active, c)
            if fused and lo == 0:
                print(f"{cfg.quant.activations or 'float'} activations: "
                      f"launches per {size}-token prefill chunk group "
                      + json.dumps({k: v - before[k] for k, v in
                                    ops.launch_counts().items()}))
            lo += size
        out.append(logits[0].float())
    gap = float((out[0] - out[1]).abs().max() / out[1].abs().max())
    print(f"prefill logits of request 0 ({lo} tokens, "
          f"{cfg.quant.activations or 'float'} activations), fused vs "
          f"decomposed: max |diff| / max |logit| = {gap:.3g}")
    return gap


def _float_path_checks(label, c, per_step_steps, cfg, head_t: int = 0):
    """The float weight path of a decode step at the defaults (fused
    plan, float activations, P(16,2) weights): each of the 7 x layers
    projections on the float GEMV's p16_2 variant and, with head_t, that
    many launches a step of its transposed variant (the unfused tied
    head); no K1 launch beyond the dense cache's KV rows (p8_2); and no
    K1 / GEMV variant other than the compile-time ones on the whole run."""
    per_step, n_steps = per_step_steps
    want = 7 * cfg.n_layers * n_steps
    _check(per_step.get("posit_gemv_f:p16_2", 0) == want
           and per_step.get("posit_gemv_f:p16_2_t", 0) == head_t * n_steps
           and per_step.get("posit_gemv_f", 0) == want + head_t * n_steps,
           f"'{label}': {7 * cfg.n_layers} float GEMV launches (p16_2) "
           f"{f'and {head_t} p16_2_t ' if head_t else ''}a decode step")
    _check(per_step.get("posit_decode", 0)
           == per_step.get("posit_decode:p8_2", 0),
           f"'{label}': no K1 launch on a weight in a decode step")
    _check(c["posit_gemv_f:posit"] == c["posit_gemv_f:posit_t"] == 0
           and c["posit_decode:posit"] == 0,
           f"'{label}': every K1 and float GEMV launch on a compile-time "
           f"variant")


def _serve(dev):
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.models import api, packing

    full = configs.get("command_r_35b")
    cfg = full.replace(n_layers=4, quant=policy_by_name("serve_fused_p16"))
    print(f"config: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, dtype {cfg.dtype}")
    print('reduced: ' + json.dumps({"n_layers": f"{full.n_layers} -> "
                                                f"{cfg.n_layers}"}))
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    # std-1 embeddings make the tied head's logits O(sqrt(d_model)) and
    # every greedy or sampled stream one repeated token; at std
    # 1/sqrt(d_model) the logits are O(1) and the streams vary, so the
    # stream comparisons below can fail
    params["embed"].mul_(1.0 / math.sqrt(cfg.d_model))
    params = packing.pack_params(params, cfg)
    torch.cuda.synchronize()
    print(f"init + pack on the card: {time.perf_counter() - t0:.3f} s, "
          f"weights {packing.weight_bytes(params)} B")
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, int(n))])
               .astype(np.int32) for n in rng.integers(8, 57, 8)]
    base = dict(max_seq=256, page_size=16, base_seed=1)

    # Each main-path run reads its own launch counts: set to 0 just before
    # it, read just after.  The sharing-off and decomposed runs are
    # comparisons and are not counted.
    counts = {}
    steps_of = {}   # label -> (launches per pure decode step summed, steps)

    def main_path(label, *args, **kw):
        ops.reset_launches()
        out = _run_engine(*args, label=label, **kw)
        counts[label] = ops.launch_counts()
        steps_of[label] = out[2:]
        print(f"{label}: launches {json.dumps(counts[label])}")
        return out

    # ---- phase 5: the policy's defaults (prefix sharing, fused prefill)
    greedy, eng, _, _ = main_path("defaults greedy", cfg, params, prompts,
                                  greedy=True, **base)
    summary = eng.execution_summary()
    _check(eng.prefix_sharing and summary["fused_prefill"],
           "the engine serves with prefix sharing and fused prefill on")
    _check(eng.stats["shared_admissions"] > 0, "shared admissions > 0")
    _check(summary["prefill_device_programs"] == summary["prefill_chunks"],
           "one prefill program per chunk group")
    sampled, eng_sampled, _, _ = main_path(
        "defaults sampled", cfg, params, prompts, greedy=False,
        temperature=0.8, top_k=40, **base)
    unshared = _run_engine(cfg, params, prompts, "sharing off greedy",
                           greedy=True, prefix_sharing=False, **base)[0]
    _check(unshared == greedy,
           "greedy streams with prefix sharing equal to sharing off")
    decomposed = _run_engine(cfg, params, prompts, "decomposed prefill greedy",
                             greedy=True, fused_prefill=False, **base)[0]
    same, toks = _agreement(greedy, decomposed)
    print(f"greedy streams, fused vs decomposed prefill: {same:.3f} of "
          f"streams identical, {toks:.4f} of tokens equal")
    long_prompt = rng.integers(0, cfg.vocab_size, 1100).astype(np.int32)
    _, eng, _, _ = main_path("long prompt greedy", cfg, params,
                             prompts + [long_prompt], greedy=True,
                             max_seq=1280, page_size=16, base_seed=1)
    summary = eng.execution_summary()
    _check(summary["prefill_device_programs"] == summary["prefill_chunks"],
           "long prompt: one prefill program per chunk group")
    for label in ("defaults greedy", "defaults sampled", "long prompt greedy"):
        for name in ("posit_decode", "posit_gemv_f", "posit_encode",
                     "paged_attention", "decode_sample", "prefill_attention"):
            _check(counts[label][name] > 0,
                   f"kernel {name} launched in the '{label}' run")
        _check(counts[label]["decode_sample:p16_2"]
               == counts[label]["decode_sample"],
               f"'{label}': every K4 launch took the p16_2 variant")
        _float_path_checks(label, counts[label], steps_of[label], cfg)
    _prefill_logit_gap(cfg, params, prompts[0], dev)

    # ---- phase 5b: activation-coded (serve_fused_p16_a13)
    cfg13 = cfg.replace(quant=policy_by_name("serve_fused_p16_a13"))
    coded, _, per_step, n_steps = main_path("a13 greedy", cfg13, params,
                                            prompts, greedy=True, **base)
    per_layer = 7 * cfg.n_layers
    _check(per_step.get("posit_matmul", 0) == per_layer * n_steps,
           f"K6 launched {per_layer} times per pure decode step")
    _check(per_step.get("posit_matmul:gemv_p16_2", 0) == per_layer * n_steps,
           "K6's decode-step launches take the split-K GEMV with the "
           "P(16,2) decode")
    c13 = counts["a13 greedy"]
    _check(c13["posit_matmul:tc_p16_2"] > 0 and
           c13["posit_matmul:tc_p16_2"] + c13["posit_matmul:gemv_p16_2"]
           == c13["posit_matmul"],
           "K6's prefill launches (M > 8) take the split-bf16 tensor-core "
           "GEMM with the P(16,2) decode")
    for name in ("posit_encode", "paged_attention", "decode_sample",
                 "prefill_attention", "posit_matmul"):
        _check(counts["a13 greedy"][name] > 0,
               f"kernel {name} launched in the 'a13 greedy' run")
    same, toks = _agreement(coded, greedy)
    print(f"a13 vs float-activation greedy streams: {same:.3f} of streams "
          f"identical, {toks:.4f} of tokens equal")
    _prefill_logit_gap(cfg13, params, prompts[0], dev)

    # ---- phase 5c: speculative decoding at the defaults (k = 4)
    _, diff = _verify_vs_sequential(
        cfg, params, prompts[0], greedy[0][:7], greedy[0][7:7 + SPEC_K],
        eng._chunk_sizes(len(prompts[0])), dev)
    print(f"decode_verify vs {SPEC_K} sequential decode_step calls over the "
          f"same tokens and pages (full width, bf16): max |logit diff| "
          f"{diff:.4g}")
    _check(diff == 0.0, "decode_verify logits bitwise equal to sequential "
                        "decode_step logits")
    for label, plain, plain_eng, kw in (
            ("speculative greedy", greedy, eng, dict(greedy=True)),
            ("speculative sampled", sampled, eng_sampled,
             dict(greedy=False, temperature=0.8, top_k=40))):
        spec, spec_eng, _, _ = main_path(label, cfg, params, prompts,
                                         speculate_k=SPEC_K, **kw, **base)
        for name in ("posit_decode", "posit_encode", "paged_attention",
                     "paged_attention_mq", "decode_sample",
                     "prefill_attention"):
            _check(counts[label][name] > 0,
                   f"kernel {name} launched in the '{label}' run")
        _check(spec_eng.stats["spec_rounds"] > 0, f"{label}: rounds ran")
        same, toks = _agreement(spec, plain)
        print(f"{label} vs plain decode: {same:.3f} of streams identical, "
              f"{toks:.4f} of tokens equal")
        for rid in sorted(spec):
            if spec[rid] != plain[rid]:
                _spec_divergence(cfg, params, prompts[rid], rid, plain[rid],
                                 spec[rid], plain_eng, dev, label)

    # ---- phase 5d: the async front end over a speculative engine (its
    # counts are read inside, around the front end's run alone)
    label = "front end (speculative)"
    counts[label] = _frontend_phase(cfg, params, prompts, greedy, rng, base)
    print(f"{label}: launches {json.dumps(counts[label])}")
    for name in ("posit_decode", "posit_encode", "paged_attention",
                 "paged_attention_mq", "decode_sample", "prefill_attention"):
        _check(counts[label][name] > 0,
               f"kernel {name} launched in the '{label}' run")
    _frontend_graph_check(cfg, params, prompts, greedy, base)
    return counts, cfg, cfg13, params, prompts, greedy


SPEC_K = 4


def _verify_vs_sequential(cfg, params, prompt, before, window, chunks, dev):
    """Replay one request on 4 slots (the engine's 4-row batch): prefill
    `prompt` in the engine's chunks, decode `before`, then run the tokens
    `window` once through decode_verify (logits) and once as sequential
    decode_step calls over the same pages.  Returns (the sequential logits
    of slot 0 per token, max |verify - sequential|)."""
    import torch
    from repro_torch.models import api, transformer
    from repro_torch.models.paged import PagedLayout
    B, M = 4, 16
    cache = api.init_cache(cfg, B, M * 16, PagedLayout.for_slots(B, M * 16, 16),
                           device=dev)
    cache["block_table"] = torch.arange(1, 1 + B * M, dtype=torch.int32,
                                        device=dev).reshape(B, M)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    lo = 0
    for size in chunks:
        toks = torch.from_numpy(prompt[lo:lo + size]).to(dev)[None]
        _, cache = api.prefill_chunk_batched(params, toks.repeat(B, 1),
                                             cache, active, cfg)
        lo += size
    for t in before:
        _, cache = api.decode_step(
            params, torch.full((B,), t, dtype=torch.int32, device=dev),
            cache, cfg)
    tokens = torch.tensor(window, dtype=torch.int32, device=dev)
    pools = dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
    verify, _ = transformer.decode_verify(
        params, tokens[None].repeat(B, 1), pools, cfg)
    diff = 0.0
    seq = []
    for i in range(tokens.numel()):
        logits, cache = api.decode_step(params, tokens[i].repeat(B), cache,
                                        cfg)
        seq.append(logits[0])
        diff = max(diff, float((verify[:, i] - logits).abs().max()))
    return seq, diff


def _spec_divergence(cfg, params, prompt, rid, plain, spec, plain_eng, dev,
                     label):
    """A speculative stream that differs from plain decode passes only at
    a near-tie that the verify's other summation order flips: prints the
    first differing position j, the plain run's top-two gap there, and the
    largest |difference| between decode_verify's logits and T sequential
    decode_step logits over the same tokens and pages; fails unless the
    gap is the smaller."""
    import torch
    j = next(i for i, (a, b) in enumerate(zip(plain, spec)) if a != b)
    _check(j >= 1, f"{label}: request {rid} differs at its prefill token")
    seq, diff = _verify_vs_sequential(
        cfg, params, prompt, plain[:j - 1], plain[j - 1:j - 1 + SPEC_K],
        plain_eng._chunk_sizes(len(prompt)), dev)
    l = seq[0].float()
    if plain_eng.greedy:
        score, scale = l, 1.0
    else:
        temp = plain_eng.temperature
        noise = plain_eng._default_noise(rid, j, cfg.vocab_size)
        kth = torch.topk(l / temp, plain_eng.top_k).values[-1]
        score = noise + torch.where(l / temp >= kth, l / temp,
                                    torch.full_like(l, -1e30))
        scale = temp   # a logit difference d moves a score by d / T
    top = torch.topk(score, 2).values
    gap = float(top[0] - top[1]) * scale
    print(f"{label}: request {rid} first differs from plain decode at "
          f"position {j} (plain {plain[j]}, speculative {spec[j]}); plain "
          f"top-two gap there {gap:.4g} (logit units); verify vs "
          f"sequential decode_step logits over the same tokens and pages: "
          f"max |diff| {diff:.4g}")
    _check(gap < diff, f"{label}: request {rid} differs from plain decode "
                       f"at position {j} away from a near-tie")


def _frontend_phase(cfg, params, prompts, plain, rng, base):
    """AsyncServingFrontend over a speculative engine: the 8 requests as
    batch work fill the 4 slots, then an interactive request arrives; at
    least one preemption, every streamed view equal to the request's
    final tokens and to plain decode, the pool clean.  Returns the launch
    counts of the front end's run alone (set to 0 after the plain run of
    the interactive request, read when the front end is done)."""
    import asyncio
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import AsyncServingFrontend, ServingEngine
    inter = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    ref = _run_engine(cfg, params, [inter], "plain run of the interactive "
                      "request", greedy=True, **base)[0]
    want = dict(plain) | {99: ref[0]}
    ops.reset_launches()
    eng = ServingEngine(cfg, params, batch_slots=4, greedy=True,
                        speculate_k=SPEC_K, **base)
    fe = AsyncServingFrontend(eng)
    streams: dict = {}

    def on_token(rid, idx, tok):
        out = streams.setdefault(rid, [])
        _check(idx == len(out), "front end: tokens stream in order")
        out.append(int(tok))

    async def main():
        ts = [fe.submit(p, max_new_tokens=16, slo="batch", rid=i,
                        on_token=on_token) for i, p in enumerate(prompts)]
        runner = asyncio.ensure_future(fe.run())
        while not ((eng.slot_phase == 2).all() and eng.queue):
            _check(not runner.done(), "front end: the slots filled")
            await asyncio.sleep(0)
        ti = fe.submit(inter, max_new_tokens=16, slo="interactive", rid=99,
                       on_token=on_token)
        out = {t.rid: await t.wait() for t in ts + [ti]}
        await runner
        return out

    t0 = time.perf_counter()
    got = asyncio.run(main())
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    s = fe.execution_summary()
    print(f"front end (speculative): {len(got)} requests, wall {wall:.3f} "
          f"s, preemptions {fe.preemptions}, TTFT p50 "
          f"{s['ttft_ms']['p50_ms']:.3f} / p95 {s['ttft_ms']['p95_ms']:.3f} "
          f"ms, ITL p50 {s['itl_ms']['p50_ms']:.3f} / p95 "
          f"{s['itl_ms']['p95_ms']:.3f} ms, speculation rounds "
          f"{s['speculation_rounds']}, accept rate "
          f"{s['speculation_accept_rate']}")
    _check(fe.preemptions >= 1 and eng.stats["preemptions"] >= 1,
           "front end: the interactive arrival preempted a batch slot")
    _check({r: list(map(int, t)) for r, t in got.items()} == streams,
           "front end: streamed tokens equal each request's final tokens")
    same, toks = _agreement(streams, want)
    print(f"front end (speculative) vs plain decode: {same:.3f} of streams "
          f"identical, {toks:.4f} of tokens equal")
    _check(streams == want, "front end: streams equal plain decode")
    _check(eng.pages_in_use == 0 and not eng._held and not eng.queue,
           "front end: the pool ends clean")
    return counts


def _frontend_graph_check(cfg, params, prompts, plain, base):
    """The front end over a plain engine: its decode steps, driven from
    the front end's event loop, capture the decode graph once and replay
    it every later step, and the streams equal plain decode."""
    import asyncio
    from repro_torch.serve import AsyncServingFrontend, ServingEngine
    eng = ServingEngine(cfg, params, batch_slots=4, greedy=True, **base)
    fe = AsyncServingFrontend(eng)

    async def main():
        ts = [fe.submit(p, max_new_tokens=16, slo="batch", rid=i)
              for i, p in enumerate(prompts)]
        runner = asyncio.ensure_future(fe.run())
        out = {t.rid: list(map(int, await t.wait())) for t in ts}
        await runner
        return out

    got = asyncio.run(main())
    s = eng.execution_summary()
    steps = s["decode_steps"]
    print(f"front end (graphed): {steps} decode steps, step graphs "
          f"{json.dumps(s['step_graphs'])}")
    _check(got == plain, "front end (graphed): streams equal plain decode")
    _check(steps > 2 and s["step_graphs"]["decode"]["captured"]
           and s["decode_graph_replays"] == steps - 1,
           "front end (graphed): every decode step after the first "
           "replayed the graph captured on the front end's loop")


# ---------------------------------------------------------------------------
# phase 7: bit_exact serving of command-r at full width (K8)
# ---------------------------------------------------------------------------

def _bit_exact_phase(dev):
    """command-r-35b at full width (depth 2) under validate_bit_exact: every
    projection and the tied head through the chunked-PDPU GEMM (K8), float
    bf16 KV pages (the policy has no KV format), decode_step + logits head
    + host sampler (no fused head).  4 requests of 16-32-token prompts, 8
    new tokens each, greedy; then the same at PDPU_P13_16_N8_W10.  Returns
    (the run's launch counts (from 0), cfg, params, prompts, the W_m 10
    run's counts, its K8 replay records)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.models import api, packing
    full = configs.get("command_r_35b")
    cfg = full.replace(n_layers=2, quant=policy_by_name("validate_bit_exact"))
    print('bit_exact: reduced: ' + json.dumps(
        {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"}))
    params = api.init(torch.Generator(device=dev).manual_seed(10), cfg,
                      device=dev)
    params["embed"].mul_(1.0 / math.sqrt(cfg.d_model))
    params = packing.pack_params(params, cfg)
    torch.cuda.synchronize()
    print(f"bit_exact: weights {packing.weight_bytes(params)} B "
          f"(P(13,2) codes, f32 embedding)")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 24, 32, 20)]
    ops.reset_launches()
    _, eng, per_step, n_steps = _run_engine(
        cfg, params, prompts, "bit_exact greedy", new_tokens=8, greedy=True,
        max_seq=64, page_size=16, base_seed=1)
    counts = ops.launch_counts()
    _check(not eng.fused_decode, "bit_exact decodes without the fused head")
    _check(eng.cache["k"].dtype == torch.bfloat16,
           "bit_exact pages hold bf16 floats")
    for name in ("pdpu_matmul", "posit_encode", "posit_decode",
                 "paged_attention", "prefill_attention"):
        _check(counts[name] > 0, f"kernel {name} launched in the bit_exact run")
    _check(counts["decode_sample"] == 0, "no fused head under bit_exact")
    # the policy's PDPU is the compile-time variant, and every encode
    # (activations and the tied head's re-encode) is P(13,2)'s
    for name, variant in (("pdpu_matmul", "p13_16_n4"),
                          ("posit_encode", "p13_2")):
        _check(counts[f"{name}:{variant}"] == counts[name],
               f"every bit_exact {name} launch took {variant}")
    per_token = 7 * cfg.n_layers + 1
    _check(per_step.get("pdpu_matmul", 0) == per_token * n_steps,
           f"K8 launched {per_token} times per decode step (7 projections "
           f"per layer and the head)")
    # the same weights and queue at PDPU_P13_16_N8_W10 (pdpu_n 8, pdpu_w_m
    # 10): every K8 launch on its compile-time variant, each K8 call
    # replayed bitwise against the plain version
    import dataclasses
    from repro_torch.core import formats
    from repro_torch.kernels import pdpu_dot
    cfg10 = cfg.replace(quant=dataclasses.replace(cfg.quant, pdpu_n=8,
                                                  pdpu_w_m=10))
    _check(cfg10.quant.pdpu_config() == formats.PDPU_P13_16_N8_W10
           and pdpu_dot.pdpu_variant(cfg10.quant.pdpu_config())
           == "p13_16_n8_w10", "bit_exact at W_m 10: p13_16_n8_w10")
    ops.reset_launches()
    with _capture_calls(names=("pdpu_matmul",)) as calls:
        _, eng, per_step10, n10 = _run_engine(
            cfg10, params, prompts, BIT_EXACT_W10, new_tokens=8,
            greedy=True, max_seq=64, page_size=16, base_seed=1)
    c10 = ops.launch_counts()
    print(f"{BIT_EXACT_W10}: launches {json.dumps(c10)}")
    _check(c10["pdpu_matmul"] > 0
           and c10["pdpu_matmul:p13_16_n8_w10"] == c10["pdpu_matmul"],
           f"every {BIT_EXACT_W10} K8 launch took p13_16_n8_w10")
    _check(per_step10.get("pdpu_matmul", 0) == per_token * n10,
           f"{BIT_EXACT_W10}: K8 launched {per_token} times a decode step")
    del eng
    _release()
    records = _replay_smoke_calls(BIT_EXACT_W10, calls, c10, tag="7",
                                  only=("pdpu_matmul",))
    del calls
    _release()
    return counts, cfg, params, prompts, c10, records


# ---------------------------------------------------------------------------
# phase 8: MoE serving of qwen3-moe-235b at full width (K9)
# ---------------------------------------------------------------------------

def _init_moe_packed(cfg, seed: int, dev):
    """Random parameters of `cfg` drawn and packed layer by layer (one
    layer's f32 masters, 10 GB at qwen3's width, live at a time), the
    embedding float, the untied head packed."""
    import torch
    from repro_torch.core.posit import storage_dtype
    from repro_torch.kernels import ops
    from repro_torch.models import api, packing
    from repro_torch.models.module import init_params
    fmt = cfg.quant.weights
    g = torch.Generator(device=dev).manual_seed(seed)
    specs = api.param_specs(cfg)
    packed = {p[1] for p in packing.packable_paths(cfg) if p[0] == "layers"}
    layers = {n: torch.empty(s.shape, dtype=storage_dtype(fmt) if n in packed
                             else s.dtype, device=dev)
              for n, s in specs["layers"].items()}
    one = api.param_specs(cfg.replace(n_layers=1))["layers"]
    for i in range(cfg.n_layers):
        sub = init_params(g, one, dev)
        for n, t in sub.items():
            layers[n][i] = ops.encode(t[0], fmt) if n in packed else t[0]
        del sub
    params = {"layers": layers,
              "embed": init_params(g, specs["embed"], dev),
              "final_norm": init_params(g, specs["final_norm"], dev)}
    params["head"] = ops.encode(init_params(g, specs["head"], dev), fmt)
    return params


def _moe_phase(dev):
    """qwen3-moe-235b at full width (depth cut to 4 of 94 layers) at the
    serve_fused_p16 defaults: 8 requests sharing a 64-token system prompt,
    16 new tokens each, greedy; every expert GEMM through K9.  Returns
    (launch counts of the run, cfg, params, prompts)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.models import packing
    full = configs.get("qwen3_moe_235b")
    cfg = full.replace(n_layers=4, quant=policy_by_name("serve_fused_p16"))
    print(f"MoE config: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} x {cfg.head_dim}, {cfg.n_experts} experts x "
          f"{cfg.moe_d_ff} top-{cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor}, vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}, qk_norm {cfg.qk_norm}, dtype {cfg.dtype}")
    print('MoE: reduced: ' + json.dumps(
        {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"}))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _init_moe_packed(cfg, 11, dev)
    torch.cuda.synchronize()
    print(f"MoE: init + pack layer by layer {time.perf_counter() - t0:.3f} s, "
          f"weights {packing.weight_bytes(params)} B, peak memory "
          f"{torch.cuda.max_memory_allocated()} B")
    rng = np.random.default_rng(11)
    system = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, int(n))])
               .astype(np.int32) for n in rng.integers(8, 57, 8)]
    ops.reset_launches()
    _, eng, per_step, n_steps = _run_engine(
        cfg, params, prompts, "MoE greedy", greedy=True, max_seq=256,
        page_size=16, base_seed=1)
    counts = ops.launch_counts()
    _check(not eng.batched_prefill,
           "qwen3's droppy capacity prefills slot by slot")
    _check(eng.fused_decode and eng.prefix_sharing,
           "MoE serves with the fused head and prefix sharing")
    _check(eng.stats["shared_admissions"] > 0, "MoE: shared admissions > 0")
    for name in ("posit_matmul_grouped", "posit_decode", "posit_encode",
                 "paged_attention", "decode_sample", "prefill_attention"):
        _check(counts[name] > 0, f"kernel {name} launched in the MoE run")
    for name in ("posit_matmul_grouped", "decode_sample"):
        _check(counts[f"{name}:p16_2"] == counts[name],
               f"every {name} launch of the MoE run took the p16_2 variant")
    per_layer = 3 * cfg.n_layers
    _check(per_step.get("posit_matmul_grouped", 0) == per_layer * n_steps,
           f"K9 launched {per_layer} times per decode step")
    return counts, cfg, params, prompts


# ---------------------------------------------------------------------------
# phase 6: where a decode step's device time goes
# ---------------------------------------------------------------------------

# kernel-name fragments -> the layer that launched the kernel
_KERNEL_GROUPS = (("posit_gemv_f", "K1 float GEMV (posit_gemv_f)"),
                  ("grouped_", "K9 posit_matmul_grouped"),
                  ("pdpu_matmul", "K8 pdpu_matmul"),
                  ("posit_decode", "K1 posit_decode"),
                  ("posit_encode", "K2 posit_encode"),
                  ("paged_attention_mq", "K7 paged_attention_mq"),
                  ("attn_shard_merge", "merge_attn_partials"),
                  ("paged_attention", "K3 paged_attention"),
                  ("ds_", "K4 decode_sample"),
                  ("prefill_attention", "K5 prefill_attention"),
                  ("posit_matmul", "K6 posit_matmul"),
                  ("gemm", "torch.matmul"), ("gemv", "torch.matmul"))


def _profile(cfg, params, prompts, label: str, steps: int = 4,
             speculate_k: int = 0, **kw):
    """torch.profiler over `steps` greedy decode steps (speculative rounds
    with speculate_k) with 4 slots busy: device time per step by layer,
    and the device's busy share of the window of as many steps run just
    before without the profiler (host clock, ending in a synchronize).  `kw` overrides the engine's max_seq 256 and page size
    16, or serves the dense cache (paged=False), or samples (greedy=False
    and its knobs).  Returns {"step_ms": unprofiled ms a step, "busy_ms":
    device ms a step (None when the profiler recorded none)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request, ServingEngine
    engine = ServingEngine(cfg, params, batch_slots=4,
                           speculate_k=speculate_k,
                           **dict(dict(greedy=True, max_seq=256,
                                       page_size=16), **kw))
    for rid, p in enumerate(prompts[:4]):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=16))
    engine.step()   # prefill of all four, then their first decode step
    engine.step()
    _check(bool((engine.slot_phase == 2).all()), "profile: four slots decode")
    # the same number of steps without the profiler first: its host-side
    # tracing lengthens a host-bound step's window many times over
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    rounds = engine.stats["spec_rounds"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if speculate_k:
        _check(engine.stats["spec_rounds"] == rounds + steps,
               "profile: every profiled step is a speculative round")
    groups: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or not evt.self_device_time_total:
            continue
        group = next((g for frag, g in _KERNEL_GROUPS if frag in evt.key),
                     "other torch ops")
        groups[group] = groups.get(group, 0.0) + evt.self_device_time_total
    busy = sum(groups.values())
    print(f"profile {label}: {steps} "
          f"{'speculative rounds' if speculate_k else 'decode steps'}, "
          f"4 slots, wall {plain_us / steps / 1e3:.3f} ms/step without the "
          f"profiler ({wall_us / steps / 1e3:.3f} under it), device busy "
          f"{busy / steps / 1e3:.3f} ms/step ({100 * busy / plain_us:.1f}% "
          f"of the unprofiled window)"
          if busy else f"profile {label}: the profiler recorded no device "
          f"time (not measured)")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}: {group}: {us / steps / 1e3:.3f} ms/step "
              f"({100 * us / busy:.1f}% of device time)")
    return {"step_ms": plain_us / steps / 1e3,
            "busy_ms": busy / steps / 1e3 if busy else None}


# ---------------------------------------------------------------------------
# phase 9: QAT training (STE autograd over K2 / K6 / K1) at full width
# ---------------------------------------------------------------------------

# minitron-8b at full width, depth cut from 32 layers to 4 for one card:
# 3.07e9 parameters, whose f32 masters, gradients and AdamW moments take
# 49 GB, the head's codes and decoded copy 6.3 GB more
TRAIN_LAYERS = 4
TRAIN_LABEL = "train minitron-8b"
TRAIN_STEPS = 4
TRAIN_ACCUM = 2
# the rows of a microbatch (4 x 128 tokens) through each coded GEMM
TRAIN_M = 512


def _train_shape():
    from repro_torch.models.config import ShapeConfig
    return ShapeConfig("ex", seq_len=128, global_batch=8, kind="train")


def _trainer(cfg, dev, steps, ckpt_dir=None, optimizer="adamw",
             peak_lr=3e-3, shape=None):
    """The training example's trainer: 8 x 128 tokens a step (or `shape`)
    in 2 microbatches, AdamW (or `optimizer`) with its cosine schedule
    (peak 3e-3 unless `peak_lr`)."""
    from repro_torch.data import Pipeline
    from repro_torch.optim import by_name, cosine_schedule
    from repro_torch.train import Trainer, TrainerConfig
    shape = shape or _train_shape()
    opt = by_name(optimizer, cosine_schedule(peak_lr, warmup=steps // 10,
                                             total=steps))
    return Trainer(cfg, shape, opt, Pipeline(cfg, shape),
                   TrainerConfig(total_steps=steps, log_every=1,
                                 ckpt_every=steps, ckpt_dir=ckpt_dir,
                                 accum=TRAIN_ACCUM, async_ckpt=False),
                   device=dev)


def _train_full_width(dev):
    """9a: minitron-8b (4 of 32 layers) under paper_mixed fused, 4 steps of
    8 x 128 tokens in 2 microbatches through Pipeline and Trainer, counted
    from 0; then one more step under torch.profiler.  Returns the run's
    launch counts."""
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    cfg = configs.get("minitron_8b").replace(
        n_layers=TRAIN_LAYERS,
        quant=policy_by_name("paper_mixed").with_execution("fused"))
    return _qat_full_width(dev, cfg, "train minitron-8b", 7,
                           "of 32 layers, d_model 4096, vocab 256000")


def _qat_full_width(dev, cfg, label: str, gemms: int, about: str,
                    shape=None, peak_lr=3e-3):
    """`cfg` (a dense-trunk, SSM or stub-frontend config at full width, its
    plan paper_mixed fused) trained TRAIN_STEPS steps of `shape` (phase 9's
    8 x 128 tokens unless given) in TRAIN_ACCUM microbatches through
    Pipeline and Trainer (AdamW, remat per layer), counted from 0: finite
    losses (peak learning rate `peak_lr`); each layer's `gemms` coded
    GEMMs on K6 `tc`, in the forward
    and again in the remat recompute; K2 on `p13_2` (each GEMM's weights
    and activations, twice, and the head's weights); K1 on `p13_2` (each
    GEMM's two codes in the backward, the head's forward and backward).
    Prints the median step, tokens/s and peak memory, then profiles one
    more step.  Returns the run's launch counts."""
    import torch
    from repro_torch.kernels import ops
    tr = _trainer(cfg, dev, TRAIN_STEPS, shape=shape, peak_lr=peak_lr)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state = tr.run(torch.Generator(device=dev).manual_seed(9))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    _check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
           f"{label}: {TRAIN_STEPS} finite losses")
    L, mb = cfg.n_layers, TRAIN_STEPS * TRAIN_ACCUM
    _check(counts["posit_matmul:tc"] == gemms * L * mb * 2
           and counts["posit_matmul"] == counts["posit_matmul:tc"],
           f"{label}: every K6 launch on tc, {gemms} x {L} x {mb} x 2")
    _check(counts["posit_encode:p13_2"] == mb * (4 * gemms * L + 1)
           and counts["posit_encode"] == counts["posit_encode:p13_2"],
           f"{label}: every K2 launch on p13_2, {mb} x ({4 * gemms} x {L} "
           f"+ 1)")
    _check(counts["posit_decode"] == mb * (2 * gemms * L + 2)
           and counts["posit_decode:p13_2"] == counts["posit_decode"],
           f"{label}: every K1 launch on p13_2, {mb} x ({2 * gemms} x {L} "
           f"+ 2)")
    times = sorted(h["time_s"] for h in tr.history[1:])
    step_ms = times[len(times) // 2] * 1e3
    tokens = tr.shape.tokens
    print(f"{label} ({L} {about}, paper_mixed fused, {tokens} tokens a "
          f"step in {TRAIN_ACCUM} microbatches): losses "
          f"{[round(x, 4) for x in losses]}, median step over steps 2-"
          f"{TRAIN_STEPS} {step_ms:.3f} ms (steps "
          f"{[round(h['time_s'] * 1e3, 3) for h in tr.history]} ms), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 1e9:.3f} GB")
    print(f"{label}: launches {json.dumps(counts)}")
    _profile_train_step(tr, state, f"{label} step")
    del state, tr
    return counts


def _profile_train_step(tr, state, label: str):
    """One more step of `tr` from `state` under torch.profiler: device
    time by kernel group, the largest kernels of the rest, and the host's
    share of the step."""
    batch = tr._to_device(tr.pipeline.batch_at(int(state.step)))
    _profile_step(lambda: tr.train_step(state, batch)[1], label)


def _profile_step(step, label: str):
    """`step()` (a training step returning its metrics) under
    torch.profiler: device time by kernel group, the largest kernels of
    the rest, and the host's share of the step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step()
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups: dict = {}
    other: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or not evt.self_device_time_total:
            continue
        group = next((g for frag, g in _KERNEL_GROUPS if frag in evt.key),
                     "attention and other torch ops")
        groups[group] = groups.get(group, 0.0) + evt.self_device_time_total
        if group.startswith("attention"):
            other[evt.key] = other.get(evt.key, 0.0) + evt.self_device_time_total
    busy = sum(groups.values())
    if busy:
        print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), host and "
              f"idle {(wall_us - busy) / 1e3:.3f} ms")
        for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"profile {label}: {group}: {us / 1e3:.3f} ms "
                  f"({100 * us / busy:.1f}% of device time)")
        # the largest kernels of the last group (elementwise, reductions,
        # indexing: the optimizer, the loss, the embedding's gradient)
        for key, us in sorted(other.items(), key=lambda kv: -kv[1])[:8]:
            print(f"profile {label}:   other: {us / 1e3:.3f} ms "
                  f"{key[:110]}")
    else:
        print(f"profile {label}: the profiler recorded no device time "
              f"(not measured)")


def _dense_kn(cfg):
    """A layer's coded GEMMs outside the routed experts, (name, K, N): the
    attention projections, then the dense FFN or, in the MoE family, the
    shared experts (n_shared x moe_d_ff wide; none in qwen3-moe); an SSM
    layer's in_proj and out_proj."""
    D = cfg.d_model
    if cfg.family == "ssm":
        Di = cfg.ssm_d_inner
        return (("in_proj", D, 2 * Di + 2 * cfg.ssm_state + cfg.ssm_heads),
                ("out_proj", Di, D))
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    kn = [("wq", D, q), ("wk", D, kv), ("wv", D, kv), ("wo", q, D)]
    F = (cfg.n_shared_experts * cfg.moe_d_ff if cfg.family == "moe"
         else cfg.d_ff)
    if F:
        kn += [("gate", D, F), ("up", D, F), ("down", F, D)]
    return tuple(kn)


def _expert_kn(cfg):
    """A layer's routed expert GEMMs (K, N): gate, up, down."""
    D, F = cfg.d_model, cfg.moe_d_ff
    return ((D, F), (D, F), (F, D))


def _train_ste(dev, label: str, arch: str, M: int = TRAIN_M):
    """9b / 11d / 14: the STE function at M rows (a microbatch's, 512
    unless given) on each distinct (K, N) of `arch`'s coded GEMMs outside
    the routed experts (`_dense_kn`): the
    forward within `sum_bound` of `ops.ste_plain` (a limit two planted
    faults must fail), dx and dw bitwise the plain version's and the
    fake_quant plan's for the same g."""
    import torch
    from repro_torch import configs
    from repro_torch.core.formats import P13_2
    from repro_torch.core.quant import QuantPolicy
    from repro_torch.kernels import dispatch, ops, posit_codec
    from repro_torch.kernels import posit_matmul as pm
    g = torch.Generator(device=dev).manual_seed(19)
    fake_quant = QuantPolicy(weights=P13_2, activations=P13_2)
    shapes = {}
    for name, K, N in _dense_kn(configs.get(arch)):
        shapes.setdefault((K, N), []).append(name)
    for (K, N), names in shapes.items():
        what = f"STE {label} {' / '.join(names)} (M {M}, K {K}, N {N})"
        x = torch.randn(M, K, generator=g, device=dev)
        w = torch.randn(K, N, generator=g, device=dev) / math.sqrt(K)
        gr = torch.randn(M, N, generator=g, device=dev)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = ops.launch_counts()["posit_matmul:tc"]
        out = ops.fused_matmul_ste(xr, wr, P13_2, P13_2)
        _check(ops.launch_counts()["posit_matmul:tc"] == before + 1,
               f"{what}: the forward ran K6 on tc")
        dx, dw = torch.autograd.grad(out, (xr, wr), gr)
        want, want_dx, want_dw = ops.ste_plain(x, w, P13_2, P13_2, gr)
        a = posit_codec.encode_plain(x, P13_2)
        b = posit_codec.encode_plain(w, P13_2)
        bound = pm.sum_bound(a, b, P13_2, P13_2)
        gap = (out.detach() - want).abs()
        _check(bool((gap <= bound).all()),
               f"{what}: the forward within sum_bound of the plain version")
        planted = _planted_faults(what, posit_codec.decode(a, P13_2),
                                  posit_codec.decode(b, P13_2), want, bound)
        _check(_bits_equal(dx, want_dx) and _bits_equal(dw, want_dw),
               f"{what}: dx, dw bitwise the plain version's")
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        fq = torch.autograd.grad(dispatch.qdot(xr, wr, fake_quant), (xr, wr),
                                 gr)
        _check(_bits_equal(dx, fq[0]) and _bits_equal(dw, fq[1]),
               f"{what}: dx, dw bitwise the fake_quant plan's")
        print(f"{what}: forward max |err| {float(gap.max()):.4g} (largest "
              f"in u sqrt(K) ||ab|| {_units(gap, bound):.4g}, limit "
              f"{pm.SUM_TOL}; planted: {planted}); dx, dw bitwise the plain "
              f"version's and the fake_quant plan's")
        del x, w, gr, out, dx, dw, want, want_dx, want_dw, a, b, bound, fq


def _train_kernels(dev, label: str, arch: str, M: int = TRAIN_M):
    """9 / 11d / 14: `arch`'s training shapes of K6, K2 and K1, each
    against its plain version and timed: K6 tc (P(13,2) x P(13,2)) at M
    rows (512 unless given) over its coded GEMMs outside the routed
    experts (`_dense_kn`), within `sum_bound` with two planted faults; K2
    p13_2 and K1 P(13,2) over its head's masters ([d_model, vocab]
    elements), bitwise.  Returns three records whose launches are those
    of the run `label`."""
    import torch
    from repro_torch import configs
    from repro_torch.core.formats import P13_2
    from repro_torch.kernels import posit_codec
    from repro_torch.kernels import posit_matmul as pm
    from repro_torch.kernels import work
    cfg = configs.get(arch)
    g = torch.Generator(device=dev).manual_seed(29)
    layer = []
    err = ratio = 0.0
    for name, K, N in _dense_kn(cfg):
        what = f"K6 {label} {name} (M {M}, K {K}, N {N}, tc, P(13,2) x P(13,2))"
        a = posit_codec.encode(torch.randn(M, K, generator=g, device=dev),
                               P13_2)
        b = posit_codec.encode(torch.randn(K, N, generator=g, device=dev)
                               / math.sqrt(K), P13_2)
        got = pm.posit_matmul(a, b, P13_2, P13_2)
        want = pm.posit_matmul_plain(a, b, P13_2, P13_2)
        bound = pm.sum_bound(a, b, P13_2, P13_2)
        gap = (got - want).abs()
        _check(bool((gap <= bound).all()), f"{what} within sum_bound")
        A, B = posit_codec.decode(a, P13_2), posit_codec.decode(b, P13_2)
        planted = _planted_faults(what, A, B, want, bound)
        err = max(err, float(gap.max()))
        ratio = max(ratio, _units(gap, bound))
        ms = _device_ms(lambda: pm.posit_matmul(a, b, P13_2, P13_2),
                        launches=3)
        lib = _device_ms(lambda: torch.matmul(A, B), launches=3)
        mm_work = work.matmul(M, K, N, 2, 2, 4, "tc")
        f32_bound, f32_by = _bound(_f32_form(mm_work))
        tc_bound, tc_by = _bound(mm_work)
        print(f"{what}: largest err in u sqrt(K) ||ab|| "
              f"{_units(gap, bound):.4g} (planted: {planted}); ms {ms:.4f}, "
              f"bound_ms {tc_bound:.4f} ({tc_by}, the exact split-bf16 form: "
              f"4 bf16 products a multiply-add), f32 bound {f32_bound:.4f} "
              f"({f32_by}), library_ms (torch.matmul, decoded f32) {lib:.4f}")
        layer.append((a, b, A, B, mm_work))
        del got, want, bound, gap

    def run():
        for a, b, *_ in layer:
            pm.posit_matmul(a, b, P13_2, P13_2)

    ms = _device_ms(run, launches=1)
    plain_ms = _time_once_ms(lambda: [pm.posit_matmul_plain(a, b, P13_2, P13_2)
                                      for a, b, *_ in layer])
    library_ms = _device_ms(lambda: [torch.matmul(A, B)
                                     for _, _, A, B, *_ in layer], launches=1)
    layer_work = work.total(r[4] for r in layer)
    bound, by = _bound(layer_work)
    f32_bound, _ = _bound(_f32_form(layer_work))
    n = len(layer)
    print(f"K6 {label} layer ({n} projections at M {M}): ms {ms:.4f}, "
          f"bound_ms {bound:.4f} ({by}; f32 {f32_bound:.4f}), plain_ms "
          f"{plain_ms:.3f}, library_ms {library_ms:.4f}; largest err in "
          f"sum_bound units {ratio:.4g}")
    del layer
    paths = (label,)
    records = [dict(name=f"posit_matmul (training: tc, P(13,2) x P(13,2), "
                         f"M {M}, {arch}'s {n} projections)",
                    counter="posit_matmul:tc", paths=paths,
                    source="src/repro_torch/csrc/posit_matmul.cu",
                    replaces="src/repro/kernels/posit_matmul.py:168",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=by, library_ms=library_ms)]
    # the head's codec: [d_model, vocab] f32 masters -> P(13,2) and back
    head = [cfg.d_model, cfg.vocab_size]
    x = torch.randn(*head, generator=g, device=dev) / 64
    codes = posit_codec.encode(x, P13_2)
    t0 = time.perf_counter()
    plain_codes = posit_codec.encode_plain(x, P13_2)
    torch.cuda.synchronize()
    enc_plain_ms = (time.perf_counter() - t0) * 1e3
    _check(_bits_equal(codes, plain_codes),
           f"K2 p13_2 at {arch}'s head {head} bitwise its plain version")
    del plain_codes
    enc_ms = _device_ms(lambda: posit_codec.encode(x, P13_2), launches=3)
    n = x.numel()
    enc_bound, enc_by = _bound(work.encode(n, codes.element_size()))
    del x
    vals = posit_codec.decode(codes, P13_2)
    t0 = time.perf_counter()
    plain_vals = posit_codec.decode_plain(codes, P13_2)
    torch.cuda.synchronize()
    dec_plain_ms = (time.perf_counter() - t0) * 1e3
    _check(_bits_equal(vals, plain_vals),
           f"K1 P(13,2) at {arch}'s head {head} bitwise its plain version")
    del plain_vals, vals
    dec_ms = _device_ms(lambda: posit_codec.decode(codes, P13_2), launches=3)
    dec_bound, dec_by = _bound(work.decode(n, codes.element_size()))
    del codes
    print(f"K2 {label} head {head} f32 -> P(13,2) (p13_2): ms {enc_ms:.4f}, "
          f"bound_ms {enc_bound:.4f} ({enc_by}), plain_ms {enc_plain_ms:.3f}; "
          f"K1 P(13,2) -> f32 (p13_2): ms {dec_ms:.4f}, bound_ms "
          f"{dec_bound:.4f} ({dec_by}), {dec_bound / dec_ms:.3f} of the "
          f"bound, plain_ms {dec_plain_ms:.3f}")
    records.append(dict(name=f"posit_encode (training: p13_2, {arch}'s head "
                             f"{head})",
                        counter="posit_encode:p13_2", paths=paths,
                        source="src/repro_torch/csrc/posit_codec.cu",
                        replaces="src/repro/kernels/posit_codec.py:78",
                        max_abs_err=0.0, ms=enc_ms, plain_ms=enc_plain_ms,
                        bound_ms=enc_bound, bound_by=enc_by, library_ms=None))
    records.append(dict(name=f"posit_decode:p13_2 (training: {arch}'s head "
                             f"{head})",
                        counter="posit_decode:p13_2", paths=paths,
                        source="src/repro_torch/csrc/posit_codec.cu",
                        replaces="src/repro/kernels/posit_codec.py:55",
                        max_abs_err=0.0, ms=dec_ms, plain_ms=dec_plain_ms,
                        bound_ms=dec_bound, bound_by=dec_by, library_ms=None))
    return records


def _train_small_reference(dev, arch: str = "minitron_8b", tag: str = "9c"):
    """9c / 11d: 3 Trainer steps of `arch`'s SMOKE config (f32) under
    paper_mixed fused on the card against the same steps on the CPU (the
    plain versions), from one initial state (a checkpoint both trainers
    restore).  Returns the card's trainer (for 9e) and the checkpoints'
    directory."""
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.quant import policy_by_name
    from repro_torch.train import step as step_lib
    cfg = configs.get_smoke(arch).replace(
        quant=policy_by_name("paper_mixed").with_execution("fused"))
    root = os.path.join(HERE, "build", f"chip_smoke_train_{arch}")
    shutil.rmtree(root, ignore_errors=True)
    losses = {}
    trainers = {}
    for label, d in (("cpu", torch.device("cpu")), ("card", dev)):
        ckpt = os.path.join(root, label)
        tr = _trainer(cfg, d, 3, ckpt_dir=ckpt)
        CheckpointManager(ckpt).save(0, step_lib.init_state(
            torch.Generator().manual_seed(3), cfg, tr.opt, "cpu"))
        tr.run(torch.Generator(device=d))
        losses[label] = [h["loss"] for h in tr.history]
        trainers[label] = tr
    _check(len(losses["card"]) == 3
           and all(map(math.isfinite, losses["card"])),
           f"{tag}: 3 finite losses on the card ({arch} smoke)")
    # P(13,2) rounds every activation: an f32 sum taken in another order
    # on the card can land an activation on the adjacent code, so the
    # losses are held to 1e-3 of their size, not bitwise
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                  losses["cpu"]))
    _check(gap <= 1e-3, f"{tag}: card and CPU losses within 1e-3 ({arch} "
                        f"smoke)")
    print(f"{tag} small input ({arch} smoke, paper_mixed fused, 3 steps): "
          f"card {losses['card']}, CPU {losses['cpu']}, largest relative "
          f"gap {gap:.3g} (limit 1e-3)")
    return trainers["card"], root


def _train_example(dev):
    """9d: the training example's `run` at smoke size on the card, float
    and paper_mixed fused, 50 steps each: the mean loss of the last 10
    steps below the first step's."""
    sys.path.insert(0, os.path.join(HERE, "examples"))
    import train_posit_lm_torch as example
    for quant, execution in (("none", "fake_quant"), ("paper_mixed", "fused")):
        t0 = time.perf_counter()
        losses = example.run(quant, 50, "minitron_8b", execution,
                             device=dev.type)
        wall = time.perf_counter() - t0
        tail = sum(losses[-10:]) / 10
        _check(len(losses) == 50 and all(map(math.isfinite, losses))
               and tail < losses[0],
               f"9d: the example ({quant}, {execution}) lowers its loss")
        print(f"9d example minitron-8b smoke {quant} ({execution}): first "
              f"loss {losses[0]:.4f}, mean of the last 10 {tail:.4f}, 50 "
              f"steps in {wall:.2f} s")


def _train_checkpoint(tr, root):
    """9e: an async save of the card trainer's state, wait, restore:
    bitwise."""
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.train import step as step_lib
    gen = torch.Generator(device=tr.device).manual_seed(4)
    state = step_lib.init_state(gen, tr.cfg, tr.opt, tr.device)
    state, _ = tr.train_step(state, tr._to_device(tr.pipeline.batch_at(0)))
    mgr = CheckpointManager(os.path.join(root, "roundtrip"), keep_last=1)
    mgr.save_async(1, state)
    mgr.wait()
    back = mgr.restore(1, state)
    want, got = _flatten(state), _flatten(back)
    _check(set(want) == set(got) and all(
        got[k].device == want[k].device and _bits_equal(got[k], want[k])
        for k in want), "9e: the train state's checkpoint round trip bitwise")
    print(f"9e checkpoint: {len(want)} arrays of the smoke train state "
          f"saved async, restored on the card, bitwise")
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 11: MoE QAT training at full width (the grouped STE over K2 / K9 /
# K1, K9 at the capacity rows of a 512-token microbatch)
# ---------------------------------------------------------------------------

# (arch, layers, optimizer).  qwen3-moe-235b: one layer holds 2.42e9 expert
# parameters, 3.73e9 with the untied 151936-row embedding and head; the
# f32 masters, gradients, AdamW's two moments and its new updates (20 B a
# parameter, 74.6 GB) leave no room on an 80 GB card for the update's
# temporaries, so one layer trains with adafactor (factored second moment,
# 12 B a parameter).  deepseek-moe-16b: 4 of 28 layers, 2.77e9 parameters,
# AdamW.
MOE_TRAIN = (("qwen3_moe_235b", 1, "adafactor"),
             ("deepseek_moe_16b", 4, "adamw"))
# the peak learning rate of the MoE runs, DeepSeekMoE 16B's published one
# (arXiv:2401.06066): at the training example's 3e-3 a full-width random
# init diverges in its first step and the router sends most tokens to a
# few experts
MOE_PEAK_LR = 4.2e-4


def _moe_train_full_width(dev, arch: str, layers: int, optimizer: str):
    """11a / 11b: `arch` at full width (`layers` of its depth) under
    paper_mixed fused, 4 steps of 8 x 128 tokens in 2 microbatches through
    Pipeline and Trainer (remat per layer; peak learning rate
    MOE_PEAK_LR), counted from 0: finite losses,
    every K9 launch on the tensor-core variant `tc_p13_2` (both operands
    P(13,2) codes, the capacity rows above 8), 3 x layers x microbatches x
    2 of them (forward and the remat recompute), every K6 launch on `tc`, every K2 launch on `p13_2`; median
    step, tokens/s, peak memory; then one more step profiled.  Returns
    (label, the run's launch counts)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    full = configs.get(arch)
    cfg = full.replace(
        n_layers=layers,
        quant=policy_by_name("paper_mixed").with_execution("fused"))
    label = f"train {arch}"
    T = _train_shape().tokens // TRAIN_ACCUM
    C = moe.capacity(cfg, T)
    print(f"{label}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} x {cfg.head_dim}, {cfg.n_experts} experts x "
          f"{cfg.moe_d_ff} top-{cfg.top_k} (+{cfg.n_shared_experts} shared), "
          f"capacity factor {cfg.capacity_factor}: {C} rows an expert for "
          f"{T} tokens, vocab {cfg.vocab_size}, {optimizer}; reduced "
          + json.dumps({"n_layers": f"{full.n_layers} -> {layers}"}))
    _release()
    tr = _trainer(cfg, dev, TRAIN_STEPS, optimizer=optimizer,
                  peak_lr=MOE_PEAK_LR)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state = tr.run(torch.Generator(device=dev).manual_seed(13))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    _check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
           f"{label}: {TRAIN_STEPS} finite losses")
    mb = TRAIN_STEPS * TRAIN_ACCUM
    dense = 4 + (3 if cfg.n_shared_experts else 0)   # K6 GEMMs a layer
    _check(counts["posit_matmul_grouped"] == 3 * layers * mb * 2
           and counts["posit_matmul_grouped:tc_p13_2"]
           == counts["posit_matmul_grouped"],
           f"{label}: every K9 launch on tc_p13_2, 3 x {layers} x {mb} x 2")
    _check(counts["posit_matmul:tc"] == dense * layers * mb * 2
           and counts["posit_matmul"] == counts["posit_matmul:tc"],
           f"{label}: every K6 launch on tc, {dense} x {layers} x {mb} x 2")
    # K2: each coded GEMM's weights and activations, in the forward and the
    # recompute, and the head's weights; K1: each coded GEMM's two codes in
    # the backward, the head's in its forward and backward
    gemms = dense + 3
    _check(counts["posit_encode:p13_2"] == mb * (4 * gemms * layers + 1)
           and counts["posit_encode"] == counts["posit_encode:p13_2"],
           f"{label}: every K2 launch on p13_2, {mb} x (4 x {gemms} x "
           f"{layers} + 1)")
    _check(counts["posit_decode"] == mb * (2 * gemms * layers + 2)
           and counts["posit_decode:p13_2"] == counts["posit_decode"],
           f"{label}: every K1 launch on p13_2, {mb} x (2 x {gemms} x "
           f"{layers} + 2)")
    times = sorted(h["time_s"] for h in tr.history[1:])
    step_ms = times[len(times) // 2] * 1e3
    tokens = tr.shape.tokens
    print(f"{label} ({layers} of {full.n_layers} layers, paper_mixed fused, "
          f"{optimizer}, {tokens} tokens a step in {TRAIN_ACCUM} "
          f"microbatches): losses {[round(x, 4) for x in losses]}, median "
          f"step over steps 2-{TRAIN_STEPS} {step_ms:.3f} ms (steps "
          f"{[round(h['time_s'] * 1e3, 3) for h in tr.history]} ms), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 1e9:.3f} GB")
    print(f"{label}: launches {json.dumps(counts)}")
    _profile_train_step(tr, state, f"{label} step")
    del state, tr
    _release()
    return label, counts


def _k9_train(dev, arch: str, train_label: str):
    """11c: the grouped STE (`ops.fused_matmul_grouped_ste`, P(13,2) x
    P(13,2)) at `arch`'s training shape, its E experts of the capacity
    rows `moe.capacity` gives a microbatch: at the gate and down shapes the
    forward within `sum_bound` of `ops.ste_plain` (a limit two planted
    faults must fail), dx and dw bitwise its; then K9 over the layer's
    three expert GEMMs on codes (as the forward runs it, on `tc_p13_2`),
    bitwise equal on a second call, expert 0 bitwise its E = 1 call,
    timed beside its plain version, torch.bmm on the decoded f32 stacks
    and the bound: bytes, or the exact form's operations (4 bf16 products
    a multiply-add at the bf16 rate), the larger.
    Returns the kernel record, whose launches are those of the run
    `train_label`."""
    import torch
    from repro_torch import configs
    from repro_torch.core.formats import P13_2
    from repro_torch.kernels import ops, posit_codec
    from repro_torch.kernels import posit_matmul as pm
    from repro_torch.kernels import work
    from repro_torch.models import moe
    cfg = configs.get(arch)
    E, layer_kn = cfg.n_experts, _expert_kn(cfg)
    M = moe.capacity(cfg, _train_shape().tokens // TRAIN_ACCUM)
    g = torch.Generator(device=dev).manual_seed(31)
    err = ratio = 0.0
    for K, N in (layer_kn[0], layer_kn[2]):
        x = torch.randn(E, M, K, generator=g, device=dev)
        w = torch.randn(E, K, N, generator=g, device=dev) / math.sqrt(K)
        gr = torch.randn(E, M, N, generator=g, device=dev)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = ops.launch_counts()["posit_matmul_grouped:tc_p13_2"]
        out = ops.fused_matmul_grouped_ste(xr, wr, P13_2, P13_2)
        _check(ops.launch_counts()["posit_matmul_grouped:tc_p13_2"]
               == before + 1,
               f"11c {arch} K={K}: the grouped STE forward ran K9 on "
               f"tc_p13_2")
        dx, dw = torch.autograd.grad(out, (xr, wr), gr)
        del xr, wr
        want, want_dx, want_dw = ops.ste_plain(x, w, P13_2, P13_2, gr)
        _check(_bits_equal(dx, want_dx) and _bits_equal(dw, want_dw),
               f"11c {arch} K={K} N={N}: dx, dw bitwise the plain version's")
        del dx, dw, want_dx, want_dw, gr
        a = posit_codec.encode_plain(x, P13_2)
        b = posit_codec.encode_plain(w, P13_2)
        bound = pm.sum_bound(a, b, P13_2, P13_2)
        gap = (out.detach() - want).abs()
        _check(bool((gap <= bound).all()),
               f"11c {arch} E={E} M={M} K={K} N={N}: the grouped STE forward "
               f"within {pm.SUM_TOL} u sqrt(K) ||ab|| of the plain version")
        units = _units(gap, bound)
        err, ratio = max(err, float(gap.max())), max(ratio, units)
        planted = _planted_faults(
            f"11c {arch} K={K}", posit_codec.decode(a, P13_2),
            posit_codec.decode(b, P13_2), want, bound)
        print(f"11c grouped STE {arch} (E {E}, M {M}, K {K}, N {N}): forward "
              f"max |err| {float(gap.max()):.4g}, largest in u sqrt(K) "
              f"||ab|| {units:.4g} (limit {pm.SUM_TOL}; planted: "
              f"{planted}); dx, dw bitwise the plain version's")
        del x, w, out, want, a, b, bound, gap
        torch.cuda.empty_cache()
    acts = {K: posit_codec.encode(torch.randn(E, M, K, generator=g,
                                              device=dev), P13_2)
            for K in {K for K, _ in layer_kn}}
    layer = [(acts[K], posit_codec.encode(torch.randn(
        E, K, N, generator=g, device=dev) / math.sqrt(K), P13_2))
        for K, N in layer_kn]

    for a, b in layer:
        before = ops.launch_counts()["posit_matmul_grouped:tc_p13_2"]
        first = pm.posit_matmul_grouped(a, b, P13_2, P13_2)
        _check(ops.launch_counts()["posit_matmul_grouped:tc_p13_2"]
               == before + 1, f"11c {arch}: K9 ran on tc_p13_2")
        _check(_bits_equal(pm.posit_matmul_grouped(a, b, P13_2, P13_2),
                           first), f"11c {arch}: K9 bitwise on a second call")
        alone = pm.posit_matmul_grouped(a[:1], b[:1], P13_2, P13_2)
        _check(_bits_equal(alone[0], first[0]),
               f"11c {arch}: K9's expert 0 bitwise its E = 1 call")
        del first, alone

    def run():
        for a, b in layer:
            pm.posit_matmul_grouped(a, b, P13_2, P13_2)

    call_ms = _time_ms(run, reps=3)
    ms = _device_ms(run, launches=1)
    plain_ms = _time_once_ms(lambda: [pm.posit_matmul_grouped_plain(
        a, b, P13_2, P13_2) for a, b in layer])
    decoded = [(posit_codec.decode(a, P13_2), posit_codec.decode(b, P13_2))
               for a, b in layer]
    library_ms = _device_ms(lambda: [torch.bmm(a, b) for a, b in decoded],
                            launches=1)
    del decoded, layer, acts
    torch.cuda.empty_cache()
    # the exact form: 4 bf16 products a multiply-add on the tensor cores
    layer_work = work.total(work.grouped(E, M, K, N, 2, 2, 4, "tc_p13_2")
                            for K, N in layer_kn)
    bound, by = _bound(layer_work)
    f32_bound, _ = _bound(_f32_form(layer_work))
    print(f"11c K9 training {arch} (E {E}, M {M}, the layer's 3 expert "
          f"GEMMs, P(13,2) x P(13,2), tc_p13_2): ms {ms:.4f}, call_ms "
          f"{call_ms:.4f}, plain_ms {plain_ms:.3f}, bound_ms {bound:.4f} "
          f"({by}; {layer_work.flops / 1e9:.2f} GFLOP, x 4 bf16 products "
          f"{_ops_ms(layer_work):.4f} ms, {int(layer_work.bytes)} B "
          f"{_bytes_ms(layer_work):.4f} ms; f32 FMA "
          f"{f32_bound:.4f} ms), torch.bmm on the decoded f32 stacks "
          f"{library_ms:.4f} ({ms / library_ms:.3f}x); largest err in u "
          f"sqrt(K) ||ab|| {ratio:.4g}")
    return dict(name=f"posit_matmul_grouped (training: tc_p13_2, P(13,2) "
                     f"x P(13,2), {arch} E {E} M {M}, the layer's 3 expert "
                     f"GEMMs)",
                counter="posit_matmul_grouped:tc_p13_2", paths=(train_label,),
                source="src/repro_torch/csrc/posit_matmul_grouped.cu",
                replaces="src/repro/kernels/posit_matmul.py:99",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                shape=f"E={E} M={M} {layer_kn}")


# ---------------------------------------------------------------------------
# phase 12: the example twins on the card
# ---------------------------------------------------------------------------

EXAMPLE_RUNS = (("quickstart_torch.py", (), {}),
                ("wm_sensitivity_study_torch.py", (), {}),
                ("ptq_study_torch.py", ("--steps", "20"), {}),
                ("serve_async_torch.py", (),
                 {"SERVE_ASYNC_REQUESTS": "2", "SERVE_ASYNC_TOKENS": "4"}))


def _examples_on_card():
    """12: the four example twins of this slice, each in its own process on
    the card (all started together, each waited for); every one must exit
    0.  Prints each one's last lines."""
    path = os.pathsep.join([os.path.join(HERE, "src")] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    procs = []
    for script, args, env in EXAMPLE_RUNS:
        procs.append((script, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "examples", script), *args],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=path, **env),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    results = []
    for script, proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        results.append((script, proc.returncode, out, err))
    wall = time.perf_counter() - t0
    for script, rc, out, err in results:
        if rc != 0:
            print(out[-4000:])
            print(err[-4000:], file=sys.stderr)
        _check(rc == 0, f"12: examples/{script} exits 0 on the card")
        lines = out.strip().splitlines()
        for line in lines[-3:]:
            print(f"12 {script}: {line}")
    print(f"12 examples: 4 twins exit 0 on the card in {wall:.1f} s (run "
          f"together)")


# ---------------------------------------------------------------------------
# phase 10: the rest of the dense family's serving: gemma3-4b and
# command-r-plus-104b at full width, the dense cache, the serving example
# ---------------------------------------------------------------------------

GEMMA_LAYERS = 12       # of 34: the 5:1 local:global pattern twice
GEMMA_MAX_SEQ = 1536
CRP_LAYERS = 2          # of 64
# K3 at gemma3's decode shape: lengths around the 1024-token window and a
# split boundary (33 splits of 32 keys end at 1056)
GEMMA_K3_LENGTHS = (1024, 1025, 1057, 1320)


def _chunks(n: int, buckets=(64, 16, 4, 1)):
    """The engine's greedy decomposition of an n-token prompt."""
    out = []
    for b in buckets:
        while n >= b:
            out.append(b)
            n -= b
    return out


def _dense_params(cfg, seed: int, dev):
    """Random weights of a dense config on the card, packed to the policy's
    weight codes; the tied embedding at std 1/sqrt(d_model), as phase 5."""
    import torch
    from repro_torch.models import api, packing
    params = api.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                      device=dev)
    params["embed"].mul_(1.0 / math.sqrt(cfg.d_model))
    return packing.pack_params(params, cfg)


def _prefill_slot0(cfg, params, prompt, dev, max_seq, paged=True, shards=0,
                   n_pages=None, table=None):
    """Prefill one prompt in slot 0 of a 4-slot cache (paged or dense) in
    the engine's chunks.  With `shards` the paged pool of `n_pages` (the
    default layout's when None) is split over that many shards of `dev`;
    slot 0's block-table row is `table` when given, else its pages go
    round-robin over the shards (page j on shard j mod shards).  Returns
    (the cache, the PageShard or None, the last chunk's logits, the next
    tokens: slot 0's greedy pick)."""
    import torch
    from repro_torch.models import api
    from repro_torch.models.paged import PagedLayout, PageShard
    shard = PageShard([dev] * shards) if shards else None
    layout = (PagedLayout.for_slots(4, max_seq, 16, n_pages,
                                    n_shards=max(shards, 1))
              if paged else None)
    cache = api.init_cache(cfg, 4, max_seq, layout, device=dev, shard=shard)
    if paged:
        M = cache["block_table"].shape[1]
        j = torch.arange(M, dtype=torch.int32, device=dev)
        cache["block_table"][0] = (
            torch.as_tensor(table).to(dev, torch.int32) if table is not None
            else (j % shards) * layout.pages_per_shard + 1 + j // shards
            if shards else j + 1)
    active = torch.tensor([True, False, False, False], device=dev)
    lo = 0
    for size in _chunks(len(prompt)):
        toks = torch.zeros(4, size, dtype=torch.int32, device=dev)
        toks[0] = torch.from_numpy(prompt[lo:lo + size]).to(dev)
        logits, cache = api.prefill_chunk_batched(params, toks, cache, active,
                                                  cfg, shard=shard)
        lo += size
    nxt = torch.zeros(4, dtype=torch.int32, device=dev)
    nxt[0] = logits[0].argmax()
    cache["length"][1:] = 0
    return cache, shard, logits[0].float(), nxt


def _prefill_then_decode(cfg, params, prompt, dev, max_seq, paged=True,
                         shards=0):
    """`_prefill_slot0`, then one greedy decode step; returns slot 0's
    first-step logits (f32)."""
    from repro_torch.models import api
    cache, shard, _, nxt = _prefill_slot0(cfg, params, prompt, dev, max_seq,
                                          paged, shards)
    logits, _ = api.decode_step(params, nxt, cache, cfg, shard=shard)
    return logits[0].float()


def _encode_head(params, cfg):
    """The tied head's P(16,2) codes, as the fused head re-encodes them."""
    import torch
    from repro_torch.kernels import ops
    return ops.encode(params["embed"].to(torch.float32), cfg.quant.weights)


def _k3_case(dev, label, Hq, Hkv, Dh, lengths, window, M, seed, ps=16,
             T=0):
    """K3 at one decode shape (K7 with T > 0 tokens a slot): a slot per
    entry of `lengths` (counting the T new tokens), M pages of `ps` P(8,2)
    tokens each, Hq / Hkv heads of Dh, one window: within 2e-5 of the
    plain version, finite, split and merged; timed beside its bound (the
    keys this data attends) and SDPA over the decoded K/V with the same
    mask.  Returns a record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import formats, posit
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    fmt = formats.P8_2
    B = len(lengths)
    P = B * M + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, Hq, Dh) if T else (B, Hq, Dh), generator=g,
                    device=dev)
    kp = posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g, device=dev), fmt)
    vp = posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g, device=dev), fmt)
    bt = torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, M)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    w = torch.tensor([window], dtype=torch.int32, device=dev)
    kernel = "paged_attention_mq" if T else "paged_attention"
    before = ops.launch_counts()[f"{kernel}:merge"]
    got = pa.paged_attention(q, kp, vp, bt, ln, w, fmt_kv=fmt)
    _check(ops.launch_counts()[f"{kernel}:merge"] == before + 1,
           f"{kernel} ({label}) splits its key span and merges")
    want = pa.paged_attention_plain(q, kp, vp, bt, ln, w, fmt_kv=fmt)
    _check(bool(torch.isfinite(got).all())
           and bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5)),
           f"{kernel} ({label}) within 2e-5 of its plain version")
    err = float((got - want).abs().max())
    run = lambda: pa.paged_attention(q, kp, vp, bt, ln, w,  # noqa: E731
                                     fmt_kv=fmt)
    ms = _device_ms(run, launches=50)
    call_ms = _time_ms(run, reps=100)
    plain_ms = _time_ms(lambda: pa.paged_attention_plain(
        q, kp, vp, bt, ln, w, fmt_kv=fmt), reps=3)
    kd, vd = (posit.decode(t[bt.long()], fmt).reshape(B, M * ps, Hkv, Dh)
              .permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
              for t in (kp, vp))
    # the kernel's mask: row i of a slot sits at position length - T' + i
    # (T' = max(T, 1)); it attends positions up to its own and where
    # position - key < window
    rows = max(T, 1)
    pos = torch.arange(M * ps, device=dev)
    qp = (ln.long()[:, None] - rows + torch.arange(rows, device=dev))
    mask = ((pos[None, None] <= qp[..., None])
            & (qp[..., None] - pos[None, None] < window))     # [B, rows, S]
    qt = q.permute(0, 2, 1, 3) if T else q[:, :, None]
    library_ms = _device_ms(lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask[:, None]), launches=20)
    keys = int(mask.sum())
    read = int(mask.any(1).sum())      # distinct keys a slot's rows read
    bound, by = _bound(work.paged_attention(
        B, rows, Hq, Hkv, Dh, read, kp.element_size(), bt.shape[1], keys))
    print(f"K3 {label} ({kernel}, B {B}{f', T {T}' if T else ''}, {Hq} / "
          f"{Hkv} heads x {Dh}, pages of {ps}, lengths {tuple(lengths)}, "
          f"window {window}, {pa.attention_splits(M, ps, Dh)[1]} splits): "
          f"ms {ms:.4f}, call_ms {call_ms:.4f}, plain_ms {plain_ms:.3f}, "
          f"bound_ms {bound:.4f} ({by}, {keys} keys attended), library_ms "
          f"(SDPA, decoded K/V, masked) {library_ms:.4f}, max_abs_err "
          f"{err:.3g}")
    return dict(name=f"{kernel} ({label})", counter=kernel,
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces=("src/repro/kernels/paged_attention.py:195" if T
                          else "src/repro/kernels/paged_attention.py:266"),
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms)


def _k5_record(dev, label, counter, act=None, **kw):
    """One K5 case of `_k5_case` (bf16 unless `act`) as a kernel record."""
    import torch
    r = _k5_case(dev, act or torch.bfloat16, reps=10, **kw)
    bound, by = r["bound"], r["by"]
    print(f"10 K5 {label}: ms {r['ms']:.4f}, call_ms {r['call_ms']:.4f}, "
          f"plain_ms {r['plain_ms']:.3f}, bound_ms {bound:.4f} ({by}; "
          f"bytes {r['bytes_ms']:.4f}, at "
          f"the f32 FMA rate {r['f32_fma_ms']:.4f}), library_ms (SDPA, "
          f"masked) {r['library_ms']:.4f} ({r['ms'] / r['library_ms']:.2f}x), "
          f"max_abs_err {r['err']:.3g}")
    return dict(name=f"prefill_attention ({label})", counter=counter,
                source="src/repro_torch/csrc/prefill_attention.cu",
                replaces="src/repro/kernels/prefill_attention.py:251",
                max_abs_err=r["err"], ms=r["ms"], call_ms=r["call_ms"],
                plain_ms=r["plain_ms"], bound_ms=bound, bound_by=by,
                library_ms=r["library_ms"])


def _k4_record(dev, label, D, V, w=None, seed=41):
    """K4 over a tied [V, D] P(16,2) head (random, or the model's re-encoded
    embedding `w`) at 4 bf16 rows: tokens equal to the plain head + sampler
    (greedy, T 0.8 with and without top-k 40), or a score within 1e-5 of
    the largest |logit| where the plain top two are that close, every
    launch on p16_2; timed beside its bytes bound."""
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    fmt = formats.P16_2
    B = 4
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
    if w is None:
        w = posit.pack(torch.randn(V, D, generator=g, device=dev), fmt)
    noise = -torch.log(-torch.log(torch.rand(B, V, generator=g, device=dev)
                                  .clamp(1e-9, 1 - 1e-7)))
    kw = dict(plan="fused", fmt_w=fmt, transpose=True)
    logits = pa.head_logits_plain(x, w, softcap_val=0.0, **kw)
    tol = 1e-5 * float(logits.abs().max())
    err = 0.0
    before = ops.launch_counts()["decode_sample:p16_2"]
    for greedy, top_k in ((True, 0), (False, 40), (False, 0)):
        tok = pa.decode_sample(x, w, None if greedy else noise, 0.8,
                               greedy=greedy, top_k=top_k, **kw)
        want = pa.sample_logits(logits, noise, 0.8, greedy=greedy,
                                top_k=top_k)
        l = logits if greedy else pa.scale_logits(logits, 0.8)
        if top_k:
            kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
            l = torch.where(l >= kth, l, torch.full_like(l, -1e30))
        score = l if greedy else noise + l
        rows = torch.arange(B, device=dev)
        gap = (score[rows, want.long()] - score[rows, tok.long()]).abs()
        _check(bool(((tok == want) | (gap <= tol)).all()),
               f"K4 {label} tokens (greedy={greedy}, top_k={top_k})")
        err = max(err, float(gap.max()))
    _check(ops.launch_counts()["decode_sample:p16_2"] == before + 3,
           f"K4 {label} on its p16_2 variant")
    run = lambda: pa.decode_sample(x, w, noise, 0.8, greedy=False,  # noqa: E731
                                   top_k=40, **kw)
    ms = _device_ms(run, launches=3)
    call_ms = _time_ms(run, reps=5)
    plain_ms = _time_once_ms(lambda: pa.decode_sample_plain(
        x, w, noise, 0.8, greedy=False, top_k=40, **kw))
    bound, by = _bound(work.decode_sample(B, D, V, w.element_size(),
                                          x.element_size(), False))
    print(f"10 K4 {label} (B 4, D {D}, V {V}, T 0.8, top-k 40): ms "
          f"{ms:.4f}, call_ms {call_ms:.4f}, plain_ms {plain_ms:.3f}, "
          f"bound_ms {bound:.4f} ({by}), {bound / ms:.3f} of the bound, "
          f"max score gap {err:.3g}")
    del logits
    return dict(name=f"decode_sample ({label}: D {D}, V {V})",
                counter="decode_sample",
                source="src/repro_torch/csrc/decode_sample.cu",
                replaces="src/repro/kernels/paged_attention.py:467",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def _path_checks(label, c, k5_variant):
    """The main-path rules of phase 5 for a phase-10 run: every kernel of
    the paged serving path launched, K3 merged, K2 on a compile-time
    variant, K4 on p16_2, K5 on the variant its dtype and head_dim pick."""
    for name in ("posit_decode", "posit_encode", "paged_attention",
                 "decode_sample", "prefill_attention"):
        _check(c[name] > 0, f"kernel {name} launched in the '{label}' run")
    _check(c["paged_attention:merge"] == c["paged_attention"],
           f"'{label}': every K3 launch split its key span and merged")
    _check(c["posit_encode:posit"] == 0,
           f"'{label}': every K2 launch took a compile-time variant")
    _check(c["decode_sample:p16_2"] == c["decode_sample"],
           f"'{label}': every K4 launch took the p16_2 variant")
    _check(c[f"prefill_attention:{k5_variant}"] == c["prefill_attention"],
           f"'{label}': every K5 launch took the {k5_variant} variant")


def _f32_serving(label, cfg, params, prompts, **kw):
    """`cfg` served with f32 activations (its dtype float32; the same
    packed weights and P(8,2) pages) on `prompts`, counted from 0: every
    kernel of the paged path launched and every K5 launch on tc_f32, each
    K5 call replayed against its plain version (`_replay_smoke_calls`);
    then the same queue four more times, K5 on the SIMT kernel (the f32
    path before tc_f32), on tc_f32, on tc_f32, on SIMT, for tokens/s and
    the prefill share of each beside the other (the counted run pays for
    the capture's copies, and a first run for its allocations).  Returns
    (the run's launch counts, its K5 replay records)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import prefill_attention as pf
    cfg32 = cfg.replace(dtype="float32")
    ops.reset_launches()
    with _capture_calls(names=("prefill_attention_paged",)) as calls:
        _, eng, _, _ = _run_engine(cfg32, params, prompts, label, **kw)
    counts = ops.launch_counts()
    print(f"{label}: launches {json.dumps(counts)}")
    _path_checks(label, counts, "tc_f32")
    del eng
    _release()
    records = _replay_smoke_calls(label, calls, counts, tag="f32",
                                  only=("prefill_attention",))
    del calls
    _release()
    chosen = pf.prefill_variant
    ab = {"simt": [], "tc_f32": []}
    for n, variant in enumerate(("simt", "tc_f32", "tc_f32", "simt")):
        run = f"{label} (K5 on {variant}, A/B {n + 1})"
        pf.prefill_variant = (chosen if variant == "tc_f32" else
                              lambda dtype, head_dim: "simt")
        try:
            _run_engine(cfg32, params, prompts, run, **kw)
        finally:
            pf.prefill_variant = chosen
        ab[variant].append(RUN_TIMES[run])
        _release()
    tok = {v: sum(r[0] for r in rs) / 2 for v, rs in ab.items()}
    pre = {v: sum(r[1] for r in rs) / 2 for v, rs in ab.items()}
    print(f"{label}: A/B (simt, tc_f32, tc_f32, simt): tok/s tc_f32 "
          f"{tok['tc_f32']:.2f} against simt {tok['simt']:.2f} "
          f"({tok['tc_f32'] / tok['simt']:.3f}x); prefill {pre['tc_f32']:.1f}"
          f" ms against {pre['simt']:.1f}; prefill share "
          f"{100 * sum(r[2] for r in ab['tc_f32']) / 2:.1f}% against "
          f"{100 * sum(r[2] for r in ab['simt']) / 2:.1f}%")
    return counts, records


def _gemma3_phase(dev):
    """10a: gemma3-4b at full width (12 of 34 layers: layers 5 and 11
    global, the rest a 1024-token window) at serve_fused_p16: K3, K5 (tc256)
    and K4 at its shapes, 8 requests of 1104-1304 tokens (a shared
    64-token system prompt) at max_seq 1536, 16 new tokens, greedy and
    sampled, and greedy with f32 activations (`_f32_serving`: K5 on
    tc_f32 at head_dim 256); the window bites.  Returns (launch counts by
    run, records)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.models import packing
    full = configs.get("gemma3_4b")
    cfg = full.replace(n_layers=GEMMA_LAYERS,
                       quant=policy_by_name("serve_fused_p16"))
    glob = [i for i in range(cfg.n_layers) if cfg.layer_is_global(i)]
    _check(glob == [5, 11], "gemma3: layers 5 and 11 are global")
    print(f"10a gemma3 config: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, qk_norm "
          f"{cfg.qk_norm}, window {cfg.sliding_window}, global layers {glob}, "
          f"dtype {cfg.dtype}")
    print("10a gemma3: reduced: " + json.dumps(
        {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"}))
    # K3 at the decode shape: the local layers' window (splits wholly
    # before it are empty partials the merge must weigh zero) and the
    # global layers' 2^30
    records = [_k3_case(
        dev, f"gemma3-4b: head_dim {cfg.head_dim}, G "
             f"{cfg.n_heads // cfg.n_kv_heads}, {label}", cfg.n_heads,
        cfg.n_kv_heads, cfg.head_dim, GEMMA_K3_LENGTHS, window,
        GEMMA_MAX_SEQ // 16, 31) for label, window in (
            (f"window {cfg.sliding_window}", cfg.sliding_window),
            ("global", 1 << 30))]
    # K5 at its chunk shape: tc256 with the local layers' window and the
    # global layers' 2^30 (tc_f32 there: phase 3's K5_F32_SHAPES)
    k5 = dict(M=128, starts=[1024, 1100, 1500, 1960], Hkv=cfg.n_kv_heads,
              Hq=cfg.n_heads, Dh=cfg.head_dim)
    for label, window in ((f"window {cfg.sliding_window}",
                           cfg.sliding_window), ("global", 1 << 30)):
        records.append(_k5_record(
            dev, f"gemma3-4b: tc256, head_dim {cfg.head_dim}, {label}",
            "prefill_attention:tc256", window=window, **k5))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _dense_params(cfg, 20, dev)
    torch.cuda.synchronize()
    trunk = sum(t.numel() for t in params["layers"].values())
    print(f"10a gemma3: init + pack {time.perf_counter() - t0:.3f} s, "
          f"{trunk} trunk weights and {params['embed'].numel()} embedding "
          f"weights, {packing.weight_bytes(params)} B on the card (P(16,2) "
          f"codes, f32 embedding)")
    records.append(_k4_record(dev, "gemma3-4b", cfg.d_model, cfg.vocab_size,
                              w=_encode_head(params, cfg)))
    rng = np.random.default_rng(20)
    system = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, int(n))])
               .astype(np.int32) for n in rng.integers(1040, 1241, 8)]
    base = dict(max_seq=GEMMA_MAX_SEQ, page_size=16, base_seed=1)
    counts = {}
    for label, kw in (("gemma3 greedy", dict(greedy=True)),
                      ("gemma3 sampled", dict(greedy=False, temperature=0.8,
                                              top_k=40))):
        ops.reset_launches()
        _, eng, _, _ = _run_engine(cfg, params, prompts, label, **kw, **base)
        counts[label] = ops.launch_counts()
        print(f"{label}: launches {json.dumps(counts[label])}")
        _check(eng.execution_summary()["fused_prefill"]
               and eng.stats["shared_admissions"] > 0,
               f"{label}: fused prefill and shared admissions")
        _path_checks(label, counts[label], "tc256")
    counts[F32_RUNS[1]], recs = _f32_serving(F32_RUNS[1], cfg, params,
                                             prompts, greedy=True, **base)
    records.extend(recs)
    # the window bites: the first decode step of request 0 (1100+ tokens)
    # with gemma3's windows against the same weights without them
    windowed = _prefill_then_decode(cfg, params, prompts[0], dev,
                                    GEMMA_MAX_SEQ)
    unwindowed = _prefill_then_decode(cfg.replace(sliding_window=None),
                                      params, prompts[0], dev, GEMMA_MAX_SEQ)
    gap = float((windowed - unwindowed).abs().max())
    _check(bool(torch.isfinite(windowed).all()) and gap > 1e-3,
           "gemma3: the window changes the first decode step's logits")
    print(f"10a gemma3 window bites: request 0 ({len(prompts[0])} tokens), "
          f"first decode step's max |logit diff| with and without the "
          f"1024-token window {gap:.4g} (max |logit| "
          f"{float(windowed.abs().max()):.4g}; K3's tolerance 2e-5)")
    _profile(cfg, params, prompts, "gemma3", steps=2, max_seq=GEMMA_MAX_SEQ)
    _graph_phase("gemma3 greedy", cfg, params, prompts, greedy=True, **base)
    del params
    _release()
    return counts, records


def _command_r_plus_phase(dev):
    """10b: command-r-plus-104b at full width (2 of 64 layers) at the
    defaults with phase 5's traffic: K1 at [12288, 33792], K4 at D 12288,
    K3 and K5 (tc) at G 12 against their plain versions, then 8 requests of
    16 new tokens, greedy.  Returns (launch counts by run, records)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core import formats
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops, posit_codec
    from repro_torch.kernels import work
    from repro_torch.models import packing
    full = configs.get("command_r_plus_104b")
    cfg = full.replace(n_layers=CRP_LAYERS,
                       quant=policy_by_name("serve_fused_p16"))
    print(f"10b command-r-plus config: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}, dtype "
          f"{cfg.dtype}")
    print("10b command-r-plus: reduced: " + json.dumps(
        {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"}))
    records = []
    # K1 at the widest projection, [d_model, d_ff]
    fmt = formats.P16_2
    g = torch.Generator(device=dev).manual_seed(42)
    K, N = cfg.d_model, cfg.d_ff
    codes = posit_codec.encode(torch.randn(K, N, generator=g, device=dev)
                               / math.sqrt(K), fmt)
    _check(_bits_equal(posit_codec.decode(codes, fmt),
                       posit_codec.decode_plain(codes, fmt)),
           f"K1 posit_decode at [{K}, {N}]")
    ms = _device_ms(lambda: posit_codec.decode(codes, fmt), launches=10)
    call_ms = _time_ms(lambda: posit_codec.decode(codes, fmt), reps=10)
    plain_ms = _time_once_ms(lambda: posit_codec.decode_plain(codes, fmt))
    bound, by = _bound(work.decode(codes.numel(), codes.element_size()))
    print(f"10b K1 [{K}, {N}] int16 -> f32: ms {ms:.4f}, call_ms "
          f"{call_ms:.4f}, plain_ms {plain_ms:.3f}, bound_ms {bound:.4f} "
          f"({by}), {bound / ms:.3f} of the bound")
    records.append(dict(
        name=f"posit_decode:p16_2 (command-r-plus-104b: [{K}, {N}])",
        counter="posit_decode:p16_2",
        source="src/repro_torch/csrc/posit_codec.cu",
        replaces="src/repro/kernels/posit_codec.py:55", max_abs_err=0.0,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None))
    del codes
    _release()
    # K3 and K7 at G = 12 over split-boundary lengths, K3 at the serving
    # shape timed; K5's tensor-core variant at G = 12
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    _attention_splits_check(dev, Hq, Hkv, "int8")
    records.append(_k3_case(dev, f"command-r-plus-104b: G {Hq // Hkv}", Hq,
                            Hkv, Dh, [256, 137, 0, 64], 1 << 30, 16, 32))
    records.append(_k5_record(
        dev, f"command-r-plus-104b: tc, G {Hq // Hkv}",
        "prefill_attention:tc", M=16, starts=[64, 64, 130, 190], Hkv=Hkv,
        Hq=Hq, Dh=Dh))
    _release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _dense_params(cfg, 21, dev)
    torch.cuda.synchronize()
    trunk = sum(t.numel() for t in params["layers"].values())
    print(f"10b command-r-plus: init + pack {time.perf_counter() - t0:.3f} s, "
          f"{trunk} trunk weights and {params['embed'].numel()} embedding "
          f"weights, {packing.weight_bytes(params)} B on the card, peak "
          f"memory {torch.cuda.max_memory_allocated()} B")
    records.append(_k4_record(dev, "command-r-plus-104b", cfg.d_model,
                              cfg.vocab_size, w=_encode_head(params, cfg)))
    _release()
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, int(n))])
               .astype(np.int32) for n in rng.integers(8, 57, 8)]
    label = "command-r-plus greedy"
    ops.reset_launches()
    _, eng, per_step, n_steps = _run_engine(
        cfg, params, prompts, label, greedy=True, max_seq=256, page_size=16,
        base_seed=1)
    counts = {label: ops.launch_counts()}
    print(f"{label}: launches {json.dumps(counts[label])}")
    _path_checks(label, counts[label], "tc")
    _check(counts[label]["posit_matmul"] == 0,
           f"'{label}': the float weight path (no K6)")
    _float_path_checks(label, counts[label], (per_step, n_steps), cfg)
    _profile(cfg, params, prompts, "command-r-plus", steps=2)
    del params
    _release()
    return counts, records


def _dense_cache_phase(cfg, params, prompts, paged_greedy, dev):
    """10c: ServingEngine(paged=False) on phase 5's command-r-35b (full
    width, 4 layers) with phase 5's 8 requests, greedy: every request
    completes, kv_cache_bytes() is the [L, B, max_seq, F] int8 rows plus
    `length`, no attention kernel launches (the dense cache attends in
    plain PyTorch, as the reference does outside its kernels); the streams
    and the first-step logits against phase 5's paged run.  Returns the
    run's launch counts."""
    import torch
    from repro_torch.kernels import ops
    label = "dense cache greedy"
    ops.reset_launches()
    dense, eng, per_step, n_steps = _run_engine(
        cfg, params, prompts, label, greedy=True, paged=False, max_seq=256,
        base_seed=1)
    counts = ops.launch_counts()
    print(f"{label}: launches {json.dumps(counts)}")
    # the unfused tied head runs the float GEMV over the head's transpose
    _float_path_checks(label, counts, (per_step, n_steps), cfg, head_t=1)
    rows = 2 * cfg.n_layers * eng.B * eng.S * cfg.n_kv_heads * cfg.head_dim
    _check(not eng.paged and eng.cache["k"].dtype == torch.int8
           and eng.kv_cache_bytes() == rows + 4 * eng.B,
           "dense cache: kv_cache_bytes() = the int8 rows + length")
    for name in ("paged_attention", "paged_attention_mq",
                 "prefill_attention", "decode_sample"):
        _check(counts[name] == 0, f"dense cache: no {name} launch")
    for name in ("posit_decode", "posit_gemv_f", "posit_encode"):
        _check(counts[name] > 0, f"dense cache: {name} launched")
    same, toks = _agreement(dense, paged_greedy)
    paged = _prefill_then_decode(cfg, params, prompts[0], dev, 256)
    dense_logits = _prefill_then_decode(cfg, params, prompts[0], dev, 256,
                                        paged=False)
    gap = float((dense_logits - paged).abs().max() / paged.abs().max())
    print(f"10c dense cache: kv_cache_bytes {eng.kv_cache_bytes()} B "
          f"([{cfg.n_layers}, {eng.B}, {eng.S}, "
          f"{cfg.n_kv_heads * cfg.head_dim}] int8 k and v + length); "
          f"greedy streams vs phase 5's paged run: "
          f"{int(round(same * len(dense)))} of {len(dense)} identical, "
          f"{toks:.4f} of tokens equal; first decode step of request 0, "
          f"max |dense - paged| / max |logit| = {gap:.3g}")
    _profile(cfg, params, prompts, "dense cache", steps=2, paged=False)
    return counts


def _serve_example():
    """10d: examples/serve_posit_lm_torch.py on the card in a subprocess
    (4 requests, 4 new tokens); it must exit 0."""
    env = dict(os.environ, SERVE_DEMO_REQUESTS="4", SERVE_DEMO_TOKENS="4",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(HERE, "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, "examples",
                                      "serve_posit_lm_torch.py")],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:])
        print(res.stderr[-4000:], file=sys.stderr)
    _check(res.returncode == 0, "10d: the serving example exits 0")
    lines = res.stdout.strip().splitlines()
    for line in lines:
        if line.startswith(("served", "kernel launches", "fused prefill",
                            "activation-coded vs")):
            print(f"10d example: {line}")
    print(f"10d example: exit 0 in {wall:.1f} s ({len(lines)} lines)")


# ---------------------------------------------------------------------------
# phase 13: the SSM and hybrid families: mamba2-1.3b at full width and all
# 48 layers; the jamba and mamba2 smoke engines on the card against the CPU
# ---------------------------------------------------------------------------

MAMBA_LONG = 2048       # 13a's long prompt, prefilled in chunks of ssm_chunk
MAMBA_SSD_TOL = 1e-3    # |logit gap| / max |logit|, f32 activations
# `_ssd_layer_gaps`' limits: the SSD's recurrence against its chunk form
# over the largest |y| (the CPU parity tests' SSD_TOL), and layer 1's
# residual gap, chunked vs whole, over its largest |value|: 5x the f32
# reading (1.99e-6), two bf16 steps in bf16 (3.65e-3 read; in_proj's rows
# over 256 at a time are not bitwise over 2048 on the card)
MAMBA_RECURRENCE_TOL = 1e-5
MAMBA_LAYER1_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# 13a's main-path runs (each counted from 0): the kernel records of
# `_mamba_kernels` count their launches, and no other record does
MAMBA_RUNS = ("mamba2 greedy", "mamba2 sampled", "mamba2 long prompt")


def _mamba_cfg():
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    return configs.get("mamba2_1_3b").replace(
        quant=policy_by_name("serve_fused_p16"))


def _mamba_kernels(dev):
    """The kernels of mamba2-1.3b's path at its shapes: the float GEMV over
    a layer's in_proj [2048, 8512] and out_proj [4096, 2048] at M 4 with
    bf16 activations and over the tied head's transpose [50280, 2048]^T,
    each within `sum_bound(x, w, None, fmt)` of its plain version and
    bitwise equal on a second call; K1 (`p16_2`) at in_proj (the prefill
    chunk groups) and K2 (`p16_2`) re-encoding the f32 tied head (each
    step), bitwise their plain versions.  Each is timed beside its plain
    version, its bound and, for the GEMV, torch.matmul on pre-decoded f32.
    Returns records whose launches are 13a's (`paths`)."""
    import torch
    from repro_torch.core import formats
    from repro_torch.kernels import ops, posit_codec
    from repro_torch.kernels import posit_matmul as pm
    from repro_torch.kernels import work
    cfg = _mamba_cfg()
    fmt, M = formats.P16_2, 4
    D, Di, V = cfg.d_model, cfg.ssm_d_inner, cfg.vocab_size
    proj = 2 * Di + 2 * cfg.ssm_state + cfg.ssm_heads
    layer = ((D, proj), (Di, D))
    g = torch.Generator(device=dev).manual_seed(17)
    weights = {kn: posit_codec.encode(torch.randn(*kn, generator=g, device=dev)
                                      / math.sqrt(kn[0]), fmt) for kn in layer}
    head_f = torch.randn(V, D, generator=g, device=dev) / math.sqrt(D)
    head = posit_codec.encode(head_f, fmt)
    xs = {K: torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
          for K in (D, Di)}
    err, per = 0.0, {}
    for (K, N), w in [(kn, weights[kn]) for kn in layer] + [((D, V), head.T)]:
        x = xs[K]
        variant = pm.gemv_f_variant(M, fmt, w)
        before = ops.launch_counts()[f"posit_gemv_f:{variant}"]
        got = pm.posit_gemv_f(x, w, fmt)
        _check(ops.launch_counts()[f"posit_gemv_f:{variant}"] == before + 1
               and _bits_equal(pm.posit_gemv_f(x, w, fmt), got),
               f"13: the float GEMV ({variant}) at K={K} N={N}, bitwise "
               f"equal on a second call")
        xf, W = x.to(torch.float32), ops.decode(w, fmt)
        want = torch.matmul(xf, W)
        gap = (got - want).abs()
        _check(bool((gap <= pm.sum_bound(x, w, None, fmt)).all()),
               f"13: the float GEMV within sum_bound at K={K} N={N}")
        err = max(err, float(gap.max()))
        ms = _device_ms(lambda: pm.posit_gemv_f(x, w, fmt), launches=5)
        mm = _device_ms(lambda: torch.matmul(xf, W), launches=5)
        plain = _time_once_ms(lambda: pm.posit_gemv_f_plain(x, w, fmt))
        bound = _bound(work.gemv_f(M, K, N, x.element_size(),
                                   w.element_size()))
        per[(K, N)] = (ms, mm, plain, bound)
        print(f"13 float GEMV M={M} K={K} N={N} ({variant}): ms {ms:.4f}, "
              f"torch.matmul on decoded f32 {mm:.4f}, plain {plain:.3f}, "
              f"bound_ms {bound[0]:.4f} ({bound[1]}), max_abs_err {err:.3g}")
        del got, want, gap, W
    layer_ms = _device_ms(lambda: [pm.posit_gemv_f(xs[K], weights[(K, N)], fmt)
                                   for K, N in layer], launches=3)
    layer_bound = _bound(work.total(work.gemv_f(M, K, N, 2, 2)
                                    for K, N in layer))
    codes = weights[layer[0]]
    _check(_bits_equal(posit_codec.decode(codes, fmt),
                       posit_codec.decode_plain(codes, fmt)),
           f"13: K1 p16_2 at {list(layer[0])}")
    k1 = (_device_ms(lambda: posit_codec.decode(codes, fmt), launches=5),
          _time_once_ms(lambda: posit_codec.decode_plain(codes, fmt)),
          _bound(work.decode(codes.numel(), codes.element_size())))
    _check(_bits_equal(posit_codec.encode(head_f, fmt),
                       posit_codec.encode_plain(head_f, fmt)),
           f"13: K2 p16_2 at [{V}, {D}]")
    k2 = (_device_ms(lambda: posit_codec.encode(head_f, fmt), launches=3),
          _time_once_ms(lambda: posit_codec.encode_plain(head_f, fmt)),
          _bound(work.encode(head_f.numel(), 2)))
    print(f"13 K1 p16_2 {list(layer[0])}: ms {k1[0]:.4f}, plain {k1[1]:.3f}, "
          f"bound_ms {k1[2][0]:.4f}; K2 p16_2 [{V}, {D}]: ms {k2[0]:.4f}, "
          f"plain {k2[1]:.3f}, bound_ms {k2[2][0]:.4f}")
    del weights, head, head_f, codes
    torch.cuda.empty_cache()
    hms, hmm, hplain, hbound = per[(D, V)]
    common = dict(paths=MAMBA_RUNS, replaces="src/repro/kernels/posit_codec.py:55")
    gemv = dict(common, source="src/repro_torch/csrc/posit_gemv_f.cu",
                max_abs_err=err, call_ms=None)
    return [
        dict(gemv, name="posit_gemv_f:p16_2 (mamba2-1.3b, M 4, a layer's "
                        "in_proj and out_proj)",
             counter="posit_gemv_f:p16_2", ms=layer_ms,
             plain_ms=sum(per[kn][2] for kn in layer),
             bound_ms=layer_bound[0], bound_by=layer_bound[1],
             library_ms=sum(per[kn][1] for kn in layer),
             shape=f"M=4 bf16 x {[list(kn) for kn in layer]} int16 P(16,2)"),
        dict(gemv, name="posit_gemv_f:p16_2_t (mamba2-1.3b, M 4, the tied "
                        "head's transpose)",
             counter="posit_gemv_f:p16_2_t", ms=hms, plain_ms=hplain,
             bound_ms=hbound[0], bound_by=hbound[1], library_ms=hmm,
             shape=f"M=4 bf16 x [{V}, {D}]^T int16 P(16,2)"),
        dict(common, name="posit_decode:p16_2 (mamba2-1.3b in_proj, prefill "
                          "chunk groups)",
             counter="posit_decode:p16_2",
             source="src/repro_torch/csrc/posit_codec.cu", max_abs_err=0.0,
             ms=k1[0], call_ms=None, plain_ms=k1[1], bound_ms=k1[2][0],
             bound_by=k1[2][1], library_ms=None,
             shape=f"{list(layer[0])} int16 P(16,2) -> f32"),
        dict(common, name="posit_encode:p16_2 (mamba2-1.3b's tied head, "
                          "re-encoded each step)",
             counter="posit_encode:p16_2",
             replaces="src/repro/kernels/posit_codec.py:78",
             source="src/repro_torch/csrc/posit_codec.cu", max_abs_err=0.0,
             ms=k2[0], call_ms=None, plain_ms=k2[1], bound_ms=k2[2][0],
             bound_by=k2[2][1], library_ms=None,
             shape=f"[{V}, {D}] f32 -> int16 P(16,2)")]


def _ssm_path_checks(label, c, per_step, n_steps, engine, cfg):
    """mamba2's launches: no attention, fused head or coded-activation
    kernel; each decode step 2 x layers float GEMV launches (in_proj,
    out_proj) and the unfused tied head (K2 re-encode + the GEMV's
    transposed variant), no K1; over the run, each chunk group and step 2
    x layers projections (the GEMV at <= 8 rows, K1 + torch.matmul above)
    and one head, every launch on a compile-time variant."""
    L = cfg.n_layers
    for name in ("paged_attention", "paged_attention_mq", "prefill_attention",
                 "decode_sample", "posit_matmul", "posit_matmul_grouped",
                 "pdpu_matmul"):
        _check(c.get(name, 0) == 0, f"'{label}': no {name} launch")
    _check(per_step.get("posit_gemv_f:p16_2", 0) == 2 * L * n_steps
           and per_step.get("posit_gemv_f:p16_2_t", 0) == n_steps
           and per_step.get("posit_encode:p16_2", 0) == n_steps
           and per_step.get("posit_decode", 0) == 0,
           f"'{label}': {2 * L} GEMV launches (p16_2), one K2 and one "
           f"p16_2_t a decode step, no K1")
    groups = engine.stats["prefill_chunks"] + engine.stats["decode_steps"]
    _check(c.get("posit_gemv_f:p16_2", 0) + c.get("posit_decode:p16_2", 0)
           == 2 * L * groups
           and c.get("posit_gemv_f:p16_2_t", 0) == groups
           and c.get("posit_encode:p16_2", 0) == groups,
           f"'{label}': {2 * L} projections and one head per chunk group "
           f"and step ({groups})")
    _check(c["posit_gemv_f"] == c.get("posit_gemv_f:p16_2", 0)
           + c.get("posit_gemv_f:p16_2_t", 0)
           and c["posit_decode"] == c.get("posit_decode:p16_2", 0)
           and c["posit_encode"] == c.get("posit_encode:p16_2", 0),
           f"'{label}': every GEMV, K1 and K2 launch on a compile-time "
           f"variant")


def _ssd_full_width(cfg, params, prompt, dev):
    """The SSD's chunk form chunked and as a recurrence against the whole
    prompt at full width, with f32 activations (bf16's gaps printed, not
    gated): the S-token prompt prefilled in chunks of ssm_chunk, and its
    first S - 1 tokens (the last chunk one short), against `api.prefill`
    over the whole prompt at positions S - 1 and S - 2; then one decode
    step of the last token after those S - 1 (the recurrence) against
    position S - 1.  Each gap over the largest |logit| within
    MAMBA_SSD_TOL."""
    import torch
    from repro_torch.models import api
    S, Q = len(prompt), cfg.ssm_chunk
    toks = torch.from_numpy(prompt[None]).to(dev)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        whole = api.prefill(params, {"tokens": toks}, c, device=dev)[0][0]
        want = {S: whole[-1].clone(), S - 1: whole[-2].clone()}
        del whole
        gaps = {}
        for n_tok in (S, S - 1):
            cache = api.init_cache(c, 1, S, device=dev)
            for lo in range(0, n_tok, Q):
                logits, cache = api.prefill_chunk(
                    params, toks[:, lo:min(lo + Q, n_tok)], cache, 0, c)
            gaps[f"{n_tok} tokens chunked"] = rel(logits[0, 0], want[n_tok])
        step = api.decode_step(params, toks[:, -1], cache, c)[0][0]
        gaps["decode step (recurrence)"] = rel(step, want[S])
        gated = dtype == "float32"
        print(f"13a SSD at full width ({dtype} activations), gap over the "
              f"largest |logit| against the whole prompt: "
              + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
              + (f" (limit {MAMBA_SSD_TOL})" if gated else " (not gated)"))
        if gated:
            _check(max(gaps.values()) <= MAMBA_SSD_TOL,
                   f"13a: the SSD's chunk form, chunked and as a recurrence, "
                   f"within {MAMBA_SSD_TOL} of the largest |logit|")


def _ssd_layer_gaps(cfg, params, prompt, dev):
    """Where `_ssd_full_width`'s gaps come from, with f32 and bf16
    activations.  (1) The residual stream's last row after each layer, the
    S-token prompt run in chunks of ssm_chunk (states carried) against the
    whole prompt, as a gap over the row's largest |value|.  (2) At layer 0
    the two forms' differences apart: in_proj over the prompt's rows
    ssm_chunk at a time against all at once (K1 + torch.matmul above 8
    rows), and, on the same projections, the SSD (`ssd_forward`) whole
    against chunk by chunk with its state carried (bitwise or not), and
    its recurrence (`ssd_decode_step` over the last token after the first
    S - 1) against the chunk form's last row, with layer 0's A_log and with
    the last layer's (the largest decays of the stack-wide `arange1`).
    The SSD must be bitwise and its recurrence within MAMBA_RECURRENCE_TOL,
    layer 1 within MAMBA_LAYER1_TOL; deeper layers are printed (random
    weights amplify layer 1's gap about 160x (f32) and 75x (bf16) over
    48 layers, so no limit on the logits tells a fault from that growth).
    Returns {dtype: (per-layer gaps, the layer-0 readings)}."""
    import torch
    from repro_torch.models import common, mamba
    S, Q, L = len(prompt), cfg.ssm_chunk, cfg.n_layers
    Di, N = cfg.ssm_d_inner, cfg.ssm_state
    toks = torch.from_numpy(prompt[None]).to(dev)

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    found = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        x = common.embed_tokens(params["embed"], toks, c)
        whole = []
        for i in range(L):
            x = x + mamba.mamba_block(mamba._layer(params, i), x, c)[0]
            whole.append(x[0, -1].clone())
        conv, ssm = [None] * L, [None] * L
        for lo in range(0, S, Q):
            x = common.embed_tokens(params["embed"], toks[:, lo:lo + Q], c)
            chunked = []
            for i in range(L):
                out, conv[i], ssm[i] = mamba.mamba_block(
                    mamba._layer(params, i), x, c, conv_state=conv[i],
                    ssm_state=ssm[i])
                x = x + out
                chunked.append(x[0, -1].clone())
        layers = [rel(a, b) for a, b in zip(chunked, whole)]
        del x, conv, ssm, whole, chunked
        p0 = mamba._layer(params, 0)
        h = common.rms_norm(common.embed_tokens(params["embed"], toks, c),
                            p0["ln"], upcast=not c.tp_bf16_reduce)
        proj = common.qdot(h, p0["in_proj"], c.quant)
        rows = torch.cat([common.qdot(h[:, lo:lo + Q], p0["in_proj"], c.quant)
                          for lo in range(0, S, Q)], 1)
        readings = {"in_proj rows": (bool(torch.equal(rows, proj)),
                                     rel(rows, proj))}
        _, xs, B_, C_, dt = mamba._split_proj(c, proj)
        xBC = mamba._causal_conv(torch.cat([xs, B_, C_], -1), p0["conv_w"],
                                 p0["conv_b"])[0]
        xs, B_, C_ = xBC[..., :Di], xBC[..., Di:Di + N], xBC[..., Di + N:]
        for i in (0, L - 1):
            A_log, dt_bias = params["layers"]["A_log"][i], p0["dt_bias"]
            y, s = mamba.ssd_forward(c, xs, B_, C_, dt, A_log, dt_bias)
            state, ys = None, []
            for lo in range(0, S, Q):
                part = slice(lo, lo + Q)
                yq, state = mamba.ssd_forward(
                    c, xs[:, part], B_[:, part], C_[:, part], dt[:, part],
                    A_log, dt_bias, state)
                ys.append(yq)
            bitwise = _bits_equal(torch.cat(ys, 1), y) and \
                _bits_equal(state, s)
            state = None
            for lo in range(0, S - 1, Q):
                part = slice(lo, min(lo + Q, S - 1))
                state = mamba.ssd_forward(
                    c, xs[:, part], B_[:, part], C_[:, part], dt[:, part],
                    A_log, dt_bias, state)[1]
            y1 = mamba.ssd_decode_step(
                c, xs[:, -1].reshape(1, cfg.ssm_heads, cfg.ssm_head_dim),
                B_[:, -1], C_[:, -1], dt[:, -1], A_log, dt_bias, state)[0]
            readings[f"SSD, layer {i}'s A_log"] = (
                bitwise, rel(y1, y[0, -1][None]))
        del proj, rows, xs, B_, C_, dt, xBC, y, s, h
        torch.cuda.empty_cache()
        shown = sorted({n for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 40)
                        if n < L} | {L})
        print(f"13a SSD gaps by layer ({dtype} activations), chunked vs "
              f"whole, the residual's last row over its largest |value|: "
              + ", ".join(f"layer {n} {layers[n - 1]:.3g}" for n in shown))
        print(f"13a layer 0 ({dtype} activations): in_proj {S // Q} x "
              f"{Q} rows vs {S} at once: bitwise "
              f"{readings['in_proj rows'][0]}, gap "
              f"{readings['in_proj rows'][1]:.3g}; "
              + "; ".join(f"{k}: chunked vs whole bitwise {b}, recurrence vs "
                          f"chunk form {g:.3g}" for k, (b, g)
                          in readings.items() if k.startswith("SSD")))
        for k, (bitwise, gap) in readings.items():
            if k.startswith("SSD"):
                _check(bitwise and gap <= MAMBA_RECURRENCE_TOL,
                       f"13a ({dtype}): the {k}, chunked bitwise whole, its "
                       f"recurrence within {MAMBA_RECURRENCE_TOL} of the "
                       f"chunk form")
        _check(layers[0] <= MAMBA_LAYER1_TOL[dtype],
               f"13a ({dtype}): layer 1's residual, chunked vs whole, within "
               f"{MAMBA_LAYER1_TOL[dtype]} of its largest |value|")
        found[dtype] = (layers, readings)
    return found


def _mamba_phase(dev):
    """13a: mamba2-1.3b at full width and all 48 layers, seeded random
    weights packed to P(16,2): phase 5's queue greedy and sampled, the same
    greedy with prefill interleaved (streams equal), a 2048-token prompt in
    chunks of ssm_chunk, the SSD's forms against each other
    (`_ssd_full_width`), launches against their formulas, one decode step
    profiled.  Returns (launch counts by run, cfg, params, prompts)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api, packing
    cfg = _mamba_cfg()
    print(f"mamba2 config: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_inner {cfg.ssm_d_inner}, {cfg.ssm_heads} SSM heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv {cfg.ssm_conv}, "
          f"chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}, dtype {cfg.dtype}")
    print("mamba2: reduced: {} (full width, 48 of 48 layers)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(13), cfg,
                      device=dev)
    params["embed"].mul_(1.0 / math.sqrt(cfg.d_model))  # as phase 5
    params = packing.pack_params(params, cfg)
    _release()
    torch.cuda.synchronize()
    print(f"mamba2: init + pack {time.perf_counter() - t0:.3f} s, weights "
          f"{packing.weight_bytes(params)} B, peak memory "
          f"{torch.cuda.max_memory_allocated()} B")
    rng = np.random.default_rng(13)
    system = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, int(n))])
               .astype(np.int32) for n in rng.integers(8, 57, 8)]
    base = dict(max_seq=256, base_seed=1)
    counts = {}

    def main_path(label, prompts_, **kw):
        ops.reset_launches()
        streams, eng, per_step, n_steps = _run_engine(cfg, params, prompts_,
                                                      label, **kw)
        counts[label] = ops.launch_counts()
        print(f"{label}: launches {json.dumps(counts[label])}")
        _ssm_path_checks(label, counts[label], per_step, n_steps, eng, cfg)
        return streams, eng

    greedy, eng = main_path("mamba2 greedy", prompts, greedy=True, **base)
    _check(not eng.paged and not eng.fused_decode and not eng.prefix_sharing
           and eng.batched_prefill,
           "13a: the SSM engine serves unpaged, unfused, batched prefill")
    summary = eng.kv_cache_summary()
    print(f"mamba2: decode state {summary['kv_bytes']} B for {eng.B} slots "
          f"({summary['kv_bytes'] // (eng.B * cfg.n_layers)} B a slot and "
          f"layer), metadata {summary['metadata_bytes']} B")
    main_path("mamba2 sampled", prompts, greedy=False, temperature=0.8,
              top_k=40, **base)
    interleaved = _run_engine(cfg, params, prompts, "mamba2 interleaved greedy",
                              greedy=True, prefill_chunks_per_step=1,
                              **base)[0]
    _check(_agreement(greedy, interleaved)[0] == 1.0,
           "13a: interleaved prefill's greedy streams equal prefill at "
           "admission")
    long_prompt = np.random.default_rng(14).integers(
        0, cfg.vocab_size, MAMBA_LONG).astype(np.int32)
    _, eng = main_path("mamba2 long prompt", [long_prompt], greedy=True,
                       max_seq=MAMBA_LONG + 16,
                       prefill_buckets=(cfg.ssm_chunk, 1))
    _check(eng.stats["prefill_chunks"] == MAMBA_LONG // cfg.ssm_chunk,
           f"13a: the {MAMBA_LONG}-token prompt in "
           f"{MAMBA_LONG // cfg.ssm_chunk} chunks of {cfg.ssm_chunk}")
    _ssd_full_width(cfg, params, long_prompt, dev)
    _ssd_layer_gaps(cfg, params, long_prompt, dev)
    return counts, cfg, params, prompts


# the kernel wrappers a main path reaches, (module of repro_torch.kernels,
# function); 13b captures each smoke run's calls of them and replays each
# against its plain version
_WRAPPERS = (("posit_codec", "decode"), ("posit_codec", "encode"),
             ("paged_attention", "paged_attention"),
             ("paged_attention", "decode_sample"),
             ("prefill_attention", "prefill_attention_paged"),
             ("posit_matmul", "posit_gemv_f"),
             ("posit_matmul", "posit_matmul_grouped"),
             ("pdpu_dot", "pdpu_matmul"))


@contextlib.contextmanager
def _capture_calls(device_type: str = "cuda", names=None, key=None):
    """Within the block, each wrapper of `_WRAPPERS` (those of `names` when
    given) called on a tensor of `device_type` keeps a copy of its
    arguments, taken before the call (K5 writes its pools in place), at
    the first call of each signature: the tensors' shapes, dtypes and
    strides and the other arguments' values, and `key(name, arguments)`
    when given (a call it maps to None is not kept).  Yields the list of
    (function name, bound arguments) it fills."""
    import importlib
    import inspect
    import torch
    calls, seen, saved = [], set(), []

    def sig(v):
        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), str(v.dtype), v.stride())
        return repr(v)

    def wrap(name, fn):
        signature = inspect.signature(fn)

        def wrapper(*args, **kw):
            bound = signature.bind(*args, **kw)
            bound.apply_defaults()
            a = bound.arguments
            first = next(iter(a.values()))
            mark = (name,) + tuple((k, sig(v)) for k, v in a.items())
            keep = (isinstance(first, torch.Tensor)
                    and first.device.type == device_type)
            if keep and key is not None:
                extra = key(name, a)
                keep, mark = extra is not None, mark + (extra,)
            if keep and mark not in seen:
                seen.add(mark)
                calls.append((name, {k: v.clone() if isinstance(
                    v, torch.Tensor) else v for k, v in a.items()}))
            return fn(*args, **kw)
        return wrapper

    for mod_name, fn_name in _WRAPPERS:
        if names is not None and fn_name not in names:
            continue
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        saved.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, wrap(fn_name, getattr(mod, fn_name)))
    try:
        yield calls
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def _replay_codec(a, decode):
    """K1 (decode) or K2 (encode) on captured arguments: bitwise its plain
    version.  Returns (max |err|, ms, plain ms, its `kernels/work.py`
    work, library ms, detail)."""
    from repro_torch.kernels import posit_codec as pc
    from repro_torch.kernels import work
    x, fmt = (a["codes"], a["fmt"]) if decode else (a["values"], a["fmt"])
    fn, plain = ((pc.decode, pc.decode_plain) if decode
                 else (pc.encode, pc.encode_plain))
    got = fn(x, fmt)
    _check(_bits_equal(got, plain(x, fmt)),
           f"{'K1' if decode else 'K2'} bitwise its plain version at "
           f"{list(x.shape)} {fmt}")
    ms = _device_ms(lambda: fn(x, fmt), launches=5)
    plain_ms = _time_once_ms(lambda: plain(x, fmt))
    w = (work.decode(x.numel(), x.element_size()) if decode
         else work.encode(x.numel(), got.element_size()))
    return 0.0, ms, plain_ms, w, None, "bitwise"


def _replay_gemv(a):
    """The float GEMV on captured arguments: within `sum_bound(x, w, None,
    fmt)` of its plain version (a limit `_gemv_f_faults` must fail),
    bitwise equal on a second call; torch.matmul on the decoded weights
    the library call."""
    import torch
    from repro_torch.kernels import posit_codec as pc
    from repro_torch.kernels import posit_matmul as pm
    from repro_torch.kernels import work
    x, w, fmt = a["x"], a["w_codes"], a["fmt_w"]
    (M, K), N = x.shape, w.shape[1]
    variant = pm.gemv_f_variant(M, fmt, w)
    got = pm.posit_gemv_f(x, w, fmt)
    _check(_bits_equal(pm.posit_gemv_f(x, w, fmt), got),
           f"the float GEMV ({variant}) bitwise equal on a second call at "
           f"M={M} K={K} N={N}")
    want = pm.posit_gemv_f_plain(x, w, fmt)
    bound = pm.sum_bound(x, w, None, fmt)
    gap = (got - want).abs()
    _check(bool((gap <= bound).all()),
           f"the float GEMV ({variant}) within sum_bound at M={M} K={K} "
           f"N={N}")
    xf, W = x.to(torch.float32), pc.decode_plain(w, fmt)
    faults = _gemv_f_faults(f"float GEMV M={M} K={K} N={N}", xf, W, want,
                            bound, _gemv_f_ks(variant, N, K))
    ms = _device_ms(lambda: pm.posit_gemv_f(x, w, fmt), launches=5)
    plain_ms = _time_once_ms(lambda: pm.posit_gemv_f_plain(x, w, fmt))
    lib = _device_ms(lambda: torch.matmul(xf, W), launches=5)
    return (float(gap.max()), ms, plain_ms,
            work.gemv_f(M, K, N, x.element_size(), w.element_size()), lib,
            f"{_units(gap, bound):.4g} units of sum_bound; planted: {faults}")


def _replay_grouped(a):
    """K9 on captured arguments: within `sum_bound` of its plain version
    (a limit `_planted_faults` must fail); torch.bmm on the decoded stacks
    the library call; the bound counts the codes of the experts holding a
    row and the rows' products."""
    import torch
    from repro_torch.kernels import posit_codec as pc
    from repro_torch.kernels import posit_matmul as pm
    from repro_torch.kernels import work
    x, w, fa, fb = a["a"], a["b_codes"], a["fmt_a"], a["fmt_b"]
    _check(a["fmt_out"] is None, "K9 replay: float output")
    E, M, K = x.shape
    N = w.shape[2]
    got = pm.posit_matmul_grouped(x, w, fa, fb)
    want = pm.posit_matmul_grouped_plain(x, w, fa, fb)
    bound = pm.sum_bound(x, w, fa, fb)
    gap = (got - want).abs()
    _check(bool((gap <= bound).all()),
           f"K9 within sum_bound at E={E} M={M} K={K} N={N}")
    A = x.to(torch.float32) if fa is None else pc.decode_plain(x, fa)
    W = pc.decode_plain(w, fb)
    faults = _planted_faults(f"K9 at E={E} M={M} K={K} N={N}", A, W, want,
                             bound)
    ms = _device_ms(lambda: pm.posit_matmul_grouped(x, w, fa, fb),
                    launches=5)
    plain_ms = _time_once_ms(lambda: pm.posit_matmul_grouped_plain(
        x, w, fa, fb))
    lib = _device_ms(lambda: torch.bmm(A, W), launches=5)
    rows = pm.occupied_rows_plain(x, fa)
    kernel_work = work.grouped(
        E, M, K, N, x.element_size(), w.element_size(), 4,
        pm.grouped_variant(M, fa, fb, w.dtype),
        experts=int((rows > 0).sum()), rows=int(rows.sum()))
    return (float(gap.max()), ms, plain_ms, kernel_work, lib,
            f"{int(rows.sum())} occupied rows; {_units(gap, bound):.4g} "
            f"units of sum_bound; planted: {faults}")


def _pages_as(pool, bt, fmt, dtype):
    """A pool's pages in each slot's block-table order, decoded: [B, M *
    page_size, F] in dtype."""
    from repro_torch.kernels import posit_codec as pc
    rows = pool[bt.long()]
    rows = pc.decode_plain(rows, fmt) if fmt is not None else rows
    return rows.reshape(bt.shape[0], -1, pool.shape[-1]).to(dtype)


def _attention_close(got, want):
    """The attention kernels' limits against their plain versions: 2e-5
    in f32, one bf16 ulp in bf16."""
    import torch
    if got.dtype == torch.bfloat16:
        return bool(torch.allclose(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-6))
    return bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))


def _owned_pages(a):
    """[B, M] bool: the pages of a K3 call's block tables its slots attend
    (below their lengths) that its page_ok lets it read."""
    import torch
    bt, ps = a["block_tables"], a["k_pages"].shape[1]
    att = (torch.arange(bt.shape[1], device=bt.device)[None] * ps
           < a["lengths"][:, None].long())
    return att, att & (a["page_ok"] != 0)


def _replay_paged(a):
    """K3 on captured arguments: finite and within 2e-5 of its plain
    version, a limit two planted faults must fail (q scaled by 1 + 2^-10,
    2^-6 for bf16 q, whose 8 significand bits 1 + 2^-10 leaves unchanged;
    each slot's newest key left out, or under page_ok each slot's last
    readable page masked); SDPA over the decoded pages with the
    same mask the library call; the bound counts the keys this data
    attends.  A shard's partials (o, m, l) are compared as K3 finalizes
    them (the merge of one shard), m and l within the same limit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    q, kp, vp, bt = a["q"], a["k_pages"], a["v_pages"], a["block_tables"]
    ln, win, fmt = a["lengths"], a["window"], a["fmt_kv"]
    partials, page_ok = a["partials"], a["page_ok"]
    _check(q.ndim == 3 and a["softcap_val"] == 0.0,
           "K3 replay: one token a slot")
    B, Hq, Dh = q.shape
    Hkv = kp.shape[-1] // Dh

    def final(r):
        return (pa.merge_attn_partials_plain(*(t[None] for t in r))
                if partials else r)

    got = pa.paged_attention(**a)
    plain = dict((k, v) for k, v in a.items() if k != "t_block")
    want = pa.paged_attention_plain(**plain)
    _check(bool(torch.isfinite(final(got)).all())
           and _attention_close(final(got), final(want))
           and (not partials or all(_attention_close(g, w) for g, w in
                                    zip(got[1:], want[1:]))),
           f"K3 within 2e-5 of its plain version at B={B} Hq={Hq} Hkv={Hkv} "
           f"Dh={Dh}{' (shard partials)' if partials else ''}")
    scale = 1 + 2.0 ** (-6 if q.dtype == torch.bfloat16 else -10)
    if page_ok is not None:
        own = _owned_pages(a)[1]
        last = own.shape[1] - 1 - own.flip(1).int().argmax(1)
        rows = torch.nonzero(own.any(1))[:, 0]
        masked = page_ok.clone()
        masked[rows, last[rows]] = 0
        second = ("each slot's last owned page masked",
                  dict(plain, page_ok=masked))
    else:
        second = ("the newest key left out",
                  dict(plain, lengths=(ln - 1).clamp(min=0)))
    for fault, bad in (("q scaled by 1 + eps", dict(plain, q=(
            q * scale).to(q.dtype))), second):
        _check(not _attention_close(final(pa.paged_attention_plain(**bad)),
                                    final(want)),
               f"K3: the limit rejects the planted fault '{fault}'")
    ms = _device_ms(lambda: pa.paged_attention(**a), launches=20)
    plain_ms = _time_once_ms(lambda: pa.paged_attention_plain(**plain))
    M = bt.shape[1]
    S = M * kp.shape[1]
    kd, vd = (_pages_as(t, bt, fmt, torch.float32).reshape(B, S, Hkv, Dh)
              .permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
              for t in (kp, vp))
    pos = torch.arange(S, device=q.device)
    qp = ln.long()[:, None] - 1
    mask = (pos[None] <= qp) & (qp - pos[None] < win.long())
    if page_ok is not None:
        mask &= (page_ok != 0).repeat_interleave(kp.shape[1], dim=1)
    lib = _device_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None].float(), kd, vd, attn_mask=mask[:, None, None]),
        launches=20)
    keys = int(mask.sum())
    return (float((final(got) - final(want)).abs().max()), ms, plain_ms,
            work.paged_attention(B, 1, Hq, Hkv, Dh, keys, kp.element_size(),
                                 M, keys, partials, page_ok is not None),
            lib,
            f"{keys} keys attended; planted faults rejected")


def _replay_sample(a):
    """K4 on captured arguments: each token the plain head + sampler's,
    or a score within 1e-5 of the largest |logit| of it; the runner-up
    token must fail that limit in some row."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    x, w, noise = a["x"], a["w"], a["noise"]
    greedy, top_k, T = a["greedy"], a["top_k"], a["temperature"]
    T = 1.0 if T is None else T
    head = {k: a[k] for k in ("plan", "fmt_w", "transpose", "softcap_val")}
    B, D = x.shape
    V = w.shape[0] if a["transpose"] else w.shape[1]
    tok = pa.decode_sample(**a)
    logits = pa.head_logits_plain(x, w, **head)
    want = pa.sample_logits(logits, noise, T, greedy=greedy, top_k=top_k)
    l = logits if greedy else pa.scale_logits(logits, T)
    if not greedy and 0 < top_k < V:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l >= kth, l, torch.full_like(l, -1e30))
    score = l if greedy else noise + l
    tol = 1e-5 * float(logits.abs().max())
    rows = torch.arange(B, device=x.device)
    gap = (score[rows, want.long()] - score[rows, tok.long()]).abs()
    _check(bool(((tok == want) | (gap <= tol)).all()),
           f"K4 tokens at B={B} D={D} V={V} (greedy={greedy})")
    second = torch.topk(score, 2, dim=-1).indices[:, 1]
    _check(bool((score[rows, want.long()] - score[rows, second] > tol).any()),
           "K4: the limit rejects the planted fault 'the runner-up token'")
    ms = _device_ms(lambda: pa.decode_sample(**a), launches=5)
    plain_ms = _time_once_ms(lambda: pa.decode_sample_plain(**a))
    return (float(gap.max()), ms, plain_ms,
            work.decode_sample(B, D, V, w.element_size(), x.element_size(),
                               greedy),
            None, "tokens equal; planted fault rejected")


def _replay_prefill(a):
    """K5 on captured arguments (the pools as they were before the call):
    pages bitwise and attention within 2e-5 (f32) or one bf16 ulp of its
    plain version, a limit two planted faults must fail (q scaled by 1 +
    2^-10, 2^-6 in bf16; the first KV head's chunk keys zeroed); SDPA over
    the decoded history and the chunk with the same mask the library
    call; the bound counts the history rows the window reaches, the rows
    written and the (query, key) pairs this data attends."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import prefill_attention as pf
    from repro_torch.kernels import work
    q, k, v, bt = a["q"], a["k"], a["v"], a["block_tables"]
    kp0, vp0, st, fmt = a["k_pages"], a["v_pages"], a["starts"], a["fmt_kv"]
    window, page_ok, act = int(a["window"][0]), a["page_ok"], q.dtype
    _check(a["softcap_val"] == 0.0, "K5 replay: no softcap")
    B, C, Hq, Dh = q.shape
    Hkv, ps, M = k.shape[2], kp0.shape[1], bt.shape[1]

    def fresh(**kw):
        return dict(a, k_pages=kp0.clone(), v_pages=vp0.clone(), **kw)

    got, kp, vp = pf.prefill_attention_paged(**fresh())
    want, kp2, vp2 = pf.prefill_attention_paged_plain(**fresh())
    _check(_bits_equal(kp[1:], kp2[1:]) and _bits_equal(vp[1:], vp2[1:]),
           f"K5 page writes bitwise at B={B} C={C} Hq={Hq} Hkv={Hkv} Dh={Dh}")
    _check(bool(torch.isfinite(got.float()).all())
           and _attention_close(got, want),
           f"K5 attention within its limit at B={B} C={C} Hq={Hq} Dh={Dh}")
    k0 = k.clone()
    k0[:, :, 0] = 0
    scale = 1 + 2.0 ** (-10 if act == torch.float32 else -6)
    for fault, kw in (("q scaled by 1 + eps", dict(q=(q * scale).to(act))),
                      ("the first KV head's chunk keys zeroed", dict(k=k0))):
        bad = pf.prefill_attention_paged_plain(**fresh(**kw))[0]
        _check(not _attention_close(bad, want),
               f"K5: the limit rejects the planted fault '{fault}'")
    pools = fresh()
    ms = _device_ms(lambda: pf.prefill_attention_paged(**pools), launches=10)
    plain_ms = _time_once_ms(lambda: pf.prefill_attention_paged_plain(
        **fresh()))
    S_h = M * ps
    # history comes from the global pool by global id under a shard
    hbt = a.get("hist_bt")
    hpools, hbt = (((kp0, vp0), bt) if hbt is None
                   else ((a["hist_pool_k"], a["hist_pool_v"]), hbt))
    hk, hv = (_pages_as(t, hbt, fmt, act).reshape(B, S_h, Hkv, Dh)
              for t in hpools)
    keys, vals = (torch.cat([h, c], 1).permute(0, 2, 1, 3).repeat_interleave(
        Hq // Hkv, dim=1) for h, c in ((hk, k), (hv, v)))
    hpos = torch.arange(S_h, device=q.device)[None]
    kv_pos = torch.cat([torch.where(hpos < st[:, None].long(), hpos, -1),
                        st[:, None].long()
                        + torch.arange(C, device=q.device)], 1)
    q_pos = st[:, None].long() + torch.arange(C, device=q.device)
    mask = ((kv_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= kv_pos[:, None])
            & (q_pos[:, :, None] - kv_pos[:, None] < window))
    lib = _device_ms(lambda: F.scaled_dot_product_attention(
        q.permute(0, 2, 1, 3), keys, vals, attn_mask=mask[:, None]),
        launches=10)
    starts, table = st.tolist(), hbt.tolist()
    ok = page_ok.tolist() if page_ok is not None else [[1] * M] * B
    hist = {(table[b][r // ps], r % ps) for b, s in enumerate(starts)
            for r in range(max(0, s - window + 1), s)}
    written = sum(1 for b, s in enumerate(starts) for j in range(C)
                  if (s + j) // ps < M and ok[b][(s + j) // ps])
    pairs = sum(min(s + j + 1, window) for s in starts for j in range(C))
    hist_bf16 = act == torch.bfloat16 or (
        fmt is not None and a["compute_dtype"] == torch.bfloat16)
    kernel_work = work.prefill(
        B, C, Hq, Hkv, Dh, q.element_size(), kp0.element_size(), len(hist),
        written, pairs, pf.prefill_variant(act, Dh),
        chunk_pairs=B * sum(min(j + 1, window) for j in range(C)),
        kv_terms=pf.prefill_kv_terms(kp0.dtype, fmt, hist_bf16))
    return (float((got.float() - want.float()).abs().max()), ms, plain_ms,
            kernel_work, lib,
            f"starts {starts}; planted faults rejected")


# columns of a K8 call the replay holds against the plain version: the
# first and the last K8_REPLAY_COLS / 2
K8_REPLAY_COLS = 64


def _replay_pdpu_calls(calls):
    """K8 on a run's captured calls: each call's output bitwise its plain
    version on the first and last K8_REPLAY_COLS / 2 columns (B a
    transposed view stays one: the head's layout).  The plain datapath
    runs one chunk step after another over all its outputs at once, so its
    time goes with K / N and not with the outputs: the calls of one K and
    configuration share one plain call over all their rows and checked
    columns, of which each call's block is read.  The first such group's
    check must reject the planted fault W_m + 1.  The bound of each call
    from its variant's SASS count.  Returns the rows `_replay_smoke_calls`
    takes, in the calls' order."""
    import collections
    import dataclasses
    import torch
    from repro_torch.kernels import pdpu_dot
    from repro_torch.kernels import work

    def checked(N, dev):
        half = K8_REPLAY_COLS // 2
        return (torch.arange(N, device=dev) if N <= K8_REPLAY_COLS else
                torch.cat([torch.arange(half, device=dev),
                           torch.arange(N - half, N, device=dev)]))

    groups = collections.defaultdict(list)
    for i, a in enumerate(calls):
        groups[(a["a_codes"].shape[1], a["cfg"])].append(i)
    rows = [None] * len(calls)
    for n_group, ((K, cfg), idx) in enumerate(groups.items()):
        xs = [calls[i]["a_codes"] for i in idx]
        dev = xs[0].device
        cols = [calls[i]["b_codes"][:, checked(calls[i]["b_codes"].shape[1],
                                               dev)] for i in idx]
        t0 = time.perf_counter()
        want = pdpu_dot.pdpu_matmul_plain(torch.cat(xs), torch.cat(cols, 1),
                                          cfg)
        if want.is_cuda:
            torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if n_group == 0:
            bad = pdpu_dot.pdpu_matmul_plain(
                torch.cat(xs), torch.cat(cols, 1),
                dataclasses.replace(cfg, w_m=cfg.w_m + 1))
            _check(not _bits_equal(bad, want),
                   "K8: the check rejects the planted fault 'W_m + 1'")
        variant = pdpu_dot.pdpu_variant(cfg)
        step, dec, _ = _k8_ops(cfg)
        r0 = c0 = 0
        for i, x, c in zip(idx, xs, cols):
            w = calls[i]["b_codes"]
            M, N = x.shape[0], w.shape[1]
            got = pdpu_dot.pdpu_matmul(x, w, cfg)
            block = want[r0:r0 + M, c0:c0 + c.shape[1]]
            _check(_bits_equal(got[:, checked(N, dev)], block),
                   f"K8 ({variant}) bitwise its plain version at M={M} "
                   f"K={K} N={N} ({c.shape[1]} columns)")
            r0, c0 = r0 + M, c0 + c.shape[1]
            ms = _device_ms(lambda: pdpu_dot.pdpu_matmul(x, w, cfg),
                            launches=3)
            rows[i] = (0.0, ms, plain_ms / len(idx),
                       work.pdpu(M, K, N, cfg.N, step, dec), None,
                       f"{c.shape[1]} of {N} columns bitwise (one plain call "
                       f"for the {len(idx)} calls at K {K}: {plain_ms:.1f} "
                       f"ms, shared out); planted fault W_m + 1 rejected")
    return rows


# the replays that take a run's whole list of calls
_BATCH_REPLAYS = (_replay_pdpu_calls,)


# kernel counter -> (captured function, replay, source, the TPU kernel)
_REPLAYS = {
    "posit_decode": ("decode", lambda a: _replay_codec(a, True),
                     "src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_codec.py:55"),
    "posit_encode": ("encode", lambda a: _replay_codec(a, False),
                     "src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_codec.py:78"),
    "posit_gemv_f": ("posit_gemv_f", _replay_gemv,
                     "src/repro_torch/csrc/posit_gemv_f.cu",
                     "src/repro/kernels/posit_codec.py:55"),
    "posit_matmul_grouped": ("posit_matmul_grouped", _replay_grouped,
                             "src/repro_torch/csrc/posit_matmul_grouped.cu",
                             "src/repro/kernels/posit_matmul.py:99"),
    "paged_attention": ("paged_attention", _replay_paged,
                        "src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:266"),
    "decode_sample": ("decode_sample", _replay_sample,
                      "src/repro_torch/csrc/decode_sample.cu",
                      "src/repro/kernels/paged_attention.py:467"),
    "prefill_attention": ("prefill_attention_paged", _replay_prefill,
                          "src/repro_torch/csrc/prefill_attention.cu",
                          "src/repro/kernels/prefill_attention.py:251"),
    "pdpu_matmul": ("pdpu_matmul", _replay_pdpu_calls,
                    "src/repro_torch/csrc/pdpu_dot.cu",
                    "src/repro/kernels/pdpu_dot.py:47"),
}


def _replay_smoke_calls(label, calls, counts, tag="13b", paths=None,
                        only=None):
    """Every kernel a run launched (of `only` when given), held against
    its plain version at each signature the run called it with
    (`_capture_calls`), each variant the run launched among the replayed
    ones.  Returns one kernel record a kernel, counting the launches of
    `paths` (`label`'s unless given; messages start with `tag`): ms,
    plain_ms, bound_ms and library_ms the sums over the signatures (one
    call each), bound_by the larger side of the bound's largest call."""
    from repro_torch.kernels import ops
    records = []
    for kernel, (fn_name, replay, source, replaces) in _REPLAYS.items():
        if not counts.get(kernel, 0) or (only is not None
                                         and kernel not in only):
            continue
        mine = [a for name, a in calls if name == fn_name]
        before = ops.launch_counts()
        rows = (replay(mine) if replay in _BATCH_REPLAYS
                else [replay(a) for a in mine])
        after = ops.launch_counts()
        launched = {k for k, n in counts.items()
                    if k.startswith(kernel + ":") and n}
        replayed = {k for k in launched if after[k] > before[k]}
        _check(bool(mine) and replayed == launched,
               f"{tag} {label}: {kernel} replayed at every variant the run "
               f"launched ({sorted(launched)}; replayed {sorted(replayed)})")
        bounds = [_bound(r[3]) for r in rows]
        libs = [r[4] for r in rows]
        for a, r, b in zip(mine, rows, bounds):
            shapes = ", ".join(f"{k} {list(v.shape)}" for k, v in a.items()
                               if hasattr(v, "shape") and v.dim())
            print(f"{tag} {label} {kernel} ({shapes}): ms {r[1]:.4f}, plain_ms "
                  f"{r[2]:.3f}, bound_ms {b[0]:.4f} ({b[1]}), library_ms "
                  f"{'none' if r[4] is None else f'{r[4]:.4f}'}, max_abs_err "
                  f"{r[0]:.3g}; {r[5]}")
        records.append(dict(
            name=f"{kernel} ({label}: {len(rows)} call signatures)",
            counter=kernel, paths=paths or (label,), source=source,
            replaces=replaces,
            max_abs_err=max(r[0] for r in rows), ms=sum(r[1] for r in rows),
            call_ms=None, plain_ms=sum(r[2] for r in rows),
            bound_ms=sum(b[0] for b in bounds),
            bound_by=max(bounds)[1],
            library_ms=(None if None in libs else sum(libs))))
    return records


def _recurrent_smoke_on_card(dev):
    """13b: the jamba and mamba2 smoke engines (serve_fused_p16, f32
    activations) with the same packed weights on the card and on the CPU,
    greedy, 6 requests sharing a 32-token prefix, 4 slots, 8 new tokens:
    equal streams; the card run's launches by variant (jamba: K5 (tc_f32,
    f32 at head_dim 16), K3, K4, K9 and the GEMV; mamba2: the GEMV, K1 and
    K2, no
    attention or fused head); every kernel the card run launched held
    against its plain version at each signature the run called it with
    (`_capture_calls`, `_replay_smoke_calls`).  Returns the card runs'
    launch counts and their kernel records."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.models import api, packing
    from repro_torch.models.module import tree_map
    from repro_torch.serve import Request, ServingEngine
    counts, records = {}, []
    for arch in ("jamba_1_5_large", "mamba2_1_3b"):
        cfg = configs.get_smoke(arch).replace(
            quant=policy_by_name("serve_fused_p16"))
        params = packing.pack_params(api.init(
            torch.Generator().manual_seed(5), cfg, device="cpu"), cfg)
        rng = np.random.default_rng(5)
        system = rng.integers(0, cfg.vocab_size, 32)
        prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size,
                                                        int(n))])
                   .astype(np.int32) for n in rng.integers(4, 41, 6)]
        streams, label = {}, f"{arch} smoke"
        for where in ("cpu", "cuda"):
            eng = ServingEngine(
                cfg, params if where == "cpu" else tree_map(
                    lambda t: t.to(dev), params), batch_slots=4, max_seq=128,
                greedy=True, device=where)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_new_tokens=8))
            ops.reset_launches()
            with _capture_calls() as calls:
                streams[where] = {r.rid: list(map(int, r.out_tokens))
                                  for r in eng.run()}
            if where == "cuda":
                counts[label] = ops.launch_counts()
        same, toks = _agreement(streams["cpu"], streams["cuda"])
        print(f"13b {label}: streams card vs CPU: {same:.3f} identical, "
              f"{toks:.3f} of tokens; stats "
              f"{json.dumps({k: eng.stats[k] for k in ('shared_admissions', 'prefill_chunks', 'decode_steps')})}")
        c = counts[label]
        print(f"13b {label}: launches by variant " + json.dumps(
            {k: v for k, v in c.items() if v}))
        _check(same == 1.0, f"13b {label}: the card's greedy streams equal "
                            f"the CPU's")
        if arch == "jamba_1_5_large":
            _check(eng.paged and eng.fused_decode
                   and eng.stats["shared_admissions"] > 0,
                   f"13b {label}: paged, fused decode, shared admissions")
            for name, variant in (("prefill_attention", "tc_f32"),
                                  ("decode_sample", "p16_2"),
                                  ("posit_matmul_grouped", "p16_2"),
                                  ("posit_gemv_f", "p16_2")):
                _check(c[name] > 0 and c.get(f"{name}:{variant}", 0) > 0,
                       f"13b {label}: {name} launched ({variant})")
            _check(c["paged_attention"] > 0,
                   f"13b {label}: paged_attention launched")
        else:
            _check(c["posit_gemv_f"] > 0 and c["paged_attention"]
                   == c["prefill_attention"] == c["decode_sample"] == 0,
                   f"13b {label}: the GEMV, no attention or fused head")
        del eng
        _release()
        records.extend(_replay_smoke_calls(label, calls, c))
        del calls
        _release()
    return counts, records


# ---------------------------------------------------------------------------
# phase 14: the stub-frontend configs at full width; QAT of the SSM family
# ---------------------------------------------------------------------------

PALI_TEXT = 64          # text tokens after paligemma's 256 image patches
PALI_DECODE = 16        # greedy decode steps after the image-prefix prefill
PALI_PREFIX = "paligemma image prefix"
PALI_RUNS = ("paligemma greedy", "paligemma sampled")
HUBERT_CLIPS = 8
HUBERT_FRAMES = 500     # 10 s of audio at HuBERT's 20 ms frame stride
HUBERT_FORWARD = "hubert forward"
HUBERT_TRAIN = "train hubert-xlarge"
MAMBA_TRAIN = "train mamba2-1.3b"
# mamba2's QAT peak learning rate.  At phase 9's 3e-3 the loss went from 252
# to 839 between steps 2 and 3 on an H100; why is not established (no float
# plan, smaller depth or reference run at full width was tried), so the rate
# is the MoE runs' lower one, at which the 4 steps' losses stay finite
MAMBA_PEAK_LR = 4.2e-4


def _image_prefix(cfg, params, patches, text, dev, steps, feed=None):
    """`api.prefill` of the vlm's image patches [B, P, F] and text tokens
    [B, T] into a dense cache of P + T + steps rows, then `steps` decode
    steps fed their greedy tokens (or `feed`'s rows).  Returns (the
    prefill's last-position logits, each step's logits, the cache, the
    launch counts after the prefill, prefill ms, [step ms])."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    S = cfg.frontend_tokens + text.shape[1]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = api.prefill(params, {"patches": patches,
                                             "tokens": text}, cfg,
                                    max_seq=S + steps, device=dev)
    last = logits[:, -1].float()
    _check(tuple(logits.shape) == (text.shape[0], S, cfg.vocab_size)
           and bool(torch.isfinite(last).all()),
           f"image prefix ({cfg.name}): finite prefill logits over "
           f"{cfg.frontend_tokens} patches + {text.shape[1]} tokens")
    del logits
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = dict(ops.launch_counts())
    toks = last.argmax(-1).to(torch.int32)
    outs, step_ms = [], []
    for i in range(steps):
        if feed is not None:
            toks = feed[i].to(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, cache = api.decode_step(params, toks, cache, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(lg.float())
        toks = lg.argmax(-1).to(torch.int32)
    _check(cache["length"].tolist() == [S + steps] * text.shape[0]
           and all(bool(torch.isfinite(o).all()) for o in outs),
           f"image prefix ({cfg.name}): {steps} finite decode steps from "
           f"position {S}")
    return last, outs, cache, after_prefill, prefill_ms, step_ms


def _image_prefix_small(dev):
    """14a's small input: paligemma's smoke config (P(16,2) weights, P(8,2)
    KV rows) on the card against the plain CPU path, the same packed
    weights, 2 rows of image patches + 12 tokens, then 2 decode steps fed
    the same tokens: prefill logits within 1e-4; KV codes equal, or at
    most _KV_FLIP_LIMIT the adjacent code (a value at a rounding boundary
    the two sides' sums straddle); decode logits within 1e-4, 1e-3 of the
    largest where a code differs."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing
    from repro_torch.models.module import tree_map
    cfg = configs.get_smoke("paligemma_3b").replace(
        quant=policy_by_name("serve_fused_p16"))
    params = packing.pack_params(api.init(
        torch.Generator().manual_seed(8), cfg, device="cpu"), cfg)
    rng = np.random.default_rng(8)
    patches = rng.normal(0, 1, (2, cfg.frontend_tokens,
                                cfg.frontend_dim)).astype(np.float32)
    text = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2))
                            .astype(np.int32))
    out = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        out[where] = _image_prefix(cfg, tree_map(lambda t: t.to(d), params),
                                   patches, text, d, 2, feed=feed)
    cpu, card = out["cpu"], out["card"]
    _check(bool(torch.allclose(card[0].cpu(), cpu[0], rtol=1e-4, atol=1e-4)),
           "14a small input: prefill logits on the card within 1e-4 of the "
           "CPU's")
    flips = 0
    for name in ("k", "v"):
        a = card[2][name].cpu().to(torch.int32)
        b = cpu[2][name].to(torch.int32)
        _check(bool(((a - b).abs() <= 1).all()),
               f"14a small input: {name} codes equal or adjacent")
        flips += int((a != b).sum())
    _check(flips <= _KV_FLIP_LIMIT, f"14a small input: {flips} KV codes "
                                    f"differ (limit {_KV_FLIP_LIMIT})")
    err = 0.0
    for a, b in zip(card[1], cpu[1]):
        a = a.cpu()
        close = (float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
                 if flips else bool(torch.allclose(a, b, rtol=1e-4,
                                                   atol=1e-4)))
        _check(close, "14a small input: decode logits on the card vs the "
                      "CPU's")
        err = max(err, float((a - b).abs().max()))
    print(f"14a small input (paligemma smoke, serve_fused_p16, "
          f"{cfg.frontend_tokens} patches + 12 tokens, 2 decode steps): "
          f"prefill max |logit diff| card vs CPU "
          f"{float((card[0].cpu() - cpu[0]).abs().max()):.3g}, decode "
          f"{err:.3g}, KV codes differing {flips}")


def _paligemma_phase(dev):
    """14a: paligemma-3b at full width and depth (18 layers, d_model 2048,
    8 query heads on 1 KV head of 256, d_ff 16384, vocab 257216, tied, 256
    patches of 1152), serve_fused_p16: the image-prefix path (`api.prefill`
    of 4 rows of 256 random patches + 64 tokens into the dense cache,
    then 16 greedy decode steps on the float weight path, the unfused tied
    head on the GEMV's transpose), then once more with every kernel call
    recorded (the same tokens and launches) and each replayed against its
    plain version (`_replay_smoke_calls`: K1 at the prefill's projections
    and the [257216, 2048] head, K2's KV rows and head re-encode, the GEMV
    at the decode steps' shapes); its small input on the card against the
    CPU; the text-only engine (the reference's engine embeds tokens only)
    on phase 5's queue, greedy and sampled, then both once more with every
    kernel call recorded (streams equal the first runs') and each replayed
    against its plain version with planted faults (K3 and K5 `tc256` at
    G 8, K4 greedy and sampling over the tied head, the GEMV at the narrow
    wk / wv, K1, K2); one decode step profiled.  Returns (launch counts by
    run, records)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.models import packing
    cfg = configs.get("paligemma_3b").replace(
        quant=policy_by_name("serve_fused_p16"))
    L, B = cfg.n_layers, 4
    print(f"14a paligemma config: {L} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}, "
          f"{cfg.frontend_tokens} patches of {cfg.frontend_dim}, dtype "
          f"{cfg.dtype}; reduced: {{}}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _dense_params(cfg, 40, dev)
    torch.cuda.synchronize()
    _check(params["layers"]["wq"].dtype == torch.int16
           and params["frontend_proj"].dtype == torch.float32,
           "14a: the trunk packed to P(16,2), frontend_proj float")
    trunk = sum(t.numel() for t in params["layers"].values())
    print(f"14a paligemma: init + pack {time.perf_counter() - t0:.3f} s, "
          f"{trunk} trunk weights, {params['embed'].numel()} embedding and "
          f"{params['frontend_proj'].numel()} frontend_proj weights, "
          f"{packing.weight_bytes(params)} B on the card; peak memory "
          f"{torch.cuda.max_memory_allocated()} B")
    counts = {}
    # ---- the image prefix over the dense cache
    rng = np.random.default_rng(40)
    patches = rng.normal(0, 1, (B, cfg.frontend_tokens, cfg.frontend_dim)
                         ).astype(np.float32)
    text = rng.integers(0, cfg.vocab_size, (B, PALI_TEXT)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    _, outs, cache, pre, pre_ms, step_ms = _image_prefix(
        cfg, params, patches, text, dev, PALI_DECODE)
    c = counts[PALI_PREFIX] = ops.launch_counts()
    tokens = [o.argmax(-1) for o in outs]
    del outs
    per_step = {k: v - pre[k] for k, v in c.items()}
    S = cfg.frontend_tokens + PALI_TEXT
    _check(pre["posit_decode:p16_2"] == pre["posit_decode"] == 7 * L + 1
           and pre["posit_encode:p8_2"] == 2 * L
           and pre["posit_encode:p16_2"] == 1 and pre["posit_gemv_f"] == 0,
           f"14a {PALI_PREFIX}: the prefill's {7 * L} projections and the "
           f"head on K1 (p16_2), its {2 * L} KV encodes on K2 (p8_2)")
    _float_path_checks(PALI_PREFIX, c, (per_step, PALI_DECODE), cfg,
                       head_t=1)
    _check(c["paged_attention"] == c["prefill_attention"]
           == c["decode_sample"] == 0,
           f"14a {PALI_PREFIX}: the dense cache runs no paged or fused "
           f"kernel")
    kv = sum(cache[n].numel() * cache[n].element_size() for n in ("k", "v"))
    print(f"14a {PALI_PREFIX}: {B} rows of {cfg.frontend_tokens} patches + "
          f"{PALI_TEXT} tokens, prefill {pre_ms:.3f} ms "
          f"({B * S / pre_ms * 1e3:.1f} positions/s), {PALI_DECODE} decode "
          f"steps, mean {float(np.mean(step_ms)):.3f} ms (median "
          f"{float(np.median(step_ms)):.3f}; {B / np.mean(step_ms) * 1e3:.2f} "
          f"tok/s), dense KV cache {kv} B ({kv // (B * (S + PALI_DECODE))} B "
          f"a token), peak memory {torch.cuda.max_memory_allocated()} B")
    print(f"14a {PALI_PREFIX}: prefill launches " + json.dumps(
        {k: v for k, v in pre.items() if v}))
    print(f"14a {PALI_PREFIX}: launches a decode step " + json.dumps(
        {k: v / PALI_DECODE for k, v in per_step.items() if v}))
    del cache
    _release()
    # the image prefix again with its kernel calls recorded (the same
    # greedy tokens), then each call replayed against its plain version
    label = f"{PALI_PREFIX} (calls recorded)"
    ops.reset_launches()
    with _capture_calls() as calls:
        _, outs, cache, *_ = _image_prefix(cfg, params, patches, text, dev,
                                           PALI_DECODE)
    recorded = ops.launch_counts()
    _check(all(torch.equal(o.argmax(-1), t) for o, t in zip(outs, tokens))
           and recorded == c,
           f"14a {label}: the greedy tokens and launches of the first run")
    del outs, cache
    _release()
    records = _replay_smoke_calls(label, calls, recorded, tag="14a",
                                  paths=(PALI_PREFIX,))
    del calls
    _release()
    _image_prefix_small(dev)
    # ---- the text-only engine on phase 5's queue
    system = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, int(n))])
               .astype(np.int32) for n in rng.integers(8, 57, 8)]
    base = dict(max_seq=256, page_size=16, base_seed=1)
    streams = {}
    runs = ((PALI_RUNS[0], dict(greedy=True)),
            (PALI_RUNS[1], dict(greedy=False, temperature=0.8, top_k=40)))
    for label, kw in runs:
        ops.reset_launches()
        streams[label], eng, per_step, n_steps = _run_engine(
            cfg, params, prompts, label, **kw, **base)
        c = counts[label] = ops.launch_counts()
        print(f"{label}: launches {json.dumps(c)}")
        _check(eng.execution_summary()["fused_prefill"]
               and eng.stats["shared_admissions"] > 0,
               f"{label}: fused prefill and shared admissions")
        _path_checks(label, c, "tc256")
        _float_path_checks(label, c, (per_step, n_steps), cfg)
        del eng
    _release()
    # the greedy and sampled runs again with their kernel calls recorded,
    # then each call replayed against its plain version
    label = "paligemma greedy and sampled (calls recorded)"
    ops.reset_launches()
    with _capture_calls() as calls:
        for run, kw in runs:
            again, eng, _, _ = _run_engine(
                cfg, params, prompts, f"{run} (calls recorded)", **kw, **base)
            _check(again == streams[run],
                   f"14a: the recorded {run} run's streams equal the first's")
            del eng
    recorded = ops.launch_counts()
    _profile(cfg, params, prompts, "paligemma", steps=1)
    _graph_phase("paligemma greedy", cfg, params, prompts, greedy=True,
                 **base)
    del params
    _release()
    records += _replay_smoke_calls(label, calls, recorded, tag="14a",
                                   paths=PALI_RUNS)
    del calls
    _release()
    return counts, records


def _encoder_small(dev):
    """14b's small input: hubert's smoke config, packed to P(16,2), on the
    card against the plain CPU path on the same frames: logits within
    1e-4."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing
    from repro_torch.models.module import tree_map
    cfg = configs.get_smoke("hubert_xlarge").replace(
        quant=policy_by_name("serve_fused_p16"))
    params = packing.pack_params(api.init(
        torch.Generator().manual_seed(9), cfg, device="cpu"), cfg)
    frames = torch.randn(2, 24, cfg.frontend_dim,
                         generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want = api.apply(params, {"frames": frames}, cfg)
        got = api.apply(tree_map(lambda t: t.to(dev), params),
                        {"frames": frames.to(dev)}, cfg).cpu()
    err = float((got - want).abs().max())
    _check(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4)),
           "14b small input: hubert smoke logits on the card within 1e-4 of "
           "the CPU's")
    print(f"14b small input (hubert smoke, serve_fused_p16, 2 x 24 frames): "
          f"max |logit diff| card vs CPU {err:.3g}")


def _hubert_phase(dev):
    """14b: hubert-xlarge at full width and depth (48 layers, d_model 1280,
    16 heads of 80, d_ff 5120, vocab 504, untied, bidirectional, frames of
    512): a packed serve_fused_p16 forward of 8 clips x 500 frames, twice
    (every projection and the head on K1 `p16_2` + torch.matmul, the
    attention the plain bidirectional one: head_dim 80 takes no attention
    kernel); the encoder attends both ways (the last frame moves the first
    frame's logits), a third forward whose kernel calls are recorded and
    replayed against their plain version (K1 at the projections and the
    head); its small input on the card against the CPU; then
    paper_mixed fused QAT on the same shape (`_qat_full_width`), K6 / K2 /
    K1 and the STE at its shapes (M 2000) and 3 smoke steps on the card
    against the CPU.  Returns (launch counts by run, records)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.models import api, packing
    from repro_torch.models.config import ShapeConfig
    full = configs.get("hubert_xlarge")
    cfg = full.replace(quant=policy_by_name("serve_fused_p16"))
    L = cfg.n_layers
    print(f"14b hubert config: {L} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, causal {cfg.causal}, frames of "
          f"{cfg.frontend_dim}, dtype {cfg.dtype}; reduced: {{}}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = packing.pack_params(api.init(
        torch.Generator(device=dev).manual_seed(50), cfg, device=dev), cfg)
    torch.cuda.synchronize()
    print(f"14b hubert: init + pack {time.perf_counter() - t0:.3f} s, "
          f"{packing.weight_bytes(params)} B on the card; peak memory "
          f"{torch.cuda.max_memory_allocated()} B")
    frames = torch.randn(HUBERT_CLIPS, HUBERT_FRAMES, cfg.frontend_dim,
                         generator=torch.Generator(device=dev).manual_seed(51),
                         device=dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = api.apply(params, {"frames": frames}, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    c = ops.launch_counts()
    _check(tuple(logits.shape) == (HUBERT_CLIPS, HUBERT_FRAMES,
                                   cfg.vocab_size)
           and bool(torch.isfinite(logits).all()),
           "14b hubert: finite logits [8, 500, 504]")
    _check(c["posit_decode:p16_2"] == c["posit_decode"] == 2 * (7 * L + 1)
           and c["posit_encode"] == c["posit_gemv_f"] == 0
           and c["paged_attention"] == c["prefill_attention"] == 0,
           f"14b hubert: each forward's {7 * L} projections and the head on "
           f"K1 (p16_2), no other kernel")
    moved = frames.clone()
    moved[:, -1] += 1.0
    # the same forward on the moved frames, its kernel calls recorded (a
    # run of the forward's shapes) and replayed against their plain version
    label = f"{HUBERT_FORWARD} (calls recorded)"
    ops.reset_launches()
    with _capture_calls() as calls, torch.no_grad():
        gap = float((api.apply(params, {"frames": moved}, cfg)[:, 0]
                     - logits[:, 0]).abs().max())
    _check(ops.launch_counts() == {k: v // 2 for k, v in c.items()},
           f"14b {label}: the launches of one forward")
    _check(gap > 1e-3, "14b hubert: the last frame moves the first frame's "
                       "logits (bidirectional)")
    tokens = HUBERT_CLIPS * HUBERT_FRAMES
    print(f"14b {HUBERT_FORWARD}: {HUBERT_CLIPS} clips x {HUBERT_FRAMES} "
          f"frames, ms {[round(t, 3) for t in times]} (the second "
          f"{tokens / times[1] * 1e3:.1f} frames/s), peak memory "
          f"{torch.cuda.max_memory_allocated()} B; the last frame moves "
          f"the first frame's logits by {gap:.4g}")
    print(f"14b {HUBERT_FORWARD}: launches " + json.dumps(
        {k: v for k, v in c.items() if v}))
    del params, logits, frames, moved
    _release()
    records = _replay_smoke_calls(label, calls, c, tag="14b",
                                  paths=(HUBERT_FORWARD,))
    del calls
    _release()
    _encoder_small(dev)
    shape = ShapeConfig("hubert", seq_len=HUBERT_FRAMES,
                        global_batch=HUBERT_CLIPS, kind="train")
    tc = _qat_full_width(
        dev, full.replace(quant=policy_by_name("paper_mixed")
                          .with_execution("fused")),
        HUBERT_TRAIN, 7, "of 48 layers, d_model 1280, 16 heads of 80, "
        "frames of 512, untied head of 504", shape)
    _release()
    M = tokens // TRAIN_ACCUM
    _train_ste(dev, HUBERT_TRAIN, "hubert_xlarge", M)
    _release()
    records += _train_kernels(dev, HUBERT_TRAIN, "hubert_xlarge", M)
    _release()
    _train_small_reference(dev, "hubert_xlarge", "14b")
    _release()
    return {HUBERT_FORWARD: c, HUBERT_TRAIN: tc}, records


def _mamba_train_phase(dev):
    """14c: mamba2-1.3b at full width and depth (48 layers) under
    paper_mixed fused QAT (`_qat_full_width`: phase 9's 4 steps of 8 x 128
    tokens, AdamW, remat per layer; in_proj and out_proj on K6), K6 / K2 /
    K1 and the STE at its training shapes (M 512), peak learning rate
    MAMBA_PEAK_LR, and 3 smoke steps of mamba2 and jamba (the hybrid:
    attention, mamba and MoE sub-layers) on the card against the CPU.  Returns (launch counts by run, records)."""
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    cfg = configs.get("mamba2_1_3b").replace(
        quant=policy_by_name("paper_mixed").with_execution("fused"))
    c = _qat_full_width(dev, cfg, MAMBA_TRAIN, 2,
                        "of 48 layers, d_model 2048, 64 SSM heads of 64, "
                        "state 128, vocab 50280, tied", peak_lr=MAMBA_PEAK_LR)
    _release()
    _train_ste(dev, MAMBA_TRAIN, "mamba2_1_3b")
    _release()
    records = _train_kernels(dev, MAMBA_TRAIN, "mamba2_1_3b")
    _release()
    for arch in ("mamba2_1_3b", "jamba_1_5_large"):
        _train_small_reference(dev, arch, "14c")
        _release()
    return {MAMBA_TRAIN: c}, records


# ---------------------------------------------------------------------------
# phase 15: kv_pages-sharded page pools on phase 5's weights and queue
# ---------------------------------------------------------------------------

SHARD_RUNS = ("sharded 2 greedy", "sharded 4 spilling greedy")
SHARD_LONG = 170        # 15b's extra prompt: 12 pages of 16 with 16 new tokens
SHARD_USABLE = 3        # 15b's usable pages a shard (4 pages with the trash)
# |first-step logit gap| / max |logit| of 15b's slot that spans four
# shards, on its own pages, against the single pool.  Its prefill writes
# the single pool's bytes and K3 over the gathered pool gives the single
# pool's logits bitwise (both checked), so the gap is the merge's: the
# four shards' partials summed in another f32 order than K3's own key
# split, then rounded into the bf16 activations of 4 layers.  The limit
# lies between that reading (9.06e-3, PERF.md) and the planted fault's
# (one shard's partials dropped), which must fail it.
SHARD_LOGIT_TOL = 2e-2


def _sharded_run(cfg, params, prompts, label, n_shards, **kw):
    """Serve `prompts` (16 new tokens each) greedy on a 4-slot engine over
    a pool split into `n_shards` shards of the card (`make_serving_mesh`),
    one step at a time, counting the run's launches from 0 and recording
    after each step each request's block-table row and the shards it
    addresses.  Checks every request served and every shard's pages
    returned.  Returns ({rid: tokens}, {rid: set of shards}, {rid: its
    last block-table row}, the engine, the launch counts)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_mesh, placement
    from repro_torch.serve import Request, ServingEngine
    mesh = make_serving_mesh(n_shards)
    print(f"15 {label}: mesh {placement(mesh)}")
    ops.reset_launches()
    engine = ServingEngine(cfg, params, batch_slots=4, greedy=True,
                           mesh=mesh, **kw)
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=16))
    spans, tables = {}, {}
    decode_ms = []
    t0 = time.perf_counter()
    while engine.queue or (engine.slot_phase != 0).any():
        chunks = engine.stats["prefill_chunks"]
        s0 = time.perf_counter()
        if not engine.step():
            break
        torch.cuda.synchronize()
        if engine.stats["prefill_chunks"] == chunks:
            decode_ms.append((time.perf_counter() - s0) * 1e3)
        for slot, req in enumerate(engine.slot_req):
            if req is not None:
                row = engine.block_tables[slot].copy()
                tables[req.rid] = row
                spans.setdefault(req.rid, set()).update(
                    engine.allocator.shard_of(int(p)) for p in row if p)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    done = {r.rid: list(map(int, r.out_tokens)) for r in engine.done}
    a = engine.allocator
    _check(len(done) == len(prompts)
           and all(len(t) == 16 for t in done.values()),
           f"15 {label}: every request served 16 tokens")
    _check(a.pages_in_use_by_shard == [0] * n_shards
           and a.pages_free_by_shard == [a.pages_per_shard - 1] * n_shards
           and not a._refs and not engine._held,
           f"15 {label}: every shard's pages returned after the drain")
    n_tok = sum(len(t) for t in done.values())
    print(f"15 {label}: {engine.n_shards} shards of "
          f"{a.pages_per_shard - 1} usable pages, tokens {n_tok}, wall "
          f"{wall:.3f} s, {n_tok / wall:.2f} tok/s, mean decode step "
          f"{float(np.mean(decode_ms)):.3f} ms over {len(decode_ms)} steps; "
          f"peak {a.peak_in_use} pages; stats " + json.dumps(
              {k: engine.stats[k] for k in ("shared_admissions",
                                            "pages_shared", "cow_forks",
                                            "prefill_chunks",
                                            "decode_steps")}))
    print(f"15 {label}: shards of each request's pages "
          + json.dumps({rid: sorted(v) for rid, v in sorted(spans.items())}))
    print(f"15 {label}: launches {json.dumps(counts)}")
    # the attention over pages: K3 with partials on every shard and one
    # merge a layer and decode step; one K5 a layer and chunk group, on the
    # home shard, reading history from the gathered global pool
    L, st = cfg.n_layers, engine.stats
    _check(counts["merge_attn_partials"] == L * st["decode_steps"] > 0
           and counts["paged_attention"]
           == n_shards * counts["merge_attn_partials"]
           and counts["paged_attention:merge"] == counts["paged_attention"],
           f"15 {label}: K3 on every shard, one merge a layer and step")
    _check(counts["prefill_attention"] == L * st["prefill_chunks"] > 0
           and counts["prefill_attention:global_hist"]
           == counts["prefill_attention"]
           == counts["prefill_attention:tc"],
           f"15 {label}: one K5 launch a layer and chunk group, on `tc`, "
           f"from the global pool")
    return done, spans, tables, engine, counts


def _phase15_key(name, a):
    """`_capture_calls`'s key in phase 15.  K3: its shard's partials only,
    by whether every page its slots attend is the shard's own (a call
    that may read none is not kept).  K5: whether page_ok masks some of
    the chunk's writes, and how many shards one slot's history spans."""
    if name == "paged_attention":
        if not a["partials"]:
            return None
        att, own = _owned_pages(a)
        if not bool(own.any()):
            return None
        return "mixed" if bool((att & ~own).any()) else "owned"
    if a["hist_bt"] is None:
        return None
    pps, ps = a["k_pages"].shape[0], a["k_pages"].shape[1]
    spans = [len({int(p) // pps for j, p in enumerate(row) if j * ps < st})
             for row, st in zip(a["hist_bt"].tolist(), a["starts"].tolist())]
    return bool((a["page_ok"] == 0).any()), max(spans)


def _replay_prefill_global(a):
    """K5 with global history on captured arguments: `_replay_prefill`'s
    checks (page writes bitwise its plain version, attention within its
    limit, planted faults rejected) and its attention bitwise the
    unsharded launch over the same global pool."""
    from repro_torch.kernels import prefill_attention as pf
    unsharded = dict(a, k_pages=a["hist_pool_k"].clone(),
                     v_pages=a["hist_pool_v"].clone(),
                     block_tables=a["hist_bt"], page_ok=None,
                     hist_pool_k=None, hist_pool_v=None, hist_bt=None)
    want = pf.prefill_attention_paged(**unsharded)[0]
    got = pf.prefill_attention_paged(**dict(
        a, k_pages=a["k_pages"].clone(), v_pages=a["v_pages"].clone()))[0]
    _check(_bits_equal(got, want),
           f"15 K5 with global history bitwise the unsharded launch at "
           f"{list(a['q'].shape)}")
    r = _replay_prefill(a)
    return r[:5] + (r[5] + "; bitwise the unsharded launch",)


def _merge_replay(dev, a, n_shards):
    """The merge at a captured K3 call's shapes (q, lengths and window as
    the run had them): a random P(8,2) pool of `n_shards` sub-pools as
    wide as the call's, slot 0's pages on shard 0 alone and the others'
    round-robin over the shards; each shard's K3 partials (ownership as
    page_ok) merged, against K3 over the whole pool: bitwise for slot 0,
    within 2e-5 elsewhere, and within 1e-6 of the merge's plain version.
    Returns (max |err|, ms, plain ms, bytes, ops, rate, library ms,
    detail)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    q, ln, win, fmt = a["q"], a["lengths"], a["window"], a["fmt_kv"]
    B, M = a["block_tables"].shape
    pps, ps, F = a["k_pages"].shape
    g = torch.Generator(device=dev).manual_seed(15)
    P = n_shards * pps
    kp, vp = (torch.randint(-127, 128, (P, ps, F), generator=g, device=dev,
                            dtype=torch.int32).to(torch.int8)
              for _ in range(2))
    bt = torch.zeros(B, M, dtype=torch.int32, device=dev)
    bt[0] = 1 + torch.arange(M, device=dev) % (pps - 1)
    for b in range(1, B):
        j = torch.arange(M, device=dev)
        bt[b] = ((b + j) % n_shards) * pps + 1 + (j + b) % (pps - 1)
    full = pa.paged_attention(q, kp, vp, bt, ln, win, fmt_kv=fmt)
    parts = []
    for s in range(n_shards):
        lo = s * pps
        owned = (bt >= lo) & (bt < lo + pps)
        parts.append(pa.paged_attention(
            q, kp[lo:lo + pps], vp[lo:lo + pps],
            torch.where(owned, bt - lo, 0).to(torch.int32), ln, win,
            fmt_kv=fmt, page_ok=owned.to(torch.int32), partials=True))
    o, m, l = (torch.stack([p[j] for p in parts]) for j in range(3))
    got = pa.merge_attn_partials(o, m, l)
    plain = pa.merge_attn_partials_plain(o, m, l)
    _check(_bits_equal(got[0], full[0]),
           "15 merge: a slot on one shard bitwise the unsharded K3")
    _check(bool(torch.allclose(got, full, rtol=2e-5, atol=2e-5))
           and bool(torch.allclose(got, plain, rtol=1e-6, atol=1e-6)),
           "15 merge: within 2e-5 of the unsharded K3 and 1e-6 of its plain "
           "version")
    ms = _device_ms(lambda: pa.merge_attn_partials(o, m, l), launches=20)
    plain_ms = _time_once_ms(lambda: pa.merge_attn_partials_plain(o, m, l))
    return (float((got - full).abs().max()), ms, plain_ms,
            work.merge(n_shards, m.numel() // n_shards, o.shape[-1]), None,
            f"{n_shards} shards, rows {list(got.shape)}; slot 0 bitwise the "
            f"unsharded K3")


def _sharded_record(name, counter, rows, source, replaces, label):
    """A kernels-line record over replayed signatures (sums, as
    `_replay_smoke_calls` builds them), counting the launches of the run
    `label`, whose signatures they are."""
    bounds = [_bound(r[3]) for r in rows]
    libs = [r[4] for r in rows]
    for r, b in zip(rows, bounds):
        print(f"15 {name}: ms {r[1]:.4f}, plain_ms {r[2]:.3f}, bound_ms "
              f"{b[0]:.4f} ({b[1]}), library_ms "
              f"{'none' if r[4] is None else f'{r[4]:.4f}'}, max_abs_err "
              f"{r[0]:.3g}; {r[5]}")
    return dict(name=f"{name} ({label}: {len(rows)} call signatures)",
                counter=counter, paths=(label,), source=source,
                replaces=replaces, max_abs_err=max(r[0] for r in rows),
                ms=sum(r[1] for r in rows), call_ms=None,
                plain_ms=sum(r[2] for r in rows),
                bound_ms=sum(b[0] for b in bounds), bound_by=max(bounds)[1],
                library_ms=None if None in libs else sum(libs))


def _launcher_on_card():
    """15c: `python -m repro_torch.launch.serve --mesh-model 2` at smoke
    width on the card in a subprocess; it must exit 0 and print the
    mesh's placement and each shard's occupancy."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "command_r_35b", "--smoke", "--quant", "serve_fused_p16",
           "--mesh-model", "2", "--requests", "4", "--new-tokens", "8"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:])
        print(res.stderr[-4000:], file=sys.stderr)
    _check(res.returncode == 0, "15c: the serving launcher exits 0")
    out = res.stdout
    _check("[serve] mesh: model[0]=cuda:0 model[1]=cuda:0" in out
           and "per-device page occupancy: d0=0/" in out,
           "15c: the launcher prints the placement and the occupancy")
    for line in out.strip().splitlines():
        print(f"15c launcher: {line}")
    print(f"15c launcher: {' '.join(cmd[1:])}: exit 0 in {wall:.1f} s")


def _spanning_first_step(cfg, params, prompt, table, n_pages, dev):
    """15b's spanning slot on its own pages: `prompt` prefilled into slot 0
    of a pool of `n_pages` split over four shards, its block-table row
    `table` (the engine's), then one greedy decode step, against the same
    over the single pool.  Checks the prefill's logits and the slot's pool
    bytes bitwise the single pool's, and K3 over the gathered pool (no
    merge) bitwise the single pool's first-step logits; reads the merged
    step's gap and that of a planted fault (one shard's partials dropped).
    Returns (the gap, the fault's gap), each max |logit diff| / max
    |logit|."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    one_c, _, one_pre, one_nxt = _prefill_slot0(cfg, params, prompt, dev, 256)
    sh_c, shard, sh_pre, sh_nxt = _prefill_slot0(
        cfg, params, prompt, dev, 256, shards=4, n_pages=n_pages, table=table)
    _check(_bits_equal(sh_pre, one_pre) and torch.equal(sh_nxt, one_nxt),
           "15b: the spanning slot's prefill logits bitwise the single pool's")
    n = len(prompt)

    def slot_rows(cache, key):
        pool = cache[key]
        if isinstance(pool, list):
            pool = torch.cat(pool, 1)
        rows = pool[:, cache["block_table"][0].long()]
        return rows.reshape(rows.shape[0], -1, rows.shape[-1])[:, :n]

    _check(all(_bits_equal(slot_rows(sh_c, key), slot_rows(one_c, key))
               for key in ("k", "v")),
           "15b: the spanning slot's prefill writes the single pool's bytes")
    gathered = dict(sh_c, k=torch.cat(sh_c["k"], 1), v=torch.cat(sh_c["v"], 1))

    def step(cache, shard=None):
        return api.decode_step(params, one_nxt, cache, cfg,
                               shard=shard)[0][0].float()

    one = step(one_c)
    _check(_bits_equal(step(gathered), one),
           "15b: K3 over the gathered pool gives the single pool's "
           "first-step logits bitwise")
    merged = step(sh_c, shard)
    merge, drop = ops.merge_attn_partials, 1

    def dropped(o, m, l):
        o, m, l = list(o), list(m), list(l)
        o[drop], l[drop] = torch.zeros_like(o[drop]), torch.zeros_like(l[drop])
        m[drop] = torch.full_like(m[drop], -2e38)
        return merge(o, m, l)

    ops.merge_attn_partials = dropped
    try:
        fault = step(sh_c, shard)
    finally:
        ops.merge_attn_partials = merge
    scale = float(one.abs().max())
    shards = sorted({int(p) // (n_pages // 4) for p in table.tolist() if p})
    print(f"15b: the spanning slot's pages {table.tolist()} (shards "
          f"{shards}): prefill logits and pool bytes bitwise the single "
          f"pool's; K3 over the gathered pool bitwise its first-step logits")
    return (float((merged - one).abs().max()) / scale,
            float((fault - one).abs().max()) / scale)


def _sharded_phase(cfg, params, prompts, paged_greedy, dev):
    """Phase 15 on phase 5's weights and queue.  Returns ({run label:
    launch counts}, the kernel records)."""
    import numpy as np
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import paged
    label_a, label_b = SHARD_RUNS
    base = dict(max_seq=256, page_size=16, base_seed=1)
    names = ("prefill_attention_paged", "paged_attention")
    # 15a: two shards, the default pool
    with _capture_calls(names=names, key=_phase15_key) as calls_a:
        greedy_a, spans_a, _, eng, c_a = _sharded_run(cfg, params, prompts,
                                                      label_a, 2, **base)
    subs = paged.layer_pools(eng.cache["k"], 0)
    _check(eng.n_shards == 2 and len(subs) == 2
           and paged.global_pool(subs, subs[0].device).data_ptr()
           == subs[0].data_ptr(),
           "15a: two sub-pools of one card, gathered as a view (no copy)")
    single = sorted(r for r, v in spans_a.items() if len(v) == 1)
    equal = [r for r in single if greedy_a[r] == paged_greedy[r]]
    print(f"15a: greedy streams equal to phase 5's: "
          f"{sum(greedy_a[r] == paged_greedy[r] for r in greedy_a)} of "
          f"{len(greedy_a)}; single-shard slots {single}, bitwise "
          f"{equal}")
    _check(single and equal == single,
           "15a: every single-shard slot's greedy stream is phase 5's")
    del eng
    # 15b: four shards of 3 usable pages; the long prompt needs all 12
    long = np.random.default_rng(15).integers(
        0, cfg.vocab_size, SHARD_LONG).astype(np.int32)
    n_pages = 4 * (SHARD_USABLE + 1)
    with _capture_calls(names=names, key=_phase15_key) as calls_b:
        greedy_b, spans_b, tables_b, eng, c_b = _sharded_run(
            cfg, params, prompts + [long], label_b, 4, n_pages=n_pages,
            **base)
    del eng
    spanning = sorted(r for r, v in spans_b.items() if len(v) == 4)
    _check(len(prompts) in spanning, "15b: the long prompt's slot spans all "
                                     "four shards")
    same = sum(greedy_b[r] == paged_greedy[r] for r in range(len(prompts)))
    gap, fault = _spanning_first_step(cfg, params, long,
                                      tables_b[len(prompts)], n_pages, dev)
    print(f"15b: slots spanning all four shards {spanning}; greedy streams "
          f"of phase 5's 8 requests equal to phase 5's: {same} of "
          f"{len(prompts)}; the long prompt's first decode step on its "
          f"engine pages over four shards vs the single pool: max |logit "
          f"diff| / max |logit| = {gap:.3g} (limit {SHARD_LOGIT_TOL}); "
          f"with shard 1's partials dropped {fault:.3g}")
    _check(gap <= SHARD_LOGIT_TOL < fault,
           "15b: the spanning slot's first-step logits within "
           "SHARD_LOGIT_TOL, and the planted fault outside it")
    # a sharded decode step profiled: the device's share of its window
    _profile(cfg, params, prompts, "sharded 2", mesh=make_serving_mesh(2),
             **base)
    # replays: every signature each run captured, counting that run's
    # launches: K5 with global history, K3's shard partials, the merge at
    # each K3 shape with the run's shard count
    records = []
    for label, calls, n_shards in ((label_a, calls_a, 2),
                                   (label_b, calls_b, 4)):
        k5 = [a for name, a in calls if name == "prefill_attention_paged"]
        k3 = [a for name, a in calls if name == "paged_attention"]
        keys = [_phase15_key("prefill_attention_paged", a) for a in k5]
        print(f"15 {label}: K5 signatures (masked writes, shards one "
              f"slot's history spans) {keys}; K3 partials signatures "
              f"{[_phase15_key('paged_attention', a) for a in k3]}")
        _check(bool(k5) and bool(k3), f"15 {label}: K5 and K3 captured")
        if n_shards == 4:
            _check(any(masked and hist > 1 for masked, hist in keys),
                   f"15 {label}: a K5 call with history on several shards "
                   f"and masked writes replayed")
        shapes = {}
        for a in k3:
            shapes.setdefault((tuple(a["q"].shape), tuple(a["k_pages"].shape),
                               tuple(a["block_tables"].shape)), a)
        records += [
            _sharded_record(
                "prefill_attention (global history)", "prefill_attention",
                [_replay_prefill_global(a) for a in k5],
                "src/repro_torch/csrc/prefill_attention.cu",
                "src/repro/kernels/prefill_attention.py:251", label),
            _sharded_record(
                "paged_attention (shard partials)", "paged_attention",
                [_replay_paged(a) for a in k3],
                "src/repro_torch/csrc/paged_attention.cu",
                "src/repro/kernels/paged_attention.py:266", label),
            _sharded_record(
                f"merge_attn_partials ({n_shards} shards)",
                "merge_attn_partials",
                [_merge_replay(dev, a, n_shards) for a in shapes.values()],
                "src/repro_torch/csrc/paged_attention.cu",
                "src/repro/kernels/ops.py:244", label)]
    _launcher_on_card()
    return {label_a: c_a, label_b: c_b}, records


# ---------------------------------------------------------------------------
# phase 16: K3 / K7 over pages of up to 1024 tokens, the posit-compressed
# cross-pod gradient reduction, the kernel autotune cache
# ---------------------------------------------------------------------------

LARGE_PAGES = (256, 512, 1024)
PAGE256_LABEL = "pages of 256 greedy"
PAGE256_SPEC_LABEL = "pages of 256 speculative greedy"
# (Hq, Hkv, head_dim, window): command-r's G 8 at 128; gemma3's G 2 at 256
# with its 1024-token window
LARGE_PAGE_SHAPES = ((64, 8, 128, 1 << 30), (8, 4, 256, 1024))
COMPRESS_LABEL = "compressed step mamba2-1.3b"
COMPRESS_STEPS = 3
COMPRESS_MESH = (2, 2)          # (pods, data replicas), model 1
# the step-0 checks read each leaf's first elements, at most this many
COMPRESS_CHECK_ELEMS = 1 << 24
_U = 2.0 ** -24


def _large_page_checks(dev):
    """16a: K3 and K7 (T = 4) over pages of 256, 512 and 1024 tokens at
    LARGE_PAGE_SHAPES, int8 P(8,2) and bf16 pages, lengths ending inside a
    split, on its edge and across pages: within 2e-5 of the plain version,
    every K7 row bitwise K3 at its own length, each launch merged, and the
    merge of two shards' partials (pages by parity) bitwise K3 for a slot
    whose page lies on one shard.  Returns max |err|."""
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    err = 0.0
    for ps in LARGE_PAGES:
        for Hq, Hkv, Dh, window in LARGE_PAGE_SHAPES:
            for kv in ("int8", "bf16"):
                M = max(1, 2048 // ps)
                lengths = [1, 128, 129, ps + 70, M * ps]
                B = len(lengths)
                g = torch.Generator(device=dev).manual_seed(ps + Dh)
                pool = torch.randn(2, B * M + 1, ps, Hkv * Dh, generator=g,
                                   device=dev)
                fmt = formats.P8_2 if kv == "int8" else None
                kp, vp = ((posit.pack(t, fmt) for t in pool) if fmt
                          else pool.to(torch.bfloat16).unbind(0))
                bt = torch.randperm(B * M, generator=g, device=dev) \
                    .reshape(B, M).to(torch.int32) + 1
                ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
                w = torch.tensor([window], dtype=torch.int32, device=dev)
                q3 = torch.randn(B, Hq, Dh, generator=g, device=dev)
                q4 = torch.randn(B, 4, Hq, Dh, generator=g, device=dev)
                what = f"K3 / K7 at pages of {ps} ({Hq} / {Hkv} x {Dh}, {kv})"
                outs = {}
                for q in (q3, q4):
                    ops.reset_launches()
                    got = pa.paged_attention(q, kp, vp, bt, ln, w, fmt_kv=fmt)
                    key = ("paged_attention_mq" if q.ndim == 4
                           else "paged_attention")
                    _check(ops.launch_counts()[f"{key}:merge"] == 1,
                           f"{what}: {key} splits and merges")
                    want = pa.paged_attention_plain(q, kp, vp, bt, ln, w,
                                                    fmt_kv=fmt)
                    _check(bool(torch.isfinite(got).all()) and bool(
                        torch.allclose(got, want, rtol=2e-5, atol=2e-5)),
                        f"{what}: {key} within 2e-5 of its plain version")
                    err = max(err, float((got - want).abs().max()))
                    outs[q.ndim] = got
                for i in range(4):
                    k3 = pa.paged_attention(q4[:, i].contiguous(), kp, vp,
                                            bt, ln - 3 + i, w, fmt_kv=fmt)
                    _check(_bits_equal(outs[4][:, i], k3),
                           f"{what}: K7 row {i} bitwise K3 at its length")
                ok = torch.zeros(B, M, dtype=torch.int32, device=dev)
                ok[:, 0::2] = 1
                parts = [pa.paged_attention(q3, kp, vp, bt, ln, w,
                                            fmt_kv=fmt, page_ok=o,
                                            partials=True)
                         for o in (ok, 1 - ok)]
                merged = pa.merge_attn_partials(
                    *(list(t) for t in zip(*parts)))
                _check(_bits_equal(merged[0], outs[3][0]),
                       f"{what}: merged shard partials bitwise K3 for a "
                       f"slot on one shard")
    print(f"16a K3 / K7 at pages of {LARGE_PAGES} (head_dim 128 G 8, "
          f"head_dim 256 G 2 window 1024; int8 and bf16): max |err| "
          f"{err:.3g} (limit 2e-5), K7 rows bitwise K3, a slot on one shard "
          f"merged bitwise")
    return err


def _large_pages_phase(cfg, params, prompts, greedy, dev):
    """16a on phase 5's weights and queue: the kernel checks above; K3 and
    K7 records at pages of 256 and 1024 (command-r's decode and verify
    shapes); phase 4's small-input check of command-r's smoke config at
    pages of 256 (300-token prompts, two 128-key splits a page); then the
    full-width engine at pages of 256 (max_seq 512), phase 5's queue
    greedy, counted from 0, beside a page-16 run at the same max_seq in
    this call, and speculatively (k = 4: K7 over pages of 256), counted
    from 0.  Returns ({label: launch counts}, records)."""
    from repro_torch.kernels import ops
    _large_page_checks(dev)
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    records = []
    for ps in (256, 1024):
        M = max(1, 1024 // ps)
        lengths = [M * ps, 129, 1, ps + 70]
        records.append(_k3_case(dev, f"pages of {ps}", Hq, Hkv, Dh, lengths,
                                1 << 30, M, 160 + ps, ps=ps))
        records.append(_k3_case(dev, f"pages of {ps}", Hq, Hkv, Dh, lengths,
                                1 << 30, M, 161 + ps, ps=ps, T=4))
    err, forced, flips = _small_reference(dev, "serve_fused_p16",
                                          "command_r_35b", page_size=256,
                                          prompt=300)
    print(f"16a small input (command_r_35b, serve_fused_p16, pages of 256, "
          f"300-token prompts): max |logit diff| card vs plain CPU "
          f"{err:.3g} (decode over the card's codes {forced:.3g}); KV codes "
          f"adjacent across a rounding boundary {flips}")
    base = dict(max_seq=512, base_seed=1, greedy=True)
    page16 = _run_engine(cfg, params, prompts, "pages of 16 greedy "
                         "(max_seq 512)", page_size=16, **base)[0]
    ops.reset_launches()
    page256, eng, _, _ = _run_engine(cfg, params, prompts, PAGE256_LABEL,
                                     page_size=256, **base)
    counts = ops.launch_counts()
    print(f"{PAGE256_LABEL}: launches {json.dumps(counts)}")
    _check(eng.layout.page_size == 256, "the engine serves pages of 256")
    _path_checks(PAGE256_LABEL, counts, "tc")
    _check(counts["paged_attention"] > 0
           and counts["paged_attention:merge"] == counts["paged_attention"],
           f"'{PAGE256_LABEL}': every K3 launch split its pages and merged")
    ops.reset_launches()
    spec, spec_eng, _, _ = _run_engine(cfg, params, prompts,
                                       PAGE256_SPEC_LABEL, page_size=256,
                                       speculate_k=SPEC_K, **base)
    spec_counts = ops.launch_counts()
    print(f"{PAGE256_SPEC_LABEL}: launches {json.dumps(spec_counts)}")
    _check(spec_eng.stats["spec_rounds"] > 0
           and spec_counts["paged_attention_mq"] > 0
           and spec_counts["paged_attention_mq:merge"]
           == spec_counts["paged_attention_mq"],
           f"'{PAGE256_SPEC_LABEL}': rounds ran, every K7 launch split its "
           f"pages and merged")
    for a, b, name in ((page256, page16, "pages of 256 vs pages of 16 at "
                        "max_seq 512"),
                       (page256, greedy, "pages of 256 vs phase 5's "
                        "defaults greedy"),
                       (spec, page256, "pages of 256, speculative vs "
                        "plain")):
        same, toks = _agreement(a, b)
        print(f"16a greedy streams, {name}: {same:.3f} of streams "
              f"identical, {toks:.4f} of tokens equal")
    for rec in records:
        rec["paths"] = ((PAGE256_SPEC_LABEL,)
                        if rec["counter"] == "paged_attention_mq"
                        else (PAGE256_LABEL, PAGE256_SPEC_LABEL))
    del eng, spec_eng
    return {PAGE256_LABEL: counts, PAGE256_SPEC_LABEL: spec_counts}, records


def _round_bound(codes, fmt):
    """The most the encode that gave each code can have rounded away: the
    larger distance from the code's value to the ends of the interval of
    values that round to it (`rounding_boundaries`: the pattern RNE's
    boundaries, not the midpoints between values; every nonzero magnitude
    below minpos rounds up to it, so that interval starts at 0; code 0
    comes from 0 only).  Magnitudes beyond maxpos, which saturate, are not
    covered (no gradient comes near 2^24)."""
    import torch
    from repro_torch.kernels import posit_codec
    k = codes.to(torch.int64).abs()
    v = posit_codec.decode_plain(codes, fmt).abs()
    edges = posit_codec.rounding_boundaries(fmt).to(v.device)
    zero = torch.zeros(1, dtype=v.dtype, device=v.device)
    lo = torch.cat([zero, edges])                  # lower edge of code k
    hi = torch.cat([edges, edges[-1:]])            # upper edge of code k
    idx = (k - 1).clamp(0, edges.numel())
    bound = torch.maximum(v - lo[idx], hi[idx] - v).clamp(min=0)
    return torch.where(k == 0, torch.zeros_like(v), bound)


def _compress_checks(gs, errs, red, new, fmt, limit=None):
    """Phase 16b's checks of one leaf's reduction over the n pods (the
    first `limit` elements): the reduced gradient against the plain f32
    mean of the pods' g + e, within the bound P(8,2)'s two roundings give
    (each pod's encode and the sum's, half a code gap each, over n, plus
    f32 slack); and error feedback conserving the sum: sum_i (g_i + e_i)
    = n r + sum_i e'_i up to the f32 rounding of those sums (a residual
    left out shows as a gap of P(8,2)'s rounding).  Returns the largest
    gap over each limit, (bound ratio, conservation ratio): both <= 1."""
    import torch
    from repro_torch.kernels import posit_codec
    n = len(gs)
    cut = (lambda t: t.reshape(-1)[:limit].to(torch.float32))
    gf = [cut(g) + cut(e) for g, e in zip(gs, errs)]
    r = cut(red[0])
    ne = [cut(e) for e in new]
    nt = torch.tensor(float(n), device=r.device)
    total = gf[0]
    for x in gf[1:]:
        total = total + x
    mean = total / nt
    codes = [posit_codec.encode_plain(x, fmt) for x in gf]
    s = posit_codec.decode_plain(codes[0], fmt)
    rounded = _round_bound(codes[0], fmt)
    for c in codes[1:]:
        s = s + posit_codec.decode_plain(c, fmt)
        rounded = rounded + _round_bound(c, fmt)
    rounded = rounded + _round_bound(posit_codec.encode_plain(s, fmt), fmt)
    mags = sum(x.abs() for x in gf)
    bound = rounded / nt + 8 * _U * (mags / nt + r.abs()) + 1e-38
    ratio_a = float(((r - mean).abs() / bound).max())
    rhs = r * nt + sum(ne)
    tol = 4 * n * _U * (mags + nt * r.abs() + sum(x.abs() for x in ne)) \
        + 1e-38
    ratio_b = float(((total - rhs).abs() / tol).max())
    return ratio_a, ratio_b


def _compressed_phase(dev):
    """16b: mamba2-1.3b at full width and depth (48 layers), paper_mixed
    fused QAT, through `make_train_step_compressed` on a (pod 2, data 2,
    model 1) mesh of cuda:0 (`make_train_mesh`): COMPRESS_STEPS steps of
    8 x 128 tokens (2 x 128 a replica), AdamW at MAMBA_PEAK_LR, counted
    from 0.  Per step: the loss, the step time, K1 / K2 `p8_2` launches
    and the int8 bytes handed between pods against `wire_bytes`.  Step
    0's reduction is checked leaf by leaf on the card (`_compress_checks`)
    and small leaves are replayed on the CPU (the plain codec) bitwise;
    after the run K2 / K1 `p8_2` over a slice of the largest leaf's
    g + e are held bitwise to `encode_plain` / `decode_plain` and timed at
    the largest leaf's shape.  Returns ({label: counts}, records)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.formats import P8_2
    from repro_torch.core.quant import policy_by_name
    from repro_torch.data import Pipeline
    from repro_torch.kernels import ops, posit_codec
    from repro_torch.kernels import work
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim import adamw, compress, constant_schedule
    from repro_torch.train import step as step_lib
    cfg = configs.get("mamba2_1_3b").replace(
        quant=policy_by_name("paper_mixed").with_execution("fused"))
    n_pods, n_data = COMPRESS_MESH
    mesh = make_train_mesh(n_pods, n_data)
    opt = adamw(constant_schedule(MAMBA_PEAK_LR))
    shape = _train_shape()
    ts = step_lib.make_train_step_compressed(cfg, opt, mesh)
    state = step_lib.init_state(torch.Generator(device=dev).manual_seed(16),
                                cfg, opt, dev)
    err = ts.init_err(state.params)
    leaves = tree_leaves(state.params)
    n_el = sum(t.numel() for t in leaves)
    wire = compress.wire_bytes(state.params, n_pods)
    print(f"16b {COMPRESS_LABEL}: mesh {mesh.shape} on "
          f"{sorted({str(d) for d in mesh.devices})}, {len(leaves)} leaves, "
          f"{n_el} parameters: masters {4 * n_el} B, AdamW moments "
          f"{8 * n_el} B, error trees {4 * n_el * n_pods} B, pod gradients "
          f"{4 * n_el * n_pods} B; wire_bytes {json.dumps(wire)}")
    pipe = Pipeline(cfg, shape)
    real = compress.compressed_psum_leaf
    seen = {"step": 0, "ratios": [0.0, 0.0], "replayed": 0, "leaves": 0}
    biggest = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    kept = {}

    def checked(gs, errs, fmt=P8_2):
        red, new = real(gs, errs, fmt)
        if seen["step"] == 0:
            i = seen["leaves"]
            seen["leaves"] += 1
            a, b = _compress_checks(gs, errs, red, new, fmt,
                                    COMPRESS_CHECK_ELEMS)
            seen["ratios"] = [max(seen["ratios"][0], a),
                              max(seen["ratios"][1], b)]
            if gs[0].numel() <= 1 << 20:
                handed = compress.BYTES_HANDED["int8"]
                cpu_red, cpu_new = real([g.cpu() for g in gs],
                                        [e.cpu() for e in errs], fmt)
                compress.BYTES_HANDED["int8"] = handed
                _check(all(_bits_equal(x.cpu(), y) for x, y in
                           zip(red + new, cpu_red + cpu_new)),
                       f"16b: leaf {i} reduced on the card bitwise its "
                       f"plain CPU reduction")
                seen["replayed"] += 1
            if i == biggest:
                kept["gf"] = (gs[0].reshape(-1)[:COMPRESS_CHECK_ELEMS]
                              .float() + errs[0].reshape(-1)[
                                  :COMPRESS_CHECK_ELEMS]).clone()
        return red, new

    compress.compressed_psum_leaf = checked
    losses, times, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        for s in range(COMPRESS_STEPS):
            batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in pipe.batch_at(s).items()}
            before = ops.launch_counts()
            handed = compress.BYTES_HANDED["int8"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (state, err), m = ts((state, err), batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            seen["step"] += 1
            losses.append(float(m["loss"]))
            after = ops.launch_counts()
            per_step.append({k: after[k] - before[k] for k in
                             ("posit_encode:p8_2", "posit_decode:p8_2",
                              "posit_encode:p13_2", "posit_decode:p13_2",
                              "posit_matmul:tc")})
            moved = compress.BYTES_HANDED["int8"] - handed
            print(f"16b step {s}: loss {losses[-1]:.4f}, step "
                  f"{times[-1]:.3f} ms, launches {json.dumps(per_step[-1])}, "
                  f"int8 bytes handed between pods {moved} "
                  f"({moved / n_pods:.0f} a pod; wire_bytes "
                  f"{wire['posit_bytes']:.0f} a device)")
            _check(abs(moved / n_pods - wire["posit_bytes"])
                   <= 2 * (n_pods - 1) * len(leaves),
                   "16b: the int8 bytes a pod hands match wire_bytes (up to "
                   "each leaf's padding)")
    finally:
        compress.compressed_psum_leaf = real
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_leaves = len(leaves)
    print(f"{COMPRESS_LABEL}: losses {[round(x, 4) for x in losses]}, steps "
          f"{[round(t, 3) for t in times]} ms, peak memory {peak / 1e9:.3f} "
          f"GB; launches {json.dumps(counts)}")
    _check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
           f"16b: finite losses, falling over {COMPRESS_STEPS} steps")
    for c in per_step:
        _check(c["posit_encode:p8_2"] == 2 * n_pods * n_leaves
               and c["posit_decode:p8_2"] == (n_pods ** 2 + 3 * n_pods)
               * n_leaves,
               f"16b: K2 p8_2 {2 * n_pods} and K1 p8_2 "
               f"{n_pods ** 2 + 3 * n_pods} launches a leaf a step")
    _check(counts["posit_matmul:tc"] > 0
           and counts["posit_encode:posit"] == 0,
           "16b: the replicas' QAT ran K6 tc, every K2 on a compile-time "
           "variant")
    ratio_a, ratio_b = seen["ratios"]
    print(f"16b step 0: {seen['leaves']} leaves checked; reduced gradient vs "
          f"the plain f32 mean of the pods' gradients {ratio_a:.3f} of "
          f"P(8,2)'s rounding bound; error feedback's conservation gap "
          f"{ratio_b:.3f} of its f32 limit; {seen['replayed']} leaves "
          f"replayed on the CPU bitwise")
    _check(seen["leaves"] == n_leaves and ratio_a <= 1.0 and ratio_b <= 1.0,
           "16b: step 0's reduced gradient within P(8,2)'s rounding bound of "
           "the f32 mean, error feedback conserving the sum")
    _check(seen["replayed"] > 0, "16b: small leaves replayed on the CPU")
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in pipe.batch_at(COMPRESS_STEPS).items()}
    _profile_step(lambda: ts((state, err), batch)[1],
                  f"{COMPRESS_LABEL} step")
    del state, err, ts, batch
    _release()
    gf = kept["gf"]
    codes = ops.encode(gf, P8_2)
    _check(_bits_equal(codes, posit_codec.encode_plain(gf, P8_2)),
           "16b: K2 p8_2 bitwise encode_plain on the step's g + e")
    _check(_bits_equal(ops.decode(codes, P8_2),
                       posit_codec.decode_plain(codes, P8_2)),
           "16b: K1 p8_2 bitwise decode_plain on the step's codes")
    records = []
    shape_big = tuple(leaves[biggest].shape)
    del leaves
    big = torch.randn(shape_big, device=dev) * float(gf.std())
    big_codes = ops.encode(big, P8_2)
    n_big = big.numel()
    for name, fn, plain, counter, kernel_work, src in (
            ("posit_encode (p8_2, gradient)",
             lambda: ops.encode(big, P8_2),
             lambda: posit_codec.encode_plain(big, P8_2),
             "posit_encode:p8_2", work.encode(n_big, 1),
             "src/repro/kernels/posit_codec.py:78"),
            ("posit_decode (p8_2, gradient)",
             lambda: ops.decode(big_codes, P8_2),
             lambda: posit_codec.decode_plain(big_codes, P8_2),
             "posit_decode:p8_2", work.decode(n_big, 1),
             "src/repro/kernels/posit_codec.py:55")):
        got, want = fn(), plain()
        _check(_bits_equal(got, want), f"16b: {name} bitwise its plain "
                                       f"version at {shape_big}")
        del got, want
        ms = _device_ms(fn, launches=5)
        call_ms = _time_ms(fn, reps=5)
        plain_ms = _time_once_ms(plain)
        bound, by = _bound(kernel_work)
        print(f"kernel {name} ({shape_big}): ms {ms:.4f}, call_ms "
              f"{call_ms:.4f}, plain_ms {plain_ms:.3f}, bound_ms {bound:.4f} "
              f"({by})")
        records.append(dict(
            name=name, counter=counter, paths=(COMPRESS_LABEL,),
            source="src/repro_torch/csrc/posit_codec.cu", replaces=src,
            max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None))
    del big, big_codes, gf, kept
    return {COMPRESS_LABEL: counts}, records


def _autotune_phase(dev):
    """16c: `launch/autotune.py`'s sweep of K7's t_block at the serving
    verify shape (B 4, T 4, 64 / 8 heads of 128, 16-token P(8,2) pages,
    M 16), each candidate's time printed; then K7 through
    `ops.paged_attention` with caches written to a temporary path: the
    swept winner, and t_block 4 (not the wrapper's default 2 at this
    shape).  Each launch reads the cache and runs the tile `ops` resolves
    from it (the reference's rule: a cached tile that does not divide T,
    or one below `_TILE_FLOOR`, yields to the default), counted as
    `paged_attention_mq:t<n>`, with the untuned launch's bits
    (REPRO_AUTOTUNE=off)."""
    import tempfile
    from repro_torch.kernels import autotune, ops
    from repro_torch.launch import autotune as launch_autotune
    import torch
    shape, fmts = launch_autotune.sweep_points(quick=True)["paged_attention"][0]
    g = torch.Generator(device=dev).manual_seed(16)
    run = launch_autotune._runner("paged_attention", shape, fmts, g, dev)
    params, ms, table = autotune.sweep("paged_attention", shape, run,
                                       fmts=fmts, reps=50)
    for row in table:
        print(f"16c sweep K7 {shape} {row['params']}: "
              + ("refused" if row["ms"] is None else f"{row['ms']:.4f} ms"))
    print(f"16c best {params} {ms:.4f} ms")
    launch = run({})
    tiles = lambda c: {k: v for k, v in c.items()  # noqa: E731
                       if k.startswith("paged_attention_mq:t") and v}
    saved = {k: os.environ.get(k) for k in ("REPRO_AUTOTUNE",
                                            "REPRO_AUTOTUNE_CACHE")}
    try:
        os.environ["REPRO_AUTOTUNE"] = "off"
        autotune.reset_cache(None)
        ops.reset_launches()
        untuned = launch()
        (default,) = tiles(ops.launch_counts())
        os.environ["REPRO_AUTOTUNE"] = "on"
        with tempfile.TemporaryDirectory() as tmp:
            for tb in (params["t_block"], 4):
                cache = autotune.AutotuneCache()
                cache.put("paged_attention", shape, {"t_block": tb},
                          fmts=fmts, ms=ms)
                path = cache.save(os.path.join(tmp, f"cache_t{tb}.json"))
                os.environ["REPRO_AUTOTUNE_CACHE"] = path
                autotune.reset_cache(None)
                ops.reset_launches()
                tuned = launch()
                on = tiles(ops.launch_counts())
                report = autotune.hit_report()
                resolved = ops._degrade_tile(shape[1], tb)
                want = (f"paged_attention_mq:t{resolved}" if resolved
                        else default)
                print(f"16c cache {path} (backend {cache.backend}) with "
                      f"t_block {tb}: untuned launch {{{default!r}: 1}}, "
                      f"tuned launch {on}; hits {json.dumps(report)}")
                _check(report == {"paged_attention": {"hits": 1,
                                                      "misses": 0}}
                       and on == {want: 1},
                       f"16c: the launch read the cache (t_block {tb}) and "
                       f"ran {want}")
                _check(_bits_equal(tuned, untuned),
                       f"16c: the launch tuned to t_block {tb} bitwise the "
                       f"untuned one")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.reset_cache(None)


# ---------------------------------------------------------------------------
# phase 17: the dry run's reckoning against the card
# ---------------------------------------------------------------------------

DRYRUN_TIMED_STEPS = 3
DRYRUN_PREFILL = 2048       # 17b's prompt
DRYRUN_DECODE_SEQ = 1024    # 17c's dense cache rows a slot


def _device_bytes(trees, dev) -> int:
    """Bytes of the tensors on `dev` in trees of dicts, tuples and
    tensors (a host scalar, such as an optimizer's step, is not the
    card's)."""
    from repro_torch.launch.dryrun import flat

    def on_dev(t):
        return t.device.type == dev.type and dev.index in (None,
                                                           t.device.index)
    return sum(t.numel() * t.element_size() for tree in trees
               for t in flat(tree) if on_dev(t))


def _dryrun_mismatches(rec, held: int, counts: dict) -> list:
    """The exact gates of phase 17 on a dry-run record `rec`: the
    reckoned state bytes (`memory.port`) against `held`, the bytes the
    run holds on the card, and the reckoned launches against
    `ops.launch_counts()` of one step (`counts`), key by key.  Returns
    what differs (empty: both hold)."""
    out = []
    want = rec["memory"]["port"]["total"]
    if want != held:
        out.append(f"state bytes reckoned {want} != held {held} "
                   f"({rec['memory']['port']})")
    got = {k: v for k, v in counts.items() if v}
    reckoned = rec["work"]["launches"]
    for k in sorted(set(got) | set(reckoned)):
        if got.get(k, 0) != reckoned.get(k, 0):
            out.append(f"launches {k}: reckoned {reckoned.get(k, 0)}, "
                       f"counted {got.get(k, 0)}")
    return out


def _dryrun_cell(label, cfg, shape, state, run, dev, accum=None,
                 packed=False):
    """Reckon `cfg` x `shape` on a one-position meta mesh, then run one
    step on the card (`run()`, which returns what the step allocates
    that the state counts: the prefill's cache) from the reset counters:
    the exact gates (`_dryrun_mismatches` over `state` and what `run`
    returned), the peak beside the reckoned one, then the median of
    DRYRUN_TIMED_STEPS more steps beside the roofline terms."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    rec = dryrun.analyze(dryrun.build_cell(cfg, shape, make_host_mesh(),
                                           accum=accum, packed=packed))
    reckon_s = time.perf_counter() - t0
    _release()
    torch.cuda.synchronize()
    # what earlier phases still hold on the card beside the cell's state
    others = torch.cuda.memory_allocated() - _device_bytes(state, dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    made = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    held = _device_bytes(tuple(state) + (made,), dev)
    del made
    bad = _dryrun_mismatches(rec, held, counts)
    _check(not bad, f"17 {label}: the dry run's reckoning equals the run: "
           + "; ".join(bad))
    times = []
    for _ in range(DRYRUN_TIMED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    step_ms = sorted(times)[len(times) // 2]
    r = rec["roofline"]
    print(f"17 {label}: reckoned in {reckon_s:.2f} s; state {held} B "
          f"(params {rec['memory']['port'].get('params')}, opt_state "
          f"{rec['memory']['port'].get('opt_state')}, batch "
          f"{rec['memory']['port'].get('batch')}, cache "
          f"{rec['memory']['port'].get('cache')}) = reckoned; launches = "
          f"reckoned {json.dumps(rec['work']['launches'])}")
    print(f"17 {label}: peak_live_bytes reckoned {rec['peak_live_bytes']}, "
          f"torch.cuda.max_memory_allocated {peak}, {others} B of it held "
          f"before the step outside the cell's state; less those "
          f"{(peak - others) / max(rec['peak_live_bytes'], 1):.4f} of the "
          f"reckoned")
    print(f"17 {label}: roofline compute_s {r['compute_s'] * 1e3:.3f} ms, "
          f"memory_s {r['memory_s'] * 1e3:.3f} ms, collective_s "
          f"{r['collective_s'] * 1e3:.3f} ms (dominant {r['dominant']}; "
          f"{rec['work']['device_ops']} device launches, flops "
          f"{rec['work']['flops']:.6g}, hbm_bytes "
          f"{rec['work']['hbm_bytes']:.6g}); measured median step "
          f"{step_ms:.3f} ms (steps {[round(t, 3) for t in times]} ms)")
    return {f"17 {label}": counts}


def _dryrun_phase(dev):
    """17a train, 17b prefill, 17c decode (see the module docstring);
    returns each cell's launch counts."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.launch import dryrun
    from repro_torch.models import api, packing
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import step as step_lib
    out = {}
    rng = np.random.default_rng(17)

    def tokens(shape, vocab):
        return torch.as_tensor(rng.integers(0, vocab, shape)
                               .astype(np.int32)).to(dev)

    # 17a: minitron-8b, 4 of 32 layers, QAT
    cfg = configs.get("minitron_8b").replace(
        n_layers=TRAIN_LAYERS,
        quant=policy_by_name("paper_mixed").with_execution("fused"))
    shape = ShapeConfig("phase17a", 128, 8, "train")
    opt = dryrun._opt_for(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(17), cfg,
                      device=dev)
    ts = step_lib.TrainState(params, opt.init(params),
                             torch.zeros((), dtype=torch.int32))
    batch = {k: tokens((8, 128), cfg.vocab_size)
             for k in ("tokens", "labels")}
    step = step_lib.make_train_step(cfg, opt, accum=TRAIN_ACCUM)

    def train_once():
        step(ts, batch)     # params and moments update in place

    out.update(_dryrun_cell("train minitron-8b", cfg, shape,
                            (params, ts.opt_state, batch), train_once, dev,
                            accum=TRAIN_ACCUM))
    del params, ts, batch, step
    _release()
    # 17b: mamba2-1.3b, 48 layers, packed, one 2048-token prompt
    cfg = _mamba_cfg()
    shape = ShapeConfig("phase17b", DRYRUN_PREFILL, 1, "prefill")
    params = api.init(torch.Generator(device=dev).manual_seed(17), cfg,
                      device=dev)
    params = packing.pack_params(params, cfg)
    _release()
    batch = {"tokens": tokens((1, DRYRUN_PREFILL), cfg.vocab_size)}
    out.update(_dryrun_cell(
        "prefill mamba2-1.3b", cfg, shape, (params, batch),
        lambda: api.prefill(params, batch, cfg, max_seq=DRYRUN_PREFILL,
                            device=dev)[1], dev, packed=True))
    del params, batch
    _release()
    # 17c: qwen3-moe-235b, 4 of 94 layers, packed, a decode step at 4 rows
    cfg = configs.get("qwen3_moe_235b").replace(
        n_layers=4, quant=policy_by_name("serve_fused_p16"))
    shape = ShapeConfig("phase17c", DRYRUN_DECODE_SEQ, 4, "decode")
    params = _init_moe_packed(cfg, 17, dev)
    cache = api.init_cache(cfg, 4, DRYRUN_DECODE_SEQ, device=dev)
    tok = tokens((4,), cfg.vocab_size)

    def decode_once():
        api.decode_step(params, tok, cache, cfg)

    out.update(_dryrun_cell("decode qwen3-moe-235b", cfg, shape,
                            (params, tok, cache), decode_once, dev,
                            packed=True))
    del params, cache, tok
    _release()
    return out


# ---------------------------------------------------------------------------
# phase 18: the compiled decode step, graphed against eager
# ---------------------------------------------------------------------------

# phase 18's configurations, in the order main() runs them, and their
# records
GRAPH_CONFIGS = ("defaults greedy", "defaults sampled", "a13 greedy",
                 "dense cache greedy", "bit_exact greedy", "MoE greedy",
                 "gemma3 greedy", "mamba2 greedy", "paligemma greedy")
GRAPH_RUNS: list = []


def _graph_run(cfg, params, prompts, label: str, graphed: bool,
               new_tokens: int, **kw):
    """`prompts` (`new_tokens` each) on a fresh 4-slot engine, counted from
    0, its decode steps replaying their graphs (`graphed`) or inside
    `disable_graphs()`: the record phase 18's gates read (streams, launches,
    decode steps, decode programs, graph replays, whether every graph was
    captured), the host-clock time of each step without prefill
    (synchronized; `replay_ms` those whose graphs were captured before the
    step), the graphs' replays alone timed by CUDA events after the run
    (`replay_device_ms`) and the peak of allocated memory over the run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.runtime.step_graph import disable_graphs
    from repro_torch.serve import Request, ServingEngine
    engine = ServingEngine(cfg, params, batch_slots=4, **kw)
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=new_tokens))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    step_ms, replay_ms = [], []
    with contextlib.nullcontext() if graphed else disable_graphs():
        while engine.queue or (engine.slot_phase != 0).any():
            chunks = engine.stats["prefill_chunks"]
            captured = (engine._steps is not None
                        and engine._steps["decode"].captured)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not engine.step():
                break
            torch.cuda.synchronize()
            if engine.stats["prefill_chunks"] == chunks:
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if captured:
                    replay_ms.append(step_ms[-1])
    launches = ops.launch_counts()
    summary = engine.execution_summary()
    done = sorted(engine.done, key=lambda r: r.rid)
    _check(len(done) == len(prompts)
           and all(len(r.out_tokens) == new_tokens for r in done),
           f"{label}: every request served {new_tokens} tokens")
    replay_device_ms = None
    if graphed and engine.device.type == "cuda":
        # the step's graphs replayed alone over the last step's buffers
        # (the engine is drained): a step's device time with the gaps
        # between the graph's kernels, without the host's work
        graphs = [g._graph for g in engine._steps.values()
                  if getattr(g, "captured", False)]
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            for g in graphs:
                g.replay()
        stop.record()
        torch.cuda.synchronize()
        replay_device_ms = start.elapsed_time(stop) / 10
    rec = {"streams": {r.rid: list(map(int, r.out_tokens)) for r in done},
           "launches": launches, "steps": engine.stats["decode_steps"],
           "programs": engine.stats["decode_device_programs"],
           "replays": summary["decode_graph_replays"],
           "captured": bool(summary["step_graphs"]) and all(
               g["captured"] for g in summary["step_graphs"].values()),
           "fused": engine.fused_decode, "step_ms": step_ms,
           "replay_ms": replay_ms, "replay_device_ms": replay_device_ms,
           "peak": torch.cuda.max_memory_allocated()}
    print(f"{label}: decode steps {rec['steps']}, programs "
          f"{rec['programs']}, graph replays {rec['replays']}, step graphs "
          f"{json.dumps(summary['step_graphs'])}, eager steps "
          f"{summary['eager_steps']}, peak memory {rec['peak']} B")
    return rec


def _graph_mismatches(label: str, graphed: dict, eager: dict,
                      per_step: int) -> list:
    """Phase 18's exact gates on a graphed and an eager run of one
    configuration (`_graph_run`'s records): the streams bitwise equal, the
    launches equal kernel by kernel and variant by variant (each run
    counted from 0), as many decode steps, `per_step` decode programs a
    step in both (1 fused, 2 unfused: the decode and the sampler), and in
    the graphed run every graph captured and every decode step after the
    first (the warm-up) `per_step` replays; none in the eager run.
    Returns the failures."""
    bad = []
    g_s, e_s = graphed["streams"], eager["streams"]
    differ = sorted(r for r in set(g_s) | set(e_s) if g_s.get(r) != e_s.get(r))
    if differ:
        bad.append(f"{label}: streams of requests {differ} differ")
    g_l, e_l = graphed["launches"], eager["launches"]
    off = {k: (g_l.get(k, 0), e_l.get(k, 0)) for k in sorted(set(g_l) | set(e_l))
           if g_l.get(k, 0) != e_l.get(k, 0)}
    if off:
        bad.append(f"{label}: launches (graphed, eager) differ: {off}")
    if graphed["steps"] != eager["steps"]:
        bad.append(f"{label}: decode steps {graphed['steps']} graphed, "
                   f"{eager['steps']} eager")
    for name, run in (("graphed", graphed), ("eager", eager)):
        if run["programs"] != per_step * run["steps"]:
            bad.append(f"{label}: {name} decode programs {run['programs']} "
                       f"for {run['steps']} steps, not {per_step} a step")
    want = per_step * (graphed["steps"] - 1)
    if not graphed["captured"] or graphed["replays"] != want:
        bad.append(f"{label}: graphed run replayed {graphed['replays']} "
                   f"times (captured {graphed['captured']}), not {want}")
    if eager["replays"]:
        bad.append(f"{label}: the eager run replayed {eager['replays']} "
                   f"graphs")
    return bad


def _graph_phase(label: str, cfg, params, prompts, new_tokens: int = 16,
                 **kw):
    """Phase 18 for one configuration on weights an earlier phase built:
    `prompts` served graphed and inside `disable_graphs()` (engine knobs
    `kw`), held to `_graph_mismatches`; the mean and median decode step on
    the host clock, the peak memory and the device-busy share of 4
    replayed (and 4 eager) steps under the profiler (`_profile`) beside
    each other.  Appends the record to GRAPH_RUNS."""
    import numpy as np
    from repro_torch.runtime.step_graph import disable_graphs
    runs = {}
    for graphed in (True, False):
        runs[graphed] = _graph_run(
            cfg, params, prompts,
            f"18 {label} {'graphed' if graphed else 'eager'}", graphed,
            new_tokens, **kw)
        _release()
    per_step = 1 if runs[True]["fused"] else 2
    bad = _graph_mismatches(f"18 {label}", runs[True], runs[False], per_step)
    for b in bad:
        print(f"18 FAILED: {b}")
    _check(not bad, f"18 {label}: graphed decode steps equal eager ones "
                    f"(streams, launches by variant, programs a step)")
    prof = {k: v for k, v in kw.items()
            if k in ("greedy", "temperature", "top_k", "max_seq",
                     "page_size", "paged")}
    busy = {True: _profile(cfg, params, prompts, f"18 {label} graphed",
                           **prof)}
    _release()
    with disable_graphs():
        busy[False] = _profile(cfg, params, prompts, f"18 {label} eager",
                               **prof)
    _release()
    rec = {"config": label, "programs_a_step": per_step,
           "decode_steps": runs[True]["steps"]}
    for graphed, name in ((True, "graphed"), (False, "eager")):
        r, b = runs[graphed], busy[graphed]
        rec[name] = {
            "mean_ms": float(np.mean(r["step_ms"])),
            "median_ms": float(np.median(r["step_ms"])),
            "replayed_mean_ms": (float(np.mean(r["replay_ms"]))
                                 if r["replay_ms"] else None),
            "replay_device_ms": r["replay_device_ms"],
            "profile_step_ms": b["step_ms"], "busy_ms": b["busy_ms"],
            "busy_share": (b["busy_ms"] / b["step_ms"] if b["busy_ms"]
                           else None),
            "peak_bytes": r["peak"]}
    print(f"18 {label}: " + json.dumps(rec))
    GRAPH_RUNS.append(rec)


def _planted_host_read():
    """Phase 18's last check: an `.item()` planted in the decode body of a
    command-r smoke engine on the card must make its capture raise at the
    second decode step, the graph left uncaptured (a step never falls back
    to eager dispatch).  Run last, on a small engine of its own."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing
    from repro_torch.serve import Request, ServingEngine
    cfg = configs.get_smoke("command_r_35b").replace(
        quant=policy_by_name("serve_fused_p16"))
    params = packing.pack_params(api.init(
        torch.Generator(device="cuda").manual_seed(3), cfg, device="cuda"),
        cfg)
    engine = ServingEngine(cfg, params, batch_slots=2, max_seq=64)
    body = engine._decode_body

    def planted(**kw):
        out = body(**kw)
        kw["length"].sum().item()
        return out

    engine._decode_body = planted
    rng = np.random.default_rng(3)
    for rid in range(2):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 12).astype(np.int32), max_new_tokens=8))
    raised = None
    try:
        for _ in range(8):
            engine.step()
    except RuntimeError as e:  # torch.AcceleratorError from the capture
        raised = e
    graph = engine._steps["decode"]
    print(f"18 planted host read: the capture raised "
          f"{type(raised).__name__ if raised else None}: "
          f"{str(raised).splitlines()[0] if raised else ''}; eager calls "
          f"{graph.eager_calls}, captured {graph.captured}, replays "
          f"{graph.replays}")
    _check(raised is not None and not graph.captured and graph.replays == 0
           and graph.eager_calls == 1,
           "18: a host read planted in the decode body fails the capture")
    torch.cuda.synchronize()


def _attribute_launches(kernels, runs):
    """Fill each kernel record's launches from the main-path runs' own
    counts (each from 0): launches_by_path, each run's count of the
    record's counter ("counter", else its name: a kernel, or one of its
    variants); launches, their sum; launches_by_variant, the same by the
    wrapper's variant.  A record counts the runs its "paths" name (the
    training runs and phase 10's models: their own); one without counts
    the runs that no other record of its kernel names."""

    def kernel_of(rec):
        return rec.get("counter", rec["name"]).split(":", 1)[0]

    named: dict = {}
    for rec in kernels:
        named.setdefault(kernel_of(rec), set()).update(rec.get("paths", ()))
    for rec in kernels:
        counter = rec.get("counter", rec["name"])
        paths = rec.get("paths") or [label for label in runs
                                     if label not in named[kernel_of(rec)]]
        rec["launches_by_path"] = {label: runs[label][counter]
                                   for label in paths}
        rec["launches"] = sum(rec["launches_by_path"].values())
        if ":" in counter:
            rec["launches_by_variant"] = {counter.split(":", 1)[1]:
                                          rec["launches"]}
        else:
            variants = sorted({key for label in paths for key in runs[label]
                               if key.startswith(counter + ":")})
            rec["launches_by_variant"] = {
                key.split(":", 1)[1]: sum(runs[label][key] for label in paths)
                for key in variants}
        rec["route"] = "cuda"


def main() -> int:
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        print("chip_smoke: src/repro_torch is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import set_float32_parity
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    _check(bool(smi), "nvidia-smi reports the card's name and power limit")
    print(f"device: {name}, count {count}")
    print(smi[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    set_float32_parity()
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {len(paths)} libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for src_name, log in _build.build_log.items():
        for line in log.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "Performance" in line):
                print(f"ptxas[{src_name}]: {line.strip()}")

    kernels = []
    for fn in (_k1_decode, _gemv_f, _k2_encode, _k3_attention,
               _k4_decode_sample, _k5_prefill, _k6_matmul, _k7_attention_mq,
               _k8_pdpu, _k8_table1, _k9_grouped):
        recs = fn(dev)
        torch.cuda.empty_cache()
        for rec in recs if isinstance(recs, list) else [recs]:
            plain = rec["plain_ms"]
            print(f"kernel {rec['name']} ({rec['shape']}): ms "
                  f"{rec['ms']:.4f} (device, graph replay), call_ms "
                  f"{rec['call_ms']:.4f} (per call with host overhead), "
                  f"plain_ms "
                  f"{'not measured' if plain is None else f'{plain:.3f}'}, "
                  f"bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']}), "
                  f"library_ms "
                  f"{'none' if rec['library_ms'] is None else round(rec['library_ms'], 4)}"
                  f", max_abs_err {rec['max_abs_err']:.3g}")
            kernels.append(rec)
    _attention_g16_float_pages(dev)
    torch.cuda.empty_cache()
    for arch, policy in (("command_r_35b", "serve_fused_p16"),
                         ("command_r_35b", "serve_fused_p16_a13"),
                         ("command_r_35b", "validate_bit_exact"),
                         ("qwen3_moe_235b", "serve_fused_p16"),
                         ("qwen3_moe_235b", "validate_bit_exact"),
                         ("gemma3_4b", "serve_fused_p16"),
                         ("command_r_plus_104b", "serve_fused_p16"),
                         ("paligemma_3b", "serve_fused_p16")):
        err, forced_err, flips = _small_reference(dev, policy, arch)
        print(f"small input ({arch}, {policy}): max |logit diff| card vs "
              f"plain CPU {err:.3g} (decode over the card's codes "
              f"{forced_err:.3g}); KV codes adjacent across a rounding "
              f"boundary {flips}")
    counts, cfg, cfg13, params, prompts, greedy = _serve(dev)
    _profile(cfg, params, prompts, "defaults")
    _profile(cfg13, params, prompts, "a13")
    _profile(cfg, params, prompts, "speculative round", steps=1,
             speculate_k=SPEC_K)
    # ---- the f32 activation path on phase 5's weights and queue: K5 on
    # tc_f32 (A/B against SIMT's prefill)
    counts_f32 = {}
    counts_f32[F32_RUNS[0]], recs = _f32_serving(
        F32_RUNS[0], cfg, params, prompts, greedy=True, max_seq=256,
        page_size=16, base_seed=1)
    kernels.extend(recs)
    # ---- phase 18 on phase 5's weights: the decode step's graphs against
    # eager dispatch (the later configurations where their weights live)
    base = dict(max_seq=256, page_size=16, base_seed=1)
    _graph_phase("defaults greedy", cfg, params, prompts, greedy=True,
                 **base)
    _graph_phase("defaults sampled", cfg, params, prompts, greedy=False,
                 temperature=0.8, top_k=40, **base)
    _graph_phase("a13 greedy", cfg13, params, prompts, greedy=True, **base)
    _graph_phase("dense cache greedy", cfg, params, prompts, greedy=True,
                 paged=False, max_seq=256, base_seed=1)
    # ---- phase 10c: the dense cache on phase 5's weights and requests
    counts10 = {"dense cache greedy": _dense_cache_phase(
        cfg, params, prompts, greedy, dev)}
    # ---- phase 15: kv_pages-sharded pools on phase 5's weights and queue
    counts15, recs = _sharded_phase(cfg, params, prompts, greedy, dev)
    kernels.extend(recs)
    # ---- phase 16a: K3 / K7 over pages of 256-1024 tokens; the engine at
    # pages of 256 on phase 5's weights and queue
    counts16, recs = _large_pages_phase(cfg, params, prompts, greedy, dev)
    kernels.extend(recs)
    _release()
    # the engines hold reference cycles (bound methods): collect them so
    # that each later phase starts with only its own weights on the card
    del params
    _release()
    # ---- phase 7: bit_exact at full width; phase 8: MoE at full width
    label = "bit_exact greedy"
    (counts[label], bx_cfg, bx_params, bx_prompts, counts[BIT_EXACT_W10],
     recs) = _bit_exact_phase(dev)
    kernels.extend(recs)
    print(f"{label}: launches {json.dumps(counts[label])}")
    _profile(bx_cfg, bx_params, bx_prompts, "bit_exact", steps=1)
    _graph_phase("bit_exact greedy", bx_cfg, bx_params, bx_prompts,
                 new_tokens=8, greedy=True, max_seq=64, page_size=16,
                 base_seed=1)
    del bx_params
    _release()
    label = "MoE greedy"
    counts[label], moe_cfg, moe_params, moe_prompts = _moe_phase(dev)
    print(f"{label}: launches {json.dumps(counts[label])}")
    _profile(moe_cfg, moe_params, moe_prompts, "MoE", steps=2)
    _graph_phase("MoE greedy", moe_cfg, moe_params, moe_prompts,
                 greedy=True, max_seq=256, page_size=16, base_seed=1)
    del moe_params
    _release()
    # ---- phase 9: QAT training of minitron-8b at full width, its STE
    # functions and kernel shapes, small-input agreement, the example,
    # checkpoints
    train_counts = _train_full_width(dev)
    _release()
    _train_ste(dev, TRAIN_LABEL, "minitron_8b")
    _release()
    kernels.extend(_train_kernels(dev, TRAIN_LABEL, "minitron_8b"))
    _release()
    tr, root = _train_small_reference(dev)
    _train_example(dev)
    _train_checkpoint(tr, root)
    del tr
    _release()
    # ---- phase 10: gemma3-4b and command-r-plus-104b at full width, the
    # serving example
    for phase in (_gemma3_phase, _command_r_plus_phase):
        c, recs = phase(dev)
        counts10.update(c)
        for rec in recs:
            rec.setdefault("paths", tuple(c))
        kernels.extend(recs)
        _release()
    _serve_example()
    # ---- phase 11: MoE QAT training at full width (qwen3-moe-235b, 1
    # layer, adafactor; deepseek-moe-16b, 4 layers, AdamW), then the
    # grouped STE and K9 at their training shapes, and each model's K6 /
    # K2 / K1 shapes and smoke steps against the CPU; phase 12: the
    # example twins
    train_runs = {TRAIN_LABEL: train_counts}
    for arch, layers, optimizer in MOE_TRAIN:
        label, c = _moe_train_full_width(dev, arch, layers, optimizer)
        train_runs[label] = c
    for arch, _, _ in MOE_TRAIN:
        label = f"train {arch}"
        kernels.append(_k9_train(dev, arch, label))
        _release()
        _train_ste(dev, label, arch)
        _release()
        kernels.extend(_train_kernels(dev, label, arch))
        _release()
        _train_small_reference(dev, arch, "11d")
        _release()
    _examples_on_card()
    # ---- phase 13: mamba2-1.3b at full width and all 48 layers (its
    # kernels at its shapes, serving, the SSD's forms, one step profiled);
    # the jamba and mamba2 smoke engines on the card against the CPU
    kernels.extend(_mamba_kernels(dev))
    _release()
    counts13, m_cfg, m_params, m_prompts = _mamba_phase(dev)
    _profile(m_cfg, m_params, m_prompts, "mamba2", steps=1)
    # phase 18: 4 requests of 16 tokens, 16 decode steps of all 48 layers
    _graph_phase("mamba2 greedy", m_cfg, m_params, m_prompts[:4],
                 greedy=True, max_seq=256, base_seed=1)
    del m_params
    _release()
    c, recs = _recurrent_smoke_on_card(dev)
    counts13.update(c)
    kernels.extend(recs)
    _release()
    # ---- phase 14: paligemma-3b's image prefix and text-only engine,
    # hubert-xlarge's forward and QAT, mamba2-1.3b's QAT, at full width
    counts14 = {}
    for phase in (_paligemma_phase, _hubert_phase, _mamba_train_phase):
        c, recs = phase(dev)
        counts14.update(c)
        kernels.extend(recs)
        _release()
    # ---- phase 16b: the posit-compressed cross-pod gradient reduction
    # (mamba2-1.3b at full width on a (2, 2, 1) mesh of cuda:0); 16c: the
    # autotune cache's sweep of K7's t_block and a tuned launch
    c, recs = _compressed_phase(dev)
    counts16.update(c)
    kernels.extend(recs)
    _release()
    _autotune_phase(dev)
    _release()
    # ---- phase 17: the dry run's reckoning against three cells on the card
    _dryrun_phase(dev)
    _release()
    # ---- phase 18's summary (each configuration ran where its weights
    # lived), then its planted host read
    names = [r["config"] for r in GRAPH_RUNS]
    _check(names == list(GRAPH_CONFIGS),
           f"18: every configuration graphed against eager ({names})")
    for r in GRAPH_RUNS:
        g, e = r["graphed"], r["eager"]
        print(f"18 summary {r['config']}: decode step mean / median "
              f"{g['mean_ms']:.3f} / {g['median_ms']:.3f} ms graphed "
              f"(replayed steps {g['replayed_mean_ms']}; the graphs "
              f"alone {g['replay_device_ms']} ms on the device), "
              f"{e['mean_ms']:.3f} / {e['median_ms']:.3f} ms eager; busy "
              f"share {g['busy_share']} graphed, {e['busy_share']} eager; "
              f"peak {g['peak_bytes']} B graphed, {e['peak_bytes']} B eager")
    _planted_host_read()
    # K3 splits every main path's key spans (tables of more than 2 pages)
    # and merges the partials: each launch ran the merge kernel
    for label, c in counts.items():
        _check(c["paged_attention"] > 0
               and c["paged_attention:merge"] == c["paged_attention"],
               f"'{label}': every K3 launch split its key span and merged")
    # every format a main path encodes (P(16,2) heads and weights, P(13,2)
    # activations, P(8,2) KV pages) has a compile-time K2 variant
    for label, c in counts.items():
        _check(c["posit_encode"] > 0 and c["posit_encode:posit"] == 0,
               f"'{label}': every K2 launch took a compile-time variant")
    # every main path runs bf16 activations: K5 must take its tensor-core
    # variant (exact three-term splits) on each of them
    for label, c in counts.items():
        _check(c["prefill_attention"] > 0
               and c["prefill_attention:tc"] == c["prefill_attention"],
               f"'{label}': every K5 launch took the tensor-core variant")
    runs = dict(counts, **counts10, **train_runs, **counts13, **counts14,
                **counts15, **counts16, **counts_f32)
    _attribute_launches(kernels, runs)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "launches_by_variant", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
