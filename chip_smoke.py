#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold every
kernel of it against its plain PyTorch version.

    python3 chip_smoke.py            # the whole check, on one card
    python3 chip_smoke.py --profile  # + round times, profiled rounds

Phases, each printing its lines; any failure raises and exits non-zero:

  1. environment: torch, the card, ``nvidia-smi`` name and power limit;
     TF32 off for float32 matmuls and convolutions.
  2. build: nvcc for every kernel source, all at once; the -Xptxas -v
     report (registers, spills). Then phase 14 (a)'s dry run starts in a
     process of its own beside the phases that follow.
  3. kernel check at the main paths' shapes: each kernel against its plain
     version on the card (prox_update within the stated tolerance, and a
     sweep's per-config case -- 3 configs of the CNN's device tier, each
     with its own alpha and lam read from device memory -- bit for bit; the
     compress kernels -- with error feedback: ef_topk, ef_randk, ef_int8,
     ef_sign; without: topk, randk, sign, and quantize -- bit for bit on
     every output, at the CNN LAN (40 senders) and WAN (4 senders) and the
     MCLR LAN uplinks, with runs of zeros, ties and tied uniforms; quantize
     also at the int8 store export, noise 0.5), its time by CUDA events,
     the plain version's time (each with the L2 cache cold), and the least
     time the card could take (every bound in this script comes from
     ``repro_torch.roofline.kernels`` on ``repro_torch.launch.mesh``'s H100
     constants); for the compress kernels also the time of
     the torch ops outside them (select thresholds, sign scales). The
     select kernels (topk, randk, ef_topk, ef_randk) are timed at all
     three uplinks, L2-cold and with a clean L2, each printing its grid
     (tiles x senders; a count and a scan launch), beside the timing floor
     (one elementwise add on 16 bytes); their thresholds (the least of an
     unsorted top-k) also by a sorted top-k, equal and timed.
  4. main path: ``run_scenario("fig2/fmnist/cnn/permfl", rounds=3)`` on the
     card at the registered size (4 teams x 10 devices, paper CNN at its
     published widths, K=5, L=10), with every launch count set to 0 just
     before and read just after: prox_update exactly rounds*K*L times, no
     compress kernel.
  5. compressed paths, each with the counts set to 0 just before it and
     read just after: every ``comm/mnist/mclr/*`` cell at its registered
     size (3 rounds), and the paper CNN of step 4 with each lossy
     compressor, with error feedback and without (2 rounds each): finite
     metrics, a lower loss, the ledger's bytes equal to the byte model,
     the compressor's kernel (EF or non-EF) launched exactly
     rounds*(K+1) times and no other compress kernel.
  6. path consistency: one round from the same state through the kernels
     and through the plain versions, uncompressed and with each lossy
     compressor with and without error feedback (same generator seed);
     the states must agree.
  7. serving, from step 4's trained state: a ``ModelStore`` exported in
     each encoding (the int8 export exactly one quantize launch, no other
     kernel), saved and reloaded bit-equal, decoded device rows equal to
     theta (delta, raw bit for bit; int8 within half a row scale); 512
     Zipf requests (batch 64, alpha 1.2, 10% unknown principals) replayed
     through ``serve`` and ``serve_cached``: the same outputs (bit for bit
     under delta and raw), the same tier counts summing to 512; qps,
     latency percentiles, the stage split, the device-tier MB and the
     cache hit rate.
 7b. baselines and the other PerMFL families, each path with the counts
     set to 0 just before it and read just after: 2 rounds of each
     baseline's CNN cell at its registered size and hyperparameters
     (``table1/mnist/cnn/{fedavg,perfedavg,pfedme,ditto}``,
     ``fig2/fmnist/cnn/{hsgd,l2gd}``; 4 x 10 devices, S = 48, P =
     206,922), each round's accuracies and host-clock seconds, peak
     memory: only the algorithm's metrics, finite, in [0, 1]; the served
     global model's train loss below the untrained model's (Per-FedAvg:
     that of its one-step adaptation, the model its meta-objective
     trains; its served loss is printed beside it); prox_update exactly
     (local_rounds + 1) * inner_steps (pFedMe: 60), local_steps (Ditto:
     20) and K * L (L2GD: 50) times a round, no kernel for FedAvg,
     Per-FedAvg and h-SGD, no other kernel. One round of pFedMe, Ditto
     and L2GD from the same state through the kernel and through the
     plain version (max |diff| over x and the personal tier within
     1e-4). A ModelStore exported from the Ditto run (no kernel): device
     rows equal ``serving_params`` (v) and team and global rows x, bit
     for bit; 512 Zipf requests replayed through it. Then one round of
     one cell of each PerMFL family beyond Table 1 and Fig 2 at its
     registered size (``table2/mnist/worst``, ``fig3/mnist/mclr``,
     ``fig4/mnist/mclr/both_25`` with sampled masks,
     ``dirichlet/mnist/a0.1``, ``quantity/mnist/q25``,
     ``featshift/dnn/s2``, ``teams/worst/m8n20``): prox_update exactly
     K * L times, finite metrics in [0, 1].
 7c. sweeps at full width (``sweep_scenario``), each with the counts set
     to 0 just before it and read just after, against each config's
     looped ``run_experiment`` and against ``run_sweep(mode="torch")``:
     Fig 3's nine grid points on ``fig3/mnist/mclr`` (seed 0, 6 rounds,
     the final PM / GM per point and the monotone checks of
     benchmarks/fig3_hparams.py as findings); the seven
     ``table1/mnist/cnn/*`` cells over three seeds, 2 rounds (the
     seed-mean best PM / GM and benchmarks/table1.py's two checks as
     findings; peak memory); ``comm/mnist/mclr/{int8,topk_10}`` over
     three seeds, 2 rounds (ledger bytes equal to the looped runs'). A
     sweep launches each kernel once for all its configs (prox_update
     K * L a PerMFL round, the looped count over the configs); a
     one-config sweep equals its looped run to the bit, and config 0
     each row of a sweep of copies of it; the kernel sweep the plain one
     within 1e-4; Fig 3's and the compressed cells' configs their looped
     runs within 1e-4 (the CNN cells' differences, which the batch size's
     summation order seeds and training amplifies, printed); configs per
     second, swept against looped (host clock). Fig 3's sweep again on
     the one-card sweep mesh (``sweep_scenario(mesh=make_host_mesh(
     n_sweep=1))``, phase 14 (d)): bit-equal to the unsharded sweep. Then
     ``table1/mnist/mclr/permfl`` swept over three system profiles
     (lan-campus, wan-cellular, edge-iot): each lane's timeline and
     trajectory equal to its solo run.
 7d. the cohort engine: prox_update at the cohort path's shape (2 x 256
     rows of the MCLR, P = 610) against its plain version, timed beside
     its bound; then the four ``cohort/virtual/n{1000,10000,100000,
     1000000}`` cells at their registered sizes and rounds (2 teams x
     10^3..10^6 devices, cohorts of 64..256, MCLR, K = L = 2) through
     ``run_scenario``, each with the counts set to 0 just before and
     read just after: prox_update exactly 4 a round and no other kernel;
     every round's index map sorted, distinct and in range; of a fixed
     sample of 4,096 theta rows, those never sampled bit-unchanged and
     those sampled moved; metrics finite in [0, 1]; the median round
     seconds, the synchronized parts (sample, gather, round, scatter,
     eval), the data's build and copy, the peak memory and the resident
     bytes. Then ``cohort/virtual/n1000`` at cohort = n bit-equal to its
     stacked run, and ``cohort/virtual/n10000`` with top-k 10% uplinks:
     ef_topk exactly K + 1 a round, never-sampled devices' EF residuals
     zero.
 7e. the system simulator: the seven ``comm/mnist/mclr/*`` cells on
     wan-cellular, 3 rounds (simulated seconds and accuracy at each
     eval; every lossy uplink priced below uncompressed); one seed run
     twice (equal timelines); uniform without a deadline (the trajectory
     bit-equal to the system-free run); ``fig2/fmnist/cnn/permfl`` at
     full width on edge-iot with a 16 s deadline, 2 rounds: stragglers
     dropped, and the system-free run fed the thinned masks bit-equal.
  7f. run telemetry (``repro_torch.obs``): ``fig2/fmnist/cnn/permfl``
     for 3 rounds with probes and health on and a trace dir, against the
     same seed with trace off: histories and state bit-equal,
     prox_update exactly 150 launches and no other kernel in each, every
     probe series finite and of length 3, the personalization gap's max
     above its mean, health ok, the JSONL event log read back and
     summarized, the span file's compile / dispatch / eval spans; the
     median round seconds with trace off and on over alternating runs,
     beside the card's name and power limit; one profiled round each way
     (``--profile-dir``: the exported trace names prox_update's kernel
     50 times; kernel launches and kernel time off and on);
     ``comm/mnist/mclr/topk_10`` traced (EF residual probes > 0, ef_topk
     exactly rounds * (K + 1)); ``table1/mnist/mclr/permfl`` at eta =
     1e30 with fail-fast (HealthError naming round 1); the int8 store
     export of step 4's state and a 512-request replay under an active
     span log with a metrics registry (one quantize launch inside the
     store_export span, tier counters summing to 512, one latency
     observation a batch, the Prometheus text written).
  8. LLM kernel check: flash_attention against its plain version at the
     serving path's shapes in bf16 (deepseek-moe-16b prefill (4, 1024,
     16, 128) causal; decode (4, 1, 16, 128) against a 1,040-slot cache
     at q_offset 1,030), each case with the variant ``plan`` picks
     (wgmma, split_kv and its chunks, simt); small bf16 cases on the
     Hopper variants (a ragged prefill, head_dim 64, GQA 40:8 and 12:2
     decode, a windowed decode); and, small, in f32 and bf16: GQA 40:8,
     head_dim 96 (bf16 on wgmma), a 256 window, non-causal, q bf16 over an
     f32 cache (f32 within 1e-5, bf16 within 2e-2); the Whisper and
     Qwen2-VL serving shapes in bf16: the encoder (4, 1,500, 12, 64)
     non-causal with 28-row q and kv tails, the cross-attention's prefill
     (64 queries on 1,500 keys) and decode (one query on 1,500 cached
     keys, non-causal, q_offset 0, split_kv over 11 chunks), Qwen2-VL's
     12:2 prefill (4, 1,024, 12, 128) and decode; the moe_router kernel on given logits
     (route_topk) at (4096, 64, k=6), (4, 64, k=6) and with tied rows (ids
     bit-equal, gates and statistics within 1e-6); the fused router
     (route_tokens: router product, top-k, capacity positions,
     statistics) at deepseek's prefill (4096 x 2048 bf16 tokens, k 6,
     groups of 1024, cap 120) and decode (4 tokens, one group), and with
     zero rows and tied experts (exactly equal ids), ragged and f32
     cases, a group longer than t and one token: ids may differ only at
     near-ties of the plain run (1e-5), pos equal to positions_ref of the
     kernel's own ids, gates and mean_prob within 1e-5, each case printing
     the form plan picks (tile or split, its clusters); its product's
     accuracy at deepseek's prefill shape in bf16 and f32 (k = E, not
     renormalised: every probability within 4e-6 of the float64 route's,
     relative; cuBLAS's f32 product read beside it). Times with the L2
     cold (the fused kernel also with a clean L2, beside the chain of ops
     it replaces on the same tensors and the timing floor), the plain
     versions' times, the bounds (the fused router's by bytes, with the
     TF32 and CUDA-core floors of its product), and for attention the
     library call's time (scaled_dot_product_attention on the same
     tensors; never the port's path).
     Jamba's attention (4, 1,024, 64:8 of 128) as its prefill (wgmma, the
     first group of 8 q-heads per kv-head) and as its decode (4 x 1 on
     1,040 slots, split_kv), timed; the fused router at Jamba's MoE (d
     8,192, E 16, k 2): its prefill (4,096 tokens, the tile form) and its
     decode (4 tokens, the split form: a cluster of 16 CTAs, each 8 chunks
     of 64 values of d), timed. phi3-mini's attention at head_dim 96
     (32 heads), timed: its prefill (4, 1,024, causal) on wgmma, its decode
     (4 x 1 on 1,040 slots at q_offset 1,030) on split_kv, and its training
     forward (the same prefill on ``wgmma`` with the log-sum-exp its
     backward reads, against ``attention_lse_ref``: lse within 1e-4),
     each beside its bound and scaled_dot_product_attention on the same
     tensors.
  9. LLM serving at full width: deepseek-moe-16b (28 layers, its
     published widths) in bf16, drawn on the card from a seeded
     generator; ``ServeEngine(max_len=1040, cache_dtype=bf16).generate``
     of 4 prompts of 1,024 tokens, 16 new tokens greedy, with the counts
     set to 0 just before and read just after: flash_attention and
     moe_router exactly 28 x 16 = 448 launches each, no other kernel,
     flash_attention's variants exactly 28 wgmma (the prefill) and 420
     split_kv (the decode steps), moe_router's exactly 448 fused and 0 on
     logits, (4, 16) tokens in range, finite logits;
     prefill ms, decode ms per step, tokens/s, peak device memory.
 10. LLM path consistency: the same config cut to 1 layer, in f32, the
     kernel path against the plain path: prefill logits of every position
     and the first decode step's, the router recorded at the MoE layer's
     routing seam (moe.route). The kernel's positions equal positions_ref
     of its own ids. Tokens whose routed and kept expert sets agree match
     within 1e-4; a token routed differently (a flip) must lie within 1e-5
     of a tie in the plain run; a token displaced from an expert's
     capacity by an earlier flip in its group is counted.
 11. RWKV kernel check: rwkv6_scan against its plain version at the
     rwkv6-7b serving shapes, bf16 r/k/v and f32 w in (0, 1) from a given
     nonzero state: the prefill (4, 1024, 64, 64) on the chunked
     tensor-core kernel, the decode (4, 1, 64, 64) on the sequential simt
     kernel, each case printing the variant ``plan`` picks; on chunked also
     t = 16, 17, 33, 130, bf16 w, strong decays with w exactly 0 and 1,
     state None, the state written in place; small f32 cases on simt
     (head size 16 and 32, t = 33 and 130, no state); and a state carried
     across a split (17 steps, then the rest) equal to one scan, in f32
     and in bf16. f32 within 1e-5 of the output's scale (sums in another
     order); a bf16 output within one bf16 rounding (2^-7 relative) of
     the plain one's; the state within 1e-5 of its scale. Times with the
     L2 cold and with a clean L2, simt's time on the prefill's tensors,
     the timing floor (one elementwise add on 16 bytes, timed the same
     way), the plain version's times, the bounds (bytes: a tensor-core
     form exists); no PyTorch call computes the recurrence.
 12. RWKV serving at full width: rwkv6-7b (32 layers, its published
     widths, 7,534,546,944 parameters as the reference's tree counts
     them) in bf16 with the float32 decay_w0 and bonus_u leaves, drawn on
     the card after the deepseek phases free theirs; the same generate
     as step 9 with exactly 32 x 16 = 512 launches of rwkv6_scan and no
     other kernel, its variants exactly 32 chunked (the prefill) and 480
     simt (the decode steps); prefill ms, decode ms per step, tokens/s,
     peak memory and the recurrent cache's bytes.
 13. RWKV path consistency: rwkv6-7b cut to 1 layer, in f32 (the simt
     kernel), the kernel path against the plain path: prefill logits of
     every position and the first decode step's within 1e-4.
 13b. Whisper serving at full width: whisper-small (12 decoder and 12
     encoder layers, d_model 768, 12 heads of 64, vocab 51,865 padded to
     51,968; 306,456,576 bf16 parameters as the reference's tree counts
     them) drawn on the card; ``generate`` of 4 prompts of 64 tokens over
     4 x 1,500 frame embeddings (the frontend stub's output), a bf16
     cache of 80 slots, 16 new tokens greedy, the counts set to 0 just
     before and read just after: flash_attention exactly 396 launches,
     36 wgmma (12 encoder, 12 causal self, 12 non-causal cross) and 360
     split_kv (15 decode steps x 12 self + 12 cross over the cached cross
     K/V), no other kernel; (4, 16) tokens in range, finite logits;
     prefill ms, decode ms per step, tokens/s, peak memory.
 13c. Qwen2-VL serving at full width: qwen2-vl-2b (28 layers, d_model
     1,536, GQA 12:2 of 128, vocab 151,936; 1,777,088,000 bf16
     parameters) through ``generate`` of 4 x 1,024 patch and text
     embeddings at an image prompt's M-RoPE positions (64 text rows, a
     28 x 32 grid at (64, 64 + row, 64 + col), 64 text rows from 96), a
     cache of 1,040 slots, each decode step at position prompt_len + i in
     all three components: flash_attention exactly 448 launches, 28 wgmma
     and 420 split_kv; the same checks and numbers.
 13d. Their path consistency: each cut to 1 layer (Whisper's encoder to 1
     layer too), in f32 (simt), kernel path against plain path on the
     serving prompts: prefill logits of every position and the first
     decode step's within 1e-4.
 13e. Jamba serving: jamba-1.5-large-398b cut to its first 5 layers at
     every published width (d_model 8,192, 64 q-heads on 8 kv-heads of
     128, d_ff 24,576, 16 experts top-2, Mamba d_in 16,384, d_state 16,
     d_conv 4, vocab 65,536): [(mamba, dense), (mamba, MoE), (mamba,
     dense), (mamba, MoE), (attn, dense)], exactly 24,045,707,264 bf16
     parameters as the reference's tree counts them (A_log, D, dt_bias and
     the router float32), 48.09 GB; the same generate as step 9:
     flash_attention exactly 16 (1 wgmma + 15 split_kv), moe_router
     exactly 32, all fused (2 tile + 30 split), mamba_scan exactly 4, all
     ``ring`` (the prefill's Mamba mixers; a decode step's recurrence step
     is torch ops), no other kernel; prefill ms, decode ms per step, tokens/s, peak
     memory; then every kernel one prefill and one decode step launch
     (torch.profiler).
 13f. Jamba consistency: the same path cut to 2 layers with attn_period 2,
     [(mamba, dense), (attn, MoE)] (11,912,896,512 parameters, 47.65 GB in
     f32), kernels against plain versions, under step 10's rule; the
     kernel path's prefill launches mamba_scan once, the plain path not
     at all. Then the Jamba cut's serving time by part (the Mamba mixer's
     in_proj, conv, SSM parameters, scan and out_proj, the rest of the
     mixer, attention, router, the rest of the MoE, the MLP, head), as
     step 16 times the other paths, its prefill's scan now the kernel.
 13g. attention backward check: flash_attention_bwd against its plain
     version (``attention_bwd_ref``) from the (out, lse) the forward
     kernel wrote, at phi3-mini's training shape (4 x 1,024, 32 heads of
     96, bf16, causal), deepseek's (4 x 1,024, 16 of 128, bf16), GQA 12:2
     with a 256 window on 512 queries and 768 keys (bf16, and f32), a
     ragged non-causal bf16 case at head_dim 64 (4 x 1,500, 12 heads),
     Whisper's cross-attention (4 x 448 queries on 1,500 keys, 12 of 64,
     non-causal) and decoder self-attention (4 x 448, causal), Qwen2-VL's
     (4 x 1,024, GQA 12:2 of 128) and qwen3-14b's (4 x 1,024, GQA 40:8 of
     128), the bf16 ones each with the forward's lse, its time, bound and
     SDPA's forward:
     each case's backward variant (``plan_bwd``: the tensor-core
     ``wgmma`` for every bf16 case, the CUDA-core ``simt`` for f32),
     held to the plain version with that variant's rounding (bf16 2e-2,
     f32 1e-4) and its error against the unrounded one printed, two
     launches bit-equal, its time (L2 cold), the plain version's, the
     bound (2.5x the forward's FLOPs against its bytes) and
     scaled_dot_product_attention's backward on the same tensors.
 13h. LLM training at full width: phi3-mini-3.8b at every published width
     in bf16 (3,821,079,552 parameters, 12 leaves), batches of 4 x 1,024
     tokens from ``repro_torch.data.tokens``, with the counts set to 0
     just before: one ``make_train_step`` with ``adamw()`` and grad_clip
     1.0, then two ``make_tier_round`` rounds (l_local 2, the example's
     alpha, lambda, gamma, eta, beta) of one team on the same batch:
     flash_attention and flash_attention_bwd exactly 32 per forward /
     backward pass (160 each; every forward and every backward the
     ``wgmma`` variant),
     prox_update exactly 2 x 2 x 12 = 48, tier_update 2 x 12 = 24, no
     other kernel; finite losses, the tier loss lower in round 2; ms per
     step, tokens/s, peak memory (under 80 GB), the second round's busy
     share (torch.profiler). Then prox_update and tier_update at phi3's
     largest leaf, w_gate, against their plain versions (tier_update bit
     for bit), timed beside their bounds, and each over the whole tree.
 13i. training consistency: phi3 cut to 2 layers in f32, one SGD
     ``make_train_step`` and one tier round through the kernels and
     through ``mode="torch"`` from the same parameters: losses and every
     parameter within 1e-5.
 13j. the MoE and RWKV-6 backward kernels against their plain versions:
     moe_router_bwd's ``fused`` variant (dl, dx and dw in one kernel)
     against ``route_tokens_full_bwd_ref``, from the fused forward's
     logits (written under a gradient), ids and gates of 4,096 x 2,048
     bf16 tokens (E 64, k 6, groups of 1,024), cotangents drawn for the
     gates and mean_prob: as drawn (timed: L2 cold, the plain version,
     the bound, the chain it replaced with x's cast inside), with zero
     rows and tied experts, with a padded last group, at Jamba's 4,096 x
     8,192 (E 16, k 2; timed), and dx only and dw only: dx within one
     bf16 rounding (2^-7) of each value plus 1e-5 of the largest, dw
     within 1e-5 of the largest, a repeat bit-equal, two launches counted
     ``fused``; the ``logits`` variant's dl within 1e-6 absolute + 1e-5
     relative at each, bit-equal; rwkv6_scan_bwd, both variants
     (``chunked``, the training path's, and ``simt``) on the same
     tensors, at rwkv6-7b's (4, 1,024, 64, 64), bf16 r/k/v, f32 w,
     without a state and a final-state cotangent (the training path's)
     and with both (each timed, both variants: L2 cold, the plain
     version, the bound by bytes, the CUDA-core floor), and at t = 17 and
     1,000: dr, dk, dv, dw, du and dstate0 each within 1e-5 of its scale
     (bf16 also one bf16 rounding), a repeat bit-equal, each launch
     counted on its variant.
 13k. MoE training: deepseek-moe-16b cut to 6 of 28 layers at every
     published width (every layer MoE: 64 experts, top-6, 2 shared;
     3,946,604,544 bf16 parameters, 16 leaves), 13h's AdamW step and two
     tier rounds with the counts set to 0 just before: flash_attention and
     flash_attention_bwd exactly 6 a pass (all ``wgmma``), moe_router
     exactly 6 a pass (all ``fused``, ``tile``), moe_router_bwd exactly 6
     a pass (all ``fused``), prox_update exactly 2 x 2 x 16, no other
     kernel; finite
     losses, the tier loss falling, peaks under 80 GB; ms a step and a
     round, tokens/s, busy share and the ten largest kernels.
 13l. RWKV-6 training: rwkv6-7b cut to 12 of 32 layers (3,161,001,984
     parameters, 25 leaves, decay_w0 and bonus_u float32), the same:
     rwkv6_scan exactly 12 a pass (all ``chunked``), rwkv6_scan_bwd
     exactly 12 a pass (all ``chunked``), prox_update exactly 2 x 2 x 25.
 13m. their consistency: each cut to 2 layers in f32, one AdamW step (lr
     1e-2, grad_clip 1.0) and one tier round through the kernels and
     through ``mode="torch"``: losses and the gradient norm within 1e-5,
     the first moments (the gradients) within 1e-5 of each leaf's scale,
     every stepped parameter within 1e-5 plus lr |u(g_k) - u(g_p)| (u(g)
     = g / (|g| + 1e-8), AdamW's first step: near g = 0 the two paths'
     rounding moves it by up to 2 lr), every leaf after the tier round
     within 1e-5; deepseek's router choices recorded at the routing seam
     and the tokens routed differently counted; its f32 router backward
     runs the ``logits`` variant.
 13n. Mamba's selective scan: each variant of mamba_scan (``ring``, the
     main path's, with its snapshots every 8 steps, and ``simt``, every
     32) and of mamba_scan_bwd (from them) against ``scan_ref`` and
     ``scan_bwd_ref`` at Jamba's (4, 1,024, 16,384, 16) in bf16, as
     training gives them (no h0, no final-state cotangent) and with both,
     in f32 with both, at s = 1, 17 and 1,000, and with A off the initial
     value's lattice (-exp(log(1..16) + N(0, 0.3))) in bf16 and f32: y
     within one bf16 rounding plus 1e-5 of the largest, the states,
     snapshots and every gradient within 1e-5 of their largest (bf16
     gradients also one bf16 rounding), a repeat bit-equal, each launch
     counted (the kernels' registers and spills are phase 2's ptxas
     lines); the training shape timed L2-cold on the same tensors (each
     forward without and with snapshots, each backward, each variant's
     training pass, forward with snapshots plus backward), beside the plain versions, the bound (the larger
     of bytes and the 1.07e9 exponentials at 16 a clock an SM) and the
     ring kernels' issue floor (instructions an element-step of their
     SASS loop).
 13o. Jamba training: jamba-1.5-large-398b cut to [mamba, attn, mamba]
     (num_layers 3, attn_period 3, every FFN dense: moe_layer_period past
     the depth) at every published width in bf16 (3,877,396,480
     parameters, 40 leaves), 13h's AdamW step and two tier rounds with
     the counts set to 0 just before: flash_attention and
     flash_attention_bwd exactly 1 a pass (``wgmma``), mamba_scan and
     mamba_scan_bwd exactly 2 a pass (``ring``), prox_update exactly 2 x 2
     x 40, no other kernel; finite losses, the tier loss falling, peaks
     under 80 GB; ms, tokens/s, busy share, the ten largest kernels and
     the selective scan's.
 13p. its consistency under 13m's rule: the 2-layer cut [mamba, attn]
     (2,853,068,800 parameters, 11.41 GB in f32), the kernel path's step
     launching mamba_scan and mamba_scan_bwd once, the plain path's
     neither.
 13q. phi3-mini serving at full width: phi3-mini-3.8b (32 layers, d_model
     3,072, 32 heads of 96, d_ff 8,192, vocab 32,064; 3,821,079,552 bf16
     parameters, param_count's plus the final norm) drawn on the card; the
     same generate as step 9: flash_attention exactly 512 launches, 32
     wgmma (the prefill) and 480 split_kv (the decode steps), no simt, no
     other kernel; prefill ms, decode ms per step, tokens/s, peak memory.
 13r. Whisper training at full width: whisper-small's whole tree
     (306,456,576 bf16 parameters, 35 leaves), 13h's AdamW step and two
     tier rounds on batches of 4 x 448 decoder tokens over 4 x 1,500
     frame embeddings drawn from a seeded generator, with the counts set
     to 0 just before: flash_attention and flash_attention_bwd exactly 36
     a pass (12 encoder, 12 self, 12 cross; all ``wgmma``), prox_update
     exactly 2 x 2 x 35, no other kernel; finite losses, the tier loss
     falling, peaks under 80 GB; ms, tokens/s, busy share, the ten
     largest kernels. Then one value_and_grad at full width through the
     kernels, the plain versions in bf16 and the plain versions in f32:
     each leaf's kernel-path error against the f32 gradients within twice
     the bf16 plain path's.
 13s. Qwen2-VL training at full width: qwen2-vl-2b's whole tree
     (1,777,088,000 bf16 parameters, 15 leaves, ``embed`` unread: zero
     gradients), the same on 4 x 1,024 embeddings at an image prompt's
     M-RoPE positions, targets -100 on the 896 image positions:
     flash_attention and flash_attention_bwd exactly 28 a pass (GQA 12:2
     at head_dim 128, all ``wgmma``), prox_update exactly 2 x 2 x 15; the
     same full-width gradient check. Then both models' consistency under
     13i's rule: Whisper cut to 2 decoder and 2 encoder layers, Qwen2-VL
     to 2 layers, in f32 (every attention ``simt``). 13i's SGD step, not
     13m's AdamW step: AdamW's first step is decided by rounding on 18%
     of Qwen2-VL's key bias, whose gradient is 0 but through M-RoPE's
     slowest frequencies.
 14. launch and roofline: (a) the dry run started after step 2
     (``python -m repro_torch.launch.dryrun --all``: 10 architectures x 4
     input shapes on fake tensors, no card visible to it), one line a
     record (FLOPs, bytes, the roofline's terms and dominant one, each
     kernel family's launches, peak bytes and whether they fit one
     card): none FAILED, only whisper-small x long_500k skipped, the
     seconds it took and waited for; (b) phi3-mini-3.8b's PerMFL device
     step (remat forward and backward, prox_sgd_tree) and
     deepseek-moe-16b's prefill at every published width on 4 x 1,024
     tokens, each built by ``build_step_and_args`` and run once on fake
     tensors and once on the card under the op counter, the counts set to
     0 just before the card's run and read just after: argument bytes
     equal to the byte, counted FLOPs and each seam's launches equal, the
     card's launches each seam's, flash_attention, flash_attention_bwd
     and prox_update (phi3) and flash_attention and moe_router (deepseek)
     launched, every attention forward on wgmma (phi3's at head_dim 96);
     the predicted peak against max_memory_allocated and their
     ratio, the step's synchronized time against the larger of its
     roofline's compute and memory terms; the phase's added seconds.
 15. examples: the port's counterparts of the reference's examples, run
     on the card as a user runs them, each run with the counts set to 0
     just before it and read just after, its host-clock seconds and
     launches on a line of its own: ``examples/quickstart_torch.py`` at
     its 10 rounds (the paper's MCLR cell at 4 x 10 devices, its top-10%
     uplinks, fp32 and top-10% uplinks on wan-cellular): PM above GM at
     the end, the compressed run's bytes under fp32's, top-10% fewer
     simulated seconds than fp32, every field of the compressed run's
     ``comm.summary()`` equal to the same cell's plain CPU run's,
     prox_update exactly 4 x 10 x K x L and ef_topk 2 x 10 x (K + 1)
     times; ``examples/federated_benchmark_torch.py`` at its defaults
     (fmnist, MCLR, 15 rounds, PerMFL then FedAvg) and at ``--model cnn
     --rounds 3`` (the paper's CNN at full width): the CSV's curves
     finite in [0, 1], prox_update exactly rounds x K x L; then
     ``examples/serve_model_torch.py`` for phi3-mini-3.8b, rwkv6-7b,
     whisper-small, qwen2-vl-2b and jamba-1.5-large-398b (reduced, vocab
     512, f32, 4 prompts of 32, 16 new greedy tokens after a 2-token
     warm-up): the cache family's line, every token the plain path's
     choice along the same tokens (or within 1e-4 of it), flash_attention
     exactly 36 (phi3, qwen2-vl), 76 (whisper) and 72 (Jamba) times,
     rwkv6_scan 36, moe_router 72 and mamba_scan 8 (Jamba), no other
     kernel; and its ``--personalized`` store:
     the tiers device, device, team, global, the classes and the device
     tier's bytes equal to the plain CPU run's, prox_update exactly 2 x
     K x L.
 16. with ``--profile``: each LLM serving path's time by layer part
     (deepseek: attention, the router (the routing seam: the fused
     kernel), the rest of the MoE layer, head;
     rwkv6-7b: the time mix's GEMMs and elementwise ops, the decay LoRA,
     the WKV scan, the channel mix, head; whisper-small: the encoder,
     self-attention, cross-attention, MLP, head; qwen2-vl-2b: attention,
     MLP, head; the Jamba cut's runs in step 13f) for a prefill and 8
     decode steps, and a profiled decode step and prefill (busy share, time by
     kernel); then the CNN round's host-clock time, uncompressed and with
     each lossy compressor, over several unprofiled rounds in alternating
     order (medians and ranges, and the host time spent issuing the
     compression), then one profiled round of each; then one profiled
     round of each baseline's CNN cell (busy share, launches); then one
     round of the Fig-3 sweep and of the PerMFL CNN 3-seed sweep beside
     one looped round (busy share, launches).
 17. the ``kernels`` JSON line (flash_attention's launches: those of
     deepseek's, Whisper's, Qwen2-VL's, Jamba's and phi3-mini's counted
     generates and of steps 13h, 13k, 13o, 13r, 13s and 14 (b);
     moe_router's: deepseek's and Jamba's generates, 13k and 14 (b);
     rwkv6_scan's: rwkv6-7b's generate and 13l; mamba_scan's: Jamba's
     generate and 13o; prox_update's and flash_attention_bwd's include
     steps 13h, 13k, 13o, 13r, 13s and 14 (b)
     (prox_update 13l too); moe_router_bwd's 13k's, rwkv6_scan_bwd's 13l's,
     mamba_scan_bwd's 13o's; the backward kernels' numbers from 13j and
     13n at the training paths' shapes; every kernel's also step 15's),
     then the ``ok`` JSON line last.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SCENARIO = "fig2/fmnist/cnn/permfl"
ROUNDS = 3
COMM_CELLS = tuple(f"comm/mnist/mclr/{c}" for c in (
    "uncompressed", "identity", "topk_10", "topk_25", "randk_10", "int8",
    "sign"))
COMM_ROUNDS = 3
CNN_COMM_ROUNDS = 2
# compressor -> the kernel its error-feedback uplinks launch
COMPRESS_KERNEL = {"topk": "ef_topk", "randk": "ef_randk", "int8": "ef_int8",
                   "sign": "ef_sign"}
# compressor -> the kernel its uplinks without error feedback launch
PLAIN_KERNEL = {"topk": "topk", "randk": "randk", "int8": "quantize",
                "sign": "sign"}
# float32 operations per value: msg add (EF), score, compares, select,
# ef' sub (EF); rand-k without EF the p/k multiply; int8 also the row
# max, divide, add, floor, two clamps and q * scale; sign the compare,
# sign and multiply
TPU_KERNEL = {  # kernel -> the Pallas kernel body it replaces
    "prox_update": "src/repro/kernels/prox_update/prox_update.py:22",
    "ef_topk": "src/repro/kernels/compress/compress.py:107",
    "ef_randk": "src/repro/kernels/compress/compress.py:123",
    "ef_int8": "src/repro/kernels/compress/compress.py:133",
    "ef_sign": "src/repro/kernels/compress/compress.py:168",
    "topk": "src/repro/kernels/compress/compress.py:99",
    "randk": "src/repro/kernels/compress/compress.py:116",
    "sign": "src/repro/kernels/compress/compress.py:161",
    "quantize": "src/repro/kernels/quantize/quantize.py:23",
    "flash_attention": "src/repro/kernels/flash_attention/"
                       "flash_attention.py:29",
    # with the XLA ops around it, src/repro/models/moe.py:73-92
    "moe_router": "src/repro/kernels/moe_router/moe_router.py:22",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:25",
    # no Pallas kernel: the reference trains through jax.grad of its XLA
    # attention_ref
    "flash_attention_bwd": "src/repro/kernels/flash_attention/ref.py:32",
    # no Pallas kernel: jax.grad of the XLA route_ref and of the router
    # product at src/repro/models/moe.py:73
    "moe_router_bwd": "src/repro/kernels/moe_router/ref.py:16",
    # no Pallas kernel: jax.grad of the XLA wkv6_ref (a checkpointed scan)
    "rwkv6_scan_bwd": "src/repro/kernels/rwkv6_scan/ref.py:20",
    # no Pallas kernel: the XLA selective scan (chunk_fn under
    # jax.checkpoint, lax.scan over chunks of 16 steps) and its jax.grad
    "mamba_scan": "src/repro/models/mamba.py:124",
    "mamba_scan_bwd": "src/repro/models/mamba.py:142",
}
KERNEL_SOURCE = {  # kernel -> its CUDA source
    "prox_update": "prox_update/csrc/prox_update.cu",
    **{op: "compress/csrc/select_hopper.cu"
       for op in ("topk", "randk", "ef_topk", "ef_randk")},
    # the serving path's variants (wgmma, split_kv); the simt kernel of
    # the other cases is flash_attention/csrc/flash_attention.cu
    "flash_attention": "flash_attention/csrc/flash_attention_hopper.cu",
    # the fused router of the serving path; the kernel on given logits (the
    # JAX package's route) is moe_router/csrc/moe_router.cu
    "moe_router": "moe_router/csrc/moe_router_hopper.cu",
    # the served prefill's variant (chunked); the sequential simt kernel of
    # the decode and the f32 path is rwkv6_scan/csrc/rwkv6_scan.cu
    "rwkv6_scan": "rwkv6_scan/csrc/rwkv6_scan_hopper.cu",
    # the training path's variant (wgmma); the CUDA-core simt backward of
    # f32 and the other cases is flash_attention/csrc/flash_attention_bwd.cu
    "flash_attention_bwd": ("flash_attention/csrc/"
                            "flash_attention_bwd_hopper.cu"),
    # the training path's variant (fused: dl, dx and dw in one kernel);
    # route_topk's backward and float32 x take moe_router/csrc/
    # moe_router_bwd.cu
    "moe_router_bwd": "moe_router/csrc/moe_router_bwd_hopper.cu",
    # the training path's variant (chunked); the CUDA-core simt backward of
    # f32 and the other cases is rwkv6_scan/csrc/rwkv6_scan_bwd.cu
    "rwkv6_scan_bwd": "rwkv6_scan/csrc/rwkv6_scan_bwd_hopper.cu",
    # the main path's variant (ring); the simt kernels of the shapes it
    # does not take are mamba_scan/csrc/mamba_scan.cu, mamba_scan_bwd.cu
    "mamba_scan": "mamba_scan/csrc/mamba_scan_hopper.cu",
    "mamba_scan_bwd": "mamba_scan/csrc/mamba_scan_bwd_hopper.cu",
}
LLM_ARCH = "deepseek-moe-16b"
RWKV_ARCH = "rwkv6-7b"
# parameters of the reference's rwkv6-7b tree (jax.eval_shape of
# repro.models.model.init_params; the CPU tests hold the port's tree to
# it). Its param_count (5,675,155,456) counts the layers otherwise.
RWKV_PARAMS = 7_534_546_944
# Whisper-small (encoder-decoder) and Qwen2-VL-2B (embeds prefill, M-RoPE
# decode): the parameters of the reference's trees (jax.eval_shape of
# repro.models.model.init_params; the CPU tests hold the port's trees to
# them). param_count gives 306,203,136 and 1,777,086,464: it leaves out the
# LayerNorm and GELU biases, the final norm and the vocabulary's padding.
WHISPER_ARCH, VLM_ARCH = "whisper-small", "qwen2-vl-2b"
WHISPER_PARAMS, VLM_PARAMS = 306_456_576, 1_777_088_000
# jamba-1.5-large-398b (398.5 B parameters) cut to its first 5 layers at
# every published width: 4 Mamba mixers, the attention layer, 2 MoE FFNs
# (16 experts of 3 x 8,192 x 24,576), 3 SwiGLU FFNs. The parameters of the
# reference's tree (jax.eval_shape of repro.models.model.init_params; the
# CPU tests hold the port's tree to it): param_count gives 24,044,519,424,
# its Mamba term counting dt_rank as d_in / 16 and leaving out dt_proj,
# dt_bias, A_log and D. Its consistency cut: 2 layers, attn_period 2,
# [(mamba, dense), (attn, MoE)], 47.65 GB in f32
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_CUT, JAMBA_PARAMS = dict(num_layers=5), 24_045_707_264
JAMBA_CONSISTENCY_CUT = dict(num_layers=2, attn_period=2)
JAMBA_CONSISTENCY_PARAMS = 11_912_896_512
# Jamba trained (phases 13n-13p): one block of attn_period = num_layers
# positions (the attention layer at num_layers // 2, the rest Mamba), every
# FFN dense (moe_layer_period past the depth: one MoE FFN at published
# widths, 16 x 3 x 8,192 x 24,576 parameters, takes ~117 GiB to train).
# JAMBA_TREE: the reference tree of such a cut (jax.eval_shape of
# repro.models.model.init_params; the CPU tests hold it): the embedding,
# final norm and head, then each Mamba layer and the attention layer (each
# with its SwiGLU FFN and two norms); leaves 3, 14 a Mamba position, 9 the
# attention's
JAMBA_TREE = (1_073_750_016, 1_024_327_680, 754_991_104)
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_CONSISTENCY_LAYERS = 3, 2
# Mamba's selective scan at Jamba's (b, s, d_in, N); the kernels held to
# their plain versions within MAMBA_TOL of each tensor's largest value
# (bf16 also one bf16 rounding, 2^-7, of each value): sums over d and over
# (b, t) in other orders
JAMBA_SCAN = (4, 1024, 16384, 16)
MAMBA_TOL = 1e-5
# Whisper's decoder prompt and cache, within its 448-token context; the
# encoder reads 1,500 frames (30 s of audio)
WHISPER_PROMPT, WHISPER_MAX_LEN = 64, 80
# Qwen2-VL's prompt, as it lays out an image prompt: 64 text rows, a 28 x
# 32 patch grid, 64 text rows (1,024 in all, the cache 1,040)
VLM_TEXT, VLM_GRID = 64, (28, 32)
# LLM training: phi3-mini-3.8b at every published width in bf16 (32
# layers, d 3,072, 32 heads of 96, d_ff 8,192, vocab 32,064): its tree's
# parameters (jax.eval_shape of repro.models.model.init_params; param_count
# gives 3,821,076,480, without the final norm's 3,072), 12 leaves. One
# AdamW step and two tier rounds (l_local 2, the example's hyperparameters)
# on batches of 4 x 1,024 tokens from repro_torch.data.tokens; the
# consistency check on a 2-layer cut in f32
TRAIN_ARCH, TRAIN_PARAMS, TRAIN_LEAVES = "phi3-mini-3.8b", 3_821_079_552, 12
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ROUNDS, TRAIN_L_LOCAL = 4, 1024, 2, 2
TRAIN_LR = 3e-4
TIER_HP = dict(alpha=3e-3, lam=0.5, gamma=1.5, eta=0.03, beta=0.3)
TRAIN_CONSISTENCY_CUT = dict(num_layers=2)
TRAIN_CONSISTENCY_LR = 1e-2
# the MoE and RWKV-6 families trained on the same batches and settings,
# cut in depth only (theta, w, x and the gradients of 28 or 32 layers do
# not fit 80 GB): deepseek-moe-16b to 6 of 28 layers (every one a MoE
# layer), rwkv6-7b to 12 of 32. CUT_TREES: the reference trees of such
# cuts (jax.eval_shape of repro.models.model.init_params): parameters in
# the embedding and the head, parameters a layer, and leaves (the layers
# stacked, so any depth has as many). Their consistency cuts: 2 layers in
# f32, one AdamW step and one tier round
CUT_TREES = {LLM_ARCH: (419_432_448, 587_862_016, 16),
             RWKV_ARCH: (536_875_008, 218_677_248, 25)}


def cut_tree(arch, layers):
    """(parameters, leaves) of ``arch``'s reference tree cut to
    ``layers`` layers, from CUT_TREES."""
    base, per_layer, leaves = CUT_TREES[arch]
    return base + layers * per_layer, leaves


def jamba_cut(layers):
    """Jamba's training cut to ``layers`` layers: one block, one attention
    layer (at ``layers // 2``), dense FFNs."""
    return dict(num_layers=layers, attn_period=layers,
                moe_layer_period=layers + 1)


def jamba_tree(layers):
    """(parameters, leaves) of the reference tree of :func:`jamba_cut`."""
    base, mamba, attn = JAMBA_TREE
    return base + (layers - 1) * mamba + attn, 3 + 14 * (layers - 1) + 9


MOE_TRAIN_CUT = dict(num_layers=6)
MOE_TRAIN_PARAMS, MOE_TRAIN_LEAVES = cut_tree(LLM_ARCH, 6)     # 3.95e9
RWKV_TRAIN_CUT = dict(num_layers=12)
RWKV_TRAIN_PARAMS, RWKV_TRAIN_LEAVES = cut_tree(RWKV_ARCH, 12)  # 3.16e9
FAMILY_CONSISTENCY_PARAMS = {a: cut_tree(a, 2)[0]
                             for a in (LLM_ARCH, RWKV_ARCH)}
FAMILY_CONSISTENCY_PARAMS[JAMBA_ARCH] = jamba_tree(
    JAMBA_TRAIN_CONSISTENCY_LAYERS)[0]
# Whisper-small and Qwen2-VL-2B trained (phases 13r, 13s) on their whole
# trees at every published width (WHISPER_PARAMS, VLM_PARAMS; leaves in
# ENCDEC_VLM_LEAVES), on :func:`model_batches`: Whisper's max_decoder_len
# (448) tokens over 1,500 frame embeddings, Qwen2-VL's 1,024 embeddings at
# :func:`vlm_positions` with targets -100 on the image grid. Their
# consistency cuts under 13i's rule (an SGD step: AdamW's first step is
# decided by rounding on 18% of Qwen2-VL's key bias, whose gradient is 0
# but through M-RoPE's slowest frequencies): 2 decoder layers (and 2
# encoder layers), the reference trees' parameters (jax.eval_shape; the
# CPU tests hold them)
ENCDEC_VLM_LEAVES = {WHISPER_ARCH: 35, VLM_ARCH: 15}
ENCDEC_VLM_CONSISTENCY_CUT = {
    WHISPER_ARCH: dict(num_layers=2, encoder_layers=2),
    VLM_ARCH: dict(num_layers=2)}
ENCDEC_VLM_CONSISTENCY_PARAMS = {WHISPER_ARCH: 117_597_696,
                                 VLM_ARCH: 560_344_576}
# AdamW's first step moves a parameter by lr * u(g), u(g) = g / (|g| +
# 1e-8): about lr * sign(g) wherever |g| >> 1e-8, so a gradient near 0
# whose two paths' values differ by their rounding moves the parameter
# by up to 2 lr more on one path than on the other
ADAM_EPS = 1e-8
# the most of a leaf whose step that allowance may excuse (entries whose
# two gradients' steps differ by more than TRAIN_TOL): 0.098% (rwkv6) and
# 0.049% (deepseek) at most on the H100, so a kernel gradient that drifts
# near 0 over more of a leaf fails
ADAM_EXCUSED_SHARE = 0.003
# the backward kernels against their plain versions: the router's dl
# within 1e-5 relative and 1e-6 absolute (unit cotangents); each WKV
# gradient within 1e-5 of its largest value (sums over keys, values and
# steps in other orders), in bf16 also one bf16 rounding (2^-7) of each
# value
ROUTER_BWD_TOL = 1e-6
WKV_BWD_TOL = 1e-5
# the fused router backward against its plain version: dx within one bf16
# rounding (2^-7) of each value plus this of the largest |dx|, dw within
# this of the largest |dw| (sums over E and over t in other orders)
ROUTER_BWD_TOL_SCALE = 1e-5
# the router backward's two timed shapes: deepseek-moe-16b's training
# (t, d, E, k) and Jamba's (4,096 tokens of d 8,192, 16 experts, top-2)
JAMBA_ROUTER = (4096, 8192, 16, 2)
# kernel vs plain path of the f32 cut: losses and parameters (float32
# gradients that differ in their sums' order, through one SGD step of lr
# 1e-2 and one tier round)
TRAIN_TOL = 1e-5
LLM_BATCH, LLM_PROMPT, LLM_NEW, LLM_MAX_LEN = 4, 1024, 16, 1040
LLM_DECODE_OFFSET = 1030           # the timed decode's cache position
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # absolute
SERVE_REQUESTS = 512
SERVE_BATCH = 64
# the six baselines' CNN cells (Table 1 and Fig 2) and the rounds each
# runs; then one cell of each PerMFL family beyond Table 1 and Fig 2, one
# round each
BASELINE_CELLS = ("table1/mnist/cnn/fedavg", "table1/mnist/cnn/perfedavg",
                  "table1/mnist/cnn/pfedme", "table1/mnist/cnn/ditto",
                  "fig2/fmnist/cnn/hsgd", "fig2/fmnist/cnn/l2gd")
BASELINE_ROUNDS = 2
FAMILY_CELLS = ("table2/mnist/worst", "fig3/mnist/mclr",
                "fig4/mnist/mclr/both_25", "dirichlet/mnist/a0.1",
                "quantity/mnist/q25", "featshift/dnn/s2",
                "teams/worst/m8n20")
CNN_PARAMS = 206_922
SWEEP_KERNEL_CONFIGS = 3           # the prox kernel's per-config case
# the sweep phase: Fig 3's nine grid points (benchmarks/fig3_hparams.py's
# SWEEPS, copied: hyperparameter -> (values, the others held fixed)) on
# fig3/mnist/mclr; the Table-1 CNN cells over three seeds; compressed
# MCLR cells over three seeds
FIG3_SWEEPS = {"beta": ([0.05, 0.2, 0.6], dict(gamma=3.0, lam=0.5)),
               "gamma": ([0.5, 1.5, 3.0], dict(lam=1.5, beta=0.1)),
               "lam": ([0.1, 0.5, 2.0], dict(beta=0.3, gamma=3.0))}
FIG3_ROUNDS = 6
TABLE1_ALGOS = ("permfl", "fedavg", "perfedavg", "pfedme", "ditto", "hsgd",
                "l2gd")
SWEEP_SEEDS = (0, 1, 2)
SWEEP_ROUNDS = 2
SWEEP_COMM_CELLS = ("comm/mnist/mclr/int8", "comm/mnist/mclr/topk_10")
SWEEP_TOL = 1e-4                   # states and losses: the round tolerance
# the sweep phase's system case: one cell over three profiles
SWEEP_SYSTEM_CELL = "table1/mnist/mclr/permfl"
SWEEP_PROFILES = ("lan-campus", "wan-cellular", "edge-iot")
# the cohort phase: the four cohort cells at their registered sizes, a
# fixed sample of theta's rows, and the cell whose CommConfig the
# compressed cohort run takes
COHORT_CELLS = tuple(f"cohort/virtual/n{n}" for n in (
    1_000, 10_000, 100_000, 1_000_000))
THETA_SAMPLE = 4096
COHORT_COMM = "comm/mnist/mclr/topk_10"
# the system phase: the comm cells on one profile; the CNN cell with a
# deadline (edge-iot's CNN chain, its bytes over thin links: ~16.6 s
# median, so about half the devices miss 16 s)
SYSTEM_PROFILE = "wan-cellular"
SYSTEM_ROUNDS = 3
DEADLINE_CELL = "fig2/fmnist/cnn/permfl"
DEADLINE_PROFILE = "edge-iot"
DEADLINE_S = 16.0
DEADLINE_ROUNDS = 2
# phase 7f: run telemetry on the main path
TRACE_ROUNDS = 3
TRACE_REPS = 6                     # more (off, on) pairs for round times
TRACE_COMM = "comm/mnist/mclr/topk_10"
FAIL_CELL = "table1/mnist/mclr/permfl"
TOL = {"float32": 1e-6, "bfloat16": 2e-2}
# the fused router: gates and mean_prob within this of the plain version's
# (its logits come from another f32 product: ~1e-6); a token's choices may
# differ only where the plain run's k-th and (k+1)-th probabilities lie
# within FLIP_GAP of each other
ROUTER_TOL = 1e-5
FLIP_GAP = 1e-5
# the fused router's product at f32 accuracy: run with k = E and no
# renormalisation, its gates are the softmax probabilities, each within
# PROB_REL_TOL (relative) of the float64 route's on the same x and w.
# Relative, so that the check reads the logits' error (a probability's
# relative error is its logit's error less their weighted mean). An f32
# product's rounding reads ~2e-6 there, w in two bf16 pieces (16 bits in
# place of 24) ~1e-5 (scripts/router_variants.py; PERF.md, PR 19)
PROB_REL_TOL = 4e-6
LLM_GROUP = 1024                   # moe.DEFAULT_GROUP
TIMED_LAUNCHES = 200
ROUND_REPS = 8                   # unprofiled CNN rounds per variant
SLEEP_CYCLES = 100_000_000       # ~50 ms at the H100's 1.98 GHz boost
L2_FLUSH_BYTES = 256 * 2**20     # > 5x the H100's 50 MB L2
# phase 14: the dry run's records (build/ is ignored by git) and its
# combinations; the two full-width steps on the card at the LM cells' size
DRYRUN_OUT = Path("build") / "dryrun.json"
DRYRUN_COMBOS, DRYRUN_SKIPPED = 40, {("whisper-small", "long_500k")}
LAUNCH_STEPS = (("phi3-mini-3.8b", "train"), ("deepseek-moe-16b", "prefill"))
LAUNCH_KERNELS = {"train": ("flash_attention", "flash_attention_bwd",
                            "prox_update"),
                  "prefill": ("flash_attention", "moe_router")}
STEP_REPS = 3                    # synchronized runs of each step, timed
# phase 15: the examples' runs, and each served arch's launches over the
# example's 18 passes (a 2-token warm-up and 16 new tokens: 2 + 16
# prefills and decode steps) of the reduced config: one a layer and pass,
# Whisper's encoder and cross-attention in each prefill (2 x (2 + 2 + 2))
# and its self and cross in each decode step (16 x (2 + 2)), Jamba's 4
# attention and 4 MoE layers each pass and its 4 Mamba layers' scans in
# the prefills only (a decode step's recurrence is torch ops)
EXAMPLE_QUICKSTART_ROUNDS = 10
EXAMPLE_BENCHMARKS = ((), ("--model", "cnn", "--rounds", "3"))
EXAMPLE_SERVE = {"phi3-mini-3.8b": {"flash_attention": 36},
                 "rwkv6-7b": {"rwkv6_scan": 36},
                 "whisper-small": {"flash_attention": 76},
                 "qwen2-vl-2b": {"flash_attention": 36},
                 "jamba-1.5-large-398b": {"flash_attention": 72,
                                          "moe_router": 72, "mamba_scan": 8}}
EXAMPLE_SERVE_NEW = 16             # the example's default --new
EXAMPLE_TIE = 1e-4                 # f32 logits: phase 10's 1-layer rule


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def bound(work):
    """(bound ms, bound by, MB moved, GFLOP) of a
    ``repro_torch.roofline.kernels.Work``."""
    return work.bound_ms, work.bound_by, work.bytes / 1e6, work.flops / 1e9


def cuda_time_ms(fn, iters, clean=False):
    """Device time of one call of ``fn`` with the L2 cache cold: the
    median over ``iters`` calls, each preceded on the stream by zeroing a
    buffer five times the L2's size and bracketed alone by CUDA events.
    The card first sleeps ~50 ms on the stream while the host queues all
    the calls, so the events time the device, not the host's launch
    rate (and the card's clocks have ramped up). The zeroing leaves the
    L2 full of dirty lines, whose write-back the timed call pays for as
    it reads; ``clean`` then also reads the buffer once, so that the L2
    holds clean lines of it (a diagnostic: what a read-bound call costs
    without that write-back)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.zero_()
        if clean:
            flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in events)
    return times[iters // 2]


def profiled(fn):
    """``fn()`` once under torch.profiler, the device synchronized before
    and after: (its result, the call's host-clock seconds, the CUDA
    kernels' rows of ``key_averages()``, most device time first). Only
    device-side rows: an operator's own row repeats the time of the
    kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return out, wall, rows


def max_errors(got, want):
    """(max abs error, max relative error), compared in float32."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rel = diff / w.abs().clamp_min(1e-30)
    return float(diff.max()), float(rel.max())


def within(got, want, tol):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


def phase_environment():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    say("env", f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; tf32 off")
    print(smi[0], flush=True)
    return smi[0]


def phase_build():
    from repro_torch.kernels.build import KERNEL_SOURCES, build, build_log

    t0 = time.perf_counter()
    libs = build()
    say("build", f"{len(libs)} kernel(s) built in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{n} -> {p.name}" for n, p in libs.items()))
    for name in KERNEL_SOURCES:
        entry = ""
        for line in build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = kernel_entry(line) + ": "
            elif "registers" in line or "spill" in line:
                say("build", f"{name}: {entry}{line.strip()}")


def kernel_entry(line):
    """``name<template arguments>`` (ints, float, bf16) of the kernel a
    ptxas ``Compiling entry function '<mangled>'`` line names."""
    import re

    mangled = line.split("'")[1]
    if not mangled.startswith("_Z"):
        return mangled
    pos = 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[pos:])):   # <length><name> ...
        pos += len(m[0])
        name, pos = mangled[pos:pos + int(m[0])], pos + int(m[0])
        if name.endswith("kernel"):
            args = re.match(r"I((?:Li\d+E|f|13__nv_bfloat16)+)E",
                            mangled[pos:])
            if args is None:
                return name
            return "{}<{}>".format(name, ", ".join(
                i or ("bf16" if bf else "float")
                for i, bf in re.findall(r"Li(\d+)E|(13__nv_bfloat16)|f",
                                        args[1])))
    return mangled[:40]


def phase_kernel_check(layout, m, n):
    """prox_update at the main path's shapes: the device tier (M*N, P) in
    a padded (M*N, S) buffer, the anchor the team tier (M, P)."""
    import torch

    from repro_torch.kernels.prox_update import prox_step_
    from repro_torch.roofline import kernels as W

    rows, p, s = m * n, layout.size, layout.stride
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def buf(r, dtype):
        b = torch.zeros(r, s, device=DEVICE, dtype=dtype)
        b[:, :p] = torch.randn(r, p, device=DEVICE, generator=gen)
        return b[:, :p]

    cases = [  # (label, dtype, momentum, weight_decay); the first is the
        ("f32", torch.float32, 0.0, 0.0),        # main path's own
        ("bf16", torch.bfloat16, 0.0, 0.0),
        ("f32+momentum+wd", torch.float32, 0.9, 0.01),
    ]
    out = {}
    for label, dtype, mu, wd in cases:
        theta, grad, w = buf(rows, dtype), buf(rows, dtype), buf(m, dtype)
        mom = buf(rows, torch.float32) if mu > 0 else None
        kw = dict(alpha=0.01, lam=0.5, momentum=mu, weight_decay=wd)
        t_k, t_p = buf(rows, dtype), buf(rows, dtype)
        t_k.copy_(theta)
        t_p.copy_(theta)
        m_k = m_p = None
        if mom is not None:
            m_k, m_p = buf(rows, torch.float32), buf(rows, torch.float32)
            m_k.copy_(mom)
            m_p.copy_(mom)
        prox_step_(t_k, grad, w, m_k, **kw)
        prox_step_(t_p, grad, w, m_p, mode="torch", **kw)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        abs_err, rel_err = max_errors(t_k, t_p)
        ok = within(t_k, t_p, TOL[name])
        if mom is not None:
            m_abs, _ = max_errors(m_k, m_p)
            abs_err = max(abs_err, m_abs)
            ok = ok and within(m_k, m_p, TOL["float32"])
        if not ok:
            raise AssertionError(f"prox_update {label}: kernel and plain "
                                 f"version disagree (max abs {abs_err})")
        ms = cuda_time_ms(lambda: prox_step_(t_k, grad, w, m_k, **kw),
                          TIMED_LAUNCHES)
        plain_ms = cuda_time_ms(
            lambda: prox_step_(t_p, grad, w, m_p, mode="torch", **kw), 50)
        bound_ms, by, moved, _ = bound(W.prox_update(
            rows, p, itemsize=theta.element_size(), anchor_rows=m,
            momentum=mu > 0))
        say("kernel", f"prox_update {label} ({rows}x{p}, anchor {m}x{p}): "
            f"max abs err {abs_err:.3g} rel {rel_err:.3g} (tol "
            f"{TOL[name]:g}); kernel {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
            f"({moved:.1f} MB by {by}), {bound_ms / ms:.1%} of bound")
        out[label] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by)
    out["per-config"] = prox_per_config_check(buf, rows, m, p)
    return out


def prox_per_config_check(buf, rows, m, p):
    """The sweep's step: SWEEP_KERNEL_CONFIGS configs of the device tier
    stacked on the rows, anchors their team tiers, each config's (alpha,
    lam) read by the kernel from device memory; bit-equal to the plain
    version, timed beside its bound."""
    import torch

    from repro_torch.kernels.prox_update import prox_step_
    from repro_torch.roofline import kernels as W

    c = SWEEP_KERNEL_CONFIGS
    theta, grad, w = (buf(c * rows, torch.float32),
                      buf(c * rows, torch.float32),
                      buf(c * m, torch.float32))
    alpha = torch.tensor([0.01, 0.03, 0.005][:c], device=DEVICE)
    lam = torch.tensor([0.5, 1.5, 0.1][:c], device=DEVICE)
    t_k, t_p = buf(c * rows, torch.float32), buf(c * rows, torch.float32)
    t_k.copy_(theta)
    t_p.copy_(theta)
    prox_step_(t_k, grad, w, alpha=alpha, lam=lam)
    prox_step_(t_p, grad, w, alpha=alpha, lam=lam, mode="torch")
    torch.cuda.synchronize()
    abs_err, _ = max_errors(t_k, t_p)
    if not torch.equal(t_k, t_p):
        raise AssertionError(f"prox_update per-config: kernel and plain "
                             f"version differ (max abs {abs_err})")
    ms = cuda_time_ms(lambda: prox_step_(t_k, grad, w, alpha=alpha,
                                         lam=lam), TIMED_LAUNCHES)
    plain_ms = cuda_time_ms(lambda: prox_step_(
        t_p, grad, w, alpha=alpha, lam=lam, mode="torch"), 50)
    bound_ms, by, moved, _ = bound(W.prox_update(
        c * rows, p, itemsize=4, anchor_rows=c * m, groups=c))
    say("kernel", f"prox_update per-config ({c} configs x {rows}x{p}, "
        f"anchors {c * m}x{p}, alpha {alpha.tolist()}, lam {lam.tolist()} "
        f"from device memory): bit-equal to the plain version; kernel "
        f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
        f"{bound_ms * 1e3:.1f} us ({moved:.1f} MB), "
        f"{bound_ms / ms:.1%} of bound")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by)


def compress_inputs(layout, senders, seed):
    """(delta, ef, u) as the round gives them: (senders, S) rows laid out
    by ``layout``, random, with a run of exact zeros in
    the largest leaf, tied uniforms there, all-equal values in the leaf
    before it, and a first leaf of one nonzero value (top-k threshold 0),
    so the tie-fill runs on the card."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p, s = layout.size, layout.stride
    delta = torch.zeros(senders, s, device=DEVICE)
    ef = torch.zeros(senders, s, device=DEVICE)
    delta[:, :p] = torch.randn(senders, p, device=DEVICE, generator=gen)
    ef[:, :p] = 0.1 * torch.randn(senders, p, device=DEVICE, generator=gen)
    u = torch.rand(senders, s, device=DEVICE, generator=gen)
    sizes = layout.leaf_sizes
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    big = max(range(len(sizes)), key=sizes.__getitem__)
    o, n = offs[big], sizes[big]
    delta[:, o:o + n // 2] = 0.0
    ef[:, o:o + n // 2] = 0.0
    u[:, o:o + n] = torch.floor(u[:, o:o + n] * 8.0) / 8.0
    if big > 0:
        o2, n2 = offs[big - 1], sizes[big - 1]
        delta[:, o2:o2 + n2] = 0.5
        ef[:, o2:o2 + n2] = 0.0
    first = next(i for i, q in enumerate(sizes) if q >= 10)
    o3, n3 = offs[first], sizes[first]
    delta[:, o3:o3 + n3] = 0.0
    ef[:, o3:o3 + n3] = 0.0
    delta[:, o3 + n3 - 1] = 1.0
    return delta, ef, u


EF_OPS = ("ef_topk", "ef_randk", "ef_int8", "ef_sign")
PLAIN_OPS = ("topk", "randk", "sign", "quantize")


def run_compress(op, delta, ef, u, segs, given, mode=None):
    """One compress op; ``given`` is its thresholds or sign scales. The
    ops without error feedback compress ``delta`` (unbiased rand-k, as
    the uplinks run it); quantize rounds with the noise ``u``."""
    from repro_torch.kernels import compress as K
    from repro_torch.kernels.quantize import quantize_int8

    if op == "ef_topk":
        return K.ef_topk(delta, ef, segs, thresh=given, mode=mode)
    if op == "ef_randk":
        return K.ef_randk(u, delta, ef, segs, thresh=given, mode=mode)
    if op == "ef_int8":
        return K.ef_int8(delta, ef, u, segs, mode=mode)
    if op == "ef_sign":
        return K.ef_sign(delta, ef, segs, scales=given, mode=mode)
    if op == "topk":
        return K.topk(delta, segs, thresh=given, mode=mode)
    if op == "randk":
        return K.randk(u, delta, segs, unbiased=True, thresh=given,
                       mode=mode)
    if op == "sign":
        return K.sign(delta, segs, scales=given, mode=mode)
    return quantize_int8(delta, u, segs, mode=mode)


def op_segments(op, layout):
    """The segment table the uplinks give ``op`` for ``layout``."""
    from repro_torch.comm import CommConfig, compression_plan
    from repro_torch.kernels import compress as K

    comp = op[3:] if op.startswith("ef_") else \
        {"quantize": "int8"}.get(op, op)
    sizes = layout.leaf_sizes
    if comp in ("topk", "randk"):
        plan = compression_plan(CommConfig(comp), sizes)
        return K.segments(sizes, tuple(pl.k for pl in plan))
    return K.segments(sizes)


def side_op(op, delta, ef, u, segs):
    """The torch ops the round runs beside ``op`` (thresholds, sign
    scales) as (what, fn), or None."""
    from repro_torch.kernels import compress as K

    if op == "ef_topk":
        return "thresholds (torch.topk)", \
            lambda: K.segment_thresholds((delta + ef).abs(), segs)
    if op == "topk":
        return "thresholds (torch.topk)", \
            lambda: K.segment_thresholds(delta.abs(), segs)
    if op in ("ef_randk", "randk"):
        return "thresholds (torch.topk)", \
            lambda: K.segment_thresholds(u, segs)
    if op == "ef_sign":
        return "sign scales (mean |msg|)", \
            lambda: K.sign_scales(delta, segs, ef)
    if op == "sign":
        return "sign scales (mean |v|)", lambda: K.sign_scales(delta, segs)
    return None


def time_compress(op, label, senders, layout, segs, fn, plain_fn, side,
                  noise_rows=None):
    """Time ``fn`` (the kernel) and ``plain_fn`` with the L2 cold, and
    the torch ops beside it; print and return the numbers."""
    from repro_torch.roofline import kernels as W

    ms = cuda_time_ms(fn, TIMED_LAUNCHES)
    plain_ms = cuda_time_ms(plain_fn, 10)
    side_ms = cuda_time_ms(side[1], 20) if side else None
    bound_ms, by, moved, _ = bound(W.compress(
        op, senders, layout.stride, layout.size, len(segs.lengths),
        segs.rows, noise_rows))
    extra = f"; {side[0]} {side_ms * 1e3:.1f} us" if side else ""
    say("kernel", f"{op} {label} ({senders}x{layout.size}, "
        f"{len(segs.lengths)} leaves): equal to the plain version bit for "
        f"bit; kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
        f"bound {bound_ms * 1e3:.1f} us ({moved:.1f} MB by {by}), "
        f"{bound_ms / ms:.1%} of bound{extra}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                side_ms=side_ms)


def assert_bit_equal(name, got, want):
    """Every output of the kernel equal to the plain version's; returns
    the largest float difference (0)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"({g.dtype} {tuple(g.shape)})")
        if g.is_floating_point():
            err = max(err, float((g - w).abs().max()))
    return err


SELECT_OPS = ("ef_topk", "ef_randk", "topk", "randk")


def kth_sorted(score, segs):
    """``segment_thresholds`` as the k-th value of a sorted top-k: what
    the least of the unsorted top-k (``ref.kth_threshold``) must equal."""
    import torch

    from repro_torch.kernels.segments import leaf_columns

    return torch.stack([torch.topk(score[:, sl], k, dim=-1,
                                   sorted=True).values[..., -1]
                        for _, sl, k in leaf_columns(segs)],
                       dim=1).contiguous()


def select_extras(op, label, delta, ef, u, segs, given):
    """For select ``op``: its grid (tiles of ``compress.TILE`` values by
    the senders, two launches), its time with a clean L2, and the
    thresholds by a sorted top-k, equal to the unsorted one's the op uses,
    and timed."""
    import torch

    from repro_torch.kernels import compress as K

    out = {"grid": f"{K.tiles(segs)[-1]} tiles x {delta.shape[0]} senders",
           "clean_ms": cuda_time_ms(
               lambda: run_compress(op, delta, ef, u, segs, given),
               TIMED_LAUNCHES, clean=True)}
    score = u if op.endswith("randk") else \
        (delta + ef if op.startswith("ef_") else delta).abs()
    if not torch.equal(kth_sorted(score, segs), given):
        raise AssertionError(f"{op} {label}: the sorted top-k's "
                             "thresholds differ from the unsorted one's")
    out["sorted_ms"] = cuda_time_ms(lambda: kth_sorted(score, segs), 20)
    return out


def phase_compress_check(cases):
    """Every compress kernel (with error feedback and without) at the
    uplinks of ``cases`` [(label, Layout, senders)], the first the timed
    one, against its plain version, bit for bit, given the same
    thresholds, scales and uniforms; the select kernels timed at every
    case, L2-cold and clean, beside the timing floor and a sorted top-k's
    thresholds; then quantize at the int8 store export of the first case
    (noise 0.5 as one expanded row)."""
    import torch

    from repro_torch.kernels.quantize import quantize_int8

    floor = timing_floor()
    say("kernel", f"timing floor (one elementwise add on 16 bytes): "
        f"{floor[0] * 1e3:.1f} us L2-cold, {floor[1] * 1e3:.1f} us clean")
    out = {}
    for ci, (label, layout, senders) in enumerate(cases):
        delta, ef, u = compress_inputs(layout, senders, seed=ci)
        for op in EF_OPS + PLAIN_OPS:
            segs = op_segments(op, layout)
            side = side_op(op, delta, ef, u, segs)
            given = side[1]() if side else None
            got = run_compress(op, delta, ef, u, segs, given)
            want = run_compress(op, delta, ef, u, segs, given, mode="torch")
            torch.cuda.synchronize()
            err = assert_bit_equal(f"{op} {label}", got, want)
            sel = op in SELECT_OPS
            extra = select_extras(op, label, delta, ef, u, segs,
                                  given) if sel else {}
            if ci and not sel:
                say("kernel", f"{op} {label} ({senders}x{layout.size}, "
                    f"{len(segs.lengths)} leaves): equal to the plain "
                    "version bit for bit")
                continue
            nums = dict(max_abs_err=err, **extra, **time_compress(
                op, label, senders, layout, segs,
                lambda: run_compress(op, delta, ef, u, segs, given),
                lambda: run_compress(op, delta, ef, u, segs, given,
                                     mode="torch"), side))
            if sel:
                say("kernel", f"{op} {label} [count + scan over "
                    f"{nums['grid']}]: {nums['ms'] * 1e3:.1f} us L2-cold, "
                    f"{nums['clean_ms'] * 1e3:.1f} us clean (timing floor "
                    f"{floor[0] * 1e3:.1f} / {floor[1] * 1e3:.1f} us); "
                    "thresholds (unsorted top-k + amin) "
                    f"{nums['side_ms'] * 1e3:.1f} us, by a sorted top-k "
                    f"{nums['sorted_ms'] * 1e3:.1f} us (equal)")
            if ci == 0:
                out[op] = nums
    label, layout, senders = cases[0]
    delta, _, _ = compress_inputs(layout, senders, seed=len(cases))
    noise = torch.full((1, layout.stride), 0.5, device=DEVICE) \
        .expand(senders, layout.stride)
    segs = op_segments("quantize", layout)
    assert_bit_equal("quantize store export",
                     quantize_int8(delta, noise, segs),
                     quantize_int8(delta, noise, segs, mode="torch"))
    out["quantize_export"] = time_compress(
        "quantize", "int8 store export", senders, layout, segs,
        lambda: quantize_int8(delta, noise, segs),
        lambda: quantize_int8(delta, noise, segs, mode="torch"), None,
        noise_rows=1)
    return out


def check_launches(launches, expect, path):
    """Every kernel in ``expect`` launched exactly that often on ``path``,
    every other kernel not at all."""
    from repro_torch.kernels.compress import KERNELS
    from repro_torch.kernels.flash_attention import KERNELS as ATTENTION
    from repro_torch.kernels.mamba_scan import KERNELS as MAMBA
    from repro_torch.kernels.moe_router import KERNELS as ROUTER
    from repro_torch.kernels.quantize import KERNELS as QUANTIZE
    from repro_torch.kernels.rwkv6_scan import KERNELS as RWKV

    for name in (("prox_update", "tier_update") + KERNELS + QUANTIZE
                 + ATTENTION + ROUTER + RWKV + MAMBA):
        want = expect.get(name, 0)
        if launches.get(name, 0) != want:
            raise AssertionError(
                f"{path}: kernel {name} launched {launches.get(name, 0)} "
                f"times, expected {want}")


def untrained_loss(spec):
    """Train loss of the model run_scenario starts from (seed 0)."""
    from repro_torch.scenarios import build_scenario

    b = build_scenario(spec, seed=0, device=DEVICE)
    return b.algo.eval(b.algo.init_state(b.params0, b.m, b.n), b.train,
                       b.val, b.metric_fn)["train_loss"]


def phase_main_path():
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import get_scenario, run_scenario

    s = get_scenario(SCENARIO)
    hp = s.algo.hparams()
    loss0 = untrained_loss(s)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = run_scenario(SCENARIO, rounds=ROUNDS, device=DEVICE)
    launches = dict(LAUNCHES)
    d = s.data
    say("main", f"{SCENARIO}: {d.m_teams} teams x {d.n_devices} devices, "
        f"S={d.samples_per_device}, K={hp.k_team}, L={hp.l_local}, "
        f"{ROUNDS} rounds on {res.device}")
    for t, (pm, tm, gm, loss, sec) in enumerate(zip(
            res.pm_acc, res.tm_acc, res.gm_acc, res.train_loss,
            res.round_seconds), 1):
        say("main", f"round {t}: PM {pm:.4f} TM {tm:.4f} GM {gm:.4f} "
            f"train_loss {loss:.4f}; {sec:.3f} s (host clock to "
            f"synchronize, eval included)")
    peak = torch.cuda.max_memory_allocated() / 2**20
    say("main", f"peak device memory {peak:.1f} MiB; launches {launches}")
    expect = ROUNDS * hp.k_team * hp.l_local
    check_launches(launches, {"prox_update": expect}, SCENARIO)
    hist = res.pm_acc + res.tm_acc + res.gm_acc + res.train_loss
    if len(res.pm_acc) != ROUNDS or not all(map(math.isfinite, hist)):
        raise AssertionError(f"bad metric history: {hist}")
    if not all(0.0 <= a <= 1.0 for a in res.pm_acc + res.tm_acc
               + res.gm_acc):
        raise AssertionError("accuracy outside [0, 1]")
    say("main", f"train loss of the untrained model {loss0:.4f}")
    if not res.train_loss[-1] < loss0:
        raise AssertionError(f"training did not lower the loss "
                             f"{loss0} -> {res.train_loss}")
    st = res.state
    if st.theta.shape != (d.m_teams, d.n_devices, st.layout.stride) or \
            st.layout.size != CNN_PARAMS:
        raise AssertionError(f"unexpected state shape {st.theta.shape}")
    return res, launches


def run_comm_path(spec, rounds, loss0):
    """One compressed (or uncompressed) scenario on the card, with the
    launch counts set to 0 just before and read just after; checks
    metrics, loss, ledger bytes and launches. Returns the launches."""
    import torch

    from repro_torch.comm import compressed_leaf_bytes, full_leaf_bytes
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import run_scenario

    hp = spec.algo.hparams()
    d = spec.data
    reset_launches()
    t0 = time.perf_counter()
    res = run_scenario(spec, rounds=rounds, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    label = spec.name + ("" if spec.comm is None else
                         f" [{spec.comm.compressor}"
                         + ("" if spec.comm.error_feedback else ", no EF")
                         + "]")
    hist = res.pm_acc + res.tm_acc + res.gm_acc + res.train_loss
    if len(res.pm_acc) != rounds or not all(map(math.isfinite, hist)):
        raise AssertionError(f"{label}: bad metric history {hist}")
    if not res.train_loss[-1] < loss0:
        raise AssertionError(f"{label}: training did not lower the loss "
                             f"{loss0} -> {res.train_loss}")
    expect = {"prox_update": rounds * hp.k_team * hp.l_local}
    mb = None
    if spec.comm is not None:
        sizes = res.state.layout.leaf_sizes
        comp = sum(compressed_leaf_bytes(spec.comm, p) for p in sizes)
        full = sum(full_leaf_bytes(p) for p in sizes)
        m, devs = d.m_teams, d.m_teams * d.n_devices
        model = rounds * (m * (comp + full)
                          + hp.k_team * devs * (comp + full))
        if res.comm.total_bytes() != model:
            raise AssertionError(f"{label}: ledger {res.comm.total_bytes()} "
                                 f"B, byte model {model} B")
        mb = model / 1e6
        kernel = (COMPRESS_KERNEL if spec.comm.error_feedback
                  else PLAIN_KERNEL).get(spec.comm.compressor)
        if kernel:
            expect[kernel] = rounds * (hp.k_team + 1)
    check_launches(launches, expect, label)
    say("comm", f"{label}: {rounds} rounds in {wall:.2f} s (host clock, "
        f"eval included); PM {res.pm_acc[-1]:.4f} TM {res.tm_acc[-1]:.4f} "
        f"GM {res.gm_acc[-1]:.4f} train_loss {loss0:.4f} -> "
        f"{res.train_loss[-1]:.4f}; "
        + (f"{mb:.2f} MB on the links (= byte model); " if mb else "")
        + f"launches {launches}")
    return launches


def phase_comm_paths():
    """Every comm/mnist/mclr/* cell, then the paper CNN of the main path
    with each lossy compressor, with error feedback and without. Returns
    {kernel: launches} of the CNN runs (the full-width model's path of
    each compress kernel)."""
    from repro_torch.comm import CommConfig
    from repro_torch.scenarios import get_scenario

    mclr_loss0 = untrained_loss(get_scenario(COMM_CELLS[0]))
    for name in COMM_CELLS:
        run_comm_path(get_scenario(name), COMM_ROUNDS, mclr_loss0)
    cnn = get_scenario(SCENARIO)
    cnn_loss0 = untrained_loss(cnn)
    out = {}
    for ef, kernels in ((True, COMPRESS_KERNEL), (False, PLAIN_KERNEL)):
        for comp, kernel in kernels.items():
            spec = dataclasses.replace(
                cnn, comm=CommConfig(comp, error_feedback=ef))
            out[kernel] = run_comm_path(spec, CNN_COMM_ROUNDS,
                                        cnn_loss0).get(kernel, 0)
    return out


def phase_consistency():
    """One round from the same state through the kernels and through the
    plain versions, on the card: uncompressed, then with each lossy
    compressor with error feedback and without (the same generator seed,
    so the same uniforms)."""
    import torch

    from repro_torch.comm import CommConfig
    from repro_torch.core import permfl as P
    from repro_torch.scenarios import build_scenario

    b = build_scenario(SCENARIO, seed=1, device=DEVICE)
    hp = b.scenario.algo.hparams()
    cfgs = [None] + [CommConfig(c, error_feedback=ef) for ef in (True, False)
                     for c in COMPRESS_KERNEL]
    for cfg in cfgs:
        state = P.init_state(b.params0, b.m, b.n, comm=cfg)
        out = {}
        for mode in (None, "torch"):
            out[mode] = P.permfl_round(state, b.train, hp, b.loss_fn,
                                       m_teams=b.m, n_devices=b.n, comm=cfg,
                                       mode=mode)
        torch.cuda.synchronize()
        pairs = [(getattr(out[None], t), getattr(out["torch"], t))
                 for t in ("x", "w", "theta")]
        if cfg is not None:
            pairs += [(getattr(out[None].comm, t), getattr(out["torch"].comm,
                                                           t))
                      for t in ("ef_dev", "ef_team")]
        worst = max(float((g - w).abs().max()) for g, w in pairs)
        what = "x, w, theta" + ("" if cfg is None else ", ef_dev, ef_team")
        tag = "uncompressed" if cfg is None else cfg.compressor + (
            "" if cfg.error_feedback else ", no EF")
        say("consistency", f"one round [{tag}] kernel vs "
            f"plain path: max |diff| over {what} = {worst:.3g} (tol 1e-4)")
        if not worst <= 1e-4:
            raise AssertionError("kernel and plain paths disagree")


def phase_serving(res):
    """The serving path from the main path's trained state ``res``: a
    store exported in each encoding, saved and reloaded, decoded, and
    Zipf traffic replayed through ``serve`` and ``serve_cached``.
    Returns the int8 export's quantize launches."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.kernels.quantize import row_of_column
    from repro_torch.kernels.segments import segments
    from repro_torch.models import paper_models as pm
    from repro_torch.scenarios import build_scenario
    from repro_torch.serve import (ENCODINGS, ModelStore, PersonalizedServer,
                                   replay_traffic, zipf_requests)

    b = build_scenario(SCENARIO, seed=0, device=DEVICE)
    st, m, n = res.state, b.m, b.n
    cfg = b.config
    pool = b.val["x"].reshape((-1,) + tuple(b.val["x"].shape[3:]))
    apply = lambda p, x: pm.apply(p, cfg, x[:, None])[:, 0]
    ts = np.repeat(np.arange(m), n)
    ds = np.tile(np.arange(n), m)
    theta = st.theta.reshape(m * n, -1)
    export_launches = 0
    for enc in ENCODINGS:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        store = ModelStore.from_result(b.algo, res, m=m, n=n, encoding=enc)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: c for k, c in LAUNCHES.items() if c}
        check_launches(launches, {"quantize": 1} if enc == "int8" else {},
                       f"store export [{enc}]")
        export_launches += launches.get("quantize", 0)
        with tempfile.TemporaryDirectory() as tmp:
            store.save(f"{tmp}/store.ckpt")
            back = ModelStore.load(f"{tmp}/store.ckpt", device=DEVICE)
        pairs = [(store.global_row, back.global_row),
                 (store.team_rows, back.team_rows)]
        pairs += ([(store.payload[k], back.payload[k])
                   for k in ("q", "scales")] if enc == "int8"
                  else [(store.payload, back.payload)])
        if not all(torch.equal(a, c) for a, c in pairs):
            raise AssertionError(f"store [{enc}]: reloaded tiers differ")
        rows = store.gather(ts, ds)
        if enc == "int8":
            segs = segments(st.layout.leaf_sizes)
            scale = store.payload["scales"].reshape(m * n, -1)[
                :, row_of_column(segs, DEVICE)]
            p = st.layout.size
            w = st.w[torch.as_tensor(ts, device=DEVICE)][:, :p]
            err = (rows[:, :p] - theta[:, :p]).abs()
            tol = 0.5 * scale * (1 + 1e-6) \
                + 2.0**-21 * (theta[:, :p].abs() + w.abs())
            if not bool((err <= tol).all()):
                raise AssertionError("int8 decode beyond half a row scale")
            check = (f"decoded rows within half a row scale of theta (max "
                     f"|err| {float(err.max()):.3g}, max |err| / scale "
                     f"{float((err / scale).max()):.3f})")
        else:
            if not torch.equal(rows, theta):
                raise AssertionError(f"store [{enc}]: decode is not theta")
            check = "decoded rows equal theta bit for bit"
        say("serve", f"[{enc}] export {sec * 1e3:.1f} ms (host clock), "
            f"launches {launches}; saved and reloaded bit-equal; {check}")
        say("serve", f"[{enc}] device tier "
            f"{store.device_tier_nbytes() / 1e6:.3f} MB ({m}x{n} devices)")
        kw = dict(requests=SERVE_REQUESTS, batch=SERVE_BATCH, alpha=1.2,
                  unknown_frac=0.1, seed=0)
        tags = zipf_requests(m, n, SERVE_REQUESTS, alpha=1.2,
                             unknown_frac=0.1, seed=0)
        xs = pool[torch.as_tensor(np.arange(SERVE_REQUESTS) % len(pool),
                                  device=DEVICE)]
        a = PersonalizedServer(store, apply)
        c = PersonalizedServer(store, apply)
        worst = 0.0
        for lo in range(0, SERVE_REQUESTS, SERVE_BATCH):
            sl = slice(lo, lo + SERVE_BATCH)
            got = a.serve(tags[0][sl], tags[1][sl], xs[sl])
            cached = c.serve_cached(tags[0][sl], tags[1][sl], xs[sl])
            if enc != "int8" and not torch.equal(got, cached):
                raise AssertionError(f"[{enc}] serve and serve_cached differ")
            worst = max(worst, float((got - cached).abs().max()))
        if a.tier_counts != c.tier_counts or \
                sum(a.tier_counts.values()) != SERVE_REQUESTS:
            raise AssertionError(f"[{enc}] tier counts {a.tier_counts} / "
                                 f"{c.tier_counts}")
        say("serve", f"[{enc}] serve vs serve_cached on {SERVE_REQUESTS} "
            f"Zipf requests: max |diff| {worst:.3g}; tiers {a.tier_counts}")
        for cached in (False, True):
            server = PersonalizedServer(store, apply)
            stats = replay_traffic(server, pool, cached=cached, **kw)
            if sum(stats["tier_counts"].values()) != SERVE_REQUESTS:
                raise AssertionError(f"replay tiers {stats['tier_counts']}")
            path = "serve_cached" if cached else "serve"
            say("serve", f"[{enc}] replay {path}: qps {stats['qps']:.1f}")
            say("serve", f"[{enc}] replay {path}: p50 "
                f"{stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, "
                f"p99 {stats['p99_ms']:.3f} ms (host clock, batch "
                f"{SERVE_BATCH}, synchronized)")
            say("serve", f"[{enc}] replay {path}: stages gather "
                f"{stats['stage_gather_ms']:.3f} ms, forward "
                f"{stats['stage_forward_ms']:.3f} ms per batch")
            say("serve", f"[{enc}] replay {path}: tiers "
                f"{stats['tier_counts']}"
                + (f", cache hit rate {stats['cache_hit_rate']:.2%}"
                   if cached else ""))
    return export_launches


def prox_launches_per_round(spec):
    """prox_update launches one round of ``spec``'s algorithm makes at its
    registered loop counts: eq. 4's step with momentum and weight decay
    0 is the kernel (PerMFL's device steps; pFedMe's inner prox steps,
    Ditto's personal steps, L2GD's local steps); plain SGD is a torch op."""
    kw, name = spec.algo.resolved(), spec.algo.name
    if name in ("permfl", "l2gd"):
        return kw["k_team"] * kw["l_local"]
    if name == "pfedme":
        return (kw["local_rounds"] + 1) * kw["inner_steps"]
    return kw["local_steps"] if name == "ditto" else 0


def served_loss(b, state, adapted=False):
    """Mean train loss, over every device's train data, of the global
    model ``b.algo`` serves from ``state`` (``serving_params(state)``);
    with ``adapted``, of Per-FedAvg's one-step adaptation of it on each
    device (the model its meta-objective trains)."""
    import torch

    from repro_torch.core.baselines import perfedavg_personalize

    d = b.m * b.n
    batch = {k: v.reshape((d,) + tuple(v.shape[2:]))
             for k, v in b.train.items()}
    x = b.algo.serving_params(state)
    rows = x.expand(d, x.shape[-1])
    if adapted:
        rows = perfedavg_personalize(x, b.train, state.layout,
                                     loss_fn=b.loss_fn,
                                     inner_lr=b.algo.inner_lr, m=b.m,
                                     n=b.n).reshape(d, -1)
    with torch.no_grad():
        return float(b.loss_fn(state.layout.unflatten(rows), batch).mean())


def phase_baselines():
    """Each baseline's CNN cell for BASELINE_ROUNDS rounds at its
    registered size and hyperparameters, each with the launch counts set
    to 0 just before and read just after: metrics finite, in [0, 1] and
    only the algorithm's; the served global model's train loss below the
    untrained model's (Per-FedAvg: the loss of its one-step adaptation,
    the model it trains; its served loss is printed); prox_update exactly
    ``prox_launches_per_round`` a round, no other kernel. Returns
    {name: (build, FLResult)}."""
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import build_scenario, get_scenario, \
        run_scenario
    from repro_torch.scenarios.spec import ALGO_METRICS

    out = {}
    for name in BASELINE_CELLS:
        s = get_scenario(name)
        algo = s.algo.name
        b = build_scenario(s, seed=0, device=DEVICE)
        init = b.algo.init_state(b.params0, b.m, b.n)
        adapted = algo == "perfedavg"
        loss0 = served_loss(b, init)
        loss0_adapted = served_loss(b, init, adapted=True) if adapted \
            else None
        del init
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = run_scenario(s, rounds=BASELINE_ROUNDS, device=DEVICE)
        launches = {k: c for k, c in LAUNCHES.items() if c}
        peak = torch.cuda.max_memory_allocated() / 2**20
        d = s.data
        say("baselines", f"{s.name}: {d.m_teams} teams x {d.n_devices} "
            f"devices, S={d.samples_per_device}, {algo} "
            f"{s.algo.resolved()}, {BASELINE_ROUNDS} rounds on "
            f"{res.device}")
        hists = {m: getattr(res, f"{m}_acc") for m in ("pm", "tm", "gm")}
        reported = tuple(m for m, h in hists.items() if h)
        if reported != ALGO_METRICS[algo] or res.train_loss:
            raise AssertionError(f"{name}: reported {reported}, train_loss "
                                 f"{res.train_loss}")
        for t in range(BASELINE_ROUNDS):
            say("baselines", f"{algo} round {t + 1}: " + " ".join(
                f"{m.upper()} {hists[m][t]:.4f}" for m in reported)
                + f"; {res.round_seconds[t]:.3f} s (host clock to "
                f"synchronize, eval included)")
        accs = [a for m in reported for a in hists[m]]
        if any(len(hists[m]) != BASELINE_ROUNDS for m in reported) or \
                not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
            raise AssertionError(f"{name}: bad metric history {hists}")
        if res.state.layout.size != CNN_PARAMS:
            raise AssertionError(f"{name}: {res.state.layout.size} params")
        loss1 = served_loss(b, res.state)
        line = (f"{algo}: served global model's train loss {loss0:.4f} -> "
                f"{loss1:.4f}")
        if adapted:
            loss1_adapted = served_loss(b, res.state, adapted=True)
            line += (f"; after one adaptation step (the model Per-FedAvg "
                     f"trains) {loss0_adapted:.4f} -> {loss1_adapted:.4f}")
            if not loss1_adapted < loss0_adapted:
                raise AssertionError(f"{name}: training did not lower the "
                                     "adapted loss")
        elif not loss1 < loss0:
            raise AssertionError(f"{name}: training did not lower the "
                                 f"served model's loss {loss0} -> {loss1}")
        say("baselines", line)
        per_round = prox_launches_per_round(s)
        check_launches(launches, {"prox_update": BASELINE_ROUNDS * per_round}
                       if per_round else {}, name)
        say("baselines", f"{algo}: peak device memory {peak:.1f} MiB; "
            f"launches {launches} ({per_round} prox_update a round)")
        out[s.name] = (b, res)
    return out


def phase_baseline_consistency():
    """One round of pFedMe, Ditto and L2GD from the same state through the
    prox kernel and through its plain version, on the card."""
    import torch

    from repro_torch.scenarios import build_scenario

    for name in BASELINE_CELLS:
        b = build_scenario(name, seed=1, device=DEVICE)
        if prox_launches_per_round(b.scenario) == 0:
            continue
        state = b.algo.init_state(b.params0, b.m, b.n)
        masks = dict(team_mask=torch.ones(b.m, device=DEVICE),
                     device_mask=torch.ones(b.m, b.n, device=DEVICE))
        out = {mode: b.algo.round(state, b.train, mode=mode, **masks)
               for mode in (None, "torch")}
        torch.cuda.synchronize()
        worst = max(float((getattr(out[None], t) - getattr(out["torch"], t))
                          .abs().max()) for t in ("x", "personal"))
        say("consistency", f"one round [{b.algo.name}] kernel vs plain "
            f"path: max |diff| over x, personal = {worst:.3g} (tol 1e-4)")
        if not worst <= 1e-4:
            raise AssertionError(f"{name}: kernel and plain paths disagree")


def phase_baseline_serving(b, res):
    """A ModelStore exported from a baseline's trained state (Ditto's):
    its device rows equal ``serving_params`` bit for bit, its team and
    global rows are x; then 512 Zipf requests replayed through it."""
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.models import paper_models as pm
    from repro_torch.serve import (ModelStore, PersonalizedServer,
                                   replay_traffic)

    st, m, n = res.state, b.m, b.n
    torch.cuda.synchronize()
    reset_launches()
    store = ModelStore.from_result(b.algo, res, m=m, n=n)
    check_launches({k: c for k, c in LAUNCHES.items() if c}, {},
                   f"store export [{b.algo.name}]")
    ts = torch.arange(m, device=DEVICE)
    ds = torch.arange(n, device=DEVICE)
    rows = store.gather(ts.repeat_interleave(n), ds.repeat(m)).view(m, n, -1)
    if not (torch.equal(rows, b.algo.serving_params(st, ts[:, None],
                                                    ds[None]))
            and torch.equal(rows, st.personal)
            and torch.equal(store.team_rows, st.x.expand(m, -1))
            and torch.equal(store.global_row, st.x)):
        raise AssertionError(f"{b.algo.name} store rows differ from "
                             "serving_params")
    cfg = b.config
    pool = b.val["x"].reshape((-1,) + tuple(b.val["x"].shape[3:]))
    server = PersonalizedServer(
        store, lambda p, x: pm.apply(p, cfg, x[:, None])[:, 0])
    stats = replay_traffic(server, pool, requests=SERVE_REQUESTS,
                           batch=SERVE_BATCH, alpha=1.2, unknown_frac=0.1,
                           seed=0)
    if sum(stats["tier_counts"].values()) != SERVE_REQUESTS:
        raise AssertionError(f"replay tiers {stats['tier_counts']}")
    say("serve", f"[{b.algo.name}] store rows equal serving_params (device "
        f"rows = v, team and global rows = x) bit for bit; replay: qps "
        f"{stats['qps']:.1f}, p50 {stats['p50_ms']:.3f} ms, p99 "
        f"{stats['p99_ms']:.3f} ms (host clock, batch {SERVE_BATCH}); "
        f"tiers {stats['tier_counts']}")


def fig3_grid():
    """The nine Fig-3 grid points, in FIG3_SWEEPS order."""
    return [dict(alpha=0.01, eta=0.03, **fixed, **{name: v})
            for name, (values, fixed) in FIG3_SWEEPS.items()
            for v in values]


def state_diff(a, b):
    """Max |a - b| over every tensor of two states (nested states
    included)."""
    import torch

    worst = 0.0
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, torch.Tensor):
            worst = max(worst, float((va - vb).abs().max()))
        elif dataclasses.is_dataclass(va):
            worst = max(worst, state_diff(va, vb))
    return worst


def run_diffs(a, b):
    """(state, train loss, accuracy): max |a - b| of two runs of one
    config."""
    worst = {}
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss"):
        x, y = getattr(a, f), getattr(b, f)
        if len(x) != len(y):
            raise AssertionError(f"{f}: {len(x)} evals against {len(y)}")
        worst[f] = max([0.0] + [abs(p - q) for p, q in zip(x, y)])
    return (state_diff(a.state, b.state), worst.pop("train_loss"),
            max(worst.values()))


def expected_launches(spec, rounds, runs):
    """{kernel: launches} of ``runs`` looped runs (or one sweep, runs=1)
    of ``spec`` for ``rounds`` rounds: prox_update per round, and a
    compressed PerMFL cell's kernel once per uplink (K + 1 a round)."""
    per_round = prox_launches_per_round(spec)
    out = {"prox_update": runs * rounds * per_round} if per_round else {}
    if spec.comm is not None:
        kernel = (COMPRESS_KERNEL if spec.comm.error_feedback
                  else PLAIN_KERNEL).get(spec.comm.compressor)
        if kernel:                        # identity launches no kernel
            out[kernel] = runs * rounds * (spec.algo.resolved()["k_team"]
                                           + 1)
    return out


def sweep_against_loops(spec, grid, seeds, rounds, failures, loop_tol):
    """``spec`` over grid x seeds (C configs), each run with the launch
    counts set to 0 just before it and read just after:

      * ``sweep_scenario`` (the kernels): each kernel launched once for
        all C configs, the looped runs' count over C;
      * ``run_sweep(mode="torch")`` (the plain versions, no kernel): each
        config within SWEEP_TOL of the kernel sweep's (states, losses;
        accuracies within one validation sample);
      * each config's looped ``run_experiment``: a one-config sweep
        equal to it to the bit (the same round body on the same batches);
        config 0 of the sweep equal to the bit to each row of a sweep of
        C copies of it (configs do not interact: a config's numbers
        depend on the sweep's size, never on the other configs); and,
        with ``loop_tol``, each swept config within ``loop_tol`` of its
        looped run, else that difference is printed only.

    Why a swept config may round apart from its looped run: with C > 1
    the batched products and PyTorch's reductions run over C*M*N rows,
    and cuBLAS and the reductions choose their summation order by that
    size; training amplifies the last-bit differences, pFedMe's the most
    (w <- w - 15 (w - theta): a rounding difference in theta enters w
    15-fold each local round; the numbers are in PERF.md). A failed
    check is appended to ``failures``, so that one run reads every
    cell's numbers. Returns (the sweep, its peak MiB)."""
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import build_scenario, sweep_scenario
    from repro_torch.scenarios.spec import init_model
    from repro_torch.train.engine import run_experiment
    from repro_torch.train.sweep import run_sweep

    b = build_scenario(spec, seeds[0], device=DEVICE)
    _, rebuild = b.algo.tree_hparams()
    kw = dict(rounds=rounds, m=b.m, n=b.n, team_frac=spec.team_frac,
              device_frac=spec.device_frac)
    torch.cuda.synchronize()
    reset_launches()
    looped = [run_experiment(rebuild(g), init_model(b.config, s), b.train,
                             b.val, metric_fn=b.metric_fn, seed=s,
                             device=DEVICE, **kw)
              for g in grid for s in seeds]
    loop_launches = {k: c for k, c in LAUNCHES.items() if c}
    runs = len(looped)
    check_launches(loop_launches, expected_launches(spec, rounds, runs),
                   f"{spec.name} looped")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sw = sweep_scenario(spec, grid, seeds, rounds=rounds, device=DEVICE)
    sweep_launches = {k: c for k, c in LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated() / 2**20
    check_launches(sweep_launches, expected_launches(spec, rounds, 1),
                   f"{spec.name} sweep")
    if any(sweep_launches[k] * runs != c for k, c in loop_launches.items()):
        raise AssertionError(f"{spec.name}: sweep {sweep_launches}, looped "
                             f"{loop_launches} over {runs} configs")
    reset_launches()
    plain = run_sweep(b.algo, grid, seeds, lambda sd: init_model(
        b.config, sd), b.train, b.val, metric_fn=b.metric_fn, mode="torch",
        device=DEVICE, **kw)
    check_launches({k: c for k, c in LAUNCHES.items() if c}, {},
                   f"{spec.name} plain sweep")
    one = sweep_scenario(spec, grid[:1], seeds[:1], rounds=rounds,
                         device=DEVICE)
    copies = sweep_scenario(spec, grid[:1] * len(grid),
                            seeds[:1] * len(seeds), rounds=rounds,
                            device=DEVICE)
    bitwise = [("a one-config sweep and its looped run", one[0], looped[0])]
    bitwise += [(f"config 0 and copy {j} of it in a sweep of {runs}",
                 sw[0], c) for j, c in enumerate(copies)]
    for what, x, y in bitwise:
        if any(run_diffs(x, y)) or x.participation != y.participation:
            failures.append(f"{spec.name}: {what} differ: "
                            f"{run_diffs(x, y)}")
    n_val = b.val["y"].shape[-1]
    tols = {"loop": loop_tol, "plain": SWEEP_TOL}
    worst = {"loop": [0.0, 0.0, 0.0], "plain": [0.0, 0.0, 0.0]}
    for res, ref, pl in zip(sw, looped, plain):
        for what, other in (("loop", ref), ("plain", pl)):
            diffs = run_diffs(res, other)
            worst[what] = [max(w, d) for w, d in zip(worst[what], diffs)]
            d, loss, acc = diffs
            if tols[what] is not None and not (
                    d <= tols[what] and loss <= tols[what]
                    and acc <= 1.0 / n_val + 1e-6):
                failures.append(
                    f"{spec.name}: a swept config and its {what} run "
                    f"differ: state {d:.3g}, loss {loss:.3g}, accuracy "
                    f"{acc:.3g}")
        if res.participation != ref.participation:
            raise AssertionError(f"{spec.name}: participation differs")
        if ref.comm is not None and \
                res.comm.total_bytes() != ref.comm.total_bytes():
            raise AssertionError(f"{spec.name}: ledger bytes differ")
    loop_s = sum(r.seconds for r in looped)
    held = ("printed, not held" if loop_tol is None
            else f"tol {loop_tol:g}")
    say("sweep", f"{spec.name}: {runs} configs x {rounds} rounds; sweep "
        f"{sw.seconds:.3f} s ({runs / sw.seconds:.2f} configs/s), looped "
        f"{loop_s:.3f} s ({runs / loop_s:.2f} configs/s): "
        f"{loop_s / sw.seconds:.2f}x (host clock, eval included); "
        f"launches sweep {sweep_launches}, looped {loop_launches}; a "
        f"one-config sweep = its looped run, config 0 = its {runs} copies "
        f"(bit for bit); max |diff| state / loss / accuracy: swept vs "
        f"looped {worst['loop'][0]:.3g} / {worst['loop'][1]:.3g} / "
        f"{worst['loop'][2]:.3g} ({held}), kernels vs plain "
        f"{worst['plain'][0]:.3g} / {worst['plain'][1]:.3g} / "
        f"{worst['plain'][2]:.3g} (tol {SWEEP_TOL:g}); peak {peak:.1f} MiB")
    return sw, peak


def phase_sweeps():
    """Batched sweeps at full width (``sweep_scenario``), each held against
    its looped runs and its plain path (``sweep_against_loops``; the CNN
    cells' drift from their looped runs printed, not held): Fig 3's
    nine grid points on fig3/mnist/mclr (seed 0, FIG3_ROUNDS rounds; the
    final PM / GM per point and the monotone checks of
    benchmarks/fig3_hparams.py, as findings), the seven Table-1 CNN cells
    over three seeds (the seed-mean best PM / GM and
    benchmarks/table1.py's two checks, as findings), and compressed MCLR
    cells over three seeds."""
    import numpy as np

    from repro_torch.scenarios import get_scenario

    spec = get_scenario("fig3/mnist/mclr")
    hp = spec.algo.hparams()
    grid = fig3_grid()
    failures = []
    sw = sweep_against_loops(spec, grid, (0,), FIG3_ROUNDS, failures,
                             SWEEP_TOL)[0]
    sweep_mesh_check(spec, grid, sw)
    say("sweep", f"fig3: prox_update {hp.k_team * hp.l_local} launches a "
        f"swept round for {len(grid)} configs (K*L = "
        f"{hp.k_team * hp.l_local})")
    i = 0
    for name, (values, fixed) in FIG3_SWEEPS.items():
        pm, gm = [], []
        for v in values:
            pm.append(sw[i].pm_acc[-1])
            gm.append(sw[i].gm_acc[-1])
            i += 1
        say("sweep", f"fig3 {name} {values} ({fixed}): final PM "
            + " ".join(f"{a:.4f}" for a in pm) + ", GM "
            + " ".join(f"{a:.4f}" for a in gm))
        metric = gm if name in ("beta", "gamma") else pm
        holds = all(b >= a - 0.03 for a, b in zip(metric, metric[1:]))
        say("sweep", f"fig3 check: {'GM' if metric is gm else 'PM'} "
            f"monotone in {name} (within 0.03) after {FIG3_ROUNDS} rounds: "
            f"{'holds' if holds else 'does not hold'}")
    best = {}
    for algo in TABLE1_ALGOS:
        spec = get_scenario(f"table1/mnist/cnn/{algo}")
        sw, peak = sweep_against_loops(spec, [{}], SWEEP_SEEDS,
                                       SWEEP_ROUNDS, failures, None)
        for f in spec.algo.metrics:
            best[f"{algo}_{f}"] = float(np.mean(sw.best(f)))
        say("sweep", f"table1/mnist/cnn/{algo}: seed-mean best "
            + ", ".join(f"{f.upper()} {best[f'{algo}_{f}']:.4f}"
                        for f in spec.algo.metrics)
            + f" ({len(SWEEP_SEEDS)} seeds, {SWEEP_ROUNDS} rounds); sweep "
            f"peak {peak:.1f} MiB")
    for label, holds in (
            ("PerMFL PM >= PerMFL GM",
             best["permfl_pm"] >= best["permfl_gm"]),
            ("PerMFL PM >= FedAvg GM - 0.02",
             best["permfl_pm"] >= best["fedavg_gm"] - 0.02)):
        say("sweep", f"table1 check after {SWEEP_ROUNDS} rounds: {label}: "
            f"{'holds' if holds else 'does not hold'}")
    for name in SWEEP_COMM_CELLS:
        spec = get_scenario(name)
        sw = sweep_against_loops(spec, [{}], SWEEP_SEEDS, SWEEP_ROUNDS,
                                 failures, SWEEP_TOL)[0]
        say("sweep", f"{name}: ledger bytes per config "
            f"{sw[0].comm.total_bytes() / 1e6:.3f} MB, equal to each looped "
            f"run's")
    sweep_profiles_check()
    if failures:
        raise AssertionError("; ".join(failures))


def sweep_mesh_check(spec, grid, sw):
    """Phase 14 (d): the Fig-3 sweep again, on the one-card sweep mesh
    (``sweep_scenario(mesh=make_host_mesh(n_sweep=1))``: states,
    hyperparameters and system leaves placed by ``sweep_pspecs``, the data
    replicated), bit-equal to ``sw``, the same sweep run without a mesh:
    every config's histories and every tensor of the stacked state."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.scenarios import sweep_scenario
    from repro_torch.train.store import state_fields

    t0 = time.perf_counter()
    mesh = make_host_mesh(n_sweep=1)
    meshed = sweep_scenario(spec, grid, (0,), rounds=FIG3_ROUNDS, mesh=mesh)
    diffs = [run_diffs(a, b) for a, b in zip(sw, meshed)]
    fields = list(zip(state_fields(sw.state_stacked),
                      state_fields(meshed.state_stacked)))
    tensors = [(p, x, y) for (p, x), (_, y) in fields
               if isinstance(x, torch.Tensor)]
    apart = [p for p, x, y in tensors if not torch.equal(x, y)]
    if len(meshed) != len(sw) or any(any(d) for d in diffs) or apart:
        raise AssertionError(f"fig3 on the sweep mesh {mesh.shape}: not "
                             f"bit-equal to the unsharded sweep ({diffs}; "
                             f"state fields {apart})")
    say("sweep", f"fig3 on the one-card sweep mesh {mesh.shape} on "
        f"{mesh.device}: {len(meshed)} configs, histories and {len(tensors)} "
        f"state tensors bit-equal to the unsharded sweep "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_sweep_profile():
    """One round of the Fig-3 sweep (9 configs) and of the PerMFL Table-1
    CNN sweep (3 seeds) under torch.profiler, beside one looped round of
    one of their configs: host clock, device busy share, launches."""
    from repro_torch.scenarios import get_scenario, run_scenario, \
        sweep_scenario

    for name, grid, seeds in (("fig3/mnist/mclr", fig3_grid(), (0,)),
                              ("table1/mnist/cnn/permfl", [{}],
                               SWEEP_SEEDS)):
        spec = get_scenario(name)
        runs = {"sweep": lambda: sweep_scenario(spec, grid, seeds,
                                                rounds=1, device=DEVICE),
                "looped": lambda: run_scenario(spec, rounds=1,
                                               device=DEVICE)}
        for label, fn in runs.items():
            fn()                                         # warm-up
            res, _, rows = profiled(fn)
            busy = sum(e.self_device_time_total for e in rows) / 1e6
            wall = res.seconds
            configs = len(res) if label == "sweep" else 1
            say("profile", f"{name} {label} ({configs} config(s)), one "
                f"round with its eval: {wall:.3f} s host clock (profiled); "
                f"kernels {busy:.3f} s of device time, busy "
                f"{busy / wall:.1%}; {sum(e.count for e in rows)} kernel "
                f"launches")


def phase_families():
    """One round of one cell of each PerMFL family beyond Table 1 and
    Fig 2 at its registered size, with the launch counts set to 0 just
    before and read just after: prox_update exactly K*L times, no other
    kernel; finite metrics in [0, 1]."""
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import get_scenario, run_scenario

    for name in FAMILY_CELLS:
        s = get_scenario(name)
        torch.cuda.synchronize()
        reset_launches()
        res = run_scenario(s, rounds=1, device=DEVICE)
        launches = {k: c for k, c in LAUNCHES.items() if c}
        check_launches(launches, {"prox_update": prox_launches_per_round(s)},
                       name)
        accs = res.pm_acc + res.tm_acc + res.gm_acc
        if len(accs) != 3 or not all(0.0 <= a <= 1.0 for a in accs) or \
                not all(map(math.isfinite, accs + res.train_loss)):
            raise AssertionError(f"{name}: bad metrics {accs} "
                                 f"{res.train_loss}")
        d = s.data
        say("families", f"{s.name}: {d.m_teams}x{d.n_devices} devices, "
            f"{d.partitioner}/{d.strategy}, {s.model.kind} (P = "
            f"{res.state.layout.size}); participation "
            f"{res.participation[0]}; PM {res.pm_acc[0]:.4f} TM "
            f"{res.tm_acc[0]:.4f} GM {res.gm_acc[0]:.4f} train_loss "
            f"{res.train_loss[0]:.4f}; {res.round_seconds[0]:.3f} s; "
            f"launches {launches}")


def theta_sample(spec):
    """THETA_SAMPLE fixed (team, device) rows of ``spec``'s population
    (all of them when fewer) and their values before the run: the model
    ``run_scenario`` starts from (seed 0), which ``init_state`` copies
    into every device row."""
    import numpy as np
    import torch

    from repro_torch.convert import params_from_numpy
    from repro_torch.flat import Layout
    from repro_torch.scenarios.spec import init_model

    m, n = spec.data.m_teams, spec.data.n_devices
    flat = np.random.default_rng(0).permutation(m * n)[:THETA_SAMPLE]
    flat.sort()
    p0 = params_from_numpy(init_model(spec.model_config(), 0), DEVICE)
    x0 = Layout.of(p0).flatten(p0)
    rows = (torch.as_tensor(flat // n, device=DEVICE),
            torch.as_tensor(flat % n, device=DEVICE))
    return rows, x0.expand(len(flat), -1).clone()


def cohort_parts(res):
    """'part median' of each synchronized part of ``res``'s rounds."""
    import statistics

    return ", ".join(f"{k} {statistics.median(v) * 1e3:.2f}"
                     for k, v in res.part_seconds.items()) + " ms"


def phase_cohort():
    """The four cohort/virtual/* cells at their registered sizes and
    rounds through ``run_scenario`` on the card, each with the launch
    counts set to 0 just before and read just after: prox_update exactly
    K*L a round (at 2 x c rows) and no other kernel; every round's index
    map sorted, distinct and in range; a fixed sample of THETA_SAMPLE
    rows of theta: rows of devices never sampled bit-unchanged, rows
    sampled moved; metrics finite in [0, 1]. Prints the median round
    seconds, the synchronized parts, the data's build and copy, the peak
    device memory and the resident bytes. Then cohort/virtual/n1000 at
    cohort = n against its stacked run (bit-equal), and
    cohort/virtual/n10000 with top-k 10% uplinks: the EF residuals of
    devices never sampled stay zero. Returns the launches of prox_update
    (and ef_topk) over these runs."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import get_scenario, run_scenario

    total = {}
    for name in COHORT_CELLS:
        spec = get_scenario(name)
        hp = spec.algo.hparams()
        d, c = spec.data, spec.cohort_size
        rows, before = theta_sample(spec)
        release()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = run_scenario(name, device=DEVICE, time_parts=True)
        torch.cuda.synchronize()
        launches = {k: v for k, v in LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        expect = spec.rounds * hp.k_team * hp.l_local
        check_launches(launches, {"prox_update": expect}, name)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        idx = np.asarray(res.cohort_indices)
        if idx.shape != (spec.rounds, d.m_teams, c) or \
                not (np.diff(idx, axis=-1) > 0).all() or idx.min() < 0 \
                or idx.max() >= d.n_devices:
            raise AssertionError(f"{name}: bad index maps {idx.shape}")
        sampled = np.zeros((d.m_teams, d.n_devices), bool)
        for t in range(d.m_teams):
            sampled[t, np.unique(idx[:, t])] = True
        after = res.state.theta[rows]
        was = torch.as_tensor(sampled, device=DEVICE)[rows]
        same = (after == before).all(dim=-1)
        if not bool(same[~was].all()):
            raise AssertionError(f"{name}: a never-sampled row of theta "
                                 "changed")
        if bool(same[was].any()):
            raise AssertionError(f"{name}: a sampled row of theta did not "
                                 "move")
        accs = res.pm_acc + res.tm_acc + res.gm_acc
        if not all(0.0 <= a <= 1.0 for a in accs) or \
                not all(map(math.isfinite, accs + res.train_loss)):
            raise AssertionError(f"{name}: bad metrics {accs}")
        st = res.state
        resident = st.theta.numel() * st.theta.element_size() \
            + d.m_teams * d.n_devices * d.samples_per_device * (60 + 1) * 4
        say("cohort", f"{name}: {d.m_teams} x {d.n_devices:,} devices, "
            f"cohort {c} ({c * d.m_teams} rows a step), {spec.rounds} rounds"
            f"; PM {res.pm_acc[-1]:.4f} TM {res.tm_acc[-1]:.4f} GM "
            f"{res.gm_acc[-1]:.4f} train_loss {res.train_loss[-1]:.4f}; "
            f"launches {launches}")
        say("cohort", f"{name}: round median "
            f"{statistics.median(res.round_seconds):.4f} s (host clock, "
            f"eval included, synchronized parts); parts: "
            f"{cohort_parts(res)}; data build "
            f"{res.setup_seconds['data']:.2f} s, copy to the card "
            f"{res.setup_seconds['to_device']:.2f} s; peak "
            f"{peak / 2**30:.3f} GiB; resident theta + data "
            f"{resident / 1e9:.3f} GB; theta sample: "
            f"{int(was.sum())} of {len(was)} rows sampled (moved), the "
            f"rest bit-unchanged")
        del res, st, after
    # cohort = n is the stacked run
    name = COHORT_CELLS[0]
    n = get_scenario(name).data.n_devices
    runs = {}
    for cohort in (None, n):
        reset_launches()
        runs[cohort] = run_scenario(name, cohort=cohort, device=DEVICE)
        torch.cuda.synchronize()
        for k, v in LAUNCHES.items():
            total[k] = total.get(k, 0) + v
    a, b = runs[None], runs[n]
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation"):
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"{name}: cohort = n differs from the "
                                 f"stacked run in {f}")
    for tier in ("x", "w", "theta"):
        if not torch.equal(getattr(a.state, tier), getattr(b.state, tier)):
            raise AssertionError(f"{name}: cohort = n differs from the "
                                 f"stacked run in {tier}")
    say("cohort", f"{name} with cohort = {n}: bit-equal to the stacked run "
        f"({len(a.pm_acc)} evals, states x, w, theta)")
    # compressed uplinks: ef_dev rides the gather
    spec = dataclasses.replace(get_scenario(COHORT_CELLS[1]),
                               comm=get_scenario(COHORT_COMM).comm)
    reset_launches()
    res = run_scenario(spec, device=DEVICE)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    check_launches(launches, expected_launches(spec, spec.rounds, 1), spec.name)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    idx = np.asarray(res.cohort_indices)
    sampled = torch.zeros(spec.data.m_teams, spec.data.n_devices,
                          dtype=torch.bool, device=DEVICE)
    for t in range(spec.data.m_teams):
        sampled[t, torch.as_tensor(np.unique(idx[:, t]), device=DEVICE)] = 1
    ef = res.state.comm.ef_dev
    if bool(ef[~sampled].any()) or not bool(ef[sampled].any()):
        raise AssertionError(f"{spec.name} [{spec.comm.compressor}]: EF "
                             "residuals of never-sampled devices moved, or "
                             "none of the sampled did")
    say("cohort", f"{spec.name} with {COHORT_COMM}'s uplinks "
        f"({spec.comm}): {int(sampled.sum())} of {sampled.numel()} devices "
        f"sampled in {spec.rounds} rounds; every never-sampled device's "
        f"ef_dev row zero; {res.comm.total_bytes() / 1e6:.3f} MB on the "
        f"links; launches {launches}")
    return total


def phase_system():
    """The wall-clock simulator on the card: the seven comm/mnist/mclr/*
    cells on SYSTEM_PROFILE for SYSTEM_ROUNDS rounds (simulated seconds
    and accuracy at each eval; every lossy uplink priced below the
    uncompressed one), a repeat with the same seed (equal timelines),
    ``uniform`` without a deadline (the trajectory bit-equal to the
    system-free run), and DEADLINE_CELL at full width on
    DEADLINE_PROFILE with a DEADLINE_S deadline for DEADLINE_ROUNDS
    rounds: stragglers dropped, and the system-free run fed the thinned
    masks (its links drawn here and given to both) bit-equal to it. Each
    run with the launch counts set to 0 just before and read just
    after."""
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import get_scenario, run_scenario
    from repro_torch.system import get_profile, simulate_round, \
        workload_for
    from repro_torch.system.simulate import sample_links

    def run(spec, rounds, **kw):
        reset_launches()
        res = run_scenario(spec, rounds=rounds, device=DEVICE, **kw)
        torch.cuda.synchronize()
        check_launches({k: v for k, v in LAUNCHES.items() if v},
                       expected_launches(spec, rounds, 1), spec.name)
        return res

    priced = {}
    for name in COMM_CELLS:
        spec = get_scenario(name)
        res = run(spec, SYSTEM_ROUNDS, system=SYSTEM_PROFILE)
        tl = res.timeline
        if len(tl) != SYSTEM_ROUNDS or not all(t > 0 for t in
                                               tl.round_seconds):
            raise AssertionError(f"{name}: bad timeline {tl}")
        priced[name.split("/")[-1]] = tl.total_seconds()
        say("system", f"{name} on {SYSTEM_PROFILE}: simulated s at each "
            "eval " + ", ".join(f"{s:.3f}" for s in res.sim_seconds)
            + "; PM " + ", ".join(f"{a:.4f}" for a in res.pm_acc)
            + "; GM " + ", ".join(f"{a:.4f}" for a in res.gm_acc)
            + f"; {tl.stragglers()} drops")
    base = priced["uncompressed"]
    for comp in ("topk_10", "topk_25", "randk_10", "int8", "sign"):
        if not priced[comp] < base:
            raise AssertionError(f"{comp} priced {priced[comp]} s, not "
                                 f"below uncompressed {base} s")
    say("system", "every lossy uplink priced below uncompressed "
        f"({base:.3f} s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         priced.items()))
    spec = get_scenario(COMM_CELLS[0])
    a = run(spec, SYSTEM_ROUNDS, system=SYSTEM_PROFILE)
    b = run(spec, SYSTEM_ROUNDS, system=SYSTEM_PROFILE)
    if a.timeline != b.timeline or a.pm_acc != b.pm_acc:
        raise AssertionError("one seed, two timelines")
    plain = run(spec, SYSTEM_ROUNDS, system=None)
    timed = run(spec, SYSTEM_ROUNDS, system="uniform")
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation"):
        if getattr(plain, f) != getattr(timed, f):
            raise AssertionError(f"uniform without a deadline moved {f}")
    if not torch.equal(plain.state.theta, timed.state.theta):
        raise AssertionError("uniform without a deadline moved theta")
    sim = timed.timeline.total_seconds()
    say("system", f"{spec.name}: two runs of one seed, equal timelines "
        f"({a.timeline.total_seconds():.4f} s); uniform without a deadline"
        f" bit-equal to the system-free run ({sim:.4f} simulated s)")
    spec = get_scenario(DEADLINE_CELL)
    sys_spec = get_profile(DEADLINE_PROFILE).with_deadline(DEADLINE_S)
    leaves = sys_spec.tree_floats()[0]
    d = spec.data
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    links = [sample_links(leaves, gen, d.m_teams, d.n_devices)
             for _ in range(DEADLINE_ROUNDS)]
    res = run(spec, DEADLINE_ROUNDS, system=sys_spec,
              links=links.__getitem__)
    b = None
    from repro_torch.scenarios import build_scenario
    b = build_scenario(spec, device=DEVICE)
    wl = workload_for(b.algo, b.params0)
    ones = (torch.ones(d.m_teams, device=DEVICE),
            torch.ones(d.m_teams, d.n_devices, device=DEVICE))
    fed = [simulate_round(leaves, wl, links[t], *ones)[:2]
           for t in range(DEADLINE_ROUNDS)]
    del b
    plain = run(spec, DEADLINE_ROUNDS, system=None, masks=fed.__getitem__)
    if res.timeline.stragglers() == 0:
        raise AssertionError(f"{DEADLINE_CELL} on {DEADLINE_PROFILE}: no "
                             "straggler dropped")
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation"):
        if getattr(plain, f) != getattr(res, f):
            raise AssertionError(f"deadline run and thinned masks differ in "
                                 f"{f}")
    for tier in ("x", "w", "theta"):
        if not torch.equal(getattr(plain.state, tier),
                           getattr(res.state, tier)):
            raise AssertionError(f"deadline run and thinned masks differ in "
                                 f"{tier}")
    say("system", f"{DEADLINE_CELL} on {DEADLINE_PROFILE}, deadline "
        f"{DEADLINE_S:g} s: participation {res.participation}, drops "
        f"{res.timeline.dropped_devices} devices / "
        f"{res.timeline.dropped_teams} teams, round s "
        + ", ".join(f"{t:.1f}" for t in res.timeline.round_seconds)
        + "; bit-equal to the system-free run fed the thinned masks")


def sweep_profiles_check():
    """table1/mnist/mclr/permfl swept over the three non-uniform
    profiles, with the launch counts set to 0 just before and read just
    after: each lane's timeline and trajectory equal to its solo run."""
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import get_scenario, run_scenario, \
        sweep_scenario

    spec = get_scenario(SWEEP_SYSTEM_CELL)
    reset_launches()
    sw = sweep_scenario(spec, rounds=SWEEP_ROUNDS,
                        system=list(SWEEP_PROFILES), device=DEVICE)
    torch.cuda.synchronize()
    check_launches({k: v for k, v in LAUNCHES.items() if v},
                   expected_launches(spec, SWEEP_ROUNDS, 1), spec.name + " sweep")
    for res, prof in zip(sw, SWEEP_PROFILES):
        solo = run_scenario(spec, rounds=SWEEP_ROUNDS, system=prof,
                            device=DEVICE)
        if res.timeline != solo.timeline or any(
                getattr(res, f) != getattr(solo, f)
                for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss")) or \
                not torch.equal(res.state.theta, solo.state.theta):
            raise AssertionError(f"{spec.name} sweep lane {prof} differs "
                                 "from its solo run")
    say("sweep", f"{spec.name} over {list(SWEEP_PROFILES)}: each lane's "
        "timeline and trajectory equal to its solo run; simulated s "
        + ", ".join(f"{r.timeline.total_seconds():.3f}" for r in sw))


def smi_line():
    """``nvidia-smi --query-gpu=name,power.limit`` of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_events(path):
    """The CUDA kernel events of an exported torch.profiler trace."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


def phase_telemetry(main_res):
    """Run telemetry (``repro_torch.obs``) on the card, each path with the
    launch counts set to 0 just before and read just after: SCENARIO for
    TRACE_ROUNDS rounds with probes and health on and a trace dir, against
    the same seed with trace off (histories and state bit-equal,
    prox_update exactly rounds * K * L and no other kernel in both, every
    series finite, the gap's max above its mean, health ok, the event log
    read back and summarized, the span file's compile / dispatch / eval
    spans), then TRACE_REPS more (off, on) pairs for the median round
    seconds; one profiled round of each (``--profile-dir``: the exported
    trace names prox_update's kernel; kernel launches and device time
    off and on); TRACE_COMM traced (its EF residual probes > 0, ef_topk
    exactly rounds * (K + 1)); FAIL_CELL at eta = 1e30 with fail-fast
    (HealthError at round 1); and the int8 store export and replay of
    ``main_res``'s state under an active span log with a metrics
    registry (one quantize launch inside the store_export span, tier
    counters summing to the requests, one latency observation a batch,
    the Prometheus text)."""
    import statistics
    import tempfile

    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.models import paper_models as pm
    from repro_torch.obs import (HealthError, MetricsRegistry, SpanLog,
                                 TraceConfig)
    from repro_torch.obs.events import read_jsonl, split_runs, summarize_run
    from repro_torch.obs.report import load_artifacts
    from repro_torch.scenarios import (AlgoSpec, build_scenario,
                                       get_scenario, run_scenario)
    from repro_torch.serve import (ModelStore, PersonalizedServer,
                                   replay_traffic)
    from repro_torch.train.engine import run_experiment

    t_phase = time.perf_counter()
    smi = smi_line()
    s = get_scenario(SCENARIO)
    hp = s.algo.hparams()
    b = build_scenario(s, seed=0, device=DEVICE)
    on_cfg = TraceConfig(health=True)

    def run(trace, rounds=TRACE_ROUNDS, **kw):
        torch.cuda.synchronize()
        reset_launches()
        r = run_experiment(b.algo, b.params0, b.train, b.val,
                           metric_fn=b.metric_fn, rounds=rounds, m=b.m,
                           n=b.n, team_frac=s.team_frac,
                           device_frac=s.device_frac, seed=0, trace=trace,
                           device=DEVICE, **kw)
        torch.cuda.synchronize()
        launches = {k: c for k, c in LAUNCHES.items() if c}
        check_launches(launches,
                       {"prox_update": rounds * hp.k_team * hp.l_local},
                       f"{SCENARIO} trace {'on' if trace else 'off'}")
        return r

    tmp = Path(tempfile.mkdtemp(prefix="obs-"))
    off = run(None)
    on = run(on_cfg, trace_dir=str(tmp / "run"))
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation"):
        if getattr(on, f) != getattr(off, f):
            raise AssertionError(f"trace on moved {f}")
    for tier in ("x", "w", "theta"):
        if not torch.equal(getattr(on.state, tier), getattr(off.state,
                                                            tier)):
            raise AssertionError(f"trace on moved {tier}")
    series = on.trace.series
    if sorted(series) != ["grad_norm", "part_loss", "pers_gap_max",
                          "pers_gap_mean", "tier_drift_max",
                          "tier_drift_mean", "update_norm"] or any(
            len(v) != TRACE_ROUNDS or not all(map(math.isfinite, v))
            for v in list(series.values())
            + list(on.health.series.values())):
        raise AssertionError(f"bad probe series {series} / "
                             f"{on.health.series}")
    if not all(a >= b_ for a, b_ in zip(series["pers_gap_max"],
                                        series["pers_gap_mean"])):
        raise AssertionError("pers_gap_max below pers_gap_mean")
    if not on.health.ok():
        raise AssertionError(f"health {on.health.summary()}")
    runs = split_runs(read_jsonl(tmp / "run"))
    summ = summarize_run(runs[0])
    if len(runs) != 1 or summ["evals"] != TRACE_ROUNDS or \
            "probes" not in summ:
        raise AssertionError(f"event log read back as {summ}")
    (chrome,) = load_artifacts(tmp / "run")["spans"]
    names = [e["name"] for e in chrome["traceEvents"]]
    if (names.count("compile"), names.count("dispatch"),
            names.count("eval")) != (1, TRACE_ROUNDS - 1, TRACE_ROUNDS):
        raise AssertionError(f"spans {names}")
    say("obs", f"{SCENARIO}: {TRACE_ROUNDS} rounds with probes and health "
        "on bit-equal to trace off (histories, x, w, theta); prox_update "
        f"{TRACE_ROUNDS * hp.k_team * hp.l_local} launches in each, no "
        "other kernel; health ok; events read back "
        f"({summ['evals']} evals, {summ['dispatches']} dispatches); spans "
        f"{sorted(set(names))}")
    for k in sorted(series):
        say("obs", f"  {k}: " + ", ".join(f"{v:.6g}" for v in series[k]))
    say("obs", "  health: " + ", ".join(
        f"{k} {v}" for k, v in sorted(on.health.series.items())))

    # round seconds (host clock, eval included, to a synchronized card),
    # rounds after the first, (off, on) pairs in alternating order
    times = {False: off.round_seconds[1:], True: on.round_seconds[1:]}
    for rep in range(TRACE_REPS):
        for traced in ((True, False) if rep % 2 == 0 else (False, True)):
            times[traced] += run(on_cfg if traced else None).round_seconds[1:]
    t_off, t_on = (statistics.median(times[k]) for k in (False, True))
    say("obs", f"median round seconds over {len(times[False])} rounds: "
        f"trace off {t_off:.4f} s, on {t_on:.4f} s "
        f"({(t_on - t_off) * 1e3:+.2f} ms, {t_on / t_off - 1:+.2%}); "
        f"ranges off {min(times[False]):.4f}-{max(times[False]):.4f}, on "
        f"{min(times[True]):.4f}-{max(times[True]):.4f} [{smi}]")

    # --profile-dir: one round, probes off and on
    prof = {}
    for traced in (False, True):
        cfg = on_cfg if traced else TraceConfig(
            drift=False, grads=False, residuals=False, loss=False,
            health=False)
        d = tmp / f"prof-{int(traced)}"
        run(dataclasses.replace(cfg, profile_dir=str(d)), rounds=1)
        (path,) = d.glob("torch-*.trace.json")
        kernels = kernel_events(path)
        prox = [e for e in kernels if "prox_kernel" in e["name"]]
        if len(prox) != hp.k_team * hp.l_local:
            raise AssertionError(f"profile {path}: {len(prox)} prox_kernel "
                                 "events")
        prof[traced] = (len(kernels), sum(e["dur"] for e in kernels) / 1e3)
    say("obs", f"--profile-dir: the exported trace names "
        f"{prox[0]['name'][:60]!r} {len(prox)} times a round; one profiled "
        f"round (eval included): {prof[False][0]} kernel launches, "
        f"{prof[False][1]:.2f} ms of kernel time with probes off; "
        f"{prof[True][0]} ({prof[True][0] - prof[False][0]:+d}), "
        f"{prof[True][1]:.2f} ms ({prof[True][1] - prof[False][1]:+.2f}) "
        f"with probes and health on [{smi}]")

    # the compressed path: EF residual probes
    spec = get_scenario(TRACE_COMM)
    chp = spec.algo.hparams()
    reset_launches()
    res = run_scenario(spec, rounds=COMM_ROUNDS, trace=on_cfg,
                       device=DEVICE)
    torch.cuda.synchronize()
    check_launches({k: c for k, c in LAUNCHES.items() if c},
                   {"prox_update": COMM_ROUNDS * chp.k_team * chp.l_local,
                    "ef_topk": COMM_ROUNDS * (chp.k_team + 1)},
                   f"{TRACE_COMM} traced")
    ef = {k: res.trace[k] for k in ("ef_dev_norm", "ef_team_norm")}
    if not all(v > 0 and math.isfinite(v) for vs in ef.values()
               for v in vs) or not res.health.ok():
        raise AssertionError(f"{TRACE_COMM}: residual probes {ef}")
    say("obs", f"{TRACE_COMM}: ef_topk {COMM_ROUNDS * (chp.k_team + 1)} "
        "launches; " + "; ".join(f"{k} " + ", ".join(f"{v:.6g}" for v in
                                                      vs)
                                 for k, vs in ef.items()))

    # fail-fast at eta = 1e30
    spec = get_scenario(FAIL_CELL)
    spec = dataclasses.replace(spec, algo=AlgoSpec(spec.algo.name, tuple(
        dict(spec.algo.overrides, eta=1e30).items())))
    try:
        run_scenario(spec, rounds=3, trace=TraceConfig(fail_fast=True),
                     device=DEVICE)
    except HealthError as e:
        if e.round_index != 1:
            raise AssertionError(f"fail-fast named round {e.round_index}")
        say("obs", f"{FAIL_CELL} at eta=1e30: {e}")
    else:
        raise AssertionError(f"{FAIL_CELL} at eta=1e30 ran to its end")

    # serving under a span log, into a metrics registry
    log, metrics = SpanLog(meta={"kind": "serve"}), MetricsRegistry()
    cfg = b.config
    pool = b.val["x"].reshape((-1,) + tuple(b.val["x"].shape[3:]))
    with log.activate():
        torch.cuda.synchronize()
        reset_launches()
        store = ModelStore.from_result(b.algo, main_res, m=b.m, n=b.n,
                                       encoding="int8")
        torch.cuda.synchronize()
        check_launches({k: c for k, c in LAUNCHES.items() if c},
                       {"quantize": 1}, "traced int8 store export")
        server = PersonalizedServer(
            store, lambda p, x: pm.apply(p, cfg, x[:, None])[:, 0])
        stats = replay_traffic(server, pool, requests=SERVE_REQUESTS,
                               batch=SERVE_BATCH, alpha=1.2,
                               unknown_frac=0.1, seed=0, metrics=metrics)
    spans = [sp.name for sp in log.spans]
    tiers = sum(metrics.counter(f"serving.tier.{t}").value
                for t in ("device", "team", "global"))
    batches = SERVE_REQUESTS // SERVE_BATCH
    lat = metrics.histogram("serving.replay.latency_ms")
    prom = metrics.write_prom(tmp / "metrics-serve.prom").read_text()
    if spans.count("store_export") != 1 or spans.count("replay") != 1 or \
            spans.count("replay_batch") != batches or \
            tiers != SERVE_REQUESTS or lat.count() != batches or \
            f"serving_requests {SERVE_REQUESTS}" not in prom:
        raise AssertionError(f"serving telemetry: spans {spans}, tiers "
                             f"{tiers}, latencies {lat.count()}")
    say("obs", f"int8 store export: 1 quantize launch inside the "
        f"store_export span; replay of {SERVE_REQUESTS} requests: tier "
        f"counters sum {tiers:g}, {lat.count()} latency observations, p50 "
        f"{lat.quantile(50):.3f} ms (qps {stats['qps']:.1f}); "
        f"{len(prom.splitlines())} lines of Prometheus text")
    say("obs", f"phase 7f took {time.perf_counter() - t_phase:.1f} s")


def phase_baseline_profile():
    """One round of each baseline's CNN cell under torch.profiler, after
    a warm-up round and an unprofiled one: host-clock seconds, device
    busy share and kernel launches."""
    import torch

    from repro_torch.scenarios import build_scenario

    for name in BASELINE_CELLS:
        b = build_scenario(name, seed=2, device=DEVICE)
        state = b.algo.init_state(b.params0, b.m, b.n)
        masks = dict(team_mask=torch.ones(b.m, device=DEVICE),
                     device_mask=torch.ones(b.m, b.n, device=DEVICE))
        state = b.algo.round(state, b.train, **masks)       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.algo.round(state, b.train, **masks)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        _, wall, rows = profiled(lambda: b.algo.round(state, b.train,
                                                      **masks))
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        say("profile", f"one round [{b.algo.name}]: {plain_wall:.3f} s host "
            f"clock unprofiled, {wall:.3f} s profiled; kernels {busy:.3f} s "
            f"of device time, busy {busy / plain_wall:.1%} of the "
            f"unprofiled round; {sum(e.count for e in rows)} kernel "
            f"launches")
        for e in rows[:5]:
            say("profile", f"[{b.algo.name}] "
                f"{e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  "
                f"{e.key[:90]}")


def attention_cases():
    """(label, b, sq, skv, hq, hkv, d, causal, window, q_offset, q dtype,
    kv dtype, timed): the serving paths' shapes in bf16 first (deepseek's
    prefill and decode, Whisper's encoder and cross decode, Qwen2-VL's
    12:2 prefill, Jamba's 64:8 prefill and decode and phi3-mini's 32 heads
    of 96, prefill and decode, timed; Whisper's cross prefill and
    Qwen2-VL's decode checked), then the small shapes in f32 and bf16."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    b, p, n = LLM_BATCH, LLM_PROMPT, LLM_MAX_LEN
    enc = 1500                      # whisper-small's encoder_seq_len
    cases = [("deepseek prefill", b, p, p, 16, 16, 128, True, 0, 0, bf16,
              bf16, True),
             ("deepseek decode", b, 1, n, 16, 16, 128, True, 0,
              LLM_DECODE_OFFSET, bf16, bf16, True),
             ("whisper encoder", b, enc, enc, 12, 12, 64, False, 0, 0, bf16,
              bf16, True),
             ("whisper cross decode", b, 1, enc, 12, 12, 64, False, 0, 0,
              bf16, bf16, True),
             ("qwen2-vl prefill", b, p, p, 12, 2, 128, True, 0, 0, bf16,
              bf16, True),
             ("jamba prefill", b, p, p, 64, 8, 128, True, 0, 0, bf16, bf16,
              True),
             ("jamba decode", b, 1, n, 64, 8, 128, True, 0,
              LLM_DECODE_OFFSET, bf16, bf16, True),
             ("phi3 prefill", b, p, p, 32, 32, 96, True, 0, 0, bf16, bf16,
              True),
             ("phi3 decode", b, 1, n, 32, 32, 96, True, 0,
              LLM_DECODE_OFFSET, bf16, bf16, True),
             ("whisper cross prefill", b, WHISPER_PROMPT, enc, 12, 12, 64,
              False, 0, 0, bf16, bf16, False),
             ("qwen2-vl decode", b, 1, n, 12, 2, 128, True, 0, p + 14, bf16,
              bf16, False),
             ("ragged prefill", 1, 300, 300, 2, 2, 128, True, 0, 0, bf16,
              bf16, False),
             ("head_dim 64 prefill", 2, 256, 256, 12, 12, 64, True, 0, 0,
              bf16, bf16, False),
             ("GQA 40:8 decode", 1, 1, n, 40, 8, 128, True, 0, n - 1, bf16,
              bf16, False),
             ("GQA 12:2 decode", 2, 1, n, 12, 2, 128, True, 0, 0, bf16,
              bf16, False),
             ("window 256 decode", 1, 1, n, 4, 4, 128, True, 256,
              LLM_DECODE_OFFSET, bf16, bf16, False)]
    for dt in (f32, bf16):
        cases += [("GQA 40:8", 1, 256, 256, 40, 8, 128, True, 0, 0, dt, dt,
                   False),
                  ("head_dim 96", 2, 256, 256, 8, 8, 96, True, 0, 0, dt, dt,
                   False),
                  ("window 256", 1, 1024, 1024, 4, 4, 128, True, 256, 0, dt,
                   dt, False),
                  ("non-causal", 2, 128, 160, 4, 4, 64, False, 0, 0, dt, dt,
                   False)]
    cases.append(("q bf16 / cache f32 decode", b, 1, n, 16, 16, 128, True, 0,
                  LLM_DECODE_OFFSET, bf16, f32, False))
    return cases


def sdpa_call(q, k, v, causal, q_offset):
    """The library call computing the same attention on the same tensors:
    ``scaled_dot_product_attention`` over (b, h, s, d) views; a causal
    prefill with ``is_causal``, a decode with a boolean mask over the
    cache."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = {"enable_gqa": True} if q.shape[2] != k.shape[2] else {}
    if q.shape[1] > 1 or not causal:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, **kw)
    mask = torch.arange(k.shape[1], device=q.device) <= q_offset
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None, None, None, :], **kw)


def phase_attention_check():
    """flash_attention against its plain version at every case of
    :func:`attention_cases`; the timed ones with their plain version's
    time, bound and the library call's time. Returns {label: numbers}."""
    import torch

    from repro_torch.kernels.flash_attention import attention, plan
    from repro_torch.roofline import kernels as W

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    out = {}
    for (label, b, sq, skv, hq, hkv, d, causal, window, q_offset, qdt, kvdt,
         timed) in attention_cases():
        q = torch.randn(b, sq, hq, d, device=DEVICE, generator=gen).to(qdt)
        k = torch.randn(b, skv, hkv, d, device=DEVICE, generator=gen).to(kvdt)
        v = torch.randn(b, skv, hkv, d, device=DEVICE, generator=gen).to(kvdt)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        variant, splits = plan(q, k, v, **kw)
        got = attention(q, k, v, **kw)
        want = attention(q, k, v, mode="torch", **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = ATTN_TOL[str(qdt).split(".")[-1]]
        name = (f"{label} {str(qdt).split('.')[-1]}/"
                f"{str(kvdt).split('.')[-1]} [{variant}"
                + (f", {splits} chunks]" if variant == "split_kv" else "]"))
        shape = f"q ({b}, {sq}, {hq}, {d}), kv ({b}, {skv}, {hkv}, {d})"
        if not err <= tol:
            raise AssertionError(f"flash_attention {name}: kernel and plain "
                                 f"version differ by {err} (tol {tol})")
        if not timed:
            say("kernel", f"flash_attention {name} {shape}: max abs err "
                f"{err:.3g} (tol {tol:g})")
            continue
        ms = cuda_time_ms(lambda: attention(q, k, v, **kw),
                          20 if sq > 1 else TIMED_LAUNCHES)
        plain_ms = cuda_time_ms(lambda: attention(q, k, v, mode="torch",
                                                  **kw), 10)
        lib_ms = cuda_time_ms(sdpa_call(q, k, v, causal, q_offset),
                              20 if sq > 1 else TIMED_LAUNCHES)
        clean_ms = cuda_time_ms(lambda: attention(q, k, v, **kw), 20,
                                clean=True)
        clean_lib = cuda_time_ms(sdpa_call(q, k, v, causal, q_offset), 20,
                                 clean=True)
        bound_ms, by, mb, gflop = bound(W.attention(
            b, sq, skv, hq, hkv, d, causal=causal, window=window,
            q_offset=q_offset, q_itemsize=qdt.itemsize,
            kv_itemsize=kvdt.itemsize))
        say("kernel", f"flash_attention {name} {shape}, q_offset "
            f"{q_offset}: max abs err {err:.3g} (tol {tol:g}); kernel "
            f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
            f"scaled_dot_product_attention {lib_ms * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.1f} us ({mb:.1f} MB, {gflop:.2f} GFLOP; by "
            f"{by}), {bound_ms / ms:.1%} of bound; after a flush that leaves "
            f"the L2 clean: kernel {clean_ms * 1e3:.1f} us, "
            f"scaled_dot_product_attention {clean_lib * 1e3:.1f} us")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
    out["phi3 train forward"] = phi3_train_forward(gen)
    return out


def phi3_train_forward(gen):
    """flash_attention at phi3-mini's training shape (4 x 1,024, 32 heads
    of 96, bf16, causal) as a training pass runs it: the variant ``plan``
    picks, which must be ``wgmma`` (a row of 96 is a 64-column box and half
    a box), with the log-sum-exp its backward reads, against
    ``attention_lse_ref`` (out within 2e-2, lse within 1e-4), timed L2-cold
    beside its plain version, its bound and scaled_dot_product_attention
    on the same tensors. Returns its numbers."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plan
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    from repro_torch.kernels.interface import KernelType
    from repro_torch.roofline import kernels as W

    b, s, h, d, bf16 = TRAIN_BATCH, TRAIN_SEQ, 32, 96, torch.bfloat16
    q, k, v = (torch.randn(b, s, h, d, device=DEVICE, generator=gen).to(bf16)
               for _ in range(3))

    def kernel():
        return fa_ops._forward(q, k, v, True, 0, 0, KernelType.CUDA, True)

    variant = plan(q, k, v, causal=True)[0]
    if variant != "wgmma":
        raise AssertionError(f"phi3's training forward plans {variant}, "
                             "expected wgmma")
    got, lse = kernel()
    want, lse_p = attention_lse_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    lse_err = float((lse - lse_p).abs().max())
    tag = (f"flash_attention phi3 train forward bf16 [{variant}, with the "
           f"log-sum-exp] q, kv ({b}, {s}, {h}, {d})")
    if not (err <= ATTN_TOL["bfloat16"] and lse_err <= 1e-4):
        raise AssertionError(f"{tag}: kernel and plain version differ by "
                             f"{err} (out), {lse_err} (lse)")
    ms = cuda_time_ms(kernel, 20)
    plain_ms = cuda_time_ms(lambda: attention_lse_ref(q, k, v, causal=True),
                            5)
    lib_ms = cuda_time_ms(sdpa_call(q, k, v, True, 0), 20)
    bound_ms, by, mb, gflop = bound(W.attention(
        b, s, s, h, h, d, causal=True, window=0, q_offset=0, q_itemsize=2,
        kv_itemsize=2))
    say("kernel", f"{tag}: max abs err {err:.3g} (tol "
        f"{ATTN_TOL['bfloat16']:g}), lse {lse_err:.3g} (tol 1e-4); kernel "
        f"{ms * 1e3:.1f} us L2-cold, plain {plain_ms * 1e3:.1f} us, "
        f"scaled_dot_product_attention {lib_ms * 1e3:.1f} us, bound "
        f"{bound_ms * 1e3:.1f} us ({mb:.1f} MB, {gflop:.2f} GFLOP; by {by}),"
        f" {bound_ms / ms:.1%} of bound")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_ms)


def router_logits(t, e, gen, tied):
    import torch

    x = 2 * torch.randn(t, e, device=DEVICE, generator=gen)
    if tied:        # all-equal rows, tied maxima, a tied top-k boundary
        x[0::7] = 0.25
        x[1::7, 5] = x[1::7, e - 2] = 9.0
        x[2::7, :8] = 3.0
    return x


def phase_router_check():
    """The moe_router kernel on given logits (route_topk, the JAX package's
    route) against its plain version: ids bit-equal, gates and statistics
    within 1e-6, at the logits of the serving path's prefill and decode
    (timed) and with tied rows. Returns {label: numbers}."""
    import torch

    from repro_torch.kernels.moe_router import route_topk
    from repro_torch.kernels.moe_router.ops import BLOCK_TOKENS, launch
    from repro_torch.roofline import kernels as W

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    e = 64
    out = {}
    for label, t, k, tied in (("prefill", LLM_BATCH * LLM_PROMPT, 6, False),
                              ("decode", LLM_BATCH, 6, False),
                              ("tied rows", 512, 6, True),
                              ("tied rows k=1", 70, 1, True)):
        x = router_logits(t, e, gen, tied)
        g, i, aux = route_topk(x, top_k=k)
        g_p, i_p, aux_p = route_topk(x, top_k=k, mode="torch")
        torch.cuda.synchronize()
        err = max([float((g - g_p).abs().max())]
                  + [float((aux[n] - aux_p[n]).abs().max())
                     for n in ("mean_prob", "frac_tokens")])
        if not torch.equal(i, i_p) or not err <= 1e-6:
            raise AssertionError(f"moe_router {label}: ids equal "
                                 f"{torch.equal(i, i_p)}, max err {err}")
        if label not in ("prefill", "decode"):
            say("kernel", f"moe_router on logits {label} ({t}x{e}, k={k}): "
                f"ids bit-equal, gates and stats max abs err {err:.3g}")
            continue
        blocks = -(-t // BLOCK_TOKENS)
        outs = (torch.empty_like(g), torch.empty_like(i),
                torch.empty(blocks, 2, e, device=DEVICE))
        ms = cuda_time_ms(lambda: launch(x, *outs, top_k=k, renormalize=True),
                          TIMED_LAUNCHES)
        op_ms = cuda_time_ms(lambda: route_topk(x, top_k=k), TIMED_LAUNCHES)
        plain_ms = cuda_time_ms(lambda: route_topk(x, top_k=k, mode="torch"),
                                20)
        # the kernel's per-block partials are its own, not the function's
        bound_ms, by, moved, _ = bound(W.route_topk(
            t, e, k, itemsize=x.element_size()))
        say("kernel", f"moe_router on logits {label} ({t}x{e}, k={k}): ids "
            f"bit-equal, "
            f"gates and stats max abs err {err:.3g}; kernel {ms * 1e3:.1f} "
            f"us (the op, with the blocks' statistics summed, "
            f"{op_ms * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.2f} "
            f"us ({moved:.2f} MB by {by}), {bound_ms / ms:.1%} of "
            f"bound")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by, library_ms=None)
    return out


def router_inputs(t, d, e, dtype, gen, zero_rows=False, tied=False):
    """Tokens x (t, d) in ``dtype`` and a float32 router weight w (d, e)
    at the model's scale (1 / sqrt(d)). With ``zero_rows`` every 7th row
    of x is 0 (all its logits exactly 0); with ``tied`` experts e - 2 and
    e - 1 copy experts 1 and 0 (exactly tied logits)."""
    import torch

    x = torch.randn(t, d, device=DEVICE, generator=gen).to(dtype)
    w = torch.randn(d, e, device=DEVICE, generator=gen) / math.sqrt(d)
    if zero_rows:
        x[::7] = 0
    if tied:
        w[:, e - 2] = w[:, 1]
        w[:, e - 1] = w[:, 0]
    return x, w


def fused_errors(x, w, k, gs, got, want):
    """Hold the fused router's outputs ``got`` (gates, idx, pos, aux)
    against the plain version's ``want`` on the same x, w. A token's ids
    equal the plain ones but where the plain run's probabilities nearly
    tie: a changed set only where its k-th and (k+1)-th lie within
    FLIP_GAP, a changed order only where two of its top k do; zero rows
    take ids 0..k-1 exactly; pos equals positions_ref of the kernel's own
    ids; gates of agreeing tokens and mean_prob within ROUTER_TOL;
    frac_tokens is the count of the kernel's own ids. Returns (max abs
    error, tokens whose ids differ); raises on a failure."""
    import torch

    from repro_torch.kernels.moe_router import positions_ref

    g, i, p, aux = got
    g_p, i_p, _, aux_p = want
    t, e = x.shape[0], w.shape[1]
    zero = (x == 0).all(1)
    first = torch.arange(k, device=x.device, dtype=i.dtype)
    if not (bool((i[zero] == first).all()) and bool((i_p[zero] == first)
                                                    .all())):
        raise AssertionError("a zero row's ids are not 0..k-1")
    same = (i == i_p).all(1)
    new_set = (i.sort(1).values != i_p.sort(1).values).any(1)
    top = torch.softmax(x.float() @ w, dim=-1).sort(1, descending=True) \
        .values
    inf = torch.full((t,), math.inf, device=x.device)
    k_gap = top[:, k - 1] - top[:, k] if k < e else inf
    in_gap = (top[:, :k - 1] - top[:, 1:k]).amin(1) if k > 1 else inf
    off_tie = (new_set & (k_gap > FLIP_GAP)) \
        | (~same & ~new_set & (in_gap > FLIP_GAP))
    if bool(off_tie.any()):
        raise AssertionError(f"ids differ off a tie at tokens "
                             f"{off_tie.nonzero()[:8, 0].tolist()}")
    if not torch.equal(p, positions_ref(i, gs, e)):
        raise AssertionError("pos is not positions_ref of the kernel's ids")
    counts = torch.nn.functional.one_hot(i.long(), e).sum((0, 1)).float()
    errs = [float((aux["mean_prob"] - aux_p["mean_prob"]).abs().max()),
            float((aux["frac_tokens"] - counts / (t * k)).abs().max())]
    if bool(same.any()):
        errs.append(float((g - g_p)[same].abs().max()))
    if not max(errs) <= ROUTER_TOL:
        raise AssertionError(f"gates or statistics off by {max(errs)}")
    return max(errs), int((~same).sum())


def f64_error(x, w, gates, idx):
    """Largest relative error of ``gates`` (k = E, not renormalised: each
    the probability of its own id) against the float64 route's
    probabilities of the same ids on the same x and w."""
    import torch

    want = torch.softmax(x.double() @ w.double(), -1).gather(1, idx.long())
    return float(((gates.double() - want).abs() / want).max())


def router_chain(x, w, k, gs):
    """The ops the fused router replaces, as models/moe.py ran them on the
    card: the f32 router product (cuBLAS), the moe_router kernel on its
    logits with the blocks' statistics summed, and the positions' one-hot
    cumsum over the (groups, group * k, E) selection."""
    from repro_torch.kernels.moe_router import positions_ref, route_topk

    logits = x.float() @ w
    g, i, aux = route_topk(logits, top_k=k)
    return g, i, positions_ref(i, gs, w.shape[1]), aux


# (label, t, d, E, k, group, x type, zero rows, tied experts, timed)
FUSED_CASES = (
    ("prefill", LLM_BATCH * LLM_PROMPT, 2048, 64, 6, LLM_GROUP, "bfloat16",
     False, False, True),
    ("decode", LLM_BATCH, 2048, 64, 6, LLM_BATCH, "bfloat16", False, False,
     True),
    # Jamba's MoE: d 8,192, 16 experts, top-2; the split form's cluster of
    # 16 CTAs spans 8 chunks of 64 values of d each
    ("jamba prefill", LLM_BATCH * LLM_PROMPT, 8192, 16, 2, LLM_GROUP,
     "bfloat16", False, False, True),
    ("jamba decode", LLM_BATCH, 8192, 16, 2, LLM_BATCH, "bfloat16", False,
     False, True),
    ("zero rows, tied experts", 512, 2048, 64, 6, 128, "bfloat16", True,
     True, False),
    ("k=1, tied", LLM_BATCH * LLM_PROMPT, 2048, 64, 1, LLM_GROUP,
     "bfloat16", True, True, False),
    ("ragged, groups of 16", 70, 256, 16, 2, 16, "float32", True, True,
     False),
    ("a padded group", 1000, 2048, 4, 1, LLM_GROUP, "float32", True, False,
     False),
    ("one token", 1, 2048, 64, 6, 1, "float32", False, False, False),
)


def phase_fused_router_check():
    """The fused router op (route_tokens) against its plain version under
    :func:`fused_errors`, at deepseek's and Jamba's prefill and decode
    (timed) and at ragged, padded, tied and f32 cases; then its product's
    accuracy at deepseek's prefill shape in bf16 and f32 against a float64
    route (:func:`f64_error`, within PROB_REL_TOL). Returns {label:
    numbers}."""
    import torch

    from repro_torch.kernels.moe_router import plan, route_tokens
    from repro_torch.kernels.moe_router.ops import launch_fused
    from repro_torch.models.moe import _capacity
    from repro_torch.roofline import kernels as W

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    floor, floor_clean = timing_floor()
    say("kernel", f"timing floor (one add on 16 bytes): {floor * 1e3:.1f} "
        f"us, clean {floor_clean * 1e3:.1f} us")
    out = {}
    for label, t, d, e, k, gs, dt, zero, tied, timed in FUSED_CASES:
        dtype = getattr(torch, dt)
        x, w = router_inputs(t, d, e, dtype, gen, zero, tied)
        form = plan(x, w, top_k=k, group_size=gs)
        got = route_tokens(x, w, top_k=k, group_size=gs)
        want = route_tokens(x, w, top_k=k, group_size=gs, mode="torch")
        torch.cuda.synchronize()
        err, flips = fused_errors(x, w, k, gs, got, want)
        cap = _capacity(gs, e, k, 1.25)
        kept = float((got[2] < cap).float().mean())
        tag = (f"moe_router fused {label} ({t}x{d} {dt}, E {e}, k {k}, "
               f"group {gs}): {form['form']}, {form['clusters']} cluster(s) "
               f"of {form['cluster']} CTAs over {form['block_tokens']}-token "
               f"tiles; ids agree but {flips} at ties, pos == positions_ref "
               f"of its ids ({kept:.1%} under cap {cap}), gates and stats "
               f"max abs err {err:.3g}")
        if not timed:
            say("kernel", tag)
            continue
        outs = (torch.empty_like(got[0]), torch.empty_like(got[1]),
                torch.empty_like(got[2]),
                torch.empty((2, e), device=DEVICE))
        fn = (lambda: launch_fused(x, w, *outs, top_k=k, renormalize=True,
                                   group_size=gs, form=form))
        ms = cuda_time_ms(fn, TIMED_LAUNCHES)
        clean = cuda_time_ms(fn, TIMED_LAUNCHES, clean=True)
        op_ms = cuda_time_ms(lambda: route_tokens(x, w, top_k=k,
                                                  group_size=gs),
                             TIMED_LAUNCHES)
        chain_ms = cuda_time_ms(lambda: router_chain(x, w, k, gs),
                                TIMED_LAUNCHES)
        plain_ms = cuda_time_ms(lambda: route_tokens(
            x, w, top_k=k, group_size=gs, mode="torch"), 20)
        work = W.moe_router(t, d, e, k, x_itemsize=dtype.itemsize)
        bound_ms, by, mb, _ = bound(work)
        # the f32 product as two TF32 products, or once on CUDA cores
        tc_ms, f32_ms = work.ops_s * 1e3, work.at("f32") * 1e3
        say("kernel", tag)
        say("kernel", f"moe_router fused {label}: kernel {ms * 1e3:.1f} us "
            f"L2-cold, {clean * 1e3:.1f} us clean (the op with its "
            f"allocations {op_ms * 1e3:.1f} us); the chain it replaces "
            f"(f32 product, the logits kernel + sum, the positions' cumsum) "
            f"{chain_ms * 1e3:.1f} us; plain {plain_ms * 1e3:.1f} us; bound "
            f"{bound_ms * 1e3:.2f} us ({mb:.2f} MB by {by}; TF32 floor "
            f"{tc_ms * 1e3:.2f} us, CUDA-core floor {f32_ms * 1e3:.2f} us), "
            f"{bound_ms / ms:.1%} of bound")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by, library_ms=None,
                          clean_ms=clean, chain_ms=chain_ms)
    t, d, e = LLM_BATCH * LLM_PROMPT, 2048, 64
    for dt in ("bfloat16", "float32"):
        x, w = router_inputs(t, d, e, getattr(torch, dt), gen)
        errs = [f64_error(x, w, *route_tokens(
            x, w, top_k=e, renormalize=False, group_size=LLM_GROUP,
            mode=m)[:2]) for m in (None, "torch")]
        if not errs[0] <= PROB_REL_TOL:
            raise AssertionError(f"moe_router fused {dt}: probabilities "
                                 f"off the float64 route by {errs[0]:.3g}, "
                                 f"relative (limit {PROB_REL_TOL})")
        say("kernel", f"moe_router fused product accuracy ({t}x{d} {dt}, "
            f"k = E = {e}, not renormalised): probabilities within "
            f"{errs[0]:.3g} of the float64 route's, relative (limit "
            f"{PROB_REL_TOL}); cuBLAS's f32 product {errs[1]:.3g}")
        out["prefill"][f"f64_rel_err_{dt}"] = errs[0]
    return out


def wkv_inputs(b, t, h, n, dtype, gen, state=True, decays="model",
               w_dtype=None):
    """r, k, v (b, t, h, n) in ``dtype``; w float32 (or ``w_dtype``) in
    [0, 1]: around the model's decay (exp(-exp(x)), x ~ N(-3, 1)), or
    ``decays="strong"``: x ~ N(0, 2) with entries of w exactly 0 and
    exactly 1; u (h, n) float32; a nonzero float32 state (b, h, n, n), or
    None."""
    import torch

    def normal(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=DEVICE, generator=gen)

    r, k, v = (normal(b, t, h, n, scale=0.3).to(dtype) for _ in range(3))
    if decays == "strong":
        w = torch.exp(-torch.exp(normal(b, t, h, n, scale=2.0)))
        w[..., ::7] = 0.0
        w[:, 3::5, :, 1::6] = 1.0
    else:
        w = torch.exp(-torch.exp(normal(b, t, h, n) - 3.0))
    u = normal(h, n, scale=0.1)
    return (r, k, v, w.to(w_dtype or torch.float32), u,
            normal(b, h, n, n) if state else None)


def wkv_errors(got, want):
    """(max |out diff|, max |state diff|, within tolerance, the tolerance
    in words): f32 outputs within 1e-5 of the plain output's scale (the
    sum over keys in another order); a bf16 output within one bf16
    rounding, 2^-7 of the value, plus that; the float32 state within
    1e-5 of its scale."""
    import torch

    (o, s), (o_p, s_p) = got, want
    eo = (o.float() - o_p.float()).abs()
    es = (s - s_p).abs()
    rel = 2.0 ** -7 if o.dtype == torch.bfloat16 else 0.0
    ok = bool((eo <= rel * o_p.float().abs()
               + 1e-5 * float(o_p.float().abs().max())).all()) and \
        float(es.max()) <= 1e-5 * float(s_p.abs().max())
    tol = ("out within 2^-7 of each value + 1e-5 of the scale (one bf16 "
           "rounding)" if rel else "out within 1e-5 of the scale") \
        + ", state within 1e-5 of its scale"
    return float(eo.max()), float(es.max()), ok, tol


def timing_floor():
    """(L2-cold ms, clean-L2 ms) of one PyTorch elementwise add on 4 floats
    (16 bytes) under :func:`cuda_time_ms`: what the timing itself costs a
    kernel that moves next to nothing."""
    import torch

    x = torch.zeros(4, device=DEVICE)
    return (cuda_time_ms(lambda: x.add_(1.0), TIMED_LAUNCHES),
            cuda_time_ms(lambda: x.add_(1.0), TIMED_LAUNCHES, clean=True))


def phase_rwkv_check():
    """rwkv6_scan against its plain version: the rwkv6-7b serving shapes
    (timed: the prefill on ``chunked`` and, on the same tensors, on
    ``simt``; the decode on ``simt``; each L2-cold and with a clean L2,
    beside the timing floor), the chunked kernel's edge cases and the
    small f32 cases (untimed), the state written in place, and a state
    carried across a split on each variant. Returns {label: numbers}."""
    import torch

    from repro_torch.kernels.rwkv6_scan import plan, wkv
    from repro_torch.kernels.rwkv6_scan.ops import launch
    from repro_torch.roofline import kernels as W

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    b, p = LLM_BATCH, LLM_PROMPT
    floor_ms, floor_clean = timing_floor()
    say("kernel", f"timing floor: one elementwise add on 16 bytes "
        f"{floor_ms * 1e3:.1f} us L2-cold, {floor_clean * 1e3:.1f} us with "
        f"a clean L2 (cuda_time_ms)")
    # (label, b, t, h, n, r/k/v dtype, given state, decays, w dtype, timed)
    cases = [("prefill", b, p, 64, 64, bf16, True, "model", f32, 10),
             ("decode", b, 1, 64, 64, bf16, True, "model", f32,
              TIMED_LAUNCHES),
             ("t 16", 2, 16, 4, 64, bf16, True, "model", f32, 0),
             ("t 17", 2, 17, 4, 64, bf16, True, "model", f32, 0),
             ("t 33", 2, 33, 4, 64, bf16, True, "model", f32, 0),
             ("t 130", 2, 130, 4, 64, bf16, True, "model", f32, 0),
             ("bf16 w", 2, 130, 4, 64, bf16, True, "model", bf16, 0),
             ("strong decays, w 0 and 1", 2, 130, 4, 64, bf16, True,
              "strong", f32, 0),
             ("n 16 t 33", 2, 33, 3, 16, f32, False, "model", f32, 0),
             ("n 16 t 130", 2, 130, 3, 16, f32, False, "model", f32, 0),
             ("n 32 t 33", 2, 33, 3, 32, f32, False, "model", f32, 0),
             ("n 32 t 130", 2, 130, 3, 32, f32, False, "model", f32, 0),
             ("n 64 t 130 bf16", 2, 130, 4, 64, bf16, False, "model", f32,
              0)]
    out = {}
    for label, b_, t, h, n, dt, state, decays, wdt, iters in cases:
        r, k, v, w, u, s0 = wkv_inputs(b_, t, h, n, dt, gen, state, decays,
                                       wdt)
        variant = plan(r, k, v, w, s0)
        got = wkv(r, k, v, w, u, s0)
        want = wkv(r, k, v, w, u, s0, mode="torch")
        torch.cuda.synchronize()
        eo, es, ok, tol = wkv_errors(got, want)
        shape = f"({b_}, {t}, {h}, {n}) {str(dt).split('.')[-1]}/" \
            f"{str(wdt).split('.')[-1].replace('float', 'f')} w, " \
            + ("a given state" if state else "state None")
        if not ok:
            raise AssertionError(f"rwkv6_scan {label} {shape} [{variant}]: "
                                 f"kernel and plain version differ (out "
                                 f"{eo}, state {es}; tol: {tol})")
        if not iters:
            say("kernel", f"rwkv6_scan {label} {shape} [{variant}]: max abs "
                f"err out {eo:.3g}, state {es:.3g} (tol: {tol})")
            continue
        o, so = torch.empty_like(got[0]), torch.empty_like(got[1])
        ms = cuda_time_ms(lambda: wkv(r, k, v, w, u, s0), iters)
        clean_ms = cuda_time_ms(lambda: wkv(r, k, v, w, u, s0), iters,
                                clean=True)
        plain_ms = cuda_time_ms(lambda: wkv(r, k, v, w, u, s0, mode="torch"),
                                3 if t > 1 else 20)
        work = W.rwkv6_scan(b_, t, h, n, itemsize=dt.itemsize, state=state)
        bound_ms, by, mb, _ = bound(work)
        cc_ms = work.at("f32") * 1e3
        simt = ""
        if variant != "simt":
            launch(r, k, v, w, u, s0, o, so, variant="simt")
            simt_ms = cuda_time_ms(lambda: launch(r, k, v, w, u, s0, o, so,
                                                  variant="simt"), iters)
            simt_clean = cuda_time_ms(lambda: launch(r, k, v, w, u, s0, o,
                                                     so, variant="simt"),
                                      iters, clean=True)
            simt = (f"; simt on the same tensors {simt_ms * 1e3:.1f} us "
                    f"({simt_ms / ms:.2f}x the {variant} kernel's time), "
                    f"clean L2 {simt_clean * 1e3:.1f} us")
        say("kernel", f"rwkv6_scan rwkv6-7b {label} {shape} [{variant}]: max "
            f"abs err out {eo:.3g}, state {es:.3g} (state relative "
            f"{es / float(want[1].abs().max()):.2g}; tol: {tol}); kernel "
            f"{ms * 1e3:.1f} us L2-cold, {clean_ms * 1e3:.1f} us clean L2 "
            f"(timing floor {floor_ms * 1e3:.1f} / {floor_clean * 1e3:.1f} "
            f"us); plain {plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.1f}"
            f" us ({mb:.1f} MB, by {by}), {bound_ms / ms:.1%} of bound; the "
            f"sequential form's CUDA-core floor {cc_ms * 1e3:.1f} us" + simt
            + "; no library call")
        out[label] = dict(max_abs_err=eo, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by, library_ms=None)
    # the state written in place into the cache it was read from
    r, k, v, w, u, s0 = wkv_inputs(2, 130, 4, 64, bf16, gen)
    want = wkv(r, k, v, w, u, s0, mode="torch")
    cache = s0.clone()
    got = wkv(r, k, v, w, u, cache, out_state=cache)
    torch.cuda.synchronize()
    eo, es, ok, _ = wkv_errors(got, want)
    say("kernel", f"rwkv6_scan state written in place ((2, 130, 4, 64) bf16 "
        f"[{plan(r, k, v, w, cache)}]): max abs err out {eo:.3g}, state "
        f"{es:.3g}")
    if not ok or got[1] is not cache:
        raise AssertionError("rwkv6_scan: the state written in place "
                             "differs")
    # a state carried across a split equals one scan, on each variant
    for dt in (f32, bf16):
        r, k, v, w, u, s0 = wkv_inputs(2, 130, 4, 64, dt, gen)
        whole = wkv(r, k, v, w, u, s0)
        o1, s1 = wkv(*(x[:, :17] for x in (r, k, v, w)), u, s0)
        o2, s2 = wkv(*(x[:, 17:] for x in (r, k, v, w)), u, s1)
        torch.cuda.synchronize()
        eo, es, ok, _ = wkv_errors((torch.cat([o1, o2], 1), s2), whole)
        variants = [plan(*(x[:, sl] for x in (r, k, v, w)), s0)
                    for sl in (slice(None), slice(0, 17), slice(17, None))]
        say("kernel", f"rwkv6_scan state carried across a split (17 + 113 of "
            f"(2, 130, 4, 64) {str(dt).split('.')[-1]}, {variants}) vs one "
            f"scan: max abs err out {eo:.3g}, state {es:.3g}")
        if not ok:
            raise AssertionError("rwkv6_scan: a carried state differs")
    return out


def llm_prompts(vocab, prompt_len=LLM_PROMPT):
    """The serving path's token prompts: (4, prompt_len) int32 from seed
    1."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    return torch.randint(0, vocab, (LLM_BATCH, prompt_len), device=DEVICE,
                         generator=gen, dtype=torch.int32)


def whisper_prompts(cfg, dtype):
    """Whisper's serving prompts: (4, 64) decoder tokens from seed 1 and
    (4, 1500, d) frame embeddings * 0.2 in ``dtype`` from seed 3 (the
    frontend stub's output)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    frames = torch.randn(LLM_BATCH, cfg.encoder_seq_len, cfg.d_model,
                         device=DEVICE, generator=gen) * 0.2
    return {"tokens": llm_prompts(cfg.vocab_size, WHISPER_PROMPT),
            "enc_frames": frames.to(dtype)}


def vlm_positions():
    """Qwen2-VL's M-RoPE positions of an image prompt, (1024, 3) int32: 64
    text rows at (i, i, i), a 28 x 32 patch grid at (64, 64 + row, 64 +
    col), 64 text rows resuming at the grid's largest position + 1."""
    import torch

    rows, cols = VLM_GRID
    text = torch.arange(VLM_TEXT, device=DEVICE)
    r, c = torch.meshgrid(torch.arange(rows, device=DEVICE),
                          torch.arange(cols, device=DEVICE), indexing="ij")
    grid = torch.stack([torch.zeros_like(r), r, c], -1).reshape(-1, 3) \
        + VLM_TEXT
    after = text + int(grid.max()) + 1
    return torch.cat([text[:, None].expand(-1, 3), grid,
                      after[:, None].expand(-1, 3)]).to(torch.int32)


def prompt_len(batch):
    """The prompt's length: that of its tokens, else of its embeddings
    (as ``ServeEngine.generate`` takes it)."""
    return (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]


def vlm_prompts(cfg, dtype):
    """Qwen2-VL's serving prompts: (4, 1024, d) patch and text embeddings
    * 0.2 in ``dtype`` from seed 1 (the vision frontend stub's output),
    with :func:`vlm_positions`."""
    import torch

    pos = vlm_positions()
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    embeds = torch.randn(LLM_BATCH, len(pos), cfg.d_model, device=DEVICE,
                         generator=gen) * 0.2
    return {"embeds": embeds.to(dtype),
            "mrope_positions": pos[None].expand(LLM_BATCH, -1, -1)}


def counted_generate(cfg, params, prompts, max_len=LLM_MAX_LEN):
    """``ServeEngine(max_len, cache_dtype=bf16).generate`` of the batch
    ``prompts``: a warm-up generate of 2 tokens, then the counted one of
    ``LLM_NEW`` with every launch count set to 0 just before and read just
    after. Checks the tokens ((b, new) int32 in the vocabulary) and that
    every step's logits are finite; prints the step times. Returns the
    launches."""
    import torch

    from repro_torch.kernels import mamba_scan, moe_router, rwkv6_scan
    from repro_torch.kernels.flash_attention import VARIANTS, reset_variants
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import engine as engine_mod

    engine = ServeEngine(cfg=cfg, params=params, max_len=max_len,
                         cache_dtype=torch.bfloat16, device=DEVICE)
    steps = {"prefill": [], "decode": []}
    finite = []

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            steps[key].append(time.perf_counter() - t1)
            return res
        return run

    def checked_greedy(logits, gen=None):
        finite.append(torch.isfinite(logits).all())
        return greedy(logits)

    greedy = engine_mod.sampler_lib.greedy
    engine._prefill = timed(engine._prefill, "prefill")
    engine._decode = timed(engine._decode, "decode")
    engine_mod.sampler_lib.greedy = checked_greedy
    try:
        engine.generate(prompts, max_new_tokens=2)           # warm-up
        torch.cuda.synchronize()
        for v in steps.values():
            v.clear()
        finite.clear()
        reset_launches()
        reset_variants()
        rwkv6_scan.reset_variants()
        moe_router.reset_variants()
        mamba_scan.reset_variants()
        t0 = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=LLM_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c for k, c in LAUNCHES.items() if c}
    finally:
        engine_mod.sampler_lib.greedy = greedy
    if out.shape != (LLM_BATCH, LLM_NEW) or out.dtype != torch.int32:
        raise AssertionError(f"tokens {tuple(out.shape)} {out.dtype}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError("token ids outside the vocabulary")
    if len(finite) != LLM_NEW or not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits")
    dec = sorted(steps["decode"])
    med, p95 = dec[len(dec) // 2], dec[min(len(dec) - 1,
                                           math.ceil(0.95 * len(dec)) - 1)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = cfg.name
    what = ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype).split('.')[-1]}"
                     for k, v in prompts.items())
    say("llm", f"{tag} generate: {what}; {LLM_NEW} new (greedy), cache bf16 "
        f"x {max_len}; launches "
        f"{launches}; flash_attention variants "
        f"{ {k: c for k, c in VARIANTS.items() if c} }; moe_router variants "
        f"{ {k: c for k, c in moe_router.VARIANTS.items() if c} }; "
        f"rwkv6_scan variants "
        f"{ {k: c for k, c in rwkv6_scan.VARIANTS.items() if c} }; tokens "
        f"{out[0].tolist()}...")
    say("llm", f"{tag} prefill {steps['prefill'][0] * 1e3:.1f} ms; decode "
        f"per step median {med * 1e3:.2f} ms, p95 {p95 * 1e3:.2f} ms over "
        f"{len(dec)} steps (host clock, each from a synchronized card to a "
        f"synchronized card)")
    say("llm", f"{tag} generate {wall:.3f} s: {LLM_BATCH * LLM_NEW / wall:.1f}"
        f" new tokens/s end to end; decode {LLM_BATCH / med:.1f} tokens/s "
        f"at the median step; peak device memory {peak:.2f} GiB")
    return launches


def release():
    """Free the card's memory of a phase (its tensors already dropped)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_llm_serving():
    """deepseek-moe-16b at its published widths, bf16, through
    ``ServeEngine.generate`` (:func:`counted_generate`): flash_attention
    and moe_router once per layer and step each. Returns its launches."""
    import torch

    from repro_torch.configs import get_config, param_count
    from repro_torch.kernels import moe_router
    from repro_torch.models import model as M

    cfg = get_config(LLM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = M.init_params(gen, cfg, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    say("llm", f"{LLM_ARCH}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.moe.num_experts} routed + "
        f"{cfg.moe.num_shared_experts} shared experts (top "
        f"{cfg.moe.top_k}, d_ff {cfg.moe.expert_d_ff}), vocab "
        f"{cfg.vocab_size}: {n / 1e9:.3f} B parameters in bf16 "
        f"(param_count {param_count(cfg) / 1e9:.3f} B), drawn on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    # param_count leaves out the final norm and the vocabulary's padding
    pad = (M.padded_vocab(cfg) - cfg.vocab_size) * cfg.d_model * 2
    if n != param_count(cfg) + cfg.d_model + pad:
        raise AssertionError(f"{n} parameters, param_count {param_count(cfg)}")
    from repro_torch.kernels.flash_attention import VARIANTS

    launches = counted_generate(cfg, params,
                                {"tokens": llm_prompts(cfg.vocab_size)})
    per = LLM_NEW * cfg.num_layers
    check_launches(launches, {"flash_attention": per, "moe_router": per},
                   f"{LLM_ARCH} generate")
    # bf16 cache, 1,024-token prompts: the prefill on the tensor cores, every
    # decode step split over the cache
    want = {"wgmma": cfg.num_layers, "split_kv": per - cfg.num_layers}
    ran = {k: c for k, c in VARIANTS.items() if c}
    if ran != want:
        raise AssertionError(f"{LLM_ARCH} generate: flash_attention variants "
                             f"{ran}, expected {want}")
    # every MoE layer routes through the fused kernel, never the logits one
    if moe_router.VARIANTS != {"fused": per, "logits": 0}:
        raise AssertionError(f"{LLM_ARCH} generate: moe_router variants "
                             f"{moe_router.VARIANTS}, expected fused {per}")
    del params
    release()
    return launches


def phase_rwkv_serving():
    """rwkv6-7b at its published widths, bf16 (the decay_w0 and bonus_u
    leaves float32), through ``ServeEngine.generate``
    (:func:`counted_generate`): rwkv6_scan once per layer and step.
    Returns its launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(RWKV_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = M.init_params(gen, cfg, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    tm = params["blocks"]["pos0"]["tm"]
    say("llm", f"{RWKV_ARCH}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} WKV heads of {cfg.rwkv_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n:,} parameters "
        f"({nbytes / 1e9:.2f} GB; decay_w0 {tm['decay_w0'].dtype}, bonus_u "
        f"{tm['bonus_u'].dtype}, the rest bf16), drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    if n != RWKV_PARAMS:
        raise AssertionError(f"{n} parameters, the reference's tree has "
                             f"{RWKV_PARAMS}")
    leaves = [t for t in _leaves(params)
              if t is not tm["decay_w0"] and t is not tm["bonus_u"]]
    if tm["decay_w0"].dtype != torch.float32 or \
            tm["bonus_u"].dtype != torch.float32 or \
            any(t.dtype != torch.bfloat16 for t in leaves):
        raise AssertionError("rwkv6-7b leaves in the wrong dtypes")
    cache = M.init_cache(cfg, LLM_BATCH, LLM_MAX_LEN, dtype=torch.bfloat16,
                         device=DEVICE)["layers"]["pos0"]
    say("llm", f"{RWKV_ARCH} recurrent cache per generate: wkv state "
        f"{cache['wkv'].numel() * 4 / 1e6:.1f} MB float32, token shifts "
        f"{2 * cache['tm_last'].numel() * 2 / 1e6:.1f} MB bf16 (whatever "
        f"max_len)")
    del cache
    from repro_torch.kernels.rwkv6_scan import VARIANTS

    launches = counted_generate(cfg, params,
                                {"tokens": llm_prompts(cfg.vocab_size)})
    check_launches(launches, {"rwkv6_scan": LLM_NEW * cfg.num_layers},
                   f"{RWKV_ARCH} generate")
    # bf16 activations: the 1,024-token prefill on the chunked tensor-core
    # scan, every decode step on the sequential one
    want = {"chunked": cfg.num_layers,
            "simt": (LLM_NEW - 1) * cfg.num_layers}
    if VARIANTS != want:
        raise AssertionError(f"{RWKV_ARCH} generate: rwkv6_scan variants "
                             f"{VARIANTS}, expected {want}")
    del params, tm, leaves
    release()
    return launches


def draw_full_width(arch, want, **cut):
    """``arch`` at its published widths in bf16 (its config with ``cut``
    replaced, e.g. fewer layers), drawn on the card from seed 0, its
    parameter count checked against the reference's tree's (``want``).
    Returns (cfg, params)."""
    import torch

    from repro_torch.configs import get_config, param_count
    from repro_torch.models import model as M

    cfg = get_config(arch).replace(**cut)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = M.init_params(gen, cfg, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    enc = (f"; encoder {cfg.encoder_layers} layers over "
           f"{cfg.encoder_seq_len} frames, "
           f"{sum(t.numel() for t in _leaves(params['encoder'])):,} "
           f"parameters" if cfg.is_encoder_decoder else "")
    say("llm", f"{arch}: {cfg.num_layers} decoder layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} q-heads on {cfg.num_kv_heads} "
        f"kv-heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} (padded {M.padded_vocab(cfg)}){enc}: {n:,} "
        f"parameters in bf16 (param_count {param_count(cfg):,}), drawn on "
        f"the card in {time.perf_counter() - t0:.3f} s")
    if n != want:
        raise AssertionError(f"{arch}: {n} parameters, the reference's tree "
                             f"has {want}")
    return cfg, params


def check_attention_variants(arch, launches, wgmma, split_kv):
    """flash_attention launched exactly ``wgmma`` + ``split_kv`` times in
    the counted generate, with exactly those variants, and no other
    kernel."""
    from repro_torch.kernels.flash_attention import VARIANTS

    check_launches(launches, {"flash_attention": wgmma + split_kv},
                   f"{arch} generate")
    ran = {k: c for k, c in VARIANTS.items() if c}
    if ran != {"wgmma": wgmma, "split_kv": split_kv}:
        raise AssertionError(f"{arch} generate: flash_attention variants "
                             f"{ran}, expected wgmma {wgmma}, split_kv "
                             f"{split_kv}")


def phase_whisper_serving():
    """whisper-small at its published widths, bf16, through
    ``ServeEngine.generate`` (:func:`counted_generate`) of 4 prompts of 64
    tokens over 1,500 frame embeddings, a cache of 80 slots: the prefill
    runs the encoder (non-causal) and each decoder layer's causal self-
    and non-causal cross-attention on wgmma; each decode step each
    layer's self-attention and its cross-attention over the cached cross
    K/V on split_kv. Returns its launches."""
    import torch

    cfg, params = draw_full_width(WHISPER_ARCH, WHISPER_PARAMS)
    launches = counted_generate(cfg, params,
                                whisper_prompts(cfg, torch.bfloat16),
                                WHISPER_MAX_LEN)
    n = cfg.num_layers
    check_attention_variants(WHISPER_ARCH, launches,
                             cfg.encoder_layers + 2 * n,
                             (LLM_NEW - 1) * 2 * n)
    del params
    release()
    return launches


def phase_vlm_serving():
    """qwen2-vl-2b at its published widths, bf16, through
    ``ServeEngine.generate`` (:func:`counted_generate`) of 4 prompts of
    1,024 embeddings at an image prompt's M-RoPE positions
    (:func:`vlm_positions`), a cache of 1,040 slots: GQA 12:2 at head_dim
    128, the prefill on wgmma and every decode step (the token at M-RoPE
    position prompt_len + i in all three components) on split_kv. Returns
    its launches."""
    import torch

    cfg, params = draw_full_width(VLM_ARCH, VLM_PARAMS)
    launches = counted_generate(cfg, params, vlm_prompts(cfg, torch.bfloat16))
    n = cfg.num_layers
    check_attention_variants(VLM_ARCH, launches, n, (LLM_NEW - 1) * n)
    del params
    release()
    return launches


def phase_phi3_serving():
    """phi3-mini-3.8b at its published widths, bf16 (32 layers, d_model
    3,072, 32 heads of 96, d_ff 8,192, vocab 32,064; the reference tree's
    3,821,079,552 parameters, param_count's plus the final norm), through
    ``ServeEngine.generate`` (:func:`counted_generate`) of 4 prompts of
    1,024 tokens, a cache of 1,040 slots: every layer's prefill attention
    on wgmma and every decode step's on split_kv, both at head_dim 96, no
    simt. Returns its launches."""
    from repro_torch.configs import param_count
    from repro_torch.models import model as M

    cfg, params = draw_full_width(TRAIN_ARCH, TRAIN_PARAMS)
    pad = (M.padded_vocab(cfg) - cfg.vocab_size) * cfg.d_model * 2
    if TRAIN_PARAMS != param_count(cfg) + cfg.d_model + pad:
        raise AssertionError(f"{TRAIN_ARCH}: {TRAIN_PARAMS} parameters, "
                             f"param_count {param_count(cfg)}")
    launches = counted_generate(cfg, params,
                                {"tokens": llm_prompts(cfg.vocab_size)})
    n = cfg.num_layers
    check_attention_variants(TRAIN_ARCH, launches, n, (LLM_NEW - 1) * n)
    del params
    release()
    return launches


def phase_jamba_serving():
    """jamba-1.5-large-398b cut to its first 5 layers at every published
    width, bf16 (A_log, D, dt_bias and the router float32), through
    ``ServeEngine.generate`` (:func:`counted_generate`) of 4 prompts of
    1,024 tokens, a cache of 1,040 slots: the attention layer on
    flash_attention (GQA 64:8 at head_dim 128; the prefill on wgmma, each
    decode step on split_kv), each of the 2 MoE layers on the fused router
    (the prefill's 4,096 tokens in the tile form, each decode step's 4 in
    the split form), each of the 4 Mamba mixers' prefill scan on
    mamba_scan (a decode step's recurrence step is torch ops). Then the
    kernels launched by one prefill and by one decode step. Returns its
    launches."""
    import torch

    from repro_torch.kernels import moe_router
    from repro_torch.models import model as M
    from repro_torch.models.transformer import block_pattern

    cfg, params = draw_full_width(JAMBA_ARCH, JAMBA_PARAMS, **JAMBA_CUT)
    tree = params["blocks"]
    f32 = sorted({k for pos in tree.values() for sub in pos.values()
                  if isinstance(sub, dict) for k, t in sub.items()
                  if isinstance(t, torch.Tensor) and t.dtype == torch.float32})
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    say("llm", f"{JAMBA_ARCH} cut to {cfg.num_layers} of 72 layers, block "
        f"pattern {block_pattern(cfg)[1]}: {nbytes / 1e9:.2f} "
        f"GB; float32 leaves {f32}, the rest bf16")
    if f32 != ["A_log", "D", "dt_bias", "router"]:
        raise AssertionError(f"{JAMBA_ARCH}: float32 leaves {f32}")
    prompts = {"tokens": llm_prompts(cfg.vocab_size)}
    launches = counted_generate(cfg, params, prompts)
    n_attn = cfg.layer_kinds().count("attn")
    n_moe = sum(cfg.moe_layer_mask())
    n_mamba = cfg.layer_kinds().count("mamba")
    check_launches(launches, {"flash_attention": LLM_NEW * n_attn,
                              "moe_router": LLM_NEW * n_moe,
                              "mamba_scan": n_mamba},
                   f"{JAMBA_ARCH} generate")
    from repro_torch.kernels.flash_attention import VARIANTS

    want = {"wgmma": n_attn, "split_kv": (LLM_NEW - 1) * n_attn}
    if {k: c for k, c in VARIANTS.items() if c} != want:
        raise AssertionError(f"{JAMBA_ARCH} generate: flash_attention "
                             f"variants {VARIANTS}, expected {want}")
    if moe_router.VARIANTS != {"fused": LLM_NEW * n_moe, "logits": 0} or \
            moe_router.FORMS != {"tile": n_moe,
                                 "split": (LLM_NEW - 1) * n_moe}:
        raise AssertionError(f"{JAMBA_ARCH} generate: moe_router variants "
                             f"{moe_router.VARIANTS}, forms "
                             f"{moe_router.FORMS}")
    from repro_torch.kernels import mamba_scan

    if mamba_scan.VARIANTS != {"ring": n_mamba, "simt": 0}:
        raise AssertionError(f"{JAMBA_ARCH} generate: mamba_scan variants "
                             f"{mamba_scan.VARIANTS}, expected "
                             f"{n_mamba} ring")
    say("llm", f"{JAMBA_ARCH} moe_router forms {moe_router.FORMS}; "
        f"mamba_scan variants {mamba_scan.VARIANTS}")
    with torch.inference_mode():
        cache = M.init_cache(cfg, LLM_BATCH, LLM_MAX_LEN,
                             dtype=torch.bfloat16, device=DEVICE)
        state = cache["layers"]["pos0"]
        kv = cache["layers"][f"pos{cfg.layer_kinds().index('attn')}"]["k"]
        say("llm", f"{JAMBA_ARCH} cache per generate: each Mamba layer's "
            f"conv window {state['conv'].numel() * 2 / 1e6:.2f} MB bf16 and "
            f"SSM state {state['ssm'].numel() * 4 / 1e6:.2f} MB float32; "
            f"the attention layer's KV {2 * kv.numel() * 2 / 1e6:.1f} MB")
        tok = {"tokens": prompts["tokens"][:, -1:]}
        steps = {"a prefill": lambda: M.prefill(params, cfg, prompts, cache,
                                                last_only=True),
                 "a decode step": lambda: M.decode_step(params, cfg, cache,
                                                        tok, LLM_PROMPT)}
        counted = {k: profiled(fn)[2] for k, fn in steps.items()}
    say("llm", f"{JAMBA_ARCH} kernels launched (torch.profiler, every "
        f"kernel): " + ", ".join(
            f"{k} {sum(e.count for e in ev)} ("
            f"{sum(e.self_device_time_total for e in ev) / 1e3:.2f} ms of "
            f"device time)" for k, ev in counted.items()))
    del params, tree, cache, state, kv
    release()
    return launches


ATTN_BWD_CASES = (  # (label, b, sq, skv, hq, hkv, d, causal, window, dtype)
    ("phi3 train", 4, 1024, 1024, 32, 32, 96, True, 0, "bfloat16"),
    ("deepseek train", 4, 1024, 1024, 16, 16, 128, True, 0, "bfloat16"),
    ("GQA 12:2 window 256", 2, 512, 768, 12, 2, 128, True, 256, "bfloat16"),
    # ragged: 1,500 keys and queries end mid-tile, no causal mask
    ("head_dim 64 non-causal", 4, 1500, 1500, 12, 12, 64, False, 0,
     "bfloat16"),
    ("GQA 12:2 window 256 f32", 2, 512, 768, 12, 2, 128, True, 256,
     "float32"),
    # the encoder-decoder and VLM training paths (13r, 13s): Whisper's
    # cross-attention (448 decoder queries on 1,500 frames, non-causal,
    # both ragged: 3.5 dq CTAs of 128 queries, the lse padded to 512) and
    # decoder self-attention, Qwen2-VL's GQA 12:2; and qwen3-14b's GQA
    # 40:8 (group 5) at the LM cells' 4 x 1,024
    ("whisper cross", 4, 448, 1500, 12, 12, 64, False, 0, "bfloat16"),
    ("whisper self", 4, 448, 448, 12, 12, 64, True, 0, "bfloat16"),
    ("qwen2-vl train", 4, 1024, 1024, 12, 2, 128, True, 0, "bfloat16"),
    ("qwen3 GQA 40:8", 4, 1024, 1024, 40, 8, 128, True, 0, "bfloat16"),
)


def sdpa_kw(q, k, causal, window, q_offset):
    """``scaled_dot_product_attention``'s keywords for the mask of
    (b, s, h, d) q and k: a window, or a causal diagonal off q_offset 0,
    as a boolean mask; no mask for non-causal attention without a
    window."""
    from repro_torch.kernels.flash_attention.ref import _mask

    kw = {"enable_gqa": True} if q.shape[2] != k.shape[2] else {}
    sq, skv = q.shape[1], k.shape[1]
    if window or (causal and (q_offset != 0 or sq != skv)):
        kw["attn_mask"] = _mask(sq, skv, q_offset, causal, window, q.device)
    else:
        kw["is_causal"] = causal
    return kw


def sdpa_bwd_call(q, k, v, dout, causal, window, q_offset):
    """The library calls beside the backward kernel: (the forward, the
    backward) of ``scaled_dot_product_attention`` on the same tensors
    ((b, h, s, d) views, :func:`sdpa_kw`), the backward's forward run once
    outside its timed call."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    kw = sdpa_kw(q, k, causal, window, q_offset)
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    do = dout.transpose(1, 2)

    def forward():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    return forward, lambda: torch.autograd.grad(out, (qt, kt, vt), do,
                                                retain_graph=True)


def phase_attention_bwd_check():
    """flash_attention_bwd against ``attention_bwd_ref`` on the card, from
    the (out, lse) the forward kernel wrote, at phi3's and deepseek's
    training shapes (bf16, causal), GQA 12:2 with a 256 window and sq !=
    skv in bf16 and in f32, a ragged non-causal bf16 case at head_dim 64,
    Whisper's cross- and self-attention, Qwen2-VL's GQA 12:2 and
    qwen3-14b's GQA 40:8 training shapes: each case's backward variant
    (``plan_bwd``; every bf16 case ``wgmma``, f32 ``simt``), held to
    ``attention_bwd_ref`` with that variant's rounding (bf16 within 2e-2,
    f32 within 1e-4, absolute and relative), its error against the
    unrounded version printed too; two launches bit-equal; the kernel's
    time (L2 cold), the plain version's, the bound and
    scaled_dot_product_attention's backward on the same tensors; the
    forward with its log-sum-exp timed beside its bound, its plain
    version's and SDPA's forward. Returns {label: numbers}."""
    import torch

    from repro_torch.kernels.flash_attention import (BWD_VARIANTS,
                                                     attention_bwd,
                                                     attention_bwd_ref,
                                                     attention_lse_ref, plan,
                                                     plan_bwd)
    from repro_torch.kernels.flash_attention.ops import _forward
    from repro_torch.kernels.interface import KernelType
    from repro_torch.roofline import kernels as W

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    out_rows = {}
    for (label, b, sq, skv, hq, hkv, d, causal, window,
         dtype) in ATTN_BWD_CASES:
        dt = getattr(torch, dtype)
        q, dout = (torch.randn(b, sq, hq, d, device=DEVICE,
                               generator=gen).to(dt) for _ in range(2))
        k, v = (torch.randn(b, skv, hkv, d, device=DEVICE,
                            generator=gen).to(dt) for _ in range(2))
        q_offset = skv - sq
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out, lse = _forward(q, k, v, causal, window, q_offset,
                            KernelType.CUDA, True)
        variant = plan_bwd(q, k, v, out, dout)
        if variant != ("wgmma" if dtype == "bfloat16" else "simt"):
            raise AssertionError(f"flash_attention_bwd {label} {dtype}: "
                                 f"plan_bwd picks {variant}")
        before = BWD_VARIANTS[variant]
        got = attention_bwd(q, k, v, out, lse, dout, **kw)
        again = attention_bwd(q, k, v, out, lse, dout, **kw)
        if BWD_VARIANTS[variant] != before + 2:
            raise AssertionError(f"flash_attention_bwd {label}: {variant} "
                                 f"did not run ({BWD_VARIANTS})")
        want = attention_bwd_ref(q, k, v, out, lse, dout, variant=variant,
                                 **kw)
        unrounded = attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        tol = ATTN_TOL[dtype] if dtype == "bfloat16" else 1e-4
        errs = [float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want)]
        errs_f32 = [float((g.float() - w.float()).abs().max())
                    for g, w in zip(got, unrounded)]
        name = (f"{label} {dtype} [backward {variant}, forward "
                f"{plan(q, k, v, **kw)[0]}]")
        if not all(within(g, w, tol) for g, w in zip(got, want)):
            raise AssertionError(f"flash_attention_bwd {name}: dq, dk, dv "
                                 f"differ by {errs} (tol {tol})")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {name}: two launches "
                                 "differ")
        ms = cuda_time_ms(lambda: attention_bwd(q, k, v, out, lse, dout,
                                                **kw), 10)
        plain_ms = cuda_time_ms(lambda: attention_bwd_ref(
            q, k, v, out, lse, dout, **kw), 5)
        lib_fwd, lib_bwd = sdpa_bwd_call(q, k, v, dout, causal, window,
                                         q_offset)
        lib_ms = cuda_time_ms(lib_bwd, 10)
        lib_fwd_ms = cuda_time_ms(lib_fwd, 10)
        del lib_fwd, lib_bwd
        fwd_ms = cuda_time_ms(lambda: _forward(q, k, v, causal, window,
                                               q_offset, KernelType.CUDA,
                                               True), 10)
        fwd_plain_ms = cuda_time_ms(lambda: attention_lse_ref(q, k, v, **kw),
                                    5)
        size = 2 if dtype == "bfloat16" else 4
        shape = (b, sq, skv, hq, hkv, d)
        mask = dict(causal=causal, window=window, q_offset=q_offset,
                    q_itemsize=size, kv_itemsize=size)
        bound_ms, by, mb, gflop = bound(W.attention_bwd(*shape, **mask))
        fwd_bound, fwd_by, fwd_mb, fwd_gflop = bound(W.attention(
            *shape, lse=True, **mask))
        say("kernel", f"flash_attention_bwd {name} q ({b}, {sq}, {hq}, {d}), "
            f"kv ({b}, {skv}, {hkv}, {d}), window {window}, q_offset "
            f"{q_offset}: max abs err dq/dk/dv "
            f"{', '.join(f'{e:.3g}' for e in errs)} (tol {tol:g}) from the "
            f"plain version with {variant}'s rounding, "
            f"{', '.join(f'{e:.3g}' for e in errs_f32)} from the unrounded "
            f"one (ds in f32), two launches bit-equal; kernel "
            f"{ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, scaled_dot_product_attention "
            f"backward {lib_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
            f"({mb:.1f} MB, {gflop:.2f} GFLOP; by {by}), {bound_ms / ms:.2%} "
            f"of bound; the forward with its log-sum-exp "
            f"{fwd_ms * 1e3:.1f} us, bound {fwd_bound * 1e3:.1f} us "
            f"({fwd_mb:.1f} MB, {fwd_gflop:.2f} GFLOP; by {fwd_by}), "
            f"{fwd_bound / fwd_ms:.2%} of bound, plain "
            f"{fwd_plain_ms * 1e3:.1f} us, scaled_dot_product_attention "
            f"forward {lib_fwd_ms * 1e3:.1f} us")
        out_rows[label] = dict(max_abs_err=max(errs), ms=ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=by, library_ms=lib_ms)
        del q, k, v, dout, out, lse, got, again, want, unrounded
    release()
    return out_rows


def train_batches(vocab, steps, seq_len=TRAIN_SEQ):
    """``steps`` batches of TRAIN_BATCH x ``seq_len`` tokens from
    ``repro_torch.data.tokens.lm_batches`` (seed 0), on the card."""
    import numpy as np
    import torch

    from repro_torch.data.tokens import lm_batches

    return [{k: torch.as_tensor(v, device=DEVICE) for k, v in b.items()}
            for b in lm_batches(np.random.default_rng(0), vocab,
                                batch=TRAIN_BATCH, seq_len=seq_len,
                                steps=steps)]


def model_batches(cfg, steps, dtype):
    """``steps`` training batches of ``cfg``'s family, on the card: a
    token model's :func:`train_batches`; Whisper's tokens and targets of
    max_decoder_len positions with (TRAIN_BATCH, 1,500, d) frame
    embeddings * 0.2 in ``dtype`` (seed 3 + step; the frontend stub's
    output); Qwen2-VL's (TRAIN_BATCH, 1,024, d) embeddings * 0.2 in
    ``dtype`` (seed 1 + step) at :func:`vlm_positions` in place of the
    tokens, the targets -100 on the image grid."""
    import torch

    seq = cfg.max_decoder_len if cfg.is_encoder_decoder else TRAIN_SEQ
    batches = train_batches(cfg.vocab_size, steps, seq)
    for i, b in enumerate(batches):
        if cfg.is_encoder_decoder:
            gen = torch.Generator(device=DEVICE).manual_seed(3 + i)
            b["enc_frames"] = (torch.randn(
                TRAIN_BATCH, cfg.encoder_seq_len, cfg.d_model, device=DEVICE,
                generator=gen) * 0.2).to(dtype)
        elif cfg.family == "vlm":
            pos = vlm_positions()
            gen = torch.Generator(device=DEVICE).manual_seed(1 + i)
            b["embeds"] = (torch.randn(TRAIN_BATCH, len(pos), cfg.d_model,
                                       device=DEVICE, generator=gen)
                           * 0.2).to(dtype)
            b["mrope_positions"] = pos[None].expand(TRAIN_BATCH, -1, -1)
            del b["tokens"]
            b["targets"][:, VLM_TEXT:VLM_TEXT + VLM_GRID[0] * VLM_GRID[1]] \
                = -100
    return batches


def run_training(arch, n_params, n_leaves, per_pass, variants, cut=None):
    """``arch`` at every published width in bf16 (``cut``: fewer layers),
    its tree's ``n_params`` parameters in ``n_leaves`` leaves, on its
    family's :func:`model_batches`, with every launch count set to 0 just
    before: one ``make_train_step`` with ``adamw()`` and
    ``grad_clip=1.0``, then two ``make_tier_round`` rounds (l_local 2, the
    example's hyperparameters) of one team from theta = w = x = the drawn
    parameters (as the example starts), on the same batch each round.
    Launches: each kernel of ``per_pass`` exactly that many
    times a forward and backward pass (1 + 4 passes), prox_update exactly
    rounds x l_local x leaves, tier_update rounds x leaves, no other
    kernel; ``variants`` maps a name
    to (its counts dict, the counts per pass it must read). Finite
    losses, the tier loss lower in round 2; ms per step, tokens/s, peak
    memory (under the card's 80 GB), the second round's device busy share,
    its ten largest kernels and its attention forward and selective scan
    kernels (torch.profiler). Returns (its launches, (theta, w, x) after
    the last round)."""
    import torch

    from repro_torch.kernels import flash_attention, mamba_scan, \
        moe_router, rwkv6_scan
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.train import optim
    from repro_torch.train.train_state import TrainState
    from repro_torch.train.trainer import make_tier_round, make_train_step

    cut = cut or {}
    tag = arch + (f" cut to {cut['num_layers']} layers" if cut else "")
    cfg, params = draw_full_width(arch, n_params, **cut)
    got_leaves = len(list(_leaves(params)))
    if got_leaves != n_leaves:
        raise AssertionError(f"{arch}: {got_leaves} leaves, expected "
                             f"{n_leaves}")
    batches = model_batches(cfg, 2, torch.bfloat16)
    shape = tuple(batches[0]["targets"].shape)
    tokens = math.prod(shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for mod in (flash_attention, mamba_scan, moe_router, rwkv6_scan):
        mod.reset_variants()
    t0 = time.perf_counter()
    state = TrainState.create(params, optim.adamw())
    step = make_train_step(cfg, optim.adamw(), lr=TRAIN_LR, grad_clip=1.0)
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_peak = torch.cuda.max_memory_allocated()
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    say("train", f"{tag} AdamW step (grad_clip 1.0, lr {TRAIN_LR}) on "
        f"{shape[0]} x {shape[1]} positions: loss {loss:.4f}, grad norm "
        f"{gnorm:.4f}; {step_s * 1e3:.1f} ms (host clock, the card "
        f"synchronized; AdamW state created inside), {tokens / step_s:,.0f} "
        f"tokens/s, peak {step_peak / 2**30:.2f} GiB "
        f"({step_peak / 1e9:.2f} GB)")
    del params, state, m, step
    release()
    # the tier rounds start where the reference's example starts: theta =
    # w = x = the drawn parameters (drawn again, seed 0)
    _, params = draw_full_width(arch, n_params, **cut)
    torch.cuda.reset_peak_memory_stats()
    round_fn = make_tier_round(cfg, l_local=TRAIN_L_LOCAL, **TIER_HP)
    theta = w = x = params
    del params
    losses, times, busy = [], [], None
    for r in range(TRAIN_ROUNDS):
        t0 = time.perf_counter()
        if r == TRAIN_ROUNDS - 1:     # the wall clock before key_averages
            (theta, w, x, mr), wall, rows = profiled(
                lambda: round_fn(theta, w, x, batches[1]))
            busy = sum(e.self_device_time_total for e in rows) / 1e6 / wall
        else:
            theta, w, x, mr = round_fn(theta, w, x, batches[1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        times.append(wall)
        losses.append(float(mr["loss"]))
    tier_peak = torch.cuda.max_memory_allocated()
    launches = dict(LAUNCHES)
    passes = 1 + TRAIN_ROUNDS * TRAIN_L_LOCAL
    check_launches(launches, {
        **{k: n * passes for k, n in per_pass.items()},
        "prox_update": TRAIN_ROUNDS * TRAIN_L_LOCAL * got_leaves,
        "tier_update": TRAIN_ROUNDS * got_leaves},
        f"{tag} training")
    for name, (counts, want) in variants.items():
        ran = {k: c for k, c in counts.items() if c}
        if ran != {k: n * passes for k, n in want.items()}:
            raise AssertionError(f"{tag} training: {name} {ran}, expected "
                                 f"{want} a pass")
    say("train", f"{tag} tier rounds (l_local {TRAIN_L_LOCAL}, "
        f"{TIER_HP}, one team, the same batch): mean local loss "
        + " -> ".join(f"{v:.4f}" for v in losses) + "; "
        + ", ".join(f"{t * 1e3:.1f} ms" for t in times)
        + f" a round ({TRAIN_L_LOCAL * tokens / times[0]:,.0f} tokens/s in "
        f"round 1; round {TRAIN_ROUNDS} under torch.profiler), peak "
        f"{tier_peak / 2**30:.2f} GiB ({tier_peak / 1e9:.2f} GB); device "
        f"busy {busy:.1%} of round {TRAIN_ROUNDS}, "
        f"{sum(e.self_device_time_total for e in rows) / 1e3:.1f} ms of "
        f"kernels")
    say("train", f"{tag} launches: " + ", ".join(
        f"{k} {v}" for k, v in sorted(launches.items()) if v)
        + "; variants " + ", ".join(
            f"{name} {dict(counts)}" for name, (counts, _) in
            variants.items()))
    say("train", f"{tag} round {TRAIN_ROUNDS} under torch.profiler, "
        f"{sum(e.count for e in rows)} kernels, by device time: " + "; ".join(
            f"{e.key[:60]} x {e.count} {e.self_device_time_total / 1e3:.1f} "
            f"ms" for e in rows[:10]))
    for what, key in (("attention forward's", "attn_"),
                      ("selective scan's", "mamba_scan")):
        found = [e for e in rows if key in e.key]
        if found:
            say("train", f"{tag} round {TRAIN_ROUNDS}: the {what} kernels "
                + "; ".join(f"{e.key[:60]} x {e.count} "
                            f"{e.self_device_time_total / 1e3:.2f} ms"
                            for e in found))
    if not all(math.isfinite(v) for v in [loss, gnorm] + losses):
        raise AssertionError(f"{tag}: losses {loss}, {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: the tier loss did not fall "
                             f"({losses})")
    if max(step_peak, tier_peak) >= HBM_BYTES:
        raise AssertionError(f"{tag}: peak {max(step_peak, tier_peak)} B is "
                             f"over the card's {HBM_BYTES:.0f} B")
    return launches, (theta, w, x)


def phase_llm_training():
    """phi3-mini-3.8b at every published width in bf16 (the reference
    tree's 3,821,079,552 parameters, 12 leaves) through
    :func:`run_training`: flash_attention and flash_attention_bwd exactly
    32 per forward/backward pass (1 + 4 passes), every backward the
    ``wgmma`` variant, prox_update exactly rounds x l_local x 12,
    tier_update rounds x 12, no other kernel (every forward the ``wgmma``
    variant too, at head_dim 96); then prox_update and tier_update at its
    largest leaves (:func:`prox_at_phi3`, :func:`tier_update_at_phi3`).
    Returns its launches."""
    from repro_torch.kernels.flash_attention import BWD_VARIANTS, VARIANTS

    layers = 32
    launches, (theta, w, x) = run_training(
        TRAIN_ARCH, TRAIN_PARAMS, TRAIN_LEAVES,
        {"flash_attention": layers, "flash_attention_bwd": layers},
        {"flash_attention variants": (VARIANTS, {"wgmma": layers}),
         "flash_attention_bwd variants": (BWD_VARIANTS,
                                          {"wgmma": layers})})
    prox_at_phi3(theta, w, x)
    tier_update_at_phi3(theta, w, x)
    del theta, w, x
    release()
    return launches


def phase_moe_training():
    """deepseek-moe-16b cut to MOE_TRAIN_CUT (every layer a MoE layer: 64
    experts, top-6, 2 shared, capacity 120 a group of 1,024) at every
    published width in bf16 through :func:`run_training`: flash_attention
    and flash_attention_bwd exactly 6 a pass (every forward and backward
    ``wgmma``),
    moe_router exactly 6 a pass (all ``fused``, ``tile``), moe_router_bwd
    exactly 6 a pass (all ``fused``: dl, dx and dw in one kernel, no
    ``logits``), prox_update rounds x l_local x 16, no other kernel.
    Returns its launches."""
    from repro_torch.kernels.flash_attention import BWD_VARIANTS
    from repro_torch.kernels.flash_attention import VARIANTS as ATTENTION
    from repro_torch.kernels.moe_router import BWD_VARIANTS as ROUTER_BWD
    from repro_torch.kernels.moe_router import FORMS, VARIANTS

    n = MOE_TRAIN_CUT["num_layers"]
    launches, trees = run_training(
        LLM_ARCH, MOE_TRAIN_PARAMS, MOE_TRAIN_LEAVES,
        {"flash_attention": n, "flash_attention_bwd": n, "moe_router": n,
         "moe_router_bwd": n},
        {"flash_attention variants": (ATTENTION, {"wgmma": n}),
         "flash_attention_bwd variants": (BWD_VARIANTS, {"wgmma": n}),
         "moe_router variants": (VARIANTS, {"fused": n}),
         "moe_router forms": (FORMS, {"tile": n}),
         "moe_router_bwd variants": (ROUTER_BWD, {"fused": n})},
        MOE_TRAIN_CUT)
    del trees
    release()
    return launches


def phase_rwkv_training():
    """rwkv6-7b cut to RWKV_TRAIN_CUT at every published width in bf16
    (decay_w0 and bonus_u float32 leaves) through :func:`run_training`:
    rwkv6_scan exactly 12 a pass (all ``chunked``), rwkv6_scan_bwd exactly
    12 a pass (all ``chunked``), prox_update rounds x l_local x 25 (the
    float32 leaves' launches among them), no other kernel. Returns its
    launches."""
    from repro_torch.kernels.rwkv6_scan import BWD_VARIANTS, VARIANTS

    n = RWKV_TRAIN_CUT["num_layers"]
    launches, trees = run_training(
        RWKV_ARCH, RWKV_TRAIN_PARAMS, RWKV_TRAIN_LEAVES,
        {"rwkv6_scan": n, "rwkv6_scan_bwd": n},
        {"rwkv6_scan variants": (VARIANTS, {"chunked": n}),
         "rwkv6_scan_bwd variants": (BWD_VARIANTS, {"chunked": n})},
        RWKV_TRAIN_CUT)
    del trees
    release()
    return launches


def prox_at_phi3(theta, w, x):
    """prox_update at phi3's largest leaves (``w_gate``, 32 x 3,072 x 8,192
    bf16: theta, w as the gradient, x as the anchor) against its plain
    version (within the bf16 tolerance), its time (L2 cold), the plain
    version's, the bound (three reads and a write of the leaf), and the
    whole 12-leaf ``prox_sgd_tree`` (12 launches). Not counted: the
    phase's launches were read before."""
    import torch

    from repro_torch.kernels.prox_update import (prox_sgd, prox_sgd_ref,
                                                 prox_sgd_tree)
    from repro_torch.roofline import kernels as W

    leaf = [t["blocks"]["pos0"]["mlp"]["w_gate"] for t in (theta, w, x)]
    kw = dict(alpha=TIER_HP["alpha"], lam=TIER_HP["lam"])
    got = prox_sgd(*leaf, **kw)[0]
    want = prox_sgd_ref(*leaf, **kw)[0]
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not within(got, want, TOL["bfloat16"]):
        raise AssertionError(f"prox_update at phi3's w_gate: {err}")
    del got, want
    ms = cuda_time_ms(lambda: prox_sgd(*leaf, **kw), 10)
    plain_ms = cuda_time_ms(lambda: prox_sgd_ref(*leaf, **kw), 3)
    tree_ms = cuda_time_ms(lambda: prox_sgd_tree(theta, w, x, **kw), 3)
    n = leaf[0].numel()
    bound_ms = W.prox_update(1, n, itemsize=2, anchor_rows=1).bound_ms
    tree_bound = sum(W.prox_update(1, t.numel(), itemsize=2,
                                   anchor_rows=1).bound_ms
                     for t in _leaves(theta))
    say("kernel", f"prox_update at {TRAIN_ARCH}'s w_gate ({n:,} bf16): max "
        f"abs err {err:.3g} (tol {TOL['bfloat16']:g}); kernel "
        f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
        f"{bound_ms * 1e3:.1f} us ({4 * n * 2 / 1e6:.1f} MB, bytes), "
        f"{bound_ms / ms:.1%} of bound; the 12-leaf prox_sgd_tree "
        f"{tree_ms:.2f} ms against {tree_bound:.2f} ms")


def tier_update_at_phi3(theta, w, x):
    """tier_update (eqs. 9 and 13 in one pass) over phi3's tree (w, x and
    theta of the last round) against its plain version (the eight eager
    kernels a leaf), bit for bit; at the largest leaf (``w_gate``,
    805,306,368 bf16) its time (L2 cold), the plain version's and the
    bound (three reads and two writes of the leaf); the same for the
    whole 12-leaf ``tier_update_tree`` (12 launches, a round's). Not
    counted: the phase's launches were read before."""
    import torch

    from repro_torch.kernels.tier_update import (tier_update,
                                                 tier_update_ref,
                                                 tier_update_tree)
    from repro_torch.roofline import kernels as W

    hp = {k: TIER_HP[k] for k in ("eta", "lam", "gamma", "beta")}
    leaf = [t["blocks"]["pos0"]["mlp"]["w_gate"] for t in (w, x, theta)]
    got = tier_update_tree(w, x, theta, **hp)
    want = tier_update_tree(w, x, theta, mode="torch", **hp)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for g, wt in zip(got, want)
               for a, b in zip(_leaves(g), _leaves(wt))):
        raise AssertionError("tier_update over phi3's tree: not bit-equal "
                             "to the plain version")
    del got, want
    ms = cuda_time_ms(lambda: tier_update(*leaf, **hp), 10)
    plain_ms = cuda_time_ms(lambda: tier_update_ref(*leaf, **hp), 3)
    tree_ms = cuda_time_ms(lambda: tier_update_tree(w, x, theta, **hp), 5)
    plain_tree_ms = cuda_time_ms(
        lambda: tier_update_tree(w, x, theta, mode="torch", **hp), 3)
    n = leaf[0].numel()
    gate = W.tier_update(n, 2)
    tree_bound = sum(W.tier_update(t.numel(), 2).bound_ms
                     for t in _leaves(theta))
    say("kernel", f"tier_update over {TRAIN_ARCH}'s tree bit-equal to the "
        f"plain version; at its w_gate ({n:,} bf16): kernel "
        f"{ms * 1e3:.1f} us, plain "
        f"{plain_ms * 1e3:.1f} us, bound {gate.bound_ms * 1e3:.1f} us "
        f"({gate.bytes / 1e6:.1f} MB, {gate.bound_by}), "
        f"{gate.bound_ms / ms:.1%} of bound; the 12-leaf tier_update_tree "
        f"(12 launches, a round's) {tree_ms:.2f} ms, plain "
        f"{plain_tree_ms:.2f} ms, against {tree_bound:.2f} ms "
        f"({tree_bound / tree_ms:.1%} of bound)")


def phase_training_consistency(arch=TRAIN_ARCH):
    """``arch`` (phi3-mini-3.8b cut to 2 layers, or whisper-small and
    qwen2-vl-2b cut to ENCDEC_VLM_CONSISTENCY_CUT on :func:`model_batches`)
    at every published width, in f32 (TF32 off), from the same parameters
    through the kernels and through the plain versions (``mode="torch"``):
    one ``make_train_step`` (SGD, lr 1e-2, grad_clip 1.0, so that the
    parameters move by the gradients) and one tier round (l_local 2);
    losses and every parameter within TRAIN_TOL (absolute and
    relative)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (BWD_VARIANTS, VARIANTS,
                                                     reset_variants)
    from repro_torch.models import model as M
    from repro_torch.train import optim
    from repro_torch.train.train_state import TrainState
    from repro_torch.train.trainer import make_tier_round, make_train_step

    cfg = get_config(arch).replace(
        **ENCDEC_VLM_CONSISTENCY_CUT.get(arch, TRAIN_CONSISTENCY_CUT))
    params = M.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                           cfg, dtype=torch.float32, device=DEVICE)
    n = sum(t.numel() for t in _leaves(params))
    if n != ENCDEC_VLM_CONSISTENCY_PARAMS.get(arch, n):
        raise AssertionError(f"{arch} cut: {n} parameters")
    (batch,) = model_batches(cfg, 1, torch.float32)
    runs = {}
    reset_variants()
    for mode in (None, "torch"):
        step = make_train_step(cfg, optim.sgd(), lr=TRAIN_CONSISTENCY_LR,
                               grad_clip=1.0, mode=mode)
        state, m = step(TrainState.create(params, optim.sgd()), batch)
        rnd = make_tier_round(cfg, l_local=TRAIN_L_LOCAL, mode=mode,
                              **TIER_HP)(params, state.params, params, batch)
        runs[mode] = (m["loss"], m["grad_norm"], state.params, rnd)
    torch.cuda.synchronize()
    (lk, nk, pk, rk), (lp, np_, pp, rp) = runs[None], runs["torch"]
    pairs = [("step loss", lk, lp), ("grad norm", nk, np_),
             ("tier loss", rk[3]["loss"], rp[3]["loss"])]
    for tag, a, b in (("step params", pk, pp), ("theta'", rk[0], rp[0]),
                      ("w'", rk[1], rp[1]), ("x'", rk[2], rp[2])):
        pairs += [(f"{tag} {i}", ga, gb)
                  for i, (ga, gb) in enumerate(zip(_leaves(a), _leaves(b)))]
    worst = max(pairs, key=lambda p: float((p[1] - p[2]).abs().max()))
    bad = [tag for tag, a, b in pairs if not within(a, b, TRAIN_TOL)]
    say("consistency", f"{arch} x {cfg.num_layers} layers f32 "
        f"training, kernel vs plain path: step loss {float(lk):.6f} / "
        f"{float(lp):.6f}, tier loss {float(rk[3]['loss']):.6f} / "
        f"{float(rp[3]['loss']):.6f}; max |diff| over losses and every "
        f"parameter {float((worst[1] - worst[2]).abs().max()):.3g} "
        f"({worst[0]}; tol {TRAIN_TOL:g} abs + rel); flash_attention "
        f"variants {dict(VARIANTS)} (f32: simt), flash_attention_bwd "
        f"variants {dict(BWD_VARIANTS)}")
    if bad:
        raise AssertionError(f"{arch} training: kernel and plain paths "
                             f"disagree on {bad[:8]}")
    del runs, params, batch
    release()


def router_bwd_errors(got, want):
    """(max abs error of dx, of dw, within tolerance) of the fused
    backward's (dx, dw) against the plain version's: dx within one bf16
    rounding (2^-7) of each value plus ROUTER_BWD_TOL_SCALE of the largest
    |dx|, dw within ROUTER_BWD_TOL_SCALE of the largest |dw|; an output
    left out (None) on both sides."""
    errs, ok = [], True
    for g, w, rel in zip(got, want, (2.0 ** -7, 0.0)):
        if g is None or w is None:
            ok &= g is None and w is None
            errs.append(0.0)
            continue
        err = (g.float() - w.float()).abs()
        ok &= g.dtype == w.dtype and bool(
            (err <= rel * w.float().abs()
             + ROUTER_BWD_TOL_SCALE * float(w.float().abs().max())).all())
        errs.append(float(err.max()))
    return errs[0], errs[1], ok


def wkv_grad_errors(got, want):
    """(max abs error per gradient, within tolerance): each of dr, dk, dv,
    dw, du, dstate0 within WKV_BWD_TOL of its largest value, in bf16 also
    within one bf16 rounding (2^-7) of each value."""
    import torch

    errs, ok = [], True
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        rel = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
        ok &= g.dtype == w.dtype and bool(
            (err <= rel * w.float().abs()
             + WKV_BWD_TOL * float(w.float().abs().max())).all())
        errs.append(float(err.max()))
    return errs, ok


def phase_family_bwd_check():
    """The two backward kernels of the MoE and RWKV-6 training paths
    against their plain versions on the card. moe_router_bwd, the fused
    variant (``csrc/moe_router_bwd_hopper.cu``) against
    ``route_tokens_full_bwd_ref`` on the fused forward's logits, ids and
    gates (groups of 1,024; cotangents drawn for the gates and mean_prob):
    deepseek's training shape (4,096 x 2,048 bf16 tokens, E 64, k 6;
    timed), with zero rows and tied experts, with a padded last group
    (4,000 tokens in 4,096 rows, the padded rows' gates' cotangent 0,
    mean_prob over 4,096 rows), Jamba's (4,096 x 8,192, E 16, k 2;
    timed), and dx only and dw only; dx and dw within
    :func:`router_bwd_errors`' tolerance, a repeat bit-equal, two launches
    counted ``fused``, ``plan_bwd`` picking it; the ``logits`` variant's
    dl (route_topk's backward, and float32 x's) within ROUTER_BWD_TOL at
    each; the logits the forward wrote against f32(x) @ w. Timed with the
    L2 cold beside the plain version, the chain the fused kernel replaced
    (the dl kernel, then dl w^T cast to bf16 and f32(x)^T dl, the cast of
    x inside, as the training path ran it) and the bound. rwkv6_scan_bwd,
    both variants on the same tensors, at rwkv6-7b's (4, 1,024, 64, 64),
    bf16 r/k/v and f32 w: without a state and with a zero final-state
    cotangent (the training path's; timed) and with a state and a
    cotangent (timed), and at t = 17 and 1,000; each gradient within
    WKV_BWD_TOL of its scale (bf16 also one bf16 rounding), a repeat
    bit-equal, two launches counted on the variant; ``plan_bwd`` picks
    ``chunked`` at each. Times with the L2 cold (``chunked`` and
    ``simt``), the plain versions', the bounds. Returns {label: numbers}:
    "router" deepseek's, "router jamba", a WKV label's the ``chunked``
    variant's."""
    import torch

    from repro_torch.kernels.interface import kernel_mode
    from repro_torch.kernels.moe_router import BWD_VARIANTS as ROUTER_BWD
    from repro_torch.kernels.moe_router import (logits_bwd, plan, plan_bwd,
                                                tokens_bwd)
    from repro_torch.kernels.moe_router.ops import _tokens_forward, \
        launch_bwd, launch_bwd_fused
    from repro_torch.kernels.moe_router.ref import route_tokens_full_bwd_ref
    from repro_torch.kernels.rwkv6_scan import BWD_VARIANTS, wkv_bwd
    from repro_torch.kernels.rwkv6_scan import plan_bwd as wkv_plan_bwd
    from repro_torch.kernels.rwkv6_scan.ops import bwd_scratch
    from repro_torch.kernels.rwkv6_scan.ops import launch_bwd as wkv_launch
    from repro_torch.roofline import kernels as W

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    out = {}
    deepseek = (LLM_BATCH * LLM_PROMPT, 2048, 64, 6)
    both = (True, True)
    # (label, (t, d, E, k), zero rows and tied experts, padded rows, the
    # outputs asked for, timed)
    for label, shape, tied, pad, need, timed in (
            ("deepseek train", deepseek, False, 0, both, True),
            ("zero rows, tied experts", deepseek, True, 0, both, False),
            ("a padded last group", deepseek, False, 96, both, False),
            ("jamba", JAMBA_ROUTER, False, 0, both, True),
            ("deepseek train, dx only", deepseek, False, 0, (True, False),
             False),
            ("deepseek train, dw only", deepseek, False, 0, (False, True),
             False)):
        t, d, e, k = shape
        x, w = router_inputs(t, d, e, torch.bfloat16, gen, tied, tied)
        if pad:
            x[t - pad:] = 0
        opts = (k, True, LLM_GROUP, kernel_mode(x),
                plan(x, w, top_k=k, group_size=LLM_GROUP))
        with torch.no_grad():
            gates, idx, _, _, _, logits = _tokens_forward(x, w, opts, True)
        dg = torch.randn(t, k, device=DEVICE, generator=gen)
        if pad:
            dg[t - pad:] = 0
        dm = torch.randn(e, device=DEVICE, generator=gen)
        form = plan_bwd(x, w, top_k=k)
        if form["variant"] != "fused":
            raise AssertionError(f"moe_router_bwd {label}: plan_bwd picks "
                                 f"{form}")
        before = dict(ROUTER_BWD)
        got = tokens_bwd(x, w, logits, idx, gates, dg, dm, need=need)
        again = tokens_bwd(x, w, logits, idx, gates, dg, dm, need=need)
        torch.cuda.synchronize()
        counted = {v: ROUTER_BWD[v] - before[v] for v in before}
        _, dx_p, dw_p = route_tokens_full_bwd_ref(x, w, logits, idx, gates,
                                                  dg, dm)
        want = (dx_p if need[0] else None, dw_p if need[1] else None)
        ex, ew, ok = router_bwd_errors(got, want)
        tag = (f"moe_router_bwd fused {label} ({t} x {d} bf16 tokens, E "
               f"{e}, k {k}, groups of {LLM_GROUP}"
               + (f", the last {pad} rows padding" if pad else "")
               + f"; {form['slices']} slices x {form['ranges']} ranges of "
               f"{form['stages_per_range']} stages): dx max abs err "
               f"{ex:.3g}, dw {ew:.3g} (dx within 2^-7 of each value, both "
               f"within {ROUTER_BWD_TOL_SCALE:g} of the largest), two "
               f"launches bit-equal")
        if not ok:
            raise AssertionError(f"{tag}: kernel and plain version differ")
        if not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(got, again)):
            raise AssertionError(f"moe_router_bwd {label}: two launches "
                                 "differ")
        if counted != {"fused": 2, "logits": 0}:
            raise AssertionError(f"moe_router_bwd {label}: variant counts "
                                 f"{counted}")
        # the logits variant's dl on the same tensors
        dl = logits_bwd(logits, idx, gates, dg, dm)
        dl_want = logits_bwd(logits, idx, gates, dg, dm, mode="torch")
        torch.cuda.synchronize()
        dl_err = float((dl - dl_want).abs().max())
        if not bool(((dl - dl_want).abs() <= ROUTER_BWD_TOL
                     + 1e-5 * dl_want.abs()).all()):
            raise AssertionError(f"moe_router_bwd logits {label}: dl off by "
                                 f"{dl_err}")
        if not torch.equal(dl, logits_bwd(logits, idx, gates, dg, dm)):
            raise AssertionError(f"moe_router_bwd logits {label}: two "
                                 "launches differ")
        lerr = float((logits - x.float() @ w).abs().max())
        say("kernel", f"{tag}; the logits variant's dl within {dl_err:.3g} "
            f"(tol {ROUTER_BWD_TOL:g} + 1e-5 relative), bit-equal; the "
            f"forward's logits within {lerr:.3g} of f32(x) @ w")
        del got, again, want, dx_p, dw_p, dl_want
        if not timed:
            continue
        dx = torch.empty(t, d, dtype=x.dtype, device=DEVICE)
        dw = torch.empty(d, e, device=DEVICE)
        ms = cuda_time_ms(lambda: launch_bwd_fused(
            x, w, logits, idx, gates, dg, dm, dx, dw, renormalize=True,
            form=form), TIMED_LAUNCHES)
        plain_ms = cuda_time_ms(lambda: route_tokens_full_bwd_ref(
            x, w, logits, idx, gates, dg, dm), 20)
        dl_ms = cuda_time_ms(lambda: launch_bwd(logits, idx, gates, dg, dm,
                                                dl, renormalize=True),
                             TIMED_LAUNCHES)

        def chain():
            d_l = logits_bwd(logits, idx, gates, dg, dm)
            return (d_l @ w.T).to(x.dtype), x.float().T @ d_l

        chain_ms = cuda_time_ms(chain, 20)
        bound_ms, by, mb, gflop = bound(W.moe_router_bwd(t, d, e, k))
        say("kernel", f"moe_router_bwd fused {label}: {ms * 1e3:.1f} us "
            f"L2-cold, {bound_ms / ms:.1%} of bound; bound "
            f"{bound_ms * 1e3:.2f} us ({mb:.2f} MB, {gflop:.2f} GFLOP of "
            f"bf16 products; by {by}); the chain it replaced (the dl "
            f"kernel {dl_ms * 1e3:.1f} us, dl w^T cast to bf16, f32(x)^T dl "
            f"with x's cast) {chain_ms * 1e3:.1f} us, "
            f"{chain_ms / ms:.2f}x; plain {plain_ms * 1e3:.1f} us; no "
            f"library call")
        out["router" if label == "deepseek train" else f"router {label}"] = \
            dict(max_abs_err=max(ex, ew), ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=by, library_ms=None,
                 chain_ms=chain_ms)
        del dx, dw
    del x, w, logits, dl
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, b, t, given state, final cotangent, timed)
    for label, b, tt, state, final, timed in (
            ("train", LLM_BATCH, LLM_PROMPT, False, False, True),
            ("train, a state and a final cotangent", LLM_BATCH, LLM_PROMPT,
             True, True, True),
            ("t 17", LLM_BATCH, 17, True, True, False),
            ("t 1000", LLM_BATCH, 1000, False, True, False)):
        h, n = 64, 64
        r, kk, v, wd, u, s0 = wkv_inputs(b, tt, h, n, bf16, gen, state)
        dout = torch.randn(b, tt, h, n, device=DEVICE, generator=gen).to(
            bf16)
        # without one, the zeros autograd hands a final state nothing reads
        dsf = (torch.randn(b, h, n, n, device=DEVICE, generator=gen)
               if final else torch.zeros(b, h, n, n, device=DEVICE))
        args = (r, kk, v, wd, u, s0, dout, dsf)
        want = wkv_bwd(*args, mode="torch")
        shape = (f"({b}, {tt}, {h}, {n}) bf16/f32 w, "
                 + ("a given state" if state else "state None") + ", "
                 + ("a final-state cotangent" if final
                    else "a zero final-state cotangent"))
        if wkv_plan_bwd(r, kk, v, wd, s0) != "chunked":
            raise AssertionError(f"rwkv6_scan_bwd {label}: plan_bwd picks "
                                 f"{wkv_plan_bwd(r, kk, v, wd, s0)}, not "
                                 "chunked")
        errs = {}
        for var in ("chunked", "simt"):
            before = dict(BWD_VARIANTS)
            got = wkv_bwd(*args, variant=var)
            again = wkv_bwd(*args, variant=var)
            torch.cuda.synchronize()
            counted = {k: BWD_VARIANTS[k] - before[k] for k in before}
            if counted != {v2: 2 if v2 == var else 0 for v2 in before}:
                raise AssertionError(f"rwkv6_scan_bwd {var} {label}: "
                                     f"variant counts {counted}")
            errs[var], ok = wkv_grad_errors(got, want)
            tag = (f"rwkv6_scan_bwd {var} rwkv6-7b {label} {shape}: max abs "
                   f"err dr/dk/dv/dw/du/dstate0 "
                   + ", ".join(f"{x:.3g}" for x in errs[var])
                   + f" (tol {WKV_BWD_TOL:g} of each scale, bf16 also 2^-7 "
                   f"of each value), two launches bit-equal")
            if not ok:
                raise AssertionError(f"{tag}: kernel and plain version "
                                     "differ")
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"rwkv6_scan_bwd {var} {label}: two "
                                     "launches differ")
            say("kernel", tag)
        if not timed:
            continue
        grads = tuple(torch.empty_like(g) for g in got[:4]) + (
            torch.empty(b, h, n, device=DEVICE), torch.empty_like(got[5]))
        uc = u.contiguous()
        ms, mb = {}, {}
        for var in ("chunked", "simt"):
            scratch = bwd_scratch(r, var)
            mb[var] = scratch.numel() * 4 / 1e6
            ms[var] = cuda_time_ms(lambda: wkv_launch(
                r, kk, v, wd, uc, s0, dout, dsf, grads, scratch,
                variant=var), 10)
            del scratch
        plain_ms = cuda_time_ms(lambda: wkv_bwd(*args, mode="torch"), 3)
        work = W.rwkv6_scan_bwd(b, tt, h, n, itemsize=2, state=state)
        bound_ms, by, moved, _ = bound(work)
        cc_ms = work.at("f32") * 1e3
        say("kernel", f"rwkv6_scan_bwd {label}: chunked "
            f"{ms['chunked'] * 1e3:.1f} us L2-cold (its snapshots "
            f"{mb['chunked']:.1f} MB), {bound_ms / ms['chunked']:.1%} of "
            f"bound; simt on the same tensors {ms['simt'] * 1e3:.1f} us "
            f"(snapshots {mb['simt']:.1f} MB), "
            f"{ms['simt'] / ms['chunked']:.2f}x; plain "
            f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
            f"({moved:.1f} MB, by {by}); the step-by-step form's CUDA-core "
            f"floor {cc_ms * 1e3:.1f} us ({W.RWKV_BWD_OPS_PER_ELEMENT} f32 "
            f"operations per element-step), {cc_ms / ms['chunked']:.1%} of "
            f"it; no library call")
        out[f"wkv {label}"] = dict(max_abs_err=max(errs["chunked"]),
                                   ms=ms["chunked"], plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=by,
                                   library_ms=None)
        del grads
    del r, kk, v, wd, u, s0, dout, dsf, got, again, want
    release()
    return out


def mamba_inputs(b, s, d_in, dtype, gen, state, lattice=True):
    """The selective scan's operands as Jamba's mixer makes them: xc (b,
    s, d_in) normal, dt = softplus(N(-2, 1)), B and C the strided views of
    one (b, s, 512 + 32) projection (x_proj's output at dt_rank 512), A =
    -(1..16) a row (the init's -exp(A_log)), or with ``lattice`` False A =
    -exp(log(1..16) + N(0, 0.3)) drawn per entry (a trained A_log's: off
    the lattice exp(dt A_n) = exp(dt A_1)^n); h0 normal x 0.5 or None."""
    import torch
    import torch.nn.functional as F

    def normal(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen)

    xc = normal(b, s, d_in).to(dtype)
    dt = F.softplus(normal(b, s, d_in) - 2.0).to(dtype)
    _, b_mat, c_mat = normal(b, s, 512 + 32).to(dtype).split([512, 16, 16],
                                                            dim=-1)
    n = torch.arange(1, 17, dtype=torch.float32, device=DEVICE)
    a = -n.expand(d_in, 16).contiguous() if lattice else \
        -(n.log() + 0.3 * normal(d_in, 16)).exp()
    h0 = normal(b, d_in, 16) * 0.5 if state else None
    return xc, dt, b_mat, c_mat, a, h0


def mamba_errors(got, want):
    """(max abs error per tensor, within tolerance): each within MAMBA_TOL
    of its largest value, in bf16 also one bf16 rounding (2^-7) of each
    value; None entries must match."""
    import torch

    errs, ok = [], True
    for g, w in zip(got, want):
        if w is None or g is None:
            ok &= g is None and w is None
            continue
        err = (g.float() - w.float()).abs()
        rel = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
        ok &= g.dtype == w.dtype and g.shape == w.shape and bool(
            (err <= rel * w.float().abs()
             + MAMBA_TOL * float(w.float().abs().max())).all())
        errs.append(float(err.max()))
    return errs, ok


def sass_loop(lib, *match):
    """(instructions, MUFU.EX2, SHFL) in the SASS body of the largest loop
    (a backward branch) of the kernel of library ``lib`` whose mangled name
    holds every string of ``match``, from ``cuobjdump -sass``; None where
    the tool or the kernel is missing."""
    import re
    import subprocess

    from repro_torch.kernels.build import build, nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(build([lib])[lib])],
                          capture_output=True, text=True).stdout
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        if not all(m in name for m in match):
            continue
        code = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;/]*?);", part)]
        best = None
        for addr, op in code:
            hit = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if hit and int(hit[1], 16) < addr:
                body = [o for a, o in code
                        if int(hit[1], 16) <= a <= addr and "NOP" not in o]
                if best is None or len(body) > len(best):
                    best = body
        if best:
            return (len(best), sum("MUFU.EX2" in o for o in best),
                    sum("SHFL" in o for o in best))
    return None


def phase_mamba_check():
    """Mamba's selective scan: each forward variant (mamba_scan: ``ring``,
    the main path's, and ``simt``; with their snapshots) and each backward
    (mamba_scan_bwd, from them) against their plain versions
    (``scan_ref``, ``scan_bwd_ref`` at the variant's cadence) at Jamba's
    (4, 1,024, 16,384, 16) in bf16 -- as the training path gives them (no
    h0, no final-state cotangent; timed), and with both -- in f32 with
    both, at s = 1, 17 and 1,000, and with an A off the initial value's
    lattice in bf16 and f32: y, the final state, the snapshots and dxc,
    ddt, dB, dC, dA (and dh0 where h0 is given) under
    :func:`mamba_errors`, two launches bit-equal and counted. Timed on the
    same tensors: each kernel L2-cold (the forward without snapshots, as
    serving runs it, and with them), each variant's training pass
    (forward with snapshots plus backward), the plain
    versions, the bound (:func:`mamba_bound`) and the ring kernels' issue
    floor (instructions an element-step of their SASS loop). Returns
    {"fwd", "bwd"}: the main path's numbers (``ring``)."""
    import torch

    from repro_torch.kernels.interface import LAUNCHES, KernelType
    from repro_torch.kernels.mamba_scan import SNAPSHOT_EVERY, ops, plan, \
        scan_bwd, scan_ref

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    b, s_full, d_in, n = JAMBA_SCAN
    out = {}
    # (label, s, dtype, h0, final-state cotangent, A on the lattice, timed)
    for label, s, dtype, state, final, lattice, timed in (
            ("jamba train", s_full, bf16, False, False, True, True),
            ("jamba, h0 and a final cotangent", s_full, bf16, True, True,
             True, False),
            ("jamba f32, h0 and a final cotangent", s_full, f32, True, True,
             True, False),
            ("s 1", 1, bf16, True, True, True, False),
            ("s 17", 17, bf16, False, True, True, False),
            ("s 1000", 1000, bf16, True, False, True, False),
            ("jamba off-lattice A, h0 and a final cotangent", s_full, bf16,
             True, True, False, False),
            ("jamba f32 off-lattice A", s_full, f32, False, False, False,
             False),
            ("s 17 f32 off-lattice A, h0 and a final cotangent", 17, f32,
             True, True, False, False)):
        args = mamba_inputs(b, s, d_in, dtype, gen, state, lattice)
        shape = (f"({b}, {s}, {d_in}, {n}) {str(dtype).split('.')[-1]}, "
                 + ("a given h0" if state else "h0 None") + ", "
                 + ("a final-state cotangent" if final
                    else "no final-state cotangent")
                 + ("" if lattice else ", A off the lattice"))
        if plan(*args) != "ring":
            raise AssertionError(f"mamba_scan {label}: plan picks "
                                 f"{plan(*args)}, not ring")
        dy = torch.randn(b, s, d_in, device=DEVICE, generator=gen).to(dtype)
        dh = (torch.randn(b, d_in, n, device=DEVICE, generator=gen)
              if final else None)
        errs_out = {}
        for variant in ("ring", "simt"):
            every = SNAPSHOT_EVERY[variant]
            tag0 = f"{variant}, snapshots every {every}"
            before = LAUNCHES.get("mamba_scan", 0)
            got = ops._forward(*args, every, dtype, KernelType.CUDA, True,
                               variant=variant)
            again = ops._forward(*args, every, dtype, KernelType.CUDA, True,
                                 variant=variant)
            torch.cuda.synchronize()
            if LAUNCHES["mamba_scan"] != before + 2:
                raise AssertionError(f"mamba_scan {label} {tag0}: launches "
                                     f"{LAUNCHES['mamba_scan'] - before}")
            if not all(torch.equal(x, z) for x, z in zip(got, again)):
                raise AssertionError(f"mamba_scan {label} {tag0}: two "
                                     "launches differ")
            want = scan_ref(*args, segment=every, snapshots=True)
            errs, ok = mamba_errors(got, want)
            tag = (f"mamba_scan {tag0}, {label} {shape}: max abs err y / "
                   f"final state / snapshots "
                   + ", ".join(f"{e:.3g}" for e in errs)
                   + f" (tol {MAMBA_TOL:g} of each scale, bf16 y also 2^-7 "
                   f"of each value), two launches bit-equal")
            if not ok:
                raise AssertionError(f"{tag}: kernel and plain version "
                                     "differ")
            say("kernel", tag)
            bargs = (*args[:5], got[2], dy, dh)
            before = LAUNCHES.get("mamba_scan_bwd", 0)
            got_b = scan_bwd(*bargs, every=every, variant=variant,
                             want_dh0=state)
            again_b = scan_bwd(*bargs, every=every, variant=variant,
                               want_dh0=state)
            torch.cuda.synchronize()
            if LAUNCHES["mamba_scan_bwd"] != before + 2:
                raise AssertionError(f"mamba_scan_bwd {label} {tag0}: "
                                     f"launches "
                                     f"{LAUNCHES['mamba_scan_bwd'] - before}")
            if not all(x is z is None or torch.equal(x, z)
                       for x, z in zip(got_b, again_b)):
                raise AssertionError(f"mamba_scan_bwd {label} {tag0}: two "
                                     "launches differ")
            want_b = scan_bwd(*bargs, segment=every, want_dh0=state,
                              mode="torch")
            errs_b, ok = mamba_errors(got_b, want_b)
            tag = (f"mamba_scan_bwd {tag0}, {label} {shape}: max abs err "
                   f"dxc / ddt / dB / dC / dA" + (" / dh0" if state else "")
                   + " " + ", ".join(f"{e:.3g}" for e in errs_b)
                   + f" (tol {MAMBA_TOL:g} of each scale, bf16 also 2^-7 of "
                   f"each value), two launches bit-equal")
            if not ok:
                raise AssertionError(f"{tag}: kernel and plain version "
                                     "differ")
            say("kernel", tag)
            errs_out[variant] = (max(errs), max(errs_b))
            del got, again, want, got_b, again_b, want_b
        if not timed:
            continue
        out.update(mamba_times(label, args, dy, dh, errs_out))
    release()
    return out


def mamba_times(label, args, dy, dh, errs):
    """The scan's kernels on the same tensors (``args`` at Jamba's
    training shape), L2-cold: each forward variant without and with
    snapshots (at its cadence), each backward, each variant's training
    pass (forward with snapshots plus backward), the plain versions, the
    bound and the ring kernels' issue floor. Returns {"fwd", "bwd"}:
    ``ring``'s numbers, the max abs errors from ``errs`` (variant ->
    (forward's, backward's))."""
    import torch

    from repro_torch.kernels.mamba_scan import BWD_CHANNELS, \
        SNAPSHOT_EVERY, bwd_scratch, launch, launch_bwd, scan_bwd_ref, \
        scan_ref
    from repro_torch.launch.mesh import INSTRUCTION_RATE
    from repro_torch.roofline import kernels as W

    xc = args[0]
    b, s, d_in = xc.shape
    n, dtype = args[4].shape[1], xc.dtype
    ring_every = SNAPSHOT_EVERY["ring"]
    y = torch.empty_like(xc)
    h_out = torch.empty((b, d_in, n), dtype=torch.float32, device=DEVICE)
    fwd_ms, bwd_ms, snap_mb = {}, {}, {}
    for variant in ("ring", "simt"):
        snaps = torch.empty((b, -(-s // SNAPSHOT_EVERY[variant]), d_in, n),
                            dtype=torch.float32, device=DEVICE)
        fwd_ms[variant] = cuda_time_ms(lambda: launch(
            *args, y, h_out, snaps, variant=variant), 20)
        launch(*args, y, h_out, snaps, variant=variant)
        grads = (torch.empty_like(xc), torch.empty_like(xc),
                 torch.empty((b, s, n), dtype=dtype, device=DEVICE),
                 torch.empty((b, s, n), dtype=dtype, device=DEVICE),
                 torch.empty((d_in, n), dtype=torch.float32, device=DEVICE),
                 None)
        scratch = bwd_scratch(xc, variant)
        bwd_ms[variant] = cuda_time_ms(lambda: launch_bwd(
            *args[:5], snaps, dy, dh, grads, scratch, variant=variant), 10)
        snap_mb[variant] = snaps.numel() * 4 / 1e6
        del snaps, grads, scratch
    fwd_plain = {v: cuda_time_ms(lambda: launch(*args, y, h_out,
                                                variant=v), 20)
                 for v in ("ring", "simt")}
    plain_ms = cuda_time_ms(lambda: scan_ref(*args), 3)
    snaps = scan_ref(*args, segment=ring_every, snapshots=True)[2]
    plain_bwd_ms = cuda_time_ms(lambda: scan_bwd_ref(
        *args, dy, dh, snaps=snaps, segment=ring_every), 3)
    del snaps
    fwd = W.mamba_scan(b, s, d_in, n, itemsize=dtype.itemsize,
                       backward=False, state=args[5] is not None)
    f_bound, f_by, f_mb, _ = bound(fwd)
    b_bound, b_by, b_mb, _ = bound(W.mamba_scan(
        b, s, d_in, n, itemsize=dtype.itemsize, backward=True,
        state=args[5] is not None, final=dh is not None))
    exps = fwd.exponentials
    # the ring kernels' issue floor: instructions an element-step of the
    # SASS loop, its element-steps counted by its MUFU.EX2 (the design's
    # exponentials an element-step: 1 forward, 2 backward; the loop holds
    # a full window's or stage's code and the ragged one's)
    floors = {}
    for key, lib, per_step in (("fwd", "mamba_scan_hopper", 1),
                               ("bwd", "mamba_scan_bwd_hopper", 2)):
        loop = sass_loop(lib, "ring_kernelI13__nv_bfloat16E"
                         if dtype == torch.bfloat16 else "ring_kernelIfE")
        if loop is None or not loop[1]:
            floors[key] = "issue floor not measured (no SASS loop found)"
            continue
        steps = loop[1] / per_step
        per = loop[0] / steps
        floor_us = per * exps / INSTRUCTION_RATE * 1e6
        floors[key] = (f"issue floor {floor_us:.1f} us "
                       f"({loop[0]} instructions, {loop[1]} MUFU.EX2, "
                       f"{loop[2]} SHFL in the SASS loop: {per:.2f} "
                       f"instructions, {loop[2] / steps:.2f} SHFL an "
                       f"element-step)")
    for variant in ("ring", "simt"):
        ms = fwd_plain[variant]
        say("kernel", f"mamba_scan {variant} {label}: {ms * 1e3:.1f} us "
            f"L2-cold, {f_bound / ms:.1%} of bound; with snapshots every "
            f"{SNAPSHOT_EVERY[variant]}: {fwd_ms[variant] * 1e3:.1f} us "
            f"({snap_mb[variant]:.1f} MB)"
            + f"; bound {f_bound * 1e3:.1f} us ({f_mb:.1f} MB, {exps:.3g} "
            f"exponentials at 16 a clock an SM; by {f_by})"
            + (f"; {floors['fwd']}" if variant == "ring" else "")
            + f"; plain {plain_ms * 1e3:.1f} us; no library call")
    for variant, ms in bwd_ms.items():
        say("kernel", f"mamba_scan_bwd {variant}, snapshots every "
            f"{SNAPSHOT_EVERY[variant]}, {label}: {ms * 1e3:.1f} us "
            f"L2-cold, {b_bound / ms:.1%} of bound; training pass (forward "
            f"with snapshots + backward) "
            f"{(fwd_ms[variant] + ms) * 1e3:.1f} us; bound "
            f"{b_bound * 1e3:.1f} us ({b_mb:.1f} MB, {exps:.3g} "
            f"exponentials; by {b_by}); scratch: the snapshots "
            f"{snap_mb[variant]:.1f} MB, partial dB/dC of each CTA of "
            f"{BWD_CHANNELS[variant]} channels "
            f"{b * s * -(-d_in // BWD_CHANNELS[variant]) * 32 * 4 / 1e6:.1f} "
            f"MB, partial dA {b * d_in * n * 4 / 1e6:.1f} MB"
            + (f"; {floors['bwd']}" if variant == "ring" else "")
            + f"; plain {plain_bwd_ms * 1e3:.1f} us; no library call")
    return {"fwd": dict(max_abs_err=errs["ring"][0],
                        ms=fwd_plain["ring"], plain_ms=plain_ms,
                        bound_ms=f_bound, bound_by=f_by, library_ms=None),
            "bwd": dict(max_abs_err=errs["ring"][1],
                        ms=bwd_ms["ring"], plain_ms=plain_bwd_ms,
                        bound_ms=b_bound, bound_by=b_by, library_ms=None)}


def phase_jamba_training():
    """jamba-1.5-large-398b cut to JAMBA_TRAIN_LAYERS layers at every
    published width in bf16 (:func:`jamba_cut`: [mamba, attn, mamba], dense
    FFNs; A_log, D and dt_bias float32) through :func:`run_training`:
    flash_attention and flash_attention_bwd exactly 1 a pass (``wgmma``),
    mamba_scan and mamba_scan_bwd exactly 2 a pass, prox_update rounds x
    l_local x 40, no other kernel. Returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan
    from repro_torch.kernels.flash_attention import BWD_VARIANTS, VARIANTS

    cut = jamba_cut(JAMBA_TRAIN_LAYERS)
    cfg = get_config(JAMBA_ARCH).replace(**cut)
    if any(cfg.moe_layer_mask()):
        raise AssertionError(f"{JAMBA_ARCH} {cut}: an MoE FFN")
    kinds = cfg.layer_kinds()
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    n_params, n_leaves = jamba_tree(JAMBA_TRAIN_LAYERS)
    say("train", f"{JAMBA_ARCH} cut to {kinds}, dense FFNs: "
        f"{n_params:,} parameters, {n_leaves} leaves")
    launches, trees = run_training(
        JAMBA_ARCH, n_params, n_leaves,
        {"flash_attention": n_attn, "flash_attention_bwd": n_attn,
         "mamba_scan": n_mamba, "mamba_scan_bwd": n_mamba},
        {"flash_attention variants": (VARIANTS, {"wgmma": n_attn}),
         "flash_attention_bwd variants": (BWD_VARIANTS, {"wgmma": n_attn}),
         "mamba_scan variants": (mamba_scan.VARIANTS, {"ring": n_mamba}),
         "mamba_scan_bwd variants": (mamba_scan.BWD_VARIANTS,
                                     {"ring": n_mamba})},
        cut)
    del trees
    release()
    return launches


def phase_encdec_vlm_training(arch):
    """whisper-small (13r) or qwen2-vl-2b (13s) at every published width
    in bf16, its whole tree (WHISPER_PARAMS or VLM_PARAMS; 35 or 15
    leaves), through :func:`run_training` on :func:`model_batches`:
    flash_attention and flash_attention_bwd exactly 36 a pass (Whisper:
    12 encoder layers non-causal on 1,500 frames, 12 causal self on 448
    tokens, 12 non-causal cross of 448 on 1,500) or 28 (Qwen2-VL: GQA 12:2
    at head_dim 128), every forward and backward ``wgmma``, prox_update
    rounds x l_local x leaves, no other kernel; then
    :func:`full_width_grads_check`. Returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import BWD_VARIANTS, VARIANTS

    cfg = get_config(arch)
    n = cfg.encoder_layers + cfg.num_layers * (
        2 if cfg.is_encoder_decoder else 1)
    n_params = WHISPER_PARAMS if arch == WHISPER_ARCH else VLM_PARAMS
    launches, trees = run_training(
        arch, n_params, ENCDEC_VLM_LEAVES[arch],
        {"flash_attention": n, "flash_attention_bwd": n},
        {"flash_attention variants": (VARIANTS, {"wgmma": n}),
         "flash_attention_bwd variants": (BWD_VARIANTS, {"wgmma": n})})
    del trees
    release()
    full_width_grads_check(arch, n_params, n)
    return launches


def full_width_grads_check(arch, n_params, n_attn):
    """One ``value_and_grad`` of ``arch`` at every published width in bf16
    on its first :func:`model_batches` batch through the kernels (every
    attention forward and backward ``wgmma``, ``n_attn`` of each) and
    through the plain versions (``mode="torch"``), both held to the plain
    path in f32 (the same bf16 parameters and inputs upcast, TF32 off):
    each leaf's kernel-path error within twice the bf16 plain path's
    (FlashAttention's test rule: the kernel rounds no worse than a bf16
    implementation of the same function) plus 1e-6 of the leaf's largest
    f32 gradient, the loss's within twice the plain path's plus 1e-3 of
    it. Prints the largest kernel-vs-plain difference over each leaf's
    scale. Not counted: the training phase's launches were read
    before."""
    import torch

    from repro_torch.flat import tree_leaves
    from repro_torch.kernels.flash_attention import (BWD_VARIANTS, VARIANTS,
                                                     reset_variants)
    from repro_torch.train.optim import tree_map
    from repro_torch.train.trainer import value_and_grad

    cfg, params = draw_full_width(arch, n_params)
    (batch,) = model_batches(cfg, 1, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    # the f32 plain path first, its parameters freed before the bf16 paths
    p32 = tree_map(lambda t: t.float(), params)
    l32, g32 = value_and_grad(
        p32, cfg, {k: v.float() if v.is_floating_point() else v
                   for k, v in batch.items()}, mode="torch")
    del p32
    release()
    reset_variants()
    lk, gk = value_and_grad(params, cfg, batch)
    ran = [{k: c for k, c in d.items() if c} for d in (VARIANTS,
                                                        BWD_VARIANTS)]
    lp, gp = value_and_grad(params, cfg, batch, mode="torch")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bad = []
    if ran != [{"wgmma": n_attn}] * 2:
        bad.append(f"attention variants (forward, backward) {ran}")
    losses = [float(x) for x in (lk, lp, l32)]
    if not (abs(losses[0] - losses[2]) <= 2 * abs(losses[1] - losses[2])
            + 1e-3 * abs(losses[2])):
        bad.append(f"loss {losses}")
    rows = []
    for (path, a), (_, b), (_, w) in zip(*map(tree_leaves, (gk, gp, g32))):
        name, a, b = ".".join(path), a.float(), b.float()
        scale = float(w.abs().max())
        e_k, e_p = (float((t - w).abs().max()) for t in (a, b))
        rows.append((float((a - b).abs().max()) / max(scale, 1e-30), name,
                     e_k, e_p, scale))
        if not e_k <= 2 * e_p + 1e-6 * scale:
            bad.append(f"{name}: {e_k:.3g} against the plain path's "
                       f"{e_p:.3g} (scale {scale:.3g})")
    rows.sort(reverse=True)
    say("consistency", f"{arch} at full width, bf16 value_and_grad: loss "
        f"{losses[0]:.6f} (kernels) / {losses[1]:.6f} (plain) / "
        f"{losses[2]:.6f} (plain, f32); {len(rows)} leaves, each kernel-path "
        f"gradient's error against the f32 path within 2x the bf16 plain "
        f"path's (largest ratio "
        f"{max(r[2] / max(r[3], 1e-30) for r in rows):.3f}); kernel vs "
        f"plain max |diff| over the leaf's scale: " + "; ".join(
            f"{name} {d:.3g} (errors {e_k:.3g} / {e_p:.3g}, scale "
            f"{scale:.3g})" for d, name, e_k, e_p, scale in rows[:4])
        + f"; attention variants {ran[0]} / {ran[1]}; peak "
        f"{peak / 2**30:.2f} GiB")
    if bad:
        raise AssertionError(f"{arch} full-width gradients: kernel path "
                             f"off on {bad[:6]}")
    del params, gk, gp, g32, batch
    release()


def adam_close(got, want, m_got, m_want, lr, tol):
    """(within, max |diff| of the parameters, the share of entries whose
    steps differ by more than ``tol`` through their gradients): AdamW's
    first-step parameters ``got`` vs ``want``, each held within ``tol``
    (abs + rel) plus lr |u(g_got) - u(g_want)|, the part of the step the
    two paths' gradients g = m / (1 - b1) account for (module constant
    ADAM_EPS); the gradients themselves are held by the caller."""
    g, w = got.float(), want.float()
    u = [m / 0.1 for m in (m_got, m_want)]             # adamw's b1 = 0.9
    u = [x / (x.abs() + ADAM_EPS) for x in u]
    step = lr * (u[0] - u[1]).abs()
    diff = (g - w).abs()
    ok = bool((diff <= tol + tol * w.abs() + step).all())
    return ok, float(diff.max()), float((step > tol).float().mean())


def tree_to(tree, device):
    """A parameter tree (nested dicts of tensors) with every tensor on
    ``device`` (the same tensors where they are there already)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def grads_close(a, b, tol):
    """``a`` within ``tol`` of ``b``'s largest value plus ``tol`` of each
    value: two gradients summed in other orders."""
    scale = float(b.abs().max())
    return bool(((a - b).abs() <= tol * scale + tol * b.abs()).all())


def phase_family_consistency(archs=(LLM_ARCH, RWKV_ARCH)):
    """``archs`` (deepseek-moe-16b and rwkv6-7b, each cut to 2 layers; or
    Jamba's 2-layer training cut, :func:`jamba_cut`) at every
    published width, in f32 (TF32 off), from the same parameters through
    the kernels and through the plain versions (``mode="torch"``): one
    ``make_train_step`` with ``adamw()`` (lr 1e-2, grad_clip 1.0): the
    losses and the gradient norm within TRAIN_TOL, the first moments (the
    clipped gradients x 0.1) within TRAIN_TOL of each leaf's largest
    value (:func:`grads_close`), every parameter under
    :func:`adam_close`'s rule;
    then one tier round (l_local 2) from theta = x = the drawn parameters
    and w = the kernel path's stepped ones: the loss and every leaf of
    theta', w', x' within TRAIN_TOL. The MoE layers' router choices are
    recorded at the routing seam and the tokens routed differently
    counted. The f32 MoE path's router backward is the ``logits`` variant
    (``plan_bwd``: the fused kernel takes bf16 x), asserted; Jamba's
    kernel path launches mamba_scan and mamba_scan_bwd once a Mamba layer
    a pass, its plain path neither."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_router
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import optim
    from repro_torch.train.train_state import TrainState
    from repro_torch.train.trainer import make_tier_round, make_train_step

    for arch in archs:
        cfg = get_config(arch).replace(
            **(jamba_cut(JAMBA_TRAIN_CONSISTENCY_LAYERS) if arch == JAMBA_ARCH
               else TRAIN_CONSISTENCY_CUT))
        n_mamba = cfg.layer_kinds().count("mamba")
        torch.cuda.reset_peak_memory_stats()
        params = M.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                               cfg, dtype=torch.float32, device=DEVICE)
        n = sum(t.numel() for t in _leaves(params))
        if n != FAMILY_CONSISTENCY_PARAMS[arch]:
            raise AssertionError(f"{arch} x 2: {n} parameters")
        (batch,) = train_batches(cfg.vocab_size, 1)
        route = moe_mod.route
        ids = {}

        def run(mode, fn):
            calls = ids.setdefault(mode, [])

            def recording(xp, w, **kw):
                res = route(xp, w, **kw)
                calls.append(res[1].detach().sort(1).values)
                return res

            moe_mod.route = recording
            try:
                return fn(mode)
            finally:
                moe_mod.route = route

        # a cut whose f32 tree takes over 8 GB (Jamba's, 11.41 GB) parks
        # the kernel path's results in host memory while the plain path
        # runs: the card holds one path's AdamW step (5 trees) or tier
        # round (about 6) at a time
        park = "cpu" if n * 4 > 8e9 else DEVICE

        def adam_step(mode):
            step = make_train_step(cfg, optim.adamw(),
                                   lr=TRAIN_CONSISTENCY_LR, grad_clip=1.0,
                                   mode=mode)
            st, m = step(TrainState.create(params, optim.adamw()), batch)
            dest = park if mode is None else DEVICE
            return (m["loss"], m["grad_norm"], tree_to(st.params, dest),
                    tree_to(st.opt_state["m"], dest))

        moe_router.reset_variants()
        scans = ("mamba_scan", "mamba_scan_bwd")
        before = {k: LAUNCHES.get(k, 0) for k in scans}
        step_k = run(None, adam_step)
        release()
        router_bwd = {v: c for v, c in moe_router.BWD_VARIANTS.items() if c}
        mid = {k: LAUNCHES.get(k, 0) for k in scans}
        step_p = run("torch", adam_step)
        torch.cuda.synchronize()
        bad, worst, flat = [], 0.0, []
        if arch == LLM_ARCH and set(router_bwd) != {"logits"}:
            bad.append(f"router backward variants {router_bwd}")
        scan_launches = [{k: mid[k] - before[k] for k in scans},
                         {k: LAUNCHES.get(k, 0) - mid[k] for k in scans}]
        if scan_launches != [{k: n_mamba for k in scans},
                             {k: 0 for k in scans}]:
            bad.append(f"selective scan launches (kernel, plain path) "
                       f"{scan_launches}")
        for tag, a, b in (("step loss", step_k[0], step_p[0]),
                          ("grad norm", step_k[1], step_p[1])):
            if not within(a, b, TRAIN_TOL):
                bad.append(tag)
        for i, (a, b) in enumerate(zip(_leaves(step_k[3]),
                                       _leaves(step_p[3]))):
            if not grads_close(a.to(DEVICE), b, TRAIN_TOL):
                bad.append(f"m {i}")
        for i, (a, b, mk, mp) in enumerate(zip(
                _leaves(step_k[2]), _leaves(step_p[2]), _leaves(step_k[3]),
                _leaves(step_p[3]))):
            ok, diff, share = adam_close(a.to(DEVICE), b, mk.to(DEVICE), mp,
                                         TRAIN_CONSISTENCY_LR, TRAIN_TOL)
            worst = max(worst, diff)
            flat.append(share)
            if not ok:
                bad.append(f"step param {i}")
            if share > ADAM_EXCUSED_SHARE:
                bad.append(f"step param {i}: {share:.3%} excused")
        losses = (float(step_k[0]), float(step_p[0]))
        del step_p
        release()
        w_step = tree_to(step_k[2], DEVICE)
        del step_k

        def tier_round(mode):
            out = make_tier_round(cfg, l_local=TRAIN_L_LOCAL, mode=mode,
                                  **TIER_HP)(params, w_step, params, batch)
            return (*(tree_to(t, park if mode is None else DEVICE)
                      for t in out[:3]), out[3])

        rk = run(None, tier_round)
        release()
        rp = run("torch", tier_round)
        torch.cuda.synchronize()
        pairs = [("tier loss", rk[3]["loss"], rp[3]["loss"])]
        for tag, a, b in (("theta'", rk[0], rp[0]), ("w'", rk[1], rp[1]),
                          ("x'", rk[2], rp[2])):
            pairs += [(f"{tag} {i}", ga, gb)
                      for i, (ga, gb) in enumerate(zip(_leaves(a),
                                                       _leaves(b)))]
        round_worst = 0.0
        for tag, a, b in pairs:          # a leaf at a time onto the card
            a = a.to(DEVICE)
            round_worst = max(round_worst, float((a - b).abs().max()))
            if not within(a, b, TRAIN_TOL):
                bad.append(tag)
        del pairs
        flips = sum(int((a != b).any(1).sum())
                    for a, b in zip(ids.get(None, []), ids.get("torch", [])))
        say("consistency", f"{arch} x {cfg.num_layers} layers f32 training "
            f"({n:,} parameters), kernel vs plain path: AdamW step loss "
            f"{losses[0]:.6f} / {losses[1]:.6f}, the first moments within "
            f"{TRAIN_TOL:g} of each leaf's scale, max |diff| of the stepped "
            f"parameters {worst:.3g} (steps whose gradients' difference "
            f"moves them by more than {TRAIN_TOL:g}: {max(flat):.3%} of a "
            f"leaf at most, under {ADAM_EXCUSED_SHARE:.1%}); tier loss "
            f"{float(rk[3]['loss']):.6f} / {float(rp[3]['loss']):.6f}, max "
            f"|diff| over the loss and theta', w', x' {round_worst:.3g} "
            f"(tol {TRAIN_TOL:g} abs + rel)"
            + (f"; {len(ids.get(None, []))} router calls a path, "
               f"{flips} token(s) routed differently, the kernel path's "
               f"router backward {router_bwd} (f32 x)" if ids.get(None)
               else "")
            + (f"; the kernel path's AdamW step launched "
               f"{scan_launches[0]}" if n_mamba else "")
            + f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if bad:
            raise AssertionError(f"{arch} training: kernel and plain paths "
                                 f"disagree on {bad[:8]}"
                                 + (f" ({flips} router flips)" if flips
                                    else ""))
        del rk, rp, params, w_step, batch
        release()


def phase_encdec_vlm_consistency():
    """whisper-small (1 decoder and 1 encoder layer) and qwen2-vl-2b (1
    layer) in f32 at full width, through the kernels and through the plain
    versions on the serving prompts: prefill logits of every position and
    the first decode step's (Whisper's reading the cross K/V its prefill
    cached; Qwen2-VL's at M-RoPE position prompt_len) within 1e-4."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import VARIANTS, reset_variants
    from repro_torch.models import model as M

    for arch, cut, prompts, max_len in (
            (WHISPER_ARCH, dict(num_layers=1, encoder_layers=1),
             whisper_prompts, WHISPER_MAX_LEN),
            (VLM_ARCH, dict(num_layers=1), vlm_prompts, LLM_MAX_LEN)):
        cfg = get_config(arch).replace(**cut)
        params = M.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                               cfg, dtype=torch.float32, device=DEVICE)
        batch = prompts(cfg, torch.float32)
        s = prompt_len(batch)
        tok = torch.randint(0, cfg.vocab_size, (LLM_BATCH, 1), device=DEVICE,
                            generator=torch.Generator(DEVICE).manual_seed(2),
                            dtype=torch.int32)
        dec_batch = {"tokens": tok}
        if cfg.family == "vlm":
            dec_batch["mrope_positions"] = torch.full(
                (LLM_BATCH, 1, 3), s, dtype=torch.int32, device=DEVICE)
        runs = {}
        reset_variants()
        for mode in (None, "torch"):
            with torch.inference_mode():
                cache = M.init_cache(cfg, LLM_BATCH, max_len,
                                     dtype=torch.float32, device=DEVICE)
                pre, cache = M.prefill(params, cfg, batch, cache, mode=mode)
                dec, _ = M.decode_step(params, cfg, cache, dec_batch, s,
                                       mode=mode)
            runs[mode] = (pre, dec)
            del cache
        torch.cuda.synchronize()
        # f32: every call on the simt kernel (Whisper: the encoder's, then
        # each layer's self and cross in the prefill and in the decode step)
        n = cfg.num_layers
        calls = (cfg.encoder_layers + 4 * n if cfg.is_encoder_decoder
                 else 2 * n)
        if VARIANTS != {"wgmma": 0, "split_kv": 0, "simt": calls}:
            raise AssertionError(f"{arch} f32 consistency: flash_attention "
                                 f"variants {VARIANTS}")
        for step, i in (("prefill", 0), ("decode", 1)):
            # the vocabulary's padding columns are -1e30 in both
            got, want = (runs[m][i][..., :cfg.vocab_size]
                         for m in (None, "torch"))
            err = float((got - want).abs().max())
            say("consistency", f"{arch} x 1 layer f32, {step} "
                f"({got.shape[0] * got.shape[1]} positions): kernel vs plain "
                f"path, max |logit diff| {err:.3g} (tol 1e-4; logits up to "
                f"{float(want.abs().max()):.3g})")
            if not err <= 1e-4:
                raise AssertionError(f"{arch} {step}: kernel and plain paths "
                                     "disagree")
        del runs, params
        release()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def kept_sets(idx, pos, t, num_experts, cap):
    """Per token (first ``t`` rows of the router's padded rows): the set of
    experts it is routed to and the set it is kept by, its positions
    ``pos`` under capacity ``cap``."""
    import torch

    sel = torch.nn.functional.one_hot(idx.long(), num_experts).float()
    kept = (sel * (pos < cap)[..., None]).sum(1)[:t] > 0
    routed = sel.sum(1)[:t] > 0
    return routed, kept


def phase_llm_consistency(arch=LLM_ARCH, cut=None, n_params=None):
    """The serving path cut to 1 layer (``arch`` with ``cut`` replaced; a
    single MoE layer) in f32, through the kernels and through the plain
    versions: prefill logits of every position and the first decode
    step's, under the flip rule of the module docstring. ``n_params``:
    the cut's parameters in the reference's tree, checked if given."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_router import positions_ref
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import block_pattern

    cfg = get_config(arch).replace(**(cut or dict(num_layers=1)))
    m = cfg.moe
    if sum(cfg.moe_layer_mask()) != 1:
        raise ValueError(f"{arch} {cut}: one MoE layer, not "
                         f"{sum(cfg.moe_layer_mask())}")
    params = M.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                           dtype=torch.float32, device=DEVICE)
    n = sum(t.numel() for t in _leaves(params))
    if n_params is not None and n != n_params:
        raise AssertionError(f"{arch} {cut}: {n} parameters, the "
                             f"reference's tree has {n_params}")
    layers = f"{cfg.num_layers} layer" + "s" * (cfg.num_layers > 1)
    if cfg.family == "hybrid":
        layers += f" {block_pattern(cfg)[1]}, {n:,} parameters"
    prompts = llm_prompts(cfg.vocab_size)
    tok = torch.randint(0, cfg.vocab_size, (LLM_BATCH, 1), device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(2),
                        dtype=torch.int32)
    from repro_torch.kernels.interface import LAUNCHES

    route = moe_mod.route
    runs, scans = {}, {}
    for mode in (None, "torch"):
        calls = []
        before = LAUNCHES.get("mamba_scan", 0)

        def recording(xp, w, **kw):
            res = route(xp, w, **kw)
            calls.append((xp, w, res[1], res[2]))
            return res

        moe_mod.route = recording
        try:
            with torch.inference_mode():
                cache = M.init_cache(cfg, LLM_BATCH, LLM_MAX_LEN,
                                     dtype=torch.float32, device=DEVICE)
                pre, cache = M.prefill(params, cfg, {"tokens": prompts},
                                       cache, mode=mode)
                dec, _ = M.decode_step(params, cfg, cache, {"tokens": tok},
                                       LLM_PROMPT, mode=mode)
        finally:
            moe_mod.route = route
        runs[mode] = (pre, dec, calls)
        scans[mode] = LAUNCHES.get("mamba_scan", 0) - before
        del cache
    torch.cuda.synchronize()
    n_mamba = cfg.layer_kinds().count("mamba")
    if scans != {None: n_mamba, "torch": 0}:
        raise AssertionError(f"{arch} {cut}: mamba_scan launches (kernel, "
                             f"plain path) {scans}, expected {n_mamba}, 0")
    if n_mamba:
        say("consistency", f"{arch} x {layers}: the kernel path's prefill "
            f"launched mamba_scan {scans[None]} time(s)")
    for step, which, t, gs in (("prefill", 0, LLM_BATCH * LLM_PROMPT,
                                min(1024, LLM_BATCH * LLM_PROMPT)),
                               ("decode", 1, LLM_BATCH, LLM_BATCH)):
        got, want = runs[None][which], runs["torch"][which]
        got, want = got.reshape(t, -1), want.reshape(t, -1)
        _, _, idx_k, pos_k = runs[None][2][which]
        xp, w, idx_p, pos_p = runs["torch"][2][which]
        if not torch.equal(pos_k, positions_ref(idx_k, gs, m.num_experts)):
            raise AssertionError(f"{step}: the kernel's pos is not "
                                 "positions_ref of its own ids")
        cap = moe_mod._capacity(gs, m.num_experts, m.top_k,
                                m.capacity_factor)
        r_k, kept_k = kept_sets(idx_k, pos_k, t, m.num_experts, cap)
        r_p, kept_p = kept_sets(idx_p, pos_p, t, m.num_experts, cap)
        flipped = (r_k != r_p).any(1)
        displaced = (kept_k != kept_p).any(1) & ~flipped
        agree = ~flipped & ~displaced
        err = (got[agree] - want[agree]).abs().max()
        probs = torch.softmax((xp.float() @ w)[:t], dim=-1)
        top = probs.topk(m.top_k + 1, dim=-1).values
        gaps = (top[:, m.top_k - 1] - top[:, m.top_k])[flipped]
        flips = flipped.nonzero()[:, 0]
        lone = [i for i in displaced.nonzero()[:, 0].tolist()
                if not bool(((flips < i) & (flips // gs == i // gs)).any())]
        say("consistency", f"{arch} x {layers} f32, {step} ({t} tokens): "
            f"kernel vs plain path, max |logit diff| over the {int(agree.sum())}"
            f" agreeing tokens {float(err):.3g} (tol 1e-4); flipped "
            f"{int(flipped.sum())} (tie gaps in the plain run "
            f"{[float(x) for x in gaps]}), displaced {int(displaced.sum())}")
        if not float(err) <= 1e-4:
            raise AssertionError(f"{arch} {step}: kernel and plain paths "
                                 "disagree")
        if len(gaps) and not float(gaps.max()) <= 1e-5:
            raise AssertionError(f"{arch} {step}: a flip off a tie ({gaps})")
        if lone:
            raise AssertionError(f"{arch} {step}: tokens {lone} displaced "
                                 "without an earlier flip in their group")
    del runs, params
    release()


def phase_rwkv_consistency():
    """rwkv6-7b cut to 1 layer in f32, through the kernel and through the
    plain version: prefill logits of every position and the first decode
    step's within 1e-4."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    from repro_torch.kernels.rwkv6_scan import VARIANTS, reset_variants

    cfg = get_config(RWKV_ARCH).replace(num_layers=1)
    params = M.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                           dtype=torch.float32, device=DEVICE)
    reset_variants()
    prompts = llm_prompts(cfg.vocab_size)
    tok = torch.randint(0, cfg.vocab_size, (LLM_BATCH, 1), device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(2),
                        dtype=torch.int32)
    runs = {}
    for mode in (None, "torch"):
        with torch.inference_mode():
            cache = M.init_cache(cfg, LLM_BATCH, LLM_MAX_LEN,
                                 dtype=torch.float32, device=DEVICE)
            pre, cache = M.prefill(params, cfg, {"tokens": prompts}, cache,
                                   mode=mode)
            dec, _ = M.decode_step(params, cfg, cache, {"tokens": tok},
                                   LLM_PROMPT, mode=mode)
        runs[mode] = (pre, dec)
        del cache
    torch.cuda.synchronize()
    if VARIANTS != {"chunked": 0, "simt": 2}:     # f32: the sequential scan
        raise AssertionError(f"{RWKV_ARCH} f32 consistency: rwkv6_scan "
                             f"variants {VARIANTS}")
    for step, i in (("prefill", 0), ("decode", 1)):
        got, want = runs[None][i], runs["torch"][i]
        err = float((got - want).abs().max())
        say("consistency", f"{RWKV_ARCH} x 1 layer f32, {step} "
            f"({got.shape[0] * got.shape[1]} positions): kernel vs plain "
            f"path, max |logit diff| {err:.3g} (tol 1e-4; logits up to "
            f"{float(want.abs().max()):.3g})")
        if not err <= 1e-4:
            raise AssertionError(f"{RWKV_ARCH} {step}: kernel and plain "
                                 "paths disagree")
    del runs, params
    release()


def profile_serving(arch, patched, nested, keys, decode_steps,
                    make_prompts=None, max_len=LLM_MAX_LEN, cut=None):
    """Where a serving path's time goes, ``arch`` at full width in bf16
    (its config with ``cut`` replaced; drawn anew), on the batch
    ``make_prompts(cfg)`` (default the token prompts) in a cache of
    ``max_len``. One prefill and ``decode_steps`` decode steps (at
    position prompt_len) with the functions ``patched`` [(module, name,
    part)] each timed on the host clock between synchronizes (a part may
    be a function of the call's arguments that names it, or None for a
    call left untimed; a part ``nested`` {outer: inner parts}
    has its inner parts' time taken out; "rest" is what no part covers:
    norms, residuals, embedding), printing the medians over ``keys``;
    then one decode step and one prefill under torch.profiler: the
    device's busy share and time by kernel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch).replace(**(cut or {}))
    params = M.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                           dtype=torch.bfloat16, device=DEVICE)
    prompts = (make_prompts(cfg) if make_prompts
               else {"tokens": llm_prompts(cfg.vocab_size)})
    s = prompt_len(prompts)
    dec_batch = {"tokens": prompts["tokens"][:, -1:] if "tokens" in prompts
                 else torch.zeros(LLM_BATCH, 1, dtype=torch.int32,
                                  device=DEVICE)}
    if cfg.family == "vlm":
        dec_batch["mrope_positions"] = torch.full(
            (LLM_BATCH, 1, 3), s, dtype=torch.int32, device=DEVICE)
    spent = {}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]

    def timed(fn, key):
        def run(*args, **kw):
            part = key(*args) if callable(key) else key
            if part is None:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[part] = spent.get(part, 0.0) + time.perf_counter() - t0
            return out
        return run

    def one(fn):
        spent.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        parts = {k: spent.get(k, 0.0) for k in keys if k != "rest"}
        for outer, inner in nested.items():
            parts[outer] -= sum(parts[k] for k in inner)
        parts["rest"] = wall - sum(parts.values())
        return wall, parts

    with torch.inference_mode():
        cache = M.init_cache(cfg, LLM_BATCH, max_len,
                             dtype=torch.bfloat16, device=DEVICE)
        prefill = lambda: M.prefill(params, cfg, prompts, cache,
                                    last_only=True)
        decode = lambda: M.decode_step(params, cfg, cache, dec_batch, s)
        prefill()
        decode()                                        # warm-up
        for mod, name, key in patched:
            setattr(mod, name, timed(getattr(mod, name), key))
        try:
            rows = [("prefill", *one(prefill))]
            for i in range(decode_steps):
                rows.append(("decode", *one(decode)))
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        for step in ("prefill", "decode"):
            got = [r for r in rows if r[0] == step]
            wall = sorted(r[1] for r in got)[len(got) // 2]
            med = {k: sorted(r[2][k] for r in got)[len(got) // 2]
                   for k in keys}
            say("profile", f"{arch} {step} (median of {len(got)}, "
                f"synchronized parts, host clock): {wall * 1e3:.2f} ms = "
                + ", ".join(f"{k} {med[k] * 1e3:.2f} ms ({med[k] / wall:.0%})"
                            for k in keys))
        for step, fn in (("decode", decode), ("prefill", prefill)):
            fn()
            _, wall, ev = profiled(fn)
            busy = sum(e.self_device_time_total for e in ev) / 1e6
            say("profile", f"{arch} {step} under torch.profiler: "
                f"{wall * 1e3:.2f} ms host clock, kernels {busy * 1e3:.2f} ms "
                f"of device time (busy {busy / wall:.1%}), "
                f"{sum(e.count for e in ev)} kernel launches")
            for e in ev[:10]:
                say("profile", f"{arch} {step} "
                    f"{e.self_device_time_total / 1e3:9.2f} ms {e.count:5d}x  "
                    f"{e.key[:90]}")
    del params, cache
    release()


def phase_llm_profile(decode_steps=8):
    """``--profile`` of deepseek-moe-16b serving: the attention layer with
    its projections, the routing seam (``moe.route``: the fused router
    kernel), the rest of the MoE layer, the head (:func:`profile_serving`)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod

    profile_serving(
        LLM_ARCH, [(attn_mod, "attn_prefill", "attention"),
                   (attn_mod, "attn_decode", "attention"),
                   (moe_mod, "moe_apply", "moe"),
                   (moe_mod, "route", "router"),
                   (M, "_logits_out", "head")],
        {"moe": ("router",)}, ("attention", "router", "moe", "head", "rest"),
        decode_steps)


def phase_rwkv_profile(decode_steps=8):
    """``--profile`` of rwkv6-7b serving: the time mix's GEMMs and
    elementwise ops ("time mix"), its decay LoRA, the WKV scan (the
    kernel and its wrapper), the channel mix, the head
    (:func:`profile_serving`)."""
    from repro_torch.models import model as M
    from repro_torch.models import rwkv as rwkv_mod

    profile_serving(
        RWKV_ARCH, [(rwkv_mod, "timemix_apply", "time mix"),
                    (rwkv_mod, "_decay", "decay LoRA"),
                    (rwkv_mod, "wkv", "WKV"),
                    (rwkv_mod, "channelmix_apply", "channel mix"),
                    (M, "_logits_out", "head")],
        {"time mix": ("decay LoRA", "WKV")},
        ("time mix", "decay LoRA", "WKV", "channel mix", "head", "rest"),
        decode_steps)


def phase_whisper_profile(decode_steps=8):
    """``--profile`` of whisper-small serving: the encoder, the decoder's
    self-attention layer and its cross-attention (each with its
    projections), the SwiGLU MLP, the head (:func:`profile_serving`)."""
    import torch

    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tr_mod

    profile_serving(
        WHISPER_ARCH, [(tr_mod, "encoder_apply", "encoder"),
                       (attn_mod, "attn_prefill", "self-attention"),
                       (attn_mod, "attn_decode", "self-attention"),
                       (tr_mod, "_cross_attention", "cross-attention"),
                       (layers_mod, "swiglu_apply", "mlp"),
                       (M, "_logits_out", "head")],
        {}, ("encoder", "self-attention", "cross-attention", "mlp", "head",
             "rest"), decode_steps,
        lambda cfg: whisper_prompts(cfg, torch.bfloat16), WHISPER_MAX_LEN)


def phase_vlm_profile(decode_steps=8):
    """``--profile`` of qwen2-vl-2b serving: the attention layer with its
    projections and M-RoPE, the SwiGLU MLP, the head
    (:func:`profile_serving`)."""
    import torch

    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import model as M

    profile_serving(
        VLM_ARCH, [(attn_mod, "attn_prefill", "attention"),
                   (attn_mod, "attn_decode", "attention"),
                   (layers_mod, "swiglu_apply", "mlp"),
                   (M, "_logits_out", "head")],
        {}, ("attention", "mlp", "head", "rest"), decode_steps,
        lambda cfg: vlm_prompts(cfg, torch.bfloat16))


def phase_jamba_profile(decode_steps=8):
    """``--profile`` of the Jamba cut's serving: each Mamba mixer's parts
    (its in_proj and out_proj products, the conv, the SSM parameters'
    products and softplus, the scan (a decode step's recurrence step),
    the rest of the mixer: the chunk, the gate, the cache writes), the
    attention layer with its projections, the routing seam (the fused
    router kernel), the rest of the MoE layer, the SwiGLU MLP, the head
    (:func:`profile_serving`)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod

    cfg = get_config(JAMBA_ARCH)
    d_in = cfg.mamba_expand * cfg.d_model

    def projection(a, w):
        if tuple(w.shape) == (cfg.d_model, 2 * d_in):
            return "in_proj"
        return "out_proj" if tuple(w.shape) == (d_in, cfg.d_model) else None

    mixer = ("in_proj", "conv", "SSM params", "scan", "out_proj")
    profile_serving(
        JAMBA_ARCH, [(mamba_mod, "mamba_apply", "mamba"),
                     (mamba_mod, "mamba_decode", "mamba"),
                     (mamba_mod, "_mm", projection),
                     (mamba_mod, "_conv", "conv"),
                     (mamba_mod, "_conv_step", "conv"),
                     (mamba_mod, "_ssm_params", "SSM params"),
                     (mamba_mod, "_scan", "scan"),
                     (mamba_mod, "_step", "scan"),
                     (attn_mod, "attn_prefill", "attention"),
                     (attn_mod, "attn_decode", "attention"),
                     (moe_mod, "moe_apply", "moe"),
                     (moe_mod, "route", "router"),
                     (layers_mod, "swiglu_apply", "mlp"),
                     (M, "_logits_out", "head")],
        {"mamba": mixer, "moe": ("router",)},
        ("mamba",) + mixer + ("attention", "router", "moe", "mlp", "head",
                              "rest"),
        decode_steps, cut=JAMBA_CUT)


def phase_round_times(reps):
    """``reps`` unprofiled rounds of the CNN cell per variant (uncompressed
    and each lossy compressor), in one order and then the reverse, each
    from a synchronized card to a synchronized card on the host clock;
    and the host time of each round spent inside ``compress_flat_ef``
    (issuing the uplinks' compression, no synchronize). Prints the
    medians and ranges; returns {variant: median seconds}."""
    import torch

    from repro_torch.comm import CommConfig
    from repro_torch.core import permfl as P
    from repro_torch.scenarios import build_scenario

    b = build_scenario(SCENARIO, seed=3, device=DEVICE)
    hp = b.scenario.algo.hparams()
    variants = (None,) + tuple(COMPRESS_KERNEL)
    cfgs = {c: None if c is None else CommConfig(c) for c in variants}
    states = {c: P.init_state(b.params0, b.m, b.n, comm=cfgs[c])
              for c in variants}
    spent = [0.0]
    compress = P.compress_flat_ef

    def timed_compress(*args, **kw):
        t0 = time.perf_counter()
        out = compress(*args, **kw)
        spent[0] += time.perf_counter() - t0
        return out

    def one_round(c):
        return P.permfl_round(states[c], b.train, hp, b.loss_fn,
                              m_teams=b.m, n_devices=b.n, comm=cfgs[c])

    walls = {c: [] for c in variants}
    inside = {c: [] for c in variants}
    P.compress_flat_ef = timed_compress
    try:
        for c in variants:                               # warm-up
            one_round(c)
        for rep in range(reps):
            for c in (variants if rep % 2 == 0 else variants[::-1]):
                torch.cuda.synchronize()
                spent[0] = 0.0
                t0 = time.perf_counter()
                one_round(c)
                torch.cuda.synchronize()
                walls[c].append(time.perf_counter() - t0)
                inside[c].append(spent[0])
    finally:
        P.compress_flat_ef = compress
    out = {}
    for c in variants:
        w, i = sorted(walls[c]), sorted(inside[c])
        out[c] = w[reps // 2]
        say("rounds", f"[{c or 'uncompressed'}] {reps} rounds, alternating "
            f"order: median {out[c]:.4f} s host clock (min {w[0]:.4f}, max "
            f"{w[-1]:.4f}); inside compress_flat_ef median "
            f"{i[reps // 2] * 1e3:.2f} ms")
    base = out[None]
    say("rounds", "median minus uncompressed median: " + ", ".join(
        f"{c} {(out[c] - base) * 1e3:+.1f} ms" for c in variants[1:]))
    return out


def phase_profile(comp=None):
    """One more round under torch.profiler (uncompressed, or with
    compressor ``comp``): device time by kernel and the device's busy
    share of the round's host-clock time."""
    import torch

    from repro_torch.comm import CommConfig
    from repro_torch.core import permfl as P
    from repro_torch.scenarios import build_scenario

    b = build_scenario(SCENARIO, seed=2, device=DEVICE)
    hp = b.scenario.algo.hparams()
    cfg = None if comp is None else CommConfig(comp)
    state = P.init_state(b.params0, b.m, b.n, comm=cfg)

    def one_round():
        return P.permfl_round(state, b.train, hp, b.loss_fn, m_teams=b.m,
                              n_devices=b.n, comm=cfg)

    one_round()                                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    _, wall, rows = profiled(one_round)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    tag = f"[{comp or 'uncompressed'}]"
    say("profile", f"one round {tag}: {plain_wall:.3f} s host clock "
        f"unprofiled, {wall:.3f} s profiled; kernels {busy:.3f} s of device "
        f"time, busy {busy / plain_wall:.1%} of the unprofiled round "
        f"({busy / wall:.1%} of the profiled one); "
        f"{sum(e.count for e in rows)} kernel launches")
    for e in rows[:15 if comp is None else 8]:
        say("profile", f"{tag} {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


def start_dryrun():
    """Phase 14 (a), started beside the card's phases: ``python -m
    repro_torch.launch.dryrun --all`` (every architecture x input shape
    on fake tensors: no allocation, no card) as a process of its own with
    no CUDA device visible and one thread, its records to DRYRUN_OUT and
    its output to a log beside them. Returns (the process, its log)."""
    out = ROOT / DRYRUN_OUT
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", str(out)], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    return proc, log


def phase_dryrun(proc, log):
    """Phase 14 (a): wait for the dry run started by :func:`start_dryrun`
    and print one line a record: the counted FLOPs and bytes, the roofline
    terms on the H100's peaks, each kernel family's launches, the peak
    bytes and whether they fit one card. Every combination ran: none
    FAILED, only DRYRUN_SKIPPED skipped. Returns the seconds waited."""
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=900)
    finally:
        log.close()
    waited = time.perf_counter() - t0
    tail = (ROOT / DRYRUN_OUT).with_suffix(".log").read_text()
    if rc != 0:
        raise AssertionError(f"dryrun --all exited {rc}:\n{tail[-4000:]}")
    records = json.loads((ROOT / DRYRUN_OUT).read_text())
    for r in records:
        tag = f"{r['arch']} x {r['shape']} x {r['mesh']}"
        if r["status"] != "ok":
            why = r.get("reason") or r.get("error")
            say("dryrun", f"{tag}: {r['status']} ({why})")
            continue
        mem = r["bytes_per_device"]
        say("dryrun", f"{tag}: {r['flops'] / 1e12:.2f} TFLOP, "
            f"{r['hbm_bytes'] / 1e9:.1f} GB moved; compute "
            f"{r['compute_s']:.3g} s, memory {r['memory_s']:.3g} s "
            f"({r['dominant']}-bound, useful {r['useful_ratio']:.2f}); "
            f"argument {mem['argument'] / 1e9:.2f} GB, peak "
            f"{mem['peak'] / 1e9:.2f} GB "
            f"({'fits' if r['fits'] else 'does not fit'} "
            f"{r['hbm_capacity'] / 1e9:.0f} GB); kernels "
            f"{ {k: v['launches'] for k, v in r['kernels'].items()} }; "
            f"traced in {r['trace_s']} s")
    failed = [(r["arch"], r["shape"]) for r in records
              if r["status"] == "FAILED"]
    skipped = {(r["arch"], r["shape"]) for r in records
               if r["status"] == "skipped"}
    if len(records) != DRYRUN_COMBOS or failed or skipped != DRYRUN_SKIPPED:
        raise AssertionError(f"dryrun --all: {len(records)} records, failed "
                             f"{failed}, skipped {sorted(skipped)}")
    say("dryrun", tail.strip().splitlines()[-1] + f" (ran beside the card's "
        f"phases; waited {waited:.1f} s for it here)")
    return waited


def real_args(arch, cfg, kind, fake_args):
    """The step's arguments on the card, drawn from seeds 0 and 1, each
    leaf of the fake arguments' shape and dtype: train (theta, w, mom,
    batch) -- two parameter draws, float32 zeros, tokens and targets;
    prefill (params, batch, cache) -- a parameter draw, tokens, a zeroed
    cache."""
    import torch

    from repro_torch.models import model as M

    def params(seed):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        return M.init_params(gen, cfg, dtype=torch.bfloat16, device=DEVICE)

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    tokens = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                               generator=gen, device=DEVICE, dtype=v.dtype)
              for k, v in fake_args[-1 if kind == "train" else 1].items()}
    if kind == "train":
        theta = params(0)
        args = (theta, params(1), _tree_zeros_f32(theta), tokens)
    else:
        b, s = tokens["tokens"].shape
        args = (params(0), tokens, M.init_cache(cfg, b, s, torch.bfloat16,
                                                device=DEVICE))
    mine, want = _shapes(args), _shapes(fake_args)
    if mine != want:
        raise AssertionError(f"{arch} {kind}: the card's arguments "
                             f"differ from the dry run's: "
                             f"{set(mine) ^ set(want)}")
    return args


def _tree_zeros_f32(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_zeros_f32(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def _shapes(tree, path=""):
    """[(path, shape, dtype)] of a tree of tensors (tuples and dicts)."""
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _shapes(v, f"{path}/{i}")]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shapes(tree[k],
                                                         f"{path}/{k}")]
    return [(path, tuple(tree.shape), str(tree.dtype))]


def phase_launch_steps():
    """Phase 14 (b): each of LAUNCH_STEPS built by the dry run's
    ``build_step_and_args`` at the LM cells' size (TRAIN_BATCH x
    TRAIN_SEQ tokens, every published width): phi3-mini's PerMFL device
    step (a remat forward and backward, then ``prox_sgd_tree``) and
    deepseek-moe-16b's prefill. Each runs once on fake tensors and once on
    the card, both under the op counter, the launch counts set to 0 just
    before the card's run and read just after. Held: the argument bytes
    equal to the byte, the counted FLOPs and each seam's launches equal,
    the card's launches each seam's, every kernel of LAUNCH_KERNELS
    launched, every bf16 attention forward on a Hopper variant (phi3's 64
    at head_dim 96 and deepseek's 28 on wgmma, none on simt). Printed: the
    predicted peak (the fake run's) against ``max_memory_allocated`` and
    their ratio, and the step's synchronized time (the median of
    STEP_REPS runs without the counter) against the larger of its
    roofline's compute and memory terms. Returns the launches."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import InputShape, get_config
    from repro_torch.kernels.flash_attention import VARIANTS, reset_variants
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.launch.dryrun import build_step_and_args, card_mesh
    from repro_torch.roofline import (analyze, model_flops_decode,
                                      model_flops_train)
    from repro_torch.roofline.op_analysis import analyze_ops

    total = {}
    for arch, kind in LAUNCH_STEPS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        shape = InputShape(f"{kind}_{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH,
                           kind)
        fm = FakeTensorMode()
        step, fake_args, _, _ = build_step_and_args(cfg, shape, card_mesh(),
                                                    fake_mode=fm)
        with fm:
            fake = analyze_ops(step, *fake_args)
        t_fake = time.perf_counter() - t0
        release()
        args = real_args(arch, cfg, kind, fake_args)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_variants()
        real = analyze_ops(step, *args)
        torch.cuda.synchronize()
        launches = {k: c for k, c in LAUNCHES.items() if c}
        variants = {k: c for k, c in VARIANTS.items() if c}
        measured = torch.cuda.max_memory_allocated()
        seams = {k: v["launches"] for k, v in real["kernels"].items()}
        tag = f"{arch} {kind} ({TRAIN_BATCH} x {TRAIN_SEQ})"
        checks = {
            "argument bytes": (fake["argument_bytes"],
                               real["argument_bytes"]),
            "FLOPs": (fake["flops"], real["flops"]),
            "seam launches": ({k: v["launches"] for k, v in
                               fake["kernels"].items()}, seams),
            "the card's launches": (seams, launches)}
        for what, (want, got) in checks.items():
            if want != got:
                raise AssertionError(f"{tag}: {what} differ between the fake "
                                     f"and the card's run: {want} vs {got}")
        if any(not launches.get(k) for k in LAUNCH_KERNELS[kind]):
            raise AssertionError(f"{tag}: kernels {LAUNCH_KERNELS[kind]} not "
                                 f"all launched: {launches}")
        if variants != {"wgmma": launches["flash_attention"]}:
            raise AssertionError(f"{tag}: flash_attention variants "
                                 f"{variants}, expected every one wgmma")
        for k, c in launches.items():
            total[k] = total.get(k, 0) + c
        times = []
        for _ in range(STEP_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            del out
        step_s = sorted(times)[len(times) // 2]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        mflops = (model_flops_train if kind == "train"
                  else model_flops_decode)(cfg, tokens)
        roof = analyze(real, model_flops=mflops)
        floor = max(roof.compute_s, roof.memory_s)
        say("launch", f"{tag}: fake and card runs agree: argument "
            f"{real['argument_bytes']:,} B, {real['flops']:,.0f} FLOPs, "
            f"launches {launches} (flash_attention {variants}); bytes "
            f"counted {fake['hbm_bytes'] / 1e9:.3f} GB on fake tensors, {real['hbm_bytes'] / 1e9:.3f} GB on the "
            f"card; {fake['aten_ops']} / {real['aten_ops']} aten ops")
        say("launch", f"{tag}: peak predicted {fake['peak_bytes'] / 2**30:.2f}"
            f" GiB (the card's run counted {real['peak_bytes'] / 2**30:.2f} "
            f"GiB), max_memory_allocated {measured / 2**30:.2f} GiB "
            f"(arguments and what stayed from earlier phases "
            f"{base / 2**30:.2f} GiB): measured / predicted "
            f"{measured / fake['peak_bytes']:.3f}")
        say("launch", f"{tag}: {step_s * 1e3:.1f} ms synchronized (median of "
            f"{STEP_REPS}: {', '.join(f'{t * 1e3:.1f}' for t in times)}); "
            f"roofline {roof.summary()}: compute {roof.compute_s * 1e3:.2f} "
            f"ms, memory {roof.memory_s * 1e3:.2f} ms "
            f"({real['hbm_bytes'] / 1e9:.1f} GB), the step at "
            f"{floor / step_s:.1%} of its roofline; traced on fake tensors "
            f"in {t_fake:.1f} s, the phase {time.perf_counter() - t0:.1f} s"
            f"; {smi_line()}")
        del args, step, fake_args, real
        release()
    return total


def load_example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counted_example(label, fn, *args, **kw):
    """``fn(*args, **kw)`` on the card with every launch count set to 0
    just before and read just after; prints its host-clock seconds and
    launches on a line of its own. Returns (its result, the launches)."""
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: c for k, c in LAUNCHES.items() if c}
    say("examples", f"{label}: {sec:.3f} s (host clock, synchronized), "
        f"launches {launches}")
    return out, launches


def forced_margins(cfg, params, prompt, toks):
    """The plain path's greedy margins along the card's tokens ``toks``
    (b, new): the prefill and each decode step through the kernels' plain
    versions on the card, fed the card's tokens, each step's (b,) margin
    max(logits) - logits[the card's token]; 0 where the plain path chose
    the same token."""
    import torch

    from repro_torch.models import model as M

    b, new = toks.shape
    first = prompt["embeds"] if "embeds" in prompt else prompt["tokens"]
    plen = first.shape[1]
    margins = []
    with torch.inference_mode():
        cache = M.init_cache(cfg, b, plen + new, dtype=torch.float32,
                             device=toks.device)
        logits, cache = M.prefill(params, cfg, prompt, cache,
                                  last_only=True, mode="torch")
        for i in range(new):
            lg = logits[:, -1].float()
            margins.append(lg.max(-1).values
                           - lg.gather(1, toks[:, i:i + 1].long())[:, 0])
            if i == new - 1:
                break
            batch = {"tokens": toks[:, i:i + 1]}
            if cfg.family == "vlm":
                batch["mrope_positions"] = torch.full(
                    (b, 1, 3), plen + i, dtype=torch.int32,
                    device=toks.device)
            logits, cache = M.decode_step(params, cfg, cache, batch,
                                          plen + i, mode="torch")
    return torch.stack(margins, 1)


def phase_examples():
    """Phase 15 (the module docstring): the port's example counterparts
    on the card. Returns their launches."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model as M
    from repro_torch.scenarios import get_scenario, run_scenario
    from repro_torch.serve.llm import VOCAB, prompts

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    t_phase = time.perf_counter()
    # quickstart, at its 10 rounds
    qs = load_example("quickstart_torch")
    # every PerMFL run of the phase takes the default hyperparameters
    hp = get_scenario("table1/mnist/mclr/permfl").algo.hparams()
    (res, res_c, t_full, t_comp), launches = counted_example(
        "quickstart_torch.py", qs.quickstart,
        rounds=EXAMPLE_QUICKSTART_ROUNDS, device=DEVICE)
    add(launches)
    r = EXAMPLE_QUICKSTART_ROUNDS
    check_launches(launches, {"prox_update": 4 * r * hp.k_team * hp.l_local,
                              "ef_topk": 2 * r * (hp.k_team + 1)},
                   "quickstart_torch.py")
    summary = res_c.comm.summary()
    if not res.pm_acc[-1] > res.gm_acc[-1]:
        raise AssertionError(f"quickstart: PM {res.pm_acc[-1]} not above GM "
                             f"{res.gm_acc[-1]}")
    if not summary["total_bytes"] < summary["uncompressed_bytes"]:
        raise AssertionError(f"quickstart: compressed bytes {summary}")
    full_s, comp_s = (t.timeline.total_seconds() for t in (t_full, t_comp))
    if not comp_s < full_s:
        raise AssertionError(f"quickstart: top-10% {comp_s} simulated s, "
                             f"fp32 {full_s}")
    cpu = run_scenario("comm/mnist/mclr/topk_10", rounds=r, device="cpu")
    if cpu.comm.summary() != summary:
        raise AssertionError(f"quickstart: link bytes {summary} on the "
                             f"card, {cpu.comm.summary()} on the CPU")
    say("examples", f"quickstart: PM {res.pm_acc[-1]:.4f} > GM "
        f"{res.gm_acc[-1]:.4f}; {summary['total_bytes']:,} B moved < "
        f"{summary['uncompressed_bytes']:,} B at fp32, every link-byte field "
        f"equal to the CPU run's; wan-cellular {comp_s:.2f} < {full_s:.2f} "
        f"simulated s")

    # federated_benchmark, at its defaults and with the paper's CNN
    fb = load_example("federated_benchmark_torch")
    out_dir = ROOT / "build" / "examples"
    out_dir.mkdir(parents=True, exist_ok=True)
    for extra in EXAMPLE_BENCHMARKS:
        csv_path = out_dir / f"curves{'_'.join(extra)}.csv"
        argv = list(extra) + ["--out", str(csv_path)]
        label = ("federated_benchmark_torch.py "
                 + (" ".join(extra) or "(its defaults)"))
        (perm, fed), launches = counted_example(label, fb.main, argv)
        add(launches)
        # PerMFL's device steps; FedAvg's plain SGD launches no kernel
        check_launches(launches, {"prox_update": perm.rounds * hp.k_team
                                  * hp.l_local}, label)
        rows = csv_path.read_text().splitlines()[1:]
        vals = [float(v) for row in rows for v in row.split(",")[1:]]
        if len(rows) != perm.rounds or not all(
                math.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f"federated_benchmark: curves {rows}")

    # serve_model, the five cache families, then the personalized store
    sm = load_example("serve_model_torch")
    for arch, expect in EXAMPLE_SERVE.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            toks, launches = counted_example(
                f"serve_model_torch.py --arch {arch}", sm.main,
                ["--arch", arch])
        print(buf.getvalue(), end="", flush=True)
        add(launches)
        cfg = get_reduced_config(arch).replace(vocab_size=VOCAB)
        head = buf.getvalue().splitlines()
        line = next(ln for ln in head if ln.startswith("arch="))
        if line != (f"arch={arch} family={cfg.family} cache="
                    f"{sm.cache_kind(cfg)}"):
            raise AssertionError(f"serve_model: {line}")
        check_launches(launches, expect, f"serve_model {arch}")
        if toks.shape != (4, EXAMPLE_SERVE_NEW) or \
                toks.dtype != torch.int32 or \
                not bool(((toks >= 0) & (toks < VOCAB)).all()):
            raise AssertionError(f"serve_model {arch}: tokens {toks}")
        # the example's weights and prompts, redrawn: the plain path's
        # choice along the card's tokens
        params = M.init_params(0, cfg, device=DEVICE)
        prompt = prompts(cfg, 4, 32, torch.Generator(
            device=DEVICE).manual_seed(1))
        margins = forced_margins(cfg, params, prompt, toks)
        worst = float(margins.max())
        if not worst <= EXAMPLE_TIE:
            raise AssertionError(f"serve_model {arch}: the card chose a "
                                 f"token {worst} below the plain path's")
        say("examples", f"{arch}: {int((margins == 0).sum())} of "
            f"{margins.numel()} tokens the plain path's choice, the rest "
            f"within {worst:.2e} of it")
        del params
        release()
    store = out_dir / "permfl_store.zip"
    (rows, nbytes), launches = counted_example(
        "serve_model_torch.py --personalized", sm.personalized_demo,
        path=str(store), device=DEVICE)
    add(launches)
    check_launches(launches, {"prox_update": 2 * hp.k_team * hp.l_local},
                   "--personalized")
    want = sm.personalized_demo(path=str(out_dir / "permfl_store_cpu.zip"),
                                device="cpu")
    if (rows, nbytes) != want or [t for _, _, t, _ in rows] != [
            "device", "device", "team", "global"]:
        raise AssertionError(f"--personalized: {rows}, {nbytes} B on the "
                             f"card; {want} on the CPU")
    say("examples", f"phase 15 took {time.perf_counter() - t_phase:.1f} s; "
        f"launches {total}")
    return total


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    dryrun = start_dryrun()
    try:
        return run_phases(argv, t_start, dryrun)
    finally:
        if dryrun[0].poll() is None:
            dryrun[0].kill()
            dryrun[0].wait()


def run_phases(argv, t_start, dryrun) -> int:
    """Phases 3 to 17 (the module docstring), the dry run of phase 14 (a)
    already running beside them."""
    import torch

    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.configs.paper_mclr import CONFIG as MCLR
    from repro_torch.flat import Layout
    from repro_torch.models.paper_models import init_params
    from repro_torch.scenarios import get_scenario

    d = get_scenario(SCENARIO).data
    gen = torch.Generator().manual_seed(0)
    layout = Layout.of(init_params(CNN, gen))
    checks = phase_kernel_check(layout, d.m_teams, d.n_devices)
    checks.update(phase_compress_check([
        ("cnn LAN", layout, d.m_teams * d.n_devices),
        ("cnn WAN", layout, d.m_teams),
        ("mclr LAN", Layout.of(init_params(MCLR, gen)),
         d.m_teams * d.n_devices)]))
    res, launches = phase_main_path()
    launches.update(phase_comm_paths())
    phase_consistency()
    launches["quantize"] += phase_serving(res)
    baselines = phase_baselines()
    phase_baseline_consistency()
    phase_baseline_serving(*baselines["table1/mnist/cnn/ditto"])
    del baselines
    phase_families()
    phase_sweeps()
    c = get_scenario(COHORT_CELLS[-1])
    checks["cohort"] = phase_kernel_check(
        Layout.of(init_params(c.model_config(), gen)), c.data.m_teams,
        c.cohort_size)["f32"]
    for k, v in phase_cohort().items():
        launches[k] = launches.get(k, 0) + v
    phase_system()
    phase_telemetry(res)
    attn = phase_attention_check()
    phase_router_check()
    router = phase_fused_router_check()
    scan = phase_rwkv_check()
    launches.update(phase_llm_serving())
    phase_llm_consistency()
    launches.update(phase_rwkv_serving())
    phase_rwkv_consistency()
    t_ev = time.perf_counter()
    for counts in (phase_whisper_serving(), phase_vlm_serving()):
        launches["flash_attention"] += counts["flash_attention"]
    t_cons = time.perf_counter()
    phase_encdec_vlm_consistency()
    say("llm", f"whisper-small and qwen2-vl-2b: serving phases "
        f"{t_cons - t_ev:.1f} s, consistency {time.perf_counter() - t_cons:.1f}"
        f" s")
    t_jamba = time.perf_counter()
    for k, v in phase_jamba_serving().items():
        launches[k] = launches.get(k, 0) + v
    t_cons = time.perf_counter()
    phase_llm_consistency(JAMBA_ARCH, JAMBA_CONSISTENCY_CUT,
                          JAMBA_CONSISTENCY_PARAMS)
    t_prof = time.perf_counter()
    phase_jamba_profile()
    say("llm", f"{JAMBA_ARCH}: serving phase {t_cons - t_jamba:.1f} s, "
        f"consistency {t_prof - t_cons:.1f} s, profile "
        f"{time.perf_counter() - t_prof:.1f} s")
    t_train = time.perf_counter()
    attn_bwd = phase_attention_bwd_check()
    t_path = time.perf_counter()
    for k, v in phase_llm_training().items():
        launches[k] = launches.get(k, 0) + v
    t_cons = time.perf_counter()
    phase_training_consistency()
    say("train", f"{TRAIN_ARCH}: backward check {t_path - t_train:.1f} s, "
        f"training phase {t_cons - t_path:.1f} s, consistency "
        f"{time.perf_counter() - t_cons:.1f} s")
    t_train = time.perf_counter()
    family_bwd = phase_family_bwd_check()
    t_path = time.perf_counter()
    for phase in (phase_moe_training, phase_rwkv_training):
        for k, v in phase().items():
            launches[k] = launches.get(k, 0) + v
    t_cons = time.perf_counter()
    phase_family_consistency()
    say("train", f"{LLM_ARCH} and {RWKV_ARCH}: backward checks "
        f"{t_path - t_train:.1f} s, training phases {t_cons - t_path:.1f} s,"
        f" consistency {time.perf_counter() - t_cons:.1f} s")
    t_train = time.perf_counter()
    mamba = phase_mamba_check()
    t_path = time.perf_counter()
    for k, v in phase_jamba_training().items():
        launches[k] = launches.get(k, 0) + v
    t_cons = time.perf_counter()
    phase_family_consistency((JAMBA_ARCH,))
    say("train", f"{JAMBA_ARCH}: scan check {t_path - t_train:.1f} s, "
        f"training phase {t_cons - t_path:.1f} s, consistency "
        f"{time.perf_counter() - t_cons:.1f} s")
    t_train = time.perf_counter()
    for arch in (WHISPER_ARCH, VLM_ARCH):
        for k, v in phase_encdec_vlm_training(arch).items():
            launches[k] = launches.get(k, 0) + v
    t_cons = time.perf_counter()
    for arch in (WHISPER_ARCH, VLM_ARCH):
        phase_training_consistency(arch)
    say("train", f"{WHISPER_ARCH} and {VLM_ARCH}: training phases and "
        f"full-width gradients {t_cons - t_train:.1f} s, consistency "
        f"{time.perf_counter() - t_cons:.1f} s")
    t_serve = time.perf_counter()
    launches["flash_attention"] += phase_phi3_serving()["flash_attention"]
    say("llm", f"{TRAIN_ARCH}: serving phase "
        f"{time.perf_counter() - t_serve:.1f} s")
    t_launch = time.perf_counter()
    waited = phase_dryrun(*dryrun)
    for k, v in phase_launch_steps().items():
        launches[k] = launches.get(k, 0) + v
    say("launch", f"phase 14 added {time.perf_counter() - t_launch:.1f} s "
        f"(of it {waited:.1f} s waiting for the dry run) and the sweep mesh "
        f"check of phase 7c")
    for k, v in phase_examples().items():
        launches[k] = launches.get(k, 0) + v
    if "--profile" in argv:
        phase_llm_profile()
        phase_rwkv_profile()
        phase_whisper_profile()
        phase_vlm_profile()
        phase_round_times(ROUND_REPS)
        for comp in (None,) + tuple(COMPRESS_KERNEL):
            phase_profile(comp)
        phase_baseline_profile()
        phase_sweep_profile()
    checks["prox_update"] = checks["f32"]
    # the JSON line carries each LLM kernel at the serving path's prefill
    # shape; the decode shape's numbers are on the lines above
    checks["flash_attention"] = attn["deepseek prefill"]
    checks["moe_router"] = router["prefill"]         # the fused kernel
    checks["rwkv6_scan"] = scan["prefill"]
    checks["flash_attention_bwd"] = attn_bwd["phi3 train"]
    # the backward kernels at the MoE and RWKV-6 training paths' shapes
    checks["moe_router_bwd"] = family_bwd["router"]
    checks["rwkv6_scan_bwd"] = family_bwd["wkv train"]
    # the selective scan at Jamba's training shape (the forward as serving
    # runs it, without snapshots)
    checks["mamba_scan"] = mamba["fwd"]
    checks["mamba_scan_bwd"] = mamba["bwd"]
    say("done", f"{time.perf_counter() - t_start:.1f} s")
    src = "src/repro_torch/kernels/"
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": src + KERNEL_SOURCE.get(name, "compress/csrc/compress.cu"),
        "replaces": TPU_KERNEL[name], "launches": launches[name],
        "max_abs_err": checks[name]["max_abs_err"],
        "ms": checks[name]["ms"], "plain_ms": checks[name]["plain_ms"],
        "bound_ms": checks[name]["bound_ms"],
        "bound_by": checks[name]["bound_by"],
        "library_ms": checks[name].get("library_ms")}
        for name in TPU_KERNEL]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
