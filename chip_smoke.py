#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU: the STrack fabric (with
RoCEv2, PFC, chaos, the active set, collectives, sweeps and the chaos
soak beside the event oracle), then LM serving:
llama3-8b at full width through the flash-attention kernel, mamba2-2.7b
(16 of its 64 layers) and zamba2-2.7b at full width through the SSD scan
kernel (and zamba2's shared attention through the flash kernel), the
MoE models mixtral-8x22b (its window and decode ring) and grok-1-314b at
full width, depth cut, through the flash kernel, and whisper-small (full
size: its encoder and cross-attention) and internvl2-26b (full width,
depth cut) through the flash kernel; then training: mamba2-2.7b (16
layers) through the SSD scan kernel and its backward kernel, and
llama3-8b (2 layers), at full width through ``make_train_step``.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the six CUDA kernel sources (nvcc, sm_90a) from src/repro_torch;
  2. hold each fabric kernel against its plain PyTorch version on the card
     (ints and bools exact, float32 bit for bit): at perm1024 and perm8k
     shapes captured a few ticks into the run; at incast1024 ticks where
     the standing queue drops, marks ECN on the dither and sends flows into
     SACK recovery (each of these must happen, or the check fails as
     vacuous); the transition on random flow states at 1024 lanes, where
     RTOs fire, probes go out and flows enter recovery; and the ranker at
     M = 255 ... 32768 (off the main paths: its work runs inside
     serve_enqueue's kernel);
  2b. both transitions (STrack, RoCEv2), serve_enqueue and pfc_account run
     one device operation a call, their own kernel and no memset (a call
     captured in a CUDA graph is one node, the wrapper's kernel), on the
     dense, PFC (and STrack's PFC NIC gate), fault and active-set paths;
     torch.profiler's times of these calls are the kernels line's device
     times of those wrappers and paths;
  3. goldens perm16_strack / incast8_strack (tests/golden/*.json) through
     repro_torch.sim.workloads.run on the card;
  4. the main path at full width: perm1024 (1024 hosts, 64 KiB, 400 Gbps)
     with launch counts reset before and read after, held exactly against
     src/repro_torch/testdata/perm1024_strack_ref.json (made by the JAX
     package); then incast1024 (256 of those hosts send 16 KiB each to
     host 0) held against incast1024_strack_ref.json the same way: drops,
     ECN marks, retransmits, SACK recoveries, every done tick;
  5. scale: perm8k (8192 hosts) must finish every flow;
  6. serve_enqueue against its plain version on perm1024 tick 16 made
     hard (every lane into one row: buckets past the fixed slots; every
     row's tail at the ring's last slots: placements wrap); the launch
     floors; fabric kernel times and bounds at the perm1024 shapes (the
     profiler's taken right after phase 2, before its records thin out);
  6b. RoCEv2 (DCQCN + go-back-N) and PFC on the fabric:
     (a) the RoCEv2 transition kernel, the PFC NIC gate of the STrack
         transition, serve/enqueue's paused rows and the PFC stage
         (pfc_account) against their plain versions on the card, exact:
         at 19 ticks of incast1024 under RoCEv2 + PFC (switch ports pause,
         rows are gated and ungated, CNPs cut rates; the transition again
         on the same inputs with every other NIC paused, which must hold
         back offers), at ticks of incast1024 under STrack + PFC, of 4x4
         incasts with a 200 KB buffer (paused NICs hold back offers) and of
         a 15-sender STrack incast on a 2 us network (probes of paused NICs
         withheld), and on random RoCEv2 and STrack flow states at 1024
         lanes with half the NICs paused (RTOs, DCQCN timers, byte-counter
         stages, rewinding NACKs, blocked probes must all occur); the
         one-bucket and wrap-around ticks on incast1024 RoCEv2 tick 100,
         with the PFC stage on each;
     (b) goldens perm16_roce / incast8_roce;
     (c) perm1024 and incast1024 under RoCEv2 + PFC, incast1024 under
         lossy RoCEv2 and under STrack + PFC, each with the launch counts
         reset before and read after (exactly its path's kernels launch),
         held exactly against its JAX-made reference file in
         src/repro_torch/testdata/;
     (d) perm8k under RoCEv2 must finish every flow;
     (e) a [fabric] line: STrack against RoCEv2, FCTs and wall times;
     then the new kernels' device times (CUDA-graph replays), bounds and
     plain versions' times at incast1024's shapes;
  6c. chaos on the fabric, perm1024 under CHAOS1024 (repro_torch.profile:
     a link flap, a permanent uplink flap, a host flap, a link at a
     quarter rate, a corrupting link and a corrupting host link):
     (a) serve_enqueue's fault branches against its plain version on the
         card, exact, at ticks of both the STrack and the RoCEv2 + PFC run
         that must show a down row popping into the blackhole, a
         duty-closed row with a ready head, a corrupted survivor and a
         spared survivor on a corrupting row; on random fault rows at the
         captured ring (each input alone too); the kernel's splitmix64
         draw against fault_u01 on a grid of keys (negative psns, ticks
         near 2^30); the one-bucket and wrap-around ticks at tick 28;
     (b) goldens perm16_flap_strack / perm16_flap_roce;
     (c) perm1024 under CHAOS1024 with STrack and with RoCEv2 + PFC, and
         linkdown1024 (128 dead uplinks) as t=0 uplink flaps, each held
         exactly against its JAX-made reference file (blackholed and
         corrupted packets, the flap windows' retransmits among the keys),
         each launching exactly its path's kernels;
     (d) serve_enqueue's fault path timed (`fault_*` fields);
  6d. the active set (active_cap) on open-loop inference traffic:
     infer1024 (repro_torch.profile.infer1024_scenario: four inference
     tenants of traffic.mixed_scenario, 4096 flows on the perm1024 fabric,
     at most 328 live at once) at active_cap=512:
     (a) the active transitions (STrack, RoCEv2), the lane-mapped
         serve/enqueue, the ranker and the PFC stage with the lanes'
         sources against their plain versions on the card, exact, on the
         slates of dense ticks of the capped runs (padded lanes; at tick
         1400 the slate holds flow N-1 beside padding), once more with
         every other NIC paused (and, under PFC, every third switch row
         and the state's NIC bits), at tick 400 of the run capped at 320
         (the slate full to its last lane), on the slate [0, N/2, N-1,
         padding] and on a slate of padding only, on the one-bucket and
         wrap-around ticks of tick 400's lanes (with the PFC stage under
         RoCEv2), and on the capped staggered 15-sender STrack + PFC
         incast of tests/test_torch_active_pfc.py (probes of paused NICs
         withheld);
     (b) infer1024 at the cap under STrack and RoCEv2 + PFC, and uncapped
         under STrack, each launching exactly its path's kernels (the
         active transition, never the dense one, under the cap), held
         exactly against src/repro_torch/testdata/infer1024_*_ref.json;
     (c) the run capped at 320 raises RuntimeError with JAX's overflow
         tick count (95), the one error caught;
     (d) wall time a trip capped and uncapped, device launches a tick,
         the new kernels' times and bounds at A = 512;
  6e. dependency-scheduled collectives and sub-flow striping
     (repro_torch.profile.COLLECTIVE1024 on the perm1024 fabric: hd1024,
     eight HD allreduces of 128 ranks and 128 KiB, 14,336 messages;
     a2a1024, 32 all-to-alls of 32 ranks with window 8, 31 flows a
     source):
     (a) goldens ring8_strack / ring8_roce4 / a2a_strack;
     (b) the transitions, serve_enqueue and (under PFC, against its plain
         version on the CPU) pfc_account against their plain versions on
         the card, exact: at hd1024 ticks where completions release
         children and the children first offer (STrack; RoCEv2 + PFC at
         four sub-flows, 56 stripes a source), at a2a1024 ticks where
         sources of 31 flows hold gated and offering flows, at ticks of a
         small-buffer all-to-all of 16 ranks at four sub-flows under
         RoCEv2 + PFC whose NICs pause (stripes of a message withheld
         behind them; pauses must occur), and the active kernels at ticks
         of allreduce8k's spot cell at active_cap=48; each case must
         occur; the collective ticks' one device operation a call is
         phase 2b's;
     (c) hd1024 under STrack (dense, and at active_cap=1024 against the
         same file), under RoCEv2 + PFC at four sub-flows, a2a1024 under
         STrack and the spot cell at its cap, each launching exactly its
         path's kernels, held exactly against its JAX-made file in
         src/repro_torch/testdata/ (every summary key, the per-group
         table, done ticks, each message's release and done tick, the
         trace's digest);
     (d) a [collective] line: STrack against the 4-QP RoCEv2 on hd1024,
         wall, warp trips, launches a trip, max_collective_time;
     (e) the `collective_*` fields of the transitions', serve_enqueue's
         and pfc_account's entries: device ms at the collective ticks,
         wall, plain and bound;
  6f. the experiment front door's batch (sweep(), run_fabric_trace_batch)
     and the per-tick trace, on full_bisection(32, 32) at 400 Gbps:
     (a) sweep() of perm1024 seeds 0-7 under STrack (warp on) as one
         batch, the launch counts reset before and read after (only the
         batched STrack transition and serve/enqueue launch), each entry
         equal to its solo run on the card (every state leaf, the
         summary, warp trips) and to the JAX-made
         perm1024_sweep8_strack_ref.json, seed 0 to
         perm1024_strack_ref.json;
     (b) sweep() of perm1024 under RoCEv2 + PFC at roce_entropy_seed 0-3
         the same way, against perm1024_sweep4_rocev2_ref.json;
     (c) perm1024 seed 0 with trace_queues and trace_every=4 over 512
         ticks against perm1024_trace4_strack_ref.json: integer rows and
         the delivered rows' bits by sha256, cwnd_mean within
         TRACE_CWND_RTOL, queue_settle_us exact (and at 0.5 and 1 us);
     (d) the four batched calls at B = 8 against their batched plain
         versions (the PFC stage's on the CPU) at dense ticks of perm1024
         STrack and RoCEv2 + PFC programs and of incast1024 under RoCEv2
         + PFC where ports pause, every entry stepping and the odd
         entries frozen (which must come out as they went in); at B = 1
         the unbatched calls' bits; each batched call one device
         operation a call (timed after phase 2b, while the profiler keeps
         its records);
     (e) printed, no claim: the sweeps' walls against their solo runs,
         launches and host ms a trip at B = 1 and 8, the batched calls'
         device ms; the `*_batch` kernels entries;
  6g. the observatory's chaos soak and the event oracle (SOAK_FLEET, the
     64-host default fleet of benchmarks/soak.py, seed 0; also alone with
     `--phase 6g`):
     (a) soak() over a clean epoch (the inert schedule) and a CHAOS1024
         epoch on one program, held exactly against the JAX-made
         soak64_chaos2_strack_ref.json: the return dict, each epoch's run()
         summary, the .prom text byte for byte; one program build; each
         epoch launching exactly the transition and serve/enqueue, one of
         each a trip, the fault rows acting in the chaos epoch only;
     (b) the transition and serve/enqueue against their plain versions at
         SOAK_TICKS of the chaos epoch (down rows popping, messages and
         collective children released, corrupted packets), exact; device
         launches a dense tick of each epoch from torch.profiler;
     (c) the event oracle on the host (the fleet's epoch 0 clean and under
         CHAOS1024; SPOT_FLEET under STrack and RoCEv2) against the
         JAX-made events64_ref.json, every summary key;
     (d) the tenant spot check: SPOT_FLEET's fabric run on the card against
         (c)'s oracle, p50 and p99 of each tenant inside SPOT_BAND;
     (e) printed: per-epoch wall, warp trips, trips/s, launches; the
         `soak_*` fields of the transition's and serve/enqueue's entries;
  7. serve: llama3-8b, bf16, attn_impl="pallas", random weights from a
     CUDA generator (seed 0; 16 GB):
     (a) the flash-attention kernel against its plain version on the card
         at the q/k/v of layers 0 and 31 of both prefills below (the tc
         route), at decode with q_offset 0, 511 and 543 (the decode
         route), and on random inputs (non-causal, window 96, MQA, f32 and
         f32 queries on bf16 k/v on the fma route, head dims 64 and 16,
         ragged Tq = Tk = 100; the tc route's edges: Tq = 1000 = 7 x 128 +
         104, Tk past the last kv tile, q_offset 50 at Tq 100, window 96
         at Tq 600, hd 16 / 64 / 80, a row with no live key; the decode
         route's: B = 1 at Tq = 1..4, MQA, hd 80 with a window, f32, a row
         with no live key): 2e-5 in f32, 2e-2 in bf16, each call on the
         route kernels.flash_attention._route names for it;
     (b) prefill of 4 x 1000 tokens and 1 x 4096: finite logits, within
         SERVE_REL_L2 of the same model with attention through the plain
         version;
     (c) greedy_generate of 4 requests (512-token prompts, 32 new tokens,
         cache 544): the decode logits at the last prompt position (the
         kernel with q_offset) within SERVE_REL_L2 of make_prefill_step's,
         and greedy_generate's tokens equal to a step-by-step decode's;
     (d) the llama3-8b SMOKE config in f32 against the JAX-made
         src/repro_torch/testdata/llama3_smoke_serve_ref.json (1e-4; the
         bf16-cache decode 2e-2);
     the serve path (both prefills and greedy_generate) runs once more with
     the launch count reset before and read after (by route: both bf16
     prefills on tc, every decode step on decode, fma never; fma runs only
     in the f32 checks and the SMOKE prefill): prefill tokens/s, decode ms
     per step, peak memory;
  8. serve, Mamba2 (the llama3 weights freed first): mamba2-2.7b (16 of
     its 64 layers, MAMBA2_LAYERS, ~1.8 GB) and zamba2-2.7b (54 layers
     and the shared block,
     attn_impl="pallas"), bf16, random weights (seed 0):
     (b) mamba2 prefill 4 x 1024 and 1 x 4096 through the SSD kernel:
         finite, within SERVE_REL_L2 of the same model with the plain SSD
         (and, the rounding floor, within SSM_REL_L2 of the same model at
         chunk 64); decode against prefill at the last prompt position
         (SSM_REL_L2); the tokens of
         greedy_generate (4 requests, 512-token prompts, 32 new) equal to
         a step-by-step decode's;
     (c) zamba2 prefill 4 x 1024 through both kernels against both plain
         versions (SSM_REL_L2); the flash kernel against its plain version at hd 80 on
         the q/k/v of the first and last application of the shared block
         (tc) and at decode offsets 0, 63, 79 (decode); a short
         greedy_generate (4 x 64 prompt tokens, 16 new) equal to a
         step-by-step decode, every prefill call on tc and every decode
         call on decode;
     (a) the SSD kernel (four chunk-parallel launches, float32 FMAs in
         the plain version's order) against its plain version, y and
         final state, on the
         captured inputs of layer 0 and the last layer of mamba2's
         prefills and layer 0 of zamba2's, on the cases of
         tests/test_kernels.py in f32 and bf16, at T = 45 (an odd L), at
         T = 960 in 20 ragged chunks of 48 (P = 72, N = 20), and at
         T = 128 against the sequential ssd_ref: 1e-4 in f32, 5e-2 in
         bf16;
     (d) the f32 SMOKE configs of both against the JAX-made
         src/repro_torch/testdata/{mamba2,zamba2}_smoke_serve_ref.json
         (SSM_SMOKE_TOL; greedy tokens exact);
     each serve path runs once more with the launch counts reset before
     and read after: prefill tokens/s, decode ms per step, peak memory;
  9. serve, MoE (phase 8's weights freed first; `python3 chip_smoke.py
     --phase 9` runs the build and this phase alone, ~1.5 minutes of
     chip time): mixtral-8x22b (4 of 56 layers, ~21 GB) and grok-1-314b (2 of
     64, ~23 GB) at full width (MOE_MODELS), bf16, attn_impl="pallas",
     random weights from a CUDA generator (seed 0):
     (b) prefills, mixtral 4 x 1024 and 1 x 8192 (16 MoE groups; the tc
         route masks keys more than 4096 back), grok 4 x 1024: finite,
         and against the same model with attention through the plain
         version (in blocks of PLAIN_ROWS query rows) row by row
         (routed_alike): a row routed to the same experts in every layer
         within SERVE_REL_L2, any other row on a router near tie (a gate
         gap of at most TIE_GAP at its first differing layer; bf16 router
         logits tie often), at least half the rows alike; the tokens
         routed otherwise logged by layer;
     (c) generate, mixtral 4 x (512 + 32) with cache_len 512 (a ring of
         512 slots that wraps at position 512), grok 4 x (64 + 16): the
         decode logits at the last prompt position (mixtral: 511, where
         the ring of 512 has not wrapped and attends what a cache of 544
         would) against a prefill at capacity factor E / k = 4, which
         must drop no (token, slot) pair, row by row as in (b);
         greedy_generate's tokens equal to a step-by-step decode's;
     (a) the flash kernel against its plain version at FA_TOL on the
         captured q/k/v of the first and last layer of every prefill
         (tc, mixtral's with its window) and of mixtral's decode at
         positions 0, 511, 512 and 542 (the decode route on the ring:
         slots never written, full, wrapped), and on one random call on
         a ring of 4096 at position 4159 (B 4, H 48, K 8, hd 128);
     (d) both f32 SMOKE configs against the JAX-made
         src/repro_torch/testdata/{mixtral,grok}_smoke_serve_ref.json:
         prefill, decode of every prompt position through mixtral's ring
         (SMOKE_TOL), greedy tokens exact;
     (e) the kernel's times at mixtral's prefill-8192 (tc with the
         window) and on the rings of 512 and 4096 (decode), SDPA's with a
         boolean mask on the first backend that takes it;
     each serve path runs once more with the launch counts reset before
     and read after (every bf16 prefill call on tc, every decode call on
     decode, fma never): prefill tokens/s, decode ms per step, peak
     memory;
  10. serve, encoder-decoder and vision-language (phase 9's weights freed
     first; `python3 chip_smoke.py --phase 10` runs the build and this
     phase alone): whisper-small at full size (12 + 12 layers, d 768, 12
     heads of 64, 1500 frames) and internvl2-26b at full width (8 of 48
     layers, INTERNVL2_LAYERS, ~8.5 GB; 256 patch embeddings), bf16,
     attn_impl="pallas", random weights from a CUDA generator (seed 0):
     (b) prefills, whisper 4 x 448 tokens with 4 x 1500 frames (its
         encoder tc non-causal at 1500 x 1500, its cross-attention tc at
         448 x 1500), internvl2 4 x (256 + 768) and 1 x (256 + 3840):
         finite, within SERVE_REL_L2 of the same model with attention
         through the plain version, and more than SERVE_REL_L2 away from
         the same prefill with the frames or patches zeroed;
     (c) whisper decode of 4 x 64 prompt tokens with cache["enc_out"]
         assigned from encode: at the last prompt position within
         SERVE_REL_L2 of the prefill with the frames (the cross decode on
         the decode route: G 1, one row, 1500 keys, non-causal);
         greedy_generate (4 x (64 + 32), cache 96, its fresh cache's
         zero enc_out: ROADMAP C20, logged) equal to a step-by-step
         decode;
     (d) internvl2 text-only decode of 4 x 512 against a text-only
         prefill at position 511; greedy_generate (4 x (512 + 32)) equal
         to a step-by-step decode;
     (a) the flash kernel against its plain version at FA_TOL on the
         captured calls (encoder layers 0 and 11, the prefill's self and
         cross calls, the decode's at position 63, internvl2's layers 0
         and 7 in both prefills and at decode position 511) and on random
         calls: tc non-causal at 1500 x 1500 and 448 x 1500, decode
         non-causal at 1 x 1500;
     (e) each serve path once more with the launch counts reset before
         and read after: every prefill call on tc, every decode call on
         decode, fma never; prefill tokens/s, decode ms per step, peak
         memory;
     (f) both f32 SMOKE configs against the JAX-made
         src/repro_torch/testdata/{whisper,internvl2}_smoke_serve_ref.json
         (SMOKE_TOL; whisper's decode with enc_out zero and assigned;
         greedy tokens exact; the prefills on fma, decode on decode);
     the kernel's times at the new calls (`4tc-nc`, `4tc-x`, `4dec-x`,
     `4tc-v`) and one layer's cross K/V, which decode_step recomputes
     from enc_out at every step;
  11. training (phase 10's weights freed first; `python3 chip_smoke.py
     --phase 11` runs the build and this phase alone, ~1.5 minutes of
     chip time): (a) the SSD scan's backward kernel (ssd_scan_bwd: five
     launches, q, pass, w, dx and dbc; float32, sums in a fixed order, W
     summed over head groups, no per-head dB or dC) against its plain twin
     (autograd through the plain scan) at mamba2-2.7b's layer shape (B 4,
     T 1024, H 80, P 64, N 128, chunk 128) and zamba2-2.7b's (N 64), each
     of dx, ddt, dA, dB, dC within SSD_TOL["float32"] of the twin's
     largest magnitude, two calls equal bits; its device ms (and by
     pass), the twin's, the bound, its scratch MB (the allocator's peak
     over a call less the gradients); (b) mamba2-2.7b
     (MAMBA2_LAYERS), bf16 over f32 masters, remat "full", 3 steps of 4
     x 1024 synthetic tokens through make_train_step with the launch
     counts reset before and read after
     (ssd_scan_bwd once a layer a step, ssd_scan twice: forward and
     recompute; the flash kernel never), the backward kernel against the
     twin again at the inputs of the step's first backward call, then
     the same 3 steps through the plain scan: step 1's losses equal bits,
     steps 2-3 within TRAIN_TWIN_REL; step 1's gradient through the
     kernels against the plain scan's, leaf by leaf within TRAIN_GRAD_CTL
     of the control (the plain scan at chunk 64); ms a step, tokens/s (the last
     step's: the caching allocator has its blocks by then), peak memory;
     (c) llama3-8b (TRAIN_LLAMA3_LAYERS) with chunked attention (chunk
     512), 3 steps of 4 x 1024: step 1's loss within (0.1, 3) ln V, as
     test_smoke_loss holds it; tokens/s, peak memory; (d) the f32 SMOKE
     configs of llama3-8b (2 micro-batches), mamba2-2.7b (both SSD
     kernels), mixtral-8x22b (gradient compression) and whisper-small, 4
     steps each, tokens, loss, grad_norm and lr against the JAX-made
     src/repro_torch/testdata/*_smoke_train_ref.json (TRAIN_TOL); (e)
     TrainSupervisor on mamba2 SMOKE f32 over 6 steps with a failure at
     step 3: params and optimizer state equal the uninterrupted run's
     bit for bit, restarted in the same process and, after a failure
     that ends the run, in a fresh process (`--train-resume`, PyTorch's
     deterministic mode), which also reruns mixtral SMOKE's compressed
     steps to (d)'s bits;
  12. a `kernels` JSON line (launches on the main paths; each kernel's
     device time per call from torch.profiler, and the wrapper's wall time
     per call; the plain version's device and wall time; the bound; for
     the transitions, serve_enqueue and pfc_account and each of their path
     fields a call's time in a CUDA graph of 20 back-to-back calls
     (`chain_ms`);
     once, beside the list, the card's launch floor (`launch_floor_ms`:
     an empty kernel in such a graph; `barrier_floor_ms`: the cooperative
     launch and grid barriers alone);
     flow_transition_roce and pfc_account from phase 6b, and the PFC-path
     `pfc_*` fields of flow_transition and serve_enqueue; the fault-path
     `fault_*` fields of serve_enqueue from phase 6c; the active set's
     flow_transition_active and flow_transition_roce_active, and the
     `active_*` fields of serve_enqueue, rank_in_queue and pfc_account,
     from phase 6d; the `collective_*` fields from phase 6e; the `soak_*`
     fields from phase 6g; for flash
     attention SDPA's time as `library_ms`, and
     under `routes` each route's device and wall ms, launches, bound,
     plain and SDPA times and factor to SDPA: tc at prefill-1000,
     prefill-4096, zamba2's prefill-1024 (hd 80) and mixtral's
     prefill-8192 with the window (phase 9), whisper's encoder and cross
     prefill and internvl2's prefill-1024 (phase 10), decode at
     decode-544, on mixtral's rings of 512 and 4096 and at whisper's
     cross decode, fma at prefill-1000's shapes in f32;
     the MoE paths' launches by route (`launches_moe`) and phase 10's
     (`launches_mm`); for the SSD scan at mamba2's
     prefill 4 x 1024 and 1 x 4096 inputs and zamba2's 4 x 1024), the
     card's name and power
     limit, and the final `{"ok": true, ...}` line.

It needs a CUDA device and the repository around it: without either it
exits non-zero before printing any result.
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TESTDATA = ROOT / "src" / "repro_torch" / "testdata"

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
#: rate outside the tensor cores, for the per-kernel bound.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: bf16 tensor-core peak (dense), for attention's bound.
BF16_OPS_PER_S = 989e12

#: Flash attention vs its plain version, as tests/test_kernels.py holds the
#: Pallas kernel: one f32 summation order against another, or one bf16
#: rounding of the output.
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: bf16 llama3-8b logits of two evaluations that differ in where bf16
#: rounds (kernel vs plain attention; 512 decode steps vs one prefill):
#: ||a - b|| / ||b|| over all logits.  Rounding differences compound over
#: 32 layers; a wrong mask or position gives O(1) (ROADMAP C6: 4.06 on
#: logits of scale ~3).
SERVE_REL_L2 = 5e-2
#: The f32 SMOKE config against the JAX-made reference; the decode from a
#: bf16 cache may round a cached value to the other bf16 neighbour.
SMOKE_TOL, SMOKE_BF16_CACHE_TOL = 1e-4, 2e-2
#: The SSD kernel against its plain version, as tests/test_kernels.py holds
#: the Pallas kernel: one f32 summation order against another (and exp of
#: differences of cumulative sums), or one bf16 rounding of y.
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: The f32 SMOKE configs of mamba2/zamba2 against the JAX-made references:
#: their block input and Mamba2 projections are bf16, as in the reference,
#: so an element that rounds to the other bf16 neighbour on the card moves
#: the logits by ~1e-4 (tests/test_torch_ssm.py: 1.7e-4 on the CPU).
SSM_SMOKE_TOL = 2e-3
#: bf16 mamba2/zamba2 logits of two evaluations that round differently:
#: decode against prefill, and zamba2's kernels against their plain
#: versions.  Random-weight stacks of 54-64 Mamba2 layers amplify the
#: bf16 roundings of the projections (bf16 even in an f32 config): two
#: prefills of the same model that differ only in the chunk length (the
#: same function) differ by 5-8% relative L2 on the card, as this phase
#: logs and holds.  A wrong state, conv window, position or skip term
#: gives O(1).
SSM_REL_L2 = 0.15
#: mamba2-2.7b's depth in phase 8, cut from 64: its host-bound decode
#: (543 steps, twice) took the most time of the serve phases, and the
#: whole script took 1135 s on a slow host with all 64.
MAMBA2_LAYERS = 16

#: Each wrapper's own CUDA kernels (csrc/*.cu); a wrapper call launches
#: these and memsets, nothing else.
OWN_KERNELS = {
    "flow_transition": ("strack_kernel",),
    "flow_transition_roce": ("roce_kernel",),
    "flow_transition_active": ("strack_kernel",),
    "flow_transition_roce_active": ("roce_kernel",),
    "serve_enqueue": ("serve_enqueue_kernel",),
    "pfc_account": ("pfc_kernel",),
    "flow_transition_batch": ("strack_kernel",),
    "flow_transition_roce_batch": ("roce_kernel",),
    "serve_enqueue_batch": ("serve_enqueue_kernel",),
    "pfc_account_batch": ("pfc_kernel",),
    "rank_in_queue": ("count_kernel", "scan_kernel", "resolve_kernel"),
    "flash_attention tc": ("tc_kernel",),
    "flash_attention decode": ("dec_kernel",),
    "flash_attention fma": ("fa_kernel",),
    "ssd_scan": ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel",
                 "ssd_out_kernel"),
    "ssd_scan_bwd": ("ssd_bwd_q_kernel", "ssd_bwd_pass_kernel",
                     "ssd_bwd_w_kernel", "ssd_bwd_dx_kernel",
                     "ssd_bwd_dbc_kernel"),
}


#: The soak's default fleet, copied from benchmarks/soak.py:45-63
#: (``default_fleet``; that module imports the JAX package): 64 hosts
#: (full_bisection(8, 8)) at 400 Gbps, a ring and an HD allreduce job of 16
#: ranks (two chained steps each, the HD job from tick 64) and a 128-flow
#: burst tenant into 4 frontends.
SOAK_FLEET = dict(
    shape=(8, 8), link_gbps=400.0,
    jobs=(dict(name="train_ring", algo="ring", ranks=16,
               collective_bytes=256 * 2 ** 10, steps=2,
               algo_kw=(("chunk", 64 * 2 ** 10),)),
          dict(name="train_hd", algo="hd", ranks=16,
               collective_bytes=256 * 2 ** 10, steps=2, start_tick=64)),
    tenants=(dict(name="inference", n_flows=128, mean_interarrival_ticks=4.0,
                  size_bytes=16 * 2 ** 10, size_jitter=0.5, n_targets=4),))
#: The oracle spot check's fleet, benchmarks/soak.py:66-84 (``spot_fleet``):
#: 16 hosts, two 4-rank jobs and a 24-flow burst tenant.
SPOT_FLEET = dict(
    shape=(4, 4), link_gbps=400.0,
    jobs=(dict(name="train_ring", algo="ring", ranks=4,
               collective_bytes=128 * 2 ** 10),
          dict(name="train_hd", algo="hd", ranks=4,
               collective_bytes=128 * 2 ** 10, start_tick=32)),
    tenants=(dict(name="inference", n_flows=24, mean_interarrival_ticks=6.0,
                  size_bytes=16 * 2 ** 10, n_targets=2),))
#: The fabric-vs-oracle band of the per-tenant FCT spot check
#: (benchmarks/soak.py:42, the differential-fuzz band).
SPOT_BAND = (0.7, 1.4)
#: The oracle's runs held against events64_ref.json (epoch 0 of the
#: fleet's mix at seed 0, ``until`` in us): name -> (fleet, RunConfig
#: fields, "CHAOS1024" for that schedule).
EVENTS_RUNS = {"default_clean": ("default", {}),
               "default_chaos": ("default", {"faults": "CHAOS1024"}),
               "spot_strack": ("spot", {}),
               "spot_rocev2": ("spot", {"protocol": "rocev2"})}
EVENTS_UNTIL_US = 2e7


def log(msg: str) -> None:
    print(msg, flush=True)


def leaves(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from leaves(v, f"{prefix}{name}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), tree


def assert_same(what: str, a, b) -> float:
    """Exact equality of two output trees (float32 compared bit for bit);
    returns the largest absolute difference of the float leaves (0.0)."""
    import torch
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys(), (what, la.keys() ^ lb.keys())
    err = 0.0
    for k in la:
        x, y = la[k], lb[k]
        if not isinstance(x, torch.Tensor):
            assert x == y, (what, k, x, y)
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (
            what, k, x.dtype, y.dtype, tuple(x.shape), tuple(y.shape))
        if x.dtype == torch.float32:
            d = (x - y).abs().nan_to_num(nan=float("inf"))
            err = max(err, float(d.max()) if d.numel() else 0.0)
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad = (x != y).nonzero()[0].tolist()
            raise AssertionError(f"{what}: kernel and plain version differ "
                                 f"at {k}{bad}")
    return err


def nbytes(tree) -> int:
    """Bytes of the distinct tensors of ``tree`` (a tensor that appears
    twice, as serve_enqueue's ``surv`` is its ``has`` without faults,
    counts once)."""
    import torch
    distinct = {id(t): t for _, t in leaves(tree)
                if isinstance(t, torch.Tensor)}
    return sum(t.numel() * t.element_size() for t in distinct.values())


def index_bytes(index) -> int:
    """Bytes of a source index the transition kernels read: the flows by
    source and the blocks' offsets."""
    return nbytes((index.by_src, index.blocks))


def wall_ms(fn, reps: int = 30) -> float:
    """Mean time of one ``fn()`` call over ``reps`` back-to-back calls,
    between two CUDA events (warmed up first): host work included."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int = 20, times: dict | None = None) -> tuple:
    """Mean device time of one ``fn()`` call: the self device time of
    every kernel and memset it ran, summed from ``torch.profiler`` over
    ``reps`` calls (warmed up first).  Returns ``(ms, device event
    names)``; ``times``, where given, gets each event's ms a call.  Every
    call runs the same device events, so a profile in which some event
    was recorded a number of times that is not a multiple of ``reps`` has
    lost records (late in a long process the
    profiler has returned a third of them) and is taken again, as is one
    that recorded no device event; after three such profiles the time
    comes from CUDA events around ``reps`` back-to-back calls (host gaps
    included) and the names are ``None``; else the names map to their
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, counts, by_key = 0.0, {}, {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                total_us += us
                counts[ev.key] = ev.count
                by_key[ev.key] = us / reps / 1e3
        if total_us > 0 and all(c % reps == 0 for c in counts.values()):
            if times is not None:
                times.update(by_key)
            return total_us / reps / 1e3, counts
        log(f"[profile] device events recorded for {reps} calls (attempt "
            f"{attempt + 1}): "
            f"{ {k[:60]: c for k, c in counts.items()} or 'none'}")
    log("[profile] falling back to CUDA events for this measurement")
    return wall_ms(fn, reps), None


def graph_ms(fn, reps: int = 50, n: int = 1) -> float:
    """Device time of one ``fn()`` call without the host: ``n`` calls
    captured in one CUDA graph (after a warm-up on the capture's side
    stream), replayed ``reps`` times between two CUDA events, per call.
    For wrappers whose host work per call (argument checks, allocation,
    ctypes) exceeds their device work, where back-to-back calls time the
    host.  With ``n = 1`` a call of a few microseconds is timed at the
    host's rate of graph launches; with ``n = 20`` as the card runs it in
    a chain of launches, gaps between launches included."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps / n


def chain_ms(fn) -> float:
    """``graph_ms`` of 20 back-to-back calls in one graph."""
    return graph_ms(fn, reps=20, n=20)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def own_device_ms(name: str, fn, reps: int = 20,
                  times: dict | None = None) -> float:
    """``device_ms`` of a wrapper call that may run its own kernels and
    memsets only (``times``, where given, gets each one's ms a call)."""
    ms, names = device_ms(fn, reps, times)
    if names is None:
        return ms
    for own in OWN_KERNELS[name]:
        assert any(own in k for k in names), (name, own, names)
    foreign = [k for k in names if "emset" not in k
               and not any(own in k for own in OWN_KERNELS[name])]
    assert not foreign, (name, foreign)
    return ms


def graph_nodes(fn) -> list:
    """The device operations of one ``fn()`` call: the call captured in a
    CUDA graph, each node's declaration in the graph's DOT dump
    (``cudaGraphDebugDotPrint``; a kernel node names its function, a
    memset or copy node its kind).  Capture records every operation the
    call puts on its stream, and loses none."""
    import re
    import tempfile
    import warnings
    import torch
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept to be dumped
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch warns of every dump
        dot_path = Path(tmp) / "call.dot"
        graph.debug_dump(str(dot_path))
        dot = dot_path.read_text()
    graph.reset()
    # a node's declaration; an edge reads '"a" -> "b" [headlabel=...]'
    heads = list(re.finditer(r'(?<!-> )"graph_\d+_node_\d+"\[', dot))
    return [dot[h.start():(heads[i + 1].start() if i + 1 < len(heads)
                           else len(dot))]
            for i, h in enumerate(heads)]


def one_launch(calls: list, reps: int = 20) -> list:
    """Fail unless each call of ``calls`` (``(name, fn, what)``: a wrapper
    and a call of it) runs exactly one device operation, the wrapper's own
    kernel and no memset: one call captured in a CUDA graph must hold
    exactly one node, and that node must name the wrapper's kernel
    (``graph_nodes``).  Its device ms: ``torch.profiler`` over ``reps``
    calls, a session a call, every recorded device event the wrapper's
    kernel and no more than ``reps`` of them, else the run fails.  The
    profiler loses records in runs of sessions (it has kept 19 and 7 of
    20), so the time is the mean over the events it kept, and a session
    that kept none is taken again, at most six times.  Returns each call's
    device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = []
    for name, fn, what in calls:
        fn()
        torch.cuda.synchronize()
        nodes = graph_nodes(fn)
        assert len(nodes) == 1 and any(o in nodes[0]
                                       for o in OWN_KERNELS[name]), (
            "one device operation a call (graph)", what, name, len(nodes),
            [n[:200] for n in nodes])
        for attempt in range(6):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            bad = [e.name for e in evs
                   if not any(o in e.name for o in OWN_KERNELS[name])]
            assert not bad and len(evs) <= reps, (
                "one device operation a call", what, name, len(evs), reps,
                sorted({e.name[:60] for e in evs}))
            if evs:
                break
        assert evs, ("no device event recorded six times", what, name)
        if len(evs) < reps:
            log(f"[one launch] {name} {what}: {len(evs)} device events "
                f"recorded for {reps} calls (attempt {attempt + 1})")
        ms = sum(e.time_range.elapsed_us() for e in evs) / len(evs) / 1e3
        log(f"[one launch] {name} {what}: one device operation a call "
            f"({evs[0].name[:60]}; graph: 1 node), {ms:.7f} ms")
        out.append(ms)
    return out


def capture_tick(sc, cfg, t: int, dev, capped: bool = False) -> tuple:
    """Dense ticks of ``sc`` under ``cfg`` on the card up to tick ``t``, and
    the transition's arguments of tick ``t``, the serve/enqueue arguments
    (with the ring, cloned), and under PFC the PFC stage's (on the
    kernel's result).  Returns ``(prog, targs, sargs, ring, pargs)``."""
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.sim.fabric import _clone_tree
    prog = fabric_program(sc, cfg, dev)
    st = prog.init_state()
    for t_ in range(t):
        st, _, _ = prog.tick(st, t_)
    eff_nic, prow = prog.eff_pause(st, t)
    lanes = active_lanes(prog, st, t) if capped else None
    targs = prog.transport_args(st, t, prog.sendable_msg(st, t), eff_nic,
                                lanes)
    if lanes is None:
        out = fk.flow_transition(*targs)
    else:
        out = fk.flow_transition_active(_clone_tree(targs[0]), *targs[1:])
    _, tx, ptx, pv, sel = out[:5]
    sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow,
                                  prog.fault_masks(t), lanes)
    ring = _clone_tree(st.q)
    pargs = None
    if prog.pfc:
        ring_k = _clone_tree(ring)
        res = fk.serve_enqueue(ring_k, *sargs[1:])
        pargs = (prog.pfc_state(st), res[3], res[2], res[5], res[6], res[9],
                 res[7], ring_k, res[0], st.qsize, res[1], t, prog.pfc_flows,
                 prog.pfc_dims, None if lanes is None else lanes.idx)
    return prog, targs, sargs, ring, pargs


def one_launch_paths(dev) -> dict:
    """Phase 2b: the transitions, serve_enqueue and pfc_account are one
    device operation a call on every path (early in the process, while the
    profiler keeps its records): the dense program (perm1024 tick 16),
    PFC (incast1024 RoCEv2 + PFC tick 100; the STrack transition's NIC
    gate at incast1024 STrack + PFC tick 64), faults (perm1024 under
    CHAOS1024, tick 28), the active set (infer1024 at A = 512, tick
    400: STrack, and RoCEv2 + PFC; the active transitions step a clone of
    the flow record, again and again) and collectives (a2a1024 under
    STrack at tick 54, where children of tick 53's completions first
    offer beside gated flows in sources of 31; hd1024 under RoCEv2 + PFC
    at four sub-flows, 56 stripes a source, at tick 65, likewise).
    Returns their device ms a call (the kernels line's ``ms`` of these
    kernels and paths: the same ticks its timings replay), keyed by
    wrapper and path ("flow_transition", "flow_transition pfc",
    "flow_transition fault", "flow_transition_roce",
    "flow_transition_active", "flow_transition_roce_active",
    "flow_transition collective", "flow_transition_roce collective",
    "serve_enqueue", "serve_enqueue pfc", "serve_enqueue fault",
    "serve_enqueue active", "serve_enqueue collective", "serve_enqueue
    collective pfc", "pfc_account", "pfc_account active", "pfc_account
    collective")."""
    from repro_torch.core.params import NetworkSpec
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.profile import (CHAOS1024, INFER1024_CAP,
                                     collective1024_scenario,
                                     infer1024_scenario)
    from repro_torch.sim.fabric import _clone_tree
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import (RunConfig, incast_scenario,
                                           permutation_scenario)
    net400 = NetworkSpec(link_gbps=400.0)
    t32 = full_bisection(32, 32)
    perm1024 = permutation_scenario(t32, 64 * 2 ** 10, net=net400, seed=0)
    incast1024 = incast_scenario(t32, 256, 16 * 2 ** 10, net=net400)
    infer = infer1024_scenario()
    a2a1024 = collective1024_scenario("a2a1024")
    hd1024 = collective1024_scenario("hd1024")
    calls, keys = [], []
    for key, what, sc, cfg, t, capped in (
            ("", "dense (perm1024 t=16)", perm1024, RunConfig(), 16, False),
            (" pfc", "PFC (incast1024 rocev2 t=100)", incast1024,
             RunConfig(protocol="rocev2"), 100, False),
            (" strack pfc", "PFC gate (incast1024 strack pfc t=64)",
             incast1024, RunConfig(pfc=True), 64, False),
            (" fault", "faults (perm1024 CHAOS1024 t=28)", perm1024,
             RunConfig(faults=CHAOS1024), 28, False),
            (" active", "active set (infer1024 strack A=512 t=400)", infer,
             RunConfig(active_cap=INFER1024_CAP), 400, True),
            (" active", "active set (infer1024 rocev2 A=512 t=400)", infer,
             RunConfig(protocol="rocev2", active_cap=INFER1024_CAP), 400,
             True),
            (" collective", "collective (a2a1024 strack t=54)", a2a1024,
             RunConfig(), 54, False),
            (" collective pfc", "collective (hd1024 rocev2 x4 t=65)",
             hd1024, RunConfig(protocol="rocev2", subflows=4), 65, False)):
        prog, targs, sargs, ring, pargs = capture_tick(sc, cfg, t, dev,
                                                       capped)
        name = "flow_transition" + ("_roce" if prog.proto.name == "rocev2"
                                    else "") + ("_active" if capped else "")
        if capped:
            fl = _clone_tree(targs[0])
            calls.append((name, lambda f=fl, a=targs:
                          fk.flow_transition_active(f, *a[1:]), what))
            keys.append(name)
        else:
            calls.append((name, lambda a=targs: fk.flow_transition(*a),
                          what))
            keys.append(name + " collective" if "collective" in key else
                        name if name.endswith("_roce") else
                        name + key.replace(" strack", ""))
        if key == " strack pfc":
            continue
        ring_k = _clone_tree(ring)
        calls.append(("serve_enqueue", lambda r=ring_k, a=sargs:
                      fk.serve_enqueue(r, *a[1:]), what))
        keys.append("serve_enqueue" + key)
        if pargs is not None:
            calls.append(("pfc_account", lambda a=pargs: fk.pfc_account(*a),
                          what))
            keys.append("pfc_account" + key.replace(" pfc", ""))
    ms = {}
    for k, v in zip(keys, one_launch(calls)):
        ms.setdefault(k, v)  # the active set: STrack's serve/enqueue
    return ms


def launch_floors(dev) -> dict:
    """The card's launch floor: an empty one-warp kernel in a CUDA graph
    of back-to-back launches (``chain_ms``); and the cooperative launch
    the one-launch kernels make (256-thread blocks), with no work but its
    grid-wide barriers, at serve/enqueue's grid at perm1024 (17 blocks, 2
    barriers) and the PFC stage's at incast1024 (21 blocks, 1 barrier)."""
    from repro_torch.kernels import _cuda_bind
    from repro_torch.kernels import fabric_kernels as fk
    lib = fk._lib("serve_enqueue")
    return {
        "launch_floor_ms": chain_ms(
            lambda: _cuda_bind.launch_floor(lib, dev)),
        "barrier_floor_ms": {
            "serve_enqueue": chain_ms(
                lambda: _cuda_bind.launch_floor(lib, dev, 17, 2)),
            "pfc_account": chain_ms(
                lambda: _cuda_bind.launch_floor(lib, dev, 21, 1))}}


def to_cpu(tree):
    """``tree`` (tensors in tuples and named tuples) with every tensor on
    the CPU."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, tuple):
        items = [to_cpu(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def rotate_rings(sargs, ring, end: int):
    """serve_enqueue's arguments and ring with each row's packets moved
    along its ring (its head with them) so that the row's tail, where its
    first placement goes, is slot ``end``; the trash row stays."""
    import torch
    cap = ring.flow.shape[1]
    args = list(sargs)
    shift = (end - sargs[1] - sargs[2]) % cap
    shift[-1] = 0
    args[1] = sargs[1] + shift
    cols = (torch.arange(cap, device=shift.device)[None, :]
            - shift[:, None]) % cap
    rolled = type(ring)(*[f.gather(1, cols.long()) for f in ring])
    return args, rolled


def synthetic_ticks(label, sargs, ring, same, pfc=None, live=None):
    """serve_enqueue against its plain version on a captured tick's
    arguments made hard: every lane's data and probe into one host-down row
    (a bucket of about 2 L) and into one ToR uplink row, with every lane
    selected and every third probe valid; every row's packets moved along
    its ring so that its first placement lands in slot cap - 1 or cap - 2
    (placements wrap to slot 0), alone and with the one bucket; on lossy
    queues the one bucket again on a host-down row that holds
    ``data_drop - 8`` packets (the walk past the drop threshold and
    ``hard``, probes accepted after dropped data).  With ``pfc`` (the PFC
    stage's state, flows and dims, the tick, and the lanes under the
    active set), the PFC stage on each result too; under the active set
    only the ``live`` lanes (bool[L]) send, as in a tick.  Fails unless
    the bucket accepts and drops (under PFC, whose queues are lossless,
    drops nothing) and some placement wraps; returns the counts."""
    import torch
    from repro_torch.kernels import fabric_kernels as fk
    d = sargs[18]
    TS = d.n_tor * d.n_spine
    L, dev, cap = sargs[13].shape[0], sargs[13].device, d.cap
    cases = []
    for row in (2 * TS + 5, 7):
        one = list(sargs)
        one[15] = torch.full((L,), row, dtype=torch.int32, device=dev)
        one[16] = one[15]
        one[13] = (torch.ones((L,), dtype=torch.bool, device=dev)
                   if live is None else live)
        one[14] = one[13] & (torch.arange(L, device=dev) % 3 == 0)
        cases.append((f"one bucket (row {row})", one, ring))
    if pfc is None:
        row = 2 * TS + 5
        assert d.data_drop_pkts - 8 > 0 and d.hard_pkts <= cap, d
        near = list(cases[0][1])
        near[2] = sargs[2].clone()
        near[2][row] = d.data_drop_pkts - 8
        cases.append((f"one bucket (row {row}) near its drop threshold",
                      near, ring))
    for end in (cap - 1, cap - 2):  # every row's tail moved to slot end
        wrap, rolled = rotate_rings(sargs, ring, end)
        cases.append((f"tails at slot {end}", wrap, rolled))
        cases.append((f"tails at slot {end}, one bucket",
                      wrap[:13] + cases[0][1][13:17] + wrap[17:], rolled))
    seen = dict(bucket_acc=0, bucket_drops=0, wrapped=0)
    for what, args, ring in cases:
        rings = [type(ring)(*[f.clone() for f in ring]) for _ in range(2)]
        res_k = fk.serve_enqueue(rings[0], *args[1:])
        same("serve_enqueue", f"{label} {what}", res_k,
             fk.serve_enqueue_plain(rings[1], *args[1:]))
        Q = ring.flow.shape[0] - 1
        same("serve_enqueue", f"{label} {what} ring",
             [f[:Q] for f in rings[0]], [f[:Q] for f in rings[1]])
        if what.startswith("one bucket"):
            seen["bucket_acc"] += int(res_k[7][2 * TS:].sum())
            seen["bucket_drops"] += int(res_k[8])
        else:  # a row whose placements ran past the ring's last slot
            tail0 = (args[1][:Q] + args[2][:Q]) % cap
            tail1 = (res_k[0][:Q] + res_k[1][:Q]) % cap
            added = res_k[1][:Q] - args[2][:Q] + res_k[3].int()
            seen["wrapped"] += int(((added > 0) & (tail1 < tail0)).sum())
        if pfc is not None:  # against the plain version on the CPU, whose
            # index_add_ sums a queue's bytes in candidate order (on the card
            # its atomics may not: hundreds of fractional tails in one row)
            st, fl, dims, t, lanes = pfc
            pargs = (st, res_k[3], res_k[2], res_k[5], res_k[6], res_k[9],
                     res_k[7], rings[0], res_k[0], args[2], res_k[1], t, fl,
                     dims, lanes)
            same("pfc_account", f"{label} {what} pfc_account",
                 to_cpu(fk.pfc_account(*pargs)),
                 fk.pfc_account_plain(*to_cpu(pargs)))
    assert seen["bucket_acc"] > 0 and seen["wrapped"] > 0, (label, seen)
    assert (seen["bucket_drops"] > 0) == (pfc is None), (label, seen)
    log(f"[synthetic] {label}: serve_enqueue"
        + (" and pfc_account" if pfc is not None else "")
        + f" match their plain versions on one-bucket and wrap-around "
        f"ticks: {seen}")
    return seen


#: The kernels each fabric path launches (the path fails unless each one
#: did): STrack and RoCEv2 over lossy queues, and either under PFC.  The
#: ranker's work runs inside serve_enqueue's kernel.
STRACK_KERNELS = ("flow_transition", "serve_enqueue")
ROCE_KERNELS = ("flow_transition_roce", "serve_enqueue")


def fabric_program(sc, cfg, dev):
    """A bound ``FabricProgram`` of scenario ``sc`` under ``cfg`` (a
    ``RunConfig``: its sub-flows, the trace's dependency edges and
    arrivals) on ``dev``, for dense ticking by hand."""
    from repro_torch.sim.fabric import trace_program
    from repro_torch.sim.workloads import _fabric_cfg, _scenario_ticks
    return trace_program(sc.topo, sc.messages, _scenario_ticks(sc, cfg),
                         _fabric_cfg(sc, cfg), dev)


#: Entries of the infer1024 reference file that are not the capped run's
#: keys: the uncapped run, and the overflow count of the run at a small cap.
INFER_EXTRA_KEYS = ("uncapped", "small_cap", "small_cap_overflow_ticks")


def hold_against_reference(name, sc, cfg, kernels, ref=None) -> tuple:
    """Run ``sc`` under ``cfg`` through the port on the card, the launch
    counts reset just before and read just after, and hold it exactly
    against ``src/repro_torch/testdata/<name>_ref.json`` (made by the JAX
    package), or against ``ref`` where given: every summary key the file
    has (floats to 1e-6; the chaos files' ``blackholed_pkts``,
    ``corrupt_drops`` and ``win_retx`` among them, the infer1024 files'
    tenant and group tables), warp trips, end tick, every done tick (the
    collective files: also each message's release and done tick, and the
    trace's size and digest).  Fails unless each kernel of ``kernels``
    launched, and unless no other fabric kernel did.  Returns
    ``(launches, summary, wall seconds)``."""
    import torch
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.sim.fabric import run_fabric_trace, summarize
    from repro_torch.sim.workloads import (_fabric_cfg, _scenario_ticks,
                                           trace_digest)
    if ref is None:
        ref = json.loads((TESTDATA / f"{name}_ref.json").read_text())
    ref = {k: v for k, v in ref.items() if k not in INFER_EXTRA_KEYS}
    n_ticks = _scenario_ticks(sc, cfg)
    assert n_ticks == ref["n_ticks"], (name, n_ticks, ref["n_ticks"])
    torch.cuda.synchronize()
    fk.reset_launches()
    t0 = time.time()
    final, m = run_fabric_trace(sc.topo, sc.messages, n_ticks,
                                _fabric_cfg(sc, cfg), device="cuda")
    wall = time.time() - t0
    launches = dict(fk.launches)
    s = summarize(m)
    # JSON's form, as the file has it (tuples as lists, string keys)
    got = json.loads(json.dumps({k: s[k] for k in ref if k in s}))
    got.update(warp_trips=m["warp_trips"], end_tick=m["end_tick"],
               n_ticks=n_ticks, done_tick=[int(v) for v in m["done_tick"]])
    if "trace_sha256" in ref:   # a collective file
        got.update(trace_sha256=trace_digest(sc.messages),
                   n_msgs=len(sc.messages),
                   n_edges=sum(len(x.deps) for x in sc.messages),
                   n_flows=len(got["done_tick"]),
                   msg_release_tick=final.msg_release_tick.tolist(),
                   msg_done_tick=final.msg_done_tick.tolist())
    for k in ("blackholed_pkts", "corrupt_drops", "win_retx"):
        assert k not in ref or k in got, (name, k)
    for k, v in ref.items():
        if isinstance(v, float):
            assert math.isclose(got[k], v, rel_tol=1e-6), (name, k, got[k], v)
        else:
            assert got[k] == v, (name, k)
    for k, c in launches.items():
        assert (c > 0) == (k in kernels), \
            f"{name}: the {k} kernel launched {c} times"
    log(f"[{name}] matches the JAX reference (unfinished 0, drops "
        f"{s['drops']}, pauses {s['pauses']}, ecn_marks {s['ecn_marks']}, "
        f"retransmits {s['retransmits']}, rto_fires {s['rto_fires']}, "
        f"sack_recoveries {s['sack_recoveries']}, gbn_rewinds "
        f"{s['gbn_rewinds']}, blackholed_pkts {s['blackholed_pkts']}, "
        f"corrupt_drops {s['corrupt_drops']}, win_retx "
        f"{list(s.get('win_retx', ()))[:4]}, warp_trips={m['warp_trips']}, "
        f"end_tick "
        f"{m['end_tick']}, all {len(got['done_tick'])} done ticks); wall "
        f"{wall:.3f}s, {m['warp_trips'] / wall:.1f} trips/s; launches "
        f"{launches}")
    return launches, s, wall


def roce_pfc(dev, strack: dict, prof_ms: dict) -> tuple:
    """Phase 6b: RoCEv2 (DCQCN + go-back-N) and PFC on the fabric.

    ``strack`` holds phase 4's STrack summaries and wall times of perm1024
    and incast1024, for the comparison line.  Returns the ``kernels``
    entries of ``flow_transition_roce`` and ``pfc_account``, and the
    PFC-path fields of the ``flow_transition`` and ``serve_enqueue``
    entries (``pfc_*``)."""
    import numpy as np
    import torch
    from repro_torch.core.cc import CCState
    from repro_torch.core.lb import SprayState
    from repro_torch.core.params import NetworkSpec
    from repro_torch.core.reliability import RelState, SackMsg
    from repro_torch.core.transport import FlowState
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.numerics import Now
    from repro_torch.sim import dcqcn_fab as dq
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import (RunConfig, incast_scenario,
                                           permutation_scenario, run)
    from torch_states import (random_cc, random_rel, random_roce_flow,
                              random_roce_msg, random_sack, random_spray)

    net400 = NetworkSpec(link_gbps=400.0)
    t32, t44 = full_bisection(32, 32), full_bisection(4, 4)
    perm1024 = permutation_scenario(t32, 64 * 2 ** 10, net=net400, seed=0)
    incast1024 = incast_scenario(t32, 256, 16 * 2 ** 10, net=net400)
    roce, roce_lossy = RunConfig(protocol="rocev2"), RunConfig(
        protocol="rocev2", pfc=False)
    strack_pfc = RunConfig(pfc=True)
    max_err = dict.fromkeys(("flow_transition", "flow_transition_roce",
                             "serve_enqueue", "rank_in_queue",
                             "pfc_account"), 0.0)
    captured = {}

    def same(key, what, a, b):
        max_err[key] = max(max_err[key], assert_same(what, a, b))

    def transition(label, prog, targs, seen):
        name = ("flow_transition_roce" if prog.proto.name == "rocev2"
                else "flow_transition")
        out_k = fk.flow_transition(*targs)
        same(name, f"{label} {name} t={targs[4]}", out_k,
             fk.flow_transition_plain(*targs))
        eff_nic = targs[6]
        _, tx, ptx, pv, sel, can = out_k
        paused = (eff_nic[prog.src.long()] if eff_nic is not None
                  else torch.zeros_like(sel))
        seen["nic_paused"] += int(eff_nic.sum()) if eff_nic is not None \
            else 0
        seen["withheld"] += int((can & paused & ~sel).sum())
        seen["blocked_probes"] += int((ptx.valid & paused).sum())
        if prog.proto.name == "rocev2":
            fl_in, due = targs[0], targs[1]
            seen["cnp"] += int((due.valid & due.cnp).sum())
            seen["rate_cut"] += int((out_k[0].rate < fl_in.rate).sum())
        return out_k

    def check_tick(label, prog, st, t, seen, forced_nic=None):
        """Every fabric kernel against its plain version at tick ``t`` of
        a dense run; with ``forced_nic``, the transition once more on the
        same inputs with that NIC pause mask."""
        eff_nic, prow = prog.eff_pause(st, t)
        targs = prog.transport_args(st, t, prog.sendable_msg(st, t), eff_nic)
        out_k = transition(label, prog, targs, seen)
        if forced_nic is not None:
            transition(label + " (NICs paused)", prog,
                       targs[:6] + (forced_nic, targs[7]), seen["forced"])
        _, tx, ptx, pv, sel, _ = out_k
        sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow)
        rings = [type(st.q)(*[f.clone() for f in st.q]) for _ in range(2)]
        res_k = fk.serve_enqueue(rings[0], *sargs[1:])
        same("serve_enqueue", f"{label} serve_enqueue t={t}", res_k,
             fk.serve_enqueue_plain(rings[1], *sargs[1:]))
        same("serve_enqueue", f"{label} ring t={t}",
             [f[:prog.Q] for f in rings[0]], [f[:prog.Q] for f in rings[1]])
        qid, accept = res_k[6], res_k[7]
        same("rank_in_queue", f"{label} rank_in_queue t={t}",
             fk.rank_in_queue(qid, accept, prog.Q),
             fk.rank_in_queue_plain(qid, accept, prog.Q))
        pargs = (prog.pfc_state(st), res_k[3], res_k[2], res_k[5], qid,
                 res_k[9], accept, rings[0], res_k[0], st.qsize, res_k[1], t,
                 prog.pfc_flows, prog.pfc_dims)
        pfc_k = fk.pfc_account(*pargs)
        same("pfc_account", f"{label} pfc_account t={t}", pfc_k,
             fk.pfc_account_plain(*pargs))
        seen["gated"] += int((prow & (st.qsize[:prog.Q] > 0)).sum())
        seen["served"] += int(res_k[3].sum())
        seen["new_pauses"] += int(pfc_k.pauses) - int(st.pauses)
        return targs, sargs, rings[0], pargs

    def walk(label, sc, cfg, ticks, capture_at=None, forced_nic=False):
        prog = fabric_program(sc, cfg, dev)
        st = prog.init_state()
        seen = dict.fromkeys(("nic_paused", "withheld", "blocked_probes",
                              "cnp", "rate_cut", "gated", "served",
                              "new_pauses"), 0)
        seen["forced"] = dict.fromkeys(("nic_paused", "withheld",
                                        "blocked_probes", "cnp",
                                        "rate_cut"), 0)
        mask = None
        if forced_nic:   # every other NIC paused
            mask = torch.arange(prog.NH, device=dev) % 2 == 0
        for t in range(max(ticks) + 1):
            if t in ticks:
                r = check_tick(label, prog, st, t, seen, mask)
                if t == capture_at:
                    captured[label] = (prog, r)
            st, _, _ = prog.tick(st, t)
        torch.cuda.synchronize()
        log(f"[roce/pfc] {label}: transition, serve_enqueue, rank_in_queue "
            f"and pfc_account match their plain versions at ticks "
            f"{sorted(ticks)}; summed over those ticks {seen}")
        return seen

    # (a) kernels against their plain versions: incast1024 under RoCEv2 +
    # PFC: the senders offer at 0-2, switch ports pause at 61-72 and gate
    # their rows from 73, CNPs reach the senders at 65-70 and 98-126 (no
    # NIC pauses in this cell, so the transition also runs on the same
    # inputs with every other NIC paused); STrack + PFC on the same
    # incast; incasts on the 4x4 fabric
    # with a 200 KB buffer, where paused NICs hold back offers from tick
    # 21; a 15-sender STrack incast on a 2 us network, where probes of
    # paused NICs are withheld from tick 80
    seen = walk("incast1024 rocev2", incast1024, roce,
                {0, 1, 2, 61, 62, 64, 65, 66, 67, 72, 73, 98, 99, 100, 104,
                 110, 126, 300, 640}, capture_at=100, forced_nic=True)
    assert seen["cnp"] > 0 and seen["rate_cut"] > 0, seen
    assert seen["gated"] > 0 and seen["served"] > 0, seen
    assert seen["new_pauses"] > 0, seen
    f = seen["forced"]
    assert f["nic_paused"] > 0 and f["withheld"] > 0, seen
    prog, (_, sargs, ring, pargs) = captured["incast1024 rocev2"]
    synthetic_ticks("incast1024 rocev2 t=100", sargs, ring, same,
                    (pargs[0], pargs[12], pargs[13], pargs[11], None))
    walk("incast1024 strack pfc", incast1024, strack_pfc, {40, 60, 64, 80},
         capture_at=64)
    small = dict(switch_buffer_bytes=2e5)
    incast8 = incast_scenario(t44, 8, 512 * 2 ** 10, net=net400)
    for proto in ("rocev2", "strack"):
        seen = walk(f"incast8 {proto} pfc 200KB", incast8,
                    RunConfig(protocol=proto, pfc=True, **small),
                    {21, 25, 30, 40, 60, 100})
        assert seen["nic_paused"] > 0 and seen["withheld"] > 0, seen
        assert seen["gated"] > 0 and seen["new_pauses"] > 0, seen
    net2 = NetworkSpec(link_gbps=400.0, base_rtt_us=2.0)
    seen = walk("incast15 strack pfc 200KB rtt 2us",
                incast_scenario(t44, 15, 512 * 2 ** 10, net=net2),
                RunConfig(pfc=True, **small), {80, 88, 96, 144, 192})
    assert seen["blocked_probes"] > 0 and seen["withheld"] > 0, seen

    # random RoCEv2 and STrack flow states at 1024 lanes, half the NICs
    # paused: RTOs, DCQCN timers, byte-counter stages, rewinding NACKs
    rng = np.random.default_rng(0)
    cuda = lambda d: {k: torch.from_numpy(np.array(v)).to(dev)
                      for k, v in d.items()}
    dims_r = fabric_program(perm1024, roce, dev).trans_dims
    dims_s = fabric_program(perm1024, strack_pfc, dev).trans_dims
    n = dims_r.n_real
    seen = dict(rto=0, alpha_timer=0, rate_timer=0, byte_stage=0, rewind=0,
                withheld=0)
    seen_s = dict(blocked_probes=0, withheld=0, probes=0)
    for t in (2400, 2401, 2403, 2408):   # timer ticks: t % 8 == 0
        now = float(Now(t, dims_r.tick_us))
        sendable = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        src = torch.from_numpy(rng.integers(0, n // 4, n).astype(np.int32)
                               ).to(dev)
        eff_nic = torch.from_numpy(rng.random(n) < 0.5).to(dev)
        flow = random_roce_flow(rng, n, dims_r.p, now)
        fl = dq.RoceFlow(**cuda(flow))
        due = dq.RoceMsg(**cuda(random_roce_msg(rng, n, flow)))
        index = fk.src_index(src, dims_r.n_hosts)
        targs = (fl, due, sendable, src, t, dims_r, eff_nic, index)
        out = fk.flow_transition(*targs)
        same("flow_transition_roce", f"random RoceFlow t={t}", out,
             fk.flow_transition_plain(*targs))
        o = out[0]
        seen["rto"] += int((o.rto_fires > fl.rto_fires).sum())
        seen["alpha_timer"] += int(((o.last_alpha_ts != fl.last_alpha_ts)
                                    & ~(due.valid & due.cnp)).sum())
        seen["rate_timer"] += int((o.t_stage > fl.t_stage).sum())
        seen["byte_stage"] += int((out[4] & (o.b_stage > fl.b_stage)).sum())
        seen["rewind"] += int((o.gbn_rewinds > fl.gbn_rewinds).sum())
        seen["withheld"] += int((out[5] & ~out[4]
                                 & eff_nic[src.long()]).sum())
        rel_d = random_rel(rng, n, dims_s.p)
        flows = FlowState(cc=CCState(**cuda(random_cc(rng, n, dims_s.p))),
                          spray=SprayState(**cuda(random_spray(rng, n,
                                                               dims_s.p))),
                          rel=RelState(**cuda(rel_d)))
        sdue = SackMsg(**cuda(random_sack(rng, n, dims_s.p, rel_d, now)))
        targs = (flows, sdue, sendable, src, t, dims_s, eff_nic, index)
        out = fk.flow_transition(*targs)
        same("flow_transition", f"random FlowState under PFC t={t}", out,
             fk.flow_transition_plain(*targs))
        paused = eff_nic[src.long()]
        seen_s["blocked_probes"] += int((out[2].valid & paused).sum())
        seen_s["probes"] += int(out[3].sum())
        seen_s["withheld"] += int((out[5] & ~out[4] & paused).sum())
    torch.cuda.synchronize()
    assert all(v > 0 for v in seen.values()), seen
    assert all(v > 0 for v in seen_s.values()), seen_s
    log(f"[roce/pfc] flow_transition_roce matches its plain version on "
        f"random RoceFlow states at {n} lanes: {seen}; flow_transition's "
        f"PFC gate on random STrack states: {seen_s}")

    # (b) goldens
    for name, sc in (("perm16_roce", permutation_scenario(
            t44, 256 * 2 ** 10, net=net400, seed=0)),
                     ("incast8_roce", incast8)):
        want = json.loads((ROOT / "tests" / "golden" / f"{name}.json")
                          .read_text())
        t0 = time.time()
        got = run(sc, roce, device="cuda")
        for k, v in want.items():
            if isinstance(v, float):
                assert math.isclose(got[k], v, rel_tol=1e-6), (name, k,
                                                               got[k], v)
            else:
                assert got[k] == v, (name, k, got[k], v)
        log(f"[golden] {name}: {want} matched in {time.time() - t0:.2f}s "
            f"({got['warp_trips']} warp trips)")

    # (c) the full-width runs against their JAX-made reference files
    pfc_kernels = ROCE_KERNELS + ("pfc_account",)
    runs = {}
    runs["perm1024"] = hold_against_reference(
        "perm1024_rocev2", perm1024, roce, pfc_kernels)
    runs["incast1024"] = hold_against_reference(
        "incast1024_rocev2", incast1024, roce, pfc_kernels)
    hold_against_reference("incast1024_rocev2_lossy", incast1024, roce_lossy,
                           ROCE_KERNELS)
    l_spfc = hold_against_reference(
        "incast1024_strack_pfc", incast1024, strack_pfc,
        STRACK_KERNELS + ("pfc_account",))[0]

    # (d) scale: perm8k under RoCEv2
    perm8k = permutation_scenario(full_bisection(128, 64), 64 * 2 ** 10,
                                  net=net400, seed=0)
    t0 = time.time()
    r8k = run(perm8k, roce, device="cuda")
    torch.cuda.synchronize()
    wall8k = time.time() - t0
    assert r8k["unfinished"] == 0, r8k["unfinished"]
    log(f"[perm8k rocev2] 8192 flows, unfinished 0, max_fct "
        f"{r8k['max_fct']:.4f} us, pauses {r8k['pauses']}; wall "
        f"{wall8k:.3f}s, warp trips {r8k['warp_trips']}, "
        f"{r8k['warp_trips'] / wall8k:.1f} trips/s")

    # (e) STrack against RoCEv2 (printed, not gated)
    for name in ("perm1024", "incast1024"):
        (s_s, w_s), (_, s_r, w_r) = strack[name], runs[name]
        log(f"[fabric] {name}: STrack avg/max FCT {s_s['avg_fct']:.4f} / "
            f"{s_s['max_fct']:.4f} us, wall {w_s:.3f}s; RoCEv2+PFC "
            f"{s_r['avg_fct']:.4f} / {s_r['max_fct']:.4f} us, wall "
            f"{w_r:.3f}s")

    # kernel times and bounds at incast1024's shapes (RoCEv2 + PFC at tick
    # 100; STrack + PFC at tick 64 for flow_transition's PFC path).  Late
    # in this process the profiler loses records (section 7 of PERF.md),
    # so the kernels' device time comes from phase 2b's profile of the
    # same ticks, beside a call among 20 in a graph (``chain_ms``); the
    # plain versions' from ``device_ms``
    l_roce = runs["incast1024"][0]
    prog, (targs, sargs, ring, pargs) = captured["incast1024 rocev2"]
    _, (targs_s, _, _, _) = captured["incast1024 strack pfc"]
    out_r = fk.flow_transition(*targs)
    out_s = fk.flow_transition(*targs_s)
    res_k = fk.serve_enqueue(type(ring)(*[f.clone() for f in ring]),
                             *sargs[1:])
    pfc_k = fk.pfc_account(*pargs)
    ring_k = type(ring)(*[f.clone() for f in ring])
    ring_p = type(ring)(*[f.clone() for f in ring])
    slot_bytes = sum(f.element_size() for f in ring)
    Q, M = prog.Q, res_k[6].numel()
    n_acc = int(res_k[7].sum())
    s_bytes = (2 * 4 * (Q + 1) + Q * slot_bytes + nbytes(sargs[3:17])
               + Q + nbytes(res_k) + n_acc * slot_bytes)
    # the PFC stage reads has, the popped flow and spine lanes and bytes
    # (Q rows), accept and the candidate bytes (M), qhead and both qsizes,
    # the accepted ring slots' flow/psn/probe, the per-flow inputs and the
    # state, and writes the state
    p_bytes = (nbytes(pargs[0]) + Q * 13 + M * 5 + 3 * 4 * (Q + 1)
               + n_acc * 9 + nbytes(pargs[12]) + nbytes(pfc_k))
    calls = {
        "flow_transition_roce": (lambda: fk.flow_transition(*targs),
                                 lambda: fk.flow_transition_plain(*targs),
                                 bound_ms(nbytes(targs[:4]) + nbytes(targs[6])
                                          + index_bytes(targs[7])
                                          + nbytes(out_r),
                                          targs[2].numel() * 40)),
        "flow_transition": (lambda: fk.flow_transition(*targs_s),
                            lambda: fk.flow_transition_plain(*targs_s),
                            bound_ms(nbytes(targs_s[:4]) + nbytes(targs_s[6])
                                     + index_bytes(targs_s[7])
                                     + nbytes(out_s),
                                     targs_s[2].numel() * (2 * 512 + 64))),
        "serve_enqueue": (lambda: fk.serve_enqueue(ring_k, *sargs[1:]),
                          lambda: fk.serve_enqueue_plain(ring_p, *sargs[1:]),
                          bound_ms(s_bytes, Q * 40 + M * 20)),
        "pfc_account": (lambda: fk.pfc_account(*pargs),
                        lambda: fk.pfc_account_plain(*pargs),
                        bound_ms(p_bytes, Q * 8 + M * 4)),
    }
    csrc = "src/repro_torch/kernels/csrc"
    entries, paths = [], {}
    for name, (kern, plain, (bnd, by)) in calls.items():
        plain_ms, _ = device_ms(plain, reps=10)
        row = {"plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
               "wall_ms": wall_ms(kern),
               "plain_wall_ms": wall_ms(plain, reps=10)}
        key = {"serve_enqueue": "serve_enqueue pfc",
               "flow_transition": "flow_transition pfc"}.get(name, name)
        row.update(ms=prof_ms[key], chain_ms=chain_ms(kern))  # phase 2b's
        if name == "flow_transition_roce":
            entries.append({
                "name": name, "route": "cuda",
                "source": f"{csrc}/transition_roce.cu",
                "replaces": "src/repro/kernels/fabric_kernels.py:191",
                "launches": l_roce[name], "max_abs_err": max_err[name],
                "library_ms": None, **row})
        elif name == "pfc_account":
            entries.append({
                "name": name, "route": "cuda",
                "source": f"{csrc}/serve_enqueue.cu",
                "replaces": "src/repro/sim/fabric.py:1741",
                "launches": l_roce[name], "max_abs_err": max_err[name],
                "library_ms": None, **row})
        else:
            launches = (l_spfc if name == "flow_transition" else l_roce)[name]
            paths[name] = {f"pfc_{k}": v for k, v in row.items()}
            paths[name].update(pfc_launches=launches,
                               pfc_max_abs_err=max_err[name],
                               pfc_shape=("incast1024 strack pfc t=64"
                                          if name == "flow_transition" else
                                          "incast1024 rocev2 t=100"))
    paths.setdefault("rank_in_queue", {})["pfc_max_abs_err"] = \
        max_err["rank_in_queue"]
    return entries, paths


def chaos(dev, perm_wall: float, prof_ms: dict) -> dict:
    """Phase 6c: chaos on the fabric (link, uplink and host flaps, a
    degraded link, seeded corruption), with serve_enqueue's fault
    branches in CUDA.  ``perm_wall`` is phase 4's wall time of the
    fault-free perm1024.  Returns the ``fault_*`` fields of the
    ``serve_enqueue`` entry of the ``kernels`` line."""
    import dataclasses as dc
    import torch
    from repro_torch.core.params import NetworkSpec
    from repro_torch.kernels import _cuda_bind
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.profile import CHAOS1024
    from repro_torch.sim.faults import (NEVER, fault_u01,
                                        faults_from_dead_links, link_flap)
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import (RunConfig, linkdown_scenario,
                                           permutation_scenario, run)

    net400 = NetworkSpec(link_gbps=400.0)
    t32 = full_bisection(32, 32)
    perm1024 = permutation_scenario(t32, 64 * 2 ** 10, net=net400, seed=0)
    cfgs = {"strack": RunConfig(faults=CHAOS1024),
            "rocev2": RunConfig(protocol="rocev2", faults=CHAOS1024)}
    max_err = [0.0]
    captured = {}

    def same(what, a, b):
        max_err[0] = max(max_err[0], assert_same(what, a, b))

    def check_serve(label, sargs, ring):
        """serve_enqueue against its plain version on clones of ``ring``;
        returns the kernel's result."""
        rings = [type(ring)(*[f.clone() for f in ring]) for _ in range(2)]
        res_k = fk.serve_enqueue(rings[0], *sargs[1:])
        same(f"{label} serve_enqueue", res_k,
             fk.serve_enqueue_plain(rings[1], *sargs[1:]))
        same(f"{label} ring", [f[:-1] for f in rings[0]],
             [f[:-1] for f in rings[1]])
        return res_k

    def walk(proto, ticks, capture_at):
        """Kernel against plain at ``ticks`` of a dense perm1024 run under
        CHAOS1024; fails unless those ticks show every fault branch."""
        prog = fabric_program(perm1024, cfgs[proto], dev)
        st = prog.init_state()
        seen = dict.fromkeys(("down_pops", "duty_closed_ready",
                              "corrupted", "spared"), 0)
        for t in range(max(ticks) + 1):
            if t in ticks:
                fm = prog.fault_masks(t)
                eff_nic, prow = prog.eff_pause(st, t)
                targs = prog.transport_args(st, t, prog.sendable_msg(st, t),
                                            eff_nic)
                _, tx, ptx, pv, sel, _ = fk.flow_transition(*targs)
                sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow,
                                              fm)
                res = check_serve(f"chaos {proto} t={t}", sargs, st.q)
                pop, has, surv = res[2], res[3], res[10]
                ready = (st.qsize[:prog.Q] > 0) & (pop.ready <= t)
                seen["down_pops"] += int((has & fm.row_down).sum())
                seen["duty_closed_ready"] += int((ready & ~fm.row_duty).sum())
                seen["corrupted"] += int(res[12])
                seen["spared"] += int((surv & ~pop.probe
                                       & (fm.row_cor_p > 0)).sum())
                if t == capture_at:
                    captured[proto] = (prog, sargs, type(st.q)(
                        *[f.clone() for f in st.q]))
            st, _, _ = prog.tick(st, t)
        torch.cuda.synchronize()
        assert all(v > 0 for v in seen.values()), (proto, seen)
        log(f"[chaos] perm1024 {proto}: serve_enqueue's fault branches match "
            f"the plain version at ticks {sorted(ticks)}; summed over those "
            f"ticks {seen}")

    # (a) the fault branches against the plain version at ticks of both
    # CHAOS1024 runs where each fires: the link flap's rows pop into the
    # blackhole at 13-61, the degraded link's duty cycle closes on ready
    # heads from 18, the corrupting links drop and spare data at 18-61 and
    # 140-141 (found by stepping the plain version on the CPU)
    walk("strack", {18, 19, 20, 21, 22, 26, 28, 41, 54, 60, 100},
         capture_at=28)
    walk("rocev2", {13, 26, 38, 40, 46, 50, 54, 61, 73, 140, 141},
         capture_at=40)
    # random row masks and probabilities on the captured STrack ring, and
    # each fault input alone
    prog, sargs, ring = captured["strack"]
    Q = prog.Q
    gen = torch.Generator(device="cpu").manual_seed(16)
    rnd = lambda: torch.rand((Q,), generator=gen).to(dev)
    seen = dict(bh=0, cor=0)
    for trial in range(4):
        down, duty = rnd() < 0.1, rnd() < 0.7
        prob = torch.where(rnd() < 0.5, rnd(), 0.0).to(torch.float32)
        seed = int(torch.randint(0, 2 ** 31, (1,), generator=gen))
        faults = [(down, duty, prob, seed), (down, None, None, None),
                  (None, duty, None, None), (None, None, prob, seed)][trial]
        res = check_serve(f"random fault rows {trial}",
                          sargs[:20] + faults, ring)
        seen["bh"] += int(res[11])
        seen["cor"] += int(res[12])
    assert seen["bh"] > 0 and seen["cor"] > 0, seen
    # the device draw against the plain draw on a grid of keys: every row
    # of perm1024, ticks from 0 and near 2^30, psns across int32
    rows = torch.arange(Q, dtype=torch.int32)
    ticks = torch.tensor([0, 1, 7, 24383, NEVER - 1, NEVER, NEVER + 1],
                         dtype=torch.int32)
    psns = torch.tensor([-2 ** 31, -1, 0, 1, 15, 4095, 2 ** 31 - 1],
                        dtype=torch.int32)
    grid = [g.reshape(-1).contiguous()
            for g in torch.meshgrid(rows, ticks, psns, indexing="ij")]
    lib = fk._lib("serve_enqueue")
    for seed in (0, 3, 2 ** 31 - 1):
        same(f"fault draw seed={seed}",
             _cuda_bind.fault_draw(lib, seed, *[g.to(dev) for g in grid]
                                   ).cpu(),
             fault_u01(seed, *grid))
    log(f"[chaos] serve_enqueue matches its plain version on random fault "
        f"rows (and each alone) at the captured perm1024 ring: {seen}; the "
        f"device draw equals fault_u01 at {grid[0].numel()} keys x 3 seeds")
    synthetic_ticks("chaos strack t=28", sargs, ring,
                    lambda key, what, a, b: same(what, a, b))

    # (b) goldens: one ToR-0 uplink flaps in [50, 400) mid-permutation
    t44 = full_bisection(4, 4)
    perm16 = permutation_scenario(t44, 256 * 2 ** 10, net=net400, seed=0)
    for name, proto in (("perm16_flap_strack", "strack"),
                        ("perm16_flap_roce", "rocev2")):
        want = json.loads((ROOT / "tests" / "golden" / f"{name}.json")
                          .read_text())
        t0 = time.time()
        got = run(perm16, RunConfig(protocol=proto,
                                    faults=link_flap(0, 0, 50, 400)),
                  device="cuda")
        for k, v in want.items():
            if isinstance(v, float):
                assert math.isclose(got[k], v, rel_tol=1e-6), (name, k,
                                                               got[k], v)
            else:
                assert got[k] == v, (name, k, got[k], v)
        log(f"[golden] {name}: {want} matched in {time.time() - t0:.2f}s "
            f"({got['warp_trips']} warp trips, blackholed "
            f"{got['blackholed_pkts']})")

    # (c) the full-width runs against their JAX-made reference files
    l_s, s_s, w_s = hold_against_reference(
        "perm1024_chaos_strack", perm1024, cfgs["strack"], STRACK_KERNELS)
    l_r, s_r, w_r = hold_against_reference(
        "perm1024_chaos_rocev2", perm1024, cfgs["rocev2"],
        ROCE_KERNELS + ("pfc_account",))
    dead = linkdown_scenario({"n_tor": 32, "hosts_per_tor": 32}, 0.125,
                             64 * 2 ** 10, net=net400)
    assert len(dead.topo.dead_links) == 128
    l_d, s_d, w_d = hold_against_reference(
        "linkdown1024_strack", dc.replace(dead, topo=t32),
        RunConfig(faults=faults_from_dead_links(dead.topo)), STRACK_KERNELS)
    assert (s_s["blackholed_pkts"], s_s["corrupt_drops"]) == (31, 9)
    assert (s_r["blackholed_pkts"], s_r["corrupt_drops"]) == (36, 30)
    log(f"[chaos] wall: perm1024 STrack {perm_wall:.3f}s fault-free, "
        f"{w_s:.3f}s under CHAOS1024; RoCEv2 + PFC {w_r:.3f}s; linkdown1024 "
        f"as t=0 flaps {w_d:.3f}s")

    # (d) serve_enqueue's fault path: times and bound at the STrack run's
    # tick 28 (down, duty-closed, corrupted and spared rows all present)
    prog, sargs, ring = captured["strack"]
    res_k = fk.serve_enqueue(type(ring)(*[f.clone() for f in ring]),
                             *sargs[1:])
    ring_k = type(ring)(*[f.clone() for f in ring])
    ring_p = type(ring)(*[f.clone() for f in ring])
    slot_bytes = sum(f.element_size() for f in ring)
    n_acc = int(res_k[7].sum())
    # the head slot of each row, qhead/qsize in and out, the per-flow lane
    # inputs, the three fault rows, the outputs (surv and the two counts
    # among them) and the accepted candidates' ring slots
    f_bytes = (2 * 4 * (Q + 1) + Q * slot_bytes + nbytes(sargs[3:17])
               + nbytes(sargs[20:23]) + nbytes(res_k) + n_acc * slot_bytes)
    bnd, by = bound_ms(f_bytes, Q * 80 + res_k[6].numel() * 20)
    kern = lambda: fk.serve_enqueue(ring_k, *sargs[1:])
    plain = lambda: fk.serve_enqueue_plain(ring_p, *sargs[1:])
    plain_ms, _ = device_ms(plain, reps=10)
    return {"fault_ms": prof_ms["serve_enqueue fault"],
            "fault_wall_ms": wall_ms(kern), "fault_chain_ms": chain_ms(kern),
            "fault_plain_ms": plain_ms,
            "fault_plain_wall_ms": wall_ms(plain, reps=10),
            "fault_bound_ms": bnd, "fault_bound_by": by,
            "fault_launches": l_s["serve_enqueue"],
            "fault_launches_rocev2": l_r["serve_enqueue"],
            "fault_launches_linkdown": l_d["serve_enqueue"],
            "fault_max_abs_err": max_err[0],
            "fault_shape": "perm1024 CHAOS1024 strack t=28"}


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


#: Query rows the plain attention takes at a time on the card: each row
#: is independent, and at mixtral's prefill of 8192 the f32 scores of all
#: rows would take 13 GB a copy.
PLAIN_ROWS = 4096


def model_layout_ref(q, k, v, **kw):
    """The kernel's plain version on model-layout (B, T, H, hd) tensors,
    in blocks of at most PLAIN_ROWS query rows (a ring's rows, at most
    four, in one)."""
    import torch
    from repro_torch.kernels.ref import flash_attention_ref
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    off, T = kw.pop("q_offset", 0), q.shape[1]
    return torch.cat([flash_attention_ref(
        q[:, i:i + PLAIN_ROWS].transpose(1, 2), kh, vh, q_offset=off + i,
        **kw).transpose(1, 2) for i in range(0, T, PLAIN_ROWS)], dim=1)


def plain_ssd(x, dt, A, B_, C_, chunk=128, *, final_state=False):
    """``kernels.ops.ssd_scan`` through the kernel's plain version."""
    from repro_torch.kernels.ref import ssd_chunked_ref
    y, state = ssd_chunked_ref(x, dt, A, B_, C_, chunk)
    return (y.to(x.dtype), state) if final_state else y.to(x.dtype)


@contextlib.contextmanager
def routed(name, fn, capture=None, store=None):
    """Route the models' calls of ``repro_torch.kernels.ops.<name>``
    (flash_attention, ssd_scan) through ``fn``; keep a copy of the
    arguments of the calls numbered in ``capture`` (call i: layer i, or
    the i-th application of a shared block) in ``store``."""
    import torch
    from repro_torch.kernels import ops as kops
    kernel, calls = getattr(kops, name), [0]

    def call(*args, **kw):
        if calls[0] in (capture or {}):
            store[capture[calls[0]]] = (
                tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args), dict(kw))
        calls[0] += 1
        return fn(*args, **kw)

    setattr(kops, name, call)
    try:
        yield
    finally:
        setattr(kops, name, kernel)


def sdpa_backend(call):
    """The first of SDPA's backends (flash, memory-efficient, cuDNN, math)
    that takes ``call`` (a boolean mask with GQA); SDPA's own choice among
    them is not exposed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                call()
            return backend
        except RuntimeError:    # "No available kernel" for this backend
            continue
    raise RuntimeError("no SDPA backend takes the call")


def flash_timing(q, k, v, kw) -> dict:
    """The flash-attention kernel, its plain version and SDPA on one call's
    model-layout inputs: device and wall ms, the route the call takes, the
    bound (the live (query, key) pairs' products at the bf16 tensor-core
    rate, or at the CUDA cores' f32 rate for f32 inputs; or the bytes: q
    read, the output written, the live keys' K and V rows read once), and
    the kernel's device time over SDPA's.  SDPA takes a causal call as
    ``is_causal``, a non-causal one as it is, or, at an offset, the live
    pairs as a boolean mask; with a window or on a ring, on the first
    backend that takes it (``library_backend``)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import live_mask
    B, Tq, H, hd = q.shape
    Tk, K = k.shape[1], k.shape[2]
    off = kw.get("q_offset", 0)
    live = live_mask(Tq, Tk, **kw, device=q.device)
    flops = 4 * hd * int(live.sum()) * B * H
    moved = 2 * q.numel() * q.element_size() + 2 * B * K * hd * \
        k.element_size() * int(live.any(0).sum())
    bnd, by = bound_ms(moved, flops, BF16_OPS_PER_S
                       if q.dtype == torch.bfloat16 else FP32_OPS_PER_S)
    kind = fa._route(Tq, hd, q.dtype, k.dtype, H, K, ring=kw.get("ring"))
    named = bool(kw.get("ring")) or kw.get("window") is not None
    mask = None if off == 0 and not named else live
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    run = lambda: kops.flash_attention(q, k, v, **kw)
    plain = lambda: model_layout_ref(q, k, v, **kw)
    causal = mask is None and kw.get("causal", True)
    sdpa = lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, is_causal=causal, enable_gqa=K != H)
    backend = sdpa_backend(sdpa) if named else None

    def library():
        if backend is None:
            return sdpa()
        with sdpa_kernel(backend):
            return sdpa()

    ms, lib_ms = own_device_ms(f"flash_attention {kind}", run), \
        device_ms(library)[0]
    extra = {} if backend is None else {
        "library_backend": f"{backend.name} (boolean mask)"}
    return {"shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)} (B,T,H,hd)"
                     f", {str(q.dtype).split('.')[-1]}, q_offset {off}"
                     + "".join(f", {n} {kw[n]}" for n in ("window", "ring")
                               if kw.get(n)), **extra,
            "fa_route": kind, "ms": ms,
            "plain_ms": device_ms(plain, reps=10)[0],
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "sdpa_factor": ms / lib_ms,
            "wall_ms": wall_ms(run), "plain_wall_ms": wall_ms(plain,
                                                              reps=10),
            "library_wall_ms": wall_ms(library)}


def serve(dev) -> dict:
    """Phase 7: llama3-8b served through the flash-attention kernel.
    Returns the kernel's entry of the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import lm
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    from torch_lm_weights import lm_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3-8b"), attn_impl="pallas")
    assert cfg.dtype == "bfloat16"
    t0 = time.time()
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in
                  [params["embed"], params["lm_head"], params["final_norm"]]
                  + [t for lp in params["layers"] for part in lp.values()
                     for t in (part.values() if isinstance(part, dict)
                               else [part])])
    log(f"[serve] llama3-8b (32 layers, d 4096, 32/8 heads, hd 128, ff "
        f"14336, vocab 128256), bf16, attn_impl=pallas: {w_bytes / 1e9:.3f} "
        f"GB of random weights in {time.time() - t0:.1f}s")
    tok_gen = torch.Generator(device=dev).manual_seed(1)

    def tokens(b, t):
        return torch.randint(0, cfg.vocab, (b, t), generator=tok_gen,
                             device=dev, dtype=torch.int32)

    p1000, p4096, p512 = tokens(4, 1000), tokens(1, 4096), tokens(4, 512)
    prefill = make_prefill_step(cfg)
    kernel = kops.flash_attention
    captured = {}

    def attention(fn, capture=None):
        return routed("flash_attention", fn, capture, captured)

    def layers(name):
        return {0: f"{name} layer 0", 31: f"{name} layer 31"}

    # (b) prefills: finite, and within SERVE_REL_L2 of the plain attention
    logits = {}
    for name, toks in (("prefill-1000", p1000), ("prefill-4096", p4096)):
        with attention(kernel, layers(name)):
            got = prefill(params, {"tokens": toks})
        with attention(model_layout_ref):
            want = prefill(params, {"tokens": toks})
        naive = make_prefill_step(dataclasses.replace(
            cfg, attn_impl="naive"))(params, {"tokens": toks})
        assert got.shape == (toks.shape[0], cfg.vocab)
        assert bool(torch.isfinite(got).all()), name
        err = rel_l2(got, want)
        assert err <= SERVE_REL_L2, (name, err)
        logits[name] = got
        log(f"[serve] (b) {name}: logits finite, |max| "
            f"{float(got.abs().max()):.4f}; kernel vs plain attention: "
            f"rel L2 {err:.3e} (limit {SERVE_REL_L2}), max abs "
            f"{float((got - want).abs().max()):.4e}; vs the naive path "
            f"(p cast to bf16 before p @ v): rel L2 {rel_l2(got, naive):.3e}; "
            f"argmax agrees with the plain path in "
            f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/"
            f"{toks.shape[0]} rows")

    # (c) decode step by step: the prompt teacher-forced, then greedy, with
    # the inputs of q_offset 0, 511 and 543 kept
    steps = stepwise("[serve] (c) llama3-8b", cfg, params, p512, 32,
                     SERVE_REL_L2, lambda t: layers(f"decode q_offset={t}")
                     if t in (0, 511, 543) else None, captured)

    # the serve path, counted and timed
    gen, launches, routes = serve_path(
        "llama3-8b", cfg, params,
        {"prefill-1000": (p1000, logits["prefill-1000"]),
         "prefill-4096": (p4096, logits["prefill-4096"])}, p512, 32)
    assert launches == {"flash_attention": cfg.n_layers * (2 + 512 + 32 - 1),
                        "ssd_scan": 0}, launches
    # both bf16 prefills on the tensor cores, every decode step on decode
    assert routes == {"tc": cfg.n_layers * 2,
                      "decode": cfg.n_layers * (512 + 32 - 1), "fma": 0}, \
        routes
    assert torch.equal(gen, steps), (gen, steps)
    launches, main_routes = launches["flash_attention"], routes
    log("[serve] (c) llama3-8b greedy_generate's tokens equal the "
        "step-by-step decode's")

    # (a) the kernel against its plain version on the card, each call on
    # the route _route names for it
    max_err = 0.0
    checked = {"tc": 0, "decode": 0, "fma": 0}

    def check(what, fn, ref, q, k, v, **kw):
        nonlocal max_err
        before = dict(fa.route_launches)
        got, want = fn(q, k, v, **kw), ref(q, k, v, **kw)
        # (B, H, T, hd), or the model layout (B, T, H, hd) of captured calls
        qh, kh = (q, k) if fn is fa.flash_attention else (
            q.transpose(1, 2), k.transpose(1, 2))
        kind = fa._route(qh.shape[2], qh.shape[3], q.dtype, k.dtype,
                         qh.shape[1], kh.shape[1])
        assert fa.route_launches[kind] == before[kind] + 1, (
            what, kind, before, fa.route_launches)
        checked[kind] += 1
        tol = FA_TOL[str(q.dtype).split(".")[-1]]
        assert got.dtype == want.dtype == q.dtype and got.shape == want.shape
        d = (got.float() - want.float()).abs()
        bad = d > tol + tol * want.float().abs()
        assert not bool(bad.any()), (what, float(d.max()))
        max_err = max(max_err, float(d.max()))
        return float(d.max())

    errs = {name: check(name, kernel, model_layout_ref, *captured[name][0],
                        **captured[name][1]) for name in sorted(captured)}
    g = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    for what, (B, H, K, Tq, Tk, hd), qdt, kvdt, kw in (
            ("non-causal", (2, 32, 8, 100, 100, 128), bf16, bf16,
             dict(causal=False)),
            ("window=96", (2, 32, 8, 100, 100, 128), bf16, bf16,
             dict(window=96)),
            ("MQA", (2, 32, 1, 100, 100, 128), bf16, bf16, {}),
            ("f32", (2, 32, 8, 100, 100, 128), f32, f32, {}),
            ("f32 q, bf16 k/v", (2, 32, 8, 100, 100, 128), f32, bf16, {}),
            ("hd=64 window=40 q_offset=37", (1, 4, 2, 100, 150, 64), f32,
             f32, dict(window=40, q_offset=37)),
            ("hd=16 decode q_offset=99", (3, 4, 1, 1, 100, 16), f32, bf16,
             dict(q_offset=99)),
            # the tc route's edges: a ragged q tile (1000 = 7 x 128 + 104),
            # Tk past the last whole kv tile, q_offset > 0, the window's
            # trailing edge inside a tile, hd 16 / 64 / 80 (boxes zero-
            # filled past hd), a row with no live key
            ("tc Tq=1000", (1, 8, 2, 1000, 1000, 128), bf16, bf16, {}),
            ("tc non-causal Tk=300", (2, 32, 8, 100, 300, 128), bf16, bf16,
             dict(causal=False)),
            ("tc q_offset=50 Tq=100", (1, 32, 8, 100, 150, 128), bf16, bf16,
             dict(q_offset=50)),
            ("tc window=96 Tq=600", (1, 8, 2, 600, 600, 128), bf16, bf16,
             dict(window=96)),
            ("tc hd=16", (1, 4, 2, 200, 200, 16), bf16, bf16, {}),
            ("tc hd=64 G=4", (2, 8, 2, 300, 300, 64), bf16, bf16, {}),
            ("tc hd=80", (2, 8, 8, 300, 300, 80), bf16, bf16, {}),
            ("tc no live key", (1, 4, 2, 8, 8, 16), bf16, bf16,
             dict(q_offset=-4)),
            # the decode route's: B = 1, Tq = 1..4 (the keys split over
            # blocks), MQA's 32 rows, hd 80, a row with no live key
            *((f"decode B=1 Tq={t}", (1, 32, 8, t, 544, 128), bf16, bf16,
               dict(q_offset=544 - t)) for t in (1, 2, 3, 4)),
            ("decode MQA", (2, 32, 1, 1, 300, 128), bf16, bf16,
             dict(q_offset=299)),
            ("decode hd=80 window=96", (2, 8, 8, 2, 300, 80), bf16, bf16,
             dict(q_offset=250, window=96)),
            ("decode f32", (2, 8, 2, 3, 200, 64), f32, f32,
             dict(q_offset=197)),
            ("decode no live key", (1, 4, 2, 4, 8, 16), bf16, bf16,
             dict(q_offset=-4))):
        q = torch.randn((B, H, Tq, hd), generator=g, device=dev).to(qdt)
        k = torch.randn((B, K, Tk, hd), generator=g, device=dev).to(kvdt)
        v = torch.randn((B, K, Tk, hd), generator=g, device=dev).to(kvdt)
        errs[f"random {what}"] = check(what, fa.flash_attention,
                                       flash_attention_ref, q, k, v, **kw)
        if "no live key" in what:   # every query before key 0: zeros
            out = fa.flash_attention(q, k, v, **kw)
            assert not bool(out[:, :, :4].any()), what
    torch.cuda.synchronize()
    assert all(checked.values()), checked
    log("[serve] (a) flash_attention matches its plain version (max abs "
        "error): " + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; checks by route {checked}")

    # (d) the SMOKE config in f32 against the JAX-made reference
    ref = json.loads((TESTDATA / "llama3_smoke_serve_ref.json").read_text())
    scfg = dataclasses.replace(get_config(ref["arch"], smoke=True),
                               dtype="float32", attn_impl="pallas")
    sp = lm_params_from_jax(lm_weights(scfg, ref["seed"]), scfg)
    stoks = torch.tensor(ref["prompt"], dtype=torch.int32, device=dev)
    shape = (ref["steps"], ref["batch"], scfg.vocab)
    errs = {}

    def hold(what, got, key, tol):
        want = torch.tensor(ref[key], device=dev).reshape(got.shape)
        d = (got - want).abs()
        assert not bool((d > tol + tol * want.abs()).any()), (what,
                                                              float(d.max()))
        errs[what] = float(d.max())

    fa.reset_launches()
    hold("pallas prefill", make_prefill_step(scfg)(sp, {"tokens": stoks}),
         "prefill_last_logits", SMOKE_TOL)
    assert fa.route_launches == {"tc": 0, "decode": 0,
                                 "fma": scfg.n_layers}, fa.route_launches
    for impl, cdt, key, tol in (
            ("pallas", f32, "decode_logits_f32_cache", SMOKE_TOL),
            ("naive", f32, "decode_logits_f32_cache", SMOKE_TOL),
            ("naive", bf16, "decode_logits_bf16_cache",
             SMOKE_BF16_CACHE_TOL)):
        c = dataclasses.replace(scfg, attn_impl=impl)
        step = make_decode_step(c)
        cache = lm.init_cache(c, ref["batch"], ref["steps"], dtype=cdt)
        out = []
        for t in range(ref["steps"]):
            lg, cache = step(sp, cache, stoks[:, t:t + 1], t)
            out.append(lg)
        hold(f"{impl} decode, {str(cdt).split('.')[-1]} cache",
             torch.stack(out), key, tol)
    assert fa.route_launches == {
        "tc": 0, "decode": scfg.n_layers * ref["steps"],
        "fma": scfg.n_layers}, fa.route_launches
    log(f"[serve] (d) llama3-8b SMOKE, f32, on the card vs the JAX "
        f"reference (max abs error): {errs}; the prefill on fma, the f32 "
        f"decode on the decode route")

    # kernel times and bounds at the prefill-1000 and decode-544 shapes
    def timing(name):
        (q, k, v), kw = captured[name]
        return flash_timing(q, k, v, kw)

    prefill_t = timing("prefill-1000 layer 0")
    decode_t = timing("decode q_offset=543 layer 0")
    (q, k, v), kw = captured["prefill-1000 layer 0"]
    fma_t = flash_timing(q.float(), k.float(), v.float(), kw)  # f32 inputs
    assert (prefill_t["fa_route"], decode_t["fa_route"],
            fma_t["fa_route"]) == ("tc", "decode", "fma")
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:90",
             "launches": launches, "max_abs_err": max_err}
    entry.update(prefill_t)
    entry["routes"] = {
        "tc": dict(prefill_t, launches=main_routes["tc"],
                   prefill_4096=timing("prefill-4096 layer 0")),
        "decode": dict(decode_t, launches=main_routes["decode"]),
        "fma": dict(fma_t, launches=main_routes["fma"],
                    note="f32 inputs at prefill-1000's shapes; the f32 "
                         "checks and SMOKE prefills only")}
    entry["decode_544"] = decode_t
    log(f"[serve] flash_attention by route: {entry['routes']}")
    return entry


def stepwise(label, cfg, params, prompt, new, limit, capture=None,
             store=None, cache_len=None, pre=None, on_last=None,
             last_ctx=None):
    """Decode step by step through make_decode_step from a cache of
    ``cache_len`` (default: prompt and new tokens): the prompt
    teacher-forced, then ``new`` greedy tokens.  The logits at the last
    prompt position are held within ``limit`` (relative L2) of ``pre``
    (default: make_prefill_step's), or handed with ``pre`` to ``on_last``
    (the step itself run inside ``last_ctx``, where given); ``capture(t)``
    names the flash-attention calls of step t whose inputs are kept in
    ``store``.  Returns the greedy tokens (B, new)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    decode = make_decode_step(cfg)
    B, T = prompt.shape
    if pre is None:
        pre = make_prefill_step(cfg)(params, {"tokens": prompt})
    cache = lm.init_cache(cfg, B, cache_len or T + new)
    toks, out = [], None
    for t in range(T + new):
        if t >= T:
            toks.append(out.argmax(-1)[:, None].to(torch.int32))
        ctx = last_ctx if last_ctx and t == T - 1 else \
            contextlib.nullcontext()
        with routed("flash_attention", kops.flash_attention,
                    capture(t) if capture else None, store), ctx:
            out, cache = decode(params, cache, toks[-1] if t >= T
                                else prompt[:, t:t + 1], t)
        if t == T - 1 and on_last:
            on_last(out, pre)
        elif t == T - 1:
            err = rel_l2(out, pre)
            assert err <= limit, (label, "decode vs prefill", err)
            log(f"{label} decode at the last prompt position ({T - 1}) vs "
                f"make_prefill_step: rel L2 {err:.3e} (limit {limit}), max "
                f"abs {float((out - pre).abs().max()):.4e}, argmax agrees in "
                f"{int((out.argmax(-1) == pre.argmax(-1)).sum())}/{B} rows")
    return torch.cat(toks, dim=1)


def serve_path(arch, cfg, params, prefills, prompt, new,
               cache_len=None) -> tuple:
    """The serve path with every kernel's launch count set to 0 just
    before and read just after: the prefills ``{name: (tokens, or the
    batch dict with a vlm's ``vis_embed`` or an encdec's ``frames``, the
    checked run's logits)}``, which must give those logits again, then
    greedy_generate of ``new`` tokens after ``prompt`` with a cache of
    ``cache_len`` (default: prompt and new tokens).  Logs prefill
    tokens/s (a vlm's patch embeddings counted as rows; an encdec's
    frames logged beside), decode ms per step and peak memory.  Returns
    (generated tokens, launches by kernel, flash-attention launches by
    route)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.runtime.serve import greedy_generate, make_prefill_step
    torch.cuda.synchronize()
    ssd.reset_launches()
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    prefill = make_prefill_step(cfg)
    rates = []
    for name, (batch, want) in prefills.items():
        batch = batch if isinstance(batch, dict) else {"tokens": batch}
        toks, vis = batch["tokens"], batch.get("vis_embed")
        t0 = time.time()
        got = prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.time() - t0
        assert torch.equal(got, want), (arch, name)
        rows = toks.numel() + (0 if vis is None else vis.shape[0]
                               * vis.shape[1])
        shape = f"{toks.shape[0]}x" + (f"({vis.shape[1]}+{toks.shape[1]})"
                                       if vis is not None
                                       else f"{toks.shape[1]}")
        if "frames" in batch:
            shape += f" with {batch['frames'].shape[1]} frames a row"
        rates.append(f"{name} {shape} {wall:.4f}s ({rows / wall:.1f} "
                     f"tokens/s)")
    B, T = prompt.shape
    t0 = time.time()
    gen = greedy_generate(params, cfg, prompt, new, cache_len or T + new)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"flash_attention": fa.launches["flash_attention"],
                "ssd_scan": ssd.launches["ssd_scan"]}
    routes = dict(fa.route_launches)
    n_steps = T + new - 1
    log(f"[serve] {arch} serve path: prefill " + ", ".join(rates)
        + f"; greedy_generate {B} x ({T} + {new}) in {wall:.3f}s: "
        f"{wall / n_steps * 1e3:.3f} ms per decode step of {B} requests "
        f"({B * n_steps / wall:.1f} tokens/s); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
        f"launches {launches}, flash_attention by route {routes}")
    return gen, launches, routes


def ssd_timing(x, dt, A, B_, C_, chunk) -> dict:
    """The SSD kernel and its plain version on one call's inputs: device
    and wall ms, and the bound.  Operations counted as the function needs
    them: per (b, h, chunk) the causal half of the intra product P @ dt*x
    (2 P L(L+1)/2), C @ state in every chunk but the first (whose state is
    0) and the state update (2 L N P each); C B^T once per (b, chunk),
    lower triangle (B and C are shared across heads); float32 at the
    CUDA cores' rate.  Bytes: x, dt, A, B, C read and y and the final
    state written once."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_chunked_ref
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    L = min(chunk, T)
    nc = T // L
    flops = (Bb * H * nc * (P * L * (L + 1) + 2 * L * N * P)
             + Bb * H * (nc - 1) * 2 * L * N * P + Bb * nc * N * L * (L + 1))
    moved = (2 * x.numel() * x.element_size()
             + sum(t.numel() * t.element_size() for t in (dt, A, B_, C_))
             + Bb * H * N * P * 4)
    bnd, by = bound_ms(moved, flops)
    run = lambda: ssd.ssd_scan(x, dt, A, B_, C_, chunk=chunk)
    plain = lambda: ssd_chunked_ref(x, dt, A, B_, C_, chunk)
    return {"shape": f"x {tuple(x.shape)}, B/C {tuple(B_.shape)}, "
                     f"{str(x.dtype).split('.')[-1]}, chunk {L}",
            "ms": own_device_ms("ssd_scan", run),
            "plain_ms": device_ms(plain, reps=5)[0],
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "wall_ms": wall_ms(run), "plain_wall_ms": wall_ms(plain, reps=5),
            "gflop": flops / 1e9, "mbytes": moved / 1e6}


def serve_ssm(dev) -> tuple:
    """Phase 8: mamba2-2.7b and zamba2-2.7b served through the SSD kernel
    (and zamba2's shared attention through the flash kernel).  Returns the
    SSD kernel's entry of the ``kernels`` line and what it adds to flash
    attention's (the zamba2 path's launches, hd-80 checks and times)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_chunked_ref, ssd_ref
    from repro_torch.models import lm
    from repro_torch.runtime.serve import (greedy_generate, make_decode_step,
                                           make_prefill_step)
    from torch_lm_weights import SSM_SERVE_REF, lm_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tok_gen = torch.Generator(device=dev).manual_seed(1)
    captured, ssd_errs, fa_errs = {}, {}, {}

    def tokens(cfg, b, t):
        return torch.randint(0, cfg.vocab, (b, t), generator=tok_gen,
                             device=dev, dtype=torch.int32)

    def model(arch, **over):
        cfg = dataclasses.replace(get_config(arch), **over)
        assert cfg.dtype == "bfloat16"
        t0 = time.time()
        params = lm.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)
        torch.cuda.synchronize()
        n_bytes = nbytes(params)
        log(f"[ssm] {arch} ({cfg.n_layers} Mamba2 layers, d {cfg.d_model}, "
            f"{cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
            f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab}"
            + (f", shared attention+MLP after every {cfg.hybrid_attn_every}:"
               f" {cfg.n_heads} heads x hd {cfg.hd}, ff {cfg.d_ff}, "
               f"attn_impl={cfg.attn_impl}" if cfg.kind == "hybrid" else "")
            + f"), bf16: {n_bytes / 1e9:.3f} GB of random weights in "
            f"{time.time() - t0:.1f}s")
        return cfg, params

    def ssd_check(what, x, dt, A, B_, C_, chunk, seq=False):
        """The kernel against its plain version (and, with ``seq``, the
        sequential oracle): y and the final state."""
        x, dt, A, B_, C_ = (t.contiguous() for t in (x, dt, A, B_, C_))
        y, st = ssd.ssd_scan(x, dt, A, B_, C_, chunk=chunk)
        wants = [ssd_chunked_ref(x, dt, A, B_, C_, chunk)]
        if seq:
            wants.append(ssd_ref(x, dt, A, B_, C_))
        tol = SSD_TOL[str(x.dtype).split(".")[-1]]
        assert y.dtype == x.dtype and y.shape == x.shape, what
        err = 0.0
        for wy, ws in wants:
            for got, want in ((y.float(), wy.to(x.dtype).float()), (st, ws)):
                d = (got - want).abs()
                assert not bool((d > tol + tol * want.abs()).any()), (
                    what, float(d.max()))
                err = max(err, float(d.max()))
        ssd_errs[what] = err

    def fa_check(what, q, k, v, **kw):
        got, want = kops.flash_attention(q, k, v, **kw), \
            model_layout_ref(q, k, v, **kw)
        tol = FA_TOL[str(q.dtype).split(".")[-1]]
        d = (got.float() - want.float()).abs()
        assert not bool((d > tol + tol * want.float().abs()).any()), (
            what, float(d.max()))
        fa_errs[what] = float(d.max())

    def prefill_vs_plain(arch, cfg, params, name, toks, limit, ssd_cap=None,
                         fa_cap=None):
        prefill = make_prefill_step(cfg)
        with routed("ssd_scan", kops.ssd_scan, ssd_cap, captured), \
                routed("flash_attention", kops.flash_attention, fa_cap,
                       captured):
            got = prefill(params, {"tokens": toks})
        with routed("ssd_scan", plain_ssd), \
                routed("flash_attention", model_layout_ref):
            want = prefill(params, {"tokens": toks})
        chunk64 = make_prefill_step(dataclasses.replace(cfg, ssm_chunk=64))(
            params, {"tokens": toks})
        assert got.shape == (toks.shape[0], cfg.vocab)
        assert bool(torch.isfinite(got).all()), (arch, name)
        err, floor = rel_l2(got, want), rel_l2(chunk64, got)
        assert err <= limit, (arch, name, err)
        assert floor <= SSM_REL_L2, (arch, name, "chunk 64", floor)
        log(f"[ssm] (b) {arch} {name}: logits finite, |max| "
            f"{float(got.abs().max()):.4f}; kernels vs plain versions: rel "
            f"L2 {err:.3e} (limit {limit}), max abs "
            f"{float((got - want).abs().max()):.4e}; argmax agrees in "
            f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/"
            f"{toks.shape[0]} rows; the rounding floor, chunk 64 vs 128: "
            f"rel L2 {floor:.3e} (limit {SSM_REL_L2})")
        return got

    # ---- mamba2-2.7b: (b) prefills and decode, the serve path -------------
    cfg, params = model("mamba2-2.7b", n_layers=MAMBA2_LAYERS)
    last = cfg.n_layers - 1
    p1024, p4096, p512 = (tokens(cfg, 4, 1024), tokens(cfg, 1, 4096),
                          tokens(cfg, 4, 512))
    logits = {name: prefill_vs_plain(
        "mamba2-2.7b", cfg, params, name, toks, SERVE_REL_L2,
        {0: f"mamba2 {name} layer 0", last: f"mamba2 {name} layer {last}"})
        for name, toks in (("prefill-1024", p1024), ("prefill-4096", p4096))}
    steps = stepwise("[ssm] (b) mamba2-2.7b", cfg, params, p512, 32,
                     SSM_REL_L2)
    gen, launches, _ = serve_path(
        "mamba2-2.7b", cfg, params,
        {"prefill-1024": (p1024, logits["prefill-1024"]),
         "prefill-4096": (p4096, logits["prefill-4096"])}, p512, 32)
    assert torch.equal(gen, steps), (gen, steps)
    assert launches == {"ssd_scan": 2 * cfg.n_layers,
                        "flash_attention": 0}, launches
    ssd_launches = {"mamba2-2.7b": launches["ssd_scan"]}
    log("[ssm] (b) mamba2-2.7b greedy_generate's tokens equal the "
        "step-by-step decode's")
    del params, logits

    # ---- zamba2-2.7b, attn_impl="pallas": (c) ----------------------------
    cfg, params = model("zamba2-2.7b", attn_impl="pallas")
    n_app = cfg.n_layers // cfg.hybrid_attn_every
    pz, p64 = tokens(cfg, 4, 1024), tokens(cfg, 4, 64)
    got = prefill_vs_plain(
        "zamba2-2.7b", cfg, params, "prefill-1024", pz, SSM_REL_L2,
        {0: "zamba2 prefill-1024 layer 0"},
        {0: "zamba2 prefill-1024 attention 0",
         n_app - 1: f"zamba2 prefill-1024 attention {n_app - 1}"})
    steps = stepwise("[ssm] (c) zamba2-2.7b", cfg, params, p64, 16,
                     SSM_REL_L2, lambda t: {0: f"zamba2-2.7b decode q_offset="
                                            f"{t}"} if t in (0, 63, 79)
                     else None, captured)
    gen, launches, routes = serve_path("zamba2-2.7b", cfg, params,
                                       {"prefill-1024": (pz, got)}, p64, 16)
    assert torch.equal(gen, steps), (gen, steps)
    assert launches == {"ssd_scan": cfg.n_layers,
                        "flash_attention": n_app * (1 + 64 + 16 - 1)}, \
        launches
    assert routes == {"tc": n_app, "decode": n_app * (64 + 16 - 1),
                      "fma": 0}, routes
    ssd_launches["zamba2-2.7b"] = launches["ssd_scan"]
    fa_launches, fa_routes = launches["flash_attention"], routes
    log("[ssm] (c) zamba2-2.7b greedy_generate's tokens equal the "
        "step-by-step decode's")
    del params
    for name in sorted(k for k in captured if "attention" in k
                       or "decode" in k):
        (q, k, v), kw = captured[name]
        assert q.shape[-1] == cfg.hd, (name, q.shape)
        fa_check(name, q, k, v, **kw)
    torch.cuda.synchronize()
    log(f"[ssm] (c) flash_attention at hd {cfg.hd} matches its plain version "
        f"(max abs error): " + "; ".join(f"{k} {v:.3e}" for k, v in fa_errs.items()))

    # ---- (a) the SSD kernel against its plain version ---------------------
    for name in sorted(k for k in captured if "layer" in k):
        (x, dt, A, B_, C_, chunk), _ = captured[name]
        ssd_check(name, x, dt, A, B_, C_, chunk)
    g = torch.Generator(device=dev).manual_seed(3)
    for (B, T, H, P, N, chunk) in ((1, 128, 2, 32, 16, 32),
                                   (2, 256, 4, 64, 64, 128),
                                   (1, 64, 8, 16, 32, 64),
                                   (2, 45, 3, 16, 8, 128),
                                   (2, 960, 3, 72, 20, 48)):
        for dtype in (torch.float32, torch.bfloat16):
            rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
            x = rnd(B, T, H, P).to(dtype)
            dt = torch.nn.functional.softplus(rnd(B, T, H))
            A = -torch.exp(rnd(H) * 0.3)
            B_ = (rnd(B, T, N) / N ** 0.5).to(dtype)
            C_ = (rnd(B, T, N) / N ** 0.5).to(dtype)
            ssd_check(f"random {(B, T, H, P, N)} chunk {chunk} "
                      f"{str(dtype).split('.')[-1]}", x, dt, A, B_, C_,
                      chunk, seq=T == 128)
    torch.cuda.synchronize()
    log("[ssm] (a) ssd_scan matches its plain version, y and final state "
        "(max abs error; T = 128 also the sequential ssd_ref): "
        + "; ".join(f"{k} {v:.3e}" for k, v in ssd_errs.items()))

    # ---- (d) the f32 SMOKE configs against the JAX-made references --------
    for arch, path in (("mamba2-2.7b", "mamba2_smoke_serve_ref.json"),
                       ("zamba2-2.7b", "zamba2_smoke_serve_ref.json")):
        ref = json.loads((TESTDATA / path).read_text())
        assert {k: ref[k] for k in SSM_SERVE_REF[arch]} == SSM_SERVE_REF[arch]
        scfg = dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32", attn_impl="pallas")
        sp = lm_params_from_jax(lm_weights(scfg, ref["seed"]), scfg)
        stoks = torch.tensor(ref["prompt"], dtype=torch.int32, device=dev)
        errs = {}

        def hold(what, got, key):
            want = torch.tensor(ref[key], device=dev).reshape(got.shape)
            d = (got - want).abs()
            assert not bool((d > SSM_SMOKE_TOL + SSM_SMOKE_TOL
                             * want.abs()).any()), (arch, what, float(d.max()))
            errs[what] = float(d.max())

        ssd.reset_launches()
        hold("prefill", make_prefill_step(scfg)(sp, {"tokens": stoks}),
             "prefill_last_logits")
        assert ssd.launches["ssd_scan"] == scfg.n_layers
        step = make_decode_step(scfg)
        cache = lm.init_cache(scfg, ref["batch"], ref["steps"],
                              dtype=torch.float32)
        out = []
        for t in range(ref["steps"]):
            lg, cache = step(sp, cache, stoks[:, t:t + 1], t)
            out.append(lg)
        hold("decode, f32 cache", torch.stack(out), "decode_logits_f32_cache")
        gen = greedy_generate(sp, scfg, stoks, ref["new"],
                              ref["steps"] + ref["new"])
        assert gen.tolist() == ref["greedy_tokens"], (arch, gen.tolist())
        log(f"[ssm] (d) {arch} SMOKE, f32, on the card vs the JAX reference "
            f"(max abs error, limit {SSM_SMOKE_TOL}): {errs}; greedy tokens "
            f"equal")

    # ---- (e) times ---------------------------------------------------------
    timing = {name: ssd_timing(*captured[f"{name} layer 0"][0])
              for name in ("mamba2 prefill-1024", "mamba2 prefill-4096",
                           "zamba2 prefill-1024")}
    (q, k, v), kw = captured["zamba2 prefill-1024 attention 0"]
    fa_t = flash_timing(q, k, v, kw)
    log(f"[ssm] ssd_scan at mamba2 prefill-1024: "
        f"{timing['mamba2 prefill-1024']}; at prefill-4096: "
        f"{timing['mamba2 prefill-4096']}; at zamba2 prefill-1024: "
        f"{timing['zamba2 prefill-1024']}; flash_attention at zamba2 "
        f"prefill-1024 (hd 80): {fa_t}")
    entry = {"name": "ssd_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:63",
             "launches": sum(ssd_launches.values()),
             "launches_by_path": ssd_launches,
             "max_abs_err": max(ssd_errs.values())}
    entry.update(timing["mamba2 prefill-1024"])
    entry["prefill_4096"] = timing["mamba2 prefill-4096"]
    entry["zamba2_prefill_1024"] = timing["zamba2 prefill-1024"]
    return entry, {"launches_zamba2": fa_launches,
                   "routes_zamba2": fa_routes,
                   "max_abs_err_hd80": max(fa_errs.values()),
                   "zamba2_prefill_1024_hd80": fa_t}


#: The MoE cells' depth cut: (architecture, layers kept of the published
#: 56 and 64) -- at full width ~5.0 and ~9.8 GB of bf16 weights a layer.
MOE_MODELS = (("mixtral-8x22b", 4), ("grok-1-314b", 2))


#: A router near tie: a token's k-th and (k+1)-th gates within this of each
#: other.  Two evaluations that round differently (kernel or plain
#: attention; decode or prefill) move a gate gap by up to ~5e-3 on an H100
#: (mixtral-8x22b's last prompt position, decode against prefill), so a
#: token whose experts differ between them must sit this close to a tie
#: in one of the two at the first layer where they differ.
TIE_GAP = 1e-2


@contextlib.contextmanager
def moe_spy(store, drops=None):
    """For every MoE call of the models (``apply_moe`` in a prefill,
    ``apply_moe_dense`` in decode) keep in ``store`` each token's top-k
    experts, sorted, (B, T, k) and the gap between its k-th and (k+1)-th
    gate (B, T); with ``drops``, also the (token, slot) pairs each
    ``apply_moe`` call dropped."""
    import torch
    from repro_torch.models import layers
    apply_moe, apply_dense = layers.apply_moe, layers.apply_moe_dense

    def record(p, x, cfg):
        gates, _, topi = layers.moe_gates(p, x.to(layers.dtype_of(cfg)), cfg)
        k = cfg.experts_per_tok
        top = torch.topk(gates, k + 1, dim=-1).values
        store.append((topi.sort(-1).values, top[..., k - 1] - top[..., k]))

    def moe(p, x, cfg, group=None):
        record(p, x, cfg)
        if drops is not None:
            drops.append(int(layers.moe_dropped(p, x, cfg, group)))
        return apply_moe(p, x, cfg, group)

    def dense(p, x, cfg):
        record(p, x, cfg)
        return apply_dense(p, x, cfg)

    layers.apply_moe, layers.apply_moe_dense = moe, dense
    try:
        yield
    finally:
        layers.apply_moe, layers.apply_moe_dense = apply_moe, apply_dense


def routed_alike(label, got, want, got_routes, want_routes, limit) -> int:
    """Logits (B, V) of two evaluations of a MoE model, row by row, with
    each evaluation's ``moe_spy`` records (the last position's taken): a
    row routed to the same experts in every layer must be within
    ``limit`` (relative L2); a row routed otherwise must sit on a near tie
    (a gate gap of at most TIE_GAP in one of the two) at the first layer
    where the experts differ, since a different expert makes it another
    function.  Returns the rows routed alike (the caller holds at least
    half of its rows to that)."""
    B = got.shape[0]
    rel = ((got - want).float().norm(dim=-1) / want.float().norm(dim=-1))
    rows = []
    for b in range(B):
        differs = [i for i, ((gt, _), (wt, _)) in
                   enumerate(zip(got_routes, want_routes))
                   if not bool((gt[b, -1] == wt[b, -1]).all())]
        if not differs:
            assert float(rel[b]) <= limit, (label, b, float(rel[b]))
            rows.append(f"row {b}: same experts, rel L2 {float(rel[b]):.3e}")
            continue
        i = differs[0]
        gap = min(float(got_routes[i][1][b, -1]),
                  float(want_routes[i][1][b, -1]))
        assert gap <= TIE_GAP, (label, b, "experts differ at layer", i,
                                "gate gap", gap)
        rows.append(f"row {b}: other experts from layer {i} (a near tie: "
                    f"gate gap {gap:.2e}), rel L2 {float(rel[b]):.3e}")
    log(f"{label}: rel L2 over all rows {rel_l2(got, want):.3e} (limit "
        f"{limit} for rows routed alike); " + "; ".join(rows))
    return sum("same" in r for r in rows)


def serve_moe(dev) -> dict:
    """Phase 9: mixtral-8x22b (its sliding window of 4096 and decode ring)
    and grok-1-314b at full width, depth cut (MOE_MODELS), served through
    the flash-attention kernel.  Returns what the phase adds to flash
    attention's entry of the ``kernels`` line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import lm
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    from torch_lm_weights import MOE_SERVE_REF, lm_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.time()
    tok_gen = torch.Generator(device=dev).manual_seed(1)
    captured, errs, launches, routes = {}, {}, {}, {}
    checked = {"tc": 0, "decode": 0, "fma": 0}

    def tokens(cfg, b, t):
        return torch.randint(0, cfg.vocab, (b, t), generator=tok_gen,
                             device=dev, dtype=torch.int32)

    def model(arch, n_layers):
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                                  attn_impl="pallas")
        assert cfg.dtype == "bfloat16" and cfg.kind == "moe"
        t0 = time.time()
        params = lm.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)
        torch.cuda.synchronize()
        log(f"[moe] {arch} ({n_layers} of {get_config(arch).n_layers} "
            f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
            f"hd {cfg.hd}, {cfg.n_experts} experts top-{cfg.experts_per_tok} "
            f"of ff {cfg.d_ff}, capacity factor {cfg.capacity_factor}, "
            f"groups of {cfg.moe_group}, window {cfg.window}, vocab "
            f"{cfg.vocab}), bf16, attn_impl=pallas: "
            f"{nbytes(params) / 1e9:.3f} GB of random weights in "
            f"{time.time() - t0:.1f}s")
        return cfg, params

    def layers_of(n_layers, name):
        return {0: f"{name} layer 0",
                n_layers - 1: f"{name} layer {n_layers - 1}"}

    def prefill_vs_plain(arch, cfg, params, name, toks):
        """Finite, and row by row within SERVE_REL_L2 of the same model
        with attention through the plain version where routed alike
        (``routed_alike``); the q/k/v of the first and last layer kept.
        Logs how many tokens each layer routes otherwise in the two runs.
        Returns the logits and the rows routed alike."""
        prefill = make_prefill_step(cfg)
        k_top, p_top = [], []
        with routed("flash_attention", kops.flash_attention,
                    layers_of(cfg.n_layers, f"{arch} {name}"), captured), \
                moe_spy(k_top):
            got = prefill(params, {"tokens": toks})
        with routed("flash_attention", model_layout_ref), moe_spy(p_top):
            want = prefill(params, {"tokens": toks})
        assert got.shape == (toks.shape[0], cfg.vocab)
        assert bool(torch.isfinite(got).all()), (arch, name)
        flips = [int((a != b).any(-1).sum())
                 for (a, _), (b, _) in zip(k_top, p_top)]
        log(f"[moe] {arch} {name}: logits finite, |max| "
            f"{float(got.abs().max()):.4f}; max abs "
            f"{float((got - want).abs().max()):.4e} from the plain "
            f"attention's; argmax agrees in "
            f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/"
            f"{toks.shape[0]} rows; tokens routed to other experts than in "
            f"the plain run, by layer: {flips} of {toks.numel()}")
        alike = routed_alike(f"[moe] {arch} {name}, kernel vs plain "
                             f"attention", got, want, k_top, p_top,
                             SERVE_REL_L2)
        return got, alike

    def no_drop_prefill(arch, cfg, params, toks):
        """The prefill at capacity factor E / k (the function decode
        computes): no (token, slot) pair may be dropped.  Returns the
        logits and the routing (``moe_spy``'s records)."""
        c = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                / cfg.experts_per_tok)
        top, drops = [], []
        with moe_spy(top, drops):
            pre = make_prefill_step(c)(params, {"tokens": toks})
        assert drops == [0] * cfg.n_layers, (arch, drops)
        log(f"[moe] {arch} prefill of the generate prompt at capacity factor "
            f"{c.capacity_factor}: dropped (token, slot) pairs by layer "
            f"{drops}")
        return pre, top

    def serve_cell(arch, n_layers, prefills, prompt, new, cache_len, cap):
        cfg, params = model(arch, n_layers)
        logits, alike = {}, []
        for name, toks in prefills.items():
            logits[name], n_alike = prefill_vs_plain(arch, cfg, params, name,
                                                     toks)
            alike.append((n_alike, toks.shape[0]))
        # at least half of the prefills' rows routed alike, and of decode's
        assert 2 * sum(a for a, _ in alike) >= sum(n for _, n in alike), \
            (arch, alike)
        pre, pre_routes = no_drop_prefill(arch, cfg, params, prompt)
        dec_routes = []

        def decode_vs_prefill(out, pre):
            n_alike = routed_alike(
                f"[moe] {arch} decode at the last prompt position "
                f"({prompt.shape[1] - 1}) vs the drop-free prefill", out, pre,
                dec_routes, pre_routes, SERVE_REL_L2)
            assert 2 * n_alike >= out.shape[0], (arch, n_alike)

        steps = stepwise(
            f"[moe] {arch}", cfg, params, prompt, new, SERVE_REL_L2, cap,
            captured, cache_len=cache_len, pre=pre,
            last_ctx=moe_spy(dec_routes), on_last=decode_vs_prefill)
        gen, n, by_route = serve_path(
            arch, cfg, params, {k: (v, logits[k]) for k, v in
                                prefills.items()}, prompt, new, cache_len)
        assert torch.equal(gen, steps), (arch, gen, steps)
        T = prompt.shape[1]
        assert n == {"flash_attention": cfg.n_layers * (len(prefills) + T
                                                        + new - 1),
                     "ssd_scan": 0}, (arch, n)
        # every bf16 prefill on tc, every decode step on decode, fma never
        assert by_route == {"tc": cfg.n_layers * len(prefills),
                            "decode": cfg.n_layers * (T + new - 1),
                            "fma": 0}, (arch, by_route)
        launches[arch], routes[arch] = n["flash_attention"], by_route
        log(f"[moe] {arch} greedy_generate's tokens (cache "
            f"{cache_len or T + new}) equal the step-by-step decode's")
        del params

    # ---- mixtral-8x22b: window 4096, a decode ring of 512 -----------------
    arch, n_layers = MOE_MODELS[0]
    get = get_config(arch)
    p1024, p8192, p512 = (tokens(get, 4, 1024), tokens(get, 1, 8192),
                          tokens(get, 4, 512))
    # decode at 0 (511 slots never written), 511 (the ring full), 512 and
    # 542 (wrapped); position 511 of the ring of 512 attends what a cache
    # of 544 would, so its logits are held against the prefill
    serve_cell(arch, n_layers, {"prefill-1024": p1024, "prefill-8192": p8192},
               p512, 32, 512,
               lambda t: layers_of(n_layers, f"{arch} decode q_offset={t}")
               if t in (0, 511, 512, 542) else None)
    torch.cuda.empty_cache()

    # ---- grok-1-314b: no window ------------------------------------------
    arch, n_layers = MOE_MODELS[1]
    get = get_config(arch)
    serve_cell(arch, n_layers, {"prefill-1024": tokens(get, 4, 1024)},
               tokens(get, 4, 64), 16, None, None)
    torch.cuda.empty_cache()
    t_paths = time.time() - t_phase

    # ---- (a) the kernel against its plain version -------------------------
    def check(what, fn, ref, q, k, v, layout, **kw):
        before = dict(fa.route_launches)
        got, want = fn(q, k, v, **kw), ref(q, k, v, **kw)
        qh, kh = (q, k) if layout == "bhtd" else (q.transpose(1, 2),
                                                  k.transpose(1, 2))
        kind = fa._route(qh.shape[2], qh.shape[3], q.dtype, k.dtype,
                         qh.shape[1], kh.shape[1], ring=kw.get("ring"))
        assert fa.route_launches[kind] == before[kind] + 1, (what, kind)
        checked[kind] += 1
        tol = FA_TOL[str(q.dtype).split(".")[-1]]
        assert got.dtype == want.dtype == q.dtype and got.shape == want.shape
        d = (got.float() - want.float()).abs()
        assert not bool((d > tol + tol * want.float().abs()).any()), (
            what, float(d.max()))
        errs[what] = float(d.max())

    for name in sorted(captured):
        (q, k, v), kw = captured[name]
        check(name, kops.flash_attention, model_layout_ref, q, k, v, "bthd",
              **kw)
        assert kw.get("ring") == ("decode" in name and "mixtral" in name)
        assert kw.get("window") == (4096 if "mixtral" in name else None)
    g = torch.Generator(device=dev).manual_seed(4)
    bf16 = torch.bfloat16
    ring4096 = (torch.randn((4, 48, 1, 128), generator=g, device=dev).to(bf16),
                *(torch.randn((4, 8, 4096, 128), generator=g,
                              device=dev).to(bf16) for _ in range(2)))
    check("random ring S=4096 q_offset=4159", fa.flash_attention,
          flash_attention_ref, *ring4096, "bhtd", window=4096, q_offset=4159,
          ring=True)
    torch.cuda.synchronize()
    assert checked["tc"] and checked["decode"] and not checked["fma"], checked
    log("[moe] (a) flash_attention matches its plain version (max abs "
        "error): " + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; checks by route {checked}")

    # ---- (d) the f32 SMOKE configs against the JAX-made references --------
    for arch, _ in MOE_MODELS:
        path = TESTDATA / f"{arch.split('-')[0]}_smoke_serve_ref.json"
        ref = json.loads(path.read_text())
        assert {k: ref[k] for k in MOE_SERVE_REF[arch]} == MOE_SERVE_REF[arch]
        scfg = dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32", attn_impl="pallas")
        sp = lm_params_from_jax(lm_weights(scfg, ref["seed"]), scfg)
        stoks = torch.tensor(ref["prompt"], dtype=torch.int32, device=dev)
        got = make_prefill_step(scfg)(sp, {"tokens": stoks})
        smoke = {"prefill": (got, "prefill_last_logits")}
        steps, new = ref["steps"], ref["new"]
        step = make_decode_step(scfg)
        cache = lm.init_cache(scfg, ref["batch"], steps + new,
                              dtype=torch.float32)
        out, tok, gen = [], stoks[:, :1], []
        for t in range(steps + new - 1):
            lg, cache = step(sp, cache, tok, t)
            if t < steps:
                out.append(lg)
            if t + 1 < steps:
                tok = stoks[:, t + 1:t + 2]
            else:
                tok = lg.argmax(-1)[:, None].to(torch.int32)
                gen.append(tok)
        smoke["decode, f32 cache"] = (torch.stack(out), "position_logits")
        held = {}
        for what, (got, key) in smoke.items():
            want = torch.tensor(ref[key], device=dev).reshape(got.shape)
            d = (got - want).abs()
            assert not bool((d > SMOKE_TOL + SMOKE_TOL * want.abs()).any()), (
                arch, what, float(d.max()))
            held[what] = float(d.max())
        assert torch.cat(gen, 1).tolist() == ref["greedy_tokens"], arch
        log(f"[moe] (d) {arch} SMOKE, f32, on the card vs the JAX reference "
            f"(max abs error, limit {SMOKE_TOL}): {held}; greedy tokens "
            f"equal")

    # ---- (e) times ---------------------------------------------------------
    def timing(name):
        (q, k, v), kw = captured[name]
        return flash_timing(q, k, v, kw)

    tc_w = timing("mixtral-8x22b prefill-8192 layer 0")
    ring512 = timing("mixtral-8x22b decode q_offset=542 layer 0")
    # the same keys as one run of 512 slots from 0: the ring's walk (two
    # runs, positions 31 .. 542) against a plain cache's at equal work
    (q, k, v), kw = captured["mixtral-8x22b decode q_offset=542 layer 0"]
    ring512["flat_512"] = flash_timing(q, k, v, dict(window=4096,
                                                     q_offset=511))
    q, k, v = (t.transpose(1, 2) for t in ring4096)
    ring_4096 = flash_timing(q, k, v, dict(window=4096, q_offset=4159,
                                           ring=True))
    assert (tc_w["fa_route"], ring512["fa_route"], ring_4096["fa_route"]) \
        == ("tc", "decode", "decode")
    log(f"[moe] flash_attention at mixtral prefill-8192 (window 4096): "
        f"{tc_w}; on the ring of 512: {ring512}; on a ring of 4096: "
        f"{ring_4096}; phase 9 wall {time.time() - t_phase:.1f}s (the serve "
        f"paths {t_paths:.1f}s)")
    return {"routes": {
        "tc": {"mixtral_prefill_8192_w4096": dict(
            tc_w, launches=routes["mixtral-8x22b"]["tc"])},
        "decode": {"mixtral_ring_512": dict(
            ring512, launches=routes["mixtral-8x22b"]["decode"]),
            "mixtral_ring_4096": dict(
                ring_4096, launches=0, note="one random call: B 4, S 4096, "
                                            "position 4159 (wrapped)")}},
        "launches_moe": launches, "routes_moe": routes,
        "max_abs_err_moe": max(errs.values())}


#: internvl2-26b's depth in phase 10, cut from 48 so that the phase fits
#: the script's time (~8.5 GB of weights at full width).
INTERNVL2_LAYERS = 8


def serve_mm(dev) -> dict:
    """Phase 10: whisper-small at full size (its non-causal encoder over
    1500 frames, cross-attention in the prefill and in decode) and
    internvl2-26b at full width, depth cut (INTERNVL2_LAYERS; 256 patch
    embeddings ahead of the tokens), served through the flash-attention
    kernel.  Returns what the phase adds to flash attention's entry of
    the ``kernels`` line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import lm
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    from torch_lm_weights import MM_SERVE_REF, frames, lm_weights, vis_embed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.time()
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    captured, errs, launches, routes = {}, {}, {}, {}
    checked = {"tc": 0, "decode": 0, "fma": 0}

    def tokens(cfg, b, t):
        return torch.randint(0, cfg.vocab, (b, t), generator=gen,
                             device=dev, dtype=torch.int32)

    def embeds(cfg, b, t):
        return torch.randn((b, t, cfg.d_model), generator=gen, device=dev,
                           dtype=torch.float32).to(bf16)

    def model(arch, **over):
        cfg = dataclasses.replace(get_config(arch), attn_impl="pallas",
                                  **over)
        assert cfg.dtype == "bfloat16"
        t0 = time.time()
        params = lm.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)
        torch.cuda.synchronize()
        log(f"[mm] {arch} ({cfg.n_layers} of {get_config(arch).n_layers} "
            f"layers" + (f" + {cfg.n_enc_layers} encoder layers over "
                         f"{cfg.enc_seq} frames" if cfg.n_enc_layers else
                         f", {cfg.n_vis_tokens} patch embeddings")
            + f", d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
            f"{cfg.hd}, ff {cfg.d_ff}, vocab {cfg.vocab}), bf16, "
            f"attn_impl=pallas: {nbytes(params) / 1e9:.3f} GB of random "
            f"weights in {time.time() - t0:.1f}s")
        return cfg, params

    def prefill_vs_plain(arch, cfg, params, name, batch, capture, stub):
        """Finite, within SERVE_REL_L2 of the same model with attention
        through the plain version, and moved by more than SERVE_REL_L2
        when the ``stub`` input (frames, patch embeddings) is zeros; the
        flash calls named in ``capture`` kept.  Returns the logits."""
        prefill = make_prefill_step(cfg)
        with routed("flash_attention", kops.flash_attention, capture,
                    captured):
            got = prefill(params, batch)
        with routed("flash_attention", model_layout_ref):
            want = prefill(params, batch)
        blank = prefill(params, dict(batch, **{stub: torch.zeros_like(
            batch[stub])}))
        assert got.shape == (batch["tokens"].shape[0], cfg.vocab)
        assert bool(torch.isfinite(got).all()), (arch, name)
        err, moved = rel_l2(got, want), rel_l2(blank, got)
        assert err <= SERVE_REL_L2, (arch, name, err)
        assert moved > SERVE_REL_L2, (arch, name, stub, moved)
        log(f"[mm] (b) {arch} {name}: logits finite, |max| "
            f"{float(got.abs().max()):.4f}; kernel vs plain attention: rel "
            f"L2 {err:.3e} (limit {SERVE_REL_L2}), max abs "
            f"{float((got - want).abs().max()):.4e}, argmax agrees in "
            f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/"
            f"{got.shape[0]} rows; {stub} zeroed: rel L2 {moved:.3e} away "
            f"(not vacuous)")
        return got

    def counted(arch, cfg, params, prefills, prompt, new, steps, per_step,
                per_prefill, cache_len=None):
        """serve_path, its tokens equal to ``steps`` and its launches: every
        prefill call on tc, every decode call on decode, fma never."""
        out, n, by_route = serve_path(arch, cfg, params, prefills, prompt,
                                      new, cache_len)
        assert torch.equal(out, steps), (arch, out, steps)
        T = prompt.shape[1]
        want = {"tc": per_prefill * len(prefills),
                "decode": per_step * (T + new - 1), "fma": 0}
        assert by_route == want, (arch, by_route, want)
        assert n == {"flash_attention": sum(want.values()), "ssd_scan": 0}, \
            (arch, n)
        launches[arch], routes[arch] = n["flash_attention"], by_route
        log(f"[mm] {arch} greedy_generate's tokens (cache "
            f"{cache_len or T + new}) equal the step-by-step decode's")

    # ---- whisper-small: 12 + 12 layers, 1500 frames ------------------------
    arch = "whisper-small"
    cfg, params = model(arch)
    L, E = cfg.n_layers, cfg.n_enc_layers
    f4 = embeds(cfg, 4, cfg.enc_seq)
    p448, p64 = tokens(cfg, 4, 448), tokens(cfg, 4, 64)
    # a prefill's calls: the encoder's E, then self and cross a decoder
    # layer; a decode step's: self and cross a layer
    logits = prefill_vs_plain(
        arch, cfg, params, "prefill-448", {"tokens": p448, "frames": f4},
        {0: f"{arch} encoder layer 0", E - 1: f"{arch} encoder layer {E - 1}",
         E: f"{arch} prefill-448 self layer 0",
         E + 1: f"{arch} prefill-448 cross layer 0",
         E + 2 * L - 1: f"{arch} prefill-448 cross layer {L - 1}"}, "frames")
    pre64 = make_prefill_step(cfg)(params, {"tokens": p64, "frames": f4})
    # (c) decode with enc_out assigned from encode: the last prompt step
    # against the prefill with the frames
    decode = make_decode_step(cfg)
    cache = lm.init_cache(cfg, 4, 64)
    cache["enc_out"] = lm.encode(params, f4, cfg)
    names = {0: "self", 1: "cross", 2 * L - 2: "self", 2 * L - 1: "cross"}
    for t in range(64):
        cap = {i: f"{arch} decode q_offset={t} {n} layer {i // 2}"
               for i, n in names.items()} if t == 63 else None
        with routed("flash_attention", kops.flash_attention, cap, captured):
            out, cache = decode(params, cache, p64[:, t:t + 1], t)
    err = rel_l2(out, pre64)
    assert err <= SERVE_REL_L2, (arch, "decode with enc_out vs prefill", err)
    log(f"[mm] (c) {arch} decode with cache['enc_out'] = encode(frames), at "
        f"the last prompt position (63) vs make_prefill_step with the "
        f"frames: rel L2 {err:.3e} (limit {SERVE_REL_L2}), argmax agrees in "
        f"{int((out.argmax(-1) == pre64.argmax(-1)).sum())}/4 rows")

    def zero_enc_out(out, pre):      # ROADMAP C20: greedy_generate's cache
        gap = rel_l2(out, pre)
        assert gap > SERVE_REL_L2, (arch, "zero enc_out", gap)
        log(f"[mm] (c) {arch} decode with the fresh cache's zero enc_out "
            f"(greedy_generate's, as the reference's: ROADMAP C20) at "
            f"position 63: rel L2 {gap:.3e} from the prefill with frames")

    steps = stepwise(f"[mm] {arch}", cfg, params, p64, 32, SERVE_REL_L2,
                     cache_len=96, pre=pre64, on_last=zero_enc_out)
    counted(arch, cfg, params,
            {"prefill-448": ({"tokens": p448, "frames": f4}, logits)}, p64,
            32, steps, 2 * L, E + 2 * L, cache_len=96)
    del params, cache
    torch.cuda.empty_cache()

    # ---- internvl2-26b: 256 patch embeddings ahead of the tokens -----------
    arch = "internvl2-26b"
    cfg, params = model(arch, n_layers=INTERNVL2_LAYERS)
    L, V = cfg.n_layers, cfg.n_vis_tokens
    prefills = {"prefill-1024": {"tokens": tokens(cfg, 4, 768),
                                 "vis_embed": embeds(cfg, 4, V)},
                "prefill-4096": {"tokens": tokens(cfg, 1, 3840),
                                 "vis_embed": embeds(cfg, 1, V)}}
    logits = {name: prefill_vs_plain(
        arch, cfg, params, name, batch,
        {0: f"{arch} {name} layer 0", L - 1: f"{arch} {name} layer {L - 1}"},
        "vis_embed") for name, batch in prefills.items()}
    # (d) text-only decode (greedy_generate's fresh cache sees no image)
    # against a text-only prefill
    p512 = tokens(cfg, 4, 512)
    pre512 = make_prefill_step(cfg)(params, {
        "tokens": p512, "vis_embed": embeds(cfg, 4, 0)})
    steps = stepwise(f"[mm] {arch} (text only)", cfg, params, p512, 32,
                     SERVE_REL_L2, lambda t: {
                         0: f"{arch} decode q_offset={t} layer 0",
                         L - 1: f"{arch} decode q_offset={t} layer {L - 1}"}
                     if t == 511 else None, captured, pre=pre512)
    counted(arch, cfg, params, {k: (v, logits[k]) for k, v in
                                prefills.items()}, p512, 32, steps, L, L)
    del params
    torch.cuda.empty_cache()
    t_paths = time.time() - t_phase

    # ---- (a) the kernel against its plain version -------------------------
    def check(what, fn, ref, q, k, v, layout, **kw):
        before = dict(fa.route_launches)
        got, want = fn(q, k, v, **kw), ref(q, k, v, **kw)
        qh, kh = (q, k) if layout == "bhtd" else (q.transpose(1, 2),
                                                  k.transpose(1, 2))
        kind = fa._route(qh.shape[2], qh.shape[3], q.dtype, k.dtype,
                         qh.shape[1], kh.shape[1])
        assert fa.route_launches[kind] == before[kind] + 1, (what, kind)
        checked[kind] += 1
        tol = FA_TOL[str(q.dtype).split(".")[-1]]
        assert got.dtype == want.dtype == q.dtype and got.shape == want.shape
        d = (got.float() - want.float()).abs()
        assert not bool((d > tol + tol * want.float().abs()).any()), (
            what, float(d.max()))
        errs[what] = float(d.max())
        return kind

    for name in sorted(captured):
        (q, k, v), kw = captured[name]
        kind = check(name, kops.flash_attention, model_layout_ref, q, k, v,
                     "bthd", **kw)
        cross = "encoder" in name or "cross" in name
        assert kw["causal"] == (not cross), (name, kw)
        assert kind == ("decode" if "decode" in name else "tc"), (name, kind)
    g = torch.Generator(device=dev).manual_seed(5)
    for what, (B, H, K, Tq, Tk, hd) in (
            ("random tc non-causal Tq=Tk=1500 hd=64 G=1",
             (4, 12, 12, 1500, 1500, 64)),
            ("random tc non-causal Tq=448 Tk=1500", (4, 12, 12, 448, 1500, 64)),
            ("random decode non-causal G=1 Tq=1 Tk=1500",
             (4, 12, 12, 1, 1500, 64))):
        q = torch.randn((B, H, Tq, hd), generator=g, device=dev).to(bf16)
        k = torch.randn((B, K, Tk, hd), generator=g, device=dev).to(bf16)
        v = torch.randn((B, K, Tk, hd), generator=g, device=dev).to(bf16)
        check(what, fa.flash_attention, flash_attention_ref, q, k, v, "bhtd",
              causal=False)
    torch.cuda.synchronize()
    assert checked["tc"] and checked["decode"] and not checked["fma"], checked
    log("[mm] (a) flash_attention matches its plain version (max abs "
        "error): " + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; checks by route {checked}")

    # ---- (f) the f32 SMOKE configs against the JAX-made references --------
    f32 = torch.float32
    for arch, want_ref in MM_SERVE_REF.items():
        path = TESTDATA / f"{arch.split('-')[0]}_smoke_serve_ref.json"
        ref = json.loads(path.read_text())
        assert {k: ref[k] for k in want_ref} == want_ref
        scfg = dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32", attn_impl="pallas")
        sp = lm_params_from_jax(lm_weights(scfg, ref["seed"]), scfg)
        stoks = torch.tensor(ref["prompt"], dtype=torch.int32, device=dev)
        B, steps, new = ref["batch"], ref["steps"], ref["new"]
        make = frames if scfg.kind == "encdec" else vis_embed
        stub = {"frames" if scfg.kind == "encdec" else "vis_embed":
                torch.from_numpy(make(scfg, ref["seed"], B)).to(dev)}
        fa.reset_launches()
        smoke = {"prefill": (make_prefill_step(scfg)(
            sp, {"tokens": stoks, **stub}), "prefill_last_logits")}
        enc = {"": None}
        if scfg.kind == "encdec":
            enc["_enc_out"] = lm.encode(sp, stub["frames"], scfg)
        n_pre = dict(fa.route_launches)
        step, held = make_decode_step(scfg), {}
        for suffix, e in enc.items():
            cache = lm.init_cache(scfg, B, steps + new, dtype=f32)
            if e is not None:
                cache["enc_out"] = e
            out, tok, toks = [], stoks[:, :1], []
            for t in range(steps + new - 1):
                lg, cache = step(sp, cache, tok, t)
                if t < steps:
                    out.append(lg)
                if t + 1 < steps:
                    tok = stoks[:, t + 1:t + 2]
                else:
                    tok = lg.argmax(-1)[:, None].to(torch.int32)
                    toks.append(tok)
            smoke[f"decode{suffix}, f32 cache"] = (
                torch.stack(out), "decode_logits_f32_cache" + suffix)
            assert torch.cat(toks, 1).tolist() == \
                ref["greedy_tokens" + suffix], (arch, suffix)
        for what, (got, key) in smoke.items():
            want = torch.tensor(ref[key], device=dev).reshape(got.shape)
            d = (got - want).abs()
            assert not bool((d > SMOKE_TOL + SMOKE_TOL * want.abs()).any()), (
                arch, what, float(d.max()))
            held[what] = float(d.max())
        # the prefill's calls (the encoder's too) and encode's, all on fma
        per_step = scfg.n_layers * (2 if scfg.kind == "encdec" else 1)
        assert n_pre == {"tc": 0, "decode": 0, "fma": per_step
                         + 2 * scfg.n_enc_layers}, (arch, n_pre)
        assert fa.route_launches == dict(n_pre, decode=per_step * len(enc)
                                         * (steps + new - 1)), (
            arch, fa.route_launches)
        log(f"[mm] (f) {arch} SMOKE, f32, on the card vs the JAX reference "
            f"(max abs error, limit {SMOKE_TOL}): {held}; greedy tokens "
            f"equal; the prefill on fma, the decode on decode")

    # ---- times --------------------------------------------------------------
    def timing(name):
        (q, k, v), kw = captured[name]
        return flash_timing(q, k, v, kw)

    times = {
        "4tc-nc": timing("whisper-small encoder layer 0"),
        "4tc-x": timing("whisper-small prefill-448 cross layer 0"),
        "4dec-x": timing("whisper-small decode q_offset=63 cross layer 0"),
        "4tc-v": timing("internvl2-26b prefill-1024 layer 0")}
    assert [t["fa_route"] for t in times.values()] == ["tc", "tc", "decode",
                                                       "tc"], times
    # decode_step recomputes every layer's cross K/V from enc_out at every
    # step, as the reference does: one layer's two products, timed
    wcfg = get_config("whisper-small")
    wp = {"xattn": {w: torch.randn((wcfg.d_model, wcfg.d_model),
                                   generator=g, device=dev).to(bf16)
                    for w in ("wk", "wv")}}
    enc_out = embeds(wcfg, 4, wcfg.enc_seq)
    kv_ms = device_ms(lambda: lm._cross_kv(wp, enc_out, wcfg))[0]
    log(f"[mm] flash_attention at the new calls: {times}; cross K/V of one "
        f"decoder layer from 4 x 1500 frames, recomputed every decode step: "
        f"{kv_ms:.7f} ms (x {wcfg.n_layers} layers a step); phase 10 wall "
        f"{time.time() - t_phase:.1f}s (the serve paths {t_paths:.1f}s)")
    return {"routes": {
        "tc": {"whisper_encoder_1500_noncausal": dict(
                   times["4tc-nc"], launches=routes["whisper-small"]["tc"]),
               "whisper_cross_448x1500": times["4tc-x"],
               "internvl2_prefill_1024_hd128_g6": dict(
                   times["4tc-v"], launches=routes["internvl2-26b"]["tc"])},
        "decode": {"whisper_cross_decode_1x1500": dict(
            times["4dec-x"], launches=routes["whisper-small"]["decode"]),
            "internvl2_decode": {"launches": routes["internvl2-26b"][
                "decode"]}}},
        "launches_mm": launches, "routes_mm": routes,
        "cross_kv_layer_ms": kv_ms, "max_abs_err_mm": max(errs.values())}


#: Phase 11: mamba2-2.7b's depth (as phase 8, MAMBA2_LAYERS) and
#: llama3-8b's (2 of 32 layers) in the training steps at full width.
TRAIN_LLAMA3_LAYERS = 2
#: The f32 SMOKE training runs against their JAX-made files, relative to
#: the file's value (tests/test_torch_train.py holds the same on the CPU):
#: attention models 1e-5; Mamba2 models 2e-3 (their projections are bf16
#: in both packages); a run with int8 gradient compression 2e-3 (an int8
#: code whose gradient sits 1e-6 from a half step rounds the other way,
#: moving its dequantised gradient by a whole step, amax / 127).
TRAIN_TOL = {"attention": 1e-5, "mamba2": 2e-3, "grad_compress": 2e-3}
#: Steps 2-3 of mamba2's training through the SSD kernels against the same
#: steps through the plain scan (step 1's losses have equal bits).
TRAIN_TWIN_REL = 1e-3
#: Step 1's gradient through the SSD kernels against the plain scan's, leaf
#: by leaf (relative L2): at most this many times the control, the plain
#: scan at chunk 64 against chunk 128 (the same function summed in another
#: order; bf16 projections make it a few percent), taken as the larger of
#: the leaf's own and the leaves' median.  The kernels' gap is the
#: backward's summation order alone (the forward has the plain bits).
TRAIN_GRAD_CTL = 1.0


def ssd_bwd_timing(x, dt, A, B_, C_, dy, chunk, scratch) -> dict:
    """The SSD backward kernel and its plain twin (autograd through the
    plain scan, its forward included) on one call's inputs, with no final
    state's gradient: device and wall ms, and the bound.  Operations as
    the function needs them: per (b, h, chunk) the causal halves of dy .
    dtx and M^T dy (P each); W B and W^T C once per (b, chunk) after W is
    summed over the heads (B and C are shared across heads: tri
    additions a head), N each; B G_c and dtx G_c^T in every chunk but the
    last (G is 0 there without a final state's gradient), and Q_c and dy
    S_in^T in every chunk but the first (S_in is 0 there), L N P each;
    float32 at the CUDA cores' rate.  Bytes: x, dt, A, B, C and dy read,
    dx, ddt, dA, dB and dC written once.  Also the kernel's device ms by
    pass, and the MB of scratch it allocates beside the forward's, read
    on the card: the caching allocator's peak over one call, less what
    was allocated before it and the gradients' own bytes (logged beside
    the same counted from ``_bwd_plan``'s shapes)."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    L = min(chunk, T)
    nc = T // L
    tri = L * (L + 1) // 2
    fma = (Bb * H * nc * 2 * tri * P + Bb * nc * 2 * tri * N
           + Bb * H * (nc - 1) * 4 * L * N * P)
    flops = 2 * fma + Bb * H * nc * tri
    moved = 2 * sum(t.numel() * 4 for t in (x, dt, A, B_, C_)) + dy.numel() * 4
    bnd, by = bound_ms(moved, flops)
    run = lambda: ssd.ssd_scan_bwd(dy, x, dt, A, B_, C_, chunk,
                                   scratch=scratch)
    plain = lambda: ssd.ssd_scan_bwd_plain(dy, x, dt, A, B_, C_, chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    grads = run()
    torch.cuda.synchronize()
    scratch_mb = (torch.cuda.max_memory_allocated() - before
                  - sum(t.numel() * t.element_size() for t in grads)) / 1e6
    del grads
    plan_mb = sum(4 * math.prod(s) for s in
                  ssd._bwd_plan(Bb, T, H, P, N, L).values()) / 1e6
    log(f"[train] ssd_scan_bwd's scratch at x {tuple(x.shape)}, N {N}: "
        f"{scratch_mb:.6f} MB on the card (peak over one call less the "
        f"gradients); {plan_mb:.6f} MB counted from _bwd_plan's shapes")
    times = {}
    ms = own_device_ms("ssd_scan_bwd", run, times=times)
    by_pass = {own: sum(v for k, v in times.items() if own in k)
               for own in OWN_KERNELS["ssd_scan_bwd"]} if times else None
    return {"shape": f"x {tuple(x.shape)}, B/C {tuple(B_.shape)}, float32, "
                     f"chunk {L}",
            "ms": ms, "ms_by_pass": by_pass, "scratch_mb": scratch_mb,
            "plain_ms": device_ms(plain, reps=3)[0],
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "wall_ms": wall_ms(run, reps=10),
            "plain_wall_ms": wall_ms(plain, reps=3),
            "gflop": flops / 1e9, "mbytes": moved / 1e6}


def supervised(dev, ckpt_dir, fail_at, max_restarts=10, run=True,
               resume=False, seed=0):
    """Phase 11 (e): ``TrainSupervisor`` over mamba2 SMOKE in f32 on the
    card, 6 steps, a checkpoint every 2; params from ``seed``.  Returns
    (the supervisor, its final state, or None where ``run`` is False)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.runtime.data import DataConfig, SyntheticDataset
    from repro_torch.runtime.elastic import SupervisorConfig, TrainSupervisor
    from repro_torch.runtime.optimizer import OptConfig
    from repro_torch.runtime.train import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config("mamba2-2.7b", smoke=True),
                              dtype="float32")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    state = init_train_state(torch.Generator(device=dev).manual_seed(seed),
                             cfg, opt_cfg)
    data = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq=32,
                                       global_batch=4, seed=3), device=dev)
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=2,
                                           max_restarts=max_restarts),
                          state, data, make_train_step(cfg, opt_cfg,
                                                       device=dev))
    return sup, (sup.run(6, fail_at=fail_at, resume=resume) if run
                 else None)


def train_resume(ckpt_dir: str) -> int:
    """The restarted process of phase 11 (e), in PyTorch's deterministic
    mode: resumes the supervisor's run in ``ckpt_dir`` from its last
    checkpoint (the params it builds, from another seed, are only the
    template), then trains mixtral SMOKE as phase 11 (d) does and prints
    its metrics' bits on a line ``MIXTRAL [...]``."""
    import torch
    from torch_lm_weights import port_train_run
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda")
    supervised(dev, ckpt_dir, None, resume=True, seed=9)
    _, got, _ = port_train_run("mixtral-8x22b", "cuda")
    print("MIXTRAL " + json.dumps({k: [v.hex() for v in got[k]]
                                   for k in got}), flush=True)
    return 0


def step1_grads_vs_plain(cfg, params, batch) -> dict:
    """The gradient of ``lm_loss`` at ``params`` and ``batch`` through the
    SSD kernels against the plain scan's, each leaf within TRAIN_GRAD_CTL
    of the control (relative L2; the control is the plain scan at chunk
    64 against chunk 128).  Returns the worst ratio and the leaves'
    numbers."""
    import statistics
    import torch
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.models import ssm as S
    from repro_torch.runtime import train as T
    from repro_torch.runtime.tree import tree_paths

    def grads(c, plain):
        real = S.ssd_chunked
        if plain:
            S.ssd_chunked = lambda x, dt, A, B_, C_, chunk: ssd_chunked_ref(
                x.float(), dt.float(), A.float(), B_.float(), C_.float(),
                chunk)
        try:
            _, g = T._value_and_grad(c, params, batch)
        finally:
            S.ssd_chunked = real
        torch.cuda.synchronize()
        return [(".".join(map(str, k)), v) for k, v in tree_paths(g)]
    kern, plain = grads(cfg, False), grads(cfg, True)
    c64 = grads(dataclasses.replace(cfg, ssm_chunk=64), True)
    errs = {n: rel_l2(a, b) for (n, a), (_, b) in zip(kern, plain)}
    ctls = {n: rel_l2(a, b) for (n, a), (_, b) in zip(c64, plain)}
    del kern, plain, c64
    med = statistics.median(ctls.values())
    ratio = {n: errs[n] / max(ctls[n], med) for n in errs}
    worst = max(ratio, key=ratio.get)
    log(f"[train] mamba2 step 1's gradient, kernels vs plain scan, rel L2 "
        f"by leaf (control: chunk 64 vs 128; limit {TRAIN_GRAD_CTL}x the "
        f"larger of the leaf's control and the median {med:.3e}): worst "
        f"{worst} {errs[worst]:.3e} (control {ctls[worst]:.3e}, ratio "
        f"{ratio[worst]:.3f}); "
        + ", ".join(f"{n} {errs[n]:.2e}/{ctls[n]:.2e}" for n in errs
                    if n.startswith("layers.0.") or n == "embed"))
    assert ratio[worst] <= TRAIN_GRAD_CTL, (worst, errs[worst], ctls[worst])
    return {"worst_leaf": worst, "worst_ratio": ratio[worst],
            "max_rel_l2": max(errs.values()),
            "max_control": max(ctls.values()), "median_control": med}


def train_phase(dev) -> dict:
    """Phase 11: training through ``make_train_step`` on the card, the SSD
    scan's backward kernel against its plain twin.  Returns the kernel's
    entry of the ``kernels`` line."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.models import ssm as S
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.data import DataConfig, SyntheticDataset
    from repro_torch.runtime.optimizer import OptConfig
    from repro_torch.runtime.train import init_train_state, make_train_step
    from repro_torch.runtime.tree import tree_leaves
    from torch_lm_weights import TRAIN_REF, port_train_run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.time()
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = SSD_TOL["float32"]

    def bwd_check(what, x, dt, A, B_, C_, dy, chunk):
        """The backward kernel against its twin: each gradient within tol
        of the twin's largest magnitude; two calls equal bits."""
        x, dt, A, B_, C_, dy = (t.detach().float().contiguous()
                                for t in (x, dt, A, B_, C_, dy))
        _, _, scratch = ssd._forward(x, dt, A, B_, C_, chunk)
        got = ssd.ssd_scan_bwd(dy, x, dt, A, B_, C_, chunk, scratch=scratch)
        again = ssd.ssd_scan_bwd(dy, x, dt, A, B_, C_, chunk,
                                 scratch=scratch)
        want = ssd.ssd_scan_bwd_plain(dy, x, dt, A, B_, C_, chunk)
        err = 0.0
        for name, g, g2, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                  again, want):
            assert torch.isfinite(g).all(), (what, name)
            assert torch.equal(g.view(torch.int32), g2.view(torch.int32)), (
                what, name, "two calls differ")
            rel = float((g - w).abs().max() / w.abs().max())
            assert rel <= tol, (what, name, rel)
            err = max(err, float((g - w).abs().max()))
            log(f"[train] {what}: {name} max |d| / max |twin| {rel:.3e}")
        return err, scratch

    def random_inputs(N, Bb=4, T=1024, H=80, P=64):
        """Layer-like inputs: silu'd conv outputs for x, B and C, a
        softplus dt, A = -exp(log(linspace(1, 16, H)))."""
        r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        silu = lambda t: t * torch.sigmoid(t)
        x, B_, C_ = silu(r(Bb, T, H, P)), silu(r(Bb, T, N)), silu(r(Bb, T, N))
        dt = torch.nn.functional.softplus(r(Bb, T, H) - 1.0)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        return x, dt, A, B_, C_, r(Bb, T, H, P) * 1e-3

    # ---- (a) the backward kernel against its plain twin ----------------
    errs, timing = {}, {}
    for label, N in (("mamba2", 128), ("zamba2", 64)):
        ins = random_inputs(N)
        errs[label], scratch = bwd_check(f"{label} layer shape N {N}", *ins,
                                         128)
        timing[label] = ssd_bwd_timing(*ins, 128, scratch)
        log(f"[train] ssd_scan_bwd at {timing[label]['shape']}: "
            f"{ {k: v for k, v in timing[label].items() if k != 'shape'} }")
        del ins, scratch
    torch.cuda.empty_cache()

    # ---- (b) mamba2-2.7b at full width: the kernels vs the plain scan ---
    cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                              n_layers=MAMBA2_LAYERS)
    assert cfg.dtype == "bfloat16" and cfg.remat == "full"
    t0 = time.time()
    p0, o0 = init_train_state(torch.Generator(device=dev).manual_seed(0),
                              cfg, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(p0))
    log(f"[train] mamba2-2.7b ({cfg.n_layers} of 64 layers, d "
        f"{cfg.d_model}, {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, vocab {cfg.vocab}): {n_params / 1e9:.4f} B f32 "
        f"master params in {time.time() - t0:.1f}s")
    data = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq=1024,
                                       global_batch=4, seed=0), device=dev)
    batches = [data.batch_at(s) for s in range(3)]
    step = make_train_step(cfg, opt_cfg, device=dev)
    captured = {}
    real_bwd = ssd.ssd_scan_bwd

    def capture_bwd(dy, x, dt, A, B_, C_, chunk, **kw):
        captured.setdefault("layer", (x, dt, A, B_, C_, dy, chunk))
        return real_bwd(dy, x, dt, A, B_, C_, chunk, **kw)

    def run3(label):
        params, opt, losses, walls = p0, o0, [], []
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.time()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            walls.append(time.time() - t0)
            assert math.isfinite(losses[-1]), (label, losses)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[train] mamba2 {label}: losses {losses}, ms a step "
            f"{[round(w * 1e3, 1) for w in walls]}, peak {peak:.3f} GiB")
        return losses, walls, peak
    ssd.ssd_scan_bwd = capture_bwd
    ssd.reset_launches()
    fa.reset_launches()
    try:
        k_losses, k_walls, k_peak = run3("through the kernels")
    finally:
        ssd.ssd_scan_bwd = real_bwd
    launches = dict(ssd.launches)
    assert fa.launches["flash_attention"] == 0, fa.launches
    assert launches["ssd_scan_bwd"] == 3 * cfg.n_layers, launches
    assert launches["ssd_scan"] == 2 * 3 * cfg.n_layers, launches  # remat
    log(f"[train] mamba2 launches a run of 3 steps: {launches}")
    errs["mamba2 step 1"], _ = bwd_check(
        "mamba2 step 1, the first backward call's inputs (layer 15)",
        *captured.pop("layer"))
    real_chunked = S.ssd_chunked
    S.ssd_chunked = lambda x, dt, A, B_, C_, chunk: ssd_chunked_ref(
        x.float(), dt.float(), A.float(), B_.float(), C_.float(), chunk)
    try:
        ssd.reset_launches()
        p_losses, p_walls, p_peak = run3("through the plain scan")
        assert ssd.launches == {"ssd_scan": 0, "ssd_scan_bwd": 0}, \
            ssd.launches
    finally:
        S.ssd_chunked = real_chunked
    assert k_losses[0] == p_losses[0], (k_losses, p_losses)
    for a, b in zip(k_losses[1:], p_losses[1:]):
        assert abs(a - b) <= TRAIN_TWIN_REL * abs(b), (k_losses, p_losses)
    grad_ctl = step1_grads_vs_plain(cfg, p0, batches[0])
    tok_s = 4096 / k_walls[-1]
    mamba2 = {"tokens_per_s": tok_s, "ms_per_step": k_walls[-1] * 1e3,
              "ms_by_step": [w * 1e3 for w in k_walls],
              "peak_gib": k_peak, "losses": k_losses,
              "plain_losses": p_losses,
              "plain_ms_per_step": p_walls[-1] * 1e3,
              "params_b": n_params / 1e9, "step1_grads": grad_ctl}
    log(f"[train] mamba2-2.7b ({cfg.n_layers} layers) 4 x 1024 tokens a "
        f"step: {tok_s:.1f} tokens/s, {mamba2['ms_per_step']:.1f} ms at "
        f"step 3, peak {k_peak:.3f} GiB (plain scan: "
        f"{mamba2['plain_ms_per_step']:.1f} ms at step 3)")
    del p0, o0, step, batches, captured
    torch.cuda.empty_cache()

    # ---- (c) llama3-8b at full width, depth cut, chunked attention -----
    lcfg = dataclasses.replace(get_config("llama3-8b"),
                               n_layers=TRAIN_LLAMA3_LAYERS,
                               attn_impl="chunked", attn_chunk=512)
    t0 = time.time()
    lp, lo = init_train_state(torch.Generator(device=dev).manual_seed(0),
                              lcfg, opt_cfg)
    n_lparams = sum(t.numel() for t in tree_leaves(lp))
    log(f"[train] llama3-8b ({lcfg.n_layers} of 32 layers, d "
        f"{lcfg.d_model}, vocab {lcfg.vocab}): {n_lparams / 1e9:.4f} B f32 "
        f"master params in {time.time() - t0:.1f}s")
    ldata = SyntheticDataset(DataConfig(vocab=lcfg.vocab, seq=1024,
                                        global_batch=4, seed=0), device=dev)
    lstep = make_train_step(lcfg, opt_cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    l_losses, l_walls = [], []
    for s in range(3):
        b = ldata.batch_at(s)
        torch.cuda.synchronize()
        t0 = time.time()
        lp, lo, m = lstep(lp, lo, b)
        l_losses.append(float(m["loss"]))
        l_walls.append(time.time() - t0)
    assert fa.launches["flash_attention"] == 0, fa.launches
    lnv = math.log(lcfg.vocab)
    assert 0.1 * lnv < l_losses[0] < 3 * lnv, (l_losses, lnv)
    assert all(math.isfinite(v) for v in l_losses), l_losses
    l_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    l_tok = 4096 / l_walls[-1]
    llama3 = {"tokens_per_s": l_tok, "ms_per_step": l_walls[-1] * 1e3,
              "ms_by_step": [w * 1e3 for w in l_walls],
              "peak_gib": l_peak, "losses": l_losses,
              "params_b": n_lparams / 1e9}
    log(f"[train] llama3-8b ({lcfg.n_layers} layers, chunked attention) "
        f"4 x 1024 tokens a step: losses {l_losses} (ln V {lnv:.4f}), "
        f"{l_tok:.1f} tokens/s, ms a step {llama3['ms_by_step']}, peak "
        f"{l_peak:.3f} GiB")
    del lp, lo, lstep
    torch.cuda.empty_cache()

    # ---- (d) the f32 SMOKE configs against the JAX-made files ----------
    smoke, smoke_bits = {}, {}
    for arch, ref in TRAIN_REF.items():
        stem = arch.split("-")[0]
        want = json.loads((TESTDATA / f"{stem}_smoke_train_ref.json")
                          .read_text())
        ssd.reset_launches()
        toks, got, _ = port_train_run(arch, "cuda")
        assert toks.tolist() == want["tokens"], (arch, "tokens")
        kind = ("grad_compress" if ref["grad_compress"] else
                "mamba2" if arch.startswith("mamba2") else "attention")
        worst = 0.0
        for k in ("loss", "grad_norm", "lr"):
            for a, b in zip(got[k], want[k]):
                rel = abs(a - b) / abs(b)
                assert rel <= TRAIN_TOL[kind], (arch, k, got[k], want[k])
                worst = max(worst, rel)
        if arch.startswith("mamba2"):  # the SMOKE config's 2 layers a step
            assert ssd.launches["ssd_scan_bwd"] == ref["steps"] * 2, \
                ssd.launches
        smoke[arch] = worst
        smoke_bits[arch] = {k: [v.hex() for v in got[k]] for k in got}
        log(f"[train] {arch} SMOKE f32, {ref['steps']} steps "
            f"(micro_batches {ref['micro_batches']}, grad_compress "
            f"{ref['grad_compress']}): loss {got['loss']}, grad_norm "
            f"{got['grad_norm']}, lr {got['lr']}; worst rel {worst:.3e} "
            f"(tol {TRAIN_TOL[kind]})")

    # ---- (e) failure recovery on the card, bit for bit -----------------
    def same_bits(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    with tempfile.TemporaryDirectory() as tmp:
        _, ref = supervised(dev, os.path.join(tmp, "a"), None)
        sup, got = supervised(dev, os.path.join(tmp, "b"), {3})
        assert sup.restarts == 1, sup.restarts
        assert ckpt.latest_step(os.path.join(tmp, "b")) == 6
        assert same_bits(ref, got), "restart not bit-exact"
        log(f"[train] TrainSupervisor, mamba2 SMOKE f32 on the card, 6 "
            f"steps with a failure at step 3 (restored from step 2 in the "
            f"same process): params and optimizer state equal the "
            f"uninterrupted run's bit for bit ({len(tree_leaves(ref[0]))} "
            f"+ {len(tree_leaves(ref[1]))} leaves)")
        # The failure ends the process; a fresh one resumes (in PyTorch's
        # deterministic mode) and reruns mixtral SMOKE's compressed steps.
        d = os.path.join(tmp, "c")
        sup, _ = supervised(dev, d, {3}, max_restarts=0, run=False)
        try:
            sup.run(6, fail_at={3})
            raise AssertionError("the injected failure did not end the run")
        except RuntimeError as e:
            assert "injected" in str(e), e
        assert ckpt.latest_step(d) == 2
        t0 = time.time()
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--train-resume",
             d], capture_output=True, text=True, timeout=300,
            env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        assert child.returncode == 0, child.stderr[-3000:]
        assert ckpt.latest_step(d) == 6
        tree, _ = ckpt.restore(d, 6, {"params": ref[0], "opt": ref[1]},
                               device=dev)
        assert same_bits(ref, (tree["params"], tree["opt"])), \
            "a restart in a fresh process is not bit-exact"
        line = [ln for ln in child.stdout.splitlines()
                if ln.startswith("MIXTRAL ")]
        assert line and json.loads(line[0][8:]) == smoke_bits[
            "mixtral-8x22b"], (line, smoke_bits["mixtral-8x22b"])
        log(f"[train] a fresh process (deterministic mode) resumed mamba2 "
            f"SMOKE from step 2 to 6: params and optimizer state equal the "
            f"uninterrupted run's bit for bit; its mixtral SMOKE run "
            f"(grad_compress) gave (d)'s loss, grad_norm and lr bits "
            f"({time.time() - t0:.1f}s)")

    wall = time.time() - t_phase
    log(f"[train] phase 11: {wall:.1f}s")
    mam = timing["mamba2"]
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "none: XLA's gradient of src/repro/models/ssm.py:72 "
                        "ssd_chunked (the Pallas kernel has no backward)",
            "launches": launches["ssd_scan_bwd"],
            "max_abs_err": max(errs.values()),
            "ms": mam["ms"], "plain_ms": mam["plain_ms"],
            "bound_ms": mam["bound_ms"], "bound_by": mam["bound_by"],
            "library_ms": None,
            "wall_ms": mam["wall_ms"], "plain_wall_ms": mam["plain_wall_ms"],
            "ms_by_pass": mam["ms_by_pass"], "scratch_mb": mam["scratch_mb"],
            "shape": mam["shape"], "zamba2_n64": timing["zamba2"],
            "max_abs_err_by_case": errs,
            "train_mamba2": mamba2, "train_llama3": llama3,
            "smoke_worst_rel": smoke, "phase_s": wall}


def active_lanes(prog, st, t):
    """The active set's lanes at tick ``t`` of ``st``, as the tick builds
    them: the released flows not yet done."""
    mask = (prog.sendable_msg(st, t)[prog.dep.msg_of_flow.long()]
            & ~prog.proto.done(st.flows))
    return prog.lane_slate(mask)[0]


def check_active_tick(label, prog, st, t, lanes, same, seen, eff_nic=None,
                      paused_row=None, paused_nic=None):
    """Every kernel of a capped tick against its plain version on the card
    at tick ``t`` of ``st``, on the slate of ``lanes``: the active
    transition (on two clones of the flow record, which it updates in
    place), the lane-mapped serve/enqueue (on two clones of the ring), the
    ranker on its candidates and, under PFC, the PFC stage with the lanes'
    sources (``paused_nic`` replaces the state's NIC pause bits).  Returns
    ``(transition args, serve args, ring, PFC args)`` for timing."""
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.sim.fabric import _clone_tree
    name = ("flow_transition_roce_active" if prog.proto.name == "rocev2"
            else "flow_transition_active")
    targs = prog.transport_args(st, t, prog.sendable_msg(st, t), eff_nic,
                                lanes)
    out_k = fk.flow_transition_active(_clone_tree(targs[0]), *targs[1:])
    same(name, f"{label} {name} t={t}", out_k,
         fk.flow_transition_active_plain(_clone_tree(targs[0]), *targs[1:]))
    _, tx, ptx, pv, sel, can, done = out_k
    ok = lanes.idx < prog.N
    seen["lanes"] += int(ok.sum())
    seen["padded"] += int((~ok).sum())
    seen["last_flow"] += int((lanes.idx == prog.N - 1).any())
    seen["sel"] += int(sel.sum())
    seen["done"] += int(done.sum())
    if eff_nic is not None:
        paused = eff_nic[lanes.src.long()] & ok
        seen["withheld"] += int((can & paused & ~sel).sum())
        seen["blocked_probes"] += int((ptx.valid & paused).sum())
    sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, paused_row, None,
                                  lanes)
    rings = [_clone_tree(st.q) for _ in range(2)]
    res_k = fk.serve_enqueue(rings[0], *sargs[1:])
    same("serve_enqueue", f"{label} serve_enqueue t={t}", res_k,
         fk.serve_enqueue_plain(rings[1], *sargs[1:]))
    same("serve_enqueue", f"{label} ring t={t}",
         [f[:prog.Q] for f in rings[0]], [f[:prog.Q] for f in rings[1]])
    qid, accept = res_k[6], res_k[7]
    same("rank_in_queue", f"{label} rank_in_queue t={t}",
         fk.rank_in_queue(qid, accept, prog.Q),
         fk.rank_in_queue_plain(qid, accept, prog.Q))
    seen["injected"] += int(accept[2 * prog.TS:].sum())
    pargs = None
    if prog.pfc:
        pst = prog.pfc_state(st)
        if paused_nic is not None:
            pst = pst._replace(paused_nic=paused_nic)
        pargs = (pst, res_k[3], res_k[2], res_k[5], qid, res_k[9], accept,
                 rings[0], res_k[0], st.qsize, res_k[1], t, prog.pfc_flows,
                 prog.pfc_dims, lanes.idx)
        pfc_k = fk.pfc_account(*pargs)
        same("pfc_account", f"{label} pfc_account t={t}", pfc_k,
             fk.pfc_account_plain(*pargs))
        seen["nic_ingress"] += int((pfc_k.ing_host != 0).sum())
    return targs, sargs, _clone_tree(st.q), pargs


def active_walk(label, prog, ticks, same, capture_at=None, forced=False):
    """Dense ticks of the capped ``prog`` up to ``max(ticks)``, each kernel
    against its plain version at ``ticks`` (with ``forced``, once more with
    every other NIC paused, and every third switch row and the PFC state's
    NIC bits forced likewise).  Returns ``(seen, seen_forced, captured)``:
    the counts summed over those ticks, and at ``capture_at`` the state
    (cloned), its lanes and the kernels' arguments."""
    import torch
    from repro_torch.sim.fabric import _clone_tree
    keys = ("lanes", "padded", "last_flow", "sel", "done", "withheld",
            "blocked_probes", "injected", "nic_ingress")
    seen, seen_f = dict.fromkeys(keys, 0), dict.fromkeys(keys, 0)
    dev = prog.device
    nic_mask = torch.arange(prog.NH, device=dev) % 2 == 0
    row_mask = torch.arange(prog.Q, device=dev) % 3 == 0
    row_mask[2 * prog.TS:] = False
    st, captured = prog.init_state(), None
    for t in range(max(ticks) + 1):
        if t in ticks:
            eff_nic, prow = prog.eff_pause(st, t)
            lanes = active_lanes(prog, st, t)
            r = check_active_tick(label, prog, st, t, lanes, same, seen,
                                  eff_nic, prow)
            if forced:
                check_active_tick(f"{label} (NICs paused)", prog, st, t,
                                  lanes, same, seen_f, nic_mask,
                                  row_mask if prog.pfc else None,
                                  nic_mask if prog.pfc else None)
            if t == capture_at:
                # the transition's record is the live state's: time on a
                # clone
                stc = _clone_tree(st)
                captured = (stc, t, lanes, (prog.transport_args(
                    stc, t, prog.sendable_msg(stc, t), eff_nic, lanes),)
                    + r[1:])
        st, _, _ = prog.tick(st, t)
    torch.cuda.synchronize()
    return seen, seen_f, captured


def tick_launches(prog, st, t0: int, n: int) -> float:
    """Device launches (kernels and memsets, from ``torch.profiler``) per
    tick of ``n`` dense ticks of ``prog`` from a clone of ``st`` at tick
    ``t0``."""
    import torch
    from repro_torch.sim.fabric import _clone_tree
    from torch.profiler import ProfilerActivity, profile
    st = _clone_tree(st)
    st, _, _ = prog.tick(st, t0)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(t0 + 1, t0 + 1 + n):
            st, _, _ = prog.tick(st, t)
        torch.cuda.synchronize()
    count = sum(ev.count for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
    return count / n


def incast15_staggered():
    """The capped incast of tests/test_torch_active_pfc.py on the port: 15
    senders of 512 KiB into host 0 of ``full_bisection(4, 4)`` on a 2 us
    network, sender i arriving at tick 3 i, and a 4 KiB message 1 -> 2
    arriving at tick 1000 (N = 16).  Returns ``(scenario, cap)``: at most
    15 flows are live before tick 1000."""
    from repro_torch.core.params import NetworkSpec
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import Message, Scenario, incast_scenario
    net2 = NetworkSpec(link_gbps=400.0, base_rtt_us=2.0)
    inc = incast_scenario(full_bisection(4, 4), 15, 512 * 2 ** 10, net=net2)
    msgs = tuple(dataclasses.replace(m, arrival=3 * i)
                 for i, m in enumerate(inc.messages))
    msgs += (Message(mid=15, src=1, dst=2, size=4096.0, arrival=1000),)
    return Scenario(name="incast15_staggered", topo=inc.topo, net=net2,
                    messages=msgs), 15


def active_set(dev, prof_ms: dict) -> tuple:
    """Phase 6d: the active set (``active_cap``) on open-loop inference
    traffic: infer1024 (``repro_torch.profile.infer1024_scenario``: four
    open-loop inference tenants, 4096 flows on the perm1024 fabric) at
    ``active_cap=512``, with the active transitions and the lane-mapped
    serve/enqueue and PFC stage in CUDA.  Returns the ``kernels`` entries
    of ``flow_transition_active`` and ``flow_transition_roce_active``, and
    the ``active_*`` fields of the ``serve_enqueue``, ``rank_in_queue`` and
    ``pfc_account`` entries."""
    import torch
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.profile import INFER1024_CAP, infer1024_scenario
    from repro_torch.sim.fabric import _clone_tree
    from repro_torch.sim.workloads import RunConfig, run

    infer = infer1024_scenario()
    ref = json.loads((TESTDATA / "infer1024_strack_cap512_ref.json")
                     .read_text())
    cap = INFER1024_CAP
    max_err = dict.fromkeys(("flow_transition_active",
                             "flow_transition_roce_active", "serve_enqueue",
                             "rank_in_queue", "pfc_account"), 0.0)

    def same(key, what, a, b):
        max_err[key] = max(max_err[key], assert_same(what, a, b))

    # (a) the kernels against their plain versions.  infer1024 under
    # STrack at the cap: lanes at ticks across the run (live flows 280-328
    # of 512 lanes, then padding), at tick 1400 the slate holds flow N-1
    # (live over ticks 1364-1464) and padding; once more with every other
    # NIC paused (offers withheld)
    strack = fabric_program(infer, RunConfig(active_cap=cap), dev)
    n = strack.N
    seen, seen_f, cap_s = active_walk(
        "infer1024 strack", strack, {8, 64, 400, 1000, 1400}, same,
        capture_at=400, forced=True)
    assert seen["padded"] > 0 and seen["sel"] > 0 and seen["done"] > 0, seen
    assert seen["last_flow"] > 0 and seen_f["withheld"] > 0, (seen, seen_f)
    log(f"[active] infer1024 strack cap {cap}: the active transition, "
        f"serve_enqueue and rank_in_queue match their plain versions at "
        f"ticks 8, 64, 400, 1000, 1400: {seen}; NICs paused: {seen_f}")
    # the cap below the peak: at tick 400 (328 live flows) every one of
    # 320 lanes holds a flow, to the last
    small = fabric_program(infer, RunConfig(active_cap=ref["small_cap"]),
                           dev)
    seen, _, cap_f = active_walk("infer1024 strack cap 320", small, {400},
                                 same, capture_at=400)
    assert bool((cap_f[2].idx < n).all()), "the slate is not full"
    log(f"[active] the slate full to its last lane (cap "
        f"{ref['small_cap']}, tick 400): {seen}")
    # RoCEv2 + PFC at the cap, once more with NICs, rows and the PFC
    # state's NIC bits forced
    roce = fabric_program(infer, RunConfig(protocol="rocev2",
                                           active_cap=cap), dev)
    seen, seen_f, cap_r = active_walk(
        "infer1024 rocev2", roce, {8, 400, 1400}, same, capture_at=400,
        forced=True)
    assert seen_f["withheld"] > 0 and seen["nic_ingress"] > 0, (seen, seen_f)
    log(f"[active] infer1024 rocev2 cap {cap}: the active RoCEv2 "
        f"transition, serve_enqueue, rank_in_queue and pfc_account match "
        f"their plain versions: {seen}; NICs, rows and NIC bits forced: "
        f"{seen_f}")
    # the slate that holds flow N-1 with padding, at tick 1400 of both
    idx = cap_s[2].idx
    for prog, label in ((strack, "strack"), (roce, "rocev2")):
        st = _clone_tree(cap_s[0]) if prog is strack else _clone_tree(cap_r[0])
        slate = torch.full((cap,), n, dtype=torch.int32, device=dev)
        slate[:3] = torch.tensor([0, n // 2, n - 1], dtype=torch.int32)
        s_seen = dict.fromkeys(seen, 0)
        check_active_tick(f"infer1024 {label} slate [0, N/2, N-1, pad]",
                          prog, st, 400, prog.lanes(slate), same, s_seen,
                          *prog.eff_pause(st, 400))
        assert s_seen["lanes"] == 3 and s_seen["padded"] == cap - 3
        # a slate of padding only: no lane holds a flow (under PFC the PFC
        # stage adds no injection)
        s_seen = dict.fromkeys(seen, 0)
        check_active_tick(f"infer1024 {label} slate all padding", prog, st,
                          400, prog.lanes(torch.full_like(slate, n)), same,
                          s_seen, *prog.eff_pause(st, 400))
        assert s_seen["lanes"] == 0 and s_seen["padded"] == cap
    # one-bucket and wrap-around ticks on the lanes of tick 400 (under
    # RoCEv2 + PFC with the PFC stage)
    for label, (st_c, t_c, lanes_c, (_, sargs, ring, pargs)) in (
            ("strack", cap_s), ("rocev2", cap_r)):
        synthetic_ticks(
            f"infer1024 {label} A={cap} t={t_c}", sargs, ring, same,
            None if pargs is None else (pargs[0], pargs[12], pargs[13],
                                        pargs[11], lanes_c.idx),
            live=lanes_c.idx < n)
    # the 15-sender STrack + PFC incast (200 KB buffer, 2 us network) of
    # tests/test_torch_active_state.py, senders staggered by arrival, at
    # the cap: probes of paused NICs are withheld with their timer state
    inc, inc_cap = incast15_staggered()
    seen, _, _ = active_walk(
        "incast15 strack pfc capped", fabric_program(
            inc, RunConfig(pfc=True, switch_buffer_bytes=2e5,
                           active_cap=inc_cap), dev),
        {80, 88, 96, 144, 192}, same)
    assert seen["blocked_probes"] > 0 and seen["withheld"] > 0, seen
    log(f"[active] incast15 strack pfc cap {inc_cap}: probes of paused "
        f"NICs withheld, every kernel matches its plain version: {seen}")

    # (b) the full-width runs against the JAX-made references
    l_s, s_s, w_s = hold_against_reference(
        "infer1024_strack_cap512", infer, RunConfig(active_cap=cap),
        ("flow_transition_active", "serve_enqueue"))
    l_u, s_u, w_u = hold_against_reference(
        "infer1024_strack_uncapped", infer, RunConfig(), STRACK_KERNELS,
        ref=ref["uncapped"])
    l_r, s_r, w_r = hold_against_reference(
        "infer1024_rocev2_cap512", infer,
        RunConfig(protocol="rocev2", active_cap=cap),
        ("flow_transition_roce_active", "serve_enqueue", "pfc_account"))
    ref_r = json.loads((TESTDATA / "infer1024_rocev2_cap512_ref.json")
                       .read_text())

    # (c) the overflow: the run at the small cap raises with JAX's count
    try:
        run(infer, RunConfig(active_cap=ref["small_cap"]), device="cuda")
    except RuntimeError as e:
        if "exceeded on" not in str(e):
            raise
        ticks = int(str(e).split("exceeded on ")[1].split()[0])
        assert f"active_cap={ref['small_cap']}" in str(e), str(e)
        assert ticks == ref["small_cap_overflow_ticks"], (ticks, ref)
        log(f"[active] cap {ref['small_cap']} raises as JAX does: {e}")
    else:
        raise AssertionError("infer1024 at the small cap did not raise")

    # (d) wall time and launches per trip, capped and uncapped
    st400 = cap_s[0]
    dense = fabric_program(infer, RunConfig(), dev)
    lpt_cap = tick_launches(strack, st400, 400, 16)
    lpt_dense = tick_launches(dense, st400, 400, 16)
    trips_s, trips_r = ref["warp_trips"], ref_r["warp_trips"]
    log(f"[active] infer1024 wall: STrack cap {cap} {w_s:.3f}s "
        f"({trips_s} trips, {w_s * 1e3 / trips_s:.3f} ms a trip), "
        f"uncapped {w_u:.3f}s ({w_u * 1e3 / trips_s:.3f} ms a trip); "
        f"RoCEv2 + PFC cap {cap} {w_r:.3f}s ({trips_r} trips, "
        f"{w_r * 1e3 / trips_r:.3f} ms a trip); device launches a tick at "
        f"ticks 401-416: {lpt_cap:.1f} capped, {lpt_dense:.1f} uncapped")

    # kernel times and bounds at A = 512, tick 400 of each capped run
    # (the transition updates its flow record in place: the timed calls
    # step a clone of it again and again, the same work each time)
    entries, paths = [], {}
    csrc = "src/repro_torch/kernels/csrc"
    for name, src, (prog, (st, t, lanes, (targs, sargs, ring, pargs))) in (
            ("flow_transition_active", "transition.cu", (strack, cap_s)),
            ("flow_transition_roce_active", "transition_roce.cu",
             (roce, cap_r))):
        fl_k, fl_p = _clone_tree(targs[0]), _clone_tree(targs[0])
        kern = lambda: fk.flow_transition_active(fl_k, *targs[1:])
        plain = lambda: fk.flow_transition_active_plain(fl_p, *targs[1:])
        out = kern()
        ok = int((lanes.idx < prog.N).sum())
        row_b = nbytes(targs[0]) / prog.N
        due_b = nbytes(targs[1]) / prog.N
        # the live lanes' flow rows read and written, their due rows and
        # sources, the slate, the per-lane outputs
        t_bytes = (ok * (2 * row_b + due_b + 4) + 4 * cap
                   + index_bytes(targs[7]) + nbytes(out[1:]))
        per_lane = 2 * 512 + 64 if name == "flow_transition_active" else 40
        bnd, by = bound_ms(t_bytes, ok * per_lane)
        plain_ms, _ = device_ms(plain, reps=10)
        runs = l_s if name == "flow_transition_active" else l_r
        entries.append({
            "name": name, "route": "cuda",
            "source": f"{csrc}/{src}",
            "replaces": "src/repro/kernels/fabric_kernels.py:191",
            "launches": runs[name], "max_abs_err": max_err[name],
            "ms": prof_ms[name], "chain_ms": chain_ms(kern),
            "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": None, "wall_ms": wall_ms(kern),
            "plain_wall_ms": wall_ms(plain, reps=10),
            "shape": f"infer1024 {prog.proto.name} A={cap} t={t} "
                     f"({ok} live lanes)"})
    # serve/enqueue (STrack) and the PFC stage (RoCEv2) on the lanes
    _, t, lanes, (targs, sargs, ring, _) = cap_s
    ring_k, ring_p = _clone_tree(ring), _clone_tree(ring)
    res_k = fk.serve_enqueue(_clone_tree(ring), *sargs[1:])
    Q, M = strack.Q, res_k[6].numel()
    slot_bytes = sum(f.element_size() for f in ring)
    n_acc = int(res_k[7].sum())
    s_bytes = (2 * 4 * (Q + 1) + Q * slot_bytes + nbytes(sargs[3:17])
               + nbytes(sargs[24]) + nbytes(res_k) + n_acc * slot_bytes)
    kern = lambda: fk.serve_enqueue(ring_k, *sargs[1:])
    plain = lambda: fk.serve_enqueue_plain(ring_p, *sargs[1:])
    bnd, by = bound_ms(s_bytes, Q * 40 + M * 20)
    plain_ms, _ = device_ms(plain, reps=10)
    paths["serve_enqueue"] = {
        "active_ms": prof_ms["serve_enqueue active"],
        "active_wall_ms": wall_ms(kern), "active_chain_ms": chain_ms(kern),
        "active_plain_ms": plain_ms,
        "active_plain_wall_ms": wall_ms(plain, reps=10),
        "active_bound_ms": bnd, "active_bound_by": by,
        "active_launches": l_s["serve_enqueue"],
        "active_launches_rocev2": l_r["serve_enqueue"],
        "active_max_abs_err": max_err["serve_enqueue"],
        "active_shape": f"infer1024 strack A={cap} t={t} (M={M})"}
    pargs = cap_r[3][3]
    pfc_k = fk.pfc_account(*pargs)
    p_bytes = (nbytes(pargs[0]) + Q * 13 + pargs[4].numel() * 5
               + 3 * 4 * (Q + 1) + int(pargs[6].sum()) * 9
               + nbytes(pargs[12]) + 4 * cap + nbytes(pfc_k))
    kern = lambda: fk.pfc_account(*pargs)
    plain = lambda: fk.pfc_account_plain(*pargs)
    bnd, by = bound_ms(p_bytes, Q * 8 + pargs[4].numel() * 4)
    plain_ms, _ = device_ms(plain, reps=10)
    paths["pfc_account"] = {
        "active_ms": prof_ms["pfc_account active"],
        "active_wall_ms": wall_ms(kern), "active_chain_ms": chain_ms(kern),
        "active_plain_ms": plain_ms,
        "active_plain_wall_ms": wall_ms(plain, reps=10),
        "active_bound_ms": bnd, "active_bound_by": by,
        "active_launches": l_r["pfc_account"],
        "active_max_abs_err": max_err["pfc_account"],
        "active_shape": f"infer1024 rocev2 A={cap} t={cap_r[1]}"}
    paths["rank_in_queue"] = {
        "active_launches": l_s["rank_in_queue"],
        "active_max_abs_err": max_err["rank_in_queue"]}
    entries[0].update(infer_wall_s_capped=w_s, infer_wall_s_uncapped=w_u,
                      infer_wall_s_rocev2=w_r,
                      launches_per_tick_capped=lpt_cap,
                      launches_per_tick_uncapped=lpt_dense)
    return entries, paths


def collective_tick(label, prog, st, t, same, seen):
    """Every kernel of a dense tick of a collective against its plain
    version on the card, at tick ``t`` of ``st``: the transition (STrack,
    or RoCEv2 with the PFC NIC gate), serve/enqueue (on two clones of the
    ring) and, under PFC, the PFC stage (against its plain version on the
    CPU: striped messages have fractional tails, whose sums the plain
    version's atomics on the card would order freely).  Adds to ``seen``:
    the first offers of messages released by completions, the sources of
    more than ``BLOCK_FLOWS`` flows that hold both gated and offering
    flows, the largest source, paused NICs, stripes withheld behind them,
    winners, accepted packets and new pauses.  Returns the transition's,
    serve/enqueue's (beside a clone of the ring) and the PFC stage's
    arguments."""
    import torch
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.sim.fabric import _clone_tree
    name = ("flow_transition_roce" if prog.proto.name == "rocev2"
            else "flow_transition")
    eff_nic, prow = prog.eff_pause(st, t)
    sendable = prog.sendable_msg(st, t)
    targs = prog.transport_args(st, t, sendable, eff_nic)
    out_k = fk.flow_transition(*targs)
    same(name, f"{label} {name} t={t}", out_k,
         fk.flow_transition_plain(*targs))
    _, tx, ptx, pv, sel, can = out_k
    src, mof = prog.src.long(), prog.dep.msg_of_flow.long()
    child = (sendable & (st.msg_release_tick < 0)
             & (prog.dep.init_pending.to(sendable.device) > 0))
    seen["first_offers"] += int((child[mof] & can).sum())
    n_src = torch.bincount(src, minlength=prog.NH)
    per_src = lambda v: torch.zeros(prog.NH, dtype=torch.int32,
                                    device=src.device).index_add_(
        0, src, v.to(torch.int32))
    big = n_src > fk.BLOCK_FLOWS
    seen["big_mixed"] += int((big & (per_src(~targs[2]) > 0)
                              & (per_src(can) > 0)).sum())
    seen["max_src"] = max(seen["max_src"], int(n_src.max()))
    if eff_nic is not None:
        seen["nics_paused"] += int(eff_nic.sum())
        seen["withheld"] += int((can & eff_nic[src] & ~sel).sum())
    seen["sel"] += int(sel.sum())
    sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow)
    rings = [_clone_tree(st.q) for _ in range(2)]
    res_k = fk.serve_enqueue(rings[0], *sargs[1:])
    same("serve_enqueue", f"{label} serve_enqueue t={t}", res_k,
         fk.serve_enqueue_plain(rings[1], *sargs[1:]))
    same("serve_enqueue", f"{label} ring t={t}",
         [f[:prog.Q] for f in rings[0]], [f[:prog.Q] for f in rings[1]])
    seen["accepted"] += int(res_k[7].sum())
    pargs = None
    if prog.pfc:
        pargs = (prog.pfc_state(st), res_k[3], res_k[2], res_k[5], res_k[6],
                 res_k[9], res_k[7], rings[0], res_k[0], st.qsize, res_k[1],
                 t, prog.pfc_flows, prog.pfc_dims)
        pfc_k = fk.pfc_account(*pargs)
        same("pfc_account", f"{label} pfc_account t={t}", to_cpu(pfc_k),
             fk.pfc_account_plain(*to_cpu(pargs)))
        seen["new_pauses"] += int(pfc_k.pauses) - int(st.pauses)
    return targs, (sargs, _clone_tree(st.q)), pargs


def collective_walk(label, prog, ticks, same, capture_at=None):
    """Dense ticks of ``prog`` up to ``max(ticks)``, every kernel against
    its plain version at ``ticks`` (``collective_tick``).  Returns
    ``(seen, captured)``: the counts summed over those ticks (with
    ``releases``, the messages those ticks' completions released), and at
    ``capture_at`` a clone of the state and the kernels' arguments."""
    import torch
    from repro_torch.sim.fabric import _clone_tree
    seen = dict.fromkeys(("first_offers", "big_mixed", "max_src",
                          "nics_paused", "withheld", "sel", "accepted",
                          "new_pauses", "releases"), 0)
    st, captured = prog.init_state(), None
    for t in range(max(ticks) + 1):
        if t in ticks:
            stc = _clone_tree(st) if t == capture_at else None
            r = collective_tick(label, prog, st, t, same, seen)
            if stc is not None:
                captured = (stc, r)
        new, _, _ = prog.tick(st, t)
        if t in ticks:
            seen["releases"] += int(((new.pending <= 0)
                                     & (st.pending > 0)).sum())
        st = new
    torch.cuda.synchronize()
    log(f"[collective] {label}: the transition, serve_enqueue"
        + (" and pfc_account" if prog.pfc else "")
        + f" match their plain versions at ticks {sorted(ticks)}; summed "
        f"over those ticks {seen}")
    return seen, captured


def collectives(dev, prof_ms: dict) -> dict:
    """Phase 6e: dependency-scheduled collectives and sub-flow striping.
    Returns the ``collective_*`` fields of the ``flow_transition``,
    ``flow_transition_roce``, ``serve_enqueue`` and ``pfc_account``
    entries: their device ms at the collective ticks of phase 2b, wall and
    plain times, bounds, launches on the full-width runs."""
    import torch
    from repro_torch.core.params import NetworkSpec
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.profile import (ALLREDUCE8K_SPOT_CAP,
                                     allreduce8k_spot_scenario,
                                     collective1024_scenario)
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import (RunConfig, collective_scenario,
                                           run)
    max_err = dict.fromkeys(("flow_transition", "flow_transition_roce",
                             "serve_enqueue", "pfc_account",
                             "flow_transition_active", "rank_in_queue"),
                            0.0)

    def same(key, what, a, b):
        max_err[key] = max(max_err[key], assert_same(what, a, b))

    # (a) goldens ring8_strack, ring8_roce4, a2a_strack (tests/golden)
    net100 = NetworkSpec(link_gbps=100.0)
    t24 = full_bisection(2, 4)
    ring8 = collective_scenario(t24, "ring", 1, 8, 512 * 2 ** 10,
                                net=net100, seed=0, chunk=32 * 2 ** 10)
    a2a8 = collective_scenario(t24, "a2a", 2, 4, 256 * 2 ** 10, net=net100,
                               seed=0, chunk=128 * 2 ** 10, window=2)
    roce4 = RunConfig(protocol="rocev2", subflows=4)
    for name, sc, cfg in (("ring8_strack", ring8, RunConfig()),
                          ("ring8_roce4", ring8, roce4),
                          ("a2a_strack", a2a8, RunConfig())):
        want = json.loads((ROOT / "tests" / "golden" / f"{name}.json")
                          .read_text())
        t0 = time.time()
        got = run(sc, cfg, device="cuda")
        for k, v in want.items():
            if isinstance(v, float):
                assert math.isclose(got[k], v, rel_tol=1e-6), (name, k,
                                                               got[k], v)
            else:
                assert got[k] == v, (name, k, got[k], v)
        log(f"[golden] {name}: {want} matched in {time.time() - t0:.2f}s "
            f"({got['warp_trips']} warp trips)")

    # (b) the kernels against their plain versions at collective ticks:
    # hd1024's first completions (tick 64) release children, which offer
    # at 65 (and again at 116-117); a2a1024's sources of 31 flows hold 8
    # offering and 23 gated flows, children of tick 53's completions offer
    # at 54; hd1024 under RoCEv2 + PFC at four sub-flows has sources of 56
    # stripes; the small-buffer a2a of 16 ranks at four sub-flows pauses
    # every NIC from tick 22, stripes of one message behind it
    hd = collective1024_scenario("hd1024")
    a2a = collective1024_scenario("a2a1024")
    progs = {"hd": fabric_program(hd, RunConfig(), dev)}
    seen, cap_hd = collective_walk("hd1024 strack", progs["hd"],
                                   {8, 64, 65, 116, 117}, same,
                                   capture_at=65)
    assert seen["releases"] > 0 and seen["first_offers"] > 0, seen
    seen, cap_a = collective_walk("a2a1024 strack",
                                  fabric_program(a2a, RunConfig(), dev),
                                  {8, 53, 54, 59, 64}, same, capture_at=54)
    assert seen["max_src"] == 31 and seen["big_mixed"] > 0, seen
    assert seen["releases"] > 0 and seen["first_offers"] > 0, seen
    progs["r4"] = fabric_program(hd, roce4, dev)
    seen, cap_r = collective_walk("hd1024 rocev2 x4", progs["r4"],
                                  {8, 64, 65, 117}, same, capture_at=65)
    assert seen["max_src"] == 56 and seen["big_mixed"] > 0, seen
    assert seen["first_offers"] > 0, seen
    small = collective_scenario(full_bisection(4, 4), "a2a", 1, 16,
                                512 * 2 ** 10,
                                net=NetworkSpec(link_gbps=400.0), seed=0,
                                window=4)
    seen, _ = collective_walk(
        "a2a16 rocev2 x4 pfc 200KB",
        fabric_program(small, RunConfig(protocol="rocev2", subflows=4,
                                        switch_buffer_bytes=2e5), dev),
        {22, 30, 60, 120}, same)
    assert seen["new_pauses"] > 0 and seen["nics_paused"] > 0, seen
    assert seen["withheld"] > 0 and seen["big_mixed"] > 0, seen
    # allreduce8k's spot cell at its cap: the active kernels on slates
    # that children join (first releases at 28 and 42)
    spot = allreduce8k_spot_scenario()
    spot_cfg = RunConfig(active_cap=ALLREDUCE8K_SPOT_CAP)
    seen, _, _ = active_walk("allreduce8k spot cap 48",
                             fabric_program(spot, spot_cfg, dev),
                             {27, 28, 42, 43}, same)
    assert seen["padded"] > 0 and seen["sel"] > 0, seen
    log(f"[collective] allreduce8k spot cap {ALLREDUCE8K_SPOT_CAP}: the "
        f"active transition, serve_enqueue and rank_in_queue match their "
        f"plain versions at ticks 27, 28, 42, 43: {seen}")

    # (c) the full-width runs against their JAX-made files, each launching
    # exactly its path's kernels; hd1024 at active_cap=1024 (at most 1024
    # messages live) against the uncapped file
    ref_hd = json.loads((TESTDATA / "hd1024_strack_ref.json").read_text())
    l_hd, s_hd, w_hd = hold_against_reference("hd1024_strack", hd,
                                              RunConfig(), STRACK_KERNELS)
    l_cap, _, w_cap = hold_against_reference(
        "hd1024_strack_cap1024", hd, RunConfig(active_cap=1024),
        ("flow_transition_active", "serve_enqueue"), ref=ref_hd)
    l_r4, s_r4, w_r4 = hold_against_reference(
        "hd1024_roce4", hd, roce4, ROCE_KERNELS + ("pfc_account",))
    l_a, s_a, w_a = hold_against_reference("a2a1024_strack", a2a,
                                           RunConfig(), STRACK_KERNELS)
    hold_against_reference("allreduce8k_spot_cap48", spot, spot_cfg,
                           ("flow_transition_active", "serve_enqueue"))

    # (d) STrack against the 4-QP RoCEv2 on hd1024
    trips = ref_hd["warp_trips"]
    trips_r4 = json.loads((TESTDATA / "hd1024_roce4_ref.json").read_text()
                          )["warp_trips"]
    lpt_s = tick_launches(progs["hd"], cap_hd[0], 65, 16)
    lpt_r = tick_launches(progs["r4"], cap_r[0], 65, 16)
    log(f"[collective] hd1024: STrack wall {w_hd:.3f}s, {trips} warp trips "
        f"({w_hd * 1e3 / trips:.3f} ms a trip), "
        f"{sum(l_hd.values()) / trips:.3f} kernel launches a trip, "
        f"{lpt_s:.1f} device launches a tick (66-81), max_collective_time "
        f"{s_hd['max_collective_time']:.5f} us; at active_cap=1024 wall "
        f"{w_cap:.3f}s ({w_cap * 1e3 / trips:.3f} ms a trip); RoCEv2 + PFC "
        f"x4 wall {w_r4:.3f}s, {trips_r4} warp trips "
        f"({w_r4 * 1e3 / trips_r4:.3f} ms a trip), "
        f"{sum(l_r4.values()) / trips_r4:.3f} kernel launches a trip, "
        f"{lpt_r:.1f} device launches a tick, max_collective_time "
        f"{s_r4['max_collective_time']:.5f} us; STrack / RoCEv2 x4 "
        f"{s_hd['max_collective_time'] / s_r4['max_collective_time']:.4f}; "
        f"a2a1024 STrack wall {w_a:.3f}s, max_collective_time "
        f"{s_a['max_collective_time']:.5f} us")

    # (e) the kernels' times at the collective ticks of phase 2b
    # (a2a1024 tick 54, hd1024 x4 tick 65), beside their bounds
    (targs_a, (sargs_a, ring_a), _), (targs_r, (sargs_r, ring_r), pargs_r) \
        = cap_a[1], cap_r[1]
    paths = {}

    def timed(key, prof_key, kern, plain, n_bytes, n_ops, launches, shape):
        bnd, by = bound_ms(n_bytes, n_ops)
        plain_ms, _ = device_ms(plain, reps=10)
        return {f"{key}_ms": prof_ms[prof_key],
                f"{key}_wall_ms": wall_ms(kern),
                f"{key}_chain_ms": chain_ms(kern),
                f"{key}_plain_ms": plain_ms,
                f"{key}_plain_wall_ms": wall_ms(plain, reps=10),
                f"{key}_bound_ms": bnd, f"{key}_bound_by": by,
                f"{key}_launches": launches, f"{key}_shape": shape}

    for name, targs, ops, launches, shape in (
            ("flow_transition", targs_a, 2 * 512 + 64,
             l_a["flow_transition"] + l_hd["flow_transition"],
             "a2a1024 strack t=54 (31 flows a source)"),
            ("flow_transition_roce", targs_r, 40,
             l_r4["flow_transition_roce"],
             "hd1024 rocev2 x4 t=65 (56 stripes a source)")):
        out = fk.flow_transition(*targs)
        paths[name] = timed(
            "collective", f"{name} collective",
            lambda a=targs: fk.flow_transition(*a),
            lambda a=targs: fk.flow_transition_plain(*a),
            nbytes(targs[:4]) + (nbytes(targs[6]) if targs[6] is not None
                                 else 0)
            + index_bytes(targs[7]) + nbytes(out), targs[2].numel() * ops,
            launches, shape)
        paths[name]["collective_max_abs_err"] = max_err[name]
    paths["serve_enqueue"] = {"collective_max_abs_err":
                              max_err["serve_enqueue"]}
    for key, sargs, ring, launches, shape in (
            ("collective", sargs_a, ring_a,
             l_a["serve_enqueue"] + l_hd["serve_enqueue"],
             "a2a1024 strack t=54"),
            ("collective_pfc", sargs_r, ring_r, l_r4["serve_enqueue"],
             "hd1024 rocev2 x4 t=65")):
        res_k = fk.serve_enqueue(type(ring)(*[f.clone() for f in ring]),
                                 *sargs[1:])
        ring_k = type(ring)(*[f.clone() for f in ring])
        ring_p = type(ring)(*[f.clone() for f in ring])
        Q, M = ring.flow.shape[0] - 1, res_k[6].numel()
        slot_bytes = sum(f.element_size() for f in ring)
        n_acc = int(res_k[7].sum())
        s_bytes = (2 * 4 * (Q + 1) + Q * slot_bytes + nbytes(sargs[3:17])
                   + nbytes(res_k) + n_acc * slot_bytes)
        paths["serve_enqueue"].update(timed(
            key, "serve_enqueue " + key.replace("_", " "),
            lambda r=ring_k, a=sargs: fk.serve_enqueue(r, *a[1:]),
            lambda r=ring_p, a=sargs: fk.serve_enqueue_plain(r, *a[1:]),
            s_bytes, Q * 40 + M * 20, launches, shape))
    pfc_k = fk.pfc_account(*pargs_r)
    Q, M = pargs_r[1].numel(), pargs_r[4].numel()
    p_bytes = (nbytes(pargs_r[0]) + Q * 13 + M * 5 + 3 * 4 * (Q + 1)
               + int(pargs_r[6].sum()) * 9 + nbytes(pargs_r[12])
               + nbytes(pfc_k))
    paths["pfc_account"] = timed(
        "collective", "pfc_account collective",
        lambda: fk.pfc_account(*pargs_r),
        lambda: fk.pfc_account_plain(*pargs_r), p_bytes, Q * 8 + M * 4,
        l_r4["pfc_account"], "hd1024 rocev2 x4 t=65")
    paths["pfc_account"]["collective_max_abs_err"] = max_err["pfc_account"]
    for name in ("flow_transition_active", "rank_in_queue"):  # spot cell
        paths[name] = {"collective_max_abs_err": max_err[name]}
    return paths


#: The batched kernels of the sweep phase and the unbatched ones they stand
#: in for.
BATCH_OF = {"flow_transition_batch": "flow_transition",
            "flow_transition_roce_batch": "flow_transition_roce",
            "serve_enqueue_batch": "serve_enqueue",
            "pfc_account_batch": "pfc_account"}
#: A trace's cwnd_mean row (a mean of N float32 windows) against the
#: JAX-made file: XLA's summation order on one side and PyTorch's on the
#: card on the other move the mean by a few ulps (rounding only; a wrong
#: window moves it by a whole packet over N).
TRACE_CWND_RTOL = 1e-5


def row_digest(rows) -> dict:
    """A trace key's rows as their count and the sha256 of their int32 (or
    float32) bytes, as the trace reference file keeps them."""
    import hashlib
    import numpy as np
    a = np.ascontiguousarray(np.asarray(rows))
    a = a.astype(np.float32 if a.dtype.kind == "f" else np.int32)
    return {"rows": int(a.shape[0]),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def entry_of(tree, i: int):
    """Entry ``i`` of a batch's tree (every tensor's leading axis)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple):
        items = [entry_of(x, i) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def real_rows(st, q_rows: int):
    """A fabric state with its ring trimmed to the real rows (the trash
    row's contents are never read)."""
    return st._replace(q=type(st.q)(*[f[..., :q_rows, :] for f in st.q]))


def batch_walk(label, prog, ticks, same, capture_at=None) -> tuple:
    """Dense ticks of the ``BatchProgram`` ``prog`` up to ``max(ticks)``;
    at each of ``ticks`` every batched kernel against its plain version
    (the PFC stage against its plain version on the CPU), once with every
    entry stepping and once with the odd entries frozen, which must come
    out as they went in.  Returns ``(seen, captured)``: counts summed over
    the checked ticks, and at ``capture_at`` the batched calls' arguments
    with every entry stepping."""
    import torch
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.sim.fabric import _clone_tree
    B, Q = prog.B, prog.Q
    odd = torch.arange(B, device=prog.device) % 2 == 0
    tname = ("flow_transition_roce_batch" if prog.proto.name == "rocev2"
             else "flow_transition_batch")
    seen = dict.fromkeys(("sel", "accepted", "frozen_rows", "new_pauses",
                          "paused_rows"), 0)
    st, captured = prog.init_state(), None
    for t in range(max(ticks) + 1):
        if t in ticks:
            eff_nic, prow = prog.eff_pause(st, t)
            fm = prog.fault_masks(t)
            sm = (st.pending <= 0) & (prog.arrival <= t)
            for live in (None, odd):
                what = f"{label} t={t}" + ("" if live is None
                                           else " odd entries frozen")
                targs = prog.transport_args(st, t, sm, eff_nic, live)
                out_k = fk.flow_transition_batch(*targs)
                same(tname, f"{what} {tname}", out_k,
                     fk.flow_transition_batch_plain(*targs))
                _, tx, ptx, pv, sel, _ = out_k
                sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, prow,
                                              fm, live)
                rings = [_clone_tree(st.q) for _ in range(2)]
                res_k = fk.serve_enqueue_batch(rings[0], *sargs[1:])
                same("serve_enqueue_batch", f"{what} serve_enqueue_batch",
                     res_k, fk.serve_enqueue_batch_plain(rings[1],
                                                         *sargs[1:]))
                same("serve_enqueue_batch", f"{what} ring",
                     [f[:, :Q] for f in rings[0]],
                     [f[:, :Q] for f in rings[1]])
                pargs = None
                if prog.pfc:
                    pargs = (prog.pfc_state(st), res_k[3], res_k[2],
                             res_k[5], res_k[6], res_k[9], res_k[7],
                             rings[0], res_k[0], st.qsize, res_k[1], t,
                             prog.pfc_flows, prog.pfc_dims, live)
                    pfc_k = fk.pfc_account_batch(*pargs)
                    # the plain version reads no ring: none goes to the CPU
                    same("pfc_account_batch", f"{what} pfc_account_batch",
                         to_cpu(pfc_k), fk.pfc_account_batch_plain(
                             *to_cpu(pargs[:7]), None, *to_cpu(pargs[8:])))
                    seen["new_pauses"] += int((pfc_k.pauses
                                               - st.pauses).sum())
                    seen["paused_rows"] += int(prow.sum())
                if live is not None:   # the frozen entries are untouched
                    for b in range(1, B, 2):
                        assert_same(f"{what} frozen entry {b}",
                                    entry_of(targs[0], b),
                                    entry_of(out_k[0], b))
                        assert not bool(res_k[3][b].any()), (what, b)
                        assert torch.equal(res_k[0][b], st.qhead[b]), b
                        assert torch.equal(res_k[1][b], st.qsize[b]), b
                        if pargs is not None:
                            assert_same(f"{what} frozen PFC {b}",
                                        entry_of(pargs[0], b),
                                        entry_of(pfc_k, b))
                        seen["frozen_rows"] += prog.N
                else:
                    seen["sel"] += int(sel.sum())
                    seen["accepted"] += int(res_k[7].sum())
                    if t == capture_at:
                        captured = (targs, sargs, _clone_tree(st.q), pargs)
        st, _, _ = prog.tick(st, t)
    torch.cuda.synchronize()
    log(f"[sweep] {label}: {tname}, serve_enqueue_batch"
        + (" and pfc_account_batch" if prog.pfc else "")
        + f" match their plain versions at B = {B}, ticks {sorted(ticks)}, "
        f"every entry stepping and the odd ones frozen; {seen}")
    return seen, captured


def batch_args_at(prog, t: int) -> tuple:
    """Dense ticks of the ``BatchProgram`` ``prog`` up to tick ``t`` and
    the batched calls' arguments there, every entry stepping: ``(targs,
    sargs, ring, pargs)`` as ``batch_walk`` captures them."""
    from repro_torch.kernels import fabric_kernels as fk
    st = prog.init_state()
    for t_ in range(t):
        st, _, _ = prog.tick(st, t_)
    eff_nic, prow = prog.eff_pause(st, t)
    targs = prog.transport_args(st, t, (st.pending <= 0)
                                & (prog.arrival <= t), eff_nic)
    out = fk.flow_transition_batch(*targs)
    sargs, _, _ = prog.serve_args(st, t, out[1], out[2], out[4], out[3],
                                  prow, None)
    ring, pargs = _clone(st.q), None
    if prog.pfc:
        ring_k = _clone(ring)
        res = fk.serve_enqueue_batch(ring_k, *sargs[1:])
        pargs = (prog.pfc_state(st), res[3], res[2], res[5], res[6], res[9],
                 res[7], ring_k, res[0], st.qsize, res[1], t, prog.pfc_flows,
                 prog.pfc_dims, None)
    return targs, sargs, ring, pargs


def batch_one_launch(dev) -> dict:
    """Phase 2b for the batched calls (early in the process, while the
    profiler keeps its records): each is one device operation a call at B
    = 8, tick 16 of perm1024 seeds 0-7 under STrack and of perm1024 under
    RoCEv2 + PFC at entropy seeds 0-7.  Returns their device ms a call
    (phase 6f's kernels entries)."""
    from repro_torch.core.params import NetworkSpec
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.sim import fabric as F
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import (RunConfig, _fabric_cfg,
                                           _scenario_ticks,
                                           permutation_scenario)
    t32 = full_bisection(32, 32)
    scs = [permutation_scenario(t32, 64 * 2 ** 10,
                                net=NetworkSpec(link_gbps=400.0), seed=s)
           for s in range(8)]
    n_ticks = _scenario_ticks(scs[0], RunConfig())
    s8 = batch_args_at(F.batch_program(
        t32, [sc.messages for sc in scs], n_ticks,
        _fabric_cfg(scs[0], RunConfig()), device=dev), 16)
    r8 = batch_args_at(F.batch_program(
        t32, [scs[0].messages] * 8, n_ticks,
        _fabric_cfg(scs[0], RunConfig(protocol="rocev2")),
        entropy_seeds=list(range(8)), device=dev), 16)
    ring = _clone(s8[2])
    calls = [("flow_transition_batch",
              lambda: fk.flow_transition_batch(*s8[0]), "B=8 strack t=16"),
             ("flow_transition_roce_batch",
              lambda: fk.flow_transition_batch(*r8[0]), "B=8 rocev2 t=16"),
             ("serve_enqueue_batch",
              lambda: fk.serve_enqueue_batch(ring, *s8[1][1:]),
              "B=8 strack t=16"),
             ("pfc_account_batch", lambda: fk.pfc_account_batch(*r8[3]),
              "B=8 rocev2 t=16")]
    return dict(zip(BATCH_OF, one_launch(calls)))


def batch_of_one(label, prog, captured, same) -> None:
    """Entry 0 of a captured batched tick (``batch_walk``'s) as a batch of
    one against the unbatched wrappers on the same inputs: the bits of
    the unbatched calls."""
    import torch
    from repro_torch.kernels import fabric_kernels as fk
    targs, sargs, ring, pargs = captured
    one = lambda tree: entry_of(tree, 0)
    first = lambda tree: tree_map(lambda x: x[:1].clone(), tree)
    src = targs[3][:1]
    index1 = fk.src_index_batch(src, prog.NH)
    t, d = targs[4], targs[5]
    out_b = fk.flow_transition_batch(first(targs[0]), first(targs[1]),
                                     targs[2][:1], src, t, d,
                                     first(targs[6]), index1, None)
    out_s = fk.flow_transition(one(targs[0]), one(targs[1]), targs[2][0],
                               targs[3][0], t, d, one(targs[6]),
                               fk.src_index(targs[3][0], prog.NH))
    name = ("flow_transition_roce" if prog.proto.name == "rocev2"
            else "flow_transition")
    same(name + "_batch", f"{label} B=1 vs unbatched {name}",
         one(out_b), out_s)
    rings = [first(ring), one(_clone(ring))]
    res_b = fk.serve_enqueue_batch(rings[0], *first(tuple(sargs[1:17])),
                                   *sargs[17:19], first(sargs[19]),
                                   *sargs[20:24], None)
    res_s = fk.serve_enqueue(rings[1], *one(tuple(sargs[1:17])),
                             *sargs[17:19], one(sargs[19]), *sargs[20:24])
    same("serve_enqueue_batch", f"{label} B=1 vs unbatched serve_enqueue",
         one(res_b[:11]), res_s[:11])
    same("serve_enqueue_batch", f"{label} B=1 vs unbatched ring",
         one(rings[0]), rings[1])
    if pargs is not None:
        fl = pargs[12]
        fl1 = fk.pfc_flows_batch(*[x[:1] for x in fl[:5]], index1)
        pfc_b = fk.pfc_account_batch(first(pargs[0]), *first(pargs[1:11]),
                                     t, fl1, pargs[13], None)
        pfc_s = fk.pfc_account(one(pargs[0]), *one(pargs[1:11]), t,
                               fk.pfc_flows(*[x[0] for x in fl[:5]],
                                            fk.src_index(fl.src[0],
                                                         prog.NH)),
                               pargs[13])
        same("pfc_account_batch", f"{label} B=1 vs unbatched pfc_account",
             one(pfc_b), pfc_s)
    torch.cuda.synchronize()
    log(f"[sweep] {label}: the batched calls at B = 1 give the unbatched "
        f"calls' bits")


def tree_map(fn, tree):
    from repro_torch.kernels.fabric_kernels import tree_map as tm
    return tm(fn, tree)


def run_launches(prog) -> tuple:
    """Device operations (kernels, memsets, copies: ``torch.profiler``
    tracing the card alone) of one full run of the ``BatchProgram``
    ``prog``, and its loop's trips."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prog.run()
        torch.cuda.synchronize()
    return (sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA),
            prog.trips)


def sweeps(dev, ms: dict) -> list:
    """Phase 6f: the batched sweep and the per-tick trace.  ``ms`` holds
    the batched calls' device ms a call (``batch_one_launch``).  Returns
    the ``kernels`` entries of the four batched calls."""
    import torch
    from repro_torch.core.params import NetworkSpec
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.sim import fabric as F
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import (RunConfig, _fabric_cfg,
                                           _fabric_summary, _queue_settle_us,
                                           _scenario_ticks, incast_scenario,
                                           permutation_scenario, sweep)
    net400 = NetworkSpec(link_gbps=400.0)
    t32 = full_bisection(32, 32)
    scs = [permutation_scenario(t32, 64 * 2 ** 10, net=net400, seed=s)
           for s in range(8)]
    max_err = dict.fromkeys(BATCH_OF, 0.0)

    def same(key, what, a, b):
        max_err[key] = max(max_err[key], assert_same(what, a, b))

    def held(name, got, want, keys):
        for k in keys:
            if isinstance(want[k], float):
                assert math.isclose(got[k], want[k], rel_tol=1e-6), (
                    name, k, got[k], want[k])
            else:
                assert got[k] == want[k], (name, k, got[k], want[k])

    def main_path(name, fn, kernels):
        """``fn()`` with the launch counts reset before and read after;
        fails unless exactly ``kernels`` launched."""
        torch.cuda.synchronize()
        fk.reset_launches()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(fk.launches)
        for k, c in launches.items():
            assert (c > 0) == (k in kernels), \
                f"{name}: the {k} kernel launched {c} times"
        return out, wall, launches

    def against_solo(name, cfgs, fcfgs, seeds, want, kernels):
        """``sweep()`` of ``scs`` under ``cfgs`` (the phase's main path),
        each entry's solo run, and the batched program's final state: each
        entry equals its solo run (every state leaf bit for bit, the
        summary, warp trips) and the JAX-made file's entry."""
        n_ticks = _scenario_ticks(scs_of[name][0], cfgs[0])
        assert n_ticks == want["n_ticks"], (name, n_ticks)
        res, w_sweep, launches = main_path(
            f"{name} sweep", lambda: sweep(scs_of[name], cfgs,
                                           device="cuda"), kernels)
        solo, t0 = [], time.time()
        for sc, fc in zip(scs_of[name], fcfgs):
            solo.append(F.run_fabric_trace(sc.topo, sc.messages, n_ticks,
                                           fc, device="cuda"))
        torch.cuda.synchronize()
        w_solo = time.time() - t0
        prog = F.batch_program(t32, [sc.messages for sc in scs_of[name]],
                               n_ticks, fcfgs[0], entropy_seeds=seeds,
                               device="cuda")
        final, mb = prog.run()
        final = prog.stacked(final)
        keys = [k for k in want["entries"][0]
                if k not in ("warp_trips", "end_tick", "done_tick")]
        for i, (sc, rc) in enumerate(zip(scs_of[name], cfgs)):
            f_solo, m_solo = solo[i]
            assert_same(f"{name} entry {i} final state (batch vs solo)",
                        real_rows(entry_of(final, i), prog.Q),
                        real_rows(f_solo, prog.Q))
            s_solo = _fabric_summary(sc, rc, m_solo)
            assert res[i] == s_solo, (name, i, res[i], s_solo)
            assert int(mb["warp_trips"][i]) == s_solo["warp_trips"], i
            got = json.loads(json.dumps(s_solo))
            got["done_tick"] = [int(v) for v in m_solo["done_tick"]]
            held(f"{name} entry {i}", got, want["entries"][i],
                 keys + ["warp_trips", "end_tick", "done_tick"])
        log(f"[sweep] {name}: sweep() of {len(cfgs)} entries ({w_sweep:.3f}s"
            f", launches {launches}) equals each entry's solo run "
            f"({w_solo:.3f}s for the {len(cfgs)}: every state leaf, the "
            f"summary, warp trips {[int(v) for v in mb['warp_trips']]}) "
            f"and the JAX-made file; the batched loop took {prog.trips} "
            f"trips")
        return res, w_sweep, w_solo, launches, prog

    t_phase = time.time()
    marks = {}

    def mark(what):
        marks[what] = round(time.time() - t_phase, 3)

    # (a) sweep8: perm1024 seeds 0-7 under STrack adaptive, warp on
    cfg = RunConfig()
    fcfg = _fabric_cfg(scs[0], cfg)
    scs_of = {"perm1024_sweep8_strack": scs,
              "perm1024_sweep4_rocev2": [scs[0]] * 4}
    want8 = json.loads((TESTDATA / "perm1024_sweep8_strack_ref.json")
                       .read_text())
    res8, w_sweep8, w_solo8, l8, prog8 = against_solo(
        "perm1024_sweep8_strack", [cfg] * 8, [fcfg] * 8, None, want8,
        ("flow_transition_batch", "serve_enqueue_batch"))
    ref0 = json.loads((TESTDATA / "perm1024_strack_ref.json").read_text())
    got0 = dict(res8[0], done_tick=want8["entries"][0]["done_tick"])
    held("sweep8 entry 0 vs perm1024_strack_ref", got0, ref0,
         [k for k in ref0 if k != "n_ticks"])

    mark("a")
    # (b) RoCEv2 + PFC, perm1024 seed 0 under entropy seeds 0-3
    cfgs = [RunConfig(protocol="rocev2", roce_entropy_seed=s)
            for s in range(4)]
    want4 = json.loads((TESTDATA / "perm1024_sweep4_rocev2_ref.json")
                       .read_text())
    res4, w_sweep4, w_solo4, l4, _ = against_solo(
        "perm1024_sweep4_rocev2", cfgs, [_fabric_cfg(scs[0], c)
                                         for c in cfgs], list(range(4)),
        want4, ("flow_transition_roce_batch", "serve_enqueue_batch",
                "pfc_account_batch"))

    mark("b")
    # (c) perm1024 seed 0's per-tick trace every 4 ticks
    tcfg = RunConfig(n_ticks=512, trace_queues=True, trace_every=4)
    want_t = json.loads((TESTDATA / "perm1024_trace4_strack_ref.json")
                        .read_text())
    (_, m), w_trace, _ = main_path(
        "perm1024 trace", lambda: F.run_fabric_trace(
            t32, scs[0].messages, 512, _fabric_cfg(scs[0], tcfg),
            device="cuda"), ("flow_transition", "serve_enqueue"))
    s_t = _fabric_summary(scs[0], tcfg, m)
    got = json.loads(json.dumps(s_t))
    got.update(trace_every=int(m["trace_every"]),
               done_tick=[int(v) for v in m["done_tick"]],
               rows={k: row_digest(m[k]) for k in want_t["rows"]})
    held("perm1024_trace4_strack", got, want_t,
         [k for k in want_t if k not in ("cwnd_mean", "queue_settle_us",
                                         "queue_settle_us_at")])
    assert s_t["queue_settle_us"] == want_t["queue_settle_us"], (
        s_t["queue_settle_us"], want_t["queue_settle_us"])
    settle_at = {th: _queue_settle_us(m, float(th))
                 for th in want_t["queue_settle_us_at"]}
    assert settle_at == want_t["queue_settle_us_at"], settle_at
    cw = [float(v) for v in m["cwnd_mean"]]
    assert len(cw) == len(want_t["cwnd_mean"]), len(cw)
    cw_err = max(abs(a - b) / abs(b) for a, b in zip(cw, want_t["cwnd_mean"]))
    assert cw_err <= TRACE_CWND_RTOL, cw_err
    log(f"[sweep] perm1024 trace every 4 ticks: {want_t['rows']['qsize']['rows']}"
        f" rows equal the JAX-made file (integer rows by sha256, the "
        f"delivered rows' float32 bits), cwnd_mean within {cw_err:.3g} "
        f"relative (limit {TRACE_CWND_RTOL}), queue_settle_us "
        f"{s_t['queue_settle_us']} (at lower thresholds {settle_at}); wall "
        f"{w_trace:.3f}s")

    mark("c")
    # (d) the batched kernels at B = 8 against their plain versions, on
    # dense ticks of (a)'s program and of (b)'s at entropy seeds 0-7
    seen8, cap8 = batch_walk("perm1024 strack seeds 0-7", F.batch_program(
        t32, [sc.messages for sc in scs], prog8.n_ticks, fcfg,
        device="cuda"), {3, 16, 40}, same, capture_at=16)
    assert seen8["sel"] > 0 and seen8["accepted"] > 0, seen8
    rcfg = _fabric_cfg(scs[0], cfgs[0])
    prog8_r = F.batch_program(t32, [scs[0].messages] * 8, prog8.n_ticks,
                              rcfg, entropy_seeds=list(range(8)),
                              device="cuda")
    seen_r, cap_r = batch_walk("perm1024 rocev2 entropy seeds 0-7", prog8_r,
                               {3, 16, 40}, same, capture_at=16)
    assert seen_r["sel"] > 0 and seen_r["accepted"] > 0, seen_r
    # incast1024 under RoCEv2 + PFC, where switch ports pause at 61-72 and
    # gate their rows from 73 (phase 6b): the PFC stage's gates at B = 8
    inc = incast_scenario(t32, 256, 16 * 2 ** 10, net=net400)
    seen_i, _ = batch_walk("incast1024 rocev2 entropy seeds 0-7",
                           F.batch_program(
                               t32, [inc.messages] * 8,
                               _scenario_ticks(inc, cfgs[0]),
                               _fabric_cfg(inc, cfgs[0]),
                               entropy_seeds=list(range(8)), device="cuda"),
                           {64, 73, 100}, same)
    assert seen_i["new_pauses"] > 0 and seen_i["paused_rows"] > 0, seen_i
    batch_of_one("perm1024 strack t=16", prog8, cap8, same)
    batch_of_one("perm1024 rocev2 t=16", prog8_r, cap_r, same)
    targs8, sargs8, ring8, _ = cap8
    targs_r, _, _, pargs_r = cap_r
    ring_k, ring_p = _clone(ring8), _clone(ring8)
    mark("d")

    # (e) timings, no claim: the sweep against its solo runs; launches and
    # host ms a trip at B = 1 and B = 8
    prog1 = F.batch_program(t32, [scs[0].messages], prog8.n_ticks, fcfg,
                            device="cuda")
    prog1.run()   # warm: its first run's allocations
    walls = {1: [], 8: []}
    for b, prog in ((1, prog1), (8, prog8), (8, prog8), (1, prog1)):
        torch.cuda.synchronize()
        t0 = time.time()
        prog.run()
        torch.cuda.synchronize()
        walls[b].append(time.time() - t0)
    per_trip = {}
    for b, prog in ((1, prog1), (8, prog8)):
        n_launch, trips = run_launches(prog)
        wall = sum(walls[b]) / 2
        per_trip[b] = dict(trips=trips, launches_a_trip=n_launch / trips,
                           host_ms_a_trip=wall * 1e3 / trips, wall_s=walls[b])
    mark("e")
    log(f"[sweep] timings (no claim): sweep8 {w_sweep8:.3f}s against its 8 "
        f"solo runs {w_solo8:.3f}s ({w_solo8 / w_sweep8:.3f}x); sweep4 "
        f"RoCEv2 + PFC {w_sweep4:.3f}s against 4 solo runs {w_solo4:.3f}s; "
        f"per trip at B = 1: {per_trip[1]}; at B = 8: {per_trip[8]}; device "
        f"ms a batched call at B = 8: {ms}")

    # the kernels line's entries: the bytes and operations of the
    # unbatched calls' bounds, over the whole batch
    Q = prog8.Q
    slot_bytes = sum(f.element_size() for f in ring8)
    res8 = fk.serve_enqueue_batch(_clone(ring8), *sargs8[1:])
    pfc8 = fk.pfc_account_batch(*pargs_r)
    M = res8[6].shape[-1]
    work = {   # name: (kernel call, plain call, bytes, operations)
        "flow_transition_batch": (
            lambda: fk.flow_transition_batch(*targs8),
            lambda: fk.flow_transition_batch_plain(*targs8),
            nbytes(targs8[:4]) + index_bytes(targs8[7])
            + nbytes(fk.flow_transition_batch(*targs8)),
            targs8[2].numel() * (2 * 512 + 64)),
        "flow_transition_roce_batch": (
            lambda: fk.flow_transition_batch(*targs_r),
            lambda: fk.flow_transition_batch_plain(*targs_r),
            nbytes(targs_r[:4]) + nbytes(targs_r[6]) + index_bytes(targs_r[7])
            + nbytes(fk.flow_transition_batch(*targs_r)),
            targs_r[2].numel() * 40),
        "serve_enqueue_batch": (
            lambda: fk.serve_enqueue_batch(ring_k, *sargs8[1:]),
            lambda: fk.serve_enqueue_batch_plain(ring_p, *sargs8[1:]),
            8 * (2 * 4 * (Q + 1) + Q * slot_bytes) + nbytes(sargs8[3:17])
            + nbytes(res8) + int(res8[7].sum()) * slot_bytes,
            8 * (Q * 40 + M * 20)),
        "pfc_account_batch": (
            lambda: fk.pfc_account_batch(*pargs_r),
            lambda: fk.pfc_account_batch_plain(*pargs_r),
            nbytes(pargs_r[0]) + 8 * (Q * 13 + M * 5 + 3 * 4 * (Q + 1))
            + int(pargs_r[6].sum()) * 9 + nbytes(pargs_r[12]) + nbytes(pfc8),
            8 * (Q * 8 + M * 4))}
    meta = {   # name: (source, TPU kernel, launches on the sweeps, shape)
        "flow_transition_batch": (
            "transition.cu", "src/repro/kernels/fabric_kernels.py:191",
            l8["flow_transition_batch"], "perm1024 B=8 t=16"),
        "flow_transition_roce_batch": (
            "transition_roce.cu", "src/repro/kernels/fabric_kernels.py:191",
            l4["flow_transition_roce_batch"], "perm1024 rocev2 B=8 t=16"),
        "serve_enqueue_batch": (
            "serve_enqueue.cu", "src/repro/kernels/fabric_kernels.py:184",
            l8["serve_enqueue_batch"] + l4["serve_enqueue_batch"],
            "perm1024 B=8 t=16"),
        "pfc_account_batch": (
            "serve_enqueue.cu", "src/repro/sim/fabric.py:1741",
            l4["pfc_account_batch"], "perm1024 rocev2 B=8 t=16")}
    entries = []
    for name, (kern, plain, n_bytes, n_ops) in work.items():
        src, repl, launches, shape = meta[name]
        bnd, by = bound_ms(n_bytes, n_ops)
        # the batched plain versions loop the entries: CUDA events around
        # back-to-back calls (the profiler loses their records)
        plain_ms = wall_ms(plain, reps=5)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": repl, "launches": launches,
            "max_abs_err": max_err[name], "ms": ms[name],
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "chain_ms": chain_ms(kern),
            "wall_ms": wall_ms(kern), "batch": 8, "shape": shape,
            "batch_of": BATCH_OF[name]})
    entries[0].update(sweep8_wall_s=w_sweep8, solo8_wall_s=w_solo8,
                      sweep4_rocev2_wall_s=w_sweep4,
                      solo4_rocev2_wall_s=w_solo4, per_trip_b1=per_trip[1],
                      per_trip_b8=per_trip[8], trace4_wall_s=w_trace)
    mark("entries")
    log(f"[sweep] phase 6f: seconds since its start after each part {marks}")
    entries[0]["phase_6f_s"] = marks
    return entries


def fleet_records(fleet: dict) -> tuple:
    """``(topo, net, jobs, tenants)`` of the port for ``SOAK_FLEET`` or
    ``SPOT_FLEET``."""
    from repro_torch.core.params import NetworkSpec
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.traffic import InferenceTenant, TrainingJob
    return (full_bisection(*fleet["shape"]),
            NetworkSpec(link_gbps=fleet["link_gbps"]),
            [TrainingJob(**j) for j in fleet["jobs"]],
            [InferenceTenant(**t) for t in fleet["tenants"]])


def canon(obj) -> str:
    """``obj`` in JSON's own form (tuples as lists, keys as strings,
    sorted), for exact comparison with a JAX-made file."""
    return json.dumps(json.loads(json.dumps(obj)), sort_keys=True)


def schedule_active(fs, t: int) -> bool:
    """Whether any window of the fault schedule ``fs`` covers tick ``t``
    (a corruption window only with a probability above 0)."""
    spans = ([w[2:4] for w in fs.link_flaps + fs.uplink_flaps]
             + [w[1:3] for w in fs.host_flaps]
             + [w[2:4] for w in fs.link_degrade]
             + [w[2:4] for w in fs.link_corrupt if w[4] > 0]
             + [w[1:3] for w in fs.host_corrupt if w[3] > 0])
    return any(t0 <= t < t1 for t0, t1 in spans)


def tenant_fct_of(sc, msg_fct: dict) -> dict:
    """Per-group FCT percentiles from an oracle run's ``msg_fct``, as
    benchmarks/soak.py:85-100 (``_events_tenant_fct``) computes them."""
    import numpy as np
    by_g: dict = {}
    for m in sc.messages:
        by_g.setdefault(m.group, []).append(msg_fct.get(m.mid))
    rows = {}
    for g, fs in by_g.items():
        done = [f for f in fs if f is not None]
        rows[g] = {"count": len(fs), "unfinished": len(fs) - len(done),
                   "p50": float(np.percentile(done, 50)) if done
                   else float("nan"),
                   "p99": float(np.percentile(done, 99)) if done
                   else float("nan")}
    return rows


#: Ticks of the soak's chaos epoch (epoch 1 of SOAK_FLEET at seed 0 under
#: CHAOS1024) where the kernels are held against their plain versions:
#: the link flap's down rows pop into the blackhole at 13, 39 and 45 (39
#: and 45 also release burst messages); the HD job's first messages
#: release at 64 and a corrupting row drops at 65; collective children
#: release at 221, 229 and 232 (the ring's first completions come after
#: the flap: at 229 and 232 beside corrupted packets).  Found by stepping
#: the plain version on the CPU.
SOAK_TICKS = (13, 39, 45, 64, 65, 221, 229, 232)


def soak_phase(dev) -> dict:
    """Phase 6g: the observatory's chaos soak and the event oracle.
    Returns the ``soak_*`` fields of the transition's and serve/enqueue's
    ``kernels`` entries."""
    import tempfile
    import torch
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.obs.metrics import (MetricsRegistry, parse_prometheus,
                                         render_prometheus)
    from repro_torch.profile import CHAOS1024
    from repro_torch.sim import fabric as F
    from repro_torch.sim.traffic import (inert_faults_like, mixed_scenario,
                                         soak)
    from repro_torch.sim.workloads import RunConfig, _fabric_summary, run

    t_phase = time.time()
    want = json.loads((TESTDATA / "soak64_chaos2_strack_ref.json")
                      .read_text())
    assert want["chaos"] == [None, json.loads(json.dumps(
        dataclasses.asdict(CHAOS1024)))], want["chaos"]
    topo, net, jobs, tenants = fleet_records(SOAK_FLEET)
    chaos = [None, CHAOS1024]
    max_err = {"flow_transition": 0.0, "serve_enqueue": 0.0}

    # (a) the soak: two epochs on one program, each epoch's fabric run
    # recorded (wall, trips, kernel launches, the ticks serve/enqueue got
    # fault rows at)
    epochs, fault_ticks = [], []
    real_run, real_serve = F.run_program, F.serve_enqueue

    def serve_recorded(*args):
        if any(a is not None for a in args[20:23]):   # the fault rows
            fault_ticks.append(args[17])
        return real_serve(*args)

    def run_recorded(prog):
        fault_ticks.clear()
        torch.cuda.synchronize()
        before, t0 = dict(fk.launches), time.time()
        final, metrics = real_run(prog)
        torch.cuda.synchronize()
        epochs.append(dict(
            wall_s=time.time() - t0, trips=int(metrics["warp_trips"]),
            launches={k: c - before[k] for k, c in fk.launches.items()},
            fault_ticks=list(fault_ticks), faults=prog.cfg.faults,
            metrics=metrics, prog=id(prog)))
        return final, metrics

    reg = MetricsRegistry()
    F.run_program, F.serve_enqueue = run_recorded, serve_recorded
    try:
        with tempfile.TemporaryDirectory() as d:
            out_path = Path(d) / "soak.prom"
            torch.cuda.synchronize()
            fk.reset_launches()
            t0 = time.time()
            res = soak(topo, jobs, tenants, epochs=want["epochs"], net=net,
                       seed=want["seed"], registry=reg,
                       out_path=str(out_path), chaos=chaos, device=dev)
            torch.cuda.synchronize()
            soak_wall = time.time() - t0
            soak_launches = dict(fk.launches)
            prom = out_path.read_text()
    finally:
        F.run_program, F.serve_enqueue = real_run, real_serve
    assert res["program_builds"] == 1, res["program_builds"]
    assert len({e["prog"] for e in epochs}) == 1
    assert canon(res) == canon(want["soak"]), "soak return dict"
    assert prom == render_prometheus(reg) == want["prom"], ".prom text"
    assert parse_prometheus(prom)[("strack_epochs_total", ())] == 2.0
    inert = inert_faults_like(CHAOS1024)
    for e, ep in enumerate(epochs):
        sc, _ = mixed_scenario(topo, jobs, tenants, net=net,
                               seed=want["seed"], epoch=e)
        ecfg = RunConfig(n_ticks=res["n_ticks"], faults=chaos[e] or inert)
        assert ep["faults"] == ecfg.faults, e
        summary = _fabric_summary(sc, ecfg, ep["metrics"])
        assert canon(summary) == canon(want["epoch_runs"][e]), \
            f"epoch {e} run() summary"
        # exactly the path's kernels, one of each a trip; serve/enqueue
        # takes the fault rows every tick, and they act in epoch 1 only
        fired = {k for k, c in ep["launches"].items() if c}
        assert fired == set(STRACK_KERNELS), (e, ep["launches"])
        assert ep["launches"]["flow_transition"] == ep["trips"] == \
            ep["launches"]["serve_enqueue"], (e, ep["launches"], ep["trips"])
        assert len(ep["fault_ticks"]) == ep["trips"], e
        ep["fault_active"] = sum(schedule_active(ep["faults"], t)
                                 for t in ep["fault_ticks"])
        assert (ep["fault_active"] > 0) == (e == 1), (e, ep["fault_active"])
        assert (summary["blackholed_pkts"] > 0) == (e == 1), summary
        ep["summary"] = summary
    assert soak_launches == {k: sum(ep["launches"][k] for ep in epochs)
                             for k in soak_launches}
    t_a = time.time() - t_phase
    for e, ep in enumerate(epochs):
        kind = "CHAOS1024" if e else "clean, inert schedule"
        log(f"[soak] epoch {e} ({kind}): wall {ep['wall_s']:.3f}s, "
            f"warp trips {ep['trips']}, {ep['trips'] / ep['wall_s']:.1f} "
            f"trips/s, kernel launches a trip 2 ({ep['launches']}), fault "
            f"rows active at {ep['fault_active']} of its serve/enqueue "
            f"calls; max_fct {ep['summary']['max_fct']} us, blackholed "
            f"{ep['summary']['blackholed_pkts']}, corrupted "
            f"{ep['summary']['corrupt_drops']}, retransmits "
            f"{ep['summary']['retransmits']}")
    log(f"[soak] default fleet (64 hosts, {res['totals']['messages']} "
        f"messages over 2 epochs of {res['n_ticks']} ticks): soak() equals "
        f"soak64_chaos2_strack_ref.json (return dict, each epoch's run() "
        f"summary, the .prom text byte for byte), 1 program build; wall "
        f"{soak_wall:.3f}s; degradation_p99 "
        f"{ {k: v['degradation_p99'] for k, v in res['per_tenant'].items()} }")

    # (b) the kernels against their plain versions at ticks of the chaos
    # epoch (dense, a program of its own)
    sc1, _ = mixed_scenario(topo, jobs, tenants, net=net, seed=want["seed"],
                            epoch=1)
    prog = fabric_program(sc1, RunConfig(n_ticks=res["n_ticks"],
                                         faults=CHAOS1024), dev)
    has_deps = torch.tensor([bool(m.deps) for m in sc1.messages],
                            device=dev)
    seen = dict.fromkeys(("down_pops", "released", "children",
                          "down_and_released", "blackholed", "corrupted"),
                         0)
    st = prog.init_state()
    for t in range(max(SOAK_TICKS) + 1):
        if t in SOAK_TICKS:
            fm = prog.fault_masks(t)
            sm = prog.sendable_msg(st, t)
            targs = prog.transport_args(st, t, sm)
            out_k = fk.flow_transition(*targs)
            max_err["flow_transition"] = max(
                max_err["flow_transition"], assert_same(
                    f"soak t={t} flow_transition", out_k,
                    fk.flow_transition_plain(*targs)))
            _, tx, ptx, pv, sel, _ = out_k
            sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv, None, fm)
            rings = [type(st.q)(*[f.clone() for f in st.q])
                     for _ in range(2)]
            res_k = fk.serve_enqueue(rings[0], *sargs[1:])
            res_p = fk.serve_enqueue_plain(rings[1], *sargs[1:])
            max_err["serve_enqueue"] = max(
                max_err["serve_enqueue"],
                assert_same(f"soak t={t} serve_enqueue", res_k, res_p),
                assert_same(f"soak t={t} ring",
                            [f[:prog.Q] for f in rings[0]],
                            [f[:prog.Q] for f in rings[1]]))
            new = sm & (st.msg_release_tick < 0)
            down = int((res_k[3] & fm.row_down).sum())
            seen["down_pops"] += down
            seen["released"] += int(new.sum())
            seen["children"] += int((new & has_deps).sum())
            seen["down_and_released"] += int(down > 0 and bool(new.any()))
            seen["blackholed"] += int(res_k[11])
            seen["corrupted"] += int(res_k[12])
        st, _, _ = prog.tick(st, t)
    torch.cuda.synchronize()
    assert all(v > 0 for v in seen.values()), seen
    per_tick = {"chaos": tick_launches(prog, st, max(SOAK_TICKS) + 1, 20)}
    prog0 = fabric_program(mixed_scenario(
        topo, jobs, tenants, net=net, seed=want["seed"], epoch=0)[0],
        RunConfig(n_ticks=res["n_ticks"], faults=inert), dev)
    st0 = prog0.init_state()
    for t in range(max(SOAK_TICKS) + 1):
        st0, _, _ = prog0.tick(st0, t)
    per_tick["clean"] = tick_launches(prog0, st0, max(SOAK_TICKS) + 1, 20)
    log(f"[soak] flow_transition and serve_enqueue (with CHAOS1024's fault "
        f"rows) match their plain versions at chaos-epoch ticks "
        f"{list(SOAK_TICKS)}: {seen}; device launches a dense tick (profiler,"
        f" 20 ticks from {max(SOAK_TICKS) + 1}): {per_tick}")
    t_b = time.time() - t_phase

    # (c) the event oracle on the host, against events64_ref.json
    ev_want = json.loads((TESTDATA / "events64_ref.json").read_text())
    fleets = {"default": (topo, net, jobs, tenants),
              "spot": fleet_records(SPOT_FLEET)}
    oracle = {}
    for name, (fleet, kw) in EVENTS_RUNS.items():
        ftopo, fnet, fjobs, ften = fleets[fleet]
        sc = mixed_scenario(ftopo, fjobs, ften, net=fnet, seed=0)[0]
        kw = dict(kw)
        if kw.get("faults") == "CHAOS1024":
            kw["faults"] = CHAOS1024
        t0 = time.time()
        got = run(sc, RunConfig(backend="events", until=EVENTS_UNTIL_US,
                                **kw))
        wall = time.time() - t0
        assert canon(got) == canon(ev_want[name]), name
        assert got["unfinished"] == 0 and len(got["msg_fct"]) == len(
            sc.messages), name
        oracle[name] = (sc, got)
        log(f"[oracle] {name}: equals events64_ref.json ({len(sc.messages)} "
            f"messages, msg_fct and group_fct included; max_fct "
            f"{got['max_fct']} us, blackholed {got['blackholed_pkts']}, "
            f"corrupted {got['corrupt_drops']}); host wall {wall:.3f}s")
    t_c = time.time() - t_phase

    # (d) the tenant spot check (benchmarks/soak.py:103-138): the fabric
    # on the card against the oracle on the spot fleet
    sc_spot, ev_spot = oracle["spot_strack"]
    fb = run(sc_spot, RunConfig(), device=dev)
    ev_rows = tenant_fct_of(sc_spot, ev_spot["msg_fct"])
    assert fb["unfinished"] == 0, fb["unfinished"]
    _, _, s_jobs, s_tenants = fleets["spot"]
    ratios = {}
    for g, name in enumerate([j.name for j in s_jobs]
                             + [t.name for t in s_tenants]):
        assert ev_rows[g]["unfinished"] == 0, (name, ev_rows[g])
        for q in ("p50", "p99"):
            ratios[f"{name} {q}"] = r = fb["tenant_fct"][g][q] / ev_rows[g][q]
            assert SPOT_BAND[0] < r < SPOT_BAND[1], (name, q, r)
    log(f"[soak] tenant spot check: fabric (card) over oracle per tenant "
        f"{ratios}, all inside {SPOT_BAND}")
    wall = time.time() - t_phase
    log(f"[soak] phase 6g wall {wall:.1f}s (after (a) {t_a:.1f}s, (b) "
        f"{t_b:.1f}s, (c) {t_c:.1f}s)")
    by_epoch = [ep["launches"] for ep in epochs]
    return {
        "flow_transition": {
            "soak_launches": soak_launches["flow_transition"],
            "soak_launches_by_epoch": [e["flow_transition"]
                                       for e in by_epoch],
            "soak_max_abs_err": max_err["flow_transition"],
            "soak_phase_6g_s": wall},
        "serve_enqueue": {
            "soak_launches": soak_launches["serve_enqueue"],
            "soak_launches_by_epoch": [e["serve_enqueue"] for e in by_epoch],
            "soak_fault_active_by_epoch": [ep["fault_active"]
                                           for ep in epochs],
            "soak_max_abs_err": max_err["serve_enqueue"]}}


def _clone(tree):
    from repro_torch.sim.fabric import _clone_tree
    return _clone_tree(tree)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs the port on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    if sys.argv[1:2] == ["--train-resume"]:   # phase 11 (e)'s restart
        return train_resume(sys.argv[2])
    import numpy as np
    from repro_torch.core.cc import CCState
    from repro_torch.core.lb import SprayState
    from repro_torch.core.params import NetworkSpec
    from repro_torch.core.reliability import RelState, SackMsg
    from repro_torch.core.transport import FlowState
    from repro_torch.kernels import fabric_kernels as fk
    from repro_torch.kernels._build import build_all
    from repro_torch.numerics import Now
    from repro_torch.sim.topology import full_bisection
    from repro_torch.sim.workloads import (RunConfig, incast_scenario,
                                           permutation_scenario, run)
    from torch_states import random_cc, random_rel, random_sack, \
        random_spray

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    net400 = NetworkSpec(link_gbps=400.0)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.time()
    paths = build_all(verbose=True)
    log(f"[build] {len(paths)} kernels in {time.time() - t0:.1f}s: "
        + ", ".join(p.name for p in paths.values()))

    if sys.argv[1:] == ["--phase", "6f"]:   # phase 6f alone, after the build
        print(json.dumps({"kernels": sweeps(dev, batch_one_launch(dev))}),
              flush=True)
        return finish(kind)
    if sys.argv[1:] == ["--phase", "6g"]:   # phase 6g alone, after the build
        print(json.dumps(soak_phase(dev)), flush=True)
        return finish(kind)
    if sys.argv[1:] == ["--phase", "9"]:    # phase 9 alone, after the build
        print(json.dumps(serve_moe(dev)), flush=True)
        return finish(kind)
    if sys.argv[1:] == ["--phase", "10"]:   # phase 10 alone, after the build
        print(json.dumps(serve_mm(dev)), flush=True)
        return finish(kind)
    if sys.argv[1:] == ["--phase", "11"]:   # phase 11 alone, after the build
        print(json.dumps({"kernels": [train_phase(dev)]}), flush=True)
        return finish(kind)

    # ---- 2. kernels vs plain versions on the card -------------------------
    def program(sc, cfg):
        return fabric_program(sc, cfg, dev)

    timing = {}
    max_err = {"flow_transition": 0.0, "serve_enqueue": 0.0,
               "rank_in_queue": 0.0}

    def same(key, what, a, b):
        max_err[key] = max(max_err[key], assert_same(what, a, b))

    def check_transition(what, targs):
        out_k = fk.flow_transition(*targs)
        same("flow_transition", f"{what} flow_transition", out_k,
             fk.flow_transition_plain(*targs))
        return out_k

    def check_ticks(name, sc, ticks, time_at=None, congested=False):
        """Kernels vs plain versions at ``ticks`` of a dense run; with
        ``congested``, fail unless those ticks dropped, marked ECN both
        ways on the dither, and saw flows in recovery with claimed bits."""
        prog = program(sc, RunConfig())
        sd = prog.serve_dims
        st = prog.init_state()
        seen = dict.fromkeys(("drops", "marks", "dither_rows",
                              "dither_marks", "in_recovery", "claimed",
                              "probes"), 0)
        for t in range(max(ticks) + 1):
            if t in ticks:
                targs = prog.transport_args(st, t, prog.sendable_msg(st, t))
                out_k = check_transition(f"{name} t={t}", targs)
                _, tx, ptx, pv, sel, _ = out_k
                sargs, _, _ = prog.serve_args(st, t, tx, ptx, sel, pv)
                rings = [type(st.q)(*[f.clone() for f in st.q])
                         for _ in range(2)]
                res_k = fk.serve_enqueue(rings[0], *sargs[1:])
                res_p = fk.serve_enqueue_plain(rings[1], *sargs[1:])
                same("serve_enqueue", f"{name} serve_enqueue t={t}", res_k,
                     res_p)
                same("serve_enqueue", f"{name} ring t={t}",
                     [f[:prog.Q] for f in rings[0]],
                     [f[:prog.Q] for f in rings[1]])
                qid, accept = res_k[6], res_k[7]
                for flag in (accept, res_k[3].new_ones(qid.shape)):
                    same("rank_in_queue", f"{name} rank_in_queue t={t}",
                         fk.rank_in_queue(qid, flag, prog.Q),
                         fk.rank_in_queue_plain(qid, flag, prog.Q))
                pop, has, ecn_out = res_k[2], res_k[3], res_k[4]
                new_mark = has & ecn_out & ~pop.ecn
                residual = (st.qsize[:prog.Q] - 1).clamp_min(0).float()
                decided = (has & ~pop.probe & (residual > sd.kmin_p)
                           & (residual < sd.kmax_p))
                rel_in, rel_out = targs[0].rel, out_k[0].rel
                seen["drops"] += int(res_k[8])
                seen["marks"] += int(new_mark.sum())
                seen["dither_rows"] += int(decided.sum())
                seen["dither_marks"] += int((decided & new_mark).sum())
                seen["in_recovery"] += int(
                    (rel_in.in_recovery | rel_out.in_recovery).sum())
                seen["claimed"] += int((rel_in.claimed.any(1)
                                        | rel_out.claimed.any(1)).sum())
                seen["probes"] += int(pv.sum())
                if t == time_at:
                    timing["transition"] = (targs, out_k)
                    timing["serve"] = (sargs, res_k, type(st.q)(
                        *[f.clone() for f in st.q]))
                    timing["rank"] = (qid, accept, prog.Q)
            st, _, _ = prog.tick(st, t)
        torch.cuda.synchronize()
        if congested:
            assert seen["drops"] > 0 and seen["marks"] > 0, (name, seen)
            assert 0 < seen["dither_marks"] < seen["dither_rows"], (name,
                                                                    seen)
            assert seen["in_recovery"] > 0 and seen["claimed"] > 0, (name,
                                                                     seen)
            assert seen["probes"] > 0, (name, seen)
        log(f"[kernels] {name}: transition, serve_enqueue and rank_in_queue "
            f"match their plain versions at ticks {sorted(ticks)}; summed "
            f"over those ticks {seen}")
        return prog

    perm1024 = permutation_scenario(full_bisection(32, 32), 64 * 2 ** 10,
                                    net=net400, seed=0)
    incast1024 = incast_scenario(full_bisection(32, 32), 256, 16 * 2 ** 10,
                                 net=net400)
    perm8k = permutation_scenario(full_bisection(128, 64), 64 * 2 ** 10,
                                  net=net400, seed=0)
    prog1024 = check_ticks("perm1024", perm1024, {3, 8, 16, 40},
                           time_at=16)
    # drops at 42-56; the dither decides at 590-630 and 1200-1260; flows
    # in recovery with claimed bits at 700-740 and 1160-1260; timer ticks
    # (t % 8 == 0) among them send probes.
    check_ticks("incast1024", incast1024,
                {42, 48, 56, 400, 590, 600, 610, 620, 630, 700, 740, 1160,
                 1200, 1210, 1220, 1230, 1240, 1250, 1260}, congested=True)
    check_ticks("perm8k", perm8k, {8, 16})

    dims = prog1024.trans_dims
    n, rng = prog1024.N, np.random.default_rng(0)
    seen = dict(rto=0, recoveries=0, probes=0, lost_nic=0)
    cuda = lambda d: {k: torch.from_numpy(np.array(v)).to(dev)
                      for k, v in d.items()}
    for t in (2400, 2401, 2403, 2408):   # timer ticks: t % 8 == 0
        now = float(Now(t, dims.tick_us))
        rel_d = random_rel(rng, n, dims.p)
        flows = FlowState(cc=CCState(**cuda(random_cc(rng, n, dims.p))),
                          spray=SprayState(**cuda(random_spray(rng, n,
                                                               dims.p))),
                          rel=RelState(**cuda(rel_d)))
        due = SackMsg(**cuda(random_sack(rng, n, dims.p, rel_d, now)))
        sendable = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        src = torch.from_numpy(rng.integers(0, n // 4, n).astype(np.int32)
                               ).to(dev)
        out = check_transition(f"random flows t={t}",
                               (flows, due, sendable, src, t, dims, None,
                                fk.src_index(src, dims.n_hosts)))
        seen["rto"] += int((out[0].rel.rto_fires
                            > flows.rel.rto_fires).sum())
        seen["recoveries"] += int((out[0].rel.recoveries
                                   > flows.rel.recoveries).sum())
        seen["probes"] += int(out[3].sum())
        seen["lost_nic"] += int((out[5] & ~out[4]).sum())
    torch.cuda.synchronize()
    assert all(v > 0 for v in seen.values()), seen
    log(f"[kernels] flow_transition matches its plain version on random "
        f"flow states at {n} lanes (timer and other ticks): {seen}")

    gen = torch.Generator(device="cpu").manual_seed(0)
    for n_queues in (3072, 24576):
        for m in (255, 256, 257, 511, 512, 513, 4096, 32768):
            for span, density in ((n_queues, 0.5), (7, 0.5), (3, 1.0),
                                  (3, 0.0)):
                qid = torch.randint(0, span, (m,), generator=gen,
                                    dtype=torch.int32).to(dev)
                flag = (torch.rand((m,), generator=gen) < density).to(dev)
                same("rank_in_queue", f"rank_in_queue m={m} q={n_queues}",
                     fk.rank_in_queue(qid, flag, n_queues),
                     fk.rank_in_queue_plain(qid, flag, n_queues))
    torch.cuda.synchronize()
    log("[kernels] rank_in_queue matches its plain version at M = 255, 256, "
        "257, 511, 512, 513, 4096, 32768 (Q = 3072 and 24576; empty, "
        "all-flagged and duplicate-heavy cases)")
    # phase 6's kernel times, taken here: late in a long process the
    # profiler loses records (PERF.md section 6)
    targs, out_k = timing["transition"]
    sargs, res_k, ring0 = timing["serve"]
    ring_k = type(ring0)(*[f.clone() for f in ring0])
    ring_p = type(ring0)(*[f.clone() for f in ring0])
    qid, accept, nq = timing["rank"]
    calls = {
        "flow_transition": (lambda: fk.flow_transition(*targs),
                            lambda: fk.flow_transition_plain(*targs)),
        "serve_enqueue": (lambda: fk.serve_enqueue(ring_k, *sargs[1:]),
                          lambda: fk.serve_enqueue_plain(ring_p,
                                                         *sargs[1:])),
        "rank_in_queue": (lambda: fk.rank_in_queue(qid, accept, nq),
                          lambda: fk.rank_in_queue_plain(qid, accept, nq)),
    }
    n = prog1024.N
    Q, M = prog1024.Q, res_k[6].numel()
    slot_bytes = sum(f.element_size() for f in ring0)
    n_acc = int(res_k[7].sum())
    s_bytes = (2 * 4 * (Q + 1) + Q * slot_bytes + nbytes(sargs[3:17])
               + nbytes(res_k) + n_acc * slot_bytes)
    bounds = {
        "flow_transition": bound_ms(nbytes(targs[:4]) + index_bytes(targs[7])
                                    + nbytes(out_k), n * 2 * 512 + n * 64),
        "serve_enqueue": bound_ms(s_bytes, Q * 40 + M * 20),
        "rank_in_queue": bound_ms(M * (4 + 1) + M * 4, M * 128),
    }
    csrc = "src/repro_torch/kernels/csrc"
    sources = {"flow_transition": ("transition.cu", 191),
               "serve_enqueue": ("serve_enqueue.cu", 184),
               "rank_in_queue": ("rank.cu", 117)}
    kernels = []
    for name, (kern, plain) in calls.items():
        ms = own_device_ms(name, kern)
        plain_ms, _ = device_ms(plain, reps=10)
        src, line = sources[name]
        bnd, by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{src}",
            "replaces": f"src/repro/kernels/fabric_kernels.py:{line}",
            "launches": None, "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": None,
            "wall_ms": wall_ms(kern), "plain_wall_ms": wall_ms(plain,
                                                               reps=10),
            "graph_ms": graph_ms(kern)})
        if name in ("serve_enqueue", "flow_transition"):
            kernels[-1]["chain_ms"] = chain_ms(kern)
        if name == "rank_in_queue":  # off the main paths since PR 20
            kernels[-1]["main_paths"] = ("0 launches: its work runs inside "
                                         "serve_enqueue's kernel")
    prof_ms = one_launch_paths(dev)
    batch_ms = batch_one_launch(dev)

    # ---- 3. goldens --------------------------------------------------------
    t44 = full_bisection(4, 4)
    goldens = {
        "perm16_strack": permutation_scenario(t44, 256 * 2 ** 10, net=net400,
                                              seed=0),
        "incast8_strack": incast_scenario(t44, 8, 512 * 2 ** 10, net=net400),
    }
    for name, sc in goldens.items():
        want = json.loads((ROOT / "tests" / "golden" / f"{name}.json")
                          .read_text())
        t0 = time.time()
        got = run(sc, RunConfig(), device="cuda")
        for k, v in want.items():
            if isinstance(v, float):
                assert math.isclose(got[k], v, rel_tol=1e-6), (name, k,
                                                               got[k], v)
            else:
                assert got[k] == v, (name, k, got[k], v)
        log(f"[golden] {name}: {want} matched in {time.time() - t0:.2f}s "
            f"({got['warp_trips']} warp trips)")

    # ---- 4. full width: perm1024 (the main path), then incast1024 ----------
    launches, s_perm, w_perm = hold_against_reference(
        "perm1024_strack", perm1024, RunConfig(), STRACK_KERNELS)
    _, s_inc, w_inc = hold_against_reference(
        "incast1024_strack", incast1024, RunConfig(), STRACK_KERNELS)

    # ---- 5. scale: perm8k --------------------------------------------------
    t0 = time.time()
    r8k = run(perm8k, RunConfig(), device="cuda")
    torch.cuda.synchronize()
    wall8k = time.time() - t0
    assert r8k["unfinished"] == 0, r8k["unfinished"]
    log(f"[perm8k] 8192 flows, unfinished 0, max_fct {r8k['max_fct']:.4f} us, "
        f"drops {r8k['drops']}; wall {wall8k:.3f}s, warp trips "
        f"{r8k['warp_trips']}, {r8k['warp_trips'] / wall8k:.1f} trips/s, "
        f"{r8k['end_tick'] / wall8k:.1f} ticks/s")

    # ---- 6. kernel times and bounds at the perm1024 shapes ------------------
    targs, out_k = timing["transition"]
    sargs, res_k, ring0 = timing["serve"]
    seen = synthetic_ticks("perm1024 t=16", sargs, ring0, same)
    assert seen["bucket_drops"] > 0, seen  # 2 N candidates in one row
    floors = launch_floors(dev)
    log(f"[floor] {floors}")
    for entry in kernels:  # launches on the main path (phase 4)
        entry["launches"] = launches[entry["name"]]
        if entry["name"] in ("serve_enqueue", "flow_transition"):
            entry["ms"] = prof_ms[entry["name"]]  # the profiler's, phase 2b

    # ---- 6b. RoCEv2 (DCQCN + go-back-N) and PFC on the fabric ------------
    pfc_entries, pfc_paths = roce_pfc(
        dev, {"perm1024": (s_perm, w_perm), "incast1024": (s_inc, w_inc)},
        prof_ms)
    for entry in kernels:
        entry.update(pfc_paths.get(entry["name"], {}))
        entry["max_abs_err"] = max(entry["max_abs_err"], entry.get(
            "pfc_max_abs_err", 0.0))
    kernels[1:1] = pfc_entries[:1]
    kernels.extend(pfc_entries[1:])
    torch.cuda.empty_cache()

    # ---- 6c. chaos: flaps, degrades and corruption on the fabric ----------
    fault = chaos(dev, w_perm, prof_ms)
    for entry in kernels:
        if entry["name"] == "flow_transition":  # its fault path, phase 2b
            entry["fault_ms"] = prof_ms["flow_transition fault"]
        if entry["name"] == "serve_enqueue":
            entry.update(fault)
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       fault["fault_max_abs_err"])
    torch.cuda.empty_cache()

    # ---- 6d. the active set on open-loop inference traffic ---------------
    act_entries, act_paths = active_set(dev, prof_ms)
    for entry in kernels:
        entry.update(act_paths.get(entry["name"], {}))
        entry["max_abs_err"] = max(entry["max_abs_err"], entry.get(
            "active_max_abs_err", 0.0))
    kernels.extend(act_entries)
    torch.cuda.empty_cache()

    # ---- 6e. dependency-scheduled collectives and sub-flow striping -------
    coll = collectives(dev, prof_ms)
    for entry in kernels:
        entry.update(coll.get(entry["name"], {}))
        entry["max_abs_err"] = max(entry["max_abs_err"], entry.get(
            "collective_max_abs_err", 0.0))
    torch.cuda.empty_cache()

    # ---- 6f. the batched sweep and the per-tick trace ---------------------
    kernels.extend(sweeps(dev, batch_ms))
    torch.cuda.empty_cache()

    # ---- 6g. the chaos soak, the observatory and the event oracle ---------
    soaked = soak_phase(dev)
    for entry in kernels:
        entry.update(soaked.get(entry["name"], {}))
        entry["max_abs_err"] = max(entry["max_abs_err"], entry.get(
            "soak_max_abs_err", 0.0))
    torch.cuda.empty_cache()

    # ---- 7. serve: llama3-8b through the flash-attention kernel -----------
    kernels.append(serve(dev))
    torch.cuda.empty_cache()

    # ---- 8. serve: mamba2-2.7b and zamba2-2.7b through the SSD kernel -----
    fa_entry = kernels[-1]
    ssd_entry, fa_zamba2 = serve_ssm(dev)
    fa_entry.update(fa_zamba2)
    for fa_route, by_route in fa_entry["routes"].items():
        by_route["launches_zamba2"] = fa_zamba2["routes_zamba2"][fa_route]
    fa_entry["routes"]["tc"]["zamba2_prefill_1024_hd80"] = \
        fa_zamba2["zamba2_prefill_1024_hd80"]
    fa_entry["max_abs_err"] = max(fa_entry["max_abs_err"],
                                  fa_zamba2["max_abs_err_hd80"])
    kernels.append(ssd_entry)
    torch.cuda.empty_cache()

    # ---- 9. serve, MoE: mixtral-8x22b and grok-1-314b through flash -------
    moe = serve_moe(dev)
    for fa_route, by_route in fa_entry["routes"].items():
        by_route.update(moe["routes"].get(fa_route, {}))
        by_route["launches_moe"] = {arch: n[fa_route] for arch, n in
                                    moe["routes_moe"].items()}
    fa_entry["launches_moe"] = moe["launches_moe"]
    fa_entry["max_abs_err"] = max(fa_entry["max_abs_err"],
                                  moe["max_abs_err_moe"])
    torch.cuda.empty_cache()

    # ---- 10. serve: whisper-small and internvl2-26b through flash --------
    mm = serve_mm(dev)
    for fa_route, by_route in fa_entry["routes"].items():
        by_route.update(mm["routes"].get(fa_route, {}))
        by_route["launches_mm"] = {arch: n[fa_route] for arch, n in
                                   mm["routes_mm"].items()}
    fa_entry["launches_mm"] = mm["launches_mm"]
    fa_entry["cross_kv_layer_ms"] = mm["cross_kv_layer_ms"]
    fa_entry["max_abs_err"] = max(fa_entry["max_abs_err"],
                                  mm["max_abs_err_mm"])
    del mm
    torch.cuda.empty_cache()

    # ---- 11. training, the SSD scan's backward kernel ---------------------
    kernels.append(train_phase(dev))
    print(json.dumps({"kernels": kernels, **floors}), flush=True)
    return finish(kind)


def finish(kind: str) -> int:
    """The card's name and power limit, then the last line."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"gpu: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
