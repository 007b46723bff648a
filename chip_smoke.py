#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc per
source, in parallel), then drives the port's main paths: first
``repro_torch.core.solve_batched`` with no device argument, at two of the
paper's workloads (src/repro_torch/configs/paper_lp.py):

1. ``lp_100d_50k``: 50,000 random 100 x 100 LPs of the Table-4 phase-1
   class; the first 64 are held against the float64 oracle with the
   reference's tolerance (status agreement >= 0.95, relative objective
   < 2e-3);
2. ``lp_afiro_100k``: 100,000 perturbed copies of Netlib AFIRO through the
   general-form pipeline; member 0 must reproduce the published optimum
   -4.6475314286E+02 (rtol 1e-4) and the first 64 hold against the oracle.

The kernel's launch counter is zeroed before the main path and must be
positive after it.  Then the kernel is held against its plain PyTorch
version on 2,048-LP slices of both batches for each pricing rule (status,
iterations and per-LP work counts equal; x, objective, y and z within 1e-5
relative; the two compute the same function, so they agree bit for bit)
and on 2,048 copies of
sc205_like, whose tableau does not fit in shared memory (the
device-memory variant; the plain version checks the first 128).

Then the compaction path: ``solve_batched(lp_100d_50k, compaction=True)``
on all 50,000 LPs goes through the segment kernel only (no whole-solve
launch) and must equal the whole-solve run bit for bit; on a 2,048-LP slice
at ``max_iters=200`` the two paths must agree, ITERATION_LIMIT included.
The segment kernel is held against its plain version on 2,048-LP slices of
lp_100d_50k and lp_afiro_100k and on sc205_like (plain version on the first
128) for every rule: one launch of each stage, leaf by leaf, and the whole
scheduled solve (status, iterations and work equal; x, objective, y, z
within rel 1e-5).  The registers, spills and stack of every
instantiation are printed (``simplex_ptxas``; any spill or stack fails
the run); each kernel line names its variant
(``shared``: the live columns in shared memory; ``device``).  Last, the box
LP: the Table-7 flow-pipe (n = 5, T = 500,
K = 40, so 20,000 box LPs) through ``solve_hyperbox`` on the card, against
the kernel's plain version (exact), the float64 oracle (rel 1e-5) and the
same LPs through ``solve_batched`` (rel 1e-4); the kernel is timed there
and at T = 50,000 (2,000,000 boxes), and one box through
``solve_hyperbox`` gives the launch floor.

Branch-and-bound (after the compaction path): the segment kernel's
combined stage (``segment_tile(stage="full")``, the counterpart of the
reference's ``segment_combined``) is held against its plain version at
atol 0, leaf by leaf, in one 8-step launch from mid-solve full-layout
states that hold lanes in phase 1, in phase 2 and warm-injected ones,
every rule, on the lp_100d_50k slice (``shared``) and 256 sc205_like LPs
(``device``, plain on 128); one launch takes all 50,000 LPs of
lp_100d_50k to their end (equal to the whole solve, timed beside the
p1 + p2 segments).  The tableau warm path: all of lp_afiro_100k from the
slack basis through ``solve_batched(warm=...)`` (statuses and iterations
of the cold whole solve), re-solved from its own optimum (0 pivots on all
but at most one in a thousand OPTIMAL members, which re-solve as the
plain engine re-solves them), and a perturbed 1,024-LP trajectory step
warm,
equal bit for bit to ``solve_batched_torch(device="cpu", warm=...)``.
The MIP fixtures' trees on the card (knapsack 280, assignment 5,
scheduling 42 proven): tableau dispatch (warm and cold) and stream and
revised dispatch with the CPU port's nodes, dispatches and LP iterations;
PDHG dispatch on knapsack and scheduling (``max_nodes`` 200) by proven
optimum.  Last, a realistic frontier: a seeded 5 x 100 multi-knapsack
(Chu & Beasley's recipe, the OR-Library mknapcb1 shape; canonically
105 x 100), best-first to 16,384 nodes, as tableau dispatch (frontier
1,024), stream (1,024 lanes), dispatch cold and revised dispatch: wall,
nodes/s, dispatches or segments, LP iterations a node, incumbent, bound,
gap, launches and the seconds spent building the kernel states.

The revised path (before the box LP): ``solve_batched(lp_100d_50k,
backend="revised")`` on all 50,000 LPs through the revised kernel, with
Dantzig and with partial pricing, each held against the oracle and against
the tableau run's statuses.  Warm starts: the first 20,000 members of
``lp_afiro_100k`` solved cold through the revised kernel (member 0 at the published optimum), re-solved
from its own ``warm_start()`` (every OPTIMAL member at 0 iterations), and
step 1 of a 10,000-member perturbed AFIRO trajectory solved warm from
step 0 against its cold solve (equal statuses, objectives within rel
2e-3, no more iterations).  The kernel is held against its plain version
on 2,048-LP slices of both batches for both rules (one launch of each
stage leaf by leaf, then the whole solve, every output and work count
equal) and on sc205_like's device-memory variant (plain version on the
first 128, max_iters 600); ``compaction=True`` on the slices through the
kernel equals the plain-backed schedule bit for bit and the whole solve in
statuses (objectives within rel 1e-3).  Last, the kernel is timed on all
50,000 LPs of lp_100d_50k beside its bound; the registers, spills and
stack of every instantiation are printed (``revised_ptxas``; any spill
or stack fails the run).

Restarted PDHG (after the revised path): ``solve_batched(lp_100d_50k,
backend="pdhg")`` on all 50,000 LPs through the whole-solve PDHG kernel
only (the first 64 against the oracle, statuses compared with the tableau
run); ``compaction=True`` on all 50,000 through the segment kernel only,
equal to the whole solve bit for bit, its 65 launches timed by CUDA events
and summed beside the bound; the first 20,000 members of
``lp_afiro_100k`` cold (member 0 at the published optimum) and re-solved from its own ``warm_start()`` (equal
statuses, objectives within rel 2e-3, at most a quarter of the cold mean
iterations).  Each kernel is held against its plain version in each of
its three variants, every output equal, and each line names the variant
that ran: registers (A in registers) on 2,048-LP slices of lp_100d_50k
(plain version on the first 512, ``max_iters`` 20,000; Malitsky-Pock on
the first 128 at 1,600) and lp_afiro_100k (both step rules; one warp an
LP), shared (A in shared memory) on sc205_like (plain on 128 at 4,000;
Malitsky-Pock on 32 at 800) and device (A in device memory) on 256 LPs of
lp_300d_2k (``max_iters`` 40,000, plain on 64 of them, the members the
kernel solved first and the rest from those at the cap, at least one
OPTIMAL; Malitsky-Pock on 16 at 800); one segment launch from a mid-solve
state leaf by leaf in each variant; the kernel-backed schedule equal to
the plain-backed one (plain on 512) and to the whole solve at
``max_iters`` 8,000.  The peak device memory of each main-path solve
stays within the chunk plan's bytes per LP
(``core.pdhg.pdhg_bytes_per_lp``).  The sparse engine runs
SparseLPBatch.from_dense of sc205_like on the card against the dense
kernel at ``max_iters`` SPARSE_CAP (equal statuses, objectives within rel
1e-3; its sums follow the dense kernel's order, so every output is
equal).  Then the whole-solve kernel is timed on all 50,000 LPs beside
its bound and a torch.bmm yardstick.  The three kernels' cycle counts by
phase (the -DSIMPLEX_TRACE, -DREVISED_TRACE and -DPDHG_TRACE builds) are
diagnostics that check no result: the ``--*-parent`` modes below run
them, the default run does not.

The telemetry plane (after PDHG): ``solve_batched(lp_100d_50k,
telemetry=True, tracer=SpanTracer())`` on all 50,000 LPs through the
counter-carrying instantiation of each segment kernel only: the tableau
schedule (``compaction=True``), the revised kernel with each rule and
PDHG's schedule.  Statuses, iterations, x and objectives equal the
telemetry-off solves of this run; phase1_iters + phase2_iters equals every
LP's iterations, every int lane is >= 0, the lanes the engine does not own
are 0, and the tracer holds one ``segment[...]`` span per segment launch
(32 for the tableau schedule); each ``SolveReport.summary()`` is printed.
One launch of each counter-carrying kernel on the 2,048-LP slice, from a
mid-solve state whose counters the kernel made non-zero, equals its plain
version leaf by leaf, counter lanes included; and each is timed against
its counter-free instantiation on all 50,000 (the launch alone, in turns
off, on, on, off; every other state leaf equal).

Serving (after the box LP, once the LP data is freed): falcon-mamba-7b at
its published config (64 layers, d_model 4096, d_inner 8192, bf16
parameters drawn on the card from a seeded generator), as shipped (the
card always scans with the CUDA kernel), serves 2 waves of 4 prompts of
1,024 tokens (two 512-token scan chunks, so the carry reaches the kernel's
h0) and 32 generated tokens through ``repro_torch.launch.serve.serve``;
the scan kernel must launch exactly 64 x 2 x 2 = 256 times and no other
kernel.  Tokens/s, time to first token, prefill and decode seconds, peak
device memory and the matmul policy (no TF32, bf16 products reduced in
float32) are printed.  The kernel is held against ``ssm_scan_plain`` on
the inputs the served run handed it in layer 0's and layer 63's second
chunk and at four odd shapes (``max_abs_err`` 0.0), prefill(511) + one
decode step is compared with prefill(512) (recorded, not asserted, in
bf16, and traced against a float32 twin of the model), and the kernel is
timed at (4, 512, 8192, 16) beside its bytes bound, its plain version and
a ``torch.add`` of the same bytes.

Hybrid serving (after falcon-mamba's, once that model is freed):
hymba-1.5b at its published config (32 layers, d_model 1600, 25 heads
over 5 KV heads of 64, SwiGLU d_ff 5504, vocab 32,001, sliding window
1,024, d_inner 3200, state 16, q_chunk 256, kv_chunk 512, bf16 parameters
drawn on the card from a seeded generator) serves 2 waves of 4 prompts of
2,048 tokens and 32 generated tokens through ``serve``: longer than the
window, so the window masks whole kv chunks in prefill and old keys in
decode, and four 512-token scan chunks a layer carry h0 to the kernel.
The scan kernel must launch exactly 32 x 4 x 2 = 256 times and no other
kernel; it is held against ``ssm_scan_plain`` on the inputs layer 0's
and layer 31's last chunk received (``max_abs_err`` 0.0) and timed at
(4, 512, 3200, 16) beside its bytes bound.  A float32 twin cut to 2
layers runs one 1,536-token prompt and 8 greedy decode steps on the card
and on the CPU (equal tokens, logits within ``TWIN_ATOL``), and on the
card its prefill(1,024) followed by 512 decode steps, which cross the
window, must end within ``TWIN_ATOL`` of its prefill(1,536).  Tokens/s,
time to first token, prefill and decode seconds a wave, decode ms a step,
peak device memory and the kernels' device time in one prefill and one
decode step are printed.

Dense serving (after hymba's, once that model is freed): qwen3-32b at
its published width cut to 16 of its 64 layers (d_model 5120, 64 heads
over 8 KV heads of 128, qk-norm, SwiGLU d_ff 25,600, vocab 151,936, rope
theta 1e6, bf16 parameters drawn on the card from a seeded generator;
the smoke's time budget cut it from all 64, 65.5 GB) serves 2
waves of 4 prompts of 2,048 tokens and 32 generated tokens through
``serve``; no custom kernel may launch (every launch counter stays 0).
Tokens/s, time to first token, prefill and decode seconds a wave, decode
ms a step, peak device memory and the kernels' device time in one
prefill and one decode step are printed.  A float32 twin at full width
cut to 2 layers (built on the CPU from the bf16 parameters, the served
model freed, then copied to the card) runs one 1,024-token prompt and 8
greedy decode steps on the card and on the CPU (equal tokens, logits
within ``TWIN_ATOL``), and on the card prefill(1,016) followed by 8
decode steps must end within ``TWIN_ATOL`` of prefill(1,024).

MoE serving (after the dense phase, once that model is freed):
llama4-scout-17b-a16e at its published width (d_model 5120, 40 heads
padded to 48 over 8 KV heads of 128, 16 experts of 8,192, top-1, one
shared expert, vocab 202,048, rope theta 5e5, q and kv chunks of 2,048,
bf16 from a seeded generator), cut to 12 of its 48 layers (57.2 GB; all
48 are 217 GB), with ``lp_capacity=True`` set by
``dataclasses.replace``, serves the same load through ``serve``.  Every
MoE layer call solves the router's LP with the whole-solve simplex
kernel: exactly 12 x (1 + 31) x 2 = 768 launches and no other custom
kernel.  The router's caps in layer 0's first prefill and layer 11's
last decode step equal the plain version's solve of the same demand on
the CPU bit for bit; the share of routed tokens kept is printed per wave
for prefill and decode; one decode-shaped ``moe_apply`` call passes with
host synchronization forbidden (``torch.cuda.set_sync_debug_mode
("error")``).  The serving metrics and profiles are printed as above,
with the simplex kernel's device time in a decode step.  A float32 twin
at full width cut to 1 layer and a 32,000-token vocabulary (the
embedding's first rows and the head's first columns) runs one
512-token prompt and 8 greedy steps on the card and on the CPU, with
``lp_capacity`` on and off: the routing (expert, slot and keep of every
token in every call) and the tokens equal, the logits within
``TWIN_ATOL``, the smallest top-1/top-2 probability gap and |cap - slot|
printed.  Decode against prefill is checked with ``lp_capacity`` off at
capacity factor 100 (capacity drops make routing depend on the batch, as
in the reference's test_decode_matches_prefill).

MLA serving (after scout's, once that model is freed): deepseek-v2-236b
at its published width (d_model 5120, 128 heads of MLA with a 512-wide
KV latent, q_lora 1,536, nope 128 + rope 64, v 128; 160 experts of
1,536, top-6, two shared experts, vocab 102,400, bf16 from a seeded
generator), cut to 6 of its 60 layers (49.8 GB; all 60 are 479 GB), with
``lp_capacity=True``, serves the same load through ``serve``: exactly
6 x (1 + 31) x 2 = 384 whole-solve launches at E = 160 and no other
custom kernel, the caps of layer 0's first prefill and layer 5's last
decode step bit-equal to the plain version on the CPU, one decode-shaped
``moe_apply`` with host synchronization forbidden, the router's share of
a decode step's kernels and wall printed.  Its float32 twin (1 layer, a
32,000-token vocabulary) runs on the card only (its runs against the CPU
are cut for the run's time limit): decode (MLA's absorbed form, against
the latent cache) against prefill (its materialized per-head K/V) within
``TWIN_ATOL`` is the MLA-specific check.

Encoder-decoder serving: whisper-small whole (12 encoder and 12 decoder
layers, d_model 768, 12 heads padded to 16, LayerNorm, GELU, a tied
head) serves 2 waves of 4 requests of 1,500 precomputed frames (the
conv frontend is a stub, as in the reference; the frames are drawn after
the prompts from serve's generator) with a 64-token prompt and 32
generated tokens; no port kernel may launch.  Its float32 twin is the
whole model, one 64-token prompt over 1,500 frames, card against CPU,
and decode from prefill(32) against prefill(64).

VLM serving: phi-3-vision-4.2b whole (32 layers, d_model 3072, 32 heads
of 96, SwiGLU 8,192, vocab 32,064) serves 2 waves of 4 requests of 256
precomputed patch embeddings (the CLIP frontend is a stub) before 1,792
text tokens, 32 generated (decode positions start at 2,048); no port
kernel may launch.  Its float32 twin is cut to 2 layers, 256 patches
before a 1,024-token prompt.  Each of the three prints what the other
serving phases print.

Training (after the serving phases, once their models and kept tensors
are freed):
falcon-mamba-7b at its full published width in bf16 (d_model 4096,
d_inner 8192, state 16, dt_rank 256, vocab 65,024), cut to 24 layers with
the reference CLI's own depth override, since the whole model with AdamW
(bf16 weights and gradients, a float32 accumulator and two float32
moments, 16 bytes a parameter: 116 GB) does not fit the card's 80 GB.
Parameters drawn on the card (seed 2018); 4 steps of
``repro_torch.launch.train.train`` on ``DataPipeline(seed=2018)``: batch 4
x 1,024 tokens, the config's 2 microbatches, ``remat="block"``, so each
layer scans two 512-token chunks a microbatch and the carry's cotangent
(g_hT != 0) reaches chunk 0.  The backward kernel must launch exactly
n_layers x chunks x microbatches x steps = 384 times and the forward
twice that (the recompute), and no other kernel; every loss and grad norm
is finite and some bf16 parameter changed.  The backward kernel is held
against ``ssm_scan_bwd_plain`` on the inputs layer 0's backward received
for chunk 0 in the first microbatch and at odd shapes (T = 1, T not a
multiple of the unroll, L not a multiple of the block; ``max_abs_err``
0.0), and timed at (2, 512, 8192, 16) beside its bytes bound
4(5BTL + 3BL), its plain version and a two-call yardstick that moves the
same bytes.  Step seconds, tokens/s and peak device memory are printed.

Training of every other family (after falcon-mamba's), each at its full
published width in bf16 from seed 2018 through
``repro_torch.launch.train.train``, 3 steps in 2 microbatches with the
config's optimizer at lr 1.0 (bf16 parameters with no float32 master
copy move only by more than half their spacing; step 0 is left out of
tokens/s): hymba-1.5b cut to 16 of 32 layers for the time budget (2 x
2,048 tokens: the 1,024 window masks keys), qwen3-32b cut to 4 of 64 layers, llama4-scout-17b-a16e cut to 1 of
48 with ``lp_capacity=True``, llama3-405b cut to 1 of 126 with its
config's Adafactor (4 x 1,024 each), whisper-small whole (4 x (1,500
frames + 448 tokens)) and phi-3-vision-4.2b whole (4 x (256 patches +
1,792 tokens); it must peak under 75 GB).  Each line gives the depth
against the published one, the memory reckoning (bf16 parameters and
gradients, float32 accumulators, the optimizer's state), losses, grad
norms, step seconds, tokens/s, peak memory and a microbatch's kernel time
(``kernel_profile``); every loss, grad norm and parameter is finite and
every bf16 parameter moved.  hymba: the scan's backward launches exactly
layers x chunks x microbatches x steps = 384 times and its forward twice
that, and one captured backward launch at (1, 512, 3200, 16) is
bit-equal to its plain version and timed.  scout: the router launches
once a MoE layer call, forward and recompute (12), the recompute's
demand, caps, experts, slots and keep mask equal the forward's, and the
caps equal the plain version's.  deepseek-v2-236b does not fit one card
for training at full width in one process (one layer is 3.97 B
parameters, 80 GB with AdamW; ``training_sharded`` trains it over a
mesh), so its reduced config (MLA, the LP router, remat per block)
trains 2 steps on the card and on the CPU, within ``TWIN_ATOL``.  Last,
``repro_torch.data.optimal_mixture`` on 4,096 utility rows over 8
sources launches the simplex kernel once; its statuses and weights equal
the CPU port's.

``python3 chip_smoke.py --simplex-parent SRC`` runs only the simplex
kernels' cycle counts by phase, phase-1 and phase-2 steps apart, on the
2,048-LP slices of lp_100d_50k (every rule, the whole solve and the
compaction schedule) and lp_afiro_100k, and then times them against the simplex_tile.cu at SRC
(another commit's, built beside this one) in turns (SRC, this, this, SRC),
Dantzig: the whole-solve kernel on all 50,000 LPs of lp_100d_50k and on the
2,048-LP slices of lp_afiro_100k and sc205_like (at a 600-step cap),
around the wrapper and around the launch alone, x, objective, status,
iterations, y, z and work equal at atol 0; the compaction schedule on all
50,000, its segment launches summed, once more with every segment launched
by both builds from one state and every state leaf compared; then
``solve_batched`` wall time with and without compaction.

``python3 chip_smoke.py --revised-parent SRC`` runs only the revised
kernel's cycle counts by phase on 2,048-LP slices of lp_100d_50k (both
rules) and lp_afiro_100k, and then times the kernel against the revised_tile.cu at SRC
(another commit's, built beside this one) in turns (SRC, this, this, SRC),
both rules: one whole-solve launch from the cold state over all 50,000 LPs
of lp_100d_50k and over the 2,048-LP slices of lp_afiro_100k and
sc205_like, with every leaf of the state and the steps taken equal, timed
around the wrapper and around the launch alone; then
``solve_batched(backend="revised")`` wall time on lp_100d_50k with every
result equal.

``python3 chip_smoke.py --pdhg-parent SRC`` runs only the PDHG kernel's
cycle counts by phase on the lp_100d_50k slice in the shared and the
registers variants (outputs equal), and then times the kernel against the pdhg_tile.cu at SRC (another
commit's, built beside this one) on the same inputs, in turns (SRC, this,
this, SRC): the whole-solve kernel on the lp_100d_50k slice and on all
50,000, and ``solve_batched(backend="pdhg")`` with and without
compaction; every pair of results equal.

The paper's workloads, multi-rank solving and the LP router (after the
compaction path): every ``configs/paper_lp.py`` workload is built with
``build_batch`` at its published batch size (the main path's lp_100d_50k,
its Table-4 phase-1 variant, lp_afiro_100k and lp_300d_2k's 256 LPs come
from it too, and must equal the batches this script built by hand before);
lp_5d_100k, lp_28d_100k and lp_sc50b_like_50k are solved through
``solve_batched`` on the card and held against the float64 oracle on their
first 64 LPs, and ``canonical_work`` of the two fixture workloads is
printed.  ``core/distributed.py`` in a world of one rank: ``solve_pjit``,
the one-shot ``solve_shard_map`` and ``solve_shard_map(segment_k)`` on all
50,000 LPs of lp_100d_50k equal the whole solve and ``compaction=True``
leaf by leaf (the ladder too), and revised and pdhg on the 2,048-LP slice
the same; a two-rank gloo world (a file store) spawned on the one card,
on the slice, every backend, whole and segmented, equals the world of
one bit for bit with every bucket a multiple of two.
``expert_capacity_lp`` at 16 and 160 experts (llama4-scout-17b-a16e's,
deepseek-v2-236b's) and 1 and 4,096 token groups runs on the card with
host synchronization forbidden (``torch.cuda.set_sync_debug_mode
("error")``) and equals its CPU run bit for bit.  Then
``examples/torch_reachability.py`` runs on the card as a subprocess and
must exit 0.  Each phase prints its seconds.

Training on a mesh (``training_sharded``, last): (a) deepseek-v2-236b at
its published width, 1 of 60 layers, bf16 from seed 2018, ``lp_capacity``,
``seq_shard`` and ``fsdp`` as shipped, over a 2 x 2 mesh of four
processes that share the card over gloo, every placement of the Sharder
acting (data parallel, FSDP over data, the heads, the shared experts'
``ff_expert`` and the vocabulary tensor parallel, 80 of the 160 expert
slabs a rank): the parameters a rank predicted from the rules and
AdamW's reckoning printed first; the loss and gradients of 2 x 1,024
tokens under ``remat="block"``; exactly 8 router launches (4 ranks x
forward and recompute), each rank's caps bit-equal to the plain version
on the CPU, the share of its tokens routed as one process's ``route``
routes them, its MoE output within 2^-7 of one process's ``_moe_local``
over all 160 experts, every gradient bit-equal on the ranks that hold
the same block of it (the mesh turns on the deterministic algorithms
that keep them so; this script does not), every gradient finite; then
one AdamW step where the card keeps 8 GB free beside the four ranks'
moments, every parameter moved and finite.  In the same world,
falcon-mamba-7b at full width, 1 of 64 layers, its 8,192 d_inner
channels cut to 4,096 a rank: the scans launched on each rank's channels
(exactly 4 forward and 2 backward a rank), one captured launch of each
bit-equal to its plain version and timed.  The peak a rank, the step's
wall and the exchanges' calls and host seconds printed.  (b) the
reduced llama4-scout (float32, ``lp_capacity``, top-2) through ``train
--mesh 2x2 --checkpoint-dir`` in four processes with torchrun's
environment, every run resuming from one step-0 checkpoint drawn on the
card, three worlds side by side: 4 steps on the card and on the CPU
within ``TWIN_ATOL``, every parameter
bit-equal on the ranks that hold the same block of it after them (the
heads, the shared experts and the vocabulary tensor parallel, AdamW's
moments under ZeRO-1); the card run's step-2
save, written from its writer thread, resumed in new processes for 2
more, bit-equal to the 4 straight; the checkpoint restored on a 1 x 4
mesh and on one rank equal to the saved whole arrays.  (c) whisper-small whole,
two ``make_compressed_train_step`` steps: every leaf's dequantization
error within half its scale (float32 rounding aside), the error-feedback
residual bit for bit, the losses finite.

The dry run (``dryrun``, before ``training_sharded``): (a) on the host, in
a process started with the run (``start_dryrun_host``, niced, one
thread), ``launch/dryrun.py``'s cells hymba-1.5b decode_32k,
falcon-mamba-7b prefill_32k and llama3-405b train_4k on rank 0 of the
abstract 16 x 16 mesh, and ``launch/dryrun_lp.py`` over the paper's
workloads, each record's numbers printed (llama3-405b's with its fits
verdict against 80 GB); (b) on the card, rank 0's share of
falcon-mamba-7b prefill_32k at 16 x 16 run for real (``build_cell(...,
device="cuda")``: 2 of 32 sequences of 32,768 tokens, d_inner 512 a
rank; the abstract mesh's collectives return zeros, so the rank's
compute and memory are real and its values are not the model's): the
scan launches equal to the dry run's charges, the matrix products'
flops from the profiler (``with_flops``; it counts no custom kernel,
so both sides leave the scan's charge out; profiled at 1 and 2 layers
of the same widths and taken to 64, since every layer runs the same
products) within 1% of the dry run's, the peak of ``torch.cuda.max_memory_allocated`` within 20% of
the reckoned arguments + temp, the wall beside the roofline's largest
term, and the scan kernel bit-equal to its plain version at the
shapes of the rank's first launch on seeded inputs (dA in (0, 1); the
launch's own inputs are trivial there), a kernel writing zeros or one a
time step late told apart from it;
(c) rank 0's block of lp_100d_50k at 16 x 16 (the first 196 LPs)
through the whole-solve simplex kernel: its mean pivots beside the
oracle sample's and its milliseconds beside the reckoned compute and
memory terms.

The plain versions of the long parity checks run first, in 4 worker
processes (``Behind``; their own CUDA contexts, the same functions on the
same device and inputs), while the kernels build: every such check hands
its plain version over before the main path, and once the workers are
done and gone, this process runs the rest of the script with the card to
itself, each check comparing where it always did.  So no time this
process takes on the card shares it with another process.  A plain time
taken on a worker was taken beside the other workers (CUDA contexts share
the card by time slices) and its row says so (``plain_on``); the plain
versions of the rows the kernel table reports run in this process, alone.

Every launch counter is zeroed just before each path of the run and read
just after; the kernel table gives each kernel's launches by path and
their sum.  Lines of JSON report each phase; the line before the last is the
kernel table, then the card's name and power limit, and the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero without that line; so does a run without a card.
"""
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

AFIRO_OPT = -464.7531428571429
SLICE = 2048
PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
RULES = ("dantzig", "devex", "steepest_edge")


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _wrappers():
    from repro_torch.kernels import (hyperbox_tile, pdhg_segment_tile,
                                     pdhg_tile, revised_segment_tile,
                                     segment_tile, simplex_tile, ssm_scan,
                                     ssm_scan_bwd)
    return {"simplex_tile": simplex_tile, "simplex_segment": segment_tile,
            "hyperbox": hyperbox_tile,
            "revised_segment": revised_segment_tile, "pdhg": pdhg_tile,
            "pdhg_segment": pdhg_segment_tile, "ssm_scan": ssm_scan,
            "ssm_scan_bwd": ssm_scan_bwd}


# the wrappers whose kernels have a counter-carrying instantiation, counted
# apart as "<name>_tel"
TEL_WRAPPERS = ("simplex_segment", "revised_segment", "pdhg_segment")


def zero_counts():
    for name, wrapper in _wrappers().items():
        wrapper.launches = 0
        if name in TEL_WRAPPERS:
            wrapper.tel_launches = 0
    _wrappers()["simplex_segment"].full_launches = 0


def counts() -> dict:
    """Launches since zero_counts() by wrapper, the counter-carrying ones
    apart ("<name>_tel") and the segment kernel's combined stage apart
    too ("simplex_segment_full", also inside "simplex_segment")."""
    got = {name: w.launches for name, w in _wrappers().items()}
    got.update({f"{name}_tel": _wrappers()[name].tel_launches
                for name in TEL_WRAPPERS})
    got["simplex_segment_full"] = _wrappers()["simplex_segment"].full_launches
    return got


def only(name) -> int:
    """The launches of kernel ``name`` since zero_counts(); fails unless it
    launched and no other kernel did."""
    got = counts()
    assert got[name] > 0, (name, "launched no kernel", got)
    assert all(v == 0 for k, v in got.items() if k != name), (name, got)
    return got[name]


# launches by kernel and by path of the run: each read from the counters
# zeroed just before that path (``path_launches``)
LAUNCHES = {}


def path_launches(kernel, path, n):
    """Record ``n`` launches of ``kernel`` on ``path``; it must launch."""
    assert n > 0, (kernel, path, "launched no kernel")
    LAUNCHES.setdefault(kernel, {})[path] = n


def launch_keys(kernel) -> dict:
    """The kernel table's launch keys: the sum over the paths and each
    path's own count."""
    return {"launches": sum(LAUNCHES[kernel].values()),
            "launches_by_path": LAUNCHES[kernel]}


def timed(fn):
    """(result, milliseconds) of fn() on the current stream."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# ---- plain versions on worker processes -----------------------------------
# The long plain-version computations of the parity checks run in worker
# processes, each with its own CUDA context, at the start of the run: a
# check is a generator, which ``start`` runs up to the hand-over of its
# plain version (``Behind``).  Once every plain version is in and the
# workers have gone (``wait_plain``), ``finish`` runs the rest of it: the
# kernel, timed with the card to this process alone, and the comparison.
# The same function runs on the same device with the same inputs as in
# this process; only the process differs.  CUDA contexts share the card
# by time slices, so a plain time taken on a worker was taken beside the
# other workers, and its row says so (``plain_on``); the checks whose
# plain times the kernel table reports run their plain version in this
# process (``here``), after the workers have gone.
PLAIN_WORKERS = 4
_POOL = []
_PENDING = []
_CLOSED = []
# by job function: jobs and the seconds they took on the workers
PLAIN = {}


def _plain_worker():
    import torch
    torch.set_num_threads(1)
    torch.zeros(1, device="cuda")


def plain_pool():
    """The worker processes, started at the first call."""
    assert not _CLOSED, "the workers have gone"
    if not _POOL:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _POOL.append(ProcessPoolExecutor(
            PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_plain_worker))
    return _POOL[0]


def stop_plain_pool():
    while _POOL:
        _POOL.pop().shutdown(wait=True, cancel_futures=True)


def wait_plain() -> float:
    """Wait for every job handed to the workers (a failed one raises
    here), then stop them: from here on the card is this process's alone.
    Returns the seconds waited."""
    t0 = time.perf_counter()
    for future in _PENDING:
        future.result()
    _PENDING.clear()
    stop_plain_pool()
    _CLOSED.append(True)
    return time.perf_counter() - t0


def _plain_job(fn, args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, t0, time.perf_counter()


class Behind:
    """``fn(*args)`` on a worker process or, with ``here``, in this
    process when ``result()`` asks for it.  ``where``: what shared the
    card while it ran."""

    def __init__(self, fn, *args, here=False):
        self.name, self.fn, self.args = fn.__name__, fn, args
        self.future = None
        self.where = "this process alone"
        if not here:
            self.future = plain_pool().submit(_plain_job, fn, args)
            _PENDING.append(self.future)
            self.where = f"a worker, one of {PLAIN_WORKERS} on the card"

    def result(self):
        if self.future is None:
            return self.fn(*self.args)
        out, start, end = self.future.result()
        row = PLAIN.setdefault(self.name, {"jobs": 0, "work_s": 0.0})
        row["jobs"] += 1
        row["work_s"] += end - start
        return out


def start(check):
    """Run a check (a generator) up to the hand-over of its plain version."""
    next(check)
    return check


def finish(check, value=None):
    """Run the rest of a started check; ``value`` is what its hand-over
    point receives.  Returns the check's result."""
    try:
        check.send(value)
    except StopIteration as stop:
        return stop.value
    raise AssertionError("a check handed over twice")


def host(*tensors):
    return [t.cpu().numpy() for t in tensors]


def on_card(arrays):
    """NumPy arrays (None stays None) as tensors on the card."""
    import torch
    return [None if a is None else torch.as_tensor(a, device="cuda")
            for a in arrays]


def plain_simplex(A, b, c, ub, kw):
    """Worker: the whole-solve kernel's plain version with work counts."""
    import torch
    from repro_torch.kernels.simplex_tile import (WORK_COUNTERS,
                                                  simplex_tile_plain)
    A, b, c, ub = on_card((A, b, c, ub))
    work = torch.zeros((A.shape[0], WORK_COUNTERS), dtype=torch.int32,
                       device="cuda")
    want, ms = timed(lambda: simplex_tile_plain(A, b, c, ub, work=work,
                                                **kw))
    return host(*want), work.cpu().numpy(), ms


def plain_schedule(A, b, c, ub, cls, args, kw, max_iters):
    """Worker: run_schedule on a plain backend (``timed_backend(cls)``):
    (result, per-LP work, segment ms summed, scheduled ms)."""
    import importlib
    module, name = cls.split(":")
    backend = getattr(importlib.import_module(module), name)
    pb = timed_backend(backend, revised_state_bytes
                       if name == "RevisedBackend" else None)(*args, **kw)
    want, work, _, ms = schedule(pb, *on_card((A, b, c, ub)),
                                 max_iters=max_iters)
    return want, work, sum(pb.segment_ms), ms


def plain_revised(A, b, c, ub, kw):
    """Worker: the revised whole solve's plain version with work counts."""
    import torch
    from repro_torch.core.revised import WORK_FIELDS, solve_revised
    A, b, c, ub = on_card((A, b, c, ub))
    work = torch.zeros((A.shape[0], len(WORK_FIELDS)), dtype=torch.int32,
                       device="cuda")
    want, ms = timed(lambda: solve_revised(A, b, c, ub, tol=1e-6,
                                           feas_tol=1e-5, work=work, **kw))
    return host(*want), work.cpu().numpy(), ms


def plain_pdhg(A, b, c, ub, kw):
    """Worker: the whole-solve PDHG kernel's plain version."""
    from repro_torch.kernels.pdhg_tile import pdhg_tile_plain
    want, ms = timed(lambda: pdhg_tile_plain(*on_card((A, b, c, ub)), **kw))
    return [None if t is None else t.cpu().numpy() for t in want], ms


def plain_pdhg_schedule(sub, m, n, kw):
    """Worker: the PDHG schedule on the plain backend."""
    import torch
    from repro_torch.core.pdhg import PdhgBackend, schedule_pdhg
    pb = timed_pdhg_backend(PdhgBackend)(m, n)
    want, ms = timed(lambda: schedule_pdhg(pb, sub, torch.device("cuda"),
                                           stats_out=None, **kw))
    return want, sum(pb.segment_ms), ms


@contextlib.contextmanager
def phase(name):
    """Print the seconds a phase of the run took."""
    t0 = time.perf_counter()
    yield
    emit({"phase": name, "seconds": time.perf_counter() - t0})


@contextlib.contextmanager
def kernel_library(module, lib, threads=None):
    """The wrappers of repro_torch.kernels.<module> launch through ``lib``
    (a build of its source, or a stand-in for one), with ``threads(m, n)``
    threads a block where given."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    saved = mod._lib, mod.block_threads
    mod._lib = lambda: lib
    if threads is not None:
        mod.block_threads = threads
    try:
        yield
    finally:
        mod._lib, mod.block_threads = saved


class _TimedLaunches:
    """A kernel build whose launch functions ``names`` are timed alone: a
    pair of CUDA events around each C call, in ``events``."""

    def __init__(self, lib, names):
        self.lib, self.names, self.events = lib, names, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in self.names:
            return fn

        def timed_call(*args):
            import torch
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            rc = fn(*args)
            pair[1].record()
            self.events.append(pair)
            return rc
        return timed_call


def check_oracle(name, res, ref):
    """The reference's tolerance against the float64 oracle."""
    import numpy as np
    agree = float((res.status[:len(ref.status)] == ref.status).mean())
    ok = (ref.status == 0) & (res.status[:len(ref.status)] == 0)
    rel = float(np.max(np.abs(res.objective[:len(ref.status)][ok]
                              - ref.objective[ok])
                       / np.abs(ref.objective[ok])))
    assert agree >= 0.95, (name, agree)
    assert rel < 2e-3, (name, rel)
    return {"oracle_lps": len(ref.status), "oracle_status_agree": agree,
            "oracle_max_rel_obj": rel}


def solve_main(name, batch, oracle_batch):
    """Drive solve_batched once; hold the result against the oracle."""
    import numpy as np
    from repro_torch.core import solve_batched, solve_batched_reference
    from repro_torch.kernels import simplex_tile

    zero_counts()
    t0 = time.perf_counter()
    res = solve_batched(batch)
    wall = time.perf_counter() - t0
    launches = simplex_tile.launches
    assert launches > 0, f"{name}: the main path launched no kernel"
    assert only("simplex_tile") == launches
    B = res.status.shape[0]
    assert res.x.shape == (B, batch.n) and res.objective.shape == (B,)
    opt = res.status == 0
    assert np.isfinite(res.x[opt]).all() and np.isfinite(res.objective[opt]).all()
    info = {"batch": name, "lps": B, "wall_s": wall, "lps_per_s": B / wall,
            "launches": launches,
            "status_counts": np.bincount(res.status.astype(int),
                                         minlength=4).tolist(),
            "mean_iterations": float(res.iterations.mean())}
    info.update(check_oracle(name, res, solve_batched_reference(oracle_batch)))
    emit(info)
    return res, launches, wall


def compare(name, lp, rule, n_lp=SLICE, n_plain=SLICE, max_iters=None,
            here=False):
    """The kernel on the first n_lp LPs of a canonical batch, against the
    plain version on the first n_plain of them (the same inputs, on a
    worker): statuses, iterations and work counts equal, x, objective, y
    and z within 1e-5 relative (NaN where NaN).  A check (``start``, ``finish``)."""
    import numpy as np
    import torch
    from repro_torch.core.lp import LPBatch, default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.simplex_tile import WORK_COUNTERS, simplex_tile
    sub = LPBatch(A=lp.A[:n_lp], b=lp.b[:n_lp], c=lp.c[:n_lp],
                  ub=None if lp.ub is None else lp.ub[:n_lp])
    A, b, c, ub = batch_tensors(sub, torch.device("cuda"))
    if max_iters is None:
        max_iters = default_max_iters(lp.m, lp.n)
    kw = dict(m=lp.m, n=lp.n, max_iters=max_iters, pricing=rule)
    k = n_plain
    plain = Behind(plain_simplex, *host(A[:k], b[:k], c[:k], ub[:k]), kw,
                   here=here)
    yield
    work = torch.zeros((n_lp, WORK_COUNTERS), dtype=torch.int32,
                       device="cuda")
    got, ms = timed(lambda: simplex_tile(A, b, c, ub, work=work, **kw))
    work = work.cpu().numpy()
    got = [t[:k].cpu().numpy() for t in got]
    want, work_plain, plain_ms = plain.result()
    st_eq = bool(np.array_equal(got[2], want[2]))
    it_diff = int((got[3] != want[3]).sum())
    work_diff = int((work[:k] != work_plain).any(axis=1).sum())
    opt = (got[2] == 0) & (want[2] == 0)
    rel = float(np.max(np.abs(got[1][opt] - want[1][opt])
                       / np.abs(want[1][opt]), initial=0.0))
    err = max(float(np.max(np.abs(g - w), initial=0.0,
                           where=np.isfinite(g) & np.isfinite(w)))
              for g, w in zip(got, want) if g.dtype.kind == "f")
    assert st_eq, (name, rule, "statuses differ")
    assert it_diff == 0, (name, rule, it_diff)
    assert work_diff == 0, (name, rule, "work counts differ", work_diff)
    assert rel <= 1e-5, (name, rule, rel)
    for i, what in ((0, "x"), (1, "objective"), (4, "y"), (5, "z")):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=0,
                                   equal_nan=True,
                                   err_msg=f"{name} {rule} {what}")
    out = {"compare": name, "pricing": rule, "lps": n_lp, "plain_lps": k,
           "max_iters": max_iters,
           "variant": simplex_variant(lp.m, lp.n, rule),
           "status_counts": np.bincount(got[2].astype(int),
                                        minlength=4).tolist(),
           "status_equal": st_eq, "iteration_diffs": it_diff,
           "work_diffs": work_diff, "max_rel_obj": rel, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "plain_on": plain.where}
    out.update(bound(lp.m, lp.n, n_lp, work))
    emit(out)
    return out


def simplex_variant(m, n, rule="dantzig", stage="whole"):
    """The simplex kernels' variant for ``stage`` (whole, p1, p2):
    ``shared`` (the live columns in shared memory) or ``device``."""
    from repro_torch.kernels.simplex_tile import tableau_in_smem
    return "shared" if tableau_in_smem(m, n, rule, stage=stage) else "device"


def bound(m, n, B, work, segment=False):
    """Least time for the work this run's data needs, from the kernel's
    per-LP counts (phase-1 pivots, phase-2 pivots, bound flips): the larger
    of the operations time and the bytes time.

    Operations, at the f32 rate outside the tensor cores: a phase-1 pivot
    divides the pivot row of the (m+2)-row tableau and updates its other
    m+1 rows (2 flops an entry) over the columns the function needs: the
    n+m live columns and the rhs in the whole solve, whose outputs never
    read the m artificial columns, and all n+2m+1 in a p1 segment
    (``segment``), whose state holds them; a phase-2 pivot does the same
    on the (m+1) x (n+m+1) view; a flip updates one rhs entry per row.
    Pricing and the ratio test are left out, so this is a floor.  Bytes,
    at the memory rate: A, b, c and ub read once; x, y, z, the objective,
    status and iterations written once."""
    p1, p2, flips = (int(v) for v in work.sum(axis=0))
    C1 = n + 2 * m + 1 if segment else n + m + 1
    C2 = n + m + 1
    flops = (p1 * (2 * (m + 1) * C1 + C1) + p2 * (2 * m * C2 + C2)
             + flips * 2 * (m + 1))
    nbytes = B * 4 * ((m * n + m + 2 * n) + (2 * n + m + 3))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"phase1_pivots": p1, "phase2_pivots": p2, "flips": flips,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def kernel_at_full_batch(name, lp):
    """The wrapper once over a whole canonical batch (tableau build and
    kernel), timed on the card; not a main-path launch."""
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.simplex_tile import WORK_COUNTERS, simplex_tile
    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    work = torch.zeros((lp.batch, WORK_COUNTERS), dtype=torch.int32,
                       device="cuda")
    out, ms = timed(lambda: simplex_tile(
        A, b, c, ub, m=lp.m, n=lp.n, max_iters=default_max_iters(lp.m, lp.n),
        work=work))
    iters = out[3].to(torch.int64)
    idle = iters - work.to(torch.int64).sum(dim=1)
    assert bool(((idle >= 0) & (idle <= 2)).all()), (name, "work counts")
    info = {"kernel_full_batch": name, "lps": lp.batch, "ms": ms,
            "iterations_sum": int(iters.sum())}
    info.update(bound(lp.m, lp.n, lp.batch, work.cpu().numpy()))
    emit(info)
    del A, b, c, ub, out, work
    torch.cuda.empty_cache()
    return info


def state_bytes(m, n, rule, stage):
    """Bytes one LP's segment state moves per launch when its block loads
    it: the stage's tableau, basis, weights (weighted rules), flips,
    phase, status, iterations and work counters read and written; bounds
    and threshold read; the step count written."""
    rows, cols = (m + 2, n + 2 * m + 1) if stage == "p1" else (m + 1,
                                                                n + m + 1)
    rw = 4 * (rows * cols + m + 3 + 3) + n
    if rule != "dantzig":
        rw += 4 * (n + m)
    return 2 * rw + 4 * n + 4 + 4


IDLE_BLOCK_BYTES = 16   # phase, status, iterations read; step count written


def timed_backend(cls, bytes_fn=None):
    """``cls`` (a scheduler backend) with each segment launch and each
    gather timed by CUDA events, and the state bytes each launch moves
    summed (``bytes_fn``, by default the tableau's ``state_bytes``): the
    LPs with steps to take load and store their state, the others read
    three words and write one."""
    bytes_fn = state_bytes if bytes_fn is None else bytes_fn
    from repro_torch.core.compaction import segment_pending

    class Timed(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.segment_ms, self.gather_ms, self.launch_bytes = [], [], []

        @property
        def moved(self):
            return sum(self.launch_bytes)

        def segment(self, state, steps, stage, max_iters):
            bucket = state.status.shape[0]
            loaded = int(segment_pending(state, stage, max_iters).sum())
            out, ms = timed(lambda: super(Timed, self).segment(
                state, steps, stage, max_iters))
            self.segment_ms.append(ms)
            self.launch_bytes.append(
                loaded * bytes_fn(self.m, self.n, self.rule, stage)
                + (bucket - loaded) * IDLE_BLOCK_BYTES)
            return out

        def take(self, state, idx):
            out, ms = timed(lambda: super(Timed, self).take(state, idx))
            self.gather_ms.append(ms)
            return out
    return Timed


def schedule(backend, A, b, c, ub, *, max_iters):
    """Drive ``backend`` through run_schedule on device tensors; returns
    (result, the per-LP work counts, stats, total ms)."""
    import numpy as np
    from repro_torch.core.compaction import run_schedule
    stats = []

    def run():
        state = backend.init(A, b, c, ub)
        work = np.zeros(tuple(state.work.shape), np.int64)
        return run_schedule(backend, state, max_iters=max_iters,
                            stats_out=stats, work_out=work), work
    (res, work), ms = timed(run)
    return res, work, stats, ms


def ladder(stats):
    return [[s.stage, s.bucket, s.steps, s.survivors] for s in stats]


def same_result(a, b, fields=("status", "iterations", "x", "objective")):
    import numpy as np
    return all(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)
               for f in fields)


def compaction_main(lp100, res_whole, wall_whole, full_batch):
    """The compaction path: solve_batched(compaction=True) on every LP of
    lp_100d_50k, through the segment kernel only; bit-equal to the
    whole-solve run on the same batch."""
    import numpy as np
    import torch
    from repro_torch.core import LPBatch, solve_batched, solve_batched_reference
    stats = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = solve_batched(lp100, compaction=True, stats_out=stats)
    wall = time.perf_counter() - t0
    got = counts()
    only("simplex_segment")
    peak = torch.cuda.max_memory_allocated()
    assert same_result(res, res_whole), "compaction != whole solve"
    head = LPBatch(A=lp100.A[:64], b=lp100.b[:64], c=lp100.c[:64])
    info = {"compaction_main": "lp_100d_50k", "lps": lp100.batch,
            "wall_s": wall, "lps_per_s": lp100.batch / wall,
            "launches": got["simplex_segment"], "segments": len(stats),
            "bitwise_equal_whole_solve": True,
            "ladder_stage_bucket_steps_survivors": ladder(stats),
            "peak_device_bytes": peak,
            "device_total_bytes":
                torch.cuda.get_device_properties(0).total_memory,
            "state_bytes_per_launch_if_all_load": [
                s.bucket * state_bytes(lp100.m, lp100.n, "dantzig", s.stage)
                for s in stats],
            "whole_solve_wall_s": wall_whole,
            "bound_ms_same_pivots": full_batch["bound_ms"]}
    info.update(check_oracle("lp_100d_50k compaction", res,
                             solve_batched_reference(head)))
    emit(info)
    return got["simplex_segment"], res, stats


def binding_budget(lp100, max_iters):
    """compaction=True against compaction=False where max_iters binds."""
    import numpy as np
    from repro_torch.core import LPBatch, solve_batched
    sub = LPBatch(A=lp100.A[:SLICE], b=lp100.b[:SLICE], c=lp100.c[:SLICE])
    seg = solve_batched(sub, compaction=True, max_iters=max_iters)
    whole = solve_batched(sub, max_iters=max_iters)
    assert same_result(seg, whole, ("status", "iterations", "x", "objective",
                                    "y", "z")), "binding budget differs"
    limited = int((whole.status == 3).sum())
    assert limited > 0, "max_iters did not bind"
    emit({"binding_budget": "lp_100d_50k", "lps": SLICE,
          "max_iters": max_iters, "iteration_limit_lps": limited,
          "status_counts": np.bincount(whole.status.astype(int),
                                       minlength=4).tolist(),
          "equal": True})


def segment_at_full_batch(lp, full_batch):
    """The scheduled solve through KernelBackend on a whole canonical
    batch, every launch and gather timed on the card; not a main-path run.
    Beside it the whole-solve wrapper's time on the same batch."""
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.ops import KernelBackend
    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    kb = timed_backend(KernelBackend)(lp.m, lp.n, 1e-6, 1e-5)
    _, work, stats, ms = schedule(kb, A, b, c, ub,
                                  max_iters=default_max_iters(lp.m, lp.n))
    info = {"segment_full_batch": "lp_100d_50k", "lps": lp.batch,
            "segments": len(stats), "gathers": len(kb.gather_ms),
            "segment_ms": sum(kb.segment_ms),
            "p1_segment_ms": sum(t for t, s in zip(kb.segment_ms, stats)
                                 if s.stage == "p1"),
            "gather_ms": sum(kb.gather_ms), "scheduled_ms": ms,
            "whole_solve_ms": full_batch["ms"],
            "state_bytes_moved": kb.moved,
            "state_bytes_per_launch": kb.launch_bytes,
            "state_roundtrip_ms": kb.moved / PEAK_BYTES * 1e3}
    info.update(bound(lp.m, lp.n, lp.batch, work, segment=True))
    emit(info)
    del A, b, c, ub
    torch.cuda.empty_cache()
    return info


def _clone(state):
    """A copy of a solver state (any of the three engines'), counter lanes
    included."""
    import torch
    from repro_torch.core.compaction import map_state
    return map_state(torch.clone, state)


def _first(state, k):
    """The state of its first k LPs."""
    from repro_torch.core.compaction import map_state
    return map_state(lambda leaf: leaf[:k].contiguous(), state)


def _pick(state, idx):
    """The state of the LPs at the indices ``idx``."""
    from repro_torch.core.compaction import map_state
    return map_state(lambda leaf: leaf[idx].contiguous(), state)


def leaf_pairs(got, want):
    """(name, got, want) of every tensor leaf of two solver states, the
    counter lanes of their ``tel`` leaves included; both states carry the
    same leaves."""
    def leaves(state):
        out = {}
        for name, v in zip(state._fields, state):
            if isinstance(v, tuple):
                out.update({f"{name}.{lane}": t
                            for lane, t in zip(v._fields, v)})
            elif v is not None:
                out[name] = v
        return out
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys(), (sorted(g), sorted(w))
    return [(name, g[name], w[name]) for name in g]


def compare_segment_launches(name, backend, state, k, steps, max_iters):
    """One launch of each stage: the kernel on every LP, the plain version
    on the first k, every leaf equal (NaN where NaN)."""
    import torch
    from repro_torch.core.compaction import segment_pending
    from repro_torch.kernels.simplex_tile import (segment_tile,
                                                  segment_tile_plain)
    kw = dict(m=backend.m, n=backend.n, max_iters=max_iters,
              pricing=backend.rule)
    out = {}
    for stage in ("p1", "p2"):
        if stage == "p2":   # finish stage p1 with the kernel first
            while bool(segment_pending(state, "p1", max_iters).any()):
                state, _ = segment_tile(state, steps, stage="p1", **kw)
            state = backend.compact_columns(state)
        got, it = segment_tile(_clone(state), steps, stage=stage, **kw)
        want, want_it = segment_tile_plain(_first(state, k), steps,
                                           stage=stage, **kw)
        torch.cuda.synchronize()
        assert torch.equal(it[:k], want_it), (name, stage, "steps differ")
        for leaf, g, w in leaf_pairs(got, want):
            torch.testing.assert_close(g[:k], w, rtol=0, atol=0,
                                       equal_nan=True,
                                       msg=f"{name} {stage} {leaf}")
        out[stage] = {"steps_max": int(it.max()),
                      "running_after": int((got.status == -1).sum())}
        state = got
    return out


def compare_schedule(name, lp, rule, n_lp=SLICE, n_plain=SLICE,
                     max_iters=None, here=False):
    """The segment kernel against its plain version: one launch of each
    stage leaf by leaf, then the whole scheduled solve through KernelBackend
    (all n_lp LPs) against TorchBackend (the first n_plain, on a worker):
    statuses, iterations and work equal; x, objective, y, z within rel
    1e-5.  A check (``start``, ``finish``)."""
    import numpy as np
    import torch
    from repro_torch.core.lp import LPBatch, default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.ops import KernelBackend
    sub = LPBatch(A=lp.A[:n_lp], b=lp.b[:n_lp], c=lp.c[:n_lp],
                  ub=None if lp.ub is None else lp.ub[:n_lp])
    A, b, c, ub = batch_tensors(sub, torch.device("cuda"))
    if max_iters is None:
        max_iters = default_max_iters(lp.m, lp.n)
    k = n_plain
    args = (lp.m, lp.n, 1e-6, 1e-5)
    plain = Behind(plain_schedule, *host(A[:k], b[:k], c[:k], ub[:k]),
                   "repro_torch.core.compaction:TorchBackend", args,
                   {"pricing": rule}, max_iters, here=here)
    yield
    kb = timed_backend(KernelBackend)(*args, pricing=rule)
    launches = compare_segment_launches(name, kb, kb.init(A, b, c, ub), k,
                                        32, max_iters)
    kb = timed_backend(KernelBackend)(*args, pricing=rule)
    got, work, stats, sched_ms = schedule(kb, A, b, c, ub,
                                          max_iters=max_iters)
    want, work_plain, plain_ms, plain_sched_ms = plain.result()
    take = lambda a: np.asarray(a)[:k]  # noqa: E731
    np.testing.assert_array_equal(take(got.status), want.status)
    np.testing.assert_array_equal(take(got.iterations), want.iterations)
    np.testing.assert_array_equal(work[:k], work_plain)
    err = 0.0
    for f in ("x", "objective", "y", "z"):
        g, w = take(getattr(got, f)), getattr(want, f)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, equal_nan=True,
                                   err_msg=f"{name} {rule} {f}")
        fin = np.isfinite(g) & np.isfinite(w)
        err = max(err, float(np.max(np.abs(g - w), initial=0.0, where=fin)))
    moved_ms = kb.moved / PEAK_BYTES * 1e3
    out = {"compare_segment": name, "pricing": rule, "lps": n_lp,
           "plain_lps": k, "max_iters": max_iters,
           "p1_variant": simplex_variant(lp.m, lp.n, rule, "p1"),
           "p2_variant": simplex_variant(lp.m, lp.n, rule, "p2"),
           "one_launch": launches, "status_counts": np.bincount(
               np.asarray(got.status).astype(int), minlength=4).tolist(),
           "segments": len(stats), "gathers": len(kb.gather_ms),
           "ladder_stage_bucket_steps_survivors": ladder(stats),
           "max_abs_err": err, "ms": sum(kb.segment_ms),
           "gather_ms": sum(kb.gather_ms), "scheduled_ms": sched_ms,
           "plain_ms": plain_ms, "plain_scheduled_ms":
               plain_sched_ms, "plain_on": plain.where,
           "state_bytes_moved": kb.moved,
           "state_roundtrip_ms": moved_ms}
    out.update(bound(lp.m, lp.n, n_lp, work, segment=True))
    emit(out)
    return out


# ---- branch-and-bound: the combined stage, tableau warm starts, trees ----

# The device the branch-and-bound phase runs on.
CARD = "cuda"
# The realistic frontier's node budget (lower it first if the smoke
# outgrows its time limit) and width.
FRONTIER_NODES = 16_384
FRONTIER_WIDTH = 1024
# LPs of the warm trajectory step held against the plain engine on the CPU
WARM_SLICE = 1024
# The members of lp_afiro_100k whose re-solve from their own optimum
# pivots, and their pivots on the port: the reference re-solves these
# members with pivots too, 5426 once more in its row-sum order
# (tests/test_torch_warm.py, AFIRO_RESOLVE)
AFIRO_RESOLVE = {5426: 25, 13721: 7}


def bound_full(m, n, B, work):
    """``bound`` for the combined stage: every pivot, in either phase,
    updates the full (m+2) x (n+2m+1) state (phase-2 pivots included:
    the state keeps the artificial columns and the phase-1 row)."""
    w = work.copy()
    w[:, 0] = w[:, 0] + w[:, 1]
    w[:, 1] = 0
    out = bound(m, n, B, w, segment=True)
    out.update(phase1_pivots=int(work[:, 0].sum()),
               phase2_pivots=int(work[:, 1].sum()))
    return out


def slack_carrier(B, m, n):
    """A WarmStart of the slack basis for B LPs: injecting it rebuilds the
    cold tableau, so a solve through the warm path starts cold."""
    import numpy as np
    from repro_torch.core.lp import WarmStart
    return WarmStart(m=m, n=n,
                     basis=np.tile(np.arange(n, n + m, dtype=np.int32),
                                   (B, 1)),
                     at_upper=np.zeros((B, n), bool))


def compare_combined(name, lp, rule, n_lp=SLICE, n_plain=SLICE, steps=8,
                     parent_steps=None):
    """One launch of the combined stage (``segment_tile(stage="full")``)
    against its plain version, every state leaf at atol 0, from a
    mid-solve full-layout state that holds lanes in phase 1, lanes in
    phase 2 and warm-injected lanes, each kind among the ``n_plain``
    lanes compared: the odd lanes are seeded from their
    LP's own basis after ``parent_steps`` combined steps (the end of the
    solve when None), with b scaled by 0.8 on every fourth LP (the
    injection repairs them: phase 1) and c reweighted on every fourth
    other (it skips to phase 2, which pivots); then combined steps in
    eights until both phases have running lanes."""
    import numpy as np
    import torch
    from repro_torch.core.lp import LPBatch, WarmStart, default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.ops import KernelBackend
    from repro_torch.kernels.simplex_tile import (segment_tile,
                                                  segment_tile_plain)
    sub = LPBatch(A=lp.A[:n_lp], b=lp.b[:n_lp], c=lp.c[:n_lp],
                  ub=None if lp.ub is None else lp.ub[:n_lp])
    m, n = lp.m, lp.n
    mi = default_max_iters(m, n)
    A, b, c, ub = batch_tensors(sub, torch.device(CARD))
    kb = KernelBackend(m, n, 1e-6, 1e-5, pricing=rule)
    ps = mi if parent_steps is None else parent_steps
    parent, _ = kb.run_combined(kb.init(A, b, c, ub), ps, mi)
    odd = np.arange(n_lp) % 2 == 1
    slack = slack_carrier(n_lp, m, n)
    warm = WarmStart(m=m, n=n, basis=np.where(
        odd[:, None], parent.basis.cpu().numpy(), slack.basis),
        at_upper=odd[:, None] & parent.flip.cpu().numpy())
    del parent
    lane = torch.arange(n_lp, device=CARD)[:, None] % 4
    scale_c = torch.linspace(0.5, 1.5, n, device=CARD)[None, :]
    state = kb.init(A, torch.where(lane == 1, 0.8 * b, b), torch.where(
        lane == 3, c * scale_c, c), ub, warm=warm)
    advanced = 0
    while True:
        running = (state.status == -1).cpu().numpy()
        p1 = np.flatnonzero(running & (state.phase == 1).cpu().numpy())
        p2 = np.flatnonzero(running & (state.phase == 2).cpu().numpy())
        if len(p1) and len(p2):
            break
        assert advanced < mi, (name, rule, len(p1), len(p2))
        state, _ = kb.run_combined(state, 8, mi)
        advanced += 8
    # the compared lanes: up to a quarter each of the running phase-2 and
    # phase-1 lanes, then the first lanes, so that both phases and warm
    # lanes are among them whatever their place in the batch
    k = min(n_plain, n_lp)
    keep = np.zeros(n_lp, bool)
    keep[p2[:max(1, k // 4)]] = True
    keep[p1[:max(1, k // 4)]] = True
    keep[np.flatnonzero(~keep)[:k - int(keep.sum())]] = True
    idx = np.flatnonzero(keep)
    lanes = {"phase1_running": int(np.isin(p1, idx).sum()),
             "phase2_running": int(np.isin(p2, idx).sum()),
             "warm_lanes": int(odd[idx].sum()), "advanced_steps": advanced}
    assert all(lanes[f] for f in ("phase1_running", "phase2_running",
                                  "warm_lanes")), (name, rule, lanes)
    kw = dict(stage="full", m=m, n=n, max_iters=mi, pricing=rule)
    before = state.work.clone()
    (got, it), ms = timed(lambda: segment_tile(_clone(state), steps, **kw))
    sel = torch.as_tensor(idx, device=CARD)
    (want, want_it), plain_ms = timed(lambda: segment_tile_plain(
        _pick(state, sel), steps, **kw))
    assert torch.equal(it[sel], want_it), (name, rule, "steps differ")
    err = 0.0
    for leaf, g, w in leaf_pairs(got, want):
        torch.testing.assert_close(g[sel], w, rtol=0, atol=0,
                                   equal_nan=True,
                                   msg=f"{name} {rule} full {leaf}")
        if g.dtype.is_floating_point:
            fin = torch.isfinite(g[sel]) & torch.isfinite(w)
            err = max(err, float((g[sel] - w).abs()[fin].max())
                      if bool(fin.any()) else 0.0)
    work = (got.work - before).cpu().numpy()
    out = {"compare_combined": name, "pricing": rule, "lps": n_lp,
           "plain_lps": len(idx), "steps": steps,
           "variant": simplex_variant(m, n, rule, "full"),
           "status_counts_after": np.bincount(
               (got.status.cpu().numpy() + 1).astype(int),
               minlength=5).tolist(),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **lanes}
    out.update(bound_full(m, n, n_lp, work))
    emit(out)
    del A, b, c, ub, state, got, want
    torch.cuda.empty_cache()
    return out


def combined_at_full_batch(lp, res_whole, seg_full):
    """One launch of the combined stage over all of a canonical batch from
    its cold state, each LP to its end: x, objective, status and
    iterations equal to the whole-solve main path's; timed on the card
    beside the p1 + p2 segments' launches (``segment_full_batch``) and the
    whole solve."""
    import numpy as np
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.ops import KernelBackend
    from repro_torch.kernels.simplex_tile import segment_tile
    m, n = lp.m, lp.n
    mi = default_max_iters(m, n)
    A, b, c, ub = batch_tensors(lp, torch.device(CARD))
    kb = KernelBackend(m, n, 1e-6, 1e-5)
    state = kb.init(A, b, c, ub)
    del A, b, c, ub
    (state, it), ms = timed(lambda: segment_tile(state, mi, stage="full",
                                                 m=m, n=n, max_iters=mi))
    x, obj, st, iters, y, z = kb.extract(state, "full")
    for f, got in (("status", st), ("iterations", iters), ("x", x),
                   ("objective", obj), ("y", y), ("z", z)):
        assert np.array_equal(got, getattr(res_whole, f), equal_nan=True), f
    info = {"combined_full_batch": "lp_100d_50k", "lps": lp.batch,
            "ms": ms, "segments_ms": seg_full["segment_ms"],
            "segments_p1_ms": seg_full["p1_segment_ms"],
            "whole_solve_wrapper_ms": seg_full["whole_solve_ms"],
            "equal_whole_solve": True, "steps_max": int(it.max())}
    info.update(bound_full(m, n, lp.batch, state.work.cpu().numpy()))
    emit(info)
    del state
    torch.cuda.empty_cache()
    return info


def tableau_warm_card(afiro, lp_af, res_af):
    """The tableau warm path on the card: all of lp_afiro_100k through it
    from the slack basis (equal to the cold whole solve), re-solved from
    its own optimum (0 pivots on all but at most one in a thousand OPTIMAL
    members; those re-solve as the plain engine re-solves them); step 1 of
    a
    perturbed AFIRO trajectory on a ``WARM_SLICE``-LP slice warm from step
    0, equal bit for bit to the plain engine's warm solve on the CPU."""
    import numpy as np
    from repro_torch.core import (LPBatch, canonicalize, solve_batched,
                                  solve_batched_torch)
    from repro_torch.io import perturbed_sequence
    from repro_torch.kernels.simplex_tile import segment_tile
    zero_counts()
    t0 = time.perf_counter()
    first = solve_batched(lp_af, device=CARD,
                          warm=slack_carrier(lp_af.batch, lp_af.m, lp_af.n))
    wall_first = time.perf_counter() - t0
    for f in ("status", "iterations"):
        assert np.array_equal(getattr(first, f), getattr(res_af, f)), f
    t1 = time.perf_counter()
    again = solve_batched(lp_af, device=CARD, warm=first.warm_start())
    wall_again = time.perf_counter() - t1
    launches = segment_tile.full_launches
    assert launches == 2 and counts()["simplex_tile"] == 0, counts()
    opt = first.status == 0
    assert np.array_equal(again.status, first.status)
    # In float32 the re-injected tableau of a few members is not the one
    # their last pivot left (a basic artificial maps to its row's slack;
    # the Gauss-Jordan rebuild rounds otherwise), and they pivot again:
    # exactly the members of AFIRO_RESOLVE, which the reference re-solves
    # with pivots too; the plain engine re-solves them as the card does
    moved = np.flatnonzero(opt & (again.iterations > 0))
    assert {int(i): int(again.iterations[i]) for i in moved} \
        == AFIRO_RESOLVE, ("warm re-solve pivoted", moved)
    idx = np.asarray(sorted(AFIRO_RESOLVE))
    sub = LPBatch(A=lp_af.A[idx], b=lp_af.b[idx], c=lp_af.c[idx],
                  ub=None if lp_af.ub is None else lp_af.ub[idx])
    plain = solve_batched_torch(sub, device="cpu",
                                warm=first.warm_start().take(idx))
    assert np.array_equal(plain.iterations, again.iterations[idx])
    assert np.array_equal(plain.status, again.status[idx])
    np.testing.assert_allclose(again.objective[moved],
                               first.objective[moved], rtol=1e-4)
    # a trajectory step that moves A, b and c by up to 20%, so that the
    # warm solves pivot; the plain engine on the CPU takes the slice
    seq = perturbed_sequence(afiro, WARM_SLICE, 2,
                             np.random.default_rng(2018), step_rel=0.2,
                             perturb=("A", "rhs", "c"))
    lp0, _ = canonicalize(seq[0])
    lp1, _ = canonicalize(seq[1])
    zero_counts()
    ws = solve_batched(lp0, device=CARD, warm=slack_carrier(
        WARM_SLICE, lp0.m, lp0.n)).warm_start()
    got = solve_batched(lp1, device=CARD, warm=ws)
    launches += segment_tile.full_launches
    t2 = time.perf_counter()
    want = solve_batched_torch(lp1, device="cpu", warm=ws)
    plain_s = time.perf_counter() - t2
    cold = solve_batched(lp1, device=CARD)
    for f in ("status", "iterations", "x", "objective", "y", "z"):
        assert np.array_equal(getattr(got, f), getattr(want, f),
                              equal_nan=True), f
    np.testing.assert_array_equal(got.warm.basis, want.warm.basis)
    warm_it = int(got.iterations.astype(np.int64).sum())
    cold_it = int(cold.iterations.astype(np.int64).sum())
    info = {"tableau_warm": "lp_afiro_100k", "lps": lp_af.batch,
            "slack_start_wall_s": wall_first, "resolve_wall_s": wall_again,
            "resolve_optimal_lps": int(opt.sum()),
            "resolve_zero_pivot_lps": int(opt.sum()) - len(moved),
            "resolve_pivoting_lps": moved.tolist(),
            "resolve_pivots": again.iterations[moved].tolist(),
            "resolve_pivots_equal_plain_engine": True,
            "trajectory_lps": WARM_SLICE,
            "trajectory_equal_plain_engine": True,
            "trajectory_warm_iterations": warm_it,
            "trajectory_cold_iterations": cold_it,
            "plain_engine_cpu_s": plain_s, "launches": launches}
    emit(info)
    return launches


BNB_KEYS = ("objective", "proven", "nodes", "dispatches", "lp_iterations",
            "max_depth")
MIP_OPT = {"knapsack": 280.0, "assignment": 5.0, "scheduling": 42.0}


def bnb_fixtures():
    """The MIP fixtures' trees on the card, every node relaxation through
    the CUDA kernels: tableau (dispatch warm and cold, stream), revised
    (dispatch) with the CPU port's nodes, dispatches and LP iterations;
    PDHG (dispatch, knapsack and scheduling, max_nodes 200) proving the
    optima.  Returns the combined stage's launches."""
    from repro_torch.core import branch_and_bound
    from repro_torch.io import MIP_FIXTURE_NAMES, fixture_path, read_mps
    full, rows = 0, []
    runs = [("tableau dispatch", dict(), "simplex_segment_full"),
            ("tableau dispatch cold", dict(warm_start=False),
             "simplex_tile"),
            ("tableau stream", dict(mode="stream"), "simplex_segment_full"),
            ("revised dispatch", dict(backend="revised"),
             "revised_segment")]
    for name in MIP_FIXTURE_NAMES:
        g = read_mps(fixture_path(name))
        for what, kw, kernel in runs:
            zero_counts()
            t0 = time.perf_counter()
            got = branch_and_bound(g, device=CARD, frontier=8, **kw)
            wall = time.perf_counter() - t0
            launched = counts()
            assert launched[kernel] > 0, (name, what, launched)
            full += launched["simplex_segment_full"]
            want = branch_and_bound(g, device="cpu", frontier=8, **kw)
            assert got.proven and got.objective == MIP_OPT[name], \
                (name, what, got.summary())
            g_k = {k: getattr(got, k) for k in BNB_KEYS}
            assert g_k == {k: getattr(want, k) for k in BNB_KEYS}, \
                (name, what, g_k)
            rows.append(dict(fixture=name, what=what, wall_s=wall,
                             launches={k: v for k, v in launched.items()
                                       if v}, **g_k))
    for name in ("knapsack", "scheduling"):
        zero_counts()
        t0 = time.perf_counter()
        got = branch_and_bound(read_mps(fixture_path(name)), device=CARD,
                               backend="pdhg", frontier=8, max_nodes=200)
        wall = time.perf_counter() - t0
        launched = counts()
        assert launched["pdhg"] > 0, launched
        assert got.proven and abs(got.objective - MIP_OPT[name]) < 1e-3
        rows.append(dict(fixture=name, what="pdhg dispatch", wall_s=wall,
                         launches={k: v for k, v in launched.items() if v},
                         **{k: getattr(got, k) for k in BNB_KEYS}))
    emit({"bnb_fixtures": rows, "equal_cpu_port": True})
    return full


@contextlib.contextmanager
def seconds_in(cls, name):
    """Host seconds spent in method ``name`` of ``cls`` while the context
    is open, the device synchronised around each call: a one-item list
    summing them."""
    import torch
    orig, own = getattr(cls, name), name in cls.__dict__
    spent = [0.0]
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)

    def wrapped(self, *args, **kw):
        sync()
        t0 = time.perf_counter()
        out = orig(self, *args, **kw)
        sync()
        spent[0] += time.perf_counter() - t0
        return out
    setattr(cls, name, wrapped)
    try:
        yield spent
    finally:
        if own:
            setattr(cls, name, orig)
        else:
            delattr(cls, name)


def mknap_chu_beasley(rng, m=5, n=100, tightness=0.25):
    """A multi-dimensional 0-1 knapsack by Chu & Beasley's recipe (J.
    Heuristics 4:63-86, 1998; the OR-Library mknapcb1 shape at m = 5, n =
    100): integer weights U[1, 1000], each capacity ``tightness`` times its
    row's weight sum, profit_j = sum_i w_ij / m + 500 U(0, 1); maximize.
    Test data, made here from the seed."""
    import numpy as np
    from repro_torch.core import GeneralLPBatch
    w = rng.integers(1, 1001, size=(m, n)).astype(np.float64)
    cap = tightness * w.sum(axis=1)
    profit = w.sum(axis=0) / m + 500.0 * rng.uniform(size=n)
    return GeneralLPBatch.from_arrays(
        A=w[None], sense=["L"] * m, rhs=cap[None], lb=np.zeros((1, n)),
        ub=np.ones((1, n)), c=profit[None], maximize=True,
        integer=np.ones(n, bool), name=f"mknap_cb_{m}x{n}")


def bnb_frontier():
    """A realistic frontier: a seeded 5 x 100 multi-knapsack (canonically
    105 x 100: the 100 bound rows), best-first, ``FRONTIER_NODES`` nodes,
    four ways: dispatch (frontier 1,024), stream (1,024 lanes), dispatch
    cold, revised dispatch.  Wall, nodes/s, dispatches or segments, LP
    iterations a node, incumbent, bound, gap and launches of each, and
    the seconds the tableau paths spend building (and warm-injecting)
    their kernel states (``KernelBackend.init``).
    Returns the combined stage's launches."""
    import numpy as np
    from repro_torch.core import branch_and_bound, canonicalize
    from repro_torch.kernels.ops import KernelBackend
    g = mknap_chu_beasley(np.random.default_rng(2018))
    lp0, _ = canonicalize(g, bound_rows=g.integer)
    full = 0
    runs = [("tableau dispatch", dict(frontier=FRONTIER_WIDTH)),
            ("tableau stream", dict(mode="stream", lanes=FRONTIER_WIDTH)),
            ("tableau dispatch cold", dict(frontier=FRONTIER_WIDTH,
                                           warm_start=False)),
            ("revised dispatch", dict(backend="revised",
                                      frontier=FRONTIER_WIDTH))]
    for what, kw in runs:
        stats = []
        if kw.get("mode") == "stream":
            kw = dict(kw, stats_out=stats)
        zero_counts()
        # the tableau paths' state setup (the warm injection on the card)
        with seconds_in(KernelBackend, "init") as setup:
            t0 = time.perf_counter()
            res = branch_and_bound(g, device=CARD, search="best",
                                   max_nodes=FRONTIER_NODES, **kw)
            wall = time.perf_counter() - t0
        launched = counts()
        full += launched["simplex_segment_full"]
        # best-first may end the budget without an incumbent: then the
        # objective is NaN and the gap infinite (printed as null)
        assert np.isfinite(res.bound) and res.nodes > 0
        if res.x is not None:
            assert res.bound >= res.objective - 1e-6 * abs(res.objective)
        found = res.x is not None
        emit({"bnb_frontier": "mknap_cb_5x100",
              "canonical": [lp0.m, lp0.n], "seed": 2018,
              "max_nodes": FRONTIER_NODES, "what": what, "wall_s": wall,
              "state_setup_s": setup[0],
              "nodes_per_s": res.nodes / wall, "nodes": res.nodes,
              "dispatches": res.dispatches,
              "segments": len(stats) if stats else None,
              "lp_iterations": res.lp_iterations,
              "lp_iterations_per_node": res.lp_iterations / res.nodes,
              "incumbent": res.objective if found else None,
              "bound": res.bound, "gap": res.gap if found else None,
              "proven": res.proven, "max_depth": res.max_depth,
              "launches": {k: v for k, v in launched.items() if v}})
    return full


# ---- the simplex kernels' builds: cycle counters, the parent's source -----

SIMPLEX_TRACE_PHASES = ("price", "ratio", "flip", "scale", "update",
                        "weights", "barrier", "replay")


def _simplex_module():
    import importlib
    return importlib.import_module("repro_torch.kernels.simplex_tile")


def _simplex_argtypes(lib):
    """``lib`` (a simplex_tile build) with its launchers' C signatures."""
    import ctypes
    lib.simplex_tile_launch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.simplex_tile_launch.restype = ctypes.c_int
    lib.simplex_segment_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.simplex_segment_launch.restype = ctypes.c_int
    return lib


class _ParentStages:
    """A simplex_tile build from before the combined stage, behind this
    tree's C interface: its segment launcher took a flag (1: p1, 0: p2)
    where this tree passes a stage code (1: p1, 2: p2, 3: full)."""

    STAGE_ARG = 14   # after the 11 state pointers and B, m, n

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def simplex_segment_launch(self, *args):
        args = list(args)
        args[self.STAGE_ARG] = {1: 1, 2: 0}[args[self.STAGE_ARG]]
        return self.lib.simplex_segment_launch(*args)


def _toolkit(tool):
    """Path of a CUDA toolkit binary beside nvcc (cuobjdump, cu++filt)."""
    from pathlib import Path
    from repro_torch.kernels import _build
    return str(Path(_build.nvcc()).with_name(tool))


def _entry_reports(lib):
    """{demangled kernel: (ptxas registers, stack, spill stores, spill
    loads, static shared bytes), SASS lines without addresses} of a
    built library, from its -Xptxas -v report and cuobjdump -sass."""
    import re
    log = lib.with_suffix(".log").read_text()
    rows, cur, frame = {}, None, None
    for line in log.splitlines():
        got = re.search(r"entry function '(\S+)'", line)
        if got:
            cur = got.group(1)
            continue
        got = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads", line)
        if got and cur:
            frame = tuple(int(v) for v in got.groups())
            continue
        got = re.search(r"Used (\d+) registers", line)
        if got and cur and frame:
            smem = re.search(r"(\d+) bytes smem", line)
            rows[cur] = (int(got.group(1)),) + frame + (
                int(smem.group(1)) if smem else 0,)
            cur = frame = None
    sass, cur = {}, None
    dump = subprocess.run([_toolkit("cuobjdump"), "-sass", str(lib)],
                          check=True, capture_output=True, text=True).stdout
    for line in dump.splitlines():
        got = re.match(r"\s*Function : (\S+)", line)
        if got:
            cur = got.group(1)
            sass[cur] = []
        elif cur:
            sass[cur].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    names = list(rows)
    plain = subprocess.run([_toolkit("cu++filt")], input="\n".join(names),
                           check=True, capture_output=True,
                           text=True).stdout.splitlines()
    return {d: (rows[k], sass.get(k)) for k, d in zip(names, plain)}


# Instantiations a source has that its parent may not (by demangled
# template head): the simplex segment kernel's full stage (kSegFull = 3).
NEW_STAGE_INSTANTIATIONS = {
    "simplex_tile": r"simplex_segment_kernel<.*, \(int\)3, \(bool\)0>$"}


def counter_free_vs_parent(name, parent_src):
    """This tree's build of library ``name`` against the parent's build of
    ``parent_src``: every kernel instantiation the parent has, with kTel
    (the last template argument of the segment kernels) false, must have
    the parent's ptxas registers, stack, spills and static shared memory
    and its SASS; the counter-carrying instantiations are counted and
    their registers and spills reported.  Matched by template name and
    arguments (the new segment kernels take the counter rows as trailing
    parameters).  Last, both sources are compiled afresh side by side, one
    nvcc each, for the build seconds the counter-carrying instantiations
    add."""
    import re
    from repro_torch.kernels import _build
    _build.load(f"{name}_parent", src=parent_src)
    new = _entry_reports(_build.library_path(name))
    old = _entry_reports(_build.library_path(f"{name}_parent",
                                             src=parent_src))
    head = lambda d: d.split(">(", 1)[0] + ">"  # noqa: E731
    parent = {head(d): v for d, v in old.items()}
    same, counters, added = 0, [], []
    for d, (ptx, sass) in new.items():
        if head(d) not in parent and re.search(
                NEW_STAGE_INSTANTIATIONS.get(name, "$^"), head(d)):
            # a stage the parent does not have (the simplex segment
            # kernel's full stage)
            added.append({"kernel": head(d), "registers": ptx[0],
                          "spill_bytes": ptx[2] + ptx[3]})
            continue
        tel = re.match(r"(.*), \(bool\)([01])>$", head(d))
        key = head(d) if head(d) in parent or tel is None else (
            tel.group(1) + ">")
        assert key in parent, (name, "no parent instantiation", d)
        if tel is not None and tel.group(2) == "1" and head(d) not in parent:
            counters.append({"kernel": key, "registers": ptx[0],
                             "parent_registers": parent[key][0][0],
                             "spill_bytes": ptx[2] + ptx[3],
                             "static_smem_bytes": ptx[4]})
            continue
        assert ptx == parent[key][0], (name, key, ptx, parent[key][0])
        assert sass == parent[key][1], (name, key, "SASS differs")
        same += 1
    assert same == len(parent), (name, same, len(parent))
    took = {}

    def fresh(which, src):
        # the flag only keys a fresh build beside the others
        got = _build.build((name,), ("-DBUILD_TIMING",), src)
        took[which] = got.get(name)

    builds = [threading.Thread(target=fresh, args=("new", None)),
              threading.Thread(target=fresh, args=("parent", parent_src))]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    emit({"counter_free_vs_parent": name, "instantiations": same,
          "ptxas_equal": True, "sass_equal": True,
          "counter_instantiations": counters, "new_instantiations": added,
          "nvcc_s": took})


def simplex_trace_build():
    """The simplex_tile build with the cycle counters (-DSIMPLEX_TRACE)."""
    from repro_torch.kernels import _build
    return _build.build(("simplex_tile",), ("-DSIMPLEX_TRACE",))


def simplex_trace(lp100, lp_af):
    """The simplex kernels' cycles by phase (thread 0 of each block,
    clock64; the -DSIMPLEX_TRACE build) on the first SLICE LPs: the whole
    solve on lp_100d_50k under every rule and on lp_afiro_100k, and the
    compaction schedule's segment launches on lp_100d_50k (Dantzig).  Full-
    tableau (phase-1) and compacted (phase-2) steps are booked apart; each
    row gives the shares, block cycles an LP-step of each kind and the
    steps, pivots and flips the counters cover."""
    import ctypes
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import KernelBackend
    from repro_torch.kernels.simplex_tile import WORK_COUNTERS, simplex_tile
    lib = _simplex_argtypes(_build.load("simplex_tile", ("-DSIMPLEX_TRACE",)))
    nph = lib.simplex_trace_phases()
    assert nph == len(SIMPLEX_TRACE_PHASES), nph
    rows = []
    cases = [("lp_100d_50k", lp100, rule, "whole solve") for rule in RULES]
    cases += [("lp_afiro_100k", lp_af, "dantzig", "whole solve"),
              ("lp_100d_50k", lp100, "dantzig", "compaction schedule")]
    for name, lp, rule, what in cases:
        A, b, c, ub = _revised_slice(lp, SLICE)
        m, n = lp.m, lp.n
        mi = default_max_iters(m, n)
        assert lib.simplex_trace_reset() == 0
        with kernel_library("simplex_tile", lib):
            if what == "whole solve":
                work = torch.zeros((SLICE, WORK_COUNTERS), dtype=torch.int32,
                                   device="cuda")
                _, ms = timed(lambda: simplex_tile(
                    A, b, c, ub, m=m, n=n, max_iters=mi, pricing=rule,
                    work=work))
                work = work.cpu().numpy()
            else:
                _, work, _, ms = schedule(
                    KernelBackend(m, n, 1e-6, 1e-5, pricing=rule), A, b, c,
                    ub, max_iters=mi)
        buf = (ctypes.c_ulonglong * (2 * nph + 4))()
        assert lib.simplex_trace_read(buf) == 0
        p1 = dict(zip(SIMPLEX_TRACE_PHASES, buf[:nph]))
        p2 = dict(zip(SIMPLEX_TRACE_PHASES, buf[nph:2 * nph]))
        other = int(buf[2 * nph])
        steps1, steps2, blocks = (int(v) for v in buf[2 * nph + 1:])
        total = sum(p1.values()) + sum(p2.values()) + other
        piv1, piv2, flips = (int(v) for v in work.sum(axis=0))
        row = {"simplex_trace": name, "pricing": rule, "what": what,
               "lps": SLICE, "m": m, "n": n, "traced_ms": ms,
               "blocks": blocks, "p1_steps": steps1, "p2_steps": steps2,
               "phase1_pivots": piv1, "phase2_pivots": piv2, "flips": flips,
               "block_cycles_per_lp_step": total / (steps1 + steps2),
               "p1_block_cycles_per_step":
                   sum(p1.values()) / max(steps1, 1),
               "p2_block_cycles_per_step":
                   sum(p2.values()) / max(steps2, 1),
               "shares": {"p1": {k: v / total for k, v in p1.items()},
                          "p2": {k: v / total for k, v in p2.items()},
                          "other": other / total},
               "cycles": {"p1": p1, "p2": p2, "other": other}}
        emit(row)
        rows.append(row)
        del A, b, c, ub
    return rows


def _equal_leaves(got, want, what):
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{what}: leaf {i}")


def simplex_ab(parent_src, lp100, slices):
    """The parent's simplex kernels (built from ``parent_src``) against
    this tree's on the same inputs, in turns (parent, new, new, parent),
    Dantzig: the whole-solve kernel on all of lp_100d_50k and on each of
    ``slices`` ((name, batch, max_iters)), timed around the wrapper and
    around the launch alone, x, objective, status, iterations, y, z and
    work equal at atol 0 (NaN where NaN); the compaction schedule on all
    of lp_100d_50k, its segment launches summed, run once more with every
    segment launched by both builds from one state and every leaf
    compared; then solve_batched wall time with and without compaction,
    every result equal."""
    import numpy as np
    import torch
    from repro_torch.core import solve_batched
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import KernelBackend
    from repro_torch.kernels.simplex_tile import WORK_COUNTERS, simplex_tile
    parent = _ParentStages(_simplex_argtypes(_build.load(
        "simplex_tile_parent", src=parent_src)))
    new = _simplex_module()._lib()
    order = ("parent", "new", "new", "parent")

    def turn(which, lib):
        # the parent's kernels take this tree's C interface and blocks
        return kernel_library("simplex_tile", lib)

    cases = [("lp_100d_50k", lp100, default_max_iters(lp100.m, lp100.n))]
    for name, lp, mi in cases + list(slices):
        m, n = lp.m, lp.n
        A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
        ms, kernel_ms, first = {}, {}, None
        for which in order:
            lib = _TimedLaunches(parent if which == "parent" else new,
                                 ("simplex_tile_launch",))
            work = torch.zeros((lp.batch, WORK_COUNTERS), dtype=torch.int32,
                               device="cuda")
            with turn(which, lib):
                got, t = timed(lambda: simplex_tile(
                    A, b, c, ub, m=m, n=n, max_iters=mi, work=work))
            (start, end), = lib.events
            ms.setdefault(which, []).append(t)
            kernel_ms.setdefault(which, []).append(start.elapsed_time(end))
            got = got + (work,)
            if first is None:
                first = got
            else:
                _equal_leaves(got, first, f"{name} whole solve")
            del got, work
        work = first[6].cpu().numpy()
        out = {"simplex_ab": name, "what": "whole-solve kernel, dantzig",
               "lps": lp.batch, "max_iters": mi, "parent_ms": ms["parent"],
               "new_ms": ms["new"], "parent_kernel_ms": kernel_ms["parent"],
               "new_kernel_ms": kernel_ms["new"],
               "variant": simplex_variant(m, n),
               "threads": _simplex_module().block_threads(m, n),
               "status_counts": np.bincount(
                   first[2].cpu().numpy().astype(int), minlength=4).tolist(),
               "iterations_sum": int(first[3].sum()), "bitwise_equal": True}
        out.update(bound(m, n, lp.batch, work))
        emit(out)
        del A, b, c, ub, first
        torch.cuda.empty_cache()

    # the compaction schedule: every segment launch by both builds from one
    # state, every leaf equal; then each build timed alone in turns
    class Twin(KernelBackend):
        def segment(self, state, steps, stage, max_iters):
            with turn("parent", parent):
                want, want_it = super().segment(_clone(state), steps, stage,
                                                max_iters)
            got, it = super().segment(state, steps, stage, max_iters)
            _equal_leaves(tuple(got) + (it,), tuple(want) + (want_it,),
                          f"{stage} segment")
            self.launches += 1
            return got, it
    lp, mi = lp100, default_max_iters(lp100.m, lp100.n)
    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    twin = Twin(lp.m, lp.n, 1e-6, 1e-5)
    twin.launches = 0
    schedule(twin, A, b, c, ub, max_iters=mi)
    seg_ms, kernel_ms, total_ms, first = {}, {}, {}, None
    for which in order:
        lib = _TimedLaunches(parent if which == "parent" else new,
                             ("simplex_segment_launch",))
        kb = timed_backend(KernelBackend)(lp.m, lp.n, 1e-6, 1e-5)
        with turn(which, lib):
            res, work, stats, ms = schedule(kb, A, b, c, ub, max_iters=mi)
        torch.cuda.synchronize()
        seg_ms.setdefault(which, []).append(sum(kb.segment_ms))
        kernel_ms.setdefault(which, []).append(
            sum(a.elapsed_time(e) for a, e in lib.events))
        total_ms.setdefault(which, []).append(ms)
        if first is None:
            first = (res, work)
        else:
            assert same_result(res, first[0], ("status", "iterations", "x",
                                               "objective", "y", "z"))
            assert np.array_equal(work, first[1])
    out = {"simplex_ab": "lp_100d_50k", "what": "compaction schedule, "
           "segment launches summed, dantzig", "lps": lp.batch,
           "segments": len(stats), "parent_ms": seg_ms["parent"],
           "new_ms": seg_ms["new"], "parent_kernel_ms": kernel_ms["parent"],
           "new_kernel_ms": kernel_ms["new"],
           "parent_scheduled_ms": total_ms["parent"],
           "new_scheduled_ms": total_ms["new"],
           "p1_variant": simplex_variant(lp.m, lp.n, stage="p1"),
           "p2_variant": simplex_variant(lp.m, lp.n, stage="p2"),
           "leaves_equal_after_each_of": twin.launches, "bitwise_equal": True}
    out.update(bound(lp.m, lp.n, lp.batch, first[1], segment=True))
    emit(out)
    del A, b, c, ub, first
    torch.cuda.empty_cache()
    for compaction in (False, True):
        wall, first = {}, None
        for which in order:
            with turn(which, parent if which == "parent" else new):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve_batched(lp100, compaction=compaction)
                wall.setdefault(which, []).append(time.perf_counter() - t0)
            if first is None:
                first = res
            else:
                assert same_result(res, first, ("status", "iterations", "x",
                                                "objective", "y", "z"))
        emit({"simplex_ab": "lp_100d_50k",
              "what": "solve_batched(compaction=%s)" % compaction,
              "lps": lp100.batch, "parent_wall_s": wall["parent"],
              "new_wall_s": wall["new"], "bitwise_equal": True})
        del first, res


def flowpipe(rng, n, T):
    """The Table-7 reachability flow-pipe: T boxes of an n-dimensional
    linear system x' = A x with a slightly growing box (copied from the
    reference's benchmarks/table7_reachability.py, with a seeded rng)."""
    import numpy as np
    A = np.eye(n) + 0.01 * rng.normal(size=(n, n))
    lo, hi = [-0.1 * np.ones(n)], [0.1 * np.ones(n)]
    for _ in range(T - 1):
        c = (lo[-1] + hi[-1]) / 2
        r = (hi[-1] - lo[-1]) / 2
        c = A @ c
        r = np.abs(A) @ r + 1e-3
        lo.append(c - r)
        hi.append(c + r)
    return np.stack(lo), np.stack(hi)


def timed_avg(fn, reps=20, spin_cycles=50_000_000):
    """Mean device milliseconds of fn() over reps calls after one warm-up
    call.  A spin kernel (about 25 ms) queued before the first event keeps
    the card busy while the host enqueues the calls, so the host's time
    per call (tens of microseconds for a small launch from Python) does
    not count: the events then time the queued work back to back."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_hyperbox(lo, hi, d):
    """Kernel, plain version and the library composition on device
    tensors; the bound charges lo, hi and d read once and the output
    written once."""
    import torch
    from repro_torch.kernels import hyperbox_tile, hyperbox_tile_plain
    shared = d.shape[0] != lo.shape[0]
    ms = timed_avg(lambda: hyperbox_tile(lo, hi, d))
    plain_ms = timed_avg(lambda: hyperbox_tile_plain(lo, hi, d), reps=3)
    if shared:
        lib = lambda: (d[None] * torch.where(  # noqa: E731
            d[None] < 0, lo[:, None], hi[:, None])).sum(-1)
    else:
        lib = lambda: (d * torch.where(d < 0, lo, hi)).sum(-1)  # noqa: E731
    library_ms = timed_avg(lib)
    B, n = lo.shape
    outs = B * (d.shape[0] if shared else 1)
    nbytes = 4 * (2 * B * n + d.shape[0] * n + outs)
    return {"boxes": B, "outputs": outs, "n": n, "shared_directions": shared,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "3 calls: torch.where, multiply, sum",
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "bound_by": "bytes"}


def box_lp():
    """The box-LP path: the Table-7 flow-pipe through solve_hyperbox on the
    card, held against the plain version, the float64 oracle and the
    simplex path; the kernel timed there and at T = 50,000."""
    import numpy as np
    import torch
    from repro_torch.core import (hyperbox_as_general_lp, solve_batched,
                                  solve_hyperbox, solve_hyperbox_ref)
    from repro_torch.kernels import hyperbox_tile, hyperbox_tile_plain
    rng = np.random.default_rng(2018)
    n, T, K = 5, 500, 40
    lo, hi = flowpipe(rng, n, T)
    dirs = rng.normal(size=(K, n))
    # expand to (T*K) box LPs, as the reference's Table-7 benchmark does
    lo_e, hi_e = np.repeat(lo, K, axis=0), np.repeat(hi, K, axis=0)
    d_e = np.tile(dirs, (T, 1))
    put = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device="cuda")
    tl, th, td = put(lo_e), put(hi_e), put(d_e)

    zero_counts()
    sup = solve_hyperbox(tl, th, td)
    torch.cuda.synchronize()
    got = counts()
    assert only("hyperbox") == 1, got
    assert sup.shape == (T * K,)
    assert torch.equal(sup, hyperbox_tile_plain(tl, th, td))
    ref = solve_hyperbox_ref(lo_e, hi_e, d_e)
    s = sup.cpu().numpy()
    rel = float(np.max(np.abs(s - ref) / np.abs(ref)))
    assert rel <= 1e-5, ("hyperbox vs oracle", rel)
    # the shared-direction form: every direction on every box
    shared = hyperbox_tile(put(lo), put(hi), put(dirs))
    assert torch.equal(shared, sup.reshape(T, K))
    assert torch.equal(shared, hyperbox_tile_plain(put(lo), put(hi),
                                                   put(dirs)))
    # the same LPs as general LPs through the simplex path
    lp, off = hyperbox_as_general_lp(lo_e, hi_e, d_e)
    res = solve_batched(lp)
    assert (res.status == 0).all()
    rel_lp = float(np.max(np.abs(res.objective + off - ref) / np.abs(ref)))
    assert rel_lp <= 1e-4, ("simplex vs support values", rel_lp)
    main = time_hyperbox(tl, th, td)
    # the launch floor: one box through solve_hyperbox (and the wrapper
    # alone), the same harness; at 20,000 boxes the bytes bound is a
    # small share of any launch's time
    one = tuple(t[:1].contiguous() for t in (tl, th, td))
    main["one_box_solve_ms"] = timed_avg(lambda: solve_hyperbox(*one))
    main["one_box_kernel_ms"] = timed_avg(lambda: hyperbox_tile(*one))
    main.update({"box_lp": "table7_flowpipe", "T": T, "K": K,
                 "launches": got["hyperbox"],
                 "max_abs_err": float((sup - hyperbox_tile_plain(
                     tl, th, td)).abs().max()),
                 "max_rel_vs_oracle": rel, "simplex_max_rel": rel_lp,
                 "simplex_mean_iterations": float(res.iterations.mean())})
    emit(main)
    # T = 50,000: the pipe's boxes grow about 2.5% a step and would
    # overflow, so the 500-step pipe is repeated 100 times
    reps = 100
    big = (put(np.tile(lo_e, (reps, 1))), put(np.tile(hi_e, (reps, 1))),
           put(np.tile(d_e, (reps, 1))))
    assert torch.equal(hyperbox_tile(*big), hyperbox_tile_plain(*big))
    emit(dict(time_hyperbox(*big), box_lp="table7_flowpipe", T=T * reps,
              K=K))
    emit(dict(time_hyperbox(put(np.tile(lo, (reps, 1))),
                            put(np.tile(hi, (reps, 1))), put(dirs)),
              box_lp="table7_flowpipe", T=T * reps, K=K))
    del big
    torch.cuda.empty_cache()
    return main


# ---- the revised simplex (core/revised.py, csrc/revised_tile.cu) ---------

REVISED_RULES = ("dantzig", "partial")
# members of the revised warm-start trajectory (three solves): a solve of
# 100,000 general-form AFIRO copies costs 20-25 s of host
# canonicalization, which the run's 1,200 s cannot spare three times
TRAJ_LPS = 10_000
# the revised and PDHG warm phases' cold and warm solves of lp_afiro_100k
# take its first AFIRO_WARM_LPS members (about 80 s of host
# canonicalization on all 100,000; the tableau main path keeps them all)
AFIRO_WARM_LPS = 20_000


def revised_main(name, batch, oracle_batch, pricing, tableau_res=None):
    """Drive solve_batched(backend="revised") once through the revised
    kernel; hold the result against the oracle and, where given, count the
    statuses that agree with the tableau run of the same batch."""
    import numpy as np
    import torch
    from repro_torch.core import solve_batched, solve_batched_reference
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = solve_batched(batch, backend="revised", pricing=pricing)
    wall = time.perf_counter() - t0
    launches = only("revised_segment")
    B = res.status.shape[0]
    assert res.x.shape == (B, batch.n) and res.objective.shape == (B,)
    opt = res.status == 0
    assert np.isfinite(res.x[opt]).all() and np.isfinite(res.objective[opt]).all()
    assert res.warm is not None and res.warm.basis.shape[0] == B
    info = {"revised_main": name, "pricing": pricing, "lps": B,
            "wall_s": wall, "lps_per_s": B / wall, "launches": launches,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "status_counts": np.bincount(res.status.astype(int),
                                         minlength=4).tolist(),
            "mean_iterations": float(res.iterations.mean())}
    if tableau_res is not None:
        info["status_agree_with_tableau"] = float(
            (res.status == tableau_res.status).mean())
        both = opt & (tableau_res.status == 0)
        info["max_rel_obj_vs_tableau"] = float(np.max(
            np.abs(res.objective[both] - tableau_res.objective[both])
            / np.abs(tableau_res.objective[both]), initial=0.0))
    info.update(check_oracle(f"{name} revised {pricing}", res,
                             solve_batched_reference(oracle_batch)))
    emit(info)
    return res, launches


def same_answers(cold, warm, rtol=2e-3):
    """The reference's warm-start contract (tests/test_warm.py): equal
    statuses, OPTIMAL objectives within rtol."""
    import numpy as np
    np.testing.assert_array_equal(cold.status, warm.status)
    ok = cold.status == 0
    np.testing.assert_allclose(warm.objective[ok], cold.objective[ok],
                               rtol=rtol)
    return float(np.max(np.abs(warm.objective[ok] - cold.objective[ok])
                        / np.abs(cold.objective[ok]), initial=0.0))


def revised_warm(afiro, g, g64, traj_lps):
    """Warm starts through the revised kernel: lp_afiro_100k cold, then
    re-solved from its own optimum (0 iterations on every OPTIMAL member),
    then step 1 of a perturbed AFIRO trajectory warm from step 0, against
    its cold solve."""
    import numpy as np
    from repro_torch.core import solve_batched
    from repro_torch.io import perturbed_sequence
    res, launches = revised_main("lp_afiro_100k", g, g64, "dantzig")
    assert res.status[0] == 0
    np.testing.assert_allclose(res.objective[0], AFIRO_OPT, rtol=1e-4)
    zero_counts()
    t0 = time.perf_counter()
    again = solve_batched(g, backend="revised", warm=res.warm_start())
    wall = time.perf_counter() - t0
    launches += only("revised_segment")
    opt = res.status == 0
    assert (again.iterations[opt] == 0).all(), "warm re-solve pivoted"
    rel_again = same_answers(res, again, rtol=1e-5)
    seq = perturbed_sequence(afiro, traj_lps, 2, np.random.default_rng(2018))
    zero_counts()
    ws = solve_batched(seq[0], backend="revised").warm_start()
    cold = solve_batched(seq[1], backend="revised")
    t1 = time.perf_counter()
    warm = solve_batched(seq[1], backend="revised", warm=ws)
    wall_traj = time.perf_counter() - t1
    launches += only("revised_segment")
    rel = same_answers(cold, warm)
    cold_it = int(cold.iterations.astype(np.int64).sum())
    warm_it = int(warm.iterations.astype(np.int64).sum())
    assert warm_it <= cold_it, (warm_it, cold_it)
    emit({"revised_warm": "lp_afiro_100k", "members": g.A.shape[0],
          "member0_objective":
          float(res.objective[0]), "published": AFIRO_OPT,
          "resolve_wall_s": wall, "resolve_optimal_lps": int(opt.sum()),
          "resolve_max_iterations": int(again.iterations[opt].max()),
          "resolve_max_rel_obj": rel_again,
          "trajectory_lps": traj_lps, "trajectory_step": 1,
          "trajectory_status_counts": np.bincount(
              warm.status.astype(int), minlength=4).tolist(),
          "trajectory_max_rel_obj": rel, "cold_iterations_sum": cold_it,
          "warm_iterations_sum": warm_it, "warm_wall_s": wall_traj,
          "launches": launches})
    return launches


def revised_bound(m, n, B, work):
    """Least time for the revised work this run's data needed, from the
    kernel's per-LP counts (core/revised.py WORK_FIELDS: steps, pivots,
    flips, refactorizations, columns priced): the larger of the operations
    time and the bytes time.  Operations, at the f32 rate outside the
    tensor cores: BTRAN 2m^2 a step, pricing 2m a priced column, FTRAN 2m^2
    a pivot or flip, the eta update of Binv 2m^2 a pivot, a refactorization
    2m^3.  Bytes: A, b, c and ub read once; x, y, z, the objective, status,
    iterations, the basis and the bound flags written once."""
    steps, pivots, flips, refactors, priced = (int(v) for v in
                                               work.sum(axis=0))
    flops = (2 * m * m * (steps + flips + 2 * pivots) + 2 * m * priced
             + 2 * m ** 3 * refactors)
    nbytes = B * (4 * (m * n + m + 2 * n) + 4 * (2 * n + 2 * m + 3) + n)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"steps": steps, "pivots": pivots, "flips": flips,
            "refactors": refactors, "priced_columns": priced,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def compare_revised(name, lp, rule, n_lp=SLICE, n_plain=SLICE,
                    max_iters=None, here=False):
    """The revised kernel against its plain version on the first n_lp LPs
    (plain: the first n_plain): one launch of each stage leaf by leaf, then
    the whole solve (its plain version on a worker; status, iterations, x,
    objective, y, z, basis, bound flags and work counts equal, NaN where
    NaN).  A check (``start``, ``finish``)."""
    import numpy as np
    import torch
    from repro_torch.core.lp import LPBatch, default_max_iters
    from repro_torch.core.revised import (WORK_FIELDS, auto_refactor_period,
                                          warm_state)
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.revised_tile import (revised_segment_tile,
                                                  revised_segment_tile_plain,
                                                  revised_tile, variant)
    sub = LPBatch(A=lp.A[:n_lp], b=lp.b[:n_lp], c=lp.c[:n_lp],
                  ub=None if lp.ub is None else lp.ub[:n_lp])
    A, b, c, ub = batch_tensors(sub, torch.device("cuda"))
    m, n, k = lp.m, lp.n, n_plain
    if max_iters is None:
        max_iters = default_max_iters(m, n)
    K = auto_refactor_period(m, n)
    wkw = dict(m=m, n=n, max_iters=max_iters, refactor_period=K,
               pricing=rule)
    plain = Behind(plain_revised, *host(A[:k], b[:k], c[:k], ub[:k]), wkw,
                   here=here)
    yield
    kw = dict(m=m, n=n, max_iters=max_iters, tol=1e-6, refactor_period=K,
              rule=rule)
    state = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5)
    one = {}
    for stage in ("p1", "p2"):
        got, it = revised_segment_tile(_clone(state), 32,
                                       stage=stage, **kw)
        want, want_it = revised_segment_tile_plain(_first(state, k),
                                                   32, stage=stage, **kw)
        torch.cuda.synchronize()
        assert torch.equal(it[:k], want_it), (name, rule, stage, "steps")
        for leaf, g, w in leaf_pairs(got, want):
            torch.testing.assert_close(g[:k], w, rtol=0, atol=0,
                                       equal_nan=True,
                                       msg=f"{name} {rule} {stage} {leaf}")
        one[stage] = {"steps_max": int(it.max()),
                      "running_after": int((got.status == -1).sum())}
        state = got
    del state, got, want
    work = torch.zeros((n_lp, len(WORK_FIELDS)), dtype=torch.int32,
                       device="cuda")
    got, ms = timed(lambda: revised_tile(A, b, c, ub, work=work, **wkw))
    want, work_plain, plain_ms = plain.result()
    want = on_card(want)
    work_plain = on_card([work_plain])[0]
    err = 0.0
    for i, what in enumerate(("x", "objective", "status", "iterations", "y",
                              "z", "basis", "onub")):
        torch.testing.assert_close(got[i][:k], want[i], rtol=0, atol=0,
                                   equal_nan=True,
                                   msg=f"{name} {rule} whole {what}")
        if got[i].dtype == torch.float32:
            g, w = got[i][:k], want[i]
            fin = torch.isfinite(g) & torch.isfinite(w)
            err = max(err, float((g - w).abs()[fin].max()) if fin.any()
                      else 0.0)
    assert torch.equal(work[:k], work_plain), (name, rule, "work")
    status = got[2].cpu().numpy()
    out = {"compare_revised": name, "pricing": rule, "lps": n_lp,
           "plain_lps": k, "max_iters": max_iters, "refactor_period": K,
           "variant": variant(m, n), "one_launch": one,
           "status_counts": np.bincount(status.astype(int),
                                        minlength=4).tolist(),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "plain_on": plain.where}
    out.update(revised_bound(m, n, n_lp, work.cpu().numpy()))
    emit(out)
    return out, got


def compare_revised_schedule(name, lp, rule, n_lp=SLICE):
    """compaction=True for the revised engine on the first n_lp LPs: the
    schedule through RevisedKernelBackend equals the one through the plain
    RevisedBackend (on a worker) bit for bit; against the whole solve
    (what its hand-over point receives: ``finish(check, whole)``) statuses
    are equal and objectives within rel 1e-3 (the reference's contract,
    tests/test_tile_parity.py).  A check."""
    import numpy as np
    import torch
    from repro_torch.core.lp import LPBatch, default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.ops import RevisedKernelBackend
    sub = LPBatch(A=lp.A[:n_lp], b=lp.b[:n_lp], c=lp.c[:n_lp],
                  ub=None if lp.ub is None else lp.ub[:n_lp])
    A, b, c, ub = batch_tensors(sub, torch.device("cuda"))
    mi = default_max_iters(lp.m, lp.n)
    args = (lp.m, lp.n, 1e-6, 1e-5)
    plain = Behind(plain_schedule, *host(A, b, c, ub),
                   "repro_torch.core.revised:RevisedBackend", args,
                   {"pricing": rule}, mi)
    whole = yield
    kb = timed_backend(RevisedKernelBackend, revised_state_bytes)(
        *args, pricing=rule)
    zero_counts()
    got, _, stats, ms = schedule(kb, A, b, c, ub, max_iters=mi)
    assert counts()["revised_segment"] == len(stats), (counts(), len(stats))
    want, _, plain_seg_ms, plain_ms = plain.result()
    assert same_result(got, want, ("status", "iterations", "x", "objective",
                                   "y", "z")), (name, rule, "schedules")
    status = whole[2].cpu().numpy().astype(np.int8)
    np.testing.assert_array_equal(got.status, status)
    obj = whole[1].cpu().numpy()
    ok = status == 0
    rel = float(np.max(np.abs(got.objective[ok] - obj[ok]) / np.abs(obj[ok]),
                       initial=0.0))
    assert rel <= 1e-3, (name, rule, rel)
    emit({"compare_revised_schedule": name, "pricing": rule, "lps": n_lp,
          "segments": len(stats), "gathers": len(kb.gather_ms),
          "ladder_stage_bucket_steps_survivors": ladder(stats),
          "bitwise_equal_plain_schedule": True,
          "max_rel_obj_vs_whole": rel,
          "iteration_diffs_vs_whole": int((got.iterations != whole[3]
                                           .cpu().numpy()).sum()),
          "ms": sum(kb.segment_ms), "scheduled_ms": ms,
          "plain_ms": plain_seg_ms, "plain_scheduled_ms": plain_ms,
          "plain_on": plain.where, "state_bytes_moved": kb.moved})


def revised_at_full_batch(name, lp):
    """The revised wrapper once over a whole canonical batch (state build,
    kernel, extraction), timed on the card with its bound; beside it, as a
    yardstick for the refactorization alone, torch.linalg.inv on the
    final basis matrices (the port never calls it)."""
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.revised import (WORK_FIELDS, auto_refactor_period,
                                          warm_state)
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.revised_tile import revised_tile
    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    m, n = lp.m, lp.n
    work = torch.zeros((lp.batch, len(WORK_FIELDS)), dtype=torch.int32,
                       device="cuda")
    out, ms = timed(lambda: revised_tile(
        A, b, c, ub, m=m, n=n, max_iters=default_max_iters(m, n),
        refactor_period=auto_refactor_period(m, n), work=work))
    basis = out[6]
    del out
    Abar = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5).Abar
    Bmat = Abar.gather(2, basis.long()[:, None, :].expand(-1, m, m))
    del Abar
    torch.cuda.empty_cache()
    _, inv_ms = timed(lambda: torch.linalg.inv(Bmat))
    info = {"revised_full_batch": name, "lps": lp.batch, "ms": ms,
            "refactorizations_per_lp": float(work[:, 3].double().mean()),
            "yardstick_linalg_inv_ms": inv_ms}
    info.update(revised_bound(m, n, lp.batch, work.cpu().numpy()))
    emit(info)
    del A, b, c, ub, Bmat, work
    torch.cuda.empty_cache()
    return info


def revised_state_bytes(m, n, rule, stage):
    """Bytes one LP's revised segment state moves per launch when its block
    loads it: Abar, cvec, ub and thr read; xB, basis, bound flags, phase,
    status, iterations, y and work read and written; the step count
    written."""
    read = 4 * (m * (n + 2 * m) + (n + m) + n + 1)
    rw = 4 * (3 * m + 3 + 5) + n
    return read + 2 * rw + 4


# ---- the revised kernel's builds: cycle counters, the parent's source -----

REVISED_TRACE_PHASES = ("refactor", "btran", "price_partial", "price",
                        "ftran", "ratio", "update", "barrier", "other")


def _revised_module():
    import importlib
    return importlib.import_module("repro_torch.kernels.revised_tile")


def _parent_revised(lib):
    """``lib`` (the parent's revised_tile build) bound with its own C
    signatures: the counter-free exports, and its revised_tile_variant of
    (m, n), which the wrapper asks with this tree's tel flag (always 0 for
    a counter-free launch)."""
    import ctypes
    lib.revised_segment_launch.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.revised_segment_launch.restype = ctypes.c_int
    lib.revised_tile_workspace_floats.argtypes = [ctypes.c_int]
    lib.revised_tile_workspace_floats.restype = ctypes.c_longlong
    parent_variant = lib.revised_tile_variant
    parent_variant.argtypes = [ctypes.c_int] * 2
    parent_variant.restype = ctypes.c_int

    def variant(m, n, tel):
        assert tel == 0, "the parent has no counter-carrying launch"
        return parent_variant(m, n)
    lib.revised_tile_variant = variant
    return lib


def revised_trace_build():
    """The revised_tile build with the cycle counters (-DREVISED_TRACE)."""
    from repro_torch.kernels import _build
    return _build.build(("revised_tile",), ("-DREVISED_TRACE",))


def ptxas_rows(name, kernels, extra=()):
    """Registers, stack frame, spills and static shared bytes of every
    instantiation of the ``kernels`` (function names) in library ``name``
    built with the extra flags ``extra``, from its -Xptxas -v report."""
    import re
    from repro_torch.kernels import _build
    log = _build.library_path(name, extra).with_suffix(".log").read_text()
    entry = re.compile(r"entry function '\S*?(%s)I(\w*?)EEv"
                       % "|".join(kernels))
    rows, kernel, frame = [], None, None
    for line in log.splitlines():
        got = entry.search(line)
        if got:
            kernel = "%s<%s>" % (got.group(1), ",".join(
                re.findall(r"L[ib](\d+)E", got.group(2))))
            continue
        got = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads", line)
        if got and kernel:
            frame = [int(v) for v in got.groups()]
            continue
        got = re.search(r"Used (\d+) registers", line)
        if got and kernel and frame:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"kernel": kernel, "registers": int(got.group(1)),
                         "stack_bytes": frame[0],
                         "spill_store_bytes": frame[1],
                         "spill_load_bytes": frame[2],
                         "static_smem_bytes": int(smem.group(1)) if smem
                         else 0})
            kernel = frame = None
    assert rows, log[-2000:]
    return rows


def no_spills(rows):
    return all(r["spill_store_bytes"] == r["spill_load_bytes"]
               == r["stack_bytes"] == 0 for r in rows)


def revised_ptxas():
    """Every revised_segment_kernel instantiation's ptxas line; fails on a
    spill or a stack frame."""
    rows = ptxas_rows("revised_tile", ("revised_segment_kernel",))
    emit({"revised_ptxas": rows})
    assert no_spills(rows), rows
    return rows


def simplex_ptxas(extra=()):
    """Every simplex_tile_kernel and simplex_segment_kernel instantiation's
    ptxas line (of the build with ``extra`` flags); fails on a spill or a
    stack frame."""
    rows = ptxas_rows("simplex_tile", ("simplex_tile_kernel",
                                       "simplex_segment_kernel"), extra)
    emit({"simplex_ptxas": rows, "flags": list(extra)})
    assert no_spills(rows), rows
    return rows


def _revised_slice(lp, k):
    import torch
    from repro_torch.core.lp import LPBatch
    from repro_torch.core.simplex import batch_tensors
    sub = LPBatch(A=lp.A[:k], b=lp.b[:k], c=lp.c[:k],
                  ub=None if lp.ub is None else lp.ub[:k])
    return batch_tensors(sub, torch.device("cuda"))


def revised_trace(lp100, lp_af):
    """The revised kernel's cycles by phase (thread 0 of each block,
    clock64; the -DREVISED_TRACE build) on the first SLICE LPs of
    lp_100d_50k under both rules and of lp_afiro_100k: shares, block cycles
    an LP-step and a refactorization, and the steps, pivots and
    refactorizations the counters cover."""
    import ctypes
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.revised import WORK_FIELDS, auto_refactor_period
    from repro_torch.kernels import _build
    from repro_torch.kernels.revised_tile import revised_tile
    lib = _revised_module()._bind(_build.load("revised_tile",
                                              ("-DREVISED_TRACE",)))
    nph = lib.revised_trace_phases()
    assert nph == len(REVISED_TRACE_PHASES), nph
    rows = []
    for name, lp, rule in (("lp_100d_50k", lp100, "dantzig"),
                           ("lp_100d_50k", lp100, "partial"),
                           ("lp_afiro_100k", lp_af, "dantzig")):
        A, b, c, ub = _revised_slice(lp, SLICE)
        m, n = lp.m, lp.n
        work = torch.zeros((SLICE, len(WORK_FIELDS)), dtype=torch.int32,
                           device="cuda")
        assert lib.revised_trace_reset() == 0
        with kernel_library("revised_tile", lib):
            _, ms = timed(lambda: revised_tile(
                A, b, c, ub, m=m, n=n, max_iters=default_max_iters(m, n),
                refactor_period=auto_refactor_period(m, n), pricing=rule,
                work=work))
        buf = (ctypes.c_ulonglong * (nph + 1))()
        assert lib.revised_trace_read(buf) == 0
        cycles = dict(zip(REVISED_TRACE_PHASES, buf[:nph]))
        total = sum(cycles.values())
        steps, pivots, flips, refactors, priced = (
            int(v) for v in work.sum(dim=0).tolist())
        row = {"revised_trace": name, "pricing": rule,
               "lps": SLICE, "m": m, "n": n, "traced_ms": ms,
               "blocks": int(buf[nph]), "steps": steps, "pivots": pivots,
               "refactors": refactors, "priced_columns": priced,
               "block_cycles_per_lp_step": total / steps,
               "refactor_cycles_per_refactorization":
                   cycles["refactor"] / max(refactors, 1),
               "shares": {k: v / total for k, v in cycles.items()},
               "cycles": cycles}
        emit(row)
        rows.append(row)
        del A, b, c, ub
    return rows


def revised_ab(parent_src, lp100, slices):
    """The parent's revised kernel (built from ``parent_src``) against
    this tree's on the same inputs, in turns (parent, new, new, parent),
    under both rules: one whole-solve launch from the cold state over all
    of lp_100d_50k and over each of ``slices`` ((name, batch, max_iters)),
    every leaf of the state and the steps taken equal, timed around the
    wrapper and around the kernel's launch alone (CUDA events); then
    solve_batched(backend="revised") wall time on lp_100d_50k, every result
    equal."""
    import numpy as np
    import torch
    from repro_torch.core import solve_batched
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.revised import (RevisedState, auto_refactor_period,
                                          warm_state)
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels import _build
    from repro_torch.kernels.revised_tile import (revised_segment_tile,
                                                  variant)
    parent = _parent_revised(_build.load("revised_tile_parent",
                                         src=parent_src))
    new = _revised_module()._lib()
    order = ("parent", "new", "new", "parent")
    cases = [("lp_100d_50k", lp100, default_max_iters(lp100.m, lp100.n))]
    cases += list(slices)
    for name, lp, mi in cases:
        m, n = lp.m, lp.n
        A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
        cold = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5)
        del A, b, c, ub
        for rule in REVISED_RULES:
            ms, kernel_ms, first = {}, {}, None
            for which in order:
                state = _clone(cold)
                lib = _TimedLaunches(parent if which == "parent" else new,
                                     ("revised_segment_launch",))
                with kernel_library("revised_tile", lib):
                    (got, it), t = timed(lambda: revised_segment_tile(
                        state, mi, stage="p2", m=m, n=n, max_iters=mi,
                        refactor_period=auto_refactor_period(m, n),
                        rule=rule))
                ms.setdefault(which, []).append(t)
                (start, end), = lib.events
                kernel_ms.setdefault(which, []).append(
                    start.elapsed_time(end))
                if first is None:
                    first = (got, it)
                else:
                    for leaf, g, w in zip(RevisedState._fields, got,
                                          first[0]):
                        torch.testing.assert_close(g, w, rtol=0, atol=0,
                                                   equal_nan=True, msg=leaf)
                    assert torch.equal(it, first[1])
                del state, got, it
            st, it = first
            work = st.work.sum(dim=0).tolist()
            emit({"revised_ab": name, "pricing": rule,
                  "what": "one whole-solve launch, all LPs", "lps": lp.batch,
                  "max_iters": mi, "parent_ms": ms["parent"],
                  "new_ms": ms["new"],
                  "parent_kernel_ms": kernel_ms["parent"],
                  "new_kernel_ms": kernel_ms["new"],
                  "variant": variant(m, n), "status_counts": np.bincount(
                      st.status.cpu().numpy().astype(int) + 1,
                      minlength=5)[1:].tolist(),
                  "mean_iterations": float(st.iters.double().mean()),
                  "work": dict(zip(("steps", "pivots", "flips", "refactors",
                                    "priced_columns"), work)),
                  "bitwise_equal": True})
            del first, st, it
            torch.cuda.empty_cache()
        del cold
    for rule in REVISED_RULES:
        wall, first = {}, None
        for which in order:
            with (kernel_library("revised_tile", parent)
                  if which == "parent" else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve_batched(lp100, backend="revised", pricing=rule)
                wall.setdefault(which, []).append(time.perf_counter() - t0)
            if first is None:
                first = res
            else:
                assert same_result(res, first, ("status", "iterations", "x",
                                                "objective", "y", "z"))
        emit({"revised_ab": "lp_100d_50k", "pricing": rule,
              "what": "solve_batched(backend='revised')", "lps": lp100.batch,
              "parent_wall_s": wall["parent"], "new_wall_s": wall["new"],
              "bitwise_equal": True})
        del first, res


# ---- restarted PDHG (core/pdhg.py, csrc/pdhg_tile.cu) ---------------------

PDHG_OUT = ("x", "objective", "status", "iterations", "y", "z", "warm_x",
            "warm_y", "omega", "eta")
PDHG_PLAIN_CAP = 20_000   # max_iters of the lp_100d_50k kernel/plain check


def pdhg_bound(m, n, B, iters, check_every=16):
    """Least time for the PDHG work this run's data needed, from the per-LP
    iteration counts the kernel reports: the larger of the operations time
    and the bytes time.  Operations, at the f32 rate outside the tensor
    cores: 4mn an iteration (the two matvecs), 8mn a round of check_every
    iterations (the two KKT evaluations of the check) and 2mn for the
    extraction; the Farkas-ray matvecs (only once an iterate passes
    RAY_MIN_NORM) and the linesearch's trial matvecs are left out, so this
    is a floor.  Bytes, at the memory rate: A, b, c and ub read once; x,
    z, y, the objective, status and iterations and the warm capture (x, y,
    omega, eta) written once."""
    import numpy as np
    it = int(np.asarray(iters, np.int64).sum())
    rounds = it // check_every
    flops = 4 * m * n * it + 8 * m * n * rounds + 2 * m * n * B
    nbytes = B * 4 * ((m * n + m + 2 * n) + (3 * n + 2 * m + 5))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"iterations_sum": it, "rounds_sum": rounds,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _pdhg_info(res):
    import numpy as np
    return {"status_counts": np.bincount(np.asarray(res.status).astype(int),
                                         minlength=4).tolist(),
            "mean_iterations": float(np.mean(res.iterations)),
            "max_iterations": int(np.max(res.iterations))}


def planned_bytes(shape, B):
    """The chunk plan's device bytes for B LPs of canonical ``shape`` on
    the pdhg path (Eq. 5's Y, core/pdhg.py ``pdhg_bytes_per_lp``)."""
    from repro_torch.core.pdhg import pdhg_bytes_per_lp
    return B * pdhg_bytes_per_lp(*shape)


def peak_since_reset(before):
    """Device bytes the run allocated at its peak beyond what was alive
    at ``reset_peak_memory_stats``."""
    import torch
    return torch.cuda.max_memory_allocated() - before


def pdhg_main(name, batch, oracle_batch, shape, tableau_res=None):
    """Drive solve_batched(backend="pdhg") once through the whole-solve
    kernel (no segment launch); hold the result against the oracle and,
    where given, count the statuses that agree with the tableau run.  The
    peak device memory must stay within the chunk plan for the canonical
    ``shape`` (m, n)."""
    import numpy as np
    import torch
    from repro_torch.core import solve_batched, solve_batched_reference
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    res = solve_batched(batch, backend="pdhg")
    wall = time.perf_counter() - t0
    launches = only("pdhg")
    B = res.status.shape[0]
    assert res.x.shape == (B, batch.n) and res.objective.shape == (B,)
    opt = res.status == 0
    assert np.isfinite(res.x[opt]).all() and np.isfinite(res.objective[opt]).all()
    assert res.warm is not None and res.warm.omega.shape == (B,)
    peak, plan = peak_since_reset(before), planned_bytes(shape, B)
    assert peak <= plan, (name, peak, plan)
    info = {"pdhg_main": name, "lps": B, "wall_s": wall, "lps_per_s": B / wall,
            "launches": launches, "peak_device_bytes": peak,
            "planned_device_bytes": plan}
    info.update(_pdhg_info(res))
    if tableau_res is not None:
        info["status_agree_with_tableau"] = float(
            (res.status == tableau_res.status).mean())
        both = opt & (tableau_res.status == 0)
        info["max_rel_obj_vs_tableau"] = float(np.max(
            np.abs(res.objective[both] - tableau_res.objective[both])
            / np.abs(tableau_res.objective[both]), initial=0.0))
    info.update(check_oracle(f"{name} pdhg", res,
                             solve_batched_reference(oracle_batch)))
    emit(info)
    return res, launches, wall


def pdhg_compaction_main(lp100, res_whole, wall_whole):
    """solve_batched(backend="pdhg", compaction=True) on every LP of
    lp_100d_50k: only the segment kernel runs, and the result equals the
    whole-solve run bit for bit (the per-LP round budget, the state carried
    through device memory)."""
    import torch
    from repro_torch.core import solve_batched
    stats = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    with segment_events() as events:
        t0 = time.perf_counter()
        res = solve_batched(lp100, backend="pdhg", compaction=True,
                            stats_out=stats)
        wall = time.perf_counter() - t0
    launches = only("pdhg_segment")
    assert len(events) == launches, (len(events), launches)
    assert same_result(res, res_whole, ("status", "iterations", "x",
                                        "objective", "y", "z")), \
        "pdhg compaction != whole solve"
    peak = peak_since_reset(before)
    plan = planned_bytes((lp100.m, lp100.n), lp100.batch)
    assert peak <= plan, ("pdhg compaction", peak, plan)
    info = {"pdhg_compaction_main": "lp_100d_50k", "lps": lp100.batch,
            "wall_s": wall, "lps_per_s": lp100.batch / wall,
            "launches": launches, "segments": len(stats),
            "buckets": sorted({s.bucket for s in stats}, reverse=True),
            "ladder_stage_bucket_rounds_survivors": ladder(stats),
            "bitwise_equal_whole_solve": True,
            "peak_device_bytes": peak, "planned_device_bytes": plan,
            "whole_solve_wall_s": wall_whole,
            "segment_kernel_ms": events_ms(events),
            "variant": pdhg_variant(lp100.m, lp100.n)}
    info.update(_pdhg_info(res))
    info.update(pdhg_bound(lp100.m, lp100.n, lp100.batch, res.iterations))
    emit(info)
    return launches, info


def pdhg_warm(g, g64, shape):
    """Warm starts through the whole-solve kernel: lp_afiro_100k cold
    (member 0 at the published optimum, the first 64 against the oracle),
    then re-solved from its own warm_start(): equal statuses, objectives
    within rel 2e-3 (the reference's contract), at most a quarter of the
    cold mean iterations."""
    import numpy as np
    from repro_torch.core import solve_batched
    cold, launches, wall_cold = pdhg_main("lp_afiro_100k", g, g64, shape)
    assert cold.status[0] == 0
    np.testing.assert_allclose(cold.objective[0], AFIRO_OPT, rtol=1e-4)
    zero_counts()
    t0 = time.perf_counter()
    warm = solve_batched(g, backend="pdhg", warm=cold.warm_start())
    wall = time.perf_counter() - t0
    launches += only("pdhg")
    rel = same_answers(cold, warm)
    cold_mean = float(np.mean(cold.iterations))
    warm_mean = float(np.mean(warm.iterations))
    assert warm_mean <= 0.25 * cold_mean, (warm_mean, cold_mean)
    emit({"pdhg_warm": "lp_afiro_100k", "members": g.A.shape[0],
          "member0_objective": float(cold.objective[0]),
          "published": AFIRO_OPT, "cold_wall_s": wall_cold,
          "warm_wall_s": wall, "cold_mean_iterations": cold_mean,
          "warm_mean_iterations": warm_mean,
          "warm_max_iterations": int(np.max(warm.iterations)),
          "warm_status_counts": np.bincount(warm.status.astype(int),
                                            minlength=4).tolist(),
          "max_rel_obj_warm_vs_cold": rel, "launches": launches})
    return launches


def _pdhg_sub(lp, k):
    import torch
    from repro_torch.core.lp import LPBatch
    from repro_torch.core.simplex import batch_tensors
    sub = LPBatch(A=lp.A[:k], b=lp.b[:k], c=lp.c[:k],
                  ub=None if lp.ub is None else lp.ub[:k])
    return sub, batch_tensors(sub, torch.device("cuda"))


def max_err(pairs):
    """Largest |kernel - plain| over the float entries finite on both
    sides of (kernel, plain) tensor pairs."""
    import torch
    err = 0.0
    for g, w in pairs:
        if g.is_floating_point():
            fin = torch.isfinite(g) & torch.isfinite(w)
            if fin.any():
                err = max(err, float((g - w).abs()[fin].max()))
    return err


def _solved_first(status, iters, k):
    """k members for a plain slice: up to three quarters the OPTIMAL ones
    the kernel solved in the fewest iterations, the rest from the others
    (so that the slice ends at the cap with both kinds in it)."""
    import torch
    opt = torch.nonzero(status == 0).flatten()
    opt = opt[torch.argsort(iters[opt], stable=True)][:3 * k // 4]
    rest = torch.nonzero(status != 0).flatten()[:k - len(opt)]
    return torch.sort(torch.cat([opt, rest])).values


def compare_pdhg(name, lp, rule, n_lp=SLICE, n_plain=512, max_iters=None,
                 solved_first=False, here=False):
    """The whole-solve kernel on the first n_lp LPs against its plain
    version on n_plain of them (the first, or with ``solved_first`` those
    of ``_solved_first``, at least one OPTIMAL): every output equal
    (status, iterations, x, objective, y, z and the warm capture; NaN
    where NaN).  The plain version runs on a worker.  A check (``start``,
    ``finish``); with ``solved_first`` the kernel also runs before the
    hand-over, untimed, and the timed run after it must equal that one."""
    import numpy as np
    import torch
    from repro_torch.core.pdhg import default_pdhg_max_iters
    from repro_torch.kernels.pdhg_tile import pdhg_tile, variant
    _, (A, b, c, ub) = _pdhg_sub(lp, n_lp)
    m, n, k = lp.m, lp.n, n_plain
    if max_iters is None:
        max_iters = default_pdhg_max_iters(m, n)
    kw = dict(m=m, n=n, max_iters=max_iters, step_rule=rule)
    first = None
    if solved_first:
        first = pdhg_tile(A, b, c, ub, **kw)
        idx = _solved_first(first[2], first[3], k)
    else:
        idx = torch.arange(k, device=A.device)
    plain = Behind(plain_pdhg, *host(A[idx], b[idx], c[idx], ub[idx]), kw,
                   here=here)
    yield
    got, ms = timed(lambda: pdhg_tile(A, b, c, ub, **kw))
    for g, f in zip(got, first or ()):
        if g is not None:
            torch.testing.assert_close(g, f, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name} {rule} run to run")
    del first
    want, plain_ms = plain.result()
    want = on_card(want)
    got_k = [g[idx] for g in got]
    for what, g, w in zip(PDHG_OUT, got_k, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{name} {rule} {what}")
    plain_counts = np.bincount(got_k[2].cpu().numpy().astype(int),
                               minlength=4).tolist()
    if solved_first:
        assert plain_counts[0] > 0, (name, "no OPTIMAL member compared")
    iters = got[3].cpu().numpy()
    out = {"compare_pdhg": name, "step_rule": rule, "lps": n_lp,
           "plain_lps": k, "max_iters": max_iters,
           "variant": variant(m, n),
           "status_counts": np.bincount(got[2].cpu().numpy().astype(int),
                                        minlength=4).tolist(),
           "plain_status_counts": plain_counts,
           "plain_members": "solved first" if solved_first else "first",
           "mean_iterations": float(iters.mean()),
           "max_iterations": int(iters.max()),
           "max_abs_err": max_err(zip(got_k, want)),
           "ms": ms, "plain_ms": plain_ms, "plain_on": plain.where}
    out.update(pdhg_bound(m, n, n_lp, iters))
    emit(out)
    return out, got


def compare_pdhg_segment(name, lp, n_lp=SLICE, n_plain=512, steps=8,
                         max_rounds=4375):
    """One segment launch (``steps`` rounds) from a mid-solve state (three
    plain rounds from cold) on every LP, against the plain segment on the
    first n_plain: every leaf and the rounds run equal."""
    import torch
    from repro_torch.core.pdhg import init_pdhg_state, segment_pdhg
    from repro_torch.kernels.pdhg_tile import (pdhg_segment_tile,
                                               pdhg_segment_tile_plain,
                                               variant)
    _, (A, b, c, ub) = _pdhg_sub(lp, n_lp)
    mid, _ = segment_pdhg(init_pdhg_state(A, b, c, ub), 3, tol=1e-5,
                          max_rounds=max_rounds)
    k = n_plain
    (got, it), ms = timed(lambda: pdhg_segment_tile(
        _clone(mid), steps, m=lp.m, n=lp.n, max_rounds=max_rounds))
    (want, want_it), plain_ms = timed(lambda: pdhg_segment_tile_plain(
        _first(mid, k), steps, max_rounds=max_rounds))
    assert torch.equal(it[:k], want_it), (name, "rounds differ")
    pairs = leaf_pairs(got, want)
    for leaf, g, w in pairs:
        torch.testing.assert_close(g[:k], w, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{name} segment {leaf}")
    out = {"compare_pdhg_segment": name, "lps": n_lp, "plain_lps": k,
           "variant": variant(lp.m, lp.n), "rounds": steps,
           "rounds_max": int(it.max()),
           "running_after": int((got.status == -1).sum()),
           "max_abs_err": max_err((g[:k], w) for _, g, w in pairs),
           "ms": ms, "plain_ms": plain_ms}
    emit(out)
    return out


def timed_pdhg_backend(cls):
    """``cls`` (a PDHG scheduler backend) with each segment launch and each
    gather timed by CUDA events."""
    class Timed(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.segment_ms, self.gather_ms = [], []

        def segment(self, state, steps, stage, max_iters):
            out, ms = timed(lambda: super(Timed, self).segment(
                state, steps, stage, max_iters))
            self.segment_ms.append(ms)
            return out

        def take(self, state, idx):
            out, ms = timed(lambda: super(Timed, self).take(state, idx))
            self.gather_ms.append(ms)
            return out
    return Timed


def compare_pdhg_schedule(name, lp, n_lp=SLICE, n_plain=512,
                          max_iters=8000, here=False):
    """compaction=True on the first n_lp LPs through PdhgKernelBackend
    against the plain PdhgBackend on the first n_plain: equal bit for bit
    (status, iterations, x, objective, y, z); and equal to the whole-solve
    kernel on the same LPs at the same cap.  The plain schedule runs on a
    worker.  A check (``start``, ``finish``)."""
    import numpy as np
    import torch
    from repro_torch.core.pdhg import schedule_pdhg
    from repro_torch.kernels.ops import PdhgKernelBackend
    from repro_torch.kernels.pdhg_tile import pdhg_tile
    kw = dict(max_iters=max_iters, segment_k=None, compact_threshold=None)
    plain_sub, _ = _pdhg_sub(lp, n_plain)
    plain = Behind(plain_pdhg_schedule, plain_sub, lp.m, lp.n, kw,
                   here=here)
    yield
    sub, (A, b, c, ub) = _pdhg_sub(lp, n_lp)
    whole = pdhg_tile(A, b, c, ub, m=lp.m, n=lp.n, max_iters=max_iters)
    del A, b, c, ub
    dev = torch.device("cuda")
    kb = timed_pdhg_backend(PdhgKernelBackend)(lp.m, lp.n)
    stats = []
    zero_counts()
    got, ms = timed(lambda: schedule_pdhg(kb, sub, dev, stats_out=stats,
                                          **kw))
    launches = counts()["pdhg_segment"]
    assert launches == len(stats) and counts()["pdhg"] == 0, counts()
    want, plain_seg_ms, plain_ms = plain.result()
    fields = ("status", "iterations", "x", "objective", "y", "z")
    k = n_plain
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[:k],
                                      getattr(want, f),
                                      err_msg=f"{name} schedule {f}")
    for f, t in zip(("x", "objective", "status", "iterations", "y", "z"),
                    whole[:6]):
        np.testing.assert_array_equal(getattr(got, f), t.cpu().numpy(),
                                      err_msg=f"{name} vs whole {f}")
    err = max_err((torch.as_tensor(np.asarray(getattr(got, f))[:k]),
                   torch.as_tensor(getattr(want, f)))
                  for f in ("x", "objective", "y", "z"))
    out = {"compare_pdhg_schedule": name, "lps": n_lp, "plain_lps": k,
           "max_iters": max_iters, "segments": len(stats),
           "gathers": len(kb.gather_ms),
           "ladder_stage_bucket_rounds_survivors": ladder(stats),
           "bitwise_equal_plain_schedule": True,
           "bitwise_equal_whole_solve": True, "max_abs_err": err,
           "ms": sum(kb.segment_ms), "gather_ms": sum(kb.gather_ms),
           "scheduled_ms": ms, "plain_ms": plain_seg_ms,
           "plain_scheduled_ms": plain_ms, "plain_on": plain.where}
    out.update(pdhg_bound(lp.m, lp.n, n_lp, got.iterations))
    emit(out)
    return out


# the sparse engine's cap on sc205_like: its iterations are host-bound
# (44.7 s at 20,000 on a slow host); cut to keep the run under 1,200 s
# with training on a mesh added, every output still equal to the dense
# kernel's
SPARSE_CAP = 5_000


def pdhg_sparse(name, lp, max_iters):
    """SparseLPBatch.from_dense of a canonical batch through the sparse
    engine on the card, against the dense kernel on the same LPs at the
    same cap: equal statuses, objectives within rel 1e-3.  The sparse sums
    follow the dense kernel's order, so every output is in fact equal."""
    import numpy as np
    from repro_torch.core.sparse import (SparseLPBatch,
                                         solve_batched_pdhg_sparse)
    from repro_torch.kernels.ops import solve_batched_kernel
    sp = SparseLPBatch.from_dense(lp)
    t0 = time.perf_counter()
    res = solve_batched_pdhg_sparse(sp, max_iters=max_iters)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = solve_batched_kernel(lp, backend="pdhg", max_iters=max_iters)
    wall_dense = time.perf_counter() - t0
    np.testing.assert_array_equal(res.status, dense.status)
    ok = dense.status == 0
    rel = float(np.max(np.abs(res.objective[ok] - dense.objective[ok])
                       / np.abs(dense.objective[ok]), initial=0.0))
    assert rel <= 1e-3, (name, rel)
    assert same_result(res, dense, ("status", "iterations", "x", "objective",
                                    "y", "z")), (name, "sparse != dense")
    out = {"pdhg_sparse": name, "lps": lp.batch, "nnz": sp.nnz,
           "density": sp.density, "max_iters": max_iters, "wall_s": wall,
           "dense_kernel_wall_s": wall_dense, "max_rel_obj_vs_dense": rel,
           "bitwise_equal_dense_kernel": True}
    out.update(_pdhg_info(res))
    emit(out)


def pdhg_full_batch(lp):
    """The whole-solve wrapper (setup, kernel) once over all of a batch,
    timed on the card with its bound; beside it, as a yardstick and not
    used by the port, one torch.bmm pair (A x, A^T y) over the batch times
    the mean iterations."""
    import torch
    from repro_torch.core.pdhg import default_pdhg_max_iters, init_pdhg_state
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.pdhg_tile import pdhg_tile
    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    m, n, B = lp.m, lp.n, lp.batch
    out, ms = timed(lambda: pdhg_tile(
        A, b, c, ub, m=m, n=n, max_iters=default_pdhg_max_iters(m, n)))
    iters = out[3].cpu().numpy()
    del out
    _, setup_ms = timed(lambda: init_pdhg_state(A, b, c, ub))
    As = init_pdhg_state(A, b, c, ub).A
    del A
    x = torch.ones((B, n, 1), device="cuda")
    y = torch.ones((B, m, 1), device="cuda")

    def pair():
        torch.bmm(As, x)
        torch.bmm(As.transpose(1, 2), y)
    pair()
    _, pair_ms = timed(lambda: [pair() for _ in range(5)])
    pair_ms /= 5
    info = {"pdhg_full_batch": "lp_100d_50k", "lps": B, "ms": ms,
            "setup_ms": setup_ms, "mean_iterations": float(iters.mean()),
            "yardstick_bmm_pair_ms": pair_ms,
            "yardstick_bmm_pairs_times_mean_iterations_ms":
                pair_ms * float(iters.mean())}
    info.update(pdhg_bound(m, n, B, iters))
    emit(info)
    del As, x, y, b, c, ub
    torch.cuda.empty_cache()
    return info


# ---- the PDHG kernel's builds: cycle counters, the parent's source --------

TRACE_PHASES = ("aty", "ax", "update", "barrier", "kkt_matvecs",
                "check_reductions", "ray_matvecs", "check_other", "other")


def _pdhg_module():
    import importlib
    return importlib.import_module("repro_torch.kernels.pdhg_tile")


def pdhg_variant(m, n):
    return _pdhg_module().variant(m, n)


def _pdhg_argtypes(lib, *extra):
    import ctypes
    fn = lib.pdhg_launch if not extra else lib.pdhg_launch_variant
    fn.argtypes = ([ctypes.c_void_p] * 27 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + list(extra))
    fn.restype = ctypes.c_int


class _Forced:
    """A traced pdhg_tile build whose pdhg_launch runs one variant."""

    def __init__(self, lib, variant, threads):
        self.lib, self.variant, self.threads = lib, variant, threads

    def pdhg_launch(self, *args):
        args = list(args)
        args[-2] = self.threads(*args[28:30])   # (m, n) -> threads
        return self.lib.pdhg_launch_variant(*args, self.variant)


def old_threads(m, n):
    """Threads a block of the warp design (the shared and device
    variants)."""
    return 128 if max(m, n) < 64 else 256


@contextlib.contextmanager
def segment_events():
    """CUDA events around every segment launch of the PDHG kernel inside
    the block: yields the list of (start, end) pairs, read after a
    synchronize."""
    import torch
    mod = _pdhg_module()
    launch, events = mod._launch, []

    def timed_launch(state, **kw):
        if kw.get("mode") != "segment":
            return launch(state, **kw)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        launch(state, **kw)
        pair[1].record()
        events.append(pair)
    mod._launch = timed_launch
    try:
        yield events
    finally:
        mod._launch = launch


def events_ms(events):
    import torch
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events)


def pdhg_trace_build():
    """The pdhg_tile build with the cycle counters (-DPDHG_TRACE)."""
    from repro_torch.kernels import _build
    return _build.build(("pdhg_tile",), ("-DPDHG_TRACE",))


def pdhg_ptxas():
    """Registers, stack frame and spills of every pdhg_kernel
    instantiation, from the build's -Xptxas -v report; fails on a
    spill."""
    import re
    from repro_torch.kernels import _build
    log = _build.library_path("pdhg_tile").with_suffix(".log").read_text()
    rows, name, frame = [], None, None
    for line in log.splitlines():
        got = re.search(r"entry function '\S*pdhg_kernelILi(\d)ENS_\d+"
                        r"(RegMv|WarpMv)I(\w*?)EE", line)
        if got:
            mode, kind, params = got.groups()
            args = ",".join(re.findall(r"L[ib](\d+)", params))
            # the last template argument, kTel, closes the name
            tel = " counters" if "Lb1EEEv" in line else ""
            name = f"mode {mode} {kind}<{args}>{tel}"
            continue
        got = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads", line)
        if got and name:
            frame = [int(v) for v in got.groups()]
            continue
        got = re.search(r"Used (\d+) registers", line)
        if got and name and frame:
            rows.append({"kernel": name, "registers": int(got.group(1)),
                         "stack_bytes": frame[0],
                         "spill_store_bytes": frame[1],
                         "spill_load_bytes": frame[2]})
            name = frame = None
    # 3 modes x 4 matvec variants (2 register shapes, shared, device), and
    # the segment mode's counter-carrying instantiation of each variant
    assert len(rows) == 16, rows
    assert sum(r["kernel"].endswith("counters") for r in rows) == 4, rows
    assert all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0
               for r in rows), rows
    emit({"pdhg_ptxas": rows})
    return rows


def pdhg_trace(lp, name="lp_100d_50k", n_lp=SLICE, max_iters=PDHG_PLAIN_CAP):
    """The whole-solve kernel's cycles by phase (thread 0 of each block,
    clock64; the -DPDHG_TRACE build) on the first n_lp LPs, fixed step, in
    the shared variant (the warp design, A in shared memory) and in the registers
    variant, one after the other: each variant's shares, block cycles an
    LP-iteration, and equal outputs."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.pdhg_tile import VARIANTS, pdhg_tile
    lib = _build.load("pdhg_tile", ("-DPDHG_TRACE",))
    _pdhg_argtypes(lib)
    _pdhg_argtypes(lib, ctypes.c_int)
    nph = lib.pdhg_trace_phases()
    assert nph == len(TRACE_PHASES), nph
    _, (A, b, c, ub) = _pdhg_sub(lp, n_lp)
    kw = dict(m=lp.m, n=lp.n, max_iters=max_iters)
    outs, rows = {}, []
    for variant in ("shared", "registers"):
        threads = (old_threads if variant != "registers"
                   else _pdhg_module().block_threads)
        assert lib.pdhg_trace_reset() == 0
        with kernel_library("pdhg_tile",
                            _Forced(lib, VARIANTS.index(variant), threads)):
            got, ms = timed(lambda: pdhg_tile(A, b, c, ub, **kw))
        buf = (ctypes.c_ulonglong * (nph + 1))()
        assert lib.pdhg_trace_read(buf) == 0
        cycles = list(buf[:nph])
        total = sum(cycles)
        iters = int(got[3].sum())
        outs[variant] = got
        row = {"pdhg_trace": name, "variant": variant, "lps": n_lp,
               "max_iters": max_iters, "traced_ms": ms,
               "blocks": int(buf[nph]), "iterations_sum": iters,
               "block_cycles_per_lp_iteration": total / iters,
               "shares": {k: v / total for k, v in zip(TRACE_PHASES, cycles)},
               "cycles": dict(zip(TRACE_PHASES, cycles))}
        emit(row)
        rows.append(row)
    for g, w in zip(outs["registers"], outs["shared"]):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    return rows


def pdhg_ab(parent_src, lp):
    """The parent's PDHG kernel (built from ``parent_src``) against this
    tree's on the same inputs, in turns (parent, new, new, parent): the
    whole-solve kernel on all of ``lp`` and on its first SLICE LPs at
    max_iters PDHG_PLAIN_CAP, solve_batched(backend="pdhg") wall time, and
    compaction=True with its segment launches summed.  Every pair of
    outputs equal."""
    import numpy as np
    import torch
    from repro_torch.core import solve_batched
    from repro_torch.core.pdhg import default_pdhg_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels import _build
    from repro_torch.kernels.pdhg_tile import pdhg_tile
    parent = _build.load("pdhg_tile_parent", src=parent_src)
    _pdhg_argtypes(parent)
    m, n = lp.m, lp.n
    order = ("parent", "new", "new", "parent")

    def turn(which):
        return (kernel_library("pdhg_tile", parent) if which == "parent"
                else contextlib.nullcontext())

    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    for what, k, cap in (("slice", SLICE, PDHG_PLAIN_CAP),
                         ("all", lp.batch, default_pdhg_max_iters(m, n))):
        ms, first = {}, None
        for which in order:
            with turn(which):
                got, t = timed(lambda: pdhg_tile(A[:k], b[:k], c[:k], ub[:k],
                                                 m=m, n=n, max_iters=cap))
            ms.setdefault(which, []).append(t)
            if first is None:
                first = got
            else:
                for g, w in zip(got, first):
                    torch.testing.assert_close(g, w, rtol=0, atol=0,
                                               equal_nan=True)
        iters = first[3].cpu().numpy()
        out = {"pdhg_ab": "lp_100d_50k", "what": f"whole-solve kernel, {what}",
               "lps": k, "max_iters": cap, "parent_ms": ms["parent"],
               "new_ms": ms["new"], "variant": pdhg_variant(m, n),
               "max_iterations": int(iters.max()),
               "status_counts": np.bincount(
                   first[2].cpu().numpy().astype(int), minlength=4).tolist(),
               "bitwise_equal": True}
        out.update(pdhg_bound(m, n, k, iters))
        emit(out)
        del first, got
    del A, b, c, ub
    torch.cuda.empty_cache()
    for compaction in (False, True):
        wall, kern, first = {}, {}, None
        for which in order:
            with turn(which), segment_events() as events:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve_batched(lp, backend="pdhg", compaction=compaction)
                wall.setdefault(which, []).append(time.perf_counter() - t0)
                if compaction:
                    kern.setdefault(which, []).append(events_ms(events))
            if first is None:
                first = res
            else:
                assert same_result(res, first, ("status", "iterations", "x",
                                                "objective", "y", "z"))
        emit({"pdhg_ab": "lp_100d_50k",
              "what": "solve_batched(backend='pdhg', compaction=%s)"
                      % compaction,
              "lps": lp.batch, "parent_wall_s": wall["parent"],
              "new_wall_s": wall["new"],
              "parent_segment_kernel_ms": kern.get("parent"),
              "new_segment_kernel_ms": kern.get("new"),
              "bitwise_equal": True})
        del first, res



# ---- the telemetry plane: per-LP counters through the segment kernels ----

# the lanes each engine books (obs/telemetry.py); the others stay zero
TEL_OWNED = {
    "tableau": ("phase1_iters", "phase2_iters", "phase1_pivots",
                "phase2_pivots", "bound_flips", "degenerate_pivots"),
    "revised": ("phase1_iters", "phase2_iters", "phase1_pivots",
                "phase2_pivots", "bound_flips", "degenerate_pivots",
                "refactorizations", "eta_len", "block_rotations"),
    "pdhg": ("phase2_iters", "restarts", "kkt_primal", "kkt_dual",
             "kkt_gap", "omega"),
}
# (run, segment kernel, solve_batched options)
TEL_RUNS = (
    ("tableau", "simplex_segment", {"compaction": True}),
    ("revised_dantzig", "revised_segment",
     {"backend": "revised", "pricing": "dantzig"}),
    ("revised_partial", "revised_segment",
     {"backend": "revised", "pricing": "partial"}),
    ("pdhg", "pdhg_segment", {"backend": "pdhg", "compaction": True}),
)
TABLEAU_SEGMENTS = 32   # the schedule's segments on lp_100d_50k (PERF.md)


def telemetry_main(lp100):
    """solve_batched on every LP of lp_100d_50k for each run of TEL_RUNS,
    in turns (off, on, on, off): on with telemetry=True, off without, each
    turn with a SpanTracer of its own.  An on turn launches only the
    counter-carrying segment kernel, an off turn only the counter-free
    one.  The first on turn's statuses, iterations, x and objectives equal
    the first off turn's; in it phase1_iters + phase2_iters equals the
    iterations of every LP, every int lane is >= 0, the lanes the engine
    does not own are 0, and the tracer holds one segment span per segment
    launch (32 for the tableau schedule).  Each turn's wall seconds and its
    span seconds by name are emitted: the flush sits in the bucket_gather
    spans and after the last segment, the counter launches in the segment
    spans.  Returns the counter-carrying launches by kernel."""
    import numpy as np
    from repro_torch.core import solve_batched
    from repro_torch.obs import SolveReport, SpanTracer
    from repro_torch.obs.telemetry import ALL_LANES, INT_LANES
    launches = {}
    for run, kernel, kw in TEL_RUNS:
        engine = run.split("_")[0]
        walls, span_s, first = {"off": [], "on": []}, {"off": [], "on": []}, {}
        for which in ("off", "on", "on", "off"):
            on = which == "on"
            tracer, stats = SpanTracer(), []
            zero_counts()
            t0 = time.perf_counter()
            res = solve_batched(lp100, telemetry=on, tracer=tracer,
                                stats_out=stats, **kw)
            walls[which].append(time.perf_counter() - t0)
            got = counts()
            tel = got[kernel + "_tel"]
            assert got[kernel] > 0 and tel == (got[kernel] if on else 0), (
                run, which, got)
            assert all(v == 0 for k, v in got.items()
                       if k not in (kernel, kernel + "_tel")), (run, got)
            spans = [s for root in tracer.roots for s in root.walk()]
            by_name = {}
            for sp in spans:
                by_name[sp.name] = by_name.get(sp.name, 0.0) + sp.dur_s
            span_s[which].append(by_name)
            if which in first:
                continue
            first[which] = res
            if not on:
                assert res.stats is None, (run, "stats without telemetry")
                continue
            assert same_result(res, first["off"]), (
                run, "telemetry changed a result")
            rep = res.stats
            assert isinstance(rep, SolveReport), run
            np.testing.assert_array_equal(rep.iterations, res.iterations)
            for lane in INT_LANES:
                assert (rep.lane(lane) >= 0).all(), (run, lane)
            for lane in ALL_LANES:
                if lane not in TEL_OWNED[engine]:
                    assert not rep.lane(lane).any(), (run, lane)
            segments = sum(s.name.startswith("segment[") for s in spans)
            if kw.get("compaction"):
                assert segments == tel == len(stats), (run, segments, tel)
            else:
                assert segments == 0 and tel == 1, (run, segments, tel)
            if run == "tableau":
                assert tel == TABLEAU_SEGMENTS, (run, tel)
            launches[kernel] = launches.get(kernel, 0) + tel
            emit({"solve_report": run, "summary": rep.summary()})
            run_tel, run_segments = tel, segments
            names = sorted({s.name for s in spans})
            del rep
        first.clear()
        del res
        mean = {w: {k: float(np.mean([t.get(k, 0.0) for t in span_s[w]]))
                    for k in names} for w in span_s}
        emit({"telemetry_main": run, "lps": lp100.batch,
              "order": ["off", "on", "on", "off"],
              "on_wall_s": walls["on"], "off_wall_s": walls["off"],
              "overhead_s": float(np.mean(walls["on"])
                                  - np.mean(walls["off"])),
              "span_s_on": mean["on"], "span_s_off": mean["off"],
              "launches": run_tel, "segment_spans": run_segments,
              "span_names": names,
              "equal_to_telemetry_off": True})
    return launches


def telemetry_kernels(name, lp, B=SLICE, kernels=("simplex", "revised",
                                                  "pdhg")):
    """One launch of each counter-carrying kernel of ``kernels`` on the
    first B LPs of ``lp`` (batch ``name``), from a mid-solve state whose
    counters the same kernel has made non-zero, against its plain version
    on the same state: every leaf, the counter lanes included, equal (NaN
    where NaN).  Returns a row per kernel: the variant the launch ran, the
    launch's and the plain version's ms and the bound of the work the
    launch did."""
    import torch
    from repro_torch.core.compaction import segment_pending
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.pdhg import default_pdhg_max_iters, pdhg_rounds
    from repro_torch.kernels import (pdhg_segment_tile,
                                     pdhg_segment_tile_plain,
                                     revised_segment_tile,
                                     revised_segment_tile_plain,
                                     segment_tile, segment_tile_plain)
    from repro_torch.kernels.ops import (KernelBackend, PdhgKernelBackend,
                                         RevisedKernelBackend)
    from repro_torch.kernels.revised_tile import variant as revised_variant
    m, n = lp.m, lp.n
    A, b, c, ub = _revised_slice(lp, B)
    mi = default_max_iters(m, n)
    rows = {}

    def check(kernel, variant, launch, plain, state, bound_of):
        assert any(bool(t.any()) for t in state.tel), (kernel, "counters 0")
        (got, it), ms = timed(lambda: launch(_clone(state)))
        (want, want_it), plain_ms = timed(lambda: plain(_clone(state)))
        assert torch.equal(it, want_it), (kernel, "steps differ")
        pairs = leaf_pairs(got, want)
        for leaf, g, w in pairs:
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name} {kernel} {leaf}")
        changed = [lane for lane, t0, t1 in zip(state.tel._fields, state.tel,
                                                got.tel)
                   if not torch.equal(t0, t1)]
        row = {"telemetry_kernel": kernel, "batch": name, "lps": B,
               "variant": variant, "steps": int(it.max()), "ms": ms,
               "plain_ms": plain_ms, "lanes_changed": changed,
               "max_abs_err": max_err((g, w) for _, g, w in pairs)}
        row.update(bound_of(state, got))
        emit(row)
        rows[kernel] = row
        return got

    def simplex_bound(before, after):
        work = (after.work - before.work).cpu().numpy()
        return bound(m, n, B, work, segment=True)

    if "simplex" in kernels:
        kb = KernelBackend(m, n, 1e-6, 1e-5)
        kw = dict(m=m, n=n, max_iters=mi)
        st, _ = segment_tile(kb.init(A, b, c, ub, telemetry=True), 8,
                             stage="p1", **kw)
        check("simplex_segment p1", simplex_variant(m, n, stage="p1"),
              lambda s: segment_tile(s, 8, stage="p1", **kw),
              lambda s: segment_tile_plain(s, 8, stage="p1", **kw), st,
              simplex_bound)
        while bool(segment_pending(st, "p1", mi).any()):
            st, _ = segment_tile(st, 32, stage="p1", **kw)
        st, _ = segment_tile(kb.compact_columns(st), 4, stage="p2", **kw)
        check("simplex_segment p2", simplex_variant(m, n, stage="p2"),
              lambda s: segment_tile(s, 8, stage="p2", **kw),
              lambda s: segment_tile_plain(s, 8, stage="p2", **kw), st,
              simplex_bound)
        del st

    def revised_bound_of(before, after):
        return revised_bound(m, n, B,
                             (after.work - before.work).cpu().numpy())

    for rule in REVISED_RULES if "revised" in kernels else ():
        rb = RevisedKernelBackend(m, n, 1e-6, 1e-5, pricing=rule)
        kw = dict(stage="p1", m=m, n=n, max_iters=mi,
                  refactor_period=rb.refactor_period, rule=rule)
        st, _ = revised_segment_tile(rb.init(A, b, c, ub, telemetry=True),
                                     8, **kw)
        check(f"revised_segment {rule}", revised_variant(m, n, tel=True),
              lambda s: revised_segment_tile(s, 8, **kw),
              lambda s: revised_segment_tile_plain(s, 8, **kw), st,
              revised_bound_of)
        del st

    def pdhg_bound_of(before, after):
        return pdhg_bound(m, n, B, (after.iters - before.iters).cpu())

    if "pdhg" in kernels:
        rounds = pdhg_rounds(default_pdhg_max_iters(m, n))
        pb = PdhgKernelBackend(m, n)
        st, _ = pdhg_segment_tile(pb.init(A, b, c, ub, telemetry=True), 3,
                                  m=m, n=n, max_rounds=rounds)
        check("pdhg_segment", pdhg_variant(m, n),
              lambda s: pdhg_segment_tile(s, 8, m=m, n=n,
                                          max_rounds=rounds),
              lambda s: pdhg_segment_tile_plain(s, 8, max_rounds=rounds), st,
              pdhg_bound_of)
        del st
    del A, b, c, ub
    torch.cuda.empty_cache()
    return rows


def telemetry_overhead(lp100):
    """Each counter-carrying kernel against its counter-free instantiation
    on all 50,000 LPs of lp_100d_50k, the launch alone (CUDA events around
    the C call), in turns (off, on, on, off) from one state: the simplex
    segment kernel's first p1 segment (32 steps), the revised kernel's
    whole solve (both rules), the PDHG segment kernel's first segment (68
    rounds); every state leaf but the counters equal between the two."""
    import numpy as np
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.pdhg import default_pdhg_max_iters, pdhg_rounds
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels import (pdhg_segment_tile, revised_segment_tile,
                                     segment_tile)
    from repro_torch.kernels.ops import (KernelBackend, PdhgKernelBackend,
                                         RevisedKernelBackend)
    m, n = lp100.m, lp100.n
    mi = default_max_iters(m, n)
    rows = {}

    def turns(name, module, names, state0, launch):
        lib = _TimedLaunches(getattr(_module(module), "_lib")(), names)
        ms, keep, checked = {"off": [], "on": []}, {}, False
        for which in ("off", "on", "on", "off"):
            state = _clone(state0)
            if which == "off":
                state = state._replace(tel=None)
            lib.events.clear()
            with kernel_library(module, lib):
                got, _ = launch(state)
            torch.cuda.synchronize()
            (start, end), = lib.events
            ms[which].append(start.elapsed_time(end))
            if not checked:
                keep.setdefault(which, got)
            del state, got
            if not checked and len(keep) == 2:
                # the first turn of each: every leaf but the counters equal
                off, on = (keep.pop(k)._replace(tel=None)
                           for k in ("off", "on"))
                for leaf, g, w in leaf_pairs(on, off):
                    torch.testing.assert_close(g, w, rtol=0, atol=0,
                                               equal_nan=True,
                                               msg=f"{name} {leaf}")
                del off, on
                checked = True
        on_ms, off_ms = float(np.mean(ms["on"])), float(np.mean(ms["off"]))
        row = {"telemetry_overhead": name, "lps": lp100.batch,
               "on_ms": ms["on"], "off_ms": ms["off"],
               "overhead_pct": 100.0 * (on_ms - off_ms) / off_ms,
               "equal_leaves": True}
        emit(row)
        rows[name] = row

    A, b, c, ub = batch_tensors(lp100, torch.device("cuda"))
    st = KernelBackend(m, n, 1e-6, 1e-5).init(A, b, c, ub, telemetry=True)
    turns("simplex_segment", "simplex_tile",
          ("simplex_segment_launch", "simplex_segment_tel_launch"), st,
          lambda s: segment_tile(s, 32, stage="p1", m=m, n=n,
                                 max_iters=mi))
    del st
    torch.cuda.empty_cache()
    for rule in REVISED_RULES:
        rb = RevisedKernelBackend(m, n, 1e-6, 1e-5, pricing=rule)
        st = rb.init(A, b, c, ub, telemetry=True)
        turns(f"revised_segment {rule}", "revised_tile",
              ("revised_segment_launch", "revised_segment_tel_launch"), st,
              lambda s: revised_segment_tile(
                  s, mi, stage="p2", m=m, n=n, max_iters=mi,
                  refactor_period=rb.refactor_period, rule=rule))
        del st
    rounds = pdhg_rounds(default_pdhg_max_iters(m, n))
    st = PdhgKernelBackend(m, n).init(A, b, c, ub, telemetry=True)
    turns("pdhg_segment", "pdhg_tile",
          ("pdhg_launch", "pdhg_segment_tel_launch"), st,
          lambda s: pdhg_segment_tile(s, max(4, rounds // 64), m=m, n=n,
                                      max_rounds=rounds))
    del st, A, b, c, ub
    torch.cuda.empty_cache()
    return rows


def _module(name):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


# The kernels line's rows of the counter-carrying instantiations: (name,
# source, the TPU kernel, telemetry_main's launch count, telemetry_kernels'
# row, telemetry_overhead's row).
TEL_KERNEL_ROWS = (
    ("simplex_segment_tel", "simplex_tile.cu",
     "src/repro/kernels/simplex_tile.py:494", "simplex_segment",
     "simplex_segment p1", "simplex_segment"),
    ("revised_segment_tel", "revised_tile.cu",
     "src/repro/kernels/revised_tile.py:221", "revised_segment",
     "revised_segment dantzig", "revised_segment dantzig"),
    ("pdhg_segment_tel", "pdhg_tile.cu",
     "src/repro/kernels/pdhg_tile.py:469", "pdhg_segment", "pdhg_segment",
     "pdhg_segment"),
)


def tel_instantiations(rows):
    """The ptxas rows of the counter-carrying instantiations among a
    source's (``ptxas_rows`` or ``pdhg_ptxas``): kTel is the last template
    argument of the segment kernels."""
    return [r for r in rows if r["kernel"].endswith("counters")
            or (r["kernel"].startswith(("simplex_segment_kernel<",
                                        "revised_segment_kernel<"))
                and r["kernel"].endswith(",1>"))]


def tel_kernel_row(name, src, line, launches, row, over, ptx, shapes):
    """One kernels-line entry of a counter-carrying instantiation: ms,
    plain ms and bound of its launch on the slice; beside them the launch
    alone on all 50,000 with and without counters, the registers and spill
    bytes of every counter-carrying instantiation of the source, and the
    launches against the plain version at every batch (``shapes``, rows
    of telemetry_kernels)."""
    tel = tel_instantiations(ptx)
    assert tel, (name, "no counter-carrying instantiation in ptxas")
    regs = [r["registers"] for r in tel]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": line, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "instantiation": "kTel (the counter rows in place)",
            "full_batch_on_ms": over["on_ms"],
            "full_batch_off_ms": over["off_ms"],
            "overhead_pct": over["overhead_pct"],
            "instantiations": len(tel), "registers": [min(regs), max(regs)],
            "spill_bytes": sum(r["spill_store_bytes"] + r["spill_load_bytes"]
                               for r in tel),
            "shapes": [{k: r[k] for k in (
                "telemetry_kernel", "batch", "variant", "lps", "ms",
                "plain_ms", "max_abs_err")} for r in shapes],
            "parity": "every leaf and counter lane equal to the plain "
                      "version from a mid-solve state with counters; "
                      "answers equal to the telemetry-off solve"}


# ---- falcon-mamba-7b serving (models/, csrc/ssm_scan.cu) ------------------

SERVE_ARCH = "falcon-mamba-7b"
SERVE_SEED = 2018
SERVE = {"batch": 4, "prompt_len": 1024, "gen": 32, "requests": 2}
SCAN_CHUNK = 512             # mamba_apply's chunk: two per 1,024-token prompt
ODD_SCANS = ((1, 8, 8, 2), (2, 16, 24, 4), (2, 33, 130, 16), (3, 7, 256, 16))


def scan_vs_plain(dA, dBx, h0):
    """One kernel launch against ssm_scan_plain on the same card tensors;
    returns the largest |kernel - plain| over hs and hT."""
    import torch
    from repro_torch.kernels import ssm_scan_bt_ds, ssm_scan_plain
    hs, hT = ssm_scan_bt_ds(dA, dBx, h0)
    want_hs, want_hT = ssm_scan_plain(dA, dBx, h0)
    torch.cuda.synchronize()
    assert torch.isfinite(hs).all() and torch.isfinite(hT).all()
    return max(float((hs - want_hs).abs().max()),
               float((hT - want_hT).abs().max()))


def kernel_profile(fn, top=6, match=None):
    """The device time of the kernels fn() launches, from torch.profiler
    tracing the device alone: (milliseconds summed over every kernel, the
    ``top`` largest by name with their milliseconds and counts), and with
    ``match`` a third item, the milliseconds of the kernels whose name
    holds it.  Host operators are not traced: their processing took 31 s
    for one hymba-1.5b prefill."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert kernels, "the profiler saw no device time"
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    out = (total, [{"kernel": e.key[:80],
                    "ms": e.self_device_time_total / 1e3,
                    "count": e.count} for e in kernels[:top]])
    if match is None:
        return out
    return out + (sum(e.self_device_time_total for e in kernels
                      if match in e.key) / 1e3,)


@contextlib.contextmanager
def scan_inputs_kept(calls):
    """Keep the (dA, dBx, h0) that mamba_apply hands the scan kernel in
    the calls numbered ``calls`` (from 0; layer l's chunk c of the first
    prefill is call l * chunks + c).  Yields {call: (dA, dBx, h0)}; the
    kernel runs and counts as it does without this."""
    from repro_torch.models import mamba
    real, kept, n = mamba.ssm_scan_bt_ds, {}, [0]

    def keep(dA, dBx, h0):
        if n[0] in calls:
            kept[n[0]] = (dA, dBx, h0)
        n[0] += 1
        return real(dA, dBx, h0)

    mamba.ssm_scan_bt_ds = keep
    try:
        yield kept
    finally:
        mamba.ssm_scan_bt_ds = real


def step_gap(model, prompts, n):
    """prefill(n - 1) then one decode step against prefill(n): the two
    last-position logits (float32, the real vocab)."""
    import torch
    V = model.cfg.vocab
    pos = torch.full((prompts.shape[0],), n - 1, device=prompts.device)
    _, caches = model.prefill(prompts[:, :n - 1])
    stepped, _ = model.decode_step(caches, prompts[:, n - 1], pos)
    whole, _ = model.prefill(prompts[:, :n])
    return stepped[:, :V].float(), whole[:, :V].float(), caches, pos


def logit_gap(got, want):
    """Largest |got - want| over the logit scale (max |want|), and the
    share of rows whose argmax agrees."""
    scale = float(want.abs().max())
    return {"max_abs_logit_diff": float((got - want).abs().max()),
            "logit_scale": scale,
            "max_rel_logit_diff": float((got - want).abs().max()) / scale,
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean())}


def serving():
    """falcon-mamba-7b at its published config (64 layers, bf16) served
    through repro_torch.launch.serve.serve with the config as shipped (the
    card always scans with the CUDA kernel); the kernel held against its
    plain version on the inputs the served run handed it and at odd
    shapes, prefill/decode consistency recorded and traced against a
    float32 twin, the kernel timed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_scan_bt_ds, ssm_scan_plain
    from repro_torch.launch.serve import serve, set_matmul_policy
    from repro_torch.models import build_model

    policy = set_matmul_policy()
    cfg = get_config(SERVE_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.param_dtype) == \
        (64, 4096, 8192, "bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED)     # drawn on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())

    # the first wave's second chunk in layers 0 and 63 (h0 != 0), kept as
    # the served run hands them to the kernel
    chunks = SERVE["prompt_len"] // SCAN_CHUNK
    last = cfg.n_layers - 1
    calls = {layer: layer * chunks + 1 for layer in (0, last)}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with scan_inputs_kept(set(calls.values())) as kept:
        res = serve(cfg, model, seed=SERVE_SEED, **SERVE)
    launches = only("ssm_scan")
    assert launches == cfg.n_layers * chunks * SERVE["requests"] == 256, \
        launches
    peak = torch.cuda.max_memory_allocated()
    real = {layer: kept[call] for layer, call in calls.items()}
    kept_bytes = sum(t.numel() * 4 for ins in real.values() for t in ins)
    tokens = res["tokens"]
    assert tokens.shape == (SERVE["requests"], SERVE["batch"], SERVE["gen"])
    assert ((tokens >= 0) & (tokens < cfg.vocab)).all()
    wave_tokens = SERVE["batch"] * SERVE["gen"]
    emit({"serve": SERVE_ARCH, "config": {
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
              "dt_rank": cfg.dt_rank, "vocab": cfg.vocab,
              "dtype": cfg.dtype},
          "params": n_params, "param_bytes": param_bytes,
          "init_on_card_s": init_s, **SERVE, "seed": SERVE_SEED,
          "matmul_policy": policy, "scan_launches": launches,
          "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"],
          "tokens_per_s_by_wave": [
              wave_tokens / (p + d)
              for p, d in zip(res["prefill_s"], res["decode_s"])],
          "ttft_s": res["prefill_s"], "prefill_s": res["prefill_s"],
          "decode_s": res["decode_s"],
          "decode_ms_per_token_step": [
              1e3 * d / (SERVE["gen"] - 1) for d in res["decode_s"]],
          "peak_device_bytes": peak,
          "peak_includes_kept_scan_input_bytes": kept_bytes,
          "sample_tokens": tokens[:, 0, :8].tolist()})

    rng = np.random.default_rng(SERVE_SEED)   # serve's first wave
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"])),
        dtype=torch.long, device="cuda")
    with torch.inference_mode():
        # the kernel against its plain version on the kept inputs
        errs = {}
        for layer, (dA, dBx, h0) in real.items():
            assert float(h0.abs().max()) > 0
            errs[f"layer{layer}"] = scan_vs_plain(dA, dBx, h0)
        for shape in ODD_SCANS:
            g = np.random.default_rng(shape[1])
            put = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                         device="cuda")
            B, T, d, s = shape
            errs[str(shape)] = scan_vs_plain(
                put(g.uniform(0.5, 1.0, (B, T, d, s))),
                put(g.normal(size=(B, T, d, s)) * 0.1),
                put(g.normal(size=(B, d, s)) * 0.1))
        max_err = max(errs.values())
        assert max_err == 0.0, errs

        # prefill(511) + one decode step against prefill(512): recorded,
        # not asserted, in bf16 at depth 64 (the CPU and card tests assert
        # it in float32).  The float32 twin computes the same function
        # with the same scan: its own gap shows what the decode path adds,
        # and its distance from the bf16 prefill what bf16 rounding does.
        n = SCAN_CHUNK
        stepped, whole, caches, pos = step_gap(model, prompts, n)
        consistency = {"bf16_decode_vs_prefill": logit_gap(stepped, whole)}
        twin = float32_cut(model, "cuda", model.cfg.n_layers)
        stepped32, whole32, _, _ = step_gap(twin, prompts, n)
        del twin
        torch.cuda.empty_cache()
        consistency["float32_decode_vs_prefill"] = logit_gap(stepped32,
                                                             whole32)
        consistency["bf16_vs_float32_prefill"] = logit_gap(whole, whole32)
        consistency["bf16_vs_float32_decode"] = logit_gap(stepped, stepped32)
        emit({"prefill_decode_consistency": consistency})

        # the kernels' device time in one decode step and in one 1,024-token
        # prefill; beside the served run's wall times (its last wave) they
        # give the share of the time the card was busy.  The profiled
        # prefill is wave 0's again: it must give wave 0's first tokens.
        step_ms, step_top = kernel_profile(
            lambda: model.decode_step(caches, prompts[:, n - 1], pos))
        again = []
        prefill_ms, prefill_top = kernel_profile(
            lambda: again.append(model.prefill(prompts)[0]))
        first_tok = again[0][:, :cfg.vocab].argmax(-1).cpu().numpy()
        del caches, stepped, whole, stepped32, whole32, again
    del model
    torch.cuda.empty_cache()

    # the kernel timed on layer 0's served inputs at the serving shape
    dA, dBx, h0 = real[0]
    del real, kept
    hs = torch.empty_like(dA)
    ms = timed_avg(lambda: ssm_scan_bt_ds(dA, dBx, h0))
    plain_ms = timed_avg(lambda: ssm_scan_plain(dA, dBx, h0), reps=3)
    yard_ms = timed_avg(lambda: torch.add(dA, dBx, out=hs))
    # dA, dBx and h0 read once, hs and hT written once (float32)
    B, T = dA.shape[:2]
    L = dA.shape[2] * dA.shape[3]
    nbytes = 4 * (3 * B * T * L + 2 * B * L)
    info = {"kernel": "ssm_scan", "shape": list(dA.shape),
            "first_token_reproduced": bool(
                (first_tok == tokens[0, :, 0]).all()),
            "kernel_vs_plain_max_abs_err": errs, "max_abs_err": max_err,
            "decode_step_kernel_ms": step_ms,
            "decode_busy_share": step_ms / (
                1e3 * res["decode_s"][-1] / (SERVE["gen"] - 1)),
            "decode_top_kernels": step_top,
            "prefill_kernel_ms": prefill_ms,
            "prefill_busy_share": prefill_ms / (1e3 * res["prefill_s"][-1]),
            "prefill_top_kernels": prefill_top,
            "ms": ms, "plain_ms": plain_ms, "yardstick_ms": yard_ms,
            "yardstick": "torch.add(dA, dBx, out=hs): the same bytes; no "
                         "PyTorch call computes the recurrence",
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "bound_by": "bytes", "launches": launches,
            "achieved_bytes_per_s": nbytes / (ms * 1e-3)}
    emit(info)
    del dA, dBx, h0, hs
    torch.cuda.empty_cache()
    return info


# ---- hymba-1.5b serving (models/attention.py, the hybrid block) ----------

HYMBA_ARCH = "hymba-1.5b"
HYMBA = {"batch": 4, "prompt_len": 2048, "gen": 32, "requests": 2}
# the float32 twin: its depth, one prompt, greedy steps on the card and the
# CPU, and the prefix that 512 decode steps extend across the window
TWIN = {"layers": 2, "prompt_len": 1536, "gen": 8, "prefix": 1024}
# logits of the twin, card against CPU and decode against prefill: float32
# products summed in other orders (cuBLAS, MKL; one row against many) over
# 2 full-width layers and 512 decode steps; logits are O(5)
TWIN_ATOL = 1e-3


def rows_before(prompts, extra=None):
    """The cache rows a prefill of ``prompts`` fills: a VLM's patches
    come first."""
    patches = (extra or {}).get("patches")
    return prompts.shape[1] + (0 if patches is None else patches.shape[1])


def greedy(model, prompts, steps, extra=None):
    """prefill (with the stub inputs ``extra`` on the prompts' device),
    the leaves decode writes padded, then ``steps`` greedy decode steps:
    the tokens (B, steps + 1) and the real-vocab logits of each
    (steps + 1, B, V) as float32 on the host."""
    import torch
    from repro_torch.launch.serve import pad_kv
    V = model.cfg.vocab
    B = prompts.shape[0]
    P = rows_before(prompts, extra)
    logits, caches = model.prefill(prompts, **(extra or {}))
    caches = pad_kv(caches, P + steps)
    seen = [logits[:, :V].float().cpu()]
    for g in range(steps):
        tok = logits[:, :V].argmax(-1)
        pos = torch.full((B,), P + g, dtype=torch.long, device=prompts.device)
        logits, caches = model.decode_step(caches, tok, pos)
        seen.append(logits[:, :V].float().cpu())
    out = torch.stack(seen)
    return out.argmax(-1).T, out


def float32_cut(model, device, layers, vocab=None, **changes):
    """The first ``layers`` layers of ``model`` in float32 on ``device``
    (its bf16 parameters widened exactly), its config otherwise changed
    by ``changes``; with ``vocab``, the embedding's first ``vocab`` rows
    and the head's first ``vocab`` columns."""
    import torch
    cfg = dataclasses.replace(model.cfg, n_layers=layers,
                              vocab=vocab or model.cfg.vocab,
                              dtype="float32", param_dtype="float32",
                              **changes)
    # an LM or an EncDecLM, uninitialized, then copied
    twin = type(model)(cfg, device=torch.device(device))
    src = dict(model.named_parameters())
    with torch.no_grad():
        for name, dst in twin.named_parameters():
            cut = src[name][tuple(slice(0, d) for d in dst.shape)]
            assert cut.shape == dst.shape, name
            assert cut.shape == src[name].shape or \
                name in ("embed.table", "head.w"), name
            dst.copy_(cut)
    return twin


def reconfigure(lm, **changes):
    """Point ``lm`` and its blocks at its config with ``changes``: flags
    the forward pass reads (lp_capacity, capacity_factor), no
    parameter."""
    cfg = dataclasses.replace(lm.cfg, **changes)
    lm.cfg = cfg
    for block in lm.blocks:
        block.cfg = cfg


def card_vs_cpu(card, cpu, prompt, steps, extra=None):
    """One prompt (with the stub inputs ``extra``, on the host) and
    ``steps`` greedy decode steps through the twin on the card and on the
    CPU: equal tokens, and the largest logit difference."""
    import torch
    extra = extra or {}
    t0 = time.perf_counter()
    tok_card, logit_card = greedy(card, prompt.cuda(), steps,
                                  {k: v.cuda() for k, v in extra.items()})
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok_cpu, logit_cpu = greedy(cpu, prompt, steps, extra)
    cpu_s = time.perf_counter() - t0
    return {"card_tokens": tok_card[0].tolist(),
            "card_vs_cpu_tokens_equal": bool(torch.equal(tok_card, tok_cpu)),
            "card_vs_cpu_max_abs_err": float((logit_card - logit_cpu)
                                             .abs().max()),
            "card_greedy_s": card_s, "cpu_greedy_s": cpu_s}


def decode_vs_prefill(card, prompt, prefix, extra=None):
    """On the card: prefill(prompt[:prefix]) (with the stub inputs
    ``extra``), then decode steps to the prompt's end, against one
    prefill of the whole prompt."""
    import torch
    from repro_torch.launch.serve import pad_kv
    ids = prompt.cuda()
    extra = {k: v.cuda() for k, v in (extra or {}).items()}
    P = ids.shape[1]
    shift = rows_before(ids, extra) - P    # a VLM's patches
    t0 = time.perf_counter()
    _, caches = card.prefill(ids[:, :prefix], **extra)
    caches = pad_kv(caches, P + shift)
    for p in range(prefix, P):
        stepped, caches = card.decode_step(
            caches, ids[:, p], torch.full((1,), p + shift, device="cuda"))
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    whole, _ = card.prefill(ids, **extra)
    V = card.cfg.vocab
    return {"decode_steps": P - prefix, "prefix": prefix,
            "decode_vs_prefill_max_abs_err": float(
                (stepped[:, :V] - whole[:, :V]).abs().max()),
            "logit_scale": float(whole[:, :V].abs().max()),
            "card_decode_steps_s": steps_s}


def twin_prompt(cfg, n):
    import torch
    gen = torch.Generator().manual_seed(SERVE_SEED)
    return torch.randint(0, cfg.vocab, (1, n), generator=gen)


def hymba_twin_checks(model):
    """The float32 twin on the card against the CPU (greedy tokens equal,
    logits within TWIN_ATOL) and, on the card, prefill(prefix) followed
    by decode steps to the prompt's end against one prefill of it."""
    import torch
    card = float32_cut(model, "cuda", TWIN["layers"], ssm_impl="kernel")
    cpu = float32_cut(card, "cpu", TWIN["layers"])
    prompt = twin_prompt(model.cfg, TWIN["prompt_len"])
    with torch.inference_mode():
        info = {"twin_layers": TWIN["layers"],
                "prompt_len": TWIN["prompt_len"],
                "greedy_steps": TWIN["gen"], "tolerance": TWIN_ATOL,
                **card_vs_cpu(card, cpu, prompt, TWIN["gen"]),
                **decode_vs_prefill(card, prompt, TWIN["prefix"])}
    emit({"hymba_float32_twin": info})
    assert info["card_vs_cpu_tokens_equal"], info
    assert info["card_vs_cpu_max_abs_err"] <= TWIN_ATOL and \
        info["decode_vs_prefill_max_abs_err"] <= TWIN_ATOL, info
    del card, cpu
    return info


def serving_hymba():
    """hymba-1.5b at its published config served through
    repro_torch.launch.serve.serve (module docstring); returns the scan
    kernel's row at the hybrid's shape."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_scan_bt_ds, ssm_scan_plain
    from repro_torch.launch.serve import pad_kv, serve, set_matmul_policy
    from repro_torch.models import build_model

    policy = set_matmul_policy()
    cfg = get_config(HYMBA_ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab,
            cfg.sliding_window, cfg.d_inner, cfg.q_chunk, cfg.kv_chunk,
            cfg.param_dtype) == ("hybrid", 32, 1600, 25, 5, 64, 5504, 32001,
                                 1024, 3200, 256, 512, "bfloat16")
    assert HYMBA["prompt_len"] > cfg.sliding_window
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED)     # drawn on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())

    # the first wave's last chunk in layers 0 and 31, as the served run
    # hands them to the kernel
    chunks = HYMBA["prompt_len"] // SCAN_CHUNK
    last = cfg.n_layers - 1
    calls = {layer: layer * chunks + chunks - 1 for layer in (0, last)}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with phase("serving_hymba.serve"), \
            scan_inputs_kept(set(calls.values())) as kept:
        res = serve(cfg, model, seed=SERVE_SEED, **HYMBA)
    launches = only("ssm_scan")
    assert launches == cfg.n_layers * chunks * HYMBA["requests"] == 256, \
        launches
    peak = torch.cuda.max_memory_allocated()
    real = {layer: kept[call] for layer, call in calls.items()}
    kept_bytes = sum(t.numel() * 4 for ins in real.values() for t in ins)
    tokens = res["tokens"]
    assert tokens.shape == (HYMBA["requests"], HYMBA["batch"], HYMBA["gen"])
    assert ((tokens >= 0) & (tokens < cfg.vocab)).all()
    wave_tokens = HYMBA["batch"] * HYMBA["gen"]
    emit({"serve": HYMBA_ARCH, "config": {
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
              "d_head": cfg.d_head, "d_ff": cfg.d_ff,
              "sliding_window": cfg.sliding_window,
              "q_chunk": cfg.q_chunk, "kv_chunk": cfg.kv_chunk,
              "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
              "dt_rank": cfg.dt_rank, "vocab": cfg.vocab,
              "dtype": cfg.dtype},
          "params": n_params, "param_bytes": param_bytes,
          "init_on_card_s": init_s, **HYMBA, "seed": SERVE_SEED,
          "matmul_policy": policy, "scan_launches": launches,
          "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"],
          "tokens_per_s_by_wave": [
              wave_tokens / (p + d)
              for p, d in zip(res["prefill_s"], res["decode_s"])],
          "ttft_s": res["prefill_s"], "prefill_s": res["prefill_s"],
          "decode_s": res["decode_s"],
          "decode_ms_per_token_step": [
              1e3 * d / (HYMBA["gen"] - 1) for d in res["decode_s"]],
          "peak_device_bytes": peak,
          "peak_includes_kept_scan_input_bytes": kept_bytes,
          "sample_tokens": tokens[:, 0, :8].tolist()})

    with phase("serving_hymba.profiles"), torch.inference_mode():
        errs = {}
        for layer, (dA, dBx, h0) in real.items():
            assert float(h0.abs().max()) > 0
            errs[f"layer{layer}"] = scan_vs_plain(dA, dBx, h0)
        max_err = max(errs.values())
        assert max_err == 0.0, errs

        # the kernels' device time in one decode step at the served
        # length and in one 2,048-token prefill (wave 0's again: it must
        # give wave 0's first tokens)
        rng = np.random.default_rng(SERVE_SEED)   # serve's first wave
        prompts = torch.as_tensor(
            rng.integers(0, cfg.vocab, (HYMBA["batch"],
                                        HYMBA["prompt_len"])),
            dtype=torch.long, device="cuda")
        again = []
        t0 = time.perf_counter()
        prefill_ms, prefill_top = kernel_profile(
            lambda: again.append(model.prefill(prompts)), top=8)
        profile_s = time.perf_counter() - t0
        logits, caches = again.pop()
        first_tok = logits[:, :cfg.vocab].argmax(-1).cpu().numpy()
        caches = pad_kv(caches, HYMBA["prompt_len"] + HYMBA["gen"])
        pos = torch.full((HYMBA["batch"],), HYMBA["prompt_len"],
                         device="cuda")
        step_ms, step_top = kernel_profile(
            lambda: model.decode_step(caches, prompts[:, 0], pos), top=8)
        del logits, caches, again
    with phase("serving_hymba.twin"):
        twin = hymba_twin_checks(model)
    del model
    torch.cuda.empty_cache()

    # the kernel timed on layer 0's served inputs at the hybrid's shape
    dA, dBx, h0 = real[0]
    del real, kept
    hs = torch.empty_like(dA)
    ms = timed_avg(lambda: ssm_scan_bt_ds(dA, dBx, h0))
    plain_ms = timed_avg(lambda: ssm_scan_plain(dA, dBx, h0), reps=3)
    yard_ms = timed_avg(lambda: torch.add(dA, dBx, out=hs))
    B, T = dA.shape[:2]
    L = dA.shape[2] * dA.shape[3]
    nbytes = 4 * (3 * B * T * L + 2 * B * L)
    info = {"kernel": "ssm_scan", "arch": HYMBA_ARCH,
            "shape": list(dA.shape),
            "first_token_reproduced": bool(
                (first_tok == tokens[0, :, 0]).all()),
            "kernel_vs_plain_max_abs_err": errs, "max_abs_err": max_err,
            "decode_step_kernel_ms": step_ms,
            "decode_busy_share": step_ms / (
                1e3 * res["decode_s"][-1] / (HYMBA["gen"] - 1)),
            "decode_top_kernels": step_top,
            "prefill_kernel_ms": prefill_ms,
            "prefill_busy_share": prefill_ms / (1e3 * res["prefill_s"][-1]),
            "prefill_top_kernels": prefill_top,
            "prefill_profile_s": profile_s,
            "ms": ms, "plain_ms": plain_ms, "yardstick_ms": yard_ms,
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "bound_by": "bytes", "launches": launches,
            "achieved_bytes_per_s": nbytes / (ms * 1e-3),
            "twin_card_vs_cpu_max_abs_err": twin["card_vs_cpu_max_abs_err"],
            "twin_decode_vs_prefill_max_abs_err":
                twin["decode_vs_prefill_max_abs_err"]}
    emit(info)
    del dA, dBx, h0, hs
    torch.cuda.empty_cache()
    return info


# ---- qwen3-32b and llama4-scout-17b-a16e serving (models/moe.py) ---------

DENSE_ARCH = "qwen3-32b"
MOE_ARCH = "llama4-scout-17b-a16e"
GQA_SERVE = {"batch": 4, "prompt_len": 2048, "gen": 32, "requests": 2}
# qwen3-32b's depth: 16 of 64 layers (0.81 GB each): the whole model
# served in 21 s of a 1,145 s run on a slow host, and the run must stay
# under 1,200 s with training on a mesh added
DENSE_LAYERS = 16
# llama4-scout's depth: 12 of 48 layers (4.43 GB each, 57.2 GB with the
# embedding and head): the layers one card holds as one stage of a
# four-stage pipeline; all 48 are 217 GB
MOE_LAYERS = 12
# the float32 twins: depth, vocabulary (the MoE twin's embedding and head
# cut to their first 32,000 rows and columns), one prompt, greedy steps on
# the card and the CPU, and the prefix that decode steps extend
DENSE_TWIN = {"layers": 2, "vocab": None, "prompt_len": 1024, "gen": 8,
              "prefix": 1016}
# (the MoE and MLA twins' prompt was 1,024 tokens until the smoke's time
# budget halved it: their CPU runs took 21-38 s)
MOE_TWIN = {"layers": 1, "vocab": 32_000, "prompt_len": 512, "gen": 8,
            "prefix": 504}
SERVE_CONFIG_KEYS = ("family", "n_layers", "d_model", "n_heads",
                     "n_heads_padded", "n_kv_heads", "d_head", "d_ff",
                     "mlp_kind", "qk_norm", "n_experts", "top_k",
                     "n_shared_experts", "d_ff_expert", "capacity_factor",
                     "lp_capacity", "vocab", "rope_theta", "q_chunk",
                     "kv_chunk", "dtype")


@contextlib.contextmanager
def routes_kept(inputs=False):
    """Keep every ``Routing`` that models/moe.py's ``route`` returns, in
    call order (with ``inputs``, each call's x and router too).  Yields
    the list; the layer runs, and its router launches, as without this."""
    from repro_torch.models import moe
    real, kept = moe.route, []

    def keep(x, router, cfg, capacity):
        r = real(x, router, cfg, capacity)
        kept.append((r, (x, router, capacity)) if inputs else r)
        return r

    moe.route = keep
    try:
        yield kept
    finally:
        moe.route = real


def serve_line(arch, cfg, model, res, policy, init_s, peak, load=GQA_SERVE,
               keys=SERVE_CONFIG_KEYS, **extra):
    """Print and return the serving line of ``res`` (``serve``'s result
    on ``load``), with the config's fields ``keys``."""
    wave_tokens = load["batch"] * load["gen"]
    line = {"serve": arch,
            "config": {k: getattr(cfg, k) for k in keys},
            "params": sum(p.numel() for p in model.parameters()),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
            "init_on_card_s": init_s, **load, "seed": SERVE_SEED,
            "matmul_policy": policy, "tokens_per_s": res["tokens_per_s"],
            "wall_s": res["wall_s"],
            "tokens_per_s_by_wave": [
                wave_tokens / (p + d)
                for p, d in zip(res["prefill_s"], res["decode_s"])],
            "ttft_s": res["prefill_s"], "prefill_s": res["prefill_s"],
            "decode_s": res["decode_s"],
            "decode_ms_per_token_step": [
                1e3 * d / (load["gen"] - 1) for d in res["decode_s"]],
            "peak_device_bytes": peak,
            "sample_tokens": res["tokens"][:, 0, :8].tolist(), **extra}
    emit(line)
    return line


def draw_on_card(cfg):
    """build_model(cfg) from the serving seed on the card, and the
    seconds it took."""
    import torch
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def check_served(res, cfg, load):
    tokens = res["tokens"]
    assert tokens.shape == (load["requests"], load["batch"], load["gen"])
    assert ((tokens >= 0) & (tokens < cfg.vocab)).all()


def serve_profiles(model, res, match=None, load=GQA_SERVE):
    """The kernels' device time in one prefill of the served run's first
    wave (again, its stub inputs included: it should give that wave's
    first tokens) and in one decode step at the served length, with the
    busy shares against the served run's last wave; with ``match``, the
    time of the kernels whose name holds it too."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import pad_kv, stub_inputs
    cfg = model.cfg
    B, P = load["batch"], load["prompt_len"]
    rng = np.random.default_rng(SERVE_SEED)   # serve's first wave
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                              dtype=torch.long, device="cuda")
    extra = {k: v.cuda() for k, v in stub_inputs(
        cfg, rng, B, load.get("n_frames", P)).items()}
    P = rows_before(prompts, extra)
    again = []
    t0 = time.perf_counter()
    prefill = kernel_profile(
        lambda: again.append(model.prefill(prompts, **extra)), top=8,
        match=match)
    profile_s = time.perf_counter() - t0
    logits, caches = again.pop()
    first_tok = logits[:, :cfg.vocab].argmax(-1).cpu().numpy()
    caches = pad_kv(caches, P + load["gen"])
    pos = torch.full((B,), P, device="cuda")
    step = kernel_profile(
        lambda: model.decode_step(caches, prompts[:, 0], pos), top=8,
        match=match)
    del logits, caches, again
    step_wall_ms = 1e3 * res["decode_s"][-1] / (load["gen"] - 1)
    info = {"first_token_reproduced": bool(
                (first_tok == res["tokens"][0, :, 0]).all()),
            "prefill_kernel_ms": prefill[0],
            "prefill_busy_share": prefill[0] / (1e3 * res["prefill_s"][-1]),
            "prefill_top_kernels": prefill[1],
            "prefill_profile_s": profile_s,
            "decode_step_kernel_ms": step[0],
            "decode_busy_share": step[0] / step_wall_ms,
            "decode_top_kernels": step[1]}
    if match is not None:
        info.update({f"prefill_{match}_ms": prefill[2],
                     f"decode_step_{match}_ms": step[2],
                     f"decode_step_{match}_share_of_wall":
                         step[2] / step_wall_ms})
    return info


def serving_dense():
    """qwen3-32b at its published width, DENSE_LAYERS of 64 layers,
    served through repro_torch.launch.serve.serve (module docstring): no
    custom kernel launches; its float32 twin on the card against the
    CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, set_matmul_policy

    policy = set_matmul_policy()
    published = get_config(DENSE_ARCH)
    assert (published.family, published.n_layers, published.d_model,
            published.n_heads, published.n_kv_heads, published.d_head,
            published.qk_norm, published.mlp_kind, published.d_ff,
            published.vocab, published.rope_theta,
            published.param_dtype) == \
        ("dense", 64, 5120, 64, 8, 128, True, "swiglu", 25600, 151936, 1e6,
         "bfloat16")
    cfg = dataclasses.replace(published, n_layers=DENSE_LAYERS)
    model, init_s = draw_on_card(cfg)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with phase("serving_dense.serve"):
        res = serve(cfg, model, seed=SERVE_SEED, **GQA_SERVE)
    launched = counts()
    assert not any(launched.values()), launched   # no custom kernel
    peak = torch.cuda.max_memory_allocated()
    check_served(res, cfg, GQA_SERVE)
    line = serve_line(DENSE_ARCH, cfg, model, res, policy, init_s, peak,
                      custom_kernel_launches=launched,
                      published_n_layers=published.n_layers)
    with phase("serving_dense.profiles"), torch.inference_mode():
        prof = serve_profiles(model, res)
    emit({"serve_profile": DENSE_ARCH, **prof})

    with phase("serving_dense.twin"), torch.inference_mode():
        spec = DENSE_TWIN
        cpu = float32_cut(model, "cpu", spec["layers"], spec["vocab"])
        del model
        torch.cuda.empty_cache()
        card = float32_cut(cpu, "cuda", spec["layers"])
        prompt = twin_prompt(card.cfg, spec["prompt_len"])
        twin = {"twin_layers": spec["layers"],
                "prompt_len": spec["prompt_len"],
                "greedy_steps": spec["gen"], "tolerance": TWIN_ATOL,
                **card_vs_cpu(card, cpu, prompt, spec["gen"]),
                **decode_vs_prefill(card, prompt, spec["prefix"])}
        emit({"dense_float32_twin": twin})
        assert twin["card_vs_cpu_tokens_equal"], twin
        assert twin["card_vs_cpu_max_abs_err"] <= TWIN_ATOL and \
            twin["decode_vs_prefill_max_abs_err"] <= TWIN_ATOL, twin
        del card, cpu
    torch.cuda.empty_cache()
    return {**line, **prof, "twin": twin}


def kept_shares(routes, layers, steps):
    """The share of routed tokens kept, per wave, in prefill and in
    decode: ``routes`` in call order, each wave a prefill call a layer and
    then ``steps`` decode steps of a call a layer."""
    per_wave = layers * (1 + steps)
    out = []
    for w in range(len(routes) // per_wave):
        wave = routes[w * per_wave:(w + 1) * per_wave]
        share = [float(sum(int(r.keep.sum()) for r in part))
                 / sum(r.keep.numel() for r in part)
                 for part in (wave[:layers], wave[layers:])]
        out.append({"prefill": share[0], "decode": share[1]})
    return out


def caps_vs_plain(r, capacity):
    """The caps a served call's router solved on the card against the
    plain version's solve of the same demand on the CPU: the largest
    |difference| (0.0 when bit-equal)."""
    from repro_torch.core import expert_capacity_lp
    N = r.keep.numel()
    want = expert_capacity_lp(r.demand.cpu(), total_slots=float(N),
                              c_max=float(capacity))[0]
    return float((r.caps.cpu() - want).abs().max())


def routing_margins(kept):
    """Over the calls ``routes_kept(inputs=True)`` kept: the smallest gap
    between a token's top-1 and top-2 router probabilities, and the
    smallest |cap - slot| of a (token, choice) pair with lp_capacity."""
    import torch
    gap, margin = float("inf"), float("inf")
    for r, (x, router, _) in kept:
        probs = torch.softmax((x @ router).float(), dim=-1)
        top2 = torch.sort(probs, dim=-1, descending=True).values[:, :2]
        gap = min(gap, float((top2[:, 0] - top2[:, 1]).min()))
        if r.caps is not None:
            margin = min(margin, float((r.caps[r.expert] - r.slot)
                                       .abs().min()))
    return gap, None if margin == float("inf") else margin


def moe_twin_run(card, cpu, prompt, steps):
    """card_vs_cpu with the routing of every MoE call kept: expert, slot
    and keep compared call for call, card against CPU."""
    import torch
    with routes_kept(inputs=True) as kept:
        run = card_vs_cpu(card, cpu, prompt, steps)
    n = cpu.cfg.n_layers * (1 + steps)
    assert len(kept) == 2 * n                  # the card's calls, the CPU's
    on_card, on_cpu = kept[:n], kept[n:]
    same = all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
               for (a, _), (b, _) in zip(on_card, on_cpu)
               for f in ("expert", "slot", "keep"))
    gap, margin = routing_margins(on_card)
    return {**run, "card_vs_cpu_routing_equal": same, "routing_calls": n,
            "min_top1_top2_prob_gap": gap, "min_abs_cap_minus_slot": margin,
            "kept_share_card": float(sum(int(r.keep.sum())
                                         for r, _ in on_card))
            / sum(r.keep.numel() for r, _ in on_card)}


def serving_moe():
    """llama4-scout-17b-a16e at its published width, 12 of 48 layers,
    with the LP capacity router, served through
    repro_torch.launch.serve.serve (module docstring): every MoE layer
    call launches the whole-solve simplex kernel once; returns the
    launches and the router's checks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, set_matmul_policy
    from repro_torch.models import moe

    policy = set_matmul_policy()
    published = get_config(MOE_ARCH)
    assert (published.family, published.n_layers, published.d_model,
            published.n_heads, published.n_heads_padded,
            published.n_kv_heads, published.d_head, published.n_experts,
            published.d_ff_expert, published.top_k,
            published.n_shared_experts, published.vocab,
            published.rope_theta, published.q_chunk, published.kv_chunk,
            published.param_dtype, published.lp_capacity) == \
        ("moe", 48, 5120, 40, 48, 8, 128, 16, 8192, 1, 1, 202048, 5e5,
         2048, 2048, "bfloat16", False)
    cfg = dataclasses.replace(published, n_layers=MOE_LAYERS,
                              lp_capacity=True)
    model, init_s = draw_on_card(cfg)
    load = GQA_SERVE
    steps = load["gen"] - 1
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with phase("serving_moe.serve"), routes_kept() as routes:
        res = serve(cfg, model, seed=SERVE_SEED, **load)
    launches = only("simplex_tile")
    want = cfg.n_layers * (1 + steps) * load["requests"]
    assert launches == want == 768, (launches, want)
    peak = torch.cuda.max_memory_allocated()
    assert len(routes) == launches
    check_served(res, cfg, load)

    # the router's caps in layer 0's first prefill and layer 11's last
    # decode step, solved again by the plain version on the CPU
    E, K = cfg.n_experts, cfg.top_k
    cap_of = {n: moe._capacity(n, K, E, cfg.capacity_factor)
              for n in (load["batch"] * load["prompt_len"], load["batch"])}
    first, last = routes[0], routes[-1]
    caps_err = {"layer0_prefill": caps_vs_plain(
                    first, cap_of[first.keep.numel() // K]),
                "layer11_last_decode": caps_vs_plain(
                    last, cap_of[last.keep.numel() // K])}
    assert max(caps_err.values()) == 0.0, caps_err
    shares = kept_shares(routes, cfg.n_layers, steps)
    del routes, first, last
    line = serve_line(MOE_ARCH, cfg, model, res, policy, init_s, peak,
                      published_layers=published.n_layers,
                      simplex_launches=launches,
                      router_caps_vs_plain_max_abs_err=caps_err,
                      kept_share_by_wave=shares)

    # one decode-shaped layer call with host synchronization forbidden
    with phase("serving_moe.sync_free"), torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
        x = torch.randn((load["batch"], 1, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        mlp = model.blocks[0].mlp
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = moe.moe_apply(mlp, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert out.shape == x.shape and torch.isfinite(out).all()
        del x, out

    with phase("serving_moe.profiles"), torch.inference_mode():
        prof = serve_profiles(model, res, match="simplex")
    emit({"serve_profile": MOE_ARCH, **prof})

    with phase("serving_moe.twin"), torch.inference_mode():
        spec = MOE_TWIN
        cpu = float32_cut(model, "cpu", spec["layers"], spec["vocab"])
        del model, mlp
        torch.cuda.empty_cache()
        card = float32_cut(cpu, "cuda", spec["layers"])
        prompt = twin_prompt(card.cfg, spec["prompt_len"])
        twin = {"twin_layers": spec["layers"], "vocab": spec["vocab"],
                "prompt_len": spec["prompt_len"],
                "greedy_steps": spec["gen"], "tolerance": TWIN_ATOL}
        for lp in (True, False):
            for lm in (card, cpu):
                reconfigure(lm, lp_capacity=lp)
            twin[f"lp_capacity_{lp}"] = run = moe_twin_run(
                card, cpu, prompt, spec["gen"])
            assert run["card_vs_cpu_routing_equal"], run
            assert run["card_vs_cpu_tokens_equal"], run
            assert run["card_vs_cpu_max_abs_err"] <= TWIN_ATOL, run
        # capacity drops make routing depend on the batch: decode against
        # prefill with none, as the reference's test_decode_matches_prefill
        reconfigure(card, lp_capacity=False, capacity_factor=100.0)
        twin.update(decode_vs_prefill(card, prompt, spec["prefix"]))
        emit({"moe_float32_twin": twin})
        assert twin["decode_vs_prefill_max_abs_err"] <= TWIN_ATOL, twin
        del card, cpu
    torch.cuda.empty_cache()
    return {**line, **prof, "twin": twin, "launches": launches}


# ---- deepseek-v2-236b (MLA), whisper-small (encdec), phi-3-vision (VLM) --

MLA_ARCH = "deepseek-v2-236b"
ENCDEC_ARCH = "whisper-small"
VLM_ARCH = "phi-3-vision-4.2b"
# deepseek-v2's depth: 6 of 60 layers (7.94 GB each, 49.8 GB with the
# embedding and head): one stage of a ten-stage pipeline; all 60 are 479 GB
MLA_LAYERS = 6
# Whisper's 30 s window (1,500 frames) under a 64-token prompt, within its
# 448-token decoder context
ENCDEC_SERVE = {"batch": 4, "prompt_len": 64, "gen": 32, "requests": 2,
                "n_frames": 1500}
# 256 patches before 1,792 text tokens: 2,048 rows, as the GQA cells
VLM_SERVE = {"batch": 4, "prompt_len": 1792, "gen": 32, "requests": 2}
# the twins: whisper whole, on one 1,500-frame window; phi-3 2 layers,
# its 256 patches before the prompt
ENCDEC_TWIN = {"prompt_len": 64, "gen": 8, "prefix": 32, "n_frames": 1500}
VLM_TWIN = {"layers": 2, "prompt_len": 1024, "gen": 8, "prefix": 1016}
SERVE_CONFIG_KEYS_MLA = SERVE_CONFIG_KEYS + (
    "attn_kind", "kv_lora", "q_lora", "qk_nope_dim", "qk_rope_dim",
    "v_head_dim")
SERVE_CONFIG_KEYS_ENCDEC = SERVE_CONFIG_KEYS + (
    "n_encoder_layers", "n_kv_heads_padded", "norm_kind", "use_rope",
    "tie_embeddings")


def twin_inputs(cfg, n_frames=1):
    """The twin's stub inputs (batch 1; ``n_frames`` frames for the
    encdec family), on the host: serve's draw from the serving seed."""
    import numpy as np
    from repro_torch.launch.serve import stub_inputs
    return stub_inputs(cfg, np.random.default_rng(SERVE_SEED), 1, n_frames)


def serving_mla():
    """deepseek-v2-236b at its published width, 6 of 60 layers, with the
    LP capacity router at E = 160, served through
    repro_torch.launch.serve.serve (module docstring): every MoE layer
    call launches the whole-solve simplex kernel once; returns the
    launches and the router's checks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, set_matmul_policy
    from repro_torch.models import moe

    policy = set_matmul_policy()
    published = get_config(MLA_ARCH)
    assert (published.family, published.attn_kind, published.n_layers,
            published.d_model, published.n_heads, published.kv_lora,
            published.q_lora, published.qk_nope_dim, published.qk_rope_dim,
            published.v_head_dim, published.n_experts, published.top_k,
            published.n_shared_experts, published.d_ff_expert,
            published.vocab, published.param_dtype,
            published.lp_capacity) == \
        ("moe", "mla", 60, 5120, 128, 512, 1536, 128, 64, 128, 160, 6, 2,
         1536, 102400, "bfloat16", False)
    cfg = dataclasses.replace(published, n_layers=MLA_LAYERS,
                              lp_capacity=True)
    model, init_s = draw_on_card(cfg)
    load = GQA_SERVE
    steps = load["gen"] - 1
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with phase("serving_mla.serve"), routes_kept() as routes:
        res = serve(cfg, model, seed=SERVE_SEED, **load)
    launches = only("simplex_tile")
    want = cfg.n_layers * (1 + steps) * load["requests"]
    assert launches == want == 384, (launches, want)
    peak = torch.cuda.max_memory_allocated()
    assert len(routes) == launches
    check_served(res, cfg, load)

    # the router's caps in layer 0's first prefill and layer 5's last
    # decode step, solved again by the plain version on the CPU
    E, K = cfg.n_experts, cfg.top_k
    cap_of = {n: moe._capacity(n, K, E, cfg.capacity_factor)
              for n in (load["batch"] * load["prompt_len"], load["batch"])}
    first, last = routes[0], routes[-1]
    caps_err = {"layer0_prefill": caps_vs_plain(
                    first, cap_of[first.keep.numel() // K]),
                "layer5_last_decode": caps_vs_plain(
                    last, cap_of[last.keep.numel() // K])}
    assert max(caps_err.values()) == 0.0, caps_err
    shares = kept_shares(routes, cfg.n_layers, steps)
    del routes, first, last
    line = serve_line(MLA_ARCH, cfg, model, res, policy, init_s, peak,
                      keys=SERVE_CONFIG_KEYS_MLA,
                      published_layers=published.n_layers,
                      simplex_launches=launches,
                      router_caps_vs_plain_max_abs_err=caps_err,
                      kept_share_by_wave=shares)

    # one decode-shaped layer call with host synchronization forbidden
    with phase("serving_mla.sync_free"), torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
        x = torch.randn((load["batch"], 1, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        mlp = model.blocks[0].mlp
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = moe.moe_apply(mlp, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert out.shape == x.shape and torch.isfinite(out).all()
        del x, out, mlp

    with phase("serving_mla.profiles"), torch.inference_mode():
        prof = serve_profiles(model, res, match="simplex")
    prof["decode_step_simplex_share_of_kernels"] = \
        prof["decode_step_simplex_ms"] / prof["decode_step_kernel_ms"]
    emit({"serve_profile": MLA_ARCH, **prof})

    # the card-against-CPU runs of this twin (about 30 s, the CPU's
    # forward over 160 experts at full width) are cut for the run's time
    # limit: the reduced deepseek-v2 trains card against CPU
    # (training_families.mla_twin) and llama4-scout's MoE twin holds the
    # router's card-against-CPU routing
    with phase("serving_mla.twin"), torch.inference_mode():
        spec = MOE_TWIN
        card = float32_cut(model, "cuda", spec["layers"], spec["vocab"])
        del model
        torch.cuda.empty_cache()
        prompt = twin_prompt(card.cfg, spec["prompt_len"])
        twin = {"twin_layers": spec["layers"], "vocab": spec["vocab"],
                "prompt_len": spec["prompt_len"], "tolerance": TWIN_ATOL}
        # decode is MLA's absorbed form, prefill its materialized one:
        # the one MLA-specific check, with routing out of it (no drops)
        reconfigure(card, lp_capacity=False, capacity_factor=100.0)
        twin.update(decode_vs_prefill(card, prompt, spec["prefix"]))
        emit({"mla_float32_twin": twin})
        assert twin["decode_vs_prefill_max_abs_err"] <= TWIN_ATOL, twin
        del card
    torch.cuda.empty_cache()
    return {**line, **prof, "twin": twin, "launches": launches}


def no_kernel_serving(name, arch, cfg, load, twin_fn,
                      keys=SERVE_CONFIG_KEYS):
    """Serve ``cfg`` (drawn on the card) on ``load`` through ``serve``
    with every launch counter zeroed first: no port kernel may launch.
    Prints the serving line and the profiles, then runs ``twin_fn(model)``
    for the float32 twin's line; ``name`` names the phases."""
    import torch
    from repro_torch.launch.serve import serve, set_matmul_policy
    policy = set_matmul_policy()
    model, init_s = draw_on_card(cfg)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with phase(f"{name}.serve"):
        res = serve(cfg, model, seed=SERVE_SEED, **load)
    launched = counts()
    assert not any(launched.values()), launched   # no port kernel
    peak = torch.cuda.max_memory_allocated()
    check_served(res, cfg, load)
    line = serve_line(arch, cfg, model, res, policy, init_s, peak, load=load,
                      keys=keys, custom_kernel_launches=launched)
    with phase(f"{name}.profiles"), torch.inference_mode():
        prof = serve_profiles(model, res, load=load)
    emit({"serve_profile": arch, **prof})
    with phase(f"{name}.twin"), torch.inference_mode():
        twin = twin_fn(model)
    del model
    torch.cuda.empty_cache()
    return {**line, **prof, "twin": twin}


def twin_checks(name, card, cpu, spec, extra):
    """The float32 twin on the card against the CPU (greedy tokens
    equal, logits within TWIN_ATOL) and, on the card, decode steps after
    a shorter prefill against one prefill (within TWIN_ATOL)."""
    prompt = twin_prompt(card.cfg, spec["prompt_len"])
    twin = {"twin_layers": card.cfg.n_layers,
            "prompt_len": spec["prompt_len"],
            "greedy_steps": spec["gen"], "tolerance": TWIN_ATOL,
            "stub_inputs": {k: list(v.shape) for k, v in extra.items()},
            **card_vs_cpu(card, cpu, prompt, spec["gen"], extra),
            **decode_vs_prefill(card, prompt, spec["prefix"], extra)}
    emit({f"{name}_float32_twin": twin})
    assert twin["card_vs_cpu_tokens_equal"], twin
    assert twin["card_vs_cpu_max_abs_err"] <= TWIN_ATOL and \
        twin["decode_vs_prefill_max_abs_err"] <= TWIN_ATOL, twin
    return twin


def serving_encdec():
    """whisper-small whole (12 encoder and 12 decoder layers) served
    through repro_torch.launch.serve.serve on 1,500-frame windows: no
    port kernel launches; its float32 twin (the whole model) on the card
    against the CPU."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH)
    assert (cfg.family, cfg.n_layers, cfg.n_encoder_layers, cfg.d_model,
            cfg.n_heads, cfg.n_heads_padded, cfg.d_head, cfg.d_ff,
            cfg.vocab, cfg.norm_kind, cfg.use_rope, cfg.tie_embeddings,
            cfg.param_dtype) == \
        ("encdec", 12, 12, 768, 12, 16, 64, 3072, 51865, "layernorm",
         False, True, "bfloat16")

    def twin(model):
        spec = ENCDEC_TWIN
        cpu = float32_cut(model, "cpu", cfg.n_layers)
        card = float32_cut(cpu, "cuda", cfg.n_layers)
        return twin_checks("encdec", card, cpu, spec,
                           twin_inputs(cfg, spec["n_frames"]))

    return no_kernel_serving("serving_encdec", ENCDEC_ARCH, cfg,
                             ENCDEC_SERVE, twin,
                             SERVE_CONFIG_KEYS_ENCDEC)


def serving_vlm():
    """phi-3-vision-4.2b whole (32 layers) served through
    repro_torch.launch.serve.serve, 256 patches before each prompt: no
    port kernel launches; its float32 twin (2 layers) on the card against
    the CPU."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab, cfg.n_patches,
            cfg.param_dtype) == \
        ("vlm", 32, 3072, 32, 32, 96, 8192, 32064, 256, "bfloat16")

    def twin(model):
        spec = VLM_TWIN
        cpu = float32_cut(model, "cpu", spec["layers"])
        card = float32_cut(cpu, "cuda", spec["layers"])
        return twin_checks("vlm", card, cpu, spec, twin_inputs(cfg))

    return no_kernel_serving("serving_vlm", VLM_ARCH, cfg, VLM_SERVE, twin)


# ---- falcon-mamba-7b training (launch/train.py, csrc/ssm_scan.cu) --------

# ---- the training runs' data, made ahead -----------------------------------
# DataPipeline.batch_at samples its Markov tokens on the host, a (1, 64) x
# (64, vocab) float64 product a token (about 2.8 ms a token at
# llama4-scout's 202,048-token vocabulary): 8-12 s a step of 4 x 1,024
# tokens at the large vocabularies.  So every training run's batches are
# made ahead, by the same class with the same arguments in DATA_WORKERS
# processes (no CUDA; one BLAS thread each, at the lowest priority, so
# that they take only cores no phase uses) started with the run, and
# ``train`` reads them (``prefetched_data``); each run's line gives the
# seconds the workers took for its batches.
DATA_WORKERS = 3
_DATA = {}                   # (vocab, batch, seq, seed, step) -> future
_DATA_POOL = []


def _pipeline_batch(vocab, batch, seq, seed, step):
    """DataPipeline(vocab, batch, seq, seed=seed).batch_at(step) and the
    seconds it took."""
    from repro_torch.data import DataPipeline
    t0 = time.perf_counter()
    out = DataPipeline(vocab=vocab, batch=batch, seq=seq,
                       seed=seed).batch_at(step)
    return out, time.perf_counter() - t0


def _data_worker():
    # before NumPy loads: one BLAS thread (a (1, 64) x (64, vocab) product
    # gains nothing from more), and the lowest CPU priority
    for name in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                 "MKL_NUM_THREADS"):
        os.environ[name] = "1"
    os.nice(19)


def start_training_data():
    """Hand every training run's batches to the data workers."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import get_config
    pool = ProcessPoolExecutor(
        DATA_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_data_worker)
    _DATA_POOL.append(pool)
    runs = [(get_config(SERVE_ARCH).vocab, TRAIN["batch"], TRAIN["seq"],
             TRAIN["steps"])]
    runs += [(get_config(arch).vocab, batch, seq, TRAIN_FAMILY_STEPS)
             for arch, _, batch, seq, _, _ in TRAIN_FAMILIES]
    for vocab, batch, seq, steps in runs:
        for step in range(steps):
            key = (vocab, batch, seq, SERVE_SEED, step)
            _DATA[key] = pool.submit(_pipeline_batch, *key)


def stop_training_data():
    while _DATA_POOL:
        _DATA_POOL.pop().shutdown(wait=True, cancel_futures=True)


@contextlib.contextmanager
def prefetched_data(made):
    """repro_torch.launch.train's DataPipeline answering ``batch_at`` with
    the batch the data workers made for the same arguments and step (and
    making any other itself); the workers' seconds are added to
    ``made["s"]``."""
    import repro_torch.launch.train as train_mod
    real = train_mod.DataPipeline

    class Prefetched:
        def __init__(self, vocab, batch, seq, *, seed=0):
            self.args, self.local_batch = (vocab, batch, seq, seed), batch
            self.seq, self._real = seq, None

        def batch_at(self, step):
            future = _DATA.get(self.args + (step,))
            if future is not None:
                out, took = future.result()
                made["s"] = made.get("s", 0.0) + took
                return out
            if self._real is None:
                vocab, batch, seq, seed = self.args
                self._real = real(vocab=vocab, batch=batch, seq=seq,
                                  seed=seed)
            return self._real.batch_at(step)

    train_mod.DataPipeline = Prefetched
    try:
        yield
    finally:
        train_mod.DataPipeline = real


TRAIN_LAYERS = 24            # full width, depth cut to fit AdamW in 80 GB
TRAIN = {"batch": 4, "seq": 1024, "steps": 4, "lr": 3e-3}
ODD_BWD = ((1, 1, 8, 2), (2, 13, 24, 4), (2, 33, 130, 16), (3, 7, 256, 16))


def scan_bwd_vs_plain(dA, hs, h0, g_hs, g_hT):
    """One backward kernel launch against ssm_scan_bwd_plain on the same
    card tensors; returns the largest |kernel - plain| over ddA, ddBx and
    dh0."""
    import torch
    from repro_torch.kernels import ssm_scan_bwd, ssm_scan_bwd_plain
    got = ssm_scan_bwd(dA, hs, h0, g_hs, g_hT)
    want = ssm_scan_bwd_plain(dA, hs, h0, g_hs, g_hT)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in got)
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


@contextlib.contextmanager
def bwd_inputs_kept(call):
    """Keep the (dA, hs, h0, g_hs, g_hT) that the scan's autograd backward
    hands the backward kernel in call number ``call`` (from 0).  Yields a
    dict that holds them under "args" once that call ran; the kernel runs
    and counts as it does without this."""
    import importlib
    mod = importlib.import_module("repro_torch.kernels.ssm_scan")
    real, kept, n = mod.ssm_scan_bwd, {}, [0]

    def keep(*args):
        if n[0] == call:
            kept["args"] = args
        n[0] += 1
        mod.ssm_scan_bwd = real    # the wrapper counts on its module name
        try:
            return real(*args)
        finally:
            mod.ssm_scan_bwd = keep

    mod.ssm_scan_bwd = keep
    try:
        yield kept
    finally:
        mod.ssm_scan_bwd = real


def training():
    """falcon-mamba-7b at full width, cut to TRAIN_LAYERS layers, trained
    for a few steps through repro_torch.launch.train.train; the backward
    kernel held against its plain version on the inputs the training run
    handed it and at odd shapes, and timed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_scan_bwd, ssm_scan_bwd_plain
    from repro_torch.launch.serve import set_matmul_policy
    from repro_torch.launch.train import train
    from repro_torch.models import build_model

    policy = set_matmul_policy()
    full = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
            cfg.vocab, cfg.param_dtype, cfg.remat) == \
        (4096, 8192, 16, 256, 65024, "bfloat16", "block")
    mb = cfg.train_microbatches
    chunks = TRAIN["seq"] // SCAN_CHUNK
    assert mb == 2 and chunks == 2
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED)      # drawn on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    # a slice of every parameter, to show that the steps moved them
    before = [p.detach().flatten()[:64].clone() for p in params]
    # layer 0's backward of chunk 0 in the first microbatch: the layers
    # run backward from the last, and a layer's chunk 1 before its chunk 0
    call = cfg.n_layers * chunks - 1
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    made = {}
    with bwd_inputs_kept(call) as kept, prefetched_data(made):
        res = train(cfg, model, microbatches=mb, seed=SERVE_SEED,
                    log_every=1, **TRAIN)
    got = counts()
    launches = cfg.n_layers * chunks * mb * TRAIN["steps"]
    assert launches == 384
    assert got["ssm_scan_bwd"] == launches, got
    assert got["ssm_scan"] == 2 * launches, got
    assert all(v == 0 for k, v in got.items()
               if k not in ("ssm_scan", "ssm_scan_bwd")), got
    peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(res["losses"]).all(), res["losses"]
    assert np.isfinite(res["grad_norms"]).all(), res["grad_norms"]
    changed = [not torch.equal(b, p.detach().flatten()[:64])
               for b, p in zip(before, params)]
    assert any(c for c, p in zip(changed, params)
               if p.dtype == torch.bfloat16), changed
    assert all(torch.isfinite(p).all() for p in params)
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    # the kernels' device time in one microbatch's loss and gradients,
    # beside the measured step time: the share of the time the card was
    # busy, and where it went
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
    toks = torch.randint(0, cfg.vocab, (TRAIN["batch"] // mb, TRAIN["seq"]),
                         generator=gen, device="cuda")
    grad_ms, grad_top = kernel_profile(lambda: torch.autograd.grad(
        model.loss_fn({"tokens": toks, "labels": toks}), params), top=8)
    dA, hs, h0, g_hs, g_hT = (t.detach() for t in kept["args"])
    assert float(h0.abs().max()) == 0 and float(g_hT.abs().max()) > 0
    kept_bytes = sum(t.numel() * 4 for t in kept["args"])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    emit({"train": SERVE_ARCH, "config": {
              "n_layers": cfg.n_layers, "published_n_layers": full.n_layers,
              "d_model": cfg.d_model, "d_inner": cfg.d_inner,
              "ssm_state": cfg.ssm_state, "dt_rank": cfg.dt_rank,
              "vocab": cfg.vocab, "param_dtype": cfg.param_dtype,
              "remat": cfg.remat, "microbatches": mb},
          **TRAIN, "seed": SERVE_SEED, "params": n_params,
          "param_bytes": param_bytes, "init_on_card_s": init_s,
          "matmul_policy": policy,
          "bwd_launches": got["ssm_scan_bwd"],
          "fwd_launches": got["ssm_scan"], "losses": res["losses"],
          "grad_norms": res["grad_norms"], "step_s": res["step_s"],
          "data_s": res["data_s"], "data_made_ahead_s": made.get("s"),
          "tokens_per_step": tokens,
          "tokens_per_s": res["tokens_per_s"],
          "peak_device_bytes": peak,
          "peak_includes_kept_bwd_input_bytes": kept_bytes,
          "microbatch_grad_kernel_ms": grad_ms,
          "microbatch_grad_top_kernels": grad_top,
          "busy_share_of_last_step": mb * grad_ms / (
              1e3 * res["step_s"][-1]),
          "params_changed": sum(changed), "params_total": len(params)})
    del model, params, before, res, toks
    torch.cuda.empty_cache()

    errs = {"layer0_chunk0": scan_bwd_vs_plain(dA, hs, h0, g_hs, g_hT)}
    for shape in ODD_BWD:
        g = np.random.default_rng(shape[1])
        put = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                     device="cuda")
        B, T, d, s = shape
        errs[str(shape)] = scan_bwd_vs_plain(
            put(g.uniform(0.5, 1.0, (B, T, d, s))),
            put(g.normal(size=(B, T, d, s))),
            put(g.normal(size=(B, d, s))),
            put(g.normal(size=(B, T, d, s))),
            put(g.normal(size=(B, d, s))))
    max_err = max(errs.values())
    assert max_err == 0.0, errs

    # the kernel timed on layer 0's inputs at the training shape
    out = (torch.empty_like(dA), torch.empty_like(dA))
    ms = timed_avg(lambda: ssm_scan_bwd(dA, hs, h0, g_hs, g_hT))
    plain_ms = timed_avg(
        lambda: ssm_scan_bwd_plain(dA, hs, h0, g_hs, g_hT), reps=3)

    def yard():
        torch.add(dA, hs, out=out[0])
        torch.neg(g_hs, out=out[1])

    yard_ms = timed_avg(yard)
    # dA, hs, g_hs, h0 and g_hT read once; ddA, ddBx and dh0 written once
    B, T = dA.shape[:2]
    L = dA.shape[2] * dA.shape[3]
    nbytes = 4 * (5 * B * T * L + 3 * B * L)
    info = {"kernel": "ssm_scan_bwd", "shape": list(dA.shape),
            "kernel_vs_plain_max_abs_err": errs, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "yardstick_ms": yard_ms,
            "yardstick": "torch.add(dA, hs, out=o1) + torch.neg(g_hs, "
                         "out=o2): the same 5BTL floats in two calls; no "
                         "PyTorch call computes the reverse recurrence",
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "bound_by": "bytes", "launches": got["ssm_scan_bwd"],
            "fwd_launches": got["ssm_scan"],
            "achieved_bytes_per_s": nbytes / (ms * 1e-3)}
    emit(info)
    del dA, hs, h0, g_hs, g_hT, out, kept
    torch.cuda.empty_cache()
    return info


# ---- training of every LM family at full width -------------------------------

TRAIN_FAMILY_STEPS = 3        # step 0 warms up and is left out of tokens/s
# the learning rate of the families' runs: every parameter is bf16 with no
# float32 master copy (as in the reference), so a step moves an entry only
# when it passes half its bf16 spacing: 0.0039 for a norm scale at 1.0,
# 0.0156 for hymba's dt_bias at -4.6.  With the optimizers' warmup of 100
# steps lr_t is 0.01, 0.02 and 0.03 at steps 0, 1 and 2
TRAIN_FAMILY_LR = 1.0
# (arch, layers or None for the published depth, batch, seq, config
# changes, n_frames); two microbatches each
TRAIN_FAMILIES = (
    (HYMBA_ARCH, 16, 2, 2048, {}, None),   # 16 of 32: the time budget
    (DENSE_ARCH, 4, 4, 1024, {}, None),
    (MOE_ARCH, 1, 4, 1024, {"lp_capacity": True}, None),
    ("llama3-405b", 1, 4, 1024, {}, None),
    (ENCDEC_ARCH, None, 4, 448, {}, 1500),
    (VLM_ARCH, None, 4, 1792, {}, None),
)
TRAIN_FAMILY_MB = 2
PEAK_LIMIT = 75e9             # phi-3-vision trains whole below this peak
MLA_TWIN_STEPS = 2


def optimizer_state_bytes(model, name):
    """The bytes of optimizer ``name``'s state for ``model``, from its
    init on meta copies of the parameters."""
    import torch
    from repro_torch.optim import get_optimizer
    meta = [(n, torch.empty(p.shape, dtype=p.dtype, device="meta"))
            for n, p in model.named_parameters()]
    state = get_optimizer(name).init(meta)
    tensors = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(state)
    return sum(t.numel() * t.element_size() for t in tensors)


def fingerprint(p, block=1 << 26):
    """(sum, sum of squares) of ``p``'s values in float64, taken in flat
    blocks: equal before and after a step only if the step changed no
    entry (bar an exact cancellation in both), with no copy of the
    tensor."""
    import torch
    flat = p.detach().reshape(-1)
    out = torch.zeros(2, dtype=torch.float64, device=p.device)
    for i in range(0, flat.numel(), block):
        x = flat[i:i + block].double()
        out[0] += x.sum()
        out[1] += x.square().sum()
    return out


def train_family(arch, layers, batch, seq, changes, n_frames):
    """``arch`` at its published width (cut to ``layers`` layers where
    given), bf16 from SERVE_SEED on the card, trained through
    repro_torch.launch.train.train for TRAIN_FAMILY_STEPS steps of
    ``batch`` x ``seq`` tokens in two microbatches with the config's
    optimizer.  Returns (the emitted line, the config, the launches by
    kernel, what the hooks kept: hymba's backward inputs, scout's
    routings)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import set_matmul_policy
    import repro_torch.launch.train as train_mod
    from repro_torch.launch.train import step_batch, train

    policy = set_matmul_policy()
    published = get_config(arch)
    cfg = dataclasses.replace(published, **changes)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    assert cfg.param_dtype == "bfloat16" and cfg.remat == "block", cfg
    model, init_s = draw_on_card(cfg)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    n_params = sum(p.numel() for p in params)
    opt_bytes = optimizer_state_bytes(model, cfg.optimizer)
    reckoning = {"param_bytes": 2 * n_params,
                 "float32_accumulator_bytes": 4 * n_params,
                 "bf16_gradient_bytes": 2 * n_params,
                 "optimizer_state_bytes": opt_bytes}
    reckoning["total_before_activations"] = sum(reckoning.values())
    before = [fingerprint(p) for p in params]
    hooks, made = {}, {}
    chunks = seq // SCAN_CHUNK if cfg.family == "hybrid" else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(prefetched_data(made))
        if cfg.family == "hybrid":
            # layer 0's backward of chunk 0 in the first microbatch: the
            # layers run backward from the last, a layer's chunks from its
            # last
            hooks["bwd"] = stack.enter_context(bwd_inputs_kept(
                cfg.n_layers * chunks - 1))
        if cfg.lp_capacity:
            hooks["routes"] = stack.enter_context(routes_kept())
        t0 = time.perf_counter()
        res = train(cfg, model, batch=batch, seq=seq,
                    steps=TRAIN_FAMILY_STEPS, lr=TRAIN_FAMILY_LR,
                    microbatches=TRAIN_FAMILY_MB, seed=SERVE_SEED,
                    log_every=1, n_frames=n_frames)
        wall = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(res["losses"]).all(), res["losses"]
    assert np.isfinite(res["grad_norms"]).all(), res["grad_norms"]
    assert all(torch.isfinite(p).all() for p in params)
    # every bf16 parameter moved: some entry of it passed half its bf16
    # spacing in a step (TRAIN_FAMILY_LR)
    changed = [not torch.equal(b, fingerprint(p))
               for b, p in zip(before, params)]
    unmoved = [n for n, c, p in zip(names, changed, params)
               if not c and p.dtype == torch.bfloat16]
    assert not unmoved, unmoved
    # step 0's first microbatch, its loss and gradients under the
    # profiler: the card's busy share of a step
    with prefetched_data({}):
        data = train_mod.DataPipeline(vocab=cfg.vocab, batch=batch,
                                      seq=seq, seed=SERVE_SEED)
        mb = {k: v[:batch // TRAIN_FAMILY_MB] for k, v in step_batch(
            cfg, data, 0, seed=SERVE_SEED, n_frames=n_frames or seq,
            device=model.device).items()}
    grad_ms, grad_top = kernel_profile(lambda: torch.autograd.grad(
        model.loss_fn(mb), params), top=8)
    warm = res["step_s"][1:]
    tokens = batch * seq
    line = {"train": arch, "family": cfg.family, "config": {
                "n_layers": cfg.n_layers,
                "published_n_layers": published.n_layers,
                "n_encoder_layers": cfg.n_encoder_layers or None,
                "d_model": cfg.d_model, "vocab": cfg.vocab,
                "param_dtype": cfg.param_dtype, "remat": cfg.remat,
                "lp_capacity": cfg.lp_capacity, "optimizer": cfg.optimizer,
                "n_patches": cfg.n_patches if cfg.family == "vlm" else None,
                "n_frames": n_frames},
            "batch": batch, "seq": seq, "microbatches": TRAIN_FAMILY_MB,
            "steps": TRAIN_FAMILY_STEPS, "lr": TRAIN_FAMILY_LR,
            "seed": SERVE_SEED, "params": n_params,
            "memory_reckoning_bytes": reckoning,
            "init_on_card_s": init_s, "matmul_policy": policy,
            "losses": res["losses"], "grad_norms": res["grad_norms"],
            "step_s": res["step_s"], "data_s": res["data_s"],
            "data_made_ahead_s": made.get("s"),
            "wall_s": wall, "tokens_per_step": tokens,
            "tokens_per_s_warm": tokens * len(warm) / sum(warm),
            "peak_device_bytes": peak,
            "microbatch_grad_kernel_ms": grad_ms,
            "microbatch_grad_top_kernels": grad_top,
            "busy_share_of_a_microbatch": TRAIN_FAMILY_MB * grad_ms / (
                1e3 * float(np.mean(warm))),
            "params_changed": sum(changed), "params_total": len(params),
            "launches": {k: v for k, v in got.items() if v}}
    emit(line)
    del model, params, before, res, mb
    torch.cuda.empty_cache()
    return line, cfg, got, hooks


def hymba_bwd_row(kept, got, cfg_layers, chunks):
    """hymba's backward launches against layers x chunks x microbatches x
    steps (the forward twice that), and the backward kernel on layer 0's
    chunk-0 inputs: bit-equal to its plain version, timed beside its
    bytes bound and yardstick.  Returns row 8's hymba-shape entry."""
    import torch
    from repro_torch.kernels import ssm_scan_bwd, ssm_scan_bwd_plain
    launches = cfg_layers * chunks * TRAIN_FAMILY_MB * TRAIN_FAMILY_STEPS
    assert got["ssm_scan_bwd"] == launches, got
    assert got["ssm_scan"] == 2 * launches, got
    assert all(v == 0 for k, v in got.items()
               if k not in ("ssm_scan", "ssm_scan_bwd")), got
    dA, hs, h0, g_hs, g_hT = (t.detach() for t in kept["args"])
    assert float(h0.abs().max()) == 0 and float(g_hT.abs().max()) > 0
    err = scan_bwd_vs_plain(dA, hs, h0, g_hs, g_hT)
    assert err == 0.0, err
    out = (torch.empty_like(dA), torch.empty_like(dA))
    ms = timed_avg(lambda: ssm_scan_bwd(dA, hs, h0, g_hs, g_hT))
    plain_ms = timed_avg(
        lambda: ssm_scan_bwd_plain(dA, hs, h0, g_hs, g_hT), reps=3)

    def yard():
        torch.add(dA, hs, out=out[0])
        torch.neg(g_hs, out=out[1])

    yard_ms = timed_avg(yard)
    B, T = dA.shape[:2]
    L = dA.shape[2] * dA.shape[3]
    nbytes = 4 * (5 * B * T * L + 3 * B * L)
    row = {"kernel": "ssm_scan_bwd", "train": HYMBA_ARCH,
           "shape": list(dA.shape), "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "yardstick_ms": yard_ms, "bytes": nbytes,
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "launches": got["ssm_scan_bwd"], "fwd_launches": got["ssm_scan"]}
    emit(row)
    return row


def scout_router_row(routes, got, cfg):
    """scout's router launches (once a MoE layer call: the forward and the
    recompute under remat, each microbatch and step), each layer's
    recompute routing against its forward's in every microbatch (demand,
    caps, keep mask, experts, slots, weights equal), and the first call's
    caps against the plain version's solve of the same demand."""
    import torch
    from repro_torch.models import moe
    layers = cfg.n_layers
    calls = 2 * layers * TRAIN_FAMILY_MB * TRAIN_FAMILY_STEPS
    assert got["simplex_tile"] == calls and len(routes) == calls, \
        (got, len(routes))
    assert all(v == 0 for k, v in got.items() if k != "simplex_tile"), got
    # each microbatch: the forward's calls layer by layer, then the
    # recompute's from the last layer
    for m in range(0, calls, 2 * layers):
        block = routes[m:m + 2 * layers]
        for fwd, rec in zip(block[:layers], block[layers:][::-1]):
            for f in ("demand", "caps", "expert", "slot", "keep", "top_w"):
                assert torch.equal(getattr(fwd, f), getattr(rec, f)), (m, f)
    fwd = routes[0]
    capacity = moe._capacity(fwd.top_w.shape[0], cfg.top_k, cfg.n_experts,
                             cfg.capacity_factor)
    err = caps_vs_plain(fwd, capacity)
    assert err == 0.0, err
    row = {"router": MOE_ARCH, "launches": got["simplex_tile"],
           "recompute_routing_equal": True, "caps_vs_plain_max_abs_err": err,
           "kept_share": float(fwd.keep.float().mean())}
    emit(row)
    return row


def training_families():
    """Every LM family trained at full width (TRAIN_FAMILIES), then the
    reduced deepseek-v2 (MLA, the LP router) trained on the card and on
    the CPU.  Returns the rows the kernel table reads."""
    import torch
    out = {"lines": []}
    for arch, layers, batch, seq, changes, n_frames in TRAIN_FAMILIES:
        with phase(f"training_families.{arch}"):
            line, cfg, got, hooks = train_family(arch, layers, batch, seq,
                                                 changes, n_frames)
            if arch == VLM_ARCH and line["peak_device_bytes"] > PEAK_LIMIT:
                raise AssertionError(f"{arch} peaked at "
                                     f"{line['peak_device_bytes']} bytes")
            out["lines"].append(line)
            if "bwd" in hooks:
                out["hymba_bwd"] = hymba_bwd_row(
                    hooks["bwd"], got, cfg.n_layers, seq // SCAN_CHUNK)
            if "routes" in hooks:
                out["scout_router"] = scout_router_row(hooks["routes"],
                                                       got, cfg)
            del hooks
            torch.cuda.empty_cache()
    with phase("training_families.mla_twin"):
        out["mla_twin"] = mla_train_twin()
    return out


def mla_train_twin():
    """The reduced deepseek-v2 (MLA, 8 experts, top-2, the LP router;
    float32, remat per block) trained MLA_TWIN_STEPS steps through train
    on the card and on the CPU from the same parameters (drawn from
    SERVE_SEED): losses, grad norms and parameters within TWIN_ATOL; on
    the card the router launches once a MoE layer call (the forward and
    the recompute).  The full-width model does not fit one card for
    training (ROADMAP: expert sharding)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(MLA_ARCH).reduced(),
                              lp_capacity=True, remat="block")
    cpu = build_model(cfg, device="cpu", seed=SERVE_SEED)
    card = build_model(cfg, device="cpu", seed=SERVE_SEED).to("cuda")
    kw = dict(batch=4, seq=64, steps=MLA_TWIN_STEPS,
              microbatches=TRAIN_FAMILY_MB, seed=SERVE_SEED, log_every=1)
    zero_counts()
    got = train(cfg, card, **kw)
    launches = only("simplex_tile")
    assert launches == 2 * cfg.n_layers * TRAIN_FAMILY_MB * MLA_TWIN_STEPS
    want = train(cfg, cpu, device="cpu", **kw)
    loss_err = max(abs(a - b) for a, b in zip(got["losses"],
                                              want["losses"]))
    norm_err = max(abs(a - b) for a, b in zip(got["grad_norms"],
                                              want["grad_norms"]))
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(card.parameters(), cpu.parameters()))
    moved = max(float((a.detach() - b.detach()).abs().max()) for a, b in
                zip(cpu.parameters(), build_model(
                    cfg, device="cpu", seed=SERVE_SEED).parameters()))
    assert np.isfinite(got["losses"]).all()
    assert max(loss_err, norm_err, param_err) < TWIN_ATOL, \
        (loss_err, norm_err, param_err)
    assert moved > 0
    line = {"train_twin": MLA_ARCH, "config": "reduced, float32, "
            "lp_capacity, remat block", "n_layers": cfg.n_layers,
            **{k: v for k, v in kw.items() if k != "log_every"},
            "card_losses": got["losses"], "cpu_losses": want["losses"],
            "card_vs_cpu_loss_max_abs_err": loss_err,
            "card_vs_cpu_grad_norm_max_abs_err": norm_err,
            "card_vs_cpu_param_max_abs_err": param_err,
            "param_max_move": moved, "atol": TWIN_ATOL,
            "launches": launches}
    emit(line)
    del card, cpu
    torch.cuda.empty_cache()
    return line


# ---- the data mixture: the paper's batched LP in the data layer -----------

MIXTURE_ROWS = 4096
MIXTURE_SOURCES = 8


def optimal_mixture_phase():
    """repro_torch.data.optimal_mixture on MIXTURE_ROWS utility rows over
    MIXTURE_SOURCES sources (positive floors: every LP starts infeasible;
    every 97th row's floors sum past 1: infeasible, uniform): one
    whole-solve launch on the card; statuses and weights equal to the
    CPU port's."""
    import numpy as np
    from repro_torch.data import mixture

    rng = np.random.default_rng(SERVE_SEED)
    u = rng.normal(size=(MIXTURE_ROWS, MIXTURE_SOURCES))
    caps = np.full(MIXTURE_SOURCES, 0.3)
    floors = np.full((MIXTURE_ROWS, MIXTURE_SOURCES), 0.05)
    floors[::97] = 0.2
    real, results = mixture.solve_batched, []

    def keep(*args, **kw):
        results.append(real(*args, **kw))
        return results[-1]

    mixture.solve_batched = keep
    try:
        zero_counts()
        t0 = time.perf_counter()
        w = mixture.optimal_mixture(u, caps, floors)
        wall = time.perf_counter() - t0
        launches = only("simplex_tile")
        t0 = time.perf_counter()
        w_cpu = mixture.optimal_mixture(u, caps, floors, device="cpu")
        cpu_wall = time.perf_counter() - t0
    finally:
        mixture.solve_batched = real
    assert launches == 1, launches
    card, cpu = results
    np.testing.assert_array_equal(card.status, cpu.status)
    np.testing.assert_array_equal(w, w_cpu)
    assert (card.status[::97] != 0).all()
    np.testing.assert_array_equal(w[::97], np.full_like(w[::97],
                                                        1 / MIXTURE_SOURCES))
    line = {"optimal_mixture": MIXTURE_ROWS, "sources": MIXTURE_SOURCES,
            "launches": launches, "wall_s": wall, "cpu_wall_s": cpu_wall,
            "status_counts": np.bincount(card.status.astype(int),
                                         minlength=4).tolist(),
            "max_abs_err": float(np.abs(w - w_cpu).max())}
    emit(line)
    return line


# ---- the paper's workloads, multi-rank solving, the LP router -------------

WORLD = 2                 # ranks of the gloo world spawned on the one card
DIST_K = 4                # segment_k of the distributed checks on the slice
ROUTER_SIZES = ((1, 16), (4096, 16), (1, 160), (4096, 160))
NEW_WORKLOADS = ("lp_5d_100k", "lp_28d_100k", "lp_sc50b_like_50k")


def _digest(*arrays):
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def batch_digest(batch):
    """A digest of every array of an LPBatch or a GeneralLPBatch."""
    fields = (("A", "b", "c") if hasattr(batch, "b")
              else ("A", "rhs", "lb", "ub", "c", "c0"))
    return _digest(*(getattr(batch, f) for f in fields))


def hand_built_digest(name):
    """Worker: the digest of the batch this script built by hand before
    configs/paper_lp.py had a counterpart."""
    import numpy as np
    from repro_torch.core import random_lp_batch
    from repro_torch.io import fixture_path, perturbed_batch, read_mps
    if name == "lp_100d_50k":
        return batch_digest(random_lp_batch(np.random.default_rng(2018),
                                            B=50_000, m=100, n=100,
                                            feasible_start=False))
    if name == "lp_afiro_100k":
        return batch_digest(perturbed_batch(read_mps(fixture_path("afiro")),
                                            100_000))
    return batch_digest(random_lp_batch(np.random.default_rng(2018), B=256,
                                        m=300, n=300))


def main_batches():
    """The batches of the main path and the checks, from
    configs/paper_lp.py ``build_batch``: lp_100d_50k in its Table-4
    phase-1 variant (``feasible_start=False``, seed 2018; the published
    entry starts feasible), lp_afiro_100k from seed 0, and 256 LPs of
    lp_300d_2k; each must equal the batch this script built by hand
    before (``hand_built_digest``, on a worker)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.paper_lp import build_batch, workload
    digests = {name: Behind(hand_built_digest, name)
               for name in ("lp_100d_50k", "lp_afiro_100k", "lp_300d_2k")}
    lp100 = build_batch(dataclasses.replace(workload("lp_100d_50k"),
                                            feasible_start=False))
    g = build_batch(workload("lp_afiro_100k"), rng=np.random.default_rng(0))
    lp300 = build_batch(workload("lp_300d_2k"), batch=256)
    return lp100, g, lp300, digests


def check_main_batches(batches, digests):
    equal = {}
    for name, batch in zip(("lp_100d_50k", "lp_afiro_100k", "lp_300d_2k"),
                           batches):
        equal[name] = batch_digest(batch) == digests[name].result()
        assert equal[name], (name, "build_batch differs from the hand-built "
                             "batch")
    emit({"main_batches_from_build_batch": equal})


def built_workload(name):
    """Worker: a configs/paper_lp.py workload built with ``build_batch``
    at its published batch size: its size, the seconds the build took and,
    for a fixture, ``canonical_work``."""
    from repro_torch.analysis.lp_perf import canonical_work
    from repro_torch.configs.paper_lp import build_batch, workload
    w = workload(name)
    t0 = time.perf_counter()
    batch = build_batch(w)
    info = {"paper_workload": name, "lps": batch.batch,
            "shape": [batch.m, batch.n], "fixture": w.fixture,
            "build_s": time.perf_counter() - t0}
    assert batch.batch == w.batch and (batch.m, batch.n) == (w.m, w.n)
    if w.fixture is not None:
        info["canonical_work"] = canonical_work(batch)
    if name == "lp_100d_50k":   # rank 0's block on 16 x 16 (phase dryrun)
        info["rank0_block"] = (batch.A[:LP_BLOCK], batch.b[:LP_BLOCK],
                               batch.c[:LP_BLOCK])
    return info


def solve_workload(name):
    """A configs/paper_lp.py workload built with ``build_batch`` at its
    published batch size and solved through ``solve_batched`` on the card,
    through the whole-solve kernel only (its launches counted from 0 just
    before), the first 64 held against the float64 oracle; a fixture's
    ``canonical_work`` beside it.  ``dispatch_s``: the seconds of the
    wall in the kernel path's dispatch span (the tensors to the card, the
    launch, the results back); the rest is the host's canonicalization
    and recovery.  Returns what it prints."""
    import dataclasses
    import numpy as np
    from repro_torch.analysis.lp_perf import canonical_work
    from repro_torch.configs.paper_lp import build_batch, workload
    from repro_torch.core import (LPBatch, solve_batched,
                                  solve_batched_reference)
    from repro_torch.obs import SpanTracer
    w = workload(name)
    t0 = time.perf_counter()
    batch = build_batch(w)
    info = {"paper_workload": w.name, "lps": batch.batch,
            "shape": [batch.m, batch.n], "fixture": w.fixture,
            "build_s": time.perf_counter() - t0}
    assert batch.batch == w.batch and (batch.m, batch.n) == (w.m, w.n)
    if w.fixture is None:
        head = LPBatch(A=batch.A[:64], b=batch.b[:64], c=batch.c[:64])
    else:
        info["canonical_work"] = canonical_work(batch)
        head = dataclasses.replace(
            batch, A=batch.A[:64], rhs=batch.rhs[:64], lb=batch.lb[:64],
            ub=batch.ub[:64], c=batch.c[:64], c0=batch.c0[:64])
    zero_counts()
    tracer = SpanTracer()
    t0 = time.perf_counter()
    res = solve_batched(batch, tracer=tracer)
    wall = time.perf_counter() - t0
    launches = only("simplex_tile")
    opt = res.status == 0
    assert res.x.shape == (w.batch, w.n)
    assert np.isfinite(res.x[opt]).all()
    assert np.isfinite(res.objective[opt]).all()
    info.update({"wall_s": wall, "lps_per_s": w.batch / wall,
                 "dispatch_s": sum(s.dur_s for root in tracer.roots
                                   for s in root.walk()
                                   if s.name == "dispatch"),
                 "launches": launches,
                 "status_counts": np.bincount(
                     res.status.astype(int), minlength=4).tolist(),
                 "mean_iterations": float(res.iterations.mean())})
    info.update(check_oracle(w.name, res, solve_batched_reference(head)))
    return info


def paper_workloads(behind, solved, blocks):
    """Every configs/paper_lp.py workload built with ``build_batch`` at its
    published batch size: those of ``behind`` (the main path's
    lp_100d_50k as published, lp_300d_2k and lp_afiro_100k) on a worker
    (``built_workload``), the rest of NEW_WORKLOADS solved here
    (``solve_workload``), beside those of ``solved`` (solved before).
    Returns the whole-solve kernel's launches by workload; ``blocks``
    receives published lp_100d_50k's first LP_BLOCK LPs."""
    from repro_torch.configs.paper_lp import WORKLOADS
    from repro_torch.core import LPBatch
    launches = {}
    for w in WORKLOADS:
        if w.name in behind:
            info = behind[w.name].result()
            info["on_worker"] = True
            block = info.pop("rank0_block", None)
            if block is not None:
                blocks[w.name] = LPBatch(*block)
        elif w.name in NEW_WORKLOADS:
            info = solved.get(w.name) or solve_workload(w.name)
            launches[w.name] = info["launches"]
        else:
            raise AssertionError(f"{w.name} was neither built nor solved")
        emit(info)
    return launches


def _slice(lp, k=SLICE):
    from repro_torch.core import LPBatch
    return LPBatch(A=lp.A[:k], b=lp.b[:k], c=lp.c[:k],
                   ub=None if lp.ub is None else lp.ub[:k])


DIST_FIELDS = ("status", "iterations", "x", "objective", "y", "z")

WORLD_RANK = """
import pickle, sys
import numpy as np, torch, torch.distributed as dist
rank, world, store, src, out = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.core import solve_pjit, solve_shard_map
with open(src, "rb") as f:
    lp, k = pickle.load(f)
fields = ("status", "iterations", "x", "objective", "y", "z")
done = {}
for backend in ("tableau", "revised", "pdhg"):
    for mode in ("pjit", "one-shot", "segment_k"):
        stats = []
        if mode == "pjit":
            res = solve_pjit(lp, backend=backend)
        elif mode == "one-shot":
            res = solve_shard_map(lp, backend=backend)
        else:
            res = solve_shard_map(lp, backend=backend, segment_k=k,
                                  stats_out=stats)
        done[backend, mode] = ({f: getattr(res, f) for f in fields},
                               [(s.stage, s.bucket, s.steps, s.survivors)
                                for s in stats])
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump(done, f)
dist.barrier()
dist.destroy_process_group()
"""


def start_world(lp, workdir):
    """Spawn the WORLD ranks of a gloo world on the one card (a file
    store, no network), each solving ``lp`` with every backend, whole and
    in DIST_K-step segments; returns (processes, result path)."""
    import pickle
    with open(workdir / "lp.pkl", "wb") as f:
        pickle.dump((lp, DIST_K), f)
    out = workdir / "rank0.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORLD_RANK, str(r), str(WORLD),
         str(workdir / "store"), str(workdir / "lp.pkl"), str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    return procs, out


def wait_world(procs, out, timeout=600):
    import pickle
    for p in procs:
        so, se = p.communicate(timeout=timeout)
        assert p.returncode == 0, ("a rank failed", so[-2000:], se[-4000:])
    with open(out, "rb") as f:
        return pickle.load(f)


def same_fields(got, want, what):
    import numpy as np
    for f in DIST_FIELDS:
        g = got[f] if isinstance(got, dict) else getattr(got, f)
        w = want[f] if isinstance(want, dict) else getattr(want, f)
        assert np.array_equal(np.asarray(g), np.asarray(w), equal_nan=True), \
            (what, f)


def distributed(lp100, res_whole, res_comp, comp_stats, workdir):
    """core/distributed.py on the card.  A world of one rank: solve_pjit,
    the one-shot solve_shard_map and solve_shard_map(segment_k) on all
    50,000 LPs of lp_100d_50k (tableau) equal the whole solve and
    compaction=True (the same segment_k, the same ladder) leaf by leaf;
    revised and pdhg the same on the 2,048-LP slice.  A gloo world of
    WORLD ranks spawned on the one card, on the slice, every backend, whole
    and segmented: equal to the world of one bit for bit, every bucket a
    multiple of WORLD (started after the timed full-batch solves, its
    files in ``workdir``).  Returns the kernels' launches in the world of
    one."""
    import numpy as np
    from repro_torch.core import solve_batched, solve_pjit, solve_shard_map
    from repro_torch.core.compaction import auto_segment_k
    sl = _slice(lp100)
    zero_counts()
    walls = {}
    t0 = time.perf_counter()
    pjit = solve_pjit(lp100)
    walls["pjit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one_shot = solve_shard_map(lp100)
    walls["one_shot_s"] = time.perf_counter() - t0
    tile_launches = only("simplex_tile")
    zero_counts()
    stats = []
    t0 = time.perf_counter()
    seg = solve_shard_map(lp100, segment_k=auto_segment_k(lp100.m, lp100.n),
                          stats_out=stats)
    walls["segment_k_s"] = time.perf_counter() - t0
    seg_launches = only("simplex_segment")
    world = start_world(sl, workdir)
    try:
        for res, what in ((pjit, "pjit"), (one_shot, "one-shot"),
                          (seg, "segment_k")):
            same_fields(res, res_whole, f"{what} vs the whole solve")
            same_fields(res, res_comp, f"{what} vs compaction=True")
        assert ladder(stats) == ladder(comp_stats), "ladder"
        one = {}
        for backend in ("tableau", "revised", "pdhg"):
            whole = solve_batched(sl, backend=backend)
            comp = solve_batched(sl, backend=backend, compaction=True,
                                 segment_k=DIST_K)
            st = []
            one[backend] = {
                "pjit": solve_pjit(sl, backend=backend),
                "one-shot": solve_shard_map(sl, backend=backend),
                "segment_k": solve_shard_map(sl, backend=backend,
                                             segment_k=DIST_K, stats_out=st)}
            for mode, want in (("pjit", whole), ("one-shot", whole),
                               ("segment_k", comp)):
                same_fields(one[backend][mode], want, (backend, mode))
            one[backend]["ladder"] = ladder(st)
        t0 = time.perf_counter()
        ranks = wait_world(*world)
        waited = time.perf_counter() - t0
        buckets = set()
        for backend in ("tableau", "revised", "pdhg"):
            for mode in ("pjit", "one-shot", "segment_k"):
                got, st = ranks[backend, mode]
                same_fields(got, one[backend][mode], (WORLD, backend, mode))
                buckets |= {b for _, b, _, _ in st}
            assert ranks[backend, "segment_k"][1], (backend, "no segment")
        assert all(b % WORLD == 0 for b in buckets), buckets
    finally:   # a failed check leaves no rank running
        for p in world[0]:
            if p.poll() is None:
                p.kill()
    emit({"distributed": "lp_100d_50k", "world_of_one_lps": lp100.batch,
          "equal_whole_and_compaction": True, "ladder_equal": True,
          "whole_launches": tile_launches, "segment_launches": seg_launches,
          "segments": len(stats), **walls, "slice_lps": SLICE,
          "world": WORLD, "world_equal_world_of_one": True,
          "world_buckets": sorted(buckets), "world_wait_s": waited,
          "world_of_one_slice_ladders": {k: len(v["ladder"])
                                         for k, v in one.items()}})
    return tile_launches, seg_launches


def lp_router():
    """core/lp_router.py on the card: ``expert_capacity_lp`` at
    ROUTER_SIZES (G token groups, E experts: llama4-scout-17b-a16e's 16
    and deepseek-v2-236b's 160; G = 1 as models/moe.py calls it) with
    host synchronization forbidden (sync-debug mode "error"), one launch
    of the whole-solve kernel a call, equal bit for bit to its run on the
    CPU.  Returns the kernel's launches, read from the counters."""
    import numpy as np
    import torch
    from repro_torch.core import expert_capacity_lp
    rows, launches = [], 0
    for G, E in ROUTER_SIZES:
        rng = np.random.default_rng(2018 + G + E)
        d = rng.uniform(0.0, 50.0, (G, E)).astype(np.float32)
        d[:, rng.integers(0, E)] *= 8.0     # a hot expert
        total, c_max = 4.0 * E, 12.0
        dev_d = torch.from_numpy(d).cuda()
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        zero_counts()
        pair[0].record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = expert_capacity_lp(dev_d, total, c_max)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pair[1].record()
        pair[1].synchronize()
        ms = pair[0].elapsed_time(pair[1])
        n = only("simplex_tile")
        assert n == 1, n
        launches += n
        want = expert_capacity_lp(torch.from_numpy(d), total, c_max)
        assert got.is_cuda and got.shape == (G, E)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
        caps = want.numpy()
        assert (caps.sum(-1) <= total + 1e-2).all() and (caps <= c_max
                                                           + 1e-3).all()
        rows.append({"G": G, "E": E, "ms": ms, "equal_cpu": True,
                     "host_syncs": 0})
    emit({"lp_router": rows})
    return launches


def reachability():
    """examples/torch_reachability.py on the card, as a subprocess, with
    the card to itself."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_reachability.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, ("torch_reachability.py failed",
                                  proc.stdout[-2000:], proc.stderr[-4000:])
    emit({"reachability_example": "examples/torch_reachability.py",
          "exit": 0, "seconds": time.perf_counter() - t0,
          "output": proc.stdout.strip().splitlines()})



# ---- training on a mesh: the Sharder, expert parallelism, checkpoints -----

SHARDED_WORLD = 4             # ranks sharing the one card over gloo
SHARDED = {"mesh": (2, 2), "layers": 1, "batch": 2, "seq": 1024}
MOE_REL = 2.0 ** -7           # a rank's MoE output against one process's
# AdamW's step at full width runs where the card keeps this much free
# beside the four ranks' parameters, gradients and float32 moments
ADAMW_FREE_BYTES = 8e9
MESH_TWIN = {"mesh": "2x2", "steps": 4, "batch": 4, "seq": 32, "lr": 1e-3}
COMPRESSED = {"batch": 4, "seq": 64, "n_frames": 1500, "steps": 2,
              "lr": 1e-3}
# |dequantized - corrected| <= scale / 2 up to the float32 rounding of the
# quotient and the product: scale x (1/2 + 254 x 2^-24)
DEQUANT_SLACK = 1 + 2.0 ** -14

SHARDED_RANK = """
import time
marks = {"start": time.time()}   # the rank's timeline, wall clock
import hashlib, os, pickle, sys
import torch, torch.distributed as dist
rank, world, store, job_path, out = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.cuda.set_device(0)
marks["card"] = time.time()
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
marks["world"] = time.time()
import chip_smoke as cs
from repro_torch.distributed.sharding import (Sharder, make_mesh,
                                              param_spec)
marks["imported"] = time.time()
from repro_torch.distributed.steps import loss_and_grads
from repro_torch.kernels import ssm_scan_bwd, ssm_scan_bwd_plain
from repro_torch.models import build_model, mamba, moe
from repro_torch.optim import adamw
with open(job_path, "rb") as f:
    job = pickle.load(f)
cfg = job["cfg"]
mesh = make_mesh(job["mesh"], ("data", "model"))
marks["mesh"] = time.time()
# the mesh, not this script, turns on the deterministic algorithms that
# keep the replicas bit-equal
deterministic = torch.are_deterministic_algorithms_enabled()
shd = Sharder(cfg, mesh)

def digest(t):
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()

def bits(t):
    return int(t.detach().contiguous().view(torch.int16).sum(
        dtype=torch.int64))

t0 = time.perf_counter()
model = build_model(cfg, seed=job["seed"], shd=shd)
torch.cuda.synchronize()
init_s = time.perf_counter() - t0
marks["built"] = time.time()
batch = {k: torch.from_numpy(v).cuda() for k, v in job["batch"].items()}
kept = {"route": [], "local": []}
real_route, real_local = moe.route, moe._moe_local

def route(*args):
    kept["route"].append(real_route(*args))
    return kept["route"][-1]

def local(x, p, cfg, axis=None):
    y = real_local(x, p, cfg, axis)
    kept["local"].append((x.detach(), y.detach()))
    return y

moe.route, moe._moe_local = route, local
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
dist.barrier()
marks["model"] = time.time()
cs.zero_counts()
t0 = time.perf_counter()
loss, grads = loss_and_grads(model, batch, shd)
finite = all(bool(torch.isfinite(g).all()) for g in grads)
wall = time.perf_counter() - t0
launches = {k: v for k, v in cs.counts().items() if v}
peak = torch.cuda.max_memory_allocated()
moe.route, moe._moe_local = real_route, real_local
names = [n for n, _ in model.named_parameters()]
axes = {n: sorted(shd.shard_axes(param_spec(n, cfg))) for n in names}
digests = {n: digest(g) for n, g in zip(names, grads)}
marks["step"] = marks["model"] + wall
marks["digests"] = time.time()
fwd, rec = kept["route"][0], kept["route"][1]
x, y = kept["local"][0]
exchanges = mesh.exchanges()
got = {"rank": rank, "coords": mesh.coords, "loss": float(loss),
       "finite": finite, "wall_s": wall,
       "deterministic_from_the_mesh": deterministic, "marks": marks,
       "init_s": init_s, "peak_device_bytes": peak, "launches": launches,
       "exchange_host_s": exchanges["seconds"],
       "exchange_calls": exchanges["calls"],
       "params": sum(p.numel() for p in model.parameters()),
       "expert_slabs": model.blocks[0].mlp["w_gate"].shape[0],
       "shard_axes": axes, "digests": digests,
       "route_calls": len(kept["route"]),
       "recompute_routes_as_forward": all(
           torch.equal(a, b) for a, b in zip(fwd, rec)
           if isinstance(a, torch.Tensor)),
       "x": x.cpu(), "y": y.cpu(),
       "route": {f: getattr(fwd, f).cpu() for f in
                 ("expert", "slot", "keep", "caps", "demand")}}
if rank == 0:
    got["router"] = model.blocks[0].mlp["router"].detach().cpu()
del kept, fwd, rec, x, y, loss
# AdamW's step where the card keeps ADAMW_FREE_BYTES free beside the four
# ranks' float32 moments (the decision taken on the least free any rank
# sees, so that every rank takes it or none does)
torch.cuda.empty_cache()
dist.barrier()
free = torch.tensor([float(torch.cuda.mem_get_info()[0])])
dist.all_reduce(free, op=dist.ReduceOp.MIN)
moments = 8 * got["params"]
got["free_after_grads_bytes"] = float(free)
got["allocated_after_grads_bytes"] = torch.cuda.memory_allocated()
got["reserved_after_grads_bytes"] = torch.cuda.memory_reserved()
got["adamw_moment_bytes_a_rank"] = moments
step = float(free) - world * moments >= cs.ADAMW_FREE_BYTES
got["adamw_step_taken"] = step
if step:
    torch.cuda.reset_peak_memory_stats()
    params = list(model.parameters())
    before = [bits(p) for p in params]
    # lr 1.0: a bf16 parameter has no float32 master copy, so a smaller
    # step would leave entries unmoved
    opt = adamw(lr=1.0, warmup=1)
    state = opt.init(list(model.named_parameters()), shd=shd)
    t0 = time.perf_counter()
    opt.update(grads, state, params)
    torch.cuda.synchronize()
    got["adamw_step_s"] = time.perf_counter() - t0
    got["adamw_moved"] = sum(b != bits(p) for b, p in zip(before, params))
    got["adamw_leaves"] = len(params)
    got["adamw_finite"] = all(bool(torch.isfinite(p).all()) for p in params)
    got["adamw_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    del state, opt, params
del grads, model
torch.cuda.empty_cache()
marks["deepseek_done"] = time.time()

# falcon-mamba-7b at full width in the same world: d_inner over the model
# line, the scans on this rank's channels
fcfg = job["falcon_cfg"]
fshd = Sharder(fcfg, mesh)
fmodel = build_model(fcfg, seed=job["seed"], shd=fshd)
fbatch = {k: torch.from_numpy(v).cuda()
          for k, v in job["falcon_batch"].items()}
fkept, fn = {}, [0]
real_scan = mamba.ssm_scan_bt_ds

def keep_scan(dA, dBx, h0):
    if fn[0] == 0:
        fkept["fwd"] = (dA.detach(), dBx.detach(), h0.detach())
    fn[0] += 1
    return real_scan(dA, dBx, h0)

mamba.ssm_scan_bt_ds = keep_scan
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
dist.barrier()
before_ex = mesh.exchanges()
cs.zero_counts()
t0 = time.perf_counter()
with cs.bwd_inputs_kept(0) as bkept:
    floss, fgrads = loss_and_grads(fmodel, fbatch, fshd)
    torch.cuda.synchronize()
fwall = time.perf_counter() - t0
flaunch = {k: v for k, v in cs.counts().items() if v}
mamba.ssm_scan_bt_ds = real_scan
after_ex = mesh.exchanges()
fnames = [n for n, _ in fmodel.named_parameters()]
got["falcon"] = {
    "loss": float(floss), "wall_s": fwall, "launches": flaunch,
    "finite": all(bool(torch.isfinite(g).all()) for g in fgrads),
    "params": sum(p.numel() for p in fmodel.parameters()),
    "d_inner_local": fmodel.blocks[0].ssm["D"].shape[0],
    "peak_device_bytes": torch.cuda.max_memory_allocated(),
    "exchange_calls": after_ex["calls"] - before_ex["calls"],
    "exchange_host_s": after_ex["seconds"] - before_ex["seconds"],
    "shard_axes": {n: sorted(fshd.shard_axes(param_spec(n, fcfg)))
                   for n in fnames},
    "digests": {n: digest(g) for n, g in zip(fnames, fgrads)}}
del fgrads, fmodel
torch.cuda.empty_cache()
if rank == 0:
    # one captured launch of each scan against its plain version, then
    # each timed at the rank's shape while the other ranks wait
    dA, dBx, h0 = fkept["fwd"]
    bargs = tuple(t.detach() for t in bkept["args"])
    got["falcon"]["scan_shape"] = list(dA.shape)
    got["falcon"]["scan_max_abs_err"] = cs.scan_vs_plain(dA, dBx, h0)
    got["falcon"]["scan_bwd_max_abs_err"] = cs.scan_bwd_vs_plain(*bargs)
    from repro_torch.kernels import ssm_scan_bt_ds, ssm_scan_plain
    got["falcon"]["scan_ms"] = cs.timed_avg(
        lambda: ssm_scan_bt_ds(dA, dBx, h0))
    got["falcon"]["scan_plain_ms"] = cs.timed_avg(
        lambda: ssm_scan_plain(dA, dBx, h0), reps=3)
    got["falcon"]["scan_bwd_ms"] = cs.timed_avg(
        lambda: ssm_scan_bwd(*bargs))
    got["falcon"]["scan_bwd_plain_ms"] = cs.timed_avg(
        lambda: ssm_scan_bwd_plain(*bargs), reps=3)
    del dA, dBx, h0, bargs
marks["falcon_done"] = time.time()
with open(out + "." + str(rank), "wb") as f:
    pickle.dump(got, f)
dist.barrier()
dist.destroy_process_group()
"""

MESH_RANK = """
import time
marks = {"start": time.time()}   # rank 0's timeline, wall clock
import dataclasses, hashlib, json, os, pickle, shutil, sys
import numpy as np, torch, torch.distributed as dist
import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import (Sharder, gather_params,
                                              make_mesh, param_spec)
from repro_torch.kernels import simplex_tile
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import state_tree
from repro_torch.models import build_model
from repro_torch.optim import get_optimizer
with open(sys.argv[1]) as f:
    job = json.load(f)
# the CLI has no flag for the router or top-k, as the reference's has
# none: the config carries them
real_config = configs.get_config
configs.get_config = lambda arch: dataclasses.replace(real_config(arch),
                                                      **job["changes"])
seen = {}
real = train_mod.train

def keep(cfg, model, **kw):
    seen.update(cfg=cfg, model=model, shd=kw["shd"], dir=kw["checkpoint_dir"])
    return real(cfg, model, **kw)

train_mod.train = keep
marks["imported"] = time.time()
for run in job["runs"]:   # one CLI run after another in these processes
    if run.get("copy"):
        # started beside the run that writes the checkpoint: wait for its
        # (atomically renamed) step directory, then resume from a copy
        # (no world yet: the CLI joins it) rank 0 copies and renames, the
        # others wait for the copy
        src, dst = run["copy"]
        rank0 = int(os.environ["RANK"]) == 0
        if "--device" not in run["argv"]:
            torch.zeros(1, device="cuda")   # the context, while it waits
        # the module torch.use_deterministic_algorithms loads (10 s on the
        # card's host), which the CLI's mesh calls, while it waits
        import torch._inductor.config
        t0 = time.perf_counter()
        while not os.path.isdir(src if rank0 else dst):
            assert time.perf_counter() - t0 < 600, src
            time.sleep(0.2)
        if rank0:
            shutil.copytree(src, dst + ".copy")
            os.rename(dst + ".copy", dst)
        marks["copied"] = time.time()
    simplex_tile.launches = 0
    marks["cli"] = time.time()
    res = train_mod.main(run["argv"])
    marks["trained"] = time.time()
    launches = torch.tensor([simplex_tile.launches])
    parts = [torch.zeros_like(launches) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, launches)
    cfg, model, shd = seen["cfg"], seen["model"], seen["shd"]
    whole = gather_params({n: p.detach()
                           for n, p in model.named_parameters()}, shd)
    # every leaf, bit for bit, on every rank of the world that holds the
    # same block of it (the same coordinates on the axes that shard it)
    mine = {n: hashlib.sha256(p.detach().contiguous().view(torch.uint8)
                              .cpu().numpy().tobytes()).hexdigest()
            for n, p in model.named_parameters()}
    axes = {n: shd.shard_axes(param_spec(n, cfg)) for n in mine}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (shd.mesh.coords, mine))
    equal = all(d[n] == mine[n] for c, d in every for n in mine
                if all(c[a] == shd.mesh.coords[a] for a in axes[n]))
    # the (leaf, line) pairs check_replicas compares
    pairs = sum(shd.mesh.shape[a] > 1 and a not in axes[n]
                for n in mine for a in ("data", "model"))
    got = {"losses": res["losses"], "start": res["start"],
           "launches": [int(p) for p in parts],
           "replicas_checked": res["replicas_checked"],
           "step_s": res["step_s"], "marks": marks,
           "replicated_leaves": pairs,
           "replicas_equal": equal,
           "device": str(model.device),
           "params": {n: p.float().cpu().numpy() for n, p in whole.items()}}
    if run["restore"]:
        # the run's last checkpoint restored on a (1, 4) mesh of this
        # world, each rank its slice, gathered back
        shd4 = Sharder(cfg, make_mesh((1, 4), ("data", "model"),
                                      device=model.device))
        other = build_model(cfg, device=model.device, shd=shd4)
        state = get_optimizer("adamw").init(list(other.named_parameters()),
                                            shd=shd4)
        mgr = CheckpointManager(seen["dir"])
        back = mgr.restore(mgr.latest_step(), state_tree(other, state),
                           sharder=shd4, device=model.device)
        slab = back["params"]["blocks.0.mlp.w_gate"].shape[0]
        again = gather_params(back["params"], shd4)
        got["restored_1x4_equal"] = all(torch.equal(again[n], whole[n])
                                        for n in whole)
        got["restored_1x4_slab"] = slab
    marks["checked"] = time.time()
    if dist.get_rank() == 0:
        with open(run["out"], "wb") as f:
            pickle.dump(got, f)
dist.barrier()
dist.destroy_process_group()
"""


def sharded_scan(falcon, kind) -> dict:
    """The kernel table's shape row of the sharded falcon-mamba scan
    ("scan" or "scan_bwd")."""
    return {"shape": falcon["scan_shape"], "ms": falcon[f"{kind}_ms"],
            "plain_ms": falcon[f"{kind}_plain_ms"],
            "bound_ms": falcon[f"{kind}_bound_ms"], "yardstick_ms": None,
            "max_abs_err": falcon[f"{kind}_max_abs_err"],
            "path": "train falcon-mamba-7b sharded 2x2, rank 0"}


def shard_replicas_equal(ranks, part=None):
    """Whether every two ranks that hold the same block of a gradient
    (equal coordinates on each mesh axis that shards the leaf) hold the
    same bits of it, and the number of (leaf, pair of ranks) compared;
    ``part`` names a model's entry of each rank's result ("falcon"),
    None the ranks' own (deepseek-v2's)."""
    def get(g):
        return g if part is None else g[part]
    pairs = 0
    for name, axes in get(ranks[0])["shard_axes"].items():
        for a in ranks:
            for b in ranks:
                if a["rank"] >= b["rank"] or any(
                        a["coords"][ax] != b["coords"][ax] for ax in axes):
                    continue
                if get(a)["digests"][name] != get(b)["digests"][name]:
                    return False, pairs
                pairs += 1
    return True, pairs


def adamw_reckoning(n_params, world):
    """The bytes AdamW's step at full width needs on the card before the
    run: each rank's bf16 parameters and gradients, float32 moments
    (``opt_state_spec``: FSDP already cuts the residual dim, so ZeRO-1
    adds no cut here), the FSDP gather of its largest leaves (the three
    expert slabs of 80 x 5,120 x 1,536 gathered over data) and their
    gradients, an activation share scaled from PR 27's 1x4 run (16.04 GB
    peak at 2.19 B parameters a rank: 7.28 GB beside the parameters and
    gradients, for twice these tokens a rank) and a CUDA context."""
    gib = 1 << 30
    params = 2 * n_params
    grads = 2 * n_params
    moments = 8 * n_params
    gathered = 2 * 3 * (80 * 5120 * 1536 * 2)
    activations = 7.28e9 / 2
    context = 0.5 * gib
    step = params + grads + moments + context
    grads_peak = params + grads + gathered + activations + context
    return {"params_bytes": params, "grads_bytes": grads,
            "moment_bytes": moments, "fsdp_gathered_bytes": gathered,
            "activation_bytes": activations, "context_bytes": context,
            "grads_peak_bytes_a_rank": grads_peak,
            "step_bytes_a_rank": step,
            "four_ranks_bytes": world * max(step, grads_peak),
            "card_bytes": 80e9}


def sharded_deepseek(workdir):
    """(a) deepseek-v2-236b at its published width, 1 of 60 layers, bf16
    from SERVE_SEED, lp_capacity, remat per block and fsdp (as shipped),
    seq_sp as shipped, over a 2 x 2 mesh of SHARDED_WORLD processes that
    share the card over gloo, every rule acting: each rank holds its
    block of every leaf (80 of the 160 expert slabs, half the heads, the
    shared experts' ff_expert, the vocabulary, and the residual dim over
    data under FSDP).  One microbatch of 2 x 1,024 tokens through
    ``distributed.steps.loss_and_grads``, then AdamW's step where the
    card keeps ADAMW_FREE_BYTES free beside the four ranks' moments (the
    reckoning is printed first): every parameter moved, and finite.
    Then, in this process with the whole model: each rank's routing
    against one process's ``route`` of the same rank's tokens (the share
    routed alike printed; caps bit-equal to the plain version), each
    rank's MoE output within MOE_REL of one process's ``_moe_local``
    over all 160 experts.  In the same world after it: falcon-mamba-7b
    at full width, 1 of 64 layers, its d_inner of 8,192 cut to 4,096 a
    rank: its loss and gradients, the scans launched on the rank's
    channels (counted exactly), one captured launch of each bit-equal to
    its plain version and timed."""
    import pickle
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import _capacity, _moe_local, route
    cfg = dataclasses.replace(get_config(MLA_ARCH),
                              n_layers=SHARDED["layers"], lp_capacity=True)
    assert cfg.seq_shard and cfg.remat == "block" and cfg.fsdp, cfg
    fcfg = dataclasses.replace(get_config(SERVE_ARCH),
                               n_layers=SHARDED["layers"])
    assert (fcfg.d_inner, fcfg.remat) == (8192, "block"), fcfg
    rng = np.random.default_rng(SERVE_SEED)
    shape = (SHARDED["batch"], SHARDED["seq"])
    job = {"cfg": cfg, "mesh": SHARDED["mesh"], "seed": SERVE_SEED,
           "batch": {k: rng.integers(0, cfg.vocab, shape) for k in
                     ("tokens", "labels")},
           "falcon_cfg": fcfg,
           "falcon_batch": {k: rng.integers(0, fcfg.vocab, shape) for k in
                            ("tokens", "labels")}}
    # the parameters a rank, from the rules (about 1.27 B against PR 27's
    # 2.19 B at 1 x 4), and AdamW's reckoning, printed before the run
    from repro_torch.distributed.sharding import Mesh, Sharder, param_spec
    from repro_torch.models import LM
    meta = LM(cfg, device=torch.device("meta"))
    desc = Sharder(cfg, Mesh(SHARDED["mesh"], ("data", "model")))
    predicted = sum(int(np.prod([
        (sl.indices(n)[1] - sl.indices(n)[0])
        for sl, n in zip(desc.local_slices(param_spec(name, cfg), p.shape),
                         p.shape)]))
        for name, p in meta.named_parameters())
    whole_params = sum(p.numel() for p in meta.parameters())
    del meta
    reckoning = adamw_reckoning(predicted, SHARDED_WORLD)
    emit({"sharded_deepseek_predicted_params_a_rank": predicted,
          "whole_params": whole_params, "adamw_reckoning": reckoning})
    with open(workdir / "sharded.job", "wb") as f:
        pickle.dump(job, f)
    out = workdir / "sharded.out"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("CUBLAS_WORKSPACE_CONFIG", None)   # the mesh sets it
    # segments the allocator can give back to the card: after the
    # gradients, what the FSDP gathers and the activations took is free
    # for the moments (fixed segments that still hold a live block stay
    # reserved)
    env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0, wall0 = time.perf_counter(), time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARDED_RANK, str(r), str(SHARDED_WORLD),
         str(workdir / "sharded.store"), str(workdir / "sharded.job"),
         str(out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(SHARDED_WORLD)]
    for p in procs:
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, ("a rank failed", so[-2000:], se[-4000:])
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(SHARDED_WORLD):
        with open(f"{out}.{r}", "rb") as f:
            ranks.append(pickle.load(f))
    launches = [g["launches"] for g in ranks]
    assert all(set(n) == {"simplex_tile"} and n["simplex_tile"] == 2
               for n in launches), launches   # the forward and recompute
    assert all(g["finite"] and g["route_calls"] == 2 and
               g["recompute_routes_as_forward"] and
               g["deterministic_from_the_mesh"] for g in ranks)
    assert len({g["loss"] for g in ranks}) == 1 and \
        np.isfinite(ranks[0]["loss"])
    grads_equal, grad_pairs = shard_replicas_equal(ranks)
    assert grads_equal and grad_pairs > 0
    assert all(g["expert_slabs"] == cfg.n_experts // 2 for g in ranks)
    assert all(g["params"] == predicted for g in ranks), \
        ([g["params"] for g in ranks], predicted)
    step = ranks[0]["adamw_step_taken"]
    assert all(g["adamw_step_taken"] == step for g in ranks)
    if step:
        assert all(g["adamw_finite"] and
                   g["adamw_moved"] == g["adamw_leaves"] for g in ranks), \
            [(g["adamw_moved"], g["adamw_leaves"]) for g in ranks]
    # falcon-mamba: every rank's scans on its 4,096 channels, counted
    # exactly (the forward and the block's recompute: two chunks each;
    # the backward two), each captured launch bit-equal to the plain one
    falcon = [g["falcon"] for g in ranks]
    chunks = SHARDED["seq"] // SCAN_CHUNK
    want = {"ssm_scan": 2 * chunks * fcfg.n_layers,
            "ssm_scan_bwd": chunks * fcfg.n_layers}
    assert all(f["launches"] == want for f in falcon), \
        [f["launches"] for f in falcon]
    assert all(f["finite"] and f["d_inner_local"] == fcfg.d_inner // 2
               for f in falcon), falcon
    assert len({f["loss"] for f in falcon}) == 1
    assert falcon[0]["scan_shape"] == [SHARDED["batch"] // 2, SCAN_CHUNK,
                                       fcfg.d_inner // 2, fcfg.ssm_state]
    assert falcon[0]["scan_max_abs_err"] == 0.0
    assert falcon[0]["scan_bwd_max_abs_err"] == 0.0
    falcon_equal, falcon_pairs = shard_replicas_equal(ranks, "falcon")
    assert falcon_equal and falcon_pairs > 0
    # one process, the whole model drawn from the same seed
    whole = build_model(cfg, seed=SERVE_SEED)
    p = whole.blocks[0].mlp
    rank0 = Sharder(cfg, Mesh(SHARDED["mesh"], ("data", "model"), rank=0))
    cut = rank0.local_slices(param_spec("blocks.0.mlp.router", cfg),
                             p["router"].shape)
    assert torch.equal(p["router"].detach()[cut].cpu(), ranks[0]["router"])
    rows = []
    with torch.no_grad():
        for g in ranks:
            x = g["x"].cuda()
            N = x.shape[0]
            C = _capacity(N, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
            one = route(x, p["router"], cfg, C)
            alike = float((one.expert.cpu() == g["route"]["expert"])
                          .float().mean())
            caps_err = caps_vs_plain(one, C)
            ref = _moe_local(x, p, cfg).float().cpu()
            rel = float((g["y"].float() - ref).abs().max()
                        / ref.abs().max())
            rows.append({"rank": g["rank"], "tokens": N, "capacity": C,
                         "routed_alike_share": alike,
                         "caps_vs_plain_max_abs_err": caps_err,
                         "moe_output_rel_err": rel,
                         "kept_share": float(g["route"]["keep"].float()
                                             .mean())})
    del whole, p
    torch.cuda.empty_cache()
    assert all(r["caps_vs_plain_max_abs_err"] == 0.0 for r in rows), rows
    assert all(r["moe_output_rel_err"] <= MOE_REL for r in rows), rows
    n_params = ranks[0]["params"]
    f0 = falcon[0]
    scan_bytes = 4 * (3 * int(np.prod(f0["scan_shape"]))
                      + 2 * f0["scan_shape"][0] * int(np.prod(
                          f0["scan_shape"][2:])))
    bwd_bytes = 4 * (5 * int(np.prod(f0["scan_shape"]))
                     + 3 * f0["scan_shape"][0] * int(np.prod(
                         f0["scan_shape"][2:])))
    line = {"train_sharded": MLA_ARCH, "mesh": list(SHARDED["mesh"]),
            "ranks_on_one_card": SHARDED_WORLD, "backend": "gloo",
            "rules_acting": ["batch", "residual (FSDP)", "heads", "experts",
                             "ff_expert", "vocab", "ZeRO-1 (opt_state_spec,"
                             " no cut beyond FSDP's here)"],
            "config": {"n_layers": cfg.n_layers, "published_n_layers": 60,
                       "d_model": cfg.d_model, "n_experts": cfg.n_experts,
                       "top_k": cfg.top_k, "seq_shard": cfg.seq_shard,
                       "fsdp": cfg.fsdp, "remat": cfg.remat,
                       "lp_capacity": True,
                       "param_dtype": cfg.param_dtype},
            "batch": SHARDED["batch"], "seq": SHARDED["seq"],
            "seed": SERVE_SEED, "params_a_rank": n_params,
            "whole_params": whole_params,
            "bf16_param_and_grad_bytes_a_rank": 4 * n_params,
            "adamw_reckoning": reckoning,
            "free_after_grads_bytes": ranks[0]["free_after_grads_bytes"],
            "allocated_after_grads_bytes_a_rank": [
                g["allocated_after_grads_bytes"] for g in ranks],
            "reserved_after_grads_bytes_a_rank": [
                g["reserved_after_grads_bytes"] for g in ranks],
            "adamw_step_taken": step,
            "adamw": [{k: g.get(k) for k in (
                "adamw_step_s", "adamw_moved", "adamw_leaves",
                "adamw_finite", "adamw_peak_device_bytes")}
                for g in ranks] if step else None,
            "loss": ranks[0]["loss"],
            "router_launches": sum(n["simplex_tile"] for n in launches),
            "peak_device_bytes_a_rank": [g["peak_device_bytes"]
                                         for g in ranks],
            "loss_and_grads_wall_s": [g["wall_s"] for g in ranks],
            "exchange_host_s": [g["exchange_host_s"] for g in ranks],
            "exchange_calls": ranks[0]["exchange_calls"],
            "init_on_card_s": [g["init_s"] for g in ranks],
            "spawn_to_exit_s": spawn_s,
            # seconds after the spawn at which each rank had started
            # Python, reached the card, joined the world, drawn its model,
            # taken its step, digested its gradients and ended each model
            "rank_timeline_s": [{k: round(v - wall0, 3)
                                 for k, v in g["marks"].items()}
                                for g in ranks],
            "grads_equal_over_unsharded_axes": True,
            "grad_rank_pairs_compared": grad_pairs,
            "ranks": rows, "moe_rel_bound": MOE_REL,
            "falcon": {
                "arch": SERVE_ARCH, "n_layers": fcfg.n_layers,
                "published_n_layers": 64, "d_inner": fcfg.d_inner,
                "d_inner_a_rank": f0["d_inner_local"],
                "params_a_rank": f0["params"], "loss": f0["loss"],
                "launches_a_rank": f0["launches"],
                "scan_launches": sum(f["launches"]["ssm_scan"]
                                     for f in falcon),
                "scan_bwd_launches": sum(f["launches"]["ssm_scan_bwd"]
                                         for f in falcon),
                "scan_shape": f0["scan_shape"],
                "scan_max_abs_err": f0["scan_max_abs_err"],
                "scan_bwd_max_abs_err": f0["scan_bwd_max_abs_err"],
                "scan_ms": f0["scan_ms"], "scan_plain_ms": f0["scan_plain_ms"],
                "scan_bound_ms": scan_bytes / PEAK_BYTES * 1e3,
                "scan_bwd_ms": f0["scan_bwd_ms"],
                "scan_bwd_plain_ms": f0["scan_bwd_plain_ms"],
                "scan_bwd_bound_ms": bwd_bytes / PEAK_BYTES * 1e3,
                "loss_and_grads_wall_s": [f["wall_s"] for f in falcon],
                "peak_device_bytes_a_rank": [f["peak_device_bytes"]
                                             for f in falcon],
                "exchange_calls": f0["exchange_calls"],
                "exchange_host_s": [f["exchange_host_s"] for f in falcon],
                "grad_rank_pairs_compared": falcon_pairs}}
    emit(line)
    return line


def mesh_twin(workdir):
    """(b) the reduced llama4-scout (float32, lp_capacity, top-2) through
    ``python -m repro_torch.launch.train --mesh 2x2 --checkpoint-dir``
    in four processes with the environment torchrun gives its workers
    (the CLI's ``join_world`` reads it), each run resuming from one step-0
    checkpoint drawn on the card: 4 steps on the card and 4 on the CPU
    (losses and parameters
    within TWIN_ATOL), the replicated parameters bit-equal on every rank
    after them; on the card the straight run saves step 2 from its writer
    thread, and a world started beside it resumes from that checkpoint in
    new processes for 2 more, bit-equal to the 4 straight; that
    checkpoint restored on a 1 x 4 mesh and on one rank equals the saved
    whole arrays.  The three worlds run side by side."""
    import pickle
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.train import state_tree
    from repro_torch.models import build_model
    from repro_torch.optim import get_optimizer
    script = workdir / "mesh_rank.py"
    script.write_text(MESH_RANK)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t = MESH_TWIN
    changes = {"lp_capacity": True, "top_k": 2}
    base = ["--arch", MOE_ARCH, "--reduced", "--mesh", t["mesh"],
            "--batch", str(t["batch"]), "--seq", str(t["seq"]),
            "--lr", str(t["lr"]), "--log-every", "1"]

    def world(tag, runs, device=None):
        """One world of 4 ranks making ``runs`` (tag, steps,
        checkpoint dir, restore, extra arguments, checkpoint to wait for
        and copy) one after another; a waiter that returns {tag: what
        rank 0 wrote}."""
        job = {"changes": changes, "runs": [
            {"argv": base + ["--steps", str(steps), "--checkpoint-dir",
                             str(workdir / ckpt)] + extra
             + (["--device", device] if device else []),
             "out": str(workdir / f"{run}.out"), "restore": restore,
             "copy": copy}
            for run, steps, ckpt, restore, extra, copy in runs]}
        (workdir / f"{tag}.json").write_text(json.dumps(job))
        started[tag] = time.time()
        # the environment torchrun --standalone --nproc-per-node 4 gives
        # its workers, without torchrun's agent process (it took 14 s to
        # start them beside the other worlds)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(workdir / f"{tag}.json")],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="4",
                     LOCAL_WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(4)]

        def wait():
            for r, proc in enumerate(procs):
                so, se = proc.communicate(timeout=600)
                assert proc.returncode == 0, (tag, r, so[-2000:],
                                              se[-4000:])
            walls[tag] = time.perf_counter() - t0
            got = {}
            for run, *_ in runs:
                with open(workdir / f"{run}.out", "rb") as f:
                    got[run] = pickle.load(f)
            return got
        return wait

    # the CLI draws on its device, and the card's generator is not the
    # CPU's: every run starts from one checkpoint at step 0, drawn on the
    # card from the CLI's seed (the model each rank would draw, whole)
    cfg = dataclasses.replace(get_config(MOE_ARCH), **changes).reduced()
    t0 = time.perf_counter()
    start = build_model(cfg)
    state = get_optimizer("adamw").init(list(start.named_parameters()))
    for ckpt in ("straight", "cpu"):     # "resumed" gets straight's step 2
        CheckpointManager(str(workdir / ckpt)).save(
            0, state_tree(start, state), extra={"data_step": 0})
    del start, state
    walls, started = {}, {}
    half = t["steps"] // 2
    mid = f"step_{half:08d}"
    on_cpu = world("cpu_world", [("cpu", t["steps"], "cpu", False, [],
                                  None)], device="cpu")
    card = world("card_world", [("straight", t["steps"], "straight", False,
                                 ["--save-every", str(half)], None)])
    # the resume in new processes, then its checkpoint on a 1 x 4 mesh
    resume = world("resume_world", [
        ("second", t["steps"], "resumed", True, [],
         (str(workdir / "straight" / mid), str(workdir / "resumed" / mid)))])
    straight = card()["straight"]
    second = resume()["second"]
    cpu = on_cpu()["cpu"]
    wall = time.perf_counter() - t0
    assert straight["losses"][half:] == second["losses"]
    assert (straight["start"], cpu["start"], second["start"]) == (0, 0, half)
    replicas = {k: (r["replicas_equal"], r["replicas_checked"],
                    r["replicated_leaves"])
                for k, r in (("straight", straight), ("second", second),
                             ("cpu", cpu))}
    assert all(eq and checked > 0 and checked == n
               for eq, checked, n in replicas.values()), replicas
    resume_equal = all(np.array_equal(second["params"][n], v)
                       for n, v in straight["params"].items())
    assert resume_equal
    assert second["restored_1x4_equal"] and \
        second["restored_1x4_slab"] == 2
    loss_err = max(abs(a - b) for a, b in zip(straight["losses"],
                                              cpu["losses"]))
    param_err = max(float(np.abs(v - cpu["params"][n]).max())
                    for n, v in straight["params"].items())
    assert np.isfinite(straight["losses"]).all()
    assert max(loss_err, param_err) < TWIN_ATOL, (loss_err, param_err)
    # one rank restores the whole arrays
    whole = build_model(cfg, device="cpu")
    state = get_optimizer("adamw").init(list(whole.named_parameters()))
    mgr = CheckpointManager(str(workdir / "resumed"))
    back = mgr.restore(mgr.latest_step(), state_tree(whole, state))
    one_rank_equal = all(np.array_equal(back["params"][n].numpy(), v)
                         for n, v in second["params"].items())
    assert one_rank_equal and back["opt"]["step"] == t["steps"]
    # one launch a MoE layer a step on each rank (remat off, one
    # microbatch)
    launches = {tag: r["launches"] for tag, r in
                (("straight", straight), ("second", second))}
    want = {"straight": t["steps"], "second": t["steps"] - half}
    assert all(v == [cfg.n_layers * want[k]] * 4
               for k, v in launches.items()), launches
    line = {"train_mesh_twin": MOE_ARCH, "config": "reduced, float32, "
            "lp_capacity, top_k 2, remat none", **t,
            "cli": "repro_torch.launch.train.main, four processes with "
                   "torchrun's environment (RANK, LOCAL_RANK, WORLD_SIZE, "
                   "LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT): "
                   + " ".join(base),
            "card_losses": straight["losses"], "cpu_losses": cpu["losses"],
            "card_vs_cpu_loss_max_abs_err": loss_err,
            "card_vs_cpu_param_max_abs_err": param_err,
            "atol": TWIN_ATOL, "resume_bit_equal": resume_equal,
            "resumed_from": f"straight/{mid}, saved from the writer thread",
            "replicas_equal_checked_leaves": replicas,
            "restored_1x4_equal": True, "restored_one_rank_equal": True,
            "router_launches_by_run_and_rank": launches,
            "wall_s": wall, "done_after_s": walls,
            # each world's rank 0, seconds after its processes started:
            # Python started, imports done, (the checkpoint copied), the
            # CLI called and returned, the checks done
            "rank0_timeline_s": {
                tag: {k: round(v - started[w], 3)
                      for k, v in r["marks"].items()}
                for tag, w, r in (("straight", "card_world", straight),
                                  ("second", "resume_world", second),
                                  ("cpu", "cpu_world", cpu))},
            "step_s": {"straight": straight["step_s"],
                       "second": second["step_s"], "cpu": cpu["step_s"]}}
    emit(line)
    assert straight["device"].startswith("cuda") and cpu["device"] == "cpu"
    return line


def compressed_whisper():
    """(c) whisper-small whole (bf16 from SERVE_SEED) through two steps of
    ``distributed.compression.make_compressed_train_step`` with AdamW on
    the card: every leaf's dequantization error within scale / 2
    (DEQUANT_SLACK), the error-feedback residual equal to ``corrected -
    c`` bit for bit, the losses finite."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.distributed import compression
    from repro_torch.launch.train import step_batch
    from repro_torch.models import build_model
    from repro_torch.optim import get_optimizer
    cfg = get_config(ENCDEC_ARCH)
    c = COMPRESSED
    model = build_model(cfg, seed=SERVE_SEED)
    params = list(model.parameters())
    opt = get_optimizer("adamw", lr=c["lr"])
    state, ef = opt.init(params), compression.ef_init(params)
    real, seen = compression.ef_compress_tree, {}

    def keep(grads, ef_state):
        out, new = real(grads, ef_state)
        seen["call"] = (grads, list(ef_state), out, new)
        return out, new

    step = compression.make_compressed_train_step(model, opt)
    data = DataPipeline(vocab=cfg.vocab, batch=c["batch"], seq=c["seq"],
                        seed=SERVE_SEED)
    losses, worst, ef_equal = [], 0.0, True
    compression.ef_compress_tree = keep
    try:
        for s in range(c["steps"]):
            b = step_batch(cfg, data, s, seed=SERVE_SEED,
                           n_frames=c["n_frames"], device=model.device)
            t0 = time.perf_counter()
            m = step(state, ef, b)
            losses.append(float(m["loss"]))
            step_s = time.perf_counter() - t0
            grads, e_in, out, new = seen.pop("call")
            with torch.no_grad():
                for g, e, q, e2 in zip(grads, e_in, out, new):
                    corrected = g.float() + e
                    scale = torch.clamp(corrected.abs().max() / 127.0,
                                        min=1e-12)
                    err = (q - corrected).abs().max()
                    worst = max(worst, float(err / (scale / 2)))
                    ef_equal &= bool(torch.equal(e2, corrected - q))
            del grads, e_in, out, new
    finally:
        compression.ef_compress_tree = real
    assert np.isfinite(losses).all() and ef_equal, (losses, ef_equal)
    assert worst <= DEQUANT_SLACK, worst
    line = {"train_compressed": ENCDEC_ARCH, "batch": c["batch"],
            "seq": c["seq"], "n_frames": c["n_frames"],
            "steps": c["steps"], "lr": c["lr"], "leaves": len(params),
            "params": sum(p.numel() for p in params), "losses": losses,
            "last_step_s": step_s,
            "max_dequant_err_over_half_scale": worst,
            "slack": DEQUANT_SLACK, "ef_residual_bit_equal": ef_equal}
    emit(line)
    del model, params, state, ef
    torch.cuda.empty_cache()
    return line


def training_sharded(workdir):
    """The phase: (a) sharded_deepseek, (b) mesh_twin, (c)
    compressed_whisper.  The router's and the scans' kernels are built
    here, once, before any rank loads them.  Returns their lines."""
    import torch
    from repro_torch.kernels import _build
    _build.build(("simplex_tile", "ssm_scan"))
    # the four ranks of (a) take about 64 GB: this process keeps nothing
    # cached beside them
    torch.cuda.empty_cache()
    emit({"training_sharded_parent_reserved_bytes":
          torch.cuda.memory_reserved()})
    with phase("training_sharded.deepseek"):
        a = sharded_deepseek(workdir)
    with phase("training_sharded.mesh_twin"):
        b = mesh_twin(workdir)
    with phase("training_sharded.compressed"):
        c = compressed_whisper()
    return {"deepseek": a, "mesh_twin": b, "compressed": c}


# ---- the dry run: the host's reckoning and one rank run on the card ------
DRYRUN_CELLS = (("falcon-mamba-7b", "prefill_32k"),
                ("hymba-1.5b", "decode_32k"),
                ("llama3-405b", "train_4k"))
DRYRUN_HOST = """
import os, sys
os.nice(19)
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun, dryrun_lp
out = sys.argv[1]
cells = [c.split(":") for c in sys.argv[2:]]
dryrun.run_cell(*cells[0], False, out)
dryrun_lp.main(["--out", os.path.join(out, "lp")])
for arch, shape in cells[1:]:
    dryrun.run_cell(arch, shape, False, out)
"""
SCAN_PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
DRYRUN_FLOPS_REL = 0.01
DRYRUN_PEAK_REL = 0.20
LP_BLOCK = 196                # ceil(50,000 / 256): rank 0's lp_100d_50k


_DRYRUN = []


def start_dryrun_host(out: Path):
    """The host's dry run of DRYRUN_CELLS and of the LP workloads, in a
    process of its own (the CPU's work, beside the card's), writing
    ``launch/dryrun.py``'s records under ``out``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_HOST, str(out)]
        + [f"{a}:{s}" for a, s in DRYRUN_CELLS], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _DRYRUN.append(proc)
    return proc


def stop_dryrun_host():
    while _DRYRUN:
        proc = _DRYRUN.pop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def wait_dryrun_host(proc, out: Path, timeout=600) -> tuple:
    """The records of ``start_dryrun_host``'s process once it ends:
    ({(arch, shape): record}, {workload: record}, its seconds waited)."""
    t0 = time.perf_counter()
    log, _ = proc.communicate(timeout=timeout)
    waited = time.perf_counter() - t0
    assert proc.returncode == 0, log[-4000:]
    cells = {}
    for arch, shape in DRYRUN_CELLS:
        rec = json.loads((out / f"{arch}__{shape}__16x16.json").read_text())
        assert "roofline" in rec, (arch, shape, rec.get("error"),
                                   rec.get("traceback"))
        cells[(arch, shape)] = rec
    lps = {p.name.split("__")[0]: json.loads(p.read_text())
           for p in sorted((out / "lp").glob("*.json"))}
    return cells, lps, waited


def dryrun_summary(rec) -> dict:
    """A record's numbers for the log: memory and fits against 80 GB,
    flops, bytes, collectives, kernel charges, the roofline, the
    placements the port does not execute."""
    from repro_torch.analysis.report import fits
    ma = rec["memory_analysis"]
    return {"dryrun_cell": f"{rec['arch']} {rec['shape']} {rec['mesh']}",
            "total_params": rec["total_params"], "memory_analysis": ma,
            "args_plus_temp_gb": (ma["argument_size_in_bytes"]
                                  + ma["temp_size_in_bytes"]) / 1e9,
            "fits_80gb": fits(rec), "op_cost": rec["op_cost"],
            "collectives": rec["collectives"], "kernels": rec["kernels"],
            "roofline": rec["roofline"], "trace_s": rec["trace_s"],
            "placement_gaps": rec["placement_gaps"]}


def product_flops(rec) -> float:
    """The dry run's flops of the matrix products alone: its total less
    the kernel charges (the profiler sees no custom kernel)."""
    return rec["op_cost"]["flops"] - sum(k["flops"] for k in
                                         rec["kernels"].values())


def profiled_products(mesh, layers: int, calls=()) -> tuple:
    """The matrix products' flops by the profiler (host operators, shapes
    recorded) of rank 0's falcon-mamba-7b prefill_32k cut to ``layers``
    layers at its widths, and the scan inputs of launches ``calls``
    (``scan_inputs_kept``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=layers)
    with torch.no_grad():
        cell = build_cell("falcon-mamba-7b", "prefill_32k", mesh, cfg=cfg,
                          device="cuda", seed=SERVE_SEED)
    with scan_inputs_kept(set(calls)) as kept, profile(
            activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        cell["fn"](*cell["args"])
        torch.cuda.synchronize()
    return sum(e.flops for e in prof.key_averages()
               if e.key in SCAN_PRODUCTS), kept


def dryrun_rank_on_card(rec) -> dict:
    """Rank 0's share of falcon-mamba-7b prefill_32k at 16 x 16 run for
    real on the card, against the dry run's record ``rec``."""
    import torch
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(abstract=True, device=torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with torch.no_grad():
        cell = build_cell("falcon-mamba-7b", "prefill_32k", mesh,
                          device="cuda", seed=SERVE_SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    args_bytes = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = cell["fn"](*cell["args"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = only("ssm_scan")
    peak = torch.cuda.max_memory_allocated() - base
    assert all(bool(torch.isfinite(t).all()) for t in (out[0],
                                                       out[1].h))
    del out
    # the products' flops from the profiler at 1 and 2 layers of the
    # same widths, taken to the cell's depth: every layer runs the same
    # products, so they are linear in the layers (profiling all 64 layers
    # took 94 s, nearly all of it the host events); one launch's inputs
    # kept for their shapes
    t0 = time.perf_counter()
    one, kept = profiled_products(mesh, 1, calls=(0,))
    two, _ = profiled_products(mesh, 2)
    layers = cell["cfg"].n_layers
    flops = one + (layers - 1) * (two - one)
    profile_s = time.perf_counter() - t0
    err, wrong = seeded_scan_check(*kept[0])
    ma = rec["memory_analysis"]
    reckoned = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
    want_flops = product_flops(rec)
    charges = rec["kernels"]["ssm_scan"]["launches"]
    rl = rec["roofline"]
    info = {"dryrun_on_card": "falcon-mamba-7b prefill_32k rank 0 of 16x16",
            "build_s": build_s, "wall_s": wall,
            "roofline_largest_s": max(rl["compute_s"], rl["memory_s"],
                                      rl["collective_s"]),
            "roofline_bottleneck": rl["bottleneck"],
            "scan_launches": launches, "scan_charges": charges,
            "argument_bytes_on_card": args_bytes,
            "argument_size_in_bytes": ma["argument_size_in_bytes"],
            "peak_bytes_on_card": peak, "args_plus_temp_bytes": reckoned,
            "peak_rel_diff": peak / reckoned - 1.0,
            "product_flops_profiler": flops,
            "product_flops_dryrun": want_flops,
            "flops_rel_diff": flops / want_flops - 1.0,
            "product_flops_profiler_1_2_layers": [one, two],
            "flops_compared": "aten mm, addmm, bmm and baddbmm on both "
                              "sides; the scan kernel's charge left out "
                              "(the profiler counts no custom kernel); "
                              "the profiler's at 1 and 2 layers taken "
                              "to the cell's depth",
            "profile_s": profile_s,
            "scan_vs_plain_max_abs_err": err,
            "scan_check": "seeded dA in (0, 1), dBx and h0 at the shapes "
                          "of the rank's first launch",
            "scan_wrong_kernels_err": wrong,
            "values": "the abstract mesh's collectives return zeros: the "
                      "rank's compute and memory are real, its values are "
                      "not the model's (its scans see dBx = 0 and h0 = 0)"}
    emit(info)
    assert launches == charges, info
    assert abs(info["flops_rel_diff"]) <= DRYRUN_FLOPS_REL, info
    assert abs(info["peak_rel_diff"]) <= DRYRUN_PEAK_REL, info
    del cell
    torch.cuda.empty_cache()
    return info


def seeded_scan_check(dA, dBx, h0) -> tuple:
    """The scan kernel against its plain version on seeded inputs of the
    shapes and dtypes of a launch on the path (``dA``, ``dBx``, ``h0``,
    whose values the abstract mesh's zeros make trivial): dA in (0, 1),
    dBx and h0 standard normal.  Returns (the largest |kernel - plain|,
    which must be 0, and that of two wrong kernels against plain, one
    writing zeros and one a time step late, which must not be: the check
    can fail)."""
    import torch
    from repro_torch.kernels import ssm_scan_plain
    g = torch.Generator(device=dA.device).manual_seed(SERVE_SEED)
    args = (torch.rand(dA.shape, generator=g, device=dA.device,
                       dtype=dA.dtype) * 0.98 + 0.01,
            torch.randn(dBx.shape, generator=g, device=dBx.device,
                        dtype=dBx.dtype),
            torch.randn(h0.shape, generator=g, device=h0.device,
                        dtype=h0.dtype))
    err = scan_vs_plain(*args)
    hs, _ = ssm_scan_plain(*args)
    wrong = {"zeros": float(hs.abs().max()),
             "late": float((hs.roll(1, dims=1) - hs).abs().max())}
    assert err == 0.0, ("scan kernel vs plain", err)
    assert min(wrong.values()) > 0.0, ("the check cannot fail", wrong)
    return err, wrong


def dryrun_lp_block(lp_block, rec) -> dict:
    """Rank 0's block of lp_100d_50k at 16 x 16 through the whole-solve
    simplex kernel, against the LP dry run's record ``rec``."""
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.simplex_tile import WORK_COUNTERS, simplex_tile
    m, n = lp_block.m, lp_block.n
    A, b, c, ub = batch_tensors(lp_block, torch.device("cuda"))
    work = torch.zeros((lp_block.batch, WORK_COUNTERS), dtype=torch.int32,
                       device="cuda")
    run = lambda: simplex_tile(A, b, c, ub, m=m, n=n,  # noqa: E731
                               max_iters=default_max_iters(m, n), work=work)
    run()                         # warm: the first launch loads the module
    zero_counts()
    out, ms = timed(run)
    launches = only("simplex_tile")
    one = rec["shard_map"]
    info = {"dryrun_lp_block": f"lp_100d_50k rank 0 of {rec['mesh']}",
            "lps": lp_block.batch, "kernel_ms": ms,
            "mean_pivots_measured": float(out[3].double().mean()),
            "mean_pivots_oracle_sample": rec["mean_pivots"],
            "optimal": int((out[2] == 0).sum()),
            "reckoned_compute_ms": one["compute_s"] * 1e3,
            "reckoned_compute_f32_ms": one["compute_s_f32"] * 1e3,
            "reckoned_memory_ms": one["memory_s"] * 1e3,
            "reckoned_collective_ms": one["collective_s"] * 1e3}
    emit(info)
    assert launches == 1 and lp_block.batch == LP_BLOCK == rec["lps_per_dev"]
    return info


def dryrun_phase(host, out: Path, lp_block) -> dict:
    """Phase ``dryrun`` (module docstring): (a) the host's records, (b)
    one rank on the card, (c) one rank's LP block."""
    cells, lps, waited = wait_dryrun_host(host, out)
    emit({"dryrun_host_waited_s": waited})
    for rec in cells.values():
        emit(dryrun_summary(rec))
    for name, rec in lps.items():
        one = rec["shard_map"]
        emit({"dryrun_lp": name, "mean_pivots": rec["mean_pivots"],
              "m_device": rec["m_device"], "n_device": rec["n_device"],
              **{k: one[k] for k in (
                  "flops_per_dev", "analytic_flops_per_dev",
                  "mem_bytes_per_dev", "collective_bytes_per_dev",
                  "compute_s", "compute_s_f32", "memory_s",
                  "collective_s")}})
    rank = dryrun_rank_on_card(cells[("falcon-mamba-7b", "prefill_32k")])
    block = dryrun_lp_block(lp_block, lps["lp_100d_50k"])
    return {"rank": rank, "block": block}



def pdhg_only(parent_src) -> int:
    """Build, trace the PDHG kernel on the lp_100d_50k slice and time it
    against the pdhg_tile.cu at ``parent_src`` in turns."""
    import numpy as np
    from repro_torch.core import random_lp_batch
    from repro_torch.kernels import _build
    took = _build.build(("pdhg_tile",))
    pdhg_trace_build()
    emit({"build": took})
    pdhg_ptxas()
    counter_free_vs_parent("pdhg_tile", parent_src)
    lp100 = random_lp_batch(np.random.default_rng(2018), B=50_000, m=100,
                            n=100, feasible_start=False)
    pdhg_trace(lp100)
    pdhg_ab(parent_src, lp100)
    print(gpu_line(), flush=True)
    return 0


def simplex_only(parent_src) -> int:
    """Build, trace the simplex kernels on the lp_100d_50k and
    lp_afiro_100k slices and time them against the simplex_tile.cu at
    ``parent_src`` in turns: all of lp_100d_50k (whole solve and the
    compaction schedule), and the 2,048-LP slices of lp_afiro_100k and
    sc205_like (``device``, at a 600-step cap)."""
    import numpy as np
    from repro_torch.core import canonicalize, random_lp_batch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.io import fixture_path, perturbed_batch, read_mps
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    builds = [threading.Thread(target=f) for f in (
        simplex_trace_build,
        lambda: _build.load("simplex_tile_parent", src=parent_src))]
    for t in builds:
        t.start()
    took = _build.build(("simplex_tile",))
    for t in builds:
        t.join()
    emit({"build": took, "build_s": time.perf_counter() - t0})
    simplex_ptxas()
    counter_free_vs_parent("simplex_tile", parent_src)
    lp100 = random_lp_batch(np.random.default_rng(2018), B=50_000, m=100,
                            n=100, feasible_start=False)
    lp_af, _ = canonicalize(perturbed_batch(read_mps(fixture_path("afiro")),
                                            SLICE))
    sc205, _ = canonicalize(perturbed_batch(
        read_mps(fixture_path("sc205_like")), SLICE))
    simplex_trace(lp100, lp_af)
    simplex_ab(parent_src, lp100, (
        ("lp_afiro_100k", lp_af, default_max_iters(lp_af.m, lp_af.n)),
        ("sc205_like_2k", sc205, 600)))
    print(gpu_line(), flush=True)
    return 0


def revised_only(parent_src) -> int:
    """Build, trace the revised kernel on the lp_100d_50k and lp_afiro_100k
    slices and time it against the revised_tile.cu at ``parent_src`` in
    turns: all of lp_100d_50k, and the 2,048-LP slices of lp_afiro_100k
    and sc205_like (``device``, at the 600-step cap of its kernel check)."""
    import numpy as np
    from repro_torch.core import canonicalize, random_lp_batch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.io import fixture_path, perturbed_batch, read_mps
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    builds = [threading.Thread(target=f) for f in (
        revised_trace_build,
        lambda: _build.load("revised_tile_parent", src=parent_src))]
    for t in builds:
        t.start()
    took = _build.build(("revised_tile",))
    for t in builds:
        t.join()
    emit({"build": took, "build_s": time.perf_counter() - t0})
    revised_ptxas()
    counter_free_vs_parent("revised_tile", parent_src)
    lp100 = random_lp_batch(np.random.default_rng(2018), B=50_000, m=100,
                            n=100, feasible_start=False)
    lp_af, _ = canonicalize(perturbed_batch(read_mps(fixture_path("afiro")),
                                            SLICE))
    sc205, _ = canonicalize(perturbed_batch(
        read_mps(fixture_path("sc205_like")), SLICE))
    revised_trace(lp100, lp_af)
    revised_ab(parent_src, lp100, (
        ("lp_afiro_100k", lp_af, default_max_iters(lp_af.m, lp_af.n)),
        ("sc205_like_2k", sc205, 600)))
    print(gpu_line(), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pdhg-parent", metavar="SRC",
                    help="run only the PDHG kernel's trace and its timing "
                         "against the pdhg_tile.cu at SRC, in turns")
    ap.add_argument("--revised-parent", metavar="SRC",
                    help="run only the revised kernel's trace and its "
                         "timing against the revised_tile.cu at SRC, in "
                         "turns")
    ap.add_argument("--simplex-parent", metavar="SRC",
                    help="run only the simplex kernels' trace and their "
                         "timing against the simplex_tile.cu at SRC, in "
                         "turns")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.pdhg_parent:
        return pdhg_only(args.pdhg_parent)
    if args.revised_parent:
        return revised_only(args.revised_parent)
    if args.simplex_parent:
        return simplex_only(args.simplex_parent)
    try:
        return smoke()
    finally:
        stop_plain_pool()
        stop_training_data()
        stop_dryrun_host()


def first_members(g, k):
    """The general-form batch ``g`` cut to its first ``k`` members."""
    return dataclasses.replace(g, A=g.A[:k], rhs=g.rhs[:k], lb=g.lb[:k],
                               ub=g.ub[:k], c=g.c[:k], c0=g.c0[:k])


def smoke() -> int:
    """The default run (module docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import LPBatch, canonicalize
    from repro_torch.io import fixture_path, perturbed_batch, read_mps
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    # the host's dry run, beside everything the card does (phase dryrun)
    dryrun_out = Path(ROOT) / "build" / "dryrun"
    dryrun_host = start_dryrun_host(dryrun_out)
    # the kernels' cycle-counter builds and traces (pdhg_trace,
    # revised_trace, simplex_trace) run in the --*-parent modes only
    took, failed = {}, []

    def build_all():
        try:
            took.update(_build.build())
        except BaseException as e:   # re-raised below, after the join
            failed.append(e)
    build_thread = threading.Thread(target=build_all)
    build_thread.start()
    # meanwhile the plain-version workers start: they rebuild by hand the
    # batches this script used to build (to hold build_batch's against
    # them), build the workloads no phase solves and run the plain
    # versions the checks hand over below
    plain_pool()
    # and the training runs' batches, on idle cores
    start_training_data()
    lp100, g, lp300, digests = main_batches()
    behind = {name: Behind(built_workload, name)
              for name in ("lp_100d_50k", "lp_300d_2k", "lp_afiro_100k")}
    # create the CUDA context before any timed run, so that no main-path
    # wall time includes it
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    emit({"cuda_context_s": time.perf_counter() - t0})
    lp_af, _ = canonicalize(g)
    # the device-memory variant; most of these LPs run to max_iters in f32
    # (as in the reference), so the plain version takes a slice of them and,
    # for steepest edge, a shorter budget given to both and a smaller slice
    sc205, _ = canonicalize(perturbed_batch(
        read_mps(fixture_path("sc205_like")), SLICE))
    assert simplex_variant(sc205.m, sc205.n) == "device"
    checks, blocks = {}, {}

    def ahead(key, check):
        checks[key] = start(check)

    def done(*key, value=None):
        return finish(checks.pop(key), value)

    # ---- every check whose plain version runs on a worker hands it over
    # now, the longest first so that the workers end together; the plain
    # versions of the rows the kernel table reports run in this process
    # (``here``) when their checks finish, after the workers have gone
    se = "steepest_edge"
    with phase("hand_over"):
        # sc205_like: a 600-step budget for every rule of the schedule
        # (most members run to the cap in f32), the plain version on the
        # first 128
        ahead(("schedule", "sc205", se), compare_schedule(
            "sc205_like_2k", sc205, se, n_plain=128, max_iters=600))
        for rule in (se, "devex", "dantzig"):
            ahead(("compare", "sc205", rule), compare(
                "sc205_like_2k", sc205, rule, n_plain=128,
                max_iters=600 if rule == se else None))
        for rule in REVISED_RULES:
            ahead(("revised_schedule", "lp_100d_50k", rule),
                  compare_revised_schedule("lp_100d_50k", lp100, rule))
            # the device-memory workspace
            ahead(("revised", "sc205", rule), compare_revised(
                "sc205_like_2k", sc205, rule, n_plain=128, max_iters=600))
        # every PDHG variant and step rule against the plain version:
        # registers (lp_100d_50k 256 threads, lp_afiro_100k one warp),
        # shared (sc205_like), device (lp_300d_2k).  The linesearch costs
        # the plain version up to 13 matvecs an iteration: a shorter
        # budget and the first 128 LPs
        ahead(("pdhg", "lp100", "malitsky_pock"), compare_pdhg(
            "lp_100d_50k", lp100, "malitsky_pock", n_plain=128,
            max_iters=1600))
        for rule in ("devex", "dantzig"):
            ahead(("schedule", "sc205", rule), compare_schedule(
                "sc205_like_2k", sc205, rule, n_plain=128, max_iters=600))
        for rule in RULES:
            here = rule == "dantzig"
            ahead(("schedule", "lp100", rule), compare_schedule(
                "lp_100d_50k", lp100, rule, here=here))
            ahead(("compare", "lp100", rule), compare("lp_100d_50k", lp100,
                                                      rule, here=here))
        # sc205_like: A in shared memory, one block per SM, at a budget
        # that keeps the plain version's lockstep loop short
        ahead(("pdhg", "sc205", "malitsky_pock"), compare_pdhg(
            "sc205_like_2k", sc205, "malitsky_pock", n_plain=32,
            max_iters=800))
        for rule in REVISED_RULES:
            ahead(("revised", "lp_100d_50k", rule), compare_revised(
                "lp_100d_50k", lp100, rule, here=rule == "dantzig"))
        ahead(("pdhg", "lp300", "malitsky_pock"), compare_pdhg(
            "lp_300d_2k", lp300, "malitsky_pock", n_lp=256, n_plain=16,
            max_iters=800))
        ahead(("pdhg", "afiro", "malitsky_pock"), compare_pdhg(
            "lp_afiro_100k", lp_af, "malitsky_pock", n_plain=128,
            max_iters=1600))
        ahead(("pdhg", "sc205", "fixed"), compare_pdhg(
            "sc205_like_2k", sc205, "fixed", n_plain=128, max_iters=4000))
        ahead(("pdhg", "lp100", "fixed"), compare_pdhg(
            "lp_100d_50k", lp100, "fixed", max_iters=PDHG_PLAIN_CAP,
            here=True))
        ahead(("pdhg_schedule",), compare_pdhg_schedule("lp_100d_50k", lp100,
                                                        here=True))
        ahead(("pdhg", "afiro", "fixed"), compare_pdhg("lp_afiro_100k",
                                                       lp_af, "fixed"))
        for rule in RULES:
            ahead(("compare", "afiro", rule), compare("lp_afiro_100k", lp_af,
                                                      rule))
            ahead(("schedule", "afiro", rule), compare_schedule(
                "lp_afiro_100k", lp_af, rule))
        for rule in REVISED_RULES:
            ahead(("revised", "lp_afiro_100k", rule), compare_revised(
                "lp_afiro_100k", lp_af, rule))
            ahead(("revised_schedule", "lp_afiro_100k", rule),
                  compare_revised_schedule("lp_afiro_100k", lp_af, rule))

    build_thread.join()
    if failed:
        raise failed[0]
    ptxas = []
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log")
        ptxas += [ln.strip() for ln in report.read_text().splitlines()
                  if "registers" in ln or "spill" in ln]
    emit({"build_s": time.perf_counter() - t_start, "nvcc_s": took,
          "ptxas": ptxas[:40]})
    ptx = {"pdhg_segment": pdhg_ptxas(), "revised_segment": revised_ptxas(),
           "simplex_segment": simplex_ptxas()}
    with phase("plain_versions"):
        # lp_300d_2k: the device-memory variant, whose members need 19,000
        # iterations and more, at a cap where some converge, the plain
        # version on those the kernel solved first (so the kernel runs
        # first, now that it is built) and on members still running at the
        # cap
        ahead(("pdhg", "lp300", "fixed"), compare_pdhg(
            "lp_300d_2k", lp300, "fixed", n_lp=256, n_plain=64,
            max_iters=40_000, solved_first=True))
        # lp_sc50b_like_50k's solve is host-bound (the canonicalization of
        # 50,000 general-form LPs): it runs while this process would wait
        # for the workers, who share the card with it, and says so
        sc50b = solve_workload("lp_sc50b_like_50k")
        sc50b["card_shared_with"] = f"{PLAIN_WORKERS} plain-version workers"
        emit({"plain_workers": PLAIN_WORKERS, "wait_s": wait_plain()})

    # ---- main path: the two paper workloads through solve_batched ---------
    with phase("main_path"):
        head = LPBatch(A=lp100.A[:64], b=lp100.b[:64], c=lp100.c[:64])
        res_100, n, wall_100 = solve_main("lp_100d_50k", lp100, head)
        path_launches("simplex_tile", "main_path lp_100d_50k", n)
        afiro = read_mps(fixture_path("afiro"))
        g64 = first_members(g, 64)
        res_af, n, _ = solve_main("lp_afiro_100k", g, g64)
        path_launches("simplex_tile", "main_path lp_afiro_100k", n)
        assert res_af.status[0] == 0
        np.testing.assert_allclose(res_af.objective[0], AFIRO_OPT, rtol=1e-4)
        emit({"afiro_member0_objective": float(res_af.objective[0]),
              "published": AFIRO_OPT})
        check_main_batches((lp100, g, lp300), digests)

    # ---- kernel vs plain version on the card ------------------------------
    with phase("simplex_checks"):
        full_100 = kernel_at_full_batch("lp_100d_50k", lp100)
        kernel_at_full_batch("lp_afiro_100k", lp_af)
        rows = []
        for rule in RULES:
            rows.append(done("compare", "lp100", rule))
            done("compare", "afiro", rule)
        for rule in RULES:
            done("compare", "sc205", rule)

    # ---- compaction path: the segment kernel under the scheduler ----------
    with phase("compaction"):
        n, res_comp, comp_stats = compaction_main(lp100, res_100, wall_100,
                                                  full_100)
        path_launches("simplex_segment", "compaction lp_100d_50k", n)
        segment_at_full_batch(lp100, full_100)
        kernel_at_full_batch("lp_100d_50k", lp100)
        seg_full = segment_at_full_batch(lp100, full_100)
        for cap in (200, 420):   # all 2,048 LPs at the cap; about half
            binding_budget(lp100, cap)
        seg_rows = []
        for rule in RULES:
            seg_rows.append(done("schedule", "lp100", rule))
            done("schedule", "afiro", rule)
        for rule in RULES:
            done("schedule", "sc205", rule)

    # ---- the paper's workloads, multi-rank solving, the LP router --------
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        with phase("new_phases"):
            with phase("paper_workloads"):
                for name, n in paper_workloads(behind, {
                        "lp_sc50b_like_50k": sc50b}, blocks).items():
                    path_launches("simplex_tile", f"paper_workloads {name}",
                                  n)
            with phase("distributed"):
                n, n_seg = distributed(lp100, res_100, res_comp, comp_stats,
                                       Path(tmp))
                path_launches("simplex_tile", "distributed world of one", n)
                path_launches("simplex_segment",
                              "distributed world of one segment_k", n_seg)
            with phase("lp_router"):
                path_launches("simplex_tile", "lp_router", lp_router())
    del res_comp
    with phase("reachability_example"):
        reachability()

    # ---- branch-and-bound: the combined stage, warm starts, trees --------
    with phase("branch_and_bound"):
        comb_rows = []
        for rule in RULES:
            comb_rows.append(compare_combined("lp_100d_50k", lp100, rule))
            comb_rows.append(compare_combined("sc205_like_2k", sc205, rule,
                                              n_lp=256, n_plain=128,
                                              parent_steps=700))
        comb_full = combined_at_full_batch(lp100, res_100, seg_full)
        for path, fn in (("tableau_warm_card",
                          lambda: tableau_warm_card(afiro, lp_af, res_af)),
                         ("bnb_fixtures", bnb_fixtures),
                         ("bnb_frontier", bnb_frontier)):
            path_launches("simplex_segment_full", path, fn())

    # ---- revised path: the revised kernel, with warm starts ---------------
    with phase("revised"):
        for rule in REVISED_RULES:
            _, n = revised_main("lp_100d_50k", lp100, head, rule, res_100)
            path_launches("revised_segment", f"revised_main {rule}", n)
        g_warm = first_members(g, AFIRO_WARM_LPS)
        path_launches("revised_segment", "revised_warm",
                      revised_warm(afiro, g_warm, g64, traj_lps=TRAJ_LPS))
        rev_rows = []
        for rule in REVISED_RULES:
            row, whole = done("revised", "lp_100d_50k", rule)
            rev_rows.append(row)
            done("revised_schedule", "lp_100d_50k", rule, value=whole)
            _, whole = done("revised", "lp_afiro_100k", rule)
            done("revised_schedule", "lp_afiro_100k", rule, value=whole)
            del whole
        for rule in REVISED_RULES:
            done("revised", "sc205", rule)
        rev_full = revised_at_full_batch("lp_100d_50k", lp100)

    # ---- restarted PDHG: the whole-solve and segment kernels --------------
    with phase("pdhg"):
        res_pdhg, n, wall_pdhg = pdhg_main(
            "lp_100d_50k", lp100, head, (lp100.m, lp100.n), res_100)
        path_launches("pdhg", "pdhg_main", n)
        n, pdhg_comp = pdhg_compaction_main(lp100, res_pdhg, wall_pdhg)
        path_launches("pdhg_segment", "pdhg_compaction_main", n)
        path_launches("pdhg", "pdhg_warm",
                      pdhg_warm(g_warm, g64, (lp_af.m, lp_af.n)))
        pdhg_rows = [done("pdhg", "lp100", "fixed")[0]]
        pdhg_seg_row = done("pdhg_schedule")
        seg_launch_rows = [compare_pdhg_segment("lp_100d_50k", lp100)]
        pdhg_rows.append(done("pdhg", "lp100", "malitsky_pock")[0])
        pdhg_rows.append(done("pdhg", "afiro", "fixed")[0])
        pdhg_rows.append(done("pdhg", "afiro", "malitsky_pock")[0])
        seg_launch_rows.append(compare_pdhg_segment("lp_afiro_100k", lp_af))
        pdhg_rows.append(done("pdhg", "sc205", "fixed")[0])
        pdhg_rows.append(done("pdhg", "sc205", "malitsky_pock")[0])
        seg_launch_rows.append(compare_pdhg_segment("sc205_like_2k", sc205,
                                                    n_plain=128))
        pdhg_rows.append(done("pdhg", "lp300", "fixed")[0])
        pdhg_rows.append(done("pdhg", "lp300", "malitsky_pock")[0])
        seg_launch_rows.append(compare_pdhg_segment("lp_300d_2k", lp300,
                                                    n_lp=256, n_plain=64))
        assert not checks, sorted(checks)
        emit({"plain_versions_on_workers": PLAIN,
              "workers": PLAIN_WORKERS})
        pdhg_sparse("sc205_like_2k", sc205, max_iters=SPARSE_CAP)
        pdhg_full = pdhg_full_batch(lp100)

    # ---- the telemetry plane: counters through the segment kernels -------
    with phase("telemetry"):
        del res_pdhg
        tel_launches = telemetry_main(lp100)
        tel_rows = telemetry_kernels("lp_100d_50k", lp100)
        # the device variants of the simplex (both stages) and revised
        # counter kernels, PDHG's shared one on sc205_like and its device
        # one on lp_300d_2k's first 64 LPs
        tel_shapes = [tel_rows,
                      telemetry_kernels("sc205_like_2k", sc205, B=256),
                      telemetry_kernels("lp_300d_2k", lp300, B=64,
                                        kernels=("pdhg",))]
        tel_over = telemetry_overhead(lp100)
    del lp100, res_100, g, g_warm, lp_af, sc205, lp300
    torch.cuda.empty_cache()

    # ---- box LP: the hyperbox kernel --------------------------------------
    with phase("box_lp"):
        box = box_lp()

    # ---- falcon-mamba-7b serving: the selective-scan kernel ----------------
    with phase("serving"):
        scan = serving()
        path_launches("ssm_scan", f"serve {SERVE_ARCH}", scan["launches"])

    # ---- hymba-1.5b serving: attention, the hybrid block, the scan kernel -
    with phase("serving_hymba"):
        hymba = serving_hymba()
        path_launches("ssm_scan", f"serve {HYMBA_ARCH}", hymba["launches"])

    # ---- qwen3-32b serving: the dense block, no custom kernel -------------
    with phase("serving_dense"):
        serving_dense()

    # ---- llama4-scout serving: the MoE layer and its LP capacity router ---
    with phase("serving_moe"):
        scout = serving_moe()
        path_launches("simplex_tile", f"serve {MOE_ARCH} (lp_capacity)",
                      scout["launches"])

    # ---- deepseek-v2 serving: MLA and the LP router at E = 160 ------------
    with phase("serving_mla"):
        deepseek = serving_mla()
        path_launches("simplex_tile", f"serve {MLA_ARCH} (lp_capacity)",
                      deepseek["launches"])

    # ---- whisper-small and phi-3-vision serving: no custom kernel -------
    with phase("serving_encdec"):
        serving_encdec()
    with phase("serving_vlm"):
        serving_vlm()

    # ---- falcon-mamba-7b training: the scan's backward kernel -------------
    with phase("training"):
        bwd = training()
        path_launches("ssm_scan", f"train {SERVE_ARCH} (forward and "
                      "recompute)", bwd["fwd_launches"])
        path_launches("ssm_scan_bwd", f"train {SERVE_ARCH}", bwd["launches"])

    # ---- every other LM family trained at full width ----------------------
    with phase("training_families"):
        fam = training_families()
        path_launches("ssm_scan", f"train {HYMBA_ARCH} (forward and "
                      "recompute)", fam["hymba_bwd"]["fwd_launches"])
        path_launches("ssm_scan_bwd", f"train {HYMBA_ARCH}",
                      fam["hymba_bwd"]["launches"])
        path_launches("simplex_tile", f"train {MOE_ARCH} (lp_capacity, "
                      "forward and recompute)",
                      fam["scout_router"]["launches"])
        path_launches("simplex_tile", f"train {MLA_ARCH} reduced twin "
                      "(lp_capacity, forward and recompute)",
                      fam["mla_twin"]["launches"])
    stop_training_data()

    # ---- the data mixture: one simplex launch -----------------------------
    with phase("optimal_mixture"):
        mix = optimal_mixture_phase()
        path_launches("simplex_tile", "optimal_mixture", mix["launches"])

    # ---- the dry run: the host's reckoning, one rank on the card ----------
    with phase("dryrun"):
        dry = dryrun_phase(dryrun_host, dryrun_out, blocks["lp_100d_50k"])
        path_launches("ssm_scan", "dryrun falcon-mamba-7b prefill_32k rank 0 "
                      "of 16x16", dry["rank"]["scan_launches"])
        path_launches("simplex_tile", "dryrun lp_100d_50k rank 0 block of "
                      "16x16", 1)

    # ---- training on a mesh: expert parallelism, compression, resume ------
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        with phase("training_sharded"):
            shard = training_sharded(Path(tmp))
    path_launches("simplex_tile", f"train {MLA_ARCH} sharded 2x2 "
                  "(lp_capacity, forward and recompute, 4 ranks)",
                  shard["deepseek"]["router_launches"])
    path_launches("ssm_scan", f"train {SERVE_ARCH} sharded 2x2 (d_inner "
                  "/ 2 a rank, forward and recompute, 4 ranks)",
                  shard["deepseek"]["falcon"]["scan_launches"])
    path_launches("ssm_scan_bwd", f"train {SERVE_ARCH} sharded 2x2 "
                  "(d_inner / 2 a rank, 4 ranks)",
                  shard["deepseek"]["falcon"]["scan_bwd_launches"])
    path_launches("simplex_tile", f"train {MOE_ARCH} reduced --mesh 2x2 "
                  "(lp_capacity, straight and resumed runs)",
                  sum(sum(v) for v in shard["mesh_twin"]
                      ["router_launches_by_run_and_rank"].values()))
    emit({"total_s": time.perf_counter() - t_start})

    main_row = rows[0]   # lp_100d_50k slice, dantzig: the paper's rule
    seg_row = seg_rows[0]
    pdhg_row = pdhg_rows[0]   # lp_100d_50k slice, fixed step
    emit({"kernels": [{
        "name": "simplex_tile", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/simplex_tile.cu",
        "replaces": "src/repro/kernels/simplex_tile.py:421",
        **launch_keys("simplex_tile"),
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "plain_on": main_row["plain_on"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        "variant": main_row["variant"],
        "full_batch_ms": full_100["ms"],
        "full_batch_bound_ms": full_100["bound_ms"],
        "moe_router_caps_vs_plain_max_abs_err":
            scout["router_caps_vs_plain_max_abs_err"],
        "mla_router_caps_vs_plain_max_abs_err":
            deepseek["router_caps_vs_plain_max_abs_err"],
        "train_moe_router_caps_vs_plain_max_abs_err":
            fam["scout_router"]["caps_vs_plain_max_abs_err"],
        "optimal_mixture_vs_cpu_max_abs_err": mix["max_abs_err"],
        "sharded_router_caps_vs_plain_max_abs_err": max(
            r["caps_vs_plain_max_abs_err"]
            for r in shard["deepseek"]["ranks"]),
        "parity": "status, iterations and work counts equal; x, objective, "
                  "y, z within rel 1e-5; every rule and batch; the MoE "
                  "router's caps in the served llama4-scout and "
                  "deepseek-v2 and in llama4-scout's training equal to "
                  "the plain version's, its recompute's routing equal to "
                  "its forward's; in deepseek-v2's sharded training each "
                  "rank's caps equal to the plain version's and its "
                  "routing to one process's; optimal_mixture's statuses "
                  "and weights equal to the CPU port's"}, {
        "name": "simplex_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/simplex_tile.cu",
        "replaces": "src/repro/kernels/simplex_tile.py:494",
        **launch_keys("simplex_segment"),
        "max_abs_err": seg_row["max_abs_err"], "ms": seg_row["ms"],
        "plain_ms": seg_row["plain_ms"], "plain_on": seg_row["plain_on"],
        "bound_ms": seg_row["bound_ms"],
        "bound_by": seg_row["bound_by"], "library_ms": None,
        "variant": {"p1": seg_row["p1_variant"], "p2": seg_row["p2_variant"]},
        "full_batch_ms": seg_full["segment_ms"],
        "full_batch_bound_ms": seg_full["bound_ms"],
        "state_roundtrip_ms": seg_row["state_roundtrip_ms"],
        "parity": "one launch per stage leaf by leaf; scheduled solve: "
                  "status, iterations and work equal, x, objective, y, z "
                  "within rel 1e-5; every rule and batch"}, {
        "name": "simplex_segment_full", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/simplex_tile.cu",
        "replaces": "src/repro/core/compaction.py:229",
        **launch_keys("simplex_segment_full"),
        "max_abs_err": max(r["max_abs_err"] for r in comb_rows),
        "ms": comb_rows[0]["ms"], "plain_ms": comb_rows[0]["plain_ms"],
        "bound_ms": comb_rows[0]["bound_ms"],
        "bound_by": comb_rows[0]["bound_by"], "library_ms": None,
        "variant": {r["compare_combined"]: r["variant"]
                    for r in comb_rows},
        "full_batch_ms": comb_full["ms"],
        "full_batch_bound_ms": comb_full["bound_ms"],
        "full_batch_segments_ms": comb_full["segments_ms"],
        "shapes": [{k: r[k] for k in ("compare_combined", "pricing",
                                      "variant", "lps", "plain_lps", "ms",
                                      "plain_ms", "bound_ms",
                                      "max_abs_err")} for r in comb_rows],
        "parity": "one 8-step launch of stage full leaf by leaf at atol 0 "
                  "from states with phase-1, phase-2 and warm-injected "
                  "lanes, every rule, lp_100d_50k slice (shared) and 256 "
                  "sc205_like LPs (device); all 50,000 to the end equal "
                  "to the whole solve; the warm path equal to the plain "
                  "engine; the fixtures' trees equal to the CPU port's"}, {
        "name": "hyperbox", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hyperbox.cu",
        "replaces": "src/repro/kernels/hyperbox_kernel.py:20",
        "launches": box["launches"], "max_abs_err": box["max_abs_err"],
        "ms": box["ms"], "plain_ms": box["plain_ms"],
        "bound_ms": box["bound_ms"], "bound_by": box["bound_by"],
        "library_ms": box["library_ms"], "library": box["library"],
        "one_box_solve_ms": box["one_box_solve_ms"],
        "one_box_kernel_ms": box["one_box_kernel_ms"],
        "parity": "equal to the plain version; rel 1e-5 to the float64 "
                  "oracle"}, {
        "name": "revised_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/revised_tile.cu",
        "replaces": "src/repro/kernels/revised_tile.py:221",
        **launch_keys("revised_segment"),
        "max_abs_err": rev_rows[0]["max_abs_err"], "ms": rev_rows[0]["ms"],
        "plain_ms": rev_rows[0]["plain_ms"],
        "plain_on": rev_rows[0]["plain_on"],
        "bound_ms": rev_rows[0]["bound_ms"],
        "bound_by": rev_rows[0]["bound_by"], "library_ms": None,
        "variant": rev_rows[0]["variant"],
        "full_batch_ms": rev_full["ms"],
        "full_batch_bound_ms": rev_full["bound_ms"],
        "parity": "one launch per stage leaf by leaf and the whole solve "
                  "equal (NaN where NaN); both rules; the compaction "
                  "schedule equal to the plain one"}, {
        "name": "pdhg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pdhg_tile.cu",
        "replaces": "src/repro/kernels/pdhg_tile.py:268",
        **launch_keys("pdhg"),
        "max_abs_err": max(r["max_abs_err"] for r in pdhg_rows),
        "ms": pdhg_row["ms"],
        "plain_ms": pdhg_row["plain_ms"], "plain_on": pdhg_row["plain_on"],
        "bound_ms": pdhg_row["bound_ms"],
        "bound_by": pdhg_row["bound_by"], "library_ms": None,
        "variant": pdhg_row["variant"],
        "slice_max_iters": pdhg_row["max_iters"],
        "plain_lps": pdhg_row["plain_lps"],
        "full_batch_ms": pdhg_full["ms"],
        "full_batch_bound_ms": pdhg_full["bound_ms"],
        "shapes": [{k: r[k] for k in (
            "compare_pdhg", "step_rule", "variant", "lps", "max_iters",
            "ms", "bound_ms", "plain_ms", "plain_on", "plain_lps",
            "max_abs_err")}
            for r in pdhg_rows],
        "parity": "every output equal (NaN where NaN): both step rules, "
                  "lp_100d_50k and lp_afiro_100k (A in registers), "
                  "sc205_like (A in shared memory) and lp_300d_2k (A in "
                  "device memory)"}, {
        "name": "pdhg_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pdhg_tile.cu",
        "replaces": "src/repro/kernels/pdhg_tile.py:469",
        **launch_keys("pdhg_segment"),
        "max_abs_err": max([pdhg_seg_row["max_abs_err"]]
                           + [r["max_abs_err"] for r in seg_launch_rows]),
        "ms": pdhg_seg_row["ms"],
        "plain_ms": pdhg_seg_row["plain_ms"],
        "plain_on": pdhg_seg_row["plain_on"],
        "bound_ms": pdhg_seg_row["bound_ms"],
        "bound_by": pdhg_seg_row["bound_by"], "library_ms": None,
        "variant": pdhg_comp["variant"],
        "plain_lps": pdhg_seg_row["plain_lps"],
        "full_batch_ms": pdhg_comp["segment_kernel_ms"],
        "full_batch_bound_ms": pdhg_comp["bound_ms"],
        "shapes": [{k: r[k] for k in (
            "compare_pdhg_segment", "variant", "lps", "rounds", "ms",
            "plain_ms", "plain_lps", "max_abs_err")}
            for r in seg_launch_rows],
        "parity": "one launch leaf by leaf in each variant; the "
                  "kernel-backed schedule equal to the plain-backed one and "
                  "to the whole solve; compaction=True on all 50,000 equal "
                  "to the whole solve"},
        *(tel_kernel_row(name, src, line, tel_launches[count],
                         tel_rows[row], tel_over[over], ptx[count],
                         [r for rows in tel_shapes for k, r in rows.items()
                          if k.startswith(count)])
          for name, src, line, count, row, over in TEL_KERNEL_ROWS), {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:44",
        **launch_keys("ssm_scan"), "max_abs_err": max(
            scan["max_abs_err"], hymba["max_abs_err"],
            shard["deepseek"]["falcon"]["scan_max_abs_err"]),
        "ms": scan["ms"], "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"],
        "library_ms": None, "yardstick_ms": scan["yardstick_ms"],
        "yardstick": scan["yardstick"], "shape": scan["shape"],
        "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                      "yardstick_ms", "max_abs_err")}
                   for r in (scan, hymba)] + [sharded_scan(
                       shard["deepseek"]["falcon"], "scan")],
        "parity": "hs and hT equal to the plain version on layer 0's and "
                  "layer 63's second-chunk inputs of falcon-mamba-7b, on "
                  "layer 0's and layer 31's last-chunk inputs of "
                  "hymba-1.5b, on rank 0's first forward chunk of "
                  "falcon-mamba-7b sharded 2x2 (d_inner / 2) and at four "
                  "odd shapes"}, {
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:57",
        **launch_keys("ssm_scan_bwd"), "max_abs_err": max(
            bwd["max_abs_err"], fam["hymba_bwd"]["max_abs_err"],
            shard["deepseek"]["falcon"]["scan_bwd_max_abs_err"]),
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": None, "yardstick_ms": bwd["yardstick_ms"],
        "yardstick": bwd["yardstick"], "shape": bwd["shape"],
        "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                      "yardstick_ms", "max_abs_err")}
                   for r in (bwd, fam["hymba_bwd"])] + [sharded_scan(
                       shard["deepseek"]["falcon"], "scan_bwd")],
        "parity": "ddA, ddBx and dh0 equal to the plain version on layer "
                  "0's chunk-0 inputs of the first microbatch of "
                  "falcon-mamba-7b's and of hymba-1.5b's training, on rank "
                  "0's first backward launch of falcon-mamba-7b sharded "
                  "2x2 (d_inner / 2), and at four odd shapes"}]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
