"""Quickstart on the PyTorch/CUDA port: solve LPs on the card, from an
MPS file or raw arrays.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain

Every ``solve_*`` of ``repro_torch`` runs on the CUDA card unless it is
given ``device="cpu"``, where the same engines run as plain PyTorch.  On
the card ``solve_batched`` goes through the hand-written CUDA kernels
(``kernels/csrc/``); on the CPU through the kernels' plain versions.

Choosing a backend (``backend=`` on every solve_*; core/lp.py registry):

* ``"tableau"`` (default) — the paper's dense simplex.  Exact vertex
  solutions and statuses in O(m+n) pivots; wins on small/medium dense
  square-ish batches (the regime of the paper's Tables 2-4).
* ``"revised"`` — exact simplex on basis factors; wins when the canonical
  shape is wide (n >> m) or sparse (``revised_crossover`` locates the
  frontier — the paper's Netlib regime).
* ``"pdhg"`` — restarted primal-dual hybrid gradient (PDLP-style
  first-order method).  Tolerance-based: OPTIMAL means the KKT residuals
  dropped below ``tol``; objectives are ~tol-accurate, solutions interior
  rather than vertex.  Every iteration is one batched matvec pair — no
  pivoting — so it scales past the sizes where per-pivot sequential depth
  dominates (``pdhg_crossover_size`` puts the square-dense flops frontier
  at m ~ iters/2, i.e. thousands), and it returns the primal-dual
  certificate (``LPResult.y``/``z``) natively — the simplex backends
  derive the same certificate from the optimal basis, so ``y``/``z`` are
  backend-uniform.

Three structural features every backend exploits (sections 0c, 1b and 4
below):

* **warm starts** — ``res.warm_start()`` extracts a backend-uniform
  ``WarmStart`` carrier (basis + bound flips + pricing weights for the
  simplex engines; iterates + primal weight for PDHG) and ``warm=`` on any
  ``solve_*`` resumes each LP from its parent's terminal state, so a
  re-solve after a small perturbation costs a handful of pivots instead
  of a full cold solve; engines repair or fall back to cold per LP, so
  statuses and objectives never change.

* **native variable bounds** — pass ``ub=`` on ``LPBatch.from_arrays``
  (or just use MPS ``UP``/``FX`` bounds) and ``0 <= x <= u`` is enforced
  by the bounded ratio test, not by ``x_j <= u_j`` rows: canonical m
  stays small, and the engines flip variables between their bounds in
  O(row) work instead of pivoting against a dense bound row.
* **shared-pattern sparsity** — a batch of perturbed copies of one
  instance shares one nonzero pattern; ``SparseLPBatch.from_dense``
  stores it once (COO) with ``(B, nnz)`` values, and the PDHG backend's
  matvecs then cost 2*nnz instead of 2*m*n elements per iteration
  (``resolve_backend("pdhg", sparse=True)`` routes there).
"""
import argparse

import numpy as np

from repro_torch.analysis.lp_perf import (canonical_work, pdhg_crossover_size,
                                          revised_crossover,
                                          revised_pivot_flops,
                                          tableau_pivot_flops)
from repro_torch.core import (LPBatch, SparseLPBatch, canonicalize,
                              random_lp_batch, solve_batched,
                              solve_batched_pdhg_sparse,
                              solve_batched_reference)
from repro_torch.core.lp import STATUS_NAMES
from repro_torch.core.pdhg import pdhg_elements
from repro_torch.core.revised import revised_elements
from repro_torch.core.simplex import tableau_elements
from repro_torch.core.sparse import sparse_pdhg_elements
from repro_torch.device import resolve_device
from repro_torch.io import fixture_path, perturbed_batch, read_mps
from repro_torch.kernels.ops import solve_batched_kernel

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
dev = resolve_device(ap.parse_args().device)
rng = np.random.default_rng(0)

# 0) the general-form entry path: MPS file -> GeneralLPBatch -> any solve_*.
# Netlib AFIRO (8 equality rows, minimization) is canonicalized on ingestion
# (equalities grow m: 27x32 -> 35x32, presolve + pow2 equilibration on by
# default) and the result is recovered into ORIGINAL coordinates — here the
# published optimum -464.7531.
afiro = read_mps(fixture_path("afiro"))
res0 = solve_batched(afiro, device=dev, backend="revised")
print(f"AFIRO (MPS -> general form -> revised backend): "
      f"status={STATUS_NAMES[int(res0.status[0])]} "
      f"objective={res0.objective[0]:.4f}")
w = canonical_work(afiro)
print(f"  canonical shape {w['m_canonical']}x{w['n_canonical']} "
      f"(from {w['m']}x{w['n']}); revised wins on flops there: "
      f"{w['revised_wins_flops']}")

# 0b) the paper's batch recipe: one real instance x B perturbed copies
batch_afiro = perturbed_batch(afiro, 512, rng)
res0b = solve_batched(batch_afiro, device=dev, backend="revised",
                      pricing="partial")
print(f"AFIRO x512 perturbed batch: {res0b.summary()}")

# 0c) warm-starting repeated solves: re-solving a nudged copy of the batch
# from the parent's terminal state (``warm=res.warm_start()``) costs ~0
# pivots instead of a full cold solve — the parent's optimal basis is
# optimal or one repair step away for every LP.  The carrier is
# backend-uniform: the same ``warm_start()`` call seeds the tableau,
# revised, and pdhg engines (pdhg resumes from the parent's iterates and
# primal weight instead of a basis).
nudged = perturbed_batch(afiro, 512, rng)
cold = solve_batched(nudged, device=dev, backend="revised",
                     pricing="partial")
warm = solve_batched(nudged, device=dev, backend="revised", pricing="partial",
                     warm=res0b.warm_start())
print(f"AFIRO x512 nudged re-solve: cold {cold.iterations.mean():.1f} "
      f"pivots/LP -> warm {warm.iterations.mean():.1f}; statuses agree: "
      f"{bool(np.array_equal(cold.status, warm.status))}")

# 1) a hand-written LP:  max x+2y  s.t.  x+y<=4, x<=2, y<=3, x,y>=0  -> 7 at (1,3)
batch = LPBatch.from_arrays(
    A=[[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]],
    b=[4.0, 2.0, 3.0],
    c=[1.0, 2.0])
res = solve_batched(batch, device=dev)
print(f"single LP: status={STATUS_NAMES[int(res.status[0])]} "
      f"objective={res.objective[0]:.3f} x={res.x[0]}")

# 1b) native upper bounds: max 3x+2y s.t. x+y<=10, 0<=x<=2, 0<=y<=3 -> 12
# at (2, 3) — both variables end at their *upper* bound, reached by bound
# flips in the ratio test; no x<=u rows are ever materialized (compare
# the three-row encoding of the same LP in section 1).
bounded = LPBatch.from_arrays(
    A=[[1.0, 1.0]], b=[10.0], c=[3.0, 2.0], ub=[2.0, 3.0])
res_ub = solve_batched(bounded, device=dev)
print(f"bounded LP (native ub, one row): "
      f"status={STATUS_NAMES[int(res_ub.status[0])]} "
      f"objective={res_ub.objective[0]:.3f} x={res_ub.x[0]}")

# 2) a batch of 10k random LPs (the paper's regime): chunked device solve
big = random_lp_batch(rng, B=10_000, m=10, n=10)
res = solve_batched(big, device=dev)   # the kernel on a card, else plain
print(f"10k LPs ({dev.type}):  {res.summary()}")

# 3) same batch through the kernel entry point in chunks of 4096 (on the
# CPU its plain version): the same results bit for bit
res_k = solve_batched(big, solver=solve_batched_kernel, device=dev,
                      chunk_size=4096)
print(f"10k LPs (kernel, chunked): {res_k.summary()}; equal to the "
      f"unchunked solve: {bool(np.array_equal(res.x, res_k.x))}")

# 3b) steepest-edge pricing: same certificates, ~half the pivots
res_se = solve_batched(big, device=dev, pricing="steepest_edge")
print(f"10k LPs (steepest-edge): {res_se.summary()} "
      f"(mean pivots {res_se.iterations.mean():.1f} "
      f"vs dantzig {res.iterations.mean():.1f})")

# 3c) revised-simplex backend: immutable (A, b, c), basis-factor updates
# (eta file + periodic LU refactorization), partial pricing over column
# blocks — same certificates, O(m^2)+pricing per pivot instead of the
# tableau's O(m*(n+2m)) rank-1 update
res_rev = solve_batched(big, device=dev, backend="revised",
                        pricing="partial")
print(f"10k LPs (revised): {res_rev.summary()}")
m, n = big.m, big.n
print("work models per pivot at "
      f"{m}x{n}: tableau {tableau_elements(m, n, compacted=True)} element "
      f"updates / {tableau_pivot_flops(m, n, compacted=True):.0f} flops, "
      f"revised {revised_elements(m, n, partial=True)} element updates / "
      f"{revised_pivot_flops(m, n, partial=True):.0f} flops "
      f"(flops crossover at n ~ {revised_crossover(m)} for m={m}: the "
      "immutable data block is never rewritten, so element updates win "
      "everywhere while dense-square flops stay tableau-territory)")

# 3d) first-order backend: restarted PDHG — tolerance-based convergence,
# one batched matvec pair per iteration, native dual certificates.  On
# AFIRO the recovered duals satisfy the original-coordinate KKT system.
res_fo = solve_batched(batch_afiro, device=dev, backend="pdhg")
print(f"AFIRO x512 (pdhg):  {res_fo.summary()} "
      f"(mean iterations {res_fo.iterations.mean():.0f} — cheap matvec "
      "iterations, not pivots)")
print(f"  row duals for the first LP (original coordinates, min "
      f"convention): y[:4] = {np.round(res_fo.y[0][:4], 4)}")
print(f"  first-order flops crossover vs tableau (square dense, ~10k "
      f"iters): m ~ {pdhg_crossover_size(10000)}")

# 4) shared-pattern sparse batches: the SC205-class staircase fixture is
# ~2.5% dense after canonicalization and every perturbed copy shares the
# same pattern — store it once (COO) with (B, nnz) values and the PDHG
# matvecs pay nnz, not m*n.  Statuses/objectives match the dense engine
# (same algorithm; only the matvec implementation changes).
sc205 = read_mps(fixture_path("sc205_like"))
canon, _ = canonicalize(perturbed_batch(sc205, 16, rng))
sp = SparseLPBatch.from_dense(canon)
res_sp = solve_batched_pdhg_sparse(sp, device=dev)
print(f"SC205-like x16 sparse pdhg: {res_sp.summary()} "
      f"(nnz={sp.nnz}, density {sp.density:.3f}; "
      f"{sparse_pdhg_elements(sp.nnz, sp.m, sp.n)} elements/iter vs "
      f"{pdhg_elements(sp.m, sp.n)} dense — "
      f"x{pdhg_elements(sp.m, sp.n) / sparse_pdhg_elements(sp.nnz, sp.m, sp.n):.1f} less traffic)")

# cross-check 100 of them against the float64 oracle
sub = LPBatch(A=big.A[:100], b=big.b[:100], c=big.c[:100])
ref = solve_batched_reference(sub)
ok = ref.status == 0
rel = np.abs(ref.objective[ok] - res.objective[:100][ok]) \
    / np.abs(ref.objective[ok])
print(f"max relative objective error vs float64 oracle: {rel.max():.2e}")
