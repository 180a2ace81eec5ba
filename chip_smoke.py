#!/usr/bin/env python3
'''Drive nutils_tpu_torch (the PyTorch/CUDA port of nutils_tpu) once on one
CUDA card and check it: the quickest proof that the port still starts on
the GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only kernels   # K1-K3, K7, K11-K15's rows alone, no solves
    python3 chip_smoke.py --only assemble  # warm assemblies alone, no solves
    python3 chip_smoke.py --only finitestrain  # the finite-strain phases alone
    python3 chip_smoke.py --only krylov    # K6/K10 rows and the Navier-Stokes GMRES/BiCGStab solves alone
    python3 chip_smoke.py --only timestep  # ns_steps, heat_steps and timestep_parity alone
    python3 chip_smoke.py --only fcm       # the finite cell phases and hier_parity alone
    python3 chip_smoke.py --only cahnhilliard  # cahnhilliard and cahnhilliard_parity alone

Phases, each printing JSON lines (``--only kernels``: device, build, K3's
rows at the slice's, the example's and the finite-strain grids, K1's at
the slice's, a periodic, the example's grid and each smoothed level of
the finite-strain hierarchy, K2's fused sweeps at those levels, the
``assembly_kernels`` rows of the slice, NS, triangles, elasticity and
finite strain, K7's rows on the NS and triangle jacobians, the example's
chunk rows, ``elasticity_kernels`` and K15 on the finite-strain integrand;
run from another checkout's root, with this script copied there, it
measures that checkout's kernels at the same shapes and inputs, K1's,
K2's, K3's, K7's, K11's, K12's and K15's outputs' sha1 digests among them;
``--only assemble``: device, build
and ``assemble_only``, many warm assemblies of each path, for comparing
two checkouts the same way):

1. device   — the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; fails without a CUDA card.
2. build    — builds the CUDA kernels K1-K15 from ``nutils_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, in parallel).
3. kernel   — K1-K4 against their plain PyTorch versions on the card, at
   the Laplace slice's shapes (1025^2 grid, W = 9, float32 and float64) and
   on a periodic 2-D and a 3-D stencil: error, CUDA-event times, the bound
   and, where one PyTorch call computes the same function, its time
   (from a CUDA graph, as the kernels);
   K1 and K2's fused launches (jacobi_pre, jacobi_post) also at the
   example's 2049^2 grid in float64, each of K2's the same bits as the
   single sweeps it replaces; K2's single sweeps also at the degree-2
   example's fine grid (k = 2); K1, K2's fused launches and K3 also at the
   finite-strain grid (721, 721, 2) in float64, K1 and K2 at each coarser
   smoothed level of its hierarchy ((361, 361, 2), (181, 181, 2),
   (91, 91, 2)), K1 there beside cuSPARSE, K3 also at the example's; K1
   and K2 in the form each grid takes (``ops/stencil.matvec_form``,
   ``ops/mg.fused_form``), K1 the same bits as the generic kernel and K2's
   component form the same bits as the 3-D box, launched directly and
   timed beside them; K3 at each grid in the form it
   takes there (``ops/mg.transfer_form``), the same bits as the generic
   kernel launched directly and timed beside it, prolong-add adding into a
   scratch x made outside the timed graph; K1-K3's rows with the sha1 of
   their outputs; K4's entries also at grids of 1-8 blocks a
   multiprocessor.
4. slice    — the bench's Laplace slice at 1,050,625 dofs in float32:
   System (every assembly chunk on the factored route), assembly through
   K11/K12, multigrid set-up and the refined CG solve to rtol 1e-10,
   through the kernels, its loop replayed from CUDA graphs (launch counts
   read around the run; a warm solve's counts are its replays times each
   graph's launches, plus the refinement's residuals); then
   ``assembly_kernels``: K11 and K12 against their plain versions at the
   slice's shapes (each row with the launch plan it took,
   ``ops/assembly.matrix_plan`` / ``vector_plan``, never K12's generic
   kernel, the sha1 of its output and whether two launches gave the same
   bits), and a profile of one warm assembly.
5. slice_driver — on the same slice: the graph driver against the host
   loop (bitwise x, the same iterations and rounds), warm solves at chunk
   lengths 1-8, and an iteration's device time after the loop's stop,
   with the multigrid kernels predicated on the loop's flag and without.
6. slice_profile — torch.profiler over one warm solve with each driver:
   wall time, device-busy time, kernel launches, replays and host reads.
7. parity   — the same slice at 65^2 dofs in float64 on the card and on the
   CPU (plain versions): the solutions agree to 1e-8 relative.
8. ns       — the bench's Taylor-Hood Navier-Stokes Newton step at
   983,403 dofs in float32: System, block-grid planning, assembly (K11,
   K12, every chunk factored; then ``assembly_kernels`` at its shapes), the
   device Schur diagonal, K5's compact plan and operand, refined GMRES to
   rtol 1e-3 and the fused step, through the kernels (launch counts read
   around the run; the GMRES loop replays CUDA graphs on K6's device state,
   each solve's record asserted: driver ``graph``, accepted on the device,
   host reads no more than chunks + cycles + rounds); then K5-K7 against
   their plain versions at the step's shapes (K6's six entries at steps 0,
   50 and 99 of GMRES(100), their decisions equal) (K5 also against the literal port on the weight buffer, and
   cuSPARSE in float32 and float64; K7 twice, the same bits, with the sha1
   of minv and the floor of its two passes beside its bound), and a
   profile of one warm assembly and one warm solve.
9. ns_parity — the step at 6x6 elements in float64 on the card and on the
   CPU: the solutions agree to 1e-8 relative, in as many iterations.
10. ns_tri  — the same Newton step on ``unitsquare(330, 'triangle')``
   (217,800 triangles, 983,403 dofs) in float32: System, CSR pattern,
   assembly (K11, K12, every chunk factored; ``assembly_kernels`` at its
   shapes) through the value scatter K8, the device Schur diagonal on CSR
   values (K7), refined GMRES and refined BiCGStab to rtol 1e-3 on the CSR
   operator (K9, K6, K10), through the kernels, both loops from CUDA graphs
   (asserted as on ``ns``; launch counts read around the run; the residual's rows with no slice plan sum through K8 too, and
   two assemblies are bitwise equal; their bits' sha1 digests are printed,
   to compare between calls), and a profile of one warm assembly
   and one warm solve of each method.
11. ns_tri_kernels — K7 on CSR values and K8-K10 against their plain
   versions at the triangle step's shapes (K10's entries each with their
   decisions) (K9 also twice, for the same
   bits, and with the loop's flag at 0, writing nothing).
12. ns_tri_parity — the triangle step at 6x6 elements in float64 on the
   card and on the CPU: both methods' solutions agree to 1e-8 relative, in
   as many iterations; then ``k9_rows``: K9 on rows of 0, 1, 3, 59 and
   more than its block's budget of nonzeros, starting at every offset.
13. laplace_example — examples/laplace.py's solve path at 2048^2 elements
   (4,198,401 dofs) in float64 through the port's entry points:
   ``solve_constraints`` (4,097 dofs constrained), then
   ``System.solve(constrain=cons)``, first part by part (the assembly in
   two element chunks through K11/K12, the masked operator and its stencil
   form, the multigrid set-up, GMRES through K1-K3 and K6; launch counts
   read around it) and then as the user calls it; the example's L2 error,
   below 2.5e-8.
14. laplace_example_chunks — that assembly in two chunks and in one: the
   first assembly's peak memory each, and the sha1 of w and r, which must
   be equal; then K11 and K12 in float64 on one chunk, writing into its
   rows of the batch's buffer, against their plain versions (K11's plan;
   two launches the same bits).
15. laplace_example_parity — the example at 256^2 elements, in chunks of
   4,096 elements, on the card and on the CPU: cons and u agree to 1e-9 of
   their largest value.
16. laplace_example_p2 — the example at degree 2 on 256^2 elements
   (263,169 dofs) in float64: its fine level (a k = 2 stencil) smooths
   through K2's single sweeps, the coarser levels through the fused ones
   (launch counts read around it); the L2 error below 4 x its O(h^3)
   estimate.
17. ns_newton — ``System.solve(method=Newton(), tol=...)`` on the
   Navier-Stokes step's System to 1e-5 of its first residual norm in at
   most 8 iterations: each iteration's norm, time, inner tolerance and
   solve record; every inner solve must be accepted on the device.
18. ns_steps — ``System.step`` on the Navier-Stokes step written as
   examples/cylinderflow.py writes it (the history ``u0`` and the timestep
   ``dt`` arguments, ``timearg='t'`` unread), 983,403 dofs in float32:
   three steps of 0.01 from the seeded state, Newton each to 1e-5 of the
   first residual norm; per step its time, and per Newton iteration
   ``t_assemble``, ``t_solve``, ``t_capture`` and the solve record; the
   layout (``System._jac_layout``) and K5's plan made once over the run
   (their calls counted and timed, ``ns_steps_setup``), each inner solve
   on the card from CUDA graphs, no plain version run, each step's history
   the previous state bit for bit.
19. heat_steps — ``solver.cranknicolson`` on the heat equation (∇v·∇u,
   inertia v u) at 1024^2 squares (1,050,625 dofs), float32 assembly, from
   the nodal values of cos(πx) cos(πy): five steps of 1e-3, each a
   ``Direct`` solve sent to the card by ``auto`` (MG-GMRES on the stencil
   operator); per step the method, preconditioner and operator form, the
   residual norm beside newtontol and the set-up calls so far (the
   layout, prolongations and level stencils in step 1 alone, the Galerkin
   plans in step 2 alone, asserted); each step's L2 norm ratio within
   1e-3 of the continuous Crank-Nicolson factor.
20. timestep_parity — the time-stepping cases of ``tests/_torch_parity.py``
   (``Pseudotime``, ``Arnoldi``, the legacy functions, the theta method,
   ``System.step`` with its halving, a Taylor-Hood history step) on the
   card and on the CPU, to 1e-10; the matrix algebra (``+``, ``-``, ``*``,
   ``/``, ``T``) on stencil-, block-grid- and CSR-form jacobians, to 1e-12
   with the same pattern; the CSR jacobian's scalar product on the card
   with the host product's bits.
21. elasticity — examples/elasticity.py on ``unitsquare(360, 'triangle')``
   at degree 2 (259,200 triangles, 1,039,682 dofs) in float64 through the
   port's entry points: ``solve_constraints``, then ``System.solve(
   constrain=cons, method=Direct(solver='cg', precon='block',
   preconargs={'blocksize': 2}))``, first part by part (the CSR assembly
   through K8, K11 and K12; the masked operator and its nodal blocks'
   inverse; block-Jacobi CG through K13, K9 and K4 from CUDA graphs, K13
   at least once an iteration and no plain version run) and then as the
   user calls it; the traction solve and the clamping force, (0, 1) to
   1e-8.  Beside it, for the record, the same CG under the default
   preconditioner (K7).  Then ``elasticity_masked``: block-Jacobi CG on the
   device's masked operator of the whole jacobian (``_isfree=``: K14
   around K9), the same free rows as the public solve to 1e-8, its set-up
   beside the public one's.  Then ``assembly_kernels`` on its System in
   float64 (P2 vector triangles, I = J = 12, one shared operator).
22. elasticity_kernels — K13 and K14 against their plain versions at that
   path's shapes, in float32 and float64, beside ``torch.bmm`` and
   ``torch.mul`` (``mask_post``: ``torch.mul`` then ``torch.addcmul``);
   each row with two launches the same bits, and K14's with its split
   (``ops/sparse.mask_plan``: scalar head, 16-byte vectors, scalar tail)
   and the same pass on views one entry in (n - 1 entries), equal to the
   plain version.
23. elasticity_square — the example on 256^2 squares at degree 2 (526,338
   dofs): its masked operator has the 3-D stencil form of 75 slots, so the
   CG graphs hold K13 beside the 3-D K1.
24. elasticity_parity — the example at 16 elements a side, triangles and
   squares, on the card and on the CPU: u and t agree to 1e-10 relative.
25. finitestrain — examples/finitestrain.py untrimmed on 720^2 squares at
   degree 1 (1,039,682 dofs) in float64 through the port's entry points:
   ``solve_constraints``, the linear ``System.solve(constrain=cons)``, then
   ``System.solve(arguments=args0, constrain=cons, method=Minimize(),
   tol=1e-10)`` on the finite-strain energy; per Minimize iteration the
   residual norm, the energies and relaxations of its trials, the inner
   solve's record, ``t_assemble``, ``t_value`` and the constrained solve's
   set-up and Krylov times (the methods are wrapped and timed, the log
   lines read); in every value assembly exactly one K15 launch that
   finishes the value (the segment sum folded in: no ``elem_value_sum``
   launch), K11/K12 and the inner MG-CG's K1-K4 launched, K1 in its tiled
   form and K2 in its component form alone, no single sweep and no plain
   version run, the residual at 1e-10; then one inner solve on the
   converged jacobian under the profiler (wall, device-busy time, K1's and
   K2's device time).
26. finitestrain_kernels — K15 (``elem_value``, ``elem_value_sum``)
   against its plain version on the converged energy's integrand (518,400
   elements of 4 points) in float32 and float64: the error, two launches
   the same bits, chunks of a multiple of the span the same partials as
   one piece, and the System's chunked value (``config.assembly_chunk``)
   the same bits as one piece; times beside ``torch.sum``; the folded
   launch (``elem_value(finish=)``) bit for bit the two launches it
   replaced and timed beside them; then ``assembly_kernels`` on the
   converged System (K11 and K12 at its block: E 518,400, Q 4, A 4, I 8,
   float64).
27. finitestrain_parity — the example at 16 elements a side on the card and
   on the CPU: u0 and u1 agree to 1e-10 relative, the values to 1e-12.
28. fcm — examples/platewithhole.py's finite cell solve at 360^2
   (``unitsquare(360)`` trimmed along the hole, maxrefine 2; 104,339 kept
   elements in three sample parts: whole squares, simplex and box
   subcells; std basis of degree 2, 837,594 unknowns, float64) through the
   example's calls: ``withboundary``, the hole's radius error, the two
   ``solve_constraints`` calls, ``System(res, trial='u', test='v').solve(
   constrain=cons)`` (``auto``: GMRES with K7's diagonal on the CSR
   operator, from CUDA graphs; its record must say accepted on the card,
   never ``fallback_from``), the L2 and H1 errors; the trim, pattern
   (native sort), first and warm assembly and solve times, launches of
   K8, K9, K11, K12 and the Krylov kernels, a profiled warm solve's busy
   share; then K8's and K9's rows at its shapes (float64; K8's stream
   has up to 35 entries a slot where subcells repeat an element) and
   ``assembly_kernels`` at its three parts.
29. fcm_ratio — the same at 180^2, and that System solved by scipy's
   direct solver on the host: the card's solution within 1e-5 of it in
   the H1 seminorm, the H1 error over 360^2's within FCM_RATIO.
30. fcm_parity — the plate at 4 and 16 elements (std) and 4 (spline) on
   the card and the CPU: cons and the errors to 1e-10, u to 1e-9 in the
   H1 seminorm; the spline case also passes the example's
   ``test_spline`` assertions.
31. hier_parity — examples/adaptivity.py at ``nrefine=2`` (THB, square
   elements, degree 2) on the card and the CPU to 1e-10, and its
   ``test_square_quadratic`` assertions.
32. cahnhilliard — examples/cahnhilliard.py's problem (the example's
   defaults, degree 1) on ``unitcircle(200, 'multipatch')``, 5 x 200^2
   elements, 400,802 unknowns in float64: the mesh (its spline
   projection solved on the card), the locate of the flux plot's points
   on a grid of spacing 1/20 (Newton over candidate elements), the
   System (factored, CSR),
   three ``System.step`` calls with GMRES and K7's diagonal (auto's CG is
   demoted to the host on the indefinite Hessian), per Newton iteration
   its assembly, solve, iterations, driver and host reads; the energy
   split before each step, the flux after it, the third step profiled;
   asserts every inner solve run on the card from graphs (none demoted to
   the host) and accepted in the Newton runs a step keeps, the mass
   conserved to the bound the eta equation gives, K6-K9, K11, K12 in every
   step.
33. cahnhilliard_parity — the example's ``test_multipatchcircle`` (3
   elements, degree 2, two steps) with ``main``'s locate on the 1/20
   grid, on the card and the CPU: the located elements exactly, their
   coordinates to 1e-12, the flux there and the fields to 1e-10, and its
   regression data.
34. mg_setup — every multigrid set-up of the run, by phase: how many, the
   K1 launches their levels' power-step estimates made (set-up, not solve;
   the slice's are also in ``slice_setup``), and each level shape's
   Gershgorin bounds and estimates and how often its diagonals were
   raised (``ops/mg.py``).

Each path's ``pattern_backend`` line says what sorted its CSR pattern
(the native radix sort, asserted; a stencil-form path that never needed
the pattern sorts it then, timed).  Each path's assembly line also gives
``t_assemble_generic``: the same
System with every chunk on the generic ``vmap(jvp)`` route, in the same
call.  The kernels line gives K1-K4's launches summed over the paths that
run them (the slice, the example, the degree-2 example, finite strain,
the heat steps) with each path's beside them (``launches_by_path``), as
K5's, K6's, K7's, K11's and K12's (the time-stepping paths' among them,
each of their steps' launches in ``launches_by_step``), K1's
and K2's fused launches by form on each path (``launches_by_form``: the
slice and the example tiled and 2-D, the degree-2 example 2-D, the
elasticity squares generic, finite strain tiled and components; each
phase asserts its own), and K1-K3's rows at the other paths' grids
(``rows``).  ``elem_value_sum`` is off the path (its launches 0): the
value's segment sum runs in its last ``elem_value`` launch, whose
launches the row ``elem_value[finish]`` counts.  No launch of the run
takes K12's generic kernel (asserted).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and the exit code is
not 0.
'''

import contextlib
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# per kernel wrapper: route, source, the nutils_tpu function it replaces
KERNELS = {
    'stencil_matvec': ('cuda', 'nutils_tpu_torch/csrc/stencil.cu', 'nutils_tpu/ops/stencil.py:313'),
    'jacobi_smooth': ('cuda', 'nutils_tpu_torch/csrc/mg.cu', 'nutils_tpu/ops/mg.py:162'),
    'jacobi_pre': ('cuda', 'nutils_tpu_torch/csrc/mg.cu', 'nutils_tpu/ops/mg.py:162'),
    'jacobi_post': ('cuda', 'nutils_tpu_torch/csrc/mg.cu', 'nutils_tpu/ops/mg.py:162'),
    'mg_restrict': ('cuda', 'nutils_tpu_torch/csrc/mg.cu', 'nutils_tpu/ops/mg.py:123'),
    'mg_prolong_add': ('cuda', 'nutils_tpu_torch/csrc/mg.cu', 'nutils_tpu/ops/mg.py:142'),
    'cg_dot': ('cuda', 'nutils_tpu_torch/csrc/cg.cu', 'nutils_tpu/ops/sparse.py:322'),
    'cg_step': ('cuda', 'nutils_tpu_torch/csrc/cg.cu', 'nutils_tpu/ops/sparse.py:322'),
    'cg_xpby': ('cuda', 'nutils_tpu_torch/csrc/cg.cu', 'nutils_tpu/ops/sparse.py:322'),
    'blockgrid_matvec': ('cuda', 'nutils_tpu_torch/csrc/blockgrid.cu', 'nutils_tpu/ops/blockgrid.py:276'),
    'gmres_project': ('cuda', 'nutils_tpu_torch/csrc/gmres.cu', 'nutils_tpu/ops/sparse.py:408'),
    'gmres_update': ('cuda', 'nutils_tpu_torch/csrc/gmres.cu', 'nutils_tpu/ops/sparse.py:408'),
    'gmres_normalize': ('cuda', 'nutils_tpu_torch/csrc/gmres.cu', 'nutils_tpu/ops/sparse.py:408'),
    'gmres_start': ('cuda', 'nutils_tpu_torch/csrc/gmres.cu', 'nutils_tpu/ops/sparse.py:408'),
    'gmres_residual': ('cuda', 'nutils_tpu_torch/csrc/gmres.cu', 'nutils_tpu/ops/sparse.py:408'),
    'gmres_solve_combine': ('cuda', 'nutils_tpu_torch/csrc/gmres.cu', 'nutils_tpu/ops/sparse.py:408'),
    'schur_diag_inverse_device': ('cuda', 'nutils_tpu_torch/csrc/schur.cu', 'nutils_tpu/ops/sparse.py:198'),
    # K7's map-free variant on a CSR matrix's values: the same wrapper, read
    # on the triangle step
    'schur_diag_inverse_device[csr]': ('cuda', 'nutils_tpu_torch/csrc/schur.cu', 'nutils_tpu/ops/sparse.py:198'),
    'csr_scatter': ('cuda', 'nutils_tpu_torch/csrc/csr_scatter.cu', 'nutils_tpu/matrix.py:83'),
    'csr_matvec': ('cuda', 'nutils_tpu_torch/csrc/csr_spmv.cu', 'nutils_tpu/ops/sparse.py:274'),
    'bicg_dots': ('cuda', 'nutils_tpu_torch/csrc/bicgstab.cu', 'nutils_tpu/ops/sparse.py:531'),
    'bicg_s': ('cuda', 'nutils_tpu_torch/csrc/bicgstab.cu', 'nutils_tpu/ops/sparse.py:531'),
    'bicg_xr': ('cuda', 'nutils_tpu_torch/csrc/bicgstab.cu', 'nutils_tpu/ops/sparse.py:531'),
    'bicg_refresh': ('cuda', 'nutils_tpu_torch/csrc/bicgstab.cu', 'nutils_tpu/ops/sparse.py:531'),
    'bicg_p': ('cuda', 'nutils_tpu_torch/csrc/bicgstab.cu', 'nutils_tpu/ops/sparse.py:531'),
    'elem_matrix': ('cuda', 'nutils_tpu_torch/csrc/assembly.cu', 'nutils_tpu/solver.py:1231'),
    'elem_vector': ('cuda', 'nutils_tpu_torch/csrc/assembly.cu', 'nutils_tpu/solver.py:950'),
    'block_apply': ('cuda', 'nutils_tpu_torch/csrc/block_jacobi.cu', 'nutils_tpu/ops/sparse.py:122'),
    'mask_pre': ('cuda', 'nutils_tpu_torch/csrc/masked.cu', 'nutils_tpu/ops/sparse.py:274'),
    'mask_post': ('cuda', 'nutils_tpu_torch/csrc/masked.cu', 'nutils_tpu/ops/sparse.py:274'),
    'elem_value': ('cuda', 'nutils_tpu_torch/csrc/value.cu', 'nutils_tpu/solver.py:985'),
    'elem_value_sum': ('cuda', 'nutils_tpu_torch/csrc/value.cu', 'nutils_tpu/solver.py:985'),
    # K15's segment sum folded into a value's last elem_value launch: the
    # same wrapper, its finishing launches read on the finite-strain path
    'elem_value[finish]': ('cuda', 'nutils_tpu_torch/csrc/value.cu', 'nutils_tpu/solver.py:985'),
}
# the factored assembly's element contractions run on all three paths
ASSEMBLY_KERNELS = ('elem_matrix', 'elem_vector')
LAPLACE_KERNELS = ('stencil_matvec', 'jacobi_pre', 'jacobi_post', 'mg_restrict', 'mg_prolong_add', 'cg_dot',
                   'cg_step', 'cg_xpby') + ASSEMBLY_KERNELS
# GMRES (K6) and BiCGStab (K10): their loops on the device, from CUDA graphs
GMRES_KERNELS = ('gmres_project', 'gmres_update', 'gmres_normalize', 'gmres_start', 'gmres_residual',
                 'gmres_solve_combine')
BICGSTAB_KERNELS = ('bicg_dots', 'bicg_s', 'bicg_xr', 'bicg_refresh', 'bicg_p')
NS_KERNELS = ('blockgrid_matvec', 'schur_diag_inverse_device') + GMRES_KERNELS + ASSEMBLY_KERNELS
TRI_KERNELS = ('csr_scatter', 'csr_matvec', 'schur_diag_inverse_device') + GMRES_KERNELS + BICGSTAB_KERNELS \
    + ASSEMBLY_KERNELS
# the Laplace example's solve: assembly in element chunks, GMRES with the
# multigrid V-cycle on the masked stencil operator
EXAMPLE_KERNELS = ('stencil_matvec', 'jacobi_pre', 'jacobi_post', 'mg_restrict', 'mg_prolong_add') + GMRES_KERNELS \
    + ASSEMBLY_KERNELS
# the degree-2 example: its fine level's stencil (k = 2) smooths through
# K2's single sweeps, the coarser levels (k = 1) through the fused ones
P2_KERNELS = ('jacobi_smooth', 'jacobi_pre', 'jacobi_post', 'mg_restrict', 'mg_prolong_add')
P2_NELEMS = 256
# the elasticity example's displacement solve: block-Jacobi CG (K13) on the
# masked CSR operator (K9) from CUDA graphs (K4), assembled through K8, K11
# and K12; the masked operator of the device (K14) on the same jacobian;
# on squares, K13 beside the 3-D stencil K1
ELASTICITY_NELEMS = 360
ELASTICITY_KERNELS = ('block_apply', 'csr_matvec', 'cg_dot', 'cg_step', 'cg_xpby', 'csr_scatter') + ASSEMBLY_KERNELS
MASKED_KERNELS = ('mask_pre', 'mask_post', 'block_apply', 'csr_matvec', 'cg_dot', 'cg_step', 'cg_xpby')
SQUARE_NELEMS = 256
SQUARE_KERNELS = ('block_apply', 'stencil_matvec', 'cg_dot', 'cg_step', 'cg_xpby') + ASSEMBLY_KERNELS
BLOCK_CG = {'solver': 'cg', 'precon': 'block', 'preconargs': {'blocksize': 2}}
# the finite-strain example's energy minimization: the value through K15 on
# every line-search trial (one finishing elem_value a value, the segment sum
# folded into it: elem_value_sum is not launched), the jacobian and
# residual through K11 and K12
FINITESTRAIN_NELEMS = 720
VALUE_KERNELS = ('elem_value',)
# the inner solves: CG from CUDA graphs (K4) with the V-cycle (K1-K3) on the
# masked stencil operator of the vector field's grid
FINITESTRAIN_KERNELS = VALUE_KERNELS + ASSEMBLY_KERNELS + ('stencil_matvec', 'jacobi_pre', 'jacobi_post', 'mg_restrict',
                                                           'mg_prolong_add', 'cg_dot', 'cg_step', 'cg_xpby')
# K1-K4: their launches are summed over the paths that run the V-cycle or
# CG on a stencil operator, each path's beside them
MG_KERNELS = ('stencil_matvec', 'jacobi_smooth', 'jacobi_pre', 'jacobi_post', 'mg_restrict', 'mg_prolong_add', 'cg_dot',
              'cg_step', 'cg_xpby')
# kernel vs plain: float32 sums in another order (and with fused multiply-
# adds) differ by a few ulps, float64 ones by a few ulps of float64
TOL = {'float32': 1e-6, 'float64': 1e-14}
# the H100 SXM data sheet: HBM bandwidth, float32 rate outside the tensor
# cores (the kernels here use none)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the same data sheet's float64 rate outside the tensor cores
F64_FLOPS = 34e12


def bound(nbytes, flops, peak=F32_FLOPS):
    '''(bound ms, what bounds it): the least time for the work, the larger
    of its bytes over the memory rate (each input read once, each output
    written once) and its operations over the peak rate of their type
    (float32 unless ``peak`` says otherwise).'''
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def wrappers():
    from nutils_tpu_torch.ops import assembly, bicgstab, blockgrid, cg, gmres, mg, precon, sparse, stencil
    return {'elem_matrix': assembly.elem_matrix, 'elem_vector': assembly.elem_vector,
            'elem_value': assembly.elem_value, 'elem_value_sum': assembly.elem_value_sum,
            'block_apply': precon.block_apply, 'mask_pre': sparse.mask_pre, 'mask_post': sparse.mask_post,
            'stencil_matvec': stencil.stencil_matvec, 'jacobi_smooth': mg.jacobi_smooth,
            'jacobi_pre': mg.jacobi_pre, 'jacobi_post': mg.jacobi_post,
            'mg_restrict': mg.mg_restrict, 'mg_prolong_add': mg.mg_prolong_add,
            'cg_dot': cg.cg_dot, 'cg_step': cg.cg_step, 'cg_xpby': cg.cg_xpby,
            'blockgrid_matvec': blockgrid.blockgrid_matvec, 'gmres_project': gmres.gmres_project,
            'gmres_update': gmres.gmres_update, 'gmres_normalize': gmres.gmres_normalize,
            'gmres_start': gmres.gmres_start, 'gmres_residual': gmres.gmres_residual,
            'gmres_solve_combine': gmres.gmres_solve_combine,
            'schur_diag_inverse_device': sparse.schur_diag_inverse_device, 'csr_scatter': sparse.csr_scatter,
            'csr_matvec': sparse.csr_matvec, 'bicg_dots': bicgstab.bicg_dots, 'bicg_s': bicgstab.bicg_s,
            'bicg_xr': bicgstab.bicg_xr, 'bicg_refresh': bicgstab.bicg_refresh, 'bicg_p': bicgstab.bicg_p}


# K12's launches on its generic kernel (an operand that vector_plan
# refuses), summed over the run's resets: none may come from any path
GENERIC_K12 = [0]


def reset_launches():
    GENERIC_K12[0] += getattr(wrappers()['elem_vector'], 'forms', {}).get('generic', 0)
    for wrapper in wrappers().values():
        wrapper.launches = 0
        if getattr(wrapper, 'forms', None):
            wrapper.forms = dict.fromkeys(wrapper.forms, 0)


def read_launches(names):
    counters = wrappers()
    return {name: counters[name].launches for name in names}


# the wrappers whose kernels come in forms chosen by shape (K1: tiled or
# generic; K2's fused sweeps: 2-D, components or 3-D box), and their
# launches by form on each path that runs them (filled by the phases)
FORM_KERNELS = ('stencil_matvec', 'jacobi_pre', 'jacobi_post')
FORMS_BY_PATH = {}


def read_forms(path, only):
    """The launches of K1 and K2's fused sweeps by form since the counts
    were last reset (``_kernels.count``), {name: {form: launches}}, kept
    as ``path``'s; raises unless every launch of each kernel named in
    ``only`` took the form given there."""
    counters = wrappers()
    forms = FORMS_BY_PATH[path] = {name: {form: count for form, count in getattr(counters[name], 'forms', {}).items()
                                          if count} for name in FORM_KERNELS}
    for name, form in only.items():
        # another checkout's package may count no forms
        if hasattr(counters[name], 'forms') and set(forms[name]) != {form}:
            raise AssertionError(f'{path}: {name} launched in the forms {forms[name]}, expected {form} alone')
    return forms


def _events(run, reps, setup=None):
    import torch
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()  # enqueued before the start event: not timed
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms(fn, calls=10, reps=7, setup=None):
    '''(device ms, call ms) of one call of ``fn``.  Device: a CUDA graph of
    ``calls`` calls replayed ``reps`` times between CUDA events, median per
    call; the host's launch overhead is not in it.  Call: CUDA events around
    single eager calls, median of ``reps`` after warm-up; the host's Python
    and launch overhead is in it.  ``setup`` (untimed) runs before each
    timed run.'''
    import torch
    for _ in range(3):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    if setup is not None:
        setup()
    graph.replay()
    torch.cuda.synchronize()
    return _events(graph.replay, reps, setup) / calls, _events(fn, reps, setup)


def time_eager_ms(fn, calls=10, reps=5):
    '''Device ms of one call of ``fn``: CUDA events around ``calls``
    back-to-back eager calls, median of ``reps`` after warm-up (for library
    calls that are not captured into a CUDA graph; host overhead hides
    behind calls of 100 us or more).'''
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
    return _events(run, reps) / calls


def build_ns(nelems, dtype, etype='square'):
    '''bench.build_ns, written against nutils_tpu_torch: the Taylor-Hood
    (P2/P1) Navier-Stokes implicit-Euler step with convection linearized at
    a random state, on the unit square of ``etype`` elements.'''
    import numpy
    from nutils_tpu_torch import function, mesh
    from nutils_tpu_torch.expression import Namespace
    from nutils_tpu_torch.solver import System
    from nutils_tpu_torch.utils import config
    config.floatx.value = dtype
    topo, geom = mesh.unitsquare(nelems, etype)
    ns = Namespace()
    ns.x = geom
    ns.define_for('x', gradient='∇', jacobians=('dV',))
    ns.u = topo.field('u', btype='std', degree=2, shape=[2])
    ns.p = topo.field('p', btype='std', degree=1)
    ns.v = function.replace_arguments(ns.u, 'u:v')
    ns.q = function.replace_arguments(ns.p, 'p:q')
    ns.δ = function.eye(2)
    ns.u0_i = 'sin(x_0) cos(x_1) δ_i0 - cos(x_0) sin(x_1) δ_i1'  # prior state (divergence-free)
    ns.dt = 0.01
    ns.nu = 0.001
    ns.eps = 0.001  # pressure stabilization: removes the nullspace without BCs
    res = topo.integral(
        '(v_i (u_i - u0_i) / dt + v_i u_j ∇_j(u_i) + nu ∇_j(v_i) ∇_j(u_i)'
        ' - p ∇_i(v_i) + q ∇_i(u_i) + eps p q) dV' @ ns, degree=6)
    system = System(res, trial='u,p', test='v,q')
    rng = numpy.random.default_rng(0)
    args = {t: 0.1 * rng.standard_normal(shape)
            for t, shape in zip(system.trials, system.trial_shapes)}
    return system, args


def build_laplace(nelems, dtype, reaction=False):
    '''bench.build_laplace, written against nutils_tpu_torch.'''
    from nutils_tpu_torch import function, mesh
    from nutils_tpu_torch.solver import System
    from nutils_tpu_torch.utils import config
    config.floatx.value = dtype
    topo, geom = mesh.unitsquare(nelems, 'square')
    u = topo.field('u', btype='std', degree=1)
    g = function.grad(u, geom)
    J = function.J(geom)
    f = function.sin(geom[0]) * function.cosh(geom[1])
    energy = topo.integral(((g @ g) / 2 + (u * u) / 2 * reaction - f * u) * J, degree=2)
    return System(energy, trial='u')


# ------------------------------------------------------------------ phases

def phase_device():
    import torch
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit('device', nvidia_smi=smi[0], torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)))
    return smi[0]


def phase_build():
    from nutils_tpu_torch import _kernels
    from nutils_tpu_torch.ops import cg
    path, seconds, diag = _kernels.build(verbose=True)
    _kernels.library()
    emit('build_cg', grid=cg.grid(0))
    ptxas = [line.strip() for line in diag.splitlines() if 'registers' in line or 'spill' in line]
    emit('build', library=str(path.relative_to(ROOT)), nvcc_seconds=seconds, ptxas=ptxas)


def _compare(got, want, scale=None):
    '''(max abs error, max abs error over the scale): the scale is the largest
    magnitude of the plain result unless given.'''
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max()) if scale is None else float(scale)
    return err, err / max(ref, 1e-300)


def row(err, ms, plain_ms, nbytes, flops, library_ms=None, peak=F32_FLOPS):
    bound_ms, bound_by = bound(nbytes, flops, peak)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def check_row(name, label, dname, relerr, fields):
    emit('kernel', name=name, case=label, dtype=dname, max_rel_err=relerr, tol=TOL[dname], **fields)
    if not relerr <= TOL[dname]:
        raise AssertionError(f'{name} ({label}, {dname}) disagrees with its plain version: {relerr:.3e}')


def phase_fused_rows(label, w, dinv, r, x, ks, shape, per, dname, peak, nu=2):
    """K2's fused launches (``jacobi_pre``, ``jacobi_post``) at one grid:
    the same bits as the single sweeps they replace (``jacobi_smooth``, its
    launches counted: none may come from the fused calls), against their
    plain versions, timed beside those sweeps; each row with the form the
    grid takes and the sha1 of its outputs (to compare with another
    package's at the same inputs), and, in the component form, the same
    bits as the box form, launched directly and timed beside it
    (``box_ms``); returns {name: row}."""
    import torch
    from nutils_tpu_torch import _kernels
    from nutils_tpu_torch.ops import mg
    n = int(r.numel())
    W = int(w.shape[0])
    isz = r.element_size()

    def pre_sweeps():
        xs = mg.jacobi_smooth(w, dinv, r, None, ks, shape, per, mode=0)
        for _ in range(nu - 1):
            xs = mg.jacobi_smooth(w, dinv, r, xs, ks, shape, per, mode=1)
        return xs, mg.jacobi_smooth(w, dinv, r, xs, ks, shape, per, mode=2)

    def post_sweeps():
        xs = x
        for _ in range(nu):
            xs = mg.jacobi_smooth(w, dinv, r, xs, ks, shape, per, mode=1)
        return xs
    # each launch moves the weights, r, dinv (and x) once and writes its
    # outputs once: W + 4 values a point
    cases = {'jacobi_pre': (lambda: mg.jacobi_pre(w, dinv, r, ks, shape, per, nu), pre_sweeps,
                            lambda: mg.jacobi_pre_plain(w, dinv, r, ks, shape, per, mg.OMEGA, nu),
                            2 * n + (nu - 1) * (2 * W + 4) * n + (2 * W + 1) * n),
             'jacobi_post': (lambda: mg.jacobi_post(w, dinv, r, x, ks, shape, per, nu), post_sweeps,
                             lambda: mg.jacobi_post_plain(w, dinv, r, x, ks, shape, per, mg.OMEGA, nu),
                             nu * (2 * W + 4) * n)}
    # the form the level takes (``ops/mg.fused_form``; a package without
    # it has the 2-D and box forms alone), and beside the component form
    # the box form, launched directly (``ntt_jacobi_fused``'s code 0)
    if hasattr(mg, 'fused_form'):
        form = mg.fused_form(ks, shape, per, nu)
    else:
        form = '2d' if len(shape) == 2 else 'box'

    def box(pre):
        out = torch.empty_like(r)
        res = torch.empty_like(r) if pre else None
        return (lambda: _kernels.launch('ntt_jacobi_fused', r, [w, dinv, r, None if pre else x, out, res, None],
                                        shape, ks=ks, periodic=per, scalars=(mg.OMEGA, nu, int(pre), 0))), \
            (out, res) if pre else (out,)
    results = {}
    for name, (kernel, sweeps, plain, flops) in cases.items():
        single = mg.jacobi_smooth.launches
        got = kernel()
        if mg.jacobi_smooth.launches != single:
            raise AssertionError(f'{name} ({label}) ran single sweeps, not its fused kernel')
        ref, want = sweeps(), plain()
        torch.cuda.synchronize()
        got, ref, want = [(t,) if isinstance(t, torch.Tensor) else t for t in (got, ref, want)]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        errs = [_compare(a, b) for a, b in zip(got, want)]
        err, relerr = max(e[0] for e in errs), max(e[1] for e in errs)
        (ms, call_ms), (plain_ms, _pc) = time_ms(kernel), time_ms(plain)
        sweeps_ms = time_ms(sweeps)[0]
        fields = dict(row(err, ms, plain_ms, (W + 4) * n * isz, flops, None, peak), form=form,
                      sha1=digest(torch.cat([t.reshape(-1) for t in got])))
        if form == 'components':
            launch, outs = box(name == 'jacobi_pre')
            launch()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, outs)):
                raise AssertionError(f'{name} ({label}, {dname}): the component form differs from the box form')
            fields['box_ms'] = time_ms(launch)[0]
        check_row(name, label, dname, relerr, dict(fields, shape=list(shape), ks=list(ks), periodic=list(per), nu=nu,
                                                   bitwise_equal_single_sweeps=bitwise, single_sweeps_ms=sweeps_ms,
                                                   single_sweeps_launches=2 * nu, call_ms=call_ms))
        if not bitwise:
            raise AssertionError(f'{name} ({label}, {dname}) differs from the single sweeps it replaces')
        results[name] = fields
    return results


def digest(t):
    """sha1 of a tensor's bits (to compare outputs between packages or calls)."""
    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def stencil_forms(w, x, ks, shape, per, got):
    """K1's form at a grid (``ops/stencil.matvec_form``; a package without
    it has the generic form alone), the sha1 of its output ``got`` (to
    compare with another package's at the same inputs), and the generic
    kernel launched directly: the same bits, its time beside the form's."""
    import torch
    from nutils_tpu_torch import _kernels
    from nutils_tpu_torch.ops import stencil
    form = stencil.matvec_form(ks, shape, per) if hasattr(stencil, 'matvec_form') else 'generic'
    y = torch.empty_like(x)

    def generic():
        _kernels.launch('ntt_stencil_matvec', x, [w, x, y, None], shape, ks=ks, periodic=per)
    generic()
    torch.cuda.synchronize()
    if digest(got) != digest(y):
        raise AssertionError(f'stencil_matvec at {shape}: the {form} form differs from the generic kernel')
    return dict(form=form, sha1=digest(got), generic_ms=time_ms(generic)[0])


def transfer_rows(label, f, x, per, dname, peak, rng):
    """K3 (``mg_restrict``, ``mg_prolong_add``) at one grid and the coarse
    grid the hierarchy's rule makes of it (``ops/mg._coarsen_flags``: a
    vector field's component axis is kept), against its plain version: the
    form it takes (``ops/mg.transfer_form``), the same bits as the generic
    kernel (launched directly), the sha1 of its outputs (to compare with
    another package's at the same inputs), its time beside the generic
    kernel's and a strided convolution's (full weighting and linear
    interpolation as ``F.conv2d`` / ``F.conv_transpose2d``, or their 3-D
    forms with the component axis kept; the transposed convolution does not
    add into x, so it computes less than prolong-add).  Prolong-add adds
    into a scratch x made outside the timed graph (its values drift, its
    time does not).  Returns {name: row}."""
    import numpy
    import torch
    import torch.nn.functional as F
    from nutils_tpu_torch import _kernels
    from nutils_tpu_torch.ops import mg
    shape = tuple(f.shape)
    dtype, dev, isz = f.dtype, f.device, f.element_size()
    flags = mg._coarsen_flags(shape, per, 1)
    cshape = tuple((s + 1) // 2 if fl else s for s, fl in zip(shape, flags))
    n, nc = int(numpy.prod(shape)), int(numpy.prod(cshape))
    form = mg.transfer_form(shape, cshape) if hasattr(mg, 'transfer_form') else 'generic'
    xc = torch.as_tensor(rng.standard_normal(cshape), dtype=dtype, device=dev)
    rc_generic = torch.empty(cshape, dtype=dtype, device=dev)
    scratch = x.clone()
    generic = {'mg_restrict': lambda: _kernels.launch('ntt_restrict', f, [f, rc_generic, None], shape, cshape=cshape),
               'mg_prolong_add': lambda: _kernels.launch('ntt_prolong_add', scratch, [scratch, xc, None], shape,
                                                         cshape=cshape)}
    t1 = torch.tensor([0.5, 1.0, 0.5], dtype=dtype, device=dev)
    if len(shape) == 2:
        k = torch.outer(t1, t1).reshape(1, 1, 3, 3)
        fk, xck = f.reshape(1, 1, *shape), xc.reshape(1, 1, *cshape)
        library = {'mg_restrict': lambda: F.conv2d(fk, k, stride=2, padding=1),
                   'mg_prolong_add': lambda: F.conv_transpose2d(xck, k, stride=2, padding=1)}
    else:
        k = torch.outer(t1, t1).reshape(1, 1, 3, 3, 1)
        fk, xck = f.reshape(1, 1, *shape), xc.reshape(1, 1, *cshape)
        library = {'mg_restrict': lambda: F.conv3d(fk, k, stride=(2, 2, 1), padding=(1, 1, 0)),
                   'mg_prolong_add': lambda: F.conv_transpose3d(xck, k, stride=(2, 2, 1), padding=(1, 1, 0))}
    checks = {'mg_restrict': (lambda: mg.mg_restrict(f, cshape), lambda: mg.mg_restrict(f, cshape),
                              lambda: mg.restrict_plain(f, cshape), (n + nc) * isz, 8 * nc),
              'mg_prolong_add': (lambda: mg.mg_prolong_add(x.clone(), xc), lambda: mg.mg_prolong_add(scratch, xc),
                                 lambda: x + mg.prolong_plain(xc, shape), (2 * n + nc) * isz, 4 * n)}
    results = {}
    for name, (check, kernel, plain, nbytes, flops) in checks.items():
        got, want = check(), plain()
        scratch.copy_(x)
        generic[name]()
        ref = rc_generic if name == 'mg_restrict' else scratch
        torch.cuda.synchronize()
        same_bits = digest(got) == digest(ref)
        err, relerr = _compare(got, want)
        (ms, call_ms), (plain_ms, _pc) = time_ms(kernel), time_ms(plain)
        generic_ms = time_ms(generic[name])[0]
        fields = dict(row(err, ms, plain_ms, nbytes, flops, time_ms(library[name])[0], peak), generic_ms=generic_ms,
                      form=form, sha1=digest(got))
        check_row(name, label, dname, relerr, dict(fields, shape=list(shape), cshape=list(cshape), call_ms=call_ms,
                                                   same_bits_as_generic=same_bits))
        if not same_bits:
            raise AssertionError(f'{name} ({label}, {dname}): the {form} form differs from the generic kernel')
        results[name] = fields
    return results


# (label, shape, ks, periodic, dtypes, what) of phase_kernels: the Laplace
# slice's grid; a periodic 2-D and a 3-D grid; the example's fine grid (K1,
# K2 fused and K3, its float64); the degree-2 example's fine grid (K2 single
# sweeps, k = 2); the finite-strain grid (a vector field: K1, K2 fused and
# K3 with the component axis kept, float64) and the hierarchy's three
# coarser smoothed levels (K1, K2 fused; K3 from the two finer of them)
_BOTH = ('float32', 'float64')
_FS = (FINITESTRAIN_NELEMS + 1,) * 2 + (2,)
FINITESTRAIN_LEVELS = [(f'finitestrain_l{level}', tuple((s - 1) // 2 ** level + 1 for s in _FS[:2]) + (2,))
                       for level in (1, 2, 3)]
KERNEL_CASES = [('slice', (1025, 1025), (1, 1), (False, False), _BOTH, ('stencil', 'sweeps', 'fused', 'transfers')),
                ('periodic', (1024, 1025), (1, 1), (True, False), _BOTH, ('stencil', 'fused')),
                ('3d', (129, 129, 65), (1, 1, 1), (False, False, False), _BOTH, ('stencil', 'fused')),
                ('example', (2049, 2049), (1, 1), (False, False), ('float64',), ('stencil', 'fused', 'transfers')),
                ('p2', (2 * P2_NELEMS + 1,) * 2, (2, 2), (False, False), ('float64',), ('sweeps',)),
                ('finitestrain', _FS, (1, 1, 1), (False, False, False), ('float64',), ('stencil', 'fused', 'transfers'))
                ] + [(label, shape, (1, 1, 1), (False, False, False), ('float64',),
                      ('stencil', 'fused') + (('transfers',) if shape[0] > 91 else ()))
                     for label, shape in FINITESTRAIN_LEVELS]
# the rows of K1-K3 kept beside each kernel's main row (the slice's, float32)
EXTRA_ROWS = {('slice', 'float64'), ('example', 'float64'), ('periodic', 'float32'), ('finitestrain', 'float64'),
              *((label, 'float64') for label, _s in FINITESTRAIN_LEVELS)}


def kernel_cases(what):
    '''The cases of :data:`KERNEL_CASES` named in ``what`` (label -> what
    to run there).'''
    return [case[:5] + (what[case[0]],) for case in KERNEL_CASES if case[0] in what]


def phase_kernels(device='cuda', cases=KERNEL_CASES, k4=True):
    """K1-K4 against their plain versions, on the card, at ``cases``
    (K4: at the slice's length, unless ``k4`` is false); returns {name:
    row} at the Laplace slice's float32 shapes, each of K1-K3's with its
    rows at the other paths' shapes (``rows``, keyed by case and dtype)."""
    import numpy
    import torch
    from nutils_tpu_torch import _kernels, carry
    from nutils_tpu_torch.ops import cg, mg, stencil
    dev = torch.device(device)
    results = {}
    extra = {}

    def keep(name, label, dname, fields):
        if label == 'slice' and dname == 'float32':
            results[name] = fields
        elif (label, dname) in EXTRA_ROWS:
            extra.setdefault(name, {})[f'{label} {dname}'] = fields
    for label, shape, ks, per, dtypes, what in cases:
        rng = numpy.random.default_rng(list(label.encode()))  # a case's inputs whatever cases run
        W = int(numpy.prod([2 * k + 1 for k in ks]))
        w_np = rng.standard_normal((W,) + shape)
        x_np = rng.standard_normal(shape)
        n = int(numpy.prod(shape))
        for dname in dtypes:
            dtype = getattr(torch, dname)
            isz = 4 if dtype == torch.float32 else 8
            peak = F32_FLOPS if dtype == torch.float32 else F64_FLOPS
            w = torch.as_tensor(w_np, dtype=dtype, device=dev)
            x = torch.as_tensor(x_np, dtype=dtype, device=dev)
            dinv = torch.as_tensor(rng.random(shape) + 1, dtype=dtype, device=dev)
            r = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
            library = {}
            checks = {}
            if 'stencil' in what:
                checks['stencil_matvec'] = (lambda: stencil.stencil_matvec(w, x, ks, shape, per),
                                            lambda: stencil.matvec_plain(w, x, ks, shape, per),
                                            (W + 2) * n * isz, 2 * W * n)
                if label in ('slice', 'periodic', 'example') or label.startswith('finitestrain'):
                    # the same product as one cuSPARSE CSR matvec
                    indptr, indices, data = carry._csr_of_stencil(w_np, ks, shape, per)
                    A = torch.sparse_csr_tensor(torch.as_tensor(indptr), torch.as_tensor(indices),
                                                torch.as_tensor(data, dtype=dtype), size=(n, n)).to(dev)
                    xf = x.reshape(-1)
                    library['stencil_matvec'] = lambda: torch.mv(A, xf)
            if 'sweeps' in what:
                sweep = {0: (3 * n, 2 * n), 1: ((W + 4) * n, (2 * W + 4) * n), 2: ((W + 3) * n, (2 * W + 1) * n)}
                for mode in (0, 1, 2):
                    checks[f'jacobi_smooth/mode{mode}'] = (
                        lambda mode=mode: mg.jacobi_smooth(w, dinv, r, x, ks, shape, per, mode=mode),
                        lambda mode=mode: mg.jacobi_plain(w, dinv, r, x, ks, shape, per, mg.OMEGA, mode),
                        sweep[mode][0] * isz, sweep[mode][1])
            for name, (kernel, plain, nbytes, flops) in checks.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err, relerr = _compare(got, want)
                (ms, call_ms), (plain_ms, plain_call_ms) = time_ms(kernel), time_ms(plain)
                lib = library.get(name.split('/')[0]) if name != 'jacobi_smooth/mode0' else None
                fields = row(err, ms, plain_ms, nbytes, flops, None if lib is None else time_ms(lib)[0], peak)
                if name == 'stencil_matvec':
                    fields.update(stencil_forms(w, x, ks, shape, per, got))
                check_row(name, label, dname, relerr, dict(fields, shape=list(shape), ks=list(ks),
                                                           periodic=list(per), call_ms=call_ms,
                                                           plain_call_ms=plain_call_ms))
                if name == 'stencil_matvec':
                    keep(name, label, dname, fields)
                if label == 'p2' and name == 'jacobi_smooth/mode1':
                    results['jacobi_smooth'] = fields
            if 'fused' in what:
                for name, fields in phase_fused_rows(label, w, dinv, r, x, ks, shape, per, dname, peak).items():
                    keep(name, label, dname, fields)
            if 'transfers' in what:
                for name, fields in transfer_rows(label, r, x, per, dname, peak, rng).items():
                    keep(name, label, dname, fields)
    for name, rows in extra.items():
        results[name] = dict(results.get(name, {}), rows=rows)
    if not k4:
        return results
    # K4 on CG vectors of the slice's length and a state of the loop's: each
    # entry against its plain version on the same state; the sums on the
    # scale of their terms (the scale of any summation's rounding error).
    # Timed runs start from the same state (an untimed reset before each),
    # so cg_step never meets its refresh schedule and stays active.
    n = 1025 * 1025
    rng = numpy.random.default_rng(0)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split('.')[1]
        isz = 4 if dtype == torch.float32 else 8
        x, r, p, ap, z = (torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev) for _ in range(5))
        head = cg.new_state(dev)
        cg.reset(head, 0.0, 1 << 30)
        for slot, v in ((cg.RZ, 0.7), (cg.PAP, 1.3), (cg.RZOLD, 0.4)):
            head[slot] = float(torch.tensor(v, dtype=dtype))
        st1, st2 = head.clone(), head.clone()
        x1, r1, p1, x2, r2, p2 = x.clone(), r.clone(), p.clone(), x.clone(), r.clone(), p.clone()
        cg.cg_dot(p, ap, st1, cg.PAP)
        cg.dot_plain(p, ap, st2, cg.PAP)
        dot = (st1[cg.PAP], st2[cg.PAP], (p * ap).abs().sum())
        st1[cg.PAP], st2[cg.PAP] = head[cg.PAP], head[cg.PAP]
        cg.cg_step(x1, r1, p, ap, st1)
        cg.step_plain(x2, r2, p, ap, st2)
        step = [(x1, x2, None), (r1, r2, None), (st1[cg.RR], st2[cg.RR], (r2 * r2).sum()),
                (st1[cg.RZOLD], st2[cg.RZOLD], None)]
        cg.cg_xpby(p1, z, st1)
        cg.xpby_plain(p2, z, st2)
        torch.cuda.synchronize()
        ints1, ints2 = st1.view(torch.int32), st2.view(torch.int32)
        if not torch.equal(ints1[cg.K:cg.REASON + 1], ints2[cg.K:cg.REASON + 1]):
            raise AssertionError(f'K4 ({dname}) took other decisions than its plain version')
        compared = {'cg_dot': [dot], 'cg_step': step, 'cg_xpby': [(p1, p2, None)]}
        beta = (head[cg.RZ] / head[cg.RZOLD]).to(dtype)

        def restore(st):
            return lambda: st.copy_(head)
        timed = {  # kernel, plain, vectors moved, operations, library call
            'cg_dot': (lambda: cg.cg_dot(p, ap, st1, cg.PAP), lambda: cg.dot_plain(p, ap, st2, cg.PAP), 2, 2,
                       lambda: torch.dot(p, ap)),
            'cg_step': (lambda: cg.cg_step(x1, r1, p, ap, st1), lambda: cg.step_plain(x2, r2, p, ap, st2), 6, 6,
                        None),
            'cg_xpby': (lambda: cg.cg_xpby(p1, z, st1), lambda: cg.xpby_plain(p2, z, st2), 3, 2,
                        lambda: torch.addcmul(z, beta, p1)),
        }
        for name, triples in compared.items():
            errs = [_compare(got, want, scale) for got, want, scale in triples]
            err, relerr = max(e[0] for e in errs), max(e[1] for e in errs)
            kernel, plain, nvec, flops, lib = timed[name]
            (ms, call_ms), (plain_ms, plain_call_ms) = time_ms(kernel, setup=restore(st1)), \
                time_ms(plain, setup=restore(st2))
            fields = row(err, ms, plain_ms, nvec * n * isz, flops * n, time_ms(lib)[0] if lib is not None else None)
            check_row(name, 'slice', dname, relerr, dict(fields, n=n, call_ms=call_ms, plain_call_ms=plain_call_ms))
            if dtype == torch.float32:
                results[name] = fields
        # every K4 launch takes one grid (cg.BLOCKS_PER_SM blocks an SM, or
        # as many as fit), and the sums' order depends on it: each entry at
        # 1-8 blocks an SM
        grids = {}
        for per_sm in range(1, 9):
            g = cg.grid(dev.index or 0, per_sm)
            st = torch.zeros(cg.HEAD + g, dtype=torch.float64, device=dev)
            calls = {'cg_dot': lambda: _kernels.call('ntt_cg_dot', p, [p, ap, st], scalars=(n, g, cg.PAP, 0)),
                     'cg_step': lambda: _kernels.call('ntt_cg_step', x1, [x1, r1, p, ap, st], scalars=(n, g)),
                     'cg_xpby': lambda: _kernels.call('ntt_cg_xpby', p1, [p1, z, st], scalars=(n, g))}
            grids[per_sm] = dict(grid=g, **{name: time_ms(fn, setup=lambda: st[:cg.HEAD].copy_(head[:cg.HEAD]))[0]
                                            for name, fn in calls.items()})
        emit('kernel_cg_grid', dtype=dname, n=n, blocks_per_sm_used=cg.BLOCKS_PER_SM, ms=grids)
    return results


def phase_slice(nelems=1024, device='cuda'):
    '''The main path: assemble and solve the 1,050,625-dof Laplace slice
    through the kernels; returns the launch counts of that run.'''
    import numpy
    import torch
    from nutils_tpu_torch.utils import config
    with config.device(device):
        t0 = time.perf_counter()
        system = build_laplace(nelems, numpy.float32, reaction=True)
        t_system = time.perf_counter() - t0
        check_routes('slice', system)
        ndofs = system.trial_shapes[0][0]
        args = {'u': numpy.zeros(ndofs)}
        fn = system._compiled('jacres')
        clean = system._clean(args)
        times = []
        for _ in range(3):  # the first call also plans and moves the tables
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(clean)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        emit('slice_assembly', ndofs=ndofs, t_system=t_system, t_assemble_first=times[0], t_assemble=min(times[1:]),
             t_assemble_generic=generic_route_time(system, clean))
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        jac, res = system.assemble_jacobian_residual(args)
        torch.cuda.synchronize()
        t_jacres = time.perf_counter() - t0
        t0 = time.perf_counter()
        jac._pattern_src.get()
        t_pattern = time.perf_counter() - t0
        t0 = time.perf_counter()
        k1_before = read_launches(('stencil_matvec',))['stencil_matvec']
        jac._mg()
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        # host set-up, not solve: the CSR pattern sort that the multigrid
        # set-up forces, then the Galerkin hierarchy (K1 launches there are
        # its levels' power-step estimates, none where a level's Gershgorin
        # bound makes them needless)
        emit('slice_setup', t_pattern=t_pattern, t_setup=t_setup,
             k1_setup_launches=read_launches(('stencil_matvec',))['stencil_matvec'] - k1_before,
             smoothing=smoothing_records(jac._mg()))
        t0 = time.perf_counter()
        x = jac.solve(res, solver='cg', rtol=1e-10)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        launches = read_launches(LAPLACE_KERNELS)
        single_sweeps = read_launches(('jacobi_smooth',))['jacobi_smooth']
        forms = read_forms('slice', {'stencil_matvec': 'tile', 'jacobi_pre': '2d', 'jacobi_post': '2d'})
        stats = dict(jac._solve_stats)
        peak = torch.cuda.max_memory_allocated()
        # a warm solve only replays: its launches are the replays times each
        # graph's launches, and the refinement's float64 residual (K1) once a
        # round
        reset_launches()
        times = []
        expected = dict.fromkeys(LAPLACE_KERNELS, 0)
        for _ in range(5):
            times.append(_sync_time(lambda: jac.solve(res, solver='cg', rtol=1e-10))[0])
            warm = dict(jac._solve_stats)
            for name in LAPLACE_KERNELS:
                expected[name] += sum(warm['replays'][g] * warm['graph_launches'][g].get(name, 0)
                                      for g in warm['replays'])
            expected['stencil_matvec'] += warm['rounds']
        t_solve_again = statistics.median(times)
        warm_launches = read_launches(LAPLACE_KERNELS)
    config.floatx.value = numpy.float64
    resnorm = float(numpy.linalg.norm(res - jac @ x))
    rel_residual = resnorm / float(numpy.linalg.norm(res))
    levels = [list(lev[1]) for lev in jac._mg().levels]
    emit('slice', ndofs=ndofs, t_system=t_system, t_jacres=t_jacres, t_pattern=t_pattern, t_setup=t_setup,
         t_solve=t_solve, t_solve_again=t_solve_again, t_solve_warm_all=times, solve_stats=stats,
         warm_solve_stats=warm, rel_residual=rel_residual, mg_levels=levels, peak_device_bytes=peak,
         launches=launches, single_sweep_launches=single_sweeps, launches_by_form=forms,
         warm_launches_per_solve={k: v / 5 for k, v in warm_launches.items()})
    if x.shape != (ndofs,) or not numpy.isfinite(x).all():
        raise AssertionError('slice solution is not a finite vector of the dof count')
    if single_sweeps:
        raise AssertionError(f'the slice\'s V-cycle ran {single_sweeps} single K2 sweeps, not only fused ones')
    if stats['op_form'] != 'stencil' or stats['precon'] != 'mg':
        raise AssertionError(f'slice solved through {stats["op_form"]}/{stats["precon"]}, not stencil/mg')
    if stats['driver'] != 'graph' or warm['driver'] != 'graph' or warm['t_capture'] != 0:
        raise AssertionError(f'slice solved through the {stats["driver"]} driver, not CUDA graphs (warm: '
                             f'{warm["driver"]}, capture {warm["t_capture"]} s)')
    if warm_launches != expected:
        raise AssertionError(f'warm solves launched {warm_launches}, replays say {expected}')
    if not jac._accept(x, resnorm, 1e-10 * float(numpy.linalg.norm(res)), numpy.float64):
        raise AssertionError(f'slice solution fails the _accept contract: rel residual {rel_residual:.3e}')
    missing = [name for name, count in launches.items() if count <= 0]
    if missing:
        raise AssertionError(f'kernels not launched on the main path: {missing}')
    return launches, system, clean, jac, res


def phase_slice_profile(jac, res):
    """torch.profiler over one warm solve of the slice with each driver (the
    graphs through ``Matrix.solve``, the host loop through the same refined
    solve): wall time, device-busy time and its share, kernel launches,
    graph replays and host reads."""
    from nutils_tpu_torch.ops import sparse
    kw = _slice_operands(jac, res)

    def host_loop():
        stats = {}
        _x, _rn, iters, rounds = sparse.refined_solve_op(**kw, chunk=None, stats=stats)
        return dict(stats, iters=iters, rounds=rounds)
    runs = [('graph', lambda: (jac.solve(res, solver='cg', rtol=1e-10), dict(jac._solve_stats))[1]),
            ('host', host_loop)]
    for label, run in runs:
        run()  # warm
        wall, kernels, _full, stats = profiled(run)
        busy = busy_s(kernels)
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
        emit('slice_profile', driver=label, wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
             kernel_launches=sum(e.count for e in kernels), replays=stats.get('replays'),
             host_reads=stats['host_reads'], chunks=stats.get('chunks'), refreshes=stats.get('refreshes'),
             iters=stats.get('iters'), rounds=stats.get('rounds'),
             top=[{'name': e.key[:80], 'device_ms': e.self_device_time_total / 1e3, 'count': e.count} for e in top])


def _slice_operands(jac, res):
    """The arguments ``Matrix._device_krylov`` gives the refined CG solve of
    the slice (stencil operator, multigrid, rtol 1e-10)."""
    import numpy
    mv_kind, op = jac._device_op()
    mg = jac._mg()
    n = jac.shape[0]
    return dict(method='cg', mv_kind=mv_kind, op=op, b=numpy.asarray(res, dtype=numpy.float64),
                target=1e-10 * float(numpy.linalg.norm(res)), maxiter=max(1024, int(16 * numpy.sqrt(n))),
                minv=(mg.ws, mg.dinvs, mg.coarse_inv), precon=('mg', mg.levels), op64=jac._op64_cache)


def phase_slice_driver(jac, res):
    """The graph driver against the host loop on the slice: bitwise x, the
    same iterations and rounds; warm solves at chunk lengths 1-8 (the
    choice of ``CG_CHUNK``); an iteration's device time after the loop's
    stop, the multigrid kernels predicated on the loop's flag and not."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import cg, sparse
    kw = _slice_operands(jac, res)
    runs = {}
    for label, chunk in (('host', None), ('graph', sparse.CG_CHUNK), ('graph again', sparse.CG_CHUNK),
                         ('host again', None)):
        stats = {}
        t, out = _sync_time(lambda: sparse.refined_solve_op(**kw, chunk=chunk, stats=stats))
        runs[label] = out, stats, t
    (xh, rnh, ith, rh), (xg, rng_, itg, rg) = runs['host'][0], runs['graph'][0]
    bitwise = bool(numpy.array_equal(xh, xg) and all(numpy.array_equal(runs[k][0][0], xh) for k in runs))
    same = (ith, rh, rnh) == (itg, rg, rng_) and all(runs[k][0][1:] == runs['host'][0][1:] for k in runs)
    emit('slice_driver', bitwise_x=bitwise, same_iters_rounds_resnorm=same, iters=ith, rounds=rh,
         resnorm=rnh, chunk=sparse.CG_CHUNK, runs={k: dict(seconds=v[2], stats=v[1]) for k, v in runs.items()})
    if not (bitwise and same):
        raise AssertionError(f'the graph driver differs from the host loop: bitwise x {bitwise}, iterations '
                             f'{ith}/{itg}, rounds {rh}/{rg}')
    # the host loop with K4's plain versions (torch's reductions in their
    # order) on the card: does the iteration count follow the sums' order?
    saved = cg.cg_dot, cg.cg_step, cg.cg_xpby
    cg.cg_dot, cg.cg_step, cg.cg_xpby = cg.dot_plain, cg.step_plain, cg.xpby_plain
    try:
        stats = {}
        xp, rnp, itp, rp = sparse.refined_solve_op(**kw, chunk=None, stats=stats)
    finally:
        cg.cg_dot, cg.cg_step, cg.cg_xpby = saved
    emit('slice_k4_plain', iters=itp, rounds=rp, resnorm=rnp, refreshes=stats.get('refreshes'),
         refuted=stats.get('refuted'), rel_x=float(numpy.linalg.norm(xp - xh) / numpy.linalg.norm(xh)))
    # warm solves at each chunk length: the first captures, the next three
    # are timed (host clock, synchronised)
    sweep = {}
    for chunk in (1, 2, 3, 4, 8):
        sparse.refined_solve_op(**kw, chunk=chunk)
        times = []
        for _ in range(3):
            stats = {}
            times.append(_sync_time(lambda: sparse.refined_solve_op(**kw, chunk=chunk, stats=stats))[0])
        sweep[chunk] = dict(seconds=statistics.median(times), host_reads=stats['host_reads'],
                            replays=stats.get('replays'))
    host = [_sync_time(lambda: sparse.refined_solve_op(**kw, chunk=None))[0] for _ in range(3)]
    emit('slice_chunks', warm_solve_s={c: v['seconds'] for c, v in sweep.items()}, host_loop_s=statistics.median(host),
         detail=sweep)
    # one iteration after the loop's stop (flag clear), ten a graph: with
    # the multigrid kernels reading the flag, and without
    frozen = {}
    b32 = torch.as_tensor(res, dtype=torch.float32, device=kw['op'][0].device)
    for predicate in (True, False):
        loop = sparse._CGLoop(kw['precon'], kw['mv_kind'], kw['op'], kw['minv'], b32, predicate=predicate)
        cg.reset(loop.st, 0.0, 1 << 30)
        loop.start()
        loop.iteration()
        cg.active_flag(loop.st).fill_(0)
        frozen['predicated' if predicate else 'not predicated'] = time_ms(loop.iteration)[0]
        del loop
    live = sparse._CGLoop(kw['precon'], kw['mv_kind'], kw['op'], kw['minv'], b32)
    cg.reset(live.st, 0.0, 1 << 30)
    live.start()
    head = live.st.clone()
    frozen['live'] = time_ms(live.iteration, setup=lambda: live.st.copy_(head))[0]
    emit('slice_frozen_iteration', device_ms=frozen)
    del live


def phase_parity(devices=('cuda', 'cpu')):
    '''The 65^2-dof slice in float64 on the card (kernels) and the CPU
    (plain versions).'''
    import numpy
    from nutils_tpu_torch.utils import config
    xs = {}
    for device in devices:
        with config.device(device):
            system = build_laplace(64, numpy.float64, reaction=True)
            jac, res = system.assemble_jacobian_residual({'u': numpy.zeros(system.trial_shapes[0][0])})
            xs[device] = jac.solve(res, solver='cg', rtol=1e-10), dict(jac._solve_stats)
    (xa, sa), (xb, sb) = (xs[d] for d in devices)
    rel = float(numpy.linalg.norm(xa - xb) / numpy.linalg.norm(xb))
    emit('parity', ndofs=65 * 65, rel_x=rel, tol=1e-8, devices=list(devices), stats=[sa, sb])
    if not rel <= 1e-8:
        raise AssertionError(f'card and CPU solutions differ: {rel:.3e}')


def _sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def profiled(fn):
    """(wall s, device kernels, the tracer's "Command Buffer Full" marks,
    fn's result) of one synchronised call under torch.profiler; the
    kernels are device events only (a CPU operator's device time repeats
    its kernels'), and the marks tell when the launch queue was full."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, out = _sync_time(fn)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key != 'Command Buffer Full']
    return wall, kernels, [e for e in events if e.key == 'Command Buffer Full'], out


def busy_s(kernels):
    return sum(e.self_device_time_total for e in kernels) / 1e6


def check_driver(path, stats):
    """Raise unless a device Krylov solve's record says its loop replayed
    CUDA graphs, was accepted on the device and read the device no more
    than once a chunk, a GMRES cycle end, a CG refresh and a refinement
    round."""
    limit = sum(stats.get(key, 0) for key in ('chunks', 'cycles', 'refreshes', 'rounds'))
    if stats.get('driver') != 'graph' or not stats.get('accepted_on_device') or not stats['host_reads'] <= limit:
        raise AssertionError(f'{path}: the solve ran {stats.get("driver")}, accepted on the device '
                             f'{stats.get("accepted_on_device")}, {stats.get("host_reads")} host reads for {limit}')


def phase_ns(nelems=330, device='cuda'):
    """The second main path: the Taylor-Hood Navier-Stokes Newton step at
    983,403 dofs through the kernels; returns (launch counts, the step's
    system, jacobian, residual and arguments)."""
    import numpy
    import torch
    from nutils_tpu_torch.utils import config
    with config.device(device):
        t_system, (system, args) = _sync_time(lambda: build_ns(nelems, numpy.float32))
        ndofs = sum(int(numpy.prod(s)) for s in system.trial_shapes)
        emit('ns_system', ndofs=ndofs, t_system=t_system)
        check_routes('ns', system)
        # host planning: the CSR pattern sort, block-grid detection and the
        # slice plans of every value segment
        t_pattern, (_meta, pattern, jplan) = _sync_time(lambda: system._jac_layout)
        fn = system._compiled('jacres')
        clean = system._clean(args)
        times = [_sync_time(lambda: fn(clean))[0] for _ in range(3)]
        nweights = int(sum(jplan['sizes']))
        emit('ns_assembly', form=jplan['form'], nnz=int(pattern.nnz), nweights=nweights, total=int(jplan['total']),
             seg_kinds=[seg[0] for seg in jplan['segs']], t_pattern=t_pattern, t_assemble_first=times[0],
             t_assemble=min(times[1:]), t_assemble_generic=generic_route_time(system, clean))
        del times
        torch.cuda.empty_cache()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t_jacres, (jac, res) = _sync_time(lambda: system.assemble_jacobian_residual(args))
        t_precon, _minv = _sync_time(lambda: jac._device_precon(None, None))
        # K5's plan (host, once per pattern) and the compact operand (one
        # gather per matrix)
        t_k5_plan, _plan = _sync_time(jac._k5_plan)
        t_pack, _op = _sync_time(jac._device_op)
        t_solve, dx = _sync_time(lambda: jac.solve_leniently(res, solver='gmres', rtol=1e-3))
        stats = dict(jac._solve_stats)
        t_solve_again, _dx = _sync_time(lambda: jac.solve_leniently(res, solver='gmres', rtol=1e-3))
        warm_stats = dict(jac._solve_stats)
        fused = system.fused_step_op(solver='gmres', rtol=1e-3)
        t_step_fused_first, _out = _sync_time(lambda: fused(clean))
        t_step_fused, (dxf, rnf, itf) = _sync_time(lambda: fused(clean))
        launches = read_launches(NS_KERNELS)
        peak = torch.cuda.max_memory_allocated()
    dxf = dxf.cpu().numpy()
    norm_res = float(numpy.linalg.norm(res))
    t_host_matvec, jdx = _sync_time(lambda: jac @ dx)
    rel_residual = float(numpy.linalg.norm(res - jdx)) / norm_res
    rel_residual_fused = float(numpy.linalg.norm(res - jac @ dxf)) / norm_res
    emit('ns', ndofs=ndofs, t_system=t_system, t_pattern=t_pattern, t_jacres=t_jacres, t_precon=t_precon,
         t_k5_plan=t_k5_plan, t_pack=t_pack, t_solve=t_solve, t_solve_again=t_solve_again,
         t_step_fused_first=t_step_fused_first, t_step_fused=t_step_fused, iters_fused=int(itf), resnorm_fused=rnf, solve_stats=stats,
         warm_solve_stats=warm_stats, rel_residual=rel_residual, rel_residual_fused=rel_residual_fused, t_host_matvec=t_host_matvec,
         peak_device_bytes=peak, launches=launches)
    if dx.shape != (ndofs,) or not numpy.isfinite(dx).all() or not numpy.isfinite(dxf).all():
        raise AssertionError('Navier-Stokes step: the solution is not a finite vector of the dof count')
    want = {'method': 'gmres', 'op_form': 'blockgrid', 'precon': 'diag', 'accepted_on_device': True}
    if any(stats[k] != v for k, v in want.items()):
        raise AssertionError(f'Navier-Stokes step solved through {stats}, expected {want}')
    check_driver('ns', stats)
    check_driver('ns warm', warm_stats)
    if warm_stats['iters'] != stats['iters']:
        raise AssertionError(f'Navier-Stokes step: {stats["iters"]} and {warm_stats["iters"]} GMRES iterations')
    if not (rel_residual <= 1e-3 and rel_residual_fused <= 1e-3):
        raise AssertionError(f'Navier-Stokes step misses rtol 1e-3: {rel_residual:.3e}, fused {rel_residual_fused:.3e}')
    missing = [name for name, count in launches.items() if count <= 0]
    if missing:
        raise AssertionError(f'kernels not launched on the Navier-Stokes path: {missing}')
    return launches, system, jac, res, clean, dict(t_k5_plan=t_k5_plan, t_pack=t_pack)


def schur_row(label, w, cmap, indices, indptr, n):
    """K7 (``schur_diag_inverse_device``) on the values ``w`` (through the
    map ``cmap``, or the CSR values themselves where it is None) against
    its plain version: the error, two launches the same bits, the sha1 of
    minv (to compare with another package's at the same inputs), the time,
    the bound (each input read once) and the floor of a two-pass design
    (the nonzeros read twice, the mapped values gathered once into a
    scratch and read back).  Returns the row."""
    import torch
    from nutils_tpu_torch.ops import sparse
    dname, isz = str(w.dtype).split('.')[1], w.element_size()
    nnz = int(indices.shape[0])
    got = sparse.schur_diag_inverse_device(w, cmap, indices, indptr, n).clone()
    again = sparse.schur_diag_inverse_device(w, cmap, indices, indptr, n)
    want = sparse.schur_diag_plain(w, cmap, indices, indptr, n)
    torch.cuda.synchronize()
    repeat = digest(got) == digest(again)
    err, relerr = _compare(got, want)
    (ms, call_ms), (plain_ms, _pc) = time_ms(lambda: sparse.schur_diag_inverse_device(w, cmap, indices, indptr, n)), \
        time_ms(lambda: sparse.schur_diag_plain(w, cmap, indices, indptr, n))
    # each input read once: the value (gathered), the map entry and the
    # column a nonzero, the row pointers; minv written once.  Two passes:
    # (map, value, column, the scratch written) then (scratch, column), or
    # (value, column) twice; the row pointers read and d, dsafe, strong
    # written and read back once a pass
    per_nnz = (isz + 4) if cmap is None else (isz + 8)
    two_pass = (2 * (isz + 4) if cmap is None else 3 * isz + 12) * nnz + 2 * (n + 1) * 4 + 2 * n * (2 * isz + 1)
    fields = dict(row(err, ms, plain_ms, nnz * per_nnz + (n + 1) * 4 + n * isz, 6 * nnz),
                  two_pass_floor_ms=two_pass / HBM_BYTES_PER_S * 1e3 + n * isz / HBM_BYTES_PER_S * 1e3,
                  sha1=digest(got))
    check_row('schur_diag_inverse_device', label, dname, relerr,
              dict(fields, n=n, nnz=nnz, call_ms=call_ms, bitwise_repeat=repeat))
    if not repeat:
        raise AssertionError(f'K7 ({label}, {dname}) differs between two launches')
    return fields


K6_RESTART = 100  # the restart of the port's GMRES solves (Matrix.solve)


def _dt(dtype):
    import numpy
    import torch
    return numpy.float32 if dtype == torch.float32 else numpy.float64


def k6_state(n, j, dtype, dev, seed=11):
    """A K6 state at step ``j`` of a GMRES(100) cycle: random h1, h2, g,
    rotations and R = I + 0.1 U, rounded to ``dtype``; both flags set, atol
    and inner_tol 0, no iteration cap in reach."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import gmres
    m, dt = K6_RESTART, _dt(dtype)
    rng = numpy.random.default_rng(seed)
    L = gmres.layout(m)
    s = numpy.zeros(L['parts'])
    s[gmres.BETA], s[gmres.RN], s[gmres.HN], s[gmres.RESNORM] = dt(1.3), dt(0.9), dt(0.8), dt(1.0)
    ints = s.view(numpy.int32)
    ints[gmres.J], ints[gmres.INNER], ints[gmres.ACTIVE], ints[gmres.MAXITER] = j, 1, 1, 2 ** 30
    theta = rng.random(m) * 2 * numpy.pi
    for key, values in (('h1', rng.standard_normal(m + 1)), ('h2', 0.01 * rng.standard_normal(m + 1)),
                        ('g', rng.standard_normal(m + 1)), ('cs', numpy.cos(theta)), ('sn', numpy.sin(theta)),
                        ('R', (numpy.eye(m) + 0.1 * numpy.triu(rng.standard_normal((m, m)))).ravel())):
        s[L[key]:L[key] + len(values)] = values.astype(dt)
    st = gmres.new_state(n, m, dtype, dev)
    st[:L['parts']] = torch.as_tensor(s, device=dev)
    return st


def k10_state(n, dtype, dev, seed=13, **kw):
    """A K10 state with random scalars (rounded to ``dtype``), the active
    flag set and the flags and slots of ``kw`` ({name: value})."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import bicgstab as B
    dt = _dt(dtype)
    s = numpy.zeros(B.HEAD)
    s[:B.RNORM + 1] = (numpy.random.default_rng(seed).random(B.RNORM + 1) + 0.5).astype(dt)
    s[B.ATOL] = dt(1e-3)
    ints = s.view(numpy.int32)
    ints[B.ACTIVE], ints[B.K], ints[B.MAXITER] = 1, 5, 2 ** 30
    for name, value in kw.items():
        slot = getattr(B, name.upper())
        if slot > B.RNORM:  # an int32 slot
            ints[slot] = value
        else:
            s[slot] = dt(value)
    st = B.new_state(n, dtype, dev)
    st[:B.HEAD] = torch.as_tensor(s, device=dev)
    return st


def stateful_ms(fn, st, eager=False):
    """Device ms of one call of ``fn``, which changes the state ``st``: each
    call after a copy of ``st`` back from a snapshot, the copy's own time
    subtracted; from a CUDA graph (time_ms) or, with ``eager``, from CUDA
    events around eager calls (time_eager_ms: the plain versions read the
    state on the host)."""
    snap = st.clone()

    def reset():
        st.copy_(snap)

    def both():
        reset()
        fn()
    timer = time_eager_ms if eager else (lambda f: time_ms(f)[0])
    ms = timer(both) - timer(reset)
    reset()
    return ms


def _state_err(got, want, regions, scales=None):
    """(max abs error, max error over each region's scale) of two states'
    float regions ({name: (start, stop)}); each region's scale is its
    largest plain magnitude unless ``scales`` names one."""
    errs = []
    for name, (lo, hi) in regions.items():
        scale = (scales or {}).get(name)
        errs.append(_compare(got[lo:hi], want[lo:hi], scale) if hi > lo else (0.0, 0.0))
    return max(e[0] for e in errs), max(e[1] for e in errs)


def k6_rows(n, dev, label, dtype=None, js=(0, 50, 99)):
    """K6 on GMRES(100) vectors of length ``n`` (float32 unless given) at
    steps ``js``: each entry against its plain version on the same state
    (vectors on their largest value, the projections on the scale of their
    terms, the other state on each region's largest value, the loop's
    decisions equal), its device time (the state restored before each call
    where the entry changes it), the plain version's (eager: it reads the
    state on the host), the bound and the library call where one computes
    the same function; returns {name: row} at j = 50 (the cycle's entries
    at j = 0)."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import gmres
    dtype = dtype or torch.float32
    dname, isz, m = str(dtype).split('.')[1], (4 if dtype == torch.float32 else 8), K6_RESTART
    peak = F32_FLOPS if dtype == torch.float32 else F64_FLOPS
    rng = numpy.random.default_rng(21)
    V = gmres.basis(n, m, dtype, dev)
    V.copy_(torch.as_tensor(rng.standard_normal((m + 1, n)) / n ** 0.5, dtype=dtype, device=dev))
    vec = {k: torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev) for k in ('w', 'src', 'x', 'b', 'y', 'r')}
    vec['vcur'] = torch.zeros(n, dtype=dtype, device=dev)
    L = gmres.layout(m)
    regions = {'head': (0, gmres.RR + 1), 'g': (L['g'], L['cs']), 'cs': (L['cs'], L['sn']), 'sn': (L['sn'], L['y']),
               'y': (L['y'], L['R']), 'R': (L['R'], L['parts'])}
    ints = (gmres.J, gmres.IT, gmres.STALL, gmres.INNER, gmres.ACTIVE, gmres.CYCLES)
    entries = {  # name: (call on (functions, vectors, V, state), stateful, bytes, operations, library call)
        'gmres_project': (lambda f, v, W, st, j: f[0](W, v['w'], st, True), False,
                          lambda j: (j + 2) * n * isz, lambda j: 2 * (j + 1) * n,
                          lambda j, v, W, st: torch.mv(W[:j + 1], v['w'])),
        'gmres_update': (lambda f, v, W, st, j: f[1](W, v['w'], v['w'], st, True), True,
                         lambda j: (j + 3) * n * isz, lambda j: 2 * (j + 1) * n + 3 * n,
                         lambda j, v, W, st: torch.addmv(v['w'], W[:j + 1].T, st[L['h2']:L['h2'] + j + 1].to(dtype),
                                                         alpha=-1)),
        'gmres_normalize': (lambda f, v, W, st, j: f[2](v['w'], W, v['vcur'], st), False,
                            lambda j: 3 * n * isz, lambda j: n, None),
        'gmres_start': (lambda f, v, W, st, j: f[3](v['w'], v['r'], st, m), True,
                        lambda j: 2 * n * isz, lambda j: 4 * n, None),
        'gmres_residual': (lambda f, v, W, st, j: f[4](v['b'], v['y'], v['r'], st, m, True), True,
                           lambda j: 3 * n * isz, lambda j: 3 * n, None),
        'gmres_solve_combine': (lambda f, v, W, st, j: f[5](W, v['x'], st), False,
                                lambda j: (j + 2) * n * isz, lambda j: 2 * j * n + j * j,
                                lambda j, v, W, st: torch.addmv(v['x'], W[:j].T, st[L['y']:L['y'] + j].to(dtype))),
    }
    kernels = (gmres.gmres_project, gmres.gmres_update, gmres.gmres_normalize, gmres.gmres_start, gmres.gmres_residual,
               gmres.gmres_solve_combine)
    plains = (gmres.project_plain, gmres.update_plain, gmres.normalize_plain, gmres.start_plain, gmres.residual_plain,
              gmres.solve_combine_plain)
    results = {}
    for j in js:
        for name, (call, stateful, nbytes, flops, lib) in entries.items():
            if j and name in ('gmres_normalize', 'gmres_start', 'gmres_residual'):
                continue
            runs = []
            for f in (kernels, plains):
                v = {k: t.clone() for k, t in vec.items()}
                W = gmres.basis(n, m, dtype, dev)
                W.copy_(V)
                st = k6_state(n, j, dtype, dev)
                call(f, v, W, st, j)
                torch.cuda.synchronize()
                runs.append((v, W, st))
            (vk, Wk, sk), (vp, Wp, sp) = runs
            errs = [_compare(vk[k], vp[k]) for k in vec] + [_compare(Wk, Wp)]
            if name == 'gmres_project':
                errs.append(_compare(sk[L['h2']:L['h2'] + j + 1], sp[L['h2']:L['h2'] + j + 1],
                                     (V[:j + 1].abs() @ vec['w'].abs()).max()))
            errs.append(_state_err(sk, sp, regions))
            err, relerr = max(e[0] for e in errs), max(e[1] for e in errs)
            same = [int(sk.view(torch.int32)[i]) == int(sp.view(torch.int32)[i]) for i in ints]
            v, W, st = vec, V, k6_state(n, j, dtype, dev)
            if stateful:
                ms = stateful_ms(lambda: call(kernels, v, W, st, j), st)
                plain_ms = stateful_ms(lambda: call(plains, v, W, st, j), st, eager=True)
            else:
                ms = time_ms(lambda: call(kernels, v, W, st, j))[0]
                plain_ms = time_eager_ms(lambda: call(plains, v, W, st, j))
            lib_ms = time_ms(lambda: lib(j, v, W, st))[0] if lib is not None else None
            fields = row(err, ms, plain_ms, nbytes(j), flops(j), lib_ms, peak)
            check_row(name, f'{label} j={j}', dname, relerr, dict(fields, n=n, j=j, restart=m, decisions_equal=all(same)))
            if not all(same):
                raise AssertionError(f'{name} ({label}, j={j}) decides otherwise than its plain version')
            if j == 50 or (j == js[0] and name in ('gmres_normalize', 'gmres_start', 'gmres_residual')):
                results[name] = fields
    return results


def k10_rows(n, dev, label, dtype):
    """K10 on BiCGStab vectors of length ``n``: each entry against its plain
    version on the same state (vectors on their largest value, sums on the
    scale of their terms, the decisions equal), timed as :func:`k6_rows`
    times K6; the refresh with its flag set.  Returns {name: row}."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import bicgstab as B
    dname, isz = str(dtype).split('.')[1], (4 if dtype == torch.float32 else 8)
    peak = F32_FLOPS if dtype == torch.float32 else F64_FLOPS
    rng = numpy.random.default_rng(22)
    vec = {k: torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
           for k in ('x', 'r', 'phat', 'shat', 's', 't', 'rhat', 'v', 'p', 'b', 'y')}
    sums = {B.RV: ('rhat', 'v'), B.TT: ('t', 't'), B.TS: ('t', 's'), B.RR: ('r', 'r'), B.RHOR: ('rhat', 'r')}
    ints = (B.K, B.ACTIVE, B.NEED, B.STALL, B.CLAIMED, B.BREAKDOWN, B.REFRESHES, B.REFUTED, B.BREAKDOWNS)
    entries = {  # name: (call, state, stateful, vectors moved, operations a value, library call)
        'bicg_dots': (lambda f, v, st: f[0](v['rhat'], v['v'], None, st, B.RV), {}, False, 2, 2,
                      lambda v, st: torch.dot(v['rhat'], v['v'])),
        'bicg_dots/two': (lambda f, v, st: f[0](v['t'], v['t'], v['s'], st, B.TT, B.TS), {}, False, 2, 4, None),
        'bicg_s': (lambda f, v, st: f[1](v['r'], v['v'], st, v['s']), {}, False, 3, 2,
                   lambda v, st: torch.addcmul(v['r'], st[B.ALPHA].to(dtype), v['v'], value=-1)),
        'bicg_xr': (lambda f, v, st: f[2](v['x'], v['r'], v['phat'], v['shat'], v['s'], v['t'], v['rhat'], st), {},
                    False, 8, 10, None),
        'bicg_refresh': (lambda f, v, st: f[3](v['b'], v['y'], v['r'], v['rhat'], st), {'need': 1}, True, 4, 5, None),
        'bicg_p': (lambda f, v, st: f[4](v['p'], v['r'], v['v'], v['rhat'], st), {}, False, 4, 4, None),
        'bicg_p/breakdown': (lambda f, v, st: f[4](v['p'], v['r'], v['v'], v['rhat'], st), {'breakdown': 1}, False, 4,
                             0, None),
    }
    kernels = (B.bicg_dots, B.bicg_s, B.bicg_xr, B.bicg_refresh, B.bicg_p)
    plains = (B.dots_plain, B.s_plain, B.xr_plain, B.refresh_plain, B.p_plain)
    results = {}
    for name, (call, kw, stateful, nvec, flops, lib) in entries.items():
        runs = []
        for f in (kernels, plains):
            v = {k: t.clone() for k, t in vec.items()}
            st = k10_state(n, dtype, dev, **kw)
            call(f, v, st)
            torch.cuda.synchronize()
            runs.append((v, st))
        (vk, sk), (vp, sp) = runs
        errs = [_compare(vk[k], vp[k]) for k in vec]
        for slot, (a, b) in sums.items():
            errs.append(_compare(sk[slot:slot + 1], sp[slot:slot + 1], (vp[a] * vp[b]).abs().sum()))
        others = [i for i in range(B.RNORM + 1) if i not in sums]
        errs.append(_compare(sk[others], sp[others]))
        err, relerr = max(e[0] for e in errs), max(e[1] for e in errs)
        same = all(int(sk.view(torch.int32)[i]) == int(sp.view(torch.int32)[i]) for i in ints)
        v, st = vec, k10_state(n, dtype, dev, **kw)
        if stateful:
            ms = stateful_ms(lambda: call(kernels, v, st), st)
            plain_ms = stateful_ms(lambda: call(plains, v, st), st, eager=True)
        else:
            ms = time_ms(lambda: call(kernels, v, st))[0]
            plain_ms = time_eager_ms(lambda: call(plains, v, st))
        lib_ms = time_ms(lambda: lib(v, st))[0] if lib is not None else None
        fields = row(err, ms, plain_ms, nvec * n * isz, flops * n, lib_ms, peak)
        check_row(name, label, dname, relerr, dict(fields, n=n, decisions_equal=same))
        if not same:
            raise AssertionError(f'{name} ({label}, {dname}) decides otherwise than its plain version')
        if '/' not in name:
            results[name] = fields
    return results


def phase_ns_kernels(jac, k5_setup):
    """K5-K7 against their plain versions at the Navier-Stokes step's shapes
    (its block-grid operator and K5's plan, whose host and pack times
    ``k5_setup`` holds, its CSR tables, GMRES vectors of its length);
    returns {name: row} in float32."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import blockgrid
    rng = numpy.random.default_rng(1)
    results = {}
    (_kind, plan), _op = jac._device_op()
    meta, woff = plan.meta, plan.woff
    w32 = jac._weights()
    dev = w32.device
    n = plan.n
    _w, cmap, indices, indptr = jac._csr_tables()
    nnz = int(indices.shape[0])
    # K5 reads exactly the operator's values: one per nonzero, no fallback
    classes = plan.classes_per_block()
    emit('ns_k5_plan', nnz=nnz, values=plan.nv, slot_weights=plan.total, classes=len(plan.ctab),
         classes_per_block=classes, checked_classes=int(plan.ctab[:, 5].sum()), tiles=len(plan.tiles),
         fallback=list(plan.fallback), **k5_setup)
    if plan.nv != nnz or plan.fallback:
        raise AssertionError(f'K5 reads {plan.nv} compact values for {nnz} nonzeros (fallback {plan.fallback})')
    # the same products as one cuSPARSE CSR matvec
    A = torch.sparse_csr_tensor(indptr, indices, jac._device_data(), size=(n, n))
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split('.')[1]
        isz = 4 if dtype == torch.float32 else 8
        w = w32.to(dtype)
        v = blockgrid.pack(w, plan)
        x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        got = blockgrid.blockgrid_matvec(v, x, plan)
        want, literal = blockgrid.compact_matvec_plain(v, x, plan), blockgrid.matvec_plain(w, x, meta, woff)
        torch.cuda.synchronize()
        err, relerr = _compare(got, want)
        _lerr, literal_relerr = _compare(got, literal)
        (ms, call_ms), (plain_ms, _pc) = time_ms(lambda: blockgrid.blockgrid_matvec(v, x, plan)), \
            time_ms(lambda: blockgrid.compact_matvec_plain(v, x, plan))
        literal_ms = time_ms(lambda: blockgrid.matvec_plain(w, x, meta, woff))[0]
        # K5 eagerly too (the host's launch overhead in it)
        eager_ms = time_eager_ms(lambda: blockgrid.blockgrid_matvec(v, x, plan))
        Ad = A if dtype == torch.float32 else A.to(dtype)
        lib = time_ms(lambda: torch.mv(Ad, x))[0]  # cuSPARSE, from a CUDA graph as the kernel
        lib_call_ms = _events(lambda: torch.mv(Ad, x), 7)
        pack_ms = time_ms(lambda: blockgrid.pack(w, plan))[0]
        del Ad
        # the bound: each value, x and y once; the kernel also reads the row
        # list and its small tables
        tables = sum(t.numel() for key, t in plan.tables(dev).items() if key != 'index') * 4
        fields = row(err, ms, plain_ms, (nnz + 2 * n) * isz, 2 * nnz, lib)
        check_row('blockgrid_matvec', 'ns', dname, max(relerr, literal_relerr),
                  dict(fields, n=n, nnz=nnz, values=plan.nv, slot_weights=plan.total, classes_per_block=classes,
                       kernel_bytes=(plan.nv + 2 * n) * isz + tables, call_ms=call_ms, eager_ms=eager_ms,
                       library_call_ms=lib_call_ms, literal_plain_ms=literal_ms, rel_err_compact_plain=relerr,
                       rel_err_literal_plain=literal_relerr, pack_ms=pack_ms))
        if dtype == torch.float32:
            results['blockgrid_matvec'] = fields
        fields = schur_row('ns', w, cmap, indices, indptr, n)
        if dtype == torch.float32:
            results['schur_diag_inverse_device'] = fields
    # K6 on GMRES(100) vectors of the step's length, float32
    results.update(k6_rows(n, dev, 'ns'))
    return results


def phase_ns_profile(system, jac, res, clean, methods=('gmres',), phase='ns_profile'):
    """torch.profiler over one warm assembly and one warm solve of the step
    with each of ``methods`` (the slice: the assembly alone): device busy
    time against wall time, its share, kernel launches (the assembly's K11
    and K12 among them), and the top device operations."""
    fn = system._compiled('jacres')
    fn(clean)  # warm
    runs = [('assemble', lambda: fn(clean))]
    runs += [(f'solve {method}', lambda method=method: jac.solve_leniently(res, solver=method, rtol=1e-3))
             for method in methods]
    for label, run in runs:
        wall, kernels, full, _out = profiled(run)
        busy = busy_s(kernels)
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
        emit(phase, run=label, wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
             kernel_launches=sum(e.count for e in kernels), command_buffer_full=sum(e.count for e in full),
             contraction_launches={e.key[:40]: e.count for e in kernels if 'ntt_asm' in e.key},
             top=[{'name': e.key[:80], 'device_ms': e.self_device_time_total / 1e3, 'count': e.count} for e in top])


def check_pattern(path, system):
    """The backend that sorted the path's CSR pattern (``SparsePattern.
    backend``; a stencil-form path that never needed its pattern sorts it
    here, timed): raises unless it is the native sort."""
    _meta, lazy, _plan = system._jac_layout
    built = lazy._pat is not None
    t_sort, pattern = _sync_time(lazy.get)
    emit('pattern_backend', path=path, backend=pattern.backend, entries=int(len(pattern.slot)),
         nnz=int(pattern.nnz), sorted_by_path=built, t_sort=None if built else t_sort)
    if pattern.backend != 'native':
        raise AssertionError(f'{path}: the CSR pattern was sorted by {pattern.backend}, expected the native sort')


def check_routes(path, system):
    '''Every assembly chunk of the path's System takes the factored route.'''
    routes = {f'{test}:{ci}': route for (test, ci), route in system._assembly_routes.items()}
    emit('assembly_routes', path=path, routes=routes)
    if set(routes.values()) != {'factored'}:
        raise AssertionError(f'{path}: assembly chunks off the factored route: {routes}')


def generic_route_time(system, clean):
    '''Warm ``t_assemble`` of the same System with every chunk on the
    generic ``vmap(jvp)`` route over the dof seeds (the assembly before the
    factored route), in the same call: the better of two calls after one
    warm-up.'''
    fn = system._compiled('jacres')
    with system._generic_route():
        times = [_sync_time(lambda: fn(clean))[0] for _ in range(3)]
    return min(times[1:])


def assembly_operands(system, clean):
    '''[(block label, Bt, K, Bs, g)]: the operands the factored assembly
    hands K11 (Bt, K, Bs) and K12 (Bt, g) for every (test, trial)
    localization pair of the System, at its arguments ``clean``.'''
    args = system._device_args(clean)
    leaves = system._bound_leaves(args, {}, system._tables())
    terms = {}
    out = []
    for bi, ci, u, li, _reduce, _size in system._jac_layout[0]:
        c = system._blocks[bi][ci]
        f = c.factored
        if id(f) not in terms:
            t_point_terms, _terms = _sync_time(lambda: system._point_terms(c, args, leaves, terms))
            emit('assembly_point_terms', t_point_terms=t_point_terms, nseeds=f.nseeds,
                 features={str(key): f.layout[key][0].stop - f.layout[key][0].start for key in f.layout})
        g, K = system._point_terms(c, args, leaves, terms)
        key = system._trial_locs[u][li].leaf.key
        tsl = f.layout[c.key][0]
        out.append((system.tests[bi] + u, f.operator(c.key, args, leaves),
                    K[f.layout[key][0]][..., tsl].permute(1, 2, 3, 0), f.operator(key, args, leaves), g[..., tsl]))
    return out


def _distinct_numel(*tensors):
    '''Entries of ``tensors``, each distinct operand once: an energy form's
    trial operator is its test operator (one tensor, read once).'''
    seen = {(t.data_ptr(), t.shape, t.stride()): t.numel() for t in tensors}
    return sum(seen.values())


def k11_plan(Bt, K, Bs):
    """The launch plan K11 takes for these operands (``ops/assembly.
    elem_matrix_plan``), without its copies' strides: the regime, elements
    a group, threads, stages, tiles, shared-memory bytes, whether Bt and Bs
    are staged as one, and each operand's copy width in values.  None for
    a package whose K11 has no host plan (an older checkout, measured with
    this script for a "before")."""
    from nutils_tpu_torch.ops import assembly
    if not hasattr(assembly, 'elem_matrix_plan'):
        return None
    plan = assembly.elem_matrix_plan(Bt, K, Bs)
    keys = ('regime', 'G', 'threads', 'stages', 'ti', 'tj', 'ta', 'tjt', 'smem', 'same', 'shBt', 'shBs')
    return dict({key: plan[key] for key in keys}, copy_vec={name: c['vec'] for name, c in plan['copies'].items()})


def k12_plan(Bt, g):
    """The launch plan K12 takes for these operands (``ops/assembly.
    elem_vector_plan``), without its copies' strides: the regime, elements a
    group, threads, the register tile, shared-memory bytes, the slices on
    16 bytes and each operand's copy width in values.  Raises where the
    plan refuses the operands (K12's generic kernel: no path may reach it).
    None for a package whose K12 has no host plan (an older checkout,
    measured with this script for a "before")."""
    from nutils_tpu_torch.ops import assembly
    if not hasattr(assembly, 'elem_vector_plan'):
        return None
    plan = assembly.elem_vector_plan(Bt, g)
    if plan['regime'] == 'generic':
        raise AssertionError(f'K12: operands Bt {tuple(Bt.shape)}, g {tuple(g.shape)} take the generic kernel')
    keys = ('regime', 'G', 'threads', 'stages', 'ti', 'te', 'smem', 'shBt', 'align16')
    return dict({key: plan[key] for key in keys}, copy_vec={name: c['vec'] for name, c in plan['copies'].items()})


def phase_assembly_kernels(system, clean, path):
    """K11 and K12 against their plain versions (one ``torch.einsum``) at
    the shapes of every block of the path's assembly, in its precision; the library
    call is the same contraction through one ``torch.einsum`` call.  K11's
    and K12's rows give their launch plans (K12's never the generic kernel)
    and the sha1 of their outputs (to compare with another package's at the
    same inputs).  Returns {name: row} of the largest block."""
    import torch
    from nutils_tpu_torch.ops import assembly
    results = {}
    done_tests = set()
    for label, Bt, K, Bs, g in assembly_operands(system, clean):
        E, Q, A, B = K.shape
        I, J = Bt.shape[-1], Bs.shape[-1]
        isz = K.element_size()
        peak = F32_FLOPS if K.dtype == torch.float32 else F64_FLOPS
        shared = Bt.shape[0] == 1 and Bs.shape[0] == 1
        cases = [('elem_matrix', lambda: assembly.elem_matrix(Bt, K, Bs), lambda: assembly.elem_matrix_plain(Bt, K, Bs),
                  lambda: torch.einsum('eqai,eqab,eqbj->eij', Bt, K, Bs),
                  lambda: assembly.elem_matrix_plain(Bt.abs(), K.abs(), Bs.abs()),
                  (_distinct_numel(Bt, K, Bs) + E * I * J) * isz, 2 * E * Q * A * J * (B + I))]
        if label[0] not in done_tests:  # one residual a test localization
            done_tests.add(label[0])
            cases.append(('elem_vector', lambda: assembly.elem_vector(Bt, g), lambda: assembly.elem_vector_plain(Bt, g),
                          lambda: torch.einsum('eqai,eqa->ei', Bt, g),
                          lambda: assembly.elem_vector_plain(Bt.abs(), g.abs()),
                          (Bt.numel() + g.numel() + E * I) * isz, 2 * E * Q * A * I))
        for name, kernel, plain, library, magnitude, nbytes, flops in cases:
            got, want, scale = kernel(), plain(), magnitude().max()
            again = kernel()
            torch.cuda.synchronize()
            err, relerr = _compare(got, want, scale)
            (ms, call_ms), (plain_ms, _pc) = time_ms(kernel), time_ms(plain)
            fields = row(err, ms, plain_ms, nbytes, flops, time_ms(library)[0], peak)
            extra = dict(plan=k11_plan(Bt, K, Bs) if name == 'elem_matrix' else k12_plan(Bt, g), sha1=digest(got))
            check_row(name, f'{path} {label}', str(K.dtype).split('.')[1], relerr,
                      dict(fields, E=E, Q=Q, A=A, B=B, I=I, J=J, shared_operators=shared,
                           bitwise_repeat=bool(torch.equal(got, again)), call_ms=call_ms, **extra))
            if not torch.equal(got, again):
                raise AssertionError(f'{name} ({path} {label}) differs between two launches')
            if name not in results or flops > results[name][1]:
                results[name] = fields, flops
            del got, want, again
    return {name: fields for name, (fields, _flops) in results.items()}


def phase_ns_parity(devices=('cuda', 'cpu')):
    """The step at 6x6 elements in float64 on the card (kernels) and the CPU
    (plain versions)."""
    import numpy
    from nutils_tpu_torch.utils import config
    out = {}
    for device in devices:
        with config.device(device):
            system, args = build_ns(6, numpy.float64)
            jac, res = system.assemble_jacobian_residual(args)
            out[device] = jac.solve_leniently(res, solver='gmres', rtol=1e-3), dict(jac._solve_stats)
    (xa, sa), (xb, sb) = (out[d] for d in devices)
    rel = float(numpy.linalg.norm(xa - xb) / numpy.linalg.norm(xb))
    emit('ns_parity', ndofs=len(xb), rel_x=rel, tol=1e-8, devices=list(devices), stats=[sa, sb])
    if not (rel <= 1e-8 and sa['iters'] == sb['iters']):
        raise AssertionError(f'card and CPU Navier-Stokes steps differ: {rel:.3e}, iterations {sa["iters"]} '
                             f'and {sb["iters"]}')


TRI_METHODS = ('gmres', 'bicgstab')


def phase_ns_tri(nelems=330, device='cuda'):
    """The third main path: the Navier-Stokes Newton step on an unstructured
    triangle mesh at 983,403 dofs, its jacobian in CSR form, solved with
    refined GMRES and refined BiCGStab through the kernels; returns (launch
    counts, the step's system, jacobian, residual and arguments)."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import sparse
    from nutils_tpu_torch.utils import config
    with config.device(device):
        t_system, (system, args) = _sync_time(lambda: build_ns(nelems, numpy.float32, 'triangle'))
        ndofs = sum(int(numpy.prod(s)) for s in system.trial_shapes)
        emit('ns_tri_system', ndofs=ndofs, nelems=2 * nelems * nelems, t_system=t_system)
        check_routes('ns_tri', system)
        # host planning: the CSR pattern sort and the value scatter's plan
        t_pattern, (_meta, lazy, jplan) = _sync_time(lambda: system._jac_layout)
        t_pattern_sort, pattern = _sync_time(lazy.get)
        if jplan is not None:
            raise AssertionError(f'the triangle step planned a {jplan["form"]} jacobian, expected CSR')
        fn = system._compiled('jacres')
        clean = system._clean(args)
        times = [_sync_time(lambda: fn(clean))[0] for _ in range(3)]
        emit('ns_tri_assembly', form='csr', entries=int(len(pattern.slot)), nnz=int(pattern.nnz),
             max_row_nnz=int(numpy.diff(pattern.indptr).max()), t_pattern=t_pattern + t_pattern_sort,
             t_assemble_first=times[0], t_assemble=min(times[1:]), t_assemble_generic=generic_route_time(system, clean))
        del times
        torch.cuda.empty_cache()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t_jacres, (jac, res) = _sync_time(lambda: system.assemble_jacobian_residual(args))
        t_precon, _minv = _sync_time(lambda: jac._device_precon(None, None))
        # host: the operator's form (stencil and block-grid inference, which
        # this pattern refutes), once per pattern
        t_op_plan, _op = _sync_time(jac._device_op)
        # K9's row-block plan on the operator's row pointers, made inside
        # _device_op with the operator; timed here alone
        indptr = jac._csr_tables()[3]
        t_k9_plan, k9_plan = _sync_time(lambda: sparse.csr_plan(indptr))
        k9_blocks = int(k9_plan.shape[0]) - 1
        solves = {}
        for method in TRI_METHODS:
            t_solve, dx = _sync_time(lambda: jac.solve_leniently(res, solver=method, rtol=1e-3))
            stats = dict(jac._solve_stats)
            t_solve_again, _dx = _sync_time(lambda: jac.solve_leniently(res, solver=method, rtol=1e-3))
            solves[method] = dx, stats, t_solve, t_solve_again, dict(jac._solve_stats)
        launches = read_launches(TRI_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        # the residual's rows with no slice plan sum through K8 in a fixed
        # order: two assemblies are bitwise equal
        before = launches['csr_scatter']
        (jac1, res1), (jac2, res2) = fn(clean), fn(clean)
        residual_k8 = read_launches(('csr_scatter',))['csr_scatter'] - before - 2  # one jacobian scatter each
        bitwise = bool(torch.equal(res1, res2) and torch.equal(jac1, jac2))
        # the bits' digests: equal in two calls where the assembly is
        # reproducible from run to run, not only within one
        digests = {name: hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest() for name, t in (('w', jac1), ('r', res1))}
        del jac1, jac2, res1, res2
    emit('ns_tri_determinism', k8_launches_per_residual=residual_k8 / 2, bitwise_equal=bitwise, sha1=digests)
    if residual_k8 <= 0 or not bitwise:
        raise AssertionError(f'triangle step: residual K8 launches {residual_k8}, bitwise equal {bitwise}')
    norm_res = float(numpy.linalg.norm(res))
    out = {}
    for method, (dx, stats, t_solve, t_solve_again, warm_stats) in solves.items():
        rel_residual = float(numpy.linalg.norm(res - jac @ dx)) / norm_res
        out[method] = dict(t_solve=t_solve, t_solve_again=t_solve_again, solve_stats=stats,
                           warm_solve_stats=warm_stats, rel_residual=rel_residual)
        check_driver(f'ns_tri {method}', stats)
        check_driver(f'ns_tri {method} warm', warm_stats)
        if warm_stats['iters'] != stats['iters']:
            raise AssertionError(f'triangle step ({method}): {stats["iters"]} and {warm_stats["iters"]} iterations')
        if dx.shape != (ndofs,) or not numpy.isfinite(dx).all():
            raise AssertionError(f'triangle step ({method}): the solution is not a finite vector of the dof count')
        want = {'method': method, 'op_form': 'csr', 'precon': 'diag', 'accepted_on_device': True}
        if any(stats[k] != v for k, v in want.items()):
            raise AssertionError(f'triangle step solved through {stats}, expected {want}')
        if not rel_residual <= 1e-3:
            raise AssertionError(f'triangle step ({method}) misses rtol 1e-3: {rel_residual:.3e}')
    emit('ns_tri', ndofs=ndofs, nnz=int(pattern.nnz), t_system=t_system, t_pattern=t_pattern + t_pattern_sort,
         t_jacres=t_jacres, t_precon=t_precon, t_op_plan=t_op_plan, t_k9_plan=t_k9_plan, k9_blocks=k9_blocks,
         k9_cap=sparse.CSR_CAP, solves=out, peak_device_bytes=peak, launches=launches)
    missing = [name for name, count in launches.items() if count <= 0]
    if missing:
        raise AssertionError(f'kernels not launched on the triangle Navier-Stokes path: {missing}')
    return launches, system, jac, res, clean


def phase_ns_tri_kernels(system, jac):
    """K7 on CSR values and K8-K10 against their plain versions at the
    triangle step's shapes (its entry values and CSR operator, BiCGStab
    vectors of its length); returns {name: row} in float32."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import sparse
    rng = numpy.random.default_rng(2)
    results = {}
    pattern = system._jac_layout[1].get()
    data32, _none, indices, indptr = jac._csr_tables()
    dev = data32.device
    n, nnz, m = jac.shape[0], int(indices.shape[0]), len(pattern.slot)
    order, segptr = (torch.as_tensor(a.astype(numpy.int32), device=dev) for a in (pattern._order, pattern._segptr))
    slot = torch.as_tensor(pattern.slot, device=dev)
    A = torch.sparse_csr_tensor(indptr, indices, data32, size=(n, n))
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split('.')[1]
        isz = 4 if dtype == torch.float32 else 8
        # K8 on random entry values; compared on the scale of the slot sums
        # of their magnitudes
        values = torch.as_tensor(rng.standard_normal(m), dtype=dtype, device=dev)
        got, want = sparse.csr_scatter(values, order, segptr, slot), sparse.scatter_plain(values, slot, nnz)
        scale = sparse.scatter_plain(values.abs(), slot, nnz).max()
        torch.cuda.synchronize()
        err, relerr = _compare(got, want, scale)
        (ms, call_ms), (plain_ms, _pc) = time_ms(lambda: sparse.csr_scatter(values, order, segptr, slot)), \
            time_ms(lambda: sparse.scatter_plain(values, slot, nnz))
        lib = time_ms(lambda: torch.zeros(nnz, dtype=dtype, device=dev).index_add_(0, slot, values))[0]
        # the function reads each entry's value and slot and writes the
        # output; the kernel also reads the segment pointers (its traffic)
        fields = row(err, ms, plain_ms, m * (isz + 4) + nnz * isz, m, lib)
        check_row('csr_scatter', 'ns_tri', dname, relerr,
                  dict(fields, entries=m, nnz=nnz, kernel_bytes=m * (isz + 4) + (nnz + 1) * 4 + nnz * isz,
                       call_ms=call_ms))
        if dtype == torch.float32:
            results['csr_scatter'] = fields
        # K9 on the step's operator (float64: the refinement's widened copy),
        # with the plan the operator carries; twice (the same bits), and with
        # the loop's flag at 0 (nothing written)
        data = data32.to(dtype)
        x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        got, want = sparse.csr_matvec(data, indices, indptr, x), sparse.csr_matvec_plain(data, indices, indptr, x)
        again = sparse.csr_matvec(data, indices, indptr, x)
        idle = torch.full_like(got, 7.0)
        sparse.csr_matvec(data, indices, indptr, x, active=torch.zeros(1, dtype=torch.int32, device=dev), out=idle)
        scale = sparse.csr_matvec_plain(data.abs(), indices, indptr, x.abs()).max()
        torch.cuda.synchronize()
        bitwise_repeat, untouched = bool(torch.equal(got, again)), bool((idle == 7.0).all())
        err, relerr = _compare(got, want, scale)
        (ms, call_ms), (plain_ms, _pc) = time_ms(lambda: sparse.csr_matvec(data, indices, indptr, x)), \
            time_ms(lambda: sparse.csr_matvec_plain(data, indices, indptr, x))
        Ad = A if dtype == torch.float32 else A.to(dtype)
        lib = time_ms(lambda: torch.mv(Ad, x))[0]  # cuSPARSE, from a CUDA graph as the kernel
        plan = sparse.csr_plan_of(indptr)
        # the function reads each value and column once, the row pointers, x
        # and writes y; the kernel also reads the plan's row starts
        nbytes = nnz * (isz + 4) + (n + 1) * 4 + 2 * n * isz
        fields = row(err, ms, plain_ms, nbytes, 2 * nnz, lib, F32_FLOPS if dtype == torch.float32 else F64_FLOPS)
        check_row('csr_matvec', 'ns_tri', dname, relerr,
                  dict(fields, n=n, nnz=nnz, call_ms=call_ms, cap=sparse.CSR_CAP, blocks=int(plan.shape[0]) - 1, kernel_bytes=nbytes + plan.numel() * 4,
                       bitwise_repeat=bitwise_repeat, flag_zero_untouched=untouched))
        if not (bitwise_repeat and untouched):
            raise AssertionError(f'K9 ({dname}): same bits twice {bitwise_repeat}, nothing written at flag 0 '
                                 f'{untouched}')
        if dtype == torch.float32:
            results['csr_matvec'] = fields
        del Ad, again, idle
        # K7 with no map: the values are the CSR data
        fields = schur_row('ns_tri csr', data, None, indices, indptr, n)
        if dtype == torch.float32:
            results['schur_diag_inverse_device[csr]'] = fields
        del data, values
        # K10 on BiCGStab vectors of the step's length
        rows = k10_rows(n, dev, 'ns_tri', dtype)
        if dtype == torch.float32:
            results.update(rows)
    return results


def phase_k9_rows(device='cuda'):
    """K9 against its plain version on a matrix of rows of 0, 1, 3, 59, and
    more than ``CSR_CAP`` nonzeros (blocks of one long row, in both of the
    kernel's modes), whose rows start at every offset modulo its 16-byte
    loads; the same bits twice."""
    import _torch_parity as tp
    import numpy
    import torch
    from nutils_tpu_torch.ops import sparse
    cap = sparse.CSR_CAP
    lens = [0, 1, 3, 59, 0, 2 * cap + 5, 1, 59, cap // 2 + 1, 0, 3] * 40 + [cap, 7, 59, 1]
    data_np, indices_np, indptr_np = tp.csr_of_rows(lens, 12)
    n = len(indptr_np) - 1
    indices, indptr = (torch.as_tensor(a, device=device) for a in (indices_np, indptr_np))
    x_np = numpy.random.default_rng(13).standard_normal(n)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split('.')[1]
        data, x = (torch.as_tensor(a, dtype=dtype, device=device) for a in (data_np, x_np))
        got, want = sparse.csr_matvec(data, indices, indptr, x), sparse.csr_matvec_plain(data, indices, indptr, x)
        again = sparse.csr_matvec(data, indices, indptr, x)
        scale = sparse.csr_matvec_plain(data.abs(), indices, indptr, x.abs()).max()
        torch.cuda.synchronize()
        _err, relerr = _compare(got, want, scale)
        emit('k9_rows', dtype=dname, n=n, nnz=int(indptr_np[-1]), cap=cap,
             blocks=int(sparse.csr_plan_of(indptr).shape[0]) - 1, max_rel_err=relerr, tol=TOL[dname],
             bitwise_repeat=bool(torch.equal(got, again)))
        if not (relerr <= TOL[dname] and torch.equal(got, again)):
            raise AssertionError(f'K9 ({dname}) on rows of 0 to {max(lens)} nonzeros: {relerr:.3e}, same bits '
                                 f'{bool(torch.equal(got, again))}')


def phase_ns_tri_parity(devices=('cuda', 'cpu')):
    """The triangle step at 6x6 elements in float64 on the card (kernels)
    and the CPU (plain versions), with both methods."""
    import numpy
    from nutils_tpu_torch.utils import config
    out = {}
    for device in devices:
        with config.device(device):
            system, args = build_ns(6, numpy.float64, 'triangle')
            jac, res = system.assemble_jacobian_residual(args)
            for method in TRI_METHODS:
                out[device, method] = (jac.solve_leniently(res, solver=method, rtol=1e-3),
                                       dict(jac._solve_stats))
    for method in TRI_METHODS:
        (xa, sa), (xb, sb) = (out[d, method] for d in devices)
        rel = float(numpy.linalg.norm(xa - xb) / numpy.linalg.norm(xb))
        emit('ns_tri_parity', method=method, ndofs=len(xb), rel_x=rel, tol=1e-8, devices=list(devices),
             stats=[sa, sb])
        if not (rel <= 1e-8 and sa['iters'] == sb['iters'] and sa['op_form'] == 'csr'):
            raise AssertionError(f'card and CPU triangle steps ({method}) differ: {rel:.3e}, iterations '
                                 f'{sa["iters"]} and {sb["iters"]}')


def laplace_l2_error(domain, ns, args):
    """The L2 error of examples/laplace.py's ``main`` (degree 1)."""
    return domain.integral('(u - sin(x_0) cosh(x_1))^2 dV' @ ns, degree=2).eval(args) ** .5


def _peak():
    import torch
    return torch.cuda.max_memory_allocated()


def phase_laplace_example(nelems=2048):
    """examples/laplace.py's solve path at ``nelems``^2 elements in float64
    through the port's entry points: ``solve_constraints`` on the boundary
    functional, then ``System.solve(constrain=cons)`` (Direct: the element-
    chunked assembly, the masked stencil operator, multigrid GMRES), timed
    part by part first and then as the user calls it, and the example's L2
    error.  Returns (launch counts of the solve, the System, its clean
    arguments, w and r of a warm assembly)."""
    import _torch_parity as tp
    import numpy
    import torch
    from nutils_tpu_torch.solver import System
    from nutils_tpu_torch.utils import config
    config.floatx.value = numpy.float64  # the package's default, which the example uses
    with config.device('cuda'):
        t_forms, (domain, ns, res, sqr) = _sync_time(lambda: tp.laplace_example_forms('nutils_tpu_torch', nelems))
        t_system, (scons, system) = _sync_time(lambda: (System(sqr, trial='u'), System(res, trial='u', test='v')))
        ndofs = system.trial_shapes[0][0]
        nelem = nelems * nelems
        emit('laplace_example_system', nelems=nelem, ndofs=ndofs, t_forms=t_forms, t_system=t_system,
             assembly_chunk=config.assembly_chunk.value)
        check_routes('laplace_example', system)
        # solve_constraints: a masked solve on the boundary functional's
        # jacobian, which the System keeps (a constant matrix)
        reset_launches()
        t_cons, cons = _sync_time(lambda: scons.solve_constraints(droptol=1e-15))
        cons_launches = {name: count for name, count in read_launches(wrappers()).items() if count}
        constrained = int(numpy.isfinite(cons['u']).sum())
        emit('laplace_example_cons', t_cons=t_cons, constrained=constrained,
             solve_stats=scons._cache['jacmat']._solve_stats, launches=cons_launches)
        if constrained != 2 * (nelems + 1) - 1:
            raise AssertionError(f'solve_constraints constrained {constrained} dofs, expected {2 * (nelems + 1) - 1}')
        # System.solve(constrain=cons) part by part: Direct's assembly, the
        # masked operator and its form, the multigrid set-up, the solve
        arguments, x = system.deconstruct({}, cons)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t_assemble_first, (jac, r) = _sync_time(lambda: system.assemble_jacobian_residual(arguments, x))
        peak_first = _peak()
        plan = system._chunk_plan()
        clean = system._clean(system.construct(arguments, x))
        fn = system._compiled('jacres')
        warm = [_sync_time(lambda: fn(clean)) for _ in range(2)]
        t_assemble, (w0, r0) = min(t for t, _out in warm), warm[-1][1]
        del warm
        emit('laplace_example_assembly', chunks=plan and plan['nc'], chunk_elements=plan and plan['ce'],
             t_assemble_first=t_assemble_first, t_assemble=t_assemble, peak_first_bytes=peak_first)
        if plan is None or plan['nc'] != 2:
            raise AssertionError(f'the example at {nelem} elements assembled in {plan and plan["nc"]} chunks, not 2')
        parent, isfree = jac._parent, jac._mask
        t_mask, masked = _sync_time(lambda: parent._masked(isfree))
        t_op_form, op = _sync_time(masked._device_op)
        t_setup, mg = _sync_time(masked._mg)
        t_solve, dx = _sync_time(lambda: jac.solve(r, symmetric=system.is_symmetric))
        stats = dict(jac._solve_stats)
        launches = read_launches(EXAMPLE_KERNELS + ('cg_dot', 'cg_step', 'cg_xpby'))
        single_sweeps = read_launches(('jacobi_smooth',))['jacobi_smooth']
        forms = read_forms('laplace_example', {'stencil_matvec': 'tile', 'jacobi_pre': '2d', 'jacobi_post': '2d'})
        t_solve_warm, dx_warm = _sync_time(lambda: jac.solve(r, symmetric=system.is_symmetric))
        wall, kernels, _full, _dx = profiled(lambda: jac.solve(r, symmetric=system.is_symmetric))
        solve_profile = dict(wall_s=wall, device_busy_s=busy_s(kernels), busy_share=busy_s(kernels) / wall,
                             kernel_launches=sum(e.count for e in kernels))
        t_check, jdx = _sync_time(lambda: jac @ dx)
        rel_residual = float(numpy.linalg.norm(r - jdx) / numpy.linalg.norm(r))
        emit('laplace_example_solve_parts', t_mask=t_mask, op_form=op[0][0], t_op_form=t_op_form, t_setup=t_setup,
             mg_levels=None if mg is None else [list(lev[1]) for lev in mg.levels], t_solve=t_solve,
             t_solve_warm=t_solve_warm, solve_stats=stats, warm_solve_stats=dict(jac._solve_stats),
             t_host_residual=t_check, rel_residual=rel_residual, launches=launches,
             single_sweep_launches=single_sweeps, launches_by_form=forms, warm_solve_profile=solve_profile)
        # the same as the user calls it: the System keeps the constant
        # jacobian, and the jacobian its masked operator
        t_solve_entry, args = _sync_time(lambda: system.solve(constrain=cons))
        t_l2, err = _sync_time(lambda: laplace_l2_error(domain, ns, args))
        peak = _peak()
    u = args['u']
    emit('laplace_example', nelems=nelem, ndofs=ndofs, t_system=t_system, t_cons=t_cons, constrained=constrained,
         chunks=plan['nc'], t_assemble_first=t_assemble_first, t_assemble=t_assemble, t_mask=t_mask,
         t_op_form=t_op_form, t_setup=t_setup, t_solve=t_solve, t_solve_warm=t_solve_warm,
         t_solve_entry=t_solve_entry, l2_error=err,
         t_l2_error=t_l2, rel_residual=rel_residual, solve_stats=stats, peak_device_bytes=peak,
         peak_first_assembly_bytes=peak_first)
    if u.shape != (ndofs,) or not numpy.isfinite(u).all():
        raise AssertionError('Laplace example: the solution is not a finite vector of the dof count')
    want = {'method': 'gmres', 'op_form': 'stencil', 'precon': 'mg', 'accepted_on_device': True}
    if any(stats.get(k) != v for k, v in want.items()):
        raise AssertionError(f'Laplace example solved through {stats}, expected {want}')
    check_driver('laplace_example', stats)
    # four times the O(h^2) estimate from the example's own regression at 4
    # elements (1.63e-3): 2.5e-8 at 2048
    if not err < 4 * 1.63e-3 * (4 / nelems) ** 2:
        raise AssertionError(f'Laplace example: L2 error {err:.3e} is not below {4 * 1.63e-3 * (4 / nelems) ** 2:.2e}')
    if not (numpy.array_equal(u[isfree], x - dx) and numpy.array_equal(dx, dx_warm)):
        raise AssertionError('Laplace example: System.solve and its parts give other solutions')
    if single_sweeps:
        raise AssertionError(f'the example\'s V-cycle ran {single_sweeps} single K2 sweeps, not only fused ones')
    missing = [name for name in EXAMPLE_KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f'kernels not launched on the Laplace example path: {missing}')
    return launches, system, clean, w0, r0


def phase_laplace_example_chunks(system, clean, w_chunked, r_chunked):
    """The example's assembly in two chunks (the default) and in one
    (``config.assembly_chunk`` 2^23), each first after its caches were
    dropped: its peak memory, time, and the bits of w and r, which must be
    equal (and equal to ``phase_laplace_example``'s warm assembly)."""
    import _torch_parity as tp
    import torch
    from nutils_tpu_torch.utils import config
    fn = system._compiled('jacres')
    out = {}
    with config.device('cuda'):
        for label, chunk in (('chunked', config.assembly_chunk.value), ('unchunked', 2**23)):
            with config.assembly_chunk(chunk):
                tp.forget_assembly(system)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                t_first, (w, r) = _sync_time(lambda: fn(clean))
                peak = _peak()
                t_warm = min(_sync_time(lambda: fn(clean))[0] for _ in range(2))
                plan = system._chunk_plan()
                out[label] = dict(chunks=plan['nc'] if plan else 1, t_first=t_first, t_assemble=t_warm,
                                  peak_first_bytes=peak,
                                  sha1={name: hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()
                                        for name, t in (('w', w), ('r', r))},
                                  equal_to_example=bool(torch.equal(w, w_chunked) and torch.equal(r, r_chunked)))
                del w, r
    tp.forget_assembly(system)
    emit('laplace_example_chunks', **out)
    if out['chunked']['sha1'] != out['unchunked']['sha1'] or not out['chunked']['equal_to_example'] \
            or (out['chunked']['chunks'], out['unchunked']['chunks']) != (2, 1):
        raise AssertionError(f'the chunked and unchunked assemblies differ: {out}')


def phase_chunk_kernels(system, clean):
    """K11 and K12 in float64 at the shapes of one element chunk of the
    example (its second), each writing into that chunk's rows of a buffer
    of the whole batch, against their plain versions (writing into another
    such buffer) and one ``torch.einsum``; returns their rows."""
    import torch
    from nutils_tpu_torch import solver
    from nutils_tpu_torch.ops import assembly
    from nutils_tpu_torch.utils import config
    with config.device('cuda'):
        plan = system._chunk_plan()
        E, ce = plan['E'], plan['ce']
        rows = slice(ce, 2 * ce)
        args = system._device_args(clean)
        leaves = system._bound_leaves(args, {}, system._tables())
        lv = solver._chunk_leaves(leaves, plan['keys'], rows)
        (bi, ci, u, li, _reduce, _size), = system._jac_layout[0]
        c = system._blocks[bi][ci]
        form = system._form(c, rows)
        g, K = form.point_terms(args, lv, True, rows)
    trial = system._trial_locs[u][li].leaf.key
    Bt, Bs = form.operator(c.key, args, leaves, rows), form.operator(trial, args, leaves, rows)
    Kts = K[form.layout[trial][0]][..., form.layout[c.key][0]].permute(1, 2, 3, 0)
    gt = g[..., form.layout[c.key][0]]
    _ce, Q, A, B = Kts.shape
    I, J = Bt.shape[-1], Bs.shape[-1]
    isz = Kts.element_size()
    bufs = {name: torch.zeros(shape, dtype=Kts.dtype, device=Kts.device)
            for name, shape in (('V', (E, I, J)), ('Vp', (E, I, J)), ('r', (E, I)), ('rp', (E, I)))}
    cases = [('elem_matrix', 'V', lambda: assembly.elem_matrix(Bt, Kts, Bs, out=bufs['V'][rows]),
              lambda: assembly.elem_matrix_plain(Bt, Kts, Bs, out=bufs['Vp'][rows]),
              lambda: torch.einsum('eqai,eqab,eqbj->eij', Bt, Kts, Bs),
              lambda: assembly.elem_matrix_plain(Bt.abs(), Kts.abs(), Bs.abs()),
              (_distinct_numel(Bt, Kts, Bs) + ce * I * J) * isz, 2 * ce * Q * A * J * (B + I)),
             ('elem_vector', 'r', lambda: assembly.elem_vector(Bt, gt, out=bufs['r'][rows]),
              lambda: assembly.elem_vector_plain(Bt, gt, out=bufs['rp'][rows]),
              lambda: torch.einsum('eqai,eqa->ei', Bt, gt),
              lambda: assembly.elem_vector_plain(Bt.abs(), gt.abs()),
              (Bt.numel() + gt.numel() + ce * I) * isz, 2 * ce * Q * A * I)]
    results = {}
    for name, bufname, kernel, plain, library, magnitude, nbytes, flops in cases:
        got, want, scale = kernel(), plain(), magnitude().max()
        torch.cuda.synchronize()
        buf = bufs[bufname]
        in_place = got.data_ptr() == buf[rows].data_ptr()
        untouched = bool((buf[:ce] == 0).all() and (buf[2 * ce:] == 0).all())
        first = got.clone()
        repeat = bool(torch.equal(kernel(), first))
        err, relerr = _compare(got, want, scale)
        (ms, call_ms), (plain_ms, _pc) = time_ms(kernel), time_ms(plain)
        fields = row(err, ms, plain_ms, nbytes, flops, time_ms(library)[0], peak=F64_FLOPS)
        extra = dict(plan=k11_plan(Bt, Kts, Bs) if name == 'elem_matrix' else k12_plan(Bt, gt), sha1=digest(got))
        check_row(name, f'laplace_example chunk {rows.start}:{rows.stop} of {E}', 'float64', relerr,
                  dict(fields, E=ce, Q=Q, A=A, B=B, I=I, J=J, in_place=in_place, other_rows_untouched=untouched,
                       bitwise_repeat=repeat, call_ms=call_ms, **extra))
        if not (in_place and untouched and repeat):
            raise AssertionError(f'{name} did not write in place into its chunk\'s rows alone, or two launches '
                                 'differ')
        results[name] = fields
        del got, want
    return results


def phase_laplace_example_parity(nelems=256, devices=('cuda', 'cpu')):
    """The example at ``nelems``^2 elements (above ``device_solve_min``, so
    the solves run on the device) with ``config.assembly_chunk`` 4,096, so
    that it is assembled in chunks too, on the card and through the port's
    CPU path, in float64: ``cons`` and ``u`` agree to 1e-9 of their largest
    value."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch.utils import config
    out = {}
    with config.floatx(numpy.float64), config.assembly_chunk(4096):
        for device in devices:
            with config.device(device):
                t, result = _sync_time(lambda: tp.laplace_example('nutils_tpu_torch', nelems))
                out[device] = result + (t,)
    (ca, ua, ea, ta), (cb, ub, eb, tb) = (out[d] for d in devices)
    dc = float(numpy.nanmax(numpy.abs(ca - cb)) / numpy.nanmax(numpy.abs(cb)))
    du = float(numpy.abs(ua - ub).max() / numpy.abs(ub).max())
    same = bool(numpy.array_equal(numpy.isnan(ca), numpy.isnan(cb)))
    emit('laplace_example_parity', nelems=nelems * nelems, ndofs=len(ub), rel_cons=dc, rel_u=du, tol=1e-9,
         same_constrained_dofs=same, l2_error=[ea, eb], seconds=[ta, tb], devices=list(devices))
    if not (dc <= 1e-9 and du <= 1e-9 and same):
        raise AssertionError(f'card and CPU examples differ: cons {dc:.3e}, u {du:.3e}, same dofs {same}')


def phase_laplace_example_p2(nelems=P2_NELEMS):
    """examples/laplace.py's ``main`` at degree 2 on ``nelems``^2 elements in
    float64 through the port's entry points (``solve_constraints``,
    ``System.solve(constrain=)``): the fine level's stencil has half-width
    2, so the V-cycle smooths it through K2's single sweeps and its coarser
    (k = 1) levels through the fused ones; launch counts read around it.
    The L2 error must be below 4 x its O(h^3) estimate from 40^2 elements
    (8.0e-8 on the CPU).  Returns the launch counts."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch.utils import config
    with config.floatx(numpy.float64), config.device('cuda'):
        reset_launches()
        t, (cons, u, err) = _sync_time(lambda: tp.laplace_example('nutils_tpu_torch', nelems, degree=2))
        launches = read_launches(P2_KERNELS + ('stencil_matvec', 'cg_dot', 'cg_step', 'cg_xpby'))
        forms = read_forms('laplace_example_p2', {'jacobi_pre': '2d', 'jacobi_post': '2d'})
    limit = 4 * 8.0e-8 * (40 / nelems) ** 3
    emit('laplace_example_p2', nelems=nelems * nelems, ndofs=len(u), seconds=t, l2_error=err, limit=limit,
         constrained=int(numpy.isfinite(cons).sum()), launches=launches, launches_by_form=forms)
    if u.shape != ((2 * nelems + 1) ** 2,) or not numpy.isfinite(u).all() or not err < limit:
        raise AssertionError(f'degree-2 example: {u.shape} dofs, L2 error {err:.3e} (limit {limit:.2e})')
    missing = [name for name in P2_KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f'kernels not launched on the degree-2 example: {missing}')
    return launches


def phase_ns_newton(nelems=330):
    """``System.solve(method=Newton(), tol=...)`` on the Navier-Stokes
    step's System (float32 assembly) from its random state, to 1e-5 of the
    first residual norm in at most 8 iterations: each iteration's residual
    norm, time, inner tolerance and solve record.  Every inner solve must be
    accepted on the device: under ``auto`` one that misses its tolerance is
    demoted to a host direct solve, and its record says so."""
    import numpy
    from nutils_tpu_torch import matrix
    from nutils_tpu_torch.solver import Newton
    from nutils_tpu_torch.utils import config
    with config.device('cuda'):
        system, args = build_ns(nelems, numpy.float32)
        t_r0, r0 = _sync_time(lambda: system.assemble_residual(args))
        tol = 1e-5 * float(numpy.linalg.norm(r0))
        iterations = []
        assemble, solve_leniently = system.assemble_jacobian_residual, matrix.Matrix.solve_leniently

        def timed_assembly(*a, **k):
            t, (jac, res) = _sync_time(lambda: assemble(*a, **k))
            iterations.append(dict(t_assemble=t, resnorm=float(numpy.linalg.norm(res)), at=time.perf_counter()))
            return jac, res

        def timed_solve(jac, res, **kw):
            t, dx = _sync_time(lambda: solve_leniently(jac, res, **kw))
            iterations[-1].update(t_solve=t, inner_rtol=kw.get('rtol'), solve_stats=dict(jac._solve_stats))
            return dx
        system.assemble_jacobian_residual = timed_assembly
        matrix.Matrix.solve_leniently = timed_solve
        try:
            t_newton, out = _sync_time(lambda: system.solve(arguments=args, method=Newton(), tol=tol, maxiter=8))
        finally:
            matrix.Matrix.solve_leniently = solve_leniently
            del system.assemble_jacobian_residual
    for prev, it in zip(iterations, iterations[1:]):
        it['t_iteration'] = it['at'] - prev['at']
    for it in iterations:
        del it['at']
    emit('ns_newton', ndofs=sum(int(numpy.prod(s)) for s in system.trial_shapes), tol=tol, t_first_residual=t_r0,
         t_newton=t_newton, newton_iterations=len(iterations) - 1, iterations=iterations)
    if not iterations[-1]['resnorm'] <= tol or not all(numpy.isfinite(v).all() for v in out.values()):
        raise AssertionError(f'Newton did not reach {tol:.3e}: {[it["resnorm"] for it in iterations]}')
    host = [it['solve_stats'] for it in iterations[:-1] if not it['solve_stats']['accepted_on_device']]
    if host:
        raise AssertionError(f'Newton\'s inner solves left the device: {host}')
    for k, it in enumerate(iterations[:-1]):
        check_driver(f'ns_newton iteration {k}', it['solve_stats'])


@contextlib.contextmanager
def plain_calls():
    """Count, while the block is open, the calls of every kernel's plain
    version in the port's ops modules (the functions named ``*_plain``):
    {name: calls}; none may come from a path on the card."""
    from nutils_tpu_torch.ops import assembly, blockgrid, cg, mg, precon, sparse, stencil
    counts = {}
    saved = [(mod, name, getattr(mod, name)) for mod in (assembly, blockgrid, cg, mg, precon, sparse, stencil)
             for name in dir(mod) if name.endswith('_plain') and callable(getattr(mod, name))]
    for mod, name, fn in saved:
        def counting(*args, _fn=fn, _name=f'{mod.__name__.rsplit(".", 1)[-1]}.{name}', **kwargs):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        setattr(mod, name, counting)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ------------------------------------------------------------ time stepping

# the Navier-Stokes history step: three System.step calls of the step's
# System (Newton to 1e-5 of the first step's first residual norm, as
# ns_newton sets it)
NS_STEPS = 3
NS_DT = 0.01
# the heat equation's Crank-Nicolson steps at 1024^2 squares: each step is
# Direct's solve, on the card (above config.device_solve_min); newtontol is
# the bound on its residual norm |r - J dx|: the device solve aims at 1e-11
# |r| or at _accept's floor 16 eps ||J||_inf |dx|, both near 1e-13 here
# (|r| ~ 1e-2, ||J||_inf ~ 2.7, |dx| ~ 10), so the theta method's default
# 1e-10 holds with room
HEAT_NELEMS = 1024
HEAT_STEPS = 5
HEAT_DT = 1e-3
HEAT_NEWTONTOL = 1e-10
SETUP_NAMES = ('jac_layout', 'k5_plan', 'level_stencil', 'prolongation', 'galerkin_plan')


@contextlib.contextmanager
def counted_set_up():
    """Time, while the block is open, each call of the set-up that a System
    makes once for its pattern: the jacobian layout
    (``System._jac_layout``: the pattern sort and value plans), K5's compact
    plan (``ops/blockgrid.compact_plan``), the multigrid's level stencil
    inferences (``ops/stencil.from_csr_grid``), prolongations
    (``ops/mg._prolong_1d``) and Galerkin plans (``ops/mg.galerkin_plan``):
    {name: [seconds of each call]}.  Nothing of the package changes."""
    import functools
    from nutils_tpu_torch import solver
    from nutils_tpu_torch.ops import blockgrid, mg, stencil
    made = {name: [] for name in SETUP_NAMES}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t, out = _sync_time(lambda: fn(*args, **kwargs))
            made[name].append(t)
            return out
        return wrapper
    layout = solver.System.__dict__['_jac_layout']
    prop = functools.cached_property(timed('jac_layout', layout.func))
    prop.__set_name__(solver.System, '_jac_layout')
    patched = [(blockgrid, 'compact_plan', 'k5_plan'), (stencil, 'from_csr_grid', 'level_stencil'),
               (mg, '_prolong_1d', 'prolongation'), (mg, 'galerkin_plan', 'galerkin_plan')]
    saved = [getattr(mod, attr) for mod, attr, _name in patched]
    solver.System._jac_layout = prop
    for (mod, attr, name), fn in zip(patched, saved):
        setattr(mod, attr, timed(name, fn))
    try:
        yield made
    finally:
        solver.System._jac_layout = layout
        for (mod, attr, _name), fn in zip(patched, saved):
            setattr(mod, attr, fn)


def phase_ns_steps(nelems=330, steps=NS_STEPS, device='cuda'):
    """``System.step`` on the Navier-Stokes step written as
    ``examples/cylinderflow.py`` writes it (the history ``u0`` and the
    timestep ``dt`` arguments, ``timearg='t'`` unread), 983,403 dofs in
    float32, from build_ns's seeded state: ``steps`` steps of 0.01, Newton
    each to 1e-5 of the first step's first residual norm.  One line a step
    (its time, Newton iterations and, for each, ``t_assemble``,
    ``t_solve``, ``t_capture`` and the solve record; launches), one of the
    set-up.  Asserts: each step converges at its timestep (no halving),
    every inner solve on the card from CUDA graphs, the layout and K5's
    plan made once over the run, no plain version, K5-K7, K11 and K12
    launched in every step, each step's history the previous step's state,
    bit for bit.  Returns each step's launches."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch import matrix
    from nutils_tpu_torch.utils import config
    names = NS_KERNELS + ('csr_scatter',)
    lines = []
    with config.device(device), counted_set_up() as made, plain_calls() as plain:
        t_system, (system, args) = _sync_time(
            lambda: tp.taylor_hood_history('nutils_tpu_torch', nelems, numpy.float32))
        ndofs = sum(int(numpy.prod(s)) for s in system.trial_shapes)
        check_routes('ns_steps', system)
        t_r0, r0 = _sync_time(lambda: system.assemble_residual(dict(args, u0=args['u'], dt=NS_DT)))
        tol = 1e-5 * float(numpy.linalg.norm(r0))
        iterations, dts = [], []
        assemble, solve_leniently, solve = system.assemble_jacobian_residual, matrix.Matrix.solve_leniently, \
            system.solve

        def timed_assembly(*a, **k):
            t, (jac, res) = _sync_time(lambda: assemble(*a, **k))
            iterations.append(dict(t_assemble=t, resnorm=float(numpy.linalg.norm(res))))
            return jac, res

        def timed_solve(jac, res, **kw):
            t, dx = _sync_time(lambda: solve_leniently(jac, res, **kw))
            stats = dict(jac._solve_stats)
            iterations[-1].update(t_solve=t, t_capture=stats.get('t_capture', 0.), inner_rtol=kw.get('rtol'),
                                  solve_stats=stats)
            return dx

        def counted_solve(**kw):
            dts.append(float(kw['arguments']['dt']))
            return solve(**kw)
        system.assemble_jacobian_residual = timed_assembly
        system.solve = counted_solve
        matrix.Matrix.solve_leniently = timed_solve
        try:
            for k in range(steps):
                iterations.clear()
                reset_launches()
                t_step, out = _sync_time(lambda: system.step(timestep=NS_DT, timearg='t', timesteparg='dt', suffix='0',
                                                             arguments=args, tol=tol, maxiter=8))
                lines.append(dict(step=k, t=out['t'], t_step=t_step, newton_iterations=len(iterations) - 1,
                                  iterations=list(iterations), launches=read_launches(names),
                                  history_is_state=out['u0'] is args['u'] and numpy.array_equal(out['u0'], args['u'])))
                emit('ns_steps', **lines[-1])
                args = out
        finally:
            matrix.Matrix.solve_leniently = solve_leniently
            del system.assemble_jacobian_residual, system.solve
    emit('ns_steps_setup', ndofs=ndofs, tol=tol, t_first_residual=t_r0, t_system=t_system,
         t_pattern=made['jac_layout'], t_k5_plan=made['k5_plan'], timesteps=dts, plain_calls=plain)
    if dts != [NS_DT] * steps:
        raise AssertionError(f'ns_steps: the solves ran at timesteps {dts}, expected {steps} of {NS_DT}')
    for line in lines:
        its = line['iterations']
        if not its[-1]['resnorm'] <= tol or not line['history_is_state']:
            raise AssertionError(f'ns_steps step {line["step"]}: residuals {[it["resnorm"] for it in its]} '
                                 f'for {tol:.3e}, history the state: {line["history_is_state"]}')
        for j, it in enumerate(its[:-1]):
            if not it['solve_stats']['accepted_on_device']:
                raise AssertionError(f'ns_steps step {line["step"]}: inner solve {j} left the device')
            check_driver(f'ns_steps step {line["step"]} iteration {j}', it['solve_stats'])
        missing = [name for name in NS_KERNELS if line['launches'][name] <= 0]
        if missing:
            raise AssertionError(f'ns_steps step {line["step"]}: kernels not launched: {missing}')
    if len(made['jac_layout']) != 1 or len(made['k5_plan']) != 1 or plain:
        raise AssertionError(f'ns_steps: {len(made["jac_layout"])} layouts and {len(made["k5_plan"])} K5 plans '
                             f'over {steps} steps (1 each expected), plain versions {plain}')
    return [line['launches'] for line in lines]


def phase_heat_steps(nelems=HEAT_NELEMS, steps=HEAT_STEPS, device='cuda'):
    """``solver.cranknicolson('u:v', ∇v·∇u, v u, timestep=1e-3)`` on
    ``nelems`` squares a side, degree 1 (1,050,625 dofs), float32 assembly,
    from the nodal values of the Neumann mode cos(πx) cos(πy): ``steps``
    steps, each a ``Direct`` solve that ``auto`` sends to the card.  One
    line a step (its time, the solve's method, preconditioner, operator
    form and record, its residual norm against newtontol, the set-up calls
    so far, launches, the L2 norm's ratio).  Asserts: every solve accepted
    on the card from CUDA graphs, the layout, prolongations and level
    stencils made in the first step alone, the Galerkin plans in the second
    alone, no plain version, the assembly's and the solve's kernels
    launched in every step, and each step's L2 norm ratio within 1e-3
    relative of the continuous Crank-Nicolson factor (1 - λΔt/2) /
    (1 + λΔt/2), λ = 2π².  Returns each step's launches."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch import function, matrix, solver
    from nutils_tpu_torch.utils import config
    names = MG_KERNELS + GMRES_KERNELS + ASSEMBLY_KERNELS
    lines, states = [], []
    with config.device(device), config.floatx(numpy.float32), counted_set_up() as made, plain_calls() as plain:
        topo, geom, u, res, inertia, u0 = tp.heat('nutils_tpu_torch', nelems)
        records = []
        direct = solver.Direct.__call__

        def recorded(self, system, **kw):
            args, resnorm = direct(self, system, **kw)
            records.append(resnorm)
            return args, resnorm
        solve = matrix.Matrix.solve

        def recorded_solve(self, *a, **k):
            x = solve(self, *a, **k)
            records.append(dict(self._solve_stats))
            return x
        solver.Direct.__call__ = recorded
        matrix.Matrix.solve = recorded_solve
        try:
            t_system, steps_ = _sync_time(lambda: solver.cranknicolson('u:v', res, inertia, timestep=HEAT_DT,
                                                                         newtontol=HEAT_NEWTONTOL,
                                                                         arguments={'u': u0}))
            states.append(next(steps_))
            for k in range(steps):
                records.clear()
                reset_launches()
                t_step, x = _sync_time(lambda: next(steps_))
                states.append(x)
                stats, resnorm = records
                lines.append(dict(step=k, t_step=t_step, method=stats['method'], precon=stats['precon'],
                                  op_form=stats['op_form'], resnorm=resnorm, newtontol=HEAT_NEWTONTOL,
                                  set_up={name: len(calls) for name, calls in made.items()},
                                  launches=read_launches(names), solve_stats=stats))
        finally:
            solver.Direct.__call__ = direct
            matrix.Matrix.solve = solve
    with config.device(device), config.floatx(numpy.float64):
        l2 = topo.integral(u ** 2 * function.J(geom), degree=2)
        norms = [float(l2.eval({'u': x})) ** .5 for x in states]
    lam_dt = 2 * numpy.pi ** 2 * HEAT_DT
    factor = (1 - lam_dt / 2) / (1 + lam_dt / 2)
    for line, n0, n1 in zip(lines, norms, norms[1:]):
        line.update(ratio=n1 / n0, ratio_rel_err=n1 / n0 / factor - 1)
        emit('heat_steps', **line)
    emit('heat_steps_setup', ndofs=int(u0.size), t_system=t_system, factor=factor, norms=norms,
         set_up_seconds=made, plain_calls=plain)
    for line in lines:
        stats = line['solve_stats']
        if not stats['accepted_on_device'] or stats['op_form'] != 'stencil' or stats['precon'] != 'mg':
            raise AssertionError(f'heat_steps step {line["step"]}: solved through {stats}')
        check_driver(f'heat_steps step {line["step"]}', stats)
        kernels = ('stencil_matvec', 'jacobi_pre', 'jacobi_post', 'mg_restrict', 'mg_prolong_add') \
            + (GMRES_KERNELS if stats['method'] == 'gmres' else ('cg_dot', 'cg_step', 'cg_xpby')) + ASSEMBLY_KERNELS
        missing = [name for name in kernels if line['launches'][name] <= 0]
        if missing or not abs(line['ratio_rel_err']) <= 1e-3:
            raise AssertionError(f'heat_steps step {line["step"]}: kernels not launched {missing}, '
                                 f'L2 ratio {line["ratio"]} against {factor}')
    first, second, last = lines[0]['set_up'], lines[1]['set_up'], lines[-1]['set_up']
    if not (first['jac_layout'] == last['jac_layout'] == 1 and 0 < first['prolongation'] == last['prolongation']
            and 0 < first['level_stencil'] == last['level_stencil']
            and first['galerkin_plan'] == 0 < second['galerkin_plan'] == last['galerkin_plan']) or plain:
        raise AssertionError(f'heat_steps: set-up calls after steps 1, 2 and {steps}: {first}, {second}, {last} '
                             f'(the layout, prolongations and level stencils in step 1 alone, the Galerkin plans in '
                             f'step 2 alone); plain versions {plain}')
    return [line['launches'] for line in lines]


def phase_timestep_parity(devices=('cuda', 'cpu')):
    """The time-stepping cases of ``tests/_torch_parity.py`` (``Pseudotime``,
    ``Arnoldi``, the legacy functions, ``thetamethod`` and
    ``cranknicolson``, ``System.step`` on the Taylor-Hood history step) in
    float64 on the card and on the CPU: their results agree to 1e-10
    relative; ``System.step``'s halving makes the same calls on both; the
    matrix algebra on the stencil-, block-grid- and CSR-form jacobians
    agrees to 1e-12 with the same pattern, and a scalar product of the CSR
    jacobian's values on the card keeps the host product's bits."""
    import _torch_parity as tp
    import numpy
    import torch
    from nutils_tpu_torch.utils import config
    rel, halving, algebra = {}, {}, {}
    with config.floatx(numpy.float64):
        for case, fn in tp.TIMESTEP_CASES.items():
            out = {}
            for device in devices:
                with config.device(device):
                    out[device] = fn('nutils_tpu_torch')
            a, b = (out[d] for d in devices)
            rel[case] = max(tp.rel(numpy.nan_to_num(a[key]), numpy.nan_to_num(b[key])) for key in a)
        for device in devices:
            with config.device(device):
                calls, state = tp.step_with_failures('nutils_tpu_torch', *tp.decay('nutils_tpu_torch', read_t=False),
                                                     timesteparg='dt')
            halving[device] = calls, state['u']
        jacobians = {}
        for form in ('stencil', 'blockgrid', 'csr'):
            for device in devices:
                with config.device(device):
                    jacobians[form, device] = tp.spd_jacobian('nutils_tpu_torch', form)[0]
            for op, fn in tp.MATRIX_OPS.items():
                a, b = (fn(jacobians[form, d]).export('csr') for d in devices)
                same = all(numpy.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
                algebra[f'{form}:{op}'] = tp.rel(a[0], b[0]) if same else None
    csr = jacobians['csr', devices[0]]
    on_card = isinstance(csr.data, torch.Tensor) and csr.data.device.type == 'cuda'
    product = csr * 0.3
    product_bits = on_card and product.data.device.type == 'cuda' \
        and product.data.cpu().numpy().tobytes() == (csr.data.cpu().numpy() * 0.3).tobytes()
    same_halving = halving[devices[0]][0] == halving[devices[1]][0] \
        and tp.rel(halving[devices[0]][1], halving[devices[1]][1]) <= 1e-10
    emit('timestep_parity', devices=list(devices), rel=rel, tol=1e-10, halving_calls=halving[devices[0]][0],
         halving_same=same_halving, algebra_rel=algebra, algebra_tol=1e-12, csr_product_on_card=bool(product_bits))
    bad = [case for case, r in rel.items() if not r <= 1e-10] + [key for key, r in algebra.items()
                                                                 if r is None or not r <= 1e-12]
    if bad or not same_halving or not product_bits:
        raise AssertionError(f'timestep_parity: card and CPU differ in {bad}; halving the same {same_halving}; '
                             f'the CSR product on the card with the host bits {product_bits}')


def timestep_only():
    """``--only timestep``: device, build and the three time-stepping
    phases alone."""
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    track_mg()
    phase_ns_steps()
    phase_heat_steps()
    phase_timestep_parity()
    emit('done', seconds=time.perf_counter() - t0)


def phase_elasticity(nelems=ELASTICITY_NELEMS):
    """examples/elasticity.py at ``nelems`` triangles a side, degree 2, in
    float64, through the port's entry points: ``solve_constraints`` on the
    clamped top, then ``System.solve(constrain=cons, method=Direct(solver=
    'cg', precon='block', preconargs={'blocksize': 2}))`` part by part (the
    CSR assembly through K8, K11 and K12, the masked operator and its
    nodal-block inverse, block-Jacobi CG through K13, K9 and K4 from CUDA
    graphs; no plain version may run) and as the user calls it, the
    traction solve and the clamping force F, which must be (0, 1) to 1e-8.
    Beside it, for the record, the same solve under the default
    preconditioner (K7's Schur diagonal, plain Jacobi on this matrix).
    Then block-Jacobi CG on the device's masked operator (``_isfree=``:
    K14 around K9) of the whole jacobian, whose free rows must be the
    public solve's to 1e-8.  Returns (launch counts, the block inverse of
    the masked matrix, the free rows, the displacement's System and its
    clean arguments)."""
    import _torch_parity as tp
    import numpy
    import torch
    from nutils_tpu_torch.ops import sparse
    from nutils_tpu_torch.solver import Direct, System
    from nutils_tpu_torch.utils import config
    with config.floatx(numpy.float64), config.device('cuda'):
        t_forms, (domain, ns, sqr, energy, traction) = _sync_time(
            lambda: tp.elasticity_forms('nutils_tpu_torch', nelems, 'triangle'))
        t_system, (scons, system) = _sync_time(lambda: (System(sqr, trial='u'), System(energy, trial='u')))
        ndofs = int(numpy.prod(system.trial_shapes[0]))
        emit('elasticity_system', nelems=2 * nelems * nelems, ndofs=ndofs, t_forms=t_forms, t_system=t_system)
        check_routes('elasticity', system)
        t_cons, cons = _sync_time(lambda: scons.solve_constraints(droptol=1e-15))
        constrained = int(numpy.isfinite(cons['u']).sum())
        emit('elasticity_cons', t_cons=t_cons, constrained=constrained,
             solve_stats=scons._cache['jacmat']._solve_stats)
        if constrained != 2 * (2 * nelems + 1):
            raise AssertionError(f'solve_constraints constrained {constrained} dofs, expected {2 * (2 * nelems + 1)}')
        # host planning: the CSR pattern sort and the value scatter's plan
        t_pattern, (_meta, lazy, jplan) = _sync_time(lambda: system._jac_layout)
        t_pattern_sort, pattern = _sync_time(lazy.get)
        if jplan is not None:
            raise AssertionError(f'the elasticity example planned a {jplan["form"]} jacobian, expected CSR')
        arguments, x = system.deconstruct({}, cons)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t_assemble_first, (jac, r) = _sync_time(lambda: system.assemble_jacobian_residual(arguments, x))
        peak_first = _peak()
        clean = system._clean(system.construct(arguments, x))
        fn = system._compiled('jacres')
        t_assemble = min(_sync_time(lambda: fn(clean))[0] for _ in range(2))
        emit('elasticity_assembly', entries=int(len(pattern.slot)), nnz=int(pattern.nnz),
             t_pattern=t_pattern + t_pattern_sort, t_assemble_first=t_assemble_first, t_assemble=t_assemble,
             peak_first_bytes=peak_first)
        # System.solve(constrain=cons) part by part: the masked operator and
        # its form, the nodal blocks' inverse, the block-Jacobi CG
        parent, isfree = jac._parent, jac._mask
        t_mask, masked = _sync_time(lambda: parent._masked(isfree))
        t_op_form, op = _sync_time(masked._device_op)
        t_precon, pc = _sync_time(lambda: masked.getprecon('block', blocksize=2))
        with plain_calls() as plain:
            t_solve, dx = _sync_time(lambda: jac.solve(r, **BLOCK_CG))
            stats = dict(jac._solve_stats)
            launches = read_launches(ELASTICITY_KERNELS)
            warm = [_sync_time(lambda: jac.solve(r, **BLOCK_CG)) for _ in range(3)]
        t_solve_warm = statistics.median(t for t, _dx in warm)
        warm_stats = dict(jac._solve_stats)
        repeatable = all(numpy.array_equal(d, dx) for _t, d in warm)
        t_check, jdx = _sync_time(lambda: jac @ dx)
        rel_residual = tp.rel(jdx, r)
        # the default preconditioner, for the record: what the nodal
        # blocks buy over plain Jacobi
        t_default, dx_default = _sync_time(lambda: jac.solve_leniently(r, solver='cg'))
        default_stats = dict(jac._solve_stats)
        t_default_warm = statistics.median(_sync_time(lambda: jac.solve_leniently(r, solver='cg'))[0]
                                           for _ in range(3))
        emit('elasticity_solve_parts', t_mask=t_mask, op_form=op[0][0], t_op_form=t_op_form, t_precon=t_precon,
             t_solve=t_solve, t_solve_warm=t_solve_warm, solve_stats=stats, warm_solve_stats=warm_stats,
             repeatable=repeatable, t_host_residual=t_check, rel_residual=rel_residual, launches=launches,
             plain_calls=plain, default_precon=dict(t_solve=t_default, t_solve_warm=t_default_warm,
                                                    solve_stats=default_stats, rel_to_block=tp.rel(dx_default, dx)))
        # as the user calls it, then the traction solve and the force
        t_solve_entry, args = _sync_time(lambda: system.solve(constrain=cons, method=Direct(**BLOCK_CG)))
        tsystem = System(traction, trial='t', test='u')
        t_traction, args = _sync_time(lambda: tsystem.solve(constrain={'t': numpy.isnan(cons['u'])}, arguments=args))
        t_force, F = _sync_time(lambda: numpy.asarray(
            domain.boundary['top'].integrate('t_i dS' @ ns, degree=4, arguments=args)))
        peak = _peak()
        # the device's masked operator on the whole jacobian
        full, res = system.assemble_jacobian_residual({'u': numpy.zeros(system.trial_shapes[0])})
        free = numpy.isnan(cons['u']).ravel()
        t_full_op, (mv_kind, fop) = _sync_time(full._device_op)
        t_full_precon, _pc = _sync_time(lambda: full.getprecon('block', blocksize=2))
        t_mask_device, _mop = _sync_time(lambda: full._masked_op(mv_kind, fop, sparse.widen(fop), free))
        b = numpy.where(free, res, 0.)
        reset_launches()
        with plain_calls() as mplain:
            t_msolve, dxm = _sync_time(lambda: full._solve_cg(b, atol=0., rtol=1e-11, precon='block',
                                                              preconargs={'blocksize': 2}, _isfree=free))
            mstats = dict(full._solve_stats)
            mlaunches = read_launches(MASKED_KERNELS)
            t_msolve_warm = _sync_time(lambda: full._solve_cg(b, atol=0., rtol=1e-11, precon='block',
                                                              preconargs={'blocksize': 2}, _isfree=free))[0]
        rel_masked = tp.rel(dxm[free], dx)
    u = args['u']
    force_error = float(numpy.abs(F - [0., 1.]).max())
    emit('elasticity_masked', setup_public=dict(t_mask=t_mask, t_op_form=t_op_form, t_precon=t_precon),
         setup_masked=dict(t_mask_device=t_mask_device, t_op_form=t_full_op, t_precon=t_full_precon),
         t_solve=t_msolve, t_solve_warm=t_msolve_warm, solve_stats=mstats, launches=mlaunches, plain_calls=mplain,
         rel_to_public=rel_masked, tol=1e-8)
    emit('elasticity', nelems=2 * nelems * nelems, ndofs=ndofs, nnz=int(pattern.nnz), t_system=t_system,
         t_cons=t_cons, t_pattern=t_pattern + t_pattern_sort, t_assemble_first=t_assemble_first,
         t_assemble=t_assemble, t_precon=t_precon, t_solve=t_solve, t_solve_warm=t_solve_warm,
         iters=stats['iters'], rounds=stats['rounds'], driver=stats.get('driver'), host_reads=stats.get('host_reads'),
         t_solve_entry=t_solve_entry, t_traction=t_traction, t_force=t_force, F=F.tolist(), force_error=force_error,
         rel_residual=rel_residual, peak_device_bytes=peak, default_iters=default_stats['iters'],
         default_t_solve_warm=t_default_warm)
    if u.shape != tuple(system.trial_shapes[0]) or not numpy.isfinite(u).all():
        raise AssertionError('elasticity: the displacement is not a finite array of the field\'s shape')
    want = {'method': 'cg', 'op_form': 'csr', 'precon': 'block', 'accepted_on_device': True, 'driver': 'graph'}
    for record in (stats, warm_stats):
        if any(record.get(k) != v for k, v in want.items()):
            raise AssertionError(f'elasticity solved through {record}, expected {want}')
    if launches['block_apply'] < stats['iters']:
        raise AssertionError(f'K13 launched {launches["block_apply"]} times in {stats["iters"]} CG iterations')
    missing = [name for name, count in launches.items() if count <= 0]
    if missing or plain:
        raise AssertionError(f'elasticity: kernels not launched {missing}, plain versions run {plain}')
    if not force_error < 1e-8:
        raise AssertionError(f'elasticity: the clamping force {F} is not (0, 1) to 1e-8')
    mwant = {'method': 'cg', 'op_form': 'masked', 'precon': 'block', 'accepted_on_device': True}
    if any(mstats.get(k) != v for k, v in mwant.items()) or not rel_masked <= 1e-8:
        raise AssertionError(f'elasticity, masked operator: {mstats}, {rel_masked:.3e} from the public solve')
    mmissing = [name for name, count in mlaunches.items() if count <= 0]
    if mmissing or mplain:
        raise AssertionError(f'elasticity, masked operator: kernels not launched {mmissing}, plain versions run '
                             f'{mplain}')
    return dict(launches, mask_pre=mlaunches['mask_pre'], mask_post=mlaunches['mask_post']), pc.minv, free, system, \
        clean


def phase_elasticity_kernels(minv_host, free):
    """K13 and K14 against their plain versions at the elasticity path's
    shapes (its nodal blocks' inverse, n = 1,039,682, bs = 2; its mask), in
    float32 and float64, timed beside one PyTorch call: ``torch.bmm`` of
    the blocks for K13, ``torch.mul`` for ``mask_pre``; ``mask_post`` has no
    one call (``torch.mul`` then ``torch.addcmul`` are timed, as
    ``two_calls_ms``).  Returns {name: row} in float64, the path's dtype."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import precon, sparse
    rng = numpy.random.default_rng(21)
    nb, bs, _ = minv_host.shape
    n = len(free)
    if nb * bs != n:
        raise AssertionError(f'elasticity: {n} dofs in {nb} blocks of {bs}')
    r_np, x_np, y_np = (rng.standard_normal(n) for _ in range(3))
    results = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split('.')[1]
        isz = 4 if dtype == torch.float32 else 8
        peak = F32_FLOPS if dtype == torch.float32 else F64_FLOPS
        minv = torch.as_tensor(minv_host, device='cuda').to(dtype)
        m = torch.as_tensor(free, device='cuda').to(dtype)
        mc = 1 - m
        r, x, y = (torch.as_tensor(a, dtype=dtype, device='cuda') for a in (r_np, x_np, y_np))
        z = torch.empty_like(r)
        r3 = r.view(nb, bs, 1)
        cases = {'block_apply': (lambda: precon.block_apply(minv, r, out=z), lambda: precon.block_apply_plain(minv, r),
                                 lambda: precon.block_apply_plain(minv.abs(), r.abs()),
                                 lambda: torch.bmm(minv, r3), None, (n * bs + 2 * n) * isz, 2 * bs * n),
                 'mask_pre': (lambda: sparse.mask_pre(m, x, out=z), lambda: sparse.mask_pre_plain(m, x), None,
                              lambda: torch.mul(m, x), None, 3 * n * isz, n),
                 'mask_post': (lambda: sparse.mask_post(m, y, x, out=z), lambda: sparse.mask_post_plain(m, y, x), None,
                               None, lambda: torch.addcmul(torch.mul(mc, x), m, y), 4 * n * isz, 4 * n)}
        for name, (kernel, plain, magnitude, library, two_calls, nbytes, flops) in cases.items():
            got, want = kernel().clone(), plain()
            repeat = bool(torch.equal(kernel(), got))
            torch.cuda.synchronize()
            err, relerr = _compare(got, want, None if magnitude is None else magnitude().max())
            same_values = bool((got == want).all())
            (ms, call_ms), (plain_ms, _pc) = time_ms(kernel), time_ms(plain)
            fields = row(err, ms, plain_ms, nbytes, flops, None if library is None else time_ms(library)[0], peak)
            extra = dict(n=n, bs=bs, call_ms=call_ms, same_values_as_plain=same_values, bitwise_repeat=repeat)
            if two_calls is not None:
                extra['two_calls_ms'] = time_ms(two_calls)[0]
            if name != 'block_apply':
                extra.update(mask_rows(name, m, x, y, dtype))
            check_row(name, 'elasticity', dname, relerr, dict(fields, **extra))
            if not repeat or (name != 'block_apply' and not (same_values and extra['misaligned']['same_values'])):
                raise AssertionError(f'{name} ({dname}) differs from its plain version or between two launches')
            if dtype == torch.float64:
                results[name] = dict(fields, **{k: v for k, v in extra.items() if k == 'two_calls_ms'})
            del got, want
    return results


def mask_rows(name, m, x, y, dtype):
    """K14's split of the row (``ops/sparse.mask_plan``: the scalar head,
    16-byte vectors, scalar tail and grid; None for a package without it)
    and the same pass on views one entry into the operands (n - 1 entries,
    not a multiple of the vector width): its split, its values against the
    plain version's, its device time."""
    import torch
    from nutils_tpu_torch.ops import sparse
    n = int(x.shape[0])

    def plan(*tensors):
        if not hasattr(sparse, 'mask_plan'):
            return None
        return sparse.mask_plan(int(tensors[0].shape[0]), tensors[0].element_size(),
                                tuple(t.data_ptr() % 16 for t in tensors))
    z = torch.empty_like(x)
    mo, xo, yo, zo = m[1:], x[1:], y[1:], z[1:]
    if name == 'mask_pre':
        args, kernel, want = (mo, xo, zo), lambda: sparse.mask_pre(mo, xo, out=zo), sparse.mask_pre_plain(mo, xo)
        full = plan(m, x, z)
    else:
        args, kernel, want = (mo, yo, xo, zo), lambda: sparse.mask_post(mo, yo, xo, out=zo), \
            sparse.mask_post_plain(mo, yo, xo)
        full = plan(m, y, x, z)
    got = kernel()
    torch.cuda.synchronize()
    return dict(vector_path=full, misaligned=dict(n=n - 1, plan=plan(*args), same_values=bool((got == want).all()),
                                                  ms=time_ms(kernel)[0]))


def phase_elasticity_square(nelems=SQUARE_NELEMS):
    """The elasticity example on ``nelems``^2 squares at degree 2 (grid
    (2 nelems + 1, 2 nelems + 1, 2), 526,338 dofs at 256) in float64 with
    the same block-Jacobi CG: its masked operator has the 3-D stencil form
    of ks (2, 2, 1), 75 slots, so the CG graphs hold K13 beside the 3-D K1.
    Returns the launch counts of the run."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch.utils import config
    with config.floatx(numpy.float64), config.device('cuda'):
        reset_launches()
        t, (cons, u, _t, F, system) = _sync_time(
            lambda: tp.elasticity('nutils_tpu_torch', nelems, 'square', degree=2, **BLOCK_CG))
        launches = read_launches(SQUARE_KERNELS)
        # its stencil of ks (2, 2, 1) takes K1's generic form
        forms = read_forms('elasticity_square', {'stencil_matvec': 'generic'})
        jm = system._cache['jacmat']
        stats = dict(jm._solve_stats)
        mv_kind = jm._masked_solve_cache[1]._device_op()[0]
    chunk = stats.get('graph_launches', {}).get('chunk', {})
    force_error = float(numpy.abs(F - [0., 1.]).max())
    emit('elasticity_square', nelems=nelems * nelems, ndofs=int(u.size), seconds=t, op=[mv_kind[0], list(mv_kind[1]),
         list(mv_kind[2])], solve_stats=stats, F=F.tolist(), force_error=force_error, launches=launches,
         launches_by_form=forms)
    if mv_kind[0] != 'stencil' or tuple(mv_kind[1]) != (2, 2, 1) or len(mv_kind[2]) != 3:
        raise AssertionError(f'the square elasticity operator is {mv_kind}, not the 3-D stencil of ks (2, 2, 1)')
    if stats['precon'] != 'block' or not stats['accepted_on_device'] or not (
            chunk.get('block_apply', 0) > 0 and chunk.get('stencil_matvec', 0) > 0):
        raise AssertionError(f'the square elasticity CG went {stats}')
    missing = [name for name, count in launches.items() if count <= 0]
    if missing or not force_error < 1e-8:
        raise AssertionError(f'square elasticity: kernels not launched {missing}, force {F}')
    return launches


def phase_elasticity_parity(nelems=16, devices=('cuda', 'cpu')):
    """The elasticity example at ``nelems`` elements a side, triangles and
    squares at degree 2, in float64 with block-Jacobi CG, on the card and
    through the port's CPU path: u and t agree to 1e-10 relative."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch.utils import config
    for etype in ('triangle', 'square'):
        out = {}
        with config.floatx(numpy.float64):
            for device in devices:
                with config.device(device):
                    cons, u, t, F, system = tp.elasticity('nutils_tpu_torch', nelems, etype, degree=2, **BLOCK_CG)
                    out[device] = u, t, F, dict(system._cache['jacmat']._solve_stats)
        (ua, ta, Fa, sa), (ub, tb, Fb, sb) = (out[d] for d in devices)
        ru, rt = tp.rel(ua, ub), tp.rel(ta, tb)
        emit('elasticity_parity', etype=etype, nelems=nelems, ndofs=int(ub.size), rel_u=ru, rel_t=rt, tol=1e-10,
             F=[Fa.tolist(), Fb.tolist()], iters=[sa['iters'], sb['iters']], devices=list(devices))
        if not (ru <= 1e-10 and rt <= 1e-10 and sa['precon'] == 'block'):
            raise AssertionError(f'card and CPU elasticity ({etype}) differ: u {ru:.3e}, t {rt:.3e}')


ITER_LINE = r'\biter \d+: residual norm'


def smoothing_records(hierarchy):
    """Each smoothed level of a multigrid hierarchy (``ops/mg.MGData``, or
    None): its shape, Gershgorin bound, power-step estimate (None where the
    bound made it needless) and whether its diagonals were raised."""
    if hierarchy is None:
        return []
    return [{'shape': list(shape), 'bound': bound, 'estimate': lam, 'raised': raised}
            for shape, bound, lam, raised in hierarchy.smoothing]


def track_mg():
    """From here on, record every multigrid set-up: the ``phase_`` function
    that made it, its levels' smoothing records and the K1 launches it made
    (the power-step estimates', set-up and not solve); returns the list it
    fills.  Wraps ``ops/mg.setup``; nothing of the package changes."""
    from nutils_tpu_torch.ops import mg, stencil
    made = []
    setup = mg.setup

    def wrapper(*args, **kwargs):
        before = stencil.stencil_matvec.launches
        out = setup(*args, **kwargs)
        frame = sys._getframe(1)
        while frame is not None and not frame.f_code.co_name.startswith('phase_'):
            frame = frame.f_back
        made.append({'phase': frame and frame.f_code.co_name, 'levels': smoothing_records(out),
                     'k1_launches': stencil.stencil_matvec.launches - before})
        return out
    mg.setup = wrapper
    return made


def mg_summary(made):
    """The multigrid set-ups of a run by phase: their number, the K1
    launches their estimates made, and each level shape's Gershgorin
    bounds and estimates (least and most) and how many set-ups raised its
    diagonals."""
    out = {}
    for rec in made:
        phase = out.setdefault(rec['phase'], {'setups': 0, 'k1_launches': 0, 'levels': {}})
        phase['setups'] += 1
        phase['k1_launches'] += rec['k1_launches']
        for level in rec['levels']:
            agg = phase['levels'].setdefault(str(level['shape']), {'bound': [], 'estimate': [], 'estimated': 0,
                                                                    'raised': 0})
            if level['bound'] is not None:
                agg['bound'].append(level['bound'])
            if level['estimate'] is not None:
                agg['estimate'].append(level['estimate'])
                agg['estimated'] += 1
            agg['raised'] += bool(level['raised'])
    for phase in out.values():
        for agg in phase['levels'].values():
            for key in ('bound', 'estimate'):
                agg[key] = [min(agg[key]), max(agg[key])] if agg[key] else None
    return out


def k15_counts():
    """[elem_value's launches, its finishing ones, elem_value_sum's]."""
    from nutils_tpu_torch.ops import assembly
    return [assembly.elem_value.launches, assembly.elem_value.forms.get('finish', 0), assembly.elem_value_sum.launches]


@contextlib.contextmanager
def solve_events(on_iter=None):
    """Record, while the block is open, what a nonlinear solve does, in
    order: each assembly of the jacobian and residual (its time and the
    residual's norm), each value assembly (time, value, K15's launches),
    the constrained solve's parts (the host masked operator, its operator
    form, the multigrid hierarchy and its levels' smoothing records, the
    preconditioner, the device Krylov solve and its record, the whole
    solve), the submatrix products, and the solver's log lines.
    Yields the list of events (dicts, ``ev`` the
    kind, ``t`` seconds); ``on_iter`` (where given) is called with the
    events of each iteration as the solver logs its end.  Wraps the
    methods; nothing of the package changes."""
    import logging
    import re
    import numpy
    import torch
    from nutils_tpu_torch import matrix, solver
    from nutils_tpu_torch.ops import assembly
    events = []

    def timed(cls, name, kind, extra=None):
        fn = getattr(cls, name)

        def wrapper(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            event = {'ev': kind, 't': time.perf_counter() - t0}
            if extra is not None:
                event.update(extra(self, out))
            events.append(event)
            return out
        return cls, name, fn, wrapper

    def value_extra(_self, out):
        return {'value': out, 'k15': k15_counts()}
    patches = [
        timed(solver.System, 'assemble_jacobian_residual', 'jacres',
              lambda _s, out: {'resnorm': float(numpy.linalg.norm(out[1]))}),
        timed(solver.System, 'assemble_value', 'value', value_extra),
        timed(matrix.Matrix, '_masked', 'mask'),
        timed(matrix.Matrix, '_device_op', 'op_form'),
        timed(matrix.Matrix, '_mg', 'mg', lambda _m, out: {'smoothing': smoothing_records(out)}),
        timed(matrix.Matrix, '_device_precon', 'precon'),
        timed(matrix.Matrix, '_device_krylov', 'krylov', lambda m, _out: {'stats': dict(m._solve_stats)}),
        timed(matrix._SubMatrix, 'solve', 'solve', lambda m, _out: {'stats': dict(m._solve_stats or {})}),
        timed(matrix._SubMatrix, '__matmul__', 'matvec'),
    ]

    cut = [0]

    class Handler(logging.Handler):
        def emit(self, record):
            events.append({'ev': 'log', 't': 0., 'msg': record.getMessage()})
            if on_iter is not None and re.search(ITER_LINE, events[-1]['msg']):
                on_iter(events[cut[0]:])
                cut[0] = len(events)
    logger = logging.getLogger('nutils_tpu_torch')
    handler, level = Handler(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    for cls, name, _fn, wrapper in patches:
        setattr(cls, name, wrapper)
    try:
        yield events
    finally:
        for cls, name, fn, _wrapper in patches:
            setattr(cls, name, fn)
        logger.removeHandler(handler)
        logger.setLevel(level)


def iteration_summary(k, evs):
    """The events of Minimize iteration ``k`` (iteration 0: the first
    assembly) summed up: its trials' relaxations, energies and residual
    norms, K15's launches in each value assembly, the times of its parts
    and its inner solve's record."""
    import re

    def total(kind):
        return sum(e['t'] for e in evs if e['ev'] == kind)
    values = [e for e in evs if e['ev'] == 'value']
    krylov = [e['stats'] for e in evs if e['ev'] == 'krylov']
    trials = [m['msg'] for m in evs if m['ev'] == 'log' and ' / e' in m['msg']]
    norms = [e['resnorm'] for e in evs if e['ev'] == 'jacres']
    return dict(
        iteration=k, resnorm=norms[-1] if norms else None, trial_resnorms=norms,
        energies=[e['value'] for e in values], trials=len(values),
        relaxations=[float(re.search(r'/ e([-+][0-9.]+)', m).group(1)) for m in trials],
        t_assemble=total('jacres'), t_value=total('value'), t_mask=total('mask'), t_op_form=total('op_form'),
        t_mg=total('mg'), t_precon=total('precon'), t_krylov=total('krylov'), t_solve=total('solve'),
        t_matvec=total('matvec'), solve_stats=krylov[-1] if krylov else None,
        solve_record=next((e['stats'] for e in reversed(evs) if e['ev'] == 'solve'), None),
        smoothing=[level for e in evs if e['ev'] == 'mg' for level in e['smoothing']],
        spectrum=[m['msg'].split('> ')[-1] for m in evs if m['ev'] == 'log' and 'spectrum' in m['msg']],
        k15_per_value=[e.get('k15_delta') for e in values])


def check_planned_galerkin(masked):
    """The finest Galerkin product of a masked operator as the multigrid
    set-up takes it (``ops/mg.galerkin``) at a pattern's first meeting
    (this machine's scipy), its second (the plan made on the card, then
    used) and its third (the plan used), the last bit for bit the first
    (the zeros that scipy drops left out); emits the three times and
    returns whether they are equal."""
    import numpy
    from nutils_tpu_torch.ops import mg
    shape = masked._mg().levels[0][1]
    P = next(P for key, P in masked._pattern_of()._mg_plans.items() if key[0] == 'P' and key[1] == shape)
    A = masked._scipy()
    plans, device = {}, masked._device_op()[1][0].device
    t_scipy, want = _sync_time(lambda: mg.galerkin(plans, 0, A, P, device))
    t_plan = _sync_time(lambda: mg.galerkin(plans, 0, A, P, device))[0]
    t_planned, got = _sync_time(lambda: mg.galerkin(plans, 0, A, P, device))
    got.eliminate_zeros()
    equal = bool(numpy.array_equal(got.indptr, want.indptr) and numpy.array_equal(got.indices, want.indices)
                 and got.data.tobytes() == want.data.tobytes())
    emit('finitestrain_galerkin', shape=list(shape), nnz=int(A.nnz), coarse_nnz=int(want.nnz), t_scipy=t_scipy,
         t_plan_and_values=t_plan, t_planned=t_planned, bitwise_equal=equal)
    del plans
    return equal


def phase_finitestrain(nelems=FINITESTRAIN_NELEMS):
    """examples/finitestrain.py on ``unitsquare(nelems, 'square')`` at degree
    1, untrimmed (518,400 elements at 720, 1,039,682 dofs), in float64,
    through the port's entry points: ``solve_constraints`` (the left and
    right edges clamped), the linear solve ``System.solve(constrain=cons)``,
    then ``System.solve(arguments=args0, constrain=cons,
    method=Minimize(), tol=1e-10)`` on the finite-strain energy, whose
    every line-search trial assembles the jacobian, the residual and the
    value (K15).  Per Minimize iteration: the residual norm, the energies,
    the relaxations, the inner solve's record, ``t_assemble``, ``t_value``,
    the set-up of the constrained solve (host masked operator, its operator
    form, the multigrid hierarchy, the preconditioner) and the Krylov
    solve.  K15 must launch in every value assembly, no plain version may
    run, and the residual must reach 1e-10.  Returns (launch counts, the
    System, its converged arguments, its value there)."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch.ops import assembly
    from nutils_tpu_torch.solver import Minimize, System
    from nutils_tpu_torch.utils import config
    with config.floatx(numpy.float64), config.device('cuda'):
        t_forms, (_domain, _ns, sqr, energy, energy1) = _sync_time(
            lambda: tp.finitestrain_forms('nutils_tpu_torch', nelems, 'square', 'std', 1, .25, 20.))
        t_system, (scons, linear, system) = _sync_time(
            lambda: (System(sqr, trial='u'), System(energy, trial='u'), System(energy1, trial='u')))
        ndofs = int(numpy.prod(system.trial_shapes[0]))
        emit('finitestrain_system', nelems=nelems * nelems, ndofs=ndofs, t_forms=t_forms, t_system=t_system,
             jacobian_form=(system._jac_layout[2] or {'form': 'csr'})['form'])
        check_routes('finitestrain', system)
        t_cons, cons = _sync_time(lambda: scons.solve_constraints(droptol=1e-15))
        constrained = int(numpy.isfinite(cons['u']).sum())
        emit('finitestrain_cons', t_cons=t_cons, constrained=constrained,
             solve_stats=scons._cache['jacmat']._solve_stats)
        if constrained != 4 * (nelems + 1):
            raise AssertionError(f'solve_constraints constrained {constrained} dofs, expected {4 * (nelems + 1)}')
        with solve_events() as lin_events:
            t_linear, args0 = _sync_time(lambda: linear.solve(constrain=cons))
        emit('finitestrain_linear', t_solve_entry=t_linear, parts=iteration_summary(0, lin_events))
        reset_launches()
        iterations = []
        k15 = [k15_counts()]

        def on_iter(evs):
            for e in evs:
                if e['ev'] == 'value':  # K15's launches in each value assembly
                    e['k15_delta'] = [b - a for a, b in zip(k15[0], e['k15'])]
                    k15[0] = e['k15']
            iterations.append(iteration_summary(len(iterations), evs))
            emit('finitestrain_iter', **iterations[-1])
        with plain_calls() as plain, solve_events(on_iter) as events:
            t_minimize, args1 = _sync_time(lambda: system.solve(arguments=args0, constrain=cons, method=Minimize(),
                                                                tol=1e-10))
            launches = read_launches(tuple(wrappers()))
            launches['elem_value[finish]'] = assembly.elem_value.forms['finish']
            # every level of the vector field's hierarchy smooths in K2's
            # component form, its operators' products in K1's tiled form
            forms = read_forms('finitestrain', {'stencil_matvec': 'tile', 'jacobi_pre': 'components',
                                                'jacobi_post': 'components'})
        values = [e for e in events if e['ev'] == 'value']
        arguments, x = system.deconstruct(args1, cons)
        jac, res = system.assemble_jacobian_residual(arguments, x)
        resnorm = float(numpy.linalg.norm(res))
        value = system.assemble_value(args1)
        u0, u1 = args0['u'], args1['u']
        # the line searches' jac @ dx: through the parent's device operator,
        # beside the scipy submatrix's product (what it replaced)
        v = numpy.random.default_rng(43).standard_normal(len(x))
        t_device_first, y = _sync_time(lambda: jac @ v)
        t_device = _sync_time(lambda: jac @ v)[0]
        t_scipy, y_scipy = _sync_time(lambda: jac._parent._scipy()[jac._mask][:, jac._mask] @ v)
        rel_matvec = tp.rel(y, y_scipy)
        emit('finitestrain_matvec', t_device_first=t_device_first, t_device=t_device, t_scipy_submatrix=t_scipy,
             rel=rel_matvec, tol=1e-12)
        # one inner solve as Minimize makes it, on the converged jacobian
        # (a first call sets up its masked operator and hierarchy), under
        # the profiler: its wall and device-busy time, and the device time
        # of K2's launches and of K1's, by kernel name
        rhs = numpy.random.default_rng(44).standard_normal(len(x))
        jac.solve_leniently(rhs, symmetric=True)
        wall, kernels, _full, _dx = profiled(lambda: jac.solve_leniently(rhs, symmetric=True))
        emit('finitestrain_solve_profile', wall_s=wall, device_busy_s=busy_s(kernels),
             busy_share=busy_s(kernels) / wall, kernel_launches=sum(e.count for e in kernels),
             k2_device_s=busy_s([e for e in kernels if 'jacobi' in e.key]),
             k1_device_s=busy_s([e for e in kernels if 'stencil' in e.key]), solve_stats=jac._solve_stats)
        galerkin_equal = check_planned_galerkin(jac._parent._masked(jac._mask))
        del jac
    setup = sum(it['t_mask'] + it['t_op_form'] + it['t_mg'] + it['t_precon'] for it in iterations)
    emit('finitestrain', nelems=nelems * nelems, ndofs=ndofs, t_system=t_system, t_cons=t_cons,
         t_linear=t_linear, t_minimize=t_minimize, iterations=len(iterations) - 1,
         trials=sum(it['trials'] for it in iterations), resnorm=resnorm, tol=1e-10, value=value,
         t_assemble=sum(it['t_assemble'] for it in iterations), t_value=sum(it['t_value'] for it in iterations),
         t_setup=setup, t_krylov=sum(it['t_krylov'] for it in iterations),
         t_matvec=sum(it['t_matvec'] for it in iterations), launches={k: v for k, v in launches.items() if v},
         launches_by_form=forms, plain_calls=plain, u0_max=float(numpy.abs(u0).max()), u1_max=float(numpy.abs(u1).max()))
    if u1.shape != tuple(system.trial_shapes[0]) or not (numpy.isfinite(u0).all() and numpy.isfinite(u1).all()):
        raise AssertionError('finitestrain: the displacements are not finite arrays of the field\'s shape')
    if not resnorm <= 1e-10:
        raise AssertionError(f'finitestrain: residual norm {resnorm:.3e} above 1e-10')
    if not rel_matvec <= 1e-12:
        raise AssertionError(f'finitestrain: jac @ v through the device operator {rel_matvec:.3e} from scipy\'s')
    if not galerkin_equal:
        raise AssertionError('finitestrain: the planned Galerkin product differs from scipy\'s')
    # every value assembly: one finishing elem_value launch (its only one,
    # the functional being one part), no elem_value_sum launch
    short = [it['iteration'] for it in iterations
             if any(d[0] < 1 or d[1] != 1 or d[2] != 0 for d in it['k15_per_value'])]
    missing = [name for name in FINITESTRAIN_KERNELS if launches[name] <= 0]
    emit('finitestrain_launches', values=len(values), elem_value=launches['elem_value'],
         finishing=launches['elem_value[finish]'], elem_value_sum=launches['elem_value_sum'],
         elem_matrix=launches['elem_matrix'], elem_vector=launches['elem_vector'])
    if short or missing or plain or not values or launches['jacobi_smooth'] or launches['elem_value_sum'] \
            or launches['elem_value[finish]'] != len(values):
        raise AssertionError(f'finitestrain: not one finishing K15 launch in a value assembly in iterations {short} '
                             f'({launches["elem_value[finish]"]} for {len(values)} values, elem_value_sum '
                             f'{launches["elem_value_sum"]}), kernels not launched {missing}, plain versions run '
                             f'{plain}, single sweeps {launches["jacobi_smooth"]}')
    return launches, system, args1, value


def fold_row(f, label):
    """K15 on a value of one part ``f`` [E, P] as the value assembly takes
    it: one ``elem_value`` launch that finishes the value (``finish=``),
    against the two launches it replaces (``elem_value`` then
    ``elem_value_sum``, timed together from one CUDA graph) and its plain
    version: the same bits as both, the sha1 of the partials and the value
    (to compare with another package's at the same inputs), the time (from
    a CUDA graph, and ``call_ms`` of eager calls, host launches included,
    both for the two launches too), the bound (f read once, the partials
    and the value written once) and ``torch.sum``'s time.  In a package without the fold (an older
    checkout), the two launches' row alone.  Returns the fold's row."""
    import inspect
    import torch
    from nutils_tpu_torch.ops import assembly
    dname = str(f.dtype).split('.')[1]
    isz = f.element_size()
    E, P = f.shape
    nb = assembly.value_blocks(E, P)
    parts, total = torch.empty(nb, dtype=f.dtype, device=f.device), torch.empty(1, dtype=f.dtype, device=f.device)

    def two():
        assembly.elem_value(f, out=parts)
        assembly.elem_value_sum(parts, [0, nb], out=total)
    two()
    torch.cuda.synchronize()
    want_parts, want_total = parts.clone(), total.clone()
    two_ms, two_call_ms = time_ms(two)
    nbytes, flops = (E * P + nb + 1) * isz, E * P + nb
    peak = F32_FLOPS if f.dtype == torch.float32 else F64_FLOPS
    if 'finish' not in inspect.signature(assembly.elem_value).parameters:
        bound_ms, _by = bound(nbytes, flops, peak)
        emit('kernel', name='elem_value+elem_value_sum', case=label, dtype=dname, E=E, P=P, blocks=nb,
             two_launch_ms=two_ms, two_launch_call_ms=two_call_ms, bound_ms=bound_ms, sha1=digest(want_parts),
             value_sha1=digest(want_total))
        return None

    def fold():
        assembly.elem_value(f, out=parts, finish=(parts, [0, nb], total))
    before = assembly.elem_value.forms['finish']
    parts.zero_(), total.zero_()
    fold()
    torch.cuda.synchronize()
    launched = assembly.elem_value.forms['finish'] - before
    same = bool(torch.equal(parts, want_parts) and torch.equal(total, want_total))
    plain_parts = torch.empty_like(parts).cpu()
    plain_total = torch.empty(1, dtype=f.dtype)
    assembly.elem_value_plain(f.cpu(), out=plain_parts, finish=(plain_parts, [0, nb], plain_total))
    err, relerr = _compare(total.cpu(), plain_total, f.double().abs().sum())
    (ms, call_ms), (plain_ms, _pc) = time_ms(fold), time_ms(
        lambda: assembly.elem_value_plain(f, out=parts, finish=(parts, [0, nb], total)))
    fields = row(err, ms, plain_ms, nbytes, flops, time_ms(lambda: torch.sum(f))[0], peak)
    check_row('elem_value[finish]', label, dname, relerr, dict(
        fields, E=E, P=P, blocks=nb, call_ms=call_ms, two_launch_ms=two_ms, two_launch_call_ms=two_call_ms,
        same_bits_as_two_launches=same,
        finishing_launches=launched, sha1=digest(parts), value_sha1=digest(total)))
    if not (same and launched == 1):
        raise AssertionError(f'K15 fold ({label}, {dname}): the same bits as two launches {same}, '
                             f'{launched} finishing launches')
    return fields


def phase_finitestrain_kernels(system, args, value):
    """K15 against its plain version at the finite-strain path's shape (the
    integrand of its converged energy, 518,400 elements of 4 points), in
    float32 and float64: the error, two launches the same bits, the
    partials of element chunks (multiples of the span) written into their
    rows equal to one piece's, and the same through the System
    (``config.assembly_chunk``); the time (a CUDA graph of 10 calls), the
    bound and ``torch.sum``'s time; ``elem_value_sum`` (off the path) and
    the folded launch (:func:`fold_row`).  Returns {name: row} in float64,
    the path's dtype."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import assembly
    from nutils_tpu_torch.utils import config
    with config.floatx(numpy.float64), config.device('cuda'):
        dargs = system._device_args(system._clean(args))
        leaves = system._bound_leaves(dargs, {}, system._tables())
        form = next(part[1] for part in system._value_parts() if part[0] == 'form')
        f64 = form.integrand(dargs, leaves).contiguous()
        E, P = f64.shape
        span = assembly.value_span(P)
        # chunks of a multiple of the span: the largest divisor of the
        # blocks up to half of them (one block where there is one)
        ce = span * next((d for d in range(E // span // 2, 0, -1) if (E // span) % d == 0), 1)
        with config.assembly_chunk(ce):
            plan = system._chunk_plan()
            chunked_value = system.assemble_value(args)
    results = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split('.')[1]
        isz = 4 if dtype == torch.float32 else 8
        peak = F32_FLOPS if dtype == torch.float32 else F64_FLOPS
        f = f64.to(dtype)
        nb = assembly.value_blocks(E, P)
        parts = torch.empty(nb, dtype=dtype, device='cuda')
        out = torch.empty(1, dtype=dtype, device='cuda')
        got = assembly.elem_value(f).clone()
        again = assembly.elem_value(f)
        total = assembly.elem_value_sum(got, [0, nb]).clone()
        total_again = assembly.elem_value_sum(got, [0, nb])
        want = assembly.elem_value_plain(f)
        want_total = assembly.elem_value_sum_plain(want, [0, nb])
        chunked = torch.empty_like(got)
        nbc = ce // span
        for c, lo in enumerate(range(0, E, ce)):
            assembly.elem_value(f[lo:lo + ce], out=chunked[c * nbc:(c + 1) * nbc])
        torch.cuda.synchronize()
        repeat = bool(torch.equal(got, again) and torch.equal(total, total_again))
        chunk_equal = bool(torch.equal(chunked, got))
        err, relerr = _compare(got, want, f.double().abs().sum() / nb)
        terr, trelerr = _compare(total, want_total, f.double().abs().sum())
        cases = {'elem_value': (lambda: assembly.elem_value(f, out=parts), lambda: assembly.elem_value_plain(f),
                                lambda: torch.sum(f), E * P * isz + nb * isz, E * P, err, relerr),
                 'elem_value_sum': (lambda: assembly.elem_value_sum(got, [0, nb], out=out),
                                    lambda: assembly.elem_value_sum_plain(got, [0, nb]), lambda: torch.sum(got),
                                    nb * isz + isz, nb, terr, trelerr)}
        for name, (kernel, plain, library, nbytes, flops, e, rel) in cases.items():
            (ms, call_ms), (plain_ms, _pc) = time_ms(kernel), time_ms(plain)
            fields = row(e, ms, plain_ms, nbytes, flops, time_ms(library)[0], peak)
            check_row(name, 'finitestrain', dname, rel, dict(
                fields, E=E, P=P, span=span, blocks=nb, call_ms=call_ms, bitwise_repeat=repeat,
                chunks_bitwise_equal=chunk_equal, chunk=ce, same_bits_as_plain=bool(torch.equal(got, want))
                if name == 'elem_value' else bool(torch.equal(total, want_total))))
            if dtype == torch.float64:
                results[name] = fields
        if not (repeat and chunk_equal):
            raise AssertionError(f'K15 ({dname}): two launches the same bits {repeat}, chunks equal {chunk_equal}')
        fold = fold_row(f, 'finitestrain')
        if dtype == torch.float64:
            results['elem_value[finish]'] = fold
    emit('finitestrain_chunked_value', chunk=ce, chunks=plan['nc'] if plan else 1, value=value,
         chunked_value=chunked_value, bitwise_equal=chunked_value == value)
    if plan is None or chunked_value != value:
        raise AssertionError(f'finitestrain: the value in chunks of {ce} ({chunked_value!r}) is not one piece\'s '
                             f'({value!r})')
    return results


def phase_finitestrain_parity(nelems=16, devices=('cuda', 'cpu')):
    """The finite-strain example at ``nelems`` elements a side in float64 on
    the card and through the port's CPU path: u0 and u1 agree to 1e-10
    relative, and the values of the finite-strain energy at the CPU's u1 to
    1e-12."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch.utils import config
    out = {}
    with config.floatx(numpy.float64):
        for device in devices:
            with config.device(device):
                out[device] = tp.finitestrain('nutils_tpu_torch', nelems, angle=20.)
        at = {'u': out[devices[1]][2]}
        values = []
        for device in devices:
            with config.device(device):
                values.append(out[device][3].assemble_value(at))
    ru0 = tp.rel(out[devices[0]][1], out[devices[1]][1])
    ru1 = tp.rel(out[devices[0]][2], out[devices[1]][2])
    rv = abs(values[0] - values[1]) / abs(values[1])
    emit('finitestrain_parity', nelems=nelems, ndofs=int(out[devices[0]][2].size), rel_u0=ru0, rel_u1=ru1,
         rel_value=rv, values=values, tol_u=1e-10, tol_value=1e-12, devices=list(devices))
    if not (ru0 <= 1e-10 and ru1 <= 1e-10 and rv <= 1e-12):
        raise AssertionError(f'card and CPU finite strain differ: u0 {ru0:.3e}, u1 {ru1:.3e}, value {rv:.3e}')


# ------------------------------------------------------------ finite cells

# examples/platewithhole.py's finite cell problem: unitsquare(FCM_NELEMS)
# trimmed along the hole (radius .5, maxrefine 2), std basis of degree 2,
# float64; the jacobian in CSR form over three sample parts (whole squares,
# simplex and box subcells), assembled through K8, K11 and K12, solved on
# the card by the example's own call, for which ``auto`` picks GMRES with
# K7's diagonal (the System has tests v, so it is not symmetric)
FCM_NELEMS = 360
FCM_COARSE = 180
FCM_KERNELS = ('csr_scatter', 'csr_matvec', 'schur_diag_inverse_device') + GMRES_KERNELS + ASSEMBLY_KERNELS
# the H1 error between FCM_COARSE^2 and FCM_NELEMS^2: degree 2 alone would
# divide it by 4, but the trim snaps each cut to 1/256 of its leaf cell's
# edge (ndivisions 8: the hole's position is off by up to h/2048, first
# order in h), and from 128^2 on that error leads: the port's CPU direct
# solves give H1 2.897e-5, 9.643e-6, 7.162e-6 at 64^2, 128^2, 180^2 (local
# rates 1.59 and 0.87), so halving h from 180^2 divides it by 1.3-2.5
FCM_RATIO = (1.3, 2.5)


def fcm_problem(nelems):
    """examples/platewithhole.py's finite cell problem (``FCM`` mode,
    ``main`` without the figure) through the port at ``nelems`` elements a
    side, on the device and in the precision in force, step by step as the
    example makes its calls, each timed (host clock around synchronised
    work): a dict of the results and times; ``solve`` is the example's own
    call, ``System(res, trial='u', test='v').solve(constrain=cons)``."""
    import numpy
    from nutils_tpu_torch import function, mesh
    from nutils_tpu_torch.expression import Namespace
    from nutils_tpu_torch.solver import System
    radius, traction, poisson, degree = .5, .1, .3, 2
    out = {}
    clock = _sync_time

    def trimmed():
        topo0, geom = mesh.unitsquare(nelems, 'square')
        topo = topo0.trim(numpy.linalg.norm(geom) - radius, maxrefine=2, name='hole')
        return topo, geom, topo.basis('std', degree=degree)
    out['t_trim'], (topo, geom, basis) = clock(trimmed)
    topo = topo.withboundary(sym='left,bottom', far='top,right')
    out['topo'] = topo
    ns = Namespace()
    ns.δ = function.eye(topo.ndims)
    ns.x = geom
    ns.define_for('x', gradient='∇', normal='n', jacobians=('dV', 'dS'))
    ns.λ = 2 * poisson
    ns.μ = 1 - poisson
    ns.u = function.field('u', basis, shape=[2])
    ns.v = function.field('v', basis, shape=[2])
    ns.ε_ij = '(∇_j(u_i) + ∇_i(u_j)) / 2'
    ns.σ_ij = 'λ ε_kk δ_ij + 2 μ ε_ij'
    ns.r2 = 'x_k x_k'
    ns.R2 = radius**2 / ns.r2
    ns.k = (3 - poisson) / (1 + poisson)
    ns.scale = traction * (1 + poisson) / 2
    ns.uexact_i = 'scale (x_i ((k + 1) (.5 + R2) + (1 - R2) R2 (x_0^2 - 3 x_1^2) / r2) - 2 δ_i1 x_1 (1 + (k - 1 + R2) R2))'
    ns.du_i = 'u_i - uexact_i'
    ns.dr = function.sqrt(ns.r2) - radius
    out['ns'] = ns
    out['t_radiuserr'], radiuserr = clock(lambda: topo.boundary['hole'].integrate('dr^2 dS' @ ns, degree=9)**.5)
    out['radiuserr'] = float(radiuserr)
    sqr = topo.boundary['sym'].integral('(u_i n_i)^2 dS' @ ns, degree=degree*2)
    out['t_cons_sym'], cons = clock(lambda: System(sqr, trial='u').solve_constraints(droptol=1e-15))
    sqr = topo.boundary['far'].integral('du_k du_k dS' @ ns, degree=20)
    out['t_cons_far'], cons = clock(lambda: System(sqr, trial='u').solve_constraints(droptol=1e-15,
                                                                                     constrain=cons))
    out['cons'] = cons
    res = topo.integral('∇_j(v_i) σ_ij dV' @ ns, degree=degree*2)
    out['t_system'], system = clock(lambda: System(res, trial='u', test='v'))
    out['system'] = system
    out['solve'] = lambda: system.solve(constrain=cons)
    out['errors'] = lambda args: numpy.sqrt(topo.integrate(['du_k du_k dV', '∇_j(du_i) ∇_j(du_i) dV'] @ ns,
                                                           degree=max(degree, 3)*2, arguments=args))
    out['h1'] = lambda u: float(numpy.sqrt(topo.integrate('∇_j(u_i) ∇_j(u_i) dV' @ ns, degree=max(degree, 3)*2,
                                                          arguments={'u': u})))
    return out


def phase_fcm(nelems=FCM_NELEMS):
    """examples/platewithhole.py's finite cell solve at ``nelems``^2
    elements through the port on the card, in float64 (``fcm_problem``):
    the trim, its sample parts, the two ``solve_constraints`` calls, the
    System (every part's chunk on the factored route), the CSR pattern
    (the native sort), the first and warm assemblies, the first and warm
    ``System.solve(constrain=cons)`` (launch counts read around the first
    assembly and solve; the solve's record: accepted on the card from
    CUDA graphs, never demoted to the host with ``fallback_from``), a
    profile of a warm solve (its busy share), the L2 and H1 errors.
    Returns (launch counts, the System, its clean arguments, the
    jacobian)."""
    import numpy
    import torch
    from nutils_tpu_torch.utils import config
    with config.floatx(numpy.float64), config.device('cuda'):
        prob = fcm_problem(nelems)
        topo, system, cons = prob['topo'], prob['system'], prob['cons']
        smp = topo.sample('gauss', 4)
        parts = [dict(E=s.nelems, P=s.npoints_per_elem, kind=s.batch_key) for s in getattr(smp, 'samples', [smp])]
        ndofs = int(numpy.prod(system.trial_shapes[0]))
        constrained = int(numpy.isfinite(cons['u']).sum())
        emit('fcm_system', nelems=nelems, kept=len(topo), parts=parts, ndofs=ndofs, constrained=constrained,
             t_trim=prob['t_trim'], t_radiuserr=prob['t_radiuserr'], radiuserr=prob['radiuserr'],
             t_cons=dict(sym=prob['t_cons_sym'], far=prob['t_cons_far']), t_system=prob['t_system'])
        check_routes('fcm', system)
        t_layout, (_meta, lazy, jplan) = _sync_time(lambda: system._jac_layout)
        t_sort, pattern = _sync_time(lazy.get)
        if jplan is not None:
            raise AssertionError(f'fcm: planned a {jplan["form"]} jacobian, expected CSR')
        arguments, x = system.deconstruct({}, cons)
        reset_launches()
        with plain_calls() as plain:
            t_assemble_first, (jac, r) = _sync_time(lambda: system.assemble_jacobian_residual(arguments, x))
            clean = system._clean(system.construct(arguments, x))
            fn = system._compiled('jacres')
            t_assemble = min(_sync_time(lambda: fn(clean))[0] for _ in range(2))
            t_solve, args = _sync_time(prob['solve'])
            stats = dict(system._cache['jacmat']._solve_stats)
            launches = read_launches(FCM_KERNELS)
            t_solve_warm, args2 = _sync_time(prob['solve'])
            warm_stats = dict(system._cache['jacmat']._solve_stats)
        wall, kernels, _full, _out = profiled(prob['solve'])
        busy = busy_s(kernels)
        t_err, err = _sync_time(lambda: prob['errors'](args))
        u = args['u']
    emit('fcm', nelems=nelems, ndofs=ndofs, nnz=int(pattern.nnz), entries=int(len(pattern.slot)),
         pattern_backend=pattern.backend, assembly_routes=sorted(set(system._assembly_routes.values())),
         t_trim=prob['t_trim'], t_cons=dict(sym=prob['t_cons_sym'], far=prob['t_cons_far']),
         t_pattern=t_layout + t_sort, t_pattern_sort=t_sort, t_assemble_first=t_assemble_first,
         t_assemble=t_assemble, t_solve=t_solve, t_solve_warm=t_solve_warm, solve_stats=stats,
         warm_solve_stats=warm_stats, iters=stats.get('iters'), driver=stats.get('driver'),
         host_reads=stats.get('host_reads'), profiled_wall=wall, busy_s=busy, busy_share=busy / wall,
         launches=launches, plain_calls=plain, t_errors=t_err, err=[float(e) for e in err],
         same_warm=bool(numpy.array_equal(u, args2['u'])))
    if u.shape != tuple(system.trial_shapes[0]) or not numpy.isfinite(u).all() or not numpy.isfinite(err).all():
        raise AssertionError('fcm: the displacement or its errors are not finite')
    if pattern.backend != 'native':
        raise AssertionError(f'fcm: the pattern was sorted by {pattern.backend}, expected the native sort')
    for record in (stats, warm_stats):
        if 'fallback_from' in record or record.get('method') == 'direct':
            raise AssertionError(f'fcm: the solve was demoted to the host: {record}')
        check_driver('fcm', record)
    if (stats['method'], stats['precon']) != ('gmres', 'diag'):
        raise AssertionError(f'fcm: auto picked {stats["method"]} with {stats["precon"]}, expected GMRES with '
                             'the diagonal')
    missing = [name for name in FCM_KERNELS if launches[name] <= 0]
    if missing or plain:
        raise AssertionError(f'fcm: kernels not launched {missing}, plain versions run {plain}')
    return launches, system, clean, jac, float(err[1])


def phase_fcm_kernels(system, jac):
    """K8 and K9 against their plain versions at the finite cell path's
    shapes (its entry stream, whose subcells repeat their elements' slots;
    its CSR operator), in float64; returns {name: row}."""
    import numpy
    import torch
    from nutils_tpu_torch.ops import sparse
    rng = numpy.random.default_rng(17)
    pattern = system._jac_layout[1].get()
    data, _none, indices, indptr = jac._parent._csr_tables() if hasattr(jac, '_parent') else jac._csr_tables()
    data = data.to(torch.float64)
    dev = data.device
    n, nnz, m = int(indptr.shape[0]) - 1, int(indices.shape[0]), len(pattern.slot)
    order, segptr = (torch.as_tensor(a.astype(numpy.int32), device=dev) for a in (pattern._order, pattern._segptr))
    slot = torch.as_tensor(pattern.slot, device=dev)
    results = {}
    values = torch.as_tensor(rng.standard_normal(m), dtype=torch.float64, device=dev)
    got, want = sparse.csr_scatter(values, order, segptr, slot), sparse.scatter_plain(values, slot, nnz)
    scale = sparse.scatter_plain(values.abs(), slot, nnz).max()
    torch.cuda.synchronize()
    err, relerr = _compare(got, want, scale)
    (ms, call_ms), (plain_ms, _pc) = time_ms(lambda: sparse.csr_scatter(values, order, segptr, slot)), \
        time_ms(lambda: sparse.scatter_plain(values, slot, nnz))
    lib = time_ms(lambda: torch.zeros(nnz, dtype=torch.float64, device=dev).index_add_(0, slot, values))[0]
    fields = row(err, ms, plain_ms, m * (8 + 4) + nnz * 8, m, lib, F64_FLOPS)
    seglen = numpy.diff(pattern._segptr)
    check_row('csr_scatter', 'fcm', 'float64', relerr,
              dict(fields, entries=m, nnz=nnz, call_ms=call_ms, max_entries_a_slot=int(seglen.max()),
                   mean_entries_a_slot=float(seglen.mean())))
    results['csr_scatter'] = fields
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float64, device=dev)
    got, want = sparse.csr_matvec(data, indices, indptr, x), sparse.csr_matvec_plain(data, indices, indptr, x)
    scale = sparse.csr_matvec_plain(data.abs(), indices, indptr, x.abs()).max()
    torch.cuda.synchronize()
    err, relerr = _compare(got, want, scale)
    (ms, call_ms), (plain_ms, _pc) = time_ms(lambda: sparse.csr_matvec(data, indices, indptr, x)), \
        time_ms(lambda: sparse.csr_matvec_plain(data, indices, indptr, x))
    A = torch.sparse_csr_tensor(indptr, indices, data, size=(n, n))
    lib = time_ms(lambda: torch.mv(A, x))[0]
    fields = row(err, ms, plain_ms, nnz * (8 + 4) + (n + 1) * 4 + 2 * n * 8, 2 * nnz, lib, F64_FLOPS)
    check_row('csr_matvec', 'fcm', 'float64', relerr, dict(fields, n=n, nnz=nnz, call_ms=call_ms))
    results['csr_matvec'] = fields
    return results


def phase_fcm_ratio(h1_fine, nelems=FCM_COARSE):
    """The same finite cell solve at ``nelems``^2 elements on the card, and
    the same System solved on the host by scipy's direct solver: the
    card's Krylov solve held against an exact one in the H1 seminorm, to
    1e-5 of the solution's (GMRES stops at rtol 1e-11 of a matrix whose
    tiny cut cells make it ill-conditioned: on the CPU the two solutions
    differ by 3.0e-10 at 32^2 and 2.0e-7 at 64^2 in that seminorm, while
    the dofs of the tiniest cells, which the seminorm barely sees, differ
    by 1.4e-8 and 21% of |u|), and their H1 errors to 1e-4; the H1 error
    over the fine mesh's must lie in FCM_RATIO."""
    import numpy
    from nutils_tpu_torch.solver import Direct
    from nutils_tpu_torch.utils import config
    with config.floatx(numpy.float64), config.device('cuda'):
        prob = fcm_problem(nelems)
        t_solve, args = _sync_time(prob['solve'])
        stats = dict(prob['system']._cache['jacmat']._solve_stats)
        err = prob['errors'](args)
        t_direct, direct = _sync_time(lambda: prob['system'].solve(constrain=prob['cons'],
                                                                    method=Direct(solver='direct')))
        err_direct = prob['errors'](direct)
        rel_h1_u = prob['h1'](args['u'] - direct['u']) / prob['h1'](direct['u'])
    ratio = float(err[1]) / h1_fine
    rel_u = float(numpy.linalg.norm(args['u'] - direct['u']) / numpy.linalg.norm(direct['u']))
    rel_h1 = abs(float(err[1]) / float(err_direct[1]) - 1)
    emit('fcm_ratio', nelems=nelems, err=[float(e) for e in err], err_direct=[float(e) for e in err_direct],
         rel_h1_seminorm_direct=rel_h1_u, rel_u_direct=rel_u, rel_h1_error_direct=rel_h1, t_direct=t_direct,
         h1_fine=h1_fine, ratio=ratio, bounds=FCM_RATIO, radiuserr=prob['radiuserr'], t_trim=prob['t_trim'],
         t_solve=t_solve, iters=stats.get('iters'), solve_stats=stats)
    if 'fallback_from' in stats or not (rel_h1_u <= 1e-5 and rel_h1 <= 1e-4):
        raise AssertionError(f'fcm at {nelems}^2: the card\'s solve is {rel_h1_u:.3e} from the direct one in H1 '
                             f'(its H1 error {rel_h1:.3e}); solve {stats}')
    if not FCM_RATIO[0] < ratio < FCM_RATIO[1]:
        raise AssertionError(f'fcm: H1 error ratio {ratio:.3f} between {nelems}^2 and the fine mesh, expected '
                             f'{FCM_RATIO}')


def phase_fcm_parity(devices=('cuda', 'cpu')):
    """The finite cell plate at 4 and 16 elements (std basis) and 4 (the
    spline basis), in float64, on the card and through the port's CPU
    path: cons and the errors agree to 1e-10, u to 1e-9 in the H1
    seminorm; the spline case also passes the example's ``test_spline``
    assertions (errors to 5 places, cons and u through
    ``testing.assertAlmostEqual64``).  The two sides' matrices differ in
    their last bits (sums in another order), and u carries that difference
    times the matrix's condition number, which tiny cut cells make large:
    1.5e-6 of |u| at 16 elements in the Euclidean norm, mostly in the dofs
    of the tiniest cells, 1.2e-10 in the H1 seminorm the problem
    measures (4.3e-13 at 4 elements)."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch import testing
    from nutils_tpu_torch.utils import config
    for nelems, btype in ((4, 'std'), (16, 'std'), (4, 'spline')):
        out = {}
        with config.floatx(numpy.float64):
            for device in devices:
                with config.device(device):
                    out[device] = tp.platewithhole_fcm('nutils_tpu_torch', nelems, btype=btype)
        a, b = (out[d] for d in devices)
        with config.floatx(numpy.float64), config.device(devices[-1]):
            h1 = lambda u: float(numpy.sqrt(b['topo'].integrate('∇_j(u_i) ∇_j(u_i) dV' @ b['ns'], degree=6,
                                                                arguments={'u': u})))
            rel_h1 = h1(a['u'] - b['u']) / h1(b['u'])
        rel = dict(cons=tp.rel(numpy.nan_to_num(a['cons']), numpy.nan_to_num(b['cons'])),
                   err=tp.rel(a['err'], b['err']))
        same_mask = bool(numpy.array_equal(numpy.isnan(a['cons']), numpy.isnan(b['cons'])))
        emit('fcm_parity', nelems=nelems, btype=btype, ndofs=int(a['u'].size), rel=rel, tol=1e-10,
             rel_u_h1=rel_h1, tol_u_h1=1e-9, rel_u_euclidean=tp.rel(a['u'], b['u']), same_constraints=same_mask,
             err=[a['err'].tolist(), b['err'].tolist()], devices=list(devices))
        if not (same_mask and max(rel.values()) <= 1e-10 and rel_h1 <= 1e-9):
            raise AssertionError(f'card and CPU finite cell plates ({nelems}, {btype}) differ: {rel}, u {rel_h1:.3e} '
                                 'in the H1 seminorm')
        if btype == 'spline':
            tp.example_assertions('platewithhole', 'test_spline', testing, err=a['err'], cons={'u': a['cons']},
                                  args=a['args'])
            emit('fcm_regression', example='platewithhole', method='test_spline', device=devices[0], ok=True)


def phase_hier_parity(devices=('cuda', 'cpu')):
    """examples/adaptivity.py at ``nrefine=2`` (square elements, h-std
    degree 2, THB refinement by the residual indicator) on the card and
    through the port's CPU path: the errors and u agree to 1e-10, and the
    card's pass the example's own regression values
    (``test_square_quadratic``)."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch import testing
    from nutils_tpu_torch.utils import config
    out = {}
    with config.floatx(numpy.float64):
        for device in devices:
            with config.device(device):
                t, (error, u, system) = _sync_time(lambda: tp.adaptivity('nutils_tpu_torch', nrefine=2))
                out[device] = error, u, t, system._cache['jacmat']._solve_stats
    (ea, ua, ta, sa), (eb, ub, tb, sb) = (out[d] for d in devices)
    rel = dict(u=tp.rel(ua, ub), err=tp.rel(ea, eb))
    emit('hier_parity', ndofs=int(ua.size), rel=rel, tol=1e-10, err=[ea.tolist(), eb.tolist()], seconds=[ta, tb],
         solve_stats=[dict(sa), dict(sb)], devices=list(devices))
    if not max(rel.values()) <= 1e-10:
        raise AssertionError(f'card and CPU adaptivity differ: {rel}')
    tp.example_assertions('adaptivity', 'test_square_quadratic', testing, error=ea, u=ua)
    emit('hier_regression', example='adaptivity', method='test_square_quadratic', device=devices[0], ok=True)


# ------------------------------------------------------------ cahnhilliard

# examples/cahnhilliard.py on the multipatch unit circle: the example's
# defaults (size 10 cm, epsilon 1 mm, so its nmin is 100) at twice its
# interface resolution, degree 1: 5 x 200^2 elements, 400,802 unknowns.  At
# 400 (1,601,602 unknowns) the three steps took 653 s on the card (GMRES
# 3,000-60,000 iterations a solve), more than the whole script's limit
# leaves (PERF.md)
CH_NELEMS = 200
CH_STEPS = 3
# the inner solves: GMRES with K7's Schur-aware diagonal, passed through
# step's solve arguments; auto's CG on the indefinite Hessian (a positive
# phi block, a negative eta block) misses its tolerance and is demoted to a
# host direct solve (ROADMAP Queue C)
CH_SOLVER = 'gmres'
CH_KERNELS = ('csr_scatter', 'csr_matvec', 'schur_diag_inverse_device') + GMRES_KERNELS + ASSEMBLY_KERNELS


def cahnhilliard_runs(events):
    """The Newton runs of a step (one, or three and more where it halved)
    from its ``solve_events`` and the ``run``, ``run_end`` and
    ``newton_solve`` events the phase adds: each run's timestep, whether it
    converged, and its iterations (the assembly's time and residual norm,
    the value assemblies' time, the inner solve's time, tolerance,
    iterations, driver, host reads, acceptance and record)."""
    runs, cur = [], None
    for e in events:
        if e['ev'] == 'run':
            runs.append(dict(dt=e['dt'], converged=None, iterations=[]))
        elif not runs:
            continue
        elif e['ev'] == 'run_end':
            runs[-1]['converged'] = e['ok']
        elif e['ev'] == 'jacres':
            cur = dict(t_assemble=e['t'], resnorm=e['resnorm'], t_value=0.)
            runs[-1]['iterations'].append(cur)
        elif cur is None:
            continue
        elif e['ev'] == 'value':
            cur['t_value'] += e['t']
        elif e['ev'] == 'newton_solve':
            stats = e['stats']
            cur.update(t_solve=e['t'], rtol=e['rtol'], iters=stats.get('iters'), driver=stats.get('driver'),
                       host_reads=stats.get('host_reads'), accepted=stats.get('accepted_on_device'),
                       solve_stats=stats)
    return runs


# the example's defaults; the flux plot's points located on a grid of
# spacing 1/20, not main's 1/40: a point outside the disk runs every
# candidate rank (32 x 30 Newton evaluations, host-bound), and at 1/40 the
# locate took 91 s, which put the two phases over their 180 s (PERF.md)
CH_PROBLEM = dict(degree=1, epsilon='1mm', mobility='1mL*s/kg', timestep='.1s', gridstep=1/20)


def phase_cahnhilliard(nelems=CH_NELEMS, steps=CH_STEPS, problem=CH_PROBLEM):
    """examples/cahnhilliard.py's problem on ``unitcircle(nelems,
    'multipatch')`` at degree 1 with the example's defaults, built through
    the port on the card in float64 as ``main`` builds it
    (``_torch_parity.cahnhilliard``, no figures): the mesh (its spline
    projection a System.solve on the card), the energies, the locate of
    the flux plot's points (Newton over candidate elements; a grid of
    spacing 1/20, ``CH_PROBLEM``), the
    System on the factored route with a CSR jacobian, then ``steps`` of
    ``main``'s ``System.step`` with GMRES and K7's diagonal passed through
    the step (``CH_SOLVER``), the energy split before each step and the
    flux at the located points after it; the third step profiled.
    Asserts every inner solve run on the card from CUDA graphs (no
    ``fallback_from``) and, in the Newton runs a step keeps, accepted there
    (a run that fails is retried at half the timestep by ``step`` itself,
    as the example does, and its solves are recorded), the kernels
    launched in every step, and the mass conserved: the change of the
    integral of phi over a Newton run is ``-mass_scale`` times the sum of
    the eta residual's entries (exactly: the eta equation tested with a
    constant), so a step's is at most ``mass_scale sqrt(n_eta)`` times the
    Newton tolerance of 1 for each run it keeps.  Returns the launches of
    each step."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch import function, matrix, solver, unstructured
    from nutils_tpu_torch.utils import config
    times, locate_stats, events = {}, {}, {}
    lines = []

    def clock(name, fn):
        if name == 'unitcircle':
            with solve_events() as evs:
                times[name], out = _sync_time(fn)
            events[name] = [e['stats'] for e in evs if e['ev'] == 'krylov']
            return out
        times[name], out = _sync_time(fn)
        return out
    newton_locate = unstructured.newton_locate
    unstructured.newton_locate = lambda *a, **k: newton_locate(*a, _stats=locate_stats, **k)
    try:
        with config.floatx(numpy.float64), config.device('cuda'):
            with counted_set_up() as made, plain_calls() as plain:
                prob = tp.cahnhilliard('nutils_tpu_torch', nelems=nelems, clock=clock, **problem)
                system, domain = prob['system'], prob['domain']
                nphi = int(numpy.prod(system.trial_shapes[0]))
                neta = int(numpy.prod(system.trial_shapes[1]))
                smp = domain.sample('gauss', 4)
                parts = [dict(E=s.nelems, P=s.npoints_per_elem, kind=str(s.batch_key))
                         for s in getattr(smp, 'samples', [smp])]
                emit('cahnhilliard_setup', nelems=nelems, elements=len(domain), ndofs=[nphi, neta],
                     t_unitcircle=times['unitcircle'], unitcircle_solves=events['unitcircle'],
                     t_locate=times['locate'], located=locate_stats.get('found'), points=prob['grid'].npoints,
                     locate=locate_stats, t_system=times['system'], parts=parts)
                check_routes('cahnhilliard', system)
                t_layout, (_meta, lazy, jplan) = _sync_time(lambda: system._jac_layout)
                t_sort, pattern = _sync_time(lazy.get)
                if jplan is not None:
                    raise AssertionError(f'cahnhilliard: planned a {jplan["form"]} jacobian, expected CSR')
                args = prob['args']
                method = solver.Newton(solver=CH_SOLVER)
                sink = [[]]
                solve_leniently, system_solve = matrix.Matrix.solve_leniently, system.solve

                def recorded(jac, res, **kw):
                    t, out = _sync_time(lambda: solve_leniently(jac, res, **kw))
                    sink[0].append({'ev': 'newton_solve', 't': t, 'rtol': kw.get('rtol'),
                                    'stats': dict(jac._solve_stats)})
                    return out

                def marked(**kw):
                    sink[0].append({'ev': 'run', 'dt': float(kw['arguments']['dt'])})
                    try:
                        out = system_solve(**kw)
                    except Exception:
                        sink[0].append({'ev': 'run_end', 'ok': False})
                        raise
                    sink[0].append({'ev': 'run_end', 'ok': True})
                    return out
                matrix.Matrix.solve_leniently = recorded
                system.solve = marked
                try:
                    for k in range(steps):
                        energies = prob['energies'](args)
                        mass0 = prob['mass'](args)
                        reset_launches()
                        run = lambda: prob['step'](args, method=method)
                        with solve_events() as evs:
                            sink[0] = evs
                            if k == steps - 1:
                                t_step, kernels, _full, new = profiled(run)
                                busy = busy_s(kernels)
                            else:
                                t_step, new = _sync_time(run)
                                busy = None
                        launches = read_launches(CH_KERNELS + VALUE_KERNELS)
                        runs = cahnhilliard_runs(evs)
                        kept = [run for run in runs if run['converged']]
                        t_flux, flux = _sync_time(lambda: prob['flux'](new))
                        dmass = prob['mass'](new) - mass0
                        r = numpy.asarray(system.assemble_residual(dict(new, dt=new['dt'])))
                        lines.append(dict(step=k, t_step=t_step,
                                          newton_iterations=sum(len(run['iterations']) - 1 for run in kept),
                                          retries=len(runs) - len(kept), timesteps=[run['dt'] for run in runs],
                                          runs=runs, energies=energies, mass=mass0, dmass=dmass,
                                          dmass_last_run=-prob['mass_scale'] * float(r[nphi:].sum()),
                                          dmass_bound=prob['mass_scale'] * neta ** .5 * len(kept),
                                          t_flux=t_flux, flux_max=float(numpy.hypot(*flux.T).max()),
                                          busy_s=busy, busy_share=None if busy is None else busy / t_step,
                                          launches=launches))
                        emit('cahnhilliard', **lines[-1])
                        args = new
                finally:
                    matrix.Matrix.solve_leniently = solve_leniently
                    del system.solve
            energies = prob['energies'](args)
            phi = args['φ']
    finally:
        unstructured.newton_locate = newton_locate
    records = [(line['step'], run, it['solve_stats']) for line in lines for run in line['runs']
               for it in run['iterations'] if 'solve_stats' in it]
    emit('cahnhilliard_summary', nelems=nelems, ndofs=nphi + neta, nnz=int(pattern.nnz), t_pattern=t_layout + t_sort,
         t_pattern_sort=t_sort, pattern_backend=pattern.backend, op_form=sorted({r['op_form'] for _k, _r, r in records}),
         solves=len(records), solves_missed=sum(not r['accepted_on_device'] for _k, _r, r in records),
         assembly_routes=sorted(set(system._assembly_routes.values())), solver=f'{CH_SOLVER} with K7\'s diagonal',
         energies=energies, set_up=made, plain_calls=plain)
    if phi.shape != (nphi,) or not numpy.isfinite(phi).all() or not numpy.isfinite(energies).all():
        raise AssertionError('cahnhilliard: the phase field or its energies are not finite')
    if sorted(set(system._assembly_routes.values())) != ['factored']:
        raise AssertionError(f'cahnhilliard: assembly routes {system._assembly_routes}')
    if pattern.backend != 'native' or plain:
        raise AssertionError(f'cahnhilliard: pattern sorted by {pattern.backend}, plain versions run {plain}')
    for k, run, record in records:
        # every inner solve ran on the card from graphs, none was demoted to
        # the host; those of the runs a step keeps met their tolerance (a
        # run that failed, and that the step retried at half its timestep,
        # may hold solves that missed theirs)
        if 'fallback_from' in record or (record['method'], record['op_form']) != (CH_SOLVER, 'csr') \
                or record.get('driver') != 'graph':
            raise AssertionError(f'cahnhilliard step {k}: {record}')
        if run['converged']:
            check_driver(f'cahnhilliard step {k}', record)
    for line in lines:
        if not abs(line['dmass']) <= line['dmass_bound']:
            raise AssertionError(f'cahnhilliard step {line["step"]}: mass changed by {line["dmass"]:.3e}, bound '
                                 f'{line["dmass_bound"]:.3e}')
        missing = [name for name in CH_KERNELS if line['launches'][name] <= 0]
        if missing:
            raise AssertionError(f'cahnhilliard step {line["step"]}: kernels not launched: {missing}')
    return [line['launches'] for line in lines]


def phase_cahnhilliard_parity(devices=('cuda', 'cpu')):
    """examples/cahnhilliard.py's ``test_multipatchcircle`` (nelems 3,
    degree 2, two steps of an hour) on the card and through the port's CPU
    path, in float64, with ``main``'s locate of the flux plot's points on
    the phase's grid (``CH_PROBLEM``'s spacing): the located elements
    agree exactly and their coordinates to 1e-12, the flux at the located
    points (both devices at the card's final state) to 1e-10, phi and eta
    to 1e-10 (both sides' inner solves are host direct solves at this
    size, so they differ only in the assembly's last bits), and the card's
    pass the test's regression data (``testing.assertAlmostEqual64``), the
    CPU's too."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch import testing
    from nutils_tpu_torch.utils import config
    out = {}
    with config.floatx(numpy.float64):
        for device in devices:
            with config.device(device):
                t0 = time.perf_counter()
                prob = tp.cahnhilliard('nutils_tpu_torch', gridstep=CH_PROBLEM['gridstep'])
                t_build = time.perf_counter() - t0
                args = prob['args']
                for _ in range(2):
                    args = prob['step'](args)
                out[device] = prob, args, t_build, time.perf_counter() - t0 - t_build
        flux = []
        for device in devices:
            with config.device(device):
                flux.append(out[device][0]['flux'](out[devices[0]][1]))
    (pa, a, ba, ta), (pb, b, bb, tb) = (out[d] for d in devices)
    (ea, xa), (eb, xb) = tp.located(pa['grid']), tp.located(pb['grid'])
    dx = float(numpy.abs(xa - xb).max()) if len(xa) == len(xb) else None
    rel = {name: tp.rel(a[name], b[name]) for name in ('φ', 'η')}
    rel_flux = tp.rel(*flux)
    emit('cahnhilliard_parity', ndofs=int(a['φ'].size), located=[len(ea), len(eb)],
         elements_equal=bool(numpy.array_equal(ea, eb)), coords_max_abs=dx, rel_flux=rel_flux, rel=rel, tol=1e-10,
         seconds_build=[ba, bb], seconds_steps=[ta, tb], devices=list(devices))
    if not numpy.array_equal(ea, eb) or not dx <= 1e-12:
        raise AssertionError(f'card and CPU locate differ: {len(ea)} / {len(eb)} points, coordinates {dx}')
    if not (rel_flux <= 1e-10 and max(rel.values()) <= 1e-10):
        raise AssertionError(f'card and CPU cahnhilliard differ: flux {rel_flux}, {rel}')
    for device in devices:
        tp.example_assertions('cahnhilliard', 'test_multipatchcircle', testing, args=out[device][1])
    emit('cahnhilliard_regression', example='cahnhilliard', method='test_multipatchcircle', devices=list(devices),
         ok=True)


def cahnhilliard_only():
    """``--only cahnhilliard``: device, build and the two cahnhilliard
    phases alone."""
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    phase_cahnhilliard()
    phase_cahnhilliard_parity()
    emit('done', seconds=time.perf_counter() - t0)


def fcm_only():
    """``--only fcm``: device, build and the finite cell phases alone (the
    solve at FCM_NELEMS^2 with K8's and K9's rows at its shapes and K11's
    and K12's at its blocks, the H1 ratio against FCM_COARSE^2, the card
    against the CPU at 4 and 16 elements, and the adaptivity example's
    hierarchical refinement card against CPU)."""
    import numpy
    from nutils_tpu_torch.utils import config
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    launches, system, clean, jac, h1 = phase_fcm()
    phase_fcm_kernels(system, jac)
    with config.floatx(numpy.float64), config.device('cuda'):
        phase_assembly_kernels(system, clean, 'fcm')
    del system, clean, jac
    phase_fcm_ratio(h1)
    phase_fcm_parity()
    phase_hier_parity()
    emit('done', seconds=time.perf_counter() - t0)


def finitestrain_only():
    """``--only finitestrain``: device, build and the three finite-strain
    phases alone."""
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    made = track_mg()
    _launches, system, args, value = phase_finitestrain()
    phase_finitestrain_kernels(system, args, value)
    del system
    phase_finitestrain_parity()
    emit('mg_setup', phases=mg_summary(made))
    emit('done', seconds=time.perf_counter() - t0)


KRYLOV_N = 983403  # the Navier-Stokes step's dofs, both meshes


def krylov_turn_rows(n, dev, package):
    """K6's normalize, its projection and second update at j = 50, and
    K10's ``rhat . v`` on float32 vectors of length ``n``, timed from CUDA
    graphs, in the form ``package`` has: ``'cuda'`` (this tree's kernels on
    their device state; the update with the step's scalars, its state
    restored before each call) or ``'triton'`` (a checkout whose K6 and K10
    are Triton, ``ops/_triton_gmres.py`` and ``ops/_triton_bicgstab.py``)."""
    import numpy
    import torch
    dtype = torch.float32
    rng = numpy.random.default_rng(23)
    j, m = 50, K6_RESTART
    w, rhat, v = (torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev) for _ in range(3))
    Vvals = torch.as_tensor(rng.standard_normal((m + 1, n)) / n ** 0.5, dtype=dtype, device=dev)
    if package == 'cuda':
        from nutils_tpu_torch.ops import bicgstab, gmres
        V = gmres.basis(n, m, dtype, dev)
        V.copy_(Vvals)
        vcur = torch.empty_like(w)
        st = k6_state(n, j, dtype, dev)
        sb = k10_state(n, dtype, dev)
        return {'gmres_normalize': time_ms(lambda: gmres.gmres_normalize(w, V, vcur, st))[0],
                'gmres_project': time_ms(lambda: gmres.gmres_project(V, w, st, True))[0],
                'gmres_update': stateful_ms(lambda: gmres.gmres_update(V, w, w, st, True), st),
                'bicg_dots': time_ms(lambda: bicgstab.bicg_dots(rhat, v, None, sb, bicgstab.RV))[0]}
    from nutils_tpu_torch.ops import _triton_bicgstab as tbi
    from nutils_tpu_torch.ops import _triton_gmres as tgm
    hn, eps = torch.linalg.norm(w), torch.tensor(1e-30, dtype=dtype, device=dev)
    out = torch.empty_like(w)
    h = torch.as_tensor(rng.standard_normal(j + 1) / n ** 0.5, dtype=dtype, device=dev)
    sc = tbi.scalars(dtype, dev)
    return {'gmres_normalize': time_ms(lambda: tgm.gmres_normalize(w, hn, eps, out))[0],
            'gmres_project': time_ms(lambda: tgm.gmres_project(Vvals, j, w))[0],
            'gmres_update': time_ms(lambda: tgm.gmres_update(Vvals, j, h, w))[0],
            'bicg_dots': time_ms(lambda: tbi.bicg_dots(rhat, v, None, sc, tbi.RV))[0]}


def krylov_only():
    """``--only krylov``: device, build, :func:`krylov_turn_rows` and the
    GMRES and BiCGStab solves of the Navier-Stokes step on squares and on
    triangles at 330 x 330 elements in float32 (983,403 dofs): each
    method's first solve (in a fresh process: with its Triton compile in a
    checkout that has one, with its graphs' capture here), three warm
    solves, and one warm solve under torch.profiler (device-busy share).
    Copied into another checkout's root and run there, it measures that
    checkout's kernels and loops the same way, for turns; K5 on the step's
    operator beside them."""
    import numpy
    import torch
    from nutils_tpu_torch import _kernels
    from nutils_tpu_torch.utils import config
    t0 = time.perf_counter()
    phase_device()
    _path, seconds, _diag = _kernels.build()
    _kernels.library()
    package = 'cuda' if (ROOT / 'nutils_tpu_torch' / 'ops' / 'gmres.py').exists() else 'triton'
    emit('build', nvcc_seconds=seconds, package=package)
    emit('krylov_rows', package=package, n=KRYLOV_N, ms=krylov_turn_rows(KRYLOV_N, torch.device('cuda'), package))
    for path, etype, methods in (('ns', 'square', ('gmres',)), ('ns_tri', 'triangle', TRI_METHODS)):
        with config.device('cuda'):
            system, args = build_ns(330, numpy.float32, etype)
            jac, res = system.assemble_jacobian_residual(args)
            (kind, *plan), op = jac._device_op()
            jac._device_precon(None, None)
            if kind == 'blockgrid':
                # K5 on the step's operator (its flag, new here, not passed)
                from nutils_tpu_torch.ops import blockgrid
                x = torch.as_tensor(numpy.random.default_rng(24).standard_normal(KRYLOV_N), dtype=torch.float32,
                                    device='cuda')
                emit('krylov_rows', package=package, n=KRYLOV_N,
                     ms={'blockgrid_matvec': time_ms(lambda: blockgrid.blockgrid_matvec(op[0], x, plan[0]))[0]})
            for method in methods:
                def solve():
                    return jac.solve_leniently(res, solver=method, rtol=1e-3)
                t_first, _dx = _sync_time(solve)
                first = dict(jac._solve_stats)
                warm = [_sync_time(solve)[0] for _ in range(3)]
                stats = dict(jac._solve_stats)
                wall, kernels, _full, _dx = profiled(solve)
                busy = busy_s(kernels)
                emit('krylov_solve', package=package, path=path, method=method, t_first=t_first, t_warm=warm,
                     profiled_wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                     kernel_launches=sum(e.count for e in kernels), iters=stats['iters'], rounds=stats['rounds'],
                     first_stats=first, stats=stats)
        del system, jac, res
        torch.cuda.empty_cache()
    emit('done', seconds=time.perf_counter() - t0)


def finitestrain_system(nelems=FINITESTRAIN_NELEMS):
    """The finite-strain energy's System at ``nelems`` squares a side in
    float64 (as :func:`phase_finitestrain` builds it) and a displacement of
    1e-3 standard normal entries from seed 45."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch.solver import System
    from nutils_tpu_torch.utils import config
    config.floatx.value = numpy.float64
    _domain, _ns, _sqr, _energy, energy1 = tp.finitestrain_forms('nutils_tpu_torch', nelems, 'square', 'std', 1, .25,
                                                                 20.)
    system = System(energy1, trial='u')
    return system, {'u': 1e-3 * numpy.random.default_rng(45).standard_normal(system.trial_shapes[0])}


def kernels_only():
    """``--only kernels``: kernel rows alone, without the solves: K3 at the
    slice's, the example's and the finite-strain grids, K1 at the slice's,
    a periodic and the example's grid and K1 and K2's fused sweeps at every
    smoothed level of the finite-strain hierarchy; K11 and K12 at every block of the
    slice, the NS step, the triangle step, the elasticity example and the
    finite-strain energy at 720^2 and on one of the Laplace example's
    chunks; K7 on the NS step's and the triangle step's jacobians; K13 and
    K14 at the elasticity path's shapes (its free rows from
    ``solve_constraints``, random nodal blocks); K15 on the finite-strain
    energy's integrand, its two launches and (where the package folds) its
    folded one.  K1's, K2's, K3's, K7's, K11's, K12's and K15's rows carry
    the sha1 of their outputs.  Run from another
    checkout's root (a copy of this script beside its package), it
    measures that checkout's kernels at the same shapes and inputs."""
    import _torch_parity as tp
    import numpy
    from nutils_tpu_torch.solver import System
    from nutils_tpu_torch.utils import config
    import torch
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    phase_kernels(cases=kernel_cases({'slice': ('stencil', 'transfers'), 'periodic': ('stencil',),
                                      'example': ('stencil', 'transfers'),
                                      'finitestrain': ('stencil', 'fused', 'transfers'),
                                      **{label: ('stencil', 'fused') + (('transfers',) if shape[0] > 91 else ())
                                         for label, shape in FINITESTRAIN_LEVELS}}),
                  k4=False)
    torch.cuda.empty_cache()
    with config.device('cuda'):
        system = build_laplace(1024, numpy.float32, reaction=True)
        phase_assembly_kernels(system, system._clean({'u': numpy.zeros(system.trial_shapes[0][0])}), 'slice')
        for etype, path in (('square', 'ns'), ('triangle', 'ns_tri')):
            system, args = build_ns(330, numpy.float32, etype)
            phase_assembly_kernels(system, system._clean(args), path)
            jac, _res = system.assemble_jacobian_residual(args)
            w, cmap, indices, indptr = jac._csr_tables()
            for dtype in (torch.float32, torch.float64):
                schur_row('ns' if cmap is not None else 'ns_tri csr', w.to(dtype), cmap, indices, indptr,
                          jac.shape[0])
            del jac, w, cmap, indices, indptr
        del system
        config.floatx.value = numpy.float64
        _domain, _ns, res, _sqr = tp.laplace_example_forms('nutils_tpu_torch', 2048)
        system = System(res, trial='u', test='v')
        clean = system._clean({'u': numpy.zeros(system.trial_shapes[0][0])})
        system._compiled('jacres')(clean)
        phase_chunk_kernels(system, clean)
        del system, clean
        _domain, _ns, sqr, energy, _traction = tp.elasticity_forms('nutils_tpu_torch', ELASTICITY_NELEMS, 'triangle')
        cons = System(sqr, trial='u').solve_constraints(droptol=1e-15)
        system = System(energy, trial='u')
        phase_assembly_kernels(system, system._clean({'u': numpy.zeros(system.trial_shapes[0])}), 'elasticity')
        free = numpy.isnan(cons['u']).ravel()
        minv = numpy.random.default_rng(3).standard_normal((len(free) // 2, 2, 2))
        phase_elasticity_kernels(minv, free)
        del system, cons, free, minv
        torch.cuda.empty_cache()
        # the finite-strain energy at 720^2 at a seeded displacement: K11,
        # K12 and K15 (the value's launch, folded where the package folds)
        system, args = finitestrain_system()
        clean = system._clean(args)
        phase_assembly_kernels(system, clean, 'finitestrain')
        dargs = system._device_args(clean)
        leaves = system._bound_leaves(dargs, {}, system._tables())
        form = next(part[1] for part in system._value_parts() if part[0] == 'form')
        fold_row(form.integrand(dargs, leaves).contiguous(), 'finitestrain')
    emit('done', seconds=time.perf_counter() - t0)


ASSEMBLE_REPS = 12


def assemble_only(reps=ASSEMBLE_REPS):
    """``--only assemble``: warm ``t_assemble`` alone, ``reps`` times on
    every path (the slice, the NS step on squares and on triangles, the
    Laplace example at 2048^2 in its 2 chunks, the elasticity example), each
    System built as its phase builds it at zero arguments and called once
    first: every sample (host clock around a synchronised call), their
    minimum and median.  Run from another checkout's root (a copy of this
    script beside its package), it times that checkout's assembly."""
    import _torch_parity as tp
    import numpy
    import torch
    from nutils_tpu_torch.solver import System
    from nutils_tpu_torch.utils import config
    t0 = time.perf_counter()
    phase_device()
    phase_build()

    def slice_system():
        return build_laplace(1024, numpy.float32, reaction=True)

    def ns_system(etype):
        return build_ns(330, numpy.float32, etype)[0]

    def example_system():
        config.floatx.value = numpy.float64
        return System(tp.laplace_example_forms('nutils_tpu_torch', 2048)[2], trial='u', test='v')

    def elasticity_system():
        config.floatx.value = numpy.float64
        return System(tp.elasticity_forms('nutils_tpu_torch', ELASTICITY_NELEMS, 'triangle')[3], trial='u')
    with config.device('cuda'):
        for path, make in (('slice', slice_system), ('ns', lambda: ns_system('square')),
                           ('ns_tri', lambda: ns_system('triangle')), ('laplace_example', example_system),
                           ('elasticity', elasticity_system)):
            system = make()
            clean = system._clean({t: numpy.zeros(shape) for t, shape in zip(system.trials, system.trial_shapes)})
            fn = system._compiled('jacres')
            t_first = _sync_time(lambda: fn(clean))[0]
            times = [_sync_time(lambda: fn(clean))[0] for _ in range(reps)]
            plan = system._chunk_plan()
            emit('assemble_only', path=path, chunks=plan['nc'] if plan else 1, t_assemble_first=t_first,
                 t_assemble=min(times), t_assemble_median=statistics.median(times), samples=times)
            del system, clean, fn
            torch.cuda.empty_cache()
    emit('done', seconds=time.perf_counter() - t0)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py: torch.cuda.is_available() is false; this check needs a CUDA card')
    sys.path.insert(0, str(ROOT))
    import numpy
    import nutils_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    sys.path.insert(0, str(ROOT / 'tests'))  # _torch_parity: the tests' problem builders (no JAX)
    from nutils_tpu_torch.utils import config
    if sys.argv[1:] == ['--only', 'kernels']:
        return kernels_only()
    if sys.argv[1:] == ['--only', 'assemble']:
        return assemble_only()
    if sys.argv[1:] == ['--only', 'finitestrain']:
        return finitestrain_only()
    if sys.argv[1:] == ['--only', 'krylov']:
        return krylov_only()
    if sys.argv[1:] == ['--only', 'timestep']:
        return timestep_only()
    if sys.argv[1:] == ['--only', 'fcm']:
        return fcm_only()
    if sys.argv[1:] == ['--only', 'cahnhilliard']:
        return cahnhilliard_only()
    if sys.argv[1:]:
        raise SystemExit(f'chip_smoke.py: unknown arguments {sys.argv[1:]} (none, --only kernels, --only assemble, '
                         '--only finitestrain, --only krylov, --only timestep, --only fcm or --only cahnhilliard)')
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    made = track_mg()
    measured = phase_kernels()
    launches, system, clean, jac, res = phase_slice()
    mg_by_path = {'slice': dict(launches)}
    phase_slice_driver(jac, res)
    phase_slice_profile(jac, res)
    with config.floatx(numpy.float32):  # the slice's own precision
        phase_assembly_kernels(system, clean, 'slice')
        phase_ns_profile(system, jac, res, clean, methods=(), phase='slice_assembly_profile')
    check_pattern('slice', system)
    del system, clean, jac, res
    phase_parity()
    torch.cuda.empty_cache()
    by_path = {'slice': {name: launches[name] for name in ASSEMBLY_KERNELS}}
    ns_launches, system, jac, res, clean, k5_setup = phase_ns()
    measured.update(phase_ns_kernels(jac, k5_setup))
    measured.update(phase_assembly_kernels(system, clean, 'ns'))
    phase_ns_profile(system, jac, res, clean)
    check_pattern('ns', system)
    del system, jac, res, clean
    torch.cuda.empty_cache()
    phase_ns_parity()
    by_path['ns'] = {name: ns_launches[name] for name in ASSEMBLY_KERNELS}
    launches.update(ns_launches)
    tri_launches, system, jac, res, clean = phase_ns_tri()
    measured.update(phase_ns_tri_kernels(system, jac))
    phase_assembly_kernels(system, clean, 'ns_tri')
    phase_ns_profile(system, jac, res, clean, methods=TRI_METHODS, phase='ns_tri_profile')
    check_pattern('ns_tri', system)
    del system, jac, res, clean
    torch.cuda.empty_cache()
    phase_ns_tri_parity()
    phase_k9_rows()
    by_path['ns_tri'] = {name: tri_launches[name] for name in ASSEMBLY_KERNELS}
    # the kernels new on the triangle path count its launches; K7's CSR
    # variant is the same wrapper, read on that path
    launches.update({name: tri_launches[name] for name in ('csr_scatter', 'csr_matvec') + BICGSTAB_KERNELS})
    launches['schur_diag_inverse_device[csr]'] = tri_launches['schur_diag_inverse_device']
    example_launches, system, clean, w0, r0 = phase_laplace_example()
    phase_laplace_example_chunks(system, clean, w0, r0)
    chunk_rows = phase_chunk_kernels(system, clean)
    check_pattern('laplace_example', system)
    del system, clean, w0, r0
    torch.cuda.empty_cache()
    phase_laplace_example_parity()
    mg_by_path['laplace_example'] = example_launches
    mg_by_path['laplace_example_p2'] = phase_laplace_example_p2()
    phase_ns_newton()
    torch.cuda.empty_cache()
    # time stepping: launches of each step of the two paths
    by_step = {'ns_steps': phase_ns_steps()}
    torch.cuda.empty_cache()
    by_step['heat_steps'] = phase_heat_steps()
    torch.cuda.empty_cache()
    phase_timestep_parity()
    step_sums = {path: {name: sum(step.get(name, 0) for step in steps) for name in KERNELS}
                 for path, steps in by_step.items()}
    mg_by_path['heat_steps'] = step_sums['heat_steps']
    by_path['laplace_example'] = {name: example_launches[name] for name in ASSEMBLY_KERNELS}
    by_path.update({path: {name: sums[name] for name in ASSEMBLY_KERNELS} for path, sums in step_sums.items()})
    elasticity_launches, minv, free, system, clean = phase_elasticity()
    with config.floatx(numpy.float64):  # the example's own precision
        elasticity_rows = phase_assembly_kernels(system, clean, 'elasticity')
    check_pattern('elasticity', system)
    del system, clean
    measured.update(phase_elasticity_kernels(minv, free))
    del minv, free
    torch.cuda.empty_cache()
    phase_elasticity_square()
    phase_elasticity_parity()
    by_path['elasticity'] = {name: elasticity_launches[name] for name in ASSEMBLY_KERNELS}
    launches.update({name: elasticity_launches[name] for name in ('block_apply', 'mask_pre', 'mask_post')})
    finitestrain_launches, system, args, value = phase_finitestrain()
    measured.update(phase_finitestrain_kernels(system, args, value))
    with config.floatx(numpy.float64), config.device('cuda'):  # the example's own precision
        finitestrain_rows = phase_assembly_kernels(system, system._clean(args), 'finitestrain')
    check_pattern('finitestrain', system)
    del system
    torch.cuda.empty_cache()
    phase_finitestrain_parity()
    by_path['finitestrain'] = {name: finitestrain_launches[name] for name in ASSEMBLY_KERNELS}
    mg_by_path['finitestrain'] = finitestrain_launches
    launches.update({name: finitestrain_launches[name] for name in VALUE_KERNELS + ('elem_value_sum',
                                                                                    'elem_value[finish]')})
    # the finite cell solve: K8 on a stream whose subcells repeat their
    # elements' slots, K9, K11 and K12 on three parts, and its Krylov and
    # preconditioner kernels
    fcm_launches, system, clean, jac, h1 = phase_fcm()
    fcm_rows = phase_fcm_kernels(system, jac)
    with config.floatx(numpy.float64), config.device('cuda'):
        fcm_blocks = phase_assembly_kernels(system, clean, 'fcm')
    check_pattern('fcm', system)
    del system, clean, jac
    torch.cuda.empty_cache()
    phase_fcm_ratio(h1)
    phase_fcm_parity()
    phase_hier_parity()
    by_path['fcm'] = {name: fcm_launches[name] for name in ASSEMBLY_KERNELS}
    # cahnhilliard's time steps on the multipatch circle: K8, K9, K7, K6,
    # K11, K12 (and K15, which Newton does not launch) in every step
    ch_steps = phase_cahnhilliard()
    torch.cuda.empty_cache()
    phase_cahnhilliard_parity()
    ch_sums = {name: sum(step[name] for step in ch_steps) for name in CH_KERNELS + VALUE_KERNELS}
    by_path['cahnhilliard'] = {name: ch_sums[name] for name in ASSEMBLY_KERNELS}
    by_step['cahnhilliard'] = ch_steps
    # K5 and K7 on block-grid jacobians: the Navier-Stokes step's and its
    # history steps'
    for name in ('blockgrid_matvec', 'schur_diag_inverse_device'):
        by = {'ns': ns_launches[name], 'ns_steps': step_sums['ns_steps'][name]}
        launches[name] = sum(by.values())
        measured[name] = dict(measured[name], launches_by_path=by)
    # K1-K4: launches summed over the paths that run them, each path's
    # beside them
    for name in MG_KERNELS:
        by = {path: counts.get(name, 0) for path, counts in mg_by_path.items()}
        launches[name] = sum(by.values())
        measured[name] = dict(measured[name], launches_by_path=by)
    for name in FORM_KERNELS:
        measured[name]['launches_by_form'] = {path: forms[name] for path, forms in FORMS_BY_PATH.items()}
    # K6: launches summed over the paths that run GMRES, each path's beside
    # them
    for name in GMRES_KERNELS:
        by = {'ns': ns_launches[name], 'ns_tri': tri_launches[name], 'laplace_example': example_launches[name],
              'ns_steps': step_sums['ns_steps'][name], 'heat_steps': step_sums['heat_steps'][name]}
        launches[name] = sum(by.values())
        measured[name] = dict(measured[name], launches_by_path=by)
    # K11 and K12: launches summed over the paths' runs, each path's beside
    # them; their float64 measurements on one of the example's element
    # chunks, written in place, on the elasticity example's block and on
    # the finite-strain one, beside those of the largest block
    for name in ASSEMBLY_KERNELS:
        launches[name] = sum(counts[name] for counts in by_path.values())
        measured[name] = dict(measured[name], launches_by_path={path: counts[name] for path, counts in by_path.items()},
                              float64_chunk=chunk_rows[name], elasticity_block=elasticity_rows[name],
                              finitestrain_block=finitestrain_rows[name], fcm_block=fcm_blocks[name])
    # the finite cell path's launches of the other kernels it runs, beside
    # those of the paths counted above (K8's and K9's: the triangle step);
    # K8's and K9's rows at its shapes
    for name in FCM_KERNELS:
        if name in ASSEMBLY_KERNELS:
            continue
        by = dict(measured[name].get('launches_by_path') or {'ns_tri': launches[name]})
        by['fcm'] = fcm_launches[name]
        launches[name] = sum(by.values())
        measured[name] = dict(measured[name], launches_by_path=by)
    for name, fields in fcm_rows.items():
        measured[name] = dict(measured[name], fcm=fields)
    # the cahnhilliard path's launches of its other kernels, beside those
    # counted above
    for name in CH_KERNELS + VALUE_KERNELS:
        if name in ASSEMBLY_KERNELS:
            continue
        by = dict(measured[name].get('launches_by_path') or {'earlier paths': launches[name]})
        by['cahnhilliard'] = ch_sums[name]
        launches[name] = sum(by.values())
        measured[name] = dict(measured[name], launches_by_path=by)
    # each step's launches of the time-stepping paths, beside the sums
    for name in KERNELS:
        steps = {path: [step[name] for step in steps] for path, steps in by_step.items() if name in steps[0]}
        if steps:
            measured[name] = dict(measured[name], launches_by_step=steps)
    # no launch of the run took K12's generic kernel
    reset_launches()
    emit('k12_generic_launches', launches=GENERIC_K12[0])
    if GENERIC_K12[0]:
        raise AssertionError(f'K12 launched its generic kernel {GENERIC_K12[0]} times: a path has operands that '
                             'vector_plan refuses')
    emit('mg_setup', phases=mg_summary(made))
    emit('done', seconds=time.perf_counter() - t0)
    print(json.dumps({'kernels': [
        {'name': name, 'route': route, 'source': source, 'replaces': replaces, 'launches': launches[name],
         **measured[name]}
        for name, (route, source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
