#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --record PATH   # also write every measurement as JSON

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and runs, in
order (any failure exits non-zero, no phase's failure is caught):

0. card and build: the card's name and power limit, torch/CUDA versions, the
   kernel build time, then the kernel lint (``repro_torch.analysis.
   lint_kernels``: the kernel table, Hopper's launch limits and the build's
   ptxas reports: no spill);
1. every kernel against its plain PyTorch version on the card at 128³ (the
   paper's per-rank block) for 7pt/27pt in f64/f32/bf16, with the
   tolerances of the CPU tests (bf16: outputs bitwise, the f32 partials
   within 1e-5·Σ|a_i·b_i|, ``part_ok``), bitwise-reproducible partials, and CUDA-event times
   (median of 25 launches, L2 flushed before each by a read, so it holds
   clean lines) beside the plain version's, a PyTorch library call's where
   one computes the same function, and the bound (bytes over the card's
   memory rate, operations over its instruction rate: half the FLOP/s peak,
   since every solver kernel rounds each multiply and add on its own); the
   plane-ring pass's kernels (``stencil_spmv``, ``stencil_spmv_dots``,
   ``stencil_spmv_dots3``) from x unpadded (the zero halo made in the
   kernel, as the solves run them) and padded, f64 outputs bitwise equal to
   the plain version's, and again at the socket block 128x128x3072 beside
   ``rb_gs_half_sweep`` (the ring pass's off-diagonal form, both colours),
   the pad, ``fused_cg_body``, bf16's ``stencil_spmv``,
   ``block_jacobi_sweep``, ``cheb_fused_step``, both BiCGStab passes and
   ``rb_gs_half_sweep`` and f32's ``block_jacobi_sweep`` and
   ``cheb_fused_step`` (bitwise the plain version and the old pass, whose
   time on a copy of z at a 4-byte offset is ``old_ms``); every bf16 ring
   row's stage checked (the pair stage: ``stencil_ring_stage`` of the built
   source, ``ring_stages``; bf16's block-Jacobi sweep, Chebyshev step,
   BiCGStab passes and half-sweep on the ring, the half-sweep's f64 27pt
   form too, and f32's two sweeps on its pair stage, the 7pt Chebyshev step
   on the old pass, ``ring_route``; the launched instances by one profiler
   window a dtype, ``ring_kernels_launched``, which also holds f32's odd
   nz, a misaligned z, a misaligned r and the 7pt Chebyshev step to
   ``stencil_kernel``, bitwise the pair stage where both run); the two
   sweeps (rows 16, 17, and 16b, 17b below) from z unpadded (the zero halo
   made in the kernel, as the solves run them: the row's ms) and padded
   (``padded_ms``), the two forms bitwise each other, f64's on the ring's
   element stage in both stencils and both forms (one profiler window a
   form, ``f64_sweeps_launched``), bitwise the plain version and the old
   pass, whose time behind the pad it needs is ``old_pad_ms`` (f64, f32);
   the kernel API's flat passes also on the
   ragged lengths 5000 and 128³ + 1; the lane-batched forms of
   ``stencil_spmv``, ``cheb_fused_step`` and ``block_jacobi_sweep`` (the
   batched solve's kernels, one launch over all lanes) at B = 4 and 8 lanes
   of 128³, bitwise equal to the plain version in f64 and, lane by lane, to
   the 3-D kernel, timed beside the plain version, a batched ``conv3d`` and
   B times the 3-D row's bound (f64, f32 and bf16 alike; a bf16 row's
   operations bound is over half the packed bf16 rate, ``op_rate``);
   then the ``autotune`` phase (its own counted window, ``phase_autotune``):
   at 128³ and 128x128x3072 27pt f64 and at 128³ 7pt f64, 27pt f32 and
   27pt bf16 (the bf16 sweep keyed ``…|bfloat16|<card>``), each
   run of x-planes the ring pass may pick (8, 16, 32) under rows 1, 2 and 4
   in both operand forms (y bitwise the plain version's in f64, partials
   repeated bitwise under one run and within the partial tolerance across
   runs), all timed; then
   ``kernels.autotune.tune`` of each cell into ``build/autotune/tuned.json``
   (never the home directory: every other phase reads an absent cache, the
   default table); a ``kernels=None`` session at 128³ resolves from it, and
   graphed cg_merged, pcg_merged + chebyshev, cg_pipe and pcg_pipe +
   chebyshev under the tuned tiles are bitwise their eager solves and stop
   on their ``kernels=False`` iteration; the crossover (graphed cg_merged
   ms/iter, kernels against plain, 8³–64³) that ``MIN_KERNEL_VOLUME`` is set
   from; and the memory of a graphed cg_merged at the socket block with
   ``donate`` on and off, the results bitwise equal;
2. six paths through the kernels, each in its own counted window (launch
   counts set to 0 just before it, read just after):
   a. the unpreconditioned path: merged CG with ``kernels=True`` at 128³,
      27pt and 7pt, f64, then cg, cg_nb, bicgstab, bicgstab_b1 (27pt) and
      jacobi, gauss_seidel, gauss_seidel_rb (7pt);
   b. the preconditioned path: pcg with chebyshev and block_jacobi (27pt
      and 7pt), pcg_merged with chebyshev and block_jacobi (the fused
      route), pcg with jacobi and ssor, and pbicgstab with chebyshev (27pt);
   c. the pipelined path: cg_pipe (27pt and 7pt), pcg_pipe with chebyshev
      (27pt and 7pt) and with block_jacobi, jacobi and ssor (27pt), all on
      the fused route;
   d. the single-reduction BiCGStab path: bicgstab_merged (27pt and 7pt),
      pbicgstab_merged with chebyshev (27pt and 7pt) and with block_jacobi,
      jacobi and ssor (27pt), all on the fused route;
   e. the kernel API path (``repro_torch.kernels.ops``, whose last four
      kernels no solver calls): on a gauss_seidel_rb iterate and a cg_nb
      state after three plain iterations at 128³ f64, 27pt and 7pt, one
      symmetric red-black sweep of four ``gs_half_sweep`` calls and CG-NB's
      lines 4–8 through ``axpbypcz``, ``axpbypcz_dot`` and ``cg_update``,
      the vectors bitwise equal to the port's own steps, the partials within
      1e-11 of them, and exactly those launches;
   each solve of paths a–d converged, with its zero-halo pads (``F.pad``
   calls: one for b = A·1 and one before each launch of a kernel that takes
   its operand padded, ``expected_pads``; none for the plane-ring pass's
   three kernels and for the preconditioner sweeps where their rule puts
   them on the ring, as it does every f64 one), with the iteration count of the same
   solve with ``kernels=False`` (for the merged BiCGStabs, whose stopping iteration
   depends on the summation order of their nine dots, within 10 % + 1 and
   with the true residual below the tolerance: ``ORDER_SENSITIVE``) and the
   launch counts it must make.  The windows' solves run the session's eager
   loop (``_solve_eager``: one read an iteration, every wrapper call a
   launch); a graphed solve replays its kernels without passing a wrapper,
   so it is counted nowhere and held to these solves instead;
   e''. the f32 preconditioned path (``precond_f32``, its own counted
      window, after 2f): pcg + chebyshev and pcg + block_jacobi at 128³
      27pt in f32 on the eager loop, their sweeps on the ring's f32 pair
      stage, exactly their launches; outside the window each on its
      ``kernels=False`` iteration and status, its graphed solve bitwise the
      eager one, and the graphed ms/iter on the kernels and the plain path;
   e'. the kernel API in bf16 (``kernel_api_bf16``, its own counted
      window): each of the 18 solver wrappers once on seeded bf16 operands
      at 128³ 27pt (``spmv`` and ``spmv_dot`` both launching
      ``stencil_spmv``) and the three 4-D forms at B = 4, exactly one launch
      of each kernel (two of ``stencil_spmv``); outside the window each
      output bitwise its plain version, each partial float32, within
      1e-5·Σ|a_i·b_i| and repeated bitwise;
   f. the graphed path: each ``kernels=True`` solve of a–d again through
      ``SolverSession.solve`` (the executable cache: CUDA graphs replayed in
      blocks of steps, one read a block), a miss that builds the executable
      and then a hit, both with the iterations and status of the window's
      eager solve and its f64 iterate, residual norm and history bitwise;
   g. the batched path (``batched``, the sixth counted window): each case of
      a–d and cg 7pt, bicgstab 7pt and jacobi 27pt as one batched solve of
      B = 4 lanes at 128³ (A·1, two seeded normal lanes, a zero lane) on
      the eager route (``_solve_batched_eager``), with exactly the launches
      of its lane-batched kernels and no 3-D launch, and its pads
      (``expected_batched_pads``: none but the sweeps' off the ring and the
      Gauss-Seidels' and SSOR's own, not counted); then, outside the
      window, each lane bitwise equal to the same-route single solve of it,
      the A·1 lane within 1e-6 of 1, and the graphed batched solve
      (``compile_batched``, a miss, then ``solve_batched``, a hit) bitwise
      the eager one; and, after the profiles below, the per-lane warm wall
      time of graphed batched solves of cg, pcg + chebyshev, pcg +
      block_jacobi and bicgstab at B = 1, 4 and 8 beside the graphed single
      solves of the same lanes, with the lane-steps run past each lane's
      stop, then the device time by kernel of one batched solve (B = 4) and
      one single solve of each;
   h. the resilience path (``resilience``, its own counted window; 128³,
      27pt, f64, ``kernels=True``): the six fused routes and cg and
      bicgstab with ``guards=True`` and ``telemetry=True``, eager and
      graphed, each bitwise the unguarded eager solve of its route, with
      its launches, the telemetry's residual column bitwise the history; a
      NaN ``b`` on merged CG's graphed fused route ends in breakdown at
      iteration 0 and raises ``SolveBreakdown`` under
      ``on_breakdown="raise"``; stagnation guards on merged CG and
      pcg_merged + chebyshev (``STAGNATION``) fire inside a block, the
      iteration printed, graphed bitwise eager; residual replacement every
      10 on merged CG and pcg_pipe + chebyshev converges, graphed bitwise
      eager, true residual below ``tol``; a batch of 4 cg lanes with one
      poisoned by ``ChaosInjector.poison_b`` ends that lane in breakdown and
      every clean lane bitwise its single solve; ``on_breakdown="fallback"``
      on merged CG converges, its ladder too; and, after phase 3, the
      graphed ms/iter of merged CG and pcg_merged + chebyshev at 128³ and
      at the socket block with the guards off, on, and on with telemetry
      (``resilience_timings``, with the device profile at 128³);
   i. the serve path (``serve``, its own counted window, after the batched
      timings): the solver service (``repro_torch.serve``) replays
      ``SERVE_BUCKETS`` — cg 27pt and 7pt, bicgstab_b1 27pt, pcg + jacobi
      (2 sweeps), pcg + chebyshev and pcg + block_jacobi 27pt, 10 requests
      each at 128³ f64, tol 1e-8 absolute — with ``max_batch = 4``,
      ``kernels=True``, builds on the background thread and guards on; the
      window's launches are the builds' warm-up steps and captures, all
      lane-batched.  Every request converged, no reject, one build a bucket
      (``cache_stats()``: one entry, one miss; 6 misses, no eviction), each
      served ``x``, ``iters`` and ``status`` bitwise the same-route single
      solve of its request (``_solve_unfused``); one warm dispatch of each
      bucket under ``torch.profiler`` with its lane-batched kernels on the
      card; a second replay bitwise the first; two cg 27pt dispatches with
      the write-ahead journal and a preemption at the second: nothing
      dropped, bitwise the first stream, the journal empty after; the chaos
      suite (``run_smoke``) on the card.  Printed: p50/p95/p99 latency,
      QPS, each bucket's build seconds, dispatches, walls, upload and copy
      times and the waits on a build's capture, the profiled dispatch's
      busy share, and the served per-lane ms/iter beside
      ``batched_timings``'s;
   j. the distributed path (``distributed``, after ``serve``): spawned
      ranks of a ``torch.distributed`` group (``torch.multiprocessing``
      spawn, a ``file://`` rendezvous under ``build/mesh/``, a hard limit on
      each run and on each collective; a rank that fails or a run past its
      limit fails the script), each a ``("cells",)`` mesh at 128³ 27pt f64 a
      rank: (a) NCCL, one rank, a real group: the six fused routes on the
      kernels and cg, bicgstab without them, each held to the local eager
      session on the card (iterations, status, max |Δx| < 1e-9, bitwise or
      not recorded), rows 1–4 among the profiled kernels and rows 1, 2, 4
      launched on padded operands only; (b) gloo, 2 and 4 ranks sharing the
      card (one spawn of four, P = 2 on the subgroup of ranks 0 and 1 while
      the others wait; CUDA tensors staged through pinned host memory): cg, cg_nb,
      bicgstab, bicgstab_b1, cg_merged and pcg_merged + chebyshev on both
      routes, and jacobi and gauss_seidel_rb at P = 2, each held on rank 0
      to the single-process solve of the global grid (the BiCGStabs within
      10 % + 1 and their true residual below ``tol``:
      ``MESH_ORDER_SENSITIVE``), the ``kernels=True`` routes to the mesh's
      ``kernels=False`` iterations, the collectives of a step to the
      registry's; at each P cg under ``scatter``, ``concat`` and
      ``overlap`` bitwise alike, its warm eager ms/iter under ``concat`` and
      ``overlap`` (median of three interleaved rounds), the halo swaps'
      share of an iteration and rank 0's busy share; at P = 4 the (2, 2)
      ``data``×``model`` mesh once under cg.  After each run's cases the
      same ranks measure the cost attribution (``obs.attribution``:
      ``ATTRIB_METHODS`` under ``concat`` and cg under ``overlap``, the
      slowest rank's ``t_iter``, ``t_halo``, ``t_reduce``, ``t_compute``;
      on NCCL P = 1 also on the one-rank mesh with no group and each
      method's no-mesh eager ms/iter), each table printed, its rows held to
      the registry's counts, its phases summing to ``t_iter``, ``t_halo > 0``
      at P > 1 and its trace valid.  The ranks' counted windows are the
      ``mesh`` path of the kernel table;
   k. the collective audit (``audit``, after ``distributed``): spawned
      ranks as in j., NCCL P = 1 and gloo P = 2, 4 sharing the card, 128³
      27pt f64 a rank: one step of every method on both routes under the
      recording comm and the op log (``analysis.audit.measure_job``; the
      ranks' counted windows are the ``audit`` path), held as the CPU audit
      holds them (``analysis.audit.compare``: the registry's collective
      counts, no other collective, each unfused reduction's window against
      its ``reduction_hides`` class), every fused kernel launched; at P = 2
      and 4 the eager ms/iter of cg, cg_nb, cg_pipe and bicgstab_b1 on the
      non-blocking comm and through ``ForkJoinComm`` (a test double whose
      gathers wait at once), three rounds interleaved, the two solves
      bitwise alike; at P = 1 one profiled pipelined-PCG step on the fused
      route (do the NCCL kernel's and the SpMV's intervals overlap?).
      ``--only-audit`` builds, lints and runs it alone;
   l. the batched and served mesh (``mesh_batched``, after ``audit``;
      ``--only-mesh-batched`` builds, lints and runs it alone): spawned
      ranks as in j., 128³ a rank, 27pt f64.  (a) NCCL, P = 1: B = 4
      lanes (A·1, two seeded lanes, a zero lane) of cg, pcg + chebyshev,
      pcg + block_jacobi and bicgstab with ``kernels=True`` on the eager
      route in one counted window (rows 1b, 16b, 17b exactly
      ``expected_batched_launches``'s, every SpMV on a padded operand, the
      ranks' windows the ``mesh_batched`` path), each lane bitwise the
      one-rank mesh's single solve of it and the single process's batched
      lane; then the eight routes of j.'s (a) and the four batched ones
      through the executable cache (the gathers captured, thread-local
      capture mode), each bitwise its eager solve, ms/iter both ways.  (b)
      gloo, P = 2 and 4 sharing the card: batched cg and pcg + chebyshev
      on the kernels, counted likewise, each lane bitwise the mesh's single
      solve of it (their walls recorded), and one batched step of cg, cg_nb
      and bicgstab making the single step's collectives with B lanes'
      payload (``analysis.audit.compare_batched``).  (c) the served stream
      on gloo P = 4: the cg 27pt bucket, 10 requests of the global grid
      128×128×512, ``max_batch`` 4, ``kernels=True``, guards, a journal;
      rank 3 lost at dispatch 0, the mesh shrunk to 2 (512 is no multiple
      of 3): 10/10 converged, 0 rejects, one loss, each result on the
      single process's iterations and within 1e-9 of its solve; then a
      service on 4 ranks dies at its first dispatch and one on ranks 0 and
      1 recovers the journal cold (4/4 converged, the journal empty);
   then, outside the counted windows, the warm wall times of the profiled
   solves and of bicgstab and pbicgstab + chebyshev, eager and graphed in
   turn, before any profiler session, and the device time by kernel
   (``torch.profiler``) of one warm solve each of merged CG, pcg_merged +
   chebyshev, cg_pipe, pcg_pipe + chebyshev, bicgstab_merged and
   pbicgstab_merged + chebyshev, eager and graphed (the busy share: device
   time over the warm wall);
3. the paper's per-socket hybrid block, 128x128x3072 (27pt, f64), on the
   kernels: merged CG, pcg_merged + chebyshev, cg_pipe, pcg_pipe +
   chebyshev, bicgstab_merged and pbicgstab_merged + chebyshev (iterations,
   time per iteration, achieved GB/s), and bicgstab, pbicgstab + chebyshev
   and cg (iterations, time per iteration) beside them; each eager (the
   counted solve and three more) and graphed (the executable built, its
   reserve recorded, then three solves bitwise equal to the counted one), in
   turn; then the K sweep: merged CG and pcg_merged + chebyshev graphed at
   128³ and at the socket block with largest blocks K = 1, 2, 4, 8, 16, 32
   (build seconds, reserve, ms/iter, blocks and steps rolled back);
4. the attention path, a seventh counted window: ``ops.flash_attention``
   once per case at the attention widths of two of the reference's configs,
   one sequence of 4096 tokens each (``ATTENTION``: internlm2-1.8b, 16 heads
   of 128, causal; hymba-1.5b, 25 heads of 64, sliding window 2048), in f32
   and bf16, exactly those four launches; then, outside the window, each
   output against the plain version (f32 within rtol 1e-4/atol 1e-5 with
   TF32 off; bf16 element by element against the plain f32 version on the
   same inputs, by ``ref.attention_bf16_error``'s rule), finite and bitwise
   equal to a second launch, and the CUDA-event times of the kernel, the
   plain version and ``F.scaled_dot_product_attention`` beside the bound
   (operations of the kept query-key pairs: in f32, three TF32 products
   each over the TF32 rate, with the FFMA rate's bound beside it).  The
   window's body counters (``kernels.flash_attention.BODY_LAUNCHES``) must
   show the f32 cases on the 3xTF32 body and the bf16 cases on the
   ``wgmma`` body.  An eighth counted window, ``attention_mma``, runs the
   ``mma.sync`` body (``flash_attention_bf16_mma``, the ``wgmma`` body's
   yardstick) once per bf16 case on the same inputs, held to the same rule
   and timed beside it (``mma_ms``); a ninth, ``attention_ffma``, runs
   the FFMA body (``flash_attention_f32_ffma``, the 3xTF32 body's
   yardstick) once per f32 case, held to the f32 rule and timed beside it
   (``ffma_ms``).  Outside the windows the ``wgmma`` body is timed at
   internlm2-1.8b's B, S and H at hd 64 and 128 (``attention_split``: how
   its time divides between its products and the rest);
5. the LM serving path (``lm``; ``--only-lm`` runs it alone, with no
   build: it launches no kernel of the port, so it adds no row to the
   kernels line): internlm2-1.8b at full width and depth (24 layers,
   d_model 2048, 16 heads of 128 over 8 KV heads, d_ff 8192, vocab 92544;
   weights from ``torch.Generator("cuda").manual_seed(0)``), TF32 off:
   (a) f32 serving, B = 4, prompt 64, gen 32, through ``serve.main``
   (``--mode lm``), twice (cold, then warm), every logit finite and every
   id inside the vocabulary; (b) the full ``forward`` over 65 tokens
   against prefill of 64 and one ``decode_step``, within 2e-3, then warm
   decode steps timed and profiled (``lm_decode_profile``: wall and device
   ms a step, busy share, kernels launched, the costliest kernels); (c) B = 1,
   a 4096-token prompt whose prefill takes ``_chunked_sdpa`` on all 24
   layers, then gen 8, and layer 0's ``_chunked_sdpa`` against its
   ``_sdpa`` within 2e-5 (both timed); (d) the same weights cut to 2
   layers, prefill logits on the card against the port on the CPU within
   1e-4 of the largest; (e) (a) again in bf16.  Then the MoE models at
   full width, each freed before the next (``moe_serve_check``): (f)
   qwen3-moe-235b-a22b (d_model 4096, 64 heads of 128 over 4 KV heads,
   qk-norm, 128 experts of d_ff 1536, top-8, vocab 151936) cut to 4 layers,
   f32, B = 4, prompt 64, gen 32 through ``launch.serve.lm_generate`` twice
   (prefill on the dispatch path, its drops printed a layer; decode on the
   gather path, never dropping); (g) its layer 0's ``moe_forward`` alone on
   the card against the same weights on the host at 4 tokens (gather) and
   256 (dispatch), within 1e-4 of the largest output with the same drops;
   (h) llama4-maverick-400b-a17b (d_model 5120, 40 heads over 8 KV heads,
   128 experts of d_ff 8192, top-1, a shared expert, dense_ff 16384, vocab
   202048) cut to one dense + MoE superlayer, bf16, gen 8.  Each of (f) and
   (h): every logit finite, every id inside the vocabulary, a second
   prefill bitwise the first, decode against the full forward at the
   no-drop capacity (f32 within 2e-3; bf16 within 2⁻⁵ of the largest
   logit), a profiled warm decode step.  Then the SSD models at full width
   and depth, each freed before the next: (i) mamba2-780m (48 SSD layers,
   d_model 1536, 48 SSD heads of 64, state 128, chunk 128, vocab 50280,
   tied embeddings) served in f32 and in bf16, B = 4, prompt 64 replayed
   through decode steps (no prefill carries an SSM state), gen 32
   (``ssm_serve_check``: once; the 96 tokens fed replayed again, its prefill
   logits bitwise the served run's, its argmaxes the served tokens, and
   against a full ``forward`` within 2e-3 in f32, the gap printed in bf16;
   a profiled warm step); (j) hymba-1.5b (32 layers of sliding-window attention, 25 heads of
   64 over 5 KV heads, window 2048, beside an SSD block of 50 heads, state
   16, d_ff 5504, vocab 32001) likewise in f32; (k) (i)'s layer 0 SSD block
   alone, f32, B = 1, on the card against the host at 4096 tokens (32
   chunks of 128) and 320 (chunks of 80) with ``return_cache``, within 1e-4
   of the largest, and the 4096 tokens replayed through ``ssm_decode`` on
   the card, its state against ``return_cache``'s; (l) one f32 decode step,
   B = 1, of each model from ``synthetic_batch``'s long_500k (position
   524,288) and decode_32k (32,768) batches, every logit finite, the step's
   ms and the caches' bytes.  Then the enc-dec model (``encdec_check``):
   (m) seamless-m4t-large-v2 at full width and depth (24 bidirectional
   encoder layers over the audio stub's frames, 24 decoder layers with
   cross-attention, d_model 1024, 16 heads of 64, d_ff 8192 GeGLU, vocab
   256206, untied; 2,034,784,256 parameters, the count checked): (m1) f32
   served through ``serve.main``, B = 4, prompt 64 over 16 source frames,
   gen 32, cold then warm, every logit finite, every id inside the
   vocabulary, the same tokens twice; (m2) the full ``forward`` over 65
   tokens against a prefill of 64 and one ``decode_step`` reading its cross
   kvs, on the same source, within 2e-3, then warm decode steps profiled;
   (m3) B = 1, a 4096-token prompt over 1024 frames, gen 8: the decoder's
   prefill takes ``_chunked_sdpa`` on all 24 layers, the encoder's
   bidirectional ``_sdpa`` runs over all 1024 frames on all 24 of its
   layers, every logit finite; (m4) the same weights cut to 2 encoder and 2
   decoder layers, prefill logits and cross kvs on the card against the
   port on the CPU within 1e-4 of the largest; (m5) (m1) once in bf16 and
   its decode against its forward within 2⁻⁵ of the largest logit.
   Printed: prefill seconds, decode tokens/s and peak memory of (a), (c),
   (e), (f), (h), (i), (j), (m1), (m3) and (m5), parameter counts, each
   part's and the phase's seconds;
6. the LM training path (``train``, after ``lm``; ``--only-train`` runs it
   alone, with no build: ``lm_loss``, ``make_train_step`` and AdamW launch
   no kernel of the port, as the reference's training path reaches no
   Pallas kernel), TF32 off: (t1) internlm2-1.8b at full width cut to 2
   layers, f32, one ``make_train_step`` on the card and on the CPU from the
   same weights (drawn on the card, copied) and the same pipeline batch (B =
   2, S = 128): loss and grad norm within 1e-5 relative, every gradient, m
   and v within 1e-4 of the CPU's largest magnitude of that tensor; (t2)
   ``launch/train.py``'s ``main`` at full width and depth, f32, B = 8, S =
   128, 10 steps, lr 1e-3, remat on: every loss and grad norm finite, the
   last loss below the first, the parameter count, peak GB, each warm
   step's wall and tokens/s; one warm step profiled (device ms, busy share,
   kernels, the costliest); ``accum=2`` against ``accum=1`` on one batch
   from the same weights (loss within 1e-5 relative, params within rtol
   2e-4 / atol 2e-5, the reference's bounds, but where the two runs'
   gradients differ by more than 1e-3 of themselves (near 0), where a first
   AdamW step's lr·g/(|g| + eps) is rounding noise: within 2·lr; at most
   1 % of the params outside rtol/atol); 3 steps with
   ``--compress`` and 3 in bf16, finite; (t3) mamba2-780m at full width
   and depth, f32, B = 8, S = 128 (one chunk of 128), 10 steps at lr 1e-3: every
   gradient finite at every step, the loss finite and falling, peak GB,
   step walls, tokens/s, layer 0's largest exponent above the chunk's
   diagonal, and the first batch's gradients through the chunk step that
   took ``exp`` before masking (the reference's order), which must hold a
   non-finite one; (t4) reduced internlm2: 6 steps straight, then with
   checkpoints under ``build/train_ckpt`` and a failure injected at step 3,
   then resumed: the last loss within 1e-4 of the straight run's; (t5)
   internlm2 at full width cut to 2 layers, f32, B = 8, S = 128, 3 steps on a
   ``data`` x ``model`` mesh of spawned ranks sharing the card (gloo (2, 2)
   twice, gloo (1, 4), and (1, 1) on a one-rank NCCL group: every axis group
   there has one rank, so that run launches no NCCL collective; the NCCL
   side of ``Mesh.axis_comm`` runs only in ``chip_train_mesh_nccl.py``, on
   four cards), each rank holding its blocks of the
   parameters and AdamW moments, against 3 one-device steps run first (their
   snapshots kept on the card and shared with the ranks): loss and grad norm
   within 1e-6 relative, every rank's blocks of each gradient, m, v and
   parameter within 1e-4 of the one-device tensor's largest (parameters where
   the two runs' m differ by more than 1e-3 of themselves within 2·Σ lr, at
   most 1 %), the one-rank (1, 1) bitwise, the second (2, 2) run's losses bitwise the
   first's; (t6) qwen3-moe-235b-a22b's layer 0 MoE at full width (2.42 B
   parameters), 256 tokens (the dispatch path), forward and backward on gloo
   (2, 2) against one rank: the same drops index for index, the output within
   1e-5 and every expert block's gradient within 1e-4 of the largest; (t7)
   ``python -m repro_torch.launch.train`` under ``torchrun --nproc_per_node
   4`` (gloo, the trainer's (1, 4) mesh), 2 layers at full width, 3 steps:
   its losses within 1e-6 relative of the one-device trainer's.  Printed:
   each part's seconds, peak GB per rank, the bytes staged a step, beside
   the card's name and power limit.  Then one JSON
   line listing every kernel (each solver kernel's bf16 instance too, as
   ``<kernel>_bf16``: its 128³ 27pt bf16 row, its ``kernel_api_bf16``
   launches), the four bodies of ``flash_attention``
   apart, f32's two sweeps as ``<kernel>_f32`` (their 128³ 27pt f32 rows,
   their ``precond_f32`` launches), and the contract line ``{"ok": true,
   "device": {...}}`` last.

With ``--record PATH`` the detailed record (every kernel row, the batched
kernels' rows, the autotune phase, each counted path, the graphed solves,
the warm wall times, the batched walls, the serve phase, the profiles, the
socket block, the K sweep, the mesh phases and the attention cases) is
written to ``PATH`` as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis.lint_kernels import check_kernels  # noqa: E402
from repro_torch.analysis.violation import format_violations  # noqa: E402
from repro_torch.api import SolverOptions, SolverSession  # noqa: E402
from repro_torch.core.methods import (STATUS_BREAKDOWN, STATUS_STAGNATED,  # noqa: E402
                                      Ops, SolveBreakdown, SolveResult, get_method,
                                      status_name)
from repro_torch.core.operators import STENCILS, Stencil, pad1  # noqa: E402
from repro_torch.core.problems import make_problem  # noqa: E402
from repro_torch.core.solvers import LocalOp  # noqa: E402
from repro_torch.kernels import _build, autotune, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import bicgstab_fused as bicgstab_kernels  # noqa: E402
from repro_torch.kernels import precond as precond_kernels  # noqa: E402
from repro_torch.kernels import rb_gs as rb_gs_kernels  # noqa: E402
from repro_torch.kernels.stencil_spmv import (F32_PAIR_KERNELS, RING_STAGES,  # noqa: E402
                                              card_ring_stage, ring_stage)
from repro_torch.precond import Chebyshev  # noqa: E402
from repro_torch.resilience import ChaosInjector, ChaosPlan  # noqa: E402
from repro_torch.resilience.__main__ import run_smoke  # noqa: E402
from repro_torch.runtime.monitor import FailureInjector  # noqa: E402
from repro_torch.serve import (ServeConfig, SolverService, TraceBucket,  # noqa: E402
                               generate_trace, replay)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, SyntheticSource, make_batch  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.optim.schedules import for_arch  # noqa: E402
from repro_torch.models import attention as lm_attention  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import ssm as lm_ssm  # noqa: E402
from repro_torch.models import steps as lm_steps  # noqa: E402
from repro_torch.models import transformer as lm_transformer  # noqa: E402
from repro_torch.models.common import causal_mask, rms_norm  # noqa: E402
from repro_torch.models.decode import caches_from_prefill, init_caches  # noqa: E402
from repro_torch.models.transformer import (Transformer, embed_tokens,  # noqa: E402
                                            forward, init_params, layer_kinds)

RANK_BLOCK = (128, 128, 128)
SOCKET_BLOCK = (128, 128, 3072)

#: name fragment -> (memory bytes/s, f64 op/s, f32 op/s without tensor cores,
#: dense bf16 op/s on the tensor cores, dense TF32 op/s on the tensor cores:
#: half the bf16 rate, bf16 op/s without tensor cores: twice the f32 rate,
#: on packed bf16x2 pairs), NVIDIA's data sheets and, for the last, the
#: Hopper architecture white paper (133.8 TFLOP/s on the SXM5 part); the
#: first fragment found in the card's name wins
CARD_PEAKS = (
    ("H100 PCIe", (2.0e12, 25.6e12, 51.2e12, 756e12, 378e12, 102.4e12)),
    ("H100 NVL", (3.9e12, 30e12, 60e12, 835e12, 417.5e12, 120e12)),
    ("H100", (3.35e12, 34e12, 67e12, 989e12, 494.5e12, 133.8e12)),   # SXM5, 80 GB HBM3
    ("H200", (4.8e12, 34e12, 67e12, 989e12, 494.5e12, 133.8e12)),
)
#: the dtypes of phase 1's and the batched kernels' loop (bf16 last, so the
#: f64 and f32 rows draw the random inputs they always drew)
KERNEL_DTYPES = (torch.float64, torch.float32, torch.bfloat16)

#: kernel -> its source, the TPU kernel it replaces, and the path whose
#: counted window must launch it ("main", "precond", "pipe", "bicgstab",
#: "kernel_api" or "batched" of phase 2, "attention", "attention_mma" or
#: "attention_ffma" of phase 4)
KERNELS = {
    "stencil_spmv": dict(source="src/repro_torch/kernels/csrc/stencil_spmv.cu",
                         replaces="src/repro/kernels/stencil_spmv.py:100",
                         path="main"),
    "stencil_spmv_dots": dict(source="src/repro_torch/kernels/csrc/spmv_dot.cu",
                              replaces="src/repro/kernels/spmv_dot.py:58",
                              path="main"),
    "fused_cg_body": dict(source="src/repro_torch/kernels/csrc/cg_fused_update.cu",
                          replaces="src/repro/kernels/cg_fused_update.py:109",
                          path="main"),
    "stencil_spmv_dots3": dict(source="src/repro_torch/kernels/csrc/spmv_dot.cu",
                               replaces="src/repro/kernels/spmv_dot.py:114",
                               path="precond"),
    "fused_pcg_body": dict(source="src/repro_torch/kernels/csrc/fused_bodies.cu",
                           replaces="src/repro/kernels/fused_bodies.py:166",
                           path="precond"),
    "cheb_fused_step": dict(source="src/repro_torch/kernels/csrc/precond.cu",
                            replaces="src/repro/kernels/precond.py:52",
                            path="precond"),
    "block_jacobi_sweep": dict(source="src/repro_torch/kernels/csrc/precond.cu",
                               replaces="src/repro/kernels/precond.py:97",
                               path="precond"),
    "fused_pipe_body": dict(source="src/repro_torch/kernels/csrc/fused_bodies.cu",
                            replaces="src/repro/kernels/fused_bodies.py:115",
                            path="pipe"),
    "fused_dots": dict(source="src/repro_torch/kernels/csrc/fused_bodies.cu",
                       replaces="src/repro/kernels/fused_bodies.py:68",
                       path="pipe"),
    "fused_ppipe_body": dict(source="src/repro_torch/kernels/csrc/fused_bodies.cu",
                             replaces="src/repro/kernels/fused_bodies.py:223",
                             path="pipe"),
    "bicgstab_fused_spmv_dots": dict(
        source="src/repro_torch/kernels/csrc/bicgstab_fused.cu",
        replaces="src/repro/kernels/bicgstab_fused.py:69", path="bicgstab"),
    "bicgstab_fused_update1": dict(
        source="src/repro_torch/kernels/csrc/fused_bodies.cu",
        replaces="src/repro/kernels/fused_bodies.py:274", path="bicgstab"),
    "bicgstab_fused_spmv_update": dict(
        source="src/repro_torch/kernels/csrc/bicgstab_fused.cu",
        replaces="src/repro/kernels/bicgstab_fused.py:134", path="bicgstab"),
    "fused_axpby": dict(source="src/repro_torch/kernels/csrc/fused_axpby.cu",
                        replaces="src/repro/kernels/fused_axpby.py:58", path="kernel_api"),
    "fused_axpby_dot": dict(source="src/repro_torch/kernels/csrc/fused_axpby.cu",
                            replaces="src/repro/kernels/fused_axpby.py:96",
                            path="kernel_api"),
    "cg_fused_update": dict(source="src/repro_torch/kernels/csrc/cg_fused_update.cu",
                            replaces="src/repro/kernels/cg_fused_update.py:54",
                            path="kernel_api"),
    "rb_gs_half_sweep": dict(source="src/repro_torch/kernels/csrc/rb_gs.cu",
                             replaces="src/repro/kernels/rb_gs.py:52", path="kernel_api"),
    "flash_attention": dict(source="src/repro_torch/kernels/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:71",
                            path="attention"),
    "flash_attention_bf16": dict(source="src/repro_torch/kernels/csrc/flash_attention.cu",
                                 replaces="src/repro/kernels/flash_attention.py:71",
                                 path="attention"),
    "flash_attention_bf16_mma": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:71", path="attention_mma"),
    "flash_attention_f32_ffma": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:71", path="attention_ffma"),
    # the lane-batched forms: the vmapped pallas_call of the batched solve
    "stencil_spmv_batched": dict(source="src/repro_torch/kernels/csrc/stencil_spmv.cu",
                                 replaces="src/repro/kernels/stencil_spmv.py:100",
                                 path="batched"),
    "cheb_fused_step_batched": dict(source="src/repro_torch/kernels/csrc/precond.cu",
                                    replaces="src/repro/kernels/precond.py:52",
                                    path="batched"),
    "block_jacobi_sweep_batched": dict(source="src/repro_torch/kernels/csrc/precond.cu",
                                       replaces="src/repro/kernels/precond.py:97",
                                       path="batched"),
}
#: the kernels without a stencil; their rows are keyed by stencil "-"
BODY_KERNELS = ("fused_cg_body", "fused_pcg_body", "fused_pipe_body", "fused_dots",
                "fused_ppipe_body", "bicgstab_fused_update1", "fused_axpby",
                "fused_axpby_dot", "cg_fused_update")
#: phase 4's cases: the attention widths of src/repro/configs/internlm2_1_8b.py
#: (16 heads of 128, full causal attention) and src/repro/configs/hymba_1_5b.py
#: (25 heads of 64, sliding_window 2048), one sequence of 4096 tokens each,
#: KV repeated to the query heads; each in f32 and bf16
ATTENTION = {"internlm2-1.8b": dict(B=1, S=4096, H=16, hd=128, window=0),
             "hymba-1.5b": dict(B=1, S=4096, H=25, hd=64, window=2048)}
#: the kernels line's entry of each body of flash_attention (a __global__
#: each): name -> (dtype, body); its row is the internlm2-1.8b case in that
#: dtype, its launches the body's count in its path's window
ATTENTION_ENTRIES = {"flash_attention": (torch.float32, "tf32x3"),
                     "flash_attention_bf16": (torch.bfloat16, "wgmma"),
                     "flash_attention_bf16_mma": (torch.bfloat16, "mma"),
                     "flash_attention_f32_ffma": (torch.float32, "ffma")}
#: the order of the BiCGStab pass's nine partials
BICG_PARTS = ("q·y", "y·y", "q·q", "r̂·q", "r̂·y", "r̂·t", "r̂·v", "r̂·z", "r̂·s")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_peaks(name: str):
    for frag, peaks in CARD_PEAKS:
        if frag in name:
            return peaks
    raise SmokeFailure(f"no peak rates known for card {name!r}")


def tols(dt):
    """(output rtol=atol, partial rtol): the CPU tests' tolerances.  In bf16
    the outputs are bitwise the plain version's (0) and a partial lies
    within 1e-5 of Σ|a_i·b_i| over its operands (:func:`part_ok`)."""
    return {torch.float64: (1e-12, 1e-11), torch.float32: (1e-5, 1e-4),
            torch.bfloat16: (0.0, 1e-5)}[dt]


def part_ok(got, want, a, b) -> bool:
    """A partial ``got`` against the plain version's ``want`` of Σ a·b: in
    bf16 within 1e-5·Σ|a_i·b_i| (both are f32 sums of f32 products, in
    other orders), else within the partial rtol of ``want``."""
    dt = a.dtype
    rtol = tols(dt)[1]
    if dt == torch.bfloat16:
        return abs(float(got) - float(want)) <= rtol * float(
            (a.double() * b.double()).abs().sum())
    return abs(float(got) - float(want)) <= rtol * abs(float(want))


def op_rate(peaks, dt) -> float:
    """The rate of the solver kernels' operations in ``dt``: each multiply
    and add is rounded on its own (no FMA), so half the FLOP/s peak without
    tensor cores (in bf16 the packed bf16x2 rate's half)."""
    return {torch.float64: peaks[1], torch.float32: peaks[2],
            torch.bfloat16: peaks[5]}[dt] / 2


class Timer:
    """CUDA-event time of one call, median of ``n``, with the 50 MB L2 cache
    flushed before each launch, as the solver's loop finds it: every
    iteration streams more than L2 holds.  The flush *reads* a 512 MiB
    buffer written once here, so the timed call finds L2 full of clean
    lines; a flush that writes (``zero_()``) leaves up to 50 MB of dirty
    lines for the timed call to write back first."""

    def __init__(self, n: int = 25):
        self.n = n
        self.flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.n):
            self.flush.sum()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def max_err(pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def conv_weights(st, dt):
    w = torch.zeros((1, 1, 3, 3, 3), dtype=dt, device="cuda")
    w[0, 0, 1, 1, 1] = st.diag
    for dx, dy, dz in st.offsets:
        w[0, 0, 1 + dx, 1 + dy, 1 + dz] = st.off_coeff
    return w


def api_check(vecs, a, b, c, what: str) -> dict:
    """``ops.axpbypcz``, ``ops.axpbypcz_dot`` and ``ops.cg_update`` (β = b)
    on ``vecs`` = (x, y, z, w) against their plain versions: vector outputs
    within the output tolerance (bitwise equal in f64 and bf16), partials
    within the partial tolerance (:func:`part_ok`) and bitwise equal from
    run to run.  Returns each kernel's max abs error."""
    x, y, z, w = vecs
    dt = x.dtype
    out_tol = tols(dt)[0]
    got = (ops.axpbypcz(a, x, b, y, c, z), ops.axpbypcz_dot(a, x, b, y, c, z, w),
           ops.cg_update(b, x, y, z, w))
    again = (ops.axpbypcz_dot(a, x, b, y, c, z, w), ops.cg_update(b, x, y, z, w))
    want = (ref.fused_axpby_ref(a, x, b, y, c, z),
            ref.fused_axpby_dot_ref(a, x, b, y, c, z, w),
            ref.cg_fused_update_ref(b, x, y, z, w))
    torch.cuda.synchronize()
    vec_pairs = {"fused_axpby": [(got[0], want[0])],
                 "fused_axpby_dot": [(got[1][0], want[1][0])],
                 "cg_fused_update": [(got[2][0], want[2][0]), (got[2][1], want[2][1])]}
    part_pairs = {"fused_axpby_dot": (got[1][1], again[0][1], want[1][1], want[1][0], w),
                  "cg_fused_update": (got[2][2], again[1][2], want[2][2], want[2][1],
                                      want[2][0])}
    for name, pairs in vec_pairs.items():
        for g, wv in pairs:
            check(torch.allclose(g, wv, rtol=out_tol, atol=out_tol),
                  f"{name} {what} {dt}: max err {max_err([(g, wv)])}")
            check(dt == torch.float32 or torch.equal(g, wv),
                  f"{name} {what} {dt}: not bitwise equal to the plain version")
    for name, (g, g2, wv, pa, pb) in part_pairs.items():
        check(part_ok(g, wv, pa, pb), f"{name} {what} {dt} partial: {float(g)} vs {float(wv)}")
        check(torch.equal(g, g2), f"{name} {what} {dt}: partial not reproducible")
        vec_pairs[name].append((g, wv))
    return {name: max_err(pairs) for name, pairs in vec_pairs.items()}


def set_bounds(row: dict, bw: float) -> None:
    """``bound_ms``/``bound_by`` of a kernel row from its ``bytes`` and
    ``ops`` (the latter over ``peak_ops``), and ``padded_bound_ms`` from
    ``padded_bytes`` where the row times the padded form too."""
    t_ops = row.pop("ops") / row.pop("peak_ops") * 1e3
    t_bytes = row["bytes"] / bw * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if "padded_bytes" in row:
        row["padded_bound_ms"] = max(row["padded_bytes"] / bw * 1e3, t_ops)


def stencil_abs(st, x):
    """Σ_j |c_j·x_j| at each point of the stencil applied to ``x`` (f64)."""
    absst = Stencil("abs", st.offsets, diag=abs(st.diag), off_coeff=abs(st.off_coeff))
    return absst.matvec_padded(pad1(x.double().abs()))


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past the start of a fresh
    buffer: for f32, 4 bytes past an 8-byte boundary (the pair stage's
    operands must be 8-byte aligned)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def ring_stages(x, xp) -> dict:
    """The ring pass's stage for the unpadded ``x`` and the padded ``xp``
    (``stencil_ring_stage`` of the built source, a batch of lanes alike),
    checked: the element stage in f64 and f32, bf16's pair stage in both
    forms (nz even, fresh allocations are aligned): its two z-outputs a
    thread in bf16x2 with ``kRingDepth − 2`` planes in flight."""
    got = dict(stage=card_ring_stage(x, zero_halo=True), padded_stage=card_ring_stage(xp))
    want = (dict(stage="pair_unpadded", padded_stage="pair_padded")
            if x.dtype == torch.bfloat16 else dict(stage="async", padded_stage="async"))
    check(got == want, f"ring stage of {tuple(x.shape)} {x.dtype}: {got}, expected {want}")
    return got


#: the kernels a static rule of their source puts on the ring pass in some
#: dtypes and stencils (from the padded operand), each with the Python
#: mirror of its rule, of (dtype, npoint, nz, the operand's and the
#: streams' addresses)
RING_RULES = {"block_jacobi_sweep": lambda dt, npoint, *at: precond_kernels.jacobi_pass(
                  dt, *at, npoint=npoint),
              "cheb_fused_step": lambda dt, npoint, *at: precond_kernels.cheb_pass(
                  dt, *at, npoint=npoint),
              "bicgstab_fused_spmv_dots": lambda dt, npoint, *at: bicgstab_kernels.dots_pass(dt),
              "bicgstab_fused_spmv_update":
                  lambda dt, npoint, *at: bicgstab_kernels.update_pass(dt),
              "rb_gs_half_sweep": lambda dt, npoint, *at: rb_gs_kernels.sweep_pass(dt, npoint)}
#: the (dtype, npoint) pairs besides bf16's that a rule puts on the ring (for
#: aligned operands with nz even: f32's two sweeps take its pair stage, but
#: the 7pt Chebyshev step, where that stage lost; f64's two sweeps on both
#: stencils)
RING_ALSO = {"rb_gs_half_sweep": {(torch.float64, 27)},
             "block_jacobi_sweep": {(torch.float32, 27), (torch.float32, 7),
                                    (torch.float64, 27), (torch.float64, 7)},
             "cheb_fused_step": {(torch.float32, 27), (torch.float64, 27), (torch.float64, 7)}}


def ring_route(kernel: str, dt, zp, streams=(), npoint: int = 27) -> dict:
    """The pass ``kernel`` launches in ``dt`` on the ``npoint`` stencil (its
    source's static rule, for the padded ``zp`` and the tail's unpadded
    ``streams``) and, on the ring, its stage, checked: bf16 on the ring's
    pair stage, and f32's two sweeps (the 7pt Chebyshev step on
    ``stencil_kernel``), at the built source's ``stencil_ring_stage`` of
    ``zp`` for the kernel's tail and the mirror's with the streams, which a
    tail with a pair form also needs aligned; the half-sweep's f64 27pt and
    f64's two sweeps on its element stage; the other f64 and f32 forms on
    ``stencil_kernel``."""
    nz = int(zp.shape[-1]) - 2
    ptrs = tuple(s.data_ptr() for s in streams)
    pass_ = RING_RULES[kernel](dt, npoint, nz, zp.data_ptr(), ptrs)
    on_ring = dt == torch.bfloat16 or (dt, npoint) in RING_ALSO.get(kernel, ())
    check(pass_ == ("ring" if on_ring else "stencil"),
          f"{kernel} {dt} {npoint}pt: on the {pass_} pass")
    if pass_ != "ring":
        return dict(stage_pass=pass_)
    stage = card_ring_stage(zp, kernel=kernel)
    mirror = ring_stage(dt, nz, False, zp.data_ptr(), ptrs, kernel=kernel)
    want = "async" if dt == torch.float64 else "pair_padded"
    check(stage == mirror == want, f"{kernel} {dt} {tuple(zp.shape)}: ring stage "
          f"{stage} (mirror with the streams {mirror}), expected {want}")
    return dict(stage_pass=pass_, padded_stage=stage)


def start_profiler() -> None:
    """One empty ``torch.profiler`` window on the card: the profiler's first
    start costs seconds, which the windows after it
    (:func:`ring_kernels_launched`) then do not pay."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


#: the profiler windows :func:`ring_kernels_launched` takes at most: the
#: trace of a window has been seen to lack kernel records (the first launch
#: of a window, or all of a window's launches of one kernel; never a record
#: of a wrong kernel), so a window whose records fall short of its
#: launches, with none on a wrong pass or stage, is taken again
RING_WINDOWS = 3
#: the idle seconds a window holds before its first call and after its last
#: synchronize: the profiler drops a kernel record whose time falls outside
#: its window, so a drift between the card's clock and the host's, the
#: likeliest cause of the lost records, must exceed this to lose one
RING_WINDOW_PAD_S = 0.1


def ring_window_short(events, calls, old) -> str | None:
    """The records that ``events`` (``(key, count)`` of one window's CUDA
    kernels) lack for the launches of ``calls`` and ``old`` (see
    :func:`ring_kernels_launched`), or None when it holds them all; fails at
    once on a record that shows a wrong pass, stage or tail, or a launch too
    many, which no lost record explains."""
    short = []
    for tail in dict.fromkeys(t for _, t in old):
        n = sum(c for k, c in events if "stencil_kernel" in k and tail in k)
        want = sum(t == tail for _, t in old)
        check(n <= want, f"expected {want} stencil_kernel launches with {tail}, "
              f"launched {[e for e in events if 'stencil_kernel' in e[0]]}")
        if n < want:
            short.append(f"{want - n} of {want} stencil_kernel with {tail}")
    ring = [(k, c) for k, c in events if "stencil_ring_kernel" in k]
    for _, tail, stage in calls:
        mine = [(n, c) for n, c in ring if tail in n]
        check(len(mine) <= 1 and all(c == 1 for _, c in mine),
              f"expected one stencil_ring_kernel launch with {tail}, launched {ring}")
        if not mine:
            short.append(f"the stencil_ring_kernel with {tail}")
            continue
        m = re.search(re.escape(tail) + r"\s*,\s*(true|false)\s*,\s*(\d+)\s*,\s*(\d+)\s*>",
                      mine[0][0])
        code = RING_STAGES.index(stage)           # the stage's STAGE argument
        unit = "true" if stage.startswith("pair") else "false"
        check(m is not None and m.group(1) == unit and int(m.group(2)) == code,
              f"{mine[0][0]}: not at the {stage} stage ({code}) with UNIT {unit}")
    tails = [t for _, t, _ in calls]
    check(all(any(t in k for t in tails) for k, _ in ring),
          f"ring kernels launched {ring}, expected {len(calls)} with {tails}")
    return "; ".join(short) or None


def ring_kernels_launched(calls, old=()) -> list[str]:
    """The ring-pass kernel each call of ``calls`` launches, ``(fn, tail,
    stage)`` each, all in one ``torch.profiler`` window (its first start
    costs seconds): one ``stencil_ring_kernel`` a call with ``tail`` (in its
    demangled name, e.g. ``JacobiTail<__nv_bfloat16>``, or ``<double, 27,
    repro::ChebTail<double>`` with the stencil) at ``stage``, on a pair
    stage with the fma terms (UNIT: the stencils' off is −1), checked; their
    names.
    Each call of ``old``, ``(fn, tail)``, must launch one ``stencil_kernel``
    with ``tail`` and no ring kernel (a launch its source's rule keeps on
    the old pass).  Each window starts with a launch, a synchronize and
    :data:`RING_WINDOW_PAD_S` idle seconds, and ends with as many; a window
    whose trace lacks records (:func:`ring_window_short`) is taken again, up
    to :data:`RING_WINDOWS` windows, each lack printed."""
    from torch.profiler import ProfilerActivity, profile
    fence = torch.zeros(1, device="cuda")
    for window in range(1, RING_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fence.add_(1)
            torch.cuda.synchronize()
            time.sleep(RING_WINDOW_PAD_S)
            for fn, _, _ in calls:
                fn()
            for fn, _ in old:
                fn()
            torch.cuda.synchronize()
            time.sleep(RING_WINDOW_PAD_S)
        events = [(e.key, e.count) for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
        short = ring_window_short(events, calls, old)
        if short is None:
            return [next(k for k, _ in events if "stencil_ring_kernel" in k and t in k)
                    for _, t, _ in calls]
        print(f"[kernels] profiler window {window} of {RING_WINDOWS} lacks records: {short}; "
              f"its CUDA events {events}")
    check(False, f"{RING_WINDOWS} profiler windows lacked records, the last {short}")


def f64_sweeps_launched(x, xp, r, d) -> dict:
    """f64's ``block_jacobi_sweep`` and ``cheb_fused_step`` (one lane, or a
    batch of lanes) on the 27pt and 7pt stencils, each launching one
    ``stencil_ring_kernel`` at the element stage, from ``xp`` padded in one
    profiler window and from ``x`` unpadded in another (the two forms run
    one instance, which one window cannot tell apart), with the old pass's
    yardstick launch (``old_pass``) on ``stencil_kernel`` in the first:
    ``{kernel: (27pt name, 7pt name)}`` of the unpadded window."""
    names = {}
    for z, zh in ((xp, False), (x, True)):
        calls, keys = [], []
        for sname in ("27pt", "7pt"):
            s = STENCILS[sname]
            a, c = Chebyshev().setup(LocalOp(s))[1][0]
            calls += [(lambda s=s: ops.jacobi_sweep(z, r, s, omega=1.0, zero_halo=zh),
                       f"<double, {s.npoint}, repro::JacobiTail<double>", "async"),
                      (lambda s=s, a=a, c=c: ops.cheb_step(z, r, d, s, a=a, c=c, zero_halo=zh),
                       f"<double, {s.npoint}, repro::ChebTail<double>", "async")]
            keys += ["block_jacobi_sweep", "cheb_fused_step"]
        s27 = STENCILS["27pt"]
        old = [] if zh else [
            (lambda: precond_kernels.block_jacobi_sweep(z, r, stencil=s27, old_pass=True),
             "<double, 27, repro::JacobiTail<double>"),
            (lambda: precond_kernels.cheb_fused_step(z, r, d, stencil=s27, a=0.5, c=0.25,
                                                     old_pass=True),
             "<double, 27, repro::ChebTail<double>")]
        launched = ring_kernels_launched(calls, old=old)
        names = {k: (launched[i], launched[i + 2]) for i, k in enumerate(keys[:2])}
    return names


def phase_kernels(timer: Timer, peaks) -> dict:
    """Phase 1: each kernel against its plain version at 128³, in f64, f32
    and bf16 (bf16 outputs bitwise, partials f32 within 1e-5·Σ|a_i·b_i|)."""
    bw = peaks[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    t_prof = time.perf_counter()
    start_profiler()
    print(f"[kernels] the profiler's first start took {time.perf_counter() - t_prof:.2f}s")
    for dt in KERNEL_DTYPES:
        t_dt = time.perf_counter()
        # each multiply and add is rounded on its own (no FMA): the
        # instruction rate, half the FLOP/s peak
        peak_ops = op_rate(peaks, dt)
        es = torch.finfo(dt).bits // 8
        ps = 4 if dt == torch.bfloat16 else es      # a partial's bytes (f32 in bf16)
        out_tol = tols(dt)[0]
        for sname in ("27pt", "7pt"):
            st = STENCILS[sname]
            x = torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
            xp = pad1(x)
            n, npad = x.numel(), xp.numel()

            def close(a, b, what):
                check(torch.allclose(a, b, rtol=out_tol, atol=out_tol),
                      f"{what} {sname} {dt}: max err {max_err([(a, b)])}")

            def close_part(a, b, what, pa, pb):
                check(a.dtype == (torch.float32 if dt == torch.bfloat16 else dt) and
                      part_ok(a, b, pa, pb),
                      f"{what} partial {sname} {dt}: {float(a)} vs {float(b)}")

            def bitwise(got, want, what):
                for g, w in zip(got, want):
                    close(g, w, what)
                    check(dt == torch.float32 or torch.equal(g, w),
                          f"{what} {sname} {dt}: not bitwise equal to the plain version")

            # kernel 1: the SpMV and its fuse_dot form on the plane-ring pass,
            # from x unpadded (the zero halo made in the kernel: the form the
            # solves run) and from x padded (the reference's signature); the
            # row's ms, plain_ms, library_ms and bound are the unpadded
            # form's, padded_ms and padded_bound_ms the padded form's
            # the ring pass's stage for these operands (bf16: the pair
            # stage, both forms; a launch on the ring takes it)
            stages = ring_stages(x, xp)
            y = ops.spmv(x, st, zero_halo=True)
            yp = ops.spmv(xp, st)
            yr = ref.stencil_spmv_ref(xp, stencil=st)
            y1, d1 = ops.spmv_dot(x, st, zero_halo=True)
            y1p, d1p = ops.spmv_dot(xp, st)
            _, dr = ref.stencil_spmv_dot_ref(xp, stencil=st)
            _, d1b = ops.spmv_dot(x, st, zero_halo=True)
            torch.cuda.synchronize()
            bitwise((y, yp, y1, y1p), (yr,) * 4, "stencil_spmv")
            close_part(d1, dr, "stencil_spmv(fuse_dot)", yr, x)
            close_part(d1p, dr, "stencil_spmv(fuse_dot, padded)", yr, x)
            check(torch.equal(d1, d1b), "stencil_spmv: partial not reproducible")
            w = conv_weights(st, dt)
            conv = F.conv3d(x[None, None], w, padding=1)[0, 0]
            # bf16: the library's one rounding against the plain version's
            # per-op roundings, within 2⁻⁴·Σ|c_j·x_j| at each point
            check(torch.allclose(conv, yr, rtol=1e-4, atol=1e-4) if dt != torch.bfloat16
                  else bool(((conv.double() - yr.double()).abs()
                             <= 2.0 ** -4 * stencil_abs(st, x)).all()),
                  "conv3d library call disagrees with the stencil")
            del conv
            ops_k1 = n * (2 * st.npoint - 1)
            rows[("stencil_spmv", sname, str(dt))] = dict(
                max_abs_err=max_err([(y, yr), (yp, yr), (y1, yr), (y1p, yr), (d1, dr),
                                     (d1p, dr)]),
                ms=timer.ms(lambda: ops.spmv(x, st, zero_halo=True)),
                padded_ms=timer.ms(lambda: ops.spmv(xp, st)),
                plain_ms=timer.ms(lambda: ref.stencil_spmv_ref(pad1(x), stencil=st)),
                library_ms=timer.ms(lambda: F.conv3d(x[None, None], w, padding=1)),
                bytes=2 * n * es, padded_bytes=(npad + n) * es, ops=ops_k1,
                peak_ops=peak_ops, **stages)

            # kernel 2: the SpMV with both merged-CG partials on the
            # plane-ring pass, in both forms of x as kernel 1
            wv, de, ga = ops.spmv_dots(x, st, zero_halo=True)
            wvp, *parts2_p = ops.spmv_dots(xp, st)
            _, der, gar = ref.stencil_spmv_dots_ref(xp, stencil=st)
            _, de2, ga2 = ops.spmv_dots(x, st, zero_halo=True)
            torch.cuda.synchronize()
            bitwise((wv, wvp), (yr, yr), "stencil_spmv_dots")
            for got, got_p, want, what, pair in zip((de, ga), parts2_p, (der, gar),
                                                    ("delta", "gamma"), ((yr, x), (x, x))):
                close_part(got, want, f"stencil_spmv_dots {what}", *pair)
                close_part(got_p, want, f"stencil_spmv_dots {what} (padded)", *pair)
            check(torch.equal(de, de2) and torch.equal(ga, ga2),
                  "stencil_spmv_dots: partials not reproducible")
            rows[("stencil_spmv_dots", sname, str(dt))] = dict(
                max_abs_err=max_err([(wv, yr), (wvp, yr), (de, der), (ga, gar),
                                     *zip(parts2_p, (der, gar))]),
                ms=timer.ms(lambda: ops.spmv_dots(x, st, zero_halo=True)),
                padded_ms=timer.ms(lambda: ops.spmv_dots(xp, st)),
                plain_ms=timer.ms(lambda: ref.stencil_spmv_dots_ref(pad1(x), stencil=st)),
                library_ms=None,
                bytes=2 * n * es + 2 * ps, padded_bytes=(npad + n) * es + 2 * ps,
                ops=ops_k1 + 4 * n, peak_ops=peak_ops, **stages)

            # kernel 4: the SpMV with merged PCG's three partials (r unpadded)
            # on the plane-ring pass, in both forms of x as kernel 1
            r = torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
            y3, yx, rx, rr = ops.spmv_dots3(x, r, st, zero_halo=True)
            y3p, *parts_p = ops.spmv_dots3(xp, r, st)
            _, yxr, rxr, rrr = ref.stencil_spmv_dots3_ref(xp, r, stencil=st)
            _, yx2, rx2, rr2 = ops.spmv_dots3(x, r, st, zero_halo=True)
            torch.cuda.synchronize()
            bitwise((y3, y3p), (yr, yr), "stencil_spmv_dots3")
            for got, got_p, want, what, pair in zip((yx, rx, rr), parts_p, (yxr, rxr, rrr),
                                                    ("y·x", "r·x", "r·r"),
                                                    ((yr, x), (r, x), (r, r))):
                close_part(got, want, f"stencil_spmv_dots3 {what}", *pair)
                close_part(got_p, want, f"stencil_spmv_dots3 {what} (padded)", *pair)
            check(torch.equal(yx, yx2) and torch.equal(rx, rx2) and torch.equal(rr, rr2),
                  "stencil_spmv_dots3: partials not reproducible")
            rows[("stencil_spmv_dots3", sname, str(dt))] = dict(
                max_abs_err=max_err([(y3, yr), (y3p, yr), (yx, yxr), (rx, rxr), (rr, rrr),
                                     *zip(parts_p, (yxr, rxr, rrr))]),
                ms=timer.ms(lambda: ops.spmv_dots3(x, r, st, zero_halo=True)),
                padded_ms=timer.ms(lambda: ops.spmv_dots3(xp, r, st)),
                plain_ms=timer.ms(lambda: ref.stencil_spmv_dots3_ref(
                    pad1(x), r, stencil=st)),
                library_ms=None,
                bytes=3 * n * es + 3 * ps, padded_bytes=(npad + 2 * n) * es + 3 * ps,
                ops=ops_k1 + 6 * n, peak_ops=peak_ops, **stages)

            # kernel 16: one Chebyshev step, with the (a, c) of the first step
            # of the default schedule on this stencil, from z unpadded (the
            # zero halo made in the kernel: the form the solves run) and
            # padded; on the ring pass but for f32's launches without its pair
            # stage (precond.cu's rule).  Both forms bitwise each other, f64
            # also bitwise the plain version and the old pass (its yardstick
            # launch, old_pass); the row's ms is the unpadded form's,
            # padded_ms the padded form's, old_pad_ms (f64, f32) the old pass
            # behind the pad it needs
            d = torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
            cheb_a, cheb_c = Chebyshev().setup(LocalOp(st))[1][0]
            cheb = ring_route("cheb_fused_step", dt, xp, (r, d), st.npoint)
            zn, dn = ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c)
            znu, dnu = ops.cheb_step(x, r, d, st, a=cheb_a, c=cheb_c, zero_halo=True)
            znr, dnr = ref.cheb_fused_step_ref(xp, r, d, stencil=st, a=cheb_a, c=cheb_c)
            torch.cuda.synchronize()
            close(zn, znr, "cheb_fused_step z")
            close(dn, dnr, "cheb_fused_step d")
            check(torch.equal(zn, znu) and torch.equal(dn, dnu),
                  f"cheb_fused_step {sname} {dt}: the unpadded form differs from the padded")
            old_pad = {}
            if dt != torch.bfloat16:
                old = precond_kernels.cheb_fused_step(x, r, d, stencil=st, a=cheb_a, c=cheb_c,
                                                      zero_halo=True, old_pass=True)
                check(torch.equal(old[0], zn) and torch.equal(old[1], dn),
                      f"cheb_fused_step {sname} {dt}: the ring differs from the old pass")
                old_pad = dict(old_pad_ms=timer.ms(lambda: precond_kernels.cheb_fused_step(
                    x, r, d, stencil=st, a=cheb_a, c=cheb_c, zero_halo=True, old_pass=True)))
            if dt == torch.float64:
                bitwise((zn, dn), (znr, dnr), "cheb_fused_step")
            rows[("cheb_fused_step", sname, str(dt))] = dict(
                max_abs_err=max_err([(zn, znr), (dn, dnr), (znu, znr), (dnu, dnr)]),
                ms=timer.ms(lambda: ops.cheb_step(x, r, d, st, a=cheb_a, c=cheb_c,
                                                  zero_halo=True)),
                padded_ms=timer.ms(lambda: ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c)),
                plain_ms=timer.ms(lambda: ref.cheb_fused_step_ref(
                    pad1(x), r, d, stencil=st, a=cheb_a, c=cheb_c)),
                library_ms=None, bytes=5 * n * es, padded_bytes=(npad + 4 * n) * es,
                ops=ops_k1 + 5 * n, peak_ops=peak_ops, **old_pad, **cheb)

            # kernel 17: one block-Jacobi sweep (the solver's default ω = 1),
            # in both forms of z as kernel 16
            jacobi = ring_route("block_jacobi_sweep", dt, xp, (r,), st.npoint)
            zs = ops.jacobi_sweep(xp, r, st, omega=1.0)
            zsu = ops.jacobi_sweep(x, r, st, omega=1.0, zero_halo=True)
            zsr = ref.block_jacobi_sweep_ref(xp, r, stencil=st, omega=1.0)
            torch.cuda.synchronize()
            close(zs, zsr, "block_jacobi_sweep")
            check(torch.equal(zs, zsu),
                  f"block_jacobi_sweep {sname} {dt}: the unpadded form differs from the padded")
            old_pad = {}
            if dt != torch.bfloat16:
                check(torch.equal(zs, precond_kernels.block_jacobi_sweep(
                    x, r, stencil=st, omega=1.0, zero_halo=True, old_pass=True)),
                      f"block_jacobi_sweep {sname} {dt}: the ring differs from the old pass")
                old_pad = dict(old_pad_ms=timer.ms(lambda: precond_kernels.block_jacobi_sweep(
                    x, r, stencil=st, omega=1.0, zero_halo=True, old_pass=True)))
            if dt == torch.float64:
                bitwise((zs,), (zsr,), "block_jacobi_sweep")
            rows[("block_jacobi_sweep", sname, str(dt))] = dict(
                max_abs_err=max_err([(zs, zsr), (zsu, zsr)]),
                ms=timer.ms(lambda: ops.jacobi_sweep(x, r, st, omega=1.0, zero_halo=True)),
                padded_ms=timer.ms(lambda: ops.jacobi_sweep(xp, r, st, omega=1.0)),
                plain_ms=timer.ms(lambda: ref.block_jacobi_sweep_ref(
                    pad1(x), r, stencil=st, omega=1.0)),
                library_ms=None, bytes=3 * n * es, padded_bytes=(npad + 2 * n) * es,
                ops=ops_k1 + 4 * n, peak_ops=peak_ops, **old_pad, **jacobi)
            del znu, dnu, zsu

            # kernels 13 and 14: single-reduction BiCGStab's two stencil
            # passes.  The padded operand xp is not z padded (M(z) when
            # preconditioned); the f64 vector outputs must be bitwise equal
            # to the plain version's, the partials bitwise reproducible
            bv = [torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
                  for _ in range(6)]
            al, om, be = (torch.tensor(c, dtype=dt, device="cuda")
                          for c in (0.37, 1.3, -0.41))
            bicg = ring_route("bicgstab_fused_spmv_dots", dt, xp, bv)
            upd = ring_route("bicgstab_fused_spmv_update", dt, xp, bv)
            gs = ring_route("rb_gs_half_sweep", dt, xp, (r,), st.npoint)
            ring_names = {}
            if dt == torch.bfloat16 and sname == "27pt":
                # the bf16 ring rows' launched instances, one profiler window
                names = ring_kernels_launched([
                    (lambda: ops.spmv(x, st, zero_halo=True), "SpmvTail<__nv_bfloat16, 0>",
                     "pair_unpadded"),
                    (lambda: ops.jacobi_sweep(xp, r, st, omega=1.0),
                     "JacobiTail<__nv_bfloat16>", "pair_padded"),
                    (lambda: ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c),
                     "ChebTail<__nv_bfloat16>", "pair_padded"),
                    (lambda: ops.bicgstab_spmv_dots(xp, *bv, al, st),
                     "BicgDotsTail<__nv_bfloat16>", "pair_padded"),
                    (lambda: ops.bicgstab_spmv_update(xp, *bv, om, be, st),
                     "BicgUpdateTail<__nv_bfloat16>", "pair_padded"),
                    (lambda: ops.gs_half_sweep(xp, r, st, 0), "RbGsTail<__nv_bfloat16>",
                     "pair_padded")])
                ring_names = dict(zip(("stencil_spmv", "block_jacobi_sweep", "cheb_fused_step",
                                       "bicgstab_fused_spmv_dots", "bicgstab_fused_spmv_update",
                                       "rb_gs_half_sweep"), names))
            if dt == torch.float32 and sname == "27pt":
                # f32's two sweeps on the ring's pair stage; a copy of z at a
                # 4-byte offset, a misaligned r, an odd nz and the 7pt
                # Chebyshev step keep stencil_kernel (precond.cu's on_ring)
                t_f32 = time.perf_counter()
                xm, rm = misaligned(xp), misaligned(r)
                g_odd = torch.Generator(device="cuda").manual_seed(35)
                xo, ro = (torch.randn((9, 13, 71), generator=g_odd, dtype=dt, device="cuda")
                          for _ in range(2))
                xo = pad1(xo)
                s7 = STENCILS["7pt"]
                names = ring_kernels_launched([
                    (lambda: ops.jacobi_sweep(xp, r, st, omega=1.0), "JacobiTail<float>",
                     "pair_padded"),
                    (lambda: ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c),
                     "ChebTail<float>", "pair_padded")], old=[
                    (lambda: ops.jacobi_sweep(xm, r, st, omega=1.0), "JacobiTail<float>"),
                    (lambda: ops.jacobi_sweep(xp, rm, st, omega=1.0), "JacobiTail<float>"),
                    (lambda: ops.jacobi_sweep(xo, ro, st, omega=1.0), "JacobiTail<float>"),
                    (lambda: ops.cheb_step(xm, r, d, st, a=cheb_a, c=cheb_c),
                     "ChebTail<float>"),
                    (lambda: ops.cheb_step(xp, r, d, s7, a=cheb_a, c=cheb_c),
                     "ChebTail<float>")])
                for g, w in ((ops.jacobi_sweep(xm, r, st, omega=1.0), zs),
                             (ops.jacobi_sweep(xp, rm, st, omega=1.0), zs),
                             *zip(ops.cheb_step(xm, r, d, st, a=cheb_a, c=cheb_c), (zn, dn))):
                    check(torch.equal(g, w), "f32 sweeps: the pair stage differs from the "
                          "old pass on the same operands")
                ring_names = dict(zip(("block_jacobi_sweep", "cheb_fused_step"), names))
                del xm, rm, xo, ro
                print(f"[kernels] the f32 pair stage's launches and bits took "
                      f"{time.perf_counter() - t_f32:.2f}s")

            if dt == torch.float64 and sname == "7pt":
                # f64's two sweeps on the ring's element stage on both stencils,
                # from z padded and unpadded (one window each: the two forms
                # launch one instance); the yardstick launch on stencil_kernel
                t_f64 = time.perf_counter()
                f64_names = f64_sweeps_launched(x, xp, r, d)
                for key, (name27, name7) in f64_names.items():
                    rows[(key, "27pt", str(dt))]["kernel_name"] = name27
                    ring_names[key] = name7
                print(f"[kernels] the f64 sweeps' launches took "
                      f"{time.perf_counter() - t_f64:.2f}s")

            v1, q1, y1, parts = ops.bicgstab_spmv_dots(xp, *bv, al, st)
            _, _, _, parts2 = ops.bicgstab_spmv_dots(xp, *bv, al, st)
            v1r, q1r, y1r, partsr = ref.bicgstab_spmv_dots_ref(xp, *bv, al, stencil=st)
            torch.cuda.synchronize()
            bitwise((v1, q1, y1), (v1r, q1r, y1r), "bicgstab_fused_spmv_dots")
            rh = bv[4]
            bicg_pairs = ((q1r, y1r), (y1r, y1r), (q1r, q1r), (rh, q1r), (rh, y1r),
                          (rh, bv[5]), (rh, v1r), (rh, bv[0]), (rh, bv[3]))
            for got, again, want, what, pair in zip(parts, parts2, partsr, BICG_PARTS,
                                                    bicg_pairs):
                close_part(got, want, f"bicgstab_fused_spmv_dots {what}", *pair)
                check(torch.equal(got, again),
                      f"bicgstab_fused_spmv_dots {what}: partial not reproducible")
            rows[("bicgstab_fused_spmv_dots", sname, str(dt))] = dict(
                max_abs_err=max_err([(v1, v1r), (q1, q1r), (y1, y1r),
                                     *zip(parts, partsr)]),
                ms=timer.ms(lambda: ops.bicgstab_spmv_dots(xp, *bv, al, st)),
                plain_ms=timer.ms(lambda: ref.bicgstab_spmv_dots_ref(
                    xp, *bv, al, stencil=st)),
                library_ms=None,
                bytes=(npad + 9 * n) * es + es + 9 * ps, ops=ops_k1 + 22 * n,
                peak_ops=peak_ops, **bicg)
            out = ops.bicgstab_spmv_update(xp, *bv, om, be, st)
            outr = ref.bicgstab_spmv_update_ref(xp, *bv, om, be, stencil=st)
            torch.cuda.synchronize()
            bitwise(out, outr, "bicgstab_fused_spmv_update")
            rows[("bicgstab_fused_spmv_update", sname, str(dt))] = dict(
                max_abs_err=max_err(zip(out, outr)),
                ms=timer.ms(lambda: ops.bicgstab_spmv_update(xp, *bv, om, be, st)),
                plain_ms=timer.ms(lambda: ref.bicgstab_spmv_update_ref(
                    xp, *bv, om, be, stencil=st)),
                library_ms=None,
                bytes=(npad + 10 * n) * es + 2 * es, ops=ops_k1 + 12 * n,
                peak_ops=peak_ops, **upd)

            # kernel 15: one red-black Gauss-Seidel half-sweep from the padded
            # old iterate (b = r), both colours (f64 27pt and bf16 on the
            # plane-ring pass, f64 7pt and f32 on the old pass: rb_gs.cu's
            # static rule); the f64 and bf16 outputs bitwise equal to the
            # plain version's, every output repeated bitwise.  Timed on colour 0
            sw = [ops.gs_half_sweep(xp, r, st, c) for c in (0, 1)]
            swr = [ref.rb_gs_half_sweep_ref(xp, r, stencil=st, colour=c) for c in (0, 1)]
            torch.cuda.synchronize()
            bitwise(sw, swr, "rb_gs_half_sweep")
            check(all(torch.equal(o, ops.gs_half_sweep(xp, r, st, c))
                      for c, o in enumerate(sw)),
                  f"rb_gs_half_sweep {sname} {dt}: output not repeated")
            rows[("rb_gs_half_sweep", sname, str(dt))] = dict(
                max_abs_err=max_err(zip(sw, swr)),
                ms=timer.ms(lambda: ops.gs_half_sweep(xp, r, st, 0)),
                plain_ms=timer.ms(lambda: ref.rb_gs_half_sweep_ref(
                    xp, r, stencil=st, colour=0)),
                library_ms=None, bytes=(npad + 2 * n) * es, ops=2 * st.npoint * n,
                peak_ops=peak_ops, **gs)
            for key, name in ring_names.items():
                rows[(key, sname, str(dt))]["kernel_name"] = name

        # the zero-halo pad every stencil kernel's operand goes through
        rows[("pad_exchange", "-", str(dt))] = dict(
            max_abs_err=0.0, ms=timer.ms(lambda: pad1(x)), plain_ms=None,
            library_ms=None, bytes=(npad + n) * es, ops=0, peak_ops=peak_ops)

        # kernel 3: the four vector updates (no stencil)
        vecs = [torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
                for _ in range(5)]
        a = torch.tensor(0.37, dtype=dt, device="cuda")
        b = torch.tensor(-0.21, dtype=dt, device="cuda")
        out = ops.cg_body(a, b, *vecs)
        outr = ref.fused_cg_body_ref(a, b, *vecs)
        torch.cuda.synchronize()
        for o, orf in zip(out, outr):
            check(torch.allclose(o, orf, rtol=out_tol, atol=out_tol),
                  f"fused_cg_body {dt}: max err {max_err([(o, orf)])}")
        n = vecs[0].numel()
        rows[("fused_cg_body", "-", str(dt))] = dict(
            max_abs_err=max_err(zip(out, outr)),
            ms=timer.ms(lambda: ops.cg_body(a, b, *vecs)),
            plain_ms=timer.ms(lambda: ref.fused_cg_body_ref(a, b, *vecs)),
            library_ms=None, bytes=9 * n * es + 2 * es, ops=8 * n,
            peak_ops=peak_ops)

        # kernel 10: merged PCG's four vector updates (no stencil)
        vecs6 = vecs + [torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")]
        out = ops.pcg_body(a, b, *vecs6)
        outr = ref.fused_pcg_body_ref(a, b, *vecs6)
        torch.cuda.synchronize()
        for o, orf in zip(out, outr):
            check(torch.allclose(o, orf, rtol=out_tol, atol=out_tol),
                  f"fused_pcg_body {dt}: max err {max_err([(o, orf)])}")
        rows[("fused_pcg_body", "-", str(dt))] = dict(
            max_abs_err=max_err(zip(out, outr)),
            ms=timer.ms(lambda: ops.pcg_body(a, b, *vecs6)),
            plain_ms=timer.ms(lambda: ref.fused_pcg_body_ref(a, b, *vecs6)),
            library_ms=None, bytes=10 * n * es + 2 * es, ops=8 * n,
            peak_ops=peak_ops)

        # kernels 9 and 11: the pipelined CGs' six and eight recurrences;
        # each operation rounds on its own, so f64 outputs must be bitwise
        # equal to the plain version's
        vecs10 = vecs6 + [torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
                          for _ in range(4)]
        for name, fn, plain, nvec, nout, nops in (
                ("fused_pipe_body", ops.pipe_body, ref.fused_pipe_body_ref, 7, 6, 12),
                ("fused_ppipe_body", ops.ppipe_body, ref.fused_ppipe_body_ref, 10, 8,
                 16)):
            vs = vecs10[:nvec]
            out = fn(a, b, *vs)
            outr = plain(a, b, *vs)
            torch.cuda.synchronize()
            for o, orf in zip(out, outr):
                check(torch.allclose(o, orf, rtol=out_tol, atol=out_tol),
                      f"{name} {dt}: max err {max_err([(o, orf)])}")
                check(dt != torch.float64 or torch.equal(o, orf),
                      f"{name} {dt}: not bitwise equal to the plain version")
            rows[(name, "-", str(dt))] = dict(
                max_abs_err=max_err(zip(out, outr)),
                ms=timer.ms(lambda: fn(a, b, *vs)),
                plain_ms=timer.ms(lambda: plain(a, b, *vs)),
                library_ms=None, bytes=(nvec + nout) * n * es + 2 * es,
                ops=nops * n, peak_ops=peak_ops)

        # kernel 12: single-reduction BiCGStab's ω-half (α = a, ω = b here)
        vs = vecs10[:6]
        out = ops.bicgstab_update1(a, b, *vs)
        outr = ref.bicgstab_update1_ref(a, b, *vs)
        torch.cuda.synchronize()
        for o, orf in zip(out, outr):
            check(torch.allclose(o, orf, rtol=out_tol, atol=out_tol),
                  f"bicgstab_fused_update1 {dt}: max err {max_err([(o, orf)])}")
            check(dt != torch.float64 or torch.equal(o, orf),
                  f"bicgstab_fused_update1 {dt}: not bitwise equal to the plain version")
        rows[("bicgstab_fused_update1", "-", str(dt))] = dict(
            max_abs_err=max_err(zip(out, outr)),
            ms=timer.ms(lambda: ops.bicgstab_update1(a, b, *vs)),
            plain_ms=timer.ms(lambda: ref.bicgstab_update1_ref(a, b, *vs)),
            library_ms=None, bytes=9 * n * es + 2 * es, ops=10 * n, peak_ops=peak_ops)

        # kernel 8: pipelined PCG's reduction triple (r·u, w·u, r·r)
        ru, uu, wu = vecs[:3]
        dots = ops.fused_dots(ru, uu, wu)
        dots2 = ops.fused_dots(ru, uu, wu)
        dotsr = ref.fused_dots_ref(ru, uu, wu)
        torch.cuda.synchronize()
        for got, want, what, pair in zip(dots, dotsr, ("a·b", "c·b", "a·a"),
                                         ((ru, uu), (wu, uu), (ru, ru))):
            check(part_ok(got, want, *pair),
                  f"fused_dots {what} {dt}: {float(got)} vs {float(want)}")
        check(all(torch.equal(d, e) for d, e in zip(dots, dots2)),
              "fused_dots: partials not reproducible")
        rows[("fused_dots", "-", str(dt))] = dict(
            max_abs_err=max_err(zip(dots, dotsr)),
            ms=timer.ms(lambda: ops.fused_dots(ru, uu, wu)),
            plain_ms=timer.ms(lambda: ref.fused_dots_ref(ru, uu, wu)),
            library_ms=None,
            three_dots_ms=timer.ms(lambda: (torch.dot(ru.view(-1), uu.view(-1)),
                                            torch.dot(wu.view(-1), uu.view(-1)),
                                            torch.dot(ru.view(-1), ru.view(-1)))),
            bytes=3 * n * es + 3 * ps, ops=6 * n, peak_ops=peak_ops)

        # kernels 6, 7 and 5: the kernel API's flat passes, a·x + b·y + c·z
        # alone and with Σ out·w, and CG-NB's lines 6–8 (β = b); at the rank
        # block and on two ragged lengths, f64 vector outputs bitwise equal to
        # the plain versions and the partials bitwise reproducible
        c = torch.tensor(2.0, dtype=dt, device="cuda")
        for ragged in (5000, n + 1):
            api_check([torch.randn(ragged, generator=gen, dtype=dt, device="cuda")
                       for _ in range(4)], a, b, c, f"n={ragged}")
        x4, y4, z4, w4 = vecs[:4]
        errs = api_check(vecs[:4], a, b, c, "rank block")
        for name, fn, plain, nvec, nout, nops in (
                ("fused_axpby", lambda: ops.axpbypcz(a, x4, b, y4, c, z4),
                 lambda: ref.fused_axpby_ref(a, x4, b, y4, c, z4), 3, 1, 5),
                ("fused_axpby_dot", lambda: ops.axpbypcz_dot(a, x4, b, y4, c, z4, w4),
                 lambda: ref.fused_axpby_dot_ref(a, x4, b, y4, c, z4, w4), 4, 1, 7),
                ("cg_fused_update", lambda: ops.cg_update(b, x4, y4, z4, w4),
                 lambda: ref.cg_fused_update_ref(b, x4, y4, z4, w4), 4, 2, 6)):
            rows[(name, "-", str(dt))] = dict(
                max_abs_err=errs[name], ms=timer.ms(fn), plain_ms=timer.ms(plain),
                library_ms=None, bytes=(nvec + nout) * n * es + 4 * es, ops=nops * n,
                peak_ops=peak_ops)
        print(f"[kernels] the {dt} rows took {time.perf_counter() - t_dt:.2f}s")
    for row in rows.values():
        set_bounds(row, bw)
    for (name, sname, dt), row in rows.items():
        def fmt(v):
            return "-" if v is None else f"{v:.4f}"
        extra = (f" three_torch_dot_ms={row['three_dots_ms']:.4f}"
                 if "three_dots_ms" in row else "")
        if "padded_ms" in row:
            extra += (f" padded_ms={row['padded_ms']:.4f} "
                      f"padded_bound_ms={row['padded_bound_ms']:.4f}")
        if "old_pad_ms" in row:
            extra += f" old_pad_ms={row['old_pad_ms']:.4f}"
        print(f"[kernels] {name:26s} {sname:4s} {dt:13s} ms={row['ms']:.4f} "
              f"plain_ms={fmt(row['plain_ms'])} library_ms={fmt(row['library_ms'])} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"max_abs_err={row['max_abs_err']:.3e}{extra}")
    return rows


def phase_socket_kernels(timer: Timer, peaks) -> dict:
    """Phase 1 at the socket block (128×128×3072, 27pt, f64: 403 MB a vector,
    8× L2): the plane-ring pass's kernels (``stencil_spmv``,
    ``stencil_spmv_dots`` and ``stencil_spmv_dots3``) in both operand forms
    and ``rb_gs_half_sweep`` (padded, both colours), their f64 outputs
    bitwise equal to the plain version's and repeated bitwise, their
    partials reproducible, beside the zero-halo pad and a flat pass
    (``fused_cg_body``); and bf16's ``stencil_spmv`` (both forms),
    ``block_jacobi_sweep``, ``cheb_fused_step``, both BiCGStab passes and
    ``rb_gs_half_sweep`` (both colours) on x and r rounded to bf16 (and
    seeded bf16 streams), on the ring's pair stage, outputs bitwise the plain
    version's and repeated, partials repeated and within 1e-5·Σ|a_i·b_i|;
    f64's ``block_jacobi_sweep`` and ``cheb_fused_step`` on the ring from z
    unpadded and padded, and f32's on its pair stage, bitwise the plain
    version and the old pass, which is timed beside them (f64 behind its
    pad, ``old_pad_ms``; f32 on a misaligned copy, ``old_ms``).  Times and
    bounds as in phase 1; with the rank block's, they separate a fixed cost
    per launch from a rate.  The old pass of the other rows is timed beside
    the ring by ``chip_stencil_variants.py``."""
    bw, peak_ops, es = peaks[0], peaks[1] / 2, 8
    st = STENCILS["27pt"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, r = (torch.randn(SOCKET_BLOCK, generator=gen, dtype=torch.float64, device="cuda")
            for _ in range(2))
    xp = pad1(x)
    n, npad = x.numel(), xp.numel()
    ops_k1 = n * (2 * st.npoint - 1)
    y3, *parts = ops.spmv_dots3(x, r, st, zero_halo=True)
    _, *again = ops.spmv_dots3(x, r, st, zero_halo=True)
    y3p = ops.spmv_dots3(xp, r, st)[0]
    yr = ref.stencil_spmv_ref(xp, stencil=st)
    torch.cuda.synchronize()
    for got, what in ((ops.spmv(x, st, zero_halo=True), "stencil_spmv"),
                      (ops.spmv(xp, st), "stencil_spmv (padded)"),
                      (y3, "stencil_spmv_dots3"), (y3p, "stencil_spmv_dots3 (padded)")):
        check(torch.equal(got, yr), f"{what} at the socket block: not bitwise equal to "
              f"the plain version")
    check(all(torch.equal(a, b) for a, b in zip(parts, again)),
          "stencil_spmv_dots3 at the socket block: partials not reproducible")
    del y3, y3p, parts, again
    y2, *parts = ops.spmv_dots(x, st, zero_halo=True)
    _, *again = ops.spmv_dots(x, st, zero_halo=True)
    y2p, *parts_p = ops.spmv_dots(xp, st)
    torch.cuda.synchronize()
    for got, what in ((y2, "stencil_spmv_dots"), (y2p, "stencil_spmv_dots (padded)")):
        check(torch.equal(got, yr), f"{what} at the socket block: not bitwise equal to "
              f"the plain version")
    check(all(torch.equal(a, b) for a, b in zip(parts, again)),
          "stencil_spmv_dots at the socket block: partials not reproducible")
    _, *parts_r = ref.stencil_spmv_dots_ref(xp, stencil=st)
    for got, got_p, want, what in zip(parts, parts_p, parts_r, ("delta", "gamma")):
        for g in (got, got_p):
            check(abs(float(g) - float(want)) <= 1e-11 * abs(float(want)),
                  f"stencil_spmv_dots {what} at the socket block: {float(g)} vs "
                  f"{float(want)}")
    del y2, y2p, yr, parts, again, parts_p, parts_r
    for colour in (0, 1):
        got = ops.gs_half_sweep(xp, r, st, colour)
        same = torch.equal(got, ops.gs_half_sweep(xp, r, st, colour))
        check(torch.equal(got, ref.rb_gs_half_sweep_ref(xp, r, stencil=st, colour=colour)),
              f"rb_gs_half_sweep colour {colour} at the socket block: not bitwise equal to "
              f"the plain version")
        check(same, f"rb_gs_half_sweep colour {colour} at the socket block: not repeated")
        del got
    # f64 rows 16 and 17 on the ring (d seeded): from z unpadded and padded,
    # bitwise the plain version, repeated, and bitwise the old pass behind
    # its pad (the yardstick launch, old_pass), which is timed beside them
    t_new = time.perf_counter()
    d64 = torch.randn(SOCKET_BLOCK, generator=gen, dtype=torch.float64, device="cuda")
    cheb_a, cheb_c = Chebyshev().setup(LocalOp(st))[1][0]
    f64_routes = dict(block_jacobi_sweep=ring_route("block_jacobi_sweep", torch.float64, xp,
                                                    (r,)),
                      cheb_fused_step=ring_route("cheb_fused_step", torch.float64, xp,
                                                 (r, d64)))
    want = ref.block_jacobi_sweep_ref(xp, r, stencil=st, omega=1.0)
    for got in (ops.jacobi_sweep(x, r, st, omega=1.0, zero_halo=True),
                ops.jacobi_sweep(xp, r, st, omega=1.0),
                ops.jacobi_sweep(x, r, st, omega=1.0, zero_halo=True),
                precond_kernels.block_jacobi_sweep(x, r, stencil=st, zero_halo=True,
                                                   old_pass=True)):
        check(torch.equal(got, want), "block_jacobi_sweep f64 at the socket block: a form "
              "not bitwise equal to the plain version, or not repeated")
    del got, want
    want = ref.cheb_fused_step_ref(xp, r, d64, stencil=st, a=cheb_a, c=cheb_c)
    for got in (ops.cheb_step(x, r, d64, st, a=cheb_a, c=cheb_c, zero_halo=True),
                ops.cheb_step(xp, r, d64, st, a=cheb_a, c=cheb_c),
                ops.cheb_step(x, r, d64, st, a=cheb_a, c=cheb_c, zero_halo=True),
                precond_kernels.cheb_fused_step(x, r, d64, stencil=st, a=cheb_a, c=cheb_c,
                                                zero_halo=True, old_pass=True)):
        check(all(torch.equal(g, w) for g, w in zip(got, want)), "cheb_fused_step f64 at "
              "the socket block: a form not bitwise equal to the plain version, or not "
              "repeated")
    del got, want
    f64_rows = {
        "block_jacobi_sweep": dict(
            ms=timer.ms(lambda: ops.jacobi_sweep(x, r, st, omega=1.0, zero_halo=True)),
            padded_ms=timer.ms(lambda: ops.jacobi_sweep(xp, r, st, omega=1.0)),
            old_pad_ms=timer.ms(lambda: precond_kernels.block_jacobi_sweep(
                x, r, stencil=st, zero_halo=True, old_pass=True)),
            bytes=3 * n * es, padded_bytes=(npad + 2 * n) * es, ops=ops_k1 + 4 * n,
            **f64_routes["block_jacobi_sweep"]),
        "cheb_fused_step": dict(
            ms=timer.ms(lambda: ops.cheb_step(x, r, d64, st, a=cheb_a, c=cheb_c,
                                              zero_halo=True)),
            padded_ms=timer.ms(lambda: ops.cheb_step(xp, r, d64, st, a=cheb_a, c=cheb_c)),
            old_pad_ms=timer.ms(lambda: precond_kernels.cheb_fused_step(
                x, r, d64, stencil=st, a=cheb_a, c=cheb_c, zero_halo=True, old_pass=True)),
            bytes=5 * n * es, padded_bytes=(npad + 4 * n) * es, ops=ops_k1 + 5 * n,
            **f64_routes["cheb_fused_step"])}
    del d64
    print(f"[socket-kernels] f64 rows 16 and 17 (checks and times) took "
          f"{time.perf_counter() - t_new:.2f}s")
    # bf16 rows 1 and 17 (x and r rounded to bf16)
    bf = torch.bfloat16
    xb, rb = x.to(bf), r.to(bf)
    xbp = pad1(xb)
    stages, jacobi = ring_stages(xb, xbp), ring_route("block_jacobi_sweep", bf, xbp, (rb,))
    ybr = ref.stencil_spmv_ref(xbp, stencil=st)
    for got, what in ((ops.spmv(xb, st, zero_halo=True), "stencil_spmv bf16"),
                      (ops.spmv(xbp, st), "stencil_spmv bf16 (padded)"),
                      (ops.spmv(xb, st, zero_halo=True), "stencil_spmv bf16 (repeated)")):
        check(torch.equal(got, ybr), f"{what} at the socket block: not bitwise equal to the "
              f"plain version")
    del ybr
    zs = ops.jacobi_sweep(xbp, rb, st, omega=1.0)
    check(torch.equal(zs, ref.block_jacobi_sweep_ref(xbp, rb, stencil=st, omega=1.0)),
          "block_jacobi_sweep bf16 at the socket block: not bitwise equal to the plain version")
    check(torch.equal(zs, ops.jacobi_sweep(xbp, rb, st, omega=1.0)),
          "block_jacobi_sweep bf16 at the socket block: not repeated")
    del zs
    # bf16 rows 16 and 13 (z̃ = x rounded, the other streams seeded bf16)
    db = torch.randn(SOCKET_BLOCK, generator=gen, device="cuda").to(bf)
    cheb_a, cheb_c = Chebyshev().setup(LocalOp(st))[1][0]
    cheb = ring_route("cheb_fused_step", bf, xbp, (rb, db))
    got = ops.cheb_step(xbp, rb, db, st, a=cheb_a, c=cheb_c)
    for g, w, g2 in zip(got, ref.cheb_fused_step_ref(xbp, rb, db, stencil=st, a=cheb_a,
                                                     c=cheb_c),
                        ops.cheb_step(xbp, rb, db, st, a=cheb_a, c=cheb_c)):
        check(torch.equal(g, w) and torch.equal(g, g2), "cheb_fused_step bf16 at the socket "
              "block: not bitwise equal to the plain version, or not repeated")
    del got, g, w, g2
    bvb = [torch.randn(SOCKET_BLOCK, generator=gen, device="cuda").to(bf) for _ in range(6)]
    alb = torch.tensor(0.37, dtype=bf, device="cuda")
    bicg = ring_route("bicgstab_fused_spmv_dots", bf, xbp, bvb)
    v1, q1, y1, parts = ops.bicgstab_spmv_dots(xbp, *bvb, alb, st)
    *_, again = ops.bicgstab_spmv_dots(xbp, *bvb, alb, st)
    v1r, q1r, y1r, partsr = ref.bicgstab_spmv_dots_ref(xbp, *bvb, alb, stencil=st)
    check(torch.equal(v1, v1r) and torch.equal(q1, q1r) and torch.equal(y1, y1r),
          "bicgstab_fused_spmv_dots bf16 at the socket block: not bitwise equal to the plain "
          "version")
    rh = bvb[4]
    pairs = ((q1r, y1r), (y1r, y1r), (q1r, q1r), (rh, q1r), (rh, y1r), (rh, bvb[5]),
             (rh, v1r), (rh, bvb[0]), (rh, bvb[3]))
    for got, rep, want, pair, what in zip(parts, again, partsr, pairs, BICG_PARTS):
        check(torch.equal(got, rep) and part_ok(got, want, *pair),
              f"bicgstab_fused_spmv_dots bf16 {what} at the socket block: {float(got)} vs "
              f"{float(want)}, or not repeated")
    del v1, q1, y1, parts, again, v1r, q1r, y1r, partsr, pairs, rh
    # bf16 rows 14 and 15 (w̃ = x rounded, the streams seeded bf16; b = r
    # rounded), both colours of the half-sweep; their checks and times are
    # timed on the host clock
    t_new = time.perf_counter()
    omb, beb = (torch.tensor(c, dtype=bf, device="cuda") for c in (1.3, -0.41))
    upd = ring_route("bicgstab_fused_spmv_update", bf, xbp, bvb)
    got = ops.bicgstab_spmv_update(xbp, *bvb, omb, beb, st)
    for g, w, g2 in zip(got, ref.bicgstab_spmv_update_ref(xbp, *bvb, omb, beb, stencil=st),
                        ops.bicgstab_spmv_update(xbp, *bvb, omb, beb, st)):
        check(torch.equal(g, w) and torch.equal(g, g2), "bicgstab_fused_spmv_update bf16 at "
              "the socket block: not bitwise equal to the plain version, or not repeated")
    del got, g, w, g2
    gs = ring_route("rb_gs_half_sweep", bf, xbp, (rb,))
    for colour in (0, 1):
        got = ops.gs_half_sweep(xbp, rb, st, colour)
        check(torch.equal(got, ref.rb_gs_half_sweep_ref(xbp, rb, stencil=st, colour=colour))
              and torch.equal(got, ops.gs_half_sweep(xbp, rb, st, colour)),
              f"rb_gs_half_sweep bf16 colour {colour} at the socket block: not bitwise equal "
              f"to the plain version, or not repeated")
        del got
    upd_ms = timer.ms(lambda: ops.bicgstab_spmv_update(xbp, *bvb, omb, beb, st))
    gs_ms = timer.ms(lambda: ops.gs_half_sweep(xbp, rb, st, 0))
    print(f"[socket-kernels] bf16 rows 14 and 15 (checks and times) took "
          f"{time.perf_counter() - t_new:.2f}s")
    # f32 rows 16 and 17 on the ring's pair stage (x and r rounded to f32, d
    # seeded): bitwise the plain version's, repeated, and bitwise the old
    # pass on a copy of z at a 4-byte offset (stencil_kernel), which is
    # timed beside them (old_ms)
    t_new = time.perf_counter()
    f32 = torch.float32
    rf, xfp = r.float(), pad1(x.float())
    df = torch.randn(SOCKET_BLOCK, generator=gen, device="cuda")
    xfm = misaligned(xfp)
    jacobi32 = ring_route("block_jacobi_sweep", f32, xfp, (rf,))
    cheb32 = ring_route("cheb_fused_step", f32, xfp, (rf, df))
    got = ops.jacobi_sweep(xfp, rf, st, omega=1.0)
    check(torch.equal(got, ref.block_jacobi_sweep_ref(xfp, rf, stencil=st, omega=1.0))
          and torch.equal(got, ops.jacobi_sweep(xfp, rf, st, omega=1.0))
          and torch.equal(got, ops.jacobi_sweep(xfm, rf, st, omega=1.0)),
          "block_jacobi_sweep f32 at the socket block: not bitwise equal to the plain "
          "version and the old pass, or not repeated")
    del got
    got = ops.cheb_step(xfp, rf, df, st, a=cheb_a, c=cheb_c)
    for g, w, g2, o in zip(got, ref.cheb_fused_step_ref(xfp, rf, df, stencil=st, a=cheb_a,
                                                        c=cheb_c),
                           ops.cheb_step(xfp, rf, df, st, a=cheb_a, c=cheb_c),
                           ops.cheb_step(xfm, rf, df, st, a=cheb_a, c=cheb_c)):
        check(torch.equal(g, w) and torch.equal(g, g2) and torch.equal(g, o),
              "cheb_fused_step f32 at the socket block: not bitwise equal to the plain "
              "version and the old pass, or not repeated")
    del got, g, w, g2, o
    f32_rows = {
        "block_jacobi_sweep_f32": dict(
            ms=timer.ms(lambda: ops.jacobi_sweep(xfp, rf, st, omega=1.0)),
            old_ms=timer.ms(lambda: ops.jacobi_sweep(xfm, rf, st, omega=1.0)),
            bytes=(npad + 2 * n) * 4, ops=ops_k1 + 4 * n, peak_ops=op_rate(peaks, f32),
            **jacobi32),
        "cheb_fused_step_f32": dict(
            ms=timer.ms(lambda: ops.cheb_step(xfp, rf, df, st, a=cheb_a, c=cheb_c)),
            old_ms=timer.ms(lambda: ops.cheb_step(xfm, rf, df, st, a=cheb_a, c=cheb_c)),
            bytes=(npad + 4 * n) * 4, ops=ops_k1 + 5 * n, peak_ops=op_rate(peaks, f32),
            **cheb32)}
    del rf, xfp, df, xfm
    print(f"[socket-kernels] f32 rows 16 and 17 (checks and times) took "
          f"{time.perf_counter() - t_new:.2f}s")
    bf_ops = op_rate(peaks, bf)
    vecs = [torch.randn(SOCKET_BLOCK, generator=gen, dtype=torch.float64, device="cuda")
            for _ in range(3)] + [x, r]
    a, b = (torch.tensor(c, dtype=torch.float64, device="cuda") for c in (0.37, -0.21))
    rows = {
        "stencil_spmv": dict(
            ms=timer.ms(lambda: ops.spmv(x, st, zero_halo=True)),
            padded_ms=timer.ms(lambda: ops.spmv(xp, st)),
            bytes=2 * n * es, padded_bytes=(npad + n) * es, ops=ops_k1),
        "stencil_spmv_dots3": dict(
            ms=timer.ms(lambda: ops.spmv_dots3(x, r, st, zero_halo=True)),
            padded_ms=timer.ms(lambda: ops.spmv_dots3(xp, r, st)),
            bytes=3 * n * es + 3 * es, padded_bytes=(npad + 2 * n) * es + 3 * es,
            ops=ops_k1 + 6 * n),
        "stencil_spmv_dots": dict(
            ms=timer.ms(lambda: ops.spmv_dots(x, st, zero_halo=True)),
            padded_ms=timer.ms(lambda: ops.spmv_dots(xp, st)),
            bytes=2 * n * es + 2 * es, padded_bytes=(npad + n) * es + 2 * es,
            ops=ops_k1 + 4 * n),
        "rb_gs_half_sweep": dict(
            ms=timer.ms(lambda: ops.gs_half_sweep(xp, r, st, 0)),
            bytes=(npad + 2 * n) * es, ops=2 * st.npoint * n),
        **f64_rows,
        "pad_exchange": dict(ms=timer.ms(lambda: pad1(x)), bytes=(npad + n) * es, ops=0),
        "fused_cg_body": dict(ms=timer.ms(lambda: ops.cg_body(a, b, *vecs)),
                              bytes=9 * n * es + 2 * es, ops=8 * n),
        "stencil_spmv_bf16": dict(
            ms=timer.ms(lambda: ops.spmv(xb, st, zero_halo=True)),
            padded_ms=timer.ms(lambda: ops.spmv(xbp, st)),
            bytes=2 * n * 2, padded_bytes=(npad + n) * 2, ops=ops_k1, peak_ops=bf_ops,
            **stages),
        "block_jacobi_sweep_bf16": dict(
            ms=timer.ms(lambda: ops.jacobi_sweep(xbp, rb, st, omega=1.0)),
            bytes=(npad + 2 * n) * 2, ops=ops_k1 + 4 * n, peak_ops=bf_ops, **jacobi),
        "cheb_fused_step_bf16": dict(
            ms=timer.ms(lambda: ops.cheb_step(xbp, rb, db, st, a=cheb_a, c=cheb_c)),
            bytes=(npad + 4 * n) * 2, ops=ops_k1 + 5 * n, peak_ops=bf_ops, **cheb),
        "bicgstab_fused_spmv_dots_bf16": dict(
            ms=timer.ms(lambda: ops.bicgstab_spmv_dots(xbp, *bvb, alb, st)),
            bytes=(npad + 9 * n) * 2 + 2 + 9 * 4, ops=ops_k1 + 22 * n, peak_ops=bf_ops,
            **bicg),
        "bicgstab_fused_spmv_update_bf16": dict(
            ms=upd_ms, bytes=(npad + 10 * n) * 2 + 2 * 2, ops=ops_k1 + 12 * n,
            peak_ops=bf_ops, **upd),
        "rb_gs_half_sweep_bf16": dict(
            ms=gs_ms, bytes=(npad + 2 * n) * 2, ops=2 * st.npoint * n, peak_ops=bf_ops, **gs),
        **f32_rows,
    }
    for name, row in rows.items():
        row.setdefault("peak_ops", peak_ops)
        set_bounds(row, bw)
        padded = (f" padded_ms={row['padded_ms']:.4f} "
                  f"padded_bound_ms={row['padded_bound_ms']:.4f}" if "padded_ms" in row
                  else "")
        dt = ("bfloat16" if name.endswith("_bf16") else "float32" if name.endswith("_f32")
              else "float64")
        old = f" old_ms={row['old_ms']:.4f}" if "old_ms" in row else ""
        old += f" old_pad_ms={row['old_pad_ms']:.4f}" if "old_pad_ms" in row else ""
        print(f"[socket-kernels] {name:31s} 27pt {dt:8s} {SOCKET_BLOCK} ms={row['ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}){padded}{old}")
    return rows


#: where the autotune phase keeps its caches: the build tree (gitignored),
#: never the home directory.  Every phase reads ``DEFAULT_CACHE`` (absent:
#: the default table, runs of 16) but the ``autotune`` phase's own sessions
TUNE_DIR = ROOT / "build" / "autotune"
DEFAULT_CACHE = TUNE_DIR / "absent.json"
TUNED_CACHE = TUNE_DIR / "tuned.json"
#: the autotune phase's cells: (grid, stencil, dtype)
TUNE_CELLS = ((RANK_BLOCK, "27pt", torch.float64), (SOCKET_BLOCK, "27pt", torch.float64),
              (RANK_BLOCK, "7pt", torch.float64), (RANK_BLOCK, "27pt", torch.float32),
              (RANK_BLOCK, "27pt", torch.bfloat16))
#: the fused routes solved graphed under the tuned tiles at 128³ 27pt f64
TUNED_ROUTES = (("cg_merged", "none"), ("pcg_merged", "chebyshev"),
                ("cg_pipe", "none"), ("pcg_pipe", "chebyshev"))
#: the grids of the kernels-versus-plain crossover (graphed cg_merged, 27pt f64)
CROSSOVER_GRIDS = tuple((n, n, n) for n in (8, 16, 24, 32, 64))


def tune_candidates(timer: Timer, grid, sname: str, dt) -> dict:
    """Each run of rows 1, 2 and 4 (``stencil_spmv``, ``stencil_spmv_dots``,
    ``stencil_spmv_dots3``; row 1's ``fuse_dot`` form checked too) in both
    operand forms at one cell: y bitwise the plain version's in f64 and bf16
    (within the output tolerance in f32), the partials within the partial
    tolerance of the plain version's (:func:`part_ok`), bitwise repeated
    under one run and within that tolerance of the default run's.  Returns
    each candidate's CUDA-event ms (L2 flushed)."""
    st = STENCILS[sname]
    out_tol = tols(dt)[0]
    what = f"{sname} {str(dt).removeprefix('torch.')} {grid}"
    gen = torch.Generator(device="cuda").manual_seed(27)
    x, r = (torch.randn(grid, generator=gen, dtype=dt, device="cuda") for _ in range(2))
    xp = pad1(x)
    yr, d1r = ref.stencil_spmv_dot_ref(xp, stencil=st)
    want = {"stencil_spmv": (d1r,),
            "stencil_spmv_dots": tuple(ref.stencil_spmv_dots_ref(xp, stencil=st)[1:]),
            "stencil_spmv_dots3": tuple(ref.stencil_spmv_dots3_ref(xp, r, stencil=st)[1:])}
    # each partial's operands
    pairs = {"stencil_spmv": ((yr, x),), "stencil_spmv_dots": ((yr, x), (x, x)),
             "stencil_spmv_dots3": ((yr, x), (r, x), (r, r))}
    calls = {"stencil_spmv": lambda xin, **kw: ops.spmv_dot(xin, st, **kw),
             "stencil_spmv_dots": lambda xin, **kw: ops.spmv_dots(xin, st, **kw),
             "stencil_spmv_dots3": lambda xin, **kw: ops.spmv_dots3(xin, r, st, **kw)}
    times: dict = {}
    for form, xin in (("zero_halo", x), ("padded", xp)):
        default = {}
        for run in sorted(autotune.RUN_CANDIDATES, key=lambda v: v != autotune.DEFAULT_RUN):
            kw = dict(zero_halo=form == "zero_halo", run=run)
            y = ops.spmv(xin, st, **kw)
            check(torch.equal(y, yr) if dt == torch.float64 else
                  torch.allclose(y, yr, rtol=out_tol, atol=out_tol),
                  f"stencil_spmv run {run} {form} {what}: y differs from the plain version")
            for name, call in calls.items():
                yv, *parts = call(xin, **kw)
                _, *again = call(xin, **kw)
                check(torch.equal(yv, yr) if dt == torch.float64 else
                      torch.allclose(yv, yr, rtol=out_tol, atol=out_tol),
                      f"{name} run {run} {form} {what}: y differs from the plain version")
                for i, (g, g2, w) in enumerate(zip(parts, again, want[name])):
                    check(torch.equal(g, g2),
                          f"{name} run {run} {form} {what}: partial {i} not repeated")
                    for other in (w, default.get((name, i), w)):
                        check(part_ok(g, other, *pairs[name][i]),
                              f"{name} run {run} {form} {what}: partial {i} {float(g)} "
                              f"vs {float(other)}")
                    if run == autotune.DEFAULT_RUN:
                        default[(name, i)] = g
                del yv, parts, again
            times[f"stencil_spmv/{form}/{run}"] = timer.ms(lambda: ops.spmv(xin, st, **kw))
            times[f"stencil_spmv_dots/{form}/{run}"] = timer.ms(
                lambda: ops.spmv_dots(xin, st, **kw))
            times[f"stencil_spmv_dots3/{form}/{run}"] = timer.ms(
                lambda: ops.spmv_dots3(xin, r, st, **kw))
            del y
    del x, r, xp, yr, pairs
    return times


def phase_autotune(timer: Timer) -> dict:
    """The ``autotune`` phase (its own counted window): every launch
    geometry a launch may pick at each of ``TUNE_CELLS``
    (:func:`tune_candidates`), then ``autotune.tune`` of each cell into
    ``TUNED_CACHE``; a ``kernels=None`` session at 128³ resolves from it,
    and ``TUNED_ROUTES`` graphed under the tuned tiles stop on their
    ``kernels=False`` solve's iteration, each bitwise its eager solve; then
    the crossover walls that ``autotune.MIN_KERNEL_VOLUME`` is set from, and
    the peak memory of a graphed cg_merged at the socket block with
    ``donate`` on and off, their results bitwise equal."""
    t0 = time.perf_counter()
    cells = []
    TUNED_CACHE.unlink(missing_ok=True)
    for grid, sname, dt in TUNE_CELLS:
        t_cell = time.perf_counter()
        times = tune_candidates(timer, grid, sname, dt)
        dec = autotune.tune(grid, sname, dt, "cuda", path=TUNED_CACHE, repeats=25)
        entry = autotune.load_cache(TUNED_CACHE)[
            autotune.tune_key(sname, grid, dt, autotune.device_kind("cuda"))]
        cells.append(dict(grid=list(grid), stencil=sname, dtype=str(dt), times_ms=times,
                          pick=dict(run=dec.run, use_kernels=dec.use_kernels),
                          sweep=entry["timings"], s=time.perf_counter() - t_cell))
        runs = " ".join(f"{k}={v:.4f}" for k, v in times.items())
        print(f"[autotune] {sname} {str(dt).removeprefix('torch.')} {grid}: pick run="
              f"{dec.run} use_kernels={dec.use_kernels} (sweep ms: runs "
              f"{entry['timings']['run']}, kernel {entry['timings']['kernel_s'] * 1e3:.4f}"
              f" plain {entry['timings']['plain_s'] * 1e3:.4f}; the cell took "
              f"{cells[-1]['s']:.2f}s)")
        print(f"[autotune]   ms {runs}")
    routes = tuned_routes()
    crossover = crossover_walls()
    donate = donate_memory()
    phase_s = time.perf_counter() - t0
    print(f"[autotune] the phase took {phase_s:.2f}s")
    return dict(cells=cells, routes=routes, crossover=crossover, donate=donate,
                phase_s=phase_s)


def tuned_routes() -> list[dict]:
    """A ``kernels=None`` session at 128³ 27pt f64 resolves from the tuned
    cache; each of ``TUNED_ROUTES`` under its tiles, graphed, is bitwise its
    eager solve and stops on the iteration of its ``kernels=False`` solve."""
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(TUNED_CACHE)
    try:
        want = autotune.resolve("27pt", RANK_BLOCK, torch.float64, "cuda")
        check(want.source == "cache", "the tuned cache has no 128³ 27pt f64 entry")
        out = []
        for method, precond in TUNED_ROUTES:
            sess = SolverSession(method=method, grid=RANK_BLOCK, stencil="27pt",
                                 options=SolverOptions(kernels=None, precond=precond))
            check(sess.options.kernels is want.use_kernels and sess._tune == want,
                  f"{method}: kernels=None did not resolve from the tuned cache")
            eager = sess._solve_eager()
            graphed = sess.solve()
            plain = SolverSession(method=method, grid=RANK_BLOCK, stencil="27pt",
                                  options=SolverOptions(kernels=False, precond=precond)).solve()
            rec = dict(method=method, precond=precond, run=want.run,
                       iters=graphed.iters, plain_iters=plain.iters,
                       status=status_name(graphed.status))
            print(f"[autotune] {method}/{precond} kernels=None -> {sess.options.kernels} "
                  f"run={want.run}: iters {graphed.iters} (plain "
                  f"{plain.iters}) {rec['status']}")
            check(same_solve(graphed, eager),
                  f"{method}/{precond}: the graphed solve under the tuned tiles differs "
                  f"from its eager solve")
            check(graphed.iters == plain.iters and graphed.status == plain.status,
                  f"{method}/{precond}: {graphed.iters} iterations under the tuned tiles, "
                  f"{plain.iters} with kernels=False")
            out.append(rec)
            del sess, eager, graphed, plain
    finally:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(DEFAULT_CACHE)
    return out


def crossover_walls(rounds: int = 5) -> list[dict]:
    """Graphed cg_merged, 27pt f64, warm ms/iter (median of ``rounds``
    solves) with ``kernels=True`` and ``False`` at each of
    ``CROSSOVER_GRIDS``: where the kernels start to win."""
    out = []
    for grid in CROSSOVER_GRIDS:
        rec = dict(grid=list(grid))
        for kernels in (True, False):
            sess = SolverSession(method="cg_merged", grid=grid, stencil="27pt",
                                 options=SolverOptions(kernels=kernels))
            res = sess.solve()                               # builds it
            walls = [timed(sess.solve)[1] for _ in range(rounds)]
            rec["kernels" if kernels else "plain"] = dict(
                iters=res.iters, ms_per_iter=statistics.median(walls) / res.iters * 1e3)
        rec["ratio"] = rec["kernels"]["ms_per_iter"] / rec["plain"]["ms_per_iter"]
        print(f"[autotune] crossover {grid}: kernels {rec['kernels']['ms_per_iter']:.4f} "
              f"ms/iter ({rec['kernels']['iters']} iters), plain "
              f"{rec['plain']['ms_per_iter']:.4f} ({rec['plain']['iters']}): ratio "
              f"{rec['ratio']:.3f}")
        out.append(rec)
    wins = [r["grid"] for r in out if r["ratio"] < 1]
    first = next((i for i in range(len(out))
                  if all(r["ratio"] < 1 for r in out[i:])), None)
    print(f"[autotune] the kernels win at {wins}; from "
          f"{None if first is None else out[first]['grid']} on (MIN_KERNEL_VOLUME in "
          f"kernels/autotune.py: {autotune.MIN_KERNEL_VOLUME})")
    return out


def donate_memory() -> dict:
    """A warm graphed cg_merged solve (27pt f64, ``kernels=True``) at the
    socket block from a caller's ``x0``, with ``donate`` on and off: the peak
    of allocated memory above what was allocated before the solve
    (``max_memory_allocated``), the bytes allocated during it and those
    still held after it, the result kept; the results bitwise equal."""
    sessions = {d: SolverSession(method="cg_merged", grid=SOCKET_BLOCK, stencil="27pt",
                                 options=SolverOptions(kernels=True, donate=d))
                for d in (True, False)}
    for sess in sessions.values():
        sess.solve(x0=torch.zeros(SOCKET_BLOCK, dtype=torch.float64, device="cuda"))
    out, results = {}, {}
    for d, sess in sessions.items():
        x0 = torch.zeros(SOCKET_BLOCK, dtype=torch.float64, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        allocated = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
        res = sess.solve(x0=x0)
        torch.cuda.synchronize()
        out["on" if d else "off"] = dict(
            peak_bytes=torch.cuda.max_memory_allocated() - base,
            allocated_bytes=torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
            - allocated,
            held_bytes=torch.cuda.memory_allocated() - base, iters=res.iters)
        check((res.x is x0) == d, f"donate={d}: result.x is x0 is {res.x is x0}")
        results[d] = res
        del x0
    check(same_solve(results[True], results[False]),
          "donate: the donated solve differs from the undonated one")
    vector = math.prod(SOCKET_BLOCK) * 8
    out["vector_bytes"] = vector
    out["saved"] = {k: out["off"][k] - out["on"][k]
                    for k in ("peak_bytes", "allocated_bytes", "held_bytes")}
    print(f"[autotune] donate at {SOCKET_BLOCK}: peak {out['on']['peak_bytes']} (on) vs "
          f"{out['off']['peak_bytes']} (off) bytes; allocated {out['on']['allocated_bytes']}"
          f" vs {out['off']['allocated_bytes']}; held {out['on']['held_bytes']} vs "
          f"{out['off']['held_bytes']}; saved {out['saved']} (a vector is {vector})")
    del sessions, results
    return out


#: M⁻¹ applications per solve (pcg, pcg_merged and pcg_pipe: one at set-up
#: and one per iteration; pbicgstab: two per iteration; pbicgstab_merged: two
#: at set-up, two per iteration and one in finalize) and each preconditioner's kernel
#: launches and SpMVs per application at its defaults (chebyshev degree 4:
#: three steps; block_jacobi 3 sweeps: two kernel sweeps; jacobi 2 sweeps:
#: one matvec; ssor: no kernel and no SpMV)
PRECOND_APPLIES = {"pcg": lambda k: 1 + k, "pcg_merged": lambda k: 1 + k,
                   "pcg_pipe": lambda k: 1 + k, "pbicgstab": lambda k: 2 * k,
                   "pbicgstab_merged": lambda k: 2 * k + 3}
PRECOND_LAUNCHES = {"chebyshev": ("cheb_fused_step", 3),
                    "block_jacobi": ("block_jacobi_sweep", 2),
                    "jacobi": ("stencil_spmv", 1), "ssor": (None, 0)}


def expected_launches(method: str, iters: int, precond: str = "none") -> dict:
    """The launches a ``kernels=True`` solve must make, from its iteration
    count (the fused route for the merged and pipelined methods, whose set-up
    is the unfused init: two SpMVs, r = b − A·x0 and A·r or A·u, except
    cg_merged's, which gets A·r from its first ``stencil_spmv_dots``, and
    the merged BiCGStabs', which make three: r0 = b − A·x0, w = A·r0 and
    t = A·w, each operand through M first when preconditioned)."""
    out = dict.fromkeys(ops.LAUNCHES, 0)
    out["stencil_spmv"] = {
        "cg": 1 + iters, "cg_nb": 2 + iters, "bicgstab": 1 + 2 * iters,
        "bicgstab_b1": 1 + 2 * iters, "jacobi": 1 + iters,
        "gauss_seidel": 1 + iters, "gauss_seidel_rb": 1 + iters,
        "cg_merged": 1, "pcg": 1 + iters, "pbicgstab": 1 + 2 * iters,
        "pcg_merged": 2, "cg_pipe": 2, "pcg_pipe": 2 + iters,
        "bicgstab_merged": 3, "pbicgstab_merged": 3}[method]
    if method == "cg_merged":
        out["stencil_spmv_dots"] = iters + 1
        out["fused_cg_body"] = iters
    if method == "pcg_merged":
        out["stencil_spmv_dots3"] = iters
        out["fused_pcg_body"] = iters
    if method == "cg_pipe":           # n = A·w with its partials, then the body
        out["stencil_spmv_dots3"] = iters
        out["fused_pipe_body"] = iters
    if method == "pcg_pipe":          # the partials, M⁻¹w, n = A·m, the body
        out["fused_dots"] = iters
        out["fused_ppipe_body"] = iters
    if method in ("bicgstab_merged", "pbicgstab_merged"):   # the three passes
        for kernel in ("bicgstab_fused_spmv_dots", "bicgstab_fused_update1",
                       "bicgstab_fused_spmv_update"):
            out[kernel] = iters
    if precond != "none":
        kernel, per_apply = PRECOND_LAUNCHES[precond]
        if kernel is not None:
            out[kernel] += per_apply * PRECOND_APPLIES[method](iters)
    return out


def run_solve(method, stencil, grid, kernels, precond="none"):
    """One solve on the session's eager loop (one read per iteration, every
    wrapper call a launch): its session, result, wall time (s), kernel
    launches and zero-halo pads (``F.pad`` calls: every ``pad1`` and
    ``pad_exchange`` of the port).  The graphed solve replays its kernels
    without passing a wrapper, so launches are counted here and phase 2f
    holds the graphed solve to this one."""
    sess = SolverSession(method=method, grid=grid, stencil=stencil,
                         options=SolverOptions(kernels=kernels, precond=precond))
    ((res, wall), launches), pads = counted_pads(
        lambda: counted(lambda: timed(sess._solve_eager)))
    return sess, res, wall, launches, pads


def counted_pads(fn):
    """``(fn(), the F.pad calls it made)``: every ``pad1`` and
    ``pad_exchange`` of the port, and a sweep wrapper's pad of an unpadded
    z its rule keeps on ``stencil_kernel``."""
    pads = [0]
    real_pad = F.pad

    def counted_pad(*args, **kw):
        pads[0] += 1
        return real_pad(*args, **kw)

    torch.nn.functional.pad = counted_pad
    try:
        return fn(), pads[0]
    finally:
        torch.nn.functional.pad = real_pad


#: the kernels whose operand the caller pads: one ``F.pad`` a launch
PADDED_KERNELS = ("bicgstab_fused_spmv_dots", "bicgstab_fused_spmv_update",
                  "rb_gs_half_sweep")
#: the preconditioner sweeps a solve on one card hands z unpadded (the
#: operator's halo is the zero pad), each with its source's rule: the
#: wrapper pads z (one ``F.pad``) only for a launch the rule keeps on
#: ``stencil_kernel``
UNPADDED_SWEEPS = {"cheb_fused_step": precond_kernels.cheb_pass,
                   "block_jacobi_sweep": precond_kernels.jacobi_pass}


def sweep_pads(launches: dict, stencil: str, grid, dtype=torch.float64) -> int:
    """The ``F.pad`` calls the preconditioner sweeps of ``launches`` (their
    3-D or lane-batched forms) make on z unpadded in ``dtype`` on ``grid``
    (fresh, aligned tensors): one a launch whose rule says
    ``stencil_kernel``, none on the ring."""
    npoint = STENCILS[stencil].npoint
    return sum(launches.get(k, 0) + launches.get(k + "_batched", 0)
               for k, rule in UNPADDED_SWEEPS.items()
               if rule(dtype, grid[-1], 0, (), npoint, zero_halo=True) == "stencil")


def expected_pads(method: str, precond: str, launches: dict, stencil: str = "27pt",
                  grid=RANK_BLOCK) -> int | None:
    """The ``F.pad`` calls a ``kernels=True`` solve must make: one for
    ``b = A·1`` (the problem's right-hand side, on the plain path), one
    before each launch of a kernel of :data:`PADDED_KERNELS`, the sweeps'
    (:func:`sweep_pads`: none where they take the ring), and merged CG's
    initial residual (the wrapped operator's own padded SpMV).  The
    plane-ring pass's kernels (``stencil_spmv``, ``stencil_spmv_dots`` and
    ``stencil_spmv_dots3``, and the sweeps on the ring) take their operand
    unpadded and make the zero halo themselves: no pad, so merged CG makes
    exactly two, and an f64 pcg + chebyshev or + block_jacobi one.  None
    (not checked) for the Gauss-Seidels and SSOR, whose own sweeps pad with
    no kernel."""
    if method in ("gauss_seidel", "gauss_seidel_rb") or precond == "ssor":
        return None
    return (1 + (method == "cg_merged") + sum(launches[k] for k in PADDED_KERNELS)
            + sweep_pads(launches, stencil, grid))


#: phase 2a, the unpreconditioned path: (method, stencil, precond)
MAIN_CASES = ([("cg_merged", "27pt", "none"), ("cg_merged", "7pt", "none")]
              + [(m, "27pt", "none") for m in ("cg", "cg_nb", "bicgstab", "bicgstab_b1")]
              + [(m, "7pt", "none") for m in ("jacobi", "gauss_seidel", "gauss_seidel_rb")])
#: phase 2b, the preconditioned path
PRECOND_CASES = [("pcg", "27pt", "chebyshev"), ("pcg", "7pt", "chebyshev"),
                 ("pcg", "27pt", "block_jacobi"), ("pcg", "7pt", "block_jacobi"),
                 ("pcg_merged", "27pt", "chebyshev"),
                 ("pcg_merged", "27pt", "block_jacobi"),
                 ("pcg", "27pt", "jacobi"), ("pcg", "27pt", "ssor"),
                 ("pbicgstab", "27pt", "chebyshev")]
#: phase 2c, the pipelined path (the fused route)
PIPE_CASES = [("cg_pipe", "27pt", "none"), ("cg_pipe", "7pt", "none"),
              ("pcg_pipe", "27pt", "chebyshev"), ("pcg_pipe", "7pt", "chebyshev"),
              ("pcg_pipe", "27pt", "block_jacobi"), ("pcg_pipe", "27pt", "jacobi"),
              ("pcg_pipe", "27pt", "ssor")]
#: phase 2d, the single-reduction BiCGStab path (the fused route)
BICGSTAB_CASES = [("bicgstab_merged", "27pt", "none"), ("bicgstab_merged", "7pt", "none"),
                  ("pbicgstab_merged", "27pt", "chebyshev"),
                  ("pbicgstab_merged", "7pt", "chebyshev"),
                  ("pbicgstab_merged", "27pt", "block_jacobi"),
                  ("pbicgstab_merged", "27pt", "jacobi"),
                  ("pbicgstab_merged", "27pt", "ssor")]


#: methods whose stopping iteration depends on the summation order of their
#: dot products.  The single-reduction BiCGStabs' nine dots are summed in
#: per-block slots by the kernel and by ``torch.dot`` without it; at 128³ the
#: recurrence carries the last-bit differences far enough that the two
#: solves may stop a few iterations apart, as the port's two routes do on the
#: CPU with no kernel at all.  For them the iteration counts must agree
#: within the reference's budget for variants (``tests/test_reduction_hiding.py``:
#: 10 % + 1), and the solve's TRUE residual must meet the tolerance.
ORDER_SENSITIVE = ("bicgstab_merged", "pbicgstab_merged")


def iters_agree(method: str, iters: int, plain_iters: int) -> bool:
    if method not in ORDER_SENSITIVE:
        return iters == plain_iters
    return abs(iters - plain_iters) <= math.ceil(0.1 * plain_iters) + 1


def phase_path(tag: str, cases, solves: list) -> list[dict]:
    """Phase 2: one path through the kernels, each solve checked against the
    same solve with ``kernels=False`` (:func:`iters_agree`) and against its
    exact launch counts; each ``kernels=True`` session and result is
    appended to ``solves`` for phase 2f."""
    out = []
    for method, stencil, precond in cases:
        what = f"{method}/{stencil}/{precond}"
        sess, res, wall, launches, pads = run_solve(method, stencil, RANK_BLOCK, True,
                                                    precond)
        _, plain, plain_wall, plain_launches, _ = run_solve(method, stencil,
                                                            RANK_BLOCK, False, precond)
        want_pads = expected_pads(method, precond, launches, stencil)
        err = float((res.x - sess.problem.x_true()).abs().max())
        dx = float((res.x - plain.x).abs().max())
        prob = sess.problem
        true_res = float(torch.linalg.vector_norm(prob.b() - prob.stencil.matvec(res.x)))
        want = expected_launches(method, res.iters, precond)
        rec = dict(method=method, stencil=stencil, precond=precond,
                   iters=res.iters, plain_iters=plain.iters, status=res.status,
                   plain_status=plain.status, err=err, x_vs_plain=dx,
                   true_res=true_res, wall_s=wall, plain_wall_s=plain_wall,
                   launches={k: v for k, v in launches.items() if v}, pads=pads)
        print(f"[{tag}] {method:15s} {stencil:4s} {precond:12s} iters={res.iters} "
              f"(plain {plain.iters}) status={res.status} max|x-1|={err:.3e} "
              f"max|x-x_plain|={dx:.3e} |b-Ax|={true_res:.3e} wall={wall:.4f}s "
              f"(plain {plain_wall:.4f}s) launches={rec['launches']} pads={pads}")
        check(res.status == 0 and plain.status == 0,
              f"{what}: status {res.status} (plain {plain.status})")
        check(iters_agree(method, res.iters, plain.iters),
              f"{what}: {res.iters} iterations on the kernels, {plain.iters} without")
        check(method not in ORDER_SENSITIVE or true_res < 10 * sess.options.tol,
              f"{what}: true residual {true_res}")
        check(err < 1e-6, f"{what}: max|x-1| = {err}")
        check(launches == want, f"{what}: launches {launches}, expected {want}")
        check(want_pads is None or pads == want_pads,
              f"{what}: {pads} pads, expected {want_pads}")
        check(not any(plain_launches.values()),
              f"{what}: kernels=False launched {plain_launches}")
        out.append(rec)
        solves.append((tag, sess, res, wall))
    return out


#: phase 2e: iterations each solver takes on the plain path before the
#: kernel API is driven on its state
API_ITERS = 3


def kernel_api_states() -> dict:
    """Phase 2e's inputs, made on the plain path (no kernel launched): per
    stencil, a gauss_seidel_rb iterate and a cg_nb state after
    :data:`API_ITERS` iterations at 128³ f64 (b = A·1, x0 = 0), each with the
    port's own next step."""
    out = {}
    for sname in ("27pt", "7pt"):
        prob = make_problem(RANK_BLOCK, sname, torch.float64, "cuda")
        port = Ops(LocalOp(prob.stencil), prob.b(), norm_ref=1.0)
        st = {}
        for method in ("gauss_seidel_rb", "cg_nb"):
            mdef = get_method(method)
            state = mdef.init(port, prob.x0())
            for _ in range(API_ITERS):
                state = mdef.step(port, state)
            st[method] = (state, mdef.step(port, state))
        x, r, p, ap, an, ad = st["cg_nb"][0]
        r_new = st["cg_nb"][1][1]
        st["cg_nb_operands"] = dict(alpha=an / ad, beta=st["cg_nb"][1][4] / an,
                                    ar=port.matvec(r_new))
        st["b"] = port.b
        out[sname] = st
    torch.cuda.synchronize()
    return out


def drive_kernel_api(states: dict) -> dict:
    """Phase 2e's counted work, through ``repro_torch.kernels.ops`` alone:
    per stencil one symmetric red-black sweep (red, black, black, red) of
    four ``gs_half_sweep`` calls on the gauss_seidel_rb iterate, and CG-NB's
    Alg. 1 line 4 (``axpbypcz``: r' = 1·r − α·Ap + 0·p), line 5's r'·r'
    (``axpbypcz_dot``) and lines 6–8 (``cg_update``) on the cg_nb state."""
    out = {}
    for sname, st in states.items():
        x = st["gauss_seidel_rb"][0][0]
        for colour in (0, 1, 1, 0):
            x = ops.gs_half_sweep(pad1(x), st["b"], STENCILS[sname], colour)
        (_, r, p, ap, an, _), step = st["cg_nb"]
        opnd = st["cg_nb_operands"]
        r_new = ops.axpbypcz(1.0, r, -opnd["alpha"], ap, 0.0, p)
        r_dot, an_new = ops.axpbypcz_dot(1.0, r, -opnd["alpha"], ap, 0.0, p, step[1])
        p_new, ap_new, ad_new = ops.cg_update(opnd["beta"], step[1], opnd["ar"], p, ap)
        out[sname] = dict(sweep=x, r_new=r_new, r_dot=r_dot, an_new=an_new,
                          p_new=p_new, ap_new=ap_new, ad_new=ad_new)
    torch.cuda.synchronize()
    return out


def check_kernel_api(states: dict, outs: dict, launches: dict) -> dict:
    """Phase 2e's checks: the sweep and the CG-NB vectors bitwise equal to
    the port's own steps and to the plain versions, r'·r' and Ap'·p' within
    rtol 1e-11 of the step's ``torch.dot`` (another summation order), and
    the window's launches exactly the sixteen sweeps and the two of each
    flat pass."""
    rec = {}
    for sname, o in outs.items():
        st = states[sname]
        (_, r, p, ap, _, _), step = st["cg_nb"]
        alpha = st["cg_nb_operands"]["alpha"]
        plain_r = ref.fused_axpby_ref(1.0, r, -alpha, ap, 0.0, p)
        equal = {"sweep": torch.equal(o["sweep"], st["gauss_seidel_rb"][1][0]),
                 "r_new": torch.equal(o["r_new"], step[1]) and torch.equal(o["r_new"], plain_r),
                 "r_dot": torch.equal(o["r_dot"], step[1]),
                 "p_new": torch.equal(o["p_new"], step[2]),
                 "ap_new": torch.equal(o["ap_new"], step[3])}
        rel = {"an_new": abs(float(o["an_new"]) / float(step[4]) - 1),
               "ad_new": abs(float(o["ad_new"]) / float(step[5]) - 1)}
        print(f"[kernel_api] {sname}: bitwise equal to the port's steps {equal}; "
              f"partials' rel. err. vs torch.dot {rel}")
        for what, ok in equal.items():
            check(ok, f"kernel_api {sname}: {what} differs from the port's own step")
        for what, err in rel.items():
            check(err <= 1e-11, f"kernel_api {sname}: {what} rel. err. {err}")
        rec[sname] = dict(bitwise=equal, partial_rel_err=rel)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(rb_gs_half_sweep=4 * len(outs), fused_axpby=len(outs),
                fused_axpby_dot=len(outs), cg_fused_update=len(outs))
    check(launches == want, f"kernel_api: launches {launches}, expected {want}")
    rec["launches"] = {k: v for k, v in launches.items() if v}
    return rec


# -- the kernel API in bf16: every solver kernel's bf16 form ------------------------

#: the kernel_api_bf16 window's scalars (Python floats; the wrappers and the
#: plain versions round them to bf16 alike)
BF16_SCALARS = dict(alpha=0.37, beta=-0.21, omega=1.3, c2=2.0)


def kernel_api_bf16_inputs() -> dict:
    """The kernel_api_bf16 window's inputs, made before it: seeded bf16
    operands at 128³ (27pt), ten vectors for the flat bodies, and B =
    :data:`BATCH` lanes of them for the lane-batched forms; Chebyshev's
    (a, c) of the default schedule's first step."""
    gen = torch.Generator(device="cuda").manual_seed(31)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    st = STENCILS["27pt"]
    x, r, d = (rnd(RANK_BLOCK) for _ in range(3))
    lanes = [rnd((BATCH, *RANK_BLOCK)) for _ in range(3)]
    cheb_a, cheb_c = Chebyshev().setup(LocalOp(st))[1][0]
    torch.cuda.synchronize()
    return dict(st=st, x=x, xp=pad1(x), r=r, d=d, T=[rnd(RANK_BLOCK) for _ in range(10)],
                lx=lanes[0], lxp=pad1(lanes[0]), lr=lanes[1], ld=lanes[2],
                cheb=(cheb_a, cheb_c))


def bf16_api_calls(inp: dict) -> dict:
    """name -> (the wrapper's call, its plain version's call, each partial's
    operands from the plain outputs): the 18 solver wrappers (``spmv`` and
    ``spmv_dot`` share the kernel ``stencil_spmv``; both colours of the
    half-sweep in one call each) and the three 4-D forms."""
    st, x, xp, r, d, T = (inp[k] for k in ("st", "x", "xp", "r", "d", "T"))
    lx, lxp, lr, ld = (inp[k] for k in ("lx", "lxp", "lr", "ld"))
    ca, cc = inp["cheb"]
    s = BF16_SCALARS
    al, be, om, c2 = s["alpha"], s["beta"], s["omega"], s["c2"]

    def bicg_pairs(out):
        v, q, y, _ = out
        rh = T[4]
        return [(q, y), (y, y), (q, q), (rh, q), (rh, y), (rh, T[5]), (rh, v), (rh, T[0]),
                (rh, T[3])]

    def none(out):
        return []

    return {
        "spmv": (lambda: ops.spmv(x, st, zero_halo=True),
                 lambda: ref.stencil_spmv_ref(xp, stencil=st), none),
        "spmv_dot": (lambda: ops.spmv_dot(x, st, zero_halo=True),
                     lambda: ref.stencil_spmv_dot_ref(xp, stencil=st),
                     lambda out: [(out[0], x)]),
        "spmv_dots": (lambda: ops.spmv_dots(x, st, zero_halo=True),
                      lambda: ref.stencil_spmv_dots_ref(xp, stencil=st),
                      lambda out: [(out[0], x), (x, x)]),
        "spmv_dots3": (lambda: ops.spmv_dots3(x, r, st, zero_halo=True),
                       lambda: ref.stencil_spmv_dots3_ref(xp, r, stencil=st),
                       lambda out: [(out[0], x), (r, x), (r, r)]),
        "cg_body": (lambda: ops.cg_body(al, be, *T[:5]),
                    lambda: ref.fused_cg_body_ref(al, be, *T[:5]), none),
        "pcg_body": (lambda: ops.pcg_body(al, be, *T[:6]),
                     lambda: ref.fused_pcg_body_ref(al, be, *T[:6]), none),
        "pipe_body": (lambda: ops.pipe_body(al, be, *T[:7]),
                      lambda: ref.fused_pipe_body_ref(al, be, *T[:7]), none),
        "ppipe_body": (lambda: ops.ppipe_body(al, be, *T[:10]),
                       lambda: ref.fused_ppipe_body_ref(al, be, *T[:10]), none),
        "fused_dots": (lambda: ops.fused_dots(*T[:3]), lambda: ref.fused_dots_ref(*T[:3]),
                       lambda out: [(T[0], T[1]), (T[2], T[1]), (T[0], T[0])]),
        "bicgstab_update1": (lambda: ops.bicgstab_update1(al, om, *T[:6]),
                             lambda: ref.bicgstab_update1_ref(al, om, *T[:6]), none),
        "bicgstab_spmv_dots": (lambda: ops.bicgstab_spmv_dots(xp, *T[:6], al, st),
                               lambda: ref.bicgstab_spmv_dots_ref(xp, *T[:6], al, stencil=st),
                               bicg_pairs),
        "bicgstab_spmv_update": (
            lambda: ops.bicgstab_spmv_update(xp, *T[:6], om, be, st),
            lambda: ref.bicgstab_spmv_update_ref(xp, *T[:6], om, be, stencil=st), none),
        "cheb_step": (lambda: ops.cheb_step(xp, r, d, st, a=ca, c=cc),
                      lambda: ref.cheb_fused_step_ref(xp, r, d, stencil=st, a=ca, c=cc), none),
        "jacobi_sweep": (lambda: ops.jacobi_sweep(xp, r, st, omega=1.0),
                         lambda: ref.block_jacobi_sweep_ref(xp, r, stencil=st, omega=1.0),
                         none),
        "axpbypcz": (lambda: ops.axpbypcz(al, T[0], be, T[1], c2, T[2]),
                     lambda: ref.fused_axpby_ref(al, T[0], be, T[1], c2, T[2]), none),
        "axpbypcz_dot": (lambda: ops.axpbypcz_dot(al, T[0], be, T[1], c2, T[2], T[3]),
                         lambda: ref.fused_axpby_dot_ref(al, T[0], be, T[1], c2, T[2], T[3]),
                         lambda out: [(out[0], T[3])]),
        "cg_update": (lambda: ops.cg_update(be, *T[:4]),
                      lambda: ref.cg_fused_update_ref(be, *T[:4]),
                      lambda out: [(out[1], out[0])]),
        "gs_half_sweep": (lambda: ops.gs_half_sweep(xp, r, st, 0),
                          lambda: ref.rb_gs_half_sweep_ref(xp, r, stencil=st, colour=0), none),
        "spmv_batched": (lambda: ops.spmv(lx, st, zero_halo=True),
                         lambda: ref.stencil_spmv_ref(lxp, stencil=st), none),
        "cheb_step_batched": (lambda: ops.cheb_step(lxp, lr, ld, st, a=ca, c=cc),
                              lambda: ref.cheb_fused_step_ref(lxp, lr, ld, stencil=st, a=ca,
                                                              c=cc), none),
        "jacobi_sweep_batched": (lambda: ops.jacobi_sweep(lxp, lr, st, omega=1.0),
                                 lambda: ref.block_jacobi_sweep_ref(lxp, lr, stencil=st,
                                                                    omega=1.0), none),
    }


def drive_kernel_api_bf16(inp: dict) -> dict:
    """The kernel_api_bf16 window's counted work: each call of
    :func:`bf16_api_calls` once, on the card, through
    ``repro_torch.kernels.ops`` alone."""
    outs = {name: call() for name, (call, _, _) in bf16_api_calls(inp).items()}
    torch.cuda.synchronize()
    return outs


def _outputs(out) -> list:
    """A wrapper's outputs as one flat list (BiCGStab's partials unpacked)."""
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        flat += list(o) if isinstance(o, tuple) else [o]
    return flat


def check_kernel_api_bf16(inp: dict, outs: dict, launches: dict) -> dict:
    """The kernel_api_bf16 window's checks: each output bf16 and bitwise its
    plain version's on the same card tensors, each partial float32 within
    1e-5·Σ|a_i·b_i| of the plain version's and bitwise repeated by a second
    call, and the window's launches exactly one of each kernel (two of
    ``stencil_spmv``: ``spmv`` and ``spmv_dot``) and of each lane-batched
    form."""
    rec = {}
    for name, (call, plain, pairs) in bf16_api_calls(inp).items():
        want = plain()
        got, wv, again = _outputs(outs[name]), _outputs(want), _outputs(call())
        torch.cuda.synchronize()
        check(len(got) == len(wv), f"kernel_api_bf16 {name}: {len(got)} outputs")
        ab = iter(pairs(want))
        parts = []
        for g, w, g2 in zip(got, wv, again):
            if g.dim() == 0:
                a, b = next(ab)
                check(g.dtype == torch.float32 and part_ok(g, w, a, b),
                      f"kernel_api_bf16 {name}: partial {float(g)} vs {float(w)} ({g.dtype})")
                check(torch.equal(g, g2), f"kernel_api_bf16 {name}: partial not repeated")
                parts.append(abs(float(g) - float(w)))
            else:
                check(g.dtype == torch.bfloat16 and torch.equal(g, w),
                      f"kernel_api_bf16 {name}: not bitwise equal to the plain version "
                      f"(max err {max_err([(g, w)])})")
        rec[name] = dict(outputs=len(got), partial_abs_err=parts)
    want = dict.fromkeys(ops.LAUNCHES, 1)
    want.update(stencil_spmv=2, flash_attention=0)
    check(launches == want, f"kernel_api_bf16: launches {launches}, expected {want}")
    print(f"[kernel_api_bf16] {len(rec)} calls, every output bitwise its plain version, "
          f"launches {launches}")
    rec["launches"] = {k: v for k, v in launches.items() if v}
    return rec


def kept_pairs(S: int, window: int) -> int:
    """The (query, key) pairs one head keeps: ``j <= i`` and, with a window,
    ``j > i - window``; each costs the kernel 4·hd operations."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_inputs() -> dict:
    """Phase 4's inputs, made on the card from a seeded generator: per case
    of :data:`ATTENTION` one f32 draw of q, k, v (B, S, H, hd), and the same
    draw rounded to bf16."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, cfg in ATTENTION.items():
        shape = (cfg["B"], cfg["S"], cfg["H"], cfg["hd"])
        qkv = [torch.randn(shape, generator=gen, device="cuda") for _ in range(3)]
        for dt in ops.ATTENTION_DTYPES:
            out[(name, dt)] = [t.to(dt) for t in qkv]
    return out


def drive_attention(inputs: dict) -> dict:
    """Phase 4's counted work: ``ops.flash_attention`` once per case."""
    outs = {key: ops.flash_attention(*qkv, window=ATTENTION[key[0]]["window"])
            for key, qkv in inputs.items()}
    torch.cuda.synchronize()
    return outs


def drive_attention_mma(inputs: dict) -> dict:
    """The ``attention_mma`` window's work: the ``mma.sync`` body,
    ``flash_attention_bf16_mma``, once per bf16 case."""
    outs = {(name, dt): fa.flash_attention_bf16_mma(*qkv, window=ATTENTION[name]["window"])
            for (name, dt), qkv in inputs.items() if dt == torch.bfloat16}
    torch.cuda.synchronize()
    return outs


def drive_attention_ffma(inputs: dict) -> dict:
    """The ``attention_ffma`` window's work: the FFMA body,
    ``flash_attention_f32_ffma``, once per f32 case."""
    outs = {(name, dt): fa.flash_attention_f32_ffma(*qkv, window=ATTENTION[name]["window"])
            for (name, dt), qkv in inputs.items() if dt == torch.float32}
    torch.cuda.synchronize()
    return outs


def attention_split(timer: Timer) -> dict:
    """The ``wgmma`` body's time (:class:`Timer`) at internlm2-1.8b's B, S
    and H, causal, at both its widths, on seeded bf16 inputs.  The two runs
    do the same softmax work while the products differ by 2×, so if the
    body runs its products and the rest one after the other, the products
    take 2·(t128 − t64) at hd 128 and the rest 2·t64 − t128: a two-point
    model, not a trace."""
    cfg = ATTENTION["internlm2-1.8b"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    ms = {}
    for hd in fa.WGMMA_HEAD_DIMS:
        shape = (cfg["B"], cfg["S"], cfg["H"], hd)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        ms[hd] = timer.ms(lambda: ops.flash_attention(q, k, v, window=cfg["window"]))
    t64, t128 = ms[64], ms[128]
    split = dict(B=cfg["B"], S=cfg["S"], H=cfg["H"], window=cfg["window"], ms_hd64=t64,
                 ms_hd128=t128, products_ms_hd128=2 * (t128 - t64), rest_ms=2 * t64 - t128)
    print(f"[attention] wgmma body at internlm2-1.8b's B, S, H: hd 64 {t64:.4f} ms, "
          f"hd 128 {t128:.4f} ms; two-point model at hd 128: products "
          f"{split['products_ms_hd128']:.4f} ms, the rest {split['rest_ms']:.4f} ms")
    return split


def window_mask(S: int, window: int) -> torch.Tensor:
    """The boolean (S, S) mask ``scaled_dot_product_attention`` takes for a
    causal sliding window (True: attend)."""
    i = torch.arange(S, device="cuda")[:, None]
    j = torch.arange(S, device="cuda")[None, :]
    return (j <= i) & (j > i - window)


def bf16_close(out, q, k, v, window: int, what: str) -> dict:
    """``ref.attention_bf16_error`` of a bf16 output against the plain
    version in f32 on the same inputs, beside the plain bf16 version; fails
    unless ``ratio <= 1`` and ``frob <= 2·plain_frob``."""
    plain = ref.flash_attention_ref(q, k, v, window=window)
    o32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), window=window)
    err = ref.attention_bf16_error(out, o32, plain)
    check(err["ratio"] <= 1 and err["frob"] <= 2 * err["plain_frob"],
          f"{what}: against the f32 plain version {err}")
    return err


def check_attention(inputs: dict, outs: dict, mma_outs: dict, ffma_outs: dict,
                    launches: dict, bodies: dict, timer: Timer, peaks) -> dict:
    """Phase 4's checks and times, outside the counted windows: each output
    finite, bitwise equal to a second launch and within its tolerance of the
    plain version; the ``attention`` window's launches exactly one per case,
    f32 on the 3xTF32 body and bf16 on the ``wgmma`` body; the
    ``attention_mma`` window's exactly one ``mma.sync`` launch per bf16 case
    and the ``attention_ffma`` window's exactly one FFMA launch per f32 case,
    and nothing else.  Times (:class:`Timer`) of the kernel (and of the
    yardstick body: ``mma_ms`` for bf16, ``ffma_ms`` for f32), the plain
    version and ``F.scaled_dot_product_attention`` on the same inputs in its
    (B, H, S, hd) view (causal, or with the window as a boolean mask), beside
    the bound: 4·hd operations per kept pair over the bf16 tensor-core rate,
    or in f32 three times as many over the TF32 rate (3xTF32, the least the
    card needs for f32-accurate products; the f32 rate without tensor cores
    gives ``ffma_bound_ms``), against q, k, v read and o written once."""
    n_bf16 = sum(dt == torch.bfloat16 for _, dt in outs)
    n_f32 = len(outs) - n_bf16
    none = dict.fromkeys(ops.LAUNCHES, 0)
    for path in ("attention_mma", "attention_ffma"):
        check(launches[path] == none, f"{path}: launches {launches[path]}, expected none")
    want = dict(none, flash_attention=len(outs))
    check(launches["attention"] == want,
          f"attention: launches {launches['attention']}, expected {want}")
    no_body = dict.fromkeys(fa.BODIES, 0)
    for path, want_bodies, n_outs, n_want in (
            ("attention", dict(no_body, tf32x3=n_f32, wgmma=n_bf16), len(outs), len(outs)),
            ("attention_mma", dict(no_body, mma=n_bf16), len(mma_outs), n_bf16),
            ("attention_ffma", dict(no_body, ffma=n_f32), len(ffma_outs), n_f32)):
        check(bodies[path] == want_bodies and n_outs == n_want,
              f"{path}: bodies {bodies[path]}, expected {want_bodies}")
    rows = {}
    for (name, dt), out in outs.items():
        cfg = ATTENTION[name]
        q, k, v = inputs[(name, dt)]
        window = cfg["window"]
        what = f"flash_attention {name} {dt}"
        check(out.shape == q.shape and out.dtype == dt and bool(torch.isfinite(out).all()),
              f"{what}: bad output")
        again = ops.flash_attention(q, k, v, window=window)
        plain = ref.flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{what}: not bitwise equal run to run")
        mma = ffma = None
        if dt == torch.float32:
            check(fa.source_body(dt, cfg["hd"]) == "tf32x3",
                  f"{what}: the source routes hd {cfg['hd']} off the 3xTF32 body")
            err = max_err([(out, plain)])
            bf16 = None
            check(torch.allclose(out, plain, rtol=1e-4, atol=1e-5),
                  f"{what}: max err {err} against the plain version")
            ffma_out = ffma_outs[(name, dt)]
            ffma_again = fa.flash_attention_f32_ffma(q, k, v, window=window)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(ffma_out).all()) and torch.equal(ffma_out, ffma_again),
                  f"{what}: the FFMA body's output not finite or not bitwise repeated")
            ffma = dict(max_abs_err=max_err([(ffma_out, plain)]))
            check(torch.allclose(ffma_out, plain, rtol=1e-4, atol=1e-5),
                  f"{what}: FFMA body max err {ffma['max_abs_err']} against the plain version")
            ffma["ms"] = timer.ms(lambda: fa.flash_attention_f32_ffma(q, k, v, window=window))
            del ffma_again
        else:
            check(fa.source_body(dt, cfg["hd"]) == "wgmma",
                  f"{what}: the source routes hd {cfg['hd']} off the wgmma body")
            bf16 = bf16_close(out, q, k, v, window, what)
            err = bf16["max_abs_err"]
            mma_out = mma_outs[(name, dt)]
            mma_again = fa.flash_attention_bf16_mma(q, k, v, window=window)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(mma_out).all()) and torch.equal(mma_out, mma_again),
                  f"{what}: the mma body's output not finite or not bitwise repeated")
            mma = bf16_close(mma_out, q, k, v, window, f"{what} (mma body)")
            mma["ms"] = timer.ms(lambda: fa.flash_attention_bf16_mma(q, k, v, window=window))
            del mma_again
        del again, plain
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            mask = window_mask(cfg["S"], window)

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        else:
            def library():
                return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        lib_out = library()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lib_out).all()), f"{what}: library call not finite")
        lib_err = max_err([(lib_out.transpose(1, 2), out)])
        del lib_out
        B, S, H, hd = q.shape
        n_ops = 4 * B * H * hd * kept_pairs(S, window)
        n_bytes = 4 * q.numel() * q.element_size()
        t_ops = (3 * n_ops / peaks[4] if dt == torch.float32 else n_ops / peaks[3]) * 1e3
        t_bytes = n_bytes / peaks[0] * 1e3
        ffma_bound = max(n_ops / peaks[2] * 1e3, t_bytes) if ffma else None
        rows[(name, str(dt))] = row = dict(
            **cfg, body=fa.route(dt, hd), max_abs_err=err, bf16_error=bf16,
            library_max_abs_diff=lib_err,
            ms=timer.ms(lambda: ops.flash_attention(q, k, v, window=window)),
            mma_ms=mma["ms"] if mma else None, mma_bf16_error=mma,
            ffma_ms=ffma["ms"] if ffma else None,
            ffma_max_abs_err=ffma["max_abs_err"] if ffma else None,
            ffma_bound_ms=ffma_bound,
            plain_ms=timer.ms(lambda: ref.flash_attention_ref(q, k, v, window=window)),
            library_ms=timer.ms(library),
            flops=n_ops, bytes=n_bytes, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"[attention] {name:15s} {str(dt):14s} B={B} S={S} H={H} hd={hd} "
              f"window={window}: {row['body']} ms={row['ms']:.4f} "
              + (f"mma_ms={row['mma_ms']:.4f} (max_abs_err={mma['max_abs_err']:.3e}, "
                 f"{mma['ratio']:.3f} of its limit) " if mma else "")
              + (f"ffma_ms={row['ffma_ms']:.4f} (max_abs_err={ffma['max_abs_err']:.3e}) "
                 if ffma else "")
              + f"plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} (scaled_dot_product_attention) "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, "
              f"{n_ops / 1e9:.2f} GFLOP"
              + (f" x 3 at the TF32 rate; ffma_bound_ms={ffma_bound:.4f}" if ffma else "")
              + f") max_abs_err={err:.3e}"
              + (f" (of its limit: {bf16['ratio']:.3f} at worst; ‖o - o32‖="
                 f"{bf16['frob']:.4e}, plain bf16's {bf16['plain_frob']:.4e})"
                 if bf16 else "")
              + f" |library - kernel|={lib_err:.3e}")
    return rows


def counted(fn):
    """``fn()`` and the kernel launches it made."""
    before = dict(ops.LAUNCHES)
    out = fn()
    return out, {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}


def bits_equal(a, b) -> bool:
    """Same dtype, shape and bit patterns (NaN included); two Nones are
    equal."""
    if a is None or b is None:
        return a is None and b is None
    view = {8: torch.int64, 4: torch.int32}
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(view[a.element_size()]),
                            b.contiguous().view(view[b.element_size()])))


def same_solve(got, want) -> bool:
    """Iterations and status equal; iterate, residual norm and NaN-padded
    history bitwise equal."""
    return ((got.iters, got.status) == (want.iters, want.status)
            and all(bits_equal(a, b) for a, b in ((got.x, want.x),
                                                 (got.res_norm, want.res_norm),
                                                 (got.history, want.history))))


def timed(fn):
    """``fn()`` and its wall time (s), the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kernel_session(method, precond, grid, max_block=None) -> SolverSession:
    """A ``kernels=True`` 27pt f64 session (``max_block``: its largest block)."""
    sess = SolverSession(method=method, grid=grid, stencil="27pt",
                         options=SolverOptions(kernels=True, precond=precond))
    if max_block is not None:
        sess._max_block = max_block
    return sess


def exe_stats(sess, res) -> dict:
    """The executable's build seconds and cache counters, and the blocks the
    last solve ran (``rolled_back``: steps run and dropped)."""
    exe = sess._executables[sess.problem.shape]
    (st,) = sess.cache_stats().values()
    return dict(compile_s=st["compile_s"], hits=st["hits"], misses=st["misses"],
                ladder=list(exe.ladder), blocks=list(exe.blocks),
                reads=len(exe.blocks), rolled_back=sum(exe.blocks) - res.iters)


def phase_graphed(solves) -> list[dict]:
    """Phase 2f: each ``kernels=True`` solve of phases 2a–d again through
    ``SolverSession.solve`` on its own session (the executable cache: CUDA
    graphs replayed in blocks, one read per block), twice: a miss that
    builds the executable, then a hit.  Both bitwise equal to the eager
    solve of the counted window (:func:`same_solve`)."""
    out = []
    for path, sess, eager, eager_wall in solves:
        what = f"{sess.method}/{sess.problem.stencil.name}/{sess.options.precond}"
        first, first_s = timed(sess.solve)
        again, wall = timed(sess.solve)
        rec = dict(path=path, method=sess.method, stencil=sess.problem.stencil.name,
                   precond=sess.options.precond, iters=again.iters,
                   eager_iters=eager.iters, status=again.status,
                   first_wall_s=first_s, wall_s=wall, eager_wall_s=eager_wall,
                   **exe_stats(sess, again))
        print(f"[graphed] {what:36s} iters={again.iters} (eager {eager.iters}) "
              f"status={again.status} build {rec['compile_s']:.3f}s first {first_s:.4f}s "
              f"wall {wall:.4f}s (eager {eager_wall:.4f}s) blocks={rec['blocks']}")
        check(same_solve(first, eager) and same_solve(again, eager),
              f"{what}: the graphed solve differs from the eager one")
        check(rec["misses"] == 1 and rec["hits"] == 1,
              f"{what}: cache {rec['misses']} misses, {rec['hits']} hits")
        sess._executables.clear()
        out.append(rec)
    return out


#: the f32 preconditioned path (``precond_f32``, its own counted window): pcg
#: with chebyshev (three ``cheb_fused_step`` an apply) and with block_jacobi
#: (two ``block_jacobi_sweep``) at 128³ 27pt in f32, both sweeps on the
#: ring's f32 pair stage
F32_CASES = (("pcg", "chebyshev"), ("pcg", "block_jacobi"))


def f32_session(method: str, precond: str, kernels: bool) -> SolverSession:
    """A 27pt f32 session at the rank block."""
    return SolverSession(method=method, grid=RANK_BLOCK, stencil="27pt",
                         options=SolverOptions(kernels=kernels, precond=precond, f64=False))


def drive_f32_precond() -> dict:
    """The ``precond_f32`` window's counted work: each case of
    :data:`F32_CASES` once on its session's eager loop (one read an
    iteration, every wrapper call a launch): (session, result, wall s,
    launches) a case."""
    out = {}
    for method, precond in F32_CASES:
        sess = f32_session(method, precond, True)
        (res, wall), launches = counted(lambda: timed(sess._solve_eager))
        out[(method, precond)] = (sess, res, wall, launches)
    return out


def check_f32_precond(eager: dict, window: dict) -> list[dict]:
    """Outside the ``precond_f32`` window: each f32 solve converged, on the
    iteration and with the status of the same solve with ``kernels=False``,
    with exactly :func:`expected_launches`' launches (the window's are
    theirs); its graphed solve (a miss, then a hit) bitwise the eager one;
    the warm graphed ms/iter on the kernels and on the plain path (median of
    three solves each)."""
    out, total = [], dict.fromkeys(ops.LAUNCHES, 0)
    for (method, precond), (sess, res, wall, launches) in eager.items():
        what = f"{method}/27pt/{precond} f32"
        plain_sess = f32_session(method, precond, False)
        plain = plain_sess._solve_eager()
        check(res.x.dtype == torch.float32, f"{what}: iterate {res.x.dtype}")
        check(res.status == 0 and plain.status == 0,
              f"{what}: status {res.status} (plain {plain.status})")
        check(res.iters == plain.iters,
              f"{what}: {res.iters} iterations on the kernels, {plain.iters} without")
        want = expected_launches(method, res.iters, precond)
        check(launches == want, f"{what}: launches {launches}, expected {want}")
        for k, v in launches.items():
            total[k] += v
        first, again = sess.solve(), sess.solve()
        check(same_solve(first, res) and same_solve(again, res),
              f"{what}: the graphed solve differs from the eager one")
        ms = statistics.median(timed(sess.solve)[1] for _ in range(3)) / res.iters * 1e3
        plain_sess.solve()
        plain_ms = statistics.median(timed(plain_sess.solve)[1]
                                     for _ in range(3)) / plain.iters * 1e3
        rec = dict(method=method, stencil="27pt", precond=precond, dtype="float32",
                   iters=res.iters, plain_iters=plain.iters, status=res.status,
                   eager_wall_s=wall, graphed_ms_per_iter=ms,
                   plain_graphed_ms_per_iter=plain_ms,
                   launches={k: v for k, v in launches.items() if v})
        print(f"[precond_f32] {method} + {precond:12s} iters={res.iters} (plain "
              f"{plain.iters}) graphed {ms:.4f} ms/iter (plain {plain_ms:.4f}) "
              f"launches={rec['launches']}")
        out.append(rec)
        sess._executables.clear()
        plain_sess._executables.clear()
    check(window == total, f"precond_f32 window launches {window}, its solves' {total}")
    return out


#: device-time groups of the profile: name -> fragment of the kernel's name
PROFILE_GROUPS = {
    "fused_cg_body": "fused_cg_body_kernel",
    "fused_pcg_body": "fused_pcg_body_kernel",
    "fused_pipe_body": "fused_pipe_body_kernel",
    "fused_ppipe_body": "fused_ppipe_body_kernel",
    "fused_dots": "fused_dots_kernel",
    "bicgstab_fused_update1": "bicgstab_update1_kernel",
    "bicgstab_fused_spmv_dots": "BicgDotsTail<double>",
    "bicgstab_fused_spmv_update": "BicgUpdateTail<double>",
    "stencil_spmv_dots": "SpmvTail<double, 2>",
    "stencil_spmv_dots3": "Dots3Tail<double>",
    "stencil_spmv": "SpmvTail<double, 0>",
    "cheb_fused_step": "ChebTail<double>",
    "block_jacobi_sweep": "JacobiTail<double>",
    "reduce_partials": "reduce_partials",
    "DtoH": "Memcpy DtoH",
    "DtoD": "Memcpy DtoD",
}


#: the solves whose device time phase 2 profiles: (method, precond)
PROFILE_CASES = (("cg_merged", "none"), ("pcg_merged", "chebyshev"),
                 ("cg_pipe", "none"), ("pcg_pipe", "chebyshev"),
                 ("bicgstab_merged", "none"), ("pbicgstab_merged", "chebyshev"))
#: solves timed beside them, not profiled: the classical BiCGStabs on the
#: SpMV kernel, against which the merged ones' time to solution is read
WALL_ONLY_CASES = (("bicgstab", "none"), ("pbicgstab", "chebyshev"))


def warm_walls(cases, rounds: int = 5) -> tuple[dict, dict]:
    """Median wall time per iteration (ms) of each warm unprofiled solve
    (128³, 27pt, f64, kernels), eager (a fresh session's eager loop, as the
    counted windows run it) and graphed (one session per case, its
    executable built first), eager then graphed for each case, the cases in
    turn, ``rounds`` times, before any profiler session starts.  Returns
    ``{case: {"eager": ms, "graphed": ms}}`` and the graphed sessions."""
    sessions = {}
    for method, precond in cases:                             # warm allocator
        run_solve(method, "27pt", RANK_BLOCK, True, precond)
        sessions[(method, precond)] = kernel_session(method, precond, RANK_BLOCK)
        sessions[(method, precond)].solve()                   # builds it
    walls = {case: {"eager": [], "graphed": []} for case in cases}
    iters = {}
    for _ in range(rounds):
        for case in cases:
            _, res, wall, _, _ = run_solve(case[0], "27pt", RANK_BLOCK, True, case[1])
            graphed, gwall = timed(sessions[case].solve)
            check(same_solve(graphed, res), f"{case}: graphed and eager solves differ")
            walls[case]["eager"].append(wall / res.iters * 1e3)
            walls[case]["graphed"].append(gwall / res.iters * 1e3)
            iters[case] = res.iters
    out = {case: {r: statistics.median(v) for r, v in w.items()} for case, w in walls.items()}
    for (method, precond), ms in out.items():
        k = iters[(method, precond)]
        print(f"[walls] {method} precond={precond} 27pt 128^3: iters={k} warm wall "
              f"eager {ms['eager']:.4f} graphed {ms['graphed']:.4f} ms/iter; to solution "
              f"{k * ms['eager']:.4f} / {k * ms['graphed']:.4f} ms (median of {rounds})")
    return out, sessions


def profile_solve(method: str, precond: str, warm_ms_per_iter: float,
                  route: str, sess: SolverSession) -> dict:
    """Where the time of one warm solve (128³, 27pt, f64, kernels) goes on
    the card: device time by kernel from ``torch.profiler``, against the
    median warm wall time per iteration from :func:`warm_walls`.  ``route``
    is ``eager`` (the session's eager loop) or ``graphed`` (its executable,
    already built)."""
    from torch.profiler import ProfilerActivity, profile
    solve = sess._solve_eager if route == "eager" else sess.solve
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = solve()
        torch.cuda.synchronize()
    us = dict.fromkeys(PROFILE_GROUPS, 0.0)
    us["other"] = 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        t = float(getattr(e, "self_device_time_total", 0.0))
        g = next((g for g, frag in PROFILE_GROUPS.items() if frag in e.key), "other")
        us[g] += t
    total = sum(us.values())
    per_iter = {g: v / res.iters / 1e3 for g, v in us.items() if v}
    rec = dict(method=method, precond=precond, route=route, iters=res.iters,
               device_ms_per_iter=per_iter,
               device_ms_total_per_iter=total / res.iters / 1e3,
               warm_wall_ms_per_iter=warm_ms_per_iter,
               device_busy_share=(total / res.iters / 1e3) / warm_ms_per_iter
               if total else None)
    print(f"[profile] {method} precond={precond} {route} 27pt 128^3: iters={res.iters} "
          f"warm wall {warm_ms_per_iter:.4f} ms/iter (median of 5 unprofiled solves); "
          f"device ms/iter " + " ".join(f"{g}={v:.4f}" for g, v in per_iter.items())
          + f"; busy share {rec['device_busy_share']}")
    return rec


def reserved_gb(base: int) -> float:
    """GB the caching allocator reserved at its peak above ``base`` bytes."""
    return (torch.cuda.max_memory_reserved() - base) / 1e9


def socket_solve(method: str, precond: str, elems_per_iter=None,
                 rounds: int = 3) -> dict:
    """Phase 3: one method on the kernels at the per-socket hybrid block;
    ``elems_per_iter(n, npad)`` is the elements one iteration moves (None
    for the classical methods, whose eager iteration is not counted).  The
    counted eager solve, then the graphed solve (its executable built first,
    with the allocator's peak reserve above what was reserved before it),
    then ``rounds`` more of each in turn: ms/iter the median of each
    route's solves, the graphed ones bitwise equal to the counted one."""
    run_solve(method, "27pt", SOCKET_BLOCK, True, precond)    # warm allocator
    sess, res, wall, launches, pads = run_solve(method, "27pt", SOCKET_BLOCK, True,
                                                precond)
    n = sess.problem.rows
    del sess
    npad = (SOCKET_BLOCK[0] + 2) * (SOCKET_BLOCK[1] + 2) * (SOCKET_BLOCK[2] + 2)
    bytes_iter = elems_per_iter(n, npad) * 8 if elems_per_iter else None
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    graphed = kernel_session(method, precond, SOCKET_BLOCK)
    first, first_s = timed(graphed.solve)
    mem = reserved_gb(base)
    eager_walls, graphed_walls = [wall], []
    for _ in range(rounds):
        got, gwall = timed(graphed.solve)
        check(same_solve(got, res), f"socket block {method}: graphed and eager differ")
        graphed_walls.append(gwall)
        eager_walls.append(run_solve(method, "27pt", SOCKET_BLOCK, True, precond)[2])
    check(same_solve(first, res), f"socket block {method}: graphed and eager differ")
    err = float((res.x - graphed.problem.x_true()).abs().max())
    eager_ms = statistics.median(eager_walls) / max(res.iters, 1) * 1e3
    graphed_ms = statistics.median(graphed_walls) / max(res.iters, 1) * 1e3
    rec = dict(method=method, precond=precond, grid=list(SOCKET_BLOCK),
               iters=res.iters, status=res.status, wall_s=wall,
               ms_per_iter=eager_ms, graphed_ms_per_iter=graphed_ms,
               bytes_per_iter=bytes_iter,
               gb_per_s=bytes_iter / eager_ms / 1e6 if bytes_iter else None,
               graphed_gb_per_s=bytes_iter / graphed_ms / 1e6 if bytes_iter else None,
               graphed_first_wall_s=first_s, graphed_reserved_gb=mem,
               **exe_stats(graphed, got),
               err=err, launches={k: v for k, v in launches.items() if v}, pads=pads)
    del graphed
    rate = (f"GB/s={rec['gb_per_s']:.1f} graphed {rec['graphed_gb_per_s']:.1f} "
            f"(bytes/iter={bytes_iter})" if bytes_iter else "GB/s not counted")
    print(f"[socket] {method} precond={precond} 27pt {SOCKET_BLOCK} "
          f"iters={res.iters} status={res.status} ms/iter eager={eager_ms:.4f} "
          f"graphed={graphed_ms:.4f} ({graphed_ms / eager_ms:.4f}x) {rate} "
          f"max|x-1|={err:.3e} build {rec['compile_s']:.3f}s reserved {mem:.3f} GB "
          f"blocks={rec['blocks']} launches={rec['launches']} pads={pads}")
    check(res.status == 0, f"socket block {method}: status {res.status}")
    check(pads == expected_pads(method, precond, launches, "27pt", SOCKET_BLOCK),
          f"socket block {method}: {pads} pads")
    check(err < 1e-6, f"socket block {method}: max|x-1| = {err}")
    check(launches == expected_launches(method, res.iters, precond),
          f"socket block {method}: launches {launches}")
    return rec


#: the K sweep: the largest block and the routes it is run on
K_SWEEP = (1, 2, 4, 8, 16, 32)
K_SWEEP_CASES = (("cg_merged", "none"), ("pcg_merged", "chebyshev"))


def k_sweep() -> list[dict]:
    """Phase 3b: the graphed solve of each :data:`K_SWEEP_CASES` route at
    128³ and at the socket block with each largest block ``K``: build
    seconds, the allocator's peak reserve above what was reserved before,
    ms/iter (median of the warm solves after the first), the blocks a solve
    runs and the steps it runs and drops; every solve bitwise equal to the
    eager one."""
    out = []
    for grid, rounds in ((RANK_BLOCK, 5), (SOCKET_BLOCK, 2)):
        for method, precond in K_SWEEP_CASES:
            eager = kernel_session(method, precond, grid)._solve_eager()
            for K in K_SWEEP:
                torch.cuda.empty_cache()
                base = torch.cuda.memory_reserved()
                torch.cuda.reset_peak_memory_stats()
                sess = kernel_session(method, precond, grid, max_block=K)
                _, first_s = timed(sess.solve)
                mem = reserved_gb(base)
                walls = []
                for _ in range(rounds):
                    res, wall = timed(sess.solve)
                    check(same_solve(res, eager), f"K={K} {method}: graphed and eager differ")
                    walls.append(wall / res.iters * 1e3)
                rec = dict(grid=list(grid), method=method, precond=precond, K=K,
                           iters=res.iters, first_wall_s=first_s,
                           ms_per_iter=statistics.median(walls), reserved_gb=mem,
                           **exe_stats(sess, res))
                del sess
                print(f"[K sweep] {method} precond={precond} {grid} K={K}: "
                      f"{rec['ms_per_iter']:.4f} ms/iter build {rec['compile_s']:.3f}s "
                      f"reserved {mem:.3f} GB blocks={rec['blocks']} "
                      f"rolled back {rec['rolled_back']}")
                out.append(rec)
            del eager
    return out


def phase_socket_block() -> list[dict]:
    """Phase 3: the merged and pipelined CG and PCG + Chebyshev and the
    merged BiCGStabs at the socket block, with the classical BiCGStabs and
    CG beside them.

    Elements moved per iteration (each input read once, each output written
    once): merged CG's fused body 5 reads + 4 writes and the ``spmv_dots``
    pass reading r and writing w, the zero halo made in the kernel: 11n.
    Merged PCG + Chebyshev: the fused body 6 reads + 4 writes (10n);
    ``z = r/θ`` (2n); three Chebyshev steps, each a pad (n + npad) and
    a pass reading padded z, r, d and writing z, d (npad + 4n); the
    ``spmv_dots3`` pass reading u and r and writing w, the zero halo made in
    the kernel (3n): 30n + 6·npad.  Pipelined CG: the ``spmv_dots3`` pass
    (3n), the body 7 reads + 6 writes: 16n.  Pipelined PCG + Chebyshev:
    ``fused_dots`` 3 reads; the Chebyshev apply on w as above (17n + 6·npad);
    the SpMV of m (2n); the body 10 reads + 8 writes: 40n + 6·npad.
    Merged BiCGStab: the pad of z (n + npad), pass 1 reading padded z and six
    vectors and writing three (npad + 9n), the ω-half 6 reads + 3 writes
    (9n), the pad of w (n + npad), pass 3 reading padded w and six vectors
    and writing four (npad + 10n): 30n + 4·npad.  pbicgstab_merged +
    Chebyshev adds two Chebyshev applies as above: 64n + 16·npad.
    """
    return [socket_solve("cg_merged", "none", lambda n, npad: 11 * n),
            socket_solve("pcg_merged", "chebyshev",
                         lambda n, npad: 30 * n + 6 * npad),
            socket_solve("cg_pipe", "none", lambda n, npad: 16 * n),
            socket_solve("pcg_pipe", "chebyshev",
                         lambda n, npad: 40 * n + 6 * npad),
            socket_solve("bicgstab_merged", "none", lambda n, npad: 30 * n + 4 * npad),
            socket_solve("pbicgstab_merged", "chebyshev",
                         lambda n, npad: 64 * n + 16 * npad),
            socket_solve("bicgstab", "none"),
            socket_solve("pbicgstab", "chebyshev"),
            socket_solve("cg", "none")]


# -- the batched path: B right-hand sides in one solve ------------------------------

#: the lanes of the batched path's solves (the serve layer's max_batch) and
#: the lane counts its kernels are timed at
BATCH = 4
BATCH_KERNEL_LANES = (4, 8)
#: each kernel of the batched path -> its 3-D kernel (the key of its row)
BATCHED_KERNELS = {"stencil_spmv_batched": "stencil_spmv",
                   "cheb_fused_step_batched": "cheb_fused_step",
                   "block_jacobi_sweep_batched": "block_jacobi_sweep"}


def phase_batched_kernels(timer: Timer, peaks) -> dict:
    """Phase 1 for the batched path's kernels: the lane-batched forms of
    ``stencil_spmv``, ``cheb_fused_step`` and ``block_jacobi_sweep`` (each
    from x or z unpadded, as the batched solve runs it, and padded; the
    sweeps' f64 old pass behind its pad timed beside) at B = 4 and 8 lanes of
    128³, 27pt and 7pt, f64, f32 and bf16: one launch over all lanes, f64
    and bf16 outputs bitwise equal to the plain version's on the 4-D
    operands (f32 within the output tolerance) and every lane bitwise equal
    to the 3-D kernel's on it; CUDA-event times beside the plain version's, a batched ``conv3d``
    (N = B) for the SpMV, and the bound: B times the 3-D row's bytes and
    operations.  Keyed ``(name, stencil, dtype, B)``."""
    bw = peaks[0]
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    for dt in KERNEL_DTYPES:
        t_dt = time.perf_counter()
        peak_ops = op_rate(peaks, dt)
        es = torch.finfo(dt).bits // 8
        out_tol = tols(dt)[0]
        for sname in ("27pt", "7pt"):
            st = STENCILS[sname]
            cheb_a, cheb_c = Chebyshev().setup(LocalOp(st))[1][0]
            for B in BATCH_KERNEL_LANES:
                x, r, d = (torch.randn((B, *RANK_BLOCK), generator=gen, dtype=dt,
                                       device="cuda") for _ in range(3))
                xp = pad1(x)
                n, npad = x[0].numel(), xp[0].numel()
                stages = ring_stages(x, xp)
                jacobi = ring_route("block_jacobi_sweep", dt, xp, (r,), st.npoint)
                cheb = ring_route("cheb_fused_step", dt, xp, (r, d), st.npoint)
                if dt == torch.bfloat16 and sname == "27pt":
                    (stages["kernel_name"], jacobi["kernel_name"],
                     cheb["kernel_name"]) = ring_kernels_launched([
                        (lambda: ops.spmv(x, st, zero_halo=True),
                         "SpmvTail<__nv_bfloat16, 0>", "pair_unpadded"),
                        (lambda: ops.jacobi_sweep(xp, r, st, omega=1.0),
                         "JacobiTail<__nv_bfloat16>", "pair_padded"),
                        (lambda: ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c),
                         "ChebTail<__nv_bfloat16>", "pair_padded")])
                if dt == torch.float32 and sname == "27pt":
                    # f32's sweeps over B lanes on the pair stage; the lanes
                    # at a 4-byte offset keep stencil_kernel
                    xm = misaligned(xp)
                    jacobi["kernel_name"], cheb["kernel_name"] = ring_kernels_launched([
                        (lambda: ops.jacobi_sweep(xp, r, st, omega=1.0),
                         "JacobiTail<float>", "pair_padded"),
                        (lambda: ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c),
                         "ChebTail<float>", "pair_padded")], old=[
                        (lambda: ops.jacobi_sweep(xm, r, st, omega=1.0), "JacobiTail<float>"),
                        (lambda: ops.cheb_step(xm, r, d, st, a=cheb_a, c=cheb_c),
                         "ChebTail<float>")])
                    check(torch.equal(ops.jacobi_sweep(xm, r, st, omega=1.0),
                                      ops.jacobi_sweep(xp, r, st, omega=1.0)) and
                          all(torch.equal(a, b) for a, b in zip(
                              ops.cheb_step(xm, r, d, st, a=cheb_a, c=cheb_c),
                              ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c))),
                          f"f32 sweeps B={B}: the pair stage differs from the old pass")
                    del xm
                if dt == torch.float64 and sname == "27pt":
                    # f64's sweeps over B lanes on the ring, both forms, both
                    # stencils (the 7pt rows' instances named here too)
                    f64_names = f64_sweeps_launched(x, xp, r, d)
                    jacobi["kernel_name"], cheb["kernel_name"] = (
                        f64_names["block_jacobi_sweep"][0], f64_names["cheb_fused_step"][0])
                ops_k1 = n * (2 * st.npoint - 1)

                def calls(x, xp, r, d):
                    return [ops.spmv(x, st, zero_halo=True), ops.spmv(xp, st),
                            *ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c),
                            ops.jacobi_sweep(xp, r, st, omega=1.0),
                            *ops.cheb_step(x, r, d, st, a=cheb_a, c=cheb_c, zero_halo=True),
                            ops.jacobi_sweep(x, r, st, omega=1.0, zero_halo=True)]

                got = calls(x, xp, r, d)
                yr = ref.stencil_spmv_ref(xp, stencil=st)
                plain = [yr, yr, *ref.cheb_fused_step_ref(xp, r, d, stencil=st, a=cheb_a,
                                                          c=cheb_c),
                         ref.block_jacobi_sweep_ref(xp, r, stencil=st, omega=1.0)]
                plain += plain[2:5]
                torch.cuda.synchronize()
                what = f"{sname} {dt} B={B}"
                for g, pv in zip(got, plain):
                    check(torch.allclose(g, pv, rtol=out_tol, atol=out_tol),
                          f"batched kernels {what}: max err {max_err([(g, pv)])}")
                    check(dt == torch.float32 or torch.equal(g, pv),
                          f"batched kernels {what}: not bitwise equal to the plain version")
                check(all(torch.equal(g, u) for g, u in zip(got[2:5], got[5:])),
                      f"batched kernels {what}: a sweep's unpadded form differs from its "
                      f"padded form")
                old_pad = {}
                if dt == torch.float64:
                    old = [*precond_kernels.cheb_fused_step(
                        x, r, d, stencil=st, a=cheb_a, c=cheb_c, zero_halo=True,
                        old_pass=True), precond_kernels.block_jacobi_sweep(
                        x, r, stencil=st, zero_halo=True, old_pass=True)]
                    check(all(torch.equal(g, o) for g, o in zip(got[2:5], old)),
                          f"batched kernels {what}: the ring differs from the old pass")
                    old_pad = dict(cheb=dict(old_pad_ms=timer.ms(
                        lambda: precond_kernels.cheb_fused_step(
                            x, r, d, stencil=st, a=cheb_a, c=cheb_c, zero_halo=True,
                            old_pass=True))), jacobi=dict(old_pad_ms=timer.ms(
                        lambda: precond_kernels.block_jacobi_sweep(
                            x, r, stencil=st, zero_halo=True, old_pass=True))))
                    del old
                for i in range(B):
                    one = calls(*(t[i].contiguous() for t in (x, xp, r, d)))
                    check(all(torch.equal(g[i], o) for g, o in zip(got, one)),
                          f"batched kernels {what}: lane {i} differs from the 3-D kernel")
                w = conv_weights(st, dt)
                errs = [max_err([(got[0], yr), (got[1], yr)]),
                        max_err(zip(got[2:4], plain[2:4])), max_err([(got[4], plain[4])])]
                rows[("stencil_spmv_batched", sname, str(dt), B)] = dict(
                    max_abs_err=errs[0],
                    ms=timer.ms(lambda: ops.spmv(x, st, zero_halo=True)),
                    padded_ms=timer.ms(lambda: ops.spmv(xp, st)),
                    plain_ms=timer.ms(lambda: ref.stencil_spmv_ref(pad1(x), stencil=st)),
                    library_ms=timer.ms(lambda: F.conv3d(x[:, None], w, padding=1)),
                    bytes=B * 2 * n * es, padded_bytes=B * (npad + n) * es,
                    ops=B * ops_k1, peak_ops=peak_ops, **stages)
                rows[("cheb_fused_step_batched", sname, str(dt), B)] = dict(
                    max_abs_err=max(errs[1], max_err(zip(got[5:7], plain[5:7]))),
                    ms=timer.ms(lambda: ops.cheb_step(x, r, d, st, a=cheb_a, c=cheb_c,
                                                      zero_halo=True)),
                    padded_ms=timer.ms(lambda: ops.cheb_step(xp, r, d, st, a=cheb_a,
                                                             c=cheb_c)),
                    plain_ms=timer.ms(lambda: ref.cheb_fused_step_ref(
                        pad1(x), r, d, stencil=st, a=cheb_a, c=cheb_c)),
                    library_ms=None, bytes=B * 5 * n * es,
                    padded_bytes=B * (npad + 4 * n) * es,
                    ops=B * (ops_k1 + 5 * n), peak_ops=peak_ops, **old_pad.get("cheb", {}),
                    **cheb)
                rows[("block_jacobi_sweep_batched", sname, str(dt), B)] = dict(
                    max_abs_err=max(errs[2], max_err([(got[7], plain[7])])),
                    ms=timer.ms(lambda: ops.jacobi_sweep(x, r, st, omega=1.0,
                                                         zero_halo=True)),
                    padded_ms=timer.ms(lambda: ops.jacobi_sweep(xp, r, st, omega=1.0)),
                    plain_ms=timer.ms(lambda: ref.block_jacobi_sweep_ref(
                        pad1(x), r, stencil=st, omega=1.0)),
                    library_ms=None, bytes=B * 3 * n * es,
                    padded_bytes=B * (npad + 2 * n) * es,
                    ops=B * (ops_k1 + 4 * n), peak_ops=peak_ops, **old_pad.get("jacobi", {}),
                    **jacobi)
                del x, r, d, xp, got, plain, yr
        print(f"[batched-kernels] the {dt} rows took {time.perf_counter() - t_dt:.2f}s")
    for (name, sname, dt, B), row in rows.items():
        set_bounds(row, bw)
        lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        padded = (f" padded_ms={row['padded_ms']:.4f} "
                  f"padded_bound_ms={row['padded_bound_ms']:.4f}" if "padded_ms" in row
                  else "")
        padded += f" old_pad_ms={row['old_pad_ms']:.4f}" if "old_pad_ms" in row else ""
        print(f"[batched-kernels] {name:26s} {sname:4s} {dt:13s} B={B} ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={lib} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"max_abs_err={row['max_abs_err']:.3e}{padded}")
    return rows


#: phase 2g, the batched path: every case of phases 2a–d and three more
BATCHED_CASES = (MAIN_CASES + PRECOND_CASES + PIPE_CASES + BICGSTAB_CASES
                 + [("cg", "7pt", "none"), ("bicgstab", "7pt", "none"),
                    ("jacobi", "27pt", "none")])
#: the SpMVs of each method's unfused body, the batched route: (at set-up, a step)
UNFUSED_SPMVS = {"cg": (1, 1), "cg_nb": (2, 1), "pcg": (1, 1), "cg_merged": (2, 1),
                 "pcg_merged": (2, 1), "cg_pipe": (2, 1), "pcg_pipe": (2, 1),
                 "bicgstab": (1, 2), "pbicgstab": (1, 2), "bicgstab_b1": (1, 2),
                 "bicgstab_merged": (3, 2), "pbicgstab_merged": (3, 2),
                 "jacobi": (1, 1), "gauss_seidel": (1, 1), "gauss_seidel_rb": (1, 1)}


def batch_lanes(prob, B: int, zero: bool = True) -> torch.Tensor:
    """``B`` lanes of ``prob``: A·1, seeded normal lanes and, with ``zero``,
    a zero lane last."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    out = [prob.b()]
    while len(out) < B - zero:
        out.append(torch.randn(prob.shape, generator=gen, dtype=prob.dtype, device="cuda"))
    if zero and B > 1:
        out.append(torch.zeros(prob.shape, dtype=prob.dtype, device="cuda"))
    return torch.stack(out)


def expected_batched_launches(method: str, steps: int, precond: str) -> dict:
    """The launches an eager batched ``kernels=True`` solve of ``steps``
    steps (the most iterations of any lane) must make: the unfused body's
    SpMVs and preconditioner sweeps, each on its lane-batched kernel, and no
    3-D launch."""
    out = dict.fromkeys(ops.LAUNCHES, 0)
    setup, per_step = UNFUSED_SPMVS[method]
    out["stencil_spmv_batched"] = setup + per_step * steps
    if precond != "none":
        kernel, per_apply = PRECOND_LAUNCHES[precond]
        if kernel is not None:
            out[kernel + "_batched"] += per_apply * PRECOND_APPLIES[method](steps)
    return out


def expected_batched_pads(method: str, precond: str, launches: dict,
                          stencil: str) -> int | None:
    """The ``F.pad`` calls an eager batched ``kernels=True`` solve must make
    on its given lanes: the sweeps' (:func:`sweep_pads`; none on the ring),
    every SpMV taking the lanes unpadded; None (not checked) for the
    Gauss-Seidels and SSOR, whose own sweeps pad with no kernel."""
    if method in ("gauss_seidel", "gauss_seidel_rb") or precond == "ssor":
        return None
    return sweep_pads(launches, stencil, RANK_BLOCK)


def lane(res, i: int) -> SolveResult:
    """Lane ``i`` of a batched result as a single solve's result."""
    return SolveResult(x=res.x[i], iters=int(res.iters[i]), res_norm=res.res_norm[i],
                       history=res.history[i], status=int(res.status[i]))


def phase_batched_path(cases) -> tuple[list, list]:
    """Phase 2g, the counted work: each case's batched solve at 128³ with
    :data:`BATCH` lanes (A·1, two seeded normal lanes, a zero lane) on the
    eager route (``_solve_batched_eager``: one read a step, every wrapper
    call a launch), with exactly the launches it must make.  Returns the
    records and, for :func:`check_batched`, each session, batch and result."""
    out, solves = [], []
    for method, stencil, precond in cases:
        what = f"{method}/{stencil}/{precond}"
        sess = SolverSession(method=method, grid=RANK_BLOCK, stencil=stencil,
                             options=SolverOptions(kernels=True, precond=precond))
        bs = batch_lanes(sess.problem, BATCH)
        ((res, wall), launches), pads = counted_pads(
            lambda: counted(lambda: timed(lambda: sess._solve_batched_eager(bs))))
        iters = res.iters.tolist()
        want = expected_batched_launches(method, max(iters), precond)
        want_pads = expected_batched_pads(method, precond, launches, stencil)
        rec = dict(method=method, stencil=stencil, precond=precond, lanes=BATCH,
                   iters=iters, status=res.status.tolist(), wall_s=wall,
                   launches={k: v for k, v in launches.items() if v}, pads=pads)
        print(f"[batched] {method:16s} {stencil:4s} {precond:12s} B={BATCH} iters={iters} "
              f"status={rec['status']} wall={wall:.4f}s launches={rec['launches']} "
              f"pads={pads}")
        check(launches == want, f"batched {what}: launches {launches}, expected {want}")
        check(want_pads is None or pads == want_pads,
              f"batched {what}: {pads} pads, expected {want_pads}")
        out.append(rec)
        solves.append((rec, sess, bs, res))
    return out, solves


def check_batched(solves) -> None:
    """Phase 2g, outside the counted window: each lane of each batched solve
    bitwise the same-route single solve of it (the session's unfused eager
    loop), the A·1 lane within 1e-6 of 1; the graphed batched solve
    (``compile_batched``, a miss, then ``solve_batched``, a hit) bitwise the
    eager one.  Adds the single solves' iterations, the graphed wall time
    and the executable's counters to each record."""
    for rec, sess, bs, res in solves:
        what = f"{sess.method}/{sess.problem.stencil.name}/{sess.options.precond}"
        singles = [sess._solve_unfused(bs[i]) for i in range(bs.shape[0])]
        for i, one in enumerate(singles):
            check(same_solve(lane(res, i), one), f"batched {what}: lane {i} differs from "
                  f"its single solve (iters {int(res.iters[i])} vs {one.iters})")
        err = float((res.x[0] - 1).abs().max())
        check(err < 1e-6, f"batched {what}: the A·1 lane has max|x-1| = {err}")
        compile_s = sess.compile_batched(bs.shape[0])
        got, wall = timed(lambda: sess.solve_batched(bs))
        check(all(same_solve(lane(got, i), lane(res, i)) for i in range(bs.shape[0])),
              f"batched {what}: graphed and eager differ")
        ((key, st),) = sess.cache_stats().items()
        check(key[0] == tuple(bs.shape) and (st["misses"], st["hits"]) == (1, 1),
              f"batched {what}: cache {key} {st}")
        exe = sess._executables[tuple(bs.shape)]
        rec.update(single_iters=[one.iters for one in singles], a1_err=err,
                   compile_batched_s=compile_s, graphed_wall_s=wall, blocks=list(exe.blocks))
        print(f"[batched-graphed] {what:36s} lanes bitwise their single solves "
              f"(iters {rec['single_iters']}); max|x-1| {err:.3e}; compile_batched "
              f"{compile_s:.3f}s graphed {wall:.4f}s (eager {rec['wall_s']:.4f}s) "
              f"blocks={rec['blocks']}")
        sess._executables.clear()


# -- phase 2h, the resilience path: guards, residual replacement, telemetry --------

#: the healthy guarded solves: the six fused routes and classical cg and
#: bicgstab, 128³ 27pt f64, kernels=True
RESILIENCE_CASES = (("cg_merged", "none"), ("pcg_merged", "chebyshev"),
                    ("cg_pipe", "none"), ("pcg_pipe", "chebyshev"),
                    ("bicgstab_merged", "none"), ("pbicgstab_merged", "chebyshev"),
                    ("cg", "none"), ("bicgstab", "none"))
#: the stagnation guards: (method, precond) -> (stagnation_window,
#: stagnation_rtol).  One step of either rarely cuts the squared residual
#: tenfold (merged CG) or a hundredfold (merged PCG + Chebyshev), so the guard
#: fires once that many steps have passed without it, before convergence
STAGNATION = {("cg_merged", "none"): (20, 0.1), ("pcg_merged", "chebyshev"): (5, 0.01)}
#: residual replacement: the routes and the interval
RR_CASES = (("cg_merged", "none"), ("pcg_pipe", "chebyshev"))
RR_EVERY = 10
#: the graphed ms/iter settings (phase 2h's timings)
RESILIENCE_SETTINGS = {"off": {}, "guards": dict(guards=True),
                       "guards+telemetry": dict(guards=True, telemetry=True)}
RESILIENCE_TIMING_CASES = (("cg_merged", "none"), ("pcg_merged", "chebyshev"))


def resilient_session(method, precond, grid=None, **opts) -> SolverSession:
    """A ``kernels=True`` 27pt f64 session (128³ unless ``grid``) with the
    resilience options ``opts``."""
    return SolverSession(method=method, grid=grid or RANK_BLOCK, stencil="27pt",
                         options=SolverOptions(kernels=True, precond=precond, **opts))


def same_watched_solve(got, want) -> bool:
    """:func:`same_solve`, and the telemetry bitwise too."""
    return same_solve(got, want) and bits_equal(got.telemetry, want.telemetry)


def always_the_largest(ladder, predicted, budget):
    return max(k for k in ladder if k <= budget)


def phase_resilience() -> dict:
    """Phase 2h, the counted work: the resilient drivers at 128³ on the
    kernels.

    * Healthy: each of :data:`RESILIENCE_CASES` with ``guards=True`` and
      ``telemetry=True``, through the eager loop (counted) and the cache
      (CUDA graphs), each bitwise the unguarded eager solve of the same
      route (iterations, status, iterate, residual, history), the telemetry
      of both routes bitwise equal and its residual column's square root
      bitwise the history, the eager launches those of the unguarded solve.
    * NaN: a NaN in ``b`` on merged CG's graphed fused route ends in
      breakdown at iteration 0; ``on_breakdown="raise"`` raises
      ``SolveBreakdown``.
    * Stagnation (:data:`STAGNATION`): the eager solve ends ``stagnated`` at
      an iteration printed here; the graphed solve with its own blocks and
      with the largest block every time is bitwise it, and at least one of
      the two ran past the stop and rolled back (the guard fired inside a
      block).
    * Residual replacement every :data:`RR_EVERY` (:data:`RR_CASES`):
      converged, graphed bitwise eager, true residual below ``tol``.
    * Batched: B = 4 lanes of cg with guards and telemetry (A·1, two seeded
      normal lanes, the second poisoned by ``ChaosInjector.poison_b``): the
      poisoned lane ends in breakdown at 0, each clean lane bitwise its
      single solve, the graphed batched solve bitwise the eager one.
    * Fallback: merged CG under ``on_breakdown="fallback"`` converges, and
      with its first attempt stamped breakdown the ladder's first rung (the
      same method off the kernels) converges.
    """
    out = {"healthy": [], "stagnation": [], "residual_replacement": []}
    for method, precond in RESILIENCE_CASES:
        what = f"{method}/{precond}"
        plain, plain_launches = counted(resilient_session(method, precond)._solve_eager)
        sess = resilient_session(method, precond, guards=True, telemetry=True)
        eager, launches = counted(sess._solve_eager)
        graphed, wall = timed(sess.solve)
        mdef = get_method(method)
        col = eager.telemetry[:eager.iters + 1, mdef.res_index - len(mdef.vectors)]
        rec = dict(method=method, precond=precond, iters=eager.iters, status=eager.status,
                   plain_iters=plain.iters, graphed_wall_s=wall,
                   telemetry_rows=int(eager.telemetry.shape[0]),
                   launches={k: v for k, v in launches.items() if v})
        print(f"[resilience] healthy {what:28s} guards+telemetry iters={eager.iters} "
              f"(unguarded {plain.iters}) status={eager.status} graphed {wall:.4f}s "
              f"launches={rec['launches']}")
        check(plain.status == 0, f"resilience {what}: unguarded status {plain.status}")
        check(same_solve(eager, plain), f"resilience {what}: the guarded eager solve "
              f"differs from the unguarded one")
        check(same_watched_solve(graphed, eager),
              f"resilience {what}: the guarded graphed solve differs from the eager one")
        check(bits_equal(torch.sqrt(col), eager.history[:eager.iters + 1]),
              f"resilience {what}: the telemetry's residual column is not the history")
        check(launches == plain_launches, f"resilience {what}: launches {launches}, "
              f"unguarded {plain_launches}")
        out["healthy"].append(rec)

    sess = resilient_session("cg_merged", "none", guards=True, on_breakdown="none")
    bnan = sess.problem.b().clone()
    bnan[tuple(n // 2 for n in bnan.shape)] = float("nan")
    nan = sess.solve(bnan)
    check(sess._use_fused_body() and nan.status == STATUS_BREAKDOWN and nan.iters == 0,
          f"resilience NaN b: status {nan.status} after {nan.iters} iterations")
    raising = resilient_session("cg_merged", "none", guards=True)
    try:
        raising.solve(bnan)
        raised = None
    except SolveBreakdown as e:
        raised = e.result.status
    check(raised == STATUS_BREAKDOWN, f"resilience NaN b: on_breakdown='raise' gave {raised}")
    out["nan"] = dict(status=nan.status, iters=nan.iters, raised=raised)
    print(f"[resilience] NaN b, cg_merged graphed fused: status={nan.status} "
          f"iters={nan.iters}; on_breakdown='raise' raised SolveBreakdown({raised})")

    for (method, precond), (window, rtol) in STAGNATION.items():
        what = f"{method}/{precond}"
        sess = resilient_session(method, precond, guards=True, on_breakdown="none",
                                 stagnation_window=window, stagnation_rtol=rtol)
        eager = sess._solve_eager()
        graphed = sess.solve()
        exe = sess._executables[sess.problem.shape]
        own = list(exe.blocks)
        exe.pick = always_the_largest
        forced = sess.solve()
        rec = dict(method=method, precond=precond, window=window, rtol=rtol,
                   fired_at=eager.iters, status=eager.status, blocks=own,
                   forced_blocks=list(exe.blocks))
        print(f"[resilience] stagnation {what:24s} window={window} rtol={rtol}: fired at "
              f"iteration {eager.iters} status={eager.status}; graphed blocks {own}, "
              f"largest-block run {rec['forced_blocks']}")
        check(eager.status == STATUS_STAGNATED, f"resilience {what}: status {eager.status}")
        check(same_solve(graphed, eager) and same_solve(forced, eager),
              f"resilience {what}: the graphed stagnated solve differs from the eager one")
        check(sum(own) > eager.iters or sum(rec["forced_blocks"]) > eager.iters,
              f"resilience {what}: the guard fired only at a block's edge")
        out["stagnation"].append(rec)

    for method, precond in RR_CASES:
        what = f"{method}/{precond}"
        sess = resilient_session(method, precond, residual_replacement=RR_EVERY)
        eager = sess._solve_eager()
        graphed = sess.solve()
        prob = sess.problem
        true_res = float(torch.linalg.vector_norm(prob.b() - prob.stencil.matvec(graphed.x)))
        exe = sess._executables[prob.shape]
        rec = dict(method=method, precond=precond, every=RR_EVERY, iters=eager.iters,
                   status=eager.status, true_res=true_res, blocks=list(exe.blocks))
        print(f"[resilience] residual replacement {what:20s} every {RR_EVERY}: "
              f"iters={eager.iters} status={eager.status} |b-Ax|={true_res:.3e} "
              f"blocks={rec['blocks']}")
        check(eager.status == 0 and same_solve(graphed, eager),
              f"resilience {what}: residual replacement status {eager.status}, or the "
              f"graphed solve differs from the eager one")
        check(true_res < sess.options.tol, f"resilience {what}: true residual {true_res}")
        out["residual_replacement"].append(rec)

    sess = resilient_session("cg", "none", guards=True, telemetry=True, on_breakdown="none")
    gen = torch.Generator(device="cuda").manual_seed(25)
    normal = [torch.randn(RANK_BLOCK, generator=gen, dtype=torch.float64, device="cuda")
              for _ in range(2)]
    poisoned, hit = ChaosInjector(ChaosPlan(seed=0, nan_rate=1.0)).poison_b(normal[1])
    check(hit and bool(torch.isnan(poisoned).any()), "resilience: the lane was not poisoned")
    bs = torch.stack([sess.problem.b(), normal[0], normal[1], poisoned])
    eager = sess._solve_batched_eager(bs)
    graphed = sess.solve_batched(bs)
    iters, status = eager.iters.tolist(), eager.status.tolist()
    print(f"[resilience] batched cg B=4 (A·1, two normal lanes, the second poisoned): "
          f"iters={iters} status={status}")
    check(status[3] == STATUS_BREAKDOWN and iters[3] == 0,
          f"resilience batched: the poisoned lane ended {status[3]} at {iters[3]}")
    for i in range(3):
        one = sess._solve_unfused(bs[i])
        check(status[i] == 0 and (iters[i], status[i]) == (one.iters, one.status)
              and all(bits_equal(a, b) for a, b in (
                  (eager.x[i], one.x), (eager.res_norm[i], one.res_norm),
                  (eager.history[i], one.history), (eager.telemetry[i], one.telemetry))),
              f"resilience batched: lane {i} differs from its single solve")
    check(all(bits_equal(a, b) for a, b in zip(graphed, eager)),
          "resilience batched: graphed and eager differ")
    out["batched"] = dict(iters=iters, status=status)

    sess = resilient_session("cg_merged", "none", on_breakdown="fallback")
    clean = sess.solve()
    real = sess._solve_once
    sess._solve_once = lambda b=None, x0=None: real(b, x0)._replace(status=STATUS_BREAKDOWN)
    recovered = sess.solve()
    del sess._solve_once     # the stamp closes a cycle over sess: its graphs die now
    ladder = [name for name, _ in sess._fallback_ladder()]
    print(f"[resilience] fallback cg_merged: clean status={clean.status} iters={clean.iters}; "
          f"first attempt stamped breakdown -> ladder {ladder}, status={recovered.status} "
          f"iters={recovered.iters}")
    check(clean.status == 0 and recovered.status == 0 and ladder == ["cg_merged", "cg"],
          f"resilience fallback: status {clean.status}/{recovered.status}, ladder {ladder}")
    out["fallback"] = dict(clean_status=clean.status, ladder=ladder,
                           recovered_status=recovered.status, recovered_iters=recovered.iters)
    return out


def resilience_timings() -> list[dict]:
    """Phase 2h's timings: the graphed ms/iter of :data:`RESILIENCE_TIMING_CASES`
    at 128³ and at the socket block with the guards off, on, and on with
    telemetry (:data:`RESILIENCE_SETTINGS`): one session each, built first,
    then ``rounds`` rounds over the settings, in turn forwards and backwards
    (the host's speed drifts), each setting one untimed solve (the switch
    from another session's buffers) and two timed ones (median of all timed
    solves); every solve bitwise the first unguarded one.  At 128³ each
    session is then profiled (``profile_solve``: device time and busy
    share)."""
    out = []
    for grid, rounds in ((RANK_BLOCK, 6), (SOCKET_BLOCK, 2)):
        for method, precond in RESILIENCE_TIMING_CASES:
            sessions = {name: resilient_session(method, precond, grid, **kw)
                        for name, kw in RESILIENCE_SETTINGS.items()}
            first = {name: sess.solve() for name, sess in sessions.items()}   # builds
            walls = {name: [] for name in sessions}
            for r in range(rounds):
                for name in list(sessions)[::1 if r % 2 == 0 else -1]:
                    sessions[name].solve()
                    for _ in range(2):
                        res, wall = timed(sessions[name].solve)
                        check(same_solve(res, first["off"]), f"timings {method} {name} "
                              f"{grid}: the solve differs from the unguarded one")
                        walls[name].append(wall / res.iters * 1e3)
            ms = {name: statistics.median(v) for name, v in walls.items()}
            rec = dict(grid=list(grid), method=method, precond=precond,
                       iters=first["off"].iters, ms_per_iter=ms,
                       ratio={name: ms[name] / ms["off"] for name in ms})
            if grid == RANK_BLOCK:
                rec["profiles"] = {
                    name: profile_solve(method, precond, ms[name], "graphed", sessions[name])
                    for name in ("off", "guards", "guards+telemetry")}
            print(f"[resilience timings] {method} precond={precond} {grid} "
                  f"iters={rec['iters']} graphed ms/iter " + " ".join(
                      f"{name}={v:.4f} ({rec['ratio'][name]:.4f}x)" for name, v in ms.items())
                  + f" (median of {2 * rounds})")
            out.append(rec)
            del sessions, first
    return out


#: the solves timed batched against single: (method, precond), 27pt f64, kernels
BATCH_TIMING_CASES = (("cg", "none"), ("pcg", "chebyshev"), ("pcg", "block_jacobi"),
                      ("bicgstab", "none"))
BATCH_TIMING_LANES = (1, 4, 8)
#: device-time groups of a batched or single unfused solve's profile: name ->
#: fragments of the kernel's name (the first group that matches wins)
BATCH_PROFILE_GROUPS = {
    "stencil_spmv": ("SpmvTail<double, 0>",),
    "cheb_fused_step": ("ChebTail<double>",),
    "block_jacobi_sweep": ("JacobiTail<double>",),
    "where": ("where",),
    "dot": ("dot_kernel", "reduce_1Block_kernel"),
    "stack": ("CatArrayBatchedCopy",),
    "scatter": ("scatter",),
    "DtoH": ("Memcpy DtoH",),
    "DtoD": ("Memcpy DtoD",),
}


def device_ms_by_group(fn, groups) -> dict:
    """Device ms of ``fn()`` by kernel group (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(groups, 0.0)
    ms["other"] = 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        g = next((g for g, frags in groups.items() if any(f in e.key for f in frags)),
                 "other")
        ms[g] += float(getattr(e, "self_device_time_total", 0.0)) / 1e3
    return ms


def batched_timings(rounds: int = 3) -> list[dict]:
    """Per-lane warm wall time per iteration of the graphed batched solve at
    B = 1, 4 and 8 (lanes A·1 and seeded normal ones, no zero lane), against
    the graphed single solves of the same lanes in the same run: the wall of
    a warm solve (median of ``rounds``) over the iterations of all its
    lanes.  Also the lane-steps run past each lane's stop (``masked``: the
    steps a lane sits out while another runs; ``past_end``: the steps of the
    last block after every lane has stopped, times B).  After every wall,
    the device time by kernel group (``torch.profiler``) of one warm batched
    solve at B = :data:`BATCH` per lane-step, beside the single solve's of
    the A·1 lane per iteration."""
    out, profiled = [], []
    for method, precond in BATCH_TIMING_CASES:
        single = kernel_session(method, precond, RANK_BLOCK)
        lanes8 = batch_lanes(single.problem, max(BATCH_TIMING_LANES), zero=False)
        single.solve(lanes8[0])                                    # builds it
        single_walls, single_iters = [], []
        for i in range(lanes8.shape[0]):
            walls = []
            for _ in range(rounds):
                res, wall = timed(lambda: single.solve(lanes8[i]))
                walls.append(wall)
            single_walls.append(statistics.median(walls))
            single_iters.append(res.iters)
        for B in BATCH_TIMING_LANES:
            sess = kernel_session(method, precond, RANK_BLOCK)
            bs = lanes8[:B].contiguous()
            compile_s = sess.compile_batched(B)
            sess.solve_batched(bs)
            walls = []
            for _ in range(rounds):
                res, wall = timed(lambda: sess.solve_batched(bs))
                walls.append(wall)
            iters = res.iters.tolist()
            exe = sess._executables[(B, *RANK_BLOCK)]
            wall = statistics.median(walls)
            single_ms = sum(single_walls[:B]) / sum(single_iters[:B]) * 1e3
            rec = dict(method=method, precond=precond, lanes=B, iters=iters,
                       single_iters=single_iters[:B], compile_batched_s=compile_s,
                       wall_s=wall, lane_ms_per_iter=wall / sum(iters) * 1e3,
                       step_ms=wall / max(iters) * 1e3,
                       single_lane_ms_per_iter=single_ms, blocks=list(exe.blocks),
                       masked_lane_steps=sum(max(iters) - k for k in iters),
                       past_end_lane_steps=B * (sum(exe.blocks) - max(iters)))
            print(f"[batched-walls] {method} precond={precond} 27pt 128^3 B={B}: iters={iters} "
                  f"per-lane {rec['lane_ms_per_iter']:.4f} ms/iter (single graphed "
                  f"{single_ms:.4f}; {rec['lane_ms_per_iter'] / single_ms:.4f}x) step "
                  f"{rec['step_ms']:.4f} ms; lane-steps masked {rec['masked_lane_steps']} "
                  f"past the end {rec['past_end_lane_steps']} blocks={rec['blocks']}")
            check(iters == single_iters[:B], f"batched {method}/{precond} B={B}: iters "
                  f"{iters} vs single {single_iters[:B]}")
            out.append(rec)
            if B == BATCH:
                profiled.append((rec, sess, bs, single, lanes8[0], single_iters[0]))
    for rec, sess, bs, single, b0, iters0 in profiled:     # no profiler before here
        dev = device_ms_by_group(lambda: sess.solve_batched(bs), BATCH_PROFILE_GROUPS)
        lane_steps = sum(rec["iters"])
        rec["device_ms_per_lane_step"] = {g: v / lane_steps for g, v in dev.items() if v}
        rec["device_busy_share"] = sum(dev.values()) / (rec["wall_s"] * 1e3)
        dev = device_ms_by_group(lambda: single.solve(b0), BATCH_PROFILE_GROUPS)
        rec["single_device_ms_per_iter"] = {g: v / iters0 for g, v in dev.items() if v}

        def fmt(d):
            return " ".join(f"{g}={v:.4f}" for g, v in d.items())
        print(f"[batched-profile] {rec['method']} precond={rec['precond']} B={rec['lanes']}: "
              f"device ms per lane-step {fmt(rec['device_ms_per_lane_step'])} (busy share "
              f"{rec['device_busy_share']:.3f}); single graphed, device ms/iter "
              f"{fmt(rec['single_device_ms_per_iter'])}")
    return out


# -- the serve phase: the solver service on the card ------------------------------

#: the serve phase's stream: the reference mix's methods (``repro/serve/trace.py``
#: ``MIXED_BUCKETS``) and its production preconditioned cells (``configs/hpcg.py``:
#: pcg + chebyshev, pcg + block_jacobi) at the per-rank block, 10 requests each
#: (two full batches of 4 and one padded), at the ``Request`` defaults tol 1e-8,
#: norm_ref 1.0, maxiter 500
SERVE_BUCKETS = (
    TraceBucket(grid=RANK_BLOCK, method="cg", stencil="27pt", count=10),
    TraceBucket(grid=RANK_BLOCK, method="cg", stencil="7pt", count=10),
    TraceBucket(grid=RANK_BLOCK, method="bicgstab_b1", stencil="27pt", count=10),
    TraceBucket(grid=RANK_BLOCK, method="pcg", stencil="27pt", precond="jacobi",
                precond_params=(("sweeps", 2),), count=10),
    TraceBucket(grid=RANK_BLOCK, method="pcg", stencil="27pt", precond="chebyshev",
                count=10),
    TraceBucket(grid=RANK_BLOCK, method="pcg", stencil="27pt", precond="block_jacobi",
                count=10),
)
SERVE_CONFIG = dict(max_batch=BATCH, kernels=True, async_compile=True, guards=True,
                    device="cuda")
#: the lane-batched kernels of a served dispatch: ``ops.LAUNCHES`` name -> a
#: fragment of the kernel's device name
SERVE_KERNELS = {"stencil_spmv_batched": "SpmvTail<double, 0>",
                 "cheb_fused_step_batched": "ChebTail<double>",
                 "block_jacobi_sweep_batched": "JacobiTail<double>"}
#: where the service writes its journal and the chaos suite its trace (gitignored)
SERVE_SCRATCH = ROOT / "build" / "serve"


def serve_kernels(tb) -> tuple[str, ...]:
    """The lane-batched kernels a bucket's served dispatch runs."""
    extra = {"chebyshev": ("cheb_fused_step_batched",),
             "block_jacobi": ("block_jacobi_sweep_batched",)}
    return ("stencil_spmv_batched", *extra.get(tb.precond, ()))


def fresh(trace) -> list:
    """The requests of ``trace`` again, unsubmitted, on the same payloads."""
    return [dataclasses.replace(r, id=None, t_submit=None, requeues=0) for r in trace]


def serve_stream(trace, **cfg):
    """One replay of ``trace`` (``chunk=4``) through a new service; the
    service (left open) and ``{position in the trace: result}``."""
    svc = SolverService(ServeConfig(**{**SERVE_CONFIG, **cfg}))
    results = replay(svc, trace, chunk=4)
    return svc, {i: results[r.id] for i, r in enumerate(trace) if r.id in results}


def same_served(a, b) -> bool:
    """Two served results with the same iterations, status and residual
    norm, and the same iterate bit for bit."""
    return ((a.iters, a.status, a.res_norm) == (b.iters, b.status, b.res_norm)
            and a.x.dtype == b.x.dtype and a.x.tobytes() == b.x.tobytes())


def profile_dispatch(svc, reqs) -> dict:
    """One warm dispatch of ``reqs`` (one bucket's ``max_batch``) through
    ``svc`` under ``torch.profiler``: launches and device ms of its
    lane-batched kernels, all its device time, and the busy share (device
    time over the dispatch's wall, the profiler on)."""
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        svc.submit(r)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, total = {}, 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        ms = float(getattr(e, "self_device_time_total", 0.0)) / 1e3
        total += ms
        for name, frag in SERVE_KERNELS.items():
            if frag in e.key:
                k = kernels.setdefault(name, dict(launches=0, device_ms=0.0))
                k["launches"] += int(e.count)
                k["device_ms"] += ms
    return dict(wall_s=wall, device_ms=total, device_busy_share=total / (wall * 1e3),
                kernels=kernels)


def phase_serve_stream():
    """The serve phase's counted work: :data:`SERVE_BUCKETS` (seed 0)
    replayed through a new ``SolverService`` (:data:`SERVE_CONFIG`: 128³
    f64, B = 4, ``kernels=True``, builds on the background thread, guards
    on).  Its window's launches are the builds' warm-up steps and captures
    (a graph replay passes no wrapper).  Returns the service (open), the
    trace and ``{position: result}`` for :func:`check_serve`."""
    trace = generate_trace(SERVE_BUCKETS, seed=0)
    torch.cuda.synchronize()
    svc, results = serve_stream(trace)
    torch.cuda.synchronize()
    return svc, trace, results


def check_serve(svc, trace, results, launches: dict, batched_walls: list) -> dict:
    """The serve phase outside its window: every request converged, no
    reject, one build a bucket (``cache_stats()``), 6 misses and no
    eviction; each served result bitwise the same-route single solve of its
    request (the session's ``_solve_unfused``, :func:`check_batched`'s
    yardstick); one warm dispatch of each bucket profiled, its lane-batched
    kernels seen on the card, and the window's launches only lane-batched;
    a second replay on a new service bitwise the first; a preemption of two
    cg 27pt dispatches recovered from the journal, nothing dropped, bitwise
    the first stream, the journal empty after; the chaos suite on the card.
    Returns the stream's latency percentiles and QPS, each bucket's build
    seconds, dispatches, walls, the waits for a build's capture and the
    share of a dispatch spent copying x to the host, and the served
    per-lane ms/iter beside ``batched_timings``'s at B = 4."""
    snap = svc.snapshot()
    cache = snap["cache"]
    # generate_trace deals the buckets round robin, 10 requests each
    tbs = [SERVE_BUCKETS[i % len(SERVE_BUCKETS)] for i in range(len(trace))]
    by_bucket = {}
    for i, (tb, req) in enumerate(zip(tbs, trace)):
        by_bucket.setdefault(req.key(), (tb, []))[1].append(i)
    statuses = {r.status for r in results.values()}
    print(f"[serve] {len(results)}/{len(trace)} served over {len(by_bucket)} buckets, "
          f"rejects {len(svc.rejects())}, statuses {sorted(statuses)}; qps={snap['qps']:.4f} "
          f"p50={snap['p50_s']:.4f}s p95={snap['p95_s']:.4f}s p99={snap['p99_s']:.4f}s")
    check(len(results) == len(trace) and statuses == {"converged"},
          f"serve: {len(results)}/{len(trace)} served, statuses {statuses}")
    check(not svc.rejects(), f"serve: rejects {svc.rejects()}")
    check(cache["misses"] == len(SERVE_BUCKETS) and cache["evictions"] == 0,
          f"serve: cache {cache}")
    waits = [d["wait_s"] * 1e3 for d in svc.dispatch_log if d["compiling"]]
    buckets = {}
    for key, (tb, idx) in by_bucket.items():
        sess = svc.cache._entries[key].session
        stats = sess.cache_stats()
        check(len(stats) == 1 and next(iter(stats.values()))["misses"] == 1,
              f"serve {key.short()}: cache_stats {stats}")
        for i in idx:                     # bitwise the same-route single solve
            one = sess._solve_unfused(torch.from_numpy(trace[i].b).to(sess.device))
            got = results[i]
            check(got.iters == one.iters and got.status == status_name(one.status)
                  and got.x.tobytes() == one.x.cpu().numpy().tobytes(),
                  f"serve {key.short()}: request {i} differs from its single solve "
                  f"(iters {got.iters} vs {one.iters})")
        log = [d for d in svc.dispatch_log if d["bucket"] == key.short()]
        full = [d for d in log if d["lanes"] == BATCH]
        buckets[key.short()] = dict(
            compile_s=cache["per_bucket"][key.short()]["compile_s"],
            dispatches=len(log), lanes=[d["lanes"] for d in log],
            iters=[d["iters"] for d in log],
            dispatch_ms=[d["device_s"] * 1e3 for d in log],
            upload_ms=[d["upload_s"] * 1e3 for d in log],
            copy_ms=[d["copy_s"] * 1e3 for d in log],
            wait_ms=[d["wait_s"] * 1e3 for d in log],
            copy_share=statistics.mean(d["copy_s"] / d["device_s"] for d in log),
            served_lane_ms_per_iter=(statistics.median(
                d["device_s"] * 1e3 / sum(d["iters"]) for d in full) if full else None))
    for key, (tb, idx) in by_bucket.items():     # no profiler before here
        prof = profile_dispatch(svc, fresh([trace[i] for i in idx[:BATCH]]))
        buckets[key.short()]["profile"] = prof
        for name in serve_kernels(tb):
            check(prof["kernels"].get(name, {}).get("launches", 0) > 0,
                  f"serve {key.short()}: no {name} in the profiled dispatch")
            check(launches.get(name, 0) > 0, f"serve: {name} not launched in the window")
    check(all(v == 0 for k, v in launches.items() if not k.endswith("_batched")),
          f"serve: a 3-D kernel launched in the window: {launches}")
    svc.close()
    for b, st in buckets.items():
        p = st["profile"]
        kern = " ".join(f"{k}={v['launches']}x/{v['device_ms']:.3f}ms"
                        for k, v in p["kernels"].items())
        served = st["served_lane_ms_per_iter"]
        print(f"[serve] {b:34s} compile_s={st['compile_s']:.4f} dispatches={st['dispatches']} "
              f"lanes={st['lanes']} iters={st['iters']} dispatch_ms="
              f"{[round(v, 3) for v in st['dispatch_ms']]} wait_ms="
              f"{[round(v, 3) for v in st['wait_ms']]} copy_share={st['copy_share']:.4f} "
              f"lane_ms_per_iter={'-' if served is None else f'{served:.4f}'}; profiled "
              f"dispatch wall {p['wall_s'] * 1e3:.3f} ms busy "
              f"{p['device_busy_share']:.4f} {kern}")
    versus = {}
    for w in batched_walls:
        for key, (tb, _) in by_bucket.items():
            served = buckets[key.short()]["served_lane_ms_per_iter"]
            if (w["lanes"] == BATCH and served is not None and tb.stencil == "27pt"
                    and (tb.method, tb.precond) == (w["method"], w["precond"])):
                versus[key.short()] = dict(served=served, batched=w["lane_ms_per_iter"],
                                           ratio=served / w["lane_ms_per_iter"])
    print(f"[serve] served per-lane ms/iter beside batched_timings's (B = {BATCH}): {versus}")
    print(f"[serve] dispatches that waited on a build's capture: {len(waits)}, wait ms "
          f"{[round(v, 3) for v in waits]}")
    del svc
    # a second replay, on a new service: bitwise the first
    svc2, again = serve_stream(fresh(trace))
    svc2.close()
    snap2 = svc2.snapshot()
    check(len(again) == len(results)
          and all(same_served(again[i], results[i]) for i in results),
          "serve: the second replay differs from the first")
    del svc2
    # a preemption in the cg 27pt bucket, recovered from the journal
    idx = next(idx for tb, idx in by_bucket.values() if tb is SERVE_BUCKETS[0])[:2 * BATCH]
    wal = SERVE_SCRATCH / "wal"
    shutil.rmtree(wal, ignore_errors=True)
    svc3 = SolverService(ServeConfig(**SERVE_CONFIG, recovery_dir=str(wal)),
                         injector=FailureInjector(fail_at_step=1))
    pre = fresh([trace[i] for i in idx])
    got = replay(svc3, pre, chunk=4)
    svc3.close()
    snap3 = svc3.snapshot()
    del svc3
    left = sorted(p.name for p in wal.iterdir()) if wal.is_dir() else []
    check(len(got) == len(pre) and snap3["preemptions"] == 1 and not left
          and all(same_served(got[r.id], results[i]) for r, i in zip(pre, idx)),
          f"serve preemption: {len(got)}/{len(pre)} served, preemptions "
          f"{snap3['preemptions']}, journal left {left}")
    # the chaos suite's serve half on the card
    SERVE_SCRATCH.mkdir(parents=True, exist_ok=True)
    chaos = run_smoke(str(SERVE_SCRATCH / "TRACE_chaos.jsonl"), device="cuda")
    check(chaos["ok"], f"serve: the chaos suite failed: {chaos['checks']}")
    print(f"[serve] second replay bitwise the first (qps {snap2['qps']:.4f}); preemption: "
          f"{len(got)}/{len(pre)} served, preemptions {snap3['preemptions']}, requeued "
          f"{snap3['requeued']}, bitwise the first stream, journal empty; the chaos suite "
          f"on the card: ok ({len(chaos['checks'])} checks)")
    return dict(requests=len(trace), qps=snap["qps"], p50_s=snap["p50_s"],
                p95_s=snap["p95_s"], p99_s=snap["p99_s"], buckets=buckets,
                versus_batched=versus, capture_waits_ms=waits,
                second_replay_qps=snap2["qps"],
                preemption=dict(served=len(got), preemptions=snap3["preemptions"],
                                requeued=snap3["requeued"]),
                chaos=chaos["checks"], launches={k: v for k, v in launches.items() if v})


# ---------------------------------------------------------------- distributed

#: the hard limit of one spawned mesh run, and of each collective in it (s)
MESH_TIMEOUT = 300
MESH_GROUP_TIMEOUT = 240
MESH_SCRATCH = ROOT / "build" / "mesh"
#: (a) NCCL, one rank, a real group: the six fused routes on the kernels and
#: cg, bicgstab without them; (method, precond, kernels)
NCCL_ROUTES = (("cg_merged", "none", True), ("pcg_merged", "chebyshev", True),
               ("cg_pipe", "none", True), ("pcg_pipe", "chebyshev", True),
               ("bicgstab_merged", "none", True), ("pbicgstab_merged", "chebyshev", True),
               ("cg", "none", False), ("bicgstab", "none", False))
#: (b) gloo, 2 and 4 ranks sharing the card, RANK_BLOCK a rank, the z split;
#: the stationary methods' hundreds of iterations run at P = 2 only (the
#: phase's time: four contexts time-slice the card)
GLOO_ROUTES = (("cg", "none", False), ("cg_nb", "none", False), ("bicgstab", "none", False),
               ("bicgstab_b1", "none", False), ("jacobi", "none", False),
               ("gauss_seidel_rb", "none", False), ("cg_merged", "none", False),
               ("pcg_merged", "chebyshev", False), ("cg_merged", "none", True),
               ("pcg_merged", "chebyshev", True))
STATIONARY_AT_P2 = ("jacobi", "gauss_seidel_rb")
#: a mesh sums each dot as rank partials in rank order, the single process
#: as one ``torch.dot``: the BiCGStabs' stopping iteration follows that order
#: at these sizes (the P = 2 mesh's bicgstab stopped at 46, its single solve
#: at 48), so they are held as ``ORDER_SENSITIVE`` is: within 10 % + 1, the
#: true residual below ``tol``
MESH_ORDER_SENSITIVE = ORDER_SENSITIVE + ("bicgstab", "bicgstab_b1")
#: the four kernels of rows 1–4 as the profiler names them, and the three of
#: them that take their operand padded or unpadded (``ops`` wrapper names)
ROW_KERNELS = {"stencil_spmv": "SpmvTail<double, 0>", "stencil_spmv_dots": "SpmvTail<double, 2>",
               "fused_cg_body": "fused_cg_body_kernel", "stencil_spmv_dots3": "Dots3Tail<double>"}
PADDED_FORMS = {"spmv": "stencil_spmv", "spmv_dots": "stencil_spmv_dots",
                "spmv_dots3": "stencil_spmv_dots3"}


class _PaddedLaunches:
    """Count the calls of ``ops.spmv``/``spmv_dots``/``spmv_dots3`` by
    operand form (``zero_halo``) inside the block; on a mesh every operand
    is padded with its neighbours' halos."""

    def __enter__(self):
        self.counts = {f"{row}/{form}": 0 for row in PADDED_FORMS.values()
                       for form in ("padded", "unpadded")}
        self.real = {name: getattr(ops, name) for name in PADDED_FORMS}

        def wrap(name, fn):
            def counted_call(*args, zero_halo=False, **kw):
                form = "unpadded" if zero_halo else "padded"
                self.counts[f"{PADDED_FORMS[name]}/{form}"] += 1
                return fn(*args, zero_halo=zero_halo, **kw)
            return counted_call

        for name, fn in self.real.items():
            setattr(ops, name, wrap(name, fn))
        return self.counts

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(ops, name, fn)


class _HaloClock:
    """A mesh comm that times each halo swap on the host from its start
    (the card drained first, so the interval is the swap's own) to the end
    of its ``wait``; every other call passes through."""

    def __init__(self, inner):
        self.inner, self.seconds, self.swaps = inner, 0.0, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def exchange(self, sends, recvs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = self.inner.exchange(sends, recvs)
        clock = self

        class Timed:
            def wait(self):
                pending.wait()
                torch.cuda.synchronize()
                clock.seconds += time.perf_counter() - t0
                clock.swaps += 1

        return Timed()


def mesh_session(mesh, grid, method, precond, kernels, **opts) -> SolverSession:
    """A 27pt f64 session on ``mesh``, or (``mesh=None``) the single-process
    solve of the same grid on this rank's card."""
    if mesh is None:
        opts["layout"] = "local"
    return SolverSession(method=method, grid=grid, stencil="27pt", mesh=mesh,
                         options=SolverOptions(kernels=kernels, precond=precond, **opts))


def step_collectives(mesh, grid, method, precond, kernels) -> dict:
    """The collectives and halo swaps of one ``solve_step_shardmap`` step of
    the route, counted by the mesh's recording comm."""
    from repro_torch.api.backend import resolve_matvec, resolve_precond
    from repro_torch.core.distributed import DistributedOp, make_layout, solve_step_shardmap
    from repro_torch.kernels.kernel_op import KernelOp
    prob = make_problem(grid, "27pt")
    layout = make_layout(mesh)
    b = layout.block(prob.b(), grid)
    opts = SolverOptions(kernels=kernels, precond=precond)
    pre = resolve_precond(opts)
    fused = kernels and get_method(method).has_fused_body
    mv = None if fused else resolve_matvec(prob.stencil, opts)
    op = DistributedOp(prob.stencil, layout, matvec_padded=mv)
    if fused:
        op = KernelOp(op)
    mdef = get_method(method)
    state = (mdef.fused_init if fused else mdef.init)(
        Ops(op, b, M=pre.bind(op) if pre else None, norm_ref=1.0), torch.zeros_like(b))
    fn, _ = solve_step_shardmap(prob, method, mesh, precond=pre, kernels_fused=fused,
                                matvec_padded=mv)
    with mesh.record() as rec:
        fn(b, *state)
    return dict(rec.counts)


def warm_ms(sess, rounds: int) -> tuple[float, int]:
    """Median warm wall ms/iter of ``rounds`` eager solves (every rank in
    step: a barrier before each) and the iterations."""
    walls = []
    for _ in range(rounds):
        sess.mesh.comm.barrier()
        res, wall = timed(sess._solve_eager)
        walls.append(wall / res.iters * 1e3)
    return statistics.median(walls), res.iters


def busy_share(sess, warm: float) -> float:
    """Rank 0's device ms/iter in one profiled solve over its warm wall
    ms/iter (the other ranks' kernels on the card are not in it)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = sess._solve_eager()
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    return us / res.iters / 1e3 / warm


def halo_share(sess) -> dict:
    """The halo swaps' share of one solve's wall: each swap timed with the
    card drained before it (``_HaloClock``), over the wall of that solve."""
    clock = _HaloClock(sess.mesh.comm)
    sess.mesh.comm = clock
    try:
        sess.mesh.comm.barrier()
        res, wall = timed(sess._solve_eager)
    finally:
        sess.mesh.comm = clock.inner
    return dict(halo_share=clock.seconds / wall, swaps_per_iter=clock.swaps / res.iters,
                halo_ms_per_iter=clock.seconds / res.iters * 1e3)


def no_mesh_ms(grid, method: str) -> float:
    """Median eager wall ms/iter of three plain solves of ``method`` with no
    mesh, after a warm one."""
    sess = mesh_session(None, grid, method, "none", False)
    sess._solve_eager()
    walls = []
    for _ in range(3):
        res, wall = timed(sess._solve_eager)
        walls.append(wall / res.iters * 1e3)
    return statistics.median(walls)


def mesh_cases(world: int, backend: str, block, group=None) -> dict:
    """Everything one rank of a mesh run of ``world`` ranks does (see
    ``phase_distributed``) on ``group`` (None: the default group); rank 0's
    record is the run's, and rank 0 prints its progress."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((world,), ("cells",), group=group)
    rank, t_start = mesh.rank, time.perf_counter()
    tag = f"mesh {backend} P={world}"

    def say(msg: str) -> None:
        if rank == 0:
            print(f"[mesh] {tag} +{time.perf_counter() - t_start:.1f}s {msg}", flush=True)

    grid = (block[0], block[1], block[2] * world)
    routes = NCCL_ROUTES if backend == "nccl" else tuple(
        r for r in GLOO_ROUTES if world == 2 or r[0] not in STATIONARY_AT_P2)
    sessions = {r: mesh_session(mesh, grid, *r) for r in routes}
    xs, runs = {}, []
    ops.reset_launches()                          # the mesh window starts here
    with _PaddedLaunches() as forms:
        for route, sess in sessions.items():
            mesh.comm.barrier()
            res, wall = timed(sess._solve_eager)
            xs[route] = sess.gather(res.x)
            runs.append(dict(method=route[0], precond=route[1], kernels=route[2],
                             iters=res.iters, status=int(res.status),
                             res_norm=float(res.res_norm),
                             cold_ms_per_iter=wall / res.iters * 1e3))
            say(f"{route}: {res.iters} iterations, {wall:.2f}s")
    launches = dict(ops.LAUNCHES)                 # ...and ends here
    out = dict(world=world, backend=backend, grid=list(grid), launches=launches,
               forms=forms, staged=dict(mesh.comm.staged), runs=runs)
    if rank == 0:                                 # the single-process solves
        prob = make_problem(grid, "27pt")
        for run, (route, x) in zip(runs, xs.items()):
            one = mesh_session(None, grid, *route)._solve_eager()
            true = torch.linalg.vector_norm(prob.b() - prob.stencil.matvec(x))
            run.update(single_iters=one.iters, single_status=int(one.status),
                       max_dx=float((x - one.x).abs().max()), bitwise=bits_equal(x, one.x),
                       err=float((x - 1).abs().max()), true_res=float(true))
            say(f"{route}: the single-process solve {one.iters} iterations, max|dx| "
                f"{run['max_dx']:.3e}, bitwise {run['bitwise']}, true residual {true:.3e}")
            del one
        del prob
    del xs
    mesh.comm.barrier()
    for run, route in zip(runs, routes):          # the collectives a step
        run["step"] = step_collectives(mesh, grid, *route)
    if backend == "nccl":                         # rows 1-4 as the profiler names them
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for route in (("cg_merged", "none", True), ("cg_pipe", "none", True),
                          ("pcg_pipe", "chebyshev", True)):
                sessions[route]._solve_eager()
            torch.cuda.synchronize()
        out["kernel_names"] = sorted({e.key for e in prof.key_averages()
                                      if str(e.device_type).endswith("CUDA")})
        say("profiled the kernels of rows 1-4")
        # the same cg without a mesh: what the mesh layer costs on one rank
        out["no_mesh_cg_ms_per_iter"] = no_mesh_ms(grid, "cg")
        say(f"cg without a mesh: {out['no_mesh_cg_ms_per_iter']:.4f} ms/iter")
        # the pad on one rank: three concatenations against one zero pad
        from repro_torch.core.distributed import DistributedOp, make_layout
        x = torch.randn(grid, dtype=torch.float64, device="cuda")
        timer = Timer()
        out["pad_ms"] = {hm: timer.ms(lambda hm=hm: DistributedOp(
            STENCILS["27pt"], make_layout(mesh), halo_mode=hm).pad_exchange(x))
            for hm in ("concat", "scatter")}
        out["pad_ms"]["pad1"] = timer.ms(lambda: pad1(x))
        del x, timer
        say(f"the pad (ms, L2 flushed): {out['pad_ms']}")
    del sessions
    # the halo modes bitwise under cg, and cg's walls under concat and overlap
    # (their rounds interleaved, so both see the same card and host)
    halo, modes = {}, {}
    for hm in ("scatter", "concat", "overlap"):
        modes[hm] = mesh_session(mesh, grid, "cg", "none", False, halo_mode=hm)
        res = modes[hm]._solve_eager()
        x = modes[hm].gather(res.x)
        halo[hm] = dict(iters=res.iters, **({"x_bits": x} if rank == 0 else {}))
    walls = {"concat": [], "overlap": []}
    for _ in range(3):
        for hm in walls:
            walls[hm].append(warm_ms(modes[hm], 1)[0])
    for hm, w in walls.items():
        halo[hm].update(ms_per_iter=statistics.median(w), rounds=w, **halo_share(modes[hm]))
        say(f"cg {hm}: {halo[hm]['ms_per_iter']:.4f} ms/iter (median of 3), halo share "
            f"{halo[hm]['halo_share']:.3f} ({halo[hm]['halo_ms_per_iter']:.4f} ms/iter)")
    halo["concat"]["busy_share"] = busy_share(modes["concat"], halo["concat"]["ms_per_iter"])
    say(f"cg concat: rank 0's busy share {halo['concat']['busy_share']:.3f}")
    del modes
    if rank == 0:
        want = halo["concat"].pop("x_bits")
        for hm in ("scatter", "overlap"):
            halo[hm]["bitwise_concat"] = bits_equal(halo[hm].pop("x_bits"), want)
    out["halo_modes"] = halo
    if world == 4:                                # the 2d mesh (2, 2), once
        mesh2 = Mesh((2, 2), ("data", "model"))
        grid2 = (2 * block[0], 2 * block[1], block[2])
        sess = mesh_session(mesh2, grid2, "cg", "none", False)
        res = sess._solve_eager()
        x = sess.gather(res.x)
        rec = dict(grid=list(grid2), iters=res.iters, status=int(res.status),
                   backend=sess.backend.describe())
        if rank == 0:
            one = mesh_session(None, grid2, "cg", "none", False)._solve_eager()
            rec.update(single_iters=one.iters, max_dx=float((x - one.x).abs().max()))
        out["mesh_2d"] = rec
        say("the 2d mesh done")
        dist.barrier()
    out["describe"] = mesh_session(mesh, grid, "cg", "none", False).backend.describe()
    out["run_s"] = time.perf_counter() - t_start
    return out


#: the methods of the cost attribution on each mesh run (halo mode concat;
#: cg also under overlap)
ATTRIB_METHODS = ("cg", "cg_merged", "cg_pipe", "bicgstab", "bicgstab_b1")


def mesh_attribution(world: int, backend: str, block, group, trace_path: str) -> dict:
    """The cost attribution (``obs.attribution``) of ``ATTRIB_METHODS``
    under ``concat`` and of cg under ``overlap`` on this run's mesh, rank 0
    tracing into ``trace_path``; on NCCL P = 1 (one process on the card)
    rank 0 also measures the same rows on the one-rank mesh with no group
    and each method's no-mesh eager ms/iter (median of three solves)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.obs import attribution, trace
    mesh = Mesh((world,), ("cells",), group=group)
    grid = (block[0], block[1], block[2] * world)
    t0 = time.perf_counter()
    if mesh.rank == 0:
        trace.enable(trace_path)
    try:
        rows = attribution.attribution_report(ATTRIB_METHODS, grid, mesh, device="cuda")
        rows += attribution.attribution_report(("cg",), grid, mesh, halo_mode="overlap",
                                               device="cuda")
    finally:
        trace.disable()
    out = dict(rows=rows)
    if mesh.rank == 0:
        out.update(trace_errors=trace.validate_stream(trace_path),
                   trace_rows=attribution.rows_from_trace(trace.read_trace(trace_path)))
    if backend == "nccl":
        out["one_rank"] = attribution.attribution_report(ATTRIB_METHODS, tuple(block),
                                                         Mesh.one_rank(), device="cuda")
        out["no_mesh_ms_per_iter"] = {m: no_mesh_ms(tuple(block), m) for m in ATTRIB_METHODS}
    out["attrib_s"] = time.perf_counter() - t0
    return out


def check_attribution(rec: dict) -> None:
    """A mesh run's attribution: every row's phases sum to ``t_iter``, its
    counts are the registry's, ``t_halo > 0`` at P > 1, the trace is valid
    and holds the rows; each table printed."""
    from repro_torch.api import REGISTRY
    from repro_torch.obs.attribution import format_table
    tag = f"mesh {rec['backend']} P={rec['world']}"
    att = rec["attribution"]
    check(att["trace_errors"] == [], f"{tag} attribution: trace {att['trace_errors'][:3]}")
    check(att["trace_rows"] == att["rows"], f"{tag} attribution: the trace's rows differ")
    for row in att["rows"] + att.get("one_rank", []):
        m, spec = row["measured"], REGISTRY[row["method"]]
        what = f"{tag} attribution {row['method']} {row['halo_mode']} on {row['mesh']}"
        check(abs(m["t_halo"] + m["t_reduce"] + m["t_compute"] - m["t_iter"]) <= 1e-12,
              f"{what}: the phases do not sum to t_iter: {m}")
        check(row["counts"] == {"halo_exchanges": spec.halo_exchanges_per_iter,
                                "allreduces": spec.allreduces_per_iter},
              f"{what}: counts {row['counts']}, not the registry's")
        check(row["mesh"]["devices"] == 1 or m["t_halo"] > 0, f"{what}: t_halo {m['t_halo']}")
    print(f"[attribution] {tag}, global grid {att['rows'][0]['grid']}, 27pt f64 (us/iter; "
          f"the slowest rank):")
    for line in format_table(att["rows"]).splitlines():
        print(f"[attribution] {line}")
    if "one_rank" in att:
        print(f"[attribution] the one-rank mesh with no group, {att['one_rank'][0]['grid']}:")
        for line in format_table(att["one_rank"]).splitlines():
            print(f"[attribution] {line}")
        print(f"[attribution] no-mesh eager ms/iter: {att['no_mesh_ms_per_iter']}")
    print(f"[attribution] {tag}: the attribution took {att['attrib_s']:.2f}s")


def mesh_rank(rank: int, world: int, backend: str, out_dir: str, block) -> None:
    """One spawned rank of the mesh runs: joins the group (``file://``
    rendezvous, the group's own timeout) and runs ``mesh_cases``, then
    ``mesh_attribution``; under gloo
    first on the subgroup of ranks 0 and 1 (P = 2, the other ranks waiting)
    and then on all four (P = 4), so the card's four contexts start once.
    Rank 0 writes each run's record."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT))
    try:
        runs = {world: None}
        if backend == "gloo":
            runs = {2: dist.new_group([0, 1]), world: None}
        for p, group in runs.items():
            if rank < p:
                rec = mesh_cases(p, backend, block, group)
                rec["attribution"] = mesh_attribution(p, backend, block, group,
                                                      f"{out_dir}/attribution{p}.jsonl")
                if rank == 0:
                    Path(out_dir, f"record{p}.json").write_text(json.dumps(rec))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple, timeout: float) -> None:
    """``fn(rank, *args)`` on ``world`` spawned processes; a rank's failure
    raises (the others are ended), and so does the deadline, after every
    rank is killed."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise SmokeFailure(f"{fn.__name__}: {world} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def spawn_mesh(world: int, backend: str, block=RANK_BLOCK) -> dict:
    """The records of one spawn of ``world`` ranks (``mesh_rank``), by run
    size, and the spawn's wall time."""
    out_dir = MESH_SCRATCH / f"{backend}{world}"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    spawn_ranks(mesh_rank, world, (world, backend, str(out_dir), list(block)), MESH_TIMEOUT)
    recs = {int(p.stem[len("record"):]): json.loads(p.read_text())
            for p in out_dir.glob("record*.json")}
    return recs, time.perf_counter() - t0


def gloo_probe_rank(rank: int, out_dir: str) -> None:
    """Rank 0 sends a CUDA tensor to rank 1 over gloo's point-to-point path,
    with no staging; each rank writes what happened."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=30))
    t = torch.full((4,), float(rank + 1), device="cuda")
    try:
        (dist.send if rank == 0 else dist.recv)(t, 1 - rank)
        outcome = f"ok: {t.tolist()}"
    except Exception as e:                        # the finding, either way
        outcome = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    Path(out_dir, f"probe{rank}.txt").write_text(outcome)
    dist.destroy_process_group()


def probe_gloo_cuda_p2p() -> str:
    """Whether gloo's send/recv take CUDA tensors in this torch: a 2-rank
    probe whose failure (an exception, a crash, the deadline) is the
    finding and ends nothing else."""
    out_dir = MESH_SCRATCH / "probe"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    try:
        spawn_ranks(gloo_probe_rank, 2, (str(out_dir),), 60)
        status = "exited 0"
    except Exception as e:                        # noqa: BLE001 — recorded
        status = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    found = [(out_dir / f"probe{r}.txt") for r in (0, 1)]
    return "; ".join([status] + [f"rank {r}: {p.read_text()}" if p.exists()
                                 else f"rank {r}: no record" for r, p in enumerate(found)])


def check_mesh_run(rec: dict) -> None:
    """A mesh run's checks: every route converged on its single-process
    solve's iterations and status, max |Δx| < 1e-9, the kernels=True routes
    on their kernels=False iterations, the halo modes bitwise, the
    collectives a step the registry's; NCCL never stages."""
    from repro_torch.api import REGISTRY
    tag = f"mesh {rec['backend']} P={rec['world']}"
    plain = {(r["method"], r["precond"]): r["iters"] for r in rec["runs"] if not r["kernels"]}
    for r in rec["runs"]:
        what = f"{tag} {r['method']} precond={r['precond']} kernels={r['kernels']}"
        check(r["status"] == 0 and r["single_status"] == 0, f"{what}: status {r['status']}")
        if r["method"] in MESH_ORDER_SENSITIVE:
            check(abs(r["iters"] - r["single_iters"]) <= math.ceil(0.1 * r["single_iters"]) + 1,
                  f"{what}: {r['iters']} iterations, the single-process solve "
                  f"{r['single_iters']}, beyond 10 % + 1")
            check(r["true_res"] < 1e-6, f"{what}: true residual {r['true_res']}")
        else:
            check(r["iters"] == r["single_iters"],
                  f"{what}: {r['iters']} iterations, the single-process solve "
                  f"{r['single_iters']}")
            check(r["max_dx"] < 1e-9, f"{what}: max |dx| {r['max_dx']} against the single solve")
        if r["kernels"] and (r["method"], r["precond"]) in plain:
            check(r["iters"] == plain[(r["method"], r["precond"])],
                  f"{what}: not the mesh's kernels=False iterations")
        spec = REGISTRY[r["method"]]
        check(r["step"]["all_gather"] == spec.allreduces_per_iter,
              f"{what}: {r['step']['all_gather']} collectives a step, the registry "
              f"{spec.allreduces_per_iter}")
        print(f"[mesh] {tag} {r['method']} precond={r['precond']} kernels={r['kernels']}: "
              f"iters={r['iters']} (single {r['single_iters']}) max|dx|={r['max_dx']:.3e} "
              f"bitwise={r['bitwise']} true res {r['true_res']:.3e}; the counted (first) "
              f"solve {r['cold_ms_per_iter']:.4f} ms/iter; step {r['step']}")
    for hm, h in rec["halo_modes"].items():
        check(h["iters"] == rec["halo_modes"]["concat"]["iters"], f"{tag} cg {hm}: iterations")
        if hm != "concat":
            check(h["bitwise_concat"], f"{tag} cg: halo_mode {hm} not bitwise concat's x")
        if "ms_per_iter" in h:
            print(f"[mesh] {tag} cg halo_mode={hm}: {h['ms_per_iter']:.4f} ms/iter (median of "
                  f"3), halo share {h['halo_share']:.3f} ({h['halo_ms_per_iter']:.4f} "
                  f"ms/iter, {h['swaps_per_iter']:.1f} swaps/iter), busy share "
                  f"{h.get('busy_share')}")
    if rec["backend"] == "nccl":
        check(rec["staged"]["calls"] == 0, f"{tag}: NCCL staged {rec['staged']}")
    if "mesh_2d" in rec:
        m2 = rec["mesh_2d"]
        check(m2["status"] == 0 and m2["iters"] == m2["single_iters"] and m2["max_dx"] < 1e-9,
              f"{tag}: the 2d mesh {m2}")
        print(f"[mesh] {tag} {m2['backend']} cg at {m2['grid']}: iters={m2['iters']} "
              f"(single {m2['single_iters']}) max|dx|={m2['max_dx']:.3e}")
    print(f"[mesh] {tag}: {rec['describe']}, staged {rec['staged']}, launches "
          f"{ {k: v for k, v in rec['launches'].items() if v} }, operand forms "
          f"{ {k: v for k, v in rec['forms'].items() if v} }, {rec['run_s']:.2f}s")


def phase_distributed(probe: bool = False) -> dict:
    """The ``distributed`` phase: (a) NCCL, one rank, a real group; (b)
    gloo, 2 and 4 ranks sharing the card, 128³ a rank; each a spawned run
    whose failure fails the script.  ``probe`` (``--only-distributed``)
    adds :func:`probe_gloo_cuda_p2p`, which the phase's time leaves out of
    the whole run."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nccl, nccl_s = spawn_mesh(1, "nccl")
    gloo, gloo_s = spawn_mesh(4, "gloo")
    out = {"nccl_1": nccl[1], "gloo_2": gloo[2], "gloo_4": gloo[4],
           "spawn_s": {"nccl": nccl_s, "gloo": gloo_s}}
    for run in ("nccl_1", "gloo_2", "gloo_4"):
        check_mesh_run(out[run])
        check_attribution(out[run])
    a = out["nccl_1"]
    print(f"[mesh] mesh nccl P=1: the pad at 128^3 f64 (ms, L2 flushed; bound 0.0103): "
          f"{a['pad_ms']}")
    for row, frag in ROW_KERNELS.items():
        check(any(frag in k for k in a["kernel_names"]),
              f"mesh nccl P=1: {row} ({frag}) not among the profiled kernels")
    for row in PADDED_FORMS.values():
        check(a["forms"][f"{row}/padded"] > 0 and a["forms"][f"{row}/unpadded"] == 0,
              f"mesh nccl P=1: {row} not launched in its padded form only: {a['forms']}")
    if probe:
        out["gloo_cuda_p2p"] = probe_gloo_cuda_p2p()
        print(f"[mesh] gloo send/recv of a CUDA tensor, unstaged: {out['gloo_cuda_p2p']}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[mesh] the phase took {out['phase_s']:.2f}s")
    return out


# ---------------------------------------------------------------- audit

AUDIT_SCRATCH = ROOT / "build" / "audit"
#: the hard limit of one spawned audit run (s)
AUDIT_TIMEOUT = 180
#: the methods timed non-blocking against fork-join, at a fixed count of
#: iterations (tol 0), rounds interleaved between the two comms
AUDIT_TIMED = ("cg", "cg_nb", "cg_pipe", "bicgstab_b1")
AUDIT_ITERS = 20
AUDIT_ROUNDS = 5
#: the SpMV kernel as the profiler names it (row 1, padded operand)
AUDIT_SPMV = "SpmvTail<double, 0>"
#: the kernels the fused steps of the audit launch on every run
AUDIT_KERNELS = ("stencil_spmv", "stencil_spmv_dots", "fused_cg_body", "stencil_spmv_dots3",
                 "fused_pcg_body", "fused_pipe_body", "fused_dots", "fused_ppipe_body",
                 "bicgstab_fused_spmv_dots", "bicgstab_fused_update1",
                 "bicgstab_fused_spmv_update")


class ForkJoinComm:
    """Test double: the mesh's comm with every ``all_gather_start`` waited
    at once, so each reduction is a barrier (the fork-join form, the
    yardstick of the non-blocking one); every other call passes through."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def all_gather_start(self, t):
        handle = self.inner.all_gather_start(t)
        handle.wait()
        return handle


def audit_steps(mesh, grid) -> dict:
    """One step of every method on both routes under the recording comm and
    the op log: this rank's ``analysis.audit.measure_job`` records, keyed as
    the CPU audit's jobs with the mesh named ``P<ranks>``."""
    from repro_torch.analysis import audit
    from repro_torch.api import REGISTRY
    prob = make_problem(grid, "27pt")
    jobs = {}
    for name in sorted(REGISTRY):
        for kern in (False, True) if REGISTRY[name].has_fused_body else (False,):
            key = f"{name}|P{mesh.size}|auto|{'kernels' if kern else 'xla'}|none"
            jobs[key] = audit.measure_job(prob, mesh, dict(method=name, halo="auto",
                                                            kernels=kern, precond="none"))
    return jobs


def audit_timings(mesh, grid) -> dict:
    """Eager ms/iter of ``AUDIT_TIMED`` on the non-blocking comm and through
    :class:`ForkJoinComm`, their rounds interleaved (the same card and host
    for both), and whether the two solves are bitwise alike."""
    inner, out = mesh.comm, {}
    for m in AUDIT_TIMED:
        sess = mesh_session(mesh, grid, m, "none", False, tol=0.0, maxiter=AUDIT_ITERS)
        sess._solve_eager()                       # warm
        walls, last = {"nonblocking": [], "fork_join": []}, {}
        for _ in range(AUDIT_ROUNDS):
            for mode in walls:
                mesh.comm = ForkJoinComm(inner) if mode == "fork_join" else inner
                try:
                    mesh.comm.barrier()
                    res, wall = timed(sess._solve_eager)
                finally:
                    mesh.comm = inner
                walls[mode].append(wall / res.iters * 1e3)
                last[mode] = res
        out[m] = dict(iters=res.iters, rounds=walls,
                      bitwise=same_solve(last["nonblocking"], last["fork_join"]),
                      **{mode: statistics.median(w) for mode, w in walls.items()})
        del sess, last
    return out


def audit_profile(mesh, grid) -> dict:
    """One profiled step of pipelined PCG on the fused route (its reduction
    triple started, then the SpMV, then the wait): the NCCL kernels' and
    the SpMV kernel's intervals on the card and whether they overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.distributed import solve_step_shardmap, step_state_layout
    prob = make_problem(grid, "27pt")
    fn, layout = solve_step_shardmap(prob, "pcg_pipe", mesh, kernels_fused=True,
                                     run=autotune.DEFAULT_RUN)
    vecs, scals = step_state_layout("pcg_pipe")
    b = layout.block(prob.b(), grid)
    one = torch.ones((), dtype=prob.dtype, device=prob.device)
    args = (b, *[b] * len(vecs), *[one] * len(scals))
    fn(*args)                                     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def span(es):
        return [min(e.time_range.start for e in es), max(e.time_range.end for e in es)] \
            if es else None

    nccl = span([e for e in evs if "nccl" in e.name.lower()])
    spmv = span([e for e in evs if AUDIT_SPMV in e.name])
    t0 = min((e.time_range.start for e in evs), default=0.0)
    return dict(nccl_us=nccl, spmv_us=spmv,
                overlap=None if nccl is None or spmv is None
                else bool(nccl[0] < spmv[1] and spmv[0] < nccl[1]),
                events=[[e.name[:60], round(e.time_range.start - t0, 3),
                         round(e.time_range.end - t0, 3)] for e in evs])


def audit_cases(world: int, backend: str, group=None) -> dict:
    """One rank's audit run on the ``cells`` mesh of ``world`` ranks, 128³ a
    rank: the steps (their own counted window), then the timings (P > 1) or
    the profile (P = 1)."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((world,), ("cells",), group=group)
    grid = (RANK_BLOCK[0], RANK_BLOCK[1], RANK_BLOCK[2] * world)
    t0 = time.perf_counter()
    ops.reset_launches()                          # the audit window starts here
    jobs = audit_steps(mesh, grid)
    launches = dict(ops.LAUNCHES)                 # ...and ends here
    out = dict(world=world, backend=backend, rank=mesh.rank, jobs=jobs, launches=launches,
               steps_s=time.perf_counter() - t0)
    if world > 1:
        out["timings"] = audit_timings(mesh, grid)
    else:
        out["profile"] = audit_profile(mesh, grid)
    out["run_s"] = time.perf_counter() - t0
    return out


def audit_rank(rank: int, world: int, backend: str, out_dir: str) -> None:
    """One spawned rank of the audit: as ``mesh_rank``, P = 2 on the
    subgroup of ranks 0 and 1 first under gloo; every rank writes its
    record of each run."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT))
    try:
        runs = {world: None}
        if backend == "gloo":
            runs = {2: dist.new_group([0, 1]), world: None}
        for p, group in runs.items():
            if rank < p:
                rec = audit_cases(p, backend, group)
                Path(out_dir, f"record{p}_rank{rank}.json").write_text(json.dumps(rec))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def check_audit_run(tag: str, recs: list) -> dict:
    """A run's checks: every rank's steps merged and held to the registry
    as the CPU audit holds them (counts, no other collective, each
    reduction's window class on the unfused route), every fused kernel
    launched, the timed solves bitwise alike on both comms.  Returns the
    run's summary (hard barriers and windows in units of V a method)."""
    from repro_torch.analysis import audit
    p = recs[0]["world"]
    measured = audit.merge_ranks([dict(jobs=r["jobs"], donate_mesh={}, local={},
                                       guard_invariance={}) for r in recs])
    found = audit.compare(measured, split_dims={f"P{p}": 1 if p > 1 else 0})
    check(not found, f"audit {tag}: {format_violations(found)}")
    for k in AUDIT_KERNELS:
        check(recs[0]["launches"][k] > 0, f"audit {tag}: {k} was not launched")
    summary = {}
    for key, win in measured["windows"].items():
        method, _, _, route, _ = key.split("|")
        V = win["vector_bytes"]
        summary[f"{method}|{route}"] = dict(
            counts=measured["comms"][key]["counts"],
            hard=sum(1 for lo, hi in win["reductions"] if hi < V / 8),
            windows_V=[round(lo / V, 3) for lo, _ in win["reductions"]])
    print(f"[audit] {tag}: " + "; ".join(
        f"{k} {v['counts']} hard {v['hard']} windows/V {v['windows_V']}"
        for k, v in summary.items()))
    for m, t in recs[0].get("timings", {}).items():
        check(t["bitwise"], f"audit {tag} {m}: the fork-join solve is not bitwise the "
                            f"non-blocking one")
        print(f"[audit] {tag} {m}: non-blocking {t['nonblocking']:.4f} ms/iter, fork-join "
              f"{t['fork_join']:.4f} (median of {AUDIT_ROUNDS}, {t['iters']} iterations)")
    if "profile" in recs[0]:
        print(f"[audit] {tag} pcg_pipe fused step: {recs[0]['profile']}")
    return summary


def phase_audit() -> dict:
    """The ``audit`` phase: one step of every method on both routes on
    NCCL P = 1 and gloo P = 2, 4 ranks sharing the card, 128³ a rank, 27pt
    f64, held to the registry's counts and window classes; the
    non-blocking comm against the fork-join double on four methods; one
    profiled NCCL step.  A run's failure fails the script."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {}
    for world, backend, runs in ((1, "nccl", (1,)), (4, "gloo", (2, 4))):
        out_dir = AUDIT_SCRATCH / f"{backend}{world}"
        shutil.rmtree(out_dir, ignore_errors=True)
        out_dir.mkdir(parents=True)
        spawn_ranks(audit_rank, world, (world, backend, str(out_dir)), AUDIT_TIMEOUT)
        for p in runs:
            recs = [json.loads(Path(out_dir, f"record{p}_rank{r}.json").read_text())
                    for r in range(p)]
            tag = f"{backend} P={p}"
            out[f"{backend}_{p}"] = dict(summary=check_audit_run(tag, recs),
                                         launches=recs[0]["launches"],
                                         timings=recs[0].get("timings"),
                                         profile=recs[0].get("profile"),
                                         steps_s=recs[0]["steps_s"], run_s=recs[0]["run_s"])
    out["phase_s"] = time.perf_counter() - t0
    print(f"[audit] the phase took {out['phase_s']:.2f}s")
    return out


# ---------------------------------------------------------------- mesh_batched

MB_SCRATCH = ROOT / "build" / "mesh_batched"
#: the hard limit of one spawned run of the phase (s)
MB_TIMEOUT = 240
#: (a) NCCL P = 1: the batched routes on the kernels (rows 1b, 16b, 17b)
MB_ROUTES = (("cg", "none"), ("pcg", "chebyshev"), ("pcg", "block_jacobi"),
             ("bicgstab", "none"))
#: (b) gloo P = 2 and 4: the batched routes on the kernels, and the methods
#: whose batched step's collectives are held to the single step's
MB_GLOO_ROUTES = (("cg", "none"), ("pcg", "chebyshev"))
MB_STEP_METHODS = ("cg", "cg_nb", "bicgstab")
#: (c) the served stream: the cg 27pt bucket on the global grid of four
#: 128³ blocks, rank 3 lost at dispatch 0 (P = 4 -> 2: 512 is not a
#: multiple of 3), then a P = 4 journal recovered cold onto P = 2
MB_SERVE_GRID = (RANK_BLOCK[0], RANK_BLOCK[1], 4 * RANK_BLOCK[2])
MB_SERVE_REQUESTS = 10
MB_COLD_REQUESTS = 4


def mb_requests(n: int, seed: int) -> list:
    """``n`` cg 27pt f64 requests of the served grid, seeded normal lanes
    made on the host (every rank makes the same), tol 1e-8 absolute."""
    from repro_torch.serve import Request
    gen = torch.Generator().manual_seed(seed)
    return [Request(b=torch.randn(MB_SERVE_GRID, generator=gen, dtype=torch.float64).numpy(),
                    method="cg", stencil="27pt", tol=1e-8, maxiter=500) for _ in range(n)]


class _Died(RuntimeError):
    """A dispatch that dies with its journal entry on disk (not a
    ``SimulatedFailure``: the service does not catch it)."""


class _DieAt(FailureInjector):
    def maybe_fail(self, step):
        if step == self.fail_at_step and not self.fired:
            self.fired = True
            raise _Died(f"the service died at dispatch {step}")


def mb_lane_checks(sess, bs, res, local=None) -> dict:
    """Each lane of ``res`` bitwise the mesh's single solve of it (the
    session's unfused eager loop, its wall per iteration recorded: the
    median over the lanes that iterate) and, given ``local``, the single
    process's batched solve's lane."""
    singles = [timed(lambda i=i: sess._solve_unfused(bs[i])) for i in range(bs.shape[0])]
    out = dict(single=[same_solve(lane(res, i), one) for i, (one, _) in enumerate(singles)],
               single_ms_per_iter=statistics.median(
                   wall / one.iters * 1e3 for one, wall in singles if one.iters))
    if local is not None:
        loc = local._solve_batched_eager(bs)
        out["local"] = [same_solve(lane(res, i), lane(loc, i)) for i in range(bs.shape[0])]
    return out


def mb_batched_routes(mesh, grid, routes, say, local: bool) -> tuple[list, dict]:
    """Each route's batched solve (B = 4: A·1, two seeded lanes, a zero
    lane) of the global lanes on ``mesh`` with ``kernels=True``, eager, in
    one counted window, its lane-batched launches exact and their operands
    padded; then each lane's checks (:func:`mb_lane_checks`)."""
    runs, solves = [], []
    ops.reset_launches()                          # the window starts here
    with _PaddedLaunches() as forms:
        for m, p in routes:
            sess = mesh_session(mesh, grid, m, p, True)
            bs = batch_lanes(sess.problem, BATCH)
            (res, wall), launches = counted(lambda: timed(lambda: sess._solve_batched_eager(bs)))
            iters = res.iters.tolist()
            want = expected_batched_launches(m, max(iters), p)
            runs.append(dict(method=m, precond=p, iters=iters, status=res.status.tolist(),
                             cold_wall_s=wall, launches={k: v for k, v in launches.items() if v},
                             launches_ok=launches == want))
            solves.append((sess, bs, res))
            say(f"batched {m}+{p}: iters {iters}, {wall:.2f}s, launches {runs[-1]['launches']}")
    window = dict(ops.LAUNCHES)                   # ...and ends here
    for run, (sess, bs, res) in zip(runs, solves):
        sess.mesh.comm.barrier()
        _, wall = timed(lambda: sess._solve_batched_eager(bs))
        run["warm_ms_per_step"] = wall / max(run["iters"]) * 1e3
        run.update(mb_lane_checks(sess, bs, res, mesh_session(None, grid, run["method"],
                                                              run["precond"], True)
                                  if local else None))
    return runs, dict(launches=window, forms=dict(forms))


def mb_graphed(mesh, grid, say) -> dict:
    """NCCL P = 1: the ``distributed`` phase's eight routes and the four
    batched ones through the executable cache (their gathers captured),
    each bitwise its eager solve, and warm ms/iter both ways."""
    out = {"single": [], "batched": []}
    for m, p, kern in NCCL_ROUTES:
        sess = mesh_session(mesh, grid, m, p, kern)
        eager = sess._solve_eager()
        _, e_wall = timed(sess._solve_eager)
        graphed = sess.solve()                    # the miss: builds and captures
        again, g_wall = timed(sess.solve)
        out["single"].append(dict(method=m, precond=p, kernels=kern, iters=eager.iters,
                                  bitwise=same_solve(graphed, eager) and same_solve(again, eager),
                                  eager_ms_per_iter=e_wall / eager.iters * 1e3,
                                  graphed_ms_per_iter=g_wall / eager.iters * 1e3,
                                  capture_mode=sess._executables[grid].capture_mode))
        say(f"graphed {m}+{p} kernels={kern}: {out['single'][-1]}")
        del sess
    for m, p in MB_ROUTES:
        sess = mesh_session(mesh, grid, m, p, True)
        bs = batch_lanes(sess.problem, BATCH)
        eager = sess._solve_batched_eager(bs)
        _, e_wall = timed(lambda: sess._solve_batched_eager(bs))
        compile_s = sess.compile_batched(BATCH)
        first = sess.solve_batched(bs)            # the graphs' first replay uploads them
        got, g_wall = timed(lambda: sess.solve_batched(bs))
        steps = int(eager.iters.max())
        out["batched"].append(dict(
            method=m, precond=p, steps=steps, compile_batched_s=compile_s,
            bitwise=all(same_solve(lane(r, i), lane(eager, i))
                        for r in (first, got) for i in range(BATCH)),
            eager_ms_per_step=e_wall / steps * 1e3, graphed_ms_per_step=g_wall / steps * 1e3))
        say(f"graphed batched {m}+{p}: {out['batched'][-1]}")
        del sess
    return out


def mb_served(mesh4, two, say) -> dict:
    """(c) on the 4 gloo ranks: the served stream with rank 3 lost at
    dispatch 0, then a P = 4 journal recovered cold on ``two`` (ranks 0 and
    1; None elsewhere).  Rank 0 holds each served ``x`` to the single
    process's solve of its request."""
    import torch.distributed as dist
    from repro_torch.serve import SolverService as Service
    rank = mesh4.rank
    cfg = dict(max_batch=BATCH, kernels=True, guards=True, device="cuda")
    wal = MB_SCRATCH / "wal_loss"
    inj = ChaosInjector(ChaosPlan(seed=0, device_loss_at=(0,), lose_devices=(3,)))
    svc = Service(ServeConfig(mesh=mesh4, recovery_dir=str(wal), **cfg), injector=inj)
    reqs = mb_requests(MB_SERVE_REQUESTS, 31)
    rids = [svc.submit(r) for r in reqs]
    t0 = time.perf_counter()
    svc.run_until_drained()
    stream_s = time.perf_counter() - t0
    svc.close()
    snap = svc.snapshot()
    res = svc.results()
    out = dict(stream_s=stream_s, served=len(res), rids=len(rids),
               converged=sum(r.status == "converged" for r in res.values()),
               rejects=snap["service_rejects"], device_losses=snap["device_losses"],
               mesh_after=None if svc.mesh is None else svc.mesh.size,
               loss=[e["attrs"] for e in svc.metrics.events()
                     if e["name"] == "serve.device_loss"],
               dispatches=[dict(lanes=d["lanes"], iters=d["iters"], solve_s=d["solve_s"])
                           for d in svc.dispatch_log],
               journal_left=sorted(os.listdir(wal)) if wal.exists() else [])
    say(f"served: {out['served']}/{len(rids)} in {stream_s:.2f}s, mesh after {out['mesh_after']}")
    if rank == 0:                                 # the single-process solves
        one = mesh_session(None, MB_SERVE_GRID, "cg", "none", True, tol=1e-8, maxiter=500)
        st = STENCILS["27pt"]
        dx, iters_eq, true = 0.0, True, 0.0
        for rid, r in zip(rids, reqs):
            b = torch.as_tensor(r.b, device=one.device)
            want = one._solve_unfused(b)
            x = torch.as_tensor(res[rid].x, device=one.device)
            dx = max(dx, float((x - want.x).abs().max()))
            iters_eq &= res[rid].iters == want.iters
            true = max(true, float(torch.linalg.vector_norm(b - st.matvec(x))))
        out.update(max_dx=dx, iters_equal=bool(iters_eq), true_res=true)
        say(f"served against the single process: max|dx| {dx:.3e}, iters equal {iters_eq}, "
            f"true residual {true:.3e}")
    del svc, res
    dist.barrier()
    # a service on 4 ranks dies at its first dispatch; 2 ranks recover it
    cold_wal = MB_SCRATCH / "wal_cold"
    dying = Service(ServeConfig(mesh=mesh4, recovery_dir=str(cold_wal), **cfg),
                    injector=_DieAt(fail_at_step=0))
    for r in mb_requests(MB_COLD_REQUESTS, 37):
        dying.submit(r)
    try:
        dying.run_until_drained()
        died = False
    except _Died:
        died = True
    dying.close()
    del dying
    dist.barrier()
    out["cold"] = dict(died=died, orphaned=len([f for f in os.listdir(cold_wal)
                                                if f.startswith("wal_")]))
    if two is not None:
        fresh = Service(ServeConfig(mesh=two, recovery_dir=str(cold_wal), **cfg))
        t0 = time.perf_counter()
        remap = fresh.recover()
        got = fresh.run_until_drained()
        fresh.close()
        out["cold"].update(recovered=len(remap), served=len(got),
                           recover_s=time.perf_counter() - t0,
                           converged=sum(r.status == "converged" for r in got.values()),
                           requeues=min((r.requeues for r in got.values()), default=0),
                           journal_left=sorted(os.listdir(cold_wal)))
        say(f"cold recovery on 2: {out['cold']}")
    dist.barrier()
    return out


def mb_rank(rank: int, world: int, backend: str, out_dir: str) -> None:
    """One spawned rank of the ``mesh_batched`` phase: (a) under NCCL (one
    rank), (b) and (c) under gloo (four ranks: P = 2 on the subgroup of
    ranks 0 and 1, then P = 4, then the served stream); rank 0 writes the
    record."""
    import datetime
    import torch.distributed as dist
    from repro_torch.analysis import audit
    from repro_torch.launch.mesh import Mesh
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT))
    t_start = time.perf_counter()

    def say(msg: str) -> None:
        if rank == 0:
            print(f"[mesh_batched] {backend} +{time.perf_counter() - t_start:.1f}s {msg}",
                  flush=True)

    try:
        rec = {}
        if backend == "nccl":
            mesh = Mesh((1,), ("cells",))
            rec["batched"], rec["window"] = mb_batched_routes(mesh, RANK_BLOCK, MB_ROUTES, say,
                                                              local=True)
            rec["graphed"] = mb_graphed(mesh, RANK_BLOCK, say)
        else:
            two_group = dist.new_group([0, 1])
            two = Mesh((2,), ("cells",), group=two_group) if rank < 2 else None
            for p, mesh in ((2, two), (4, Mesh((4,), ("cells",)))):
                if mesh is not None:
                    grid = (RANK_BLOCK[0], RANK_BLOCK[1], RANK_BLOCK[2] * p)
                    runs, window = mb_batched_routes(mesh, grid, MB_GLOO_ROUTES, say,
                                                     local=False)
                    prob = make_problem(grid, "27pt")
                    steps = {m: audit.compare_batched(
                        m, audit.measure_batched_step(prob, mesh, m, BATCH))
                        for m in MB_STEP_METHODS}
                    rec[f"gloo_{p}"] = dict(batched=runs, window=window,
                                            steps={m: [str(v) for v in f]
                                                   for m, f in steps.items()})
                    del prob
                dist.barrier()
            rec["served"] = mb_served(Mesh((4,), ("cells",)), two, say)
        rec["run_s"] = time.perf_counter() - t_start
        if rank == 0:
            Path(out_dir, "record.json").write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def check_mb_batched(tag: str, runs: list, window: dict) -> None:
    """Every lane converged (a zero lane at iteration 0) and bitwise its
    single mesh solve (and the single process's batched lane, where run),
    the launches exact, every SpMV on a padded operand."""
    for r in runs:
        what = f"mesh_batched {tag} {r['method']}+{r['precond']}"
        check(all(s == 0 for s in r["status"]) and r["iters"][-1] == 0,
              f"{what}: statuses {r['status']} iters {r['iters']}")
        check(r["launches_ok"], f"{what}: launches {r['launches']} not the expected")
        check(all(r["single"]), f"{what}: lanes not bitwise their single mesh solves "
                                f"{r['single']}")
        check(all(r.get("local", [True])), f"{what}: lanes not bitwise the single "
                                           f"process's batched lanes {r.get('local')}")
    forms = window["forms"]
    check(forms["stencil_spmv/unpadded"] == 0
          and forms["stencil_spmv/padded"] == window["launches"]["stencil_spmv_batched"],
          f"mesh_batched {tag}: the SpMVs' operand forms {forms}")


def phase_mesh_batched() -> dict:
    """The ``mesh_batched`` phase (see the module's docstring): (a) NCCL P
    = 1, (b) gloo P = 2 and 4 and (c) the served stream on gloo P = 4 → 2,
    each a spawned run whose failure fails the script."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shutil.rmtree(MB_SCRATCH, ignore_errors=True)
    out = {}
    for world, backend in ((1, "nccl"), (4, "gloo")):
        out_dir = MB_SCRATCH / f"{backend}{world}"
        out_dir.mkdir(parents=True)
        spawn_ranks(mb_rank, world, (world, backend, str(out_dir)), MB_TIMEOUT)
        out[backend] = json.loads((out_dir / "record.json").read_text())
    a = out["nccl"]
    check_mb_batched("nccl P=1", a["batched"], a["window"])
    for r in a["graphed"]["single"] + a["graphed"]["batched"]:
        check(r["bitwise"], f"mesh_batched nccl P=1 graphed {r}: not bitwise eager")
        print(f"[mesh_batched] nccl P=1 graphed {r}")
    check(all(r["capture_mode"] == "thread_local" for r in a["graphed"]["single"]),
          "mesh_batched nccl P=1: not captured thread-local")
    b = out["gloo"]
    for p in (2, 4):
        g = b[f"gloo_{p}"]
        check_mb_batched(f"gloo P={p}", g["batched"], g["window"])
        for m, found in g["steps"].items():
            check(not found, f"mesh_batched gloo P={p} {m}: a batched step's collectives "
                             f"{found}")
        print(f"[mesh_batched] gloo P={p}: {g['batched']}; batched steps' collectives the "
              f"single step's ({', '.join(g['steps'])})")
    s = b["served"]
    check(s["served"] == MB_SERVE_REQUESTS == s["converged"] and s["rejects"] == 0
          and s["device_losses"] == 1 and s["mesh_after"] == 2
          and s["loss"] == [{"lost": 1, "survivors": 2}] and not s["journal_left"],
          f"mesh_batched served stream: {s}")
    check(s["iters_equal"] and s["max_dx"] < 1e-9 and s["true_res"] < 1e-7,
          f"mesh_batched served stream against the single process: {s}")
    c = s["cold"]
    check(c["died"] and c["orphaned"] == 1 and c["recovered"] == MB_COLD_REQUESTS
          == c["served"] == c["converged"] and c["requeues"] >= 1 and not c["journal_left"],
          f"mesh_batched cold recovery: {c}")
    print(f"[mesh_batched] served on gloo P=4->2: {s['served']}/{MB_SERVE_REQUESTS} converged, "
          f"{s['rejects']} rejects, losses {s['loss']}, {s['stream_s']:.2f}s, dispatches "
          f"{s['dispatches']}; cold recovery of a P=4 journal on P=2: {c}")
    out["launches"] = {k: a["window"]["launches"][k] + sum(b[f"gloo_{p}"]["window"]["launches"][k]
                                                        for p in (2, 4))
                       for k in ops.LAUNCHES}
    out["phase_s"] = time.perf_counter() - t0
    print(f"[mesh_batched] the phase took {out['phase_s']:.2f}s")
    return out


LM_ARCH = "internlm2-1.8b"
#: internlm2-1.8b's full width and depth (src/repro_torch/configs/internlm2_1_8b.py)
LM_WIDTHS = dict(n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, hd=128, d_ff=8192,
                 vocab_size=92544)
LM_SERVE = dict(batch=4, prompt_len=64, gen=32)      # (a), (e)
LM_LONG = dict(batch=1, prompt_len=4096, gen=8)      # (c): the prefill takes _chunked_sdpa
LM_CUT_LAYERS = 2                                    # (d)
#: (b) forward against prefill + decode (the reference test's rtol = atol)
LM_DECODE_TOL = 2e-3
#: (c) _chunked_sdpa against _sdpa (the reference test's rtol = atol)
LM_CHUNKED_TOL = 2e-5
#: (d) card against CPU, max |Δ| over max |CPU logit|: both f32, TF32 off, so
#: only the summation order differs
LM_CPU_TOL = 1e-4
#: (h) bf16 decode against the full forward, max |Δ| over max |logit|: four
#: bf16 epsilons (2⁻⁷).  ``LM_DECODE_TOL`` cannot hold in bf16: the logits
#: themselves are bf16, whose unit in the last place is 2⁻⁵ between 4 and 8,
#: and the M = 4 and M = 260 products round apart (PERF.md §6)
LM_DECODE_TOL_BF16 = 2.0 ** -5


#: (f) qwen3-moe-235b-a22b's full widths (src/repro_torch/configs/qwen3_moe_235b_a22b.py),
#: its depth cut to 4 layers: 11,195,678,720 parameters, 44.78 GB in f32
MOE_QWEN3 = "qwen3-moe-235b-a22b"
MOE_QWEN3_WIDTHS = dict(d_model=4096, n_heads=64, n_kv_heads=4, hd=128, qk_norm=True,
                        n_experts=128, d_ff=1536, top_k=8, vocab_size=151936)
MOE_QWEN3_LAYERS = 4
MOE_QWEN3_SERVE = dict(batch=4, prompt_len=64, gen=32)
#: (g) one full-width qwen3 MoE layer alone, (B, S): 4 tokens take the gather
#: path (T·k = 32 ≤ 64), 256 the dispatch path (C = 24)
MOE_LAYER_TOKENS = ((4, 1), (4, 64))
#: (h) llama4-maverick-400b-a17b's full widths
#: (src/repro_torch/configs/llama4_maverick_400b_a17b.py), its depth cut to one
#: dense + MoE superlayer: 18,679,091,200 parameters, 37.36 GB in bf16
MOE_LLAMA4 = "llama4-maverick-400b-a17b"
MOE_LLAMA4_WIDTHS = dict(d_model=5120, n_heads=40, n_kv_heads=8, hd=128, n_experts=128,
                         d_ff=8192, top_k=1, shared_expert=True, moe_every=2,
                         dense_ff=16384, vocab_size=202048)
MOE_LLAMA4_LAYERS = 2
MOE_LLAMA4_SERVE = dict(batch=4, prompt_len=64, gen=8)
#: (i) mamba2-780m at full width and depth (src/repro_torch/configs/mamba2_780m.py):
#: 48 SSD layers, no attention, no MLP, 48 SSD heads of 64, state 128, chunk 128
SSM_MAMBA2 = "mamba2-780m"
SSM_MAMBA2_WIDTHS = dict(n_layers=48, d_model=1536, n_heads=0, d_ff=0, d_inner=3072,
                         ssm_heads=48, ssm_head_dim=64, ssm_state=128, ssm_chunk=128,
                         conv_kernel=4, vocab_size=50280, tie_embeddings=True)
#: (j) hymba-1.5b at full width and depth (src/repro_torch/configs/hymba_1_5b.py):
#: 32 layers of sliding-window attention (25 heads of 64 over 5 KV heads,
#: window 2048) and an SSD block (50 heads of 64, state 16) side by side, d_ff 5504
SSM_HYMBA = "hymba-1.5b"
SSM_HYMBA_WIDTHS = dict(n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, hd=64,
                        d_ff=5504, d_inner=3200, ssm_heads=50, ssm_head_dim=64,
                        ssm_state=16, sliding_window=2048, vocab_size=32001)
#: (i), (j): the reference serve demo's defaults
SSM_SERVE = dict(batch=4, prompt_len=64, gen=32)
#: (k) one SSD layer alone, B = 1: (S, the chunk it runs) — 32 chunks of 128,
#: and 320 tokens, whose chunk falls back to 80
SSM_LAYER_TOKENS = ((4096, 128), (320, 80))
#: (l) the subquadratic configs' cell and, at B = 1 too, the 32k decode cell
SSM_LONG = (("long_500k", None), ("decode_32k", (32_768, 1)))
#: (m) seamless-m4t-large-v2 at full width and depth
#: (src/repro_torch/configs/seamless_m4t_large_v2.py): 24 bidirectional encoder layers over
#: the audio stub's frames and 24 decoder layers with cross-attention, d_model 1024, 16
#: heads of 64 (MHA), d_ff 8192 GeGLU, vocab 256206, untied
ENC_DEC_ARCH = "seamless-m4t-large-v2"
ENC_DEC_WIDTHS = dict(n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
                      hd=64, d_ff=8192, act="gelu", vocab_size=256206, tie_embeddings=False)
#: param_count() (2,034,782,208) and the two final norms it leaves out
ENC_DEC_PARAMS = 2_034_784_256
ENC_DEC_SERVE = dict(batch=4, prompt_len=64, gen=32)   # (m1), (m5); 16 source frames
ENC_DEC_LONG = dict(batch=1, prompt_len=4096, gen=8)   # (m3); 1024 source frames
ENC_DEC_CUT_LAYERS = 2                                 # (m4), encoder and decoder each


def lm_serve_run(tag: str, dtype: str, device: str, runs: int = 2, arch: str = LM_ARCH,
                 serve: dict = LM_SERVE) -> dict:
    """(a)/(e)/(m1)/(m5): ``launch/serve.py --mode lm`` (``serve.main``, the
    function the CLI calls) at ``arch``'s full width (internlm2-1.8b's by
    default), ``runs`` times: the first cold (cuBLAS handles, PyTorch's
    kernels loaded), then warm.  Each run's logits finite, its ids inside
    the vocabulary, its peak memory."""
    out = []
    vocab = get_config(arch).vocab_size
    for i in range(runs):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = lm_serve.main(["--mode", "lm", "--arch", arch, "--dtype", dtype, "--seed", "0",
                           "--device", device,
                           "--batch", str(serve["batch"]),
                           "--prompt-len", str(serve["prompt_len"]),
                           "--gen", str(serve["gen"])])
        toks = r["tokens"]
        check(r["finite"], f"lm {tag}: a logit is not finite")
        check(toks.shape == (serve["batch"], serve["gen"] + 1)
              and int(toks.min()) >= 0 and int(toks.max()) < vocab,
              f"lm {tag}: ids {tuple(toks.shape)} outside [0, {vocab})")
        out.append(dict(run="cold" if i == 0 else "warm", prefill_s=r["prefill_s"],
                        decode_s=r["decode_s"], tokens_per_s=r["tokens_per_s"],
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                        tokens=toks.cpu()))
        print(f"[lm] ({tag}) {dtype} {out[-1]['run']}: prefill {r['prefill_s']:.4f}s, decode "
              f"{r['decode_s']:.4f}s = {r['tokens_per_s']:.1f} tok/s, peak "
              f"{out[-1]['peak_gb']:.2f} GB")
    same = all(torch.equal(o["tokens"], out[0]["tokens"]) for o in out)
    for o in out:
        o["tokens"] = o["tokens"][0, :16].tolist()
    return dict(runs=out, same_tokens=same)


def lm_decode_profile(ctx, model, tok, pos: int, caches, steps: int = 4,
                      cross_kvs=None) -> dict:
    """Warm decode steps at B = 4: the host-clock ms of a step (the card
    drained), then the same number of steps under ``torch.profiler``: kernels
    launched and device ms a step, the busy share (device over wall) and the
    five kernels with the most device time.  An enc-dec model's steps also
    read ``cross_kvs``."""
    from torch.profiler import ProfilerActivity, profile
    dstep = lm_steps.make_decode_step(ctx)
    cross = () if cross_kvs is None else (cross_kvs,)
    for i in range(steps):                       # warm
        dstep(model, tok, pos + i, caches, *cross)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        dstep(model, tok, pos + steps + i, caches, *cross)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            dstep(model, tok, pos + 2 * steps + i, caches, *cross)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_ms = {e.key: float(getattr(e, "self_device_time_total", 0.0)) / 1e3 / steps
              for e in kernels}
    device_ms = sum(dev_ms.values())
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy=device_ms / wall_ms,
                launches=sum(e.count for e in kernels) / steps,
                top=sorted(dev_ms.items(), key=lambda kv: -kv[1])[:5])


def moe_recorder(calls: list):
    """A stand-in for ``models.moe.moe_forward`` that appends each call's
    tokens, path and dropped-assignment mask (T, k) to ``calls`` (the masks
    are read after the run, so the recording adds no host sync)."""
    run = lm_moe.moe_forward

    def recorded(p, cfg, x, *, stats=None, par=None):
        st = {} if stats is None else stats
        out = run(p, cfg, x, stats=st, par=par)
        calls.append((x.shape[0] * x.shape[1], st["path"], st["dropped"]))
        return out

    return recorded


def moe_serve_check(tag: str, arch: str, widths: dict, n_layers: int, dtype, serve: dict,
                    dev) -> tuple[dict, Transformer]:
    """(f)/(h): ``arch`` at its full widths, its depth cut to ``n_layers``,
    weights from ``torch.Generator("cuda").manual_seed(0)`` in ``dtype``:
    ``launch.serve.lm_generate`` twice (cold, then warm; the same tokens),
    every logit finite, every id inside the vocabulary, each prefill MoE
    layer on the dispatch path (its drops printed) and each decode one on
    the gather path with no drop; a second prefill bitwise the first; the
    full forward over P + 1 tokens against prefill P + one decode step
    within ``LM_DECODE_TOL`` in f32 (within ``LM_DECODE_TOL_BF16`` of the
    largest logit in bf16), both at the no-drop capacity (``capacity_factor
    = E / k``: C ≥ T), since a decode step never drops; then warm decode
    steps profiled (``lm_decode_profile``).  Returns the record and the
    model."""
    t0 = time.perf_counter()
    full = get_config(arch)
    check({k: getattr(full, k) for k in widths} == widths, f"{arch}: not the full widths {widths}")
    cfg = dataclasses.replace(full, n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    print(f"[lm] ({tag}) {arch} at full width, {n_layers} layers "
          f"({', '.join(layer_kinds(cfg))}): {n_params} parameters, {gb:.2f} GB "
          f"{str(dtype).split('.')[-1]}, drawn in {init_s:.2f}s")
    ctx = model.ctx
    B, P, gen = serve["batch"], serve["prompt_len"], serve["gen"]
    V = cfg.vocab_size
    prompt = torch.randint(0, V, (B, P + 1), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    pos = torch.arange(P + 1, device=dev).expand(B, P + 1)
    batch = {"tokens": prompt[:, :P], "positions": pos[:, :P]}
    n_moe = layer_kinds(cfg).count("moe")
    calls, run = [], lm_moe.moe_forward
    lm_moe.moe_forward = moe_recorder(calls)
    rec = dict(arch=arch, layers=n_layers, dtype=str(dtype), parameters=n_params, gb=gb,
               init_s=init_s, runs=[])
    try:
        toks = None
        for i in range(2):
            calls.clear()
            r = lm_serve.lm_generate(ctx, model, batch, gen)
            pre = [(path, int(d.sum())) for T, path, d in calls if T == B * P]
            dec = [(path, int(d.sum())) for T, path, d in calls if T == B]
            check(r["finite"], f"lm ({tag}): a logit is not finite")
            check(r["tokens"].shape == (B, gen + 1) and int(r["tokens"].min()) >= 0
                  and int(r["tokens"].max()) < V, f"lm ({tag}): ids outside [0, {V})")
            check(len(pre) == n_moe and all(path == "dispatch" for path, _ in pre),
                  f"lm ({tag}): prefill MoE calls {[path for path, _ in pre]}")
            check(len(dec) == n_moe * gen and all(p == "gather" and n == 0 for p, n in dec),
                  f"lm ({tag}): decode MoE calls {dec[:4]}...")
            check(toks is None or torch.equal(toks, r["tokens"]),
                  f"lm ({tag}): the warm run's tokens differ from the cold run's")
            toks = r["tokens"]
            rec["runs"].append(dict(run="cold" if i == 0 else "warm", prefill_s=r["prefill_s"],
                                    decode_s=r["decode_s"], tokens_per_s=r["tokens_per_s"],
                                    prefill_drops=[n for _, n in pre]))
            print(f"[lm] ({tag}) B={B} prompt {P} gen {gen}, {rec['runs'][-1]['run']}: prefill "
                  f"{r['prefill_s']:.4f}s (drops of each MoE layer, C = "
                  f"{lm_moe.capacity(B * P, cfg)}: {[n for _, n in pre]}), decode "
                  f"{r['decode_s']:.4f}s = {r['tokens_per_s']:.1f} tok/s")
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["tokens"] = toks[0, :16].tolist()
        del toks
        with torch.inference_mode():
            # a second prefill repeats the first bit for bit
            prefill = lm_steps.make_prefill(ctx)
            l1, kv1 = prefill(model, batch)
            l2, kv2 = prefill(model, batch)
            same = torch.equal(l1, l2) and all(torch.equal(a, b) for x, y in zip(kv1, kv2)
                                               for a, b in zip(x, y))
            check(same, f"lm ({tag}): a second prefill differs from the first")
            del l1, l2, kv1, kv2
            # decode against the full forward, at the no-drop capacity
            nd = dataclasses.replace(ctx, cfg=dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k))
            calls.clear()
            full_l, _ = forward(nd, model, {"tokens": prompt, "positions": pos})
            _, kvs = lm_steps.make_prefill(nd)(model, batch)
            caches = caches_from_prefill(nd, kvs, P + 16)
            step, _ = lm_steps.make_decode_step(nd)(model, prompt[:, P:], P, caches)
            check(all(int(d.sum()) == 0 for _, _, d in calls),
                  f"lm ({tag}): an assignment was dropped at the no-drop capacity")
            want, got = full_l[:, -1].double(), step[:, 0].double()
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            if dtype == torch.float32:
                ok = torch.allclose(got, want, rtol=LM_DECODE_TOL, atol=LM_DECODE_TOL)
                rule = f"rtol = atol = {LM_DECODE_TOL}"
            else:
                ok = err <= LM_DECODE_TOL_BF16 * scale
                rule = f"{LM_DECODE_TOL_BF16} of the largest in bf16"
            rec.update(decode_max_abs_err=err, max_abs_logit=scale)
            print(f"[lm] ({tag}) forward over {P + 1} tokens against prefill {P} + one decode "
                  f"step, capacity_factor {nd.cfg.capacity_factor:g}: max |Δ| {err:.3e} of "
                  f"max |logit| {scale:.3e} ({rule})")
            check(ok, f"lm ({tag}): decode against forward, max |Δ| {err:.3e}")
            calls.clear()
            prof = lm_decode_profile(nd, model, step[:, -1].argmax(dim=-1)[:, None], P + 1,
                                     caches)
            rec["decode_profile"] = prof
            print(f"[lm] ({tag}) a warm decode step at B = {B}: {prof['wall_ms']:.3f} ms wall, "
                  f"{prof['device_ms']:.3f} ms device (busy {prof['busy']:.3f}), "
                  f"{prof['launches']:.0f} kernels; most device time: "
                  + ", ".join(f"{k[:60]} {v:.3f}" for k, v in prof["top"]))
            del full_l, kvs, caches, step, want, got
    finally:
        lm_moe.moe_forward = run
    rec["s"] = time.perf_counter() - t0
    print(f"[lm] ({tag}) peak {rec['peak_gb']:.2f} GB; the part took {rec['s']:.2f}s")
    return rec, model


def moe_layer_card_vs_cpu(model: Transformer, dev) -> dict:
    """(g): layer 0's MoE of (f)'s model alone, f32, on the card against the
    same weights copied to the host, at ``MOE_LAYER_TOKENS``: the same path,
    max |Δ| ≤ ``LM_CPU_TOL`` of the largest CPU output, the same dropped
    assignments; the card's CUDA-event ms (L2 flushed) beside the weight
    bytes' time at the card's memory rate."""
    t0 = time.perf_counter()
    cfg, layer = model.cfg, model.layers[0].moe
    d, E, k, f = cfg.d_model, cfg.n_experts, cfg.top_k, cfg.d_ff
    on_cpu = lm_moe.MoE(cfg, dtype=torch.float32, device="meta")
    on_cpu.load_state_dict({n: t.cpu() for n, t in layer.state_dict().items()}, assign=True)
    host_gb = sum(t.numel() * t.element_size() for t in on_cpu.state_dict().values()) / 1e9
    mem_rate = card_peaks(torch.cuda.get_device_name(0))[0]
    timer, out = Timer(n=5), {"host_gb": host_gb, "cases": []}
    for B, S in MOE_LAYER_TOKENS:
        T = B * S
        path = "gather" if lm_moe.takes_gather_path(T, cfg) else "dispatch"
        x = torch.randn((B, S, d), device=dev, generator=torch.Generator(dev).manual_seed(3))
        card, host = {}, {}
        with torch.inference_mode():
            got, aux = lm_moe.moe_forward(layer, cfg, x, stats=card)
            t1 = time.perf_counter()
            want, aux_cpu = lm_moe.moe_forward(on_cpu, cfg, x.cpu(), stats=host)
            cpu_s = time.perf_counter() - t1
            ms = timer.ms(lambda: lm_moe.moe_forward(layer, cfg, x))
        err, scale = float((got.cpu() - want).abs().max()), float(want.abs().max())
        drops = int(host["dropped"].sum())
        same_drops = torch.equal(card["dropped"].cpu(), host["dropped"])
        # weight bytes the path reads: every expert's on dispatch, one slice
        # pair an assignment on gather
        per_expert = (d * 2 * f + f * d) * 4
        weight_bytes = E * per_expert if path == "dispatch" else T * k * per_expert
        row = dict(tokens=T, path=path, capacity=card["capacity"], drops=drops,
                   same_drops=same_drops, max_abs_err=err, max_abs_out=scale,
                   aux=float(aux), aux_cpu=float(aux_cpu), ms=ms, cpu_s=cpu_s,
                   weight_bytes_ms=weight_bytes / mem_rate * 1e3)
        out["cases"].append(row)
        print(f"[lm] (g) one MoE layer at T = {T} ({path}, C = {card['capacity']}, "
              f"{drops} dropped): card against CPU max |Δ| {err:.3e} of max |out| "
              f"{scale:.3e} (tol {LM_CPU_TOL} relative), drop sets equal {same_drops}; "
              f"card {ms:.3f} ms (its weight bytes at the memory rate "
              f"{row['weight_bytes_ms']:.3f} ms), CPU {cpu_s:.3f}s")
        check(card["path"] == host["path"] == path,
              f"lm (g): paths {card['path']} / {host['path']}, expected {path}")
        check(err <= LM_CPU_TOL * scale,
              f"lm (g): card against CPU, max |Δ| {err:.3e} > {LM_CPU_TOL} × {scale:.3e}")
        check(same_drops, "lm (g): the card and the CPU dropped different assignments")
        del x, got, want
    del on_cpu, timer
    out["s"] = time.perf_counter() - t0
    print(f"[lm] (g) {host_gb:.2f} GB of weights on the host; the part took {out['s']:.2f}s")
    return out


def _leaves(cache: dict):
    """A layer's cache tensors, an SSM layer's nested ``"ssm"`` dict's too."""
    for v in cache.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for c in caches for t in _leaves(c))


def replay_logits(ctx, model, seq) -> tuple[torch.Tensor, list]:
    """Every position of ``seq`` (B, S) through a decode step from
    ``init_caches`` (token i at position i): the logits of all S steps
    (B, S, V) and the caches after the last."""
    dstep = lm_steps.make_decode_step(ctx)
    caches = init_caches(ctx, seq.shape[0], seq.shape[1])
    out = []
    for i in range(seq.shape[1]):
        logits, caches = dstep(model, seq[:, i:i + 1], i, caches)
        out.append(logits)
    return torch.cat(out, dim=1), caches


def ssm_serve_check(tag: str, arch: str, widths: dict, dtype, dev) -> tuple[dict, Transformer]:
    """(i)/(j): ``arch`` at full width and depth, weights from
    ``torch.Generator("cuda").manual_seed(0)`` in ``dtype``:
    ``launch.serve.lm_generate`` once (the prompt replayed through decode
    steps), every logit finite and every id inside the vocabulary; then the
    96 tokens it fed (prompt and 32 generated) replayed again: its logits
    at the prompt's end bitwise the served prefill's, its argmaxes the
    served tokens, and all 96 positions against a full ``forward`` of the
    same tokens (the chunked scan against the recurrence): within
    ``LM_DECODE_TOL`` in f32, printed only in bf16, whose decode conv runs in
    f32 and forward conv in bf16 by the reference's design; then warm
    decode steps profiled (``lm_decode_profile``).  Each decode step is a
    few thousand launches from Python, so the part serves once, not cold
    and warm.  Returns the record and the model."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    check({k: getattr(cfg, k) for k in widths} == widths, f"{arch}: not the full widths {widths}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    dname = str(dtype).split(".")[-1]
    print(f"[lm] ({tag}) {arch} at full width, {cfg.n_layers} {layer_kinds(cfg)[0]} layers: "
          f"{n_params} parameters, {gb:.2f} GB {dname}, drawn in {init_s:.2f}s")
    ctx = model.ctx
    B, P, gen = SSM_SERVE["batch"], SSM_SERVE["prompt_len"], SSM_SERVE["gen"]
    V = cfg.vocab_size
    prompt = torch.randint(0, V, (B, P), device=dev, generator=torch.Generator(dev).manual_seed(1))
    pos = torch.arange(P, device=dev).expand(B, P)
    r = lm_serve.lm_generate(ctx, model, {"tokens": prompt, "positions": pos}, gen)
    toks = r["tokens"]
    check(r["finite"], f"lm ({tag}): a logit is not finite")
    check(toks.shape == (B, gen + 1) and int(toks.min()) >= 0 and int(toks.max()) < V,
          f"lm ({tag}): ids outside [0, {V})")
    rec = dict(arch=arch, layers=cfg.n_layers, dtype=str(dtype), parameters=n_params, gb=gb,
               init_s=init_s, prefill_s=r["prefill_s"], decode_s=r["decode_s"],
               tokens_per_s=r["tokens_per_s"], peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               tokens=toks[0, :16].tolist())
    print(f"[lm] ({tag}) {dname} B={B} prompt {P} (replayed) gen {gen}: prefill "
          f"{r['prefill_s']:.4f}s, decode {r['decode_s']:.4f}s = {r['tokens_per_s']:.1f} tok/s, "
          f"peak {rec['peak_gb']:.2f} GB")
    with torch.inference_mode():
        seq = torch.cat([prompt, toks[:, :gen]], dim=1)            # the 96 tokens fed
        l1, c1 = replay_logits(ctx, model, seq)
        check(torch.equal(l1[:, P - 1], r["prefill_logits"]),
              f"lm ({tag}): a second prefill differs from the first")
        check(torch.equal(l1[:, P - 1:].argmax(dim=-1), toks),
              f"lm ({tag}): the replay's argmaxes are not the served tokens")
        full, _ = forward(ctx, model, {"tokens": seq, "positions": torch.arange(
            P + gen, device=dev).expand(B, P + gen)})
        check(bool(torch.isfinite(full).all()), f"lm ({tag}): a forward logit is not finite")
        want, got = full.double(), l1.double()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        rec.update(decode_max_abs_err=err, max_abs_logit=scale,
                   chunk=lm_ssm.chunk_size(cfg, P + gen))
        gated = dtype == torch.float32
        print(f"[lm] ({tag}) a second replay: its prefill logits bitwise the first's, its "
              f"argmaxes the served tokens; its {P + gen} positions against a full forward "
              f"(chunk {rec['chunk']}): max |Δ| {err:.3e} of max |logit| {scale:.3e} "
              + (f"(rtol = atol = {LM_DECODE_TOL})" if gated else "(bf16: printed, not gated)"))
        if gated:
            check(torch.allclose(got, want, rtol=LM_DECODE_TOL, atol=LM_DECODE_TOL),
                  f"lm ({tag}): decode against forward, max |Δ| {err:.3e}")
        del full, want, got
        prof = lm_decode_profile(ctx, model, toks[:, -1:], P + gen, c1)
        rec["decode_profile"] = prof
        rec["cache_bytes"] = cache_bytes(c1)
        print(f"[lm] ({tag}) a warm decode step at B = {B}: {prof['wall_ms']:.3f} ms wall, "
              f"{prof['device_ms']:.3f} ms device (busy {prof['busy']:.3f}), "
              f"{prof['launches']:.0f} kernels; most device time: "
              + ", ".join(f"{k[:60]} {v:.3f}" for k, v in prof["top"]))
        del l1, c1
    rec["s"] = time.perf_counter() - t0
    print(f"[lm] ({tag}) the part took {rec['s']:.2f}s")
    return rec, model


def ssm_layer_card_vs_cpu(model: Transformer, dev) -> dict:
    """(k): layer 0's SSD block of (i)'s model alone, f32, on the card against
    the same weights copied to the host, B = 1, at ``SSM_LAYER_TOKENS`` with
    ``return_cache``: the output, the conv tail and the state within
    ``LM_CPU_TOL`` of the largest CPU value; at 4096 tokens the same tokens
    also replayed through ``ssm_decode`` on the card, its state and conv
    window against ``return_cache``'s; the card's CUDA-event ms (L2
    flushed) and the CPU's seconds."""
    t0 = time.perf_counter()
    cfg, block = model.cfg, model.layers[0].ssm
    on_cpu = lm_ssm.SSM(cfg, dtype=torch.float32, device="meta")
    on_cpu.load_state_dict({n: t.cpu() for n, t in block.state_dict().items()}, assign=True)
    host_mb = sum(t.numel() * t.element_size() for t in on_cpu.state_dict().values()) / 1e6
    timer, out = Timer(n=5), {"host_mb": host_mb, "cases": []}

    def rel(a, b):
        return float((a.cpu().double() - b.double()).abs().max()), float(b.abs().max())

    for S, Q in SSM_LAYER_TOKENS:
        check(lm_ssm.chunk_size(cfg, S) == Q, f"lm (k): S = {S} runs chunks of "
              f"{lm_ssm.chunk_size(cfg, S)}, not {Q}")
        x = torch.randn((1, S, cfg.d_model), device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
        with torch.inference_mode():
            got, cache = lm_ssm.ssm_forward(block, cfg, x, return_cache=True)
            t1 = time.perf_counter()
            want, cache_cpu = lm_ssm.ssm_forward(on_cpu, cfg, x.cpu(), return_cache=True)
            cpu_s = time.perf_counter() - t1
            ms = timer.ms(lambda: lm_ssm.ssm_forward(block, cfg, x, return_cache=True))
        row = dict(tokens=S, chunk=Q, chunks=S // Q, ms=ms, cpu_s=cpu_s)
        for name, a, b in (("out", got, want), ("conv", cache["conv"], cache_cpu["conv"]),
                           ("state", cache["state"], cache_cpu["state"])):
            err, scale = rel(a, b)
            row[f"{name}_max_abs_err"], row[f"{name}_max_abs"] = err, scale
            check(err <= LM_CPU_TOL * scale, f"lm (k): S = {S}, {name} card against CPU, "
                  f"max |Δ| {err:.3e} > {LM_CPU_TOL} × {scale:.3e}")
        if S == SSM_LAYER_TOKENS[0][0]:
            rc = lm_ssm.init_ssm_cache(cfg, 1, torch.float32, dev)
            t1 = time.perf_counter()
            with torch.inference_mode():
                for i in range(S):
                    lm_ssm.ssm_decode(block, cfg, x[:, i:i + 1], rc)
            torch.cuda.synchronize()
            row["replay_s"] = time.perf_counter() - t1
            for name in ("conv", "state"):
                err, scale = rel(rc[name], cache[name].cpu())
                row[f"replay_{name}_max_abs_err"] = err
                check(err <= LM_CPU_TOL * scale, f"lm (k): the replay's {name} against "
                      f"return_cache's, max |Δ| {err:.3e} > {LM_CPU_TOL} × {scale:.3e}")
        out["cases"].append(row)
        print(f"[lm] (k) one SSD layer, B = 1, S = {S} ({S // Q} chunks of {Q}): card against "
              f"CPU max |Δ| out {row['out_max_abs_err']:.3e} of {row['out_max_abs']:.3e}, "
              f"conv {row['conv_max_abs_err']:.3e}, state {row['state_max_abs_err']:.3e} of "
              f"{row['state_max_abs']:.3e} (tol {LM_CPU_TOL} relative); card {ms:.3f} ms, CPU "
              f"{cpu_s:.3f}s"
              + (f"; {S} steps of ssm_decode on the card in {row['replay_s']:.2f}s, state "
                 f"against return_cache's max |Δ| {row['replay_state_max_abs_err']:.3e}"
                 if "replay_s" in row else ""))
        del x, got, want, cache, cache_cpu
    del on_cpu, timer
    out["s"] = time.perf_counter() - t0
    print(f"[lm] (k) {host_mb:.1f} MB of weights on the host; the part took {out['s']:.2f}s")
    return out


def ssm_long_steps(tag: str, model: Transformer, dev) -> dict:
    """(l): one decode step of ``model`` (f32, B = 1) from
    ``steps.synthetic_batch`` of each ``SSM_LONG`` cell (long_500k at
    position 524,288; decode_32k at 32,768): every logit finite, a warm
    step's host-clock ms (the card drained), the caches' bytes."""
    t0 = time.perf_counter()
    cfg, ctx = model.cfg, model.ctx
    dstep = lm_steps.make_decode_step(ctx)
    out = {}
    for shape, override in SSM_LONG:
        b = lm_steps.synthetic_batch(cfg, shape, torch.Generator(dev).manual_seed(4),
                                     override=override, dtype=torch.float32, device=dev)
        pos, caches, tok = b["cur_pos"], b["caches"], b["tokens"]
        with torch.inference_mode():
            logits, caches = dstep(model, tok, pos, caches)
            finite = bool(torch.isfinite(logits).all())
            torch.cuda.synchronize()
            walls = []
            for i in range(1, 4):
                t1 = time.perf_counter()
                step, caches = dstep(model, tok, pos + i, caches)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
                finite &= bool(torch.isfinite(step).all())
        check(finite and logits.shape == (1, 1, cfg.vocab_size),
              f"lm (l) {tag}: {shape} step, finite {finite}, logits {tuple(logits.shape)}")
        out[shape] = dict(cur_pos=pos, step_ms=statistics.median(walls),
                          cache_bytes=cache_bytes(caches))
        print(f"[lm] (l) {tag} {shape}: a decode step at position {pos}, B = 1: "
              f"{out[shape]['step_ms']:.3f} ms wall, caches {out[shape]['cache_bytes']} bytes, "
              f"every logit finite")
        del b, caches, logits, step
    out["s"] = time.perf_counter() - t0
    return out


def encdec_batch(cfg, B: int, P: int, dev, seed: int) -> dict:
    """P + 1 prompt tokens, then max(P // SRC_FRACTION, 1) standard normal
    source frames (f32; the model casts them), from one seeded generator on
    ``dev``, at positions 0.. on both sides."""
    g = torch.Generator(dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, P + 1), device=dev, generator=g)
    T = max(P // lm_steps.SRC_FRACTION, 1)
    src = torch.randn((B, T, cfg.d_model), device=dev, generator=g)
    return {"tokens": toks, "positions": torch.arange(P + 1, device=dev).expand(B, P + 1),
            "src_embeds": src, "src_positions": torch.arange(T, device=dev).expand(B, T)}


def encdec_decode_against_forward(tag: str, model: Transformer, batch: dict, P: int) -> tuple:
    """The full ``forward`` over the P + 1 tokens of ``batch`` against a
    prefill of the first P and one ``decode_step`` reading its cross kvs, on
    the same source: f32 within ``LM_DECODE_TOL``, bf16 within
    ``LM_DECODE_TOL_BF16`` of the largest logit.  Returns the record, the
    step's logits, its caches and cross kvs."""
    ctx = model.ctx
    full, _ = forward(ctx, model, batch)
    head = dict(batch, tokens=batch["tokens"][:, :P], positions=batch["positions"][:, :P])
    _, kvs = lm_steps.make_prefill(ctx)(model, head)
    caches, cross = caches_from_prefill(ctx, kvs, P + 16)
    step, _ = lm_steps.make_decode_step(ctx)(model, batch["tokens"][:, P:], P, caches, cross)
    want, got = full[:, -1].double(), step[:, 0].double()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if ctx.dtype == torch.float32:
        ok, rule = (torch.allclose(got, want, rtol=LM_DECODE_TOL, atol=LM_DECODE_TOL),
                    f"rtol = atol = {LM_DECODE_TOL}")
    else:
        ok, rule = err <= LM_DECODE_TOL_BF16 * scale, f"{LM_DECODE_TOL_BF16} of the largest"
    print(f"[lm] ({tag}) forward over {P + 1} tokens and {batch['src_embeds'].shape[1]} frames "
          f"against prefill {P} + one decode step: max |Δ| {err:.3e} of max |logit| "
          f"{scale:.3e} ({rule})")
    check(ok, f"lm ({tag}): decode against forward, max |Δ| {err:.3e} of {scale:.3e}")
    return dict(max_abs_err=err, max_abs_logit=scale), step, caches, cross


def encdec_check(dev) -> dict:
    """(m): seamless-m4t-large-v2 at full width and depth, weights from
    ``torch.Generator("cuda").manual_seed(0)``: (m1) f32 serving through
    ``serve.main`` cold and warm, the same tokens; (m2) decode against the
    full forward, then profiled warm steps; (m3) B = 1, a 4096-token prompt
    over 1024 frames (``_chunked_sdpa`` on all 24 decoder layers, the
    encoder's bidirectional ``_sdpa`` over all 1024 frames on all 24 of
    its), gen 8; (m4) the same weights cut to 2 encoder and 2 decoder
    layers, prefill logits and cross kvs on the card against the CPU; (m5)
    (m1) once in bf16 and its decode against its forward."""
    t0 = time.perf_counter()
    cfg = get_config(ENC_DEC_ARCH)
    check({k: getattr(cfg, k) for k in ENC_DEC_WIDTHS} == ENC_DEC_WIDTHS and cfg.enc_dec,
          f"{ENC_DEC_ARCH}: not the full widths {ENC_DEC_WIDTHS}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec = {"m1": lm_serve_run("m1", "float32", str(dev), arch=ENC_DEC_ARCH, serve=ENC_DEC_SERVE)}
    check(rec["m1"]["same_tokens"], "lm (m1): the warm run's tokens differ from the cold run's")

    t1 = time.perf_counter()
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), torch.float32)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    print(f"[lm] (m) {ENC_DEC_ARCH} at full width and depth, {cfg.n_enc_layers} encoder and "
          f"{cfg.n_layers} decoder layers: {n_params} parameters, {gb:.2f} GB f32, drawn in "
          f"{time.perf_counter() - t1:.2f}s")
    check(n_params == ENC_DEC_PARAMS == cfg.param_count() + 2 * cfg.d_model,
          f"lm (m): {n_params} parameters, not {ENC_DEC_PARAMS}")
    rec.update(parameters=n_params, gb=gb)
    ctx = model.ctx
    B, P = ENC_DEC_SERVE["batch"], ENC_DEC_SERVE["prompt_len"]
    batch = encdec_batch(cfg, B, P, dev, 1)
    with torch.inference_mode():
        rec["m2"], step, caches, cross = encdec_decode_against_forward("m2", model, batch, P)
        prof = lm_decode_profile(ctx, model, step[:, -1].argmax(dim=-1)[:, None], P + 1, caches,
                                 cross_kvs=cross)
        rec["m2"]["decode_profile"] = prof
        print(f"[lm] (m2) a warm f32 decode step at B = {B}: {prof['wall_ms']:.3f} ms wall, "
              f"{prof['device_ms']:.3f} ms device (busy {prof['busy']:.3f}), "
              f"{prof['launches']:.0f} kernels; most device time: "
              + ", ".join(f"{k[:60]} {v:.3f}" for k, v in prof["top"]))
        del step, caches, cross

        # (m3) a 4096-token prompt over 1024 frames
        Bl, Pl, gen = ENC_DEC_LONG["batch"], ENC_DEC_LONG["prompt_len"], ENC_DEC_LONG["gen"]
        check(Pl > lm_attention.CHUNKED_ATTN_THRESHOLD, "lm (m3): the prompt is not chunked")
        long = encdec_batch(cfg, Bl, Pl, dev, 2)
        long = dict(long, tokens=long["tokens"][:, :Pl], positions=long["positions"][:, :Pl])
        chunked, enc_attn = lm_attention._chunked_sdpa, lm_transformer.encoder_attn
        taken, frames = [], []

        def counted_chunked(*a, **k):
            taken.append(1)
            return chunked(*a, **k)

        def counted_encoder(p, cfg_, x, positions):
            frames.append(x.shape[1])
            return enc_attn(p, cfg_, x, positions)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm_attention._chunked_sdpa, lm_transformer.encoder_attn = counted_chunked, counted_encoder
        try:
            r = lm_serve.lm_generate(ctx, model, long, gen)
        finally:
            lm_attention._chunked_sdpa, lm_transformer.encoder_attn = chunked, enc_attn
        peak = torch.cuda.max_memory_allocated() / 1e9
        T = Pl // lm_steps.SRC_FRACTION
        check(r["finite"] and len(taken) == cfg.n_layers
              and frames == [T] * cfg.n_enc_layers,
              f"lm (m3): finite {r['finite']}, _chunked_sdpa taken {len(taken)} times, "
              f"the encoder over {frames[:3]}... frames")
        check(int(r["tokens"].min()) >= 0 and int(r["tokens"].max()) < cfg.vocab_size,
              "lm (m3): an id outside the vocabulary")
        rec["m3"] = dict(prefill_s=r["prefill_s"], decode_s=r["decode_s"],
                         tokens_per_s=r["tokens_per_s"], peak_gb=peak, chunked_layers=len(taken),
                         encoder_layers=len(frames), frames=T)
        print(f"[lm] (m3) B={Bl} prompt {Pl} over {T} frames, gen {gen}: prefill "
              f"{r['prefill_s']:.4f}s (_chunked_sdpa on {len(taken)} decoder layers, the "
              f"encoder's bidirectional _sdpa on {len(frames)} layers), decode "
              f"{r['decode_s']:.4f}s = {r['tokens_per_s']:.1f} tok/s, peak {peak:.2f} GB; "
              f"every logit finite")
        del long, r

        # (m4) the same seeded weights cut to 2 + 2 layers: the card against the CPU
        cut = dataclasses.replace(cfg, n_layers=ENC_DEC_CUT_LAYERS,
                                  n_enc_layers=ENC_DEC_CUT_LAYERS)

        def kept(name: str) -> bool:
            for stack in ("layers.", "encoder.layers."):
                if name.startswith(stack):
                    return int(name[len(stack):].split(".")[0]) < ENC_DEC_CUT_LAYERS
            return True

        state = {n: t for n, t in model.state_dict().items() if kept(n)}
        del model, ctx
        torch.cuda.empty_cache()
        on_card = Transformer(cut, dtype=torch.float32, device=dev)
        on_card.load_state_dict(state)
        on_cpu = Transformer(cut, dtype=torch.float32, device="cpu")
        on_cpu.load_state_dict({n: t.cpu() for n, t in state.items()})
        del state
        head = dict(batch, tokens=batch["tokens"][:, :P], positions=batch["positions"][:, :P])
        got, (_, cross_got) = lm_steps.make_prefill(on_card.ctx)(on_card, head)
        want, (_, cross_want) = lm_steps.make_prefill(on_cpu.ctx)(
            on_cpu, {k: t.cpu() for k, t in head.items()})
        err, scale = float((got.cpu() - want).abs().max()), float(want.abs().max())
        kv_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                     for kg, kw in zip(cross_got, cross_want) for a, b in zip(kg, kw))
        check(err <= LM_CPU_TOL * scale and kv_err <= LM_CPU_TOL,
              f"lm (m4): card against CPU, logits max |Δ| {err:.3e} of {scale:.3e}, cross "
              f"kvs {kv_err:.3e} of their largest (tol {LM_CPU_TOL})")
        rec["m4"] = dict(layers=ENC_DEC_CUT_LAYERS, max_abs_err=err, max_abs_logit=scale,
                         cross_kv_rel_err=kv_err)
        print(f"[lm] (m4) {ENC_DEC_CUT_LAYERS} encoder + {ENC_DEC_CUT_LAYERS} decoder layers, "
              f"prefill on the card against the CPU: logits max |Δ| {err:.3e} of max |logit| "
              f"{scale:.3e}, cross kvs {kv_err:.3e} of their largest (tol {LM_CPU_TOL} "
              f"relative)")
        del on_card, on_cpu, got, want, cross_got, cross_want
    torch.cuda.empty_cache()

    # (m5) bf16: served once, then its decode against its forward
    rec["m5"] = lm_serve_run("m5", "bfloat16", str(dev), runs=1, arch=ENC_DEC_ARCH,
                             serve=ENC_DEC_SERVE)
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), torch.bfloat16)
    with torch.inference_mode():
        rec["m5"]["decode"], *_ = encdec_decode_against_forward("m5", model, batch, P)
    del model, batch
    torch.cuda.empty_cache()
    rec["s"] = time.perf_counter() - t0
    print(f"[lm] (m) took {rec['s']:.2f}s")
    return rec


def phase_lm(device: str = "cuda") -> dict:
    """The ``lm`` phase: internlm2-1.8b at full width and depth from
    ``torch.Generator("cuda").manual_seed(0)`` (see the module's docstring);
    each check's failure fails the script."""
    t0 = time.perf_counter()
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on for f32 matmuls")
    cfg = get_config(LM_ARCH)
    check({k: getattr(cfg, k) for k in LM_WIDTHS} == LM_WIDTHS,
          f"{LM_ARCH}: not the full widths {LM_WIDTHS}")
    dev = torch.device(device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec = {"a": lm_serve_run("a", "float32", device)}

    model = init_params(cfg, torch.Generator(dev).manual_seed(0), torch.float32)
    ctx = model.ctx
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[lm] {LM_ARCH}: {n_params} parameters, "
          f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB f32")
    B, S = LM_SERVE["batch"], LM_SERVE["prompt_len"]
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    pos = torch.arange(S + 1, device=dev).expand(B, S + 1)
    with torch.inference_mode():
        # (b) full forward over S + 1 tokens against prefill of S + one decode step
        full, _ = forward(ctx, model, {"tokens": toks, "positions": pos})
        _, kvs = lm_steps.make_prefill(ctx)(model, {"tokens": toks[:, :S],
                                                    "positions": pos[:, :S]})
        caches = caches_from_prefill(ctx, kvs, S + 16)
        step, _ = lm_steps.make_decode_step(ctx)(model, toks[:, S:], S, caches)
        want, got = full[:, -1].double(), step[:, 0].double()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=LM_DECODE_TOL, atol=LM_DECODE_TOL),
              f"lm (b): decode against forward, max |Δ| {err:.3e}")
        rec["b"] = dict(max_abs_err=err, max_abs_logit=float(want.abs().max()))
        print(f"[lm] (b) forward over {S + 1} tokens against prefill {S} + one decode step: "
              f"max |Δ| {err:.3e} (rtol = atol = {LM_DECODE_TOL})")
        prof = lm_decode_profile(ctx, model, step[:, -1].argmax(dim=-1)[:, None], S + 1,
                                 caches)
        rec["decode_profile"] = prof
        print(f"[lm] a warm f32 decode step at B = {B}: {prof['wall_ms']:.3f} ms wall, "
              f"{prof['device_ms']:.3f} ms device (busy {prof['busy']:.3f}), "
              f"{prof['launches']:.0f} kernels; most device time: "
              + ", ".join(f"{k[:60]} {v:.3f}" for k, v in prof["top"]))
        del full, kvs, caches, step

        # (c) a 4096-token prompt: the prefill takes _chunked_sdpa on every layer
        Bl, P, gen = LM_LONG["batch"], LM_LONG["prompt_len"], LM_LONG["gen"]
        check(P > lm_attention.CHUNKED_ATTN_THRESHOLD, "lm (c): the prompt is not chunked")
        prompt = torch.randint(0, cfg.vocab_size, (Bl, P), device=dev,
                               generator=torch.Generator(dev).manual_seed(2))
        lpos = torch.arange(P, device=dev).expand(Bl, P)
        chunked = lm_attention._chunked_sdpa
        taken = []

        def counted_chunked(*a, **k):
            taken.append(1)
            return chunked(*a, **k)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm_attention._chunked_sdpa = counted_chunked
        try:
            r = lm_serve.lm_generate(ctx, model, {"tokens": prompt, "positions": lpos}, gen)
        finally:
            lm_attention._chunked_sdpa = chunked
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(r["finite"] and len(taken) == cfg.n_layers,
              f"lm (c): finite {r['finite']}, _chunked_sdpa taken {len(taken)} times")
        check(int(r["tokens"].min()) >= 0 and int(r["tokens"].max()) < cfg.vocab_size,
              "lm (c): an id outside the vocabulary")
        layer = model.layers[0]
        x = rms_norm(embed_tokens(ctx, model, prompt), layer.norm_attn, cfg.norm_eps)
        q, k, v = lm_attention._project_qkv(layer.attn, cfg, x, lpos)
        got = chunked(cfg, q, k, v, window=0)
        want = lm_attention._sdpa(cfg, q, k, v, causal_mask(P, P, device=dev)[None, None])
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=LM_CHUNKED_TOL, atol=LM_CHUNKED_TOL),
              f"lm (c): layer 0's _chunked_sdpa against _sdpa, max |Δ| {err:.3e}")
        timer = Timer(n=5)
        chunked_ms = timer.ms(lambda: chunked(cfg, q, k, v, window=0))
        sdpa_ms = timer.ms(lambda: lm_attention._sdpa(
            cfg, q, k, v, causal_mask(P, P, device=dev)[None, None]))
        del timer, x, q, k, v, got, want
        rec["c"] = dict(prefill_s=r["prefill_s"], decode_s=r["decode_s"],
                        tokens_per_s=r["tokens_per_s"], peak_gb=peak, chunked_layers=len(taken),
                        chunked_max_abs_err=err, chunked_ms=chunked_ms, sdpa_ms=sdpa_ms)
        print(f"[lm] (c) B={Bl} prompt {P} gen {gen}: prefill {r['prefill_s']:.4f}s "
              f"(_chunked_sdpa on {len(taken)} layers), decode {r['decode_s']:.4f}s = "
              f"{r['tokens_per_s']:.1f} tok/s, peak {peak:.2f} GB; layer 0 _chunked_sdpa "
              f"against _sdpa max |Δ| {err:.3e} (tol {LM_CHUNKED_TOL}), {chunked_ms:.3f} "
              f"against {sdpa_ms:.3f} ms")

        # (d) the same seeded weights cut to 2 layers: the card against the CPU
        cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
        state = {n: t for n, t in model.state_dict().items()
                 if not n.startswith("layers.") or int(n.split(".")[1]) < LM_CUT_LAYERS}
        del model, ctx
        torch.cuda.empty_cache()
        on_card = Transformer(cut, dtype=torch.float32, device=dev)
        on_card.load_state_dict(state)
        on_cpu = Transformer(cut, dtype=torch.float32, device="cpu")
        on_cpu.load_state_dict({n: t.cpu() for n, t in state.items()})
        del state
        batch = {"tokens": toks[:, :S], "positions": pos[:, :S]}
        got, _ = lm_steps.make_prefill(on_card.ctx)(on_card, batch)
        want, _ = lm_steps.make_prefill(on_cpu.ctx)(on_cpu, {k: t.cpu() for k, t in batch.items()})
        err, scale = float((got.cpu() - want).abs().max()), float(want.abs().max())
        check(err <= LM_CPU_TOL * scale,
              f"lm (d): card against CPU, max |Δ| {err:.3e} > {LM_CPU_TOL} × {scale:.3e}")
        rec["d"] = dict(layers=LM_CUT_LAYERS, max_abs_err=err, max_abs_logit=scale)
        print(f"[lm] (d) {LM_CUT_LAYERS} layers, prefill logits on the card against the CPU: "
              f"max |Δ| {err:.3e} of max |logit| {scale:.3e} (tol {LM_CPU_TOL} relative)")
        del on_card, on_cpu, got, want
    torch.cuda.empty_cache()
    rec["e"] = lm_serve_run("e", "bfloat16", device)

    # (f)-(h): the MoE models at full width, each freed before the next
    rec["f"], model = moe_serve_check("f", MOE_QWEN3, MOE_QWEN3_WIDTHS, MOE_QWEN3_LAYERS,
                                      torch.float32, MOE_QWEN3_SERVE, dev)
    rec["g"] = moe_layer_card_vs_cpu(model, dev)
    del model
    torch.cuda.empty_cache()
    rec["h"], model = moe_serve_check("h", MOE_LLAMA4, MOE_LLAMA4_WIDTHS, MOE_LLAMA4_LAYERS,
                                      torch.bfloat16, MOE_LLAMA4_SERVE, dev)
    del model
    torch.cuda.empty_cache()

    # (i)-(l): the SSD models at full width and depth, each freed before the next
    t_ssm = time.perf_counter()
    rec["i"], model = ssm_serve_check("i", SSM_MAMBA2, SSM_MAMBA2_WIDTHS, torch.float32, dev)
    rec["k"] = ssm_layer_card_vs_cpu(model, dev)
    rec["l"] = {SSM_MAMBA2: ssm_long_steps("mamba2", model, dev)}
    del model
    torch.cuda.empty_cache()
    rec["i_bf16"], model = ssm_serve_check("i", SSM_MAMBA2, SSM_MAMBA2_WIDTHS, torch.bfloat16,
                                           dev)
    del model
    torch.cuda.empty_cache()
    rec["j"], model = ssm_serve_check("j", SSM_HYMBA, SSM_HYMBA_WIDTHS, torch.float32, dev)
    rec["l"][SSM_HYMBA] = ssm_long_steps("hymba", model, dev)
    del model
    torch.cuda.empty_cache()
    rec["ssm_s"] = time.perf_counter() - t_ssm
    print(f"[lm] (i)-(l) took {rec['ssm_s']:.2f}s")

    # (m): the enc-dec model at full width and depth
    rec["m"] = encdec_check(dev)
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[lm] the phase took {rec['phase_s']:.2f}s")
    return rec


#: the train phase (``phase_train``): internlm2-1.8b (``LM_ARCH``) at the reference
#: trainer's defaults (``repro/launch/train.py``: f32, B = 8, S = 128, lr 1e-3)
TRAIN = dict(batch=8, seq=128, steps=10, lr=1e-3)
TRAIN_CUT_LAYERS = 2                                    # (t1)
#: (t1) B on both sides, S = TRAIN's: the CPU's step at B = 8 took 23–35 s of
#: the phase; the widths, the depth cut and the tolerances are the same
TRAIN_CPU_BATCH = 2
#: (t1) the card against the CPU: loss and grad norm relative; each gradient,
#: m and v over the CPU's largest magnitude of that tensor (f32, TF32 off)
TRAIN_CPU_RTOL = 1e-5
TRAIN_CPU_GRAD_TOL = 1e-4
#: (t2) accum=2 against accum=1 on one batch: the reference's own bounds
#: (``tests/test_models.py::test_grad_accumulation_matches_full_batch``)
TRAIN_ACCUM = dict(loss_rtol=1e-5, rtol=2e-4, atol=2e-5)
#: ... but where the two runs' first-step gradients differ by more than this
#: fraction of themselves: a first AdamW step moves p by lr·g/(|g| + eps),
#: which is noise there, so p is held within 2·lr (at most 1 % of the params
#: outside rtol/atol)
TRAIN_ACCUM_NOISE = 1e-3
TRAIN_OPTIONS_STEPS = 3                                 # (t2) --compress, bf16
#: (t3) t2's protocol (lr 1e-3, cosine over 10 steps): 3 steps at lr 1e-3 went
#: 11.139 -> 12.353 -> 11.204 on the card, AdamW's first steps overshooting at
#: random init as internlm2's do (11.58 -> 14.48 at its step 1, 6.16 at 10)
TRAIN_MAMBA2_STEPS = TRAIN["steps"]
#: (t4) resumed against straight, the reference's bound (tests/test_runtime.py)
TRAIN_RESUME_RTOL = 1e-4
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"


def pipeline_batch(cfg, B: int, S: int, step: int, dev, seed: int = 0) -> dict:
    """Batch ``step`` of ``data.pipeline`` (shard 0 of 1, ``seed``), on ``dev``."""
    pipe = PipelineConfig(batch_size=B, seq_len=S, seed=seed, mrope=cfg.mrope,
                          frontend=cfg.frontend, d_model=cfg.d_model, enc_dec=cfg.enc_dec,
                          src_fraction=lm_steps.SRC_FRACTION)
    return lm_train.to_device(make_batch(SyntheticSource(cfg.vocab_size, seed), pipe, step), dev)


def grad_recorder(store: dict):
    """A ``grad_transform`` that keeps the step's gradients in ``store`` and
    passes them on unchanged."""
    def transform(grads, extra):
        store.update(grads)
        return grads, extra
    return transform


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|, on ``got``'s device."""
    want = want.to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def train_card_vs_cpu(cfg, dev) -> dict:
    """(t1): the full width cut to ``TRAIN_CUT_LAYERS`` layers, f32: one
    ``make_train_step`` on the card and on the CPU from the same weights
    (drawn on the card, copied) and the same pipeline batch (B =
    ``TRAIN_CPU_BATCH``, S = 128).  Loss and grad norm within
    ``TRAIN_CPU_RTOL``; every gradient, m and v within ``TRAIN_CPU_GRAD_TOL``
    of the CPU's largest magnitude of it."""
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    B, S = TRAIN_CPU_BATCH, TRAIN["seq"]
    runs = {}
    on_card = init_params(cut, torch.Generator(dev).manual_seed(0), torch.float32)
    on_cpu = Transformer(cut, dtype=torch.float32, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    for where, model in (("card", on_card), ("cpu", on_cpu)):
        device = next(model.parameters()).device
        opt = adamw(for_arch(cut.name, TRAIN["lr"], TRAIN["steps"]))
        grads = {}
        step = lm_steps.make_train_step(model.ctx, opt, grad_recorder(grads))
        state, _, metrics = step(model, opt.init(dict(model.named_parameters())), None,
                                 pipeline_batch(cut, B, S, 0, device))
        runs[where] = dict(grads=grads, state=state,
                           metrics={k: float(v) for k, v in metrics.items()})
    card, cpu = runs["card"], runs["cpu"]
    rec = {f"{k}_rel": abs(card["metrics"][k] - cpu["metrics"][k]) / abs(cpu["metrics"][k])
           for k in ("loss", "grad_norm")}
    for k in ("loss", "grad_norm"):
        err = rec[f"{k}_rel"]
        check(err <= TRAIN_CPU_RTOL, f"train (t1): {k} card {card['metrics'][k]!r} against CPU "
                                     f"{cpu['metrics'][k]!r}, {err:.3e} > {TRAIN_CPU_RTOL}")
    for part, card_tree, cpu_tree in (("grad", card["grads"], cpu["grads"]),
                                      ("m", card["state"].m, cpu["state"].m),
                                      ("v", card["state"].v, cpu["state"].v)):
        worst = max((max_rel(card_tree[k], cpu_tree[k]), k) for k in cpu_tree)
        check(worst[0] <= TRAIN_CPU_GRAD_TOL,
              f"train (t1): {part} of {worst[1]} card against CPU {worst[0]:.3e} > "
              f"{TRAIN_CPU_GRAD_TOL} of its largest")
        rec[f"{part}_max_rel"], rec[f"{part}_worst"] = worst
    n = sum(p.numel() for p in on_card.parameters())
    rec.update(layers=TRAIN_CUT_LAYERS, params=n, loss=card["metrics"]["loss"],
               seconds=time.perf_counter() - t0)
    print(f"[train] (t1) {TRAIN_CUT_LAYERS} layers at full width ({n} parameters), one step "
          f"at B={B} S={S} card against CPU: loss {rec['loss']:.6f} rel {rec['loss_rel']:.3e}, grad norm rel "
          f"{rec['grad_norm_rel']:.3e} (tol {TRAIN_CPU_RTOL}); grads {rec['grad_max_rel']:.3e} "
          f"({rec['grad_worst']}), m {rec['m_max_rel']:.3e}, v {rec['v_max_rel']:.3e} of their "
          f"largest (tol {TRAIN_CPU_GRAD_TOL}); {rec['seconds']:.2f}s")
    return rec


def train_step_profile(step, model, opt_state, batch) -> tuple[dict, object]:
    """One warm train step timed on the host (the card drained), then one
    under ``torch.profiler``: device ms, busy share (device over wall),
    kernels launched and the five costliest."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt_state, _, _ = step(model, opt_state, None, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt_state, _, _ = step(model, opt_state, None, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_ms = {e.key: float(getattr(e, "self_device_time_total", 0.0)) / 1e3 for e in kernels}
    device_ms = sum(dev_ms.values())
    check(device_ms > 0, "train: the profiled step shows no device time")
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy=device_ms / wall_ms,
                launches=sum(e.count for e in kernels),
                top=sorted(dev_ms.items(), key=lambda kv: -kv[1])[:5]), opt_state


def train_trainer(cfg, dev) -> dict:
    """(t2): ``launch/train.py``'s ``main`` at full width and depth, f32,
    ``TRAIN``'s B, S, steps and lr, remat on: every loss and grad norm
    finite, the last loss below the first; the parameter count, peak GB,
    each warm step's wall and tokens/s.  Then, on the trained weights: one
    warm step profiled; ``accum=2`` against ``accum=1`` on one batch (each
    from a fresh AdamW on a copy of the same weights: the loss within
    ``TRAIN_ACCUM``'s 1e-5 relative, the params within its rtol/atol where
    the two runs' gradients agree within ``TRAIN_ACCUM_NOISE`` of
    themselves; where they do not (near 0), a first step's lr·g/(|g| + eps)
    is rounding noise and p is held within 2·lr; the params outside rtol/atol
    counted, at most 1 %); then ``--compress`` and
    ``--dtype bfloat16`` runs of ``TRAIN_OPTIONS_STEPS`` steps, finite."""
    t_part = time.perf_counter()
    B, S = TRAIN["batch"], TRAIN["seq"]
    argv = ["--arch", cfg.name, "--steps", str(TRAIN["steps"]), "--batch", str(B),
            "--seq", str(S), "--lr", str(TRAIN["lr"])]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = lm_train.main(argv)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, norms, step_s = out["losses"], out["grad_norms"], out["step_s"]
    check(all(math.isfinite(x) for x in losses + norms),
          f"train (t2): a loss or grad norm is not finite: {losses} {norms}")
    check(losses[-1] < losses[0], f"train (t2): the loss did not fall: {losses}")
    model = out["final_params"]
    check(model.ctx.remat, "train (t2): remat is off")
    n_params = sum(p.numel() for p in model.parameters())
    warm = step_s[1:]
    tok_s = B * S / statistics.median(warm)
    rec = dict(params=n_params, peak_gb=peak, losses=losses, grad_norms=norms, step_s=step_s,
               tokens_per_s=tok_s, run_s=run_s)
    print(f"[train] (t2) {cfg.name} at full width and depth, f32, B={B} S={S}: {n_params} "
          f"parameters; {len(losses)} steps in {run_s:.2f}s, losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; peak {peak:.2f} GB; first step {step_s[0]:.3f}s, warm steps "
          + " ".join(f"{x:.3f}" for x in warm) + f" s; {tok_s:.1f} tokens/s (median warm)")

    batch = pipeline_batch(cfg, B, S, TRAIN["steps"], dev)
    opt = adamw(for_arch(cfg.name, TRAIN["lr"], TRAIN["steps"]))
    params = dict(model.named_parameters())
    step = lm_steps.make_train_step(model.ctx, opt)
    state, _, _ = step(model, opt.init(params), None, batch)       # warm, then profiled
    prof, state = train_step_profile(step, model, state, batch)
    del state
    rec["profile"] = prof
    print(f"[train] (t2) a warm step: {prof['wall_ms']:.1f} ms wall, {prof['device_ms']:.1f} ms "
          f"device (busy {prof['busy']:.3f}), {prof['launches']} kernels; most device time: "
          + ", ".join(f"{k[:60]} {v:.2f}" for k, v in prof["top"]))

    # accum=2 against accum=1 from one set of weights, each a fresh AdamW; the
    # accum=1 run's m waits on the host while accum=2 runs (peak ~64 GB)
    twin = Transformer(cfg, dtype=torch.float32, device=dev)
    twin.load_state_dict(model.state_dict())
    state, _, mt = lm_steps.make_train_step(model.ctx, opt)(model, opt.init(params), None, batch)
    loss1 = float(mt["loss"])
    m1 = {k: v.cpu() for k, v in state.m.items()}
    del state, out, params, step
    torch.cuda.empty_cache()
    state, _, mt = lm_steps.make_train_step(twin.ctx, opt, accum=2)(
        twin, opt.init(dict(twin.named_parameters())), None, batch)
    loss2 = float(mt["loss"])
    loss_rel = abs(loss2 - loss1) / abs(loss1)
    check(loss_rel <= TRAIN_ACCUM["loss_rtol"],
          f"train (t2): accum=2 loss {loss2!r} against {loss1!r}: {loss_rel:.3e}")
    n_noise = n_out = n_bad = 0
    with torch.no_grad():
        for (k, a), b in zip(model.named_parameters(), twin.parameters(), strict=True):
            g1, g2 = m1.pop(k).to(dev), state.m[k]
            # m = 0.1·clip·g after one step; where the two gradients disagree by
            # more than 1e-3 of themselves (near 0) a first step's lr·g/(|g| + eps)
            # is noise
            noise = (g1 - g2).abs() > TRAIN_ACCUM_NOISE * g1.abs()
            diff = (a - b).abs()
            bad = diff > TRAIN_ACCUM["atol"] + TRAIN_ACCUM["rtol"] * a.abs()
            n_out += int((bad & ~noise).sum())
            n_noise += int(noise.sum())
            n_bad += int(bad.sum())
            check(bool((diff[noise] <= 2 * TRAIN["lr"] + TRAIN_ACCUM["atol"]).all()),
                  f"train (t2): accum=2 param {k} moved more than 2·lr from accum=1")
    del model
    del twin, state
    torch.cuda.empty_cache()
    check(n_out == 0, f"train (t2): {n_out} params of accum=2 outside rtol "
                      f"{TRAIN_ACCUM['rtol']} / atol {TRAIN_ACCUM['atol']} of accum=1's where "
                      f"their gradients agree")
    check(n_bad <= n_params // 100, f"train (t2): {n_bad} params of accum=2 outside rtol / "
                                    f"atol of accum=1's, more than 1 %")
    rec["accum"] = dict(loss_rel=loss_rel, noise=n_noise, outside=n_bad)
    print(f"[train] (t2) accum=2 against accum=1: loss rel {loss_rel:.3e} (tol "
          f"{TRAIN_ACCUM['loss_rtol']}); {n_bad} params outside rtol {TRAIN_ACCUM['rtol']} / "
          f"atol {TRAIN_ACCUM['atol']}, all within 2·lr and among the {n_noise} whose two "
          f"gradients differ by more than {TRAIN_ACCUM_NOISE} of themselves; "
          f"{time.perf_counter() - t_part:.2f}s into (t2)")

    for tag, extra in (("compress", ["--compress"]), ("bf16", ["--dtype", "bfloat16"])):
        torch.cuda.reset_peak_memory_stats()
        o = lm_train.main(argv[:2] + ["--steps", str(TRAIN_OPTIONS_STEPS)] + argv[4:] + extra)
        pk = torch.cuda.max_memory_allocated() / 1e9
        check(all(math.isfinite(x) for x in o["losses"] + o["grad_norms"]),
              f"train (t2) {tag}: a loss or grad norm is not finite")
        if tag == "bf16":
            check(all(p.dtype == torch.bfloat16 for p in o["final_params"].parameters()),
                  "train (t2) bf16: the params are not bf16")
        rec[tag] = dict(losses=o["losses"], grad_norms=o["grad_norms"], step_s=o["step_s"],
                        peak_gb=pk)
        print(f"[train] (t2) {tag}: losses " + " ".join(f"{x:.4f}" for x in o["losses"])
              + f", steps " + " ".join(f"{x:.3f}" for x in o["step_s"]) + f" s, peak {pk:.2f} GB")
        del o
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_part
    print(f"[train] (t2) took {rec['seconds']:.2f}s")
    return rec


def _exp_before_mask_chunk_step(h, xck, Bck, Cck, dtc, A, tri):
    """``models.ssm._chunk_step`` as it took ``exp`` before masking (the
    reference's order): its backward multiplies a zero cotangent by the
    upper triangle's inf."""
    a = dtc * A
    cum = torch.cumsum(a, dim=1)
    CB = torch.einsum("bin,bjn->bij", Cck, Bck)
    decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
    M = torch.where(tri[None, :, :, None], CB[..., None] * decay * dtc[:, None, :, :], 0.0)
    y = torch.einsum("bijh,bjhp->bihp", M, xck)
    y = y + torch.einsum("bin,bhpn->bihp", Cck, h) * torch.exp(cum)[..., None]
    a_sum = cum[:, -1]
    carry_decay = torch.exp(a_sum[:, None, :] - cum)
    h_new = (torch.exp(a_sum)[:, :, None, None] * h
             + torch.einsum("bjh,bjn,bjhp->bhpn", carry_decay * dtc, Bck, xck))
    return h_new, y


def train_mamba2(dev) -> dict:
    """(t3): mamba2-780m at full width and depth, f32, ``TRAIN``'s B and S
    (one chunk of 128), ``TRAIN_MAMBA2_STEPS`` steps of ``make_train_step``:
    every gradient finite at every step, the loss finite and falling; peak
    GB, step walls, tokens/s, one warm step profiled; layer 0's largest
    exponent above the diagonal
    (max cum_i − cum_j over the chunk, i < j); and the same first batch's
    gradients through the chunk step that took ``exp`` before masking, which
    must not all be finite (the fault the masked exponent repairs)."""
    t_part = time.perf_counter()
    cfg = get_config(SSM_MAMBA2)
    check({k: getattr(cfg, k) for k in SSM_MAMBA2_WIDTHS} == SSM_MAMBA2_WIDTHS,
          f"{SSM_MAMBA2}: not the full widths")
    B, S = TRAIN["batch"], TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), torch.float32)
    n_params = sum(p.numel() for p in model.parameters())
    batch0 = pipeline_batch(cfg, B, S, 0, dev)

    # layer 0's exponents: cum over the chunk of dt·A, from the normed embedding
    with torch.no_grad():
        layer = model.layers[0]
        x = rms_norm(embed_tokens(model.ctx, model, batch0["tokens"]), layer.norm_attn,
                     cfg.norm_eps)
        dt = F.softplus((x @ layer.ssm.w_dt).float() + layer.ssm.dt_bias)
        cum = torch.cumsum(dt * -torch.exp(layer.ssm.A_log), dim=1)
        span = float((cum[:, :, None, :] - cum[:, None, :, :]).amax())
        del x, dt, cum

    names, params = zip(*model.named_parameters())
    real = lm_ssm._chunk_step
    lm_ssm._chunk_step = _exp_before_mask_chunk_step
    try:
        loss, _ = lm_steps.lm_loss(model.ctx, model, batch0)
        old = torch.autograd.grad(loss, params, materialize_grads=True)
        old_finite = bool(torch.stack([torch.isfinite(g).all() for g in old]).all())
        old_bad = [n for n, g in zip(names, old, strict=True) if not bool(torch.isfinite(g).all())]
        del loss, old
    finally:
        lm_ssm._chunk_step = real
    check(not old_finite, "train (t3): the exp-before-mask chunk step gave finite gradients "
                          f"(largest exponent {span:.1f}); the check would not see the fault")

    opt = adamw(for_arch(cfg.name, TRAIN["lr"], TRAIN_MAMBA2_STEPS))
    grads = {}
    step = lm_steps.make_train_step(model.ctx, opt, grad_recorder(grads))
    state = opt.init(dict(zip(names, params)))
    losses, walls = [], []
    for i in range(TRAIN_MAMBA2_STEPS):
        batch = batch0 if i == 0 else pipeline_batch(cfg, B, S, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, metrics = step(model, state, None, batch)
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
        check(finite, f"train (t3): step {i}: a gradient is not finite")
        grads.clear()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train (t3): the loss is not finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    tok_s = B * S / statistics.median(walls[1:])
    prof, state = train_step_profile(step, model, state, batch)
    grads.clear()
    rec = dict(params=n_params, span=span, old_nonfinite=old_bad[:8], n_old_nonfinite=len(old_bad),
               losses=losses, step_s=walls, peak_gb=peak, tokens_per_s=tok_s, profile=prof)
    print(f"[train] (t3) {SSM_MAMBA2} at full width and depth, f32, B={B} S={S}: {n_params} "
          f"parameters; layer 0's largest exponent above the diagonal {span:.1f} (exp overflows "
          f"f32 past 88.7); exp before the mask: {len(old_bad)} non-finite gradients (e.g. "
          f"{', '.join(old_bad[:3])}); the port's: all finite; losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; steps "
          + " ".join(f"{x:.3f}" for x in walls) + f" s; {tok_s:.1f} tokens/s; peak {peak:.2f} GB")
    print(f"[train] (t3) a warm step: {prof['wall_ms']:.1f} ms wall, {prof['device_ms']:.1f} ms "
          f"device (busy {prof['busy']:.3f}), {prof['launches']} kernels; most device time: "
          + ", ".join(f"{k[:60]} {v:.2f}" for k, v in prof["top"]))
    del model, state, step
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_part
    print(f"[train] (t3) took {rec['seconds']:.2f}s")
    return rec


def train_resume(cfg) -> dict:
    """(t4): reduced internlm2 on the card: 6 steps straight; 6 steps with
    checkpoints every 2 under ``build/`` and a failure injected at step 3;
    the rerun resumed from the step-4 checkpoint (written before the failure): its last loss within
    ``TRAIN_RESUME_RTOL`` of the straight run's.  (Full-width checkpoints
    would be 20–30 GB of .npy files.)"""
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    common = ["--arch", cfg.name, "--reduced", "--steps", "6", "--batch", "2", "--seq", "32",
              "--ckpt-every", "2"]
    try:
        straight = lm_train.main(common)
        failed = lm_train.main(common + ["--ckpt-dir", str(TRAIN_CKPT_DIR), "--fail-at", "3"])
        check(failed.get("failed_at") == 3, "train (t4): no failure injected at step 3")
        resumed = lm_train.main(common + ["--ckpt-dir", str(TRAIN_CKPT_DIR)])
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    a, b = resumed["losses"][-1], straight["losses"][-1]
    rel = abs(a - b) / abs(b)
    check(len(resumed["losses"]) == 2 and rel <= TRAIN_RESUME_RTOL,
          f"train (t4): resumed last loss {a!r} against straight {b!r}: {rel:.3e}")
    print(f"[train] (t4) reduced {cfg.name}: straight last loss {b:.6f}, fail at 3 + resume "
          f"{a:.6f} (rel {rel:.3e}, tol {TRAIN_RESUME_RTOL})")
    return dict(straight=straight["losses"], resumed=resumed["losses"], rel=rel)


# ----------------------------------------------------------- train on a mesh

#: (t5)–(t7): the training step on a (data, model) mesh of spawned ranks
#: sharing the card (gloo: NCCL takes one card a rank), internlm2-1.8b at
#: full width cut to ``TRAIN_CUT_LAYERS`` layers, f32, TRAIN's B and S
TRAIN_MESH_STEPS = 3
#: (t5) the gloo runs of one spawn of 4 ranks: (2, 2) twice (the second
#: repeats the first's losses bitwise) and the trainer's own (1, 4)
TRAIN_MESH_RUNS = (("a", (2, 2)), ("b", (2, 2)), ("c", (1, 4)))
#: loss and grad norm against the one-device step, relative
TRAIN_MESH_RTOL = 1e-6
#: every gradient, m, v and parameter block against the same block of the
#: one-device tensor, over that tensor's largest magnitude (the bounds of
#: the one-device step on the card); parameters where the two runs' m have
#: differed by more than ``TRAIN_ACCUM_NOISE`` of themselves at any step so
#: far are held within 2·Σ lr instead (at most 1 % of a tensor)
TRAIN_MESH_TOL = 1e-4
TRAIN_MESH_TIMEOUT = 600
TRAIN_MESH_GROUP_TIMEOUT = 300
TRAIN_MESH_SCRATCH = ROOT / "build" / "train_mesh"
#: (t6) qwen3-moe-235b-a22b's layer 0 MoE at full width: 256 tokens (B = 2,
#: S = 128: the dispatch path), forward and backward, on gloo (2, 2)
MOE_MESH_ARCH = "qwen3-moe-235b-a22b"
MOE_MESH_SHAPE = (2, 128)
MOE_MESH_OUT_TOL = 1e-5


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, printed beside every time."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def _mesh_snapshot(model, state, grads) -> dict:
    """Copies of a step's gradients, m, v and parameters on the card, and
    each tensor's largest magnitude."""
    snap = {"grads": {k: g.detach().clone() for k, g in grads.items()},
            "m": {k: t.clone() for k, t in state.m.items()},
            "v": {k: t.clone() for k, t in state.v.items()},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()}}
    snap["max"] = {part: {k: float(t.abs().max()) for k, t in tree.items()}
                   for part, tree in snap.items()}
    return snap


def mesh_reference_steps(cut, dev) -> dict:
    """(t5)'s yardstick: ``TRAIN_MESH_STEPS`` one-device steps on the card
    (the pipeline's batches 0, 1, 2; lr 1e-3, cosine over those steps):
    each step's loss, grad norm and snapshot (``_mesh_snapshot``).  The
    model, its state and the activations are freed before it returns."""
    B, S = TRAIN["batch"], TRAIN["seq"]
    model = init_params(cut, torch.Generator(dev).manual_seed(0), torch.float32)
    opt = adamw(for_arch(cut.name, TRAIN["lr"], TRAIN_MESH_STEPS))
    grads = {}
    step = lm_steps.make_train_step(model.ctx, opt, grad_recorder(grads))
    state = opt.init(dict(model.named_parameters()))
    out = {"loss": [], "grad_norm": [], "lr": [], "snap": []}
    for s in range(TRAIN_MESH_STEPS):
        state, _, metrics = step(model, state, None, pipeline_batch(cut, B, S, s, dev))
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(metrics[k]))
        out["snap"].append(_mesh_snapshot(model, state, grads))
    del model, state, grads, step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _mesh_compare(mesh, model, state, grads, snap, lr_sum: float, noisy: dict) -> dict:
    """This rank's blocks of the step's tensors against the same blocks of
    the one-device snapshot; the worst over every rank (one max over the
    mesh).  Returns, per part, the largest error over its tensor's largest
    and its tensor; for the params the noise-rule counts: ``noisy`` (name →
    bool block, updated in place) marks the entries whose two m have
    differed by more than ``TRAIN_ACCUM_NOISE`` of themselves at this step
    or an earlier one (a first step's ±lr stays in p after the two m agree
    again); and whether every block equals its one-device block."""
    from repro_torch.distributed import sharding
    every = mesh.axis_comm(mesh.axis_names)
    named = {"grads": grads, "m": state.m, "v": state.v,
             "params": {k: p.detach() for k, p in model.named_parameters()}}
    specs = {k: sharding.spec_of(p) for k, p in model.named_parameters()}
    names = list(specs)
    rec, equal = {}, True
    for part, tree in named.items():
        errs = []
        for k in names:
            want = sharding.block_of(snap[part][k], specs[k], mesh)
            equal &= torch.equal(tree[k], want)
            errs.append(((tree[k] - want).abs().max() / max(snap["max"][part][k], 1e-30))
                        .float())
        worst = every.max(torch.stack(errs))
        i = int(worst.argmax())
        rec[part] = (float(worst[i]), names[i])
    bad = noise_broken = 0
    over_noisy, sizes = [], []
    for k in names:
        want = sharding.block_of(snap["params"][k], specs[k], mesh)
        m_ref = sharding.block_of(snap["m"][k], specs[k], mesh)
        diff = (named["params"][k] - want).abs()
        noisy[k] |= (state.m[k] - m_ref).abs() > TRAIN_ACCUM_NOISE * m_ref.abs()
        over = diff > TRAIN_MESH_TOL * snap["max"]["params"][k]
        bad += int((over & ~noisy[k]).sum())
        noise_broken += int((diff[noisy[k]] > 2 * lr_sum).sum())
        over_noisy.append(int(over.sum()))
        sizes.append(diff.numel())
    dev = grads[names[0]].device
    counts = every.sum(torch.tensor([bad, noise_broken, int(not equal)] + over_noisy + sizes,
                                    dtype=torch.float64, device=dev))
    rec["param_outside"], rec["noise_rule_broken"] = int(counts[0]), int(counts[1])
    n = len(names)
    frac = (counts[3:3 + n] / counts[3 + n:]).tolist()
    i = max(range(n), key=lambda j: frac[j])
    rec["param_noisy"] = int(counts[3:3 + n].sum())
    rec["param_total"] = int(counts[3 + n:].sum())
    rec["param_noisy_worst"] = (frac[i], names[i])
    rec["bitwise"] = int(counts[2]) == 0
    return rec


def mesh_train_run(shape, ref: dict, cut, dev, group=None) -> dict:
    """One (t5) run on a ``data`` × ``model`` mesh of ``shape`` over
    ``group`` (the default group by default): the trainer's placement
    (``init_params`` with the mesh: one device's draws, each layer cut to
    this rank's blocks as it is drawn), then ``TRAIN_MESH_STEPS`` steps on
    the global batches, each compared with the one-device step's
    (``_mesh_compare``)."""
    from repro_torch.launch.mesh import Mesh
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = Mesh(shape, ("data", "model"), group=group)
    model = init_params(cut, torch.Generator(dev).manual_seed(0), torch.float32, mesh=mesh)
    torch.cuda.empty_cache()
    opt = adamw(for_arch(cut.name, TRAIN["lr"], TRAIN_MESH_STEPS))
    grads = {}
    step = lm_steps.make_train_step(model.ctx, opt, grad_recorder(grads))
    state = opt.init(dict(model.named_parameters()))
    rec = {"shape": list(shape), "backend": mesh.backend, "loss": [], "grad_norm": [],
           "step_s": [], "staged": [], "compare": [], "setup_s": time.perf_counter() - t0}
    lr_sum = 0.0
    noisy = {k: torch.zeros(p.shape, dtype=torch.bool, device=dev)
             for k, p in model.named_parameters()}
    for s in range(TRAIN_MESH_STEPS):
        batch = pipeline_batch(cut, TRAIN["batch"], TRAIN["seq"], s, dev)
        staged0 = mesh.staged_bytes()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _, metrics = step(model, state, None, batch)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t1)
        rec["staged"].append(mesh.staged_bytes() - staged0)
        rec["loss"].append(float(metrics["loss"]))
        rec["grad_norm"].append(float(metrics["grad_norm"]))
        lr_sum += ref["lr"][s]
        rec["compare"].append(_mesh_compare(mesh, model, state, grads, ref["snap"][s], lr_sum,
                                            noisy))
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.perf_counter() - t0
    del model, state, grads, step, noisy
    torch.cuda.empty_cache()
    return rec


def moe_mesh_reference(dev) -> dict:
    """(t6)'s yardstick: the layer on one rank on the card, forward and
    backward of a seeded cotangent: the output, the dropped assignments, the
    input's gradient and every parameter's gradient, with their largest
    magnitudes; the layer's weights freed."""
    cfg = get_config(MOE_MESH_ARCH)
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn((*MOE_MESH_SHAPE, cfg.d_model), generator=gen, device=dev)
    cot = torch.randn(x.shape, generator=gen, device=dev)
    t0 = time.perf_counter()
    layer = lm_moe.MoE(cfg, dtype=torch.float32, device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    x.requires_grad_()
    stats = {}
    out, aux = lm_moe.moe_forward(layer, cfg, x, stats=stats)
    torch.autograd.backward([out, aux], [cot, torch.ones_like(aux)])
    torch.cuda.synchronize()
    ref = dict(x=x.detach(), cot=cot, out=out.detach(), aux=float(aux.detach()),
               dropped=stats["dropped"].view(MOE_MESH_SHAPE[0], -1), path=stats["path"],
               capacity=stats["capacity"], x_grad=x.grad,
               n_params=sum(p.numel() for p in layer.parameters()),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    ref["max"] = {k: float(p.grad.abs().max()) for k, p in layer.named_parameters()}
    ref["max"].update(out=float(ref["out"].abs().max()), x_grad=float(x.grad.abs().max()))
    # the 9.7 GB of gradients go to files the ranks read their blocks of
    # (memory-mapped), so the card holds no copy of them beside the ranks
    grad_dir = TRAIN_MESH_SCRATCH / "t6_grads"
    shutil.rmtree(grad_dir, ignore_errors=True)
    grad_dir.mkdir(parents=True)
    ref["grads"] = {}
    for k, p in layer.named_parameters():
        path = grad_dir / f"{k}.npy"
        np.save(path, p.grad.cpu().numpy())
        ref["grads"][k] = str(path)
        p.grad = None
    ref["seconds"] = time.perf_counter() - t0
    del layer, out, aux, x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ref


def moe_mesh_run(ref: dict, dev) -> dict:
    """(t6) on the gloo (2, 2) mesh: this rank's blocks (``models.moe.
    init_moe_params`` with the mesh: the one-rank layer's draws, only this
    rank's experts kept, each cut to its block as it is drawn),
    its dp rows of the input, forward and backward; its rows of the output,
    the drops and the input's gradient, and its blocks of the gradients,
    against the one-rank run's; the worst over every rank."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.collectives import Parallel
    from repro_torch.launch.mesh import Mesh
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(MOE_MESH_ARCH)
    mesh = Mesh.from_default_group((2, 2), ("data", "model"))
    layer = lm_moe.init_moe_params(cfg, torch.Generator(dev).manual_seed(0), torch.float32,
                                   mesh=mesh)
    par = Parallel(mesh, ("data",), "model")
    x = par.rows(ref["x"], 0).clone().requires_grad_()
    cot = par.rows(ref["cot"], 0)
    staged0 = mesh.staged_bytes()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = {}
    out, aux = lm_moe.moe_forward(layer, cfg, x, stats=stats, par=par)
    torch.autograd.backward([out, aux], [cot, torch.ones_like(aux)])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    every = mesh.axis_comm(mesh.axis_names)
    errs = [(out.detach() - par.rows(ref["out"], 0)).abs().max() / ref["max"]["out"],
            (x.grad - par.rows(ref["x_grad"], 0)).abs().max() / ref["max"]["x_grad"]]
    names = [k for k, _ in layer.named_parameters()]
    for k, p in layer.named_parameters():
        whole = torch.from_numpy(np.load(ref["grads"][k], mmap_mode="r"))
        want = sharding.block_of(whole, sharding.spec_of(p), mesh).to(dev)
        errs.append((p.grad - want).abs().max() / ref["max"][k])
        del whole, want
    worst = every.max(torch.stack(errs).float())
    drops_equal = torch.equal(stats["dropped"].view(x.shape[0], -1),
                              par.rows(ref["dropped"], 0))
    flags = every.sum(torch.tensor([int(not drops_equal), int(stats["path"] != ref["path"]),
                                    int(stats["capacity"] != ref["capacity"])],
                                   dtype=torch.float64, device=dev))
    rec = dict(out_err=float(worst[0]), x_grad_err=float(worst[1]),
               grad_err={k: float(worst[2 + i]) for i, k in enumerate(names)},
               drops_differ=int(flags[0]), path_differs=int(flags[1]),
               capacity_differs=int(flags[2]), path=stats["path"],
               capacity=stats["capacity"], n_dropped=int(stats["dropped"].sum()),
               aux=float(aux.detach()), step_s=step_s, staged=mesh.staged_bytes() - staged0,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               seconds=time.perf_counter() - t0)
    rec["n_dropped_all"] = int(every.sum(torch.tensor([rec["n_dropped"]], device=dev))[0])
    return rec


def train_mesh_rank(rank: int, world: int, out_dir: str, part: str, ref: dict) -> None:
    """One spawned gloo rank of (t5) or (t6) (``part``): joins the group
    (``file://`` rendezvous, the group's own timeout) and runs, for (t5),
    the runs of ``TRAIN_MESH_RUNS`` and then, on rank 0 alone, the run on a
    one-rank NCCL group (``dist.new_group([0], backend="nccl")``: NCCL takes
    one card a rank) while the others wait.  That run's axis groups have
    one rank each, so it runs the mesh code with identity collectives and
    launches no NCCL op; for (t6) the MoE layer on (2,
    2).  Rank 0 writes each record.  ``ref`` holds the one-device run's
    tensors on the card (shared with this process, not copied) or, for
    (t6), the paths of its gradients."""
    import datetime
    import threading
    import torch.distributed as dist
    if part == "t5":
        # the first torch.utils.checkpoint imports torch._dynamo (~9 s on
        # the card's host): start it now, beside the rendezvous and the draw
        threading.Thread(target=__import__, args=("torch._dynamo",), daemon=True).start()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TRAIN_MESH_GROUP_TIMEOUT))
    dev = torch.device("cuda", 0)
    cut = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_CUT_LAYERS)
    peaks = []
    try:
        if part == "t6":
            rec = moe_mesh_run(ref, dev)
            peaks.append(rec["peak_gb"])
            if rank == 0:
                Path(out_dir, "t6.json").write_text(json.dumps(rec))
        else:
            for tag, shape in TRAIN_MESH_RUNS:
                rec = mesh_train_run(shape, ref, cut, dev)
                peaks.append(rec["peak_gb"])
                if rank == 0:
                    Path(out_dir, f"t5_{tag}.json").write_text(json.dumps(rec))
                    print(f"[train] (t5) {tag} {shape}: losses {rec['loss']}", flush=True)
            nccl = dist.new_group([0], backend="nccl")     # collective: every rank makes it
            if rank == 0:
                rec = mesh_train_run((1, 1), ref, cut, dev, group=nccl)
                check(rec["backend"] == "nccl", f"train (t5): (1, 1) ran on {rec['backend']}")
                peaks.append(rec["peak_gb"])
                Path(out_dir, "t5_nccl.json").write_text(json.dumps(rec))
        Path(out_dir, f"peak{rank}.json").write_text(json.dumps(peaks))
        # drop this process's handles on the parent's tensors now: a spawned
        # process's exit does not release them, and the parent's memory
        # stays held until every handle is released (torch.cuda.ipc_collect)
        ref.clear()
        gc.collect()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def card_memory() -> str:
    """This process's allocated and reserved GB and the card's free GB."""
    free, total = torch.cuda.mem_get_info()
    return (f"this process {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} reserved; the card {free / 1e9:.2f} of "
            f"{total / 1e9:.2f} GB free")


def _spawn_mesh(part: str, ref: dict) -> dict:
    """One spawn of 4 ``train_mesh_rank`` for ``part``: its records, the
    ranks' peaks and its seconds."""
    print(f"[train] ({part}) before its spawn: {card_memory()}", flush=True)
    out_dir = TRAIN_MESH_SCRATCH / part
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    spawn_ranks(train_mesh_rank, 4, (4, str(out_dir), part, ref), TRAIN_MESH_TIMEOUT)
    out = {p.stem: json.loads(p.read_text()) for p in sorted(out_dir.glob("t*.json"))}
    out[f"{part}_peak_gb"] = [json.loads(p.read_text())
                              for p in sorted(out_dir.glob("peak*.json"))]
    out[f"{part}_spawn_s"] = time.perf_counter() - t0
    return out


def _check_t5(tag: str, rec: dict, ref: dict, bitwise: bool) -> None:
    for s in range(TRAIN_MESH_STEPS):
        for k in ("loss", "grad_norm"):
            got, want = rec[k][s], ref[k][s]
            if bitwise:
                check(got == want, f"train (t5) {tag}: step {s} {k} {got!r} is not the "
                                   f"one-device step's {want!r}")
            rel = abs(got - want) / abs(want)
            check(rel <= TRAIN_MESH_RTOL, f"train (t5) {tag}: step {s} {k} {got!r} against "
                                          f"one device {want!r}: {rel:.3e}")
        c = rec["compare"][s]
        if bitwise:
            check(c["bitwise"], f"train (t5) {tag}: step {s}: a block differs from one device")
        for part in ("grads", "m", "v"):
            check(c[part][0] <= TRAIN_MESH_TOL, f"train (t5) {tag}: step {s} {part} of "
                                                f"{c[part][1]}: {c[part][0]:.3e}")
        check(c["param_outside"] == 0 and c["noise_rule_broken"] == 0
              and c["param_noisy_worst"][0] <= 0.01,
              f"train (t5) {tag}: step {s} params: {c}")


def train_mesh(cfg, dev) -> dict:
    """(t5) and (t6), each its one-device yardstick on the card first, then a
    spawn of 4 gloo ranks: (t5)'s 3 steps (the model freed, the snapshots
    kept on the card and shared with the ranks), then (2, 2) twice, (1, 4)
    and rank 0's one-rank NCCL group (bitwise; no NCCL op runs there); the
    snapshots freed; (t6)'s
    layer (freed, its gradients written to files the ranks read their
    blocks of), then (2, 2)."""
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    gc.collect()                         # earlier phases' models held only by cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[train] (t5) before its yardstick: {card_memory()}", flush=True)
    ref5 = mesh_reference_steps(cut, dev)
    t5_ref_s = time.perf_counter() - t0
    out = _spawn_mesh("t5", ref5)
    ref5 = {k: ref5[k] for k in ("loss", "grad_norm", "lr")}   # the snapshots go: 24 GB
    gc.collect()
    torch.cuda.ipc_collect()             # the ranks' handles on them are closed
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    r6 = moe_mesh_reference(dev)
    ref_s = t5_ref_s + time.perf_counter() - t1
    out.update(_spawn_mesh("t6", r6))
    shutil.rmtree(TRAIN_MESH_SCRATCH / "t6_grads", ignore_errors=True)
    for tag in ("t5_a", "t5_b", "t5_c"):
        _check_t5(tag, out[tag], ref5, bitwise=False)
    _check_t5("t5_nccl", out["t5_nccl"], ref5, bitwise=True)
    check(out["t5_b"]["loss"] == out["t5_a"]["loss"],
          f"train (t5): the second (2, 2) run's losses {out['t5_b']['loss']} are not the "
          f"first's {out['t5_a']['loss']}")
    t6 = out["t6"]
    check(t6["drops_differ"] == 0 and t6["path_differs"] == 0 and t6["capacity_differs"] == 0,
          f"train (t6): drops, path or capacity differ from one rank: {t6}")
    check(t6["path"] == "dispatch", f"train (t6): the {t6['path']} path, not dispatch")
    check(t6["out_err"] <= MOE_MESH_OUT_TOL, f"train (t6): output {t6['out_err']:.3e}")
    worst = max(t6["grad_err"].items(), key=lambda kv: kv[1])
    check(worst[1] <= TRAIN_MESH_TOL and t6["x_grad_err"] <= TRAIN_MESH_TOL,
          f"train (t6): gradient {worst} / x {t6['x_grad_err']:.3e}")
    out.update(ref_s=ref_s, t5_ref_s=t5_ref_s, t5_ref=dict(loss=ref5["loss"],
                                                            grad_norm=ref5["grad_norm"]),
               t6_ref=dict(path=r6["path"], capacity=r6["capacity"], aux=r6["aux"],
                           n_dropped=int(r6["dropped"].sum()), n_params=r6["n_params"],
                           seconds=r6["seconds"]),
               ref_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    out["seconds"] = time.perf_counter() - t0
    card = card_line()
    for tag in ("t5_a", "t5_b", "t5_c", "t5_nccl"):
        r = out[tag]
        print(f"[train] (t5) {tag} {r['shape']}: losses {r['loss']} (one device "
              f"{ref5['loss']}), grad/m/v worst "
              f"{max(c['grads'][0] for c in r['compare']):.3e}/"
              f"{max(c['m'][0] for c in r['compare']):.3e}/"
              f"{max(c['v'][0] for c in r['compare']):.3e}, params off {[c['param_noisy'] for c in r['compare']]}"
              f" of {r['compare'][0]['param_total']}; steps {[round(x, 3) for x in r['step_s']]}s,"
              f" staged {[x / 1e9 for x in r['staged']]} GB a step; setup {r['setup_s']:.2f}s, "
              f"run {r['seconds']:.2f}s, rank 0 peak {r['peak_gb']:.2f} GB; on {card}")
    print(f"[train] (t6) {MOE_MESH_ARCH} layer 0 MoE ({r6['n_params']} parameters), "
          f"{MOE_MESH_SHAPE[0] * MOE_MESH_SHAPE[1]} tokens, {t6['path']} C={t6['capacity']}: "
          f"drops equal ({out['t6_ref']['n_dropped']} dropped), out {t6['out_err']:.3e}, "
          f"x grad {t6['x_grad_err']:.3e}, worst grad {worst[1]:.3e} ({worst[0]}); one rank "
          f"{r6['seconds']:.2f}s peak {r6['peak_gb']:.2f} GB; (2, 2) fwd+bwd {t6['step_s']:.2f}s, "
          f"staged {t6['staged'] / 1e9:.2f} GB, rank 0 peak {t6['peak_gb']:.2f} GB; on {card}")
    print(f"[train] (t5)+(t6) peak GB per rank (each run: (t5) a, b, c, rank 0's one-rank (1, 1); "
          f"(t6)): {out['t5_peak_gb']}; {out['t6_peak_gb']}; the one-device yardsticks "
          f"{ref_s:.2f}s, parent peak {out['ref_peak_gb']:.2f} GB; the spawns "
          f"{out['t5_spawn_s']:.2f}s, {out['t6_spawn_s']:.2f}s; (t5)+(t6) "
          f"{out['seconds']:.2f}s; on {card}")
    return out


def train_torchrun(cfg, dev) -> dict:
    """(t7): ``python -m repro_torch.launch.train`` under ``torchrun
    --nproc_per_node 4`` (gloo, the trainer's own (1, 4) mesh), internlm2
    at full width cut to ``TRAIN_CUT_LAYERS`` layers, ``TRAIN_MESH_STEPS``
    steps, against the same trainer in this process on one device: every
    loss within ``TRAIN_MESH_RTOL`` relative."""
    t0 = time.perf_counter()
    argv = ["--arch", cfg.name, "--layers", str(TRAIN_CUT_LAYERS), "--steps",
            str(TRAIN_MESH_STEPS), "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
            "--json"]
    one = lm_train.main(argv)
    one_s = time.perf_counter() - t0
    del one["final_params"]
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "4", "-m", "repro_torch.launch.train", *argv,
                           "--backend", "gloo"], capture_output=True, text=True, env=env,
                          timeout=TRAIN_MESH_TIMEOUT, cwd=ROOT)
    run_s = time.perf_counter() - t1
    check(proc.returncode == 0, f"train (t7): torchrun exited {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    got = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    check(got["mesh"] == {"data": 1, "model": 4}, f"train (t7): mesh {got['mesh']}")
    rels = [abs(a - b) / abs(b) for a, b in zip(got["losses"], one["losses"])]
    check(len(got["losses"]) == len(one["losses"]) and max(rels) <= TRAIN_MESH_RTOL,
          f"train (t7): losses {got['losses']} against one device {one['losses']}: {rels}")
    print(f"[train] (t7) torchrun --nproc_per_node 4 (gloo (1, 4)): losses {got['losses']} "
          f"(one device {one['losses']}, worst rel {max(rels):.3e}); steps "
          f"{[round(x, 3) for x in got['step_s']]}s; one device {one_s:.2f}s, torchrun "
          f"{run_s:.2f}s; on {card_line()}")
    return dict(losses=got["losses"], one_device=one["losses"], rel=rels, step_s=got["step_s"],
                one_s=one_s, torchrun_s=run_s, seconds=time.perf_counter() - t0)


def phase_train(device: str = "cuda") -> dict:
    """The ``train`` phase: the LM side's training half on the card, (t1)–(t4)
    of the module's docstring; each check's failure fails the script."""
    t0 = time.perf_counter()
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on for f32 matmuls")
    cfg = get_config(LM_ARCH)
    check({k: getattr(cfg, k) for k in LM_WIDTHS} == LM_WIDTHS,
          f"{LM_ARCH}: not the full widths {LM_WIDTHS}")
    dev = torch.device(device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec = {"t1": train_card_vs_cpu(cfg, dev)}
    torch.cuda.empty_cache()
    rec["t2"] = train_trainer(cfg, dev)
    rec["t3"] = train_mamba2(dev)
    rec["t4"] = train_resume(cfg)
    t_mesh = time.perf_counter()
    torch.cuda.empty_cache()
    rec["t5_t6"] = train_mesh(cfg, dev)
    rec["t7"] = train_torchrun(cfg, dev)
    rec["mesh_s"] = time.perf_counter() - t_mesh
    print(f"[train] (t5)-(t7) took {rec['mesh_s']:.2f}s on {card_line()}")
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[train] the phase took {rec['phase_s']:.2f}s")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="write the detailed record as JSON to PATH")
    ap.add_argument("--only-distributed", action="store_true",
                    help="build, lint and run the distributed phase alone (no "
                         "kernels line, no contract line)")
    ap.add_argument("--only-audit", action="store_true",
                    help="build, lint and run the audit phase alone (no kernels "
                         "line, no contract line)")
    ap.add_argument("--only-mesh-batched", action="store_true",
                    help="build, lint and run the mesh_batched phase alone (no "
                         "kernels line, no contract line)")
    ap.add_argument("--only-lm", action="store_true",
                    help="run the lm phase alone, with no build (the LM path "
                         "launches no kernel of the port; no kernels line, no "
                         "contract line)")
    ap.add_argument("--only-train", action="store_true",
                    help="run the train phase alone, with no build (the training "
                         "path launches no kernel of the port; no kernels line, "
                         "no contract line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = card_peaks(kind)
    # every session reads an absent tune cache (the default table) but the
    # autotune phase's own; nothing reads or writes the home directory
    TUNE_DIR.mkdir(parents=True, exist_ok=True)
    DEFAULT_CACHE.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(DEFAULT_CACHE)
    if args.only_lm or args.only_train:
        key, phase = ("lm", phase_lm) if args.only_lm else ("train", phase_train)
        rec = phase()
        if args.record:
            Path(args.record).parent.mkdir(parents=True, exist_ok=True)
            Path(args.record).write_text(json.dumps({"card": smi, key: rec}, indent=1))
        return 0

    launches = {}
    t0 = time.perf_counter()
    build = _build.build_all()
    print(f"[build] {len(_build.sources())} sources into {build.relative_to(ROOT)} "
          f"in {time.perf_counter() - t0:.2f}s")
    findings = check_kernels(build_dir=build)       # the table and the ptxas reports
    print(f"[lint] {format_violations(findings)}")
    check(not findings, f"kernel lint: {len(findings)} finding(s)")
    if args.only_distributed or args.only_audit or args.only_mesh_batched:
        key, phase = (("audit", phase_audit) if args.only_audit
                      else ("mesh_batched", phase_mesh_batched) if args.only_mesh_batched
                      else ("distributed", lambda: phase_distributed(probe=True)))
        rec = phase()
        if args.record:
            Path(args.record).parent.mkdir(parents=True, exist_ok=True)
            Path(args.record).write_text(json.dumps({"card": smi, key: rec}, indent=1))
        return 0

    timer = Timer()
    rows = phase_kernels(timer, peaks)
    batched_kernels = phase_batched_kernels(timer, peaks)
    for (name, sname, dt, B), row in batched_kernels.items():
        if B == BATCH:
            rows[(name, sname, dt)] = row           # the kernels line's row
    socket_kernels = phase_socket_kernels(timer, peaks)
    ops.reset_launches()                         # the autotune path starts here
    tuned = phase_autotune(timer)
    launches["autotune"] = dict(ops.LAUNCHES)    # ...and ends here
    for name in ("stencil_spmv", "stencil_spmv_dots", "stencil_spmv_dots3",
                 "fused_cg_body", "fused_pcg_body"):
        check(launches["autotune"][name] > 0, f"{name} was not launched on the autotune path")
    # one untimed solve of each path warms the caching allocator and loads
    # the PyTorch kernels the paths use
    run_solve("cg_merged", "27pt", RANK_BLOCK, True)
    run_solve("pcg_merged", "27pt", RANK_BLOCK, True, "chebyshev")
    run_solve("pcg_pipe", "27pt", RANK_BLOCK, True, "chebyshev")
    run_solve("pbicgstab_merged", "27pt", RANK_BLOCK, True, "chebyshev")
    runs, solves = {}, []
    for path, cases in (("main", MAIN_CASES), ("precond", PRECOND_CASES),
                        ("pipe", PIPE_CASES), ("bicgstab", BICGSTAB_CASES)):
        ops.reset_launches()                     # the path starts here
        runs[path] = phase_path(path, cases, solves)
        launches[path] = dict(ops.LAUNCHES)      # ...and ends here
    api_states = kernel_api_states()
    ops.reset_launches()                         # the kernel_api path starts here
    api_outs = drive_kernel_api(api_states)
    launches["kernel_api"] = dict(ops.LAUNCHES)  # ...and ends here
    runs["kernel_api"] = check_kernel_api(api_states, api_outs, launches["kernel_api"])
    del api_states, api_outs
    t_bf16 = time.perf_counter()
    bf16_inputs = kernel_api_bf16_inputs()
    ops.reset_launches()                         # the kernel_api_bf16 path starts here
    bf16_outs = drive_kernel_api_bf16(bf16_inputs)
    launches["kernel_api_bf16"] = dict(ops.LAUNCHES)  # ...and ends here
    runs["kernel_api_bf16"] = check_kernel_api_bf16(bf16_inputs, bf16_outs,
                                                    launches["kernel_api_bf16"])
    runs["kernel_api_bf16"]["phase_s"] = time.perf_counter() - t_bf16
    print(f"[kernel_api_bf16] the window and its checks took "
          f"{runs['kernel_api_bf16']['phase_s']:.2f}s")
    del bf16_inputs, bf16_outs
    graphed = phase_graphed(solves)
    del solves
    t_f32 = time.perf_counter()
    ops.reset_launches()                         # the precond_f32 path starts here
    f32_eager = drive_f32_precond()
    launches["precond_f32"] = dict(ops.LAUNCHES)  # ...and ends here
    runs["precond_f32"] = check_f32_precond(f32_eager, launches["precond_f32"])
    del f32_eager
    print(f"[precond_f32] the window and its checks took {time.perf_counter() - t_f32:.2f}s")
    ops.reset_launches()                         # the batched path starts here
    runs["batched"], batched_solves = phase_batched_path(BATCHED_CASES)
    launches["batched"] = dict(ops.LAUNCHES)     # ...and ends here
    check_batched(batched_solves)
    del batched_solves
    ops.reset_launches()                         # the resilience path starts here
    runs["resilience"] = phase_resilience()
    launches["resilience"] = dict(ops.LAUNCHES)  # ...and ends here
    walls, sessions = warm_walls(PROFILE_CASES + WALL_ONLY_CASES)
    profiles = []
    for m, p in PROFILE_CASES:
        eager = kernel_session(m, p, RANK_BLOCK)
        profiles.append(profile_solve(m, p, walls[(m, p)]["eager"], "eager", eager))
        profiles.append(profile_solve(m, p, walls[(m, p)]["graphed"], "graphed",
                                      sessions[(m, p)]))
    del sessions, eager
    batched_walls = batched_timings()
    t_serve = time.perf_counter()
    ops.reset_launches()                         # the serve path starts here
    serve_svc, serve_trace, served = phase_serve_stream()
    launches["serve"] = dict(ops.LAUNCHES)       # ...and ends here
    serve = check_serve(serve_svc, serve_trace, served, launches["serve"], batched_walls)
    del serve_svc, serve_trace, served
    serve["phase_s"] = time.perf_counter() - t_serve
    print(f"[serve] the phase took {serve['phase_s']:.2f}s; measured on {smi}")
    mesh = phase_distributed()                   # its counted windows are the ranks'
    launches["mesh"] = {k: sum(mesh[run]["launches"][k] for run in ("nccl_1", "gloo_2", "gloo_4"))
                        for k in ops.LAUNCHES}
    audited = phase_audit()                      # its counted windows are the ranks'
    launches["audit"] = {k: sum(audited[run]["launches"][k]
                                for run in ("nccl_1", "gloo_2", "gloo_4"))
                         for k in ops.LAUNCHES}
    mesh_batched = phase_mesh_batched()          # its counted windows are the ranks'
    launches["mesh_batched"] = mesh_batched["launches"]
    socket = phase_socket_block()
    resilience_walls = resilience_timings()
    sweep = k_sweep()
    attn_inputs = attention_inputs()
    bodies = {}
    ops.reset_launches()                         # the attention path starts here
    fa.reset_body_launches()
    attn_outs = drive_attention(attn_inputs)
    launches["attention"] = dict(ops.LAUNCHES)   # ...and ends here
    bodies["attention"] = dict(fa.BODY_LAUNCHES)
    ops.reset_launches()                         # the attention_mma path starts here
    fa.reset_body_launches()
    mma_outs = drive_attention_mma(attn_inputs)
    launches["attention_mma"] = dict(ops.LAUNCHES)   # ...and ends here
    bodies["attention_mma"] = dict(fa.BODY_LAUNCHES)
    ops.reset_launches()                         # the attention_ffma path starts here
    fa.reset_body_launches()
    ffma_outs = drive_attention_ffma(attn_inputs)
    launches["attention_ffma"] = dict(ops.LAUNCHES)  # ...and ends here
    bodies["attention_ffma"] = dict(fa.BODY_LAUNCHES)
    attention = check_attention(attn_inputs, attn_outs, mma_outs, ffma_outs, launches,
                                bodies, timer, peaks)
    del attn_inputs, attn_outs, mma_outs, ffma_outs
    split = attention_split(timer)
    del timer
    lm = phase_lm()
    train = phase_train()
    for name, (dt, body) in ATTENTION_ENTRIES.items():
        row = attention[("internlm2-1.8b", str(dt))]
        if body == "mma":
            row = dict(row, max_abs_err=row["mma_bf16_error"]["max_abs_err"],
                       ms=row["mma_ms"])
        elif body == "ffma":
            row = dict(row, max_abs_err=row["ffma_max_abs_err"], ms=row["ffma_ms"])
        rows[(name, "-", str(dt))] = row

    kernels = []
    for name, meta in KERNELS.items():
        if name in ATTENTION_ENTRIES:
            dt, body = ATTENTION_ENTRIES[name]
            row, n_launch = rows[(name, "-", str(dt))], bodies[meta["path"]][body]
        else:
            row = rows[(name, "-" if name in BODY_KERNELS else "27pt", str(torch.float64))]
            n_launch = launches[meta["path"]][name]
        check(n_launch > 0, f"{name} was not launched on the {meta['path']} path")
        kernels.append(dict(name=name, route="cuda", source=meta["source"],
                            replaces=meta["replaces"], launches=n_launch,
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"],
                            library_ms=row["library_ms"]))
    # every solver kernel's bf16 instance: its 128³ 27pt bf16 row (the
    # lane-batched forms' at B = BATCH), its launches in kernel_api_bf16
    for name, meta in KERNELS.items():
        if name in ATTENTION_ENTRIES:
            continue
        row = rows[(name, "-" if name in BODY_KERNELS else "27pt", str(torch.bfloat16))]
        n_launch = launches["kernel_api_bf16"][name]
        check(n_launch > 0, f"{name} was not launched in bf16 on the kernel_api_bf16 path")
        kernels.append(dict(name=f"{name}_bf16", route="cuda", source=meta["source"],
                            replaces=meta["replaces"], launches=n_launch,
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))

    # f32's two sweeps on the ring's pair stage: their 128³ 27pt f32 rows,
    # their launches in precond_f32
    for name in ("cheb_fused_step", "block_jacobi_sweep"):
        meta, row = KERNELS[name], rows[(name, "27pt", str(torch.float32))]
        n_launch = launches["precond_f32"][name]
        check(n_launch > 0, f"{name} was not launched in f32 on the precond_f32 path")
        kernels.append(dict(name=f"{name}_f32", route="cuda", source=meta["source"],
                            replaces=meta["replaces"], launches=n_launch,
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))

    record = dict(card=smi, kind=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, peaks=peaks,
                  kernels=[dict(name=k[0], stencil=k[1], dtype=k[2], **v)
                           for k, v in rows.items()],
                  batched_kernels=[dict(name=k[0], stencil=k[1], dtype=k[2], lanes=k[3], **v)
                                   for k, v in batched_kernels.items()],
                  batched_walls=batched_walls,
                  paths=runs, path_launches=launches, attention_bodies=bodies,
                  graphed=graphed,
                  warm_wall_ms_per_iter={f"{m}/{p}": v for (m, p), v in walls.items()},
                  socket_kernels=socket_kernels, profiles=profiles, socket_block=socket,
                  resilience_timings=resilience_walls, serve=serve, k_sweep=sweep,
                  distributed=mesh, audit=audited, mesh_batched=mesh_batched,
                  autotune=tuned,
                  attention=[dict(config=n, dtype=d, **v)
                             for (n, d), v in attention.items()],
                  attention_split=split, lm=lm, train=train)
    if args.record:
        path = Path(args.record)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
