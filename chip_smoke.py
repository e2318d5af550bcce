#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``mg_gcn_tpu_torch``.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, in order, each with its seconds; any failure exits non-zero before
the result line:

1. device — the card's name and power limit (nvidia-smi) and torch's name;
2. build  — nvcc builds the kernels from the sources in this checkout, one
   process per source, all at once; the host library
   (``native.py``, g++ -fopenmp) must build and load, its OpenMP threads
   logged;
3. kernels vs plain, n = 20,000 — each pattern kernel (fwd, bwd) x
   {bfloat16, float32, int8} x d in {41, 128} and PageRank's and SAGE's
   1, 512 and 608; ``edge`` in {bfloat16, float32} and ``edge_i8`` x d in
   {41, 128, 256} on a weighted graph; ``gather`` {weighted, binary,
   binary + bfloat16 stream} x d in {48, 100, 256, 1} at average degree 50; ``sddmm`` {bfloat16, float32,
   int8} x d in {1, 2, 16, 24, 32, 41, 48, 64, 128, 256} (every lane-group
   size of its rule but int8's L = 32) within the float32 sum bound of the
   plain version summed in float64, twice bit for bit, its launch geometry
   against ``sddmm_geometry``, ``sddmm_qskip`` on the same graph with 90% of
   its rows emptied (bitwise equal to ``sddmm``), ``edge_t`` {bfloat16,
   float32} x d in {2, 41, 64, 128}, ``block_fwd`` / ``block_bwd``
   {bfloat16, float32, int8} x d in {41, 128} on a banded graph with empty
   rows, an empty row block and an empty group (whose output rows must be 0)
   and ``tiled`` float32 x d in {41, 128} on the ELL path's Â — each against
   its plain PyTorch
   version on the card: float within rtol 1e-5 / atol 1e-6 of the output
   scale of the plain version summed in float64 (same rounded inputs; the
   reference does not move with the order of index_add_'s atomics), int8
   SpMM equal; each check logs the share of the tolerance it used; the
   CSR walk's narrow group sizes on tests/test_torch_port_cuda.py's hub
   graph (a row of degree 5,000, empty rows): ``edge`` {bfloat16, float32},
   ``edge_i8`` and ``edge_t`` {bfloat16, float32} at d_pad 8 and 16 within
   the float32 sum bound 4 sqrt(deg + 2) 2^-24 sum|terms| of the plain
   version summed in float64 (int8 equal), empty rows zero, two launches
   equal bit for bit; then
   (logged, ROADMAP queue 3 item 2) one float32 step of the main path's
   model on that banded graph through the block pair and through COO,
   each layer's output and gradient leaves held against the float64
   oracle tests/torch_oracle.py, and the block step against COO; the
   ``gather`` kernel at halo-block shapes: every block of partition 0 of a
   ``DistHaloGatherMat`` at P = 4 on cuda:0 (rectangular m_loc x w_s, w_s
   much below m_loc on a banded graph with an empty round and near it on a
   uniform one), weighted float32 at d_pad 8, 48, 104 and 256, within the
   float bound, two launches equal bit for bit; and the pair builder the
   later phases use (``normalized_pair_on_card``) equal to
   ``sparse.normalize`` + ``sparse.transpose`` bit for bit; and the f64 mode
   (``build_agg_pair(impl="xla", coo_val_dtype=np.float64)``, the COO
   engine's index_add_ in float64): one float64 step of the main path's
   model on random_graph(20,000, 64, seed=3) against the float64 oracle
   tests/torch_oracle.py fed the same Â (the float32 normalization
   widened), loss and every gradient leaf within 1e-12 relative, then 2
   ``train(f64=True)`` epochs launching no kernel of the port;
4. main path at full width — bench.py's uniform configuration
   (n = 232,968, random_graph(n, 493, seed=1) ~ 115M edges, 608 features,
   41 classes, sizes (608, 128, 128, 41), parity mode, Adam, seed-99 init)
   through ``train.build_agg_pair`` / ``train.train`` with impl="pattern"
   (``train.auto_engine`` must pick the binary CSR walk, "gather", for
   bfloat16 and float32 operands on this graph, 1 bit in 474 set, far below
   ``train.WALK_DENSITY_MAX``, and the pattern pair for int8, which the
   walk does not take;
   the pattern kernels stay on SAGE's, PageRank's, -P 4's and int8's
   paths); one float32 pattern step must agree
   with the COO engine (its pair built on the card; run with PyTorch's deterministic algorithms, so
   its sums, and the comparison, repeat from run to run) within rtol 1e-4: the loss, and every gradient leaf
   in norm, ||pattern - COO|| <= 1e-4 ||COO|| (element-wise, the two sum
   orders can put a near-zero pre-activation on either side of the
   LeakyReLU, which moves single elements by a step); both float32 steps
   are then held against the float64 oracle tests/torch_oracle.py run on
   the card (logged, ROADMAP queue 3 item 2); then 5
   bfloat16 epochs and 1 int8 epoch with finite losses. The kernels' launch
   counters are zeroed before this phase and read after it: exactly 3 fwd +
   2 bwd launches an epoch in each dtype; the bfloat16 epoch median is
   logged beside PERF.md's;
5. pattern kernels at the main-path shape — each kernel x dtype x width
   against its plain version again, timed with CUDA events beside its bound
   and beside torch.sparse.mm (float32; a yardstick the port never calls);
   each kernel launched twice must give the same bits, and its launch
   geometry (grid, threads, dynamic shared memory, row slices or stages,
   resident blocks an SM; ``pattern_bwd``'s lanes and groups besides, held
   to ``pattern_bwd_split``) is put in its kernels-line rows; the rest of
   ``pattern_bwd``'s geometry (features, loads, span words, column
   windows: the rule's and the kernel's constants) is only logged;
5a. the SAGE path — BASELINE config 4 as bench.py runs it (bench.py:
   239-263): SAGEConfig(sizes=(608, 512, 41)), l2-normalized, seed-99 init,
   on the main path's dataset through ``models.sage.build_sage_pair`` and
   ``train.make_train_step(model="sage")``: impl="auto" must pick the
   pattern pair, on phase 5's pack; one float32 step against the SAGE COO
   pair built on the card by the rule of phase 4; 5 bfloat16 epochs with
   losses falling from epoch 0 to 4 and 1 int8 epoch, their median and peak
   memory; counters zeroed before the float32 step and read after the int8
   epoch: exactly 2 ``pattern_bwd`` (d_pad 608, 512) + 1 ``pattern_fwd``
   (512) launches an epoch in each dtype; then the infer path's forward at
   full size, its argmax equal to the step's logits';
5b. pattern kernels at the SAGE path's shape — ``pattern_bwd`` at d = 608
   and 512 and ``pattern_fwd`` at 512, each dtype, as phase 5 (rows of the
   kernels line);
5s. the multi-epoch step — ``train.make_scan_train_steps`` (one CUDA graph
   of the step, captured once and replayed an epoch at a time) on phase
   5's pattern pair in bfloat16, int8 and float32 (the float32 backward
   walk at d_pad 128 one cooperative launch) and on SAGE's (phase 5a's
   model, bfloat16, the same pack): the route must be "graph"; 3 replayed
   epochs, on the capturing call and on a replay-only one, must equal 3
   eager ``make_train_step`` epochs from the same parameters bit for bit
   (losses, accuracies, parameters, Adam moments and step count). The
   wrappers count host launches only: the capturing call must count 2
   warm-up epochs' and the captured epoch's worth of each kernel,
   replay-only calls none; a traced replay-only call's kernel events must
   equal a traced eager call's name by name, and those the eager call's
   counted launches. One line each logs the warm-up and capture seconds,
   the per-epoch median of 3 replay calls and of 3 eager calls (3 steps,
   one read at the end), each traced call's device-busy share of its own
   traced window, and peak memory (phases 10 and 13s do the same for the
   ELL and GAT paths). It runs before 5f, whose trace then shows whether a
   profiler trace stays whole after a capture and replays;
5c. PageRank at Reddit scale (bench.py:333-373) — the main pack with the
   row scale, PatternMat "PT", "pre", float32, damping 0.85, eps 1e-4:
   iterations, cold and warm seconds, held against a COO PageRank on the
   card within rtol 1e-4 / atol 1e-5 (tests/test_pagerank.py's tolerance);
   exactly one ``pattern_fwd`` float32 d_pad 8 launch an iteration;
   ``pattern_fwd`` float32 at d = 1 as phase 5 (a kernels-line row);
5d. row-partitioned PageRank — ``pagerank_dist``'s two halves at -P 4,
   its partitions on cuda:0, on the main graph: the COO ring blocks built
   once (seconds logged), then ring and all_gather, each held against 5c's
   result within rtol 1e-4 / atol 1e-5, iterations and seconds logged;
5e. SAGE at -P 4 on one card — BASELINE config 4's widths (608 → 512 →
   41) on the main graph (232,968 = 4 x 58,242) through
   ``make_dist_sage_train_step`` on ``--impl halo``'s pair (``halo_engine``
   must take COO: expected fill 0.949) and ``--impl gather``'s
   (``DistGatherPair``) over (M, Mᵀ): one float32 step each against the
   single-card SAGE COO step by the rule of phase 4 (each also logged
   against the same step in float64), 3 epochs, median and
   peak memory; exactly 0 and 48 ``gather`` launches an epoch (16 at d_pad
   608, 32 at 512);
5f. phase timing of the main path — phase 4's bfloat16 step on the pattern
   pair ``build_agg_pair(impl="pattern")`` builds, through
   ``diagnostics.profile_fused_step`` (one warm step, 2 traced): the
   per-phase device ms an epoch (``xplane.attribute`` on the kept Chrome
   trace), the keys equal to the JAX package's named scopes for these
   sizes, each epoch's ``{l}_0_matmul-spmm`` scopes holding one
   ``pattern_fwd`` event each and ``{2,1}_1_matmul-spmm`` one
   ``pattern_bwd`` each, no pattern kernel unattributed; counters zeroed before and read after (3 epochs of 3 + 2
   launches, by width); logged: the unattributed share, the phase sum
   against the device's busy time and window, each SpMM scope against
   phase 5's isolated launch at its width;
5g. the main path on impl="auto" — phase 4's graph, model and sizes
   through ``build_agg_pair`` / ``train`` with impl="auto", which must
   build the binary gather pair (no weights): its float32 step against the
   COO engine by the rule of phase 4; 5 bfloat16 epochs with finite losses
   (logged beside phase 4's pattern-pair bfloat16 losses); counters zeroed
   before and read after: exactly the float32 step's 5 ``gather`` float32
   launches (3 at d_pad 128, 2 at 48) and 5 ``gather`` bfloat16 launches an
   epoch (the operand streamed in bfloat16: 3 at d_pad 128, 2 at 48), and
   no other kernel; peak memory and the pair's build seconds;
5h. gather kernel at the main path's shape — ``gather`` with a bfloat16
   operand on 5g's binary Âᵀ at d = 128 and 41 against its plain version,
   with the repeat check and walk geometry of phase 13, beside the bound
   and 5g's launches at that width (kernels-line rows);
6. the dist path — BASELINE's canonical ``-P 4 -R 1`` run (BASELINE.md:13)
   on the main path's dataset, sizes (608, 128, 128, 44) (41 classes round
   up to a multiple of P), its 4 partitions all on cuda:0, through
   ``parallel.dist``: the gate must take the pattern pair, built on the card
   (m_loc = 61,440, n_pad = 245,760; bytes and seconds logged); one float32
   fused step against the single-card pattern step from the same seed-99
   parameters by the rule of phase 4; 5 bfloat16 fused epochs with finite
   losses falling from epoch 0 to 4 and 1 int8 epoch, their median and peak
   memory; counters zeroed before the float32 step and read after the int8
   epoch: exactly 12 ``ring_fwd`` (d_pad 128, 128, 48) + 8 ``ring_bwd`` (48,
   128) launches an epoch and no other kernel; then one bfloat16 epoch each
   of the ``ring`` and ``all_gather`` exchanges, losses within rtol 1e-4 of
   the fused epoch 0;
7. ring kernels at the dist path's shape — partition 0's launch, each
   kernel x dtype x width as phase 5, beside torch.sparse.mm on the
   partition's slab of Pᵀ / P against the gathered operand; each kernel's
   repeat check and geometry as in phase 5;
6a. the column path — ``-P 4 -R 0`` on the main graph through
   ``parallel.dist_col``, its 4 partitions on cuda:0, every width rounded up
   to a multiple of P (608, 128, 128, 44): Âᵀ held once on the card (COO,
   built on the card as phase 4's); one float32 step (exact gradients) held
   against the single-card exact-mode COO step at the same sizes from the
   same seed-99 parameters, the loss within rtol 1e-5 and every gradient
   leaf ||column - one card|| <= 1e-4 ||one card||; then 3 float32 epochs
   with finite losses, their median and peak memory, launching no kernel
   of the port (the COO engine, as the JAX package's XLA product);
8. the banded path — bench.py's block-banded graph (bench.py:276-292, n =
   232,968, 493 draws a row in row ± 4096, ~111M edges) with the main path's
   features, labels and model: impl="auto" must pick the block pair (its
   occupancies, T and the store's bytes logged); one float32 step against
   COO by the rule of phase 4; 5 bfloat16 epochs with losses falling from
   epoch 0 to 4 and 1 int8 epoch; counters zeroed before and read after:
   exactly 3 ``block_fwd`` + 2 ``block_bwd`` launches an epoch in each
   dtype; build seconds, epoch median, peak memory; then (logged only) 5
   bfloat16 epochs each of the pattern pair and ``edge`` on the same graph,
   and the float32 step again with ``block_fwd_plain`` (float32, round to
   nearest) in the kernel's place, each step's gap to COO logged;
9. block kernels at the banded path's shape — as phase 5; ``block_fwd``
   (tensor cores over the live bit planes) launched twice must give the
   same bits, its geometry and the count of its dense products over the
   live planes (2 · live planes · 128 · tile_r · d_pad operations, three
   bf16 passes in float32) are put in its rows, and the lean of its float
   sums against the float64 sum is logged beside the plain version's; its
   float32 bound prices the operations as three bf16 passes; ``block_bwd``
   (the backward pattern walk over the store) launched twice must give the
   same bits, and its geometry goes in its rows as ``pattern_bwd``'s in
   phase 5 (lanes and groups held to ``block_bwd_split``), its L2 gather
   bytes nnz x d_pad x element size (computed) logged beside its bound;
10. the ELL path — ``train(impl="pallas")`` at the main path's widths on
   random_graph(20,000, 64, seed=3): one float32 step against COO, 5
   float32 epochs with exactly 5 ``tiled`` launches an epoch, K and the
   store's bytes logged; ``tiled`` at the path's widths as phase 5, with
   its repeat check and geometry as ``block_fwd``'s; the multi-epoch step
   on the path's pair as phase 5s, after 25 traces of its eager call that
   start and stop the profiler at once and 25 settled at both ends
   (``timers.settle_profiler``): the traces whose ``tiled`` events fall
   short of the launches counted in them logged, none allowed among the
   settled ones; and
   ``TiledMat.from_csr`` must refuse the main path's graph, as JAX's does;
11. GAT, card vs CPU — one float32 step of the GAT path's model on
   random_graph(20,000, 16, seed=3) on the card against the port's CPU
   path from the same seed-99 parameters: the loss within rtol 1e-5 and
   every gradient leaf ||card - CPU|| <= 1e-4 ||CPU||;
12. the GAT path — bench.py's GAT headline (bench.py:892-893):
   GATConfig(sizes=(64, 64, 41), heads=2) on the main path's graph with
   planted_features(labels, 64, noise=2.0, seed=8), through
   ``models.gat.build_gat_graph`` (bfloat16) and
   ``train.make_train_step(model="gat")``: the graph's build seconds, 5
   bfloat16 epochs from the seed-99 init with finite losses falling from
   epoch 0 to 4, their median, peak memory; counters zeroed before the
   epochs and read after: exactly 8 ``softmax_fwd`` + 4 ``softmax_bwd``
   (the edge softmax's walks, at d_pad 8) + 4 ``sddmm`` + 4 ``edge`` + 8
   ``edge_t`` (4 at d_pad 8) launches an epoch, by width;
13. attention kernels at the GAT path's shape — ``sddmm`` and
   ``sddmm_qskip`` x {bfloat16, float32, int8} and ``edge_t`` x {bfloat16,
   float32}, x d in {2, 41, 64} (the path's d_pad 8, 48 and 64), as phase
   5, beside torch.sparse.sampled_addmm (SDDMM) and torch.sparse.mm on the
   transposed CSR (``edge_t``), float32 yardsticks the port never calls;
   ``edge`` bfloat16 at the same widths; d = 128 (and for the SDDMMs
   256) is checked and logged, not put in the kernels line (no launch of
   the path has it); ``sddmm`` within the float32 sum bound as in phase
   3; ``sddmm``, ``edge`` and ``edge_t`` launched twice must give the same
   bits, and the launch geometry as the card reports it (grid, threads,
   dynamic shared memory, resident blocks an SM) goes in their rows, as in
   phases 15 and 17 (``edge`` and ``edge_t`` with the walk's lanes and
   groups a warp); the SDDMM's lanes, groups, entries a group scores at
   once, features a lane loads and the tree's shuffles a batch (held to
   the rule) and its L2 gather bytes nnz x d_pad x element size (computed)
   are logged beside its bound, not put in the line; then the edge
   softmax's fused walks, ``softmax_fwd`` and ``softmax_bwd`` (port-only
   kernels, logged only) in bfloat16 and float32, each launched twice for
   the same bits, held element by element to its plain version on the card
   (each entry's gradient within one ulp), the gradient's row sums and its
   column sums through ``edge_t`` within the float32 sum bound, and timed
   beside its bytes bound;
13s. the multi-epoch step on the GAT path — phase 12's model and attention
   graph as phase 5s; where two eager runs of the step differ, the
   replayed epochs are held within rtol 1e-5 of the eager ones and the
   line says so;
12a. the GAT path at -P 4 on one card — phase 12's model on the main graph
   (232,968 = 4 x 58,242), its 4 partitions on cuda:0, through
   ``parallel.dist_gat``: one float32 step against the single-card float32
   GAT step from the same seed-99 parameters (loss within rtol 1e-5, every
   gradient leaf within 1e-4 of its norm); the bfloat16 ring blocks' build
   seconds and entries per block; 5 bfloat16 epochs with finite losses
   falling from epoch 0 to 4, their median and peak memory; counters zeroed
   before the epochs and read after: per head, layer and block with
   entries, exactly 6 ``sddmm`` + 5 ``edge`` + 2 ``edge_t`` launches an
   epoch (384 + 320 + 128 at 16 blocks), by width; then one more epoch
   under torch.profiler, its device time by kernel (logged, as phase 12);
13a. attention kernels at the -P 4 GAT path's ring blocks — partition 0's
   diagonal and round-1 blocks (58,242 x 58,242): ``sddmm`` {bfloat16,
   float32} x d in {1, 2, 41, 64}, ``edge`` bfloat16 x {1, 41, 64} and
   ``edge_t`` {bfloat16, float32} x {2, 41, 64}, each against its plain
   version with the repeat check, timed beside its bound and beside
   torch.sparse.sampled_addmm / torch.sparse.mm on the same block (rows of
   the kernels line, with phase 12a's launches at that width and the
   block's own an epoch); then an empty block through the three ops: zeros,
   no launch;
14. path A, weighted Reddit on the edge engine — the same graph with
   bench.py's edge values (rng(5).random + 0.5): auto must pick ``edge``;
   one float32 step against the COO engine by the rule of phase 4; 5
   bfloat16 epochs and 1 int8 epoch with finite losses; counters zeroed
   before and read after: exactly 5 ``edge`` launches an epoch (float32,
   bfloat16) and 5 ``edge_i8`` in the int8 epoch;
15. edge kernels at path A's shape — as phase 5, on path A's Âᵀ, with the
   repeat check and walk geometry of phase 13, then (logged only)
   ``gather`` on the same matrix;
16. path B, products scale on the gather engine — BASELINE config 2's model
   (100 features, 48 classes, sizes (100, 256, 256, 48)) on bench.py's
   uniform products graph, random_graph(2,449,029, 50, seed=3): auto must
   pick ``gather`` (the binary pair); the float32 step's phase times
   logged as in phase 5f (one warm, 2 traced epochs); one float32 step
   against the COO engine; 5 epochs with finite losses and exactly 5
   ``gather`` launches an epoch; peak memory and the pair's build seconds
   (host normalize and transpose through the host library);
16a. BASELINE config 2 at -P 4 on one card — path B's graph padded with 3
   empty rows and columns to n = 2,449,032, its 4 partitions on cuda:0, the
   model of phase 16 (no shape cut): ``train.dist_engine`` under auto must
   take the halo pair on the gather kernel; ``DistHaloPair`` built on the
   card (round widths, moved against useful rows logged); one float32 step
   against the single-card COO step on the padded graph by the rule of
   phase 4; 5 float32 epochs, their median and peak memory; exactly 5 SpMMs
   x 4 partitions x 4 blocks = 80 ``gather`` launches an epoch, by width
   (16 at d_pad 104, 32 at 256, 32 at 48); then ``--impl gather``'s pair
   (``DistGatherPair``, the ring) the same way;
17. gather kernel at path B's shape — as phase 5, on path B's Aᵀ, with the
   repeat check and walk geometry of phase 13, then (logged only) ``edge``
   on the same matrix; and at phase 16a's partition 0 halo blocks (the
   diagonal and round 0's, weighted) at d = 256, 100 and 48, beside the
   bound and torch.sparse.mm on the same block, with the path's launches an
   epoch at that width;
17a. PageRank at products scale (bench.py:739-775) — path B's gather
   matrix with its scale swapped to a pre-scale of 1/max(outdeg, 1):
   iterations and seconds, held against a COO PageRank on the card as in
   5c; exactly one ``gather`` float32 d_pad 8 launch an iteration;
   ``gather`` float32 at d = 1 as phase 17 (a kernels-line row);
18. CLI — ``python -m mg_gcn_tpu_torch.cli -E 3 train <dir> 2 128 128`` and
   ``... --model gat --heads 2 -E 3 train <dir> 1 16`` on a small binary
   dataset; ``python -m mg_gcn_tpu_torch.data.prep synthetic`` (n = 20,000)
   and ``prep cluster`` (RCM), then ``--impl block`` and ``--impl pallas``
   ``-E 3 train <dir>_clustered 1 16``, and ``-P 4 -R 1 --device
   cuda:0,cuda:0,cuda:0,cuda:0 -E 3 train <dir> 2 128 128``: stderr lines
   and the timer CSVs; ``--model sage -E 3 train <dir> 1 16 --save CK``,
   ``--model sage infer <dir> 1 16 --load CK`` and ``pagerank <dir>``, at
   -P 1 and at -P 4 on one card: the files they write equal the library's
   results on the same inputs; at -P 4 on one card, ``train`` of a weighted
   copy of the dataset under auto (the halo pair: the JAX CLI's ``halo
   local engine`` and ``halo exchange`` lines, the moved rows the library's),
   ``--impl gather`` and ``--model sage --impl halo``; ``--time-phases``
   (``phase_`` rows of the JAX package's scopes, no fallback line),
   ``--profile DIR`` (a Chrome trace naming the CSR walk kernel) and
   ``--f64`` (the COO engine) on the toy dataset; at -P 4 on one card
   ``-R 1 --model gat --heads 2 train <dir> 1 16`` and ``-R 0 train <dir> 2
   128 128 --save CK``: their epoch lines equal the library's steps on the
   same inputs (GAT within rtol 1e-5; the column path within rtol 1e-4, its
   COO sums in another order each run), the column checkpoint the full
   rounded arrays. The CLI processes run six at a time, each with a CSV
   directory of its own, their checks in this order.

19. multi-process halo — BASELINE config 3's widths at -P 2 across two
   processes, both on cuda:0 (MG_GCN_LOCAL_DEVICE_IDS=0): a papers100M-like
   graph (scripts/papers_rehearsal.py:33-60's geometry, n = 8,388,608, 15
   draws a row, about 126M entries; 128 features, 172 labels) drawn on the
   card and written in the reference formats under chiprun_out/ (removed
   after the phase), graph_t.bin by ``ensure_pigo_transpose``; two
   processes of ``cli --multihost -P 2 -R 1 --impl halo --mmap -E 2 train
   <dir> 3 128 128 128`` (each reading its row slabs of graph.bin and
   graph_t.bin) and the same command in one process at -P 2: both workers
   exit 0, each prints the route line "staged through host over gloo" and
   the halo pair on the gather engine, and the (loss, acc) columns of both
   processes equal the one-process run's bit for bit. Logged beside the
   card's name and power limit: epoch and set-up seconds, each process's
   peak card memory and host RSS, the halo rows moved against the useful
   ones, the bytes sent to the other process an epoch and the share of the
   epochs spent in the exchange helpers. Process 0 checks ``gather`` at its
   partition's diagonal and round-0 blocks of Âᵀ at d = 128 against the plain
   version summed in float64 (rows of the kernels line, with its launches
   at that width over its run). Then ``--model sage`` at -P 2 on
   random_graph(262,144, 16) across two processes, bit for bit with one
   process, and a world of one process on the NCCL route (one all-gather,
   one hop to itself).

20. the paths whose exchanges carry gradients, across the same two
   processes on cuda:0 (staged route): the main graph written under
   chiprun_out/ after phase 13a (removed after the phase) as two datasets
   sharing one graph.bin, GAT's 64 planted features and the main path's
   608. GAT: ``cli --multihost -P 2 -R 1 --model gat --heads 2 -E 3 train
   <dir> 1 64`` (phase 12's model, the last width rounded to 42; 2 x 2
   bfloat16 ring blocks of 116,484²) in two processes and at -P 2 in one:
   both exit 0 with the route line, their (loss, acc) columns equal the
   one process's bit for bit (or, only where a second one-process run
   differs from the first, within rtol 1e-5, said so on the line), and
   each process launches exactly phase 12a's count for its blocks an
   epoch; process 0 then checks ``sddmm``, ``edge`` and ``edge_t`` at its
   diagonal and round-1 blocks as phase 13a does (rows of the kernels
   line, with its launches over its run). The column path: ``cli
   --multihost -P 2 -R 0 -E 3 --save CK train <dir> 2 128 128`` (sizes
   (608, 128, 128, 42)) in two processes and in one, all under PyTorch's
   deterministic algorithms (the COO engine's index_add_ in a fixed
   order): the columns bit for bit, no kernel of the port launched, process
   0's checkpoint (the full rounded arrays) equal to the one process's and
   none from process 1. Logged for each beside the card's name and power
   limit: epoch and set-up seconds, two processes and one, each process's
   peak card memory and host RSS, the bytes sent to the other process an
   epoch and the exchange helpers' share of the epochs.

Then, each on its own line: the ``{"kernels": [...]}`` JSON, the
nvidia-smi name and power limit, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

N_MAIN, DEG_MAIN, FEATURES, CLASSES, HIDDEN = 232_968, 493, 608, 41, [128, 128]
N_SMALL, DEG_SMALL = 20_000, 64
WIDTHS = (41, 128)
DTYPES = ("bfloat16", "float32", "int8")
EPOCHS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}  # dense, no sparsity
KERNELS = {
    "pattern_fwd": "mg_gcn_tpu/ops/spmm_pattern.py:265",
    "pattern_bwd": "mg_gcn_tpu/ops/spmm_pattern.py:280",
    "edge": "mg_gcn_tpu/ops/spmm_edges.py:550",
    "edge_i8": "mg_gcn_tpu/ops/spmm_edges.py:604",
    "gather": "mg_gcn_tpu/ops/spmm_gather.py:499",
    "sddmm": "mg_gcn_tpu/ops/sddmm.py:123",
    "sddmm_qskip": "mg_gcn_tpu/ops/sddmm.py:61",
    "edge_t": "mg_gcn_tpu/ops/spmm_edges.py:980",
    "block_fwd": "mg_gcn_tpu/ops/spmm_pattern_sparse.py:366",
    "block_bwd": "mg_gcn_tpu/ops/spmm_pattern_sparse.py:392",
    "tiled": "mg_gcn_tpu/ops/spmm_pallas.py:161",
    "ring_fwd": "mg_gcn_tpu/ops/spmm_pattern_ring.py:128",
    "ring_bwd": "mg_gcn_tpu/ops/spmm_pattern_ring.py:204",
}
SOURCES = {"pattern_fwd": "spmm_pattern.cu", "pattern_bwd": "spmm_pattern.cu", "edge": "spmm_edges.cu",
           "edge_i8": "spmm_edges.cu", "gather": "spmm_gather.cu", "sddmm": "sddmm.cu", "sddmm_qskip": "sddmm.cu",
           "edge_t": "spmm_edges.cu", "block_fwd": "spmm_pattern_sparse.cu", "block_bwd": "spmm_pattern_sparse.cu",
           "tiled": "spmm_tiled.cu", "ring_fwd": "spmm_pattern_ring.cu", "ring_bwd": "spmm_pattern_ring.cu"}
# path A: bench.py's weighted section (edge values rng(5).random + 0.5 on
# the main path's graph); path B: BASELINE config 2's model on bench.py's
# uniform products-scale graph (bench.py:586, 607, 623)
EDGE_WIDTHS, GATHER_WIDTHS = (41, 128, 256), (48, 100, 256)
N_PROD, DEG_PROD, FEATURES_PROD, CLASSES_PROD, HIDDEN_PROD = 2_449_029, 50, 100, 48, [256, 256]
DEG_GATHER_SMALL = 50
# the GAT path: bench.py's GAT headline (bench.py:892-893), GATConfig(sizes=
# (64, 64, 41), heads=2) on the main path's graph with planted_features(
# labels, 64, noise=2.0, seed=8); its kernels' widths: d = 1 and 2 (d_pad
# 8), the output layer's 41 (d_pad 48) and the hidden layer's 64. d = 128
# (and for the SDDMM 256, its rows walked in chunks in float32) is checked
# and logged besides, outside the kernels line.
GAT_SIZES, GAT_HEADS, GAT_WIDTHS, ATT_EXTRA_WIDTHS = (64, 64, CLASSES), 2, (2, 41, 64), (128,)
SDDMM_EXTRA_WIDTHS = ATT_EXTRA_WIDTHS + (256,)
# the SDDMM's checks at n = 20,000: every lane-group size of its rule
# (ops/sddmm.sddmm_geometry) in each dtype but int8's L = 32 (d_pad > 256)
SDDMM_SMALL_WIDTHS = (1, 2, 16, 24, 32, 41, 48, 64, 128, 256)
DEG_GAT_CPU = 16  # the card-vs-CPU step's graph: random_graph(N_SMALL, 16, seed=3)
# the banded path: bench.py's block-banded graph (bench.py:276-292), 493 draws
# a row in row ± 4096, rng(7), on the main path's model; the small banded
# graph of phase 3 draws 64 a row in row ± 1024
BAND_HALF, BAND_SEED, BAND_SMALL_DRAWS, BAND_SMALL_HALF = 4096, 7, 64, 1024
# the dist path: BASELINE's canonical -P 4 -R 1 run (BASELINE.md:13) on the
# main path's dataset, its 4 partitions on one card; the last width rounds
# up to a multiple of P (main.cpp:135): 41 -> 44, d_pad 48
DIST_PARTS = 4
DIST_CLASSES = -(-CLASSES // DIST_PARTS) * DIST_PARTS
DIST_WIDTHS = (128, DIST_CLASSES)
# the SAGE path: BASELINE config 4 as bench.py runs it (bench.py:239-263),
# SAGEConfig(sizes=(608, 512, 41)), l2-normalized, on the main path's dataset
# and pack. Its launches: pattern_bwd at d = 608 (layer 0's M·X) and 512
# (layer 1's M·H), pattern_fwd at 512 (layer 1's Mᵀ·G); layer 0's M·X takes
# no gradient. PageRank (bench.py:333-373, 739-775): damping 0.85, eps 1e-4,
# float32, d = 1 (d_pad 8), on the main pack and on path B's gather matrix.
SAGE_SIZES = (FEATURES, 512, CLASSES)
SAGE_WIDTHS = (("pattern_bwd", 608), ("pattern_bwd", 512), ("pattern_fwd", 512))
PR_SAGE_WIDTHS = (1, 512, 608)  # phase 3 checks both pattern kernels at PageRank's and SAGE's widths
DAMPING, PR_EPS = 0.85, 1e-4
# the -P 4 products path (phase 16a): path B's graph padded with empty rows
# and columns to a multiple of 4 partitions; phase 3 checks the gather kernel
# at halo-block shapes at d_pad 8, 48, 104 and 256
N_PROD_DIST = -(-N_PROD // DIST_PARTS) * DIST_PARTS
HALO_SMALL_WIDTHS = (8, 48, 104, 256)
# the GAT path at -P 4 (phase 12a): phase 12's model on the main graph, its 4
# partitions on cuda:0 (232,968 = 4 x 58,242); phase 13a checks its kernels at
# partition 0's diagonal and round-1 blocks at these widths
DIST_GAT_SDDMM_WIDTHS, DIST_GAT_EDGE_WIDTHS, DIST_GAT_EDGE_T_WIDTHS = (1, 2, 41, 64), (1, 41, 64), (2, 41, 64)
# the column path (phase 6a): -P 4 -R 0 on one card rounds every width up to a
# multiple of P (mg_gcn_tpu/cli.py:267-273): (608, 128, 128, 44)
COL_SIZES = tuple(-(-s // DIST_PARTS) * DIST_PARTS for s in (FEATURES, *HIDDEN, CLASSES))
COL_EPOCHS = 3
# phase timing (phases 5f and 16): traced epochs after one warm step, and
# the port's kernels by a piece of their device event names
PHASE_EPOCHS = 2
KERNEL_EVENTS = (("pattern_fwd_kernel", "pattern_fwd"), ("PackArgs", "pattern_bwd"), ("csr::walk_kernel", "csr walk"))
# every kernel of the port by a piece of its device event name, with the
# wrappers that launch it (phase 5s counts a replayed graph's kernels so)
PORT_KERNEL_EVENTS = (("pattern_fwd_kernel", ("pattern_fwd",)), ("ring_fwd_kernel", ("ring_fwd",)),
                      ("block_fwd_kernel", ("block_fwd",)), ("TileArgs", ("block_bwd",)),
                      ("PackArgs", ("pattern_bwd", "ring_bwd")),
                      ("csr::walk_kernel", ("edge", "edge_i8", "edge_t", "gather")),
                      ("sddmm_kernel", ("sddmm", "sddmm_qskip")), ("tiled_kernel", ("tiled",)),
                      ("edge_softmax::", ("softmax_fwd", "softmax_bwd")))
FALLBACK_LINE = "no device trace; falling back to un-fused phase replay"
# phase 19: BASELINE config 3 ("edge-partitioned across 2 hosts with halo
# exchange") as two processes on one card: a papers100M-like graph
# (scripts/papers_rehearsal.py:33-60's geometry: 80% of a row's draws in
# row ± 2000, 20% uniform, self loops, duplicates merged) of 2^23 rows and 15
# draws a row (about ogbn-products' 126M entries: papers100M's 111M rows cut
# to a run's time), papers100M's widths (128 features, 172 labels, three
# hidden layers of 128), -P 2 -R 1 --impl halo --mmap, 3 epochs; the gather
# kernel checked at d = 128; a small SAGE run (random_graph(2^18, 16)) the
# same way
MH_N, MH_DEG, MH_BAND, MH_FAR = 8_388_608, 15, 2000, 0.2
MH_FEATURES, MH_CLASSES, MH_HIDDEN, MH_PARTS, MH_EPOCHS = 128, 172, (128, 128, 128), 2, 3
MH_KERNEL_D, MH_SAGE_N, MH_SAGE_DEG, MH_TIMEOUT_S = 128, 262_144, 16, 600
# phase 20: the paths whose exchanges carry gradients, across the same two
# processes on cuda:0: phase 12's GAT model (the last width rounds up to 42
# at -P 2) and phase 6a's column path at -P 2, sizes (608, 128, 128, 42), on
# the main graph (232,968 = 2 x 116,484), 3 epochs each
MH2_EPOCHS = 3
MH2_GAT_SIZES = (GAT_SIZES[0], GAT_SIZES[1], -(-CLASSES // MH_PARTS) * MH_PARTS)
MH2_COL_SIZES = tuple(-(-s // MH_PARTS) * MH_PARTS for s in (FEATURES, *HIDDEN, CLASSES))


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of ``fn`` over ``reps`` calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def operand(n_pad: int, d: int, dtype: str, seed: int) -> torch.Tensor:
    """A padded kernel operand (n_pad, d_pad) as the wrapper would pass it."""
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.zeros((n_pad, sp.round_up(max(d, 8), 8)), device="cuda", dtype=sp.DTYPES[dtype])
    if dtype == "int8":
        b[:, :d] = torch.randint(-127, 128, (n_pad, d), device="cuda", generator=gen).to(torch.int8)
    else:
        b[:, :d] = torch.randn((n_pad, d), device="cuda", generator=gen).to(b.dtype)
    return b


def check_close(kind: str, got: torch.Tensor, want: torch.Tensor, dtype: str) -> tuple[float, float]:
    """(max |got - want|, share of the tolerance used); raises past it.

    ``want`` is the plain version's result: summed exactly (int64) for int8,
    which must be equal, and in float64 for a float kernel, so that the
    reference does not move with the order of CUDA ``index_add_``'s atomics
    from run to run. A float kernel is held within rtol 1e-5 / atol 1e-6 of
    the output's scale: its inputs are the reference's, rounded the same
    way, and only its float32 sums differ. The share used is the largest
    |got - want| / (1e-5 |want| + 1e-6 scale) over the elements."""
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if dtype == "int8":
        if err != 0.0:
            raise AssertionError(f"{kind}: int8 result differs from the plain version by {err}")
        return err, 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    use = float((diff / (1e-5 * want.double().abs() + 1e-6 * scale)).max()) if err else 0.0
    if not use <= 1.0:
        raise AssertionError(f"{kind}: {use:.3f} of the tolerance rtol 1e-5 / atol 1e-6 x {scale} used")
    return err, use


def phase_kernels_small() -> None:
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    g = sparse.random_graph(N_SMALL, DEG_SMALL, seed=3)
    fwd, _ = sp.pattern_pair_from_binary_csr(g, device="cuda")
    for name, kernel, plain in (("pattern_fwd", sp.pattern_fwd, sp.pattern_fwd_plain),
                                ("pattern_bwd", sp.pattern_bwd, sp.pattern_bwd_plain)):
        for dtype in DTYPES:
            for d in WIDTHS + PR_SAGE_WIDTHS:
                b = operand(fwd.n_pad, d, dtype, seed=d)
                got = kernel(fwd.pack, b)
                torch.cuda.synchronize()
                err, use = check_close(f"{name} {dtype} d={d}", got, plain(fwd.pack, b, torch.float64), dtype)
                ms = cuda_ms(lambda: kernel(fwd.pack, b), 10)
                plain_ms = cuda_ms(lambda: plain(fwd.pack, b), 3)
                log(f"  {name} {dtype:8s} d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f})"
                    f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")


def small_banded_graph():
    """A banded graph at n = 20,000 (BAND_SMALL_DRAWS draws a row in row ±
    BAND_SMALL_HALF) with every tenth row empty, an empty row block (rows
    4096-4607) and an empty group (columns 8192-12287)."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import CSRData

    g = sparse.banded_graph(N_SMALL, BAND_SMALL_DRAWS, BAND_SMALL_HALF, seed=BAND_SEED)
    rows = np.repeat(np.arange(N_SMALL), np.diff(g.indptr))
    keep = (rows % 10 != 0) & ((rows < 4096) | (rows >= 4608)) & ((g.indices < 8192) | (g.indices >= 12288))
    indptr = np.zeros(N_SMALL + 1, np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=N_SMALL), out=indptr[1:])
    return CSRData(indptr, g.indices[keep], g.data[keep], g.shape)


def phase_block_kernels_small() -> None:
    """block_fwd / block_bwd x {bfloat16, float32, int8} x WIDTHS on the
    small banded graph, and tiled (float32) x WIDTHS on the ELL path's Â of
    random_graph(N_SMALL, DEG_SMALL, seed=3), each against its plain version
    summed in float64; the rows no tile reaches must come out 0."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.ops import spmm_pallas as tpl
    from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps

    fwd, _ = sps.block_pattern_pair_from_binary_csr(small_banded_graph(), device="cuda")
    log(f"  small banded graph: {fwd.num_tiles} tiles, tile occupancy {fwd.occupancy:.3f},"
        f" plane occupancy {fwd.plane_occ:.3f}")
    for name, kernel, plain, empty in (("block_fwd", sps.block_fwd, sps.block_fwd_plain, slice(8192, 12288)),
                                       ("block_bwd", sps.block_bwd, sps.block_bwd_plain, slice(4096, 4608))):
        for dtype in DTYPES:
            for d in WIDTHS:
                b = operand(fwd.n_pad, d, dtype, seed=d)
                got = kernel(fwd, b)
                torch.cuda.synchronize()
                if got[empty].any():
                    raise AssertionError(f"{name} {dtype} d={d}: rows {empty} no tile reaches are not 0")
                err, use = check_close(f"{name} {dtype} d={d}", got, plain(fwd, b, torch.float64), dtype)
                ms = cuda_ms(lambda: kernel(fwd, b), 10)
                plain_ms = cuda_ms(lambda: plain(fwd, b), 3)
                log(f"  {name} {dtype:8s} d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f})"
                    f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")
    a = sparse.normalize(sparse.random_graph(N_SMALL, DEG_SMALL, seed=3), axis=True)
    mat = tpl.TiledMat.from_csr(a, device="cuda")
    for d in WIDTHS:
        b = operand(mat.n_cb * mat.bc, d, "float32", seed=d)[:, :d].contiguous()
        (err, use), ms, plain_ms = check_and_time(
            f"tiled d={d}", lambda: tpl.tiled(mat, b), lambda: tpl.tiled_plain(mat, b, torch.float64), "float32",
            10, lambda: tpl.tiled_plain(mat, b), 3)
        log(f"  tiled   float32  d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f})"
            f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms (K = {mat.ell_k})")


def phase_block_layers_small() -> None:
    """ROADMAP queue 3 item 2, the block half: one float32 step of the main
    path's model (608 -> 128 -> 128 -> 41, seed-99 init) on the small banded
    graph, with planted features and labels from seed 5, through the block
    pair and through the COO engine, each held layer by layer against the
    float64 oracle ``tests/torch_oracle.py`` (the reference's semantics,
    independent of the port's code) on the same parameters: every layer's
    output and every gradient leaf, ||engine - oracle|| / ||oracle||; then
    the block step against COO by the rule of phase 4. Logged; phase 8
    holds the full-size step to its limit."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_oracle

    from mg_gcn_tpu_torch.models.gcn import GCNConfig, forward, init_params, loss_and_grad
    from mg_gcn_tpu_torch.train import build_agg_pair

    g = small_banded_graph()
    rng = np.random.default_rng(5)
    labels = rng.integers(0, CLASSES, N_SMALL)
    proj = rng.standard_normal((CLASSES, FEATURES)).astype(np.float32)
    x_np = proj[labels] + 10.0 * rng.standard_normal((N_SMALL, FEATURES)).astype(np.float32)
    dev = torch.device("cuda")
    config = GCNConfig(sizes=(FEATURES, *HIDDEN, CLASSES))
    params = init_params(config, device=dev)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(labels).to(dev)

    def step(pair):
        with torch.no_grad():
            caches = forward(params, pair, x, config, return_caches=True)[1]
        return [c["post"].double().cpu() for c in caches], loss_and_grad(params, pair, x, y, config)

    block = step(build_agg_pair(g, impl="block", pattern_dtype="float32", device=dev))
    with deterministic():
        coo = step(coo_pair_on_card(g))
    # the oracle's Â (column-normalized, main.cpp:143) and Âᵀ in float64 on the host
    cols = g.indices.astype(np.int64)
    vals = 1.0 / np.bincount(cols, minlength=g.ncols).astype(np.float64)[cols]
    rows = np.repeat(np.arange(g.nrows), np.diff(g.indptr))
    a_hat = torch.sparse_coo_tensor(np.stack([rows, cols]), vals, g.shape).coalesce()
    a_hat_t = a_hat.t().coalesce()
    ref_params = [{"W": p_["W"].double().cpu(), "b": p_["b"].reshape(-1).double().cpu()} for p_ in params]
    acts, loss_ref, _, grads_ref = torch_oracle.run_parity(a_hat, a_hat_t, ref_params, x_np, labels)
    rel = lambda got, want: float(torch.linalg.vector_norm(got.double().cpu().reshape(want.shape) - want)  # noqa: E731
                                  / torch.linalg.vector_norm(want))
    for i in range(len(params)):
        line = f"  layer {i}: output"
        for name, (posts, _) in (("block", block), ("COO", coo)):
            line += f" {name} {rel(posts[i], acts[i]):.3e}"
        for k in ("W", "b"):
            line += f"; grad {k}"
            for name, (_, (_, _, grads)) in (("block", block), ("COO", coo)):
                line += f" {name} {rel(grads[i][k], grads_ref[i][k]):.3e}"
        log(line + "  (||f32 - f64 oracle|| / ||oracle||)")
    log(f"  loss: block {float(block[1][0])!r}, COO {float(coo[1][0])!r}, oracle {loss_ref!r}")
    compare_with_coo("block", block[1], coo[1])


def main_dataset():
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset

    t0 = time.perf_counter()
    g = sparse.random_graph(N_MAIN, DEG_MAIN, seed=1)
    # bench.py's uniform labels and planted features (sparse.planted_features)
    labels = np.random.default_rng(0).integers(0, CLASSES, N_MAIN).astype(np.int32)
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((CLASSES, FEATURES)).astype(np.float32)
    x = proj[labels] + 10.0 * rng.standard_normal((N_MAIN, FEATURES)).astype(np.float32)
    ds = Dataset(graph=g, features=x, labels=labels.reshape(-1, 1), sets=np.zeros((N_MAIN, 1), np.int32))
    log(f"  graph n={g.nrows} nnz={g.nnz} built in {time.perf_counter() - t0:.1f} s")
    return ds


def wrappers() -> dict:
    """Every kernel wrapper of the port, by the name the kernels line uses."""
    from mg_gcn_tpu_torch.ops import spmm_edges as se
    from mg_gcn_tpu_torch.ops import spmm_gather as sg
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    from mg_gcn_tpu_torch.ops import edge_softmax as esm
    from mg_gcn_tpu_torch.ops import sddmm as sd
    from mg_gcn_tpu_torch.ops import spmm_pallas as tpl
    from mg_gcn_tpu_torch.ops import spmm_pattern_ring as ring
    from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps

    return {"pattern_fwd": sp.pattern_fwd, "pattern_bwd": sp.pattern_bwd, "edge": se.edge,
            "edge_i8": se.edge_i8, "gather": sg.gather, "sddmm": sd.sddmm, "sddmm_qskip": sd.sddmm_qskip,
            "edge_t": se.edge_t, "block_fwd": sps.block_fwd, "block_bwd": sps.block_bwd, "tiled": tpl.tiled,
            "ring_fwd": ring.ring_pattern_fwd, "ring_bwd": ring.ring_pattern_bwd,
            "softmax_fwd": esm.softmax_fwd, "softmax_bwd": esm.softmax_bwd}


def counts() -> dict:
    return {name: dict(fn.launches) for name, fn in wrappers().items()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches.clear()


def per_dtype(c: dict, name: str, dtype: str) -> int:
    return sum(v for (dt, _), v in c[name].items() if dt == dtype)


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms, on for the COO step only: CUDA
    index_add_ (the COO engine's sum) then adds in a fixed order instead of
    by atomics, so the COO step, and the comparison against it, comes out
    the same in every run. warn_only: ops without a deterministic variant
    run as they are."""
    prev = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def normalized_on_card(graph, gcn: bool | None):
    """(rows, cols, vals) of ``graph``'s entries on the card in its CSR
    order, rows and columns int32, the values float32 with the arithmetic
    of ``sparse.normalize``: GCN (``gcn``) Â = A / column sums (float64
    sums, a float64 divide, main.cpp:143), SAGE M = A / row sums (float64
    sums rounded to float32, a float32 divide); ``gcn=None`` ones (the
    pattern, torch.sparse.mm's operand in the kernels lines). Built under
    :func:`deterministic`, so the sums repeat from run to run; held equal
    to ``sparse.normalize`` in phase 3 (:func:`normalized_pair_on_card`)."""
    with deterministic():
        cols = torch.from_numpy(graph.indices).cuda()
        counts = torch.from_numpy(np.diff(graph.indptr)).cuda()
        rows = torch.repeat_interleave(torch.arange(graph.nrows, dtype=torch.int32, device="cuda"), counts)
        del counts
        if gcn is None:
            return rows, cols, torch.ones(graph.nnz, device="cuda")
        data = torch.from_numpy(graph.data).cuda().float()
        if gcn:
            col_sum = torch.zeros(graph.ncols, dtype=torch.float64, device="cuda").index_add_(0, cols, data.double())
            return rows, cols, (data.double() / col_sum[cols.long()]).float()
        row_sum = torch.zeros(graph.nrows, dtype=torch.float64, device="cuda").index_add_(0, rows, data.double())
        return rows, cols, data / row_sum.float()[rows.long()]


def transpose_on_card(rows, cols, vals, shape):
    """(indptr, indices, vals) of the transpose of the (rows, cols, vals)
    matrix of ``shape`` as a CSR on the card: one sort of (column, row)
    keys, which for distinct entries is the order of ``sparse.transpose``'s
    stable counting sort."""
    n_rows, n_cols = shape
    key, order = torch.sort(cols.long() * n_rows + rows)
    indptr = torch.zeros(n_cols + 1, dtype=torch.int64, device="cuda")
    indptr[1:] = torch.cumsum(torch.bincount(key // n_rows, minlength=n_cols), 0)
    return indptr, (key % n_rows).int(), vals[order]


def coo_pair_on_card(graph):
    """The COO engine's (Âᵀ, Â) pair, the matrices build_agg_pair(impl="xla")
    builds on the host, built on the card (:func:`normalized_on_card`): the
    engine's index_add_ needs no sorted rows, so Âᵀ is Â with rows and
    columns swapped and no transpose is sorted."""
    from mg_gcn_tpu_torch.ops.spmm import AggPair, COOMat

    rows, cols, vals = normalized_on_card(graph, gcn=True)
    n, m, nnz = graph.nrows, graph.ncols, graph.nnz
    return AggPair(fwd=COOMat(rows=cols, cols=rows, vals=vals, n_rows=m, n_cols=n, nnz=nnz),
                   bwd=COOMat(rows=rows, cols=cols, vals=vals, n_rows=n, n_cols=m, nnz=nnz))


def coo_step(params, coo, x, y, config):
    """The COO engine's float32 step, run twice under :func:`deterministic`;
    logs whether the two repeat bit for bit."""
    from mg_gcn_tpu_torch.models.gcn import loss_and_grad

    with deterministic():
        first = loss_and_grad(params, coo, x, y, config)
        again = loss_and_grad(params, coo, x, y, config)
    same = bool(torch.equal(first[0], again[0])) and all(
        torch.equal(g[k], h[k]) for g, h in zip(first[2], again[2]) for k in g)
    log(f"  COO step repeats bit for bit: {same}")
    return first


def compare_with_coo(engine: str, got, coo, ref: str = "COO") -> None:
    """One float32 step against the COO engine (or the ``ref`` step) from
    the same parameters: the loss within rtol 1e-4 and every gradient leaf
    in norm, ||engine - COO|| <= 1e-4 ||COO|| (element-wise, the two sum
    orders can put a near-zero pre-activation on either side of the
    LeakyReLU, which moves single elements by a step)."""
    (loss_p, acc_p, grads_p), (loss_c, acc_c, grads_c) = got, coo
    if not math.isclose(float(loss_p), float(loss_c), rel_tol=1e-4):
        raise AssertionError(f"float32 {engine} loss {float(loss_p)} vs {ref} {float(loss_c)}")
    norm_err, worst, elem_err = 0.0, "", 0.0
    for i, (gp, gc) in enumerate(zip(grads_p, grads_c)):
        for k in gc:
            rel = float(torch.linalg.vector_norm(gp[k] - gc[k]) / torch.linalg.vector_norm(gc[k]))
            if not rel <= 1e-4:
                raise AssertionError(f"layer {i} grad {k}: ||{engine} - {ref}|| / ||{ref}|| = {rel} > 1e-4")
            if rel >= norm_err:
                norm_err, worst = rel, f"layer {i} {k}"
            elem_err = max(elem_err, float((gp[k] - gc[k]).abs().max() / gc[k].abs().max()))
    log(f"  first step: {engine} f32 loss {float(loss_p)!r} vs {ref} {float(loss_c)!r}, acc {float(acc_p)!r}"
        f" vs {float(acc_c)!r}; gradients: max ||diff||/||{ref}|| {norm_err:.3e} ({worst}),"
        f" max |diff| / max|{ref}| {elem_err:.3e}")


def gcn_phase_keys(config) -> set[str]:
    """The phase scopes of one parity-mode GCN step that hold work, by the
    JAX package's rule (``mg_gcn_tpu/models/gcn.py``'s named scopes and
    ``adam-update``; tests/test_torch_port_diagnostics.py holds the port's
    scopes equal to the JAX step's)."""
    keys = {"adam-update", f"{config.num_layers}_loss-layer"}
    for i in range(config.num_layers):
        meta = config.layer_meta(i)
        keys |= {f"{i}_0_matmul-gemm", f"{i}_0_matmul-spmm", f"{i}_1_matmul-gemm"}
        if meta["activation"]:
            keys |= {f"{i}_0_activation", f"{i}_1_activation"}
        if meta["res_proj"] or meta["res_identity"]:
            keys.add(f"{i}_0_residual")
        if meta["res_proj"]:
            keys.add(f"{i}_1_residual")
        if meta["backward_spmm"]:
            keys.add(f"{i}_1_matmul-spmm")
    return keys


def spmm_width(config, i: int) -> int:
    """The operand width of layer i's SpMMs (forward and backward)."""
    meta = config.layer_meta(i)
    return meta["out"] if meta["lin_first"] else meta["in_"]


def kernel_of_event(name: str) -> str | None:
    return next((kernel for piece, kernel in KERNEL_EVENTS if piece in name), None)


def kernel_ms_by_scope(attributed) -> dict[str, float]:
    """The port's kernel events' ms an epoch, by the scope they are credited to."""
    out = collections.defaultdict(float)
    for phase, e in attributed:
        if kernel_of_event(e["name"]) is not None:
            out[phase] += float(e["dur"]) / 1e3 / PHASE_EPOCHS
    return dict(out)


def busy_ms(events) -> float:
    """The union of the device events' intervals, in ms."""
    total, end = 0.0, -math.inf
    for t0, t1 in sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total / 1e3


def profile_step(label: str, step, args) -> tuple[dict, list]:
    """``diagnostics.profile_fused_step`` on ``step(*args)`` (one warm step,
    then PHASE_EPOCHS traced), its Chrome trace kept for
    ``xplane.attribute``. Logs each phase's device ms an epoch, the
    unattributed share, the phase sum against the device's busy time and
    the traced window. Returns ({key: ms an epoch}, [(phase, device event)])."""
    from mg_gcn_tpu_torch.diagnostics import profile_fused_step
    from mg_gcn_tpu_torch.timers import TimerRegistry
    from mg_gcn_tpu_torch.xplane import attribute

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        timers, _, _ = profile_fused_step(step, args, TimerRegistry(), prefix="phase_", epochs=PHASE_EPOCHS,
                                          trace_dir=tmp)
        seconds = time.perf_counter() - t0
        with open(os.path.join(tmp, "trace.json")) as fh:
            attributed = attribute(json.load(fh)["traceEvents"])
    totals = dict(timers._entries)
    device = [e for _, e in attributed]
    phase_sum, busy = sum(totals.values()), busy_ms(device) / PHASE_EPOCHS
    window = (max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in device)
              - min(float(e["ts"]) for e in device)) / 1e3 / PHASE_EPOCHS
    unattributed = totals.get("phase_unattributed", 0.0)
    log(f"  {label}: device ms an epoch by phase (torch.profiler, {PHASE_EPOCHS} traced epochs after one warm;"
        f" profile_fused_step {seconds:.1f} s):")
    for key, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        log(f"    {key:28s} {ms:10.4f} ms  {ms / phase_sum:.4f}")
    log(f"  phase sum {phase_sum:.4f} ms an epoch, unattributed {unattributed:.4f} ms"
        f" ({unattributed / phase_sum:.4f}); device busy {busy:.4f} ms (phase sum / busy {phase_sum / busy:.4f});"
        f" device window {window:.4f} ms an epoch, busy share {busy / window:.4f}")
    return totals, attributed


def phase_main_path_phases(ds, rows: list[dict]) -> None:
    """Phase 5f: the main path's bfloat16 step (phase 4's, sizes 608 → 128
    → 128 → 41, on the pattern pair ``build_agg_pair(impl="pattern")``)
    through ``diagnostics.profile_fused_step``: the phase keys must be the
    JAX package's named scopes for these sizes (:func:`gcn_phase_keys`),
    each traced epoch's ``{l}_0_matmul-spmm`` scopes must hold one
    ``pattern_fwd`` event each and ``{l}_1_matmul-spmm`` (l > 0) one
    ``pattern_bwd`` each, and no pattern kernel may be unattributed. Counters zeroed just before and read
    just after: 3 forward and 2 backward launches an epoch over the warm
    and traced epochs, by width. Logged: each SpMM scope against phase 5's
    isolated launch at its width."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import build_agg_pair, make_train_step

    dev = torch.device("cuda")
    config = GCNConfig(sizes=(FEATURES, *HIDDEN, CLASSES))
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    params = init_params(config, device=dev)
    pair = build_agg_pair(ds.graph, impl="pattern", pattern_dtype="bfloat16", device=dev)
    reset_counts()  # the path starts here
    totals, attributed = profile_step("main path, bfloat16", make_train_step(config),
                                      (params, adam.adam_init(params), pair, x, y, None))
    torch.cuda.synchronize()
    launches = counts()  # the path ends here
    del pair
    torch.cuda.empty_cache()

    want = {f"phase_{k}" for k in gcn_phase_keys(config)}
    if set(totals) - {"phase_unattributed"} != want:
        raise AssertionError(f"phase keys {sorted(totals)} != the JAX package's {sorted(want)}")
    per_scope, names = collections.Counter(), collections.defaultdict(set)
    for phase, e in attributed:
        kernel = kernel_of_event(e["name"])
        if kernel is not None:
            per_scope[(phase, kernel)] += 1
            names[phase].add(e["name"])
    L = config.num_layers
    want_scopes = {(f"{i}_0_matmul-spmm", "pattern_fwd"): PHASE_EPOCHS for i in range(L)}
    want_scopes |= {(f"{i}_1_matmul-spmm", "pattern_bwd"): PHASE_EPOCHS for i in range(1, L)}
    if dict(per_scope) != want_scopes:
        raise AssertionError(f"pattern kernel events by scope {dict(per_scope)} != {want_scopes}")
    epochs = 1 + PHASE_EPOCHS
    widths = collections.Counter(sp_pad(spmm_width(config, i)) for i in range(L))
    want_fwd = {("bfloat16", d): epochs * c for d, c in widths.items()}
    want_bwd = collections.Counter()
    for i in range(1, L):
        want_bwd[("bfloat16", sp_pad(spmm_width(config, i)))] += epochs
    if launches["pattern_fwd"] != want_fwd or launches["pattern_bwd"] != dict(want_bwd):
        raise AssertionError(f"launches {launches['pattern_fwd']} / {launches['pattern_bwd']},"
                             f" want {want_fwd} / {dict(want_bwd)}")
    isolated = {(r["name"], r["d"]): r["ms"] for r in rows if r["dtype"] == "bfloat16"}
    kernel_ms = kernel_ms_by_scope(attributed)
    for (scope, kernel), _ in sorted(want_scopes.items()):
        d = spmm_width(config, int(scope[0]))
        log(f"  {scope}: scope {totals['phase_' + scope]:.4f} ms an epoch, its {kernel} event"
            f" {kernel_ms[scope]:.4f} ms; phase 5's isolated {kernel} at d={d}: {isolated[(kernel, d)]:.4f} ms;"
            f" {sorted(names[scope])[0][:90]}")
    log(f"  launches on the path: pattern_fwd {launches['pattern_fwd']}, pattern_bwd {launches['pattern_bwd']}")


def sp_pad(d: int) -> int:
    """The padded width the pattern kernels run at (their launch counters'
    key, ``spmm_pattern.apply_pattern_calls``)."""
    from mg_gcn_tpu_torch.ops.spmm_pattern import round_up

    return round_up(max(d, 8), 8)


def phase_main_auto_path(ds, pattern_bf16: dict) -> dict:
    """Phase 5g: the main path on impl="auto", the binary CSR walk
    (:func:`drive_path`), its launches by width, and its bfloat16 losses
    logged beside ``pattern_bf16``, phase 4's run on the pattern pair."""
    out = drive_path("gather", ds, HIDDEN, [("bfloat16", EPOCHS)])
    if out["fwd"].has_w or out["fwd"].stream_bf16:
        raise AssertionError("impl='auto' with a float32 operand did not build the float32 binary gather pair")
    expect_launches(out["launches"], {("gather", "float32"): 5, ("gather", "bfloat16"): 5 * EPOCHS})
    by_width = {k: v for k, v in out["launches"]["gather"].items() if v}
    want = {("float32", 128): 3, ("float32", 48): 2, ("bfloat16", 128): 3 * EPOCHS, ("bfloat16", 48): 2 * EPOCHS}
    if by_width != want:
        raise AssertionError(f"gather launches by width {by_width}, want {want}")
    walk, pack = out["bfloat16"]["losses"], pattern_bf16["losses"]
    log(f"  bfloat16 losses, the walk {walk}, the pattern pair {pack}; largest relative difference"
        f" {max(abs(a - b) / abs(b) for a, b in zip(walk, pack)):.3e}")
    return out


def phase_main_path(ds) -> dict:
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad
    from mg_gcn_tpu_torch.train import auto_engine, build_agg_pair, card_memory, train

    dev = torch.device("cuda")
    sizes = (FEATURES, *HIDDEN, CLASSES)
    config = GCNConfig(sizes=sizes)
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    params = init_params(config, device=dev)
    out = {}
    for dtype, want in (("bfloat16", "gather"), ("float32", "gather"), ("int8", "pattern")):
        impl, why = auto_engine(ds.graph, card_memory(dev), pattern_dtype=dtype)
        if impl != want:
            raise AssertionError(f"impl='auto' picks {impl} for a {dtype} operand, not {want} ({why})")
    log(f"  impl='auto' on this graph: {why}")

    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    pair = build_agg_pair(ds.graph, impl="pattern", pattern_dtype="float32", device=dev)
    torch.cuda.synchronize()
    out["pattern_build_s"] = time.perf_counter() - t0
    loss_p, acc_p, grads_p = loss_and_grad(params, pair, x, y, config)
    torch.cuda.synchronize()
    del pair
    t0 = time.perf_counter()
    coo = coo_pair_on_card(ds.graph)
    torch.cuda.synchronize()
    out["coo_build_s"] = time.perf_counter() - t0
    loss_c, acc_c, grads_c = coo_step(params, coo, x, y, config)
    torch.cuda.synchronize()
    del coo
    torch.cuda.empty_cache()
    compare_with_coo("pattern", (loss_p, acc_p, grads_p), (loss_c, acc_c, grads_c))
    oracle = (None, None, oracle_grads_on_card(ds, params, x, y))
    log(f"  the float32 steps against the float64 oracle (tests/torch_oracle.py on the card), max over leaves of"
        f" ||step - oracle|| / ||oracle||: pattern {gap((loss_p, acc_p, grads_p), oracle)};"
        f" COO {gap((loss_c, acc_c, grads_c), oracle)}")
    del oracle
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    res = train(ds, HIDDEN, epochs=EPOCHS, impl="pattern", pattern_dtype="bfloat16", device=dev)
    if res.engine != "pattern" or not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"bf16 run: engine {res.engine}, losses {res.losses}")
    out["bf16"] = dict(losses=res.losses, accs=res.accs, epoch_seconds=res.epoch_seconds,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    res8 = train(ds, HIDDEN, epochs=1, impl="pattern", pattern_dtype="int8", device=dev)
    if res8.engine != "pattern" or not all(math.isfinite(v) for v in res8.losses):
        raise AssertionError(f"int8 run: engine {res8.engine}, losses {res8.losses}")
    out["int8"] = dict(losses=res8.losses, accs=res8.accs, epoch_seconds=res8.epoch_seconds)
    torch.cuda.synchronize()
    out["launches"] = counts()  # the main path ends here

    for dtype, epochs in (("float32", 1), ("bfloat16", EPOCHS), ("int8", 1)):
        f = per_dtype(out["launches"], "pattern_fwd", dtype)
        b = per_dtype(out["launches"], "pattern_bwd", dtype)
        if (f, b) != (3 * epochs, 2 * epochs):
            raise AssertionError(f"{dtype}: {f} fwd / {b} bwd launches in {epochs} epoch(s), want 3/2 each")
    steady = sorted(res.epoch_seconds[1:])
    out["bf16_epoch_s_median"] = steady[len(steady) // 2]
    log(f"  launches on the main path: {out['launches']}")
    log(f"  pattern pair build {out['pattern_build_s']:.2f} s, COO pair build {out['coo_build_s']:.1f} s,"
        f" bf16 epoch median (epochs 1-{EPOCHS - 1}) {out['bf16_epoch_s_median']:.4f} s (no profiler; PERF.md"
        f" section 5: 0.0598 s), peak memory {out['bf16']['peak_mem_gb']:.2f} GB")
    return out


def library_sparse(ds, transpose: bool):
    """torch.sparse.mm's float32 CSR of ``ds``'s adjacency of ones, or of its
    transpose, built on the card (:func:`transpose_on_card`) rather than by
    a host transpose of 115M entries."""
    g = ds.graph
    rows, cols, ones = normalized_on_card(g, gcn=None)
    if transpose:
        return csr_library(*transpose_on_card(rows, cols, ones, g.shape), (g.ncols, g.nrows))
    return csr_library(torch.from_numpy(g.indptr).cuda(), cols, ones, g.shape)


def csr_library(indptr, indices, values, shape):
    """A float32 CSR tensor for torch.sparse.mm, the yardstick of the
    kernels lines (the port never calls it)."""
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(indptr, indices.long(), values, size=shape, check_invariants=False)


def elt_size(t: torch.Tensor) -> int:
    return (torch.finfo(t.dtype).bits if t.is_floating_point() else torch.iinfo(t.dtype).bits) // 8


def kernel_row(name, dtype, d, n, nnz, launches, check, ms, plain_ms, library_ms, moved,
               datapath: tuple[int, str] | None = None) -> dict:
    """One entry of the kernels line. ``check`` is check_close's (max_err,
    tolerance used). bound_ms is the larger of the bytes the function must
    move (``moved``: each input read once, each output written once) over
    the memory rate and its 2*nnz*d operations over the peak rate of the
    datapath the kernel computes them on: the operand type's, or for
    ``datapath`` = (passes, type) that many passes at the peak of ``type``
    (block_fwd's float32 mode: three bfloat16 passes on the tensor cores)."""
    passes, ops_type = datapath or (1, dtype)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, passes * 2.0 * nnz * d / PEAK_OPS[ops_type]
    err, use = check
    return dict(
        name=name, route="cuda", source=f"mg_gcn_tpu_torch/csrc/{SOURCES[name]}", replaces=KERNELS[name],
        dtype=dtype, d=d, n=n, nnz=nnz, launches=launches, max_abs_err=err, max_err=err, tolerance_used=use,
        ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms,
    )


def log_row(r: dict, note: str = "") -> None:
    """A kernels-line row on the log; ``note`` is logged after its bound."""
    log(f"  {r['name']} {r['dtype']:8s} d={r['d']:3d}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms,"
        f" {r['bound_by']}{note}), plain {r['plain_ms']:.1f} ms, library {r['library_ms']},"
        f" launches {r['launches']}, max_err {r['max_abs_err']:.3e} (tolerance used {r['tolerance_used']:.3f})")


def phase_kernels_main(ds, launches: dict) -> tuple[list[dict], tuple]:
    """The pattern kernels at the main path's shape (phase 5); returns the
    rows and the bfloat16 pattern pair, whose pack the SAGE, scan and
    PageRank phases reuse."""
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    fwd, bwd = sp.pattern_pair_from_binary_csr(ds.graph, device="cuda")
    n, n_pad, nnz = fwd.n, fwd.n_pad, fwd.nnz
    rows = []
    for name, kernel, plain in (("pattern_fwd", sp.pattern_fwd, sp.pattern_fwd_plain),
                                ("pattern_bwd", sp.pattern_bwd, sp.pattern_bwd_plain)):
        lib = library_sparse(ds, transpose=name == "pattern_fwd")
        for dtype in DTYPES:
            for d in WIDTHS:
                b = operand(n_pad, d, dtype, seed=d)
                label = f"{name} {dtype} d={d} (main shape)"
                got = kernel(fwd.pack, b)
                torch.cuda.synchronize()
                check = check_close(label, got, plain(fwd.pack, b, torch.float64), dtype)
                if name == "pattern_fwd":
                    geometry, keep = sp.pattern_fwd_geometry(n_pad, b.shape[1], b.dtype), None
                else:
                    geometry = bwd_geometry(label, sp.pattern_bwd_geometry(n_pad, b.shape[1], b.dtype), b)
                    keep = BWD_ROW_KEYS
                extra = repeat_and_geometry(label, got, lambda: kernel(fwd.pack, b), geometry, keep)
                del got
                ms = cuda_ms(lambda: kernel(fwd.pack, b), 5)
                plain_ms = cuda_ms(lambda: plain(fwd.pack, b), 1)
                library_ms = None
                if dtype == "float32":
                    bl = b[:n, :d].contiguous()
                    library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
                moved = n_pad * n_pad / 8 + n * d * elt_size(b) + n * d * 4
                rows.append(kernel_row(name, dtype, d, n, nnz, launches[name].get((dtype, b.shape[1]), 0),
                                       check, ms, plain_ms, library_ms, moved) | extra)
                log_row(rows[-1])
        del lib
    return rows, (fwd, bwd)


def repeat_and_geometry(label: str, got: torch.Tensor, run, geometry: dict, keep: tuple | None = None) -> dict:
    """A redesigned kernel's contract at the path's shape (the forward and
    backward pattern walks, block_fwd, tiled): a second launch gives the
    same bits as ``got`` (fixed sum order, no atomics); logs the launch
    geometry (grid, threads, dynamic shared memory, row slices or stages,
    resident blocks an SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor).
    Returns the row's extra keys, with the geometry's ``keep`` keys only
    where given."""
    again = run()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches differ")
    del again
    log(f"  {label}: two launches equal bit for bit; geometry {geometry}")
    return {"repeat_equal": True, "geometry": geometry if keep is None else {k: geometry[k] for k in keep}}


# What the kernels line keeps of the backward walk's geometry: the launch and
# the card's occupancy, and the split of a warp (held to pattern_bwd_split by
# bwd_geometry). Features, loads, span words and column windows (the rule's
# and the kernel's constants, windows by the L2 rule) stay in the log.
BWD_ROW_KEYS = ("grid_x", "grid_y", "threads", "smem", "stages", "blocks_per_sm", "resident_blocks", "lanes", "groups")


def bwd_geometry(label: str, geometry: dict, b: torch.Tensor) -> dict:
    """The backward walk's launch geometry for operand ``b`` (its width and
    dtype), whose lanes, groups and features must be
    ``spmm_pattern.pattern_bwd_split``'s; returned whole."""
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    split = sp.pattern_bwd_split(b.shape[-1], b.dtype)
    if any(geometry[k] != split[k] for k in ("lanes", "groups", "features")):
        raise AssertionError(f"{label}: launch geometry {geometry} is not the split {split}")
    return geometry



# ---------------------------------------------------------------------------
# the SAGE path (BASELINE config 4) and PageRank (BASELINE config 5)


def mean_coo_pair_on_card(graph):
    """The COO pair (M, Mᵀ) of the row-normalized adjacency M
    (:func:`normalized_on_card`, as sparse.normalize(axis=False) takes it),
    built on the card: SAGE's reference pair, and Mᵀ PageRank's reference
    iteration matrix."""
    from mg_gcn_tpu_torch.ops.spmm import AggPair, COOMat

    rows, cols, vals = normalized_on_card(graph, gcn=False)
    n, nnz = graph.nrows, graph.nnz
    return AggPair(fwd=COOMat(rows=rows, cols=cols, vals=vals, n_rows=n, n_cols=n, nnz=nnz),
                   bwd=COOMat(rows=cols, cols=rows, vals=vals, n_rows=n, n_cols=n, nnz=nnz))


def run_pagerank(label: str, mat, n: int, warm: bool = True) -> dict:
    """The power iteration on ``mat`` (``models.pagerank.power_iterate``),
    the launch counters zeroed before it and read after it, rescaled to
    mean 1 as ``pagerank`` does; with ``warm`` a second run, timed, must
    give the same iterations and bits (the kernels' sums have a fixed
    order). Logs iterations, cold and warm seconds and launches."""
    from mg_gcn_tpu_torch.models.pagerank import power_iterate

    reset_counts()  # the PageRank path starts here
    t0 = time.perf_counter()
    p, iters = power_iterate(mat, n, DAMPING, PR_EPS)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = counts()  # and ends here
    warm_s = float("nan")
    if warm:
        t0 = time.perf_counter()
        p2, iters2 = power_iterate(mat, n, DAMPING, PR_EPS)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if iters2 != iters or not torch.equal(p, p2):
            raise AssertionError(f"{label}: a second run gave {iters2} iterations (first {iters}) or other bits")
        del p2
    p = p * (n / p.sum())
    if not bool(torch.isfinite(p).all()):
        raise AssertionError(f"{label}: PageRank not finite")
    log(f"  {label}: {iters} iterations, cold {cold:.4f} s, warm {warm_s:.4f} s ({warm_s / iters * 1e3:.3f} ms an"
        f" iteration); launches { {k: v for k, v in launches.items() if v} }")
    return dict(p=p, iters=iters, cold_s=cold, warm_s=warm_s, launches=launches)


def compare_pagerank(label: str, got: torch.Tensor, want: torch.Tensor, ref: str) -> None:
    """PageRank vectors within the JAX tests' rtol 1e-4 / atol 1e-5
    (tests/test_pagerank.py)."""
    diff = (got.double() - want.double()).abs()
    use = float((diff / (1e-4 * want.double().abs() + 1e-5)).max())
    if not use <= 1.0:
        raise AssertionError(f"{label}: {use:.3f} of rtol 1e-4 / atol 1e-5 against {ref} used")
    log(f"  {label} vs {ref}: max |diff| {float(diff.max()):.3e} ({use:.3f} of rtol 1e-4 / atol 1e-5),"
        f" sums {float(got.sum())!r} / {float(want.sum())!r}")


def phase_sage_path(ds, pack) -> dict:
    """BASELINE config 4 through ``models.sage`` and
    ``train.make_train_step(model="sage")``: SAGEConfig(sizes=(608, 512,
    41)), l2-normalized, seed-99 init, on the main path's dataset; impl="auto"
    must pick the pattern pair (the pack fits, train.mean_engine) and the run
    reuses the main path's ``pack`` (bench.py:250). One float32 step against
    the SAGE COO pair built on the card by the rule of phase 4; EPOCHS
    bfloat16 epochs with losses falling from the first to the last and one
    int8 epoch, their median and peak memory. The counters are zeroed
    before the float32 step and read after the int8 epoch: exactly 2
    pattern_bwd (d_pad 608, 512) + 1 pattern_fwd (512) launches an epoch in
    each dtype and no other kernel. Then the infer path's forward (no
    gradient) at full size: its argmax equals the step's logits'."""
    from mg_gcn_tpu_torch.models import sage
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp
    from mg_gcn_tpu_torch.train import make_train_step, mean_engine

    dev = torch.device("cuda")
    if mean_engine(ds.graph, dev) != "pattern":
        raise AssertionError("impl='auto' would not take the pattern pair for SAGE on the main graph")
    config = sage.SAGEConfig(sizes=SAGE_SIZES)
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    params = sage.init_params(config, device=dev)
    out = {}

    reset_counts()  # the SAGE path starts here
    t0 = time.perf_counter()
    pair = sage.build_sage_pair(ds.graph, impl="auto", pack=pack, dtype="float32", device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    if not isinstance(pair.fwd, sp.PatternMat) or pair.fwd.pack is not pack:
        raise AssertionError(f"SAGE impl='auto' chose {type(pair.fwd).__name__} or another pack")
    step = sage.loss_and_grad(params, pair, x, y, config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coo = mean_coo_pair_on_card(ds.graph)
    torch.cuda.synchronize()
    out["coo_build_s"] = time.perf_counter() - t0
    with deterministic():
        step_coo = sage.loss_and_grad(params, coo, x, y, config)
    torch.cuda.synchronize()
    del coo
    torch.cuda.empty_cache()
    compare_with_coo("SAGE pattern", step, step_coo)
    del step_coo

    def run(dtype, epochs):
        p_dt = sage.build_sage_pair(ds.graph, impl="auto", pack=pack, dtype=dtype, device=dev)
        train_step = make_train_step(config, model="sage")
        p, st = params, adam.adam_init(params)
        losses, accs, seconds = [], [], []
        for e in range(epochs):
            t0 = time.perf_counter()
            p, st, loss, acc = train_step(p, st, p_dt, x, y, None)
            losses.append(float(loss))  # waits for the card
            accs.append(float(acc))
            seconds.append(time.perf_counter() - t0)
            log(f"  SAGE {dtype} epoch {e} {losses[-1]} {accs[-1]} {seconds[-1]}")
        return dict(losses=losses, accs=accs, epoch_seconds=seconds)

    torch.cuda.reset_peak_memory_stats()
    out["bf16"] = run("bfloat16", EPOCHS)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["int8"] = run("int8", 1)
    torch.cuda.synchronize()
    out["launches"] = counts()  # the SAGE path ends here
    want = {}
    for dtype, epochs in (("float32", 1), ("bfloat16", EPOCHS), ("int8", 1)):
        want[("pattern_bwd", dtype)], want[("pattern_fwd", dtype)] = 2 * epochs, epochs
        by_width = {(name, d_pad): v for name in ("pattern_bwd", "pattern_fwd")
                    for (dt, d_pad), v in out["launches"][name].items() if dt == dtype}
        if by_width != {("pattern_bwd", 608): epochs, ("pattern_bwd", 512): epochs, ("pattern_fwd", 512): epochs}:
            raise AssertionError(f"SAGE {dtype} launches by width {by_width}, want 1 + 1 + 1 an epoch")
    expect_launches(out["launches"], want)
    losses = out["bf16"]["losses"]
    if not all(math.isfinite(v) for v in losses + out["int8"]["losses"]) or not losses[-1] < losses[0]:
        raise AssertionError(f"SAGE losses bf16 {losses}, int8 {out['int8']['losses']}: not finite, or not falling")
    steady = sorted(out["bf16"]["epoch_seconds"][1:])
    out["bf16_epoch_s_median"] = steady[len(steady) // 2]
    log(f"  launches on the SAGE path: { {k: v for k, v in out['launches'].items() if v} }")
    log(f"  SAGE pair build {out['build_s']:.3f} s (pack reused), COO pair build {out['coo_build_s']:.2f} s,"
        f" bf16 epoch median (epochs 1-{EPOCHS - 1}) {out['bf16_epoch_s_median']:.4f} s,"
        f" peak memory {out['peak_mem_gb']:.2f} GB")

    leaves = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in params]
    with torch.enable_grad():
        step_logits = sage.forward(leaves, pair, x, config)
    t0 = time.perf_counter()
    with torch.no_grad():
        infer_logits = sage.forward(params, pair, x, config)
    pred = torch.argmax(infer_logits, dim=-1)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    if not torch.equal(pred, torch.argmax(step_logits.detach(), dim=-1)):
        raise AssertionError("SAGE: the infer forward's argmax differs from the step's logits'")
    log(f"  SAGE infer forward (float32, no gradient): {infer_s:.4f} s, argmax equal to the step's logits',"
        f" accuracy {float((pred == y).float().mean())!r}")
    return out


def phase_sage_kernels(ds, pack, launches: dict) -> list[dict]:
    """The SAGE path's pattern launches at its shape (the main pack):
    pattern_bwd at d = 608 and 512 and pattern_fwd at 512, each dtype,
    against the plain version, timed beside the bound and torch.sparse.mm,
    with the repeat check and the launch geometry, as phase 5."""
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    n, n_pad, nnz = ds.num_nodes, pack.shape[0], ds.graph.nnz
    rows = []
    for name, d in SAGE_WIDTHS:
        kernel, plain = (sp.pattern_fwd, sp.pattern_fwd_plain) if name == "pattern_fwd" else (sp.pattern_bwd,
                                                                                              sp.pattern_bwd_plain)
        lib = library_sparse(ds, transpose=name == "pattern_fwd")
        for dtype in DTYPES:
            b = operand(n_pad, d, dtype, seed=d)
            label = f"{name} {dtype} d={d} (SAGE shape)"
            got = kernel(pack, b)
            torch.cuda.synchronize()
            check = check_close(label, got, plain(pack, b, torch.float64), dtype)
            if name == "pattern_fwd":
                geometry, keep = sp.pattern_fwd_geometry(n_pad, b.shape[1], b.dtype), None
            else:
                geometry = bwd_geometry(label, sp.pattern_bwd_geometry(n_pad, b.shape[1], b.dtype), b)
                keep = BWD_ROW_KEYS
            extra = repeat_and_geometry(label, got, lambda: kernel(pack, b), geometry, keep)
            del got
            torch.cuda.empty_cache()
            ms = cuda_ms(lambda: kernel(pack, b), 5)
            plain_ms = cuda_ms(lambda: plain(pack, b), 1)
            library_ms = None
            if dtype == "float32":
                bl = b[:n, :d].contiguous()
                library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
                del bl
            moved = n_pad * n_pad / 8 + n * d * elt_size(b) + n * d * 4
            rows.append(kernel_row(name, dtype, d, n, nnz, launches[name].get((dtype, b.shape[1]), 0),
                                   check, ms, plain_ms, library_ms, moved) | extra)
            log_row(rows[-1])
            del b
            torch.cuda.empty_cache()
        del lib
    return rows


def phase_pagerank_reddit(ds, pack) -> tuple[list[dict], torch.Tensor]:
    """BASELINE config 5 at Reddit scale as bench.py runs it (bench.py:
    333-373): the main pack with the row scale, PatternMat "PT", "pre",
    float32 (impl="auto" would take the pattern operator: train.mean_engine),
    damping 0.85, eps 1e-4; iterations, cold and warm seconds; held against
    a COO PageRank on the card within rtol 1e-4 / atol 1e-5 (both counts
    logged: the engines sum in other orders, so where a change sits at eps
    the counts may differ by one); exactly one pattern_fwd float32 d_pad 8
    launch an iteration and no other kernel. Then pattern_fwd float32 at
    d = 1 as phase 5, for the kernels line. Returns its row and the result."""
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp
    from mg_gcn_tpu_torch.train import mean_engine

    g, n, n_pad = ds.graph, ds.num_nodes, pack.shape[0]
    if mean_engine(g, torch.device("cuda")) != "pattern":
        raise AssertionError("impl='auto' would not take the pattern operator for PageRank on the main graph")
    scale = torch.from_numpy(sp.row_scale(g, n_pad)).cuda()
    mat = sp.PatternMat(pack, scale, n, n_pad, g.nnz, "PT", "pre", "float32")
    got = run_pagerank("PageRank on the pattern pack", mat, n)
    expect_launches(got["launches"], {("pattern_fwd", "float32"): got["iters"]})
    if got["launches"]["pattern_fwd"] != {("float32", 8): got["iters"]}:
        raise AssertionError(f"PageRank launches {got['launches']['pattern_fwd']}, want d_pad 8 only")
    coo = mean_coo_pair_on_card(g).bwd
    ref = run_pagerank("PageRank on COO", coo, n, warm=False)
    del coo
    compare_pagerank("PageRank (pattern)", got["p"], ref["p"], "COO")

    b = operand(n_pad, 1, "float32", seed=1)
    label = "pattern_fwd float32 d=1 (PageRank shape)"
    check, ms, plain_ms = check_and_time(label, lambda: sp.pattern_fwd(pack, b),
                                         lambda: sp.pattern_fwd_plain(pack, b, torch.float64), "float32", 5,
                                         lambda: sp.pattern_fwd_plain(pack, b), 1)
    extra = repeat_and_geometry(label, sp.pattern_fwd(pack, b), lambda: sp.pattern_fwd(pack, b),
                                sp.pattern_fwd_geometry(n_pad, 8, torch.float32))
    lib = library_sparse(ds, transpose=True)
    bl = b[:n, :1].contiguous()
    library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
    del lib, bl, b
    row = kernel_row("pattern_fwd", "float32", 1, n, g.nnz, got["launches"]["pattern_fwd"][("float32", 8)],
                     check, ms, plain_ms, library_ms, n_pad * n_pad / 8 + n * 4 + n * 4) | extra
    log_row(row, f"; {got['iters']} iterations, {got['warm_s'] / got['iters'] * 1e3:.3f} ms an iteration")
    torch.cuda.empty_cache()
    return [row], got["p"]


def phase_pagerank_dist(ds, single: torch.Tensor) -> None:
    """Row-partitioned PageRank (``models.pagerank``: ``dist_pagerank_mat``,
    then ``power_iterate_dist``, the two halves of ``pagerank_dist``;
    BASELINE config 5's layout) at DIST_PARTS partitions, all on cuda:0, on
    the main graph (232,968 % 4 == 0): the COO ring blocks built once (host
    seconds logged), then each strategy's iterations, held against the
    single-card result within rtol 1e-4 / atol 1e-5. The ring blocks are
    COO: no kernel of the port launches."""
    from mg_gcn_tpu_torch.models.pagerank import dist_pagerank_mat, power_iterate_dist
    from mg_gcn_tpu_torch.parallel import dist

    mesh = dist.make_mesh(DIST_PARTS, ["cuda:0"] * DIST_PARTS)
    t0 = time.perf_counter()
    dmat = dist_pagerank_mat(ds.graph, mesh)
    torch.cuda.synchronize()
    log(f"  dist_pagerank_mat: {DIST_PARTS} x {DIST_PARTS} COO ring blocks of {dmat.rows[0].shape[1]} entries"
        f" on cuda:0, built in {time.perf_counter() - t0:.2f} s (host normalize, transpose and block split)")
    n = ds.num_nodes
    for strategy in ("ring", "all_gather"):
        reset_counts()
        t0 = time.perf_counter()
        p, iters = power_iterate_dist(dmat, DAMPING, PR_EPS, strategy=strategy)
        p = torch.cat(p).reshape(-1)
        p = p * (n / p.sum())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        expect_launches(counts(), {})
        log(f"  power_iterate_dist -P {DIST_PARTS} {strategy} on cuda:0: {iters} iterations, {seconds:.4f} s")
        compare_pagerank(f"pagerank_dist {strategy}", p, single, "the single card")
        del p
    del dmat
    torch.cuda.empty_cache()


def phase_pagerank_products(fwd, graph) -> list[dict]:
    """BASELINE config 5 at products scale as bench.py runs it (bench.py:
    739-775): path B's gather matrix (Aᵀ, binary) with its scale swapped to
    a pre-scale of 1/max(outdeg, 1) of ``graph`` (path B's); iterations and
    seconds; held against a COO PageRank on the card as at Reddit scale; exactly one gather float32
    d_pad 8 launch an iteration. Then gather float32 at d = 1 as phase 17,
    for the kernels line."""
    import dataclasses

    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    n = fwd.n_out
    outdeg = np.diff(graph.indptr).astype(np.float32)
    mat = dataclasses.replace(fwd, scale=torch.from_numpy(1.0 / np.maximum(outdeg, 1.0)).cuda(), scale_side="pre")
    got = run_pagerank("PageRank on the gather matrix", mat, n)
    expect_launches(got["launches"], {("gather", "float32"): got["iters"]})
    if got["launches"]["gather"] != {("float32", 8): got["iters"]}:
        raise AssertionError(f"PageRank launches {got['launches']['gather']}, want d_pad 8 only")
    coo = mean_coo_pair_on_card(graph).bwd
    ref = run_pagerank("PageRank on COO (products)", coo, n, warm=False)
    del coo
    compare_pagerank("PageRank (gather)", got["p"], ref["p"], "COO")
    del got["p"], ref

    b = operand(n, 1, "float32", seed=1)
    label = "gather float32 d=1 (PageRank products shape)"
    check, ms, plain_ms = time_against_plain(label, sg.gather, sg.gather_plain, (fwd.indptr, fwd.indices, None, b),
                                             "float32", 5, 1, repeat=True)
    extra = walk_geometry(label, sg.gather_geometry(n, 8, torch.float32, False))
    lib = csr_library(fwd.indptr, fwd.indices, torch.ones(fwd.nnz, device="cuda"), (n, fwd.n_in))
    bl = b[:, :1].contiguous()
    library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
    del lib, bl, b
    moved = 8 * (n + 1) + 4 * fwd.nnz + fwd.n_in * 4 + n * 4
    row = kernel_row("gather", "float32", 1, n, fwd.nnz, got["launches"]["gather"][("float32", 8)], check, ms,
                     plain_ms, library_ms, moved) | extra
    log_row(row, f"; {got['iters']} iterations, {got['warm_s'] / got['iters'] * 1e3:.3f} ms an iteration")
    torch.cuda.empty_cache()
    return [row]

# ---------------------------------------------------------------------------
# the dist path: -P 4 -R 1 on one card (ring_fwd, ring_bwd)


def phase_dist_path(ds) -> dict:
    """BASELINE's canonical ``-P 4 -R 1`` run on the main path's dataset,
    its DIST_PARTS partitions all on cuda:0, through ``parallel.dist``: the
    gate of train.dist_pattern_engine must take the pattern pair; the pair is
    built on the card (m_loc, n_pad, bytes and seconds logged); one float32
    fused step (``dist_loss_and_grad``) is held against the single-card
    pattern step from the same seed-99 parameters by the rule of phase 4;
    then EPOCHS bfloat16 fused epochs with finite losses falling from the
    first to the last and 1 int8 epoch. The counters are zeroed before the
    float32 step and read after the int8 epoch: exactly 3 ``ring_fwd`` + 2
    ``ring_bwd`` launches a partition and epoch (forward at d_pad 128, 128,
    48; backward at 48, 128) and no other kernel. Then one bfloat16 epoch
    each of the ``ring`` and ``all_gather`` exchanges from the same
    parameters as the fused epoch 0: losses within rtol 1e-4 of it."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.parallel import dist
    from mg_gcn_tpu_torch.train import build_agg_pair, dist_pattern_engine

    dev = torch.device("cuda:0")
    P, n = DIST_PARTS, ds.num_nodes
    config = GCNConfig(sizes=(FEATURES, *HIDDEN, DIST_CLASSES))
    params = init_params(config, device=dev)
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    single = build_agg_pair(ds.graph, impl="pattern", pattern_dtype="float32", device=dev)
    ref = loss_and_grad(params, single, x, y, config)
    torch.cuda.synchronize()
    del single, x, y
    torch.cuda.empty_cache()  # the single-card 6.8 GB pack goes before the dist build

    mesh = dist.make_mesh(P, [dev] * P)
    fits, why = dist_pattern_engine(ds.graph, P, P, torch.cuda.get_device_properties(dev).total_memory)
    log(f"  gate: {why}")
    if not fits:
        raise AssertionError("the dist pattern gate refused the main path's graph")
    out = {}
    reset_counts()  # the dist path starts here
    t0 = time.perf_counter()
    pair = dist.DistPatternPair.from_binary_csr(ds.graph, mesh, dtype="bfloat16")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    pack_gb = 2 * sum(p.numel() for p in pair.pack_fwd) * 4 / 1e9
    log(f"  DistPatternPair: P = {P} on {dev}, m_loc = {pair.m_loc}, n_pad = {pair.n_pad},"
        f" packs {pack_gb / P:.2f} GB a partition, {pack_gb:.2f} GB in all, built on the card in"
        f" {out['build_s']:.2f} s")
    xs, ys, masks = dist.shard_dataset(ds, mesh, pair.n_pad)

    def aggs(dtype, strategy):
        return (lambda hs: dist.dist_aggregate_pattern(pair, hs, "PT", dtype, strategy),
                lambda gs: dist.dist_aggregate_pattern(pair, gs, "P", dtype, strategy))

    got = dist.dist_loss_and_grad([params] * P, *aggs("float32", "fused"), xs, ys, config, n, masks, mesh=mesh)
    torch.cuda.synchronize()
    compare_with_coo("dist fused", got, ref, ref="single-card pattern")
    del got, ref

    def run(dtype, strategy, epochs):
        step = dist.make_dist_train_step(config, mesh, n, strategy=strategy, pair_kind="pattern", pattern_dtype=dtype)
        p, st = dist.replicate(params, mesh), dist.replicate(adam.adam_init(params), mesh)
        losses, seconds = [], []
        for e in range(epochs):
            t0 = time.perf_counter()
            p, st, loss, acc = step(p, st, pair, xs, ys, masks)
            losses.append(float(loss))  # waits for the card
            seconds.append(time.perf_counter() - t0)
            log(f"  dist {strategy} {dtype} epoch {e} {losses[-1]} {float(acc)} {seconds[-1]}")
        return losses, seconds

    torch.cuda.reset_peak_memory_stats()
    out["losses"], out["epoch_seconds"] = run("bfloat16", "fused", EPOCHS)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["int8_losses"], out["int8_seconds"] = run("int8", "fused", 1)
    torch.cuda.synchronize()
    out["launches"] = counts()  # the dist path ends here
    want = {}
    for dtype, epochs in (("float32", 1), ("bfloat16", EPOCHS), ("int8", 1)):
        want[("ring_fwd", dtype)], want[("ring_bwd", dtype)] = 3 * P * epochs, 2 * P * epochs
    expect_launches(out["launches"], want)
    by_width = {(name, dp): v for name in ("ring_fwd", "ring_bwd")
                for (dt, dp), v in out["launches"][name].items() if dt == "bfloat16"}
    if by_width != {("ring_fwd", 128): 2 * P * EPOCHS, ("ring_fwd", 48): P * EPOCHS,
                    ("ring_bwd", 128): P * EPOCHS, ("ring_bwd", 48): P * EPOCHS}:
        raise AssertionError(f"dist bf16 launches by width {by_width}")
    losses = out["losses"]
    if not all(math.isfinite(v) for v in losses + out["int8_losses"]) or not losses[-1] < losses[0]:
        raise AssertionError(f"dist losses bf16 {losses}, int8 {out['int8_losses']}: not finite, or not falling")
    steady = sorted(out["epoch_seconds"][1:])
    out["epoch_s_median"] = steady[len(steady) // 2]
    log(f"  launches on the dist path: { {k: v for k, v in out['launches'].items() if v} }")
    log(f"  dist fused bf16 epoch median (epochs 1-{EPOCHS - 1}) {out['epoch_s_median']:.4f} s,"
        f" peak memory {out['peak_mem_gb']:.2f} GB")
    for strategy in ("ring", "all_gather"):
        other, sec = run("bfloat16", strategy, 1)
        if not math.isclose(other[0], losses[0], rel_tol=1e-4):
            raise AssertionError(f"dist {strategy} bf16 epoch 0 loss {other[0]} vs fused {losses[0]}")
        log(f"  dist {strategy} bf16 epoch 0: loss {other[0]!r} (fused {losses[0]!r}), {sec[0]:.4f} s")
    out["pair"] = pair
    return out


def slab_library(ds, m: int, n_pad: int, transpose: bool):
    """torch.sparse.mm's float32 CSR of partition 0's m x n_pad slab of Pᵀ
    (``transpose``: the columns of slab 0, for ring_fwd) or of P (its rows,
    for ring_bwd), and its nonzeros; a yardstick the port never calls."""
    g = ds.graph
    if not transpose:
        e = int(g.indptr[m])
        crow = torch.from_numpy(g.indptr[: m + 1]).cuda()
        return csr_library(crow, torch.from_numpy(g.indices[:e]).cuda(), torch.ones(e, device="cuda"),
                           (m, n_pad)), e
    cols = torch.from_numpy(g.indices).cuda().long()
    rows = torch.repeat_interleave(torch.arange(g.nrows, device="cuda"), torch.from_numpy(np.diff(g.indptr)).cuda())
    sel = cols < m
    key, _ = torch.sort(cols[sel] * n_pad + rows[sel])
    del cols, rows, sel
    crow = torch.zeros(m + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(key // n_pad, minlength=m), 0)
    return csr_library(crow, key % n_pad, torch.ones(key.numel(), device="cuda"), (m, n_pad)), key.numel()


def phase_ring_kernels(ds, pair, launches: dict) -> list[dict]:
    """ring_fwd and ring_bwd at the dist path's shape: partition 0's launch
    (its P = 4 blocks of m_loc², slot s = partition s's block) for each
    dtype x the path's widths, against the plain version summed in float64
    (int8 equal), timed with CUDA events beside the bound (the P packs, the
    P slots and C at the memory rate, or 2·nnz_0·d operations), the plain
    version and (float32) torch.sparse.mm on the partition's slab of Pᵀ / P
    against the gathered operand."""
    from mg_gcn_tpu_torch.ops import spmm_pattern_ring as ring

    P, m = pair.parts, pair.m_loc
    rows = []
    for name, kernel, plain, pack in (("ring_fwd", ring.ring_pattern_fwd, ring.ring_pattern_fwd_plain, pair.pack_fwd[0]),
                                      ("ring_bwd", ring.ring_pattern_bwd, ring.ring_pattern_bwd_plain, pair.pack_bwd[0])):
        lib, nnz = slab_library(ds, m, pair.n_pad, transpose=name == "ring_fwd")
        for dtype in DTYPES:
            for d in DIST_WIDTHS:
                slots = operand(P * m, d, dtype, seed=d).reshape(P, m, -1)
                label = f"{name} {dtype} d={d} (dist shape)"
                if name == "ring_fwd":
                    geometry, keep = ring.ring_pattern_fwd_geometry(P, m, slots.shape[2], slots.dtype), None
                else:
                    geometry = bwd_geometry(label, ring.ring_pattern_bwd_geometry(P, m, slots.shape[2], slots.dtype),
                                            slots)
                    keep = BWD_ROW_KEYS
                extra = repeat_and_geometry(label, kernel(pack, slots), lambda: kernel(pack, slots), geometry, keep)
                check, ms, plain_ms = check_and_time(
                    label, lambda: kernel(pack, slots),
                    lambda: plain(pack, slots, None if dtype == "int8" else torch.float64), dtype, 5,
                    lambda: plain(pack, slots), 1)
                library_ms = None
                if dtype == "float32":
                    bl = slots.reshape(P * m, -1)[:, :d].contiguous()
                    library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
                    del bl
                moved = pack.numel() * 4 + slots.numel() * elt_size(slots) + m * d * 4
                rows.append(kernel_row(name, dtype, d, m, nnz, launches[name].get((dtype, slots.shape[2]), 0),
                                       check, ms, plain_ms, library_ms, moved) | extra)
                log_row(rows[-1])
                del slots
                torch.cuda.empty_cache()
        del lib
    return rows


# ---------------------------------------------------------------------------
# the column path: -P 4 -R 0 on one card (the COO engine, no kernel)


def phase_col_path(ds) -> dict:
    """Column-parallel GCN at -P 4 -R 0 on the main graph, its partitions on
    cuda:0, through ``parallel.dist_col`` at the rounded sizes COL_SIZES:
    Âᵀ held once on the card (``replicate_coo``), one float32 step (exact
    gradients, under :func:`deterministic`) against the single-card
    exact-mode COO step from the same seed-99 parameters
    (:func:`compare_steps`), then COL_EPOCHS float32 epochs of
    ``make_col_train_step`` with finite losses, their median and peak
    memory. The COO engine is the JAX package's (``dist_col.py:33``: XLA):
    the counters, zeroed before the epochs, must read no launch after."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.parallel import dist_col

    dev = torch.device("cuda:0")
    P, n = DIST_PARTS, ds.num_nodes
    config = GCNConfig(sizes=COL_SIZES, parity=False)
    params = init_params(config, device=dev)
    x = torch.zeros((n, COL_SIZES[0]), device=dev)
    x[:, :FEATURES] = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    coo = coo_pair_on_card(ds.graph)
    with deterministic():
        ref = loss_and_grad(params, coo, x, y, config)
    mesh = dist_col.make_col_mesh(P, [dev] * P)
    mats = dist_col.replicate_coo(coo.fwd, mesh)
    del coo
    if any(m is not mats[0] for m in mats) or mats[0].fwd.rows.data_ptr() != mats[0].bwd.cols.data_ptr():
        raise AssertionError("the column path holds Âᵀ more than once on the card")
    mat_gb = sum(t.numel() * t.element_size() for t in (mats[0].fwd.rows, mats[0].fwd.cols, mats[0].fwd.vals)) / 1e9
    xs, ys = dist_col.shard_columns(x, mesh), [y] * P
    del x
    shards = dist_col.shard_col_params(params, mesh)
    with deterministic():
        loss, acc, grads = dist_col.col_loss_and_grad(shards, mats, xs, ys, config, n, mesh)
    torch.cuda.synchronize()
    compare_steps(f"column -P {P} -R 0", (loss, acc, dist_col.gather_col_params(grads, mesh)), ref,
                  "single-card exact COO")
    del grads, ref
    torch.cuda.empty_cache()
    step = dist_col.make_col_train_step(config, mesh, n)
    state = dist_col.shard_col_state(adam.adam_init(params), mesh)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the column path's epochs start here
    out = dict(losses=[], epoch_seconds=[])
    for e in range(COL_EPOCHS):
        t0 = time.perf_counter()
        shards, state, loss, acc = step(shards, state, mats, xs, ys)
        out["losses"].append(float(loss))  # waits for the card
        out["epoch_seconds"].append(time.perf_counter() - t0)
        log(f"  column f32 epoch {e} {out['losses'][-1]} {float(acc)} {out['epoch_seconds'][-1]}")
    torch.cuda.synchronize()
    expect_launches(counts(), {})  # ... and end here: the COO engine launches no kernel of the port
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in out["losses"]):
        raise AssertionError(f"column losses {out['losses']}: not finite")
    steady = sorted(out["epoch_seconds"][1:])
    out["epoch_s_median"] = steady[len(steady) // 2]
    full = dist_col.gather_col_params(shards, mesh)
    if [tuple(layer["W"].shape) for layer in full] != [(a, b) for a, b in zip(COL_SIZES, COL_SIZES[1:])]:
        raise AssertionError(f"gathered column parameters {[tuple(la['W'].shape) for la in full]}")
    log(f"  column -P {P} -R 0: sizes {COL_SIZES}, Âᵀ {mat_gb:.2f} GB held once on {dev}; f32 epoch median"
        f" (epochs 1-{COL_EPOCHS - 1}) {out['epoch_s_median']:.4f} s; peak memory {out['peak_mem_gb']:.2f} GB;"
        f" no kernel of the port launched (COO engine)")
    return out


# ---------------------------------------------------------------------------
# the O(nnz) engines: edge (path A) and gather (path B)


def check_and_time(label, run, reference, dtype, reps, plain, plain_reps, repeat: bool = False):
    """Check the kernel call ``run()`` against ``reference()`` (see
    check_close), with ``repeat`` a second call equal bit for bit, then time
    ``plain()`` and the kernel; returns ((max_err, tolerance used), kernel
    ms, plain ms), the plain ms None for ``plain_reps=0``."""
    got = run()
    torch.cuda.synchronize()
    check = check_close(label, got, reference(), dtype)
    if repeat:
        again = run()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: two launches differ")
        del again
    del got
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(plain, plain_reps) if plain_reps else None
    return check, cuda_ms(run, reps), plain_ms


def time_against_plain(label, kernel, plain, args, dtype, reps, plain_reps, repeat: bool = False):
    """:func:`check_and_time` for the CSR kernel ``kernel(*args)`` against
    its plain version, summed in float64 for a float kernel."""
    from mg_gcn_tpu_torch.ops.spmm_edges import csr_plain

    reference = (lambda: plain(*args)) if dtype == "int8" else (lambda: csr_plain(*args, torch.float64))
    return check_and_time(label, lambda: kernel(*args), reference, dtype, reps, lambda: plain(*args), plain_reps,
                          repeat)


def walk_geometry(label: str, geometry: dict) -> dict:
    """The CSR walk's launch geometry for a kernels-line row (lanes L and
    groups G a warp, grid, threads, resident blocks an SM), logged."""
    keep = {k: geometry[k] for k in ("lanes", "groups", "grid_x", "threads", "blocks_per_sm", "resident_blocks")}
    log(f"  {label}: two launches equal bit for bit; walk geometry {keep}")
    return {"repeat_equal": True, "geometry": keep}


def hub_graph():
    """tests/test_torch_port_cuda.py's hub graph: random_graph(5000, 16,
    seed=4) with weights rng(1).random + 0.5, a hub row 7 of degree 5,000
    and empty rows 100..199."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import CSRData

    g = sparse.random_graph(5000, 16, seed=4, weights="uniform")
    rows = [g.indices[g.indptr[r] : g.indptr[r + 1]] for r in range(g.nrows)]
    rows[7] = np.arange(5000, dtype=np.int32)
    for r in range(100, 200):
        rows[r] = rows[r][:0]
    indptr = np.r_[0, np.cumsum([len(c) for c in rows])].astype(np.int64)
    data = np.random.default_rng(1).random(indptr[-1], np.float32) + 0.5
    return CSRData(indptr, np.concatenate(rows).astype(np.int32), data, g.shape)


def sum_bound_use(label: str, got, exact, mag, terms) -> float:
    """A float32 sum ``got`` of ``terms`` terms element by element within
    4 sqrt(terms + 2) 2^-24 ``mag`` of ``exact`` (float64 sums of the same
    rounded terms and of their magnitudes; a float32 sum of that many terms
    in any order stays inside it; a dropped or doubled term does not);
    returns the share of the bound used."""
    if not torch.is_tensor(terms):
        terms = torch.tensor(float(terms), dtype=torch.float64, device=got.device)
    bound = 4.0 * (terms + 2).sqrt() * 2.0**-24 * mag
    diff = (got.double() - exact).abs()
    use = float((diff / bound.clamp_min(1e-300)).max()) if diff.numel() else 0.0
    if not bool((diff <= bound).all()):
        raise AssertionError(f"{label}: outside the float32 sum bound ({use:.3f} of it)")
    return use


def within_sum_bound(label: str, got, indptr, indices, w, b) -> float:
    """A float CSR kernel against its plain version summed in float64 on the
    same rounded inputs, within :func:`sum_bound_use`'s bound at each row's
    degree; returns the share of the bound used."""
    from mg_gcn_tpu_torch.ops.spmm_edges import csr_plain

    exact = csr_plain(indptr, indices, w, b, torch.float64)
    mag = csr_plain(indptr, indices, None if w is None else w.abs(), b.abs(), torch.float64)
    return sum_bound_use(label, got, exact, mag, indptr.diff().double()[:, None])


def phase_csr_walk_small() -> None:
    """The walk's narrow group sizes on the hub graph: ``edge`` {bfloat16,
    float32}, ``edge_i8`` and ``edge_t`` {bfloat16, float32} (over the hub
    graph's transpose: a column of 5,000 entries, empty columns) at d_pad 8
    (16 groups of 2 lanes) and 16 (8 of 4), each against its plain version
    summed in float64 (float within the float32 sum bound, int8 equal),
    empty rows zero, two launches equal bit for bit."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.ops import spmm_edges as se

    g = hub_graph()
    ip, ix = torch.from_numpy(g.indptr).cuda(), torch.from_numpy(g.indices).cuda()
    w32 = torch.from_numpy(g.data).cuda()
    wq = torch.from_numpy(np.random.default_rng(2).integers(-127, 128, g.nnz).astype(np.int8)).cuda()
    mat = se.edge_tile_mat_from_csr(sparse.transpose(g), dtype="float32", device="cuda", merge=False)
    t = se.transposed_schedule(mat)
    for d_pad in (8, 16):
        cases = [("edge", dtype, se.edge, (ip, ix, w32.to(se.DTYPES[dtype]))) for dtype in ("bfloat16", "float32")]
        cases += [("edge_i8", "int8", se.edge_i8, (ip, ix, wq))]
        cases += [("edge_t", dtype, se.edge_t, (t.t_indptr, t.t_rows, t.perm, mat.w.to(se.DTYPES[dtype])))
                  for dtype in ("bfloat16", "float32")]
        for name, dtype, kernel, head in cases:
            label = f"{name} {dtype} d_pad={d_pad} (hub graph)"
            b = operand(g.nrows, d_pad, dtype, seed=d_pad)
            got, again = kernel(*head, b), kernel(*head, b)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: two launches differ")
            if name == "edge_t":  # the walk over (t_indptr, t_rows) with the weights through perm
                args = (t.t_indptr, t.t_rows, head[3][t.perm.long()], b)
            else:
                args = (*head, b)
            if dtype == "int8":
                if not torch.equal(got, se.edge_i8_plain(*args)):
                    raise AssertionError(f"{label}: differs from the plain version")
                use = 0.0
            else:
                use = within_sum_bound(label, got, *args)
            empty = args[0].diff() == 0
            if bool(got[empty].any()) or not bool(empty[100:200].all()):
                raise AssertionError(f"{label}: an empty row is not zero")
            geo = se.csr_walk_geometry(d_pad)
            log(f"  {label}: two launches equal bit for bit; {geo['groups']} groups of {geo['lanes']} lanes;"
                f" sum bound used {use:.3f}")
            del got, again


def phase_csr_kernels_small() -> None:
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.ops import spmm_edges as se
    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    g = sparse.random_graph(N_SMALL, DEG_SMALL, seed=3, weights="uniform")
    ip, ix = torch.from_numpy(g.indptr).cuda(), torch.from_numpy(g.indices).cuda()
    wq = torch.from_numpy(np.random.default_rng(4).integers(-127, 128, g.nnz).astype(np.int8)).cuda()
    for dtype in DTYPES:
        name = "edge_i8" if dtype == "int8" else "edge"
        kernel, plain = (se.edge_i8, se.edge_i8_plain) if dtype == "int8" else (se.edge, se.edge_plain)
        w = wq if dtype == "int8" else torch.from_numpy(g.data).cuda().to(se.DTYPES[dtype])
        for d in EDGE_WIDTHS:
            b = operand(N_SMALL, d, dtype, seed=d)
            (err, use), ms, plain_ms = time_against_plain(f"{name} {dtype} d={d}", kernel, plain, (ip, ix, w, b),
                                                          dtype, 10, 3)
            log(f"  {name:7s} {dtype:8s} d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f})"
                f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")
    g = sparse.random_graph(N_SMALL, DEG_GATHER_SMALL, seed=5)
    ip, ix = torch.from_numpy(g.indptr).cuda(), torch.from_numpy(g.indices).cuda()
    wts = torch.from_numpy(np.random.default_rng(6).random(g.nnz, np.float32) + 0.5).cuda()
    for mode, w, dtype in (("weighted", wts, "float32"), ("binary", None, "float32"),
                           ("binary stream", None, "bfloat16")):
        for d in GATHER_WIDTHS + (1,):
            b = operand(N_SMALL, d, dtype, seed=d)
            (err, use), ms, plain_ms = time_against_plain(
                f"gather {mode} d={d}", sg.gather, sg.gather_plain, (ip, ix, w, b), dtype, 10, 3)
            log(f"  gather  {mode:13s} d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f})"
                f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")


def drive_path(engine: str, ds, hidden, runs, impl: str = "auto", phases: bool = False,
               keep_pair: bool = False) -> dict:
    """One path through the entry points a user calls:
    ``build_agg_pair(impl=impl)`` must give ``engine`` (impl="auto" must
    pick it); its float32 step is held against the COO engine (with
    ``phases``, the step's phase times are logged first: one warm and
    PHASE_EPOCHS traced epochs of :func:`profile_step`); then
    ``train(impl=impl)`` for each (pattern_dtype, epochs) of ``runs`` with
    finite losses. The launch counters are zeroed just before and read just
    after. ``keep_pair`` keeps the float32 pair in the result's "pair"."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import ENGINE_OF, build_agg_pair, make_train_step, train

    dev = torch.device("cuda")
    config = GCNConfig(sizes=(ds.num_features, *hidden, ds.num_labels))
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    params = init_params(config, device=dev)
    out = {}

    reset_counts()  # the path starts here
    t0 = time.perf_counter()
    pair = build_agg_pair(ds.graph, impl=impl, pattern_dtype="float32", device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    if ENGINE_OF[type(pair.fwd)] != engine:
        raise AssertionError(f"impl={impl!r} chose {type(pair.fwd).__name__}, not the {engine} engine")
    step = loss_and_grad(params, pair, x, y, config)
    torch.cuda.synchronize()
    if phases:
        totals, attributed = profile_step(f"{engine} path, float32", make_train_step(config),
                                          (params, adam.adam_init(params), pair, x, y, None))
        kernel_ms = kernel_ms_by_scope(attributed)
        log(f"  {engine} kernel events by scope, ms an epoch: { {k: round(v, 4) for k, v in kernel_ms.items()} };"
            f" the rest of the phase sum: {sum(totals.values()) - sum(kernel_ms.values()):.4f} ms")
    out["fwd"] = pair.fwd  # the forward matrix, for the kernels at this path's shape
    if keep_pair:
        out["pair"] = pair
    del pair
    t0 = time.perf_counter()
    coo = coo_pair_on_card(ds.graph)
    torch.cuda.synchronize()
    out["coo_build_s"] = time.perf_counter() - t0
    step_coo = coo_step(params, coo, x, y, config)
    torch.cuda.synchronize()
    del coo
    torch.cuda.empty_cache()
    compare_with_coo(engine, step, step_coo)
    del step, step_coo

    torch.cuda.reset_peak_memory_stats()
    for dtype, epochs in runs:
        res = train(ds, hidden, epochs=epochs, impl=impl, pattern_dtype=dtype, device=dev)
        if res.engine != engine or not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"{engine} {dtype} run: engine {res.engine}, losses {res.losses}")
        out[dtype] = dict(losses=res.losses, accs=res.accs, epoch_seconds=res.epoch_seconds)
        for e, (loss, acc, sec) in enumerate(zip(res.losses, res.accs, res.epoch_seconds)):
            log(f"  {engine} {dtype} epoch {e} {loss} {acc} {sec}")
    torch.cuda.synchronize()
    out["launches"] = counts()  # the path ends here
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches on the path: { {k: v for k, v in out['launches'].items() if v} }")
    log(f"  {engine} pair build {out['build_s']:.2f} s, COO pair build {out['coo_build_s']:.1f} s,"
        f" peak memory in training {out['peak_mem_gb']:.2f} GB")
    return out


def phase_engines_binary(ds, own: str, own_median: float, runs) -> None:
    """Other engines on a binary graph where impl="auto" picks ``own``
    (bfloat16 epoch median ``own_median``): ``train`` with each (impl,
    dtype) of ``runs``, EPOCHS epochs each, for the rule of impl="auto"
    (ROADMAP queue 1 item 5b). Losses must be finite; no launch counter is
    read."""
    from mg_gcn_tpu_torch.train import train

    for impl, dtype in runs:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train(ds, HIDDEN, epochs=EPOCHS, impl=impl, pattern_dtype=dtype, device="cuda", log=False)
        total = time.perf_counter() - t0
        if res.engine != impl or not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"{impl} on the binary graph: engine {res.engine}, losses {res.losses}")
        steady = sorted(res.epoch_seconds[1:])
        log(f"  {impl} {dtype} on the binary graph: epoch median (epochs 1-{EPOCHS - 1})"
            f" {steady[len(steady) // 2]:.5f} s ({own} bfloat16 {own_median:.5f} s),"
            f" epochs {res.epoch_seconds}, losses {res.losses[0]} -> {res.losses[-1]},"
            f" peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, build + train {total:.1f} s")
        del res
        torch.cuda.empty_cache()


def expect_launches(launches: dict, want: dict) -> None:
    """``want``: {(kernel name, dtype): launches}; every other kernel of the
    port must not have launched on the path."""
    for name, per in launches.items():
        for dtype in {dt for dt, _ in per} | {dt for n, dt in want if n == name}:
            got, exp = per_dtype(launches, name, dtype), want.get((name, dtype), 0)
            if got != exp:
                raise AssertionError(f"{name} {dtype}: {got} launches on the path, want {exp}")


SCAN_EPOCHS, SCAN_CALLS = 3, 3


def flat_counts() -> dict:
    """{(kernel, dtype, d_pad): launches} of every wrapper, nonzero only."""
    return {(name, dt, dp): n for name, per in counts().items() for (dt, dp), n in per.items() if n}


def traced_call(run) -> tuple[float, float, collections.Counter]:
    """One ``run()`` under torch.profiler, settled at both ends: (the device's busy ms, the union
    of its kernel, copy and memset events, the primer left out; the traced window's ms, from the
    first device event's start to the last one's end; the port's kernel
    events by full name). Zeros and an empty Counter when the trace holds
    no device event."""
    from torch.profiler import ProfilerActivity, profile

    from mg_gcn_tpu_torch.timers import settle_profiler
    from mg_gcn_tpu_torch.xplane import device_events, trace_events

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        settle_profiler()
        run()
        settle_profiler(start=False)
    device = device_events(trace_events(prof))
    if not device:
        return 0.0, 0.0, collections.Counter()
    window = (max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in device) - min(float(e["ts"]) for e in device))
    return busy_ms(device), window / 1e3, collections.Counter(
        e["name"] for e in device if e.get("cat") == "kernel" and port_event_piece(e["name"]) is not None)


TRACE_START_TRACES = 25


def trace_start_check(label: str, run) -> None:
    """The profiler's start-up loss on ``run()``: TRACE_START_TRACES traces
    whose work starts as soon as the profiler has and ends it at once, and
    as many settled at both ends (``timers.settle_profiler``). A trace is
    whole when its port
    kernel events equal the launches the wrappers counted in it, kernel by
    kernel. Logs the traces that are not, and the device events a trace
    holds; every settled trace must be whole."""
    from torch.profiler import ProfilerActivity, profile

    from mg_gcn_tpu_torch.timers import settle_profiler
    from mg_gcn_tpu_torch.xplane import device_events, trace_events

    def trace(settle: bool) -> tuple[int, bool]:
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if settle:
                settle_profiler()
            run()
            torch.cuda.synchronize()
            if settle:
                settle_profiler(start=False)
        device = device_events(trace_events(prof))
        kernels = collections.Counter(
            e["name"] for e in device if e.get("cat") == "kernel" and port_event_piece(e["name"]) is not None)
        return len(device), events_by_piece(kernels) == launches_by_piece(flat_counts())

    at_once = [trace(False) for _ in range(TRACE_START_TRACES)]
    settled = [trace(True) for _ in range(TRACE_START_TRACES)]
    sizes = lambda traces: dict(sorted(collections.Counter(n for n, _ in traces).items()))  # noqa: E731
    short_at_once = [n for n, whole in at_once if not whole]
    short_settled = [n for n, whole in settled if not whole]
    log(f"  trace start, {label}: traces missing port kernel events: started at once {len(short_at_once)} of"
        f" {TRACE_START_TRACES} (their device events {short_at_once}), settled {len(short_settled)} of"
        f" {TRACE_START_TRACES}; device events a trace: at once {sizes(at_once)}, settled {sizes(settled)}")
    if short_settled:
        raise AssertionError(f"trace start, {label}: settled traces missing port kernel events: {short_settled}")


def port_event_piece(name: str) -> str | None:
    """The piece of :data:`PORT_KERNEL_EVENTS` that names this device event."""
    return next((piece for piece, _ in PORT_KERNEL_EVENTS if piece in name), None)


def events_by_piece(events: collections.Counter) -> dict:
    out = collections.Counter()
    for name, n in events.items():
        out[port_event_piece(name)] += n
    return dict(out)


def launches_by_piece(launches: dict) -> dict:
    """Counted launches ({(kernel, dtype, d_pad): n}) by the piece of
    :data:`PORT_KERNEL_EVENTS` whose events they launch."""
    piece_of = {w: piece for piece, ws in PORT_KERNEL_EVENTS for w in ws}
    out = collections.Counter()
    for (name, _, _), n in launches.items():
        out[piece_of[name]] += n
    return dict(out)


def scan_path(label: str, config, model: str, pair, x, y, params, start_check: bool = False) -> None:
    """``train.make_scan_train_steps`` on one path at full width against
    ``make_train_step``'s eager epochs from the same parameters: the route
    must be "graph"; SCAN_EPOCHS replayed epochs must equal SCAN_EPOCHS
    eager ones bit for bit (losses, accuracies, parameters, Adam moments and
    step count; where two eager runs differ, within rtol 1e-5, and the line
    says so), on the capturing call and on a replay-only call.

    Launches: the wrappers count host launches only, so eager's counted
    launches must equal its traced call's port kernel events, kernel by
    kernel; the capturing call counts (SCAN_WARMUP_STEPS + 1) epochs' worth
    (the warm-up steps and the captured epoch); replay-only calls count
    none; and a traced replay-only call's port kernel events must equal the
    traced eager call's, name by name: the replayed graph launches every
    kernel of the step as often as eager, none dropped or repeated.

    Logs on one line: the warm-up and capture seconds, the per-epoch median
    of SCAN_CALLS replay calls and of SCAN_CALLS eager calls (SCAN_EPOCHS
    steps, one read at the end), each traced call's device-busy ms and its
    busy share of its own traced window, and peak memory above the same
    base (what was allocated when the path started, garbage collected).
    ``start_check`` first runs :func:`trace_start_check` on the eager call."""
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import SCAN_WARMUP_STEPS, _leaves, make_scan_train_steps, make_train_step

    step, opt = make_train_step(config, model=model), adam.adam_init(params)
    steps = make_scan_train_steps(config, SCAN_EPOCHS, model=model)

    def eager():
        p, o, losses, accs = params, opt, [], []
        for _ in range(SCAN_EPOCHS):
            p, o, loss, acc = step(p, o, pair, x, y, None)
            losses.append(loss)
            accs.append(acc)
        return p, o, torch.stack(losses), torch.stack(accs)

    def replay():
        return steps(params, opt, pair, x, y, None)

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / SCAN_EPOCHS

    def leaves(run_out):
        p, o, losses, accs = run_out
        return _leaves(p, o) + [losses, accs]

    def compare(what, got, want, exact):
        for a, b in zip(leaves(got), leaves(want), strict=True):
            if exact and not torch.equal(a, b):
                raise AssertionError(f"scan {label}: {what} differs from the eager epochs")
            if not exact:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=f"scan {label}: {what} vs eager")

    gc.collect()  # as the capture does (torch.cuda.graph): both peaks from the same base
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ref = eager()
    torch.cuda.synchronize()
    eager_launches = flat_counts()
    exact = all(torch.equal(a, b) for a, b in zip(leaves(eager()), leaves(ref)))
    if not exact and model != "gat":
        raise AssertionError(f"scan {label}: two eager runs of the step differ")
    eager_s = sorted(timed(eager)[1] for _ in range(SCAN_CALLS))
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    if start_check:
        trace_start_check(f"{label} eager, {SCAN_EPOCHS} epochs", eager)
    reset_counts()
    eager_busy, eager_window, eager_events = traced_call(eager)
    if events_by_piece(eager_events) != launches_by_piece(flat_counts()):
        raise AssertionError(f"scan {label}: the traced eager call's kernel events {events_by_piece(eager_events)}"
                             f" != its counted launches {launches_by_piece(flat_counts())}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got = replay()
    torch.cuda.synchronize()
    first_launches = flat_counts()
    if steps.route != "graph" or len(steps.captures) != 1:
        raise AssertionError(f"scan {label}: route {steps.route}, {len(steps.captures)} captures; want one graph")
    compare("the capturing call", got, ref, exact)
    want_first = {k: n * (SCAN_WARMUP_STEPS + 1) // SCAN_EPOCHS for k, n in eager_launches.items()}
    if first_launches != want_first:
        raise AssertionError(f"scan {label}: the capturing call counted {first_launches}, want {want_first}")
    reset_counts()
    replays = [timed(replay) for _ in range(SCAN_CALLS)]
    torch.cuda.synchronize()
    if flat_counts():
        raise AssertionError(f"scan {label}: replay-only calls counted host launches {flat_counts()}")
    compare("a replay-only call", replays[-1][0], ref, exact)
    replay_s = sorted(s for _, s in replays)
    replay_peak = torch.cuda.max_memory_allocated() / 1e9
    replay_busy, replay_window, replay_events = traced_call(replay)
    if replay_events != eager_events:
        raise AssertionError(f"scan {label}: the replayed kernel events differ from eager's:"
                             f" replay - eager {dict(replay_events - eager_events)},"
                             f" eager - replay {dict(eager_events - replay_events)}")
    cap = steps.captures[0]
    med_r, med_e = replay_s[SCAN_CALLS // 2], eager_s[SCAN_CALLS // 2]
    share = lambda busy, window: f"{busy / window:.4f}" if window else "not measured"  # noqa: E731
    log(f"  scan {label}: route graph; warm-up {cap['warmup_s']:.3f} s ({SCAN_WARMUP_STEPS} steps), capture"
        f" {cap['capture_s']:.3f} s; per epoch (median of {SCAN_CALLS} calls of {SCAN_EPOCHS}) replay"
        f" {med_r * 1e3:.3f} ms, eager {med_e * 1e3:.3f} ms ({med_r / med_e:.4f}); traced call of {SCAN_EPOCHS}"
        f" epochs: replay busy {replay_busy:.3f} of {replay_window:.3f} ms (share {share(replay_busy, replay_window)}),"
        f" eager busy {eager_busy:.3f} of {eager_window:.3f} ms (share {share(eager_busy, eager_window)}); peak"
        f" memory eager {eager_peak:.2f} GB, replay {replay_peak:.2f} GB (base {base:.2f} GB); replayed kernel"
        f" events of {SCAN_EPOCHS} epochs = eager's = its counted launches, {events_by_piece(replay_events)};"
        f" {'equal to eager bit for bit' if exact else 'two eager runs differ: held within rtol 1e-5'}")
    del steps
    torch.cuda.empty_cache()


def phase_scan_main(ds, main_pair) -> None:
    """Phase 5s: the main path's model on phase 5's pattern pair in bf16,
    int8 and float32 (the pair's dtype replaced, one pack), then SAGE's
    (BASELINE config 4, bf16) on the same pack, each through
    :func:`scan_path`."""
    from mg_gcn_tpu_torch.models import sage
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params
    from mg_gcn_tpu_torch.ops.spmm import AggPair

    dev = torch.device("cuda")
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    config = GCNConfig(sizes=(FEATURES, *HIDDEN, CLASSES))
    for dtype in ("bfloat16", "int8", "float32"):
        pair = AggPair(*(dataclasses.replace(m, dtype_name=dtype) for m in main_pair))
        scan_path(f"main {dtype}", config, "gcn", pair, x, y, init_params(config, device=dev))
    config = sage.SAGEConfig(sizes=SAGE_SIZES)
    pair = sage.build_sage_pair(ds.graph, impl="pattern", pack=main_pair[0].pack, dtype="bfloat16", device=dev)
    scan_path("SAGE bfloat16", config, "sage", pair, x, y, sage.init_params(config, device=dev))


def phase_scan_gat(ds, graph) -> None:
    """Phase 13s: the GAT headline (phase 12's model and attention graph,
    bf16, 2 heads) through :func:`scan_path`."""
    from mg_gcn_tpu_torch.models import gat

    dev = torch.device("cuda")
    labels = ds.labels.reshape(-1)
    x = torch.from_numpy(gat_features(labels)).to(dev)
    y = torch.from_numpy(labels.astype(np.int64)).to(dev)
    config = gat.GATConfig(sizes=GAT_SIZES, heads=GAT_HEADS)
    scan_path("GAT bfloat16", config, "gat", graph, x, y, gat.init_params(config, None, device=dev))


def path_a_dataset(ds):
    """bench.py's weighted section: the main path's graph with edge values
    rng(5).random + 0.5 (bench.py:386-399)."""
    from mg_gcn_tpu_torch.formats import CSRData, Dataset

    g = ds.graph
    w = np.random.default_rng(5).random(g.nnz, np.float32) + 0.5
    return Dataset(graph=CSRData(g.indptr, g.indices, w, g.shape), features=ds.features, labels=ds.labels,
                   sets=ds.sets)


def path_b_dataset():
    """BASELINE config 2 on one card, bench.py's uniform products section:
    random_graph(2,449,029, 50, seed=3), 100 features and 48 labels from
    rng(4) (bench.py:586, 607, 697-699)."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset

    t0 = time.perf_counter()
    g = sparse.random_graph(N_PROD, DEG_PROD, seed=3)
    rng = np.random.default_rng(4)
    x = rng.random((N_PROD, FEATURES_PROD), np.float32)
    y = rng.integers(0, CLASSES_PROD, N_PROD).astype(np.int32)
    log(f"  graph n={g.nrows} nnz={g.nnz} built in {time.perf_counter() - t0:.1f} s")
    return Dataset(graph=g, features=x, labels=y.reshape(-1, 1), sets=np.zeros((N_PROD, 1), np.int32))


def phase_edge_main(fwd, launches: dict) -> list[dict]:
    """The edge kernels at path A's shape (its forward matrix Âᵀ), each mode
    x width against its plain version, timed beside its bound and beside
    torch.sparse.mm on the same float32 CSR."""
    from mg_gcn_tpu_torch.formats import CSRData
    from mg_gcn_tpu_torch.ops import spmm_edges as se

    host = CSRData(fwd.indptr.cpu().numpy(), fwd.indices.cpu().numpy(), fwd.w.cpu().numpy(), (fwd.n_out, fwd.n_in))
    weights = {"float32": fwd.w, "bfloat16": fwd.w.to(torch.bfloat16),
               "int8": se.edge_tile_mat_from_csr(host, dtype="int8", device="cuda").wq}
    del host
    lib = csr_library(fwd.indptr, fwd.indices, fwd.w, (fwd.n_out, fwd.n_in))
    rows = []
    for dtype in DTYPES:
        name = "edge_i8" if dtype == "int8" else "edge"
        kernel, plain = (se.edge_i8, se.edge_i8_plain) if dtype == "int8" else (se.edge, se.edge_plain)
        for d in (128, 41):
            b = operand(fwd.n_in, d, dtype, seed=d)
            label = f"{name} {dtype} d={d} (path A shape)"
            check, ms, plain_ms = time_against_plain(label, kernel, plain,
                                                     (fwd.indptr, fwd.indices, weights[dtype], b), dtype, 5, 1,
                                                     repeat=True)
            extra = walk_geometry(label, se.edge_geometry(name, fwd.n_out, b.shape[1], b.dtype))
            library_ms = None
            if dtype == "float32":
                bl = b[:, :d].contiguous()
                library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
            moved = (8 * (fwd.n_out + 1) + 4 * fwd.nnz + elt_size(weights[dtype]) * fwd.nnz
                     + fwd.n_in * d * elt_size(b) + fwd.n_out * d * 4)
            rows.append(kernel_row(name, dtype, d, fwd.n_out, fwd.nnz, launches[name].get((dtype, b.shape[1]), 0),
                                   check, ms, plain_ms, library_ms, moved) | extra)
            log_row(rows[-1])
    cross_engine("path A's Âᵀ (edge regime)", fwd, fwd.w, rows)
    return rows


def cross_engine(where: str, mat, w32, rows: list[dict]) -> None:
    """Logs the other O(nnz) engine's kernel on the matrix of a path, beside
    that path's own rows, for the rule of impl="auto" (ROADMAP queue 1 item
    5b): on ``mat`` (CSR on the card, float32 weights ``w32`` or None for a
    binary matrix), ``gather`` in float32 and with the bfloat16 operand
    stream, and ``edge`` in float32 and bfloat16 (weights of ones for a
    binary matrix), each checked against its plain version. Not part of
    the kernels line: no path runs these launches."""
    from mg_gcn_tpu_torch.ops import spmm_edges as se
    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    ones = torch.ones(mat.nnz, device="cuda") if w32 is None else w32
    own = {(r["name"], r["dtype"], r["d"]): r["ms"] for r in rows}
    for d in sorted({r["d"] for r in rows}, reverse=True):
        for name, dtype, kernel, plain, w in (
            ("gather", "float32", sg.gather, sg.gather_plain, w32),
            ("gather", "bfloat16", sg.gather, sg.gather_plain, w32),
            ("edge", "float32", se.edge, se.edge_plain, ones),
            ("edge", "bfloat16", se.edge, se.edge_plain, ones.to(torch.bfloat16)),
        ):
            if (name, dtype, d) in own:
                continue
            b = operand(mat.n_in, d, dtype, seed=d)
            (err, use), ms, _ = time_against_plain(f"{name} {dtype} d={d} on {where}", kernel, plain,
                                                   (mat.indptr, mat.indices, w, b), dtype, 5, 0)
            log(f"  cross-engine on {where}: {name} {dtype} B d={d}: {ms:.3f} ms, max_err {err:.3e}"
                f" (tolerance used {use:.3f})")
            del b
            torch.cuda.empty_cache()


def phase_gather_main(fwd, launches: dict, where: str, runs) -> list[dict]:
    """The gather kernel at a binary path's shape (its forward matrix,
    ``fwd``), for each (operand dtype, width) of ``runs`` against the plain
    version, timed beside the bound and (float32) beside torch.sparse.mm on
    the same float32 CSR; returns a row each."""
    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    ones = torch.ones(fwd.nnz, device="cuda")
    lib = csr_library(fwd.indptr, fwd.indices, ones, (fwd.n_out, fwd.n_in))
    del ones
    measured = []
    for dtype, d in runs:
        b = operand(fwd.n_in, d, dtype, seed=d)
        label = f"gather {dtype} d={d} ({where} shape)"
        check, ms, plain_ms = time_against_plain(label, sg.gather, sg.gather_plain,
                                                 (fwd.indptr, fwd.indices, None, b), dtype, 5, 1, repeat=True)
        extra = walk_geometry(label, sg.gather_geometry(fwd.n_out, b.shape[1], b.dtype, False))
        library_ms = None
        if dtype == "float32":
            bl = b[:, :d].contiguous()
            library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
            del bl
        moved = 8 * (fwd.n_out + 1) + 4 * fwd.nnz + fwd.n_in * d * elt_size(b) + fwd.n_out * d * 4
        measured.append(kernel_row("gather", dtype, d, fwd.n_out, fwd.nnz,
                                   launches["gather"].get((dtype, b.shape[1]), 0),
                                   check, ms, plain_ms, library_ms, moved) | extra)
        log_row(measured[-1])
        del b
        torch.cuda.empty_cache()
    del lib
    return measured


# ---------------------------------------------------------------------------
# the halo exchange and the serial-gather ring: -P 4 on one card (gather)


def normalized_pair_on_card(graph, gcn: bool):
    """The host CSR pair of ``graph``'s normalized adjacency, computed on the
    card (:func:`normalized_on_card`, :func:`transpose_on_card`): GCN
    (``gcn``) (Âᵀ, Â), SAGE (M, Mᵀ); held equal to ``sparse.normalize`` and
    ``sparse.transpose`` in phase 3."""
    from mg_gcn_tpu_torch.formats import CSRData

    rows, cols, vals = normalized_on_card(graph, gcn)
    t_indptr, t_indices, t_vals = transpose_on_card(rows, cols, vals, graph.shape)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    a = CSRData(graph.indptr, graph.indices, host(vals), graph.shape)
    a_t = CSRData(host(t_indptr), host(t_indices), host(t_vals), graph.shape[::-1])
    del rows, cols, vals, t_indptr, t_indices, t_vals
    torch.cuda.empty_cache()
    return (a_t, a) if gcn else (a, a_t)


def phase_normalize_on_card_small() -> None:
    """:func:`normalized_pair_on_card` equals ``sparse.normalize`` and
    ``sparse.transpose`` bit for bit (both normalizations) on the phase's
    n = 20,000 graph, weighted and binary."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import CSRData

    g = sparse.random_graph(N_SMALL, DEG_GATHER_SMALL, seed=5, weights="uniform")
    for graph in (g, CSRData(g.indptr, g.indices, np.ones_like(g.data), g.shape)):
        for gcn in (True, False):
            a = sparse.normalize(graph, axis=gcn)
            want = (sparse.transpose(a), a) if gcn else (a, sparse.transpose(a))
            for got, ref in zip(normalized_pair_on_card(graph, gcn), want):
                if got.shape != ref.shape or not all(np.array_equal(getattr(got, k), getattr(ref, k))
                                                     for k in ("indptr", "indices", "data")):
                    raise AssertionError(f"normalized_pair_on_card(gcn={gcn}) differs from sparse.normalize")
    log("  normalized_pair_on_card equals sparse.normalize + sparse.transpose bit for bit (GCN and SAGE)")


def phase_gather_halo_small() -> None:
    """The gather kernel at halo-block shapes: every block of partition 0 of
    a DistHaloGatherMat at P = 4 on cuda:0 (the diagonal m_loc × m_loc and
    each round's m_loc × w_s; a banded graph's narrow halos, w_s ≪ m_loc,
    one round empty, and a uniform graph's, w_s ≈ m_loc), weighted, float32,
    at d_pad 8, 48, 104 and 256: against the plain version summed in float64
    (check_close), two launches equal bit for bit."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import CSRData
    from mg_gcn_tpu_torch.ops import spmm_gather as sg
    from mg_gcn_tpu_torch.parallel import dist, dist_halo

    mesh = dist.make_mesh(DIST_PARTS, ["cuda:0"] * DIST_PARTS)
    for kind in ("banded", "uniform"):
        if kind == "banded":
            g = sparse.banded_graph(N_SMALL, 16, N_SMALL // (4 * DIST_PARTS), seed=BAND_SEED)
        else:
            g = sparse.random_graph(N_SMALL, DEG_GATHER_SMALL, seed=5)
        w = np.random.default_rng(6).random(g.nnz, np.float32) + 0.5
        mat = dist_halo.DistHaloGatherMat.from_csr(sparse.normalize(CSRData(g.indptr, g.indices, w, g.shape),
                                                                   axis=True), mesh)
        for r, blk in enumerate([mat.loc[0], *mat.rem[0]]):
            for d in HALO_SMALL_WIDTHS:
                b = operand(blk.n_in, d, "float32", seed=d + r)
                label = f"gather halo block {r} of partition 0, {kind}, {blk.n_out} x {blk.n_in}, d={d}"
                (err, use), ms, plain_ms = time_against_plain(label, sg.gather, sg.gather_plain,
                                                              (blk.indptr, blk.indices, blk.w, b), "float32", 3, 1,
                                                              repeat=True)
                log(f"  {label}: {blk.nnz} entries, max_err {err:.3e} (tolerance used {use:.3f}), two launches"
                    f" equal; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
        del mat
    torch.cuda.empty_cache()


def padded_products(ds_b):
    """Path B's dataset padded with empty rows and columns to
    N_PROD_DIST = 2,449,032 nodes (a multiple of 4, as prep pads node counts
    to multiples of 8); the padded rows' features and labels 0."""
    from mg_gcn_tpu_torch.formats import CSRData, Dataset

    g, n = ds_b.graph, ds_b.num_nodes
    indptr = np.concatenate([g.indptr, np.full(N_PROD_DIST - n, g.indptr[-1])])
    x = np.zeros((N_PROD_DIST, ds_b.num_features), np.float32)
    x[:n] = ds_b.features
    y = np.zeros((N_PROD_DIST, 1), np.int32)
    y[:n] = ds_b.labels
    return Dataset(graph=CSRData(indptr, g.indices, g.data, (N_PROD_DIST, N_PROD_DIST)), features=x, labels=y,
                   sets=np.zeros((N_PROD_DIST, 1), np.int32))


def gcn_products_by_width(config) -> tuple[dict, dict]:
    """({d_pad: forward products}, {d_pad: backward products}) of one
    parity-mode GCN epoch: a forward product a layer at the width it
    aggregates, a backward product a layer but layer 0, at the same width."""
    fwd: dict = {}
    bwd: dict = {}
    for i in range(config.num_layers):
        meta = config.layer_meta(i)
        d_pad = -(-max(meta["out"] if meta["lin_first"] else meta["in_"], 8) // 8) * 8
        fwd[d_pad] = fwd.get(d_pad, 0) + 1
        if meta["backward_spmm"]:
            bwd[d_pad] = bwd.get(d_pad, 0) + 1
    return fwd, bwd


def gcn_launches_by_width(config, parts: int, blocks: int) -> dict:
    """{d_pad: gather launches} of one parity-mode GCN epoch at ``parts``
    partitions of ``blocks`` blocks each (:func:`gcn_products_by_width`)."""
    fwd, bwd = gcn_products_by_width(config)
    return {d: (fwd.get(d, 0) + bwd.get(d, 0)) * parts * blocks for d in fwd | bwd}


def run_dist_epochs(label: str, step, params, mesh, pair, xs, ys, epochs: int) -> dict:
    """``epochs`` steps of a dist train step from ``params``; logs each
    epoch; returns losses, seconds, their median (epochs 1 on) and the peak
    memory."""
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.parallel import dist

    p, st = dist.replicate(params, mesh), dist.replicate(adam.adam_init(params), mesh)
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for e in range(epochs):
        t0 = time.perf_counter()
        p, st, loss, acc = step(p, st, pair, xs, ys, None)
        losses.append(float(loss))  # waits for the card
        seconds.append(time.perf_counter() - t0)
        log(f"  {label} epoch {e} {losses[-1]} {float(acc)} {seconds[-1]}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses} not finite, or not falling")
    steady = sorted(seconds[1:])
    return dict(losses=losses, epoch_seconds=seconds, median_s=steady[len(steady) // 2],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_products_dist(ds_b) -> dict:
    """BASELINE config 2 at -P 4 as the JAX package runs it, its 4
    partitions on cuda:0: path B's graph padded to n = 2,449,032
    (:func:`padded_products`; 100 → 256 → 256 → 48, no shape cut).
    ``train.dist_engine`` under impl="auto" must take the halo pair on the
    gather kernel (the pattern gate refuses its packs); the pair
    (``DistHaloPair.from_csr_pair``, built on the card) is held by one
    float32 step against the single-card COO step on the same padded graph
    by the rule of phase 4 (``dist_loss_and_grad``), then trains EPOCHS
    float32 epochs (``make_dist_train_step``). Then ``--impl gather``'s
    pair, ``DistGatherPair``, the same way. Each run's counters are zeroed
    before its float32 step and read after its epochs: exactly 5 SpMMs x 4
    partitions x 4 blocks = 80 gather launches an epoch (empty blocks
    launched), by width. Returns both runs and the halo pair."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params
    from mg_gcn_tpu_torch.parallel import dist, dist_halo
    from mg_gcn_tpu_torch.train import dist_engine

    dev = torch.device("cuda:0")
    P = DIST_PARTS
    t0 = time.perf_counter()
    ds = padded_products(ds_b)
    n = ds.num_nodes
    a_t, a = normalized_pair_on_card(ds.graph, gcn=True)
    log(f"  padded to n = {n}; Âᵀ and Â built on the card and copied to the host in"
        f" {time.perf_counter() - t0:.1f} s")
    config = GCNConfig(sizes=(FEATURES_PROD, *HIDDEN_PROD, CLASSES_PROD))
    params = init_params(config, device=dev)
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    coo = coo_pair_on_card(ds.graph)
    ref = coo_step(params, coo, x, y, config)
    del coo, x, y
    torch.cuda.empty_cache()

    mesh = dist.make_mesh(P, [dev] * P)
    kind, why = dist_engine(ds.graph, "auto", P, P, torch.cuda.get_device_properties(dev).total_memory)
    log(f"  dist_engine(impl='auto'): {kind} ({why})")
    if kind != "halo_gather":
        raise AssertionError(f"impl='auto' at -P {P} took {kind}, not the halo pair on the gather kernel")
    xs, ys, masks = dist.shard_dataset(ds, mesh)
    want = gcn_launches_by_width(config, P, P)
    out = {}
    for kind in ("halo_gather", "gather"):
        reset_counts()  # this run starts here
        t0 = time.perf_counter()
        pair = dist.build_pair(kind, a_t, a, mesh)
        torch.cuda.synchronize()
        run = dict(build_s=time.perf_counter() - t0)
        if kind == "halo_gather":
            fwd = pair.fwd
            run.update(moved=P * sum(fwd.round_widths), halo_total=fwd.halo_total, round_widths=fwd.round_widths)
            log(f"  DistHaloPair (gather engine) built on the card in {run['build_s']:.2f} s: round widths"
                f" {fwd.round_widths}, {run['moved']} rows/SpMM fwd moved ({fwd.halo_total} useful; dense bcast"
                f" would move {(P - 1) * n}), {fwd.comm_bytes_per_spmm(256) / 1e9:.3f} GB an SpMM at d = 256")
            agg = dist_halo.dist_aggregate_halo
        else:
            log(f"  DistGatherPair built on the card in {run['build_s']:.2f} s")
            agg = dist.dist_aggregate_gather
        got = dist.dist_loss_and_grad([params] * P, lambda hs: agg(pair.fwd, hs), lambda gs: agg(pair.bwd, gs), xs,
                                      ys, config, n, masks, mesh=mesh)
        torch.cuda.synchronize()
        compare_with_coo(f"-P {P} {kind}", got, ref, ref="single-card COO")
        del got
        step = dist.make_dist_train_step(config, mesh, n, pair_kind=kind)
        run.update(run_dist_epochs(f"-P {P} {kind} float32", step, params, mesh, pair, xs, ys, EPOCHS))
        torch.cuda.synchronize()
        run["launches"] = counts()  # and ends here
        expect_launches(run["launches"], {("gather", "float32"): sum(want.values()) * (1 + EPOCHS)})
        by_width = {d_pad: v for (dt, d_pad), v in run["launches"]["gather"].items()}
        if by_width != {d_pad: v * (1 + EPOCHS) for d_pad, v in want.items()}:
            raise AssertionError(f"-P {P} {kind} gather launches by width {by_width}, want {want} an epoch")
        log(f"  -P {P} {kind}: epoch median (1-{EPOCHS - 1}) {run['median_s']:.4f} s, peak memory"
            f" {run['peak_mem_gb']:.2f} GB, gather launches {by_width} ({sum(want.values())} an epoch)")
        out[kind] = run
        if kind == "halo_gather":
            out["pair"] = pair
        del pair
        torch.cuda.empty_cache()
    return out


def phase_halo_gather_kernels(pair, launches: dict) -> list[dict]:
    """The gather kernel at partition 0's halo-block shapes of phase 16a's
    forward matrix Âᵀ: the diagonal (m_loc × m_loc) and round 0's block
    (m_loc × w_0) at the path's widths, against the plain version, timed
    beside the bound and torch.sparse.mm on the same float32 CSR block.
    ``launches`` is the kernel's counter at that width over the path's run:
    every block of both matrices, 1 + EPOCHS steps (``launches_counted``);
    ``block_launches_an_epoch`` is this block's own, one a forward product
    at that width."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig
    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    fwd_products, _ = gcn_products_by_width(GCNConfig(sizes=(FEATURES_PROD, *HIDDEN_PROD, CLASSES_PROD)))
    counted = (f"every block of the {DIST_PARTS} partitions' Âᵀ and Â ({DIST_PARTS} x {DIST_PARTS} each) at this"
               f" width over the path's 1 + {EPOCHS} steps")
    rows = []
    for where, blk in (("diagonal", pair.fwd.loc[0]), ("round 0", pair.fwd.rem[0][0])):
        lib = csr_library(blk.indptr, blk.indices, blk.w, (blk.n_out, blk.n_in))
        for d in GATHER_WIDTHS[::-1]:
            b = operand(blk.n_in, d, "float32", seed=d)
            label = f"gather float32 d={d} (-P {DIST_PARTS} halo {where}, {blk.n_out} x {blk.n_in})"
            check, ms, plain_ms = time_against_plain(label, sg.gather, sg.gather_plain,
                                                     (blk.indptr, blk.indices, blk.w, b), "float32", 5, 1, repeat=True)
            extra = walk_geometry(label, sg.gather_geometry(blk.n_out, b.shape[1], b.dtype, True))
            bl = b[:, :d].contiguous()
            library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
            moved = 8 * (blk.n_out + 1) + 8 * blk.nnz + blk.n_in * d * 4 + blk.n_out * d * 4
            rows.append(kernel_row("gather", "float32", d, blk.n_out, blk.nnz,
                                   launches["gather"].get(("float32", b.shape[1]), 0), check, ms, plain_ms,
                                   library_ms, moved) | extra
                        | {"shape": f"halo {where} {blk.n_out} x {blk.n_in}", "launches_counted": counted,
                           "block_launches_an_epoch": fwd_products.get(b.shape[1], 0)})
            log_row(rows[-1], f"; this block {rows[-1]['block_launches_an_epoch']} an epoch")
            del b, bl
            torch.cuda.empty_cache()
        del lib
    return rows


def phase_sage_dist(ds) -> None:
    """GraphSAGE at -P 4 on one card: BASELINE config 4's widths (608 → 512 →
    41, l2-normalized, seed-99 init) on the main graph (232,968 = 4 x
    58,242), through ``make_dist_sage_train_step`` on ``--impl halo``'s pair
    (``train.halo_engine`` must take COO, expected fill 0.949) and
    ``--impl gather``'s (``DistGatherPair``), each over the mean pair (M,
    Mᵀ) built by :func:`normalized_pair_on_card`. Each run: one float32 step
    (``dist_sage_loss_and_grad``) against the single-card SAGE COO step by
    the rule of phase 4 (both also logged against the same step in float64),
    then 3 epochs, their median and peak memory; the
    counters zeroed before the step and read after the epochs: exactly 0
    (halo, COO) and 3 SpMMs x 4 x 4 = 48 gather launches an epoch (16 at
    d_pad 608, 32 at 512)."""
    from mg_gcn_tpu_torch.models import sage
    from mg_gcn_tpu_torch.parallel import dist
    from mg_gcn_tpu_torch.train import halo_engine

    dev = torch.device("cuda:0")
    P, n = DIST_PARTS, ds.num_nodes
    config = sage.SAGEConfig(sizes=SAGE_SIZES)
    params = sage.init_params(config, device=dev)
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    coo = mean_coo_pair_on_card(ds.graph)
    with deterministic():
        ref = sage.loss_and_grad(params, coo, x, y, config)
        # the same step in float64 on the same values: how far each float32
        # step lies from exact arithmetic
        coo64 = type(coo)(*(dataclasses.replace(mat, vals=mat.vals.double()) for mat in (coo.fwd, coo.bwd)))
        exact = sage.loss_and_grad([{k: v.double() for k, v in p.items()} for p in params], coo64, x.double(), y,
                                   config)
    log(f"  single-card SAGE COO f32 step against the float64 step, max over leaves of ||f32 - f64|| / ||f64||:"
        f" {gap(ref, exact)}")
    del coo, coo64, x, y
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m, m_t = normalized_pair_on_card(ds.graph, gcn=False)
    log(f"  M and Mᵀ built on the card and copied to the host in {time.perf_counter() - t0:.1f} s")
    engine = halo_engine(ds.graph, on_card=True)
    if engine != "xla":
        raise AssertionError(f"halo_engine took {engine} for SAGE on the main graph, not COO")
    mesh = dist.make_mesh(P, [dev] * P)
    xs, ys, _ = dist.shard_dataset(ds, mesh)
    for kind in ("halo", "gather"):
        reset_counts()  # this run starts here
        t0 = time.perf_counter()
        pair = dist.build_pair(kind, m, m_t, mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        got = dist.dist_sage_loss_and_grad([params] * P, dist.sage_aggregation(kind, pair), xs, ys, config, n,
                                           mesh=mesh)
        torch.cuda.synchronize()
        compare_with_coo(f"SAGE -P {P} {kind}", got, ref, ref="single-card SAGE COO")
        log(f"  SAGE -P {P} {kind} f32 step against the float64 step: {gap(got, exact)}")
        del got
        step = dist.make_dist_sage_train_step(config, mesh, n, pair_kind=kind)
        run = run_dist_epochs(f"SAGE -P {P} {kind}", step, params, mesh, pair, xs, ys, 3)
        torch.cuda.synchronize()
        launches = counts()  # and ends here
        per_epoch = {608: 4 * P, 512: 8 * P} if kind == "gather" else {}
        expect_launches(launches, {("gather", "float32"): 4 * sum(per_epoch.values())} if per_epoch else {})
        by_width = {d_pad: v for (_, d_pad), v in launches["gather"].items()}
        if by_width != {d: 4 * v for d, v in per_epoch.items()}:
            raise AssertionError(f"SAGE -P {P} {kind}: gather launches by width {by_width}")
        log(f"  SAGE -P {P} {kind}: pair built in {build_s:.2f} s, epoch median (1-2) {run['median_s']:.4f} s,"
            f" peak memory {run['peak_mem_gb']:.2f} GB, gather launches {by_width}")
        del pair
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the clustered-graph path (block pair) and the ELL path (tiled)


def banded_dataset(ds):
    """bench.py's block-banded graph at the main path's size (bench.py:
    276-292: 493 draws a row in row ± 4096, rng(7), duplicates merged, no
    self loops) with the main path's features and labels."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset

    t0 = time.perf_counter()
    g = sparse.banded_graph(N_MAIN, DEG_MAIN, BAND_HALF, seed=BAND_SEED)
    log(f"  banded graph n={g.nrows} nnz={g.nnz} built in {time.perf_counter() - t0:.1f} s")
    return Dataset(graph=g, features=ds.features, labels=ds.labels, sets=ds.sets)


def phase_banded_path(ds) -> dict:
    """The banded graph through ``drive_path``: impl="auto" must pick the
    block pair; its float32 step against COO; EPOCHS bfloat16 epochs with
    losses falling from the first to the last, and one int8 epoch; exactly
    3 block_fwd + 2 block_bwd launches an epoch in each dtype."""
    from mg_gcn_tpu_torch.ops.spmm_pattern_sparse import estimate_occupancy

    t0 = time.perf_counter()
    tile_occ, plane_occ = estimate_occupancy(ds.graph)
    log(f"  estimate_occupancy: tile {tile_occ:.4f}, plane {plane_occ:.4f} ({time.perf_counter() - t0:.2f} s)")
    out = drive_path("block", ds, HIDDEN, [("bfloat16", EPOCHS), ("int8", 1)])
    fwd = out["fwd"]
    log(f"  block store: T = {fwd.num_tiles} tiles of {fwd.tile_r} x 128 words, {fwd.store_bytes / 1e9:.3f} GB"
        f" (dense pack {fwd.n_pad ** 2 / 8e9:.2f} GB); stored tiles' plane occupancy {fwd.plane_occ:.4f}")
    want = {}
    for dtype, epochs in (("float32", 1), ("bfloat16", EPOCHS), ("int8", 1)):
        want[("block_fwd", dtype)], want[("block_bwd", dtype)] = 3 * epochs, 2 * epochs
    expect_launches(out["launches"], want)
    losses = out["bfloat16"]["losses"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"banded bf16 losses {losses}: not falling")
    steady = sorted(out["bfloat16"]["epoch_seconds"][1:])
    out["bf16_epoch_s_median"] = steady[len(steady) // 2]
    log(f"  block bf16 epoch median (epochs 1-{EPOCHS - 1}) {out['bf16_epoch_s_median']:.5f} s")
    return out


def phase_banded_f32_witness(ds) -> None:
    """Logged, after the banded path's counted run (ROADMAP queue 3 item 2):
    the float32 step of phase 8 (same seed-99 parameters) three ways, the
    block pair on its kernels, the block pair with block_fwd's plain version
    summed in float32 (index_add_ under :func:`deterministic`, round to
    nearest) in its place, and COO; each leaf's ||a - b|| / ||b|| between
    them, the largest and where. If the kernel's gap to COO is the plain
    version's, the gap is the float32 sum order's; if it is larger, the
    kernel's own sums add it. Then each step against the float64 oracle
    (:func:`oracle_grads_on_card`), which says which of them the gap
    between two float32 steps comes from."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad
    from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps
    from mg_gcn_tpu_torch.train import build_agg_pair

    dev = torch.device("cuda")
    config = GCNConfig(sizes=(ds.num_features, *HIDDEN, ds.num_labels))
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    params = init_params(config, device=dev)
    pair = build_agg_pair(ds.graph, impl="block", pattern_dtype="float32", device=dev)
    kernel_step = loss_and_grad(params, pair, x, y, config)
    kernel_fn = sps.block_fwd
    sps.block_fwd = lambda mat, b: sps.block_fwd_plain(mat, b)  # noqa: E731
    try:
        with deterministic():
            plain_step = loss_and_grad(params, pair, x, y, config)
    finally:
        sps.block_fwd = kernel_fn
    del pair
    with deterministic():
        coo_step_ = loss_and_grad(params, coo_pair_on_card(ds.graph), x, y, config)
    torch.cuda.synchronize()

    log(f"  float32 step, max over leaves of ||a - b|| / ||b||: block kernel vs COO {gap(kernel_step, coo_step_)};"
        f" block with block_fwd_plain (float32, round to nearest) vs COO {gap(plain_step, coo_step_)};"
        f" block kernel vs block_fwd_plain {gap(kernel_step, plain_step)}")
    oracle = (None, None, oracle_grads_on_card(ds, params, x, y))
    log(f"  the same steps against the float64 oracle (tests/torch_oracle.py on the card), max over leaves of"
        f" ||step - oracle|| / ||oracle||: block kernel {gap(kernel_step, oracle)}; block with block_fwd_plain"
        f" {gap(plain_step, oracle)}; COO {gap(coo_step_, oracle)}")
    del kernel_step, plain_step, coo_step_, oracle
    torch.cuda.empty_cache()


def gap(a, b) -> str:
    """max over gradient leaves of ||a - b|| / ||b|| for two steps (loss,
    acc, grads), and the leaf."""
    worst = max((float(torch.linalg.vector_norm((ga[k] - gb[k].reshape(ga[k].shape)).double())
                       / torch.linalg.vector_norm(gb[k].double())), f"layer {i} {k}")
                for i, (ga, gb) in enumerate(zip(a[2], b[2])) for k in gb)
    return f"{worst[0]:.3e} ({worst[1]})"


def oracle_step_on_card(graph, params, x, y, vals: torch.Tensor | None = None) -> tuple[float, list[dict]]:
    """(loss, gradient leaves) of one parity-mode step of the float64 oracle
    ``tests/torch_oracle.py`` (the reference's semantics, independent of the
    port's code) from ``params`` on the binary ``graph``: Â column-normalized
    (main.cpp:143) as a float64 sparse tensor on the card, its values
    1 / in-degree in float64, or ``vals`` (float64, in CSR entry order);
    the forward and the hand-rolled backward on the card, the softmax loss
    on the host."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_oracle

    g = graph
    cols = torch.from_numpy(g.indices).cuda().long()
    rows = torch.repeat_interleave(torch.arange(g.nrows, device="cuda"), torch.from_numpy(np.diff(g.indptr)).cuda())
    if vals is None:
        vals = 1.0 / torch.bincount(cols, minlength=g.ncols).double()[cols]
    a_hat = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, g.shape).coalesce()
    del rows, cols, vals
    a_hat_t = a_hat.t().coalesce()
    ref = [{"W": p["W"].double(), "b": p["b"].reshape(-1).double()} for p in params]
    x64 = x.double()
    acts, h = torch_oracle.forward_ref(a_hat_t, ref, x64)
    loss, _, g_loss = torch_oracle.softmax_xent_ref(h.cpu(), y.cpu())
    return float(loss), torch_oracle.parity_backward_ref(a_hat, a_hat_t, ref, x64, acts, g_loss.to(x.device))


def oracle_grads_on_card(ds, params, x, y) -> list[dict]:
    """The gradient leaves of :func:`oracle_step_on_card` on ``ds``."""
    return oracle_step_on_card(ds.graph, params, x, y)[1]


def phase_f64_small() -> None:
    """The f64 mode on the card (phase 3): ``build_agg_pair(impl="xla",
    coo_val_dtype=np.float64)`` and one float64 step of the main path's
    model on random_graph(20,000, 64, seed=3), held against the float64
    oracle fed the same Â (the float32 normalization's values widened, as
    tests/test_f64.py shares it): the loss and every gradient leaf within
    1e-12 relative (max |diff| / max |oracle|); then ``train(f64=True)``, 2
    epochs on the COO engine, its first loss the step's within 1e-12 and no
    kernel of the port launched."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad
    from mg_gcn_tpu_torch.train import build_agg_pair, train

    g = sparse.random_graph(N_SMALL, DEG_SMALL, seed=3)
    rng = np.random.default_rng(11)
    ds = Dataset(graph=g, features=rng.standard_normal((N_SMALL, FEATURES)).astype(np.float32),
                 labels=rng.integers(0, CLASSES, (N_SMALL, 1)).astype(np.int32),
                 sets=np.zeros((N_SMALL, 1), np.int32))
    config = GCNConfig(sizes=(FEATURES, *HIDDEN, CLASSES))
    params = init_params(config, device="cuda", dtype=torch.float64)
    x = torch.from_numpy(ds.features).cuda().double()
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).cuda()
    pair = build_agg_pair(g, impl="xla", device="cuda", coo_val_dtype=np.float64)
    loss, _, grads = loss_and_grad(params, pair, x, y, config)
    vals = torch.from_numpy(sparse.normalize(g, axis=True).data).cuda().double()
    loss_o, grads_o = oracle_step_on_card(g, params, x, y, vals)
    worst = [abs(float(loss) - loss_o) / abs(loss_o), "loss"]
    for i, layer in enumerate(grads_o):
        for k, want in layer.items():
            err = float((grads[i][k].reshape(want.shape) - want).abs().max() / want.abs().max())
            worst = max(worst, [err, f"layer {i} {k}"])
    if not worst[0] <= 1e-12:
        raise AssertionError(f"f64 step vs the float64 oracle: {worst[0]:.3e} ({worst[1]}) > 1e-12")
    reset_counts()
    res = train(ds, HIDDEN, epochs=2, f64=True, device="cuda", log=False)
    launched = {k: v for k, v in counts().items() if v}
    if res.engine != "xla" or launched or not abs(res.losses[0] - float(loss)) <= 1e-12 * abs(float(loss)):
        raise AssertionError(f"train(f64=True): engine {res.engine}, launches {launched}, first loss"
                             f" {res.losses[0]!r} vs the step's {float(loss)!r}")
    log(f"  f64 step (COO, index_add_ in float64) vs the float64 oracle: max {worst[0]:.3e} ({worst[1]}),"
        f" loss {float(loss)!r}; train(f64=True) losses {res.losses}")


def phase_block_kernels_main(ds, fwd, launches: dict) -> list[dict]:
    """block_fwd and block_bwd at the banded path's shape, each dtype x
    width against its plain version, timed beside the bound (the store, B
    and C at the memory rate, or 2·nnz·d operations on the kernel's
    datapath), the plain version and torch.sparse.mm on the float32 Pᵀ / P
    (a yardstick the port never calls). Each kernel besides: two launches
    equal bit for bit and its launch geometry (block_bwd's lanes and groups
    held to block_bwd_split by :func:`bwd_geometry`, its L2 gather bytes
    logged beside its bound); block_fwd the bias of its float sums
    (:func:`rounding_bias`) and the count of the dense products it runs on
    the tensor cores over the live planes (2 · live planes · 128 · tile_r ·
    d_pad operations, three times over in float32), logged beside their
    time at the MMA type's peak."""
    from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps

    n, n_pad, nnz = fwd.n, fwd.n_pad, fwd.nnz
    index_bytes = 4 * (3 * fwd.num_tiles + fwd.n_pad // fwd.tile_r + fwd.n_pad // sps.GROUP + 2)
    live_planes = int(((fwd.pmask.long()[:, None] >> torch.arange(32, device=fwd.pmask.device)) & 1).sum())
    log(f"  live (tile, plane) pairs: {live_planes} of {32 * fwd.num_tiles}")
    rows = []
    for name, kernel, plain in (("block_fwd", sps.block_fwd, sps.block_fwd_plain),
                                ("block_bwd", sps.block_bwd, sps.block_bwd_plain)):
        lib = library_sparse(ds, transpose=name == "block_fwd")
        for dtype in DTYPES:
            for d in WIDTHS:
                b = operand(n_pad, d, dtype, seed=d)
                label = f"{name} {dtype} d={d} (banded shape)"
                reference = lambda: plain(fwd, b, None if dtype == "int8" else torch.float64)  # noqa: E731
                datapath, note = None, ""
                if name == "block_fwd":
                    got = kernel(fwd, b)
                    torch.cuda.synchronize()
                    want = reference()
                    check = check_close(label, got, want, dtype)
                    extra = repeat_and_geometry(label, got, lambda: kernel(fwd, b),
                                                sps.block_fwd_geometry(n_pad, fwd.tile_r, b.shape[1], b.dtype))
                    if dtype != "int8":
                        rounding_bias(label, got, want, lambda: plain(fwd, b), b,
                                      lambda bb: (kernel(fwd, bb), plain(fwd, bb), plain(fwd, bb, torch.float64)))
                    del got, want
                    torch.cuda.empty_cache()
                    ms, plain_ms = cuda_ms(lambda: kernel(fwd, b), 5), cuda_ms(lambda: plain(fwd, b), 1)
                    datapath = (3, "bfloat16") if dtype == "float32" else (1, dtype)
                    dense_ops = datapath[0] * 2.0 * live_planes * 128 * fwd.tile_r * b.shape[1]
                    extra |= {"live_planes": live_planes, "dense_ops": dense_ops}
                    log(f"  {label}: dense live-plane products {dense_ops / 1e9:.1f}"
                        f" G{'OP' if dtype == 'int8' else 'FLOP'}, {dense_ops / PEAK_OPS[datapath[1]] * 1e3:.3f} ms"
                        f" at the {datapath[1]} peak (computed, not measured)")
                else:
                    got = kernel(fwd, b)
                    torch.cuda.synchronize()
                    check = check_close(label, got, reference(), dtype)
                    geometry = bwd_geometry(label, sps.block_bwd_geometry(n_pad, fwd.tile_r, b.shape[1], b.dtype), b)
                    extra = repeat_and_geometry(label, got, lambda: kernel(fwd, b), geometry, BWD_ROW_KEYS)
                    del got
                    torch.cuda.empty_cache()
                    ms, plain_ms = cuda_ms(lambda: kernel(fwd, b), 5), cuda_ms(lambda: plain(fwd, b), 1)
                    note = f"; L2 gather {nnz * b.shape[1] * elt_size(b) / 1e9:.3f} GB, computed"
                library_ms = None
                if dtype == "float32":
                    bl = b[:n, :d].contiguous()
                    library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
                    del bl
                moved = fwd.store_bytes + index_bytes + n * d * elt_size(b) + n * d * 4
                rows.append(kernel_row(name, dtype, d, n, nnz, launches[name].get((dtype, b.shape[1]), 0),
                                       check, ms, plain_ms, library_ms, moved, datapath) | extra)
                log_row(rows[-1], note)
                del b
                torch.cuda.empty_cache()
        del lib
    return rows


def rounding_bias(label: str, got, want, plain_f32, b, on_abs) -> None:
    """Logged: whether a kernel's float sums lean one way, and how large
    their errors are. For each output element with a nonzero float64 sum
    ``want``, e = got - want; the share sum(e · sign(want)) / sum(|e|) is 0
    for unbiased rounding and -1 when every error shrinks the sum's
    magnitude (truncation toward zero), and ||e|| / ||want|| the errors'
    size. Both are logged for the kernel and for the plain version summed in
    float32 (index_add_, round to nearest), on ``b`` and on |b| (every
    partial sum positive, where truncation shows as -1); ``on_abs(bb)``
    gives (kernel, plain float32, plain float64) on an operand bb."""
    def share(x, ref):
        e = x.double() - ref.double()
        return float((e * torch.sign(ref.double())).sum() / e.abs().sum().clamp_min(1e-300))

    def size(x, ref):
        return float(torch.linalg.vector_norm(x.double() - ref.double()) / torch.linalg.vector_norm(ref.double()))

    plain = plain_f32()
    line = f"  {label}: sum(e·sign(sum)) / sum(|e|) against the float64 sum: kernel {share(got, want):+.4f},"
    line += f" plain float32 {share(plain, want):+.4f}"
    k_abs, p_abs, want_abs = on_abs(b.abs())
    line += f"; on |B|: kernel {share(k_abs, want_abs):+.4f}, plain float32 {share(p_abs, want_abs):+.4f}"
    line += (f" (0: unbiased; -1: every error toward zero); ||e|| / ||sum||: kernel {size(got, want):.3e}, plain"
             f" float32 {size(plain, want):.3e}; on |B| {size(k_abs, want_abs):.3e}, {size(p_abs, want_abs):.3e}")
    del k_abs, p_abs, want_abs, plain
    log(line)


def ell_dataset(ds):
    """The ELL path's data: random_graph(N_SMALL, DEG_SMALL, seed=3) with the
    main path's first N_SMALL feature rows and labels (608 features, 41
    classes)."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset

    return Dataset(graph=sparse.random_graph(N_SMALL, DEG_SMALL, seed=3), features=ds.features[:N_SMALL],
                   labels=ds.labels[:N_SMALL], sets=ds.sets[:N_SMALL])


def phase_ell_path(ds_main) -> list[dict]:
    """``train(impl="pallas")`` at the main path's widths on the ELL graph:
    its float32 step against COO, EPOCHS float32 epochs with exactly 5
    ``tiled`` launches an epoch; then the kernel at the path's widths
    against its plain version, timed beside its bound and torch.sparse.mm on
    the same Âᵀ; the multi-epoch step on the path's pair (:func:`scan_path`);
    and ``TiledMat.from_csr`` must refuse the main path's graph (its store
    would pass 4e9 bytes), as the JAX package's does."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params
    from mg_gcn_tpu_torch.ops import spmm_pallas as tpl

    ds = ell_dataset(ds_main)
    out = drive_path("pallas", ds, HIDDEN, [("float32", EPOCHS)], impl="pallas", keep_pair=True)
    fwd = out["fwd"]
    log(f"  ELL store: K = {fwd.ell_k} slots, {fwd.n_rb} x {fwd.n_cb} tiles of {fwd.br}, {fwd.store_bytes / 1e9:.3f} GB"
        " a direction")
    expect_launches(out["launches"], {("tiled", "float32"): 5 * (1 + EPOCHS)})
    a_t = sparse.transpose(sparse.normalize(ds.graph, axis=True))
    lib = csr_library(torch.from_numpy(a_t.indptr).cuda(), torch.from_numpy(a_t.indices).cuda(),
                      torch.from_numpy(a_t.data).cuda(), a_t.shape)
    rows = []
    for d in (128, 41):
        b = operand(fwd.n_cb * fwd.bc, d, "float32", seed=d)[:, :d].contiguous()
        label = f"tiled d={d} (ELL path shape)"
        got = tpl.tiled(fwd, b)
        torch.cuda.synchronize()
        check = check_close(label, got, tpl.tiled_plain(fwd, b, torch.float64), "float32")
        extra = repeat_and_geometry(label, got, lambda: tpl.tiled(fwd, b), tpl.tiled_geometry(fwd, d))
        del got
        ms, plain_ms = cuda_ms(lambda: tpl.tiled(fwd, b), 5), cuda_ms(lambda: tpl.tiled_plain(fwd, b), 1)
        bl = b[: fwd.n_cols].contiguous()
        library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
        used = int(fwd.nsteps.sum()) * fwd.br  # the slots the kernel reads: k < nsteps
        moved = 8 * used + 4 * fwd.nsteps.numel() + fwd.n_cols * d * 4 + fwd.n_rows * d * 4
        rows.append(kernel_row("tiled", "float32", d, fwd.n_rows, fwd.nnz,
                               out["launches"]["tiled"].get(("float32", d), 0), check, ms, plain_ms, library_ms, moved)
                    | extra)
        log_row(rows[-1])
    config = GCNConfig(sizes=(ds.num_features, *HIDDEN, ds.num_labels))
    scan_path("ELL float32", config, "gcn", out.pop("pair"), torch.from_numpy(ds.features).cuda(),
              torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).cuda(), init_params(config, device="cuda"),
              start_check=True)
    t0 = time.perf_counter()
    try:
        tpl.TiledMat.from_csr(ds_main.graph, device="cuda")
    except ValueError as exc:
        log(f"  TiledMat.from_csr on the main path's graph refuses ({time.perf_counter() - t0:.1f} s): {exc}")
    else:
        raise AssertionError("TiledMat.from_csr built the main path's graph; the JAX package's refuses it")
    return rows


# ---------------------------------------------------------------------------
# the attention stack: sddmm, sddmm_qskip, edge_t and the GAT path


def sddmm_operands(mat, d: int, dtype: str, seed: int):
    """(A, B, g) as ``sddmm_edge_tiles`` hands them to the kernel: random
    (n_out, d) and (n_in, d) cast to ``dtype``, or quantized per feature with
    g = qa·qb in int8, and padded to d_pad."""
    from mg_gcn_tpu_torch.ops import sddmm as sd
    from mg_gcn_tpu_torch.ops.spmm_edges import DTYPES, pad_features

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((mat.n_out, d), device="cuda", generator=gen)
    b = torch.randn((mat.n_in, d), device="cuda", generator=gen)
    if dtype != "int8":
        return pad_features(a, DTYPES[dtype]), pad_features(b, DTYPES[dtype]), None
    (aq, qa), (bq, qb) = sd.quantize_per_feature(a), sd.quantize_per_feature(b)
    am, bm = pad_features(aq, torch.int8), pad_features(bq, torch.int8)
    g = torch.zeros(am.shape[1], device="cuda")
    g[:d] = qa * qb
    return am, bm, g


def check_sddmm(label, mat, d, dtype, reps, plain_reps):
    """sddmm on ``mat`` against its plain version summed in float64: within
    check_close's tolerance and element by element within the float32 sum
    bound 4 sqrt(d_pad + 2) 2^-24 sum|terms|; a second launch must give the
    same bits. Returns (operands, check, ms, plain ms, share of the sum
    bound used)."""
    from mg_gcn_tpu_torch.ops import sddmm as sd

    a, b, g = sddmm_operands(mat, d, dtype, seed=d)
    args = (mat.indptr, mat.indices, a, b, g)
    got, again = sd.sddmm(*args), sd.sddmm(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches differ")
    del again
    exact = sd.sddmm_plain(mat.indptr, mat.indices, a.double(), b.double(), g)
    check = check_close(label, got, exact, "float32")
    mag = sd.sddmm_plain(mat.indptr, mat.indices, a.double().abs(), b.double().abs(), g)
    use = sum_bound_use(label, got, exact, mag, a.shape[1])
    del got, exact, mag
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: sd.sddmm_plain(*args), plain_reps)
    return args, check, cuda_ms(lambda: sd.sddmm(*args), reps), plain_ms, use


def sddmm_geometry_row(label: str, n: int, a: torch.Tensor) -> dict:
    """The SDDMM's launch geometry at (n rows, A's width and dtype) from the
    card, whose split of a warp must follow ops/sddmm.sddmm_geometry's rule;
    logged whole. Returns a row's extra keys: the repeat check (made by
    check_sddmm) and what the card reports of the launch (grid, threads,
    dynamic shared memory, resident blocks from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor); the rule's counts stay
    in the log."""
    from mg_gcn_tpu_torch.ops import sddmm as sd

    geo = sd.sddmm_launch_geometry(n, a.shape[1], a.dtype)
    rule = sd.sddmm_geometry(a.shape[1], a.dtype)
    if {k: geo[k] for k in rule} != rule:
        raise AssertionError(f"{label}: launch geometry {geo} is not the rule's {rule}")
    log(f"  {label}: geometry {geo}")
    keep = {k: geo[k] for k in ("grid_x", "threads", "smem", "blocks_per_sm", "resident_blocks")}
    return {"repeat_equal": True, "geometry": keep}


def check_qskip(label, mat, args, reps) -> float:
    """sddmm_qskip on ``mat`` must equal sddmm bit for bit; its ms."""
    from mg_gcn_tpu_torch.ops import sddmm as sd

    indptr, indices, a, b, g = args
    run = lambda: sd.sddmm_qskip(indptr, indices, mat.live_rows, a, b, g)  # noqa: E731
    same = bool(torch.equal(run(), sd.sddmm(*args)))
    torch.cuda.synchronize()
    if not same:
        raise AssertionError(f"{label}: sddmm_qskip differs from sddmm")
    return cuda_ms(run, reps)


def check_edge_t(label, mat, t, w, d, dtype, reps, plain_reps, repeat: bool = False):
    """edge_t over ``mat``'s transpose ``t`` with entry weights ``w``
    against its plain version; (operand, check, ms, plain ms)."""
    from mg_gcn_tpu_torch.ops import spmm_edges as se

    a = operand(mat.n_out, d, dtype, seed=d)
    args = (t.t_indptr, t.t_rows, t.perm, w, a)
    check, ms, plain_ms = check_and_time(
        label, lambda: se.edge_t(*args),
        lambda: se.csr_plain(t.t_indptr, t.t_rows, w[t.perm.long()], a, torch.float64),
        "float32", reps, lambda: se.edge_t_plain(*args), plain_reps, repeat)
    return a, check, ms, plain_ms


def phase_attention_kernels_small() -> None:
    """sddmm {bfloat16, float32, int8} and edge_t {bfloat16, float32} at the
    GAT widths against their plain versions at n = 20,000; sddmm_qskip on
    the same graph with 90% of its rows emptied, bitwise equal to sddmm."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import CSRData
    from mg_gcn_tpu_torch.ops import sddmm as sd
    from mg_gcn_tpu_torch.ops import spmm_edges as se

    g = sparse.random_graph(N_SMALL, DEG_SMALL, seed=3)
    mat = se.edge_tile_mat_from_csr(g, dtype="float32", device="cuda", merge=False)
    widths = GAT_WIDTHS + ATT_EXTRA_WIDTHS
    for dtype in DTYPES:
        for d in SDDMM_SMALL_WIDTHS:
            label = f"sddmm {dtype} d={d}"
            args, (err, use), ms, plain_ms, bound_use = check_sddmm(label, mat, d, dtype, 10, 3)
            sddmm_geometry_row(label, mat.n_out, args[2])  # the card's split, held to the rule
            geo = sd.sddmm_geometry(args[2].shape[1], args[2].dtype)
            log(f"  sddmm   {dtype:8s} d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f}, sum bound used"
                f" {bound_use:.3f}), two launches equal bit for bit, L={geo['lanes']} G={geo['groups']}"
                f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")
    rows = np.repeat(np.arange(N_SMALL), np.diff(g.indptr))
    keep = rows % 10 == 0
    indptr = np.zeros(N_SMALL + 1, np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=N_SMALL), out=indptr[1:])
    thin = se.edge_tile_mat_from_csr(CSRData(indptr, g.indices[keep], g.data[keep], g.shape), dtype="float32",
                                     device="cuda", merge=False)
    for dtype in DTYPES:
        for d in SDDMM_SMALL_WIDTHS:
            args, (err, use), ms, _, _ = check_sddmm(f"sddmm {dtype} d={d}, 90% rows empty", thin, d, dtype, 10, 1)
            q_ms = check_qskip(f"{dtype} d={d}", thin, args, 10)
            log(f"  sddmm_qskip {dtype:8s} d={d:3d}, {thin.live_rows.numel()} live rows of {N_SMALL}: bitwise equal"
                f" to sddmm; {q_ms:.4f} ms vs sddmm {ms:.4f} ms (max_err {err:.3e}, tolerance used {use:.3f})")
    t = se.transposed_schedule(mat)
    gen = torch.Generator(device="cuda").manual_seed(7)
    w32 = torch.rand(mat.nnz, device="cuda", generator=gen)
    for dtype in ("bfloat16", "float32"):
        w = w32.to(se.DTYPES[dtype])
        for d in widths:
            _, (err, use), ms, plain_ms = check_edge_t(f"edge_t {dtype} d={d}", mat, t, w, d, dtype, 10, 3)
            log(f"  edge_t  {dtype:8s} d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f})"
                f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")


def gat_features(labels: np.ndarray) -> np.ndarray:
    """bench.py's planted_features(labels, 64, noise=2.0, seed=8)
    (mg_gcn_tpu/sparse.py:334-345)."""
    rng = np.random.default_rng(8)
    proj = rng.standard_normal((int(labels.max()) + 1, GAT_SIZES[0])).astype(np.float32)
    return proj[labels] + 2.0 * rng.standard_normal((labels.size, GAT_SIZES[0])).astype(np.float32)


def gat_launches_per_epoch(config) -> dict:
    """{(kernel, dtype, d_pad): launches} of one bfloat16 GAT epoch: per head
    and layer, forward the edge softmax's two walks (``softmax_fwd``: the
    global max, then both passes and the weights) and 1 edge (the
    aggregation, d=out); backward the edge softmax's walk (``softmax_bwd``),
    1 sddmm (the aggregation's dw at d=out) and 2 edge_t (the aggregation's
    dB at d=out; the column sums of the scores' gradient at d=1)."""
    from mg_gcn_tpu_torch.ops.spmm_pattern import round_up

    want = {}
    for i in range(config.num_layers):
        d_out = round_up(max(config.sizes[i + 1], 8), 8)
        for name, narrow, wide in (("softmax_fwd", 2, 0), ("softmax_bwd", 1, 0), ("sddmm", 0, 1), ("edge", 0, 1),
                                   ("edge_t", 1, 1)):
            for d_pad, n in ((8, narrow), (d_out, wide)):
                key = (name, "bfloat16", d_pad)
                if n:
                    want[key] = want.get(key, 0) + n * config.heads
    return want


def compare_steps(label: str, got, ref, ref_name: str) -> None:
    """One float32 step against a reference step from the same parameters:
    the loss within rtol 1e-5, every gradient leaf ||got - ref|| <= 1e-4
    ||ref||."""
    (loss_g, acc_g, grads_g), (loss_r, acc_r, grads_r) = got, ref
    if not math.isclose(float(loss_g), float(loss_r), rel_tol=1e-5):
        raise AssertionError(f"{label} float32 loss {float(loss_g)} vs {ref_name} {float(loss_r)}")
    worst, where = 0.0, ""
    for i, (gg, gr) in enumerate(zip(grads_g, grads_r)):
        for k in gr:
            rel = float(torch.linalg.vector_norm(gg[k].to(gr[k].device) - gr[k]) / torch.linalg.vector_norm(gr[k]))
            if not rel <= 1e-4:
                raise AssertionError(f"{label} layer {i} grad {k}: ||diff|| / ||{ref_name}|| = {rel} > 1e-4")
            if rel >= worst:
                worst, where = rel, f"layer {i} {k}"
    log(f"  {label} f32 step vs {ref_name}: loss {float(loss_g)!r} vs {float(loss_r)!r}, acc {float(acc_g)!r} vs"
        f" {float(acc_r)!r}; gradients: max ||diff||/||{ref_name}|| {worst:.3e} ({where})")


def phase_gat_card_vs_cpu() -> None:
    """One float32 step of the GAT path's model at n = 20,000 on the card
    against the port's CPU path, from the same seed-99 parameters: at full
    size no second engine exists to hold it against."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.models import gat

    g = sparse.random_graph(N_SMALL, DEG_GAT_CPU, seed=3)
    labels = np.random.default_rng(0).integers(0, CLASSES, N_SMALL)
    x, y = torch.from_numpy(gat_features(labels)), torch.from_numpy(labels.astype(np.int64))
    config = gat.GATConfig(sizes=GAT_SIZES, heads=GAT_HEADS)
    steps = []
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        graph = gat.build_gat_graph(g, dtype="float32", device=dev)
        params = gat.init_params(config, None, device=dev)
        steps.append(gat.loss_and_grad(params, graph, x.to(dev), y.to(dev), config))
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"  {dev}: n={g.nrows} nnz={g.nnz} build + float32 step {time.perf_counter() - t0:.2f} s")
    compare_steps("GAT card", steps[0], steps[1], "CPU")


def profile_epoch(run_epoch, epoch_s: float, top: int = 12) -> None:
    """One more epoch under torch.profiler (after the counted ones): the
    device time by kernel name, its sum against the median epoch's
    ``epoch_s`` (the device's busy share of an unprofiled epoch) and the
    ``top`` kernels. Only the device's own events count: the host ops that
    launched them carry the same time again. Logged only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_epoch()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"  profiled epoch: device busy {busy_ms:.2f} ms = {busy_ms / (epoch_s * 1e3):.3f} of the median epoch"
        f" ({epoch_s * 1e3:.2f} ms); {len(rows)} kernel names; top {top} by device time:")
    for e in rows[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d} x  {e.key[:110]}")


def phase_gat_path(ds) -> dict:
    """bench.py's GAT headline through the library entry points:
    ``build_gat_graph`` (bfloat16, the transpose built on the card) and
    ``make_train_step(model="gat")``, EPOCHS epochs from the seed-99 init
    with finite losses that fall from epoch 0 to the last. The launch
    counters are zeroed just before the epochs and read just after: exactly
    :func:`gat_launches_per_epoch` an epoch, and no other kernel."""
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import make_train_step

    dev = torch.device("cuda")
    labels = ds.labels.reshape(-1)
    x = torch.from_numpy(gat_features(labels)).to(dev)
    y = torch.from_numpy(labels.astype(np.int64)).to(dev)
    config = gat.GATConfig(sizes=GAT_SIZES, heads=GAT_HEADS)
    params = gat.init_params(config, None, device=dev)
    opt = adam.adam_init(params)
    out = {}
    t0 = time.perf_counter()
    graph = gat.build_gat_graph(ds.graph, dtype="bfloat16", device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    step = make_train_step(config, model="gat")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the GAT path's epochs start here
    out["losses"], out["accs"], out["epoch_seconds"] = [], [], []
    for e in range(EPOCHS):
        t0 = time.perf_counter()
        params, opt, loss, acc = step(params, opt, graph, x, y, None)
        loss, acc = float(loss), float(acc)  # waits for the card
        out["epoch_seconds"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        out["accs"].append(acc)
        log(f"  gat bf16 epoch {e} {loss} {acc} {out['epoch_seconds'][-1]}")
    torch.cuda.synchronize()
    out["launches"] = counts()  # ... and end here
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    profile_epoch(lambda: float(step(params, opt, graph, x, y, None)[2]), sorted(out["epoch_seconds"])[EPOCHS // 2])
    losses = out["losses"]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"GAT bf16 losses {losses}: not finite, or not falling")
    want = {k: v * EPOCHS for k, v in gat_launches_per_epoch(config).items()}
    got = {(name, dt, dp): n for name, per in out["launches"].items() for (dt, dp), n in per.items() if n}
    if got != want:
        raise AssertionError(f"GAT launches {got}, want {want}")
    steady = sorted(out["epoch_seconds"][1:])
    out["epoch_s_median"] = steady[len(steady) // 2]
    out["graph"] = graph
    log(f"  launches in {EPOCHS} epochs: {got}")
    log(f"  attention graph n={graph[0].n_out} nnz={graph[0].nnz} built in {out['build_s']:.2f} s"
        f" (host cast and upload, transpose on the card); bf16 epoch median (epochs 1-{EPOCHS - 1})"
        f" {out['epoch_s_median']:.4f} s; peak memory {out['peak_mem_gb']:.2f} GB")
    return out


def library_ms_or_none(label: str, fn, reps: int):
    """The yardstick's ms, or None (logged) where the library call is not
    available on this installation; the port never calls it."""
    try:
        return cuda_ms(fn, reps)
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  {label}: library call not available ({str(exc).splitlines()[0][:200]}): none")
        return None


def phase_gat_kernels(graph, launches: dict) -> list[dict]:
    """sddmm, sddmm_qskip and edge_t at the GAT path's shape, each dtype x
    width against its plain version, timed beside its bound, its plain
    version and (float32) torch.sparse.sampled_addmm for the SDDMMs and
    torch.sparse.mm on the transposed CSR for edge_t; and the path's own
    ``edge`` launches (bfloat16, d_pad 8, 48 and 64) on the same matrix.
    The kernels line takes the path's widths; ATT_EXTRA_WIDTHS (and for the
    SDDMMs SDDMM_EXTRA_WIDTHS) are logged."""
    from mg_gcn_tpu_torch.ops import spmm_edges as se

    mat, t = graph
    n, n_in, nnz = mat.n_out, mat.n_in, mat.nnz
    pattern = csr_library(mat.indptr, mat.indices, torch.zeros(nnz, device="cuda"), (n, n_in))
    rows = []

    def keep(row: dict, note: str = "") -> None:
        log_row(row, note)
        if row["d"] in GAT_WIDTHS:
            rows.append(row)

    for dtype in DTYPES:
        for d in GAT_WIDTHS + SDDMM_EXTRA_WIDTHS:
            label = f"sddmm {dtype} d={d} (GAT shape)"
            args, check, ms, plain_ms, bound_use = check_sddmm(label, mat, d, dtype, 5, 1)
            a, b = args[2], args[3]
            extra = sddmm_geometry_row(label, n, a) | {"sum_bound_used": bound_use}
            # each entry reads a B row from the L2: computed, logged beside the bound
            gather = f"; L2 gather {nnz * a.shape[1] * elt_size(a) / 1e9:.3f} GB, computed"
            library_ms = None
            if dtype == "float32":
                al, bt = a[:, :d].contiguous(), b[:, :d].t()
                library_ms = library_ms_or_none(
                    "sampled_addmm", lambda: torch.sparse.sampled_addmm(pattern, al, bt, beta=0.0), 5)
                del al, bt
            moved = 8 * (n + 1) + 4 * nnz + (n + n_in) * d * elt_size(a) + 4 * nnz
            keep(kernel_row("sddmm", dtype, d, n, nnz, launches["sddmm"].get((dtype, a.shape[1]), 0),
                            check, ms, plain_ms, library_ms, moved) | extra, gather)
            q_ms = check_qskip(f"{dtype} d={d} (GAT shape)", mat, args, 5)
            keep(kernel_row("sddmm_qskip", dtype, d, n, nnz, launches["sddmm_qskip"].get((dtype, a.shape[1]), 0),
                            check, q_ms, plain_ms, library_ms, moved + 4 * mat.live_rows.numel()) | extra,
                 gather)
            del args, a, b
            torch.cuda.empty_cache()
    del pattern
    gen = torch.Generator(device="cuda").manual_seed(7)
    w32 = torch.rand(nnz, device="cuda", generator=gen)
    w16 = w32.to(torch.bfloat16)
    for d in GAT_WIDTHS:  # the edge kernel at the path's own widths (d = 1 pads to 8 as d = 2 does)
        b = operand(n_in, d, "bfloat16", seed=d)
        label = f"edge bfloat16 d={d} (GAT shape)"
        check, ms, plain_ms = time_against_plain(label, se.edge, se.edge_plain, (mat.indptr, mat.indices, w16, b),
                                                 "bfloat16", 5, 1, repeat=True)
        extra = walk_geometry(label, se.edge_geometry("edge", n, b.shape[1], b.dtype))
        moved = 8 * (n + 1) + 4 * nnz + 2 * nnz + n_in * d * 2 + n * d * 4
        keep(kernel_row("edge", "bfloat16", d, n, nnz, launches["edge"].get(("bfloat16", b.shape[1]), 0),
                        check, ms, plain_ms, None, moved) | extra)
        del b
    del w16
    transposed = csr_library(t.t_indptr, t.t_rows, w32[t.perm.long()], (n_in, n))
    for dtype in ("bfloat16", "float32"):
        w = w32.to(se.DTYPES[dtype])
        for d in GAT_WIDTHS + ATT_EXTRA_WIDTHS:
            label = f"edge_t {dtype} d={d} (GAT shape)"
            a, check, ms, plain_ms = check_edge_t(label, mat, t, w, d, dtype, 5, 1, repeat=True)
            extra = walk_geometry(label, se.edge_geometry("edge_t", n_in, a.shape[1], a.dtype))
            library_ms = None
            if dtype == "float32":
                al = a[:, :d].contiguous()
                library_ms = library_ms_or_none("torch.sparse.mm", lambda: torch.sparse.mm(transposed, al), 5)
                del al
            moved = 8 * (n_in + 1) + 8 * nnz + elt_size(w) * nnz + n * d * elt_size(a) + n_in * d * 4
            keep(kernel_row("edge_t", dtype, d, n_in, nnz, launches["edge_t"].get((dtype, a.shape[1]), 0),
                            check, ms, plain_ms, library_ms, moved) | extra)
            del a
            torch.cuda.empty_cache()
    return rows


def held_to_twin(label: str, got: torch.Tensor, want: torch.Tensor, rtol: float) -> str:
    """``got`` within ``rtol`` of ``want`` element by element (atol the
    smallest normal of ``want``'s dtype: no value is let off for being small
    beside the largest); the share of values equal bit for bit, for the
    log."""
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=torch.finfo(want.dtype).tiny,
                               msg=lambda m: f"{label}: {m}")
    return f"{float((got == want).float().mean()):.6f}"


def phase_gat_softmax(graph, launches: dict) -> None:
    """The edge softmax's fused walks (``ops/edge_softmax.py``, port-only
    kernels: logged, not in the kernels line) at the GAT path's shape, in
    bfloat16 (the path's) and float32: ``softmax_fwd`` (its two launches)
    and ``softmax_bwd`` each launched twice must give the same bits; the
    weights, the row statistics and each entry's gradient are held element
    by element to their plain versions run on the card (the same operations,
    each row summed in the walk's order: within rtol 1e-5, the gradient
    within one ulp of its dtype, the share equal bit for bit logged); the
    gradient's row sums (``e_dst``'s) and its column sums through ``edge_t``
    at d = 1 in the gradient's dtype (``e_src``'s; the op's own call on the
    path's bfloat16 graph) within the float32 sum bound of float64 sums of
    the same entries; each walk timed beside its bytes
    bound (the index list read once a walk, the per-entry values read or
    written once, the score vectors and row statistics)."""
    from mg_gcn_tpu_torch.ops import edge_softmax as esm
    from mg_gcn_tpu_torch.ops.spmm_edges import DTYPES, edge_t, pad_features

    mat, sched = graph
    n, n_in, nnz = mat.n_out, mat.n_in, mat.nnz
    gen = torch.Generator(device="cuda").manual_seed(11)
    vectors = [2.0 * torch.randn(m, device="cuda", generator=gen) for m in (n, n_in)]
    dalpha = torch.randn(nnz, device="cuda", generator=gen)
    csr = 8 * (n + 1) + 4 * nnz
    ones = torch.ones((n, 1), dtype=torch.float32, device="cuda")
    for dtype in ("bfloat16", "float32"):
        e_dst, e_src = (v.to(DTYPES[dtype]) for v in vectors)
        args = (mat.indptr, mat.indices, e_dst, e_src, None, 0.2)
        (alpha, stats), again = esm.softmax_fwd(*args), esm.softmax_fwd(*args)
        (de, g_pre), (de2, g_pre2) = esm.softmax_bwd(*args, stats, dalpha), esm.softmax_bwd(*args, stats, dalpha)
        torch.cuda.synchronize()
        if not (torch.equal(alpha, again[0]) and torch.equal(stats, again[1]) and torch.equal(de, de2)
                and torch.equal(g_pre, g_pre2)):
            raise AssertionError(f"edge softmax {dtype}: two launches differ")
        del again, de2, g_pre2
        t0 = time.perf_counter()
        twin_alpha, twin_stats = esm.softmax_fwd_plain(*args, row_sums=esm.walk_row_sums)
        twin_de, twin_g = esm.softmax_bwd_plain(*args, stats, dalpha, row_sums=esm.walk_row_sums)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        ulp = 2.0**-7 if dtype == "bfloat16" else 2.0**-23
        equal = {k: held_to_twin(f"edge softmax {dtype} {k}", got, want, tol) for k, got, want, tol in (
            ("alpha", alpha, twin_alpha, 1e-5), ("stats", stats, twin_stats, 1e-5), ("g_pre", g_pre, twin_g, ulp))}
        equal["de_dst"] = f"{float((de == twin_de).float().mean()):.6f}"
        del twin_alpha, twin_stats, twin_de, twin_g
        torch.cuda.empty_cache()
        de_src = edge_t(sched.t_indptr, sched.t_rows, sched.perm, g_pre, pad_features(ones, g_pre.dtype))[:, :1]
        sums_use = {
            "de_dst": within_sum_bound(f"edge softmax {dtype} de_dst", de[:, None], mat.indptr, mat.indices, g_pre,
                                       ones.new_ones((n_in, 1))),
            "de_src": within_sum_bound(f"edge softmax {dtype} de_src", de_src, sched.t_indptr, sched.t_rows,
                                       g_pre[sched.perm.long()], ones)}
        del de_src
        torch.cuda.empty_cache()
        fwd_ms = cuda_ms(lambda: esm.softmax_fwd(*args), 5)
        bwd_ms = cuda_ms(lambda: esm.softmax_bwd(*args, stats, dalpha), 5)
        elt = e_dst.element_size()
        vec = elt * (n + n_in)
        fwd_bytes = (csr + vec) + (csr + vec + 4 * nnz + 12 * n)  # the max walk, then the softmax walk
        bwd_bytes = csr + vec + 12 * n + 4 * nnz + elt * nnz + 4 * n
        key = (dtype, 8)
        log(f"  edge softmax {dtype} (GAT shape, n={n} nnz={nnz}): softmax_fwd {fwd_ms:.3f} ms (bound"
            f" {fwd_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, bytes), softmax_bwd {bwd_ms:.3f} ms (bound"
            f" {bwd_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, bytes); launches in the path's epochs"
            f" {launches['softmax_fwd'].get(key, 0)} + {launches['softmax_bwd'].get(key, 0)}; two launches equal"
            f" bit for bit; held to the plain version ({plain_s:.1f} s both ways), shares equal bit for bit"
            f" {equal}; gradient sums, share of the float32 sum bound used"
            f" {', '.join(f'{k} {v:.3f}' for k, v in sums_use.items())}")
        del alpha, stats, de, g_pre
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the GAT path at -P 4 on one card (sddmm, edge, edge_t at the ring blocks)


def dist_gat_launches_per_epoch(config, graph) -> dict:
    """{(kernel, dtype, d_pad): launches} of one bfloat16 dist GAT epoch: per
    head, layer and block with entries, forward 4 sddmm (scores d = 2, the
    two shifts and the log row sums d = 1) and 3 edge (rs1, rowsum d = 1,
    aggregation d = out); backward 2 sddmm (d = out, the rowsum's d = 1), 2
    edge (d = 1, the scores' d = 2) and 2 edge_t (d = 2, d = out). A block
    with no entry launches nothing."""
    from mg_gcn_tpu_torch.ops.spmm_pattern import round_up

    live = sum(nnz > 0 for row in graph.block_nnz for nnz in row)
    want = {}
    for i in range(config.num_layers):
        d_out = round_up(max(config.sizes[i + 1], 8), 8)
        for name, narrow, wide in (("sddmm", 5, 1), ("edge", 4, 1), ("edge_t", 1, 1)):
            for d_pad, n in ((8, narrow), (d_out, wide)):
                key = (name, "bfloat16", d_pad)
                want[key] = want.get(key, 0) + n * config.heads * live
    return want


def phase_dist_gat_path(ds) -> dict:
    """bench.py's GAT headline at -P 4, its partitions on cuda:0, through
    ``parallel.dist_gat``: one float32 step against the single-card float32
    GAT step from the same seed-99 parameters (:func:`compare_steps`); then
    the bfloat16 ring blocks (build seconds, entries per block) and EPOCHS
    epochs of ``make_dist_gat_train_step`` with finite losses falling from
    the first to the last, their median and peak memory. The counters are
    zeroed just before the epochs and read just after: exactly
    :func:`dist_gat_launches_per_epoch` an epoch, by width, and no other
    kernel. Then one more epoch under torch.profiler (:func:`profile_epoch`,
    logged)."""
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.parallel import dist, dist_gat

    dev = torch.device("cuda:0")
    P = DIST_PARTS
    labels = ds.labels.reshape(-1)
    x = torch.from_numpy(gat_features(labels)).to(dev)
    y = torch.from_numpy(labels.astype(np.int64)).to(dev)
    config = gat.GATConfig(sizes=GAT_SIZES, heads=GAT_HEADS)
    params = gat.init_params(config, None, device=dev)
    single = gat.build_gat_graph(ds.graph, dtype="float32", device=dev)
    ref = gat.loss_and_grad(params, single, x, y, config)
    torch.cuda.synchronize()
    del single
    torch.cuda.empty_cache()
    mesh = dist.make_mesh(P, [dev] * P)
    xs, ys = dist.shard(x, mesh), dist.shard(y, mesh)
    g32 = dist_gat.build_dist_gat_graph(ds.graph, mesh, dtype="float32")
    got = dist_gat.dist_gat_loss_and_grad([params] * P, g32, xs, ys, config)
    torch.cuda.synchronize()
    compare_steps(f"dist GAT -P {P}", got, ref, "single-card GAT")
    del g32, got, ref
    torch.cuda.empty_cache()

    out = {}
    t0 = time.perf_counter()
    graph = dist_gat.build_dist_gat_graph(ds.graph, mesh, dtype="bfloat16")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    log(f"  DistGatGraph: P = {P} on {dev}, m_loc = {graph.m_loc}, {P} x {P} bfloat16 blocks built on the card"
        f" in {out['build_s']:.2f} s; entries per block [partition][round]: {graph.block_nnz}")
    step = dist_gat.make_dist_gat_train_step(config, mesh, graph)
    p, st = dist.replicate(params, mesh), dist.replicate(adam.adam_init(params), mesh)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the dist GAT path's epochs start here
    out["losses"], out["epoch_seconds"] = [], []
    for e in range(EPOCHS):
        t0 = time.perf_counter()
        p, st, loss, acc = step(p, st, graph, xs, ys)
        loss = float(loss)  # waits for the card
        out["epoch_seconds"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        log(f"  dist gat bf16 epoch {e} {loss} {float(acc)} {out['epoch_seconds'][-1]}")
    torch.cuda.synchronize()
    out["launches"] = counts()  # ... and end here
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    profile_epoch(lambda: float(step(p, st, graph, xs, ys)[2]), sorted(out["epoch_seconds"])[EPOCHS // 2])
    losses = out["losses"]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"dist GAT bf16 losses {losses}: not finite, or not falling")
    want = {k: v * EPOCHS for k, v in dist_gat_launches_per_epoch(config, graph).items()}
    got = {(name, dt, dp): n for name, per in out["launches"].items() for (dt, dp), n in per.items() if n}
    if got != want:
        raise AssertionError(f"dist GAT launches {got}, want {want}")
    steady = sorted(out["epoch_seconds"][1:])
    out["epoch_s_median"] = steady[len(steady) // 2]
    per_epoch = {k: v // EPOCHS for k, v in got.items()}
    log(f"  launches an epoch: {per_epoch} ({sum(per_epoch.values())} in all)")
    log(f"  dist GAT bf16 epoch median (epochs 1-{EPOCHS - 1}) {out['epoch_s_median']:.4f} s; peak memory"
        f" {out['peak_mem_gb']:.2f} GB")
    out["graph"] = graph
    return out


def phase_dist_gat_kernels(graph, launches: dict, counted: str | None = None, epochs: int = EPOCHS,
                           empty_block: bool = True) -> list[dict]:
    """sddmm (bfloat16, float32) at d = 1, 2, 41, 64, edge (bfloat16) at 1,
    41, 64 and edge_t (bfloat16, float32) at 2, 41, 64 on the first local
    partition's diagonal and round-1 blocks of a dist GAT graph (phase
    12a's, or phase 20's process 0's), each against its plain version (two
    launches equal bit for bit), timed beside its bound and (float32)
    torch.sparse.sampled_addmm / torch.sparse.mm on the same block.
    ``launches`` is the kernel's counter at that width over ``epochs``
    epochs (``counted`` says whose: phase 12a's, every block of the 4
    partitions); ``block_launches_an_epoch`` this block's own. Then, with
    ``empty_block``, one empty block through the three ops: zeros, no
    launch."""
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.ops import edge_attention as ea
    from mg_gcn_tpu_torch.ops import spmm_edges as se
    from mg_gcn_tpu_torch.parallel import dist_gat

    config = gat.GATConfig(sizes=GAT_SIZES, heads=GAT_HEADS)
    one_block = dist_gat_launches_per_epoch(config, dataclasses.replace(graph, blocks=[[graph.blocks[0][0]]]))
    counted = counted or f"every block of the {DIST_PARTS} partitions over phase 12a's {EPOCHS} bfloat16 epochs"
    shape = f"dist GAT -P {graph.parts}" if graph.ring.world == 1 else f"two-process GAT -P {graph.parts}"
    rows = []

    def keep(row: dict, where: str, n: int, n_in: int) -> None:
        key = (row["name"], row["dtype"], sp_pad(row["d"]))
        row |= {"shape": f"{shape} partition 0 {where} block {n} x {n_in}", "launches_counted": counted,
                "launches_an_epoch": row["launches"] / epochs, "block_launches_an_epoch": one_block.get(key, 0)}
        log_row(row, f"; this block {row['block_launches_an_epoch']} an epoch")
        rows.append(row)

    gen = torch.Generator(device="cuda").manual_seed(7)
    for where, s in (("diagonal", 0), ("round 1", 1)):
        mat, t = graph.blocks[0][s]
        n, n_in, nnz = mat.n_out, mat.n_in, mat.nnz
        pattern = csr_library(mat.indptr, mat.indices, torch.zeros(nnz, device="cuda"), (n, n_in))
        for dtype in ("bfloat16", "float32"):
            for d in DIST_GAT_SDDMM_WIDTHS:
                label = f"sddmm {dtype} d={d} (dist GAT {where} block)"
                args, check, ms, plain_ms, bound_use = check_sddmm(label, mat, d, dtype, 5, 1)
                a, b = args[2], args[3]
                extra = sddmm_geometry_row(label, n, a) | {"sum_bound_used": bound_use}
                library_ms = None
                if dtype == "float32":
                    al, bt = a[:, :d].contiguous(), b[:, :d].t()
                    library_ms = library_ms_or_none(
                        "sampled_addmm", lambda: torch.sparse.sampled_addmm(pattern, al, bt, beta=0.0), 5)
                    del al, bt
                moved = 8 * (n + 1) + 4 * nnz + (n + n_in) * d * elt_size(a) + 4 * nnz
                keep(kernel_row("sddmm", dtype, d, n, nnz, launches["sddmm"].get((dtype, a.shape[1]), 0), check, ms,
                                plain_ms, library_ms, moved) | extra, where, n, n_in)
                del args, a, b
        del pattern
        w32 = torch.rand(nnz, device="cuda", generator=gen)
        w16 = w32.to(torch.bfloat16)
        lib = csr_library(mat.indptr, mat.indices, w32, (n, n_in))
        for d in DIST_GAT_EDGE_WIDTHS:
            b = operand(n_in, d, "bfloat16", seed=d)
            label = f"edge bfloat16 d={d} (dist GAT {where} block)"
            check, ms, plain_ms = time_against_plain(label, se.edge, se.edge_plain,
                                                     (mat.indptr, mat.indices, w16, b), "bfloat16", 5, 1, repeat=True)
            extra = walk_geometry(label, se.edge_geometry("edge", n, b.shape[1], b.dtype))
            bl = b[:, :d].float()
            library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
            moved = 8 * (n + 1) + 4 * nnz + 2 * nnz + n_in * d * 2 + n * d * 4
            keep(kernel_row("edge", "bfloat16", d, n, nnz, launches["edge"].get(("bfloat16", b.shape[1]), 0), check,
                            ms, plain_ms, library_ms, moved) | extra, where, n, n_in)
            del b, bl
        del lib, w16
        transposed = csr_library(t.t_indptr, t.t_rows, w32[t.perm.long()], (n_in, n))
        for dtype in ("bfloat16", "float32"):
            w = w32.to(se.DTYPES[dtype])
            for d in DIST_GAT_EDGE_T_WIDTHS:
                label = f"edge_t {dtype} d={d} (dist GAT {where} block)"
                a, check, ms, plain_ms = check_edge_t(label, mat, t, w, d, dtype, 5, 1, repeat=True)
                extra = walk_geometry(label, se.edge_geometry("edge_t", n_in, a.shape[1], a.dtype))
                library_ms = None
                if dtype == "float32":
                    al = a[:, :d].contiguous()
                    library_ms = library_ms_or_none("torch.sparse.mm", lambda: torch.sparse.mm(transposed, al), 5)
                    del al
                moved = 8 * (n_in + 1) + 8 * nnz + elt_size(w) * nnz + n * d * elt_size(a) + n_in * d * 4
                keep(kernel_row("edge_t", dtype, d, n_in, nnz, launches["edge_t"].get((dtype, a.shape[1]), 0), check,
                                ms, plain_ms, library_ms, moved) | extra, where, n, n_in)
                del a
        del transposed, w32
        torch.cuda.empty_cache()

    if not empty_block:
        return rows
    m = graph.m_loc
    none = torch.zeros(0, dtype=torch.int64, device="cuda")
    mat, t = dist_gat.attention_block(none, none, m, m, "bfloat16")
    before = counts()
    z = torch.randn((m, 64), device="cuda", generator=gen)
    w = torch.zeros(0, device="cuda")
    scores, prod = ea.sddmm(mat, t, z, z), ea.spmm_attn(mat, t, w, z)
    prod_t = se.spmm_edge_tiles_t(mat, t, z, w_slots=w)
    torch.cuda.synchronize()
    if scores.numel() or prod.shape != (m, 64) or prod.any() or prod_t.shape != (m, 64) or prod_t.any():
        raise AssertionError("an empty attention block did not give zeros")
    if counts() != before:
        raise AssertionError("an empty attention block launched a kernel")
    log(f"  an empty {m} x {m} block: sddmm scores nothing, edge and edge_t give zeros, no launch")
    return rows


def module_run(module: str, args: list[str], cwd: str = ROOT, after=None) -> subprocess.CompletedProcess:
    """``python -m <module> <args>`` from the checkout (output captured, 300
    s limit), once the future ``after`` (if any) has its result."""
    if after is not None:
        after.result()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def start_module(module: str, args: list[str], pool, cwd: str = ROOT):
    """:func:`module_run` in ``pool`` (phase 18's thread pool): a future of
    its CompletedProcess."""
    return pool.submit(module_run, module, args, cwd)


def start_cli(tmp: str, args: list[str], pool):
    """``python -m mg_gcn_tpu_torch.cli -E 3 --csv-dir <a directory of its
    own> <args>``, started in ``pool``: (future, the CSV directory), for
    :func:`run_cli`."""
    csv_dir = tempfile.mkdtemp(prefix="csvs", dir=tmp)
    return start_module("mg_gcn_tpu_torch.cli", ["-E", "3", "--csv-dir", csv_dir, *args], pool), csv_dir


def run_cli(ds, args: list[str], csv_name: str, started, phases: set[str] | None = None) -> list[str]:
    """The run of ``python -m mg_gcn_tpu_torch.cli -E 3 ... <args>`` that
    :func:`start_cli` ``started``: exit code 0,
    the JAX CLI's three header lines, three ``epoch loss acc seconds``
    lines with finite losses and the timer CSV's keys, then ``phase_`` and
    each of ``phases`` (``--time-phases``: from the device trace, so no
    fallback line; an ``unattributed`` row may follow); returns the stderr
    lines."""
    future, csv_dir = started
    r = future.result()
    if r.returncode != 0:
        raise AssertionError(f"CLI {args} exited {r.returncode}:\n{r.stderr}")
    lines = r.stderr.splitlines()
    want = [f"{ds.num_nodes} {ds.graph.nnz}", f"num_labels = {ds.num_labels}", f"feature size = {ds.num_features}"]
    if lines[:3] != want:
        raise AssertionError(f"CLI {args}: stderr header {lines[:3]} != {want}")
    epochs = [line.split() for line in lines if re.fullmatch(r"\d+ \S+ \S+ \S+", line)]
    if [int(e[0]) for e in epochs] != [0, 1, 2] or not all(math.isfinite(float(e[1])) for e in epochs):
        raise AssertionError(f"CLI {args}: epoch lines {epochs}")
    keys = [line.split(":")[0] for line in open(os.path.join(csv_dir, csv_name)).read().splitlines()]
    extra = set(keys[4:]) - {"phase_unattributed"}
    if keys[:4] != ["0_preprocess", "0_0_epoch", "1_0_epoch", "2_0_epoch"] or extra != {
            f"phase_{k}" for k in phases or ()}:
        raise AssertionError(f"CLI {args}: timer CSV keys {keys}")
    if FALLBACK_LINE in lines:
        raise AssertionError(f"CLI {args}: the un-fused fallback ran on the card")
    log("  " + "\n  ".join(lines))
    return lines


def run_command(args: list[str], started) -> list[str]:
    """The run of ``python -m mg_gcn_tpu_torch.cli <args>`` (infer,
    pagerank) that :func:`start_module` ``started``: exit code 0; returns
    and logs its stderr lines."""
    r = started.result()
    if r.returncode != 0:
        raise AssertionError(f"CLI {args} exited {r.returncode}:\n{r.stderr}")
    lines = r.stderr.splitlines()
    log("  " + "\n  ".join(lines))
    return lines


def phase_cli_sage_pagerank(tmp: str, toy: str, runs: dict) -> None:
    """``--model sage -E 3 train <toy> 1 16 --save CK``, then ``--model sage
    infer <toy> 1 16 --load CK``: predictions.bin equal to the library's
    forward from that checkpoint (``build_sage_pair`` impl="auto" bfloat16,
    as the CLI's defaults); ``pagerank <toy>`` equal to the library's
    ``pagerank`` bit for bit, and at ``-P 4 --device cuda:0,cuda:0,cuda:0,
    cuda:0`` within rtol 1e-4 / atol 1e-5 of its ``pagerank_dist`` (COO ring
    blocks, summed by index_add_)."""
    from mg_gcn_tpu_torch.checkpoint import load_checkpoint
    from mg_gcn_tpu_torch.formats import Dataset, read_dense
    from mg_gcn_tpu_torch.models import sage
    from mg_gcn_tpu_torch.models.pagerank import pagerank, pagerank_dist
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.parallel import dist

    ds = Dataset.load(toy)
    ck, preds = os.path.join(tmp, "sage.npz"), os.path.join(tmp, "predictions.bin")
    lines = run_cli(ds, ["--model", "sage", "--save", ck, "train", toy, "1", "16"], "toy_32_16_7_1.csv",
                    started=runs["sage"])
    if not any(line.startswith("aggregation engine: pattern") for line in lines):
        raise AssertionError("CLI --model sage: no pattern engine line")
    lines = run_command(["--model", "sage", "--load", ck, "--save", preds, "infer", toy, "1", "16"],
                        started=runs["infer"])
    if not lines[-2].startswith(f"inference: n={ds.num_nodes} acc="):
        raise AssertionError(f"CLI infer: stderr {lines}")
    config = sage.SAGEConfig(sizes=(ds.num_features, 16, ds.num_labels))
    template = sage.init_params(config, device="cuda")
    params, _ = load_checkpoint(ck, (template, adam.adam_init(template)))
    pair = sage.build_sage_pair(ds.graph, device="cuda")
    with torch.no_grad():
        want = torch.argmax(sage.forward(params, pair, torch.from_numpy(ds.features).cuda(), config), dim=-1)
    got = read_dense(preds, np.int32)
    if got.shape != (ds.num_nodes, 1) or not np.array_equal(got[:, 0], want.cpu().numpy()):
        raise AssertionError("CLI infer: predictions.bin differs from the library's forward")

    out1, out4 = os.path.join(tmp, "pagerank.bin"), os.path.join(tmp, "pagerank4.bin")
    lines = run_command(["--save", out1, "pagerank", toy], started=runs["pagerank"])
    if not lines[-2].startswith(f"pagerank n={ds.num_nodes} sum=") or lines[-1] != f"wrote {out1}":
        raise AssertionError(f"CLI pagerank: stderr {lines}")
    want = pagerank(ds.graph, device="cuda").cpu().numpy()
    if not np.array_equal(read_dense(out1)[:, 0], want):
        raise AssertionError("CLI pagerank: pagerank.bin differs from the library's pagerank")
    ring = ",".join(["cuda:0"] * DIST_PARTS)
    run_command(["-P", str(DIST_PARTS), "--device", ring, "--save", out4, "pagerank", toy], started=runs["pagerank4"])
    want4 = pagerank_dist(ds.graph, dist.make_mesh(DIST_PARTS, ring.split(",")))
    compare_pagerank(f"CLI pagerank -P {DIST_PARTS}", torch.from_numpy(read_dense(out4)[:, 0]), want4.cpu(),
                     "the library's pagerank_dist")
    log("  CLI infer and pagerank files equal the library's results")


def phase_cli_dist_halo_gather(tmp: str, toy: str, runs: dict) -> None:
    """``-P 4 -R 1`` on one card past the pattern pair: ``train`` of a
    weighted copy of the toy graph under ``auto`` (the halo pair, the JAX
    CLI's stderr lines: the local engine by ``train.halo_engine`` and the
    moved rows of the library's build), ``--impl gather`` (the serial-gather
    ring) and ``--model sage --impl halo`` on the toy graph."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset
    from mg_gcn_tpu_torch.parallel import dist, dist_halo
    from mg_gcn_tpu_torch.train import halo_engine

    ds = Dataset.load(toy)
    toyw = os.path.join(tmp, "toyw")
    dsw = Dataset.load(toyw)
    ring = ",".join(["cuda:0"] * DIST_PARTS)
    lines = run_cli(dsw, ["-P", str(DIST_PARTS), "-R", "1", "--device", ring, "train", toyw, "2", "128", "128"],
                    "toyw_32_128_128_8_4.csv", started=runs["halo"])
    mat = dist_halo.DistHaloMat.from_csr(sparse.transpose(sparse.normalize(dsw.graph, axis=True)),
                                         dist.make_mesh(DIST_PARTS, ring.split(",")))
    want = [f"halo exchange: {DIST_PARTS * sum(mat.round_widths)} rows/SpMM fwd moved ({mat.halo_total} useful;"
            f" dense bcast would move {(DIST_PARTS - 1) * dsw.num_nodes})"]
    if halo_engine(dsw.graph, on_card=True) == "gather":
        want.insert(0, "halo local engine: serial-gather")
    if [line for line in lines if line.startswith("halo ")] != want or not any(
            line.startswith("aggregation engine: halo") for line in lines):
        raise AssertionError(f"CLI -P {DIST_PARTS} on a weighted graph: no halo pair, or not the lines {want}")
    del mat
    run_cli(ds, ["-P", str(DIST_PARTS), "-R", "1", "--device", ring, "--impl", "gather", "train", toy, "2", "128",
                      "128"], "toy_32_128_128_8_4.csv", started=runs["gather4"])
    run_cli(ds, ["-P", str(DIST_PARTS), "-R", "1", "--device", ring, "--model", "sage", "--impl", "halo", "train",
                      toy, "1", "16"], "toy_32_16_8_4.csv", started=runs["sage_halo4"])


def epoch_numbers(lines: list[str]) -> list[tuple[float, float]]:
    """(loss, acc) of each ``epoch loss acc seconds`` line."""
    return [(float(e[1]), float(e[2])) for e in (line.split() for line in lines if re.fullmatch(r"\d+ \S+ \S+ \S+",
                                                                                                 line))]


def phase_cli_dist_gat_col(tmp: str, toy: str, runs: dict) -> None:
    """``-P 4 -R 1 --model gat --heads 2 train <toy> 1 16`` and ``-P 4 -R 0
    train <toy> 2 128 128 --save CK``, four partitions on one card: the
    epoch lines equal the library's steps on the same inputs (GAT: losses
    within rtol 1e-5 and accuracies equal, from the seed-99 init, 7 labels
    rounded to 8; column: losses within rtol 1e-4, since the COO engine's
    index_add_ adds in another order each run, and the JAX CLI's parity
    note), and the checkpoint holds the full rounded arrays."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.ops.spmm import COOMat
    from mg_gcn_tpu_torch.parallel import dist, dist_col, dist_gat

    ds = Dataset.load(toy)
    ring = ",".join(["cuda:0"] * DIST_PARTS)
    mesh = dist.make_mesh(DIST_PARTS, ring.split(","))
    labels = -(-ds.num_labels // DIST_PARTS) * DIST_PARTS
    lines = run_cli(ds, ["-P", str(DIST_PARTS), "-R", "1", "--device", ring, "--model", "gat", "--heads", "2",
                              "train", toy, "1", "16"], f"toy_32_16_{labels}_{DIST_PARTS}.csv", started=runs["gat4"])
    config = gat.GATConfig(sizes=(ds.num_features, 16, labels), heads=2)
    start = gat.init_params(config, None, device="cuda:0")
    graph = dist_gat.build_dist_gat_graph(ds.graph, mesh, dtype="bfloat16")
    xs, ys, masks = dist.shard_dataset(ds, mesh)
    step = dist_gat.make_dist_gat_train_step(config, mesh, graph)
    p, st, want = dist.replicate(start, mesh), dist.replicate(adam.adam_init(start), mesh), []
    for _ in range(3):
        p, st, loss, acc = step(p, st, graph, xs, ys, masks)
        want.append((float(loss), float(acc)))
    got = epoch_numbers(lines)
    if not all(math.isclose(g[0], w[0], rel_tol=1e-5) and g[1] == w[1] for g, w in zip(got, want)):
        raise AssertionError(f"CLI --model gat -P {DIST_PARTS}: epochs {got}, the library's {want}")
    log(f"  CLI --model gat -P {DIST_PARTS}: epochs {got} (the library's {want})")
    del graph, p, st

    ck = os.path.join(tmp, "col.npz")
    sizes = tuple(-(-s // DIST_PARTS) * DIST_PARTS for s in (ds.num_features, 128, 128, ds.num_labels))
    lines = run_cli(ds, ["-P", str(DIST_PARTS), "-R", "0", "--device", ring, "--save", ck, "train", toy, "2",
                              "128", "128"], f"toy_{'_'.join(map(str, sizes))}_{DIST_PARTS}.csv", started=runs["col4"])
    if not any(line.startswith("note: column path uses exact autodiff gradients") for line in lines):
        raise AssertionError("CLI -R 0: no parity note")
    config = GCNConfig(sizes=sizes, parity=False)
    full = init_params(config, device="cuda:0")
    a = sparse.normalize(ds.graph, axis=True)
    mats = dist_col.replicate_coo(COOMat.from_csr(sparse.transpose(a), device="cuda:0"), mesh)
    x = np.zeros((ds.num_nodes, sizes[0]), np.float32)
    x[:, : ds.num_features] = ds.features
    xs = dist_col.shard_columns(x, mesh)
    ys = [torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to("cuda:0")] * DIST_PARTS
    step = dist_col.make_col_train_step(config, mesh, ds.num_nodes)
    p, st, want = dist_col.shard_col_params(full, mesh), dist_col.shard_col_state(adam.adam_init(full), mesh), []
    for _ in range(3):
        p, st, loss, acc = step(p, st, mats, xs, ys)
        want.append((float(loss), float(acc)))
    got = epoch_numbers(lines)
    if not all(math.isclose(g[0], w[0], rel_tol=1e-4) for g, w in zip(got, want)) or len(got) != 3:
        raise AssertionError(f"CLI -R 0: epochs {got}, the library's {want}")
    with np.load(ck) as saved:
        shapes = [saved[f"leaf_{i}"].shape for i in range(len(saved.files))]
    state = adam.adam_init(full)
    template = [tuple(t.shape) for t in (*(v for la in full for _, v in sorted(la.items())), state.step,
                                         *(v for la in state.m for _, v in sorted(la.items())),
                                         *(v for la in state.v for _, v in sorted(la.items())))]
    if shapes != template:
        raise AssertionError(f"CLI -R 0 checkpoint leaves {shapes}, want the full rounded arrays {template}")
    log(f"  CLI -P {DIST_PARTS} -R 0: epochs {got} (the library's {want}); checkpoint leaves {shapes}")


def phase_cli_phases_f64(tmp: str, toy: str, runs: dict) -> None:
    """``--time-phases``, ``--profile DIR`` and ``--f64`` on the toy dataset:
    the ``phase_`` rows of the JAX package's scopes from the device trace
    (no fallback line), a non-empty Chrome trace that names the CSR walk
    ``auto`` takes there, and a float64 run on the COO engine."""
    from mg_gcn_tpu_torch.formats import Dataset
    from mg_gcn_tpu_torch.models.gcn import GCNConfig

    ds = Dataset.load(toy)
    config = GCNConfig(sizes=(ds.num_features, 128, 128, ds.num_labels))
    run_cli(ds, ["--time-phases", "train", toy, "2", "128", "128"], "toy_32_128_128_7_1.csv",
            phases=gcn_phase_keys(config), started=runs["phases"])
    prof = os.path.join(tmp, "prof")
    run_cli(ds, ["--profile", prof, "train", toy, "2", "128", "128"], "toy_32_128_128_7_1.csv",
            started=runs["profile"])
    trace = open(os.path.join(prof, "trace.json")).read()
    if "csr::walk_kernel" not in trace:
        raise AssertionError("CLI --profile: the trace names no CSR walk kernel")
    log(f"  --profile: trace.json {len(trace)} bytes, CSR walk events {trace.count('csr::walk_kernel')}")
    lines = run_cli(ds, ["--f64", "train", toy, "2", "128", "128"], "toy_32_128_128_7_1.csv", started=runs["f64"])
    if any(line.startswith("aggregation engine") for line in lines):
        raise AssertionError("CLI --f64: not on the COO engine")


CLI_CONCURRENCY = 6  # phase 18's CLI processes run this many at a time


def start_cli_runs(tmp: str, toy: str, pool) -> dict:
    """Every CLI process of phase 18, started in ``pool`` in the order the
    checks read them (a run that needs another's files starts when that
    one has ended): name -> :func:`start_cli`'s (future, CSV directory), or
    a future of the CompletedProcess for ``infer``, ``pagerank`` and
    ``prep``."""
    ring, P = ",".join(["cuda:0"] * DIST_PARTS), str(DIST_PARTS)
    runs = {}

    def after(first: str, module: str, args: list[str], cwd: str = ROOT):
        dep = runs[first][0] if isinstance(runs[first], tuple) else runs[first]
        return pool.submit(module_run, module, args, cwd, dep)

    def cli_after(first: str, args: list[str]):
        csv_dir = tempfile.mkdtemp(prefix="csvs", dir=tmp)
        return after(first, "mg_gcn_tpu_torch.cli", ["-E", "3", "--csv-dir", csv_dir, *args]), csv_dir

    for name, args in (
            ("gcn", ["train", toy, "2", "128", "128"]),
            ("gat", ["--model", "gat", "--heads", "2", "train", toy, "1", "16"]),
            ("p4", ["-P", "4", "-R", "1", "--device", ring, "train", toy, "2", "128", "128"]),
            ("sage", ["--model", "sage", "--save", os.path.join(tmp, "sage.npz"), "train", toy, "1", "16"])):
        runs[name] = start_cli(tmp, args, pool)
    runs["infer"] = after("sage", "mg_gcn_tpu_torch.cli", [
        "--model", "sage", "--load", os.path.join(tmp, "sage.npz"), "--save", os.path.join(tmp, "predictions.bin"),
        "infer", toy, "1", "16"])
    runs["pagerank"] = start_module("mg_gcn_tpu_torch.cli", ["--save", os.path.join(tmp, "pagerank.bin"), "pagerank",
                                                             toy], pool)
    runs["pagerank4"] = start_module("mg_gcn_tpu_torch.cli", ["-P", P, "--device", ring, "--save",
                                                              os.path.join(tmp, "pagerank4.bin"), "pagerank", toy],
                                     pool)
    toyw = os.path.join(tmp, "toyw")
    for name, args in (
            ("halo", ["-P", P, "-R", "1", "--device", ring, "train", toyw, "2", "128", "128"]),
            ("gather4", ["-P", P, "-R", "1", "--device", ring, "--impl", "gather", "train", toy, "2", "128", "128"]),
            ("sage_halo4", ["-P", P, "-R", "1", "--device", ring, "--model", "sage", "--impl", "halo", "train", toy,
                            "1", "16"]),
            ("gat4", ["-P", P, "-R", "1", "--device", ring, "--model", "gat", "--heads", "2", "train", toy, "1", "16"]),
            ("col4", ["-P", P, "-R", "0", "--device", ring, "--save", os.path.join(tmp, "col.npz"), "train", toy, "2",
                      "128", "128"]),
            ("phases", ["--time-phases", "train", toy, "2", "128", "128"]),
            ("profile", ["--profile", os.path.join(tmp, "prof"), "train", toy, "2", "128", "128"]),
            ("f64", ["--f64", "train", toy, "2", "128", "128"])):
        runs[name] = start_cli(tmp, args, pool)
    runs["synthetic"] = start_module("mg_gcn_tpu_torch.data.prep", ["synthetic", "-n", "20000", "--deg", "16", "--feat",
                                                                    "32", "--labels", "7", "-o", tmp], pool,
                                     cwd=tmp)
    runs["cluster"] = after("synthetic", "mg_gcn_tpu_torch.data.prep", ["cluster", os.path.join(tmp, "synthetic")],
                            cwd=tmp)
    clustered = os.path.join(tmp, "synthetic_clustered")
    for impl in ("block", "pallas"):
        runs[impl] = cli_after("cluster", ["--impl", impl, "train", clustered, "1", "16"])
    return runs


def phase_cli() -> None:
    """The CLI on a small binary dataset: GCN (``train <dir> 2 128 128``,
    where ``auto`` must pick the binary CSR walk, "gather"), GAT (``--model gat
    --heads 2 train <dir> 1 16``), ``-P 4 -R 1`` GCN on one card (the
    dist pattern pair, the fused exchange by ``auto``), SAGE's train and
    infer and PageRank at -P 1 and 4 (:func:`phase_cli_sage_pagerank`);
    then ``data.prep synthetic`` and ``prep cluster`` (RCM) write a dataset
    and its clustered copy, and GCN trains on the copy with ``--impl block``
    and ``--impl pallas``. The CLI processes run CLI_CONCURRENCY at a time
    (:func:`start_cli_runs`), each with a CSV directory of its own; their
    checks read them in this order."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.cli import _csv_name
    from mg_gcn_tpu_torch.formats import CSRData, Dataset

    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor(CLI_CONCURRENCY) as pool:
        rng = np.random.default_rng(5)
        n = 50_000
        toy = os.path.join(tmp, "toy")
        g = sparse.random_graph(n, 20, seed=5)
        features = rng.standard_normal((n, 32)).astype(np.float32)
        labels = rng.integers(0, 7, (n, 1)).astype(np.int32)
        Dataset(graph=g, features=features, labels=labels, sets=np.zeros((n, 1), np.int32)).save(toy)
        # a weighted copy for the halo pair (phase_cli_dist_halo_gather)
        Dataset(graph=CSRData(g.indptr, g.indices, np.random.default_rng(9).random(g.nnz, np.float32) + 0.5, g.shape),
                features=features, labels=labels, sets=np.zeros((n, 1), np.int32)).save(os.path.join(tmp, "toyw"))
        runs = start_cli_runs(tmp, toy, pool)
        ds = Dataset.load(toy)
        lines = run_cli(ds, ["train", toy, "2", "128", "128"], "toy_32_128_128_7_1.csv", started=runs["gcn"])
        if not any(line.startswith("aggregation engine: gather") for line in lines):
            raise AssertionError("CLI: no gather engine line")
        run_cli(ds, ["--model", "gat", "--heads", "2", "train", toy, "1", "16"], "toy_32_16_7_1.csv",
                started=runs["gat"])
        # -P 4 -R 1, the four partitions on one card; 7 labels round up to 8
        lines = run_cli(ds, ["-P", "4", "-R", "1", "--device", ",".join(["cuda:0"] * 4), "train", toy, "2",
                                  "128", "128"], "toy_32_128_128_8_4.csv", started=runs["p4"])
        if "exchange: fused ring (auto)" not in lines or not any(
                line.startswith("aggregation engine: pattern") for line in lines):
            raise AssertionError("CLI -P 4: no pattern pair or no fused exchange")
        phase_cli_sage_pagerank(tmp, toy, runs)
        phase_cli_dist_halo_gather(tmp, toy, runs)
        phase_cli_dist_gat_col(tmp, toy, runs)
        phase_cli_phases_f64(tmp, toy, runs)

        for name in ("synthetic", "cluster"):
            r = runs[name].result()
            if r.returncode != 0:
                raise AssertionError(f"data.prep {name} exited {r.returncode}:\n{r.stderr}")
            log("  " + r.stdout.strip())
        clustered = os.path.join(tmp, "synthetic_clustered")
        ds = Dataset.load(clustered)
        csv = _csv_name(clustered, [ds.num_features, 16, ds.num_labels], 1)
        for impl in ("block", "pallas"):
            run_cli(ds, ["--impl", impl, "train", clustered, "1", "16"], csv, started=runs[impl])


def write_papers_like(directory: str, n: int, draws: int, features: int, classes: int, seed: int) -> dict:
    """A papers100M-like dataset in the reference formats (the geometry of
    scripts/papers_rehearsal.py:33-60: ``draws`` edges a row, 80% to
    columns row ± MH_BAND clipped to [0, n), 20% uniform; self loops;
    duplicates merged; binary), drawn and merged on the card from a seed,
    with standard normal float32 features, labels in [0, classes) and sets
    in {0, 1, 2}. Returns its row and entry counts."""
    from mg_gcn_tpu_torch.formats import CSRData, write_dense, write_pigo_csr

    os.makedirs(directory, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.randint(0, n, (n * draws,), device="cuda", generator=gen)
    near = torch.clamp(src + torch.randint(-MH_BAND, MH_BAND + 1, src.shape, device="cuda", generator=gen), 0, n - 1)
    far = torch.randint(0, n, src.shape, device="cuda", generator=gen)
    dst = torch.where(torch.rand(src.shape, device="cuda", generator=gen) < 1 - MH_FAR, near, far)
    del near, far
    loops = torch.arange(n, device="cuda")
    key = torch.unique(torch.cat([src, loops]) * n + torch.cat([dst, loops]))  # sorted: CSR order
    del src, dst
    indptr = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    torch.cumsum(torch.bincount(key // n, minlength=n), 0, out=indptr[1:])
    indices = (key % n).to(torch.int32).cpu().numpy()
    nnz = key.numel()
    del key
    write_pigo_csr(os.path.join(directory, "graph.bin"),
                   CSRData(indptr.cpu().numpy(), indices, np.ones(nnz, np.float32), (n, n)))
    del indices
    with open(os.path.join(directory, "features.bin"), "wb") as f:
        np.array([n, features], np.uint32).tofile(f)
        for r0 in range(0, n, 1 << 20):
            rows = min(1 << 20, n - r0)
            f.write(torch.randn((rows, features), device="cuda", generator=gen).cpu().numpy().tobytes())
    labels = torch.randint(0, classes, (n, 1), device="cuda", generator=gen).to(torch.int32).cpu().numpy()
    labels[0] = classes - 1  # 1 + max(labels) is the class count (main.cpp:88)
    write_dense(os.path.join(directory, "labels.bin"), labels, np.uint32)
    sets = torch.randint(0, 3, (n, 1), device="cuda", generator=gen).to(torch.int32).cpu().numpy()
    write_dense(os.path.join(directory, "sets.bin"), sets, np.uint32)
    torch.cuda.empty_cache()
    return {"n": n, "nnz": nnz}


def mh_env(rank: int | None, port: int) -> dict:
    """The environment of a worker: its rank's ``MG_GCN_*`` variables (all
    on cuda:0), or none for a one-process run."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MG_GCN_")}
    env["PYTHONPATH"] = ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")
    if rank is not None:
        env.update(MG_GCN_COORDINATOR=f"localhost:{port}", MG_GCN_NUM_PROCESSES=str(MH_PARTS),
                   MG_GCN_PROCESS_ID=str(rank), MG_GCN_LOCAL_DEVICE_IDS="0")
    return env


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# a worker starts from a small launcher process of its own, in a process
# group of its own: a process started by fork and exec carries its parent's
# memory at the fork into getrusage's peak RSS (ru_maxrss), so a worker
# forked from this script would report this script's RSS as its own
WORKER_LAUNCHER = "import subprocess, sys; sys.exit(subprocess.call(sys.argv[1:]))"


def launch_workers(label: str, specs: list[dict], world: bool) -> list[dict]:
    """Run ``python chip_smoke.py --multihost-worker <spec>`` once a spec
    (each through WORKER_LAUNCHER), as the ranks of one run when ``world``
    (else one process alone). Every worker must exit 0 within MH_TIMEOUT_S;
    all are killed otherwise (each launcher's process group), and a failure
    raises. Returns each worker's result (its last stdout line) with its
    stdout's other lines and its stderr lines."""
    import signal

    port = free_port()
    procs = []
    try:
        for rank, spec in enumerate(specs):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER_LAUNCHER, sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--multihost-worker", json.dumps(spec)],
                cwd=ROOT, env=mh_env(rank if world else None, port), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, process_group=0))
        outs = [p.communicate(timeout=MH_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{label}: worker {rank} exited {p.returncode}:\n{err[-6000:]}\n{out[-2000:]}")
        result = json.loads(out.strip().splitlines()[-1])
        result["stderr"] = err.splitlines()
        result["stdout"] = out.strip().splitlines()[:-1]
        results.append(result)
    return results


def epoch_lines(lines: list[str]) -> list[tuple[str, str, float]]:
    """(loss, acc, seconds) of each ``epoch loss acc seconds`` line, the
    numbers as printed."""
    out = [line.split() for line in lines if re.fullmatch(r"\d+ \S+ \S+ \S+", line)]
    return [(e[1], e[2], float(e[3])) for e in out]


def multihost_worker(spec: dict) -> int:
    """One worker of phases 19 and 20: ``mg_gcn_tpu_torch.cli.main(spec["argv"])``
    with the run's operator kept (``DistHaloPair.from_pigo`` /
    ``from_csr_pair``, ``dist_gat.build_dist_gat_graph`` or
    ``dist_col.replicate_coo`` wrapped) and the exchange helpers
    (``multihost.exchange`` / ``all_gather``) wrapped to add up their wall
    seconds and the bytes they send to other processes (an all-gather's
    once for each peer) from the operator's build on; under
    ``spec["deterministic"]`` with PyTorch's deterministic algorithms on
    (the COO engine's index_add_ in a fixed order). Prints one JSON line:
    every kernel's launches by width over the run, peak card memory and host
    RSS, the exchange's bytes and seconds, the halo pair's moved and useful
    rows or the GAT blocks' entries, and with ``spec["kernels"]`` the
    kernels' rows at this process's first partition's blocks: ``gather``
    at the halo pair's diagonal and round-0 blocks of Âᵀ at d =
    MH_KERNEL_D, or the attention kernels at the GAT graph's diagonal and
    round-1 blocks (:func:`phase_dist_gat_kernels`)."""
    import resource

    sys.path.insert(0, ROOT)
    from mg_gcn_tpu_torch import cli
    from mg_gcn_tpu_torch.parallel import dist_col, dist_gat, dist_halo, multihost

    kept, spent = {}, {"exchange_s": 0.0, "bytes": 0}

    def keep(build):
        def wrapped(*a, **k):
            pair = build(*a, **k)
            torch.cuda.synchronize()
            kept.update(pair=pair, built=time.perf_counter())
            spent.update(exchange_s=0.0, bytes=0)
            return pair
        return wrapped

    def timed(fn, sent):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent["exchange_s"] += time.perf_counter() - t0
                spent["bytes"] += sent(*a)
        return wrapped

    def nbytes(t):
        return t.numel() * t.element_size()

    H = dist_halo.DistHaloPair
    H.from_pigo, H.from_csr_pair = staticmethod(keep(H.from_pigo)), staticmethod(keep(H.from_csr_pair))
    dist_gat.build_dist_gat_graph = keep(dist_gat.build_dist_gat_graph)
    dist_col.replicate_coo = keep(dist_col.replicate_coo)
    multihost.exchange = timed(multihost.exchange, lambda sends, recvs: sum(nbytes(t) for t, _, _ in sends))
    multihost.all_gather = timed(multihost.all_gather, lambda t: nbytes(t) * (multihost.process_count() - 1))
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(True, warn_only=True)
        warnings.simplefilter("ignore", UserWarning)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    code = cli.main(spec["argv"])
    torch.cuda.synchronize()
    launched = counts()
    out = {"code": code, "wall_s": time.perf_counter() - t0,
           "launches": {name: [[dt, d, v] for (dt, d), v in per.items()] for name, per in launched.items() if per},
           "peak_card_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
           "bytes_after_build": spent["bytes"],
           "exchange_s": spent["exchange_s"], "epochs_s": time.perf_counter() - kept.get("built", t0)}
    pair = kept.get("pair")
    if isinstance(pair, H):
        out.update(moved=pair.fwd.parts * sum(pair.fwd.round_widths), useful=pair.fwd.halo_total,
                   round_widths=list(pair.fwd.round_widths), engine=type(pair.fwd).__name__)
    elif isinstance(pair, dist_gat.DistGatGraph):
        out.update(block_nnz=pair.block_nnz, m_loc=pair.m_loc)
    if spec.get("kernels") and code == 0:
        if isinstance(pair, H):
            out["rows"] = multihost_kernel_rows(pair, launched["gather"])
        else:
            counted = f"process 0's {spec['epochs']} bfloat16 epochs, every block of its partition"
            out["rows"] = phase_dist_gat_kernels(pair, launched, counted, spec["epochs"], empty_block=False)
    print(json.dumps(out))
    multihost.shutdown()
    return 0 if code == 0 else 1


def multihost_kernel_rows(pair, launches: dict) -> list[dict]:
    """The gather kernel at this process's first partition's Âᵀ blocks (the
    diagonal, m_loc x m_loc, and round 0's, m_loc x w_0) at d =
    MH_KERNEL_D: against its plain version summed in float64, twice bit for
    bit, timed beside the bound, the plain version and torch.sparse.mm on
    the same block. ``launches`` is this process's counter over its run."""
    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    d, rows = MH_KERNEL_D, []
    for where, blk in (("diagonal", pair.fwd.loc[0]), ("round 0", pair.fwd.rem[0][0])):
        b = operand(blk.n_in, d, "float32", seed=d)
        label = f"gather float32 d={d} (two-process halo {where}, {blk.n_out} x {blk.n_in})"
        check, ms, plain_ms = time_against_plain(label, sg.gather, sg.gather_plain,
                                                 (blk.indptr, blk.indices, blk.w, b), "float32", 5, 1, repeat=True)
        extra = walk_geometry(label, sg.gather_geometry(blk.n_out, b.shape[1], b.dtype, True))
        lib, bl = csr_library(blk.indptr, blk.indices, blk.w, (blk.n_out, blk.n_in)), b[:, :d].contiguous()
        library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
        del lib, bl
        moved = 8 * (blk.n_out + 1) + 8 * blk.nnz + blk.n_in * d * 4 + blk.n_out * d * 4
        rows.append(kernel_row("gather", "float32", d, blk.n_out, blk.nnz, launches.get(("float32", b.shape[1]), 0),
                               check, ms, plain_ms, library_ms, moved) | extra
                    | {"shape": f"two-process halo {where} {blk.n_out} x {blk.n_in}",
                       "launches_counted": "process 0's run, every block of its partition's Âᵀ and Â at this width"})
        del b
        torch.cuda.empty_cache()
    return rows


def nccl_check() -> int:
    """The NCCL route builds: a world of one process on cuda:0
    (``multihost.initialize``) takes it, and one all-gather and one hop to
    itself (``multihost.exchange``) return their tensors."""
    sys.path.insert(0, ROOT)
    from mg_gcn_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{free_port()}", num_processes=1, process_id=0, local_device_ids=[0],
                         timeout=120)
    t = torch.arange(12.0, device="cuda:0").reshape(3, 4)
    gathered = multihost.all_gather(t)
    hop = multihost.exchange([(t, 0, 1)], [(torch.empty_like(t), 0, 1)])
    torch.cuda.synchronize()
    ok = multihost.route() == "nccl" and len(gathered) == 1 and torch.equal(gathered[0], t) and torch.equal(hop[0], t)
    print(json.dumps({"route": multihost.route(), "ok": bool(ok)}))
    multihost.shutdown()
    return 0 if ok else 1


def phase_multihost(smi: str) -> list[dict]:
    """Phase 19 (see the module docstring). Returns the gather kernel's
    rows at the per-process block shapes."""
    import shutil

    from mg_gcn_tpu_torch.formats import Dataset, ensure_pigo_transpose, read_pigo_header
    from mg_gcn_tpu_torch.train import halo_engine

    root = os.path.join(ROOT, "chiprun_out", "multihost")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        data = os.path.join(root, "papers_like")
        info = write_papers_like(data, MH_N, MH_DEG, MH_FEATURES, MH_CLASSES, seed=19)
        t1 = time.perf_counter()
        ensure_pigo_transpose(data)
        log(f"  dataset: n = {info['n']}, {info['nnz']} entries, {MH_FEATURES} features, {MH_CLASSES} labels;"
            f" written in {t1 - t0:.1f} s (drawn on the card), graph_t.bin by ensure_pigo_transpose in"
            f" {time.perf_counter() - t1:.1f} s")
        header = read_pigo_header(os.path.join(data, "graph.bin"))
        if halo_engine(header, True) != "gather":
            raise AssertionError("the halo rule did not take the gather engine for the papers-like graph")
        args = ["-P", str(MH_PARTS), "-R", "1", "--impl", "halo", "--mmap", "-E", str(MH_EPOCHS), "train", data,
                str(len(MH_HIDDEN)), *map(str, MH_HIDDEN)]
        csv = lambda tag: ["--csv-dir", os.path.join(root, f"csv_{tag}")]  # noqa: E731
        two = launch_workers("two processes", [
            {"argv": ["--multihost", *csv(f"rank{r}"), *args], "kernels": r == 0} for r in range(MH_PARTS)],
            world=True)
        one = launch_workers("one process", [{"argv": ["--device", ",".join(["cuda:0"] * MH_PARTS), *csv("one"),
                                                        *args]}], world=False)[0]
        for r, w in enumerate(two):
            if not any("exchange route: card tensors staged through host over gloo" in x for x in w["stderr"]):
                raise AssertionError(f"worker {r}: no staged route line:\n" + "\n".join(w["stderr"][:20]))
            if "halo local engine: serial-gather" not in w["stderr"]:
                raise AssertionError(f"worker {r}: the halo pair is not on the gather engine")
        lines = [epoch_lines(w["stderr"]) for w in two]
        want = epoch_lines(one["stderr"])
        if len(want) != MH_EPOCHS or not all(math.isfinite(float(e[0])) for e in want):
            raise AssertionError(f"one process: epoch lines {want}")
        for r, got in enumerate(lines):
            if [e[:2] for e in got] != [e[:2] for e in want]:
                raise AssertionError(f"worker {r}: (loss, acc) {[e[:2] for e in got]} != one process's"
                                     f" {[e[:2] for e in want]}")
        log(f"  route: {[x for x in two[0]['stderr'] if 'exchange route' in x][0]}")
        log(f"  losses (both processes and one process, bit for bit): {[e[0] for e in want]}")
        for tag, w, ep in [(f"process {r}", w, lines[r]) for r, w in enumerate(two)] + [("one process", one, want)]:
            epoch_s = [e[2] for e in ep]
            log(f"  {tag}: epoch seconds {epoch_s} (median of epochs 1 on"
                f" {float(np.median(epoch_s[1:])):.3f} s); run {w['wall_s']:.1f} s, of which set-up (start to the"
                f" pair built) {w['wall_s'] - w['epochs_s']:.1f} s; peak card memory {w['peak_card_gb']:.2f} GB,"
                f" peak host RSS {w['peak_rss_gb']:.2f} GB; halo rows moved {w.get('moved')} a product"
                f" ({w.get('useful')} useful, round widths {w.get('round_widths')}); gather launches"
                f" {sorted(map(tuple, w['launches'].get('gather', [])))}; [{smi}]")
        for r, w in enumerate(two):
            per_epoch = w["bytes_after_build"] / MH_EPOCHS
            log(f"  process {r}: {per_epoch / 1e9:.3f} GB sent to the other process an epoch; exchange helpers"
                f" {w['exchange_s']:.2f} s of its {w['epochs_s']:.2f} s of epochs"
                f" ({w['exchange_s'] / w['epochs_s']:.3f}, host wall clock, waits included) [{smi}]")
        launches = {(dt, d): v for dt, d, v in two[0]["launches"].get("gather", [])}
        if not launches or min(launches.values()) < 1:
            raise AssertionError(f"process 0 launched no gather kernel: {launches}")
        rows = two[0]["rows"]
        for r in rows:
            log_row(r, f"; {r['shape']}")

        t0 = time.perf_counter()
        small = os.path.join(root, "sage")
        from mg_gcn_tpu_torch import sparse

        rng = np.random.default_rng(23)
        Dataset(graph=sparse.random_graph(MH_SAGE_N, MH_SAGE_DEG, seed=23),
                features=rng.standard_normal((MH_SAGE_N, MH_FEATURES)).astype(np.float32),
                labels=rng.integers(0, MH_CLASSES, (MH_SAGE_N, 1)).astype(np.int32),
                sets=rng.integers(0, 3, (MH_SAGE_N, 1)).astype(np.int32)).save(small)
        ensure_pigo_transpose(small)
        sage = ["--model", "sage", "-P", str(MH_PARTS), "-R", "1", "--impl", "halo", "-E", "3", "train", small, "1",
                str(MH_HIDDEN[0])]
        two = launch_workers("SAGE two processes", [{"argv": ["--multihost", *csv(f"sage{r}"), *sage]}
                                                    for r in range(MH_PARTS)], world=True)
        one = launch_workers("SAGE one process", [{"argv": ["--device", "cuda:0,cuda:0", *csv("sage"), *sage]}],
                             world=False)[0]
        want = [e[:2] for e in epoch_lines(one["stderr"])]
        if len(want) != 3 or any([e[:2] for e in epoch_lines(w["stderr"])] != want for w in two):
            raise AssertionError(f"SAGE: two processes {[epoch_lines(w['stderr']) for w in two]} != one {want}")
        if two[0].get("engine") != "DistHaloGatherMat":
            raise AssertionError(f"SAGE: the halo pair is a {two[0].get('engine')}")
        log(f"  SAGE -P {MH_PARTS} two processes (n = {MH_SAGE_N}, random_graph({MH_SAGE_N}, {MH_SAGE_DEG}),"
            f" {MH_FEATURES} -> {MH_HIDDEN[0]} -> {MH_CLASSES}, halo pair on the gather engine): losses {want}"
            f" bit for bit with one process, in {time.perf_counter() - t0:.1f} s")

        r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--nccl-check"], cwd=ROOT,
                           env=mh_env(None, 0), capture_output=True, text=True, timeout=300)
        if r.returncode != 0 or not json.loads(r.stdout.strip().splitlines()[-1])["ok"]:
            raise AssertionError(f"NCCL route check exited {r.returncode}:\n{r.stderr[-4000:]}\n{r.stdout[-1000:]}")
        log(f"  NCCL route, a world of one on cuda:0: {r.stdout.strip().splitlines()[-1]}")
        return rows
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_main_datasets(ds, root: str) -> dict:
    """Phase 20's two datasets in the reference formats under ``root``:
    ``gat`` (the GAT path's 64 planted features, :func:`gat_features`) and
    ``col`` (the main path's 608 features), with the main path's labels and
    graph; ``col/graph.bin`` is a link to ``gat/graph.bin``. Returns the
    directories and the seconds taken. The directories go at the script's
    exit if phase 20 has not removed them (chiprun_out/ must stay small)."""
    import atexit
    import shutil

    from mg_gcn_tpu_torch.formats import write_dense, write_pigo_csr

    t0 = time.perf_counter()
    dirs = {"root": root, "gat": os.path.join(root, "gat"), "col": os.path.join(root, "col")}
    atexit.register(shutil.rmtree, root, True)
    for d in ("gat", "col"):
        os.makedirs(dirs[d], exist_ok=True)
    write_pigo_csr(os.path.join(dirs["gat"], "graph.bin"), ds.graph)
    os.symlink(os.path.join("..", "gat", "graph.bin"), os.path.join(dirs["col"], "graph.bin"))
    labels = ds.labels.reshape(-1, 1)
    for d, x in (("gat", gat_features(labels.reshape(-1))), ("col", ds.features)):
        write_dense(os.path.join(dirs[d], "features.bin"), x, np.float32)
        write_dense(os.path.join(dirs[d], "labels.bin"), labels, np.uint32)
        write_dense(os.path.join(dirs[d], "sets.bin"), np.zeros_like(labels), np.uint32)
    dirs["seconds"] = time.perf_counter() - t0
    return dirs


def log_workers(label: str, two: list[dict], one: dict, smi: str) -> None:
    """Phase 20's lines for one path: each process's and the one process's
    epoch and set-up seconds, peak card memory and host RSS; each process's
    bytes sent to the other an epoch and its exchange helpers' share of its
    epochs."""
    for tag, w in [(f"process {r}", w) for r, w in enumerate(two)] + [("one process", one)]:
        epoch_s = [e[2] for e in epoch_lines(w["stderr"])]
        log(f"  {label} {tag}: epoch seconds {epoch_s} (median of 1-{MH2_EPOCHS - 1}"
            f" {float(np.median(epoch_s[1:])):.4f} s); run {w['wall_s']:.1f} s, of which set-up (start to the"
            f" operator built) {w['wall_s'] - w['epochs_s']:.1f} s; peak card memory {w['peak_card_gb']:.2f} GB,"
            f" peak host RSS {w['peak_rss_gb']:.2f} GB [{smi}]")
    for r, w in enumerate(two):
        log(f"  {label} process {r}: {w['bytes_after_build'] / MH2_EPOCHS / 1e9:.4f} GB sent to the other process"
            f" an epoch; exchange helpers {w['exchange_s']:.2f} s of its {w['epochs_s']:.2f} s of epochs"
            f" ({w['exchange_s'] / w['epochs_s']:.3f}, host wall clock, waits included) [{smi}]")


def staged_route(label: str, two: list[dict]) -> str:
    for r, w in enumerate(two):
        if not any("exchange route: card tensors staged through host over gloo" in x for x in w["stderr"]):
            raise AssertionError(f"{label} worker {r}: no staged route line:\n" + "\n".join(w["stderr"][:20]))
    return [x for x in two[0]["stderr"] if "exchange route" in x][0]


def phase_multihost_gat_col(smi: str, dirs: dict) -> list[dict]:
    """Phase 20 (see the module docstring). Returns the attention kernels'
    rows at process 0's blocks."""
    import shutil
    import types

    from mg_gcn_tpu_torch.models import gat

    try:
        csv = lambda tag: ["--csv-dir", os.path.join(dirs["root"], f"csv_{tag}")]  # noqa: E731
        cols = lambda lines: [e[:2] for e in lines]  # noqa: E731
        log(f"  datasets written in {dirs['seconds']:.1f} s (graph.bin once, linked)")

        # 20: GAT across two processes
        args = ["-P", str(MH_PARTS), "-R", "1", "--model", "gat", "--heads", str(GAT_HEADS), "-E", str(MH2_EPOCHS),
                "train", dirs["gat"], "1", str(GAT_SIZES[1])]
        two = launch_workers("GAT two processes", [
            {"argv": ["--multihost", *csv(f"gat{r}"), *args], "kernels": r == 0, "epochs": MH2_EPOCHS}
            for r in range(MH_PARTS)], world=True)
        one = launch_workers("GAT one process", [{"argv": ["--device", ",".join(["cuda:0"] * MH_PARTS),
                                                           *csv("gat_one"), *args]}], world=False)[0]
        route = staged_route("GAT", two)
        want = epoch_lines(one["stderr"])
        if len(want) != MH2_EPOCHS or not all(math.isfinite(float(e[0])) for e in want):
            raise AssertionError(f"GAT one process: epoch lines {want}")
        lines = [epoch_lines(w["stderr"]) for w in two]
        how = "bit for bit with one process"
        if any(cols(got) != cols(want) for got in lines):
            again = epoch_lines(launch_workers("GAT one process, again", [{"argv": [
                "--device", ",".join(["cuda:0"] * MH_PARTS), *csv("gat_again"), *args]}], world=False)[0]["stderr"])
            if cols(again) == cols(want):
                raise AssertionError(f"GAT: two processes {[cols(x) for x in lines]} != one process {cols(want)},"
                                     " which repeats itself bit for bit")
            for r, got in enumerate(lines):
                np.testing.assert_allclose(np.array(cols(got), np.float64), np.array(cols(want), np.float64),
                                           rtol=1e-5, err_msg=f"GAT worker {r}")
            how = (f"within rtol 1e-5 of one process (two one-process runs differ: {cols(want)} and"
                   f" {cols(again)})")
        config = gat.GATConfig(sizes=MH2_GAT_SIZES, heads=GAT_HEADS)
        for tag, w in [(f"process {r}", w) for r, w in enumerate(two)] + [("one process", one)]:
            per_epoch = dist_gat_launches_per_epoch(config, types.SimpleNamespace(block_nnz=w["block_nnz"]))
            got = {(name, dt, d): v for name, per in w["launches"].items() for dt, d, v in per if v}
            if got != {k: v * MH2_EPOCHS for k, v in per_epoch.items()}:
                raise AssertionError(f"GAT {tag}: launches {got}, want {per_epoch} an epoch x {MH2_EPOCHS}")
            log(f"  GAT {tag}: entries per block [partition][round] {w['block_nnz']} (m_loc {w['m_loc']});"
                f" launches an epoch {per_epoch} ({sum(per_epoch.values())} in all)")
        log(f"  {route}")
        log(f"  GAT -P {MH_PARTS} (sizes {MH2_GAT_SIZES}, {GAT_HEADS} heads, bfloat16 blocks): losses"
            f" {[e[0] for e in want]}, both processes {how}")
        log_workers("GAT", two, one, smi)
        for line in two[0]["stdout"]:
            log(f"  [process 0] {line.strip()}")
        rows = two[0]["rows"]
        for r in rows:
            log_row(r, f"; {r['shape']}; this block {r['block_launches_an_epoch']} an epoch")

        # 20a: the column path across two processes, deterministic sums
        args = ["-P", str(MH_PARTS), "-R", "0", "-E", str(MH2_EPOCHS), "train", dirs["col"], str(len(HIDDEN)),
                *map(str, HIDDEN)]
        ck = lambda tag: ["--save", os.path.join(dirs["root"], f"ck_{tag}.npz")]  # noqa: E731
        two = launch_workers("column two processes", [
            {"argv": ["--multihost", *csv(f"col{r}"), *ck(f"col{r}"), *args], "deterministic": True}
            for r in range(MH_PARTS)], world=True)
        one = launch_workers("column one process", [
            {"argv": ["--device", ",".join(["cuda:0"] * MH_PARTS), *csv("col_one"), *ck("col_one"), *args],
             "deterministic": True}], world=False)[0]
        route = staged_route("column", two)
        want = epoch_lines(one["stderr"])
        if len(want) != MH2_EPOCHS or not all(math.isfinite(float(e[0])) for e in want):
            raise AssertionError(f"column one process: epoch lines {want}")
        for r, w in enumerate(two):
            if cols(epoch_lines(w["stderr"])) != cols(want):
                raise AssertionError(f"column worker {r}: {cols(epoch_lines(w['stderr']))} != one process's"
                                     f" {cols(want)} (both under deterministic algorithms)")
            if any(w["launches"].values()):
                raise AssertionError(f"column worker {r} launched a kernel of the port: {w['launches']}")
        got, ref = (np.load(os.path.join(dirs["root"], f"ck_{t}.npz")) for t in ("col0", "col_one"))
        shapes = [got[k].shape for k in got.files if got[k].ndim == 2 and got[k].shape[0] > 1][:3]
        if got.files != ref.files or not all(np.array_equal(got[k], ref[k]) for k in got.files):
            raise AssertionError("column: process 0's checkpoint differs from the one-process run's")
        if shapes != list(zip(MH2_COL_SIZES, MH2_COL_SIZES[1:])):
            raise AssertionError(f"column checkpoint W shapes {shapes}, want the full rounded arrays")
        if os.path.exists(os.path.join(dirs["root"], "ck_col1.npz")):
            raise AssertionError("column: process 1 wrote a checkpoint")
        log(f"  {route}")
        log(f"  column -P {MH_PARTS} -R 0 (sizes {MH2_COL_SIZES}, COO engine, deterministic index_add_): losses"
            f" {[e[0] for e in want]}, both processes bit for bit with one process; process 0's checkpoint equal"
            f" to the one process's, W {shapes}")
        log_workers("column", two, one, smi)
        return rows
    finally:
        shutil.rmtree(dirs["root"], ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mg_gcn_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("[1] device")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {smi}")
    log(f"  torch: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("[2] build")
    built = _build.build_all()
    for name, (seconds, compiler_log) in built.items():
        log(f"  {name}: built in {seconds:.1f} s")
        log("  " + "\n  ".join(line for line in compiler_log.splitlines() if "ptxas" in line or "spill" in line))
    if not built:
        log("  kernels already built")
    from mg_gcn_tpu_torch import native

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the host library (mg_gcn_tpu_torch/csrc/host/mggcn_host.cpp) did not build or load")
    log(f"  host library {os.path.basename(native.library_path())}: ready in {time.perf_counter() - t0:.1f} s,"
        f" {native.num_threads()} OpenMP threads")

    t_phase = [time.perf_counter()]

    def phase(title: str) -> None:
        now = time.perf_counter()
        log(f"  ({now - t_phase[0]:.1f} s)")
        t_phase[0] = now
        log(title)

    phase(f"[3] kernels vs plain, n = {N_SMALL}")
    phase_kernels_small()
    phase_csr_kernels_small()
    phase_csr_walk_small()
    phase_attention_kernels_small()
    phase_block_kernels_small()
    phase_block_layers_small()
    phase_gather_halo_small()
    phase_normalize_on_card_small()
    phase_f64_small()

    phase(f"[4] main path, n = {N_MAIN}")
    ds = main_dataset()
    main_path = phase_main_path(ds)
    bf16 = main_path["bf16"]
    for e, (loss, acc, s) in enumerate(zip(bf16["losses"], bf16["accs"], bf16["epoch_seconds"])):
        log(f"  bf16 epoch {e} {loss} {acc} {s}")

    phase("[5] pattern kernels at the main-path shape")
    kernels, main_pair = phase_kernels_main(ds, main_path["launches"])
    pack = main_pair[0].pack
    torch.cuda.empty_cache()

    phase(f"[5a] SAGE path: BASELINE config 4, sizes {SAGE_SIZES}, on the main pack")
    sage_path = phase_sage_path(ds, pack)
    torch.cuda.empty_cache()

    phase("[5b] pattern kernels at the SAGE path's shape")
    kernels += phase_sage_kernels(ds, pack, sage_path["launches"])

    phase(f"[5s] multi-epoch step (make_scan_train_steps), replayed against eager: the main path in bf16, int8"
          f" and float32, SAGE in bf16, n = {N_MAIN}")
    phase_scan_main(ds, main_pair)
    del main_pair

    phase(f"[5c] PageRank at Reddit scale on the main pack, n = {N_MAIN}")
    rows, pr_single = phase_pagerank_reddit(ds, pack)
    kernels += rows
    del pack
    torch.cuda.empty_cache()  # the 6.8 GB pack goes before the O(nnz) paths

    phase(f"[5d] row-partitioned PageRank: -P {DIST_PARTS} on one card, n = {N_MAIN}")
    phase_pagerank_dist(ds, pr_single)
    del pr_single
    torch.cuda.empty_cache()

    phase(f"[5e] SAGE at -P {DIST_PARTS} on one card: sizes {SAGE_SIZES}, --impl halo and gather, n = {N_MAIN}")
    phase_sage_dist(ds)
    torch.cuda.empty_cache()

    phase(f"[5f] phase timing of the main path's bfloat16 step, n = {N_MAIN}")
    phase_main_path_phases(ds, kernels)

    phase(f"[5g] the main path on impl='auto': the binary CSR walk, n = {N_MAIN}")
    auto_path = phase_main_auto_path(ds, main_path["bf16"])

    phase("[5h] gather kernel at the main path's shape")
    kernels += phase_gather_main(auto_path.pop("fwd"), auto_path["launches"], "main path",
                                 (("bfloat16", 128), ("bfloat16", 41)))
    torch.cuda.empty_cache()

    phase(f"[6] dist path: -P {DIST_PARTS} -R 1 on one card, n = {N_MAIN}")
    dist_path = phase_dist_path(ds)
    torch.cuda.empty_cache()

    phase("[7] ring kernels at the dist path's shape")
    kernels += phase_ring_kernels(ds, dist_path.pop("pair"), dist_path["launches"])
    torch.cuda.empty_cache()  # the 15.1 GB of ring packs go before the banded path

    phase(f"[6a] column path: -P {DIST_PARTS} -R 0 on one card, sizes {COL_SIZES}, n = {N_MAIN}")
    phase_col_path(ds)
    torch.cuda.empty_cache()

    phase(f"[8] banded path: bench.py's block-banded graph on the block pair, n = {N_MAIN}")
    ds_band = banded_dataset(ds)
    band = phase_banded_path(ds_band)
    phase_banded_f32_witness(ds_band)
    phase_engines_binary(ds_band, "block", band["bf16_epoch_s_median"],
                         runs=(("pattern", "bfloat16"), ("edge", "bfloat16")))

    phase("[9] block kernels at the banded path's shape")
    kernels += phase_block_kernels_main(ds_band, band.pop("fwd"), band["launches"])
    del ds_band
    torch.cuda.empty_cache()

    phase(f"[10] ELL path: impl='pallas' on random_graph({N_SMALL}, {DEG_SMALL}, seed=3)")
    kernels += phase_ell_path(ds)
    torch.cuda.empty_cache()

    phase(f"[11] GAT: one float32 step on the card against the CPU, n = {N_SMALL}")
    phase_gat_card_vs_cpu()

    phase(f"[12] GAT path, n = {N_MAIN}")
    gat_path = phase_gat_path(ds)

    phase("[13] attention kernels at the GAT path's shape")
    gat_graph = gat_path.pop("graph")
    kernels += phase_gat_kernels(gat_graph, gat_path["launches"])
    phase_gat_softmax(gat_graph, gat_path["launches"])
    torch.cuda.empty_cache()

    phase(f"[13s] multi-epoch step, replayed against eager: the GAT path, n = {N_MAIN}")
    phase_scan_gat(ds, gat_graph)
    del gat_graph

    phase(f"[12a] GAT path at -P {DIST_PARTS} on one card, n = {N_MAIN}")
    dist_gat_path = phase_dist_gat_path(ds)

    phase("[13a] attention kernels at the -P 4 GAT path's ring blocks")
    kernels += phase_dist_gat_kernels(dist_gat_path.pop("graph"), dist_gat_path["launches"])
    torch.cuda.empty_cache()
    mh_dirs = write_main_datasets(ds, os.path.join(ROOT, "chiprun_out", "multihost_gat_col"))  # for phase 20

    phase("[14] path A: weighted Reddit on the edge engine")
    from mg_gcn_tpu_torch.ops.spmm_edges import expected_fill

    ds_a = path_a_dataset(ds)
    del ds
    g = ds_a.graph
    log(f"  expected edge-tile fill {expected_fill(g.nrows, g.ncols, g.nnz):.4f}")
    path_a = drive_path("edge", ds_a, HIDDEN, [("bfloat16", EPOCHS), ("int8", 1)])
    expect_launches(path_a["launches"], {("edge", "float32"): 5, ("edge", "bfloat16"): 5 * EPOCHS,
                                         ("edge_i8", "int8"): 5})
    del ds_a, g

    phase("[15] edge kernels at path A's shape")
    kernels += phase_edge_main(path_a.pop("fwd"), path_a["launches"])
    torch.cuda.empty_cache()

    phase(f"[16] path B: products scale on the gather engine, n = {N_PROD}")
    ds_b = path_b_dataset()
    path_b = drive_path("gather", ds_b, HIDDEN_PROD, [("float32", EPOCHS)], phases=True)
    if path_b["fwd"].has_w:
        raise AssertionError("impl='auto' built a weighted gather pair for a binary graph")
    expect_launches(path_b["launches"], {("gather", "float32"): 5 * (1 + 1 + PHASE_EPOCHS + EPOCHS)})
    graph_b = ds_b.graph

    phase(f"[16a] BASELINE config 2 at -P {DIST_PARTS} on one card: the halo pair and the gather ring,"
          f" n = {N_PROD_DIST}")
    products_dist = phase_products_dist(ds_b)
    del ds_b

    phase("[17] gather kernel at path B's shape and at the -P 4 halo blocks'")
    fwd_b = path_b.pop("fwd")
    rows = phase_gather_main(fwd_b, path_b["launches"], "path B",
                             (("float32", 256), ("float32", 100), ("float32", 48), ("bfloat16", 256)))
    cross_engine("path B's Aᵀ (gather regime)", fwd_b, None, rows)
    kernels += [r for r in rows if r["dtype"] == "float32"]  # the path's own mode; the stream row is logged only
    kernels += phase_halo_gather_kernels(products_dist.pop("pair"), products_dist["halo_gather"]["launches"])
    torch.cuda.empty_cache()

    phase(f"[17a] PageRank at products scale on path B's gather matrix, n = {N_PROD}")
    kernels += phase_pagerank_products(fwd_b, graph_b)
    del fwd_b, graph_b
    torch.cuda.empty_cache()

    phase("[18] CLI")
    phase_cli()

    phase(f"[19] multi-process halo: BASELINE config 3's widths at -P {MH_PARTS} across {MH_PARTS} processes on"
          f" cuda:0, n = {MH_N}")
    kernels += phase_multihost(smi)

    phase(f"[20] GAT (-R 1) and the column path (-R 0) at -P {MH_PARTS} across {MH_PARTS} processes on cuda:0,"
          f" n = {N_MAIN}")
    kernels += phase_multihost_gat_col(smi, mh_dirs)
    phase("done")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(json.loads(sys.argv[2])))
    if sys.argv[1:] == ["--nccl-check"]:
        sys.exit(nccl_check())
    sys.exit(main())
