"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code is
not 0:

1. environment: card name and power limit, torch / CUDA / nvcc versions,
   whether triton imports; TF32 off for matrix products and cuDNN;
2. build: the kernels of ``hspose_tpu_torch/csrc`` with nvcc (sm_90a), and
   the registers, shared memory and spills ptxas reports for K1's to K4's
   kernels, K11's projection tile and reduction, K13's and K14's rows,
   reduction and recompute kernels, K8's dg rows and drf walks, K12's
   and K15's kernels, K10's, K16's / K17's and K18's, and K9's three
   (``PTXAS_KERNELS``);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at every shape the B=24, N=1028 forward gives it, with kernel and plain
   times from CUDA events; K1's nine searches are also kept one by one
   (``searches``), K4's five layers likewise (``layers``), each beside its
   bound, and K3's two launches are timed apart (``parts``: the
   projection with its bound and a library product as yardstick, the
   reduction with its bound);
4. slice: ``PoseNet9D`` at full width with seeded random weights serves a few
   (24, 1028, 3) requests through ``eval_forward`` and ``generate_RT``; the
   launch counters must show 9 KNN, 1 surface, 4 support and 5 ORL launches
   and 1 heads epilogue per forward, the poses must be finite and orthonormal, and the same
   weights, input and pooling samples through the plain ops on the CPU must
   agree within 1e-3;
5. throughput: crops/s at B=24, fp32, best of 3 windows;
6. bf16 kernels: the packed-key KNN and the bf16 surface, support and ORL
   kernels against their plain versions on the card at every shape the
   B=24 bf16 forward gives them (KNN: >= 99.9% of the neighbours shared and
   swapped neighbours within 2^-10 relative distance; the reductions within
   1e-4 of the largest value), with kernel and plain times, the nine
   searches, K4's five layers and K3's parts kept as in phase 3;
7. bf16 slice: the same model built with ``compute_dtype="bfloat16"``
   serves the same requests; the launch counters must show 9 packed-key
   KNN, no exact KNN, 1 surface, 4 support and 5 ORL bf16 launches, 1 bf16
   heads epilogue and no fp32 HS launch per forward, the poses must be finite and orthonormal,
   the plain ops on the CPU must agree within 3e-2, and the deviation from
   the fp32 tier is printed; then crops/s at B=24 in bf16, best of 3;
8. training kernels: K12, K15, K11 and K13 against their plain versions at
   every shape of the B=16, N=1028 train step: forwards within 1e-4 of the
   largest value, winners equal on >= 99.9% of entries and near-ties where
   not; backwards fed the same residuals as their plain versions, every
   cotangent within 1e-4 of its largest value; kernel and plain times;
   K12 and K15 also per launch (``parts``: K12's reduction; K15's routing
   with its drf walk and dd tile partials, and the partial sum, each with
   its bound, timed by torch.profiler); K13 also per layer (``layers``) and
   per launch (``parts``: rows, reduction, partial sum, each with its
   bound), with at most one launch of each per call; K11 (fed the source rows
   ``feat`` and index ``idx`` that g gathers, g formed as their gather) per
   layer and per launch (``parts``: the projection of the source rows with
   its bound and a library product as yardstick, the gather-reduction with
   its bound), with the bound of the design it replaced
   (``bound_gathered_ms``: every gathered row projected);
9. training slice: ``build_train_step`` at full width takes 3 steps on a
   (16, 1028) synthetic batch; the launch counters must show 9 KNN, 1 + 1
   surface and 4 + 4 support training launches per step and no serving
   launch, the losses must be finite, the parameters move and the optimizer
   count advance; one train forward and backward at B=4 on the card and on
   the CPU plain ops, with the same weights, batch and draws, must agree
   (losses within 1e-3 relative, parameter gradients within the N=1028
   gates of tests/test_torch_parity.py); then steps/s at B=16;
10. bf16 training kernels: the bf16 instantiations of K12, K15, K11 and K13
   against their plain versions (which make the same bf16 roundings) at
   every shape of the B=16 bf16 train step: fp32 outputs within 1e-4 of
   the largest value, winners as in phase 8, and the bf16 cotangents
   (drf, dg, dd) within one bf16 ulp of each element plus 1e-4 of the
   largest (the fp32 sums differ in order, which can move a rounding to
   bf16 by one ulp); K12's and K15's ``parts``, K13's ``layers`` and
   ``parts`` as in phase 8;
11. bf16 training slice: ``build_train_step`` on ``compute_dtype="bfloat16"``
   takes 3 steps at (16, 1028); the counters must show 9 packed-key KNN and
   1 + 1 surface and 4 + 4 support bf16 training launches per step, nothing
   else (no exact KNN, no fp32 training kernel, no serving kernel); finite
   losses, moved parameters; one bf16 train forward and backward at B=4 on
   the card against the CPU plain ops, gated by ``SPREAD_MULT`` times the
   card's own spread (the card against itself with the input cloud moved by
   1e-6 relative), both printed; then bf16 steps/s beside the fp32 steps/s;
12. v4 training kernels: K11 without winner values and K14 (``bwd_store=False``)
   at the four HS layers' shapes of the B=16 step, the fused ops' forwards
   with winners (K2, K3, K4) and their backwards (K9 at conv_0's shape, K8
   at conv_2..conv_4's, K10 at their ORL branches') against their plain
   versions, with phase 8's gates; K14 against K13 on the same inputs; the
   forwards with winners against the serving kernels and every backward
   against a second launch, bit for bit; then one autograd backward through
   ``hs_surface_fused``, K9's carrier (no model path reaches K9), which must
   launch one K2 with winners and one K9; K14 per layer and per launch
   (recompute, rows, reduction, partial sum) as K13 in phase 8; K11 without
   values per layer and per launch as in phase 8; K8 per layer and per
   launch (inverse lists, route, drf walk, dd partial sums, the source-row
   scatter, dverts, the two partial sums, and dfeat's and dW's products,
   each beside one library product, or in the bf16 tier the dg rows and
   their source-row sums for dfeat); K10 per launch (``parts``): one
   kernel, at most one launch a call, no inverse lists; K9 per launch
   (``parts``: the fused route / drf / dd kernel, the partial sum, dverts;
   three launches a call, no inverse lists) at conv_0, and against its
   plain version and a second launch, bit for bit, at (N, K, S, Co) =
   (2056, 20, 7, 128), (1001, 5, 3, 64), (257, 31, 9, 96) and (5000, 12,
   10, 32), B=4 (``K9_SHAPES``: K up to 31, S*Co not a multiple of 32, a
   dverts window short of a batch's N*K entries);
13. v4 training slice: ``build_train_step`` on ``ModelConfig(bwd_store=False,
   train_v4_small=True)`` takes 3 steps at (16, 1028); the counters must show
   9 KNN, 1 + 1 K12/K15, 1 K11 without winner values + 1 K14, 3 K3 with
   winners + 3 K8 and 3 K4 with winners + 3 K10 per step and nothing else
   (no K13, no serving launch, no bf16 launch); finite losses, moved
   parameters; one train forward and backward at B=4 on the card against
   the CPU plain ops with phase 9's gates; then its steps/s beside phase 9's;
14. bf16 v4 training kernels: phase 12 on the bf16 instantiations (bf16
   features, rf and directions as the bf16 step forms them): K11 without
   winner values and K14 at conv_1..conv_4, K14 bit for bit against K13
   bf16; K2/K3/K4 with winners bit for bit against the bf16 serving
   kernels; K9 at conv_0's shape, K8 at conv_2..conv_4's and K10 at their
   ORL branches' against their plain versions with phase 10's gates; every
   backward twice, bit for bit; K9 per launch and at ``K9_SHAPES`` as in
   phase 12; one autograd backward through a bf16 ``hs_surface_fused``
   (K9's carrier);
15. bf16 v4 training slice: phase 13 on ``ModelConfig(compute_dtype=
   "bfloat16", bwd_store=False, train_v4_small=True)``: 9 packed KNN, 1 + 1
   K12/K15 bf16, 1 K11 bf16 without winner values + 1 K14 bf16, 3 + 3
   K3/K8 bf16 and 3 + 3 K4/K10 bf16 per step and nothing else; finite
   losses, moved parameters; card against CPU within ``SPREAD_MULT`` times
   the card's own spread, as phase 11; steps/s beside phase 11's;
16. each training flag alone, in both tiers: one train forward and backward
   at (16, 1028) with its exact launch counts (``bwd_store=False``: 4 K11
   without winner values + 4 K14, no K13; ``train_v4_small=True``: 1 K11 +
   1 K13 at conv_1 and 3 + 3 K3/K8 and K4/K10), finite losses and
   gradients;
17. chamfer kernels: K16 (minimum), K17 (minimum and argmin) and K18 (the
   gradient for one cloud) against their plain versions at the recon tier's
   shape (24, 1028) x (24, 1028), at (24, 1028) x (24, 700) and on a cloud
   with duplicated points: distances within 1e-5 of the largest distance or
   squared norm of a query point (the scale of the expansion's rounding,
   all there is where the clouds coincide), argmins
   equal on >= 99.9% and within 1e-6 in exact distance where not, gradients
   within 1e-4 of the largest, K18 twice bit for bit; K18 also at (4, 5000)
   x (4, 300) (long lists) and where every point of b, 3000 of them, shares
   one nearest point of a (a tile's list over two windows); K16, K17 and
   K18 per launch (``parts``; K18 one launch a call, no inverse lists) at
   the recon shape; then one autograd call of ``chamfer_distance`` (2 K17,
   2 K18);
18. eval harness: ``batched_pose_inference`` on in-memory records (3
   batches of 24 crops of 1028 points; no PNG, cv2 or matplotlib) in fp32,
   bf16, and fp32 with ``eval.recon`` on a model with the train heads:
   exact launch counts per batch (recon: 2 K16, no K17/K18), the fp32 poses
   bit for bit those of ``eval_forward`` + ``generate_RT`` on the same
   crops and pool samples and the recon run's those of the fp32 run,
   chamfer and EMD finite and positive, then
   ``compute_degree_cm_mAP``; crops/s over 20 batches beside the forward
   alone's (phases 5 and 7), and the recon tier's chamfer and EMD ms per
   batch;
19. K5: the exact KNN above N = 2048 (the JAX package's streamed kernel)
   against its plain version at N = 2056 and 4096 (xyz k=20 and k=4,
   features k=20 in fp32 and bf16), with times, and one fp32 harness batch
   at ``data.num_points=2056``: 3 streamed and 6 other KNN launches;
20. K2, K4 and K10 off the forward's shapes, fp32 and bf16, so that each
   branch of their launches runs: K4 at the N = 2056 harness forward's five
   ORL shapes (B=24), at B=4 N=2056, N=5000, K=5 and on an index tensor off
   16-byte alignment; K2 at S, K and Co other than 7, 20 and 128; each
   against its plain version within 1e-4 of the largest value, the
   forwards with winners bit for bit the serving kernels' and their
   winners as in phase 8; K4 must refuse features off 16-byte alignment;
   K10 at (N, C, K) = (1028, 128, 20), (2056, 64, 20), (5000, 48, 5), (257,
   50, 20), (20000, 32, 8) and (33, 36, 7) on random winners, against its
   plain version with phase 12's gates and twice bit for bit;
21. K11, K13 and K14 off the step's shapes, fp32 and bf16, so that each
   branch of their launches runs: (K, Cin, Co, S) = (5, 132, 128, 3), (31,
   128, 512, 7) and (20, 256, 256, 9) at B=3, N=1001 (every template width
   of K, Cin beyond one 128-channel block, column tiles of other widths, a
   row count that is a multiple of no tile): K11 against its plain version
   at phase 8's gates, twice with the same bits, its no-values launch bit
   for bit its stored one; K13 against its plain version at phase 8's gates
   (phase 10's in bf16), K14 bit for bit K13 on the forward's stored
   values, each launched twice with the same bits; and K12 and K15 at
   (K, S, Co) = (5, 3, 64), (31, 9, 128) and (12, 10, 96), B=3, N=1001 (K
   and S read at run time, a part-full last block and tile), against
   their plain versions at phase 8's gates (phase 10's in bf16), each
   launched twice with the same bits;
22. the relaxed-KNN serving tier (``serve_k=16``, the kernels' generic-K
   branches) in fp32 and bf16: phase 4's and 7's launch counts, poses and
   card-against-CPU gates on the same seeded weights;
23. the train loop: ``hspose_tpu_torch/tools/make_synth_nocs.py`` renders a
   tree of 24 train and 4 test images into a temporary directory; the train
   entry point (``engine/train.py::train``, the spawned worker pool, fp32)
   takes 2 epochs of 3 steps at B=16, N=1028 with a checkpoint each epoch,
   its counters exactly ``TRAIN_LAUNCHES["float32"]`` per step, its decode
   path numpy and recorded in the checkpoints' ``meta.json``; epoch 0's
   checkpoint restored into a fresh model and step gives every saved tensor
   and count back bit for bit; the run resumed from it repeats epoch 1's
   losses within ``RESUME_LOSS_REL`` (the card's backward adds with float
   atomics, so bits need not repeat); the eval CLI's ``evaluate`` on the
   test split from the last checkpoint, decoding the PNGs in numpy (the
   card's machine has no libpng; the phase asserts that path), with
   ``SERVE_LAUNCHES["float32"]`` per padded batch; cv2 never imported; the
   loader's samples/s and the loop's steps/s printed;
24. the probes (``hspose_tpu_torch/tools/fast_mode_parity.py``,
   ``train_sanity.py``) on seeded weights: one B=256 ``predict`` batch of
   the mAP study's held-out crops in fp32, bf16 and bf16 + ``serve_k=16``,
   each with exactly ``SERVE_LAUNCHES`` of its tier for the one forward,
   finite poses and sizes, its first ``PROBE_CPU_CROPS`` crops against the
   same weights and pools through the plain ops on the CPU (``SLICE_ATOL``,
   in bf16 ``SLICE_ATOL_BF16``: in eval mode each crop is served alone),
   and ``assemble`` giving a finite table; then ``PROBE_STEPS`` steps of
   the sanity recipe in each training route (default, ``bwd_store=False``,
   ``bwd_store=False, train_v4_small=True``, each in fp32 and bf16) with
   ``pose_errors`` between the two halves: each half exactly
   ``TRAIN_LAUNCHES`` of the route per step, the eval forward exactly
   ``SERVE_LAUNCHES`` of its tier, the model back in train mode after it,
   every loss finite and no step skipped.
25. device sampling (``data.sample_mode=device``, ``eval.sample_mode=
   device``) on phase 23's tree: ``data/preprocess.py::roi_to_pointcloud``
   on the card against the CPU with the same scores, bit for bit, on a B=24
   eval batch and a B=16 train batch of the tree's crops, each with one
   crop of fewer valid pixels than ``N`` and one of none (its ms per batch
   printed); the train entry point in device mode, 1 epoch of 3 fp32 steps
   at B=16, N=1028 with the spawned pool, exactly ``TRAIN_LAUNCHES
   ["float32"]`` per step and finite losses, its loader samples/s beside
   phase 23's host-mode figures; the eval CLI's ``evaluate`` in device mode
   on its checkpoint with ``SERVE_LAUNCHES["float32"]`` per padded batch;
   then the harness's crops/s at B=24 in device and in host mode on the
   same test images (``DEVICE_RATE_BATCHES`` batches, exact launch counts);
   cv2 never imported.
26. multi-GPU serving (``parallel.sp``, ``parallel.dp``): the query-sharded
   branches of K1 (and K5's range), K2, K3 and K4 at the shard shapes of the
   N = 4096, B = 8 forward for sp = 2 and 4, in both tiers, each against its
   plain version with phase 3's and 6's gates and against the single-source
   launch on the gathered cloud (K1's indices, K2's and K3's outputs bit for
   bit its rows; K4's shard means recombined within ``ORL_RECOMBINE``),
   timed with their bounds at the sp = 2 shapes; two ranks sharing the card
   over an explicit gloo group (``sp_rank``; NCCL takes one rank per device
   and the rig has one card) serve the sp = 2 forward at N = 4096, B = 8 in
   both tiers: exactly ``SP_LAUNCHES`` query-sharded launches per rank per
   forward and nothing else, the outputs the same on both ranks, the poses
   and sizes within ``SLICE_ATOL`` (bf16 ``SLICE_ATOL_BF16``) of the
   one-process card forward, and the crops/s of the two ranks (not a
   multi-GPU rate); gloo takes the ranks' CUDA tensors as they are, exactly;
   where the sp forward parts from the one-process one (``sp_probe``): the
   forward again with the one-process centre, then with the one-process
   centre and ORL means, each search's differing rows and map gap printed,
   the bf16 tier then bit for bit the one-process forward and the fp32 tier
   reading the one-process maps at its first ``SP_EXACT_SEARCHES`` searches,
   and each point-row product's gap between all rows and a shard's
   (``row_split_gaps``); the same ranks run the harness with ``parallel.dp=2``
   against the one-process harness; then the eval CLI under ``torchrun
   --standalone --nproc_per_node=<device count>`` with nccl on phase 23's
   checkpoint and tree gives phase 23's pred_result.pkl.
27. multi-GPU training (``parallel.dp``, ``parallel.mp``): the ranks of
   each of ``DP_JOBS`` share the card over an explicit gloo group
   (``dp_rank``) and train from one set of weights on global batches of
   (16, 1028) with the draws pinned: two ranks run dp = 2 (8 rows a rank)
   for ``DP_STEPS`` fp32 and bf16 steps and one step of ``bwd_store=False,
   train_v4_small=True``, and mp = 2 for one fp32 step; four ranks run dp =
   4 (4 rows a rank) and dp = 2 x mp = 2 for one fp32 step each.  Each rank
   launches exactly ``TRAIN_LAUNCHES`` of its route per step (the
   one-process step's at its own rows), all ranks' parameters, BatchNorm
   buffers and Ranger state are bit for bit equal after every step, and
   each step (from the run's checkpoint before it) is read against the
   one-process step on the card from that checkpoint on the same global
   batch and draws (``step_readings``: each loss term relative, the loss as
   a share of the total, BatchNorm, the gradient's 1 - cosine, per leaf its
   1 - cosine and norm ratio, and Ranger's first moment, the update before
   rounding): fp32 dp steps within ``DP_GATES`` (dp = 4: ``DP4_GATES``), the
   mp step within the tighter ``MP_GATES``, bf16 within ``SPREAD_MULT`` x the card's own spread
   (the one-process step with the clouds moved by ``SPREAD_EPS``), which is
   every fp32 step's second witness; the fp32 dp = 2, dp = 4 and mp = 2
   runs' checkpoints restore in one process bit for bit; the dp steps/s of
   the two ranks (not a multi-GPU rate); the harness with
   ``parallel.mp=2`` within ``MP_RT_ATOL`` / ``MP_S_ATOL`` of the
   one-process harness on the concatenated route (which mp takes); then the
   train CLI under ``torchrun --standalone
   --nproc_per_node=<device count>`` with nccl on phase 23's tree and
   recipe (with one card, phase 23's losses bit for bit), its epoch-0
   checkpoint resumed by the one-process train CLI within
   ``RESUME_LOSS_REL`` and its last served by the one-process eval CLI.
28. the serving heads' first block (``models/heads.py::FirstLayers``) at
   B = 96, N = 1028, the serving cells' batch, in both tiers: the epilogue
   kernel (``csrc/heads_epilogue.cu``) against its plain version (fp32
   within ``TOL_REL`` of the largest value, bf16 within one bf16 ulp of each
   element) with its time beside its bound, the three products per
   backbone resolution beside the three 1286-K conv1 products of the
   concatenated route, the whole block both ways, and the B = 96
   ``eval_forward`` both ways with its largest pose gap.  It also runs
   alone: ``python3 chip_smoke.py --phase heads``.  The block's gap between
   the routes must stay within the CPU test's bounds
   (tests/test_torch_port_heads_factored.py: fp32 ``FP32_REL`` of each
   head's largest value against the concatenated route; bf16 per element
   one ulp of every rounding the sums went through, carried by bn1's scale,
   plus one of the output, and half an ulp more at the factored sum's
   rounding and at the output for a value that rounds into the binade
   above, against that test's reference, conv1 as fp32 sums of its bf16
   products rounded once, the gap to cuBLAS's bf16 products printed beside
   it), and
   the forward's pose gap within ``FP32_REL`` (fp32) or ``FORWARD_ATOL``
   (bf16; tests/test_torch_port_bf16.py).
29. the served forward as one CUDA graph replay (``models/graphed.py``)
   against the eager route, in both tiers at B = 96 and 24, N = 1028: the
   poses of both routes (bit for bit, or the largest gap within phase 28's
   pose bounds), the capture's time, two replays' outputs unaliased, a
   recapture after ``load_state_dict`` serving the new weights in place of
   the old weights' graph, host and
   wall time a forward on each route, and the kernels that a profiler
   session started after the capture sees (every eager kernel, the serving
   kernels ``SERVE_LAUNCHES`` names, device time within
   ``GRAPH_DEVICE_REL``); then the harness (pinned uploads, graph replays)
   against the harness on the eager route (``eager_route``).  It also runs
   alone: ``python3 chip_smoke.py --phase graph``.
30. the train step's forward, losses and backward as one CUDA graph replay
   (``engine/graphed_step.py``) against the eager route (``eager_step``),
   in both tiers at B = 24, N = 1028, from one set of weights and one
   generator seed on each route and on both routes again (the controls):
   ``STEP_GRAPH_STEPS`` finite steps (past RAdam's switch and the first
   lookahead) with a batch of NaN mean shapes (finite clouds, no bowl or
   mug) after ``STEP_GRAPH_POISON`` of them, every step's metrics and the
   parameters, BatchNorm statistics and Ranger's state after them bit for
   bit (bf16, whose eager step does not repeat its bits run to run: the
   metrics, and the state within ``STEP_GRAPH_BF16_REL`` or the gap a route
   shows against itself in the phase); the NaN step skipped with nothing
   moved on every route and the next step replayed; the capturing step's
   time; the kernels a profiler session started after the capture sees on
   each route (the port's kernels by name the same on both, 9 KNN searches
   a step; PyTorch's and the libraries' printed); host and wall time a step
   on each route, and the state of both routes bit for bit after those
   steps too (fp32).  It also runs alone:
   ``python3 chip_smoke.py --phase train-graph``.

A served forward on the card is a graph replay, which calls no op wrapper:
the phases that count a served path's launches (5-7, 18, 19, 23-26) count
its kernels by name in a ``torch.profiler`` session around it (``served``,
``check_served``): one ``hspose.model.graph_replay`` span a forward, the
kernels of ``SERVE_LAUNCHES`` (``KERNEL_NAMES``, ``LAUNCH_KERNELS``) once a
forward and once for each of a capture's ``WARMUP`` eager forwards, and the
wrappers' counters at those of the captures' eager forwards alone.  The
slice and harness phases capture before the session, so that every kernel
counted ran in a replay.  The eager paths (``eval.recon``, sp, mp, dp and
mp training, device sampling) keep the wrappers' counters.  So does a
train step on a batch of clouds on the card, whose first step is eager and
whose second captures its graph: the phases that count such steps' launches
(9, 11, 23, 24) count the wrappers' calls of their eager steps and
captures (``wrapper_steps``), and phase 30 counts the replays' kernels by
name.

``python3 chip_smoke.py --phase <name> ...`` runs only the named phases, in
order, after the environment and the build: ``heads`` (28), ``graph`` (29),
``train-graph`` (30), ``harness`` (18) and ``sp-forward`` (26's two-rank
forward).

Each kernel's ``bound_ms`` is the least time the card could take for its
calls: per call the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and its multiply-adds (2 operations
each) over the peak rate of their operand type (67 TFLOP/s fp32 outside the
tensor cores, 989 TFLOP/s bf16), summed over the calls of one pass;
``bound_by`` names the larger part.  K16's and K17's ``library_ms`` is
``torch.cdist(a, b).pow(2).min(-1)`` over both directions, a reference the
port never calls; no single PyTorch call computes the other functions (the
backwards are winner- or argmin-routed scatters), so theirs is null.  K3's
projection alone has one: ``parts.project.library_ms`` is ``torch.addmm(b,
feat, W)`` in fp32 with TF32 off, ``torch.matmul`` on bf16 operands in the
bf16 tier, neither called by the port; so has K11's (the same calls on its
source rows), and K8's two products (``torch.matmul`` of the same shapes,
fp32, TF32 off).  K11's, K13's, K14's and K8's ``parts`` are their launches
timed apart, each with the bound of its own inputs and outputs; K11's
``bound_ms`` is the least work of the function (the source rows projected
once), ``bound_gathered_ms`` that of the design it replaced.
K12's and K15's ``parts`` likewise.
``launches`` is each kernel's count in the main run of its path: phases 4,
7, 9, 11, 13 and 15, for K2 with winners and K9 the autograd call of phases
12 and 14, for K16 the recon harness run, for K17 and K18 the autograd call
of phase 17, for K5 the N = 2056 harness batch, and for the query-sharded
branches rank 0's sp = 2 forward of phase 26.

The line before the last is one JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import re
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

B, N = 24, 1028  # the serving batch and points per crop
DEVICE = "cuda"
REQUESTS = 3
TOL_REL = 1e-4  # K2-K4: max |kernel - plain| <= TOL_REL * max |plain| (summation order)
KNN_AGREE = 0.999  # K1: share of kernel neighbours in the plain version's set
KNN_TIE_REL = 1e-5  # K1: sorted neighbour distances agree to this (fp32 near-ties)
SLICE_ATOL = 1e-3  # card against CPU on the pose outputs
KNN_SWAP_REL = 2.0 ** -10  # packed-key KNN: distance gap of a swapped neighbour
SLICE_ATOL_BF16 = 3e-2  # bf16 tier, card against CPU on the pose outputs
SEED = 0
SERVE_K_RELAXED = 16  # phase 22: the relaxed-KNN serving tier's neighbour count
TRAIN_B = 16  # the train batch (train.batch_size)
TRAIN_STEPS = 3
WIN_AGREE = 0.999  # K11, K12: share of winners equal to the plain version's
LOSS_REL = 1e-3  # card against CPU, each loss term
GRAD_LEAF = (0.98, 0.2, 0.9, 1.1)  # per leaf: min cos, max norm_rel, norm ratio range
GRAD_COS = 0.9995  # all parameter gradients as one vector
ZERO_LEAF = 1e-5  # a leaf gradient below this share of the largest is rounding noise
SPREAD_MULT = 4.0  # bf16 train step, card against CPU: at most this multiple of the card's spread
SPREAD_EPS = 1e-6  # the relative move of the input cloud that measures the spread
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, per operand type


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


# clock cycles of the sleep kernel that holds the stream while cuda_ms
# enqueues its calls (about 10 ms on an H100)
QUEUE_CYCLES = 20_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up.  A
    sleep kernel ahead of the first event holds the stream while the host
    enqueues the ``iters`` calls, so that a kernel shorter than its
    wrapper's host time (an ORL layer: 5 to 20 us against about 25 us) is timed
    back to back on the device, not at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_env() -> str:
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    log("env", f"card: {smi}")
    log("env", f"torch {torch.__version__}, torch CUDA {torch.version.cuda}, "
               f"python {sys.version.split()[0]}")
    from hspose_tpu_torch.ops import _build

    log("env", "nvcc: " + run([_build._nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton  # noqa: F401
        log("env", f"triton {triton.__version__} imports")
    except ImportError as e:
        log("env", f"triton does not import: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("env", "TF32 off (cuda.matmul, cudnn)")
    return smi


# kernels whose registers, shared memory and spills phase 2 prints: K1's to
# K4's, K11's (the projection tile gemm_kernel, shared with K3's fp32
# projection and K8's products, and support_fwd_kernel), K13's and K14's
# (support_bwd_rows_kernel, support_bwd_reduce_kernel, recompute_kernel),
# K8's rows and drf walks (dg_rows_kernel, rf_grad_kernel), and K12's and
# K15's (surface_fwd_kernel; surface_bwd_kernel, sum_tiles_kernel, which K9
# shares), K10's (orl_bwd_kernel), K16's / K17's (chamfer_min_kernel), K18's
# (chamfer_grad_kernel) and K9's (fused_bwd_kernel, dverts_rows_kernel)
PTXAS_KERNELS = ("knn_kernel", "surface_kernel", "gemm_kernel", "project_bf16_kernel",
                 "reduce_kernel", "orl_kernel", "support_fwd_kernel", "support_bwd_rows_kernel",
                 "recompute_kernel", "dg_rows_kernel", "rf_grad_kernel", "surface_fwd_kernel",
                 "surface_bwd_kernel", "sum_tiles_kernel", "orl_bwd_kernel", "chamfer_min_kernel",
                 "chamfer_grad_kernel", "fused_bwd_kernel", "dverts_rows_kernel")


def ptxas_report(text: str, names=PTXAS_KERNELS) -> list[str]:
    """One line per compiled instantiation of the kernels in ``names`` from
    ptxas' -v output: registers, shared memory, spill stores and loads."""
    rows, fn, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and any(n in fn for n in names):
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((fn, int(m.group(1)), int(smem.group(1)) if smem else 0, *spill))
            fn, spill = None, (0, 0)
    try:  # demangle where binutils is installed
        names_out = run(["c++filt", *[r[0] for r in rows]]).splitlines() if rows else []
    except (OSError, subprocess.CalledProcessError):
        names_out = [r[0] for r in rows]
    return [f"{name}: {regs} registers, {smem} bytes static smem, spill stores {st} B, "
            f"loads {ld} B" for name, (_, regs, smem, st, ld) in zip(names_out, rows)]


def phase_build() -> None:
    from hspose_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    how = ("built" if _build.build_seconds is not None else "found cached")
    report = _build.library_path().with_suffix(".log")
    log("build", f"{how} {_build.library_path().name} in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s; "
                 f"ptxas report in {report.name})")
    if report.exists():
        for line in ptxas_report(report.read_text()):
            log("build", "ptxas " + line)


def cloud(rng, n: int) -> torch.Tensor:
    return cloud_b(rng, B, n)


def cloud_b(rng, b: int, n: int) -> torch.Tensor:
    return torch.from_numpy(rng.normal(scale=0.2, size=(b, n, 3)).astype(np.float32)).to(DEVICE)


def normal(rng, *shape, scale: float = 1.0) -> torch.Tensor:
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(DEVICE)


def unit_dirs(rng, n: int) -> torch.Tensor:
    d = normal(rng, 3, n)
    return d / d.norm(dim=0, keepdim=True)


def bound(tensors, macs: float, dtype, nbytes: float = 0.0) -> tuple[float, str]:
    """(ms, what bounds it) of the least time the card could take for one
    call: the bytes of ``tensors`` (its inputs and outputs, each once) and
    ``nbytes`` more over HBM_BYTES_PER_S, or ``macs`` multiply-adds at the
    peak of ``dtype``."""
    nbytes += sum(t.numel() * t.element_size() for t in tensors)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / PEAK_OPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def record(rec: dict, name: str, err: float, ms: float, plain_ms: float,
           bnd: tuple[float, str]) -> None:
    """Add one call's numbers to a kernel's record: the largest error, and the
    kernel, plain and bound times summed over the calls of one pass of the
    path; ``bound_by`` is whichever part holds most of the bound."""
    r = rec.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                              "bound_by": "", "library_ms": None, "_by": {}})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bound_ms"] += bnd[0]
    r["_by"][bnd[1]] = r["_by"].get(bnd[1], 0.0) + bnd[0]
    r["bound_by"] = max(r["_by"], key=r["_by"].get)


def phase_kernels(dtype: str = "float32") -> dict:
    """Every kernel of one tier against its plain version at the B=24
    forward's shapes: the exact KNN and fp32 HS kernels, or the packed-key
    KNN and the HS kernels' bf16 variants (xyz stays fp32, features are
    bf16).  Returns per-kernel records; ms and plain_ms sum the forward's
    calls."""
    from hspose_tpu_torch.ops.cuda_hs_fused import (
        hs_support_fused, hs_support_plain, hs_surface_fused, hs_surface_plain,
        orl_global_fused, orl_global_plain)
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, knn_indices, knn_indices_packed

    fast = dtype == "bfloat16"
    phase, tag = ("bf16-kernels", "_bf16") if fast else ("kernels", "")
    knn_name, knn_plain = ("knn_packed", knn_indices_packed) if fast else ("knn", knn_indices)
    knn_gap = KNN_SWAP_REL if fast else KNN_TIE_REL
    rng = np.random.default_rng(SEED)
    n1, n2 = N // 4, N // 16
    clouds = {n: cloud(rng, n) for n in (N, n1, n2)}
    rec = {}

    def features(n, c):
        x = normal(rng, B, n, c)
        return x.to(torch.bfloat16) if fast else x

    def knn_cuda(pts, k):
        return knn_indices_cuda(pts, k, packed=fast)

    # the nine searches of one forward, (points, D, k)
    for n, d, k in [(N, 3, 20), (N, 128, 20), (N, 3, 4),
                    (n1, 3, 20), (n1, 128, 20), (n1, 256, 20), (n1, 3, 4),
                    (n2, 3, 8), (n2, 256, 8)]:
        pts = clouds[n] if d == 3 else features(n, d)
        got, want = knn_cuda(pts, k), knn_plain(pts, k)
        torch.cuda.synchronize()
        agree = (got[..., :, None] == want[..., None, :]).any(-1).double().mean().item()
        p64 = pts.double()

        def sorted_d(idx):
            diff = gather_neighbors(p64, idx) - p64[:, :, None]
            return (diff * diff).sum(-1).sort(-1).values

        dg, dw = sorted_d(got), sorted_d(want)
        err = (dg - dw).abs().max().item()
        rel = ((dg - dw).abs() / dw.clamp_min(1e-30)).max().item()
        ms = cuda_ms(lambda: knn_cuda(pts, k))
        pms = cuda_ms(lambda: knn_plain(pts, k))
        log(phase, f"{knn_name} N={n} D={d} {pts.dtype} k={k}: agreement {agree:.6f}, max "
                   f"rel distance gap {rel:.3e}, {ms:.4f} ms (plain {pms:.4f} ms)")
        if agree < KNN_AGREE or rel > knn_gap:
            raise AssertionError(f"{knn_name} N={n} D={d} k={k} disagrees with its plain "
                                 f"version: agreement {agree}, distance gap {rel}")
        bnd = bound([pts, got], B * n * n * d, torch.float32 if d == 3 else pts.dtype)
        record(rec, knn_name, err, ms, pms, bnd)
        rec[knn_name].setdefault("searches", []).append(
            {"N": n, "D": d, "k": k, "ms": ms, "plain_ms": pms, "bound_ms": bnd[0]})

    op_dtype = torch.bfloat16 if fast else torch.float32

    def close(name, label, got, want, ms, pms, tensors, macs):
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        log(phase, f"{name} {label}: max abs err {err:.3e} (bound "
                   f"{TOL_REL * scale:.3e}), {ms:.4f} ms (plain {pms:.4f} ms)")
        if not (err <= TOL_REL * scale and got.dtype == torch.float32):
            raise AssertionError(f"{name} {label}: error {err} > {TOL_REL} * {scale}")
        bnd = bound(tensors + [got], macs, op_dtype)
        record(rec, name, err, ms, pms, bnd)
        return bnd

    S = 7
    # conv_0
    verts, idx = clouds[N], knn_cuda(clouds[N], 20)
    dirs = unit_dirs(rng, S * 128)
    args = (verts, idx, dirs, S, 128)
    close("hs_surface" + tag, f"conv_0 N={N} K=20 Co=128",
          hs_surface_fused(*args, exact=not fast), hs_surface_plain(*args, exact=not fast),
          cuda_ms(lambda: hs_surface_fused(*args, exact=not fast)),
          cuda_ms(lambda: hs_surface_plain(*args, exact=not fast)),
          [verts, idx, dirs], 3 * idx.numel() * S * 128)

    # conv_1 .. conv_4, weights as column slices of the (Cin, (S+1)Co) matrix
    for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, n1, 20),
                                 (3, 256, 256, n1, 20), (4, 256, 512, n2, 8)]:
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w_full = normal(rng, cin, (S + 1) * co, scale=stdv)
        b_full = normal(rng, (S + 1) * co, scale=stdv)
        args = (features(n, cin), clouds[n], knn_cuda(clouds[n], k),
                w_full[:, co:], b_full[co:], unit_dirs(rng, S * co), S, co)
        label = f"conv_{layer} {cin}->{co} N={n} K={k}"
        close("hs_support" + tag, label,
              hs_support_fused(*args), hs_support_plain(*args),
              cuda_ms(lambda: hs_support_fused(*args)),
              cuda_ms(lambda: hs_support_plain(*args)),
              list(args[:6]), B * n * cin * S * co + 3 * args[2].numel() * S * co)
        support_parts(phase, rec["hs_support" + tag], label, args, fast)

    # the ORL branch of each layer
    for layer, c, n, k in [(0, 128, N, 20), (1, 128, N, 20), (2, 256, n1, 20),
                           (3, 256, n1, 20), (4, 512, n2, 8)]:
        feat, idx = features(n, c), knn_cuda(clouds[n], k)
        ms, pms = cuda_ms(lambda: orl_global_fused(feat, idx)), cuda_ms(
            lambda: orl_global_plain(feat, idx))
        bnd = close("orl_global" + tag, f"conv_{layer} C={c} N={n} K={k}",
                    orl_global_fused(feat, idx), orl_global_plain(feat, idx), ms, pms,
                    [feat, idx], 0)
        rec["orl_global" + tag].setdefault("layers", []).append(
            {"layer": layer, "N": n, "C": c, "K": k, "ms": ms, "plain_ms": pms,
             "bound_ms": bnd[0]})
    return rec


def support_parts(phase: str, r: dict, label: str, args, fast: bool) -> None:
    """K3's two launches timed apart and summed over the forward into
    r["parts"]: the projection (with its bound and, as a yardstick the port
    never calls, one library product: ``torch.addmm`` in fp32 with TF32 off,
    ``torch.matmul`` on bf16 operands) and the reduction (with its bound)."""
    from hspose_tpu_torch.ops import _build
    from hspose_tpu_torch.ops.cuda_hs_fused import _support_project

    feat, verts, idx, w, b, dirs, S, co = args
    Bn, n, cin = feat.shape
    proj = _support_project(feat, w, b, S, co, fast)
    out = torch.empty((Bn, n, co), dtype=torch.float32, device=DEVICE)
    feat2d = feat.reshape(-1, cin)
    if fast:
        w16 = w.to(torch.bfloat16)
        library = lambda: torch.matmul(feat2d, w16)  # noqa: E731
    else:
        library = lambda: torch.addmm(b, feat2d, w)  # noqa: E731
    p_ms = cuda_ms(lambda: _support_project(feat, w, b, S, co, fast))
    r_ms = cuda_ms(lambda: _build.launch("hs_support_reduce", proj, verts, idx, dirs, out, Bn, n,
                                         idx.shape[2], S, co, int(fast)))
    l_ms = cuda_ms(library)
    p_bound = bound([feat, w, b, proj], Bn * n * cin * S * co,
                    torch.bfloat16 if fast else torch.float32)
    r_bound = bound([proj, verts, idx, dirs, out], 3 * idx.numel() * S * co, torch.float32)
    log(phase, f"  {label}: projection {p_ms:.4f} ms (bound {p_bound[0]:.4f} "
               f"{p_bound[1]}, library {l_ms:.4f}), reduction {r_ms:.4f} ms (bound "
               f"{r_bound[0]:.4f} {r_bound[1]})")
    parts = r.setdefault("parts", {"project": {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0},
                                   "reduce": {"ms": 0.0, "bound_ms": 0.0}})
    for part, ms, bnd in (("project", p_ms, p_bound), ("reduce", r_ms, r_bound)):
        parts[part]["ms"] += ms
        parts[part]["bound_ms"] += bnd[0]
    parts["project"]["library_ms"] += l_ms


def build_seeded_model(device, dtype: str = "float32", serve_k: int = 0):
    """The serving model with weights from SEED: the same in both tiers (and
    with any ``serve_k``)."""
    from hspose_tpu_torch.config import ModelConfig
    from hspose_tpu_torch.models.hspose import build_model

    torch.manual_seed(SEED)
    model = build_model(ModelConfig(compute_dtype=dtype, serve_k=serve_k), device=device)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):  # running statistics that matter
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return model


def counters() -> dict:
    """Kernel name -> (wrapper, attribute holding its launch count)."""
    from hspose_tpu_torch.ops import chamfer as ch
    from hspose_tpu_torch.ops import cuda_hs_fused as f
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda as knn
    from hspose_tpu_torch.ops.heads_epilogue import heads_epilogue as he

    return {"knn": (knn, "launches"), "knn_streamed": (knn, "streamed_launches"),
            "heads_epilogue": (he, "launches"), "heads_epilogue_bf16": (he, "bf16_launches"),
            "chamfer_min": (ch.chamfer_min_cuda, "launches"),
            "chamfer_min_argmin": (ch.chamfer_min_argmin_cuda, "launches"),
            "chamfer_grad": (ch.chamfer_grad_cuda, "launches"),
            "hs_surface": (f.hs_surface_fused, "launches"),
            "hs_support": (f.hs_support_fused, "launches"),
            "orl_global": (f.orl_global_fused, "launches"),
            "knn_packed": (knn, "packed_launches"),
            "hs_surface_bf16": (f.hs_surface_fused, "bf16_launches"),
            "hs_support_bf16": (f.hs_support_fused, "bf16_launches"),
            "orl_global_bf16": (f.orl_global_fused, "bf16_launches"),
            "knn_qs": (knn, "qs_launches"), "knn_qs_streamed": (knn, "qs_streamed_launches"),
            "knn_qs_packed": (knn, "qs_packed_launches"),
            **{name + "_qs" + tag: (fn, "qs_" + attr)
               for name, fn in (("hs_surface", f.hs_surface_fused),
                                ("hs_support", f.hs_support_fused),
                                ("orl_global", f.orl_global_fused))
               for tag, attr in (("", "launches"), ("_bf16", "bf16_launches"))},
            **{name: (getattr(f, name), "launches") for name in FUSED_TRAIN_KERNELS},
            **{name + "_bf16": (getattr(f, name), "bf16_launches") for name in FUSED_TRAIN_KERNELS}}


def reset_counts(counts: dict) -> None:
    for fn, attr in counts.values():
        setattr(fn, attr, 0)


def read_counts(counts: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counts.items()}


def check_counts(launches: dict, per_run: dict, runs: int, what: str) -> None:
    """Every counter must read its per-run count times ``runs``; a kernel
    missing from ``per_run`` must not have launched."""
    for name, n in launches.items():
        if n != per_run.get(name, 0) * runs:
            raise AssertionError(f"{name}: {n} launches, expected {per_run.get(name, 0)} "
                                 f"per {what}")


SERVE_LAUNCHES = {
    "float32": {"knn": 9, "hs_surface": 1, "hs_support": 4, "orl_global": 5,
                "heads_epilogue": 1},
    "bfloat16": {"knn_packed": 9, "hs_surface_bf16": 1, "hs_support_bf16": 4,
                 "orl_global_bf16": 5, "heads_epilogue_bf16": 1},
}
# the forwards that multiply the concatenated feature in the heads (a head layer
# sharded over mp) launch no epilogue
CONCAT_HEADS = {"heads_epilogue": 0, "heads_epilogue_bf16": 0}

# The kernels of the serving wrappers' launches, by the names torch.profiler
# gives them.  A forward served as a CUDA graph replay (models/graphed.py)
# runs its kernels without calling a wrapper, so the wrappers' counters see
# only the eager forwards of a capture; the served route is counted here.
KERNEL_NAMES = (("knn", "::knn_kernel<"), ("surface", "::surface_kernel<"),
                ("support_projection", "hsp::gemm_kernel<float"),
                ("support_projection_bf16", "::project_bf16_kernel("),
                ("support_reduction", "(anonymous namespace)::reduce_kernel<"),
                ("orl", "::orl_kernel<"), ("heads_epilogue", "heads_epilogue_kernel<false>"),
                ("heads_epilogue_bf16", "heads_epilogue_kernel<true>"))
LAUNCH_KERNELS = {"knn": ("knn",), "knn_streamed": ("knn",), "knn_packed": ("knn",),
                  "hs_surface": ("surface",), "hs_surface_bf16": ("surface",),
                  "hs_support": ("support_projection", "support_reduction"),
                  "hs_support_bf16": ("support_projection_bf16", "support_reduction"),
                  "orl_global": ("orl",), "orl_global_bf16": ("orl",),
                  "heads_epilogue": ("heads_epilogue",),
                  "heads_epilogue_bf16": ("heads_epilogue_bf16",)}


def kernels_of(launches: dict) -> dict:
    """The kernels, by KERNEL_NAMES, that the wrappers' ``launches`` run."""
    out = {}
    for name, n in launches.items():
        for kernel in LAUNCH_KERNELS[name]:
            out[kernel] = out.get(kernel, 0) + n
    return out


def kernel_counts(events) -> dict:
    """The profiler's device ``events`` counted by KERNEL_NAMES."""
    counts = dict.fromkeys((name for name, _ in KERNEL_NAMES), 0)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            name = next((k for k, pattern in KERNEL_NAMES if pattern in e.name), None)
            if name is not None:
                counts[name] += 1
    return counts


class Served(NamedTuple):
    """What ``served`` saw of a call."""

    result: object
    launches: dict  # the wrappers' counters: the eager forwards, a capture's among them
    kernels: dict  # the serving kernels that ran, by KERNEL_NAMES
    replays: int  # hspose.model.graph_replay spans
    captures: int  # hspose.model.graph_capture spans


def session_start() -> None:
    """The first device work of a counting profiler session: a sleep kernel
    that holds the card while the host queues the calls, between a few
    small kernels that no count reads.  Sessions have dropped the record of
    the first kernel queued behind the sleep (the first KNN launch of a
    forward)."""
    x = torch.zeros(256, device=torch.cuda.current_device())
    x.add_(1)
    torch.cuda._sleep(QUEUE_CYCLES)
    for _ in range(4):
        x.add_(1)


def served(fn) -> Served:
    """``fn()`` inside a torch.profiler session, with every wrapper counter
    set to 0 just before, behind ``session_start``."""
    from torch.profiler import ProfilerActivity, profile

    counts = counters()
    reset_counts(counts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        session_start()
        result = fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    return Served(result, read_counts(counts), kernel_counts(events),
                  spans.count("hspose.model.graph_replay"),
                  spans.count("hspose.model.graph_capture"))


def check_served(s: Served, per_forward: dict, forwards: int, what: str,
                 warm: bool = False) -> None:
    """``forwards`` forwards served as graph replays: one replay each, whose
    kernels ran (``per_forward``'s launches, counted by name), and the
    wrappers' counts those of the captures' eager forwards alone (WARMUP + 1
    a capture: a replay calls no wrapper).  ``warm``: the graph was captured
    before the call, so every kernel counted ran in a replay."""
    from hspose_tpu_torch.models.graphed import WARMUP

    if s.replays != forwards or (warm and s.captures):
        raise AssertionError(f"{what}: {s.replays} graph replays and {s.captures} captures, "
                             f"expected {forwards} and {0 if warm else 'any'}")
    check_counts(s.launches, per_forward, (WARMUP + 1) * s.captures,
                 f"{what}'s capture (eager forwards)")
    check_counts(s.kernels, kernels_of(per_forward), forwards + WARMUP * s.captures,
                 f"{what} (kernels run, {WARMUP} warm-up forwards a capture)")


def concatenated_forward(model, pc, obj, samples):
    """``eval_forward`` with every head on the concatenated feature, the route
    that gradients and mp take (phase 28's other side)."""
    from hspose_tpu_torch.models.hspose import eval_forward

    model.factored = lambda: False
    try:
        return eval_forward(model, pc, obj, pool_samples=samples)
    finally:
        del model.factored


def serve_requests(model, requests, samples, obj, sym) -> list:
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import eval_forward

    results = []
    for pc, smp in zip(requests, samples):
        out = eval_forward(model, pc, obj, pool_samples=smp)
        results.append((out, generate_RT(out.p_green_R, out.p_red_R, out.f_green_R,
                                         out.f_red_R, out.pred_T, sym)))
    torch.cuda.synchronize()
    return results


def phase_slice(dtype: str = "float32", fp32_results: list | None = None, serve_k: int = 0):
    """A few requests through the serving path of one tier: launch counts,
    finite orthonormal poses, card against the CPU plain ops; for bf16 also
    the deviation from the fp32 tier's ``fp32_results``.  ``serve_k`` > 0
    serves the relaxed-KNN tier (each search and reduction at that K, the
    kernels' generic-K branches).  Returns the launches and the results."""
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import draw_pool_samples, eval_forward

    phase = ("slice" if dtype == "float32" else "bf16-slice") + (
        f"-serve_k{serve_k}" if serve_k else "")
    bound = SLICE_ATOL if dtype == "float32" else SLICE_ATOL_BF16
    model = build_seeded_model(DEVICE, dtype, serve_k)
    rng = np.random.default_rng(SEED + 2)
    obj = torch.arange(B, device=DEVICE) % 6
    sym = torch.tensor([[0, 1, 0, 0]], dtype=torch.float32, device=DEVICE).repeat(B, 1)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    requests = [cloud(rng, N) for _ in range(REQUESTS)]
    samples = [draw_pool_samples(N, gen, DEVICE) for _ in range(REQUESTS)]

    serve_requests(model, requests[:1], samples[:1], obj, sym)  # warm: the graph's capture
    s = served(lambda: serve_requests(model, requests, samples, obj, sym))
    results = s.result
    launches = {k: v // REQUESTS for k, v in s.kernels.items() if v}
    log(phase, f"{REQUESTS} requests of ({B}, {N}, 3), graph replays {s.replays}: kernels a "
               f"forward {launches}")
    check_served(s, SERVE_LAUNCHES[dtype], REQUESTS, "forward", warm=True)
    # the wrappers' launches that the replays stand for (their kernels counted above)
    launches = {**s.launches, **{k: n * REQUESTS for k, n in SERVE_LAUNCHES[dtype].items()}}

    eye = torch.eye(3, device=DEVICE)
    for i, (out, RT) in enumerate(results):
        for name, v in zip(out._fields, out):
            if not torch.isfinite(v).all():
                raise AssertionError(f"request {i}: {name} is not finite")
        R = RT[:, :3, :3]
        ortho = (R.transpose(1, 2) @ R - eye).abs().max().item()
        det = (torch.linalg.det(R) - 1).abs().max().item()
        log(phase, f"request {i}: |R^T R - I| {ortho:.2e}, |det R - 1| {det:.2e}, "
                   f"RT shape {tuple(RT.shape)}")
        if not (ortho < 1e-4 and det < 1e-4 and RT.shape == (B, 4, 4)):
            raise AssertionError(f"request {i}: R is not a rotation")

    # the same weights, input and pooling samples through the plain ops on the CPU
    cpu_model = copy.deepcopy(model).to("cpu")
    out_cpu = eval_forward(cpu_model, requests[0].cpu(), obj.cpu(),
                           pool_samples=[s.cpu() for s in samples[0]])
    RT_cpu = generate_RT(out_cpu.p_green_R, out_cpu.p_red_R, out_cpu.f_green_R,
                         out_cpu.f_red_R, out_cpu.pred_T, sym.cpu())
    out, RT = results[0]
    diffs = {name: (a.cpu() - b).abs().max().item()
             for name, a, b in zip(out._fields, out, out_cpu)}
    diffs["RT"] = (RT.cpu() - RT_cpu).abs().max().item()
    log(phase, "card against CPU plain ops, max abs diff: "
               + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    bad = {k: v for k, v in diffs.items() if not v <= bound}
    if bad:
        raise AssertionError(f"card and CPU disagree beyond {bound}: {bad}")

    if fp32_results is not None:
        dev = {name: max((a - b).abs().max().item()
                         for (o, _), (o32, _) in zip(results, fp32_results)
                         for a, b in [(getattr(o, name), getattr(o32, name))])
               for name in out._fields}
        R, R32 = (torch.cat([rt[:, :3, :3] for _, rt in res]) for res in (results, fp32_results))
        cos = ((R32.transpose(1, 2) @ R).diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2
        angle = torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))
        log(phase, f"deviation from the fp32 tier over {REQUESTS * B} crops, max abs: "
                   + ", ".join(f"{k} {v:.2e}" for k, v in dev.items())
                   + f"; rotation angle mean {angle.mean().item():.4f} deg, max "
                     f"{angle.max().item():.4f} deg")
    return launches, results


def phase_throughput(smi: str, dtype: str = "float32") -> float:
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import eval_forward

    model = build_seeded_model(DEVICE, dtype)
    pc = cloud(np.random.default_rng(SEED + 3), N)
    obj = torch.arange(B, device=DEVICE) % 6
    sym = torch.tensor([[0, 1, 0, 0]], dtype=torch.float32, device=DEVICE).repeat(B, 1)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def serve():
        out = eval_forward(model, pc, obj, generator=gen)
        return generate_RT(out.p_green_R, out.p_red_R, out.f_green_R, out.f_red_R,
                           out.pred_T, sym)

    for _ in range(3):
        serve()
    torch.cuda.synchronize()
    iters, rates = 20, []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            serve()
        torch.cuda.synchronize()
        rates.append(B * iters / (time.perf_counter() - t0))
    tier = "fp32" if dtype == "float32" else "bf16"
    log("throughput", f"{max(rates)} crops/s at B={B} {tier} (best of 3 windows of "
                      f"{iters} forwards: {rates}) on {smi}")
    return max(rates)


TRAIN_KERNELS = ("hs_surface_fwd", "hs_surface_bwd", "hs_support_fwd", "hs_support_bwd")
# the differentiable fused ops' kernels (ops/cuda_hs_fused.py)
FUSED_TRAIN_KERNELS = ("hs_surface_fused_fwd", "hs_surface_fused_bwd", "hs_support_fused_fwd",
                       "hs_support_fused_bwd", "orl_global_fused_fwd", "orl_global_fused_bwd")


def train_counters() -> dict:
    """The training kernels' counters: fp32 launches under the wrapper's
    name, bf16 launches under the name with ``_bf16``."""
    from hspose_tpu_torch.ops import cuda_hs

    fp32 = {name: (getattr(cuda_hs, name), "launches") for name in TRAIN_KERNELS}
    bf16 = {name + "_bf16": (getattr(cuda_hs, name), "bf16_launches") for name in TRAIN_KERNELS}
    return {**fp32, **bf16, "hs_support_fwd_novals": (cuda_hs.hs_support_fwd, "novals_launches"),
            "hs_support_fwd_novals_bf16": (cuda_hs.hs_support_fwd, "novals_bf16_launches"),
            "hs_support_bwd_recompute": (cuda_hs.hs_support_bwd_recompute, "launches"),
            "hs_support_bwd_recompute_bf16": (cuda_hs.hs_support_bwd_recompute, "bf16_launches")}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits), as fp32."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def compare_cotangents(phase: str, rec: dict, name: str, label: str, pairs, ms: float | None,
                       pms: float, tensors, macs: float, op_dtype=torch.float32):
    """pairs: (what, kernel tensor, plain tensor); fp32 ones within TOL_REL of
    their largest plain value, bf16 ones also one bf16 ulp of each element
    (the two fp32 sums differ in order, which can move the final rounding by
    one ulp).  Logs and records the call under ``name`` and returns its
    bound; with ``ms`` None only checks and logs."""
    torch.cuda.synchronize()
    worst, parts = 0.0, []
    for what, got, want in pairs:
        scale = want.abs().max().item()
        diff = (got.float() - want.float()).abs()
        slack = bf16_ulp(want) if got.dtype == torch.bfloat16 else torch.zeros_like(diff)
        err = diff.max().item()
        over = (diff - slack).max().item()
        parts.append(f"{what} {err:.3e} (bound {TOL_REL * scale:.3e}"
                     + (" + 1 bf16 ulp" if got.dtype == torch.bfloat16 else "") + ")")
        if not (over <= TOL_REL * scale and got.dtype == want.dtype):
            raise AssertionError(f"{name} {label} {what}: error {err} ({over} beyond the "
                                 f"ulp slack) > {TOL_REL} * {scale}, or {got.dtype} is "
                                 f"not {want.dtype}")
        worst = max(worst, err)
    if ms is None:
        log(phase, f"{name} {label}: " + ", ".join(parts))
        return None
    log(phase, f"{name} {label}: " + ", ".join(parts) + f"; {ms:.4f} ms (plain {pms:.4f} ms)")
    bnd = bound(tensors + [got for _, got, _ in pairs], macs, op_dtype)
    record(rec, name, worst, ms, pms, bnd)
    return bnd


def check_winners(phase: str, name: str, label: str, wk, wp, mk, mp) -> None:
    """Winners agree on >= WIN_AGREE of entries; where not, the values at
    the two winners (mk, mp) are fp32 near-ties."""
    differ = wk != wp
    n_differ = int(differ.sum().item())  # a count: a mean can round below 1 with none
    agree = 1.0 - n_differ / wk.numel()
    scale = mp.abs().max().item()
    gap = (mk - mp)[differ].abs().max().item() if n_differ else 0.0
    log(phase, f"{name} {label}: winners agree {agree:.6f}, largest value gap where not "
               f"{gap:.3e} (bound {TOL_REL * scale:.3e})")
    if agree < WIN_AGREE or not gap <= TOL_REL * scale:
        raise AssertionError(f"{name} {label}: winners agree {agree}, gap {gap}")


# launches by kernel name, per kernel: (substring of the profiler's kernel
# name, part), the first match wins.  K13's and K14's (csrc/hs_support_train.cu;
# the partial sum is hs_common.cuh's, shared with other backwards), K11's (the
# projection tile of csrc/hs_project.cuh and the gather-reduction) and K8's
# (csrc/hs_fused_bwd.cuh, csrc/hs_support.cu: dfeat's and dW's products are
# the tile with W, or feat, read transposed)
SUPPORT_BWD_PARTS = (("support_bwd_rows_kernel", "rows"), ("support_bwd_reduce_kernel", "reduction"),
                     ("recompute_kernel", "recompute"), ("sum_partials_kernel", "partial_sum"))
SUPPORT_FWD_PARTS = (("gemm_kernel", "projection"), ("support_fwd_kernel", "reduction"))
# K12's one launch and K15's two (csrc/hs_surface_train.cu)
SURFACE_FWD_PARTS = (("surface_fwd_kernel", "reduction"),)
SURFACE_BWD_PARTS = (("surface_bwd_kernel", "route_drf_dd"), ("sum_tiles_kernel", "partial_sum"))
# K10's one launch (csrc/orl.cu; inverse_index_kernel, the inverse lists of
# the design it replaced, must not run) and K16's / K17's (csrc/chamfer.cu)
ORL_BWD_PARTS = (("inverse_index_kernel", "inverse_index"), ("orl_bwd_kernel", "orl_bwd"))
CHAMFER_PARTS = {"chamfer_min": (("chamfer_min_kernel<false", "search"),),
                 "chamfer_min_argmin": (("chamfer_min_kernel<true", "search"),),
                 "chamfer_grad": (("inverse_index_kernel", "inverse_index"),
                                  ("chamfer_grad_kernel", "grad"))}
# K9's three launches (csrc/hs_surface.cu; the partial sum is hs_common.cuh's,
# shared with K15); inverse_index_kernel, the lists of the design before, must
# not run
SURFACE_FUSED_BWD_PARTS = (("inverse_index_kernel", "inverse_index"),
                           ("fused_bwd_kernel", "route_drf_dd"),
                           ("sum_tiles_kernel", "partial_sum"), ("dverts_rows_kernel", "dverts"))
# K9 off conv_0's shape, (N, K, S, Co) at B=4: K up to 31, S*Co not a multiple
# of 32, and (5000 x 12 entries) dverts in two windows
K9_SHAPES = ((2056, 20, 7, 128), (1001, 5, 3, 64), (257, 31, 9, 96), (5000, 12, 10, 32))
FUSED_BWD_PARTS = (("inverse_index_kernel", "inverse_index"), ("route_kernel", "route"),
                   ("rf_grad_kernel", "rf_grad"), ("dd_partial_kernel", "dd_partial"),
                   ("dfeat_source_kernel", "dfeat_source"), ("source_proj_kernel", "source"),
                   ("dverts_kernel", "dverts"),
                   ("dg_rows_kernel", "dg_rows"), ("gemm_kernel<float, false, true", "dfeat_gemm"),
                   ("gemm_kernel<", "dw_gemm"), ("sum_partials_kernel", "partial_sum"))


def surface_bwd_bounds(rf, dirs, win, gb, drf, op_dtype) -> dict:
    """Each launch of one K15 call: the routing kernel reads rf, dirs, win
    and gb once and writes drf and the 16-query tiles' dd partial sums, with
    theta, drf's and dd's multiply-adds at each winner; the partial sum
    reads the tiles' rows and writes dd."""
    B, N, sc = win.shape
    tiles = B * -(-N // 16)
    return {"route_drf_dd": bound([rf, dirs, win, gb, drf], 9 * win.numel(), op_dtype,
                                  tiles * 3 * sc * 4),
            "partial_sum": bound([], 0, torch.float32, (tiles + 1) * 3 * sc * 4)}


def surface_fused_bwd_bounds(verts, idx, dirs, win, gb) -> dict:
    """Each launch of one K9 call: the fused kernel reads verts, idx, dirs,
    win and gb once and writes drf, dvq and the 64-query chunks' rows of dd
    partial sums, with theta, drfn's and dd's multiply-adds at each winner
    (at the fp32 rate, the bf16 tier's fp64 drfn sums counted as fp32); the
    partial sum reads the rows and writes dd; dverts reads idx, drf and dvq
    and writes dverts."""
    B, N, K = idx.shape
    sc, parts, f32 = win.shape[-1], B * -(-N // 64), 4
    drf, rows = idx.numel() * 3 * f32, B * N * 3 * f32
    return {"route_drf_dd": bound([verts, idx, dirs, win, gb], 9 * win.numel(), torch.float32,
                                  drf + rows + parts * 3 * sc * f32),
            "partial_sum": bound([], 0, torch.float32, (parts + 1) * 3 * sc * f32),
            "dverts": bound([idx], 0, torch.float32, drf + 2 * rows)}


def support_bwd_bounds(g, rf, w, dirs, win, gb, recompute: bool, op_dtype) -> dict:
    """Each launch of one K13 (or, with ``recompute``, K14) call: its
    bound from its own inputs and outputs, each once."""
    rows, K, cin = g.numel() // (g.shape[-2] * g.shape[-1]), g.shape[-2], g.shape[-1]
    sc, co = win.shape[-1], gb.shape[-1]
    f32, esz = 4, g.element_size()
    parts = -(-rows // 128)
    winners = 3 * rows * sc * f32 + rows * co * f32  # win, twin, pwin, gb
    out = {"rows": bound([], rows * sc * (cin + 3), op_dtype,
                         winners + cin * sc * f32 + 3 * sc * esz + rows * K * (cin + 3) * esz),
           "reduction": bound([], rows * sc * (cin + 4), op_dtype,
                              winners + rows * K * (cin + 3) * esz + parts * (cin + 4) * sc * f32),
           "partial_sum": bound([], 0, op_dtype, (parts + 1) * (cin + 4) * sc * f32)}
    if recompute:
        out = {"recompute": bound([], rows * sc * (cin + 3), op_dtype,
                                  rows * K * (cin + 3) * esz + cin * sc * f32 + sc * f32
                                  + 3 * sc * esz + 3 * rows * sc * f32), **out}
    return out


def support_fwd_bounds(feat, rf, idx, w, b, dirs, co: int, store: bool, op_dtype) -> dict:
    """Each launch of one K11 call: the projection of the source rows
    (feat, W, b in, P out) and the gather-reduction (P, rf, idx, dirs in;
    out, win and, with ``store``, twin and pwin out), each once."""
    rows, cin = feat.numel() // feat.shape[-1], feat.shape[-1]
    sc, K = w.shape[1], idx.shape[-1]
    p_bytes = rows * sc * 4
    return {"projection": bound([feat, b], rows * cin * sc, op_dtype, cin * sc * 4 + p_bytes),
            "reduction": bound([rf, idx, dirs], rows * K * sc, torch.float32,
                               p_bytes + rows * sc * 4 * (3 if store else 1) + rows * co * 4)}


def fused_bwd_bounds(feat, verts, idx, w, win, gb, op_dtype) -> dict:
    """Each launch of one K8 call, from its own inputs and outputs, each
    once; the bf16 tier's rows (dg_rows, dfeat_source) stand in for fp32's
    dfeat product."""
    B, N, K = idx.shape
    rows, cin, sc, co = B * N, feat.shape[-1], win.shape[-1], gb.shape[-1]
    f32, fast = 4, feat.dtype == torch.bfloat16
    plane = rows * sc * f32  # one (B, N, S*Co) fp32 tensor
    small = rows * 3 * f32 + idx.numel() * 4 + 3 * sc * f32  # verts, idx, dirs
    lists = (B * (N + 1) + idx.numel()) * 4
    parts, dw_parts = -(-N // 64) * B, -(-rows // 256)
    out = {"inverse_index": bound([idx], 0, torch.float32, lists),
           "route": bound([], 3 * rows * sc, torch.float32,
                          small + 4 * plane + rows * co * f32),  # win, P in; dz, dproj out
           "rf_grad": bound([], 3 * rows * sc, torch.float32,
                            small + 2 * plane + idx.numel() * 3 * f32 + rows * 3 * f32),
           "dd_partial": bound([], 4 * rows * sc, torch.float32,
                               small + 3 * plane + parts * 4 * sc * f32),
           "source": bound([idx], 0, torch.float32, 3 * plane),
           "dverts": bound([], 0, torch.float32, lists + idx.numel() * 3 * f32
                           + 2 * rows * 3 * f32),
           "dw_gemm": bound([feat], rows * cin * sc, torch.float32,
                            plane + dw_parts * cin * sc * f32),
           "partial_sum": bound([], 0, torch.float32,
                                (parts + 1) * 4 * sc * f32 + (dw_parts + 1) * cin * sc * f32)}
    if fast:
        dg = idx.numel() * cin * 2
        out["dg_rows"] = bound([], rows * sc * cin, op_dtype, 2 * plane + cin * sc * f32 + dg)
        out["dfeat_source"] = bound([], 0, torch.float32, lists + dg + rows * cin * 2)
    else:
        out["dfeat_gemm"] = bound([w], rows * sc * cin, torch.float32, plane + rows * cin * f32)
    return out


def launch_parts(phase: str, r: dict, label: str, fn, bounds: dict, names, per_call=None,
                 calls: int = 10) -> None:
    """A kernel's launches timed apart: each part's mean device time per
    launch (by torch.profiler over ``calls`` calls after one) times its
    launches per call (``per_call``, 1 unless given), summed over the pass
    into r["parts"] beside its bound.  ``names`` maps the kernels to parts
    (SUPPORT_BWD_PARTS, ...).  Each part of ``bounds`` must launch, at most
    ``per_call`` times a call, and no other part may (the profiler can drop
    a launch's record, so a part may show fewer).  A session in which the
    profiler recorded no launch of any part is run again, up to twice: the
    gate still fails if the parts never launch."""
    from torch.profiler import ProfilerActivity, profile

    per_call = per_call or {}
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the calls queue behind a sleep kernel: launches that run while
            # the session starts are not recorded
            torch.cuda._sleep(QUEUE_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
                continue
            part = next((p for k, p in names if k in e.name), None)
            if part is not None:
                total[part] = total.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
                count[part] = count.get(part, 0) + 1
        if count:
            break
        log(phase, f"  {label}: the profiler recorded no launch of any part; the session again")
    if set(count) != set(bounds) or any(n > calls * per_call.get(p, 1) for p, n in count.items()):
        raise AssertionError(f"{label}: launches over {calls} calls {count}, expected at most "
                             f"{ {p: per_call.get(p, 1) for p in bounds} } a call")
    ms = {part: total[part] / count[part] * per_call.get(part, 1) for part in bounds}
    parts = r.setdefault("parts", {})
    for part, (bms, by) in bounds.items():
        e = parts.setdefault(part, {"ms": 0.0, "bound_ms": 0.0, "bound_ms_by": {}})
        e["ms"] += ms[part]
        e["bound_ms"] += bms
        e["bound_ms_by"][by] = e["bound_ms_by"].get(by, 0.0) + bms
        e["bound_by"] = max(e["bound_ms_by"], key=e["bound_ms_by"].get)
    r["launches_per_call"] = sum(per_call.get(p, 1) for p in bounds)
    log(phase, f"  {label}: " + ", ".join(f"{part} {ms[part]:.4f} ms (bound {bms:.4f} {by})"
                                         for part, (bms, by) in bounds.items())
        + f"; launches seen over {calls} calls {count}")


def library_part(r: dict, part: str, ms: float) -> None:
    """Add a library yardstick's time to r["parts"][part]["library_ms"]."""
    e = r["parts"][part]
    e["library_ms"] = e.get("library_ms", 0.0) + ms


def layer_time(r: dict, layer: int, ms: float, pms: float, bnd) -> None:
    r.setdefault("layers", []).append({"layer": layer, "ms": ms, "plain_ms": pms,
                                       "bound_ms": bnd[0]})


def support_fwd_work(fargs, src, win) -> tuple[list, float]:
    """K11's least work (with its outputs, which ``compare_cotangents``
    adds): feat, rf, idx, W, b, dirs read and win written once; the
    projection of the B*N source rows and theta at each (query, k, column)."""
    g, rf, w, b, dirs, S, co = fargs
    feat, idx = src["feat"], src["idx"]
    return [feat, rf, idx, w, b, dirs, win], feat.numel() * S * co + rf.numel() * S * co


def support_fwd_detail(phase: str, r: dict, layer: int, label: str, fargs, src, store: bool,
                       ms: float, pms: float, bnd, op_dtype) -> None:
    """K11's per-layer time, the bound of the design it replaced (every
    gathered row projected: g read and (B, N, K) * S*Co multiply-adds,
    summed in r["bound_gathered_ms"]), its two launches timed apart
    (``launch_parts``) and, for the projection, a library product as
    yardstick (``torch.addmm`` in fp32 with TF32 off, ``torch.matmul`` on
    bf16 operands; the port never calls it)."""
    from hspose_tpu_torch.ops import cuda_hs

    g, rf, w, b, dirs, S, co = fargs
    feat = src["feat"]
    layer_time(r, layer, ms, pms, bnd)
    old = bound([g, rf, w, b, dirs], (g.numel() + rf.numel()) * S * co, op_dtype,
                feat.shape[0] * feat.shape[1] * (S * co * (12 if store else 4) + co * 4))
    r["bound_gathered_ms"] = r.get("bound_gathered_ms", 0.0) + old[0]
    launch_parts(phase, r, label,
                 lambda: cuda_hs.hs_support_fwd(*fargs, store=store, **src),
                 support_fwd_bounds(feat, rf, src["idx"], w, b, dirs, co, store, op_dtype),
                 SUPPORT_FWD_PARTS)
    feat2d = feat.reshape(-1, feat.shape[-1])
    if feat.dtype == torch.bfloat16:
        w16 = w.to(torch.bfloat16)
        library_part(r, "projection", cuda_ms(lambda: torch.matmul(feat2d, w16), 10))
    else:
        library_part(r, "projection", cuda_ms(lambda: torch.addmm(b, feat2d, w), 10))
    log(phase, f"  {label}: gather-then-project bound {old[0]:.4f} ms ({old[1]}), projection "
               f"library {r['parts']['projection']['library_ms']:.4f} ms (summed so far)")


def phase_train_kernels(dtype: str = "float32") -> dict:
    """K12, K15, K11, K13 against their plain versions at the train step's
    shapes (B=16), fp32 or the bf16 instantiations (bf16 rf, gathered rows
    and directions as the bf16 train step forms them; W and b fp32).  The
    backwards get the kernel forward's residuals on both sides, so winner
    flips do not enter their comparison.  Returns per-kernel records; ms and
    plain_ms sum the calls of one train step."""
    from hspose_tpu_torch.ops import cuda_hs
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized

    fast = dtype == "bfloat16"
    phase, tag = ("bf16-train-kernels", "_bf16") if fast else ("train-kernels", "")
    op_dtype = torch.bfloat16 if fast else torch.float32
    rng = np.random.default_rng(SEED + 4)
    rec = {}
    S, B = 7, TRAIN_B

    def compare(name, label, pairs, ms, pms, tensors, macs):
        return compare_cotangents(phase, rec, name + tag, label, pairs, ms, pms, tensors, macs,
                                  op_dtype)

    def winners(name, label, wk, wp, mk, mp):
        check_winners(phase, name + tag, label, wk, wp, mk, mp)

    # K12 / K15: conv_0
    verts = cloud_b(rng, B, N)
    rf = neighbor_directions_normalized(verts.to(op_dtype),
                                        knn_indices_cuda(verts, 20, packed=fast))
    co, dirs = 128, unit_dirs(rng, S * 128).to(op_dtype)
    label = f"conv_0 N={N} K=20 Co={co}"
    out_k, win_k = cuda_hs.hs_surface_fwd(rf, dirs, S, co)
    out_p, win_p = cuda_hs.hs_surface_fwd_plain(rf, dirs, S, co)
    theta = torch.relu(rf.double() @ dirs.double())  # (B, N, K, S*Co)
    winners("hs_surface_fwd", label, win_k, win_p,
            theta.gather(2, win_k.long()[:, :, None]).squeeze(2),
            theta.gather(2, win_p.long()[:, :, None]).squeeze(2))
    del theta
    fwd_bound = compare("hs_surface_fwd", label, [("out", out_k, out_p)],
                        cuda_ms(lambda: cuda_hs.hs_surface_fwd(rf, dirs, S, co), 10),
                        cuda_ms(lambda: cuda_hs.hs_surface_fwd_plain(rf, dirs, S, co), 10),
                        [rf, dirs, win_k], rf.numel() * S * co)
    launch_parts(phase, rec["hs_surface_fwd" + tag], label,
                 lambda: cuda_hs.hs_surface_fwd(rf, dirs, S, co), {"reduction": fwd_bound},
                 SURFACE_FWD_PARTS)
    gb = normal(rng, B, N, co)
    args = (rf, dirs, win_k, gb, S, co)
    drf_k, dd_k = cuda_hs.hs_surface_bwd(*args)
    compare("hs_surface_bwd", label,
            list(zip(("drf", "dd"), (drf_k, dd_k), cuda_hs.hs_surface_bwd_plain(*args))),
            cuda_ms(lambda: cuda_hs.hs_surface_bwd(*args), 10),
            cuda_ms(lambda: cuda_hs.hs_surface_bwd_plain(*args), 10),
            [rf, dirs, win_k, gb], 9 * win_k.numel())  # theta, drf, dd at each winner
    launch_parts(phase, rec["hs_surface_bwd" + tag], label,
                 lambda: cuda_hs.hs_surface_bwd(*args),
                 surface_bwd_bounds(rf, dirs, win_k, gb, drf_k, op_dtype), SURFACE_BWD_PARTS)

    # K11 / K13: conv_1 .. conv_4, w and b as column slices of the layer's matrix
    for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, N // 4, 20),
                                 (3, 256, 256, N // 4, 20), (4, 256, 512, N // 16, 8)]:
        label = f"conv_{layer} {cin}->{co} N={n} K={k}"
        verts = cloud_b(rng, B, n)
        feat = torch.relu(normal(rng, B, n, cin)).to(op_dtype)
        idx = knn_indices_cuda(feat, k, packed=fast)
        g = gather_neighbors(feat, idx)
        rf = neighbor_directions_normalized(verts.to(op_dtype), idx)
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w_full = normal(rng, cin, (S + 1) * co, scale=stdv)
        b_full = normal(rng, (S + 1) * co, scale=stdv)
        fargs = (g, rf, w_full[:, co:], b_full[co:], unit_dirs(rng, S * co).to(op_dtype), S, co)
        src = {"feat": feat, "idx": idx}  # K11 reads the rows g gathers
        out_k, win_k, tw_k, pw_k = cuda_hs.hs_support_fwd(*fargs, **src)
        out_p, win_p, tw_p, pw_p = cuda_hs.hs_support_fwd_plain(*fargs)
        winners("hs_support_fwd", label, win_k, win_p, tw_k * pw_k, tw_p * pw_p)
        same = win_k == win_p
        ms = cuda_ms(lambda: cuda_hs.hs_support_fwd(*fargs, **src), 10)
        pms = cuda_ms(lambda: cuda_hs.hs_support_fwd_plain(*fargs), 10)
        bnd = compare("hs_support_fwd", label,
                      [("out", out_k, out_p), ("twin", tw_k * same, tw_p * same),
                       ("pwin", pw_k * same, pw_p * same)], ms, pms,
                      *support_fwd_work(fargs, src, win_k))
        support_fwd_detail(phase, rec["hs_support_fwd" + tag], layer, label, fargs, src, True,
                           ms, pms, bnd, op_dtype)
        gb = normal(rng, B, n, co)
        bargs = (g, rf, fargs[2], fargs[4], win_k, tw_k, pw_k, gb, S, co)
        ms = cuda_ms(lambda: cuda_hs.hs_support_bwd(*bargs), 10)
        pms = cuda_ms(lambda: cuda_hs.hs_support_bwd_plain(*bargs), 10)
        bnd = compare("hs_support_bwd", label,
                      list(zip(("dg", "drf", "dw", "db", "dd"), cuda_hs.hs_support_bwd(*bargs),
                               cuda_hs.hs_support_bwd_plain(*bargs))), ms, pms,
                      [g, rf, fargs[2], fargs[4], win_k, tw_k, pw_k, gb],
                      win_k.numel() * (2 * cin + 6))  # dg, dW at each winner; drf, dd
        r = rec["hs_support_bwd" + tag]
        layer_time(r, layer, ms, pms, bnd)
        launch_parts(phase, r, label, lambda: cuda_hs.hs_support_bwd(*bargs),
                     support_bwd_bounds(g, rf, fargs[2], fargs[4], win_k, gb, False, op_dtype),
                     SUPPORT_BWD_PARTS)
    return rec


def same_bits(name: str, label: str, first, second) -> None:
    """Two launches on the same inputs must give the same bits."""
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {label}: two launches on the same inputs differ")


def phase_v4_kernels(dtype: str = "float32") -> tuple[dict, dict]:
    """K11 without winner values and K14 at the four HS layers' shapes of
    the B=16 step (bwd_store=False); the fused ops' winner-recording
    forwards (K2-K4) and their backwards K9, K8 and K10 at conv_0's,
    conv_2..conv_4's and their ORL branches' shapes (train_v4_small): each
    against its plain version (forwards within TOL_REL of the largest value
    and winners as in phase 8; backwards fed the kernel forward's residuals
    on both sides, fp32 cotangents within TOL_REL of their largest value,
    bf16 ones within one bf16 ulp of each element more), K14 against K13 on
    the same inputs bit for bit, the forwards with winners against the
    serving kernels bit for bit, two launches with the same bits; then one
    autograd backward through ``hs_surface_fused`` (K9's carrier).  fp32
    (phase 12) or the bf16 instantiations (phase 14: bf16 features, rf and
    directions as the bf16 step forms them, W, b and the fused ops'
    vertices and directions fp32).  Returns the per-kernel records and the
    carrier's launches."""
    from hspose_tpu_torch.ops import cuda_hs, cuda_hs_fused as f
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized

    fast = dtype == "bfloat16"
    phase, tag = ("bf16-v4-train-kernels", "_bf16") if fast else ("v4-train-kernels", "")
    op = torch.bfloat16 if fast else torch.float32
    rng = np.random.default_rng(SEED + (9 if fast else 8))
    rec = {}
    S, B = 7, TRAIN_B

    def compare(name, *args):
        return compare_cotangents(phase, rec, name + tag, *args, op_dtype=op)

    def winners(name, *args):
        check_winners(phase, name + tag, *args)

    def bits(name, *args):
        same_bits(name + tag, *args)

    def at_win(x, win):  # x (B, N, K, C) at each column's winner
        return x.gather(2, win.long()[:, :, None]).squeeze(2)

    def fused_theta(verts, idx, d):  # relu(rfn . d) of the fused ops, (B, N, K, C)
        if fast:
            return f._theta_fast(f._rf_fast(verts, idx), f._bf16(d))
        return torch.relu(neighbor_directions_normalized(verts, idx) @ d)

    def knn(pts, k):
        return knn_indices_cuda(pts, k, packed=fast)

    # K11 without winner values, K14: the four HS layers (bwd_store=False alone)
    for layer, cin, co, n, k in [(1, 128, 128, N, 20), (2, 128, 256, N // 4, 20),
                                 (3, 256, 256, N // 4, 20), (4, 256, 512, N // 16, 8)]:
        label = f"conv_{layer} {cin}->{co} N={n} K={k}"
        feat = torch.relu(normal(rng, B, n, cin)).to(op)
        idx = knn(feat, k)
        g = gather_neighbors(feat, idx)
        rf = neighbor_directions_normalized(cloud_b(rng, B, n).to(op), idx)
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w, b = normal(rng, cin, (S + 1) * co, scale=stdv), normal(rng, (S + 1) * co, scale=stdv)
        fargs = (g, rf, w[:, co:], b[co:], unit_dirs(rng, S * co).to(op), S, co)
        src = {"feat": feat, "idx": idx}  # K11 reads the rows g gathers
        out_k, win_k = cuda_hs.hs_support_fwd(*fargs, store=False, **src)
        out_p, win_p = cuda_hs.hs_support_fwd_plain(*fargs)[:2]
        stored = cuda_hs.hs_support_fwd(*fargs, **src)
        bits("hs_support_fwd_novals", label, (out_k, win_k), stored[:2])
        theta_proj = [cuda_hs._theta(rf, fargs[4][:, sl])
                      * (g.float() @ cuda_hs._operand(fargs[2][:, sl], fast) + fargs[3][sl])
                      for sl in (slice(i * co, (i + 1) * co) for i in range(S))]
        vk = torch.cat([at_win(x, win_k[..., i * co:(i + 1) * co])
                        for i, x in enumerate(theta_proj)], -1)
        vp = torch.cat([at_win(x, win_p[..., i * co:(i + 1) * co])
                        for i, x in enumerate(theta_proj)], -1)
        del theta_proj
        winners("hs_support_fwd_novals", label, win_k, win_p, vk, vp)
        ms = cuda_ms(lambda: cuda_hs.hs_support_fwd(*fargs, store=False, **src), 10)
        pms = cuda_ms(lambda: cuda_hs.hs_support_fwd_plain(*fargs), 10)
        bnd = compare("hs_support_fwd_novals", label, [("out", out_k, out_p)], ms, pms,
                      *support_fwd_work(fargs, src, win_k))
        support_fwd_detail(phase, rec["hs_support_fwd_novals" + tag], layer, label, fargs, src,
                           False, ms, pms, bnd, op)
        gb = normal(rng, B, n, co)
        bargs = (g, rf, fargs[2], fargs[3], fargs[4], win_k, gb, S, co)
        got = cuda_hs.hs_support_bwd_recompute(*bargs)
        bits("hs_support_bwd_recompute", label, got, cuda_hs.hs_support_bwd_recompute(*bargs))
        k13 = cuda_hs.hs_support_bwd(g, rf, fargs[2], fargs[4], win_k, stored[2], stored[3], gb,
                                     S, co)
        bits("hs_support_bwd_recompute", label + " (against K13 on the forward's stored values)",
             got, k13)
        log(phase, f"hs_support_bwd_recompute{tag} {label}: K13's bits on the forward's stored "
                   f"values")
        ms = cuda_ms(lambda: cuda_hs.hs_support_bwd_recompute(*bargs), 10)
        pms = cuda_ms(lambda: cuda_hs.hs_support_bwd_recompute_plain(*bargs), 10)
        bnd = compare("hs_support_bwd_recompute", label,
                      list(zip(("dg", "drf", "dw", "db", "dd"), got,
                               cuda_hs.hs_support_bwd_recompute_plain(*bargs))), ms, pms,
                      [g, rf, fargs[2], fargs[3], fargs[4], win_k, gb],
                      win_k.numel() * (3 * cin + 9))  # P at each winner; dg, dW; theta, drf, dd
        r = rec["hs_support_bwd_recompute" + tag]
        layer_time(r, layer, ms, pms, bnd)
        launch_parts(phase, r, label, lambda: cuda_hs.hs_support_bwd_recompute(*bargs),
                     support_bwd_bounds(g, rf, fargs[2], fargs[4], win_k, gb, True, op),
                     SUPPORT_BWD_PARTS)

    # K2 with winners, K9: conv_0
    label = f"conv_0 N={N} K=20 Co=128"
    verts = cloud_b(rng, B, N)
    idx = knn(verts, 20)
    dirs = unit_dirs(rng, S * 128)
    fargs = (verts, idx, dirs, S, 128)
    (out_k, win_k), (out_p, win_p) = (f.hs_surface_fused_fwd(*fargs, exact=not fast),
                                      f.hs_surface_fused_fwd_plain(*fargs, exact=not fast))
    theta = fused_theta(verts, idx, dirs)
    winners("hs_surface_fused_fwd", label, win_k, win_p, at_win(theta, win_k), at_win(theta, win_p))
    del theta
    with torch.no_grad():
        serving = f.hs_surface_fused(*fargs, exact=not fast)
    bits("hs_surface_fused_fwd", label + " (against the serving kernel)", (out_k,), (serving,))
    compare("hs_surface_fused_fwd", label, [("out", out_k, out_p)],
            cuda_ms(lambda: f.hs_surface_fused_fwd(*fargs, exact=not fast), 10),
            cuda_ms(lambda: f.hs_surface_fused_fwd_plain(*fargs, exact=not fast), 10),
            [verts, idx, dirs, win_k], 3 * idx.numel() * S * 128)
    gb = normal(rng, B, N, 128)
    bargs = (verts, idx, dirs, win_k, gb, S, 128)
    got = f.hs_surface_fused_bwd(*bargs, exact=not fast)
    bits("hs_surface_fused_bwd", label, got, f.hs_surface_fused_bwd(*bargs, exact=not fast))
    compare("hs_surface_fused_bwd", label,
            list(zip(("dverts", "dd"), got, f.hs_surface_fused_bwd_plain(*bargs, exact=not fast))),
            cuda_ms(lambda: f.hs_surface_fused_bwd(*bargs, exact=not fast), 10),
            cuda_ms(lambda: f.hs_surface_fused_bwd_plain(*bargs, exact=not fast), 10),
            [verts, idx, dirs, win_k, gb], 9 * win_k.numel())  # theta, drfn, dd at each winner
    # three launches a call: launch_parts raises on an inverse_index_kernel launch
    launch_parts(phase, rec["hs_surface_fused_bwd" + tag], label,
                 lambda: f.hs_surface_fused_bwd(*bargs, exact=not fast),
                 surface_fused_bwd_bounds(verts, idx, dirs, win_k, gb), SURFACE_FUSED_BWD_PARTS)
    for n, k, s_, co in K9_SHAPES:  # off conv_0's shape: against plain, twice bit for bit
        shape = f"B=4 N={n} K={k} S={s_} Co={co}"
        verts = cloud_b(rng, 4, n)
        verts[:, 1] = verts[:, 0]  # a duplicated point: |rf| = 0
        idx = knn(verts, k)
        dirs = unit_dirs(rng, s_ * co)
        win = f.hs_surface_fused_fwd(verts, idx, dirs, s_, co, exact=not fast)[1]
        kargs = (verts, idx, dirs, win, normal(rng, 4, n, co), s_, co)
        got = f.hs_surface_fused_bwd(*kargs, exact=not fast)
        bits("hs_surface_fused_bwd", shape, got, f.hs_surface_fused_bwd(*kargs, exact=not fast))
        compare("hs_surface_fused_bwd", shape + " (twice, same bits)",
                list(zip(("dverts", "dd"), got,
                         f.hs_surface_fused_bwd_plain(*kargs, exact=not fast))), None, 0.0, [], 0)

    # K3 with winners, K8: conv_2 .. conv_4 (train_v4_small)
    for layer, cin, co, n, k in [(2, 128, 256, N // 4, 20), (3, 256, 256, N // 4, 20),
                                 (4, 256, 512, N // 16, 8)]:
        label = f"conv_{layer} {cin}->{co} N={n} K={k}"
        feat = torch.relu(normal(rng, B, n, cin)).to(op)
        stdv = 1.0 / (co * (S + 1)) ** 0.5
        w, b = normal(rng, cin, (S + 1) * co, scale=stdv), normal(rng, (S + 1) * co, scale=stdv)
        verts, idx = cloud_b(rng, B, n), knn(feat, k)
        fargs = (feat, verts, idx, w[:, co:], b[co:], unit_dirs(rng, S * co), S, co)
        (out_k, win_k, proj_k), (out_p, win_p, proj_p) = (f.hs_support_fused_fwd(*fargs),
                                                          f.hs_support_fused_fwd_plain(*fargs))
        theta = fused_theta(verts, idx, fargs[5])
        prod = [theta[..., i * co:(i + 1) * co]
                * gather_neighbors(proj_p[..., i * co:(i + 1) * co], idx) for i in range(S)]
        del theta
        winners("hs_support_fused_fwd", label, win_k, win_p,
                torch.cat([at_win(x, win_k[..., i * co:(i + 1) * co]) for i, x in enumerate(prod)], -1),
                torch.cat([at_win(x, win_p[..., i * co:(i + 1) * co]) for i, x in enumerate(prod)], -1))
        del prod
        with torch.no_grad():
            serving = f.hs_support_fused(*fargs)
        bits("hs_support_fused_fwd", label + " (against the serving kernel)", (out_k,), (serving,))
        compare("hs_support_fused_fwd", label, [("out", out_k, out_p), ("proj", proj_k, proj_p)],
                cuda_ms(lambda: f.hs_support_fused_fwd(*fargs), 10),
                cuda_ms(lambda: f.hs_support_fused_fwd_plain(*fargs), 10),
                list(fargs[:6]) + [win_k], B * n * cin * S * co + 3 * idx.numel() * S * co)
        gb = normal(rng, B, n, co)
        bargs = (feat, verts, idx, fargs[3], fargs[5], win_k, proj_k, gb, S, co)
        got = f.hs_support_fused_bwd(*bargs)
        bits("hs_support_fused_bwd", label, got, f.hs_support_fused_bwd(*bargs))
        ms = cuda_ms(lambda: f.hs_support_fused_bwd(*bargs), 10)
        pms = cuda_ms(lambda: f.hs_support_fused_bwd_plain(*bargs), 10)
        bnd = compare("hs_support_fused_bwd", label,
                      list(zip(("dfeat", "dverts", "dw", "db", "dd"), got,
                               f.hs_support_fused_bwd_plain(*bargs))), ms, pms,
                      [feat, verts, idx, fargs[3], fargs[5], win_k, proj_k, gb],
                      2 * B * n * cin * S * co + 9 * win_k.numel())  # dfeat, dW; theta, drfn, dd
        r = rec["hs_support_fused_bwd" + tag]
        layer_time(r, layer, ms, pms, bnd)
        # K8's launches apart; its two products beside one library product each
        # (fp32, TF32 off; the port never calls them), on the projection P as a
        # stand-in of the same shape for dproj_src
        launch_parts(phase, r, label, lambda: f.hs_support_fused_bwd(*bargs),
                     fused_bwd_bounds(feat, verts, idx, fargs[3], win_k, gb, op),
                     FUSED_BWD_PARTS, {"partial_sum": 2})
        p2d, feat2d = proj_k.reshape(B * n, -1), feat.reshape(B * n, cin).float()
        if not fast:
            w_t = fargs[3].t()
            library_part(r, "dfeat_gemm", cuda_ms(lambda: torch.matmul(p2d, w_t), 10))
        feat_t = feat2d.t()
        library_part(r, "dw_gemm", cuda_ms(lambda: torch.matmul(feat_t, p2d), 10))

    # K4 with winners, K10: the ORL branches of conv_2 .. conv_4
    for layer, c, n, k in [(2, 256, N // 4, 20), (3, 256, N // 4, 20), (4, 512, N // 16, 8)]:
        label = f"conv_{layer} C={c} N={n} K={k}"
        feat, idx = normal(rng, B, n, c).to(op), knn(cloud_b(rng, B, n), k)
        (out_k, win_k), (out_p, win_p) = (f.orl_global_fused_fwd(feat, idx),
                                          f.orl_global_fused_fwd_plain(feat, idx))
        rows = gather_neighbors(feat, idx).float()
        winners("orl_global_fused_fwd", label, win_k, win_p, at_win(rows, win_k),
                at_win(rows, win_p))
        with torch.no_grad():
            serving = f.orl_global_fused(feat, idx)
        bits("orl_global_fused_fwd", label + " (against the serving kernel)", (out_k,), (serving,))
        compare("orl_global_fused_fwd", label, [("out", out_k, out_p)],
                cuda_ms(lambda: f.orl_global_fused_fwd(feat, idx), 10),
                cuda_ms(lambda: f.orl_global_fused_fwd_plain(feat, idx), 10),
                [feat, idx, win_k], 0)
        gb = normal(rng, B, 1, c)
        got = f.orl_global_fused_bwd(idx, win_k, gb, op)
        bits("orl_global_fused_bwd", label, (got,), (f.orl_global_fused_bwd(idx, win_k, gb, op),))
        bnd = compare("orl_global_fused_bwd", label,
                      [("dfeat", got, f.orl_global_fused_bwd_plain(idx, win_k, gb, op))],
                      cuda_ms(lambda: f.orl_global_fused_bwd(idx, win_k, gb, op), 10),
                      cuda_ms(lambda: f.orl_global_fused_bwd_plain(idx, win_k, gb, op), 10),
                      [idx, win_k, gb], 0)
        # one launch a call: launch_parts raises on an inverse_index_kernel
        # launch, or on more orl_bwd launches than calls (the profiler can
        # drop a record, so it may see fewer)
        launch_parts(phase, rec["orl_global_fused_bwd" + tag], label,
                     lambda: f.orl_global_fused_bwd(idx, win_k, gb, op), {"orl_bwd": bnd},
                     ORL_BWD_PARTS)

    # K9's carrier: one autograd backward through hs_surface_fused
    names = [name + tag for name in ("hs_surface", "hs_surface_fused_fwd", "hs_surface_fused_bwd")]
    counts = {name: counters()[name] for name in names}
    verts = cloud_b(rng, B, N).requires_grad_(True)
    idx = knn(verts.detach(), 20)
    dirs = unit_dirs(rng, S * 128).requires_grad_(True)
    gb = normal(rng, B, N, 128)
    reset_counts(counts)
    (f.hs_surface_fused(verts, idx, dirs, S, 128, exact=not fast) * gb).sum().backward()
    torch.cuda.synchronize()
    carrier = read_counts(counts)
    log(phase, f"autograd through hs_surface_fused at conv_0's shape: launches {carrier}")
    check_counts(carrier, {names[1]: 1, names[2]: 1}, 1, "backward")
    vd, dd = verts.detach(), dirs.detach()
    want = f.hs_surface_fused_bwd(vd, idx, dd, f.hs_surface_fused_fwd(vd, idx, dd, S, 128,
                                                                      exact=not fast)[1],
                                  gb, S, 128, exact=not fast)
    bits("hs_surface_fused autograd", "conv_0", (verts.grad, dirs.grad), want)
    return rec, carrier


def build_train_model(device, cfg):
    from hspose_tpu_torch.models.hspose import build_model

    torch.manual_seed(SEED)
    return build_model(cfg, device=device, train_heads=True)


def grad_gates(got: dict, want: dict) -> str:
    """The N=1028 gates of tests/test_torch_parity.py on parameter gradients:
    per leaf cosine, norm_rel and norm ratio, and the global cosine.

    A bias that a train-mode BatchNorm follows has a zero gradient in exact
    arithmetic (BN removes any constant shift), so both sides hold rounding
    noise there and its direction means nothing: a leaf whose reference norm
    is below ZERO_LEAF of the largest is held only to being as small on the
    card."""
    lo_cos, hi_rel, lo_ratio, hi_ratio = GRAD_LEAF
    top = max(w.double().norm().item() for w in want.values())
    worst, zero = (1.0, 0.0, 1.0), []
    all_g, all_w = [], []
    for name, w in want.items():
        g = got[name].double().ravel()
        w = w.double().ravel()
        nw, ng = max(w.norm().item(), 1e-30), max(g.norm().item(), 1e-30)
        if nw <= ZERO_LEAF * top:
            zero.append(name)
            if not ng <= ZERO_LEAF * top:
                raise AssertionError(f"grad {name}: norm {ng:.3e} where the reference's "
                                     f"{nw:.3e} is rounding noise (bound {ZERO_LEAF * top:.3e})")
            continue
        cos = (g @ w).item() / (ng * nw)
        rel = (g - w).norm().item() / nw
        if not (cos >= lo_cos and rel <= hi_rel and lo_ratio <= ng / nw <= hi_ratio):
            raise AssertionError(f"grad {name}: cos {cos:.5f} norm_rel {rel:.3e} "
                                 f"ratio {ng / nw:.4f}")
        worst = (min(worst[0], cos), max(worst[1], rel),
                 ng / nw if abs(ng / nw - 1) > abs(worst[2] - 1) else worst[2])
        all_g.append(g)
        all_w.append(w)
    g, w = torch.cat(all_g), torch.cat(all_w)
    cos = (g @ w).item() / (g.norm().item() * w.norm().item())
    if not cos >= GRAD_COS:
        raise AssertionError(f"global gradient cosine {cos} < {GRAD_COS}")
    return (f"{len(all_g)} leaves gated, worst cos {worst[0]:.5f}, worst norm_rel "
            f"{worst[1]:.3e}, worst norm ratio {worst[2]:.4f}, global cos {cos:.6f}; "
            f"{len(zero)} leaves zero up to rounding on both sides ({', '.join(zero)})")


def train_once(cfg, model, batch: dict, draws, device) -> tuple[dict, dict, dict]:
    """One train forward and backward of ``model`` on the numpy ``batch``:
    (loss terms with the total, BatchNorm running statistics, parameter
    gradients), on the CPU."""
    from hspose_tpu_torch.engine.train_step import to_device
    from hspose_tpu_torch.models.hspose import train_forward

    total, losses = train_forward(cfg, model, to_device(batch, device), draws=draws.to(device))
    total.backward()
    terms = {"total": total.item(),
             **{f"{f}/{k}": v.item() for f, d in losses.items() for k, v in d.items()}}
    stats = {n: b.detach().cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return terms, stats, {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def step_gaps(a: tuple, b: tuple) -> dict:
    """How far two ``train_once`` results lie apart: the largest loss-term
    difference as a share of the total loss, the largest BatchNorm-statistic
    difference as a share of that buffer's largest value, and 1 - the cosine
    of all parameter gradients as one vector."""
    (ta, sa, ga), (tb, sb, gb) = a, b
    loss = max(abs(ta[k] - v) for k, v in tb.items()) / abs(tb["total"])
    bn = max(((sa[n] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
             for n, v in sb.items())
    g1, g2 = (torch.cat([g[n].double().ravel() for n in gb]) for g in (ga, gb))
    cos = (g1 @ g2).item() / (g1.norm().item() * g2.norm().item())
    return {"loss": loss, "bn": bn, "grad": 1.0 - cos}


def _flag_launches(tag: str, knn: str, store: bool, v4: bool) -> dict:
    """Launches per train step of one tier (``tag`` "" or "_bf16") under the
    two training flags: conv_0 on K12/K15; conv_1 .. conv_4 on K11/K13
    (``store``) or K11 without winner values and K14, except that with
    ``v4`` conv_2 .. conv_4 and their ORL branches take the fused ops'
    K3/K8 and K4/K10."""
    support = ({"hs_support_fwd": 1, "hs_support_bwd": 1} if store else
               {"hs_support_fwd_novals": 1, "hs_support_bwd_recompute": 1})
    layers = 1 if v4 else 4
    out = {knn: 9, "hs_surface_fwd" + tag: 1, "hs_surface_bwd" + tag: 1,
           **{name + tag: n * layers for name, n in support.items()}}
    if v4:
        out.update({name + tag: 3 for name in ("hs_support_fused_fwd", "hs_support_fused_bwd",
                                              "orl_global_fused_fwd", "orl_global_fused_bwd")})
    return out


# per train step, in each training configuration: the default fp32 and bf16
# steps, and in each tier the step with bwd_store=False and train_v4_small=True
# ("v4", "bf16v4": conv_1 on K11 without winner values and K14, conv_2 ..
# conv_4 and their ORL branches on the fused ops' K3/K8 and K4/K10) and with
# each flag alone ("recompute", "v4only" and their bf16 twins)
TRAIN_TIERS = {  # tier -> (compute_dtype, bwd_store, train_v4_small)
    "float32": ("float32", True, False), "bfloat16": ("bfloat16", True, False),
    "v4": ("float32", False, True), "bf16v4": ("bfloat16", False, True),
    "recompute": ("float32", False, False), "bf16recompute": ("bfloat16", False, False),
    "v4only": ("float32", True, True), "bf16v4only": ("bfloat16", True, True),
}
TRAIN_LAUNCHES = {
    tier: _flag_launches("_bf16" if dt == "bfloat16" else "",
                         "knn_packed" if dt == "bfloat16" else "knn", store, v4)
    for tier, (dt, store, v4) in TRAIN_TIERS.items()}


def train_config(tier: str):
    from hspose_tpu_torch.config import ModelConfig

    dt, store, v4 = TRAIN_TIERS[tier]
    return ModelConfig(compute_dtype=dt, bwd_store=store, train_v4_small=v4)


def phase_train(smi: str, tier: str = "float32") -> tuple[dict, float]:
    """The train step of one configuration of ``TRAIN_LAUNCHES`` at full
    width: launches, sanity, card against CPU, steps/s.  Returns the
    kernels' launches of the main run and the best steps/s."""
    from hspose_tpu_torch.config import HSPoseConfig
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.models.hspose import draw_train
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    fast = TRAIN_TIERS[tier][0] == "bfloat16"
    phase, name = {"float32": ("train", "fp32"), "bfloat16": ("bf16-train", "bf16"),
                   "v4": ("v4-train", "fp32 bwd_store=False train_v4_small=True"),
                   "bf16v4": ("bf16-v4-train", "bf16 bwd_store=False train_v4_small=True")}[tier]
    cfg = HSPoseConfig(model=train_config(tier))
    model = build_train_model(DEVICE, cfg.model)
    step = build_train_step(cfg, model, torch.Generator(device=DEVICE).manual_seed(SEED))
    batch = to_device(synthetic_train_batch(TRAIN_B, N, seed=SEED), DEVICE)
    before = [p.detach().clone() for p in model.parameters()]

    counts = {**counters(), **train_counters()}
    reset_counts(counts)
    metrics = [step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = read_counts(counts)
    log(phase, f"{TRAIN_STEPS} steps of ({TRAIN_B}, {N}, 3): launches {launches}")
    check_counts(launches, TRAIN_LAUNCHES[tier], wrapper_steps(step, TRAIN_STEPS, 0, 0),
                 "train step")
    for i, m in enumerate(metrics):
        log(phase, f"step {i}: total_loss {m['total_loss']:.6f}, skipped_nan "
                   f"{m['skipped_nan']}, {len(m) - 2} loss terms")
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad or m["skipped_nan"]:
            raise AssertionError(f"step {i}: non-finite {bad}")
    moved = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, model.parameters()))
    change = max((a - p.detach()).abs().max().item() for a, p in zip(before, model.parameters()))
    # at the start of the warm-up the rate is lr * 1e-3, so small steps round away
    log(phase, f"{moved} of {len(before)} parameter tensors moved (largest change "
               f"{change:.3e}), optimizer count {step.optimizer.count}")
    if moved == 0 or step.optimizer.count != TRAIN_STEPS:
        raise AssertionError("the train step did not update the model")

    # one train forward and backward on the card and on the CPU plain ops
    cpu_model = build_train_model("cpu", cfg.model).train()
    card_model = copy.deepcopy(cpu_model).to(DEVICE)
    small = synthetic_train_batch(4, N, seed=SEED + 5)
    draws = draw_train(torch.Generator().manual_seed(SEED + 6), 4, N)
    card = train_once(cfg, copy.deepcopy(card_model), small, draws, DEVICE)
    cpu = train_once(cfg, cpu_model, small, draws, "cpu")
    if not fast:
        (card_loss, _, card_grad), (cpu_loss, _, cpu_grad) = card, cpu
        rel = {k: abs(card_loss[k] - v) / max(abs(v), 1e-12) for k, v in cpu_loss.items()}
        log(phase, "card against CPU, loss terms: worst rel diff "
                   f"{max(rel.values()):.3e} ({max(rel, key=rel.get)})")
        if not max(rel.values()) <= LOSS_REL:
            raise AssertionError(f"losses disagree beyond {LOSS_REL}: "
                                 f"{ {k: v for k, v in rel.items() if v > LOSS_REL} }")
        log(phase, "card against CPU, parameter gradients: " + grad_gates(card_grad, cpu_grad))
    else:
        # the bf16 step is chaotic (KNN, winner and max selections flip under
        # bf16 rounding), so the card is held to its own spread: the same
        # forward with the input cloud moved by SPREAD_EPS relative, both ways
        z = np.random.default_rng(SEED + 7).standard_normal(small["pcl_in"].shape)
        spread = {}
        for sign in (1.0, -1.0):
            moved_pc = (small["pcl_in"] * (1.0 + sign * SPREAD_EPS * z)).astype(np.float32)
            gaps = step_gaps(train_once(cfg, copy.deepcopy(card_model),
                                        dict(small, pcl_in=moved_pc), draws, DEVICE), card)
            spread = {k: max(spread.get(k, 0.0), v) for k, v in gaps.items()}
        gap = step_gaps(card, cpu)
        log(phase, "card against CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in gap.items())
            + "; the card's own spread: " + ", ".join(f"{k} {v:.3e}" for k, v in spread.items())
            + f"; bound {SPREAD_MULT} x spread")
        bad = {k: v for k, v in gap.items() if not v <= SPREAD_MULT * spread[k]}
        if bad:
            raise AssertionError(f"card and CPU disagree beyond {SPREAD_MULT} x the card's "
                                 f"spread: {bad}")

    # throughput
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    iters, rates = 5, []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            step(batch)
        torch.cuda.synchronize()
        rates.append(iters / (time.perf_counter() - t0))
    log(phase, f"{max(rates)} steps/s at B={TRAIN_B} {name} (best of 3 windows of {iters} "
               f"steps: {rates}) on {smi}")
    return launches, max(rates)


def phase_train_flags(tiers=("recompute", "v4only", "bf16recompute", "bf16v4only")) -> None:
    """Each training flag alone, in both tiers: one train forward and
    backward at (16, 1028) on the card, its launch counts exactly
    ``TRAIN_LAUNCHES[tier]``, finite losses and gradients; no throughput."""
    from hspose_tpu_torch.config import HSPoseConfig
    from hspose_tpu_torch.models.hspose import draw_train
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    batch = synthetic_train_batch(TRAIN_B, N, seed=SEED)
    for tier in tiers:
        cfg = HSPoseConfig(model=train_config(tier))
        model = build_train_model(DEVICE, cfg.model).train()
        draws = draw_train(torch.Generator().manual_seed(SEED + 6), TRAIN_B, N)
        counts = {**counters(), **train_counters()}
        reset_counts(counts)
        terms, _, grads = train_once(cfg, model, batch, draws, DEVICE)
        torch.cuda.synchronize()
        launches = read_counts(counts)
        log("train-flags", f"{tier} {cfg.model.compute_dtype} bwd_store={cfg.model.bwd_store} "
                           f"train_v4_small={cfg.model.train_v4_small}: one train forward and "
                           f"backward of ({TRAIN_B}, {N}, 3), total_loss {terms['total']:.6f}, "
                           f"launches { {k: v for k, v in launches.items() if v} }")
        check_counts(launches, TRAIN_LAUNCHES[tier], 1, f"{tier} train step")
        bad = [k for k, v in terms.items() if not np.isfinite(v)]
        bad += [k for k, g in grads.items() if not torch.isfinite(g).all()]
        if bad:
            raise AssertionError(f"{tier}: non-finite {bad}")

# K16/K17 distances: max |kernel - plain| <= CHAMFER_REL * the largest plain
# distance or squared norm of a query point (|a|^2 + |b|^2 - 2 a.b rounds
# relative to the norms, and where the clouds coincide that is all there is)
CHAMFER_REL = 1e-5
ARGMIN_AGREE = 0.999  # K17: share of argmins equal to the plain version's
ARGMIN_GAP = 1e-6  # K17: where they differ, the exact distances at the two indices
HARNESS_BATCHES = 3  # the gated run
# the timed run: the harness leaves its first batch out of the time and
# fetches a batch after submitting the next, so over 3 batches it times the
# third and the tail of the second only
HARNESS_RATE_BATCHES = 20
N_LARGE = 2056  # the smallest padded N > 2048 at which the JAX package streams (K5)


def chamfer_clouds(rng, m: int, duplicates: bool = False):
    """Two (B, N, 3) / (B, m, 3) clouds; with ``duplicates`` b holds points of
    a, each twice or more (exact zero distances and ties)."""
    a = cloud(rng, N)
    if not duplicates:
        return a, (cloud(rng, m) + 0.05).contiguous()
    pick = torch.from_numpy(rng.integers(0, N // 2, (B, m))).to(DEVICE)
    return a, torch.gather(a, 1, pick[..., None].expand(B, m, 3)).contiguous()


def library_min_ms(a, b) -> float:
    """One PyTorch expression for a direction's minimum and argmin, timed."""
    return cuda_ms(lambda: torch.cdist(a, b).pow(2).min(-1))


def phase_chamfer() -> tuple[dict, dict]:
    """K16, K17 and K18 against their plain versions at the recon tier's
    shape (B, N) x (B, N), at (B, N) x (B, 700) and on a cloud with
    duplicated points: distances within CHAMFER_REL of the largest distance
    or query norm, argmins
    equal on >= ARGMIN_AGREE and within ARGMIN_GAP in exact distance where
    not, gradients within TOL_REL of the largest, K18 twice bit for bit.
    Records the recon shape's two directions per kernel, with the time of
    ``torch.cdist(a, b).pow(2).min(-1)`` as K16's and K17's library call.
    Then one autograd call of ``chamfer_distance``, K17's and K18's carrier
    (the harness runs K16 only): returns (records, its launches)."""
    from hspose_tpu_torch.ops import chamfer as ch

    phase = "chamfer"
    rng = np.random.default_rng(SEED + 7)
    rec = {}
    for label, m, dup in (("recon", N, False), ("uneven", 700, False), ("duplicates", N, True)):
        a, b = chamfer_clouds(rng, m, dup)
        mains = label == "recon"
        args = {}
        for x, y, what in ((a, b, "a->b"), (b, a, "b->a")):
            d16 = ch.chamfer_min_cuda(x, y)
            d17, i17 = ch.chamfer_min_argmin_cuda(x, y)
            want_d, want_i = ch.chamfer_min_argmin(x, y)
            torch.cuda.synchronize()
            scale = max(want_d.abs().max().item(), (x * x).sum(-1).max().item())
            errs = [(d - want_d).abs().max().item() for d in (d16, d17)]
            exact = ((x.double()[:, :, None] - y.double()[:, None]) ** 2).sum(-1)
            agree = (i17 == want_i).double().mean().item()
            at = [exact.gather(2, i.long()[..., None]) for i in (i17, want_i)]
            gap = (at[0] - at[1]).abs().max().item()
            log(phase, f"{label} ({B}, {x.shape[1]}) -> ({B}, {y.shape[1]}) {what}: K16 max abs "
                       f"err {errs[0]:.3e}, K17 {errs[1]:.3e} (bound {CHAMFER_REL * scale:.3e}); "
                       f"argmin agreement {agree:.6f}, largest exact-distance gap {gap:.3e}")
            if max(errs) > CHAMFER_REL * scale or agree < ARGMIN_AGREE or gap > ARGMIN_GAP:
                raise AssertionError(f"chamfer {label} {what}: errors {errs}, agreement {agree}, "
                                     f"gap {gap}")
            args[what] = (d17, i17)
            if mains:
                macs = B * x.shape[1] * y.shape[1] * 3  # the inner product of each pair
                lib = library_min_ms(x, y)
                record(rec, "chamfer_min", errs[0], cuda_ms(lambda: ch.chamfer_min_cuda(x, y)),
                       cuda_ms(lambda: ch.chamfer_min(x, y)),
                       bound([x, y, d16], macs, torch.float32))
                record(rec, "chamfer_min_argmin", errs[1],
                       cuda_ms(lambda: ch.chamfer_min_argmin_cuda(x, y)),
                       cuda_ms(lambda: ch.chamfer_min_argmin(x, y)),
                       bound([x, y, d17, i17], macs, torch.float32))
                for name, fn, outs in (("chamfer_min", ch.chamfer_min_cuda, [d16]),
                                       ("chamfer_min_argmin", ch.chamfer_min_argmin_cuda,
                                        [d17, i17])):
                    launch_parts(phase, rec[name], f"{name} {label} {what}",
                                 lambda: fn(x, y), {"search": bound([x, y, *outs], macs,
                                                                    torch.float32)},
                                 CHAMFER_PARTS[name])
                for name in ("chamfer_min", "chamfer_min_argmin"):
                    rec[name]["library_ms"] = (rec[name]["library_ms"] or 0.0) + lib
        ia, ib = args["a->b"][1], args["b->a"][1]
        gda, gdb = normal(rng, B, N), normal(rng, B, m)
        for x, y, ix, iy, gx, gy, what in ((a, b, ia, ib, gda, gdb, "ga"),
                                           (b, a, ib, ia, gdb, gda, "gb")):
            got = ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy)
            again = ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy)
            want = ch.chamfer_grad(x, y, ix, iy, gx, gy)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"chamfer_grad {label} {what}: two launches differ")
            ms = cuda_ms(lambda: ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy)) if mains else 0.0
            pms = cuda_ms(lambda: ch.chamfer_grad(x, y, ix, iy, gx, gy)) if mains else 0.0
            bnd = compare_cotangents(phase, rec if mains else {}, "chamfer_grad",
                                     f"{label} {what} (twice, same bits)", [(what, got, want)],
                                     ms, pms, [x, y, ix, iy, gx, gy], 0)
            if mains:  # one launch a call: launch_parts raises on an inverse_index_kernel
                launch_parts(phase, rec["chamfer_grad"], f"chamfer_grad {label} {what}",
                             lambda: ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy), {"grad": bnd},
                             CHAMFER_PARTS["chamfer_grad"])

    # K18 where the lists are long, (4, 5000) x (4, 300), and where all 3000
    # points of b share one nearest point of a (far off the cloud): that
    # tile's list takes two windows
    for label, n, m, far in (("long lists", 5000, 300, False), ("one nearest point", N, 3000, True)):
        a = normal(rng, 4, n, 3, scale=0.2)
        b = (normal(rng, 4, m, 3, scale=0.01) + 5.0) if far else normal(rng, 4, m, 3, scale=0.2)
        ia, ib = ch.chamfer_min_argmin_cuda(a, b)[1], ch.chamfer_min_argmin_cuda(b, a)[1]
        if far and not bool((ib == ib[:, :1]).all()):
            raise AssertionError("chamfer_grad one nearest point: the points of b do not share one")
        gda, gdb = normal(rng, 4, n), normal(rng, 4, m)
        for x, y, ix, iy, gx, gy, what in ((a, b, ia, ib, gda, gdb, "ga"),
                                           (b, a, ib, ia, gdb, gda, "gb")):
            got = ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy)
            same_bits("chamfer_grad", f"{label} {what}", (got,),
                      (ch.chamfer_grad_cuda(x, y, ix, iy, gx, gy),))
            compare_cotangents(phase, {}, "chamfer_grad", f"(4, {n}) x (4, {m}) {label} {what} "
                               "(twice, same bits)",
                               [(what, got, ch.chamfer_grad(x, y, ix, iy, gx, gy))], None, 0.0,
                               [], 0)

    # the differentiable call: K17 twice, then K18 once per cloud
    a, b = chamfer_clouds(rng, N)
    counts = counters()
    reset_counts(counts)
    a.requires_grad_(True)
    b.requires_grad_(True)
    da, db = ch.chamfer_distance(a, b)
    gda, gdb = normal(rng, B, N), normal(rng, B, N)
    torch.autograd.backward((da, db), (gda, gdb))
    torch.cuda.synchronize()
    launches = read_counts(counts)
    check_counts(launches, {"chamfer_min_argmin": 2, "chamfer_grad": 2}, 1, "autograd call")
    with torch.no_grad():
        _, ia = ch.chamfer_min_argmin(a, b)
        _, ib = ch.chamfer_min_argmin(b, a)
        want = ch.chamfer_grad(a.detach(), b.detach(), ia, ib, gda, gdb)
    err = (a.grad - want).abs().max().item()
    log(phase, f"autograd chamfer_distance ({B}, {N}) x ({B}, {N}): launches "
               f"{ {k: v for k, v in launches.items() if v} }, ga against the plain VJP {err:.3e} "
               f"(bound {TOL_REL * want.abs().max().item():.3e})")
    if not err <= TOL_REL * want.abs().max().item():
        raise AssertionError(f"autograd chamfer_distance: ga error {err}")
    return rec, launches


def harness_records(rng, n_pts: int, batches: int) -> list:
    """In-memory eval records: ``batches`` * B crops of n_pts points, four
    detections per image, with categories, symmetry, mean shapes and gt."""
    from hspose_tpu_torch.geometry.symmetry import CAT_NAMES, mean_shape_mm, sym_info

    records = []
    for _ in range(batches * B // 4):
        cat = rng.integers(0, 6, 4)
        gt_RTs = np.tile(np.eye(4), (4, 1, 1))
        gt_RTs[:, :3, :3] = np.linalg.qr(rng.normal(size=(4, 3, 3)))[0]
        gt_RTs[:, :3, 3] = rng.normal(scale=0.1, size=(4, 3)) + [0.0, 0.0, 0.7]
        pcl = (rng.normal(scale=0.05, size=(4, n_pts, 3)) + gt_RTs[:, None, :3, 3])
        data = {"cat_id_0base": cat.astype(np.int32),
                "sym_info": np.stack([sym_info(CAT_NAMES[c]) for c in cat]).astype(np.float32),
                "mean_shape": np.stack([mean_shape_mm(CAT_NAMES[c]) for c in cat]) / 1000.0,
                "pcl_in": pcl.astype(np.float32)}
        det = {"pred_class_ids": cat + 1, "pred_scores": rng.uniform(0.5, 1.0, 4)}
        gts = {"gt_class_ids": cat + 1, "gt_RTs": gt_RTs,
               "gt_scales": rng.uniform(0.05, 0.3, (4, 3)), "gt_handle_visibility": np.ones(4)}
        records.append((data, det, gts))
    return records


def harness_config(dtype: str = "float32", recon: bool = False, n_pts: int = N):
    from hspose_tpu_torch.config import DataConfig, EvalConfig, HSPoseConfig, ModelConfig

    return HSPoseConfig(data=DataConfig(num_points=n_pts), model=ModelConfig(compute_dtype=dtype),
                        eval=EvalConfig(eval_batch=B, recon=recon))


def run_harness(cfg, model, records, seed: int):
    """``batched_pose_inference`` on a copy of ``records``: (pred_results,
    crops/s)."""
    from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference

    out = batched_pose_inference(cfg, model, copy.deepcopy(records), seed)
    torch.cuda.synchronize()
    return out


def phase_harness(smi: str, rates: dict | None = None) -> dict:
    """The eval harness on in-memory records, HARNESS_BATCHES batches of
    (B, N): fp32, bf16, and fp32 with ``eval.recon`` on a model with the
    train heads (the same backbone and pose-head weights).  Gates: exact
    launch counts per batch, the graph replays' kernels by name
    (``check_served``), recon's eager launches by its wrappers (K16 twice
    and no K17/K18); the fp32
    poses bit for bit those of ``eval_forward`` + ``generate_RT`` on the same
    crops and pool samples, and the recon run's poses those of the fp32 run;
    chamfer and EMD finite and positive; then ``compute_degree_cm_mAP``.
    Prints the harness's crops/s over HARNESS_RATE_BATCHES batches beside
    the forward alone's (``rates``, when given) and the recon tier's chamfer and EMD ms
    per batch.  Returns the recon
    run's launches."""
    from hspose_tpu_torch.evaluation.evaluate import report_lines
    from hspose_tpu_torch.evaluation.metrics import compute_degree_cm_mAP
    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.geometry.symmetry import SYNSET_NAMES
    from hspose_tpu_torch.models.hspose import draw_pool_samples, eval_forward
    from hspose_tpu_torch.ops.chamfer import chamfer_distance
    from hspose_tpu_torch.ops.emd import emd_distance

    phase, seed = "harness", SEED + 8
    records = harness_records(np.random.default_rng(SEED + 9), N, HARNESS_BATCHES)
    rate_records = harness_records(np.random.default_rng(SEED + 12), N, HARNESS_RATE_BATCHES)
    model = build_seeded_model(DEVICE)
    preds = {}
    for tier, dtype, recon in (("fp32", "float32", False), ("bf16", "bfloat16", False),
                               ("fp32 recon", "float32", True)):
        cfg = harness_config(dtype, recon)
        if recon:
            m = build_train_model(DEVICE, cfg.model).eval()
            missing = m.load_state_dict(model.state_dict(), strict=False).missing_keys
            if any(".".join(k.split(".")[:2]) not in ("face_recon.conv1d_block",
                                                      "face_recon.recon_head",
                                                      "face_recon.face_head") for k in missing):
                raise AssertionError(f"the recon model lacks backbone weights: {missing}")
        else:
            m = model if dtype == "float32" else build_seeded_model(DEVICE, dtype)
        # warm: the first call of each tier builds caches and captures the graph
        run_harness(cfg, m, records, seed)
        s = served(lambda: run_harness(cfg, m, records, seed))
        preds[tier], launches = s.result[0], s.launches
        log(phase, f"{tier}: {HARNESS_BATCHES} batches of ({B}, {N}, 3), graph replays "
                   f"{s.replays}, kernels {s.kernels}, wrapper launches "
                   f"{ {k: v for k, v in launches.items() if v} }")
        if recon:  # with_heads: the eager route, every launch through a wrapper
            if s.replays or s.captures:
                raise AssertionError(f"{tier}: {s.replays} graph replays, {s.captures} captures")
            check_counts(launches, dict(SERVE_LAUNCHES[dtype], chamfer_min=2), HARNESS_BATCHES,
                         f"{tier} harness batch")
        else:
            check_served(s, SERVE_LAUNCHES[dtype], HARNESS_BATCHES, f"{tier} harness batch",
                         warm=True)
        _, rate = run_harness(cfg, m, rate_records, seed)
        alone = f" (forward alone {rates[dtype]:.1f} crops/s)" if rates else ""
        log(phase, f"{tier}: {rate} crops/s over {HARNESS_RATE_BATCHES} batches of ({B}, {N}, 3)"
                   f"{alone} on {smi}")
        if recon:
            recon_launches = launches

    def flat(results, key):
        return np.concatenate([r[key] for r in results])

    # the fp32 harness against the forward alone, on the same crops and samples
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    crops = np.concatenate([d["pcl_in"] for d, _, _ in records])
    obj = np.concatenate([d["cat_id_0base"] for d, _, _ in records])
    sym = np.concatenate([d["sym_info"] for d, _, _ in records])
    mean = np.concatenate([d["mean_shape"] for d, _, _ in records]).astype(np.float32)
    RTs, scales = [], []
    for i in range(HARNESS_BATCHES):
        rows = slice(i * B, (i + 1) * B)
        pc = torch.from_numpy(crops[rows]).to(DEVICE)
        out = eval_forward(model, pc, torch.from_numpy(obj[rows]).to(DEVICE),
                           pool_samples=draw_pool_samples(N, gen, DEVICE))
        RTs.append(generate_RT(out.p_green_R, out.p_red_R, out.f_green_R, out.f_red_R,
                               out.pred_T, torch.from_numpy(sym[rows]).to(DEVICE)).cpu())
        scales.append((out.pred_s + torch.from_numpy(mean[rows]).to(DEVICE)).cpu())
    same = {"fp32 RT": np.array_equal(flat(preds["fp32"], "pred_RTs"), torch.cat(RTs).double()),
            "fp32 scales": np.array_equal(flat(preds["fp32"], "pred_scales"),
                                          torch.cat(scales).double()),
            "recon RT": np.array_equal(flat(preds["fp32 recon"], "pred_RTs"),
                                       flat(preds["fp32"], "pred_RTs"))}
    dev = np.abs(flat(preds["bf16"], "pred_RTs") - flat(preds["fp32"], "pred_RTs")).max()
    cmf = flat(preds["fp32 recon"], "chamfer_dis_cass")
    emd = flat(preds["fp32 recon"], "emd_dis_cass")
    log(phase, f"bit for bit against eval_forward + generate_RT: {same}; bf16 against fp32 "
               f"poses max abs {dev:.3e}; chamfer {cmf.min():.4e} .. {cmf.max():.4e}, EMD "
               f"{emd.min():.4e} .. {emd.max():.4e}")
    if not all(same.values()):
        raise AssertionError(f"the harness's poses are not the forward's: {same}")
    if not (np.isfinite(cmf).all() and np.isfinite(emd).all() and (cmf > 0).all()
            and (emd > 0).all()):
        raise AssertionError("chamfer or EMD not finite and positive")

    grids = (list(range(0, 61)), [i / 2 for i in range(21)], [i / 100 for i in range(101)])
    iou_aps, pose_aps = compute_degree_cm_mAP(preds["fp32"], SYNSET_NAMES, None, *grids,
                                              iou_pose_thres=0.1, use_matches_for_pose=True,
                                              plot_figure=False)
    log(phase, "fp32 mean table (random weights): " + "; ".join(
        report_lines(iou_aps, pose_aps, grids[0] + [360], grids[1] + [100], grids[2])[1:]))

    # the recon tier's cost per batch, on the recon model's cloud for batch 0
    m = build_train_model(DEVICE, harness_config(recon=True).model).eval()
    pc = torch.from_numpy(crops[:B]).to(DEVICE)
    out = eval_forward(m, pc, torch.from_numpy(obj[:B]).to(DEVICE),
                       generator=torch.Generator(device=DEVICE).manual_seed(seed), with_heads=True)
    recon = out.recon.float()
    cfg = harness_config(recon=True)
    with torch.no_grad():
        cmf_ms = cuda_ms(lambda: chamfer_distance(recon, pc))
        emd_ms = cuda_ms(lambda: emd_distance(recon, pc, cfg.eval.emd_epsilon, cfg.eval.emd_iters),
                         iters=5, warmup=1)
    log(phase, f"recon tier per batch of ({B}, {N}): chamfer {cmf_ms:.4f} ms (K16 twice), "
               f"Sinkhorn EMD {emd_ms:.3f} ms ({cfg.eval.emd_iters} sweeps) on {smi}")
    return recon_launches


def phase_k5(smi: str) -> tuple[dict, dict]:
    """K5, the JAX package's streamed KNN above padded N = 2048, covered by
    the exact kernel: the three full-N searches of a forward (xyz k=20,
    features k=20, xyz k=4) at N = 2056 and 4096 against the plain version,
    and the feature search on bf16 points, which the wrapper widens to
    fp32; then one fp32 harness batch at ``data.num_points=2056`` with its
    exact launch counts.  Records the N = 2056 forward's three searches;
    returns (records, the batch's launches)."""
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, knn_indices

    phase = "k5"
    rng = np.random.default_rng(SEED + 10)
    rec = {}
    for n in (N_LARGE, 4096):
        for d, k, dtype in ((3, 20, torch.float32), (128, 20, torch.float32), (3, 4, torch.float32),
                            (128, 20, torch.bfloat16)):
            pts = cloud(rng, n) if d == 3 else normal(rng, B, n, d).to(dtype)
            got = knn_indices_cuda(pts, k, packed=dtype == torch.bfloat16)
            want = knn_indices(pts.float(), k)
            torch.cuda.synchronize()
            agree = (got[..., :, None] == want[..., None, :]).any(-1).double().mean().item()
            p64 = pts.double()

            def sorted_d(idx):
                diff = gather_neighbors(p64, idx) - p64[:, :, None]
                return (diff * diff).sum(-1).sort(-1).values

            dg, dw = sorted_d(got), sorted_d(want)
            err = (dg - dw).abs().max().item()
            rel = ((dg - dw).abs() / dw.clamp_min(1e-30)).max().item()
            ms = cuda_ms(lambda: knn_indices_cuda(pts, k, packed=dtype == torch.bfloat16), iters=5)
            pms = cuda_ms(lambda: knn_indices(pts.float(), k), iters=3, warmup=1)
            log(phase, f"exact KNN N={n} D={d} {dtype} k={k}: agreement {agree:.6f}, max rel "
                       f"distance gap {rel:.3e}, {ms:.4f} ms (plain {pms:.4f} ms) on {smi}")
            if agree < KNN_AGREE or rel > KNN_TIE_REL:
                raise AssertionError(f"exact KNN N={n} D={d} k={k}: agreement {agree}, gap {rel}")
            if n == N_LARGE and dtype == torch.float32:
                record(rec, "knn_streamed", err, ms, pms,
                       bound([pts, got], B * n * n * d, torch.float32))

    cfg = harness_config(n_pts=N_LARGE)
    records = harness_records(np.random.default_rng(SEED + 11), N_LARGE, 1)
    model = build_seeded_model(DEVICE)
    run_harness(cfg, model, records, SEED)  # warm: the graph's capture
    s = served(lambda: run_harness(cfg, model, records, SEED))
    preds = s.result[0]
    log(phase, f"one fp32 harness batch of ({B}, {N_LARGE}, 3): graph replays {s.replays}, "
               f"kernels {s.kernels}")
    per_forward = {"knn": 6, "knn_streamed": 3, "hs_surface": 1, "hs_support": 4,
                   "orl_global": 5, "heads_epilogue": 1}
    check_served(s, per_forward, 1, f"N={N_LARGE} harness batch", warm=True)
    launches = {**s.launches, **per_forward}  # the launches the replay stands for
    RT = np.concatenate([r["pred_RTs"] for r in preds])
    if not np.isfinite(RT).all():
        raise AssertionError(f"N={N_LARGE}: poses not finite")
    return rec, launches


# K4's calls off the B=24, N=1028 forward, (B, N, C, K): the N = 2056 harness
# forward's five ORL branches (64-byte rows, the neighbour lists read through
# L1 at N = 2056), 16-byte rows with the lists staged (B=4, N=2056) and read
# through L1 (N=5000, K=8), and a K read at run time
ORL_SHAPES = [(B, N_LARGE, 128, 20), (B, N_LARGE, 128, 20), (B, N_LARGE // 4, 256, 20),
              (B, N_LARGE // 4, 256, 20), (B, N_LARGE // 16, 512, 8), (4, N_LARGE, 128, 20),
              (2, 5000, 64, 8), (3, 33, 256, 5)]
# K10's calls off the v4 step, (B, N, C, K): idx staged and one block of rows
# (N = 1028), idx read through L1 and the rows split over blocks (N = 2056,
# 20000), idx staged and the rows split (N = 5000, with a part-full channel
# slice), a C that is not a multiple of 4 (4-byte loads), and N*K odd (idx
# copied 4 bytes at a time)
K10_SHAPES = [(2, N, 128, 20), (2, N_LARGE, 64, 20), (2, 5000, 48, 5), (3, 257, 50, 20),
              (2, 20000, 32, 8), (3, 33, 36, 7)]
# K2's calls off the forward, (B, N, K, S, Co): S and K read at run time (the
# supports held eight at a time), and Co below 128 (queries side by side)
SURFACE_SHAPES = [(4, 300, 12, 10, 64), (3, 200, 20, 3, 96), (2, N, 20, 9, 128),
                  (2, 130, 7, 7, 40), (2, 100, 20, 7, 40)]


def phase_k2k4_shapes() -> None:
    """K2 and K4 at shapes off the B=24, N=1028 forward, so that each branch
    of their launches runs on the card (ORL_SHAPES, SURFACE_SHAPES, and one
    ORL call on an index tensor 4 bytes off 16-byte alignment), in fp32 and
    bf16: each serving call against its plain version within TOL_REL of
    the largest value, the forward with winners bit for bit the serving
    kernel's, its winners against the plain version's as in phase 8; K10
    at K10_SHAPES in both tiers against its plain version (phase 12's
    gates) and twice with the same bits; and features off 16-byte
    alignment must be refused."""
    from hspose_tpu_torch.ops import cuda_hs_fused as f
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized

    phase = "k2k4-shapes"
    rng = np.random.default_rng(SEED + 12)

    def close(name, label, got, want):
        torch.cuda.synchronize()
        scale, err = want.abs().max().item(), (got - want).abs().max().item()
        log(phase, f"{name} {label}: max abs err {err:.3e} (bound {TOL_REL * scale:.3e})")
        if not (err <= TOL_REL * scale and got.dtype == torch.float32):
            raise AssertionError(f"{name} {label}: error {err} > {TOL_REL} * {scale}")

    def at_win(x, win):  # x (B, N, K, C) at each column's winner
        return x.gather(2, win.long()[:, :, None]).squeeze(2)

    def off16(t):  # a contiguous copy of t 4 bytes off 16-byte alignment
        buf = torch.empty(t.numel() * t.element_size() + 4, dtype=torch.uint8, device=t.device)
        out = buf[4:].view(t.dtype).view(t.shape)
        out.copy_(t)
        return out

    orl_cases = [(shape, False) for shape in ORL_SHAPES] + [((2, 300, 128, 20), True)]
    for (b, n, c, k), unaligned in orl_cases:
        idx = knn_indices_cuda(cloud_b(rng, b, n), k)
        if unaligned:
            idx = off16(idx)
        for fast in (False, True):
            feat = normal(rng, b, n, c).to(torch.bfloat16 if fast else torch.float32)
            label = (f"B={b} N={n} C={c} K={k} {feat.dtype}"
                     + (" idx off 16-byte alignment" if unaligned else ""))
            got = f.orl_global_fused(feat, idx)
            close("orl_global", label, got, f.orl_global_plain(feat, idx))
            (out_k, win_k), (_, win_p) = (f.orl_global_fused_fwd(feat, idx),
                                          f.orl_global_fused_fwd_plain(feat, idx))
            same_bits("orl_global_fused_fwd", label + " (against the serving kernel)",
                      (out_k,), (got,))
            rows = gather_neighbors(feat, idx).float()
            check_winners(phase, "orl_global_fused_fwd", label, win_k, win_p,
                          at_win(rows, win_k), at_win(rows, win_p))
            del rows

    for b, n, k, S, co in SURFACE_SHAPES:
        verts = cloud_b(rng, b, n)
        idx = knn_indices_cuda(verts, k)
        dirs = unit_dirs(rng, S * co)
        for exact in (True, False):
            label = f"B={b} N={n} K={k} S={S} Co={co} exact={exact}"
            args = (verts, idx, dirs, S, co)
            got = f.hs_surface_fused(*args, exact=exact)
            close("hs_surface", label, got, f.hs_surface_plain(*args, exact=exact))
            (out_k, win_k), (_, win_p) = (f.hs_surface_fused_fwd(*args, exact=exact),
                                          f.hs_surface_fused_fwd_plain(*args, exact=exact))
            same_bits("hs_surface_fused_fwd", label + " (against the serving kernel)",
                      (out_k,), (got,))
            if exact:
                theta = torch.relu(neighbor_directions_normalized(verts, idx) @ dirs)
            else:
                theta = f._theta_fast(f._rf_fast(verts, idx), f._bf16(dirs))
            check_winners(phase, "hs_surface_fused_fwd", label, win_k, win_p,
                          at_win(theta, win_k), at_win(theta, win_p))

    # K10 on neighbour lists that name rows twice and on random winners, so
    # that every branch of its launch plan runs
    for b, n, c, k in K10_SHAPES:
        idx = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(np.int32)).to(DEVICE)
        idx[:, :, k // 2] = idx[:, :, 0]
        win = torch.from_numpy(rng.integers(0, k, (b, n, c)).astype(np.int32)).to(DEVICE)
        gb = normal(rng, b, 1, c)
        for dtype in (torch.float32, torch.bfloat16):
            label = f"B={b} N={n} C={c} K={k} {dtype}"
            got = f.orl_global_fused_bwd(idx, win, gb, dtype)
            same_bits("orl_global_fused_bwd", label + " (twice)", (got,),
                      (f.orl_global_fused_bwd(idx, win, gb, dtype),))
            compare_cotangents(phase, {}, "orl_global_fused_bwd", label,
                               [("dfeat", got, f.orl_global_fused_bwd_plain(idx, win, gb, dtype))],
                               None, 0.0, [], 0)

    feat = off16(normal(rng, 2, 300, 128))
    try:
        f.orl_global_fused(feat, knn_indices_cuda(cloud_b(rng, 2, 300), 20))
    except RuntimeError as err:
        log(phase, f"orl_global on features off 16-byte alignment: refused ({err})")
    else:
        raise AssertionError("orl_global took features off 16-byte alignment")


# K13's and K14's calls off the step, (K, Cin, Co, S): K under each template
# width (8, 20, 32), Cin beyond one 128-channel block, S*Co in column tiles
# of 192, 256 and 256; at B=3, N=1001 the rows are a multiple of no tile
SUPPORT_BWD_SHAPES = [(5, 132, 128, 3), (31, 128, 512, 7), (20, 256, 256, 9)]
# K12's and K15's calls off the step, (K, S, Co): K and S read at run time
# (S = 9, 10: the supports held eight at a time), other widths, and at B=3,
# N=1001 a part-full last block and tile
SURFACE_TRAIN_SHAPES = [(5, 3, 64), (31, 9, 128), (12, 10, 96)]


def phase_k13k14_shapes() -> None:
    """K13 and K14 at shapes off the B=16 step (SUPPORT_BWD_SHAPES, B=3,
    N=1001), in fp32 and bf16, so that each branch of their launches runs on
    the card: K13 against its plain version at phase 8's gates (phase 10's in
    bf16), K14 bit for bit K13 on the forward's stored values, each launched
    twice with the same bits; and K12 and K15 at SURFACE_TRAIN_SHAPES, B=3,
    N=1001, against their plain versions with the same gates, each twice
    with the same bits."""
    from hspose_tpu_torch.ops import cuda_hs
    from hspose_tpu_torch.ops.knn import gather_neighbors, knn_indices, neighbor_directions_normalized

    phase = "k13k14-shapes"
    rng = np.random.default_rng(SEED + 13)
    b, n = 3, 1001
    for k, cin, co, S in SUPPORT_BWD_SHAPES:
        for op in (torch.float32, torch.bfloat16):
            label = f"B={b} N={n} K={k} Cin={cin} Co={co} S={S} {op}"
            feat = torch.relu(normal(rng, b, n, cin))
            idx = knn_indices(feat, k)
            src = {"feat": feat.to(op), "idx": idx}
            g = gather_neighbors(src["feat"], idx)
            rf = neighbor_directions_normalized(cloud_b(rng, b, n).to(op), idx)
            stdv = 1.0 / (co * (S + 1)) ** 0.5
            w = normal(rng, cin, (S + 1) * co, scale=stdv)
            bias = normal(rng, (S + 1) * co, scale=stdv)
            dirs = unit_dirs(rng, S * co).to(op)
            fargs = (g, rf, w[:, co:], bias[co:], dirs, S, co)
            out, win, tw, pw = cuda_hs.hs_support_fwd(*fargs, **src)
            same_bits("hs_support_fwd", label, (out, win, tw, pw),
                      cuda_hs.hs_support_fwd(*fargs, **src))
            same_bits("hs_support_fwd_novals", label + " (against the stored launch)",
                      (out, win), cuda_hs.hs_support_fwd(*fargs, store=False, **src))
            out_p, win_p, tw_p, pw_p = cuda_hs.hs_support_fwd_plain(*fargs)
            check_winners(phase, "hs_support_fwd", label, win, win_p, tw * pw, tw_p * pw_p)
            agree = win == win_p
            compare_cotangents(phase, {}, "hs_support_fwd", label,
                               [("out", out, out_p), ("twin", tw * agree, tw_p * agree),
                                ("pwin", pw * agree, pw_p * agree)], None, 0.0, [], 0)
            gb = normal(rng, b, n, co)
            bargs = (g, rf, w[:, co:], dirs, win, tw, pw, gb, S, co)
            got = cuda_hs.hs_support_bwd(*bargs)
            same_bits("hs_support_bwd", label, got, cuda_hs.hs_support_bwd(*bargs))
            compare_cotangents(phase, {}, "hs_support_bwd", label,
                               list(zip(("dg", "drf", "dw", "db", "dd"), got,
                                        cuda_hs.hs_support_bwd_plain(*bargs))), None, 0.0, [], 0)
            rargs = (g, rf, w[:, co:], bias[co:], dirs, win, gb, S, co)
            k14 = cuda_hs.hs_support_bwd_recompute(*rargs)
            same_bits("hs_support_bwd_recompute", label, k14,
                      cuda_hs.hs_support_bwd_recompute(*rargs))
            same_bits("hs_support_bwd_recompute", label + " (against K13)", k14, got)
            log(phase, f"hs_support_bwd_recompute {label}: K13's bits, twice")
    for k, S, co in SURFACE_TRAIN_SHAPES:
        verts = cloud_b(rng, b, n)
        idx = knn_indices(verts, k)
        for op in (torch.float32, torch.bfloat16):
            label = f"B={b} N={n} K={k} S={S} Co={co} {op}"
            rf = neighbor_directions_normalized(verts.to(op), idx)
            dirs = unit_dirs(rng, S * co).to(op)
            out, win = cuda_hs.hs_surface_fwd(rf, dirs, S, co)
            same_bits("hs_surface_fwd", label, (out, win), cuda_hs.hs_surface_fwd(rf, dirs, S, co))
            out_p, win_p = cuda_hs.hs_surface_fwd_plain(rf, dirs, S, co)
            theta = torch.relu(rf.double() @ dirs.double())
            at = [theta.gather(2, w.long()[:, :, None]).squeeze(2) for w in (win, win_p)]
            check_winners(phase, "hs_surface_fwd", label, win, win_p, *at)
            del theta, at
            compare_cotangents(phase, {}, "hs_surface_fwd", label, [("out", out, out_p)], None,
                               0.0, [], 0)
            gb = normal(rng, b, n, co)
            gb[:, ::7] = 0.0  # rows whose every column routes nothing
            args = (rf, dirs, win, gb, S, co)
            got = cuda_hs.hs_surface_bwd(*args)
            same_bits("hs_surface_bwd", label, got, cuda_hs.hs_surface_bwd(*args))
            compare_cotangents(phase, {}, "hs_surface_bwd", label,
                               list(zip(("drf", "dd"), got, cuda_hs.hs_surface_bwd_plain(*args))),
                               None, 0.0, [], 0)
            log(phase, f"hs_surface_fwd, hs_surface_bwd {label}: twice the same bits")


# kernel -> (source, the TPU kernel it replaces, the record and counter it
# shares, when another kernel of the line ports the same function)
SOURCES = {
    "knn": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:163", None),
    # K6, the lane-major layout of the same exact search (no caller passes tmaj=False)
    "knn_lane_major": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:64",
                       "knn"),
    "hs_surface": ("hspose_tpu_torch/csrc/hs_surface.cu",
                   "hspose_tpu/ops/pallas_hs_fused.py:299", None),
    "hs_support": ("hspose_tpu_torch/csrc/hs_support.cu",
                   "hspose_tpu/ops/pallas_hs_fused.py:219", None),
    "orl_global": ("hspose_tpu_torch/csrc/orl.cu", "hspose_tpu/ops/pallas_hs_fused.py:358",
                   None),
    # the bf16 tier: K1's packed-key branch, and the exact=False branches of
    # K2-K4, the same sources instantiated for bf16
    "knn_packed": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:213", None),
    # K7, the lane-major layout of the same packed-key search
    "knn_packed_lane_major": ("hspose_tpu_torch/csrc/knn.cu",
                              "hspose_tpu/ops/pallas_knn.py:91", "knn_packed"),
    "hs_surface_bf16": ("hspose_tpu_torch/csrc/hs_surface.cu",
                        "hspose_tpu/ops/pallas_hs_fused.py:299", None),
    "hs_support_bf16": ("hspose_tpu_torch/csrc/hs_support.cu",
                        "hspose_tpu/ops/pallas_hs_fused.py:219", None),
    "orl_global_bf16": ("hspose_tpu_torch/csrc/orl.cu",
                        "hspose_tpu/ops/pallas_hs_fused.py:358", None),
    # training: K11, K12, K13, K15, fp32 (exact=True) and bf16 (exact=False)
    **{name + tag: (src, rep, None)
       for tag in ("", "_bf16")
       for name, src, rep in [
           ("hs_support_fwd", "hspose_tpu_torch/csrc/hs_support_train.cu",
            "hspose_tpu/ops/pallas_hs.py:151"),
           ("hs_surface_fwd", "hspose_tpu_torch/csrc/hs_surface_train.cu",
            "hspose_tpu/ops/pallas_hs.py:215"),
           ("hs_support_bwd", "hspose_tpu_torch/csrc/hs_support_train.cu",
            "hspose_tpu/ops/pallas_hs.py:336"),
           ("hs_surface_bwd", "hspose_tpu_torch/csrc/hs_surface_train.cu",
            "hspose_tpu/ops/pallas_hs.py:410")]},
    # bwd_store=False: K11 without winner values, K14 (fp32)
    "hs_support_fwd_novals": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                              "hspose_tpu/ops/pallas_hs.py:151", None),
    "hs_support_bwd_recompute": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                                 "hspose_tpu/ops/pallas_hs.py:240", None),
    # the fused ops' VJPs (fp32): K2-K4 with want_win, K9, K8, K10
    **{name: (src, "hspose_tpu/ops/pallas_hs_fused.py:" + line, None)
       for name, src, line in [
           ("hs_surface_fused_fwd", "hspose_tpu_torch/csrc/hs_surface.cu", "299"),
           ("hs_surface_fused_bwd", "hspose_tpu_torch/csrc/hs_surface.cu", "493"),
           ("hs_support_fused_fwd", "hspose_tpu_torch/csrc/hs_support.cu", "219"),
           ("hs_support_fused_bwd", "hspose_tpu_torch/csrc/hs_support.cu", "420"),
           ("orl_global_fused_fwd", "hspose_tpu_torch/csrc/orl.cu", "358"),
           ("orl_global_fused_bwd", "hspose_tpu_torch/csrc/orl.cu", "544")]},
    # bf16 training under the flags (exact=False): K11 without winner values,
    # K14, and the fused ops' K2-K4 with want_win, K9, K8, K10
    "hs_support_fwd_novals_bf16": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                                   "hspose_tpu/ops/pallas_hs.py:151", None),
    "hs_support_bwd_recompute_bf16": ("hspose_tpu_torch/csrc/hs_support_train.cu",
                                      "hspose_tpu/ops/pallas_hs.py:240", None),
    **{name + "_bf16": (src, "hspose_tpu/ops/pallas_hs_fused.py:" + line, None)
       for name, src, line in [
           ("hs_surface_fused_fwd", "hspose_tpu_torch/csrc/hs_surface.cu", "299"),
           ("hs_surface_fused_bwd", "hspose_tpu_torch/csrc/hs_surface.cu", "493"),
           ("hs_support_fused_fwd", "hspose_tpu_torch/csrc/hs_support.cu", "219"),
           ("hs_support_fused_bwd", "hspose_tpu_torch/csrc/hs_support.cu", "420"),
           ("orl_global_fused_fwd", "hspose_tpu_torch/csrc/orl.cu", "358"),
           ("orl_global_fused_bwd", "hspose_tpu_torch/csrc/orl.cu", "544")]},
    # the recon tier: K16, K17, K18
    "chamfer_min": ("hspose_tpu_torch/csrc/chamfer.cu", "hspose_tpu/ops/chamfer.py:85", None),
    "chamfer_min_argmin": ("hspose_tpu_torch/csrc/chamfer.cu", "hspose_tpu/ops/chamfer.py:167",
                           None),
    "chamfer_grad": ("hspose_tpu_torch/csrc/chamfer.cu", "hspose_tpu/ops/chamfer.py:216", None),
    # K5, the streamed search above padded N = 2048: the exact kernel
    "knn_streamed": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:119", None),
    # the query-sharded branches of sequence-parallel serving (knn_indices_pallas_qs
    # :426, the vertices_q branches of K2 and K3, K4 with fewer index rows)
    "knn_qs": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:163", None),
    "knn_qs_streamed": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:119", None),
    "knn_qs_packed": ("hspose_tpu_torch/csrc/knn.cu", "hspose_tpu/ops/pallas_knn.py:213", None),
    **{name + tag: (src, "hspose_tpu/ops/pallas_hs_fused.py:" + line, None)
       for tag in ("", "_bf16")
       for name, src, line in [
           ("hs_surface_qs", "hspose_tpu_torch/csrc/hs_surface.cu", "299"),
           ("hs_support_qs", "hspose_tpu_torch/csrc/hs_support.cu", "219"),
           ("orl_global_qs", "hspose_tpu_torch/csrc/orl.cu", "358")]},
}


def kernel_line(rec: dict, launches: dict) -> dict:
    """The ``kernels`` JSON object: every kernel of SOURCES with its
    launches on the main path and its measured numbers."""
    kernels = []
    for name, (src, rep, shares) in SOURCES.items():
        if not launches[shares or name] > 0:
            raise AssertionError(f"{name}: no launch in the main run of its path")
        r = {k: v for k, v in rec[shares or name].items() if not k.startswith("_")}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches[shares or name], **r})
    return {"kernels": kernels}


LOOP_TRAIN, LOOP_TEST = 24, 4  # phase 23's rendered images
LOOP_STEPS, LOOP_EPOCHS = 3, 2
RESUME_LOSS_REL = 1e-3  # a resumed epoch's losses against the unbroken run's


def render_tree(root: str) -> None:
    """Render phase 23's tree of LOOP_TRAIN / LOOP_TEST images into ``root``."""
    import os

    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, os.path.join(here, "hspose_tpu_torch", "tools",
                                                 "make_synth_nocs.py"), root,
                    "--train", str(LOOP_TRAIN), "--test", str(LOOP_TEST)],
                   check=True, capture_output=True, text=True, cwd=here)
    log("loop", f"rendered {LOOP_TRAIN} train / {LOOP_TEST} test images in "
                f"{time.perf_counter() - t0:.1f} s")


def test_crops(tree: str) -> int:
    """The number of detection crops of the tree's test split."""
    import os
    import pickle

    crops = 0
    for name in os.listdir(f"{tree}/segmentation_results/REAL275"):
        with open(f"{tree}/segmentation_results/REAL275/{name}", "rb") as f:
            crops += len(pickle.load(f)["pred_class_ids"])
    return crops


def phase_loop(smi: str, tree: str | None = None, keep: str | None = None) -> dict:
    """Phase 23: train entry point -> checkpoints -> resume -> eval CLI on a
    rendered tree (the module docstring's item 23); ``tree`` is rendered
    here unless given.  ``keep``: a directory that receives the eval CLI's
    checkpoint (``model``) and its pred_result.pkl, for phase 26.  Returns
    the unbroken run's last epoch record (loader and loop rates)."""
    import math
    import os
    import tempfile

    from hspose_tpu_torch.config import parse_overrides
    from hspose_tpu_torch.data import dataset as pds
    from hspose_tpu_torch.engine import train as loop
    from hspose_tpu_torch.engine.checkpoint import (
        latest_checkpoint,
        read_meta,
        restore_checkpoint,
    )
    from hspose_tpu_torch.engine.train_step import build_train_step
    from hspose_tpu_torch.evaluation.evaluate import evaluate
    from hspose_tpu_torch.models.hspose import build_model

    phase = "loop"
    with tempfile.TemporaryDirectory() as tmp:
        if tree is None:
            tree = tmp
            render_tree(tree)
        data = [f"data.dataset_dir={tree}/NOCS",
                f"data.detection_dir={tree}/segmentation_results"]

        def run(out, *extra):
            cfg = parse_overrides(data + [
                f"train.batch_size={TRAIN_B}", f"train.train_steps={LOOP_STEPS}",
                f"train.total_epoch={LOOP_EPOCHS}", "train.save_every=1", "train.log_every=1",
                f"train.seed={SEED + 13}", f"train.model_save={tmp}/{out}", *extra])
            counts = {**counters(), **train_counters()}
            reset_counts(counts)
            model, step = loop.train(cfg, device=DEVICE)
            torch.cuda.synchronize()
            with open(f"{tmp}/{out}/metrics.jsonl") as f:
                recs = [json.loads(line) for line in f]
            return cfg, model, step, read_counts(counts), recs

        cfg, model, step, launches, recs = run("run")
        decode = pds.decode_path(cfg.data)
        log(phase, f"{LOOP_EPOCHS} epochs of {LOOP_STEPS} steps of ({TRAIN_B}, {N}, 3), "
                   f"decode {decode}: launches { {k: v for k, v in launches.items() if v} }")
        if decode != "numpy":
            raise AssertionError(f"the loader decodes by {decode}; expected numpy (no libpng)")
        check_counts(launches, TRAIN_LAUNCHES["float32"],
                     wrapper_steps(step, LOOP_EPOCHS * LOOP_STEPS, 0, 0), "train loop step")
        losses = {r["step"]: r["total_loss"] for r in recs if "total_loss" in r}
        if len(losses) != LOOP_EPOCHS * LOOP_STEPS or not all(map(math.isfinite,
                                                                   losses.values())):
            raise AssertionError(f"train loop losses: {losses}")
        epoch = [r for r in recs if "steps_per_s" in r][-1]
        log(phase, f"loader {epoch['loader_samples_per_s']:.1f} samples/s "
                   f"({int(epoch['num_workers'])} workers, {epoch['worker_samples_per_s']:.1f} "
                   f"each), epoch 1 {epoch['steps_per_s']:.3f} steps/s "
                   f"({epoch['data_wait_s']:.2f} s waiting for batches) on {smi}")

        # epoch 0's checkpoint into a fresh model and step, bit for bit
        first = f"{tmp}/run/model_000"
        if read_meta(first).get("decode") != decode:
            raise AssertionError(f"{first}/meta.json: {read_meta(first)}, decode {decode}")
        saved = torch.load(f"{first}/state.pt", map_location=DEVICE, weights_only=True)
        torch.manual_seed(SEED + 14)
        fresh = build_model(cfg.model, device=DEVICE, train_heads=True)
        fresh_step = build_train_step(cfg, fresh, torch.Generator(device=DEVICE))
        restore_checkpoint(first, fresh, fresh_step)
        got = {f"model.{k}": v for k, v in fresh.state_dict().items()}
        want = {f"model.{k}": v for k, v in saved["model"].items()}
        opt = fresh_step.optimizer
        for i, p in enumerate(opt._params()):
            for k, v in opt.state[p].items():
                got[f"opt.{i}.{k}"], want[f"opt.{i}.{k}"] = v, saved["optimizer"]["state"][i][k]
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        log(phase, f"epoch 0's checkpoint restored: {len(want)} tensors, {len(differ)} differ; "
                   f"optimizer count {opt.count} (saved {saved['optimizer_count']}), "
                   f"lr {opt.lr():.6e}")
        if differ or got.keys() != want.keys() or opt.count != saved["optimizer_count"]:
            raise AssertionError(f"the restored state is not the saved one: {differ[:5]}")

        _, _, resumed_step, launches, recs_b = run("resumed", "train.resume=true",
                                                   f"train.resume_model={first}")
        check_counts(launches, TRAIN_LAUNCHES["float32"],
                     wrapper_steps(resumed_step, LOOP_STEPS, 0, 0), "resumed loop step")
        resumed = {r["step"]: r["total_loss"] for r in recs_b if "total_loss" in r}
        gap = max(abs(v - losses[k]) / abs(losses[k]) for k, v in resumed.items())
        log(phase, f"resumed epoch 1 against the unbroken run: steps {sorted(resumed)}, "
                   f"largest relative loss gap {gap:.3e} (bound {RESUME_LOSS_REL})")
        if sorted(resumed) != sorted(losses)[LOOP_STEPS:] or not gap <= RESUME_LOSS_REL:
            raise AssertionError(f"resumed losses {resumed} against {losses}")

        # the eval CLI's evaluate on the test split from the last checkpoint
        crops = test_crops(tree)
        ckpt = latest_checkpoint(f"{tmp}/run")
        eval_cfg = parse_overrides(data + ["eval.eval_seed=5", f"train.resume_model={ckpt}",
                                           f"train.model_save={tmp}/eval"])
        s = served(lambda: evaluate(eval_cfg, device=DEVICE))
        summary = s.result
        batches = math.ceil(crops / eval_cfg.eval.eval_batch)
        log(phase, f"eval CLI on {os.path.basename(ckpt)}: {crops} crops in {batches} batches, "
                   f"graph replays {s.replays}, captures {s.captures}, kernels {s.kernels}; "
                   f"3D IoU at 25 {summary['IoU25']:.1f}, 10 degree 10cm {summary['10d10cm']:.1f}")
        check_served(s, SERVE_LAUNCHES["float32"], batches, "eval batch")
        if not all(map(math.isfinite, summary.values())):
            raise AssertionError(f"eval summary not finite: {summary}")
        if keep is not None:
            import shutil

            shutil.copytree(ckpt, os.path.join(keep, "model"))
            shutil.copy(os.path.join(tmp, "eval", f"eval_result_{os.path.basename(ckpt)}",
                                     "pred_result.pkl"), keep)
    if "cv2" in sys.modules:
        raise AssertionError("cv2 was imported")
    log(phase, "cv2 never imported")
    return dict(epoch, losses=losses)


PROBE_CPU_CROPS = 32  # phase 24: crops of the B=256 batch held to the CPU plain ops
PROBE_TIERS = (("float32", 0), ("bfloat16", 0), ("bfloat16", SERVE_K_RELAXED))
PROBE_ROUTES = ("float32", "bfloat16", "recompute", "bf16recompute", "v4", "bf16v4")
PROBE_STEPS = 20


def phase_probes(smi: str) -> None:
    """Phase 24: the probe machinery on the card (the module docstring's
    item 24)."""
    from hspose_tpu_torch.tools import fast_mode_parity as fmp
    from hspose_tpu_torch.tools import train_sanity as ts

    phase = "probes"
    batches = fmp.held_out(fmp.EVAL_BS, fmp.EVAL_BS, easy=True)
    head = [{k: v[:PROBE_CPU_CROPS] for k, v in batches[0].items()}]
    for dtype, serve_k in PROBE_TIERS:
        tier = ("fp32" if dtype == "float32" else "bf16") + (f"+k{serve_k}" if serve_k else "")
        model = build_seeded_model(DEVICE, dtype, serve_k)
        # the pool samples drawn on the host go up to the card for the graph's replay
        got = served(lambda: fmp.predict(model, batches, pool_device="cpu"))
        (RT, s), = got.result
        check_served(got, SERVE_LAUNCHES[dtype], 1, f"B={fmp.EVAL_BS} {tier} forward")
        t0 = time.perf_counter()
        fmp.predict(model, batches, pool_device="cpu")
        wall = time.perf_counter() - t0
        if RT.shape != (fmp.EVAL_BS, 4, 4) or s.shape != (fmp.EVAL_BS, 3) or not (
                np.isfinite(RT).all() and np.isfinite(s).all()):
            raise AssertionError(f"{tier}: poses {RT.shape}, sizes {s.shape}, or not finite")
        (RT_cpu, s_cpu), = fmp.predict(copy.deepcopy(model).to("cpu"), head, pool_device="cpu")
        diff = max(np.abs(RT[:PROBE_CPU_CROPS] - RT_cpu).max(),
                   np.abs(s[:PROBE_CPU_CROPS] - s_cpu).max())
        bound = SLICE_ATOL if dtype == "float32" else SLICE_ATOL_BF16
        table = fmp.assemble(batches, [(RT, s)])
        log(phase, f"{tier}: one predict batch of ({fmp.EVAL_BS}, {fmp.N_PTS}, 3), graph "
                   f"replays {got.replays}, captures {got.captures}, kernels {got.kernels}; "
                   f"first {PROBE_CPU_CROPS} "
                   f"crops against the CPU plain ops, max abs diff {diff:.2e} (bound {bound}); "
                   f"second call {wall * 1e3:.1f} ms (host clock, with the host copies); "
                   "table " + ", ".join(f"{k} {v:.2f}" for k, v in table.items()))
        if not diff <= bound:
            raise AssertionError(f"{tier}: card and CPU disagree beyond {bound}: {diff}")
        if not all(map(np.isfinite, table.values())):
            raise AssertionError(f"{tier}: table not finite: {table}")

    half = PROBE_STEPS // 2
    for tier in PROBE_ROUTES:
        dt, store, v4 = TRAIN_TIERS[tier]
        overrides = [f"model.bwd_store={store}", f"model.train_v4_small={v4}"]
        cfg = ts.sanity_config(PROBE_STEPS, TRAIN_B, dt, overrides)
        model, step = ts.build_trainer(cfg, SEED, DEVICE)
        rng = np.random.default_rng(SEED)
        eval_batch = ts.make_batch(rng, ts.EVAL_CROPS, N, ts.MEAN_SHAPE)
        counts = {**counters(), **train_counters()}
        losses, skipped = [], 0
        for part in range(2):
            if part:
                got = served(lambda: ts.pose_errors(model, eval_batch, torch.Generator(
                    device=DEVICE).manual_seed(ts.EVAL_POOL_SEED)))
                errs = got.result
                check_served(got, SERVE_LAUNCHES[dt], 1, f"{tier} pose_errors forward")
                if not (model.training and all(map(np.isfinite, errs))):
                    raise AssertionError(f"{tier}: pose_errors {errs}, train mode "
                                         f"{model.training} after it")
            reset_counts(counts)
            graphs = (step.graphs.replays, step.graphs.captures)
            got, n = ts.train_steps(step, rng, half, TRAIN_B, N, DEVICE, log_every=1,
                                    log=lambda msg: None)
            torch.cuda.synchronize()
            check_counts(read_counts(counts), TRAIN_LAUNCHES[tier],
                         wrapper_steps(step, half, *graphs), f"{tier} sanity step")
            losses += [v for _, v in got]
            skipped += n
        log(phase, f"{tier} ({dt}, bwd_store={store}, train_v4_small={v4}): {PROBE_STEPS} "
                   f"steps of ({TRAIN_B}, {N}, 3), {half} + {half} with exact launch counts, "
                   f"losses {losses[0]:.3f} -> {losses[-1]:.3f}, {skipped} skipped; "
                   f"pose_errors between the halves: rot {errs[0]:.1f} deg, trans "
                   f"{errs[1]:.1f} cm, size {errs[2]:.3f}")
        if skipped or not all(map(np.isfinite, losses)):
            raise AssertionError(f"{tier}: losses {losses}, {skipped} skipped")
    log(phase, f"on {smi}")


DEVICE_RATE_BATCHES = 20  # phase 25: harness batches of B crops timed in each sample mode
SHORT_CROP = 300  # phase 25: valid pixels of the short crop (fewer than N: it tiles)


def crop_checks(batch: dict, rng) -> dict:
    """``batch``'s crops with crop 1 cut to SHORT_CROP valid pixels and crop
    2 to none, the mask of the rest as it was."""
    from hspose_tpu_torch.data.preprocess import CROP_KEYS

    batch = {k: batch[k].copy() for k in CROP_KEYS}
    mask = batch["roi_mask"]
    rows, cols = np.nonzero((batch["roi_depth"][1] > 0) & (mask[1] > 0))
    keep = rng.choice(len(rows), SHORT_CROP, replace=False)
    mask[1] = 0
    mask[1, rows[keep], cols[keep]] = 1
    mask[2] = 0
    return batch


def sample_on_card_and_cpu(phase: str, label: str, batch: dict, seed: int) -> None:
    """``roi_to_pointcloud`` on the card and on the CPU with the same
    scores: the clouds and counts bit for bit, and its ms per batch."""
    from hspose_tpu_torch.data.preprocess import CROP_KEYS, roi_to_pointcloud
    from hspose_tpu_torch.ops.sampling import draw_sample_scores

    b, s = batch["roi_depth"].shape[:2]
    scores = draw_sample_scores(torch.Generator().manual_seed(seed), b, s * s)
    cpu = [torch.from_numpy(batch[k]) for k in CROP_KEYS]
    card = [x.to(DEVICE) for x in cpu]
    want, want_n = roi_to_pointcloud(scores, *cpu, N)
    got, got_n = roi_to_pointcloud(scores.to(DEVICE), *card, N)
    ms = cuda_ms(lambda: roi_to_pointcloud(scores.to(DEVICE), *card, N))
    got, got_n = got.cpu(), got_n.cpu()
    differ = int((got != want).any(-1).sum())
    log(phase, f"{label}: roi_to_pointcloud ({b}, {s}, {s}) -> ({b}, {N}, 3) on the card "
               f"against the CPU: {differ} of {b * N} points differ, valid pixels "
               f"{got_n.tolist()} (CPU {want_n.tolist()}); {ms:.4f} ms a batch")
    if not (torch.equal(got, want) and torch.equal(got_n, want_n)):
        raise AssertionError(f"{label}: the card's sampled clouds are not the CPU's")
    if not (want_n[1] == SHORT_CROP and want_n[2] == 0 and (want_n[3:] > N).all()):
        raise AssertionError(f"{label}: valid pixels {want_n.tolist()}")


def phase_device_sampling(smi: str, tree: str, host: dict) -> None:
    """Phase 25: device sampling on phase 23's tree (the module docstring's
    item 25); ``host`` is phase 23's epoch record."""
    import math
    import os
    import tempfile

    from hspose_tpu_torch.config import parse_overrides
    from hspose_tpu_torch.data import dataset as pds
    from hspose_tpu_torch.data.preprocess import CROP_KEYS
    from hspose_tpu_torch.engine import train as loop
    from hspose_tpu_torch.engine.checkpoint import latest_checkpoint
    from hspose_tpu_torch.evaluation.evaluate import evaluate, load_eval_images
    from hspose_tpu_torch.models.hspose import build_model
    from hspose_tpu_torch.utils.params_io import load_params

    phase = "device-sampling"
    rng = np.random.default_rng(SEED + 15)
    data = [f"data.dataset_dir={tree}/NOCS", f"data.detection_dir={tree}/segmentation_results"]

    # 1. the card's sampling against the CPU's on the tree's crops
    eval_cfg = parse_overrides(data + ["eval.sample_mode=device"])
    records = load_eval_images(eval_cfg, SEED, num_workers=4)
    crops = {k: np.concatenate([d[k] for d, _, _ in records]) for k in CROP_KEYS}
    rows = np.arange(B) % len(crops["roi_depth"])  # the test split's crops, cycled to B
    sample_on_card_and_cpu(phase, f"B={B} eval batch ({len(crops['roi_depth'])} crops cycled)",
                           crop_checks({k: v[rows] for k, v in crops.items()}, rng), SEED + 16)
    train_ds = pds.PoseTrainDataset(eval_cfg.data, sample_mode="device")
    sample_on_card_and_cpu(phase, f"B={TRAIN_B} train batch",
                           crop_checks(pds._make_batch_from(train_ds, SEED, 0, TRAIN_B), rng),
                           SEED + 17)

    with tempfile.TemporaryDirectory() as tmp:
        # 2. the train entry point in device mode
        cfg = parse_overrides(data + [
            "data.sample_mode=device", f"train.batch_size={TRAIN_B}",
            f"train.train_steps={LOOP_STEPS}", "train.total_epoch=1", "train.log_every=1",
            f"train.seed={SEED + 13}", f"train.model_save={tmp}/run"])
        counts = {**counters(), **train_counters()}
        reset_counts(counts)
        loop.train(cfg, device=DEVICE)
        torch.cuda.synchronize()
        launches = read_counts(counts)
        with open(f"{tmp}/run/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        log(phase, f"train loop, data.sample_mode=device: 1 epoch of {LOOP_STEPS} steps of "
                   f"({TRAIN_B}, {N}, 3) sampled on the card, launches "
                   f"{ {k: v for k, v in launches.items() if v} }")
        check_counts(launches, TRAIN_LAUNCHES["float32"], LOOP_STEPS, "device-mode loop step")
        losses = [r["total_loss"] for r in recs if "total_loss" in r]
        if len(losses) != LOOP_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"device-mode train loop losses: {losses}")
        epoch = [r for r in recs if "steps_per_s" in r][-1]
        log(phase, f"loader, device mode: {epoch['loader_samples_per_s']:.1f} samples/s "
                   f"({int(epoch['num_workers'])} workers, {epoch['worker_samples_per_s']:.1f} "
                   f"each), {epoch['steps_per_s']:.3f} steps/s, {epoch['data_wait_s']:.2f} s "
                   f"waiting; host mode (phase 23): {host['loader_samples_per_s']:.1f} "
                   f"samples/s ({int(host['num_workers'])} workers, "
                   f"{host['worker_samples_per_s']:.1f} each), {host['steps_per_s']:.3f} "
                   f"steps/s; losses {', '.join(f'{v:.3f}' for v in losses)} on {smi}")

        # 3. the eval CLI's evaluate in device mode on that checkpoint
        ckpt = latest_checkpoint(f"{tmp}/run")
        cfg = parse_overrides(data + ["eval.sample_mode=device", "eval.eval_seed=5",
                                      f"train.resume_model={ckpt}", f"train.model_save={tmp}/eval"])
        s = served(lambda: evaluate(cfg, device=DEVICE))
        summary = s.result
        batches = math.ceil(test_crops(tree) / cfg.eval.eval_batch)
        log(phase, f"eval CLI, eval.sample_mode=device, on {os.path.basename(ckpt)}: "
                   f"{batches} batches, graph replays {s.replays}, captures {s.captures}, "
                   f"kernels {s.kernels}; "
                   f"3D IoU at 25 {summary['IoU25']:.1f}, 10 degree 10cm {summary['10d10cm']:.1f}")
        check_served(s, SERVE_LAUNCHES["float32"], batches, "device-mode eval batch")
        if not all(map(math.isfinite, summary.values())):
            raise AssertionError(f"eval summary not finite: {summary}")

        # the harness's crops/s in both sample modes on the same test images
        model = build_model(cfg.model, device=DEVICE)
        load_params(model, ckpt)
        rates = {}
        for mode in ("device", "host"):
            rcfg = parse_overrides(data + [f"eval.sample_mode={mode}", f"eval.eval_batch={B}"])
            base = load_eval_images(rcfg, SEED, num_workers=4)
            n = sum(len(d["cat_id_0base"]) for d, _, _ in base)
            reps = math.ceil((DEVICE_RATE_BATCHES + 1) * B / n)
            run_harness(rcfg, model, base, SEED)  # warm: the graph's capture
            check_served(served(lambda: run_harness(rcfg, model, base, SEED)),
                         SERVE_LAUNCHES["float32"], math.ceil(n / B), f"{mode}-mode harness batch",
                         warm=True)
            _, rates[mode] = run_harness(rcfg, model, base * reps, SEED)
        log(phase, f"harness at B={B}, {DEVICE_RATE_BATCHES}+ batches of the test images' crops: "
                   f"device mode {rates['device']:.1f} crops/s, host mode {rates['host']:.1f} "
                   f"crops/s on {smi}")
    if "cv2" in sys.modules:
        raise AssertionError("cv2 was imported")
    log(phase, "cv2 never imported")


SP_N, SP_B = 4096, 8  # phase 26: scripts/bench_large_n.py:38's largest configuration, its batch
SP_SHARDS = (2, 4)  # phase 26: the sp sizes whose shard shapes the kernels are held at
SP_RECORD = 2  # phase 26: the sp whose shard shapes the kernel line reports
# phase 26: query-sharded launches per rank per sp = 2 forward at N = 4096: the
# three searches of resolution 0 have M = 4096 > 2048 source points (the exact
# search, K5's range, in both tiers), the six of the pooled resolutions not
SP_LAUNCHES = {
    "float32": {"knn_qs_streamed": 3, "knn_qs": 6, "hs_surface_qs": 1, "hs_support_qs": 4,
                "orl_global_qs": 5, "heads_epilogue": 1},
    "bfloat16": {"knn_qs_streamed": 3, "knn_qs_packed": 6, "hs_surface_qs_bf16": 1,
                 "hs_support_qs_bf16": 4, "orl_global_qs_bf16": 5, "heads_epilogue_bf16": 1},
}
# K4: shard means recombined against the one-device mean, (rtol, atol).  The sum
# of NQ terms / NQ, then the mean of the sp shard means, is another fp32 order
# than the sum of N terms / N (32-point tiles, then the tiles, in order).  A
# numpy model of the kernel's order puts the gap at up to 6.8e-7 relative at
# these shapes (N = 4096 ... 256, sp = 2 and 4) for JAX's rtol of 2e-7 at N = 64
# (tests/test_sequence_parallel.py), so the card is held to 2e-6
ORL_RECOMBINE = (2e-6, 1e-7)
SP_RATE_REPS = 10  # phase 26: sp forwards timed per tier
# phase 26: with the one-process centre and ORL means, the fp32 sp forward's
# first five searches (resolution 0's three, resolution 1's vertex search and
# rf_2) read the one-process maps bit for bit
SP_EXACT_SEARCHES = 5
JOIN_SECONDS = 120  # phase 26: the spawned ranks' process-group timeout


@contextlib.contextmanager
def sp_probe(inject: dict | None = None):
    """Phase 26: within, the forward's searches (their indices and query
    maps), its centring mean and its five ORL means are recorded into the yielded
    dict; with ``inject`` (such a record of another forward), its centre
    and ORL means take the place of this forward's, in order, after the
    collectives ran as always."""
    from hspose_tpu_torch.models import face_recon, layers, posenet

    saved = face_recon.knn, posenet.mean_over_shards, layers.mean_over_shards
    rec = {"searches": [], "inputs": [], "centre": [], "orl": []}
    given = {key: iter(v) for key, v in (inject or {}).items() if key in ("centre", "orl")}

    def search(points, *args, **kwargs):
        idx = saved[0](points, *args, **kwargs)
        rec["searches"].append(idx.cpu())
        rec["inputs"].append(points.cpu())
        return idx

    def mean(key, fn):
        def wrapped(x, group):
            out = fn(x, group)
            if key in given:
                out = next(given[key]).to(out.device)
            rec[key].append(out.cpu())
            return out
        return wrapped

    face_recon.knn = search
    posenet.mean_over_shards, layers.mean_over_shards = mean("centre", saved[1]), mean("orl", saved[2])
    try:
        yield rec
    finally:
        face_recon.knn, posenet.mean_over_shards, layers.mean_over_shards = saved


def against_one(rec: dict, one: dict, rank: int, world: int) -> dict:
    """Phase 26: an sp rank's ``sp_probe`` record against the one-process
    forward's, on this rank's rows: per search, the rows whose neighbour
    sets differ and the max abs gap of the searched map; the gaps of the
    centre and of the ORL means."""
    def mine(full):
        nq = full.shape[1] // world
        return full[:, rank * nq:(rank + 1) * nq]

    return {"rows": [int((a.sort(-1).values != mine(b).sort(-1).values).any(-1).sum())
                     for a, b in zip(rec["searches"], one["searches"])],
            "maps": [(a.float() - mine(b).float()).abs().max().item()
                     for a, b in zip(rec["inputs"], one["inputs"])],
            "centre": (rec["centre"][0] - one["centre"][0]).abs().max().item(),
            "orl": [(a - b).abs().max().item() for a, b in zip(rec["orl"], one["orl"])]}


def row_split_gaps(model, world: int) -> dict:
    """Phase 26: each fp32 product that the sp forward runs on point rows,
    on random inputs at its B * n rows and on each of the ``world`` shards'
    rows: the max abs gap between the two (0 where cuBLAS takes the same
    path for both row counts)."""
    fr, vec = model.face_recon, model.rot_green.vec
    products = [("head conv1", SP_N, vec.conv1), ("head conv2", SP_N, vec.conv2)]
    for k, n in enumerate((SP_N, SP_N, SP_N // 4, SP_N // 4, SP_N // 16)):
        layer = getattr(fr, f"conv_{k}")
        products += [(f"conv_{k} STE", n, layer.STE_layer), (f"conv_{k} conv2", n, layer.conv2)]
        if k:
            products.append((f"conv_{k} centre", n, (layer, layer.out_channel)))
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 33)
    gaps = {}
    with torch.no_grad():
        for name, n, op in products:
            if isinstance(op, tuple):
                layer, co = op
                width = layer.weights.shape[0]
                fn = lambda x, l=layer, co=co: x @ l.weights[:, :co] + l.bias[:co]  # noqa: E731
            else:
                width, fn = op.in_features, op
            x = torch.randn((SP_B, n, width), generator=g, device=DEVICE)
            m = n // world
            parts = torch.cat([fn(x[:, i * m:(i + 1) * m].contiguous()) for i in range(world)], 1)
            gaps[f"{name} ({SP_B * n} / {SP_B * m} rows)"] = (fn(x) - parts).abs().max().item()
    return gaps


def sp_gate_knn(phase, rec, name, got, plain, full_slice, pts, label, gap_rel, bnd, ms, pms):
    """A query-sharded search against its plain version (phase 3's gates)
    and the single-source launch's rows, index for index."""
    from hspose_tpu_torch.ops.knn import gather_neighbors

    src = pts.double()
    q = src[:, label["lo"]:label["hi"]]
    agree = (got[..., :, None] == plain[..., None, :]).any(-1).double().mean().item()

    def sorted_d(idx):
        diff = gather_neighbors(src, idx) - q[:, :, None]
        return (diff * diff).sum(-1).sort(-1).values

    dg, dw = sorted_d(got), sorted_d(plain)
    err = (dg - dw).abs().max().item()
    rel = ((dg - dw).abs() / dw.clamp_min(1e-30)).max().item()
    same = torch.equal(got, full_slice)
    log(phase, f"{name} {label['text']}: agreement {agree:.6f}, max rel distance gap "
               f"{rel:.3e}, the single-source rows {'bit for bit' if same else 'DIFFER'}, "
               f"{ms:.4f} ms (plain {pms:.4f} ms, bound {bnd[0]:.4f} {bnd[1]})")
    if agree < KNN_AGREE or rel > gap_rel or not same:
        raise AssertionError(f"{name} {label['text']}: agreement {agree}, gap {rel}, "
                             f"equal to the single-source rows {same}")
    if rec is not None:
        record(rec, name, err, ms, pms, bnd)


def phase_sp_kernels() -> dict:
    """Phase 26, part 1: the query-sharded branches of K1/K5, K2, K3 and K4
    at the shard shapes of the N = 4096, B = 8 forward for sp = 2 and 4, in
    both tiers, each against its plain version (phase 3's and 6's gates) and
    the single-source launch on the gathered cloud: K1's indices, K2's and
    K3's outputs bit for bit its rows, K4's shard means recombined within
    ORL_RECOMBINE.  Each query tensor is a copy of the last shard of the
    source, as the rank holding it has it.  Returns the records of the
    sp = 2 shapes."""
    from hspose_tpu_torch.ops.cuda_hs_fused import (
        hs_support_fused, hs_support_plain, hs_surface_fused, hs_surface_plain,
        orl_global_fused, orl_global_plain)
    from hspose_tpu_torch.ops.cuda_knn import knn_indices_cuda
    from hspose_tpu_torch.ops.knn import PACKED_MAX_N, knn_indices, knn_indices_packed

    phase = "sp-kernels"
    rec = {}
    S = 7
    for dtype in ("float32", "bfloat16"):
        fast = dtype == "bfloat16"
        tag = "_bf16" if fast else ""
        op_dtype = torch.bfloat16 if fast else torch.float32
        for sp in SP_SHARDS:
            r = rec if sp == SP_RECORD else None
            rng = np.random.default_rng(SEED + 20 + sp)
            sizes = [SP_N, SP_N // 4, SP_N // 16]
            clouds = {m: cloud_b(rng, SP_B, m) for m in sizes}

            def features(m, c):
                x = normal(rng, SP_B, m, c)
                return x.to(torch.bfloat16) if fast else x

            def shard(x):
                m = x.shape[1]
                lo = (sp - 1) * m // sp
                return x[:, lo:].contiguous(), lo

            def text(m, what):
                return {"text": f"sp={sp} M={m} NQ={m // sp} {what}", "lo": (sp - 1) * m // sp,
                        "hi": m}

            # the nine searches of a forward
            idx_of = {}
            for m, d, k in [(sizes[0], 3, 20), (sizes[0], 128, 20), (sizes[0], 3, 4),
                            (sizes[1], 3, 20), (sizes[1], 128, 20), (sizes[1], 256, 20),
                            (sizes[1], 3, 4), (sizes[2], 3, 20), (sizes[2], 256, 20)]:
                pts = clouds[m] if d == 3 else features(m, d)
                q, lo = shard(pts)
                packed = fast and m <= PACKED_MAX_N
                name = ("knn_qs_streamed" if m > PACKED_MAX_N
                        else "knn_qs_packed" if packed else "knn_qs")
                got = knn_indices_cuda(q, k, packed=fast, source=pts)
                full = knn_indices_cuda(pts, k, packed=fast)
                plain = (knn_indices_packed(q, k, source=pts) if packed
                         else knn_indices(q.float(), k, source=pts.float()))
                ms = cuda_ms(lambda: knn_indices_cuda(q, k, packed=fast, source=pts))
                pms = cuda_ms(lambda: (knn_indices_packed(q, k, source=pts) if packed
                                       else knn_indices(q.float(), k, source=pts.float())),
                              iters=3, warmup=1)
                bnd = bound([q, pts, got], SP_B * (m // sp) * m * d,
                            torch.float32 if d == 3 or not packed else op_dtype)
                # the streamed searches are recorded once, in the fp32 tier: the
                # bf16 tier runs the same exact kernel on its points widened
                sp_gate_knn(phase, None if fast and not packed else r, name, got, plain,
                            full[:, lo:], pts,
                            text(m, f"D={d} {pts.dtype} k={k}"),
                            KNN_SWAP_REL if packed else KNN_TIE_REL, bnd, ms, pms)
                if d == 3 and k == 20:
                    idx_of[m] = (full, got)

            def close(name, label, got, want, tensors, macs, ms, pms, rows=None):
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                same = "" if rows is None else (
                    ", the single-source rows bit for bit" if torch.equal(got, rows)
                    else ", the single-source rows DIFFER")
                bnd = bound(tensors + [got], macs, op_dtype)
                log(phase, f"{name} {label}: max abs err {err:.3e} (bound {TOL_REL * scale:.3e})"
                           f"{same}, {ms:.4f} ms (plain {pms:.4f} ms, bound {bnd[0]:.4f} "
                           f"{bnd[1]})")
                if not err <= TOL_REL * scale or "DIFFER" in same:
                    raise AssertionError(f"{name} {label}: error {err} > {TOL_REL} * {scale}"
                                         f"{same}")
                if r is not None:
                    record(r, name, err, ms, pms, bnd)

            # conv_0
            m = sizes[0]
            verts = clouds[m]
            vq, lo = shard(verts)
            full_idx, idx = idx_of[m]
            dirs = unit_dirs(rng, S * 128)
            call = lambda: hs_surface_fused(verts, idx, dirs, S, 128, not fast,  # noqa: E731
                                            vertices_q=vq)
            got = call()
            close("hs_surface_qs" + tag, f"conv_0 sp={sp} M={m} NQ={m // sp} K=20 Co=128", got,
                  hs_surface_plain(verts, idx, dirs, S, 128, not fast, vertices_q=vq),
                  [verts, vq, idx, dirs], 3 * idx.numel() * S * 128, cuda_ms(call),
                  cuda_ms(lambda: hs_surface_plain(verts, idx, dirs, S, 128, not fast,
                                                   vertices_q=vq), iters=3, warmup=1),
                  hs_surface_fused(verts, full_idx, dirs, S, 128, not fast)[:, lo:])

            # conv_1 .. conv_4
            for layer, cin, co, m in [(1, 128, 128, sizes[0]), (2, 128, 256, sizes[1]),
                                      (3, 256, 256, sizes[1]), (4, 256, 512, sizes[2])]:
                stdv = 1.0 / (co * (S + 1)) ** 0.5
                w_full = normal(rng, cin, (S + 1) * co, scale=stdv)
                b_full = normal(rng, (S + 1) * co, scale=stdv)
                feat, verts = features(m, cin), clouds[m]
                vq, lo = shard(verts)
                full_idx, idx = idx_of[m]
                args = (feat, verts, idx, w_full[:, co:], b_full[co:], unit_dirs(rng, S * co),
                        S, co)
                call = lambda: hs_support_fused(*args, vertices_q=vq)  # noqa: E731
                got = call()
                close("hs_support_qs" + tag, f"conv_{layer} {cin}->{co} sp={sp} M={m} "
                                             f"NQ={m // sp} K=20", got,
                      hs_support_plain(*args, vertices_q=vq), list(args[:6]) + [vq],
                      SP_B * m * cin * S * co + 3 * idx.numel() * S * co, cuda_ms(call),
                      cuda_ms(lambda: hs_support_plain(*args, vertices_q=vq), iters=3,
                              warmup=1),
                      hs_support_fused(feat, verts, full_idx, *args[3:])[:, lo:])

            # the ORL branch of each layer: the shard means recombined
            for layer, c, m in [(0, 128, sizes[0]), (1, 128, sizes[0]), (2, 256, sizes[1]),
                                (3, 256, sizes[1]), (4, 512, sizes[2])]:
                feat = features(m, c)
                full_idx, _ = idx_of[m]
                nq = m // sp
                parts = [orl_global_fused(feat, full_idx[:, i * nq:(i + 1) * nq].contiguous(),
                                          query_sharded=True)
                         for i in range(sp)]
                one = orl_global_fused(feat, full_idx)
                mean = torch.stack(parts).sum(0) / sp
                ok = torch.allclose(mean, one, rtol=ORL_RECOMBINE[0], atol=ORL_RECOMBINE[1])
                idx = full_idx[:, -nq:].contiguous()
                call = lambda: orl_global_fused(feat, idx, query_sharded=True)  # noqa: E731
                label = (f"conv_{layer} C={c} sp={sp} M={m} NQ={nq} K=20: shard means "
                         f"recombined {'within' if ok else 'BEYOND'} rtol {ORL_RECOMBINE[0]} "
                         f"atol {ORL_RECOMBINE[1]} (max gap "
                         f"{(mean - one).abs().max().item():.3e})")
                close("orl_global_qs" + tag, label, parts[-1], orl_global_plain(feat, idx),
                      [feat, idx], 0, cuda_ms(call),
                      cuda_ms(lambda: orl_global_plain(feat, idx), iters=3, warmup=1))
                if not ok:
                    raise AssertionError(f"orl_global_qs{tag} conv_{layer} sp={sp}: the shard "
                                         "means do not recombine to the one-device mean")
    return rec


def sp_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """Phase 26: one of the ranks that share the card over an explicit gloo
    group (the rig has one card, and NCCL takes one rank per device).  It
    serves the job's crops sequence-parallel in both tiers (its launches
    per forward, its outputs, crops/s over SP_RATE_REPS forwards between two
    barriers), then the dp harness on the job's records, and saves what it
    got to ``tmp``."""
    import dataclasses
    import datetime
    import os

    import torch.distributed as dist

    from hspose_tpu_torch.config import ModelConfig, ParallelConfig
    from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference
    from hspose_tpu_torch.models.hspose import build_model
    from hspose_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from hspose_tpu_torch.parallel.sp import sp_eval_fn

    device = init_distributed(device, backend="gloo", init_method=f"file://{tmp}/store",
                              rank=rank, world_size=world,
                              timeout=datetime.timedelta(seconds=JOIN_SECONDS))
    job = torch.load(os.path.join(tmp, "job.pt"), weights_only=False)
    mesh = make_mesh(1, world)
    n = job["pc"].shape[1] // world

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # gloo takes CUDA tensors as they are (parallel/sp.py passes them so)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.arange(6, device=device) + rank).to(dtype)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=mesh.sp_group)
        total, top = x.clone(), x.clone()
        dist.all_reduce(total, group=mesh.sp_group)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.sp_group)
        want = [torch.arange(6, device=device).to(dtype) + r for r in range(world)]
        if not (all(torch.equal(a, w) for a, w in zip(parts, want))
                and torch.equal(total, sum(want)) and torch.equal(top, want[-1])):
            raise AssertionError(f"gloo's all_gather / all_reduce of CUDA {dtype} tensors "
                                 "are not exact")

    pc = job["pc"][:, rank * n:(rank + 1) * n].contiguous().to(device)
    obj, sym = job["obj"].to(device), job["sym"].to(device)
    mean_shape = torch.zeros((pc.shape[0], 3), device=device)
    samples = [x.to(device) for x in job["samples"]]
    got = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(ModelConfig(compute_dtype=dtype), device=device)
        model.load_state_dict(job["state_dict"])

        fn = sp_eval_fn(model, mesh.sp_group)

        def serve():
            return fn(pc, obj, sym, mean_shape, samples)

        serve()  # warm
        counts = counters()
        reset_counts(counts)
        RT, scales = serve()
        sync()
        launches = read_counts(counts)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(SP_RATE_REPS):
            serve()
        sync()
        dist.barrier()
        rate = SP_RATE_REPS * pc.shape[0] / (time.perf_counter() - t0)
        got[dtype] = {"RT": RT.cpu(), "scales": scales.cpu(), "launches": launches,
                      "rate": rate}
        # where the sp forward parts from the one-process one: served as it
        # is, with the one-process centre, with the one-process centre and
        # ORL means in place of the shard means
        one = job["one"][dtype]
        for variant, inject in (("sp", None), ("centre", {"centre": one["centre"]}),
                                ("centre+orl", one)):
            with sp_probe(inject) as rec:
                RT_v, s_v = serve()
            got[dtype][variant] = dict(against_one(rec, one, rank, world), RT=RT_v.cpu(),
                                       scales=s_v.cpu())
        if dtype == "float32":  # the dp harness: each rank's forwards are graph replays
            cfg = dataclasses.replace(harness_config(), parallel=ParallelConfig(dp=world))
            h = served(lambda: batched_pose_inference(cfg, model, job["records"], job["seed"]))
            preds, _ = h.result
            got["harness"] = {"RT": np.concatenate([r["pred_RTs"] for r in preds]),
                              "scales": np.concatenate([r["pred_scales"] for r in preds]),
                              "served": h._replace(result=None)._asdict()}
    torch.save(got, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def phase_sp_forward(smi: str) -> dict:
    """Phase 26, part 2: two ranks on the card over an explicit gloo group
    (``sp_rank``): the sp = 2 forward at N = 4096, B = 8 in both tiers,
    exactly SP_LAUNCHES per rank per forward and no other kernel, the
    outputs the same on both ranks bit for bit, the poses and sizes within
    SLICE_ATOL (bf16: SLICE_ATOL_BF16) of the one-process card forward on
    the same weights, crops and pools, and the crops/s of two ranks sharing
    the card; where the sp forward parts from the one-process one (the
    module docstring); then the harness with parallel.dp=2 on HARNESS_BATCHES
    batches of (B, N) against the one-process harness on the same records
    and seed (cuBLAS may split the heads' products differently at B / 2
    rows: SLICE_ATOL).  Returns rank 0's launches per forward."""
    import multiprocessing
    import tempfile

    from hspose_tpu_torch.geometry.rotations import generate_RT
    from hspose_tpu_torch.models.hspose import draw_pool_samples, eval_forward

    phase, world = "sp-forward", 2
    rng = np.random.default_rng(SEED + 30)
    pc = cloud_b(rng, SP_B, SP_N)
    obj = torch.arange(SP_B, device=DEVICE) % 6
    sym = torch.tensor([[0, 1, 0, 0]], dtype=torch.float32, device=DEVICE).repeat(SP_B, 1)
    samples = draw_pool_samples(SP_N, torch.Generator(device=DEVICE).manual_seed(SEED + 31),
                                DEVICE)
    model = build_seeded_model(DEVICE)
    records, seed = harness_records(np.random.default_rng(SEED + 32), N, HARNESS_BATCHES), SEED
    launches, want, one = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        m = model if dtype == "float32" else build_seeded_model(DEVICE, dtype)
        # the probe reads the forward's intermediates as they run: the eager route
        # (its poses are the graph's, bit for bit: phase 29)
        with sp_probe() as one[dtype], eager_route():
            out = eval_forward(m, pc, obj, pool_samples=samples)
        RT = generate_RT(out.p_green_R, out.p_red_R, out.f_green_R, out.f_red_R, out.pred_T, sym)
        want[dtype] = {"RT": RT.cpu(), "pred_s": out.pred_s.cpu()}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"state_dict": model.state_dict(), "pc": pc.cpu(), "obj": obj.cpu(),
                    "sym": sym.cpu(), "samples": [x.cpu() for x in samples],
                    "records": records, "seed": seed, "one": one}, f"{tmp}/job.pt")
        ctx = multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=sp_rank, args=(r, world, tmp, f"{DEVICE}:0"))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=4 * JOIN_SECONDS)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode for p in procs):
            raise AssertionError(f"the sp ranks failed: exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(world)]
    log(phase, f"{world} ranks on cuda:0 over gloo: {time.perf_counter() - t0:.1f} s with start-up; "
               "gloo's all_gather and all_reduce (sum, max) took CUDA fp32 and bf16 tensors, "
               "exactly")

    for dtype, atol in (("float32", SLICE_ATOL), ("bfloat16", SLICE_ATOL_BF16)):
        for r, got in enumerate(ranks):
            check_counts(got[dtype]["launches"], SP_LAUNCHES[dtype], 1, f"rank {r} {dtype} forward")
        a, b = ranks[0][dtype], ranks[1][dtype]
        replicated = torch.equal(a["RT"], b["RT"]) and torch.equal(a["scales"], b["scales"])
        diffs = {"RT": (a["RT"] - want[dtype]["RT"]).abs().max().item(),
                 "pred_s": (a["scales"] - want[dtype]["pred_s"]).abs().max().item()}
        log(phase, f"{dtype}: sp=2 forward of ({SP_B}, {SP_N}, 3), launches per rank "
                   f"{ {k: v for k, v in a['launches'].items() if v} }; outputs the same on both "
                   f"ranks: {replicated}; against the one-process card forward, max abs "
                   + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()) + f" (bound {atol})")
        log(phase, f"{dtype}: {a['rate']:.1f} crops/s of two ranks sharing one card over gloo "
                   f"(not a multi-GPU rate) on {smi}")
        if not replicated or not all(v <= atol for v in diffs.values()):
            raise AssertionError(f"{dtype} sp forward: replicated {replicated}, {diffs}")
        rows = SP_B * SP_N // world
        for variant in ("sp", "centre", "centre+orl"):
            for r, got in enumerate(ranks):
                v = got[dtype][variant]
                log(phase, f"{dtype} rank {r}, {variant}: against the one-process forward, "
                           f"centre {v['centre']:.3e}, ORL means "
                           + ", ".join(f"{x:.2e}" for x in v["orl"])
                           + f"; per search, rows of {rows} whose neighbour sets differ "
                           f"{v['rows']}, max abs gap of the searched map "
                           + ", ".join(f"{x:.2e}" for x in v["maps"]) + "; max abs RT "
                           f"{(v['RT'] - want[dtype]['RT']).abs().max().item():.3e}, pred_s "
                           f"{(v['scales'] - want[dtype]['pred_s']).abs().max().item():.3e}")
        # the plumbing (gathers, pool slices, upsample, collectives) at full
        # width: with the one-process centre the bf16 tier, whose roundings
        # absorb the ORL means' order, serves the one-process bits; with both
        # means the fp32 tier searches the one-process maps up to conv_2's
        # output, whose conv2 product cuBLAS forms otherwise at half the rows
        for r, got in enumerate(ranks):
            if dtype == "bfloat16":
                v = got[dtype]["centre"]
                exact = (torch.equal(v["RT"], want[dtype]["RT"])
                         and torch.equal(v["scales"], want[dtype]["pred_s"]))
            else:
                exact = not any(got[dtype]["centre+orl"]["maps"][:SP_EXACT_SEARCHES])
            if not exact:
                raise AssertionError(f"rank {r}: the {dtype} sp forward with the one-process "
                                     "means is not the one-process forward bit for bit")
        launches.update({k: a["launches"][k] for k in SP_LAUNCHES[dtype]
                         if (dtype == "float32" or k != "knn_qs_streamed")
                         and not k.startswith("heads_epilogue")})
    log(phase, "fp32 products on point rows, all rows against each sp = 2 shard's rows, max abs "
               "gap: " + ", ".join(f"{k} {v:.2e}" for k, v in row_split_gaps(model, world).items()))

    preds, _ = run_harness(harness_config(), model, records, seed)
    want_RT = np.concatenate([r["pred_RTs"] for r in preds])
    want_s = np.concatenate([r["pred_scales"] for r in preds])
    for r, got in enumerate(ranks):
        h = got["harness"]
        hs = Served(**h["served"])
        check_served(hs, SERVE_LAUNCHES["float32"], HARNESS_BATCHES, f"rank {r} dp harness batch")
        d_rt = np.abs(h["RT"] - want_RT).max()
        d_s = np.abs(h["scales"] - want_s).max()
        same = np.array_equal(h["RT"], want_RT) and np.array_equal(h["scales"], want_s)
        log(phase, f"rank {r}: parallel.dp=2 harness, {HARNESS_BATCHES} batches of ({B}, {N}, 3) "
                   f"({B // 2} rows a rank), graph replays {hs.replays}, captures "
                   f"{hs.captures}, kernels {hs.kernels}; "
                   f"against the one-process harness: bit for bit {same}, max abs RT {d_rt:.3e}, "
                   f"scales {d_s:.3e} (bound {SLICE_ATOL})")
        if not (d_rt <= SLICE_ATOL and d_s <= SLICE_ATOL):
            raise AssertionError(f"rank {r}: the dp harness's poses are not the one-device ones")
    return launches


def phase_sp_cli(smi: str, tree: str, keep: str) -> None:
    """Phase 26, part 3: the eval CLI under ``torchrun --standalone
    --nproc_per_node=<device count>`` with nccl on phase 23's checkpoint and
    tree (``keep``), its pred_result.pkl equal to the one-process CLI's of
    phase 23."""
    import os
    import pickle
    import tempfile

    phase = "sp-cli"
    ckpt = os.path.join(keep, "model")
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={torch.cuda.device_count()}", "-m",
               "hspose_tpu_torch.evaluation.evaluate", f"data.dataset_dir={tree}/NOCS",
               f"data.detection_dir={tree}/segmentation_results", "eval.eval_seed=5",
               f"train.resume_model={ckpt}", f"train.model_save={out}"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode:
            raise AssertionError(f"torchrun eval CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(os.path.join(out, "eval_result_model", "pred_result.pkl"), "rb") as f:
            got = pickle.load(f)
    with open(os.path.join(keep, "pred_result.pkl"), "rb") as f:
        want = pickle.load(f)
    keys = ("pred_RTs", "pred_scales")
    same = len(got) == len(want) and all(np.array_equal(a[k], b[k])
                                         for a, b in zip(got, want) for k in keys)
    log(phase, f"torchrun --nproc_per_node={torch.cuda.device_count()} (nccl) eval CLI on "
               f"phase 23's checkpoint: {time.perf_counter() - t0:.1f} s, {len(got)} images, "
               f"pred_result.pkl equal to the one-process CLI's: {same} on {smi}")
    if not same:
        raise AssertionError("the torchrun eval CLI's predictions are not the one-process CLI's")


DP_STEPS = 3  # phase 27: steps of each tier's dp = 2 run
DP_RATE_STEPS = 5  # phase 27: dp = 2 fp32 steps timed
DP_SAVED = ("float32", "mp", "dp4")  # phase 27: runs whose last state is restored in one process
MP_RT_ATOL, MP_S_ATOL = 1e-5, 1e-6  # phase 27: mp = 2 harness (tests/test_parallel.py:271-272)
# phase 27: fixed gates of a step against the one-process step on the card from
# the same state (``step_readings``' keys).  A dp step sums BatchNorm's moments
# and the gradient in another order than one process, and at B = 16 that flips
# near-tie KNN and max selections.  The card's fp32 dp = 2 readings (PERF.md
# §6; the card is deterministic here): loss_rel <= 1.63e-3, loss <= 4.5e-4,
# bn <= 3.4e-4, grad <= 9.8e-4, leaf_cos <= 3.9e-3, leaf_ratio <= 1.6e-2,
# update <= 9.7e-4, update_rel <= 4.4e-2 (phase 9's 1e-3 per term and 0.9995
# cosine hold one B = 4 forward).  The per-leaf gates are phase 9's (cosine
# 0.98, norm ratio 0.9-1.1: a gradient scaled by dp or mp fails them), the
# update's (Ranger's first moment, the update before it is rounded into the
# parameters) tests/test_torch_port_step.py's norm_rel 5e-2 and cosine 0.999.
# An mp step differs by the gathered products alone (loss_rel 6.9e-6, loss
# 4.9e-7, bn 1.3e-6, grad 1.0e-9, leaf_cos 1.3e-5, leaf_ratio 3.6e-4, update
# 1.0e-9, update_rel 4.5e-5), so it is held far tighter.
DP_GATES = {"loss_rel": 5e-3, "loss": 1e-3, "bn": 1e-3, "grad": 5e-3, "leaf_cos": 2e-2,
            "leaf_ratio": 0.1, "update": 1e-3, "update_rel": 5e-2}
MP_GATES = {"loss_rel": 1e-4, "loss": 1e-5, "bn": 1e-4, "grad": 1e-6, "leaf_cos": 1e-4,
            "leaf_ratio": 1e-3, "update": 1e-6, "update_rel": 1e-3}
# dp = 4 at 4 rows a rank flips more near-ties (readings: grad 1.5e-3, update
# 1.53e-3, update_rel 5.5e-2).  At a first step the update is the clipped,
# centred gradient, so it takes the gradient's gate: 1 - cos 5e-3, and the
# norm_rel of two equal norms at that cosine, sqrt(2 * 5e-3) = 0.1
DP4_GATES = {**DP_GATES, "update": DP_GATES["grad"], "update_rel": 0.1}
# phase 27's jobs: (ranks sharing the card, its runs: (name, training tier, dp,
# mp, steps, the fp32 gates or None for bf16's spread bound)); the first job
# also times DP_RATE_STEPS fp32 dp steps and runs the harness with parallel.mp=2
DP_JOBS = ((2, (("float32", "float32", 2, 1, DP_STEPS, DP_GATES),
                ("bfloat16", "bfloat16", 2, 1, DP_STEPS, None),
                ("v4", "v4", 2, 1, 1, DP_GATES), ("mp", "float32", 1, 2, 1, MP_GATES))),
           (4, (("dp4", "float32", 4, 1, 1, DP4_GATES),
                ("dp2mp2", "float32", 2, 2, 1, DP_GATES))))
SPREAD_KEYS = ("loss_rel", "loss", "bn", "grad")  # phase 27's second witness (bf16's gate)


def dp_state(model, step, values: bool) -> dict:
    """The full training state of a rank (mp shards gathered; every rank of
    the mp group calls it): a digest of each tensor, the counts, and with
    ``values`` the model's parameters and BatchNorm buffers, the last
    step's (reduced) gradients and Ranger's first moments on the host."""
    import hashlib

    from hspose_tpu_torch.parallel import mp

    weights = model.state_dict()
    for name, p in model.named_parameters():
        weights[name] = mp.full(p, p.detach())
    tensors = {f"model.{k}": v for k, v in weights.items()}
    params = step.optimizer._params()
    for i, p in enumerate(params):
        tensors.update({f"opt.{i}.{k}": mp.full(p, v) for k, v in step.optimizer.state[p].items()})
    digest = {k: hashlib.blake2b(v.detach().cpu().contiguous().numpy().tobytes(),
                                 digest_size=16).hexdigest() for k, v in tensors.items()}
    named = list(model.named_parameters())
    grads = {k: mp.full(p, p.grad) for k, p in named}
    moments = {k: mp.full(p, step.optimizer.state[p]["exp_avg"]) for k, p in named}
    out = {"digest": digest, "count": step.optimizer.count}
    if values:
        out["model"] = {k: v.detach().cpu().clone() for k, v in weights.items()}
        out["grad"] = {k: g.cpu().clone() for k, g in grads.items()}
        out["moment"] = {k: m.cpu().clone() for k, m in moments.items()}
    return out


def dp_rank(rank: int, job: int, tmp: str, device: str) -> None:
    """Phase 27: one of the ranks of ``DP_JOBS[job]`` sharing the card over
    an explicit gloo group.  Each run trains from the job's weights on this
    rank's rows of the job's global batches with their global draws,
    recording per step the metrics, this rank's launches and its full state
    (rank 0 also the values); the first job's fp32 dp run then times
    DP_RATE_STEPS steps between two barriers, and the ``DP_SAVED`` runs save
    a checkpoint.  The first job then runs the harness with parallel.mp=2 on
    the job's records."""
    import datetime
    import os

    import torch.distributed as dist

    from hspose_tpu_torch.config import HSPoseConfig
    from hspose_tpu_torch.engine.checkpoint import save_checkpoint
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference
    from hspose_tpu_torch.parallel.mesh import batch_sharding, init_distributed, make_mesh

    world, runs = DP_JOBS[job]
    device = init_distributed(device, backend="gloo", init_method=f"file://{tmp}/store{job}",
                              rank=rank, world_size=world,
                              timeout=datetime.timedelta(seconds=JOIN_SECONDS))
    spec = torch.load(os.path.join(tmp, "job.pt"), weights_only=False)
    counts = {**counters(), **train_counters()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    got = {}
    for name, tier, dp, mp_size, steps, _ in runs:
        mesh = make_mesh(dp, 1, mp_size)
        cfg = HSPoseConfig(model=train_config(tier))
        model = build_train_model(device, cfg.model)
        model.load_state_dict(spec["start"])
        step = build_train_step(cfg, model, torch.Generator(device=device), mesh)
        rows = batch_sharding(mesh, len(spec["steps"][0][0]["cat_id"]))
        recs = []
        for i, (batch, draws) in enumerate(spec["steps"][:steps]):
            # the state before each step, for the one-process step from it
            save_checkpoint(os.path.join(tmp, name), model, step, epoch=i, seed=SEED)
            local = to_device({k: v[rows] for k, v in batch.items()}, device)
            reset_counts(counts)
            metrics = step(local, draws.to(device))
            sync()
            recs.append({"metrics": metrics, "launches": read_counts(counts),
                         **dp_state(model, step, rank == 0)})
        got[name] = {"steps": recs}
        if name == "float32":
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(DP_RATE_STEPS):
                step(local, draws.to(device))
            sync()
            dist.barrier()
            got[name]["rate"] = DP_RATE_STEPS / (time.perf_counter() - t0)
        if name in DP_SAVED:
            save_checkpoint(os.path.join(tmp, name), model, step, epoch=steps, seed=SEED)
            got[name]["final"] = dp_state(model, step, False)["digest"]
    if job == 0:
        counts = counters()
        reset_counts(counts)
        preds, _ = batched_pose_inference(spec["harness"], build_seeded_model(device),
                                          spec["records"], spec["seed"])
        sync()
        got["harness"] = {"RT": np.concatenate([r["pred_RTs"] for r in preds]),
                          "scales": np.concatenate([r["pred_scales"] for r in preds]),
                          "launches": read_counts(counts)}
    torch.save(got, os.path.join(tmp, f"job{job}_rank{rank}.pt"))
    dist.destroy_process_group()


def one_process_step(cfg, ckpt: str, batch: dict, draws, moved: float = 0.0) -> tuple:
    """The one-process train step on the card from the training state of
    ``ckpt`` on the global ``batch`` and ``draws``; with ``moved`` the input
    clouds are scaled by 1 + moved * z (z fixed normal draws).  Returns
    (metrics, parameters and BatchNorm buffers after the step, the
    gradients, Ranger's first moments, on the host)."""
    from hspose_tpu_torch.engine.checkpoint import restore_checkpoint
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device

    model = build_train_model(DEVICE, cfg.model)
    step = build_train_step(cfg, model, torch.Generator(device=DEVICE))
    restore_checkpoint(ckpt, model, step)
    if moved:
        z = np.random.default_rng(SEED + 50).standard_normal(batch["pcl_in"].shape)
        batch = dict(batch, pcl_in=(batch["pcl_in"] * (1.0 + moved * z)).astype(np.float32))
    metrics = step(to_device(batch, DEVICE), draws.to(DEVICE))
    named = list(model.named_parameters())
    return (metrics, {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            {k: p.grad.cpu() for k, p in named},
            {k: step.optimizer.state[p]["exp_avg"].cpu().clone() for k, p in named})


def step_readings(got: tuple, want: tuple) -> dict:
    """Two steps' (metrics, state after, gradients, Ranger's first moments)
    apart: the worst loss term's relative gap (``loss_rel``) and as a share
    of the total loss (``loss``); the worst BatchNorm statistic's gap as a
    share of its buffer's largest value (``bn``); 1 - the cosine of all
    gradients as one vector (``grad``); per leaf (those above ZERO_LEAF of
    the largest; the others must be as small on both sides, as phase 9
    holds them) the worst 1 - cosine (``leaf_cos``) and the worst |norm
    ratio - 1| (``leaf_ratio``); and of the first moments as one vector
    1 - the cosine (``update``) and the norm of the difference over the
    norm (``update_rel``).  The parameters themselves are not compared: at
    the warm-up's first rates (about 1e-7) an update lies a few fp32 steps
    from its parameter, and rounding moves it by 10-15 %."""
    (gm, gs, gg, gu), (wm, ws, wg, wu) = got, want

    def flat(x, keys):
        return torch.cat([x[k].double().ravel() for k in keys])

    def one_minus_cos(a, b):
        return 1.0 - (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()

    top = max(w.double().norm().item() for w in wg.values())
    leaf_cos, leaf_ratio, gated = 0.0, 0.0, []
    for k, w in wg.items():
        ng, nw = gg[k].double().norm().item(), w.double().norm().item()
        if nw <= ZERO_LEAF * top:
            # a bias that a train-mode BatchNorm follows: rounding noise on both sides
            leaf_ratio = max(leaf_ratio, 0.0 if ng <= ZERO_LEAF * top else float("inf"))
            continue
        gated.append(k)
        leaf_cos = max(leaf_cos, one_minus_cos(gg[k].double().ravel(), w.double().ravel()))
        leaf_ratio = max(leaf_ratio, abs(ng / nw - 1.0))
    g, w = flat(gg, wg), flat(wg, wg)
    u, v = flat(gu, wu), flat(wu, wu)
    return {"loss_rel": max(abs(gm[k] - x) / max(abs(x), 1e-12) for k, x in wm.items()
                            if k != "skipped_nan"),
            "loss": max(abs(gm[k] - x) for k, x in wm.items()) / abs(wm["total_loss"]),
            "bn": max(((gs[k] - x).abs().max() / x.abs().max().clamp_min(1e-30)).item()
                      for k, x in ws.items() if "running" in k),
            "grad": one_minus_cos(g, w), "leaf_cos": leaf_cos, "leaf_ratio": leaf_ratio,
            "update": one_minus_cos(u, v), "update_rel": ((u - v).norm() / v.norm()).item()}


def start_dp_job(job: int, tmp: str) -> list:
    """Phase 27: the ranks of ``DP_JOBS[job]`` spawned on ``cuda:0``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(r, job, tmp, f"{DEVICE}:0"))
             for r in range(DP_JOBS[job][0])]
    for p in procs:
        p.start()
    return procs


def join_dp_job(job: int, tmp: str, procs: list) -> list:
    """Phase 27: wait for ``start_dp_job``'s ranks; their records."""
    for p in procs:
        p.join(timeout=4 * JOIN_SECONDS)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode for p in procs):
        raise AssertionError(f"the ranks of phase 27's job {job} failed: exit codes "
                             f"{[p.exitcode for p in procs]}")
    return [torch.load(f"{tmp}/job{job}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def check_dp_job(phase: str, job: int, tmp: str, ranks: list, steps: list, bad: list) -> None:
    """Phase 27: the runs of ``DP_JOBS[job]``: the launches and the ranks'
    equal states (raised at once), then each step against the one-process
    step from the same state, read in full and gated by the run's fp32
    gates, or in bf16 by SPREAD_MULT x the card's own spread;
    the spread is read for every run (in fp32 a second witness).  A gate
    missed is appended to ``bad``."""
    import os

    from hspose_tpu_torch.config import HSPoseConfig
    from hspose_tpu_torch.engine.checkpoint import restore_checkpoint
    from hspose_tpu_torch.engine.train_step import build_train_step

    for name, tier, dp, mp_size, n_steps, gates in DP_JOBS[job][1]:
        cfg = HSPoseConfig(model=train_config(tier))
        what = f"{name} (dp={dp}, mp={mp_size}, {TRAIN_B // dp} rows a rank)"
        for r, got in enumerate(ranks):
            for i, rec in enumerate(got[name]["steps"]):
                check_counts(rec["launches"], TRAIN_LAUNCHES[tier], 1,
                             f"rank {r} {name} step {i}")
                same = rec["digest"] == ranks[0][name]["steps"][i]["digest"]
                if not same or rec["count"] != i + 1 or rec["metrics"]["skipped_nan"]:
                    raise AssertionError(f"rank {r} {what} step {i}: state the same as rank "
                                         f"0's {same}, count {rec['count']}")
        launched = {k: v for k, v in ranks[0][name]["steps"][0]["launches"].items() if v}
        log(phase, f"{what}: launches per step on each of {len(ranks)} ranks {launched}; all "
                   f"ranks' parameters, BatchNorm buffers and Ranger state bit for bit equal "
                   f"after each of {n_steps} steps")
        # each step against the one-process step from the same state (the
        # run's checkpoint before it): chained runs part through selection flips
        for i, rec in enumerate(ranks[0][name]["steps"]):
            ckpt = os.path.join(tmp, name, f"model_{i:03d}")
            m, after, grads, moments = one_process_step(cfg, ckpt, *steps[i])
            g = step_readings((rec["metrics"], rec["model"], rec["grad"], rec["moment"]),
                              (m, after, grads, moments))
            # the card's own spread: the one-process step from the same state
            # with the input clouds moved by SPREAD_EPS relative, both ways
            spread = {k: 0.0 for k in g}
            for sign in (1.0, -1.0):
                d = step_readings(one_process_step(cfg, ckpt, *steps[i], sign * SPREAD_EPS),
                                  (m, after, grads, moments))
                spread = {k: max(spread[k], d[k]) for k in g}
            log(phase, f"{what} step {i} against the one-process step from its state: "
                       + ", ".join(f"{k} {g[k]:.3e}" for k in g)
                       + "; the card's own spread: "
                       + ", ".join(f"{k} {spread[k]:.3e}" for k in g)
                       + ("; gates " + ", ".join(f"{k} {v:g}" for k, v in gates.items())
                          if gates else "")
                       + f"; bound {SPREAD_MULT} x spread on {', '.join(SPREAD_KEYS)}")
            missed = {k: g[k] for k in SPREAD_KEYS if not g[k] <= SPREAD_MULT * spread[k]}
            if gates:
                missed.update({k: g[k] for k, v in gates.items() if not g[k] <= v})
            if missed:
                bad.append(f"{what} step {i}: {missed}")
        if name in DP_SAVED:
            model = build_train_model(DEVICE, cfg.model)
            step = build_train_step(cfg, model, torch.Generator(device=DEVICE))
            restore_checkpoint(os.path.join(tmp, name, f"model_{n_steps:03d}"), model, step)
            same = dp_state(model, step, False)["digest"] == ranks[0][name]["final"]
            log(phase, f"{what} checkpoint restored in one process: the run's full state "
                       f"bit for bit {same}")
            if not same:
                raise AssertionError(f"{what}: the restored checkpoint is not the run's state")


def phase_dp_train(smi: str, ranks_done=None) -> None:
    """Phase 27, part 1: the ranks of each of ``DP_JOBS`` on the card over
    an explicit gloo group (``dp_rank``) train their runs from one set of
    weights on global batches of (TRAIN_B, N) with the draws pinned, each
    rank on its rows; ``check_dp_job`` holds each run to the one-process
    step; the harness with parallel.mp=2 against the one-process harness.
    The second job runs beside the first's comparisons; ``ranks_done`` is
    called once the first job's ranks have ended.  Every reading is printed
    before a missed gate raises."""
    import dataclasses
    import tempfile

    from hspose_tpu_torch.config import ParallelConfig
    from hspose_tpu_torch.models.hspose import draw_train
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    phase = "dp-train"
    start = {k: v.cpu() for k, v in build_train_model(DEVICE, train_config("float32"))
             .state_dict().items()}
    steps = [(synthetic_train_batch(TRAIN_B, N, seed=SEED + 40 + i),
              draw_train(torch.Generator().manual_seed(SEED + 45 + i), TRAIN_B, N))
             for i in range(DP_STEPS)]
    records, seed = harness_records(np.random.default_rng(SEED + 32), N, HARNESS_BATCHES), SEED
    mp_harness = dataclasses.replace(harness_config(), parallel=ParallelConfig(dp=1, mp=2))
    bad: list = []
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"start": start, "steps": steps, "records": records, "seed": seed,
                    "harness": mp_harness}, f"{tmp}/job.pt")
        t0 = time.perf_counter()
        ranks = join_dp_job(0, tmp, start_dp_job(0, tmp))
        log(phase, f"{DP_JOBS[0][0]} ranks on cuda:0 over gloo: {time.perf_counter() - t0:.1f} s "
                   "with start-up")
        if ranks_done is not None:  # what may run beside the one-process comparisons
            ranks_done()
        t0, second = time.perf_counter(), start_dp_job(1, tmp)
        try:
            check_dp_job(phase, 0, tmp, ranks, steps, bad)
            log(phase, f"{ranks[0]['float32']['rate']:.3f} steps/s at B={TRAIN_B} fp32, dp=2 on "
                       f"two ranks sharing one card over gloo (not a multi-GPU rate) on {smi}")
            four = join_dp_job(1, tmp, second)
        finally:
            for p in second:
                if p.is_alive():
                    p.kill()
        log(phase, f"{DP_JOBS[1][0]} ranks on cuda:0 over gloo beside the comparisons: "
                   f"{time.perf_counter() - t0:.1f} s with start-up")
        check_dp_job(phase, 1, tmp, four, steps, bad)

    # the mp ranks multiply the concatenated feature in the heads: so does the
    # one-process harness they are held to
    one = build_seeded_model(DEVICE)
    one.factored = lambda: False
    preds, _ = run_harness(harness_config(), one, records, seed)
    want_RT = np.concatenate([r["pred_RTs"] for r in preds])
    want_s = np.concatenate([r["pred_scales"] for r in preds])
    for r, got in enumerate(ranks):
        h = got["harness"]
        check_counts(h["launches"], dict(SERVE_LAUNCHES["float32"], **CONCAT_HEADS),
                     HARNESS_BATCHES, f"rank {r} mp harness batch")
        d_rt, d_s = np.abs(h["RT"] - want_RT).max(), np.abs(h["scales"] - want_s).max()
        log(phase, f"rank {r}: parallel.mp=2 harness, {HARNESS_BATCHES} batches of ({B}, {N}, 3), "
                   f"against the one-process harness: max abs RT {d_rt:.3e} (bound {MP_RT_ATOL}), "
                   f"scales {d_s:.3e} (bound {MP_S_ATOL})")
        if not (d_rt <= MP_RT_ATOL and d_s <= MP_S_ATOL):
            bad.append(f"rank {r}: the mp harness's poses are not the one-process ones")
    if bad:
        raise AssertionError("phase 27 missed its gates:\n" + "\n".join(bad))


class Cli:
    """A CLI run in the background from the repo's root, its output in
    files under ``out``; ``wait`` returns (stdout, seconds) or raises with
    the run's output when it failed."""

    def __init__(self, out: str, name: str, args: list):
        import os

        self.path, self.args = os.path.join(out, name), args
        self.t0 = time.perf_counter()
        with open(self.path + ".out", "w") as o, open(self.path + ".err", "w") as e:
            self.proc = subprocess.Popen([sys.executable, *args], stdout=o, stderr=e,
                                         cwd=os.path.dirname(os.path.abspath(__file__)))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def wait(self, timeout: float = 600) -> tuple:
        try:
            code = self.proc.wait(timeout=timeout)
        finally:
            self.stop()
        seconds = time.perf_counter() - self.t0
        with open(self.path + ".out") as o, open(self.path + ".err") as e:
            stdout, stderr = o.read(), e.read()
        if code:
            raise AssertionError(f"{' '.join(self.args[:6])} failed ({code}):\n"
                                 f"{stdout[-3000:]}\n{stderr[-3000:]}")
        return stdout, seconds


def run_losses(path: str) -> dict:
    """Step -> total loss from a train run's ``metrics.jsonl``."""
    with open(f"{path}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["total_loss"] for r in recs if "total_loss" in r}


def dp_cli_args(tree: str) -> tuple:
    """Phase 27's CLI arguments on phase 23's tree: (data, phase 23's recipe)."""
    data = [f"data.dataset_dir={tree}/NOCS", f"data.detection_dir={tree}/segmentation_results"]
    recipe = [f"train.batch_size={TRAIN_B}", f"train.train_steps={LOOP_STEPS}",
              f"train.total_epoch={LOOP_EPOCHS}", "train.save_every=1", "train.log_every=1",
              f"train.seed={SEED + 13}"]
    return data, recipe


def start_dp_cli(tree: str, out: str) -> Cli:
    """Phase 27, part 2 begins: the train CLI under ``torchrun --standalone
    --nproc_per_node=<device count>`` with nccl on phase 23's tree and
    recipe, a checkpoint every epoch, in the background."""
    data, recipe = dp_cli_args(tree)
    return Cli(out, "dist", ["-m", "torch.distributed.run", "--standalone",
                             f"--nproc_per_node={torch.cuda.device_count()}", "-m",
                             "hspose_tpu_torch.engine.train", *data, *recipe,
                             f"train.model_save={out}/dist"])


def phase_dp_cli(smi: str, tree: str, out: str, losses: dict, dist_cli: Cli) -> None:
    """Phase 27, part 2: ``start_dp_cli``'s run (with one card its losses are
    phase 23's unbroken run's, ``losses``); then, side by side, the
    one-process train CLI resumes its epoch-0 checkpoint for epoch 1 within
    RESUME_LOSS_REL of its losses, and the one-process eval CLI serves its
    last checkpoint."""
    phase = "dp-cli"
    cards = torch.cuda.device_count()
    data, recipe = dp_cli_args(tree)

    _, seconds = dist_cli.wait()
    got = run_losses(f"{out}/dist")
    gap = max(abs(got[k] - v) / abs(v) for k, v in losses.items())
    log(phase, f"torchrun --nproc_per_node={cards} (nccl) train CLI, {LOOP_EPOCHS} epochs of "
               f"{LOOP_STEPS} steps at B={TRAIN_B}, phase 23's recipe: {seconds:.1f} s from its "
               f"start; its losses against phase 23's unbroken run: bit for bit {got == losses}, "
               f"largest relative gap {gap:.3e}" + (" (one card: the same run)" if cards == 1
                                                    else ""))
    if sorted(got) != sorted(losses) or (cards == 1 and not gap <= RESUME_LOSS_REL):
        raise AssertionError(f"torchrun train CLI losses {got} against {losses}")
    ckpt = f"{out}/dist/model_{LOOP_EPOCHS - 1:03d}"
    resume = Cli(out, "resumed", ["-m", "hspose_tpu_torch.engine.train", *data, *recipe,
                                  "train.resume=true", f"train.resume_model={out}/dist/model_000",
                                  f"train.model_save={out}/resumed"])
    serve = Cli(out, "eval", ["-m", "hspose_tpu_torch.evaluation.evaluate", *data,
                              "eval.eval_seed=5", f"train.resume_model={ckpt}",
                              f"train.model_save={out}/eval"])
    try:
        check_resume_and_serve(smi, out, ckpt, got, resume, serve)
    finally:
        resume.stop()
        serve.stop()


def check_resume_and_serve(smi: str, out: str, ckpt: str, got: dict, resume: Cli,
                           serve: Cli) -> None:
    """Phase 27, part 2's last checks: the resumed run's losses and the
    eval CLI's predictions."""
    import os

    phase = "dp-cli"

    _, seconds = resume.wait()
    resumed = run_losses(f"{out}/resumed")
    gap = max(abs(v - got[k]) / abs(got[k]) for k, v in resumed.items())
    log(phase, f"one-process train CLI resumed the torchrun run's epoch-0 checkpoint: "
               f"{seconds:.1f} s, steps {sorted(resumed)}, largest relative loss gap to the "
               f"torchrun run's {gap:.3e} (bound {RESUME_LOSS_REL})")
    if sorted(resumed) != sorted(got)[LOOP_STEPS:] or not gap <= RESUME_LOSS_REL:
        raise AssertionError(f"the resumed run's losses {resumed} against {got}")
    stdout, seconds = serve.wait()
    pkl = os.path.join(out, "eval", f"eval_result_{os.path.basename(ckpt)}", "pred_result.pkl")
    log(phase, f"one-process eval CLI served the torchrun run's last checkpoint beside the "
               f"resume: {seconds:.1f} s, pred_result.pkl written {os.path.exists(pkl)}, mAP "
               f"table printed {'3D IoU at 25:' in stdout} on {smi}")
    if not os.path.exists(pkl) or "3D IoU at 25:" not in stdout:
        raise AssertionError("the eval CLI did not serve the torchrun checkpoint")


HEADS_B = 96  # phase 28: the serving cells' eval.eval_batch
# phase 28's gates, the CPU tests' (tests/test_torch_port_heads_factored.py; bf16 poses
# tests/test_torch_port_bf16.py): the routes add the same products in another order
HEADS_FP32_REL = 1e-5  # fp32: of each head's largest block output, and of the poses
HEADS_ORDER_REL = 2.0 ** -16  # bf16: a K = 1286 fp32 sum's order, of the largest sum
HEADS_POSE_ATOL_BF16 = 1e-2  # bf16 poses


def heads_maps(rng, dt: torch.dtype, b: int, n: int):
    """Phase 28's inputs: ReLU'd random maps of the backbone's widths in the
    tier's type, uniform 1-NN indices, categories and centred points."""
    from hspose_tpu_torch.models.face_recon import BackboneMaps

    n1, n2 = n // 4, n // 16

    def fm(m, c):
        return torch.relu(normal(rng, b, m, c)).to(dt)

    def up(m):
        return torch.from_numpy(rng.integers(0, m, size=(b, n)).astype(np.int32)).to(DEVICE)

    maps = BackboneMaps(fm(n, 128), fm(n, 128), fm(n1, 256), fm(n1, 256), fm(n2, 512), up(n1),
                        up(n2))
    cat = torch.from_numpy(rng.integers(0, 6, size=b).astype(np.int32)).to(DEVICE)
    return maps, cat, cloud_b(rng, b, n)


def phase_heads(smi: str) -> dict:
    """Phase 28: the serving heads' first block at B=96, N=1028 in both tiers.
    The epilogue kernel against its plain version on the card (fp32: within
    TOL_REL of the largest value, and written over P0 as the serving route
    writes it with the same bits; bf16: within one bf16 ulp of each element),
    its time beside its bound (P0 and P1, P2 read once, h written once), the
    three products per resolution beside the three 1286-K products of the
    concatenated route, the whole block both ways (the factored route: two
    concats, three products, the epilogue; the concatenated: the feature's
    gathers and concat, three conv1 products, bn1 and ReLU) and their
    outputs' gap, and the B=96 ``eval_forward`` both ways and its pose gap,
    both gaps held to the CPU tests' bounds (HEADS_*).  Raises after both
    tiers have printed every reading."""
    phase, rec, failed = "heads", {}, []
    rng = np.random.default_rng(SEED + 28)
    for dtype in ("float32", "bfloat16"):
        with torch.no_grad():
            heads_tier(phase, rec, rng, dtype, smi, failed)
    if failed:
        raise AssertionError("heads: " + "; ".join(failed))
    return rec


def heads_tier(phase: str, rec: dict, rng, dtype: str, smi: str, failed: list) -> None:
    """Phase 28 in one tier; what fails its gate is appended to ``failed``."""
    from hspose_tpu_torch.models.face_recon import batch_norm
    from hspose_tpu_torch.models.heads import _product
    from hspose_tpu_torch.models.hspose import eval_forward
    from hspose_tpu_torch.models.layers import dense
    from hspose_tpu_torch.ops.heads_epilogue import heads_epilogue, heads_epilogue_plain
    from hspose_tpu_torch.ops.knn import gather_neighbors

    dt = getattr(torch, dtype)
    bf16 = dt == torch.bfloat16
    tag = "_bf16" if bf16 else ""
    model = build_seeded_model(DEVICE, dtype)
    fl = model.first_layers
    w0, w1, w2, wcat, wxyz, params = fl.consts()
    maps, cat, xyz = heads_maps(rng, dt, HEADS_B, N)
    xyz = xyz.to(dt)
    a = (torch.cat([maps.fm_0, maps.fm_1], -1), torch.cat([maps.fm_2, maps.fm_3], -1),
         maps.fm_4)
    p = [_product(x, w) for x, w in zip(a, (w0, w1, w2))]
    rest = (*p[1:], maps.up_1, maps.up_2, cat, xyz, wcat, wxyz, params)
    got, want = heads_epilogue(p[0], *rest), heads_epilogue_plain(p[0], *rest)
    same_in_place = True
    if not bf16:  # the serving route's form: h over P0
        buf = p[0].clone()
        same_in_place = bool(torch.equal(heads_epilogue(buf, *rest, out=buf), got))
    torch.cuda.synchronize()
    gap = (got.float() - want.float()).abs()
    if bf16:
        ok = bool((gap <= bf16_ulp(want.float())).all())
    else:
        ok = float(gap.max()) <= TOL_REL * float(want.abs().max())
    err = float(gap.max())
    if bf16:
        ms = cuda_ms(lambda: heads_epilogue(p[0], *rest))
    else:
        ms = cuda_ms(lambda: heads_epilogue(buf, *rest, out=buf))
    plain_ms = cuda_ms(lambda: heads_epilogue_plain(p[0], *rest), iters=5)
    bnd = bound((p[0], got), 0, torch.float32, nbytes=sum(
        t.numel() * t.element_size() for t in (p[1], p[2], maps.up_1, maps.up_2, xyz)))
    record(rec, "heads_epilogue" + tag, err, ms, plain_ms, bnd)
    log(phase, f"{dtype} epilogue at B={HEADS_B}, N={N}: max |kernel - plain| {err:.3e} "
               f"(bits equal {bool((got == want).all())}"
               + ("" if bf16 else f"; over P0 the same bits {same_in_place}")
               + f"), {ms:.3f} ms{'' if bf16 else ' over P0'}, plain {plain_ms:.3f} ms, bound "
               f"{bnd[0]:.3f} ms ({bnd[1]}, {ms / bnd[0]:.2f}x) on {smi}")
    if not (ok and same_in_place):
        failed.append(f"{dtype} epilogue against plain {err:.3e}, over P0 the same bits "
                      f"{same_in_place}")

    # the three products per resolution, then the 1286-K products they replace
    prod_ms = [cuda_ms(lambda x=x, w=w: _product(x, w)) for x, w in zip(a, (w0, w1, w2))]
    heads = [head.vec for head in model.pose_heads()]

    def feat():
        return torch.cat([maps.fm_0, maps.fm_1,
                          gather_neighbors(maps.fm_2, maps.up_1[..., None])[:, :, 0],
                          gather_neighbors(maps.fm_3, maps.up_1[..., None])[:, :, 0],
                          gather_neighbors(maps.fm_4, maps.up_2[..., None])[:, :, 0],
                          torch.nn.functional.one_hot(cat.long(), 6).to(dt)[:, None, :]
                          .expand(HEADS_B, N, 6)], -1)

    def conv1(v, x, fp32_sums=False):
        """A head's conv1 as ``VecHead.forward`` runs it, and the tensors its
        sum was rounded as (bf16).  ``fp32_sums``: each bf16 product summed
        in fp32 and rounded once with its bias, as the CPU's ``F.linear``
        does (the CPU test's reference), instead of by cuBLAS."""
        if fp32_sums:
            b = v.conv1.bias.to(dt).float()
            if v is not heads[-1]:
                pre = torch.addmm(b, x.float().reshape(-1, x.shape[-1]),
                                  v.conv1.weight.to(dt).float().t()).reshape(
                    *x.shape[:-1], -1).to(dt)
                return pre, [pre]
            w = v.conv1.weight.to(dt).float()
            q = (x.float() @ w[:, :1286].t()).to(dt)
            r = (xyz.float() @ w[:, 1286:].t()).to(dt)
            pre = ((q.float() + r.float()).to(dt).float() + b).to(dt)
            return pre, [q, r, (q.float() + r.float()).to(dt), pre]
        if v is not heads[-1]:
            pre = dense(v.conv1, x, dt)
            return pre, [pre]
        w = v.conv1.weight.to(dt)
        q, r = x @ w[:, :1286].t(), xyz @ w[:, 1286:].t()
        pre = q + r + v.conv1.bias.to(dt)
        return pre, [q, r, q + r, pre]

    f = feat()
    old_ms = [cuda_ms(lambda v=v: conv1(v, f)[0]) for v in heads]
    log(phase, f"{dtype} products per resolution (K = 256, 512, 512; 3072 columns, fp32 "
               f"out): {' + '.join(f'{t:.3f}' for t in prod_ms)} = {sum(prod_ms):.3f} ms; "
               f"the concatenated route's conv1 (K = 1286, 1286, 1289; 1024 columns): "
               f"{' + '.join(f'{t:.3f}' for t in old_ms)} = {sum(old_ms):.3f} ms")
    del f

    # the whole first block both ways, and its outputs' gap
    def factored():
        return fl(maps, cat, xyz)

    def concatenated():
        f = feat()
        return [torch.relu(batch_norm(v.bn1, conv1(v, f)[0])) for v in heads]

    f_ms, c_ms = cuda_ms(factored), cuda_ms(concatenated)
    f = feat()

    def against(fp32_sums):
        """Each head's largest gap over its largest value and over its bound;
        bf16 also over the CPU test's bound."""
        gaps, worst, cpu = [], [], []
        for v, hg in zip(heads, factored()):
            pre, parts = conv1(v, f, fp32_sums)
            hw = torch.relu(batch_norm(v.bn1, pre)).float()
            gap = (hg.float() - hw).abs()
            gaps.append(float(gap.max() / hw.abs().max()))
            if bf16:  # per element
                scale = (torch.rsqrt(v.bn1.running_var + v.bn1.eps) * v.bn1.weight).abs()
                order = HEADS_ORDER_REL * float(parts[-1].float().abs().max())
                ulps = sum(bf16_ulp(x) for x in parts)
                cpu.append(float((gap / (scale * (ulps + order) + bf16_ulp(hw))).max()))
                half = 0.5 * scale * bf16_ulp(parts[-1]) + 0.5 * bf16_ulp(hw)
                worst.append(float((gap / (scale * (ulps + order) + bf16_ulp(hw) + half)).max()))
            else:
                worst.append(gaps[-1] / HEADS_FP32_REL)
            del pre, parts, hw, gap
        return gaps, worst, cpu

    def show(gaps, worst, cpu):
        return (f"largest gap of each head's output over its largest value "
                f"{', '.join(f'{g:.2e}' for g in gaps)}, over its bound "
                f"{', '.join(f'{w:.3f}' for w in worst)}"
                + (f" (over the CPU test's {', '.join(f'{w:.3f}' for w in cpu)})" if cpu else ""))

    # bf16: the gate holds the factored route to the CPU test's reference,
    # conv1 as fp32 sums of the bf16 products rounded once with the bias, not
    # to cuBLAS's bf16 products (printed), and to the CPU test's bound (one
    # ulp of every rounding, carried by bn1's scale, plus one of the output)
    # with half an ulp more at the factored route's own rounding and at the
    # output: where the factored value rounds into the binade above the
    # reference's, its half ulp is a whole one of the reference's, which the
    # 3e8 elements of a B = 96 block meet and the CPU test's 8e5 need not
    gaps, worst, cpu = against(False)
    log(phase, f"{dtype} first block at B={HEADS_B}: factored {f_ms:.3f} ms, concatenated "
               f"{c_ms:.3f} ms ({c_ms / f_ms:.2f}x); against the concatenated route: "
               + show(gaps, worst, cpu))
    if bf16:
        gaps, worst, cpu = against(True)
        log(phase, f"{dtype} first block against conv1 as fp32 sums of its bf16 products "
                   f"(reduced-precision bf16 reductions allowed in cuBLAS: "
                   f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}): "
                   + show(gaps, worst, cpu))
    del f
    if max(worst) > 1:
        failed.append(f"{dtype} first block: gap over its bound {max(worst):.3f}")

    # the served forward both ways
    pc = cloud_b(rng, HEADS_B, N)
    obj = torch.from_numpy(rng.integers(0, 6, size=HEADS_B).astype(np.int32)).to(DEVICE)
    smp = [torch.from_numpy(rng.permutation(N)[:N // 4]).to(DEVICE)]
    smp.append(torch.from_numpy(rng.permutation(N // 4)[:N // 16]).to(DEVICE))
    fwd_ms = cuda_ms(lambda: eval_forward(model, pc, obj, pool_samples=smp), iters=10)
    out = eval_forward(model, pc, obj, pool_samples=smp)
    cat_ms = cuda_ms(lambda: concatenated_forward(model, pc, obj, smp), iters=10)
    ref = concatenated_forward(model, pc, obj, smp)
    pose_gap = max(float((x - y).abs().max()) for x, y in zip(out, ref))
    # per output: bf16 an absolute bound, fp32 relative to the output's largest value or 1
    over = max(float((x - y).abs().max()) / (HEADS_POSE_ATOL_BF16 if bf16 else HEADS_FP32_REL
                                             * max(float(y.abs().max()), 1.0))
               for x, y in zip(out, ref))
    log(phase, f"{dtype} eval_forward at B={HEADS_B}, N={N}: factored {fwd_ms:.3f} ms, "
               f"concatenated {cat_ms:.3f} ms ({cat_ms / fwd_ms:.2f}x); largest pose gap "
               f"{pose_gap:.3e}, largest over its bound {over:.3f}")
    if not all(bool(torch.isfinite(x).all()) for x in out):
        failed.append(f"{dtype}: non-finite poses on the factored route")
    if not over <= 1:
        failed.append(f"{dtype} pose gap over its bound {over:.3f}")


GRAPH_BATCHES = (96, 24)  # phase 29: the benchmark's eval.eval_batch and the eval CLI's
GRAPH_PROFILED = 3  # phase 29: forwards profiled on each route (< 1024 queued launches)
GRAPH_TIMED = 20  # phase 29: forwards timed on each route
GRAPH_DEVICE_REL = 0.05  # phase 29: device time a forward, graph against eager
GRAPH_HARNESS_CROPS = 13 * B  # phase 29: three batches of 96 and a short one of 24


@contextlib.contextmanager
def eager_route():
    """Serve every forward on the eager route inside the block, op by op:
    phase 29's other side, and phase 26's one-process forward, whose
    intermediates ``sp_probe`` reads as they run (a CUDA graph replay,
    ``models/graphed.py``, runs no Python)."""
    from hspose_tpu_torch.models import graphed

    real = graphed.eligible
    graphed.eligible = lambda *args: False
    try:
        yield
    finally:
        graphed.eligible = real


def device_kernels(fn, n: int, start=None) -> tuple[float, float, dict]:
    """Kernels a call of ``fn`` runs as ``torch.profiler`` sees them from a
    session started after the call's first run (a graph captured before it):
    (count, device ms summed, count by name), each a call, copies and sets
    left out, as ``portbench/trace.py`` leaves them out.  A sleep kernel
    holds the card while the host enqueues the ``n`` calls, so that both
    routes' kernels run back to back at the clocks of a busy card; or
    ``start()`` is the session's first device work."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if start is None:
            torch.cuda._sleep(QUEUE_CYCLES * 5)
        else:
            start()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation
          and not any(p in e.name for p in ("Memcpy", "Memset", "spin_kernel"))]
    ms = sum(e.time_range.end - e.time_range.start for e in ks) / 1e3
    return len(ks) / n, ms / n, Counter(e.name for e in ks)


def host_and_wall_ms(fn) -> tuple[float, float]:
    """(host ms of a call on an idle card, wall ms a call back to back),
    over GRAPH_TIMED calls each."""
    fn()
    host = 0.0
    for _ in range(GRAPH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAPH_TIMED):
        fn()
    torch.cuda.synchronize()
    return 1e3 * host / GRAPH_TIMED, 1e3 * (time.perf_counter() - t0) / GRAPH_TIMED


def phase_graph(smi: str) -> dict:
    """Phase 29: the served forward as one CUDA graph replay
    (``models/graphed.py``) against the eager route, in both tiers at B = 96
    and 24, N = 1028: the poses of both routes (bit for bit, or the largest
    gap within phase 28's bounds), the capture's time, two replays' outputs
    unaliased, a recapture after ``load_state_dict`` serving the new weights,
    the host's enqueue and the wall time a forward on each route, and the
    kernels a profiler session started after the capture sees on each route
    (every eager kernel, device time within GRAPH_DEVICE_REL, each route's
    lower of two sessions in turns) and the
    replays' serving kernels against SERVE_LAUNCHES (``served``); then the
    harness,
    pinned uploads and graph replays, against the harness on the eager
    route, bit for bit, with each one's crops/s.  Raises after every
    reading has printed."""
    from hspose_tpu_torch.evaluation.evaluate import batched_pose_inference
    from hspose_tpu_torch.models.hspose import eval_forward

    phase, rec, failed = "graph", {}, []
    rng = np.random.default_rng(SEED + 29)
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        model = build_seeded_model(DEVICE, dtype)

        def over(got, want):
            """The largest gap over its phase-28 bound, and whether every bit agrees."""
            worst = max(float((x - y).abs().max()) / (
                HEADS_POSE_ATOL_BF16 if bf16 else HEADS_FP32_REL * max(float(y.abs().max()), 1.0))
                for x, y in zip(got, want))
            return worst, all(torch.equal(x, y) for x, y in zip(got, want))

        for b in GRAPH_BATCHES:
            label = f"{dtype} B={b}"
            pc, pc2 = cloud_b(rng, b, N), cloud_b(rng, b, N)
            obj = torch.from_numpy(rng.integers(0, 6, size=b).astype(np.int32)).to(DEVICE)
            smp = [torch.from_numpy(rng.permutation(N)[:N // 4]).to(DEVICE),
                   torch.from_numpy(rng.permutation(N // 4)[:N // 16]).to(DEVICE)]

            def graph(x=pc):
                return eval_forward(model, x, obj, pool_samples=smp)

            def eager(x=pc):
                with eager_route():
                    return eval_forward(model, x, obj, pool_samples=smp)

            want, want2 = eager(), eager(pc2)
            captures = model.graphs.captures
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = graph()
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            first = [x.clone() for x in got]
            got2 = graph(pc2)
            gap, bits = over(got, want)
            gap2, bits2 = over(got2, want2)
            unaliased = (all(torch.equal(x, y) for x, y in zip(got, first))
                         and not {x.data_ptr() for x in got} & {x.data_ptr() for x in got2})
            log(phase, f"{label}: capture and first replay {capture_s:.3f} s; graph against "
                       f"eager poses bit for bit {bits} / {bits2} (largest gap over its bound "
                       f"{gap:.3f} / {gap2:.3f}); two replays' outputs unaliased {unaliased}")
            if not (gap <= 1 and gap2 <= 1 and unaliased):
                failed.append(f"{label}: gap {gap:.3f} / {gap2:.3f}, unaliased {unaliased}")

            # two sessions a route in turns, each route's lower device time: a
            # session at a low clock reads neither route
            runs = {eager: [], graph: []}
            for fn in (eager, graph, eager, graph):
                runs[fn].append(device_kernels(fn, GRAPH_PROFILED))
            n_e, ms_e, names_e = min(runs[eager], key=lambda r: r[1])
            n_g, ms_g, names_g = min(runs[graph], key=lambda r: r[1])
            replays = served(lambda: [graph() for _ in range(GRAPH_PROFILED)])
            try:  # the replays' serving kernels, by name, against SERVE_LAUNCHES
                check_served(replays, SERVE_LAUNCHES[dtype], GRAPH_PROFILED, f"{label} replays",
                             warm=True)
            except AssertionError as e:
                failed.append(str(e))
            host_e, wall_e = host_and_wall_ms(eager)
            host_g, wall_g = host_and_wall_ms(graph)
            missing, extra = dict(names_e - names_g), dict(names_g - names_e)
            log(phase, f"{label}: profiler started after the capture sees {n_g:.1f} kernels a "
                       f"graphed forward, {ms_g:.3f} device ms, against {n_e:.1f} and {ms_e:.3f} "
                       f"eager ({ms_g / ms_e:.4f}x; kernels the graph's lack {missing}, kernels "
                       f"only the graph's have {extra}); serving kernels over {GRAPH_PROFILED} "
                       f"replays {replays.kernels}; host "
                       f"enqueue {host_g:.3f} ms graph, {host_e:.3f} ms eager; wall a forward "
                       f"back to back {wall_g:.3f} ms graph, {wall_e:.3f} ms eager on {smi}")
            rec[f"{dtype}_b{b}"] = {"capture_s": capture_s, "bits": bits and bits2,
                                    "kernels": [n_g, n_e], "device_ms": [ms_g, ms_e],
                                    "host_ms": [host_g, host_e], "wall_ms": [wall_g, wall_e]}
            # the graph's own copies (inputs in, outputs out) may add kernels
            if missing or n_g < n_e or abs(ms_g / ms_e - 1) > GRAPH_DEVICE_REL:
                failed.append(f"{label}: profiled kernels {n_g} / {n_e}, device ms "
                              f"{ms_g:.3f} / {ms_e:.3f}")

            # new weights: the next call captures anew and serves them
            state = {k: (v * 1.01 if v.is_floating_point() else v)
                     for k, v in model.state_dict().items()}
            model.load_state_dict(state)
            want3, got3 = eager(), graph()
            gap3, bits3 = over(got3, want3)
            captured = model.graphs.captures - captures
            moved = not all(torch.equal(x, y) for x, y in zip(got3, first))
            log(phase, f"{label}: after load_state_dict {captured} captures at this B in all "
                       f"(the old weights' graph dropped); poses moved {moved}, against eager "
                       f"bit for bit {bits3} (largest gap over its bound {gap3:.3f})")
            if not (captured == 2 and moved and gap3 <= 1):
                failed.append(f"{label}: captures {captured}, moved {moved}, gap {gap3:.3f}")

        # the harness: pinned uploads and graph replays against the eager route
        for b in GRAPH_BATCHES:
            records = harness_records(np.random.default_rng(SEED + 30), N,
                                      GRAPH_HARNESS_CROPS // B)
            cfg = harness_config(dtype)
            cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, eval_batch=b))
            runs = {}
            for route in ("graph", "eager", "graph"):
                ctx = eager_route() if route == "eager" else contextlib.nullcontext()
                with ctx:
                    preds, rate = batched_pose_inference(cfg, model, copy.deepcopy(records),
                                                         SEED)
                runs.setdefault(route, []).append(
                    (np.concatenate([r["pred_RTs"] for r in preds]),
                     np.concatenate([r["pred_scales"] for r in preds]), rate))
            same = all(np.array_equal(g[0], e[0]) and np.array_equal(g[1], e[1])
                       for g in runs["graph"] for e in runs["eager"])
            gap = max(float(np.abs(g[i] - runs["eager"][0][i]).max())
                      for g in runs["graph"] for i in (0, 1))
            log(phase, f"{dtype} harness, eval_batch {b}, {GRAPH_HARNESS_CROPS} crops: graph "
                       f"route and pinned uploads against the eager route bit for bit {same} "
                       f"(largest gap {gap:.3e}); crops/s graph "
                       f"{', '.join(f'{g[2]:.1f}' for g in runs['graph'])}, eager "
                       f"{runs['eager'][0][2]:.1f} on {smi}")
            rec[f"{dtype}_harness_b{b}"] = {"same": same, "gap": gap}
            limit = HEADS_POSE_ATOL_BF16 if bf16 else HEADS_FP32_REL
            if not gap <= limit:
                failed.append(f"{dtype} harness eval_batch {b}: gap {gap:.3e}")
        del model
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("graph: " + "; ".join(failed))
    return rec


STEP_GRAPH_STEPS = 8  # phase 30: finite steps, past RAdam's switch (5) and the lookahead (6)
STEP_GRAPH_POISON = 4  # phase 30: a batch of NaN mean shapes after this many steps
STEP_GRAPH_PROFILED = 2  # phase 30: steps profiled on each route
STEP_GRAPH_ROUTES = ("graph", "eager", "graph again", "eager again")  # phase 30: the last
# two are the controls
# phase 30, bf16: the largest state gap between the routes over the largest value of the
# tensor.  The bf16 step does not repeat its bits on the card even on the eager route (a few
# leaves' gradients, now and then, from the first steps on), so its routes are held to bits
# in the metrics and, in the state, to this share or to the larger gap that a route shows
# against itself in the same phase; a fault of the graph (a stale input, a missed copy)
# moves the losses, and a state by its own size
STEP_GRAPH_BF16_REL = 1e-3
# phase 30: kernels by name that are PyTorch's or a library's (portbench/trace.py's list,
# and the sleep); every other kernel is the port's, whose counts a step both routes share
LIBRARY_KERNELS = ("at::", "at_cuda_detail", "cub::", "c10::", "cublas", "cutlass", "xmma",
                   "cudnn", "nccl", "nvjet", "gemv", "gemmSN", "splitKreduce", "Memcpy", "Memset",
                   "memcpy", "memset", "sm90_", "sm80_", "ampere_", "spin_kernel")


@contextlib.contextmanager
def eager_step():
    """Run every train step inside the block op by op (the eager route of
    ``engine/train_step.py``): phase 30's other side."""
    from hspose_tpu_torch.engine import graphed_step

    real = graphed_step.eligible
    graphed_step.eligible = lambda *args: False
    try:
        yield
    finally:
        graphed_step.eligible = real


def train_state(model, step) -> dict:
    """Every number a train step moves: the parameters, the BatchNorm
    statistics, Ranger's state and its count."""
    out = {f"model.{k}": v.detach().clone() for k, v in model.state_dict().items()}
    opt = step.optimizer
    for name, p in model.named_parameters():
        for k, v in opt.state[p].items():
            out[f"opt.{name}.{k}"] = v.clone()
    out["opt.count"] = torch.tensor(opt.count)
    return out


def state_gap(a: dict, b: dict) -> tuple[int, float]:
    """(tensors that differ, their largest difference) of two ``train_state``s."""
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    return len(differ), max((float((a[k].double() - b[k].double()).abs().max())
                             for k in differ), default=0.0)


def state_rel_gap(a: dict, b: dict) -> float:
    """The largest difference of two ``train_state``s' tensors over the
    largest value of that tensor in ``b``."""
    gaps = [float((a[k].double() - b[k].double()).abs().max()
                  / b[k].double().abs().max().clamp_min(1e-30))
            for k in a if not torch.equal(a[k], b[k])]
    return max(gaps, default=0.0)


def short(names: dict) -> dict:
    """Kernel counts by name, each name cut to 60 characters."""
    return {k[:60]: v for k, v in names.items()}


def first_split(a: list, b: list):
    """(step, tensors that differ, the four largest gaps with their names) at
    the first step whose ``train_state``s in ``a`` and ``b`` differ; None
    where none does."""
    for i, (x, y) in enumerate(zip(a, b)):
        differ = [k for k in x if not torch.equal(x[k], y[k])]
        if differ:
            gaps = sorted(((float((x[k].double() - y[k].double()).abs().max()), k)
                           for k in differ), reverse=True)
            return i, len(differ), [(k, f"{g:.3e}") for g, k in gaps[:4]]
    return None


def same_metrics(a: dict, b: dict) -> bool:
    """Every metric equal, NaN equal to NaN."""
    return a.keys() == b.keys() and all(a[k] == b[k] or (a[k] != a[k] and b[k] != b[k])
                                        for k in a)


def wrapper_steps(step, steps: int, replays: int, captures: int) -> int:
    """Of ``steps`` train steps taken since ``step.graphs`` read ``replays``
    replays and ``captures`` captures, those whose kernels the wrappers'
    counters see: the eager steps and the captures (a replay calls no
    wrapper; phase 30 counts its kernels by name)."""
    g = step.graphs
    return steps - (g.replays - replays) + (g.captures - captures)


def phase_train_graph(smi: str) -> dict:
    """Phase 30: the train step's forward, losses and backward as one CUDA
    graph replay (``engine/graphed_step.py``) against the eager route, in
    both tiers at B = 24, N = 1028: STEP_GRAPH_STEPS finite steps with a
    batch of NaN mean shapes after STEP_GRAPH_POISON of them, from one set of
    weights and one generator seed on each route (and on both routes again,
    the controls): the metrics of every step and, after the last, the
    parameters, BatchNorm statistics and Ranger's state bit for bit (bf16:
    the metrics, and the state within STEP_GRAPH_BF16_REL or the gap a
    route shows against itself; where each pair of routes first parts is
    printed); the NaN step skipped on every route with nothing moved, and
    the step after it replayed; the capture's time; the kernels a profiler
    session started after the capture sees on each route (the port's
    kernels, by name, the same on both, 9 KNN searches a step; PyTorch's
    and the libraries' printed: a session can lose the record of an eager
    draw kernel); host and wall time a step on each route, and the state of
    both routes bit for bit after those steps too (fp32).  Raises after
    every reading has printed."""
    from hspose_tpu_torch.config import HSPoseConfig, ModelConfig, TrainConfig
    from hspose_tpu_torch.engine.train_step import build_train_step, to_device
    from hspose_tpu_torch.utils.synthetic import synthetic_train_batch

    phase, rec, failed = "train-graph", {}, []
    batches = [to_device(synthetic_train_batch(B, N, seed=SEED + 30 + i), DEVICE)
               for i in range(STEP_GRAPH_STEPS)]
    # a batch whose losses are not finite over finite clouds: NaN mean shapes, no bowl or
    # mug (their box-cage taper would carry the NaN into the cloud).  A NaN cloud leaves
    # K1's selections unordered: its indices stay INT_MAX, and the next gather asserts
    first = batches[0]
    poison = dict(first, mean_shape=torch.full_like(first["mean_shape"], float("nan")),
                  cat_id=torch.zeros_like(first["cat_id"]))
    order = batches[:STEP_GRAPH_POISON] + [poison] + batches[STEP_GRAPH_POISON:]
    for dtype in ("float32", "bfloat16"):
        label = f"{dtype} B={B}"
        cfg = HSPoseConfig(model=ModelConfig(compute_dtype=dtype),
                           train=dataclasses.replace(TrainConfig(), batch_size=B))
        base = build_train_model(DEVICE, cfg.model)
        runs = {}
        for route in STEP_GRAPH_ROUTES:
            model = copy.deepcopy(base)
            step = build_train_step(cfg, model,
                                    torch.Generator(device=DEVICE).manual_seed(SEED + 31))
            ctx = contextlib.nullcontext if route.startswith("graph") else eager_step
            metrics, replays, capture_s, states = [], [], 0.0, []
            for i, batch in enumerate(order):
                before = states[-1] if batch is poison else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ctx():
                    metrics.append(step(batch))
                torch.cuda.synchronize()
                if i == 1:
                    capture_s = time.perf_counter() - t0
                replays.append(step.graphs.replays)
                states.append(train_state(model, step))
                if before is not None:
                    moved, _ = state_gap(before, states[-1])
                    if not (metrics[-1]["skipped_nan"] == 1.0 and moved == 0):
                        failed.append(f"{label} {route}: NaN step skipped "
                                      f"{metrics[-1]['skipped_nan']}, {moved} tensors moved")
            runs[route] = {"model": model, "step": step, "metrics": metrics,
                           "replays": replays, "state": states[-1], "states": states,
                           "capture_s": capture_s, "ctx": ctx}
        g, e, g2, e2 = (runs[r] for r in STEP_GRAPH_ROUTES)
        splits = {f"{a} / {b}": first_split(runs[a]["states"], runs[b]["states"])
                  for a, b in (("graph", "eager"), ("graph", "graph again"),
                               ("eager", "eager again"))}
        log(phase, f"{label}: the first step whose state differs (step from 0, tensors, "
                   f"largest gaps): {splits}")
        skipped = [[m["skipped_nan"] for m in r["metrics"]] for r in (g, e, e2)]
        # the routes against themselves: how far the bf16 step parts from its own bits
        own = max(state_rel_gap(g2["state"], g["state"]), state_rel_gap(e2["state"], e["state"]))
        del g2
        same_g = all(same_metrics(a, b) for a, b in zip(g["metrics"], e["metrics"]))
        same_e = all(same_metrics(a, b) for a, b in zip(e2["metrics"], e["metrics"]))
        differ_g, gap_g = state_gap(g["state"], e["state"])
        differ_e, gap_e = state_gap(e2["state"], e["state"])
        rel_g = state_rel_gap(g["state"], e["state"])
        exact = dtype == "float32"  # bf16: the state as STEP_GRAPH_BF16_REL says
        n = len(order)
        want_replays = list(range(n))  # the first step is the warm-up
        log(phase, f"{label}: {STEP_GRAPH_STEPS} steps and a NaN step after "
                   f"{STEP_GRAPH_POISON}: metrics graph against eager bit for bit {same_g} "
                   f"(eager again {same_e}); after them {differ_g} of {len(e['state'])} state "
                   f"tensors differ, largest gap {gap_g:.3e}, {rel_g:.3e} of its tensor's "
                   f"largest value (eager again {differ_e}, {gap_e:.3e}; the routes "
                   f"against themselves {own:.3e} of the tensor); skipped {skipped[0]} / "
                   f"{skipped[1]} / {skipped[2]}; "
                   f"replays after each step {g['replays']}; {g['step'].graphs.captures} "
                   f"capture, the capturing step {g['capture_s']:.3f} s; optimizer count "
                   f"{g['step'].optimizer.count}; losses "
                   f"{[round(m['total_loss'], 6) for m in g['metrics']]}")
        rec[f"{dtype}_steps"] = {"bits": same_g and differ_g == 0, "control": same_e and
                                 differ_e == 0, "gap": gap_g, "rel_gap": rel_g,
                                 "capture_s": g["capture_s"]}
        if not (same_g and (differ_g == 0
                            or not exact and rel_g <= max(STEP_GRAPH_BF16_REL, own))):
            failed.append(f"{label}: graph against eager metrics {same_g}, {differ_g} state "
                          f"tensors differ by up to {gap_g:.3e} ({rel_g:.3e} of the tensor)")
        if (g["replays"] != want_replays or g["step"].graphs.captures != 1
                or e["step"].graphs.replays != 0
                or any(s != [float(b is poison) for b in order] for s in skipped)
                or g["step"].optimizer.count != STEP_GRAPH_STEPS):
            failed.append(f"{label}: replays {g['replays']}, captures "
                          f"{g['step'].graphs.captures}, skipped {skipped}")

        # the kernels of both routes, two sessions a route in turns (each
        # route's lower device time), the same batches on both
        def stepper(r):
            taken = [0]

            def fn():
                with r["ctx"]():
                    r["step"](batches[taken[0] % len(batches)])
                taken[0] += 1
            return fn

        fns = {"graph": stepper(g), "eager": stepper(e)}
        sessions = {"graph": [], "eager": []}
        for route in ("eager", "graph", "eager", "graph"):
            sessions[route].append(device_kernels(fns[route], STEP_GRAPH_PROFILED,
                                                  session_start))
        n_e, ms_e, names_e = min(sessions["eager"], key=lambda r: r[1])
        n_g, ms_g, names_g = min(sessions["graph"], key=lambda r: r[1])
        knn = {route: sum(c for name, c in names.items() if "::knn_kernel<" in name)
               / STEP_GRAPH_PROFILED for route, names in (("graph", names_g), ("eager", names_e))}
        port = {route: {k: v for k, v in names.items()
                        if not any(p in k for p in LIBRARY_KERNELS)}
                for route, names in (("graph", names_g), ("eager", names_e))}
        missing, extra = dict(names_e - names_g), dict(names_g - names_e)
        host_e, wall_e = host_and_wall_ms(fns["eager"])
        host_g, wall_g = host_and_wall_ms(fns["graph"])
        differ_t, gap_t = state_gap(train_state(g["model"], g["step"]),
                                    train_state(e["model"], e["step"]))
        log(phase, f"{label}: profiler started after the capture sees {n_g:.1f} kernels a "
                   f"graphed step, {ms_g:.3f} device ms, against {n_e:.1f} and {ms_e:.3f} eager "
                   f"({ms_g / ms_e:.4f}x); KNN searches a step {knn['graph']:.1f} graph, "
                   f"{knn['eager']:.1f} eager; the port's kernels the same on both routes "
                   f"{port['graph'] == port['eager']} ({len(port['eager'])} names, "
                   f"{sum(port['eager'].values()) / STEP_GRAPH_PROFILED:.0f} launches a step); "
                   f"kernels the graph's lack {short(missing)}, kernels only the graph's have "
                   f"{short(extra)}; host {host_g:.3f} ms a step graph, {host_e:.3f} "
                   f"eager (the card idle before each); wall a step back to back "
                   f"{wall_g:.3f} ms graph, {wall_e:.3f} ms eager "
                   f"({B / wall_g * 1e3:.1f} / {B / wall_e * 1e3:.1f} samples/s) on {smi}; "
                   f"after {g['step'].optimizer.count} steps {differ_t} state tensors differ "
                   f"(largest gap {gap_t:.3e})")
        rec[f"{dtype}_b{B}"] = {"kernels": [n_g, n_e], "device_ms": [ms_g, ms_e],
                                "host_ms": [host_g, host_e], "wall_ms": [wall_g, wall_e],
                                "differ_after": differ_t}
        if (port["graph"] != port["eager"] or knn["graph"] != 9 or knn["eager"] != 9
                or exact and differ_t):
            failed.append(f"{label}: the port's kernels graph {short(port['graph'])}, eager "
                          f"{short(port['eager'])}; KNN {knn}; {differ_t} state tensors differ "
                          f"after the timed steps")
        del runs, g, e, e2, fns, base, splits
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("train-graph: " + "; ".join(failed))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    if sys.argv[1:2] == ["--phase"]:
        phases = {"heads": phase_heads, "graph": phase_graph, "harness": phase_harness,
                  "sp-forward": phase_sp_forward, "train-graph": phase_train_graph}
        for name in sys.argv[2:]:
            print(json.dumps(phases[name](smi)))
        return 0
    rec = phase_kernels()
    launches, fp32_results = phase_slice()
    fp32_rate = phase_throughput(smi)
    rec.update(phase_kernels("bfloat16"))
    bf16_launches, _ = phase_slice("bfloat16", fp32_results)
    launches.update({name: bf16_launches[name] for name in SERVE_LAUNCHES["bfloat16"]})
    bf16_rate = phase_throughput(smi, "bfloat16")
    log("throughput", f"bf16 / fp32 at B={B}: {bf16_rate:.1f} / {fp32_rate:.1f} crops/s "
                      f"= {bf16_rate / fp32_rate:.3f}")
    rates = {}
    for dtype in ("float32", "bfloat16"):
        rec.update(phase_train_kernels(dtype))
        train_launches, rates[dtype] = phase_train(smi, dtype)
        launches.update({name: train_launches[name] for name in TRAIN_LAUNCHES[dtype]})
    log("train", f"bf16 / fp32 at B={TRAIN_B}: {rates['bfloat16']:.3f} / {rates['float32']:.3f} "
                 f"steps/s = {rates['bfloat16'] / rates['float32']:.3f}")
    for dtype, tier, default in (("float32", "v4", "float32"), ("bfloat16", "bf16v4", "bfloat16")):
        v4_rec, carrier = phase_v4_kernels(dtype)
        rec.update(v4_rec)
        train_launches, rates[tier] = phase_train(smi, tier)
        launches.update({name: train_launches[name] for name in TRAIN_LAUNCHES[tier]})
        # K2 with winners and K9 run on no model path: their launches are the carrier's
        tag = "_bf16" if dtype == "bfloat16" else ""
        launches.update({name + tag: carrier[name + tag]
                         for name in ("hs_surface_fused_fwd", "hs_surface_fused_bwd")})
        log(tier + "-train", f"bwd_store=False train_v4_small=True / default {dtype} at "
                             f"B={TRAIN_B}: {rates[tier]:.3f} / {rates[default]:.3f} steps/s = "
                             f"{rates[tier] / rates[default]:.3f}")
    phase_train_flags()
    chamfer_rec, carrier = phase_chamfer()
    rec.update(chamfer_rec)
    # K17 and K18 run on no harness path: their launches are the autograd call's
    launches.update({name: carrier[name] for name in ("chamfer_min_argmin", "chamfer_grad")})
    launches["chamfer_min"] = phase_harness(smi, {"float32": fp32_rate,
                                                  "bfloat16": bf16_rate})["chamfer_min"]
    rec.update(phase_heads(smi))
    phase_graph(smi)
    phase_train_graph(smi)
    k5_rec, k5_launches = phase_k5(smi)
    rec.update(k5_rec)
    launches["knn_streamed"] = k5_launches["knn_streamed"]
    phase_k2k4_shapes()
    phase_k13k14_shapes()
    for dtype in ("float32", "bfloat16"):
        phase_slice(dtype, serve_k=SERVE_K_RELAXED)
    import tempfile

    with tempfile.TemporaryDirectory() as tree, tempfile.TemporaryDirectory() as keep:
        render_tree(tree)
        host_loop = phase_loop(smi, tree, keep)
        phase_probes(smi)
        phase_device_sampling(smi, tree, host_loop)
        t0 = time.perf_counter()
        rec.update(phase_sp_kernels())
        launches.update(phase_sp_forward(smi))
        phase_sp_cli(smi, tree, keep)
        log("sp", f"phase 26: {time.perf_counter() - t0:.1f} s")
        t0, cli = time.perf_counter(), []
        with tempfile.TemporaryDirectory() as out:
            try:
                phase_dp_train(smi, lambda: cli.append(start_dp_cli(tree, out)))
                phase_dp_cli(smi, tree, out, host_loop["losses"], cli[0])
            finally:
                for c in cli:
                    c.stop()
        log("dp", f"phase 27: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernel_line(rec, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
