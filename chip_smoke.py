"""On-card smoke run of the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``); any failure raises
and the script exits non-zero:

1. ``device``     the card's name and power limit (``nvidia-smi``).
2. ``build``      compiles the two elementwise fused-BatchNorm Triton
                  kernels (into ``build/triton``) and, at the same time, one
                  thread a source, the CUDA kernels with ``nvcc`` (into
                  ``build/cuda``): the two BatchNorm reductions
                  (``csrc/fused_bn.cu``) and the three flash-attention
                  kernels (``csrc/flash_attention.cu``), from the sources in
                  the checkout; reports each CUDA kernel's registers and
                  spill bytes from the ``-Xptxas -v`` logs.
3. ``kernel``     at every BatchNorm shape of a ResNet-50 step (batch 64,
                  224 px, bf16), each BN kernel against its plain PyTorch
                  version: the max error beside its stated tolerance, the
                  kernel's time, the plain version's, one PyTorch library
                  call computing the same function (a yardstick only; the
                  port never calls it) and the least time the card could take
                  (bytes moved / 3.35 TB/s, the H100 SXM data sheet); the two
                  reductions called again must give bitwise-equal outputs.
                  Lines are printed for the stem and a stage-3 shape, and one
                  ``kernel_odd`` line at 37 channels (the reductions' scalar
                  path).
   ``kernel_split`` B1 and B3 in their split mode (the mode of more than
                  one rank: f64 sums, an all-reduce, ``bn_finish``) at every
                  BN shape, in a one-rank NCCL group of this process:
                  bitwise equal to the single launch; the batch cut in two
                  halves, their sums added and finished: within the
                  per-channel tolerance above; ``bn_finish`` against
                  ``bn_finish_plain`` on the same f64 sums, within it too.
                  Split-mode ms per step beside the bound.
4. ``kernel``     each flash-attention kernel against its plain version at
                  the LM slice's shape ([B·H=64, L=2048, D=64] bf16, causal,
                  with the packed segment layout of the slice's own corpus),
                  and once in f32 at [16, 1024, 64]: the errors (bf16
                  outputs elementwise and as a norm) beside their limits,
                  two faults the bf16 limits must catch (an output off by
                  1%; O with a kv block dropped), kernel, plain and
                  yardstick times
                  (``scaled_dot_product_attention`` with the causal+segment
                  mask, and its backward), the bound from this run's
                  segments (989 TFLOP/s bf16 or 67 TFLOP/s f32, 3.35 TB/s)
                  and the 64 x 64 blocks each kernel visits (the bf16
                  kernels skip the pairs that the fence empties:
                  ``visited_blocks``) beside the causal ones. Then a bf16
                  line at the slice's shape without segment ids (pure
                  causal, ``kernel_causal``): the forward, dq and dk/dv
                  against their plain versions under the same limits, the
                  forward's time against SDPA's forward and the backward
                  pair's against SDPA's backward, both with
                  ``is_causal=True``.
   ``kernel_ring`` ring attention over 4 members in this process
                  (``ring_attention_local``, the seam of the ring's
                  exchange: NCCL takes no two ranks on one card) at the LM's
                  width, 8 heads of 64, causal: bf16 over the packed slab
                  [8, 2048] and over one unpacked sequence of 16,384, f32
                  over the slab cut to [2, 1024]. Each case: every wrapper's
                  count set to 0, the ring's forward and backward run under a
                  trace; each flash kernel launched n(n+1)/2 = 10 times by
                  its wrapper and on the card; the output and the three
                  gradients against whole-sequence ``flash_attention`` on
                  the same tensors (bf16 as a norm within 2^-8, f32 within
                  1e-4 of the largest); every hop's three kernels (the
                  keys' own segment ids, f32 outputs) against their plain
                  versions at the flash limits above (O and lse on the rows
                  that attend a key of the hop); in bf16, every hop's f32
                  outputs before any cast (O against the kernel's own online
                  rounding of p, ``flash_fwd_online_plain``; dq, dk, dv
                  against the plain versions) as a norm within 2^-12, below
                  one bf16 rounding, which the same hop's bf16 outputs cast
                  up to f32 must exceed; a 1% fault in one hop's dk
                  that the check must catch; a diagonal and an off-diagonal
                  hop's forward, dq and dk/dv ms beside their bounds (the
                  hop's attended pairs).
   ``kernel_headdim`` B5-B7 at head dims the kernels are not compiled
                  for, D = 32, 48 (zero-padded to the D = 64 kernels), 96
                  (to D = 128), 160 and 192 (to D = 256), beside D = 64,
                  128 and 256, and D = 320, 384, 512 and 1024 (the
                  split-D kernels), at [B·H=64, L=2048, D] up to D = 128,
                  at the D = 256 LM's 2 heads, [B·H=16, L=2048, D], up to
                  256 and at the D = 512 LM's one head, [B·H=8, L=2048, D],
                  above, on the slab's segments, causal, bf16 and f32:
                  every launch against its plain version at the flash
                  limits above, one launch a call, a 1% dk fault caught at
                  each padded and each split-D width; kernel and plain ms,
                  the bound at the real D and at the padded one, SDPA's ms
                  from D = 256 (its backend named); a layer's forward and
                  backward, device ms queued behind a spin, through the
                  autograd function (each operand padded once) and through
                  the three wrappers each padding its own.
5. ``slice``      the port's ResNet path: ``TFCluster.run`` on the local
                  backend, one executor, the port's ``resnet_spark.main_fun``
                  on full ResNet-50, bf16, ``bn_impl="pallas"``, batch 64, 5
                  steps. Per-step losses (finite), images/s over steps 2-5,
                  and each BN kernel's launch count read back from the
                  trainer's obs counters, which must be 53 per step.
   ``slice_loop`` the same with ``--steps_per_loop 5``, 20 steps: four
                  calls of the train loop (two eager warm-up steps and the
                  capture in the first, then replays of one CUDA graph a
                  step); each call's loss, images/s over calls 2 and 4, the
                  wrappers' launches (53 for each warm-up step and 53 for
                  the capture: a replay calls no wrapper), and call 3
                  traced in the trainer with ``torch.profiler``
                  (``--trace_call 3``): 53 device launches of each BN
                  kernel for each of its 5 replayed steps, 5 graph
                  launches, device busy ms and idle share.
6. ``compare``    one ResNet-50 train step, BN kernels vs their plain versions
                  (``bn_impl="plain"``: statistics from f64 sums), in
                  float32 and bf16 with TF32 off, then a 1% dgamma fault
                  that the gradient limit must catch.
7. ``slice_lm``   the port's LM path: ``TFCluster.run`` → the port's
                  ``transformer_spark.main_fun`` at ``TransformerConfig``'s
                  full width (vocab 32000, d_model 512, 6 layers, 8 heads,
                  d_ff 2048), seq 2048, batch 8, bf16, on byte-tokenized
                  packed text, 5 steps: losses (finite), tokens/s over steps
                  2-5, the packing efficiency, and each flash kernel's
                  launches, which must be 6 per step.
   ``slice_lm_loop`` the same with ``--steps_per_loop 5``, 20 steps, as
                  ``slice_loop``: tokens/s over calls 2 and 4, 6 wrapper
                  launches for each warm-up step and the capture, and in
                  the traced call 6 device launches of each flash kernel a
                  replayed step, with the host ms of the call's fetch, its
                  queueing and its sync.
8. ``compare_lm`` one LM train step on the same weights (seed 0) and packed
                  batch through the kernels (``attention="flash"``) and
                  through a reference, with TF32 off: in float32 plain
                  attention, in bf16 the kernels' plain versions on the
                  same autograd path. Loss and gradient differences
                  against stated limits; then, in each dtype, a 1% dk fault
                  in the dk/dv kernel's output that the gradient limit
                  must catch.
   ``slice_lm_defaults`` the port's transformer example at its own
                  defaults (d_model 256, 8 heads of 32: the padding route,
                  2 layers, d_ff 1024, vocab 1024, seq 256, batch 8, bf16)
                  through ``TFCluster.run``: 20 eager steps, then 20
                  through the loop (K = 5, call 3 traced), as
                  ``slice_lm`` / ``slice_lm_loop`` (losses finite, a launch
                  a layer a step of each flash wrapper, tokens/s); then
                  ``compare_lm_defaults``: ``compare_lm``'s step, limits
                  and faults at those defaults, on each of the first 16
                  batches (its bf16 loss and gradient limits
                  ``LM_DEFAULTS_BF16_TOLS``).
   ``slice_lm_d256`` the LM slice with 2 heads of 256 (``LM_D256``: the
                  D = 256 kernels, no padding) through ``TFCluster.run``,
                  eager and through the loop, as ``slice_lm`` /
                  ``slice_lm_loop`` (``slice_lm_d256`` /
                  ``slice_lm_d256_loop``); then ``compare_lm_d256``:
                  ``compare_lm``'s step, limits and faults on the slice's
                  batch at that width.
   ``slice_lm_d512`` the LM slice with one head of 512 (``LM_D512``: the
                  split-D kernels) through ``TFCluster.run``, eager and
                  through the loop (call 3 traced), as ``slice_lm_d256``;
                  then ``compare_lm_d512`` at that width.
   ``compare_loop`` for each slice, 5 captured steps (the train loop)
                  against 5 eager steps from the same weights on the same 5
                  batches, cuDNN deterministic: every parameter, BN
                  statistic and the last loss bitwise equal, after two eager
                  runs are shown bitwise equal to each other.
   ``slice_fsdp`` the LM slice fully sharded (ZeRO-3): ``TFCluster.run``
                  on one executor runs ``examples/transformer/fsdp_check.py``'s
                  trainer, which builds ``SyncDataParallel(ctx.mesh({"dp": 1,
                  "fsdp": -1}), fsdp=True)`` and ``SyncDataParallel(ctx.mesh(
                  {"dp": -1}))`` and trains the full-width LM on each from
                  the same weights and packed batches: 5 eager steps, two
                  calls of the captured loop (K = 5: call 1 warms up and
                  captures, call 2 is traced), then 5 turns timing an eager
                  step and a loop call on each side in turn. Parameters and
                  losses bitwise equal between the two after the eager
                  steps and at the end; then the
                  sharded state saved, ``ckpt.reshard_restore`` onto a fresh
                  ``{"dp": -1}`` state and one more step on both, bitwise
                  again. Each flash wrapper's launches on each side (6 a
                  step for the 5 eager steps and the loop's 2 warm-up steps
                  and capture), the traced call's device launches (6 a
                  replayed step) and graph launches, eager and captured step
                  ms (medians of the turns), tokens/s, peak memory, Adam
                  state bytes, the parameters sharded (38 of 51).
   ``slice_axes`` the LM slice on its model axes: ``TFCluster.run`` on one
                  executor runs ``examples/transformer/axes_check.py``'s
                  trainer. (a) tp: the LM built on ``ctx.mesh({"dp": 1,
                  "tp": -1})`` (``SyncDataParallel(tp=transformer.
                  param_specs)``, 37 of 51 parameters split) beside
                  ``{"dp": -1}``, from the same weights and batches: 3
                  eager steps, two calls of the captured loop (K = 5, call
                  2 traced), 3 timed turns; bitwise equal after the eager
                  steps and the loop, and after the tp state's checkpoint
                  is resharded onto dp and both take a step. (b) the LM
                  with 8 experts (capacity 1.25, groups of 256, balancing
                  weight 0.01) on ``{"dp": 1, "ep": -1}``: 10 eager steps
                  and the same 10 through the loop, bitwise; the loss
                  finite and falling, ``moe_aux`` >= 0.99; one f32 step at
                  depth 2 on the card against the CPU within 1e-4
                  relative, and a 1% gradient fault caught. (c) one step
                  with ``remat`` against one without, bitwise, with each
                  step's peak memory, and the remat loop bitwise its eager
                  steps. (d) sp: the LM on ``ctx.mesh({"dp": 1, "sp":
                  -1})`` (the model on the mesh, each batch cut to the
                  rank's block of the sequence), a third side of (a)'s
                  turns: at one rank a ring of one member, bitwise dp after
                  the eager steps, the loop, and a resharded restore and a
                  step. Each flash wrapper's launches in each leg (6 a
                  step; 12 of B5 under remat, which recomputes the
                  forward), the tp side's traced device launches, step ms
                  and tokens/s, peak memory.
   ``pipeline``   pipeline parallelism at the LM slice's full width
                  (``parallel.pipeline_parallel``): ``Pipeline1F1B`` with 3
                  stages of 2 of the LM's blocks on the one card
                  (``devices=["cuda:0"] * 3``, a thread and a CUDA stream a
                  stage), 8 rows of 2,048 tokens (one causal segment a row),
                  embedded before stage 0, the final norm, head and
                  cross-entropy closing the last stage, 4 microbatches,
                  overlap on and off: loss and every stage's gradients
                  against the same blocks composed sequentially under plain
                  autograd (bf16 limits of ``compare_lm``), on and off
                  bitwise, each stage's stashed inputs within 1F1B's bound;
                  the flash wrappers' launches on one step (B5 40: the
                  backward re-runs the forward; B6, B7 24) and the card's in
                  its trace; the measured bubble beside its closed form
                  (P-1)/(2M+P-1), the overlap fraction, step ms (turns),
                  peak memory. Then ``pipeline_apply_local`` (GPipe's
                  schedule, all 4 members of one block in this process, 2
                  rows a microbatch, M = 4): forward and gradients against
                  the sequential composition, launches (B5 28, B6/B7 16).
   ``overlap``    ``train.BucketedOverlap`` over ``parallel.hostreduce``:
                  2 processes on the one card (the group is TCP over
                  loopback; NCCL takes no two ranks on one card), each the
                  full-width LM (bf16) on 2 microbatches of 4 of the slice's
                  packed rows (rolled by the rank), 3 AdamW steps with
                  overlap on and 3 off from the same weights: an exact mean
                  of distinct payloads, both ranks' losses bitwise equal,
                  on/off bitwise, the loss falling, the overlap fraction > 0
                  on and 0 off; step ms, the comm thread's busy and
                  device-wait seconds, buckets, the flash wrappers' launches
                  (12 a step) and the card's in the last "on" step's trace.
   ``loop_cache`` in a process of its own (``loop_cache_child``: a
                  fresh process's profiler, see there)
                  ``train.PackedLoopCache`` on the ResNet slice (bf16,
                  batch 64, 224 px, ``bn_impl="pallas"``, cuDNN
                  deterministic): 8 batches through ``autotuned_prefetch``
                  in windows of 1, 2, 4, 1 (the controller scripted), each
                  window run by its bucket's loop, every loop replaying one
                  captured step; against the same windows' batches through
                  one captured K = 1 loop: every batch one step, bitwise
                  equal parameters, BN statistics and window losses,
                  ``feed_recompiles_total`` 3, peak memory within 5%; the BN
                  wrappers' launches (159: two warm-up steps and the
                  capture) and the card's in the traced K = 4 window (212,
                  4 graph launches).
9. ``ckpt_engine`` ResNet-50 at the slice's shape in this process,
                  ``compile_train_loop`` (K = 5) driven by ``run_steps``:
                  runs with an ``AsyncCheckpointEngine`` (``keep=2``, a save
                  every 10 steps) and runs without, alternating, 2 pairs,
                  cuDNN deterministic. Step ms both ways, the training
                  thread's ms a snapshot, the writer's seconds a commit,
                  commits and supersedes; every committed checkpoint must
                  equal, bitwise, a blocking copy of the engine-less twin's
                  state at its step.
10. ``recover``   the port's ResNet example at the slice's shape with
                  ``--steps_per_loop 5 --checkpoint_steps 10
                  --deterministic``, twice: run A uninterrupted through
                  ``TFCluster.run``, run B through ``--auto_recover 1``
                  (``TFCluster.run_with_recovery``) with the ``node.kill``
                  chaos site killing the trainer once, mid-run, at the
                  first heartbeat after its checkpoint of step 70 or later
                  is committed. One relaunch, the second life resumed from
                  a checkpoint at or past that one, both
                  final checkpoints manifest-verified and B's bitwise equal
                  to A's; checkpoint bytes, the blocking save's median
                  seconds, restore seconds, seconds from the kill to the
                  second life's first logged step, and both wall times, read
                  from the runs' flight shards (``TOS_TRACE_DIR``).
    ``ladder``    the recovery ladder (``elastic.run_ladder``) on the
                  recover phase's arguments, two executors sharing the card
                  (no world), the story of the JAX package's
                  ``test_preempt_drain_regrow_full_size_resume``: executor
                  1's latched kill, armed once executor 0's checkpoint of
                  step 30 or later is committed; the blacklist and the
                  shrink to 1; the regrow probe, the scaler's grow vote and
                  executor 0's drain; the relaunch at 2. Sizes 2 → 1 → 2,
                  one shrink, one regrow, one drained preemption, every
                  life's child on the card, executor 0 resumed each life at
                  or after its last committed checkpoint, its final
                  checkpoint bitwise run A's of the recover phase; the
                  seconds from the kill to the first logged step after it
                  and the drain's.
    ``spark_recover`` the JAX package's
                  ``test_spark_feed_killed_node_training_finishes_anyway``
                  (``cluster_check.spark_feed_story``): two executors share
                  the card as independent workers, fed 128 rows in waves
                  (feed timeout 30 s); executor 1 SIGKILLs its trainer at
                  step 5, after ``ckpt_4``; ``run_with_recovery(feed_fn=...)``
                  relaunches once and re-runs the feed loop; both workers
                  end at step 8 on ``cuda:0``, the victim's checkpoints are
                  ``ckpt_2, 4, 6, 8``.
11. ``mnist_compare`` ``MnistMLP`` (784-512-10) and ``MnistCNN`` at full
                  width, float32 with TF32 off: eval logits and one Adam step
                  through ``SyncDataParallel`` on the card against the same
                  on the CPU, from the same weights (seed 0) and 64 rows of
                  the examples' data (``synthetic_mnist``): logits, loss,
                  every gradient tensor and the parameters after the step
                  (against their starting values), each within 1e-4
                  relative; then a 1% fault in one gradient that the
                  gradient limit must catch.
12. ``slice_mnist`` the port's InputMode.SPARK path: ``mnist_spark.main``
                  through ``TFCluster.run``, one executor and the card, one
                  epoch of 30,000 synthetic rows (half of MNIST's train
                  split) in 8 partitions, batch 64, with ``--model_dir`` (a
                  checkpoint every 250 steps) and ``--export_dir``: rows
                  fed, rows the trainer took off the feed and trained on
                  (the example's 90% cap: 421 steps), the epoch's seconds (``cluster.train``)
                  and images/s, first and last loss (finite, falling), the
                  checkpoints and the bundle, and each kernel wrapper's
                  launches in the trainer (0: MNIST runs none of them).
   ``chaos_cluster`` the JAX package's cluster chaos on the card, two legs
                  in one trainer life (one child's start on the card, not
                  two). A commit torn in a CUDA child
                  (``tests/test_ckpt_chaos.py``'s cluster case): the MNIST
                  trainer on ``cuda:0`` saves its first two Adam steps
                  through ``ckpt.AsyncCheckpointEngine`` under a
                  ``ckpt.commit_tear`` site seeded to tear the second
                  commit; the tear and a commit are counted in the merged
                  metrics, ``tmp.ckpt_2`` stays unpublished and
                  ``restore_latest`` onto the card takes ``ckpt_1``, whose
                  tensors equal step 1's bitwise. Then the Spark feed under
                  ``tests/test_chaos_cluster.py``'s plan (one dropped
                  registration in the driver, two 10 ms slow dequeues in
                  the trainer): ``mnist_spark``'s ``main_fun`` through
                  ``TFCluster.run`` on one executor in InputMode.SPARK,
                  3,000 synthetic rows in the uneven partitions of
                  ``cluster_check.py``'s ``mnist_spark_dp4``: the trainer
                  trains the example's cap (``steps_per_worker``: 41 steps
                  of 64, every row it took off the feed) and each fault is
                  a counter in the merged metrics.
13. ``pipeline_mnist`` ``mnist_pipeline.main`` on the card:
                  ``TFEstimator.fit`` on 10,000 rows, then
                  ``TFModel.transform`` of 2,048 rows in the executor; the
                  predictions must equal, row for row, the bundle's
                  ``predict_fn`` run in this process on the card, and every
                  row must report the executor's predict ran on ``cuda:0``.
14. ``parallel_mnist`` ``mnist_inference.main`` through TFParallel, one
                  instance on the card, over ``slice_mnist``'s bundle: its
                  part file must equal, row for row, the direct predict of
                  the same 2,048 rows, and so give the same correct count.
                  Each MNIST phase prints its seconds (``<phase>_seconds``).
15. ``data_setup`` the real-data slice's shards through the port's
                  ``resnet_data_setup.py``: 2,048 ImageNet-schema JPEG
                  Examples of 256² random pixels at quality 90 in 8 shards,
                  and 512 for eval; the native library's build (``g++`` at
                  first use from ``csrc/tfrecord_io.cc``: libjpeg where the
                  host has it, else the in-tree scalar decoder); 64 records
                  through the native decoder and through PIL, train and
                  eval parse: every pixel equal.
   ``input_only`` the trainer's ``ImagePipeline`` on those shards with no
                  training, in a spawned process: images/s over 31 batches
                  of 64 (224 px, uint8) with the thread pool and the native
                  decoder, the forked decode plane (usable cores − 2
                  workers, at most 16), one epoch filling the slab cache
                  (cold) and one served from it (warm).
   ``slice_real`` the port's ResNet example through ``TFCluster.run`` on
                  those shards, ResNet-50, bf16, ``bn_impl="pallas"``, batch
                  64, 224 px, ``--steps_per_loop 5``, 60 steps, once a
                  decode mode (threads; the decode plane with one worker
                  killed by the ``data.decode_kill`` chaos site, respawned
                  from the trainer with CUDA up; a warm slab cache): each
                  call's loss (finite), images/s over calls 2 and later, the
                  stall counters over calls 2 and later (the trainer sets
                  them on each call's span) and ``classify_stalls``' verdict
                  on them, native
                  decodes (> 0), respawns (>= 1 in the plane leg), cache
                  hits and the BN wrappers' launches (> 0).
   ``eval_real``  top-1 of the threads leg's trained model over the 512
                  eval images on rank 0 (``--eval_dir``): every image
                  scored.
   ``slice_lm_pack`` the LM slice's eager path with ``--pack_workers 2``
                  for 10 steps: the flash wrappers' launches (6 a step) and
                  the first 5 losses against ``slice_lm``'s (the same
                  weights and packed stream), within 1e-3 relative.
16. ``serve``     the serving plane: the port's ``InferenceServer`` on a
                  ResNet-50 bundle (bf16, 224 px, 1,000 classes, random
                  weights from a seeded generator, eval mode; replies
                  ``prediction`` and f32 ``logits``); 8 clients x 12
                  requests x 16 uint8 rows on the binary lane, a server a
                  leg with coalescing on (``TOS_SERVING_COALESCE_ROWS=1024``)
                  and off (``=1``) in turns, 3 rounds: rows/s, p50 and p99
                  ms a leg; every reply's logits against a direct
                  ``predict_fn`` call on the same rows on the card
                  (||got - want|| / ||want|| <= 2^-8 a reply, shown to catch
                  a 1% fault; max abs error and bitwise or not, a leg),
                  predictions equal to the direct argmax wherever its top
                  two logits differ by more than 2^-6 of the largest;
                  ``max_memory_allocated``.
   ``serve_lm``   the LM at ``TransformerConfig``'s defaults (bf16,
                  attention "auto") behind the server: 4 clients x 6
                  requests of 1-2 packed rows [n, 2048] of the slice's
                  corpus, replying ``logits_last`` [n, 32000] f32; the
                  dispatches coalesce several requests; the flash forward's
                  wrapper launches at least 6 times a dispatch; every reply
                  against the same weights with attention "plain" on the
                  card (the head in f32 at the last position; as a norm
                  within 2^-6 and in scale within 2^-9, the second shown to
                  catch an output 1% off); p50 and p99 ms.
   ``infer_cli``  ``python -m tensorflowonspark_tpu_torch.serving infer`` on
                  the 512 eval images of ``data_setup`` (decoded by the eval
                  parse into float-feature shards: the CLI feeds numeric
                  features only), once with ``--export_dir`` on the ResNet-50
                  bundle and once with ``--server`` against a running
                  server: 512 predictions each, equal to each other and to a
                  direct predict of the same images; seconds of each run.
   ``serving_mesh`` in a fresh interpreter that never sets up CUDA: a
                  process-mode ``ServingMesh`` of 3 forked replicas on the
                  card over a ``ModelPointer``, 3 load threads through
                  ``mesh.router()``; one replica killed mid-load (relaunched,
                  seconds from the kill to its first answered request, 0
                  router errors); 3 new generations published and swapped in
                  under load (replies after the settle window all the new
                  generation's; each replica's ``memory_allocated`` after the
                  third swap within one model's parameter bytes of that
                  after the first); with CUDA up, a process-mode mesh
                  refuses to fork; the ``mesh`` CLI with ``--metrics_port``
                  (``serving_replicas_active 2``, ``info()["mesh"]``).
17. ``seg_compare`` the segmentation U-Net at the JAX model's full width
                  (3 classes, 32 base filters, depth 4), 128 px, float32
                  with TF32 off, weights from a seeded generator: eval
                  logits and one Adam step on 8 images of
                  ``synthetic_shapes(seed=0)`` on the card against the same
                  on the CPU, as ``mnist_compare`` holds them (1e-4
                  relative), and a 1% fault in the largest gradient that the
                  gradient limit must catch.
   ``slice_seg``  BASELINE config 5: the port's ``segmentation_spark.main``,
                  ``TFCluster.run`` on one executor and the card, 30 eager
                  steps of batch 64 at 128 px (the setting of the TensorFlow
                  image-segmentation tutorial the reference example
                  converts), Adam 1e-3, with ``--export_dir``; then
                  ``TFParallel.run`` with 2 instances sharing the card
                  (``--instances_per_card 2``) over 64 images: images/s over
                  steps 6-30, the first and last 5 losses (finite; the last
                  lower), the final pixel accuracy, peak
                  ``max_memory_allocated``, each kernel wrapper's launches in
                  the trainer (0: the U-Net's convs and GroupNorm are
                  cuDNN's and PyTorch's) and each instance's device
                  (``cuda:0``); each instance's masks bitwise equal to the
                  bundle's ``predict_fn`` run here on the card on the same
                  shard in one batch (cuDNN picks its algorithm by batch
                  size).
   ``estimator_mnist`` ``mnist_estimator.main`` with ``--cluster_size 2``
                  (the chief and the evaluator, both on the card), one epoch
                  of 2,048 rows: at least one eval record; the last from the
                  last checkpoint, its accuracy equal to a direct evaluation
                  of that checkpoint on the card; seconds.
18. ``kernels``   every kernel of the port and whether the eager and the
                  loop paths of phases 5 and 7 launched it, the traced loop
                  call ran it on the card, (the BN kernels) run A of the
                  recover phase, the ladder's last life and the real-data
                  slice launched it, and
                  (the flash kernels) the pack-plane LM leg, the fully
                  sharded leg (``slice_fsdp``), the model-axes legs
                  (``slice_axes``: tp, the mixture, remat), the example at its defaults
                  (``slice_lm_defaults``, eager, loop, traced), the LM at
                  head dim 256 and 512 (``slice_lm_d256`` /
                  ``slice_lm_d512``, eager, loop, traced: the
                  ``<wrapper>_d256`` / ``_d512`` entries), the ring, the
                  1F1B and GPipe steps and the overlap ranks did, and (the
                  flash forward) the LM server did; the BN kernels also on
                  ``loop_cache``'s run and in its traced window.

Order: phases 1-4 (the build and the kernels' own times) run alone. Then
three processes run side by side (``trainer_phases`` here;
``sharded_phases`` and ``host_phases`` each in one of their own,
``phase_child``, their lines printed here once they end, with
``<name>_seconds``): here phases 5-8, ``slice_lm_defaults``,
``slice_lm_d256``, ``slice_lm_d512``, ``compare_loop``, ``pipeline``, 9,
``slice_lm_pack``
and ``serve_lm``; ``slice_fsdp``, ``slice_axes``, ``overlap``,
``loop_cache``, 10, ``ladder`` and ``spark_recover``; and phases 11-17 but those two (feeders, data
planes, clients, small models: the card idle most of their time). The
rates of phases 5 on are taken with the other two running; the recover
phase's kill waits for a checkpoint, not for a time.

Then one JSON line with every kernel's measurements (``launches``: its
wrapper's on the eager path; ``launches_loop_path``: its wrapper's on the
loop path; ``device_launches_traced_loop_call``: the card's in the traced
loop call; ``launches_recover_path``: its wrapper's in the recover phase's
run A; ``launches_ladder_last_life``: its wrappers' in the ladder's last
life, both executors; ``launches_mnist_path``: its wrapper's in ``slice_mnist``'s
trainer; ``launches_slice_real``: its wrapper's over the three
``slice_real`` legs; ``launches_slice_lm_pack``: its wrapper's in
``slice_lm_pack``; ``launches_fsdp`` / ``device_launches_fsdp_traced_call``:
the flash wrappers' on ``slice_fsdp``'s sharded side and the card's in its
traced loop call; ``launches_axes_tp`` / ``device_launches_axes_tp_traced_call``
/ ``launches_axes_moe`` / ``launches_axes_remat``: the flash wrappers' on
``slice_axes``'s tp side (and the card's in its traced call), its mixture
leg and its remat leg; ``launches_axes_sp`` /
``device_launches_axes_sp_traced_call``: its sp side's; ``launches_lm_defaults`` / ``launches_lm_defaults_loop``
/ ``device_launches_lm_defaults_traced_call``: ``slice_lm_defaults``'s;
``headdim``: ``kernel_headdim``'s ms, plain ms and bounds by head dim and
dtype;
``launches_ring`` / ``device_launches_ring_traced`` / ``ring_hop_ms``:
``kernel_ring``'s packed case, the wrappers', the card's and a diagonal and
an off-diagonal hop's ms beside their bounds; ``launches_pipeline_1f1b`` /
``device_launches_pipeline_1f1b_traced`` / ``launches_pipeline_gpipe``:
``pipeline``'s; ``launches_overlap`` / ``device_launches_overlap_traced_step``:
``overlap``'s rank 0; ``launches_loop_cache`` /
``device_launches_loop_cache_traced_window``: ``loop_cache``'s;
``launches_serving``: the flash forward's wrapper's over
``serve_lm``'s traffic; ``launches_segmentation``: its wrapper's in
``slice_seg``'s trainer; and the ``<wrapper>_d256`` and ``<wrapper>_d512``
entries, the same wrappers at head dim 256 and 512 (the split-D kernels):
``slice_lm_d256``'s / ``slice_lm_d512``'s launches, ``kernel_headdim``'s
D = 256 / 512 bf16 numbers a step of that LM, SDPA's beside them), the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script fails before printing anything.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

_T0 = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
BATCH, IMAGE, STEPS = 64, 224, 5
#: the loop paths: four calls of ``--steps_per_loop 5`` (the first holds
#: the two eager warm-up steps and the capture), the third traced
LOOP_STEPS, TRACE_CALL = 20, 3
#: the recover phase: the example with a checkpoint every 10 steps (the
#: newest 3 kept); run B's trainer is killed at its first heartbeat (every
#: HEARTBEAT_S) once its checkpoint of step RECOVER_KILL_STEP or later is
#: committed, so the kill lands mid-run wherever the host sets the pace
RECOVER_STEPS, RECOVER_EVERY, RECOVER_KEEP, RECOVER_KILL_STEP = 200, 10, 3, 70
HEARTBEAT_S = 0.25
#: the ladder phase: two executors share the card, each on the recover
#: phase's arguments in a directory of its own; executor 1's kill is armed
#: once executor 0's checkpoint of step LADDER_KILL_STEP or later is
#: committed; the shrunk life trains executor 0 to LADDER_PAUSE and waits
#: for the drain, which the regrow poll (every LADDER_REGROW_S) asks for
LADDER_KILL_STEP, LADDER_PAUSE, LADDER_REGROW_S, LADDER_SIZE = 30, 150, 20.0, 2
#: the slice_axes phase: eager steps and timed turns of its tp leg
AXES_EAGER, AXES_PAIRS = 3, 3
#: the pipeline phase: 1F1B over PIPE_STAGES stages of PIPE_BLOCKS LM
#: blocks on the one card, PIPE_MICRO microbatches; GPipe over
#: PIPE_LOCAL_MEMBERS members of one block in one process
PIPE_STAGES, PIPE_BLOCKS, PIPE_MICRO, PIPE_LOCAL_MEMBERS = 3, 2, 4, 4
#: the overlap phase: ranks on the one card, microbatches of rows a rank,
#: steps a side (overlap on, off)
OVERLAP_RANKS, OVERLAP_MICRO, OVERLAP_ROWS, OVERLAP_STEPS = 2, 2, 4, 3
#: the loop_cache phase: the window sizes the scripted controller picks in
#: turn (a batch a step: sum(LOOP_CACHE_KS) batches)
LOOP_CACHE_KS = (1, 2, 4, 1)
#: the ckpt_engine phase: 6 calls of K = 5 a run, a save every 2 calls (10
#: steps), 2 pairs of runs with and without the engine
CKPT_CALLS, CKPT_EVERY, CKPT_PAIRS = 6, 2, 2
BF16_ULP = 2.0 ** -7  # bf16 keeps 8 significant bits
#: f32 per-channel outputs of sums of up to 8e5 values, relative to the
#: largest (floor 1): the kernels round each sum once from near-exact
#: partials, the plain versions sum in f64 (bn_stats) or in torch's f32
#: order (bn_bwd_reduce)
REL_F32_SUM = 1e-4

#: (wrapper, TPU kernel it replaces, (bytes per element of the activation
#: moved, f32 per-channel vectors moved), flops per element, route, source)
KERNEL_TABLE = [
    ("bn_stats", "tensorflowonspark_tpu/ops/fused_bn.py:87", (1, 2), 3,
     "cuda", "tensorflowonspark_tpu_torch/csrc/fused_bn.cu"),
    ("bn_normalize", "tensorflowonspark_tpu/ops/fused_bn.py:108", (2, 4), 3,
     "triton", "tensorflowonspark_tpu_torch/ops/fused_bn.py"),
    ("bn_bwd_reduce", "tensorflowonspark_tpu/ops/fused_bn.py:116", (2, 4), 5,
     "cuda", "tensorflowonspark_tpu_torch/csrc/fused_bn.cu"),
    ("bn_bwd_dx", "tensorflowonspark_tpu/ops/fused_bn.py:138", (3, 5), 7,
     "triton", "tensorflowonspark_tpu_torch/ops/fused_bn.py"),
]
#: the reductions, which must repeat bitwise
REDUCTIONS = ("bn_stats", "bn_bwd_reduce")

#: the LM slice: TransformerConfig's defaults at full width
LM = dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048)
LM_SEQ, LM_BATCH = 2048, 8
#: one bf16 LM step, kernels vs their plain versions: the loss, all
#: gradients (relative) and each of the last layer's q, k, v projection
#: gradients (relative, forward kernel on both sides)
LM_BF16_LOSS_TOL, LM_BF16_GRAD_TOL, LM_BF16_ATTN_GRAD_TOL = 2e-4, 2e-3, 3e-3
#: (wrapper, TPU kernel it replaces, matrix products per attended (q, k)
#: pair, [BH, L, D] tensors moved, [BH, L] f32 row vectors moved)
FLASH_TABLE = [
    ("flash_fwd", "tensorflowonspark_tpu/ops/flash_attention.py:54", 2, 4, 1),
    ("flash_bwd_dq", "tensorflowonspark_tpu/ops/flash_attention.py:104", 3, 5, 2),
    ("flash_bwd_dkv", "tensorflowonspark_tpu/ops/flash_attention.py:151", 4, 6, 2),
]
FLASH_SOURCE = "tensorflowonspark_tpu_torch/csrc/flash_attention.cu"
#: the kernel_headdim phase: head dims the kernels are not compiled for
#: (zero-padded to the next compiled one), the compiled ones beside them,
#: and head dims above 256 (the split-D kernels, which take any width)
HEADDIM_PADDED, HEADDIM_NATIVE, HEADDIM_SPLIT = (32, 48, 96, 160, 192), (64, 128, 256), (320, 384, 512, 1024)
#: the LM slice at head dim 256 (slice_lm_d256): 2 heads of 256
LM_D256 = dict(LM, n_heads=2)
#: the LM slice at head dim 512 (slice_lm_d512): one head of 512, the
#: split-D kernels
LM_D512 = dict(LM, n_heads=1)
#: the slice_lm_defaults phase: steps of the example at its own defaults,
#: eager and through the loop (K = STEPS, the third call traced)
LM_DEFAULTS_STEPS = 20
#: compare_lm_defaults: the batches its step is compared on, and its bf16
#: loss and gradient limits. The 2-layer model at head dim 32 and 256
#: tokens reads its loss up to 2.3e-4 apart (the forward kernel rounds p
#: at each key block's running max, its plain version at the final one;
#: 7.6e-6 at full width), its gradients 1.42e-3 to 1.51e-3, over the
#: example's first 16 batches; the dk fault moves the whole gradient to
#: 1.84e-3 to 1.98e-3 and is held by the q, k, v projection gradients, as
#: at full width.
LM_DEFAULTS_COMPARE_BATCHES, LM_DEFAULTS_BF16_TOLS = 16, (5e-4, 2e-3)
#: kernel vs plain version, f32 outputs (lse everywhere, every output of the
#: f32 line): the same f32 math summed in another order, within this much
#: of the largest reference value (floor 1)
FLASH_F32_TOL = 1e-4
#: bf16 outputs, held elementwise: |got - ref| <= tol * (|ref| + rms(ref)).
#: The summands of dq, dk and dv cancel, so one bf16 ulp at the scale of the
#: summands lands on smaller values (a sound kernel reads up to 1.4e-2 at
#: the slice's shape on an H100); a kv block dropped from the rows past it
#: reads 3.2
FLASH_BF16_ELEM_TOL = 2.0 ** -5
#: bf16 outputs, held as a norm: ||got - ref|| / ||ref||. O differs most: p
#: rounds to bf16 against a running max in the kernel and the final max in
#: the plain version (reads 1.1e-3); dq, dk, dv round the same p and ds on
#: both sides (read <= 8.5e-5). A 1% fault in any output reads 1.0e-2
FLASH_BF16_NORM_TOL = {"flash_fwd": 2.0 ** -8, "flash_bwd_dq": 2.0 ** -10,
                       "flash_bwd_dkv": 2.0 ** -10}


def emit(obj):
    """Print one JSON line; a phase's line carries the script's seconds so
    far (``t_s``), so a run's timeline reads from its lines."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def bound(name, rows, n_ch, elem_bytes):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    flops over the float32 rate, each input read once, each output written
    once."""
    acts, vecs = next(t[2] for t in KERNEL_TABLE if t[0] == name)
    flops = next(t[3] for t in KERNEL_TABLE if t[0] == name) * rows * n_ch
    moved = acts * rows * n_ch * elem_bytes + vecs * n_ch * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bn_cases(torch, F, fused_bn, nhwc, x, dy, gamma, beta, eps):
    """``{wrapper: (kernel, plain version, library call, relative tolerance)}``
    of the four BN kernels on ``x``, ``dy`` ``[R, C]``, the activation of
    shape ``nhwc``."""
    x4 = x.view(nhwc).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
    dy4 = dy.view(nhwc).permute(0, 3, 1, 2)
    mean, var = fused_bn.bn_stats_plain(x)
    dgamma, dbeta = fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, eps)
    invstd = torch.rsqrt(var + eps)
    nbb = torch.ops.aten.native_batch_norm_backward
    return {
        "bn_stats": (
            lambda: fused_bn.bn_stats(x), lambda: fused_bn.bn_stats_plain(x),
            lambda: torch.var_mean(x, dim=0, correction=0), REL_F32_SUM,
        ),
        "bn_normalize": (
            lambda: fused_bn.bn_normalize(x, mean, var, gamma, beta, eps),
            lambda: fused_bn.bn_normalize_plain(x, mean, var, gamma, beta, eps),
            lambda: F.batch_norm(x4, mean, var, gamma, beta, training=False, eps=eps),
            BF16_ULP,
        ),
        "bn_bwd_reduce": (
            lambda: fused_bn.bn_bwd_reduce(x, dy, mean, var, eps),
            lambda: fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, eps),
            lambda: nbb(dy4, x4, gamma, None, None, mean, invstd, True, eps,
                        [False, True, True]),
            REL_F32_SUM,
        ),
        "bn_bwd_dx": (
            lambda: fused_bn.bn_bwd_dx(x, dy, mean, var, gamma, dgamma, dbeta, eps),
            lambda: fused_bn.bn_bwd_dx_plain(x, dy, mean, var, gamma, dgamma, dbeta, eps),
            lambda: nbb(dy4, x4, gamma, None, None, mean, invstd, True, eps,
                        [True, False, False]),
            BF16_ULP,
        ),
    }


def check_bn(torch, name, kernel, plain, rel_tol, where):
    """The kernel's max abs error against its plain version and its
    tolerance; raises beyond it, and for a reduction whose second call is
    not bitwise equal to its first."""
    got, want = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, want))
    scale = max(float(r.float().abs().max()) for r in want)
    # f32 sums: relative to the largest value (floor 1); bf16 outputs:
    # one unit in the last place at the largest magnitude
    tol = rel_tol * (max(1.0, scale) if rel_tol == REL_F32_SUM else scale)
    if not err <= tol:
        raise AssertionError("{} at {}: max abs err {} > tolerance {}".format(name, where, err, tol))
    if name in REDUCTIONS and not all(torch.equal(a, b) for a, b in zip(kernel(), got)):
        raise AssertionError("{} at {}: a second call is not bitwise equal to the first".format(
            name, where))
    return err, tol


def phase_kernel(torch, F, fused_bn, shapes):
    """Every kernel against its plain version at each distinct shape, and the
    reductions' repeat bitwise; per-step totals weight each shape by how
    many layers have it. Then every kernel at 37 channels."""
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms

    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {t[0]: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                     "max_abs_err": 0.0, "bound_by": "bytes"} for t in KERNEL_TABLE}
    eps = 1e-5
    named = {(BATCH, 112, 112, 64): "stem", (BATCH, 14, 14, 1024): "stage3"}
    for shape, n_layers in sorted(counts.items()):
        n, h, w, c = shape
        rows = n * h * w
        x = (torch.randn(rows, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(rows, c, device="cuda", generator=gen).to(torch.bfloat16)
        gamma = torch.randn(c, device="cuda", generator=gen)
        beta = torch.randn(c, device="cuda", generator=gen)
        cases = bn_cases(torch, F, fused_bn, shape, x, dy, gamma, beta, eps)
        for name, (kernel, plain, library, rel_tol) in cases.items():
            err, tol = check_bn(torch, name, kernel, plain, rel_tol, shape)
            ms = time_ms(torch, kernel, flush)
            plain_ms = time_ms(torch, plain, flush)
            library_ms = time_ms(torch, library, flush)
            b_ms, b_by = bound(name, rows, c, x.element_size())
            tot = totals[name]
            tot["ms"] += n_layers * ms
            tot["plain_ms"] += n_layers * plain_ms
            tot["library_ms"] += n_layers * library_ms
            tot["bound_ms"] += n_layers * b_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["bound_by"] = b_by
            if shape in named:
                emit({"phase": "kernel", "name": name, "at": named[shape],
                      "shape": [rows, c], "dtype": "bfloat16", "layers": n_layers,
                      "max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "repeat_bitwise": name in REDUCTIONS})
        del x, dy, cases
    # 37 channels: 74-byte rows, so the reductions take their scalar path
    rows, c = BATCH * 14 * 14, 37
    x = (torch.randn(rows, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    dy = torch.randn(rows, c, device="cuda", generator=gen).to(torch.bfloat16)
    gamma, beta = torch.randn(c, device="cuda", generator=gen), torch.randn(c, device="cuda", generator=gen)
    line = {"phase": "kernel_odd", "shape": [rows, c], "dtype": "bfloat16",
            "vector_path": fused_bn._vector_path(x, dy)}
    odd = bn_cases(torch, F, fused_bn, (BATCH, 14, 14, c), x, dy, gamma, beta, eps)
    for name, (kernel, plain, _, rel_tol) in odd.items():
        err, tol = check_bn(torch, name, kernel, plain, rel_tol, (rows, c))
        line[name] = {"max_abs_err": err, "tolerance": tol, "ms": time_ms(torch, kernel, flush),
                      "bound_ms": bound(name, rows, c, x.element_size())[0],
                      "repeat_bitwise": name in REDUCTIONS}
    emit(line)
    return totals


def phase_kernel_split(torch, fused_bn, shapes):
    """B1 and B3 in their split mode (the mode of more than one rank: f64
    sums, an all-reduce, ``bn_finish``) at every BN shape of the step, in a
    one-rank NCCL group of this process: equal bitwise to the single launch.
    Then the batch cut in two halves, their sums added (the all-reduce's
    arithmetic without a second card) and finished over all rows: within
    the kernel phase's per-channel tolerance of the single launch on the
    whole. Times the split mode (sums launch + finish launch, no
    all-reduce) per step, beside the single launch's bound (the same bytes
    moved, and 32 bytes a channel more)."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import util
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms

    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:{}".format(
        util.find_free_port("127.0.0.1")), rank=0, world_size=1)
    try:
        if util.world_size() != 1:
            raise AssertionError("a one-rank group must keep the single launches")
        counts = {}
        for shp in shapes:
            counts[shp] = counts.get(shp, 0) + 1
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        eps = 1e-5
        totals = {name: {"split_ms": 0.0, "bound_ms": 0.0, "max_abs_err_halves": 0.0, "shapes_bitwise": 0}
                  for name in REDUCTIONS}
        finish_ms = None
        finish = {"max_abs_err": 0.0, "bitwise": 0, "cases": 0}
        for (n, h, w, c), n_layers in sorted(counts.items()):
            rows = n * h * w
            x = (torch.randn(rows, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
            dy = torch.randn(rows, c, device="cuda", generator=gen).to(torch.bfloat16)
            mean, var = fused_bn.bn_stats(x)
            cases = {
                "bn_stats": ((mean, var), lambda a: fused_bn.bn_stats_sums(a), True, (x,)),
                "bn_bwd_reduce": (fused_bn.bn_bwd_reduce(x, dy, mean, var, eps),
                                  lambda a, b: fused_bn.bn_bwd_reduce_sums(a, b, mean, var, eps), False,
                                  (x, dy)),
            }
            half = rows // 2
            for name, (single, sums_fn, stats, args) in cases.items():
                sums = sums_fn(*args)
                dist.all_reduce(sums)
                split = fused_bn.bn_finish(sums, rows, stats)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(split, single)):
                    raise AssertionError("{} split at one rank differs from the single launch at "
                                         "{}".format(name, (rows, c)))
                halves = sums_fn(*(a[:half] for a in args)) + sums_fn(*(a[half:] for a in args))
                got = fused_bn.bn_finish(halves, rows, stats)
                err = max(float((g - r).abs().max()) for g, r in zip(got, single))
                tol = REL_F32_SUM * max(1.0, max(float(r.abs().max()) for r in single))
                if not err <= tol:
                    raise AssertionError("{} from two halves at {}: max abs err {} > {}".format(
                        name, (rows, c), err, tol))
                # the finish kernel against its plain version on the same f64 sums
                for finished, on in ((split, sums), (got, halves)):
                    plain = fused_bn.bn_finish_plain(on, rows, stats)
                    err_plain = max(float((g - r).abs().max()) for g, r in zip(finished, plain))
                    tol_plain = REL_F32_SUM * max(1.0, max(float(r.abs().max()) for r in plain))
                    if not err_plain <= tol_plain:
                        raise AssertionError("bn_finish ({}) vs bn_finish_plain at {}: max abs err {} > "
                                             "{}".format(name, (rows, c), err_plain, tol_plain))
                    finish["max_abs_err"] = max(finish["max_abs_err"], err_plain)
                    finish["bitwise"] += all(torch.equal(g, r) for g, r in zip(finished, plain))
                    finish["cases"] += 1
                ms = time_ms(torch, lambda: fused_bn.bn_finish(sums_fn(*args), rows, stats), flush)
                tot = totals[name]
                tot["split_ms"] += n_layers * ms
                b_ms, _ = bound(name, rows, c, x.element_size())
                tot["bound_ms"] += n_layers * (b_ms + 32 * c / HBM_BYTES_PER_S * 1e3)
                tot["max_abs_err_halves"] = max(tot["max_abs_err_halves"], err)
                tot["shapes_bitwise"] += 1
            if (n, h, w, c) == (BATCH, 112, 112, 64):
                stem_sums = fused_bn.bn_stats_sums(x)
                finish_ms = time_ms(torch, lambda: fused_bn.bn_finish(stem_sums, rows, True), flush)
            del x, dy
        emit({"phase": "kernel_split", "world": dist.get_world_size(), "backend": "nccl",
              "per": "ResNet-50 step, batch {}, {} px, bf16: sum over its 53 BatchNorm layers".format(
                  BATCH, IMAGE),
              "tolerance_halves": "{} x max(1, max |single|)".format(REL_F32_SUM),
              "bn_finish_ms_at_stem": finish_ms,
              "bn_finish_vs_plain": dict(finish, tolerance="{} x max(1, max |plain|)".format(REL_F32_SUM)),
              **totals})
        return totals
    finally:
        dist.destroy_process_group()


def wrapper_calls(steps, steps_per_loop):
    """How many steps' launches the kernel wrappers make in a run: every
    step's eagerly; on the loop path (K > 1) the warm-up steps' and the
    capture's, since a replay calls no wrapper."""
    from tensorflowonspark_tpu_torch.train.strategy import _CapturedLoop

    return steps if steps_per_loop == 1 else _CapturedLoop.WARMUP + 1


def loop_trace(events, names, per_step, steps_per_loop):
    """The readings of the loop call the trainer traced (``--trace_call``),
    a call of replays only: the card ran ``per_step`` of each kernel in
    ``names`` for each of its K steps, in K graph launches."""
    traced = [e["device_trace"] for e in events if "device_trace" in e]
    if len(traced) != 1:
        raise AssertionError("expected one traced call, got {}".format(len(traced)))
    trace = traced[0]
    bad = {n: trace["launches"].get(n) for n in names if trace["launches"].get(n) != per_step * steps_per_loop}
    if bad or trace["graph_launches"] != steps_per_loop:
        raise AssertionError("traced loop call: device launches {} (want {} x {} each), graph launches {} "
                             "(want {})".format(bad, per_step, steps_per_loop, trace["graph_launches"],
                                                steps_per_loop))
    return trace


def phase_slice(torch, fused_bn, steps=STEPS, steps_per_loop=1):
    """The port's main path through the user's entry points; with
    ``steps_per_loop`` K > 1 its loop path (``--steps_per_loop K``: one
    captured CUDA graph a step, replayed), whose call ``TRACE_CALL`` the
    trainer traces. Returns each BN wrapper's launches in the run (53 a
    step for :func:`wrapper_calls` steps) and, on the loop path, the traced
    call's device launches of each BN kernel (53 a replayed step)."""
    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark

    args = resnet_spark.build_parser().parse_args([
        "--dataset", "imagenet", "--bn_impl", "pallas", "--batch_size", str(BATCH),
        "--train_steps", str(steps), "--log_steps", "1", "--steps_per_loop", str(steps_per_loop),
        "--trace_call", str(TRACE_CALL if steps_per_loop > 1 else 0),
    ])
    # the counts the trainer reports start at 0 in its freshly spawned
    # process; this process's own counts are zeroed too
    fused_bn.reset_launch_counts()
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        cluster = TFCluster.run(
            sc, resnet_spark.main_fun, args, 1,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
            env={util.ENV_PLATFORM: "gpu"},
        )
        if not cluster.wait_for_completion(timeout=600):
            raise TimeoutError("the trainer did not finish within 600 s")
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown()
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    events = sorted(
        (e for e in metrics["events"] if e.get("span") == "train_step"), key=lambda e: e["step"]
    )
    losses = [e.get("loss") for e in events]
    calls = steps // steps_per_loop
    if len(events) != calls or not all(isinstance(v, float) and math.isfinite(v) for v in losses):
        raise AssertionError("expected {} finite losses, got {}".format(calls, losses))
    # past the first call (build, warm-up, capture), the traced call left out
    timed = [e["dur_s"] for e in events[1:] if "device_trace" not in e]
    launches = {
        name: int(metrics["counters"].get("fused_bn_{}_launches_total".format(name), {}).get("value", 0))
        for name, *_ in KERNEL_TABLE
    }
    want = 53 * wrapper_calls(steps, steps_per_loop)
    line = {"phase": "slice" if steps_per_loop == 1 else "slice_loop", "model": "resnet50",
            "dtype": "bfloat16", "bn_impl": "pallas", "batch": BATCH, "image": IMAGE, "steps": steps,
            "steps_per_loop": steps_per_loop, "logged_steps": [e["step"] for e in events],
            "losses": losses, "call_s": [e["dur_s"] for e in events],
            "images_per_sec_after_first_call": BATCH * steps_per_loop * len(timed) / sum(timed),
            "launches": launches, "expected_launches": want, "wall_s": wall}
    bad = {k: v for k, v in launches.items() if v != want}
    trace = None
    if steps_per_loop > 1 and not bad:
        trace = loop_trace(events, [name for name, *_ in KERNEL_TABLE], 53, steps_per_loop)
        line.update(traced_call=TRACE_CALL, device_trace=trace)
    emit(line)
    if bad:
        raise AssertionError("kernel wrapper launches {} != 53 x {} steps".format(
            bad, wrapper_calls(steps, steps_per_loop)))
    return launches, trace and trace["launches"]


def _train_grads(torch, fused_bn, resnet, dtype, impl, batch, loss_fn):
    """Loss, flattened parameter gradients and kernel launches of one
    training forward and backward of the slice's model (weights seed 0)."""
    model = resnet.resnet50(
        dtype=dtype, bn_impl=impl, generator=torch.Generator().manual_seed(0)
    ).cuda().train()
    before = fused_bn.launch_counts()
    loss, _ = loss_fn(model, dict(model.named_buffers()), batch)
    loss.backward()
    torch.cuda.synchronize()
    after = fused_bn.launch_counts()
    grad = torch.cat([p.grad.float().flatten() for p in model.parameters()])
    return loss.item(), grad, {k: after[k] - before[k] for k in after}


def phase_compare(torch, fused_bn, resnet):
    """One train step, kernels vs plain versions, same weights and batch:
    the loss and the relative difference of all parameter gradients, each
    against its limit. A control run with dgamma off by 1% in every layer
    shows that the gradient limit sees a fault the loss cannot."""
    import numpy as np

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)  # the trainer's synthetic batch (executor 0)
    batch = {
        "image": torch.as_tensor(
            rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)).cuda(),
        "label": torch.as_tensor(rng.integers(0, 1000, BATCH)).cuda(),
    }
    loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
    # (loss limit, gradient limit). float32: the gradient limit sits between
    # the sound reading (3.1e-7 on an H100) and the 1% dgamma fault below
    # (9.0e-4); it holds only because both sides round each layer's Σx and
    # Σx² once from exact sums (any two f32 summation orders of the stem's
    # statistics move the gradients about 2e-4). bfloat16: BN outputs that
    # round one bf16 ulp apart propagate through the network (the gradients
    # read 3.8e-3 apart)
    limits = {"float32": (1e-3, 1e-4), "bfloat16": (5e-2, 3e-2)}
    grads = {}
    for dtype_name, (tol, grad_tol) in limits.items():
        dtype = getattr(torch, dtype_name)
        lk, gk, nk = _train_grads(torch, fused_bn, resnet, dtype, "pallas", batch, loss_fn)
        lp, gp, np_ = _train_grads(torch, fused_bn, resnet, dtype, "plain", batch, loss_fn)
        if any(v != 53 for v in nk.values()) or any(np_.values()):
            raise AssertionError("kernel launches: kernels {} plain {}".format(nk, np_))
        grad_rel = float((gk - gp).norm() / gp.norm())
        grads[dtype_name] = (lp, gp)
        emit({"phase": "compare", "dtype": dtype_name, "tf32": False, "loss_kernels": lk,
              "loss_plain": lp, "loss_diff": abs(lk - lp), "tolerance": tol,
              "grad_rel_diff": grad_rel, "grad_tolerance": grad_tol})
        if not (math.isfinite(lk) and abs(lk - lp) <= tol):
            raise AssertionError("{} loss {} vs plain {} beyond {}".format(dtype_name, lk, lp, tol))
        if not grad_rel <= grad_tol:
            raise AssertionError("{} gradients {} apart (relative), beyond {}".format(
                dtype_name, grad_rel, grad_tol))

    real = fused_bn.bn_bwd_reduce

    def faulted(*args):
        dgamma, dbeta = real(*args)
        return dgamma * 1.01, dbeta

    # the wrapper counts its launches on the module's name for it, which
    # is this stand-in while the fault is in
    faulted.launches = 0
    fused_bn.bn_bwd_reduce = faulted
    try:
        lf, gf, _ = _train_grads(torch, fused_bn, resnet, torch.float32, "pallas", batch, loss_fn)
    finally:
        fused_bn.bn_bwd_reduce = real
    grad_tol = limits["float32"][1]
    lp, gp = grads["float32"]
    control = float((gf - gp).norm() / gp.norm())
    emit({"phase": "compare_control", "dtype": "float32", "fault": "dgamma x 1.01",
          "loss_diff": abs(lf - lp), "grad_rel_diff": control, "grad_tolerance": grad_tol})
    if not control > grad_tol:
        raise AssertionError("a 1% dgamma fault moved the gradients by only {}, within the "
                             "limit {}: the gradient check cannot see it".format(control, grad_tol))


def lm_corpus(here):
    """The LM slice's corpus (the example's synthetic TFRecord text) under
    ``build/`` in the checkout, and the first packed batch that the trainer
    (executor 0 of 1: every shard, seed 0) draws from it."""
    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.data import TextPipeline, Tokenizer
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    data_dir = os.path.join(here, "build", "lm_corpus")
    transformer_spark.make_text_corpus(data_dir)
    stream = iter(TextPipeline(tfrecord.list_shards(data_dir), Tokenizer(kind="byte"),
                               seq_len=LM_SEQ + 1, batch_size=LM_BATCH, seed=0, epochs=None,
                               pack_workers=0))
    batch = next(stream)
    stream.close()
    return data_dir, batch


def attended_pairs(seg):
    """(q, k) pairs per head that causal attention with the segment fence
    needs on ``seg`` ``[B, L]`` (pad rows, id 0, attend to each other):
    n(n+1)/2 for each id with n positions in a row."""
    import numpy as np

    total = 0
    for row in np.asarray(seg):
        _, counts = np.unique(row, return_counts=True)
        total += int((counts * (counts + 1) // 2).sum())
    return total


def flash_bound(name, seg, heads, length, d, elem_bytes, pairs=None):
    """(bound_ms, bound_by) of one call: the larger of bytes over the memory
    rate (each input read once, each output written once) and the matrix
    products' flops on the attended pairs over the dtype's peak rate."""
    _, _, products, tensors, rows = next(t for t in FLASH_TABLE if t[0] == name)
    b = seg.shape[0]
    bh = b * heads
    if pairs is None:
        pairs = attended_pairs(seg) * heads
    flops = products * 2 * d * pairs
    moved = tensors * bh * length * d * elem_bytes + rows * bh * length * 4 + b * length * 4
    peak = BF16_FLOPS_PER_S if elem_bytes == 2 else F32_FLOPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_errors(name, got, want):
    """``(max_abs_err, failures, readings)`` of one kernel's outputs against
    its plain version's: f32 outputs within ``FLASH_F32_TOL`` of the largest
    value; bf16 outputs elementwise and as a norm (``FLASH_BF16_*``)."""
    import torch

    failures, readings, max_abs = [], {"elem": None, "norm": None}, 0.0
    for i, (g, r) in enumerate(zip(got, want)):
        g, rf = g.float(), r.float()
        diff = (g - rf).abs()
        err = float(diff.max())
        max_abs = max(max_abs, err)
        if r.dtype == torch.float32:
            tol = FLASH_F32_TOL * max(1.0, float(rf.abs().max()))
            if not err <= tol:
                failures.append("output {}: max abs err {} > {}".format(i, err, tol))
            continue
        rms = rf.square().mean().sqrt()
        elem = float((diff / (rf.abs() + rms)).max())
        norm = float((g - rf).norm() / rf.norm())
        readings = {"elem": max(readings["elem"] or 0.0, elem),
                    "norm": max(readings["norm"] or 0.0, norm)}
        if not elem <= FLASH_BF16_ELEM_TOL:
            failures.append("output {}: elementwise err {} > {}".format(i, elem, FLASH_BF16_ELEM_TOL))
        if not norm <= FLASH_BF16_NORM_TOL[name]:
            failures.append("output {}: norm err {} > {}".format(i, norm, FLASH_BF16_NORM_TOL[name]))
    return max_abs, failures, readings


def o_dropped_block(fa, q, k, v, seg, scale, heads):
    """The plain forward's O with keys 64-127 dropped from every query row
    past them: a fault that the elementwise limit must catch."""
    import torch

    s = fa._masked_scores(q, k, seg, scale, True, heads)
    s[:, 128:, 64:128] = fa.NEG_BIG
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    return (torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), v.float()) / denom).to(q.dtype)


def _sdpa_backend(torch, F, q, k, v, mask):
    """The first of PyTorch's fused SDPA backends that takes this boolean
    mask and dtype (the yardstick's; the port never calls SDPA)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes a boolean mask here")


def sdpa_yardsticks(torch, F, q, k, v, do, seg, heads):
    """SDPA's forward and its backward (dq, dk, dv) on the kernels' ``[BH,
    L, D]`` operands, causal with the segment fence as a boolean mask, on
    the first fused backend that takes them (:func:`_sdpa_backend`):
    ``(forward, backward, backend)``."""
    from torch.nn.attention import sdpa_kernel

    bh, length, d = q.shape
    q4, k4, v4, do4 = (t.view(bh // heads, heads, length, d) for t in (q, k, v, do))
    pos = torch.arange(length, device=q.device)
    mask = ((pos[:, None] >= pos[None, :])[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]
    backend = _sdpa_backend(torch, F, q4, k4, v4, mask)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
    with sdpa_kernel([backend]):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

    def forward():
        with sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    def backward():
        return torch.autograd.grad(out, (qg, kg, vg), do4, retain_graph=True)

    return forward, backward, backend


def phase_flash_kernel(torch, F, fa, seg_slice):
    """Each flash kernel against its plain version, bf16 at the slice's
    shape and f32 at [16, 1024, 64], causal with the corpus's segments. On
    the bf16 line two faults must fail the check: each kernel's first
    output (O, dq, dk) off by 1%, and O with a kv block dropped. Returns the
    bf16 line's numbers per LM step (6 layers)."""
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums in full f32
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(1)
    heads, d = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    totals = {}
    for dtype_name, b, length in (("bfloat16", LM_BATCH, LM_SEQ), ("float32", 2, 1024)):
        dtype = getattr(torch, dtype_name)
        seg = seg_slice[:b, :length].contiguous()
        shape = (b * heads, length, d)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, seg, scale, True, heads)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (seg, scale, True, heads)
        bwd = (seg, do, lse_ref, delta, scale, True, heads)
        library_fwd, library_bwd, backend = sdpa_yardsticks(torch, F, q, k, v, do, seg, heads)
        cases = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *args),
                          lambda: fa.flash_fwd_plain(q, k, v, *args), library_fwd),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, *bwd),
                             lambda: fa.flash_bwd_dq_plain(q, k, v, *bwd), library_bwd),
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, *bwd),
                              lambda: fa.flash_bwd_dkv_plain(q, k, v, *bwd), library_bwd),
        }
        pairs = attended_pairs(seg.cpu()) * heads
        n_blk = -(-length // 64)
        blocks_causal = b * n_blk * (n_blk + 1) // 2
        blocks_fenced = int(fa.visited_blocks(seg.cpu(), True).sum())
        for name, (kernel, plain, library) in cases.items():
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err, failures, readings = flash_errors(name, got, want)
            controls = {}
            if dtype_name == "bfloat16":
                faults = {"x1.01": (got[0].float() * 1.01,) + got[1:]}
                if name == "flash_fwd":
                    faults["dropped_kv_block"] = (o_dropped_block(fa, q, k, v, seg, scale, heads),
                                                  got[1])
                for fault, outs in faults.items():
                    _, caught, controls[fault] = flash_errors(name, outs, want)
                    if not caught:
                        raise AssertionError("{}: the {} fault passed the check ({})".format(
                            name, fault, controls[fault]))
            if failures:
                raise AssertionError("{} {} at {}: {}".format(name, dtype_name, shape, failures))
            ms = time_ms(torch, kernel, flush)
            plain_ms = time_ms(torch, plain, flush)
            library_ms = time_ms(torch, library, flush)
            b_ms, b_by = flash_bound(name, seg, heads, length, d, q.element_size(), pairs)
            causal_ms, _ = flash_bound(name, seg, heads, length, d, q.element_size(),
                                       b * heads * length * (length + 1) // 2)
            line = {"phase": "kernel", "name": name, "shape": list(shape), "dtype": dtype_name,
                    "causal": True, "segments": int(sum(len(set(r)) for r in seg.cpu().tolist())),
                    "max_abs_err": err, "elem_err": readings["elem"], "norm_err": readings["norm"],
                    "elem_tolerance": FLASH_BF16_ELEM_TOL, "norm_tolerance": FLASH_BF16_NORM_TOL[name],
                    "f32_tolerance": FLASH_F32_TOL, "controls": controls,
                    "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library": "sdpa {} {}".format(
                        backend.name, "forward" if name == "flash_fwd" else "backward (dq+dk+dv)"),
                    "bound_ms": b_ms, "bound_by": b_by, "bound_ms_dense_causal": causal_ms,
                    # 64 x 64 block pairs of the batch: the bf16 kernels
                    # skip those the fence empties, the f32 ones only the
                    # causal ones
                    "blocks_visited": blocks_fenced if dtype_name == "bfloat16" else blocks_causal,
                    "blocks_causal": blocks_causal}
            emit(line)
            if dtype_name == "bfloat16":
                n_layers = LM["n_layers"]
                totals[name] = {"ms": n_layers * ms, "plain_ms": n_layers * plain_ms,
                                "library_ms": n_layers * library_ms, "bound_ms": n_layers * b_ms,
                                "bound_by": b_by, "max_abs_err": err}
        del q, k, v, do, o_ref, lse_ref, delta, cases, library_fwd, library_bwd
        torch.cuda.empty_cache()
    return totals


def queued_ms(torch, fn, calls=20, spin_cycles=100_000_000):
    """Device ms a call of ``fn`` over ``calls`` calls queued behind a spin
    (~50 ms) that outlasts their host work: the card runs them back to
    back, the host's launch gaps hidden (L2 warm)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def phase_kernel_headdim(torch, F, fa, seg_slice):
    """B5-B7 at head dims the kernels are not compiled for (module
    docstring, ``kernel_headdim``), beside the compiled ones: each launch
    against its plain version at the flash limits, on the LM slab's shape
    and segments (8 heads up to D = 128, the D = 256 LM's 2 heads up to
    256, the D = 512 LM's one head above), causal, bf16 and f32; a 1% dk
    fault caught at each padded and each split-D width; from D = 256 SDPA's
    time on the same operands (its backend named). Returns ``{wrapper:
    {"<d>_<dtype>": {"ms", "plain_ms", "bound_ms", "bound_by",
    "bound_ms_padded_width", "max_abs_err"[, "library_ms", "library"]}}}``."""
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums in full f32
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(2)
    seg = seg_slice[:LM_BATCH, :LM_SEQ].contiguous()
    out = {name: {} for name, *_ in FLASH_TABLE}
    for d in sorted(HEADDIM_PADDED + HEADDIM_NATIVE + HEADDIM_SPLIT):
        heads = LM["n_heads"] if d <= 128 else LM_D256["n_heads"] if d <= 256 else LM_D512["n_heads"]
        pairs = attended_pairs(seg.cpu()) * heads
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            shape = (LM_BATCH * heads, LM_SEQ, d)
            q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, seg, scale, True, heads)
            delta = (do.float() * o_ref.float()).sum(-1)
            args = (seg, scale, True, heads)
            bwd = (seg, do, lse_ref, delta, scale, True, heads)
            cases = {
                "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *args), lambda: fa.flash_fwd_plain(q, k, v, *args)),
                "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, *bwd),
                                 lambda: fa.flash_bwd_dq_plain(q, k, v, *bwd)),
                "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, *bwd),
                                  lambda: fa.flash_bwd_dkv_plain(q, k, v, *bwd)),
            }
            library = None
            if d >= 256:
                library_fwd, library_bwd, backend = sdpa_yardsticks(torch, F, q, k, v, do, seg, heads)
                library = {"flash_fwd": library_fwd, "flash_bwd_dq": library_bwd, "flash_bwd_dkv": library_bwd}
            line = {"phase": "kernel_headdim", "shape": list(shape), "dtype": dtype_name, "causal": True,
                    "padded_to": fa.head_width(d), "split_d": d > fa.HEAD_DIMS[-1]}
            for name, (kernel, plain) in cases.items():
                n0 = fa.launch_counts()[name]
                got, want = kernel(), plain()
                launched = fa.launch_counts()[name] - n0
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                torch.cuda.synchronize()
                err, failures, readings = flash_errors(name, got, want)
                if launched != 1 or any(g.shape != shape for g in got if g.dim() == 3):
                    failures.append("{} launches, shapes {}".format(launched, [tuple(g.shape) for g in got]))
                control = None
                if name == "flash_bwd_dkv" and d in HEADDIM_PADDED + HEADDIM_SPLIT:
                    fault_err, caught, control = flash_errors(name, (got[0].float() * 1.01,) + got[1:], want)
                    control = dict(control, max_abs_err=fault_err)
                    if not caught:
                        failures.append("a 1% dk fault passed the check ({})".format(control))
                if failures:
                    raise AssertionError("kernel_headdim {} {} at {}: {}".format(name, dtype_name, shape, failures))
                b_ms, b_by = flash_bound(name, seg, heads, LM_SEQ, d, q.element_size(), pairs)
                res = {"ms": time_ms(torch, kernel, flush), "plain_ms": time_ms(torch, plain, flush),
                       "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                       "bound_ms_padded_width": flash_bound(name, seg, heads, LM_SEQ, fa.head_width(d),
                                                            q.element_size(), pairs)[0]}
                if library:
                    res.update(library_ms=time_ms(torch, library[name], flush), library="sdpa {} {}".format(
                        backend.name, "forward" if name == "flash_fwd" else "backward (dq+dk+dv)"))
                out[name]["{}_{}".format(d, dtype_name)] = res
                line[name] = dict(res, elem_err=readings["elem"], norm_err=readings["norm"],
                                  dk_fault=control)
            # a layer's attention forward and backward as the model runs
            # it (the autograd function: q, k, v and dO padded once for the
            # three launches) and as each wrapper pads its own operands
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def shared():
                torch.autograd.grad(fa._FlashAttention.apply(qg, kg, vg, seg, scale, True, heads), (qg, kg, vg), do)

            def each():
                o, lse = fa.flash_fwd(q, k, v, *args)
                dlt = (do.float() * o.float()).sum(-1)
                fa.flash_bwd_dq(q, k, v, seg, do, lse, dlt, scale, True, heads)
                fa.flash_bwd_dkv(q, k, v, seg, do, lse, dlt, scale, True, heads)

            line["layer_ms"] = {"pads_shared": queued_ms(torch, shared), "pads_each_launch": queued_ms(torch, each)}
            emit(line)
            del q, k, v, do, o_ref, lse_ref, delta, cases, qg, kg, vg, library
            torch.cuda.empty_cache()
    return out


def phase_flash_causal(torch, F, fa):
    """The bf16 kernels at the slice's shape without segment ids (pure
    causal, every causal block visited): the forward, dq and dk/dv against
    their plain versions under the bf16 limits, the forward's time against
    SDPA's forward and the backward pair's against SDPA's whole backward,
    both with ``is_causal=True``. This shows the kernels' design apart from
    the fence's skipped blocks."""
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms

    from torch.nn.attention import SDPBackend, sdpa_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(2)
    heads, d = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    shape = (LM_BATCH * heads, LM_SEQ, d)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o_ref, lse = fa.flash_fwd_plain(q, k, v, None, scale, True, heads)
    bwd = (None, do, lse, (do.float() * o_ref.float()).sum(-1), scale, True, heads)
    q4, k4, v4, do4 = (t.view(LM_BATCH, heads, LM_SEQ, d) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def library_fwd():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    n_blk = -(-LM_SEQ // 64)
    pairs = LM_BATCH * heads * LM_SEQ * (LM_SEQ + 1) // 2
    no_ids = torch.zeros(LM_BATCH, LM_SEQ, dtype=torch.int32)
    line = {"phase": "kernel_causal", "shape": list(shape), "dtype": "bfloat16", "causal": True,
            "segments": None, "blocks_visited": int(fa.visited_blocks(no_ids, True).sum()),
            "blocks_causal": LM_BATCH * n_blk * (n_blk + 1) // 2,
            "library": "sdpa backward (dq+dk+dv), is_causal=True"}
    for name, kernel, plain in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, None, scale, True, heads), lambda: (o_ref, lse)),
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, *bwd), lambda: fa.flash_bwd_dq_plain(q, k, v, *bwd)),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, *bwd),
             lambda: fa.flash_bwd_dkv_plain(q, k, v, *bwd))):
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err, failures, readings = flash_errors(name, got, want)
        if failures:
            raise AssertionError("{} bfloat16 at {} without segment ids: {}".format(name, shape, failures))
        del got, want
        b_ms, b_by = flash_bound(name, no_ids, heads, LM_SEQ, d, q.element_size(), pairs)
        line[name] = {"ms": time_ms(torch, kernel, flush), "max_abs_err": err, "elem_err": readings["elem"],
                      "norm_err": readings["norm"], "bound_ms": b_ms, "bound_by": b_by}
    line["flash_fwd"].update(library="sdpa forward, is_causal=True", library_ms=time_ms(torch, library_fwd, flush))
    line["library_ms"] = time_ms(
        torch, lambda: torch.autograd.grad(out, (qg, kg, vg), do4, retain_graph=True), flush)
    line["pair_ms"] = line["flash_bwd_dq"]["ms"] + line["flash_bwd_dkv"]["ms"]
    emit(line)
    del q, k, v, do, q4, k4, v4, do4, qg, kg, vg, out, o_ref, lse, bwd
    torch.cuda.empty_cache()


#: the ring phase: members of the ring, and the unpacked causal sequence's length
RING_N, RING_LONG = 4, 16384
#: the ring's merged output and gradients against whole-sequence flash:
#: bf16 as a norm, f32 within this much of the largest value
RING_BF16_NORM_TOL, RING_F32_TOL = 2.0 ** -8, 1e-4
#: a bf16 hop's f32 outputs, before any cast, against their references in
#: f32 (the forward's O against ``flash_fwd_online_plain``, the kernel's own
#: rounding of p; dq, dk, dv against the plain versions): a norm well below
#: one bf16 rounding (~2^-9.3), which the same hop's bf16 outputs cast up to
#: f32 (the control) must exceed
RING_F32_OUT_NORM_TOL = 2.0 ** -12
#: (wrapper: f32 [BH, L] row vectors moved, f32 [BH, L, D] outputs written)
#: of a ring hop: the bf16 kernels write f32 outputs for the ring's sums
RING_HOP_IO = {"flash_fwd": (1, 1), "flash_bwd_dq": (2, 1), "flash_bwd_dkv": (2, 2)}


def hop_pairs(seg_q, seg_k, diagonal):
    """(q, k) pairs per head that one ring hop attends on ``[B, L_local]``
    ids: on the diagonal, causal pairs of equal ids (n(n+1)/2 an id); off
    it, every pair of equal ids."""
    import numpy as np

    total = 0
    for rq, rk in zip(np.asarray(seg_q), np.asarray(seg_k)):
        ids, cq = np.unique(rq, return_counts=True)
        if diagonal:
            total += int((cq * (cq + 1) // 2).sum())
        else:
            ck = dict(zip(*np.unique(rk, return_counts=True)))
            total += int(sum(int(c) * int(ck.get(i, 0)) for i, c in zip(ids, cq)))
    return total


def ring_hop_bound(name, bh, b, length, d, elem_bytes, pairs, segmented):
    """(bound_ms, bound_by) of one ring hop's call: its inputs read once
    (q, k, v and dO, f32 row vectors, both sides' ids), its f32 outputs
    written once, and its matrix products on the attended pairs."""
    _, _, products, tensors, _ = next(t for t in FLASH_TABLE if t[0] == name)
    rows, outs = RING_HOP_IO[name]
    moved = ((tensors - outs) * bh * length * d * elem_bytes + outs * bh * length * d * 4 + rows * bh * length * 4
             + (2 * b * length * 4 if segmented else 0))
    flops = products * 2 * d * pairs
    peak = BF16_FLOPS_PER_S if elem_bytes == 2 else F32_FLOPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attending_rows(torch, seg_q, seg_k, diagonal, heads):
    """``[BH, L]`` booleans: the rows that attend at least one key of a hop
    (the rows a hop's O and lse are compared on; a row that attends none
    weighs 0 in the merge, ROADMAP 4c)."""
    if seg_q is None:
        return None
    eq = seg_q[:, :, None] == seg_k[:, None, :]
    if diagonal:
        eq = eq & torch.ones(seg_q.shape[1], seg_q.shape[1], dtype=torch.bool, device=seg_q.device).tril()
    return eq.any(-1).repeat_interleave(heads, 0)


def hop_f32_outputs(torch, fa, name, kernel, args, seg_k, rows, got, ref):
    """``{output: (norm_err, control_norm_err)}`` of one bf16 ring hop's
    kernel: its f32 outputs ``got`` (before any cast) against their f32
    references (the forward's O against ``flash_fwd_online_plain``, the
    gradients against the plain versions' ``ref``), and the same launch
    with bf16 outputs cast up to f32 against the same references (the
    control that the limit must refuse). The forward on ``rows`` only."""
    if name == "flash_fwd":
        got, ref = got[:1], fa.flash_fwd_online_plain(*args, seg_k=seg_k)[:1]
    control = kernel(*args, seg_k=seg_k)
    control = control if isinstance(control, tuple) else (control,)
    whats = {"flash_fwd": ("o",), "flash_bwd_dq": ("dq",), "flash_bwd_dkv": ("dk", "dv")}[name]
    out = {}
    for what, g, c, r in zip(whats, got, control, ref):
        if g.dtype != torch.float32:
            raise AssertionError("{} {}: a ring hop's output is {}, not float32".format(name, what, g.dtype))
        if rows is not None and name == "flash_fwd":
            g, c, r = g[rows], c[rows], r[rows]
        c = c.float()
        out[what] = (float((g - r).norm() / r.norm()), float((c - r).norm() / r.norm()))
    return out


def phase_kernel_ring(torch, fa, ra, seg_slice):
    """Ring attention over ``RING_N`` members in this process
    (``ring_attention_local``, the exchange's seam), at the LM's width (8
    heads of 64): bf16 over the packed slab [8, 2048] and over one unpacked
    causal sequence of ``RING_LONG``, and f32 over the slab cut to [2, 1024].
    Each case: the counts set to 0, the ring's forward and backward run
    (traced), each wrapper's launches and the trace's read (n(n+1)/2 each);
    the merged output and the three gradients held against whole-sequence
    ``flash_attention`` on the same tensors (bf16 as a norm within
    ``RING_BF16_NORM_TOL``, f32 within ``RING_F32_TOL`` of the largest);
    every hop's three kernels against their plain versions at the flash
    limits (O and lse on the rows that attend a key of the hop); in bf16
    each hop's f32 outputs before any cast within
    ``RING_F32_OUT_NORM_TOL`` of their f32 references, a limit that the
    hop's bf16 outputs cast up to f32 must fail (:func:`hop_f32_outputs`);
    a 1% fault in one hop's dk that the check must catch; the ms of a diagonal and an
    off-diagonal hop, forward and backward, beside their bounds. Returns
    the packed case's launches (wrappers, trace) and hop timings."""
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms
    from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention
    from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    heads, d, n = LM["n_heads"], LM["d_model"] // LM["n_heads"], RING_N
    want = n * (n + 1) // 2
    names = [name for name, *_ in FLASH_TABLE]
    out = None
    for case, dtype_name, b, length, packed in (("packed", "bfloat16", LM_BATCH, LM_SEQ, True),
                                                ("long", "bfloat16", 1, RING_LONG, False),
                                                ("packed_f32", "float32", 2, 1024, True)):
        dtype = getattr(torch, dtype_name)
        seg = seg_slice[:b, :length].contiguous() if packed else None
        q, k, v, do = (torch.randn(b, heads, length, d, device="cuda", generator=gen).to(dtype) for _ in range(4))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        fa.reset_launch_counts()
        with KernelTrace() as trace:
            o = ra.ring_attention_local(*leaves, n, causal=True, segment_ids=seg)
            grads = torch.autograd.grad(o, leaves, do)
        launches = fa.launch_counts()
        traced = trace.readings["launches"]
        ref_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ref = flash_attention(*ref_leaves, causal=True, segment_ids=seg)
        ref_grads = torch.autograd.grad(ref, ref_leaves, do)
        errs = {}
        for what, got, want_t in zip(("o", "dq", "dk", "dv"), (o.detach(),) + grads, (ref.detach(),) + ref_grads):
            g, r = got.float(), want_t.float()
            if dtype == torch.bfloat16:
                errs[what] = {"norm": float((g - r).norm() / r.norm()), "max_abs": float((g - r).abs().max())}
            else:
                errs[what] = {"max_abs": float((g - r).abs().max()), "ref_max": float(r.abs().max())}
        bad = [w for w, e in errs.items() if not (e["norm"] <= RING_BF16_NORM_TOL if "norm" in e
                                                   else e["max_abs"] <= RING_F32_TOL * max(1.0, e["ref_max"]))]
        bad += [nm for nm in names if launches[nm] != want or traced[nm] != want]
        # every hop's kernels against their plain versions, on the whole
        # sequence's final lse and delta (as the backward runs them)
        m = lambda t: t.reshape(b * heads, length, d).contiguous()  # noqa: E731
        qm, km, vm, dom = m(q), m(k), m(v), m(do)
        scale = 1.0 / math.sqrt(d)
        o_full, lse_full = fa.flash_fwd(qm, km, vm, seg, scale, True, heads)
        delta_full = (dom.float() * o_full.float()).sum(-1)
        chunk = lambda t: [c.contiguous() for c in t.chunk(n, 1)]  # noqa: E731
        qs, ks, vs, dos, lses, deltas = (chunk(t) for t in (qm, km, vm, dom, lse_full, delta_full))
        segs = chunk(seg) if seg is not None else [None] * n
        hop_errs, hop_ms, controls, f32_out = {}, {}, {}, {}
        for s, my, src, mask in ra.hop_schedule(n, True):
            fwd = (qs[my], ks[src], vs[src], segs[my], scale, mask, heads)
            bwd = (qs[my], ks[src], vs[src], segs[my], dos[my], lses[my], deltas[my], scale, mask, heads)
            kw = {"seg_k": segs[src], "out_dtype": torch.float32}
            rows = _attending_rows(torch, segs[my], segs[src], mask, heads)
            for name, kernel, plain, args in (("flash_fwd", fa.flash_fwd, fa.flash_fwd_plain, fwd),
                                              ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, bwd),
                                              ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, bwd)):
                got, ref_hop = kernel(*args, **kw), plain(*args, **kw)
                got = got if isinstance(got, tuple) else (got,)
                ref_hop = ref_hop if isinstance(ref_hop, tuple) else (ref_hop,)
                raw = got, ref_hop  # the f32 outputs before any cast
                # the main outputs in the input dtype for the flash limits;
                # O and lse on the rows that attend a key of the hop
                cast = lambda outs: tuple(  # noqa: E731
                    (t if name == "flash_fwd" and i == 1 else t.to(dtype)) for i, t in enumerate(outs))
                got, ref_hop = cast(got), cast(ref_hop)
                if name == "flash_fwd" and rows is not None:
                    if not bool(rows.any()):
                        continue  # no row of this hop attends a key: nothing it computes is used
                    got, ref_hop = tuple(t[rows] for t in got), tuple(t[rows] for t in ref_hop)
                key = "{}:s{}m{}".format(name, s, my)
                if not any(bool(t.any()) for t in ref_hop):
                    # no pair of the hop is attended (no shared id): the
                    # gradients' parts are exactly zero on both sides
                    if any(bool(t.any()) for t in got):
                        bad.append("{}: nonzero parts of a hop that attends nothing".format(key))
                    continue
                err, failures, readings = flash_errors(name, got, ref_hop)
                hop_errs[key] = {"max_abs_err": err, **readings}
                if failures:
                    bad.append("{} {}".format(key, failures))
                if dtype == torch.bfloat16:
                    f32_out[key] = hop_f32_outputs(torch, fa, name, kernel, args, segs[src], rows, *raw)
                    for what, (norm, control) in f32_out[key].items():
                        if not norm <= RING_F32_OUT_NORM_TOL:
                            bad.append("{} {}: f32 output norm err {} > {}".format(
                                key, what, norm, RING_F32_OUT_NORM_TOL))
                        if not control > RING_F32_OUT_NORM_TOL:
                            bad.append("{} {}: its bf16 output cast to f32 passed the f32 limit ({})".format(
                                key, what, control))
                if name == "flash_bwd_dkv" and s == 1 and my == 1 and dtype == torch.bfloat16:
                    _, caught, controls["dk_x1.01"] = flash_errors(name, (got[0].float().mul(1.01).to(dtype),)
                                                                + got[1:], ref_hop)
                    if not caught:
                        bad.append("a 1% fault in hop (s=1, member 1)'s dk passed the check {}".format(
                            controls["dk_x1.01"]))
            for kind, (s_t, my_t) in (("diagonal", (0, n - 1)), ("off_diagonal", (1, n - 1))):
                if (s, my) != (s_t, my_t):
                    continue
                local = length // n
                if packed:
                    pairs = hop_pairs(segs[my].cpu(), segs[src].cpu(), mask) * heads
                else:
                    pairs = b * heads * (local * (local + 1) // 2 if mask else local * local)
                entry = {"pairs": pairs}
                for name, kernel, args in (("flash_fwd", fa.flash_fwd, fwd), ("flash_bwd_dq", fa.flash_bwd_dq, bwd),
                                           ("flash_bwd_dkv", fa.flash_bwd_dkv, bwd)):
                    b_ms, b_by = ring_hop_bound(name, b * heads, b, local, d, q.element_size(), pairs, packed)
                    entry[name] = {"ms": time_ms(torch, lambda: kernel(*args, **kw), flush), "bound_ms": b_ms,
                                   "bound_by": b_by}
                entry["backward_ms"] = entry["flash_bwd_dq"]["ms"] + entry["flash_bwd_dkv"]["ms"]
                hop_ms[kind] = entry
        line = {"phase": "kernel_ring", "case": case, "dtype": dtype_name, "members": n, "batch": b,
                "heads": heads, "head_dim": d, "length": length, "local_length": length // n,
                "causal": True, "packed": packed, "launches": launches, "device_launches_traced": traced,
                "expected_launches": want, "vs_flash": errs, "norm_tolerance": RING_BF16_NORM_TOL,
                "f32_tolerance": RING_F32_TOL, "hop_max_abs_err": max(e["max_abs_err"] for e in hop_errs.values()),
                "hop_elem_err": max((e["elem"] or 0.0) for e in hop_errs.values()),
                "hop_norm_err": {nm: max((e["norm"] or 0.0) for key, e in hop_errs.items() if key.startswith(nm + ":"))
                                 for nm in names},
                "controls": controls, "hop_ms": hop_ms}
        if f32_out:
            line["f32_outputs"] = {
                "norm_tolerance": RING_F32_OUT_NORM_TOL,
                **{what: {"max_norm_err": max(e[what][0] for e in f32_out.values() if what in e),
                          "min_bf16_control_norm_err": min(e[what][1] for e in f32_out.values() if what in e)}
                   for what in ("o", "dq", "dk", "dv")}}
        emit(line)
        if bad:
            raise AssertionError("kernel_ring {}: {}".format(case, bad))
        if case == "packed":
            out = {"launches": launches, "traced": traced, "hop_ms": hop_ms,
                   "max_abs_err": {nm: max(e["max_abs_err"] for key, e in hop_errs.items()
                                           if key.startswith(nm + ":")) for nm in names}}
        del q, k, v, do, leaves, o, grads, ref_leaves, ref, ref_grads, qm, km, vm, dom, o_full, lse_full
        torch.cuda.empty_cache()
    return out


def lm_defaults():
    """The transformer example's own defaults: ``(model config, seq_len,
    batch_size, dtype)``."""
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    args = transformer_spark.build_parser().parse_args([])
    cfg = {k: getattr(args, k) for k in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff")}
    return cfg, args.seq_len, args.batch_size, args.dtype


def phase_slice_lm(torch, fa, data_dir, steps, steps_per_loop=1, pack_workers=0, defaults=False, width=LM):
    """The port's LM path through the user's entry points; with
    ``steps_per_loop`` K > 1 its loop path, traced as in :func:`phase_slice`;
    with ``pack_workers`` its text plane packing in forked workers
    (``slice_lm_pack``); with ``defaults`` the example at its own defaults
    (``slice_lm_defaults``: only the data, the steps and the loop set);
    ``width`` the model's (``LM_D256``: ``slice_lm_d256``; ``LM_D512``:
    ``slice_lm_d512``).
    Returns each flash wrapper's launches in the run (a layer a step for
    :func:`wrapper_calls` steps), on the loop path the traced call's device
    launches of each flash kernel (a layer a replayed step), and the
    losses."""
    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    model_args = [] if defaults else [
        "--vocab_size", str(width["vocab_size"]), "--d_model", str(width["d_model"]),
        "--n_layers", str(width["n_layers"]), "--n_heads", str(width["n_heads"]),
        "--d_ff", str(width["d_ff"]), "--seq_len", str(LM_SEQ), "--batch_size", str(LM_BATCH),
        "--dtype", "bfloat16", "--tokenizer", "byte"]
    args = transformer_spark.build_parser().parse_args(model_args + [
        "--train_steps", str(steps),
        "--log_steps", "1", "--data_dir", data_dir, "--steps_per_loop", str(steps_per_loop),
        "--trace_call", str(TRACE_CALL if steps_per_loop > 1 else 0),
        "--pack_workers", str(pack_workers),
    ])
    cfg = {k: getattr(args, k) for k in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff")}
    seq, rows = args.seq_len, args.batch_size
    fa.reset_launch_counts()  # the trainer's counts start at 0 in its fresh process
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        cluster = TFCluster.run(
            sc, transformer_spark.main_fun, args, 1,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
            env={util.ENV_PLATFORM: "gpu"},
        )
        if not cluster.wait_for_completion(timeout=600):
            raise TimeoutError("the LM trainer did not finish within 600 s")
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown()
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    events = sorted(
        (e for e in metrics["events"] if e.get("span") == "train_step"), key=lambda e: e["step"]
    )
    losses = [e.get("loss") for e in events]
    calls = steps // steps_per_loop
    if len(events) != calls or not all(isinstance(v, float) and math.isfinite(v) for v in losses):
        raise AssertionError("expected {} finite LM losses, got {}".format(calls, losses))
    # past the first call (build, warm-up, capture), the traced call left out
    timed = [e["dur_s"] for e in events[1:] if "device_trace" not in e]
    launches = {
        name: int(metrics["counters"].get(
            "flash_attention_{}_launches_total".format(name[len("flash_"):]), {}).get("value", 0))
        for name, *_ in FLASH_TABLE
    }
    want = cfg["n_layers"] * wrapper_calls(steps, steps_per_loop)
    efficiency = metrics["gauges"].get("text_pack_efficiency", {}).get("value")
    name = "slice_lm_pack" if pack_workers else "slice_lm" if steps_per_loop == 1 else "slice_lm_loop"
    if defaults or width is not LM:
        name = ("slice_lm_defaults" if defaults else "slice_lm_d{}".format(cfg["d_model"] // cfg["n_heads"])) + (
            "_loop" if steps_per_loop > 1 else "")
    line = {"phase": name, "model": "transformer", "pack_workers": pack_workers,
            "config": dict(cfg, seq_len=seq), "head_dim": cfg["d_model"] // cfg["n_heads"],
            "dtype": args.dtype, "batch": rows, "steps": steps,
            "steps_per_loop": steps_per_loop, "logged_steps": [e["step"] for e in events],
            "losses": losses, "call_s": [e["dur_s"] for e in events],
            "tokens_per_sec_after_first_call": rows * seq * steps_per_loop * len(timed) / sum(timed),
            "packing_efficiency": efficiency, "launches": launches,
            "expected_launches": want, "wall_s": wall}
    if pack_workers:
        # the pack plane ran: its worker gauge was set (back at 0 after close)
        line["pack_plane"] = "decode_workers" in metrics["gauges"]
    bad = {k: v for k, v in launches.items() if v != want}
    trace = None
    if steps_per_loop > 1 and not bad:
        trace = loop_trace(events, [name for name, *_ in FLASH_TABLE], cfg["n_layers"], steps_per_loop)
        line.update(traced_call=TRACE_CALL, device_trace=trace)
    emit(line)
    if bad:
        raise AssertionError("flash kernel wrapper launches {} != {} x {} steps".format(
            bad, cfg["n_layers"], wrapper_calls(steps, steps_per_loop)))
    if not (isinstance(efficiency, float) and 0 < efficiency <= 1):
        raise AssertionError("packing efficiency {} outside (0, 1]".format(efficiency))
    if pack_workers and not line["pack_plane"]:
        raise AssertionError("slice_lm_pack: the pack plane did not run")
    return launches, trace and trace["launches"], losses


def _lm_grads(torch, fa, transformer, dtype_name, impl, batch, cfg=LM):
    """Loss, all parameter gradients (flattened), the last layer's attention
    projection gradients (``{"q", "k", "v"}`` weights) and flash launches
    of one LM training forward and backward (weights seed 0)."""
    model = transformer.create_model(
        dtype=dtype_name, attention=impl, generator=torch.Generator().manual_seed(0), **cfg
    ).cuda().train()
    before = fa.launch_counts()
    loss, _ = transformer.make_loss_fn(model)(model, batch)
    loss.backward()
    torch.cuda.synchronize()
    after = fa.launch_counts()
    grad = torch.cat([p.grad.float().flatten() for p in model.parameters()])
    last = getattr(model, "layer_{}".format(cfg["n_layers"] - 1)).attn
    attn = {name: getattr(last, name).weight.grad.float() for name in ("q", "k", "v")}
    del model, last
    torch.cuda.empty_cache()
    return loss.item(), grad, attn, {k: after[k] - before[k] for k in after}


def _rel(got, ref):
    return float((got - ref).norm() / ref.norm())


@contextlib.contextmanager
def plain_kernels(fa, wrappers):
    """The given flash wrappers replaced by their plain versions inside the
    block: the same autograd path and the same bf16 casts of p and ds, with
    those kernels not launched."""
    saved = {fn.__name__: fn for fn in wrappers}
    for name in saved:
        setattr(fa, name, getattr(fa, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)


@contextlib.contextmanager
def dk_fault(fa):
    """dk off by 1% in the dk/dv kernel's output inside the block."""
    real = fa.flash_bwd_dkv

    def faulted(*args):
        dk, dv = real(*args)
        return dk * 1.01, dv

    # the wrapper counts its launches on the module's name for it, which
    # is this stand-in while the fault is in
    faulted.launches = 0
    fa.flash_bwd_dkv = faulted
    try:
        yield
    finally:
        fa.flash_bwd_dkv = real


def phase_compare_lm(torch, fa, transformer, host_batches, cfg=LM, name="compare_lm",
                     bf16_tols=(LM_BF16_LOSS_TOL, LM_BF16_GRAD_TOL)):
    """One LM train step through the flash kernels against a reference step
    on the same weights and packed batch, then the same step with a 1% fault
    in dk, each against stated limits, on each of ``host_batches``
    (``cfg``: the LM's width, one batch; the example's defaults in
    ``compare_lm_defaults``, head dim 32 through the padding route, over
    several batches, its bf16 loss and gradients held to ``bf16_tols``).
    Every batch is read before any is checked.

    float32 (TF32 off): against plain attention, the dense f32 math; the
    loss and the relative difference of all parameter gradients, which the
    fault must break.

    bfloat16: against the kernels' plain versions on the same autograd path
    (plain attention keeps p and ds in f32: the kernels' bf16 rounding alone
    moves the gradients by 1.2e-3). The loss and the whole gradient are
    held to a step's bf16 rounding, which leaves no room for a 1% fault: any
    difference flips bf16 roundings layer after layer (the whole gradient
    reads 1.1e-3 apart, the dk fault 1.6e-3; the q, k, v projections of all
    layers 8.9e-4 and 2.0e-3). The fault is held in the last layer's q, k
    and v projection gradients, each relative to its own norm, with the
    forward kernel on both sides and only the backward kernels against
    their plain versions: there the gradient arriving at attention is the
    same on both sides, and dq, dk, dv reach the weights in one product."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    loss_tol, grad_tol = bf16_tols
    readings = [_compare_lm_batch(torch, fa, transformer, host_batch, cfg, name, bf16_tols, index)
                for index, host_batch in enumerate(host_batches)]
    failures = []
    for index, (f32, bf16) in enumerate(readings):
        checks = [
            ("f32 loss", f32["finite"] and f32["loss_diff"] <= 1e-4),
            ("f32 gradients", f32["grad_rel_diff"] <= 1e-4),
            ("f32 dk fault caught", f32["control_grad_rel_diff"] > 1e-4),
            ("bf16 loss", bf16["finite"] and bf16["loss_diff"] <= loss_tol),
            ("bf16 gradients", bf16["grad_rel_diff"] <= grad_tol),
            ("bf16 projection gradients",
             max(bf16["last_attn_grad_rel_diff"].values()) <= LM_BF16_ATTN_GRAD_TOL),
            ("bf16 dk fault caught",
             max(bf16["control_last_attn_grad_rel_diff"].values()) > LM_BF16_ATTN_GRAD_TOL),
            ("same forward", bf16["loss_diff_plain_backward"] == 0.0),
        ]
        failed = [check for check, ok in checks if not ok]
        if failed:
            failures.append("batch {}: {} (f32 {}, bf16 {})".format(index, failed, f32, bf16))
    if failures:
        raise AssertionError("{} failed: {}".format(name, "; ".join(failures)))


def _compare_lm_batch(torch, fa, transformer, host_batch, cfg, name, bf16_tols, index):
    """:func:`phase_compare_lm`'s readings on one batch, emitted: ``(f32,
    bf16)``."""
    batch = {k: torch.as_tensor(v).cuda() for k, v in host_batch.items()}
    n = cfg["n_layers"]
    kernels = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    bwd_plain = {"flash_fwd": n, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    none = dict.fromkeys(kernels, 0)
    run = lambda dtype, impl="flash": _lm_grads(torch, fa, transformer, dtype, impl, batch, cfg)  # noqa: E731
    shape = {"config": cfg, "head_dim": cfg["d_model"] // cfg["n_heads"], "batch": list(batch["tokens"].shape),
             "batch_index": index}

    lk, gk, _, nk = run("float32")
    lp, gp, _, np_ = run("float32", "plain")
    with dk_fault(fa):
        lf, gf, _, _ = run("float32")
    if (nk, np_) != (kernels, none):
        raise AssertionError("flash launches: kernels {} plain {}".format(nk, np_))
    f32 = {"loss_diff": abs(lk - lp), "grad_rel_diff": _rel(gk, gp),
           "control_grad_rel_diff": _rel(gf, gp), "finite": math.isfinite(lk)}
    emit({"phase": name, **shape, "dtype": "float32", "tf32": False,
          "reference": "plain attention", "loss_kernels": lk, "loss_reference": lp,
          "loss_tolerance": 1e-4, "grad_tolerance": 1e-4, "control": "dk x 1.01", **f32})
    del gk, gp, gf

    lk, gk, ak, nk = run("bfloat16")
    with plain_kernels(fa, fa.KERNELS):
        lp, gp, _, np_ = run("bfloat16")
    with plain_kernels(fa, (fa.flash_bwd_dq, fa.flash_bwd_dkv)):
        lb, _, ab, nb = run("bfloat16")
    with dk_fault(fa):
        lf, gf, af, _ = run("bfloat16")
    if (nk, np_, nb) != (kernels, none, bwd_plain):
        raise AssertionError("flash launches: kernels {} plain {} plain backward {}".format(
            nk, np_, nb))
    bf16 = {"finite": math.isfinite(lk), "loss_diff": abs(lk - lp), "grad_rel_diff": _rel(gk, gp),
            "last_attn_grad_rel_diff": {n: _rel(ak[n], ab[n]) for n in ak},
            "control_grad_rel_diff": _rel(gf, gp),
            "control_last_attn_grad_rel_diff": {n: _rel(af[n], ab[n]) for n in af},
            "loss_diff_plain_backward": abs(lk - lb)}
    emit({"phase": name, **shape, "dtype": "bfloat16", "tf32": False,
          "reference": "plain versions (last_attn: plain backward, forward kernel)",
          "loss_kernels": lk, "loss_reference": lp, "loss_tolerance": bf16_tols[0],
          "grad_tolerance": bf16_tols[1], "attn_grad_tolerance": LM_BF16_ATTN_GRAD_TOL,
          "control": "dk x 1.01", **bf16})
    del gk, gp, gf, ak, ab, af
    return f32, bf16


def lm_defaults_batches(data_dir):
    """The first ``LM_DEFAULTS_COMPARE_BATCHES`` packed batches of the
    example at its own defaults from the corpus (executor 0 of 1: every
    shard, seed 0)."""
    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.data import TextPipeline, Tokenizer

    _, seq, rows, _ = lm_defaults()
    stream = iter(TextPipeline(tfrecord.list_shards(data_dir), Tokenizer(kind="byte"), seq_len=seq + 1,
                               batch_size=rows, seed=0, epochs=None, pack_workers=0))
    batches = [next(stream) for _ in range(LM_DEFAULTS_COMPARE_BATCHES)]
    stream.close()
    return batches


def phase_slice_lm_defaults(torch, fa, transformer, data_dir):
    """The transformer example at its own defaults (module docstring,
    ``slice_lm_defaults``): eager and through the loop, then one step
    through the kernels against their plain versions. Returns the eager
    run's and the loop run's wrapper launches and the traced call's device
    launches."""
    cfg, _, _, dtype = lm_defaults()
    if dtype != "bfloat16" or cfg["d_model"] // cfg["n_heads"] in fa.HEAD_DIMS:
        raise AssertionError("the example's defaults ({}, {}) no longer need the padding route".format(cfg, dtype))
    launches, _, _ = phase_slice_lm(torch, fa, data_dir, LM_DEFAULTS_STEPS, defaults=True)
    loop_launches, traced, _ = phase_slice_lm(torch, fa, data_dir, LM_DEFAULTS_STEPS, STEPS, defaults=True)
    torch.cuda.empty_cache()
    phase_compare_lm(torch, fa, transformer, lm_defaults_batches(data_dir), cfg, "compare_lm_defaults",
                     LM_DEFAULTS_BF16_TOLS)
    return launches, loop_launches, traced


def phase_slice_lm_width(torch, fa, transformer, data_dir, lm_batch, width, name):
    """The LM slice at another head width (module docstring,
    ``slice_lm_d256`` / ``slice_lm_d512``): eager and through the loop, then
    ``compare_lm``'s step on the slice's batch (``compare_lm_d256`` /
    ``compare_lm_d512``). Returns the eager run's and the loop run's wrapper
    launches and the traced call's device launches."""
    launches, _, _ = phase_slice_lm(torch, fa, data_dir, STEPS, width=width)
    loop_launches, traced, _ = phase_slice_lm(torch, fa, data_dir, LOOP_STEPS, STEPS, width=width)
    torch.cuda.empty_cache()
    phase_compare_lm(torch, fa, transformer, [lm_batch], width, "compare_" + name)
    return launches, loop_launches, traced


def _snapshot(torch, state):
    return {k: v.detach().clone() for k, v in dict(state.params, **state.model_state).items()}


def _mismatches(torch, a, b):
    """Names of the tensors of snapshot ``a`` that are not bitwise equal
    to ``b``'s."""
    return [k for k in a if not torch.equal(a[k], b[k])]


def phase_compare_loop(torch, resnet, transformer, lm_host_batch, k=STEPS):
    """For each slice, K captured steps (``compile_train_loop``: two eager
    warm-up steps, the capture, replays) against K eager steps from the same
    weights on the same K batches, with cuDNN deterministic: every
    parameter and BN statistic, and the last step's loss, must be bitwise
    equal. Two eager runs are held bitwise equal first, so that a mismatch
    is the capture's, not a non-deterministic algorithm's. Peak memory of
    each side beside."""
    import numpy as np

    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    strategy = SyncDataParallel("cuda")
    rng = np.random.default_rng(7)
    image_batches = [strategy.shard_batch({
        "image": rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
        "label": rng.integers(0, 1000, BATCH)}) for _ in range(k)]
    lm_batch = strategy.shard_batch(lm_host_batch)
    lm_batches = [{key: torch.roll(v, shifts=i, dims=1) for key, v in lm_batch.items()} for i in range(k)]
    args = resnet_spark.build_parser().parse_args(["--dataset", "imagenet", "--batch_size", str(BATCH)])

    def resnet_run(loop):
        optimizer = optim.sgd(resnet_spark.lr_schedule(args), momentum=0.9)
        state = strategy.create_state(lambda: resnet.resnet50(
            dtype=torch.bfloat16, bn_impl="pallas", generator=torch.Generator().manual_seed(0)), optimizer)
        loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
        if loop:
            return strategy.compile_train_loop(loss_fn, optimizer, k, mutable=True), state, image_batches
        return strategy.compile_train_step(loss_fn, optimizer, mutable=True), state, image_batches

    def lm_run(loop):
        model = transformer.create_model(dtype="bfloat16", **LM)
        optimizer = optim.adamw(3e-4)
        state = strategy.create_state(transformer.make_init_fn(model), optimizer,
                                      torch.Generator().manual_seed(0))
        loss_fn = transformer.make_loss_fn(model)
        if loop:
            return strategy.compile_train_loop(loss_fn, optimizer, k, has_aux=True), state, lm_batches
        return strategy.compile_train_step(loss_fn, optimizer, has_aux=True), state, lm_batches

    try:
        for name, build in (("resnet50", resnet_run), ("transformer", lm_run)):
            runs = {}
            for side in ("eager", "eager_again", "captured"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                fn, state, batches = build(side == "captured")
                t0 = time.perf_counter()
                if side == "captured":
                    state, metrics = fn(state, batches)
                else:
                    for b in batches:
                        state, metrics = fn(state, b)
                torch.cuda.synchronize()
                runs[side] = (_snapshot(torch, state), metrics["loss"].clone(), time.perf_counter() - t0,
                              torch.cuda.max_memory_allocated() / 1e9, state.step)
                del fn, state, metrics
            repeat = _mismatches(torch, runs["eager"][0], runs["eager_again"][0])
            captured = _mismatches(torch, runs["eager"][0], runs["captured"][0])
            loss_equal = torch.equal(runs["eager"][1], runs["captured"][1])
            emit({"phase": "compare_loop", "model": name, "dtype": "bfloat16", "steps": k,
                  "cudnn_deterministic": True, "tensors": len(runs["eager"][0]),
                  "eager_repeat_mismatches": repeat, "captured_mismatches": captured,
                  "loss_eager": float(runs["eager"][1]), "loss_captured": float(runs["captured"][1]),
                  "loss_bitwise": loss_equal, "steps_after": runs["captured"][4],
                  "seconds": {side: r[2] for side, r in runs.items()},
                  "peak_memory_gb": {side: r[3] for side, r in runs.items()}})
            if repeat:
                raise AssertionError("{}: two eager runs differ in {} tensors: the comparison "
                                     "cannot blame the capture".format(name, len(repeat)))
            if captured or not loss_equal or runs["captured"][4] != k:
                raise AssertionError("{}: the captured loop differs from the eager steps in {} "
                                     "tensors (loss bitwise: {})".format(name, len(captured), loss_equal))
            del runs
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        torch.cuda.empty_cache()


def phase_slice_fsdp(torch, fa, data_dir, work):
    """The LM slice fully sharded, through ``TFCluster.run``
    (``examples/transformer/fsdp_check.py``, module docstring phase
    ``slice_fsdp``). Returns the sharded side's flash wrapper launches and
    the traced call's device launches."""
    from tensorflowonspark_tpu_torch.examples.transformer import fsdp_check
    from tensorflowonspark_tpu_torch.train.strategy import _CapturedLoop

    fa.reset_launch_counts()  # the trainer's counts start at 0 in its fresh process
    os.makedirs(work, exist_ok=True)
    out = fsdp_check.main(["--data_dir", data_dir, "--work_dir", work, "--eager_steps", str(STEPS),
                           "--steps_per_loop", str(STEPS)])
    want = LM["n_layers"] * (STEPS + _CapturedLoop.WARMUP + 1)
    line = {"phase": "slice_fsdp", "model": "transformer", "config": dict(LM, seq_len=LM_SEQ),
            "batch": LM_BATCH, "expected_launches": want, "expected_traced": LM["n_layers"] * STEPS}
    line.update({k: v for k, v in out.items() if k not in ("config",)})
    emit(line)
    names = [name for name, *_ in FLASH_TABLE]
    for side in ("fsdp", "dp"):
        got = out[side]
        bad = {n: got["launches"][n] for n in names if got["launches"][n] != want}
        bad.update({n + "_traced": got["device_launches_traced_call"][n] for n in names
                    if got["device_launches_traced_call"][n] != LM["n_layers"] * STEPS})
        if bad or got["graph_launches_traced_call"] != STEPS:
            raise AssertionError("slice_fsdp {}: flash launches {} (want {} a wrapper, {} traced), graph "
                                 "launches {}".format(side, bad, want, LM["n_layers"] * STEPS,
                                                      got["graph_launches_traced_call"]))
    if out["fsdp"]["params_sharded"] != 38:
        raise AssertionError("slice_fsdp: {} parameters sharded, want 38".format(out["fsdp"]["params_sharded"]))
    return out["fsdp"]["launches"], out["fsdp"]["device_launches_traced_call"]


def phase_slice_axes(torch, fa, data_dir, work):
    """The LM slice on its model axes, through ``TFCluster.run``
    (``examples/transformer/axes_check.py``, module docstring phase
    ``slice_axes``). Returns the flash wrappers' launches on the tp side,
    its traced call's device launches, the wrappers' launches on the
    mixture's and the remat leg's paths, and the sp side's launches and
    traced device launches."""
    from tensorflowonspark_tpu_torch.examples.transformer import axes_check
    from tensorflowonspark_tpu_torch.train.strategy import _CapturedLoop

    fa.reset_launch_counts()  # the trainer's counts start at 0 in its fresh process
    os.makedirs(work, exist_ok=True)
    out = axes_check.main(["--data_dir", data_dir, "--work_dir", work, "--eager_steps", str(AXES_EAGER),
                           "--steps_per_loop", str(STEPS), "--pairs", str(AXES_PAIRS),
                           "--moe_steps", str(2 * STEPS)])
    layers, loop_steps = LM["n_layers"], _CapturedLoop.WARMUP + 1
    want = {"tp": layers * (AXES_EAGER + loop_steps), "moe": layers * (2 * STEPS + loop_steps),
            # remat recomputes each block's forward in the backward: B5 twice a step
            "remat_fwd": layers * (1 + 2 * (STEPS + loop_steps)), "remat_bwd": layers * (1 + STEPS + loop_steps)}
    line = {"phase": "slice_axes", "model": "transformer", "config": dict(LM, seq_len=LM_SEQ), "batch": LM_BATCH,
            "expected_launches": want, "expected_traced": layers * STEPS}
    line.update({k: v for k, v in out.items() if k not in ("config",)})
    emit(line)
    names = [name for name, *_ in FLASH_TABLE]
    bad = {}
    for side in ("tp", "sp", "dp"):
        got = out[side]
        bad.update({side + ":" + n: got["launches"][n] for n in names if got["launches"][n] != want["tp"]})
        bad.update({side + ":" + n + "_traced": got["device_launches_traced_call"][n] for n in names
                    if got["device_launches_traced_call"][n] != layers * STEPS})
        if got["graph_launches_traced_call"] != STEPS:
            bad[side + ":graph_launches"] = got["graph_launches_traced_call"]
    bad.update({"moe:" + n: out["moe"]["launches"][n] for n in names if out["moe"]["launches"][n] != want["moe"]})
    bad.update({"remat:" + n: out["remat"]["launches"][n] for n in names
                if out["remat"]["launches"][n] != want["remat_fwd" if n == "flash_fwd" else "remat_bwd"]})
    if bad:
        raise AssertionError("slice_axes: launches {} against {}".format(bad, want))
    if out["tp"]["params_split"] != 37:
        raise AssertionError("slice_axes: {} parameters split over tp, want 37".format(out["tp"]["params_split"]))
    return (out["tp"]["launches"], out["tp"]["device_launches_traced_call"], out["moe"]["launches"],
            out["remat"]["launches"], out["sp"]["launches"], out["sp"]["device_launches_traced_call"])


def _grad_gap(torch, got, want):
    """||got - want|| / ||want|| over every tensor of two lists of dicts."""
    flat = lambda tree: torch.cat([t.float().flatten() for d in tree for t in d.values()])  # noqa: E731
    return _rel(flat(got), flat(want))


def phase_pipeline(torch, fa, transformer, cfg=LM, rows=LM_BATCH, seq=LM_SEQ, device="cuda", timed_steps=3):
    """Pipeline parallelism at the LM slice's full width (module docstring
    phase ``pipeline``): ``Pipeline1F1B`` with ``PIPE_STAGES`` stages of
    ``PIPE_BLOCKS`` blocks on the one card, ``PIPE_MICRO`` microbatches,
    overlap on and off, against the same blocks composed sequentially; then
    ``pipeline_apply_local`` over ``PIPE_LOCAL_MEMBERS`` members of one
    block. Returns the flash wrappers' launches on the 1F1B step, the
    card's in its trace, and the wrappers' on the GPipe step."""
    import statistics

    import numpy as np
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.examples.sync_dp_check import pp_stage, stage_params
    from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace
    from tensorflowonspark_tpu_torch.parallel import (Pipeline1F1B, module_stage, pipeline_apply_local,
                                                      split_microbatches, stack_stage_params)

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model = transformer.create_model(dtype="bfloat16", generator=torch.Generator().manual_seed(0),
                                     **cfg).to(device)
    tokens = torch.as_tensor(np.random.default_rng(21).integers(1, cfg["vocab_size"], (rows, seq + 1)),
                             device=device)
    with torch.no_grad():
        x = F.embedding(tokens[:, :-1], model.embed.weight).to(torch.bfloat16)
    targets = tokens[:, 1:]

    def loss_fn(h, t):
        logits = model.lm_head(model.ln_f(h)).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), t.reshape(-1))

    P, M = PIPE_STAGES, PIPE_MICRO
    stage_fn = module_stage(pp_stage(model.cfg, PIPE_BLOCKS))
    stages = [stage_params(model, range(i * PIPE_BLOCKS, (i + 1) * PIPE_BLOCKS)) for i in range(P)]
    xs, ts = split_microbatches(x, M), split_microbatches(targets, M)

    def sequential():
        """The same blocks composed sequentially under plain autograd, a
        microbatch at a time, in this thread: the mean of the microbatches'
        losses and every stage's gradients."""
        leaves = [{k: v.clone().requires_grad_() for k, v in s.items()} for s in stages]
        total = 0.0
        for m in range(M):
            h = xs[m]
            for i in range(P):
                h = stage_fn(leaves[i], h)
            total = total + loss_fn(h, ts[m]) / M
        it = iter(torch.autograd.grad(total, [t for d in leaves for t in d.values()]))
        return total.detach(), [{k: next(it) for k in d} for d in leaves]

    ref_loss, ref_grads = sequential()
    sync()

    pipes = {side: Pipeline1F1B(stage_fn, stages, loss_fn, devices=[device] * P, overlap=side == "on")
             for side in ("on", "off")}
    try:
        runs = {}
        for side in ("on", "off"):  # first steps: warm, and the bitwise pair
            runs[side] = pipes[side].step(xs, ts)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        with KernelTrace() as trace:
            loss_t, grads_t = pipes["on"].step(xs, ts)
        launches = fa.launch_counts()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9 if cuda else None
        stats = {side: dict(p.last_stats) for side, p in pipes.items()}
        ms = {"on": [], "off": [], "sequential": []}
        for _ in range(timed_steps):
            for side in ("on", "off", "sequential"):
                sync()
                t0 = time.perf_counter()
                if side == "sequential":
                    sequential()
                else:
                    pipes[side].step(xs, ts)
                sync()
                ms[side].append((time.perf_counter() - t0) * 1e3)
                if side != "sequential":
                    stats[side] = dict(pipes[side].last_stats)
    finally:
        for p in pipes.values():
            p.close()
    bitwise = bool(torch.equal(runs["on"][0], runs["off"][0]) and all(
        torch.equal(a[k], b[k]) for a, b in zip(runs["on"][1], runs["off"][1]) for k in a))
    loss = float(runs["on"][0])
    want = {"flash_fwd": PIPE_BLOCKS * M * (2 * (P - 1) + 1), "flash_bwd_dq": PIPE_BLOCKS * M * P,
            "flash_bwd_dkv": PIPE_BLOCKS * M * P}
    one_f1b = {"loss": loss, "loss_sequential": float(ref_loss), "loss_diff": abs(loss - float(ref_loss)),
               "grad_rel_diff": _grad_gap(torch, runs["on"][1], ref_grads),
               "grad_rel_diff_by_stage": [_grad_gap(torch, [g], [r]) for g, r in zip(runs["on"][1], ref_grads)],
               "traced_step_loss_equal": bool(torch.equal(loss_t, runs["on"][0])),
               "on_off_bitwise": bitwise, "launches": launches, "expected_launches": want,
               "device_launches_traced": {n: trace.readings["launches"][n] for n in want},
               "traced_busy_ms": trace.readings["busy_ms"], "traced_idle_share": trace.readings["idle_share"],
               "traced_kernels": trace.readings["kernels"],
               "stage_op_busy_s": {side: s["busy_s"] for side, s in stats.items()},
               "window_s": {side: s["window_s"] for side, s in stats.items()},
               "step_ms": {side: {"median": statistics.median(v), "min": min(v), "max": max(v)}
                           for side, v in ms.items()},
               "bubble_fraction": {side: s["bubble_fraction"] for side, s in stats.items()},
               "bubble_fraction_closed_form": stats["on"]["bubble_fraction_theory"],
               "overlap_fraction": {side: s["overlap_fraction"] for side, s in stats.items()},
               "comm_busy_ms": {side: s["comm_busy_s"] * 1e3 for side, s in stats.items()},
               "stash_peak": stats["on"]["stash_peak"], "peak_memory_gb": peak_gb}
    del runs, grads_t, ref_grads

    # GPipe: all members of pipeline_apply's schedule in this process
    n, rows_mb = PIPE_LOCAL_MEMBERS, rows // PIPE_MICRO
    one = module_stage(pp_stage(model.cfg, 1))
    stacked = stack_stage_params([stage_params(model, [i]) for i in range(n)])
    stacked = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    mb, tb = xs[:, :rows_mb].contiguous(), ts[:, :rows_mb].contiguous()
    fa.reset_launch_counts()
    out = pipeline_apply_local(one, stacked, mb)
    gpipe_loss = sum(loss_fn(out[m], tb[m]) for m in range(M)) / M
    gpipe_grads = torch.autograd.grad(gpipe_loss, list(stacked.values()))
    sync()
    gpipe_launches = fa.launch_counts()
    seq_leaves = {k: v.detach().clone().requires_grad_() for k, v in stacked.items()}
    outs = []
    for m in range(M):
        h = mb[m]
        for i in range(n):
            h = one({k: v[i] for k, v in seq_leaves.items()}, h)
        outs.append(h)
    seq_out = torch.stack(outs)
    seq_loss = sum(loss_fn(seq_out[m], tb[m]) for m in range(M)) / M
    seq_grads = torch.autograd.grad(seq_loss, list(seq_leaves.values()))
    gwant = {"flash_fwd": n * (M + n - 1), "flash_bwd_dq": n * M, "flash_bwd_dkv": n * M}
    gpipe = {"members": n, "microbatches": M, "rows_a_microbatch": rows_mb,
             "forward_bitwise": bool(torch.equal(out, seq_out)),
             "forward_rel_diff": _rel(out.detach().float(), seq_out.detach().float()),
             "loss_diff": abs(float(gpipe_loss) - float(seq_loss)),
             "grad_rel_diff": _rel(torch.cat([g.flatten() for g in gpipe_grads]),
                                   torch.cat([g.flatten() for g in seq_grads])),
             "launches": gpipe_launches, "expected_launches": gwant}
    emit({"phase": "pipeline", "model": "transformer", "config": dict(cfg, seq_len=seq), "dtype": "bfloat16",
          "rows": rows, "stages": P, "blocks_a_stage": PIPE_BLOCKS, "microbatches": M,
          "devices": [device] * P, "loss_tolerance": LM_BF16_LOSS_TOL, "grad_tolerance": LM_BF16_GRAD_TOL,
          "pipeline_1f1b": one_f1b, "pipeline_apply_local": gpipe})
    checks = [
        ("1F1B loss", math.isfinite(loss) and one_f1b["loss_diff"] <= LM_BF16_LOSS_TOL),
        ("1F1B gradients", one_f1b["grad_rel_diff"] <= LM_BF16_GRAD_TOL),
        ("1F1B overlap on/off bitwise", bitwise),
        ("1F1B stash bound", all(s <= P - i for i, s in enumerate(one_f1b["stash_peak"]))),
        ("1F1B bubble in range", all(0.0 <= b <= 1.0 for b in one_f1b["bubble_fraction"].values())),
        ("GPipe forward", gpipe["forward_rel_diff"] <= LM_BF16_GRAD_TOL),
        ("GPipe loss", gpipe["loss_diff"] <= LM_BF16_LOSS_TOL),
        ("GPipe gradients", gpipe["grad_rel_diff"] <= LM_BF16_GRAD_TOL),
    ]
    if cuda:
        checks += [("1F1B launches", launches == want),
                   ("1F1B traced launches", one_f1b["device_launches_traced"] == want),
                   ("GPipe launches", gpipe_launches == gwant)]
    failed = [name for name, ok in checks if not ok]
    if failed:
        raise AssertionError("pipeline failed: {} ({}, {})".format(failed, one_f1b, gpipe))
    return launches, one_f1b["device_launches_traced"], gpipe_launches


def overlap_microbatches(lm_batch, ranks=OVERLAP_RANKS, micro=OVERLAP_MICRO, rows=OVERLAP_ROWS):
    """Each rank's microbatches of the slice's packed rows: microbatch j
    holds rows [j·rows, (j+1)·rows), rolled by the rank along the sequence
    (distinct data a rank)."""
    import numpy as np

    return [[{k: np.roll(np.asarray(v)[j * rows:(j + 1) * rows], r, axis=1) for k, v in lm_batch.items()}
             for j in range(micro)] for r in range(ranks)]


def overlap_child(rank, world, address, in_path, out_path, device="cuda", cfg=None, steps=OVERLAP_STEPS):
    """One rank of the ``overlap`` phase, in a process of its own on the one
    card (``python3 -c 'import chip_smoke; chip_smoke.overlap_child(...)'``):
    ``HostAllReduceGroup`` over loopback at ``address``, an exact mean of
    distinct per-rank payloads, then ``BucketedOverlap`` of the full-width
    LM on this rank's microbatches (``in_path``), overlap on and off from
    the same weights, ``steps`` AdamW steps each; the last "on" step traced
    with ``torch.profiler`` on rank 0. Writes its readings to ``out_path``."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace
    from tensorflowonspark_tpu_torch.parallel import HostAllReduceGroup
    from tensorflowonspark_tpu_torch.train import BucketedOverlap, SyncDataParallel, optim

    cfg = cfg or LM
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.set_device(0)
    host = np.load(in_path)
    micro = sorted({k.split("/")[0] for k in host.files})
    out = {"rank": rank}
    with HostAllReduceGroup(rank, world, root_address=address, timeout=300) as group:
        got = group.allreduce_mean(np.arange(8, dtype=np.float32) + 10.0 * rank)
        want = np.mean([np.arange(8, dtype=np.float32) + 10.0 * r for r in range(world)], axis=0)
        out["reduce_exact"] = bool(np.array_equal(got, want))
        strategy = SyncDataParallel(device)
        mbs = [strategy.shard_batch({k.split("/")[1]: host[k] for k in host.files if k.startswith(j + "/")})
               for j in micro]
        for side in ("on", "off"):  # from the same weights (seed 0)
            model = transformer.create_model(dtype="bfloat16", **cfg)
            loss_fn = transformer.make_loss_fn(model)
            opt = optim.adamw(3e-4)
            state = strategy.create_state(transformer.make_init_fn(model), opt, torch.Generator().manual_seed(0))
            sched = BucketedOverlap(strategy, loss_fn, opt, group=group, has_aux=True, overlap=side == "on")
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            losses, ms, stats = [], [], []
            for i in range(steps):
                sync()
                t0 = time.perf_counter()
                if side == "on" and i == steps - 1 and rank == 0:
                    with KernelTrace() as trace:
                        state, metrics = sched.step(state, mbs)
                    out["device_launches_traced"] = {fn.__name__: trace.readings["launches"][fn.__name__]
                                                     for fn in fa.KERNELS}
                else:
                    state, metrics = sched.step(state, mbs)
                losses.append(float(metrics["loss"]))
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                stats.append(dict(sched.last_stats))
            sched.close()
            out[side] = {"losses": losses, "step_ms": ms, "stats": stats, "launches": fa.launch_counts(),
                         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
            del state, sched, opt, model
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_overlap(torch, fa, here, lm_batch, work, device="cuda", cfg=None):
    """``BucketedOverlap`` over ``HostAllReduceGroup`` on loopback (module
    docstring phase ``overlap``): ``OVERLAP_RANKS`` processes on the one
    card (the group is TCP; NCCL would take no two ranks on one card), each
    ``overlap_child``. Returns the flash wrappers' launches on rank 0's
    "on" run and the card's in its traced step."""
    import statistics

    import numpy as np

    os.makedirs(work, exist_ok=True)
    from tensorflowonspark_tpu_torch import util

    address = "127.0.0.1:{}".format(util.find_free_port("127.0.0.1"))
    procs, outs = [], []
    for r, mbs in enumerate(overlap_microbatches(lm_batch)):
        data = os.path.join(work, "overlap_in_{}.npz".format(r))
        np.savez(data, **{"{}/{}".format(j, k): v for j, mb in enumerate(mbs) for k, v in mb.items()})
        outs.append(os.path.join(work, "overlap_out_{}.json".format(r)))
        code = "import chip_smoke; chip_smoke.overlap_child({}, {}, {!r}, {!r}, {!r}, {!r}, {!r})".format(
            r, OVERLAP_RANKS, address, data, outs[-1], device, cfg)
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=here, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("overlap: ranks exited {}: {}".format(
            [p.returncode for p in procs], [log[-3000:] for log in logs]))
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    timed = lambda ms: ms[1:-1] or ms  # noqa: E731  (the first warms up, the last "on" is traced)
    line = {"phase": "overlap", "model": "transformer",
            "config": dict(cfg or LM, seq_len=int(lm_batch["tokens"].shape[1]) - 1),
            "dtype": "bfloat16", "ranks": OVERLAP_RANKS, "devices": [device] * OVERLAP_RANKS,
            "microbatches": OVERLAP_MICRO, "rows_a_microbatch": OVERLAP_ROWS, "steps": OVERLAP_STEPS,
            "group": "HostAllReduceGroup over loopback TCP",
            "reduce_exact": [r["reduce_exact"] for r in ranks],
            "losses": {side: [r[side]["losses"] for r in ranks] for side in ("on", "off")},
            "step_ms": {side: {"median": statistics.median(timed(r0[side]["step_ms"])),
                               "all": r0[side]["step_ms"]} for side in ("on", "off")},
            "comm_busy_s": {side: r0[side]["stats"][-1]["comm_busy_s"] for side in ("on", "off")},
            "device_wait_s": {side: r0[side]["stats"][-1]["device_wait_s"] for side in ("on", "off")},
            "blocked_s": {side: r0[side]["stats"][-1]["blocked_s"] for side in ("on", "off")},
            "overlap_fraction": {side: [s["overlap_fraction"] for s in r0[side]["stats"]]
                                 for side in ("on", "off")},
            "buckets": r0["on"]["stats"][-1]["buckets"],
            "launches": r0["on"]["launches"], "device_launches_traced": r0["device_launches_traced"],
            "peak_memory_gb_by_rank": [r["on"]["peak_memory_gb"] for r in ranks]}
    emit(line)
    cuda = torch.device(device).type == "cuda"
    per_step = LM["n_layers"] * OVERLAP_MICRO
    on, off = line["losses"]["on"], line["losses"]["off"]
    checks = [
        ("exact mean", all(line["reduce_exact"])),
        ("ranks equal", all(r == on[0] for r in on) and all(r == off[0] for r in off)),
        ("on/off bitwise", on[0] == off[0]),
        ("loss finite and descending", all(math.isfinite(v) for v in on[0]) and on[0][-1] < on[0][0]),
        ("overlap on > 0", line["overlap_fraction"]["on"][-1] > 0.0),
        ("overlap off == 0", all(v == 0.0 for v in line["overlap_fraction"]["off"])),
    ]
    if cuda:
        checks += [("launches", all(line["launches"][fn.__name__] == per_step * OVERLAP_STEPS for fn in fa.KERNELS)),
                   ("traced launches", all(v == per_step for v in line["device_launches_traced"].values()))]
    failed = [name for name, ok in checks if not ok]
    if failed:
        raise AssertionError("overlap failed: {}".format(failed))
    return line["launches"], line["device_launches_traced"]


def phase_loop_cache(torch, fused_bn, resnet, device="cuda", batch=BATCH, image=IMAGE, build=None):
    """``PackedLoopCache`` on the ResNet slice (module docstring phase
    ``loop_cache``): windows of the scripted sizes ``LOOP_CACHE_KS`` from
    ``autotuned_prefetch`` through the cache, against the same windows'
    batches through one captured K = 1 loop. Returns the BN wrappers' launches on
    the cache's run and the card's in its traced K = 4 window."""
    import numpy as np

    from tensorflowonspark_tpu_torch import obs
    from tensorflowonspark_tpu_torch.data import autotune
    from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace
    from tensorflowonspark_tpu_torch.train import PackedLoopCache, SyncDataParallel, optim

    class Scripted(autotune.FeedAutotuner):
        """The controller with its window sizes scripted: ``ks`` in turn."""

        def __init__(self, ks, **kw):
            super().__init__(**kw)
            self._script = iter(ks)

        def decide(self, batch_bytes):
            k = next(self._script)
            self._k = k
            return k, self.depth(k)

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ks = LOOP_CACHE_KS
    rng = np.random.default_rng(7)
    host = [{"image": rng.standard_normal((batch, image, image, 3)).astype(np.float32),
             "label": rng.integers(0, 1000, batch)} for _ in range(sum(ks))]
    build = build or (lambda: resnet.resnet50(dtype=torch.bfloat16, bn_impl="pallas",
                                              generator=torch.Generator().manual_seed(0)))
    loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
    strategy = SyncDataParallel(device)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def run(cached):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        optimizer = optim.sgd(0.1, momentum=0.9)
        state = strategy.create_state(build, optimizer)
        losses, seen, readings = {}, [], None
        if cached:
            cache = PackedLoopCache(strategy, loss_fn, optimizer, mutable=True)
            before = obs.snapshot()["counters"].get("feed_recompiles_total", {"value": 0})["value"]
            fused_bn.reset_launch_counts()
        else:
            loop = strategy.compile_train_loop(loss_fn, optimizer, 1, mutable=True, packed=True)
        t0 = time.perf_counter()
        # both runs take the same windows, so the same input bytes are on the
        # card: the reference feeds each window's batches to one K = 1 loop
        for w in autotune.autotuned_prefetch(iter(host), strategy, tuner=Scripted(ks, buckets=(1, 2, 4))):
            seen.append(w.k)
            if not cached:
                for i in range(w.k):
                    state, metrics = loop(state, {k: v[i:i + 1] for k, v in w.data.items()})
                    losses[state.step] = metrics["loss"].clone()
            elif w.k == max(ks) and readings is None:
                with KernelTrace() as trace:
                    state, metrics = cache.run(state, w)
                readings = trace.readings
            else:
                state, metrics = cache.run(state, w)
            losses[state.step] = metrics["loss"].clone()
        sync()
        out = {"losses": losses, "seen": seen, "step": state.step, "snapshot": _snapshot(torch, state),
               "seconds": time.perf_counter() - t0,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
        if cached:
            out["launches"] = fused_bn.launch_counts()
            out["recompiles"] = obs.snapshot()["counters"]["feed_recompiles_total"]["value"] - before
            out["readings"], out["sizes"] = readings, cache.compiled_sizes
        return out

    try:
        a = run(True)
        b = run(False)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    mismatched = _mismatches(torch, a["snapshot"], b["snapshot"])
    loss_equal = all(torch.equal(v, b["losses"][s]) for s, v in a["losses"].items())
    names = [t[0] for t in KERNEL_TABLE]
    want_calls = 53 * wrapper_calls(sum(ks), 2)  # two eager warm-up steps and the capture
    want_traced = 53 * max(ks)
    line = {"phase": "loop_cache", "model": "resnet50", "dtype": "bfloat16", "bn_impl": "pallas", "batch": batch,
            "image": image, "windows": a["seen"], "compiled_sizes": a["sizes"],
            "feed_recompiles_total": a["recompiles"], "steps": a["step"], "reference_steps": b["step"],
            "tensors": len(a["snapshot"]), "mismatches": mismatched, "window_losses_bitwise": loss_equal,
            "losses": {s: float(v) for s, v in a["losses"].items()},
            "launches": {n: a["launches"][n] for n in names}, "expected_launches": want_calls,
            "device_launches_traced_window": {n: a["readings"]["launches"][n] for n in names} if a["readings"]
            else None, "expected_traced": want_traced,
            "graph_launches_traced_window": a["readings"]["graph_launches"] if a["readings"] else None,
            "seconds": {"cache": a["seconds"], "k1": b["seconds"]},
            "peak_memory_gb": {"cache": a["peak_gb"], "k1": b["peak_gb"]}}
    emit(line)
    checks = [
        ("every batch one step", a["step"] == b["step"] == sum(ks) and a["seen"] == b["seen"] == list(ks)),
        ("bitwise the K=1 loop", not mismatched and loss_equal),
        ("a build a bucket", a["recompiles"] == len(set(ks)) and a["sizes"] == sorted(set(ks))),
    ]
    if cuda:
        checks += [
            ("peak memory within 5%", a["peak_gb"] <= 1.05 * b["peak_gb"]),
            ("launches", all(line["launches"][n] == want_calls for n in names)),
            ("traced launches", all(v == want_traced for v in line["device_launches_traced_window"].values())
             and line["graph_launches_traced_window"] == max(ks)),
        ]
    failed = [name for name, ok in checks if not ok]
    if failed:
        raise AssertionError("loop_cache failed: {}".format(failed))
    return line["launches"], line["device_launches_traced_window"]


def loop_cache_child(out_path):
    """``phase_loop_cache`` in a process of its own (``python3 -c 'import
    chip_smoke; chip_smoke.loop_cache_child(...)'``): its trace of a window
    of graph replays then runs in a fresh process, as the trainers' traced
    calls do. In this long-lived process the profiler lost 1-2 of the
    window's 212 records of a BN kernel in 3 of 3 whole runs (0 of 116
    traced windows in fresh processes). Writes the phase's launch counts to
    ``out_path``."""
    import torch

    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.ops import fused_bn

    launches, traced = phase_loop_cache(torch, fused_bn, resnet)
    with open(out_path, "w") as f:
        json.dump({"launches": launches, "traced": traced}, f)


def phase_loop_cache_child(here, work):
    """``loop_cache_child`` in a fresh interpreter; relays its line (with this
    script's ``t_s``) and returns its launch counts."""
    os.makedirs(work, exist_ok=True)
    out = os.path.join(work, "loop_cache.json")
    done = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.loop_cache_child({!r})".format(out)],
                          cwd=here, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in done.stdout.splitlines() if ln.startswith('{"phase": "loop_cache"')]
    if lines:
        line = json.loads(lines[-1])
        line.pop("t_s", None)
        emit(line)
    if done.returncode != 0 or not lines:
        raise AssertionError("loop_cache: exit {}: {}".format(done.returncode, done.stderr[-4000:]))
    with open(out) as f:
        got = json.load(f)
    return got["launches"], got["traced"]


def _state_host(torch, state):
    """A blocking copy of a TrainState's checkpointed tensors, in the
    layout of a checkpoint file's tree."""
    torch.cuda.synchronize()
    opt = state.opt_state
    return {"step": state.step,
            "params": {k: v.detach().cpu().clone() for k, v in state.params.items()},
            "model_state": {k: v.detach().cpu().clone() for k, v in state.model_state.items()},
            "opt_state": {"count": opt["count"].cpu().clone(),
                          "trace": {k: v.cpu().clone() for k, v in opt["trace"].items()}}}


def _tree_mismatches(torch, got, want, where=""):
    """Paths where two checkpoint trees differ: keys, step, or any tensor
    not bitwise equal."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [where or "/"]
        return [m for k in sorted(want) for m in _tree_mismatches(torch, got[k], want[k], where + "/" + str(k))]
    if isinstance(want, torch.Tensor):
        ok = isinstance(got, torch.Tensor) and got.dtype == want.dtype and torch.equal(got, want)
        return [] if ok else [where]
    return [] if got == want else [where]


def _count_tensors(torch, tree):
    if isinstance(tree, dict):
        return sum(_count_tensors(torch, v) for v in tree.values())
    return int(isinstance(tree, torch.Tensor))


def phase_ckpt_engine(torch, resnet, work):
    """ResNet-50 at the slice's shape in this process, ``compile_train_loop``
    with K = 5 driven by ``run_steps``: runs with an ``AsyncCheckpointEngine``
    (``keep=2``, a save every ``CKPT_EVERY`` calls = every 10 steps) and runs
    without one, alternating, ``CKPT_PAIRS`` pairs, cuDNN deterministic. Step
    ms both ways after the first call (host clock from a sync after one call
    to a sync after the next; in the engine runs the interval holds the
    snapshot queued after the first), the training thread's ms in each
    ``ckpt_snapshot`` span, the writer's seconds per commit, commits and
    supersedes. The ordering check: every committed checkpoint — each one
    hard-linked aside as soon as a sync sees it, before ``keep`` prunes it —
    equals, bitwise, a blocking copy of the engine-less twin's state at the
    same step (taken outside the timed intervals)."""
    import shutil

    import numpy as np

    from tensorflowonspark_tpu_torch import ckpt, obs
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim
    from tensorflowonspark_tpu_torch.train.strategy import run_steps

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    strategy = SyncDataParallel("cuda")
    rng = np.random.default_rng(11)
    windows = [[strategy.shard_batch({
        "image": rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
        "label": rng.integers(0, 1000, BATCH)}) for _ in range(STEPS)] for _ in range(CKPT_CALLS)]
    args = resnet_spark.build_parser().parse_args(["--dataset", "imagenet", "--batch_size", str(BATCH)])
    loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
    counters = ("ckpt_commits_total", "ckpt_superseded_total", "ckpt_write_seconds_total")

    def keep_aside(model_dir, aside):
        """Hard-link every published checkpoint not yet kept aside (no data
        is copied; a later prune leaves the links)."""
        for name in os.listdir(model_dir):
            src, dst = os.path.join(model_dir, name), os.path.join(aside, name)
            if name.startswith("ckpt_") and not os.path.isdir(dst):
                os.makedirs(dst + ".part")
                for f in os.listdir(src):
                    os.link(os.path.join(src, f), os.path.join(dst + ".part", f))
                os.rename(dst + ".part", dst)

    def run(model_dir):
        optimizer = optim.sgd(resnet_spark.lr_schedule(args), momentum=0.9)
        state = strategy.create_state(lambda: resnet.resnet50(
            dtype=torch.bfloat16, bn_impl="pallas", generator=torch.Generator().manual_seed(0)), optimizer)
        loop = strategy.compile_train_loop(loss_fn, optimizer, STEPS, mutable=True)
        ends, starts, copies = [], [], {}
        aside = model_dir and model_dir + "_committed"

        def hook(s, call, metrics):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            if model_dir is None and call % CKPT_EVERY == 0:
                copies[s.step] = _state_host(torch, s)
            if aside:
                keep_aside(model_dir, aside)
            starts.append(time.perf_counter())

        engine = None
        if model_dir:
            os.makedirs(aside)
            engine = ckpt.AsyncCheckpointEngine(model_dir, keep=2, save_every_n=CKPT_EVERY)
        before = {c: obs.counter(c).value for c in counters}
        t0 = time.time()
        run_steps(loop, state, windows, engine=engine, hooks=[hook])
        if engine is not None:
            engine.close()
            keep_aside(model_dir, aside)
        step_ms = [(b - a) / STEPS * 1e3 for a, b in zip(starts[:-1], ends[1:])][1:]  # after call 1
        snaps = [e["dur_s"] * 1e3 for e in obs.get_registry().events()
                 if e.get("span") == "ckpt_snapshot" and e["ts"] >= t0]
        delta = {c: obs.counter(c).value - before[c] for c in counters}
        return step_ms, snaps, delta, copies, aside

    work = os.path.join(work, "engine")
    try:
        shutil.rmtree(work, ignore_errors=True)
        sides = {"engine": [], "none": []}
        twin = None
        for pair in range(CKPT_PAIRS):
            for side in (("engine", "none") if pair % 2 == 0 else ("none", "engine")):
                model_dir = os.path.join(work, "engine_{}".format(pair)) if side == "engine" else None
                torch.cuda.empty_cache()
                step_ms, snaps, delta, copies, aside = run(model_dir)
                sides[side].append({"step_ms": step_ms, "snapshot_ms": snaps, "counters": delta, "aside": aside})
                if side == "none" and twin is None:
                    twin = copies
        checked, bad = [], []
        for r in sides["engine"]:
            for name in sorted(os.listdir(r["aside"])):
                path = os.path.join(r["aside"], name)
                ok, reason = ckpt.verify(path)
                tree = checkpoint.restore_checkpoint(path)
                want = twin.get(tree["step"])
                diff = ["no twin copy"] if want is None else _tree_mismatches(torch, tree, want)
                checked.append({"checkpoint": name, "step": tree["step"], "verify": reason,
                                "mismatches": len(diff)})
                if diff or not ok:
                    bad.append((path, reason, diff[:5]))
        commits = int(sum(r["counters"]["ckpt_commits_total"] for r in sides["engine"]))
        per_side = {side: [v for r in runs for v in r["step_ms"]] for side, runs in sides.items()}
        line = {
            "phase": "ckpt_engine", "model": "resnet50", "dtype": "bfloat16", "bn_impl": "pallas",
            "batch": BATCH, "steps_per_loop": STEPS, "calls": CKPT_CALLS, "pairs": CKPT_PAIRS,
            "save_every_n_calls": CKPT_EVERY, "keep": 2, "cudnn_deterministic": True,
            "step_ms": {side: [[round(v, 4) for v in r["step_ms"]] for r in runs] for side, runs in sides.items()},
            "step_ms_median": {side: float(np.median(v)) for side, v in per_side.items()},
            "snapshot_ms": [[round(v, 3) for v in r["snapshot_ms"]] for r in sides["engine"]],
            "writer_s_per_commit": [r["counters"]["ckpt_write_seconds_total"] / max(1, r["counters"]["ckpt_commits_total"])
                                    for r in sides["engine"]],
            "commits": [r["counters"]["ckpt_commits_total"] for r in sides["engine"]],
            "supersedes": [r["counters"]["ckpt_superseded_total"] for r in sides["engine"]],
            "checked": checked, "tensors": _count_tensors(torch, twin[min(twin)]) if twin else 0,
        }
        emit(line)
        if bad or not checked or len(checked) != commits:
            raise AssertionError("ckpt_engine: {} of {} committed checkpoints ({} commits) differ from the "
                                 "blocking copy at their step or fail verify: {}".format(
                                     len(bad), len(checked), commits, bad))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        torch.cuda.empty_cache()


def _trainer_lives(flight, root):
    """``[(start wall time, records)]`` of the trainer children's flight
    shards under ``root``, oldest first."""
    lives = []
    for shard in flight.list_shards(root):
        records, _ = flight.read_shard(shard)
        meta = [r for r in records if r.get("kind") == "meta"]
        if meta and str(meta[0].get("proc", "")).startswith("trainer-"):
            lives.append((meta[0]["wall"], records))
    return sorted(lives, key=lambda life: life[0])


def _spans(records, name):
    return [r for r in records if r.get("kind") == "span" and r.get("name") == name]


def phase_recover(torch, fused_bn, work):
    """The port's ResNet example at the slice's shape (``--steps_per_loop 5
    --checkpoint_steps 10``, cuDNN deterministic), twice. Run A
    uninterrupted through ``TFCluster.run``; run B through the example's
    ``--auto_recover 1`` (``TFCluster.run_with_recovery``) with a chaos plan
    arming ``node.kill`` on executor 0, once-latched: the latch is held
    until the checkpoint of step ``RECOVER_KILL_STEP`` or later is
    committed (a thread here watches the model directory), so the kill
    lands at the next heartbeat, mid-run, however fast the host. Both runs
    trace into flight shards (``TOS_TRACE_DIR``): the kill, each life's
    ``ckpt_restore`` / ``ckpt_save`` / ``train_step`` spans. Fails unless B
    relaunched once, its second life resumed at a step >= the checkpoint
    that armed the kill, both final checkpoints pass ``manifest.verify``,
    and B's final checkpoint equals
    A's bitwise, tensor for tensor, and in ``step``. Returns each BN
    wrapper's launches in run A (its counts start at 0 in the fresh
    trainer)."""
    import shutil
    import statistics

    from tensorflowonspark_tpu_torch import TFCluster, chaos, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.ckpt import manifest
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
    from tensorflowonspark_tpu_torch.obs import flight
    from tensorflowonspark_tpu_torch.train import checkpoint

    def argv(model_dir):
        return ["--dataset", "imagenet", "--bn_impl", "pallas", "--batch_size", str(BATCH),
                "--train_steps", str(RECOVER_STEPS), "--log_steps", str(STEPS), "--steps_per_loop", str(STEPS),
                "--checkpoint_steps", str(RECOVER_EVERY), "--keep_checkpoints", str(RECOVER_KEEP),
                "--model_dir", model_dir, "--deterministic"]

    dirs = {side: os.path.join(work, "recover_" + side) for side in ("a", "b")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    keys = ("TOS_HEARTBEAT_INTERVAL", "TOS_MONITOR_INTERVAL", flight.TRACE_DIR_ENV)
    saved_env = {k: os.environ.get(k) for k in keys}
    os.environ.update({"TOS_HEARTBEAT_INTERVAL": str(HEARTBEAT_S), "TOS_MONITOR_INTERVAL": "1"})
    try:
        # run A: uninterrupted
        os.environ[flight.TRACE_DIR_ENV] = os.path.join(dirs["a"], "trace")
        model_a = os.path.join(dirs["a"], "model")
        fused_bn.reset_launch_counts()
        t0 = time.perf_counter()
        sc = LocalSparkContext(num_executors=1)
        try:
            cluster = TFCluster.run(sc, resnet_spark.main_fun, resnet_spark.build_parser().parse_args(argv(model_a)),
                                    1, input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
                                    env={util.ENV_PLATFORM: "gpu"})
            if not cluster.wait_for_completion(timeout=900):
                raise TimeoutError("run A did not finish within 900 s")
            metrics = cluster.metrics(include_driver=False)
            cluster.shutdown()
        finally:
            sc.stop()
        wall_a = time.perf_counter() - t0
        launches = {name: int(metrics["counters"].get("fused_bn_{}_launches_total".format(name), {}).get("value", 0))
                    for name, *_ in KERNEL_TABLE}
        lives_a = _trainer_lives(flight, os.path.join(dirs["a"], "trace"))
        if len(lives_a) != 1:
            raise AssertionError("run A: expected one trainer life, found {}".format(len(lives_a)))
        saves_a = _spans(lives_a[0][1], "ckpt_save")

        # run B: killed once, relaunched by run_with_recovery, resumed. The
        # latch exists from the start, which holds the kill back, until the
        # watcher sees a checkpoint of step RECOVER_KILL_STEP or later
        os.environ[flight.TRACE_DIR_ENV] = os.path.join(dirs["b"], "trace")
        model_b = os.path.join(dirs["b"], "model")
        latch = os.path.join(dirs["b"], "killed.latch")
        os.makedirs(dirs["b"])
        with open(latch, "w"):
            pass
        armed, done = {}, threading.Event()

        def arm():
            while not done.wait(0.02):
                steps = [int(d[len("ckpt_"):]) for d in (os.listdir(model_b) if os.path.isdir(model_b) else [])
                         if d.startswith("ckpt_") and d[len("ckpt_"):].isdigit()]
                if steps and max(steps) >= RECOVER_KILL_STEP:
                    armed["step"] = max(steps)
                    os.remove(latch)
                    return

        chaos.install(chaos.ChaosPlan(seed=0).site("node.kill", probability=1.0, max_count=1, victim=0,
                                                   once_path=latch))
        watcher = threading.Thread(target=arm, name="recover-arm", daemon=True)
        t0 = time.perf_counter()
        sc = LocalSparkContext(num_executors=1)
        watcher.start()
        try:
            relaunches = resnet_spark.main(argv(model_b) + ["--auto_recover", "1"], sc=sc)
        finally:
            done.set()
            watcher.join()
            sc.stop()
            chaos.uninstall()
        wall_b = time.perf_counter() - t0
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    lives_b = _trainer_lives(flight, os.path.join(dirs["b"], "trace"))
    kills = [r for _, recs in lives_b for r in _spans(recs, "chaos_fault")
             if r.get("attrs", {}).get("site") == "node.kill"]
    kill_ts = kills[0]["ts"] if len(kills) == 1 else None
    second = [recs for start, recs in lives_b if kill_ts is not None and start > kill_ts]
    restores = _spans(second[0], "ckpt_restore") if len(second) == 1 else []
    resumed = restores[0]["attrs"].get("step") if restores else None
    calls_b2 = sorted(_spans(second[0], "train_step"), key=lambda r: r["ts"]) if len(second) == 1 else []
    final = "ckpt_{}".format(RECOVER_STEPS)
    paths = {side: os.path.join(model, final) for side, model in (("a", model_a), ("b", model_b))}
    verified = {side: manifest.verify(path) if os.path.isdir(path) else (False, "absent")
                for side, path in paths.items()}
    trees = {side: checkpoint.restore_checkpoint(path) for side, path in paths.items() if verified[side][0]}
    diff = _tree_mismatches(torch, trees["b"], trees["a"]) if len(trees) == 2 else ["a final checkpoint is missing"]
    saves_b = [r for _, recs in lives_b for r in _spans(recs, "ckpt_save")]
    line = {
        "phase": "recover", "model": "resnet50", "dtype": "bfloat16", "bn_impl": "pallas", "batch": BATCH,
        "image": IMAGE, "steps": RECOVER_STEPS, "steps_per_loop": STEPS, "checkpoint_steps": RECOVER_EVERY,
        "keep_checkpoints": RECOVER_KEEP, "cudnn_deterministic": True, "heartbeat_s": HEARTBEAT_S,
        "kill_armed_at_checkpoint": armed.get("step"), "relaunches": relaunches, "kills": len(kills),
        "lives": len(lives_b),
        "resumed_at_step": resumed,
        "checkpoint_bytes": sum(os.path.getsize(os.path.join(paths["a"], n)) for n in os.listdir(paths["a"]))
        if os.path.isdir(paths["a"]) else None,
        "save_s_median": {"a": statistics.median(r["dur_s"] for r in saves_a),
                          "b": statistics.median(r["dur_s"] for r in saves_b) if saves_b else None},
        "saves": {"a": len(saves_a), "b": len(saves_b)},
        "restore_s": restores[0]["dur_s"] if restores else None,
        "kill_to_first_step_s": (calls_b2[0]["ts"] + calls_b2[0]["dur_s"] - kill_ts) if calls_b2 else None,
        "second_life_first_call_s": calls_b2[0]["dur_s"] if calls_b2 else None,
        "wall_s": {"a": wall_a, "b": wall_b},
        "manifest_verify": {side: v[1] for side, v in verified.items()},
        "tensors": _count_tensors(torch, trees.get("a", {})), "final_mismatches": diff[:10],
        "launches_run_a": launches,
    }
    emit(line)
    if relaunches != 1 or len(kills) != 1 or len(second) != 1:
        raise AssertionError("recover: {} relaunch(es), {} kill(s), {} life after the kill (want 1 each)".format(
            relaunches, len(kills), len(second)))
    if resumed is None or resumed < max(RECOVER_EVERY, armed.get("step", 0)):
        raise AssertionError("recover: the second life resumed at step {}, not from a checkpoint at or past the "
                             "kill's ({})".format(resumed, armed.get("step")))
    if not all(v[0] and v[1] == "verified" for v in verified.values()):
        raise AssertionError("recover: final checkpoints fail verify: {}".format(verified))
    if diff:
        raise AssertionError("recover: the resumed run's final checkpoint differs from the uninterrupted "
                             "run's in {} place(s): {}".format(len(diff), diff[:10]))
    want = 53 * wrapper_calls(RECOVER_STEPS, STEPS)
    if any(v != want for v in launches.values()):
        raise AssertionError("recover: run A's BN wrapper launches {} != {}".format(launches, want))
    return launches


def phase_ladder(torch, fused_bn, work, run_a):
    """The recovery ladder on the card: the ResNet example at the recover
    phase's arguments on two executors that share the card (no world: one
    card holds one NCCL rank), through ``elastic.run_ladder``, with the story
    of the JAX package's ``test_preempt_drain_regrow_full_size_resume``
    (``cluster_check.run_ladder_story``, its map function
    ``cluster_check.resnet_ladder_fun``): a latched ``node.kill`` of
    executor 1 armed once executor 0's checkpoint of step
    ``LADDER_KILL_STEP`` or later is committed; ``blacklist_after=1``, so
    the ladder shrinks to 1; the mid-run regrow probe forgives executor 1,
    the scaler votes to grow and executor 0 drains on the preemption
    warning; the relaunch runs at 2. Fails unless the relaunches, blacklist
    and sizes (2 → 1 → 2) are the reference's, one shrink, one regrow and
    one drained preemption are counted, every life's child ran on ``cuda``
    and the BN wrappers launched in the last life, executor 0 resumed each
    life at or after its last committed checkpoint, and its final
    checkpoint equals the recover phase's run A (``run_a``) bitwise and in
    ``step``. Returns each BN wrapper's launches in the last life."""
    import shutil

    from tensorflowonspark_tpu_torch.examples import cluster_check
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
    from tensorflowonspark_tpu_torch.train import checkpoint

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    args = resnet_spark.build_parser().parse_args([
        "--dataset", "imagenet", "--bn_impl", "pallas", "--batch_size", str(BATCH), "--train_steps",
        str(RECOVER_STEPS), "--log_steps", str(STEPS), "--steps_per_loop", str(STEPS), "--checkpoint_steps",
        str(RECOVER_EVERY), "--keep_checkpoints", str(RECOVER_KEEP), "--model_dir", work, "--deterministic"])
    args.ladder_root, args.ladder_size, args.ladder_pause = work, LADDER_SIZE, LADDER_PAUSE
    keeper = os.path.join(work, "executor_0")
    story = cluster_check.run_ladder_story(
        cluster_check.resnet_ladder_fun, args, work, LADDER_SIZE, 1, keeper, LADDER_KILL_STEP, "gpu",
        jax_distributed=False, master_node=None, regrow_s=LADDER_REGROW_S, task_timeout=300)
    result, lives, armed = story["result"], story["lives"], story["armed"]
    sizes = [life[0]["size"] for life in lives]
    cards = [{r["executor_id"]: {"card": r["card"], "device": r["device"]} for r in life} for life in lives]
    # executor 0 is worker:0 in every life: its shards, the kill, its restores and saves
    shards = story["shards"]
    keeper_lives = [recs for _, recs in shards if any(
        r.get("kind") == "meta" and str(r.get("proc", "")).endswith("worker-0") for r in recs)]
    kills = [r for _, recs in shards for r in _spans(recs, "chaos_fault")
             if r.get("attrs", {}).get("site") == "node.kill"]
    resumed, committed, last_saved = [], [], 0
    for recs in keeper_lives:
        restores = _spans(recs, "ckpt_restore")
        resumed.append(restores[0]["attrs"].get("step") if restores else None)
        committed.append(last_saved)
        last_saved = max([last_saved] + [r["attrs"].get("step", 0) for r in _spans(recs, "ckpt_save")])
    after_kill = [recs for recs in keeper_lives if kills and min(
        r["ts"] for r in recs if r.get("kind") in ("span", "event")) > kills[0]["ts"]]
    calls = sorted(_spans(after_kill[0], "train_step"), key=lambda r: r["ts"]) if after_kill else []
    drains = [(e["ts"], d["ts"]) for recs in keeper_lives
              for e in recs if e.get("kind") == "event" and e.get("name") == "preempt_drain"
              for d in recs if d.get("kind") == "dump" and str(d.get("reason", "")).startswith("preempted")]
    drained_at = next((t for t, kind in story["classified"] if kind == "preemption"), None)
    node_counters = (result.metrics or {}).get("counters", {})
    launches = {name: int((node_counters.get("fused_bn_{}_launches_total".format(name)) or {}).get("value", 0))
                for name, *_ in KERNEL_TABLE}
    final = os.path.join(keeper, "ckpt_{}".format(RECOVER_STEPS))
    trees = [checkpoint.restore_checkpoint(p) for p in (final, run_a) if os.path.isdir(p)]
    diff = _tree_mismatches(torch, trees[0], trees[1]) if len(trees) == 2 else ["a final checkpoint is missing"]
    line = {"phase": "ladder", "model": "resnet50", "dtype": "bfloat16", "bn_impl": "pallas", "batch": BATCH,
            "image": IMAGE, "steps": RECOVER_STEPS, "steps_per_loop": STEPS, "checkpoint_steps": RECOVER_EVERY,
            "executors": LADDER_SIZE, "heartbeat_s": cluster_check.HEARTBEAT_S, "regrow_check_s": LADDER_REGROW_S,
            "kill_armed_at_checkpoint": armed.get("step"), "kills": len(kills), "relaunches": result.relaunches,
            "blacklist": sorted(result.blacklist), "final_size": result.num_executors, "sizes": sizes,
            "events": [e.kind for _, e in result.events], "counters": story["counters"], "cards": cards,
            "exits_by_life": story["exits"], "executor0_resumed_at": resumed, "executor0_committed_before": committed,
            "kill_to_first_step_s": calls[0]["ts"] + calls[0]["dur_s"] - kills[0]["ts"] if calls else None,
            "drain_s": [b - a for a, b in drains],
            "preempt_to_classified_s": drained_at - story["preempts"][0] if drained_at and story["preempts"]
            else None,
            "launches_last_life": launches, "final_mismatches_vs_recover_run_a": diff[:10],
            "tensors": _count_tensors(torch, trees[0]) if trees else 0, "wall_s": story["wall_s"]}
    emit(line)
    failures = cluster_check.story_failures("ladder", story, LADDER_SIZE)
    if failures:
        raise AssertionError("; ".join(failures))
    if any(r["device"].split(":")[0] != "cuda" for life in lives for r in life):
        raise AssertionError("ladder: a life's child did not run on the card: {}".format(cards))
    if len(resumed) != 3 or any(r is None or r < c for r, c in zip(resumed[1:], committed[1:])):
        raise AssertionError("ladder: executor 0 resumed at {} with {} committed before".format(resumed, committed))
    if diff:
        raise AssertionError("ladder: executor 0's final checkpoint differs from recover's run A in {} place(s): "
                             "{}".format(len(diff), diff[:10]))
    if any(v == 0 for v in launches.values()):
        raise AssertionError("ladder: a BN wrapper did not launch in the last life: {}".format(launches))
    return launches


#: the MNIST phases: the example's batch, one epoch of half of MNIST's train
#: split (synthetic rows; cut from 60,000 to keep the script inside its
#: time) in 8 partitions, a checkpoint every MNIST_CKPT steps; the
#: pipeline trains on MNIST_PIPELINE rows and transforms MNIST_TEST of them,
#: TFParallel predicts MNIST_TEST rows of the inference example's own
MNIST_BATCH, MNIST_EXAMPLES, MNIST_PARTITIONS, MNIST_CKPT = 64, 30000, 8, 250
MNIST_PIPELINE, MNIST_TEST = 10000, 2048
#: the device the MNIST phases run on, and report, on the card
MNIST_DEVICE = "cuda:0"
#: the card against the CPU, float32 with TF32 off: logits, loss, each
#: gradient tensor and the parameters after one Adam step, each as
#: ||card - cpu|| / ||cpu|| (all the parameters as one vector, against their
#: starting values: the biases start at 0)
MNIST_REL_TOL = 1e-4


#: the spark_recover phase's feed waves' timeout (seconds)
SPARK_RECOVER_FEED_TIMEOUT = 30


def phase_spark_recover(work):
    """The JAX package's ``test_spark_feed_killed_node_training_finishes_anyway``
    on the card (``cluster_check.spark_feed_story``): two executors share
    ``cuda:0`` as independent workers, fed in waves of
    ``SPARK_RECOVER_FEED_TIMEOUT``; executor 1 SIGKILLs its trainer at step 5
    (after ``ckpt_4``), the feed task bound for it surfaces the loss at its
    timeout, and ``TFCluster.run_with_recovery`` relaunches both, which
    resume from their own checkpoints. Fails unless there was one relaunch
    and two feed passes, both workers ended at step 8 on ``cuda:0`` and the
    victim's checkpoints are ``ckpt_2, 4, 6, 8``."""
    from tensorflowonspark_tpu_torch.examples import cluster_check

    story = cluster_check.spark_feed_story(work, "gpu", SPARK_RECOVER_FEED_TIMEOUT)
    failures = cluster_check.spark_feed_failures("spark_recover", story)
    devices = {eid: d.get("device") for eid, d in story["done"].items()}
    if any(d != "cuda:0" for d in devices.values()):
        failures.append("spark_recover: the workers ran on {}".format(devices))
    emit({"phase": "spark_recover", "model": "mnist_mlp", "width": [784, cluster_check.SPARK_FEED_MLP["hidden"], 10],
          "input_mode": "SPARK", "executors": 2, "feed_timeout_s": SPARK_RECOVER_FEED_TIMEOUT,
          "target_steps": cluster_check.SPARK_FEED_TARGET, "kill_at": cluster_check.SPARK_FEED_KILL_AT,
          "relaunches": story["relaunches"], "feed_passes": story["feeds"],
          "final_steps": {eid: d["final_step"] for eid, d in story["done"].items()}, "devices": devices,
          "victim_ckpts": story["victim_ckpts"], "wall_s": story["wall_s"], "failures": failures})
    if failures:
        raise AssertionError("; ".join(failures))


def timed(name, phase, *args):
    """Run ``phase(*args)``, print its seconds as ``<name>_seconds``, return
    its result."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit({"phase": name + "_seconds", "seconds": time.perf_counter() - t0})
    return out


def _mnist_run(torch, mnist, kind, device, batch, fault=None):
    """One Adam step of an MNIST model (weights seed 0) through
    ``SyncDataParallel`` on ``device``: eval logits before it, the loss,
    each parameter's gradient and value after it (host tensors). The MLP
    trains through the example's loss at dropout 0, the CNN (dropout fixed
    at 0.5) through the eval-mode loss: the two devices' generators draw
    different masks. ``fault`` (a parameter name) scales that gradient by
    1.01 before the update."""
    import torch.nn.functional as F

    cfg = {"dropout_rate": 0.0} if kind == "mlp" else {}
    model = mnist.create_model(kind, generator=torch.Generator().manual_seed(0), **cfg)
    if kind == "mlp":
        loss_fn = mnist.make_loss_fn(model)
    else:
        def loss_fn(module, b):
            return F.cross_entropy(module(b["image"], train=False), b["label"].long()), {}
    return _adam_step(torch, model, loss_fn, device, batch, fault)


def _adam_step(torch, model, loss_fn, device, batch, fault=None):
    """One Adam 1e-3 step of ``model`` (``loss_fn`` with aux metrics)
    through ``SyncDataParallel`` on ``device``: eval logits before it, the
    loss, each parameter's gradient and value after it (host tensors).
    ``fault`` (a parameter name) scales that gradient by 1.01 before the
    update."""
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    strategy = SyncDataParallel(device)
    opt = optim.adam(1e-3)
    if fault is not None:
        real = opt.update

        def update(params, grads, state):
            grads[fault].mul_(1.01)
            return real(params, grads, state)

        opt.update = update
    state = strategy.create_state(lambda: model, opt)
    placed = strategy.shard_batch(batch)
    with torch.no_grad():
        logits = state.module(placed["image"]).cpu()
    step = strategy.compile_train_step(loss_fn, opt, has_aux=True)
    state, metrics = step(state, placed)
    return {"logits": logits, "loss": float(metrics["loss"]),
            "grads": {n: p.grad.detach().cpu() for n, p in state.module.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in state.module.named_parameters()}}


def phase_mnist_compare(torch):
    """``MnistMLP`` and ``MnistCNN`` at full width: logits and one Adam step
    on the card against the same on the CPU, from the same weights and 64
    rows of the examples' data, float32 with TF32 off, each within
    ``MNIST_REL_TOL``; then a 1% fault in one gradient on the card, which
    the gradient limit must catch (Adam's first step hardly moves with it:
    g/(|g| + eps) is about sign(g))."""
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist
    from tensorflowonspark_tpu_torch.models import mnist

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, labels = synthetic_mnist(MNIST_BATCH)
    batch = {"image": images, "label": labels}
    start = {kind: dict(mnist.create_model(kind, generator=torch.Generator().manual_seed(0)).named_parameters())
             for kind in ("mlp", "cnn")}
    for kind in ("mlp", "cnn"):
        line = _card_vs_cpu(torch, lambda device, fault=None: _mnist_run(torch, mnist, kind, device, batch, fault),
                            start[kind])
        line = {"phase": "mnist_compare", "model": kind, "dtype": "float32", "tf32": False,
                "batch": MNIST_BATCH, **line, "seconds": time.perf_counter() - t0}
        _check_card_vs_cpu(line)


def _card_vs_cpu(torch, run, start):
    """``run(device, fault=None)`` (one Adam step, :func:`_adam_step`'s
    result) on the card and on the CPU, then on the card with a 1% fault
    in the CPU's largest gradient: each difference as ``||card - cpu|| /
    ||cpu||`` (all the parameters as one vector, against their values in
    ``start``: biases start at 0)."""
    card = run(MNIST_DEVICE)
    cpu = run("cpu")
    grad_rel = {n: _rel(card["grads"][n], g) for n, g in cpu["grads"].items()}
    flat = lambda tree: torch.cat([tree[n].detach().flatten() for n in sorted(tree)])  # noqa: E731
    fault = max(cpu["grads"], key=lambda n: cpu["grads"][n].norm())
    faulted = run(MNIST_DEVICE, fault=fault)
    return {"params": sum(p.numel() for p in cpu["params"].values()),
            "logits_rel": _rel(card["logits"], cpu["logits"]),
            "loss_card": card["loss"], "loss_cpu": cpu["loss"],
            "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
            "grad_rel_max": max(grad_rel.values()),
            "param_rel_to_start": float((flat(card["params"]) - flat(cpu["params"])).norm() / flat(start).norm()),
            "tolerance": MNIST_REL_TOL, "fault": "{} gradient x 1.01".format(fault),
            "fault_grad_rel": _rel(faulted["grads"][fault], cpu["grads"][fault]),
            "fault_param_rel_to_start": float((flat(faulted["params"]) - flat(cpu["params"])).norm()
                                              / flat(start).norm())}


def _check_card_vs_cpu(line):
    """Print ``line`` (:func:`_card_vs_cpu`'s readings); fail unless the
    card is within ``MNIST_REL_TOL`` of the CPU and the fault is not."""
    emit(line)
    name = "{} {}".format(line["phase"], line["model"])
    worst = max(line["logits_rel"], line["loss_rel"], line["grad_rel_max"], line["param_rel_to_start"])
    if not (math.isfinite(line["loss_card"]) and worst <= MNIST_REL_TOL):
        raise AssertionError("{}: card vs CPU {} beyond {}: {}".format(name, worst, MNIST_REL_TOL, line))
    if not line["fault_grad_rel"] > MNIST_REL_TOL:
        raise AssertionError("{}: a 1% fault in {} reads {}, within the limit {}".format(
            name, line["fault"], line["fault_grad_rel"], MNIST_REL_TOL))


def phase_slice_mnist(torch, work):
    """The port's InputMode.SPARK path: ``mnist_spark.main`` through
    ``TFCluster.run`` on one executor and the card, one epoch of
    ``MNIST_EXAMPLES`` synthetic rows in ``MNIST_PARTITIONS`` partitions,
    batch ``MNIST_BATCH``, with ``--model_dir`` and ``--export_dir``. The
    trainer stops at the example's 90% cap (``steps_per_worker``) and ends
    the feed; the rows it took off the feed are the rows it trained on.
    Returns the bundle's directory and each kernel wrapper's launches in
    the trainer (the MNIST models call none)."""
    import shutil

    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_spark
    from tensorflowonspark_tpu_torch.train import steps_per_worker

    model_dir, export_dir = os.path.join(work, "model"), os.path.join(work, "bundle")
    for d in (model_dir, export_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        out = mnist_spark.main([
            "--cluster_size", "1", "--epochs", "1", "--num_examples", str(MNIST_EXAMPLES),
            "--batch_size", str(MNIST_BATCH), "--num_partitions", str(MNIST_PARTITIONS),
            "--checkpoint_steps", str(MNIST_CKPT), "--log_steps", "200",
            "--model_dir", model_dir, "--export_dir", export_dir], sc=sc)
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    metrics = out["metrics"]
    (span,) = [e for e in metrics["events"] if e.get("span") == "mnist_train"]
    counters = {k: v["value"] for k, v in metrics["counters"].items()}
    launches = {fn: int(counters.get(fn + "_launches_total", -1))
                for fn in [t[0] for t in KERNEL_TABLE] + [t[0] for t in FLASH_TABLE]}
    cap = steps_per_worker(MNIST_EXAMPLES, MNIST_BATCH, 1)
    line = {"phase": "slice_mnist", "model": "mnist_mlp", "hidden": 512, "dtype": "float32",
            "input_mode": "SPARK", "batch": MNIST_BATCH, "examples": MNIST_EXAMPLES, "epochs": 1,
            "partitions": MNIST_PARTITIONS, "executors": 1, "device": span["device"],
            "rows_fed": int(counters.get("feed_rows_total", 0)),
            "feed_chunks": int(counters.get("feed_chunks_total", 0)),
            "rows_taken_off_the_feed": int(counters.get("train_rows_total", 0)),
            "rows_trained": span["steps"] * MNIST_BATCH, "steps": span["steps"], "step_cap": cap,
            "epoch_s": out["train_s"], "epoch_images_per_sec": span["rows"] / out["train_s"],
            "trainer_s": span["train_s"], "trainer_images_per_sec": span["images_per_sec"],
            "trainer_host_s": {k: span[k] for k in ("feed_s", "batch_s", "step_s")},
            "first_loss": span["first_loss"], "last_loss": span["last_loss"],
            "checkpoints": sorted(os.listdir(model_dir)) if os.path.isdir(model_dir) else [],
            "bundle": sorted(os.listdir(export_dir)) if os.path.isdir(export_dir) else [],
            "launches": launches, "wall_s": wall}
    emit(line)
    want_ckpts = ["ckpt_{}".format(s) for s in range(MNIST_CKPT, cap + 1, MNIST_CKPT)]
    if not (line["device"] == MNIST_DEVICE and span["steps"] == cap
            and line["rows_taken_off_the_feed"] == line["rows_trained"] == span["rows"]
            and line["rows_fed"] >= line["rows_trained"]):
        raise AssertionError("slice_mnist: steps {} (cap {}), rows fed {}, taken {}, trained {} on {}".format(
            span["steps"], cap, line["rows_fed"], line["rows_taken_off_the_feed"], line["rows_trained"],
            line["device"]))
    if not (math.isfinite(span["first_loss"]) and math.isfinite(span["last_loss"])
            and span["last_loss"] < span["first_loss"]):
        raise AssertionError("slice_mnist: loss {} -> {} is not finite and falling".format(
            span["first_loss"], span["last_loss"]))
    if line["checkpoints"] != sorted(want_ckpts) or line["bundle"] != ["predict_builder.pkl", "weights.npz"]:
        raise AssertionError("slice_mnist: checkpoints {} (want {}), bundle {}".format(
            line["checkpoints"], want_ckpts, line["bundle"]))
    if any(launches.values()):
        raise AssertionError("slice_mnist: kernel launches {} on the MNIST path".format(launches))
    return export_dir, launches


#: the chaos_cluster phase's rows (one epoch)
CHAOS_ROWS = 3000


def phase_chaos_cluster(torch, work):
    """The JAX package's cluster chaos on the card, in one trainer life:
    ``cluster_check.mnist_spark_story`` with the tear (the async engine's
    torn second commit, then the Spark feed of ``mnist_spark`` under the
    cluster chaos plan) on one executor, and the driver's resume. Fails on
    any of its checks."""
    from tensorflowonspark_tpu_torch.examples import cluster_check

    story = cluster_check.mnist_spark_story(work, "chaos_cluster", 1, CHAOS_ROWS, 1, MNIST_BATCH, "gpu", tear=True)
    failures = cluster_check.mnist_story_failures("chaos_cluster", story, 1, MNIST_BATCH, "gpu")
    failures += cluster_check.tear_failures("chaos_cluster", story["tear"], "gpu")
    (span,) = story["spans"] or [{}]
    counters = story["counters"]
    emit({"phase": "chaos_cluster", "model": "mnist_mlp", "input_mode": "SPARK", "rows": CHAOS_ROWS,
          "batch": MNIST_BATCH, "partitions": [len(p) for p in story["parts"]], "device": span.get("device"),
          "steps": span.get("steps"), "step_cap": story["steps"],
          "rows_fed": counters.get("feed_rows_total"), "rows_trained": counters.get("train_rows_total"),
          "rows_per_sec": span.get("images_per_sec"), "faults": story["faults"], "tear": story["tear"],
          "train_s": story["train_s"], "shutdown_s": story["shutdown_s"], "wall_s": story["wall_s"],
          "failures": failures})
    if failures:
        raise AssertionError("chaos_cluster: {}".format(failures))


def _direct_predict(predict_fn, params, model_state, images, batch_size):
    """The bundle's ``predict_fn`` in this process, in the batches of the
    caller it is held against (a short last batch padded with its last row,
    as ``TFModel.transform`` pads it)."""
    import numpy as np

    preds, devices = [], set()
    for lo in range(0, len(images), batch_size):
        chunk = images[lo:lo + batch_size].reshape(-1, 28 * 28)
        n = len(chunk)
        if n < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - n, axis=0)])
        out = predict_fn(params, model_state, {"image": chunk})
        preds.extend(np.asarray(out["prediction"])[:n].tolist())
        devices.update(np.asarray(out["device"]).tolist())
    return preds, devices


def phase_pipeline_mnist(torch, work):
    """``mnist_pipeline.main`` on the card: ``TFEstimator.fit`` (one
    executor, InputMode.SPARK) exports a bundle, then ``TFModel.transform``
    predicts ``MNIST_TEST`` rows inside the executor, whose rows report the
    device they ran on. The predictions must equal, row for row, the
    bundle's ``predict_fn`` run in this process on the card."""
    import shutil

    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_pipeline
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist
    from tensorflowonspark_tpu_torch.train import export

    export_dir = os.path.join(work, "pipeline_bundle")
    shutil.rmtree(export_dir, ignore_errors=True)
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        preds, labels, devices = mnist_pipeline.main([
            "--cluster_size", "1", "--epochs", "1", "--num_examples", str(MNIST_PIPELINE),
            "--batch_size", str(MNIST_BATCH), "--num_test", str(MNIST_TEST), "--export_dir", export_dir], sc=sc)
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    predict_fn, params, model_state = export.load_model(export_dir)  # on the card
    images, _ = synthetic_mnist(MNIST_PIPELINE)
    t1 = time.perf_counter()
    direct, direct_devices = _direct_predict(predict_fn, params, model_state, images[:MNIST_TEST], MNIST_BATCH)
    mismatches = sum(a != b for a, b in zip(preds, direct))
    line = {"phase": "pipeline_mnist", "train_rows": MNIST_PIPELINE, "batch": MNIST_BATCH,
            "transform_rows": len(preds), "executor_devices": sorted(set(devices)),
            "direct_devices": sorted(direct_devices), "mismatches": mismatches,
            "accuracy": sum(int(p == y) for p, y in zip(preds, labels)) / max(len(preds), 1),
            "direct_predict_s": time.perf_counter() - t1, "wall_s": wall}
    emit(line)
    if len(preds) != MNIST_TEST or mismatches or set(devices) != {MNIST_DEVICE} or direct_devices != {MNIST_DEVICE}:
        raise AssertionError("pipeline_mnist: {} rows, {} differ from the direct predict, executor devices {}, "
                             "direct {}".format(len(preds), mismatches, set(devices), direct_devices))


def phase_parallel_mnist(torch, bundle):
    """``mnist_inference.main`` through TFParallel, one instance on the
    card, over ``slice_mnist``'s bundle: its part file must give, row for
    row, the predictions of the bundle's ``predict_fn`` run in this
    process on the card, and so the same correct count."""
    import shutil

    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_inference
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist
    from tensorflowonspark_tpu_torch.train import export

    output = os.path.join(os.path.dirname(bundle), "parallel_out")
    shutil.rmtree(output, ignore_errors=True)
    batch_size = 256  # the example's default
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        done = mnist_inference.main(["--cluster_size", "1", "--num_examples", str(MNIST_TEST),
                                     "--batch_size", str(batch_size), "--export_dir", bundle,
                                     "--output", output], sc=sc)
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    pairs = mnist_inference.read_parts(output)
    predict_fn, params, model_state = export.load_model(bundle)  # on the card
    images, labels = synthetic_mnist(MNIST_TEST, seed=99)
    direct, direct_devices = _direct_predict(predict_fn, params, model_state, images, batch_size)
    line = {"phase": "parallel_mnist", "instances": len(done), "rows": len(pairs),
            "correct": sum(int(y == p) for y, p in pairs),
            "correct_direct": sum(int(y == p) for y, p in zip(labels.tolist(), direct)),
            "mismatches": sum(a != b for a, b in zip(pairs, zip(labels.tolist(), direct))),
            "direct_devices": sorted(direct_devices), "wall_s": wall}
    emit(line)
    if done != [0] or len(pairs) != MNIST_TEST or line["mismatches"] or line["correct"] != line["correct_direct"]:
        raise AssertionError("parallel_mnist: {}".format(line))


#: the real-data slice: ImageNet-schema JPEG shards (uniform random pixels,
#: PIL quality 90) written by the port's resnet_data_setup.py, and the
#: train legs of ``--steps_per_loop 5`` over them, one a decode mode
REAL_TRAIN, REAL_EVAL, REAL_SIZE, REAL_SHARDS = 2048, 512, 256, 8
REAL_STEPS, REAL_THREADS = 60, 8
#: records of the first train shard decoded natively and by PIL, train and
#: eval parse each, in ``data_setup``: the pixels must be equal
NATIVE_CHECK = 64
#: the input-path-only legs: batches drawn from the pipeline with no
#: training (timed after the first), in a spawned process
INPUT_BATCHES = 32
#: one decode worker killed in the decode-plane leg (the first round of the
#: plane: the trainer has CUDA up by then, so the respawn forks from it)
DECODE_KILL = {"seed": 0, "sites": {"data.decode_kill": {"probability": 1.0, "max_count": 1}}}
#: the pack-plane leg of the LM: forked pack workers, eager steps
LM_PACK_WORKERS, LM_PACK_STEPS = 2, 10


def usable_cores():
    return len(os.sched_getaffinity(0))


def decode_plane_workers():
    """The decode-plane leg's workers: the usable cores less two (the
    trainer's own thread and the producer), at least 1, at most 16."""
    return max(1, min(16, usable_cores() - 2))


def phase_data_setup(work):
    """Shards for the real-data slice through the port's data set-up tool:
    ``REAL_TRAIN`` train and ``REAL_EVAL`` eval JPEG Examples of
    ``REAL_SIZE``² pixels. Returns (train dir, eval dir)."""
    import itertools
    import shutil

    import numpy as np
    import PIL

    from tensorflowonspark_tpu_torch import native_io
    from tensorflowonspark_tpu_torch import tfrecord as tfr
    from tensorflowonspark_tpu_torch.data import imagenet
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_data_setup

    train_dir, eval_dir = os.path.join(work, "train"), os.path.join(work, "eval")
    t0 = time.perf_counter()
    for d, n, shards, seed in ((train_dir, REAL_TRAIN, REAL_SHARDS, 0), (eval_dir, REAL_EVAL, 2, 1)):
        shutil.rmtree(d, ignore_errors=True)
        resnet_data_setup.main(["--dataset", "imagenet", "--image_size", str(REAL_SIZE),
                                "--num_examples", str(n), "--num_shards", str(shards),
                                "--output", d, "--seed", str(seed)])
    files = tfr.list_shards(train_dir)
    # this host's native decoder against its PIL, record for record, on the
    # trainer's parse (train crops and flips) and the eval parse
    same = checked = 0
    records = tfr.read_records(files[0])
    for training in (True, False):
        parse = imagenet.make_parse_fn(training, image_size=IMAGE, seed=0, raw_uint8=True)
        for rec in itertools.islice(records, NATIVE_CHECK):
            want, want_label = parse(rec)
            out = np.empty_like(want)
            label, used_native = parse.into(rec, out)
            same += bool(used_native and label == want_label and np.array_equal(out, want))
            checked += 1
    line = {"phase": "data_setup", "train": REAL_TRAIN, "eval": REAL_EVAL, "image": REAL_SIZE,
            "quality": 90, "train_shards": len(files), "eval_shards": len(tfr.list_shards(eval_dir)),
            "train_bytes": sum(os.path.getsize(f) for f in files),
            "native_build": native_io.build_info(), "pil": PIL.__version__,
            "native_equals_pil": "{} of {}".format(same, checked), "seconds": time.perf_counter() - t0}
    emit(line)
    if line["train_shards"] != REAL_SHARDS or line["native_build"] is None or same != checked:
        raise AssertionError("data_setup: {} shards, native build {}, native = PIL in {} of {}".format(
            line["train_shards"], line["native_build"], same, checked))
    return train_dir, eval_dir


def _input_rate(here, train_dir, env, batches, epochs):
    """The input path alone (no training), in a fresh spawned process: the
    trainer's pipeline on the same shards, decode mode from ``env``;
    images/s over the batches after the first, and the stall counters."""
    sys.path.insert(0, here)
    os.environ.update(env)
    from tensorflowonspark_tpu_torch import obs
    from tensorflowonspark_tpu_torch import tfrecord as tfr
    from tensorflowonspark_tpu_torch.data import ImagePipeline, imagenet

    parse = imagenet.make_parse_fn(True, image_size=IMAGE, seed=0, raw_uint8=True)
    stream = iter(ImagePipeline(tfr.list_shards(train_dir), parse, BATCH, seed=0, epochs=epochs,
                                num_threads=REAL_THREADS))
    next(stream)
    t0, n = time.perf_counter(), 0
    if epochs:  # the rest of the pass
        for _ in stream:
            n += 1
    else:
        for _ in range(batches - 1):
            next(stream)
            n += 1
    seconds = time.perf_counter() - t0
    stream.close()
    counters = {k: v["value"] for k, v in obs.snapshot()["counters"].items()}
    return {"images_per_sec": BATCH * n / seconds, "batches_timed": n, "seconds": seconds,
            "decode_native_total": counters.get("decode_native_total", 0),
            "decode_cache_hits_total": counters.get("decode_cache_hits_total", 0),
            "data_producer_parse_seconds_total": counters.get("data_producer_parse_seconds_total", 0)}


def _input_rate_child(conn, *args):
    import traceback

    try:
        conn.send(("ok", _input_rate(*args)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))


def input_rate(here, train_dir, env, batches=INPUT_BATCHES, epochs=None):
    """:func:`_input_rate` in a spawned process of its own (not a pool's
    daemon: the decode plane forks children)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_input_rate_child, args=(send, here, train_dir, env, batches, epochs))
    proc.start()
    send.close()
    try:
        status, out = recv.recv()
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
    if status != "ok":
        raise RuntimeError("input_only leg {} failed:\n{}".format(env, out))
    return out


def _stall_readings(first, last):
    """The input plane's stall seconds between two train_step spans (calls 1
    and the last: the steady state, past the build and the capture) and
    ``classify_stalls``' verdict on them."""
    from tensorflowonspark_tpu_torch.control.core import classify_stalls
    from tensorflowonspark_tpu_torch.examples.resnet.resnet_spark import STALL_COUNTERS

    d = {name: last[name] - first[name] for name in STALL_COUNTERS}
    return dict(d, classify_stalls=classify_stalls(*(d[name] for name in STALL_COUNTERS)))


def phase_slice_real(torch, fused_bn, train_dir, eval_dir, mode, env, eval_leg=False):
    """One leg of the real-data slice: the port's ResNet example through
    ``TFCluster.run``, ResNet-50, bf16, ``bn_impl="pallas"``, batch 64, 224
    px, ``--steps_per_loop 5`` for ``REAL_STEPS`` steps on the JPEG shards,
    the decode mode set through the cluster's env lane. Images/s over calls
    2 and later, the stall counters and their verdict, the native decodes,
    the decode plane's respawns and each BN wrapper's launches; with
    ``eval_leg`` also ``--eval_dir`` (top-1 over every eval image, rank 0)."""
    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark

    argv = ["--dataset", "imagenet", "--bn_impl", "pallas", "--batch_size", str(BATCH),
            "--train_steps", str(REAL_STEPS), "--log_steps", str(STEPS), "--steps_per_loop", str(STEPS),
            "--data_dir", train_dir, "--data_threads", str(REAL_THREADS), "--image_size", str(IMAGE)]
    if eval_leg:
        argv += ["--eval_dir", eval_dir]
    args = resnet_spark.build_parser().parse_args(argv)
    fused_bn.reset_launch_counts()
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        cluster = TFCluster.run(
            sc, resnet_spark.main_fun, args, 1,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
            env=dict(env, **{util.ENV_PLATFORM: "gpu"}),
        )
        if not cluster.wait_for_completion(timeout=600):
            raise TimeoutError("the trainer did not finish within 600 s")
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown()
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    events = sorted(
        (e for e in metrics["events"] if e.get("span") == "train_step"), key=lambda e: e["step"]
    )
    losses = [e.get("loss") for e in events]
    counters = {k: v["value"] for k, v in metrics["counters"].items()}
    launches = {name: int(counters.get("fused_bn_{}_launches_total".format(name), 0))
                for name, *_ in KERNEL_TABLE}
    timed_calls = [e["dur_s"] for e in events[1:]]
    line = {"phase": "slice_real", "mode": mode, "env": env, "model": "resnet50", "dtype": "bfloat16",
            "bn_impl": "pallas", "batch": BATCH, "image": IMAGE, "steps": REAL_STEPS,
            "steps_per_loop": STEPS, "data_threads": REAL_THREADS, "usable_cores": usable_cores(),
            "losses": losses, "call_s": [e["dur_s"] for e in events],
            "images_per_sec_after_first_call": BATCH * STEPS * len(timed_calls) / sum(timed_calls),
            "decode_native_total": int(counters.get("decode_native_total", 0)),
            "decode_worker_restarts_total": int(counters.get("decode_worker_restarts_total", 0)),
            "decode_cache_hits_total": int(counters.get("decode_cache_hits_total", 0)),
            "records_skipped": int(counters.get("data_records_skipped_total", 0)),
            "launches": launches, "wall_s": wall}
    line["after_first_call"] = _stall_readings(events[0], events[-1])
    line["whole_run_classify_stalls"] = _stall_readings({k: 0.0 for k in events[-1]}, events[-1])[
        "classify_stalls"]
    evals = [e for e in metrics["events"] if e.get("span") == "eval"]
    if eval_leg:
        line["eval"] = {k: evals[0].get(k) for k in ("examples", "correct", "accuracy", "dur_s")} if evals else None
    emit(line)
    calls = REAL_STEPS // STEPS
    if len(events) != calls or not all(isinstance(v, float) and math.isfinite(v) for v in losses):
        raise AssertionError("slice_real {}: expected {} finite losses, got {}".format(mode, calls, losses))
    if not all(v > 0 for v in launches.values()):
        raise AssertionError("slice_real {}: BN kernel launches {}".format(mode, launches))
    if line["records_skipped"]:
        raise AssertionError("slice_real {}: {} records skipped".format(mode, line["records_skipped"]))
    return line


def phase_real(torch, fused_bn, here, work):
    """``data_setup``, the input path alone in each decode mode, then
    ``slice_real`` in each (threads with the native decoder; the forked
    decode plane, one worker killed; a warm slab cache) and ``eval_real``.
    Returns each BN wrapper's launches summed over the three legs."""
    from tensorflowonspark_tpu_torch import native_io

    train_dir, eval_dir = phase_data_setup(work)
    cache_dir = os.path.join(work, "slab_cache")
    workers = decode_plane_workers()
    modes = {"threads": {"TOS_DECODE_WORKERS": "0"},
             "decode_plane": {"TOS_DECODE_WORKERS": str(workers)},
             "cache_warm": {"TOS_DECODE_WORKERS": "0", "TOS_SLAB_CACHE_DIR": cache_dir}}
    inputs = {mode: input_rate(here, train_dir, env) for mode, env in modes.items() if mode != "cache_warm"}
    # one epoch with the cache on fills it (cold), the next pass reads it
    inputs["cache_cold"] = input_rate(here, train_dir, modes["cache_warm"], epochs=1)
    inputs["cache_warm"] = input_rate(here, train_dir, modes["cache_warm"])
    emit({"phase": "input_only", "batch": BATCH, "image": IMAGE, "batches": INPUT_BATCHES,
          "usable_cores": usable_cores(), "decode_plane_workers": workers, "legs": inputs})
    if not inputs["threads"]["decode_native_total"] or inputs["cache_warm"]["decode_cache_hits_total"] < BATCH:
        raise AssertionError("input_only: native decodes {}, warm cache hits {}".format(
            inputs["threads"]["decode_native_total"], inputs["cache_warm"]["decode_cache_hits_total"]))
    lines = {}
    for mode, env in modes.items():
        if mode == "decode_plane":
            env = dict(env, TOS_CHAOS_PLAN=json.dumps(DECODE_KILL))
        lines[mode] = phase_slice_real(torch, fused_bn, train_dir, eval_dir, mode, env,
                                       eval_leg=mode == "threads")
    if not (lines["threads"]["decode_native_total"] > 0 and lines["decode_plane"]["decode_native_total"] > 0):
        raise AssertionError("slice_real: the native decoder did not run")
    if lines["decode_plane"]["decode_worker_restarts_total"] < 1:
        raise AssertionError("slice_real: no decode worker respawned after the kill")
    if lines["cache_warm"]["decode_cache_hits_total"] < BATCH:
        raise AssertionError("slice_real: the warm cache served {} rows".format(
            lines["cache_warm"]["decode_cache_hits_total"]))
    ev = lines["threads"]["eval"]
    emit({"phase": "eval_real", "eval": ev})
    if not (ev and ev["examples"] == REAL_EVAL and 0.0 <= ev["accuracy"] <= 1.0):
        raise AssertionError("eval_real: {}".format(ev))
    emit({"phase": "slice_real_summary", "native_build": native_io.build_info(),
          "usable_cores": usable_cores(), "decode_plane_workers": workers,
          "images_per_sec": {m: v["images_per_sec_after_first_call"] for m, v in lines.items()},
          "input_only_images_per_sec": {m: v["images_per_sec"] for m, v in inputs.items()},
          "classify_stalls": {m: v["after_first_call"]["classify_stalls"] for m, v in lines.items()},
          "data_consumer_wait_seconds_total": {
              m: v["after_first_call"]["data_consumer_wait_seconds_total"] for m, v in lines.items()},
          "data_producer_parse_seconds_total": {
              m: v["after_first_call"]["data_producer_parse_seconds_total"] for m, v in lines.items()}})
    return {name: sum(line["launches"][name] for line in lines.values()) for name, *_ in KERNEL_TABLE}


# -- the serving plane ---------------------------------------------------------

#: ``serve``: ResNet-50 (bf16, 224 px, 1,000 classes) behind the port's
#: InferenceServer; clients x requests x rows of uint8 images on the binary
#: lane, coalescing on (1,024 rows) and off (1) in turns, rounds of both
SERVE_MODEL, SERVE_IMAGE = "resnet50", 224
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_ROWS, SERVE_ROUNDS = 8, 12, 16, 3
#: a reply's logits against a direct predict of the same rows on the card,
#: as a norm: ||got - want|| / ||want|| <= SERVE_TOL, per reply. A dispatch
#: of another batch size may take another cuDNN / cuBLAS algorithm, and the
#: logits come out of a bf16 head: a coalesced reply reads one bf16 ulp off
#: here and there (0.0625 at a logit of 8, 0.8% of it). A 1% fault reads
#: 1e-2 > SERVE_TOL
SERVE_TOL = 2.0 ** -8
#: a reply's prediction must equal the direct argmax wherever the direct
#: top two logits differ by more than SERVE_GAP * max|want| (about two bf16
#: ulps of the largest logit): a tie within one ulp flips when one logit
#: moves by one ulp
SERVE_GAP = 2.0 ** -6
#: ``serve_lm``: the LM at TransformerConfig's defaults (bf16, attention
#: "auto": the flash kernels on the card); clients x requests of 1-2 rows
SERVE_LM_CLIENTS, SERVE_LM_REQUESTS = 4, 6
#: a reply's ``logits_last`` against the same bundle built with attention
#: "plain" on the card. The blocks keep their residual stream in bf16: one
#: attention output a rounding apart flips bf16 roundings downstream, and the
#: logits read 0.8% apart as a norm (the head runs in f32, so they are not
#: rounded at the end). Held two ways: ||got - plain|| / ||plain|| <=
#: SERVE_LM_NORM_TOL, and the scale of got along plain, |<got, plain> /
#: <plain, plain> - 1| <= SERVE_LM_SCALE_TOL (the flips are unbiased and
#: nearly orthogonal to the logits; an output 1% off reads 1e-2 there)
SERVE_LM_NORM_TOL, SERVE_LM_SCALE_TOL = 2.0 ** -6, 2.0 ** -9
#: ``infer_cli``: rows a batch of the batch-inference CLI
INFER_BATCH = 64
#: ``serving_mesh``: process-mode replicas on the one card, load threads,
#: published generations after the first, the settle window after a swap
MESH_REPLICAS, MESH_LOAD_THREADS, MESH_GENERATIONS, MESH_SETTLE_S = 3, 3, 3, 2.0
MESH_ROWS = 4
#: the device the serving phases' servers report, on the card
SERVE_DEVICE = "cuda:0"


def build_resnet_predict(device=None, model="resnet50", image=224, report=False):
    """``predict_builder`` of the serving phases' ResNet bundle: the port's
    ``resnet`` ``model`` in bf16, eval mode, built on ``device`` (default:
    the card, raising without one). ``predict(params, model_state,
    arrays)`` takes ``image``, uint8 ``[n, image, image, 3]`` (or the same
    values flattened, as the batch CLI feeds a float feature), and returns
    ``prediction`` (class ids) and ``logits`` (f32) as tensors on the
    device. With ``report`` it also returns, row by row, the generation in
    ``model_state``, the serving process's pid and its
    ``torch.cuda.memory_allocated`` before the forward."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import util
    from tensorflowonspark_tpu_torch.data import imagenet
    from tensorflowonspark_tpu_torch.models import resnet

    device = torch.device(device) if device is not None else util.select_device("gpu")
    with device:  # initialise the (replaced) weights where they will live
        module = getattr(resnet, model)(dtype=torch.bfloat16).eval()
    loaded = {}

    @torch.no_grad()
    def predict(params, model_state, arrays):
        if loaded.get("params") is not params:
            module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
            loaded["params"] = params
        allocated = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        x = np.asarray(arrays["image"]).astype(np.uint8, copy=False).reshape(-1, image, image, 3)
        logits = module(imagenet.device_normalize(torch.from_numpy(np.array(x)).to(device)))
        out = {"prediction": logits.argmax(-1), "logits": logits}
        if report:
            n = len(x)
            out["generation"] = np.full(n, int(np.asarray(model_state["generation"]).ravel()[0]))
            out["pid"] = np.full(n, os.getpid())
            out["cuda_allocated"] = np.full(n, allocated)
        return out

    return predict


def resnet_bundle_builder(**kw):
    import functools

    return functools.partial(build_resnet_predict, model=SERVE_MODEL, image=SERVE_IMAGE, **kw)


def resnet_serve_weights(seed=0):
    """The serving ResNet's weights on the host, from a seeded
    ``torch.Generator``: flax's initialisers, then every BatchNorm's scale,
    bias and running statistics drawn too (a zero-initialised residual
    scale would leave its branch out of the forward)."""
    import torch

    from tensorflowonspark_tpu_torch.models import resnet

    gen = torch.Generator().manual_seed(seed)
    module = getattr(resnet, SERVE_MODEL)(dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        for m in module.modules():
            if getattr(m, "running_var", None) is not None:
                m.weight.uniform_(0.2, 1.0, generator=gen)
                m.bias.uniform_(-0.1, 0.1, generator=gen)
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return {k: v.numpy() for k, v in module.state_dict().items()}


def serve_images(rng, n):
    """uint8 images that differ image to image: a colour per image plus
    pixel noise (noise alone averages out to one class for every image)."""
    import numpy as np

    base = rng.integers(0, 256, (n, 1, 1, 3))
    noise = rng.integers(-48, 49, (n, SERVE_IMAGE, SERVE_IMAGE, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _percentiles(lat_s):
    import numpy as np

    ms = np.asarray(lat_s) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def _drive(address, requests, clients):
    """``requests[c]``: client ``c``'s request dicts, sent in order over one
    ``InferenceClient`` each, all clients at once. Returns (replies by
    (client, i), latencies in seconds, wall seconds, errors)."""
    from tensorflowonspark_tpu_torch.serving import InferenceClient

    replies, lat, errors = {}, [], []
    lock = threading.Lock()
    start = threading.Barrier(clients + 1)

    def client(c):
        cl = InferenceClient(address, timeout=300)
        try:
            start.wait()
            for i, req in enumerate(requests[c]):
                t = time.perf_counter()
                out = cl.predict_binary(**req)
                with lock:
                    lat.append(time.perf_counter() - t)
                    replies[(c, i)] = out
        except Exception as e:  # reported and failed by the caller
            with lock:
                errors.append("{}: {}".format(type(e).__name__, e))
        finally:
            cl.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    return replies, lat, time.perf_counter() - t0, errors


def _logit_error(got, want):
    """max |got - want| over a reply, and ||got - want|| / ||want||."""
    import numpy as np

    diff = got.astype(np.float64) - want
    return float(np.abs(diff).max()), float(np.linalg.norm(diff) / max(np.linalg.norm(want), 1e-30))


def phase_serve(torch, work):
    """The port's ``InferenceServer`` on a ResNet-50 bundle, a server a leg
    started with ``TOS_SERVING_COALESCE_ROWS`` set (1,024: coalescing on;
    1: off), coalescing on and off in turns. Every reply is held against a
    direct ``predict_fn`` call on the same rows on the card. Returns the
    bundle dir."""
    import shutil

    import numpy as np

    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.train import export

    bundle = os.path.join(work, "resnet50_bundle")
    shutil.rmtree(bundle, ignore_errors=True)
    export.export_model(bundle, resnet_bundle_builder(), resnet_serve_weights(0))
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    requests = [[{"image": serve_images(rng, SERVE_ROWS)} for _ in range(SERVE_REQUESTS)]
                for _ in range(SERVE_CLIENTS)]
    predict_fn, params, model_state, _ = serving.load_bundle(bundle)
    # the direct predict of each request's rows, on the card
    want = {(c, i): serving._to_numpy(predict_fn(params, model_state, req)["logits"])
            for c, reqs in enumerate(requests) for i, req in enumerate(reqs)}
    del predict_fn, params, model_state
    legs, worst, fault_caught, pred_bad, pred_checked, devices = [], 0.0, None, 0, 0, set()
    old_rows = os.environ.get("TOS_SERVING_COALESCE_ROWS")
    try:
        for rnd in range(SERVE_ROUNDS):
            for coalesce in (True, False):
                os.environ["TOS_SERVING_COALESCE_ROWS"] = "1024" if coalesce else "1"
                server = serving.InferenceServer(bundle, host="127.0.0.1", port=0)
                devices.add(str(server.device))
                try:
                    replies, lat, wall, errors = _drive(server.start(), requests, SERVE_CLIENTS)
                finally:
                    server.stop()
                if errors or len(replies) != SERVE_CLIENTS * SERVE_REQUESTS:
                    raise AssertionError("serve: {} replies, errors {}".format(len(replies), errors[:3]))
                leg_err, leg_rel, leg_bitwise = 0.0, 0.0, True
                for key, out in replies.items():
                    got, ref = out["logits"], want[key]
                    err, rel = _logit_error(got, ref)
                    leg_err, leg_rel, worst = max(leg_err, err), max(leg_rel, rel), max(worst, rel)
                    leg_bitwise = leg_bitwise and bool(np.array_equal(got, ref))
                    top2 = np.sort(ref, axis=-1)[:, -2:]
                    clear = (top2[:, 1] - top2[:, 0]) > SERVE_GAP * np.abs(ref).max()
                    pred_checked += int(clear.sum())
                    pred_bad += int((out["prediction"][clear] != ref.argmax(-1)[clear]).sum())
                    if fault_caught is None:
                        fault_caught = _logit_error(ref * 1.01, ref)[1] > SERVE_TOL
                p50, p99 = _percentiles(lat)
                legs.append({"round": rnd, "coalesce": coalesce, "rows_per_s": SERVE_CLIENTS * SERVE_REQUESTS
                             * SERVE_ROWS / wall, "p50_ms": p50, "p99_ms": p99, "wall_s": wall,
                             "max_abs_err": leg_err, "max_rel_norm_err": leg_rel, "bitwise": leg_bitwise})
    finally:
        if old_rows is None:
            os.environ.pop("TOS_SERVING_COALESCE_ROWS", None)
        else:
            os.environ["TOS_SERVING_COALESCE_ROWS"] = old_rows
    line = {"phase": "serve", "model": SERVE_MODEL, "image": SERVE_IMAGE, "dtype": "bfloat16",
            "clients": SERVE_CLIENTS, "requests_per_client": SERVE_REQUESTS, "rows": SERVE_ROWS,
            "legs": legs, "max_rel_norm_err": worst, "tol": SERVE_TOL, "argmax_gap": SERVE_GAP,
            "fault_1pct_caught": fault_caught, "predictions_checked": pred_checked,
            "predictions_differ": pred_bad, "server_devices": sorted(devices),
            "classes_seen": len({int(w.argmax(-1)[j]) for w in want.values() for j in range(len(w))}),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(line)
    if worst > SERVE_TOL or not fault_caught or pred_bad or devices != {SERVE_DEVICE}:
        raise AssertionError("serve: {}".format(line))
    return bundle


def build_lm_predict(device=None, attention="auto", **cfg):
    """``predict_builder`` of the serving LM bundle: the port's transformer
    (``TransformerConfig(**cfg)``, its ``attention``) on ``device`` (default:
    the card). ``predict`` takes ``tokens`` and ``segment_ids`` ``[n, L]``
    int32 (packed rows; positions restart at each segment), runs the
    embedding and the blocks in the model's dtype, and returns
    ``logits_last``, f32 ``[n, vocab]``: the final RMSNorm and the vocab
    projection at each row's last position only, in f32 (a bf16 head would
    round every logit to 2^-8 of itself); and ``dispatch``, the number of
    this call, row by row."""
    import itertools

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import util
    from tensorflowonspark_tpu_torch.models import transformer

    device = torch.device(device) if device is not None else util.select_device("gpu")
    with device:
        module = transformer.create_model(attention=attention, **cfg).eval()
    loaded, calls = {}, itertools.count(1)

    @torch.no_grad()
    def predict(params, model_state, arrays):
        if loaded.get("params") is not params:
            module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
            loaded["params"] = params
        tokens = torch.from_numpy(np.array(arrays["tokens"], np.int64)).to(device)
        seg = torch.from_numpy(np.array(arrays["segment_ids"], np.int32)).to(device)
        idx = torch.arange(seg.shape[1], device=device).expand(seg.shape)
        first = seg != seg.roll(1, 1)
        first[:, 0] = True
        positions = idx - torch.cummax(torch.where(first, idx, 0), 1).values
        x = torch.nn.functional.embedding(tokens, module.embed.weight).to(module.cfg.compute_dtype)
        for i in range(module.cfg.n_layers):
            x = getattr(module, "layer_{}".format(i))(x, positions, seg)
        h = x[:, -1].float()
        h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + module.ln_f.eps) * module.ln_f.weight
        logits_last = torch.nn.functional.linear(h, module.lm_head.weight)
        return {"logits_last": logits_last, "dispatch": np.full(len(h), next(calls))}

    return predict


def lm_serve_weights(seed=0):
    import torch

    from tensorflowonspark_tpu_torch.models import transformer

    gen = torch.Generator().manual_seed(seed)
    module = transformer.create_model(generator=gen, **LM)
    return {k: v.numpy() for k, v in module.state_dict().items()}


def phase_serve_lm(torch, fa, lm_batch, work):
    """The port's ``InferenceServer`` on the LM bundle (bf16, attention
    "auto"): clients send 1-2 packed rows of the slice's corpus each, so the
    predictor coalesces dispatches of several rows. The flash forward's
    wrapper must launch at least 6 times a dispatch; every reply is held
    against the same weights with attention "plain" on the card. Returns
    the flash wrappers' launches over the traffic."""
    import functools
    import shutil

    import numpy as np

    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.train import export

    weights = lm_serve_weights(0)
    bundles = {}
    for attention in ("auto", "plain"):
        bundles[attention] = os.path.join(work, "lm_bundle_" + attention)
        shutil.rmtree(bundles[attention], ignore_errors=True)
        export.export_model(bundles[attention], functools.partial(
            build_lm_predict, attention=attention, dtype="bfloat16", max_seq_len=LM_SEQ, **LM), weights)
    tokens = np.asarray(lm_batch["tokens"][:, :-1], np.int32)
    seg = np.asarray(lm_batch["segment_ids"][:, :-1], np.int32)
    rng = np.random.default_rng(1)
    requests, row = [], 0
    for _ in range(SERVE_LM_CLIENTS):
        reqs = []
        for _ in range(SERVE_LM_REQUESTS):
            n = int(rng.integers(1, 3))
            rows = [(row + j) % len(tokens) for j in range(n)]
            row += n
            reqs.append({"tokens": tokens[rows], "segment_ids": seg[rows]})
        requests.append(reqs)
    server = serving.InferenceServer(bundles["auto"], host="127.0.0.1", port=0)
    address = server.start()
    try:
        # the first dispatch of each size builds nothing new for the flash
        # kernel (built in ``build``); warm the cuBLAS handles once
        _drive(address, [[requests[0][0]]], 1)
        fa.reset_launch_counts()
        replies, lat, wall, errors = _drive(address, requests, SERVE_LM_CLIENTS)
        launches = fa.launch_counts()
    finally:
        server.stop()
    if errors or len(replies) != SERVE_LM_CLIENTS * SERVE_LM_REQUESTS:
        raise AssertionError("serve_lm: {} replies, errors {}".format(len(replies), errors[:3]))
    per_dispatch = {}  # dispatch number -> the requests it served
    for out in replies.values():
        d = int(out["dispatch"][0])
        per_dispatch[d] = per_dispatch.get(d, 0) + 1
    dispatches = set(per_dispatch)
    plain_fn, params, model_state, _ = serving.load_bundle(bundles["plain"])

    def held(got, want):
        """(||got - want|| / ||want||, |<got, want> / <want, want> - 1|)."""
        return (float(np.linalg.norm(got - want) / np.linalg.norm(want)),
                abs(float(np.vdot(got, want) / np.vdot(want, want)) - 1.0))

    worst, worst_scale, fault = 0.0, 0.0, None
    for key, out in replies.items():
        req = requests[key[0]][key[1]]
        want = serving._to_numpy(plain_fn(params, model_state, req)["logits_last"]).astype(np.float64)
        got = out["logits_last"].astype(np.float64)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError("serve_lm: reply {} shape {} finite {}".format(key, got.shape, np.isfinite(got).all()))
        rel, scale = held(got, want)
        worst, worst_scale = max(worst, rel), max(worst_scale, scale)
        if fault is None:
            fault = held(want * 1.01, want)
    p50, p99 = _percentiles(lat)
    rows = [len(out["logits_last"]) for out in replies.values()]
    line = {"phase": "serve_lm", "config": dict(LM, seq=LM_SEQ, dtype="bfloat16", attention="auto"),
            "clients": SERVE_LM_CLIENTS, "requests_per_client": SERVE_LM_REQUESTS, "rows": sum(rows),
            "dispatches": len(dispatches), "coalesced_dispatches": sum(n > 1 for n in per_dispatch.values()),
            "flash_launches": launches, "p50_ms": p50, "p99_ms": p99,
            "rows_per_s": sum(rows) / wall, "max_rel_norm_err_vs_plain": worst, "norm_tol": SERVE_LM_NORM_TOL,
            "max_scale_err_vs_plain": worst_scale, "scale_tol": SERVE_LM_SCALE_TOL,
            "fault_1pct_reads": fault, "fault_1pct_caught": fault is not None and (
                fault[0] > SERVE_LM_NORM_TOL or fault[1] > SERVE_LM_SCALE_TOL)}
    emit(line)
    if (launches["flash_fwd"] < len(dispatches) * LM["n_layers"] or worst > SERVE_LM_NORM_TOL
            or worst_scale > SERVE_LM_SCALE_TOL
            or not line["fault_1pct_caught"] or not line["coalesced_dispatches"]):
        raise AssertionError("serve_lm: {}".format(line))
    return launches


def phase_infer_cli(torch, here, bundle, eval_dir, work):
    """``python -m tensorflowonspark_tpu_torch.serving infer`` on the
    real-data slice's 512 eval images: the CLI feeds numeric features only
    (bytes features are not model inputs, as in the JAX package), so the
    eval shards' JPEGs are decoded (the eval parse: 224 px centre crop)
    into float-feature shards, one a source shard. Run once in-process
    (``--export_dir``) and once against a running server (``--server``):
    both must write 512 predictions, equal to each other and to a direct
    predict of the same decoded images."""
    import shutil

    import numpy as np

    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch import tfrecord as tfr
    from tensorflowonspark_tpu_torch.data import imagenet

    feats = os.path.join(work, "infer_records")
    shutil.rmtree(feats, ignore_errors=True)
    os.makedirs(feats)
    parse = imagenet.make_parse_fn(False, image_size=SERVE_IMAGE, raw_uint8=True)
    shards = []
    for src in tfr.list_shards(eval_dir):
        images = np.stack([parse(rec)[0] for rec in tfr.read_records(src)])
        shards.append(images)
        with tfr.TFRecordWriter(os.path.join(feats, os.path.basename(src))) as w:
            for img in images:
                w.write(tfr.encode_example({"image": img.reshape(-1).astype(np.float32).tolist()}))
    predict_fn, params, model_state, _ = serving.load_bundle(bundle)
    direct = []
    for images in shards:  # the CLI's batches: per shard, INFER_BATCH rows
        for lo in range(0, len(images), INFER_BATCH):
            out = predict_fn(params, model_state, {"image": images[lo:lo + INFER_BATCH]})
            direct.extend(serving._to_numpy(out["prediction"]).tolist())

    def run(out_dir, *source):
        shutil.rmtree(out_dir, ignore_errors=True)
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "tensorflowonspark_tpu_torch.serving", "infer", "--tfrecords", feats,
             "--output", out_dir, "--batch_size", str(INFER_BATCH), "--input_mapping", "image=image",
             "--output_mapping", "prediction=prediction"] + list(source),
            cwd=here, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if done.returncode != 0:
            raise AssertionError("infer_cli {}: exit {}: {}".format(source, done.returncode, done.stderr[-3000:]))
        preds = []
        for name in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, name)) as f:
                preds.extend(json.loads(line)["prediction"] for line in f)
        return preds, seconds

    local, local_s = run(os.path.join(work, "infer_out_local"), "--export_dir", bundle)
    server = serving.InferenceServer(bundle, host="127.0.0.1", port=0)
    host, port = server.start()
    try:
        remote, remote_s = run(os.path.join(work, "infer_out_server"), "--server", "127.0.0.1:{}".format(port))
    finally:
        server.stop()
    line = {"phase": "infer_cli", "records": sum(len(s) for s in shards), "batch": INFER_BATCH,
            "export_dir_predictions": len(local), "server_predictions": len(remote),
            "export_dir_equals_server": local == remote, "export_dir_equals_direct": local == direct,
            "export_dir_s": local_s, "server_s": remote_s, "classes_seen": len(set(direct))}
    emit(line)
    if not (len(local) == len(remote) == len(direct) == REAL_EVAL and local == remote == direct):
        raise AssertionError("infer_cli: {}".format(line))


def _scrape(port):
    import urllib.request

    with urllib.request.urlopen("http://127.0.0.1:{}/metrics".format(port), timeout=5) as resp:
        return resp.read().decode("utf-8")


def mesh_child(work):
    """The ``serving_mesh`` phase's body, in a process that never sets up
    CUDA (``python3 -c 'import chip_smoke; chip_smoke.mesh_child(...)'``):
    a process-mode ``ServingMesh`` of ``MESH_REPLICAS`` forked replicas on
    the one card over a ``ModelPointer``, load threads through
    ``mesh.router()`` for the whole phase; a replica killed mid-load and
    relaunched; ``MESH_GENERATIONS`` new generations published and swapped
    in under load; then the fork refusal with CUDA up; then the ``mesh``
    CLI with ``--metrics_port``. Prints one JSON line; raises on a
    failed check."""
    import shutil
    import signal

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import obs, serving, util
    from tensorflowonspark_tpu_torch.serving_mesh import ModelPointer, ServingMesh

    if torch.cuda.is_initialized():
        raise AssertionError("serving_mesh: the mesh parent has CUDA up")
    root = os.path.join(work, "pointer")
    shutil.rmtree(root, ignore_errors=True)
    ptr = ModelPointer(root)
    weights = resnet_serve_weights(0)
    param_bytes = sum(v.nbytes for v in weights.values())

    def generation(g):  # the head moved a little each generation
        w = dict(weights)
        w["head.weight"] = weights["head.weight"] * np.float32(1.0 + 0.05 * g)
        return w

    builder = resnet_bundle_builder(report=True)
    ptr.publish(builder, generation(0), model_state={"generation": np.array([0])})
    counter = lambda name: obs.snapshot()["counters"].get(name, {}).get("value", 0)  # noqa: E731
    mesh = ServingMesh(root, replicas=MESH_REPLICAS, mode="process", monitor_interval=0.5,
                       lease_ttl=2.0, swap_poll=0.2)
    t0 = time.perf_counter()
    mesh.start()
    start_s = time.perf_counter() - t0
    router = mesh.router(deadline=60.0)
    image = serve_images(np.random.default_rng(5), MESH_ROWS)
    log, errors, stop = [], [], threading.Event()
    lock = threading.Lock()

    def load():
        while not stop.is_set():
            try:
                out = router.predict_binary(image=image)
                with lock:
                    log.append((time.perf_counter(), int(out["generation"][0]), int(out["pid"][0]),
                                int(out["cuda_allocated"][0])))
            except Exception as e:  # every client-visible failure fails the phase
                with lock:
                    errors.append("{}: {}".format(type(e).__name__, e))
            time.sleep(0.01)

    threads = [threading.Thread(target=load) for _ in range(MESH_LOAD_THREADS)]
    line = {"phase": "serving_mesh", "replicas": MESH_REPLICAS, "load_threads": MESH_LOAD_THREADS,
            "start_s": start_s, "param_bytes": param_bytes, "parent_cuda_initialized": False}
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 60
        while time.time() < deadline and mesh._beats.get(0, 0) < 1:
            time.sleep(0.05)
        relaunches = counter("serving_replica_relaunches_total")
        time.sleep(1.0)
        with mesh._lock:
            old_pids = {rec.proc.pid for rec in mesh._replicas.values()}
        t_kill = time.perf_counter()
        mesh.kill_replica(0)
        deadline = time.time() + 120
        while time.time() < deadline and not (counter("serving_replica_relaunches_total") - relaunches >= 1
                                               and len(mesh.endpoints()) == MESH_REPLICAS):
            time.sleep(0.1)
        with mesh._lock:
            new_pid = mesh._replicas[0].proc.pid
        deadline = time.time() + 60
        first = None
        while time.time() < deadline and first is None:
            with lock:
                first = next((t for t, _, pid, _ in log if pid == new_pid and t > t_kill), None)
            time.sleep(0.05)
        line.update(relaunches=counter("serving_replica_relaunches_total") - relaunches,
                    endpoints_after_relaunch=len(mesh.endpoints()), relaunched_pid_new=new_pid not in old_pids,
                    kill_to_first_answer_s=None if first is None else first - t_kill,
                    errors_after_kill=len(errors))
        swaps = []
        for g in range(1, MESH_GENERATIONS + 1):
            t_pub = time.perf_counter()
            ptr.publish(builder, generation(g), model_state={"generation": np.array([g])})
            deadline = time.time() + 120
            flipped = None
            while time.time() < deadline and flipped is None:
                with lock:
                    seen = {pid for t, gen, pid, _ in log if t > t_pub and gen == g}
                if len(seen) >= MESH_REPLICAS:
                    flipped = time.perf_counter() - t_pub
                time.sleep(0.05)
            t_settled = time.perf_counter() + MESH_SETTLE_S
            time.sleep(MESH_SETTLE_S + 1.0)
            with lock:
                after = [(gen, pid, mem) for t, gen, pid, mem in log if t > t_settled]
            memory = {}
            for gen, pid, mem in after:
                memory[pid] = mem  # the newest reading of each replica
            swaps.append({"generation": g, "all_replicas_flipped_s": flipped, "replies_after_settle": len(after),
                          "generations_after_settle": sorted({gen for gen, _, _ in after}),
                          "cuda_allocated_by_pid": memory})
        line["swaps"] = swaps
        growth = {pid: swaps[-1]["cuda_allocated_by_pid"][pid] - swaps[0]["cuda_allocated_by_pid"][pid]
                  for pid in swaps[-1]["cuda_allocated_by_pid"] if pid in swaps[0]["cuda_allocated_by_pid"]}
        line["cuda_allocated_growth_swap1_to_swap3"] = growth
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        router.close()
        mesh.stop()
    line["router_errors"] = len(errors)
    line["errors_sample"] = errors[:3]
    # the fork rule: with CUDA up in the parent, a process-mode mesh refuses
    torch.cuda.init()
    refused = None
    try:
        ServingMesh(root, replicas=1, mode="process").start()
    except RuntimeError as e:
        refused = str(e)
    line["fork_with_cuda_refused"] = refused
    # the CLI: a routed mesh of 2 (thread-mode) replicas with a metrics endpoint
    port, metrics_port = util.find_free_port(), util.find_free_port()
    line["cli"] = {}
    cli_log = open(os.path.join(work, "mesh_cli.log"), "w")
    cli = subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.serving", "mesh", "--export_dir", root,
         "--replicas", "2", "--host", "127.0.0.1", "--port", str(port), "--metrics_port", str(metrics_port)],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=cli_log, stderr=subprocess.STDOUT)
    try:
        body, deadline = "", time.time() + 180
        while time.time() < deadline and "serving_replicas_active 2" not in body:
            try:
                body = _scrape(metrics_port)
            except OSError:
                pass
            time.sleep(0.5)
        client = serving.InferenceClient(("127.0.0.1", port), timeout=120)
        try:
            info = client.info()
            cli_gen = int(client.predict_binary(image=image)["generation"][0])
        finally:
            client.close()
        line["cli"].update(replicas_active_2="serving_replicas_active 2" in body, info_mesh=info.get("mesh"),
                           generation=cli_gen)
    finally:
        cli.send_signal(signal.SIGINT)
        try:
            cli.wait(timeout=60)
        except subprocess.TimeoutExpired:
            cli.kill()
            cli.wait()
        cli_log.close()
    line["cli"]["exit"] = cli.returncode
    print(json.dumps(line), flush=True)
    bad = []
    if line["router_errors"]:
        bad.append("router errors")
    if (line["relaunches"] < 1 or line["endpoints_after_relaunch"] != MESH_REPLICAS
            or line["kill_to_first_answer_s"] is None):
        bad.append("relaunch")
    for s in line["swaps"]:
        if s["all_replicas_flipped_s"] is None or s["generations_after_settle"] != [s["generation"]]:
            bad.append("swap {}".format(s["generation"]))
    if len(growth) != MESH_REPLICAS or max(growth.values()) > param_bytes:
        bad.append("replica memory grew past one model's bytes: {}".format(growth))
    if not refused or "CUDA" not in refused:
        bad.append("fork with CUDA up was not refused")
    if not (line["cli"].get("replicas_active_2") and line["cli"].get("info_mesh") is True):
        bad.append("mesh CLI")
    if bad:
        raise AssertionError("serving_mesh: {}".format("; ".join(bad)))


def phase_serving_mesh(here, work):
    """``mesh_child`` in a fresh interpreter (this process has CUDA up, and
    the mesh parent must not); relays its line."""
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.mesh_child({!r})".format(work)],
                          cwd=here, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in done.stdout.splitlines() if ln.startswith('{"phase": "serving_mesh"')]
    if lines:
        print(lines[-1], flush=True)
    if done.returncode != 0 or not lines:
        raise AssertionError("serving_mesh: exit {}: {}".format(done.returncode, done.stderr[-4000:]))
    emit({"phase": "serving_mesh_seconds", "seconds": time.perf_counter() - t0})


#: the segmentation slice (BASELINE config 5): the JAX U-Net's full width,
#: the TensorFlow "Image segmentation" tutorial's batch and image size
SEG = dict(num_classes=3, base_filters=32, depth=4)
SEG_IMAGE, SEG_BATCH, SEG_STEPS = 128, 64, 30
#: images/s over steps SEG_TIMED_FROM..SEG_STEPS (the first ones set up cuDNN)
SEG_TIMED_FROM = 6
#: seg_compare's batch; the inference leg's instances and images in all
SEG_COMPARE_BATCH, SEG_INSTANCES, SEG_INFER = 8, 2, 64
#: estimator_mnist: the example's defaults (2,048 rows, batch 64, a
#: checkpoint every 10 steps), a chief and the evaluator, one epoch
ESTIMATOR_CLUSTER = 2


def phase_seg_compare(torch):
    """The U-Net at the JAX model's full width, 128 px, float32 with TF32
    off, weights from a seeded generator: eval logits and one Adam step of
    the example's loss on 8 images of ``synthetic_shapes(seed=0)``, on the
    card against the same on the CPU, within ``MNIST_REL_TOL`` each; a 1%
    fault in the largest gradient must read beyond it."""
    from tensorflowonspark_tpu_torch.examples.segmentation.segmentation_spark import synthetic_shapes
    from tensorflowonspark_tpu_torch.models import segmentation

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, masks = synthetic_shapes(SEG_COMPARE_BATCH, SEG_IMAGE, seed=0)
    batch = {"image": images, "mask": masks}

    def run(device, fault=None):
        model = segmentation.create_model(**SEG, generator=torch.Generator().manual_seed(0))
        return _adam_step(torch, model, segmentation.make_loss_fn(model), device, batch, fault)

    start = dict(segmentation.create_model(**SEG, generator=torch.Generator().manual_seed(0)).named_parameters())
    line = _card_vs_cpu(torch, run, start)
    _check_card_vs_cpu({"phase": "seg_compare", "model": "unet", **SEG, "image": SEG_IMAGE, "dtype": "float32",
                        "tf32": False, "batch": SEG_COMPARE_BATCH, **line, "seconds": time.perf_counter() - t0})


def phase_slice_seg(torch, work):
    """The port's segmentation example (BASELINE config 5) through its
    ``main``: ``TFCluster.run`` on one executor trains the full-width U-Net
    for ``SEG_STEPS`` eager steps (batch 64, 128 px, Adam 1e-3) and exports
    a bundle; ``TFParallel.run`` then starts ``SEG_INSTANCES`` instances on
    the card, each segmenting its shard of images. Reads images/s over the
    steps from ``SEG_TIMED_FROM``, the first and last 5 losses (the last
    must be lower), the final pixel accuracy, peak device memory and each
    kernel wrapper's launches in the trainer (0: the U-Net calls none);
    each instance's masks must equal, bitwise, the bundle's ``predict_fn``
    run here on the card on the same shard in one batch, as the instance
    ran it. Returns the launches."""
    import shutil

    import numpy as np

    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.segmentation import segmentation_spark
    from tensorflowonspark_tpu_torch.train import export

    export_dir = os.path.join(work, "seg_bundle")
    shutil.rmtree(export_dir, ignore_errors=True)
    argv = ["--cluster_size", "1", "--base_filters", str(SEG["base_filters"]), "--depth", str(SEG["depth"]),
            "--image_size", str(SEG_IMAGE), "--batch_size", str(SEG_BATCH), "--train_steps", str(SEG_STEPS),
            "--log_steps", "1", "--export_dir", export_dir, "--inference_count", str(SEG_INFER),
            "--inference_instances", str(SEG_INSTANCES), "--instances_per_card", str(SEG_INSTANCES)]
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=SEG_INSTANCES)
    try:
        out = segmentation_spark.main(argv, sc=sc)
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    metrics = out["metrics"]
    steps = sorted((e for e in metrics["events"] if e.get("span") == "train_step"), key=lambda e: e["step"])
    (summary,) = [e for e in metrics["events"] if e.get("span") == "seg_train"]
    losses = [e.get("loss") for e in steps]
    timed = [e["dur_s"] for e in steps if e["step"] >= SEG_TIMED_FROM]
    counters = {k: v["value"] for k, v in metrics["counters"].items()}
    launches = {fn: int(counters.get(fn + "_launches_total", -1))
                for fn in [t[0] for t in KERNEL_TABLE] + [t[0] for t in FLASH_TABLE]}

    args = segmentation_spark.build_parser().parse_args(argv)
    # the instances' processes run with PyTorch's default, TF32 convs
    torch.backends.cudnn.allow_tf32 = True
    predict_fn, params, model_state = export.load_model(export_dir)  # on the card
    instances = []
    for i in range(SEG_INSTANCES):
        images, masks = segmentation_spark.inference_shard(args, i, SEG_INSTANCES)
        direct = predict_fn(params, model_state, {"image": images})
        with np.load(os.path.join(export_dir, "inference-{}.npz".format(i))) as got:
            mask, devices = got["mask"], sorted(set(got["device"].tolist()))
        instances.append({"instance": i, "images": len(images), "devices": devices,
                          "direct_devices": sorted(set(direct["device"].tolist())),
                          "pixel_accuracy": float(np.mean(mask == masks)),
                          "bitwise_equal_direct": bool(mask.shape == direct["mask"].shape
                                                       and np.array_equal(mask, direct["mask"]))})
    line = {"phase": "slice_seg", "model": "unet", **SEG, "image": SEG_IMAGE, "batch": SEG_BATCH,
            "dtype": "float32", "tf32_convs": True, "optimizer": "adam 1e-3", "steps": len(steps),
            "device": summary["device"], "losses": losses, "step_s": [e["dur_s"] for e in steps],
            "images_per_sec_steps_{}_{}".format(SEG_TIMED_FROM, SEG_STEPS): SEG_BATCH * len(timed) / sum(timed),
            "step_ms_median": 1e3 * sorted(timed)[len(timed) // 2],
            "first5_loss": losses[:5], "last5_loss": losses[-5:],
            "final_pixel_accuracy": summary.get("pixel_accuracy"),
            "peak_memory_bytes": summary["peak_memory_bytes"], "launches": launches,
            "inference": instances, "inference_done": out["inference"], "wall_s": wall}
    emit(line)
    if len(steps) != SEG_STEPS or not all(isinstance(v, float) and math.isfinite(v) for v in losses):
        raise AssertionError("slice_seg: expected {} finite losses, got {}".format(SEG_STEPS, losses))
    if not sum(losses[-5:]) < sum(losses[:5]):
        raise AssertionError("slice_seg: the loss did not fall: {} -> {}".format(losses[:5], losses[-5:]))
    if line["device"] != MNIST_DEVICE or any(launches.values()):
        raise AssertionError("slice_seg: trained on {}, kernel launches {}".format(line["device"], launches))
    if sorted(out["inference"]) != list(range(SEG_INSTANCES)) or not all(
            r["bitwise_equal_direct"] and r["devices"] == r["direct_devices"] == [MNIST_DEVICE] for r in instances):
        raise AssertionError("slice_seg: inference {}".format(instances))
    return launches


def phase_estimator_mnist(torch, work):
    """``mnist_estimator.main`` on the card: a chief trains the MLP from the
    feed (one epoch of the example's 2,048 rows) and checkpoints, the
    evaluator (``eval_node=True``) evaluates each new checkpoint on its own
    ``ctx.device``. At least one eval record; the last must come from the
    last checkpoint and its accuracy equal a direct evaluation of that
    checkpoint here on the card."""
    import shutil

    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_estimator
    from tensorflowonspark_tpu_torch.train import checkpoint

    model_dir = os.path.join(work, "estimator")
    shutil.rmtree(model_dir, ignore_errors=True)
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=ESTIMATOR_CLUSTER)
    try:
        records = mnist_estimator.main(["--cluster_size", str(ESTIMATOR_CLUSTER), "--epochs", "1",
                                        "--model_dir", model_dir], sc=sc)
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    latest = checkpoint.latest_checkpoint(model_dir)
    direct = mnist_estimator.evaluate(latest, MNIST_DEVICE, 256) if latest else None
    line = {"phase": "estimator_mnist", "cluster": ESTIMATOR_CLUSTER, "records": records,
            "latest_checkpoint": latest and os.path.basename(latest), "direct_accuracy": direct,
            "seconds": wall}
    emit(line)
    if not (records and records[-1]["checkpoint"] == line["latest_checkpoint"]
            and records[-1]["accuracy"] == direct and all(r["device"] == MNIST_DEVICE for r in records)):
        raise AssertionError("estimator_mnist: {}".format(line))


def trainer_phases(torch, fa, fused_bn, resnet, transformer, here, data_dir, lm_batch):
    """The ResNet and LM slices, the comparisons on their steps and the LM
    server, in this process while :func:`sharded_phases` and
    :func:`host_phases` run beside them. Returns the launch counts (and
    losses) the kernels lines read, by name."""
    n = {}
    n["launches"], _ = phase_slice(torch, fused_bn)
    n["loop_launches"], n["traced_launches"] = phase_slice(torch, fused_bn, LOOP_STEPS, STEPS)
    phase_compare(torch, fused_bn, resnet)
    torch.cuda.empty_cache()
    n["flash_launches"], _, n["lm_losses"] = phase_slice_lm(torch, fa, data_dir, STEPS)
    n["loop_flash_launches"], n["traced_flash_launches"], _ = phase_slice_lm(torch, fa, data_dir, LOOP_STEPS, STEPS)
    phase_compare_lm(torch, fa, transformer, [lm_batch])
    torch.cuda.empty_cache()
    n["defaults_launches"], n["defaults_loop_launches"], n["defaults_traced"] = timed(
        "slice_lm_defaults", phase_slice_lm_defaults, torch, fa, transformer, data_dir)
    torch.cuda.empty_cache()
    for key, width in (("d256", LM_D256), ("d512", LM_D512)):
        name = "lm_" + key
        n[key + "_launches"], n[key + "_loop_launches"], n[key + "_traced"] = timed(
            "slice_" + name, phase_slice_lm_width, torch, fa, transformer, data_dir, lm_batch, width, name)
        torch.cuda.empty_cache()
    phase_compare_loop(torch, resnet, transformer, lm_batch)
    torch.cuda.empty_cache()
    n["pipe_launches"], n["pipe_traced"], n["gpipe_launches"] = timed("pipeline", phase_pipeline, torch, fa,
                                                                      transformer)
    torch.cuda.empty_cache()
    phase_ckpt_engine(torch, resnet, os.path.join(here, "build", "chip_smoke_ckpt"))
    n["pack_launches"], _, n["pack_losses"] = timed("slice_lm_pack", phase_slice_lm, torch, fa, data_dir,
                                                    LM_PACK_STEPS, 1, LM_PACK_WORKERS)
    serve_work = os.path.join(here, "build", "chip_smoke_serve_lm")
    os.makedirs(serve_work, exist_ok=True)
    n["serve_launches"] = timed("serve_lm", phase_serve_lm, torch, fa, lm_batch, serve_work)
    torch.cuda.empty_cache()
    return n


def sharded_phases(torch, fa, fused_bn, here):
    """The LM on its sharded and model axes, the two-rank overlap, the loop
    cache, the recovery and the Spark-fed recovery, in a process of their own
    (:class:`PhaseProcess`). Returns their launch counts by name."""
    data_dir, lm_batch = lm_corpus(here)
    n = {}
    n["fsdp_launches"], n["fsdp_traced"] = timed("slice_fsdp", phase_slice_fsdp, torch, fa, data_dir,
                                                 os.path.join(here, "build", "chip_smoke_fsdp"))
    (n["axes_launches"], n["axes_traced"], n["moe_launches"], n["remat_launches"], n["sp_launches"],
     n["sp_traced"]) = timed("slice_axes", phase_slice_axes, torch, fa, data_dir,
                             os.path.join(here, "build", "chip_smoke_axes"))
    torch.cuda.empty_cache()  # hand the overlap ranks the card's memory
    n["overlap_launches"], n["overlap_traced"] = timed("overlap", phase_overlap, torch, fa, here, lm_batch,
                                                       os.path.join(here, "build", "chip_smoke_overlap"))
    n["cache_launches"], n["cache_traced"] = timed("loop_cache", phase_loop_cache_child, here,
                                                   os.path.join(here, "build", "chip_smoke_loop_cache"))
    recover_work = os.path.join(here, "build", "chip_smoke_recover")
    n["recover_launches"] = timed("recover", phase_recover, torch, fused_bn, recover_work)
    n["ladder_launches"] = timed("ladder", phase_ladder, torch, fused_bn,
                                 os.path.join(here, "build", "chip_smoke_ladder"),
                                 os.path.join(recover_work, "recover_a", "model", "ckpt_{}".format(RECOVER_STEPS)))
    timed("spark_recover", phase_spark_recover, os.path.join(here, "build", "chip_smoke_spark_recover"))
    return n


def host_phases(torch, fa, fused_bn, here):
    """The MNIST, real-data, serving and segmentation phases, whose feeders,
    data planes, clients and small models keep the host busy and leave the
    card idle most of the time, in a process of their own
    (:class:`PhaseProcess`). Returns their launch counts by name."""
    mnist_work = os.path.join(here, "build", "chip_smoke_mnist")
    n = {}
    timed("mnist_compare", phase_mnist_compare, torch)
    bundle, n["mnist_launches"] = timed("slice_mnist", phase_slice_mnist, torch, mnist_work)
    timed("chaos_cluster", phase_chaos_cluster, torch, os.path.join(here, "build", "chip_smoke_chaos"))
    timed("pipeline_mnist", phase_pipeline_mnist, torch, mnist_work)
    timed("parallel_mnist", phase_parallel_mnist, torch, bundle)
    n["real_launches"] = timed("real", phase_real, torch, fused_bn, here,
                               os.path.join(here, "build", "chip_smoke_real"))
    serve_work = os.path.join(here, "build", "chip_smoke_serve")
    os.makedirs(serve_work, exist_ok=True)
    bundle = timed("serve", phase_serve, torch, serve_work)
    timed("infer_cli", phase_infer_cli, torch, here, bundle,
          os.path.join(here, "build", "chip_smoke_real", "eval"), serve_work)
    torch.cuda.empty_cache()
    phase_serving_mesh(here, serve_work)
    seg_work = os.path.join(here, "build", "chip_smoke_seg")
    os.makedirs(seg_work, exist_ok=True)
    timed("seg_compare", phase_seg_compare, torch)
    torch.cuda.empty_cache()
    n["seg_launches"] = timed("slice_seg", phase_slice_seg, torch, seg_work)
    timed("estimator_mnist", phase_estimator_mnist, torch, seg_work)
    return n


def phase_child(name, here, out_path, t0, started):
    """The phases of ``name`` (:func:`sharded_phases` or :func:`host_phases`)
    in a process of their own (``python3 -c 'import chip_smoke;
    chip_smoke.phase_child(...)'``), their lines' ``t_s`` on the script's
    clock (``t0``: the parent's start; ``perf_counter`` is the host's
    monotonic clock), then ``<name>_seconds`` from ``started`` (when the
    parent started this process); writes what they return to
    ``out_path``."""
    global _T0
    _T0 = t0
    import torch

    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops import fused_bn

    got = {"sharded_phases": sharded_phases, "host_phases": host_phases}[name](torch, fa, fused_bn, here)
    emit({"phase": name + "_seconds", "seconds": time.perf_counter() - started})
    with open(out_path, "w") as f:
        json.dump(got, f)


class PhaseProcess:
    """:func:`phase_child` of ``name`` started now, beside this process's
    phases. Its standard output goes to a file that :meth:`join` prints here
    once it has ended, so no line of two processes tears another; its
    errors go to this process's. It stays in this process's group, so what
    ends the script's group ends it too; :meth:`stop` kills it and every
    process under it unless it ended."""

    def __init__(self, here, name):
        self.name = name
        work = os.path.join(here, "build", "chip_smoke_" + name)
        os.makedirs(work, exist_ok=True)
        self.out_path = os.path.join(work, "result.json")
        self.lines_path = os.path.join(work, "lines.out")
        if os.path.exists(self.out_path):
            os.remove(self.out_path)
        self._lines = open(self.lines_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.phase_child({!r}, {!r}, {!r}, {!r}, {!r})".format(
                name, here, self.out_path, _T0, time.perf_counter())],
            cwd=here, stdout=self._lines)
        self._relayed = False

    def _relay(self):
        if self._relayed:
            return
        self._relayed = True
        self._lines.close()
        with open(self.lines_path) as f:
            for line in f:
                print(line.rstrip("\n"), flush=True)

    def join(self, timeout):
        """Wait for the phases; print their lines; return their results, or
        raise if they failed."""
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.stop()
        if rc != 0 or not os.path.exists(self.out_path):
            raise AssertionError("{}: exit {} (their errors are above)".format(self.name, rc))
        with open(self.out_path) as f:
            return json.load(f)

    def stop(self):
        import signal

        if self.proc.poll() is None:
            for pid in [self.proc.pid] + _descendants(self.proc.pid):
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            self.proc.wait()
        self._relay()


def _descendants(pid):
    """The processes under ``pid``, from ``/proc``'s child lists."""
    found = []
    with contextlib.suppress(OSError):
        for task in os.listdir("/proc/{}/task".format(pid)):
            with open("/proc/{}/task/{}/children".format(pid, task)) as f:
                for child in f.read().split():
                    found += [int(child)] + _descendants(int(child))
    return found


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch {} sees no CUDA device; this script runs on the card "
                 "only".format(torch.__version__))
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(here, "tensorflowonspark_tpu_torch", "__init__.py")):
        sys.exit("chip_smoke: no tensorflowonspark_tpu_torch package beside {}; run it from "
                 "the root of a checkout".format(__file__))
    sys.path.insert(0, here)
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.examples.resnet import bench_bn
    from tensorflowonspark_tpu_torch.models import resnet, transformer
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops import fused_bn
    from tensorflowonspark_tpu_torch.parallel import ring_attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    import triton

    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "triton": triton.__version__})

    t0 = time.perf_counter()
    # nvcc builds each CUDA source in a thread of its own while triton
    # compiles the two elementwise BN kernels
    cuda_builds = {"fused_bn": fused_bn.build, "flash_attention": fa.build}
    built = {}

    def build_cuda(name):
        t = time.perf_counter()
        try:
            built[name] = {"library": cuda_builds[name]()}
        except Exception as e:  # re-raised below, in the main thread
            built[name] = {"error": e}
        built[name]["seconds"] = time.perf_counter() - t

    nvcc_threads = [threading.Thread(target=build_cuda, args=(name,)) for name in cuda_builds]
    for t in nvcc_threads:
        t.start()
    for c in (64, 256):
        x = torch.randn(3136, c, device="cuda").to(torch.bfloat16)
        v = torch.ones(c, device="cuda")
        mean, var = fused_bn.bn_stats_plain(x)
        dg, db = fused_bn.bn_bwd_reduce_plain(x, x, mean, var, 1e-5)
        fused_bn.bn_normalize(x, mean, var, v, v, 1e-5)
        fused_bn.bn_bwd_dx(x, x, mean, var, v, dg, db, 1e-5)
    torch.cuda.synchronize()
    for t in nvcc_threads:
        t.join()
    for name in cuda_builds:
        if "error" in built[name]:
            raise built[name]["error"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):  # load and launch each kernel once
        x = torch.randn(8, 130, 64, device="cuda", generator=gen).to(dtype)
        _, lse = fa.flash_fwd(x, x, x, None, 0.125, True, 1)
        fa.flash_bwd_dq(x, x, x, None, x, lse, lse, 0.125, True, 1)
        fa.flash_bwd_dkv(x, x, x, None, x, lse, lse, 0.125, True, 1)
        x = x.view(-1, 64)
        mean, var = fused_bn.bn_stats(x)
        fused_bn.bn_bwd_reduce(x, x, mean, var, 1e-5)
    torch.cuda.synchronize()
    emit({"phase": "build", "kernels": [t[0] for t in KERNEL_TABLE] + [t[0] for t in FLASH_TABLE],
          "seconds": time.perf_counter() - t0, "cache": os.environ.get("TRITON_CACHE_DIR"),
          "cuda_seconds": {name: b["seconds"] for name, b in built.items()},
          "cuda_libraries": {name: b["library"] for name, b in built.items()},
          "cuda_kernels": fused_bn.kernel_resources() + fa.kernel_resources()})

    shapes = bench_bn.bn_shapes(torch, BATCH, IMAGE)
    if len(shapes) != 53:
        raise AssertionError("expected 53 BatchNorm layers, found {}".format(len(shapes)))
    totals = phase_kernel(torch, F, fused_bn, shapes)
    phase_kernel_split(torch, fused_bn, shapes)
    data_dir, lm_batch = lm_corpus(here)
    seg_slice = torch.as_tensor(lm_batch["segment_ids"][:, :-1]).cuda().contiguous()
    flash_totals = phase_flash_kernel(torch, F, fa, seg_slice)
    phase_flash_causal(torch, F, fa)
    ring = timed("kernel_ring", phase_kernel_ring, torch, fa, ring_attention, seg_slice)
    headdim = timed("kernel_headdim", phase_kernel_headdim, torch, F, fa, seg_slice)
    del seg_slice
    torch.cuda.empty_cache()  # hand the trainer child the card's memory
    # the kernels' times are taken: the other phases run from here in three
    # processes side by side, this one and two of their own
    others = [PhaseProcess(here, "sharded_phases"), PhaseProcess(here, "host_phases")]
    try:
        n = trainer_phases(torch, fa, fused_bn, resnet, transformer, here, data_dir, lm_batch)
        for other in others:
            n.update(other.join(timeout=1100))
    finally:
        for other in others:
            other.stop()
    # the same weights on the same packed stream: the eager steps the thread
    # packer fed (slice_lm) and those the pack plane fed
    pack_losses, lm_losses = n["pack_losses"], n["lm_losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(pack_losses, lm_losses))
    emit({"phase": "slice_lm_pack_vs_slice_lm", "losses": pack_losses[:len(lm_losses)],
          "slice_lm_losses": lm_losses, "max_rel_gap": gap})
    if gap > 1e-3:
        raise AssertionError("slice_lm_pack: losses {} against slice_lm's {}".format(pack_losses, lm_losses))
    emit({"phase": "kernels", "kernels": [
        {"name": name, "route": route, "source": source,
         "launched": (n["launches"][name] > 0 and n["loop_launches"][name] > 0 and n["traced_launches"][name] > 0
                      and n["recover_launches"][name] > 0 and n["ladder_launches"][name] > 0
                      and n["real_launches"][name] > 0
                      and n["cache_launches"][name] > 0 and n["cache_traced"][name] > 0)}
        for name, _, _, _, route, source in KERNEL_TABLE] + [
        {"name": name, "route": "cuda", "source": FLASH_SOURCE,
         "launched": (n["flash_launches"][name] > 0 and n["loop_flash_launches"][name] > 0
                      and n["traced_flash_launches"][name] > 0 and n["pack_launches"][name] > 0
                      and n["defaults_launches"][name] > 0 and n["defaults_loop_launches"][name] > 0
                      and n["defaults_traced"][name] > 0
                      and n["fsdp_launches"][name] > 0 and n["fsdp_traced"][name] > 0
                      and n["axes_launches"][name] > 0 and n["axes_traced"][name] > 0 and n["moe_launches"][name] > 0
                      and n["remat_launches"][name] > 0 and n["sp_launches"][name] > 0 and n["sp_traced"][name] > 0
                      and ring["launches"][name] > 0 and ring["traced"][name] > 0
                      and n["pipe_launches"][name] > 0 and n["pipe_traced"][name] > 0 and n["gpipe_launches"][name] > 0
                      and n["overlap_launches"][name] > 0 and n["overlap_traced"][name] > 0
                      and (name != "flash_fwd" or n["serve_launches"][name] > 0))}
        for name, *_ in FLASH_TABLE] + [
        {"name": name + "_" + key, "route": "cuda", "source": FLASH_SOURCE,
         "launched": (n[key + "_launches"][name] > 0 and n[key + "_loop_launches"][name] > 0
                      and n[key + "_traced"][name] > 0)}
        for key in ("d256", "d512") for name, *_ in FLASH_TABLE], "script_s": time.perf_counter() - t_start})
    wide = {(key, name): headdim[name]["{}_bfloat16".format(key[1:])]
            for key in ("d256", "d512") for name, *_ in FLASH_TABLE}
    emit({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": n["launches"][name], "launches_loop_path": n["loop_launches"][name],
         "device_launches_traced_loop_call": n["traced_launches"][name],
         "launches_recover_path": n["recover_launches"][name],
         "launches_ladder_last_life": n["ladder_launches"][name],
         "launches_mnist_path": n["mnist_launches"][name],
         "launches_slice_real": n["real_launches"][name],
         "launches_segmentation": n["seg_launches"][name],
         "launches_loop_cache": n["cache_launches"][name],
         "device_launches_loop_cache_traced_window": n["cache_traced"][name],
         "max_abs_err": totals[name]["max_abs_err"],
         "ms": totals[name]["ms"], "plain_ms": totals[name]["plain_ms"],
         "bound_ms": totals[name]["bound_ms"], "bound_by": totals[name]["bound_by"],
         "library_ms": totals[name]["library_ms"],
         "per": "ResNet-50 step, batch {}, {} px, bf16: sum over its 53 BatchNorm "
                "layers".format(BATCH, IMAGE)}
        for name, replaces, _, _, route, source in KERNEL_TABLE] + [
        {"name": name, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
         "launches": n["flash_launches"][name], "launches_loop_path": n["loop_flash_launches"][name],
         "device_launches_traced_loop_call": n["traced_flash_launches"][name],
         "launches_mnist_path": n["mnist_launches"][name],
         "launches_slice_lm_pack": n["pack_launches"][name],
         "launches_fsdp": n["fsdp_launches"][name], "device_launches_fsdp_traced_call": n["fsdp_traced"][name],
         "launches_axes_tp": n["axes_launches"][name], "device_launches_axes_tp_traced_call": n["axes_traced"][name],
         "launches_axes_moe": n["moe_launches"][name], "launches_axes_remat": n["remat_launches"][name],
         "launches_axes_sp": n["sp_launches"][name], "device_launches_axes_sp_traced_call": n["sp_traced"][name],
         "launches_lm_defaults": n["defaults_launches"][name],
         "launches_lm_defaults_loop": n["defaults_loop_launches"][name],
         "device_launches_lm_defaults_traced_call": n["defaults_traced"][name],
         "headdim": headdim[name],
         "launches_ring": ring["launches"][name], "device_launches_ring_traced": ring["traced"][name],
         "ring_hop_max_abs_err": ring["max_abs_err"][name],
         "ring_hop_ms": {kind: dict(ring["hop_ms"][kind][name], pairs=ring["hop_ms"][kind]["pairs"])
                         for kind in ("diagonal", "off_diagonal")},
         "launches_segmentation": n["seg_launches"][name],
         "launches_pipeline_1f1b": n["pipe_launches"][name],
         "device_launches_pipeline_1f1b_traced": n["pipe_traced"][name],
         "launches_pipeline_gpipe": n["gpipe_launches"][name],
         "launches_overlap": n["overlap_launches"][name],
         "device_launches_overlap_traced_step": n["overlap_traced"][name],
         **({"launches_serving": n["serve_launches"][name]} if name == "flash_fwd" else {}),
         "max_abs_err": flash_totals[name]["max_abs_err"],
         "ms": flash_totals[name]["ms"], "plain_ms": flash_totals[name]["plain_ms"],
         "bound_ms": flash_totals[name]["bound_ms"], "bound_by": flash_totals[name]["bound_by"],
         "library_ms": flash_totals[name]["library_ms"],
         "per": "transformer LM step, batch {}, seq {}, bf16, causal with packed segments: "
                "sum over its {} attention layers".format(LM_BATCH, LM_SEQ, LM["n_layers"])}
        for name, replaces, *_ in FLASH_TABLE] + [
        {"name": name + "_" + key, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
         "instance": ("{}_wgmma_kernel<256, 2>" if key == "d256" else "{}_split_wgmma_kernel").format(name),
         "launches": n[key + "_launches"][name], "launches_loop_path": n[key + "_loop_launches"][name],
         "device_launches_traced_loop_call": n[key + "_traced"][name],
         "max_abs_err": wide[key, name]["max_abs_err"],
         **{k: LM["n_layers"] * wide[key, name][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "bound_by": wide[key, name]["bound_by"], "library": wide[key, name]["library"],
         "per": "transformer LM step at {} head(s) of {}, batch {}, seq {}, bf16, causal with packed segments: "
                "sum over its {} attention layers".format(width["n_heads"], width["d_model"] // width["n_heads"],
                                                         LM_BATCH, LM_SEQ, LM["n_layers"])}
        for key, width in (("d256", LM_D256), ("d512", LM_D512)) for name, replaces, *_ in FLASH_TABLE]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
