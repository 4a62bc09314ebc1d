#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fraud_detection_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi) beside torch's device name;
2. build every CUDA kernel from ``fraud_detection_tpu_torch/ops/csrc`` into
   ``build/torch_kernels/`` (one nvcc per source, all started together),
   print each one's ``-Xptxas -v`` report, build the native host featurizer
   with g++ into ``build/native/``, and run the kernels' self-tests
   on hand-reckoned inputs (the histogram's on uint8 and int32 bins, under
   plans that split the pairs into node groups and tree groups and the rows
   into chunks; the featurize kernel's two entries on hand-reckoned rows, an
   overflow row among them; the int8 product's on exact small integers);
3. each kernel against its plain torch version on the same CUDA tensors:
   ``featurize_packed`` (the serving path's one featurize kernel) bit for
   bit, packed output and unique counts, two launches bit-equal, on
   synthetic-corpus rows at W=2048, the adversarial strings and a seeded
   fuzz (padding rows included), rows past 256 unique buckets, the fuzz at
   W=8 and rows at W=16,384, in both hash modes, ``binary`` on and off,
   with the English stop table and one holding "", and at 32 slots (the
   plain version's scan, a launch per small op on the card, runs on a host
   copy of the same bytes; at W=16,384 in a process of its own started
   before the build, which hands back the bytes' SHA-256 with it); the
   stream entry ``featurize_scan`` exactly (corpus, adversarial, fuzz,
   both hash modes); the tree histogram (int path equal,
   f32 path within 1e-5 of the largest cell, two launches bit-equal, T=1
   and T=8, uint8 bins as the trainer passes them and int32 bins, the two
   bit-equal) and ``best_splits`` (indices equal, gains bit-equal, gini and
   xgb, a ragged feature tile, an all-invalid node) at the training CLI's
   shape (1,120 x 10,000, the real TF-IDF bins) and at the bench shape
   (100,000 x 2,048, zero-inflated bins); both again at every level width
   L in {1, 2, 4, 8, 16} at the CLI shape (the histogram for the xgb, dt
   and 8-tree forest levels, each width its own plan, on both bin widths;
   ``best_splits`` on the xgb and dt levels it reads); the weight-only int8
   product ``w8_matmul`` at every Gemma-2B weight shape (wq/wo, wk/wv,
   w_gate/w_up, w_down in the kn layout, the head in nk) at M in {1, 8, 35,
   64, 512, 2048}, and at a ragged M, N and K in both layouts, bf16 (within
   two bf16 steps plus 2^-15 of the output's sum of |x q| times its scale)
   and f32 (1e-5 of max |y|), two launches bit-equal, rows [5, 29) of an
   M = 64 and an M = 2048 launch equal to a launch of those rows alone (the
   kernel picks another block shape for each), and across the dispatch's
   boundaries rows [0, 8) of M = 2048 (128-row blocks, the K splits added
   in registers) equal to an M = 8 launch (8-row blocks, the splits in
   blocks of their own and a second pass) and its row 0 to an M = 1
   launch; the ragged shapes' plans split K with a ragged last split;
4. the serving slice at full width (HashingTF(10000)+IDF, W=2048, L=256,
   B=256; LR fp32, LR int8 and a depth-5 20-tree forest made from --seed)
   on ``cuda`` with device featurization, against the same pipeline on the
   CPU: labels equal and |dp| <= 1e-6;
5. the streaming engine over 4,096 seeded messages (malformed ones
   included): output keys exactly the fed keys, malformed count exact,
   every label equal to ``pipeline.predict`` on its text; phases 4-5 must
   launch ``featurize_packed`` once per chunk the card pipelines dispatch
   and never the stream entry, whose own path
   (``tokenize_hash`` over phase 4's texts, a call a chunk) follows;
5b. the serve CLI's default path (phase 2 built the native host
   featurizer, ``featurize/native.py``, printing the g++ command; a library
   that does not build or load fails the run with the compiler's message):
   the host-featurize pipelines (LR fp32, LR int8, the forest) on the card
   against the CPU (labels equal, |dp| <= 1e-6) and against phase 4's
   device-featurize pipelines (labels equal), their raw-JSON path equal to
   ``predict``; the engine over phase 5's messages on the raw-JSON path
   with native frames (``_json_fast`` and ``_frames_ok`` True), sync and
   with the dispatch lane: keys exact, wires byte-identical, labels equal
   ``predict``; the scheduler's overload case (out + DLQ keys == fed,
   shed > 0); no ``featurize_packed`` launch in any of it. Then the serve
   CLI (``app/serve.py main``, ``--demo 4096 --batch-size 1024``) on a
   checkpoint of the seeded LR that ``save_checkpoint`` writes: host
   featurize (no ``featurize_packed`` launch, the raw-JSON path and native
   frames), ``--featurize-device`` (one launch per chunk dispatched) and
   ``--async-dispatch --int8``: each exits 0 and classifies every message;
5c. serving that survives faults and can be watched, on that checkpoint
   under device featurize: the engine (batch 256, a DLQ, sync dispatch)
   supervised by ``run_supervised`` over 4,096 seeded messages (malformed
   ones included) under ``tests/test_chaos.py``'s mixed fault plan at seed
   42 (200 faults at most): every key in out ∪ DLQ, no commit past a lost
   output, restarts, injections and lost records > 0, every delivered
   label equal to ``predict``, one ``featurize_packed`` launch a chunk
   dispatched across incarnations, a second run and a run on the dispatch
   lane byte-identical, the CPU run on the host-featurize pipeline with the
   same fault report and stream (confidence within two last digits), no
   thread left
   and device memory within 1 MB of a clean warm-up run; then the serve
   CLI with ``--featurize-device --chaos --chaos-seed 7 --trace --alerts
   --incident-dir --metrics-file --health-file --profile-dir
   --profile-batches 4``: exit 0, every key classified, restarts and the
   chaos report, exact span accounting, the Prometheus file covering every
   health leaf, the final health file, incidents equal to bundles, the
   ``torch.profiler`` trace holding 1 to (chunks dispatched)
   ``featurize_packed`` kernel events; and the CLI's msgs/s with and
   without ``--trace --alerts --metrics-file``, in turns;
5d. the fleet (``fleet/``): N worker threads sharing ONE pipeline on the
   card, on that checkpoint under device featurize, 8,192 seeded messages
   (malformed ones included) over 4 partitions, batch 256. Three workers
   under ``Fleet.in_process``: every key classified exactly once, the
   malformed count exact, every label equal to ``predict``, and
   ``featurize_packed`` launches equal to the chunks dispatched summed over
   the workers; the same drain on phase 4's forest; a seeded worker death
   (``WorkerDeathPlan(seed=5, kills=1)``: zero lost or duplicated keys,
   each source partition in order, a death and rebalances); a coordinator
   kill under 2 candidates (keys exact, term >= 2, a handoff); the CPU twin
   on the host-featurize pipeline (labels equal per key, |dp| <= 1e-6);
   the serve CLI's ``--fleet 3 --partitions 4 --demo 8192`` on host and on
   device featurize (launches equal the chunks), ``--workers 3
   --partitions 3`` and ``--fleet 2 --autoscale --min-workers 2
   --max-workers 3 --fleet-health-file --alerts`` (the final health file
   and the stats JSON carry the reference's autoscale block): each exits 0
   with every message classified; then no fleet thread alive and device
   memory within 1 MB of the warm-up. Printed beside the card: msgs/s at 1,
   2 and 3 workers, ``os.cpu_count()`` and the 3-worker drain's
   device-idle share;
5e. the game days (``scenarios/``): all 12 catalog scenarios at seed 0 and
   their own sizes (449-8,120 rows, 28,001 in all), each on the game-day
   pipeline (``_default_pipeline``: 2,048 features, the scenario's model)
   under device featurize, warp-fed but for the two that declare real-time
   pacing (diurnal_tide_scale, flash_crowd_scale): every SLO verdict
   passes, the accounting SLO among them (out ∪ DLQ keys equal the
   timeline's), but for the paced days' three autoscale-decision gates,
   which race the reference's own scale policy at the same rate in both
   packages and are printed, not gated; the feeder walks the JAX
   package's timeline (its SHA-256 and row count) and feeds every row;
   ``featurize_packed`` launches equal the chunks every device-featurize
   pipeline of the run dispatched (the hot-swap candidate's and all fleet
   workers' included); the succession game days' control-lane journals
   conform to the role machines (0 violations); drift_shift refreshes at
   least once, its xgb fit and each refresh launching the histogram and
   ``best_splits`` once per split level of every round; then a profiled
   flash_crowd (device-idle share), ``serve --scenario diurnal_hotkey:0
   --trace-record`` on phase 5c's checkpoint (exit 0, the scenario block
   ok, fed == planned, a complete recording, launches = chunks), ``serve
   --scenario flash_crowd:0`` without shed flags (exit 4,
   admission_shed_bit failed) and ``python -m
   fraud_detection_tpu_torch.scenarios.replay`` of the recording on the
   card (exit 0, keys_exact); no flash launch over the phase, no thread of
   it left, device memory within 1 MB of its start. Each run's wall and
   msgs/s are printed;
6. the training slice at full width (the CLI's 1,600-dialogue synthetic
   corpus, HashingTF(10000), depth 5, 32 bins), card against CPU: dt and a
   16-tree rf (JAX's threefry draws, made on each device) equal tree for
   tree, 16-round xgb within 1e-4 in p;
6b. the L-BFGS logistic-regression fit (``models/train_linear.py``) at the
   CLI's width, card against CPU: validation and test labels equal, the
   iteration counts side by side, the card fit's wall, loss evaluations,
   host reads and byte bound (evaluations x 2 reads of X at 3.35 TB/s);
   then at the JAX bench's shape (100,000 x 2,048 f32 made on the card):
   the loss below ln 2, finite weights, wall, evaluations, bound and a
   profiler breakdown;
7. the training CLI on the card at its defaults (dt, rf 100 trees, xgb 100
   rounds, lr): dt's and rf's metrics equal the JAX package's recorded ones
   (reports/metrics.json); lr's accuracy and confusion equal them on both
   splits, its AUC printed beside the recorded one and within 0.01; the
   saved dt served by ``ServingPipeline.from_checkpoint`` gives the dense
   ``predict`` labels; ``--publish lr=<root>`` then
   ``ModelRegistry(root).verify(1)`` and ``.load(1, device="cuda")``
   serves the dense ``predict`` labels, its manifest carrying the report's
   metrics; the same run saves lr natively too and exports lr, rf and xgb
   with ``--save m=spark:<dir>`` (phase 7k serves them);
7b. the serve CLI on that dt checkpoint, host featurize and
   ``--featurize-device``, with phase 5b's gates;
7c. resume: the CLI's rf and xgb interrupted at 30 trees / rounds
   (``--checkpoint-dir``) and resumed to 100 save checkpoints equal to
   phase 7's array for array (the forest's snapshot is off its chunk grid
   and is rebuilt from tree 24); both tree kernels must launch;
7d. ``--featurizer count --models lr --save lr=...``: the vocabulary
   checkpoint served on host featurize gives the dense ``predict`` labels
   and the CLI's test confusion, launches no featurize kernel, and
   ``featurize_device=True`` refuses it;
7e. ``serve --model synthetic --demo 4096 --batch-size 1024`` (an LR
   trained at startup), host featurize and ``--featurize-device``, with
   phase 5b's gates;
7f. the model lifecycle: phase 7's xgb100 checkpoint published as v1 of a
   fresh registry and served (``HotSwapPipeline``, raw JSON, batch 512) by
   the engine with a ``ShadowScorer``, a ``LearnLoop`` (``LearnConfig``
   defaults, its own thread and CUDA stream) and a ``LifecycleController``
   on its watcher thread, over 4,096 messages of the serve demo's corpus
   with 256 ``drift_scam_pool`` rows among them, their labels on a
   feedback topic: every key out once in partition order; the lane
   publishes v2 (trigger drift), its refresh launching ``histogram.cu``
   and ``best_splits.cu`` once per split level of every round; the
   controller stages, shadow-scores and promotes it (audit order, no load
   failure, no lane fault); the live model then flags > 90% of a fresh
   drift pool. The lane's window refreshed on the card and on the CPU:
   new trees equal, p within 1e-4, and equal to the published v2's; the
   same for a two-class window (all 4,096 scored rows with their ground
   truth, at the 4,096 rung), whose refresh flags <= 10% of its legit rows
   (its wall and device idle printed). The
   primary's msgs/s and p99 with the lanes off, during back-to-back
   refreshes and with the lanes on, the refresh's wall and device idle
   share, the prewarm wall, the pointer swap and shadow rows/s are printed.
   Then ``serve --registry --watch --shadow --promote-policy --learn
   --demo 4096 --batch-size 1024``, a thread publishing v2 once the first
   batch is delivered: exit 0, every message classified, the stage in the
   stats JSON's lifecycle block;
7g. Kafka: ``serve --kafka`` on phase 5b's LR checkpoint (batch 1,024) over
   4,096 seeded messages (malformed ones included) on 3 partitions of a
   stand-in broker (``tests/torch_fake_kafka.py`` ``FakeCluster`` behind
   the ``confluent_kafka`` client surface; there is no librdkafka here):
   every fed key out once, each partition's committed offset its last
   offset + 1; host featurize on the raw-JSON path with native frames and
   no ``featurize_packed`` launch, in turns with ``--demo`` (kafka, demo,
   demo, kafka); ``--featurize-device`` with one launch per chunk; a
   ``KafkaControlBus`` round trip over the compacted control topic;
7h. mesh serving: ``MeshServingPipeline`` over the local devices (one
   card: the plain pipeline, byte-identical, ``mesh_devices`` 1); a virtual
   mesh of 4 shards on cuda:0 (per-chip 256, global 1,024, device
   featurize at W=2,048, 256 slots) against the single-device card
   pipeline (labels equal, |dp| <= 1e-6), ``featurize_packed`` launches =
   chunks x 4, every prewarmed rung a multiple of 4, the engine over it
   (keys exact, launches = chunks x 4), no plain featurize, rows/s in turns
   with the single-device pipeline; ``serve --mesh --featurize-device
   --demo 4096``;
7i. data-parallel training: the training CLI at its defaults with
   ``--mesh`` (dt's metrics equal the recorded run's, lr's as phase 7
   gates them, rf's and xgb's printed: a mesh forest draws over its padded
   rows, as the reference's mesh path does); on a virtual mesh of 4
   shards on cuda:0, dt at the CLI shape equal to the card's
   single-device fit, xgb5 on the reference's mesh-test data (301 x 6)
   within its 1e-4 in p, xgb8 at the CLI shape within the same 1e-4 of
   the card's single-device fit and equal to the same mesh fit on the
   CPU, each fit
   launching the histogram shards x levels x trees times and
   ``best_splits`` levels x trees, no plain tree version run;
7j. with two or more cards, a 2-process NCCL rendezvous (global batch and
   data-axis sum across the processes); with one card, a line saying it
   was not run and why;
7k. Spark artifacts (``checkpoint/spark_artifact.py``, ``spark_writer.py``
   on the port's parquet codec, ``checkpoint/parquet.py``): phase 7's
   Spark exports read back (read and write walls, host clock, and the
   sizes on disk), each served by ``from_spark_artifact`` on the card with
   the native checkpoint's labels and |dp| <= 1e-6 (xgb exported as GBT:
   1e-5) on 2,048 texts; ``serve --model spark:<dir>`` with phase 5b's
   gates for each, host featurize and ``--featurize-device`` (launches =
   chunks), the Spark LR in turns with the native LR on host featurize;
   the committed fixture ``tests/data/torch_spark_fixture`` (bytes pyarrow
   wrote, in Spark's column types): the JAX package's recorded labels and
   |dp| <= 1e-6, on host featurize and under device featurize (launches =
   chunks); a HashingTF(262,144) + IDF + LR artifact written by the port:
   card against CPU on host featurize (labels equal, |dp| <= 1e-6, two
   uploads a chunk), ``serve`` on it, and ``--featurize-device`` refused
   with the reference's message; the front end: ``build_agent`` over
   ``FRAUD_MODEL_PATH=spark:<lr dir>`` with the canned backend on the card
   and ``start_monitor`` over its 500 demo messages: every tapped label
   equals ``pipeline.predict`` on its text, no ``featurize_packed``
   launch, the monitor thread stopped;
7l. flightcheck and the sanitizer builds, on the host, one subprocess a
   step, all started together, one line each with its seconds:
   ``python -m fraud_detection_tpu_torch.analysis --json`` on the port's
   tree (exit 0, no finding; the suppressed and file counts printed);
   ``analysis model --json``, default and ``--autoscale`` (exit 0, states
   and transitions equal to the counts tests/test_torch_model_checker.py
   pins); ``--autoscale --mutate release_before_drain`` (exit 1, its trace
   naming ``revoke_barrier``); ``--liveness`` (exit 0, the pinned SCC
   count); the ASan+UBSan and TSan builds of the native featurizer (host
   g++, ``build_variant``), each driving ``native/san_driver.py`` with its
   runtime preloaded (exit 0, "all checks passed", no sanitizer report). A
   variant whose runtime the host's gcc lacks is said so, naming that gcc;
   one whose runtime is present but that fails to build or run fails the
   run;
8. timings (CUDA events, median of >= 10 after warm-up; of 3 to 10 for
   the plain versions, which take up to seconds a call) of each kernel, its
   plain version and its library call where one exists (both featurize
   entries in turns with their profiler device time, beside the first scan
   kernel's recorded 1.1390 ms; the histogram at
   four shapes on uint8 and int32 bins, each with its own byte bound, beside
   ``index_add_`` and the first kernel's recorded time; both tree kernels
   at every level width of the CLI's fits, with their device time from the
   profiler and their sums per xgb100, rf100 and dt fit); pipeline rows/s
   (device featurize and native host featurize in turns) and the host
   encode alone, engine msgs/s (raw JSON with native frames, the slow
   path, device featurize, the dispatch lane; in turns), the serve CLI's
   msgs/s and the fits' walls (CLI shape and bench shape) on the host
   clock, each pipeline's and engine run's device idle share (device time
   over the wall of the same profiled call); profiler breakdowns of
   ``featurize_bytes`` (one launch a call, and the one kernel in its
   trace) and of a DT fit;
9. the flash-attention kernels against their plain version: the sm90
   route (bf16, wgmma) at the prefill shape (1, 2048, 8, 256) with one K/V
   head and at ragged bf16 shapes (B=2, T in {1, 64, 127, 1000, 2049}, d in
   {64, 128, 256}, 1, 2 or 4 K/V heads over 4); the SIMT route at f32
   ragged shapes with GQA and at phase 11's shape (1, 600, 8, 256) with one
   K/V head; native-width K/V bit-equal to expanded, two launches
   bit-equal, on every shape;
10. the explanation LLM from a checkpoint: a Hugging Face checkpoint of
   the Gemma-2B architecture (18 layers, bf16 weights N(0, 0.02) drawn on
   the card from --seed, Gemma's zero norms) written into a temporary
   directory (removed afterwards) and loaded by ``load_hf_checkpoint``:
   bf16 from the shards, again from the bf16 cache, int8 (the int8 miss,
   from the bf16 cache) and again from the q8 cache, each load's source
   gated and its wall printed; the int8 params equal ``quantize_params`` of
   the bf16 model on the card bit for bit; one int8 decode step launches
   ``w8_matmul`` 7 x 18 + 1 times; int8 logits against the same model
   through the plain product within 5% of max |logit|, and against bf16
   correlated above 0.999 at full width and 2 layers (18 layers reported);
   prefill at T=2048, bf16 and int8 in turns. Then the bf16 model's
   prefill: ``forward`` at T=2048 through the flash kernel (18 launches, all
   on the sm90 route) against the chunked path, prefill tokens/s at T=2048
   and 8192, and a profiler breakdown;
11. card against CPU at Gemma widths, 2 layers, f32, T=600 (the SIMT
   route's path: 2 launches): last logits within 5e-4, and greedy batched
   generation equal (and equal to B=1); sampled generation at temperature
   1.0, card against CPU, rows equal reported (the logits differ by up to
   5e-4, so a near-tie may flip a token; not gated); the same model with
   int8 weights, card (``w8_matmul``'s SIMT route, 15 launches) against
   CPU: last logits within 5e-4, greedy tokens equal;
12. greedy generation at full width (bench.py's 8 prompts, 64 new tokens):
   tokens/s and explanations/s; rows equal to B=1 calls is reported (bf16
   GEMMs of other shapes may round apart; phase 11 is the gate); the token
   choice at B=8 x 256,000, greedy against sampled; then bf16 and int8 in
   turns (bf16, int8, int8, bf16): tokens/s, explanations/s, peak device
   memory over the model, the int8 run's ``w8_matmul`` launches (a positive
   multiple of 127);
12b. tensor parallelism at full width: ``w8_matmul`` at the 4-way
   shard shapes and flash at the head group's shape (1, 2048, 2, 256)
   against their plain versions; phase 10's model and its int8 copy split
   over a 4-way virtual model axis of cuda:0 (``shard_params``); a T=2048
   prefill at bf16 and int8 against one device's last logits (within 5%
   of their max), flash 72 launches (layers x shards, all sm90) and
   ``w8_matmul`` 397 (18 x 22 + the head) at int8; greedy tokens of 4
   prompts x 16 equal one device's, or part only at a near tie (the two
   tokens' logits at most twice the TP logit difference apart); TP prefill
   time against one device's in turns;
12c. sequence parallelism at full width: ``forward(seq_mesh=)`` over a
   4-way virtual "seq" axis, ring and Ulysses, T=2048, against the plain
   forward's last logits (within 5%), no flash launch; times;
12d. head-sharded KV caches at the Llama-3-8B architecture (hidden 4,096,
   32 heads, 8 K/V heads of 128, FFN 14,336, vocab 128,256, 32 layers,
   untied; random N(0, 0.02) weights), bf16 then int8, over a 4-way virtual
   model axis of cuda:0: every layer's k and v 4 parts of 2 K/V heads, each
   1/4 of the cache's bytes, on its shard's device; a cached prefill at
   T=512 against one device's last logits (within 5%); batched generation,
   a slot window and a paged window (a shared prefix, copy-on-write
   admits), 4 prompts x 16 tokens each, tokens equal one device's or
   parting only at a near tie; 0 flash launches, ``w8_matmul`` a multiple
   of a TP forward's 897 at int8 only; the decode step at B=8 with the
   cache on the first device against per part;
13. the streaming engine with ``explain_batch_fn`` over the on-device
   model (1,024 messages, ~5% scam, the CLI's dt as classifier, batch
   512, 48 new tokens): keys exact, ``analysis`` on exactly the flagged
   rows; msgs/s with and without the hook, flagged explanations/s;
13b. the slot programs (``models/llm.py`` slot and paged decode,
   ``explain/slotserve/decode.py``) at Gemma widths, 2 layers, f32 (phase
   11's model), card against CPU, driven by ``SlotServeService``'s own
   scheduler: five prompts through 2 slots (slot reuse), windows of 4:
   greedy tokens equal card/CPU and equal to each row's
   ``generate_tokens_batch``; the paged service (the shared preamble
   prefilled once, copy-on-write admits) equal to the contiguous one window
   for window, bit for bit (out, new_lens, steps_run, active_row_steps);
   the repeated prompt in a reused slot equal to its first decode; no page
   leaked; sampled rows at temperature 1.0 card vs CPU reported;
13c. ``SlotServeService`` at full width (phase 10's model, 8 slots, 48 new
   tokens, max_len 512), contiguous, then paged (page 64, the shared
   preamble, a 37-page pool), over the first SLOT_LANE_ROWS of phase 13's
   flagged rows and bench.py's 8 prompts: every request completed, ``admitted == completed + dropped``,
   0 leaked pages, paged replies equal to contiguous; tokens/s,
   explanations/s, occupancy, latency, ``kv_bytes`` and the saving, and
   the peak device memory of each mode; one window's host syncs (sync
   debug mode) and device-idle share; then the int8 model: phase 13b's
   prompts through 2 slots, paged windows == contiguous bit for bit, and
   the slot lane at full width, contiguous and paged, with the same gates;
13d. phase 13's stream with ``explain_async=True`` and
   ``make_slot_explain_hook`` over the service: keys exact, no frame
   carries analysis, exactly one annotation record per flagged row, each
   an explanation; the service decoded every flagged row with no fault,
   error or drop;
   msgs/s and flagged explanations/s beside phase 13's inline figures;
13e. ``serve --model synthetic --explain onpod-demo --explain-slots 4
   --explain-tokens 8 --demo 4096 --batch-size 1024``, contiguous and
   with ``--explain-paged --breaker 3``: exit 0, every message classified,
   the stats JSON's ``explain`` block with ``admitted == completed +
   dropped`` and no errors;
13f. ``serve --model synthetic --explain onpod-int8:<dir> --explain-slots 4
   --explain-tokens 8 --demo 4096 --batch-size 1024`` on a 2-layer
   Gemma-width checkpoint: with ``transformers`` on the machine (and a
   word-level tokenizer written into the directory) it exits 0 with phase
   13e's gates; without it the CLI must refuse with the reference's "cannot
   load ... tokenizer" message; either way ``--explain onpod:/nowhere``
   refuses with "checkpoint dir ... not found";
14. flash times at T=2048 and 8192, in one run on one card: the sm90
   kernel and the SIMT kernel on the same bf16 inputs (in turns: sm90,
   SIMT, SIMT, sm90), ``scaled_dot_product_attention`` (the library
   yardstick), the plain version, and the bound; the same four for the
   SIMT kernel at phase 11's f32 shape; ``w8_matmul`` at each Gemma-2B
   shape at decode (M=8) and prefill (M=2048), in turns with cuBLAS bf16
   ``torch.matmul`` on a bf16 copy of the weight (the yardstick, never
   called by the port for int8), its plain version and its bound, and a
   decode step's sum over its 127 products; the f32 route at M=8;
14b. the LLM trainer (``models/train_llm.py``), in a process of its
   own with ``torch.use_deterministic_algorithms(True)``: at full Gemma-2B
   width, 18 layers, bf16, B=8, T=128, a step's time, tokens/s, peak memory
   and a profiler breakdown, losses finite and the last below the first;
   at 2 layers, ``fit_language_model`` cut after 2 of 4 steps and resumed
   equals the uninterrupted fit array for array (params and optimizer
   state: the two snapshots); a 2-layer f32 fit (Gemma's quirks at D 512)
   on the card against the CPU, losses within 1e-4;
14c. mesh fine-tuning: 2-layer full-width f32 fits on virtual (data 2,
   model 2) and (data 2, seq 2) meshes of cuda:0, losses within 3e-4 of
   the one-device fit;
14d. with two cards or more, the same fits by two NCCL processes of one
   card each over ("data",), ("model",) and ("seq",) (ring and Ulysses)
   meshes across them, against this process's fit on the same cards
   (losses within 3e-4, step times side by side); with one card the line
   says it did not run (``scripts/llm_mesh_phases.py`` runs it on 2 and 4
   cards);
14e. the seven example twins (``examples/torch_*.py``: the serve and
   streaming quickstarts, the train quickstart, the HF checkpoint demo at
   bf16 and ``--int8``, the hot swap, the drift loop and the game day) run
   in this process on ``cuda`` at their JAX examples' sizes, one line each
   with its wall and launch counts: every exit code 0; no featurize_packed
   or flash launch; the train twin's histogram and best_splits launches
   each equal levels x rounds; the drift day's tree kernels once a split
   level each; ``w8_matmul`` only under ``--int8``, a multiple of an int8
   forward's launches; and each twin's values equal those of its run on
   the host under ``--device cpu``, made after the card's runs in this
   process: labels, counts and metrics equal, p within the stated bound
   (the streaming demo's every row), the HF
   replies equal or parting only at a bf16 tie of the host model's
   logits; the hot swap delivers every message once on both, its
   timing-dependent promotion printed;
15. a ``{"kernels": [...]}`` line (eight entries: featurize_packed, the
   stream entry, histogram, best_splits, both flash routes, both
   ``w8_matmul`` routes), then the last line
   ``{"ok": true, "device": {...}}``.

Launch counts are reset just before each main path (serving: phases 4-5;
the stream entry: the pass after phase 5; ``featurize_packed`` again
before phase 5b's host pipelines, before phase 5c's supervised run, before
phase 5d's 3-worker drain, before each phase 5e game day and before each
serve CLI run; the tree kernels before phase 5e's drift_shift pipeline fit
and again before its run;
training: phase 7, the CLI, and phase 7c, the resume; the learn lane's
refresh: phase 7f's lifecycle run; ``featurize_packed`` again around each
``--kafka`` run, the virtual-mesh predict, its engine run and ``serve
--mesh``, and the tree kernels around each virtual-mesh fit (phases
7g-7i); ``featurize_packed`` around each phase 7k serve run, fixture
predict and the front end's monitor run; the LLM prefill: one T=2048 forward in phase
10, for the sm90 flash kernel; the f32 forward of phase 11, for the SIMT
flash kernel and, at int8, for ``w8_matmul``'s SIMT route; one int8 decode
step and phase 12's int8 generation, for ``w8_matmul``; each of phase
12b's TP prefills and its int8 TP generation, for flash and
``w8_matmul``; each of phase 12c's SP forwards, for flash; each of phase
12d's TP cache programs, for flash and ``w8_matmul``; every kernel's
count around each example twin of phase 14e) and read just after it. The flash counts are reset before phase 5e and must read 0 after it
(the game days launch no flash kernel, as in the reference), and again
before phase 13b and must read 0 after phase 13f: the slot lane runs no
kernel of the table (its prefill is ``causal_attention(use_flash=False)``
and its decode ``_attend``, as in the reference). It imports nothing of
JAX or of ``fraud_detection_tpu``.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
SCAN_OPS_PER_ELEMENT = 30   # compare/select/shift/or per (row, column) step

# The adversarial strings of the JAX package's device-featurize tests.
ADVERSARIAL = [
    "hello world hello",
    "",
    "   ",
    "the a an and of urgent urgent account",
    "İstanbul K 42 --- !!!",
    "a  b   c",
    "tab\tand\nnewline stay joined",
    "ALL CAPS MiXeD",
    "ß é ü ñ",
    "x" * 90,
    "z 9 9 9",
    "trailing spaces   ",
    "🚀 emoji 🚀🚀 between 🚀",
    "a" * 12 + " " + "b" * 13,
]
FUZZ_ALPHABET = list("abcXYZ  \t\n0!-'") + ["İ", "K", "ß", "é", "🚀"]

WIDTH, TOKENS, BATCH, FEATURES = 2048, 256, 256, 10000
SERVE_DEMO = 4096   # messages a serve CLI run classifies (--demo)
# phase 13c: flagged rows each slot lane run explains (of phase 13's ~69):
# enough for slot reuse and the paged pool's pressure; the four runs of
# every row took ~82 s of the run's time limit
SLOT_LANE_ROWS = 16
KERNELS = ("featurize_scan", "histogram", "best_splits", "flash_attention",
           "flash_attention_sm90", "int8_matmul")
ROOT = Path(__file__).resolve().parent
# the helper processes this run starts and their result files: each is
# waited for where its result is read, and any left at exit is stopped
_children: list = []
# The training CLI's shipped configuration and the JAX bench's training shape.
DEPTH, NBINS, CLI_N, CLI_SEED = 5, 32, 1600, 42
CLI_AUC_TOL = 0.01   # lr AUC against the recorded run (near-separable fit)
LEVEL_WIDTHS = (1, 2, 4, 8, 16)   # the nodes of each split level at depth 5
HIST_KERNELS, GAIN_KERNELS = ("hist_kernel", "reduce_chunks"), ("_slabs",)
# The first kernels' events times as PERF.md records them (NVIDIA H100 80GB
# HBM3 at 700 W), printed as recorded beside this run's; their device times
# come from scripts/kernel_times.py --slice tree.
FIRST_HIST_MS = {"cli_xgb": 0.1606, "cli_rf": 0.8936, "bench_xgb": 1.8768,
                 "bench_rf": 12.3148}
FIRST_GAIN_MS = {"bench_xgb": 0.2048, "cli_rf": 0.2466, "cli_xgb": 0.2732}
FIRST_SCAN_MS = 1.1390   # the first scan kernel at (256, 2049), as PERF.md records
BENCH_ROWS, BENCH_FEATURES = 100_000, 2048
# The explanation LLM: Gemma-2B's architecture (bench.py GEMMA2B_HF_CONFIG).
GEMMA_2B = dict(vocab_size=256_000, d_model=2048, n_layers=18, n_heads=8,
                n_kv_heads=1, head_dim_override=256, d_ff=16_384,
                activation="gelu", embed_scale=math.sqrt(2048),
                tie_embeddings=True, rms_eps=1e-6, rope_theta=10000.0,
                max_seq=4096)
FLASH_MAIN = (1, 2048, 8, 256)      # the prefill's q shape; one K/V head
FLASH_SIMT_MAIN = (1, 600, 8, 256)  # phase 11's q shape (f32); one K/V head
# f32: the JAX flash test's 2e-5, absolute plus relative. bf16: absolute, from
# this shape's own reading (max |diff| 0.0039 at (1, 2048, 8, 256), where
# most outputs are a few hundredths), so a kernel that drops or misweights
# keys fails it.
FLASH_F32_TOL, FLASH_BF16_ATOL = 2e-5, 1e-2
# Ragged bf16 shapes: at small T an output averages a few v values and is
# O(1), where one bf16 step is up to 2^-7 relative, so the ragged gate adds
# 2^-7 relative to the absolute 1e-2.
FLASH_BF16_RTOL = 2.0 ** -7
FLASH_RAGGED_T, FLASH_RAGGED_D, FLASH_RAGGED_H = (1, 64, 127, 1000, 2049), (64, 128, 256), 4
CARD_CPU_TOL = 5e-4                 # the JAX flash forward test's bound
# The lifecycle phase: LC_MSGS messages, every LC_DRIFT_EVERY-th one of
# LC_DRIFT drift rows (drift_scam_pool); the engine's batch; the promotion
# spec of the JAX package's inline learn-loop test (its window is all drift
# rows, which the candidate and the drifted primary score apart on every
# row); the reference test's bar for a fresh drift pool after promotion;
# the card-vs-CPU bound in p (phase 6's xgb bound); the most of a two-class
# window's legit rows that a refresh trained on their labels may flag (the
# drift-only refresh, a window of positives, flags ~98% of them).
LC_MSGS, LC_DRIFT, LC_DRIFT_EVERY, LC_BATCH = 4096, 256, 16, 512
LC_POLICY = ("min_batches=1,min_rows=16,max_disagreement=1.0,max_psi=50.0,"
             "max_flag_rate_delta=1.0")
LC_FLAG_MIN, LC_P_TOL, LC_LEGIT_MAX = 0.9, 1e-4, 0.1
LC_TWIN_ROWS = 1024   # the two-class window's rows refreshed on both sides
LC_RATE_MSGS, LC_SHADOW_ROWS = 32768, 8192
# bench.py's generation prompts (mk_prompts(8)).
GEN_PROMPTS = [f"Analyze this dialogue for scam risk (case {i}): the caller "
               "claims to be the bank fraud department and demands immediate "
               "gift card payment to reverse a suspicious charge. "
               + "Customer hesitates repeatedly. " * (i % 3 + 1)
               for i in range(8)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """One line from nvcc's ``-Xptxas -v`` report: the functions compiled,
    their register range, the largest stack frame and spills, and any
    warning."""
    import re

    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", log)
    worst = max(((int(a), int(b), int(c)) for a, b, c in frames), default=(0, 0, 0))
    spilling = sum(1 for _, b, c in frames if int(b) or int(c))
    warnings = [l.strip() for l in log.splitlines() if "warning" in l]
    return (f"{len(regs)} functions, {min(regs, default=0)}-{max(regs, default=0)} "
            f"registers; largest stack frame {worst[0]} B, spill stores / loads "
            f"{worst[1]} / {worst[2]} B ({spilling} functions spill)"
            + (f"; warnings: {warnings}" if warnings else "; no warnings"))


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each timed with a
    pair of CUDA events, after ``warmup`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_breakdown(fn, reps: int = 10, tries: int = 3):
    """The device kernels ``fn`` launches, from a torch.profiler (CUPTI)
    trace of ``reps`` calls: [(name, us per call, launches per call)],
    largest first. Now and then a trace records no device activity at all
    (the profiler drops it, not the card); such a trace is taken again, up
    to ``tries`` times, and an empty list means every try came back empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / reps, e.count / reps)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if rows:
            break
    return sorted(rows, key=lambda r: -r[1])


def kernel_device_ms(fn, names, reps: int = 10) -> float:
    """Milliseconds of device time per call of ``fn`` in the kernels whose
    name contains one of ``names``, each of which ``fn`` launches once: the
    sum over those kernels of a profiler trace's time per recorded launch
    (the trace may miss a few launches, which a per-call average would
    count as zero; the wrapper's host work, which CUDA events around one
    call include, is left out)."""
    return sum(us / n for key, us, n in device_breakdown(fn, reps)
               if n and any(k in key for k in names)) / 1e3


def burst_ms(fn, n: int) -> float:
    """Milliseconds per call of ``fn`` over ``n`` back-to-back calls between
    one pair of CUDA events, after a warm-up call: the host enqueues ahead
    of the card, so unlike ``cuda_ms`` a launch's host cost is hidden
    whenever it is shorter than the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def staged_classes(texts, width, dev, batch=None):
    import torch

    from fraud_detection_tpu_torch.featurize.device import pack_staged
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk

    staged, _ = pack_staged(texts, width, batch)
    staged = torch.from_numpy(staged).to(dev)
    byts, lengths = fk.split_staged(staged)
    return staged, fk.byte_classes(byts, lengths)


def scan_max_err(classes, legacy: bool) -> int:
    """Run the scan kernel on a CUDA tensor and its plain version on a host
    copy of it (a launch per small op on the card; the same integer
    arithmetic on either device); raise unless all five outputs are equal.
    Returns the max |diff| (0)."""
    import torch

    from fraud_detection_tpu_torch.ops import featurize_kernel as fk

    got = fk.tokenize_hash(classes, legacy=legacy)
    want = [t.to(classes.device) for t in
            fk.tokenize_hash_reference(classes.cpu(), legacy=legacy)]
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(("h", "w0", "w1", "tok_len", "emp"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"scan {name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        if diff:
            bad = int((g != w).sum())
            raise AssertionError(f"scan kernel != plain version on {name} "
                                 f"(legacy={legacy}): {bad} elements differ")
        err = max(err, diff)
    return err


def packed_spec(base, **over):
    """``base`` (a FeaturizeSpec) with fields replaced; the "" token's bucket
    follows the hash mode and feature count."""
    from fraud_detection_tpu_torch.featurize.hashing import spark_hash_bucket

    spec = base._replace(**over)
    return spec._replace(empty_bucket=spark_hash_bucket(
        "", spec.num_features, spec.legacy))


def packed_max_err(label: str, staged, stop, spec, scans: dict) -> int:
    """Run ``featurize_packed`` twice and its plain version once on the same
    CUDA tensors; raise unless the two launches are bit-equal and equal the
    plain version (packed output and unique counts). The plain version's
    scan is kept per (input, hash mode) in ``scans``: assemble_packed is
    the only step a spec changes. The scan, a loop of ~80 small integer ops
    a byte column, runs on a host copy of the same bytes (on the card each
    op is a launch: ~20 s a scan at W=16,384) and is copied back; its
    integer arithmetic is the same on either device. Returns the max |diff|
    (0)."""
    import torch

    from fraud_detection_tpu_torch.ops import featurize_kernel as fk

    got = fk.featurize_bytes(staged, stop, spec=spec)
    again = fk.featurize_bytes(staged, stop, spec=spec)
    key = (label.split()[0], spec.legacy)
    if key not in scans:
        host = fk.tokenize_hash_reference(
            fk.byte_classes(*fk.split_staged(staged.cpu())),
            legacy=spec.legacy)
        scans[key] = tuple(t.to(staged.device) for t in host)
    want = fk.assemble_packed(*scans[key], stop, spec=spec)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"featurize_packed {label}: two launches differ")
    for name, g, w in zip(("packed", "n_unique"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"featurize_packed {label} {name}: "
                                 f"{tuple(g.shape)}/{g.dtype} vs "
                                 f"{tuple(w.shape)}/{w.dtype}")
        if not torch.equal(g, w):
            rows = (g != w).reshape(g.shape[0], -1).any(dim=1).nonzero()
            raise AssertionError(f"featurize_packed {label} != plain version "
                                 f"on {name}: rows {rows.flatten().tolist()[:8]}")
    n = got[1]
    print(f"[check] featurize_packed == plain version, launches bit-equal: "
          f"{label} {tuple(staged.shape)} (legacy={spec.legacy}, binary="
          f"{spec.binary}, empty_is_stop={spec.empty_is_stop}, slots "
          f"{spec.n_slots}; unique per row {int(n.min())}-{int(n.max())}, "
          f"{int((n > spec.n_slots).sum())} rows past the slots)")
    return 0


def packed_inputs(corpus_texts, fuzz, dev, seed: int):
    """The staged inputs phase 3 holds featurize_packed to: W=2048 corpus
    rows, the adversarial strings (padding rows included), the seeded fuzz,
    rows of random words with more unique buckets than 256 slots, the fuzz
    at W=8, and W=16,384 rows (long dialogues, one truncated, "", a
    16,000-letter token, padding)."""
    import torch

    from fraud_detection_tpu_torch.featurize.device import pack_staged

    rng = random.Random(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    words = ["".join(rng.choice(letters) for _ in range(rng.randrange(2, 5)))
             for _ in range(900)]
    overflow = [" ".join(rng.choice(words[: rng.choice((450, 900))])
                         for _ in range(600))[:WIDTH] for _ in range(6)]

    def stage(texts, width, batch=None):
        return torch.from_numpy(pack_staged(texts, width, batch)[0]).to(dev)

    return [("corpus", stage(corpus_texts, WIDTH)),
            ("adversarial", stage(ADVERSARIAL, 128, 16)),
            ("fuzz", stage(fuzz, 256, 130)),
            ("overflow", stage(overflow, WIDTH, 8)),
            ("w8", stage(fuzz, 8, 130)),
            ("w16384", long_staged(corpus_texts).to(dev))]


def long_staged(corpus_texts):
    """The W=16,384 staged rows on the host: long dialogues (one past the
    width, truncated), "", a 16,000-letter token, padding to 8 rows."""
    import torch

    from fraud_detection_tpu_torch.featurize.device import pack_staged

    rows, i = [], 0
    for target in (16_384, 16_000, 20_000, 9_000):
        row = ""
        while len(row) < target:
            row += corpus_texts[i % len(corpus_texts)] + " "
            i += 1
        rows.append(row[:target])
    rows += ["", "Q" * 16_000 + " end"]
    return torch.from_numpy(pack_staged(rows, 16_384, 8)[0])


def background_host_process() -> None:
    """Keep a helper process out of the way of the main one, whose phases
    are host-bound: the lowest priority, one core, one torch thread."""
    import torch

    os.nice(19)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    torch.set_num_threads(1)


def host_scans_child(result_path: str, seed: int) -> int:
    """The plain scan of phase 3's W=16,384 rows in both hash modes, on the
    host, in a process of its own that runs beside the kernels' build
    (``start_host_scans``): ~80 small integer ops a byte column, each a
    launch on the card. Saves the scans and the staged bytes' SHA-256."""
    import hashlib

    import torch

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk

    background_host_process()
    texts = [d.text for d in generate_corpus(n=BATCH, seed=seed + 11)]
    staged = long_staged(texts)
    classes = fk.byte_classes(*fk.split_staged(staged))
    torch.save({"sha256": hashlib.sha256(staged.numpy().tobytes()).hexdigest(),
                "scans": {legacy: fk.tokenize_hash_reference(classes,
                                                             legacy=legacy)
                          for legacy in (False, True)}}, result_path)
    return 0


def start_host_scans(seed: int):
    """Start ``host_scans_child``; returns (process, result path)."""
    fd, path = tempfile.mkstemp(prefix="chip_smoke_scans_", suffix=".pt")
    os.close(fd)
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
         "chip_smoke.host_scans_child(sys.argv[1], int(sys.argv[2])))",
         path, str(seed)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES=""))
    _children.append((proc, path))
    return proc, path


def stop_children() -> None:
    """Stop every helper process still running and remove the result files
    left behind (registered with ``atexit`` in ``main``)."""
    for proc, path in _children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)


def host_scans(started, staged) -> dict:
    """Wait for ``start_host_scans``'s child; its scans, on ``staged``'s
    device, keyed as ``packed_max_err`` keys them, once the child is shown
    to have scanned these very bytes."""
    import hashlib

    import torch

    proc, path = started
    try:
        if proc.wait(timeout=600) != 0:
            raise AssertionError(f"the host scan exited {proc.returncode}")
        out = torch.load(path)
    finally:
        os.unlink(path)
    if out["sha256"] != hashlib.sha256(
            staged.cpu().numpy().tobytes()).hexdigest():
        raise AssertionError("the host scan read other W=16,384 bytes")
    return {("w16384", legacy): tuple(t.to(staged.device) for t in scan)
            for legacy, scan in out["scans"].items()}


def make_models(feat, seed: int, dev):
    """LR parameters and a depth-5 20-tree random forest, from ``seed``. Tree
    splits use buckets that occur in the IDF corpus, so rows really branch."""
    import numpy as np

    from fraud_detection_tpu_torch import convert

    rng = np.random.default_rng(seed)
    lr = convert.logistic_from_arrays(
        rng.normal(0.0, 0.5, FEATURES).astype(np.float32), -0.25,
        device=dev)
    depth, n_trees = 5, 20
    n_nodes = 2 ** (depth + 1) - 1
    n_inner = 2 ** depth - 1
    seen = np.flatnonzero(feat.doc_freq > 0)
    feature = np.full((n_trees, n_nodes), -1, np.int32)
    threshold = np.zeros((n_trees, n_nodes), np.float32)
    left = np.full((n_trees, n_nodes), -1, np.int32)
    right = np.full((n_trees, n_nodes), -1, np.int32)
    inner = np.arange(n_inner)
    feature[:, :n_inner] = rng.choice(seen, size=(n_trees, n_inner))
    threshold[:, :n_inner] = rng.uniform(0.0, 3.0, (n_trees, n_inner))
    left[:, :n_inner] = 2 * inner + 1
    right[:, :n_inner] = 2 * inner + 2
    leaf = rng.uniform(0.0, 10.0, (n_trees, n_nodes, 2)).astype(np.float32)
    trees = convert.trees_from_arrays(
        feature, threshold, left, right, leaf, np.ones(n_trees, np.float32),
        kind="random_forest", max_depth=depth, device=dev)
    return lr, trees


# ---------------------------------------------------------------------------
# tree training
# ---------------------------------------------------------------------------

def cli_data(dev):
    """The training CLI's data at full width: the synthetic corpus (n=1600,
    seed 42), its 70/10/20 split and HashingTF(10000)+IDF fitted on the
    training texts, as host matrices (train, test), the test texts, and the
    evaluation sets {"Validation": (X, y), "Test": (X, y)}."""
    import numpy as np

    from fraud_detection_tpu_torch.data import (generate_corpus,
                                                train_val_test_split)
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer

    corpus = [(d.text, d.label)
              for d in generate_corpus(n=CLI_N, seed=CLI_SEED)]
    train, val, test = train_val_test_split(corpus, seed=CLI_SEED)
    feat = HashingTfIdfFeaturizer(num_features=FEATURES)
    feat.fit_idf([t for t, _ in train])

    def dense(split):
        return feat.featurize_dense([t for t, _ in split],
                                    device=dev).cpu().numpy()

    def labels(split):
        return np.asarray([l for _, l in split], np.float32)

    sets = {"Validation": (dense(val), labels(val)),
            "Test": (dense(test), labels(test))}
    return (dense(train), labels(train), sets["Test"][0],
            [t for t, _ in test], sets)


def bench_bins(dev, seed: int):
    """(100,000 x 2,048) int32 bins shaped like a quantile-binned TF-IDF
    matrix, made on the card from ``seed``: each feature is nonzero in 2-12%
    of rows, which spread over its upper bins, and its zeros collapse into
    bin 0. Labels come from 16 features plus noise."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n, f = BENCH_ROWS, BENCH_FEATURES
    rate = 0.02 + 0.10 * torch.rand((1, f), generator=g, device=dev)
    low = torch.floor(NBINS * (1.0 - rate)).clamp(max=NBINS - 1)
    upper = low + torch.floor(
        torch.rand((n, f), generator=g, device=dev) * (NBINS - low))
    nonzero = torch.rand((n, f), generator=g, device=dev) < rate
    bins = torch.where(nonzero, upper, torch.zeros_like(upper)).to(torch.int32)
    score = (bins[:, :16].to(torch.float32).sum(dim=1)
             + 4.0 * torch.randn((n,), generator=g, device=dev))
    return bins.contiguous(), (score > score.median()).to(torch.float32)


def level_inputs(n: int, trees: int, k: int, labels, dev, seed: int,
                 width: int = 16):
    """One level's kernel inputs. At the default width, depth 4 of a
    depth-5 tree (16 nodes): node ids in [0, 15), node 15 left empty, ~1/16
    of the rows inactive (id 16); at another width, ids in [0, width).
    Poisson(1) bootstrap weights for a forest chunk (trees > 1), else ones;
    stats the one-hot labels (k=2) or xgb (grad, hess, count) from random
    margins (k=3)."""
    import torch

    from fraud_detection_tpu_torch.models.train_trees import _poisson1

    g = torch.Generator(device=dev).manual_seed(seed)
    loc = torch.randint(0, width, (trees, n), generator=g, device=dev)
    if width == 16:
        loc = torch.where(loc == 15, 16, loc)
    loc = loc.to(torch.int32).contiguous()
    w = (_poisson1(torch.rand((trees, n), generator=g, device=dev))
         if trees > 1 else torch.ones((1, n), device=dev))
    if k == 2:
        stats = torch.stack([1.0 - labels, labels], dim=1)
    else:
        p = torch.sigmoid(torch.randn((n,), generator=g, device=dev))
        stats = torch.stack([p - labels, p * (1.0 - p), torch.ones_like(p)],
                            dim=1)
    return loc, w.contiguous(), stats.contiguous()


def check_histogram(label: str, bins, loc, w, stats, exact: bool,
                    n_nodes: int = 16):
    """Kernel twice and plain version on the same CUDA tensors; raises
    unless the two launches are bit-equal and the kernel equals the plain
    version (exact path) or lies within 1e-5 of its largest |cell| (f32).
    Returns (max |diff|, the kernel's histogram)."""
    import torch

    from fraud_detection_tpu_torch.ops import histogram as H

    kw = dict(n_nodes=n_nodes, n_bins=NBINS, exact_int8=exact)
    a = H.node_feature_bin_histogram_multi(bins, loc, w, stats, **kw)
    b = H.node_feature_bin_histogram_multi(bins, loc, w, stats, **kw)
    ref = H.histogram_reference(bins, loc, w, stats, **kw)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"histogram {label}: two launches differ")
    err = float((a - ref).abs().max())
    scale = float(ref.abs().max())
    if (exact and err != 0.0) or err > 1e-5 * scale:
        raise AssertionError(f"histogram {label} (exact={exact}): kernel vs "
                             f"plain max |diff| {err} at scale {scale}")
    n, f = bins.shape
    plan = H.histogram_plan(n, f, loc.shape[0], n_nodes, NBINS,
                            stats.shape[1], exact)
    print(f"[check] histogram {label} {tuple(a.shape)} {bins.dtype} bins "
          f"exact={exact}: max |diff| {err:.3g} (largest cell {scale:.6g}), "
          f"two launches bit-equal; {plan}")
    return err, a


def check_best_splits(label: str, hist, totals, criterion: str,
                      empty_node=15) -> None:
    """Kernel and plain version on the same CUDA tensors, at the default
    and a ragged feature tile: indices equal, gains bit-equal, and the
    empty node (if any) returns (0, 0, -inf)."""
    import torch

    from fraud_detection_tpu_torch.ops import histogram as H

    for tile in (1024, 300):
        kf, kb, kg = H.best_splits(hist, totals, criterion=criterion,
                                   feature_tile=tile)
        pf, pb, pg = H.best_splits_reference(hist, totals, criterion=criterion)
        torch.cuda.synchronize()
        if not (torch.equal(kf, pf) and torch.equal(kb, pb)
                and torch.equal(kg, pg)):
            raise AssertionError(f"best_splits {label} {criterion} tile {tile}:"
                                 " kernel != plain version")
        e = empty_node
        if e is not None and (int(kf[e]), int(kb[e]), float(kg[e])) != (
                0, 0, float("-inf")):
            raise AssertionError(f"best_splits {label}: the empty node gave "
                                 f"{(int(kf[e]), int(kb[e]), float(kg[e]))}")
    valid = int(torch.isfinite(kg).sum())
    print(f"[check] best_splits {label} {criterion} {tuple(hist.shape)}: "
          f"indices equal, gains bit-equal (tiles 1024 and 300), "
          f"{valid}/{hist.shape[0]} nodes with a valid split"
          + ("" if empty_node is None else ", empty node -> (0, 0, -inf)"))


def histogram_library_call(bins, loc, w, stats, n_nodes: int):
    """One ``index_add_`` over the flat segment id ((t*L + l)*F + f)*NB + b
    computing the same histogram, with ids and values built beforehand
    into tensors allocated once (no concatenated copy). Returns (the call
    to time, None), or (None, bytes it would need) when the card cannot
    hold its ids and values."""
    import torch

    n, f = bins.shape
    k = stats.shape[1]
    t = loc.shape[0]
    active = (loc >= 0) & (loc < n_nodes)
    total = int(active.sum()) * f
    need = total * (8 + 4 * k)
    try:
        flat = torch.empty((total,), dtype=torch.int64, device=bins.device)
        val = torch.empty((total, k), dtype=torch.float32, device=bins.device)
        cols = torch.arange(f, device=bins.device, dtype=torch.int64)
        at = 0
        for ti in range(t):
            rows = torch.nonzero(active[ti])[:, 0]
            m = rows.numel() * f
            base = (ti * n_nodes + loc[ti, rows].to(torch.int64)) * f
            flat[at:at + m].view(-1, f).copy_(
                (base[:, None] + cols[None, :]) * NBINS + bins[rows].to(torch.int64))
            v = stats[rows] * w[ti, rows][:, None]
            val[at:at + m].view(-1, f, k).copy_(v[:, None, :].expand(-1, f, -1))
            at += m
            del rows, base, v
        out = torch.zeros((t * n_nodes * f * NBINS, k), dtype=torch.float32,
                          device=bins.device)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None, need
    return (lambda: out.index_add_(0, flat, val)), None


def histogram_bound(bins, loc, w, stats, n_nodes: int):
    """(bound ms, "bytes" | "operations", MB moved): the bins (at the width
    passed, 1 byte for uint8) of the rows some tree uses, the per-row inputs
    and the output once, at the HBM rate; one multiply and one add per
    (tree, active row, feature, stat) at the 32-bit rate."""
    n, f = bins.shape
    t, k = loc.shape[0], stats.shape[1]
    active = (loc >= 0) & (loc < n_nodes)
    rows = int(active.any(dim=0).sum())
    nbytes = (rows * f * bins.element_size() + loc.numel() * 4 + w.numel() * 4
              + stats.numel() * 4 + t * n_nodes * f * NBINS * k * 4)
    ops = int(active.sum()) * f * k * 2
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes / 1e6


def best_splits_bound(hist):
    """(bound ms, "bytes" | "operations"): the histogram, totals and
    results moved once; per (node, feature, bin) candidate K prefix adds, K
    subtractions and ~12 gain operations at the 32-bit rate."""
    L, f, nb, k = hist.shape
    nbytes = hist.numel() * 4 + L * k * 4 + L * 12
    ops = L * f * (nb - 1) * (2 * k + 12)
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def train_card_vs_cpu(Xtr, ytr, Xte, dev) -> dict:
    """dt, an 8-tree rf and an 8-round xgb at full width on the card and on
    the CPU: dt and rf equal tree for tree (feature, threshold, children,
    leaf stats), xgb test-set max |dp| <= 1e-4. Returns host walls. (16
    trees and rounds until the LLM trainer's phases needed the time: the
    CPU side took 34 s of the script's 1,200.)"""
    import dataclasses

    import torch

    from fraud_detection_tpu_torch.models import train_trees as tt
    from fraud_detection_tpu_torch.models import trees as tm
    from fraud_detection_tpu_torch.ops import histogram as H

    cfg = tt.TreeTrainConfig(max_depth=DEPTH, n_bins=NBINS)
    fits = {
        "dt": lambda d: tt.fit_decision_tree(Xtr, ytr, config=cfg, device=d),
        "rf8": lambda d: tt.fit_random_forest(Xtr, ytr, n_trees=8,
                                              seed=CLI_SEED, config=cfg,
                                              device=d),
        "xgb8": lambda d: tt.fit_gradient_boosting(
            Xtr, ytr, n_rounds=8,
            config=dataclasses.replace(cfg, criterion="xgb"), device=d),
    }
    h0, b0 = H.node_feature_bin_histogram_multi.launches, H.best_splits.launches
    walls = {}
    for name, fit in fits.items():
        t0 = time.perf_counter()
        card = fit(dev)
        walls[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = fit("cpu")
        cpu_s = time.perf_counter() - t0
        if name == "xgb8":
            pg = tm.predict(card, torch.from_numpy(Xte).to(dev))[1].cpu()
            pc = tm.predict(cpu, torch.from_numpy(Xte))[1]
            dp = float((pg - pc).abs().max())
            if dp > 1e-4:
                raise AssertionError(f"xgb8: card vs cpu test max |dp| {dp}")
            same = f"test max |dp| {dp:.3g}"
        else:
            for field in ("feature", "threshold", "left", "right", "leaf"):
                if not torch.equal(getattr(card, field).cpu(),
                                   getattr(cpu, field)):
                    raise AssertionError(f"{name}: card and cpu trees differ "
                                         f"in {field}")
            same = "trees equal"
        print(f"[train] {name}: card vs cpu {same}; {card.num_trees} trees, "
              f"card {walls[name]:.3f} s, cpu {cpu_s:.3f} s (host clock)")
    launched = (H.node_feature_bin_histogram_multi.launches - h0,
                H.best_splits.launches - b0)
    if min(launched) < 1:
        raise AssertionError(f"training phase launches {launched}")
    print(f"[train] card fits launched histogram {launched[0]}x, best_splits "
          f"{launched[1]}x")
    return walls


def lr_card_vs_cpu(Xtr, ytr, sets, dev, card: str) -> dict:
    """The L-BFGS fit at the CLI's full width (1,120 x 10,000) on the card
    and on the CPU: validation and test labels equal. The card fit runs
    twice (the second timed, X already on the card); its wall, loss
    evaluations and host reads print beside the CPU fit's iterations and
    the byte bound (each evaluation reads X twice)."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models.linear import predict_dense
    from fraud_detection_tpu_torch.models.train_linear import (
        fit_logistic_regression)

    fits = {}
    for name, X in (("card", torch.from_numpy(Xtr).to(dev)),
                    ("card", torch.from_numpy(Xtr).to(dev)), ("cpu", Xtr)):
        d = dev if name == "card" else "cpu"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, info = fit_logistic_regression(X, ytr, return_info=True,
                                              device=d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fits[name] = dict(info=info, wall=wall, labels={
            s: predict_dense(model, Xs)[0].cpu().numpy()
            for s, (Xs, _) in sets.items()})
    card_fit, cpu_fit = fits["card"], fits["cpu"]
    Xd = torch.from_numpy(Xtr).to(dev)
    breakdown = device_breakdown(
        lambda: fit_logistic_regression(Xd, ytr, device=dev), reps=1)
    busy_ms = sum(us for _, us, _ in breakdown) / 1e3
    for split in sets:
        if not np.array_equal(card_fit["labels"][split],
                              cpu_fit["labels"][split]):
            raise AssertionError(f"lr card vs cpu: {split} labels differ")
    ci, pi = card_fit["info"], cpu_fit["info"]
    if not math.isfinite(ci.final_loss):
        raise AssertionError(f"lr card fit: {ci}")
    bound_ms = ci.evaluations * 2 * Xtr.nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[lr] CLI shape {Xtr.shape[0]} x {Xtr.shape[1]}: card vs cpu "
          f"validation and test labels equal; iterations card {ci.iterations} "
          f"/ cpu {pi.iterations}, evaluations {ci.evaluations} / "
          f"{pi.evaluations}, final loss {ci.final_loss:.7g} / "
          f"{pi.final_loss:.7g}; card fit {card_fit['wall'] * 1e3:.2f} ms "
          f"wall, {ci.host_syncs} host reads, byte bound {bound_ms:.4f} ms "
          f"({ci.evaluations} evaluations x 2 reads of {Xtr.nbytes / 1e6:.1f}"
          f" MB); cpu fit {cpu_fit['wall'] * 1e3:.2f} ms ({card})")
    print(f"[trace] {card}: lr fit at the CLI shape: device busy "
          f"{busy_ms:.2f} ms of a {card_fit['wall'] * 1e3:.1f} ms wall; "
          f"{sum(c for *_, c in breakdown):.0f} device ops")
    for name, us, c in breakdown[:6]:
        print(f"[trace]   {us:10.1f} us  x{c:.0f}  {name[:90]}")
    return dict(card_ms=card_fit["wall"] * 1e3, cpu_ms=cpu_fit["wall"] * 1e3,
                device_busy_ms=busy_ms,
                device_ops=sum(c for *_, c in breakdown),
                iterations=ci.iterations, cpu_iterations=pi.iterations,
                evaluations=ci.evaluations, cpu_evaluations=pi.evaluations,
                host_syncs=ci.host_syncs,
                final_loss=ci.final_loss, bound_ms=bound_ms)


def lr_bench_fit(dev, seed: int, card: str) -> dict:
    """The L-BFGS fit at the JAX bench's training shape (100,000 x 2,048
    f32, 819 MB, made on the card from ``seed``; labels from a logistic
    model): wall, iterations, evaluations, host reads, the byte bound, and
    a profiler breakdown of a second fit. The loss must fall below ln 2."""
    import torch

    from fraud_detection_tpu_torch.models.train_linear import (
        fit_logistic_regression)

    g = torch.Generator(device=dev).manual_seed(seed)
    n, f = BENCH_ROWS, BENCH_FEATURES
    X = torch.randn((n, f), generator=g, device=dev)
    w = torch.randn((f,), generator=g, device=dev) / math.sqrt(f) * 3.0
    y = (torch.rand((n,), generator=g, device=dev)
         < torch.sigmoid(X @ w)).to(torch.float32)

    def fit():
        return fit_logistic_regression(X, y, return_info=True, device=dev)

    fit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, info = fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (info.final_loss < math.log(2.0)
            and bool(torch.isfinite(model.weights).all())):
        raise AssertionError(f"lr bench fit: {info}")
    nbytes = X.numel() * X.element_size()
    bound_ms = info.evaluations * 2 * nbytes / HBM_BYTES_PER_S * 1e3
    breakdown = device_breakdown(fit, reps=1)
    busy_ms = sum(us for _, us, _ in breakdown) / 1e3
    print(f"[lr] bench shape {n} x {f} ({nbytes / 1e6:.0f} MB): fit "
          f"{wall * 1e3:.2f} ms wall, {info.iterations} iterations, "
          f"{info.evaluations} evaluations, {info.host_syncs} host reads, "
          f"final loss {info.final_loss:.6g}; byte bound {bound_ms:.3f} ms "
          f"({bound_ms / info.evaluations:.4f} ms an evaluation); device busy "
          f"{busy_ms:.2f} ms of the fit, "
          f"{sum(c for *_, c in breakdown):.0f} device ops ({card})")
    for name, us, c in breakdown[:6]:
        print(f"[trace]   {us:10.1f} us  x{c:.0f}  {name[:90]}")
    return dict(ms=wall * 1e3, iterations=info.iterations,
                evaluations=info.evaluations, host_syncs=info.host_syncs,
                final_loss=info.final_loss, bound_ms=bound_ms,
                device_busy_ms=busy_ms)


def run_train_cli(argv) -> dict:
    """``app/train.py main(argv)`` in-process: exit 0 or raise with its
    output; returns the captured output."""
    import contextlib
    import io

    from fraud_detection_tpu_torch.app import train as cli

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"train CLI {argv}: exit {rc}\n{log.getvalue()}")
    return log.getvalue()


def train_cli(dev, test_texts, out: Path) -> dict:
    """The training CLI on the card at its defaults (dt, rf 100 trees, xgb
    100 rounds, lr), saving dt, rf, xgb and lr as native checkpoints, lr, rf
    and xgb as Spark ``PipelineModel`` directories (``--save
    m=spark:<dir>``, phase 7k serves them) and publishing lr to a registry.
    dt's and rf's metrics must equal the JAX package's recorded run
    (reports/metrics.json, same corpus, split, exact gini and, for rf, the
    same threefry draws); lr's accuracy and confusion must equal it on both
    splits and its AUC lie within CLI_AUC_TOL (near separability makes the
    L-BFGS stopping point depend on rounding). The saved dt, served with
    device featurization, and the published lr, verified and loaded from
    the registry, must give the dense ``predict`` labels on the test
    texts. Returns the report."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import trees as tm
    from fraud_detection_tpu_torch.models.linear import predict_dense
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.registry import ModelRegistry

    metrics, registry = out / "metrics.json", out / "registry"
    shutil.rmtree(registry, ignore_errors=True)
    shutil.rmtree(out / "spark", ignore_errors=True)
    run_train_cli(["--device", str(dev), "--save", f"dt={out / 'dt'}",
                   "--save", f"rf={out / 'rf'}", "--save", f"xgb={out / 'xgb'}",
                   "--save", f"lr={out / 'lr_cli'}",
                   *(a for m in SPARK_MODELS
                     for a in ("--save", f"{m}=spark:{out / 'spark' / m}")),
                   "--publish", f"lr={registry}", "--metrics-out", str(metrics)])
    report = json.loads(metrics.read_text())
    ref = json.loads((ROOT / "reports" / "metrics.json").read_text())
    if set(report["metrics"]) != {"dt", "rf", "xgb", "lr"}:
        raise AssertionError(f"default models {sorted(report['metrics'])}")
    for name in ("dt", "rf", "xgb", "lr"):
        got, want = report["metrics"][name]["Test"], ref["metrics"][name]["Test"]
        print(f"[cli] {name} test: accuracy {got['accuracy']:.4f} f1 "
              f"{got['f1']:.4f} auc {got['auc']:.4f} (JAX package's recorded "
              f"run: {want['accuracy']:.4f} / {want['f1']:.4f} / "
              f"{want['auc']:.4f}); fit {report['meta']['train_seconds'][name]}"
              " s host clock")
    for name in ("dt", "rf"):
        if report["metrics"][name] != ref["metrics"][name]:
            raise AssertionError(f"{name} metrics differ from the JAX "
                                 "package's recorded run")
    for split in ("Validation", "Test"):
        got, want = report["metrics"]["lr"][split], ref["metrics"]["lr"][split]
        if (got["confusion"] != want["confusion"]
                or got["accuracy"] != want["accuracy"]):
            raise AssertionError(f"lr {split}: {got} != recorded {want}")
        if abs(got["auc"] - want["auc"]) > CLI_AUC_TOL:
            raise AssertionError(f"lr {split} auc {got['auc']} vs recorded "
                                 f"{want['auc']}")
        print(f"[cli] lr {split}: confusion {got['confusion']} and accuracy "
              f"{got['accuracy']:.6f} equal the recorded run's; auc "
              f"{got['auc']:.6f} beside the recorded {want['auc']:.6f} "
              f"(|diff| {abs(got['auc'] - want['auc']):.6f} <= {CLI_AUC_TOL})")
    width = -(-max(len(t.encode()) for t in test_texts) // 64) * 64
    tokens = -(-max(sum(c.isspace() for c in t) + 1 for t in test_texts)
               // 16) * 16
    pipe = ServingPipeline.from_checkpoint(
        str(out / "dt"), device=dev, featurize_device=True,
        featurize_width=width, featurize_tokens=tokens)
    served = pipe.predict(test_texts)
    dense = pipe.featurizer.featurize_dense(test_texts, device=dev)
    labels = tm.predict(pipe.model, dense)[0].cpu().numpy()
    if not np.array_equal(served.labels, labels):
        raise AssertionError("served dt labels != dense predict labels")
    want_path = "cuda" if torch.device(dev).type == "cuda" else "torch"
    if (pipe.device_stats.truncated_rows
            or pipe.device_stats.featurize_path != want_path):
        raise AssertionError(f"served dt: {pipe.device_stats.snapshot()}")
    print(f"[cli] dt and rf metrics equal the recorded JAX run; checkpoint "
          f"served on {dev} (device featurize W={width}, L={tokens}): "
          f"{len(test_texts)} labels equal dense predict")
    reg = ModelRegistry(str(registry))
    mv = reg.verify(1)
    _, lr_pipe = reg.load(1, device=dev)
    served = lr_pipe.predict(test_texts)
    dense = lr_pipe.featurizer.featurize_dense(test_texts, device=dev)
    if not np.array_equal(served.labels,
                          predict_dense(lr_pipe.model, dense)[0].cpu().numpy()):
        raise AssertionError("registry lr: served labels != dense predict")
    if mv.manifest["metrics"] != {k: {m: v for m, v in d.items()
                                      if m != "confusion"}
                                  for k, d in report["metrics"]["lr"].items()}:
        raise AssertionError("registry lr: manifest metrics != the report's")
    print(f"[cli] --publish lr: {mv.name} verified ({len(mv.manifest['files'])}"
          f" files hashed) and loaded on {dev}; {len(test_texts)} served "
          "labels equal dense predict")
    return report


def resume_cli(dev, out: Path, card: str) -> dict:
    """The training CLI's resume: rf and xgb interrupted at k = 30 trees /
    rounds (``--checkpoint-dir``, default cadence 10), then resumed to 100;
    the resumed checkpoints must equal the uninterrupted run's (phase 7's)
    array for array. The forest's snapshot at 30 is off its 8-tree chunk
    grid, so the resume rebuilds from tree 24."""
    import numpy as np

    from fraud_detection_tpu_torch.checkpoint import train_state as ts

    snaps = out / "snapshots"
    shutil.rmtree(snaps, ignore_errors=True)
    t0 = time.perf_counter()
    run_train_cli(["--device", str(dev), "--models", "rf,xgb", "--n-trees",
                   "30", "--n-rounds", "30", "--checkpoint-dir", str(snaps)])
    cut_s = time.perf_counter() - t0
    for name, kind in (("rf", "random_forest"), ("xgb", "gradient_boosting")):
        snap = ts.load_train_state(str(snaps / name))
        if snap is None or snap[:2] != (kind, 30):
            raise AssertionError(f"{name} snapshot {snap and snap[:2]}")
    t0 = time.perf_counter()
    run_train_cli(["--device", str(dev), "--models", "rf,xgb",
                   "--checkpoint-dir", str(snaps),
                   "--save", f"rf={out / 'rf_resumed'}",
                   "--save", f"xgb={out / 'xgb_resumed'}"])
    resumed_s = time.perf_counter() - t0
    for name in ("rf", "xgb"):
        a = np.load(out / name / "arrays.npz")
        b = np.load(out / f"{name}_resumed" / "arrays.npz")
        if sorted(a.files) != sorted(b.files) or any(
                not np.array_equal(a[k], b[k]) for k in a.files):
            raise AssertionError(f"resumed {name} != uninterrupted {name}")
        if ts.load_train_state(str(snaps / name))[1] != 100:
            raise AssertionError(f"{name}: final snapshot not at 100")
    print(f"[resume] rf100 and xgb100 interrupted at 30 and resumed: every "
          f"checkpoint array equals the uninterrupted run's; CLI walls "
          f"{cut_s:.2f} s to 30, {resumed_s:.2f} s from 30 to 100 ({card})")
    return dict(to_30_s=cut_s, resumed_s=resumed_s)


def count_cli(dev, test_texts, y_test, out: Path) -> dict:
    """``--featurizer count --models lr --save lr=...``; the checkpoint
    served on host featurize gives the dense ``predict`` labels on the test
    texts, whose confusion is the CLI's reported one; device featurize
    refuses the vocabulary featurizer."""
    import numpy as np

    from fraud_detection_tpu_torch.eval import evaluate_classification
    from fraud_detection_tpu_torch.featurize.device import (
        DeviceFeaturizeUnavailable)
    from fraud_detection_tpu_torch.featurize.tfidf import VocabTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.linear import predict_dense
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk

    ckpt, metrics = out / "lr_count", out / "count_metrics.json"
    run_train_cli(["--device", str(dev), "--featurizer", "count", "--models",
                   "lr", "--save", f"lr={ckpt}", "--metrics-out", str(metrics)])
    report = json.loads(metrics.read_text())
    fk.featurize_bytes.launches = 0
    pipe = ServingPipeline.from_checkpoint(str(ckpt), device=dev)
    if not isinstance(pipe.featurizer, VocabTfIdfFeaturizer):
        raise AssertionError(f"count checkpoint loaded a "
                             f"{type(pipe.featurizer).__name__}")
    served = pipe.predict(test_texts)
    dense = pipe.featurizer.featurize_dense(test_texts, device=dev)
    want = predict_dense(pipe.model, dense)[0].cpu().numpy()
    if not np.array_equal(served.labels, want):
        raise AssertionError("count lr: served labels != dense predict")
    confusion = evaluate_classification(y_test, served.labels,
                                        served.probabilities).confusion.tolist()
    if confusion != report["metrics"]["lr"]["Test"]["confusion"]:
        raise AssertionError(f"count lr: served confusion {confusion} != the "
                             "CLI's")
    if fk.featurize_bytes.launches or pipe.device_stats.featurize_path != "host":
        raise AssertionError("count lr: not served on host featurize")
    try:
        ServingPipeline.from_checkpoint(str(ckpt), device=dev,
                                        featurize_device=True)
    except DeviceFeaturizeUnavailable as e:
        refusal = str(e)
    else:
        raise AssertionError("device featurize took a vocabulary featurizer")
    print(f"[count] --featurizer count: vocabulary {pipe.featurizer.num_features}"
          f" terms; served on host featurize, {len(test_texts)} labels equal "
          f"dense predict, test confusion {confusion} equals the CLI's "
          f"(accuracy {report['metrics']['lr']['Test']['accuracy']:.4f}); "
          f"--featurize-device refuses: {refusal}")
    return dict(vocab=pipe.featurizer.num_features,
                test=report["metrics"]["lr"]["Test"])


# ---------------------------------------------------------------------------
# explanation LLM
# ---------------------------------------------------------------------------

def flash_inputs(shape, hkv: int, dtype, dev, seed: int):
    """q (B, T, H, d) and k/v (B, T, hkv, d), standard normal, from seed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b, t, _, d = shape
    return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in (shape, (b, t, hkv, d), (b, t, hkv, d)))


def check_flash(label: str, q, k, v, atol: float, rtol: float = 0.0,
                route: str = "", quiet: bool = False):
    """Kernel twice and plain version once on the same CUDA tensors; raises
    unless the launches are bit-equal, native-width K/V give what expanded
    K/V give bit for bit, and |kernel - plain| <= atol + rtol * |plain|
    everywhere. ``route`` names the kernel ("sm90" or "simt"); by default
    ``flash_attention`` picks it, and the check raises unless it picked the
    route ``flash_route`` names. Returns max |kernel - plain|."""
    import torch

    from fraud_detection_tpu_torch.ops import attention as A

    want = A.flash_route(q.dtype, q.shape[3])
    fn = {"sm90": A.flash_attention_sm90, "simt": A.flash_attention_simt,
          "": A.flash_attention}[route]
    counts = (A.flash_attention_sm90.launches, A.flash_attention_simt.launches)
    a = fn(q, k, v)
    b = fn(q, k, v)
    rep = q.shape[2] // k.shape[2]
    e = fn(q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2))
    ran = {"sm90": A.flash_attention_sm90.launches - counts[0],
           "simt": A.flash_attention_simt.launches - counts[1]}
    if ran[route or want] != 3:
        raise AssertionError(f"flash {label}: launches by route {ran}, want 3 "
                             f"on {route or want}")
    ref = A.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"flash {label}: two launches differ")
    if not torch.equal(a, e):
        raise AssertionError(f"flash {label}: native K/V != expanded K/V")
    diff = (a.float() - ref.float()).abs()
    err = float(diff.max())
    rms = float(ref.float().square().mean().sqrt())
    if not bool(torch.isfinite(a).all()) or not bool(
            (diff <= atol + rtol * ref.float().abs()).all()):
        raise AssertionError(f"flash {label}: kernel vs plain max |diff| "
                             f"{err} beyond {atol} (+ {rtol} relative)")
    if not quiet:
        print(f"[check] flash {label} ({route or want}) q {tuple(q.shape)} kv "
              f"heads {k.shape[2]} {q.dtype}: max |diff| {err:.3g} (limit "
              f"{atol} + {rtol} relative), plain output RMS {rms:.3g}, two "
              "launches bit-equal, native K/V == expanded K/V")
    return err


def flash_bound(shape, hkv: int, itemsize: int):
    """(bound ms, "bytes" | "operations"): q, k, v read and out written once
    at the HBM rate, against 4 d operations (q.k and p.v) per causal (query,
    key) pair and head at the bf16 tensor-core rate (itemsize 2) or the
    non-tensor f32 rate (itemsize 4: TF32 would not give f32 results)."""
    b, t, h, d = shape
    nbytes = (2 * b * t * h * d + 2 * b * t * hkv * d) * itemsize
    ops = 4 * b * h * d * (t * (t + 1) // 2)
    rate = BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def sdpa_call(q, k, v):
    """One ``scaled_dot_product_attention(is_causal=True)`` on the same
    inputs in its (B, H, T, d) layout, K/V at native width."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)


def gemma(dev, seed: int, **over):
    """A language model of Gemma-2B's architecture with weights N(0, 0.02)
    drawn on ``dev`` from ``seed`` (norm gains 1), as bench.py's synthetic
    checkpoint; ``over`` replaces config fields."""
    import torch

    from fraud_detection_tpu_torch.models.llm import (LanguageModel,
                                                      TransformerConfig)

    cfg = TransformerConfig(**{**GEMMA_2B, "dtype": torch.bfloat16, **over})
    return LanguageModel.init_random(cfg, seed=seed, device=dev, std=0.02)


def prefill(lm, dev, seed: int, card: str) -> dict:
    """The flash path's main run: one T=2048 forward with the launch count
    reset before and read after (18 = one per layer), held against the
    chunked path (``use_flash=False``) on the card; then prefill times at
    T=2048 and 8192 and a profiler breakdown at T=2048."""
    import torch

    from fraud_detection_tpu_torch.models.llm import forward
    from fraud_detection_tpu_torch.ops import attention as A

    cfg = lm.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, 8192), generator=g, device=dev)
    short = toks[:, :2048]
    with torch.inference_mode():
        A.flash_attention.launches = 0
        A.flash_attention_sm90.launches = A.flash_attention_simt.launches = 0
        flash = forward(lm.params, short, cfg, logits_last_only=True)[0][0, 0]
        torch.cuda.synchronize()
        launches = A.flash_attention.launches
        on_sm90 = A.flash_attention_sm90.launches
        plain = forward(lm.params, short, cfg, use_flash=False,
                        logits_last_only=True)[0][0, 0]
        torch.cuda.synchronize()
    if launches != cfg.n_layers or on_sm90 != cfg.n_layers:
        raise AssertionError(f"prefill launched the flash kernels {launches}x "
                             f"({on_sm90} on the sm90 route), want "
                             f"{cfg.n_layers} on sm90")
    dmax = float((flash - plain).abs().max())
    scale = float(plain.abs().max())
    same_top = int(flash.argmax()) == int(plain.argmax())
    # bf16 activations through 18 layers: the kernel rounds p to bf16, the
    # chunked path keeps it in f32, so the two drift by bf16 round-off.
    if not (bool(torch.isfinite(flash).all()) and dmax <= 0.05 * scale):
        raise AssertionError(f"prefill flash vs chunked: max |dlogit| {dmax} "
                             f"> 5% of max |logit| {scale}")
    print(f"[llm] prefill T=2048 ({cfg.n_layers} layers, bf16): flash kernel "
          f"{launches} launches, {on_sm90} on the sm90 route; last logits flash vs chunked max |d| "
          f"{dmax:.4g} (max |logit| {scale:.4g}, gate 5%), argmax "
          f"{'agrees' if same_top else 'differs'}")

    def run(t):
        return lambda: forward(lm.params, toks[:, :t], cfg,
                               logits_last_only=True)

    with torch.inference_mode():
        ms = {2048: cuda_ms(run(2048), 5, 2), 8192: cuda_ms(run(8192), 3, 1)}
        chunked_ms = cuda_ms(lambda: forward(lm.params, short, cfg,
                                             use_flash=False,
                                             logits_last_only=True), 3, 1)
        breakdown = device_breakdown(run(2048), reps=2)
    busy = sum(us for _, us, _ in breakdown)
    flash_us = sum(us for name, us, _ in breakdown if "flash_fwd" in name)
    print(f"[time] {card}: prefill tokens/s T=2048 {2048 / ms[2048] * 1e3:.0f} "
          f"({ms[2048]:.2f} ms), T=8192 {8192 / ms[8192] * 1e3:.0f} "
          f"({ms[8192]:.2f} ms); chunked path T=2048 {chunked_ms:.2f} ms")
    print(f"[trace] {card}: prefill T=2048 device busy {busy / 1e3:.2f} ms "
          f"of {ms[2048]:.2f} ms; flash kernel {flash_us / 1e3:.2f} ms "
          f"({100 * flash_us / max(busy, 1e-9):.1f}% of busy)")
    for name, us, n in breakdown[:8]:
        print(f"[trace]   {us:10.1f} us  x{n:.0f}  {name[:90]}")
    return dict(launches=launches, dlogit=dmax, logit_scale=scale,
                argmax_agrees=same_top, ms_2048=ms[2048], ms_8192=ms[8192],
                chunked_ms_2048=chunked_ms, busy_ms_2048=busy / 1e3,
                flash_ms_2048=flash_us / 1e3)


def llm_card_vs_cpu(dev, seed: int) -> dict:
    """Gemma widths at 2 layers in f32, card against CPU on the same weights:
    last logits at T=600 (flash kernel on the card, its plain version on the
    CPU) within 5e-4; greedy batched generation of uneven prompts equal on
    both, and equal to each prompt's B=1 generation on the card."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models.llm import (LanguageModel,
                                                      Transformer, forward)
    from fraud_detection_tpu_torch.ops import attention as A

    card = gemma(dev, seed, n_layers=2, dtype=torch.float32)
    params = Transformer(card.cfg, device="cpu")
    for name in params.param_names():
        params.param(name).data.copy_(card.params.param(name))
    cpu = LanguageModel(card.cfg, params)
    toks = torch.randint(0, card.cfg.vocab_size, (1, FLASH_SIMT_MAIN[1]),
                         generator=torch.Generator().manual_seed(seed))
    A.flash_attention.launches = 0
    A.flash_attention_sm90.launches = A.flash_attention_simt.launches = 0
    with torch.inference_mode():
        lg = forward(card.params, toks.to(dev), card.cfg,
                     logits_last_only=True)[0][0, 0].cpu()
        simt = A.flash_attention_simt.launches
        if simt != card.cfg.n_layers or A.flash_attention.launches != simt:
            raise AssertionError(f"the f32 card forward at T=600 ran the SIMT "
                                 f"flash kernel {simt}x of "
                                 f"{A.flash_attention.launches}, want "
                                 f"{card.cfg.n_layers}")
        lc = forward(cpu.params, toks, cpu.cfg, logits_last_only=True)[0][0, 0]
    err = float((lg - lc).abs().max())
    if not bool((lg - lc).abs().le(CARD_CPU_TOL * (1 + lc.abs())).all()):
        raise AssertionError(f"card vs cpu logits max |d| {err}")
    prompts = [GEN_PROMPTS[0], "Agent: hello, is this Mr Smith?",
               GEN_PROMPTS[5][:90]]
    enc = [card.tokenizer.encode(p) for p in prompts]
    tg = card.generate_tokens_batch(enc, max_new_tokens=8)
    tc = cpu.generate_tokens_batch(enc, max_new_tokens=8)
    if not np.array_equal(tg, tc):
        raise AssertionError(f"greedy tokens card {tg.tolist()} != cpu "
                             f"{tc.tolist()}")
    for i, e in enumerate(enc):
        if not np.array_equal(card.generate_tokens(e, max_new_tokens=8), tg[i]):
            raise AssertionError(f"f32 card: batched row {i} != its B=1 call")
    # sampled at temperature 1.0: both draw the same threefry noise, but the
    # logits differ by up to 5e-4, so a near-tie may flip a row (reported)
    sg = card.generate_tokens_batch(enc, max_new_tokens=8, temperature=1.0,
                                    seed=seed)
    sc = cpu.generate_tokens_batch(enc, max_new_tokens=8, temperature=1.0,
                                   seed=seed)
    sampled_equal = int(sum(np.array_equal(a, b) for a, b in zip(sg, sc)))
    print(f"[llm] sampled generation at temperature 1.0, card vs cpu: "
          f"{sampled_equal}/{len(enc)} rows equal (reported, not gated)")
    print(f"[llm] card vs cpu (Gemma widths, 2 layers, f32, T=600): last "
          f"logits max |d| {err:.3g} (tol {CARD_CPU_TOL}), SIMT flash kernel "
          f"{simt} launches; greedy tokens of {len(enc)} uneven prompts equal "
          "card/cpu and batched/single")
    return dict(dlogit=err, simt_launches=simt,
                sampled_rows_equal=sampled_equal, sampled_rows=len(enc))


def llm_generate(lm, card: str) -> dict:
    """Greedy generation of bench.py's 8 prompts, 64 new tokens, batched
    (host clock, after one warm call), and each prompt's B=1 call."""
    import numpy as np

    enc = [lm.tokenizer.encode(p) for p in GEN_PROMPTS]
    lm.generate_tokens_batch(enc, max_new_tokens=4)
    t0 = time.perf_counter()
    out = lm.generate_tokens_batch(enc, max_new_tokens=64)
    wall = time.perf_counter() - t0
    singles = [lm.generate_tokens(e, max_new_tokens=64) for e in enc]
    equal = [i for i in range(len(enc)) if np.array_equal(out[i], singles[i])]
    eos = lm.cfg.EOS
    emitted = int(sum(int(np.argmax(r == eos)) + 1 if (r == eos).any()
                      else len(r) for r in out))
    print(f"[llm] generate B=8 x 64 new tokens ({lm.cfg.dtype}, "
          f"{lm.cfg.n_layers} layers): {emitted} tokens up to EOS; rows "
          f"equal to their B=1 call: {len(equal)}/8 (reported, not gated: "
          "bf16 GEMMs at B=1 and B=8 may round apart; the f32 check above "
          "is the gate)")
    print(f"[time] {card}: generation B=8 x 64 tokens {wall:.3f} s host "
          f"clock, {8 * 64 / wall:.1f} tokens/s, {8 / wall:.3f} "
          "explanations/s")
    t0 = time.perf_counter()
    lm.generate_tokens_batch(enc, max_new_tokens=16)
    wall16 = time.perf_counter() - t0
    breakdown = device_breakdown(
        lambda: lm.generate_tokens_batch(enc, max_new_tokens=16), reps=1)
    busy = sum(us for _, us, _ in breakdown) / 1e3
    print(f"[trace] {card}: generate B=8 x 16 tokens: device busy {busy:.2f} "
          f"ms of a {wall16 * 1e3:.1f} ms wall "
          f"({100 * (1 - busy / (wall16 * 1e3)):.0f}% idle); "
          f"{sum(n for *_, n in breakdown):.0f} device ops")
    for name, us, n in breakdown[:8]:
        print(f"[trace]   {us:10.1f} us  x{n:.0f}  {name[:90]}")
    # one decode step's token choice at B=8 over the full vocabulary:
    # greedy against sampled (the threefry Gumbel noise in int64 torch ops)
    import torch

    from fraud_detection_tpu_torch.models.llm import _sample_token

    logits = torch.randn((8, lm.cfg.vocab_size), device=lm.device,
                         generator=torch.Generator(lm.device).manual_seed(3))
    greedy_ms = cuda_ms(lambda: _sample_token(0.0, logits, 0, 5), 20, 3)
    sampled_ms = cuda_ms(lambda: _sample_token(1.0, logits, 0, 5), 20, 3)
    print(f"[time] {card}: token choice at B=8 x {lm.cfg.vocab_size}: greedy "
          f"{greedy_ms:.4f} ms, sampled {sampled_ms:.4f} ms; a decode step "
          f"takes {wall16 * 1e3 / 16:.2f} ms (16-token wall / 16)")
    return dict(wall_s=wall, tokens_per_s=8 * 64 / wall,
                explanations_per_s=8 / wall, rows_equal_single=len(equal),
                busy_ms_16=busy, wall_ms_16=wall16 * 1e3,
                choice_greedy_ms=greedy_ms, choice_sampled_ms=sampled_ms)


def explained_stream_inputs(dev, ckpt: Path):
    """bench.py's explained-stream recipe on the port: 1,024 messages drawn
    from generate_corpus(n=2000, seed=42) with ~5% scams (rng 7), and the
    CLI's dt checkpoint as the in-domain classifier (device featurize,
    batch 512). Returns (pipeline, [(value, key)])."""
    import numpy as np

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    corpus = generate_corpus(n=2000, seed=42)
    scams = [d.text for d in corpus if d.label == 1]
    benign = [d.text for d in corpus if d.label == 0]
    rng = np.random.default_rng(7)
    texts = [(scams[int(rng.integers(len(scams)))] if rng.uniform() < 0.05
              else benign[int(rng.integers(len(benign)))])
             for _ in range(1024)]
    width = -(-max(len(t.encode()) for t in texts) // 64) * 64
    tokens = -(-max(sum(c.isspace() for c in t) + 1 for t in texts) // 16) * 16
    pipe = ServingPipeline.from_checkpoint(
        str(ckpt), device=dev, batch_size=512, featurize_device=True,
        featurize_width=width, featurize_tokens=tokens)
    items = [(json.dumps({"text": t, "id": i}).encode(), str(i).encode())
             for i, t in enumerate(texts)]
    return pipe, items


def run_stream(pipe, items, **kw):
    """One engine run (batch 512) over a fresh 3-partition broker holding
    ``items``: output keys must be exactly the fed keys. Returns (stats,
    {key: frame}, broker, engine)."""
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    broker = InProcessBroker(num_partitions=3)
    broker.producer().produce_batch("in", items)
    if kw.get("explain_async"):
        kw["annotations_producer"] = broker.producer()
    engine = StreamingClassifier(pipe, broker.consumer(["in"], "x"),
                                 broker.producer(), "out", batch_size=512,
                                 max_wait=0.01, **kw)
    stats = engine.run(max_messages=len(items), idle_timeout=10.0)
    out = broker.messages("out")
    if sorted(m.key for m in out) != sorted(k for _, k in items):
        raise AssertionError("explained stream: output keys != fed keys")
    if stats.processed != len(items):
        raise AssertionError(f"explained stream: {stats.processed} processed")
    return stats, {m.key: json.loads(m.value) for m in out}, broker, engine


def explained_stream(lm, dev, ckpt: Path, card: str) -> dict:
    """Phase 13: the explained stream with the inline hook,
    ``make_stream_explain_hook(OnPodBackend.from_model(lm), max_tokens=48)``
    (``explained_stream_inputs``). One warm run, then a timed run with the
    hook and one without. Gates: keys exact, frames carry exactly their
    fields, and ``analysis`` on exactly the flagged rows, with labels equal
    to the no-hook run's. Also returns the inputs and the flagged rows
    (text, label, confidence) for phases 13c-13d."""
    from fraud_detection_tpu_torch.explain.onpod import (
        OnPodBackend, make_stream_explain_hook)

    pipe, items = explained_stream_inputs(dev, ckpt)
    hook = make_stream_explain_hook(OnPodBackend.from_model(lm), max_tokens=48)
    run_stream(pipe, items, explain_batch_fn=hook)
    stats_x, frames_x, _, _ = run_stream(pipe, items, explain_batch_fn=hook)
    stats_0, frames_0, _, _ = run_stream(pipe, items)
    base = {"prediction", "label", "confidence", "original_text"}
    rows = []
    for key, f in frames_x.items():
        want = base | ({"analysis"} if f["prediction"] != 0 else set())
        if set(f) != want or f["prediction"] != frames_0[key]["prediction"]:
            raise AssertionError(f"explained frame {key}: fields {sorted(f)}, "
                                 f"prediction {f['prediction']} (no hook: "
                                 f"{frames_0[key]['prediction']})")
        if "analysis" in f:
            if not isinstance(f["analysis"], str):
                raise AssertionError(f"frame {key}: analysis {f['analysis']!r}")
            rows.append((f["original_text"], f["prediction"], f["confidence"]))
    flagged = len(rows)
    if flagged == 0:
        raise AssertionError("explained stream: no row was flagged")
    out = dict(messages=len(items), flagged=flagged,
               flagged_explanations_per_s=flagged / stats_x.elapsed,
               msgs_per_s_with_explain=stats_x.msgs_per_sec,
               msgs_per_s_without=stats_0.msgs_per_sec)
    print(f"[engine] explained stream: {len(items)} messages, {flagged} "
          "flagged, each flagged frame (and only those) carries analysis; "
          "keys exact")
    print(f"[time] {card}: explained stream msgs/s with hook "
          f"{stats_x.msgs_per_sec:.1f}, without {stats_0.msgs_per_sec:.1f}; "
          f"flagged explanations/s {flagged / stats_x.elapsed:.2f}")
    return out, pipe, items, rows


# ---------------------------------------------------------------------------
# the slot lane: slotserve, the paged pool, the async annotation lane
# ---------------------------------------------------------------------------

def serve_slots(lm, texts, temperature: float, seed: int, **kw):
    """Run ``texts`` through a 2-slot ``SlotServeService`` (12 new tokens,
    windows of 4) with every prompt queued before the lane's first
    iteration, so admission, and with it every window, is deterministic.
    Returns (the requests, every window's (out, new_lens, steps_run,
    active_row_steps), the service, closed)."""
    from fraud_detection_tpu_torch.explain.slotserve import SlotServeService

    svc = SlotServeService(lm, slots=2, max_new_tokens=12, prompt_width=384,
                           prompt_bucket=16, decode_window=4, seed=seed, **kw)
    windows, step = [], svc._decoder.step

    def recorded_step(*args):
        windows.append(step(*args))
        return windows[-1]

    svc._decoder.step = recorded_step
    try:
        # The idle lane waits on this condition's lock, so it finds the whole
        # queue at its first boundary.
        with svc._cv:
            reqs = [svc.submit(t, temperature=temperature) for t in texts]
        for r in reqs:
            r.wait(600.0)
        snap = svc.snapshot()
    finally:
        svc.close(timeout=60.0)
    if svc.fault is not None or snap["errors"] or snap["dropped"] or \
            snap["completed"] != len(texts):
        raise AssertionError(f"slot service: {snap}, fault {svc.fault!r}")
    return reqs, windows, svc


def windows_equal(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        and x[2] == y[2] and x[3] == y[3] for x, y in zip(a, b))


def slot_card_vs_cpu(dev, seed: int) -> dict:
    """Phase 13b: the slot programs at Gemma widths, 2 layers, f32 (phase
    11's model), card against CPU on the same weights, driven by the
    service's own scheduler. Five prompts through 2 slots (slot reuse), 12
    new tokens, windows of 4: two analysis prompts that share the explain
    preamble and two plain ones, then the first again. Gates: greedy tokens
    card == CPU, and each equal to its row of ``generate_tokens_batch`` on
    the card; the paged service (page 64, the shared preamble prefilled
    once, copy-on-write admits) gives the contiguous service's windows bit
    for bit (out, new_lens, steps_run, active_row_steps) on the card; the
    repeated prompt in a reused slot equals its first decode; no page leaks.
    Sampled rows at temperature 1.0, card vs CPU, are reported (not
    gated)."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.explain.backends import frame_prompt
    from fraud_detection_tpu_torch.explain.onpod import flatten_chat
    from fraud_detection_tpu_torch.explain.prompts import analysis_prompt
    from fraud_detection_tpu_torch.explain.slotserve.service import (
        shared_explain_prefix)
    from fraud_detection_tpu_torch.models.llm import LanguageModel, Transformer

    card = gemma(dev, seed, n_layers=2, dtype=torch.float32)
    params = Transformer(card.cfg, device="cpu")
    for name in params.param_names():
        params.param(name).data.copy_(card.params.param(name))
    cpu = LanguageModel(card.cfg, params)
    texts = [flatten_chat(frame_prompt(analysis_prompt(t, 1, 0.93)))
             for t in ("Caller: this is your bank, read me the code now.",
                       "Agent: your parcel is held; pay the customs fee in "
                       "gift cards today.")]
    texts += [GEN_PROMPTS[0], "Agent: hello, is this Mr Smith?", texts[0]]
    req_g, win_g, _ = serve_slots(card, texts, 0.0, seed)
    req_c, _, _ = serve_slots(cpu, texts, 0.0, seed)
    req_p, win_p, paged = serve_slots(card, texts, 0.0, seed, paged=True)
    rows_g, rows_c, rows_p = ([r.out for r in reqs]
                              for reqs in (req_g, req_c, req_p))
    if rows_g != rows_c:
        raise AssertionError(f"slot greedy tokens card {rows_g} != cpu {rows_c}")
    batch = card.generate_tokens_batch([r.tokens for r in req_g[:4]],
                                       max_new_tokens=12)
    for i, row in enumerate(rows_g[:4]):
        if not np.array_equal(batch[i][:len(row)], row):
            raise AssertionError(f"slot row {i} {row} != generate_tokens_batch "
                                 f"{batch[i].tolist()}")
    if rows_g[4] != rows_g[0]:
        raise AssertionError("the reused slot's decode differs from the fresh one")
    if not windows_equal(win_g, win_p) or rows_p != rows_g:
        raise AssertionError("paged windows != contiguous windows on the card")
    dec = paged._decoder
    if dec.prefix_hits != 3 or dec.cow_copies != 3:
        raise AssertionError(f"paged: {dec.prefix_hits} prefix hits, "
                             f"{dec.cow_copies} copy-on-write admits, want 3")
    if dec.leaked_pages:
        raise AssertionError(f"paged decoder leaked {dec.leaked_pages} pages")
    s_g, _, _ = serve_slots(card, texts[:4], 1.0, seed)
    s_c, _, _ = serve_slots(cpu, texts[:4], 1.0, seed)
    sampled_equal = sum(a.out == b.out for a, b in zip(s_g, s_c))
    print(f"[slot] card vs cpu (Gemma widths, 2 layers, f32): {len(texts)} "
          f"prompts through a 2-slot service, {len(win_g)} windows: greedy "
          "tokens equal card/cpu and to generate_tokens_batch; paged (prefix "
          f"{len(shared_explain_prefix()) + 1} tokens, 3 hits, 3 copy-on-write "
          "admits) == contiguous window for window bit for bit; reused slot "
          "== fresh; 0 leaked pages")
    print(f"[slot] sampled at temperature 1.0, card vs cpu: {sampled_equal}/4 "
          "rows equal (reported, not gated)")
    del paged, dec, card, cpu
    torch.cuda.empty_cache()
    return dict(windows=len(win_g), rows=len(texts), paged_equal=True,
                sampled_rows_equal=sampled_equal, sampled_rows=4)


def count_host_syncs(fn):
    """Synchronizing CUDA calls made by ``fn`` (``torch.cuda``'s sync debug
    mode, one warning each): (count, the distinct warnings' first lines)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # one warning per synchronizing call (torch's one-time notice that the
    # mode is a prototype is not one)
    lines = [str(w.message).splitlines()[0][:120] for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return len(lines), sorted(set(lines))


def slot_window_figures(dec, prompt, card: str) -> dict:
    """Host syncs of one decode window and its device-idle share: every slot
    prefilled with ``prompt``, then one 16-step window over the pool."""
    import numpy as np

    B, eos = dec.slots, dec.cfg.EOS

    def setup():
        firsts = [dec.prefill(s, prompt, 0.0, s) for s in range(B)]
        args = (np.asarray(firsts, np.int32), np.full(B, len(prompt), np.int32),
                np.ones(B, bool), np.full(B, 16, np.int32),
                np.zeros(B, np.float32), 0, 16)
        return lambda: dec.step(*args)

    window = setup()
    syncs, what = count_host_syncs(window)
    prefill_syncs, prefill_what = count_host_syncs(
        lambda: dec.prefill(0, prompt, 0.0, 0))
    idle = profiled_idle(setup)
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3
    breakdown = device_breakdown(window, reps=1)
    busy = sum(us for _, us, _ in breakdown) / 1e3
    for s in range(B):
        dec.release_slot(s)
    print(f"[slot] one 16-step window at B={B}: {syncs} host syncs "
          f"(sync debug mode: {what}), a prefill {prefill_syncs} "
          f"({prefill_what}); device idle {100 * idle:.1f}% ({card})")
    print(f"[trace] {card}: a 16-step window: device busy {busy:.2f} ms of a "
          f"{wall_ms:.1f} ms wall, {sum(n for *_, n in breakdown):.0f} device "
          "ops")
    for name, us, n in breakdown[:8]:
        print(f"[trace]   {us:10.1f} us  x{n:.0f}  {name[:90]}")
    return dict(window_host_syncs=syncs, prefill_host_syncs=prefill_syncs,
                window_device_idle=idle, window_wall_ms=wall_ms,
                window_busy_ms=busy, sync_sources=what)


def slot_lane(lm, flagged_rows, card: str) -> dict:
    """Phase 13c: ``SlotServeService`` at full width (phase 10's model, 8
    slots, 48 new tokens, prompt width 464 in 16-token buckets: max_len
    512), contiguous, then paged (page 64, the shared preamble, the pool
    capped at 37 pages: 5 for the preamble and 4 private pages for each of
    the 8 slots). Each runs ``explain_rows`` over the first SLOT_LANE_ROWS
    of phase 13's flagged rows and ``generate_batch`` over bench.py's 8
    prompts. Gates: every request
    completed, ``admitted == completed + dropped``, 0 leaked pages, and the
    paged service's greedy texts equal the contiguous one's. Each mode's
    peak device memory above the model (pool, windows' transients) is
    printed beside its reserved ``kv_bytes``."""
    import torch

    from fraud_detection_tpu_torch.explain.slotserve import SlotServeService

    geo = dict(slots=8, max_new_tokens=48, prompt_width=464,
               prompt_bucket=16, decode_window=16, wait_timeout=600.0)
    texts, labels, confs = (list(c) for c in zip(*flagged_rows[
        :SLOT_LANE_ROWS]))
    results, replies = {}, {}
    for mode, kw in (("contiguous", {}),
                     ("paged", dict(paged=True, kv_pages=37))):
        # The lane's device memory: the pool plus everything a window
        # allocates on top of it (the paged window's gathered view too).
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        svc = SlotServeService(lm, **geo, **kw)
        try:
            t0 = time.perf_counter()
            got = svc.explain_rows(texts, labels, confs, max_tokens=48)
            got += svc.generate_batch(GEN_PROMPTS, temperature=0.0,
                                      max_tokens=48)
            wall = time.perf_counter() - t0
            snap = svc.snapshot()
        finally:
            clean = svc.close(timeout=60.0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        n = len(texts) + len(GEN_PROMPTS)
        if not clean or snap["completed"] != n or snap["dropped"] != 0 or \
                snap["admitted"] != snap["completed"] + snap["dropped"]:
            raise AssertionError(f"slot lane {mode}: {snap} (clean close "
                                 f"{clean})")
        leaked = getattr(svc._decoder, "leaked_pages", 0)
        if leaked:
            raise AssertionError(f"slot lane {mode}: {leaked} pages leaked")
        del svc     # its pool must not count in the next mode's base
        replies[mode] = got
        results[mode] = dict(
            requests=n, wall_s=wall, tokens_per_s=snap["tokens_out"] / wall,
            explanations_per_s=n / wall, occupancy=snap["occupancy"],
            latency_ms=snap["latency_ms"],
            admit_to_first_token_ms=snap["admit_to_first_token_ms"],
            decode_steps=snap["decode_steps"], iterations=snap["iterations"],
            tokens_out=snap["tokens_out"], truncated=snap["truncated"],
            kv_bytes=snap["kv_bytes"], kv_pages=snap["kv_pages"],
            prefix_hits=snap["prefix_hits"], cow_copies=snap["cow_copies"],
            kv_bytes_saved_vs_contiguous=snap["kv_bytes_saved_vs_contiguous"],
            peak_lane_bytes=peak)
        r = results[mode]
        print(f"[time] {card}: slot lane {mode}: {n} requests ({len(texts)} "
              f"flagged rows + 8 bench prompts) in {wall:.3f} s: "
              f"{r['tokens_per_s']:.1f} tokens/s, {r['explanations_per_s']:.2f} "
              f"explanations/s, occupancy {r['occupancy']}, latency p50/p99 "
              f"{r['latency_ms']['p50']} / {r['latency_ms']['p99']} ms, "
              f"{r['decode_steps']} decode steps in {r['iterations']} "
              f"iterations; kv_bytes {r['kv_bytes']}, saved vs contiguous "
              f"{r['kv_bytes_saved_vs_contiguous']}, prefix hits "
              f"{r['prefix_hits']}, copy-on-write {r['cow_copies']}; peak "
              f"device memory over the model {peak} bytes")
    if replies["paged"] != replies["contiguous"]:
        diff = sum(a != b for a, b in zip(replies["paged"],
                                          replies["contiguous"]))
        raise AssertionError(f"slot lane: {diff} paged replies differ from "
                             "the contiguous service's")
    from fraud_detection_tpu_torch.explain.slotserve.decode import SlotDecoder

    dec = SlotDecoder(lm, 8, prompt_width=464, max_new_tokens=48,
                      prompt_bucket=16)
    prompt, _ = dec.encode_prompt(GEN_PROMPTS[0])
    results["window"] = slot_window_figures(dec, prompt, card)
    del dec
    print("[slot] paged greedy replies == contiguous replies; every request "
          "completed, admitted == completed + dropped, 0 leaked pages")
    return results


def explained_stream_async(lm, pipe, items, sync: dict, card: str) -> dict:
    """Phase 13d: phase 13's stream with ``explain_async=True`` and
    ``make_slot_explain_hook`` over a contiguous ``SlotServeService`` (phase
    13c's geometry). Gates: output keys exactly the fed keys, no frame
    carries ``analysis``, the annotations topic holds exactly one record
    per flagged row and nothing else, each an explanation (no dropped or
    unavailable marker), and the service decoded every flagged row with no
    fault, error or drop (nor did the annotation lane drop or fail). Prints
    msgs/s and flagged explanations/s beside phase 13's inline figures."""
    from fraud_detection_tpu_torch.explain.slotserve import (
        DROPPED_MARKER, UNAVAILABLE_MARKER, SlotServeService,
        make_slot_explain_hook)

    svc = SlotServeService(lm, slots=8, max_new_tokens=48, prompt_width=464,
                           prompt_bucket=16, decode_window=16)
    try:
        hook = make_slot_explain_hook(svc, max_tokens=48)
        t0 = time.perf_counter()
        stats, frames, broker, engine = run_stream(
            pipe, items, explain_batch_fn=hook, explain_async=True,
            explain_service=svc)
        drained = engine.close_annotations(timeout=300.0)
        wall = time.perf_counter() - t0
        lane = engine.annotation_stats()
        snap = svc.snapshot()
    finally:
        svc.close(timeout=60.0)
    flagged = {k for k, f in frames.items() if f["prediction"] != 0}
    recs = [(m.key, json.loads(m.value))
            for m in broker.messages("out-annotations")]
    if any("analysis" in f for f in frames.values()):
        raise AssertionError("async stream: a frame carries analysis")
    if not drained or sorted(k for k, _ in recs) != sorted(flagged):
        raise AssertionError(f"async stream: {len(recs)} annotation records "
                             f"for {len(flagged)} flagged rows (drained "
                             f"{drained}, lane {lane})")
    markers = tuple(m.split("{")[0] for m in (DROPPED_MARKER,
                                               UNAVAILABLE_MARKER))
    for key, rec in recs:
        if rec["prediction"] != frames[key]["prediction"] or \
                not isinstance(rec["analysis"], str) or \
                rec["analysis"].startswith(markers):
            raise AssertionError(f"async stream: record {key} {rec}")
    # A decoder that faults or throws still yields one (marker) record per
    # flagged row, so the lane's own counts decide: every flagged row was
    # decoded, none dropped or failed.
    if svc.fault is not None or snap["errors"] or snap["dropped"] or \
            snap["completed"] != len(flagged) or \
            snap["admitted"] != snap["completed"] + snap["dropped"] or \
            lane["dropped"] or lane["backend_errors"]:
        raise AssertionError(f"async stream: slot lane {snap}, annotation "
                             f"lane {lane}, fault {svc.fault!r}")
    out = dict(messages=len(items), flagged=len(flagged),
               msgs_per_s=stats.msgs_per_sec,
               flagged_explanations_per_s=len(flagged) / wall,
               wall_to_last_annotation_s=wall, lane=lane,
               slot_occupancy=snap["occupancy"])
    print(f"[engine] async explained stream: {len(items)} messages, "
          f"{len(flagged)} flagged, no frame carries analysis, one annotation "
          f"record per flagged row ({lane})")
    print(f"[time] {card}: async explained stream msgs/s "
          f"{stats.msgs_per_sec:.1f} (inline hook {sync['msgs_per_s_with_explain']:.1f},"
          f" no hook {sync['msgs_per_s_without']:.1f}); flagged explanations/s "
          f"{len(flagged) / wall:.2f} to the last annotation (inline "
          f"{sync['flagged_explanations_per_s']:.2f})")
    return out


def slot_serve_cli(dev, card: str) -> dict:
    """Phase 13e: ``serve --model synthetic --explain onpod-demo
    --explain-slots 4 --explain-tokens 8 --demo 4096 --batch-size 1024``,
    contiguous, then ``--explain-paged --breaker 3``: each exits 0 and
    classifies every message, and its stats JSON's ``explain`` block holds
    ``admitted == completed + dropped`` with requests completed and no
    errors."""
    results = {}
    for name, extra in (("contiguous", []),
                        ("paged_breaker", ["--explain-paged", "--breaker",
                                           "3"])):
        r = serve_cli(["--device", str(dev), "--model", "synthetic", "--demo",
                       str(SERVE_DEMO), "--batch-size", "1024", "--explain",
                       "onpod-demo", "--explain-slots", "4",
                       "--explain-tokens", "8", *extra], card)
        stats, ex = r["stats"], r["stats"]["explain"]
        if r["classified"] != SERVE_DEMO or stats["processed"] != SERVE_DEMO \
                or ex["admitted"] != ex["completed"] + ex["dropped"] \
                or ex["completed"] == 0 or ex["errors"]:
            raise AssertionError(f"serve {name}: classified {r['classified']},"
                                 f" explain {ex}")
        results[name] = dict(msgs_per_sec=stats["msgs_per_sec"], explain=ex,
                             annotations=stats["annotations"])
        print(f"[serve] slot lane {name}: explain admitted {ex['admitted']} = "
              f"completed {ex['completed']} + dropped {ex['dropped']}; "
              f"annotations {stats['annotations']}")
    return results


# ---------------------------------------------------------------------------
# weight-only int8: the W8A16 kernel, HF checkpoints, the int8 decoder
# ---------------------------------------------------------------------------

# Gemma-2B's weight products as (K, N, layout): a layer's wq and wo, wk and wv,
# w_gate and w_up, w_down, and the tied head, in w8_matmul's layouts.
W8_SHAPES = {"wq,wo": (2048, 2048, "kn"), "wk,wv": (2048, 256, "kn"),
             "w_gate,w_up": (2048, 16_384, "kn"), "w_down": (16_384, 2048, "kn"),
             "head": (2048, 256_000, "nk")}
# launches of each shape in one decode step of the 18-layer model (127)
W8_STEP_LAUNCHES = {"wq,wo": 36, "wk,wv": 36, "w_gate,w_up": 36, "w_down": 18,
                    "head": 1}
W8_M = (1, 8, 35, 64, 512, 2048)
W8_RAGGED = (1008, 1000)       # K (a ragged 128-k chunk), N (a ragged tile)
# The row-independence gate: rows [5, 29) of an M = 64 or M = 2048 launch
# against a launch of those rows alone (M = 24: another block shape).
W8_ROWS = (5, 29)
# The dispatch-boundary gate: rows [0, 8) of the M = 2048 launch (128-token
# tiles, the K splits added in registers) against an M = 8 launch of those
# rows (8-token tiles, the splits in separate blocks and a second pass), and
# row 0 of that against an M = 1 launch.
W8_BOUNDARY_ROWS = (8, 1)
# f32: the kernel and cuBLAS sum the same products in other orders, within
# 1e-5 of the largest |y| (the f32 flash gate's order of magnitude). bf16:
# the output is rounded twice (x.q to bf16, times the scale to bf16), so a
# kernel and a plain value whose f32 sums straddle a rounding boundary sit
# one step apart at each rounding: two bf16 steps of the larger of the two;
# plus 2^-15 of the output's sum of |x q| times its scale, the f32 sums' own
# order difference (about sqrt(K) 2^-24 of it, 2^-17 at K = 16,384, taken 4
# times), which decides outputs near zero where the products cancel.
W8_F32_TOL = 1e-5
W8_BF16_STEPS, W8_BF16_SUM_TOL = 2, 2.0 ** -15
# Gemma-2B's architecture as an HF config.json (bench.py GEMMA2B_HF_CONFIG).
GEMMA2B_HF_CONFIG = {
    "model_type": "gemma", "vocab_size": 256_000, "hidden_size": 2048,
    "intermediate_size": 16_384, "num_hidden_layers": 18,
    "num_attention_heads": 8, "num_key_value_heads": 1, "head_dim": 256,
    "hidden_act": "gelu", "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": True,
}
# The reference's bar for int8 against full-precision logits (a trained 2B
# model). On these N(0, 0.02) weights the per-channel codes' noise grows with
# depth (on an NVIDIA H100: 0.99964 at 2 layers, 0.9971 at 18, with the
# quantizer bit-equal to the JAX package's), so the bar is held at full width
# and 2 layers, and the 18-layer figure is reported beside it.
INT8_CORR_MIN = 0.999


def w8_weight(k: int, n: int, layout: str, dev, seed: int):
    """An int8 weight as ``quantize_params`` makes it: a bf16 N(0, 0.02)
    matrix (K, N), or (N, K) for the head, drawn on the card from ``seed``
    and quantized per output channel. Returns (q, scale (N,))."""
    import torch

    from fraud_detection_tpu_torch.models.llm import _quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    shape, axes = ((k, n), (0,)) if layout == "kn" else ((n, k), (1,))
    w = (torch.randn(shape, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    q8 = _quantize(w, axes)
    return q8.q, q8.scale.reshape(-1)


def check_w8(label: str, x, q, scale, layout: str, quiet: bool = True) -> float:
    """The kernel twice and its plain version once on the same CUDA tensors;
    raises unless the launches are bit-equal, rows ``W8_ROWS`` of an M = 64 or
    2048 launch equal a launch of those rows alone (another block shape), at
    M = 2048 rows ``W8_BOUNDARY_ROWS`` equal launches of those rows alone
    across the dispatch's boundaries, and |kernel - plain| is within the
    tolerance of x's dtype (``W8_F32_TOL``, ``W8_BF16_STEPS``). Returns max
    |kernel - plain|."""
    import torch

    from fraud_detection_tpu_torch.ops import int8_matmul as W

    a = W.w8_matmul(x, q, scale, layout)
    b = W.w8_matmul(x, q, scale, layout)
    rows = None
    if x.shape[0] in (64, 2048):
        lo, hi = W8_ROWS
        rows = W.w8_matmul(x[lo:hi].contiguous(), q, scale, layout)
    edge = None
    if x.shape[0] == 2048:
        edge = [W.w8_matmul(x[:r].contiguous(), q, scale, layout)
                for r in W8_BOUNDARY_ROWS]
    ref = W.w8_matmul_reference(x, q, scale, layout).float()
    if x.dtype == torch.bfloat16:
        w = q.float() if layout == "kn" else q.float().T
        sums = (x.float().abs() @ w.abs()) * scale
        del w
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"w8_matmul {label}: two launches differ")
    if rows is not None and not torch.equal(rows, a[W8_ROWS[0]:W8_ROWS[1]]):
        raise AssertionError(f"w8_matmul {label}: rows {W8_ROWS} alone differ "
                             f"from the same rows of the M = {x.shape[0]} launch")
    if edge is not None:
        wide, narrow = W8_BOUNDARY_ROWS
        if not torch.equal(edge[0], a[:wide]):
            raise AssertionError(f"w8_matmul {label}: an M = {wide} launch "
                                 f"differs from rows [0, {wide}) of M = 2048")
        if not torch.equal(edge[1], edge[0][:narrow]):
            raise AssertionError(f"w8_matmul {label}: an M = {narrow} launch "
                                 f"differs from rows [0, {narrow}) of M = {wide}")
    diff = (a.float() - ref).abs()
    err = float(diff.max())
    if x.dtype == torch.bfloat16:
        mag = torch.maximum(a.float().abs(), ref.abs())
        step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
        bound = W8_BF16_STEPS * step + W8_BF16_SUM_TOL * sums
        worst = float((diff / step).max())
        ok = bool((diff <= bound).all())
        limit = (f"{W8_BF16_STEPS} bf16 steps + {W8_BF16_SUM_TOL:.3g} of "
                 f"sum |x q| scale; worst {worst:.2f} steps")
    else:
        ok = err <= W8_F32_TOL * float(ref.abs().max())
        limit = f"{W8_F32_TOL} of max |y| {float(ref.abs().max()):.4g}"
    if not (ok and bool(torch.isfinite(a).all())):
        raise AssertionError(f"w8_matmul {label}: kernel vs plain max |diff| "
                             f"{err} beyond {limit}")
    if not quiet:
        print(f"[check] w8_matmul {label}: max |diff| {err:.3g} ({limit}), "
              "two launches bit-equal"
              + (f", rows {W8_ROWS} alone equal" if rows is not None else "")
              + (f", M = {W8_BOUNDARY_ROWS} launches equal its first rows"
                 if edge is not None else ""))
    return err


def check_w8_all(dev, seed: int) -> dict:
    """Phase 3 (w8_matmul): the kernel against its plain version at every
    Gemma-2B weight shape (``W8_SHAPES``) at M in ``W8_M``, bf16 and f32,
    and at a ragged M, N and K in both layouts, whose plans split K with a
    ragged last split (checked). Returns {label: max |diff|}."""
    import torch

    from fraud_detection_tpu_torch.ops import int8_matmul as W

    errs = {}
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = dict(W8_SHAPES)
    shapes["ragged"] = (*W8_RAGGED, "kn")
    shapes["ragged_nk"] = (*W8_RAGGED, "nk")
    for i, (name, (k, n, layout)) in enumerate(shapes.items()):
        q, scale = w8_weight(k, n, layout, dev, seed + i)
        ms = (3, 35, 64) if name.startswith("ragged") else W8_M
        for dtype in (torch.bfloat16, torch.float32):
            plan = W._plan(k, n, layout, dtype)
            last = k - (plan.splits - 1) * plan.split_len
            if name.startswith("ragged") and not (plan.splits > 1
                                                  and last < plan.split_len):
                raise AssertionError(f"w8_matmul {name} {str(dtype)[6:]}: "
                                     f"{plan} has no ragged last split")
            routes = sorted({W._config(m, k, n, layout, dtype)[1:] for m in ms})
            print(f"[check] w8_matmul {name} {str(dtype)[6:]} plan: "
                  f"{plan.splits} K splits of {plan.split_len} (last "
                  f"{last}), {plan.tile}-channel tiles; (rows a block, splits "
                  f"in blocks of their own) over M in {ms}: {routes}")
            worst = 0.0
            for m in ms:
                x = torch.randn((m, k), generator=g, device=dev).to(dtype)
                label = f"{name} {layout} {str(dtype)[6:]} M={m}"
                errs[label] = check_w8(label, x, q, scale, layout)
                worst = max(worst, errs[label])
            print(f"[check] w8_matmul {name} ({layout}, K={k}, N={n}) "
                  f"{str(dtype)[6:]}: M in {ms} within "
                  + (f"{W8_BF16_STEPS} bf16 steps (+ {W8_BF16_SUM_TOL:.3g} of "
                     "sum |x q| scale)" if dtype == torch.bfloat16
                     else f"{W8_F32_TOL} of max |y|")
                 + f", max |diff| {worst:.3g}; every M two launches "
                 f"bit-equal; rows {W8_ROWS} of M=64 and 2048 alone equal"
                 + ("" if name.startswith("ragged") else
                    f"; M = {W8_BOUNDARY_ROWS} launches equal M = 2048's "
                    "first rows"))
        del q, scale
    torch.cuda.empty_cache()
    return errs


def write_gemma_checkpoint(path: Path, dev, seed: int, n_layers: int = 18) -> int:
    """An HF checkpoint of Gemma-2B's architecture (``GEMMA2B_HF_CONFIG``,
    ``n_layers`` layers) in ``path``: bf16 N(0, 0.02) weights drawn on the
    card from ``seed``, Gemma's zero norms (gamma - 1), one
    model.safetensors, config.json last. Returns the bytes written."""
    import torch

    from fraud_detection_tpu_torch.checkpoint.hf_convert import (
        write_safetensors)

    c = {**GEMMA2B_HF_CONFIG, "num_hidden_layers": n_layers}
    D, dh, F = c["hidden_size"], c["head_dim"], c["intermediate_size"]
    H, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.02).to(
            torch.bfloat16).cpu()

    zeros = torch.zeros(D, dtype=torch.bfloat16)
    tensors = {"model.embed_tokens.weight": w(c["vocab_size"], D),
               "model.norm.weight": zeros}
    for l in range(n_layers):
        pre = f"model.layers.{l}."
        tensors.update({
            pre + "self_attn.q_proj.weight": w(H * dh, D),
            pre + "self_attn.k_proj.weight": w(Hkv * dh, D),
            pre + "self_attn.v_proj.weight": w(Hkv * dh, D),
            pre + "self_attn.o_proj.weight": w(D, H * dh),
            pre + "mlp.gate_proj.weight": w(F, D),
            pre + "mlp.up_proj.weight": w(F, D),
            pre + "mlp.down_proj.weight": w(D, F),
            pre + "input_layernorm.weight": zeros,
            pre + "post_attention_layernorm.weight": zeros})
    write_safetensors(str(path / "model.safetensors"), tensors)
    with open(path / "config.json", "w") as f:
        json.dump(c, f)
    return sum(t.numel() * t.element_size() for t in tensors.values())


def timed_load(path: Path, want_source: str, **kw):
    """``load_hf_checkpoint(path, tokenizer="byte", **kw)`` on the card with
    its wall (host clock to a synchronized card); raises unless
    ``load_info["source"]`` is ``want_source``."""
    import torch

    from fraud_detection_tpu_torch.checkpoint.hf_convert import (
        load_hf_checkpoint)

    info = {}
    t0 = time.perf_counter()
    lm = load_hf_checkpoint(str(path), tokenizer="byte", load_info=info, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if info.get("source") != want_source:
        raise AssertionError(f"load {kw}: source {info.get('source')}, want "
                             f"{want_source}")
    return lm, wall


def weight_bytes(params) -> int:
    """Device bytes of a model's weights (int8 codes and scales included)."""
    return sum(t.numel() * t.element_size()
               for t in list(params.parameters()) + list(params.buffers()))


def load_gemma(path: Path, dev, seed: int, card: str):
    """Phase 10's models from the synthetic checkpoint: bf16 from the shards
    (``hf_shards``) and again warm (``bf16_cache``), int8 from the bf16
    cache (the int8 miss, ``bf16_cache``) and again warm (``q8_cache``).
    Gates: each load's source; the int8 params equal ``quantize_params`` of
    the bf16 model on the card bit for bit, and the warm int8 reload equals
    the first. Returns (bf16 model, int8 model, figures)."""
    import torch

    from fraud_detection_tpu_torch.models.llm import Q8, quantize_params

    free = shutil.disk_usage(path).free
    print(f"[load] free disk space at {path}: {free / 1e9:.1f} GB (the shards "
          "and both caches take ~13 GB)")
    t0 = time.perf_counter()
    nbytes = write_gemma_checkpoint(path, dev, seed)
    write_s = time.perf_counter() - t0
    lm, cold_bf16 = timed_load(path, "hf_shards")
    warm, warm_bf16 = timed_load(path, "bf16_cache")
    del warm
    lm8, miss_int8 = timed_load(path, "bf16_cache", int8=True)
    warm8, warm_int8 = timed_load(path, "q8_cache", int8=True)
    ref = quantize_params(lm.params)
    torch.cuda.synchronize()

    def same(a, b) -> bool:
        if isinstance(a, Q8) or isinstance(b, Q8):
            return (isinstance(a, Q8) and isinstance(b, Q8)
                    and torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale))
        return torch.equal(a, b)

    for name in ref.param_names():
        if not same(ref.param(name), lm8.params.param(name)):
            raise AssertionError(f"int8 load: {name} differs from "
                                 "quantize_params of the bf16 model on the card")
        if not same(lm8.params.param(name), warm8.params.param(name)):
            raise AssertionError(f"int8 load: {name} of the q8 cache differs")
    del ref, warm8
    torch.cuda.empty_cache()
    out = dict(checkpoint_bytes=nbytes, write_s=write_s,
               load_s={"bf16 hf_shards": cold_bf16, "bf16 bf16_cache": warm_bf16,
                       "int8 bf16_cache": miss_int8, "int8 q8_cache": warm_int8},
               weight_bytes={"bf16": weight_bytes(lm.params),
                             "int8": weight_bytes(lm8.params)})
    print(f"[load] Gemma-2B checkpoint ({nbytes / 1e9:.3f} GB of bf16 "
          f"shards) written in {write_s:.1f} s; load walls ({card}): bf16 from "
          f"the shards {cold_bf16:.1f} s, from the bf16 cache {warm_bf16:.1f} "
          f"s; int8 from the bf16 cache {miss_int8:.1f} s, from the q8 cache "
          f"{warm_int8:.1f} s; sources hf_shards, bf16_cache, bf16_cache, "
          "q8_cache; int8 params == quantize_params(bf16) on the card bit for "
          f"bit; weights on the card bf16 {out['weight_bytes']['bf16']} B, "
          f"int8 {out['weight_bytes']['int8']} B")
    return lm, lm8, out


def logits_corr(pairs) -> float:
    """Pearson correlation over every logit of ``pairs``, a sequence of
    (a, b) logit tensors, summed in float64."""
    import torch

    sums = torch.zeros(6, dtype=torch.float64)
    for a, b in pairs:
        a, b = a.double().ravel(), b.double().ravel()
        sums += torch.stack([a.new_tensor(a.numel()), a.sum(), b.sum(),
                             (a * b).sum(), (a * a).sum(), (b * b).sum()]).cpu()
    n, sa, sb, sab, saa, sbb = sums.tolist()
    return (sab - sa * sb / n) / math.sqrt((saa - sa * sa / n)
                                           * (sbb - sb * sb / n))


def int8_gates(lm, lm8, dev, card: str) -> dict:
    """Phase 10 at int8. Gates: one decode step (B = 8, one token each)
    launches ``w8_matmul`` 7 x 18 + 1 times, none on the SIMT route; the
    int8 model's logits on ``GEN_PROMPTS`` against the same int8 model
    through the plain version of the product (``w8_matmul_reference``,
    cuBLAS on the dequantized weight) within 5% of max |logit|, phase 10's
    flash gate (bf16 through 18 layers); full-width logits of int8 against
    bf16 correlated above ``INT8_CORR_MIN`` at 2 layers (the model's first
    two). The 18-layer correlation is reported."""
    import torch

    from fraud_detection_tpu_torch.models import llm
    from fraud_detection_tpu_torch.models.llm import (Transformer, forward,
                                                      init_cache,
                                                      quantize_params)
    from fraud_detection_tpu_torch.ops import int8_matmul as W

    cfg = lm8.cfg
    tok = torch.tensor([[65 + i] for i in range(8)], device=dev)
    pos = torch.full((8, 1), 3, dtype=torch.int64, device=dev)
    cache = init_cache(cfg, 8, 16, dev)
    with torch.inference_mode():
        forward(lm8.params, tok, cfg, positions=pos, kv_cache=cache,
                cache_len=3)
        torch.cuda.synchronize()
        W.w8_matmul.launches = W.w8_matmul.simt_launches = 0
        forward(lm8.params, tok, cfg, positions=pos, kv_cache=cache,
                cache_len=3)
        torch.cuda.synchronize()
    step_launches = W.w8_matmul.launches
    want = 7 * cfg.n_layers + 1
    if step_launches != want or W.w8_matmul.simt_launches:
        raise AssertionError(f"an int8 decode step launched w8_matmul "
                             f"{step_launches}x ({W.w8_matmul.simt_launches} "
                             f"SIMT), want {want} on the mma route")
    cfg2 = dataclasses.replace(lm.cfg, n_layers=2)
    two = Transformer.from_leaves(cfg2, {n: lm.params.param(n)
                                         for n in Transformer(cfg2, "meta").param_names()})
    two8 = quantize_params(two)
    prompts = [torch.from_numpy(lm.tokenizer.encode(p).astype("int64"))[None].to(dev)
               for p in GEN_PROMPTS]
    worst = scale = 0.0
    with torch.inference_mode():
        def logits(params, c=cfg):
            return [forward(params, t, c)[0] for t in prompts]

        full, full8 = logits(lm.params), logits(lm8.params)
        real = llm.w8_matmul
        llm.w8_matmul = W.w8_matmul_reference
        try:
            plain8 = logits(lm8.params)
        finally:
            llm.w8_matmul = real
        for b, c in zip(full8, plain8):
            worst = max(worst, float((b - c).abs().max()))
            scale = max(scale, float(c.abs().max()))
        corr18 = logits_corr(zip(full, full8))
        corr_plain = logits_corr(zip(full8, plain8))
        del full, full8, plain8
        corr2 = logits_corr(zip(logits(two, cfg2), logits(two8, cfg2)))
    long = torch.randint(0, 258, (1, 2048), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    with torch.inference_mode():
        runs = {name: (lambda p=p: forward(p, long, cfg, logits_last_only=True))
                for name, p in (("bf16", lm.params), ("int8", lm8.params))}
        prefill_ms = {"bf16": [], "int8": []}
        for name in ("bf16", "int8", "int8", "bf16"):
            prefill_ms[name].append(cuda_ms(runs[name], 3, 1))
    if not worst <= 0.05 * scale:
        raise AssertionError(f"int8 logits, kernel vs plain product: max |d| "
                             f"{worst} > 5% of max |logit| {scale}")
    if not corr2 > INT8_CORR_MIN:
        raise AssertionError(f"int8 vs bf16 logits at 2 layers: correlation "
                             f"{corr2} <= {INT8_CORR_MIN}")
    print(f"[int8] one decode step (B=8) launched w8_matmul {step_launches} "
          f"times (7 x {cfg.n_layers} + 1, all on the mma route); int8 logits "
          f"kernel vs plain product max |d| {worst:.4g} (max |logit| "
          f"{scale:.4g}, gate 5%; correlation {corr_plain:.6f}); full-width "
          f"logits of int8 against bf16 on GEN_PROMPTS: correlation "
          f"{corr2:.6f} at 2 layers (gate > {INT8_CORR_MIN}), {corr18:.6f} at "
          f"{cfg.n_layers} layers (reported)")
    print(f"[time] {card}: prefill T=2048 in turns (bf16, int8, int8, bf16): bf16 "
          f"{prefill_ms['bf16'][0]:.2f} / {prefill_ms['bf16'][1]:.2f} ms, int8 "
          f"{prefill_ms['int8'][0]:.2f} / {prefill_ms['int8'][1]:.2f} ms")
    return dict(step_launches=step_launches, logits_corr_2_layers=corr2,
                prefill_ms_2048=prefill_ms,
                logits_corr_18_layers=corr18,
                logits_corr_kernel_vs_plain=corr_plain,
                kernel_vs_plain_dlogit=worst, logit_scale=scale)


def int8_card_vs_cpu(dev, seed: int) -> dict:
    """Phase 11 at int8: the 2-layer f32 model of Gemma widths quantized,
    card against CPU on the same codes: last logits at T=600 within
    ``CARD_CPU_TOL`` (the card's products on the SIMT route of w8_matmul,
    2 x 7 + 1 launches), greedy batched generation equal."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models.llm import (LanguageModel, Q8,
                                                      Transformer, forward)
    from fraud_detection_tpu_torch.ops import int8_matmul as W

    card = gemma(dev, seed, n_layers=2, dtype=torch.float32).quantized()
    leaves = {}
    for name in card.params.param_names():
        v = card.params.param(name)
        leaves[name] = (Q8(v.q.cpu(), v.scale.cpu()) if isinstance(v, Q8)
                        else v.detach().cpu())
    cpu = LanguageModel(card.cfg, Transformer.from_leaves(card.cfg, leaves))
    toks = torch.randint(0, card.cfg.vocab_size, (1, FLASH_SIMT_MAIN[1]),
                         generator=torch.Generator().manual_seed(seed))
    W.w8_matmul.launches = W.w8_matmul.simt_launches = 0
    with torch.inference_mode():
        lg = forward(card.params, toks.to(dev), card.cfg,
                     logits_last_only=True)[0][0, 0].cpu()
        simt, total = W.w8_matmul.simt_launches, W.w8_matmul.launches
        lc = forward(cpu.params, toks, cpu.cfg, logits_last_only=True)[0][0, 0]
    want = 7 * card.cfg.n_layers + 1
    if simt != want or total != simt:
        raise AssertionError(f"the f32 int8 forward launched the SIMT route "
                             f"{simt}x of {total}, want {want}")
    err = float((lg - lc).abs().max())
    if not bool((lg - lc).abs().le(CARD_CPU_TOL * (1 + lc.abs())).all()):
        raise AssertionError(f"int8 card vs cpu logits max |d| {err}")
    enc = [card.tokenizer.encode(p) for p in
           (GEN_PROMPTS[0], "Agent: hello, is this Mr Smith?", GEN_PROMPTS[5][:90])]
    tg = card.generate_tokens_batch(enc, max_new_tokens=8)
    tc = cpu.generate_tokens_batch(enc, max_new_tokens=8)
    if not np.array_equal(tg, tc):
        raise AssertionError(f"int8 greedy tokens card {tg.tolist()} != cpu "
                             f"{tc.tolist()}")
    print(f"[int8] card vs cpu (Gemma widths, 2 layers, f32, int8 weights, "
          f"T=600): last logits max |d| {err:.3g} (tol {CARD_CPU_TOL}), "
          f"w8_matmul SIMT route {simt} launches; greedy tokens of "
          f"{len(enc)} uneven prompts equal card/cpu")
    del card, cpu
    torch.cuda.empty_cache()
    return dict(dlogit=err, simt_launches=simt)


def generation_turns(lm, lm8, card: str) -> dict:
    """Phase 12 at int8: greedy generation of ``GEN_PROMPTS`` (8 x 64 new
    tokens) with the bf16 and the int8 model in turns (bf16, int8, int8,
    bf16) after a warm call each: tokens/s and explanations/s per turn, and
    each model's peak device memory above its weights during a turn."""
    import torch

    enc = [lm.tokenizer.encode(p) for p in GEN_PROMPTS]
    models = {"bf16": lm, "int8": lm8}
    for m in models.values():
        m.generate_tokens_batch(enc, max_new_tokens=4)
    turns = {"bf16": [], "int8": []}
    peak = {}
    for name in ("bf16", "int8", "int8", "bf16"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        models[name].generate_tokens_batch(enc, max_new_tokens=64)
        wall = time.perf_counter() - t0
        peak[name] = torch.cuda.max_memory_allocated() - base
        turns[name].append(wall)
    out = {}
    for name, walls in turns.items():
        out[name] = dict(walls_s=walls,
                         tokens_per_s=[8 * 64 / w for w in walls],
                         explanations_per_s=[8 / w for w in walls],
                         peak_bytes_over_model=peak[name])
    breakdown = device_breakdown(
        lambda: lm8.generate_tokens_batch(enc, max_new_tokens=16), reps=1)
    busy = sum(us for _, us, _ in breakdown) / 1e3
    w8 = sum(us for k, us, _ in breakdown if "w8_" in k) / 1e3
    out["int8"]["busy_ms_16"] = busy
    out["int8"]["w8_ms_16"] = w8
    print(f"[time] {card}: generation B=8 x 64 tokens in turns (bf16, int8, "
          f"int8, bf16): bf16 {out['bf16']['tokens_per_s'][0]:.1f} / "
          f"{out['bf16']['tokens_per_s'][1]:.1f} tokens/s, int8 "
          f"{out['int8']['tokens_per_s'][0]:.1f} / "
          f"{out['int8']['tokens_per_s'][1]:.1f} tokens/s (explanations/s "
          f"bf16 {out['bf16']['explanations_per_s'][0]:.3f}, int8 "
          f"{out['int8']['explanations_per_s'][0]:.3f}); peak device memory "
          f"over the model bf16 {peak['bf16']} B, int8 {peak['int8']} B")
    print(f"[trace] {card}: int8 generate B=8 x 16 tokens: device busy "
          f"{busy:.2f} ms, w8_matmul kernels {w8:.2f} ms of it")
    for name, us, n in breakdown[:6]:
        print(f"[trace]   {us:10.1f} us  x{n:.0f}  {name[:90]}")
    return out


def slot_int8(lm8, flagged_rows, seed: int, card: str) -> dict:
    """Phase 13c at int8: the slot lane (``slot_lane``, contiguous then
    paged) over the int8 model, and the paged service's windows bit-equal
    to the contiguous one's under int8 (phase 13b's prompts through 2
    slots, every window's out, new_lens, steps_run and active_row_steps)."""
    from fraud_detection_tpu_torch.explain.backends import frame_prompt
    from fraud_detection_tpu_torch.explain.onpod import flatten_chat
    from fraud_detection_tpu_torch.explain.prompts import analysis_prompt

    texts = [flatten_chat(frame_prompt(analysis_prompt(t, 1, 0.93)))
             for t in ("Caller: this is your bank, read me the code now.",
                       "Agent: your parcel is held; pay the customs fee in "
                       "gift cards today.")]
    texts += [GEN_PROMPTS[0], "Agent: hello, is this Mr Smith?", texts[0]]
    req_c, win_c, _ = serve_slots(lm8, texts, 0.0, seed)
    req_p, win_p, _ = serve_slots(lm8, texts, 0.0, seed, paged=True)
    if not windows_equal(win_c, win_p) or [r.out for r in req_c] != \
            [r.out for r in req_p]:
        raise AssertionError("int8: paged windows != contiguous windows")
    print(f"[int8] slot service at full width, int8 weights: paged == "
          f"contiguous, {len(win_c)} windows bit for bit")
    lane = slot_lane(lm8, flagged_rows, card)
    return dict(windows=len(win_c), paged_equal=True, lane=lane)


def write_tokenizer(path: Path, vocab_size: int) -> None:
    """A word-level tokenizer for ``path`` with one entry per id of the
    checkpoint's vocabulary (``tokenizers``), which ``transformers`` loads
    from the directory's files."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<unk>", "<s>", "</s>"] + [f"w{i}" for i in range(3, vocab_size)]
    tok = Tokenizer(models.WordLevel(vocab={w: i for i, w in enumerate(words)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path / "tokenizer.json"))
    with open(path / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>"}, f)


def hf_serve_cli(dev, path: Path, seed: int, card: str) -> dict:
    """Phase 13f: ``serve --model synthetic --explain onpod-int8:<dir>
    --explain-slots 4 --explain-tokens 8 --demo 4096 --batch-size 1024`` on a
    2-layer Gemma-width checkpoint. With ``transformers`` on the machine the
    directory gets a word-level tokenizer and the run must exit 0 with every
    message classified and ``admitted == completed + dropped``, no errors;
    without it the CLI must refuse with the reference's "cannot load ...
    tokenizer" message. Either way ``--explain onpod:/nowhere`` must refuse
    with "checkpoint dir ... not found"."""
    import importlib.util

    from fraud_detection_tpu_torch.app import serve

    write_gemma_checkpoint(path, dev, seed, n_layers=2)
    have = importlib.util.find_spec("transformers") is not None
    if have:
        write_tokenizer(path, GEMMA2B_HF_CONFIG["vocab_size"])
    argv = ["--device", str(dev), "--model", "synthetic", "--demo",
            str(SERVE_DEMO), "--batch-size", "1024", "--explain",
            f"onpod-int8:{path}", "--explain-slots", "4", "--explain-tokens",
            "8"]
    out = dict(transformers=have)
    if have:
        r = serve_cli(argv, card)
        stats, ex = r["stats"], r["stats"]["explain"]
        if r["classified"] != SERVE_DEMO or stats["processed"] != SERVE_DEMO \
                or ex["admitted"] != ex["completed"] + ex["dropped"] \
                or ex["completed"] == 0 or ex["errors"]:
            raise AssertionError(f"serve onpod-int8: classified "
                                 f"{r['classified']}, explain {ex}")
        out.update(msgs_per_sec=stats["msgs_per_sec"], explain=ex)
        print(f"[serve] onpod-int8 (transformers present, a word-level "
              f"tokenizer in the directory): explain admitted {ex['admitted']}"
              f" = completed {ex['completed']} + dropped {ex['dropped']}, no "
              "errors")
    else:
        try:
            serve.main(argv)
        except SystemExit as e:
            msg = str(e)
        else:
            raise AssertionError("serve onpod-int8 without transformers: no "
                                 "refusal")
        if "cannot load" not in msg or "tokenizer" not in msg:
            raise AssertionError(f"serve onpod-int8 refusal: {msg!r}")
        out["refusal"] = msg
        print(f"[serve] onpod-int8 without transformers on this machine: the "
              f"CLI refuses as the reference does: {msg[:160]}")
    try:
        serve.main(["--device", str(dev), "--model", "synthetic", "--demo",
                    "8", "--explain", "onpod:/nowhere"])
    except SystemExit as e:
        if "checkpoint dir '/nowhere' not found" not in str(e):
            raise AssertionError(f"onpod:/nowhere refusal: {e}")
    else:
        raise AssertionError("onpod:/nowhere did not refuse")
    print("[serve] --explain onpod:/nowhere refuses: checkpoint dir "
          "'/nowhere' not found")
    return out


def w8_bound(m: int, k: int, n: int, layout: str, itemsize: int):
    """(bound ms, "bytes" | "operations"): x read, q (int8) and the scale
    read and y written once at the HBM rate, against 2 M N K operations at
    the bf16 tensor-core rate (itemsize 2) or the non-tensor f32 rate."""
    out_size = itemsize if layout == "kn" else 4
    nbytes = m * k * itemsize + k * n + 4 * n + m * n * out_size
    rate = BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * n * k / rate * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def w8_times(dev, seed: int, card: str) -> dict:
    """Phase 14 (w8_matmul): at each Gemma-2B shape, at decode (M = 8) and
    prefill (M = 2048), bf16: the kernel in turns with cuBLAS bf16
    ``torch.matmul`` on a bf16 copy of the same weight (the yardstick, which
    the port never calls for int8), CUDA events around one call and per call
    over a back-to-back burst (host cost hidden behind the card), the plain
    version and the bound; a decode step's sum over its 127 products (burst
    times); the f32 route at M = 8 beside f32 ``torch.matmul``."""
    import torch

    from fraud_detection_tpu_torch.ops import int8_matmul as W

    g = torch.Generator(device=dev).manual_seed(seed)
    times = {}
    for i, (name, (k, n, layout)) in enumerate(W8_SHAPES.items()):
        q, scale = w8_weight(k, n, layout, dev, seed + i)
        wb = q.to(torch.bfloat16)
        for m in (8, 2048):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            kern = lambda: W.w8_matmul(x, q, scale, layout)
            lib = (lambda: x @ wb) if layout == "kn" else (lambda: x @ wb.T)
            reps, burst = (50, 100) if m == 8 else (10, 10)
            k1, l1 = cuda_ms(kern, reps), cuda_ms(lib, reps)
            l2, k2 = cuda_ms(lib, reps), cuda_ms(kern, reps)
            bound, by = w8_bound(m, k, n, layout, 2)
            t = times[f"{name} M={m}"] = dict(
                shape=[m, k, n], layout=layout, ms=(k1 + k2) / 2,
                ms_turns=[k1, k2], library_ms=(l1 + l2) / 2,
                burst_ms=burst_ms(kern, burst),
                library_burst_ms=burst_ms(lib, burst),
                plain_ms=cuda_ms(lambda: W.w8_matmul_reference(x, q, scale,
                                                               layout), 5, 1),
                bound_ms=bound, bound_by=by)
            print(f"[time] {card}: w8_matmul {name} ({layout}) M={m} K={k} "
                  f"N={n} bf16, CUDA events around one call (a back-to-back "
                  f"burst, per call): kernel {t['ms']:.4f} ms (turns "
                  f"{k1:.4f} / {k2:.4f}; burst {t['burst_ms']:.4f}), cuBLAS "
                  f"bf16 torch.matmul {t['library_ms']:.4f} ms (burst "
                  f"{t['library_burst_ms']:.4f}), plain {t['plain_ms']:.4f} "
                  f"ms, bound {bound * 1e3:.2f} us ({by}); kernel burst "
                  f"{t['burst_ms'] / bound:.2f}x its bound, "
                  f"{t['burst_ms'] / t['library_burst_ms']:.2f}x cuBLAS's")
            del x
        del wb
        x32 = torch.randn((8, k), generator=g, device=dev)
        wf = q.float()
        lib32 = (lambda: x32 @ wf) if layout == "kn" else (lambda: x32 @ wf.T)
        bound, by = w8_bound(8, k, n, layout, 4)
        t = times[f"{name} M=8 f32"] = dict(
            shape=[8, k, n], layout=layout,
            ms=cuda_ms(lambda: W.w8_matmul(x32, q, scale, layout), 20),
            plain_ms=cuda_ms(lambda: W.w8_matmul_reference(x32, q, scale,
                                                           layout), 5, 1),
            library_ms=cuda_ms(lib32, 20), bound_ms=bound, bound_by=by)
        print(f"[time] {card}: w8_matmul {name} ({layout}) M=8 f32 (SIMT "
              f"route): kernel {t['ms']:.4f} ms, f32 torch.matmul "
              f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {bound * 1e3:.2f} us ({by})")
        del q, scale, wf, x32
        torch.cuda.empty_cache()
    step = {key: sum(times[f"{s} M=8"][key] * W8_STEP_LAUNCHES[s]
                     for s in W8_SHAPES)
            for key in ("burst_ms", "library_burst_ms", "bound_ms")}
    print(f"[time] {card}: one decode step's 127 weight products at M=8 "
          f"(burst times): w8_matmul {step['burst_ms']:.3f} ms, cuBLAS bf16 "
          f"{step['library_burst_ms']:.3f} ms, int8 byte bound "
          f"{step['bound_ms']:.3f} ms")
    times["decode_step"] = step
    return times


# ---------------------------------------------------------------------------
# the serve CLI's default path: native host featurize, raw JSON, C++ frames
# ---------------------------------------------------------------------------

def build_native() -> dict:
    """Build and load the port's native host featurizer; fail with the
    compiler's message when it does not load (the card run must not serve
    the pure-Python encode by default)."""
    from fraud_detection_tpu_torch.featurize import native

    t0 = time.perf_counter()
    if native.load_library() is None:
        raise AssertionError("the native featurizer did not build or load: "
                             f"{' '.join(native.build_command or [])}\n"
                             f"{native.build_error}")
    secs = time.perf_counter() - t0
    print(f"[native] {' '.join(native.build_command)} ({secs:.2f} s, "
          f"library {native.library_path()})")
    return dict(command=native.build_command, seconds=secs)


def make_engine(pipe, items, batch: int, json_fast=None, **kw):
    """An engine (batch ``batch``, depth 2) over a fresh broker holding
    ``items``; returns (engine, broker)."""
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    broker = InProcessBroker()
    broker.producer().produce_batch("in", items)
    engine = StreamingClassifier(pipe, broker.consumer(["in"], "g"),
                                 broker.producer(), "out", batch_size=batch,
                                 max_wait=0.05, pipeline_depth=2, **kw)
    if json_fast is not None:
        engine._json_fast = json_fast
    return engine, broker


def run_engine(pipe, items, batch: int, json_fast=None, **kw):
    """One engine run over a fresh broker holding ``items``; returns
    (engine, stats, output messages, DLQ messages)."""
    engine, broker = make_engine(pipe, items, batch, json_fast, **kw)
    stats = engine.run(max_messages=len(items), idle_timeout=5.0)
    return engine, stats, broker.messages("out"), broker.messages("dlq")


def host_serving(feat, texts, models, dev_pipes, items, want, n_malformed,
                 dev) -> dict:
    """Phase 5b: the host-featurize pipelines (LR fp32, LR int8, forest) on
    the card against the CPU and against the device-featurize pipelines;
    the engine over raw JSON with native frames, sync and with the dispatch
    lane; the scheduler's overload case. ``featurize_packed`` must not
    launch. Returns the card's host pipelines."""
    import numpy as np

    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.sched import (AdaptiveScheduler,
                                                 SchedulerConfig)

    dev_labels = {name: dev_pipes[name].predict(texts).labels
                  for name in models}
    fk.featurize_bytes.launches = 0
    pipes = {}
    for name, (gm, cm, int8) in models.items():
        gpu = ServingPipeline(feat, gm, batch_size=BATCH, int8=int8, device=dev)
        cpu = ServingPipeline(feat, cm, batch_size=BATCH, int8=int8,
                              device="cpu")
        pg, pc = gpu.predict(texts), cpu.predict(texts)
        dp = float(np.abs(pg.probabilities - pc.probabilities).max())
        if not np.array_equal(pg.labels, pc.labels) or dp > 1e-6:
            raise AssertionError(f"host {name}: cuda vs cpu labels differ or "
                                 f"|dp| {dp} > 1e-6")
        if not np.array_equal(pg.labels, dev_labels[name]):
            raise AssertionError(f"host {name}: labels != the device-featurize "
                                 "pipeline's")
        values = [json.dumps({"text": t}).encode() for t in texts]
        fast = gpu.predict_json_async(values)
        if fast is None or not fast[1].all() or not np.array_equal(
                fast[0].resolve().labels, pg.labels):
            raise AssertionError(f"host {name}: raw-JSON path != predict")
        if gpu.device_stats.featurize_path != "host":
            raise AssertionError(f"host {name}: {gpu.device_stats.snapshot()}")
        pipes[name] = gpu
        print(f"[host] {name}: {len(texts)} texts, native host featurize, "
              f"labels equal cuda/cpu and equal device featurize, max |dp| "
              f"{dp:.3g}; raw-JSON path equals predict")

    pipe = pipes["lr_fp32"]
    wires = {}
    for lane in (False, True):
        eng, stats, out, _ = run_engine(pipe, items, 1024, async_dispatch=lane)
        if sorted(m.key for m in out) != sorted(k for _, k in items):
            raise AssertionError(f"host engine (lane={lane}): keys != fed")
        if stats.malformed != n_malformed:
            raise AssertionError(f"host engine: malformed {stats.malformed} "
                                 f"!= fed {n_malformed}")
        if not (eng._json_fast is True and eng._frames_ok is True):
            raise AssertionError(f"host engine (lane={lane}): _json_fast "
                                 f"{eng._json_fast}, _frames_ok {eng._frames_ok}")
        if lane and eng.health()["device"]["lane_batches"] != stats.batches:
            raise AssertionError(f"lane: {eng.health()['device']}")
        wires[lane] = sorted((m.key, m.value) for m in out)
    if wires[False] != wires[True]:
        raise AssertionError("async_dispatch wires != sync wires")
    keys = sorted(want)
    expect = dict(zip(keys, pipe.predict([want[k] for k in keys]).labels.tolist()))
    frames = {k: json.loads(v) for k, v in wires[False]}
    if any(frames[k]["prediction"] != expect[k] for k in keys):
        raise AssertionError("host engine labels != pipeline.predict")
    print(f"[host] engine: {len(items)} messages over raw JSON with native "
          "frames (_json_fast, _frames_ok), sync and async_dispatch: keys "
          "exact, wires byte-identical, labels equal predict")

    sched = AdaptiveScheduler(SchedulerConfig(
        shed_policy="reject", max_queue=len(items) // 8,
        batch_deadline_ms=5), 1024)
    sched.prewarm(pipe)
    eng, stats, out, dlq = run_engine(pipe, items, 1024, dlq_topic="dlq",
                                      scheduler=sched)
    got = sorted([m.key for m in out] + [m.key for m in dlq])
    if got != sorted(k for _, k in items) or stats.shed < 1:
        raise AssertionError(f"overload: out+dlq {len(got)} keys, shed "
                             f"{stats.shed}")
    json.dumps(eng.health()["sched"])
    print(f"[host] overload (reject, max_queue {len(items) // 8}): out {len(out)} + dlq "
          f"{len(dlq)} == fed {len(items)}, shed {stats.shed}; ladder "
          f"{list(sched.buckets)}")
    pipe.pad_ladder = None
    if fk.featurize_bytes.launches:
        raise AssertionError(f"host featurize launched featurize_packed "
                             f"{fk.featurize_bytes.launches}x")
    return pipes


def serve_cli(argv, card: str, rc: int = 0) -> dict:
    """The port's serve CLI in-process (``main(argv)``): exit ``rc``, the
    stats line, the classified count, the engine the CLI ran and its
    ``featurize_packed`` launches."""
    import contextlib
    import io

    from fraud_detection_tpu_torch.app import serve
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.stream import engine as engine_mod

    engines = []
    run = engine_mod.StreamingClassifier.run

    def recording_run(self, *a, **kw):
        engines.append(self)
        return run(self, *a, **kw)

    fk.featurize_bytes.launches = 0
    log = io.StringIO()
    engine_mod.StreamingClassifier.run = recording_run
    try:
        with contextlib.redirect_stdout(log):
            got = serve.main(argv)
    finally:
        engine_mod.StreamingClassifier.run = run
    lines = log.getvalue().strip().splitlines()
    if got != rc:
        raise AssertionError(f"serve {argv}: exit {got}, want {rc}\n"
                             f"{log.getvalue()}")
    # a demo broker's run ends with its classified count (``--kafka`` has
    # no broker to count)
    counted = lines[-1].startswith("classified messages")
    stats = json.loads(lines[-2] if counted else lines[-1])
    n = int(lines[-1].rsplit(":", 1)[1]) if counted else stats["processed"]
    print(f"[serve] {' '.join(argv)}: exit {rc}, classified {n}, msgs/s "
          f"{stats['msgs_per_sec']} ({card})")
    return dict(stats=stats, classified=n, engine=engines[-1],
                launches=fk.featurize_bytes.launches)


CHAOS_MSGS = 4096        # phase 5c: messages of the seeded chaos run
CHAOS_SEED = 42          # the mixed plan's seed (tests/test_chaos.py)
CHAOS_MAX_FAULTS = 200
CHAOS_BATCH = 256
SERVE_THREADS = ("dispatch-lane", "health-writer", "metrics-writer",
                 "metrics-http", "sentinel", "profile-window")


def chaos_items(n: int, seed: int):
    """``n`` seeded messages of the synthetic corpus, ~2% malformed
    (unterminated JSON, a missing text field); returns (items, texts by
    key)."""
    from fraud_detection_tpu_torch.data import generate_corpus

    rng = random.Random(seed)
    items, want = [], {}
    for i, d in enumerate(generate_corpus(n=n, seed=seed)):
        key = str(i).encode()
        r = rng.random()
        if r < 0.01:
            value = b'{"text": "unterminated'
        elif r < 0.02:
            value = json.dumps({"body": d.text}).encode()
        else:
            value = json.dumps({"text": d.text, "id": i}).encode()
            want[key] = d.text
        items.append((value, key))
    return items, want


def chaos_plan(seed: int = CHAOS_SEED):
    """tests/test_chaos.py's mixed plan: lossy flushes, flush crashes,
    commit fences, poll errors, duplicates, corruption, zero-cost latency
    spikes, budgeted at ``CHAOS_MAX_FAULTS``."""
    from fraud_detection_tpu_torch.stream.faults import FaultPlan

    return FaultPlan(seed=seed, poll_error_rate=0.08, latency_spike_rate=0.05,
                     latency_spike_sec=0.0, duplicate_rate=0.08,
                     corrupt_rate=0.05, flush_fail_rate=0.08,
                     flush_crash_rate=0.06, commit_fence_rate=0.08,
                     max_faults=CHAOS_MAX_FAULTS, sleep=lambda s: None)


def chaos_run(pipe, items, plan=None, **engine_kw) -> dict:
    """One supervised run (``run_supervised``, backoff 0, a no-op sleep)
    of the engine (batch 256, no scheduler, a DLQ) over a fresh broker
    holding ``items``, its clients wrapped by ``plan`` when one is given.
    Returns the broker, the stats, the producers and the engines built."""
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)
    from fraud_detection_tpu_torch.stream.engine import run_supervised
    from fraud_detection_tpu_torch.stream.faults import (ChaosConsumer,
                                                         ChaosProducer)

    broker = InProcessBroker(num_partitions=3)
    broker.producer().produce_batch("in", items)
    producers, engines, attempts = [], [], {}

    def make_engine():
        cons, prod = broker.consumer(["in"], "chaos"), broker.producer()
        if plan is not None:
            cons, prod = ChaosConsumer(cons, plan), ChaosProducer(prod, plan)
            producers.append(prod)
        engines.append(StreamingClassifier(
            pipe, cons, prod, "out", batch_size=CHAOS_BATCH, max_wait=0.01,
            dlq_topic="out-dlq", dlq_attempts=attempts, **engine_kw))
        return engines[-1]

    t0 = time.perf_counter()
    stats = run_supervised(make_engine, max_restarts=300, backoff=0.0,
                           idle_timeout=0.2, sleep=lambda s: None)
    return dict(broker=broker, stats=stats, producers=producers,
                engines=engines, wall_s=time.perf_counter() - t0)


def chaos_invariants(run: dict, items, label: str) -> None:
    """Every fed key is in out ∪ out-dlq, and no committed offset passes an
    output that was lost."""
    broker = run["broker"]
    delivered = ({m.key for m in broker.messages("out")}
                 | {m.key for m in broker.messages("out-dlq")})
    missing = {k for _, k in items} - delivered
    if missing:
        raise AssertionError(f"{label}: lost {len(missing)} keys, e.g. "
                             f"{sorted(missing)[:3]}")
    committed = broker.committed("chaos")
    for m in broker.messages("in"):
        if (m.offset < committed.get((m.topic, m.partition), 0)
                and m.key not in delivered):
            raise AssertionError(f"{label}: a commit passed the lost output "
                                 f"{m.key!r} ({m.partition}@{m.offset})")


def serve_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.is_alive() and t.name in SERVE_THREADS)


def supervised_chaos(dev, ckpt: Path, seed: int, card: str) -> dict:
    """Phase 5c, part 1: the engine under the seeded mixed plan at the serve
    CLI's widths on the card with device featurize (``featurize_packed``),
    supervised. Gates: the delivery invariants; restarts, injections and a
    lost flush; every delivered label equal to ``predict``; one
    ``featurize_packed`` launch a chunk dispatched, across incarnations; a
    second card run (sync) and a run on the dispatch lane byte-identical;
    the CPU run on the host-featurize pipeline with the same fault report
    and the same stream (keys, labels and texts in order, confidence within
    two of the frame's last digits: |dp| <= 1e-6 as phase 5b gates, plus
    the %.6f rounding); every thread joined and
    device memory back within 1 MB of a clean warm-up run of the same
    engine."""
    import gc

    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk

    items, want = chaos_items(CHAOS_MSGS, seed + 101)
    pipe = ServingPipeline.from_checkpoint(str(ckpt), device=dev,
                                           batch_size=CHAOS_BATCH,
                                           featurize_device=True)
    if pipe.device_stats.featurize_path != "cuda":
        raise AssertionError(f"chaos: featurize path "
                             f"{pipe.device_stats.featurize_path}")
    warm = chaos_run(pipe, items)          # clean: no plan
    chaos_invariants(warm, items, "chaos warm-up")
    torch.cuda.synchronize()
    gc.collect()
    mem_clean = torch.cuda.memory_allocated()
    threads_before = serve_threads()

    plan = chaos_plan()
    fk.featurize_bytes.launches = 0
    chunks0 = pipe.device_stats.chunks
    run = chaos_run(pipe, items, plan)
    launches = fk.featurize_bytes.launches
    chunks = pipe.device_stats.chunks - chunks0
    stats, report = run["stats"], plan.report()
    chaos_invariants(run, items, "chaos")
    lost = sum(len(p.lost) for p in run["producers"])
    if not (stats.restarts > 0 and plan.total_injected > 0 and lost > 0):
        raise AssertionError(f"chaos: restarts {stats.restarts}, injected "
                             f"{report}, lost records {lost}")
    if launches < 1 or launches != chunks:
        raise AssertionError(f"chaos: featurize_packed launched {launches}x "
                             f"over {chunks} chunks dispatched")
    out = run["broker"].messages("out")
    keys = sorted(want)
    expect = dict(zip(keys, pipe.predict([want[k] for k in keys])
                      .labels.tolist()))
    frames = [(m.key, json.loads(m.value)) for m in out]
    bad = [k for k, f in frames
           if "error" not in f and f["prediction"] != expect.get(k)]
    if bad:
        raise AssertionError(f"chaos: {len(bad)} delivered labels != predict")
    stream = [(m.key, m.value) for m in out]

    again = chaos_run(pipe, items, chaos_plan())
    lane = chaos_run(pipe, items, chaos_plan(), async_dispatch=True)
    for name, r in (("second card run", again), ("dispatch lane", lane)):
        if [(m.key, m.value) for m in r["broker"].messages("out")] != stream:
            raise AssertionError(f"chaos: the {name}'s output stream != the "
                                 "first run's")
    cpu_pipe = ServingPipeline.from_checkpoint(str(ckpt), device="cpu",
                                               batch_size=CHAOS_BATCH)
    cpu_plan = chaos_plan()
    cpu = chaos_run(cpu_pipe, items, cpu_plan)
    if cpu_plan.report() != report or cpu["stats"].restarts != stats.restarts:
        raise AssertionError(f"chaos: the CPU run's faults {cpu_plan.report()} "
                             f"(restarts {cpu['stats'].restarts}) != the "
                             f"card's {report} ({stats.restarts})")
    cpu_out = cpu["broker"].messages("out")
    byte_equal, max_dconf = 0, 0.0
    if len(cpu_out) != len(out):
        raise AssertionError(f"chaos: CPU stream {len(cpu_out)} frames, card "
                             f"{len(out)}")
    for mc, mg in zip(cpu_out, out):
        fc, fg = json.loads(mc.value), json.loads(mg.value)
        dconf = abs(fc.pop("confidence", 0.0) - fg.pop("confidence", 0.0))
        # |dp| <= 1e-6 (phase 5b) plus the %.6f rounding: two last digits
        if mc.key != mg.key or fc != fg or round(dconf * 1e6) > 2:
            raise AssertionError(f"chaos: CPU frame {mc.key!r} != card frame "
                                 f"{mg.key!r} (|dconf| {dconf})")
        max_dconf = max(max_dconf, dconf)
        byte_equal += mc.value == mg.value
    cpu_dlq = sorted(m.key for m in cpu["broker"].messages("out-dlq"))
    if cpu_dlq != sorted(m.key for m in run["broker"].messages("out-dlq")):
        raise AssertionError("chaos: CPU DLQ keys != the card's")

    torch.cuda.synchronize()
    gc.collect()
    mem_after = torch.cuda.memory_allocated()
    leaked = [t for t in serve_threads() if t not in threads_before]
    if leaked or abs(mem_after - mem_clean) > 1 << 20:
        raise AssertionError(f"chaos: threads left {leaked}, device memory "
                             f"{mem_after} B after the runs vs {mem_clean} B "
                             "after the clean warm-up")
    print(f"[chaos] {CHAOS_MSGS} msgs, batch {CHAOS_BATCH}, plan seed "
          f"{CHAOS_SEED}: {report}, restarts {stats.restarts}, lost records "
          f"{lost}, keys all in out+dlq, no commit past a lost output, "
          f"labels equal predict; featurize_packed {launches} launches over "
          f"{chunks} chunks; second run and dispatch lane byte-identical; "
          f"CPU run same faults and stream ({byte_equal}/{len(out)} frames "
          f"byte-equal, max |dconf| {max_dconf:.3g}); memory "
          f"{mem_after - mem_clean:+d} B vs clean, no thread left; wall "
          f"{run['wall_s']:.2f} s ({card})")
    return dict(report=report, restarts=stats.restarts, lost_records=lost,
                processed=stats.processed, dead_lettered=stats.dead_lettered,
                featurize_packed_launches=launches, chunks=chunks,
                wall_s=run["wall_s"], clean_wall_s=warm["wall_s"],
                lane_wall_s=lane["wall_s"], cpu_wall_s=cpu["wall_s"],
                frames=len(out), cpu_byte_equal_frames=byte_equal,
                cpu_max_abs_dconf=max_dconf,
                memory_delta_bytes=mem_after - mem_clean, card=card)


def kernel_events(trace_path: str, name: str) -> int:
    """Kernel events whose name holds ``name`` in a Chrome trace (a
    kernel's device symbol: ``featurize_packed`` launches ``packed_kernel``)."""
    with open(trace_path) as f:
        doc = json.load(f)
    return sum(1 for e in doc.get("traceEvents", [])
               if e.get("cat") == "kernel" and name in e.get("name", ""))


def chaos_cli(dev, ckpt: Path, work: Path, card: str) -> dict:
    """Phase 5c, part 2: the serve CLI with every new flag (``--chaos
    --chaos-seed 7 --trace --alerts --incident-dir --metrics-file
    --health-file --profile-dir --profile-batches 4``) on the card under
    ``--featurize-device``. Gates: exit 0, every message classified or
    dead-lettered, restarts and the chaos report in the stats line, exact
    span accounting, the metrics file parsed and covering every health
    leaf, the health file's final state, its incident count equal to the
    bundles written, the profile trace holding between 1 and the chunks
    dispatched ``featurize_packed`` kernel events, and no serving thread
    left. Then the CLI's msgs/s with and without ``--trace --alerts
    --metrics-file``, in turns (reported, not gated)."""
    from fraud_detection_tpu_torch.obs.metrics import (leaf_paths,
                                                       metric_name,
                                                       parse_prometheus)

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    inc, prom, hfile, prof = (work / "incidents", work / "m.prom",
                              work / "health.json", work / "profile")
    base = ["--device", str(dev), "--model", str(ckpt), "--demo",
            str(SERVE_DEMO), "--batch-size", "1024", "--featurize-device"]
    r = serve_cli(base + ["--chaos", "--chaos-seed", "7", "--trace",
                          "--alerts", "--incident-dir", str(inc),
                          "--metrics-file", str(prom), "--health-file",
                          str(hfile), "--profile-dir", str(prof),
                          "--profile-batches", "4"], card)
    stats, engine = r["stats"], r["engine"]
    broker = engine.consumer.inner.broker
    out_keys = {m.key for m in broker.messages("dialogues-classified")}
    if out_keys != {str(i).encode() for i in range(SERVE_DEMO)}:
        raise AssertionError(f"chaos CLI: {len(out_keys)} of {SERVE_DEMO} keys "
                             "classified")
    if stats["restarts"] < 1 or stats.get("chaos", {}).get("total", 0) < 1:
        raise AssertionError(f"chaos CLI: restarts {stats['restarts']}, chaos "
                             f"{stats.get('chaos')}")
    tr = stats["health"]["trace"]
    if tr["spans_begun"] != tr["spans_ended"] or tr["spans_open"] \
            or tr["batches_traced"] != tr["batches_closed"] \
            or tr["batches_traced"] < 1:
        raise AssertionError(f"chaos CLI: span accounting {tr}")
    parsed = parse_prometheus(prom.read_text())
    missing = [p for p in leaf_paths(stats["health"], ("engine",))
               if metric_name("fraud", p) not in parsed
               and metric_name("fraud", p) + "_count" not in parsed]
    if missing:
        raise AssertionError(f"chaos CLI: health leaves not exported: "
                             f"{missing[:5]}")
    health = json.loads(hfile.read_text())
    final = health["engines"][-1]
    if health.get("chaos") != stats["chaos"] \
            or final["processed"] != stats["health"]["processed"]:
        raise AssertionError("chaos CLI: the health file is not the final "
                             "state")
    bundles = ([p for p in inc.iterdir() if p.is_dir()]
               if inc.exists() else [])
    if final["alerts"]["fired"] != len(bundles) \
            or stats["alerts"]["fired"] != len(bundles):
        raise AssertionError(f"chaos CLI: {final['alerts']['fired']} incidents "
                             f"in the health file, {len(bundles)} bundles")
    profile = stats.get("profile") or {}
    if profile.get("error") is not None or not profile.get("trace"):
        raise AssertionError(f"chaos CLI: profiler {profile}")
    n_events = kernel_events(profile["trace"], "packed_kernel")
    if not 1 <= n_events <= r["launches"]:
        raise AssertionError(f"chaos CLI: {n_events} featurize_packed kernel "
                             f"events in the profile, {r['launches']} chunks "
                             "dispatched")
    left = serve_threads()
    if left:
        raise AssertionError(f"chaos CLI: serving threads left: {left}")
    print(f"[chaos-cli] exit 0, {SERVE_DEMO} keys classified, restarts "
          f"{stats['restarts']}, chaos {stats['chaos']}; spans "
          f"{tr['spans_begun']} begun = ended, batches {tr['batches_traced']} "
          f"traced = closed; {len(parsed)} metric names cover every health "
          f"leaf; health file final; incidents {len(bundles)} = bundles "
          f"({stats['alerts']['firing']} firing); profile: {n_events} "
          f"featurize_packed kernel events of {r['launches']} launches")
    rates = {"plain": [], "traced": []}
    obs_flags = ["--trace", "--alerts", "--metrics-file",
                 str(work / "turns.prom")]
    for arm in ("plain", "traced", "traced", "plain"):
        t = serve_cli(base + (obs_flags if arm == "traced" else []), card)
        rates[arm].append(t["stats"]["msgs_per_sec"])
    print(f"[chaos-cli] serve msgs/s in turns (plain, traced, traced, plain):"
          f" plain {rates['plain']}, with --trace --alerts --metrics-file "
          f"{rates['traced']} ({card})")
    return dict(restarts=stats["restarts"], chaos=stats["chaos"],
                spans=tr["spans_begun"], batches_traced=tr["batches_traced"],
                incidents=len(bundles), firing=stats["alerts"]["firing"],
                metric_names=len(parsed), profile_kernel_events=n_events,
                featurize_packed_launches=r["launches"],
                msgs_per_sec=rates, card=card)


FLEET_MSGS = 8192        # phase 5d: messages of each fleet drain
FLEET_PARTITIONS = 4
FLEET_WORKERS = 3
# Heartbeats ride the poll path, so a worker whose batch outlasts its lease
# loses it (and its partitions' rows go round again): 2 s is ~100x a card
# batch, and a crashed worker's partitions wait that long to move.
FLEET_LEASE_TTL = 2.0
FLEET_THREAD_PREFIXES = ("fleet-", "serve-w")
FLEET_AUTOSCALE_KEYS = {"desired", "live", "min", "max", "scale_outs",
                        "scale_ins", "replacements", "denied",
                        "cooldown_remaining_s", "last_decision",
                        "provisioner", "decisions"}


def fleet_threads() -> list:
    """Live threads of a fleet (workers, monitor, candidates) or of
    ``--workers`` (serve-w<i>)."""
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.is_alive() and t.name.startswith(FLEET_THREAD_PREFIXES))


def fleet_drain(pipe, items, n_workers: int, *, profile: bool = False,
                idle: float = 0.5, **fleet_kw) -> dict:
    """One ``Fleet.in_process`` drain of ``items`` (4 partitions, batch 256)
    by ``n_workers`` workers that share ``pipe``. A watcher thread stamps
    the moment the output topic holds every key, so ``drain_s`` (and the
    aggregate msgs/s) excludes the idle tail that ends a drain run; with
    ``profile`` the run is traced and ``idle`` is the device-idle share of
    that drain window."""
    import threading

    import torch

    from fraud_detection_tpu_torch.fleet import Fleet
    from fraud_detection_tpu_torch.stream import InProcessBroker

    broker = InProcessBroker(num_partitions=FLEET_PARTITIONS)
    broker.producer().produce_batch("in", items)
    fleet = Fleet.in_process(broker, pipe, "in", "out", n_workers,
                             batch_size=CHAOS_BATCH,
                             lease_ttl=FLEET_LEASE_TTL,
                             heartbeat_interval=0.05, tick_interval=0.05,
                             **fleet_kw)
    done = threading.Event()
    stamp = {}

    def watch():
        while not done.is_set():
            if broker.topic_size("out") >= len(items):
                stamp["full"] = time.perf_counter()
                return
            time.sleep(0.001)

    watcher = threading.Thread(target=watch, name="fleet-drain-watch")
    torch.cuda.synchronize()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        prof = torch_profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             acc_events=True)
        prof.__enter__()
    t0 = time.perf_counter()
    watcher.start()
    try:
        result = fleet.run(idle_timeout=idle, join_timeout=120.0)
    finally:
        done.set()
        watcher.join(10.0)
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    drain_s = stamp.get("full", time.perf_counter()) - t0
    out = dict(broker=broker, result=result, fleet=fleet, wall_s=wall,
               drain_s=drain_s, msgs_per_s=len(items) / drain_s)
    if prof is not None:
        busy_us = sum(e.device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if not busy_us:
            raise AssertionError("fleet: the profiled drain recorded no "
                                 "device time")
        out["idle"] = 1 - busy_us / (drain_s * 1e6)
    return out


def fleet_gates(run: dict, items, want: dict, predict, label: str,
                order: bool = False, malformed: bool = True) -> dict:
    """Every key classified exactly once, every label equal to ``predict``
    on its text, no worker error; the malformed count exact (with
    ``malformed``: a killed worker's aborted batch counts its malformed
    rows once more when its successor re-reads them); with ``order`` each
    source partition's rows in offset order. Returns the output frames by
    key."""
    broker, result = run["broker"], run["result"]
    keys = [m.key for m in broker.messages("out")]
    fed = sorted(k for _, k in items)
    if sorted(keys) != fed:
        raise AssertionError(
            f"{label}: {len(set(fed) - set(keys))} keys lost, "
            f"{len(keys) - len(set(keys))} duplicated")
    if result["errors"]:
        raise AssertionError(f"{label}: worker errors {result['errors']}")
    if malformed and result["malformed"] != len(items) - len(want):
        raise AssertionError(f"{label}: malformed {result['malformed']} != "
                             f"fed {len(items) - len(want)}")
    frames = {m.key: json.loads(m.value) for m in broker.messages("out")}
    good = sorted(want)
    expect = dict(zip(good, predict([want[k] for k in good]).labels.tolist()))
    bad = [k for k in good if frames[k].get("prediction") != expect[k]]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} labels != predict")
    if order:
        pos = {m.key: i for i, m in enumerate(broker.messages("out"))}
        for p in range(FLEET_PARTITIONS):
            seen = [pos[m.key] for m in broker.messages("in")
                    if m.partition == p]
            if seen != sorted(seen):
                raise AssertionError(f"{label}: partition {p} out of order")
    return frames


def fleet_phase(dev, ckpt: Path, forest, work: Path, seed: int,
                card: str) -> dict:
    """Phase 5d: N worker threads sharing ONE pipeline on the card (the
    seeded LR checkpoint at the serve CLI's widths, device featurize).
    Gates (``fleet_gates`` on every drain): the 3-worker drain, with
    ``featurize_packed`` launches equal to the chunks dispatched summed over
    the workers; the same drain on phase 4's forest; a seeded worker death
    (zero lost or duplicated keys, partition order, deaths and rebalances);
    a coordinator kill under 2 candidates (term >= 2, a handoff); the CPU
    twin on the host-featurize pipeline (labels equal per key, |dp| <=
    1e-6); the serve CLI's --fleet (host and device featurize), --workers
    and --fleet --autoscale --alerts --fleet-health-file runs; no fleet
    thread left and device memory within 1 MB of the warm-up. Printed, not
    gated: msgs/s at 1, 2 and 3 workers, the host's cores and the 3-worker
    drain's device-idle share."""
    import gc
    import os

    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.stream.faults import (CoordinatorKillSpec,
                                                         WorkerDeathPlan)

    t_phase = time.perf_counter()
    items, want = chaos_items(FLEET_MSGS, seed + 131)
    pipe = ServingPipeline.from_checkpoint(str(ckpt), device=dev,
                                           batch_size=CHAOS_BATCH,
                                           featurize_device=True)
    if pipe.device_stats.featurize_path != "cuda":
        raise AssertionError(f"fleet: featurize path "
                             f"{pipe.device_stats.featurize_path}")
    rates = {}
    warm = fleet_drain(pipe, items, 1)               # warm-up, 1 worker
    fleet_gates(warm, items, want, pipe.predict, "fleet 1 worker")
    torch.cuda.synchronize()
    gc.collect()
    mem_clean = torch.cuda.memory_allocated()
    for n in (1, 2):
        r = fleet_drain(pipe, items, n)
        fleet_gates(r, items, want, pipe.predict, f"fleet {n} workers")
        rates[n] = dict(drain=r["msgs_per_s"],
                        run=r["result"]["msgs_per_sec"])

    # the gated drain: launches reset just before, read just after
    fk.featurize_bytes.launches = 0
    chunks0 = pipe.device_stats.chunks
    main = fleet_drain(pipe, items, FLEET_WORKERS)
    launches = fk.featurize_bytes.launches
    chunks = pipe.device_stats.chunks - chunks0
    frames = fleet_gates(main, items, want, pipe.predict, "fleet drain")
    if launches < 1 or launches != chunks:
        raise AssertionError(f"fleet: featurize_packed launched {launches}x "
                             f"over {chunks} chunks dispatched by "
                             f"{FLEET_WORKERS} workers")
    per_worker = main["result"]["per_worker_processed"]
    rates[FLEET_WORKERS] = dict(drain=main["msgs_per_s"],
                                run=main["result"]["msgs_per_sec"])
    profiled = fleet_drain(pipe, items, FLEET_WORKERS, profile=True)
    fleet_gates(profiled, items, want, pipe.predict, "fleet profiled drain")

    forest_run = fleet_drain(forest, items, FLEET_WORKERS)
    fleet_gates(forest_run, items, want, forest.predict, "fleet forest")

    plan = WorkerDeathPlan(seed=5, kills=1)
    death = fleet_drain(pipe, items, FLEET_WORKERS, death_plan=plan)
    fleet_gates(death, items, want, pipe.predict, "fleet worker death",
                order=True, malformed=False)
    dres = death["result"]
    if len(dres["deaths"]) < 1 or dres["rebalances"] < 1:
        raise AssertionError(f"fleet: deaths {dres['deaths']}, rebalances "
                             f"{dres['rebalances']}")

    kill = CoordinatorKillSpec(seed=seed + 7, kills=1, min_ticks=2,
                               max_ticks=4)
    succ_run = fleet_drain(pipe, items, FLEET_WORKERS, idle=1.5,
                           candidates=2, role_ttl=0.3, coordinator_kill=kill)
    fleet_gates(succ_run, items, want, pipe.predict, "fleet coordinator kill")
    succ = succ_run["result"]["succession"]
    if succ["term"] < 2 or len(succ["handoffs"]) < 1:
        raise AssertionError(f"fleet: succession term {succ['term']}, "
                             f"handoffs {succ['handoffs']}")

    cpu_pipe = ServingPipeline.from_checkpoint(str(ckpt), device="cpu",
                                               batch_size=CHAOS_BATCH)
    cpu = fleet_drain(cpu_pipe, items, FLEET_WORKERS)
    cpu_frames = fleet_gates(cpu, items, want, cpu_pipe.predict,
                             "fleet CPU twin")
    good = sorted(want)
    pg = pipe.predict([want[k] for k in good])
    pc = cpu_pipe.predict([want[k] for k in good])
    dp = float(np.abs(pg.probabilities - pc.probabilities).max())
    if not np.array_equal(pg.labels, pc.labels) or dp > 1e-6:
        raise AssertionError(f"fleet: card vs CPU labels differ or |dp| {dp}")
    diff = [k for k in good if frames[k]["prediction"]
            != cpu_frames[k]["prediction"]
            or round(abs(frames[k]["confidence"]
                         - cpu_frames[k]["confidence"]) * 1e6) > 2]
    if diff:
        raise AssertionError(f"fleet: {len(diff)} card frames != the CPU "
                             "twin's")

    # the serve CLI: --fleet (host and device featurize), --workers, and the
    # autoscaled fleet with alerts and the health file
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cli = {}
    base = ["--device", str(dev), "--model", str(ckpt), "--batch-size",
            "1024"]
    for name, extra in (
            ("fleet_host", ["--demo", str(FLEET_MSGS), "--fleet", "3",
                            "--partitions", "4"]),
            ("fleet_featurize_device", ["--demo", str(FLEET_MSGS), "--fleet",
                                        "3", "--partitions", "4",
                                        "--featurize-device"]),
            ("workers", ["--demo", str(SERVE_DEMO), "--workers", "3",
                         "--partitions", "3"]),
            ("fleet_autoscale", ["--demo", str(SERVE_DEMO), "--fleet", "2",
                                 "--partitions", "4", "--autoscale",
                                 "--min-workers", "2", "--max-workers", "3",
                                 "--fleet-health-file",
                                 str(work / "fleet.json"), "--alerts"])):
        r = serve_cli(base + extra, card)
        stats, n = r["stats"], int(extra[1])
        if r["classified"] != n or stats["processed"] != n:
            raise AssertionError(f"fleet CLI {name}: classified "
                                 f"{r['classified']} of {n}")
        dispatched = r["engine"].pipeline.device_stats.chunks
        if "--featurize-device" in extra:
            if r["launches"] < 1 or r["launches"] != dispatched:
                raise AssertionError(f"fleet CLI {name}: featurize_packed "
                                     f"{r['launches']}x over {dispatched} "
                                     "chunks")
        elif r["launches"]:
            raise AssertionError(f"fleet CLI {name}: featurize_packed "
                                 f"launched {r['launches']}x on host "
                                 "featurize")
        cli[name] = dict(msgs_per_sec=stats["msgs_per_sec"],
                         workers=stats["workers"],
                         featurize_packed_launches=r["launches"],
                         chunks=dispatched)
        if name == "fleet_autoscale":
            if set(stats["autoscale"]) != FLEET_AUTOSCALE_KEYS:
                raise AssertionError(f"fleet CLI: autoscale block keys "
                                     f"{sorted(stats['autoscale'])}")
            doc = json.loads((work / "fleet.json").read_text())
            block = (doc.get("fleet") or {}).get("autoscale")
            if not isinstance(block, dict) or set(block) != \
                    FLEET_AUTOSCALE_KEYS - {"provisioner", "decisions"}:
                raise AssertionError(f"fleet CLI: the final health file's "
                                     f"autoscale block {block}")
            cli[name]["autoscale"] = {k: stats["autoscale"][k] for k in
                                      ("desired", "scale_outs", "scale_ins",
                                       "replacements")}

    idle = profiled["idle"]
    del warm, main, profiled, forest_run, death, succ_run, cpu
    torch.cuda.synchronize()
    gc.collect()
    mem_after = torch.cuda.memory_allocated()
    left = fleet_threads()
    if left or abs(mem_after - mem_clean) > 1 << 20:
        raise AssertionError(f"fleet: threads left {left}, device memory "
                             f"{mem_after} B vs {mem_clean} B after the "
                             "warm-up")
    cores = os.cpu_count()
    wall = time.perf_counter() - t_phase
    print(f"[fleet] {FLEET_MSGS} msgs, {FLEET_PARTITIONS} partitions, batch "
          f"{CHAOS_BATCH}, {FLEET_WORKERS} workers on one pipeline: keys "
          f"exact, malformed exact, labels equal predict (LR and forest); "
          f"featurize_packed {launches} launches = {chunks} chunks "
          f"dispatched (per worker {per_worker}); worker death "
          f"{dres['death_plan']['killed']} with {dres['rebalances']} "
          f"rebalances, {dres['lease_expirations']} lease expirations, keys "
          f"exact, partition order kept; coordinator kill "
          f"{succ['kill_plan']['killed']}: term {succ['term']}, "
          f"{len(succ['handoffs'])} handoff(s); CPU twin labels equal, max "
          f"|dp| {dp:.3g}; serve CLI {sorted(cli)} exit 0; no fleet thread "
          f"left, memory {mem_after - mem_clean:+d} B; phase wall "
          f"{wall:.1f} s ({card})")
    print(f"[fleet] aggregate msgs/s to the last key (and Fleet.run's, idle "
          f"tail included): "
          + ", ".join(f"{n} worker(s) {r['drain']:.1f} ({r['run']})"
                      for n, r in sorted(rates.items()))
          + f"; os.cpu_count() {cores}; device idle over the "
          f"{FLEET_WORKERS}-worker drain {idle:.4f} ({card})")
    return dict(msgs=FLEET_MSGS, workers=FLEET_WORKERS, rates=rates,
                cores=cores, idle_3_workers=idle,
                featurize_packed_launches=launches, chunks=chunks,
                per_worker_processed=per_worker,
                death=dres["death_plan"], rebalances=dres["rebalances"],
                lease_expirations=dres["lease_expirations"],
                succession=dict(term=succ["term"],
                                handoffs=succ["handoffs"]),
                cpu_max_abs_dp=dp, cli=cli,
                memory_delta_bytes=mem_after - mem_clean, wall_s=wall,
                card=card)



# Phase 5e: the game days. Every catalog scenario at its own sizes (seed 0,
# scale 1.0); the SHA-256 of each timeline's events (virtual t, key, value
# bytes, truth family), as the JAX package composes it on the CPU, with its
# row count (tests/test_torch_scenarios.py holds the port's timelines equal
# to the JAX package's event for event at these and other seeds and scales).
GAMEDAY_SEED, GAMEDAY_SCALE = 0, 1.0
GAMEDAY_TIMELINES = {
    "campaign_breaker": (1049, "bdecb78c54e23c972ec74cb9bc3052d2"),
    "campaign_explain": (649, "81b93fbeba6e09dd3adaabead6e4ab75"),
    "campaign_explain_paged": (649, "81b93fbeba6e09dd3adaabead6e4ab75"),
    "campaign_kill_swap": (2299, "df54e2bd22666d3759f93f3c5f6480cf"),
    "chaos_storm": (939, "b7a65f85907ce08d0c281441d429de93"),
    "coordinator_kill": (2159, "db1b76d2fd478ca208189713be7a4335"),
    "diurnal_hotkey": (960, "349e0dfa72d020fc9ca558956cc2c30c"),
    "diurnal_tide_scale": (8120, "0211eab516d79b057cecf716830ed43e"),
    "drift_shift": (1384, "e16ba852fa6f758705e4ca6e961feaf7"),
    "elastic_control": (449, "c9112c5190fdb2e82708446bf03da8e5"),
    "flash_crowd": (4295, "e5380cc7b81477607c6c4d4cb951091d"),
    "flash_crowd_scale": (5049, "ca9666e3b19d62f01f5d881842ab556c"),
}
# Game days that run a coordinator under succession (candidates >= 2): their
# control-lane journal is audited against the role machines.
GAMEDAY_SUCCESSION = ("campaign_kill_swap", "coordinator_kill")
# The two game days that declare real-time pacing judge the autoscaler's
# decisions, and those race the reference's own scale policy: the fleet's
# start leaves a backlog spike that fires the burn for ~0.7-0.9 virtual s,
# while fleet_idle's scale-in, clamped at min_workers, is denied and
# restarts the cooldown every cooldown_s; a burn whose window falls inside a
# cooldown never scales out. The JAX package's runs of the same day on the
# same host fail the same three gates at the same rate as the port's
# (tests/gameday_twin_rates.py; PERF.md). These gates of those days are
# printed and returned, not gated; every other gate of theirs is.
GAMEDAY_DECISION_GATES = ("scaled_out", "scaled_in", "reaction_bounded_s")
GAMEDAY_SERVE = "diurnal_hotkey"        # serve --scenario's passing run
GAMEDAY_SERVE_FAIL = "flash_crowd"      # ... and its exit-4 run (no shed flags)


def timeline_digest(events) -> str:
    """SHA-256 over a timeline's events in order (t, key, value, family)."""
    import hashlib

    h = hashlib.sha256()
    for e in events:
        h.update(repr((e.t, e.key, e.value, e.kind)).encode())
    return h.hexdigest()[:32]


class _Recorder:
    """Records, while active, every ``ServingPipeline`` built and every
    traffic feeder made by ``run_gameday``, so a game day's gates can read
    the chunks its pipelines dispatched and the timeline its feeder
    walked."""

    def __init__(self):
        self.pipelines, self.feeders = [], []

    def __enter__(self):
        from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
        from fraud_detection_tpu_torch.scenarios import gameday as G

        rec = self
        self._saved = (ServingPipeline.__init__, G.TrafficFeeder)
        init, feeder_cls = self._saved

        def recording_init(pipe, *a, **kw):
            init(pipe, *a, **kw)
            rec.pipelines.append(pipe)

        class Feeder(feeder_cls):
            def __init__(f, *a, **kw):
                super().__init__(*a, **kw)
                rec.feeders.append(f)

        ServingPipeline.__init__ = recording_init
        G.TrafficFeeder = Feeder
        return self

    def __exit__(self, *exc):
        from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
        from fraud_detection_tpu_torch.scenarios import gameday as G

        ServingPipeline.__init__, G.TrafficFeeder = self._saved
        return False


def run_gameday_gated(name: str, dev, card: str) -> dict:
    """One catalog game day on the card under device featurize, gated:
    every SLO verdict, the accounting SLO among them (out ∪ DLQ keys
    equal the timeline's: ``exact_accounting``, or chaos_storm's
    ``zero_loss``, where chaos redelivers); the feeder walked the JAX
    package's timeline (its digest) and fed every row;
    ``featurize_packed`` launches (reset just before the run) equal the
    chunks its device-featurize pipelines dispatched; the succession game
    days' journals conform (0 violations over > 0 records); drift_shift
    refreshes at least once, its pipeline fit and each refresh launching
    the histogram and ``best_splits`` once per split level of every round.
    A day that declares real-time pacing holds every gate but its
    autoscale-decision gates (``GAMEDAY_DECISION_GATES``), whose outcomes
    are printed and returned; one run each, no retry."""
    import torch

    from fraud_detection_tpu_torch.models.train_trees import TreeTrainConfig
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.ops import histogram as H
    from fraud_detection_tpu_torch.registry import ModelRegistry
    from fraud_detection_tpu_torch.scenarios import gameday as G

    gd = G.get_scenario(name, GAMEDAY_SEED, scale=GAMEDAY_SCALE)
    H.node_feature_bin_histogram_multi.launches = 0
    H.best_splits.launches = 0
    pipe = G._default_pipeline(gd.batch_size, model=gd.model, device=dev,
                               featurize_device=True)
    fit = (H.node_feature_bin_histogram_multi.launches,
           H.best_splits.launches)
    if pipe.device_stats.featurize_path != "cuda":
        raise AssertionError(f"game day {name}: featurize path "
                             f"{pipe.device_stats.featurize_path}")
    torch.cuda.synchronize()
    H.node_feature_bin_histogram_multi.launches = 0
    H.best_splits.launches = 0
    fk.featurize_bytes.launches = 0
    chunks0 = pipe.device_stats.chunks
    with _Recorder() as rec:
        t0 = time.perf_counter()
        result = G.run_gameday(gd, pipeline=pipe)
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = fk.featurize_bytes.launches
    tree = (H.node_feature_bin_histogram_multi.launches,
            H.best_splits.launches)
    reported = GAMEDAY_DECISION_GATES if gd.time_scale is not None else ()
    decisions = {v.name: v.ok for v in result.report.verdicts
                 if v.name in reported}
    held = [v for v in result.report.verdicts if v.name not in decisions]
    if not all(v.ok for v in held):
        raise AssertionError(f"game day {name} failed its SLO gates:\n"
                             f"{result.table()}")
    rows, digest = GAMEDAY_TIMELINES[name]
    (feeder,) = rec.feeders
    if len(feeder.events) != rows or timeline_digest(feeder.events) \
            != digest or feeder.fed != rows:
        raise AssertionError(f"game day {name}: timeline of "
                             f"{len(feeder.events)} rows (fed {feeder.fed}) "
                             f"is not the JAX package's {rows}")
    on_device = [p for p in [pipe, *rec.pipelines]
                 if p.device_stats.featurize_path == "cuda"]
    chunks = sum(p.device_stats.chunks for p in on_device) - chunks0
    if launches < 1 or launches != chunks:
        raise AssertionError(f"game day {name}: featurize_packed launched "
                             f"{launches}x over {chunks} chunks dispatched")
    ev = result.evidence
    out = dict(rows=rows, mode=result.mode, wall_s=wall,
               msgs_per_s=rows / wall, featurize_packed_launches=launches,
               chunks=chunks, pipelines=len(on_device),
               verdicts=len(result.report.verdicts), gated=len(held),
               ok=result.ok, decision_gates=decisions)
    if name in GAMEDAY_SUCCESSION:
        conf = ev.get("conformance") or {}
        if conf.get("violation_count") != 0 or not conf.get("records"):
            raise AssertionError(f"game day {name}: conformance {conf}")
        out["conformance_records"] = conf["records"]
    if gd.learn is not None:
        versions = ev["learn"]["published_versions"]
        reg = ModelRegistry(ev["registry_root"])
        infos = [reg.get(v).manifest["learn"] for v in versions]
        # (a CPU run launches nothing: the plain versions run there)
        on_card = dev.type == "cuda"
        per_refresh = sum(i["rounds"] * i["max_depth"] for i in infos
                          ) if on_card else 0
        want_fit = (pipe.model.num_trees * TreeTrainConfig().max_depth
                    if on_card else 0)
        if not versions or tree != (per_refresh, per_refresh) \
                or fit != (want_fit, want_fit):
            raise AssertionError(
                f"game day {name}: refreshes {versions}, tree kernel "
                f"launches fit {fit} (want {want_fit} each) and run {tree} "
                f"(want {per_refresh} each)")
        out.update(refreshes=len(versions),
                   tree_launches=dict(fit=fit[0], refresh=tree[0]),
                   promoted=ev["learn"]["promoted"])
    elif any(tree):
        raise AssertionError(f"game day {name}: tree kernels launched {tree}")
    if gd.autoscale is not None:
        a = ev.get("autoscale") or {}
        out["autoscale"] = {k: a.get(k) for k in
                            ("scale_outs", "scale_ins", "replacements")}
        out["reaction_s"] = ev.get("autoscale_reaction_s")
    print(f"[gameday] {name} ({result.mode}, {rows} rows): PASS "
          f"{len(held)} gates"
          + (f", autoscale-decision gates (reported, not gated) "
             + ", ".join(f"{k} {'PASS' if ok else 'FAIL'}"
                         for k, ok in decisions.items())
             + f" (verdict {'PASS' if result.ok else 'FAIL'})"
             if decisions else "")
          + f"; wall {wall:.2f} s, "
          f"{rows / wall:.1f} msgs/s; featurize_packed {launches} launches = "
          f"{chunks} chunks ({len(on_device)} pipeline(s))"
          + (f"; conformance 0 violations over {out['conformance_records']} "
             "records" if "conformance_records" in out else "")
          + (f"; {out['refreshes']} refresh(es), tree kernels fit {fit[0]} + "
             f"refresh {tree[0]} each" if "refreshes" in out else "")
          + (f"; autoscale {out['autoscale']}, reaction {out['reaction_s']} "
             "s" if "autoscale" in out else "")
          + f" ({card})")
    return out


def gameday_phase(dev, ckpt: Path, work: Path, card: str) -> dict:
    """Phase 5e: the game days on the card (``scenarios/``). All 12 catalog
    scenarios at seed 0 and their own sizes, each on
    ``_default_pipeline(model=gd.model, featurize_device=True)`` passed to
    ``run_gameday`` (warp, but for the two scenarios that declare real-time
    pacing), gated by ``run_gameday_gated``; a profiled second run of
    flash_crowd for its device-idle share; ``serve --scenario
    diurnal_hotkey:0 --trace-record`` on the phase 5c checkpoint under
    device featurize (exit 0, an ok scenario block, fed == planned, a
    complete recording, ``featurize_packed`` launches = chunks), the same
    with ``flash_crowd:0`` and no shed flags (exit 4, admission_shed_bit
    failed), and ``python -m fraud_detection_tpu_torch.scenarios.replay``
    of the recording on the card (exit 0, keys_exact). No flash launch over
    the phase; then no thread of the phase left and device memory within
    1 MB of its start."""
    import gc
    import threading

    import torch

    from fraud_detection_tpu_torch.ops import attention as A
    from fraud_detection_tpu_torch.scenarios import gameday as G

    t_phase = time.perf_counter()
    # cuBLAS keeps a workspace per stream it ran on (the lanes make
    # streams of their own): both readings are taken with them released
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)
    torch.cuda.synchronize()
    gc.collect()
    clear()
    mem0 = torch.cuda.memory_allocated()
    threads0 = {t.ident for t in threading.enumerate()}
    A.flash_attention.launches = 0
    A.flash_attention_sm90.launches = A.flash_attention_simt.launches = 0
    runs = {name: run_gameday_gated(name, dev, card)
            for name in sorted(G.CATALOG)}

    def profiled_flash_crowd():
        gd = G.get_scenario("flash_crowd", GAMEDAY_SEED, scale=GAMEDAY_SCALE)
        pipe = G._default_pipeline(gd.batch_size, device=dev,
                                   featurize_device=True)
        pipe.predict(["warm"])
        return lambda: G.run_gameday(gd, pipeline=pipe)

    idle = profiled_idle(profiled_flash_crowd)

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rec = work / "diurnal_hotkey.jsonl"
    base = ["--device", str(dev), "--model", str(ckpt), "--featurize-device",
            "--demo", "1", "--batch-size", "256", "--scenario-scale", "1.0",
            "--scenario-time-scale", "0"]
    r = serve_cli(base + ["--scenario", f"{GAMEDAY_SERVE}:{GAMEDAY_SEED}",
                          "--trace-record", str(rec)], card)
    stats, launches = r["stats"], r["launches"]
    sc = stats.get("scenario") or {}
    rows = GAMEDAY_TIMELINES[GAMEDAY_SERVE][0]
    chunks = r["engine"].pipeline.device_stats.chunks
    if sc.get("ok") is not True or sc["fed"] != sc["planned"] \
            or sc["planned"] != rows \
            or stats["trace_record"]["complete"] is not True \
            or launches < 1 or launches != chunks:
        raise AssertionError(f"serve --scenario {GAMEDAY_SERVE}: "
                             f"scenario {sc}, trace_record "
                             f"{stats.get('trace_record')}, featurize_packed "
                             f"{launches}x over {chunks} chunks")
    serve_ok = dict(msgs_per_sec=stats["msgs_per_sec"], rows=rows,
                    verdicts=len(sc["verdicts"]),
                    spans=stats["trace_record"]["spans"],
                    featurize_packed_launches=launches)
    r = serve_cli(base + ["--scenario", f"{GAMEDAY_SERVE_FAIL}:{GAMEDAY_SEED}"],
                  card, rc=4)
    sc = r["stats"].get("scenario") or {}
    failed = {v["name"] for v in sc.get("verdicts", [])
              if not v["ok"] and not v["skipped"]}
    if sc.get("ok") is not False or "admission_shed_bit" not in failed:
        raise AssertionError(f"serve --scenario {GAMEDAY_SERVE_FAIL}: "
                             f"failed gates {sorted(failed)}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fraud_detection_tpu_torch.scenarios.replay",
         str(rec)], cwd=str(ROOT), capture_output=True, text=True,
        timeout=600)
    replay_s = time.perf_counter() - t0
    report = (json.loads(proc.stdout.strip().splitlines()[-1])
              if proc.returncode in (0, 1) and proc.stdout.strip() else {})
    if proc.returncode != 0 or report.get("keys_exact") is not True \
            or report.get("rows") != rows:
        raise AssertionError(f"replay of {rec.name}: exit {proc.returncode}, "
                             f"{report}\n{proc.stderr[-2000:]}")
    print(f"[gameday] serve --scenario {GAMEDAY_SERVE}:{GAMEDAY_SEED} exit 0 "
          f"({serve_ok['verdicts']} gates ok, fed {rows} = planned, "
          f"recording complete with {serve_ok['spans']} spans, "
          f"featurize_packed {launches} launches = chunks); "
          f"--scenario {GAMEDAY_SERVE_FAIL}:{GAMEDAY_SEED} without shed flags "
          f"exit 4 (admission_shed_bit failed); replay on the card exit 0, "
          f"keys_exact over {report['rows']} rows in {replay_s:.1f} s "
          f"({card})")

    flash = A.flash_attention.launches
    if flash:
        raise AssertionError(f"game days launched flash_attention {flash}x, "
                             "want 0")
    deadline = time.monotonic() + 30.0
    while True:
        # (the host featurizer's process-wide pool grows on demand: its
        # threads are not the phase's)
        left = sorted(t.name for t in threading.enumerate()
                      if t.is_alive() and t.ident not in threads0
                      and not t.name.startswith("featurize"))
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    torch.cuda.synchronize()
    gc.collect()
    clear()
    mem1 = torch.cuda.memory_allocated()
    if left or abs(mem1 - mem0) > 1 << 20:
        raise AssertionError(f"game days: threads left {left}, device memory "
                             f"{mem1} B vs {mem0} B at the phase's start")
    wall = time.perf_counter() - t_phase
    total = sum(r["rows"] for r in runs.values())
    verdicts = sum(r["ok"] for r in runs.values())
    print(f"[gameday] {len(runs)} of {len(G.CATALOG)} game days hold their "
          f"gates, {verdicts} of {len(runs)} whole verdicts PASS (the paced "
          f"days' autoscale-decision gates reported, not gated; {total} rows; "
          f"featurize_packed "
          f"{sum(r['featurize_packed_launches'] for r in runs.values())} "
          f"launches = chunks); flash_attention 0 launches; device idle over "
          f"flash_crowd {idle:.4f}; no thread left, memory {mem1 - mem0:+d} "
          f"B; phase wall {wall:.1f} s ({card})")
    return dict(runs=runs, rows=total, flash_crowd_device_idle=idle,
                serve=serve_ok, replay=dict(rows=report["rows"],
                                            keys_exact=True,
                                            wall_s=replay_s),
                flash_launches=flash, memory_delta_bytes=mem1 - mem0,
                wall_s=wall, card=card)

def check_serve_runs(ckpt, n: int, dev, card: str, variants) -> dict:
    """Serve ``ckpt`` with each flag variant over ``--demo n``: every run
    classifies n (or n minus its shed rows); host featurize launches no
    ``featurize_packed`` and takes the raw-JSON path with native frames;
    ``--featurize-device`` launches it once per chunk dispatched."""
    results = {}
    for name, extra in variants.items():
        r = serve_cli(["--device", str(dev), "--model", str(ckpt), "--demo",
                       str(n), "--batch-size", "1024", *extra], card)
        stats, eng = r["stats"], r["engine"]
        device = stats["health"]["device"]
        if r["classified"] + stats["shed"] != n or stats["processed"] != n:
            raise AssertionError(f"serve {name}: classified {r['classified']}")
        if "--featurize-device" in extra:
            if device["featurize_path"] != "cuda" or r["launches"] < 1 \
                    or r["launches"] != device["uploads"] \
                    or device["uploads_per_batch"] != 1.0:
                raise AssertionError(f"serve {name}: featurize_packed "
                                     f"launched {r['launches']}x, {device}")
        elif r["launches"] or not (eng._json_fast is True
                                   and eng._frames_ok is True):
            raise AssertionError(f"serve {name}: featurize_packed launched "
                                 f"{r['launches']}x, _json_fast "
                                 f"{eng._json_fast}, _frames_ok {eng._frames_ok}")
        if "--async-dispatch" in extra and device["lane_batches"] != stats["batches"]:
            raise AssertionError(f"serve {name}: {device}")
        results[name] = dict(msgs_per_sec=stats["msgs_per_sec"],
                             classified=r["classified"],
                             featurize_packed_launches=r["launches"],
                             chunks=device["uploads"])
    return results


def profiled_idle(setup, tries: int = 3) -> float:
    """Device idle share of one call under torch.profiler: 1 - (device time
    of its kernels) / (host-clock wall of that same call, synchronized).
    ``setup()`` runs outside the trace and returns the call. A trace that
    records no device activity (the profiler drops one now and then) is
    taken again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn = setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us = sum(e.device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy_us:
            return 1 - busy_us / wall_us
    raise AssertionError(f"{tries} profiler traces recorded no device time")


def pipeline_rate(p, texts):
    """Rows/s of ``p.predict`` over ``texts`` (median of 5, host clock,
    each predict resolved) and the device idle share of a sixth, profiled
    predict."""
    p.predict(texts[:BATCH])
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        p.predict(texts)
        reps.append(time.perf_counter() - t0)
    idle = profiled_idle(lambda: lambda: p.predict(texts))
    return len(texts) / statistics.median(reps), idle


def engine_rate(pipe, items, **kw):
    """Engine msgs/s over ``items`` (batch 256, depth 2) and the device
    idle share of a second, profiled ``engine.run`` (the broker is built
    and loaded outside the trace)."""
    _, stats, _, _ = run_engine(pipe, items, BATCH, **kw)

    def setup():
        engine, _ = make_engine(pipe, items, BATCH, **kw)
        return lambda: engine.run(max_messages=len(items), idle_timeout=5.0)

    return stats.msgs_per_sec, profiled_idle(setup)


# ---------------------------------------------------------------------------
# the model lifecycle: registry, hot swap, shadow, promotion, learn lane
# ---------------------------------------------------------------------------

def lifecycle_texts(seed: int):
    """The lifecycle stream: LC_MSGS texts from the serve demo's corpus
    (``generate_corpus(n=2000, seed=123)``, cycled) with every
    LC_DRIFT_EVERY-th replaced by the next of ``drift_scam_pool(seed,
    LC_DRIFT)``; returns (texts, drift flags, ground truth: the corpus
    label, 1 for a drift row)."""
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.scenarios import drift_scam_pool

    corpus = generate_corpus(n=2000, seed=123)
    drift = drift_scam_pool(seed, LC_DRIFT)
    texts, flags, truth = [], [], []
    for i in range(LC_MSGS):
        is_drift = i % LC_DRIFT_EVERY == LC_DRIFT_EVERY - 1
        doc = corpus[i % len(corpus)]
        texts.append(drift[i // LC_DRIFT_EVERY] if is_drift else doc.text)
        flags.append(is_drift)
        truth.append(1 if is_drift else int(doc.label))
    return texts, flags, truth


def wait_for(predicate, what: str, timeout: float = 120.0, faults=()):
    """Poll ``predicate`` until it holds; fail on a lane's device fault or
    at ``timeout``."""
    deadline = time.monotonic() + timeout
    while not predicate():
        for lane in faults:
            if lane.fault is not None:
                raise AssertionError(f"{what}: {type(lane).__name__} stopped "
                                     f"on a device fault: {lane.fault!r}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.01)


def new_trees(model, base_trees: int) -> dict:
    return {k: getattr(model, k)[base_trees:].cpu().numpy()
            for k in ("feature", "threshold", "left", "right", "leaf")}


def lifecycle_run(dev, xgb_ckpt: Path, out: Path, seed: int, card: str) -> dict:
    """Phase 7f's main path: the CLI's xgb100 checkpoint as v1 of a fresh
    registry, served through a HotSwapPipeline by the engine (raw JSON) with
    a ShadowScorer, a LearnLoop (LearnConfig defaults, its own thread,
    reading a feedback topic) and a LifecycleController on its watcher
    thread. The stream carries LC_DRIFT drift rows among LC_MSGS messages;
    their ground-truth labels wait on the feedback topic. Gates: every key
    out once in partition order; the lane publishes v2 (trigger drift),
    its refresh launching both tree kernels on the card; the controller
    stages, shadow-scores and promotes v2 (audit order, no load failure, no
    lane fault); the live model then flags > LC_FLAG_MIN of a fresh drift
    pool. Returns the phase's numbers and what later checks need."""
    import numpy as np

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.learn import LearnLoop
    from fraud_detection_tpu_torch.ops import histogram as H
    from fraud_detection_tpu_torch.registry import (HotSwapPipeline,
                                                    LifecycleController,
                                                    ModelRegistry,
                                                    PromotionPolicy,
                                                    ShadowScorer)
    from fraud_detection_tpu_torch.scenarios import drift_scam_pool
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)
    from fraud_detection_tpu_torch.stream.feedback import label_record

    root = out / "lifecycle_registry"
    shutil.rmtree(root, ignore_errors=True)
    reg = ModelRegistry(str(root))
    reg.publish_dir(str(xgb_ckpt), metrics={"source": "train CLI xgb100"})
    _, v1 = reg.load(1, batch_size=LC_BATCH, device=dev)
    hot = HotSwapPipeline(v1, version=1)
    texts, flags, truth = lifecycle_texts(seed)
    broker = InProcessBroker(num_partitions=3)
    broker.producer().produce_batch("lc-in", [
        (json.dumps({"text": t, "id": i}).encode(), str(i).encode())
        for i, t in enumerate(texts)])
    drift_keys = {str(i).encode() for i, f in enumerate(flags) if f}
    broker.producer().produce_batch("lc-feedback", [
        (label_record(m.topic, m.partition, m.offset, 1), m.key)
        for m in broker.messages("lc-in") if m.key in drift_keys])
    shadow = ShadowScorer(max_queue=64, window_batches=16)
    loop = LearnLoop(feedback_consumer=broker.consumer(["lc-feedback"], "learn"),
                     registry=reg, hotswap=hot, shadow=shadow)
    engine = StreamingClassifier(hot, broker.consumer(["lc-in"], "lc"),
                                 broker.producer(), "lc-out",
                                 batch_size=LC_BATCH, max_wait=0.05,
                                 shadow=shadow, learn=loop)
    controller = LifecycleController(
        reg, hot, shadow=shadow, policy=PromotionPolicy.parse(LC_POLICY),
        batch_size=LC_BATCH, health_fn=engine.health,
        on_transition=loop.on_transition)
    loop.bind_controller(controller)
    lanes = (loop, controller, shadow)
    H.node_feature_bin_histogram_multi.launches = 0
    H.best_splits.launches = 0
    watch_thread, watch_stop = controller.run_in_thread(0.02)
    try:
        stats = engine.run(max_messages=LC_MSGS, idle_timeout=5.0)
        pins = {"v1": engine.health()["device"]["model_pins"]}
        wait_for(lambda: loop.snapshot()["published"] >= 1,
                 "the learn lane's v2", faults=lanes)
        launches = {"histogram": H.node_feature_bin_histogram_multi.launches,
                    "best_splits": H.best_splits.launches}
        wait_for(lambda: hot.active_version == 2, "promotion of v2",
                 faults=lanes)
    finally:
        watch_stop.set()
        watch_thread.join(timeout=10.0)
        loop.close(timeout=30.0)
    health = engine.health()
    pins["v2"] = health["device"]["model_pins"]
    for lane in lanes:
        if lane.fault is not None:
            raise AssertionError(f"{type(lane).__name__} device fault: "
                                 f"{lane.fault!r}")
    outs = broker.messages("lc-out")
    if stats.processed != LC_MSGS or sorted(m.key for m in outs) != sorted(
            str(i).encode() for i in range(LC_MSGS)):
        raise AssertionError(f"lifecycle stream: {stats.processed} processed, "
                             f"{len(outs)} out")
    for part in range(3):
        want = [m.key for m in broker.messages("lc-in") if m.partition == part]
        if [m.key for m in outs if m.partition == part] != want:
            raise AssertionError(f"lifecycle stream: partition {part} reordered")
    learn = loop.snapshot()
    mv2 = reg.get(2)
    info = mv2.manifest["learn"]
    if learn["published_versions"] != [2] or info["trigger"] != "drift" \
            or learn["last_trigger"] != "drift":
        raise AssertionError(f"learn lane: {learn}, manifest {info}")
    # one histogram and one best_splits per split level of every round (a
    # CPU run launches nothing: the plain versions run there)
    per_retrain = (info["rounds"] * info["max_depth"]
                   if dev.type == "cuda" else 0)
    if launches != {"histogram": per_retrain, "best_splits": per_retrain}:
        raise AssertionError(f"the refresh launched {launches}, want "
                             f"{per_retrain} of each tree kernel")
    events = [e["event"] for e in reg.read_audit()]
    if events != ["publish", "publish", "stage", "promote"] or [
            e["event"] for e in controller.events] != ["stage", "promote"]:
        raise AssertionError(f"audit events {events}")
    promo = controller.events[-1]
    if promo["version"] != 2 or promo["mode"] != "shadow" \
            or promo["shadow"]["rows"] < 1:
        raise AssertionError(f"promotion {promo}")
    fresh = drift_scam_pool(seed + 1, LC_DRIFT)
    flagged = float(np.mean(hot.predict(fresh).labels))
    if not flagged > LC_FLAG_MIN:
        raise AssertionError(f"after the promotion the live model flags "
                             f"{flagged:.4f} of a fresh drift pool")
    legit = [d.text for d in generate_corpus(n=2000, seed=123) if d.label == 0]
    legit_flagged = float(np.mean(hot.predict(legit).labels))
    shadow.close(timeout=10.0)
    window = loop.store.labeled_rows()
    # The two-class window: the corpus truth of the lane's other scored rows
    # joined into its (closed) store beside the drift labels.
    for m in broker.messages("lc-in"):
        if m.key not in drift_keys:
            loop.store.join((m.topic, m.partition, m.offset),
                            truth[int(m.key)])
    two_class = loop.store.labeled_rows()
    if len(two_class) != LC_MSGS:
        raise AssertionError(f"two-class window: {len(two_class)} rows")
    print(f"[lifecycle] {LC_MSGS} messages ({LC_DRIFT} drift rows) through "
          f"v1 with shadow + learn lanes: keys exact, partition order kept, "
          f"{stats.msgs_per_sec:.0f} msgs/s; v2 published (trigger drift, "
          f"{info['window_rows']} rows padded to {info['padded_rows']}, "
          f"{info['rounds']} rounds, retrain wall {learn['last_retrain_wall_s']}"
          f" s) launching histogram {launches['histogram']}x and best_splits "
          f"{launches['best_splits']}x; audit {events}; promoted after "
          f"{promo['shadow']['rows']} shadow rows; fresh drift pool flagged "
          f"{flagged:.4f} (> {LC_FLAG_MIN}); corpus legit rows flagged "
          f"{legit_flagged:.4f} (not gated); model_pins {pins} ({card})")
    return dict(msgs_per_sec=stats.msgs_per_sec,
                p99_row_latency_ms=stats.row_latency_ms(0.99),
                launches=launches, learn=learn, manifest_learn=info,
                events=events, promote_shadow_rows=promo["shadow"]["rows"],
                fresh_drift_flagged=flagged, legit_flagged=legit_flagged,
                model_pins=pins, model_block=health["model"],
                registry=reg, v1=v1, hot=hot, window=window,
                two_class_window=two_class, seed=seed)


def refresh_card_vs_cpu(lc: dict, dev) -> dict:
    """Two windows through ``refresh_gradient_boosting`` on the card and on
    the CPU, from v1: the lane's own (the drift rows, at the smallest
    rung), whose card refresh must equal the published v2's trees, and the
    two-class window's last LC_TWIN_ROWS rows (scored rows with their ground
    truth). On each, the new trees' feature / split (threshold) / children
    are equal and p on the window is within LC_P_TOL. The whole two-class
    window (all LC_MSGS rows, at LearnConfig's max_train_rows rung) is
    refreshed on the card, and that model may flag at most LC_LEGIT_MAX of
    the window's legit rows. Also that refresh's wall (median of 3) and
    device idle share. (The CPU twin took the whole window until the LLM
    trainer's phases needed the time: 50.8 s of the script's 1,200.)"""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.learn import LearnConfig, LearnLoop
    from fraud_detection_tpu_torch.models import trees as tm
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.models.train_trees import (
        refresh_gradient_boosting)
    from fraud_detection_tpu_torch.scenarios import drift_scam_pool

    v1 = lc["v1"]
    base = v1.model.num_trees
    rounds = lc["manifest_learn"]["rounds"]
    cap = LearnConfig().max_train_rows

    def card_vs_cpu(name, rows):
        X, y = LearnLoop._densify(rows[-LC_TWIN_ROWS:], v1.featurizer)
        got = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            model, info = refresh_gradient_boosting(
                v1.model.to(d), X, y, n_rounds=rounds, device=d)
            wall = time.perf_counter() - t0
            p = tm.predict_proba(model, torch.from_numpy(X).to(d))[:, 1]
            got[side] = (model, info, p.cpu().numpy(), wall)
        card, cpu = (new_trees(got[k][0], base) for k in ("card", "cpu"))
        for k in ("feature", "threshold", "left", "right"):
            if not np.array_equal(card[k], cpu[k]):
                raise AssertionError(f"refresh card vs CPU ({name} window): "
                                     f"new trees' {k} differ")
        dp = float(np.max(np.abs(got["card"][2] - got["cpu"][2])))
        if got["card"][1] != got["cpu"][1] or not dp <= LC_P_TOL:
            raise AssertionError(f"refresh card vs CPU ({name} window): max "
                                 f"|dp| {dp}, info {got['card'][1]} / "
                                 f"{got['cpu'][1]}")
        out = dict(max_abs_dp=dp, rows=X.shape[0],
                   rung=got["card"][1]["padded_rows"],
                   card_wall_s=got["card"][3], cpu_wall_s=got["cpu"][3])
        print(f"[lifecycle] refresh of the {name} window ({X.shape[0]} x "
              f"{X.shape[1]} at rung {out['rung']}, {rounds} rounds): card and "
              f"CPU trees equal, max |dp| {dp:.3g} <= {LC_P_TOL}; walls card "
              f"{out['card_wall_s']:.3f} s, CPU {out['cpu_wall_s']:.3f} s "
              "(host clock)")
        return out, X, y, got["card"], card

    drift, X, y, _, card = card_vs_cpu("drift", lc["window"])
    _, v2 = lc["registry"].load(2, batch_size=LC_BATCH, device=dev)
    lane = new_trees(v2.model, base)
    for k in ("feature", "threshold", "left", "right"):
        if not np.array_equal(lane[k], card[k]):
            raise AssertionError(f"the published v2's new trees' {k} differ "
                                 "from a card refresh of its window")
    drift["v2_leaf_max_abs_diff"] = float(
        np.max(np.abs(lane["leaf"] - card["leaf"])))
    print(f"[lifecycle] v2's trees equal the card refresh of the lane's window "
          f"(leaf max |diff| {drift['v2_leaf_max_abs_diff']:.3g})")

    two, _, _, _, _ = card_vs_cpu("two-class", lc["two_class_window"])
    X2, y2 = LearnLoop._densify(lc["two_class_window"][-cap:], v1.featurizer)
    model2, info2 = refresh_gradient_boosting(v1.model.to(dev), X2, y2,
                                              n_rounds=rounds, device=dev)
    p2 = tm.predict_proba(model2, torch.from_numpy(X2).to(dev))[:, 1]
    p2 = p2.cpu().numpy()
    two["window_rows"] = X2.shape[0]
    if info2["padded_rows"] != cap:
        raise AssertionError(f"two-class window at rung "
                             f"{info2['padded_rows']}, want {cap}")
    legit = y2 == 0
    p_v1 = tm.predict_proba(v1.model, torch.from_numpy(X2).to(dev))[:, 1]
    two.update(
        scam_rows=int(np.sum(y2 == 1)), legit_rows=int(np.sum(legit)),
        legit_flagged=float(np.mean(p2[legit] > 0.5)),
        v1_legit_flagged=float(np.mean(p_v1.cpu().numpy()[legit] > 0.5)),
        scam_flagged=float(np.mean(p2[~legit] > 0.5)))
    fresh = drift_scam_pool(lc["seed"] + 1, LC_DRIFT)
    two["fresh_drift_flagged"] = float(np.mean(ServingPipeline(
        v1.featurizer, model2, batch_size=LC_BATCH,
        device=dev).predict(fresh).labels))
    if not two["legit_flagged"] <= LC_LEGIT_MAX:
        raise AssertionError(f"the two-class refresh flags "
                             f"{two['legit_flagged']:.4f} of the window's "
                             f"legit rows (limit {LC_LEGIT_MAX})")

    def refresh():
        refresh_gradient_boosting(v1.model, X2, y2, n_rounds=rounds,
                                  device=dev)

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        refresh()
        walls.append(time.perf_counter() - t0)
    two["wall_s"] = statistics.median(walls)
    two["device_idle"] = profiled_idle(lambda: refresh)
    print(f"[lifecycle] two-class window ({two['scam_rows']} scam, "
          f"{two['legit_rows']} legit rows): the refresh flags "
          f"{two['legit_flagged']:.4f} of the legit rows (<= {LC_LEGIT_MAX}; "
          f"v1 {two['v1_legit_flagged']:.4f}) and {two['scam_flagged']:.4f} "
          f"of the scam rows and {two['fresh_drift_flagged']:.4f} of a fresh "
          f"drift pool (not gated); card refresh wall "
          f"{two['wall_s']:.4f} s (median of 3), device idle "
          f"{two['device_idle']:.4f}")
    return dict(drift=drift, two_class=two, X=X, y=y)


def lane_figures(lc: dict, fit: dict, dev, card: str) -> dict:
    """Printed, not gated: the primary's msgs/s and p99 row latency over
    LC_RATE_MSGS messages with the lanes off, with a refresh of the lane's
    window running back to back on a lane stream, and after (shadow and an
    idle learn lane attached); one refresh's wall and device idle share;
    the prewarm wall and the pointer swap; shadow rows/s."""
    import threading

    import numpy as np

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.learn import LearnConfig, LearnLoop
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.models.train_trees import (
        refresh_gradient_boosting)
    from fraud_detection_tpu_torch.registry import (HotSwapPipeline,
                                                    ShadowScorer)
    from fraud_detection_tpu_torch.utils.device import lane_stream, on_lane

    reg, v1 = lc["registry"], lc["v1"]
    X, y = fit["X"], fit["y"]
    rounds = lc["manifest_learn"]["rounds"]
    corpus = [d.text for d in generate_corpus(n=2000, seed=123)]
    items = [(json.dumps({"text": corpus[i % len(corpus)], "id": i}).encode(),
              str(i).encode()) for i in range(LC_RATE_MSGS)]
    pipe = ServingPipeline(v1.featurizer, v1.model, batch_size=1024,
                           device=dev)

    def refresh():
        refresh_gradient_boosting(v1.model, X, y, n_rounds=rounds, device=dev)

    def engine_figures(**kw):
        _, stats, _, _ = run_engine(pipe, items, 1024, **kw)
        return dict(msgs_per_sec=stats.msgs_per_sec,
                    p99_row_latency_ms=stats.row_latency_ms(0.99))

    pipe.predict(corpus[:1024])
    rates = {"lanes_off": engine_figures()}
    stop, done = threading.Event(), []

    def refresh_loop():
        with on_lane(lane_stream(dev, {})):
            while not stop.is_set():
                refresh()
                done.append(1)

    worker = threading.Thread(target=refresh_loop, name="refresh")
    worker.start()
    try:
        rates["during_retrain"] = engine_figures()
    finally:
        stop.set()
        worker.join()
    rates["during_retrain"]["retrains_finished"] = len(done)
    _, v2 = reg.load(2, batch_size=1024, device=dev)
    shadow = ShadowScorer(max_queue=8)
    shadow.set_candidate(v2, version=2)
    idle_lane = LearnLoop(registry=reg, hotswap=HotSwapPipeline(pipe, 1),
                          config=LearnConfig(min_labeled=10 ** 6))
    try:
        rates["after_lanes_on"] = engine_figures(shadow=shadow, learn=idle_lane)
        rates["after_lanes_on"]["shadow_rows"] = shadow.snapshot()["rows"]
    finally:
        idle_lane.close(timeout=30.0)
        shadow.close(timeout=30.0)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        refresh()
        walls.append(time.perf_counter() - t0)
    idle = profiled_idle(lambda: refresh)
    hot = HotSwapPipeline(pipe, version=1)
    _, cand = reg.load(2, batch_size=1024, device=dev)
    t0 = time.perf_counter()
    hot.stage(cand, version=2)
    prewarm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hot.promote_staged()
    swap_us = (time.perf_counter() - t0) * 1e6
    sh = ShadowScorer(max_queue=64)
    sh.set_candidate(cand, version=2)
    values = [v for v, _ in items[:LC_SHADOW_ROWS]]
    prim = pipe.predict([json.loads(v)["text"] for v in values])
    try:
        t0 = time.perf_counter()
        for s in range(0, len(values), 1024):
            if not sh.submit(values[s:s + 1024], prim.labels[s:s + 1024],
                             prim.probabilities[s:s + 1024], raw=True):
                raise AssertionError("shadow queue dropped a batch")
        if not sh.drain(60.0):
            raise AssertionError("shadow queue never drained")
        shadow_rows_s = sh.snapshot()["rows"] / (time.perf_counter() - t0)
    finally:
        sh.close(timeout=10.0)
    out = dict(engine=rates, retrain_wall_s=statistics.median(walls),
               retrain_device_idle=idle, prewarm_wall_s=prewarm_s,
               swap_us=swap_us, shadow_rows_per_s=shadow_rows_s,
               window_rung=fit["drift"]["rung"],
               window_rows=fit["drift"]["rows"])
    print(f"[lifecycle] {card}: primary over {LC_RATE_MSGS} msgs (batch "
          "1024, raw JSON): " + "; ".join(
              f"{k} {v['msgs_per_sec']:.0f} msgs/s p99 "
              f"{v['p99_row_latency_ms']} ms" for k, v in rates.items())
          + f" ({len(done)} refreshes finished during the run); refresh wall "
          f"{out['retrain_wall_s']:.4f} s (median of 3), device idle "
          f"{idle:.4f}; prewarm {prewarm_s:.4f} s, pointer swap "
          f"{swap_us:.1f} us; shadow {shadow_rows_s:.0f} rows/s; window "
          f"{fit['drift']['rows']} rows at rung {fit['drift']['rung']}")
    return out


def lifecycle_cli(dev, xgb_ckpt: Path, v2_dir: str, out: Path,
                  card: str) -> dict:
    """``serve --registry --watch --shadow --promote-policy --learn --demo
    SERVE_DEMO --batch-size 1024`` on the card: once the engine delivers its
    first batch, a thread publishes the learn lane's v2 as the registry's
    v2 and the delivery waits until the watcher has staged it. The run must
    exit 0 (no lane fault), classify every message and show the stage (or
    a swap) in the stats JSON's lifecycle block."""
    import threading

    from fraud_detection_tpu_torch.registry import ModelRegistry
    from fraud_detection_tpu_torch.stream import engine as engine_mod

    root = out / "lifecycle_cli_registry"
    shutil.rmtree(root, ignore_errors=True)
    reg = ModelRegistry(str(root))
    reg.publish_dir(str(xgb_ckpt))
    deliver = engine_mod.StreamingClassifier._deliver
    staged = {}

    def publish():
        staged["version"] = reg.publish_dir(v2_dir).version

    def first_delivery_publishes(self, *a, **kw):
        if not staged:
            staged["thread"] = threading.Thread(target=publish)
            staged["thread"].start()
            staged["thread"].join()
            deadline = time.monotonic() + 30.0
            while not any(e["event"] == "stage" for e in reg.read_audit()):
                if time.monotonic() > deadline:
                    raise AssertionError("the watcher never staged v2")
                time.sleep(0.005)
        return deliver(self, *a, **kw)

    engine_mod.StreamingClassifier._deliver = first_delivery_publishes
    try:
        r = serve_cli(["--device", str(dev), "--registry", str(root),
                       "--watch", "--watch-interval", "0.02", "--shadow",
                       "--promote-policy", LC_POLICY, "--learn", "--demo",
                       str(SERVE_DEMO), "--batch-size", "1024"], card)
    finally:
        engine_mod.StreamingClassifier._deliver = deliver
    stats, lc = r["stats"], r["stats"]["lifecycle"]
    events = [e["event"] for e in lc["events"]]
    if r["classified"] != SERVE_DEMO or stats["processed"] != SERVE_DEMO \
            or "stage" not in events or staged.get("version") != 2:
        raise AssertionError(f"serve --registry: classified {r['classified']}"
                             f", lifecycle {lc}")
    print(f"[lifecycle] serve --registry --watch --shadow --promote-policy "
          f"--learn: exit 0, classified {r['classified']}, lifecycle events "
          f"{events}, active v{lc['active_version']}, swaps {lc['swaps']}, "
          f"learn window rows {lc['learn']['window']['rows']} ({card})")
    return dict(msgs_per_sec=stats["msgs_per_sec"], events=events,
                active_version=lc["active_version"], swaps=lc["swaps"],
                learn_window_rows=lc["learn"]["window"]["rows"])


def lifecycle(dev, xgb_ckpt: Path, out: Path, seed: int, card: str) -> dict:
    """Phase 7f: the lifecycle's main path, the refresh card vs CPU, the
    lanes' figures and the serve CLI's registry flags."""
    lc = lifecycle_run(dev, xgb_ckpt, out, seed, card)
    fit = refresh_card_vs_cpu(lc, dev)
    figures = lane_figures(lc, fit, dev, card)
    cli = lifecycle_cli(dev, xgb_ckpt, lc["registry"].get(2).checkpoint_path,
                        out, card)
    keep = ("msgs_per_sec", "p99_row_latency_ms", "launches", "manifest_learn",
            "events", "promote_shadow_rows", "fresh_drift_flagged",
            "legit_flagged", "model_pins", "model_block")
    return dict(run={k: lc[k] for k in keep},
                learn={k: v for k, v in lc["learn"].items()
                       if k != "error_by_version"},
                refresh_card_vs_cpu={k: v for k, v in fit.items()
                                     if k not in ("X", "y")},
                figures=figures, serve_cli=cli)

# ---------------------------------------------------------------------------
# serving from Kafka and across devices: the Kafka adapter over a stand-in
# broker, mesh serving, data-parallel training, the multi-process helpers
# ---------------------------------------------------------------------------

KAFKA_MSGS = 4096        # phase 7g: messages of each --kafka run
MESH_SHARDS = 4          # phases 7h-7i: the virtual mesh's shards on cuda:0
MESH_PER_CHIP = 256      # phase 7h: rows a shard scores (global batch 1,024)
MESH_XGB_ROUNDS = 8      # phase 7i: rounds of the CLI-shape virtual-mesh xgb


def fake_kafka():
    """The stand-in ``confluent_kafka`` of the port's tests
    (``tests/torch_fake_kafka.py``), loaded from the checkout's tests."""
    import importlib.util

    path = ROOT / "tests" / "torch_fake_kafka.py"
    spec = importlib.util.spec_from_file_location("torch_fake_kafka", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kafka_serve(argv, cluster, items, topic: str, card: str) -> dict:
    """``serve --kafka`` in-process (``serve_cli``) over the stand-in
    cluster holding ``items`` on ``topic``: exit 0, every fed key out once
    (malformed rows as error records), each partition's committed offset
    its last offset + 1."""
    for value, key in items:
        cluster.append(topic, value, key)
    out_topic = f"{topic}-out"
    r = serve_cli(["--kafka", "--input-topic", topic, "--output-topic",
                   out_topic, "--max-messages", str(len(items)),
                   "--batch-size", "1024", *argv], card)
    keys = sorted(m.key() for m in cluster.records(out_topic))
    if keys != sorted(k for _, k in items):
        raise AssertionError(f"serve --kafka {argv}: {len(keys)} output keys "
                             f"!= the {len(items)} fed")
    high = cluster.high_watermarks(topic)
    committed = {p: cluster.committed.get(("dialogue-classifier-group", topic,
                                           p)) for p in high}
    if committed != high:
        raise AssertionError(f"serve --kafka {argv}: committed {committed} "
                             f"!= last offset + 1 {high}")
    return r


def kafka_phase(dev, ckpt: Path, card: str, seed: int) -> dict:
    """Phase 7g: the serve CLI's ``--kafka`` path over the stand-in broker
    (``tests/torch_fake_kafka.py``: partitions, group offsets, compaction;
    no real broker or librdkafka on this machine) at the CLI's batch
    (1,024) on the LR checkpoint, host featurize (the raw-JSON path and
    native frames, no ``featurize_packed`` launch) and
    ``--featurize-device`` (one launch per chunk dispatched); the host run
    in turns with ``--demo`` on the same checkpoint (kafka, demo, demo,
    kafka); then a ``KafkaControlBus`` round trip: lease records published,
    the control topic compacted, the newest lease read back by a second
    bus."""
    fk_mod = fake_kafka()
    cluster = fk_mod.FakeCluster(num_partitions=3)
    restore = fk_mod.install(fk_mod.module(cluster))
    print("[kafka] the broker is a stand-in: tests/torch_fake_kafka.py "
          "FakeCluster behind the confluent_kafka client surface (no "
          "librdkafka, no network)")
    try:
        items, _ = chaos_items(KAFKA_MSGS, seed + 71)
        base = ["--device", str(dev), "--model", str(ckpt)]
        turns = {"kafka": [], "demo": []}
        runs = {}
        for i, mode in enumerate(("kafka", "demo", "demo", "kafka")):
            if mode == "kafka":
                r = kafka_serve(base, cluster, items, f"kafka-host-{i}", card)
                eng, dev_block = r["engine"], r["stats"]["health"]["device"]
                if r["launches"] or not (eng._json_fast is True
                                         and eng._frames_ok is True):
                    raise AssertionError(
                        f"serve --kafka: featurize_packed {r['launches']}x, "
                        f"_json_fast {eng._json_fast}, _frames_ok "
                        f"{eng._frames_ok}")
                turns["kafka"].append(r["stats"]["msgs_per_sec"])
                runs["host"] = dict(msgs_per_sec=r["stats"]["msgs_per_sec"],
                                    chunks=dev_block["uploads"],
                                    json_fast=eng._json_fast,
                                    frames_ok=eng._frames_ok)
            else:
                r = serve_cli([*base, "--demo", str(KAFKA_MSGS),
                               "--batch-size", "1024"], card)
                turns["demo"].append(r["stats"]["msgs_per_sec"])
        r = kafka_serve([*base, "--featurize-device"], cluster, items,
                        "kafka-device", card)
        dev_block = r["stats"]["health"]["device"]
        if (dev_block["featurize_path"] != "cuda" or r["launches"] < 1
                or r["launches"] != dev_block["uploads"]):
            raise AssertionError(f"serve --kafka --featurize-device: "
                                 f"featurize_packed {r['launches']}x over "
                                 f"{dev_block['uploads']} chunks")
        runs["featurize_device"] = dict(
            msgs_per_sec=r["stats"]["msgs_per_sec"],
            featurize_packed_launches=r["launches"],
            chunks=dev_block["uploads"],
            # the raw-JSON path fronts the host featurize the kernel
            # replaces, so the engine takes the decode path here by design
            json_fast=r["engine"]._json_fast)
        print(f"[kafka] {card}: serve --kafka over {KAFKA_MSGS} messages x3 "
              f"partitions, keys exact, committed = last offset + 1 on every "
              f"partition; host featurize msgs/s {turns['kafka']} (raw JSON, "
              f"native frames, 0 featurize_packed launches) beside --demo "
              f"{turns['demo']} in turns; --featurize-device "
              f"{runs['featurize_device']['msgs_per_sec']} msgs/s, "
              f"featurize_packed {r['launches']} launches = "
              f"{dev_block['uploads']} chunks")
        from fraud_detection_tpu_torch.fleet import KafkaControlBus
        from fraud_detection_tpu_torch.utils.config import KafkaConfig

        pub = KafkaControlBus(KafkaConfig(consumer_group="fleet-pub"))
        for term in (1, 2, 3):
            pub.publish("lease", "coordinator",
                        {"partition": 0, "owner": "w1", "epoch": term},
                        term=term)
        pub.publish("heartbeat", "w1", {"batches": 7})
        removed = cluster.compact("__fleet_control")
        got = KafkaControlBus(KafkaConfig(consumer_group="fleet-read")).poll()
        leases = [r for r in got if r.kind == "lease"]
        if (removed != 2 or len(got) != 2 or len(leases) != 1
                or leases[0].payload["epoch"] != 3 or leases[0].term != 3):
            raise AssertionError(f"KafkaControlBus round trip: removed "
                                 f"{removed}, read {got}")
        print("[kafka] KafkaControlBus: 4 records published, compaction "
              "removed 2, a second bus read back the newest lease (term 3) "
              "and the heartbeat")
        return {"runs": runs, "turns": turns, "msgs": KAFKA_MSGS,
                "stand_in": "tests/torch_fake_kafka.py FakeCluster",
                "control_bus_removed": removed}
    finally:
        restore()


def plain_calls(names):
    """Count calls of the kernels' plain versions (``ops`` module
    attributes) while the block runs: (counts, restore)."""
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.ops import histogram as H

    mods = {"histogram_reference": H, "best_splits_reference": H,
            "featurize_bytes_reference": fk}
    counts = {n: 0 for n in names}
    saved = {n: getattr(mods[n], n) for n in names}

    def wrap(n):
        fn = saved[n]

        def counted(*a, **kw):
            counts[n] += 1
            return fn(*a, **kw)

        return counted

    for n in names:
        setattr(mods[n], n, wrap(n))

    def restore():
        for n in names:
            setattr(mods[n], n, saved[n])

    return counts, restore


def mesh_serving_phase(dev, ckpt: Path, feat, lr_gpu, texts, card: str,
                       seed: int) -> dict:
    """Phase 7h: ``MeshServingPipeline`` over the real local devices (on one
    card: the plain pipeline, labels and probabilities byte-identical,
    ``mesh_devices`` 1); a named virtual mesh of MESH_SHARDS shards on
    cuda:0 at the shipped widths (HashingTF 10,000, W = 2,048, 256 slots,
    per-chip 256, global 1,024) against the single-device card pipeline
    (labels equal, |dp| <= 1e-6), ``featurize_packed`` launches = chunks x
    shards, every prewarmed rung a shard multiple, the engine over it
    (keys exact, launches = chunks x shards), no plain version run, rows/s
    in turns with the single-device pipeline; then ``serve --mesh
    --featurize-device --demo 4096``."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.parallel import make_mesh
    from fraud_detection_tpu_torch.parallel.serving import (
        MeshServingPipeline, local_device_count)
    from fraud_detection_tpu_torch.sched import (AdaptiveScheduler,
                                                 SchedulerConfig)

    kw = dict(featurize_device=True, featurize_width=WIDTH,
              featurize_tokens=TOKENS)
    single = ServingPipeline(feat, lr_gpu, batch_size=MESH_PER_CHIP
                             * MESH_SHARDS, device=dev, **kw)
    real = MeshServingPipeline.from_pipeline(single)
    n_local = local_device_count(torch.device(dev).type)
    want = single.predict(texts)
    fk.featurize_bytes.launches = 0
    chunks0 = real.device_stats.chunks
    got = real.predict(texts)
    real_launches = fk.featurize_bytes.launches
    real_chunks = real.device_stats.chunks - chunks0
    if n_local == 1 and (real.mesh is not None or not np.array_equal(
            want.labels, got.labels) or not np.array_equal(
            want.probabilities, got.probabilities)):
        raise AssertionError("one-card mesh pipeline is not the plain one")
    real_dp = float(np.abs(got.probabilities - want.probabilities).max())
    if not np.array_equal(want.labels, got.labels) or real_dp > 1e-6:
        raise AssertionError(f"mesh over the local devices: labels differ or "
                             f"|dp| {real_dp}")
    if (real.device_stats.snapshot()["mesh_devices"] != n_local
            or real_launches != real_chunks * n_local):
        raise AssertionError(f"mesh over local devices: {real_launches} "
                             f"launches over {real_chunks} chunks, "
                             f"{real.device_stats.snapshot()}")
    print(f"[mesh] MeshServingPipeline over the {n_local} local device(s): "
          f"mesh_devices {n_local}, featurize_packed {real_launches} "
          f"launches = {real_chunks} chunks x {n_local}"
          + (", the plain pipeline, labels and p byte-identical"
             if n_local == 1 else f", labels equal, max |dp| {real_dp:.3g}"))
    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    vpipe = MeshServingPipeline(feat, lr_gpu, per_chip_batch=MESH_PER_CHIP,
                                mesh=mesh, **kw)
    counts, restore = plain_calls(("featurize_bytes_reference",))
    try:
        fk.featurize_bytes.launches = 0
        chunks0 = vpipe.device_stats.chunks
        got = vpipe.predict(texts)
        launches = fk.featurize_bytes.launches
        chunks = vpipe.device_stats.chunks - chunks0
        dp = float(np.abs(got.probabilities - want.probabilities).max())
        if not np.array_equal(got.labels, want.labels) or dp > 1e-6:
            raise AssertionError(f"virtual mesh: labels differ or |dp| {dp}")
        if launches != chunks * MESH_SHARDS or launches < 1:
            raise AssertionError(f"virtual mesh: featurize_packed {launches}x "
                                 f"over {chunks} chunks x {MESH_SHARDS}")
        sched = AdaptiveScheduler(SchedulerConfig(batch_deadline_ms=10),
                                  vpipe.batch_size)
        sched.prewarm(vpipe)
        rungs = list(vpipe.pad_ladder)
        if any(r % MESH_SHARDS for r in rungs):
            raise AssertionError(f"virtual mesh rungs {rungs}")
        per_chip = vpipe.device_stats.snapshot()["per_chip_rungs"]
        items, _ = chaos_items(KAFKA_MSGS, seed + 73)
        fk.featurize_bytes.launches = 0
        chunks0 = vpipe.device_stats.chunks
        engine, stats, out, dlq = run_engine(vpipe, items, vpipe.batch_size)
        eng_launches = fk.featurize_bytes.launches
        eng_chunks = vpipe.device_stats.chunks - chunks0
        if sorted(m.key for m in out) != sorted(k for _, k in items):
            raise AssertionError("virtual-mesh engine: keys != fed")
        if eng_launches != eng_chunks * MESH_SHARDS:
            raise AssertionError(f"virtual-mesh engine: {eng_launches} "
                                 f"launches over {eng_chunks} chunks")
        if engine.health()["device"]["mesh_devices"] != MESH_SHARDS:
            raise AssertionError(f"engine health {engine.health()['device']}")
        if counts["featurize_bytes_reference"]:
            raise AssertionError("a plain featurize ran on the card")
    finally:
        restore()
    print(f"[mesh] virtual mesh {MESH_SHARDS} x {dev} (per-chip "
          f"{MESH_PER_CHIP}, global {vpipe.batch_size}): {len(texts)} labels "
          f"equal the single-device card pipeline's, max |dp| {dp:.3g}; "
          f"featurize_packed {launches} launches = {chunks} chunks x "
          f"{MESH_SHARDS}; prewarmed rungs {rungs} (per chip {per_chip}); "
          f"engine over {len(items)} messages keys exact, {eng_launches} "
          f"launches = {eng_chunks} chunks x {MESH_SHARDS}; no plain version "
          "ran")
    arms = {"single": single, "virtual_mesh": vpipe}
    if n_local > 1:
        arms["local_mesh"] = real
    order = [*arms, *reversed(arms)]
    turns = {k: [] for k in arms}
    for k in order:
        turns[k].append(pipeline_rate(arms[k], texts))
    rates = {k: statistics.median(r[0] for r in v) for k, v in turns.items()}
    idle = {k: statistics.median(r[1] for r in v) for k, v in turns.items()}
    print(f"[time] {card}: pipeline rows/s at global batch "
          f"{vpipe.batch_size}, device featurize, in turns: "
          + ", ".join(f"{k} {rates[k]:.0f} (idle {100 * idle[k]:.1f}%)"
                      for k in arms)
          + f" (virtual mesh: {MESH_SHARDS} x {dev})")
    cli = serve_cli(["--device", str(dev), "--model", str(ckpt), "--mesh",
                     "--featurize-device", "--demo", str(SERVE_DEMO),
                     "--batch-size", "1024"], card)
    block = cli["stats"]["health"]["device"]
    if (cli["classified"] != SERVE_DEMO or block["mesh_devices"] != n_local
            or cli["launches"] != block["uploads"]
            or not block["per_chip_rungs"]):
        raise AssertionError(f"serve --mesh: {cli['classified']} classified, "
                             f"{cli['launches']} launches, {block}")
    torch.cuda.synchronize()
    return {"local_devices": n_local, "virtual_shards": MESH_SHARDS,
            "local_launches": real_launches, "local_chunks": real_chunks,
            "local_max_abs_dp": real_dp,
            "max_abs_dp": dp, "launches": launches, "chunks": chunks,
            "engine_launches": eng_launches, "engine_chunks": eng_chunks,
            "engine_msgs_per_s": stats.msgs_per_sec, "rungs": rungs,
            "per_chip_rungs": per_chip, "rows_per_s": rates,
            "device_idle": idle,
            "serve_cli": dict(msgs_per_sec=cli["stats"]["msgs_per_sec"],
                              launches=cli["launches"],
                              mesh_devices=block["mesh_devices"])}


def fit_plan_launches(cfg, trees: int, shards: int) -> tuple:
    """(histogram, best_splits) launches of a DT or boosting fit of
    ``trees`` trees over ``shards`` shards: a histogram a shard and a
    split choice per split level (``max_depth`` levels a tree; the leaves'
    totals are derived, not scanned)."""
    return shards * cfg.max_depth * trees, cfg.max_depth * trees


def mesh_fit(fit, kind: str, cfg, trees: int):
    """One virtual-mesh fit with the tree kernels' launches counted and
    held against the fit plan's, and no plain tree version run; returns
    (model, (histogram, best_splits) launches, wall)."""
    import torch

    from fraud_detection_tpu_torch.ops import histogram as H

    counts, restore = plain_calls(("histogram_reference",
                                   "best_splits_reference"))
    try:
        H.node_feature_bin_histogram_multi.launches = 0
        H.best_splits.launches = 0
        t0 = time.perf_counter()
        model = fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (H.node_feature_bin_histogram_multi.launches,
                    H.best_splits.launches)
        if any(counts.values()):
            raise AssertionError(f"plain tree versions ran on the card: "
                                 f"{counts}")
    finally:
        restore()
    want = fit_plan_launches(cfg, trees, MESH_SHARDS)
    if launches != want:
        raise AssertionError(f"virtual-mesh {kind}: (histogram, best_splits) "
                             f"launches {launches} != plan {want}")
    return model, launches, wall


def mesh_training_phase(dev, Xtr, ytr, out: Path, card: str) -> dict:
    """Phase 7i: the training CLI at its defaults with ``--mesh`` over the
    local devices (dt's metrics equal the recorded run's; lr's confusion
    and accuracy too, AUC within CLI_AUC_TOL; rf's and xgb's printed: a
    mesh forest draws over the padded row count, as the reference's mesh
    path does). Then fits on a virtual mesh of MESH_SHARDS shards on
    cuda:0, each launching the histogram shards x levels x trees times and
    ``best_splits`` levels x trees, no plain version run: dt at the CLI
    shape against the card's single-device fit (equal: the gini histogram
    is exact); xgb on the reference's own mesh-test data
    (``tests/test_trees.py``: 301 x 6, depth 4, 5 rounds) against the
    single-device fit within its 1e-4 in p; xgb at the CLI shape against
    the card's single-device fit within the same 1e-4 and against the same
    mesh fit on the CPU (trees equal, p within 1e-4)."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import train_trees as tt
    from fraud_detection_tpu_torch.models.trees import predict_proba
    from fraud_detection_tpu_torch.parallel import make_mesh
    from fraud_detection_tpu_torch.parallel.mesh import local_devices

    metrics = out / "mesh_metrics.json"
    t0 = time.perf_counter()
    run_train_cli(["--device", str(dev), "--mesh", "--metrics-out",
                   str(metrics)])
    cli_wall = time.perf_counter() - t0
    report = json.loads(metrics.read_text())
    ref = json.loads((ROOT / "reports" / "metrics.json").read_text())
    if report["meta"]["mesh"] != {"data": len(local_devices(
            torch.device(dev).type)), "feature": 1}:
        raise AssertionError(f"train --mesh: mesh {report['meta']['mesh']}")
    if report["metrics"]["dt"] != ref["metrics"]["dt"]:
        raise AssertionError("train --mesh: dt metrics differ from the "
                             "recorded run")
    for split in ("Validation", "Test"):
        got, want = report["metrics"]["lr"][split], ref["metrics"]["lr"][split]
        if (got["confusion"] != want["confusion"]
                or got["accuracy"] != want["accuracy"]
                or abs(got["auc"] - want["auc"]) > CLI_AUC_TOL):
            raise AssertionError(f"train --mesh lr {split}: {got} vs {want}")
    print(f"[mesh-train] train --mesh over {report['meta']['mesh']}: dt "
          "metrics equal the recorded run; lr confusion and accuracy equal, "
          "AUC within 0.01; test accuracy rf "
          f"{report['metrics']['rf']['Test']['accuracy']:.4f} (recorded "
          f"{ref['metrics']['rf']['Test']['accuracy']:.4f}; a mesh forest "
          f"draws over the padded rows), xgb "
          f"{report['metrics']['xgb']['Test']['accuracy']:.4f} (recorded "
          f"{ref['metrics']['xgb']['Test']['accuracy']:.4f}); fit walls "
          f"{report['meta']['train_seconds']} s, CLI {cli_wall:.1f} s ({card})")
    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    launches, walls = {}, {}
    dcfg = tt.TreeTrainConfig(max_depth=DEPTH, n_bins=NBINS)
    t0 = time.perf_counter()
    d1 = tt.fit_decision_tree(Xtr, ytr, config=dcfg, device=dev)
    torch.cuda.synchronize()
    walls["dt_single"] = time.perf_counter() - t0
    d2, launches["dt"], walls["dt_mesh"] = mesh_fit(
        lambda: tt.fit_decision_tree(Xtr, ytr, config=dcfg, mesh=mesh),
        "dt", dcfg, 1)
    if not torch.equal(d1.feature, d2.feature) or not torch.allclose(
            d1.threshold, d2.threshold) or not torch.allclose(
            d1.leaf, d2.leaf, rtol=1e-5):
        raise AssertionError("virtual-mesh dt differs from the card fit")
    # the reference's mesh test data and tolerance
    rng = np.random.default_rng(7)
    Xs = rng.normal(size=(301, 6)).astype(np.float32)
    ys = (Xs[:, 1] - Xs[:, 4] > 0).astype(np.int64)
    scfg = tt.TreeTrainConfig(max_depth=4, criterion="xgb")
    s1 = tt.fit_gradient_boosting(Xs, ys, n_rounds=5, config=scfg, device=dev)
    s2, launches["xgb_ref_data"], _ = mesh_fit(
        lambda: tt.fit_gradient_boosting(Xs, ys, n_rounds=5, config=scfg,
                                         mesh=mesh), "xgb", scfg, 5)
    xs = torch.from_numpy(Xs).to(dev)
    dp_ref = float((predict_proba(s1, xs) - predict_proba(s2, xs)).abs().max())
    if dp_ref > 1e-4:
        raise AssertionError(f"virtual-mesh xgb |dp| {dp_ref} > 1e-4 on the "
                             "reference's mesh-test data")
    xcfg = tt.TreeTrainConfig(max_depth=DEPTH, n_bins=NBINS, criterion="xgb")
    t0 = time.perf_counter()
    g1 = tt.fit_gradient_boosting(Xtr, ytr, n_rounds=MESH_XGB_ROUNDS,
                                  config=xcfg, device=dev)
    torch.cuda.synchronize()
    walls["xgb_single"] = time.perf_counter() - t0
    g2, launches["xgb"], walls["xgb_mesh"] = mesh_fit(
        lambda: tt.fit_gradient_boosting(Xtr, ytr, n_rounds=MESH_XGB_ROUNDS,
                                         config=xcfg, mesh=mesh),
        "xgb", xcfg, MESH_XGB_ROUNDS)
    t0 = time.perf_counter()
    g3 = tt.fit_gradient_boosting(
        Xtr, ytr, n_rounds=MESH_XGB_ROUNDS, config=xcfg,
        mesh=make_mesh(devices=["cpu"] * MESH_SHARDS))
    walls["xgb_mesh_cpu"] = time.perf_counter() - t0
    xc = torch.from_numpy(Xtr)
    dp_cpu = float((predict_proba(g2, xc.to(dev)).cpu()
                    - predict_proba(g3, xc)).abs().max())
    if (not torch.equal(g2.feature.cpu(), g3.feature)
            or not torch.equal(g2.left.cpu(), g3.left) or dp_cpu > 1e-4):
        raise AssertionError(f"virtual-mesh xgb: card and CPU fits differ "
                             f"(|dp| {dp_cpu})")
    dp_single = float((predict_proba(g1, xc.to(dev))
                       - predict_proba(g2, xc.to(dev))).abs().max())
    if dp_single > 1e-4:
        raise AssertionError(f"virtual-mesh xgb{MESH_XGB_ROUNDS} at the CLI "
                             f"shape: |dp| {dp_single} > 1e-4 from the "
                             "single-device card fit")
    first = next((i for i in range(MESH_XGB_ROUNDS) if not torch.equal(
        g1.feature[i], g2.feature[i])), None)
    print(f"[mesh-train] virtual mesh {MESH_SHARDS} x {dev}: dt at the CLI "
          f"shape {Xtr.shape} equal to the card fit (features, thresholds, "
          f"leaves rtol 1e-5); xgb5 on the reference's mesh-test data (301 x "
          f"6) within {dp_ref:.3g} of the card fit (<= 1e-4); "
          f"xgb{MESH_XGB_ROUNDS} at the CLI shape: card == CPU mesh fit "
          f"(trees equal, |dp| {dp_cpu:.3g}), within {dp_single:.3g} of "
          f"the single-device fit (<= 1e-4; first tree apart: {first}); "
          f"(histogram, "
          f"best_splits) launches {launches} = the plan's; no plain version "
          f"ran on the card; walls {walls} s ({card})")
    return {"cli": {"mesh": report["meta"]["mesh"],
                    "train_seconds": report["meta"]["train_seconds"],
                    "wall_s": cli_wall,
                    "test_accuracy": {k: v["Test"]["accuracy"]
                                      for k, v in report["metrics"].items()}},
            "virtual": {"shards": MESH_SHARDS, "xgb_rounds": MESH_XGB_ROUNDS,
                        "launches": launches, "xgb_ref_data_max_abs_dp": dp_ref,
                        "xgb_card_vs_cpu_max_abs_dp": dp_cpu,
                        "xgb_vs_single_max_abs_dp": dp_single,
                        "xgb_first_tree_apart": first, "walls_s": walls}}


_MP_CHILD = r'''
import sys
import torch
from fraud_detection_tpu_torch.parallel.mesh import (
    data_sum, global_batch_from_local, initialize_distributed,
    make_hybrid_mesh)

assert initialize_distributed(backend="nccl", timeout_s=60) is True
rank = torch.distributed.get_rank()
mesh = make_hybrid_mesh(devices=[f"cuda:{rank}"])
x = torch.full((4, 3), float(rank))
g = global_batch_from_local(x, mesh)
total = float(data_sum([s.sum() for s in g.shards], mesh))
rows = g.gather()[:, 0].tolist()
print("RESULT", rank, mesh.shape, total, tuple(g.shape), rows, flush=True)
torch.distributed.destroy_process_group()
'''


def multiprocess_phase(card: str) -> dict:
    """Phase 7j: with two or more cards, a 2-process NCCL rendezvous over
    localhost (one card a process): ``make_hybrid_mesh`` and
    ``global_batch_from_local`` give the 8-row global batch and the
    data-axis sum crosses the processes. With one card there is nothing to
    run it on, and the line says so."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"[multiprocess] not run: {n} card on this machine, and the "
              "NCCL rendezvous needs one card a process (the CPU tests run "
              "the 2-process gloo cases)")
        return {"run": False, "cards": n}
    lines = [[ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
             for out in run_two_ranks(_MP_CHILD, {}, 120)]
    for ln in lines:
        if not ("'data': 2" in ln and " 12.0 " in ln and "(8, 3)" in ln
                and "[0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0]" in ln):
            raise AssertionError(f"NCCL rendezvous: {ln}")
    print(f"[multiprocess] NCCL rendezvous of 2 processes ({card}): {lines}")
    return {"run": True, "cards": n, "lines": lines}


SPARK_MODELS = ("lr", "rf", "xgb")   # phase 7k: the CLI's Spark exports
SPARK_FIXTURE = ROOT / "tests" / "data" / "torch_spark_fixture"
SPARK_WIDE = 262_144                 # Spark HashingTF's default numFeatures
SPARK_TEXTS = 2048                   # phase 7k: texts of each in-process check
SPARK_MONITOR = 500                  # the front end's demo feed (start_monitor)


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def featurize_shape(texts):
    """(width, tokens) that hold every text whole under device featurize:
    the byte width rounded up to 64, the token slots to 16."""
    width = -(-max(len(t.encode()) for t in texts) // 64) * 64
    tokens = -(-max(sum(c.isspace() for c in t) + 1 for t in texts) // 16) * 16
    return width, tokens


def spark_phase(dev, out: Path, card: str, seed: int) -> dict:
    """Phase 7k: Spark artifacts on the card. Phase 7's CLI exported its lr,
    rf100 and xgb100 fits as Spark ``PipelineModel`` directories beside
    their native checkpoints. Each is read with the port's parquet codec
    (read wall, host clock) and written again from the native checkpoint
    (write wall); ``from_spark_artifact`` on the card gives the native
    pipeline's labels on 2,048 texts with |dp| <= 1e-6 (xgb exported as
    GBT: 1e-5, the reference's bound); ``serve --model spark:<dir>`` runs
    with phase 5b's gates on host featurize and ``--featurize-device``
    (launches = chunks; 0 on host), the Spark LR in turns with the native
    LR on host featurize (native, spark, spark, native). Then the committed
    fixture (bytes pyarrow wrote, in Spark's column types): the JAX
    package's recorded labels and |dp| <= 1e-6 on host featurize and under
    device featurize (launches = chunks). A HashingTF(262,144) + IDF + LR
    artifact written by the port serves on host featurize, card against
    CPU (labels equal, |dp| <= 1e-6), and through the serve CLI, whose
    ``--featurize-device`` refuses it with the reference's message. Last,
    the front end: ``build_agent`` over ``FRAUD_MODEL_PATH=spark:<lr dir>``
    with the canned backend on the card and ``start_monitor`` over its 500
    demo messages: every tapped frame's label equals ``pipeline.predict``
    on its text, and the monitor thread stops."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.app.ui import (MonitorState, build_agent,
                                                  start_monitor)
    from fraud_detection_tpu_torch.checkpoint import (load_spark_pipeline,
                                                      save_spark_pipeline)
    from fraud_detection_tpu_torch.checkpoint.native import load_checkpoint
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize.device import (
        DeviceFeaturizeUnavailable)
    from fraud_detection_tpu_torch.featurize.tfidf import (
        HashingTfIdfFeaturizer)
    from fraud_detection_tpu_torch.models.linear import LogisticRegression
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.utils import AppConfig

    t_phase = time.perf_counter()
    texts = [d.text for d in generate_corpus(n=SPARK_TEXTS, seed=seed + 71)]
    spark, res = out / "spark", {"artifacts": {}, "serve": {}}
    native_dirs = {"lr": out / "lr_cli", "rf": out / "rf", "xgb": out / "xgb"}
    for name in SPARK_MODELS:
        t0 = time.perf_counter()
        art = load_spark_pipeline(str(spark / name))
        read_s = time.perf_counter() - t0
        feat, model = load_checkpoint(str(native_dirs[name]), device="cpu")
        t0 = time.perf_counter()
        save_spark_pipeline(str(spark / f"{name}_rewritten"), feat, model)
        write_s = time.perf_counter() - t0
        ours = ServingPipeline.from_spark_artifact(art, batch_size=BATCH,
                                                   device=dev).predict(texts)
        native = ServingPipeline.from_checkpoint(
            str(native_dirs[name]), device=dev, batch_size=BATCH).predict(texts)
        tol = 1e-5 if name == "xgb" else 1e-6
        dp = float(np.abs(ours.probabilities - native.probabilities).max())
        if not np.array_equal(ours.labels, native.labels) or dp > tol:
            raise AssertionError(f"spark {name}: labels differ from the native "
                                 f"checkpoint's or |dp| {dp} > {tol}")
        res["artifacts"][name] = dict(
            bytes=dir_bytes(spark / name), read_s=read_s, write_s=write_s,
            max_abs_dp=dp, positives=int(ours.labels.sum()),
            kind=type(art.stages[-1]).__name__)
        print(f"[spark] {name}: {res['artifacts'][name]['bytes']} bytes on "
              f"disk, parquet read {read_s:.4f} s, write {write_s:.4f} s (host "
              f"clock); served on {dev} == native checkpoint on "
              f"{len(texts)} texts (labels equal, max |dp| {dp:.3g} <= {tol})")
    # the Spark LR in turns with the native LR, host featurize
    turns = []
    for which in ("native", "spark", "spark", "native"):
        spec = (str(native_dirs["lr"]) if which == "native"
                else f"spark:{spark / 'lr'}")
        r = check_serve_runs(spec, SERVE_DEMO, dev, card, {which: []})
        turns.append((which, r[which]["msgs_per_sec"]))
    res["lr_turns"] = turns
    res["serve"].update(check_serve_runs(
        f"spark:{spark / 'lr'}", SERVE_DEMO, dev, card,
        {"spark_lr_featurize_device": ["--featurize-device"]}))
    for name in ("rf", "xgb"):
        res["serve"].update(check_serve_runs(
            f"spark:{spark / name}", SERVE_DEMO, dev, card,
            {f"spark_{name}_host": [],
             f"spark_{name}_featurize_device": ["--featurize-device"]}))
    print(f"[spark] serve --model spark: msgs/s, LR in turns with the native "
          f"LR (host featurize): {turns}; " + ", ".join(
              f"{k} {v['msgs_per_sec']} ({v['featurize_packed_launches']} "
              f"launches / {v['chunks']} chunks)"
              for k, v in res["serve"].items()) + f" ({card})")

    # the committed fixture: bytes pyarrow wrote
    exp = json.loads((SPARK_FIXTURE / "expected.json").read_text())
    ftexts = [d.text for d in generate_corpus(**exp["corpus"])]
    t0 = time.perf_counter()
    art = load_spark_pipeline(str(SPARK_FIXTURE))
    fixture_read_s = time.perf_counter() - t0
    width, tokens = featurize_shape(ftexts)
    fixture = {"read_s": fixture_read_s, "bytes": dir_bytes(SPARK_FIXTURE)}
    for mode, kw in (("host", {}), ("featurize_device", dict(
            featurize_device=True, featurize_width=width,
            featurize_tokens=tokens))):
        pipe = ServingPipeline.from_spark_artifact(art, batch_size=BATCH,
                                                   device=dev, **kw)
        fk.featurize_bytes.launches = 0
        got = pipe.predict(ftexts)
        launches = fk.featurize_bytes.launches
        dp = float(np.abs(got.probabilities
                          - np.asarray(exp["probabilities"])).max())
        if not np.array_equal(got.labels, exp["labels"]) or dp > 1e-6:
            raise AssertionError(f"fixture {mode}: labels differ from the "
                                 f"recorded JAX labels or |dp| {dp} > 1e-6")
        want = pipe.device_stats.chunks if kw else 0
        if launches != want or (kw and (launches < 1 or
                                        pipe.device_stats.truncated_rows)):
            raise AssertionError(f"fixture {mode}: featurize_packed launched "
                                 f"{launches}x over {pipe.device_stats.chunks}"
                                 " chunks")
        fixture[mode] = dict(max_abs_dp=dp, launches=launches,
                             chunks=pipe.device_stats.chunks)
    print(f"[spark] fixture ({fixture['bytes']} bytes, read "
          f"{fixture_read_s:.4f} s): {len(ftexts)} labels equal the recorded "
          f"JAX labels; host featurize max |dp| "
          f"{fixture['host']['max_abs_dp']:.3g}, device featurize (W={width}, "
          f"L={tokens}) {fixture['featurize_device']['max_abs_dp']:.3g} with "
          f"featurize_packed launches {fixture['featurize_device']['launches']}"
          f" = chunks {fixture['featurize_device']['chunks']}")
    res["fixture"] = fixture

    # a wide HashingTF space, written by the port
    rng = np.random.default_rng(seed + 72)
    wfeat = HashingTfIdfFeaturizer(num_features=SPARK_WIDE)
    wfeat.fit_idf(texts)
    wmodel = LogisticRegression.from_arrays(
        rng.normal(0.0, 0.25, SPARK_WIDE), -1.0, device="cpu")
    wdir = spark / "wide"
    t0 = time.perf_counter()
    save_spark_pipeline(str(wdir), wfeat, wmodel)
    wide_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wart = load_spark_pipeline(str(wdir))
    wide_read_s = time.perf_counter() - t0
    on_card = ServingPipeline.from_spark_artifact(wart, batch_size=BATCH,
                                                  device=dev)
    a = on_card.predict(texts)
    b = ServingPipeline.from_spark_artifact(wart, batch_size=BATCH,
                                            device="cpu").predict(texts)
    dp = float(np.abs(a.probabilities - b.probabilities).max())
    if not np.array_equal(a.labels, b.labels) or dp > 1e-6:
        raise AssertionError(f"wide: card and CPU labels differ or |dp| {dp}")
    if on_card.device_stats.snapshot()["uploads_per_chunk"] != 2.0:
        raise AssertionError(f"wide: {on_card.device_stats.snapshot()}")
    res["serve"].update(check_serve_runs(f"spark:{wdir}", SERVE_DEMO, dev,
                                         card, {"spark_wide_host": []}))
    try:
        serve_cli(["--device", str(dev), "--model", f"spark:{wdir}", "--demo",
                   "8", "--featurize-device"], card)
    except DeviceFeaturizeUnavailable as e:
        refusal = str(e)
    else:
        raise AssertionError("--featurize-device served a 262,144-feature space")
    if "exceeds the int16 packed staging layout" not in refusal:
        raise AssertionError(f"wide --featurize-device: {refusal}")
    res["wide"] = dict(bytes=dir_bytes(wdir), read_s=wide_read_s,
                       write_s=wide_write_s, max_abs_dp=dp,
                       positives=int(a.labels.sum()), refusal=refusal)
    print(f"[spark] HashingTF({SPARK_WIDE}) + IDF + LR: "
          f"{res['wide']['bytes']} bytes, write {wide_write_s:.4f} s, read "
          f"{wide_read_s:.4f} s; {len(texts)} labels equal card/CPU (two "
          f"uploads a chunk), max |dp| {dp:.3g}; serve --featurize-device "
          f"refuses: {refusal}")

    # the front end over the Spark LR
    cfg = AppConfig.from_env({"FRAUD_MODEL_PATH": f"spark:{spark / 'lr'}",
                              "FRAUD_BATCH_SIZE": str(BATCH),
                              "FRAUD_MAX_WAIT": "0.01"})
    agent = build_agent(cfg, "Offline (no LLM)", "", 0.0, device=dev)
    state = MonitorState(maxlen=SPARK_MONITOR)
    fk.featurize_bytes.launches = 0
    t0 = time.perf_counter()
    start_monitor(state, agent, cfg, demo=True)
    deadline = time.time() + 120
    while (time.time() < deadline
           and state.engine.stats.processed < SPARK_MONITOR):
        time.sleep(0.05)
    state.engine.stop()
    state.thread.join(timeout=30)
    monitor_s = time.perf_counter() - t0
    frames = state.snapshot(SPARK_MONITOR)
    if state.thread.is_alive() or len(frames) != SPARK_MONITOR:
        raise AssertionError(f"monitor: {len(frames)} frames, thread alive "
                             f"{state.thread.is_alive()}")
    want = agent.pipeline.predict([f["original_text"] for f in frames]).labels
    if [f["prediction"] for f in frames] != want.tolist():
        raise AssertionError("monitor frames' labels != pipeline.predict")
    if (agent.pipeline.device.type != torch.device(dev).type
            or fk.featurize_bytes.launches):
        raise AssertionError(f"front end on {agent.pipeline.device}, "
                             f"{fk.featurize_bytes.launches} featurize "
                             "launches on host featurize")
    res["front_end"] = dict(frames=len(frames), wall_s=monitor_s,
                            featurize_packed_launches=fk.featurize_bytes.launches)
    res["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[spark] front end: build_agent(FRAUD_MODEL_PATH=spark:<lr>, "
          f"canned) on {agent.pipeline.device}, start_monitor over "
          f"{len(frames)} demo messages in {monitor_s:.2f} s: every label "
          "equals pipeline.predict, monitor thread stopped")
    print(f"[spark] phase 7k wall {res['phase_wall_s']:.1f} s ({card})")
    return res


# ---------------------------------------------------------------------------
# the explanation LLM across devices and its fine-tuning
# ---------------------------------------------------------------------------

TP_SHARDS = 4          # phases 12b-12c, 14c: the virtual mesh's devices on cuda:0
TP_GEN_TOKENS = 16     # phase 12b: greedy tokens a prompt, bf16 and int8
# phase 12b: TP and SP last logits against the single-device forward, as
# phase 10 holds flash against the chunked path (bf16 through 18 layers)
TP_LOGIT_FRAC = 0.05
# the per-shard weight shapes of a 4-way Gemma-2B model axis (K, N, kn):
# wq, wo, w_gate / w_up, w_down (wk / wv stay whole: one K/V head)
W8_TP_SHAPES = {"wq/4": (2048, 512), "wo/4": (512, 2048),
                "w_gate,w_up/4": (2048, 4096), "w_down/4": (4096, 2048)}
TRAIN_B, TRAIN_T = 8, 128   # phase 14b: the reference trainer's defaults
TRAIN_TIMED = 3             # phase 14b: timed steps after one warm step
TRAIN_STEPS, TRAIN_CUT = 4, 2   # phase 14b: the resume gate's run and cut
MESH_TRAIN_STEPS = 3        # phase 14c: steps of each mesh fit
# phase 14b's card-vs-CPU fit: Gemma-2B's quirks (MQA, head dim != D/H,
# GeGLU, sqrt(D) embedding scale) at 2 layers and a narrow width, f32: the
# CPU draws the threefry init at ~2.3M weights a second, so a full-width
# twin would take minutes there
TRAIN_TWIN = dict(GEMMA_2B, vocab_size=258, d_model=512, n_heads=8,
                  n_kv_heads=1, head_dim_override=64, d_ff=2048, n_layers=2,
                  embed_scale=math.sqrt(512), max_seq=256)
TRAIN_CPU_RTOL = 1e-4   # card vs CPU f32 losses (the JAX-trajectory test's rtol)
MESH_LOSS_TOL = 3e-4    # mesh fits vs one device (the reference's dp x sp bound)
# phase 12d: the Llama-3-8B architecture (the config.json of
# meta-llama/Meta-Llama-3-8B): GQA with 8 K/V heads, so a 4-way model axis
# splits them, 2 a part beside 8 query heads; random N(0, 0.02) weights
LLAMA3_8B = dict(vocab_size=128_256, d_model=4096, n_layers=32, n_heads=32,
                 n_kv_heads=8, d_ff=14_336, activation="silu",
                 embed_scale=1.0, tie_embeddings=False, rms_eps=1e-5,
                 rope_theta=500_000.0, max_seq=8192)
KV_ROWS, KV_STEPS = 4, 16      # phase 12d: prompts, and tokens of each decode
KV_PREFILL_T = 512             # phase 12d: the cached prefill's length
KV_WIDTH, KV_PAGE = 128, 16    # phase 12d: the slot pools' prompt width, page
KV_PREFIX = "<|system|>\nYou are a fraud analyst.\n"   # 37 tokens: a COW page
# phase 12d's f32 check: the TP cached prefill against one device at
# KV_F32_LAYERS (a depth cut: f32 weights and their TP copy at 32 layers
# would take 64 GB), within KV_F32_FRAC of max |logit|. In bf16 at 32
# layers of these random weights one device's own two exact paths (cached
# and full-sequence forward) part by up to ~7% of max |logit| on an H100,
# so there the TP logits are held within the larger of
# TP_LOGIT_FRAC and twice that spread, and the per-part cache within
# TP_LOGIT_FRAC of the whole-cache TP path
KV_F32_LAYERS, KV_F32_FRAC = 8, 1e-4
# phase 12d's w8_matmul products as (K, N, layout): those of a 4-way model
# axis' part (wq, wk / wv, wo, w_gate / w_up, w_down), those of one device,
# and the untied head (whole on the first device), at the decode step's
# M = 8 and the cached prefill's M = KV_PREFILL_T
W8_LLAMA_SHAPES = {"wq/4": (4096, 1024, "kn"), "wk,wv/4": (4096, 256, "kn"),
                   "wo/4": (1024, 4096, "kn"),
                   "w_gate,w_up/4": (4096, 3584, "kn"),
                   "w_down/4": (3584, 4096, "kn"),
                   "wq,wo": (4096, 4096, "kn"), "wk,wv": (4096, 1024, "kn"),
                   "w_gate,w_up": (4096, 14_336, "kn"),
                   "w_down": (14_336, 4096, "kn"),
                   "head": (4096, 128_256, "nk")}


#: phase 7l: the counts the port's model checker reproduces, as
#: tests/test_torch_model_checker.py pins them (states, transitions)
MODEL_COUNTS = {"default": (58_074, 190_517), "autoscale": (49_212, 174_482)}
LIVENESS_SCCS = 57_504
SAN_ENV = {"asan": {"ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
                    "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1"},
           "tsan": {"TSAN_OPTIONS": "halt_on_error=1"}}
SAN_REPORTS = ("ERROR: AddressSanitizer", "runtime error:",
               "WARNING: ThreadSanitizer", "ERROR: LeakSanitizer")


def host_step(argv, env=None, timeout: float = 300.0) -> dict:
    """One host subprocess: exit code, output and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    return {"rc": proc.returncode, "out": proc.stdout, "err": proc.stderr,
            "s": time.perf_counter() - t0}


def sanitizer_step(variant: str) -> dict:
    """Build one sanitizer variant of the native featurizer with the host's
    g++ and drive san_driver.py under it, the runtime preloaded."""
    from fraud_detection_tpu_torch.featurize import native

    t0 = time.perf_counter()
    runtime = native.sanitizer_runtime(variant)
    if runtime is None:
        return {"runtime": None, "s": time.perf_counter() - t0}
    lib = native.build_variant(variant)
    build_s = time.perf_counter() - t0
    if lib is None:
        return {"runtime": runtime, "lib": None, "s": build_s,
                "err": native.build_error or "build failed"}
    env = dict(os.environ, LD_PRELOAD=runtime,
               FRAUD_TPU_NATIVE_VARIANT=variant, **SAN_ENV[variant])
    run = host_step([sys.executable, str(
        ROOT / "fraud_detection_tpu_torch" / "native" / "san_driver.py"),
        "--variant", variant], env)
    return {**run, "runtime": runtime, "lib": str(lib), "build_s": build_s,
            "s": time.perf_counter() - t0}


def flightcheck_phase(card: str, work: Path) -> dict:
    """Phase 7l: the port's flightcheck on its own tree, the protocol model
    checker (safety, a seeded mutation, liveness) and the sanitizer drives
    of the native featurizer, on the card machine's host."""
    import concurrent.futures as cf

    from fraud_detection_tpu_torch.featurize import native

    work.mkdir(parents=True, exist_ok=True)
    trace = work / "release_before_drain.txt"
    cli = [sys.executable, "-m", "fraud_detection_tpu_torch.analysis"]
    gcc = shutil.which("gcc") or "gcc"
    steps = {
        "flightcheck": (host_step, [*cli, "--json", "--no-cache"]),
        "model_default": (host_step, [*cli, "model", "--json"]),
        "model_autoscale": (host_step, [*cli, "model", "--json",
                                        "--autoscale"]),
        "mutation": (host_step, [*cli, "model", "--json", "--autoscale",
                                 "--mutate", "release_before_drain",
                                 "--trace-file", str(trace)]),
        "liveness": (host_step, [*cli, "model", "--json", "--liveness"]),
        "asan": (sanitizer_step, "asan"),
        "tsan": (sanitizer_step, "tsan"),
    }
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(len(steps)) as pool:
        futures = {name: pool.submit(fn, *args)
                   for name, (fn, *args) in steps.items()}
        runs = {name: f.result() for name, f in futures.items()}
    wall = time.perf_counter() - t0
    failures, out = [], {"wall_s": wall, "gcc": gcc}

    def payload(name):
        run = runs[name]
        try:
            return json.loads(run["out"])
        except ValueError:
            failures.append(f"{name}: rc {run['rc']}, no JSON: "
                            f"{run['err'][-1500:]}")
            return {}

    fc = payload("flightcheck")
    ok = runs["flightcheck"]["rc"] == 0 and fc.get("findings") == []
    print(f"[flightcheck] {'ok' if ok else 'FAIL'}: analysis --json on the "
          f"port's tree: rc {runs['flightcheck']['rc']}, "
          f"{len(fc.get('findings', []))} finding(s), {fc.get('suppressed')} "
          f"suppressed by pragma, {fc.get('files')} files, "
          f"{runs['flightcheck']['s']:.1f} s")
    if not ok:
        failures.append(f"flightcheck: {fc.get('findings')}")
    out["flightcheck"] = {k: fc.get(k) for k in ("findings", "suppressed",
                                                 "files")}
    for config in MODEL_COUNTS:
        name = f"model_{config}"
        m = payload(name)
        got = (m.get("states"), m.get("transitions"))
        ok = (runs[name]["rc"] == 0 and m.get("ok") is True
              and got == MODEL_COUNTS[config])
        print(f"[flightcheck] {'ok' if ok else 'FAIL'}: model --json "
              f"{config}: rc {runs[name]['rc']}, {got[0]} states, {got[1]} "
              f"transitions, depth {m.get('depth')} (pinned "
              f"{MODEL_COUNTS[config]}), {runs[name]['s']:.1f} s")
        if not ok:
            failures.append(f"{name}: {got} rc {runs[name]['rc']}")
        out[name] = {k: m.get(k) for k in ("states", "transitions", "depth",
                                           "elapsed_s")}
    m = payload("mutation")
    text = trace.read_text() if trace.is_file() else ""
    ok = (runs["mutation"]["rc"] == 1
          and m.get("invariant_violated") == "revoke_barrier"
          and "counterexample: invariant `revoke_barrier`" in text)
    print(f"[flightcheck] {'ok' if ok else 'FAIL'}: model --autoscale "
          f"--mutate release_before_drain: rc {runs['mutation']['rc']}, "
          f"violates {m.get('invariant_violated')} in "
          f"{len(m.get('trace', []))} steps, {runs['mutation']['s']:.1f} s")
    if not ok:
        failures.append(f"mutation: rc {runs['mutation']['rc']}, "
                        f"{m.get('invariant_violated')}")
    out["mutation"] = {"invariant": m.get("invariant_violated"),
                       "steps": len(m.get("trace", []))}
    m = payload("liveness")
    ok = (runs["liveness"]["rc"] == 0 and m.get("ok") is True
          and m.get("sccs") == LIVENESS_SCCS)
    print(f"[flightcheck] {'ok' if ok else 'FAIL'}: model --liveness: rc "
          f"{runs['liveness']['rc']}, {m.get('states')} states, "
          f"{m.get('sccs')} SCCs (pinned {LIVENESS_SCCS}), "
          f"{runs['liveness']['s']:.1f} s")
    if not ok:
        failures.append(f"liveness: rc {runs['liveness']['rc']}, "
                        f"{m.get('sccs')} SCCs")
    out["liveness"] = {k: m.get(k) for k in ("states", "sccs", "elapsed_s")}
    for variant in ("asan", "tsan"):
        run = runs[variant]
        if run["runtime"] is None:
            print(f"[flightcheck] {variant}: not run — {gcc} has no "
                  f"{native.SAN_RUNTIMES[variant]} "
                  f"({gcc} -print-file-name), {run['s']:.1f} s")
            out[variant] = {"run": False, "gcc": gcc}
            continue
        if run.get("lib") is None:
            print(f"[flightcheck] FAIL: {variant} build: {run['err'][-1500:]}")
            failures.append(f"{variant}: build failed")
            continue
        report = [r for r in SAN_REPORTS if r in run["out"] + run["err"]]
        ok = (run["rc"] == 0 and "all checks passed" in run["out"]
              and not report)
        print(f"[flightcheck] {'ok' if ok else 'FAIL'}: {variant} san_driver "
              f"(runtime {run['runtime']}): rc {run['rc']}, build "
              f"{run['build_s']:.1f} s, total {run['s']:.1f} s"
              + (f", reports {report}" if report else ""))
        if not ok:
            failures.append(f"{variant}: rc {run['rc']} {report} "
                            f"{(run['out'] + run['err'])[-1500:]}")
        out[variant] = {"run": True, "rc": run["rc"], "s": run["s"],
                        "build_s": run["build_s"]}
    print(f"[flightcheck] phase 7l wall {wall:.1f} s (host; {card})")
    if failures:
        raise AssertionError("phase 7l: " + " | ".join(failures))
    return out


def tp_mesh(axis: str, dev, devices=None):
    """A 1-D mesh named ``axis`` over ``devices``, by default the virtual
    one: TP_SHARDS entries of ``dev``."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.parallel.mesh import Mesh

    if devices is None:
        dev = torch.device(dev)
        one = torch.device("cuda", 0) if dev.type == "cuda" and \
            dev.index is None else dev
        devices = [one] * TP_SHARDS
    return Mesh(np.array(devices, dtype=object), (axis,))


def last_logits_close(label: str, got, want) -> dict:
    """Raise unless ``got`` is finite and within TP_LOGIT_FRAC of max
    |want| everywhere; returns the figures."""
    import torch

    dmax = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (bool(torch.isfinite(got).all()) and dmax <= TP_LOGIT_FRAC * scale):
        raise AssertionError(f"{label}: last logits max |d| {dmax} beyond "
                             f"{TP_LOGIT_FRAC} of max |logit| {scale}")
    return dict(dlogit=dmax, logit_scale=scale,
                argmax_agrees=int(got.argmax()) == int(want.argmax()))


def w8_forward_launches(params) -> int:
    """``w8_matmul`` launches of one forward on int8 ``params``: a launch a
    weight part (every Sharded leaf's part, every whole matrix once) a
    layer, and one for an int8 head."""
    from fraud_detection_tpu_torch.models.llm import Q8, Sharded

    per_layer = 0
    for leaf in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w = getattr(params.layers[0], leaf)
        per_layer += len(w.parts) if isinstance(w, Sharded) else int(
            isinstance(w, Q8))
    head = params.embed if params.cfg.tie_embeddings else params.lm_head
    return per_layer * params.cfg.n_layers + int(isinstance(head, Q8))


def tie_gate(label: str, single, model, prompt, got, want, dev) -> dict:
    """A tensor-parallel greedy row that parts from the single-device row:
    raises unless, at the first step where they part, the single-device
    logits of the two chosen tokens are at most twice the TP-vs-one-device
    logit difference apart (both models' last logits over the prompt and
    the common tokens): a near tie that the partial sums' rounding may
    flip, not a wrong model."""
    import torch

    from fraud_detection_tpu_torch.models.llm import forward

    step = int((got != want).nonzero()[0][0])
    ids = torch.tensor([list(prompt) + list(want[:step])], device=dev)
    with torch.inference_mode():
        ls = forward(single.params, ids, single.cfg,
                     logits_last_only=True)[0][0, 0]
        lt = forward(model.params, ids, model.cfg,
                     logits_last_only=True)[0][0, 0]
    gap = float((ls[int(want[step])] - ls[int(got[step])]).abs())
    dlogit = float((lt - ls).abs().max())
    if not gap <= 2 * dlogit:
        raise AssertionError(f"{label}: parts from one device at step {step} "
                             f"({int(got[step])} vs {int(want[step])}), whose "
                             f"logits are {gap} apart, beyond twice the TP "
                             f"logit difference {dlogit}")
    return dict(step=step, gap=gap, dlogit=dlogit,
                tokens=[int(got[step]), int(want[step])])


def tp_serving(lm, lm8, dev, seed: int, card: str, devices=None) -> dict:
    """Phase 12b: the 18-layer model tensor-parallel over a 4-way virtual
    model axis (quantize then shard at int8). Per-shard w8_matmul shapes
    and flash's head-group shape held against their plain versions; the
    split checked part by part; a T=2048 prefill (bf16, then int8) against
    the single-device model's last logits, with the flash and w8_matmul
    launches reset before and read after each (flash: layers x shards, all
    on sm90; w8_matmul: ``w8_forward_launches``); greedy tokens at bf16 and
    int8 equal the single-device model's, or part from them only at a near
    tie (``tie_gate``); the int8 generation's w8_matmul launches a multiple
    of a forward's; TP prefill time against one device's, in turns.
    ``devices``: the model axis' devices (default the virtual mesh)."""
    import torch

    from fraud_detection_tpu_torch.models.llm import (
        MODEL_AXIS, LanguageModel, Sharded, forward, shard_params)
    from fraud_detection_tpu_torch.ops import attention as A
    from fraud_detection_tpu_torch.ops import int8_matmul as W

    cfg = lm.cfg
    w8_err = {}
    for i, (name, (k, n)) in enumerate(W8_TP_SHAPES.items()):
        q, scale = w8_weight(k, n, "kn", dev, seed + 100 + i)
        for m in (8, 2048):
            g = torch.Generator(device=dev).manual_seed(seed + 110 + m)
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            w8_err[f"{name} M={m}"] = check_w8(f"{name} M={m}", x, q, scale,
                                               "kn")
    print(f"[check] w8_matmul at the 4-way shard shapes {W8_TP_SHAPES}, "
          f"M = 8 and 2048, bf16: kernel vs plain max |diff| "
          f"{max(w8_err.values()):.3g}, launches bit-equal")
    group = (1, 2048, cfg.n_heads // len(devices or [0] * TP_SHARDS),
             cfg.head_dim)
    flash_err = check_flash("TP head group", *flash_inputs(
        group, cfg.kv_heads, torch.bfloat16, dev, seed + 120),
        FLASH_BF16_ATOL, route="sm90")

    mesh = tp_mesh(MODEL_AXIS, dev, devices)
    shards = mesh.shape[MODEL_AXIS]
    t0 = time.perf_counter()
    tp = LanguageModel(cfg, shard_params(lm.params, cfg, mesh),
                       tokenizer=lm.tokenizer)
    tp8 = LanguageModel(cfg, shard_params(lm8.params, cfg, mesh),
                        tokenizer=lm8.tokenizer)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    layout = {}
    for name in ("l0.wq", "l0.wo", "l0.w_gate", "l0.w_down"):
        leaf = tp.params.param(name)
        if not isinstance(leaf, Sharded) or len(leaf.parts) != shards:
            raise AssertionError(f"TP {name}: not split in {shards}")
        layout[name] = [tuple(p.shape) for p in leaf.parts][0]
    if isinstance(tp.params.param("l0.wk"), Sharded):
        raise AssertionError("TP: Gemma-2B's one K/V head must stay whole")
    g = torch.Generator(device=dev).manual_seed(seed + 121)
    toks = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g, device=dev)

    def launches():
        A.flash_attention.launches = 0
        A.flash_attention_sm90.launches = A.flash_attention_simt.launches = 0
        W.w8_matmul.launches = W.w8_matmul.simt_launches = 0

    out = {"shard_s": shard_s, "layout": {k: list(v) for k, v in layout.items()},
           "w8_tp_max_abs_err": max(w8_err.values()),
           "flash_group_max_abs_err": flash_err}
    for label, single, model in (("bf16", lm, tp), ("int8", lm8, tp8)):
        with torch.inference_mode():
            want = forward(single.params, toks, cfg,
                           logits_last_only=True)[0][0, 0]
            launches()
            got = forward(model.params, toks, cfg,
                          logits_last_only=True)[0][0, 0]
            torch.cuda.synchronize()
        counts = dict(flash=A.flash_attention.launches,
                      sm90=A.flash_attention_sm90.launches,
                      w8=W.w8_matmul.launches)
        want_w8 = w8_forward_launches(model.params) if label == "int8" else 0
        want_flash = cfg.n_layers * shards
        if counts != dict(flash=want_flash, sm90=want_flash, w8=want_w8):
            raise AssertionError(f"TP prefill {label}: launches {counts}, want "
                                 f"flash {want_flash} on sm90, w8_matmul "
                                 f"{want_w8}")
        out[f"prefill_{label}"] = dict(
            launches=counts, **last_logits_close(f"TP prefill {label}", got,
                                                 want))
        print(f"[tp] prefill T=2048 {label}, {cfg.n_layers} layers over "
              f"{shards} model shards {sorted({str(d) for d in mesh.devices.flat})}: flash {counts['flash']} launches "
              f"({counts['sm90']} sm90, = layers x shards), w8_matmul "
              f"{counts['w8']} (= {want_w8}); last logits vs one device max "
              f"|d| {out[f'prefill_{label}']['dlogit']:.4g} (max |logit| "
              f"{out[f'prefill_{label}']['logit_scale']:.4g}, gate "
              f"{TP_LOGIT_FRAC}), argmax "
              f"{'agrees' if out[f'prefill_{label}']['argmax_agrees'] else 'differs'}")

    enc = [lm.tokenizer.encode(p) for p in GEN_PROMPTS[:4]]
    for label, single, model in (("bf16", lm, tp), ("int8", lm8, tp8)):
        want = single.generate_tokens_batch(enc, max_new_tokens=TP_GEN_TOKENS)
        launches()
        got = model.generate_tokens_batch(enc, max_new_tokens=TP_GEN_TOKENS)
        w8 = W.w8_matmul.launches
        per = w8_forward_launches(model.params)
        if label == "int8" and (not w8 or w8 % per):
            raise AssertionError(f"TP int8 generation launched w8_matmul {w8}x,"
                                 f" want a positive multiple of {per}")
        equal = [bool((a == b).all()) for a, b in zip(got, want)]
        ties = [dict(tie_gate(f"TP greedy {label} row {r}", single, model,
                              enc[r], got[r], want[r], dev), row=r)
                for r in range(len(enc)) if not equal[r]]
        out[f"generate_{label}"] = dict(rows_equal=sum(equal), rows=len(enc),
                                        w8_launches=w8, near_ties=ties)
        print(f"[tp] greedy generation {label}, {len(enc)} prompts x "
              f"{TP_GEN_TOKENS} tokens: {sum(equal)} of {len(enc)} rows equal "
              f"to one device's" + "".join(
                  f"; row {t['row']} parts at step {t['step']} on a near tie "
                  f"(one device's logits of the two tokens {t['gap']:.4g} "
                  f"apart, TP vs one device max |dlogit| there "
                  f"{t['dlogit']:.4g})" for t in ties)
              + f"; w8_matmul {w8} launches"
              + (f" (= {w8 // per} forwards x {per})" if label == "int8"
                 else ""))

    def run(model):
        return lambda: forward(model.params, toks, cfg, logits_last_only=True)

    with torch.inference_mode():
        turns = [cuda_ms(run(m), 5, 2) for m in (lm, tp, tp, lm)]
    out["prefill_ms"] = dict(single=[turns[0], turns[3]], tp=[turns[1],
                                                               turns[2]])
    print(f"[time] {card}: prefill T=2048 bf16 in turns (one device, TP x"
          f"{shards}, TP, one device): {turns[0]:.2f} / {turns[1]:.2f} / "
          f"{turns[2]:.2f} / {turns[3]:.2f} ms; TP / one device "
          f"{(turns[1] + turns[2]) / (turns[0] + turns[3]):.2f}x "
          + ("(a virtual mesh: the shards run one after another on one card)"
             if devices is None else f"(over {shards} cards)")
          + f"; sharding both models {shard_s:.2f} s")
    del tp, tp8
    torch.cuda.empty_cache()
    return out


def sp_forward(lm, dev, seed: int, card: str, devices=None) -> dict:
    """Phase 12c: ``forward(seq_mesh=)`` on the 18-layer bf16 model over a
    4-way virtual "seq" axis, ring then Ulysses, at T=2048 against the plain
    (flash) forward's last logits; neither runs the flash kernel (reset
    before, read after each); times in turns."""
    import torch

    from fraud_detection_tpu_torch.models.llm import SEQ_AXIS, forward
    from fraud_detection_tpu_torch.ops import attention as A

    cfg = lm.cfg
    mesh = tp_mesh(SEQ_AXIS, dev, devices)
    g = torch.Generator(device=dev).manual_seed(seed + 130)
    toks = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g, device=dev)
    out = {}
    with torch.inference_mode():
        want = forward(lm.params, toks, cfg, logits_last_only=True)[0][0, 0]
        for impl in ("ring", "ulysses"):
            A.flash_attention.launches = 0
            got = forward(lm.params, toks, cfg, seq_mesh=mesh, sp_impl=impl,
                          logits_last_only=True)[0][0, 0]
            torch.cuda.synchronize()
            if A.flash_attention.launches:
                raise AssertionError(f"SP {impl} launched the flash kernel")
            out[impl] = last_logits_close(f"SP {impl}", got, want)

        def run(**kw):
            return lambda: forward(lm.params, toks, cfg,
                                   logits_last_only=True, **kw)

        plain = cuda_ms(run(), 3, 1)
        for impl in ("ring", "ulysses"):
            out[impl]["ms"] = cuda_ms(run(seq_mesh=mesh, sp_impl=impl), 3, 1)
        plain2 = cuda_ms(run(), 3, 0)
    out["plain_ms"] = [plain, plain2]
    for impl in ("ring", "ulysses"):
        r = out[impl]
        print(f"[sp] {impl} forward T=2048 over {mesh.shape[SEQ_AXIS]} seq "
              f"blocks on {sorted({str(d) for d in mesh.devices.flat})} "
              f"({cfg.n_layers} layers, bf16): last logits vs the plain "
              f"forward max |d| {r['dlogit']:.4g} (max |logit| "
              f"{r['logit_scale']:.4g}, gate {TP_LOGIT_FRAC}), argmax "
              f"{'agrees' if r['argmax_agrees'] else 'differs'}, 0 flash "
              f"launches; {r['ms']:.2f} ms against the plain forward's "
              f"{plain:.2f} / {plain2:.2f} ms ({card})")
    return out


def kv_rows(dec, prompts) -> tuple:
    """Each prompt admitted greedily into its own slot of ``dec``, then one
    window of KV_STEPS: (the prompts' tokens, each row's first token
    followed by its window)."""
    import numpy as np

    toks = [dec.encode_prompt(p)[0] for p in prompts]
    firsts = [dec.prefill(s, t, 0.0, s) for s, t in enumerate(toks)]
    n = len(prompts)
    lens = np.asarray([len(t) for t in toks], np.int32)
    for slot in range(n):
        if not dec.grow_for_window(slot, int(lens[slot]), KV_STEPS):
            raise AssertionError("phase 12d: the page pool is too small")
    out = dec.step(np.asarray(firsts, np.int32), lens, np.ones(n, bool),
                   np.full(n, KV_STEPS, np.int32), np.zeros(n, np.float32),
                   0, KV_STEPS)[0]
    return toks, [np.concatenate([[f], o]) for f, o in zip(firsts, out)]


def kv_counts() -> dict:
    from fraud_detection_tpu_torch.ops import attention as A
    from fraud_detection_tpu_torch.ops import int8_matmul as W

    return dict(flash=A.flash_attention.launches, w8=W.w8_matmul.launches)


def kv_reset() -> None:
    from fraud_detection_tpu_torch.ops import attention as A
    from fraud_detection_tpu_torch.ops import int8_matmul as W

    A.flash_attention.launches = 0
    A.flash_attention_sm90.launches = A.flash_attention_simt.launches = 0
    W.w8_matmul.launches = W.w8_matmul.simt_launches = 0


def kv_decode_ms(model, cache, toks, reps: int = 5) -> float:
    """One decode step's CUDA-event time at B = len(toks): ``toks`` prefilled
    into ``cache``, then a one-token forward at the next position
    (rewritten each repeat)."""
    import torch

    from fraud_detection_tpu_torch.models.llm import forward

    B, T = toks.shape
    with torch.inference_mode():
        forward(model.params, toks, model.cfg, kv_cache=cache,
                logits_last_only=True)
        step = toks[:, -1:]
        pos = torch.full((B, 1), T, device=toks.device)
        return cuda_ms(lambda: forward(model.params, step, model.cfg,
                                       positions=pos, kv_cache=cache,
                                       cache_len=T), reps, 2)


def kv_programs(lm) -> dict:
    """Phase 12d's cache programs on ``lm``, KV_ROWS prompts x KV_STEPS
    greedy tokens each: batched generation, a slot window and a paged
    window (the shared prefix: copy-on-write admits); {name: (the prompts'
    tokens, each row's tokens)}."""
    from fraud_detection_tpu_torch.explain.slotserve.decode import (
        PagedSlotDecoder, SlotDecoder)

    enc = [lm.tokenizer.encode(p) for p in GEN_PROMPTS[:KV_ROWS]]
    geo = dict(prompt_width=KV_WIDTH, max_new_tokens=KV_STEPS,
               prompt_bucket=16)
    return {"generate": (enc, list(lm.generate_tokens_batch(
                enc, max_new_tokens=KV_STEPS))),
            "slot window": kv_rows(SlotDecoder(lm, KV_ROWS, **geo),
                                   GEN_PROMPTS[:KV_ROWS]),
            "paged window": kv_rows(PagedSlotDecoder(
                lm, KV_ROWS, page_size=KV_PAGE, prefix_text=KV_PREFIX, **geo),
                [KV_PREFIX + p for p in GEN_PROMPTS[:KV_ROWS]])}


def kv_compare(label: str, single, tp, want: dict, got: dict, dev) -> dict:
    """Each program's rows on ``tp`` against ``single``'s: equal, or
    parting only at a near tie (``tie_gate``)."""
    import numpy as np

    runs = {}
    for name, (prompts, rows) in got.items():
        ref = want[name][1]
        equal = [bool(np.array_equal(a, b)) for a, b in zip(rows, ref)]
        ties = [dict(tie_gate(f"{label} {name} row {r}", single, tp,
                              prompts[r], np.asarray(rows[r]),
                              np.asarray(ref[r]), dev), row=r)
                for r in range(len(rows)) if not equal[r]]
        runs[name] = dict(rows_equal=sum(equal), rows=len(rows),
                          near_ties=ties)
    return runs


@contextlib.contextmanager
def whole_caches():
    """The cache programs with every cache whole on the first device and
    each layer's q/k/v gathered there, the layout before head sharding,
    kept here as phase 12d's baseline (the port refuses a whole cache
    beside split K/V weights): ``init_cache`` and ``init_kv_pages`` with
    their ``params`` not read, and ``_cache_groups`` taking every head's
    q/k/v on the residual's device (``_qkv``)."""
    from fraud_detection_tpu_torch.models import llm

    saved = llm.init_cache, llm.init_kv_pages, llm._cache_groups
    llm.init_cache = lambda cfg, b, s, device, params=None: saved[0](
        cfg, b, s, device)
    llm.init_kv_pages = lambda cfg, n, p, device, params=None: saved[1](
        cfg, n, p, device)
    llm._cache_groups = lambda layer, x, cos, sin, cfg, ck, cv: [
        (*llm._qkv(layer, x, cos, sin, cfg), ck, cv)]
    try:
        yield
    finally:
        llm.init_cache, llm.init_kv_pages, llm._cache_groups = saved


@contextlib.contextmanager
def count_forwards():
    """Yields {"n": the model forwards run inside}, counted at the logits
    head that each forward, slot step and paged step ends with once."""
    from fraud_detection_tpu_torch.models import llm

    head, seen = llm._logits_head, {"n": 0}

    def counted(*args, **kwargs):
        seen["n"] += 1
        return head(*args, **kwargs)

    llm._logits_head = counted
    try:
        yield seen
    finally:
        llm._logits_head = head


def kv_w8_shapes(dev, seed: int, card: str) -> dict:
    """Phase 12d's w8_matmul products (``W8_LLAMA_SHAPES``) against their
    plain versions (``check_w8``) at M = 8 and KV_PREFILL_T, bf16."""
    import torch

    errs = {}
    for i, (name, (k, n, layout)) in enumerate(W8_LLAMA_SHAPES.items()):
        q, scale = w8_weight(k, n, layout, dev, seed + i)
        for m in (8, KV_PREFILL_T):
            g = torch.Generator(device=dev).manual_seed(seed + 50 + m)
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            errs[f"{name} M={m}"] = check_w8(f"12d {name} M={m}", x, q, scale,
                                             layout)
        del q, scale
    torch.cuda.empty_cache()
    print(f"[check] w8_matmul at the Llama-3-8B shapes (4-way parts, one "
          f"device, the untied head) {W8_LLAMA_SHAPES}, M = 8 and "
          f"{KV_PREFILL_T}, bf16: kernel vs plain max |diff| "
          f"{max(errs.values()):.3g} (each within {W8_BF16_STEPS} bf16 steps "
          f"+ {W8_BF16_SUM_TOL:.3g} of sum |x q| scale), launches bit-equal "
          f"({card})")
    return errs


def logits_within(label: str, got, want, tol: float) -> dict:
    """Raise unless ``got`` is finite and within ``tol`` of ``want``."""
    import torch

    dmax = float((got - want).abs().max())
    if not (bool(torch.isfinite(got).all()) and dmax <= tol):
        raise AssertionError(f"{label}: last logits max |d| {dmax} beyond "
                             f"{tol}")
    return dict(dlogit_single=dmax, logit_scale=float(want.abs().max()),
                tol=tol, argmax_agrees=int(got.argmax()) == int(want.argmax()))


def kv_f32(dev, seed: int, devices=None) -> dict:
    """Phase 12d's f32 check: Llama-3-8B width at KV_F32_LAYERS, f32, the
    TP cached prefill on per-part caches against one device's, within
    KV_F32_FRAC of max |logit|, and the three cache programs' tokens
    against one device's (``kv_compare``)."""
    import torch

    from fraud_detection_tpu_torch.models.llm import (
        MODEL_AXIS, LanguageModel, TransformerConfig, forward, init_cache,
        init_params, shard_params)

    cfg = TransformerConfig(**{**LLAMA3_8B, "n_layers": KV_F32_LAYERS,
                               "dtype": torch.float32})
    gen = torch.Generator(device=dev).manual_seed(seed)
    single = init_params(cfg, gen, std=0.02)
    tp = shard_params(single, cfg, tp_mesh(MODEL_AXIS, dev, devices))
    toks = torch.randint(0, cfg.vocab_size, (1, KV_PREFILL_T), generator=gen,
                         device=dev)
    S = KV_PREFILL_T + KV_STEPS
    with torch.inference_mode():
        want = forward(single, toks, cfg, kv_cache=init_cache(cfg, 1, S, dev),
                       logits_last_only=True)[0][0, 0]
        got = forward(tp, toks, cfg, kv_cache=init_cache(cfg, 1, S, dev, tp),
                      logits_last_only=True)[0][0, 0]
    out = logits_within("12d f32 cached prefill against one device", got,
                        want, KV_F32_FRAC * float(want.abs().max()))
    single, tp = LanguageModel(cfg, single), LanguageModel(cfg, tp)
    out["runs"] = kv_compare("12d f32", single, tp, kv_programs(single),
                             kv_programs(tp), dev)
    del single, tp
    torch.cuda.empty_cache()
    return out


def kv_gates(label: str, single, tp, dev, seed: int, card: str) -> dict:
    """Phase 12d for one dtype: the head-sharded caches' layout and bytes;
    a cached prefill's last logits on per-part caches against the whole
    caches' (TP_LOGIT_FRAC) and one device's (the larger of TP_LOGIT_FRAC
    and twice one device's own bf16 spread); the three cache programs
    (``kv_programs``) on the tensor-parallel model against one device's
    (``kv_compare``) and, row for row equal, against the same programs on
    whole caches (``whole_caches``); their launches: flash none, and
    w8_matmul at int8 exactly a forward's (``w8_forward_launches``) times
    the forwards they ran (``count_forwards``), none at bf16; the TP decode
    step with the cache on the first device against per part."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models.llm import (
        MODEL_AXIS, Sharded, forward, init_cache, kv_bytes_by_device, kv_parts)

    cfg = tp.cfg
    wk = tp.params.param("l0.wk")
    n = wk.mesh.shape[MODEL_AXIS]
    S = KV_PREFILL_T + KV_STEPS
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, KV_PREFILL_T), generator=g,
                         device=dev)
    cache = init_cache(cfg, 1, S, dev, tp.params)
    whole = (2 * cfg.n_layers * S * cfg.kv_heads * cfg.head_dim
             * torch.finfo(cfg.dtype).bits // 8)
    parts = [p for a in cache.values() for p in kv_parts(a)]
    if not (all(isinstance(a, Sharded) and len(a.parts) == n
                for a in cache.values())
            and [p.device for p in kv_parts(cache["l0.k"])] == wk.devices
            and all(p.shape[2] == cfg.kv_heads // n for p in parts)
            and {p.numel() * p.element_size() * 2 * cfg.n_layers
                 for p in parts} == {whole // n}):
        raise AssertionError(f"12d {label}: cache parts {[tuple(p.shape) for p in parts[:n]]} "
                             f"on {[str(p.device) for p in parts[:n]]}, not "
                             f"1/{n} of {whole} bytes a part")
    out = dict(part_bytes=whole // n, whole_bytes=whole,
               bytes_by_device=kv_bytes_by_device(cache))
    with torch.inference_mode():
        want = forward(single.params, toks, cfg,
                       kv_cache=init_cache(cfg, 1, S, dev),
                       logits_last_only=True)[0][0, 0]
        spread = float((forward(single.params, toks, cfg, use_flash=False,
                                logits_last_only=True)[0][0, 0]
                        - want).abs().max())
        kv_reset()
        got = forward(tp.params, toks, cfg, kv_cache=cache,
                      logits_last_only=True)[0][0, 0]
        with whole_caches():
            gathered = forward(tp.params, toks, cfg,
                               kv_cache=init_cache(cfg, 1, S, dev),
                               logits_last_only=True)[0][0, 0]
    torch.cuda.synchronize()
    out["prefill"] = dict(last_logits_close(
        f"12d {label} per-part cache against the whole", got, gathered),
        **logits_within(f"12d {label} cached prefill against one device",
                        got, want, max(TP_LOGIT_FRAC * float(
                            want.abs().max()), 2 * spread)),
        own_spread=spread)
    del cache
    want = kv_programs(single)
    kv_reset()
    with count_forwards() as forwards:
        got = kv_programs(tp)
    torch.cuda.synchronize()
    counts = kv_counts()
    per = w8_forward_launches(tp.params)
    want_w8 = per * forwards["n"] if label == "int8" else 0
    if counts["flash"] or counts["w8"] != want_w8:
        raise AssertionError(f"12d {label}: launches {counts}, want flash 0 "
                             f"and w8_matmul {want_w8} ({forwards['n']} TP "
                             f"forwards x {per} at int8, 0 at bf16)")
    counts["forwards"] = forwards["n"]
    with whole_caches():
        gathered = kv_programs(tp)
    runs = kv_compare(f"12d {label}", single, tp, want, got, dev)
    for name, (_, rows) in gathered.items():
        if not all(np.array_equal(a, b) for a, b in zip(got[name][1], rows)):
            raise AssertionError(f"12d {label} {name}: per-part caches' tokens "
                                 "differ from the whole caches'")
    out["launches"] = counts
    out["runs"] = runs
    with torch.inference_mode():
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        batch = torch.randint(0, cfg.vocab_size, (8, KV_PREFILL_T),
                              generator=g, device=dev)
        caches = {kind: init_cache(cfg, 8, S, dev, tp.params
                                   if kind == "per part" else None)
                  for kind in ("first device", "per part")}
        turns = []
        for kind in ("first device", "per part", "per part", "first device"):
            with (whole_caches() if kind == "first device"
                  else contextlib.nullcontext()):
                turns.append((kind, kv_decode_ms(tp, caches[kind], batch)))
        del caches
    out["decode_step_ms"] = {kind: [ms for k, ms in turns if k == kind]
                             for kind in ("first device", "per part")}
    print(f"[kv] {label}: {cfg.n_layers} layers of Llama-3-8B width over "
          f"{n} model shards {sorted({str(d) for d in wk.devices})}: each "
          f"layer's k and v {n} parts of (..., {cfg.kv_heads // n}, "
          f"{cfg.head_dim}), {whole // n} of the cache's {whole} bytes each "
          f"(B=1, S={S}); cached prefill T={KV_PREFILL_T} last logits: per "
          f"part vs the whole cache max |d| {out['prefill']['dlogit']:.4g} "
          f"(gate {TP_LOGIT_FRAC} of max |logit|), vs one device "
          f"{out['prefill']['dlogit_single']:.4g} (max |logit| "
          f"{out['prefill']['logit_scale']:.4g}; gate "
          f"{out['prefill']['tol']:.4g}: one device's own cached vs "
          f"full-sequence spread {out['prefill']['own_spread']:.4g}); "
          + "; ".join(f"{k} {v['rows_equal']} of {v['rows']} rows equal "
                      f"one device's ({len(v['near_ties'])} near ties)"
                      for k, v in runs.items())
          + f", every row equal to the whole caches'; the three programs "
          f"ran {forwards['n']} TP forwards and launched flash "
          f"{counts['flash']}, w8_matmul {counts['w8']}"
          + (f" (= {forwards['n']} x {per})" if label == "int8" else "")
          + f"; decode step B=8 at S={S} in turns (cache on the first device, "
          f"per part, per part, first device): " + " / ".join(
              f"{ms:.2f}" for _, ms in turns) + f" ms ({card})")
    return out


def sharded_caches(dev, seed: int, card: str, devices=None,
                   n_layers: int = LLAMA3_8B["n_layers"]) -> dict:
    """Phase 12d: the Llama-3-8B architecture (bf16, random N(0, 0.02)
    weights from ``seed``, ``n_layers`` deep), split over a 4-way model
    axis (by default the virtual one of cuda:0; ``devices``: real cards)
    at bf16, then quantized and split at int8 (``kv_gates`` for each): the
    KV caches head-sharded, 2 K/V heads a part. First w8_matmul at every
    Llama-3-8B weight shape against its plain version (``kv_w8_shapes``)
    and the f32 check at KV_F32_LAYERS (``kv_f32``)."""
    import torch

    from fraud_detection_tpu_torch.models.llm import (
        MODEL_AXIS, LanguageModel, TransformerConfig, init_params,
        shard_params)

    cfg = TransformerConfig(**{**LLAMA3_8B, "n_layers": n_layers,
                               "dtype": torch.bfloat16})
    t0 = time.perf_counter()
    w8_err = kv_w8_shapes(dev, seed + 3, card)
    f32 = kv_f32(dev, seed + 2, devices)
    print(f"[kv] f32, {KV_F32_LAYERS} layers of Llama-3-8B width over 4 model "
          f"shards: cached prefill T={KV_PREFILL_T} on per-part caches, last "
          f"logits vs one device max |d| {f32['dlogit_single']:.4g} (max "
          f"|logit| {f32['logit_scale']:.4g}, gate {KV_F32_FRAC} of it); "
          + "; ".join(f"{k} {v['rows_equal']} of {v['rows']} rows equal one "
                      f"device's ({len(v['near_ties'])} near ties)"
                      for k, v in f32["runs"].items()) + f" ({card})")
    gen = torch.Generator(device=dev).manual_seed(seed)
    single = LanguageModel(cfg, init_params(cfg, gen, std=0.02))
    mesh = tp_mesh(MODEL_AXIS, dev, devices)
    out = {"layers": n_layers, "shards": mesh.shape[MODEL_AXIS], "f32": f32,
           "w8_max_abs_err": w8_err}
    for label in ("bf16", "int8"):
        if label == "int8":
            single = single.quantized()
        tp = LanguageModel(cfg, shard_params(single.params, cfg, mesh),
                           tokenizer=single.tokenizer)
        out[label] = kv_gates(label, single, tp, dev, seed + 1, card)
        del tp
        torch.cuda.empty_cache()
    del single
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    print(f"[kv] phase 12d: Llama-3-8B width at {n_layers} of 32 layers, "
          f"bf16 and int8, {out['wall_s']:.1f} s ({card})")
    return out


# phase 14d: the fits each two-process layout runs, per cards a process:
# (label, axis names, one process's grid, sp_impl); the first axis spans
# the two processes
FIT_MESHES = {1: (("data", ("data",), (1,), "ring"),
                  ("model", ("model",), (1,), "ring"),
                  ("seq ring", ("seq",), (1,), "ring"),
                  ("seq ulysses", ("seq",), (1,), "ulysses")),
              2: (("data x model", ("data", "model"), (1, 2), "ring"),
                  ("data x seq", ("data", "seq"), (1, 2), "ring"),
                  ("model", ("model",), (2,), "ring"))}
FIT_TIMED = 3    # phase 14d: steps timed after the first

_FIT_CHILD = r'''
import json, os, sys, time
import numpy as np
import torch
import chip_smoke as cs
from fraud_detection_tpu_torch.parallel.mesh import Mesh, initialize_distributed

assert initialize_distributed(timeout_s=120)
rank = torch.distributed.get_rank()
per = int(os.environ["FIT_CARDS"])
devs = cs.fit_devices(os.environ["FIT_DEVICE"], rank * per, per)
res = {}
for label, names, grid, impl in cs.FIT_MESHES[per]:
    mesh = Mesh(np.array(devs, object).reshape(grid), names, process_count=2,
                process_index=rank, group=torch.distributed.group.WORLD)
    res[label] = cs.timed_fit(mesh, devs[0], impl)
if rank == 0:
    with open(os.environ["FIT_OUT"], "w") as fh:
        json.dump(res, fh)
torch.distributed.destroy_process_group()
'''


def run_two_ranks(child: str, env: dict, timeout: float) -> list:
    """Run ``child`` as two ``torch.distributed`` processes (rank r with
    ``LOCAL_RANK`` from ``env``'s ``LOCAL_RANKS``, a rendezvous port on
    localhost), both under one deadline, their output in files so neither
    blocks on a full pipe while the other waits in a collective; kill what
    is left and raise with both ranks' output tails unless both exit 0.
    Returns each rank's output (stdout and stderr)."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    local = env.get("LOCAL_RANKS", "0,1").split(",")
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", child], cwd=ROOT, text=True,
        stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(os.environ, **env, PYTHONPATH=str(ROOT),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=local[r]))
        for r in range(2)]
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline and any(p.poll() is None
                                                  for p in procs):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for fh in logs:
        fh.seek(0)
        texts.append(fh.read())
        fh.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"two ranks exited {[p.returncode for p in procs]}"
                             + "".join(f"\nrank {r}: {t[-3000:]}"
                                       for r, t in enumerate(texts)))
    return texts


def fit_devices(kind: str, first: int, n: int) -> list:
    """Cards ``first`` to ``first + n - 1``, or ``n`` CPU entries (a CPU
    rehearsal of phase 14d under gloo)."""
    import torch

    if kind == "cuda":
        return [torch.device("cuda", first + i) for i in range(n)]
    return [torch.device("cpu")] * n


def timed_fit(mesh, dev, sp_impl: str) -> dict:
    """phase 14c's 2-layer full-width f32 fit on ``mesh`` (or on ``dev``):
    the losses of 1 + FIT_TIMED steps and a step's milliseconds, the median
    of the last FIT_TIMED steps' walls (each step synchronized; the first
    holds NCCL's and the allocator's warm-up)."""
    import torch

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.models import train_llm as TL
    from fraud_detection_tpu_torch.models.llm import TransformerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(**{**GEMMA_2B, "n_layers": 2,
                               "dtype": torch.float32})
    texts = [d.text for d in generate_corpus(n=64, seed=5)]
    cuda = torch.device(dev).type == "cuda"
    walls = []
    step = TL._train_step

    def timed(*args, **kw):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args, **kw)
        if cuda:
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    tcfg = TL.LLMTrainConfig(steps=1 + FIT_TIMED, batch_size=TRAIN_B,
                             seq_len=TRAIN_T, learning_rate=1e-3,
                             warmup_steps=0, seed=3)
    TL._train_step = timed
    try:
        _, losses = TL.fit_language_model(texts, cfg, tcfg, mesh=mesh,
                                          device=dev, sp_impl=sp_impl)
    finally:
        TL._train_step = step
    if cuda:
        torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=statistics.median(walls[1:]),
                step_walls_ms=walls)


def two_process_fit_ranks(per: int, device_type: str = "cuda") -> dict:
    """Phase 14d's fits of FIT_MESHES[per] by two NCCL processes of ``per``
    cards each (``_FIT_CHILD``; ``device_type="cpu"`` rehearses them under
    gloo): {label: the first rank's ``timed_fit``}."""
    import os

    fd, path = tempfile.mkstemp(prefix="chip_smoke_fits_", suffix=".json")
    os.close(fd)
    try:
        run_two_ranks(_FIT_CHILD, dict(FIT_CARDS=str(per), FIT_OUT=path,
                                       FIT_DEVICE=device_type,
                                       LOCAL_RANKS=f"0,{per}"), 600)
        with open(path) as fh:
            return json.load(fh)
    finally:
        os.unlink(path)


def two_process_fits(per: int, card: str, device_type: str = "cuda",
                     ranks=None) -> dict:
    """Phase 14d over ``2 per`` cards: the two processes' fits
    (``two_process_fit_ranks``, or ``ranks`` when they already ran) against
    this process's fits on meshes of the same cards: losses within
    MESH_LOSS_TOL, each one's step time beside the other's."""
    import numpy as np

    from fraud_detection_tpu_torch.parallel.mesh import Mesh

    if ranks is None:
        ranks = two_process_fit_ranks(per, device_type)
    devs = fit_devices(device_type, 0, 2 * per)
    out = {}
    for label, names, grid, impl in FIT_MESHES[per]:
        full = (2 * grid[0],) + tuple(grid[1:])
        one = timed_fit(Mesh(np.array(devs, object).reshape(full), names),
                        devs[0], impl)
        two = ranks[label]
        if not all(abs(a - b) <= MESH_LOSS_TOL * (1 + abs(b))
                   for a, b in zip(two["losses"], one["losses"])):
            raise AssertionError(f"two-process fit {label}: losses "
                                 f"{two['losses']} vs one process "
                                 f"{one['losses']}")
        out[label] = dict(two_process=two, one_process=one)
        print(f"[train-llm] 2 NCCL processes x {per} card(s), {label} "
              f"{dict(zip(names, full))}"
              + (f" ({impl})" if "seq" in names else "")
              + f", 2 layers, full width, f32: losses "
              f"{[round(x, 5) for x in two['losses']]} vs one process on the "
              f"same cards {[round(x, 5) for x in one['losses']]} (gate "
              f"{MESH_LOSS_TOL}); step {two['step_ms']:.1f} ms vs "
              f"{one['step_ms']:.1f} ms ({card})")
    return out


def two_process_fits_phase(card: str) -> dict:
    """Phase 14d: with two cards or more, ``two_process_fits`` at one card a
    process; with one card there is no second card for NCCL's second rank,
    and the line says so (``scripts/llm_mesh_phases.py`` runs both
    layouts, and the CPU tests the gloo ones)."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"[train-llm] phase 14d not run: {n} card on this machine, and "
              "NCCL takes one card a process (scripts/llm_mesh_phases.py runs "
              "the two-process fits on 2 and 4 cards, "
              "tests/test_torch_llm_multiprocess.py the gloo ones)")
        return {"run": False, "cards": n}
    return {"run": True, "cards": n, "fits": two_process_fits(1, card)}


# ---------------------------------------------------------------------------
# phase 14e: the example twins (examples/torch_*.py)
# ---------------------------------------------------------------------------

# (key, module, arguments): each twin at its JAX example's own sizes
EXAMPLE_RUNS = (("serve", "torch_serve_quickstart", []),
                ("streaming", "torch_streaming_demo", []),
                ("train", "torch_train_quickstart", []),
                ("convert", "torch_convert_hf_checkpoint", []),
                ("convert_int8", "torch_convert_hf_checkpoint", ["--int8"]),
                ("hot_swap", "torch_hot_swap_demo", []),
                ("drift_loop", "torch_drift_loop_demo", []),
                ("game_day", "torch_game_day_demo", []))
# demo-LR probabilities of two separately trained fits (the port's
# tests/test_torch_serve_cli.py bound, for the quickstart's two dialogues,
# whose p saturate); xgb p card against CPU (phase 6's)
SYNTHETIC_P_TOL, TWIN_XGB_P_TOL = 1e-3, 1e-4
# the streaming demo's 500 dialogues, p(scam) card against host: the demo
# LR, trained on each device, stops short of convergence at 50 L-BFGS
# iterations, where the two devices' reduction orders part the iterates;
# an H100 80GB HBM3 (700 W) against its 8-core host parted by 0.0161 at most
STREAM_P_TOL = 0.05


def twin_values(key: str, out: dict) -> dict:
    """The values of a twin's run (``run``'s dict) that a run on another
    device must give too, as JSON."""
    def keyed(d):
        return {k.decode(): v for k, v in d.items()}

    if key == "serve":
        return {"scored": out["scored"]}
    if key == "streaming":
        return {"processed": out["processed"], "malformed": out["malformed"],
                "labels": keyed(out["labels"]),
                "confidences": keyed(out["confidences"]),
                "annotated": [k.decode() for k in out["annotated"]]}
    if key == "train":
        return {"preds": out["preds"].tolist(),
                "scores": out["scores"].tolist(), "metrics": out["metrics"],
                "reloaded_equal": bool(out["reloaded_equal"])}
    if key.startswith("convert"):
        return {"reply": out["reply"]}
    if key == "hot_swap":
        return {k: out[k] for k in ("active_version", "swaps", "delivered",
                                    "unique_keys", "fed", "audit_events")}
    ev = out["result"].evidence
    return {"counts": {k: ev.get(k) for k in ("planned", "out_rows",
                                              "dlq_rows", "deaths", "swaps")},
            "verdicts": {v.name: v.ok for v in out["result"].report.verdicts}}


def run_twin(module: str, argv) -> tuple:
    """One twin's ``run(argv)`` with its output captured: (its dict, its
    output, wall s)."""
    import importlib
    import io

    twin = importlib.import_module(f"examples.{module}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = twin.run(argv)
    return out, buf.getvalue(), time.perf_counter() - t0


def convert_tie(int8: bool, card_reply: str, cpu_reply: str) -> dict:
    """Where the card's and the host's greedy replies of the HF checkpoint
    twin part: the host model's last logits there (the port's forward on the
    CPU over the prompt and the common prefix) for the two tokens. The
    synthetic checkpoint's bf16 logits tie often; a parting is a tie when
    the two sit within one bf16 step of the top logit."""
    import importlib

    import numpy as np
    import torch

    from fraud_detection_tpu_torch.checkpoint.hf_convert import (
        load_hf_checkpoint)
    from fraud_detection_tpu_torch.explain.backends import frame_prompt
    from fraud_detection_tpu_torch.explain.onpod import flatten_chat
    from fraud_detection_tpu_torch.models import llm as L

    if card_reply == cpu_reply:
        return {"equal": True}
    i = next((j for j, (a, b) in enumerate(zip(card_reply, cpu_reply))
              if a != b), min(len(card_reply), len(cpu_reply)))
    tc = importlib.import_module("examples.torch_convert_hf_checkpoint")
    with tempfile.TemporaryDirectory() as d:
        tc.make_synthetic_checkpoint(d)
        lm = load_hf_checkpoint(d, max_seq=128, tokenizer="byte", int8=int8,
                                device="cpu")
    prompt = lm.tokenizer.encode(flatten_chat(frame_prompt(
        "Classify this call: 'you won a prize, read me your SSN'.")))
    seq = np.concatenate([prompt, np.frombuffer(
        cpu_reply[:i].encode("latin-1"), np.uint8).astype(np.int32)])
    with torch.no_grad():
        logits, _ = L.forward(lm.params, torch.from_numpy(seq[None].astype(
            np.int64)), lm.cfg)
    last = logits[0, -1].double().numpy()
    toks = [ord(r[i]) if i < len(r) else lm.cfg.EOS
            for r in (card_reply, cpu_reply)]
    top = float(last.max())
    step = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0
    gap = top - min(last[toks[0]], last[toks[1]])
    if gap > step:
        raise AssertionError(
            f"HF checkpoint twin (int8={int8}): the card's and the host's "
            f"replies part at character {i} ({toks}), {gap:.3g} below the "
            f"top logit, more than one bf16 step ({step:.3g})")
    return {"equal": False, "parts_at": i, "tokens": toks, "gap": gap,
            "bf16_step": step}


def examples_phase(card: str) -> dict:
    """Phase 14e: the seven example twins on the card at their JAX examples'
    sizes, in this process, launch counts reset before each and read after;
    against the host's runs of the same twins, made after them in this
    process (no host-timed phase runs beside them). Gates:
    every exit code 0, card and host; featurize_packed and flash 0 a twin;
    the train twin's histogram and best_splits launches each levels x
    rounds; w8_matmul only under ``--int8``, a multiple of an int8 forward's
    launches; the drift day's tree kernels once a split level each; the
    values each twin gives (labels, metrics, counts) equal the host's:
    equal, or within the stated bound, or (the HF checkpoint's replies) a
    bf16 tie where they part; the hot swap delivers every message once on
    each device, and its decision (timing-dependent: the shadow scorer's
    sample) is printed, not compared."""
    import numpy as np

    from fraud_detection_tpu_torch.models.train_trees import TreeTrainConfig
    from fraud_detection_tpu_torch.ops import attention as A
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.ops import histogram as H
    from fraud_detection_tpu_torch.ops import int8_matmul as W

    t_phase = time.perf_counter()
    card_runs = {}
    for key, module, argv in EXAMPLE_RUNS:
        fk.featurize_bytes.launches = fk.tokenize_hash.launches = 0
        H.node_feature_bin_histogram_multi.launches = 0
        H.best_splits.launches = 0
        A.flash_attention.launches = 0
        W.w8_matmul.launches = W.w8_matmul.simt_launches = 0
        out, text, wall = run_twin(module, argv)
        launches = {"featurize_packed": fk.featurize_bytes.launches,
                    "histogram": H.node_feature_bin_histogram_multi.launches,
                    "best_splits": H.best_splits.launches,
                    "flash_attention": A.flash_attention.launches,
                    "w8_matmul": W.w8_matmul.launches,
                    "w8_matmul_simt": W.w8_matmul.simt_launches}
        tail = " | ".join(line.strip() for line in text.strip().splitlines()[-2:])
        print(f"[examples] {key} ({module}.py {' '.join(argv)}) on the card: "
              f"exit {out['exit_code']}, wall {wall:.2f} s ({card}); launches "
              f"{launches}; last lines: {tail[:240]}")
        if out["exit_code"] != 0:
            raise AssertionError(f"example twin {key} exited "
                                 f"{out['exit_code']} on the card:\n{text}")
        if launches["featurize_packed"] or launches["flash_attention"]:
            raise AssertionError(f"example twin {key} launched featurize_packed "
                                 f"or flash: {launches}")
        if key == "train":
            want = TreeTrainConfig().max_depth * out["model"].num_trees
            if launches["histogram"] != want or launches["best_splits"] != want:
                raise AssertionError(
                    f"train twin: histogram {launches['histogram']}, "
                    f"best_splits {launches['best_splits']} launches, want "
                    f"levels x rounds = {want} each")
        elif key == "drift_loop":
            if not launches["histogram"] or (launches["histogram"]
                                             != launches["best_splits"]):
                raise AssertionError(f"drift twin's tree kernels: {launches}")
        elif launches["histogram"] or launches["best_splits"]:
            raise AssertionError(f"{key} launched the tree kernels: {launches}")
        if key == "convert_int8":
            per_forward = 7 * 2 + 1     # the synthetic checkpoint's 2 layers
            if (not launches["w8_matmul"] or launches["w8_matmul_simt"]
                    or launches["w8_matmul"] % per_forward):
                raise AssertionError(f"--int8 twin: w8_matmul {launches}, want "
                                     f"a positive multiple of {per_forward}")
        elif launches["w8_matmul"] or launches["w8_matmul_simt"]:
            raise AssertionError(f"{key} launched w8_matmul: {launches}")
        card_runs[key] = {"exit_code": out["exit_code"], "wall_s": wall,
                          "launches": launches,
                          "values": twin_values(key, out)}
    card_wall = time.perf_counter() - t_phase

    t_host = time.perf_counter()
    host = {}
    for key, module, argv in EXAMPLE_RUNS:
        got, _, wall = run_twin(module, argv + ["--device", "cpu"])
        host[key] = {"exit_code": got["exit_code"], "wall_s": wall,
                     "values": twin_values(key, got)}
    host_wall = time.perf_counter() - t_host
    compared = {}
    for key, run in card_runs.items():
        got, want = run["values"], host[key]["values"]
        if host[key]["exit_code"] != 0:
            raise AssertionError(f"example twin {key} exited "
                                 f"{host[key]['exit_code']} on the host")
        if key == "serve":
            for name, (label, p) in got["scored"].items():
                hl, hp = want["scored"][name]
                if label != hl or abs(p - hp) > SYNTHETIC_P_TOL:
                    raise AssertionError(f"serve twin {name}: card {label}, "
                                         f"{p}; host {hl}, {hp}")
            note = "labels equal, p within 1e-3"
        elif key == "streaming":
            if (got["processed"], got["malformed"]) != (want["processed"],
                                                        want["malformed"]):
                raise AssertionError(f"streaming twin counts: {got} vs host")
            # p(scam) from each frame's label and confidence (malformed
            # frames carry neither); a label may part only where the host's
            # p lies within STREAM_P_TOL of the threshold
            def p_scam(v, k):
                label, conf = v["labels"][k], v["confidences"][k]
                return None if label is None else (conf if label else 1 - conf)

            dps, near = [], []
            for k, label in got["labels"].items():
                pc, ph = p_scam(got, k), p_scam(want, k)
                if (pc is None) != (ph is None):
                    raise AssertionError(f"streaming twin {k}: card {pc}, "
                                         f"host {ph}")
                if pc is None:
                    continue
                dps.append(abs(pc - ph))
                if label != want["labels"][k]:
                    near.append((k, pc, ph))
            dp = max(dps)
            if dp > STREAM_P_TOL or any(abs(ph - 0.5) > STREAM_P_TOL
                                        for _, _, ph in near):
                raise AssertionError(f"streaming twin: max |dp| {dp:.6f} "
                                     f"(limit {STREAM_P_TOL}); labels apart "
                                     f"{near[:5]}")
            run["max_abs_dp"] = dp
            note = (f"counts equal, {len(dps)} p(scam) within "
                    f"{STREAM_P_TOL}: max |dp| {dp:.6f}, labels equal but "
                    f"for {len(near)} row(s) near the threshold")
        elif key == "train":
            dp = float(np.abs(np.asarray(got["scores"])
                              - np.asarray(want["scores"])).max())
            if (got["preds"] != want["preds"] or dp > TWIN_XGB_P_TOL
                    or got["metrics"] != want["metrics"]
                    or not got["reloaded_equal"]):
                raise AssertionError(f"train twin: metrics {got['metrics']} vs "
                                     f"host {want['metrics']}, max |dp| {dp}")
            note = f"predictions and metrics equal, max |dp| {dp:.3g}"
        elif key.startswith("convert"):
            tie = convert_tie(key.endswith("int8"), got["reply"],
                              want["reply"])
            run["tie"] = tie
            note = ("replies equal" if tie["equal"] else
                    f"replies part at character {tie['parts_at']} at a bf16 "
                    f"tie (gap {tie['gap']:.3g}, step {tie['bf16_step']:.3g})")
        elif key == "hot_swap":
            for side, v in (("card", got), ("host", want)):
                promoted = v["audit_events"][3:] == ["promote"]
                if (not v["delivered"] == v["unique_keys"] == v["fed"]
                        or v["audit_events"][:3] != ["publish", "publish",
                                                     "stage"]
                        or (v["active_version"], v["swaps"])
                        != ((2, 1) if promoted else (1, 0))):
                    raise AssertionError(f"hot swap twin on the {side}: {v}")
            note = (f"every message once on both; decision card "
                    f"{got['audit_events'][3:]}, host {want['audit_events'][3:]}")
        else:
            if got["counts"] != want["counts"]:
                raise AssertionError(f"{key} twin counts {got['counts']} vs "
                                     f"host {want['counts']}")
            note = f"counts {got['counts']} equal, every gate passed"
        compared[key] = note
        print(f"[examples] {key}: card against host: {note}; host wall "
              f"{host[key]['wall_s']:.2f} s")
    wall = time.perf_counter() - t_phase
    print(f"[examples] phase 14e wall {wall:.1f} s: the seven twins on the "
          f"card {card_wall:.1f} s, on the host {host_wall:.1f} s ({card})")
    return {"card": card_runs, "host": {k: {"exit_code": v["exit_code"],
                                            "wall_s": v["wall_s"]}
                                        for k, v in host.items()},
            "compared": compared, "card_wall_s": card_wall,
            "host_wall_s": host_wall, "wall_s": wall}


def llm_train_phase(card: str) -> dict:
    """Phases 14b-14c in a process of their own (``llm_train_child``), with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before it starts CUDA and
    ``torch.use_deterministic_algorithms(True)`` on, so a nondeterministic
    op in the trainer raises and names itself; its result comes back in a
    file. Under its own time limit; it is killed at the end either way."""
    import os

    import torch

    torch.cuda.empty_cache()
    fd, path = tempfile.mkstemp(prefix="chip_smoke_train_", suffix=".json")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.llm_train_child(sys.argv[1]))", path],
            cwd=ROOT, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT),
                     CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        if proc.returncode != 0:
            raise AssertionError(f"the LLM trainer's phases exited "
                                 f"{proc.returncode}")
        with open(path) as fh:
            out = json.load(fh)
    finally:
        os.unlink(path)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[train-llm] phases 14b-14c wall {out['wall_s']:.1f} s ({card})")
    return out


def mesh_fits(texts, dev, devices, card: str) -> dict:
    """Phase 14c: 2-layer full-width f32 fits of MESH_TRAIN_STEPS steps on
    (data 2, model 2) and (data 2, seq 2) meshes over ``devices`` (four,
    row-major) against the one-device fit on ``dev``: losses within
    MESH_LOSS_TOL."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import train_llm as TL
    from fraud_detection_tpu_torch.models.llm import (
        DATA_AXIS, MODEL_AXIS, SEQ_AXIS, TransformerConfig)
    from fraud_detection_tpu_torch.parallel.mesh import Mesh

    cfg32 = TransformerConfig(**{**GEMMA_2B, "n_layers": 2,
                                 "dtype": torch.float32})
    mcfg = TL.LLMTrainConfig(steps=MESH_TRAIN_STEPS, batch_size=TRAIN_B,
                             seq_len=TRAIN_T, learning_rate=1e-3,
                             warmup_steps=0, seed=3)
    grid = np.array(devices, dtype=object).reshape(2, 2)
    fits = {}
    for label, mesh in (("one device", None),
                        ("data x model", Mesh(grid, (DATA_AXIS, MODEL_AXIS))),
                        ("data x seq", Mesh(grid, (DATA_AXIS, SEQ_AXIS)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, fl = TL.fit_language_model(texts, cfg32, mcfg, mesh=mesh,
                                      device=dev)
        fits[label] = dict(losses=fl, wall_s=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    base = fits["one device"]["losses"]
    for label in ("data x model", "data x seq"):
        fl = fits[label]["losses"]
        fits[label]["max_abs_diff"] = max(abs(a - b) for a, b in zip(fl, base))
        if not all(abs(a - b) <= MESH_LOSS_TOL * (1 + abs(b))
                   for a, b in zip(fl, base)):
            raise AssertionError(f"mesh fit {label} losses {fl} vs one "
                                 f"device {base}")
    where = sorted({str(d) for d in devices})
    print(f"[train-llm] mesh fine-tuning, 2 layers, full width, f32, "
          f"{MESH_TRAIN_STEPS} steps on 2 x 2 meshes over {where}: "
          + "; ".join(f"{k} losses {[round(x, 5) for x in v['losses']]}"
                      + (f" (max |d| vs one device {v['max_abs_diff']:.3g})"
                         if "max_abs_diff" in v else "")
                      + f", {v['wall_s']:.1f} s" for k, v in fits.items())
          + f"; gate {MESH_LOSS_TOL} ({card})")
    return fits

def llm_train_child(result_path: str, device: str = "cuda") -> int:
    """The body of phases 14b-14c (see ``llm_train_phase``).

    14b: ``models/train_llm.py`` at full Gemma-2B width, bf16, B=8, T=128:
    the 18-layer model's step time, tokens/s and peak memory over
    TRAIN_TIMED steps after a warm one, losses finite and the last below the
    first; at 2 layers, ``fit_language_model`` interrupted after TRAIN_CUT of
    TRAIN_STEPS steps and resumed equals the uninterrupted fit array for
    array, params and optimizer state (the two snapshots); a 2-layer f32
    fit of TRAIN_TWIN on the card against the same fit on the CPU (losses
    within TRAIN_CPU_RTOL).
    14c: 2-layer full-width f32 fits on the virtual (data 2, model 2) and
    (data 2, seq 2) meshes of cuda:0 against the one-device fit (losses
    within MESH_LOSS_TOL)."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.models import train_llm as TL
    from fraud_detection_tpu_torch.models.llm import (DATA_AXIS,
                                                      TransformerConfig)

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    card = card_line()
    texts = [d.text for d in generate_corpus(n=64, seed=5)]
    out = {}

    # -- 14b. full width, 18 layers: the step's time and memory --------------
    cfg = TransformerConfig(**{**GEMMA_2B, "dtype": torch.bfloat16})
    tcfg = TL.LLMTrainConfig(steps=1 + TRAIN_TIMED, batch_size=TRAIN_B,
                             seq_len=TRAIN_T, warmup_steps=0, seed=0)
    stream = TL.pack_corpus(texts, cfg)
    rows = TL._rows(None, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    master = TL._init_master(cfg, tcfg, None, rows)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt = TL.make_optimizer(tcfg)
    state = opt.init({k: TL._parts(v) for k, v in master.items()})
    losses, times = [], []
    for step in range(tcfg.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = TL._train_step(master, state,
                                     TL.batch_for_step(stream, step, tcfg),
                                     cfg, tcfg, opt, rows)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for v in master.values() for p in TL._parts(v))
    box = {"state": state, "step": tcfg.steps}

    def one_step():
        box["state"], _ = TL._train_step(
            master, box["state"], TL.batch_for_step(stream, box["step"], tcfg),
            cfg, tcfg, opt, rows)
        box["step"] += 1

    breakdown = device_breakdown(one_step, reps=1, tries=2)
    del master, state, box
    torch.cuda.empty_cache()
    step_s = statistics.median(times[1:])
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"full-width fine-tune losses {losses}")
    busy_ms = sum(us for _, us, _ in breakdown) / 1e3
    out["timed"] = dict(step_s=step_s, step_times_s=times, losses=losses,
                        tokens_per_s=TRAIN_B * TRAIN_T / step_s,
                        peak_bytes=peak, params=n_params, init_s=init_s,
                        flop_per_step=6 * n_params * TRAIN_B * TRAIN_T,
                        busy_ms=busy_ms, top_kernels=breakdown[:12])
    print(f"[train-llm] {card}: Gemma-2B width, {cfg.n_layers} layers, bf16, "
          f"{n_params / 1e9:.3f}e9 params, B={TRAIN_B} T={TRAIN_T}: step "
          f"{step_s * 1e3:.1f} ms (median of {TRAIN_TIMED} after a warm step; "
          f"all {[round(t * 1e3, 1) for t in times]} ms), "
          f"{TRAIN_B * TRAIN_T / step_s:.0f} tokens/s, peak memory "
          f"{peak / 1e9:.2f} GB, init draw {init_s:.2f} s; losses "
          f"{[round(x, 4) for x in losses]} (finite, last below first)")
    print(f"[trace] {card}: a full-width step's device busy {busy_ms:.1f} ms "
          f"against {step_s * 1e3:.1f} ms of wall; by kernel:")
    for name, us, n in breakdown[:12]:
        print(f"[trace]   {us:10.1f} us  x{n:.0f}  {name[:90]}")

    # -- 14b. resume at 2 layers: equal to the uninterrupted fit -------------
    cfg2 = TransformerConfig(**{**GEMMA_2B, "n_layers": 2,
                                "dtype": torch.bfloat16})
    rcfg = TL.LLMTrainConfig(steps=TRAIN_STEPS, batch_size=TRAIN_B,
                             seq_len=TRAIN_T, learning_rate=1e-3,
                             warmup_steps=0, decay_steps=TRAIN_STEPS, seed=1)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ft_"))
    try:
        t0 = time.perf_counter()
        full, full_losses = TL.fit_language_model(
            texts, cfg2, rcfg, checkpoint_dir=str(work / "full"),
            checkpoint_every=TRAIN_STEPS, device=dev)
        TL.fit_language_model(
            texts, cfg2, dataclasses.replace(rcfg, steps=TRAIN_CUT),
            checkpoint_dir=str(work / "cut"), checkpoint_every=TRAIN_CUT,
            device=dev)
        resumed, tail = TL.fit_language_model(
            texts, cfg2, rcfg, checkpoint_dir=str(work / "cut"),
            checkpoint_every=TRAIN_CUT, device=dev)
        resume_s = time.perf_counter() - t0
        if len(tail) != TRAIN_STEPS - TRAIN_CUT or \
                tail != full_losses[TRAIN_CUT:]:
            raise AssertionError(f"resumed losses {tail} != the "
                                 f"uninterrupted run's {full_losses}")
        for name in full.params.param_names():
            if not torch.equal(full.params.param(name),
                               resumed.params.param(name)):
                raise AssertionError(f"resume: {name} differs")
        del full, resumed
        with np.load(work / "full" / "arrays.npz") as a, \
                np.load(work / "cut" / "arrays.npz") as b:
            if sorted(a.files) != sorted(b.files):
                raise AssertionError("resume: snapshot names differ")
            for k in a.files:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"resume: snapshot {k} differs")
            n_arrays = len(a.files)
        snap_bytes = sum(f.stat().st_size for f in (work / "full").iterdir())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["resume"] = dict(losses=full_losses, arrays=n_arrays,
                         snapshot_bytes=snap_bytes, wall_s=resume_s)
    print(f"[train-llm] resume at 2 layers, full width, bf16: cut at "
          f"{TRAIN_CUT} of {TRAIN_STEPS} steps and resumed: params and "
          f"optimizer state equal the uninterrupted fit's, {n_arrays} arrays "
          f"of a {snap_bytes / 1e9:.2f} GB snapshot; losses "
          f"{[round(x, 4) for x in full_losses]}; three fits {resume_s:.1f} s "
          "(deterministic algorithms on)")

    # -- 14b. card against CPU, f32 ------------------------------------------
    twin = TransformerConfig(**TRAIN_TWIN)
    tw = TL.LLMTrainConfig(steps=TRAIN_STEPS, batch_size=TRAIN_B,
                           seq_len=TRAIN_T, learning_rate=1e-3,
                           warmup_steps=1, seed=2)
    walls = {}
    got = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        got[side] = TL.fit_language_model(texts, twin, tw, device=d)[1]
        walls[side] = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["card"], got["cpu"]))
    if not rel <= TRAIN_CPU_RTOL:
        raise AssertionError(f"f32 fit card vs CPU losses {got}")
    out["card_vs_cpu"] = dict(losses=got, max_rel=rel, walls_s=walls)
    print(f"[train-llm] f32 fit (Gemma quirks, D {twin.d_model}, 2 layers) "
          f"card vs CPU: losses max relative diff {rel:.3g} (<= "
          f"{TRAIN_CPU_RTOL}); walls card {walls['card']:.2f} s, CPU "
          f"{walls['cpu']:.2f} s")

    # -- 14c. mesh fine-tuning on a virtual 2 x 2 mesh of cuda:0 ------------
    out["mesh"] = mesh_fits(texts, dev, [tp_mesh(DATA_AXIS, dev).home] * 4,
                            card)
    with open(result_path, "w") as fh:
        json.dump(out, fh)
    return 0


def llm_phases(dev, seed: int, card: str, work: Path) -> dict:
    """Phases 10-13f: the Gemma-2B-architecture model loaded from a
    synthetic HF checkpoint at bf16 and at int8 (``load_gemma``), prefill,
    card against CPU (f32 and int8), generation in turns, the explained
    stream, the slot lane at both widths, the async stream, the serve CLI's
    slot lane and its onpod-int8 spec. The checkpoints live under ``work``."""
    import torch

    from fraud_detection_tpu_torch.ops import attention as A
    from fraud_detection_tpu_torch.ops import int8_matmul as W

    # -- 10. the model from a checkpoint; full-width prefill (flash's path) --
    (work / "gemma2b").mkdir()
    lm, lm8, loads = load_gemma(work / "gemma2b", dev, seed, card)
    shutil.rmtree(work / "gemma2b")
    int8 = int8_gates(lm, lm8, dev, card)
    pre = prefill(lm, dev, seed + 40, card)

    # -- 11. card against CPU, 2 layers, f32 (and its int8 weights) ---------
    cvc = llm_card_vs_cpu(dev, seed + 41)
    cvc8 = int8_card_vs_cpu(dev, seed + 41)
    torch.cuda.empty_cache()

    # -- 12. full-width generation, bf16 then both in turns -----------------
    gen = llm_generate(lm, card)
    W.w8_matmul.launches = W.w8_matmul.simt_launches = 0
    turns = generation_turns(lm, lm8, card)
    gen8_launches = W.w8_matmul.launches
    if not gen8_launches or gen8_launches % (7 * lm8.cfg.n_layers + 1) \
            or W.w8_matmul.simt_launches:
        raise AssertionError(f"int8 generation launched w8_matmul "
                             f"{gen8_launches}x ({W.w8_matmul.simt_launches} "
                             "SIMT), want a positive multiple of 127 on mma")

    # -- 12b-12c. tensor and sequence parallelism at full width -------------
    # (flash and w8_matmul counts reset and read around each TP prefill and
    # the int8 TP generation, the flash count around each SP forward)
    tp = tp_serving(lm, lm8, dev, seed + 44, card)
    sp = sp_forward(lm, dev, seed + 45, card)
    # -- 12d. head-sharded KV caches at Llama-3-8B width ---------------------
    # (flash and w8_matmul counts reset and read around each TP run)
    kv = sharded_caches(dev, seed + 46, card)

    # -- 13. the engine with explanations ------------------------------------
    expl, expl_pipe, expl_items, flagged_rows = explained_stream(
        lm, dev, ROOT / "build" / "chip_smoke" / "dt", card)

    # -- 13b-13f. the slot lane (no flash launch anywhere in it) -------------
    A.flash_attention.launches = 0
    A.flash_attention_sm90.launches = A.flash_attention_simt.launches = 0
    slot_cvc = slot_card_vs_cpu(dev, seed + 42)
    slots = slot_lane(lm, flagged_rows, card)
    slots8 = slot_int8(lm8, flagged_rows, seed + 42, card)
    async_stream = explained_stream_async(lm, expl_pipe, expl_items, expl,
                                          card)
    del lm, lm8, expl_pipe
    torch.cuda.empty_cache()
    slot_cli = slot_serve_cli(dev, card)
    (work / "gemma2l").mkdir()
    hf_cli = hf_serve_cli(dev, work / "gemma2l", seed + 43, card)
    if A.flash_attention.launches:
        raise AssertionError(f"the slot lane launched the flash kernels "
                             f"{A.flash_attention.launches}x, want 0")
    print("[slot] phases 13b-13f: 0 flash launches (the slot prefill uses "
          "causal_attention(use_flash=False), the window _attend, as in the "
          "reference)")
    return {"load": loads, "int8": int8, "prefill": pre, "card_vs_cpu": cvc,
            "card_vs_cpu_int8": cvc8, "generate": gen,
            "generate_turns": turns, "int8_generate_launches": gen8_launches,
            "tp_serving": tp, "sp_forward": sp, "sharded_caches": kv,
            "explained_stream": expl, "slot_card_vs_cpu": slot_cvc,
            "slot_lane": slots, "slot_lane_int8": slots8,
            "explained_stream_async": async_stream,
            "slot_serve_cli": slot_cli, "hf_serve_cli": hf_cli}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from fraud_detection_tpu_torch.checkpoint.native import save_checkpoint
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize.device import DeviceFeaturizer
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline
    from fraud_detection_tpu_torch.models import train_trees as tt
    from fraud_detection_tpu_torch.ops import _build
    from fraud_detection_tpu_torch.ops import attention as A
    from fraud_detection_tpu_torch.ops import featurize_kernel as fk
    from fraud_detection_tpu_torch.ops import histogram as H
    from fraud_detection_tpu_torch.ops import int8_matmul as W
    from fraud_detection_tpu_torch.stream import (InProcessBroker,
                                                  StreamingClassifier)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card ------------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"[card] nvidia-smi: {card} | torch: {kind} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # the plain scan of phase 3's W=16,384 rows runs on the host meanwhile
    atexit.register(stop_children)
    scan_job = start_host_scans(args.seed)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    build_s = time.perf_counter() - t0
    fk.kernel_self_test(dev)
    H.kernel_self_test(dev)
    A.kernel_self_test(dev)
    W.kernel_self_test(dev)
    print(f"[build] {', '.join(k + '.cu' for k in KERNELS)} built in "
          f"{build_s:.3f} s (one nvcc each, in parallel); self-tests ok")
    native_build = build_native()
    for name in KERNELS:
        print(f"[build] ptxas {name}: {ptxas_summary(_build.build_log(name))}")

    # -- 3. kernel against plain version ------------------------------------
    corpus_texts = [d.text for d in generate_corpus(n=BATCH, seed=args.seed + 11)]
    rng = random.Random(args.seed + 1234)
    fuzz = ["".join(rng.choice(FUZZ_ALPHABET)
                    for _ in range(rng.randrange(0, 300))) for _ in range(128)]
    fuzz[0] = ""
    staged_main, cls_main = staged_classes(corpus_texts, WIDTH, dev)
    inputs = [("corpus", cls_main),
              ("adversarial", staged_classes(ADVERSARIAL, 128, dev, 16)[1]),
              ("fuzz", staged_classes(fuzz, 256, dev, 130)[1])]
    max_err = 0
    for name, cls in inputs:
        for legacy in (False, True):
            max_err = max(max_err, scan_max_err(cls, legacy))
            print(f"[check] scan kernel == plain version: {name} "
                  f"{tuple(cls.shape)} legacy={legacy}")
    feat = HashingTfIdfFeaturizer(num_features=FEATURES)
    feat.fit_idf([d.text for d in generate_corpus(n=800, seed=7)])
    dfeat = DeviceFeaturizer(feat, width=WIDTH, tokens=TOKENS, device=dev)
    stop = dfeat.stop_table()
    stop_empty = torch.from_numpy(fk.build_stop_table(
        list(feat.stop_filter.words) + [""])[0]).to(dev)
    spec = dfeat.spec
    staged_inputs = packed_inputs(corpus_texts, fuzz, dev, args.seed + 9)
    scans = host_scans(scan_job, dict(staged_inputs)["w16384"])
    packed_err = 0
    for name, staged in staged_inputs:
        variants = [(stop, spec), (stop, packed_spec(spec, legacy=True)),
                    (stop, packed_spec(spec, binary=True))]
        if name in ("corpus", "fuzz", "w16384"):
            variants += [(stop_empty, packed_spec(spec, empty_is_stop=True)),
                         (stop, packed_spec(spec, n_slots=32))]
        if name == "fuzz":
            variants.append((stop, packed_spec(spec, legacy=True,
                                               binary=True)))
        for table, sp in variants:
            packed_err = max(packed_err, packed_max_err(name, staged, table,
                                                        sp, scans))
    del scans
    packed_k, n_k = fk.featurize_bytes(staged_main, stop, spec=spec)
    if packed_k.shape != (BATCH, 2, TOKENS) or not bool((n_k > 0).all()):
        raise AssertionError(f"featurize_bytes output {tuple(packed_k.shape)} "
                             "or empty rows on corpus text")

    # tree kernels at the CLI shape (the real TF-IDF bins) and the bench
    # shape, on uint8 bins (the trainer's) and int32 bins: the same plan, so
    # the same sums in the same order
    Xtr, ytr, Xte, test_texts, cli_sets = cli_data(dev)
    edges = tt.quantile_bin_edges(Xtr, NBINS)
    bins_c = tt.apply_bins(torch.from_numpy(Xtr).to(dev),
                           torch.from_numpy(edges).to(dev)).contiguous()
    y_c = torch.from_numpy(ytr).to(dev)
    bins_b, y_b = bench_bins(dev, args.seed + 21)
    n_c, n_b = bins_c.shape[0], bins_b.shape[0]
    wide = {"cli": {torch.uint8: bins_c.to(torch.uint8), torch.int32: bins_c},
            "bench": {torch.uint8: bins_b.to(torch.uint8), torch.int32: bins_b}}
    shapes = {
        "cli_rf": ("cli", *level_inputs(n_c, 8, 2, y_c, dev, args.seed + 22), True),
        "cli_xgb": ("cli", *level_inputs(n_c, 1, 3, y_c, dev, args.seed + 23), False),
        "bench_rf": ("bench", *level_inputs(n_b, 8, 2, y_b, dev, args.seed + 24), True),
        "bench_xgb": ("bench", *level_inputs(n_b, 1, 3, y_b, dev, args.seed + 25), False),
    }
    hist_err, hists = {}, {}
    for name, (src, loc, w, st, exact) in shapes.items():
        for dt, bins in wide[src].items():
            err, h = check_histogram(name, bins, loc, w, st, exact)
            hist_err[(name, dt)] = err
            if dt == torch.uint8:
                hists[name] = h
            elif not torch.equal(h, hists[name]):
                raise AssertionError(f"histogram {name}: uint8 and int32 bins "
                                     "give different sums")
        print(f"[check] histogram {name}: uint8 and int32 bins bit-equal")
    gain_inputs = {}
    for name, crit in (("cli_rf", "gini"), ("cli_xgb", "xgb"),
                       ("bench_rf", "gini"), ("bench_xgb", "xgb")):
        hist = hists[name][0].contiguous()
        gain_inputs[name] = (hist, hist[:, 0].sum(dim=1).contiguous(), crit)
        check_best_splits(name, *gain_inputs[name])
    del hists
    # the histogram and best_splits at every level width of a depth-5 tree
    # at the CLI shape (the xgb rounds', the dt fit's and, 8 trees a chunk,
    # the forest's widths): each width runs its own plan, so each is held
    # against the plain version on uint8 and int32 bins, and best_splits
    # reads the checked level histograms
    width_inputs, level_hist = {}, {}
    for fit, trees, k in (("xgb", 1, 3), ("gini", 1, 2), ("rf", 8, 2)):
        for width in LEVEL_WIDTHS:
            seed = args.seed + (70 if fit == "rf" else 60) + width
            loc, w, st = level_inputs(n_c, trees, k, y_c, dev, seed, width)
            exact = fit != "xgb"
            hist = {dt: check_histogram(f"cli {fit} L={width}", bins, loc, w,
                                        st, exact, width)[1]
                    for dt, bins in wide["cli"].items()}
            if not torch.equal(hist[torch.uint8], hist[torch.int32]):
                raise AssertionError(f"histogram cli {fit} L={width}: uint8 "
                                     "and int32 bins give different sums")
            level_hist[(fit, width)] = (loc, w, st, dict(
                n_nodes=width, n_bins=NBINS, exact_int8=exact))
            if fit == "rf":
                continue
            h = hist[torch.uint8][0].contiguous()
            totals = h[:, 0].sum(dim=1).contiguous()
            check_best_splits(f"cli L={width}", h, totals, fit, None)
            width_inputs[(fit, width)] = (h, totals)
        del hist

    # the weight-only int8 product at every Gemma-2B weight shape
    w8_errs = check_w8_all(dev, args.seed + 80)

    # -- 4. the slice at full width (main path) -----------------------------
    lr_gpu, trees_gpu = make_models(feat, args.seed, dev)
    lr_cpu, trees_cpu = make_models(feat, args.seed, "cpu")
    texts = [d.text for d in generate_corpus(n=2048, seed=args.seed + 3)]
    fk.featurize_bytes.launches = fk.tokenize_hash.launches = 0
    pipes = {}
    for name, gm, cm, int8 in (("lr_fp32", lr_gpu, lr_cpu, False),
                               ("lr_int8", lr_gpu, lr_cpu, True),
                               ("forest", trees_gpu, trees_cpu, False)):
        kw = dict(batch_size=BATCH, int8=int8, featurize_device=True,
                  featurize_width=WIDTH, featurize_tokens=TOKENS)
        gpu = ServingPipeline(feat, gm, device=dev, **kw)
        cpu = ServingPipeline(feat, cm, device="cpu", **kw)
        pg, pc = gpu.predict(texts), cpu.predict(texts)
        if pg.probabilities.shape != (len(texts),) or not np.isfinite(
                pg.probabilities).all():
            raise AssertionError(f"{name}: bad output {pg.probabilities.shape}")
        dp = float(np.abs(pg.probabilities - pc.probabilities).max())
        if not np.array_equal(pg.labels, pc.labels) or dp > 1e-6:
            raise AssertionError(f"{name}: cuda vs cpu labels differ or "
                                 f"|dp| {dp} > 1e-6")
        assert gpu.device_stats.featurize_path == "cuda"
        pipes[name] = gpu
        print(f"[slice] {name}: {len(texts)} texts, labels equal cuda/cpu, "
              f"max |dp| {dp:.3g}, positives {int(pg.labels.sum())}, "
              f"truncated {gpu.device_stats.truncated_rows}")

    # -- 5. engine ----------------------------------------------------------
    def load_broker(n: int, seed: int):
        erng = random.Random(seed)
        items, want, malformed = [], {}, 0
        for i, d in enumerate(generate_corpus(n=n, seed=seed)):
            key = f"m{i}".encode()
            r = erng.random()
            if r < 0.01:
                value, malformed = b'{"text": "unterminated', malformed + 1
            elif r < 0.02:
                value, malformed = json.dumps({"body": d.text}).encode(), malformed + 1
            else:
                value = json.dumps({"text": d.text}).encode()
                want[key] = d.text
            items.append((value, key))
        broker = InProcessBroker()
        broker.producer().produce_batch("in", items)
        return broker, items, want, malformed

    pipe = pipes["lr_fp32"]
    broker, items, want, n_malformed = load_broker(4096, args.seed + 5)
    engine = StreamingClassifier(pipe, broker.consumer(["in"], "g"),
                                 broker.producer(), "out", batch_size=BATCH,
                                 max_wait=0.05, pipeline_depth=2)
    stats = engine.run(max_messages=len(items), idle_timeout=5.0)
    launches = fk.featurize_bytes.launches
    chunks = sum(p.device_stats.chunks for p in pipes.values())
    if launches != chunks:
        raise AssertionError(f"featurize_packed launched {launches}x over "
                             f"{chunks} chunks, want one launch a chunk")
    if fk.tokenize_hash.launches:
        raise AssertionError(f"the serving path ran the stream entry "
                             f"{fk.tokenize_hash.launches}x")
    out = broker.messages("out")
    if sorted(m.key for m in out) != sorted(k for _, k in items):
        raise AssertionError("engine output keys != fed keys")
    if stats.malformed != n_malformed:
        raise AssertionError(f"malformed {stats.malformed} != fed {n_malformed}")
    keys = sorted(want)
    expect = dict(zip(keys, pipe.predict([want[k] for k in keys]).labels.tolist()))
    frames = {m.key: json.loads(m.value) for m in out}
    bad = [k for k in keys if frames[k].get("prediction") != expect[k]]
    if bad:
        raise AssertionError(f"{len(bad)} engine labels != pipeline.predict")
    if launches < 1:
        raise AssertionError("the main path never launched featurize_packed")
    print(f"[engine] {len(items)} messages, keys exact, malformed "
          f"{stats.malformed}, labels equal predict; featurize_packed "
          f"launches on the main path {launches} over {chunks} chunks, "
          "stream entry 0")
    # the stream entry's own path: the reference tokenize_hash contract
    # (per-column token streams) over phase 4's texts, chunk by chunk
    fk.tokenize_hash.launches = 0
    for i in range(0, len(texts), BATCH):
        fk.tokenize_hash(staged_classes(texts[i:i + BATCH], WIDTH, dev)[1])
    scan_launches = fk.tokenize_hash.launches

    # -- 5b. the serve CLI's default path: native host featurize -------------
    host_pipes = host_serving(
        feat, texts, {"lr_fp32": (lr_gpu, lr_cpu, False),
                      "lr_int8": (lr_gpu, lr_cpu, True),
                      "forest": (trees_gpu, trees_cpu, False)},
        pipes, items, want, n_malformed, dev)
    ckpt_dir = ROOT / "build" / "chip_smoke"
    save_checkpoint(str(ckpt_dir / "lr"), feat, lr_gpu)
    serve_runs = check_serve_runs(ckpt_dir / "lr", SERVE_DEMO, dev, card, {
        "lr_host": [], "lr_featurize_device": ["--featurize-device"],
        "lr_async_int8": ["--async-dispatch", "--int8"]})
    # -- 5c. supervision, chaos and observability on the card ---------------
    # (featurize_packed counts reset and read around each of its main paths:
    # the supervised run and the serve CLI, inside the two functions)
    t5c = time.perf_counter()
    supervised = supervised_chaos(dev, ckpt_dir / "lr", args.seed, card)
    supervised["cli"] = chaos_cli(dev, ckpt_dir / "lr",
                                  ckpt_dir / "chaos_cli", card)
    supervised["phase_wall_s"] = time.perf_counter() - t5c
    print(f"[chaos] phase 5c wall {supervised['phase_wall_s']:.1f} s ({card})")
    # -- 5d. the fleet: N worker threads sharing one pipeline on the card ----
    # (featurize_packed counts reset and read around the 3-worker drain and
    # around each serve CLI run, inside fleet_phase)
    fleet_out = fleet_phase(dev, ckpt_dir / "lr", pipes["forest"],
                            ckpt_dir / "fleet", args.seed, card)
    # -- 5e. the game days: the scenario catalog on the card ------------------
    # (featurize_packed and tree-kernel counts reset and read around each
    # game day, the flash counts around the phase, inside gameday_phase)
    gameday_out = gameday_phase(dev, ckpt_dir / "lr", ckpt_dir / "gameday",
                                card)

    # -- 6. training slice, card against CPU ---------------------------------
    train_walls = train_card_vs_cpu(Xtr, ytr, Xte, dev)
    # -- 6b. the L-BFGS fit: card against CPU, and at the bench shape ---------
    lr_fits = {"cli": lr_card_vs_cpu(Xtr, ytr, cli_sets, dev, card),
               "bench": lr_bench_fit(dev, args.seed + 41, card)}

    # -- 7. training CLI on the card (the training main path) ----------------
    H.node_feature_bin_histogram_multi.launches = 0
    H.best_splits.launches = 0
    report = train_cli(dev, test_texts, ckpt_dir)
    hist_launches = H.node_feature_bin_histogram_multi.launches
    gain_launches = H.best_splits.launches
    if hist_launches < 1 or gain_launches < 1:
        raise AssertionError("the training CLI never launched the tree kernels")
    print(f"[cli] tree kernel launches on the main path: histogram "
          f"{hist_launches}, best_splits {gain_launches}")
    # -- 7b. the serve CLI on the training CLI's dt checkpoint ---------------
    serve_runs.update(check_serve_runs(ckpt_dir / "dt", SERVE_DEMO, dev, card, {
        "dt_host": [], "dt_featurize_device": ["--featurize-device"]}))
    # -- 7c. resume: rf and xgb interrupted at 30 and resumed (a main path) ---
    H.node_feature_bin_histogram_multi.launches = 0
    H.best_splits.launches = 0
    resume = resume_cli(dev, ckpt_dir, card)
    resume["launches"] = {"histogram": H.node_feature_bin_histogram_multi.launches,
                          "best_splits": H.best_splits.launches}
    if min(resume["launches"].values()) < 1:
        raise AssertionError(f"resume launches {resume['launches']}")
    print(f"[resume] tree kernel launches on the resume path: "
          f"{resume['launches']}")
    # -- 7d. the count featurizer: train, save, serve on host featurize -------
    count = count_cli(dev, test_texts, cli_sets["Test"][1], ckpt_dir)
    # -- 7e. serve --model synthetic: an LR trained at startup ----------------
    serve_runs.update(check_serve_runs("synthetic", SERVE_DEMO, dev, card, {
        "synthetic_host": [],
        "synthetic_featurize_device": ["--featurize-device"]}))
    # -- 7f. the model lifecycle: registry, shadow, promotion, learn lane ----
    # (tree-kernel counts reset and read around the learn lane's refresh,
    # inside lifecycle_run)
    lifecycle_out = lifecycle(dev, ckpt_dir / "xgb", ckpt_dir,
                              args.seed + 61, card)
    # -- 7g-7j. Kafka, mesh serving, data-parallel training, processes -------
    # (featurize_packed counts reset and read around each --kafka run, the
    # virtual-mesh predict and engine run and the serve --mesh run; the
    # tree-kernel counts around each virtual-mesh fit)
    t16 = time.perf_counter()
    kafka_out = kafka_phase(dev, ckpt_dir / "lr", card, args.seed)
    mesh_out = mesh_serving_phase(dev, ckpt_dir / "lr", feat, lr_gpu, texts,
                                  card, args.seed)
    mesh_train = mesh_training_phase(dev, Xtr, ytr, ckpt_dir, card)
    multiprocess = multiprocess_phase(card)
    phase16_wall = time.perf_counter() - t16
    print(f"[mesh] phases 7g-7j wall {phase16_wall:.1f} s ({card})")
    # -- 7k. Spark artifacts in and out, the wide space, the front end -------
    # (featurize_packed counts reset and read around each serve CLI run and
    # each fixture predict, inside spark_phase)
    spark_out = spark_phase(dev, ckpt_dir, card, args.seed)
    # -- 7l. flightcheck, the model checker, the sanitizer drives (host) ----
    flightcheck_out = flightcheck_phase(card, ckpt_dir / "flightcheck")

    # -- 8. times -------------------------------------------------------------
    def packed_call():
        before = fk.featurize_bytes.launches
        out = fk.featurize_bytes(staged_main, stop, spec=spec)
        if fk.featurize_bytes.launches != before + 1:
            raise AssertionError("featurize_bytes did not launch its kernel "
                                 "exactly once")
        return out

    def stream_call():
        return fk.tokenize_hash(cls_main)

    # the two entries in turns (packed, stream, stream, packed), beside the
    # first kernel's recorded time
    fb_ms = cuda_ms(packed_call, 50, 5)
    k_ms = cuda_ms(stream_call, 50, 5)
    k_ms = statistics.median([k_ms, cuda_ms(stream_call, 50, 5)])
    fb_ms = statistics.median([fb_ms, cuda_ms(packed_call, 50, 5)])
    fb_dev = kernel_device_ms(packed_call, ("packed_kernel",), 20)
    k_dev = kernel_device_ms(stream_call, ("stream_kernel",), 20)
    # the plain versions, ~1.7 s a call on the card: 3 timed calls each
    p_ms = cuda_ms(lambda: fk.tokenize_hash_reference(cls_main), 3, 1)
    fb_plain_ms = cuda_ms(lambda: fk.featurize_bytes_reference(
        staged_main, stop, spec=spec), 3, 1)
    rows, cols = cls_main.shape
    nbytes = rows * cols * 4 + 4 * rows * cols * 4 + rows * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * cols * SCAN_OPS_PER_ELEMENT / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # the rows read, the packed planes and unique counts written; the stop
    # table is probed once a token, not read whole, so it is not counted
    fb_bytes = staged_main.numel() + rows * 2 * spec.n_slots * 2 + rows * 4
    fb_bytes_ms = fb_bytes / HBM_BYTES_PER_S * 1e3
    fb_ops_ms = rows * cols * SCAN_OPS_PER_ELEMENT / FP32_OPS_PER_S * 1e3
    fb_bound_ms = max(fb_bytes_ms, fb_ops_ms)
    # pipelines: device featurize and native host featurize in turns
    # (device, host, host, device), each with its device idle share
    rates, idle, host_rates, host_idle = {}, {}, {}, {}
    for name, p in pipes.items():
        turns = [pipeline_rate(q, texts)
                 for q in (p, host_pipes[name], host_pipes[name], p)]
        rates[name] = statistics.median([turns[0][0], turns[3][0]])
        idle[name] = statistics.median([turns[0][1], turns[3][1]])
        host_rates[name] = statistics.median([turns[1][0], turns[2][0]])
        host_idle[name] = statistics.median([turns[1][1], turns[2][1]])
    # the host encode alone over the same 256-row chunks (host clock,
    # median of 5)
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for i in range(0, len(texts), BATCH):
            feat.encode(texts[i:i + BATCH], batch_size=BATCH)
        reps.append((time.perf_counter() - t0) * 1e3)
    host_encode_ms = statistics.median(reps)
    # the engine over 4,096 messages (batch 256, depth 2): raw JSON with
    # native frames (host featurize), the slow path (json.loads + Python
    # frames, host featurize), device featurize, and the raw-JSON path
    # with the dispatch lane; in turns, each with its device idle share
    _, items2, _, _ = load_broker(4096, args.seed + 6)
    modes = {"raw_json_native_frames": (host_pipes["lr_fp32"], {}),
             "slow_path": (host_pipes["lr_fp32"], {"json_fast": False}),
             "device_featurize": (pipe, {}),
             "raw_json_async_dispatch": (host_pipes["lr_fp32"],
                                         {"async_dispatch": True})}
    engine_turns = {m: [] for m in modes}
    for m in [*modes, *reversed(modes)]:
        engine_turns[m].append(engine_rate(modes[m][0], items2, **modes[m][1]))
    engine_modes = {m: dict(msgs_per_s=statistics.median(r[0] for r in t),
                            device_idle=statistics.median(r[1] for r in t),
                            turns=[r[0] for r in t])
                    for m, t in engine_turns.items()}
    msgs_s = engine_modes["device_featurize"]["msgs_per_s"]
    print(f"[engine] {card}: msgs/s over {len(items2)} messages (batch "
          f"{BATCH}, in turns): " + "; ".join(
              f"{m} {v['msgs_per_s']:.0f} (turns "
              f"{', '.join(f'{x:.0f}' for x in v['turns'])}; device idle "
              f"{100 * v['device_idle']:.1f}%)"
              for m, v in engine_modes.items()))
    print(f"[time] {card}: featurize_packed ({rows}, {WIDTH + 4}) -> "
          f"({rows}, 2, {spec.n_slots}): events {fb_ms:.4f} ms, device "
          f"{fb_dev:.4f} ms; plain version {fb_plain_ms:.2f} ms; bound "
          f"{fb_bound_ms * 1e3:.3f} us ({fb_bytes / 1e6:.3f} MB moved, "
          f"{'bytes' if fb_bytes_ms >= fb_ops_ms else 'operations'})")
    print(f"[time] {card}: stream entry ({rows}, {cols}): events {k_ms:.4f} "
          f"ms, device {k_dev:.4f} ms; plain version {p_ms:.2f} ms; bound "
          f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB moved); first "
          f"kernel (one thread per row) {FIRST_SCAN_MS} ms as recorded")
    print(f"[time] {card}: pipeline rows/s at batch {BATCH}, device "
          "featurize: "
          + ", ".join(f"{k} {v:.0f} (device idle {100 * idle[k]:.1f}%)"
                      for k, v in rates.items())
          + "; native host featurize: "
          + ", ".join(f"{k} {v:.0f} (device idle {100 * host_idle[k]:.1f}%)"
                      for k, v in host_rates.items())
          + f"; engine msgs/s (device featurize) {msgs_s:.0f}")
    print(f"[time] {card}: host encode of the {len(texts)} texts in "
          f"{BATCH}-row chunks: {host_encode_ms:.2f} ms")
    print(f"[time] {card}: serve CLI --demo {SERVE_DEMO} --batch-size 1024 "
          "msgs_per_sec: " + ", ".join(f"{k} {v['msgs_per_sec']}"
                                        for k, v in serve_runs.items()))
    print("[time] library_ms: none — no single PyTorch call computes the "
          "featurize program or the scan")
    breakdown = device_breakdown(packed_call)
    fb_kernels = sorted({name for name, _, _ in breakdown})
    print(f"[trace] {card}: featurize_bytes device ops: {fb_kernels} "
          f"(device {fb_dev * 1e3:.1f} us a launch of {fb_ms * 1e3:.1f} us "
          "events around the call)")
    for name, us, n in breakdown[:8]:
        print(f"[trace]   {us:9.1f} us/call  x{n:.1f}  {name[:90]}")
    if len(fb_kernels) != 1 or "packed_kernel" not in fb_kernels[0]:
        raise AssertionError(f"featurize_bytes ran {fb_kernels}, want the "
                             "one featurize_packed kernel")

    # tree kernels: kernel (uint8 bins, the main path's, and int32 bins),
    # plain version, library call, bound, per shape, beside the first
    # kernels' recorded times
    tree_times = {}
    for name, (src, loc, w, st, exact) in shapes.items():
        kw = dict(n_nodes=16, n_bins=NBINS, exact_int8=exact)
        big = src == "bench"
        row = {}
        for dt, bins in wide[src].items():
            def call():
                return H.node_feature_bin_histogram_multi(bins, loc, w, st, **kw)

            ms = cuda_ms(call, 20, 3)
            hb, hby, mb = histogram_bound(bins, loc, w, st, 16)
            row[str(dt).split(".")[1]] = dict(
                ms=ms, device_ms=kernel_device_ms(call, HIST_KERNELS),
                bound_ms=hb, bound_by=hby, mb=mb,
                max_abs_err=hist_err[(name, dt)])
        bins = wide[src][torch.uint8]
        hp = cuda_ms(lambda: H.histogram_reference(bins, loc, w, st, **kw),
                     5 if big else 20, 1)
        call, need = histogram_library_call(bins, loc, w, st, 16)
        lib = None if call is None else cuda_ms(call, 10 if big else 20, 2)
        del call
        torch.cuda.empty_cache()
        u8, i32 = row["uint8"], row["int32"]
        tree_times[name] = dict(
            ms=u8["ms"], device_ms=u8["device_ms"], plain_ms=hp,
            library_ms=lib, bound_ms=u8["bound_ms"],
            bound_by=u8["bound_by"], max_abs_err=u8["max_abs_err"],
            int32=i32, shape=[*bins.shape, loc.shape[0], 16, NBINS, st.shape[1]])
        print(f"[time] {card}: histogram {name} (N, F, T, L, NB, K) = "
              f"{tree_times[name]['shape']}: kernel uint8 bins {u8['ms']:.4f} ms "
              f"(device {u8['device_ms']:.4f} ms; bound {u8['bound_ms'] * 1e3:.2f} "
              f"us, {u8['bound_by']}, {u8['mb']:.1f} MB), int32 bins "
              f"{i32['ms']:.4f} ms (device {i32['device_ms']:.4f} ms; bound "
              f"{i32['bound_ms'] * 1e3:.2f} us, {i32['mb']:.1f} MB); first "
              f"kernel (recorded) {FIRST_HIST_MS[name]}; plain {hp:.2f} ms; "
              "index_add_ "
              + (f"{lib:.4f} ms" if lib is not None else
                 f"not built: needs {need / 1e9:.1f} GB of ids and values"))
        if not u8["ms"] < FIRST_HIST_MS[name]:
            print(f"[time] NOTE: histogram {name} is not faster than the "
                  "first kernel's recorded time")
        if lib is not None and not u8["ms"] < lib:
            print(f"[time] NOTE: histogram {name} is not faster than index_add_")
    gain_times = {}
    for name, (hist, totals, crit) in gain_inputs.items():
        def call():
            return H.best_splits(hist, totals, criterion=crit)

        gk = cuda_ms(call, 50, 5)
        gd = kernel_device_ms(call, GAIN_KERNELS)
        gp = cuda_ms(lambda: H.best_splits_reference(hist, totals,
                                                     criterion=crit), 20, 2)
        gb, gby = best_splits_bound(hist)
        gain_times[name] = dict(ms=gk, device_ms=gd, plain_ms=gp, bound_ms=gb,
                                bound_by=gby, shape=list(hist.shape),
                                criterion=crit)
        print(f"[time] {card}: best_splits {name} {crit} (L, F, NB, K) = "
              f"{list(hist.shape)}: kernel {gk:.4f} ms (device {gd:.4f} ms); first kernel "
              f"(recorded) {FIRST_GAIN_MS.get(name, 'not recorded')}; plain "
              f"{gp:.2f} ms; bound {gb * 1e3:.2f} us ({gby}); library call: none")
    width_times, hist_width_times = {}, {}
    for (crit, width), (hist, totals) in width_inputs.items():
        def call():
            return H.best_splits(hist, totals, criterion=crit)

        gk = cuda_ms(call, 50, 5)
        gd = kernel_device_ms(call, GAIN_KERNELS)
        gb, gby = best_splits_bound(hist)
        width_times[f"{crit}_L{width}"] = dict(ms=gk, device_ms=gd, bound_ms=gb,
                                               bound_by=gby,
                                               shape=list(hist.shape))
        print(f"[time] {card}: best_splits cli {crit} L={width} "
              f"{list(hist.shape)}: kernel {gk:.4f} ms (device {gd:.4f} ms); "
              f"bound {gb * 1e3:.2f} us ({gby})")
    per_fit = {f"{fit}_{key}": reps * sum(width_times[f"{crit}_L{w}"][key]
                                          for w in LEVEL_WIDTHS)
               for fit, crit, reps in (("xgb100", "xgb", 100), ("dt", "gini", 1))
               for key in ("ms", "device_ms")}
    print(f"[time] {card}: best_splits per fit at the CLI shape (sum over the "
          f"level widths): xgb100 {per_fit['xgb100_ms']:.3f} ms (device "
          f"{per_fit['xgb100_device_ms']:.3f}), dt {per_fit['dt_ms']:.4f} ms "
          f"(device {per_fit['dt_device_ms']:.4f})")
    bins_u8 = wide["cli"][torch.uint8]
    for (fit, width), (loc, w, st, kw) in level_hist.items():
        def call():
            return H.node_feature_bin_histogram_multi(bins_u8, loc, w, st, **kw)

        hist_width_times[f"{fit}_L{width}"] = dict(
            ms=cuda_ms(call, 20, 3), device_ms=kernel_device_ms(call, HIST_KERNELS),
            trees=loc.shape[0], k=st.shape[1])
        t = hist_width_times[f"{fit}_L{width}"]
        print(f"[time] {card}: histogram cli {fit} L={width} T={t['trees']} "
              f"K={t['k']}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms)")
    # launches per CLI fit: xgb 100 rounds, the forest 13 chunks of 8 trees,
    # dt once, each at every level width
    for key in ("ms", "device_ms"):
        for fit, crit, n_fit in (("xgb100", "xgb", 100), ("rf100", "rf", 13),
                                 ("dt", "gini", 1)):
            per_fit[f"hist_{fit}_{key}"] = n_fit * sum(
                hist_width_times[f"{crit}_L{w}"][key] for w in LEVEL_WIDTHS)
    print(f"[time] {card}: histogram per fit at the CLI shape (sum over the "
          "level widths): " + ", ".join(
              f"{fit} {per_fit[f'hist_{fit}_ms']:.3f} ms (device "
              f"{per_fit[f'hist_{fit}_device_ms']:.3f})"
              for fit in ("xgb100", "rf100", "dt")))
    cli_walls = report["meta"]["train_seconds"]
    print(f"[time] {card}: fit walls at the CLI shape (1120 x 10000, host "
          f"clock): train CLI dt {cli_walls['dt']} s, rf100 {cli_walls['rf']} "
          f"s, xgb100 {cli_walls['xgb']} s; phase 6 dt "
          f"{train_walls['dt']:.3f} s, rf8 {train_walls['rf8']:.3f} s, "
          f"xgb8 {train_walls['xgb8']:.3f} s")
    y_bh = y_b.cpu().numpy()
    edges_b = np.tile(np.linspace(0.0, 1.0, NBINS - 1, dtype=np.float32),
                      (BENCH_FEATURES, 1))
    bench_fits = {
        "dt": lambda: tt.fit_decision_tree(bins_b, y_bh, edges=edges_b,
                                           device=dev),
        "rf100": lambda: tt.fit_random_forest(bins_b, y_bh, n_trees=100,
                                              edges=edges_b, device=dev),
        "xgb100": lambda: tt.fit_gradient_boosting(bins_b, y_bh, n_rounds=100,
                                                   edges=edges_b, device=dev),
    }
    bench_walls = {}
    for name, fit in bench_fits.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        bench_walls[name] = time.perf_counter() - t0
    print(f"[time] {card}: fit walls at the bench shape ({BENCH_ROWS} x "
          f"{BENCH_FEATURES}, pre-binned on the card, host clock): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in bench_walls.items()))
    fit_ms = bench_walls["dt"] * 1e3
    breakdown = device_breakdown(bench_fits["dt"], reps=1)
    busy = sum(us for _, us, _ in breakdown)
    print(f"[trace] {card}: dt fit at the bench shape: device busy "
          f"{busy / 1e3:.2f} ms of a {fit_ms:.1f} ms wall; "
          f"{sum(n for *_, n in breakdown):.0f} device ops")
    for name, us, n in breakdown[:10]:
        print(f"[trace]   {us:10.1f} us  x{n:.0f}  {name[:90]}")

    # -- 9. flash kernels against their plain version ------------------------
    bf16, f32 = torch.bfloat16, torch.float32
    flash_err = check_flash("main", *flash_inputs(FLASH_MAIN, 1, bf16, dev,
                                                  args.seed + 31),
                            FLASH_BF16_ATOL)
    ragged_err = {}
    for d in FLASH_RAGGED_D:
        for t in FLASH_RAGGED_T:
            for hkv in (1, 2, FLASH_RAGGED_H):
                shape = (2, t, FLASH_RAGGED_H, d)
                ragged_err[(t, d, hkv)] = check_flash(
                    f"ragged bf16 T={t} d={d} Hkv={hkv}",
                    *flash_inputs(shape, hkv, bf16, dev, args.seed + t + d + hkv),
                    FLASH_BF16_ATOL, FLASH_BF16_RTOL, quiet=True)
        worst = max((e, t, hkv) for (t, dd, hkv), e in ragged_err.items()
                    if dd == d)
        print(f"[check] flash ragged bf16 (sm90) d={d}: B=2, H=4, T in "
              f"{FLASH_RAGGED_T}, Hkv in (1, 2, 4): all within "
              f"{FLASH_BF16_ATOL} + {FLASH_BF16_RTOL:.4g} relative, max |diff| "
              f"{worst[0]:.3g} (T={worst[1]}, Hkv={worst[2]}); every shape two "
              "launches bit-equal, native K/V == expanded K/V")
    for i, (shape, hkv) in enumerate((((2, 1000, 4, 64), 2),
                                      ((1, 131, 1, 32), 1))):
        check_flash("ragged", *flash_inputs(shape, hkv, f32, dev,
                                            args.seed + 32 + i),
                    FLASH_F32_TOL, FLASH_F32_TOL)
    simt_qkv = flash_inputs(FLASH_SIMT_MAIN, 1, f32, dev, args.seed + 34)
    simt_err = check_flash("phase-11 shape", *simt_qkv, FLASH_F32_TOL,
                           FLASH_F32_TOL)

    # -- 10-13f. the explanation LLM, loaded from a checkpoint --------------
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_llm_"))
    try:
        llm_out = llm_phases(dev, args.seed, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    pre, cvc = llm_out["prefill"], llm_out["card_vs_cpu"]

    # -- 14. flash kernel times ------------------------------------------------
    flash_times, simt_times = {}, {}
    for t in (2048, 8192):
        shape = (1, t, 8, 256)
        q, k, v = flash_inputs(shape, 1, bf16, dev, args.seed + 50)
        err = check_flash(f"T={t}", q, k, v, FLASH_BF16_ATOL, route="sm90")
        err_simt = check_flash(f"T={t}", q, k, v, FLASH_BF16_ATOL, route="simt")
        fb, fby = flash_bound(shape, 1, 2)
        reps = 20 if t == 2048 else 5
        sm90_a = cuda_ms(lambda: A.flash_attention_sm90(q, k, v), 3 * reps, 3)
        simt_a = cuda_ms(lambda: A.flash_attention_simt(q, k, v), reps, 2)
        simt_b = cuda_ms(lambda: A.flash_attention_simt(q, k, v), reps, 0)
        sm90_b = cuda_ms(lambda: A.flash_attention_sm90(q, k, v), 3 * reps, 0)
        sdpa = sdpa_call(q, k, v)
        burst = 50 if t == 2048 else 10
        common = dict(
            plain_ms=cuda_ms(lambda: A.flash_attention_reference(q, k, v), 5, 1),
            library_ms=cuda_ms(sdpa, 20, 3), library_burst_ms=burst_ms(sdpa, burst),
            bound_ms=fb, bound_by=fby, shape=[*shape, 1])
        flash_times[t] = dict(
            ms=(sm90_a + sm90_b) / 2, ms_turns=[sm90_a, sm90_b],
            burst_ms=burst_ms(lambda: A.flash_attention_sm90(q, k, v), burst),
            max_abs_err=err, **common)
        simt_times[t] = dict(
            ms=(simt_a + simt_b) / 2, ms_turns=[simt_a, simt_b],
            burst_ms=burst_ms(lambda: A.flash_attention_simt(q, k, v), 5),
            max_abs_err=err_simt, **common)
        ft, st = flash_times[t], simt_times[t]
        print(f"[time] {card}: flash (B, T, H, d, Hkv) = {ft['shape']} bf16, "
              f"CUDA events around one call (around a burst of back-to-back "
              f"calls, per call, beside it): sm90 kernel {ft['ms']:.4f} ms "
              f"(turns {sm90_a:.4f} / {sm90_b:.4f}; burst {ft['burst_ms']:.4f}); "
              f"SIMT kernel {st['ms']:.4f} ms (turns {simt_a:.4f} / "
              f"{simt_b:.4f}; burst {st['burst_ms']:.4f}); "
              f"scaled_dot_product_attention {ft['library_ms']:.4f} ms (burst "
              f"{ft['library_burst_ms']:.4f}); plain {ft['plain_ms']:.2f} ms; "
              f"bound {fb * 1e3:.2f} us ({fby}); sm90 {ft['ms'] / fb:.1f}x "
              f"bound, {st['ms'] / ft['ms']:.1f}x faster than SIMT, "
              f"{ft['ms'] / ft['library_ms']:.2f}x SDPA's time")
        if not ft["ms"] < st["ms"]:
            print(f"[time] NOTE: the sm90 kernel is not faster than the SIMT "
                  f"kernel at T={t}")
        del q, k, v
    q, k, v = simt_qkv
    fb, fby = flash_bound(FLASH_SIMT_MAIN, 1, 4)
    simt_main = dict(
        ms=cuda_ms(lambda: A.flash_attention_simt(q, k, v), 20, 3),
        plain_ms=cuda_ms(lambda: A.flash_attention_reference(q, k, v), 10, 2),
        library_ms=cuda_ms(sdpa_call(q, k, v), 20, 3), bound_ms=fb,
        bound_by=fby, shape=[*FLASH_SIMT_MAIN, 1], dtype="float32",
        max_abs_err=simt_err)
    print(f"[time] {card}: flash (B, T, H, d, Hkv) = {simt_main['shape']} f32 "
          f"(phase 11's shape), CUDA events around one call: SIMT kernel "
          f"{simt_main['ms']:.4f} ms; scaled_dot_product_attention "
          f"{simt_main['library_ms']:.4f} ms; plain {simt_main['plain_ms']:.2f} "
          f"ms; bound {fb * 1e3:.2f} us ({fby}, f32 at 67 TFLOP/s); SIMT "
          f"{simt_main['ms'] / fb:.1f}x bound")
    del q, k, v, simt_qkv

    w8 = w8_times(dev, args.seed + 90, card)

    # -- 14b-14c. the LLM trainer, in a process of its own -------------------
    train_llm = llm_train_phase(card)
    # -- 14d. two-process fits (with two cards or more) ----------------------
    train_llm["two_process"] = two_process_fits_phase(card)
    # -- 14e. the example twins on the card, against their host runs --------
    # (every launch count reset before each twin and read after it)
    examples_out = examples_phase(card)

    # -- 15. result lines ----------------------------------------------------
    def learn_refresh(kernel):
        """The tree kernels' second main path: phase 7f's learn refresh."""
        info = lifecycle_out["run"]["manifest_learn"]
        return {"launches": lifecycle_out["run"]["launches"][kernel],
                "path": "phase 7f: the learn lane's drift refresh beside "
                        "the serving engine",
                "rounds": info["rounds"], "max_depth": info["max_depth"],
                "window_rows": info["window_rows"],
                "padded_rows": info["padded_rows"]}

    # the tree kernels' main shape: the CLI's xgb level (500 of each
    # kernel's launches on the main path)
    main_h, main_g = tree_times["cli_xgb"], gain_times["cli_xgb"]
    print(f"[wall] chip_smoke.py {time.perf_counter() - start:.1f} s from its "
          f"start to the result lines ({card})")
    print(json.dumps({"kernels": [{
        "name": "featurize_packed",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/featurize_scan.cu",
        "replaces": "fraud_detection_tpu/ops/featurize_kernel.py:266 and :488",
        "launches": launches,
        "max_abs_err": packed_err,
        "matched": True,
        "ms": fb_ms,
        "device_ms": fb_dev,
        "plain_ms": fb_plain_ms,
        "bound_ms": fb_bound_ms,
        "bound_by": "bytes" if fb_bytes_ms >= fb_ops_ms else "operations",
        "library_ms": None,
        "shape": [rows, WIDTH + 4],
        "trace_kernels": fb_kernels,
        "gameday_launches": {k: v["featurize_packed_launches"]
                             for k, v in gameday_out["runs"].items()},
        "kafka_launches": kafka_out["runs"]["featurize_device"][
            "featurize_packed_launches"],
        "mesh_launches": {"virtual_predict": mesh_out["launches"],
                          "virtual_chunks": mesh_out["chunks"],
                          "virtual_engine": mesh_out["engine_launches"],
                          "virtual_engine_chunks": mesh_out["engine_chunks"],
                          "shards": MESH_SHARDS},
        "spark_launches": {
            **{k: v["featurize_packed_launches"]
               for k, v in spark_out["serve"].items()},
            "fixture_featurize_device":
                spark_out["fixture"]["featurize_device"]["launches"],
            "front_end": spark_out["front_end"]["featurize_packed_launches"]},
        "card": card,
    }, {
        "name": "featurize_scan",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/featurize_scan.cu",
        "replaces": "fraud_detection_tpu/ops/featurize_kernel.py:266",
        "launches": scan_launches,
        "max_abs_err": max_err,
        "matched": True,
        "ms": k_ms,
        "device_ms": k_dev,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [rows, cols],
        "main_path": "tokenize_hash over phase 4's texts, one call a chunk",
        "card": card,
    }, {
        "name": "histogram",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/histogram.cu",
        "replaces": "fraud_detection_tpu/ops/histogram.py:185",
        "launches": hist_launches,
        "max_abs_err": main_h["max_abs_err"],
        "matched": True,
        "ms": main_h["ms"],
        "device_ms": main_h["device_ms"],
        "plain_ms": main_h["plain_ms"],
        "bound_ms": main_h["bound_ms"],
        "bound_by": main_h["bound_by"],
        "library_ms": main_h["library_ms"],
        "shape": main_h["shape"],
        "main_path": "phase 7: the training CLI's dt, rf100 and xgb100 "
                     "fits (rf and xgb also exported with --save "
                     "m=spark:<dir>, served in phase 7k)",
        "bins": "uint8",
        "int32_bins": main_h["int32"],
        "other_shapes": {k: v for k, v in tree_times.items()
                         if k != "cli_xgb"},
        "cli_level_widths": hist_width_times,
        "learn_refresh": learn_refresh("histogram"),
        "gameday_drift_shift": gameday_out["runs"]["drift_shift"][
            "tree_launches"],
        "mesh_launches": mesh_train["virtual"]["launches"],
        "card": card,
    }, {
        "name": "best_splits",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/best_splits.cu",
        "replaces": "fraud_detection_tpu/ops/histogram.py:378",
        "launches": gain_launches,
        "max_abs_err": 0.0,
        "matched": True,
        "ms": main_g["ms"],
        "device_ms": main_g["device_ms"],
        "plain_ms": main_g["plain_ms"],
        "bound_ms": main_g["bound_ms"],
        "bound_by": main_g["bound_by"],
        "library_ms": None,
        "shape": main_g["shape"],
        "main_path": "phase 7: the training CLI's dt, rf100 and xgb100 "
                     "fits (rf and xgb also exported with --save "
                     "m=spark:<dir>, served in phase 7k)",
        "other_shapes": {k: v for k, v in gain_times.items()
                         if k != "cli_xgb"},
        "cli_level_widths": width_times,
        "learn_refresh": learn_refresh("best_splits"),
        "gameday_drift_shift": gameday_out["runs"]["drift_shift"][
            "tree_launches"],
        "mesh_launches": mesh_train["virtual"]["launches"],
        "card": card,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/flash_attention_sm90.cu",
        "replaces": "fraud_detection_tpu/ops/attention.py:75",
        "launches": pre["launches"],
        "max_abs_err": flash_err,
        "matched": True,
        "ms": flash_times[2048]["ms"],
        "plain_ms": flash_times[2048]["plain_ms"],
        "bound_ms": flash_times[2048]["bound_ms"],
        "bound_by": flash_times[2048]["bound_by"],
        "library_ms": flash_times[2048]["library_ms"],
        "shape": flash_times[2048]["shape"],
        "other_shapes": {"T8192": flash_times[8192]},
        "ragged_bf16_max_abs_err": max(ragged_err.values()),
        "card": card,
    }, {
        "name": "flash_attention_simt",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "fraud_detection_tpu/ops/attention.py:75",
        "launches": cvc["simt_launches"],
        "max_abs_err": simt_main["max_abs_err"],
        "matched": True,
        "ms": simt_main["ms"],
        "plain_ms": simt_main["plain_ms"],
        "bound_ms": simt_main["bound_ms"],
        "bound_by": simt_main["bound_by"],
        "library_ms": simt_main["library_ms"],
        "shape": simt_main["shape"],
        "dtype": "float32",
        "other_shapes": {"bf16_T2048": simt_times[2048],
                         "bf16_T8192": simt_times[8192]},
        "main_path": "phase 11: the 2-layer f32 forward at T=600",
        "card": card,
    }, {
        "name": "w8_matmul",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "none: no pl.pallas_call; the reference's int8 products "
                    "(fraud_detection_tpu/models/llm.py:271 _mm, :793 "
                    "_logits_head) are left to XLA",
        "launches": llm_out["int8_generate_launches"],
        "max_abs_err": max(v for k, v in w8_errs.items() if "bfloat16" in k),
        "matched": True,
        "ms": w8["w_gate,w_up M=8"]["ms"],
        "burst_ms": w8["w_gate,w_up M=8"]["burst_ms"],
        "library_burst_ms": w8["w_gate,w_up M=8"]["library_burst_ms"],
        "plain_ms": w8["w_gate,w_up M=8"]["plain_ms"],
        "bound_ms": w8["w_gate,w_up M=8"]["bound_ms"],
        "bound_by": w8["w_gate,w_up M=8"]["bound_by"],
        "library_ms": w8["w_gate,w_up M=8"]["library_ms"],
        "library": "cuBLAS bf16 torch.matmul on a bf16 copy of the weight",
        "shape": w8["w_gate,w_up M=8"]["shape"],
        "dtype": "bfloat16",
        "design": "wgmma swap-AB (int8 weight as A, converted in registers; "
                  "x as B in shared memory, tokens as instruction N: 8, 32, "
                  "128 or 256), TMA-fed stage ring on mbarriers, one split plan "
                  "per (K, N) for every M (K splits in blocks of their own "
                  "at decode with an ordered second pass, in registers at "
                  "prefill)",
        "per_decode_step": {"launches": llm_out["int8"]["step_launches"],
                            **w8["decode_step"]},
        "other_shapes": {k: v for k, v in w8.items()
                         if k not in ("w_gate,w_up M=8", "decode_step")
                         and not k.endswith("f32")},
        "main_path": "phase 12: int8 generation in turns with bf16",
        "card": card,
    }, {
        "name": "w8_matmul_simt",
        "route": "cuda",
        "source": "fraud_detection_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "none: no pl.pallas_call (as w8_matmul)",
        "launches": llm_out["card_vs_cpu_int8"]["simt_launches"],
        "max_abs_err": max(v for k, v in w8_errs.items() if "float32" in k),
        "matched": True,
        "ms": w8["w_gate,w_up M=8 f32"]["ms"],
        "plain_ms": w8["w_gate,w_up M=8 f32"]["plain_ms"],
        "bound_ms": w8["w_gate,w_up M=8 f32"]["bound_ms"],
        "bound_by": w8["w_gate,w_up M=8 f32"]["bound_by"],
        "library_ms": w8["w_gate,w_up M=8 f32"]["library_ms"],
        "library": "f32 torch.matmul on an f32 copy of the weight",
        "shape": w8["w_gate,w_up M=8 f32"]["shape"],
        "dtype": "float32",
        "design": "SIMT f32 FMAs in ascending k inside each K split of the "
                  "same plan, double-buffered 32-k tiles, 8- or 32-row "
                  "blocks, the same ordered second pass",
        "other_shapes": {k: v for k, v in w8.items() if k.endswith("f32")
                         and k != "w_gate,w_up M=8 f32"},
        "main_path": "phase 11: the 2-layer f32 int8 forward at T=600",
        "card": card,
    }], "serving": {"pipeline_rows_per_s": rates, "device_idle": idle,
                    "host_featurize_rows_per_s": host_rates,
                    "host_featurize_device_idle": host_idle,
                    "host_encode_ms": host_encode_ms,
                    "engine_msgs_per_s": msgs_s, "engine": engine_modes,
                    "serve_cli": serve_runs, "native_build": native_build},
        "fit_walls_s": {"cli": cli_walls, "bench": bench_walls},
        "lr_fits": lr_fits, "cli_lr_metrics": report["metrics"]["lr"],
        "resume": resume, "count_featurizer": count,
        "lifecycle": lifecycle_out, "supervised": supervised,
        "fleet": fleet_out, "gameday": gameday_out,
        "kafka": kafka_out, "mesh_serving": mesh_out,
        "mesh_training": mesh_train, "multiprocess": multiprocess,
        "phase_7g_7j_wall_s": phase16_wall, "spark": spark_out,
        "flightcheck": flightcheck_out,
        "tree_kernels_ms_per_cli_fit": per_fit,
        "llm": llm_out, "llm_train": train_llm, "examples": examples_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
