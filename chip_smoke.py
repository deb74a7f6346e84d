#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, each printing its own lines:

  1. card     nvidia-smi's name and power limit, torch/CUDA versions, the
              TF32 switches;
  2. build    the hand-written CUDA kernels, built from src/repro_torch/
              kernels/csrc at first use (nvcc, sm_90a), with ptxas's
              registers, stack and spills of every register-tile
              instantiation (warp-select knn and bubble_cd, assign, the
              distance panel of pairwise and mutual_reach and its norm
              pass, the CUDA-core flash kernel, both flash backward
              kernels, the round minima and the strip distances and top-k
              of the exact path; each must have no stack frame and no
              spills; and
              the wgmma flash forward's two, reported, each required to
              launch at the 168 registers its setmaxnreg split assumes;
              the grid kernels', reported by name, with the five widths of
              the redesigned round and assign kernels, and the Eq. 6
              kernel csrc/grid_cd.cu's ten (the five widths by lists of 12
              and 16 slots) and six queues, required),
              and the flash kernel's query rows
              and blocks per SM for each head-dim bucket;
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes, on a tie-free mean-centred table
              and on a duplicate-heavy one, with kernel / plain / library
              times; assign and bubble_cd also bit for bit against the
              per-lane kernels they replaced (assign's time beside the
              per-lane kernel's), mutual_reach bit for bit against the
              tile kernel it replaced on every table (its time beside the
              tile kernel's, the card's write rate at the same size and
              the bound), assign also at d = 200, and bubble_cd timed at
              min_pts 1, 10, 100 and 1024 (the last two held to the plain
              version);
  4. stream   the default StreamingClusterEngine on the card: 262,144
              points at d = 16 from a seeded Gaussian mixture, ingested in
              blocks of 8192 (compression 0.02 → ~5,200 leaves, Lp = 8192),
              a quarter retired in blocks, 65,536 queries in chunks, and
              assign timed at the query shape (a 4096-row chunk against the
              final snapshot's bucket); the hierarchy kernels launched once
              per offline pass and the plain hierarchy loops never on the
              card; then the snapshots and the served rows held against the
              port's own plain pipeline on the CPU; the three hierarchy
              kernels (single-linkage, condense, extract) against the
              plain loops on the card on the full table's own Borůvka
              buffers (Lp = 8192: every field bit for bit, a second run
              bit for bit), and single-linkage and condense
              (csrc/hierarchy_par.cu) also against their first versions
              (csrc/hierarchy.cu) and the CPU models of their algorithms
              there and on a 32,768-leaf chain (a dendrogram 32,767 deep,
              with the plain loops on the CPU); extract
              (csrc/hierarchy_extract.cu) also bit for bit the plain
              extract_fixed on the CPU, and against the earlier
              composition extract_v1 (index_put_ stabilities, the EOM
              kernel, flat_labels: integer fields equal, stabilities
              within 1e-5, or 2 (k - 1) 2^-24 for a label of k terms
              where that is larger) there and on a 32,768-leaf comb of ~11,000
              labels (its arrays past shared memory); each timed in turns
              with its first version at both sizes and beside the plain
              loops, with their bound (the larger of the bytes and, for
              the sweeps that walk, a latency floor of one shared-memory
              round trip per dependent step); one offline pass at Lp = 8192 timed stage by
              stage, end to end, under torch.profiler (device busy share),
              and once more with no host synchronisation allowed between
              prepare and unwrap (torch.cuda.set_sync_debug_mode); and
              passes at min_pts = 100 (warp-select) and 2000 (bubble_cd's
              strip route) on the full table held to the CPU plain pass by
              partition;
     serve    SERVE_THREADS threads of SERVE_REQUESTS requests of 512 rows
              of the stream's query mixture through one QueryBatcher on
              the stream's final engine: every caller's rows against a
              direct query_detailed of the same rows (labels and
              bubble_index identical, distance and strength bit for bit
              counted and held within 1e-6 relative) and against the
              port's CPU plain query, fused calls, fan-out, assign
              launches (one per fused call), caller p50/p99 and rows/s
              beside the same requests served one by one, at the
              batcher's default re-contend interval (2 ms); then a
              poisoned query_detailed that must raise in every caller,
              and the batcher serving rightly afterwards;
     recover  the stream engine checkpointed after its full flush
              (checkpoint_state, a blocking save, an async save and wait,
              into a temporary CheckpointStore), restored into a fresh
              card engine that replays the stream's retire blocks: every
              version published on the way bit for bit the stream's
              (version, labels, MST u/v/w, stabilities, every result and
              condensed field), the final query chunk identical; the same
              checkpoint restored into a CPU engine, its snapshot equal;
              bytes on disk and the ms of each step and of the first pass
              after the restore;
     online   the [stream] configuration with device_online=True (the same
              data, blocks, retires and queries): the leaf CF table also on
              the card, each block through the assign and flat_scatter
              kernels, ε-passes read straight from the table; CF parity
              against the host tree after every block (and the host's
              populated slots equal to the device's), every pass's
              partition equal to the card's host-table pass on the same
              tree, the final snapshot and the served rows against the CPU
              plain pipeline, a capture and pass under
              torch.cuda.set_sync_debug_mode("error") up to the unwrap;
              ingest and retire ms per 1k points beside [stream]'s, the
              device-table pass's stages at the full table beside the
              host-table pass's; flat_scatter bit for bit against its
              plain version at the stream's shapes and on a
              duplicate-heavy block (insert and delete, two runs), timed
              beside the plain version and index_put_(accumulate) with the
              Kahan adds; a checkpoint drill replaying the retires bit for
              bit;
     grid     the [stream] configuration with spatial_index=True (the same
              data, blocks, retires and queries): every published snapshot
              with the dense engine's partition (and counted bit for bit),
              the served chunks bit for bit the dense engine's, the grid
              kernels launched and the dense distance kernels not; on the
              full table (L = 5,243, Lp = 8192) grid_core_distances
              (csrc/grid_cd.cu) bit for bit bubble_cd at min_pts 10, 100 and
              2000 (the strip route) and its first kernel
              (grid_core_distances_v1, csrc/grid.cu: launched 0 times on
              every stream), both timed alone in turns there with their
              row-tile visits and longest walks of a CTA and the bound from
              the visits the function needs (each valid row's tiles
              whose bound is at most the distance of its min_pts
              crossing),
              and the grid pass also timed with its Eq. 6 search on the
              first kernel,
              grid_assign (csrc/grid_assign.cu) bit for bit assign and its
              first kernel (grid_assign_v1, csrc/grid.cu: launched 0 times
              on every stream) at the ingest and query shapes and on the
              d = 200 stream, boruvka_grid's buffers bit for bit dense
              Borůvka on the panel's W; each kernel against its plain
              version, timed beside it with the visited share of rows x
              tiles and the bound from the visited tiles; grid_assign at
              both shapes in turns with its first kernel, the kernel alone
              and the whole call, each kernel's visits and longest walk of
              a CTA, the bound from the visits the function needs (the
              first kernel's), cdist+min, and one whole call's launches,
              device busy and host enqueue under torch.profiler;
              grid_round_minima (csrc/grid_round.cu) bit for bit its first
              kernel (grid_round_minima_v1, csrc/grid.cu: launched 0 times
              on the stream) in round 1, timed in turns with it, and in
              every round of one pass (the pass's own labels and hopeless
              masks), over the mesh ranges too: per round the live rows and
              both kernels' device ms, row-tile visits and longest walk of
              a CTA, with both bounds (the visits' operations, the walk's
              visits one after another on one SM);
              the grid pass and the dense pass stage by stage, end to end
              in turns, peak device memory, launches per pass, a
              torch.profiler pass, and the grid pass under
              set_sync_debug_mode("error"); a device_online=True grid
              stream, every flat-table pass against the host-table grid
              pass on the same tree; the d = 200 point ([wide]'s data): each
              snapshot's partition the dense card pass's, the kernels bit
              for bit the feature-sliced dense routes;
     mesh     the sharded offline pass (mesh=) on cuda:0 named k = 1, 2, 4
              and 8 times (and mesh=True over every card where there are
              several): on the [stream] table (L = 5,243, Lp = 8192) each
              k's pass, dense and grid, from the host table and from a
              device-online capture of the stream's final tree, bit for bit
              the unsharded pass, with no host synchronisation from prepare
              to unwrap; its stages, Borůvka's gathers, end to end in turns
              beside the unsharded pass, launches per pass and peak device
              memory; each shard's strip launches (bubble_cd, mutual_reach,
              grid_core_distances, grid_round_minima; grid_core_distances
              also at every cluster size and through its first kernel) bit
              for bit the same rows of the whole launch, timed one by one
              beside it, and each
              shard's peak memory; the same dense at k = 4 and 8 on a table
              of L = 20,000 bubbles (Lp = 32,768, one W 4 GiB) with the
              per-shard W bytes; then the [stream] configuration cut to
              65,536 points with a mesh of 4, dense and spatial, every
              snapshot and served chunk bit for bit the unsharded engine's,
              the four kernels' launches counted over the mesh engines;
  5. wide     a default StreamingClusterEngine at d = 200 (past the
              register tiles' 128): 65,536 points in blocks of 8192
              (L ~ 1,300, Lp = 2048), then 8192 queries; every snapshot and
              the served rows held to the port's CPU plain pipeline, the
              routes' launch counts checked;
     tenants  benchmarks/fig9_service.py's deployment (d = 8, 4 blobs per
              tenant 12 apart, min_pts 8, epsilon 0.3) at 8 tenants of
              32,768 points (compression 0.02: L ~ 650, Lp = 1024) through
              one TenantRouter on the card, ingested interleaved in blocks
              of 2048; one closed-loop client per tenant, 40 requests of 64
              rows, each answer held to the tenant's direct
              query_detailed; each tenant's final snapshot and served rows
              held to the port's CPU plain pipeline (partition, MST
              weight, bubble indices); per-tenant p50/p99, the worst/best p99, the
              shared cache's builds and hits; save_all, and a cold
              router's recover() serving the same labels;
  6. points   the point-level kernel API (Def. 1 core distances, knn,
              pairwise squared distances, Def. 2 mutual reachability) on
              the first 65,536 points of the stream's mixture, mean-centred:
              knn and core distances at n = m = 65,536, pairwise and
              mutual reachability at 16,384²; each held against its plain
              version over row strips, the knn tie order among copies held
              on a duplicate-heavy table, with kernel / plain / library
              times; knn also bit for bit against the per-lane kernel it
              replaced (65,536² at k = 10, the duplicate table, k = 64),
              timed at k 1, 10, 64, 256 and 1024 (the last two held to the
              plain version), and at k = 2000 through the strip route;
              pairwise and mutual reachability also bit for bit against
              the tile kernels they replaced, timed beside them and the
              card's write rate; then all four calls at d = 200 and 16,384
              points (knn by the strip route), each against its plain
              version, pairwise and mutual reachability also against the
              tile kernels;
  7. attention GQA flash attention at the full attention widths of
              qwen2-1.5b (S = 4096, 12 heads, 2 kv heads, Dh 128, causal,
              bf16 and f32) and h2o-danube-3-4b (S = 8192, 32 heads, 8 kv
              heads, Dh 120, window 4096, bf16), and a ragged case with a
              dead-key tail and fully masked rows; the bf16 cases take the
              tensor-core kernel (csrc/flash_attention_wgmma.cu) and the
              f32 ones the CUDA-core kernel (counted per route); each held
              against the plain version a few heads at a time, with device
              times and the host time of one ops call, and shown to reject
              two wrong outputs; the bf16 cases also held to the first
              tensor-core kernel (flash_attention_mma_v1, mma.sync), its
              readings against the plain version and its time beside; the
              f32 cases also held to the earlier CUDA-core kernel
              (flash_attention_scalar) on the same inputs and timed beside
              it; then bf16 at qwen2-1.5b widths with Dh = 256, which the
              tensor cores refuse, through the CUDA-core kernel, held to
              the plain version and to the earlier kernel, both timed;
     lm       LM serving at published widths: qwen2-1.5b (28 layers,
              d_model 1536, 12/2 heads of 128, d_ff 8960, vocab 151,936,
              random weights from a seed; the parameter count held to the
              reference's) through ServeEngine from its bf16 compute copy:
              8 prompts of 4-16 tokens and one of 6144 (past the flash
              threshold, 6144² > 4096²) on 4 slots of 8192 positions, 12
              greedy tokens each, every request finished; the long prefill
              launches the tensor-core flash kernel once per layer, the
              short prefills and the decode steps none; the long prefill's
              ms and the kernel's share of it, decode ms per step at 4
              slots, tokens/s, peak device memory; layer 0's attention of
              the long prefill through the kernel against the plain
              version ([attention]'s readings); then 2 layers at full
              width in f32 (the CUDA-core route) on 4 equal-length prompts
              of 4160 tokens, the engine's tokens against a teacher-forced
              full prefill; then the ragged case at SMOKE size in f32 on
              the card and on the CPU (plain versions), tokens equal and
              logits within 2e-3 of the largest;
     moe      LM serving for the MoE family at published widths:
              qwen2-moe-a2.7b (24 layers, d_model 2048, 16/16 heads of
              128, 60 routed experts top-4 of width 1408, 4 shared fused
              to 5632, vocab 151,936; the parameter count held to the
              reference's), its bf16 compute copy drawn leaf by leaf
              (models.init_compute_params: no f32 master on the card),
              served as [lm] serves (24 tensor-core launches on the long
              prefill, MHA with a group of 1, none elsewhere); the long
              prefill twice more, bit for bit, with the dropped (token,
              choice) pairs at C = 512 and the most and least loaded
              experts per layer; then dbrx-132b at its published widths
              (d_model 6144, 48/8 heads, 16 experts top-4 of width
              10752) cut to 2 of its 40 layers (the whole model is 263
              GB in bf16), one 6144-token prefill twice, bit for bit, 2
              launches (GQA with a group of 6); layer 0's attention of
              both against the plain version; profiles of a prefill and
              a decode step; the ragged case at SMOKE size in f32 on the
              card and the CPU, as [lm];
     vlm      LM serving for the vision family at published widths:
              llama-3.2-vision-11b (40 layers as 8 groups of 4 self
              blocks and 1 cross block, d_model 4096, 32/8 heads, d_ff
              14336, 1601 media tokens) built leaf by leaf, served as [lm]
              serves with the engine's zero media (the gates start at 0:
              the cross branch adds exactly 0); then one 12,288-token
              prefill with seeded media and every gate at 0.5: 40 causal
              and 8 non-causal tensor-core launches, twice bit for bit,
              the cross branch moving the logits, and at the gates' 0 the
              same bits as with zero media; layer 0's cross-attention
              against the plain version; profiles; the SMOKE replay;
     ssm      LM serving and training for the ssm family at published
              widths: rwkv6-1.6b (24 layers, d_model 2048, 32 heads of
              64, d_ff 7168, vocab 65,536; the parameter count and FLOPs
              a token held to the reference's), its bf16 compute copy
              (RWKV's mixing and decay leaves f32) served as [lm] serves
              with 32 greedy tokens a request (one prompt of 6144 tokens,
              96 chunks of 64), its state the same bytes per slot at
              cache_len 8 and 9000; the long prefill's and a decode
              step's ms, tokens/s, launches, busy share and the WKV
              scan's share under torch.profiler (a record_function range
              around models/rwkv.py::_wkv_chunked); the WKV scan timed on
              layer 0's inputs beside its bound; 4 layers in f32: the
              engine's tokens against a teacher-forced prefill, layer 0's
              WKV at T = 6144 against the serial f64 recurrence; a
              full-width train step at (4, 2048) (median of 3 after a
              warm-up, 6N share, peak memory); at 2 layers in f32 remat
              "none" and "dots" and microbatches=2 against "full" and 1;
              the SMOKE replay against the CPU; every hand-written
              kernel's launches over the phase 0 (no kernel lies on this
              path: the reference's scan is jnp, not Pallas);
     hybrid   LM serving and training for the hybrid family at published
              widths: zamba2-7b (81 layers: 13 groups of 5 Mamba-2 blocks
              and one application of the shared attention block, then 3;
              d_model 3584, the shared block 32/32 heads of 112 and d_ff
              14336, SSD 112 heads of 64 with state 64, vocab 32,000; the
              parameter count and FLOPs a token held to the reference's),
              its bf16 compute copy (A_log, dt_bias and the norms f32)
              served as [lm] serves with 16 greedy tokens a request: the
              6144-token prefill launches the tensor-core flash kernel
              once per application of the shared block (13) at Dh 112,
              the short prefills and the decode steps none; the decode
              state per slot at cache_len 8 and 8192 against the
              reference's; the long prefill's and a decode step's ms,
              tokens/s, launches, busy share and the SSD scan's share
              (a record_function range around models/ssm.py::_ssd_chunked)
              and the flash kernel's under torch.profiler; the first
              application's attention against the plain version; the SSD
              scan timed on layer 0's inputs beside its bound; 9 layers
              in f32: the engine's tokens on 4 equal prompts against a
              teacher-forced prefill, layer 0's SSD at T = 6144 against
              the serial f64 recurrence; 15 layers (2 groups and the tail;
              the whole model does not train on one card) at (1, 8192):
              step ms (median of 3 after a warm-up), tokens/s, 6N share,
              peak memory, the flash launches against the code's
              prediction (per step and application one forward and one
              backward, the shared block not recomputed), the shared
              block's backward at that shape against the plain backward
              and autograd ([train]'s checks); at 9 layers in f32 remat
              "none" and "dots" and microbatches=2 against "full" and 1;
              the SMOKE replay against the CPU;
     audio    LM serving and training for the audio family at published
              widths: whisper-tiny (4 encoder and 4 decoder layers,
              d_model 384, 6/6 heads of 64, d_ff 1536, vocab 51,865, 1500
              frames; the conv front end a stub; the parameter count and
              FLOPs a token held to the reference's), its bf16 compute
              copy (the position tables and norms f32) served as [lm]
              serves with the engine's zero frames, one prompt of 12,288
              tokens on 4 slots of 16,384: the long prefill launches the
              tensor-core flash kernel at Dh 64 for both attentions of
              each decoder layer (causal self 12,288², non-causal cross
              12,288 x 1500), the encoder (1500²), the short prefills and
              the decode steps none; layer 0's two calls against the
              plain version, each timed beside its bound and SDPA's; the
              long prefill's and a decode step's ms, tokens/s, launches
              and busy share under torch.profiler; one encode timed; in
              f32 the decode fed encode(frames) against forward over the
              same tokens on 4 prompts of seeded frames; the whole model
              trained at (1, 16,384) (both attentions on the flash
              kernels) and (4, 2048) (neither): step ms, tokens/s, 6N
              share, peak memory, the flash launches against the code's
              prediction (per step and attention two forwards, with the
              remat recompute, and one backward); the backward at
              (1, 16,384, 6/6, Dh 64) causal and (1, 16,384 x 1500)
              non-causal against the plain backward and autograd
              ([train]'s checks); the SMOKE replay against the CPU; every
              kernel off the flash path launched 0 times;
     train    LM training at published widths: the flash backward at
              qwen2-1.5b's attention (S = 8192, 12/2 heads of 128,
              causal, bf16), danube's (32/8 of 120, window 4096, S =
              8192) and llama-3.2-vision's cross-attention (32/8, 4096 x
              1601, non-causal) on the tensor cores
              (csrc/flash_attention_bwd_mma.cu), a ragged f32 case (dead
              keys, Sq != Sk) and bf16 at Dh 256 on the CUDA cores
              (csrc/flash_attention_bwd.cu), each route checked: against
              the plain backward on the same saved output and
              log-sum-exp and against autograd through the plain forward
              (allowing what Δ from the saved bf16 output moves), the
              tensor-core cases also against the CUDA-core kernel, bit
              for bit on repeat, a causal mask off by one rejected, timed
              beside the plain backward and SDPA's backward (and the
              CUDA-core kernel); then qwen2-1.5b (remat
              "full", bf16 compute over the f32 master, random weights
              from a seed) through make_train_step and AdamW: 4 steps at
              (4, 2048) (the plain _sdpa branch) and 4 at (1, 8192) (the
              flash branch in every layer), the first of each a warm-up,
              then 5 on one constant batch, the loss falling; step ms
              (median and range of 3), tokens/s, the 6N share of the
              bf16 peak, peak memory, the flash launches against the
              code's prediction (per 8192-token step and layer: forward
              and remat recompute on the tensor-core kernel, one
              backward), a profiled step (busy share, the backward's
              share); SMOKE qwen2-1.5b in f32 with the threshold lowered,
              3 steps on the card and the CPU; the trainer CLI's main
              sent SIGTERM in step 6 of 10 and resumed, against an
              uninterrupted run;
     exact    the exact-dynamic engine (exact=True) at a deployment's size:
              16,384 points of the [stream] mixture (d = 16, min_pts 10),
              the first rebuild's shrink to Np = 32,768 slots, then 48
              alternating insert and delete blocks of 256 (1.6 % of n,
              incremental): after every block the maintained state against
              a rebuild from scratch (knn_dst and cd bit for bit, knn_idx
              but for ties at the K-th distance, MST weight within 1e-6,
              the partition), every eighth block the update also through
              the plain versions on the card (bit for bit), every fourth a
              4096-row query_detailed chunk against the rebuilt snapshot;
              one insert block of 1024 (routed full), an overflow drill
              (rk_cap = s_cap = 8); the stream replayed at 2048 points in
              blocks of 32 on the card and on the CPU (versions,
              partitions, MST weight, bitwise cd / knn_dst rows); insert
              and delete ms at blocks of 64, 256, 819 and 1638 against a
              rebuild (the crossover), the hierarchy-only refresh and its
              stage split (single_linkage, condense, extract), the
              query p50, peak memory (also of an insert through the first
              route, SW and smask built), no host read in an update body or
              a refresh before its unwrap (set_sync_debug_mode); the strip
              distances and top-k (csrc/strip_tiles.cu) bit for bit their
              plain versions and their first kernels (csrc/dynamic.cu) at
              the stream's shapes (tie-free, an integer grid, a ragged Np,
              a row slice and a row view off 16 bytes, the rebuild's
              square, K = 10, 100, 2000), timed in turns with the first
              kernels, beside the plain versions, cdist (also on the
              square) and topk, with both bounds of the distances (bytes,
              and 3·U·Np·d FP32 instructions at half the FMA peak); one
              insert block and one rebuild through the new and the first
              strip kernels (states equal, walls in turns, the strip
              launches' device time by CUDA events); the round minima
              from the strip's factors (csrc/strip_minima.cu, the update's
              route) on one insert block's captured strip (5,376 x 32,768)
              bit for bit its plain version and the first kernel
              (csrc/dynamic.cu) fed the SW and smask built from the same
              factors, in round 1, at ~1000-slot components and at one
              component, with all rows valid and with the stream's rows,
              and with every slot live; timed (CUDA events and
              torch.profiler's device time) beside the first kernel and
              the bound; every round of the insert's
              Borůvka; that Borůvka through both routes (buffers equal,
              walls in turns, the strip kernels' device time) and the
              insert's state through both routes, equal;
     summarizer the online–offline summarizer (core/summarizer.py) at the
              [stream] configuration: the same 262,144 points inserted into
              its host tree in blocks of 8192, a quarter deleted in blocks,
              then cluster() three times on the card (the first split into
              to_bubbles, the W kernels, W's copy home, the host hdbscan and
              assign_points): bubble_cd and mutual_reach launched once per
              cluster(), assign in every one, no plain version on the card;
              the bubble partition and MST weight against the CPU backend's
              on the same bubbles, assignment indices identical outside
              near-ties, NMI >= 0.95 against the numpy route, NMI against
              the mixture's ground truth printed; insert and delete ms per
              1k points, peak device memory;
     examples the port's five examples (examples/torch_quickstart.py,
              torch_streaming_service.py, torch_dynamic_vs_static.py,
              torch_serve_batched.py, torch_train_lm_with_curation.py), on
              the card, each in its own process, started together: each
              must exit 0 with OK as its last line;
  8. the kernels JSON line (launches on each kernel's own path, errors,
     times, bounds; assign with the per-lane kernel's time as lane_ms,
     mutual_reach and pairwise with the tile kernel's as tile_ms;
     flash_attention with the qwen2-1.5b f32 case and the earlier
     CUDA-core kernel's time as scalar_ms, flash_attention_mma (source
     csrc/flash_attention_wgmma.cu) with the qwen2-1.5b bf16 case and
     every layer-0 reading's plain time and the first tensor-core
     kernel's as <run>_plain_ms / <run>_v1_ms; flash_attention_mma_v1
     (csrc/flash_attention_mma.cu, its oracle, launched on no path) with
     its own numbers on the qwen2-1.5b bf16 case; both also with their [lm] launches as
     launches_lm and layer 0's call there as lm_ms / lm_bound_ms, their
     launches on [moe]'s serve and dbrx prefill as launches_moe /
     launches_dbrx and on [vlm]'s serve and 12,288-token prefill as
     launches_vlm / launches_vlm_long, flash_attention_mma also with
     layer 0's call on the three new routes as moe_ms / moe_bound_ms
     (MHA), dbrx_ms / dbrx_bound_ms (GQA, a group of 6) and vlm_ms /
     vlm_bound_ms (the non-causal cross-attention);
     single_linkage, condense and extract, which stand for the JAX
     package's three hierarchy scans, and eom, extract_v1's EOM
     kernel (launched on no path since extract took its place), with the stage's time
     as stage_ms and the latency floor as latency_floor_ms (null for
     condense, which has no chain of dependent steps), single_linkage and
     condense with the first version's time as v1_ms and both times at
     the 32,768 chain as chain; flat_scatter,
     which stands for the segment sums of device-online ingest, with its
     launches from [online] and one launch's time as launch_ms;
     grid_assign, grid_core_distances and grid_round_minima, which stand
     for the JAX package's grid-pruned jnp searches, with their launches
     from [grid] and the visited share as visited_share;
     grid_assign (source csrc/grid_assign.cu) also with its cluster size,
     v1_ms (the first kernel alone in the same turns), the whole call's
     call_ms, v1_call_ms and host_ms, its own visits (kernel_visits,
     extra_visits), the longest walks (walk, v1_walk), the profiled call's
     call_launches, and the query shape's numbers as query;
     grid_assign_v1 (csrc/grid.cu, its oracle, launched on no path) with
     its ingest-shape numbers and launches_oracle;
     grid_core_distances (source csrc/grid_cd.cu) also with its cluster
     size, v1_ms (the first kernel alone in the same turns), its own visits
     (kernel_visits), the longest walks (walk, v1_walk, walk_c1) and the
     numbers at min_pts 100 and 2000 (min_pts_100, min_pts_2000);
     grid_core_distances_v1 (csrc/grid.cu, its oracle, launched on no
     path) with its min_pts 10 numbers and launches_oracle;
     grid_round_minima (source csrc/grid_round.cu) also with its cluster
     size, v1_ms (the first kernel's round-1 call in the same turns), one
     pass's device ms over its rounds for the new kernel, the first and the
     new at one CTA a block (pass_ms, v1_pass_ms, c1_pass_ms) and the
     rounds' ms (rounds_ms, v1_rounds_ms); grid_round_minima_v1
     (csrc/grid.cu, its oracle, launched on no path) with its round-1
     numbers and launches_oracle; strip_dists,
     strip_topk and strip_round_minima_from_dists, which stand for the JAX
     package's jnp strip programs of the exact-dynamic path, with their
     launches from [exact] (the round minima on the stream's round 1 with
     its device time, first_ms for the first kernel on the same inputs,
     full_ms / full_bound_ms with every row and slot live, the device time
     of every round and of one insert's Borůvka
     through both routes; the distances with v1_ms, the first kernel's
     time, their bytes and instruction bounds, the square's times and
     bound and cdist's time there, and the insert's and the rebuild's
     walls and strip-kernel device times through both kernels as insert
     and rebuild; the top-k with v1_ms and its times at K = 100 and 2000),
     and strip_round_minima, strip_dists_v1 and strip_topk_v1, the first
     versions, launched on no path (launches_oracle: their launches as the
     oracles);
     bubble_cd, mutual_reach, grid_core_distances and
     grid_round_minima also with launches_mesh, their launches on [mesh]'s
     mesh engines; assign, bubble_cd and mutual_reach also with
     launches_summarizer, their launches over [summarizer]'s cluster()
     calls; flash_attention_bwd, the backward, which stands for JAX's
     autodiff of its jnp online softmax: its source the tensor-core
     kernel and simt_source the CUDA-core one, with [train]'s launches in
     all, launches_mma and launches_simt, qwen2-1.5b's shape as its
     numbers (the tensor-core kernel's, backward_route "mma"; simt_ms and
     simt_reading the CUDA-core kernel's time and its reading against it
     on the same call),
     bound_f32_ms beside the bound at the bf16 peak, train_step_ms (the
     median of the timed steps at
     (1, 8192)) with train_step_ms_min and _max, and train_bwd_share; the
     two forward flash entries also with launches_train; the two forward
     flash entries with [hybrid]'s launches on its serve and its training
     steps as launches_hybrid and launches_hybrid_train, and
     flash_attention_mma with the shared block's call at Dh 112 as
     hybrid_ms / hybrid_bound_ms; flash_attention_bwd with
     launches_hybrid_train and the shared block's backward at (1, 8192)
     as hybrid_ms, hybrid_bound_ms, hybrid_plain_ms, hybrid_library_ms and
     hybrid_max_abs_err; the two forward flash entries with [audio]'s
     launches on its serve as launches_audio and on its training steps as
     launches_audio_train_1x16384 and launches_audio_train_4x2048,
     flash_attention_mma with layer 0's Dh 64 calls as audio_ms /
     audio_bound_ms / audio_library_ms / audio_max_abs_err (causal self)
     and audio_cross_* (non-causal cross), flash_attention_bwd with the
     same training launches and the backward at whisper's two shapes as
     audio_* and audio_cross_* (ms, bound_ms, plain_ms, library_ms,
     max_abs_err); every layer-0 reading of a forward flash entry with
     SDPA's time on the same call as <run>_library_ms);
  9. the last line: {"ok": true, "device": {...}}.

Exits non-zero, with no result line, without a GPU, outside a checkout
of the repository, or when any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20241209
DIM = 16
N_POINTS = 262_144
BLOCK = 8192
COMPRESSION = 0.02
MIN_PTS = 10
EPSILON = 0.2
N_QUERIES = 65_536
QUERY_CHUNK = 4096
LP = 8192  # the offline bucket the stream reaches, and the kernels' check size
CHAIN_LP = 32_768  # [kernels] hierarchy: a chain and a comb this long, the exact refresh's bucket (state in scratch)
RTOL = 1e-5
N_KNN = 65_536  # [points]: knn and core distances at n = m
N_PAIR = 16_384  # [points]: pairwise and point mutual reachability (1 GiB each)
STRIP = 4096  # rows per strip of a plain version on the card
KNN_SWEEP = (1, 10, 64, 256, 1024)  # [points]: k = 1 nearly skips selection; above 64 the per-lane kernel cannot
BCD_SWEEP = (1, 10, 100, 1024)  # [kernels]: the same for min_pts
K_STRIP = 2000  # [points], [min_pts]: k and min_pts past the warp-select core's 1024 (strip route)
MIN_PTS_PASSES = ((100, "ws"), (K_STRIP, "strip"))  # [min_pts]: past the per-lane kernel's 64, past 1024
WIDE_DIM = 200  # [kernels], [points], [wide]: d past the warp-select core's 128
N_WIDE = 65_536  # [wide]: points of the d = 200 stream (compression 0.02: L ~ 1,300, Lp = 2048)
N_WIDE_QUERIES = 8192
N_WIDE_POINTS = 16_384  # [points] at d = 200: knn, core distances, pairwise, mutual reachability
# [attention]: (label, B, S, H, KV, Dh, window, dtype, dead keys at the head, dead keys at the tail)
SERVE_THREADS, SERVE_REQUESTS, SERVE_ROWS = 8, 32, 512  # [serve]: callers, requests each, rows per request
SERVE_MAX_BATCH = 4096
# [tenants]: benchmarks/fig9_service.py's deployment (d = 8, 4 blobs per tenant, min_pts 8, epsilon 0.3) at a size a
# service holds per tenant: compression 0.02 gives L ~ 650 (Lp = 1024) per tenant
TENANTS, TENANT_DIM, TENANT_POINTS, TENANT_BLOCK = 8, 8, 32_768, 2048
TENANT_COMPRESSION, TENANT_MIN_PTS = 0.02, 8
TENANT_REQUESTS, TENANT_ROWS = 40, 64
ATTENTION = (
    ("qwen2-1.5b bf16", 1, 4096, 12, 2, 128, None, "bf16", 0, 0),
    ("qwen2-1.5b f32", 1, 4096, 12, 2, 128, None, "f32", 0, 0),
    ("h2o-danube-3-4b bf16", 1, 8192, 32, 8, 120, 4096, "bf16", 0, 0),
    ("ragged f32", 2, 3001, 12, 2, 128, None, "f32", 5, 37),
)

# published peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12
# the hierarchy sweeps' latency floor: one dependent shared-memory round trip per step, ~30 cycles on Hopper,
# at the H100 SXM's 1.98 GHz boost clock
SMEM_ROUND_TRIP_S = 30 / 1.98e9
EPS32 = float(np.finfo(np.float32).eps)
# register-tile sources whose ptxas report [build] checks: knn_ws.cu and bubble_cd_ws.cu, 24 instantiations
# each (D in {16, 32, 64, 128} x K in {32, ..., 1024}); assign_ws.cu, 4 (D) + the wide kernel + its combine;
# dist_panel.cu, the panel for pairwise (D = 0) and mutual_reach (D = 1) + the norm pass;
# flash_attention_panel.cu, 8 (head-dim bucket D in {32, 64, 128, 256} x element bits K in {32, 16})
WS_SOURCES = ("knn_ws.cu", "bubble_cd_ws.cu", "assign_ws.cu", "dist_panel.cu", "flash_attention_panel.cu",
              "grid.cu", "grid_round.cu", "grid_cd.cu", "flash_attention_bwd.cu", "flash_attention_bwd_mma.cu",
              "flash_attention_wgmma.cu")  # the grid's and the wgmma kernel's: by name, not checked for spills
GRID_ROUND_INSTANTIATIONS = 5  # grid_round.cu: compiled widths 16, 32, 64, 128 and the feature-slice kernel
GRID_ASSIGN_INSTANTIATIONS = 5  # grid_assign.cu: the same widths
GRID_CD_REG_INSTANTIATIONS = 10  # grid_cd.cu's register route: the same widths x lists of 12 and 16 slots
GRID_CD_WS_INSTANTIATIONS = 6  # grid_cd.cu's warp-select route: the queues 32 ... 1024
# flash_attention_wgmma.cu: head-dim bucket {64, 128}; 384 threads at 168 registers (the launch bound's share),
# of which setmaxnreg moves the producer warpgroup to 40 and the two consumer warpgroups to 232: 128 x 40 + 256 x 232
# = 384 x 168, so a launch at any other count could leave a consumer's raise waiting
FWD_INSTANTIATIONS, FWD_REGISTERS = 2, 168
WS_INSTANTIATIONS = 48 + 6 + 3 + 8
# flash_attention_bwd.cu: {f32, bf16} x head-dim bucket {64, 128, 256} x {dK/dV, dQ}, and the pre-pass per dtype;
# flash_attention_bwd_mma.cu: bf16 x head-dim bucket {64, 128} x {dK/dV, dQ}, and its pre-pass
BWD_INSTANTIATIONS = 2 * 3 * 2 + 2 + 2 * 2 + 1
FLASH_BUCKETS = (32, 64, 128, 256)
# [attention]: bf16 on the CUDA-core route at qwen2-1.5b's widths with Dh past the tensor-core kernel's 128
SIMT_BF16 = ("qwen2-1.5b Dh256 bf16", 1, 4096, 12, 2, 256)
# [lm]: qwen2-1.5b at its published widths (configs/qwen2_1_5b.py, random weights from a seed) through ServeEngine:
# LM_SHORT ragged prompts of 4-16 tokens and one of LM_LONG tokens, past the flash threshold (6144² > 4096²), on
# LM_SLOTS slots of LM_CACHE_LEN positions, LM_NEW greedy tokens each
LM_ARCH = "qwen2-1.5b"
LM_PARAMS = 1_543_714_304  # the reference's count_params(abstract_params(cfg)), run on a CPU
LM_SLOTS, LM_CACHE_LEN, LM_NEW = 4, 8192, 12
LM_SHORT, LM_LONG, LM_LONG_AT = 8, 6144, 2
# [lm] the f32 route: LM_F32_LAYERS layers at full width in f32, equal-length prompts past the threshold
LM_F32_LAYERS, LM_F32_BATCH, LM_F32_PROMPT, LM_F32_NEW = 2, 4, 4160, 4
LM_LOGIT_RTOL = 2e-3  # f32 logits against another run, relative to the largest (tests/test_torch_lm.py's bound)
# [moe]: qwen2-moe-a2.7b at its published widths (configs/qwen2_moe_a2_7b.py: 24 layers, d 2048, 16/16 heads, 60
# routed experts top-4 of width 1408, 4 shared fused to 5632), built leaf by leaf into its bf16 compute copy and
# served as [lm] serves; then dbrx-132b at its published widths (d 6144, 48/8 heads, 16 experts top-4 of width
# 10752) cut to DBRX_LAYERS of its 40 layers (a layer is ~3.3 G parameters, the whole model 263 GB in bf16: one
# card holds 80), one DBRX_LONG-token prefill
MOE_ARCH, MOE_PARAMS, MOE_CAPACITY = "qwen2-moe-a2.7b", 14_315_735_040, 512  # C at the 6144-token prefill
DBRX_ARCH, DBRX_PARAMS, DBRX_LAYERS, DBRX_LONG = "dbrx-132b", 131_596_523_520, 2, 6144
# [vlm]: llama-3.2-vision-11b (configs/llama_3_2_vision_11b.py: 8 groups of 4 self blocks and 1 cross block, d
# 4096, 32/8 heads, d_ff 14336, 1601 media tokens) served as [lm] serves with the engine's zero media; then one
# VLM_LONG-token prefill with seeded media and the cross-attention gates at VLM_GATE: self-attention 12,288² and
# cross-attention 12,288 x 1601 = 19.7 M both past the flash threshold (4096² = 16.8 M)
VLM_ARCH, VLM_PARAMS, VLM_LONG, VLM_GATE = "llama-3.2-vision-11b", 10_110_734_344, 12_288, 0.5
# [ssm]: rwkv6-1.6b at its published widths (configs/rwkv6_1_6b.py: 24 layers, d_model 2048, 32 heads of 64, d_ff 7168,
# vocab 65,536; random weights from a seed), its bf16 compute copy drawn leaf by leaf, served as [lm] serves (LM_SHORT
# prompts of 4-16 tokens and one of LM_LONG = 96 chunks of 64, on LM_SLOTS slots) with SSM_NEW greedy tokens each
SSM_ARCH, SSM_PARAMS, SSM_FLOPS, SSM_NEW = "rwkv6-1.6b", 1_599_823_872, 8_793_636_864, 32
# the leaves that stay f32 in the compute copy (models/rwkv.py casts each where it reads it)
SSM_F32_LEAVES = ("mu", "maa_w1", "maa_w2", "decay_mu", "decay_w1", "decay_w2", "bonus_u")
# [ssm] f32 at full width, SSM_F32_LAYERS layers: the engine's greedy tokens against a teacher-forced prefill (every
# prefix within one chunk of 64: the longest prompt and its new tokens make 41 + 15 = 56), and layer 0's WKV at
# T = LM_LONG against the serial f64 recurrence within SSM_WKV_RTOL of the largest |o| and |S|
SSM_F32_LAYERS, SSM_F32_PROMPTS, SSM_F32_NEW, SSM_WKV_RTOL = 4, (8, 17, 30, 41), 16, 1e-4
# [ssm] training: a full-width step at SSM_TRAIN (remat "full"), TRAIN_TIMED_STEPS steps, the first a warm-up; then
# SSM_CUT_LAYERS layers at full width in f32 at SSM_CUT: remat "none" and "dots" and microbatches=2 against "full"
# and 1 (tests/test_torch_train.py's bounds: the remat losses equal and the leaves within SSM_REMAT_RTOL in relative
# norm, microbatches' loss within 1e-6 relative and its leaves within SSM_MICRO_RTOL)
SSM_TRAIN, SSM_CUT_LAYERS, SSM_CUT = (4, 2048), 2, (4, 256)
SSM_REMAT_RTOL, SSM_MICRO_RTOL = 1e-6, 1e-5
# [hybrid]: zamba2-7b at its published widths (configs/zamba2_7b.py: 81 layers = 13 groups of 5 Mamba-2 blocks and
# one application of the shared attention block, then a tail of 3; d_model 3584, the shared block 32/32 heads of 112
# and d_ff 14336; SSD 112 heads of 64, state 64; vocab 32,000; random weights from a seed), its bf16 compute copy
# drawn leaf by leaf, served as [lm] serves (LM_SHORT prompts of 4-16 tokens and one of LM_LONG = 96 chunks, past the
# flash threshold in each of the 13 applications) with HYB_NEW greedy tokens each; the decode state per slot at
# cache_len 8 and 8192 (the reference's jax.eval_shape of init_cache(1, n), run on a CPU)
HYB_ARCH, HYB_PARAMS, HYB_FLOPS, HYB_NEW = "zamba2-7b", 5_737_416_000, 48_533_872_512, 16
HYB_STATE_BYTES = {8: 129_248_308, 8192: 1_654_484_020}
# the leaves that stay f32 in the compute copy (models/ssm.py reads them in f32)
HYB_F32_LEAVES = ("A_log", "dt_bias")
# [hybrid] f32 at full width, HYB_F32_LAYERS layers (1 group + the tail): HYB_F32_BATCH prompts of HYB_F32_PROMPT
# tokens (one position for every row: the engine decodes every row at the largest position, which RoPE sees) and
# HYB_F32_NEW greedy tokens each against a teacher-forced prefill (every prefix within one chunk of 64); layer 0's
# SSD at T = LM_LONG against the serial f64 recurrence within HYB_SSD_RTOL of the largest |y| and |h|
HYB_F32_LAYERS, HYB_F32_BATCH, HYB_F32_PROMPT, HYB_F32_NEW, HYB_SSD_RTOL = 9, 4, 40, 16, 1e-4
# [hybrid] training: HYB_TRAIN_LAYERS layers at full width (2 groups + the tail; the whole model's f32 master, its
# gradients and AdamW's two moments are ~92 GB) at HYB_TRAIN, remat "full", TRAIN_TIMED_STEPS steps, the first a
# warm-up; the shared block's backward at that shape against the plain backward (train_bwd_case); then
# HYB_F32_LAYERS layers in f32 at SSM_CUT: remat "none" and "dots" and microbatches=2 against "full" and 1
HYB_TRAIN_LAYERS, HYB_TRAIN = 15, (1, 8192)
# microbatches=2 against 1 at HYB_F32_LAYERS layers in f32: the two batch shapes take other cuBLAS kernels, whose f32
# roundings over reductions of up to 14,336 terms reach ~1.3e-5 of each leaf's norm, alike over the leaves (every
# leaf 0.9e-5 to 1.3e-5 on the card; rwkv6-1.6b's 2 layers of at most 7168: 4.3e-6); the loss stays within 1e-6
HYB_MICRO_RTOL = 5e-5
HYB_BWD = ("zamba2-7b shared block bf16", 1, 8192, 8192, 32, 32, 112, True, None, "bf16", 0, 0)
# [audio]: whisper-tiny at its published widths (configs/whisper_tiny.py: 4 encoder and 4 decoder layers, d_model
# 384, 6/6 heads of 64, d_ff 1536, vocab 51,865, 1500 frames, 32,768 decoder positions; the conv front end a stub, the
# encoder takes frame embeddings; random weights from a seed), its bf16 compute copy drawn leaf by leaf, served as
# [lm] serves (LM_SHORT prompts of 4-16 tokens and one of AUD_LONG tokens on LM_SLOTS slots of AUD_CACHE_LEN) with the
# engine's zero frames: the long prefill's causal self-attention (12,288²) and cross-attention (12,288 x 1500) are
# both past the flash threshold (4096² = 16.8 M) at Dh 64 in each of the 4 decoder layers, the encoder's 1500² under
# it; the counts are the reference's count_params(abstract_params(cfg)) and model_flops_per_token, run on a CPU
AUD_ARCH, AUD_PARAMS, AUD_FLOPS = "whisper-tiny", 49_646_592, 297_879_552
AUD_LONG, AUD_CACHE_LEN = 12_288, 16_384
# [audio] f32 at full width: AUD_F32_BATCH prompts of AUD_F32_PROMPT tokens over seeded non-zero frames, AUD_F32_NEW
# greedy tokens through decode fed encode(frames) against forward over the prompt and those tokens (teacher
# forcing): every step's logits within AUD_TEACHER_RTOL of the largest (tests/test_torch_audio.py's bound: decode
# reads the K/V rounded into the bf16 cache, forward f32 ones; 8.5e-4 at full width on a CPU), the same tokens
AUD_F32_BATCH, AUD_F32_PROMPT, AUD_F32_NEW, AUD_TEACHER_RTOL = 4, 40, 16, 5e-3
# [audio] training at full width and depth (remat "full"), TRAIN_TIMED_STEPS steps at each (B, S), the first a
# warm-up: at (1, 16,384) both attentions of each decoder layer take the flash kernels, at (4, 2048) neither
AUD_TRAIN = ((1, 16_384), (4, 2048))
AUD_BWD = (("whisper-tiny self bf16", 1, 16_384, 16_384, 6, 6, 64, True, None, "bf16", 0, 0),
           ("whisper-tiny cross bf16", 1, 16_384, 1500, 6, 6, 64, False, None, "bf16", 0, 0))
AUD_SMOKE_LONG = 40  # the SMOKE replay's long prompt: its 64 decoder positions hold it and LM_NEW tokens
# [train]: qwen2-1.5b at its published widths (configs/qwen2_1_5b.py: remat "full", bf16 compute over the f32
# master, random weights from a seed) trained through make_train_step and AdamW: TRAIN_TIMED_STEPS steps at
# TRAIN_SHORT, the plain _sdpa branch (2048² <= 4096²), and at TRAIN_LONG, the flash branch in every layer, the first
# of each a warm-up and the rest timed (median, min-max); then 1 + TRAIN_CONST_STEPS steps on one constant batch at
# TRAIN_LR with no warmup, the loss falling
TRAIN_SHORT, TRAIN_LONG = (4, 2048), (1, 8192)
TRAIN_TIMED_STEPS, TRAIN_CONST_STEPS, TRAIN_LR = 4, 4, 1e-3
# [train]: the backward kernel's checks: (label, B, Sq, Sk, H, KV, D, causal, window, dtype, dead keys at the head,
# dead keys at the tail); with Sq < Sk and causal the queries are the last Sq positions
TRAIN_BWD = (
    ("qwen2-1.5b bf16", 1, 8192, 8192, 12, 2, 128, True, None, "bf16", 0, 0),
    ("h2o-danube-3-4b bf16", 1, 8192, 8192, 32, 8, 120, True, 4096, "bf16", 0, 0),
    ("ragged f32", 2, 3001, 3100, 12, 2, 128, True, None, "f32", 5, 37),
    ("llama-3.2-vision-11b cross bf16", 1, 4096, 1601, 32, 8, 128, False, None, "bf16", 0, 0),
    ("qwen2-1.5b Dh256 bf16", 1, 4096, 4096, 12, 2, 256, True, None, "bf16", 0, 0),
)
# [train] CPU replay: SMOKE qwen2-1.5b in f32 at (B, S), S² past the lowered threshold 64², steps on both devices
TRAIN_SMOKE_SHAPE, TRAIN_SMOKE_STEPS = (2, 96), 3
TRAIN_REPLAY_LOSS_RTOL = 1e-4  # f32 losses of the card and the CPU (grad norms 10x): summation order, then Adam
TRAIN_CLI_RTOL = 1e-4  # the resumed CLI's losses against the uninterrupted run's, relative
# [exact]: the exact-dynamic engine (exact=True) at a deployment's size: the [stream] mixture at d = 16, min_pts 10,
# EXACT_N live points (the first rebuild's shrink gives Np = 32,768 slots), EXACT_BLOCKS alternating insert and
# delete blocks of EXACT_BLOCK points (1.6 % of n: incremental), one insert block of EXACT_FULL_BLOCK (6.25 %: full)
EXACT_N = 16_384
EXACT_BLOCK = 256
EXACT_BLOCKS = 48
EXACT_FULL_BLOCK = 1024
EXACT_SMALL_DELETES = (4, 16)  # delete blocks small enough (0.1 % of n) that S' stays within s_cap: the
# incremental delete rule itself (blocks of 256 strand more than s_cap = Np/4 survivors and rebuild)
EXACT_QUERY_EVERY = 4  # a QUERY_CHUNK-row query_detailed chunk after every fourth block
EXACT_PLAIN_EVERY = 8  # the update also through the plain versions on the card, bit for bit
EXACT_CPU = (2048, 32, 12)  # the CPU replay: points, block, blocks (engines, then handles with s_cap = Np)
EXACT_TIMED_BLOCKS = (16, 64, 256, 819, 1638)  # 0.1 %, 0.4 %, 1.6 %, 5 % and 10 % of EXACT_N
EXACT_TOPK = (MIN_PTS, 100, K_STRIP)  # strip_topk's K: the path's, and past the 1024 queue
EXACT_KERNELS = ("strip_dists", "strip_topk", "strip_round_minima_from_dists")  # the update's path
MINIMA_INSTANTIATIONS = 3  # strip_minima.cu: the tile kernel with and without 16-byte loads, and the merge
# the round minima's label sets at the stream's strip: round 1 (every slot alone), components of ~1000 slots, one
EXACT_MINIMA_LABELS = ("round 1", "~1000-slot components", "one component")
NEW_MINIMA = ("minima_tile_kernel", "minima_merge_kernel")  # the kernels of the two round-minima launches
STRIP_ORACLES = ("strip_dists_v1", "strip_topk_v1")  # csrc/dynamic.cu's first strip kernels: oracles on no path
STRIP_INSTANTIATIONS = 1 + 6  # strip_tiles.cu: the distance tile, the top-k at each warp queue 32 ... 1024
OLD_MINIMA = ("round_rows_kernel", "round_cols_kernel")
SUMMARIZER_KERNELS = ("assign", "bubble_cd", "mutual_reach")
SUMMARIZER_NMI = 0.95  # [summarizer]: against the numpy route (tests/test_summarizer.py's contract)
EXAMPLES = ("torch_quickstart.py", "torch_streaming_service.py", "torch_dynamic_vs_static.py", "torch_serve_batched.py",
            "torch_train_lm_with_curation.py")
EXAMPLE_TIMEOUT_S = 300


def say(*parts):
    print(*parts, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def mixture(rng, n, k=20, spread=3.0, dim=DIM, labels=False):
    """A seeded Gaussian mixture (d = 16 by default): k unit-variance blobs
    whose centres are N(0, spread²) per coordinate; with ``labels`` also
    each row's blob."""
    centres = rng.normal(scale=spread, size=(k, dim))
    blob = rng.integers(0, k, size=n)
    X = centres[blob] + rng.normal(size=(n, dim))
    return (X, blob) if labels else X


def time_ms(fn, reps=10, warm=2):
    """Mean device time of one call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=10):
    """The device time of one call of ``fn``: CUDA events around ``reps``
    calls queued behind a spin kernel (``torch.cuda._sleep``), so that the
    host has enqueued them all before the device reaches the first event
    and the device never waits for the host between them (``time_ms``
    counts those waits when a call's host work outlasts its kernels).  The
    spin is lengthened until the first event is still pending once the
    last call is enqueued."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    spin = 4 * reps * (time.perf_counter() - t0) + 1e-3  # seconds
    torch.cuda.synchronize()
    for _ in range(4):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * 2e9))  # cycles; the SM clock is at most ~2 GHz
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = not a.query()
        torch.cuda.synchronize()
        if ahead:
            return a.elapsed_time(b) / reps
        spin *= 4
    raise RuntimeError("device_ms: the host could not get ahead of the device")


def host_ms(fn, reps=20):
    """Host time to enqueue one call (no synchronisation inside): the part
    of ``time_ms``'s first call that the device does not overlap."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def fill_ms(n: int, m: int) -> float:
    """The card's realised write rate at an (n, m) f32 output: the time of
    ``torch.empty(n, m).fill_(0.5)`` (a yardstick of what the byte bound
    can reach, not a library call of the same function)."""
    import torch

    return time_ms(lambda: torch.empty(n, m, device="cuda").fill_(0.5), reps=20)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sq_tol(x, y) -> float:
    """The cancellation bound on an f32 squared distance between rows of x
    and y (d features) computed in the expanded form by two different
    summation orders: δ(r²) = γ·(max‖x‖² + max‖y‖²) with γ = max(16, d)·ε/2,
    the worst-case rounding of a d-term dot product (Higham), which is 8ε
    at the main path's d = 16."""
    d = x.shape[1]
    return max(16, d) / 2 * EPS32 * float((x * x).sum(1).max() + (y * y).sum(1).max())


def dist_tol(x, y, r):
    """Elementwise allowance for an f32 distance r between rows of x and y:
    1e-5 relative plus δ(r) = min(√δ(r²), δ(r²)/2r), δ(r²) = sq_tol(x, y)."""
    import torch

    dsq = sq_tol(x, y)
    floor = torch.minimum(torch.full_like(r, dsq**0.5), dsq / (2 * r.clamp_min(1e-30)))
    return RTOL * r.abs() + floor


def compare(name, got, want, tol):
    """Hold ``got`` to ``want`` within ``tol`` (+inf must match +inf)."""
    import torch

    inf_g, inf_w = torch.isinf(got), torch.isinf(want)
    check(bool(torch.equal(inf_g, inf_w)), f"{name}: +inf positions differ")
    fin = ~inf_w
    err = (got[fin] - want[fin]).abs()
    bad = int((err > tol[fin]).sum())
    rel = float((err / want[fin].abs().clamp_min(1e-30)).max()) if err.numel() else 0.0
    check(bad == 0, f"{name}: {bad} elements outside tolerance")
    return float(err.max()) if err.numel() else 0.0, rel


def tie_free_rows(q, reps, sites=None):
    """Rows of q whose best and second-best squared distance to the table
    (or to its distinct ``sites``) differ by more than 64× the f32
    rounding of the expanded form — no near-tie rounding can flip."""
    import torch

    from repro_torch.kernels import ref

    table = reps if sites is None else sites
    sq = ref.pairwise_sqdist(q, table)
    two = torch.topk(sq, 2, dim=1, largest=False).values
    noise = 64 * EPS32 * ((q * q).sum(1) + float((table * table).sum(1).max()))
    keep = (two[:, 1] - two[:, 0]) > noise
    return q[keep], int((~keep).sum())


def direct_core_distances(rep, nb, ext, rows=256):
    """Eq. 6 by the plain sort + cumulative mass over distances in the
    direct-difference form √Σ(x−y)², ``rows`` table rows at a time.  Exact
    copies of a row are exactly 0 apart here, as in the kernel, so the
    (d, j) order among copies is the index order on both sides.  The
    yardstick of the duplicate-order check only."""
    import torch

    from repro_torch.kernels import ref

    out = []
    for i in range(0, rep.shape[0], rows):
        blk = rep[i : i + rows]
        d = (blk[:, None, :] - rep[None, :, :]).square().sum(-1).sqrt()
        ids = torch.arange(i, i + blk.shape[0], device=rep.device)
        out.append(ref.bubble_core_distances_from_dm(d, ids, nb, ext, MIN_PTS, DIM))
    return torch.cat(out)


def clear_crossings(rep, nb, min_pts, rows=1024):
    """Rows whose Eq. 6 crossing is not a near-tie: the crossing entry's
    squared distance is apart from its neighbours in the sorted row by more
    than 64× the f32 rounding of the expanded form, so no rounding can
    change the crossing bubble or the mass ahead of it.  Masses are whole,
    so the f64 cumulative mass here equals the f32 one."""
    import torch

    from repro_torch.kernels import ref

    yy = float((rep * rep).sum(1).max())
    out = []
    for i in range(0, rep.shape[0], rows):
        q = rep[i : i + rows]
        sq = ref.pairwise_sqdist(q, rep).double()
        own = torch.arange(q.shape[0], device=rep.device)
        sq[own, i + own] = 0.0
        v, order = torch.sort(sq, dim=1, stable=True)
        c = torch.argmax((torch.cumsum(nb.double()[order], dim=1) >= min_pts).to(torch.int8), dim=1)[:, None]
        noise = 64 * EPS32 * ((q * q).sum(1).double() + yy)
        at = v.gather(1, c)[:, 0]
        lo = v.gather(1, (c - 1).clamp_min(0))[:, 0]
        hi = v.gather(1, (c + 1).clamp_max(v.shape[1] - 1))[:, 0]
        out.append(((at - lo > noise) | (c[:, 0] == 0)) & (hi - at > noise))
    return torch.cat(out)


def ptxas_ws(log: str) -> dict:
    """{(kernel, D, K): (registers, stack bytes, spill stores, spill loads)}
    of the register-tile kernels in an ``nvcc -Xptxas -v`` log (D and K 0
    where the kernel has no such template argument; D of dist_panel is its
    bool, 1 for mutual_reach; flash_panel's D is its head-dim bucket and K
    the element's bits, 32 for f32 and 16 for bf16)."""
    import re

    def entry(line):
        m = re.search(r"Compiling entry function '\S*?(knn_ws|bubble_cd_ws|assign_ws|assign_wide|assign_combine"
                      r"|dist_panel|dist_norms)_kernel(?:IL[ib](\d+)E(?:Li(\d+)E)?)?", line)
        f = re.search(r"Compiling entry function '\S*?flash_panel_kernelI(f|13__nv_bfloat16)Li(\d+)E", line)
        if m:
            return m.group(1), int(m.group(2) or 0), int(m.group(3) or 0)
        return ("flash_panel", int(f.group(2)), 32 if f.group(1) == "f" else 16) if f else None

    return ptxas_entries(log, entry)


def ptxas_grid(log: str) -> dict:
    """{(kernel, K): (registers, stack bytes, spill stores, spill loads)} of
    csrc/grid.cu's kernels (K the Eq. 6 kernel's queue length, else 0) and
    csrc/grid_round.cu's, csrc/grid_assign.cu's and csrc/grid_cd.cu's
    (grid_round_tiles, grid_assign_tiles, grid_cd_reg: K the compiled
    width, 16, 32, 64, 128, or 0 for feature slices, and for grid_cd_reg
    the list's slots after it, as "16/12"; grid_cd_ws: K the queue
    length)."""
    import re

    def entry(line):
        m = re.search(r"Compiling entry function '\S*?(grid_assign_tiles|grid_round_tiles|grid_cd_reg|grid_cd_ws"
                      r"|grid_assign|grid_round|grid_cd)"
                      r"_kernel"
                      r"(?:ILi(\d+)E(?:Li(\d+)E)?)?", line)
        if not m:
            return None
        return (m.group(1), f"{m.group(2)}/{m.group(3)}" if m.group(3) else int(m.group(2) or 0))

    return ptxas_entries(log, entry)


def ptxas_bwd(log: str) -> dict:
    """{(kernel, element bits, head-dim bucket, part): (registers, stack
    bytes, spill stores, spill loads)} of the kernels of
    csrc/flash_attention_bwd.cu (flash_bwd_kernel, delta_kernel) and
    csrc/flash_attention_bwd_mma.cu (flash_bwd_mma, bf16 only; part "dkdv"
    or "dq"; the pre-passes have bucket 0, part "")."""
    import re

    def entry(line):
        m = re.search(r"Compiling entry function '\S*?(flash_bwd_kernel|delta_kernel)I(f|13__nv_bfloat16)"
                      r"(?:Li(\d+)ELi\d+ELi\d+ELb([01]))?", line)
        if m:
            part = {"1": "dkdv", "0": "dq", None: ""}[m.group(4)]
            return m.group(1), 32 if m.group(2) == "f" else 16, int(m.group(3) or 0), part
        m = re.search(r"Compiling entry function '\S*?flash_bwd_mma_(dkdv|dq|delta)_kernel(?:ILi(\d+)E)?", line)
        if m:
            return "flash_bwd_mma", 16, int(m.group(2) or 0), "" if m.group(1) == "delta" else m.group(1)
        return None

    return ptxas_entries(log, entry)


def ptxas_fwd(log: str) -> dict:
    """{head-dim bucket: (registers, stack bytes, spill stores, spill
    loads)} of csrc/flash_attention_wgmma.cu's kernel."""
    import re

    def entry(line):
        m = re.search(r"Compiling entry function '\S*?flash_wgmma_kernelILi(\d+)E", line)
        return int(m.group(1)) if m else None

    return ptxas_entries(log, entry)


def ptxas_minima(log: str) -> dict:
    """{(kernel, 16-byte loads): (registers, stack bytes, spill stores,
    spill loads)} of csrc/strip_minima.cu's kernels."""
    import re

    def entry(line):
        m = re.search(r"Compiling entry function '\S*?minima_(tile|merge)_kernel(?:ILb([01])E)?", line)
        return (m.group(1), m.group(2) == "1") if m else None

    return ptxas_entries(log, entry)


def ptxas_strip(log: str) -> dict:
    """{(kernel, warp queue or 0): (registers, stack bytes, spill stores,
    spill loads)} of csrc/strip_tiles.cu's kernels."""
    import re

    def entry(line):
        m = re.search(r"Compiling entry function '\S*?strip_(dists_tile|topk_vec)_kernel(?:ILi(\d+)E)?", line)
        return (m.group(1), int(m.group(2) or 0)) if m else None

    return ptxas_entries(log, entry)


def ptxas_entries(log: str, entry) -> dict:
    """{key: (registers, stack bytes, spill stores, spill loads)} of the
    entry functions for which ``entry(line)`` gives a key."""
    import re

    out, cur, stack = {}, None, None
    for line in log.splitlines():
        key = entry(line) if "Compiling entry function" in line else None
        if key:
            cur = key
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            stack = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur and stack:
            out[cur] = (int(m.group(1)), *stack)
            cur, stack = None, None
    return out


def phase_card():
    import torch

    from repro_torch.device import resolve_device

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    say(f"[card] {card}")
    dev = resolve_device("cuda")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    say(f"[card] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 must be off")
    return dev, card


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    say(f"[build] {info['path']} built in {info['seconds']:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    src = None
    for line in info["log"].splitlines():  # the warp-select sources are summarised below
        if line.startswith("---"):
            src = line[4:].strip()
        if line.startswith("---") or (src not in WS_SOURCES and ("registers" in line or "spill" in line)):
            say(f"[build] {line.strip()}")
    if info["seconds"]:  # a fresh build: its ptxas report covers every instantiation
        ws = ptxas_ws(info["log"])
        for (kern, D, K), (regs, stack, st, ld) in sorted(ws.items()):
            say(f"[build] {kern} D={D} K={K}: {regs} registers, {stack} bytes stack, spill stores {st} loads {ld}")
        check(len(ws) == WS_INSTANTIATIONS,
              f"{len(ws)} register-tile instantiations in the ptxas report, not {WS_INSTANTIATIONS}")
        bad = [key for key, v in ws.items() if v[1:] != (0, 0, 0)]
        check(not bad, f"register-tile instantiations with a stack frame or spills: {bad}")
        grid = ptxas_grid(info["log"])
        for (kern, K), (regs, stack, st, ld) in sorted(grid.items()):
            src = {"grid_round_tiles": "grid_round.cu", "grid_assign_tiles": "grid_assign.cu",
                   "grid_cd_reg": "grid_cd.cu", "grid_cd_ws": "grid_cd.cu"}.get(kern, "grid.cu")
            say(f"[build] {src} {kern} K={K}: {regs} registers, {stack} bytes stack, spill stores {st} loads {ld}")
        for kern, src, want in (("grid_round_tiles", "grid_round.cu", GRID_ROUND_INSTANTIATIONS),
                                ("grid_assign_tiles", "grid_assign.cu", GRID_ASSIGN_INSTANTIATIONS),
                                ("grid_cd_reg", "grid_cd.cu", GRID_CD_REG_INSTANTIATIONS),
                                ("grid_cd_ws", "grid_cd.cu", GRID_CD_WS_INSTANTIATIONS)):
            tiles = [k for k in grid if k[0] == kern]
            check(len(tiles) == want, f"{len(tiles)} {src} kernels in the ptxas report, not {want}")
        bwd = ptxas_bwd(info["log"])
        for (kern, bits, D, part), (regs, stack, st, ld) in sorted(bwd.items()):
            say(f"[build] flash backward {kern} {part} D={D} bits={bits}: {regs} registers, {stack} bytes "
                f"stack, spill stores {st} loads {ld}")
        check(len(bwd) == BWD_INSTANTIATIONS,
              f"{len(bwd)} backward instantiations in the ptxas report, not {BWD_INSTANTIATIONS}")
        bad = [key for key, v in bwd.items() if v[1:] != (0, 0, 0)]
        check(not bad, f"backward instantiations with a stack frame or spills: {bad}")
        fwd = ptxas_fwd(info["log"])
        for DP, (regs, stack, st, ld) in sorted(fwd.items()):
            say(f"[build] flash_attention_wgmma.cu DP={DP}: {regs} registers at launch (setmaxnreg: producer 40, "
                f"consumers 232), {stack} bytes stack, spill stores {st} loads {ld}")
        check(len(fwd) == FWD_INSTANTIATIONS,
              f"{len(fwd)} wgmma forward instantiations in the ptxas report, not {FWD_INSTANTIATIONS}")
        check(all(v[0] == FWD_REGISTERS for v in fwd.values()),
              f"the wgmma forward does not launch at {FWD_REGISTERS} registers: {fwd}")
        minima = ptxas_minima(info["log"])
        for (kern, vec), (regs, stack, st, ld) in sorted(minima.items()):
            say(f"[build] strip_minima.cu {kern} vec={vec}: {regs} registers, {stack} bytes stack, spill stores "
                f"{st} loads {ld}")
        check(len(minima) == MINIMA_INSTANTIATIONS,
              f"{len(minima)} strip_minima.cu kernels in the ptxas report, not {MINIMA_INSTANTIATIONS}")
        bad = [key for key, v in minima.items() if v[1:] != (0, 0, 0)]
        check(not bad, f"strip_minima.cu kernels with a stack frame or spills: {bad}")
        tiles = ptxas_strip(info["log"])
        for (kern, K), (regs, stack, st, ld) in sorted(tiles.items()):
            say(f"[build] strip_tiles.cu {kern}{f' K={K}' if K else ''}: {regs} registers, {stack} bytes stack, "
                f"spill stores {st} loads {ld}")
        check(len(tiles) == STRIP_INSTANTIATIONS,
              f"{len(tiles)} strip_tiles.cu kernels in the ptxas report, not {STRIP_INSTANTIATIONS}")
        bad = [key for key, v in tiles.items() if v[1:] != (0, 0, 0)]
        check(not bad, f"strip_tiles.cu kernels with a stack frame or spills: {bad}")
    lib = _build.load()
    for dtype, name in ((0, "f32"), (1, "bf16")):
        plans = []
        for D in FLASH_BUCKETS:
            rows, blocks = ctypes.c_int(0), ctypes.c_int(0)
            _build.check(lib.repro_flash_attention_panel_plan(dtype, D, ctypes.byref(rows), ctypes.byref(blocks)),
                         "flash_attention plan")
            check(blocks.value >= 1, f"flash_attention_panel {name} D={D}: no block fits on an SM")
            plans.append(f"D<={D}: {rows.value} rows x {blocks.value} block(s)/SM")
        say(f"[build] flash_attention_panel {name}: " + ", ".join(plans))


def phase_kernels(dev):
    """Each kernel vs its plain version at the path's shapes; returns the
    per-kernel numbers for the JSON line."""
    import torch

    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import mutual_reach as k_mr
    from repro_torch.kernels import ref

    rng = np.random.default_rng(SEED)
    out = {}

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    # tie-free centred table and a duplicate-heavy one (300 sites over LP rows)
    pts = mixture(rng, LP + 3 * LP)
    pts -= pts.mean(axis=0)
    R = t(pts[:LP])
    Q, dropped = tie_free_rows(t(pts[LP:]), R)
    Q = Q[:LP].contiguous()
    check(Q.shape[0] == LP, f"only {Q.shape[0]} tie-free queries")
    sites = mixture(rng, 300)
    sites -= sites.mean(axis=0)
    site_of_row = rng.integers(0, 300, size=LP)
    Rdup = t(sites[site_of_row])
    near = sites[rng.integers(0, 300, size=2 * LP)] + rng.normal(scale=0.3, size=(2 * LP, DIM))
    Qdup, dropped_dup = tie_free_rows(t(near), Rdup, t(sites))
    Qdup = torch.cat([Rdup[:1000], Qdup[: LP - 1000]]).contiguous()  # on-table rows tie by index

    # --- assign: 8192 × 8192 × 16, with and without the distance; ragged L;
    # bit for bit against the per-lane kernel it replaced
    errs = []
    ragged = LP - 192  # a multiple of no kernel chunk or tile
    Rr = R[:ragged].contiguous()
    Qr, _ = tie_free_rows(Q, Rr)
    for label, q, r in (("tie-free", Q, R), ("duplicates", Qdup, Rdup), (f"ragged L={ragged}", Qr, Rr)):
        idx, dist = k_assign.assign(q, r, with_dist=True)
        idx_only = k_assign.assign(q, r)
        lidx, ldist = k_assign.assign_lane(q, r, with_dist=True)
        check(bool(torch.equal(idx, lidx)) and bool(torch.equal(dist, ldist)) and bool(torch.equal(idx_only, lidx)),
              f"assign {label}: differs from the per-lane kernel ({int((idx != lidx).sum())} indices, "
              f"{int((dist != ldist).sum())} distances)")
        pidx, pdist = ref.assign_with_dist(q, r)
        check(bool(torch.equal(idx, pidx)), f"assign {label}: {int((idx != pidx).sum())} indices differ")
        e, rel = compare(f"assign {label}", dist, pdist, dist_tol(q, r, pdist))
        errs.append(e)
        say(f"[kernels] assign {label}: identical to the per-lane kernel (indices and distances) and indices "
            f"identical to plain ({q.shape[0]} rows, {r.shape[0]} reps), dist max_abs_err {e:.3e} max_rel {rel:.3e}")
    say(f"[kernels] assign: near-tie rows left out of the tie-free sets: {dropped} / {dropped_dup}")
    n, L = Q.shape[0], R.shape[0]
    ms = time_ms(lambda: k_assign.assign(Q, R), reps=50)
    ms_d = time_ms(lambda: k_assign.assign(Q, R, with_dist=True), reps=50)
    lane_ms = time_ms(lambda: k_assign.assign_lane(Q, R), reps=50)
    plain = time_ms(lambda: ref.assign(Q, R))
    lib = time_ms(lambda: torch.cdist(Q, R).min(dim=1))
    b, by = bound_ms(2.0 * n * L * DIM, 4.0 * (n * DIM + L * DIM + n))
    say(f"[kernels] assign {n}x{L}x{DIM}: kernel {ms:.4f} ms (with dist {ms_d:.4f}), per-lane kernel {lane_ms:.4f} ms, "
        f"plain {plain:.4f} ms, cdist+min {lib:.4f} ms, bound {b:.4f} ms ({by})")
    out["assign"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                         lane_ms=lane_ms)
    # d past the register tile's 128: the same kernel file's feature slices
    wide = mixture(rng, 2 * LP, dim=WIDE_DIM)
    wide -= wide.mean(axis=0)
    Rw = t(wide[:LP])
    Qw, _ = tie_free_rows(t(wide[LP:]), Rw)
    check(Qw.shape[0] > LP // 2, f"assign d={WIDE_DIM}: only {Qw.shape[0]} tie-free queries")
    idx, dist = k_assign.assign(Qw, Rw, with_dist=True)
    pidx, pdist = ref.assign_with_dist(Qw, Rw)
    check(bool(torch.equal(idx, pidx)), f"assign d={WIDE_DIM}: {int((idx != pidx).sum())} indices differ")
    e, rel = compare(f"assign d={WIDE_DIM}", dist, pdist, dist_tol(Qw, Rw, pdist))
    ms_w = time_ms(lambda: k_assign.assign(Qw, Rw, with_dist=True))
    plain_w = time_ms(lambda: ref.assign_with_dist(Qw, Rw))
    b_w, by_w = bound_ms(2.0 * Qw.shape[0] * LP * WIDE_DIM, 4.0 * (Qw.shape[0] + LP) * WIDE_DIM)
    say(f"[kernels] assign d={WIDE_DIM} ({Qw.shape[0]} tie-free rows x {LP} reps): indices identical to plain, "
        f"dist max_abs_err {e:.3e} max_rel {rel:.3e}; kernel {ms_w:.4f} ms (with dist), plain {plain_w:.4f} ms, "
        f"bound {b_w:.4f} ms ({by_w})")
    del Rw, Qw, wide

    # --- bubble_cd: LP rows, min_pts 10, masses > 1; path layout (pads at
    # 1e6 with mass 0 past the real rows) and a ragged pad-free table
    def table(rows, real, site=None):
        """Masses 1..30 and extents per row, or per site for a table of
        duplicated bubbles: the copies of a row sit at distance 0 in the
        kernel and at f32 rounding noise in the plain version, so which
        copy crosses min_pts differs, and only a per-site mass and extent
        makes Eq. 6 independent of that order (the order itself is held
        against the direct-difference yardstick below)."""
        rep = rows.clone()
        rep[real:] = 1e6
        key = np.arange(rep.shape[0]) if site is None else site
        nb = t(rng.integers(1, 31, size=key.max() + 1)[key])
        nb[real:] = 0
        ext = t(rng.uniform(0.2, 2.0, size=key.max() + 1)[key])
        ext[real:] = 0
        return rep.contiguous(), nb, ext

    real = min(LP, round(COMPRESSION * N_POINTS))  # the leaf count the stream reaches
    cases = {"tie-free": (table(R, real), real), "duplicates, mass per site": (table(Rdup, real, site_of_row), real),
             f"ragged L={ragged}": (table(Rr, ragged), ragged)}
    errs = []
    cds = {}
    for label, ((rep, nb, ext), nreal) in cases.items():
        cd = k_bcd.bubble_core_distances(rep, nb, ext, min_pts=MIN_PTS, dim=DIM)
        check(bool(torch.equal(cd, k_bcd.bubble_cd_lane(rep, nb, ext, min_pts=MIN_PTS, dim=DIM))),
              f"bubble_cd {label}: differs from the per-lane kernel")
        pcd = ref.bubble_core_distances(rep, nb, ext, MIN_PTS, DIM)
        # pad rows (mass 0, all at one far point) never cross min_pts and
        # take each side's documented fallback; their W rows are +inf
        # the allowance is that of the row's nearest other bubble, the
        # shortest distance the crossing can sit at (self crossings are 0)
        sq = ref.pairwise_sqdist(rep[:nreal], rep[:nreal]).fill_diagonal_(float("inf"))
        r1 = sq.amin(1).sqrt()
        del sq
        tol = dist_tol(rep[:nreal], rep[:nreal], r1) - RTOL * r1 + RTOL * pcd[:nreal].abs()
        e, rel = compare(f"bubble_cd {label}", cd[:nreal], pcd[:nreal], tol)
        errs.append(e)
        cds[label] = (rep, nb, ext, pcd, nreal, r1)
        say(f"[kernels] bubble_cd {label}: {nreal} real rows of {rep.shape[0]}, identical to the per-lane "
            f"kernel on all {rep.shape[0]} rows; vs plain max_abs_err {e:.3e} max_rel {rel:.3e}")
    # the (d, j) order among copies: duplicates with a mass and extent per
    # ROW, so Eq. 6 depends on which copy crosses min_pts.  A row whose
    # site holds >= min_pts of mass crosses among its own copies, all at
    # exactly 0 in the kernel and the yardstick: there the two agree to
    # 1e-5 relative or the order differs.  Other rows cross at another
    # site, no nearer than the nearest other site, and get that distance's
    # cancellation allowance as above.
    rep, nb, ext = table(Rdup, real)
    cd = k_bcd.bubble_core_distances(rep, nb, ext, min_pts=MIN_PTS, dim=DIM)
    check(bool(torch.equal(cd, k_bcd.bubble_cd_lane(rep, nb, ext, min_pts=MIN_PTS, dim=DIM))),
          "bubble_cd duplicates, mass per row: differs from the per-lane kernel")
    want = direct_core_distances(rep, nb, ext)
    site_mass = np.bincount(site_of_row[:real], weights=nb[:real].cpu().numpy(), minlength=300)
    own = torch.as_tensor(site_mass[site_of_row[:real]] >= MIN_PTS, device=dev)
    ts = t(sites)
    sq = ref.pairwise_sqdist(ts, ts).fill_diagonal_(float("inf"))
    r1 = sq.amin(1).sqrt()[torch.as_tensor(site_of_row[:real], device=dev)]
    tol = RTOL * want[:real].abs() + torch.where(
        own, 0.0, dist_tol(rep[:real], rep[:real], r1) - RTOL * r1)
    e, rel = compare("bubble_cd duplicates, mass per row", cd[:real], want[:real], tol)
    errs.append(e)
    say(f"[kernels] bubble_cd duplicates, mass per row: identical to the per-lane kernel; vs the "
        f"direct-difference yardstick: {real} real rows, "
        f"{int(own.sum())} crossing among their own copies (tie order, 1e-5 relative), "
        f"max_abs_err {e:.3e} max_rel {rel:.3e}")
    rep, nb, ext, _, nreal, r1 = cds["tie-free"]
    ms = time_ms(lambda: k_bcd.bubble_core_distances(rep, nb, ext, min_pts=MIN_PTS, dim=DIM))
    lane_ms = time_ms(lambda: k_bcd.bubble_cd_lane(rep, nb, ext, min_pts=MIN_PTS, dim=DIM))
    plain = time_ms(lambda: ref.bubble_core_distances(rep, nb, ext, MIN_PTS, DIM), reps=3)
    # every unordered pair's distance once: L(L-1)/2 · d FMAs
    b, by = bound_ms(1.0 * LP * (LP - 1) * DIM, 4.0 * (LP * DIM + 3 * LP))
    say(f"[kernels] bubble_cd L={LP} d={DIM} min_pts={MIN_PTS}: kernel {ms:.4f} ms, per-lane kernel "
        f"{lane_ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}); no single PyTorch call computes Eq. 6")
    out["bubble_cd"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)
    # min_pts past the per-lane kernel's 64, against the plain version on
    # the real rows whose crossing is not a near-tie
    for mp in BCD_SWEEP:
        sweep_ms = time_ms(lambda: k_bcd.bubble_core_distances(rep, nb, ext, min_pts=mp, dim=DIM), reps=5)
        note = ""
        if mp > 64:
            cd = k_bcd.bubble_core_distances(rep, nb, ext, min_pts=mp, dim=DIM)
            pcd = ref.bubble_core_distances(rep, nb, ext, mp, DIM)
            keep = clear_crossings(rep[:nreal], nb[:nreal], mp)
            check(int(keep.sum()) > 0.9 * nreal, f"bubble_cd min_pts={mp}: only {int(keep.sum())} clear crossings")
            tol = dist_tol(rep[:nreal], rep[:nreal], r1) - RTOL * r1 + RTOL * pcd[:nreal].abs()
            e, rel = compare(f"bubble_cd min_pts={mp}", cd[:nreal][keep], pcd[:nreal][keep], tol[keep])
            check(bool(torch.isfinite(cd[:nreal]).all()), f"bubble_cd min_pts={mp}: non-finite output")
            note = (f"; vs plain on the {int(keep.sum())} of {nreal} real rows without a near-tie at the "
                    f"crossing: max_abs_err {e:.3e} max_rel {rel:.3e}")
        say(f"[kernels] bubble_cd sweep L={LP} min_pts={mp}: kernel {sweep_ms:.4f} ms{note}")

    # --- mutual_reach: LP², pad rows/cols +inf, diagonal 0; bit for bit
    # against the tile kernel it replaced
    errs = []
    for label, (rep, _, _, pcd, nreal, _) in cds.items():
        W = k_mr.mutual_reachability(rep, rep, pcd, pcd, n_valid=nreal)
        check(bool(torch.equal(W, k_mr.mutual_reach_tile(rep, rep, pcd, pcd, n_valid=nreal))),
              f"mutual_reach {label}: differs from the tile kernel")
        pW = ref.mutual_reachability(rep, rep, pcd, pcd, n_valid=nreal)
        check(bool((W.diagonal()[:nreal] == 0).all()), f"mutual_reach {label}: diagonal not 0")
        base = ref.mutual_reachability(rep, rep, torch.zeros_like(pcd), torch.zeros_like(pcd), n_valid=nreal)
        e, rel = compare(f"mutual_reach {label}", W, pW, dist_tol(rep[:nreal], rep[:nreal], base) + RTOL * pW.abs())
        errs.append(e)
        say(f"[kernels] mutual_reach {label}: {rep.shape[0]}², n_valid {nreal}, identical to the tile kernel; "
            f"vs plain max_abs_err {e:.3e} max_rel {rel:.3e}")
        del W, pW, base
    rep, _, _, pcd, nreal, _ = cds["tie-free"]
    ms = time_ms(lambda: k_mr.mutual_reachability(rep, rep, pcd, pcd, n_valid=nreal), reps=50)
    tile_ms = time_ms(lambda: k_mr.mutual_reach_tile(rep, rep, pcd, pcd, n_valid=nreal), reps=50)
    fill = fill_ms(LP, LP)
    host = host_ms(lambda: k_mr.mutual_reachability(rep, rep, pcd, pcd, n_valid=nreal))
    plain = time_ms(lambda: ref.mutual_reachability(rep, rep, pcd, pcd, n_valid=nreal), reps=5)
    lib = time_ms(lambda: torch.maximum(torch.cdist(rep, rep), torch.maximum(pcd[:, None], pcd[None, :])), reps=5)
    b, by = bound_ms(2.0 * LP * LP * DIM, 4.0 * (LP * LP + 2 * LP * DIM + 2 * LP))
    say(f"[kernels] mutual_reach {LP}²x{DIM}, n_valid {nreal}: kernel {ms:.4f} ms, tile kernel {tile_ms:.4f} ms, "
        f"write rate (fill_) {fill:.4f} ms, host enqueue {host:.4f} ms per call, plain {plain:.4f} ms, "
        f"cdist+maximum {lib:.4f} ms, bound {b:.4f} ms ({by})")
    out["mutual_reach"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                               tile_ms=tile_ms)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _same_partition(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a == -1, b == -1):
        return False
    m = a != -1
    pairs = set(zip(a[m].tolist(), b[m].tolist()))
    return len(pairs) == len({x for x, _ in pairs}) == len({y for _, y in pairs})


def phase_stream(dev):
    """The engine on the card; returns the launch counts of the stream and
    the tables for the CPU checks."""
    import torch

    from repro_torch import StreamingClusterEngine
    from repro_torch.core import hierarchy as th
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import hierarchy as k_h
    from repro_torch.kernels import mutual_reach as k_mr

    rng = np.random.default_rng(SEED + 1)
    data = mixture(rng, N_POINTS + N_QUERIES) + 50.0  # off the origin: the engine centres
    X, Qs = data[:N_POINTS], data[N_POINTS:]
    eng = StreamingClusterEngine(
        DIM, min_pts=MIN_PTS, compression=COMPRESSION, epsilon=EPSILON, max_block=BLOCK, device=dev)
    passes, history = [], {}

    def note_pass(before):
        snap = eng.snapshot
        if snap is not None and snap.version != before:
            passes.append((snap.n_bubbles, max(8, 1 << (snap.n_bubbles - 1).bit_length()),
                           snap.wall_seconds * 1e3))
            history[snap.version] = snap

    reset_counts()
    k_bcd.launches_lane = k_mr.launches_tile = 0
    eom_before = k_h.launches_eom
    plain = {name: getattr(th, name) for name in ("single_linkage_fixed", "condense_fixed", "extract_fixed",
                                                  "stabilities", "eom_loop", "flat_labels")}
    plain_on_card = []

    def watched(name, fn):  # counts the plain hierarchy loops' calls on CUDA tensors
        def call(*args, **kw):
            first = args[0][0] if isinstance(args[0], tuple) else args[0]
            if first.is_cuda:
                plain_on_card.append(name)
            return fn(*args, **kw)
        return call

    for name, fn in plain.items():
        setattr(th, name, watched(name, fn))
    torch.cuda.reset_peak_memory_stats()
    t_stream = time.perf_counter()
    ingest_s, pids = 0.0, []
    for i in range(0, N_POINTS, BLOCK):
        v0 = 0 if eng.snapshot is None else eng.snapshot.version
        off0 = eng.stats["offline_seconds_total"]
        t0 = time.perf_counter()
        pids.extend(eng.ingest(X[i : i + BLOCK]))
        ingest_s += time.perf_counter() - t0 - (eng.stats["offline_seconds_total"] - off0)
        note_pass(v0)
    v0 = eng.snapshot.version
    snap_full = eng.flush()
    note_pass(v0)
    table_full = eng._table.capture(eng.tree.n_points).table()
    ckpt = checkpoint_stream(eng)  # for [recover]; host only, left out of the stream's wall
    retire_s = 0.0
    drop = rng.choice(len(pids), size=N_POINTS // 4, replace=False)
    retire_blocks = [[pids[j] for j in drop[i : i + BLOCK]] for i in range(0, len(drop), BLOCK)]
    published = {}  # version -> snapshot, each pass published from here on ([recover] replays them)
    retire_versions = []  # the version served after each retire block
    for block in retire_blocks:
        v0 = eng.snapshot.version
        off0 = eng.stats["offline_seconds_total"]
        t0 = time.perf_counter()
        eng.retire(block)
        retire_s += time.perf_counter() - t0 - (eng.stats["offline_seconds_total"] - off0)
        note_pass(v0)
        published[eng.snapshot.version] = eng.snapshot
        retire_versions.append(eng.snapshot.version)
    v0 = eng.snapshot.version
    snap_last = eng.flush()
    note_pass(v0)
    published[snap_last.version] = snap_last
    table_last = eng._table.capture(eng.tree.n_points).table()
    lat, served = [], []
    for i in range(0, N_QUERIES, QUERY_CHUNK):
        t0 = time.perf_counter()
        served.append(eng.query_detailed(Qs[i : i + QUERY_CHUNK]))
        lat.append((time.perf_counter() - t0) * 1e3)
    stream_s = time.perf_counter() - t_stream - ckpt["seconds"]
    for name, fn in plain.items():
        setattr(th, name, fn)
    launches = read_counts()
    n_passes = eng.stats["recluster_count"]

    say(f"[stream] {N_POINTS} points d={DIM} in blocks of {BLOCK}, {len(drop)} retired, "
        f"{N_QUERIES} queries in chunks of {QUERY_CHUNK}: {stream_s:.2f} s wall, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    say(f"[stream] launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the stream")
    check(k_bcd.launches_lane == 0, "the per-lane bubble_cd kernel ran on the stream")
    check(k_mr.launches_tile == 0, "the mutual_reach tile kernel ran on the stream")
    say(f"[stream] {n_passes} offline passes; hierarchy kernel launches per pass: single_linkage "
        f"{launches['single_linkage'] / n_passes:g}, condense {launches['condense'] / n_passes:g}, extract "
        f"{launches['extract'] / n_passes:g} (eom {k_h.launches_eom - eom_before}); plain hierarchy loops on the card: "
        f"{len(plain_on_card)}")
    check(all(launches[k] == n_passes for k in ("single_linkage", "condense", "extract")),
          f"hierarchy kernels not launched once per offline pass ({n_passes} passes): {launches}")
    check(k_h.launches_eom == eom_before, "the EOM kernel of extract_v1 ran on the stream")
    check(not plain_on_card, f"the plain hierarchy loops ran on the card: {sorted(set(plain_on_card))}")
    say(f"[stream] ingest {ingest_s / N_POINTS * 1e6:.3f} ms per 1k points (host tree + assign kernel, "
        f"offline passes excluded); retire {retire_s / len(drop) * 1e6:.3f} ms per 1k points")
    say(f"[stream] offline passes (L, Lp, ms): {[(a, b, round(c, 1)) for a, b, c in passes]}")
    check(any(lp == LP for _, lp, _ in passes), f"no offline pass at Lp = {LP}")
    check(snap_full.n_bubbles > LP // 2, "the full-stream snapshot is not in the Lp = 8192 bucket")
    say(f"[stream] query latency per {QUERY_CHUNK}-row chunk: p50 {np.median(lat):.3f} ms, "
        f"min {min(lat):.3f} ms, max {max(lat):.3f} ms")
    for res in served:
        check(res.version == snap_last.version and np.isfinite(res.distance).all()
              and ((res.strength >= 0) & (res.strength <= 1)).all(), "malformed query result")
    return dict(eng=eng, snap_full=snap_full, table_full=table_full, snap_last=snap_last,
                table_last=table_last, Qs=Qs, served=served, launches=launches, ckpt=ckpt,
                retire_blocks=retire_blocks, published=published, retire_versions=retire_versions,
                ingest_ms=ingest_s / N_POINTS * 1e6, retire_ms=retire_s / len(drop) * 1e6, history=history,
                wall_s=stream_s, eom_launches=k_h.launches_eom - eom_before)


def assign_at_query_shape(dev, run):
    """The assign kernel at the serve path's shape: one query chunk against
    the final snapshot's device entry (its L reps padded to the bucket, as
    ``query_detailed`` calls it); new kernel, per-lane kernel, plain
    version, cdist+min and the bound."""
    import torch

    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import ref
    from repro_torch.serving.query import _build_entry

    snap = run["snap_last"]
    entry = _build_entry(snap, dev)
    q = torch.as_tensor((run["Qs"][:QUERY_CHUNK] - entry.center[None, :]).astype(np.float32), device=dev)
    r = entry.reps
    idx, dist = k_assign.assign(q, r, with_dist=True)
    lidx, ldist = k_assign.assign_lane(q, r, with_dist=True)
    check(bool(torch.equal(idx, lidx)) and bool(torch.equal(dist, ldist)),
          "assign at the query shape differs from the per-lane kernel")
    ms = time_ms(lambda: k_assign.assign(q, r, with_dist=True), reps=50)
    host = host_ms(lambda: k_assign.assign(q, r, with_dist=True), reps=50)
    lane_ms = time_ms(lambda: k_assign.assign_lane(q, r, with_dist=True), reps=50)
    plain = time_ms(lambda: ref.assign_with_dist(q, r))
    lib = time_ms(lambda: torch.cdist(q, r).min(dim=1))
    n, L = q.shape[0], r.shape[0]
    b, by = bound_ms(2.0 * n * L * DIM, 4.0 * (n * DIM + L * DIM + 2 * n))
    # where the host's enqueue time per call reaches the device time, the
    # device idles between calls and the event time is the host's
    say(f"[stream] assign at the query shape ({n} rows x {L} reps: the final snapshot's {snap.n_bubbles} bubbles "
        f"in its bucket), with dist: kernel {ms:.4f} ms (host enqueue {host:.4f} ms per call), per-lane kernel "
        f"{lane_ms:.4f} ms, plain {plain:.4f} ms, cdist+min {lib:.4f} ms, bound {b:.4f} ms ({by}); identical to the "
        f"per-lane kernel")


def check_snapshot(tag, name, snap, table, min_pts):
    """A published snapshot against the port's plain pipeline on the CPU:
    the same partition, MST weight within RTOL."""
    from repro_torch.kernels import ops

    rep, extent, n_b, center = table
    check(np.array_equal(rep, snap.bubble_rep) and np.array_equal(center, snap.center),
          f"{name}: the captured table is not the snapshot's")
    t0 = time.perf_counter()
    cpu = ops.offline_recluster_from_table(rep, n_b, extent, min_pts, device="cpu")
    w_gpu, w_cpu = float(np.sum(snap.mst[2])), float(np.sum(cpu.mst[2]))
    rel = abs(w_gpu - w_cpu) / abs(w_cpu)
    say(f"[{tag}] {name} snapshot (L={snap.n_bubbles}): CPU plain pass {time.perf_counter() - t0:.2f} s, "
        f"{cpu.n_clusters} vs {snap.result.n_clusters} clusters, MST weight rel diff {rel:.3e}")
    check(_same_partition(snap.bubble_labels, cpu.labels), f"{name}: partition differs from the CPU pass")
    check(rel <= RTOL, f"{name}: MST weight differs by {rel:.3e}")


def check_served(tag, snap, X, served):
    """Served rows against the CPU plain ``_fused_query`` on the same
    snapshot: bubble indices and labels identical on rows whose best and
    second-best distances are more than 1e-5 apart."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.serving.query import _build_entry, _fused_query

    entry = _build_entry(snap, torch.device("cpu"))
    idx, lbl, near_tie = [], [], []
    for i in range(0, X.shape[0], 16384):
        xc = torch.from_numpy((X[i : i + 16384] - entry.center[None, :]).astype(np.float32))
        out = _fused_query(xc, entry.reps, entry.labels, entry.lam, entry.lam_max)
        idx.append(out[0].numpy())
        lbl.append(out[1].numpy())
        sq = ref.pairwise_sqdist(xc, entry.reps[: snap.n_bubbles])
        two = torch.topk(sq, 2, dim=1, largest=False).values.sqrt()
        near_tie.append(((two[:, 1] - two[:, 0]) <= RTOL * two[:, 1]).numpy())
    idx, lbl, near_tie = (np.concatenate(a) for a in (idx, lbl, near_tie))
    got = np.concatenate([r.bubble_index for r in served])
    got_lbl = np.concatenate([r.labels for r in served])
    differ = (got != idx) & ~near_tie
    say(f"[{tag}] served bubble_index vs CPU plain _fused_query: {int(differ.sum())} differ on "
        f"{int((~near_tie).sum())} rows; {int(near_tie.sum())} near-ties (second-best within 1e-5) left out")
    check(not differ.any(), "served rows differ from the CPU plain query")
    check(np.array_equal(got_lbl[~near_tie], lbl[~near_tie]), "served labels differ")


PATH_KERNELS = ("assign", "bubble_cd", "mutual_reach", "single_linkage", "condense", "extract")


def reset_counts(counts=None):
    """Set the launch counts of the engine's kernels to 0, or to ``counts``
    (a ``read_counts()`` result)."""
    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import hierarchy as k_h
    from repro_torch.kernels import mutual_reach as k_mr

    c = counts or dict.fromkeys(PATH_KERNELS, 0)
    k_assign.launches, k_bcd.launches, k_mr.launches = c["assign"], c["bubble_cd"], c["mutual_reach"]
    k_h.launches_single_linkage, k_h.launches_condense, k_h.launches_extract = (
        c["single_linkage"], c["condense"], c["extract"])


def read_counts() -> dict:
    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import hierarchy as k_h
    from repro_torch.kernels import mutual_reach as k_mr

    return {"assign": k_assign.launches, "bubble_cd": k_bcd.launches, "mutual_reach": k_mr.launches,
            "single_linkage": k_h.launches_single_linkage, "condense": k_h.launches_condense,
            "extract": k_h.launches_extract}


def checkpoint_stream(eng) -> dict:
    """Checkpoint the stream engine at full size into a CheckpointStore in a
    temporary directory: ``checkpoint_state`` alone, a blocking ``save``,
    then one async ``save`` (the next step) with ``wait()``; for
    [recover]."""
    import tempfile

    from repro_torch import CheckpointStore

    t_all = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t0 = time.perf_counter()
    state = eng.checkpoint_state()
    state_ms = (time.perf_counter() - t0) * 1e3
    store = CheckpointStore(root, keep=2)
    t0 = time.perf_counter()
    step = eng.save(store)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eng.save(store, step=step + 1, blocking=False)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    store.wait()
    async_ms = (time.perf_counter() - t0) * 1e3
    store.close()
    disk = sum(f.stat().st_size for f in (Path(root) / f"step_{step}").iterdir())
    return dict(root=root, step=step + 1, leaves=len(state), nbytes=sum(np.asarray(v).nbytes for v in state.values()),
                disk=disk, state_ms=state_ms, save_ms=save_ms, enqueue_ms=enqueue_ms, async_ms=async_ms,
                seconds=time.perf_counter() - t_all)


SNAP_RESULT_FIELDS = ("labels", "stabilities", "weights", "point_parent", "point_lambda", "cluster_parent",
                      "cluster_birth", "cluster_weight", "selected", "all_stabilities")


def same_snapshot(name, got, want):
    """Two published snapshots field for field, bit for bit: version, table,
    MST u/v/w, every result field and every condensed-tree field."""
    pairs = [("version", got.version, want.version), ("n_points", got.n_points, want.n_points),
             ("dirty_consumed", got.dirty_consumed, want.dirty_consumed),
             ("min_cluster_size", got.result.min_cluster_size, want.result.min_cluster_size)]
    pairs += [(f, getattr(got, f), getattr(want, f)) for f in ("bubble_rep", "bubble_n", "center")]
    pairs += [(f"mst_{k}", a, b) for k, a, b in zip("uvw", got.mst, want.mst)]
    pairs += [(f, getattr(got.result, f), getattr(want.result, f)) for f in SNAP_RESULT_FIELDS]
    cg, cw = got.condensed, want.condensed
    pairs += [(f"condensed.{f}", getattr(cg, f), getattr(cw, f))
              for f in ("parent", "child", "lambda_val", "child_weight", "n_leaves")]
    bad = [f for f, a, b in pairs
           if not (np.shape(a) == np.shape(b) and np.asarray(a).dtype == np.asarray(b).dtype
                   and np.array_equal(a, b))]
    check(not bad, f"{name}: snapshot fields differ: {bad}")


def batched_callers(qb, reqs):
    """SERVE_THREADS closed-loop callers, each issuing its SERVE_REQUESTS
    of ``reqs`` through ``qb``; returns the results, the callers'
    latencies (ms), the wall (s) and the assign launches meanwhile."""
    import threading

    from repro_torch.kernels import assign as k_assign

    got, lat, errors = [None] * len(reqs), [], []
    start = threading.Barrier(SERVE_THREADS + 1)

    def caller(t):
        try:
            start.wait(timeout=60)
            for i in range(t * SERVE_REQUESTS, (t + 1) * SERVE_REQUESTS):
                t1 = time.perf_counter()
                got[i] = qb.query_detailed(reqs[i])
                lat.append((time.perf_counter() - t1) * 1e3)
        except BaseException as e:  # noqa: BLE001 — checked below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(t,)) for t in range(SERVE_THREADS)]
    for t in threads:
        t.start()
    k_assign.launches = 0
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a batcher caller did not finish")
    check(not errors, f"a batcher caller raised: {errors[:1]}")
    return got, lat, wall, k_assign.launches


def phase_serve(dev, run, card):
    """Concurrent callers through one QueryBatcher on the stream's final
    engine (after the retires L = 3932, Lp = 4096): SERVE_THREADS threads
    of SERVE_REQUESTS requests of SERVE_ROWS rows each, every caller's rows
    held to a direct ``query_detailed`` of the same rows and to the CPU
    plain query, the same requests served one by one beside them, at the
    batcher's default re-contend interval; then a leader that dies in its
    fused call."""
    import threading

    from repro_torch import QueryBatcher

    eng = run["eng"]
    Qs = run["Qs"]
    rng = np.random.default_rng(SEED + 9)
    n_req = SERVE_THREADS * SERVE_REQUESTS
    # rows of the stream's query mixture, resampled with a small jitter
    reqs = [Qs[rng.integers(0, len(Qs), size=SERVE_ROWS)] + rng.normal(scale=0.05, size=(SERVE_ROWS, DIM))
            for _ in range(n_req)]
    eng.query_detailed(reqs[0])
    direct, serial_lat = [], []
    t0 = time.perf_counter()
    for r in reqs:
        t1 = time.perf_counter()
        direct.append(eng.query_detailed(r))
        serial_lat.append((time.perf_counter() - t1) * 1e3)
    serial_s = time.perf_counter() - t0

    rows = n_req * SERVE_ROWS
    say(f"[serve] {n_req} requests of {SERVE_ROWS} rows from {SERVE_THREADS} threads through one QueryBatcher "
        f"(max_batch {SERVE_MAX_BATCH}) on the stream's final engine (L={eng.snapshot.n_bubbles}), on {card}; "
        f"one by one: p50 {np.percentile(serial_lat, 50):.3f} ms, p99 {np.percentile(serial_lat, 99):.3f} ms, "
        f"{rows / serial_s:.0f} rows/s ({serial_s * 1e3:.1f} ms wall)")
    qb = QueryBatcher(eng, max_batch=SERVE_MAX_BATCH)
    got, lat, wall, launches = batched_callers(qb, reqs)
    for g, w in zip(got, direct):
        check(g.version == w.version and np.array_equal(g.labels, w.labels)
              and np.array_equal(g.bubble_index, w.bubble_index), "batched labels or bubble_index differ")
    dist_equal = sum(np.array_equal(g.distance, w.distance) for g, w in zip(got, direct))
    str_equal = sum(np.array_equal(g.strength, w.strength) for g, w in zip(got, direct))
    rel = max(float(np.max(np.abs(g.distance - w.distance) / np.maximum(np.abs(w.distance), 1e-30)))
              for g, w in zip(got, direct))
    rel_s = max(float(np.max(np.abs(g.strength - w.strength) / np.maximum(np.abs(w.strength), 1e-30)))
                for g, w in zip(got, direct))
    say(f"[serve] batched, poll_s {qb.poll_s * 1e3:g} ms: {qb.batches} fused calls, fanned_out {qb.fanned_out}, "
        f"assign launches {launches}; caller latency p50 {np.percentile(lat, 50):.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms; {rows / wall:.0f} rows/s ({wall * 1e3:.1f} ms wall), "
        f"{serial_s / wall:.2f}x the serial rows/s; against direct query_detailed: labels and bubble_index "
        f"identical in all {n_req}, distance bit for bit in {dist_equal}, strength in {str_equal} (max rel "
        f"diff {rel:.3e}, {rel_s:.3e})")
    check(rel <= 1e-6 and rel_s <= 1e-6, "batched distance or strength beyond 1e-6 relative")
    check(qb.fanned_out == n_req and launches == qb.batches >= 1,
          f"fanned_out {qb.fanned_out}, batches {qb.batches}, assign launches {launches}")
    check_served("serve", eng.snapshot, np.concatenate(reqs), got)

    batches0 = qb.batches
    outcomes = [None] * SERVE_THREADS

    def poisoned(X, **kw):
        raise RuntimeError("poisoned batch")

    def victim(t):
        try:
            qb.query_detailed(reqs[t])
            outcomes[t] = "ok"
        except RuntimeError as e:
            outcomes[t] = str(e)

    eng.query_detailed = poisoned
    try:
        threads = [threading.Thread(target=victim, args=(t,)) for t in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        alive = sum(t.is_alive() for t in threads)
    finally:
        del eng.query_detailed
    check(alive == 0, f"{alive} callers still waiting after their leader died")
    check(outcomes == ["poisoned batch"] * SERVE_THREADS, f"leader death outcomes {outcomes}")
    after = qb.query_detailed(reqs[0])
    check(np.array_equal(after.labels, direct[0].labels) and np.array_equal(after.bubble_index, direct[0].bubble_index),
          "the batcher serves wrongly after a leader died")
    say(f"[serve] leader death: a poisoned query_detailed raised in all {SERVE_THREADS} callers (none left waiting), "
        f"{qb.batches - batches0} fused call completed after it, and it matches the direct query")


def phase_recover(dev, run, card):
    """The stream's checkpoint (taken at full size, [stream]) restored into
    a fresh card engine, which replays the stream's retire blocks: at every
    version both engines published, the snapshots bit for bit, and the
    final query chunk's rows identical; also restored into a CPU engine,
    whose snapshot is the same published one."""
    import shutil

    from repro_torch import CheckpointStore, StreamingClusterEngine

    ck = run["ckpt"]
    kw = dict(min_pts=MIN_PTS, compression=COMPRESSION, epsilon=EPSILON, max_block=BLOCK)
    reset_counts()
    store = CheckpointStore(ck["root"])
    fresh = StreamingClusterEngine(DIM, device=dev, **kw)
    t0 = time.perf_counter()
    step = fresh.restore(store)
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(step == ck["step"], f"restored step {step}, not the newest {ck['step']}")
    same_snapshot("restored", fresh.snapshot, run["snap_full"])
    cpu = StreamingClusterEngine(DIM, device="cpu", **kw)
    cpu.restore(store)
    store.close()
    same_snapshot("restored on the CPU", cpu.snapshot, fresh.snapshot)
    first, compared = None, 0
    for block, want_v in zip(run["retire_blocks"], run["retire_versions"]):
        v0 = fresh.snapshot.version
        fresh.retire(block)
        snap = fresh.snapshot
        check(snap.version == want_v, f"after a retire block: version {snap.version}, the stream had {want_v}")
        if snap.version != v0:
            same_snapshot(f"version {snap.version}", snap, run["published"][snap.version])
            compared += 1
            first = first or (snap.wall_seconds * 1e3, run["published"][snap.version].wall_seconds * 1e3)
    last = fresh.flush()
    same_snapshot("final", last, run["snap_last"])
    compared += 1
    first = first or (last.wall_seconds * 1e3, run["snap_last"].wall_seconds * 1e3)
    got, want = fresh.query_detailed(run["Qs"][-QUERY_CHUNK:]), run["served"][-1]
    for f in ("labels", "bubble_index", "distance", "strength"):
        check(np.array_equal(getattr(got, f), getattr(want, f)), f"final query chunk: {f} differs")
    launches = read_counts()
    shutil.rmtree(ck["root"], ignore_errors=True)
    say(f"[recover] checkpoint of the stream at {N_POINTS} points (L={run['snap_full'].n_bubbles}), on {card}: "
        f"{ck['leaves']} leaves, {ck['nbytes']} bytes in memory, {ck['disk']} bytes on disk; checkpoint_state "
        f"{ck['state_ms']:.1f} ms, save (blocking) {ck['save_ms']:.1f} ms, async save {ck['enqueue_ms']:.1f} ms "
        f"to enqueue and {ck['async_ms']:.1f} ms to wait(); restore {restore_ms:.1f} ms")
    say(f"[recover] the restored card engine replayed {len(run['retire_blocks'])} retire blocks: {compared} published "
        f"versions bit for bit (version, labels, MST u/v/w, stabilities, every result and condensed field), the "
        f"final query chunk identical; first pass after the restore {first[0]:.2f} ms (the uninterrupted stream's "
        f"same pass {first[1]:.2f} ms); the CPU engine's restored snapshot equal field for field")
    say(f"[recover] launches {json.dumps(launches)}")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched in [recover]")


ONLINE_DUP_SLOTS = 16  # [online]: the distinct slots of flat_scatter's duplicate-heavy block


def flat_parity(eng) -> float:
    """The device-online engine's flat table against its host tree, per
    alive leaf: the same leaves, N exact, the uncentred LS and SS within
    1e-6 relative (plus 1e-6 of the largest magnitude); and the populated
    slots the host takes for a capture equal to the ones the device's N
    gives.  Returns the largest difference relative to that allowance's
    scale."""
    import torch

    f, t = eng._flat, eng.tree
    leaf_ids, LS, SS, N = f.host_cfs()
    ids = t.alive_leaf_ids()
    order, srt = np.argsort(leaf_ids), np.sort(leaf_ids)
    check(np.array_equal(srt, np.sort(ids[t.N[ids] > 0])), "[online] the flat table's leaves are not the tree's")
    check(np.array_equal(N[order], t.N[srt]), "[online] the flat table's N differs from the tree's")
    worst = 0.0
    for name, got, want in (("LS", LS[order], t.LS[srt]), ("SS", SS[order], t.SS[srt])):
        scale = np.abs(want) + max(1.0, float(np.abs(want).max()))
        rel = float(np.max(np.abs(got - want) / scale))
        check(rel <= 1e-6, f"[online] flat {name} differs from the tree's by {rel:.3e} of its scale")
        worst = max(worst, rel)
    dev_slots = torch.nonzero(f.alive & (f.N > 0)).squeeze(1).cpu().numpy()
    check(np.array_equal(f.alive_slots(), dev_slots), "[online] the host's populated slots are not the device's")
    return worst


def online_pass_parity(eng):
    """The newest snapshot (a device-table pass) against the card's
    host-table pass on the same tree, aligned per leaf: the same partition;
    returns the MST weights' relative difference.  The check's own kernel
    launches are taken back out of the counts."""
    snap, f = eng.snapshot, eng._flat
    ids, LS, SS, N = eng.tree.leaf_cf_buffers()
    counts = read_counts()
    host = eng.backend.offline_recluster(LS, SS, N, ids, MIN_PTS)
    reset_counts(counts)  # a check's launches are not the path's
    pos = {int(leaf): i for i, leaf in enumerate(ids)}
    rows = np.asarray([pos[int(leaf)] for leaf in f.leaf_of_slot[f.alive_slots()]])
    check(snap.n_bubbles == len(rows), "[online] the snapshot's rows are not the flat table's populated slots")
    check(_same_partition(snap.bubble_labels, host.labels[rows]),
          f"[online] version {snap.version}: partition differs from the host-table pass")
    w = float(np.sum(host.mst[2]))
    return abs(snap.total_mst_weight - w) / w


def phase_online(dev, run, card):
    """Device-online ingest on the card: the [stream] configuration (the
    same data, blocks, retires and queries) with ``device_online=True``;
    CF parity after every block, every pass against the host-table pass on
    the same tree, the final snapshot and the served rows against the CPU
    plain pipeline, one pass with no host synchronisation allowed from the
    capture to the unwrap; then the device-table pass's stages at the full
    table beside the host-table pass's, flat_scatter against its plain
    version at the stream's shapes, and a checkpoint drill.  Returns
    (launches, flat_scatter's numbers)."""
    import torch

    from repro_torch import StreamingClusterEngine
    from repro_torch.core.device_table import FlatTableCapture
    from repro_torch.kernels import flat_scatter as k_fs
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED + 1)
    data = mixture(rng, N_POINTS + N_QUERIES) + 50.0  # [stream]'s data, blocks and retires
    X, Qs = data[:N_POINTS], data[N_POINTS:]
    kw = dict(min_pts=MIN_PTS, compression=COMPRESSION, epsilon=EPSILON, max_block=BLOCK, device_online=True)
    eng = StreamingClusterEngine(DIM, device=dev, **kw)
    passes, parity, weights = [], [], []

    def note_pass(before):
        snap = eng.snapshot
        if snap is not None and snap.version != before:
            passes.append((snap.n_bubbles, ops._pow2_rows(snap.n_bubbles), snap.wall_seconds * 1e3))
            weights.append(online_pass_parity(eng))

    reset_counts()
    k_fs.launches = 0
    ingest_s, pids = 0.0, []
    for i in range(0, N_POINTS, BLOCK):
        v0 = 0 if eng.snapshot is None else eng.snapshot.version
        off0 = eng.stats["offline_seconds_total"]
        t0 = time.perf_counter()
        pids.extend(eng.ingest(X[i : i + BLOCK]))
        ingest_s += time.perf_counter() - t0 - (eng.stats["offline_seconds_total"] - off0)
        if not eng._flat.stale:
            parity.append(flat_parity(eng))
        note_pass(v0)
    v0 = eng.snapshot.version
    snap_full = eng.flush()
    note_pass(v0)
    f = eng._flat
    check(not f.stale, "[online] the flat table is stale after the ingest")
    # for the stage split and the drill, outside the stream's timed windows:
    # a capture (isolation clones), the host tree's table, a checkpoint
    cap_full = f.capture(eng.tree.n_points)
    table_full = eng._host_table.capture(eng.tree.n_points).table()
    ckpt = checkpoint_stream(eng)
    drop = rng.choice(len(pids), size=N_POINTS // 4, replace=False)
    retire_blocks = [[pids[j] for j in drop[i : i + BLOCK]] for i in range(0, len(drop), BLOCK)]
    retire_s, published = 0.0, {}
    for block in retire_blocks:
        v0 = eng.snapshot.version
        off0 = eng.stats["offline_seconds_total"]
        t0 = time.perf_counter()
        eng.retire(block)
        retire_s += time.perf_counter() - t0 - (eng.stats["offline_seconds_total"] - off0)
        parity.append(flat_parity(eng))
        note_pass(v0)
        published[eng.snapshot.version] = eng.snapshot
    v0 = eng.snapshot.version
    snap_last = eng.flush()
    note_pass(v0)
    published[snap_last.version] = snap_last
    served = [eng.query_detailed(Qs[i : i + QUERY_CHUNK]) for i in range(0, N_QUERIES, QUERY_CHUNK)]
    launches = dict(read_counts(), flat_scatter=k_fs.launches)

    say(f"[online] {N_POINTS} points d={DIM} in blocks of {BLOCK}, device_online=True, {len(drop)} retired, "
        f"{N_QUERIES} queries, on {card}: {eng.stats['device_online_blocks']} blocks on the device, flat_loads "
        f"{eng.stats['flat_loads']}, flat Lp {f.Lp}; launches {json.dumps(launches)}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} never launched in [online]")
    n_passes = eng.stats["recluster_count"]
    check(all(launches[k] == n_passes for k in PATH_KERNELS[1:]),
          f"[online] pass kernels not launched once per offline pass ({n_passes} passes): {launches}")
    check(eng.stats["device_online_blocks"] >= len(retire_blocks) + N_POINTS // BLOCK - 1,
          "[online] blocks left the device path")
    say(f"[online] ingest {ingest_s / N_POINTS * 1e6:.3f} ms per 1k points, retire {retire_s / len(drop) * 1e6:.3f} "
        f"ms per 1k points (offline passes excluded); [stream]'s default engine in this run: ingest "
        f"{run['ingest_ms']:.3f}, retire {run['retire_ms']:.3f}")
    say(f"[online] CF parity against the host tree after all {len(parity)} blocks: N exact, LS and SS within "
        f"{max(parity):.3e} of their scale (limit 1e-6); the host's populated slots equal the device's each time")
    say(f"[online] {len(passes)} offline passes from the device table (L, Lp, ms): "
        f"{[(a, b, round(c, 1)) for a, b, c in passes]}; each partition equal to the card's host-table pass on "
        f"the same tree, MST weight rel diff max {max(weights):.3e}")
    check(len(passes) >= 3, "[online] fewer than three offline passes")

    # the final snapshot against the CPU plain pipeline on the same capture
    cap = f.capture(eng.tree.n_points)
    cpu_cap = FlatTableCapture(view=tuple(t.cpu() for t in cap.view), origin=cap.origin, n_points=cap.n_points,
                               slots=cap.slots)
    t0 = time.perf_counter()
    res_cpu, rep_cpu, nb_cpu, _ = cpu_cap.recluster(ops.get_backend("cpu"), min_pts=MIN_PTS,
                                                    min_cluster_size=float(MIN_PTS))
    w_gpu, w_cpu = snap_last.total_mst_weight, float(np.sum(res_cpu.mst[2]))
    rel = abs(w_gpu - w_cpu) / w_cpu
    check(np.array_equal(nb_cpu, snap_last.bubble_n), "[online] final: the CPU pass's masses differ")
    check(_same_partition(snap_last.bubble_labels, res_cpu.labels), "[online] final: partition differs from CPU")
    check(rel <= RTOL, f"[online] final: MST weight differs from the CPU plain pass by {rel:.3e}")
    rep_rel = float(np.max(np.abs(rep_cpu - snap_last.bubble_rep)) / np.max(np.abs(snap_last.bubble_rep)))
    say(f"[online] final snapshot (L={snap_last.n_bubbles}) against the CPU plain pipeline on the same capture "
        f"({time.perf_counter() - t0:.2f} s): partition equal, {res_cpu.n_clusters} clusters, MST weight rel diff "
        f"{rel:.3e}, reps within {rep_rel:.3e} of their largest magnitude")
    check_served("online", snap_last, Qs, served)

    # no host synchronisation from the capture to the unwrap
    def no_sync(name, fn, *args, **kwargs):
        if name == "unwrap":
            return fn(*args, **kwargs)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    torch.cuda.synchronize()
    cap = no_sync("capture", f.capture, eng.tree.n_points)
    res = ops.offline_recluster_from_device_table(*cap.view, cap.origin, MIN_PTS, float(MIN_PTS), slots=cap.slots,
                                                  stage=no_sync)[0]
    check(np.array_equal(res.labels, snap_last.bubble_labels), "[online] the pass under the sync debug mode differs")
    say("[online] capture and pass with torch.cuda.set_sync_debug_mode('error') from the capture to the unwrap: "
        "no host synchronisation raised; labels identical to the published snapshot's")

    online_stages(dev, cap_full, table_full, snap_full)
    numbers = online_scatter(dev, eng, Qs)
    online_drill(dev, card, ckpt, kw, f, retire_blocks, published, snap_last)
    del eng, f, cap, cap_full
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches, numbers


def stage_timer(times: dict):
    """A ``stage`` hook that times each stage between synchronisations."""
    import torch

    def timed(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*args, **kw)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return r

    return timed


def online_stages(dev, cap, table, snap):
    """The device-table pass over the full table's capture, stage by stage
    and end to end, beside the host-table pass over the same tree."""
    import torch

    from repro_torch.kernels import ops

    rep, extent, n_b, _ = table
    L = len(cap.slots)

    def device_pass(stage=ops._run_stage):
        return ops.offline_recluster_from_device_table(*cap.view, cap.origin, MIN_PTS, float(MIN_PTS),
                                                       slots=cap.slots, stage=stage)[0]

    def host_pass(stage=ops._run_stage):
        return ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev, stage=stage)

    t_dev, t_host = {}, {}
    for _ in range(2):  # the second round is the one reported (warm caches)
        res_d = device_pass(stage_timer(t_dev))
        res_h = host_pass(stage_timer(t_host))
    check(np.array_equal(res_d.labels, snap.bubble_labels), "[online] the timed device-table pass differs")
    check(res_h.n_bubbles == L, "[online] the host table's L differs from the flat table's")
    walls = {"device": [], "host": []}
    for _ in range(3):  # end to end, in turns
        for name, fn in (("device", device_pass), ("host", host_pass)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    for name, times in (("device-table", t_dev), ("host-table", t_host)):
        say(f"[online] {name} pass at L={L}, Lp={ops._pow2_rows(L)} (ms): "
            + ", ".join(f"{k} {v:.2f}" for k, v in times.items()) + f"; total {sum(times.values()):.2f}")
    say(f"[online] end to end (ms, in turns): device-table {', '.join(f'{w:.2f}' for w in walls['device'])}; "
        f"host-table {', '.join(f'{w:.2f}' for w in walls['host'])}")


def online_scatter(dev, eng, Qs):
    """flat_scatter against its plain version on the card at the stream's
    shapes (Bp = BLOCK rows of the query mixture, the run's flat Lp,
    d = 16): slots from the assign kernel as the insert path takes them,
    and a duplicate-heavy block over ONLINE_DUP_SLOTS slots; insert and
    delete, bit for bit, two runs bit for bit; then its time, the plain
    version's, the library call's and the bound."""
    import torch

    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import flat_scatter as k_fs
    from repro_torch.kernels import ref

    f = eng._flat
    Lp, d = f.LS.shape
    xc = torch.as_tensor((Qs[:BLOCK] - f.origin).astype(np.float32), device=dev)
    valid = torch.ones(BLOCK, dtype=torch.bool, device=dev)
    live = f.alive & (f.N > 0)
    reps = torch.where(live[:, None], f.LS / torch.clamp_min(f.N, 1.0)[:, None], 1e6).contiguous()
    slot_stream = k_assign.assign(xc, reps)
    live_slots = torch.nonzero(live).squeeze(1)
    pick = np.random.default_rng(SEED + 21).integers(0, ONLINE_DUP_SLOTS, BLOCK)
    slot_dup = live_slots[torch.as_tensor(pick, device=dev)].to(torch.int32)
    state = [t.clone() for t in (f.LS, f.LSe, f.SS, f.SSe, f.N)]
    thresh = float(eng.tree._leaf_cap_at(eng.tree.n_points + BLOCK))
    names = ("LS", "LSe", "SS", "SSe", "N", "flags")
    err = 0.0
    for label, slot in (("stream", slot_stream), ("duplicate-heavy", slot_dup)):
        for sign in (1, -1):
            want = ref.flat_scatter(*state, f.alive, xc, slot, valid, thresh, sign)
            runs = []
            for _ in range(2):
                got = [t.clone() for t in state]
                flags = k_fs.flat_scatter(*got, f.alive, xc, slot, valid, thresh, sign=sign)
                runs.append(got + [flags])
            torch.cuda.synchronize()
            bad = [n for n, g, w in zip(names, runs[0], want) if not torch.equal(g, w)]
            check(not bad, f"flat_scatter {label} sign {sign}: differs from the plain version in {bad}")
            err = max([err] + [abs_diff(g, w) for g, w in zip(runs[0], want)])
            check(all(torch.equal(a, b) for a, b in zip(*runs)), f"flat_scatter {label} sign {sign}: runs differ")
        per_slot = int(torch.bincount(slot.long()).max())
        say(f"[online] flat_scatter {label} block (Bp={BLOCK}, Lp={Lp}, d={d}, up to {per_slot} rows in one slot), "
            f"insert and delete: identical to the plain version (LS, LSe, SS, SSe, N, flags), a second run identical")
    work = [t.clone() for t in state]
    ms = time_ms(lambda: k_fs.flat_scatter(*work, f.alive, xc, slot_stream, valid, thresh, sign=1), reps=50)
    host = host_ms(lambda: k_fs.flat_scatter(*work, f.alive, xc, slot_stream, valid, thresh, sign=1))
    plain = time_ms(lambda: ref.flat_scatter(*state, f.alive, xc, slot_stream, valid, thresh, 1), reps=3, warm=1)
    at = (slot_stream.long(),)

    def library():  # index_put_ with accumulate (float atomics) and the compensated adds
        dLS = torch.zeros_like(work[0]).index_put_(at, xc, accumulate=True)
        dSS = torch.zeros_like(work[2]).index_put_(at, (xc * xc).sum(1), accumulate=True)
        dN = torch.zeros_like(work[4]).index_put_(at, torch.ones_like(xc[:, 0]), accumulate=True)
        ref.kahan_add(work[0], work[1], dLS)
        ref.kahan_add(work[2], work[3], dSS)
        return f.alive & (work[4] + dN > thresh)

    lib = time_ms(library, reps=20)
    one = torch.empty(1, device=dev)
    launch = time_ms(lambda: one.fill_(0.0), reps=200)
    nbytes = 4.0 * (2 * 2 * Lp * d + 2 * 3 * Lp + BLOCK * d + BLOCK) + 2.0 * Lp + BLOCK
    t_bytes = nbytes / PEAK_BYTES * 1e3
    b, by = max(t_bytes, launch), ("bytes" if t_bytes >= launch else "operations")
    say(f"[online] flat_scatter Bp={BLOCK} Lp={Lp} d={d}: kernel {ms:.4f} ms (host enqueue {host:.4f} ms per call), "
        f"plain {plain:.2f} ms, index_put_(accumulate) + Kahan {lib:.4f} ms, bound {b:.4f} ms (the larger of "
        f"{nbytes / 1e6:.3f} MB at 3.35 TB/s {t_bytes:.4f} ms and one launch, a one-element fill_ back to back, "
        f"{launch:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                launch_ms=launch, host_ms=host)


def online_drill(dev, card, ckpt, kw, flat, retire_blocks, published, snap_last):
    """[online]'s checkpoint (taken after the full flush) restored into a
    fresh card engine, which replays the retire blocks: every version
    published on the way and the final flat table bit for bit."""
    import shutil

    import torch

    from repro_torch import CheckpointStore, StreamingClusterEngine

    store = CheckpointStore(ckpt["root"])
    fresh = StreamingClusterEngine(DIM, device=dev, **kw)
    t0 = time.perf_counter()
    fresh.restore(store)
    restore_ms = (time.perf_counter() - t0) * 1e3
    store.close()
    check(not fresh._flat.stale, "[online] the restored flat table is stale")
    compared = 0
    for block in retire_blocks:
        v0 = fresh.snapshot.version
        fresh.retire(block)
        if fresh.snapshot.version != v0:
            same_snapshot(f"[online] version {fresh.snapshot.version}", fresh.snapshot,
                          published[fresh.snapshot.version])
            compared += 1
    same_snapshot("[online] final", fresh.flush(), snap_last)
    compared += 1
    g = fresh._flat
    for name in ("LS", "LSe", "SS", "SSe", "N", "alive"):
        check(bool(torch.equal(getattr(g, name), getattr(flat, name))), f"[online] restored flat {name} differs")
    check(g._free == flat._free and g._hi == flat._hi, "[online] restored free list differs")
    shutil.rmtree(ckpt["root"], ignore_errors=True)
    say(f"[online] checkpoint after the full flush ({ckpt['leaves']} leaves, {ckpt['disk']} bytes on disk, "
        f"checkpoint_state {ckpt['state_ms']:.1f} ms, restore {restore_ms:.1f} ms on {card}): the restored card "
        f"engine replayed {len(retire_blocks)} retire blocks, {compared} published versions bit for bit and the "
        f"final flat table (LS, LSe, SS, SSe, N, alive, free list) identical")


def tenant_data(rng, i, n):
    """benchmarks/fig9_service.py's tenant: 4 blobs around a centre 12·i
    apart per coordinate."""
    centers = rng.normal(size=(4, TENANT_DIM)) * 2.0 + 12.0 * i
    pick = rng.integers(0, 4, size=n)
    return centers[pick] + rng.normal(size=(n, TENANT_DIM)) * 0.6


def phase_tenants(dev, card):
    """The fig9 service deployment at a tenant's real size: TENANTS tenants
    of TENANT_POINTS points through one TenantRouter on the card, ingested
    interleaved, one closed-loop client per tenant (each answer held to the
    tenant's direct ``query_detailed``; each tenant's final snapshot and
    served rows held to the port's plain pipeline on the CPU), then
    ``save_all`` and a cold router's ``recover()`` serving the same
    labels."""
    import shutil
    import tempfile
    import threading

    from repro_torch import TenantRouter

    root = tempfile.mkdtemp(prefix="chip_smoke_tenants_")
    kw = dict(device=dev, cache_keep=2 * TENANTS, checkpoint_root=root, min_pts=TENANT_MIN_PTS,
              compression=TENANT_COMPRESSION, min_offline_points=16, epsilon=0.3)
    rng = np.random.default_rng(SEED + 11)
    names = [f"tenant{i:02d}" for i in range(TENANTS)]
    data = {n: tenant_data(rng, i, TENANT_POINTS) for i, n in enumerate(names)}
    reqs = {}
    for i, n in enumerate(names):
        qrng = np.random.default_rng(1000 + i)
        reqs[n] = [data[n][qrng.integers(0, TENANT_POINTS, size=TENANT_ROWS)] for _ in range(TENANT_REQUESTS)]
    router = TenantRouter(TENANT_DIM, **kw)
    reset_counts()
    t0 = time.perf_counter()
    for n in names:
        router.create(n)
    for off in range(0, TENANT_POINTS, TENANT_BLOCK):
        for n in names:
            router.submit_insert(n, data[n][off : off + TENANT_BLOCK])
        router.poll()
    router.flush()
    ingest_s = time.perf_counter() - t0
    tables = {n: router.engine(n)._table.capture(router.engine(n).tree.n_points).table() for n in names}
    direct = {n: [router.engine(n).query_detailed(q) for q in reqs[n]] for n in names}
    builds0, hits0 = router.cache.builds, router.cache.hits
    got = {n: [None] * TENANT_REQUESTS for n in names}
    lat = {n: [] for n in names}
    errors = []
    start = threading.Barrier(TENANTS + 1)

    def client(n):
        try:
            start.wait(timeout=60)
            for j, q in enumerate(reqs[n]):
                t1 = time.perf_counter()
                got[n][j] = router.query_detailed(n, q)
                lat[n].append((time.perf_counter() - t1) * 1e3)
        except BaseException as e:  # noqa: BLE001 — checked below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(n,)) for n in names]
    for t in threads:
        t.start()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=120)
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    check(not any(t.is_alive() for t in threads) and not errors, f"a tenant client failed: {errors[:1]}")
    bitwise = 0
    for n in names:
        for g, w in zip(got[n], direct[n]):
            check(g.version == w.version and np.array_equal(g.labels, w.labels)
                  and np.array_equal(g.bubble_index, w.bubble_index), f"{n}: routed labels differ")
            check(np.allclose(g.distance, w.distance, rtol=1e-6, atol=0)
                  and np.allclose(g.strength, w.strength, rtol=1e-6, atol=0), f"{n}: routed distances differ")
            bitwise += np.array_equal(g.distance, w.distance) and np.array_equal(g.strength, w.strength)
    p99 = {n: float(np.percentile(lat[n], 99)) for n in names}
    L = [router.engine(n).snapshot.n_bubbles for n in names]
    passes = sum(router.engine(n).stats["recluster_count"] for n in names)
    say(f"[tenants] {TENANTS} tenants x {TENANT_POINTS} points, d={TENANT_DIM}, in interleaved blocks of "
        f"{TENANT_BLOCK}, on {card}: ingest {ingest_s:.2f} s with {passes} offline passes, L {min(L)}..{max(L)}")
    say(f"[tenants] {TENANTS} closed-loop clients x {TENANT_REQUESTS} requests of {TENANT_ROWS} rows: "
        f"{serve_s * 1e3:.1f} ms wall; per-tenant p50/p99 (ms) "
        + ", ".join(f"{n[-2:]} {np.percentile(lat[n], 50):.3f}/{p99[n]:.3f}" for n in names)
        + f"; worst/best p99 {max(p99.values()) / min(p99.values()):.2f}; cache builds {router.cache.builds} "
        f"hits {router.cache.hits} ({router.cache.builds - builds0} builds, {router.cache.hits - hits0} hits in "
        f"the closed loop); batches {router.batcher.batches}; every answer equal to the tenant's direct "
        f"query_detailed ({bitwise} of {TENANTS * TENANT_REQUESTS} bit for bit in distance and strength)")
    say(f"[tenants] launches {json.dumps(launches)}")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched in [tenants]")
    for n in names:
        check_snapshot("tenants", n, router.engine(n).snapshot, tables[n], TENANT_MIN_PTS)
        check_served("tenants", router.engine(n).snapshot, np.concatenate(reqs[n]), got[n])
    t0 = time.perf_counter()
    steps = router.save_all()
    save_ms = (time.perf_counter() - t0) * 1e3
    versions = {n: router.engine(n).snapshot.version for n in names}
    router.close()
    cold = TenantRouter(TENANT_DIM, **kw)
    t0 = time.perf_counter()
    recovered = cold.recover()
    recover_ms = (time.perf_counter() - t0) * 1e3
    check(recovered == names and sorted(steps) == names, f"recovered {recovered}")
    for n in names:
        check(cold.engine(n).snapshot.version == versions[n], f"{n}: recovered version differs")
        for q, g in zip(reqs[n], got[n]):
            check(np.array_equal(cold.query(n, q), g.labels), f"{n}: labels served after recover() differ")
    cold.close()
    shutil.rmtree(root, ignore_errors=True)
    say(f"[tenants] save_all {save_ms:.1f} ms, a cold router's recover() {recover_ms:.1f} ms; every tenant's "
        f"served labels identical after the recovery")


GRID_KERNELS = ("grid_assign", "grid_core_distances", "grid_round_minima")
# csrc/grid.cu's first round, assign and Eq. 6 kernels: the redesigns' oracles, launched on no path
GRID_ORACLES = ("grid_round_minima_v1", "grid_assign_v1", "grid_core_distances_v1")
CD_SWEEP = (MIN_PTS, 100, 2000)  # [grid]: the path's min_pts, the Eq. 6 kernel's warp-select route in one and two rounds


def grid_counts(reset: bool = False) -> dict:
    """The grid kernels' launch counts (set to 0 first with ``reset``)."""
    from repro_torch.kernels import grid as k_grid

    if reset:
        for name in GRID_KERNELS + GRID_ORACLES:
            k_grid.launches[name] = 0
    return dict(k_grid.launches)


def no_oracle(tag: str, before: dict):
    """Fail if a first grid kernel (an oracle) launched since ``before``
    (``grid_counts()``): the stream ``tag`` names runs the new kernels only."""
    after = grid_counts()
    ran = {n: after[n] - before[n] for n in GRID_ORACLES if after[n] != before[n]}
    check(not ran, f"[{tag}] the first grid kernels ran on the path: {ran}")


def drive_stream(eng, X, Qs, drop):
    """[stream]'s operations on ``eng``: the blocks, a flush, the retires
    in blocks (by insert position), a flush, the queries in chunks.
    Returns every published snapshot by version, the served chunks, and
    ingest and retire ms per 1k points (offline passes excluded) and the
    query chunks' latencies (ms)."""
    history, pids, lat = {}, [], []
    ingest_s = retire_s = 0.0

    def note(before):
        snap = eng.snapshot
        if snap is not None and snap.version != before:
            history[snap.version] = snap

    def timed(fn, *args):
        off0 = eng.stats["offline_seconds_total"]
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0 - (eng.stats["offline_seconds_total"] - off0)

    for i in range(0, X.shape[0], BLOCK):
        v0 = 0 if eng.snapshot is None else eng.snapshot.version
        got, s = timed(eng.ingest, X[i : i + BLOCK])
        pids.extend(got)
        ingest_s += s
        note(v0)
    v0 = eng.snapshot.version
    eng.flush()
    note(v0)
    for i in range(0, len(drop), BLOCK):
        v0 = eng.snapshot.version
        retire_s += timed(eng.retire, [pids[j] for j in drop[i : i + BLOCK]])[1]
        note(v0)
    v0 = eng.snapshot.version
    eng.flush()
    note(v0)
    served = []
    for i in range(0, Qs.shape[0], QUERY_CHUNK):
        t0 = time.perf_counter()
        served.append(eng.query_detailed(Qs[i : i + QUERY_CHUNK]))
        lat.append((time.perf_counter() - t0) * 1e3)
    return history, served, ingest_s / X.shape[0] * 1e6, retire_s / len(drop) * 1e6, lat


def same_history(tag, got, want) -> int:
    """Every version published by both runs: the same versions, the same
    partition; returns how many are also bit for bit (labels and MST)."""
    check(sorted(got) == sorted(want), f"[{tag}] published versions {sorted(got)} != {sorted(want)}")
    exact = 0
    for v in sorted(want):
        a, b = got[v], want[v]
        check(a.n_bubbles == b.n_bubbles and np.array_equal(a.bubble_rep, b.bubble_rep),
              f"[{tag}] version {v}: the summaries differ")
        check(_same_partition(a.bubble_labels, b.bubble_labels), f"[{tag}] version {v}: partition differs")
        exact += bool(np.array_equal(a.bubble_labels, b.bubble_labels)
                      and all(np.array_equal(u, w) for u, w in zip(a.mst, b.mst)))
    return exact


def same_served(tag, got, want):
    """Served chunks bit for bit: labels, bubble_index, distance, strength."""
    for a, b in zip(got, want, strict=True):
        for f in ("labels", "bubble_index", "distance", "strength"):
            check(np.array_equal(getattr(a, f), getattr(b, f)), f"[{tag}] served {f} differ from the dense engine's")


def phase_grid(dev, run, card):
    """``spatial_index=True`` on the card: the [stream] configuration (the
    same data, blocks, retires and queries) through the grid engine, every
    published snapshot against the dense engine's and the served rows bit
    for bit; the three grid kernels bit for bit their dense counterparts
    and within tolerance of their plain versions on the full table, timed;
    the grid pass's stages, memory and host reads beside the dense pass's;
    a device-online grid stream against the host-table grid pass; and a
    d = 200 point.  Returns (launches, numbers) for the kernels line."""
    import torch

    from repro_torch import StreamingClusterEngine

    rng = np.random.default_rng(SEED + 1)  # [stream]'s data and retires
    data = mixture(rng, N_POINTS + N_QUERIES) + 50.0
    X, Qs = data[:N_POINTS], data[N_POINTS:]
    drop = rng.choice(N_POINTS, size=N_POINTS // 4, replace=False)
    kw = dict(min_pts=MIN_PTS, compression=COMPRESSION, epsilon=EPSILON, max_block=BLOCK, device=dev)
    eng = StreamingClusterEngine(DIM, spatial_index=True, **kw)
    reset_counts()
    grid_counts(reset=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history, served, ingest_ms, retire_ms, lat = drive_stream(eng, X, Qs, drop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = grid_counts()
    dense = read_counts()
    say(f"[grid] {N_POINTS} points d={DIM} in blocks of {BLOCK}, {len(drop)} retired, {N_QUERIES} queries, "
        f"spatial_index=True, on {card}: {wall:.2f} s wall ([stream] {run['wall_s']:.2f} s, its checkpoint "
        f"excluded), peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; {len(history)} "
        f"passes; launches {json.dumps(launches)}; dense kernels {json.dumps(dense)}")
    for name in GRID_KERNELS:
        check(launches[name] > 0, f"[grid] kernel {name} never launched on the spatial stream")
    check(all(launches[n] == 0 for n in GRID_ORACLES), f"[grid] a first grid kernel ran on the stream: {launches}")
    check(dense["assign"] == dense["bubble_cd"] == dense["mutual_reach"] == 0,
          f"[grid] the spatial stream ran dense kernels: {dense}")
    n_passes = eng.stats["recluster_count"]
    check(launches["grid_core_distances"] == n_passes, "[grid] not one Eq. 6 launch per pass")
    say(f"[grid] ingest {ingest_ms:.3f} ms per 1k points, retire {retire_ms:.3f} (offline passes excluded; "
        f"[stream]'s {run['ingest_ms']:.3f}, {run['retire_ms']:.3f}); query latency per {QUERY_CHUNK}-row chunk: "
        f"p50 {np.median(lat):.3f} ms, min {min(lat):.3f} ms, max {max(lat):.3f} ms")
    exact = same_history("grid", history, run["history"])
    same_served("grid", served, run["served"])
    say(f"[grid] every one of the {len(history)} published snapshots has the dense engine's partition "
        f"({exact} also bit for bit in labels and MST); the {len(served)} served chunks are bit for bit the "
        f"dense engine's (labels, bubble_index, distance, strength)")
    del eng, history, served
    numbers = grid_kernels(dev, run, X)
    grid_pass(dev, run["table_full"])
    grid_online(dev, X, drop, kw, card)
    grid_wide(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches, numbers


MESH_KS = (1, 2, 4, 8)  # [mesh]: shards of one card (cuda:0 named k times)
MESH_BIG_L, MESH_BIG_KS = 20_000, (4, 8)  # [mesh]: L = 20,000 bubbles, Lp = 32,768 (one dense W is 4 GiB)
MESH_N, MESH_ENGINE_K = 65_536, 4  # [mesh]: the [stream] configuration cut to 65,536 points, mesh of 4
MESH_KERNELS = ("bubble_cd", "mutual_reach", "grid_core_distances", "grid_round_minima")


def mesh_counts(reset: bool = False) -> dict:
    """The launch counts of the four kernels the sharded pass runs per
    shard (set to 0 first with ``reset``)."""
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import grid as k_grid
    from repro_torch.kernels import mutual_reach as k_mr

    if reset:
        k_bcd.launches = k_mr.launches = 0
        for name in GRID_KERNELS:
            k_grid.launches[name] = 0
    return {"bubble_cd": k_bcd.launches, "mutual_reach": k_mr.launches,
            "grid_core_distances": k_grid.launches["grid_core_distances"],
            "grid_round_minima": k_grid.launches["grid_round_minima"]}


def same_result(name, got, want):
    """Two passes' results bit for bit: labels, MST u/v/w, stabilities and
    every condensed field."""
    for f in ("labels", "stabilities", "weights", "point_parent", "point_lambda", "cluster_parent",
              "cluster_birth", "cluster_weight", "selected", "all_stabilities"):
        check(np.array_equal(getattr(got, f), getattr(want, f)), f"{name}: {f} differs from the unsharded pass")
    check(all(np.array_equal(a, b) for a, b in zip(got.mst, want.mst)), f"{name}: the MST differs")


def no_sync_stage(name, fn, *args, **kw):
    """A ``stage`` hook under which any host synchronisation between
    prepare and unwrap raises."""
    import torch

    if name in ("prepare", "unwrap"):
        return fn(*args, **kw)
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def sync_all():
    """Wait for every card (a sharded pass's strips may sit on several)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def peak_mib(fn, cards: int = 1) -> list:
    """Peak device memory allocated by ``fn`` above what was allocated
    before, on each of the first ``cards`` cards (MiB)."""
    import torch

    sync_all()
    torch.cuda.empty_cache()
    base = [torch.cuda.memory_allocated(i) for i in range(cards)]
    for i in range(cards):
        torch.cuda.reset_peak_memory_stats(i)
    fn()
    sync_all()
    return [(torch.cuda.max_memory_allocated(i) - base[i]) / 2**20 for i in range(cards)]


def stage_timer_all(times: dict):
    """``stage_timer`` with every card synchronised around each stage."""

    def timed(name, fn, *args, **kw):
        sync_all()
        t0 = time.perf_counter()
        r = fn(*args, **kw)
        sync_all()
        times[name] = (time.perf_counter() - t0) * 1e3
        return r

    return timed


def mesh_strips(tag, dev, rep, nb, ext, k, spatial: bool):
    """Each shard's strip launches at this k: bit for bit the same rows of
    the whole launch, timed one by one (their sum beside the whole
    launch); each shard's peak device memory for its Eq. 6 and Eq. 7
    strips and one Borůvka round's minima; the dense strips' W bytes."""
    import torch

    from repro_torch.core import mst as t_mst
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import grid as k_grid
    from repro_torch.kernels import mutual_reach as k_mr
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import shard_ranges

    Lp, d = rep.shape
    L = int((nb > 0).sum())
    mp = MIN_PTS
    if not spatial:
        cd = k_bcd.bubble_core_distances(rep, nb, ext, min_pts=mp, dim=d)
        W = k_mr.mutual_reachability(rep, rep, cd, cd, zero_diag=True, n_valid=L)
        whole = {"bubble_cd": time_ms(lambda: k_bcd.bubble_core_distances(rep, nb, ext, min_pts=mp, dim=d)),
                 "mutual_reach": time_ms(lambda: k_mr.mutual_reachability(rep, rep, cd, cd, zero_diag=True,
                                                                          n_valid=L))}
        times, peaks = {"bubble_cd": [], "mutual_reach": []}, []
        labels = torch.arange(Lp, device=dev)
        for a, b in shard_ranges(Lp, k):
            s_cd = k_bcd.bubble_core_distances(rep, nb, ext, min_pts=mp, dim=d, rows=(a, b))
            s_w = k_mr.mutual_reachability(rep[a:b], rep, cd[a:b], cd, zero_diag=True, n_valid=L, row0=a)
            check(bool(torch.equal(s_cd, cd[a:b])), f"[{tag}] bubble_cd rows [{a}, {b}) differ from the whole launch")
            check(bool(torch.equal(s_w, W[a:b])), f"[{tag}] mutual_reach rows [{a}, {b}) differ from the whole launch")
            times["bubble_cd"].append(time_ms(
                lambda: k_bcd.bubble_core_distances(rep, nb, ext, min_pts=mp, dim=d, rows=(a, b))))
            times["mutual_reach"].append(time_ms(
                lambda: k_mr.mutual_reachability(rep[a:b], rep, cd[a:b], cd, zero_diag=True, n_valid=L, row0=a)))
            del s_w

            def shard_work():
                c = k_bcd.bubble_core_distances(rep, nb, ext, min_pts=mp, dim=d, rows=(a, b))
                w = k_mr.mutual_reachability(rep[a:b], rep, c, cd, zero_diag=True, n_valid=L, row0=a)
                t_mst._strip_minima(w, t_mst._strip_eid(a, b - a, Lp, dev), labels, a)

            peaks.append(peak_mib(shard_work)[0])
        del W
        strip_mib = -(-Lp // k) * Lp * 4 / 2**20
    else:
        grid, views = ops._grid_table(rep, L)
        cd = k_grid.grid_core_distances(grid, nb, ext, mp, d, views)
        labels = torch.arange(Lp, device=dev)
        hopeless = torch.zeros(Lp, dtype=torch.bool, device=dev)
        w, e = k_grid.grid_round_minima(grid, views, cd, labels, hopeless)
        rows = grid.orig.long()
        cd_s, w_s, e_s = cd[rows], w[rows], e[rows]
        whole = {"grid_core_distances": time_ms(lambda: k_grid.grid_core_distances(grid, nb, ext, mp, d, views)),
                 "grid_round_minima": time_ms(lambda: k_grid.grid_round_minima(grid, views, cd, labels, hopeless))}
        times, peaks = {"grid_core_distances": [], "grid_round_minima": []}, []
        bn = views.block
        for b0, b1 in shard_ranges(views.order.shape[0], k):
            g_cd = k_grid.grid_core_distances(grid, nb, ext, mp, d, views, blocks=(b0, b1))
            g_w, g_e = k_grid.grid_round_minima(grid, views, cd, labels, hopeless, blocks=(b0, b1))
            r = slice(b0 * bn, b1 * bn)
            check(bool(torch.equal(g_cd, cd_s[r])), f"[{tag}] grid_core_distances blocks [{b0}, {b1}) differ")
            for c in k_grid.CLUSTERS:
                got = k_grid.grid_core_distances(grid, nb, ext, mp, d, views, blocks=(b0, b1), cluster=c)
                check(bool(torch.equal(got, g_cd)), f"[{tag}] grid_core_distances blocks [{b0}, {b1}) at cluster {c} "
                      f"differ from the default cluster's")
            got = k_grid.grid_core_distances_v1(grid, nb, ext, mp, d, views, blocks=(b0, b1))
            check(bool(torch.equal(got, g_cd)), f"[{tag}] grid_core_distances_v1 blocks [{b0}, {b1}) differ")
            check(bool(torch.equal(g_w, w_s[r])) and bool(torch.equal(g_e, e_s[r])),
                  f"[{tag}] grid_round_minima blocks [{b0}, {b1}) differ")
            times["grid_core_distances"].append(time_ms(
                lambda: k_grid.grid_core_distances(grid, nb, ext, mp, d, views, blocks=(b0, b1))))
            times["grid_round_minima"].append(time_ms(
                lambda: k_grid.grid_round_minima(grid, views, cd, labels, hopeless, blocks=(b0, b1))))
            peaks.append(peak_mib(lambda: (k_grid.grid_core_distances(grid, nb, ext, mp, d, views, blocks=(b0, b1)),
                                           k_grid.grid_round_minima(grid, views, cd, labels, hopeless,
                                                                    blocks=(b0, b1))))[0])
        strip_mib = 0.0
    say(f"[{tag}] k={k} {'grid' if spatial else 'dense'} strips bit for bit the whole launches; per shard (ms): "
        + "; ".join(f"{n} {', '.join(f'{t:.4f}' for t in ts)} (sum {sum(ts):.4f}, whole launch {whole[n]:.4f})"
                    for n, ts in times.items())
        + f"; peak per shard (MiB) {', '.join(f'{p:.1f}' for p in peaks)}"
        + (f"; W strip {strip_mib:.1f} MiB per shard (Lp/k x Lp x 4)" if not spatial else ""))
    return {n: sum(ts) for n, ts in times.items()}


def mesh_table(tag, dev, table, meshes, spatial_modes, cap=None):
    """The sharded pass over one host table for each of ``meshes`` (k, the
    number of times ``dev`` is named, or True for every card): dense and
    grid, bit for bit the unsharded pass (also from the device-online
    capture ``cap`` when given); its stages, Borůvka's gathers, the pass
    end to end in turns beside the unsharded one, launches per pass, peak
    device memory per card, no host read from prepare to unwrap; and, on
    one card, ``mesh_strips``."""
    import torch

    from repro_torch.core import mst as t_mst
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import resolve_mesh, shard_ranges

    rep, extent, n_b, _ = table
    L = rep.shape[0]
    Lp = ops._pow2_rows(L)

    def run(mesh, sp, stage=ops._run_stage):
        return ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev, stage=stage,
                                                spatial_index=sp, mesh=mesh)

    (rep_t, nb_t, ext_t), _, _ = ops._prepare_table(rep, n_b, extent, MIN_PTS, dev)
    rounds = t_mst._rounds(Lp)[0]
    for sp in spatial_modes:
        name = "grid" if sp else "dense"
        base_t = {}
        for _ in range(2):
            want = run(None, sp, stage_timer_all(base_t))
        base_peak = peak_mib(lambda: run(None, sp))[0]
        say(f"[{tag}] unsharded {name} pass at L={L}, Lp={Lp} (ms): "
            + ", ".join(f"{s} {v:.2f}" for s, v in base_t.items())
            + f"; total {sum(base_t.values()):.2f}; peak {base_peak:.1f} MiB above the table")
        for m in meshes:
            mesh = (dev,) * m if m is not True else True
            resolved = resolve_mesh(mesh, dev)
            k = len(resolved.devices)
            cards = len(set(resolved.devices))
            label = f"k={k}" + (f" over {cards} cards (mesh=True)" if m is True else "")
            t = {}
            for _ in range(2):
                got = run(mesh, sp, stage_timer_all(t))
            same_result(f"[{tag}] {label} {name}", got, want)
            walls = {None: [], m: []}
            for mm in (None, m, m, None):
                sync_all()
                t0 = time.perf_counter()
                run(None if mm is None else mesh, sp)
                walls[mm].append((time.perf_counter() - t0) * 1e3)
            before = mesh_counts()
            run(mesh, sp)
            after = mesh_counts()
            per_pass = {n: after[n] - before[n] for n in MESH_KERNELS}
            peak = peak_mib(lambda: run(mesh, sp), cards)
            sync_all()
            same_result(f"[{tag}] {label} {name} under the sync debug mode", run(mesh, sp, no_sync_stage), want)
            if cap is not None:
                dt_want = ops.offline_recluster_from_device_table(*cap.view, cap.origin, MIN_PTS, float(MIN_PTS),
                                                                  slots=cap.slots, spatial_index=sp)
                dt_got = ops.offline_recluster_from_device_table(*cap.view, cap.origin, MIN_PTS, float(MIN_PTS),
                                                                 slots=cap.slots, spatial_index=sp, mesh=mesh,
                                                                 stage=no_sync_stage)
                same_result(f"[{tag}] {label} {name} device table", dt_got[0], dt_want[0])
                check(all(np.array_equal(a, b) for a, b in zip(dt_got[1:], dt_want[1:])),
                      f"[{tag}] {label} device table: the serve-plane table differs")
            pieces = [torch.zeros(b - a, device=dev) for a, b in shard_ranges(Lp, k)]
            gather_ms = time_ms(lambda: torch.cat(pieces), reps=50)
            say(f"[{tag}] {label} sharded {name} pass bit for bit the unsharded one"
                + (" (and from the device-online table)" if cap is not None else "")
                + ", no host synchronisation from prepare to unwrap; stages (ms): "
                + ", ".join(f"{s} {v:.2f}" for s, v in t.items()) + f"; total {sum(t.values()):.2f}; "
                f"Borůvka {t['boruvka']:.2f} against {base_t['boruvka']:.2f} unsharded, with {2 * rounds} gathers a "
                f"pass (row w and eid, {rounds} rounds; one gather of {k} pieces on one card {gather_ms:.4f} ms); "
                f"end to end in turns (ms) unsharded {', '.join(f'{w:.2f}' for w in walls[None])}, sharded "
                f"{', '.join(f'{w:.2f}' for w in walls[m])}; launches per pass {json.dumps(per_pass)}; peak "
                f"{', '.join(f'{p:.1f}' for p in peak)} MiB above the table per card (unsharded {base_peak:.1f})")
            n_shards = sum(b > a for a, b in shard_ranges(Lp // min(64, Lp) if sp else Lp, k))
            launched = (per_pass["grid_core_distances"],) if sp else (per_pass["bubble_cd"], per_pass["mutual_reach"])
            check(all(n == n_shards for n in launched),
                  f"[{tag}] {label} {name}: launches per pass {per_pass} for {n_shards} non-empty shards")
            if m is not True:
                mesh_strips(tag, dev, rep_t, nb_t, ext_t, k, sp)
            torch.cuda.empty_cache()


def mesh_engine(dev, card):
    """The [stream] configuration cut to MESH_N points, with
    ``mesh=("cuda:0",) * MESH_ENGINE_K`` beside the unsharded engine, dense
    and spatial: every snapshot and the served rows bit for bit.  The four
    kernels' launches are counted over the mesh engines' runs alone."""
    from repro_torch import StreamingClusterEngine

    rng = np.random.default_rng(SEED + 7)
    data = mixture(rng, MESH_N + 8 * QUERY_CHUNK) + 50.0
    X, Qs = data[:MESH_N], data[MESH_N:]
    drop = rng.choice(MESH_N, size=MESH_N // 4, replace=False)
    kw = dict(min_pts=MIN_PTS, compression=COMPRESSION, epsilon=EPSILON, max_block=BLOCK, device=dev)
    launches = {}
    for sp in (False, True):
        name = "grid" if sp else "dense"
        before = grid_counts()
        plain_hist, plain_served, *_ = drive_stream(StreamingClusterEngine(DIM, spatial_index=sp, **kw), X, Qs, drop)
        eng = StreamingClusterEngine(DIM, spatial_index=sp, mesh=(dev,) * MESH_ENGINE_K, **kw)
        mesh_counts(reset=True)
        t0 = time.perf_counter()
        hist, served, ingest_ms, retire_ms, lat = drive_stream(eng, X, Qs, drop)
        wall = time.perf_counter() - t0
        counts = mesh_counts()
        no_oracle(f"mesh {name} engines", before)
        check(sorted(hist) == sorted(plain_hist), f"[mesh] {name} engine: published versions differ")
        for v in sorted(hist):
            same_result(f"[mesh] {name} engine version {v}", hist[v].result, plain_hist[v].result)
            check(np.array_equal(hist[v].bubble_rep, plain_hist[v].bubble_rep), f"[mesh] version {v}: reps differ")
        same_served(f"mesh {name}", served, plain_served)
        n_passes = eng.stats["recluster_count"]
        say(f"[mesh] {name} engine, {MESH_N} points d={DIM} in blocks of {BLOCK}, {len(drop)} retired, mesh of "
            f"{MESH_ENGINE_K} x {dev} on {card}: {wall:.2f} s wall, {n_passes} passes; every one of the {len(hist)} "
            f"snapshots and the {len(served)} served chunks bit for bit the unsharded engine's; launches "
            f"{json.dumps(counts)}")
        keys = ("grid_core_distances", "grid_round_minima") if sp else ("bubble_cd", "mutual_reach")
        for k in keys:
            check(counts[k] > 0, f"[mesh] kernel {k} never launched on the {name} mesh engine")
            launches[k] = counts[k]
        if not sp:
            check(counts["bubble_cd"] == counts["mutual_reach"] == MESH_ENGINE_K * n_passes,
                  f"[mesh] not one Eq. 6 and one Eq. 7 launch per shard per pass: {counts}, {n_passes} passes")
    return launches


def phase_mesh(dev, run, card):
    """``mesh=`` on the card (DESIGN.md §12): the sharded offline pass on
    ``cuda:0`` named k = 1, 2, 4 and 8 times over the [stream] table, dense
    and grid, host-table and device-online, bit for bit the unsharded pass;
    a table at Lp = 32,768; ``mesh=True`` over every card where there are
    several; the [stream] engine cut to 65,536 points with a mesh of 4.
    Returns the four kernels' launches on the mesh engines."""
    import torch

    from repro_torch.core.bubble_flat import BubbleFlat
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    eng = run["eng"]
    flat = BubbleFlat(DIM, device=dev)
    flat.load(eng.tree)
    cap = flat.capture(eng.tree.n_points)
    meshes = list(MESH_KS) + ([True] if torch.cuda.device_count() > 1 else [])
    mesh_table("mesh", dev, run["table_full"], meshes, (False, True), cap)
    del flat, cap
    rng = np.random.default_rng(SEED + 8)
    big_rep = mixture(rng, MESH_BIG_L) + 50.0
    big = (big_rep, rng.uniform(0.5, 1.5, size=MESH_BIG_L), rng.integers(10, 90, size=MESH_BIG_L).astype(float), None)
    say(f"[mesh] a table of L={MESH_BIG_L} bubbles (reps from the stream's mixture, masses 10-89, extents 0.5-1.5), "
        f"Lp={ops._pow2_rows(MESH_BIG_L)}: one dense W is {ops._pow2_rows(MESH_BIG_L) ** 2 * 4 / 2**30:.0f} GiB")
    mesh_table("mesh big", dev, big, list(MESH_BIG_KS) + meshes[len(MESH_KS):], (False,))
    torch.cuda.empty_cache()
    launches = mesh_engine(dev, card)
    say(f"[mesh] phase {time.perf_counter() - t0:.1f} s")
    return launches


def grid_bitwise(tag, dev, table, q_ingest, snap, Qs, min_pts_list):
    """The grid kernels bit for bit their dense counterparts on ``table``
    padded as the offline pass pads it: Eq. 6 at each min_pts against
    bubble_cd's route for it, assign at the ingest shape (``q_ingest``
    against the table's reps, centred as the engine's ingest centres them)
    and at the query shape (a chunk of ``Qs`` against ``snap``'s serve
    entry), boruvka_grid against dense Borůvka on the panel's W of the same
    core distances.  Returns the padded table, its grid and visit lists."""
    import torch

    from repro_torch.core.mst import boruvka, boruvka_grid
    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import grid as k_grid
    from repro_torch.kernels import mutual_reach as k_mr
    from repro_torch.kernels import ops
    from repro_torch.serving.query import _build_entry

    rep, extent, n_b, _ = table
    L, d = rep.shape
    (rep_t, nb_t, ext_t), mp, _ = ops._prepare_table(rep, n_b, extent, MIN_PTS, dev)
    grid, views = ops._grid_table(rep_t, L)
    routes = []
    for m in min_pts_list:
        mpc = ops._clamp_min_pts(m, float(n_b.sum()))
        got = k_grid.grid_core_distances(grid, nb_t, ext_t, mpc, d, views)
        want = k_bcd.bubble_core_distances(rep_t, nb_t, ext_t, min_pts=mpc, dim=d)
        check(bool(torch.equal(got[:L], want[:L])), f"[{tag}] grid_core_distances at min_pts {mpc} differs from "
              f"bubble_cd ({int((got[:L] != want[:L]).sum())} of {L} rows)")
        routes.append(f"{mpc} ({k_bcd.route(d, mpc)})")
    mu = rep.mean(axis=0)
    q = torch.as_tensor((q_ingest - mu).astype(np.float32), device=dev)
    r = torch.as_tensor((rep - mu).astype(np.float32), device=dev)
    gi, gd = ops.assign(q, r, with_dist=True, spatial_index=True)
    di, dd = k_assign.assign(q, r, with_dist=True)
    check(bool(torch.equal(gi, di)) and bool(torch.equal(gd, dd)),
          f"[{tag}] grid_assign at the ingest shape differs from assign ({int((gi != di).sum())} indices)")
    Lp = rep_t.shape[0]  # ops.assign's grid: the reps padded as the offline pass pads them
    g_in = k_grid.build_grid(torch.cat([r, r.new_full((Lp - L, d), ops._PAD_COORD)]), torch.arange(Lp, device=dev) < L)
    oi, od = k_grid.grid_assign_v1(g_in, q)
    check(bool(torch.equal(gi, oi)) and bool(torch.equal(gd, od)),
          f"[{tag}] grid_assign at the ingest shape differs from grid_assign_v1 ({int((gi != oi).sum())} indices)")
    entry = _build_entry(snap, dev, spatial=True)
    qq = torch.as_tensor((Qs[:QUERY_CHUNK] - entry.center[None, :]).astype(np.float32), device=dev)
    gi, gd = k_grid.grid_assign(entry.grid, qq)
    di, dd = k_assign.assign(qq, entry.reps, with_dist=True)
    check(bool(torch.equal(gi, di)) and bool(torch.equal(gd, dd)),
          f"[{tag}] grid_assign at the query shape differs from assign ({int((gi != di).sum())} indices)")
    oi, od = k_grid.grid_assign_v1(entry.grid, qq)
    check(bool(torch.equal(gi, oi)) and bool(torch.equal(gd, od)),
          f"[{tag}] grid_assign at the query shape differs from grid_assign_v1 ({int((gi != oi).sum())} indices)")
    cd = k_grid.grid_core_distances(grid, nb_t, ext_t, mp, d, views)
    W = k_mr.mutual_reachability(rep_t, rep_t, cd, cd, zero_diag=True, n_valid=L)
    want = boruvka(W)
    del W
    got = boruvka_grid(grid, cd, views)
    for name, a, b in zip(("eu", "ev", "ew", "valid"), got, want):
        check(bool(torch.equal(a, b)), f"[{tag}] boruvka_grid's {name} differs from dense Borůvka's")
    say(f"[{tag}] L={L}, Lp={rep_t.shape[0]}, d={d}: grid_core_distances bit for bit bubble_cd at min_pts "
        f"{', '.join(routes)}; grid_assign bit for bit assign and grid_assign_v1 at the ingest shape ({q.shape[0]} "
        f"rows x {L} reps) "
        f"and the query shape ({qq.shape[0]} rows x the final snapshot's {snap.n_bubbles} in its bucket "
        f"{entry.bucket}); boruvka_grid's (eu, ev, ew, valid) bit for bit dense Borůvka on the panel's W "
        f"({int(got[3].sum())} edges)")
    return (rep_t, nb_t, ext_t, mp, L), grid, views, q, r, qq, entry


def visits_of(fn):
    """Row-tile visits of the grid kernels during one call of ``fn``."""
    import torch

    from repro_torch.kernels import grid as k_grid

    k_grid.track_visits(True, torch.device("cuda", torch.cuda.current_device()))
    try:
        fn()
        return k_grid.visit_counts()
    finally:
        k_grid.track_visits(False)


def call_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler after a warm call: device
    launches, device busy ms, the host's enqueue (the call returning, before
    the synchronisation) and the busiest kernel's ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = max((e.self_device_time_total for e in events), default=0.0) / 1e3
    return dict(launches=sum(e.count for e in events), busy_ms=sum(e.self_device_time_total for e in events) / 1e3,
                enqueue_ms=enqueue, kernel_ms=top)


def assign_shape(g, qx, reps, d) -> dict:
    """Both assign kernels at one shape (queries ``qx`` against the grid
    ``g`` of ``reps``): the kernel alone on the Morton-sorted queries
    (device ms behind a spin) and the whole call (time_ms), each in turns
    new, v1, v1, new; the host enqueue of both calls; the visits the
    function needs (the first kernel's, which stops on each block's bests)
    and the bound from them, the new kernel's own visits and the longest
    walk of a CTA of both; cdist+min as the library; one whole call under
    torch.profiler."""
    import torch

    from repro_torch.kernels import grid as k_grid

    xs, _, views = k_grid._query_views(g, qx)
    kern = {"new": lambda: k_grid._assign_sorted("grid_assign", "repro_grid_assign_tiles_f32",
                                                 (k_grid.ASSIGN_CLUSTER,), g, xs, views),
            "v1": lambda: k_grid._assign_sorted("grid_assign_v1", "repro_grid_assign_f32", (), g, xs, views)}
    call = {"new": lambda: k_grid.grid_assign(g, qx), "v1": lambda: k_grid.grid_assign_v1(g, qx)}
    turns, call_turns = {"new": [], "v1": []}, {"new": [], "v1": []}
    for which in ("new", "v1", "v1", "new"):
        turns[which].append(device_ms(kern[which], reps=20))
        call_turns[which].append(time_ms(call[which], reps=20))
    v1 = visits_of(kern["v1"])
    new = visits_of(kern["new"])
    B, NT = qx.shape[0], g.tile_lo.shape[0]
    flops = 2.0 * d * g.tile * v1["grid_assign"]
    nbytes = 4.0 * (g.pts.shape[0] * d + 2 * views.order.numel() + B * (d + 2))
    b, by = bound_ms(flops, nbytes)
    return dict(ms=float(np.mean(turns["new"])), v1_ms=float(np.mean(turns["v1"])), turns=turns,
                call_ms=float(np.mean(call_turns["new"])), v1_call_ms=float(np.mean(call_turns["v1"])),
                call_turns=call_turns, host_ms=host_ms(call["new"]), v1_host_ms=host_ms(call["v1"]),
                visits=v1["grid_assign"], kernel_visits=new["grid_assign"],
                extra_visits=new["grid_assign"] - v1["grid_assign"], walk=new["grid_assign_longest"],
                v1_walk=v1["grid_assign_longest"], bound_ms=b, bound_by=by,
                library_ms=time_ms(lambda: torch.cdist(qx, reps).min(dim=1)), blocks=views.order.shape[0],
                tiles=NT, profile=call_profile(call["new"]))


def grid_kernels(dev, run, X):
    """The three kernels on the full table (L = 5,243, Lp = 8192): bit for
    bit their dense counterparts, within tolerance of their plain
    versions; kernel, plain and library times; the visited share of the
    (rows, tiles) pairs; the bound from the visited tiles."""
    import torch

    from repro_torch.kernels import grid as k_grid
    from repro_torch.kernels import ref

    (rep_t, nb_t, ext_t, mp, L), grid, views, q, r, qq, entry = grid_bitwise(
        "grid", dev, run["table_full"], X[:BLOCK], run["snap_last"], run["Qs"], (MIN_PTS, 100, K_STRIP))
    Lp, d = rep_t.shape
    NT = grid.tile_lo.shape[0]
    counts = grid_counts()
    out = {}

    def report(name, n_rows, visits, ms, plain, lib, err, extra=""):
        flops = 2.0 * d * grid.tile * visits
        nbytes = 4.0 * (Lp * d + 2 * views.order.numel() + n_rows * (d + 2))
        b, by = bound_ms(flops, nbytes)
        share = visits / (n_rows * NT)
        say(f"[grid] {name}: kernel {ms:.4f} ms, plain {plain:.2f} ms, library {lib if lib is None else f'{lib:.4f}'}"
            f" ms, bound {b:.4f} ms ({by}: {visits} row-tile visits, {share:.4f} of {n_rows} rows x {NT} tiles); "
            f"max abs err {err:.3e} against the plain version{extra}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                         visited_share=share)

    # grid_assign at the ingest shape, against its plain version on the same sorted queries
    g = k_grid.build_grid(torch.cat([r, r.new_full((Lp - L, d), 1e6)]), torch.arange(Lp, device=dev) < L)
    qt, _ = tie_free_rows(q, r)
    xs, qperm, qviews = k_grid._query_views(g, qt)
    pidx, psq = ref.grid_assign(g, xs, qviews)
    gidx, gdist = k_grid.grid_assign(g, qt)
    check(bool(torch.equal(gidx[qperm], pidx)), "[grid] grid_assign: indices differ from the plain version")
    err, _ = compare("grid_assign", gdist[qperm], psq.sqrt(), dist_tol(qt, r, psq.sqrt()))
    # the first kernel on the same rows: its own error against the plain version, and bit for bit the new kernel
    vidx, vdist = k_grid.grid_assign_v1(g, qt)
    check(bool(torch.equal(vidx[qperm], pidx)), "[grid] grid_assign_v1: indices differ from the plain version")
    v1_err, _ = compare("grid_assign_v1", vdist[qperm], psq.sqrt(), dist_tol(qt, r, psq.sqrt()))
    check(bool(torch.equal(vidx, gidx)) and bool(torch.equal(vdist, gdist)),
          f"[grid] grid_assign differs from grid_assign_v1 on the tie-free rows ({int((vidx != gidx).sum())} indices, "
          f"{int((vdist != gdist).sum())} distances)")
    plain = None
    shapes = {}
    for shape, gg, qx, reps in (("ingest", g, q, r), ("query", entry.grid, qq, entry.reps)):
        shapes[shape] = assign_shape(gg, qx, reps, d)
        if plain is None:
            xs_i, _, v_i = k_grid._query_views(gg, qx)
            plain = time_ms(lambda: ref.grid_assign(gg, xs_i, v_i), reps=1, warm=1)
    ing, qry = shapes["ingest"], shapes["query"]
    report("grid_assign", q.shape[0], ing["visits"], ing["ms"], plain, ing["library_ms"], err,
           f" ({q.shape[0]} rows x {L} reps, the ingest shape: the kernel alone on Morton-sorted queries, device ms "
           f"behind a spin; the bound counts the visits the function needs, the first kernel's)")
    report("grid_assign_v1", q.shape[0], ing["visits"], ing["v1_ms"], plain, ing["library_ms"], v1_err,
           " (the first kernel, csrc/grid.cu)")
    for shape, got in shapes.items():
        n_rows = q.shape[0] if shape == "ingest" else qq.shape[0]
        reps_n = L if shape == "ingest" else f"the final snapshot's {entry.n_bubbles} in its bucket {entry.bucket}"
        say(f"[grid] grid_assign, {shape} shape ({n_rows} rows x {reps_n}, {got['blocks']} blocks x {got['tiles']} "
            f"tiles), in turns new, v1, v1, new: kernel alone {', '.join(f'{t:.4f}' for t in got['turns']['new'])} "
            f"ms [v1 {', '.join(f'{t:.4f}' for t in got['turns']['v1'])}]; the whole call (Morton sort, visit lists, "
            f"search, scatter) {', '.join(f'{t:.4f}' for t in got['call_turns']['new'])} ms [v1 "
            f"{', '.join(f'{t:.4f}' for t in got['call_turns']['v1'])}], host enqueue {got['host_ms']:.4f} ms [v1 "
            f"{got['v1_host_ms']:.4f}]; bound {got['bound_ms']:.4f} ms ({got['bound_by']}: the {got['visits']} "
            f"row-tile visits the function needs, the first kernel's, {got['visits'] / (n_rows * got['tiles']):.4f} "
            f"of rows x tiles); library {got['library_ms']:.4f} ms (cdist+min)")
        say(f"[grid] grid_assign, {shape} shape: the new kernel's own visits {got['kernel_visits']} "
            f"(+{got['extra_visits']} from the cluster's stop, in no bound); longest walk of a CTA {got['walk']} at "
            f"cluster {k_grid.ASSIGN_CLUSTER} [v1 {got['v1_walk']}]; one whole call under torch.profiler: "
            f"{got['profile']['launches']} device launches, device busy {got['profile']['busy_ms']:.4f} ms, host "
            f"enqueue {got['profile']['enqueue_ms']:.4f} ms (traced), of which the search kernel "
            f"{got['profile']['kernel_ms']:.4f} ms")
    out["grid_assign"].update(cluster=k_grid.ASSIGN_CLUSTER, v1_ms=ing["v1_ms"], call_ms=ing["call_ms"],
                              v1_call_ms=ing["v1_call_ms"], host_ms=ing["host_ms"], kernel_visits=ing["kernel_visits"],
                              extra_visits=ing["extra_visits"], walk=ing["walk"], v1_walk=ing["v1_walk"],
                              call_launches=ing["profile"]["launches"],
                              query={k: qry[k] for k in ("ms", "v1_ms", "call_ms", "v1_call_ms", "host_ms", "bound_ms",
                                                         "bound_by", "library_ms", "visits", "kernel_visits",
                                                         "extra_visits", "walk", "v1_walk")})
    out["grid_assign_v1"].update(walk=ing["v1_walk"], call_ms=ing["v1_call_ms"],
                                 query={"ms": qry["v1_ms"], "call_ms": qry["v1_call_ms"], "walk": qry["v1_walk"]})

    # grid_core_distances (csrc/grid_cd.cu) and its first kernel (csrc/grid.cu) at MIN_PTS against the plain version on
    # the rows whose crossing is clear; both kernels alone in turns at each of CD_SWEEP, bit for bit each other there
    cd = k_grid.grid_core_distances(grid, nb_t, ext_t, mp, d, views)
    cd_v1 = k_grid.grid_core_distances_v1(grid, nb_t, ext_t, mp, d, views)
    pcd = ref.grid_core_distances(grid, views, nb_t, ext_t, mp, d)
    keep = clear_crossings(rep_t[:L], nb_t[:L], mp)
    tol = dist_tol(rep_t[:L], rep_t[:L], pcd[:L][keep])
    err, _ = compare("grid_core_distances", cd[:L][keep], pcd[:L][keep], tol)
    v1_err, _ = compare("grid_core_distances_v1", cd_v1[:L][keep], pcd[:L][keep], tol)
    plain = time_ms(lambda: ref.grid_core_distances(grid, views, nb_t, ext_t, mp, d), reps=1, warm=1)
    sweep = cd_turns(grid, views, nb_t, ext_t, float(nb_t.sum()), d)
    main = sweep[0]
    report("grid_core_distances", Lp, main["visits"], main["ms"], plain, None, err,
           f" on the {int(keep.sum())} of {L} rows with a clear crossing (the kernel alone, device ms behind a spin; "
           f"the bound counts the visits the function needs: each valid row's tiles up to its min_pts crossing)")
    report("grid_core_distances_v1", Lp, main["visits"], main["v1_ms"], plain, None, v1_err,
           " (the first kernel, csrc/grid.cu)")
    for got in sweep:
        say(f"[grid] grid_core_distances at min_pts {got['min_pts']} ({got['route']}), bit for bit the first kernel, "
            f"in turns new, v1, v1, new: {', '.join(f'{t:.4f}' for t in got['turns']['new'])} ms [v1 "
            f"{', '.join(f'{t:.4f}' for t in got['turns']['v1'])}]; bound {got['bound_ms']:.4f} ms ({got['bound_by']}: "
            f"the {got['visits']} row-tile visits the function needs, {got['visits'] / (Lp * NT):.4f} of rows x "
            f"tiles: each valid row's tiles whose bound is at most the distance of its min_pts crossing, counted "
            f"once); "
            f"row-tile visits of the new kernel at cluster {k_grid.CD_CLUSTER} {got['kernel_visits']}, at 1 "
            f"{got['c1_visits']}, of v1 {got['v1_visits']} (in no bound); longest walk of a CTA {got['walk']} at "
            f"cluster {k_grid.CD_CLUSTER}, "
            f"{got['walk_c1']} at 1 [v1 {got['v1_walk']}]")
    out["grid_core_distances"].update(
        cluster=k_grid.CD_CLUSTER, v1_ms=main["v1_ms"], kernel_visits=main["kernel_visits"],
        c1_visits=main["c1_visits"], walk=main["walk"],
        walk_c1=main["walk_c1"], v1_walk=main["v1_walk"],
        **{f"min_pts_{got['min_pts']}": {k: got[k] for k in ("ms", "v1_ms", "bound_ms", "bound_by", "visits",
                                                              "kernel_visits", "c1_visits", "v1_visits", "walk",
                                                              "walk_c1",
                                                              "v1_walk")} for got in sweep[1:]})
    out["grid_core_distances_v1"].update(walk=main["v1_walk"], visits=main["v1_visits"])

    # grid_round_minima: Borůvka's first round (every row its own component), the new kernel
    # (csrc/grid_round.cu) bit for bit the first (csrc/grid.cu), both within tolerance of the plain version
    labels = torch.arange(Lp, device=dev)
    hopeless = torch.zeros(Lp, dtype=torch.bool, device=dev)
    args = (grid, views, cd, labels, hopeless)
    rw, re = k_grid.grid_round_minima(*args)
    ow, oe = k_grid.grid_round_minima_v1(*args)
    check(bool(torch.equal(rw, ow)) and bool(torch.equal(re, oe)),
          f"[grid] grid_round_minima differs from its first kernel ({int((rw != ow).sum())} w, "
          f"{int((re != oe).sum())} eid)")
    pw, pe = ref.grid_round_minima(*args)
    err, _ = compare("grid_round_minima", rw[:L], pw[:L], dist_tol(rep_t[:L], rep_t[:L], pw[:L]))
    same_e = float((re[:L] == pe[:L]).double().mean())
    check(same_e >= 0.99, f"[grid] grid_round_minima: only {same_e:.4f} of the edge ids equal the plain version's")
    times = {"new": [], "v1": []}  # in turns: new, v1, v1, new (the whole call: the kernel and the scatter)
    for which in ("new", "v1", "v1", "new"):
        fn = k_grid.grid_round_minima if which == "new" else k_grid.grid_round_minima_v1
        times[which].append(time_ms(lambda: fn(*args), reps=20))
    ms, v1_ms = float(np.mean(times["new"])), float(np.mean(times["v1"]))
    plain = time_ms(lambda: ref.grid_round_minima(*args), reps=1, warm=1)
    got = visits_of(lambda: k_grid.grid_round_minima(*args))
    v, walk = got["grid_round_minima"], got["grid_round_longest"]
    v1_visits = visits_of(lambda: k_grid.grid_round_minima_v1(*args))["grid_round_minima"]
    # the bound and the visited share count the visits the function needs: the first kernel's, which stops on the
    # block's bests; the new kernel's extra visits (each CTA of a cluster stops on its own bests) stand apart
    report("grid_round_minima", Lp, v1_visits, ms, plain, None, err,
           f"; bit for bit the first kernel; {same_e:.4f} of the rows' edge ids equal the plain version's; in turns "
           f"new {', '.join(f'{t:.4f}' for t in times['new'])} ms, first kernel "
           f"{', '.join(f'{t:.4f}' for t in times['v1'])} ms; the new kernel's own row-tile visits {v} "
           f"(+{v - v1_visits} from the per-CTA stop, in no bound); longest walk of a CTA {walk} at cluster "
           f"{k_grid.ROUND_CLUSTER}")
    report("grid_round_minima_v1", Lp, v1_visits, v1_ms, plain, None, err, " (the first kernel, csrc/grid.cu)")
    out["grid_round_minima"].update(v1_ms=v1_ms, kernel_visits=v, extra_visits=v - v1_visits)
    rounds, sums = grid_rounds(dev, run["table_full"])
    out["grid_round_minima"].update(cluster=k_grid.ROUND_CLUSTER, **sums,
                                    rounds_ms=[round(r["ms"], 4) for r in rounds],
                                    v1_rounds_ms=[round(r["v1_ms"], 4) for r in rounds])
    after = grid_counts()  # the checks' launches are not the path's: the caller's counts were read before
    for name in GRID_ORACLES:
        out[name]["launches_oracle"] = after[name] - counts[name]
        check(out[name]["launches_oracle"] > 0, f"[grid] the first kernel {name} never ran as the oracle")
    for name in GRID_KERNELS + GRID_ORACLES:
        k_grid.launches[name] = counts[name]
    return out


def cd_turns(grid, views, nb, ext, mass, d) -> list:
    """Both Eq. 6 kernels on the [grid] table at each of CD_SWEEP (clamped
    to the mass as the pass clamps it): bit for bit each other; the kernel
    alone over every block (device ms behind a spin, no scatter) in turns
    new, v1, v1, new; the row-tile visits and the longest walk of a CTA of
    both, and of the new kernel at one CTA a block; the bound from the
    visits the function needs (``cd_needed_visits``), not from a kernel's:
    past the register route the new kernel's k-th lags as v1's does, and
    past 1024 keys each round walks again."""
    import torch

    from repro_torch.kernels import grid as k_grid
    from repro_torch.kernels import ops

    NB = views.order.shape[0]
    Lp = grid.pts.shape[0]
    out = []
    for m in CD_SWEEP:
        mpc = ops._clamp_min_pts(m, mass)
        args = (grid, nb, ext, mpc, d, views, (0, NB))
        kern = {"new": lambda: k_grid.grid_core_distances(*args), "v1": lambda: k_grid.grid_core_distances_v1(*args)}
        a, b = kern["new"](), kern["v1"]()
        check(bool(torch.equal(a, b)), f"[grid] grid_core_distances at min_pts {mpc} differs from its first kernel "
              f"({int((a != b).sum())} rows)")
        turns = {"new": [], "v1": []}
        for which in ("new", "v1", "v1", "new"):
            turns[which].append(device_ms(kern[which], reps=20))
        new, v1 = visits_of(kern["new"]), visits_of(kern["v1"])
        one = visits_of(lambda: k_grid.grid_core_distances(*args, cluster=1))
        need = cd_needed_visits(grid, views, nb, mpc)
        flops = 2.0 * d * grid.tile * need
        nbytes = 4.0 * (Lp * (d + 4) + 2 * views.order.numel())
        b, by = bound_ms(flops, nbytes)
        out.append(dict(min_pts=mpc, route="registers" if min(mpc, Lp) <= 16 else "warp-select",
                        ms=float(np.mean(turns["new"])), v1_ms=float(np.mean(turns["v1"])), turns=turns,
                        visits=need, c1_visits=one["grid_core_distances"], kernel_visits=new["grid_core_distances"],
                        v1_visits=v1["grid_core_distances"], walk=new["grid_core_longest"],
                        walk_c1=one["grid_core_longest"], v1_walk=v1["grid_core_longest"], bound_ms=b, bound_by=by))
    return out


def cd_needed_visits(grid, views, nb, min_pts) -> int:
    """The row-tile visits Eq. 6 needs at min_pts on the sorted table: per
    valid row, the tiles whose bound (its block's, the kernels' lower
    bound) is at most the distance of its min_pts crossing, counted once
    however many passes or rounds a kernel makes, and none for invalid
    rows.  The crossing is the first of the row's k = min(min_pts, Lp)
    nearest keys (the row itself at 0) at which their masses ``nb`` sum to
    min_pts, else the k-th: the keys past it change no bit of the answer,
    and every key up to its distance must be seen to place it.  A kernel
    visits more: each tile for every row of its block (v1 for every row of
    a pass), until the last row's k-th.  The distances are the plain
    version's (``ref._tile_sq`` against every valid row), which may differ
    from the kernels' FMA chains in the last bit; the masses are whole, so
    their sums do not depend on the order."""
    import torch

    from repro_torch.kernels import ref

    pts, valid, lbs = grid.pts, grid.valid, views.lbs
    Lp, NB, bn = pts.shape[0], lbs.shape[0], views.block
    k = min(int(min_pts), Lp)
    mass = nb.float()[grid.orig.long()]  # column p's mass, by sorted position
    xx = (pts * pts).sum(-1)
    reach = torch.full((NB * bn,), float("-inf"), device=pts.device)
    for r0 in range(0, Lp, 1024):
        r1 = min(Lp, r0 + 1024)
        dm = torch.sqrt(ref._tile_sq(pts[None, r0:r1], xx[None, r0:r1], pts[None], xx[None])[0])
        at = torch.arange(r1 - r0, device=pts.device)
        dm[at, at + r0] = 0.0  # the row itself
        dm = torch.where(valid[None, :], dm, float("inf"))
        dist, col = dm.topk(k, dim=1, largest=False, sorted=True)
        csum = torch.where(torch.isfinite(dist), mass[col], 0.0).cumsum(1)
        hit = csum >= float(min_pts)
        cross = torch.where(hit.any(1), hit.to(torch.int8).argmax(1), k - 1)
        reach[r0:r1] = torch.where(valid[r0:r1], dist.gather(1, cross[:, None])[:, 0], float("-inf"))
    need = torch.isfinite(lbs)[:, None, :] & (lbs[:, None, :] <= reach.view(NB, bn)[:, :, None])
    return int(need.sum())


N_SM = 132  # the H100 SXM's streaming multiprocessors
ROUND_REPS = 20  # [grid] rounds: launches timed per round and kernel


def grid_rounds(dev, table):
    """Every round of one grid Borůvka pass at Lp = 8192 on the stream's
    table: the pass's own labels and hopeless masks (``boruvka_grid`` with
    its search hooked), and per round the live rows, each kernel's device
    ms (CUDA events behind a spin, ``ROUND_REPS`` launches over the round's
    blocks, no scatter) and its longest walk (the most tiles one CTA
    visited); the new kernel bit for bit the first in every round and over
    the mesh ranges.  The round's row-tile visits and its ops bound count
    what the function needs, the first kernel's visits; the new kernel's
    extra visits (each CTA of a cluster stops on its own bests) stand apart
    and enter no bound.  The first kernel's walk comes from its own visits
    of one block at a time; the new kernel at one CTA a block must repeat
    its visits and walk.  Returns the per-round records and the sums of a
    pass."""
    import torch

    from repro_torch.core.mst import boruvka_grid
    from repro_torch.kernels import grid as k_grid
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import shard_ranges

    rep, extent, n_b, _ = table
    L, d = rep.shape
    (rep_t, nb_t, ext_t), mp, _ = ops._prepare_table(rep, n_b, extent, MIN_PTS, dev)
    grid, views = ops._grid_table(rep_t, L)
    cd = k_grid.grid_core_distances(grid, nb_t, ext_t, mp, d, views)
    Lp, NT, NB, T = rep_t.shape[0], grid.tile_lo.shape[0], views.order.shape[0], grid.tile
    visit_flops = 2.0 * 64 * T * d  # one tile visited by a 64-row block
    search, v1 = k_grid.grid_round_minima, k_grid.grid_round_minima_v1
    records = []

    def counted(fn):
        got = visits_of(fn)
        return got["grid_round_minima"], got["grid_round_longest"]

    def walk_bound(walk):
        return walk * visit_flops / (PEAK_F32_FLOPS / N_SM) * 1e3

    def hook(g, v, cd_, labels, hopeless, blocks=None):
        args = (g, v, cd_, labels, hopeless, (0, NB))
        rec = dict(round=len(records) + 1, live=int((g.valid & ~hopeless[g.orig.long()]).sum()))
        old = v1(*args)
        rec["v1_ms"] = device_ms(lambda: v1(*args), reps=ROUND_REPS)
        rec["visits"], _ = counted(lambda: v1(*args))
        # the first kernel's walk: its visits of one block at a time over the block's 64 rows
        rec["v1_walk"] = max(counted(lambda: v1(*args[:5], (b, b + 1)))[0] // min(64, Lp - 64 * b)
                             for b in range(NB)) if rec["visits"] else 0
        c1 = counted(lambda: search(*args, cluster=1))
        check(c1 == (rec["visits"], rec["v1_walk"]), f"[grid] round {rec['round']}: the new kernel at one CTA "
              f"a block visited {c1}, the first kernel {rec['visits'], rec['v1_walk']} (visits, walk)")
        got = search(*args)
        check(torch.equal(got[0], old[0]) and torch.equal(got[1], old[1]),
              f"[grid] round {rec['round']}: the new kernel differs from the first "
              f"({int((got[0] != old[0]).sum())} w, {int((got[1] != old[1]).sum())} eid)")
        for k in MESH_KS[1:]:
            for b0, b1 in shard_ranges(NB, k):
                if b1 > b0:
                    a = search(g, v, cd_, labels, hopeless, blocks=(b0, b1))
                    check(torch.equal(a[0], old[0][b0 * 64 : b1 * 64]) and torch.equal(a[1], old[1][b0 * 64 : b1 * 64]),
                          f"[grid] round {rec['round']}: blocks [{b0}, {b1}) differ from the first kernel")
        rec["ms"] = device_ms(lambda: search(*args), reps=ROUND_REPS)
        rec["c1_ms"] = device_ms(lambda: search(*args, cluster=1), reps=ROUND_REPS)
        own, rec["walk"] = counted(lambda: search(*args))
        rec["extra_visits"] = own - rec["visits"]
        rec["bound_ms"], _ = bound_ms(visit_flops * rec["visits"] / 64, 0.0)
        rec["v1_walk_bound_ms"], rec["walk_bound_ms"] = walk_bound(rec["v1_walk"]), walk_bound(rec["walk"])
        records.append(rec)
        return search(g, v, cd_, labels, hopeless, blocks=blocks)

    k_grid.grid_round_minima = hook
    try:
        boruvka_grid(grid, cd, views)
    finally:
        k_grid.grid_round_minima = search
    check(len(records) == Lp.bit_length(), f"[grid] {len(records)} rounds in a pass at Lp = {Lp}")
    say(f"[grid] the rounds of one Borůvka pass at L={L}, Lp={Lp}, d={d} ({NB} blocks x {NT} tiles; device ms a "
        f"launch by CUDA events over {ROUND_REPS}; visits = the rows x tiles the function needs, the first kernel's; "
        f"walk = the most tiles one CTA visited; bounds: ops = 2·d FLOPs per needed (row, column) at 67 TFLOP/s, "
        f"walk = the kernel's walk, its visits one after another at one SM's 1/{N_SM} of it):")
    for r in records:
        say(f"[grid]   round {r['round']}: live rows {r['live']}; visits {r['visits']} "
            f"({r['visits'] / (Lp * NT):.4f} of rows x tiles), ops bound {r['bound_ms']:.4f} ms; first kernel "
            f"{r['v1_ms']:.4f} ms, walk {r['v1_walk']} (bound {r['v1_walk_bound_ms']:.4f}); new (cluster "
            f"{k_grid.ROUND_CLUSTER}) {r['ms']:.4f} ms, walk {r['walk']} (bound {r['walk_bound_ms']:.4f}), extra "
            f"visits from the per-CTA stop {r['extra_visits']} (in no bound); new at one CTA {r['c1_ms']:.4f} ms")
    sums = {"v1_pass_ms": sum(r["v1_ms"] for r in records), "pass_ms": sum(r["ms"] for r in records),
            "c1_pass_ms": sum(r["c1_ms"] for r in records)}
    say(f"[grid] one pass's {len(records)} rounds, device ms: " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items())
        + f"; extra visits from the per-CTA stop {sum(r['extra_visits'] for r in records)} of "
        f"{sum(r['visits'] for r in records)}; the new kernel bit for bit the first in every round and over the "
        f"mesh ranges (k = {', '.join(map(str, MESH_KS[1:]))})")
    return records, sums


def grid_pass(dev, table):
    """One offline pass at Lp = 8192 through offline_recluster_from_table,
    spatial and dense: stage by stage, end to end in turns (the grid pass
    also with its round search on the first round kernel, and with its
    Eq. 6 search on the first Eq. 6 kernel, to compare each pair of
    kernels' pass), peak device memory above what was allocated
    before, launches per pass, the visited share per kernel, a
    torch.profiler pass of each grid variant, and the grid pass with no
    host synchronisation allowed from build_grid to extract."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import grid as k_grid
    from repro_torch.kernels import ops

    rep, extent, n_b, _ = table
    L = rep.shape[0]

    def run(spatial, stage=ops._run_stage):
        return ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev, stage=stage,
                                                spatial_index=spatial)

    def on_first(name):  # the grid pass with the search `name` on its first kernel (csrc/grid.cu)
        def run_first():
            search = getattr(k_grid, name)
            setattr(k_grid, name, getattr(k_grid, name + "_v1"))
            try:
                return run(True)
            finally:
                setattr(k_grid, name, search)
        return run_first

    run_v1, run_cd_v1 = on_first("grid_round_minima"), on_first("grid_core_distances")

    t = {True: {}, False: {}}
    for _ in range(2):  # the second round is the one reported (warm caches)
        res = {sp: run(sp, stage_timer(t[sp])) for sp in (False, True)}
    check(_same_partition(res[True].labels, res[False].labels), "[grid] the grid pass's partition differs")
    check(np.array_equal(run_v1().labels, res[True].labels), "[grid] the pass on the first round kernel differs")
    check(np.array_equal(run_cd_v1().labels, res[True].labels), "[grid] the pass on the first Eq. 6 kernel differs")
    for sp, name in ((False, "dense"), (True, "grid")):
        say(f"[grid] {name} pass at L={L}, Lp={ops._pow2_rows(L)} (ms): "
            + ", ".join(f"{k} {v:.2f}" for k, v in t[sp].items()) + f"; total {sum(t[sp].values()):.2f}")
    passes = {"dense": lambda: run(False), "grid": lambda: run(True), "grid on the first round kernel": run_v1,
              "grid on the first Eq. 6 kernel": run_cd_v1}
    walls = {name: [] for name in passes}
    for name in list(passes) + list(passes)[::-1] + list(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        passes[name]()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    peak = {}
    for sp in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run(sp)
        peak[sp] = (torch.cuda.max_memory_allocated() - base) / 2**20
    before = grid_counts()
    v = visits_of(lambda: run(True))
    after = grid_counts()
    v1v = visits_of(run_v1)  # the visits the rounds need: the first kernel's, which stops on each block's bests
    per_pass = {k: after[k] - before[k] for k in GRID_KERNELS}
    NT = ops._pow2_rows(L) // k_grid.DEFAULT_TILE
    Lp = ops._pow2_rows(L)
    rounds = Lp * NT * max(per_pass["grid_round_minima"], 1)
    say(f"[grid] end to end, in turns (ms): " + "; ".join(f"{name} {', '.join(f'{w:.2f}' for w in ws)}"
                                                         for name, ws in walls.items())
        + f"; peak device memory above the table: dense {peak[False]:.1f} MiB, grid {peak[True]:.1f} MiB; grid "
        f"launches per pass {json.dumps(per_pass)}; visited share of rows x tiles: Eq. 6 "
        f"{v['grid_core_distances'] / (Lp * NT):.4f}, Borůvka rounds {v1v['grid_round_minima'] / rounds:.4f} per "
        f"round (the first kernel's visits, what the rounds need; the new kernel's "
        f"{v['grid_round_minima'] / rounds:.4f}, its per-CTA stop's extra visits "
        f"{v['grid_round_minima'] - v1v['grid_round_minima']})")
    check(per_pass["grid_core_distances"] == 1 and per_pass["grid_assign"] == 0
          and per_pass["grid_round_minima"] == ops._pow2_rows(L).bit_length()
          and all(after[n] == before[n] for n in GRID_ORACLES), f"[grid] launches in one pass: {per_pass}, first "
          f"kernels {[after[n] - before[n] for n in GRID_ORACLES]}")
    for name in ("grid", "grid on the first round kernel", "grid on the first Eq. 6 kernel"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            passes[name]()
            traced = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        wall = float(np.median(walls[name]))
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        if busy > 0:
            say(f"[grid] torch.profiler, one {name} pass: {sum(e.count for e in events)} launches, device busy "
                f"{busy:.3f} ms (traced wall {traced:.2f} ms); against the untraced wall {wall:.2f} ms: idle share "
                f"{1 - busy / wall:.3f}; top device time (ms): "
                + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} x{e.count}" for e in top))
        else:
            say(f"[grid] torch.profiler, one {name} pass: no device time in the trace; idle share not measured")

    def no_sync(name, fn, *args, **kw):
        if name in ("prepare", "unwrap"):
            return fn(*args, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    torch.cuda.synchronize()
    res2 = run(True, no_sync)
    check(np.array_equal(res2.labels, res[True].labels), "[grid] the pass under the sync debug mode differs")
    say("[grid] the grid pass with torch.cuda.set_sync_debug_mode('error') from build_grid to extract: no host "
        "synchronisation raised")


def grid_online(dev, X, drop, kw, card):
    """``device_online=True`` with ``spatial_index=True``: [stream]'s
    ingests and retires; every pass from the flat table with the partition
    of the host-table grid pass on the same tree."""
    import torch

    from repro_torch import StreamingClusterEngine

    eng = StreamingClusterEngine(DIM, spatial_index=True, device_online=True, **kw)
    parity, history, pids = [], {}, []
    before = grid_counts()

    def note(before):
        snap = eng.snapshot
        if snap is not None and snap.version != before:
            history[snap.version] = snap
            if not eng._flat.stale:
                parity.append(online_pass_parity(eng))

    t0 = time.perf_counter()
    for i in range(0, N_POINTS, BLOCK):
        v0 = 0 if eng.snapshot is None else eng.snapshot.version
        pids.extend(eng.ingest(X[i : i + BLOCK]))
        note(v0)
    v0 = eng.snapshot.version
    eng.flush()
    note(v0)
    for i in range(0, len(drop), BLOCK):
        v0 = eng.snapshot.version
        eng.retire([pids[j] for j in drop[i : i + BLOCK]])
        note(v0)
    v0 = eng.snapshot.version
    eng.flush()
    note(v0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(eng.stats["device_online_blocks"] > 0 and parity, "[grid] the device-online grid stream ran no flat pass")
    no_oracle("grid", before)
    say(f"[grid] device_online=True with spatial_index=True on {card}: {wall:.2f} s wall, "
        f"{eng.stats['device_online_blocks']} blocks on the device, {len(history)} snapshots; {len(parity)} passes "
        f"from the flat table, each with the partition of the host-table grid pass on the same tree (MST weight "
        f"rel diff max {max(parity):.3e})")
    del eng


def grid_wide(dev):
    """The d = 200 point: [wide]'s data through a grid engine, each
    snapshot's partition against the dense card pass on its table, and the
    kernels bit for bit the feature-sliced dense routes on the last one."""
    import torch

    from repro_torch import StreamingClusterEngine
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED + 3)  # [wide]'s data
    data = mixture(rng, N_WIDE + N_WIDE_QUERIES, dim=WIDE_DIM) + 50.0
    X, Qs = data[:N_WIDE], data[N_WIDE:]
    eng = StreamingClusterEngine(WIDE_DIM, spatial_index=True, min_pts=MIN_PTS, compression=COMPRESSION,
                                 epsilon=EPSILON, max_block=BLOCK, device=dev)
    snaps, before = [], grid_counts()
    for i in range(0, N_WIDE, BLOCK):
        v0 = 0 if eng.snapshot is None else eng.snapshot.version
        eng.ingest(X[i : i + BLOCK])
        if eng.snapshot is not None and eng.snapshot.version != v0:
            snaps.append((eng.snapshot, eng._table.capture(eng.tree.n_points).table()))
    v0 = eng.snapshot.version
    eng.flush()
    if eng.snapshot.version != v0:
        snaps.append((eng.snapshot, eng._table.capture(eng.tree.n_points).table()))
    no_oracle("grid", before)
    for snap, (rep, extent, n_b, _) in snaps:
        dense = ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev)
        check(_same_partition(snap.bubble_labels, dense.labels),
              f"[grid] d={WIDE_DIM} version {snap.version}: partition differs from the dense card pass")
    snap, table = snaps[-1]
    grid_bitwise("grid", dev, table, X[:BLOCK], snap, Qs, (MIN_PTS,))
    say(f"[grid] d={WIDE_DIM}: {len(snaps)} snapshots of the grid engine each with the dense card pass's partition")
    del eng
    torch.cuda.synchronize()


def phase_cpu_check(run):
    """The stream's snapshots and served rows against the port's own plain
    pipeline on the CPU."""
    for name in ("full", "last"):
        check_snapshot("check", name, run[f"snap_{name}"], run[f"table_{name}"], MIN_PTS)
    check_served("check", run["snap_last"], run["Qs"], run["served"])


def hierarchy_bound(nbytes: float, steps: int):
    """The larger of the bytes' time at the card's memory rate and the
    latency floor of ``steps`` dependent steps (one shared-memory round
    trip each); ("operations" when the floor binds)."""
    t_bytes, t_lat = nbytes / PEAK_BYTES * 1e3, steps * SMEM_ROUND_TRIP_S * 1e3
    return max(t_bytes, t_lat), ("bytes" if t_bytes >= t_lat else "operations"), t_lat


def abs_diff(got, want) -> float:
    """The largest absolute difference of two same-shape tensors (of any
    dtype, read in f64): the max_abs_err a kernel's row reports."""
    return float((got.double() - want.double()).abs().max()) if want.numel() else 0.0


def order_rtol(ct):
    """Per label slot of condensed arrays ``ct``, how far two f32 sums of
    its stability terms in different orders may lie apart, relative: RTOL,
    or the worst case 2·(k − 1)·2⁻²⁴ of its k non-negative terms where that
    is larger."""
    import torch

    n_slots, n = ct.cluster_parent.shape[0], int(ct.n_labels)
    k = torch.bincount(ct.point_parent.long(), minlength=n_slots)[:n_slots]
    k = k + torch.bincount(ct.cluster_parent[1:n].long(), minlength=n_slots)[:n_slots]
    return torch.clamp(2.0 * (k - 1).clamp(min=0).double() * 2.0 ** -24, min=RTOL)


def same_arrays(name, got, want, stab_rtol=None) -> float:
    """Every field of two hierarchy NamedTuples bit for bit, stabilities
    within ``stab_rtol`` (a number or one per slot) when one is given;
    returns the largest absolute difference over the fields."""
    import torch

    err = 0.0
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        check(g.shape == w.shape and g.dtype == w.dtype, f"{name}.{field}: shape or dtype differs")
        if field == "stability" and stab_rtol is not None:
            ok = bool(((g.double() - w.double()).abs() <= stab_rtol * w.double().abs()).all())
            check(ok, f"{name}.{field}: beyond the order tolerance")
        else:
            check(bool(torch.equal(g, w)), f"{name}.{field}: differs")
        err = max(err, abs_diff(g, w))
    return err


def chain_buffers(Lp: int, seed: int):
    """Borůvka-shaped (eu, ev, ew, valid, weights) numpy buffers of a chain
    over Lp leaves: a path whose weights rise along it (distinct in f32:
    multiples of 2^-10 in [1, 1025)), in random slots, one slot left
    invalid; leaf weights 1–5.  Every merge takes in one leaf: a dendrogram
    Lp − 1 deep, as a large cluster that absorbs points one at a time
    gives."""
    rng = np.random.default_rng(seed)
    perm, n_e = rng.permutation(Lp), Lp - 1
    slots = rng.permutation(Lp)[:n_e]
    eu, ev = np.zeros(Lp, np.int32), np.zeros(Lp, np.int32)
    ew, valid = np.zeros(Lp, np.float32), np.zeros(Lp, bool)
    eu[slots], ev[slots], valid[slots] = perm[1:], perm[:-1], True
    ew[slots] = 1.0 + np.sort(rng.choice(1 << 20, n_e, replace=False)) / 1024.0
    return eu, ev, ew, valid, rng.integers(1, 6, Lp).astype(np.float32)


def comb_buffers(Lp: int, seed: int):
    """Borůvka-shaped buffers of a comb over Lp leaves: groups of 6 leaves
    on light edges (0.01–1), their heads on a path whose weights rise above
    them (10 + multiples of 2^-10), in random slots, one slot invalid;
    leaf weights 1–5.  At min_cluster_size 10 every path merge splits two
    heavy subtrees: ~Lp / 3 condensed labels, a label tree ~Lp / 6 deep."""
    rng = np.random.default_rng(seed)
    n_e = Lp - 1
    child = np.arange(1, Lp)
    head = child % 6 == 0
    par = np.where(head, child - 6, child - 1)
    perm = rng.permutation(Lp)
    rise = 1.0 + np.sort(rng.choice(1 << 20, n_e, replace=False)) / 1024.0
    slots = rng.permutation(Lp)[:n_e]
    eu, ev = np.zeros(Lp, np.int32), np.zeros(Lp, np.int32)
    ew, valid = np.zeros(Lp, np.float32), np.zeros(Lp, bool)
    eu[slots], ev[slots], valid[slots] = perm[child], perm[par], True
    ew[slots] = np.where(head, 10.0 + rise, rng.uniform(0.01, 1.0, n_e))
    return eu, ev, ew, valid, rng.integers(1, 6, Lp).astype(np.float32)


def on_cpu(arrays):
    """A hierarchy NamedTuple with every field copied to the CPU."""
    return type(arrays)(*(t.cpu() for t in arrays))


def in_turns(new, old, reps=20):
    """Device ms of two versions timed in turns (new, old, old, new): the
    means of each version's two timings."""
    a, b, c, d = time_ms(new, reps), time_ms(old, reps), time_ms(old, reps), time_ms(new, reps)
    return (a + d) / 2, (b + c) / 2


def phase_hierarchy(dev, table):
    """The hierarchy kernels on the card.  Single-linkage and condense
    (csrc/hierarchy_par.cu) against their first versions
    (csrc/hierarchy.cu), the plain loops and the CPU models of their
    algorithms (core/hierarchy.py: single_linkage_chunked, condense_jump),
    every field bit for bit, on the offline pass's own Borůvka buffers for
    the stream's full table (Lp = 8192, the state in shared memory) and on a
    chain at CHAIN_LP (a dendrogram CHAIN_LP − 1 deep, the state in
    scratch).  Extract (csrc/hierarchy_extract.cu) bit for bit the plain
    extract_fixed on the card and on the CPU, stabilities included, both
    methods with and without allow_single_cluster, and against extract_v1
    (integer fields equal, stabilities within RTOL), there and on a comb at
    CHAIN_LP (~11,000 labels, its arrays past shared memory); the EOM
    kernel of extract_v1 against its plain loop; a second run bit for bit;
    the new and first versions timed in turns at both sizes, with stage and
    plain times and the bound.  Returns the per-kernel numbers for the JSON
    line."""
    import torch

    from repro_torch.core import hierarchy as th
    from repro_torch.kernels import hierarchy as k_h
    from repro_torch.kernels import ops

    rep, extent, n_b, _ = table
    L = rep.shape[0]
    seen = {}

    def capture(name, fn, *args, **kw):
        seen[name] = fn(*args, **kw)
        return seen[name]

    ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev, stage=capture)
    eu, ev, ew, valid = seen["boruvka"]
    nb = seen["prepare"][0][1]
    Lp, M, mcs = eu.shape[0], eu.shape[0] - 1, float(MIN_PTS)
    check(Lp == LP, f"the full table's bucket is {Lp}, not {LP}")

    def kernels():
        u_s, v_s, w_s = th.sorted_edges(eu, ev, ew, valid, L)
        slt = k_h.single_linkage_sorted(u_s, v_s, w_s, nb)
        ct = k_h.condense(slt, nb, mcs)
        return (u_s, v_s, w_s), slt, ct, k_h.extract(ct)

    def against_plain_extract(tag, ct, ex):
        """ex (the kernel's, eom without allow_single) and the kernel's other
        three policies bit for bit the plain version on the CPU; all four
        against extract_v1; returns the largest difference from the plain
        version."""
        c_ct, err, rtol = on_cpu(ct), 0.0, order_rtol(ct)
        for method in ("eom", "leaf"):
            for single in (False, True):
                got = ex if (method, single) == ("eom", False) else k_h.extract(ct, method, single)
                what = f"{tag} extract {method}{' allow_single' if single else ''}"
                err = max(err, same_arrays(f"{what} vs plain (CPU)", on_cpu(got),
                                           th.extract_fixed(c_ct, method=method, allow_single_cluster=single)))
                same_arrays(f"{what} vs extract_v1", got, k_h.extract_v1(ct, method, single), stab_rtol=rtol)
        return err

    edges, slt, ct, ex = kernels()
    p_slt = th.single_linkage_fixed(eu, ev, ew, valid, L, nb)
    p_ct = th.condense_fixed(p_slt, nb, mcs)
    p_ex = th.extract_fixed(p_ct)
    errs = dict(single_linkage=same_arrays("single_linkage", slt, p_slt), condense=same_arrays("condense", ct, p_ct),
                extract=same_arrays("extract", ex, p_ex))
    errs["extract"] = max(errs["extract"], against_plain_extract(f"Lp={Lp}", ct, ex))
    sel, kids = k_h.eom_sweep(ex.stability, ct.cluster_parent, ct.n_labels)
    p_sel, p_kids = th.eom_loop(ex.stability, ct.cluster_parent, ct.n_labels)
    check(bool(torch.equal(sel, p_sel)) and bool(torch.equal(kids.long(), p_kids)), "eom: selection or child counts")
    errs["eom"] = max(abs_diff(sel, p_sel), abs_diff(kids, p_kids))
    again = kernels()
    for name, a, b in (("single_linkage", slt, again[1]), ("condense", ct, again[2]), ("extract", ex, again[3])):
        for field in a._fields:
            check(bool(torch.equal(getattr(a, field), getattr(b, field))), f"{name}.{field}: a second run differs")
    check(bool(torch.equal(sel, k_h.eom_sweep(ex.stability, ct.cluster_parent, ct.n_labels)[0])),
          "eom: a second run differs")

    def against_oracles(tag, bufs, n_valid, slt, ct, cpu_plain):
        """slt, ct (the new kernels' on the card) bit for bit the first
        versions on the same inputs, the CPU models and, with
        ``cpu_plain``, the plain loops on the CPU."""
        edges = th.sorted_edges(*bufs[:4], n_valid)
        same_arrays(f"{tag} single_linkage v1", slt, k_h.single_linkage_sorted_v1(*edges, bufs[4]))
        same_arrays(f"{tag} condense v1", ct, k_h.condense_v1(slt, bufs[4], mcs))
        cpu = [b.cpu() for b in bufs]
        c_slt, c_ct = on_cpu(slt), on_cpu(ct)
        same_arrays(f"{tag} single_linkage model", c_slt,
                    th.single_linkage_chunked(*cpu[:4], n_valid, cpu[4], chunk=k_h.CHUNK))
        same_arrays(f"{tag} condense model", c_ct, th.condense_jump(c_slt, cpu[4], mcs, chunk=k_h.CHUNK))
        if cpu_plain:
            pc_slt = th.single_linkage_fixed(*cpu[:4], n_valid, cpu[4])
            same_arrays(f"{tag} single_linkage plain (CPU)", c_slt, pc_slt)
            same_arrays(f"{tag} condense plain (CPU)", c_ct, th.condense_fixed(pc_slt, cpu[4], mcs))

    v1_launches = (k_h.launches_single_linkage_v1, k_h.launches_condense_v1)
    against_oracles(f"Lp={Lp}", (eu, ev, ew, valid, nb), L, slt, ct, cpu_plain=False)
    chain = [torch.from_numpy(a).to(dev) for a in chain_buffers(CHAIN_LP, SEED + 7)]
    ch_edges = th.sorted_edges(*chain[:4], CHAIN_LP)
    ch_slt = k_h.single_linkage_sorted(*ch_edges, chain[4])
    ch_ct = k_h.condense(ch_slt, chain[4], mcs)
    t0 = time.perf_counter()
    against_oracles(f"chain Lp={CHAIN_LP}", chain, CHAIN_LP, ch_slt, ch_ct, cpu_plain=True)
    check((k_h.launches_single_linkage_v1, k_h.launches_condense_v1) == tuple(n + 2 for n in v1_launches),
          "the first versions' launches")
    t_chain = time.perf_counter() - t0
    comb = [torch.from_numpy(a).to(dev) for a in comb_buffers(CHAIN_LP, SEED + 8)]
    cb_slt = k_h.single_linkage(*comb[:4], CHAIN_LP, comb[4])
    cb_ct = k_h.condense(cb_slt, comb[4], mcs)
    cb_ex = k_h.extract(cb_ct)
    cb_labels = int(cb_ct.n_labels)
    labels_fit = 26 * cb_labels + k_h._BUFFERS["extract"] <= k_h.SMEM_BYTES  # 6 words and 2 flags a label
    check(not labels_fit, f"the comb's {cb_labels} labels' arrays fit shared memory together")
    t0 = time.perf_counter()
    errs["extract"] = max(errs["extract"], against_plain_extract(f"comb Lp={CHAIN_LP}", cb_ct, cb_ex))
    check(all(bool(torch.equal(getattr(cb_ex, f), getattr(k_h.extract(cb_ct), f))) for f in cb_ex._fields),
          "extract on the comb: a second run differs")
    t_comb = time.perf_counter() - t0
    n_labels = int(ct.n_labels)
    n_skipped = int((slt.left == 2 * Lp - 1).sum())
    say(f"[kernels] hierarchy at Lp={Lp} (L={L}, the stream's full table, min_cluster_size {mcs:g}): "
        f"{n_labels} condensed labels, {int(ex.n_clusters)} clusters, {n_skipped} skipped merges; every field of "
        "single-linkage, condense and extract identical to the plain loops on the card, stabilities included; "
        "extract also identical to the plain extract_fixed on the CPU for both methods with and without "
        f"allow_single_cluster, and to extract_v1 but for the stabilities (within {RTOL}, or 2(k - 1) 2^-24 for a "
        "label of k terms where that is larger: index_put_'s own order); "
        "EOM's selection and child counts identical to eom_loop; a second run identical; single-linkage and condense "
        "(csrc/hierarchy_par.cu) identical to their first versions (csrc/hierarchy.cu) and to the CPU models of "
        f"their algorithms (chunk {k_h.CHUNK})")
    say(f"[kernels] hierarchy on a chain at Lp={CHAIN_LP} (a dendrogram {CHAIN_LP - 1} deep; state in shared memory: "
        f"single_linkage {k_h.plan('single_linkage', CHAIN_LP)[0]}, condense {k_h.plan('condense', CHAIN_LP)[0]}; "
        f"{int(ch_ct.n_labels)} labels): the new kernels identical to the first versions, the CPU models and the "
        f"plain loops on the CPU in every field ({t_chain:.1f} s with the CPU loops)")
    say(f"[kernels] hierarchy extract on a comb at Lp={CHAIN_LP} ({cb_labels} labels, {int(cb_ex.n_clusters)} "
        f"clusters; the per-label arrays, 26 bytes a label, past shared memory together: some in scratch): identical "
        "to the plain extract_fixed on the "
        f"CPU for both methods with and without allow_single_cluster, to extract_v1 but for the stabilities, and to a "
        f"second run ({t_comb:.1f} s with the CPU loops)")

    u_s, v_s, w_s = edges
    n_slots = 2 * Lp + 1
    sl_bytes, cd_bytes = (lambda n: 24.0 * n + 16.0 * (n - 1)), (lambda n: 12.0 * (n - 1) + 16.0 * n + 12.0 * (2 * n + 1) + 4)

    def ex_bytes(n):  # extract reads 3 leaf and 3 label arrays and the count, writes stability, selected, labels, count
        return 16.0 * n + 17.0 * (2 * n + 1) + 8

    runs = {  # new, first version, stage, plain, bytes at Lp, dependent steps at Lp, then the CHAIN_LP case's
        "single_linkage": dict(
            kernel=lambda: k_h.single_linkage_sorted(u_s, v_s, w_s, nb),
            first=lambda: k_h.single_linkage_sorted_v1(u_s, v_s, w_s, nb),
            stage=lambda: k_h.single_linkage(eu, ev, ew, valid, L, nb),
            plain=lambda: th.single_linkage_fixed(eu, ev, ew, valid, L, nb), nbytes=sl_bytes, steps=Lp - 1,
            big=("chain", CHAIN_LP - 1, lambda: k_h.single_linkage_sorted(*ch_edges, chain[4]),
                 lambda: k_h.single_linkage_sorted_v1(*ch_edges, chain[4]))),
        "condense": dict(
            kernel=lambda: k_h.condense(slt, nb, mcs), first=lambda: k_h.condense_v1(slt, nb, mcs),
            stage=lambda: k_h.condense(slt, nb, mcs), plain=lambda: th.condense_fixed(slt, nb, mcs),
            nbytes=cd_bytes, steps=0,
            big=("chain", 0, lambda: k_h.condense(ch_slt, chain[4], mcs),
                 lambda: k_h.condense_v1(ch_slt, chain[4], mcs))),
        "extract": dict(
            kernel=lambda: k_h.extract(ct), first=lambda: k_h.extract_v1(ct), stage=lambda: k_h.extract(ct),
            plain=lambda: th.extract_fixed(ct), nbytes=ex_bytes, steps=n_labels,
            big=("comb", cb_labels, lambda: k_h.extract(cb_ct), lambda: k_h.extract_v1(cb_ct))),
        "eom": dict(
            kernel=lambda: k_h.eom_sweep(ex.stability, ct.cluster_parent, ct.n_labels), first=None,
            stage=lambda: k_h.extract_v1(ct), plain=lambda: th.eom_loop(ex.stability, ct.cluster_parent, ct.n_labels),
            nbytes=lambda n: 13.0 * n_slots + 4, steps=n_labels, big=None),
    }
    counts = (k_h.launches_single_linkage, k_h.launches_condense, k_h.launches_extract, k_h.launches_eom,
              k_h.launches_single_linkage_v1, k_h.launches_condense_v1)
    out = {}
    for name, r in runs.items():
        ms, v1_ms = in_turns(r["kernel"], r["first"]) if r["first"] else (time_ms(r["kernel"], reps=20), None)
        stage_ms = time_ms(r["stage"], reps=20)
        host = host_ms(r["stage"])
        plain_ms = time_ms(r["plain"], reps=1, warm=0)
        b, by, floor = hierarchy_bound(r["nbytes"](Lp), r["steps"])
        what = (f"latency floor of {r['steps']} dependent steps x 30 cycles at 1.98 GHz {floor:.4f} ms" if by ==
                "operations" else "its bytes: no chain of dependent steps" if name == "condense" else "")
        first_name = {"extract": "extract_v1"}.get(name, "first version")
        stage_name = {"eom": "extract_v1's stage"}.get(name, "stage")
        say(f"[kernels] hierarchy {name} at Lp={Lp}: kernel {ms:.4f} ms"
            + (f" ({first_name}, in turns: {v1_ms:.4f} ms, {v1_ms / ms:.2f}x)" if r["first"] else "")
            + f", {stage_name} {stage_ms:.4f} ms (host enqueue {host:.4f} ms per call), plain {plain_ms:.2f} ms, bound "
            f"{b:.4f} ms ({what}; {r['nbytes'](Lp) / 1e6:.3f} MB at 3.35 TB/s {r['nbytes'](Lp) / PEAK_BYTES * 1e3:.5f} "
            "ms); library none")
        out[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                         stage_ms=stage_ms, host_ms=host, latency_floor_ms=floor if r["steps"] else None)
        if r["first"]:
            tag, steps, new, old = r["big"]
            c_ms, c_v1 = in_turns(new, old, reps=5)
            c_b, c_by, c_floor = hierarchy_bound(r["nbytes"](CHAIN_LP), steps)
            out[name].update(v1_ms=v1_ms, **{tag: dict(Lp=CHAIN_LP, ms=c_ms, v1_ms=c_v1, bound_ms=c_b, bound_by=c_by)})
            if name == "extract":
                out[name][tag].update(n_labels=cb_labels, host_ms=host_ms(new))
            say(f"[kernels] hierarchy {name} on the {tag} at Lp={CHAIN_LP}: kernel {c_ms:.4f} ms, {first_name} "
                f"{c_v1:.4f} ms ({c_v1 / c_ms:.2f}x, in turns), bound {c_b:.4f} ms ({c_by}"
                + (f": {steps} steps {c_floor:.4f} ms" if c_by == "operations" else "") + ")"
                + (f"; host enqueue {out[name][tag]['host_ms']:.4f} ms per call" if name == "extract" else ""))
    (k_h.launches_single_linkage, k_h.launches_condense, k_h.launches_extract, k_h.launches_eom,
     k_h.launches_single_linkage_v1, k_h.launches_condense_v1) = counts  # the timing's launches are not the path's
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def phase_stages(dev, table):
    """One offline pass at Lp = 8192 through the engine's own entry point,
    ops.offline_recluster_from_table: each stage timed through its
    ``stage`` hook, then the pass end to end, under torch.profiler, and
    once with any host synchronisation from bubble_cd to extract made an
    error (``torch.cuda.set_sync_debug_mode``; PyTorch notes that the mode
    does not yet see every synchronising operation)."""
    import torch

    from repro_torch.kernels import hierarchy as k_h
    from repro_torch.kernels import ops

    rep, extent, n_b, _ = table
    L = rep.shape[0]
    times = {}
    for _ in range(2):  # the second round is the one reported (warm caches)
        res = ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev, stage=stage_timer(times))
    check(res.n_bubbles == L and res.n_clusters > 0, "the timed pass gave no clustering")
    total = sum(times.values())
    say(f"[stages] one offline pass at L={L}, Lp={ops._pow2_rows(L)} (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in times.items()) + f"; total {total:.2f}")
    walls = []
    for _ in range(3):  # end to end: the unwrap is the pass's one synchronisation
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    say(f"[stages] the same pass end to end, no synchronisation but the unwrap's (ms): "
        + ", ".join(f"{w:.2f}" for w in walls))
    phase_profile(dev, table, float(np.median(walls)))

    def no_sync(name, fn, *args, **kw):  # any host synchronisation between prepare and unwrap raises
        if name in ("prepare", "unwrap"):
            return fn(*args, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    before = (k_h.launches_single_linkage, k_h.launches_condense, k_h.launches_extract, k_h.launches_eom)
    torch.cuda.synchronize()
    res2 = ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev, stage=no_sync)
    after = (k_h.launches_single_linkage, k_h.launches_condense, k_h.launches_extract, k_h.launches_eom)
    check(_same_partition(res2.labels, res.labels), "the pass under the sync debug mode differs")
    check([a - b for a, b in zip(after, before)] == [1, 1, 1, 0],
          f"hierarchy launches (single_linkage, condense, extract, eom) in one pass: {before} -> {after}")
    say("[stages] the same pass with torch.cuda.set_sync_debug_mode('error') from bubble_cd to extract: no host "
        "synchronisation raised; the hierarchy kernels launched once each")


def phase_profile(dev, table, wall_ms: float):
    """One offline pass under torch.profiler: the device's busy time (the
    sum of its kernels', copies' and fills' times; one stream, so they do
    not overlap) against ``wall_ms``, the untraced pass's wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    rep, extent, n_b, _ = table
    ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ops.offline_recluster_from_table(rep, n_b, extent, MIN_PTS, device=dev)
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    if busy <= 0:
        say(f"[stages] torch.profiler: no device time in the trace (traced wall {wall:.2f} ms); idle share not "
            f"measured")
        return
    say(f"[stages] torch.profiler, one pass: {len(events)} device functions, {sum(e.count for e in events)} "
        f"launches, device busy {busy:.3f} ms (traced wall {wall:.2f} ms); against the untraced wall "
        f"{wall_ms:.2f} ms: idle share {1 - busy / wall_ms:.3f}; top device time (ms): "
        + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} x{e.count}" for e in top))


def phase_wide(dev):
    """A default StreamingClusterEngine at d = 200 on the card: N_WIDE
    points from a seeded mixture ingested in blocks of BLOCK (compression
    0.02: L ~ 1,300, Lp = 2048), the last offline pass forced by a flush,
    then N_WIDE_QUERIES queries in chunks; every published snapshot and the
    served rows against the port's plain pipeline on the CPU.  At this
    width assign runs its feature-sliced kernel, bubble_cd its strip route
    and mutual_reach the distance panel's feature slices."""
    import torch

    from repro_torch import StreamingClusterEngine
    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import hierarchy as k_h
    from repro_torch.kernels import mutual_reach as k_mr

    rng = np.random.default_rng(SEED + 3)
    data = mixture(rng, N_WIDE + N_WIDE_QUERIES, dim=WIDE_DIM) + 50.0
    X, Qs = data[:N_WIDE], data[N_WIDE:]
    eng = StreamingClusterEngine(
        WIDE_DIM, min_pts=MIN_PTS, compression=COMPRESSION, epsilon=EPSILON, max_block=BLOCK, device=dev)
    for mod in (k_assign, k_bcd, k_mr):
        mod.launches = 0
    k_bcd.launches_ws = k_bcd.launches_strip = 0
    k_h.launches_single_linkage = k_h.launches_condense = k_h.launches_extract = k_h.launches_eom = 0
    snaps = []

    def note_pass(before):
        snap = eng.snapshot
        if snap is not None and snap.version != before:
            snaps.append((snap, eng._table.capture(eng.tree.n_points).table()))

    t0 = time.perf_counter()
    for i in range(0, N_WIDE, BLOCK):
        v0 = 0 if eng.snapshot is None else eng.snapshot.version
        eng.ingest(X[i : i + BLOCK])
        note_pass(v0)
    v0 = eng.snapshot.version
    eng.flush()
    note_pass(v0)
    served = [eng.query_detailed(Qs[i : i + QUERY_CHUNK]) for i in range(0, N_WIDE_QUERIES, QUERY_CHUNK)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"assign": k_assign.launches, "bubble_cd ws": k_bcd.launches_ws,
                "bubble_cd strip": k_bcd.launches_strip, "mutual_reach": k_mr.launches,
                "hierarchy": [k_h.launches_single_linkage, k_h.launches_condense, k_h.launches_extract],
                "eom": k_h.launches_eom}
    say(f"[wide] {N_WIDE} points d={WIDE_DIM} in blocks of {BLOCK}, {N_WIDE_QUERIES} queries: {wall:.2f} s wall, "
        f"{len(snaps)} offline passes at L = {[sn.n_bubbles for sn, _ in snaps]}; launches {json.dumps(launches)}")
    check(launches["assign"] > 0 and launches["mutual_reach"] == len(snaps) and launches["bubble_cd ws"] == 0
          and launches["bubble_cd strip"] == len(snaps) and launches["hierarchy"] == [len(snaps)] * 3
          and launches["eom"] == 0,
          f"d={WIDE_DIM} stream: launches {launches}")
    check(len(snaps) > 0, f"d={WIDE_DIM} stream: no offline pass")
    for k, (snap, table) in enumerate(snaps):
        check_snapshot("wide", f"pass {k + 1}", snap, table, MIN_PTS)
    last = snaps[-1][0]
    for res in served:
        check(res.version == last.version and np.isfinite(res.distance).all()
              and ((res.strength >= 0) & (res.strength <= 1)).all(), f"d={WIDE_DIM}: malformed query result")
    check_served("wide", last, Qs, served)


def knn_against_plain(X, kd, ki, k):
    """Hold knn(X, X, k) to the plain version, STRIP rows at a time:
    distances within dist_tol, indices identical on the entries apart from
    both neighbours of their sorted row by more than 64× the f32 rounding
    of the expanded form (such an entry has one possible index).  Returns
    the largest error and the count of such entries."""
    import torch

    from repro_torch.kernels import ref

    errs, kept = [], 0
    yy = float((X * X).sum(1).max())
    for i in range(0, X.shape[0], STRIP):
        q = X[i : i + STRIP]
        pd, pi = ref.knn(q, X, k + 1)
        errs.append(compare(f"knn k={k} rows {i}+", kd[i : i + STRIP], pd[:, :k], dist_tol(q, X, pd[:, :k]))[0])
        sq = pd.double().square()
        noise = 64 * EPS32 * ((q * q).sum(1).double() + yy)
        gap = (sq[:, 1:] - sq[:, :-1]) > noise[:, None]
        iso = torch.cat([torch.ones_like(gap[:, :1]), gap[:, : k - 1]], dim=1) & gap
        check(bool(torch.equal(ki[i : i + STRIP][iso], pi[:, :k][iso])),
              f"knn k={k} rows {i}+: indices differ on entries without near-ties")
        kept += int(iso.sum())
        del pd, pi, sq
    check(kept > X.shape[0] * k // 4, f"knn k={k}: only {kept} entries without near-ties")
    return max(errs), kept


def phase_min_pts(dev, table):
    """One offline pass per ``MIN_PTS_PASSES`` entry on the stream's full
    table through the engine's entry point: min_pts = 100 (past the
    per-lane kernel's bound, the warp-select kernel) and 2000 (past the
    warp-select core's, bubble_cd's strip route), each against the port's
    plain pipeline on the CPU.

    The warp-select pass must give the CPU pass's partition.  At
    min_pts = 2000 a row's crossing lies ~40 bubbles deep, where the
    sorted distances sit ~1e-3 apart relative, so the f32 rounding of the
    kernel's FMA chains and of the plain version's matrix product can swap
    two bubbles at the crossing of a few rows of 5,243: those rows' core
    distances then differ by more than rounding, and the partition may.  So
    the strip pass is held in two parts: its Eq. 6 core distances to the
    plain version's on every row whose crossing is not a near-tie
    (``clear_crossings``), and the rest of the pass to the CPU plain pass
    given those same core distances (through the ``stage`` hook).  Where
    no row differs, the partition must equal the plain pass's as well."""
    import torch

    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    rep, extent, n_b, _ = table
    L = rep.shape[0]
    for min_pts, route in MIN_PTS_PASSES:
        cds = []  # the card pass's core distances, then the CPU pass's

        def capture(name, fn, *args, **kw):
            out = fn(*args, **kw)
            if name == "bubble_cd":
                cds.append(out)
            return out

        k_bcd.launches_ws = k_bcd.launches_strip = k_bcd.launches_lane = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ops.offline_recluster_from_table(rep, n_b, extent, min_pts, device=dev, stage=capture)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        launches = {"ws": k_bcd.launches_ws, "strip": k_bcd.launches_strip, "lane": k_bcd.launches_lane}
        check(launches == {"ws": int(route == "ws"), "strip": int(route == "strip"), "lane": 0},
              f"min_pts={min_pts} pass: bubble_cd launches per route {launches}")
        cpu = ops.offline_recluster_from_table(rep, n_b, extent, min_pts, device="cpu", stage=capture)
        w_gpu, w_cpu = float(np.sum(res.mst[2])), float(np.sum(cpu.mst[2]))
        rel = abs(w_gpu - w_cpu) / abs(w_cpu)
        same = res.n_clusters > 0 and _same_partition(res.labels, cpu.labels)
        say(f"[min_pts] one offline pass at L={L} min_pts={min_pts}: {gpu_s:.2f} s on the card, "
            f"bubble_cd launches per route {json.dumps(launches)}; {res.n_clusters} vs {cpu.n_clusters} "
            f"clusters on the CPU plain pass, same partition: {same}, MST weight rel diff {rel:.3e}")
        if route == "ws":
            check(same, f"min_pts={min_pts}: partition differs from the CPU pass")
            check(rel <= RTOL, f"min_pts={min_pts}: MST weight differs by {rel:.3e}")
            continue
        # the strip pass: core distances, then the rest of the pass on equal core distances
        (rep_t, nb_t, _), mp, _ = ops._prepare_table(rep, n_b, extent, min_pts, dev)
        got, want = cds[0][:L], cds[1][:L].to(dev)
        sq = ref.pairwise_sqdist(rep_t[:L], rep_t[:L]).fill_diagonal_(float("inf"))
        r1 = sq.amin(1).sqrt()
        del sq
        tol = dist_tol(rep_t[:L], rep_t[:L], r1) - RTOL * r1 + RTOL * want.abs()
        differ = (got - want).abs() > tol
        clear = clear_crossings(rep_t[:L], nb_t[:L], mp)
        check(int(clear.sum()) > 0.8 * L, f"min_pts={min_pts}: only {int(clear.sum())} clear crossings")
        check(not bool((differ & clear).any()),
              f"min_pts={min_pts}: {int((differ & clear).sum())} core distances differ on clear crossings")
        e, _ = compare(f"min_pts={min_pts} core distances", got[clear], want[clear], tol[clear])
        gpu_cd = cds[0].cpu()
        same_cd = ops.offline_recluster_from_table(
            rep, n_b, extent, min_pts, device="cpu",
            stage=lambda name, fn, *a, **kw: gpu_cd if name == "bubble_cd" else fn(*a, **kw))
        w_same = float(np.sum(same_cd.mst[2]))
        rel_same = abs(w_gpu - w_same) / abs(w_same)
        say(f"[min_pts] min_pts={min_pts} (strip route): core distances vs plain max_abs_err {e:.3e} on the "
            f"{int(clear.sum())} of {L} rows without a near-tie at the crossing; {int(differ.sum())} rows differ "
            f"beyond rounding, all at near-tie crossings; the CPU plain pass on the card's core distances: "
            f"{same_cd.n_clusters} clusters, same partition, MST weight rel diff {rel_same:.3e}")
        check(res.n_clusters > 0 and _same_partition(res.labels, same_cd.labels),
              f"min_pts={min_pts}: partition differs from the CPU pass on the same core distances")
        check(rel_same <= RTOL, f"min_pts={min_pts}: MST weight differs by {rel_same:.3e} on the same core distances")
        if not bool(differ.any()):
            check(same and rel <= RTOL, f"min_pts={min_pts}: no core distance differs, yet the pass does")
    # bubble_cd's strip route alone at the pass's table and min_pts
    (rep_t, nb_t, ext_t), mp, _ = ops._prepare_table(rep, n_b, extent, K_STRIP, dev)
    ms = time_ms(lambda: k_bcd.bubble_core_distances(rep_t, nb_t, ext_t, min_pts=mp, dim=DIM), reps=3, warm=1)
    say(f"[min_pts] bubble_cd strip route at Lp={rep_t.shape[0]} d={DIM} min_pts={mp}: {ms:.4f} ms")


def pair_against_plain(Xs, P, W, cds):
    """Hold pairwise P and point mutual reachability W (diagonal 0) of Xs
    to the plain versions, STRIP rows at a time, and mutual_reach with
    zero core distances to sqrt(P) bit for bit.  Returns both largest
    errors."""
    import torch

    from repro_torch.kernels import mutual_reach as k_mr
    from repro_torch.kernels import ref

    n = Xs.shape[0]
    dsq = sq_tol(Xs, Xs)
    e_pw, e_mr = [], []
    for i in range(0, n, STRIP):
        q = Xs[i : i + STRIP]
        pp = ref.pairwise_sqdist(q, Xs)
        e_pw.append(compare(f"pairwise rows {i}+", P[i : i + STRIP], pp, RTOL * pp + dsq)[0])
        pW = ref.mutual_reachability(q, Xs, cds[i : i + STRIP], cds, zero_diag=False)
        rows = torch.arange(q.shape[0], device=Xs.device)
        pW[rows, i + rows] = 0.0  # the global diagonal
        e_mr.append(compare(f"mutual_reachability rows {i}+", W[i : i + STRIP], pW,
                            dist_tol(q, Xs, pp.sqrt()) + RTOL * pW.abs())[0])
        del pp, pW
    z = torch.zeros(n, device=Xs.device)
    W0 = k_mr.mutual_reachability(Xs, Xs, z, z, zero_diag=False)
    check(bool(torch.equal(W0, P.sqrt())), "pairwise and mutual_reach disagree on squared-distance bits")
    return max(e_pw), max(e_mr)


def pair_against_tile(X, P, W, cds):
    """Hold pairwise P and point mutual reachability W of X bit for bit to
    the tile kernels they replaced (one tile output on the card at a time)."""
    import torch

    from repro_torch.kernels import mutual_reach as k_mr
    from repro_torch.kernels import pairwise as k_pw

    check(bool(torch.equal(P, k_pw.pairwise_tile(X, X))), f"pairwise d={X.shape[1]}: differs from the tile kernel")
    check(bool(torch.equal(W, k_mr.mutual_reach_tile(X, X, cds, cds))),
          f"mutual_reachability d={X.shape[1]}: differs from the tile kernel")
    torch.cuda.empty_cache()


def phase_points(dev):
    """The point-level kernel API through ops at a size users call real;
    returns the launches of that run and the per-kernel numbers."""
    import torch

    from repro_torch.kernels import knn as k_knn
    from repro_torch.kernels import mutual_reach as k_mr
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise as k_pw
    from repro_torch.kernels import ref

    rng = np.random.default_rng(SEED + 1)  # the stream's mixture (phase_stream)
    pts = mixture(rng, N_POINTS + N_QUERIES)[:N_KNN]
    X = torch.as_tensor(pts - pts.mean(axis=0), dtype=torch.float32, device=dev)
    Xs = X[:N_PAIR].contiguous()
    k = MIN_PTS

    for mod in (k_knn, k_pw, k_mr):
        mod.launches = 0
    k_knn.launches_lane = k_pw.launches_tile = k_mr.launches_tile = 0
    cd = ops.core_distances(X, k)
    kd, ki = ops.knn(X, X, k)
    P = ops.pairwise_sqdist(Xs, Xs)
    cds = cd[:N_PAIR].contiguous()
    W = ops.mutual_reachability(Xs, Xs, cds, cds)
    torch.cuda.synchronize()
    launches = {"knn": k_knn.launches, "pairwise": k_pw.launches, "mutual_reach": k_mr.launches}
    say(f"[points] core_distances + knn at {N_KNN}x{N_KNN}x{DIM} k={k}, pairwise + mutual_reachability "
        f"at {N_PAIR}²: launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the point-level path")
    check(k_knn.launches_lane == 0, "the per-lane knn kernel ran on the point-level path")
    check(k_pw.launches_tile == k_mr.launches_tile == 0, "a tile kernel ran on the point-level path")
    check(bool(torch.equal(cd, kd[:, k - 1])), "core_distances is not the knn's k-th column")
    ld, li = k_knn.knn_lane(X, X, k)
    check(bool(torch.equal(kd, ld)) and bool(torch.equal(ki, li)),
          f"knn differs from the per-lane kernel: {int((kd != ld).sum())} distances, {int((ki != li).sum())} indices")
    del ld, li
    knn_err, kept = knn_against_plain(X, kd, ki, k)
    say(f"[points] knn identical to the per-lane kernel at {N_KNN}² k={k} (distances and indices); "
        f"knn / core_distances vs plain: max_abs_err {knn_err:.3e}; "
        f"indices identical on the {kept} of {N_KNN * k} entries without near-ties")

    e_pw, e_mr = pair_against_plain(Xs, P, W, cds)
    pair_against_tile(Xs, P, W, cds)
    say(f"[points] pairwise vs plain max_abs_err {e_pw:.3e}; mutual_reachability vs plain "
        f"max_abs_err {e_mr:.3e}; both identical to the tile kernels; mutual_reach(cd=0) == sqrt(pairwise) "
        f"bit for bit")

    # the (d, j) order among copies: a duplicate-heavy table against a
    # yardstick in the direct-difference form √Σ(x−y)², where copies are
    # exactly 0 apart as in the kernel.  Each row's first min(copies, k)
    # entries are its site's lowest copy indices at distance 0; the rest sit
    # at other sites and get the cancellation allowance.
    sites = mixture(rng, 1000)
    sites -= sites.mean(axis=0)
    site = rng.integers(0, 1000, size=N_PAIR)
    Xd = torch.as_tensor(sites[site], dtype=torch.float32, device=dev)
    dd, di = k_knn.knn(Xd, Xd, k)
    ld, li = k_knn.knn_lane(Xd, Xd, k)
    check(bool(torch.equal(dd, ld)) and bool(torch.equal(di, li)), "knn duplicates: differs from the per-lane kernel")
    yd, yi = [], []
    for i in range(0, N_PAIR, 256):
        dist = (Xd[i : i + 256, None, :] - Xd[None, :, :]).square().sum(-1).sqrt()
        v, j = torch.sort(dist, dim=1, stable=True)
        yd.append(v[:, :k])
        yi.append(j[:, :k].to(torch.int32))
    yd, yi = torch.cat(yd), torch.cat(yi)
    copies = torch.as_tensor(np.bincount(site, minlength=1000)[site], device=dev)
    own = torch.arange(k, device=dev)[None, :] < copies.clamp_max(k)[:, None]
    check(bool(torch.equal(di[own], yi[own])) and bool((dd[own] == 0).all()),
          "knn duplicates: the lowest-index order among copies differs")
    e_dup, _ = compare("knn duplicates, other sites", dd[~own], yd[~own],
                       dist_tol(Xd, Xd, yd)[~own])
    say(f"[points] knn duplicate table ({N_PAIR} rows, 1000 sites): identical to the per-lane kernel; "
        f"{int(own.sum())} entries among "
        f"own copies identical to the direct-difference yardstick; other entries max_abs_err {e_dup:.3e}")
    knn_err = max(knn_err, e_dup)
    del Xd, dd, di, yd, yi, P, W
    torch.cuda.empty_cache()

    # times
    out = {}
    ms = time_ms(lambda: k_knn.knn(X, X, k), reps=3, warm=1)
    lane_ms = time_ms(lambda: k_knn.knn_lane(X, X, k), reps=3, warm=1)

    def plain_knn():
        for i in range(0, N_KNN, STRIP):
            ref.knn(X[i : i + STRIP], X, k)

    plain = time_ms(plain_knn, reps=1, warm=1)
    torch.cuda.empty_cache()
    lib = time_ms(lambda: torch.topk(torch.cdist(X, X), k, dim=1, largest=False), reps=2, warm=1)
    torch.cuda.empty_cache()
    b, by = bound_ms(2.0 * N_KNN * N_KNN * DIM, 4.0 * (2 * N_KNN * DIM + 2 * N_KNN * k))
    say(f"[points] knn {N_KNN}x{N_KNN}x{DIM} k={k}: kernel {ms:.4f} ms, per-lane kernel {lane_ms:.4f} ms, "
        f"plain ({N_KNN // STRIP} strips) {plain:.4f} ms, cdist+topk {lib:.4f} ms, bound {b:.4f} ms ({by})")
    out["knn"] = dict(max_abs_err=knn_err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)
    # k past the per-lane kernel's 64, against the plain version
    for kk in KNN_SWEEP:
        sweep_ms = time_ms(lambda: k_knn.knn(X, X, kk), reps=3, warm=1)
        note = ""
        if kk == 64:
            sd, si = k_knn.knn(X, X, kk)
            ld, li = k_knn.knn_lane(X, X, kk)
            check(bool(torch.equal(sd, ld)) and bool(torch.equal(si, li)), "knn k=64 differs from the per-lane kernel")
            note = "; identical to the per-lane kernel"
            del sd, si, ld, li
        elif kk > 64:
            sd, si = k_knn.knn(X, X, kk)
            e, kept = knn_against_plain(X, sd, si, kk)
            note = f"; vs plain max_abs_err {e:.3e}, indices identical on the {kept} of {N_KNN * kk} entries without near-ties"
            del sd, si
        torch.cuda.empty_cache()
        say(f"[points] knn sweep {N_KNN}² k={kk}: kernel {sweep_ms:.4f} ms{note}")

    # k past the warp-select core's 1024: the strip route, through ops
    k_knn.launches_ws = k_knn.launches_strip = 0
    cd2 = ops.core_distances(X, K_STRIP)
    kd2, ki2 = ops.knn(X, X, K_STRIP)
    torch.cuda.synchronize()
    routes = (k_knn.launches_ws, k_knn.launches_strip)
    check(routes == (0, 2), f"knn k={K_STRIP}: launches (ws, strip) {routes}, not (0, 2)")
    check(bool(torch.equal(cd2, kd2[:, K_STRIP - 1])), f"core_distances k={K_STRIP} is not the knn's last column")
    del cd2
    e2, kept2 = knn_against_plain(X, kd2, ki2, K_STRIP)
    del kd2, ki2
    torch.cuda.empty_cache()
    strip_ms = time_ms(lambda: k_knn.knn(X, X, K_STRIP), reps=1, warm=0)
    torch.cuda.empty_cache()
    say(f"[points] knn / core_distances at {N_KNN}² k={K_STRIP} (strip route; launches ws {routes[0]}, strip "
        f"{routes[1]}): vs plain max_abs_err {e2:.3e}, indices identical on the {kept2} of {N_KNN * K_STRIP} entries "
        f"without near-ties; {strip_ms:.4f} ms per knn call")

    ms = time_ms(lambda: k_pw.pairwise_sqdist(Xs, Xs), reps=20)
    tile_ms = time_ms(lambda: k_pw.pairwise_tile(Xs, Xs), reps=20)
    fill = fill_ms(N_PAIR, N_PAIR)
    plain = time_ms(lambda: ref.pairwise_sqdist(Xs, Xs), reps=5)
    lib_cdist = time_ms(lambda: torch.cdist(Xs, Xs).square_(), reps=5)
    xx = (Xs * Xs).sum(1)
    lib_addmm = time_ms(lambda: torch.addmm(xx[None, :], Xs, Xs.T, alpha=-2.0).add_(xx[:, None]).clamp_min_(0.0),
                        reps=5)
    b, by = bound_ms(2.0 * N_PAIR * N_PAIR * DIM, 4.0 * (N_PAIR * N_PAIR + 2 * N_PAIR * DIM))
    say(f"[points] pairwise {N_PAIR}²x{DIM}: kernel {ms:.4f} ms, tile kernel {tile_ms:.4f} ms, write rate (fill_) "
        f"{fill:.4f} ms, plain {plain:.4f} ms, cdist**2 {lib_cdist:.4f} ms, addmm expansion {lib_addmm:.4f} ms, "
        f"bound {b:.4f} ms ({by})")
    out["pairwise"] = dict(max_abs_err=e_pw, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                           library_ms=min(lib_cdist, lib_addmm), tile_ms=tile_ms)
    ms = time_ms(lambda: k_mr.mutual_reachability(Xs, Xs, cds, cds), reps=20)
    tile_ms = time_ms(lambda: k_mr.mutual_reach_tile(Xs, Xs, cds, cds), reps=20)
    say(f"[points] point-level mutual_reachability {N_PAIR}²x{DIM}: kernel {ms:.4f} ms, tile kernel "
        f"{tile_ms:.4f} ms, write rate (fill_) {fill:.4f} ms, bound {b:.4f} ms ({by})")
    del Xs, X
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    points_wide(dev, rng)
    return launches, out


def points_wide(dev, rng):
    """All four point-level calls at d = 200, past the register tile's 128,
    through ops: knn and core distances by the strip route, pairwise and
    mutual reachability by the distance panel's feature slices; each
    against its plain version and the latter two against the tile kernels,
    with the route counters checked."""
    import torch

    from repro_torch.kernels import knn as k_knn
    from repro_torch.kernels import mutual_reach as k_mr
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise as k_pw

    pts = mixture(rng, N_WIDE_POINTS, dim=WIDE_DIM)
    X = torch.as_tensor(pts - pts.mean(axis=0), dtype=torch.float32, device=dev)
    k = MIN_PTS
    for mod in (k_knn, k_pw, k_mr):
        mod.launches = 0
    k_knn.launches_ws = k_knn.launches_strip = 0
    cd = ops.core_distances(X, k)
    kd, ki = ops.knn(X, X, k)
    P = ops.pairwise_sqdist(X, X)
    W = ops.mutual_reachability(X, X, cd, cd)
    torch.cuda.synchronize()
    launches = {"knn ws": k_knn.launches_ws, "knn strip": k_knn.launches_strip, "pairwise": k_pw.launches,
                "mutual_reach": k_mr.launches}
    check(launches == {"knn ws": 0, "knn strip": 2, "pairwise": 1, "mutual_reach": 1},
          f"d={WIDE_DIM} point-level launches {launches}")
    check(bool(torch.equal(cd, kd[:, k - 1])), f"d={WIDE_DIM}: core_distances is not the knn's k-th column")
    e_knn, kept = knn_against_plain(X, kd, ki, k)
    e_pw, e_mr = pair_against_plain(X, P, W, cd)
    pair_against_tile(X, P, W, cd)
    del P, W
    torch.cuda.empty_cache()
    n = X.shape[0]
    knn_ms = time_ms(lambda: k_knn.knn(X, X, k), reps=2, warm=1)
    pw_ms = time_ms(lambda: k_pw.pairwise_sqdist(X, X), reps=5)
    pw_tile = time_ms(lambda: k_pw.pairwise_tile(X, X), reps=5)
    mr_ms = time_ms(lambda: k_mr.mutual_reachability(X, X, cd, cd), reps=5)
    mr_tile = time_ms(lambda: k_mr.mutual_reach_tile(X, X, cd, cd), reps=5)
    b, by = bound_ms(2.0 * n * n * WIDE_DIM, 4.0 * (n * n + 2 * n * WIDE_DIM))
    say(f"[points] d={WIDE_DIM} at {n}², k={k}, launches {json.dumps(launches)}: knn / core_distances vs plain "
        f"max_abs_err {e_knn:.3e}, indices identical on the {kept} of {n * k} entries without near-ties; pairwise "
        f"max_abs_err {e_pw:.3e}; mutual_reachability max_abs_err {e_mr:.3e}; both identical to the tile kernels; "
        f"mutual_reach(cd=0) == sqrt(pairwise) bit for bit; knn (strip route) {knn_ms:.4f} ms, pairwise "
        f"{pw_ms:.4f} ms (tile kernel {pw_tile:.4f}), mutual_reachability {mr_ms:.4f} ms (tile kernel "
        f"{mr_tile:.4f}), bound {b:.4f} ms ({by})")
    del X, kd, ki, cd
    torch.cuda.empty_cache()


def _live_pairs(qpos, kpos, window, causal=True):
    """Live (query, key) pairs of (B, S) position vectors."""
    n = 0
    for qp, kp in zip(qpos, kpos):
        live = (kp[None, :] >= 0) & ((kp[None, :] <= qp[:, None]) if causal else (qp[:, None] == qp[:, None]))
        if window is not None:
            live &= kp[None, :] > qp[:, None] - window
        n += int(live.sum())
    return n


def flash_reading(o, want, dt):
    """The attention check's two readings of an output against the plain
    one, each over its limit (the output passes while both are <= 1):
    the largest |o - want| / (atol + rtol·|want|), and the largest per-row
    ‖o - want‖ / ‖want‖ over the row limit.  The kernel keeps (m, l, acc)
    in f32, so in bf16 the two differ by the output's rounding (one bf16
    ulp is at most 2^-7 relative): the limits scale with the values, which
    shrink like 1/√(live keys), instead of a flat atol that a late row's
    whole value fits under."""
    rtol, atol, row_tol = (1e-4, 2e-4, 1e-3) if dt == "f32" else (1e-2, 2e-3, 1e-2)
    d = o - want
    elem = float((d.abs() / (atol + rtol * want.abs())).max())
    row = float((d.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max()) / row_tol
    return elem, row


def phase_attention(dev):
    """GQA flash attention through ops at the full attention widths of two
    configurations; returns the launches of that run and the numbers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cases = []
    for label, B, S, H, KV, Dh, window, dt, dead_head, dead_tail in ATTENTION:
        q, k, v = (torch.randn(B, S, h, Dh, generator=gen, device=dev).to(dtypes[dt]) for h in (H, KV, KV))
        pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
        kpos = pos.clone()
        kpos[:, :dead_head] = -1
        kpos[:, S - dead_tail:] = -1
        cases.append((label, q, k, v, pos, kpos, window, dt))

    k_fa.launches = k_fa.launches_mma = k_fa.launches_simt = k_fa.launches_mma_v1 = 0
    outs = [ops.flash_attention(q, k, v, qp, kp, causal=True, window=w) for _, q, k, v, qp, kp, w, _ in cases]
    torch.cuda.synchronize()
    launches = {"flash_attention_mma": k_fa.launches_mma, "flash_attention": k_fa.launches_simt,
                "flash_attention_mma_v1": k_fa.launches_mma_v1}
    n_bf16 = sum(dt == "bf16" for *_, dt in cases)
    say(f"[attention] {len(cases)} calls of ops.flash_attention: launches {k_fa.launches}, per route "
        f"{json.dumps(launches)}")
    check(k_fa.launches == len(cases), "flash_attention kernel not launched once per call")
    check(launches["flash_attention_mma_v1"] == 0, "the first tensor-core kernel launched on the main path")
    check(launches["flash_attention_mma"] == n_bf16, "a bf16 case did not take the tensor-core kernel")
    check(launches["flash_attention"] == len(cases) - n_bf16,
          "an f32 case did not take the CUDA-core kernel (flash_attention_panel.cu)")

    def plain(q, k, v, qp, kp, window):
        """The plain version, one kv head (G query heads) at a time."""
        G = q.shape[2] // k.shape[2]
        res = []
        for g in range(k.shape[2]):
            hq = q[:, :, g * G : (g + 1) * G].transpose(1, 2)
            hk, hv = (t[:, :, g : g + 1].transpose(1, 2) for t in (k, v))
            res.append(ref.gqa_flash_attention(hq, hk, hv, qp, kp, True, window))
        return res

    def wrong_readings(q, k, v, qp, kp, window, want, dt):
        """What the check reads on two wrong outputs of kv head 0: the
        rows past S/2 zeroed, and the 64 keys from S/2 dropped (a lost
        K/V tile).  Returns their readings and their largest |error|."""
        S = q.shape[1]
        zeroed = want.clone()
        zeroed[:, :, S // 2 :] = 0
        kd = kp.clone()
        kd[:, S // 2 : S // 2 + 64] = -1
        dropped = plain(q[:, :, : q.shape[2] // k.shape[2]], k[:, :, :1], v[:, :, :1], qp, kd, window)[0].float()
        return {name: (*flash_reading(w, want, dt), float((w - want).abs().max()))
                for name, w in (("late rows zeroed", zeroed), ("one K/V tile dropped", dropped))}

    out = {}
    for (label, q, k, v, qp, kp, window, dt), got in zip(cases, outs):
        B, S, H, Dh = q.shape
        G = H // k.shape[2]
        err, elem, row = 0.0, 0.0, 0.0
        wants = [w.float() for w in plain(q, k, v, qp, kp, window)]
        for g, want in enumerate(wants):
            o = got[:, :, g * G : (g + 1) * G].transpose(1, 2).float()
            check(bool(torch.isfinite(o).all()), f"{label}: non-finite output")
            e, r = flash_reading(o, want, dt)
            check(e <= 1 and r <= 1, f"{label}: kv head {g} outside tolerance, readings {e:.3f} (elements), "
                                     f"{r:.3f} (rows)")
            err, elem, row = max(err, float((o - want).abs().max())), max(elem, e), max(row, r)
            if g == 0:
                for name, (we, wr, wa) in wrong_readings(q, k, v, qp, kp, window, want, dt).items():
                    say(f"[attention] {label}: a wrong output ({name}) reads {we:.3f} (elements), {wr:.3f} (rows), "
                        f"max |error| {wa:.3e}")
                    check(we > 1 or wr > 1, f"{label}: the check passes a wrong output ({name})")
        scalar = None
        if dt == "f32":  # the earlier CUDA-core kernel on the same inputs
            heads = [t.transpose(1, 2) for t in (q, k, v)]
            old = k_fa.flash_attention_scalar(*heads, qp, kp, causal=True, window=window).transpose(1, 2)
            e, r = flash_reading(got, old, dt)
            scalar = dict(err=float((got - old).abs().max()), elem=e, row=r,
                          ms=time_ms(lambda: k_fa.flash_attention_scalar(*heads, qp, kp, causal=True, window=window),
                                     reps=5))
            check(e <= 1 and r <= 1, f"{label}: outside tolerance of the earlier CUDA-core kernel, readings "
                                     f"{e:.3f} (elements), {r:.3f} (rows)")
            del old
        dead_rows = int((~((kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])).any(-1)).sum())
        live = _live_pairs(qp, kp, window)
        peak = PEAK_BF16_FLOPS if dt == "bf16" else PEAK_F32_FLOPS
        nbytes = q.element_size() * 2 * (q.numel() + k.numel())
        b, by = bound_ms(4.0 * Dh * live * H, nbytes, peak)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, qp, kp, causal=True, window=window), reps=5)
        host = host_ms(lambda: ops.flash_attention(q, k, v, qp, kp, causal=True, window=window))
        p_ms = time_ms(lambda: plain(q, k, v, qp, kp, window), reps=1, warm=1)
        lib = None
        if not dead_rows:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window is None:
                lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
                              reps=5)
            else:
                p = qp[0]
                mask = (p[None, :] <= p[:, None]) & (p[None, :] > p[:, None] - window)
                lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True),
                              reps=5)
        say(f"[attention] {label}: B={B} S={S} H={H} KV={k.shape[2]} Dh={Dh} window={window}, "
            f"{dead_rows} fully masked rows; max_abs_err {err:.3e}, readings {elem:.3f} (elements), "
            f"{row:.3f} (rows) of limit 1; kernel {ms:.4f} ms (host {host:.4f} ms per call), "
            f"plain {p_ms:.4f} ms, "
            f"sdpa {'n/a' if lib is None else f'{lib:.4f} ms'}, bound {b:.4f} ms ({by}, {live} live "
            f"(query, key) pairs per head, at the {dt} peak)")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b, bound_by=by, library_ms=lib)
        if dt == "bf16":
            out[label].update(mma_v1(label, "[attention]", q, k, v, qp, kp, True, window, got, ms, wants))
        if scalar:
            say(f"[attention] {label}: against the earlier CUDA-core kernel max |new - scalar| {scalar['err']:.3e}, "
                f"readings {scalar['elem']:.3f} (elements), {scalar['row']:.3f} (rows); kernel {ms:.4f} ms, "
                f"scalar kernel {scalar['ms']:.4f} ms ({scalar['ms'] / ms:.2f}x)")
            out[label]["scalar_ms"] = scalar["ms"]
        torch.cuda.empty_cache()
    del cases, outs
    attention_simt_bf16(dev, gen, plain)
    return launches, out


def attention_simt_bf16(dev, gen, plain):
    """bf16 through the CUDA-core route (Dh past the tensor-core kernel's
    128), outside the counted run: held to the plain version and to the
    earlier CUDA-core kernel, both timed."""
    import torch

    from repro_torch.kernels import flash_attention as k_fa

    label, B, S, H, KV, Dh = SIMT_BF16
    q, k, v = (torch.randn(B, S, h, Dh, generator=gen, device=dev).bfloat16() for h in (H, KV, KV))
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    before = (k_fa.launches_mma, k_fa.launches_simt)
    got = k_fa.flash_attention(*heads, pos, pos, causal=True).transpose(1, 2)
    old = k_fa.flash_attention_scalar(*heads, pos, pos, causal=True).transpose(1, 2)
    torch.cuda.synchronize()
    check((k_fa.launches_mma, k_fa.launches_simt) == (before[0], before[1] + 1),
          f"{label}: did not take the CUDA-core kernel")
    G = H // KV
    elem, row = 0.0, 0.0
    for g, want in enumerate(plain(q, k, v, pos, pos, None)):
        e, r = flash_reading(got[:, :, g * G : (g + 1) * G].transpose(1, 2).float(), want.float(), "bf16")
        elem, row = max(elem, e), max(row, r)
    e_old, r_old = flash_reading(got.float(), old.float(), "bf16")
    check(bool(torch.isfinite(got).all()) and max(elem, row, e_old, r_old) <= 1,
          f"{label}: readings {elem:.3f} / {row:.3f} against plain, {e_old:.3f} / {r_old:.3f} against the scalar kernel")
    ms = time_ms(lambda: k_fa.flash_attention(*heads, pos, pos, causal=True), reps=5)
    old_ms = time_ms(lambda: k_fa.flash_attention_scalar(*heads, pos, pos, causal=True), reps=5)
    say(f"[attention] {label}: B={B} S={S} H={H} KV={KV} Dh={Dh}, CUDA-core route; readings {elem:.3f} (elements), "
        f"{row:.3f} (rows) against plain, {e_old:.3f} / {r_old:.3f} against the earlier kernel (max |new - scalar| "
        f"{float((got.float() - old.float()).abs().max()):.3e}); kernel {ms:.4f} ms, scalar kernel {old_ms:.4f} ms "
        f"({old_ms / ms:.2f}x)")
    del q, k, v, got, old
    torch.cuda.empty_cache()


def lm_configs():
    """[lm]'s three configurations: qwen2-1.5b at its published widths (bf16
    compute), the same with LM_F32_LAYERS layers in f32 compute (the
    CUDA-core flash route), and its SMOKE size in f32 (the CPU replay)."""
    import torch

    from repro_torch import configs as C

    cfg = C.get(LM_ARCH)
    return (cfg, cfg.replace(n_layers=LM_F32_LAYERS, compute_dtype=torch.float32),
            C.get_smoke(LM_ARCH).replace(compute_dtype=torch.float32))


def lm_prompts(cfg, rng, long_len: int = LM_LONG):
    """The ragged case: LM_SHORT prompts of 4–16 tokens, the
    ``long_len``-token one at LM_LONG_AT."""
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 17))).astype(np.int32)
               for _ in range(LM_SHORT)]
    prompts.insert(LM_LONG_AT, rng.integers(0, cfg.vocab_size, size=long_len).astype(np.int32))
    return prompts


def lm_serve(eng, prompts, new: int):
    """Greedy requests of ``new`` tokens through ``eng``; returns the
    requests and the sampler's log, (rid, logits over the vocab, token) in
    call order."""
    from repro_torch.serving import Request

    log, sample = [], eng._sample

    def logged(logits, req):
        tok = sample(logits, req)
        log.append((req.rid, np.asarray(logits[: eng.cfg.vocab_size], np.float64), tok))
        return tok

    eng._sample = logged
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    del eng._sample  # back to the class's method, with no reference cycle through the engine
    check(all(r.done and len(r.generated) == new for r in reqs), "a request did not finish with all its tokens")
    check(all(0 <= t < eng.cfg.vocab_size for r in reqs for t in r.generated), "a token outside the vocab")
    check(all(np.isfinite(lg).all() for _, lg, _ in log), "non-finite logits")
    return reqs, log


def lm_serve_timed(eng, prompts, base: int, new: int = LM_NEW):
    """The ragged case through ``eng`` (``new`` greedy tokens a request)
    with every prefill and decode step timed (synchronised) and each
    prefill's flash launches per route counted; the counters are set to 0
    just before the run.  Returns the requests, [(S, ms, mma, simt)] per
    prefill, [(active slots, ms)] per step, the launches of the run, its
    wall (s) and peak memory (GiB above ``base``)."""
    import torch

    from repro_torch.kernels import flash_attention as k_fa

    prefills, steps = [], []
    prefill_one, serve_step = eng._prefill_one, eng.serve_step

    def timed_prefill(params, toks):
        before = (k_fa.launches_mma, k_fa.launches_simt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill_one(params, toks)
        torch.cuda.synchronize()
        prefills.append((toks.shape[1], (time.perf_counter() - t0) * 1e3, k_fa.launches_mma - before[0],
                         k_fa.launches_simt - before[1]))
        return out

    def timed_step(*args):
        active = sum(r is not None for r in eng.slot_req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_step(*args)
        torch.cuda.synchronize()
        steps.append((active, (time.perf_counter() - t0) * 1e3))
        return out

    eng._prefill_one, eng.serve_step = timed_prefill, timed_step
    torch.cuda.reset_peak_memory_stats()
    k_fa.launches = k_fa.launches_mma = k_fa.launches_simt = 0
    t0 = time.perf_counter()
    try:
        reqs, _ = lm_serve(eng, prompts, new)
    finally:
        del eng._prefill_one  # back to the class's method, with no reference cycle through the engine
        eng.serve_step = serve_step
    wall = time.perf_counter() - t0
    launches = {"flash_attention_mma": k_fa.launches_mma, "flash_attention": k_fa.launches_simt}
    return dict(reqs=reqs, prefills=prefills, steps=steps, launches=launches, wall=wall,
                peak=(torch.cuda.max_memory_allocated() - base) / 2**30)


def lm_serve_report(phase: str, eng, run, long_len: int, n_layers: int, peak_build: float, base: int):
    """Print and check a timed ragged serve: every request finished, the
    long prefill launched the tensor-core kernel once per layer and
    nothing else launched a flash kernel.  Returns (long prefill ms,
    median decode ms per step at LM_SLOTS)."""
    prefills, launches = run["prefills"], run["launches"]
    long_ms = [ms for S, ms, _, _ in prefills if S == long_len]
    short = [(S, mma, simt) for S, _, mma, simt in prefills if S != long_len]
    long_launches = [(mma, simt) for S, _, mma, simt in prefills if S == long_len]
    say(f"{phase} ragged serve: {len(run['reqs'])} requests ({LM_SHORT} of 4-16 tokens, one of {long_len}) on "
        f"{LM_SLOTS} slots, cache_len {eng.cache_len}, {len(run['reqs'][0].generated)} greedy tokens each: all "
        f"finished; {eng.tokens_out} "
        f"tokens in {eng.steps} steps, {run['wall'] * 1e3:.1f} ms, {eng.tokens_out / run['wall']:.1f} tokens/s; "
        f"flash launches {json.dumps(launches)}: the long prefill (mma, simt) {long_launches}, the short prefills "
        f"{sum(m + s for _, m, s in short)}, decode 0 (Sq = 1 takes the plain branch)")
    check(long_launches == [(n_layers, 0)], f"{phase} the {long_len}-token prefill did not launch the tensor-core "
                                            f"kernel {n_layers} times: {long_launches}")
    check(all(m == s == 0 for _, m, s in short), f"{phase} a short prefill launched a flash kernel")
    check(launches == {"flash_attention_mma": n_layers, "flash_attention": 0},
          f"{phase} flash launches over the run {launches}: a decode step launched the kernel")
    full = sorted(ms for active, ms in run["steps"] if active == LM_SLOTS)
    check(bool(full), f"{phase} no decode step ran with every slot busy")
    say(f"{phase} long prefill ({long_len} tokens): {long_ms[0]:.3f} ms; decode at {LM_SLOTS} slots: "
        f"{float(np.median(full)):.3f} ms per step (median of {len(full)}; min {full[0]:.3f}, max {full[-1]:.3f}); "
        f"the short prefills {float(np.median([ms for S, ms, _, _ in prefills if S != long_len])):.3f} ms (median); "
        f"peak device memory {run['peak']:.2f} GiB serving, {peak_build:.2f} GiB while building (above the "
        f"{base / 2**30:.2f} GiB that earlier phases hold)")
    return long_ms[0], float(np.median(full))


def lm_near_tie(logits, want: int, got: int) -> float:
    """The reference-side margin between two greedy picks over the logit
    bound: a pick may part from the other only where this is <= 2."""
    return float(logits[want] - logits[got]) / (LM_LOGIT_RTOL * float(np.abs(logits).max()))


def lm_capture(S: int, Sk: int | None = None):
    """Wrap ``models.layers.attention_core`` to keep the first call's
    inputs at query length S (and key length Sk where given): layer 0's
    call of that prefill.  Returns the record, the unwrapped function and
    a function that unwraps."""
    from repro_torch.models import layers as L

    seen, core = {}, L.attention_core

    def capture(q, k, v, **kw):
        if q.shape[1] == S and (Sk is None or k.shape[1] == Sk) and not seen:
            seen.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=kw)
        return core(q, k, v, **kw)

    L.attention_core = capture
    return seen, core, lambda: setattr(L, "attention_core", core)


def sdpa_kw(qpos, kpos, causal: bool, window) -> dict:
    """The mask arguments of ``F.scaled_dot_product_attention`` for (B, S)
    position vectors that are the same in every batch row: ``is_causal``
    where both are ``arange`` and Sq = Sk, none where every key is live and
    the call is not causal, else the boolean mask of row 0's positions."""
    import torch

    p, kp = qpos[0], kpos[0]
    Sq, Sk = p.shape[0], kp.shape[0]
    ar = torch.arange(max(Sq, Sk), device=p.device, dtype=p.dtype)
    plain = bool(torch.equal(p, ar[:Sq])) and bool(torch.equal(kp, ar[:Sk].to(kp.dtype))) and window is None
    if plain and causal and Sq == Sk:
        return dict(is_causal=True)
    if plain and not causal:
        return {}
    mask = kp[None, :] >= 0
    if causal:
        mask = mask & (kp[None, :] <= p[:, None])
    if window is not None:
        mask = mask & (kp[None, :] > p[:, None] - window)
    return dict(attn_mask=mask)


def sdpa_ms(q, k, v, qp, kp, causal: bool, window):
    """One ``F.scaled_dot_product_attention`` call (``enable_gqa``) on the
    model-layout q, k, v of a captured call with its mask (``sdpa_kw``):
    its mean ms."""
    import torch.nn.functional as F

    kw = sdpa_kw(qp, kp, causal, window)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    return time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True, **kw), reps=5)


def lm_flash(tag, core, cap, dt: str, n_layers: int, prefill_ms: float | None, phase: str = "[lm]"):
    """The captured layer's attention through the kernel (outside any
    counted run) against the plain version one kv head at a time, the
    [attention] readings; its time, bound, share of the prefill and
    SDPA's time on the same call."""
    import torch

    from repro_torch.kernels import ref

    q, k, v, kw = cap["q"], cap["k"], cap["v"], cap["kw"]
    B, S, H, Dh = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    G = H // KV
    causal = kw.get("causal", True)
    got = core(q, k, v, **kw)
    qp = torch.broadcast_to(torch.as_tensor(kw["qpos"]).to(torch.int32), (B, S)).contiguous()
    kp = torch.broadcast_to(torch.as_tensor(kw["kpos"]).to(torch.int32), (B, Sk)).contiguous()
    elem = row = err = 0.0
    wants = []
    for g in range(KV):
        want = ref.gqa_flash_attention(q[:, :, g * G : (g + 1) * G].transpose(1, 2), k[:, :, g : g + 1].transpose(1, 2),
                                       v[:, :, g : g + 1].transpose(1, 2), qp, kp, causal, kw["window"]).float()
        wants.append(want)
        o = got[:, :, g * G : (g + 1) * G].transpose(1, 2).float()
        check(bool(torch.isfinite(o).all()), f"{tag}: non-finite attention")
        e, r = flash_reading(o, want, dt)
        elem, row, err = max(elem, e), max(row, r), max(err, float((o - want).abs().max()))
    check(elem <= 1 and row <= 1, f"{tag}: layer 0's attention outside tolerance, readings {elem:.3f} (elements), "
                                  f"{row:.3f} (rows)")

    def plain_all():
        for g in range(KV):
            ref.gqa_flash_attention(q[:, :, g * G : (g + 1) * G].transpose(1, 2), k[:, :, g : g + 1].transpose(1, 2),
                                    v[:, :, g : g + 1].transpose(1, 2), qp, kp, causal, kw["window"])

    ms = time_ms(lambda: core(q, k, v, **kw), reps=5)
    p_ms = time_ms(plain_all, reps=1, warm=0)
    lib = sdpa_ms(q, k, v, qp, kp, causal, kw["window"])
    live = _live_pairs(qp, kp, kw["window"], causal)
    b, by = bound_ms(4.0 * Dh * live * H, q.element_size() * 2 * (q.numel() + k.numel()),
                     PEAK_BF16_FLOPS if dt == "bf16" else PEAK_F32_FLOPS)
    share = "" if prefill_ms is None else (f", x {n_layers} layers = {ms * n_layers:.3f} ms, "
                                           f"{ms * n_layers / prefill_ms:.3f} of the prefill")
    say(f"{phase} {tag}: layer 0's attention (S = {S}, Sk = {Sk}, {H}/{KV} heads, Dh {Dh}, {dt}, "
        f"{'causal' if causal else 'non-causal'}) through the kernel against the plain version: max_abs_err "
        f"{err:.3e}, readings {elem:.3f} (elements), {row:.3f} (rows) of limit 1 (rtol/atol/row "
        f"{'1e-2/2e-3/1e-2' if dt == 'bf16' else '1e-4/2e-4/1e-3'}); kernel {ms:.4f} ms a layer{share}; bound "
        f"{b:.4f} ms ({by}); plain {p_ms:.4f} ms; SDPA (enable_gqa) {lib:.4f} ms on the same call")
    out = dict(ms=ms, bound_ms=b, max_abs_err=err, library_ms=lib, plain_ms=p_ms)
    if dt == "bf16":
        out.update(mma_v1(tag, phase, q, k, v, qp, kp, causal, kw["window"], got, ms, wants))
    return out


def mma_v1(tag, phase, q, k, v, qp, kp, causal: bool, window, got, ms: float, wants) -> dict:
    """The first tensor-core kernel (``flash_attention_mma_v1``, outside any
    counted run) on a model-layout call of the tensor-core route: its
    readings against the plain version's outputs ``wants`` (one a kv head,
    f32), the ``wgmma`` kernel's output ``got`` against it under the same
    limits, the largest |new - v1| and its time beside the new kernel's
    ``ms``."""
    import torch

    from repro_torch.kernels import flash_attention as k_fa

    heads = [t.transpose(1, 2) for t in (q, k, v)]
    old = k_fa.flash_attention_mma_v1(*heads, qp, kp, causal=causal, window=window).transpose(1, 2)
    G = q.shape[2] // k.shape[2]
    elem = row = err = 0.0
    for g, want in enumerate(wants):
        o = old[:, :, g * G : (g + 1) * G].transpose(1, 2).float()
        e, r = flash_reading(o, want, "bf16")
        elem, row, err = max(elem, e), max(row, r), max(err, float((o - want).abs().max()))
    check(elem <= 1 and row <= 1, f"{tag}: the first tensor-core kernel outside tolerance, readings {elem:.3f} "
                                  f"(elements), {row:.3f} (rows)")
    e_new, r_new = flash_reading(got.float(), old.float(), "bf16")
    diff = float((got.float() - old.float()).abs().max())
    check(e_new <= 1 and r_new <= 1, f"{tag}: the wgmma kernel outside tolerance of the first tensor-core kernel, "
                                     f"readings {e_new:.3f} (elements), {r_new:.3f} (rows)")
    v1_ms = time_ms(lambda: k_fa.flash_attention_mma_v1(*heads, qp, kp, causal=causal, window=window), reps=5)
    direct = time_ms(lambda: k_fa.flash_attention(*heads, qp, kp, causal=causal, window=window), reps=5)
    say(f"{phase} {tag}: the first tensor-core kernel (mma.sync, flash_attention_mma.cu) on the same call: readings "
        f"{elem:.3f} (elements), {row:.3f} (rows) against the plain version; the wgmma kernel against it "
        f"{e_new:.3f} / {r_new:.3f}, max |new - v1| {diff:.3e}; wgmma {ms:.4f} ms through the call above, "
        f"{direct:.4f} ms through the wrapper as v1 is called, v1 {v1_ms:.4f} ms ({v1_ms / direct:.2f}x)")
    del old
    torch.cuda.empty_cache()
    return dict(v1_ms=v1_ms, v1_max_abs_diff=diff, v1_max_abs_err=err, wrapper_ms=direct)


def lm_profile(tag, fn, wall_ms: float, phase: str = "[lm]", part: str = "flash", extra: tuple = ()):
    """One call of ``fn`` under torch.profiler: the device's busy time (its
    kernels', copies' and fills' times; one stream), the launches, the
    share of ``part`` and the idle share against ``wall_ms``, the untraced
    call's wall.  ``part`` is "flash" (the kernels of that name) or the
    name of a ``record_function`` range that ``fn`` opens (the device time
    of the kernels launched inside it; the range's own device-side
    annotation is not a launch); ``extra`` names more such ranges, each
    with its share.  Returns {launches, busy_ms, part_ms, extra_ms (by
    range)} or None when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    ranges = (part,) + tuple(extra)
    events = [e for e in averages if e.device_type == DeviceType.CUDA and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy <= 0:
        say(f"{phase} {tag} under torch.profiler: no device time in the trace (traced wall {traced:.2f} ms); idle "
            f"share not measured")
        return None

    def range_ms(name):
        return sum(e.device_time_total for e in averages if e.key == name and e.device_type == DeviceType.CPU) / 1e3

    if part == "flash":
        part_ms = sum(e.self_device_time_total for e in events if "flash" in e.key) / 1e3
    else:
        part_ms = range_ms(part)
    extra_ms = {name: range_ms(name) for name in extra}
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    say(f"{phase} {tag} under torch.profiler: {launches} launches, device busy {busy:.3f} ms (traced wall "
        f"{traced:.2f} ms), {part} {part_ms:.3f} ms of it"
        + "".join(f", {name} {ms:.3f} ms" for name, ms in extra_ms.items())
        + f"; against the untraced wall {wall_ms:.3f} ms: busy share {busy / wall_ms:.3f}, idle share "
        f"{1 - busy / wall_ms:.3f}, {part} {part_ms / wall_ms:.3f}"
        + "".join(f", {name} {ms / wall_ms:.3f}" for name, ms in extra_ms.items())
        + "; top device time (ms): "
        + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} x{e.count}" for e in top))
    return dict(launches=launches, busy_ms=busy, part_ms=part_ms, extra_ms=extra_ms)


def lm_cpu_replay(phase: str, dev, smoke, seed: int,
                  paths: str = "on the CUDA-core kernel on the card and the plain version on the CPU",
                  long_len: int = LM_LONG):
    """The ragged case at SMOKE size in f32 (its long prompt ``long_len``
    tokens) through ServeEngine on the card and on the CPU (plain
    versions): the sampler's calls in the same order, logits within
    LM_LOGIT_RTOL of the largest, tokens identical (or parting only at a
    near-tie, after which nothing is compared)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine

    values = M.init_params(smoke, torch.Generator().manual_seed(seed), device="cpu")
    prompts = lm_prompts(smoke, np.random.default_rng(seed + 1), long_len)
    runs = []
    for where in (dev, torch.device("cpu")):
        eng = ServeEngine(smoke, values, slots=LM_SLOTS, cache_len=LM_CACHE_LEN, seed=SEED, device=where)
        t0 = time.perf_counter()
        runs.append(lm_serve(eng, prompts, LM_NEW))
        say(f"{phase} CPU replay: {smoke.name} SMOKE in f32 on {where.type}: {time.perf_counter() - t0:.1f} s")
    (card_reqs, card_log), (cpu_reqs, cpu_log) = runs
    worst, parted = 0.0, None
    for n, ((rid, want_l, want), (rid_c, got_l, got)) in enumerate(zip(cpu_log, card_log)):
        check(rid == rid_c, f"{phase} CPU replay: sampler call {n} serves request {rid_c}, the CPU {rid}")
        worst = max(worst, float(np.abs(got_l - want_l).max()) / float(np.abs(want_l).max()))
        check(worst <= LM_LOGIT_RTOL, f"{phase} CPU replay: call {n}'s logits {worst:.3e} apart (relative to the "
                                      f"largest)")
        if want != got:
            parted = (n, lm_near_tie(want_l, want, got))
            check(parted[1] <= 2, f"{phase} CPU replay: request {rid} parts at call {n} by {parted[1]:.2f} logit "
                                  f"bounds")
            break
    if parted is None:
        check([r.generated for r in card_reqs] == [r.generated for r in cpu_reqs],
              f"{phase} CPU replay: tokens differ")
    say(f"{phase} CPU replay: {len(cpu_reqs)} requests (the ragged case: one prompt of {long_len}, {paths}): "
        + ("tokens identical" if parted is None else f"parting at sampler call {parted[0]}, a near-tie "
                                                       f"({parted[1]:.2f} of the bound's 2)")
        + f"; logits at most {worst:.3e} apart relative to the largest (limit {LM_LOGIT_RTOL:g}) over "
        f"{len(card_log)} sampler calls")


def phase_lm(dev, card):
    """LM serving at published widths: qwen2-1.5b through ServeEngine, the
    long prefill on the tensor-core flash kernel; the f32 route against a
    teacher-forced prefill; a SMOKE replay against the CPU.  Returns the
    flash launches of the counted runs and the layer-0 kernel numbers."""
    import torch

    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine

    t_phase = time.perf_counter()
    cfg, cfg32, smoke = lm_configs()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    values = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 3), device=dev)
    n_params = M.count_params(values)
    eng = ServeEngine(cfg, values, slots=LM_SLOTS, cache_len=LM_CACHE_LEN, seed=SEED, device=dev)
    del values  # the engine serves from its bf16 compute copy
    torch.cuda.synchronize()
    peak_build = (torch.cuda.max_memory_allocated() - base) / 2**30
    say(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params:,} parameters (the reference's "
        f"count_params over abstract_params: {LM_PARAMS:,}); built from a seeded torch.Generator on the card, "
        f"served from the bf16 compute copy; peak {peak_build:.2f} GiB with the f32 master")
    check(n_params == LM_PARAMS, f"{cfg.name}: {n_params} parameters, the reference counts {LM_PARAMS}")
    check(all(t.dtype == torch.bfloat16 for t in (eng.params["embed"]["table"], eng.params["blocks"]["mlp"]["up"]["w"])),
          "the engine does not hold the bf16 compute copy")

    prompts = lm_prompts(cfg, np.random.default_rng(SEED + 4))
    cap, core, uncapture = lm_capture(LM_LONG)
    try:
        run = lm_serve_timed(eng, prompts, base)
    finally:
        uncapture()
    launches = run["launches"]
    long_ms, decode_ms = lm_serve_report("[lm]", eng, run, LM_LONG, cfg.n_layers, peak_build, base)
    numbers = {"flash_attention_mma": lm_flash("bf16 route", core, cap, "bf16", cfg.n_layers, long_ms)}
    long_toks = torch.as_tensor(prompts[LM_LONG_AT], dtype=torch.int64, device=dev)[None]
    lm_profile(f"the {LM_LONG}-token prefill", lambda: eng.model.prefill(eng.params, long_toks), long_ms)
    last = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    lm_profile(f"a decode step at {LM_SLOTS} slots",
               lambda: eng.model.decode(eng.params, eng.caches, last, LM_LONG + LM_NEW), decode_ms)
    del eng, cap, run
    torch.cuda.empty_cache()

    # the f32 route: equal-length prompts (one position for every row) against a teacher-forced prefill
    values = M.init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED + 5), device=dev)
    eng = ServeEngine(cfg32, values, slots=LM_F32_BATCH, cache_len=LM_F32_PROMPT + LM_F32_NEW + 8, seed=SEED,
                      device=dev)
    del values
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg32.vocab_size, size=LM_F32_PROMPT).astype(np.int32) for _ in range(LM_F32_BATCH)]
    cap, core, uncapture = lm_capture(LM_F32_PROMPT)
    k_fa.launches = k_fa.launches_mma = k_fa.launches_simt = 0
    try:
        reqs, _ = lm_serve(eng, prompts, LM_F32_NEW)
    finally:
        uncapture()
    f32_launches = {"flash_attention_mma": k_fa.launches_mma, "flash_attention": k_fa.launches_simt}
    check(f32_launches == {"flash_attention_mma": 0, "flash_attention": cfg32.n_layers * LM_F32_BATCH},
          f"f32 route: flash launches {f32_launches}, want the CUDA-core kernel once per layer and prefill")
    launches["flash_attention"] = f32_launches["flash_attention"]
    parted, margins = 0, []
    with torch.no_grad():
        for r in reqs:
            seq = list(r.prompt)
            for i, got in enumerate(r.generated):
                toks = torch.as_tensor(np.asarray(seq), dtype=torch.int64, device=dev)[None]
                logits = eng.model.prefill(eng.params, toks)[0][0, -1].float().cpu().numpy()[: cfg32.vocab_size]
                want = int(np.argmax(logits))
                if want != got:
                    margins.append(lm_near_tie(logits, want, got))
                    check(margins[-1] <= 2, f"f32 route: request {r.rid} token {i} is {got}, the teacher-forced "
                                            f"prefill gives {want} by a margin of {margins[-1]:.2f} logit bounds")
                    parted += 1
                    break
                seq.append(want)
    say(f"[lm] f32 route: {cfg32.name} at full width with {cfg32.n_layers} layers in f32, {LM_F32_BATCH} prompts of "
        f"{LM_F32_PROMPT} tokens (one position for every row), {LM_F32_NEW} greedy tokens: flash launches "
        f"{json.dumps(f32_launches)}; the engine's tokens against a teacher-forced full prefill: "
        f"{len(reqs) - parted} of {len(reqs)} requests identical"
        + (f", {parted} parting at a near-tie (margins {margins} of the logit bound)" if parted else ""))
    numbers["flash_attention"] = lm_flash("f32 route", core, cap, "f32", cfg32.n_layers, None)
    del eng, cap, reqs
    torch.cuda.empty_cache()

    lm_cpu_replay("[lm]", dev, smoke, SEED + 7)
    say(f"[lm] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, numbers


def lm_build(cfg, dev, seed: int):
    """``models.init_compute_params`` on the card: the bf16 compute copy
    drawn leaf by leaf.  Returns the memory earlier phases hold, the
    params and the build's peak (GiB above that)."""
    import torch

    from repro_torch.models import model as M

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = M.init_compute_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    return base, params, (torch.cuda.max_memory_allocated() - base) / 2**30


def lm_widths(cfg) -> str:
    return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
            f"vocab {cfg.vocab_size}")


def timed_prefill(model, params, *args):
    """One synchronised prefill: (last logits, ms)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.prefill(params, *args)
    torch.cuda.synchronize()
    return logits, (time.perf_counter() - t0) * 1e3


def phase_moe(dev, card):
    """LM serving for the MoE family at published widths: qwen2-moe-a2.7b
    through ServeEngine as [lm] serves (the long prefill on the tensor-core
    kernel, MHA), its long prefill repeated bit for bit with the capacity's
    drops per layer; dbrx-132b's widths at 2 layers (GQA, a group of 6);
    a SMOKE replay against the CPU.  Returns the flash launches of the
    counted runs and the layer-0 kernel numbers."""
    import torch

    from repro_torch import configs as C
    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serving import ServeEngine

    t_phase = time.perf_counter()
    cfg = C.get(MOE_ARCH)
    base, params, peak_build = lm_build(cfg, dev, SEED + 10)
    n_params = M.count_params(params)
    say(f"[moe] {cfg.name}: {lm_widths(cfg)}, {cfg.n_experts} routed experts top-{cfg.n_experts_per_tok} of width "
        f"{cfg.moe_d_ff}, {cfg.n_shared_experts} shared fused to {cfg.n_shared_experts * cfg.moe_d_ff}; "
        f"{n_params:,} parameters (the reference's count_params over abstract_params: {MOE_PARAMS:,}); the bf16 "
        f"compute copy drawn leaf by leaf from a seeded torch.Generator on the card: peak {peak_build:.2f} GiB")
    check(n_params == MOE_PARAMS, f"{cfg.name}: {n_params} parameters, the reference counts {MOE_PARAMS}")
    moe = params["blocks"]["moe"]
    check(all(moe[k].dtype == torch.bfloat16 for k in ("gate", "up", "down")), "the experts are not in bf16")
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, cache_len=LM_CACHE_LEN, seed=SEED, device=dev)
    check(eng.params["blocks"]["moe"]["gate"] is moe["gate"], "the engine copied a tree already in bf16")
    del params, moe
    prompts = lm_prompts(cfg, np.random.default_rng(SEED + 11))
    cap, core, uncapture = lm_capture(LM_LONG)
    try:
        run = lm_serve_timed(eng, prompts, base)
    finally:
        uncapture()
    launches = {name: {"moe": n} for name, n in run["launches"].items()}
    long_ms, decode_ms = lm_serve_report("[moe]", eng, run, LM_LONG, cfg.n_layers, peak_build, base)
    numbers = {"moe": lm_flash("MHA (a group of 1)", core, cap, "bf16", cfg.n_layers, long_ms, "[moe]")}
    del cap

    # the long prefill twice more, directly: the same bits (no atomics in the combine); the second also reads the
    # router's choices per layer
    long_toks = torch.as_tensor(prompts[LM_LONG_AT], dtype=torch.int64, device=dev)[None]
    first, ms1 = timed_prefill(eng.model, eng.params, long_toks)
    stats, apply = [], MOE.moe_apply

    def observed(p, x, c):
        _, cap_, top_e, _ = MOE.route(p, x, c)
        stats.append((cap_, torch.stack([torch.bincount(e.reshape(-1), minlength=c.n_experts) for e in top_e]).cpu()))
        return apply(p, x, c)

    MOE.moe_apply = observed
    try:
        second, ms2 = timed_prefill(eng.model, eng.params, long_toks)
    finally:
        MOE.moe_apply = apply
    check(bool(torch.isfinite(first).all()), "[moe] non-finite logits")
    check(torch.equal(first, second), "[moe] the long prefill's logits differ between two runs")
    check(len(stats) == cfg.n_layers and all(c == MOE_CAPACITY for c, _ in stats),
          f"[moe] capacities {[c for c, _ in stats]}, want {MOE_CAPACITY} in each of {cfg.n_layers} layers")
    pairs = LM_LONG * cfg.n_experts_per_tok
    dropped = [int((n - c).clamp(min=0).sum()) for c, n in stats]
    say(f"[moe] the {LM_LONG}-token prefill twice more, directly: {ms1:.3f} and {ms2:.3f} ms, logits bit for bit "
        f"equal; C = {MOE_CAPACITY} slots per expert ({cfg.n_experts} x {MOE_CAPACITY} = "
        f"{cfg.n_experts * MOE_CAPACITY} for {pairs} (token, choice) pairs); dropped pairs per layer {dropped} "
        f"({sum(dropped)} of {pairs * cfg.n_layers}, {sum(dropped) / (pairs * cfg.n_layers):.4f}); per layer the most "
        f"and least loaded experts (expert: pairs): "
        + "; ".join(f"L{i} {int(n[0].argmax())}:{int(n[0].max())} {int(n[0].argmin())}:{int(n[0].min())}"
                    for i, (_, n) in enumerate(stats)))
    del first, second
    lm_profile(f"the {LM_LONG}-token prefill", lambda: eng.model.prefill(eng.params, long_toks), long_ms, "[moe]")
    last = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    lm_profile(f"a decode step at {LM_SLOTS} slots",
               lambda: eng.model.decode(eng.params, eng.caches, last, LM_LONG + LM_NEW), decode_ms, "[moe]")
    del eng, run
    torch.cuda.empty_cache()

    # dbrx-132b at its published widths, DBRX_LAYERS layers
    cfg = C.get(DBRX_ARCH).replace(n_layers=DBRX_LAYERS)
    full = M.count_params(M.init_params(C.get(DBRX_ARCH), device="meta"))
    base, params, peak_build = lm_build(cfg, dev, SEED + 12)
    model = M.build_model(cfg)
    toks = torch.as_tensor(np.random.default_rng(SEED + 13).integers(0, cfg.vocab_size, size=DBRX_LONG),
                           dtype=torch.int64, device=dev)[None]
    cap, core, uncapture = lm_capture(DBRX_LONG)
    k_fa.launches = k_fa.launches_mma = k_fa.launches_simt = 0
    try:
        first, ms1 = timed_prefill(model, params, toks)
    finally:
        uncapture()
    d_launches = {"flash_attention_mma": k_fa.launches_mma, "flash_attention": k_fa.launches_simt}
    second, ms2 = timed_prefill(model, params, toks)
    say(f"[moe] {cfg.name}: {lm_widths(cfg)} (cut from 40: {full:,} parameters, {full * 2 / 1e9:.1f} GB in bf16), "
        f"{cfg.n_experts} experts top-{cfg.n_experts_per_tok} of width {cfg.d_ff}, C = "
        f"{MOE.capacity(DBRX_LONG, cfg)}; {M.count_params(params):,} parameters built leaf by leaf, peak "
        f"{peak_build:.2f} GiB; one {DBRX_LONG}-token prefill {ms1:.3f} ms, again {ms2:.3f} ms, logits bit for bit "
        f"equal: {torch.equal(first, second)}; flash launches {json.dumps(d_launches)}")
    check(d_launches == {"flash_attention_mma": DBRX_LAYERS, "flash_attention": 0},
          f"[moe] {cfg.name}: flash launches {d_launches}, want the tensor-core kernel once per layer")
    check(bool(torch.isfinite(first).all()) and torch.equal(first, second),
          f"[moe] {cfg.name}: the prefill's logits are not finite or differ between two runs")
    for name, n in d_launches.items():
        launches[name]["dbrx"] = n
    numbers["dbrx"] = lm_flash("dbrx-132b GQA (a group of 6)", core, cap, "bf16", DBRX_LAYERS, ms2, "[moe]")
    del params, model, cap, first, second
    torch.cuda.empty_cache()

    lm_cpu_replay("[moe]", dev, C.get_smoke(MOE_ARCH).replace(compute_dtype=torch.float32), SEED + 14)
    say(f"[moe] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, numbers


def phase_vlm(dev, card):
    """LM serving for the vision family at published widths:
    llama-3.2-vision-11b through ServeEngine as [lm] serves, with the
    engine's zero media; one 12,288-token prefill with seeded media and
    open gates, every self- and cross-attention on the tensor-core kernel
    (the cross-attention non-causal over 1601 keys), repeated bit for bit;
    layer 0's cross-attention against the plain version; a SMOKE replay
    against the CPU.  Returns the flash launches of the counted runs and
    the layer-0 kernel numbers."""
    import torch

    from repro_torch import configs as C
    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine

    t_phase = time.perf_counter()
    cfg = C.get(VLM_ARCH)
    base, params, peak_build = lm_build(cfg, dev, SEED + 20)
    n_params = M.count_params(params)
    n_cross = cfg.n_layers // cfg.cross_attn_period
    say(f"[vlm] {cfg.name}: {lm_widths(cfg)} as {n_cross} groups of {cfg.cross_attn_period - 1} self blocks and 1 "
        f"cross block, d_ff {cfg.d_ff}, {cfg.n_media_tokens} media tokens; {n_params:,} parameters (the reference's "
        f"count_params over abstract_params: {VLM_PARAMS:,}); the bf16 compute copy drawn leaf by leaf: peak "
        f"{peak_build:.2f} GiB")
    check(n_params == VLM_PARAMS, f"{cfg.name}: {n_params} parameters, the reference counts {VLM_PARAMS}")
    gates = params["cross_blocks"]["xattn_gate"]
    check(gates.dtype == torch.float32 and bool((gates == 0).all()), "[vlm] the gates are not f32 zeros")
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, cache_len=LM_CACHE_LEN, seed=SEED, device=dev)
    del params
    say("[vlm] the engine's media are bf16 zeros (the reference engine's) and every cross-attention gate starts at 0 "
        "(tanh(0) = 0): in this serve the cross branch adds exactly 0")
    prompts = lm_prompts(cfg, np.random.default_rng(SEED + 21))
    run = lm_serve_timed(eng, prompts, base)
    launches = {name: {"vlm": n} for name, n in run["launches"].items()}
    long_ms, decode_ms = lm_serve_report("[vlm]", eng, run, LM_LONG, cfg.n_layers, peak_build, base)
    long_toks = torch.as_tensor(prompts[LM_LONG_AT], dtype=torch.int64, device=dev)[None]
    lm_profile(f"the {LM_LONG}-token prefill", lambda: eng._prefill_one(eng.params, long_toks), long_ms, "[vlm]")
    last = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    lm_profile(f"a decode step at {LM_SLOTS} slots",
               lambda: eng.model.decode(eng.params, eng.caches, last, LM_LONG + LM_NEW, eng._media(LM_SLOTS)),
               decode_ms, "[vlm]")
    del run

    # the long prompt with media and open gates: every attention on the kernel
    model, params = eng.model, eng.params
    gated = dict(params, cross_blocks=dict(params["cross_blocks"], xattn_gate=torch.full_like(gates, VLM_GATE)))
    toks = torch.as_tensor(np.random.default_rng(SEED + 22).integers(0, cfg.vocab_size, size=VLM_LONG),
                           dtype=torch.int64, device=dev)[None]
    media = torch.randn((1, cfg.n_media_tokens, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(
        SEED + 23), device=dev).to(torch.bfloat16)
    calls, fa = [], k_fa.flash_attention

    def counted(*args, causal=True, **kw):
        calls.append(bool(causal))
        return fa(*args, causal=causal, **kw)

    cap, core, uncapture = lm_capture(VLM_LONG, cfg.n_media_tokens)
    k_fa.flash_attention = counted
    k_fa.launches = k_fa.launches_mma = k_fa.launches_simt = 0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the weights, the serve's cache and the media
    try:
        first, ms1 = timed_prefill(model, gated, toks, media)
    finally:
        k_fa.flash_attention = fa
        uncapture()
    l_launches = {"flash_attention_mma": k_fa.launches_mma, "flash_attention": k_fa.launches_simt}
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    second, ms2 = timed_prefill(model, gated, toks, media)
    shut, _ = timed_prefill(model, params, toks, media)
    zero, _ = timed_prefill(model, params, toks)
    moved = float((first.float() - shut.float()).abs().max())
    say(f"[vlm] one {VLM_LONG}-token prefill with seeded media and every gate at {VLM_GATE}: {ms1:.3f} ms, again "
        f"{ms2:.3f} ms, logits bit for bit equal: {torch.equal(first, second)}; flash launches "
        f"{json.dumps(l_launches)}: {sum(calls)} causal, {len(calls) - sum(calls)} non-causal; peak {peak:.2f} GiB above "
        f"the {held / 2**30:.2f} GiB held (weights, the serve's cache, the media); "
        f"the cross branch moves the logits by up to {moved:.4f} (against the gates at 0); at the gates' 0 the "
        f"prefill with these media is bit for bit the one with zero media: {torch.equal(shut, zero)}")
    check(l_launches == {"flash_attention_mma": cfg.n_layers + n_cross, "flash_attention": 0},
          f"[vlm] flash launches {l_launches}, want the tensor-core kernel {cfg.n_layers} + {n_cross} times")
    check(len(calls) - sum(calls) == n_cross and sum(calls) == cfg.n_layers,
          f"[vlm] {sum(calls)} causal and {len(calls) - sum(calls)} non-causal flash calls")
    check(bool(torch.isfinite(first).all()) and torch.equal(first, second),
          "[vlm] the long prefill's logits are not finite or differ between two runs")
    check(moved > 0, "[vlm] the cross branch did not move the logits")
    check(torch.equal(shut, zero), "[vlm] with the gates at 0 the media moved the logits")
    for name, n in l_launches.items():
        launches[name]["vlm_long"] = n
    numbers = {"vlm": lm_flash("cross-attention", core, cap, "bf16", n_cross, ms2, "[vlm]")}
    del eng, model, params, gated, cap, first, second, shut, zero
    torch.cuda.empty_cache()

    lm_cpu_replay("[vlm]", dev, C.get_smoke(VLM_ARCH).replace(compute_dtype=torch.float32), SEED + 24)
    say(f"[vlm] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, numbers


def kernel_counts(reset: bool = False) -> dict:
    """Every hand-written kernel's launch counter, by the kernels line's
    names (forward and backward flash counted apart); with ``reset``,
    every counter of every kernel module set to 0 first."""
    from repro_torch.kernels import assign as k_assign
    from repro_torch.kernels import bubble_cd as k_bcd
    from repro_torch.kernels import dynamic as k_dyn
    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.kernels import flat_scatter as k_flat
    from repro_torch.kernels import grid as k_grid
    from repro_torch.kernels import hierarchy as k_h
    from repro_torch.kernels import knn as k_knn
    from repro_torch.kernels import mutual_reach as k_mr
    from repro_torch.kernels import pairwise as k_pw

    if reset:
        for mod in (k_assign, k_bcd, k_fa, k_flat, k_h, k_knn, k_mr, k_pw):
            for name in [n for n in vars(mod) if n.startswith("launches")]:
                setattr(mod, name, 0)
        for counts in (k_grid.launches, k_dyn.launches):
            counts.update(dict.fromkeys(counts, 0))
    return dict(assign=k_assign.launches, bubble_cd=k_bcd.launches, mutual_reach=k_mr.launches, knn=k_knn.launches,
                pairwise=k_pw.launches, flash_attention=k_fa.launches, flash_attention_bwd=k_fa.launches_bwd,
                flat_scatter=k_flat.launches, single_linkage=k_h.launches_single_linkage,
                condense=k_h.launches_condense, extract=k_h.launches_extract, eom=k_h.launches_eom,
                **k_grid.launches, **k_dyn.launches)


def fn_capture(module, name: str, T: int):
    """Wrap ``module.name`` (a scan whose first argument is (B, T, ...)) to
    keep the first call's inputs at sequence length T: layer 0's call of
    that prefill.  Returns the record, the unwrapped function and a
    function that unwraps."""
    seen, fn = {}, getattr(module, name)

    def capture(*args):
        if args[0].shape[1] == T and not seen:
            seen["args"] = tuple(t.clone() for t in args)
        return fn(*args)

    setattr(module, name, capture)
    return seen, fn, lambda: setattr(module, name, fn)


def fn_annotated(module, name: str, label: str):
    """A context in which every ``module.name`` call runs inside a
    ``record_function(label)`` range (for lm_profile's shares)."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        fn = getattr(module, name)

        def annotated(*args):
            with torch.profiler.record_function(label):
                return fn(*args)

        setattr(module, name, annotated)
        try:
            yield
        finally:
            setattr(module, name, fn)

    return ctx()


def wkv_bound(r, S0):
    """The WKV scan's bound at this call's shapes: the bytes of r, k, v
    (their dtype), the f32 log decays, u, S0 and S_T read or written once
    and o written once; the products' FLOPs on the strictly lower
    triangle (r̃·k̃ and A·v), the chunk states' increments and the carried
    state's term (4·dh per element), the carry's mul and add, the bonus;
    at the tensor cores' bf16 peak for bf16, the f32 peak otherwise."""
    import torch

    B, T, H, dh = r.shape
    C = min(64, T)
    n = T // C
    el = B * T * H * dh
    nbytes = el * (4 * r.element_size() + 4) + 2 * S0.numel() * 4 + H * dh * 4
    flops = 2.0 * B * n * H * dh * C * (C - 1) + 4.0 * el * dh + 2.0 * B * n * H * dh * dh + 3.0 * el
    return bound_ms(flops, nbytes, PEAK_BF16_FLOPS if r.dtype == torch.bfloat16 else PEAK_F32_FLOPS)


def serial_wkv64(r, k, v, lw, u, S0):
    """The recurrence itself in f64 on the card, token by token:
    o_t = r_t·(S + diag(u) k_t⊗v_t), S = diag(w_t) S + k_t⊗v_t."""
    import torch

    r, k, v, lw, u, S = (t.double() for t in (r, k, v, lw, u, S0))
    w, o = lw.exp(), torch.empty_like(r)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        o[:, t] = (r[:, t, :, :, None] * (S + u[None, :, :, None] * kv)).sum(2)
        S = w[:, t, :, :, None] * S + kv
    return o, S


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def lm_teacher_forced(phase: str, eng, reqs, dev):
    """Each request's greedy tokens against a teacher-forced prefill of its
    prompt and the tokens before (a part only at a near-tie, after which
    the request is not compared).  Returns (requests parted, their margins
    in logit bounds, the longest prefix)."""
    import torch

    parted, margins, longest = 0, [], 0
    vocab = eng.cfg.vocab_size
    with torch.no_grad():
        for r in reqs:
            seq = list(r.prompt)
            for i, got in enumerate(r.generated):
                longest = max(longest, len(seq))
                toks = torch.as_tensor(np.asarray(seq), dtype=torch.int64, device=dev)[None]
                logits = eng.model.prefill(eng.params, toks)[0][0, -1].float().cpu().numpy()[:vocab]
                want = int(np.argmax(logits))
                if want != got:
                    margins.append(lm_near_tie(logits, want, got))
                    check(margins[-1] <= 2, f"{phase} f32: request {r.rid} token {i} is {got}, the teacher-forced "
                                            f"prefill gives {want} by a margin of {margins[-1]:.2f} logit bounds")
                    parted += 1
                    break
                seq.append(want)
    check(longest <= 64, f"{phase} a teacher-forced prefix of {longest} tokens (the chunk rule: at most 64)")
    return parted, margins, longest


def remat_readings(phase: str, cut, seed: int, dev, micro_rtol: float = SSM_MICRO_RTOL):
    """``cut`` (f32) at SSM_CUT: remat "none" and "dots" and
    microbatches=2 against remat "full" and 1 microbatch, the loss and
    every gradient leaf, under tests/test_torch_train.py's bounds (the
    microbatches' leaves within ``micro_rtol``)."""
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    params = M.init_params(cut, torch.Generator(device=dev).manual_seed(seed), device=dev)
    pipe = TokenPipeline(cut.vocab_size, SSM_CUT[0], SSM_CUT[1], seed=seed + 1)
    tb = {k: torch.as_tensor(v).to(dev) for k, v in pipe.batch_at(0).items()}
    pipe.close()
    runs = {}
    for remat, mb in (("full", 1), ("none", 1), ("dots", 1), ("full", 2)):
        loss, grads = M.make_value_and_grad(cut.replace(remat=remat), microbatches=mb)(params, tb)
        runs[(remat, mb)] = (float(loss), tree_leaves(grads))
    ref_loss, ref_g = runs[("full", 1)]
    readings = []
    for (remat, mb), (loss, g) in runs.items():
        if (remat, mb) == ("full", 1):
            continue
        worst = max(float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(g, ref_g))
        bitwise = loss == ref_loss and all(torch.equal(a, b) for a, b in zip(g, ref_g))
        readings.append((remat, mb, abs(loss - ref_loss) / abs(ref_loss), worst, bitwise))
    say(f"{phase} cut depth: {cut.name} at full width, {cut.n_layers} layers in f32, (B, S) = {SSM_CUT}: against "
        f"remat 'full' and 1 microbatch (loss {ref_loss:.6f}): "
        + "; ".join(f"remat {r!r} x{mb}: loss {dl:.2e} relative, leaves at most {w:.2e} in relative norm, bit for bit "
                    f"{bw}" for r, mb, dl, w, bw in readings)
        + f" (limits: remat losses equal, leaves {SSM_REMAT_RTOL:g}; microbatches 1e-6 and {micro_rtol:g})")
    for remat, mb, dl, w, _ in readings:
        if mb == 1:
            check(dl == 0 and w <= SSM_REMAT_RTOL, f"{phase} remat {remat!r} moves the loss or the gradients")
        else:
            check(dl <= 1e-6 and w <= micro_rtol, f"{phase} microbatches=2 moves the loss or the gradients")
    del params, runs, ref_g
    gc.collect()
    torch.cuda.empty_cache()


def phase_ssm(dev, card):
    """LM serving and training for the ssm family at published widths:
    rwkv6-1.6b through ServeEngine as [lm] serves, 32 tokens a request,
    its state O(1) in the sequence; profiles of the long prefill and a
    decode step with the WKV scan's share; 4 layers in f32 against a
    teacher-forced prefill and layer 0's WKV at T = 6144 against the
    serial f64 recurrence; a full-width train step at (4, 2048), the
    remat modes and microbatches at cut depth; the SMOKE replay against
    the CPU.  No hand-written kernel lies on this path: every kernel's
    launches over the phase must stay 0.  Returns the WKV scan's numbers."""
    import torch

    from repro_torch import configs as C
    from repro_torch.data import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.models import rwkv as R
    from repro_torch.serving import ServeEngine
    from repro_torch.train import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    kernel_counts(reset=True)  # every counter 0 for the phase (later phases reset their own before counting)
    cfg = C.get(SSM_ARCH)
    base, params, peak_build = lm_build(cfg, dev, SEED + 40)
    n_params, fpt = M.count_params(params), M.model_flops_per_token(cfg)
    say(f"[ssm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.rwkv_heads} heads of "
        f"{cfg.rwkv_head_size}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params:,} parameters and "
        f"model_flops_per_token {fpt:,.0f} (the reference's: {SSM_PARAMS:,} and {SSM_FLOPS:,}); the bf16 compute copy "
        f"drawn leaf by leaf from a seeded torch.Generator on the card: peak {peak_build:.2f} GiB; on {card}")
    check(n_params == SSM_PARAMS and fpt == SSM_FLOPS, f"[ssm] {n_params} parameters, {fpt} FLOPs a token")
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, cache_len=LM_CACHE_LEN, seed=SEED, device=dev)
    tm = eng.params["blocks"]["tm"]
    check(all(t.dtype == torch.bfloat16 for t in (tm["wr"]["w"], eng.params["blocks"]["cm"]["wk"]["w"],
                                                  eng.params["embed"]["table"], eng.params["unembed"]["table"]))
          and all(tm[k].dtype == torch.float32 for k in SSM_F32_LEAVES)
          and all(eng.params["blocks"]["cm"][k].dtype == torch.float32 for k in ("mu_k", "mu_r")),
          "[ssm] the engine does not hold the bf16 compute copy with RWKV's f32 leaves")
    check(eng.params["blocks"]["tm"]["wr"]["w"] is params["blocks"]["tm"]["wr"]["w"],
          "[ssm] the engine copied a tree already in the compute dtype")
    del params
    per_slot = {n: tree_bytes(eng.model.init_cache(1, n, device="meta")) for n in (8, 9000)}
    check(per_slot[8] == per_slot[9000] and tree_bytes(eng.caches) == LM_SLOTS * per_slot[8],
          f"[ssm] state bytes per slot {per_slot}, the engine's {tree_bytes(eng.caches)}")

    prompts = lm_prompts(cfg, np.random.default_rng(SEED + 41))
    cap, wkv, uncapture = fn_capture(R, "_wkv_chunked", LM_LONG)
    try:
        run = lm_serve_timed(eng, prompts, base, SSM_NEW)
    finally:
        uncapture()
    check(all(n == 0 for n in run["launches"].values()), f"[ssm] flash launches {run['launches']}")
    long_ms = [ms for S_, ms, _, _ in run["prefills"] if S_ == LM_LONG][0]
    short_ms = float(np.median([ms for S_, ms, _, _ in run["prefills"] if S_ != LM_LONG]))
    full = sorted(ms for active, ms in run["steps"] if active == LM_SLOTS)
    check(bool(full), "[ssm] no decode step ran with every slot busy")
    decode_ms = float(np.median(full))
    say(f"[ssm] ragged serve: {len(run['reqs'])} requests ({LM_SHORT} of 4-16 tokens, one of {LM_LONG} = "
        f"{LM_LONG // 64} chunks) on {LM_SLOTS} slots, {SSM_NEW} greedy tokens each: all finished; "
        f"{eng.tokens_out} tokens in {eng.steps} steps, {run['wall'] * 1e3:.1f} ms, "
        f"{eng.tokens_out / run['wall']:.1f} tokens/s; long prefill {long_ms:.3f} ms "
        f"({LM_LONG / long_ms * 1e3:.0f} tokens/s, 6N FLOPs {fpt * LM_LONG / (long_ms / 1e3) / PEAK_BF16_FLOPS:.4f} "
        f"of the bf16 peak); the short prefills {short_ms:.3f} ms (median); decode at {LM_SLOTS} slots "
        f"{decode_ms:.3f} ms per step (median of {len(full)}; min {full[0]:.3f}, max {full[-1]:.3f}); peak device "
        f"memory {run['peak']:.2f} GiB serving, {peak_build:.2f} GiB building; state {per_slot[8]:,} bytes per slot "
        f"at cache_len 8 and at 9000; on {card}")
    long_toks = torch.as_tensor(prompts[LM_LONG_AT], dtype=torch.int64, device=dev)[None]
    last = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    with fn_annotated(R, "_wkv_chunked", "rwkv_wkv"):
        prof_long = lm_profile(f"the {LM_LONG}-token prefill", lambda: eng.model.prefill(eng.params, long_toks),
                               long_ms, "[ssm]", part="rwkv_wkv")
        prof_dec = lm_profile(f"a decode step at {LM_SLOTS} slots",
                              lambda: eng.model.decode(eng.params, eng.caches, last, 0), decode_ms, "[ssm]",
                              part="rwkv_wkv")

    # the WKV scan alone, on layer 0's bf16 inputs of the long prefill
    args = cap["args"]
    o, S_T = wkv(*args)
    check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(S_T).all()), "[ssm] non-finite WKV output")
    wkv_ms = time_ms(lambda: wkv(*args), reps=5)
    prof_wkv = lm_profile(f"one WKV call at T = {LM_LONG}", lambda: wkv(*args), wkv_ms, "[ssm]")
    b, by = wkv_bound(args[0], args[5])
    say(f"[ssm] the WKV scan (models/rwkv.py::_wkv_chunked, torch operations) on layer 0's inputs of the long "
        f"prefill, (B, T, H, dh) = {tuple(args[0].shape)}, bf16: {wkv_ms:.4f} ms a call, x {cfg.n_layers} layers = "
        f"{wkv_ms * cfg.n_layers:.3f} ms, {wkv_ms * cfg.n_layers / long_ms:.3f} of the prefill; "
        f"{prof_wkv['launches'] if prof_wkv else 'not measured'} launches a call; bound {b:.4f} ms ({by}); "
        f"on {card}")
    numbers = dict(ms=wkv_ms, launches=prof_wkv["launches"] if prof_wkv else None, bound_ms=b, bound_by=by,
                   prefill_share=prof_long["part_ms"] / long_ms if prof_long else None,
                   decode_share=prof_dec["part_ms"] / decode_ms if prof_dec else None)
    del eng, run, cap, args, o, S_T
    gc.collect()
    torch.cuda.empty_cache()

    # f32 at full width, cut depth: the engine against a teacher-forced prefill; layer 0's WKV against f64
    cfg32 = cfg.replace(n_layers=SSM_F32_LAYERS, compute_dtype=torch.float32)
    values = M.init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED + 42), device=dev)
    eng = ServeEngine(cfg32, values, slots=len(SSM_F32_PROMPTS), cache_len=128, seed=SEED, device=dev)
    del values
    rng = np.random.default_rng(SEED + 43)
    prompts = [rng.integers(0, cfg32.vocab_size, size=n).astype(np.int32) for n in SSM_F32_PROMPTS]
    reqs, _ = lm_serve(eng, prompts, SSM_F32_NEW)
    parted, margins, longest = lm_teacher_forced("[ssm]", eng, reqs, dev)
    say(f"[ssm] f32: {cfg32.name} at full width with {cfg32.n_layers} layers in f32, prompts of {SSM_F32_PROMPTS} "
        f"tokens, {SSM_F32_NEW} greedy tokens each through the engine (the recurrent decode) against a teacher-forced "
        f"prefill (the chunked scan; prefixes up to {longest} tokens): {len(reqs) - parted} of {len(reqs)} requests "
        f"identical" + (f", {parted} parting at a near-tie (margins {margins} of the logit bound)" if parted else ""))
    long32 = torch.as_tensor(np.random.default_rng(SEED + 44).integers(0, cfg32.vocab_size, size=LM_LONG),
                             dtype=torch.int64, device=dev)[None]
    cap, wkv, uncapture = fn_capture(R, "_wkv_chunked", LM_LONG)
    try:
        with torch.no_grad():
            eng.model.prefill(eng.params, long32)
    finally:
        uncapture()
    args = cap["args"]
    o, S_T = wkv(*args)
    t0 = time.perf_counter()
    o64, S64 = serial_wkv64(*args)
    serial_s = time.perf_counter() - t0
    lwc = args[3].reshape(1, LM_LONG // 64, 64, *args[3].shape[2:]).double().cumsum(2)
    read_o = float((o.double() - o64).abs().max() / o64.abs().max())
    read_S = float((S_T.double() - S64).abs().max() / S64.abs().max())
    say(f"[ssm] f32: layer 0's WKV at T = {LM_LONG} on its real inputs (log decays {float(args[3].min()):.4f} to "
        f"{float(args[3].max()):.4f}, the deepest cumulative log decay in a chunk {float(lwc.min()):.3f}: the clip at "
        f"-30 does not bind) against the serial f64 recurrence ({serial_s:.1f} s): o {read_o:.3e}, S_T {read_S:.3e} "
        f"of the largest |value| (limit {SSM_WKV_RTOL:g})")
    check(float(lwc.min()) > -30, "[ssm] the clip binds on the f32 inputs")
    check(read_o <= SSM_WKV_RTOL and read_S <= SSM_WKV_RTOL, "[ssm] the chunked WKV leaves the f64 recurrence")
    del eng, reqs, cap, args, o, S_T, o64, S64, lwc
    gc.collect()
    torch.cuda.empty_cache()

    # a full-width train step
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 45), device=dev)
    state = adamw_init(params)
    step = M.make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
    pipe = TokenPipeline(cfg.vocab_size, SSM_TRAIN[0], SSM_TRAIN[1], seed=SEED + 46)
    batches = [pipe.batch_at(i) for i in range(TRAIN_TIMED_STEPS)]
    pipe.close()
    torch.cuda.reset_peak_memory_stats()
    timed = train_steps(step, params, state, batches, dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = [r[2] for r in timed[1:]]
    step_ms = float(np.median(after))
    tok_s = SSM_TRAIN[0] * SSM_TRAIN[1] / (step_ms / 1e3)
    say(f"[ssm] training: {cfg.name} at full width, remat {cfg.remat!r}, bf16 compute over the f32 master, (B, S) = "
        f"{SSM_TRAIN} ({SSM_TRAIN[1] // 64} chunks): steps {[round(r[2], 3) for r in timed]} ms, the first a "
        f"warm-up; the other {len(after)}: median {step_ms:.3f} ms, min {min(after):.3f}, max {max(after):.3f} "
        f"(losses {[round(r[0], 4) for r in timed]}); {tok_s:.0f} tokens/s, 6N FLOPs "
        f"{fpt * tok_s / PEAK_BF16_FLOPS:.4f} of the 989 TFLOP/s bf16 peak; peak memory {peak:.2f} GiB; on {card}")
    check(all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in timed), "[ssm] a non-finite loss")
    numbers.update(train_step_ms=step_ms, train_tokens_s=tok_s)
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()

    # cut depth in f32: the remat modes and microbatches against "full" and 1
    remat_readings("[ssm]", cfg.replace(n_layers=SSM_CUT_LAYERS, compute_dtype=torch.float32), SEED + 47, dev)

    lm_cpu_replay("[ssm]", dev, C.get_smoke(SSM_ARCH).replace(compute_dtype=torch.float32), SEED + 49,
                  "torch operations on both")
    moved = kernel_counts()
    say(f"[ssm] hand-written kernel launches over the phase (no kernel lies on RWKV's path): {json.dumps(moved)}")
    check(not any(moved.values()), "[ssm] a hand-written kernel was launched")
    say(f"[ssm] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return numbers


def ssd_bound(x, Bm, h0):
    """The SSD scan's bound at this call's shapes: x, B and C (their dtype)
    read once, the f32 Δ, A_log and h0 read and h_T written once, y
    written once; the FLOPs of the products on each chunk's lower
    triangle (C·Bᵀ per group, its decay-weighted product with Δx per
    head), of the chunk states' increments and the carried state's term
    (2·N·P each per token and head) and of the carry (2·N·P per chunk and
    head); at the tensor cores' bf16 peak for bf16, the f32 peak otherwise."""
    import torch

    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    C = min(64, T)
    n = T // C
    nbytes = x.element_size() * (2 * x.numel() + 2 * Bm.numel()) + 4 * (B * T * H + H) + 2 * 4 * h0.numel()
    tri = C * (C + 1)
    flops = B * n * (G * N * tri + H * P * tri) + 4.0 * B * T * H * N * P + 2.0 * B * n * H * N * P
    return bound_ms(flops, nbytes, PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_F32_FLOPS)


def serial_ssd64(x, dt, Bm, Cm, A_log, h0):
    """The recurrence itself in f64 on the card, token by token:
    h_t = exp(Δ_t·A) h_{t-1} + Δ_t x_t ⊗ B_t, y_t = C_t · h_t."""
    import torch

    rep = x.shape[2] // Bm.shape[2]
    x, dt, h = x.double(), dt.double(), h0.double()
    Bh, Ch = (t.double().repeat_interleave(rep, dim=2) for t in (Bm, Cm))  # (B, T, H, N)
    a = torch.exp(dt * -torch.exp(A_log.double()))  # (B, T, H)
    y = torch.empty_like(x)
    for t in range(x.shape[1]):
        h = a[:, t, :, None, None] * h + (dt[:, t, :, None, None] * Bh[:, t, :, :, None]) * x[:, t, :, None, :]
        y[:, t] = (Ch[:, t, :, :, None] * h).sum(2)
    return y, h


def phase_hybrid(dev, card):
    """LM serving and training for the hybrid family at published widths:
    zamba2-7b through ServeEngine as [lm] serves, HYB_NEW tokens a
    request, the long prefill on the tensor-core flash kernel at Dh 112 in
    each of the 13 applications of the shared block and nowhere else; its
    decode state per slot against the reference's; profiles of the long
    prefill and a decode step with the SSD scan's and the flash kernel's
    shares; the first application's attention against the plain version;
    the SSD scan timed on layer 0's inputs beside its bound; 9 layers in
    f32: the engine's tokens against a teacher-forced prefill, layer 0's
    SSD at T = 6144 against the serial f64 recurrence; 15 layers trained
    at (1, 8192) with the flash launches against the code's prediction,
    and the shared block's backward at that shape against the plain one;
    at 9 layers in f32 the remat modes and microbatches; the SMOKE replay
    against the CPU.  Returns the flash launches of the counted runs (by
    run) and the Dh 112 kernels' numbers."""
    import torch

    from repro_torch import configs as C
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM
    from repro_torch.serving import ServeEngine
    from repro_torch.train import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    kernel_counts(reset=True)  # every counter 0 for the phase (later phases reset their own before counting)
    cfg = C.get(HYB_ARCH)
    apps = (cfg.n_layers - cfg.hybrid_tail) // (cfg.hybrid_group + 1)  # applications of the shared block
    base, params, peak_build = lm_build(cfg, dev, SEED + 50)
    n_params, fpt = M.count_params(params), M.model_flops_per_token(cfg)
    d_inner, H, conv_dim = SSM.ssm_dims(cfg)
    say(f"[hybrid] {cfg.name}: {cfg.n_layers} layers ({apps} groups of {cfg.hybrid_group} Mamba-2 blocks and one "
        f"application of the shared attention block, then {cfg.hybrid_tail} Mamba-2 blocks), d_model {cfg.d_model}, "
        f"the shared block {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim} and d_ff {cfg.d_ff}, SSD {H} heads "
        f"of {cfg.ssm_head_dim} with state {cfg.ssm_state} (d_inner {d_inner}, {cfg.ssm_groups} B/C group, conv "
        f"width {SSM.CONV_W} over {conv_dim} channels), vocab {cfg.vocab_size}; {n_params:,} parameters and "
        f"model_flops_per_token {fpt:,.0f} (the reference's: {HYB_PARAMS:,} and {HYB_FLOPS:,}); the bf16 compute "
        f"copy drawn leaf by leaf from a seeded torch.Generator on the card: peak {peak_build:.2f} GiB; on {card}")
    check(n_params == HYB_PARAMS and fpt == HYB_FLOPS, f"[hybrid] {n_params} parameters, {fpt} FLOPs a token")
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, cache_len=LM_CACHE_LEN, seed=SEED, device=dev)
    mamba, p = eng.params["mamba_groups"]["mamba"], eng.params
    check(all(mamba[k].dtype == torch.bfloat16 for k in ("in_proj", "out_proj", "conv_w", "conv_b", "D"))
          and all(t.dtype == torch.bfloat16 for t in (p["shared_attn"]["attn"]["wq"]["w"], p["embed"]["table"],
                                                      p["unembed"]["table"]))
          and all(mamba[k].dtype == torch.float32 for k in HYB_F32_LEAVES)
          and all(t.dtype == torch.float32 for t in (mamba["norm"]["scale"], p["mamba_groups"]["ln"]["scale"],
                                                     p["shared_attn"]["ln1"]["scale"], p["final_norm"]["scale"])),
          "[hybrid] the engine does not hold the bf16 compute copy with A_log, dt_bias and the norms in f32")
    check(mamba["in_proj"] is params["mamba_groups"]["mamba"]["in_proj"],
          "[hybrid] the engine copied a tree already in the compute dtype")
    del params, mamba, p
    per_slot = {n: tree_bytes(eng.model.init_cache(1, n, device="meta")) for n in HYB_STATE_BYTES}
    check(per_slot == HYB_STATE_BYTES and tree_bytes(eng.caches) == LM_SLOTS * per_slot[LM_CACHE_LEN],
          f"[hybrid] state bytes per slot {per_slot} (the reference's {HYB_STATE_BYTES}), the engine's "
          f"{tree_bytes(eng.caches)}")

    prompts = lm_prompts(cfg, np.random.default_rng(SEED + 51))
    cap, core, uncapture = lm_capture(LM_LONG)
    ssd_cap, ssd, unssd = fn_capture(SSM, "_ssd_chunked", LM_LONG)
    try:
        run = lm_serve_timed(eng, prompts, base, HYB_NEW)
    finally:
        uncapture()
        unssd()
    launches = {name: {"hybrid": n} for name, n in run["launches"].items()}
    long_ms, decode_ms = lm_serve_report("[hybrid]", eng, run, LM_LONG, apps, peak_build, base)
    say(f"[hybrid] {eng.tokens_out / run['wall']:.1f} tokens/s over the ragged serve; the long prefill "
        f"{LM_LONG / long_ms * 1e3:.0f} tokens/s, 6N FLOPs {fpt * LM_LONG / (long_ms / 1e3) / PEAK_BF16_FLOPS:.4f} of "
        f"the bf16 peak; decode state {per_slot[8]:,} bytes per slot at cache_len 8 and {per_slot[8192]:,} at 8192 "
        f"(the Mamba states {per_slot[8] - 2 * apps * 8 * cfg.n_kv_heads * cfg.head_dim * 2 - 4 * apps:,} of them, "
        f"O(1) in the sequence), {tree_bytes(eng.caches):,} for the engine's {LM_SLOTS} slots; on {card}")

    # the shared block's first application of the long prefill at Dh 112, through the tensor-core kernel
    q, k, v = cap["q"], cap["k"], cap["v"]
    views = [t.transpose(1, 2) for t in (q, k, v, torch.empty_like(q))]
    which = k_fa.route(q.dtype, q.shape[3], [t.shape for t in views], [t.stride() for t in views],
                       [t.data_ptr() for t in views])
    check(which == "mma" and q.shape[3] == cfg.head_dim == 112,
          f"[hybrid] the shared block's attention (Dh {q.shape[3]}) takes the {which!r} route, not 'mma'")
    flash = lm_flash(f"the shared block (route {which!r}, Dh {q.shape[3]})", core, cap, "bf16", apps, long_ms,
                     "[hybrid]")
    del q, k, v, views, cap
    long_toks = torch.as_tensor(prompts[LM_LONG_AT], dtype=torch.int64, device=dev)[None]
    last = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    with fn_annotated(SSM, "_ssd_chunked", "mamba2_ssd"):
        prof_long = lm_profile(f"the {LM_LONG}-token prefill", lambda: eng.model.prefill(eng.params, long_toks),
                               long_ms, "[hybrid]", extra=("mamba2_ssd",))
        prof_dec = lm_profile(f"a decode step at {LM_SLOTS} slots",
                              lambda: eng.model.decode(eng.params, eng.caches, last, LM_LONG + HYB_NEW), decode_ms,
                              "[hybrid]", extra=("mamba2_ssd",))

    # the SSD scan alone, on layer 0's bf16 inputs of the long prefill
    args = ssd_cap["args"]
    y, h = ssd(*args)
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all()), "[hybrid] non-finite SSD output")
    ssd_ms = time_ms(lambda: ssd(*args), reps=5)
    prof_ssd = lm_profile(f"one SSD call at T = {LM_LONG}", lambda: ssd(*args), ssd_ms, "[hybrid]")
    b, by = ssd_bound(args[0], args[2], args[5])
    n_mamba = cfg.n_layers - apps
    say(f"[hybrid] the SSD scan (models/ssm.py::_ssd_chunked, torch operations) on layer 0's inputs of the long "
        f"prefill, x (B, T, H, P) = {tuple(args[0].shape)}, B/C {tuple(args[2].shape)}, bf16: {ssd_ms:.4f} ms a call, "
        f"x {n_mamba} Mamba-2 layers = {ssd_ms * n_mamba:.3f} ms, {ssd_ms * n_mamba / long_ms:.3f} of the prefill; "
        f"{prof_ssd['launches'] if prof_ssd else 'not measured'} launches a call; bound {b:.4f} ms ({by}); on {card}")
    numbers = dict(hybrid=flash, ssd=dict(
        ms=ssd_ms, launches=prof_ssd["launches"] if prof_ssd else None, bound_ms=b, bound_by=by,
        prefill_share=prof_long["extra_ms"]["mamba2_ssd"] / long_ms if prof_long else None,
        decode_share=prof_dec["extra_ms"]["mamba2_ssd"] / decode_ms if prof_dec else None))
    del eng, run, ssd_cap, args, y, h
    gc.collect()
    torch.cuda.empty_cache()

    # f32 at full width, cut depth: the engine against a teacher-forced prefill; layer 0's SSD against f64
    cfg32 = cfg.replace(n_layers=HYB_F32_LAYERS, compute_dtype=torch.float32)
    values = M.init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED + 52), device=dev)
    eng = ServeEngine(cfg32, values, slots=HYB_F32_BATCH, cache_len=128, seed=SEED, device=dev)
    del values
    rng = np.random.default_rng(SEED + 53)
    prompts = [rng.integers(0, cfg32.vocab_size, size=HYB_F32_PROMPT).astype(np.int32) for _ in range(HYB_F32_BATCH)]
    reqs, _ = lm_serve(eng, prompts, HYB_F32_NEW)
    parted, margins, longest = lm_teacher_forced("[hybrid]", eng, reqs, dev)
    say(f"[hybrid] f32: {cfg32.name} at full width with {cfg32.n_layers} layers in f32, {HYB_F32_BATCH} prompts of "
        f"{HYB_F32_PROMPT} tokens, {HYB_F32_NEW} greedy tokens each through the engine (the recurrent decode over "
        f"the conv and SSD states and the KV cache) against a teacher-forced prefill (the chunked scan; prefixes up "
        f"to {longest} tokens): {len(reqs) - parted} of {len(reqs)} requests identical"
        + (f", {parted} parting at a near-tie (margins {margins} of the logit bound)" if parted else ""))
    long32 = torch.as_tensor(np.random.default_rng(SEED + 54).integers(0, cfg32.vocab_size, size=LM_LONG),
                             dtype=torch.int64, device=dev)[None]
    cap, ssd, unssd = fn_capture(SSM, "_ssd_chunked", LM_LONG)
    try:
        with torch.no_grad():
            eng.model.prefill(eng.params, long32)
    finally:
        unssd()
    args = cap["args"]
    y, h = ssd(*args)
    t0 = time.perf_counter()
    y64, h64 = serial_ssd64(*args)
    serial_s = time.perf_counter() - t0
    lg = args[1].double() * -torch.exp(args[4].double())  # the log decays Δ·A
    read_y = float((y.double() - y64).abs().max() / y64.abs().max())
    read_h = float((h.double() - h64).abs().max() / h64.abs().max())
    say(f"[hybrid] f32: layer 0's SSD at T = {LM_LONG} on its real inputs (log decays Δ·A {float(lg.min()):.4f} to "
        f"{float(lg.max()):.4f} a token) against the serial f64 recurrence ({serial_s:.1f} s): y {read_y:.3e}, h_T "
        f"{read_h:.3e} of the largest |value| (limit {HYB_SSD_RTOL:g})")
    check(read_y <= HYB_SSD_RTOL and read_h <= HYB_SSD_RTOL, "[hybrid] the chunked SSD leaves the f64 recurrence")
    del eng, reqs, cap, args, y, h, y64, h64, lg
    gc.collect()
    torch.cuda.empty_cache()

    # training at full width, cut depth: 15 layers (2 applications of the shared block) at (1, 8192)
    cut = cfg.replace(n_layers=HYB_TRAIN_LAYERS)
    cut_apps = (cut.n_layers - cut.hybrid_tail) // (cut.hybrid_group + 1)
    fpt_cut = M.model_flops_per_token(cut)
    check(cut.remat == "full", f"[hybrid] remat {cut.remat!r}")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cut, torch.Generator(device=dev).manual_seed(SEED + 55), device=dev)
    state = adamw_init(params)
    step = M.make_train_step(cut, AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
    pipe = TokenPipeline(cut.vocab_size, HYB_TRAIN[0], HYB_TRAIN[1], seed=SEED + 56)
    batches = [pipe.batch_at(i) for i in range(TRAIN_TIMED_STEPS)]
    pipe.close()
    k_fa.launches = k_fa.launches_mma = k_fa.launches_simt = k_fa.launches_bwd = 0
    k_fa.launches_bwd_mma = k_fa.launches_bwd_simt = 0
    timed = train_steps(step, params, state, batches, dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    t_launches = {"flash_attention_mma": k_fa.launches_mma, "flash_attention": k_fa.launches_simt,
                  "flash_attention_bwd": k_fa.launches_bwd, "flash_attention_bwd_mma": k_fa.launches_bwd_mma,
                  "flash_attention_bwd_simt": k_fa.launches_bwd_simt}
    n = cut_apps * TRAIN_TIMED_STEPS
    want = {"flash_attention_mma": n, "flash_attention": 0, "flash_attention_bwd": n, "flash_attention_bwd_mma": n,
            "flash_attention_bwd_simt": 0}
    after = [r[2] for r in timed[1:]]
    step_ms = float(np.median(after))
    tok_s = HYB_TRAIN[0] * HYB_TRAIN[1] / (step_ms / 1e3)
    say(f"[hybrid] training: {cut.name} at full width cut to {cut.n_layers} layers ({cut_apps} applications of the "
        f"shared block; {M.count_params(params):,} parameters, model_flops_per_token {fpt_cut:,.0f}), remat "
        f"{cut.remat!r} on the Mamba-2 blocks only, bf16 compute over the f32 master, (B, S) = {HYB_TRAIN}: steps "
        f"{[round(r[2], 3) for r in timed]} ms, the first a warm-up; the other {len(after)}: median {step_ms:.3f} ms, "
        f"min {min(after):.3f}, max {max(after):.3f} (losses {[round(r[0], 4) for r in timed]}); {tok_s:.0f} "
        f"tokens/s, 6N FLOPs {fpt_cut * tok_s / PEAK_BF16_FLOPS:.4f} of the 989 TFLOP/s bf16 peak; peak memory "
        f"{peak:.2f} GiB; flash launches {json.dumps(t_launches)}, the code predicts {json.dumps(want)} (per step "
        f"and application: one forward on the tensor cores, no remat recompute of the shared block, one backward "
        f"on the tensor cores); on {card}")
    check(all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in timed), "[hybrid] a non-finite loss")
    check(t_launches == want, "[hybrid] training's flash launches differ from the prediction")
    for name in ("flash_attention_mma", "flash_attention"):
        launches[name]["hybrid_train"] = t_launches[name]
    launches["flash_attention_bwd"] = {"hybrid_train": t_launches["flash_attention_bwd"]}
    numbers.update(train_step_ms=step_ms, train_tokens_s=tok_s)
    del params, state, step, batches
    gc.collect()
    torch.cuda.empty_cache()

    # the shared block's backward at the training shape (Dh 112) against the plain backward and autograd
    numbers["hybrid_bwd"] = train_bwd_case(dev, torch.Generator(device=dev).manual_seed(SEED + 57), HYB_BWD,
                                           "[hybrid]")
    remat_readings("[hybrid]", cfg.replace(n_layers=HYB_F32_LAYERS, compute_dtype=torch.float32), SEED + 58, dev,
                   HYB_MICRO_RTOL)
    lm_cpu_replay("[hybrid]", dev, C.get_smoke(HYB_ARCH).replace(compute_dtype=torch.float32), SEED + 60)
    moved = kernel_counts()
    say(f"[hybrid] hand-written kernel launches over the phase (the flash kernels alone lie on this path; the "
        f"checks' launches included): {json.dumps(moved)}")
    check(not any(v for name, v in moved.items() if name not in ("flash_attention", "flash_attention_bwd")),
          "[hybrid] a kernel off the hybrid path was launched")
    say(f"[hybrid] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, numbers


def phase_audio(dev, card):
    """LM serving and training for the audio family at published widths:
    whisper-tiny through ServeEngine as [lm] serves (the engine's zero
    frames), the AUD_LONG-token prefill on the tensor-core flash kernel at
    Dh 64 in both attentions of each decoder layer (causal self 12,288²,
    non-causal cross 12,288 x 1500) and nowhere else; profiles of that
    prefill and a decode step; layer 0's two calls against the plain
    version, each timed beside its bound and SDPA's; one encode timed; in
    f32 the decode fed encode(frames) against forward (teacher forcing);
    the whole model trained at (1, 16,384) and (4, 2048) with the flash
    launches against the code's prediction; the backward at whisper's
    two shapes against the plain backward; the SMOKE replay against the
    CPU.  Returns the flash launches of the counted runs (by run) and the
    Dh 64 kernels' numbers."""
    import torch

    from repro_torch import configs as C
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine
    from repro_torch.train import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    kernel_counts(reset=True)  # every counter 0 for the phase (later phases reset their own before counting)
    cfg = C.get(AUD_ARCH)
    n_attn = 2 * cfg.n_layers  # the flash calls of a long prefill: self- and cross-attention in each decoder layer
    base, params, peak_build = lm_build(cfg, dev, SEED + 70)
    n_params, fpt = M.count_params(params), M.model_flops_per_token(cfg)
    say(f"[audio] {cfg.name}: {cfg.encoder_layers} encoder and {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.n_frames} frames, {cfg.max_dec_pos} decoder positions; {n_params:,} parameters and "
        f"model_flops_per_token {fpt:,.0f} (the reference's: {AUD_PARAMS:,} and {AUD_FLOPS:,}); the bf16 compute "
        f"copy drawn leaf by leaf from a seeded torch.Generator on the card: peak {peak_build:.3f} GiB; on {card}")
    check(n_params == AUD_PARAMS and fpt == AUD_FLOPS, f"[audio] {n_params} parameters, {fpt} FLOPs a token")
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, cache_len=AUD_CACHE_LEN, seed=SEED, device=dev)
    p = eng.params
    dec = p["dec_blocks"]
    check(all(t.dtype == torch.bfloat16 for t in (p["embed"]["table"], p["enc_blocks"]["attn"]["wq"]["w"],
                                                  dec["xattn"]["wk"]["w"], dec["mlp"]["down"]["w"]))
          and all(t.dtype == torch.float32 for t in (p["enc_pos"], p["dec_pos"], p["enc_norm"]["scale"],
                                                     dec["ln_x"]["bias"])),
          "[audio] the engine does not hold the bf16 compute copy with the position tables and the norms in f32")
    check(p["embed"]["table"] is params["embed"]["table"], "[audio] the engine copied a tree already in bf16")
    del params, p, dec
    say("[audio] the engine's frames are bf16 zeros (the reference engine's): each prefill encodes them, and each "
        "decode step passes them unencoded as the encoder's output, so there the cross K/V are 0 and the branch "
        "adds nothing")

    prompts = lm_prompts(cfg, np.random.default_rng(SEED + 71), AUD_LONG)
    cap_self, core, unself = lm_capture(AUD_LONG, AUD_LONG)
    cap_cross, _, uncross = lm_capture(AUD_LONG, cfg.n_frames)
    try:
        run = lm_serve_timed(eng, prompts, base)
    finally:
        uncross()
        unself()
    launches = {name: {"audio": n} for name, n in run["launches"].items()}
    long_ms, decode_ms = lm_serve_report("[audio]", eng, run, AUD_LONG, n_attn, peak_build, base)
    say(f"[audio] {eng.tokens_out / run['wall']:.1f} tokens/s over the ragged serve; the long prefill "
        f"{AUD_LONG / long_ms * 1e3:.0f} tokens/s, 6N FLOPs {fpt * AUD_LONG / (long_ms / 1e3) / PEAK_BF16_FLOPS:.4f} "
        f"of the bf16 peak; on {card}")

    # layer 0's two calls of the long prefill at Dh 64, through the tensor-core kernel
    numbers = {}
    for key, cap, causal, Sk in (("self", cap_self, True, AUD_LONG), ("cross", cap_cross, False, cfg.n_frames)):
        q, k, v = cap["q"], cap["k"], cap["v"]
        views = [t.transpose(1, 2) for t in (q, k, v, torch.empty_like(q))]
        which = k_fa.route(q.dtype, q.shape[3], [t.shape for t in views], [t.stride() for t in views],
                           [t.data_ptr() for t in views])
        check(which == "mma" and q.shape[3] == cfg.head_dim == 64 and bool(cap["kw"]["causal"]) == causal
              and k.shape[1] == Sk, f"[audio] layer 0's {key}-attention (Dh {q.shape[3]}, Sk {k.shape[1]}, causal "
                                    f"{cap['kw']['causal']}) takes the {which!r} route, not 'mma'")
        numbers[key] = lm_flash(f"{'causal self' if causal else 'non-causal cross'}-attention (route {which!r}, Dh "
                                f"{q.shape[3]})", core, cap, "bf16", cfg.n_layers, long_ms, "[audio]")
        del q, k, v, views
    del cap_self, cap_cross
    long_toks = torch.as_tensor(prompts[LM_LONG_AT], dtype=torch.int64, device=dev)[None]
    prof_long = lm_profile(f"the {AUD_LONG}-token prefill", lambda: eng._prefill_one(eng.params, long_toks), long_ms,
                           "[audio]")
    last = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    prof_dec = lm_profile(f"a decode step at {LM_SLOTS} slots",
                          lambda: eng.model.decode(eng.params, eng.caches, last, AUD_LONG + LM_NEW,
                                                   eng._frames(LM_SLOTS)), decode_ms, "[audio]")
    frames = torch.randn((1, cfg.n_frames, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(SEED + 72),
                         device=dev).to(torch.bfloat16)
    with torch.no_grad():
        enc = eng.model.encode(eng.params, frames)
        enc_ms = time_ms(lambda: eng.model.encode(eng.params, frames), reps=10)
    check(bool(torch.isfinite(enc).all()) and tuple(enc.shape) == (1, cfg.n_frames, cfg.d_model),
          "[audio] the encoder's output is not finite or not (1, n_frames, d_model)")
    say(f"[audio] one encode of (1, {cfg.n_frames}) frames ({cfg.encoder_layers} layers, bidirectional attention "
        f"on the plain branch: {cfg.n_frames}² is under the flash threshold): {enc_ms:.4f} ms, "
        f"{enc_ms / long_ms:.3f} of the long prefill that runs it; on {card}")
    numbers.update(prefill_ms=long_ms, decode_ms=decode_ms, encode_ms=enc_ms,
                   prefill_busy_ms=prof_long["busy_ms"] if prof_long else None,
                   decode_launches=prof_dec["launches"] if prof_dec else None)
    del eng, run, enc, frames
    gc.collect()
    torch.cuda.empty_cache()

    # f32 at full width: decode fed encode(frames) against forward (teacher forcing)
    cfg32 = cfg.replace(compute_dtype=torch.float32)
    values = M.init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED + 73), device=dev)
    model = M.build_model(cfg32)
    Bf, P, NEW, vocab = AUD_F32_BATCH, AUD_F32_PROMPT, AUD_F32_NEW, cfg.vocab_size
    frames = torch.randn((Bf, cfg.n_frames, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(SEED + 74),
                         device=dev)
    toks = torch.as_tensor(np.random.default_rng(SEED + 75).integers(0, vocab, size=(Bf, P)), dtype=torch.int64,
                           device=dev)
    with torch.no_grad():
        enc = model.encode(values, frames)
        logits, cache = model.prefill(values, toks, frames)
        grown = model.init_cache(Bf, P + NEW, device=dev)
        for name in ("k", "v"):
            grown["self"][name][:, :, :P] = cache["self"][name]
        grown["pos"].copy_(cache["pos"])
        steps = [logits[:, -1, :vocab].float()]
        picked = [steps[-1].argmax(-1)]
        for i in range(NEW - 1):
            logits, grown = model.decode(values, grown, picked[-1][:, None], P + i, enc)
            steps.append(logits[:, -1, :vocab].float())
            picked.append(steps[-1].argmax(-1))
        seq = torch.cat([toks, torch.stack(picked[:-1], 1)], 1)
        full = model.forward(values, {"frames": frames, "tokens": seq})[:, P - 1:, :vocab].float()
    worst, margins = 0.0, []
    for i, got in enumerate(steps):
        want = full[:, i]
        check(bool(torch.isfinite(got).all()), "[audio] f32: non-finite logits")
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
        for r in torch.nonzero(got.argmax(-1) != want.argmax(-1)).flatten().tolist():
            w, g = int(want[r].argmax()), int(got[r].argmax())
            margins.append(float(want[r, w] - want[r, g]) / (AUD_TEACHER_RTOL * float(want[r].abs().max())))
    say(f"[audio] f32: {cfg32.name} at full width in f32, {Bf} prompts of {P} tokens over seeded frames, {NEW} greedy "
        f"tokens each through decode fed encode(frames) (the bf16 KV cache) against forward over the prompt and "
        f"those tokens: logits at most {worst:.3e} apart relative to the largest (limit {AUD_TEACHER_RTOL:g}); "
        f"{Bf * NEW - len(margins)} of {Bf * NEW} tokens identical"
        + (f", {len(margins)} parting at a near-tie (margins {margins} of the bound)" if margins else ""))
    check(worst <= AUD_TEACHER_RTOL, "[audio] f32: decode leaves forward")
    check(all(mg <= 2 for mg in margins), f"[audio] f32: a token parts from forward's by more than a near-tie: "
                                          f"{margins}")
    del values, model, frames, toks, enc, cache, grown, steps, full, logits
    gc.collect()
    torch.cuda.empty_cache()

    # training at full width and depth
    check(cfg.remat == "full", f"[audio] remat {cfg.remat!r}")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 76), device=dev)
    state = adamw_init(params)
    step = M.make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
    gen = torch.Generator(device=dev).manual_seed(SEED + 77)
    thr = cfg.flash_threshold
    launches["flash_attention_bwd"] = {}
    for Bt, St in AUD_TRAIN:
        pipe = TokenPipeline(cfg.vocab_size, Bt, St, seed=SEED + 78)
        frames = torch.randn((Bt, cfg.n_frames, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        batches = [dict(pipe.batch_at(i), frames=frames) for i in range(TRAIN_TIMED_STEPS)]
        pipe.close()
        k_fa.launches = k_fa.launches_mma = k_fa.launches_simt = k_fa.launches_bwd = 0
        k_fa.launches_bwd_mma = k_fa.launches_bwd_simt = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = train_steps(step, params, state, batches, dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = {"flash_attention_mma": k_fa.launches_mma, "flash_attention": k_fa.launches_simt,
               "flash_attention_bwd": k_fa.launches_bwd, "flash_attention_bwd_mma": k_fa.launches_bwd_mma,
               "flash_attention_bwd_simt": k_fa.launches_bwd_simt}
        # per step: each decoder attention past the threshold runs the forward kernel twice (the forward and the
        # remat recompute of its block) and the backward once; the encoder's 1500² stays on the plain branch
        calls = cfg.n_layers * (int(St * St > thr) + int(St * cfg.n_frames > thr)) * TRAIN_TIMED_STEPS
        want = {"flash_attention_mma": 2 * calls, "flash_attention": 0, "flash_attention_bwd": calls,
                "flash_attention_bwd_mma": calls, "flash_attention_bwd_simt": 0}
        after = [r[2] for r in timed[1:]]
        step_ms = float(np.median(after))
        tok_s = Bt * St / (step_ms / 1e3)
        say(f"[audio] training: {cfg.name} at full width and depth, remat {cfg.remat!r}, bf16 compute over the f32 "
            f"master, AdamW, seeded frames in the batch, (B, S) = ({Bt}, {St}): steps "
            f"{[round(r[2], 3) for r in timed]} ms, the first a warm-up; the other {len(after)}: median "
            f"{step_ms:.3f} ms, min {min(after):.3f}, max {max(after):.3f} (losses {[round(r[0], 4) for r in timed]}); "
            f"{tok_s:.0f} tokens/s, 6N FLOPs {fpt * tok_s / PEAK_BF16_FLOPS:.4f} of the 989 TFLOP/s bf16 peak; peak "
            f"memory {peak:.2f} GiB; flash launches {json.dumps(got)}, the code predicts {json.dumps(want)}; on {card}")
        check(all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in timed), "[audio] a non-finite loss")
        check(got == want, f"[audio] training's flash launches at ({Bt}, {St}) differ from the prediction")
        run_name = f"audio_train_{Bt}x{St}"
        for name in ("flash_attention_mma", "flash_attention", "flash_attention_bwd"):
            launches[name][run_name] = got[name]
        numbers[f"train_{Bt}x{St}"] = dict(step_ms=step_ms, tokens_s=tok_s, peak_gib=peak)
        del batches, frames
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()

    # the backward at whisper's two training shapes against the plain backward and autograd
    for key, case in zip(("bwd_self", "bwd_cross"), AUD_BWD, strict=True):
        numbers[key] = train_bwd_case(dev, torch.Generator(device=dev).manual_seed(SEED + 79), case, "[audio]")
    lm_cpu_replay("[audio]", dev, C.get_smoke(AUD_ARCH).replace(compute_dtype=torch.float32), SEED + 80,
                  "the plain branch on both: the SMOKE shapes are under the flash threshold", AUD_SMOKE_LONG)
    moved = kernel_counts()
    say(f"[audio] hand-written kernel launches over the phase (the flash kernels alone lie on this path; the "
        f"checks' launches included): {json.dumps(moved)}")
    check(not any(v for name, v in moved.items() if name not in ("flash_attention", "flash_attention_bwd")),
          "[audio] a kernel off the audio path was launched")
    say(f"[audio] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, numbers


def grad_reading(got, want, dt, allow=None):
    """The gradient check's reading of a backward output against a plain
    one (passing while <= 1): the largest |got - want| / (rtol·|want| +
    atol·rms(want) + allow), rms the root mean square of ``want``.  In
    bf16, rtol = 2^-7 and atol = 1e-3: the kernel sums in f32 and rounds
    each gradient once to bf16 (up to 2^-8 relative: 7 stored mantissa
    bits), where the plain one stays f32; in f32, 1e-4 and 1e-4: the
    sums' order.  ``allow`` (elementwise) adds what a known difference of
    the inputs moves (see ``train_bwd_case``)."""
    rtol, atol = (1e-4, 1e-4) if dt == "f32" else (2.0**-7, 1e-3)
    got, want = got.float(), want.float()
    rms = float(want.square().mean().sqrt())
    lim = rtol * want.abs() + max(atol * rms, 1e-30)
    if allow is not None:
        lim = lim + allow
    return float(((got - want).abs() / lim).max())


def train_bwd_inputs(dev, gen, case):
    import torch

    label, B, Sq, Sk, H, KV, D, causal, window, dt, dead_head, dead_tail = case
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=dev).to(dtype)
                   for S, h in ((Sq, H), (Sk, KV), (Sk, KV), (Sq, H)))
    # causal with Sq < Sk: the queries are the last Sq positions
    qpos = (torch.arange(Sq, device=dev, dtype=torch.int32) + (Sk - Sq if causal else 0)).expand(B, Sq).contiguous()
    kpos = torch.arange(Sk, device=dev, dtype=torch.int32).expand(B, Sk).clone()
    kpos[:, :dead_head] = -1
    kpos[:, Sk - dead_tail:] = -1
    return q, k, v, do, qpos, kpos


def train_bwd_plain(q, k, v, do, qpos, kpos, causal, window):
    """Autograd through the plain forward on f32 copies, one kv head (its
    G query heads) at a time: [(g, dq (B, G, Sq, D), dk, dv (B, 1, Sk, D))]."""
    from repro_torch.kernels import ref

    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    for g in range(KV):
        leaves = [t.transpose(1, 2).float().clone().requires_grad_() for t in
                  (q[:, :, g * G:(g + 1) * G], k[:, :, g:g + 1], v[:, :, g:g + 1])]
        o = ref.gqa_flash_attention(*leaves, qpos, kpos, causal, window)
        o.backward(do[:, :, g * G:(g + 1) * G].transpose(1, 2).float())
        yield g, [t.grad for t in leaves]
        del o, leaves


def train_bwd_case(dev, gen, case, phase: str = "[train]"):
    """The backward on one shape: the route it takes (the tensor cores for
    bf16 with D <= 128, else the CUDA cores), against the plain backward
    and autograd through the plain version (the readings of
    ``grad_reading``), on the tensor-core route also against the CUDA-core
    kernel, bit for bit on a second run, rejecting a wrong mask; its time
    beside its bound, the plain backward's, SDPA's backward and (tensor
    cores) the CUDA-core kernel's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.kernels import ref

    label, B, Sq, Sk, H, KV, D, causal, window, dt, dead_head, dead_tail = case
    q, k, v, do, qpos, kpos = train_bwd_inputs(dev, gen, case)
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    o = k_fa.flash_attention(qh, kh, vh, qpos, kpos, causal=causal, window=window, lse=lse)
    # the serving call (no lse) gives the same bits; the lse is the plain one's (+inf on rows with no live key)
    plain_out = k_fa.flash_attention(qh, kh, vh, qpos, kpos, causal=causal, window=window)
    check(torch.equal(o, plain_out), f"{phase} {label}: the forward's output moved when it wrote the lse")
    want_lse = torch.cat([ref.gqa_flash_lse(qh[:, g * (H // KV):(g + 1) * (H // KV)], kh[:, g:g + 1], qpos, kpos,
                                            causal, window) for g in range(KV)], dim=1)
    fin = torch.isfinite(want_lse)
    lse_err = float((lse[fin] - want_lse[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(torch.equal(torch.isinf(lse), ~fin) and lse_err <= 1e-5 * max(1.0, float(want_lse[fin].abs().max())),
          f"{phase} {label}: the forward's lse is {lse_err:.3e} from the plain one's")
    del plain_out, want_lse, fin

    def bwd(qp=qpos, c=causal):
        return k_fa.flash_attention_backward(qh, kh, vh, o, lse, doh, qp, kpos, causal=c, window=window)

    def simt_bwd():
        return k_fa.flash_attention_backward_simt(qh, kh, vh, o, lse, doh, qpos, kpos, causal=causal, window=window)

    before = k_fa.launches_bwd_mma, k_fa.launches_bwd_simt
    got = bwd()
    route = {(1, 0): "mma", (0, 1): "simt"}.get((k_fa.launches_bwd_mma - before[0],
                                                  k_fa.launches_bwd_simt - before[1]))
    want_route = "mma" if dt == "bf16" and D <= 128 else "simt"
    check(route == want_route, f"{phase} {label}: the backward took the route {route}, not {want_route}")
    again = bwd()
    simt = simt_bwd() if route == "mma" else None
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    # a wrong backward: the causal mask off by one (each row sees one more key); non-causal: the mask switched on
    wrong = bwd(qpos + 1, True) if causal else bwd(qpos, True)
    G = H // KV
    own = exact = err = wrong_reading = simt_reading = 0.0
    for g, want in train_bwd_plain(q, k, v, do, qpos, kpos, causal, window):
        hs = slice(g * G, (g + 1) * G)
        # the plain version of this kernel in f32 on the same saved output and log-sum-exp: Δ from the same O
        plain = ref.gqa_flash_attention_backward(*(t.float() for t in (qh[:, hs], kh[:, g:g + 1], vh[:, g:g + 1],
                                                                         o[:, hs])), lse[:, hs], doh[:, hs].float(),
                                                 qpos, kpos, causal, window)
        for i, (w, pl) in enumerate(zip(want, plain)):
            sl = hs if i == 0 else slice(g, g + 1)
            mine = got[i][:, sl]
            check(bool(torch.isfinite(mine).all()), f"{phase} {label}: non-finite gradient")
            own = max(own, grad_reading(mine, pl, dt))
            # against autograd's exact gradient, allowing twice what Δ = rowsum(dO ∘ O) from the saved (in bf16,
            # rounded) O moves the plain version: |plain - exact|
            exact = max(exact, grad_reading(mine, w, dt, allow=2 * (pl - w).abs()))
            err = max(err, float((mine.float() - w).abs().max()))
            wrong_reading = max(wrong_reading, grad_reading(wrong[i][:, sl], pl, dt))
            if simt is not None:  # the CUDA-core kernel on the same inputs, under the same limits
                simt_reading = max(simt_reading, grad_reading(mine, simt[i][:, sl], dt))
        del plain
    check(same, f"{phase} {label}: a second run of the backward gave other bits")
    check(own <= 1 and exact <= 1 and simt_reading <= 1,
          f"{phase} {label}: outside tolerance, readings {own:.3f} (the plain backward), {exact:.3f} (autograd), "
          f"{simt_reading:.3f} (the CUDA-core kernel)")
    check(wrong_reading > 1, f"{phase} {label}: the check passes a wrong mask (reading {wrong_reading:.3f})")
    del wrong, again, simt
    ms = time_ms(bwd, reps=3, warm=1)
    simt_ms = time_ms(simt_bwd, reps=3, warm=1) if route == "mma" else None

    def plain():
        G_ = H // KV
        for g in range(KV):
            ref.gqa_flash_attention_backward(qh[:, g * G_:(g + 1) * G_], kh[:, g:g + 1], vh[:, g:g + 1],
                                             o[:, g * G_:(g + 1) * G_], lse[:, g * G_:(g + 1) * G_],
                                             doh[:, g * G_:(g + 1) * G_], qpos, kpos, causal, window)

    p_ms = time_ms(plain, reps=1, warm=1)
    live_pairs = kpos[:, None, :] >= 0
    if causal:
        live_pairs = live_pairs & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        live_pairs = live_pairs & (kpos[:, None, :] > qpos[:, :, None] - window)
    dead_rows = int((~live_pairs.any(-1)).sum())
    del live_pairs
    lib = None
    if not dead_rows:
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (qh, kh, vh))
        kw = sdpa_kw(qpos, kpos, causal, window)

        def fwd():
            return F.scaled_dot_product_attention(lq, lk, lv, enable_gqa=True, **kw)

        def fwd_bwd():
            fwd().backward(doh)

        lib = max(time_ms(fwd_bwd, reps=3, warm=1) - time_ms(fwd, reps=3, warm=1), 0.0)
        del lq, lk, lv
    live = _live_pairs(qpos, kpos, window, causal)
    es = q.element_size()
    # q, o, dO and dq at q's size, k, v, dk and dv at k's, the f32 lse read and Δ written and read
    nbytes = es * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel() + 8 * lse.numel()
    flops = 10.0 * D * live * H
    peak = PEAK_BF16_FLOPS if dt == "bf16" else PEAK_F32_FLOPS
    b, by = bound_ms(flops, nbytes, peak)
    b32, _ = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
    # the tensor-core kernel executes 20 FLOPs per live pair and padded feature (DP = 64 or 128): S and dP twice,
    # the dV, dK and dQ products on the hi and lo terms
    executed = 20.0 * (64 if D <= 64 else 128) * live * H
    simt_txt = (f", the CUDA-core kernel {simt_ms:.4f} ms on the same call (reading {simt_reading:.3f}); executed "
                f"{executed / ms / 1e9:.2f} TFLOP/s at 20·DP per live pair" if route == "mma" else "")
    say(f"{phase} backward {label}: route {route}; B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} "
        f"{'causal' if causal else 'non-causal'} window={window} {dt}, {dead_rows} rows without a live key; "
        f"the forward's output the same bits with and without lse, its lse {lse_err:.3e} from the plain one's; "
        f"max_abs_err {err:.3e} (against autograd); readings {own:.3f} against the plain backward on the same "
        f"saved tensors, {exact:.3f} against autograd through the plain forward, of limit 1; a wrong mask reads "
        f"{wrong_reading:.3f}; a second run bit for bit: {same}; kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s of the 10·D products), plain {p_ms:.4f} ms, sdpa backward "
        f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {b:.4f} ms ({by}, at the {dt} peak; {b32:.4f} ms at "
        f"the f32 peak), {live} live pairs per head{simt_txt}")
    del q, k, v, do, o, lse, got
    torch.cuda.empty_cache()
    return dict(backward_route=route, max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=b, bound_by=by,
                library_ms=lib, bound_f32_ms=b32, simt_ms=simt_ms,
                simt_reading=simt_reading if route == "mma" else None)


def train_steps(step, params, state, batches, dev):
    """``step`` over ``batches`` (numpy dicts): [(loss, grad_norm, ms)]."""
    import torch

    out = []
    for batch in batches:
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, tb)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        out.append((loss, float(m["grad_norm"]), (time.perf_counter() - t0) * 1e3))
    return out


def union_ms(intervals) -> float:
    """The length in ms of the union of (start, end) intervals in µs: the
    time at least one of them covers (kernels on two streams overlap)."""
    total, lo, hi = 0.0, None, None
    for start, end in sorted(intervals):
        if hi is None or start > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


def train_profile(step, params, state, batch, wall_ms: float, dev):
    """One step under torch.profiler: the device's busy share against the
    untraced wall (the union of the kernels' intervals: the backward's dQ
    kernel runs on a second stream beside its dK/dV kernel), the backward's
    share (the union of its kernels' intervals) and the forward kernel's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, state, tb)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_sum = sum(e.self_device_time_total for e in events) / 1e3
    if device_sum <= 0 or not kernels:
        say("[train] under torch.profiler: no device time in the trace; busy share not measured")
        return None

    def is_bwd(name):
        return "flash_bwd" in name or "delta_kernel" in name

    busy = union_ms((e.time_range.start, e.time_range.end) for e in kernels)
    bwd = union_ms((e.time_range.start, e.time_range.end) for e in kernels if is_bwd(e.name))
    bwd_events = [e for e in events if is_bwd(e.key)]
    fwd = sum(e.self_device_time_total for e in events if "flash_wgmma" in e.key) / 1e3  # the tensor-core forward
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    say(f"[train] one (1, 8192) step under torch.profiler: device busy {busy:.1f} ms of the untraced wall "
        f"{wall_ms:.1f} ms (busy share {busy / wall_ms:.3f}; the kernels' times sum to {device_sum:.1f} ms, two "
        f"streams overlapping); the backward {bwd:.1f} ms of the step's time ({bwd / wall_ms:.3f}; its kernels: "
        + ", ".join(f"{e.key.replace('(anonymous namespace)::', '').split('(')[0][-48:]} "
                    f"{e.self_device_time_total / 1e3:.1f} x{e.count}" for e in bwd_events) +
        f"), the forward kernel {fwd:.1f} ms ({fwd / wall_ms:.3f}, forward and remat recompute); top "
        f"device time (ms): " + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} x{e.count}"
                                          for e in top))
    return dict(busy_share=busy / wall_ms, bwd_share=bwd / wall_ms)


def train_cpu_replay(dev):
    """SMOKE qwen2-1.5b in f32 with the flash threshold lowered, three steps
    on the card (the CUDA-core forward and the backward kernel) and on the
    CPU (plain versions) from the same params and batches."""
    import torch

    from repro_torch import configs as C
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.models import model as M
    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    cfg = C.get_smoke(LM_ARCH).replace(compute_dtype=torch.float32, flash_threshold=64 * 64, remat="full")
    B_, S_ = TRAIN_SMOKE_SHAPE
    master = M.init_params(cfg, torch.Generator().manual_seed(SEED + 31), device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, B_, S_, seed=SEED + 32)
    batches = [pipe.batch_at(i) for i in range(TRAIN_SMOKE_STEPS)]
    pipe.close()
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=0)
    runs = {}
    for where in (dev, torch.device("cpu")):
        params = tree_map(lambda t: t.detach().to(where, copy=True), master)
        state = adamw_init(params)
        step = M.make_train_step(cfg, opt)
        before = (k_fa.launches_simt, k_fa.launches_bwd)
        losses = []
        for batch in batches:
            params, state, m = step(params, state, {k: torch.as_tensor(v).to(where) for k, v in batch.items()})
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        runs[where.type] = (losses, tree_map(lambda t: t.detach().to("cpu", copy=True), params),
                            (k_fa.launches_simt - before[0], k_fa.launches_bwd - before[1]))
    (card_l, card_p, card_n), (cpu_l, cpu_p, _) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card_l, cpu_l))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(card_l, cpu_l))
    dp = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)))
    n_moved = sum(int(((a - b).abs() > 1e-3 * TRAIN_LR).sum()) for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)))
    n_all = sum(a.numel() for a in tree_leaves(cpu_p))
    layers = cfg.n_layers * TRAIN_SMOKE_STEPS
    say(f"[train] CPU replay: {cfg.name} SMOKE in f32, flash_threshold 64², (B, S) = {TRAIN_SMOKE_SHAPE}, "
        f"{TRAIN_SMOKE_STEPS} steps of AdamW (lr {TRAIN_LR:g}) on the card (CUDA-core forward {card_n[0]} launches, "
        f"backward {card_n[1]}) and on the CPU (plain versions): losses {[round(x[0], 6) for x in card_l]} against "
        f"{[round(x[0], 6) for x in cpu_l]}, at most {loss_rel:.2e} apart relative (limit {TRAIN_REPLAY_LOSS_RTOL:g}), "
        f"grad_norm {gn_rel:.2e} (limit {TRAIN_REPLAY_LOSS_RTOL * 10:g}); params at most {dp:.3e} apart (limit "
        f"{2 * TRAIN_LR * TRAIN_SMOKE_STEPS:g} = 2·lr a step, Adam's sign-like step on gradients at f32 noise), "
        f"{n_moved} of {n_all} elements more than 1e-3·lr apart")
    check(card_n == (2 * layers, layers), f"[train] CPU replay: the card's flash launches {card_n}, want "
                                          f"{(2 * layers, layers)} (forward + remat recompute, backward)")
    check(loss_rel <= TRAIN_REPLAY_LOSS_RTOL and gn_rel <= 10 * TRAIN_REPLAY_LOSS_RTOL,
          "[train] CPU replay: losses or grad norms apart")
    check(dp <= 2 * TRAIN_LR * TRAIN_SMOKE_STEPS, "[train] CPU replay: params apart")


def train_cli(card):
    """The port's trainer CLI on the card, its ``main`` in this process:
    SIGTERM during step 6 of 10 (a preemption at a known step),
    --resume auto to 10, against an uninterrupted 10-step run."""
    import contextlib
    import io
    import signal
    import tempfile

    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    def run(out, sigterm_in_step=None, *extra):
        make, handler, stdout = M.make_train_step, signal.getsignal(signal.SIGTERM), io.StringIO()

        def make_preempted(*a, **kw):
            step, calls = make(*a, **kw), [0]

            def preempted(*args):
                calls[0] += 1
                if calls[0] == sigterm_in_step:
                    signal.raise_signal(signal.SIGTERM)
                return step(*args)

            return preempted

        M.make_train_step = make_preempted
        try:
            with contextlib.redirect_stdout(stdout):
                rc = T.main(["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "2", "--seq", "16", "--ckpt-every", "3",
                             "--lr", "1e-3", "--steps", "10", "--out", str(out), *extra])
        finally:
            M.make_train_step = make
            signal.signal(signal.SIGTERM, handler)
        check(rc == 0, f"[train] the CLI exited {rc}")
        return stdout.getvalue()

    def metrics(out):
        with open(out / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "a", Path(tmp) / "b"
        run(b)
        check("SIGTERM received" in run(a, 6), "[train] the CLI did not stop on SIGTERM")
        check("restored step 6" in run(a, None, "--resume", "auto"), "[train] the CLI did not resume")
        got, want = metrics(a), metrics(b)
    check([r["step"] for r in got] == list(range(10)) == [r["step"] for r in want], "[train] the CLI's steps")
    worst = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(got, want))
    exact = all(a[k] == b[k] for a, b in zip(got, want) for k in ("loss", "grad_norm", "lr"))
    say(f"[train] CLI: qwen1.5-0.5b SMOKE on the card, SIGTERM in step 6 of 10, --resume auto to 10: "
        f"losses {[round(r['loss'], 5) for r in got]}; against an uninterrupted 10-step run at most {worst:.2e} apart "
        f"relative (limit {TRAIN_CLI_RTOL:g}), bit for bit: {exact}; {time.perf_counter() - t0:.1f} s on {card}")
    check(worst <= TRAIN_CLI_RTOL, "[train] the resumed loss stream leaves the uninterrupted run's")


def phase_train(dev, card):
    """Training for the dense family at published widths: the backward
    kernel against the plain version on five shapes; qwen2-1.5b trained
    through make_train_step and AdamW at (4, 2048) and (1, 8192), the loss
    falling on a constant batch; the SMOKE replay against the CPU; the
    CLI's resume.  Returns the flash launches of the counted run and the
    backward kernel's numbers."""
    import torch

    from repro_torch import configs as C
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.models import model as M
    from repro_torch.train import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    cases = {case[0]: train_bwd_case(dev, gen, case) for case in TRAIN_BWD}

    cfg = C.get(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 33), device=dev)
    state = adamw_init(params)
    n_params = M.count_params(params)
    check(n_params == LM_PARAMS, f"[train] {cfg.name}: {n_params} parameters, the reference counts {LM_PARAMS}")
    fpt = M.model_flops_per_token(cfg)
    step = M.make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
    say(f"[train] {cfg.name}: {lm_widths(cfg)}, d_ff {cfg.d_ff}, remat {cfg.remat!r}, bf16 compute over the f32 "
        f"master; {n_params:,} parameters, model_flops_per_token {fpt:.4e} (6N); the master and AdamW's moments "
        f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB")
    check(cfg.remat == "full" and cfg.flash_threshold == 4096 * 4096, "[train] the published config changed")
    batches = {}
    for shape in (TRAIN_SHORT, TRAIN_LONG):
        pipe = TokenPipeline(cfg.vocab_size, shape[0], shape[1], seed=SEED + 34)
        batches[shape] = [pipe.batch_at(i) for i in range(TRAIN_TIMED_STEPS)]
        pipe.close()
    const = batches[TRAIN_LONG][0]
    flash_steps = TRAIN_TIMED_STEPS + 1 + TRAIN_CONST_STEPS

    # the counted run: the timed steps at both shapes, then the constant batch
    k_fa.launches = k_fa.launches_mma = k_fa.launches_simt = k_fa.launches_bwd = 0
    k_fa.launches_bwd_mma = k_fa.launches_bwd_simt = 0
    timed, peaks = {}, {}
    for shape in (TRAIN_SHORT, TRAIN_LONG):
        torch.cuda.reset_peak_memory_stats()
        timed[shape] = train_steps(step, params, state, batches[shape], dev)
        peaks[shape] = torch.cuda.max_memory_allocated() / 2**30
    losses = [r[0] for r in train_steps(step, params, state, [const] * (1 + TRAIN_CONST_STEPS), dev)]
    torch.cuda.synchronize()
    launches = {"flash_attention_mma": k_fa.launches_mma, "flash_attention": k_fa.launches_simt,
                "flash_attention_bwd": k_fa.launches_bwd, "flash_attention_bwd_mma": k_fa.launches_bwd_mma,
                "flash_attention_bwd_simt": k_fa.launches_bwd_simt}
    want = {"flash_attention_mma": 2 * cfg.n_layers * flash_steps, "flash_attention": 0,
            "flash_attention_bwd": cfg.n_layers * flash_steps, "flash_attention_bwd_mma": cfg.n_layers * flash_steps,
            "flash_attention_bwd_simt": 0}
    step_ms = {}
    for shape in (TRAIN_SHORT, TRAIN_LONG):
        B_, S_ = shape
        after_warmup = [r[2] for r in timed[shape][1:]]
        ms = step_ms[shape] = float(np.median(after_warmup))
        tok_s = B_ * S_ / (ms / 1e3)
        share = fpt * tok_s / PEAK_BF16_FLOPS
        branch = "the plain _sdpa branch" if S_ * S_ <= cfg.flash_threshold else "the flash branch in every layer"
        say(f"[train] (B, S) = {shape}, {branch}: steps {[r[2] for r in timed[shape]]} ms, the first a warm-up; "
            f"the other {len(after_warmup)}: median {ms} ms, min {min(after_warmup)}, max {max(after_warmup)} (losses "
            f"{[round(r[0], 4) for r in timed[shape]]}, grad norms {[round(r[1], 4) for r in timed[shape]]}); at the "
            f"median {tok_s:.0f} tokens/s, 6N FLOPs {share:.4f} of the 989 TFLOP/s bf16 peak; peak memory "
            f"{peaks[shape]:.2f} GiB")
        check(all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in timed[shape]), "[train] a non-finite loss")
    say(f"[train] {1 + TRAIN_CONST_STEPS} steps on one constant (1, 8192) batch (lr {TRAIN_LR:g}, no warmup): losses "
        f"{[round(x, 4) for x in losses]}")
    say(f"[train] flash launches over the counted run ({TRAIN_TIMED_STEPS} + {TRAIN_TIMED_STEPS} + "
        f"{1 + TRAIN_CONST_STEPS} steps, {flash_steps} of them at S = 8192): {json.dumps(launches)}; the code "
        f"predicts {json.dumps(want)} (per flash step and layer: the forward and the remat recompute on the "
        f"tensor-core kernel, one backward on the tensor cores)")
    check(launches == want, "[train] flash launches differ from the prediction")
    check(np.isfinite(losses).all() and losses[-1] < losses[0], f"[train] the loss did not fall: {losses}")
    prof = train_profile(step, params, state, batches[TRAIN_LONG][0], step_ms[TRAIN_LONG], dev)
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()

    train_cpu_replay(dev)
    train_cli(card)
    numbers = dict(cases[TRAIN_BWD[0][0]])
    numbers["train_step_ms"] = step_ms[TRAIN_LONG]  # the median of the steps after the warm-up, and their range
    numbers["train_step_ms_min"] = min(r[2] for r in timed[TRAIN_LONG][1:])
    numbers["train_step_ms_max"] = max(r[2] for r in timed[TRAIN_LONG][1:])
    if prof:
        numbers["train_bwd_share"] = prof["bwd_share"]
    say(f"[train] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, numbers


def plain_strips():
    """A context in which kernels/dynamic.py's four wrappers run their
    plain versions whatever the device (the update's plain replay on the
    card)."""
    import contextlib

    from repro_torch.kernels import dynamic as k_dyn
    from repro_torch.kernels import ref

    @contextlib.contextmanager
    def ctx():
        names = ("strip_dists", "strip_topk", "strip_round_minima", "strip_round_minima_from_dists")
        saved = {name: getattr(k_dyn, name) for name in names}

        def dists(rows, X, out=None):
            r = ref.strip_dists(rows, X)
            return r if out is None else out.copy_(r)

        k_dyn.strip_dists = dists
        k_dyn.strip_topk = lambda D, ids, valid, alive, K: ref.strip_topk(D, ids, valid.bool(), alive.bool(), K)
        k_dyn.strip_round_minima = lambda SW, sm, si, lab, E=0: ref.strip_round_minima(SW, sm.bool(), si, lab, E)
        k_dyn.strip_round_minima_from_dists = lambda D, cd, si, rv, al, lab, E=0: ref.strip_round_minima_from_dists(
            D, cd, si, rv.bool(), al.bool(), lab, E)
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(k_dyn, name, fn)

    return ctx()


def exact_counts(reset: bool = False) -> dict:
    from repro_torch.kernels import dynamic as k_dyn

    out = dict(k_dyn.launches)
    if reset:
        for k in k_dyn.launches:
            k_dyn.launches[k] = 0
    return out


def state_equal(a, b) -> list:
    """The DynState fields on which two states differ (torch.equal, on the
    host when their devices differ)."""
    return [f for f in a._fields if not torch_equal(getattr(a, f), getattr(b, f))]


def torch_equal(x, y) -> bool:
    import torch

    return x.dtype == y.dtype and bool(torch.equal(x.cpu(), y.cpu()) if x.device != y.device else torch.equal(x, y))


def mst_weight(state) -> float:
    from repro_torch.core import dynamic_torch as dt

    return float(dt.state_mst_weights(state).double().sum())


def against_rebuild(tag, state, min_pts):
    """The maintained state against a rebuild from scratch of the same X and
    alive mask: knn_dst and cd bit for bit, knn_idx identical but where a
    row's differing entries all sit at its K-th distance (a new point at
    exactly the horizon leaves the row alone: the insert rule's strict
    <), MST weight within 1e-6 relative, the same partition.  Returns the
    rebuilt state and the count of rows with such ties."""
    import torch

    from repro_torch.core import dynamic_torch as dt
    from repro_torch.kernels import dynamic as k_dyn
    from repro_torch.kernels import ops

    counts = exact_counts()
    fresh = dt.rebuild(state, min_pts=min_pts)
    k_dyn.launches.update(counts)  # the check's launches are not the path's
    check(bool(torch.equal(state.knn_dst, fresh.knn_dst)), f"{tag}: knn_dst differs from a rebuild")
    check(bool(torch.equal(state.cd, fresh.cd)), f"{tag}: cd differs from a rebuild")
    differ = state.knn_idx != fresh.knn_idx
    at_kth = state.knn_dst == state.knn_dst[:, -1:]
    check(not bool((differ & ~at_kth).any()), f"{tag}: knn_idx differs from a rebuild off the K-th distance")
    tied = int(differ.any(1).sum())
    w, wf = mst_weight(state), mst_weight(fresh)
    check(abs(w - wf) <= 1e-6 * abs(wf), f"{tag}: MST weight {w} against the rebuild's {wf}")
    a, _, _ = ops.incremental_recluster(state, float(min_pts))
    b, _, _ = ops.incremental_recluster(fresh, float(min_pts))
    check(_same_partition(a.labels, b.labels), f"{tag}: the partition differs from the rebuild's")
    return fresh, b, tied


def phase_exact(dev, card):
    """The exact-dynamic engine on the card (see the module docstring)."""
    import copy

    import torch

    from repro_torch import StreamingClusterEngine
    from repro_torch.serving.stream import ClusterSnapshot

    rng = np.random.default_rng(SEED + 23)
    n_new = EXACT_BLOCKS // 2 * EXACT_BLOCK + EXACT_FULL_BLOCK
    data = mixture(rng, EXACT_N + n_new + EXACT_BLOCKS * QUERY_CHUNK // EXACT_QUERY_EVERY) + 50.0
    X0, Xnew, Qs = data[:EXACT_N], data[EXACT_N : EXACT_N + n_new], data[EXACT_N + n_new :]
    eng = StreamingClusterEngine(DIM, min_pts=MIN_PTS, exact=True, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pids = list(eng.ingest(X0))
    torch.cuda.synchronize()
    h = eng._dyn
    say(f"[exact] build: {EXACT_N} points ingested and the first rebuild in {time.perf_counter() - t0:.2f} s; "
        f"Np = {h.capacity} slots, rk_cap {h._eff_cap(EXACT_BLOCK)}, s_cap {h._eff_s_cap(EXACT_BLOCK)} at blocks of "
        f"{EXACT_BLOCK}; snapshot v{eng.snapshot.version} with {eng.snapshot.n_clusters} clusters")
    Np = 1 << (int(1.5 * EXACT_N) - 1).bit_length()  # the shrink's bucket: 32,768 at 16,384 points
    check(h.capacity == Np and eng.stats["exact_rebuilds"] == 1 and eng.snapshot.n_points == EXACT_N,
          f"[exact] build: capacity {h.capacity}, rebuilds {eng.stats['exact_rebuilds']}")
    against_rebuild("[exact] build", h.state, MIN_PTS)

    exact_counts(reset=True)
    tally = dict(tied=0, plain=0, served=0)
    overflows = {"insert": 0, "delete": 0, "small delete": 0}
    walls = {"insert": [], "delete": []}
    off = 0

    def block(b, kind, size, plain):
        """One checked block through the engine: incremental, against a
        rebuild from scratch, optionally against its plain replay."""
        nonlocal off
        before = (h.state, list(h._free), dict(h.stats))
        inc0, ov0 = eng.stats["incremental_blocks"], h.stats["overflow_rebuilds"]
        if kind == "insert":
            Xb = Xnew[off : off + size]
            off += size
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pids.extend(eng.ingest(Xb))
        else:
            pos = sorted(rng.choice(len(pids), size=size, replace=False).tolist(), reverse=True)
            gone = [pids.pop(i) for i in pos]
            slots = [eng._pid2slot[p] for p in gone]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.retire(gone)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        check(eng.stats["incremental_blocks"] == inc0 + 1 and h.ok, f"[exact] block {b} did not run incrementally")
        overflowed = h.stats["overflow_rebuilds"] > ov0
        _, fresh_res, tied = against_rebuild(f"[exact] block {b}", h.state, MIN_PTS)
        tally["tied"] += tied
        if plain:  # the same update from the same state through the plain versions, on the card
            twin = copy.copy(h)
            twin._free, twin.stats = before[1], before[2]
            twin.state = before[0]
            with plain_strips():
                if kind == "insert":
                    twin.insert_block(Xb)
                else:
                    twin.delete_block(slots)
            bad = state_equal(twin.state, h.state)
            check(not bad, f"[exact] block {b}: the plain replay differs in {bad}")
            tally["plain"] += 1
        return wall, overflowed, fresh_res

    stream_t0 = time.perf_counter()
    for b in range(EXACT_BLOCKS):
        kind = "insert" if b % 2 == 0 else "delete"
        wall, overflowed, fresh_res = block(b, kind, EXACT_BLOCK, b == 0 or b % EXACT_PLAIN_EVERY == EXACT_PLAIN_EVERY - 1)
        walls[kind].append(wall)
        overflows[kind] += overflowed
        if b % EXACT_QUERY_EVERY == EXACT_QUERY_EVERY - 1:
            Q = Qs[tally["served"] * QUERY_CHUNK : (tally["served"] + 1) * QUERY_CHUNK]
            got = eng.query_detailed(Q)
            snap = eng.snapshot
            rebuilt = ClusterSnapshot(version=10**9 + b, n_points=snap.n_points, bubble_rep=snap.bubble_rep,
                                      bubble_n=snap.bubble_n, center=snap.center, result=fresh_res,
                                      wall_seconds=0.0)
            want = eng.query_detailed(Q, snapshot=rebuilt)
            check(np.array_equal(got.bubble_index, want.bubble_index), f"[exact] block {b}: served rows differ")
            lab = dict(zip(snap.bubble_labels.tolist(), fresh_res.labels.tolist()))
            mapped = np.array([lab.get(int(x), -1) if x != -1 else -1 for x in got.labels])
            check(np.array_equal(mapped, want.labels), f"[exact] block {b}: served labels differ from the rebuild's")
            tally["served"] += 1
    n_small, small = EXACT_SMALL_DELETES
    small_walls = []
    for j in range(n_small):
        wall, overflowed, _ = block(EXACT_BLOCKS + j, "delete", small, j == 0)
        small_walls.append(wall)
        overflows["small delete"] += overflowed
    check(overflows["small delete"] == 0, f"[exact] a delete block of {small} overflowed: the delete rule never ran")
    stream_s = time.perf_counter() - stream_t0
    launches = exact_counts()
    check(all(launches[k] > 0 for k in EXACT_KERNELS) and launches["strip_round_minima"] == 0
          and all(launches[k] == 0 for k in STRIP_ORACLES),
          f"[exact] stream launches {launches}: the first round-minima, distance and top-k kernels are oracles only")
    say(f"[exact] stream: {EXACT_BLOCKS} alternating blocks of {EXACT_BLOCK} ({EXACT_BLOCK / EXACT_N:.2%} of n) and "
        f"{n_small} delete blocks of {small}, every one routed incremental and checked against a rebuild from "
        f"scratch (knn_dst, cd bit for bit; {tally['tied']} rows whose knn_idx differ only at the K-th distance; MST "
        f"weight within 1e-6; partition equal); overflow rebuilds (RkNN or S' past its bucket) {overflows}; "
        f"{tally['plain']} updates bit for bit their plain replay on the card; {tally['served']} served chunks of "
        f"{QUERY_CHUNK} rows equal to the rebuilt snapshot's; {stream_s:.2f} s with the checks; block wall (update + "
        f"refresh, ms) insert p50 {np.median(walls['insert']):.2f}, delete p50 {np.median(walls['delete']):.2f}, "
        f"delete of {small} p50 {np.median(small_walls):.2f}; launches {launches}")

    # one block past the policy's crossover: routed full, rebuilt at the refresh
    full0, reb0 = eng.stats["exact_full_blocks"], eng.stats["exact_rebuilds"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pids += eng.ingest(Xnew[off : off + EXACT_FULL_BLOCK])
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    check(eng.stats["exact_full_blocks"] == full0 + 1 and eng.stats["exact_rebuilds"] == reb0 + 1,
          f"[exact] a {EXACT_FULL_BLOCK}-point block did not route full: {eng.stats}")
    against_rebuild("[exact] full block", h.state, MIN_PTS)
    say(f"[exact] one insert block of {EXACT_FULL_BLOCK} ({EXACT_FULL_BLOCK / eng.tree.n_points:.2%}): routed full "
        f"and rebuilt at the refresh, {full_ms:.1f} ms; exact_full_blocks {eng.stats['exact_full_blocks']}, "
        f"exact_rebuilds {eng.stats['exact_rebuilds']}")

    # an overflow drill: a handle with RkNN and S' buckets of 8
    live = eng.tree.alive_points()[1]
    drill = eng.backend.make_dynamic(MIN_PTS, DIM, capacity=h.capacity, rk_cap=8, s_cap=8)
    drill.load(live)
    drill.insert_block(Xnew[:EXACT_BLOCK] + 0.01)
    check(drill.stats["overflow_rebuilds"] >= 1 and drill.ok, f"[exact] overflow drill: {drill.stats}")
    against_rebuild("[exact] overflow drill", drill.state, MIN_PTS)
    say(f"[exact] overflow drill: rk_cap = s_cap = 8, an insert block of {EXACT_BLOCK} flipped ok and the handle "
        f"rebuilt ({drill.stats['overflow_rebuilds']} overflow rebuilds); the state equals a rebuild's")
    del drill

    exact_cpu_replay(dev)
    exact_times(dev, eng, rng)
    numbers = exact_kernels(dev, h, EXACT_BLOCK + h._eff_cap(EXACT_BLOCK), Qs)
    return launches, numbers


def exact_cpu_replay(dev):
    """The same kind of stream at reduced depth on the card and through the
    port's CPU engine: versions and partitions at every snapshot, MST
    weight within 1e-6; the cd / knn_dst rows that differ bitwise; then
    the update rules on two handles (card, CPU) whose S' bucket holds
    every slot, every field equal."""
    from repro_torch import StreamingClusterEngine
    from repro_torch.kernels import ops

    n, blk, blocks = EXACT_CPU
    rng = np.random.default_rng(SEED + 24)
    data = mixture(rng, n + blocks * blk) + 50.0
    card = StreamingClusterEngine(DIM, min_pts=MIN_PTS, exact=True, device=dev)
    host = StreamingClusterEngine(DIM, min_pts=MIN_PTS, exact=True, device="cpu")
    t0 = time.perf_counter()
    pids = [card.ingest(data[:n]), host.ingest(data[:n])]
    check(pids[0] == pids[1], "[exact] cpu replay: point ids differ")
    pids = pids[0]
    diff_rows, snaps, off = 0, 0, n
    for b in range(blocks + 1):
        if b:
            if b % 2:
                got = [e.ingest(data[off : off + blk]) for e in (card, host)]
                check(got[0] == got[1], f"[exact] cpu replay block {b}: point ids differ")
                pids += got[0]
                off += blk
            else:
                pos = sorted(rng.choice(len(pids), size=blk, replace=False).tolist(), reverse=True)
                gone = [pids.pop(i) for i in pos]
                for e in (card, host):
                    e.retire(gone)
        a, c = card.snapshot, host.snapshot
        check(a.version == c.version, f"[exact] cpu replay block {b}: versions {a.version} / {c.version}")
        check(_same_partition(a.bubble_labels, c.bubble_labels), f"[exact] cpu replay block {b}: partitions differ")
        wa, wc = float(np.sum(a.mst[2])), float(np.sum(c.mst[2]))
        check(abs(wa - wc) <= 1e-6 * abs(wc), f"[exact] cpu replay block {b}: MST weight {wa} / {wc}")
        sa, sc = card._dyn.state, host._dyn.state
        rows = (sa.cd.cpu() != sc.cd) | (sa.knn_dst.cpu() != sc.knn_dst).any(1)
        diff_rows += int(rows.sum())
        snaps += 1
    check(card.stats["incremental_blocks"] == host.stats["incremental_blocks"] > 0,
          f"[exact] cpu replay: incremental blocks {card.stats['incremental_blocks']} / {host.stats['incremental_blocks']}")
    ovf = [e._dyn.stats["overflow_rebuilds"] for e in (card, host)]
    check(ovf[0] == ovf[1], f"[exact] cpu replay: overflow rebuilds {ovf}")
    say(f"[exact] cpu replay: {n} points, {blocks} alternating blocks of {blk} on the card and through the CPU engine "
        f"({ovf[0]} overflow rebuilds on each, the same blocks): "
        f"{snaps} snapshots with equal versions and partitions, MST weight within 1e-6; cd / knn_dst rows that "
        f"differ bitwise, summed over the snapshots: {diff_rows}; {time.perf_counter() - t0:.1f} s")
    check(diff_rows == 0, f"[exact] cpu replay: {diff_rows} cd / knn_dst rows differ from the CPU's")
    # the update rules themselves on both devices: handles whose S' bucket holds every slot never overflow
    hs = [ops.get_backend(d).make_dynamic(MIN_PTS, DIM, capacity=2 * n, s_cap=2 * n) for d in (dev, "cpu")]
    for hh in hs:
        hh.load(data[:n])
    alive = list(range(n))
    for b in range(4):
        if b % 2 == 0:
            for hh in hs:
                slots = hh.insert_block(data[n + b * blk : n + (b + 1) * blk])
            alive += slots
        else:
            drop = [alive.pop(i) for i in sorted(rng.choice(len(alive), size=blk, replace=False).tolist(), reverse=True)]
            for hh in hs:
                hh.delete_block(drop)
        check(all(hh.stats["overflow_rebuilds"] == 0 for hh in hs), f"[exact] handle replay block {b} overflowed")
        bad = state_equal(hs[0].state, hs[1].state)
        check(not bad, f"[exact] handle replay block {b}: the card's state differs from the CPU's in {bad}")
    say(f"[exact] handle replay: {n} points, two insert and two delete blocks of {blk} with s_cap = Np (no overflow) "
        "on the card and the CPU: every state field equal after every block")


def refresh_split(state, wall_ms: float):
    """The hierarchy-only refresh's stages on its own inputs (captured from
    one ops.incremental_recluster, which must launch the extract kernel
    once and the EOM kernel never): single_linkage (the sort and the
    kernel; the kernel alone), condense and extract (and extract_v1, the
    composition it replaced), each by CUDA events, beside the refresh's
    wall on the host clock (``wall_ms``)."""
    import torch

    from repro_torch.core import hierarchy as th
    from repro_torch.kernels import hierarchy as k_h
    from repro_torch.kernels import ops

    seen, real = {}, ops.hierarchy_fixed

    def capture(*args, **kw):
        seen["args"] = args
        return real(*args, **kw)

    before = (k_h.launches_extract, k_h.launches_eom)
    ops.hierarchy_fixed = capture
    try:
        ops.incremental_recluster(state, float(MIN_PTS))
    finally:
        ops.hierarchy_fixed = real
    check((k_h.launches_extract - before[0], k_h.launches_eom - before[1]) == (1, 0),
          "[exact] a refresh did not launch the extract kernel once and the EOM kernel never")
    eu, ev, ew, valid, n_valid, weights, mcs = seen["args"]
    counts = (k_h.launches_single_linkage, k_h.launches_condense, k_h.launches_extract, k_h.launches_eom)
    edges = th.sorted_edges(eu, ev, ew, valid, n_valid)
    slt = k_h.single_linkage_sorted(*edges, weights)
    ct = k_h.condense(slt, weights, mcs)
    split = {"single_linkage": time_ms(lambda: k_h.single_linkage(eu, ev, ew, valid, n_valid, weights), reps=10),
             "condense": time_ms(lambda: k_h.condense(slt, weights, mcs), reps=10),
             "extract": time_ms(lambda: k_h.extract(ct), reps=10)}
    kernel = time_ms(lambda: k_h.single_linkage_sorted(*edges, weights), reps=10)
    host = host_ms(lambda: k_h.extract(ct), reps=10)
    v1_ms, v1_host = time_ms(lambda: k_h.extract_v1(ct), reps=10), host_ms(lambda: k_h.extract_v1(ct), reps=10)
    (k_h.launches_single_linkage, k_h.launches_condense, k_h.launches_extract, k_h.launches_eom) = counts
    torch.cuda.synchronize()
    say(f"[exact] the refresh's stage split at Lp = {eu.shape[0]} ({int(ct.n_labels)} labels; device ms by CUDA events, "
        "each stage alone): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f" (single_linkage's kernel alone {kernel:.4f}; extract's host enqueue {host:.4f} ms per call; extract_v1, "
          f"the composition it replaced, {v1_ms:.4f}, host enqueue {v1_host:.4f}); the rest of "
          f"the {wall_ms:.2f} ms refresh (compaction, weights, the unwrap's one read) "
          f"{wall_ms - sum(split.values()):.2f} ms")


def exact_times(dev, eng, rng):
    """Incremental insert and delete against a rebuild at n = EXACT_N, by
    block size (the card's Fig. 3); the hierarchy-only refresh; the query
    p50; peak memory of a rebuild and an update; host reads in an update
    body and in a refresh (set_sync_debug_mode)."""
    import torch

    from repro_torch.core import dynamic_torch as dt
    from repro_torch.kernels import ops

    h = eng.backend.make_dynamic(MIN_PTS, DIM)
    live = eng.tree.alive_points()[1][:EXACT_N]
    h.load(live, shrink=True)
    fresh = mixture(rng, max(EXACT_TIMED_BLOCKS)) + 50.0

    def wall(fn, reps=3):
        out = []
        for _ in range(reps):
            saved = (h.state, list(h._free), dict(h.stats))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            h.state, h._free, h.stats = saved[0], saved[1], saved[2]
        return float(np.median(out)), h.stats

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rebuild_ms, _ = wall(h.rebuild)
    peak_rebuild = (torch.cuda.max_memory_allocated() - base) / 2**20
    rows, peak_update = [], 0.0
    for B in EXACT_TIMED_BLOCKS:
        ov = []

        def ins():
            h.insert_block(fresh[:B])
            ov.append(h.stats["overflow_rebuilds"])

        drop = rng.choice(h.alive_slots(), size=B, replace=False).tolist()

        def dele():
            h.delete_block(drop)
            ov.append(h.stats["overflow_rebuilds"])

        torch.cuda.reset_peak_memory_stats()
        ins_ms, _ = wall(ins)
        if B == EXACT_BLOCK:
            peak_update = (torch.cuda.max_memory_allocated() - base) / 2**20
        del_ms, _ = wall(dele)
        rows.append((B, B / EXACT_N, ins_ms, del_ms, max(ov)))
    say(f"[exact] times at n = {EXACT_N}, Np = {h.capacity}: rebuild {rebuild_ms:.1f} ms; by block (ms, incremental "
        "update with its one read of ok; an overflowed update includes its rebuild): " + "; ".join(
            f"{B} ({f:.2%}) insert {i:.1f}, delete {d:.1f}{' (overflowed)' if o else ''}" for B, f, i, d, o in rows))
    # the insert of EXACT_BLOCK again through the first route (SW and smask built and held through Borůvka)
    real_route = dt.boruvka_strip_from_dists
    dt.boruvka_strip_from_dists = first_route
    try:
        torch.cuda.reset_peak_memory_stats()
        first_ms, _ = wall(lambda: h.insert_block(fresh[:EXACT_BLOCK]))
        peak_first = (torch.cuda.max_memory_allocated() - base) / 2**20
    finally:
        dt.boruvka_strip_from_dists = real_route
    ins_ms = next(r[2] for r in rows if r[0] == EXACT_BLOCK)
    say(f"[exact] an insert of {EXACT_BLOCK}: factor route {ins_ms:.1f} ms, peak device memory above the state "
        f"{peak_update:.0f} MiB; the first route (SW and smask built and held) {first_ms:.1f} ms, "
        f"{peak_first:.0f} MiB; {peak_first - peak_update:.0f} MiB less")

    def crossing(col):
        """The block fraction where the update's time reaches the rebuild's,
        interpolated between the measured blocks."""
        prev = None
        for r in rows:
            if r[col] >= rebuild_ms:
                if prev is None:
                    return f"below {r[1]:.2%}"
                (f0, t0_), (f1, t1) = prev, (r[1], r[col])
                return f"at {f0 + (rebuild_ms - t0_) * (f1 - f0) / (t1 - t0_):.2%} (interpolated)"
            prev = (r[1], r[col])
        return f"beyond {rows[-1][1]:.2%}"

    cross = {"insert": crossing(2), "delete": crossing(3)}
    say("[exact] crossover (the card's Fig. 3): " + ", ".join(f"{k} {v}" for k, v in cross.items())
        + " of n, against UpdatePolicy.max_update_frac = 0.05 (left as it is)")

    s = h.state
    refresh = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, slots, rep = ops.incremental_recluster(s, float(MIN_PTS))
        refresh.append((time.perf_counter() - t0) * 1e3)
    lat = []
    Q = mixture(rng, QUERY_CHUNK * 20) + 50.0
    for i in range(20):
        t0 = time.perf_counter()
        eng.query_detailed(Q[i * QUERY_CHUNK : (i + 1) * QUERY_CHUNK])
        lat.append((time.perf_counter() - t0) * 1e3)
    say(f"[exact] hierarchy-only refresh (ops.incremental_recluster, n = {len(slots)}, Lp = {h.capacity}): "
        + ", ".join(f"{t:.2f}" for t in refresh) + f" ms; query p50 {np.median(lat):.3f} ms per {QUERY_CHUNK}-row "
        f"chunk over the engine's {eng.snapshot.n_bubbles}-row snapshot; peak device memory above the state: "
        f"rebuild {peak_rebuild:.0f} MiB, update (insert of {EXACT_BLOCK}) {peak_update:.0f} MiB")

    refresh_split(s, float(np.median(refresh)))

    # host reads: none in an update body, one (the unwrap) in a refresh
    P = torch.as_tensor(fresh[:EXACT_BLOCK], dtype=torch.float32, device=dev)
    free = torch.as_tensor(h._free[-EXACT_BLOCK:][::-1], device=dev)
    valid = torch.ones(EXACT_BLOCK, dtype=torch.bool, device=dev)
    small = EXACT_SMALL_DELETES[1]  # a delete that stays within its buckets: the whole rule runs
    alive = torch.as_tensor(rng.choice(h.alive_slots(), size=small, replace=False), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = dt.insert_batch(s, P, free, valid, min_pts=MIN_PTS, rk_cap=h._eff_cap(EXACT_BLOCK))
        st = dt.delete_batch(st, alive, valid[:small], min_pts=MIN_PTS, rk_cap=h._eff_cap(small),
                             s_cap=h._eff_s_cap(small))
        out = ops._incremental_pipeline(st.X, st.mst_u, st.mst_v, st.mst_raw, st.mst_valid, st.cd, st.alive,
                                        st.n_alive, float(MIN_PTS))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ops._to_host(out)
    say(f"[exact] an insert body of {EXACT_BLOCK}, a delete body of {small} (ok: {bool(st.ok)}) and a refresh up to its unwrap "
        "under torch.cuda.set_sync_debug_mode('error'): no host synchronisation raised")
    return cross


def exact_kernels(dev, h, U, fresh):
    """The strip kernels at the stream's shapes (U = Bp + rk_cap = 5,376 and
    the rebuild's 32,768 rows, Np = 32,768): the distances and the top-k
    (csrc/strip_tiles.cu) bit for bit their plain versions and their first
    kernels (csrc/dynamic.cu) on tie-free (the stream's state) and
    duplicate-heavy (an integer grid) data, with an Np that is no multiple
    of the tile, a row view at an offset that is no multiple of 16 bytes
    and K = 10, 100 and 2000; new, first-kernel, plain and library times in
    turns and the bounds; an insert block's and a rebuild's strip kernels
    in ``exact_strip_path``; the round minima in ``exact_minima``."""
    import torch

    from repro_torch.kernels import dynamic as k_dyn
    from repro_torch.kernels import ref

    counts = exact_counts()
    X, alive = h.state.X, h.state.alive
    Np, d = X.shape
    gen = np.random.default_rng(SEED + 25)
    ids = torch.as_tensor(gen.choice(Np, size=U, replace=False), device=dev)
    rows = X[ids]
    valid = torch.ones(U, dtype=torch.bool, device=dev)
    out = {}

    errs = dict.fromkeys(EXACT_KERNELS + STRIP_ORACLES, 0.0)

    def same(name, got, want):
        """Every output bit for bit; the largest absolute difference (equal
        infinities masked) goes into the kernel's max_abs_err."""
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            check(bool(torch.equal(g, w)), f"[exact] {name}: differs from the plain version")
            kernel = name.split()[0]
            g, w = g.reshape(-1), w.reshape(-1)
            for i in range(0, w.numel(), 1 << 26):  # in chunks: the rebuild's square is 2^30 entries
                a, b = g[i : i + (1 << 26)], w[i : i + (1 << 26)]
                if b.is_floating_point():
                    both = torch.isinf(a) & (a == b)
                    a, b = a.masked_fill(both, 0.0), b.masked_fill(both, 0.0)
                errs[kernel] = max(errs[kernel], abs_diff(a, b))

    def both(name, fn, fn_v1, plain, *args):
        """The new kernel and the first against the plain version's result."""
        want = plain(*args)
        same(name, fn(*args), want)
        same(name.replace(" ", "_v1 ", 1) if " " in name else name + "_v1", fn_v1(*args), want)
        return want

    oracle0 = {k: k_dyn.launches[k] for k in STRIP_ORACLES}
    # strip_dists: the insert strip, a ragged Np of integer-grid rows, the rebuild's square
    grid = torch.as_tensor(gen.integers(-6, 7, size=(Np - 13, d)), dtype=torch.float32, device=dev)
    D = both("strip_dists strip", k_dyn.strip_dists, k_dyn.strip_dists_v1, ref.strip_dists, rows, X)
    both("strip_dists grid", k_dyn.strip_dists, k_dyn.strip_dists_v1, ref.strip_dists, grid[:777], grid)
    both("strip_dists square", k_dyn.strip_dists, k_dyn.strip_dists_v1, ref.strip_dists, X, X)
    # a row slice at an offset that is no multiple of 16 bytes (Np - 13 is odd), as the insert writes D_strip[Bp:]
    buf = torch.full((779, Np - 13), -7.0, device=dev)
    k_dyn.strip_dists(grid[:777], grid, out=buf[1:778])
    same("strip_dists row slice", buf[1:778], ref.strip_dists(grid[:777], grid))
    check(bool((buf[0] == -7.0).all()) and bool((buf[778] == -7.0).all()),
          "[exact] strip_dists wrote outside its row slice")
    del buf
    torch.cuda.empty_cache()
    t = dict(zip(("new", "v1"), in_turns(lambda: k_dyn.strip_dists(rows, X), lambda: k_dyn.strip_dists_v1(rows, X),
                                         reps=10)))
    t_sq = dict(zip(("new", "v1"), in_turns(lambda: k_dyn.strip_dists(X, X), lambda: k_dyn.strip_dists_v1(X, X),
                                            reps=3)))
    plain = time_ms(lambda: ref.strip_dists(rows, X), reps=1, warm=1)
    lib = time_ms(lambda: torch.cdist(rows, X), reps=10)
    lib_sq = time_ms(lambda: torch.cdist(X, X), reps=3, warm=1)
    torch.cuda.empty_cache()

    def dist_bounds(n):
        """(bound, by) of an (n, Np) strip: the larger of its bytes and its
        3·n·Np·d FP32 instructions (no FMA) at half the FMA peak; and both."""
        nbytes = 4.0 * (n * Np + (n + Np) * d)
        b_ops, _ = bound_ms(3.0 * n * Np * d, 0.0, PEAK_F32_FLOPS / 2)
        b_bytes, _ = bound_ms(0.0, nbytes)
        b, by = bound_ms(3.0 * n * Np * d, nbytes, PEAK_F32_FLOPS / 2)
        return b, by, b_bytes, b_ops

    b, by, b_bytes, b_ops = dist_bounds(U)
    b_sq, by_sq, b_sq_bytes, b_sq_ops = dist_bounds(Np)
    out["strip_dists"] = dict(max_abs_err=errs["strip_dists"], ms=t["new"], plain_ms=plain, bound_ms=b, bound_by=by,
                              library_ms=lib, v1_ms=t["v1"], bytes_bound_ms=b_bytes, instr_bound_ms=b_ops,
                              square_ms=t_sq["new"], square_v1_ms=t_sq["v1"], square_bound_ms=b_sq,
                              square_library_ms=lib_sq)
    out["strip_dists_v1"] = dict(max_abs_err=errs["strip_dists_v1"], ms=t["v1"], plain_ms=plain, bound_ms=b,
                                 bound_by=by, library_ms=lib, square_ms=t_sq["v1"])
    say(f"[exact] strip_dists ({U} x {Np}, d = {d}; csrc/strip_tiles.cu): kernel {t['new']:.4f} ms, the first kernel "
        f"{t['v1']:.4f} ({t['v1'] / t['new']:.2f}x; in turns), plain {plain:.2f}, cdist {lib:.4f}, bound {b:.4f} "
        f"({by}: bytes {b_bytes:.4f}, 3·U·Np·d FP32 instructions at half the FMA peak {b_ops:.4f}); the rebuild's "
        f"{Np} x {Np}: kernel {t_sq['new']:.3f} ms, the first kernel {t_sq['v1']:.3f}, cdist {lib_sq:.3f}, bound "
        f"{b_sq:.3f} ({by_sq}: bytes {b_sq_bytes:.3f}, instructions {b_sq_ops:.3f}); bit for bit the plain version "
        f"and the first kernel (also a 777 x {Np - 13} integer grid and a row slice of it at an odd offset)")

    # strip_topk at K = 10 (the path's), 100 and 2000: the strip, the grid (Np % 4 = 3), a row view off 16 bytes
    Dg = ref.strip_dists(grid[:777], grid)
    g_alive = torch.as_tensor(gen.random(Np - 13) < 0.8, device=dev)
    g_ids = torch.arange(777, device=dev)
    g_valid = torch.ones(777, dtype=torch.bool, device=dev)
    for K in EXACT_TOPK:
        both(f"strip_topk K={K}", k_dyn.strip_topk, k_dyn.strip_topk_v1, ref.strip_topk, D, ids, valid, alive, K)
        both(f"strip_topk grid K={K}", k_dyn.strip_topk, k_dyn.strip_topk_v1, ref.strip_topk, Dg, g_ids, g_valid,
             g_alive, K)
        both(f"strip_topk view K={K}", k_dyn.strip_topk, k_dyn.strip_topk_v1, ref.strip_topk, Dg[1:], g_ids[1:],
             g_valid[1:], g_alive, K)
    sw = []
    for K in EXACT_TOPK:
        a, c = in_turns(lambda: k_dyn.strip_topk(D, ids, valid, alive, K),
                        lambda: k_dyn.strip_topk_v1(D, ids, valid, alive, K), reps=5)
        sw.append((K, a, c, bound_ms(0.0, 4.0 * U * Np + Np + U * (4 + 1 + 8 * K))[0]))
    ms, ms_v1 = sw[0][1], sw[0][2]
    plain = time_ms(lambda: ref.strip_topk(D, ids, valid, alive, MIN_PTS), reps=1, warm=1)
    iota = torch.arange(Np, device=dev)
    Dm = torch.where(alive[None, :] & (iota[None, :] != ids[:, None]), D, float("inf"))
    lib = time_ms(lambda: torch.topk(Dm, MIN_PTS, dim=1, largest=False), reps=10)
    b, by = bound_ms(0.0, 4.0 * U * Np + Np + U * (4 + 1 + 8 * MIN_PTS))
    by_k = {K: dict(ms=a, v1_ms=c, bound_ms=bb) for K, a, c, bb in sw}
    out["strip_topk"] = dict(max_abs_err=errs["strip_topk"], ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                             library_ms=lib, v1_ms=ms_v1, k100=by_k[100], k2000=by_k[K_STRIP])
    out["strip_topk_v1"] = dict(max_abs_err=errs["strip_topk_v1"], ms=ms_v1, plain_ms=plain, bound_ms=b, bound_by=by,
                                library_ms=lib, k100_ms=by_k[100]["v1_ms"], k2000_ms=by_k[K_STRIP]["v1_ms"])
    say(f"[exact] strip_topk ({U} x {Np}, K = {MIN_PTS}; csrc/strip_tiles.cu): kernel {ms:.4f} ms, the first kernel "
        f"{ms_v1:.4f} ({ms_v1 / ms:.2f}x; in turns), plain {plain:.2f}, torch.topk on the masked strip {lib:.4f}, "
        f"bound {b:.4f} ({by}); by K (kernel / first kernel / bound): " + ", ".join(
            f"{K}: {a:.4f} / {c:.4f} / {bb:.4f}" for K, a, c, bb in sw) + "; bit for bit the plain version and the "
        f"first kernel at every K, also on a 777 x {Np - 13} integer grid and a row view of it off 16 bytes")
    del Dm, Dg

    del D
    out["strip_dists"].update(exact_strip_path(dev, h, fresh))  # insert and rebuild: both strip kernels' device time
    for k in STRIP_ORACLES:
        out[k]["launches_oracle"] = k_dyn.launches[k] - oracle0[k]
        check(out[k]["launches_oracle"] > 0, f"[exact] {k} never ran as the oracle")
    out.update(exact_minima(dev, h, fresh))
    k_dyn.launches.update(counts)  # the checks' launches are not the path's
    return out


def timed_strips(which: str, spans: list):
    """A context in which kernels/dynamic.py's strip_dists and strip_topk
    launch the redesigned kernels (``which`` "new") or the first ones
    ("v1"), each call bracketed by CUDA events appended to ``spans``: the
    device time of each strip launch, whatever the host does between."""
    import contextlib

    import torch

    from repro_torch.kernels import dynamic as k_dyn

    def timed(fn):
        def call(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans.append((a, b))
            return out

        return call

    @contextlib.contextmanager
    def ctx():
        saved = k_dyn.strip_dists, k_dyn.strip_topk
        base = (k_dyn.strip_dists_v1, k_dyn.strip_topk_v1) if which == "v1" else saved
        k_dyn.strip_dists, k_dyn.strip_topk = timed(base[0]), timed(base[1])
        try:
            yield
        finally:
            k_dyn.strip_dists, k_dyn.strip_topk = saved

    return ctx()


def exact_strip_path(dev, h, fresh):
    """One insert block of EXACT_BLOCK unseen points on the stream's final
    state (``dt.insert_batch``: two strip_dists and two strip_topk launches
    into one 5,376 x 32,768 strip) and one rebuild of that state
    (``dt.rebuild``: the 32,768² square and its top-k), through the
    redesigned kernels and through the first ones: the states equal, walls
    in turns, and the strip launches' device time (CUDA events around each
    launch, the mean of the two calls of each)."""
    import torch

    from repro_torch.core import dynamic_torch as dt

    P = torch.as_tensor(fresh[:EXACT_BLOCK], dtype=torch.float32, device=dev)
    free = torch.as_tensor(h._free[-EXACT_BLOCK:][::-1], device=dev)
    valid = torch.ones(EXACT_BLOCK, dtype=torch.bool, device=dev)
    rk_cap = h._eff_cap(EXACT_BLOCK)
    calls = {"insert": lambda: dt.insert_batch(h.state, P, free, valid, min_pts=MIN_PTS, rk_cap=rk_cap),
             "rebuild": lambda: dt.rebuild(h.state, min_pts=MIN_PTS)}
    res = {}
    for name, fn in calls.items():
        a = fn()
        with timed_strips("v1", []):
            b = fn()
        bad = state_equal(a, b)
        check(not bad, f"[exact] the {name} through the first strip kernels differs in {bad}")
        del a, b
        walls, spans = {"new": [], "v1": []}, {"new": [], "v1": []}
        for which in ("new", "v1", "v1", "new"):
            with timed_strips(which, spans[which]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[which].append((time.perf_counter() - t0) * 1e3)
        launches = {w: len(v) // 2 for w, v in spans.items()}
        check(launches["new"] == launches["v1"] > 0, f"[exact] strip launches in the {name}: {launches}")
        strip_ms = {w: sum(x.elapsed_time(y) for x, y in v) / 2 for w, v in spans.items()}
        res[name] = dict(wall_ms=min(walls["new"]), v1_wall_ms=min(walls["v1"]), strip_device_ms=strip_ms["new"],
                         v1_strip_device_ms=strip_ms["v1"], strip_launches=launches["new"])
        say(f"[exact] one {name} ({'a block of ' + str(EXACT_BLOCK) if name == 'insert' else 'Np = ' + str(h.capacity)}) "
            f"through the redesigned strip kernels / the first ones, states equal: wall (ms, in turns) "
            f"{', '.join(f'{w:.2f}' for w in walls['new'])} / {', '.join(f'{w:.2f}' for w in walls['v1'])}; device "
            f"time of its {launches['new']} strip launches (CUDA events around each) {strip_ms['new']:.3f} / "
            f"{strip_ms['v1']:.3f} ms")
    return res


def built_strip(D, cd, sids, rv, alive):
    """SW and smask as ``dt.insert_batch`` built them before the factor
    route: ``max(max(D, cd[sids]), cd)``, +inf off ``rv & alive & (col !=
    sids)``."""
    import torch

    iota = torch.arange(D.shape[1], device=D.device)
    smask = rv[:, None] & alive[None, :] & (iota[None, :] != sids[:, None].long())
    SW = torch.maximum(D, cd[sids.long()][:, None])
    SW = torch.maximum(SW, cd[None, :], out=SW)
    return SW.masked_fill_(~smask, float("inf")), smask


def first_route(eu, ev, ew, evalid, sids, D, cd, rv, alive, n):
    """``boruvka_strip_from_dists`` through the first route: SW and smask
    built and held through ``boruvka_strip`` (the update before the factor
    route)."""
    from repro_torch.core import mst

    return mst.boruvka_strip(eu, ev, ew, evalid, sids, *built_strip(D, cd, sids, rv, alive), n)


def exact_minima(dev, h, fresh):
    """The round minima at the stream's shapes.  One insert block of
    EXACT_BLOCK points of ``fresh`` (unseen points of the stream's mixture)
    on the stream's final state (``dt.insert_batch``) is captured: its distance strip (U = 5,376 rows by Np = 32,768), core
    distances, strip ids, row validity (Bp rows and rk_n RkNN rows valid),
    live slots and its Borůvka's labels in every round.  Then: the factor
    kernel bit for bit its plain version and the first kernel (fed the SW
    and smask built from the same factors) for each label set of
    EXACT_MINIMA_LABELS with all rows valid and with the stream's rows,
    timed beside the first kernel, with the bound of the entries that the
    inputs make active (4 bytes each) and the vectors; the whole strip live
    (every column, every row: the bound of D read once);
    every round of the captured Borůvka; the Borůvka through both routes
    (buffers equal, walls in turns, torch.profiler's device time of the
    strip kernels); the update's state through both routes, equal."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dynamic_torch as dt
    from repro_torch.core import mst
    from repro_torch.kernels import dynamic as k_dyn
    from repro_torch.kernels import ref

    P = torch.as_tensor(fresh[:EXACT_BLOCK], dtype=torch.float32, device=dev)
    free = torch.as_tensor(h._free[-EXACT_BLOCK:][::-1], device=dev)
    valid = torch.ones(EXACT_BLOCK, dtype=torch.bool, device=dev)
    rk_cap = h._eff_cap(EXACT_BLOCK)
    seen, labs = {}, []
    real_route, real_kernel = dt.boruvka_strip_from_dists, k_dyn.strip_round_minima_from_dists

    def capture(*args):
        seen["args"] = args
        return real_route(*args)

    def record(D, cd, sids, rv, alive, lab, E=0, **kw):
        labs.append(lab.clone())
        return real_kernel(D, cd, sids, rv, alive, lab, E, **kw)

    dt.boruvka_strip_from_dists, k_dyn.strip_round_minima_from_dists = capture, record
    try:
        after = dt.insert_batch(h.state, P, free, valid, min_pts=MIN_PTS, rk_cap=rk_cap)
    finally:
        dt.boruvka_strip_from_dists, k_dyn.strip_round_minima_from_dists = real_route, real_kernel
    dt.boruvka_strip_from_dists = first_route
    try:
        after_first = dt.insert_batch(h.state, P, free, valid, min_pts=MIN_PTS, rk_cap=rk_cap)
    finally:
        dt.boruvka_strip_from_dists = real_route
    bad = state_equal(after, after_first)
    check(not bad, f"[exact] an insert block's state through the factor route differs from the first route's in {bad}")
    eu, ev, ew, evalid, sids, D, cd, rv, alive, n = seen["args"]
    U, E = D.shape[0], eu.shape[0]
    iota = torch.arange(n, device=dev)
    ones = torch.ones(U, dtype=torch.bool, device=dev)
    err = 0.0
    old_before = k_dyn.launches["strip_round_minima"]

    def equal(tag, got, want):
        nonlocal err
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and bool(torch.equal(g, w)), f"[exact] {tag}: differs")
            if w.is_floating_point():
                both = torch.isinf(g) & (g == w)
                g, w = g.masked_fill(both, 0.0), w.masked_fill(both, 0.0)
            err = max(err, abs_diff(g, w))

    def active(rows, lab, live):
        slab = lab[sids.long()]
        return sum(int((rows[r0 : r0 + 1024, None] & live[None, :] & (slab[r0 : r0 + 1024, None] != lab[None, :])).sum())
                   for r0 in range(0, U, 1024))

    vectors = 4.0 * n + n + 8.0 * n + 4.0 * U + U + 12.0 * (U + n)  # cd, alive, lab, sids, rows; the outputs

    def case(tag, rows, lab, live, plain=False):
        """One label set: bitwise checks, times and bounds."""
        got = k_dyn.strip_round_minima_from_dists(D, cd, sids, rows, live, lab, E)
        SW, smask = built_strip(D, cd, sids, rows, live)
        equal(f"{tag}: the factor kernel against the first", got, k_dyn.strip_round_minima(SW, smask, sids, lab, E))
        equal(f"{tag}: the factor kernel against its plain version", got,
              ref.strip_round_minima_from_dists(D, cd, sids, rows, live, lab, E))
        acts = active(rows, lab, live)

        def factor():
            return k_dyn.strip_round_minima_from_dists(D, cd, sids, rows, live, lab, E)

        def first():
            return k_dyn.strip_round_minima(SW, smask, sids, lab, E)

        r = dict(active=acts, ms=time_ms(factor, reps=20), old_ms=time_ms(first, reps=5),
                 device_ms=device_ms(factor), old_device_ms=device_ms(first, reps=3))
        r["bound_ms"], r["bound_by"] = bound_ms(0.0, 4.0 * acts + vectors)
        r["old_bound_ms"], _ = bound_ms(0.0, 1.0 * U * n + 4.0 * acts + vectors)  # smask whole, SW where active
        if plain:
            r["plain_ms"] = time_ms(lambda: ref.strip_round_minima_from_dists(D, cd, sids, rows, live, lab, E),
                                    reps=1, warm=1)
            r["old_plain_ms"] = time_ms(lambda: ref.strip_round_minima(SW, smask, sids, lab, E), reps=1, warm=1)
        del SW, smask
        say(f"[exact] round minima, {tag}: {acts} active entries of {U} x {n}; factor kernel {r['ms']:.4f} ms "
            f"(device {r['device_ms']:.4f}), the first kernel {r['old_ms']:.4f} (device {r['old_device_ms']:.4f}; "
            f"{r['old_ms'] / r['ms']:.1f}x), bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}: active entries' 4 bytes and the vectors; the first kernel's {r['old_bound_ms']:.4f})"
            + (f"; plain {r['plain_ms']:.2f} (the first's {r['old_plain_ms']:.2f})" if plain else "")
            + "; bit for bit its plain version and the first kernel")
        return r

    stream_rows = f"the stream's rows ({int(rv.sum())} of {U} valid: Bp = {EXACT_BLOCK} and rk_n = " \
                  f"{int(rv[EXACT_BLOCK:].sum())} of rk_cap = {rk_cap})"
    label_sets = dict(zip(EXACT_MINIMA_LABELS, (iota, iota // 1000 * 1000, torch.zeros_like(iota))))
    cases = {}
    for vname, rows in ((stream_rows, rv), ("all rows valid", ones)):
        for lname, lab in label_sets.items():
            cases[(vname, lname)] = case(f"{lname}, {vname}, {int(alive.sum())} live slots", rows, lab, alive,
                                         plain=lname == "round 1")
    live_all = torch.ones(n, dtype=torch.bool, device=dev)
    full = case("round 1, every row and every column live (D read once)", ones, iota, live_all)
    check(full["bound_ms"] > 0.2, f"[exact] the whole strip's bound {full['bound_ms']:.4f} ms")
    # every round of the captured insert block's Borůvka
    SW, smask = built_strip(D, cd, sids, rv, alive)
    rounds = []
    for i, lab in enumerate(labs):
        equal(f"round {i + 1} of the insert's Borůvka", k_dyn.strip_round_minima_from_dists(D, cd, sids, rv, alive, lab, E),
              k_dyn.strip_round_minima(SW, smask, sids, lab, E))
        acts = active(rv, lab, alive)
        rounds.append((device_ms(lambda: k_dyn.strip_round_minima_from_dists(D, cd, sids, rv, alive, lab, E)),
                       device_ms(lambda: k_dyn.strip_round_minima(SW, smask, sids, lab, E), reps=2),
                       bound_ms(0.0, 4.0 * acts + vectors)[0], acts, int(torch.unique(lab).numel())))
    say(f"[exact] round minima over the {len(labs)} rounds of one insert block's Borůvka (device ms, the calls "
        "queued behind a spin: factor kernel / first kernel / bound; active entries; components): " + "; ".join(
            f"{i + 1}: {a:.4f} / {b:.4f} / {c:.4f}, {d}, {e}" for i, (a, b, c, d, e) in enumerate(rounds))
        + f"; sums {sum(r[0] for r in rounds):.3f} / {sum(r[1] for r in rounds):.3f} ms")

    # the insert block's Borůvka through both routes
    def first():
        return mst.boruvka_strip(eu, ev, ew, evalid, sids, SW, smask, n)

    def factor():
        return mst.boruvka_strip_from_dists(eu, ev, ew, evalid, sids, D, cd, rv, alive, n)

    a, b = first(), factor()
    check(all(bool(torch.equal(x, y)) for x, y in zip(a, b)), "[exact] the insert's Borůvka differs between routes")
    walls = {"first": [], "factor": []}
    for name, fn in (("first", first), ("factor", factor), ("factor", factor), ("first", first)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    prof = {}
    for name, fn, keys in (("first", first, OLD_MINIMA), ("factor", factor, NEW_MINIMA)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        events = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
        prof[name] = (sum(e.self_device_time_total for e in events if any(k in e.key for k in keys)) / 1e3,
                      sum(e.self_device_time_total for e in events) / 1e3)
    say(f"[exact] one insert block's Borůvka ({len(labs)} rounds, U = {U}, Np = {n}), buffers equal: wall (ms, in turns "
        f"first, factor, factor, first) first route {walls['first'][0]:.2f}, {walls['first'][1]:.2f}; factor route "
        f"{walls['factor'][0]:.2f}, {walls['factor'][1]:.2f}; torch.profiler device time of the strip kernels "
        f"{prof['first'][0]:.3f} / {prof['factor'][0]:.3f} ms of {prof['first'][1]:.3f} / {prof['factor'][1]:.3f} busy; "
        "the update's state through both routes equal")
    del SW, smask
    oracle = k_dyn.launches["strip_round_minima"] - old_before
    check(oracle > 0, "[exact] the first round-minima kernel never ran as the oracle")
    lead = cases[(stream_rows, "round 1")]
    whole = cases[("all rows valid", "round 1")]
    return {
        "strip_round_minima_from_dists": dict(
            max_abs_err=err, ms=lead["ms"], plain_ms=lead["plain_ms"], bound_ms=lead["bound_ms"],
            bound_by=lead["bound_by"], library_ms=None, device_ms=lead["device_ms"], first_ms=lead["old_ms"],
            first_device_ms=lead["old_device_ms"], full_ms=full["ms"], full_device_ms=full["device_ms"],
            full_bound_ms=full["bound_ms"], rounds_device_ms=[r[0] for r in rounds],
            boruvka_ms=min(walls["factor"]), boruvka_first_ms=min(walls["first"]),
            boruvka_device_ms=prof["factor"][0], boruvka_first_device_ms=prof["first"][0]),
        "strip_round_minima": dict(
            max_abs_err=err, ms=whole["old_ms"], plain_ms=whole["old_plain_ms"], bound_ms=whole["old_bound_ms"],
            bound_by="bytes", library_ms=None, launches_oracle=oracle, stream_ms=lead["old_ms"]),
    }


def watch_plain(names=("pairwise_sqdist", "nearest", "assign", "assign_with_dist", "bubble_core_distances",
                       "bubble_core_distances_rows", "mutual_reachability")):
    """Wrap the plain versions of ``kernels/ref.py`` so that each call with a
    CUDA tensor is recorded; returns (the record, a function that unwraps)."""
    import torch

    from repro_torch.kernels import ref

    seen, saved = [], {name: getattr(ref, name) for name in names}

    def watched(name, fn):
        def call(*args, **kw):
            if any(torch.is_tensor(a) and a.is_cuda for a in args):
                seen.append(name)
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(ref, name, watched(name, fn))
    return seen, lambda: [setattr(ref, name, fn) for name, fn in saved.items()]


def near_tie_rows(Xc, Rc, dev, rows=16384):
    """Rows of the centred points Xc whose best and second-best distances
    to the centred reps Rc are within RTOL relative (f64 on the card)."""
    import torch

    R = torch.as_tensor(Rc, dtype=torch.float64, device=dev)
    out = []
    for i in range(0, Xc.shape[0], rows):
        x = torch.as_tensor(Xc[i : i + rows], dtype=torch.float64, device=dev)
        two = torch.topk(torch.cdist(x, R), 2, dim=1, largest=False).values
        out.append(((two[:, 1] - two[:, 0]) <= RTOL * two[:, 1]).cpu().numpy())
    return np.concatenate(out)


def summarizer_checks(tag, summ, res, truth):
    """One ``cluster()`` result against the CPU backend on the same bubbles
    (the partition, MST weight within RTOL, assignment indices identical
    outside near-ties), the numpy route (NMI >= SUMMARIZER_NMI) and the
    ground truth (NMI, printed).  ``truth`` maps point ids to blobs."""
    from repro_torch import get_backend
    from repro_torch.core import nmi
    from repro_torch.core.summarizer import assign_points, cluster_bubbles

    b, L = res.bubbles, res.bubbles.size
    cpu = get_backend("cpu")
    t0 = time.perf_counter()
    res_cpu = cluster_bubbles(b, MIN_PTS, backend=cpu)
    w_gpu, w_cpu = res.hdbscan.total_mst_weight, res_cpu.total_mst_weight
    rel = abs(w_gpu - w_cpu) / abs(w_cpu)
    check(_same_partition(res.bubble_labels, res_cpu.labels), f"{tag}: bubble partition differs from the CPU backend's")
    check(rel <= RTOL, f"{tag}: MST weight differs from the CPU backend's by {rel:.3e}")
    pids_alive, Xa = summ.tree.alive_points()
    check(np.array_equal(pids_alive, res.point_ids), f"{tag}: the tree's live points are not the result's")
    a_gpu = assign_points(Xa, b, backend=summ.backend)
    a_cpu = np.concatenate([assign_points(Xa[i : i + 16384], b, backend=cpu) for i in range(0, len(Xa), 16384)])
    mu = b.rep.mean(axis=0)
    tie = near_tie_rows(Xa - mu, b.rep - mu, summ.backend.device)
    differ = (a_gpu != a_cpu) & ~tie
    say(f"[summarizer] {tag}: CPU backend on the same {L} bubbles ({time.perf_counter() - t0:.2f} s): "
        f"{len(set(res_cpu.labels.tolist()) - {-1})} clusters, the same partition, MST weight rel diff {rel:.3e}; "
        f"assignment indices: {int(differ.sum())} differ on {int((~tie).sum())} rows, {int(tie.sum())} "
        f"near-ties (second-best within {RTOL:g}) left out")
    check(not differ.any(), f"{tag}: assignment indices differ from the CPU backend's")
    check(np.array_equal(res.point_labels, res.bubble_labels[a_gpu]),
          f"{tag}: cluster()'s point labels are not the labels of the bubbles assign gives")
    check(_same_partition(res.point_labels[~tie], res_cpu.labels[a_cpu][~tie]),
          f"{tag}: point partition differs from the CPU backend's")
    t0 = time.perf_counter()
    res_np = cluster_bubbles(b, MIN_PTS)
    a_np = np.concatenate([assign_points(Xa[i : i + 8192], b) for i in range(0, len(Xa), 8192)])
    score_np = nmi(res.point_labels, res_np.labels[a_np])
    score_truth = nmi(res.point_labels, truth[pids_alive])
    say(f"[summarizer] {tag}: NMI against the numpy route {score_np:.4f} (f64 W and assign, "
        f"{time.perf_counter() - t0:.2f} s), against the mixture's ground truth {score_truth:.4f}; "
        f"{res.hdbscan.labels.max() + 1} clusters, noise share of points {float((res.point_labels < 0).mean()):.4f}")
    check(score_np >= SUMMARIZER_NMI, f"{tag}: NMI {score_np:.4f} against the numpy route, below {SUMMARIZER_NMI}")


def phase_summarizer(dev, card):
    """The online–offline summarizer (core/summarizer.py) at the [stream]
    configuration: the same 262,144 points inserted into the host tree in
    blocks of BLOCK, ``cluster()`` on the card at the full table (L =
    5,243: split stage by stage, then end to end), a quarter deleted in
    blocks, ``cluster()`` twice more (L = 3,932).  The three kernels'
    launches are counted over the four calls (the checks' own launches
    left out) and every plain version is watched for CUDA calls; each
    table's result goes through ``summarizer_checks``."""
    import torch

    from repro_torch import BubbleTreeSummarizer

    rng = np.random.default_rng(SEED + 1)  # [stream]'s draws: the same points
    data, blob = mixture(rng, N_POINTS + N_QUERIES, labels=True)
    X = data[:N_POINTS] + 50.0
    summ = BubbleTreeSummarizer(DIM, min_pts=MIN_PTS, compression=COMPRESSION, device=dev)
    t0 = time.perf_counter()
    pids = []
    for i in range(0, N_POINTS, BLOCK):
        pids.extend(summ.insert_block(X[i : i + BLOCK]))
    insert_s = time.perf_counter() - t0
    truth = np.full(max(pids) + 1, -1)
    truth[pids] = blob[:N_POINTS]
    drop = np.random.default_rng(SEED + 27).choice(N_POINTS, size=N_POINTS // 4, replace=False)

    def timed_cluster():
        t0 = time.perf_counter()
        out = summ.cluster()
        walls.append((time.perf_counter() - t0) * 1e3)
        calls.append(read_counts())
        return out

    def checked(tag, res):  # the checks' launches are not the path's
        counts = read_counts()
        summarizer_checks(tag, summ, res, truth)
        reset_counts(counts)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    seen, unwatch = watch_plain()
    reset_counts()
    times, walls, calls = {}, [], []
    try:
        full = summ.cluster(stage=stage_timer(times))
        calls.append(read_counts())
        again = timed_cluster()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        L_full = full.bubbles.size
        say(f"[summarizer] {N_POINTS} points d={DIM} inserted in blocks of {BLOCK}: {insert_s / N_POINTS * 1e6:.3f} "
            f"ms per 1k points (host tree, host f64 assign) on {card}")
        say(f"[summarizer] cluster() at L = {L_full}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
            + f"; split total {sum(times.values()):.1f} ms; end to end {walls[0]:.1f} ms; peak device memory "
            f"{peak:.1f} MiB above the {base / 2**20:.0f} MiB held")
        check(LP // 2 < L_full <= LP, f"the full summary has {L_full} bubbles, not the Lp = {LP} bucket's")
        check(np.array_equal(again.point_labels, full.point_labels), "a repeated cluster() gave other labels")
        checked(f"L = {L_full}", full)
        t0 = time.perf_counter()
        for i in range(0, len(drop), BLOCK):
            summ.delete_block([pids[j] for j in drop[i : i + BLOCK]])
        delete_s = time.perf_counter() - t0
        last = timed_cluster()
        again = timed_cluster()
        launches = {k: calls[-1][k] for k in SUMMARIZER_KERNELS}
    finally:
        unwatch()
    L_last = last.bubbles.size
    say(f"[summarizer] {len(drop)} deleted in blocks of {BLOCK}: {delete_s / len(drop) * 1e6:.3f} ms per 1k points; "
        f"cluster() at L = {L_last}: {walls[1]:.1f}, {walls[2]:.1f} ms end to end")
    say(f"[summarizer] launches over {len(calls)} cluster() calls {json.dumps(launches)}; "
        f"plain versions on the card: {len(seen)}")
    for n, c in enumerate(calls, 1):
        check(c["bubble_cd"] == c["mutual_reach"] == n and c["assign"] >= n,
              f"cluster() call {n} did not launch bubble_cd and mutual_reach once and assign at least once: {c}")
    check(not seen, f"plain versions ran on the card: {sorted(set(seen))}")
    check(np.array_equal(again.point_labels, last.point_labels), "a repeated cluster() gave other labels")
    summarizer_checks(f"L = {L_last}", summ, last, truth)
    return launches


def phase_examples():
    """The port's four examples, on the card by default, each in its own
    process (started together): exit 0 and ``OK`` as the last line."""
    import os

    import torch

    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(root / "examples" / name)], cwd=root, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in EXAMPLES}
    failed = []
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        lines = out.strip().splitlines()
        for line in lines:
            say(f"[examples] {name}: {line}")
        if proc.returncode != 0 or not lines or lines[-1] != "OK":
            failed.append(name)
            say(f"[examples] {name} exited {proc.returncode}; stderr tail: {err.strip()[-2000:]}")
    say(f"[examples] {len(EXAMPLES) - len(failed)} of {len(EXAMPLES)} ended with OK in "
        f"{time.perf_counter() - t0:.1f} s")
    check(not failed, f"examples failed: {failed}")


def layer0(run: str, got: dict) -> dict:
    """A layer-0 reading's numbers for the kernels line, keyed by its run:
    ms, bound, plain and SDPA, and where the call took the tensor-core
    route the kernel's ms through its wrapper and the first tensor-core
    kernel's through its own."""
    keys = ("ms", "bound_ms", "plain_ms", "library_ms") + (("wrapper_ms", "v1_ms") if "v1_ms" in got else ())
    return {f"{run}_{key}": got[key] for key in keys}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    t0 = time.perf_counter()
    dev, card = phase_card()
    phase_build()
    numbers = phase_kernels(dev)
    run = phase_stream(dev)
    assign_at_query_shape(dev, run)
    phase_cpu_check(run)
    phase_serve(dev, run, card)
    phase_recover(dev, run, card)
    online_launches, online_numbers = phase_online(dev, run, card)
    grid_launches, grid_numbers = phase_grid(dev, run, card)
    mesh_launches = phase_mesh(dev, run, card)
    numbers.update(phase_hierarchy(dev, run["table_full"]))
    phase_stages(dev, run["table_full"])
    phase_min_pts(dev, run["table_full"])
    phase_wide(dev)
    phase_tenants(dev, card)
    summarizer_launches = phase_summarizer(dev, card)
    exact_launches, exact_numbers = phase_exact(dev, card)
    torch.cuda.empty_cache()
    point_launches, point_numbers = phase_points(dev)
    attn_launches, attn_numbers = phase_attention(dev)
    lm_launches, lm_numbers = phase_lm(dev, card)
    moe_launches, moe_numbers = phase_moe(dev, card)
    vlm_launches, vlm_numbers = phase_vlm(dev, card)
    phase_ssm(dev, card)
    hybrid_launches, hybrid_numbers = phase_hybrid(dev, card)
    audio_launches, audio_numbers = phase_audio(dev, card)
    train_launches, train_numbers = phase_train(dev, card)
    phase_examples()
    launches = dict(run["launches"], eom=run["eom_launches"], knn=point_launches["knn"], pairwise=point_launches["pairwise"],
                    flat_scatter=online_launches["flat_scatter"], **grid_launches, **attn_launches, **exact_launches)
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    # the backward's two sources: the tensor-core kernel (source, the qwen2-1.5b numbers) and the CUDA-core one
    train_numbers.update(launches_mma=train_launches["flash_attention_bwd_mma"],
                         launches_simt=train_launches["flash_attention_bwd_simt"],
                         simt_source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu")
    got = attn_numbers[ATTENTION[0][0]]  # the first tensor-core kernel on qwen2-1.5b's bf16 call, as the oracle
    mma_v1 = dict(max_abs_err=got["v1_max_abs_err"], ms=got["v1_ms"], plain_ms=got["plain_ms"],
                  bound_ms=got["bound_ms"], bound_by=got["bound_by"], library_ms=got["library_ms"])
    numbers.update(point_numbers, flash_attention=attn_numbers[ATTENTION[1][0]],
                   flash_attention_mma=attn_numbers[ATTENTION[0][0]], flash_attention_mma_v1=mma_v1,
                   flat_scatter=online_numbers, **grid_numbers, **exact_numbers, flash_attention_bwd=train_numbers)
    sources = {"assign": ("assign_ws.cu", "src/repro/kernels/assign.py:21"),
               "bubble_cd": ("bubble_cd_ws.cu", "src/repro/kernels/bubble_cd.py:41"),
               "mutual_reach": ("dist_panel.cu", "src/repro/kernels/mutual_reach.py:23"),
               "knn": ("knn_ws.cu", "src/repro/kernels/knn.py:34"),
               "pairwise": ("dist_panel.cu", "src/repro/kernels/pairwise.py:30"),
               "flash_attention": ("flash_attention_panel.cu", "src/repro/kernels/flash_attention.py:38"),
               "flash_attention_mma": ("flash_attention_wgmma.cu", "src/repro/kernels/flash_attention.py:38"),
               # the first tensor-core kernel (mma.sync): the wgmma kernel's oracle, launched on no path
               "flash_attention_mma_v1": ("flash_attention_mma.cu", "src/repro/kernels/flash_attention.py:38"),
               # no Pallas kernel: the JAX package differentiates its jnp online softmax through lax.scan
               "flash_attention_bwd": ("flash_attention_bwd_mma.cu",
                                       "no Pallas kernel: autodiff of _flash_sdpa, src/repro/models/layers.py:171"),
               # no Pallas kernel: the JAX package's lax.scan sweeps of the hierarchy
               "single_linkage": ("hierarchy_par.cu", "src/repro/core/hierarchy_jax.py:195"),
               "condense": ("hierarchy_par.cu", "src/repro/core/hierarchy_jax.py:265"),
               "extract": ("hierarchy_extract.cu", "src/repro/core/hierarchy_jax.py:288"),
               # extract_v1's EOM kernel, the extract kernel's oracle: launched on no path
               "eom": ("hierarchy.cu", "src/repro/core/hierarchy_jax.py:336"),
               # no Pallas kernel: the JAX package's segment sums + _kahan_add of device-online ingest
               "flat_scatter": ("flat_scatter.cu", "src/repro/core/bubble_flat.py:93"),
               # no Pallas kernel: the JAX package's grid-pruned jnp searches (spatial_index=True)
               "grid_assign": ("grid_assign.cu", "src/repro/kernels/grid.py:355"),
               "grid_core_distances": ("grid_cd.cu", "src/repro/kernels/grid.py:222"),
               "grid_round_minima": ("grid_round.cu", "src/repro/core/mst.py:392"),
               # the first round, assign and Eq. 6 kernels: the redesigns' oracles, launched on no path
               "grid_round_minima_v1": ("grid.cu", "src/repro/core/mst.py:392"),
               "grid_assign_v1": ("grid.cu", "src/repro/kernels/grid.py:355"),
               "grid_core_distances_v1": ("grid.cu", "src/repro/kernels/grid.py:222"),
               # no Pallas kernel: the jnp strip programs of the exact-dynamic path (exact=True)
               "strip_dists": ("strip_tiles.cu", "src/repro/core/dynamic_jax.py:145"),
               "strip_topk": ("strip_tiles.cu", "src/repro/core/dynamic_jax.py:187"),
               # the first versions: the redesigned kernels' oracles, launched on no path
               "strip_dists_v1": ("dynamic.cu", "src/repro/core/dynamic_jax.py:145"),
               "strip_topk_v1": ("dynamic.cu", "src/repro/core/dynamic_jax.py:187"),
               # the first version: the factor kernel's oracle, launched on no path
               "strip_round_minima": ("dynamic.cu", "src/repro/core/mst.py:777"),
               "strip_round_minima_from_dists": ("strip_minima.cu", "src/repro/core/mst.py:777")}
    for name, n in mesh_launches.items():  # the sharded pass's launches on [mesh]'s engines
        numbers[name]["launches_mesh"] = n
    for name, n in summarizer_launches.items():  # the summarizer's cluster() calls on [summarizer]
        numbers[name]["launches_summarizer"] = n
    for name, n in lm_launches.items():  # the flash kernels on [lm]'s serving path, and layer 0's call there
        numbers[name].update(launches_lm=n, **layer0("lm", lm_numbers[name]))
    for runs in (moe_launches, vlm_launches):  # their launches on [moe]'s and [vlm]'s runs, by run
        for name, by_run in runs.items():
            numbers[name].update({f"launches_{run}": n for run, n in by_run.items()})
    for name in ("flash_attention_mma", "flash_attention"):  # the forward kernels' launches on [train]'s run
        numbers[name]["launches_train"] = train_launches[name]
    for run, got in dict(moe_numbers, **vlm_numbers).items():  # layer 0's call on the new routes (tensor cores)
        numbers["flash_attention_mma"].update(layer0(run, got))
    for name, by_run in hybrid_launches.items():  # [hybrid]'s serve and its 15-layer training steps, by run
        numbers[name].update({f"launches_{run}": n for run, n in by_run.items()})
    # Dh 112: the shared block's first application of the long prefill, and its backward at (1, 8192)
    got = hybrid_numbers["hybrid"]
    numbers["flash_attention_mma"].update(layer0("hybrid", got))
    got = hybrid_numbers["hybrid_bwd"]
    numbers["flash_attention_bwd"].update(hybrid_ms=got["ms"], hybrid_bound_ms=got["bound_ms"],
                                          hybrid_plain_ms=got["plain_ms"], hybrid_library_ms=got["library_ms"],
                                          hybrid_max_abs_err=got["max_abs_err"])
    for name, by_run in audio_launches.items():  # [audio]'s serve and its training steps at each shape, by run
        numbers[name].update({f"launches_{run}": n for run, n in by_run.items()})
    # Dh 64: layer 0's causal self- and non-causal cross-attention of the 12,288-token prefill, and the backward at
    # whisper's two (1, 16,384) training shapes
    for key, fwd, bwd in (("audio", "self", "bwd_self"), ("audio_cross", "cross", "bwd_cross")):
        got = audio_numbers[fwd]
        numbers["flash_attention_mma"].update(layer0(key, got), **{f"{key}_max_abs_err": got["max_abs_err"]})
        got = audio_numbers[bwd]
        numbers["flash_attention_bwd"].update({f"{key}_{n}": got[n] for n in ("ms", "bound_ms", "plain_ms",
                                                                              "library_ms", "max_abs_err")})
    kernels = [
        dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
             replaces=tpu, launches=launches[name], **numbers[name])
        for name, (src, tpu) in sources.items()
    ]
    say(f"[done] {time.perf_counter() - t0:.1f} s on {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
