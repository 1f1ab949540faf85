#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):

1. Device: the card's name and power limit (nvidia-smi).
2. Build: every CUDA kernel of ``xllm_service_tpu_torch/ops/kernels/csrc``
   with nvcc for sm_90a (parallel, one nvcc per source).
3. Kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors at the serving shapes of llama3-1b (B=8 decode rows,
   a 4-row prefill window batch, a ragged batch of 7 decode rows and a
   256-token window in a T=256 bucket, page size 128, bf16), in both
   orders of the KV write: the one-layer writers K1/K2 and the pool-only
   attention K3/K4 (write-then-attend), the all-layer writers K6/K7 over
   16 layers (also at the MLA latent row, Hkv=1 and D=576) and the
   attention forms K3' (current token held apart; a row with cache
   length 0 compared like the others) and K4' (fresh window operands)
   of attend-then-write, whose pools hold random stale values where the
   current token or the window would sit. KV writers must be bit-exact;
   attention must agree within atol = rtol = 2e-2 (bf16 outputs; the
   plain version rounds its probabilities to bf16 before P @ V) on
   active rows / valid query rows, with plain, windowed, soft-capped and
   sink cases; a ragged row of length 0 must come out finite. Each
   kernel is timed with CUDA events (>= 20 launches after warm-up)
   beside its plain version, one PyTorch library call computing the
   same function, and its bound (bytes over 3.35 TB/s or operations
   over 989 TFLOP/s, whichever is larger); the ragged kernel K5 also
   beside the split path's two launches for the same work (decode kernel
   on the decode rows, prefill kernel on the window) and alone on its
   decode rows and on its window, with its split count and grid, its
   bound counting the whole [B, T, Hq, D] output written once
   (``bound_ms_valid_rows_only``: the count that takes only the valid
   rows, kept for comparison with older records), and at long decode
   rows (8 x 2048-4096 keys beside a 256-token window,
   ``ragged_paged_attention_long``, held to atol = rtol = 5e-3, the
   reference's RMS beside its error); the blocks with work and the work
   items, as the host rule ``ragged_work`` derives them (not measured),
   go to a ``[kernel]`` line of their own; K6 beside 16 K1 launches for the
   same rows. Then K3'', the MLA decode attention, in
   both forms at DeepSeek-V2-Lite's decode shape (B=8, 16 heads, one
   576-wide latent head, a 27-layer pool; contexts 117-411 with an
   inactive row, and for the current form a row at cache length 0 and
   stale slots), timed beside gather + SDPA over the latent as K and V
   of every head; and K1/K2 bit-exact at the latent row. Then the layer
   body's writers as the serving path runs them, fused with their
   neighbours: K1 and K2 fused with the rope of q and k
   (``rope_kv_update_layer``, ``rope_prefill_kv_update_layer``:
   bit-exact against their plain version, two ``rotate`` + the scatter,
   in decode, prefill, ragged-window and pool-less modes) and with the
   MLA latent row (``latent_kv_update_layer``,
   ``latent_prefill_kv_update_layer`` at DeepSeek-V2-Lite's geometry:
   within 2e-2, the rope columns bit-exact, with pools and without), each
   timed beside the unfused chain it replaces in one CUDA graph
   (``unfused_ms``) and K1 / K2 alone (``writer_only_ms``). K6 folded
   into the last layer's writer: the all-layer modes
   (``rope_kv_update_all_layers`` over llama3-1b's 16 layers,
   ``latent_kv_update_all_layers`` over DeepSeek-V2-Lite's 27) against
   their plain versions (the dense one and the staged layers bit-exact,
   the latent row within 2e-2 with its rope columns exact) and the
   unfused chain they replace (pool-less writer, ``torch.stack``, K6),
   timed beside that chain in one CUDA graph and K6 alone; and K3' and
   K3'' current shown blind to NaN at the slot where the fold writes
   the current rows. The split-KV
   decode kernels (K3, K3', K3'') are also checked and timed at long
   contexts, B = 8 rows of 2048-4096 keys (seeded) and B = 1 row of
   4096 (records ``*_long_b8`` / ``*_long_b1``), and every K3/K3'/K3''
   record carries the split count the wrapper chose (``splits``) and the
   same kernel's time at one split (``unsplit_ms``, checked too); the
   pool-only long records also time the split counts 4-64
   (``split_sweep_ms``). K4, K4'
   and K5's window tiles (the tile code they share), and K3 and K3' at
   1, 3 and the wrappers' splits, are also held at D = 128 (G = 3) and
   D = 256 (G = 4) on a small pool of page size 16,
   and at a long prompt (B = 2 x T = 2048 at q_start 0/2048, page
   tables of 32 pages), in all four argument sets; K4 and K4' are timed
   at the long prompt too (records ``*_long_prompt``, bound by the
   tensor cores' operations, with their share of the bound). K5 is
   also held at 256 rows (its row table) and at 300 rows (299 decode
   rows and a 256-token window), which the wrapper cuts into two
   launches (``ragged_attention.launch_plan``). K3 is also held under a
   100-token sliding window with each row's leading table entries NULL
   (page 0, filled with large values), as the engine leaves a table once
   it has released the pages every later window masks
   (``paged_decode_attention_null_lead``). The fused rope writers, K3
   and K4 are also recorded at llama3-8b's shapes (32 query heads, Hkv
   8, D = 128; records ``*_d128``), which phase 12 serves, and K3, K3',
   K4, K4', K5 and the fused rope writers at GPT-OSS-20B's (64 query
   heads, Hkv 8, D = 64, yarn tables; the attention with float32 sinks
   and a 128-token window, checked with the window and without it, the
   bound counting the keys inside the window, ``library_ms`` null since
   no one PyTorch call takes sinks, SDPA without them beside it; records
   ``*_gptoss``), which phase 13 serves. And at Gemma-3-12B's shapes
   (16 query heads, Hkv 8, D = 256; 16 pages a row, contexts up to
   2,011 past the 1024-token window of its local layers): the fused
   rope writers (a local layer's tables), K3, K3', K4, K4' and K5 with
   the window and without it, timed with it (records ``*_gemma3``;
   ``library_ms`` null, SDPA without the window beside it), and K3 and
   K4 with Gemma-2-9B's soft-cap 50 (``*_gemma2``; SDPA without the
   soft-cap beside them), which phase 16 serves.
4. Forward: a full-width llama3-1b forward_prefill + forward_decode + a
   ragged forward_prefill through the kernels (bf16 on the GPU), and
   the attend-then-write order (two prefill windows, the second at
   q_start > 0, then a decode step), each against the plain path
   (float32 on the CPU, same weights): logits within a relative L2
   error of 5e-2 (16 bf16 layers against float32). Then DeepSeek-V2-
   Lite at full width in both orders (prefill + decode; prefill x2 +
   decode), its depth cut to 4 layers (the dense one and 3 MoE layers:
   the float32 CPU copy of all 27 would be 63 GB), to the same bound;
   each of its decode forwards must launch K3'' once per layer. Each
   model's largest absolute logit error is kept for phase 5's margins.
   With each model's weights, one decode forward (B = 8) is captured in
   a CUDA graph and replayed against the same forward run eagerly, in
   both orders (``[graph]``: the logits' max abs difference, 0
   expected, and the kernels the graph launches per replay). With
   llama3-1b's, two engines with 4-step bursts through graphs, the
   pipeline on and off, serve two sampled streams and a greedy one
   admitted mid-run (``[pipeline]``): identical streams, at least one
   speculation hit and one rollback.
5. Serving: the worker the CLI builds (``runtime.worker`` with
   --model llama3-1b --page-size 128 --num-pages 512 --max-model-len 1024
   --max-batch-size 8, prefill buckets 128,256,512, 256 prefill tokens
   per step so the longer prompts prefill in chunks) answers 4
   concurrent requests (2 streamed chats, 2 non-streamed completions,
   prompts of 100-400 tokens, 32 new tokens, temperature 0), with the
   ragged step off and XLLM_WRITE_THEN_ATTEND=1. Launch counts are
   zeroed just before and read just after, and counted per engine step:
   every decode forward must launch the fused rope writer and K3 once
   per layer, every prefill forward the fused prefill writer and K4 once
   per layer, and nothing else (in every phase below as well: the
   unfused K1/K2 never run on a served path). Then one streamed request
   is served again under torch.profiler (device time by kernel, idle
   share, launches per forward, the decode attention kernels', the
   writers' and PyTorch's elementwise and copy kernels' device ms).
5b. Serving, ragged: the same worker, flags and requests with
   XLLM_RAGGED_ATTN=1. At least one mixed iteration must run as one
   ragged forward, each launching the fused prefill writer and the
   ragged kernel once per layer and neither the decode nor the prefill
   attention kernel.
5c. Serving, attend-then-write: the same worker, flags and requests
   with XLLM_WRITE_THEN_ATTEND=0 (ragged off). Every decode forward
   must launch the fused rope writer (no pools: rotation into the
   staging buffer) for every layer but the last, its all-layer mode
   (``rope_kv_update_all_layers``, K6 folded in) for the last, and K3'
   once per layer; every prefill forward the fused prefill writer and
   K4' once per layer and K7 once; K1-K6 never. One request is profiled
   as in phase 5.
5d. Serving DeepSeek-V2-Lite: the worker with --model deepseek-v2-lite
   at full width, its depth cut to ``DEEPSEEK_SERVE_LAYERS`` (4: the
   dense layer and 3 MoE layers, as phase 4; the cut config goes to the
   worker as its ``model_cfg``; random bf16 weights), the same flags and
   requests, in the GPU default order (write-then-attend). Every decode
   forward must launch the fused latent writer and K3'' once per layer,
   every prefill forward the fused latent prefill writer once per layer
   (its attention is plain), and K1-K5 never. One streamed request is
   profiled as in phase 5.
5e. The same with XLLM_WRITE_THEN_ATTEND=0: every decode forward the
   fused latent writer (no pools) for every layer but the last, its
   all-layer mode (``latent_kv_update_all_layers``) for the last, and
   K3'' (current form) once per layer, every prefill forward the fused
   latent prefill writer once per layer and K7 once, K1-K6 never.
   Profiled as 5d.
5f. Decode modes, llama3-1b: the worker of phase 5 (write-then-attend,
   ragged off) serves the same requests with CUDA graphs off
   (XLLM_CUDA_GRAPHS=0, single steps) and on with --decode-steps 4
   (fused bursts and the speculative pipeline), beside phase 5's own
   serve, which is the mode with graphs on and single steps (the same
   flags, weights and requests). Each worker warms up (captures every
   decode graph) before serving; with graphs on, every decode step must
   be a replay of a graph warmup captured.
   Per mode (``[servef]``): TTFT, decode tokens/s per stream, the
   profiled stream's idle share, host launches per forward (kernel and
   graph launches the profiler sees the host issue), device kernels per
   forward, graphs captured, speculation hits and rollbacks. Greedy
   streams with graphs on must equal graphs off; where not, the margins
   rule below decides, and a fault fails.
5g. The same for DeepSeek-V2-Lite at 5d's depth, beside 5d's serve.
   Each worker's weights are freed before the next phase.
   Launch counts: a kernel captured in a CUDA graph counts once per
   replay (``ops/kernels/_launch.count_replay``), so the per-step checks
   hold in every mode (a burst step runs N decode forwards, 2N with a
   speculative burst).
   Margins: each model's phases serve the same weights, so on the live
   engine of 5c (and 5e) the script reads, at each stream's first
   divergent token between phase 5 and 5b, 5 and 5c (5d and 5e), the
   top-2 logit margin of one prefill forward over the common prefix on
   the card through both paths and, for llama3-1b, under the plain
   float32 path on the CPU (``[margins]``): wider than 10 x phase 4's
   largest logit error for the model is a fault, narrower is drift.
   ``[profile]`` prints the launches per forward of 5, 5c, 5d and 5e.
6. Cluster: the port's coordination store and master run as child
   processes (``python -m xllm_service_tpu_torch.service.coordination_net``,
   ``python -m xllm_service_tpu_torch.service.master --block-size 128
   --heartbeat-interval 0.5 --master-upload-interval 0.5
   --load-balance-policy RR``; nothing of the
   JAX package runs or is imported here: ``guard_child_argv`` fails a
   child whose argv names one of its modules, ``guard_no_jax_modules``
   a run that imported one) and the port's worker (llama3-1b,
   the phase 5 flags and seed, write-then-attend, graphs on) joins them
   in-process: it warms up, registers through the store under a lease
   and heartbeats every 0.5 s; the phase waits (60 s at most) for the
   master's ``/rpc/static_prefill_list`` to list it and checks its
   ``/rpc/instance_info``. Then: one streamed chat alone (its token ids
   in the body, so the master's chat template cannot change the prompt)
   gives the same text and chosen-token logprobs direct and through the
   master; phase 5's four requests run direct and through the master,
   all finish with 32 tokens, every step launching the fused writers, K3
   and K4 as phase 5 requires; while a long stream runs through the
   master, the master's books (``/admin/debug_bundle``) show one running
   request and a step p99 that a heartbeat carried, and ``POST /cancel``
   on the worker ends the stream, the engine idle after; the master is
   stopped and one with ``--enable-decode-response-to-service`` takes
   over, the worker follows its advertisement in the store and learns
   the RPC topology, and the four requests finish through it (tokens
   pushed to ``/rpc/generations``); the ``[master]`` round
   (``master_round``, at most ``MASTER_ROUND_S``): the RPC master's
   ``/admin/timeline``, ``/admin/slo``, ``/admin/profile`` and
   ``/admin/debug_bundle`` answer 200 with the JAX master's top-level
   keys (``ADMIN_KEYS``), its hot-path section medians (``schedule``,
   ``tokenize``) are printed, a second master joins the store as a
   replica, the leader is killed with SIGKILL and the replica takes over
   within the election lease (3 s) plus ``MASTER_TAKEOVER_SLACK_S``, the
   worker follows it and the four requests finish through it, and no
   master or store process holds the card (``nvidia-smi
   --query-compute-apps=pid``, and from ``/proc``: the CUDA driver
   library mapped or a device file open, this process the probe's
   control);
   ``worker.stop()`` takes the worker
   off the master's list within the lease TTL (1.5 s). The worker's
   front door must be the native epoll server. ``[cluster]``:
   the median TTFT and decode tokens/s per stream through the master
   (relay, rpc) and direct, the heartbeat's step p99 and the card. In
   phase 6 each run sends its own prompts, and the chat compared direct
   and through the master runs with the prefix cache off (the second
   would otherwise prefill only past the first's pages).
7. Prefix reuse (``[prefix]``): llama3-1b (16 layers, bf16, phase 5's
   flags with --max-model-len 2048, graphs on) serves a 1,024-token
   system prompt (8 full pages) with four tails of 100-300 tokens, on the
   split path in write-then-attend order (fused writer + K4 at start
   1024), on the ragged step (K5 windows at start 1024 beside decode
   rows) and in attend-then-write order (K4' + K7): four rounds, the
   prefix cache off / on / on / off (``prefix_cache.enable`` toggled on
   the idle engine), two prompt sets; in each the first request alone
   (cold), then the other three at once (warm). A cache-on round must
   hit 3 x 1,024 tokens, every step must launch its kernels, and the
   warm streams must equal the cache-off round's, or the margins rule
   decides. Printed: hit tokens, prefill tokens computed per request,
   TTFT cold against warm (and cache off), the launches of each warm
   prefill step.
7b. Spill and restore (``[spill]``): the same weights on a 40-page pool
   with ``XLLM_KV_SPILL_MB=160``: the shared-prompt request, three
   fillers that reclaim its pages (spilled to the host tier), then the
   shared request again (restored). Pages spilled and restored, every
   restored page read back from the pool bit-equal to the bytes the tier
   took, the stream equal to the cold one (or the margins rule decides);
   each spill's and restore's host ms.
6b. Cache-aware routing (``[cluster-car]``): the port's store and a
   master with ``--load-balance-policy CAR --block-size 128`` over two
   port workers (phase 7's weights): A (the shared prompt and a tail),
   then, once a heartbeat after it reached the master, B and C (the same
   prefix, new tails) and D (no shared prefix). The master's routing
   audit (``/admin/trace/<id>``) must put B and C on A's worker with a
   match ratio above 0 and no fallback, and D on the least-loaded
   fallback.
8. Sampling (``[sampling]``, ``sampling_phase``): threefry on the card
   against the CPU for seeds 0, 1 and 2^31 - 1 at positions 0, 1 and
   4095 over llama3-1b's vocabulary (bits bit-equal, Gumbel noise within
   1e-6), the sampler's pieces timed at B = 8 (greedy, sampled, seeded,
   penalized, the seeded chain alone, the counts update, top-5
   logprobs); then a llama3-1b worker (phase 5's flags,
   ``num_top_logprobs=5``) serves a greedy round, a concurrent mix (two
   penalized greedy requests, a ``logit_bias`` banning the greedy first
   token, a 20-entry bias, two seeded sampled requests with top-5
   logprobs, an n=3 seeded chat, an echo with logprobs=2, a best_of=3
   completion) and a seeded round, then each seeded request of the mix
   alone. It fails unless the banned token never comes, every top list
   has 5 sorted entries headed at or above the chosen token, each seeded
   stream equals its request served alone or diverges as drift (the
   perturbed-score margin at the first divergent token below 10 x phase
   4's logit error over the temperature), echo leads with its prompt, no
   step ran eagerly, the captures after warmup are only the bias-32 and
   echo keys, a prefill forward is one host launch and the mix's
   launches per step hold; it prints the three rounds' decode step
   medians.
9. Faults and the flight recorder (``fault_phase``, ``[faults]``,
   ``[steptrace]``): a llama3-1b worker with phase 5's flags serves
   eight greedy 32-token streams fault-free (launches checked per
   step), then again with a request seeded past int32 arriving while
   they decode (9a: its prefill packing raises), then seven of them with
   an eighth arriving while ``worker.fault_step`` is armed (count:1,
   ``POST /admin/failpoint``) during a decode graph's replay, so that
   the same step's prefill section faults after the decode section
   completed (9b), and once more with the failpoint armed while eight
   decode and nothing is queued, so that a decode section faults and is
   bisected in probe steps. Each faulted request must get the typed
   ``engine_fault`` with a ``culprit`` verdict; the other streams must
   finish with 32 tokens, equal to the fault-free round or drift under
   the margins rule; ``xllm_engine_faults_total{outcome="culprit"}``
   reads 1, 2, then 3; 9b's salvaged outputs reach their streams; the
   engine loop lives; no step runs eagerly and nothing is captured
   after warmup. Printed: each faulted step's ms, probes and salvaged
   outputs, and each survivor's extra wait. 9c reads ``/admin/steptrace``:
   median MFU, debt and bound per step kind, the roofline rows and the
   peaks beside the card (the ``h100`` row on an H100); each ``decode``
   key holds 2 x B x (non-embedding parameters + LM head) FLOPs plus at
   most its attention share; then the greedy round four times, recorder
   off and on alternately: the decode step medians and the recorder's
   host microseconds a step.
10. PD disaggregation (``pd_phase``, ``[pd]``): the port's store and
   master as children, a llama3-1b PREFILL worker in-process (phase 5's
   flags and seed) whose own round (phase 5's four requests and 16
   streamed chats) is the reference before ``POST /flip_role`` makes it
   PREFILL; the same round through the master by each transport: the
   direct path to a DECODE worker in this process (once with the two
   engines' steps serialized, for the launch checks, and once stepping
   freely, for the migration time), then, to a DECODE
   worker in a child process (``python -m
   xllm_service_tpu_torch.runtime.worker``, its weights checked equal by
   one stream), the CUDA IPC device wire, the chunked host shuttle and
   the monolithic one. Every stream 32 tokens, equal to the reference or
   drift under the margins rule; each transport's counter moved once a
   request and no local decode happened; K2/K4 in every prefill replay
   and K1/K3 in every decode replay (the child's from its ``/metrics``);
   no eager step or capture after warmup; no held page left, free pages
   back to their start. Then ``worker.fail_kv_transfer`` decodes one
   request locally, one RPC round runs over the wire, and the roles
   flipped serve one request the other way. A child process's pull of a
   staged block is bit-equal (sha256), timed beside a device ``copy_``
   and pinned D2H / H2D copies of the same bytes;
   ``probe_kv_migration`` at 16 pages. Printed: KV bytes per request,
   migration ms and GB/s per transport, TTFT and tokens/s per stream
   under PD against the reference.
11. The cross-worker block fetch (``fetch_phase``, ``[fetch]``): the
   port's store and master, a llama3-1b holder child and an
   in-process requester; the prefix fetched over the CUDA IPC wire, as
   bytes, and recomputed.
12. Lifecycle (``lifecycle_phase``, ``[lifecycle]``): the port's
   store and master as children, a llama3-1b worker in-process (phase
   5's flags). Phase 5's four requests through the master; a sleep
   through ``/model/triggers`` (memory allocated back within 256 MiB of
   its value before the worker, the bytes freed beside the parameters',
   KV pools' and graph pool's, the D2H rate); a wake (the weights' H2D,
   the warmup; as many graphs as at boot and none after, no kernel built
   again, every parameter's checksum unchanged, the requests' streams
   equal or drift under the margins rule, launches per step); a
   llama3-8b staged by ``/fork_master``, woken cold in the 1b's place
   and served (K1-K4 at D = 128), then swapped back; a 64-token stream
   that ``drain_and_stop`` finishes with the greedy tokens, the worker
   off the master's list and a late request a 503; on a fresh worker,
   ``worker.crash_heartbeat`` once: the loop restarts, the lease is kept,
   the crash counted and in the event ring. At most 150 s.
13. Serving from a model directory (``checkpoint_phase``,
   ``[checkpoint]``): llama3-1b's phase 5 weights written by the port's
   ``save_checkpoint`` and served by a CLI worker child with
   ``--model-dir`` (every leaf's sha256 equal to the weights written,
   phase 5's streams, no graph after warmup, the write's and load's
   GB/s); a two-layer GPT-OSS checkpoint at full width in the MXFP4
   dialect loaded on the card (the dequantization bit-equal to the
   host's, prefill and decode against the float32 plain path, two planted
   faults that the check fails); and
   GPT-OSS-20B at full width and depth on random weights made on the
   card, served in the split path, the ragged step and attend-then-write
   (``[serveh_*]`` lines; launches per step, margins; 4 slots, 512
   tokens, buckets 128 and 256; the split path's request profiled).
14. The EPD multimodal path (``epd_phase``, ``[epd]``): Qwen2-VL-7B at
   full width and depth (the published config.json, random bf16
   weights): K1/K2 with the sectioned mrope tables, K3 and K4 at its
   shapes (``*_qwen2vl`` records); its vision tower written as ``visual.*``
   safetensors and read back by the port's reader (every leaf equal), one
   image against the float32 run of the same weights, ms per image and
   share of the bf16 peak, and the Qwen2.5-VL-7B tower the same way; an
   ENCODE worker child and an in-process MIX worker behind the port's
   store and master serving text and image chats: TTFT with and without
   an image, the decode step's ms, K1/K2, K3, K4 launched and K5 not, no
   graph after warmup, an encode-cache hit on a repeated image, the
   local encode under ``worker.fail_encode`` (the same text), the image
   streams under the margins rule; the staged wire beside the bytes
   (``_epd_wire_round``): one image's embeddings fetched from the child
   over CUDA IPC and as bytes, bit-equal, the child's staged tickets
   back to 0, an image chat each way with its TTFT and the master's
   trace split (received -> encoded -> scheduled -> first_token). At
   most 150 s.
15. The observability and coordination plane over etcd (``obs_phase``,
   ``[obs]``): the native etcd server built from ``csrc/xllm_etcd.cpp``
   with g++; the port's master on ``etcd://`` and llama3-1b (16
   layers, random bf16 weights) in-process on ``--store-addr etcd://``:
   seconds until listed; 8 chats through the master whose traces at
   ``/admin/trace/<id>`` hold the worker-plane stages in order beside the
   service's, and how long after ``finished`` they arrived; the worker's
   ``/admin/steptrace`` sections and ``/metrics`` profiler families; the
   profiler's cost (decode step median and tokens/s per stream with
   ``XLLM_HOTPATH_PROFILE`` on and off, two children); the etcd process
   killed (store health 0, chats still served) and restarted empty (the
   seconds to re-registration and the list); ``stop()`` off the list.
   The in-process worker's front door must be native; a shed round
   (``shed_round``): a third child at ``--max-concurrency 2`` joins the
   master, two streams held by ``worker.slow_response_ms`` fill it, and
   two chats through the master must both be served with a 503 counted
   on the child; the profiler's thread books after the phase beside the
   handler pool's cap. At most 90 s.
16. Gemma (``gemma_phase``, ``[gemma]``): Gemma-3-12B at its published
   widths cut to 6 layers (5 local, 1 global), the kernels in bf16
   against the float32 plain path (rel L2 under 5e-2); Gemma-3-12B at
   all 48 layers on random bf16 weights made on the card (~23.5 GB),
   served in-process in the split path and attend-then-write, and the
   ragged step at its first 6 layers (4 slots of 2,048 tokens, buckets
   128/256/512, prefill budget 259; two
   of the four prompts past the window, 32 new tokens): launches per
   step, no capture after warmup, TTFT, decode step median, tokens/s
   per stream, margins between paths; Gemma-2-9B at its published widths
   and 8 layers through one served batch (the soft-capped path).
17. Parallelism (``parallel_phase``, ``[parallel]``) on the one card,
   two ranks each over gloo (collectives staged through the host),
   eager steps: llama3-1b at tp = 2 behind a worker (``--tp 2
   --dist-backend gloo``, rank 1 a child) serving phase 5's requests
   (launches per step on every rank, collectives a forward, the staged
   all-reduce's ms, rank 0's logits within rel L2 5e-2 of the unsharded
   forward, streams against an unsharded eager engine, eager decode
   step beside it); a ~900-token prompt in one ``prefill_ring`` step at
   sp = 2 (its logits and first token against the unsharded chunked
   windows); DeepSeek-V2-Lite at 4 layers at ep = 2 (32 experts a rank:
   streams and ``moe_dropped`` against the unsharded engine, the MLA
   prefill calls past the 64 MiB cut through ``mha_prefill_chunked``,
   its error against the dense form). K3 and K4 at the tp = 2 rank's
   shapes are timed as ``*_tp2`` records. At most 150 s.
18. Summary: one line ``{"kernels": [...]}`` (K1-K4 and the fused rope
   writers' launches from phase 5 (K1/K2 now 0), K5 from 5b, K6 (now 0),
   K7, K3', K4' and the dense all-layer mode from 5c, K3'' and the fused
   latent writers from 5d, the current form of K3'' and the latent
   all-layer mode from 5e; a record at another shape takes its kernel's
   count, and its count in phase 12's woken llama3-1b round
   (``launches_lifecycle``); the ``*_d128`` records take phase 12's
   llama3-8b round's, the ``*_gptoss`` records phase 13's GPT-OSS-20B
   round of their path (with their time per byte against the llama3-1b
   record's), the ``*_qwen2vl`` records phase 14's, the ``*_gemma3``
   records phase 16's Gemma-3 round of their path and the ``*_gemma2``
   ones its Gemma-2 round, the ``*_tp2`` records phase 17's tp = 2
   round; phases 5f/5g and the
   graph checks go to the ``[summary]``
   line; phases 7, 7b, 6b and 9 too, and ``phase_end_s``, the script's
   clock at the end of each phase), the card line, then the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without printing a result when no CUDA device is
present, or when the port's package is not beside it.
"""

from __future__ import annotations

import base64
import dataclasses
import gc
import json
import math
import os
import random
import re
import subprocess
import sys
import threading
import time
import types
from http.client import HTTPConnection
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
PEAK_BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
ATTN_TOL = 2e-2
# K5 at long decode rows: outputs ~0.03 RMS, where ATTN_TOL is the size
# of a value (its error there read 0.0020 on an H100).
LONG_ROW_TOL = 5e-3
FORWARD_REL_L2 = 5e-2
CSRC = "xllm_service_tpu_torch/ops/kernels/csrc"
PALLAS = "xllm_service_tpu/ops/pallas"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 30, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph, replayed, timed with CUDA events. Host overhead (Python,
    argument checks) is outside the graph, so this is the kernels' own
    time back to back."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, mask, scale=None):
    """One library call: q [B, Hq, Tq, D]; k/v [B, Hkv, S, D]."""
    import torch
    import torch.nn.functional as F
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True, scale=scale)
    g = q.shape[1] // k.shape[1]
    return F.scaled_dot_product_attention(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
        attn_mask=mask, scale=scale)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

class KernelBench:
    """Serving-shape inputs for llama3-1b and the checks/timings of the
    four kernels. ``suffix``: a bench at another model's shapes (its
    records named ``<kernel><suffix>``, their ``entry`` the kernel's own
    and ``shape_model`` the model)."""

    def __init__(self, torch, cfg, device, suffix: str = "",
                 mp: int = 8) -> None:
        self.torch = torch
        self.cfg = cfg
        self.suffix = suffix
        self.dev = torch.device(device)
        self.g = torch.Generator(device=self.dev).manual_seed(1234)
        self.L, self.P, self.ps = 4, 512, 128
        self.Hq, self.Hkv, self.D = cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.MP = mp                         # pages a row: 8 = 1024 / 128
        shape = (self.L, self.P, self.ps, self.Hkv, self.D)
        self.kp = self.randn(*shape)
        self.vp = self.randn(*shape)
        # Disjoint page tables, as the allocator hands them out.
        perm = torch.randperm(self.P - 1, generator=self.g,
                              device=self.dev)[:8 * self.MP] + 1
        self.pt8 = perm.reshape(8, self.MP).to(torch.int32).contiguous()
        self.layer = 2
        self.results = []

    def randn(self, *shape, dtype=None):
        t = self.torch.randn(shape, generator=self.g, device=self.dev)
        return t.to(dtype or self.torch.bfloat16)

    def i32(self, xs):
        return self.torch.tensor(xs, dtype=self.torch.int32, device=self.dev)

    def record(self, name, source, replaces, err, kernel, plain, library,
               nbytes, flops, peak=PEAK_BF16_FLOPS, **extra):
        """Time ``kernel`` (the wrapper) and ``library`` as device time
        (graph replay), the wrapper also per eager call (device time plus
        its host overhead), and ``plain`` per eager call (it syncs with
        the host, so it cannot be captured). ``library`` None: no one
        PyTorch call computes the same function (``library_ms`` null).
        ``peak``: the operations' rate (the fused writers' float32
        arithmetic runs outside the tensor cores)."""
        if self.suffix:
            extra.setdefault("entry", name)
            extra["shape_model"] = self.cfg.name
            name += self.suffix
        ms = graph_ms(kernel)
        lib_ms = graph_ms(library) if library is not None else None
        eager_ms, plain_ms = time_ms(kernel), time_ms(plain)
        b_ms, b_by = bound(nbytes, flops, peak)
        self.results.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms, "library_ms": lib_ms, **extra})
        log(f"[kernel] {name}: max_abs_err={err} ms={ms:.5f} "
            f"eager_ms={eager_ms:.5f} plain_ms={plain_ms:.5f} "
            f"library_ms={lib_ms} bound_ms={b_ms:.6f} ({b_by}, "
            f"{b_ms / ms:.4f} of it) {json.dumps(extra)}")

    def latent_pools(self):
        """A 4-layer pool pair of the MLA latent row (Hkv=1, D=576) with
        its own disjoint page table."""
        P = 128
        kp, vp = self.randn(4, P, self.ps, 1, 576), \
            self.randn(4, P, self.ps, 1, 576)
        perm = self.torch.randperm(P - 1, generator=self.g,
                                   device=self.dev)[:8 * self.MP] + 1
        return kp, vp, perm.reshape(8, self.MP).to(
            self.torch.int32).contiguous()

    # -- K1 ----------------------------------------------------------------
    def decode_writer(self, kv, pools=None):
        """K1 at llama3-1b's rows, timed; with ``pools`` (k, v, page
        table) at their geometry, checked only."""
        torch = self.torch
        kp, vp, pt8 = pools or (self.kp, self.vp, self.pt8)
        P, Hkv, D = kp.shape[1], kp.shape[3], kp.shape[4]
        B = 8
        row_bytes = Hkv * D * 2
        kn, vn = self.randn(B, Hkv, D), self.randn(B, Hkv, D)
        ctx = [117, 205, 298, 411, 150, 260, 333, 390]
        pos = self.i32([c - 1 for c in ctx])
        pt = pt8.clone()
        pt[5, 2] = 0                      # row 5's page is NULL: dropped
        active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                              device=self.dev)      # an inactive row
        ka, va = kp.clone(), vp.clone()
        kb, vb = kp.clone(), vp.clone()
        kv.paged_kv_update_layer(ka, va, kn, vn, pt, pos, active, self.layer)
        kv.paged_kv_update_layer_plain(kb, vb, kn, vn, pt, pos, active,
                                       self.layer)
        torch.cuda.synchronize()
        if not (torch.equal(ka, kb) and torch.equal(va, vb)):
            raise AssertionError(f"decode KV writer is not bit-exact at "
                                 f"(Hkv, D) = {(Hkv, D)}")
        changed = int((ka != kp).flatten(2).any(-1).sum())
        if changed != 6:                           # rows 5 and 6 dropped
            raise AssertionError(f"decode writer touched {changed} pages")
        if pools is not None:
            log(f"[kernel] paged_kv_update_layer bit-exact at (Hkv, D) = "
                f"{(Hkv, D)}")
            return
        all_on = torch.ones(B, dtype=torch.bool, device=self.dev)
        pt = pt8
        flat = (pt.long().gather(1, (pos.long() // self.ps)[:, None])[:, 0]
                * self.ps + pos.long() % self.ps)
        kf = ka[self.layer].view(P * self.ps, Hkv, D)
        vf = va[self.layer].view(P * self.ps, Hkv, D)

        def lib():
            kf.index_copy_(0, flat, kn)
            vf.index_copy_(0, flat, vn)
        nbytes = B * 2 * 2 * row_bytes + B * (4 + 4 + 1 + 4)
        self.record(
            "paged_kv_update_layer", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:162", 0.0,
            lambda: kv.paged_kv_update_layer(ka, va, kn, vn, pt, pos, all_on,
                                             self.layer),
            lambda: kv.paged_kv_update_layer_plain(kb, vb, kn, vn, pt, pos,
                                                   all_on, self.layer),
            lib, nbytes, 0.0, superseded_by="rope_kv_update_layer, "
            "latent_kv_update_layer (no served path launches K1 alone)")

    # -- K2 ----------------------------------------------------------------
    def prefill_writer(self, kv, pools=None):
        """K2 at llama3-1b's rows, timed; with ``pools``, checked only."""
        torch = self.torch
        kp, vp, pt8 = pools or (self.kp, self.vp, self.pt8)
        P, Hkv, D = kp.shape[1], kp.shape[3], kp.shape[4]
        B, T = 4, 256
        row_bytes = Hkv * D * 2
        kn, vn = self.randn(B, T, Hkv, D), self.randn(B, T, Hkv, D)
        pt = pt8[:B].contiguous()
        start = self.i32([0, 256, 128, 7])            # last row unaligned
        lens = self.i32([256, 144, 200, 97])
        ka, va = kp.clone(), vp.clone()
        kb, vb = kp.clone(), vp.clone()
        kv.paged_prefill_kv_update_layer(ka, va, kn, vn, pt, start, lens,
                                         self.layer)
        kv.paged_prefill_kv_update_layer_plain(kb, vb, kn, vn, pt, start,
                                               lens, self.layer)
        torch.cuda.synchronize()
        if not (torch.equal(ka, kb) and torch.equal(va, vb)):
            raise AssertionError(f"prefill KV writer is not bit-exact at "
                                 f"(Hkv, D) = {(Hkv, D)}")
        if pools is not None:
            log(f"[kernel] paged_prefill_kv_update_layer bit-exact at "
                f"(Hkv, D) = {(Hkv, D)}")
            return
        t = torch.arange(T, device=self.dev)
        valid = t[None, :] < lens.long()[:, None]
        pos = start.long()[:, None] + t[None, :]
        flat = (pt.long().gather(1, pos // self.ps) * self.ps
                + pos % self.ps)[valid]
        kr, vr = kn[valid], vn[valid]
        kf = ka[self.layer].view(P * self.ps, Hkv, D)
        vf = va[self.layer].view(P * self.ps, Hkv, D)

        def lib():
            kf.index_copy_(0, flat, kr)
            vf.index_copy_(0, flat, vr)
        n = int(lens.sum())
        nbytes = n * 2 * 2 * row_bytes + B * (4 * self.MP + 8)
        self.record(
            "paged_prefill_kv_update_layer", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:336", 0.0,
            lambda: kv.paged_prefill_kv_update_layer(ka, va, kn, vn, pt, start,
                                                     lens, self.layer),
            lambda: kv.paged_prefill_kv_update_layer_plain(
                kb, vb, kn, vn, pt, start, lens, self.layer),
            lib, nbytes, 0.0, superseded_by="rope_prefill_kv_update_layer, "
            "latent_prefill_kv_update_layer (no served path launches K2 "
            "alone)")

    # -- K1 / K2 fused with the rope of q and k ----------------------------
    def _rope_inputs(self, rope, B, T, starts):
        """Fresh q [B, T, Hq, D], k/v [B, T, Hkv, D] and llama3-1b's
        cos/sin [B, T, D/2] (its llama3 scaling) at starts[b] + t."""
        torch, cfg = self.torch, self.cfg
        pos = self.i32(starts).long()[:, None] \
            + torch.arange(T, device=self.dev)[None, :]
        if cfg.is_mrope:
            # Three distinct streams, as an image's (t, h, w) ids: the
            # sectioned tables of the multimodal rope.
            pos3 = torch.stack([pos, pos // 2, pos % 16], dim=1)
            cos, sin = rope.mrope_cos_sin(pos3, self.D, cfg.rope_theta,
                                          cfg.rope_scaling[1])
        elif cfg.rope_local_base_freq is not None:
            cos, sin = rope.layer_cos_sin(cfg, pos)[0]     # a local layer's
        else:
            cos, sin = rope.rope_cos_sin(pos, self.D, cfg.rope_theta,
                                         cfg.rope_scaling)
        return (self.randn(B, T, self.Hq, self.D),
                self.randn(B, T, self.Hkv, self.D),
                self.randn(B, T, self.Hkv, self.D), cos, sin)

    def _rope_same(self, fused, plain, q, k, v, cos, sin, pools, rest,
                   what):
        """``fused`` and ``plain`` on copies of the same q, k (and pools):
        the rotated q and k and both pools must be bit-exact, and the
        rotation must have changed q."""
        torch = self.torch
        outs = []
        for fn in (fused, plain):
            qc, kc = q.clone(), k.clone()
            pc = [p.clone() for p in pools] if pools else [None, None]
            fn(qc, kc, v, cos, sin, *pc, *rest)
            outs.append([qc, kc] + pc)
        torch.cuda.synchronize()
        for a, b, name in zip(*outs, ("q", "k", "k_pages", "v_pages")):
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} is not bit-exact")
        if torch.equal(outs[0][0], q):
            raise AssertionError(f"{what}: q was not rotated")
        log(f"[kernel] {what} bit-exact")

    def rope_decode_writer(self, kv, rope):
        """K1 fused with the rope (``rope_kv_update_layer``) at llama3-1b's
        decode rows (B=8, contexts 117-411, row 6 inactive, row 5's page
        NULL): bit-exact with pools and without (attend-then-write), then
        timed beside the unfused chain it replaces (two ``rotate`` + K1,
        one CUDA graph) and K1 alone."""
        torch = self.torch
        B = 8
        positions = [c - 1 for c in (117, 205, 298, 411, 150, 260, 333, 390)]
        q, k, v, cos, sin = self._rope_inputs(rope, B, 1, positions)
        pos = self.i32(positions)
        pt = self.pt8.clone()
        pt[5, 2] = 0
        active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                              device=self.dev)
        for pools, rest, mode in (
                ((self.kp, self.vp), (pt, pos, active, self.layer), "decode"),
                (None, (), "pool-less decode")):
            self._rope_same(kv.rope_kv_update_layer,
                            kv.rope_kv_update_layer_plain, q, k, v, cos, sin,
                            pools, rest, f"rope_kv_update_layer ({mode})")
        all_on = torch.ones(B, dtype=torch.bool, device=self.dev)
        ka, va, qa, kq = self.kp.clone(), self.vp.clone(), q.clone(), \
            k.clone()
        kb, vb, qb, kqb = self.kp.clone(), self.vp.clone(), q.clone(), \
            k.clone()
        args = (self.pt8, pos, all_on, self.layer)

        def unfused():                    # the unfused chain it replaces
            qr, kr = rope.rotate(qa, cos, sin), rope.rotate(kq, cos, sin)
            kv.paged_kv_update_layer(ka, va, kr[:, 0], v[:, 0], *args)
            return qr
        # q and k read and written, v read, cos/sin read, k and v rows
        # written to the pool, the row metadata read.
        nbytes = (B * (2 * self.Hq + 3 * self.Hkv) * self.D * 2
                  + 2 * B * self.D // 2 * 4 + B * 2 * self.Hkv * self.D * 2
                  + B * (4 + 4 + 1 + 4))
        self.record(
            "rope_kv_update_layer", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:162", 0.0,
            lambda: kv.rope_kv_update_layer(qa, kq, v, cos, sin, ka, va,
                                            *args),
            lambda: kv.rope_kv_update_layer_plain(qb, kqb, v, cos, sin, kb,
                                                  vb, *args),
            None, nbytes, 6.0 * B * (self.Hq + self.Hkv) * self.D // 2,
            PEAK_FP32_FLOPS, entry="rope_kv_update_layer",
            unfused_ms=graph_ms(unfused),
            writer_only_ms=graph_ms(lambda: kv.paged_kv_update_layer(
                ka, va, kq[:, 0], v[:, 0], *args)))

    def rope_prefill_writer(self, kv, rope):
        """K2 fused with the rope (``rope_prefill_kv_update_layer``):
        bit-exact on the 4 x 256 prefill batch (one start unaligned), a
        ragged batch (7 decode rows at mid-page starts and a 256-token
        window in a T = 256 bucket) and without pools; timed on the
        prefill batch beside the unfused chain (two ``rotate`` + K2) and
        K2 alone."""
        torch = self.torch
        ragged_starts = [c - 1 for c in (117, 205, 298, 411, 150, 260, 333)]
        for B, starts, lens, pools, mode in (
                (4, [0, 256, 128, 7], [256, 144, 200, 97], True, "prefill"),
                (8, ragged_starts + [0], [1] * 7 + [256], True,
                 "ragged window"),
                (4, [0, 256, 128, 7], [256, 144, 200, 97], False,
                 "pool-less prefill")):
            q, k, v, cos, sin = self._rope_inputs(rope, B, 256, starts)
            rest = (self.pt8[:B].contiguous(), self.i32(starts),
                    self.i32(lens), self.layer) if pools else ()
            self._rope_same(kv.rope_prefill_kv_update_layer,
                            kv.rope_prefill_kv_update_layer_plain, q, k, v,
                            cos, sin, (self.kp, self.vp) if pools else None,
                            rest, f"rope_prefill_kv_update_layer ({mode})")
        B, T = 4, 256
        starts, lens = [0, 256, 128, 7], [256, 144, 200, 97]
        q, k, v, cos, sin = self._rope_inputs(rope, B, T, starts)
        ka, va, qa, kq = self.kp.clone(), self.vp.clone(), q.clone(), \
            k.clone()
        kb, vb, qb, kqb = self.kp.clone(), self.vp.clone(), q.clone(), \
            k.clone()
        args = (self.pt8[:B].contiguous(), self.i32(starts), self.i32(lens),
                self.layer)

        def unfused():                    # the unfused chain it replaces
            qr, kr = rope.rotate(qa, cos, sin), rope.rotate(kq, cos, sin)
            kv.paged_prefill_kv_update_layer(ka, va, kr, v, *args)
            return qr
        n = sum(lens)
        nbytes = (B * T * (2 * self.Hq + 3 * self.Hkv) * self.D * 2
                  + 2 * B * T * self.D // 2 * 4
                  + n * 2 * self.Hkv * self.D * 2 + B * (4 * self.MP + 8))
        self.record(
            "rope_prefill_kv_update_layer", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:336", 0.0,
            lambda: kv.rope_prefill_kv_update_layer(qa, kq, v, cos, sin, ka,
                                                    va, *args),
            lambda: kv.rope_prefill_kv_update_layer_plain(
                qb, kqb, v, cos, sin, kb, vb, *args),
            None, nbytes, 6.0 * B * T * (self.Hq + self.Hkv) * self.D // 2,
            PEAK_FP32_FLOPS, entry="rope_prefill_kv_update_layer",
            unfused_ms=graph_ms(unfused),
            writer_only_ms=graph_ms(lambda: kv.paged_prefill_kv_update_layer(
                ka, va, kq, v, *args)))

    # -- K6 folded into the last layer's fused writer ----------------------
    def _fold_inputs(self, L, Hkv, D, P):
        """A decode step's rows for the all-layer mode: pools [L, P, 128,
        Hkv, D], staging [L, 8, Hkv, D] (random: the earlier layers'
        rows), positions 116-410 with row 6 inactive and row 5's page
        NULL."""
        torch = self.torch
        kp, vp = self.randn(L, P, self.ps, Hkv, D), \
            self.randn(L, P, self.ps, Hkv, D)
        perm = torch.randperm(P - 1, generator=self.g,
                              device=self.dev)[:8 * self.MP] + 1
        pt = perm.reshape(8, self.MP).to(torch.int32).contiguous()
        pt[5, 2] = 0
        positions = [c - 1 for c in (117, 205, 298, 411, 150, 260, 333, 390)]
        act = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                           device=self.dev)
        return kp, vp, pt, positions, self.i32(positions), act

    def fold_writers(self, kv, rope, mla_cfg):
        """K6 folded into the last layer's fused writer, the attend-then-
        write decode step: ``rope_kv_update_all_layers`` at llama3-1b's
        16 layers and ``latent_kv_update_all_layers`` at DeepSeek-V2-
        Lite's 27, each held to its plain version (the dense one bit for
        bit; the latent one's staged layers bit for bit and its own
        layer within ATTN_TOL, rope columns exact) and to the unfused
        chain it replaces (the pool-less writer, ``torch.stack`` of every
        layer's rows and K6: the same pool bytes), then timed beside that
        chain in one CUDA graph (``unfused_ms``) and K6 alone
        (``k6_only_ms``)."""
        torch = self.torch
        cfg, B = self.cfg, 8
        # Dense.
        L, Hkv, D = cfg.num_layers, self.Hkv, self.D
        kp, vp, pt, positions, pos, act = self._fold_inputs(L, Hkv, D, 128)
        q, k, v, cos, sin = self._rope_inputs(rope, B, 1, positions)
        k_stage, v_stage = self.randn(L, B, Hkv, D), self.randn(L, B, Hkv, D)
        outs = []
        for fn in (kv.rope_kv_update_all_layers,
                   kv.rope_kv_update_all_layers_plain):
            t = [x.clone() for x in (q, k, kp, vp, k_stage, v_stage)]
            fn(t[0], t[1], v, cos, sin, t[2], t[3], pt, pos, act, L - 1,
               t[4], t[5])
            outs.append(t)
        # The unfused chain: the pool-less writer, a stack of every
        # layer's rows, K6.
        t = [x.clone() for x in (q, k, kp, vp)]
        kv.rope_kv_update_layer(t[0], t[1], v, cos, sin)
        kv.paged_kv_update(t[2], t[3],
                           torch.cat([k_stage[:-1], t[1][None, :, 0]]),
                           torch.cat([v_stage[:-1], v[None, :, 0]]), pt, pos,
                           act)
        torch.cuda.synchronize()
        names = ("q", "k", "k_pages", "v_pages", "k_stage", "v_stage")
        for a, b, n in zip(*outs, names):
            if not torch.equal(a, b):
                raise AssertionError(f"rope_kv_update_all_layers: {n} is "
                                     f"not bit-exact with its plain version")
        for a, b, n in zip(outs[0][:4], t, names):
            if not torch.equal(a, b):
                raise AssertionError(f"rope_kv_update_all_layers: {n} is "
                                     f"not bit-exact with the unfused chain")
        changed = int((outs[0][2] != kp).flatten(3).any(-1).sum())
        if changed != 6 * L:                       # rows 5 and 6 dropped
            raise AssertionError(f"all-layer mode touched {changed} rows, "
                                 f"want {6 * L}")
        log("[kernel] rope_kv_update_all_layers bit-exact with its plain "
            "version and the unfused chain")
        qa, ka, kpa, vpa, ksa, vsa = (x.clone() for x in
                                      (q, k, kp, vp, k_stage, v_stage))
        qb, kb, kpb, vpb, ksb, vsb = (x.clone() for x in
                                      (q, k, kp, vp, k_stage, v_stage))
        all_on = torch.ones(B, dtype=torch.bool, device=self.dev)
        k_list = [x.clone() for x in k_stage[:-1]]
        v_list = [x.clone() for x in v_stage[:-1]]

        def unfused():
            kv.rope_kv_update_layer(qb, kb, v, cos, sin)
            kv.paged_kv_update(kpb, vpb, torch.stack(k_list + [kb[:, 0]]),
                               torch.stack(v_list + [v[:, 0]]), pt, pos,
                               all_on)
        row = Hkv * D * 2
        # q and k read and written, v, cos and sin read, k and v staged,
        # the earlier layers' staged rows read, every layer's row
        # written to both pools, the row metadata read.
        nbytes = (B * (2 * self.Hq + 3 * Hkv) * D * 2 + 2 * B * D // 2 * 4
                  + 2 * B * row + (L - 1) * B * 2 * row + L * B * 2 * row
                  + B * (4 + 4 + 1 + 4))
        self.record(
            "rope_kv_update_all_layers", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:77", 0.0,
            lambda: kv.rope_kv_update_all_layers(
                qa, ka, v, cos, sin, kpa, vpa, pt, pos, all_on, L - 1, ksa,
                vsa),
            lambda: kv.rope_kv_update_all_layers_plain(
                qa, ka, v, cos, sin, kpa, vpa, pt, pos, all_on, L - 1, ksa,
                vsa),
            None, nbytes, 6.0 * B * (self.Hq + Hkv) * D // 2,
            PEAK_FP32_FLOPS, entry="rope_kv_update_all_layers", layers=L,
            unfused_ms=graph_ms(unfused),
            k6_only_ms=graph_ms(lambda: kv.paged_kv_update(
                kpb, vpb, ksb, vsb, pt, pos, all_on)))
        del kp, vp, kpa, vpa, kpb, vpb
        # MLA latent rows.
        L = mla_cfg.num_layers
        r, dr = mla_cfg.kv_lora_rank, mla_cfg.qk_rope_head_dim
        W = r + dr
        kp, vp, pt, positions, pos, act = self._fold_inputs(L, 1, W, 80)
        cos, sin = rope.rope_cos_sin(pos.long()[:, None], dr,
                                     mla_cfg.rope_theta, mla_cfg.rope_scaling)
        ckv = self.randn(B, 1, W)
        weight = (1.0 + 0.1 * self.randn(r, dtype=torch.float32)).to(
            torch.bfloat16)
        args = (ckv, weight, cos, sin, mla_cfg.rms_norm_eps,
                mla_cfg.rope_interleave)
        stage = self.randn(L, B, 1, W)
        outs = []
        for fn in (kv.latent_kv_update_all_layers,
                   kv.latent_kv_update_all_layers_plain):
            t = [x.clone() for x in (kp, vp, stage)]
            fn(*args, t[0], t[1], pt, pos, act, L - 1, t[2])
            outs.append(t)
        torch.cuda.synchronize()
        (gk, gv, gs), (wk, wv, ws) = outs
        if not (torch.equal(gk[:-1], wk[:-1]) and torch.equal(gv[:-1], wv[:-1])
                and torch.equal(gs[:-1], ws[:-1])):
            raise AssertionError("latent_kv_update_all_layers: staged layers "
                                 "not bit-exact")
        if not torch.equal(gs[-1][..., r:], ws[-1][..., r:]):
            raise AssertionError("latent_kv_update_all_layers: rope columns "
                                 "not bit-exact")
        err = max(float((a[-1].float() - b[-1].float()).abs().max())
                  for a, b in ((gk, wk), (gv, wv), (gs, ws)))
        same_rows = torch.equal(gk[-1] != kp[-1], wk[-1] != kp[-1])
        if err > ATTN_TOL or not same_rows:
            raise AssertionError(f"latent_kv_update_all_layers: last layer "
                                 f"{err}")
        log(f"[kernel] latent_kv_update_all_layers: staged layers bit-exact, "
            f"its own layer max_abs_err={err}")
        ka, va, sa = kp.clone(), vp.clone(), stage.clone()
        kb, vb = kp.clone(), vp.clone()
        lat_list = [x.clone() for x in stage[:-1]]

        def unfused_latent():
            lat = kv.latent_kv_update_layer(*args)[:, 0]
            rows = torch.stack(lat_list + [lat])
            kv.paged_kv_update(kb, vb, rows, rows, pt, pos, all_on)
        row = W * 2
        nbytes = (B * W * 2 * 2 + r * 2 + 2 * B * dr // 2 * 4
                  + (L - 1) * B * row + L * B * 2 * row + B * (4 + 4 + 1 + 4))
        self.record(
            "latent_kv_update_all_layers", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:77", err,
            lambda: kv.latent_kv_update_all_layers(
                *args, ka, va, pt, pos, all_on, L - 1, sa),
            lambda: kv.latent_kv_update_all_layers_plain(
                *args, ka, va, pt, pos, all_on, L - 1, sa),
            None, nbytes, B * (3.0 * r + 3.0 * dr), PEAK_FP32_FLOPS,
            entry="latent_kv_update_all_layers", layers=L,
            unfused_ms=graph_ms(unfused_latent),
            k6_only_ms=graph_ms(lambda: kv.paged_kv_update(
                kb, vb, sa, sa, pt, pos, all_on)),
            shape=f"B=8 (Hkv, D) = (1, {W}) x {L} layers")

    def poison_current_slot(self, pa, mla_scale):
        """Why the fold may write before the last layer attends: with NaN
        in the pool slot at each row's cache length (where the fold
        writes the current rows), K3' and K3'' current give the same
        bits as without."""
        torch = self.torch
        B = 8
        cache = self.i32([116, 204, 297, 410, 149, 259, 0, 389])
        flat = (self.pt8.long().gather(1, (cache.long() // self.ps)[:, None])
                [:, 0] * self.ps + cache.long() % self.ps)
        q = self.randn(B, self.Hq, self.D)
        k_cur, v_cur = self.randn(B, self.Hkv, self.D), \
            self.randn(B, self.Hkv, self.D)
        kp, vp = self.kp.clone(), self.vp.clone()
        want = pa.paged_decode_attention_current(
            q, kp, vp, self.pt8, cache, k_cur, v_cur, self.layer)
        for pool in (kp, vp):
            pool[self.layer].view(-1, self.Hkv, self.D)[flat] = float("nan")
        got = pa.paged_decode_attention_current(
            q, kp, vp, self.pt8, cache, k_cur, v_cur, self.layer)
        lat = self.randn(4, 128, self.ps, 1, 576)
        qm, cur = self.randn(B, 16, 576), self.randn(B, 1, 576)
        pt_m = (torch.randperm(127, generator=self.g, device=self.dev)[
            :8 * self.MP] + 1).reshape(8, self.MP).to(torch.int32)
        want_m = pa.paged_decode_attention_mla_current(
            qm, lat, pt_m, cache, cur, 1, mla_scale)
        flat_m = (pt_m.long().gather(1, (cache.long() // self.ps)[:, None])
                  [:, 0] * self.ps + cache.long() % self.ps)
        lat[1].view(-1, 576)[flat_m] = float("nan")
        got_m = pa.paged_decode_attention_mla_current(
            qm, lat, pt_m, cache, cur, 1, mla_scale)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got_m, want_m)):
            raise AssertionError("a NaN at the cache-length slot reached "
                                 "K3' or K3'' current")
        log("[kernel] K3' and K3'' current unchanged by NaN at the "
            "cache-length slot")

    # -- K1 / K2 fused with the MLA latent row -----------------------------
    def _latent_close(self, fused, plain, args, pools, rest, what, r):
        """``fused`` and ``plain`` on copies of the same pools: the latent
        rows (returned and written to both pools) within ATTN_TOL, their
        rope columns bit-exact, and the same pool rows written. Returns
        the largest absolute error."""
        torch = self.torch
        outs = []
        for fn in (fused, plain):
            pc = [p.clone() for p in pools] if pools else [None, None]
            outs.append([fn(*args, *pc, *rest)] + pc)
        torch.cuda.synchronize()
        (got, gk, gv), (want, wk, wv) = outs
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: latent not finite")
        if not torch.equal(got[..., r:], want[..., r:]):
            raise AssertionError(f"{what}: rope columns not bit-exact")
        err = float((got.float() - want.float()).abs().max())
        if pools:
            for a, b, p0 in ((gk, wk, pools[0]), (gv, wv, pools[1])):
                if not torch.equal((a != p0).flatten(3).any(-1),
                                   (b != p0).flatten(3).any(-1)):
                    raise AssertionError(f"{what}: other pool rows written")
                err = max(err, float((a.float() - b.float()).abs().max()))
        if err > ATTN_TOL:
            raise AssertionError(f"{what}: max abs error {err}")
        log(f"[kernel] {what}: max_abs_err={err}")
        return err

    def latent_writers(self, kv, rope, mla_cfg):
        """K1 and K2 fused with the MLA latent row (``latent_kv_update_
        layer``, ``latent_prefill_kv_update_layer``) at DeepSeek-V2-Lite's
        geometry (ckv = h @ kv_a of width 512 + 64, yarn cos/sin,
        adjacent-pair rope): the decode rows (B=8, row 6 inactive, row 5's
        page NULL) and the 4 x 256 prefill batch, with pools and without,
        within ATTN_TOL (the norm's sum runs in another order; the rope
        columns bit-exact); each timed beside the unfused chain (rms_norm,
        rope, cat, then K1 / K2; one CUDA graph) and K1 / K2 alone."""
        torch = self.torch
        kp, vp, pt8 = self.latent_pools()
        r, dr = mla_cfg.kv_lora_rank, mla_cfg.qk_rope_head_dim
        W = r + dr
        weight = (1.0 + 0.1 * self.randn(r, dtype=torch.float32)).to(
            torch.bfloat16)
        eps, inter = mla_cfg.rms_norm_eps, mla_cfg.rope_interleave
        layer = 1
        decode_pos = [c - 1 for c in (117, 205, 298, 411, 150, 260, 333, 390)]
        for name, B, T, starts, lens in (
                ("latent_kv_update_layer", 8, 1, decode_pos, None),
                ("latent_prefill_kv_update_layer", 4, 256, [0, 256, 128, 7],
                 [256, 144, 200, 97])):
            fused = getattr(kv, name)
            plain = getattr(kv, name + "_plain")
            pos = self.i32(starts).long()[:, None] \
                + torch.arange(T, device=self.dev)[None, :]
            cos, sin = rope.rope_cos_sin(pos, dr, mla_cfg.rope_theta,
                                         mla_cfg.rope_scaling)
            ckv = self.randn(B, T, W)
            args = (ckv, weight, cos, sin, eps, inter)
            pt = pt8[:B].clone()
            if lens is None:
                pt[5, 2] = 0
                act = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                                   device=self.dev)
                rest = (pt, self.i32(starts), act, layer)
                n = int(act.sum())
            else:
                rest = (pt, self.i32(starts), self.i32(lens), layer)
                n = sum(lens)
            err = max(self._latent_close(fused, plain, args, p, re,
                                         f"{name} ({mode})", r)
                      for p, re, mode in (((kp, vp), rest, "pools"),
                                          (None, (), "pool-less")))
            if lens is None:                  # timed with every row on
                rest = (pt8[:B].contiguous(), self.i32(starts),
                        torch.ones(B, dtype=torch.bool, device=self.dev),
                        layer)
                n = B
            writer = (kv.paged_kv_update_layer if lens is None
                      else kv.paged_prefill_kv_update_layer)
            ka, va, kb, vb = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            fresh = kv.latent_prefill_kv_update_layer_plain(*args)
            if lens is None:
                fresh = fresh[:, 0]

            def unfused(args=args, writer=writer, rest=rest, T=T):
                lat = kv.latent_prefill_kv_update_layer_plain(*args)
                lat = lat[:, 0] if T == 1 else lat
                writer(ka, va, lat, lat, *rest)
            nbytes = (B * T * W * 2 * 2 + r * 2 + 2 * B * T * dr // 2 * 4
                      + n * 2 * W * 2
                      + B * (4 + 4 + 1 + 4 if lens is None
                             else 4 * self.MP + 8))
            self.record(
                name, f"{CSRC}/kv_update.cu",
                f"{PALLAS}/kv_update.py:{162 if lens is None else 336}", err,
                lambda f=fused, a=args, re=rest: f(*a, ka, va, *re),
                lambda p=plain, a=args, re=rest: p(*a, kb, vb, *re),
                None, nbytes, B * T * (3.0 * r + 3.0 * dr), PEAK_FP32_FLOPS,
                entry=name,
                unfused_ms=graph_ms(unfused),
                writer_only_ms=graph_ms(
                    lambda w=writer, f=fresh, re=rest: w(ka, va, f, f, *re)),
                shape=f"B={B} T={T} (Hkv, D) = (1, {W})")
        del kp, vp

    # -- K3 ----------------------------------------------------------------
    def decode_attention(self, pa, attention):
        torch = self.torch
        B = 8
        q = self.randn(B, self.Hq, self.D)
        ctx_list = [117, 205, 298, 411, 150, 260, 0, 390]   # row 6 inactive
        ctx = self.i32(ctx_list)
        act = ctx > 0
        sinks = self.randn(self.Hq, dtype=torch.float32)
        worst = 0.0
        for extras in ({}, {"sliding_window": 100},
                       {"logits_soft_cap": 30.0, "scale": 0.1},
                       {"sinks": sinks, "sliding_window": 64}):
            got = pa.paged_decode_attention(q, self.kp, self.vp, self.pt8,
                                            ctx, self.layer, **extras)
            want = pa.paged_decode_attention_plain(
                q, self.kp, self.vp, self.pt8, ctx, self.layer, **extras)
            torch.cuda.synchronize()
            g, w = got[act].float(), want[act].float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"decode attention not finite {extras}")
            if not torch.allclose(g, w, atol=ATTN_TOL, rtol=ATTN_TOL):
                raise AssertionError(
                    f"decode attention disagrees ({list(extras)}): "
                    f"{float((g - w).abs().max())}")
            if bool(got[~act].float().abs().max() != 0):
                raise AssertionError("inactive decode row not zero")
            worst = max(worst, float((g - w).abs().max()))
        S = self.MP * self.ps
        mask = (torch.arange(S, device=self.dev)[None, :]
                < ctx.long()[:, None])[:, None, None, :]
        mask[~act] = True                 # SDPA needs a key per row

        def lib():
            k = attention.gather_pages(self.kp[self.layer], self.pt8)
            v = attention.gather_pages(self.vp[self.layer], self.pt8)
            return sdpa(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        mask)
        keys = sum(ctx_list)
        row = self.Hkv * self.D * 2
        nbytes = keys * 2 * row + 2 * int(act.sum()) * self.Hq * self.D * 2 \
            + B * (4 + 4 * self.MP)
        flops = 4.0 * keys * self.Hq * self.D
        self.split_record(
            "paged_decode_attention", "paged_decode_attention",
            f"{CSRC}/paged_decode_attention.cu",
            lambda n: pa.paged_decode_attention(
                q, self.kp, self.vp, self.pt8, ctx, self.layer, num_splits=n),
            lambda: pa.paged_decode_attention_plain(
                q, self.kp, self.vp, self.pt8, ctx, self.layer),
            lib, nbytes, flops,
            pa.gqa_splits(B, self.Hkv, self.MP, self.ps, 0, False), act,
            worst)

    def decode_attention_null_lead(self, pa, attention):
        """K3 under a 100-token sliding window with each row's leading
        table entries NULL (page 0), as the engine leaves a table once it
        has released the pages every later window masks. Page 0 holds
        large values here, so a read of it outside the masked lanes
        would show; checked against the plain version on the same table,
        timed as the other K3 records."""
        torch = self.torch
        B, W = 8, 100
        q = self.randn(B, self.Hq, self.D)
        ctx_list = [117, 205, 298, 411, 150, 260, 0, 390]   # row 6 inactive
        ctx = self.i32(ctx_list)
        act = ctx > 0
        pt = self.pt8.clone()
        nulls = 0
        for b, c in enumerate(ctx_list):
            # Pages whose every position is below the window of the
            # row's one query (position c - 1).
            n = max(c - 1 - W, 0) // self.ps
            pt[b, :n] = 0
            nulls += n
        if not nulls:
            raise AssertionError("no NULL leading entry in the table")
        saved = (self.kp[self.layer, 0].clone(),
                 self.vp[self.layer, 0].clone())
        self.kp[self.layer, 0] = 300.0
        self.vp[self.layer, 0] = 300.0
        try:
            run = (lambda n=None: pa.paged_decode_attention(
                q, self.kp, self.vp, pt, ctx, self.layer, sliding_window=W,
                num_splits=n))
            plain = (lambda: pa.paged_decode_attention_plain(
                q, self.kp, self.vp, pt, ctx, self.layer, sliding_window=W))
            S = self.MP * self.ps
            pos = torch.arange(S, device=self.dev)[None, :]
            last = ctx.long()[:, None] - 1
            mask = ((pos <= last) & (pos > last - W))[:, None, None, :]
            mask[~act] = True              # SDPA needs a key per row

            def lib():
                k = attention.gather_pages(self.kp[self.layer], pt)
                v = attention.gather_pages(self.vp[self.layer], pt)
                return sdpa(q[:, :, None], k.transpose(1, 2),
                            v.transpose(1, 2), mask)
            keys = sum(min(c, W) for c in ctx_list)
            nbytes = keys * 2 * self.Hkv * self.D * 2 \
                + 2 * int(act.sum()) * self.Hq * self.D * 2 \
                + B * (4 + 4 * self.MP)
            flops = 4.0 * keys * self.Hq * self.D
            self.split_record(
                "paged_decode_attention_null_lead", "paged_decode_attention",
                f"{CSRC}/paged_decode_attention.cu", run, plain, lib, nbytes,
                flops, pa.gqa_splits(B, self.Hkv, self.MP, self.ps, W,
                                     False), act, null_entries=nulls,
                sliding_window=W)
        finally:
            self.kp[self.layer, 0] = saved[0]
            self.vp[self.layer, 0] = saved[1]

    # Split counts timed at the long shapes beside the wrapper's own.
    SPLIT_SWEEP = (4, 8, 12, 16, 24, 32, 48, 64)

    def split_record(self, name, entry, source, run, plain, lib, nbytes,
                     flops, splits, valid, worst=0.0, sweep=False, **extra):
        """A split decode kernel at one shape: ``run(None)`` (the
        wrapper's own split count, ``splits``) and ``run(1)`` (one split,
        one block per row and kv head: the unsplit yardstick, through the
        same kernel) checked against ``plain()`` on the ``valid`` rows
        (the others must be zero), then recorded with the second's device
        time beside the first's; with ``sweep``, also the device time at
        each of SPLIT_SWEEP (``split_sweep_ms``)."""
        want = plain()
        errs = [self.close(f"{name} S={s}", run(n), want, valid)
                for s, n in ((splits, None), (1, 1))]
        unsplit_ms = graph_ms(lambda: run(1))
        if sweep:
            extra["split_sweep_ms"] = {
                n: graph_ms(lambda n=n: run(n)) for n in self.SPLIT_SWEEP}
        self.record(name, source, f"{PALLAS}/paged_attention.py:154",
                    max([worst] + errs), lambda: run(None), plain, lib,
                    nbytes, flops, entry=entry, splits=splits,
                    unsplit_ms=unsplit_ms, **extra)

    def long_decode_rows(self, P):
        """The long decode shapes, over a pool of ``P`` pages of 128:
        (label, contexts, page table) for B = 8 rows of 2048-4096 keys
        (seeded) and B = 1 row of 4096, 32 pages a row."""
        rng = random.Random(6)
        ctx8 = [rng.randrange(2048, 4097) for _ in range(8)]
        perm = self.torch.randperm(P - 1, generator=self.g,
                                   device=self.dev)[:8 * 32] + 1
        pt = perm.reshape(8, 32).to(self.torch.int32).contiguous()
        return [("B=8 ctx 2048-4096", "long_b8", ctx8, pt),
                ("B=1 ctx 4096", "long_b1", [4096], pt[:1].contiguous())]

    def decode_attention_long(self, pa, attention):
        """K3 and K3' at the long shapes: contexts (cache lengths one
        less, with the current token's K/V apart), every row compared."""
        torch = self.torch
        for label, tag, ctx_list, pt in self.long_decode_rows(self.P):
            B, MP = len(ctx_list), pt.shape[1]
            q = self.randn(B, self.Hq, self.D)
            k_cur, v_cur = self.randn(B, self.Hkv, self.D), \
                self.randn(B, self.Hkv, self.D)
            ctx = self.i32(ctx_list)
            cache = self.i32([c - 1 for c in ctx_list])
            valid = torch.ones(B, dtype=torch.bool, device=self.dev)
            S = MP * self.ps
            pos = torch.arange(S + 1, device=self.dev)[None, :]
            keys = sum(ctx_list)
            nbytes = keys * 2 * self.Hkv * self.D * 2 \
                + 2 * B * self.Hq * self.D * 2 + B * (4 + 4 * MP)
            flops = 4.0 * keys * self.Hq * self.D

            def gathered(pool):
                return attention.gather_pages(pool[self.layer], pt)

            def lib(mask=(pos[:, :S] < ctx.long()[:, None])[:, None, None]):
                return sdpa(q[:, :, None], gathered(self.kp).transpose(1, 2),
                            gathered(self.vp).transpose(1, 2), mask)

            def lib_cur(mask=((pos < cache.long()[:, None])
                              | (pos == S))[:, None, None]):
                k = torch.cat([gathered(self.kp), k_cur[:, None]], dim=1)
                v = torch.cat([gathered(self.vp), v_cur[:, None]], dim=1)
                return sdpa(q[:, :, None], k.transpose(1, 2),
                            v.transpose(1, 2), mask)
            self.split_record(
                f"paged_decode_attention_{tag}", "paged_decode_attention",
                f"{CSRC}/paged_decode_attention.cu",
                lambda n: pa.paged_decode_attention(
                    q, self.kp, self.vp, pt, ctx, self.layer, num_splits=n),
                lambda: pa.paged_decode_attention_plain(
                    q, self.kp, self.vp, pt, ctx, self.layer),
                lib, nbytes, flops,
                pa.gqa_splits(B, self.Hkv, MP, self.ps, 0, False), valid,
                sweep=True, shape=label)
            self.split_record(
                f"paged_decode_attention_current_{tag}",
                "paged_decode_attention_current",
                f"{CSRC}/paged_decode_attention.cu",
                lambda n: pa.paged_decode_attention_current(
                    q, self.kp, self.vp, pt, cache, k_cur, v_cur, self.layer,
                    num_splits=n),
                lambda: pa.paged_decode_attention_current_plain(
                    q, self.kp, self.vp, pt, cache, k_cur, v_cur,
                    self.layer),
                lib_cur, nbytes, flops,
                pa.gqa_splits(B, self.Hkv, MP, self.ps, 0, True), valid,
                shape=label)

    # -- K4 ----------------------------------------------------------------
    def prefill_attention(self, pf, attention):
        torch = self.torch
        B, T = 4, 256
        q = self.randn(B, T, self.Hq, self.D)
        pt = self.pt8[:B].contiguous()
        q_start = self.i32([0, 256, 128, 0])
        lens_list = [256, 144, 200, 97]
        lens = self.i32(lens_list)
        sinks = self.randn(self.Hq, dtype=torch.float32)
        valid = (torch.arange(T, device=self.dev)[None, :]
                 < lens.long()[:, None])
        worst = 0.0
        for extras in self.arg_sets(sinks):
            worst = max(worst, self.close(
                f"prefill attention ({list(extras)})",
                pf.paged_prefill_attention(q, self.kp, self.vp, pt, q_start,
                                           lens, self.layer, **extras),
                pf.paged_prefill_attention_plain(
                    q, self.kp, self.vp, pt, q_start, lens, self.layer,
                    **extras), valid))
        S = self.MP * self.ps
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        mask = (kv_pos <= q_pos) & (kv_pos < (q_start + lens).long()[
            :, None, None])
        mask = mask[:, None]

        def lib():
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)
        starts = [0, 256, 128, 0]
        keys = sum(s + n for s, n in zip(starts, lens_list))
        pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts,
                                                             lens_list))
        row = self.Hkv * self.D * 2
        n_rows = sum(lens_list)
        nbytes = keys * 2 * row + 2 * n_rows * self.Hq * self.D * 2 \
            + B * (8 + 4 * self.MP)
        flops = 4.0 * pairs * self.Hq * self.D
        self.record(
            "paged_prefill_attention", f"{CSRC}/paged_prefill_attention.cu",
            f"{PALLAS}/prefill_attention.py:272", worst,
            lambda: pf.paged_prefill_attention(q, self.kp, self.vp, pt,
                                               q_start, lens, self.layer),
            lambda: pf.paged_prefill_attention_plain(
                q, self.kp, self.vp, pt, q_start, lens, self.layer),
            lib, nbytes, flops)


    # -- K5 ----------------------------------------------------------------
    def ragged_attention(self, ra, pa, pf, attention):
        """The ragged serving mix: 7 decode rows (length 1 at context - 1,
        contexts 117-411, mid-page) and a 256-token continuation window
        at q_start 128, in one B=8 x T=256 bucket; checked in the four
        argument sets and with a padding row, timed beside the split
        path and SDPA, and alone on its decode rows and on its window."""
        B, T = 8, 256
        ctx = [117, 205, 298, 411, 150, 260, 333]
        starts = [c - 1 for c in ctx] + [128]
        lens_list = [1] * 7 + [256]
        pt = self.pt8
        self._ragged_case(
            ra, pa, pf, attention, "ragged_paged_attention", starts,
            lens_list, pt, T, checks=True,
            # The kernel on each half of the batch alone (the other
            # half's rows at length 0): which rows set its time.
            parts={"decode_rows_only": lens_list[:7] + [0],
                   "window_only": [0] * 7 + [256]})

    def ragged_attention_long(self, ra, pa, pf, attention):
        """K5 at long decode rows, which no served phase reaches: B = 8
        decode rows of 2048-4096 keys (seeded) beside one 256-token
        window at q_start 512, in a T = 256 bucket, 32 pages a row."""
        rng = random.Random(8)
        ctx = [rng.randrange(2048, 4097) for _ in range(8)]
        starts = [c - 1 for c in ctx] + [512]
        lens_list = [1] * 8 + [256]
        perm = self.torch.randperm(self.P - 1, generator=self.g,
                                   device=self.dev)[:9 * 32] + 1
        pt = perm.reshape(9, 32).to(self.torch.int32).contiguous()
        self._ragged_case(
            ra, pa, pf, attention, "ragged_paged_attention_long", starts,
            lens_list, pt, 256, checks=False,
            parts={"decode_rows_only": lens_list[:8] + [0]},
            shape="B=9: 8 decode rows ctx 2048-4096 + a 256-token window",
            # Its decode rows' outputs are ~0.03 RMS (a mean over 2048+
            # random values): ATTN_TOL would let a dropped split pass.
            tol=LONG_ROW_TOL)

    def ragged_attention_wide(self, ra):
        """K5 at the largest bucket its row table holds, 256 rows (the
        engine refuses a larger one at start-up): decode rows, windows
        of 2-16 tokens and padding rows mixed, T = 16, checked in the
        four argument sets."""
        torch = self.torch
        B, T = 256, 16
        rng = random.Random(9)
        lens_list = [rng.choice([1, 1, 0, rng.randrange(2, T + 1)])
                     for _ in range(B)]
        starts = [rng.randrange(0, self.MP * self.ps - T) for _ in range(B)]
        pt = torch.randint(1, self.P, (B, self.MP), generator=self.g,
                           device=self.dev).to(torch.int32)
        q = self.randn(B, T, self.Hq, self.D)
        q_start, lens = self.i32(starts), self.i32(lens_list)
        valid = (torch.arange(T, device=self.dev)[None, :]
                 < lens.long()[:, None])
        worst = 0.0
        for extras in self.arg_sets(self.randn(self.Hq,
                                               dtype=torch.float32)):
            args = (q, self.kp, self.vp, pt, q_start, lens, self.layer)
            worst = max(worst, self.close(
                f"ragged_paged_attention B={B} ({list(extras)})",
                ra.ragged_paged_attention(*args, **extras),
                ra.ragged_paged_attention_plain(*args, **extras), valid))
        log(f"[kernel] ragged_paged_attention at B={B} x T={T} "
            f"({lens_list.count(1)} decode rows): all four argument sets "
            f"within {ATTN_TOL}, max abs err {worst}")

    def ragged_attention_rows(self, ra):
        """K5 past its row table: 300 rows (299 decode rows of 1-255 keys
        and one 256-token window, T = 256, two-page tables), which the
        wrapper cuts into two launches (256 + 44 rows), against the plain
        version of the whole batch, in the four argument sets."""
        torch = self.torch
        B, T, MP = 300, 256, 2
        rng = random.Random(17)
        lens_list = [T] + [1] * (B - 1)
        starts = [0] + [rng.randrange(0, MP * self.ps - 1)
                        for _ in range(B - 1)]
        pt = torch.randint(1, self.P, (B, MP), generator=self.g,
                           device=self.dev).to(torch.int32)
        q = self.randn(B, T, self.Hq, self.D)
        q_start, lens = self.i32(starts), self.i32(lens_list)
        valid = (torch.arange(T, device=self.dev)[None, :]
                 < lens.long()[:, None])
        plan = ra.launch_plan(B, T, self.Hq // self.Hkv)
        worst = 0.0
        for extras in self.arg_sets(self.randn(self.Hq,
                                               dtype=torch.float32)):
            args = (q, self.kp, self.vp, pt, q_start, lens, self.layer)
            n0 = ra.ragged_paged_attention.launches
            got = ra.ragged_paged_attention(*args, **extras)
            if ra.ragged_paged_attention.launches - n0 != len(plan) or \
                    len(plan) != 2:
                raise AssertionError(f"300 rows in {len(plan)} launches")
            worst = max(worst, self.close(
                f"ragged_paged_attention B={B} ({list(extras)})", got,
                ra.ragged_paged_attention_plain(*args, **extras), valid))
            del got
        log(f"[kernel] ragged_paged_attention at B={B} x T={T} (299 decode "
            f"rows, one {T}-token window) in {len(plan)} launches {plan}: "
            f"all four argument sets within {ATTN_TOL}, max abs err {worst}")

    def _ragged_nbytes(self, starts, lens_list, T, MP):
        """K5's bytes: the live keys' K and V, the valid query rows of q
        and the whole [B, T, Hq, D] output (padding rows are written as
        zeros), each once, and the row metadata; also the count that
        takes the output for the valid rows only, as older records
        did."""
        B = len(lens_list)
        keys = sum(s + n for s, n in zip(starts, lens_list) if n > 0)
        row = self.Hkv * self.D * 2
        head_rows = self.Hq * self.D * 2
        n_rows = sum(lens_list)
        meta = B * (8 + 4 * MP)
        full = keys * 2 * row + n_rows * head_rows + B * T * head_rows
        return full + meta, keys * 2 * row + 2 * n_rows * head_rows + meta

    def _ragged_flops(self, starts, lens_list):
        """The products' operations: 4 D per (query, key) pair a head."""
        pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts,
                                                             lens_list))
        return 4.0 * pairs * self.Hq * self.D

    def _ragged_case(self, ra, pa, pf, attention, name, starts, lens_list,
                     pt, T, checks, parts, shape=None, tol=ATTN_TOL):
        torch = self.torch
        B, MP = len(lens_list), pt.shape[1]
        q = self.randn(B, T, self.Hq, self.D)
        q_start, lens = self.i32(starts), self.i32(lens_list)
        sinks = self.randn(self.Hq, dtype=torch.float32)
        cases = [({}, lens_list)]
        if checks:
            # The last case makes row 6 a padding row of length 0.
            cases = [(extras, lens_list) for extras in self.arg_sets(sinks)]
            cases.append(({}, lens_list[:6] + [0] + lens_list[7:]))
        cases += [({}, p) for p in parts.values()]
        worst = 0.0
        for extras, lens_case in cases:
            lc = self.i32(lens_case)
            valid = (torch.arange(T, device=self.dev)[None, :]
                     < lc.long()[:, None])
            args = (q, self.kp, self.vp, pt, q_start, lc, self.layer)
            want = ra.ragged_paged_attention_plain(*args, **extras)
            worst = max(worst, self.close(
                f"{name} ({list(extras)}, lengths {lens_case})",
                ra.ragged_paged_attention(*args, **extras), want, valid,
                tol))
            if lens_case is lens_list and not extras:
                # The scale the error is read against: the reference's
                # RMS over its decode rows and over all its valid rows.
                dec_rows = valid.clone()
                dec_rows[self.i32(lens_case).long() != 1] = False
                ref_rms = {
                    "decode_rows": float(want[dec_rows].float().pow(2)
                                         .mean().sqrt()),
                    "valid_rows": float(want[valid].float().pow(2)
                                        .mean().sqrt())}
        S = MP * self.ps
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        mask = (kv_pos <= q_pos) & (kv_pos < (q_start + lens).long()[
            :, None, None])
        mask = mask[:, None]

        def lib():
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)
        # The split path's two launches for the same work: the decode
        # kernel on the decode rows, the prefill kernel on the windows.
        dec = [b for b, n in enumerate(lens_list) if n == 1]
        win = [b for b, n in enumerate(lens_list) if n > 1]
        q_dec = q[dec, 0].contiguous()
        ctx_t = self.i32([starts[b] + 1 for b in dec])
        pt_dec, pt_win = pt[dec].contiguous(), pt[win].contiguous()
        q_win = q[win].contiguous()
        win_start = self.i32([starts[b] for b in win])
        win_len = self.i32([lens_list[b] for b in win])

        def split_decode():
            pa.paged_decode_attention(q_dec, self.kp, self.vp, pt_dec, ctx_t,
                                      self.layer)

        def split_window():
            pf.paged_prefill_attention(q_win, self.kp, self.vp, pt_win,
                                       win_start, win_len, self.layer)

        def split():
            split_decode()
            split_window()
        splits = pa.gqa_splits(B, self.Hkv, MP, self.ps, 0, False)
        blocks = ra.ragged_blocks(B, T, self.Hq, self.Hkv, self.D, splits)
        # The split path, and each of its launches alone: K3 on the
        # decode rows, K4 on the windows.
        extra = {"split_ms": graph_ms(split),
                 "split_decode_k3_ms": graph_ms(split_decode),
                 "split_window_k4_ms": graph_ms(split_window),
                 "splits": splits, "grid_blocks": blocks,
                 "tolerance": tol, "ref_rms": ref_rms}

        def work_record(tag, lens_case):
            w = ra.ragged_work(starts, lens_case, T, self.Hq, self.Hkv,
                               self.D, MP, self.ps, 0, splits)
            log(f"[kernel] {name} {tag.rstrip('_') or 'mix'}: derived by "
                f"the host rule ragged_work, not measured: "
                f"{w.live_blocks(blocks, self.D)} of {blocks} blocks with "
                f"work; {len(w.windows)} window tiles, {len(w.splits)} "
                f"decode splits, {len(w.zeros)} zero ranges")
            nbytes, _ = self._ragged_nbytes(starts, lens_case, T, MP)
            extra[f"{tag}bound_ms"] = bound(
                nbytes, self._ragged_flops(starts, lens_case))[0]
        work_record("", lens_list)
        for tag, lens_case in parts.items():
            lc = self.i32(lens_case)
            extra[f"{tag}_ms"] = graph_ms(
                lambda lc=lc: ra.ragged_paged_attention(
                    q, self.kp, self.vp, pt, q_start, lc, self.layer))
            work_record(f"{tag}_", lens_case)
        del extra["bound_ms"]             # the record's own bound_ms
        flops = self._ragged_flops(starts, lens_list)
        nbytes, nbytes_valid = self._ragged_nbytes(starts, lens_list, T, MP)
        extra["bound_ms_valid_rows_only"] = bound(nbytes_valid, flops)[0]
        if shape:
            extra.update(entry="ragged_paged_attention", shape=shape)
        self.record(
            name, f"{CSRC}/ragged_paged_attention.cu",
            f"{PALLAS}/ragged_attention.py:191", worst,
            lambda: ra.ragged_paged_attention(q, self.kp, self.vp, pt,
                                              q_start, lens, self.layer),
            lambda: ra.ragged_paged_attention_plain(
                q, self.kp, self.vp, pt, q_start, lens, self.layer),
            lib, nbytes, flops, **extra)

    # -- K6 / K7 ------------------------------------------------------------
    def all_layer_writers(self, kv, L, Hkv, D, record):
        """K6 (a decode step: 8 rows, contexts 117-411, row 6 inactive)
        and K7 (the 4 x 256 prefill window batch, one start unaligned)
        over the ``L`` layers of a pool of (Hkv, D) rows: bit-exact
        against the plain version; with ``record``, timed as well."""
        torch = self.torch
        P, MP = 128, self.MP
        shape = (L, P, self.ps, Hkv, D)
        kp, vp = self.randn(*shape), self.randn(*shape)
        perm = torch.randperm(P - 1, generator=self.g,
                              device=self.dev)[:8 * MP] + 1
        pt8 = perm.reshape(8, MP).to(torch.int32).contiguous()
        rows = [self._decode_writer_all(kv, kp, vp, pt8),
                self._prefill_writer_all(kv, kp, vp, pt8)]
        if not record:
            log(f"[kernel] all-layer writers bit-exact at (L, Hkv, D) = "
                f"{(L, Hkv, D)}")
            return
        for name, replaces, kernel, plain, lib, nbytes, extra in rows:
            extra = {k: graph_ms(f) for k, f in extra.items()}
            if name == "paged_kv_update":
                extra["superseded_by"] = (
                    "rope_kv_update_all_layers, latent_kv_update_all_layers "
                    "(no served path launches K6 alone)")
            self.record(name, f"{CSRC}/kv_update.cu", replaces, 0.0, kernel,
                        plain, lib, nbytes, 0.0, layers=L, **extra)

    def _same(self, a, b, what, geometry):
        self.torch.cuda.synchronize()
        if not (self.torch.equal(a[0], b[0]) and self.torch.equal(a[1], b[1])):
            raise AssertionError(f"{what} is not bit-exact at (L, Hkv, D) = "
                                 f"{geometry}")

    def _decode_writer_all(self, kv, kp, vp, pt8):
        torch = self.torch
        L, P, ps, Hkv, D = kp.shape
        B = 8
        ctx = [117, 205, 298, 411, 150, 260, 333, 390]
        pos = self.i32([c - 1 for c in ctx])
        active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                              device=self.dev)
        kn, vn = self.randn(L, B, Hkv, D), self.randn(L, B, Hkv, D)
        pt = pt8.clone()
        pt[5, 2] = 0                      # row 5's page is NULL: dropped
        ka, va, kb, vb = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        kv.paged_kv_update(ka, va, kn, vn, pt, pos, active)
        kv.paged_kv_update_plain(kb, vb, kn, vn, pt, pos, active)
        self._same((ka, va), (kb, vb), "all-layer decode KV writer",
                   (L, Hkv, D))
        changed = int((ka != kp).flatten(3).any(-1).sum())
        if changed != 6 * L:                      # rows 5 and 6 dropped
            raise AssertionError(f"all-layer decode writer touched "
                                 f"{changed} rows, want {6 * L}")
        act_rows = active.nonzero()[:, 0]
        flat = (pt8.long().gather(1, (pos.long() // ps)[:, None])[:, 0]
                * ps + pos.long() % ps)[act_rows]
        kn_a = kn[:, act_rows].contiguous()
        vn_a = vn[:, act_rows].contiguous()
        kf = ka.view(L, P * ps, Hkv, D)
        vf = va.view(L, P * ps, Hkv, D)

        def lib():
            kf.index_copy_(1, flat, kn_a)
            vf.index_copy_(1, flat, vn_a)

        def one_layer_writer_x_layers():   # what K6 replaces: L K1 launches
            for li in range(L):
                kv.paged_kv_update_layer(ka, va, kn[li], vn[li], pt8, pos,
                                         active, li)
        nbytes = int(active.sum()) * L * 2 * 2 * Hkv * D * 2 \
            + B * (4 + 4 + 1 + 4)
        return ("paged_kv_update", f"{PALLAS}/kv_update.py:77",
                lambda: kv.paged_kv_update(ka, va, kn, vn, pt8, pos, active),
                lambda: kv.paged_kv_update_plain(kb, vb, kn, vn, pt8, pos,
                                                 active),
                lib, nbytes,
                {"one_layer_writer_x_layers_ms": one_layer_writer_x_layers})

    def _prefill_writer_all(self, kv, kp, vp, pt8):
        torch = self.torch
        L, P, ps, Hkv, D = kp.shape
        B, T = 4, 256
        kn, vn = self.randn(L, B, T, Hkv, D), self.randn(L, B, T, Hkv, D)
        pt = pt8[:B].contiguous()
        start = self.i32([0, 256, 128, 7])            # last row unaligned
        lens = self.i32([256, 144, 200, 97])
        ka, va, kb, vb = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        kv.paged_prefill_kv_update(ka, va, kn, vn, pt, start, lens)
        kv.paged_prefill_kv_update_plain(kb, vb, kn, vn, pt, start, lens)
        self._same((ka, va), (kb, vb), "all-layer prefill KV writer",
                   (L, Hkv, D))
        t = torch.arange(T, device=self.dev)
        valid = t[None, :] < lens.long()[:, None]
        pos = start.long()[:, None] + t[None, :]
        flat = (pt.long().gather(1, pos // ps) * ps + pos % ps)[valid]
        kr, vr = kn[:, valid].contiguous(), vn[:, valid].contiguous()
        kf = ka.view(L, P * ps, Hkv, D)
        vf = va.view(L, P * ps, Hkv, D)

        def lib():
            kf.index_copy_(1, flat, kr)
            vf.index_copy_(1, flat, vr)
        nbytes = int(lens.sum()) * L * 2 * 2 * Hkv * D * 2 \
            + B * (4 * self.MP + 8)
        return ("paged_prefill_kv_update", f"{PALLAS}/kv_update.py:244",
                lambda: kv.paged_prefill_kv_update(ka, va, kn, vn, pt, start,
                                                   lens),
                lambda: kv.paged_prefill_kv_update_plain(kb, vb, kn, vn, pt,
                                                         start, lens),
                lib, nbytes, {})

    # -- K3' ---------------------------------------------------------------
    def decode_attention_current(self, pa, attention):
        """K3' at the decode shape: cache lengths 116-410 and an inactive
        row with cache length 0 (it attends to its current token alone),
        all rows compared. The pool slot at each cache length holds a
        random value unlike k_cur/v_cur (stale in this order)."""
        torch = self.torch
        B = 8
        q = self.randn(B, self.Hq, self.D)
        k_cur, v_cur = self.randn(B, self.Hkv, self.D), \
            self.randn(B, self.Hkv, self.D)
        cache_list = [116, 204, 297, 410, 149, 259, 0, 389]
        cache = self.i32(cache_list)
        sinks = self.randn(self.Hq, dtype=torch.float32)
        worst = 0.0
        for extras in ({}, {"sliding_window": 100},
                       {"logits_soft_cap": 30.0, "scale": 0.1},
                       {"sinks": sinks, "sliding_window": 64},
                       {"sliding_window": 1}):
            got = pa.paged_decode_attention_current(
                q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                self.layer, **extras)
            want = pa.paged_decode_attention_current_plain(
                q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                self.layer, **extras)
            torch.cuda.synchronize()
            g, w = got.float(), want.float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"decode attention (current) not "
                                     f"finite {list(extras)}")
            if not torch.allclose(g, w, atol=ATTN_TOL, rtol=ATTN_TOL):
                raise AssertionError(
                    f"decode attention (current) disagrees "
                    f"({list(extras)}): {float((g - w).abs().max())}")
            worst = max(worst, float((g - w).abs().max()))
        S = self.MP * self.ps
        pos = torch.arange(S + 1, device=self.dev)[None, :]
        mask = ((pos < cache.long()[:, None]) | (pos == S))[:, None, None, :]

        def lib():
            k = torch.cat([attention.gather_pages(self.kp[self.layer],
                                                  self.pt8),
                           k_cur[:, None]], dim=1)
            v = torch.cat([attention.gather_pages(self.vp[self.layer],
                                                  self.pt8),
                           v_cur[:, None]], dim=1)
            return sdpa(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        mask)
        keys = sum(cache_list) + B           # the current keys included
        row = self.Hkv * self.D * 2
        nbytes = keys * 2 * row + 2 * B * self.Hq * self.D * 2 \
            + B * (4 + 4 * self.MP)
        flops = 4.0 * keys * self.Hq * self.D
        self.split_record(
            "paged_decode_attention_current",
            "paged_decode_attention_current",
            f"{CSRC}/paged_decode_attention.cu",
            lambda n: pa.paged_decode_attention_current(
                q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                self.layer, num_splits=n),
            lambda: pa.paged_decode_attention_current_plain(
                q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                self.layer),
            lib, nbytes, flops,
            pa.gqa_splits(B, self.Hkv, self.MP, self.ps, 0, True),
            torch.ones(B, dtype=torch.bool, device=self.dev), worst)

    # -- K4' ---------------------------------------------------------------
    def prefill_attention_fresh(self, pf, attention):
        """K4' at the 4 x 256 prefill shape with q_start 0/256/128/0: the
        window's K/V as fresh operands; the pool's window slots hold
        random values unlike them (stale in this order)."""
        torch = self.torch
        B, T = 4, 256
        q = self.randn(B, T, self.Hq, self.D)
        k_fresh, v_fresh = self.randn(B, T, self.Hkv, self.D), \
            self.randn(B, T, self.Hkv, self.D)
        pt = self.pt8[:B].contiguous()
        starts = [0, 256, 128, 0]
        lens_list = [256, 144, 200, 97]
        q_start, lens = self.i32(starts), self.i32(lens_list)
        sinks = self.randn(self.Hq, dtype=torch.float32)
        valid = (torch.arange(T, device=self.dev)[None, :]
                 < lens.long()[:, None])
        worst = 0.0
        for extras in self.arg_sets(sinks):
            args = (q, k_fresh, v_fresh, self.kp, self.vp, pt, q_start, lens,
                    self.layer)
            worst = max(worst, self.close(
                f"prefill attention (fresh) ({list(extras)})",
                pf.paged_prefill_attention_fresh(*args, **extras),
                pf.paged_prefill_attention_fresh_plain(*args, **extras),
                valid))
        S = self.MP * self.ps
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        mask = (kv_pos <= q_pos) & (kv_pos < (q_start + lens).long()[
            :, None, None])
        mask = mask[:, None]
        idx = (q_start.long()[:, None] + torch.arange(T, device=self.dev))[
            :, :, None, None].expand(-1, -1, self.Hkv, self.D)

        def lib():
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            k.scatter_(1, idx, k_fresh)
            v.scatter_(1, idx, v_fresh)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)
        keys = sum(s + n for s, n in zip(starts, lens_list))
        pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts,
                                                             lens_list))
        row = self.Hkv * self.D * 2
        n_rows = sum(lens_list)
        nbytes = keys * 2 * row + 2 * n_rows * self.Hq * self.D * 2 \
            + B * (8 + 4 * self.MP)
        flops = 4.0 * pairs * self.Hq * self.D
        self.record(
            "paged_prefill_attention_fresh",
            f"{CSRC}/paged_prefill_attention.cu",
            f"{PALLAS}/prefill_attention.py:272", worst,
            lambda: pf.paged_prefill_attention_fresh(
                q, k_fresh, v_fresh, self.kp, self.vp, pt, q_start, lens,
                self.layer),
            lambda: pf.paged_prefill_attention_fresh_plain(
                q, k_fresh, v_fresh, self.kp, self.vp, pt, q_start, lens,
                self.layer),
            lib, nbytes, flops)

    # -- K4, K5, K4' + K7 at phase 7's cached starts -----------------------
    def cached_start(self, pf, ra, pa, kv, attention):
        """Phase 7's warm windows: three requests whose first 1,024
        tokens (8 pages) the prefix cache holds prefill their tails of
        180, 260 and 300 tokens from start 1,024, in one T = 512 bucket
        of B = 4 rows, tables 16 pages wide (11 pages cover 1,325
        positions). K4 with a padding row beside them; K5 with a decode
        row (context 1,141) before them, as a ragged step would carry
        the cold request; K4' (the window's K/V as fresh operands, the
        pool's window slots stale) with K7 writing the windows into all
        4 layers of the pool after it, as an attend-then-write step
        does (its record also times K4' and K7 in one graph,
        ``with_k7_ms``). Each checked against its plain version and timed
        beside the library: SDPA over ``gather_pages`` (for K4' the fresh
        window scattered in first) and, for K7, ``index_copy_``."""
        torch = self.torch
        B, T, MP = 4, 512, 16
        perm = torch.randperm(self.P - 1, generator=self.g,
                              device=self.dev)[:B * MP] + 1
        pt = perm.reshape(B, MP).to(torch.int32).contiguous()
        tails = [180, 260, 300]
        shape = ("B=4, T=512: windows of 180/260/300 tokens at start "
                 "1,024, page 128, tables 16 pages wide")
        # K5: a decode row first, then the three windows.
        self._ragged_case(
            ra, pa, pf, attention, "ragged_paged_attention_cached_start",
            [1140] + [1024] * 3, [1] + tails, pt, T, checks=False,
            parts={"windows_only": [0] + tails},
            shape=shape + " after a decode row at context 1,141")
        # K4 and K4' + K7: the three windows and a padding row.
        starts, lens_list = [1024] * 3 + [0], tails + [0]
        q = self.randn(B, T, self.Hq, self.D)
        q_start, lens = self.i32(starts), self.i32(lens_list)
        valid = (torch.arange(T, device=self.dev)[None, :]
                 < lens.long()[:, None])
        args = (self.kp, self.vp, pt, q_start, lens, self.layer)
        err = self.close("K4 at a cached start",
                         pf.paged_prefill_attention(q, *args),
                         pf.paged_prefill_attention_plain(q, *args), valid)
        S = MP * self.ps
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        mask = ((kv_pos <= q_pos) & (kv_pos < (q_start + lens).long()[
            :, None, None]))[:, None]

        def lib():
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)
        keys = sum(st + n for st, n in zip(starts, lens_list) if n)
        pairs = sum(n * st + n * (n + 1) // 2
                    for st, n in zip(starts, lens_list))
        row = self.Hkv * self.D * 2
        n_rows = sum(lens_list)
        nbytes = keys * 2 * row + 2 * n_rows * self.Hq * self.D * 2 \
            + B * (8 + 4 * MP)
        flops = 4.0 * pairs * self.Hq * self.D
        self.record(
            "paged_prefill_attention_cached_start",
            f"{CSRC}/paged_prefill_attention.cu",
            f"{PALLAS}/prefill_attention.py:272", err,
            lambda: pf.paged_prefill_attention(q, *args),
            lambda: pf.paged_prefill_attention_plain(q, *args), lib,
            nbytes, flops, entry="paged_prefill_attention", shape=shape)
        # K4' + K7 on copies of the pools (K7 writes them).
        L = self.L
        kn = self.randn(L, B, T, self.Hkv, self.D)
        vn = self.randn(L, B, T, self.Hkv, self.D)
        kf, vf = kn[self.layer], vn[self.layer]
        ka, va, kb, vb = (self.kp.clone(), self.vp.clone(),
                          self.kp.clone(), self.vp.clone())
        fresh = (q, kf, vf, ka, va, pt, q_start, lens, self.layer)
        err = self.close("K4' at a cached start",
                         pf.paged_prefill_attention_fresh(*fresh),
                         pf.paged_prefill_attention_fresh_plain(*fresh),
                         valid)
        kv.paged_prefill_kv_update(ka, va, kn, vn, pt, q_start, lens)
        kv.paged_prefill_kv_update_plain(kb, vb, kn, vn, pt, q_start, lens)
        self._same((ka, va), (kb, vb), "K7 at a cached start",
                   (L, self.Hkv, self.D))

        t = torch.arange(T, device=self.dev)
        pos = q_start.long()[:, None] + t[None, :]
        idx = pos[:, :, None, None].expand(-1, -1, self.Hkv, self.D)

        def lib_fresh():
            k = attention.gather_pages(ka[self.layer], pt)
            v = attention.gather_pages(va[self.layer], pt)
            k.scatter_(1, idx, kf)
            v.scatter_(1, idx, vf)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)

        def both():
            pf.paged_prefill_attention_fresh(*fresh)
            kv.paged_prefill_kv_update(ka, va, kn, vn, pt, q_start, lens)
        self.record(
            "paged_prefill_attention_fresh_cached_start",
            f"{CSRC}/paged_prefill_attention.cu",
            f"{PALLAS}/prefill_attention.py:272", err,
            lambda: pf.paged_prefill_attention_fresh(*fresh),
            lambda: pf.paged_prefill_attention_fresh_plain(
                q, kf, vf, kb, vb, pt, q_start, lens, self.layer),
            lib_fresh, nbytes, flops,
            entry="paged_prefill_attention_fresh", shape=shape,
            with_k7_ms=graph_ms(both))
        flat = (pt.long().gather(1, pos // self.ps) * self.ps
                + pos % self.ps)[valid]
        kr, vr = kn[:, valid].contiguous(), vn[:, valid].contiguous()
        kflat = ka.view(L, self.P * self.ps, self.Hkv, self.D)
        vflat = va.view(L, self.P * self.ps, self.Hkv, self.D)

        def lib_write():
            kflat.index_copy_(1, flat, kr)
            vflat.index_copy_(1, flat, vr)
        self.record(
            "paged_prefill_kv_update_cached_start", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:244", 0.0,
            lambda: kv.paged_prefill_kv_update(ka, va, kn, vn, pt, q_start,
                                               lens),
            lambda: kv.paged_prefill_kv_update_plain(kb, vb, kn, vn, pt,
                                                     q_start, lens),
            lib_write, n_rows * L * 2 * 2 * self.Hkv * self.D * 2
            + B * (4 * MP + 8), 0.0, entry="paged_prefill_kv_update",
            layers=L, shape=shape + "; all 4 layers of the pool")
        del ka, va, kb, vb

    # -- K4, K4', K5 beyond the serving shape -------------------------------
    @staticmethod
    def arg_sets(sinks):
        """The attention kernels' four argument sets: plain; window;
        soft-cap and scale; sinks and window."""
        return ({}, {"sliding_window": 100},
                {"logits_soft_cap": 30.0, "scale": 0.1},
                {"sinks": sinks, "sliding_window": 64})

    def close(self, what, got, want, valid, tol=ATTN_TOL) -> float:
        """Valid query rows within ``tol`` (atol = rtol) of the plain
        version, padded rows exactly zero, everything finite; returns the
        max abs error."""
        torch = self.torch
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what} not finite")
        g, w = got[valid].float(), want[valid].float()
        err = float((g - w).abs().max())
        if not torch.allclose(g, w, atol=tol, rtol=tol):
            raise AssertionError(f"{what} disagrees: {err}")
        if bool((~valid).any()) and bool(got[~valid].float().abs().max()
                                         != 0):
            raise AssertionError(f"{what}: padded rows not zero")
        return err

    def tile_kernels(self, pf, ra, kp, vp, pt, q, k_fresh, v_fresh, q_start,
                     lens, layer, label) -> float:
        """K4, K4' (pool slots of the window stale) and K5 on one input,
        in all four argument sets."""
        torch = self.torch
        sinks = self.randn(q.shape[2], dtype=torch.float32)
        valid = (torch.arange(q.shape[1], device=self.dev)[None, :]
                 < lens.long()[:, None])
        worst = 0.0
        for extras in self.arg_sets(sinks):
            args = (kp, vp, pt, q_start, lens, layer)
            fresh = (q, k_fresh, v_fresh) + args
            for kname, kernel, plain, a in (
                    ("K4", pf.paged_prefill_attention,
                     pf.paged_prefill_attention_plain, (q,) + args),
                    ("K4'", pf.paged_prefill_attention_fresh,
                     pf.paged_prefill_attention_fresh_plain, fresh),
                    ("K5", ra.ragged_paged_attention,
                     ra.ragged_paged_attention_plain, (q,) + args)):
                worst = max(worst, self.close(
                    f"{kname} {label} ({list(extras)})", kernel(*a, **extras),
                    plain(*a, **extras), valid))
        log(f"[kernel] K4, K4', K5 {label}: all four argument sets within "
            f"{ATTN_TOL}, max abs err {worst}")
        return worst

    def head_dims(self, pf, ra, pa):
        """K4, K4' and K5's window tiles at D = 128 (G = 3: 126 of a
        tile's 128 rows used) and D = 256 (G = 4) on a small pool of
        page size 16 (a 64-key chunk spans four pages): rows at q_start
        0/100/37 of lengths 160/90/1 in a T = 160 bucket (K5 serves the
        last as a decode row), windows that start and end mid-chunk.
        Then K3 and K3' on the same pools: contexts 300/0/45 (cache
        lengths one less), at the wrappers' split count, one split and
        three, in all four argument sets."""
        torch = self.torch
        B, T, ps, MP, P = 3, 160, 16, 20, 80
        for D, Hkv, G in ((128, 2, 3), (256, 2, 4)):
            kp, vp = self.randn(2, P, ps, Hkv, D), self.randn(2, P, ps, Hkv, D)
            perm = torch.randperm(P - 1, generator=self.g,
                                  device=self.dev)[:B * MP] + 1
            pt = perm.reshape(B, MP).to(torch.int32).contiguous()
            q = self.randn(B, T, Hkv * G, D)
            k_fresh, v_fresh = self.randn(B, T, Hkv, D), \
                self.randn(B, T, Hkv, D)
            self.tile_kernels(pf, ra, kp, vp, pt, q, k_fresh, v_fresh,
                              self.i32([0, 100, 37]), self.i32([160, 90, 1]),
                              1, f"at D={D} G={G}")
            qd = self.randn(B, Hkv * G, D)
            k_cur, v_cur = self.randn(B, Hkv, D), self.randn(B, Hkv, D)
            ctx, cache = self.i32([300, 0, 45]), self.i32([299, 0, 44])
            every = torch.ones(B, dtype=torch.bool, device=self.dev)
            sinks = self.randn(Hkv * G, dtype=torch.float32)
            for extras in self.arg_sets(sinks):
                for n in (None, 1, 3):
                    what = f"at D={D} G={G} S={n} {list(extras)}"
                    self.close(
                        f"decode attention {what}",
                        pa.paged_decode_attention(qd, kp, vp, pt, ctx, 1,
                                                  num_splits=n, **extras),
                        pa.paged_decode_attention_plain(qd, kp, vp, pt, ctx,
                                                        1, **extras),
                        ctx > 0)
                    self.close(
                        f"decode attention (current) {what}",
                        pa.paged_decode_attention_current(
                            qd, kp, vp, pt, cache, k_cur, v_cur, 1,
                            num_splits=n, **extras),
                        pa.paged_decode_attention_current_plain(
                            qd, kp, vp, pt, cache, k_cur, v_cur, 1, **extras),
                        every)

    def prefill_long(self, pf, ra, attention):
        """K4 and K4' at a long prompt, B = 2 x T = 2048 at q_start
        0/2048 (the second row's first 2048 keys in the pool), page tables
        of 32 pages per row from the 512-page pool: checked in all four
        argument sets (K5's window tiles too) and timed; there the bound
        is the tensor cores' operations."""
        torch = self.torch
        B, T, MP = 2, 2048, 32
        perm = torch.randperm(self.P - 1, generator=self.g,
                              device=self.dev)[:B * MP] + 1
        pt = perm.reshape(B, MP).to(torch.int32).contiguous()
        q = self.randn(B, T, self.Hq, self.D)
        k_fresh, v_fresh = self.randn(B, T, self.Hkv, self.D), \
            self.randn(B, T, self.Hkv, self.D)
        starts, lens_list = [0, 2048], [2048, 2048]
        q_start, lens = self.i32(starts), self.i32(lens_list)
        worst = self.tile_kernels(pf, ra, self.kp, self.vp, pt, q, k_fresh,
                                  v_fresh, q_start, lens, self.layer,
                                  "long prompt")
        S = MP * self.ps
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        mask = ((kv_pos <= q_pos) & (kv_pos < (q_start + lens).long()[
            :, None, None]))[:, None]
        idx = (q_start.long()[:, None] + torch.arange(T, device=self.dev))[
            :, :, None, None].expand(-1, -1, self.Hkv, self.D)

        def lib(fresh):
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            if fresh:
                k.scatter_(1, idx, k_fresh)
                v.scatter_(1, idx, v_fresh)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)
        keys = sum(s + n for s, n in zip(starts, lens_list))
        pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts,
                                                             lens_list))
        nbytes = keys * 2 * self.Hkv * self.D * 2 \
            + 2 * sum(lens_list) * self.Hq * self.D * 2 + B * (8 + 4 * MP)
        flops = 4.0 * pairs * self.Hq * self.D
        args = (self.kp, self.vp, pt, q_start, lens, self.layer)
        for name, kernel, plain, a, fresh in (
                ("paged_prefill_attention", pf.paged_prefill_attention,
                 pf.paged_prefill_attention_plain, (q,) + args, False),
                ("paged_prefill_attention_fresh",
                 pf.paged_prefill_attention_fresh,
                 pf.paged_prefill_attention_fresh_plain,
                 (q, k_fresh, v_fresh) + args, True)):
            self.record(f"{name}_long_prompt",
                        f"{CSRC}/paged_prefill_attention.cu",
                        f"{PALLAS}/prefill_attention.py:272", worst,
                        lambda a=a, kernel=kernel: kernel(*a),
                        lambda a=a, plain=plain: plain(*a),
                        lambda fresh=fresh: lib(fresh), nbytes, flops,
                        entry=name, shape="B=2 T=2048 q_start 0/2048")


    # -- K3'' -------------------------------------------------------------
    def mla_decode_attention(self, pa, attention, mla_cfg, scale):
        """K3'' in both forms at DeepSeek-V2-Lite's decode shape: B=8, 16
        heads, one latent head of 576, a 27-layer pool of page size 128.
        Pool-only: contexts 117-411, row 6 inactive (context 0, zeros).
        Current: cache lengths one less, row 6 at cache length 0 (its
        current row alone); the pool is random everywhere, so the slot
        at each cache length holds a stale row unlike the current one.
        Every row compared. Then both forms at the long shapes (B = 8 x
        2048-4096 keys, B = 1 x 4096)."""
        torch = self.torch
        Hq, D = mla_cfg.num_heads, mla_cfg.kv_cache_dim
        L, P = mla_cfg.num_layers, 512
        pool = self.randn(L, P, self.ps, 1, D)
        layer = L // 2
        ctx_list = [117, 205, 298, 411, 150, 260, 0, 390]
        shapes = [("B=8 ctx 117-411", "", ctx_list, self.pt8)] + \
            self.long_decode_rows(P)
        for label, tag, ctx_list, pt in shapes:
            B, MP = len(ctx_list), pt.shape[1]
            q = self.randn(B, Hq, D)
            cur = self.randn(B, 1, D)
            cache_list = [max(c - 1, 0) for c in ctx_list]
            ctx, cache = self.i32(ctx_list), self.i32(cache_list)
            S = MP * self.ps
            pos = torch.arange(S + 1, device=self.dev)[None, :]
            sfx = f"_{tag}" if tag else ""
            for name, run, plain, keys, mask, lib_kv, valid, splits in (
                    ("paged_decode_attention_mla",
                     lambda n: pa.paged_decode_attention_mla(
                         q, pool, pt, ctx, layer, scale, num_splits=n),
                     lambda: pa.paged_decode_attention_mla_plain(
                         q, pool, pt, ctx, layer, scale),
                     sum(ctx_list),
                     (pos[:, :S] < ctx.long()[:, None]) | (pos[:, :S] == 0),
                     lambda: attention.gather_pages(pool[layer], pt),
                     ctx > 0, pa.mla_splits(B, MP, self.ps, False)),
                    ("paged_decode_attention_mla_current",
                     lambda n: pa.paged_decode_attention_mla_current(
                         q, pool, pt, cache, cur, layer, scale,
                         num_splits=n),
                     lambda: pa.paged_decode_attention_mla_current_plain(
                         q, pool, pt, cache, cur, layer, scale),
                     sum(cache_list) + B,
                     (pos < cache.long()[:, None]) | (pos == S),
                     lambda: torch.cat([attention.gather_pages(pool[layer],
                                                               pt),
                                        cur[:, None]], dim=1),
                     torch.ones(B, dtype=torch.bool, device=self.dev),
                     pa.mla_splits(B, MP, self.ps, True))):
                m = mask[:, None, None, :]

                def lib(m=m, lib_kv=lib_kv):
                    # The latent as K and V of every head (an SDPA
                    # yardstick; the port never calls it). An inactive
                    # row's mask keeps key 0 so that SDPA has a key.
                    kv = lib_kv().transpose(1, 2)
                    return sdpa(q[:, :, None], kv, kv, m, scale=scale)
                nbytes = keys * D * 2 + 2 * B * Hq * D * 2 + B * (4 + 4 * MP)
                flops = 4.0 * keys * Hq * D
                self.split_record(
                    name + sfx, name,
                    f"{CSRC}/paged_decode_attention_mla.cu", run, plain, lib,
                    nbytes, flops, splits, valid,
                    sweep=bool(tag) and name.endswith("_mla"), layers=L,
                    pool_pages=P, shape=label)
        del pool

    # -- K3, K3', K4, K4', K5 at GPT-OSS-20B's sliding layers -------------
    GPTOSS_WINDOW = 128
    # The attention forms ``windowed_attention`` can hold.
    ATTN_FORMS = ("paged_decode_attention", "paged_decode_attention_current",
                  "paged_prefill_attention", "paged_prefill_attention_fresh",
                  "ragged_paged_attention")

    @staticmethod
    def _window_counts(starts, lens_list, W):
        """The keys a row needs (the positions within the window ``W`` of
        any of its queries; W = 0: all before them) and its (query, key)
        pairs, summed over the rows: what this data needs, not the
        table's width."""
        keys = pairs = 0
        for s, n in zip(starts, lens_list):
            if n <= 0:
                continue
            keys += s + n - (max(0, s - W + 1) if W else 0)
            pairs += sum(min(p + 1, W) if W else p + 1
                         for p in range(s, s + n))
        return keys, pairs

    def gptoss_attention(self, pa, pf, ra, attention):
        """The attention forms the GPT-OSS-20B path reaches, at its shapes
        (64 query heads, Hkv 8, D 64) on its sliding layers: a 128-token
        window and float32 sinks, checked with sinks and the window and
        with sinks alone (a full layer), timed with both; SDPA's time for
        the same windowed attention without sinks is
        ``sdpa_without_sinks_ms``."""
        W = self.GPTOSS_WINDOW
        sinks = self.randn(self.Hq, dtype=self.torch.float32)
        self.windowed_attention(
            pa, pf, ra, attention,
            ({"sinks": sinks, "sliding_window": W}, {"sinks": sinks}),
            "sdpa_without_sinks_ms", sliding_window=W, sinks=True)

    def windowed_attention(self, pa, pf, ra, attention, checked,
                           library_key, forms=ATTN_FORMS,
                           ctx_list=(117, 205, 298, 411, 150, 260, 0, 390),
                           prefill_starts=(0, 256, 128, 0),
                           ragged_ctx=(117, 205, 298, 411, 150, 260, 333),
                           ragged_start=128, lib_window=True, **flags):
        """The attention ``forms`` with a model's features (a window,
        sinks, a soft-cap): each checked against its plain version with
        every keyword set of ``checked``, then timed with the first. K3 /
        K3' at B = 8 rows of contexts ``ctx_list`` (a 0 is an inactive
        row; the current form there a row at cache length 0), K4 / K4' at
        4 x 256 prefill windows from ``prefill_starts``, K5 at decode rows
        of ``ragged_ctx`` beside a 256-token window at ``ragged_start``.
        ``library_ms`` is null (no one PyTorch call computes the same
        function); SDPA's time for the attention without the feature is
        under ``library_key``, its mask with the timed window when
        ``lib_window``. The bound counts the keys inside the timed
        window. ``flags`` go into each record."""
        torch = self.torch
        timed = checked[0]
        W = int(timed.get("sliding_window") or 0)
        Wl = W if lib_window else 0
        row = self.Hkv * self.D * 2
        head_row = self.Hq * self.D * 2
        S = self.MP * self.ps
        B = 8
        label = self.suffix.lstrip("_") or self.cfg.name
        extra_bytes = self.Hq * 4 if "sinks" in timed else 0
        flops_per_pair = 4.0 * self.Hq * self.D
        # -- K3 and K3' -----------------------------------------------------
        q = self.randn(B, self.Hq, self.D)
        ctx_list = list(ctx_list)
        ctx = self.i32(ctx_list)
        act = ctx > 0
        cache_list = [max(c - 1, 0) for c in ctx_list]
        cache = self.i32(cache_list)
        k_cur, v_cur = self.randn(B, self.Hkv, self.D), \
            self.randn(B, self.Hkv, self.D)
        pos = torch.arange(S + 1, device=self.dev)[None, :]
        ones = torch.ones(B, dtype=torch.bool, device=self.dev)
        lo_dec = (pos[:, :S] >= ctx.long()[:, None] - Wl) if Wl else True
        lo_cur = (pos > cache.long()[:, None] - Wl) if Wl else True
        for name, run, plain, keys, mask, lib_kv, valid, current in (
                ("paged_decode_attention",
                 lambda n, kw: pa.paged_decode_attention(
                     q, self.kp, self.vp, self.pt8, ctx, self.layer,
                     num_splits=n, **kw),
                 lambda kw: pa.paged_decode_attention_plain(
                     q, self.kp, self.vp, self.pt8, ctx, self.layer, **kw),
                 sum(min(c, W) if W else c for c in ctx_list),
                 # An inactive row keeps every key: SDPA needs one.
                 ((pos[:, :S] < ctx.long()[:, None]) & lo_dec)
                 | ~act[:, None],
                 lambda: (attention.gather_pages(self.kp[self.layer],
                                                 self.pt8),
                          attention.gather_pages(self.vp[self.layer],
                                                 self.pt8)),
                 act, False),
                ("paged_decode_attention_current",
                 lambda n, kw: pa.paged_decode_attention_current(
                     q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                     self.layer, num_splits=n, **kw),
                 lambda kw: pa.paged_decode_attention_current_plain(
                     q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                     self.layer, **kw),
                 sum(min(c + 1, W) if W else c + 1 for c in cache_list),
                 ((pos < cache.long()[:, None]) & lo_cur) | (pos == S),
                 lambda: (torch.cat([attention.gather_pages(
                     self.kp[self.layer], self.pt8), k_cur[:, None]], 1),
                     torch.cat([attention.gather_pages(
                         self.vp[self.layer], self.pt8), v_cur[:, None]],
                         1)),
                 ones, True)):
            if name not in forms:
                continue
            worst = max(self.close(f"{name} {label} ({list(kw)})",
                                   run(None, kw), plain(kw), valid)
                        for kw in checked)
            m = mask[:, None, None, :]

            def lib(m=m, lib_kv=lib_kv):
                k, v = lib_kv()
                return sdpa(q[:, :, None], k.transpose(1, 2),
                            v.transpose(1, 2), m)
            nbytes = keys * 2 * row + 2 * int(valid.sum()) * head_row \
                + extra_bytes + B * (4 + 4 * self.MP)
            self.split_record(
                name, name, f"{CSRC}/paged_decode_attention.cu",
                lambda n, run=run: run(n, timed),
                lambda plain=plain: plain(timed), None, nbytes,
                flops_per_pair * keys,
                pa.gqa_splits(B, self.Hkv, self.MP, self.ps, W, current),
                valid, worst, bytes_moved=nbytes,
                **{library_key: graph_ms(lib)}, **flags)
        # -- K4 and K4' -----------------------------------------------------
        Bp, T = 4, 256
        starts, lens_list = list(prefill_starts), [256, 144, 200, 97]
        qp = self.randn(Bp, T, self.Hq, self.D)
        k_fresh, v_fresh = self.randn(Bp, T, self.Hkv, self.D), \
            self.randn(Bp, T, self.Hkv, self.D)
        pt = self.pt8[:Bp].contiguous()
        q_start, lens = self.i32(starts), self.i32(lens_list)
        valid = (torch.arange(T, device=self.dev)[None, :]
                 < lens.long()[:, None])
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        pmask = ((kv_pos <= q_pos)
                 & ((kv_pos > q_pos - Wl) if Wl else True)
                 & (kv_pos < (q_start + lens).long()[:, None, None])
                 )[:, None]
        idx = (q_start.long()[:, None] + torch.arange(T, device=self.dev))[
            :, :, None, None].expand(-1, -1, self.Hkv, self.D)

        def gathered(fresh: bool):
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            if fresh:
                k.scatter_(1, idx, k_fresh)
                v.scatter_(1, idx, v_fresh)
            return k, v
        keys, pairs = self._window_counts(starts, lens_list, W)
        n_rows = sum(lens_list)
        for name, run, plain, fresh in (
                ("paged_prefill_attention",
                 lambda kw: pf.paged_prefill_attention(
                     qp, self.kp, self.vp, pt, q_start, lens, self.layer,
                     **kw),
                 lambda kw: pf.paged_prefill_attention_plain(
                     qp, self.kp, self.vp, pt, q_start, lens, self.layer,
                     **kw), False),
                ("paged_prefill_attention_fresh",
                 lambda kw: pf.paged_prefill_attention_fresh(
                     qp, k_fresh, v_fresh, self.kp, self.vp, pt, q_start,
                     lens, self.layer, **kw),
                 lambda kw: pf.paged_prefill_attention_fresh_plain(
                     qp, k_fresh, v_fresh, self.kp, self.vp, pt, q_start,
                     lens, self.layer, **kw), True)):
            if name not in forms:
                continue
            worst = max(self.close(f"{name} {label} ({list(kw)})", run(kw),
                                   plain(kw), valid) for kw in checked)

            def lib(fresh=fresh):
                k, v = gathered(fresh)
                return sdpa(qp.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), pmask)
            nbytes = keys * 2 * row + 2 * n_rows * head_row + extra_bytes \
                + Bp * (8 + 4 * self.MP)
            self.record(
                name, f"{CSRC}/paged_prefill_attention.cu",
                f"{PALLAS}/prefill_attention.py:272", worst,
                lambda run=run: run(timed), lambda plain=plain: plain(timed),
                None, nbytes, flops_per_pair * pairs, entry=name,
                bytes_moved=nbytes, **{library_key: graph_ms(lib)}, **flags)
        if "ragged_paged_attention" not in forms:
            return
        # -- K5 -------------------------------------------------------------
        Tr = 256
        rctx = list(ragged_ctx)
        rstarts = [c - 1 for c in rctx] + [ragged_start]
        rlens_list = [1] * len(rctx) + [256]
        qr = self.randn(B, Tr, self.Hq, self.D)
        rq_start, rlens = self.i32(rstarts), self.i32(rlens_list)
        rvalid = (torch.arange(Tr, device=self.dev)[None, :]
                  < rlens.long()[:, None])
        args = (qr, self.kp, self.vp, self.pt8, rq_start, rlens, self.layer)
        worst = max(self.close(
            f"ragged_paged_attention {label} ({list(kw)})",
            ra.ragged_paged_attention(*args, **kw),
            ra.ragged_paged_attention_plain(*args, **kw), rvalid)
            for kw in checked)
        rq_pos = rq_start.long()[:, None, None] + torch.arange(
            Tr, device=self.dev)[None, :, None]
        rmask = ((kv_pos <= rq_pos)
                 & ((kv_pos > rq_pos - Wl) if Wl else True)
                 & (kv_pos < (rq_start + rlens).long()[:, None, None])
                 )[:, None]

        def rlib():
            k = attention.gather_pages(self.kp[self.layer], self.pt8)
            v = attention.gather_pages(self.vp[self.layer], self.pt8)
            return sdpa(qr.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), rmask)
        keys, pairs = self._window_counts(rstarts, rlens_list, W)
        # The whole [B, T, Hq, D] output is written (padding as zeros).
        nbytes = keys * 2 * row + sum(rlens_list) * head_row \
            + B * Tr * head_row + extra_bytes + B * (8 + 4 * self.MP)
        self.record(
            "ragged_paged_attention", f"{CSRC}/ragged_paged_attention.cu",
            f"{PALLAS}/ragged_attention.py:191", worst,
            lambda: ra.ragged_paged_attention(*args, **timed),
            lambda: ra.ragged_paged_attention_plain(*args, **timed), None,
            nbytes, flops_per_pair * pairs,
            entry="ragged_paged_attention", bytes_moved=nbytes,
            **{library_key: graph_ms(rlib)}, **flags)


# ---------------------------------------------------------------------------
# Phase 4: full-width forward, kernels (GPU bf16) vs plain (CPU float32)
# ---------------------------------------------------------------------------

def forward_check(torch, cfg, device) -> float:
    from xllm_service_tpu_torch.models import transformer as tf
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = tf.init_params(cfg, gen, dev)
    cpu_params = {k: (v.float().cpu() if k != "layers" else
                      {n: t.float().cpu() for n, t in v.items()})
                  for k, v in params.items()}
    P, ps, B, T = 8, 128, 2, 128
    pt = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
    rng = random.Random(7)
    tokens = torch.tensor([[rng.randrange(3, 259) for _ in range(T)]
                           for _ in range(B)])
    start = torch.zeros(B, dtype=torch.int32)
    lens = torch.tensor([128, 77], dtype=torch.int32)
    # Then a ragged batch: row 0 decodes at position 129 (mid-page), row 1
    # continues with a 40-token window from position 78.
    rg_tokens = torch.zeros(B, 64, dtype=torch.long)
    rg_tokens[1, :40] = torch.tensor([rng.randrange(3, 259)
                                      for _ in range(40)])
    rg_start = torch.tensor([129, 78], dtype=torch.int32)
    rg_lens = torch.tensor([1, 40], dtype=torch.int32)
    # The attend-then-write order's second windows: 40 and 30 tokens at
    # q_start = the first windows' lengths.
    aw_tokens = torch.tensor([[rng.randrange(3, 259) for _ in range(64)]
                              for _ in range(B)])
    aw_lens = torch.tensor([40, 30], dtype=torch.int32)
    results = []
    for device, p, dtype in ((dev, params, tf.torch_dtype(cfg)),
                             (torch.device("cpu"), cpu_params,
                              torch.float32)):
        kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
        pre, kv = tf.forward_prefill(p, cfg, tokens.to(device),
                                     start.to(device), lens.to(device), kv,
                                     pt.to(device))
        nxt = pre.argmax(-1) if not results else results[0][0].argmax(-1)
        dec, kv = tf.forward_decode(
            p, cfg, nxt.to(device), lens.to(device),
            torch.ones(B, dtype=torch.bool, device=device), kv,
            pt.to(device))
        rg_tokens[0, 0] = (dec if not results else results[0][1]).argmax(
            -1)[0].item()
        rag, kv = tf.forward_prefill(p, cfg, rg_tokens.to(device),
                                     rg_start.to(device), rg_lens.to(device),
                                     kv, pt.to(device), ragged=True)
        # Attend-then-write, on a fresh pool: a first window, a second
        # at q_start 128 / 77 (unaligned), then a decode step.
        kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
        first, kv = tf.forward_prefill(p, cfg, tokens.to(device),
                                       start.to(device), lens.to(device), kv,
                                       pt.to(device), write_then_attend=False)
        second, kv = tf.forward_prefill(p, cfg, aw_tokens.to(device),
                                        lens.to(device), aw_lens.to(device),
                                        kv, pt.to(device),
                                        write_then_attend=False)
        nxt = second.argmax(-1) if not results else results[0][4].argmax(-1)
        aw_dec, kv = tf.forward_decode(
            p, cfg, nxt.to(device), (lens + aw_lens).to(device),
            torch.ones(B, dtype=torch.bool, device=device), kv,
            pt.to(device), write_then_attend=False)
        results.append(tuple(x.float().cpu() for x in (
            pre, dec, rag, first, second, aw_dec)))
    graph = graph_decode_check(torch, params, cfg, "llama3-1b")
    graph["prefill"] = graph_prefill_check(
        torch, params, cfg, "llama3-1b",
        (("prefill", True), ("prefill", False), ("ragged", True)))
    graph["pipeline"] = pipeline_check(torch, params, cfg, "llama3-1b")
    worst, err = logit_errors(torch, results)
    log(f"[forward] llama3-1b rel L2 (GPU kernels bf16 vs CPU plain fp32): "
        f"write-then-attend prefill/decode/ragged {worst[:3]}, "
        f"attend-then-write prefill/prefill/decode {worst[3:]}; largest "
        f"logit error {err}")
    if max(worst) > FORWARD_REL_L2:
        raise AssertionError(f"forward logits rel L2 {max(worst)} > "
                             f"{FORWARD_REL_L2}")
    return max(worst), err, graph


def graph_decode_check(torch, params, cfg, name: str) -> dict:
    """A decode forward captured in a CUDA graph and replayed, against
    the same forward run eagerly on the same inputs, in both orders of
    the KV write (B = 8 rows of 1-411 keys, one inactive, on a pool of
    random stale values): the logits' max abs difference (the same
    kernels in the same order: 0 expected), and the hand-written
    kernels the graph captured, which each replay launches."""
    from xllm_service_tpu_torch.models import transformer as tf
    from xllm_service_tpu_torch.ops.kernels import _launch
    dev = torch.device("cuda")
    B, MP, ps = 8, 4, 128
    g = torch.Generator(device=dev).manual_seed(13)
    kv = tf.init_kv_cache(cfg, 1 + B * MP, ps, dev)
    for pool in kv:
        pool.normal_(generator=g)
    table = torch.arange(1, 1 + B * MP, dtype=torch.int32,
                         device=dev).reshape(B, MP)
    positions = torch.tensor([117, 240, 411, 5, 300, 0, 128, 77],
                             dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[3] = False
    tokens = torch.randint(3, 259, (B,), generator=g, device=dev)
    out = {}
    for wta in (True, False):
        order = "write_then_attend" if wta else "attend_then_write"
        eager, _ = tf.forward_decode(params, cfg, tokens, positions, active,
                                     kv, table, write_then_attend=wta)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tf.forward_decode(params, cfg, tokens, positions, active, kv,
                              table, write_then_attend=wta)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _launch.capture_tally() as tally:
            with torch.cuda.graph(graph):
                static, _ = tf.forward_decode(params, cfg, tokens, positions,
                                              active, kv, table,
                                              write_then_attend=wta)
        graph.replay()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(static[active]).all()):
            raise AssertionError(f"{name} graph logits not finite")
        diff = float((static.float() - eager.float()).abs().max())
        rel = float((static.float() - eager.float()).norm()
                    / eager.float().norm())
        if rel > FORWARD_REL_L2:
            raise AssertionError(f"{name} {order}: graph vs eager rel L2 "
                                 f"{rel}")
        out[order] = {"max_abs_diff": diff, "rel_l2": rel,
                      "kernels_per_replay": {w.__name__: n
                                             for w, n in tally.items()}}
        del graph, static
    log(f"[graph] {name}: a captured decode forward replayed vs the same "
        f"forward eager: {json.dumps(out)}")
    return out


def graph_prefill_check(torch, params, cfg, name: str, kinds) -> dict:
    """The prefill runner's graphs on the card: one step captured and
    replayed against the same step run eagerly through the runner's body,
    each on its own copy of a pool of random stale values: B = 4 rows in
    a T = 256 bucket, tables 4 pages wide, windows of 200, 77 and 130
    tokens at starts 0, 256 (a cached start) and 128 beside a padding
    row (length 0, NULL table); a ragged step has two decode rows (contexts
    301 and 411) before its two windows. For each (kind, order): the
    capture's warm-up body (every length 0, every table NULL) left every
    pool byte as it was; the replay wrote the live rows' window slots and
    no other byte; tokens equal, logprobs and the written slots within
    ATTN_TOL of the eager body's (the same kernels in the same order: 0
    expected); and the kernels a replay launches."""
    from xllm_service_tpu_torch.models import transformer as tf
    from xllm_service_tpu_torch.ops.sampling import SamplingTensors
    from xllm_service_tpu_torch.runtime import prefill_graph
    from xllm_service_tpu_torch.utils.types import SamplingParams
    dev = torch.device("cuda")
    B, T, MP, ps = 4, 256, 4, 128
    g = torch.Generator(device=dev).manual_seed(17)
    base = tf.init_kv_cache(cfg, 1 + B * MP, ps, dev)
    for pool in base:
        pool.normal_(generator=g)
    table = [list(range(1 + i * MP, 1 + (i + 1) * MP)) for i in range(B)]
    rng = random.Random(17)
    spans = {"prefill": [(0, 200), (256, 77), (128, 130)],
             "ragged": [(300, 1), (410, 1), (0, 200), (128, 130)]}
    greedy = SamplingTensors.pack_batch([SamplingParams(temperature=0.0)]
                                        * B)
    out = {}
    for kind, wta in kinds:
        rows = [([rng.randrange(3, 259) for _ in range(n)], st, table[i])
                for i, (st, n) in enumerate(spans[kind])]
        flat = prefill_graph.pack((B, T, MP), rows, greedy)
        key = prefill_graph.Key(kind, B, T, MP, True)
        got = {}
        for use_graphs in (True, False):
            kv = tuple(p.clone() for p in base)
            runner = prefill_graph.PrefillGraphs(
                params, cfg, kv, B, wta, torch.Generator(device=dev), dev,
                use_graphs, torch.cuda.graph_pool_handle()
                if use_graphs else None)
            runner.stage((B, T, MP), flat)
            runner.prepare(key)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(kv, base)):
                raise AssertionError(f"{name} {kind}: the capture's warm-up "
                                     f"body (length 0, NULL tables) wrote "
                                     f"into the pools")
            res = runner.launch(key)
            got[use_graphs] = (res.tokens, res.logprobs, kv, runner)
        (tg, lg, kg, rg), (te, le, ke, _) = got[True], got[False]
        touched = torch.zeros((1 + B * MP, ps), dtype=torch.bool,
                              device=dev)
        for i, (st, n) in enumerate(spans[kind]):
            for pos in range(st, st + n):
                touched[table[i][pos // ps], pos % ps] = True
        slot_err = 0.0
        for new, old, eager in zip(kg, base, ke):
            moved = (new != old).flatten(3).any(-1).any(0)
            if bool(moved[~touched].any()):
                raise AssertionError(f"{name} {kind}: the replay wrote "
                                     f"outside the live rows' windows")
            slot_err = max(slot_err, float(
                (new.float() - eager.float()).abs().max()))
        lp_err = max(abs(a - b) for a, b in zip(lg[:len(rows)],
                                                 le[:len(rows)]))
        order = "write_then_attend" if wta else "attend_then_write"
        rec = {"tokens_equal": tg == te, "logprob_max_abs_diff": lp_err,
               "pool_max_abs_diff": slot_err,
               "kernels_per_replay": {
                   w.__name__: n for w, n in rg.graphs[key].tally.items()}}
        if tg[:len(rows)] != te[:len(rows)] or lp_err > ATTN_TOL or \
                slot_err > ATTN_TOL:
            raise AssertionError(f"{name} {kind} {order}: graph vs eager "
                                 f"{rec}")
        out[f"{kind}_{order}"] = rec
        del got, rg
    log(f"[graph] {name}: a captured prefill step replayed vs the same "
        f"step eager: {json.dumps(out)}")
    return out


def pipeline_check(torch, params, cfg, name: str) -> dict:
    """The speculative pipeline on the card: two engines on the same
    weights, 4-step bursts through graphs with the pipeline on and off,
    serve two sampled streams (temperature 1, top-p 0.9) and, admitted
    mid-run, a greedy one, whose admission (prefill-first routing)
    rolls an in-flight burst back.
    The streams must be identical (the generator's state is restored on
    a rollback), with at least one speculation hit and one rollback."""
    from xllm_service_tpu_torch.config import EngineConfig
    from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
    from xllm_service_tpu_torch.utils.types import SamplingParams
    rng = random.Random(19)
    prompts = [[rng.randrange(3, 259) for _ in range(n)] for n in (90, 60, 40)]
    runs = []
    for pipeline in (True, False):
        eng = Engine(cfg, EngineConfig(
            page_size=128, num_pages=64, max_model_len=1024,
            max_batch_size=8, max_prefill_tokens=256,
            prefill_buckets=(128, 256), decode_steps=4,
            decode_pipeline=pipeline, cuda_graphs=True,
            interleave=False),
            params=params, device="cuda", seed=3)
        eng.warmup()
        for i in range(2):
            eng.add_request(EngineRequest(f"s{i}", prompts[i], SamplingParams(
                max_tokens=24, temperature=1.0, top_p=0.9,
                ignore_eos=True)))
        streams, step = {}, 0
        while eng.has_work():
            step += 1
            if step == 4:
                eng.add_request(EngineRequest("g", prompts[2], SamplingParams(
                    max_tokens=10, temperature=0.0, ignore_eos=True)))
            for o in eng.step():
                streams.setdefault(o.request_id, []).extend(o.new_token_ids)
        runs.append((streams, eng.overlap_metrics(), eng.capture_report()))
        del eng
    (on, om, cap), (off, _, _) = runs
    out = {"equal": on == off, "overlap": om,
           "replays": cap["replays"], "eager_steps": cap["eager_steps"]}
    log(f"[pipeline] {name}: sampled streams, pipeline on vs off: "
        f"{json.dumps(out)}")
    if on != off or om["spec_rollbacks"] < 1 or om["spec_hits"] < 1 or \
            cap["eager_steps"] or cap["captures_after_warmup"]:
        raise AssertionError(f"{name} pipeline check: {out}, {cap}")
    return out


def logit_errors(torch, results):
    """Per forward, the relative L2 error of the kernel path's logits
    (results[0]) against the plain path's (results[1]); and the largest
    absolute logit error of all of them."""
    rels, err = [], 0.0
    for got, want in zip(results[0], results[1]):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("kernel-path logits not finite")
        rels.append(float((got - want).norm() / want.norm()))
        err = max(err, float((got - want).abs().max()))
    return rels, err


def cpu_float(params):
    """A float32 CPU copy of a parameter dict (stacks of layers too)."""
    return {k: ({n: t.cpu().float() for n, t in v.items()}
                if isinstance(v, dict) else v.cpu().float())
            for k, v in params.items()}


def mla_forward_check(torch, kernels, cfg, device) -> float:
    """DeepSeek-V2-Lite at full width (hidden 2048, 16 heads, the
    576-wide latent, 64 routed + 2 shared experts, random bf16 weights
    from a seed), its depth cut to 4 layers (the dense layer and 3 MoE
    layers) because the float32 CPU copy that the plain path runs on
    would take 63 GB at all 27. Write-then-attend: a prefill (rows of 128
    and 77 tokens), then a decode step; attend-then-write: the same
    prefill, a second window at q_start 128 / 77 (unaligned), then a
    decode step. Each against the plain path (float32 on the CPU, same
    weights): relative L2 of the logits <= 5e-2. Each decode forward on
    the GPU must launch K3'' once per layer: the latent form of K1 (the
    latent row built and written) + K3'' (write-then-attend), the latent
    form without pools + K3'' current form + one K6 (attend-then-write)."""
    from xllm_service_tpu_torch.models import transformer as tf
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(11)
    params = tf.init_params(cfg, gen, dev)
    cpu_params = cpu_float(params)
    L, P, ps, B, T = cfg.num_layers, 8, 128, 2, 128
    pt = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
    rng = random.Random(11)
    tokens = torch.tensor([[rng.randrange(3, 259) for _ in range(T)]
                           for _ in range(B)])
    start = torch.zeros(B, dtype=torch.int32)
    lens = torch.tensor([128, 77], dtype=torch.int32)
    aw_tokens = torch.tensor([[rng.randrange(3, 259) for _ in range(64)]
                              for _ in range(B)])
    aw_lens = torch.tensor([40, 30], dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.bool)
    results = []

    def decode(p, device, nxt, pos, kv, wta):
        kernels.reset_launch_counts()
        out, kv = tf.forward_decode(p, cfg, nxt.to(device), pos.to(device),
                                    ones.to(device), kv, pt.to(device),
                                    write_then_attend=wta)
        n = kernels.launch_counts()
        want = {k: 0 for k in n}
        if wta:
            want.update(latent_kv_update_layer=L,
                        paged_decode_attention_mla=L)
        else:
            want.update(latent_kv_update_layer=L - 1,
                        latent_kv_update_all_layers=1,
                        paged_decode_attention_mla_current=L)
        if device.type == "cuda" and n != want:
            raise AssertionError(f"MLA decode forward launches {n}, want "
                                 f"{want}")
        return out, kv

    for device, p, dtype in ((dev, params, tf.torch_dtype(cfg)),
                             (torch.device("cpu"), cpu_params,
                              torch.float32)):
        kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
        pre, kv = tf.forward_prefill(p, cfg, tokens.to(device),
                                     start.to(device), lens.to(device), kv,
                                     pt.to(device))
        nxt = pre.argmax(-1) if not results else results[0][0].argmax(-1)
        dec, kv = decode(p, device, nxt, lens, kv, True)
        kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
        first, kv = tf.forward_prefill(p, cfg, tokens.to(device),
                                       start.to(device), lens.to(device), kv,
                                       pt.to(device), write_then_attend=False)
        second, kv = tf.forward_prefill(p, cfg, aw_tokens.to(device),
                                        lens.to(device), aw_lens.to(device),
                                        kv, pt.to(device),
                                        write_then_attend=False)
        nxt = second.argmax(-1) if not results else results[0][3].argmax(-1)
        aw_dec, kv = decode(p, device, nxt, lens + aw_lens, kv, False)
        results.append(tuple(x.float().cpu() for x in (
            pre, dec, first, second, aw_dec)))
        del kv
    graph = graph_decode_check(torch, params, cfg,
                               f"deepseek-v2-lite ({L} layers)")
    graph["prefill"] = graph_prefill_check(
        torch, params, cfg, f"deepseek-v2-lite ({L} layers)",
        (("prefill", True), ("prefill", False)))
    del params, cpu_params
    rels, err = logit_errors(torch, results)
    log(f"[forward] deepseek-v2-lite ({L} layers) rel L2 (GPU kernels bf16 "
        f"vs CPU plain fp32): write-then-attend prefill/decode {rels[:2]}, "
        f"attend-then-write prefill/prefill/decode {rels[2:]}; largest "
        f"logit error {err}")
    if max(rels) > FORWARD_REL_L2:
        raise AssertionError(f"MLA forward logits rel L2 {max(rels)} > "
                             f"{FORWARD_REL_L2}")
    return max(rels), err, graph


def free_device_memory(torch) -> None:
    """Collect what a finished phase left (the worker and its engine sit
    in reference cycles) and return the cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: serving through the worker
# ---------------------------------------------------------------------------

def _prompt(rng: random.Random, n: int) -> str:
    words = ["page", "table", "kernel", "token", "decode", "prefill",
             "cache", "head", "warp", "block", "query", "value"]
    out = ""
    while len(out) < n:
        out += rng.choice(words) + " "
    return out[:n]


def _request(addr, path, body, stream, result, headers=None):
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    r = conn.getresponse()
    result["status"] = r.status
    if not stream:
        result["body"] = json.loads(r.read())
        result["latency_s"] = time.perf_counter() - t0
        conn.close()
        return
    frames, times, buf = [], [], b""
    while True:
        chunk = r.read1(65536) if hasattr(r, "read1") else r.read(1)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            frames.append(frame.decode())
            times.append(time.perf_counter() - t0)
    conn.close()
    result["frames"] = frames
    result["times"] = times
    result["latency_s"] = time.perf_counter() - t0


def profile_request(torch, addr: str, body: dict) -> dict:
    """One streamed request under torch.profiler: device time by kernel
    and the device's busy share of the request's wall time (the profiler
    adds host time, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    res: dict = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _request(addr, "/v1/chat/completions", body, True, res)
        torch.cuda.synchronize()
    if res.get("status") != 200:
        raise AssertionError(f"profiled request failed: {res}")
    rows, host_launches = [], 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            # What the host issued: kernel launches and graph launches.
            if e.key in HOST_LAUNCH_CALLS:
                host_launches += e.count
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    wall_ms = res["latency_s"] * 1e3
    busy_ms = sum(r[0] for r in rows)
    # The decode attention kernels' own device time (K3/K3' and K3''),
    # the layer body's fused writers', and PyTorch's elementwise kernels
    # and copies (cat, casts, index copies).
    k3 = {kind: sum(ms for ms, _, k in rows if f"{kernel}<" in k)
          for kind, kernel in (
              ("gqa", "paged_decode_attention_kernel"),
              ("mla", "paged_decode_attention_mla_kernel"))}
    writers = {name: sum(ms for ms, _, k in rows if k.startswith(name + "("))
               for name in ("rope_kv_write_kernel", "latent_kv_write_kernel",
                            "kv_write_kernel")}
    def is_copy(k):
        return "CatArrayBatchedCopy" in k or "copy_kernel" in k
    elementwise = sum(ms for ms, _, k in rows
                      if "elementwise_kernel" in k and not is_copy(k))
    copies = sum(ms for ms, _, k in rows if is_copy(k))
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms if rows else None,
           "idle_share": 1.0 - busy_ms / wall_ms if rows else None,
           "decode_attention_device_ms": k3,
           "writer_device_ms": writers,
           "elementwise_device_ms": elementwise,
           "cat_copy_device_ms": copies,
           "kernel_launches": sum(r[1] for r in rows),
           "host_launches": host_launches,
           "top": [{"ms": ms, "count": n, "name": k[:90]}
                   for ms, n, k in rows[:14]],
           # The profiled request and the reading of its events.
           "profile_s": time.perf_counter() - t0}
    log(f"[profile] {json.dumps(out)}")
    return out


def runner_host_launches(torch, engine) -> dict:
    """Host launch calls (``HOST_LAUNCH_CALLS``) of one prefill forward
    and, on a dense model, one ragged forward through the live engine's
    runner, under torch.profiler on this thread: ``launch`` as the engine
    runs it in its mode (a replay with graphs on, the body eagerly with
    them off), and ``eager_body`` the same forward's body called alone.
    The smallest greedy key of each kind (one the engine's mode lacks is
    made first: after the phase's census was read), on padding inputs
    (every row length 0: the pools are not written)."""
    from torch.profiler import ProfilerActivity, profile
    from xllm_service_tpu_torch.ops.sampling import SamplingTensors
    from xllm_service_tpu_torch.runtime import prefill_graph
    from xllm_service_tpu_torch.utils.types import SamplingParams
    runner = engine.prefill_graphs
    out = {}
    for kind in ("prefill",) + (() if engine.cfg.mla else ("ragged",)):
        keys = sorted(k for k in runner.graphs if k[0] == "prefill" and k[4])
        key = runner.prepare((kind,) + keys[0][1:])
        B = key[1]
        runner.stage(key[1:4], prefill_graph.pack(
            key[1:4], [], SamplingTensors.pack_batch(
                [SamplingParams(temperature=0.0)] * B)))
        counts = {"key": list(key)}
        for mode, fn in (("launch", lambda: runner.launch(key)),
                         ("eager_body", lambda: runner._body(key))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            counts[mode] = sum(e.count for e in prof.key_averages()
                               if e.key in HOST_LAUNCH_CALLS)
        out[kind] = counts
    return out


# Runtime calls by which the host issues device work: a kernel, or a
# whole CUDA graph.
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")


class StepLog:
    """Wraps a live engine's ``step``: per iteration its kind, forwards,
    wall time (host clock; a step ends in the host read of its sampled
    tokens, so it includes the device's work) and hand-written kernel
    launches, and the tokens of each request and the prompt tokens the
    prefix cache served it (``cached``), keyed by prompt length."""

    def __init__(self, engine, kernels) -> None:
        self.rows, self.tokens, self.prompts = [], {}, {}
        self.cached = {}
        inner, add = engine.step, engine.add_request

        def add_request(req):
            self.prompts[len(req.token_ids)] = list(req.token_ids)
            return add(req)
        engine.add_request = add_request

        def step():
            before = kernels.launch_counts()
            runs0 = (engine.graphs.launches, engine.graphs.forwards)
            late0 = (len(engine.graphs.late), len(engine.prefill_graphs.late))
            t0 = time.perf_counter()
            outs = inner()
            ms = (time.perf_counter() - t0) * 1e3
            after = kernels.launch_counts()
            captured = engine.graphs.use_graphs
            self.rows.append({
                "kind": engine.last_step_kind,
                "ragged": engine.last_step_ragged,
                "forwards": engine.last_step_attn_dispatches, "ms": ms,
                # Decode dispatches (graph replays or eager steps) and
                # the forwards they ran (N a burst).
                "decode_dispatches": engine.graphs.launches - runs0[0],
                "decode_forwards": engine.graphs.forwards - runs0[1],
                # Graphs captured in the step (each runs its body once
                # eagerly first).
                "decode_captures": (len(engine.graphs.late) - late0[0])
                if captured else 0,
                "prefill_captures":
                    (len(engine.prefill_graphs.late) - late0[1])
                    if captured else 0,
                "launches": {k: after[k] - before[k] for k in after}})
            for o in outs:
                self.tokens.setdefault(o.num_prompt_tokens, []).extend(
                    o.new_token_ids)
                if o.num_cached_tokens:
                    self.cached[o.num_prompt_tokens] = o.num_cached_tokens
            return outs
        engine.step = step

    def clear(self) -> None:
        self.rows, self.tokens, self.cached = [], {}, {}


# The kernels of each order, by launches per forward. The layer body's
# writers run fused with the rope of q and k (dense) or with the latent
# row (MLA) in both orders; the unfused one-layer writers K1/K2 never run
# on a served path.
ONE_LAYER_KERNELS = ("rope_kv_update_layer", "rope_prefill_kv_update_layer",
                     "paged_decode_attention", "paged_prefill_attention",
                     "ragged_paged_attention")
ATTEND_THEN_WRITE_KERNELS = ("paged_kv_update", "paged_prefill_kv_update",
                             "paged_decode_attention_current",
                             "paged_prefill_attention_fresh",
                             "rope_kv_update_all_layers")
MLA_KERNELS = ("latent_kv_update_layer", "latent_prefill_kv_update_layer",
               "paged_decode_attention_mla",
               "paged_decode_attention_mla_current")
# The unfused writers: K1/K2, and K6, which the last layer's fused writer
# does in an attend-then-write decode step.
UNFUSED_WRITERS = ("paged_kv_update_layer", "paged_prefill_kv_update_layer",
                   "paged_kv_update")


def step_launches_wanted(row, layers: int, mla: bool,
                         write_then_attend: bool) -> dict:
    """The hand-written launches one step must make: one ragged forward
    (the fused prefill writer and the ragged kernel once per layer), or
    decode forwards (one a single step, N a fused burst, 2N with a
    speculative burst) and/or a prefill forward (a split mixed step runs
    both), each with its fused writer once per layer, in either order;
    an attend-then-write decode forward's last layer takes the writer's
    all-layer mode (K6 folded in), a prefill forward adds K7. A kernel
    in a CUDA graph counts once per replay (``_launch.count_replay``).
    A graph captured in the step (a key after warmup) first runs its
    body once eagerly: one more decode or prefill (ragged) forward."""
    dec = row["decode_forwards"] + row.get("decode_captures", 0)
    pre = int(row["kind"] in ("prefill", "mixed")) + \
        row.get("prefill_captures", 0)
    want = {k: 0 for k in row["launches"]}
    if row["ragged"]:
        n = layers * (1 + row.get("prefill_captures", 0))
        want.update(rope_prefill_kv_update_layer=n,
                    ragged_paged_attention=n)
    elif mla:
        want.update(latent_kv_update_layer=layers * dec,
                    latent_prefill_kv_update_layer=layers * pre)
        if write_then_attend:
            want.update(paged_decode_attention_mla=layers * dec)
        else:
            want.update(latent_kv_update_layer=(layers - 1) * dec,
                        latent_kv_update_all_layers=dec,
                        paged_decode_attention_mla_current=layers * dec,
                        paged_prefill_kv_update=pre)
    else:
        want.update(rope_kv_update_layer=layers * dec,
                    rope_prefill_kv_update_layer=layers * pre)
        if write_then_attend:
            want.update(paged_decode_attention=layers * dec,
                        paged_prefill_attention=layers * pre)
        else:
            want.update(rope_kv_update_layer=(layers - 1) * dec,
                        rope_kv_update_all_layers=dec,
                        paged_decode_attention_current=layers * dec,
                        paged_prefill_attention_fresh=layers * pre,
                        paged_prefill_kv_update=pre)
    return want


# The served requests of phases 5-6: 2 streamed chats and 2 non-streamed
# completions, prompts of 100-400 tokens, 32 new tokens at temperature 0.
SERVE_PLAN = (
    ("/v1/chat/completions", True, 380),
    ("/v1/completions", False, 250),
    ("/v1/chat/completions", True, 120),
    ("/v1/completions", False, 330),
)


def serve_bodies(rng: random.Random, tokenizer=None,
                 plan=SERVE_PLAN) -> list:
    """The bodies of ``plan``. With ``tokenizer`` each also carries its
    prompt's token ids, so a master in front (which renders chats
    through its own template) serves the prompt a direct request does."""
    bodies = []
    for path, stream, n in plan:
        body = {"max_tokens": 32, "temperature": 0.0, "ignore_eos": True,
                "stream": stream}
        text = _prompt(rng, n)
        if path.endswith("chat/completions"):
            body["messages"] = [{"role": "user", "content": text}]
        else:
            body["prompt"] = text
        if tokenizer is not None:
            body["token_ids"] = tokenizer.encode(text)
        if stream:
            # With logprobs every token gets its own frame, even one
            # whose text is empty (random weights mostly sample ids
            # past the byte tokenizer's range), so frames time tokens.
            body["stream_options"] = {"include_usage": True}
            body["logprobs"] = True
        bodies.append(body)
    return bodies


def stream_tokens(frames):
    """A chat stream's frames as (text, chosen-token logprobs, frame
    times' indices, usage); raises unless it ends in [DONE]."""
    if not frames or frames[-1] != "data: [DONE]":
        raise AssertionError(f"stream did not end in [DONE]: {frames[-2:]}")
    objs = [json.loads(f[len("data: "):]) for f in frames[:-1]]
    text, lps, idx = "", [], []
    for i, o in enumerate(objs):
        if not o["choices"]:
            continue
        c = o["choices"][0]
        text += c["delta"].get("content") or ""
        for e in (c.get("logprobs") or {}).get("content") or []:
            lps.append(e["logprob"])
            idx.append(i)
    return text, lps, idx, objs[-1].get("usage")


def check_replies(plan, results):
    """Every reply 200 with 32 completion tokens (a stream ends in [DONE]
    and carries one token frame per token); returns the streams' TTFT
    (ms) and decode tokens/s, and the completion tokens in all."""
    ttfts, decode_rates, total_tokens = [], [], 0
    for (path, stream, n), r in zip(plan, results):
        if r.get("status") != 200:
            raise AssertionError(f"{path} returned {r.get('status')}: {r}")
        if stream:
            _, _, idx, usage = stream_tokens(r["frames"])
            # A frame carries one token, or a fused burst's tokens.
            tok_t = [r["times"][i] for i in idx]
            if not usage or usage["completion_tokens"] != 32 \
                    or len(tok_t) != 32:
                raise AssertionError(f"stream usage {usage}, "
                                     f"{len(tok_t)} token frames")
            ttfts.append(tok_t[0] * 1e3)
            decode_rates.append(31 / (tok_t[-1] - tok_t[0]))
            total_tokens += usage["completion_tokens"]
        else:
            usage = r["body"]["usage"]
            if usage["completion_tokens"] != 32 or \
                    r["body"]["choices"][0]["finish_reason"] != "length":
                raise AssertionError(f"completion body {r['body']}")
            total_tokens += usage["completion_tokens"]
    return ttfts, decode_rates, total_tokens


def run_concurrent(addr, bodies, headers=None, plan=SERVE_PLAN):
    """``plan``'s requests with ``bodies``, all at once, to ``addr``;
    returns (results, wall seconds)."""
    results = [{} for _ in plan]
    threads = [threading.Thread(target=_request,
                                args=(addr, p, b, s, r, headers))
               for (p, s, _), b, r in zip(plan, bodies, results)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results, time.perf_counter() - t0


def check_step_launches(rows, counts, layers: int, mla: bool,
                        write_then_attend: bool, ragged: bool) -> list:
    """Every step exactly (``step_launches_wanted``), and every kernel a
    step wanted launched in the run (``counts``, zeroed just before it);
    the unfused writers never. Returns the kernels the run needed."""
    need = set()
    for row in rows:
        if ragged and row["kind"] == "mixed" and not row["ragged"]:
            raise AssertionError(f"a mixed iteration ran split: {row}")
        want = step_launches_wanted(row, layers, mla, write_then_attend)
        pre = int(row["kind"] in ("prefill", "mixed"))
        forwards = 1 if row["ragged"] else row["decode_dispatches"] + pre
        if row["launches"] != want or row["forwards"] != forwards:
            raise AssertionError(f"step launches: {row}, want {want}")
        need |= {k for k, n in want.items() if n}
    if any(counts[k] for k in UNFUSED_WRITERS):
        raise AssertionError(f"an unfused writer ran: {counts}")
    need = sorted(need)
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing} ({counts})")
    return need


# Phases 5-5g's worker flags (phase 5's flags).
SERVE_ARGS = ["--page-size", "128", "--num-pages", "512",
              "--max-model-len", "1024", "--max-batch-size", "8",
              "--prefill-buckets", "128,256,512",
              "--max-prefill-tokens", "256"]


def serve(torch, kernels, model: str, device: str, ragged: bool,
          write_then_attend: bool = True, tag: str = "",
          on_engine=None, graphs: bool = True, decode_steps: int = 1,
          params=None, keep_params: bool = False, model_cfg=None,
          engine_args=None, profile: bool = True,
          plan=SERVE_PLAN) -> dict:
    """Phase 5 (ragged off), 5b (ragged on), 5c (attend-then-write), 5d
    and 5e (DeepSeek-V2-Lite in either order), and each mode of 5f/5g:
    4 concurrent requests through the worker (which captures its decode
    graphs before serving, unless ``graphs`` is off); checks the replies
    and which kernels ran. ``decode_steps``: the worker's
    --decode-steps. ``params``: weights to serve (default: random from
    the engine's seed); ``keep_params`` returns them as
    ``out["params"]``. ``model_cfg``: the model to serve instead of
    ``model``'s catalog entry. ``engine_args``: the worker's pool and
    batch flags (default ``SERVE_ARGS``). ``profile``: profile one
    request (the split paths). ``plan``: the requests (default
    ``SERVE_PLAN``). ``on_engine(engine, tokens)``, if given,
    runs on the live engine once the requests are served (``tokens``:
    each request's, by prompt length); its result is
    ``out["on_engine"]``."""
    from xllm_service_tpu_torch.runtime import worker
    t_serve = time.perf_counter()
    args = worker.parse_args([
        "--model", model, "--device", device,
        *(engine_args or SERVE_ARGS), "--decode-steps", str(decode_steps)])
    # The engine reads the switches once, when its config is built.
    env = {"XLLM_RAGGED_ATTN": "1" if ragged else "0",
           "XLLM_WRITE_THEN_ATTEND": "1" if write_then_attend else "0",
           "XLLM_CUDA_GRAPHS": "1" if graphs else "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t_build = time.perf_counter()
        w = worker.build_worker(args, params=params,
                                model_cfg=model_cfg).start()
        build_s = time.perf_counter() - t_build
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    layers = w.engine.cfg.num_layers
    mla = w.engine.cfg.mla
    torch.cuda.reset_peak_memory_stats()
    steplog = StepLog(w.engine, kernels)
    try:
        rng = random.Random(0)
        warm = {}
        _request(w.name, "/v1/completions",
                 {"prompt": _prompt(rng, 64), "max_tokens": 4,
                  "temperature": 0.0}, False, warm)
        if warm["status"] != 200:
            raise AssertionError(f"warm-up request failed: {warm}")
        bodies = serve_bodies(rng, plan=plan)
        steps0 = w.engine.step_count
        ragged0 = w.engine.ragged_steps
        kernels.reset_launch_counts()
        steplog.clear()
        results, wall = run_concurrent(w.name, bodies, plan=plan)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        steps = w.engine.step_count - steps0
        ragged_steps = w.engine.ragged_steps - ragged0
        rows = list(steplog.rows)
        tokens = {n: list(t) for n, t in steplog.tokens.items()}
        capture = w.engine.capture_report()
        overlap = w.engine.overlap_metrics()
        moe_dropped = w.engine.moe_dropped_tokens
        runner_launches = runner_host_launches(torch, w.engine)
        prof = None
        if profile and not ragged:
            n0 = len(steplog.rows)
            # A prompt of the same length that no served request shares a
            # page with: the profiled request prefills from token 0.
            fresh = dict(bodies[0], messages=[{
                "role": "user", "content": _prompt(random.Random(5),
                                                   plan[0][2])}])
            prof = profile_request(torch, w.name, fresh)
            # Forward passes: decode forwards (N a burst) and prefill
            # forwards.
            fwd = sum(r["decode_forwards"] + int(r["kind"] in (
                "prefill", "mixed")) for r in steplog.rows[n0:])
            prof["forwards"] = fwd
            prof["kernel_launches_per_forward"] = (
                prof["kernel_launches"] / fwd if fwd else None)
            prof["host_launches_per_forward"] = (
                prof["host_launches"] / fwd if fwd else None)
        prompts = dict(steplog.prompts)
        on_engine_out = on_engine(w.engine, tokens) if on_engine else None
    finally:
        w.stop()
    engine_ragged, engine_wta = w.engine.ragged, w.engine.write_then_attend
    kept = w.engine.params if keep_params else None
    del w, steplog
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    ttfts, decode_rates, total_tokens = check_replies(plan, results)
    if engine_ragged != ragged or engine_wta != write_then_attend:
        raise AssertionError(
            f"engine.ragged={engine_ragged}, write_then_attend="
            f"{engine_wta}; want {ragged}, {write_then_attend}")
    # Graphs on: every prefill, ragged and decode step a replay of a
    # graph warmup captured (no capture after warmup, no eager step, in
    # any program); off: none.
    served_programs = ["prefill", "decode_multi" if decode_steps > 1
                       else "decode"] + (["ragged"] if ragged else [])
    if graphs and (any(capture[p]["replays"] == 0 for p in served_programs)
                   or capture["eager_steps"]
                   or capture["captures_after_warmup"]):
        raise AssertionError(f"steps did not run through the warmed-up "
                             f"graphs: {capture}")
    if not graphs and capture["replays"]:
        raise AssertionError(f"graphs replayed with graphs off: {capture}")
    # Every step exactly (step_launches_wanted): the fused writer once per
    # layer per forward, in every path; write-then-attend, K3 x layers per
    # decode forward and K4 x layers per prefill forward, or one ragged
    # forward with K5 x layers; attend-then-write, K3' x layers per decode
    # forward with the last layer's writer in its all-layer mode, K4' x
    # layers + K7 per prefill forward; MLA, K3'' (pool-only or current
    # form) x layers per decode forward, its prefill attention plain, the
    # all-layer mode / K7 in attend-then-write. No other kernel, so the
    # unfused writers K1/K2 and K6 never.
    check_step_launches(rows, counts, layers, mla, write_then_attend,
                        ragged)
    if ragged and ragged_steps < 1:
        raise AssertionError("no ragged iteration ran")
    mixed = [r for r in rows if r["kind"] == "mixed"]
    decode_rows = [r for r in rows if r["kind"] == "decode"]
    out = {"model": model, "layers": layers, "ragged": ragged,
           "write_then_attend": write_then_attend,
           "launches": counts, "engine_steps": steps,
           "ragged_steps": ragged_steps,
           "ttft_ms_streams": ttfts,
           "decode_tokens_per_s_streams": decode_rates,
           "completion_tokens": total_tokens, "wall_s": wall,
           "tokens_per_s_aggregate": total_tokens / wall,
           "forwards_per_request": sum(r["forwards"] for r in rows)
           / len(plan),
           "mixed_steps": len(mixed),
           "forwards_per_mixed_step": (sum(r["forwards"] for r in mixed)
                                       / len(mixed) if mixed else None),
           "kernel_launches_per_mixed_step": (
               sum(sum(r["launches"].values()) for r in mixed) / len(mixed)
               if mixed else None),
           "mixed_step_ms": sorted(r["ms"] for r in mixed),
           "kernel_launches_per_decode_step": (
               sum(sum(r["launches"].values()) for r in decode_rows)
               / len(decode_rows) if decode_rows else None),
           "decode_step_ms_median": _median(
               [r["ms"] for r in rows if r["kind"] == "decode"]),
           "prefill_step_ms_median": _median(
               [r["ms"] for r in rows if r["kind"] == "prefill"]),
           "max_memory_allocated_gib": peak_gb,
           "worker_build_s": build_s,
           "decode_steps": decode_steps,
           # The census without its per-key graph lists.
           "capture": {k: ({kk: vv for kk, vv in v.items()
                            if kk != "graphs"}
                           if isinstance(v, dict) and "graphs" in v else v)
                       for k, v in capture.items()},
           "runner_host_launches": runner_launches,
           "overlap": overlap,
           "moe_dropped_tokens": moe_dropped,
           "profile": prof,
           # The whole call: build, warmup, serving, profile, on_engine.
           "serve_s": time.perf_counter() - t_serve}
    log(f"[serve{tag}] {json.dumps(out)}")
    out["tokens"], out["prompts"] = tokens, prompts
    out["on_engine"] = on_engine_out
    out["params"] = kept
    return out


def _last_logits(torch, params, cfg, ids, device, dtype, path):
    """The logits after ``ids`` from one prefill forward of the whole
    sequence, on ``device`` through ``path`` (ragged, write_then_attend)."""
    from xllm_service_tpu_torch.models import transformer as tf
    ps, T = 128, len(ids)
    pages = -(-T // ps)
    kv = tf.init_kv_cache(cfg, pages + 1, ps, device, dtype=dtype)
    table = torch.arange(1, pages + 1, dtype=torch.int32,
                         device=device)[None]
    logits, _ = tf.forward_prefill(
        params, cfg, torch.tensor([ids], device=device),
        torch.zeros(1, dtype=torch.int32, device=device),
        torch.tensor([T], dtype=torch.int32, device=device), kv, table,
        ragged=path["ragged"],
        write_then_attend=path["ragged"] or path["write_then_attend"])
    return logits[0].float().cpu()


def divergence_margins(torch, engine, pairs, err, cpu_params=None):
    """At each stream's first divergent token between two served paths,
    the top-2 logit margin of one forward over the common prefix (the
    prompt and the tokens both streams share): on the card through each
    path, and with ``cpu_params`` under the plain float32 path on the
    CPU. ``pairs``: (tag, tokens_a, path_a, tokens_b, path_b, prompts),
    tokens by prompt length. A divergence whose reference margin (the
    CPU's where there is one, else the smaller card margin) is wider
    than 10 x ``err`` (phase 4's largest logit error for the model) is
    a fault; a narrower one is drift."""
    from xllm_service_tpu_torch.models import transformer as tf
    dtype = tf.torch_dtype(engine.cfg)
    out = []
    for tag, tok_a, path_a, tok_b, path_b, prompts in pairs:
        for n in sorted(tok_a):
            a, b = tok_a[n], tok_b.get(n, [])
            i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if i is None:
                continue
            ids = prompts[n] + a[:i]
            rec = {"pair": tag, "prompt_tokens": n, "position": i,
                   "served": [a[i], b[i]]}
            for side, path in (("a", path_a), ("b", path_b)):
                top = torch.topk(_last_logits(torch, engine.params,
                                              engine.cfg, ids, engine.device,
                                              dtype, path), 2)
                rec[f"margin_{side}"] = float(top.values[0] - top.values[1])
                rec[f"top2_{side}"] = top.indices.tolist()
            ref = min(rec["margin_a"], rec["margin_b"])
            if cpu_params is not None:
                top = torch.topk(_last_logits(
                    torch, cpu_params, engine.cfg, ids, torch.device("cpu"),
                    torch.float32, {"ragged": False,
                                    "write_then_attend": False}), 2)
                rec["margin_cpu_fp32"] = ref = float(top.values[0]
                                                     - top.values[1])
                rec["top2_cpu_fp32"] = top.indices.tolist()
            rec["limit"] = 10 * err
            rec["verdict"] = "fault" if ref > 10 * err else "drift"
            out.append(rec)
    return out


# The depth at which 5d, 5e and 5g serve DeepSeek-V2-Lite at full width:
# the dense layer and 3 MoE layers, as phase 4 cuts it, so that the
# script fits its time limit.
DEEPSEEK_SERVE_LAYERS = 4
# Phases 5f/5g: the decode modes, in the order they are served.
DECODE_MODES = (("graphs_off", False, 1), ("graphs_n1", True, 1),
                ("graphs_n4", True, 4))


def decode_modes(torch, kernels, model: str, tag: str, err: float,
                 card: str, served_n1: dict, tokens_n1: dict,
                 model_cfg=None) -> dict:
    """Phase 5f (llama3-1b) / 5g (DeepSeek-V2-Lite): the same 4 requests
    served (write-then-attend, ragged off) with graphs off (single
    steps) and graphs on with 4-step bursts and the pipeline, on the
    weights of graphs on with single steps: phase 5's (5d's) serve,
    whose worker has these flags, weights and requests (``served_n1``,
    its tokens ``tokens_n1``). Per mode: TTFT, decode tokens/s per
    stream, the prefill step's median ms, host launches per prefill and
    per ragged forward (``runner_host_launches``), the profiled idle
    share, host launches and device kernels per forward, graphs
    captured, speculation hits and rollbacks. Greedy streams with graphs
    on must equal graphs off token for token; where they do not, the
    margins rule (``divergence_margins``) decides drift or fault, and a
    fault fails. ``model_cfg``: the model to serve instead of
    ``model``'s catalog entry (5g's depth cut)."""
    from xllm_service_tpu_torch.runtime.worker import resolve_model_config
    cfg = model_cfg or resolve_model_config(model)
    runs, tokens = {"graphs_n1": served_n1}, {"graphs_n1": tokens_n1}
    params, prompts = None, None
    for name, graphs, steps in DECODE_MODES:
        if name in runs:
            continue
        out = serve(torch, kernels, model, "cuda", ragged=False,
                    tag=f"{tag}:{name}", graphs=graphs, decode_steps=steps,
                    params=params, keep_params=True, model_cfg=cfg)
        params = out.pop("params")
        tokens[name] = out.pop("tokens")
        prompts = out.pop("prompts")
        out.pop("on_engine")
        runs[name] = out
        free_device_memory(torch)
    same, margins = {}, []
    path = {"ragged": False, "write_then_attend": True}
    for name in ("graphs_n1", "graphs_n4"):
        same[name] = tokens[name] == tokens["graphs_off"]
        if not same[name]:
            margins += divergence_margins(
                torch, types.SimpleNamespace(
                    params=params, cfg=cfg, device=torch.device("cuda")),
                [(name, tokens["graphs_off"], path, tokens[name], path,
                  prompts)], err)
    del params
    free_device_memory(torch)
    faults = [m for m in margins if m["verdict"] == "fault"]
    table = {}
    for name, _, steps in DECODE_MODES:
        x = runs[name]
        table[name] = {
            "decode_steps": steps,
            "ttft_ms": x["ttft_ms_streams"],
            "decode_tokens_per_s_per_stream":
                x["decode_tokens_per_s_streams"],
            "idle_share": x["profile"]["idle_share"],
            "host_launches_per_forward":
                x["profile"]["host_launches_per_forward"],
            "device_kernels_per_forward":
                x["profile"]["kernel_launches_per_forward"],
            "device_busy_ms": x["profile"]["device_busy_ms"],
            "graphs_captured": x["capture"]["captured"],
            "captures_after_warmup": x["capture"]["captures_after_warmup"],
            "spec_hits": x["overlap"]["spec_hits"],
            "spec_rollbacks": x["overlap"]["spec_rollbacks"],
            "decode_step_ms_median": x["decode_step_ms_median"],
            "prefill_step_ms_median": x["prefill_step_ms_median"],
            "mixed_step_ms_median": _median(x["mixed_step_ms"]),
            "host_launches_per_prefill_forward":
                x["runner_host_launches"]["prefill"]["launch"],
            "host_launches_per_ragged_forward":
                x["runner_host_launches"].get("ragged", {}).get("launch"),
            "worker_build_s": x["worker_build_s"]}
        log(f"[serve{tag}] {card}: {model} {name}: "
            f"{json.dumps(table[name])}")
    log(f"[serve{tag}] {card}: {model} greedy streams equal to graphs off: "
        f"{json.dumps(same)}")
    log(f"[margins] {card}: {model} graphs on vs off: {json.dumps(margins)}")
    if faults:
        raise AssertionError(f"{model}: greedy streams with graphs on "
                             f"diverge from graphs off past the margin "
                             f"rule: {faults}")
    return {"modes": table, "equal_to_graphs_off": same, "margins": margins}


def ladder_warmup(torch, model: str, params, card: str) -> dict:
    """``Engine.warmup()``'s full ladder at ``EngineConfig``'s defaults
    (page 64, buckets 64-2048, a 2,048-token budget, 8 slots,
    max_model_len 2048; ragged off) on one model's served weights: the
    seconds, the graph pool's bytes (its segments in the allocator's
    snapshot; beside it the reserved bytes the warmup added, with the
    cached blocks returned) and the graphs captured per program."""
    from xllm_service_tpu_torch.config import EngineConfig
    from xllm_service_tpu_torch.runtime.engine import Engine
    from xllm_service_tpu_torch.runtime.worker import resolve_model_config
    free_device_memory(torch)
    eng = Engine(resolve_model_config(model),
                 EngineConfig(cuda_graphs=True, ragged_attn=False),
                 params=params, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    secs = eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool = tuple(eng.graphs.pool)
    pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) == pool)
    out = {"model": model, "warmup_s": secs, "graph_pool_bytes": pool_bytes,
           "reserved_bytes_added": torch.cuda.memory_reserved() - reserved0,
           "graphs": eng.compile_report(),
           "captures_after_warmup":
               eng.capture_report()["captures_after_warmup"]}
    del eng
    free_device_memory(torch)
    log(f"[warmup] {card}: {model}, the default ladder: {json.dumps(out)}")
    return out


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


# ---------------------------------------------------------------------------
# Phase 6: the cluster
# ---------------------------------------------------------------------------

# The JAX package is the reference the CPU tests hold the port to; no
# process of this script runs it or imports it.
JAX_PACKAGE = "xllm_service_tpu"


def _names_jax_package(text: str) -> bool:
    """True when ``text`` names the JAX package or a module under it
    (``xllm_service_tpu_torch`` is the port, not the JAX package)."""
    return re.search(r"(?<![\w.])" + JAX_PACKAGE + r"(?!\w)", text) \
        is not None


def guard_child_argv(argv) -> None:
    """Fails the run when a child's argv names a module of the JAX
    package."""
    bad = [str(a) for a in argv if _names_jax_package(str(a))]
    if bad:
        raise AssertionError(f"a child process would run the JAX "
                             f"package: {bad}")


def guard_no_jax_modules() -> None:
    """Fails the run when this process imported the JAX package or a
    module of it."""
    bad = sorted(m for m in sys.modules if _names_jax_package(m))
    if bad:
        raise AssertionError(f"the JAX package was imported: {bad[:8]}")


class RefProcess:
    """A child process started as ``python -m <module>`` from this
    checkout: the port's coordination store, master or worker, with
    ``env`` added to its environment (``guard_child_argv`` refuses a
    module of the JAX package). Waits (bounded) for the stdout line
    starting with ``marker``; stderr goes to ``log``."""

    def __init__(self, args, marker: str, log: Path,
                 timeout: float = 60.0, env=None, on_spawn=None) -> None:
        import queue
        guard_child_argv(args)
        self.log_path = log
        self._log = open(log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=self._log,
            env={**os.environ, **(env or {}), "PYTHONPATH": str(ROOT)})
        if on_spawn is not None:          # before the wait for the marker
            on_spawn(self.proc)
        lines: "queue.Queue[str]" = queue.Queue()

        def drain() -> None:       # keeps the pipe from filling up
            for line in self.proc.stdout:
                lines.put(line)
        threading.Thread(target=drain, daemon=True).start()
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(),
                                             0.01))
            except queue.Empty:
                self.stop()
                raise AssertionError(f"{args[0]} did not start: "
                                     f"{self.tail()}") from None
            if line.startswith(marker):
                self.line = line.strip()
                return

    def tail(self, n: int = 20) -> str:
        self._log.flush()
        return "\n".join(self.log_path.read_text(
            errors="replace").splitlines()[-n:])

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=15)
        self._log.close()


def _get(addr: str, path: str):
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"null")
    finally:
        conn.close()


class PushTimes:
    """The RPC topology's push of a step's outputs to the master, timed
    on the engine loop's thread, where it runs after the step and before
    the next one. Wraps the method on the worker instance."""

    def __init__(self, w) -> None:
        self.ms = []
        push = w._push_outputs_to_service

        def timed_push(outs) -> None:
            t0 = time.perf_counter()
            push(outs)
            if outs:
                self.ms.append((time.perf_counter() - t0) * 1e3)

        w._push_outputs_to_service = timed_push

    def summary(self, steplog) -> dict:
        """This run's steps and pushes; empties the push log."""
        steps = sorted(r["ms"] for r in steplog.rows)
        pushes, self.ms = sorted(self.ms), []
        return {"step_ms_median": _median(steps),
                "step_ms_sum": sum(steps),
                "pushes": len(pushes),
                "push_ms_median": _median(pushes),
                "push_ms_max": pushes[-1] if pushes else None,
                "push_ms_sum": sum(pushes)}


def start_master(store: str, rpc_topology: bool, log: Path, env=None):
    """The port's master on ``store``: round robin, block size 128 (the
    worker's page size), 0.5 s heartbeats and keepalives, ``env`` added
    to its environment. Returns (process, http, rpc). The keepalive runs
    at the upload interval, which must sit below the election lease
    (max(3 x 0.5 s, 3 s)): at the default 3 s the master loses its own
    lease every few seconds and re-wins it, and a standing replica can
    take the seat."""
    args = ["xllm_service_tpu_torch.service.master", "--host", "127.0.0.1",
            "--http-port", "0", "--rpc-port", "0", "--etcd-addr", store,
            "--block-size", "128", "--heartbeat-interval", "0.5",
            "--master-upload-interval", "0.5",
            "--load-balance-policy", "RR"]
    if rpc_topology:
        args.append("--enable-decode-response-to-service")
    p = RefProcess(args, "XLLM_SERVICE_UP", log, env=env)
    fields = dict(f.split("=", 1) for f in p.line.split()[1:])
    return p, fields["http"], fields["rpc"]


def listed(master_rpc: str) -> list:
    status, resp = _get(master_rpc, "/rpc/static_prefill_list")
    if status != 200:
        raise AssertionError(f"static_prefill_list: {status} {resp}")
    return resp["instances"]


def master_row(master_http: str, name: str):
    """The master's books on instance ``name`` (load and latency as its
    heartbeats carried them), from ``/admin/debug_bundle``."""
    status, bundle = _get(master_http, "/admin/debug_bundle")
    if status != 200:
        raise AssertionError(f"debug_bundle: {status}")
    return next((r for r in bundle["instances"] if r["name"] == name),
                None)


def wait_for(cond, timeout: float, what: str, step: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(step)
    got = cond()
    if not got:
        raise AssertionError(f"phase 6: {what} not within {timeout:g} s")
    return got


# Phase 6's streamed chats a round (two rounds a topology): prompt
# lengths of 100-400 tokens.
CHAT_ROUND = (380, 250, 120, 330, 200, 300, 150, 400)


def chat_round(addr: str, tokenizer, rng: random.Random) -> list:
    """``CHAT_ROUND``'s streamed chats (32 tokens each, temperature 0,
    their token ids carried) sent at once to ``addr``; per stream its
    TTFT (ms) and its decode tokens/s (31 gaps)."""
    bodies = [_chat_body(_token_ids(tokenizer, rng, n)) for n in CHAT_ROUND]
    out = []
    for r in _concurrent(addr, bodies):
        ttft = _ttft_ms(r)
        _, _, idx, _ = stream_tokens(r["frames"])
        out.append((ttft, 31 / (r["times"][idx[-1]] - r["times"][idx[0]])))
    return out


def _nearest_rank(xs, q: float):
    xs = sorted(xs)
    return xs[max(0, -(-int(q * 100) * len(xs) // 100) - 1)]


def chat_summary(streams: list) -> dict:
    ttft = [t for t, _ in streams]
    rate = [r for _, r in streams]
    return {"streams": len(streams), "ttft_ms_median": _median(ttft),
            "ttft_ms_p90": _nearest_rank(ttft, 0.9),
            "decode_tokens_per_s_median": _median(rate),
            "decode_tokens_per_s_p10": _nearest_rank(rate, 0.1),
            "ttft_ms": ttft, "decode_tokens_per_s": rate}


# The top-level keys of the JAX master's admin answers (its
# ``service/http_service.py``); the port's master must answer with them.
ADMIN_KEYS = {
    "/admin/timeline": ["displayTimeUnit", "metadata", "traceEvents"],
    "/admin/slo": ["breached", "burn_close", "burn_open", "fast_window_s",
                   "objectives", "slow_window_s", "tick_s"],
    "/admin/profile?seconds=0.2": [
        "enabled", "lock_profile_sample", "locks", "sections", "self",
        "stacks", "thread_cpu_s"],
    "/admin/debug_bundle": [
        "anomalies", "captured_at", "events", "flags", "instances",
        "is_master", "metrics", "profile", "service_id", "slo", "spans",
        "steptrace", "tracked_requests"],
}
# The [master] round's budget on the script's clock, and the slack
# allowed past the election lease (max(3 x 0.5 s, 3 s) = 3 s) for the
# store to expire it, the replica's watch to hear the DELETE and its
# election to run.
MASTER_ROUND_S = 20.0
MASTER_LEASE_S = 3.0
MASTER_TAKEOVER_SLACK_S = 0.5


def _compute_app_pids() -> list:
    """The pids of the processes that hold a context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _opened_the_card(pid: int):
    """True when process ``pid`` mapped the CUDA driver library or holds
    an NVIDIA device file open, False when neither, None when its
    ``/proc`` entries cannot be read."""
    try:
        with open(f"/proc/{pid}/maps", encoding="utf-8",
                  errors="replace") as f:
            if any("libcuda" in line for line in f):
                return True
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return None
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
                    "/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def master_round(torch, kernels, w, leader, leader_http: str,
                 store_addr: str, store, procs: list, logs: Path,
                 steplog, rng: random.Random, layers: int) -> dict:
    """Phase 6's ``[master]`` round: the port's master at the card's run.

    The leader's (``leader``, the RPC master) ``/admin/timeline``,
    ``/admin/slo``, ``/admin/profile`` and ``/admin/debug_bundle`` must
    answer 200 with ``ADMIN_KEYS``; its hot-path section medians are
    read from the profile. A second master (relay topology) joins the
    store as a replica; the leader is killed with SIGKILL; the replica
    must take over within ``MASTER_LEASE_S`` + ``MASTER_TAKEOVER_SLACK_S``,
    the worker follow its advertisement (and the relay topology), and
    phase 5's four requests finish through it with the kernels each step
    must launch. Neither master nor the store may hold a context on the
    card: none among the compute apps, and none with the CUDA driver
    mapped or a device file open where ``/proc`` shows this process
    (which holds the card) so."""
    t_round = time.perf_counter()
    out = {"admin": {}}
    for path, keys in ADMIN_KEYS.items():
        status, body = _get(leader_http, path)
        got = sorted(body) if isinstance(body, dict) else body
        out["admin"][path.split("?")[0]] = status
        if status != 200 or got != keys:
            raise AssertionError(f"[master] {path}: {status}, keys {got}")
        if path.startswith("/admin/profile"):
            sections = body["sections"]
        if path == "/admin/debug_bundle" and not body["is_master"]:
            raise AssertionError("[master] the leader's bundle says it is "
                                 "not the master")
    out["sections_us"] = {
        name: {"ops": sections[name]["ops"],
               "p50_us": (None if sections[name]["p50"] is None
                          else sections[name]["p50"] * 1e3),
               "p99_us": (None if sections[name]["p99"] is None
                          else sections[name]["p99"] * 1e3)}
        for name in ("schedule", "tokenize") if name in sections}
    if set(out["sections_us"]) != {"schedule", "tokenize"}:
        raise AssertionError(f"[master] sections: {sorted(sections)}")

    replica, rep_http, rep_rpc = start_master(store_addr, False,
                                              logs / "master_replica.log")
    procs.append(replica)
    status, bundle = _get(rep_http, "/admin/debug_bundle")
    if status != 200 or bundle["is_master"]:
        raise AssertionError("[master] the replica leads beside the leader")
    pids = _compute_app_pids()
    out["compute_app_pids"] = pids
    ours = {"store": store.proc.pid, "leader": leader.proc.pid,
            "replica": replica.proc.pid}
    on_card = {k: p for k, p in ours.items() if p in pids}
    # The same from /proc, which names this process namespace's pids:
    # the CUDA driver library mapped or a device file open. This process
    # (the worker's, on the card) is the probe's control.
    out["opened_the_card"] = {k: _opened_the_card(p)
                              for k, p in ours.items()}
    out["opened_the_card"]["this_process"] = _opened_the_card(os.getpid())
    if out["opened_the_card"]["this_process"]:
        on_card.update({k: p for k, p in ours.items()
                        if out["opened_the_card"][k]})
    if on_card or len(pids) > 1:
        raise AssertionError(f"[master] service processes on the card: "
                             f"{on_card}, compute apps {pids}")
    t0 = time.perf_counter()
    leader.proc.kill()
    leader.proc.wait(timeout=15)

    def replica_leads():
        st, b = _get(rep_http, "/admin/debug_bundle")
        return st == 200 and b["is_master"]
    wait_for(replica_leads, MASTER_LEASE_S + MASTER_TAKEOVER_SLACK_S,
             "the replica leading after the leader's SIGKILL")
    out["takeover_s"] = time.perf_counter() - t0
    wait_for(lambda: w.service_addr == rep_rpc and not w._decode_to_service
             and w.name in listed(rep_rpc), 10.0,
             "the worker following the replica")
    out["followed_s"] = time.perf_counter() - t0
    kernels.reset_launch_counts()
    steplog.clear()
    bodies = [{**b, "model": w.opts.model}
              for b in serve_bodies(rng, w.tokenizer)]
    results, wall = run_concurrent(rep_http, bodies)
    torch.cuda.synchronize()
    ttft, rate, _ = check_replies(SERVE_PLAN, results)
    check_step_launches(steplog.rows, kernels.launch_counts(), layers,
                        False, True, False)
    out["after_takeover"] = {"ttft_ms_streams": ttft,
                             "decode_tokens_per_s_streams": rate,
                             "wall_s": wall}
    out["seconds"] = time.perf_counter() - t_round
    if out["seconds"] > MASTER_ROUND_S:
        raise AssertionError(f"[master] round took {out['seconds']:.1f} s")
    return out


def cluster_phase(torch, kernels, card: str) -> dict:
    """Phase 6: the port's store and master as child processes, the
    port's worker (llama3-1b, 16 layers, bf16, write-then-attend, every
    step through the warmed-up graphs) in-process, registered through
    the store. Checks: one streamed chat alone gives the same text and
    token logprobs direct and through the master; the four served
    requests through the relay master all finish, each step launching
    the kernels it must; 16 streamed chats a topology (``chat_round``,
    two rounds of 8 at once; direct and relay interleaved, RPC after its
    takeover) give TTFT median and p90 and decode tokens/s per stream;
    the master's books show the load a heartbeat carried (and its step
    p99) while a long stream runs, which ``POST /cancel`` then ends, the
    engine idle after; the master is replaced by one in the RPC
    topology, which the worker follows through the store, and the four
    requests finish through it too; the ``[master]`` round
    (``master_round``): the admin answers, a replica's takeover after the
    leader's SIGKILL, the four requests through the replica, no service
    process on the card; ``stop()`` takes the worker off the master's
    list within the lease TTL."""
    from xllm_service_tpu_torch.runtime import worker
    model = "llama3-1b"
    logs = ROOT / "build" / "cluster_logs"
    logs.mkdir(parents=True, exist_ok=True)
    procs, w, out = [], None, {}
    try:
        store = RefProcess(["xllm_service_tpu_torch.service.coordination_net",
                            "--port", "0"],
                           "coordination store serving on",
                           logs / "store.log")
        procs.append(store)
        store_addr = store.line.split()[-1]
        relay, relay_http, relay_rpc = start_master(
            store_addr, False, logs / "master_relay.log")
        procs.append(relay)
        args = worker.parse_args([
            "--model", model, "--device", "cuda",
            "--page-size", "128", "--num-pages", "512",
            "--max-model-len", "1024", "--max-batch-size", "8",
            "--prefill-buckets", "128,256,512", "--max-prefill-tokens",
            "256", "--instance-type", "DEFAULT",
            "--store-addr", store_addr, "--service-addr", relay_rpc,
            "--heartbeat-interval-s", "0.5"])
        env = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
               "XLLM_CUDA_GRAPHS": "1"}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            t0 = time.perf_counter()
            # Warms up (captures the decode graphs) in build, then
            # registers in start().
            w = worker.build_worker(args)
            out["worker_build_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            w.start()
            out["worker_start_s"] = time.perf_counter() - t0
            # The front door: the native epoll server, which g++ builds.
            out["front_door"] = w._srv.kind
            if w._srv.kind != "native":
                raise AssertionError(f"phase 6: the worker's front door is "
                                     f"{w._srv.kind}, not native")
        finally:
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        t0 = time.perf_counter()
        wait_for(lambda: w.name in listed(relay_rpc), 60.0,
                 "the worker on the master's list")
        out["listed_after_start_s"] = time.perf_counter() - t0
        status, info = _get(relay_rpc,
                            f"/rpc/instance_info?name={w.name}")
        if status != 200 or info["page_size"] != 128 or \
                info["models"] != [model] or \
                info["kv_block_bytes"] != w.engine.kv_block_bytes():
            raise AssertionError(f"registration on the master: {info}")
        layers = w.engine.cfg.num_layers
        steplog = StepLog(w.engine, kernels)
        pushes = PushTimes(w)
        rng = random.Random(6)
        chat = "/v1/chat/completions"

        # 1. One streamed chat alone, direct and through the master.
        text = _prompt(rng, 200)
        one = {"model": model, "max_tokens": 32, "temperature": 0.0,
               "ignore_eos": True, "stream": True, "logprobs": True,
               "stream_options": {"include_usage": True},
               "messages": [{"role": "user", "content": text}],
               "token_ids": w.tokenizer.encode(text)}
        alone = {}
        # The same prompt twice: with the prefix cache the second would
        # prefill only past the first's pages, a different window; the
        # pair compares the master's relay, so both prefill in full.
        w.engine.prefix_cache.enable = False
        for where, addr in (("direct", w.name), ("master", relay_http)):
            r = {}
            _request(addr, chat, one, True, r)
            if r.get("status") != 200:
                raise AssertionError(f"{where} chat: {r}")
            alone[where] = stream_tokens(r["frames"])
        (t_d, lp_d, _, u_d), (t_m, lp_m, _, u_m) = (alone["direct"],
                                                    alone["master"])
        lp_diff = max(abs(a - b) for a, b in zip(lp_d, lp_m))
        if t_d != t_m or len(lp_d) != 32 or len(lp_m) != 32 or \
                u_d != u_m or lp_diff > ATTN_TOL:
            raise AssertionError(f"alone: direct {t_d!r} {u_d} vs master "
                                 f"{t_m!r} {u_m}, logprob diff {lp_diff}")
        out["alone_logprob_max_diff"] = lp_diff
        w.engine.prefix_cache.enable = True

        # 2. The four requests direct, then through the relay master; each
        # run its own prompts, so no run prefills from another's pages.
        runs = {}
        for where, addr in (("direct", w.name), ("relay", relay_http)):
            bodies = [{**b, "model": model}
                      for b in serve_bodies(rng, w.tokenizer)]
            kernels.reset_launch_counts()
            steplog.clear()
            pushes.ms.clear()
            results, wall = run_concurrent(addr, bodies)
            torch.cuda.synchronize()
            ttft, rate, toks = check_replies(SERVE_PLAN, results)
            need = check_step_launches(steplog.rows,
                                       kernels.launch_counts(), layers,
                                       False, True, False)
            runs[where] = {"ttft_ms_streams": ttft,
                           "decode_tokens_per_s_streams": rate,
                           "wall_s": wall,
                           "tokens_per_s_aggregate": toks / wall,
                           "engine_steps": len(steplog.rows),
                           **pushes.summary(steplog),
                           "launches": {k: kernels.launch_counts()[k]
                                        for k in need}}

        # 2b. TTFT through the master: 16 streamed chats a topology, in
        # two rounds of 8 at once, direct and relay interleaved (the RPC
        # rounds follow its takeover below).
        chats = {"direct": [], "relay": [], "rpc": []}
        for where, addr in (("direct", w.name), ("relay", relay_http),
                            ("relay", relay_http), ("direct", w.name)):
            chats[where] += chat_round(addr, w.tokenizer, rng)

        # 3-4. A long stream through the master: the master's books show
        # the heartbeat's load; POST /cancel ends it.
        srid = "phase6-cancel"
        long_body = {"model": model, "max_tokens": 900,
                     "temperature": 0.0, "ignore_eos": True, "stream": True,
                     "logprobs": True,
                     "messages": [{"role": "user",
                                   "content": _prompt(rng, 64)}]}
        long_r = {}
        th = threading.Thread(target=_request, args=(
            relay_http, chat, long_body, True, long_r,
            {"x-request-id": srid}))
        th.start()
        try:
            wait_for(lambda: srid in w._live and w.engine.running, 30.0,
                     "the long request running")
            # One running request: a beat sent while the long stream
            # ran, not one left from the four requests.
            row = wait_for(lambda: (lambda r: r if r and r["load"]
                                    ["running_requests"] == 1 and
                                    r["latency"]["step_ms_p99"] > 0
                                    else None)(
                master_row(relay_http, w.name)), 10.0,
                "the heartbeat's load on the master")
            # The next beat covers decode steps only (the first holds
            # the long request's prefill).
            beats, age = [row["latency"]["step_ms_p99"]], \
                row["heartbeat_age_s"]
            t_end = time.monotonic() + 1.5
            while len(beats) < 2 and time.monotonic() < t_end:
                r = master_row(relay_http, w.name)
                if r["heartbeat_age_s"] < age and \
                        r["load"]["running_requests"] == 1:
                    beats.append(r["latency"]["step_ms_p99"])
                age = r["heartbeat_age_s"]
                time.sleep(0.05)
            status, ack = 0, None
            host, port = w.name.rsplit(":", 1)
            conn = HTTPConnection(host, int(port), timeout=30)
            conn.request("POST", "/cancel", json.dumps(
                {"service_request_id": srid}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            status, ack = resp.status, json.loads(resp.read())
            conn.close()
        finally:
            th.join(timeout=60)
        if status != 200 or ack != {"ok": True} or th.is_alive():
            raise AssertionError(f"cancel: {status} {ack}")
        _, lp_c, _, _ = stream_tokens(long_r["frames"])
        if len(lp_c) >= 900:
            raise AssertionError("the cancelled stream ran to its end")
        wait_for(lambda: not w.engine.running and not w.engine.has_work()
                 and not w._live, 10.0, "an idle engine after the cancel")
        out["heartbeat_on_master"] = row
        out["heartbeat_step_ms_p99"] = beats
        out["cancelled_after_tokens"] = len(lp_c)

        # 5. The RPC topology: the relay master stops, one with
        # --enable-decode-response-to-service takes over; the worker
        # follows the store's advertisement and learns the topology.
        relay.stop()
        procs.remove(relay)
        rpc_p, rpc_http, rpc_rpc = start_master(
            store_addr, True, logs / "master_rpc.log")
        procs.append(rpc_p)
        t0 = time.perf_counter()
        wait_for(lambda: w.service_addr == rpc_rpc and w._decode_to_service
                 and w.name in listed(rpc_rpc), 60.0,
                 "the worker following the new master")
        out["takeover_s"] = time.perf_counter() - t0
        kernels.reset_launch_counts()
        steplog.clear()
        pushes.ms.clear()
        bodies = [{**b, "model": model}
                  for b in serve_bodies(rng, w.tokenizer)]
        results, wall = run_concurrent(rpc_http, bodies)
        torch.cuda.synchronize()
        ttft, rate, toks = check_replies(SERVE_PLAN, results)
        need = check_step_launches(steplog.rows, kernels.launch_counts(),
                                   layers, False, True, False)
        runs["rpc"] = {"ttft_ms_streams": ttft,
                       "decode_tokens_per_s_streams": rate,
                       "wall_s": wall,
                       "tokens_per_s_aggregate": toks / wall,
                       "engine_steps": len(steplog.rows),
                       **pushes.summary(steplog),
                       "launches": {k: kernels.launch_counts()[k]
                                    for k in need}}

        for _ in range(2):
            chats["rpc"] += chat_round(rpc_http, w.tokenizer, rng)
        capture = w.engine.capture_report()
        if capture["captures_after_warmup"] or capture["eager_steps"]:
            raise AssertionError(f"phase 6 steps outside the warmed-up "
                                 f"graphs: {capture}")

        # 5b. [master]: the leader's admin answers, then its SIGKILL and
        # a replica's takeover.
        out["master"] = master_round(torch, kernels, w, rpc_p, rpc_http,
                                     store_addr, store, procs, logs,
                                     steplog, rng, layers)
        rpc_rpc = w.service_addr

        # 6. stop() takes the worker off the master's list within the
        # lease TTL.
        t0 = time.perf_counter()
        w.stop()
        # Still referenced: freeing the engine is not part of the wait.
        stopped, w = w, None
        wait_for(lambda: stopped.name not in listed(rpc_rpc),
                 stopped.lease_ttl_s, "the worker off the list after stop()")
        out["off_list_after_stop_s"] = time.perf_counter() - t0
        del stopped
    except Exception:
        for p in procs:
            log(f"[cluster] {p.proc.args[2]} log tail:\n{p.tail()}")
        raise
    finally:
        if w is not None:
            w.stop()
        for p in procs:
            p.stop()
    out["runs"] = runs
    import statistics
    med = {k: {"ttft_ms": statistics.median(v["ttft_ms_streams"]),
               "decode_tokens_per_s": statistics.median(
                   v["decode_tokens_per_s_streams"])}
           for k, v in runs.items()}
    out["medians"] = med
    out["chats"] = {k: chat_summary(v) for k, v in chats.items()}
    log(f"[cluster] detail {json.dumps(out)}")
    log(f"[cluster-loop] {card}: the engine loop per run, [steps, step "
        f"ms median, pushes, push ms median, push ms max]: "
        + json.dumps({k: [v["engine_steps"], v["step_ms_median"],
                          v["pushes"], v["push_ms_median"],
                          v["push_ms_max"]] for k, v in runs.items()}))
    log(f"[cluster] {card}: median TTFT ms through the master (relay) "
        f"{med['relay']['ttft_ms']}, (rpc) {med['rpc']['ttft_ms']}, direct "
        f"{med['direct']['ttft_ms']}; median decode tokens/s per stream "
        f"through the master (relay) {med['relay']['decode_tokens_per_s']}"
        f", (rpc) {med['rpc']['decode_tokens_per_s']}, direct "
        f"{med['direct']['decode_tokens_per_s']}; heartbeat step_ms_p99 "
        f"by beat during a long stream (the first holds its prefill) "
        f"{beats}")
    mr = out["master"]
    after = {"ttft_ms": statistics.median(
                 mr["after_takeover"]["ttft_ms_streams"]),
             "decode_tokens_per_s": statistics.median(
                 mr["after_takeover"]["decode_tokens_per_s_streams"])}
    log(f"[master] {card}: the port's master; admin answers "
        f"{json.dumps(mr['admin'])} with the JAX master's keys; hot-path "
        f"sections (us) {json.dumps(mr['sections_us'])}; SIGKILLed leader "
        f"replaced in {mr['takeover_s']:.3f} s (lease {MASTER_LEASE_S} s), "
        f"worker following in {mr['followed_s']:.3f} s; no service "
        f"process among the card's compute apps "
        f"{mr['compute_app_pids']} (libcuda mapped or a device file open, "
        f"from /proc: {json.dumps(mr['opened_the_card'])}); median TTFT "
        f"ms / decode tokens/s per "
        f"stream of the four requests: direct "
        f"{med['direct']['ttft_ms']} / {med['direct']['decode_tokens_per_s']}"
        f", relay {med['relay']['ttft_ms']} / "
        f"{med['relay']['decode_tokens_per_s']}, rpc {med['rpc']['ttft_ms']}"
        f" / {med['rpc']['decode_tokens_per_s']}, after the takeover "
        f"{after['ttft_ms']} / {after['decode_tokens_per_s']}; the round "
        f"{mr['seconds']:.1f} s")
    log(f"[cluster] {card}: 16 streamed chats a topology (two rounds of "
        f"8 at once), TTFT ms median / p90 and decode tokens/s per stream "
        f"median: " + json.dumps({
            k: [v["ttft_ms_median"], v["ttft_ms_p90"],
                v["decode_tokens_per_s_median"]]
            for k, v in out["chats"].items()}))
    return out


# ---------------------------------------------------------------------------
# Phase 7: prefix reuse; 7b: spill and restore; 6b: cache-aware routing
# ---------------------------------------------------------------------------

# Phase 5's flags, with room for a 1,024-token system prompt, a tail of up
# to 300 tokens and 32 new tokens.
PREFIX_ARGS = ["--model", "llama3-1b", "--device", "cuda",
               "--page-size", "128", "--num-pages", "512",
               "--max-model-len", "2048", "--max-batch-size", "8",
               "--prefill-buckets", "128,256,512",
               "--max-prefill-tokens", "256"]
SYSTEM_TOKENS = 1024                     # 8 full pages of 128
# The cold request's tail, then the three warm requests' tails.
PREFIX_TAILS = (100, 180, 260, 300)
# (tag, ragged, write_then_attend)
PREFIX_PATHS = (("write_then_attend", False, True),
                ("ragged", True, True),
                ("attend_then_write", False, False))
CHAT = "/v1/chat/completions"


def _token_ids(tokenizer, rng: random.Random, n: int) -> list:
    """Exactly ``n`` token ids of a random word prompt (the byte
    tokenizer: one id per byte)."""
    ids = tokenizer.encode(_prompt(rng, 2 * n + 8))
    if len(ids) < n:
        raise AssertionError(f"{len(ids)} ids for {n}")
    return ids[:n]


def _chat_body(ids: list) -> dict:
    return {"model": "llama3-1b", "max_tokens": 32, "temperature": 0.0,
            "ignore_eos": True, "stream": True, "logprobs": True,
            "stream_options": {"include_usage": True},
            "messages": [{"role": "user", "content": "x"}],
            "token_ids": list(ids)}


def _ttft_ms(result) -> float:
    """A streamed reply's first token time (ms); its 32 tokens checked."""
    if result.get("status") != 200:
        raise AssertionError(f"reply {result.get('status')}: {result}")
    _, lps, idx, usage = stream_tokens(result["frames"])
    if not usage or usage["completion_tokens"] != 32 or len(lps) != 32:
        raise AssertionError(f"stream usage {usage}, {len(lps)} tokens")
    return result["times"][idx[0]] * 1e3


def _start(worker, argv, env, params=None):
    """A worker from ``argv`` with ``env`` set while its engine config is
    built (the engine reads its switches once, then)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        w = worker.build_worker(worker.parse_args(argv),
                                params=params).start()
        return w, time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _concurrent(addr, bodies, headers=None):
    results = [{} for _ in bodies]
    threads = [threading.Thread(target=_request, args=(
        addr, CHAT, b, True, r, (headers[i] if headers else None)))
        for i, (b, r) in enumerate(zip(bodies, results))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results


def prefix_phase(torch, kernels, card: str, err: float) -> dict:
    """Phase 7: a 1,024-token system prompt (8 full pages) shared by 4
    requests with distinct tails, served by one llama3-1b worker (16
    layers, bf16, phase 5's flags, every step a replay of a graph its
    warmup captured, wide cached-start tables included) on each path:
    the split
    step in write-then-attend order (fused writer + K4 at start 1024),
    the ragged step (K5 windows at start 1024 beside decode rows) and
    attend-then-write (K4' + K7). Four rounds, cache off / on / on / off
    (``prefix_cache.enable`` toggled on the idle engine), two prompt
    sets: in each the first request runs alone (cold), then the other
    three at once (warm). A cache-on round must hit 3 x 1,024 tokens,
    and every step launch its kernels; the warm streams must equal the
    cache-off round's, or the margins rule decides (a fault fails).
    Returns the weights for phase 7b and each path's numbers."""
    from xllm_service_tpu_torch.runtime import worker
    params, out, margins = None, {}, []
    for tag, ragged, wta in PREFIX_PATHS:
        env = {"XLLM_RAGGED_ATTN": "1" if ragged else "0",
               "XLLM_WRITE_THEN_ATTEND": "1" if wta else "0",
               "XLLM_CUDA_GRAPHS": "1"}
        w, build_s = _start(worker, PREFIX_ARGS, env, params)
        params = w.engine.params
        steplog = StepLog(w.engine, kernels)
        layers = w.engine.cfg.num_layers
        path = {"ragged": ragged, "write_then_attend": wta}
        rec = {"worker_build_s": build_s, "rounds": []}
        try:
            rng = random.Random(70)
            sets = []
            for _ in range(2):
                system = _token_ids(w.tokenizer, rng, SYSTEM_TOKENS)
                sets.append([system + _token_ids(w.tokenizer, rng, n)
                             for n in PREFIX_TAILS])
            tokens = {}
            for r, on in ((0, False), (0, True), (1, True), (1, False)):
                prompts = sets[r]
                w.engine.prefix_cache.enable = on
                kernels.reset_launch_counts()
                steplog.clear()
                hits0 = w.engine.prefix_hit_tokens
                cold = {}
                _request(w.name, CHAT, _chat_body(prompts[0]), True, cold)
                n_cold = len(steplog.rows)
                warm = _concurrent(w.name, [_chat_body(p)
                                            for p in prompts[1:]])
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                rows = list(steplog.rows)
                check_step_launches(rows, counts, layers, False, wta,
                                    ragged)
                hits = w.engine.prefix_hit_tokens - hits0
                if hits != (3 * SYSTEM_TOKENS if on else 0):
                    raise AssertionError(f"phase 7 {tag} round {r} cache "
                                         f"{on}: {hits} hit tokens")
                if on and ragged and not any(x["ragged"]
                                             for x in rows[n_cold:]):
                    raise AssertionError(f"phase 7 {tag}: no ragged step "
                                         f"beside a cached-start window")
                computed = {len(p): len(p) - steplog.cached.get(len(p), 0)
                            for p in prompts}
                prefill_rows = [x for x in rows[n_cold:]
                                if x["kind"] in ("prefill", "mixed")]
                rec["rounds"].append({
                    "round": r, "cache": on, "hit_tokens": hits,
                    "prefill_tokens_computed": [computed[len(p)]
                                                for p in prompts],
                    "ttft_ms_cold": _ttft_ms(cold),
                    "ttft_ms_warm": [_ttft_ms(x) for x in warm],
                    "warm_prefill_steps": len(prefill_rows),
                    "warm_prefill_step_launches": [
                        {k: v for k, v in x["launches"].items() if v}
                        for x in prefill_rows],
                    "engine_steps": len(rows)})
                tokens[(r, on)] = {n: list(t)
                                   for n, t in steplog.tokens.items()}
            same = []
            for r in (0, 1):
                same.append(tokens[(r, True)] == tokens[(r, False)])
                if not same[-1]:
                    margins += divergence_margins(
                        torch, w.engine,
                        [(f"prefix_{tag}_round{r}", tokens[(r, False)],
                          path, tokens[(r, True)], path,
                          {len(p): p for p in sets[r]})], err)
            rec["warm_equal_to_cache_off"] = same
            rec["prefix_cache_stats"] = w.engine.prefix_cache_stats()
            # Every window, cached starts and their wide tables included,
            # a replay of a graph the worker's warmup captured.
            cap = w.engine.capture_report()
            rec["capture"] = {p: {k: cap[p][k] for k in (
                "captured", "replays", "captures_after_warmup", "late",
                "eager_steps")} for p in ("prefill", "ragged", "decode")}
            if cap["captures_after_warmup"] or cap["eager_steps"] or \
                    cap["prefill"]["replays"] == 0 or \
                    (ragged and cap["ragged"]["replays"] == 0):
                raise AssertionError(f"phase 7 {tag}: steps outside the "
                                     f"warmed-up graphs: {rec['capture']}")
        finally:
            w.stop()
        del w, steplog
        free_device_memory(torch)
        out[tag] = rec
        log(f"[prefix] {card}: {tag}: {json.dumps(rec)}")
    faults = [m for m in margins if m["verdict"] == "fault"]
    log(f"[margins] {card}: llama3-1b prefix cache on vs off: "
        f"{json.dumps(margins)}")
    if faults:
        raise AssertionError(f"phase 7: warm streams diverge from the "
                             f"cache-off streams past the margin rule: "
                             f"{faults}")
    out["margins"] = margins
    for tag, rec in out.items():
        if tag == "margins":
            continue
        on = [x for x in rec["rounds"] if x["cache"]]
        off = [x for x in rec["rounds"] if not x["cache"]]
        log(f"[prefix] {card}: {tag}: hit tokens per cache-on round "
            f"{[x['hit_tokens'] for x in on]}; prefill tokens computed per "
            f"request, on {[x['prefill_tokens_computed'] for x in on]} vs "
            f"off {[x['prefill_tokens_computed'] for x in off]}; TTFT ms "
            f"cold {[round(x['ttft_ms_cold'], 3) for x in on]} vs warm "
            f"{[[round(t, 3) for t in x['ttft_ms_warm']] for x in on]} "
            f"(cache off, the same requests: "
            f"{[[round(t, 3) for t in x['ttft_ms_warm']] for x in off]})")
    out["params"] = params
    return out


def spill_phase(torch, kernels, card: str, params, err: float) -> dict:
    """Phase 7b: the same weights on a 40-page pool with a 160 MB host
    tier (XLLM_KV_SPILL_MB; one llama3-1b page, K and V over 16 layers,
    is 4 MiB): a shared-prompt request, three fillers of 1,900 distinct
    tokens that reclaim its pages (spilled to the tier), then the shared
    request again, restored from the tier. Checks: pages spilled and
    restored; every restored page, read back from the pool, bit-equal to
    the bytes the tier took at spill; the stream equal to the cold one
    (or the margins rule decides)."""
    from xllm_service_tpu_torch.runtime import worker
    from xllm_service_tpu_torch.runtime.kv_cache import pool_gather
    argv = list(PREFIX_ARGS)
    argv[argv.index("--num-pages") + 1] = "40"
    env = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
           "XLLM_CUDA_GRAPHS": "1", "XLLM_KV_SPILL_MB": "160"}
    w, build_s = _start(worker, argv, env, params)
    eng = w.engine
    taken = {}
    # Host ms of each spill (the gather and the tier's put, without this
    # phase's copy of the block) and of each restore.
    spill_ms, restore_ms = [], []
    try:
        if eng.host_tier is None:
            raise AssertionError("phase 7b: no host tier")
        put, spill = eng.host_tier.put, eng.prefix_cache.spill_hook
        restore = eng._restore_spilled

        def recording_put(h, k, v):
            ok = put(h, k, v)
            if ok:
                taken[h] = (k, v)       # copied in timed_spill
            return ok

        def timed_spill(h, pid):
            t0 = time.perf_counter()
            ok = spill(h, pid)
            if ok:
                t1 = time.perf_counter()
                taken[h] = tuple(x.clone() for x in taken[h])
                t0 += time.perf_counter() - t1     # the check's copy
            spill_ms.append((time.perf_counter() - t0) * 1e3)
            return ok

        def timed_restore(*args):
            t0 = time.perf_counter()
            got = restore(*args)
            restore_ms.append((time.perf_counter() - t0) * 1e3)
            return got
        eng.host_tier.put = recording_put
        eng.prefix_cache.spill_hook = timed_spill
        eng._restore_spilled = timed_restore
        steplog = StepLog(eng, kernels)
        rng = random.Random(71)
        shared = _token_ids(w.tokenizer, rng, SYSTEM_TOKENS) + \
            _token_ids(w.tokenizer, rng, 200)
        fillers = [_token_ids(w.tokenizer, rng, 1900) for _ in range(3)]
        first = {}
        _request(w.name, CHAT, _chat_body(shared), True, first)
        cold = list(steplog.tokens[len(shared)])
        for f in fillers:
            r = {}
            _request(w.name, CHAT, _chat_body(f), True, r)
            _ttft_ms(r)
        stats0 = eng.prefix_cache_stats()
        steplog.clear()
        again = {}
        _request(w.name, CHAT, _chat_body(shared), True, again)
        torch.cuda.synchronize()
        warm = list(steplog.tokens[len(shared)])
        stats = eng.prefix_cache_stats()
        hashes = eng.prefix_cache.block_hashes(shared)[:len(shared) // 128]
        restored = [h for h in hashes if h in taken]
        unequal = []
        for h in restored:
            pid = eng.prefix_cache.page_of(h)
            if pid is None:
                unequal.append((h.hex(), "not in the pool"))
                continue
            back = pool_gather(eng.kv, pid)
            if not all(torch.equal(a, b) for a, b in zip(back, taken[h])):
                unequal.append((h.hex(), pid))
        ev = eng.drain_kvcache_event()
        rec = {"worker_build_s": build_s,
               "spilled_pages": stats["spilled_pages"],
               "restored_pages": stats["restored_pages"],
               "spilled_before_reuse": stats0["spilled_pages"],
               "restored_blocks_of_shared_prompt": len(restored),
               "cached_tokens_on_reuse": steplog.cached.get(len(shared), 0),
               "bit_equal": not unequal,
               "ttft_ms_cold": _ttft_ms(first),
               "ttft_ms_restored": _ttft_ms(again),
               "spill_ms": spill_ms,
               "restore_ms": restore_ms,
               "stream_equal": warm == cold,
               "events": {"stored": len(ev.stored),
                          "removed": len(ev.removed),
                          "offloaded": len(ev.offloaded),
                          "offloaded_ssd": len(ev.offloaded_ssd)}}
        if not (stats["spilled_pages"] > 0 and stats["restored_pages"] > 0
                and restored):
            raise AssertionError(f"phase 7b: nothing spilled and restored:"
                                 f" {rec}")
        if unequal:
            raise AssertionError(f"phase 7b: restored pages differ from "
                                 f"the spilled bytes: {unequal}")
        rec["margins"] = [] if warm == cold else divergence_margins(
            torch, eng, [("spill_restore", {len(shared): cold},
                          {"ragged": False, "write_then_attend": True},
                          {len(shared): warm},
                          {"ragged": False, "write_then_attend": True},
                          {len(shared): shared})], err)
    finally:
        w.stop()
    del w, eng
    free_device_memory(torch)
    log(f"[spill] {card}: {json.dumps(rec)}")
    if any(m["verdict"] == "fault" for m in rec["margins"]):
        raise AssertionError(f"phase 7b: the restored stream diverges "
                             f"past the margin rule: {rec['margins']}")
    return rec


def _route_audit(master_http: str, srid: str):
    """The routing audit of request ``srid`` on the master: (winner,
    winner's match ratio, fallback reason)."""
    status, span = _get(master_http, f"/admin/trace/{srid}")
    if status != 200:
        raise AssertionError(f"trace {srid}: {status} {span}")
    audit = span["attrs"]["schedule_decision"]
    role = next(audit[r] for r in ("prefill", "decode")
                if audit.get(r, {}).get("candidates"))
    row = next(c for c in role["candidates"]
               if c["instance"] == role["winner"])
    return role["winner"], row["match_ratio"], role["fallback_reason"]


def routed_cluster_phase(torch, kernels, card: str, params) -> dict:
    """Phase 6b: the port's store and a master under the cache-aware
    policy (``--load-balance-policy CAR --block-size 128``) with two
    port workers (llama3-1b, the same weights, 0.5 s heartbeats) in this
    process. A (the 1,024-token shared prompt and a tail) is served
    first; once a heartbeat after it was acknowledged, B and C (the same
    prefix, new tails) at once, then D (no shared prefix). The master's
    routing audit (``/admin/trace/<id>``) must show B and C on A's
    worker with a match ratio above 0 and no fallback, and D on the
    least-loaded fallback."""
    from xllm_service_tpu_torch.runtime import worker
    logs = ROOT / "build" / "cluster_logs"
    logs.mkdir(parents=True, exist_ok=True)
    procs, ws, out = [], [], {}
    try:
        store = RefProcess(["xllm_service_tpu_torch.service.coordination_net",
                            "--port", "0"], "coordination store serving on",
                           logs / "store_car.log")
        procs.append(store)
        store_addr = store.line.split()[-1]
        master = RefProcess(
            ["xllm_service_tpu_torch.service.master", "--host", "127.0.0.1",
             "--http-port", "0", "--rpc-port", "0", "--etcd-addr",
             store_addr, "--block-size", "128", "--heartbeat-interval",
             "0.5", "--master-upload-interval", "0.5",
             "--load-balance-policy", "CAR"], "XLLM_SERVICE_UP",
            logs / "master_car.log")
        procs.append(master)
        fields = dict(f.split("=", 1) for f in master.line.split()[1:])
        http, rpc = fields["http"], fields["rpc"]
        argv = PREFIX_ARGS + ["--instance-type", "DEFAULT", "--store-addr",
                              store_addr, "--service-addr", rpc,
                              "--heartbeat-interval-s", "0.5"]
        env = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
               "XLLM_CUDA_GRAPHS": "1"}
        for _ in range(2):
            # Built one after the other: a worker's warmup captures its
            # graphs while the other's engine loop is idle.
            w, _ = _start(worker, argv, env, params)
            ws.append(w)
        for w in ws:
            wait_for(lambda w=w: w.name in listed(rpc), 60.0,
                     f"worker {w.name} on the cache-aware master's list")
        rng = random.Random(72)
        tok = ws[0].tokenizer
        system = _token_ids(tok, rng, SYSTEM_TOKENS)
        prompts = {"A": system + _token_ids(tok, rng, 150),
                   "B": system + _token_ids(tok, rng, 220),
                   "C": system + _token_ids(tok, rng, 90),
                   "D": _token_ids(tok, rng, 1100)}
        results, audit = {}, {}

        def send(names):
            rs = _concurrent(http, [_chat_body(prompts[n]) for n in names],
                             [{"x-request-id": f"phase6b-{n}"}
                              for n in names])
            for n, r in zip(names, rs):
                results[n] = r
                audit[n] = _route_audit(http, f"phase6b-{n}")

        send(["A"])
        t_done = time.monotonic()
        holder = audit["A"][0]
        # A beat the master received after A finished carries A's
        # digests (the worker keeps an undelivered delta for the next).
        wait_for(lambda: (lambda row: row is not None and
                          time.monotonic() - row["heartbeat_age_s"]
                          > t_done + 0.1)(master_row(http, holder)),
                 10.0, "a heartbeat after A on the master")
        send(["B", "C"])
        send(["D"])
        for n in ("B", "C"):
            winner, ratio, fallback = audit[n]
            if winner != holder or not ratio > 0 or fallback is not None:
                raise AssertionError(f"phase 6b: {n} routed {audit[n]}, "
                                     f"A's worker {holder}")
        if audit["D"][2] != "no_prefix_overlap" or audit["D"][1] != 0:
            raise AssertionError(f"phase 6b: D routed {audit['D']}")
        served = {w.name: w.engine.prefix_cache_stats() for w in ws}
        if served[holder]["hit_tokens_total"] < 2 * SYSTEM_TOKENS:
            raise AssertionError(f"phase 6b: the holder's hits {served}")
        out = {"holder": holder,
               "routes": {n: {"winner": a[0], "match_ratio": a[1],
                              "fallback_reason": a[2]}
                          for n, a in audit.items()},
               "ttft_ms": {n: _ttft_ms(r) for n, r in results.items()},
               "prefix_cache_stats": served}
    except Exception:
        for p in procs:
            log(f"[cluster-car] {p.proc.args[2]} log tail:\n{p.tail()}")
        raise
    finally:
        for w in ws:
            w.stop()
        for p in procs:
            p.stop()
    del ws
    free_device_memory(torch)
    log(f"[cluster-car] {card}: winners "
        f"{ {n: r['winner'] == out['holder'] for n, r in out['routes'].items()} }"
        f" (True = A's worker); match ratios "
        f"{ {n: r['match_ratio'] for n, r in out['routes'].items()} }; "
        f"fallbacks { {n: r['fallback_reason'] for n, r in out['routes'].items()} }"
        f"; TTFT ms A {out['ttft_ms']['A']} vs B {out['ttft_ms']['B']}, C "
        f"{out['ttft_ms']['C']} (D, no shared prefix, {out['ttft_ms']['D']})")
    log(f"[cluster-car] detail {json.dumps(out)}")
    return out


# Phase 8: the seeds and positions of the threefry check, and the
# tolerance of the card's Gumbel noise against the CPU's.
THREEFRY_SEEDS = (0, 1, 2 ** 31 - 1)
THREEFRY_POSITIONS = (0, 1, 4095)
GUMBEL_TOL = 1e-6
CMPL = "/v1/completions"
# Phase 8's model and device (a CPU rehearsal rewrites them: "tiny",
# "cpu").
SAMPLING_MODEL, SAMPLING_DEVICE = "llama3-1b", "cuda"


def _sampler_times(torch, samp, V: int) -> dict:
    """Device ms of the sampler's pieces at a decode step's shape (B = 8
    rows over llama3-1b's vocabulary, ``graph_ms``): greedy (bias and
    argmax), sampled (the filter and the generator's draw), seeded (the
    threefry chain added), seeded with the penalties, and the seeded
    chain alone (``seeded_gumbel``), the counts update and the top-5
    logprobs."""
    from xllm_service_tpu_torch.utils.types import SamplingParams
    dev = torch.device("cuda")
    B = 8
    g = torch.Generator(device=dev).manual_seed(23)
    logits = torch.randn((B, V), generator=g, device=dev) * 3
    params = [SamplingParams(temperature=0.8, top_p=0.9, seed=i,
                             presence_penalty=0.5, frequency_penalty=0.5)
              for i in range(B)]
    st = samp.SamplingTensors.from_packed(
        samp.SamplingTensors.pack_batch(params), dev)
    pos = torch.arange(100, 100 + B, dtype=torch.int32, device=dev)
    counts = torch.randint(0, 3, (B, V), generator=g, device=dev,
                           dtype=torch.int32)
    ids, vals = (torch.from_numpy(a).to(dev)
                 for a in samp.batch_bias(params, B, V))
    tokens = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)

    def sample(greedy, seeded, cnt=None):
        # The default generator: graph_ms registers no other.
        return lambda: samp.sample_packed(logits, st, None, greedy, seeded,
                                          pos, cnt, ids, vals)
    return {
        "greedy": graph_ms(sample(True, False)),
        "sampled": graph_ms(sample(False, False)),
        "seeded": graph_ms(sample(False, True)),
        "seeded_penalized": graph_ms(sample(False, True, counts)),
        "seeded_chain": graph_ms(lambda: samp.seeded_gumbel(st.seed, pos,
                                                            V)),
        "update_counts": graph_ms(lambda: samp.update_counts(
            counts, tokens, active)),
        "top_logprobs_5": graph_ms(lambda: samp.compute_top_logprobs(
            logits, 5))}


def _perturbed_margin(torch, samp, engine, ids, a: int, b: int,
                      sp) -> float:
    """|score(a) - score(b)| of the seeded draw after ``ids``: each
    token's filtered, scaled logit (one prefill forward on the card)
    plus its threefry Gumbel noise at the draw's position."""
    from xllm_service_tpu_torch.models import transformer as tf
    logits = _last_logits(torch, engine.params, engine.cfg, ids,
                          engine.device, tf.torch_dtype(engine.cfg),
                          {"ragged": False, "write_then_attend": True})
    st = samp.SamplingTensors.from_packed(
        samp.SamplingTensors.pack_batch([sp]), "cpu")
    noise = samp.seeded_gumbel(torch.tensor([sp.seed]),
                               torch.tensor([len(ids) - 1]),
                               logits.shape[-1])[0]
    score = samp.filtered_scaled(logits[None], st)[0] + noise
    return float((score[a] - score[b]).abs())


def sampling_phase(torch, kernels, card: str, err: float) -> dict:
    """Phase 8: the OpenAI sampling surface on the card.

    8a: threefry on the card (bits bit-equal to the CPU's, the Gumbel
    noise within ``GUMBEL_TOL``) for ``THREEFRY_SEEDS`` x
    ``THREEFRY_POSITIONS`` over llama3-1b's vocabulary, and the
    sampler's pieces timed (``_sampler_times``).

    8b: a llama3-1b worker (phase 5's flags, ``num_top_logprobs=5``)
    serves a greedy round, a concurrent mix (2 greedy requests with
    presence and frequency penalties, a ``logit_bias`` banning the
    greedy first token, one of 20 entries (a bias width of 32, captured
    late), 2 seeded sampled requests with top-5 logprobs, an ``n=3``
    seeded chat, an echo with ``logprobs=2`` and a ``best_of=3, n=1``
    completion) and a seeded round, then each seeded request of the mix
    alone. Checks: every reply; the banned token never sampled; each
    top list 5 entries, sorted, headed at or above the chosen token's
    logprob; each seeded stream equal to the same request served alone
    (where one is not, the perturbed-score margin at its first divergent
    token, ``_perturbed_margin``, against 10 x phase 4's logit error
    over the temperature: drift below it, a fault above); echo's text
    led by its prompt; no eager step; captures after warmup only the
    named late keys (bias width 32, the prompt-scored prefill); one host
    launch a prefill forward; the mix's kernel launches per step.
    Prints the decode step medians of the three rounds."""
    from xllm_service_tpu_torch.config import EngineConfig
    from xllm_service_tpu_torch.ops import sampling as samp
    from xllm_service_tpu_torch.runtime import worker
    from xllm_service_tpu_torch.utils.types import SamplingParams
    V = worker.resolve_model_config(SAMPLING_MODEL).vocab_size
    dev = torch.device(SAMPLING_DEVICE)
    # 8a. threefry on the card.
    seeds = torch.tensor([s for s in THREEFRY_SEEDS
                          for _ in THREEFRY_POSITIONS])
    positions = torch.tensor([p for _ in THREEFRY_SEEDS
                              for p in THREEFRY_POSITIONS])

    def chain(device):
        key = samp.fold_in(samp.prng_key(seeds.to(device)),
                           positions.to(device))
        bits = samp.random_bits(key, (V,))
        return bits.cpu(), samp.gumbel_from_bits(bits).cpu()
    bits_cpu, gumbel_cpu = chain(torch.device("cpu"))
    bits_card, gumbel_card = chain(dev)
    gdiff = (gumbel_card - gumbel_cpu).abs()
    threefry = {"rows": len(seeds), "vocab": V,
                "bits_equal": bool(torch.equal(bits_cpu, bits_card)),
                "gumbel_max_abs_diff": float(gdiff.max()),
                "gumbel_max_rel_diff": float(
                    (gdiff / gumbel_cpu.abs().clamp(min=1.0)).max()),
                "tolerance": GUMBEL_TOL}
    times = _sampler_times(torch, samp, V)
    log(f"[sampling] {card}: threefry on the card against the CPU "
        f"{json.dumps(threefry)}; sampler device ms at B = 8 x V = {V} "
        f"{json.dumps(times)}")
    if not threefry["bits_equal"] or \
            threefry["gumbel_max_abs_diff"] > GUMBEL_TOL:
        raise AssertionError(f"threefry on the card: {threefry}")

    # 8b. The worker.
    env = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
           "XLLM_CUDA_GRAPHS": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ecfg = EngineConfig(page_size=128, num_pages=512,
                            max_model_len=1024, max_batch_size=8,
                            max_prefill_tokens=256,
                            prefill_buckets=(128, 256, 512),
                            num_top_logprobs=5)
        w = worker.Worker(worker.WorkerOptions(model=SAMPLING_MODEL,
                                               device=SAMPLING_DEVICE,
                                               warmup=True),
                          engine_cfg=ecfg).start()
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    eng = w.engine
    steplog = StepLog(eng, kernels)
    by_rid = {}
    inner = eng.step

    def step():
        outs = inner()
        for o in outs:
            r = by_rid.setdefault(o.request_id,
                                  {"tokens": [], "lps": [], "tops": []})
            r["tokens"] += o.new_token_ids
            r["lps"] += o.logprobs
            r["tops"] += o.top_logprobs or []
        return outs
    eng.step = step
    rng = random.Random(8)
    tok = w.tokenizer

    def body(rid, path, length, **kw):
        ids = _token_ids(tok, rng, length)
        b = {"max_tokens": 32, "ignore_eos": True, "token_ids": ids,
             "service_request_id": rid, **kw}
        if path == CHAT:
            b["messages"] = [{"role": "user", "content": "x"}]
        else:
            b["prompt"] = tok.decode(ids)
        return rid, path, b

    def run(reqs):
        results = [{} for _ in reqs]
        threads = [threading.Thread(target=_request,
                                    args=(w.name, p, b, False, r))
                   for (_, p, b), r in zip(reqs, results)]
        steplog.clear()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        for (rid, _, _), r in zip(reqs, results):
            if r.get("status") != 200:
                raise AssertionError(f"{rid}: {r}")
        return results, list(steplog.rows), wall

    def decode_median(rows):
        return _median([r["ms"] for r in rows if r["kind"] == "decode"])
    try:
        sizes = (120, 200, 160, 260)
        greedy_round = [body(f"g{i}", CMPL, n, temperature=0.0)
                        for i, n in enumerate(sizes)]
        _, g_rows, _ = run(greedy_round)
        probe = body("ban_probe", CMPL, 180, temperature=0.0, max_tokens=1)
        run([probe])
        ban = by_rid["ban_probe"]["tokens"][0]
        sampled = dict(temperature=0.8, top_p=0.9)
        mix = [
            body("pen0", CMPL, 150, temperature=0.0, presence_penalty=0.5,
                 frequency_penalty=0.5),
            body("pen1", CHAT, 230, temperature=0.0, presence_penalty=0.5,
                 frequency_penalty=0.5),
            ("ban", CMPL, dict(probe[2], service_request_id="ban",
                               max_tokens=32,
                               logit_bias={str(ban): -100})),
            body("bias20", CMPL, 110, temperature=0.0,
                 logit_bias={str(V - 1 - i): 1.0 for i in range(20)}),
            body("seed0", CMPL, 190, seed=1234, logprobs=5, **sampled),
            body("seed1", CHAT, 140, seed=99, logprobs=True,
                 top_logprobs=5, **sampled),
            body("n3", CHAT, 170, n=3, seed=7, **sampled),
            body("echo", CMPL, 130, temperature=0.0, echo=True, logprobs=2),
            body("best", CMPL, 210, best_of=3, n=1, seed=5, **sampled)]
        kernels.reset_launch_counts()
        mix_results, mix_rows, mix_wall = run(mix)
        torch.cuda.synchronize()
        launch_counts = kernels.launch_counts()
        seeded_round = [body(f"s{i}", CMPL, n, seed=300 + i, **sampled)
                        for i, n in enumerate(sizes)]
        _, s_rows, _ = run(seeded_round)
        seeded_rids = {"seed0": ["seed0"], "seed1": ["seed1"],
                       "n3": [f"n3#{k}" for k in range(3)],
                       "best": [f"best#{k}" for k in range(3)]}
        alone = {}
        for rid, path, b in mix:
            if rid in seeded_rids:
                run([(rid + "_alone", path,
                      dict(b, service_request_id=rid + "_alone"))])
                alone[rid] = b
        capture = eng.capture_report()
        host = runner_host_launches(torch, eng)
    finally:
        w.stop()
    bodies = {rid: r["body"] for (rid, _, _), r in zip(mix, mix_results)}
    checks = {}
    if ban in by_rid["ban"]["tokens"]:
        raise AssertionError(f"the banned token {ban} was sampled")
    checks["banned_token_sampled"] = False
    tops = 0
    for rid in ("seed0", "seed1"):
        r = by_rid[rid]
        if len(r["tops"]) != 32 or len(r["tokens"]) != 32:
            raise AssertionError(f"{rid}: {len(r['tops'])} top lists")
        for lp, row in zip(r["lps"], r["tops"]):
            vals = [e["logprob"] for e in row]
            if len(row) != 5 or vals != sorted(vals, reverse=True) or \
                    vals[0] < lp - 1e-6:
                raise AssertionError(f"{rid}: top list {row}, chosen {lp}")
            tops += 1
    checks["top_lists_checked"] = tops
    if len(bodies["n3"]["choices"]) != 3 or \
            len(bodies["best"]["choices"]) != 1:
        raise AssertionError(f"choices: {bodies['n3']}, {bodies['best']}")
    echo_prompt = dict((r, b) for r, _, b in mix)["echo"]["prompt"]
    if not bodies["echo"]["choices"][0]["text"].startswith(echo_prompt):
        raise AssertionError(f"echo: {bodies['echo']['choices'][0]}")
    lp_echo = bodies["echo"]["choices"][0]["logprobs"]["token_logprobs"]
    if lp_echo[0] is not None or len(lp_echo) != \
            len(dict((r, b) for r, _, b in mix)["echo"]["token_ids"]) + 32:
        raise AssertionError(f"echo logprobs: {lp_echo[:3]}, "
                             f"{len(lp_echo)}")
    equal, margins = {}, []
    for rid, erids in seeded_rids.items():
        b = alone[rid]
        for k, erid in enumerate(erids):
            x = by_rid[erid]["tokens"]
            y = by_rid[erid.replace(rid, rid + "_alone", 1)]["tokens"]
            equal[erid] = x == y
            i = next((j for j, (p, q) in enumerate(zip(x, y)) if p != q),
                     None)
            if i is None:
                continue
            sp = SamplingParams(temperature=b["temperature"],
                                top_p=b["top_p"], seed=b["seed"] + k
                                if len(erids) > 1 else b["seed"])
            margin = _perturbed_margin(torch, samp, eng,
                                       b["token_ids"] + x[:i], x[i], y[i],
                                       sp)
            limit = 10 * err / b["temperature"]
            margins.append({"stream": erid, "position": i,
                            "served": [x[i], y[i]], "margin": margin,
                            "limit": limit,
                            "verdict": "fault" if margin > limit
                            else "drift"})
    late = [n for p in ("prefill", "ragged", "decode", "decode_multi")
            for n in capture[p]["late"]]
    eager = {p: capture[p]["eager_steps"] for p in ("prefill", "ragged",
                                                    "decode",
                                                    "decode_multi")}
    need = check_step_launches(mix_rows, launch_counts, eng.cfg.num_layers,
                               False, True, False)
    out = {"card": card, "threefry": threefry, "sampler_ms": times,
           "banned_token": ban, "checks": checks,
           "seeded_equal_alone": equal, "margins": margins,
           "late_captures": late, "eager_steps": eager,
           "captures_after_warmup": capture["captures_after_warmup"],
           "graphs": eng.compile_report(),
           "host_launches_per_prefill_forward": host["prefill"]["launch"],
           "kernels_on_the_mix": need,
           "decode_step_ms_median": {
               "greedy_round": decode_median(g_rows),
               "mix": decode_median(mix_rows),
               "seeded_round": decode_median(s_rows)},
           "mix_wall_s": mix_wall, "mix_engine_steps": len(mix_rows)}
    log(f"[sampling] {card}: {json.dumps(out)}")
    if any(m["verdict"] == "fault" for m in margins):
        raise AssertionError(f"seeded streams served alone diverge past "
                             f"the margin rule: {margins}")
    if capture["eager_steps"] or any(eager.values()):
        raise AssertionError(f"eager steps: {eager}")
    if not late or not all("_bias32" in n or n.endswith("_echo")
                           for n in late) \
            or not any(n.endswith("_echo") for n in late) \
            or not any("_bias32" in n for n in late):
        raise AssertionError(f"captures after warmup: {late}")
    if host["prefill"]["launch"] != 1:
        raise AssertionError(f"host launches a prefill forward: {host}")
    return out


# Phase 9's model and device (a CPU rehearsal rewrites them: "tiny",
# "cpu"), and the prompt lengths of its eight greedy streams.
FAULT_MODEL, FAULT_DEVICE = "llama3-1b", "cuda"
FAULT_SIZES = (120, 200, 160, 260, 140, 230, 180, 110)


def _stream_tokens_and_times(result):
    """(token ids, arrival seconds of each, error frame or None) of one
    streamed completion served with ``ledger_tokens`` (every frame
    carries its token ids)."""
    ids, times, error = [], [], None
    for frame, t in zip(result.get("frames", []), result.get("times", [])):
        if not frame.startswith("data: ") or frame == "data: [DONE]":
            continue
        obj = json.loads(frame[len("data: "):])
        if "error" in obj:
            error = obj["error"]
            continue
        new = (obj.get("xllm") or {}).get("token_ids") or []
        ids += new
        times += [t] * len(new)
    return ids, times, error


def fault_phase(torch, kernels, card: str, err: float) -> dict:
    """Phase 9: the step fault boundary and the flight recorder on the
    card, on one llama3-1b worker with phase 5's flags (write-then-
    attend, graphs on, single decode steps).

    A fault-free round first: the eight greedy streams of
    ``FAULT_SIZES`` (32 tokens each, streamed with ``ledger_tokens`` so
    every frame carries its token ids), launch counts checked per step.

    9a: the same eight streams; once all eight decode, a request seeded
    past int32 (``seed: 2**31``) arrives; it is admitted when the first
    stream finishes, and its prefill packing raises OverflowError. It
    must get the typed ``engine_fault`` with a ``culprit`` verdict, the
    eight streams must finish with 32 tokens each, equal to the
    fault-free round or diverging as drift (``divergence_margins``), the
    culprit counter read 1 and the engine loop stay alive.

    9b: seven of the streams decode; an eighth arrives; while the decode
    step's graph replays, ``worker.fault_step`` is armed with count:1
    through ``POST /admin/failpoint``, so that the prefill section of
    the same step faults after the decode section completed: the eighth
    request is the culprit, and the decode section's salvaged outputs
    must reach their seven streams (32 tokens each, equal or drift); the
    culprit counter reads 2. Then the eight streams once more, with the
    failpoint armed while they decode and nothing is queued: it trips in
    a decode section of eight members, which the worker bisects in probe
    steps (isolating halves, each re-prefilled), blaming one stream by
    elimination; the seven others finish (equal or drift), the counter
    reads 3 and at least one probe ran.

    In both: no eager step and no capture after warmup (every probe,
    re-prefill and resumed decode replays a warmup graph). Printed: the
    faulted step's ms, the probes, the salvaged outputs, and each
    survivor's extra wait from re-prefill (its longest gap between
    tokens against its median gap in the fault-free round).

    9c: ``/admin/steptrace``: the median MFU and debt per step kind and
    the bound verdicts, the roofline rows and the peaks beside the card;
    llama3-1b's ``decode`` keys hold 2 x B x (non-embedding parameters +
    LM head) FLOPs plus at most their attention share; then the greedy
    round four times with the recorder off and on alternately: the
    decode step median of each setting and the recorder's host
    microseconds a step."""
    from xllm_service_tpu_torch.config import EngineConfig
    from xllm_service_tpu_torch.runtime import worker
    env = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
           "XLLM_CUDA_GRAPHS": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ecfg = EngineConfig(page_size=128, num_pages=512,
                            max_model_len=1024, max_batch_size=8,
                            max_prefill_tokens=256,
                            prefill_buckets=(128, 256, 512))
        w = worker.Worker(worker.WorkerOptions(model=FAULT_MODEL,
                                               device=FAULT_DEVICE,
                                               warmup=True),
                          engine_cfg=ecfg).start()
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    eng = w.engine
    steplog = StepLog(eng, kernels)
    rng = random.Random(9)
    prompts = {n: _token_ids(w.tokenizer, rng, n) for n in FAULT_SIZES}
    probes = [0]
    isolate = eng.isolate

    def counted_isolate(keep):
        probes[0] += 1
        return isolate(keep)
    eng.isolate = counted_isolate
    faults = []
    contain = w._contain_engine_fault

    def noted_contain(rt, exc, step_ms):
        probes[0] = 0
        salvaged = [o.request_id for o in eng.last_step_partial_outs]
        members = list(eng.step_members)
        ok = contain(rt, exc, step_ms)
        faults.append({"error": f"{type(exc).__name__}: {exc}",
                       "step_ms": step_ms, "members": members,
                       "salvaged_outputs": len(salvaged),
                       "probes": probes[0], "contained": ok})
        return ok
    w._contain_engine_fault = noted_contain
    arm = {"pending": False, "status": None}
    launch = eng.graphs.launch

    def arming_launch(key, want_top=False):
        out = launch(key, want_top)
        # The decode graph is replaying: arm the injected fault now, so
        # that the next section of this step, a prefill, trips it.
        if arm["pending"] and eng.waiting and eng._free_slot() >= 0:
            arm["pending"] = False
            armed = {}
            _request(w.name, "/admin/failpoint", {
                "name": "worker.fault_step", "mode": "count", "n": 1},
                False, armed)
            arm["status"] = armed["status"]
        return out
    eng.graphs.launch = arming_launch

    def body(rid, n, **kw):
        return {"prompt": w.tokenizer.decode(prompts[n]),
                "token_ids": prompts[n], "max_tokens": 32,
                "ignore_eos": True, "temperature": 0.0, "stream": True,
                "ledger_tokens": True, "service_request_id": rid, **kw}

    def start(reqs):
        results = [{} for _ in reqs]
        threads = [threading.Thread(target=_request,
                                    args=(w.name, CMPL, b, True, r))
                   for b, r in zip(reqs, results)]
        for t in threads:
            t.start()
        return threads, results

    def join(threads):
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a phase 9 request hung")

    def by_size(sizes, results):
        out = {}
        for n, r in zip(sizes, results):
            ids, times, error = _stream_tokens_and_times(r)
            out[n] = {"tokens": ids, "times": times, "error": error,
                      "status": r.get("status")}
        return out

    def wait_running(k):
        wait_for(lambda: len(eng.running) >= k and not eng.waiting, 300,
                 f"{k} running streams")

    def gaps(times):
        return [b - a for a, b in zip(times, times[1:])]

    def metric(name, **labels):
        for line in w.metrics_text().splitlines():
            if line.startswith(name + "{") and all(
                    f'{k}="{v}"' in line for k, v in labels.items()):
                return float(line.split()[-1])
        return 0.0

    def survivors(tag, got, ref, sizes):
        """Each survivor's 32 tokens against the fault-free round, and
        its longest gap against that round's median gap."""
        out, pairs_ref, pairs_got = [], {}, {}
        for n in sizes:
            g = got[n]
            if g["error"] is not None or g["status"] != 200 or \
                    len(g["tokens"]) != 32:
                raise AssertionError(f"{tag}: survivor {n}: {g['error']}, "
                                     f"{len(g['tokens'])} tokens")
            pairs_ref[n], pairs_got[n] = ref[n]["tokens"], g["tokens"]
            out.append({"prompt_tokens": n,
                        "equal": g["tokens"] == ref[n]["tokens"],
                        "extra_wait_ms": 1e3 * (
                            max(gaps(g["times"]), default=0.0)
                            - (_median(gaps(ref[n]["times"])) or 0.0))})
        path = {"ragged": False, "write_then_attend": True}
        margins = divergence_margins(
            torch, eng, [(tag, pairs_ref, path, pairs_got, path, prompts)],
            err)
        if any(m["verdict"] == "fault" for m in margins):
            raise AssertionError(f"{tag}: survivors diverge past the "
                                 f"margin rule: {margins}")
        return out, margins

    try:
        # The fault-free round, its launches checked per step.
        steplog.clear()
        kernels.reset_launch_counts()
        threads, results = start([body(f"ref{n}", n) for n in FAULT_SIZES])
        join(threads)
        torch.cuda.synchronize()
        need = check_step_launches(steplog.rows, kernels.launch_counts(),
                                   eng.cfg.num_layers, False, True, False)
        ref = by_size(FAULT_SIZES, results)

        # 9a. The seeded request.
        threads, results = start([body(f"a{n}", n) for n in FAULT_SIZES])
        wait_running(len(FAULT_SIZES))
        bad = {}
        bt = threading.Thread(target=_request, args=(
            w.name, CMPL, {"prompt": "seeded past int32", "max_tokens": 8,
                           "temperature": 1.0, "seed": 2 ** 31,
                           "service_request_id": "seed_fault"}, False, bad))
        bt.start()
        join(threads + [bt])
        got_a = by_size(FAULT_SIZES, results)
        if bad.get("status") != 500 or \
                bad["body"]["error"]["type"] != "engine_fault" or \
                "culprit" not in bad["body"]["error"]["message"]:
            raise AssertionError(f"9a: the seeded request got {bad}")
        surv_a, margins_a = survivors("9a", got_a, ref, FAULT_SIZES)
        culprits_a = metric("xllm_engine_faults_total", outcome="culprit")
        if len(faults) != 1 or culprits_a != 1 or not w._engine_loop_alive:
            raise AssertionError(f"9a: faults {faults}, culprit count "
                                 f"{culprits_a}")

        # 9b. The injected fault, armed while a decode graph replays.
        seven = FAULT_SIZES[:7]
        threads, results = start([body(f"b{n}", n) for n in seven])
        wait_running(7)
        arm["pending"] = True
        t8, r8 = start([body(f"b{FAULT_SIZES[7]}", FAULT_SIZES[7])])
        join(threads + t8)
        got_b = by_size(seven, results)
        eighth = by_size(FAULT_SIZES[7:], r8)[FAULT_SIZES[7]]
        if arm["status"] != 200 or eighth["error"] is None or \
                eighth["error"].get("type") != "engine_fault" or \
                "culprit" not in eighth["error"].get("message", ""):
            raise AssertionError(f"9b: armed {arm}, the eighth stream "
                                 f"{eighth['error']}")
        surv_b, margins_b = survivors("9b", got_b, ref, seven)
        culprits_b = metric("xllm_engine_faults_total", outcome="culprit")
        if len(faults) != 2 or culprits_b != 2 or \
                faults[1]["salvaged_outputs"] < 7 or \
                not w._engine_loop_alive or \
                w.failpoints.trips("worker.fault_step") != 1:
            raise AssertionError(f"9b: faults {faults}, culprit count "
                                 f"{culprits_b}")
        # 9b, second fault: armed while the eight decode with nothing
        # queued, it trips in a decode section of eight members, which
        # the worker bisects in probe steps (each re-prefills its half:
        # pow2 batches of the warmup ladder).
        threads, results = start([body(f"p{n}", n) for n in FAULT_SIZES])
        wait_running(len(FAULT_SIZES))
        armed = {}
        _request(w.name, "/admin/failpoint", {
            "name": "worker.fault_step", "mode": "count", "n": 1}, False,
            armed)
        join(threads)
        got_p = by_size(FAULT_SIZES, results)
        blamed = [n for n in FAULT_SIZES if got_p[n]["error"] is not None]
        if armed.get("status") != 200 or len(blamed) != 1 or \
                got_p[blamed[0]]["error"].get("type") != "engine_fault" or \
                "culprit" not in got_p[blamed[0]]["error"]["message"]:
            raise AssertionError(f"9b probes: armed {armed}, errors "
                                 f"{[got_p[n]['error'] for n in blamed]}")
        rest = tuple(n for n in FAULT_SIZES if n not in blamed)
        surv_p, margins_p = survivors("9b_probes", got_p, ref, rest)
        margins_b += margins_p
        culprits_p = metric("xllm_engine_faults_total", outcome="culprit")
        if len(faults) != 3 or culprits_p != 3 or faults[2]["probes"] < 1 \
                or len(faults[2]["members"]) != len(FAULT_SIZES) or \
                w.failpoints.trips("worker.fault_step") != 2:
            raise AssertionError(f"9b probes: faults {faults}, culprit "
                                 f"count {culprits_p}")
        capture = eng.capture_report()

        # 9c. The flight recorder.
        status, trace = _get(w.name, "/admin/steptrace?n=512")
        if status != 200:
            raise AssertionError(f"/admin/steptrace: {status}")
        per_kind = {}
        for kind in ("prefill", "decode", "mixed", "fault"):
            recs = [r for r in trace["steps"] if r["kind"] == kind]
            if not recs:
                continue
            bounds = {}
            for r in recs:
                bounds[r["bound"]] = bounds.get(r["bound"], 0) + 1
            per_kind[kind] = {
                "steps": len(recs),
                "step_ms_median": _median([r["step_ms"] for r in recs]),
                "mfu_median": _median([r["mfu"] for r in recs]),
                "debt_ms_median": _median([r["debt_ms"] for r in recs]),
                "bound": bounds}
        cfg = eng.cfg
        B = ecfg.max_batch_size
        non_embed = sum(t.numel() for k, t in eng.params.items()
                        if k not in ("embed", "lm_head")
                        and isinstance(t, torch.Tensor)) + sum(
            t.numel() for t in eng.params["layers"].values())
        norms = (2 * cfg.num_layers + 1) * cfg.hidden_size
        decode_check = {}
        for key, v in eng.roofline.get("decode", {}).items():
            mp = int(key[2:])
            gemm = 2 * B * (non_embed - norms
                            + cfg.hidden_size * cfg.vocab_size)
            attn = 2 * B * cfg.num_layers * mp * ecfg.page_size * 2 * \
                cfg.num_heads * cfg.head_dim
            decode_check[key] = {"flops": v["flops"], "gemm": gemm,
                                 "attention_share": attn}
            if not 0 <= v["flops"] - gemm <= attn:
                raise AssertionError(f"decode key {key}: {decode_check}")
        if not decode_check:
            raise AssertionError(f"no decode roofline key: {eng.roofline}")
        peaks = (trace["peak_flops"], trace["peak_bytes_s"])
        if "H100" in trace["device_kind"] and peaks != (989e12, 3.35e12):
            raise AssertionError(f"peaks {peaks} on {trace['device_kind']}")
        if not per_kind.get("fault") or per_kind["fault"]["steps"] != 3:
            raise AssertionError(f"fault records: {per_kind}")
        record = w._record_steptrace
        rec_s = [0.0, 0]

        def timed_record(rt, eng, kind, step_ms):
            t0 = time.perf_counter()
            record(rt, eng, kind, step_ms)
            rec_s[0] += time.perf_counter() - t0
            rec_s[1] += 1
        w._record_steptrace = timed_record
        medians = {"off": [], "on": []}
        for setting in ("off", "on", "off", "on"):
            w.steptrace.enabled = setting == "on"
            steplog.clear()
            threads, _ = start([body(f"{setting}{len(medians[setting])}"
                                     f"_{n}", n) for n in FAULT_SIZES])
            join(threads)
            medians[setting].append(_median(
                [r["ms"] for r in steplog.rows if r["kind"] == "decode"]))
        w.steptrace.enabled = True
        capture_end = eng.capture_report()
    finally:
        w.stop()
    late = [n for p in ("prefill", "ragged", "decode", "decode_multi")
            for n in capture_end[p]["late"]]
    out = {"card": card, "kernels_on_the_fault_free_round": need,
           "faults": faults, "seeded_culprit": bad["body"]["error"],
           "injected_culprit": eighth["error"],
           "survivors_9a": surv_a, "survivors_9b": surv_b,
           "survivors_9b_probes": surv_p,
           "margins": margins_a + margins_b,
           "eager_steps": capture_end["eager_steps"],
           "captures_after_warmup": capture_end["captures_after_warmup"],
           "late_captures": late,
           "captures_after_warmup_9ab": capture["captures_after_warmup"],
           "steptrace": {"device_kind": trace["device_kind"],
                         "peak_flops": peaks[0], "peak_bytes_s": peaks[1],
                         "per_kind": per_kind,
                         "roofline": trace["roofline"],
                         "decode_key_check": decode_check},
           "decode_step_ms_median_recorder": medians,
           "recorder_us_per_step": (1e6 * rec_s[0] / rec_s[1]
                                    if rec_s[1] else None)}
    log(f"[faults] {card}: 9a faulted step ms {faults[0]['step_ms']:.3f}, "
        f"probes {faults[0]['probes']}, salvaged "
        f"{faults[0]['salvaged_outputs']}, survivors' extra wait ms "
        f"{[round(s['extra_wait_ms'], 3) for s in surv_a]}; 9b faulted step "
        f"ms {faults[1]['step_ms']:.3f}, probes {faults[1]['probes']}, "
        f"salvaged {faults[1]['salvaged_outputs']}, survivors' extra wait "
        f"ms {[round(s['extra_wait_ms'], 3) for s in surv_b]}; 9b with "
        f"probes: faulted step ms {faults[2]['step_ms']:.3f}, probes "
        f"{faults[2]['probes']}, survivors' extra wait ms "
        f"{[round(s['extra_wait_ms'], 3) for s in surv_p]}")
    log(f"[steptrace] {card}: peaks {peaks[0]:.4g} FLOP/s, "
        f"{peaks[1]:.4g} B/s ({trace['device_kind']}); per kind "
        f"{json.dumps(per_kind)}; decode step ms median recorder off "
        f"{medians['off']} on {medians['on']}; recorder "
        f"{out['recorder_us_per_step']} us a step")
    log(f"[faults] {card}: {json.dumps(out)}")
    if capture_end["eager_steps"] or capture_end["captures_after_warmup"]:
        raise AssertionError(f"eager steps or late captures: "
                             f"{capture_end['eager_steps']}, {late}")
    return out


# ---------------------------------------------------------------------------
# Phase 10: PD disaggregation
# ---------------------------------------------------------------------------

PD_MODEL, PD_DEVICE = "llama3-1b", "cuda"
PD_ARGS = ["--page-size", "128", "--num-pages", "512", "--max-model-len",
           "1024", "--max-batch-size", "8", "--prefill-buckets",
           "128,256,512", "--max-prefill-tokens", "256",
           "--heartbeat-interval-s", "0.5"]
PD_ENV = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
          "XLLM_CUDA_GRAPHS": "1"}
# Sixteen streamed chats a round (two waves of eight), prompt lengths
# distinct from each other and from phase 5's four requests (380, 250,
# 120, 330), so that each request's tokens are known by its length.
PD_CHATS = ((390, 260, 130, 340, 210, 310, 160, 410),
            (370, 240, 110, 320, 190, 290, 140, 400))
# The chunked shuttle's chunk budget in MB: a llama3-1b page (128
# tokens) holds 256 KiB of K and V a layer, so a one-page prompt goes
# out in 3 chunks of up to 7 layers and a four-page one in 16 of one.
PD_CHUNK_MB = 2.0
# The wire check's block: a 400-token prompt's KV, 4 pages of 128.
PD_WIRE_PAGES = 4

WIRE_CHILD = r"""
import hashlib, json, sys, time
import torch
from xllm_service_tpu_torch.runtime import kv_wire
tr = json.loads(sys.argv[1])
t0 = time.perf_counter()
k, v = kv_wire.pull_block(tr)
first_ms = (time.perf_counter() - t0) * 1e3
ms = []
for _ in range(10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k, v = kv_wire.pull_block(tr)
    ms.append((time.perf_counter() - t0) * 1e3)
h = hashlib.sha256()
for t in (k, v):
    h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
print(json.dumps({"sha256": h.hexdigest(), "first_pull_ms": first_ms,
                  "pull_ms": sorted(ms)[len(ms) // 2]}))
"""


def _sha256(torch, *tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def wire_pull_check(torch, kv_wire, card: str) -> dict:
    """A block staged on this process's CUDA IPC wire, pulled by a child
    process (the check a process cannot make on its own handle): the
    pulled bytes must be bit-equal (sha256) to the staged ones. Beside
    it, on the card, the same bytes by a device ``copy_`` and by pinned
    device-to-host and host-to-device copies (CUDA events around ten
    back-to-back copies, the median of ten such timings)."""
    shape = (16, PD_WIRE_PAGES, 128, 8, 64)          # llama3-1b pages
    g = torch.Generator(device="cuda").manual_seed(10)
    k = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    wire = kv_wire.get_device_wire()
    if wire is None:
        raise AssertionError("phase 10: no CUDA IPC wire on the card")
    uuid = wire.stage(k, v)
    torch.cuda.synchronize()
    want = _sha256(torch, k, v)
    argv = [sys.executable, "-c", WIRE_CHILD, json.dumps(wire.ticket(uuid))]
    guard_child_argv(argv)
    try:
        child = subprocess.run(
            argv, cwd=ROOT, text=True,
            capture_output=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
    finally:
        wire.release(uuid)
    if child.returncode != 0:
        raise AssertionError(f"phase 10: the wire's child failed: "
                             f"{child.stderr[-2000:]}")
    got = json.loads(child.stdout.strip().splitlines()[-1])
    if got["sha256"] != want:
        raise AssertionError("phase 10: the pulled block differs from "
                             "the staged one")
    nbytes = 2 * k.numel() * k.element_size()

    def events_ms(fn) -> float:
        """Median of 10 timings of 10 back-to-back calls, a call's ms."""
        fn()
        ms = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(10):
                fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b) / 10)
        return sorted(ms)[5]

    dst = torch.empty_like(k)
    host = torch.empty(k.shape, dtype=k.dtype, pin_memory=True)
    copy_ms = 2 * events_ms(lambda: dst.copy_(k))
    d2h_ms = 2 * events_ms(lambda: host.copy_(k, non_blocking=True))
    h2d_ms = 2 * events_ms(lambda: dst.copy_(host, non_blocking=True))
    out = {"bytes": nbytes, "bit_equal": True,
           "wire_pull_ms": got["pull_ms"],
           "wire_first_pull_ms": got["first_pull_ms"],
           "wire_gbps": nbytes / got["pull_ms"] / 1e6,
           "device_copy_gbps": nbytes / copy_ms / 1e6,
           "pinned_d2h_gbps": nbytes / d2h_ms / 1e6,
           "pinned_h2d_gbps": nbytes / h2d_ms / 1e6}
    log(f"[pd] {card}: wire pull of {nbytes} B (a 400-token prompt's KV) "
        f"by another process, bit-equal; pull ms {got['pull_ms']:.4f} "
        f"({out['wire_gbps']:.2f} GB/s; the first, mapping the segment, "
        f"{got['first_pull_ms']:.2f} ms); yardsticks on the same bytes: "
        f"device copy_ {out['device_copy_gbps']:.1f} GB/s, pinned D2H "
        f"{out['pinned_d2h_gbps']:.1f} GB/s, pinned H2D "
        f"{out['pinned_h2d_gbps']:.1f} GB/s")
    return out


def _metric_rows(addr: str) -> dict:
    """A worker's /metrics as {(name, frozenset of label pairs): value}."""
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    rows = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        name, labels = head, frozenset()
        if "{" in head:
            name, rest = head.split("{", 1)
            labels = frozenset(
                tuple(p.split("=", 1)) for p in rest.rstrip("}").split(",")
                if p)
            labels = frozenset((a, b.strip('"')) for a, b in labels)
        rows[(name, labels)] = float(value)
    return rows


def _metric(rows: dict, name: str, **labels) -> float:
    want = set(labels.items())
    return sum(v for (n, ls), v in rows.items()
               if n == name and want <= set(ls))


def _pd_stream_stats(r) -> tuple:
    """A streamed chat's TTFT (ms) and decode tokens/s (31 gaps, from the
    first content frame to the finish frame); its usage must count 32
    tokens."""
    if r.get("status") != 200:
        raise AssertionError(f"phase 10: reply {r.get('status')}: {r}")
    frames = r["frames"]
    if not frames or frames[-1] != "data: [DONE]":
        raise AssertionError(f"phase 10: stream ended {frames[-2:]}")
    first = last = None
    usage = None
    for i, f in enumerate(frames[:-1]):
        o = json.loads(f[len("data: "):])
        usage = o.get("usage") or usage
        for c in o.get("choices") or []:
            if first is None and "content" in c.get("delta", {}):
                first = i
            if c.get("finish_reason"):
                last = i
    if not usage or usage["completion_tokens"] != 32 or first is None \
            or last is None:
        raise AssertionError(f"phase 10: stream usage {usage}")
    t0, t1 = r["times"][first], r["times"][last]
    return t0 * 1e3, 31 / max(t1 - t0, 1e-9)


class _RelayTee:
    """The token ids of every RequestOutput frame the prefill worker
    relays from its decode worker, by request id (a wrapper of the
    worker module's ``iter_sse_events``)."""

    def __init__(self, worker_mod) -> None:
        self.tokens, inner = {}, worker_mod.iter_sse_events

        def tee(chunks):
            for payload in inner(chunks):
                if payload != "[DONE]":
                    o = json.loads(payload)
                    for s in o.get("outputs") or []:
                        self.tokens.setdefault(o["request_id"], []).extend(
                            s.get("token_ids") or [])
                yield payload
        worker_mod.iter_sse_events = tee
        self._undo = lambda: setattr(worker_mod, "iter_sse_events", inner)

    def close(self) -> None:
        self._undo()


def pd_phase(torch, kernels, card: str, err: float) -> dict:
    """Phase 10: PD disaggregation behind the port's master. The store
    and master run as child processes (as in phase 6); the PREFILL
    worker P (llama3-1b at phase 5's flags, random weights from the
    engine's seed) runs in-process. Its first round, sent straight to
    it while it is registered DEFAULT, is the reference: phase 5's four
    requests and 16 streamed chats (``PD_CHATS``), 32 greedy tokens
    each. Then ``POST /flip_role`` makes it PREFILL (the master's books
    follow) and the same round runs through the master once per
    transport:

    - direct: a DECODE worker D1 in this process, twice: first with the
      steps of P and D1 serialized, so that each step's launch counts
      are its own (``direct_serialized``), then stepping freely, which
      gives the direct path's migration time (the serialized round's
      holds waits for the other engine's step) and the export's and
      the import's own times; ``probe_kv_migration`` at 16 pages
      between their engines;
    - after D1 leaves, a DECODE worker D2 as a child process
      (``python -m xllm_service_tpu_torch.runtime.worker --instance-type
      DECODE``) with the same seed: its weights sha256-equal to P's
      leaf by leaf (``GET /admin/weights``), and one greedy stream
      straight to D2 equal to the reference or drift under the margins
      rule (D2 decodes it alone, the reference round in a batch); then
      the CUDA IPC device wire,
      the chunked host shuttle (``PD_CHUNK_MB``) and the monolithic one.

    Checks, each round: every stream 32 tokens, equal to the reference
    or diverging as drift under the margins rule; the transport's
    counter moved once a request and no other, and P never decoded
    locally (a silent fallback fails); P's steps (and D1's) launch the
    kernels they must (K2/K4 each prefill replay, K1/K3 each decode
    replay), and D2's /metrics count K1 and K3 16 times a decode step
    and no prefill kernel; no step eager, no capture after warmup, on
    every worker; no held pages, P's and D1's free pages back to their
    start and D2's KV usage 0. Then one request with
    ``worker.fail_kv_transfer`` armed decodes on P; one RPC round (the
    master replaced by one in the RPC topology, which both workers
    follow) over the wire; and the roles flipped (P to DECODE, D2 to
    PREFILL) serve one more request over the wire the other way. The
    wire's block is checked bit-equal by a child process's pull
    (``wire_pull_check``), beside the card's copy yardsticks. Printed:
    KV bytes per request, migration ms and GB/s per transport, TTFT and
    tokens/s per stream under PD against the reference."""
    from xllm_service_tpu_torch.runtime import (checkpoint, kv_transfer,
                                                kv_wire, worker)
    logs = ROOT / "build" / "pd_logs"
    logs.mkdir(parents=True, exist_ok=True)
    procs, live_workers, out = [], [], {}
    tee = None

    def argv(role, store_addr, rpc):
        return ["--model", PD_MODEL, "--device", PD_DEVICE, *PD_ARGS,
                "--instance-type", role, "--store-addr", store_addr,
                "--service-addr", rpc]

    try:
        store = RefProcess(["xllm_service_tpu_torch.service.coordination_net",
                            "--port", "0"],
                           "coordination store serving on",
                           logs / "store.log")
        procs.append(store)
        store_addr = store.line.split()[-1]
        master, m_http, m_rpc = start_master(store_addr, False,
                                             logs / "master_relay.log")
        procs.append(master)
        p, p_s = _start(worker, argv("DEFAULT", store_addr, m_rpc), PD_ENV)
        live_workers.append(p)
        eng = p.engine
        layers = eng.cfg.num_layers
        start_free = eng.allocator.num_free + eng.prefix_cache.num_reclaimable
        wait_for(lambda: p.name in listed(m_rpc), 60.0,
                 "P on the master's list")
        rng = random.Random(10)
        plan_ids = [_token_ids(p.tokenizer, rng, n)
                    for _, _, n in SERVE_PLAN]
        chat_ids = [[_token_ids(p.tokenizer, rng, n) for n in wave]
                    for wave in PD_CHATS]
        prompts = {len(ids): ids for ids in plan_ids}
        prompts.update({len(ids): ids for w in chat_ids for ids in w})
        assert len(prompts) == 4 + 16, "prompt lengths must be distinct"
        steplog_p = StepLog(eng, kernels)
        # Each engine request's prompt length, by request id.
        srid_len = {}
        p_add = eng.add_request

        def noted_add(req):
            srid_len[req.request_id] = len(req.token_ids)
            return p_add(req)
        eng.add_request = noted_add
        imports_p = [0]
        p_import = eng.import_sequence

        def counted_import(*a, **k):
            imports_p[0] += 1
            return p_import(*a, **k)
        eng.import_sequence = counted_import

        def plan_bodies():
            bodies = []
            for (path, stream, n), ids in zip(SERVE_PLAN, plan_ids):
                body = {"model": PD_MODEL, "max_tokens": 32,
                        "temperature": 0.0, "ignore_eos": True,
                        "stream": stream, "token_ids": list(ids)}
                if path.endswith("chat/completions"):
                    body["messages"] = [{"role": "user", "content": "x"}]
                else:
                    body["prompt"] = "x"
                if stream:
                    body["stream_options"] = {"include_usage": True}
                    body["logprobs"] = True
                bodies.append(body)
            return bodies

        def run_round(addr) -> dict:
            """Phase 5's four requests at once, then the chats in two
            waves of eight; returns the chats' (TTFT, tokens/s)."""
            results, _ = run_concurrent(addr, plan_bodies())
            for (path, stream, n), r in zip(SERVE_PLAN, results):
                if stream:
                    _pd_stream_stats(r)
                elif r.get("status") != 200 or \
                        r["body"]["usage"]["completion_tokens"] != 32:
                    raise AssertionError(f"phase 10: {path}: {r}")
            stats = []
            for wave in chat_ids:
                for r in _concurrent(addr, [_chat_body(ids)
                                            for ids in wave]):
                    stats.append(_pd_stream_stats(r))
            return chat_summary(stats)

        def counters():
            return (p.kv_migration_direct, p.kv_migration_device_wire,
                    p.kv_migration_chunked, p.kv_migration_bytes,
                    p.kv_migration_seconds)

        def census_clean(w, tag):
            rep = w.engine.capture_report()
            if rep["captures_after_warmup"] or rep["eager_steps"]:
                raise AssertionError(f"phase 10 {tag}: captures after "
                                     f"warmup {rep['captures_after_warmup']},"
                                     f" eager steps {rep['eager_steps']}")

        def pages_back(w, start, tag):
            e = w.engine
            ok = wait_for(lambda: not e.has_work(), 60.0, f"{tag} idle")
            free = e.allocator.num_free + e.prefix_cache.num_reclaimable
            if not ok or e.num_held or free != start:
                raise AssertionError(f"phase 10 {tag}: held {e.num_held}, "
                                     f"free pages {free} of {start}")

        # The reference: P serves the round itself, as a DEFAULT worker.
        steplog_p.clear()
        kernels.reset_launch_counts()
        out["reference"] = run_round(p.name)
        torch.cuda.synchronize()
        check_step_launches(steplog_p.rows, kernels.launch_counts(), layers,
                            False, True, False)
        ref = {n: list(t) for n, t in steplog_p.tokens.items()}
        if sorted(ref) != sorted(prompts) or \
                any(len(t) != 32 for t in ref.values()):
            raise AssertionError("phase 10: the reference round")
        # The role flip, followed by the master.
        status = {}
        _request(p.name, "/flip_role", {"instance_type": "PREFILL"},
                 False, status)
        if status.get("status") != 200:
            raise AssertionError(f"phase 10: /flip_role {status}")
        wait_for(lambda: (_get(m_rpc, f"/rpc/instance_info?name={p.name}")
                          [1] or {}).get("instance_type") == "PREFILL",
                 30.0, "the master's books on P's new role")

        margins = []

        def check_streams(tag, got, where, keys=None):
            """``got`` (tokens by prompt length, every key of ``keys``,
            default all) equal to the reference, or drift; returns the
            count of equal streams."""
            keys = sorted(ref if keys is None else keys)
            if sorted(got) != keys or \
                    any(len(t) != 32 for t in got.values()):
                raise AssertionError(
                    f"phase 10 {tag}: streams "
                    f"{ {n: len(t) for n, t in got.items()} }")
            path = {"ragged": False, "write_then_attend": True}
            m = divergence_margins(torch, where.engine,
                                   [(f"pd_{tag}", {n: ref[n] for n in keys},
                                     path, got, path, prompts)], err)
            if any(x["verdict"] == "fault" for x in m):
                raise AssertionError(f"phase 10 {tag}: divergence past "
                                     f"the margin rule: {m}")
            margins.extend(m)
            return sum(got[n] == ref[n] for n in keys)

        def transport_round(tag, idx, decode_logs, launches=True) -> dict:
            """One round through the master: the transport ``idx`` of
            ``counters()`` (None: the monolithic shuttle, which has no
            counter of its own) moves once a request and no other does;
            P never decodes locally. ``launches``: each step's kernel
            launches are checked (steps of two engines in this process
            must then be serialized)."""
            before = counters()
            steplog_p.clear()
            srid_len.clear()
            if tee is not None:
                tee.tokens.clear()
            for s in decode_logs:
                s.clear()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            chats = run_round(m_http)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            if launches:
                rows = steplog_p.rows + [r for s in decode_logs
                                         for r in s.rows]
                check_step_launches(rows, kernels.launch_counts(), layers,
                                    False, True, False)
            after = counters()
            moved = [after[i] - before[i] for i in range(3)]
            want = [0, 0, 0]
            if idx is not None:
                want[idx] = 20
            nbytes, secs = after[3] - before[3], after[4] - before[4]
            if moved != want or imports_p[0] or nbytes <= 0:
                raise AssertionError(f"phase 10 {tag}: transports moved "
                                     f"{moved}, want {want}; local "
                                     f"decodes on P {imports_p[0]}; "
                                     f"{nbytes} B")
            return {"chats": chats, "round_s": wall,
                    "kv_bytes_per_request": nbytes / 20,
                    "migration_ms_per_request": 1e3 * secs / 20,
                    "migration_gbps": nbytes / secs / 1e9}

        # Direct: D1 in this process.
        d1, d1_s = _start(worker, argv("DECODE", store_addr, m_rpc), PD_ENV)
        live_workers.append(d1)
        out["worker_start_s"] = {"prefill": p_s, "decode_direct": d1_s}
        d1_free = d1.engine.allocator.num_free + \
            d1.engine.prefix_cache.num_reclaimable
        wait_for(lambda: _get(m_rpc, "/rpc/static_decode_list")[1].get(
            "instances") == [d1.name], 60.0, "D1 on the decode list")
        steplog_d1 = StepLog(d1.engine, kernels)
        p_step, d1_step = eng.step, d1.engine.step
        d1_import = d1.engine.import_sequence
        serial = threading.Lock()
        for e in (eng, d1.engine):
            inner = e.step

            def step(inner=inner):
                with serial:
                    return inner()
            e.step = step
        out["direct_serialized"] = transport_round("direct", 0,
                                                   [steplog_d1])
        got = {n: steplog_p.tokens.get(n, []) + steplog_d1.tokens.get(n, [])
               for n in ref}
        out["direct_serialized"]["equal_streams"] = check_streams(
            "direct", got, p)
        # The same round with the engines stepping freely: its migration
        # time holds no wait for the other engine's step (the serialized
        # round's does, up to two steps a request). The export and the
        # import are also timed alone, each until the device is done.
        eng.step, d1.engine.step = p_step, d1_step
        handoff = {"export": 0.0, "import": 0.0}

        def timed(fn, key):
            def call(*a, **k):
                t0 = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                handoff[key] += time.perf_counter() - t0
                return r
            return call
        p_export = eng.export_held
        eng.export_held = timed(p_export, "export")
        d1.engine.import_sequence = timed(d1_import, "import")
        try:
            out["direct"] = transport_round("direct", 0, [steplog_d1],
                                            launches=False)
        finally:
            eng.export_held = p_export
            d1.engine.import_sequence = d1_import
        got = {n: steplog_p.tokens.get(n, []) + steplog_d1.tokens.get(n, [])
               for n in ref}
        out["direct"]["equal_streams"] = check_streams("direct", got, p)
        out["direct"]["export_ms_per_request"] = 1e3 * handoff["export"] / 20
        out["direct"]["import_ms_per_request"] = 1e3 * handoff["import"] / 20
        census_clean(d1, "D1")
        pages_back(d1, d1_free, "D1")
        out["probe_kv_migration"] = kv_transfer.probe_kv_migration(
            eng, d1.engine, n_pages=16, iters=5)
        d1.stop()
        live_workers.remove(d1)
        del d1, steplog_d1
        free_device_memory(torch)

        # D2: a DECODE worker in a child process, the same seed.
        d2 = RefProcess(["xllm_service_tpu_torch.runtime.worker",
                         *argv("DECODE", store_addr, m_rpc)],
                        "XLLM_TORCH_WORKER_UP", logs / "decode_child.log",
                        timeout=300.0, env=PD_ENV)
        procs.append(d2)
        d2_addr = d2.line.split("http=")[-1]
        wait_for(lambda: _get(m_rpc, "/rpc/static_decode_list")[1].get(
            "instances") == [d2_addr], 60.0, "D2 on the decode list")
        one = {}
        n0 = len(chat_ids[0][2])
        _request(d2_addr, CHAT, {**_chat_body(chat_ids[0][2]),
                                 "ledger_tokens": True}, True, one)
        d2_tokens = [t for f in one["frames"][:-1]
                     for t in (json.loads(f[6:]).get("xllm") or {})
                     .get("token_ids", [])]
        status, body = _get(d2_addr, "/admin/weights")
        p_digests = checkpoint.param_digests(p.engine.params)
        if status != 200 or body["digests"] != p_digests:
            raise AssertionError(
                "phase 10: D2's weights differ from P's: " + str(sorted(
                    k for k in p_digests
                    if (body or {}).get("digests", {}).get(k)
                    != p_digests[k])))
        out["d2_leaves_equal"] = len(p_digests)
        out["d2_alone_equal_streams"] = check_streams(
            "d2_alone", {n0: d2_tokens}, p, keys=[n0])
        tee = _RelayTee(worker)
        for tag, idx, wire_on, chunk_mb in (
                ("device_wire", 1, True, 0.0),
                ("chunked", 2, False, PD_CHUNK_MB),
                ("monolithic", None, False, 0.0)):
            p.opts.pd_device_wire = wire_on
            p._kv_shuttle_chunk_mb = chunk_mb
            m0 = _metric_rows(d2_addr)
            res = transport_round(tag, idx, [])
            m1 = _metric_rows(d2_addr)
            # The relay's frames by request, the first of them the
            # migrated first token.
            got = {srid_len[rid]: toks for rid, toks in tee.tokens.items()}
            res["equal_streams"] = check_streams(tag, got, p)
            dsteps = _metric(m1, "xllm_worker_steps_total", phase="decode") \
                - _metric(m0, "xllm_worker_steps_total", phase="decode")
            other = sum(_metric(m1, "xllm_worker_steps_total", phase=ph)
                        - _metric(m0, "xllm_worker_steps_total", phase=ph)
                        for ph in ("prefill", "mixed"))
            launches = {k: _metric(m1, "xllm_worker_kernel_launches",
                                   kernel=k)
                        - _metric(m0, "xllm_worker_kernel_launches", kernel=k)
                        for k in ("rope_kv_update_layer",
                                  "paged_decode_attention",
                                  "rope_prefill_kv_update_layer",
                                  "paged_prefill_attention")}
            if other or dsteps <= 0 or \
                    launches["rope_kv_update_layer"] != layers * dsteps or \
                    launches["paged_decode_attention"] != layers * dsteps or \
                    launches["rope_prefill_kv_update_layer"] or \
                    launches["paged_prefill_attention"]:
                raise AssertionError(f"phase 10 {tag}: D2 ran {dsteps} "
                                     f"decode and {other} other steps, "
                                     f"launches {launches}")
            res["decode_worker_steps"] = dsteps
            out[tag] = res
        for name in ("xllm_worker_eager_steps_total",
                     "xllm_worker_recompiles_total"):
            if _metric(m1, name):
                raise AssertionError(f"phase 10: D2 {name} "
                                     f"{_metric(m1, name)}")
        if _metric(m1, "xllm_worker_kv_cache_usage") != 0.0:
            raise AssertionError("phase 10: D2 holds KV after the rounds")

        # One armed worker.fail_kv_transfer: P decodes locally.
        armed = {}
        _request(p.name, "/admin/failpoint",
                 {"name": "worker.fail_kv_transfer", "mode": "count",
                  "n": 1}, False, armed)
        steplog_p.clear()
        failed = {}
        n1 = len(plan_ids[2])
        _request(m_http, CHAT, _chat_body(plan_ids[2]), True, failed)
        _pd_stream_stats(failed)
        if imports_p[0] != 1:
            raise AssertionError(f"phase 10: fail_kv_transfer: local "
                                 f"decodes {imports_p[0]}")
        check_streams("fail_kv_transfer", {n1: steplog_p.tokens.get(n1)},
                      p, [n1])
        imports_p[0] = 0
        out["fail_kv_transfer_local_decode"] = True

        # The RPC topology: the relay master replaced; both workers
        # follow the store's advertised address.
        master.stop()
        procs.remove(master)
        rpc_master, r_http, r_rpc = start_master(store_addr, True,
                                                 logs / "master_rpc.log")
        procs.append(rpc_master)
        wait_for(lambda: p.service_addr == r_rpc and p._decode_to_service,
                 60.0, "P following the RPC master")
        wait_for(lambda: _get(r_rpc, "/rpc/static_decode_list")[1].get(
            "instances") == [d2_addr] and p.name in listed(r_rpc), 60.0,
            "both workers on the RPC master")
        time.sleep(2.0)          # D2's beats fetch the new topology
        p.opts.pd_device_wire = True
        before = counters()
        results, rpc_wall = run_concurrent(r_http, plan_bodies())
        for (path, stream, n), r in zip(SERVE_PLAN, results):
            if stream:
                _pd_stream_stats(r)
            elif r.get("status") != 200 or \
                    r["body"]["usage"]["completion_tokens"] != 32:
                raise AssertionError(f"phase 10 rpc: {path}: {r}")
        if counters()[1] - before[1] != 4 or imports_p[0]:
            raise AssertionError("phase 10 rpc: not over the wire")
        out["rpc_round_s"] = rpc_wall

        # The roles flipped: D2 prefills, P decodes, over the wire.
        for addr, role in ((p.name, "DECODE"), (d2_addr, "PREFILL")):
            st = {}
            _request(addr, "/flip_role", {"instance_type": role}, False, st)
            if st.get("status") != 200:
                raise AssertionError(f"phase 10: flip {addr}: {st}")
        wait_for(lambda: _get(r_rpc, "/rpc/static_decode_list")[1].get(
            "instances") == [p.name] and _get(
            r_rpc, "/rpc/static_prefill_list")[1].get("instances")
            == [d2_addr], 60.0, "the master's lists after the flips")
        firsts = []
        adopt = p.adopt_migrated

        def noted_adopt(meta, k, v):
            firsts.append(int(meta["tokens"][-1]))
            return adopt(meta, k, v)
        p.adopt_migrated = noted_adopt
        pulls = [0]
        pull = kv_wire.pull_block

        def counted_pull(tr):
            pulls[0] += 1
            return pull(tr)
        kv_wire.pull_block = counted_pull
        try:
            steplog_p.clear()
            flipped = {}
            _request(r_http, CHAT, _chat_body(chat_ids[1][0]), True,
                     flipped)
            _pd_stream_stats(flipped)
        finally:
            kv_wire.pull_block = pull
        n2 = len(chat_ids[1][0])
        if pulls[0] != 1 or len(firsts) != 1:
            raise AssertionError(f"phase 10: flipped roles: pulls "
                                 f"{pulls[0]}, adoptions {len(firsts)}")
        check_streams("flipped", {n2: firsts + steplog_p.tokens.get(n2, [])},
                      p, [n2])
        out["flip_role_followed"] = True
        census_clean(p, "P")
        pages_back(p, start_free, "P")
        out["wire_check"] = wire_pull_check(torch, kv_wire, card)
    finally:
        if tee is not None:
            tee.close()
        for w in live_workers:
            try:
                w.stop()
            except Exception as e:  # noqa: BLE001 — teardown goes on
                log(f"phase 10: stopping a worker: {e}")
        for proc in procs:
            proc.stop()
    out["margins"] = margins
    rounds = ("direct_serialized", "direct", "device_wire", "chunked",
              "monolithic")
    out["equal_token_streams"] = {t: out[t]["equal_streams"]
                                  for t in rounds}
    ref_c = out["reference"]
    rows = []
    for t in rounds:
        r = out[t]
        rows.append(f"{t}: {r['kv_bytes_per_request']:.0f} B/request, "
                    f"{r['migration_ms_per_request']:.3f} ms, "
                    f"{r['migration_gbps']:.3f} GB/s, TTFT ms median "
                    f"{r['chats']['ttft_ms_median']:.1f}, tokens/s median "
                    f"{r['chats']['decode_tokens_per_s_median']:.1f}")
    pr, dr = out["probe_kv_migration"], out["direct"]
    rows.append(f"direct's export {dr['export_ms_per_request']:.3f} ms and "
                f"import {dr['import_ms_per_request']:.3f} ms a request "
                f"(each until the device is done)")
    log(f"[pd] {card}: reference (DEFAULT) TTFT ms median "
        f"{ref_c['ttft_ms_median']:.1f}, tokens/s median "
        f"{ref_c['decode_tokens_per_s_median']:.1f}; " + "; ".join(rows))
    log(f"[pd] {card}: probe_kv_migration at {pr['pages']:.0f} pages "
        f"({pr['bytes']:.0f} B): direct {pr['direct_gbps']:.2f}, host "
        f"{pr['host_gbps']:.2f}, host pipelined "
        f"{pr['host_pipelined_gbps']:.2f} GB/s; equal streams "
        f"{out['equal_token_streams']} of 20; margins {json.dumps(margins)}")
    log(f"[pd] detail {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the cross-worker block fetch
# ---------------------------------------------------------------------------

FETCH_MODEL, FETCH_DEVICE = "llama3-1b", "cuda"
# Phase 7's flags: room for the 1,024-token prompt, a tail and 32 tokens.
FETCH_ARGS = ["--page-size", "128", "--num-pages", "512", "--max-model-len",
              "2048", "--max-batch-size", "8", "--prefill-buckets",
              "128,256,512", "--max-prefill-tokens", "256",
              "--heartbeat-interval-s", "0.5"]
FETCH_ENV = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
             "XLLM_CUDA_GRAPHS": "1"}
# The master prices a fetch far below a recompute, so that every planned
# run is a fetch (a holder that migrated no PD request beats kv_gbps 0.0,
# so the master's XLLM_KV_FETCH_GBPS applies).
FETCH_MASTER_ENV = {"XLLM_KV_FETCH_GBPS": "1000",
                    "XLLM_KV_FETCH_OVERHEAD_MS": "0"}
# The planner's defaults (the master's XLLM_KV_FETCH_GBPS and
# XLLM_KV_FETCH_OVERHEAD_MS), for the verdict it gives unprompted.
FETCH_DEFAULT_GBPS, FETCH_DEFAULT_OVERHEAD_MS = 1.0, 5.0
# The holder's cold request's tail, then the 8 chats' tails: every
# prompt of a round has its own length.
FETCH_TAILS = (20, 40, 70, 100, 130, 160, 190, 220, 250)
# (tag, the requester offers the CUDA IPC wire, worker.fail_kv_fetch
# armed on the requester). The first wire round maps the holder's new
# staging segments in the requester's process; the second reuses them.
FETCH_ROUNDS = (("wire_first", True, False), ("wire", True, False),
                ("bytes", False, False), ("recompute", False, True))


def _fetch_counters(w) -> dict:
    return {k: getattr(w, k) for k in (
        "kv_fetch_attempts", "kv_fetch_failures", "kv_fetch_bytes",
        "kv_fetch_seconds", "kv_fetch_adopt_seconds",
        "kv_fetch_device_wire")}


def _default_verdict(terms: dict) -> dict:
    """The reference planner's verdict for the audited plan's blocks at
    its default price (``FETCH_DEFAULT_*``), from the audit's own terms:
    a block is fetched while its transfer costs less than recomputing
    it, and the fetch wins when those blocks' transfer plus the
    overhead costs less than recomputing them."""
    blocks = terms["holder_blocks"] - terms["local_blocks"]
    recompute_blk = terms["block_size"] / terms["prefill_tok_s"] * 1e3
    fetch_blk = terms["block_bytes"] / (FETCH_DEFAULT_GBPS * 1e9) * 1e3
    n = blocks if fetch_blk < recompute_blk else 0
    fetch_ms = n * fetch_blk + FETCH_DEFAULT_OVERHEAD_MS
    return {"blocks": blocks, "fetch_ms_per_block": fetch_blk,
            "recompute_ms_per_block": recompute_blk,
            "fetch_ms": blocks * fetch_blk + FETCH_DEFAULT_OVERHEAD_MS,
            "recompute_ms": blocks * recompute_blk,
            "verdict": "fetch" if n and fetch_ms < n * recompute_blk
            else "recompute"}


def fetch_phase(torch, kernels, card: str, err: float) -> dict:
    """Phase 11: the cross-worker block fetch behind the port's master
    (round robin, block size 128, a fetch priced to win:
    ``FETCH_MASTER_ENV``). The store and the master run as children (as
    in phase 10); so does the holder A (llama3-1b, phase 5's flags and
    order, graphs on, random weights from the engine's seed), and the
    requester B runs in this process with the same weights and
    ``--enable-profiling``, so that its token streams and kernel launches
    are read step by step (a stream the master relays carries no token
    ids). Each round (``FETCH_ROUNDS``) takes a new 1,024-token shared
    prompt: A serves it with a tail straight (cold); once a beat of A's
    after it reached the master, 8 chats share it with other tails (32
    greedy tokens each) through the master at once, so that the four
    routed to B are planned as fetches from A. Rounds: over the CUDA IPC
    wire (twice: the first maps A's staging segments in this process),
    over the bytes (B offers no wire), and with ``worker.fail_kv_fetch``
    armed on B (the recompute yardstick).

    Checks: every planned fetch adopted outside the armed round (no
    failure, 8 blocks and their bytes a fetch, the wire's fetches over
    the wire); the master's ``fetch`` verdicts moved; in the armed round
    every attempt a failure; B's streams equal A's own (the same prompts
    sent straight to A) or drift under the margins rule; each of B's
    steps launches its kernels (K2/K4 a prefill replay, K1/K3 a decode
    replay); no eager step and no capture after warmup on A or B; no
    ticket left staged and no segment leaked on A; B's free pages back
    to their start and A's KV usage 0. Printed: KV bytes a fetch; its ms
    on B's clock, split into A's export, the transfer and B's adoption,
    and GB/s, per transport; TTFT of the fetched requests against the
    recompute round and against A's local hits; the planner's audit
    terms and its verdict at its defaults beside what the card measured;
    B's profiling samples as the master holds them."""
    from xllm_service_tpu_torch.runtime import kv_wire, worker
    logs = ROOT / "build" / "fetch_logs"
    logs.mkdir(parents=True, exist_ok=True)
    procs, ws, out = [], [], {"rounds": {}}
    t_phase = time.perf_counter()
    try:
        store = RefProcess(["xllm_service_tpu_torch.service.coordination_net",
                            "--port", "0"], "coordination store serving on",
                           logs / "store.log")
        procs.append(store)
        store_addr = store.line.split()[-1]
        master, m_http, m_rpc = start_master(store_addr, False,
                                             logs / "master.log",
                                             env=FETCH_MASTER_ENV)
        procs.append(master)
        argv = ["--model", FETCH_MODEL, "--device", FETCH_DEVICE,
                *FETCH_ARGS, "--instance-type", "DEFAULT", "--store-addr",
                store_addr, "--service-addr", m_rpc]
        # A starts in its child while B builds here.
        started = {}

        def start_holder() -> None:
            try:
                started["a"] = RefProcess(
                    ["xllm_service_tpu_torch.runtime.worker", *argv],
                    "XLLM_TORCH_WORKER_UP", logs / "holder_child.log",
                    timeout=300.0, env=FETCH_ENV)
            except Exception as e:  # noqa: BLE001 — raised below
                started["error"] = e
        th = threading.Thread(target=start_holder)
        th.start()
        try:
            b, out["requester_start_s"] = _start(
                worker, argv + ["--enable-profiling"], FETCH_ENV)
            ws.append(b)
        finally:
            th.join(timeout=330.0)
        if "a" not in started:
            raise AssertionError(f"phase 11: the holder did not start: "
                                 f"{started.get('error')}")
        procs.append(started["a"])
        a_addr = started["a"].line.split("http=")[-1]
        wait_for(lambda: {a_addr, b.name} <= set(listed(m_rpc)), 60.0,
                 "A and B on the master's list")
        eng = b.engine
        layers = eng.cfg.num_layers
        block_bytes = eng.kv_block_bytes()
        start_free = eng.allocator.num_free + eng.prefix_cache.num_reclaimable
        steplog = StepLog(eng, kernels)
        on_b = set()
        add = eng.add_request

        def noted_add(req):
            on_b.add(req.request_id)
            return add(req)
        eng.add_request = noted_add
        rng = random.Random(110)
        tok = b.tokenizer
        path = {"ragged": False, "write_then_attend": True}
        # TTFT ms: B's chats by round (fetched, or recomputed in the
        # armed round), and A's (local hits) over every round.
        margins, ttft = [], {"local": []}
        audits = {}

        def body(ids, **extra):
            return {**_chat_body(ids), "model": FETCH_MODEL, **extra}

        for tag, offer, armed in FETCH_ROUNDS:
            system = _token_ids(tok, rng, SYSTEM_TOKENS)
            prompts = [system + _token_ids(tok, rng, n) for n in FETCH_TAILS]
            cold = {}
            _request(a_addr, CHAT, body(prompts[0]), True, cold)
            t_done = time.monotonic()
            wait_for(lambda: (lambda row: row is not None and
                              time.monotonic() - row["heartbeat_age_s"]
                              > t_done + 0.1)(master_row(m_http, a_addr)),
                     10.0, "a beat of A's after its cold request")
            b.opts.pd_device_wire = offer
            if armed:
                b.failpoints.arm("worker.fail_kv_fetch", mode="always")
            c0, a0 = _fetch_counters(b), _metric_rows(a_addr)
            v0 = _metric(_metric_rows(m_http),
                         "xllm_kv_fetch_decisions_total", verdict="fetch")
            steplog.clear()
            on_b.clear()
            kernels.reset_launch_counts()
            rids = [f"phase11-{tag}-{i}" for i in range(len(prompts) - 1)]
            t0 = time.perf_counter()
            try:
                res = _concurrent(m_http, [body(p) for p in prompts[1:]],
                                  [{"x-request-id": r} for r in rids])
            finally:
                if armed:
                    b.failpoints.arm("worker.fail_kv_fetch", mode="off")
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            check_step_launches(steplog.rows, kernels.launch_counts(),
                                layers, False, True, False)
            c1, a1 = _fetch_counters(b), _metric_rows(a_addr)
            v1 = _metric(_metric_rows(m_http),
                         "xllm_kv_fetch_decisions_total", verdict="fetch")
            d = {k: c1[k] - c0[k] for k in c1}
            mine = [i for i, r in enumerate(rids) if r in on_b]
            if not mine or len(mine) == len(rids):
                raise AssertionError(f"phase 11 {tag}: {len(mine)} of "
                                     f"{len(rids)} chats on B")
            attempts = d["kv_fetch_attempts"]
            if armed:
                ok = attempts >= 1 and d["kv_fetch_failures"] == attempts \
                    and d["kv_fetch_bytes"] == 0
            else:
                ok = (attempts >= 1 and d["kv_fetch_failures"] == 0
                      and d["kv_fetch_bytes"] == attempts * block_bytes
                      * (SYSTEM_TOKENS // eng.ecfg.page_size)
                      and d["kv_fetch_device_wire"]
                      == (attempts if offer else 0))
            if not ok or v1 <= v0:
                raise AssertionError(f"phase 11 {tag}: fetch counters "
                                     f"{d}, fetch verdicts {v0} -> {v1}")
            # B's streams against A's own: the same prompts straight to A.
            ref = {}
            for i, r in zip(mine, _concurrent(
                    a_addr, [body(prompts[i + 1], ledger_tokens=True)
                             for i in mine])):
                _ttft_ms(r)
                ref[len(prompts[i + 1])] = [
                    t for f in r["frames"][:-1]
                    for t in (json.loads(f[6:]).get("xllm") or {})
                    .get("token_ids", [])]
            got = {n: steplog.tokens.get(n, []) for n in ref}
            equal = sum(got[n] == ref[n] for n in ref)
            if equal < len(ref):
                m = divergence_margins(
                    torch, eng, [(f"fetch_{tag}", ref, path, got, path,
                                  {len(p): p for p in prompts})], err)
                if any(x["verdict"] == "fault" for x in m):
                    raise AssertionError(f"phase 11 {tag}: divergence "
                                         f"past the margin rule: {m}")
                margins.extend(m)
            ttft[tag] = [_ttft_ms(res[i]) for i in mine]
            ttft["local"] += [_ttft_ms(r) for i, r in enumerate(res)
                              if i not in mine]
            status, span = _get(m_http, f"/admin/trace/{rids[mine[0]]}")
            if status != 200:
                raise AssertionError(f"phase 11 {tag}: trace {status}")
            audits[tag] = span["attrs"]["schedule_decision"]["kv_fetch"]
            if audits[tag].get("verdict") != "fetch":
                raise AssertionError(f"phase 11 {tag}: plan {audits[tag]}")
            rec = {"chats_on_requester": len(mine), "fetches": attempts,
                   "round_s": wall, "equal_streams": equal,
                   "streams": len(ref), "counters": d,
                   "ttft_ms_cold_on_holder": _ttft_ms(cold),
                   "ttft_ms_on_requester": [_ttft_ms(res[i])
                                            for i in mine],
                   "ttft_ms_on_holder": [_ttft_ms(r) for i, r in
                                         enumerate(res) if i not in mine]}
            if not armed:
                served = _metric(a1, "xllm_worker_kv_blocks_served_total") \
                    - _metric(a0, "xllm_worker_kv_blocks_served_total")
                export_s = _metric(
                    a1, "xllm_worker_kv_blocks_export_seconds_total") - \
                    _metric(a0, "xllm_worker_kv_blocks_export_seconds_total")
                fetch_ms = 1e3 * d["kv_fetch_seconds"] / attempts
                rec.update(
                    kv_bytes_per_fetch=d["kv_fetch_bytes"] / attempts,
                    blocks_per_fetch=d["kv_fetch_bytes"] / attempts
                    / block_bytes,
                    fetch_ms=fetch_ms,
                    export_ms=1e3 * export_s / max(served, 1),
                    adopt_ms=1e3 * d["kv_fetch_adopt_seconds"] / attempts,
                    gbps=d["kv_fetch_bytes"] / d["kv_fetch_seconds"] / 1e9)
                rec["transfer_ms"] = (fetch_ms - rec["export_ms"]
                                      - rec["adopt_ms"])
            out["rounds"][tag] = rec
        # Every step of B's a replay of a graph its warmup captured; A's
        # too (its /metrics); no ticket left and no segment leaked.
        cap = eng.capture_report()
        a_rows = _metric_rows(a_addr)
        a_state = {k: _metric(a_rows, k) for k in (
            "xllm_worker_eager_steps_total", "xllm_worker_recompiles_total",
            "xllm_worker_kv_wire_staged", "xllm_worker_kv_wire_leaked_total",
            "xllm_worker_kv_cache_usage")}
        if cap["captures_after_warmup"] or cap["eager_steps"] or \
                any(a_state.values()) or kv_wire.wire_stats()["leaked"]:
            raise AssertionError(f"phase 11: B's census {cap}, A's "
                                 f"{a_state}")
        wait_for(lambda: not eng.has_work(), 60.0, "B idle")
        free = eng.allocator.num_free + eng.prefix_cache.num_reclaimable
        if free != start_free:
            raise AssertionError(f"phase 11: B's free pages {free} of "
                                 f"{start_free}")
        status, info = _get(m_rpc, f"/rpc/instance_info?name={b.name}")
        prof = {"ttft": (info or {}).get("ttft_profiling_data") or [],
                "tpot": (info or {}).get("tpot_profiling_data") or []}
        if [s[0] for s in prof["ttft"]] != [32, 64, 128] or \
                [s[0] for s in prof["tpot"]] != [1, 2, 4]:
            raise AssertionError(f"phase 11: B's registration's profile "
                                 f"{status} {prof}")
        out["profiling"] = prof
    except Exception:
        for p in procs:
            log(f"[fetch] {p.proc.args[2]} log tail:\n{p.tail()}")
        raise
    finally:
        for w in ws:
            w.stop()
        for p in procs:
            p.stop()
    del ws
    free_device_memory(torch)
    out["margins"] = margins
    out["ttft_ms"] = ttft
    med = out["ttft_ms_median"] = {k: _median(v) for k, v in ttft.items()}
    out["audit"] = audits["recompute"]
    dv = out["default_verdict"] = _default_verdict(audits["recompute"])
    # The card's verdict per transport: whether the fetched chats' median
    # TTFT beat the recomputed ones'.
    out["card_verdict"] = {
        tag: "fetch" if med[tag] < med["recompute"] else "recompute"
        for tag, _, armed in FETCH_ROUNDS if not armed}
    out["phase_s"] = time.perf_counter() - t_phase
    rows = []
    for tag, rec in out["rounds"].items():
        if "fetch_ms" in rec:
            rows.append(
                f"{tag}: {rec['fetches']} fetches of "
                f"{rec['kv_bytes_per_fetch']:.0f} B "
                f"({rec['blocks_per_fetch']:.0f} blocks), "
                f"{rec['fetch_ms']:.3f} ms a fetch = A's export "
                f"{rec['export_ms']:.3f} + transfer "
                f"{rec['transfer_ms']:.3f} + B's adoption "
                f"{rec['adopt_ms']:.3f}, {rec['gbps']:.3f} GB/s; streams "
                f"equal {rec['equal_streams']} of {rec['streams']}")
    log(f"[fetch] {card}: " + "; ".join(rows))
    log(f"[fetch] {card}: TTFT ms median on B by round "
        f"{ {t: med[t] for t, *_ in FETCH_ROUNDS} } (recompute: "
        f"fail_kv_fetch armed), local hit on A {med['local']}; planner "
        f"audit {json.dumps(out['audit'])}; at the defaults "
        f"({FETCH_DEFAULT_GBPS} GB/s, {FETCH_DEFAULT_OVERHEAD_MS} ms): "
        f"fetch {dv['fetch_ms']:.3f} ms vs recompute "
        f"{dv['recompute_ms']:.3f} ms, verdict {dv['verdict']}; the card "
        f"by transport {out['card_verdict']}")
    log(f"[fetch] {card}: B's profiling samples on the master: TTFT "
        f"(tokens, ms) {prof['ttft']}; TPOT (batch, tokens, ms) "
        f"{prof['tpot']}; phase {out['phase_s']:.1f} s")
    log(f"[fetch] detail {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the worker's lifecycle plane
# ---------------------------------------------------------------------------

LIFE_MODEL, LIFE_BIG, LIFE_DEVICE = "llama3-1b", "llama3-8b", "cuda"
# Phase 5's flags, the cluster's 0.5 s beats.
LIFE_ARGS = ["--page-size", "128", "--num-pages", "512", "--max-model-len",
             "1024", "--max-batch-size", "8", "--prefill-buckets",
             "128,256,512", "--max-prefill-tokens", "256",
             "--heartbeat-interval-s", "0.5", "--instance-type", "DEFAULT"]
LIFE_ENV = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
            "XLLM_CUDA_GRAPHS": "1"}
# Device memory a sleep may leave allocated beyond what the process held
# before the worker was built.
LIFE_RESIDUE_BYTES = 256 << 20
LIFE_BUDGET_S = 150.0


def _param_checksums(torch, params) -> dict:
    """Per parameter tensor, two int64 sums of its bit patterns (plain,
    and weighted by position mod 65521), computed on the device in
    chunks."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif isinstance(v, torch.Tensor):
                flat = v.detach().reshape(-1)
                bits = flat.view({2: torch.int16, 4: torch.int32}[
                    flat.element_size()])
                s1 = s2 = 0
                step = 1 << 24
                for i in range(0, bits.numel(), step):
                    c = bits[i:i + step].to(torch.int64)
                    w = torch.arange(i, i + c.numel(), device=c.device) \
                        % 65521 + 1
                    s1 += int(c.sum())
                    s2 += int((c * w).sum())
                out[prefix + k] = (s1, s2)
    walk(params, "")
    return out


def _active_blocks(torch) -> dict:
    """The caching allocator's active blocks, counted by size (bytes)."""
    out = {}
    for seg in torch.cuda.memory_snapshot():
        for blk in seg.get("blocks", []):
            if blk.get("state") == "active_allocated":
                out[blk["size"]] = out.get(blk["size"], 0) + 1
    return out


def _graph_pool_bytes(torch, eng) -> int:
    pool = tuple(eng.graphs.pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def _post(addr: str, path: str, body: dict, timeout: float = 300.0):
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"null")
    finally:
        conn.close()


def _life_round(torch, kernels, w, model: str, m_http: str, bodies) -> dict:
    """``bodies`` (phase 5's four requests) through the master to
    ``model`` on ``w``: replies checked, every step's launches checked on
    the model's live engine (K2/K4 a prefill replay, K1/K3 a decode
    replay, fused with the rope), its tokens and prompts by prompt
    length, the launch counts, and the engine's census after."""
    rt = w.runtimes[model]
    steplog = StepLog(rt.engine, kernels)
    layers = rt.model_cfg.num_layers
    bodies = [dict(b, model=model) for b in bodies]
    kernels.reset_launch_counts()
    results, wall = run_concurrent(m_http, bodies)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_replies(SERVE_PLAN, results)
    check_step_launches(steplog.rows, counts, layers, False, True, False)
    cap = rt.engine.capture_report()
    if cap["captures_after_warmup"] or cap["eager_steps"]:
        raise AssertionError(f"phase 12: {model} did not replay its warmup "
                             f"graphs: {cap}")
    return {"tokens": {n: list(t) for n, t in steplog.tokens.items()},
            "prompts": dict(steplog.prompts), "launches": counts,
            "steps": len(steplog.rows), "wall_s": wall,
            "graphs": sum(rt.engine.compile_report().values())}


def _trigger(m_http: str, model: str, action: str) -> float:
    """``POST /model/triggers`` on the master; its seconds."""
    t0 = time.perf_counter()
    status, resp = _post(m_http, "/model/triggers",
                         {"model": model, "action": action})
    if status != 200 or set((resp or {}).get("results", {}).values()) \
            != {200}:
        raise AssertionError(f"phase 12: {action} {model}: {status} {resp}")
    return time.perf_counter() - t0


def lifecycle_phase(torch, kernels, card: str, err: float) -> dict:
    """Phase 12: the worker's lifecycle behind the port's master (store
    and master as children, round robin, block size 128) with a llama3-1b
    port worker in-process (phase 5's flags, random bf16 weights from the
    engine's seed, graphs on).

    a. Phase 5's four requests through the master, token streams kept;
       device memory allocated before the worker is built and while it
       serves.
    b. ``/model/triggers`` sleep: the master's row says asleep; allocated
       memory back within ``LIFE_RESIDUE_BYTES`` of its value before the
       worker (the residue named); the bytes freed beside the parameters',
       the KV pools' and the graph pool's; the sleep's ms and D2H GB/s.
    c. ``/model/triggers`` wakeup: its seconds split into the weights' H2D
       (GB/s), the engine's build and the warmup capture; as many graphs
       as the first warmup, none after; no kernel built or loaded again;
       every parameter's checksum equal to the one before the sleep; the
       four requests again: streams equal to a's, or drift under the
       margins rule; launches checked per step.
    d. ``/fork_master`` llama3-8b straight to the worker (staged asleep),
       then through the master: sleep llama3-1b, wake llama3-8b cold
       (random bf16 weights from seed 0), the four requests to it (K1-K4
       at D = 128, launches checked per step), sleep it, wake llama3-1b;
       memory after each flip, each wake's seconds.
    e. A 64-token llama3-1b stream through the master, ``drain_and_stop
       (30)`` while it runs: [DONE] with the greedy text of the same
       request served before; the worker off the master's list, a late
       request a 503; the drain's seconds.
    f. A fresh worker (no warmup: it serves nothing) with
       ``worker.crash_heartbeat`` armed once: the loop restarts, the worker
       stays listed past 3 x its lease, ``xllm_thread_crashes_total
       {root="worker.hb_loop"}`` is 1 and ``thread_crashed`` is in its
       event ring.

    At most ``LIFE_BUDGET_S`` on the script's clock."""
    from xllm_service_tpu_torch.ops.kernels import _build, paged_attention
    from xllm_service_tpu_torch.runtime import worker
    from xllm_service_tpu_torch.utils import threads as sup
    logs = ROOT / "build" / "lifecycle_logs"
    logs.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    procs, ws, out = [], [], {}
    path = {"ragged": False, "write_then_attend": True}
    try:
        store = RefProcess(["xllm_service_tpu_torch.service.coordination_net",
                            "--port", "0"], "coordination store serving on",
                           logs / "store.log")
        procs.append(store)
        store_addr = store.line.split()[-1]
        master, m_http, m_rpc = start_master(store_addr, False,
                                             logs / "master.log")
        procs.append(master)
        argv = ["--model", LIFE_MODEL, "--device", LIFE_DEVICE, *LIFE_ARGS,
                "--store-addr", store_addr, "--service-addr", m_rpc]
        free_device_memory(torch)
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        blocks0 = _active_blocks(torch)
        builds0 = (len(_build.build_logs),
                   {k: id(v) for k, v in _build._libs.items()})
        w, out["worker_start_s"] = _start(worker, argv, LIFE_ENV)
        ws.append(w)
        wait_for(lambda: w.name in listed(m_rpc), 60.0,
                 "the worker on the master's list")
        rng = random.Random(0)
        _prompt(rng, 64)                   # phase 5's warm-up prompt
        bodies = serve_bodies(rng, w.tokenizer)
        # a.
        a = _life_round(torch, kernels, w, LIFE_MODEL, m_http, bodies)
        torch.cuda.synchronize()
        alloc_serving = torch.cuda.memory_allocated()
        rt = w.runtimes[LIFE_MODEL]
        eng = rt.engine
        kv_bytes = sum(t.numel() * t.element_size() for t in eng.kv)
        pool_bytes = _graph_pool_bytes(torch, eng)
        sums0 = _param_checksums(torch, eng.params)
        del eng
        # b.
        _trigger(m_http, LIFE_MODEL, "sleep")
        if rt.engine is not None:
            raise AssertionError("phase 12: an engine after the sleep")
        # The master's books follow the trigger and the beats after it.
        wait_for(lambda: master_row(m_http, w.name)["models"].get(
            LIFE_MODEL) == "asleep", 5.0, "the master's row asleep")
        torch.cuda.synchronize()
        alloc_sleep = torch.cuda.memory_allocated()
        residue = alloc_sleep - alloc0
        # What is left: the blocks active now and not before the worker,
        # by size, and the split kernels' ticket buffers among them.
        blocks1 = _active_blocks(torch)
        new_blocks = {n: c - blocks0.get(n, 0) for n, c in blocks1.items()
                      if c > blocks0.get(n, 0)}
        tickets = sum(t.numel() * t.element_size() for t in
                      list(paged_attention._tickets.values())
                      + paged_attention._retired)
        if residue > LIFE_RESIDUE_BYTES:
            raise AssertionError(f"phase 12: {residue} B left allocated after "
                                 f"the sleep; new blocks by size "
                                 f"{new_blocks}")
        param_bytes = rt.timings["param_bytes"]
        out["sleep"] = {
            "allocated_before_worker": alloc0,
            "allocated_serving": alloc_serving,
            "allocated_asleep": alloc_sleep, "residue_bytes": residue,
            "residue_split_kv_tickets_bytes": tickets,
            "residue_blocks_by_size": new_blocks,
            "reserved_asleep": torch.cuda.memory_reserved(),
            "freed_bytes": alloc_serving - alloc_sleep,
            "param_bytes": param_bytes, "kv_pool_bytes": kv_bytes,
            "graph_pool_bytes": pool_bytes,
            "sleep_ms": 1e3 * rt.timings["sleep_s"],
            "d2h_gbps": param_bytes / rt.timings["d2h_s"] / 1e9}
        # c.
        wake_s = _trigger(m_http, LIFE_MODEL, "wakeup")
        wait_for(lambda: master_row(m_http, w.name)["models"].get(
            LIFE_MODEL) == "awake", 5.0, "the master's row awake")
        builds1 = (len(_build.build_logs),
                   {k: id(v) for k, v in _build._libs.items()})
        if builds1 != builds0:
            raise AssertionError(f"phase 12: kernels built or loaded again: "
                                 f"{builds0} -> {builds1}")
        graphs_woken = sum(rt.engine.compile_report().values())
        if _param_checksums(torch, rt.engine.params) != sums0:
            raise AssertionError("phase 12: parameters changed across the "
                                 "sleep")
        c = _life_round(torch, kernels, w, LIFE_MODEL, m_http, bodies)
        if graphs_woken != a["graphs"] or c["graphs"] != a["graphs"]:
            raise AssertionError(f"phase 12: graphs {a['graphs']} at boot, "
                                 f"{graphs_woken} at the wake, {c['graphs']} "
                                 f"after serving")
        equal = sum(c["tokens"].get(n) == t for n, t in a["tokens"].items())
        margins = []
        if equal < len(a["tokens"]):
            margins = divergence_margins(
                torch, rt.engine, [("wake", a["tokens"], path, c["tokens"],
                                    path, a["prompts"])], err)
            if any(m["verdict"] == "fault" for m in margins):
                raise AssertionError(f"phase 12: streams after the wake "
                                     f"diverge past the margins: {margins}")
        out["wake"] = {
            "seconds": wake_s, "h2d_s": rt.timings["h2d_s"],
            "h2d_gbps": param_bytes / rt.timings["h2d_s"] / 1e9,
            "engine_s": rt.timings["engine_s"],
            "warmup_s": rt.timings["warmup_s"], "graphs": graphs_woken,
            "equal_streams": equal, "streams": len(a["tokens"]),
            "margins": margins, "launches": c["launches"],
            "kernel_builds": builds1[0]}
        # d.
        status, resp = _post(w.name, "/fork_master", {"models": [LIFE_BIG]})
        if status != 200 or resp.get("created") != [LIFE_BIG]:
            raise AssertionError(f"phase 12: fork_master {status} {resp}")
        wait_for(lambda: master_row(m_http, w.name)["models"].get(LIFE_BIG)
                 == "asleep", 10.0, "llama3-8b staged on the master's row")
        flips = []

        def flip(model, action):
            s = _trigger(m_http, model, action)
            torch.cuda.synchronize()
            keys = (("sleep_s", "d2h_s", "param_bytes") if action == "sleep"
                    else ("h2d_s", "engine_s", "warmup_s"))
            timings = w.runtimes[model].timings
            rec = {"model": model, "action": action, "seconds": s,
                   "allocated": torch.cuda.memory_allocated(),
                   **{k: timings.get(k) for k in keys}}
            flips.append(rec)
            return rec
        flip(LIFE_MODEL, "sleep")
        big_wake = flip(LIFE_BIG, "wakeup")
        d = _life_round(torch, kernels, w, LIFE_BIG, m_http, bodies)
        flip(LIFE_BIG, "sleep")
        flip(LIFE_MODEL, "wakeup")
        out["swap"] = {"flips": flips, "big_launches": d["launches"],
                       "big_steps": d["steps"], "big_graphs": d["graphs"],
                       "big_cold_wake_s": big_wake["seconds"]}
        # e.
        long_body = dict(bodies[0], model=LIFE_MODEL, max_tokens=64)
        # The cache off: the drained request prefills as the first did.
        w.engine.prefix_cache.enable = False
        steplog = StepLog(w.engine, kernels)
        base = {}
        _request(m_http, CHAT, long_body, True, base)
        want = (stream_tokens(base["frames"])[0], dict(steplog.tokens))
        steplog.clear()
        got = {}
        reader = threading.Thread(target=_request,
                                  args=(m_http, CHAT, long_body, True, got))
        reader.start()
        wait_for(lambda: w.engine.has_work(), 30.0, "the long stream")
        t0 = time.perf_counter()
        drained = w.drain_and_stop(30.0)
        drain_s = time.perf_counter() - t0
        reader.join(60)
        # stream_tokens raises unless the stream ended in [DONE].
        if not drained or (stream_tokens(got["frames"])[0],
                           dict(steplog.tokens)) != want:
            raise AssertionError(f"phase 12: drain {drained}, stream "
                                 f"{got.get('frames', [])[-2:]}")
        del steplog
        wait_for(lambda: w.name not in listed(m_rpc), 10.0,
                 "the drained worker off the master's list")
        status, _ = _post(m_http, CMPL, {"model": LIFE_MODEL,
                                         "prompt": "late", "max_tokens": 1})
        if status != 503:
            raise AssertionError(f"phase 12: a late request got {status}")
        out["drain"] = {"seconds": drain_s, "late_status": status}
        ws.remove(w)
        del w, rt
        free_device_memory(torch)
        # f.
        f, _ = _start(worker, argv + ["--no-warmup"], LIFE_ENV)
        ws.append(f)
        wait_for(lambda: f.name in listed(m_rpc), 60.0, "the fresh worker")
        lease0 = f._lease_id
        before = sup.crash_counts().get("worker.hb_loop", 0)
        t0 = time.perf_counter()
        f.failpoints.arm("worker.crash_heartbeat", mode="count", n=1)
        wait_for(lambda: sup.crash_counts().get("worker.hb_loop", 0)
                 == before + 1, 10.0, "the heartbeat loop's crash")
        crashed = [e for e in f.events.since(0)
                   if e["type"] == "thread_crashed"]
        wait_for(lambda: f.failpoints.trips("worker.crash_heartbeat") == 1
                 and f._threads[-1].is_alive(), 10.0, "the restart")
        restart_s = time.perf_counter() - t0
        time.sleep(3 * f.lease_ttl_s)
        metric = _metric(_metric_rows(f.name), "xllm_thread_crashes_total",
                         root="worker.hb_loop")
        if not crashed or crashed[-1]["attrs"]["restarting"] is not True \
                or f.name not in listed(m_rpc) or f._lease_id != lease0 \
                or metric != before + 1:
            raise AssertionError(f"phase 12: restart {crashed}, listed "
                                 f"{listed(m_rpc)}, metric {metric}")
        out["restart"] = {"crashes_metric": metric,
                          "seconds_to_restart": restart_s,
                          "lease_kept": True}
    except Exception:
        for p in procs:
            log(f"[lifecycle] {p.proc.args[2]} log tail:\n{p.tail()}")
        raise
    finally:
        for x in ws:
            x.stop()
        for p in procs:
            p.stop()
    del ws
    free_device_memory(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    if out["phase_s"] > LIFE_BUDGET_S:
        raise AssertionError(f"phase 12 took {out['phase_s']:.1f} s")
    s, wk = out["sleep"], out["wake"]
    log(f"[lifecycle] {card}: sleep {s['sleep_ms']:.1f} ms, D2H "
        f"{s['d2h_gbps']:.2f} GB/s; freed {s['freed_bytes']} B (parameters "
        f"{s['param_bytes']}, KV pools {s['kv_pool_bytes']}, graph pool "
        f"{s['graph_pool_bytes']}); {s['residue_bytes']} B left over the "
        f"{s['allocated_before_worker']} B before the worker: new active "
        f"blocks by size {s['residue_blocks_by_size']} (the split kernels' "
        f"tickets {s['residue_split_kv_tickets_bytes']} B among them)")
    log(f"[lifecycle] {card}: wake {wk['seconds']:.2f} s = H2D "
        f"{wk['h2d_s']:.3f} s ({wk['h2d_gbps']:.2f} GB/s) + engine "
        f"{wk['engine_s']:.3f} s + warmup {wk['warmup_s']:.2f} s, "
        f"{wk['graphs']} graphs; streams equal {wk['equal_streams']} of "
        f"{wk['streams']}; llama3-8b cold wake "
        f"{out['swap']['big_cold_wake_s']:.2f} s; drain "
        f"{out['drain']['seconds']:.2f} s; restart "
        f"{out['restart']['seconds_to_restart']:.2f} s; phase "
        f"{out['phase_s']:.1f} s")
    log(f"[lifecycle] detail {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 13: serving from a model directory
# ---------------------------------------------------------------------------

CKPT_MODEL = "llama3-1b"
CKPT_DEVICE = "cuda"
GPTOSS_MODEL = "gpt-oss-20b"
# Part (c)'s depth: one sliding and one full layer at full width, so the
# MXFP4 file stays near 3 GB (the experts of all 24 layers would be
# 9.6 GB, and the float32 plain copy on the host 4 x that).
MXFP4_LAYERS = 2
# The RMS of the 16 E2M1 codes drawn uniformly (0, 0.5, 1, 1.5, 2, 3, 4,
# 6 and their negatives).
FP4_RMS = math.sqrt(68.5 / 8)
CKPT_ENV = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1"}
CKPT_ARGS = ["--page-size", "128", "--num-pages", "512", "--max-model-len",
             "1024", "--max-batch-size", "8", "--prefill-buckets",
             "128,256,512", "--max-prefill-tokens", "256"]


class RssSampler:
    """Peaks of a process's resident memory (GiB) while it runs, sampled
    every 20 ms on a thread, beside their values at the start: ``rss``
    the whole resident set, ``anon`` / ``file`` its anonymous and
    file-backed parts (``/proc/<pid>/status`` RssAnon / RssFile), and
    ``hwm`` the kernel's own peak of the resident set over the process's
    life (VmHWM). Where ``status`` lacks the split (some kernels list no
    RssAnon), ``rss`` comes from ``statm`` and the other three are null:
    ``statm`` gives no peak and no file-backed part (``source`` says
    which file was read)."""

    _KEYS = (("VmRSS:", "rss"), ("RssAnon:", "anon"), ("RssFile:", "file"),
             ("VmHWM:", "hwm"))

    def __init__(self, pid: int = 0) -> None:
        self.path = f"/proc/{pid or os.getpid()}/status"
        self.start = self.read()
        self.peak = dict(self.start)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def read(self) -> dict:
        out = {name: None for _, name in self._KEYS}
        out["source"] = "status"
        try:
            with open(self.path) as f:
                for line in f:
                    for key, name in self._KEYS:
                        if line.startswith(key):
                            out[name] = int(line.split()[1]) / 2 ** 20
            if out["anon"] is None:
                with open(self.path[:-len("status")] + "statm") as f:
                    resident = int(f.read().split()[1])
                out = {name: None for _, name in self._KEYS}
                out.update(rss=resident * os.sysconf("SC_PAGE_SIZE") / 2 ** 30,
                           source="statm")
        except (OSError, ValueError, IndexError):
            out["source"] = "unreadable"
        return out

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            for k, v in self.read().items():
                if k != "source" and v is not None:
                    old = self.peak.get(k)
                    self.peak[k] = v if old is None else max(old, v)

    def stop(self) -> dict:
        self._stop.set()
        self._t.join()
        return {"start_gib": self.start, "peak_gib": self.peak}


def _streamed_tokens(results) -> dict:
    """Each streamed reply's token ids (its frames carry them, served
    with ``ledger_tokens``), by its prompt's token count; every stream
    must end in [DONE] with 32 tokens."""
    out = {}
    for r in results:
        if r.get("status") != 200:
            raise AssertionError(f"phase 13: reply {r.get('status')}: {r}")
        ids, _, error = _stream_tokens_and_times(r)
        usage = [json.loads(f[len("data: "):]).get("usage")
                 for f in r["frames"] if f.startswith("data: {")]
        usage = [u for u in usage if u]
        if error or r["frames"][-1] != "data: [DONE]" or len(ids) != 32 \
                or not usage:
            raise AssertionError(f"phase 13: stream {error} {len(ids)} "
                                 f"tokens, usage {usage}")
        out[usage[-1]["prompt_tokens"]] = ids
    return out


def _llama_from_disk(torch, tf, ck, cfg, tmp: Path, tok_ref, prompts,
                     err: float, card: str) -> dict:
    """Part (a): phase 5's weights written with the port's writer, a CLI
    worker child on the directory, phase 5's four requests."""
    out = {}
    params = tf.init_params(cfg, torch.Generator(
        device=CKPT_DEVICE).manual_seed(0), CKPT_DEVICE)
    written = ck.param_digests(params)
    d = tmp / "llama"
    t0 = time.perf_counter()
    nbytes = ck.save_checkpoint(params, cfg, str(d))
    out["write_s"] = time.perf_counter() - t0
    out["bytes"] = nbytes
    out["write_gbps"] = nbytes / out["write_s"] / 1e9
    if (d / "tokenizer.json").exists():
        raise AssertionError("the directory carries a tokenizer.json")
    logs = ROOT / "build" / "ckpt_logs"
    logs.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    samplers = []
    child = RefProcess(["xllm_service_tpu_torch.runtime.worker", "--model",
                        CKPT_MODEL, "--model-dir", str(d), "--device",
                        CKPT_DEVICE, *CKPT_ARGS], "XLLM_TORCH_WORKER_UP",
                       logs / "llama_child.log", timeout=300.0, env=CKPT_ENV,
                       on_spawn=lambda p: samplers.append(RssSampler(p.pid)))
    rss = samplers[0]
    try:
        addr = child.line.split("http=")[-1]
        out["child_up_s"] = time.perf_counter() - t0
        status, body = _get(addr, "/admin/weights")
        if status != 200:
            raise AssertionError(f"/admin/weights: {status} {body}")
        if body["source"] != "checkpoint" or body["load_bytes"] != nbytes:
            raise AssertionError(f"the child did not load the file: {body}")
        out.update(load_s=body["load_s"], load_bytes=body["load_bytes"],
                   load_gbps=body["load_bytes"] / body["load_s"] / 1e9)
        unequal = sorted(k for k in written
                         if body["digests"].get(k) != written[k])
        if unequal or set(body["digests"]) != set(written):
            raise AssertionError(f"leaves differ from the weights written: "
                                 f"{unequal}")
        out["leaves_equal"] = len(written)
        compiles0 = _metric(_metric_rows(addr),
                            "xllm_worker_jit_compiles_total")
        rng = random.Random(0)
        _request(addr, "/v1/completions",
                 {"prompt": _prompt(rng, 64), "max_tokens": 4,
                  "temperature": 0.0}, False, {})
        bodies = [dict(b, stream=True, ledger_tokens=True,
                       stream_options={"include_usage": True})
                  for b in serve_bodies(rng)]
        results = [{} for _ in bodies]
        threads = [threading.Thread(target=_request,
                                    args=(addr, p, b, True, r))
                   for (p, _, _), b, r in zip(SERVE_PLAN, bodies, results)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        tokens = _streamed_tokens(results)
        rows = _metric_rows(addr)
        out["graphs_at_boot"] = compiles0
        out["graphs_after_warmup"] = _metric(
            rows, "xllm_worker_recompiles_total")
        out["eager_steps"] = _metric(rows, "xllm_worker_eager_steps_total")
        if out["graphs_after_warmup"] or out["eager_steps"] or \
                _metric(rows, "xllm_worker_jit_compiles_total") != compiles0:
            raise AssertionError(f"phase 13: graphs after warmup or eager "
                                 f"steps: {out}")
    finally:
        out["child_rss"] = rss.stop()
        child.stop()
    if sorted(tokens) != sorted(tok_ref):
        raise AssertionError(f"prompt lengths {sorted(tokens)} vs phase 5's "
                             f"{sorted(tok_ref)}")
    out["equal_streams"] = sum(tokens[n] == tok_ref[n] for n in tokens)
    margins = []
    if out["equal_streams"] != len(tokens):
        eng = types.SimpleNamespace(params=params, cfg=cfg,
                                    device=torch.device(CKPT_DEVICE))
        path = {"ragged": False, "write_then_attend": True}
        margins = divergence_margins(
            torch, eng, [("from_disk", tok_ref, path, tokens, path,
                          prompts)], err, cpu_float(params))
    out["margins"] = margins
    if any(m["verdict"] == "fault" for m in margins):
        raise AssertionError(f"phase 13: served from disk, a stream "
                             f"diverged past the margins rule: {margins}")
    del params
    log(f"[checkpoint] {card}: {cfg.name} written {nbytes} B in "
        f"{out['write_s']:.3f} s ({out['write_gbps']:.3f} GB/s, into the page "
        f"cache), loaded by "
        f"the CLI child in {out['load_s']:.3f} s ({out['load_gbps']:.3f} "
        f"GB/s, warm page cache); {out['leaves_equal']} leaves sha256-equal "
        f"to the weights written; {out['equal_streams']} of 4 streams equal "
        f"to phase 5's {json.dumps(margins)}; graphs at boot "
        f"{out['graphs_at_boot']}, after warmup "
        f"{out['graphs_after_warmup']}; child RSS {out['child_rss']}")
    return out


def _gptoss_hf_config(cfg) -> dict:
    """The ``config.json`` of a GPT-OSS checkpoint for ``cfg``."""
    (_, factor, bf, bs, orig, attn, trunc, _) = cfg.rope_scaling
    return {
        "model_type": "gpt_oss", "architectures": ["GptOssForCausalLM"],
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "sliding_window": cfg.sliding_window,
        "layer_types": ["sliding_attention" if s else "full_attention"
                        for s in cfg.layer_sliding],
        "num_local_experts": cfg.num_experts,
        "num_experts_per_tok": cfg.num_experts_per_tok,
        "rope_scaling": {"rope_type": "yarn", "factor": factor,
                         "beta_fast": bf, "beta_slow": bs,
                         "original_max_position_embeddings": orig,
                         "attention_factor": attn, "truncate": trunc},
        "tie_word_embeddings": False, "attention_bias": True,
        "torch_dtype": "bfloat16"}


def _mxfp4_tensors(torch, cfg, g) -> dict:
    """A GPT-OSS checkpoint's tensors in the MXFP4 dialect, made on the
    card: random E2M1 codes for the experts with E8M0 scales in [119,
    127] that keep their weights near in_features^-0.5, bf16 for the rest
    (attention with its biases and sinks, router, norms, embeddings, LM
    head)."""
    D, E, F = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = g.device

    def w(*shape, scale=None):
        t = torch.randn(shape, generator=g, device=dev)
        return t.mul_(scale if scale is not None
                      else shape[-1] ** -0.5).to(torch.bfloat16)

    def codes(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    def scales(*shape):
        # E8M0 exponents (bias 127) that keep each expert weight's RMS
        # near in_features^-0.5, as ``w`` draws the bf16 weights: random
        # E2M1 codes have an RMS of FP4_RMS, so for 2880 inputs the
        # scales are 2^-8 and 2^-7 (codes 119 and 120), within [119, 127].
        lo = 127 + math.floor(-0.5 * math.log2(shape[-1] * 32)
                              - math.log2(FP4_RMS))
        return torch.randint(lo, lo + 2, shape, generator=g, device=dev,
                             dtype=torch.uint8)
    out = {"model.embed_tokens.weight": w(cfg.vocab_size, D),
           "model.norm.weight": w(D, scale=0.1).add_(1),
           "lm_head.weight": w(cfg.vocab_size, D)}
    for i in range(cfg.num_layers):
        L = f"model.layers.{i}."
        A, M = L + "self_attn.", L + "mlp."
        out.update({
            L + "input_layernorm.weight": w(D, scale=0.1).add_(1),
            L + "post_attention_layernorm.weight": w(D, scale=0.1).add_(1),
            A + "q_proj.weight": w(Hq * Dh, D),
            A + "k_proj.weight": w(Hkv * Dh, D),
            A + "v_proj.weight": w(Hkv * Dh, D),
            A + "o_proj.weight": w(D, Hq * Dh),
            A + "q_proj.bias": w(Hq * Dh, scale=0.1),
            A + "k_proj.bias": w(Hkv * Dh, scale=0.1),
            A + "v_proj.bias": w(Hkv * Dh, scale=0.1),
            A + "o_proj.bias": w(D, scale=0.1),
            # Near ln(window): a sink takes about a third of a window's
            # attention, so a kernel that dropped it would show.
            A + "sinks": w(Hq, scale=1.0).add_(
                math.log(cfg.sliding_window)),
            M + "router.weight": w(E, D),
            M + "router.bias": w(E, scale=0.1),
            M + "experts.gate_up_proj_blocks": codes(E, 2 * F, D // 32, 16),
            M + "experts.gate_up_proj_scales": scales(E, 2 * F, D // 32),
            M + "experts.gate_up_proj_bias": w(E, 2 * F, scale=0.1),
            M + "experts.down_proj_blocks": codes(E, D, F // 32, 16),
            M + "experts.down_proj_scales": scales(E, D, F // 32),
            M + "experts.down_proj_bias": w(E, D, scale=0.1)})
    return out


def _gptoss_forwards(torch, tf, params, cfg) -> dict:
    """Phase 4's forwards at GPT-OSS's shapes: a prefill of 2 rows (200
    and 150 tokens: past the 128-token window) and a decode step in each
    order of the KV write, through the kernels (bf16 on the card) and the
    plain versions in float32 on the CPU (same weights).
    Returns each pair's rel L2 errors and largest absolute logit error,
    and the token rows (padding included) whose experts the float32 path
    would have chosen otherwise. Two planted faults run on the card as
    well and are held to the plain float32 path: the sinks dropped (the
    kernels' forms without sinks) and the experts' gate and up
    projections swapped.

    The discrete choices are shared, as phase 4 feeds the card's greedy
    token to both decodes: the plain paths take the card's top-k experts
    per token (``transformer._gptoss_gate`` replayed, its weights the
    softmax over those k logits). A near-tie between the 4th and 5th
    logit that two precisions break differently swaps one of 4 random
    experts for a token, which no kernel error explains."""
    chosen, at, differ = [], [0], [0, 0]
    gate = tf._gptoss_gate

    def logits_of(lp, x):
        return (x @ lp["router"]).float() + lp["router_bias"]

    def record(lp, cfg_, x):
        chosen.append(torch.topk(logits_of(lp, x),
                                 cfg_.num_experts_per_tok, -1).indices)
        return gate(lp, cfg_, x)

    def replay(lp, cfg_, x):
        logits = logits_of(lp, x)
        idx = chosen[at[0]].to(logits.device)
        at[0] += 1
        if x.dtype == torch.float32:
            own = torch.topk(logits, cfg_.num_experts_per_tok, -1).indices
            differ[0] += int((own.sort(-1).values != idx.sort(-1).values)
                             .any(-1).sum())
            differ[1] += idx[..., 0].numel()
        return tf._scatter_topk(torch.softmax(logits.gather(-1, idx), -1),
                                idx, logits.shape[-1])
    P, ps, B, T = 8, 128, 2, 256
    pt = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
    rng = random.Random(13)
    tokens = torch.tensor([[rng.randrange(3, cfg.vocab_size)
                            for _ in range(T)] for _ in range(B)])
    start = torch.zeros(B, dtype=torch.int32)
    lens = torch.tensor([200, 150], dtype=torch.int32)
    on = torch.ones(B, dtype=torch.bool)
    cpu, card_dev = torch.device("cpu"), torch.device(CKPT_DEVICE)

    def run(p, device, dtype, route, ref=None):
        """Prefill and decode in each order of the KV write, routed by
        ``route``; the decodes take ``ref``'s greedy tokens (None: this
        run's own)."""
        tf._gptoss_gate = route
        at[0] = 0
        outs = []
        for wta in (True, False):
            kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
            pre, kv = tf.forward_prefill(
                p, cfg, tokens.to(device), start.to(device),
                lens.to(device), kv, pt.to(device), write_then_attend=wta)
            nxt = (pre if ref is None else ref[len(outs)]).argmax(-1)
            dec, kv = tf.forward_decode(
                p, cfg, nxt.to(device), lens.to(device), on.to(device),
                kv, pt.to(device), write_then_attend=wta)
            outs += [pre.float().cpu(), dec.float().cpu()]
        return tuple(outs)

    def on_cpu(dtype):
        p = {k: ({n: t.to(cpu, dtype) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(cpu, dtype))
             for k, v in params.items()}
        # The float32 leaves (sinks, router bias) stay float32.
        for n, t in params["layers"].items():
            if t.dtype == torch.float32:
                p["layers"][n] = t.to(cpu)
        return p
    lp = params["layers"]
    faults = {"sinks_dropped": {n: t for n, t in lp.items() if n != "sinks"},
              "gate_up_swapped": dict(
                  lp, gate_proj=lp["up_proj"], up_proj=lp["gate_proj"],
                  gate_bias=lp["up_bias"], up_bias=lp["gate_bias"])}
    try:
        card = run(params, card_dev, torch.bfloat16, record)
        planted = {name: run(dict(params, layers=layers), card_dev,
                             torch.bfloat16, gate, card)
                   for name, layers in faults.items()}
        plain_f32 = run(on_cpu(torch.float32), cpu, torch.float32, replay,
                        card)
    finally:
        tf._gptoss_gate = gate
    out = {"routing_rows_differing": differ[0], "routing_rows": differ[1]}
    for name, pair in (("vs_plain_float32", (card, plain_f32)),
                       *((f"{n}_vs_plain_float32", (o, plain_f32))
                         for n, o in planted.items())):
        rels, err = logit_errors(torch, pair)
        out[f"rel_l2_{name}"], out[f"max_abs_logit_err_{name}"] = rels, err
    out["planted"] = list(planted)
    return out


def _mxfp4_checkpoint(torch, tf, ck, tmp: Path, card: str) -> dict:
    """Part (c): a two-layer GPT-OSS checkpoint at full width in the MXFP4
    dialect, written with the port's writer, loaded on the card."""
    from xllm_service_tpu_torch.config import ModelConfig
    from xllm_service_tpu_torch.runtime import worker
    out = {}
    full = ModelConfig.gpt_oss_20b()
    cfg = dataclasses.replace(full, num_layers=MXFP4_LAYERS,
                              layer_sliding=full.layer_sliding[
                                  :MXFP4_LAYERS])
    d = tmp / "gptoss_mxfp4"
    d.mkdir()
    g = torch.Generator(device=CKPT_DEVICE).manual_seed(21)
    tensors = _mxfp4_tensors(torch, cfg, g)
    t0 = time.perf_counter()
    out["bytes"] = ck.save_file(tensors, str(d / "model.safetensors"),
                                metadata={"format": "pt"})
    out["write_s"] = time.perf_counter() - t0
    del tensors
    free_device_memory(torch)
    with open(d / "config.json", "w") as f:
        json.dump(_gptoss_hf_config(cfg), f)
    rcfg = worker.resolve_model_config(GPTOSS_MODEL, str(d))
    # A GPT-OSS config.json names no expert width apart from the MLP's,
    # nor top-k renormalization (its router takes a softmax over the k).
    want = dataclasses.replace(cfg, moe_intermediate_size=None,
                               norm_topk_prob=rcfg.norm_topk_prob)
    if dataclasses.asdict(rcfg) != dataclasses.asdict(want):
        raise AssertionError(f"config.json resolves to {rcfg}, not {want}")
    rss = RssSampler()
    stats = {}
    t0 = time.perf_counter()
    params = ck.load_checkpoint(str(d), rcfg, CKPT_DEVICE, stats=stats)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_rss"] = rss.stop()
    out["load_bytes"] = stats["bytes_read"]
    out["load_gbps"] = stats["bytes_read"] / out["load_s"] / 1e9
    if params["layers"]["sinks"].dtype != torch.float32 or \
            tuple(params["layers"]["gate_proj"].shape) != (
                MXFP4_LAYERS, cfg.num_experts, cfg.hidden_size,
                cfg.intermediate_size):
        raise AssertionError("the MXFP4 load's layout")
    # The dequantization on the card against the host's, bit for bit, on
    # one layer's gate_up blocks [32, 5760, 90, 16].
    f = ck.SafetensorsFile(str(d / "model.safetensors"))
    blocks = f.get("model.layers.0.mlp.experts.gate_up_proj_blocks")
    scales = f.get("model.layers.0.mlp.experts.gate_up_proj_scales")
    t0 = time.perf_counter()
    host = ck.dequant_mxfp4(blocks, scales)
    out["dequant_host_s"] = time.perf_counter() - t0
    b_dev, s_dev = blocks.to(CKPT_DEVICE), scales.to(CKPT_DEVICE)
    dev = ck.dequant_mxfp4(b_dev, s_dev)
    same = torch.equal(dev.cpu().view(torch.int32), host.view(torch.int32))
    out["dequant_shape"] = list(blocks.shape)
    del dev, host
    if not same:
        raise AssertionError("dequant_mxfp4 on the card is not bit-equal to "
                             "the host's")
    out["dequant_ms"] = time_ms(lambda: ck.dequant_mxfp4(b_dev, s_dev),
                                iters=10, warmup=2)
    # Reads the codes and scales once, writes float32 values once.
    dq_bytes = blocks.numel() + scales.numel() + blocks.numel() * 2 * 4
    out["dequant_bound_ms"] = dq_bytes / HBM_BYTES_PER_S * 1e3
    del b_dev, s_dev, blocks, scales, f
    fw = _gptoss_forwards(torch, tf, params, rcfg)
    out.update(fw)
    rels = fw["rel_l2_vs_plain_float32"]
    # (b)'s margins rule reads the largest logit error of the same check.
    out["max_abs_logit_err"] = fw["max_abs_logit_err_vs_plain_float32"]
    planted = {n: fw[f"rel_l2_{n}_vs_plain_float32"] for n in fw["planted"]}
    del params
    free_device_memory(torch)
    log(f"[checkpoint] {card}: gpt-oss MXFP4 x{MXFP4_LAYERS} layers at full "
        f"width: {out['bytes']} B written in {out['write_s']:.3f} s, loaded "
        f"in {out['load_s']:.3f} s ({out['load_gbps']:.3f} GB/s, warm page "
        f"cache; host RSS {out['load_rss']}); dequant on the card bit-equal "
        f"to the host over {out['dequant_shape']} ({out['dequant_ms']:.4f} "
        f"ms, bound {out['dequant_bound_ms']:.4f} ms; host "
        f"{out['dequant_host_s']:.2f} s); logits rel L2 (wta prefill/decode, "
        f"atw prefill/decode) kernels vs plain float32 {rels} (limit "
        f"{FORWARD_REL_L2}); largest logit error "
        f"{fw['max_abs_logit_err_vs_plain_float32']}; planted faults "
        f"vs plain float32 {json.dumps(planted)}; float32 would have chosen "
        f"other experts on {fw['routing_rows_differing']} of "
        f"{fw['routing_rows']} token rows (the plain paths took the card's)")
    if max(rels) > FORWARD_REL_L2:
        raise AssertionError(f"gpt-oss logits rel L2 against the plain "
                             f"float32 path {max(rels)} > {FORWARD_REL_L2}")
    passed = [n for n, r in planted.items() if max(r) <= FORWARD_REL_L2]
    if passed:
        raise AssertionError(f"gpt-oss logits check passed planted faults "
                             f"{passed}: {planted}")
    return out


GPTOSS_PATHS = (("split", False, True), ("ragged", True, True),
                ("attend_then_write", False, False))
# Part (b)'s worker flags: the four requests' slots, the longest one's
# pages (at most 4 of 128 tokens with its template and 32 new) and the
# buckets a 256-token budget fills, so that its warmup captures 54 graphs
# (108 with the ragged step) where phase 5's flags take 96 (240): each
# graph's warm-up forward runs all 32 experts over its every row.
GPTOSS_ARGS = ["--page-size", "128", "--num-pages", "512",
               "--max-model-len", "512", "--max-batch-size", "4",
               "--prefill-buckets", "128,256",
               "--max-prefill-tokens", "256"]


def _gptoss_20b(torch, kernels, tf, err: float, card: str) -> dict:
    """Part (b): GPT-OSS-20B at its published widths and depth on random
    bf16 weights made on the card (sinks, biases and the router bias
    drawn too), served in-process by the worker in each of
    ``GPTOSS_PATHS`` with phase 5's four requests."""
    from xllm_service_tpu_torch.config import ModelConfig
    cfg = ModelConfig.gpt_oss_20b()
    # At the catalog's factor 2 a prefill chunk's assignments drop by the
    # batch it shares (a random model routes its tokens alike), so two
    # paths that chunk alike but batch otherwise part at the first token.
    # At E / k each expert can take every token of its group.
    served_cfg = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    t0 = time.perf_counter()
    g = torch.Generator(device=CKPT_DEVICE).manual_seed(0)
    params = tf.init_params(cfg, g, CKPT_DEVICE)
    lp = params["layers"]
    for k in ("sinks", "router_bias", "q_bias", "k_bias", "v_bias",
              "o_bias", "gate_bias", "up_bias", "down_bias"):
        lp[k].copy_(0.1 * torch.randn(lp[k].shape, generator=g,
                                      device=CKPT_DEVICE))
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in [params["embed"], params["lm_head"],
                                        params["final_norm"], *lp.values()]),
           "params": sum(t.numel() for t in [params["embed"],
                                             params["lm_head"],
                                             params["final_norm"],
                                             *lp.values()])}
    split = {"ragged": False, "write_then_attend": True}
    served = {}
    tok = {}
    for tag, ragged, wta in GPTOSS_PATHS:
        on_engine = None
        if tag != "split":
            def on_engine(eng, tok_x, path={"ragged": ragged,
                                            "write_then_attend": wta},
                          tag=tag):
                return divergence_margins(torch, eng, [(
                    tag, tok["split"], split, tok_x, path,
                    served["split"]["prompts"])], err)
        served[tag] = serve(torch, kernels, GPTOSS_MODEL, CKPT_DEVICE,
                            ragged=ragged, write_then_attend=wta,
                            tag=f"h_{tag}", params=params,
                            on_engine=on_engine, model_cfg=served_cfg,
                            engine_args=GPTOSS_ARGS,
                            profile=tag == "split")
        tok[tag] = served[tag].pop("tokens")
    for tag in served:
        served[tag].pop("prompts")
        served[tag].pop("params", None)
    margins = [m for tag in served for m in (served[tag].pop("on_engine")
                                             or [])]
    same = {}
    for tag in ("ragged", "attend_then_write"):
        pairs = [(x, y) for n in tok["split"]
                 for x, y in zip(tok["split"][n], tok[tag].get(n, []))]
        same[tag] = sum(x == y for x, y in pairs) / len(pairs)
    del params, lp
    free_device_memory(torch)
    out.update(serve=served, margins=margins, equal_token_share=same)
    if any(m["verdict"] == "fault" for m in margins):
        raise AssertionError(f"gpt-oss-20b: a stream diverged past the "
                             f"margins rule: {margins}")
    dropped = {t: served[t]["moe_dropped_tokens"] for t in served}
    if any(dropped.values()):
        raise AssertionError(f"gpt-oss-20b: assignments dropped at the "
                             f"capacity factor E / k: {dropped}")
    s = served["split"]
    log(f"[checkpoint] {card}: gpt-oss-20b x{cfg.num_layers} layers, "
        f"{out['params']} parameters ({out['param_bytes']} B) made in "
        f"{out['init_s']:.2f} s; decode step ms median split "
        f"{s['decode_step_ms_median']}, ragged "
        f"{served['ragged']['decode_step_ms_median']}, attend-then-write "
        f"{served['attend_then_write']['decode_step_ms_median']}; idle share "
        f"(split, profiled) {(s['profile'] or {}).get('idle_share')}; "
        f"capacity factor {served_cfg.moe_capacity_factor}, moe_dropped "
        f"{dropped}; "
        f"equal tokens {same}; margins {json.dumps(margins)}")
    return out


def checkpoint_phase(torch, kernels, card: str, tok_ref, prompts,
                     err: float) -> dict:
    """Phase 13: the port served from a model directory.

    a. llama3-1b's random bf16 weights (phase 5's: the engine's seed 0;
       2,471,628,800 B, tied embeddings so no ``lm_head``) written by the
       port's ``save_checkpoint`` to a temporary directory without a
       ``tokenizer.json`` (the byte tokenizer, as phase 5), then a CLI
       worker child (``--model-dir <dir> --model llama3-1b``, phase 5's
       flags) serving phase 5's four requests, each streamed with its
       token ids: the write's and the load's seconds and GB/s (a warm
       read), every leaf's sha256 in the child (``GET /admin/weights``)
       equal to the weights written, the streams equal to phase 5's or
       drift under the margins rule, graphs captured at boot and none
       after warmup, the child's peak RSS.
    c. GPT-OSS at full width cut to ``MXFP4_LAYERS`` layers (one sliding,
       one full): a checkpoint in the MXFP4 dialect (random codes, scales
       2^-8 and 2^-7, codes 119 and 120, which keep the expert weights
       near 2880^-0.5; bf16 attention, sinks near ln(128), router,
       embeddings and LM head; ~3.1 GB) written with ``save_file`` and a
       gpt_oss
       ``config.json`` (the port's ``save_checkpoint`` refuses GPT-OSS),
       loaded by ``load_checkpoint`` on the card: the load's GB/s and
       the host's peak RSS, ``dequant_mxfp4`` on the card bit-equal to the
       host's over one layer's [32, 5760, 90, 16] blocks and its ms, and a
       prefill + decode in both orders through the kernels against the
       plain versions in float32 on the CPU (rel L2 under 5e-2), and two
       planted faults (sinks dropped; gate and up swapped) that the same
       check must fail.
    b. GPT-OSS-20B at its published widths and depth (24 layers, vocab
       201,088, 32 experts top-4, alternating 128-token windows, sinks,
       yarn): ~20.9 B random bf16 parameters made on the card, served by
       the worker in-process, at the capacity factor E / k = 8 so that no
       (token, expert) assignment drops and each stream depends on its own
       tokens alone, in 4 slots of up to 512 tokens with prefill buckets
       128 and 256 (``GPTOSS_ARGS``), with phase 5's four requests in the
       split path, the ragged step and attend-then-write (``serve``: launches
       checked per step, K3/K3'/K4/K4'/K5 with sinks once per layer per
       forward, graphs replayed, none captured late); step medians, idle
       share, ``moe_dropped`` (0); the margins rule on each path's streams
       against the split path's, against 10 x c's largest logit error.
    d. Every model freed between parts; the directories deleted.

    Its seconds are printed."""
    import shutil
    import tempfile
    from xllm_service_tpu_torch.models import transformer as tf
    from xllm_service_tpu_torch.runtime import checkpoint as ck
    from xllm_service_tpu_torch.runtime import worker
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="xllm_ckpt_"))
    out = {}
    part_s = out["part_s"] = {}
    try:
        out["llama"] = _llama_from_disk(
            torch, tf, ck, worker.resolve_model_config(CKPT_MODEL), tmp,
            tok_ref, prompts, err, card)
        free_device_memory(torch)
        part_s["a"] = time.perf_counter() - t_phase
        out["mxfp4"] = _mxfp4_checkpoint(torch, tf, ck, tmp, card)
        free_device_memory(torch)
        part_s["c"] = time.perf_counter() - t_phase - part_s["a"]
        out["gptoss"] = _gptoss_20b(torch, kernels, tf,
                                    out["mxfp4"]["max_abs_logit_err"], card)
        free_device_memory(torch)
        part_s["b"] = (time.perf_counter() - t_phase - part_s["a"]
                       - part_s["c"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[checkpoint] {card}: phase 13 took {out['seconds']:.1f} s "
        f"(parts {json.dumps(part_s)})")
    return out


# Phase 14: Qwen2-VL-7B with images. The published
# Qwen/Qwen2-VL-7B-Instruct config.json (text stack and vision tower).
EPD_MODEL = "qwen2-vl-7b"
EPD_DEVICE = "cuda"
QWEN2VL_7B = {
    "architectures": ["Qwen2VLForConditionalGeneration"],
    "model_type": "qwen2_vl", "hidden_act": "silu", "hidden_size": 3584,
    "intermediate_size": 18944, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4,
    "max_position_embeddings": 32768, "max_window_layers": 28,
    "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "sliding_window": 32768, "use_sliding_window": False,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "vocab_size": 152064, "bos_token_id": 151643, "eos_token_id": 151645,
    "vision_start_token_id": 151652, "vision_end_token_id": 151653,
    "vision_token_id": 151654, "image_token_id": 151655,
    "video_token_id": 151656,
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "vision_config": {"depth": 32, "embed_dim": 1280, "mlp_ratio": 4,
                      "num_heads": 16, "in_chans": 3, "hidden_size": 3584,
                      "patch_size": 14, "spatial_merge_size": 2,
                      "spatial_patch_size": 14, "temporal_patch_size": 2},
}
# The published Qwen/Qwen2.5-VL-7B-Instruct vision_config.
QWEN25VL_7B_VISION = {
    "depth": 32, "hidden_act": "silu", "hidden_size": 1280,
    "intermediate_size": 3420, "num_heads": 16, "in_chans": 3,
    "out_hidden_size": 3584, "patch_size": 14, "spatial_merge_size": 2,
    "spatial_patch_size": 14, "window_size": 112,
    "fullatt_block_indexes": [7, 15, 23, 31], "tokens_per_second": 2,
    "temporal_patch_size": 2}
EPD_ARGS = ["--page-size", "128", "--num-pages", "64", "--max-model-len",
            "512", "--max-batch-size", "4", "--prefill-buckets", "128,256",
            "--max-prefill-tokens", "256", "--heartbeat-interval-s", "0.5"]
EPD_ENV = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1"}
# A tower's bf16 output against the float32 run of the same weights:
# relative L2 of the [tokens, 3584] embeddings (bf16 keeps 8 mantissa
# bits; 32 blocks accumulate their rounding).
EPD_TOWER_TOL = 5e-2
EPD_TOKENS = 16
EPD_BUDGET_S = 150.0


def _epd_chat(image=None, text="Describe this picture in a few words.",
              model=EPD_MODEL) -> dict:
    content = [{"type": "text", "text": text}]
    if image is not None:
        content.append({"type": "image_url", "image_url": {"url": image}})
    return {"model": model, "max_tokens": EPD_TOKENS, "temperature": 0.0,
            "ignore_eos": True, "stream": True, "logprobs": True,
            "stream_options": {"include_usage": True},
            "messages": [{"role": "user", "content": content}]}


def _epd_reply(result) -> tuple:
    """A streamed reply's text and TTFT (ms); its tokens counted."""
    if result.get("status") != 200:
        raise AssertionError(f"phase 14: reply {result.get('status')}: "
                             f"{result.get('frames', result)}")
    text, lps, idx, usage = stream_tokens(result["frames"])
    if not usage or usage["completion_tokens"] != EPD_TOKENS:
        raise AssertionError(f"phase 14: stream usage {usage}")
    return text, result["times"][idx[0]] * 1e3 if idx else None


def _tower_run(torch, qv, params, vcfg, pixels, v25: bool):
    fn = (qv.encode_images_fixed_grid_v25 if v25
          else qv.encode_images_fixed_grid)
    with torch.inference_mode():
        return fn(params, vcfg, pixels)


def _tower_check(torch, qv, params, vcfg, v25: bool, card: str) -> dict:
    """One 224 x 224 image through ``params`` (bf16) and through the same
    weights in float32: relative L2 and max abs error of the embeddings,
    the bf16 run's ms per image (median of 5 after one warm run) and its
    modeled FLOPs as a share of the bf16 peak."""
    import numpy as np

    from xllm_service_tpu_torch.runtime.multimodal import load_image
    pixels = load_image("random:5", vcfg.image_size)[None]
    out = _tower_run(torch, qv, params, vcfg, pixels, v25)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _tower_run(torch, qv, params, vcfg, pixels, v25)
        times.append((time.perf_counter() - t0) * 1e3)
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    ref = _tower_run(torch, qv, p32, vcfg, pixels, v25)
    del p32
    free_device_memory(torch)
    rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    ms = _median(times)
    flops = qv.tower_flops(vcfg)
    rec = {"shape": list(out.shape), "finite": bool(np.isfinite(out).all()),
           "rel_l2_vs_fp32": rel,
           "max_abs_err_vs_fp32": float(np.abs(out - ref).max()),
           "ref_rms": float(np.sqrt((ref ** 2).mean())),
           "tol": EPD_TOWER_TOL, "ms_per_image": ms,
           "ms_samples": times, "modeled_flops": flops,
           "bf16_peak_share": flops / (ms * 1e-3) / PEAK_BF16_FLOPS,
           "card": card}
    want = [1, vcfg.tokens_per_image, vcfg.hidden_size]
    if rec["shape"] != want or not rec["finite"] or rel > EPD_TOWER_TOL:
        raise AssertionError(f"phase 14: tower check failed: {rec}")
    return rec


def _mm_margins(torch, eng, reqs, streams, err) -> list:
    """The served image streams under the margins rule: each stream's
    tokens against teacher-forced argmaxes of one prefill forward (the
    splice, the rope streams, write-then-attend, eager) over the prompt
    and the tokens before; at the first disagreement the top-2 margin,
    drift under 10 x ``err``, a fault above it."""
    import numpy as np

    from xllm_service_tpu_torch.models import transformer as tf
    out = []
    for rid, req in reqs.items():
        toks = streams.get(rid, [])
        for i in range(len(toks)):
            ids = list(req.token_ids) + toks[:i]
            T = len(ids)
            pages = -(-T // 128)
            kv = tf.init_kv_cache(eng.cfg, pages + 1, 128, eng.device)
            index = np.full((1, T), -1, np.int64)
            index[0, req.mm_positions] = np.arange(len(req.mm_positions))
            rope_pos = eng._rope_window(types.SimpleNamespace(req=req), 0, T)
            dev = eng.device
            with torch.inference_mode():
                logits, _ = tf.forward_prefill(
                    eng.params, eng.cfg, torch.tensor([ids], device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev),
                    torch.tensor([T], dtype=torch.int32, device=dev), kv,
                    torch.arange(1, pages + 1, dtype=torch.int32,
                                 device=dev)[None],
                    mm_embeds=torch.from_numpy(req.mm_embeds).to(dev),
                    mm_index=torch.from_numpy(index).to(dev),
                    rope_pos=torch.from_numpy(rope_pos[None]).to(dev))
            top = torch.topk(logits[0].float(), 2)
            if int(top.indices[0]) != toks[i]:
                margin = float(top.values[0] - top.values[1])
                out.append({"request": rid, "position": i,
                            "served": toks[i],
                            "top2": top.indices.tolist(), "margin": margin,
                            "limit": 10 * err,
                            "verdict": "fault" if margin > 10 * err
                            else "drift"})
                break
    return out


EPD_WORKER_STAGES = ("received", "encoded", "scheduled", "first_token")


def _trace_split(m_http: str, rid: str) -> dict:
    """The ms between the worker plane's stages of ``rid``'s trace at the
    master (received -> encoded -> scheduled -> first_token), once its
    spans arrived."""
    stages = {}

    def arrived() -> bool:
        status, tr = _get(m_http, f"/admin/trace/{rid}")
        if status != 200:
            return False
        for e in tr["events"]:
            if e["plane"] == "worker" and e["stage"] in EPD_WORKER_STAGES:
                stages.setdefault(e["stage"], e["t_wall"])
        return len(stages) == len(EPD_WORKER_STAGES)
    wait_for(arrived, 15.0, f"phase 14: the worker spans of {rid}")
    return {f"{a}->{b}": (stages[b] - stages[a]) * 1e3
            for a, b in zip(EPD_WORKER_STAGES, EPD_WORKER_STAGES[1:])}


def _epd_wire_round(w, enc_addr: str, m_http: str, card: str) -> dict:
    """Phase 14's staged wire beside the bytes: one image's embeddings
    fetched from the ENCODE child by the MIX worker over CUDA IPC (a
    staged ticket pulled and acknowledged) and as bytes, bit-equal; the
    child's staged tickets back to 0; an image chat through the master
    each way, its TTFT and trace split."""
    from xllm_service_tpu_torch.runtime import kv_wire
    pulls, pull_one = [], kv_wire.pull_one

    def counted(tr):
        out = pull_one(tr)
        pulls.append(tr.get("uuid"))
        return out
    out = {}
    kv_wire.pull_one = counted
    try:
        t0 = time.perf_counter()
        wired, _ = w._fetch_remote_embeds(enc_addr, ["random:7"], 60.0)
        out["fetch_ms_wire"] = (time.perf_counter() - t0) * 1e3
        w.opts.pd_device_wire = False
        t0 = time.perf_counter()
        by_bytes, _ = w._fetch_remote_embeds(enc_addr, ["random:7"], 60.0)
        out["fetch_ms_bytes"] = (time.perf_counter() - t0) * 1e3
        bytes_chat = _concurrent(m_http, [_epd_chat("random:8")],
                                 [{"x-request-id": "epd-bytes"}])[0]
        w.opts.pd_device_wire = True
        wire_chat = _concurrent(m_http, [_epd_chat("random:9")],
                                [{"x-request-id": "epd-wire"}])[0]
    finally:
        kv_wire.pull_one = pull_one
        w.opts.pd_device_wire = True
    out["pulls"] = len(pulls)
    out["bit_equal"] = (wired.dtype == by_bytes.dtype
                        and wired.shape == by_bytes.shape
                        and wired.tobytes() == by_bytes.tobytes())
    out["child_staged_after"] = _metric(_metric_rows(enc_addr),
                                        "xllm_worker_encode_staged")
    out["ttft_ms_image_wire"] = _epd_reply(wire_chat)[1]
    out["ttft_ms_image_bytes"] = _epd_reply(bytes_chat)[1]
    out["trace_split_ms_wire"] = _trace_split(m_http, "epd-wire")
    out["trace_split_ms_bytes"] = _trace_split(m_http, "epd-bytes")
    out["ok"] = (out["bit_equal"] and out["pulls"] == 2
                 and out["child_staged_after"] == 0)
    log(f"[epd] {card}: staged wire beside bytes: {json.dumps(out)}")
    return out


def epd_phase(torch, kernels, card: str, err: float) -> dict:
    """Phase 14: the EPD multimodal path with Qwen2-VL-7B at full width
    and depth (the published config.json; random bf16 weights from seed
    0), behind the port's store and master (children).

    a. K1/K2 with the sectioned mrope tables, K3 and K4 at Qwen2-VL-7B's
       shapes (28 query heads, 4 KV heads, D = 128) against their plain
       versions, timed (``*_qwen2vl`` records).
    b. The vision tower (``Qwen2VLVisionConfig`` defaults: depth 32,
       width 1280, 16 heads, patch 14, merge 2) random in bf16, written
       as HF-named safetensors (``visual.*``) with the config.json and
       read back through the port's reader: every leaf equal; one image
       through it against the float32 run of the same weights
       (``EPD_TOWER_TOL``), its ms per image and share of the bf16 peak.
       The Qwen2.5-VL-7B tower (``Qwen25VLVisionConfig`` defaults) over
       one image the same way.
    c. An ENCODE worker child (``--role encode``) and an in-process MIX
       worker on that directory (the language model random from seed 0,
       the tower from the file), warmed up, behind the master: two text
       chats, three image chats (224 x 224, 64 merged tokens each), the
       first image again (an encode-cache hit on the ENCODE worker, the
       same text), then ``worker.fail_encode`` armed on the ENCODE
       worker and the second image again (the MIX worker encodes
       locally: the same text, the fallback counted). TTFT with and
       without an image, the decode step's median ms, the launches of
       K1/K2, K3, K4 (K5 none), no graph captured after warmup, every
       image token spliced, and the image streams under the margins
       rule.

    At most ``EPD_BUDGET_S`` on the script's clock."""
    import collections

    from xllm_service_tpu_torch.config import ModelConfig
    from xllm_service_tpu_torch.models import qwen2vl_vision as qv
    from xllm_service_tpu_torch.ops import attention, rope
    from xllm_service_tpu_torch.ops.kernels import (kv_update,
                                                    paged_attention,
                                                    prefill_attention)
    from xllm_service_tpu_torch.runtime import checkpoint, worker
    t_phase = time.perf_counter()
    logs = ROOT / "build" / "epd_logs"
    logs.mkdir(parents=True, exist_ok=True)
    mdir = ROOT / "build" / "epd_model"
    mdir.mkdir(parents=True, exist_ok=True)
    for f in mdir.glob("*"):
        f.unlink()
    cfg = ModelConfig.from_hf_config(QWEN2VL_7B, name=EPD_MODEL)
    out = {"card": card}
    # a.
    bench = KernelBench(torch, cfg, EPD_DEVICE, suffix="_qwen2vl")
    bench.rope_decode_writer(kv_update, rope)
    bench.rope_prefill_writer(kv_update, rope)
    bench.decode_attention(paged_attention, attention)
    bench.prefill_attention(prefill_attention, attention)
    records = bench.results
    del bench
    free_device_memory(torch)
    out["kernels_s"] = time.perf_counter() - t_phase
    # b.
    vcfg = qv.Qwen2VLVisionConfig.from_hf_config(QWEN2VL_7B["vision_config"])
    gen = torch.Generator(device=EPD_DEVICE).manual_seed(0)
    tower = qv.init_vision_params(vcfg, gen, EPD_DEVICE, torch.bfloat16)
    with open(mdir / "config.json", "w", encoding="utf-8") as f:
        json.dump(QWEN2VL_7B, f)
    t0 = time.perf_counter()
    nbytes = checkpoint.save_qwen2vl_vision(tower, vcfg,
                                            str(mdir / "visual.safetensors"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vcfg2, read = checkpoint.load_qwen2vl_vision(str(mdir), EPD_DEVICE,
                                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    if vcfg2 != dataclasses.replace(vcfg, dtype="float32"):
        raise AssertionError(f"phase 14: reader config {vcfg2} != {vcfg}")
    for grp in ("blocks", "merger"):
        for k, v in tower[grp].items():
            if not torch.equal(v, read[grp][k]):
                raise AssertionError(f"phase 14: {grp}.{k} read back "
                                     f"differs")
    if not torch.equal(tower["patch_embed"], read["patch_embed"]):
        raise AssertionError("phase 14: patch_embed read back differs")
    out["tower_io"] = {"bytes": nbytes, "write_s": write_s,
                       "read_s": read_s}
    out["tower"] = _tower_check(torch, qv, read, vcfg, False, card)
    del tower, read
    free_device_memory(torch)
    v25 = qv.Qwen25VLVisionConfig.from_hf_config(QWEN25VL_7B_VISION)
    p25 = qv.init_vision_params(v25, gen, EPD_DEVICE, torch.bfloat16)
    out["tower_v25"] = _tower_check(torch, qv, p25, v25, True, card)
    del p25
    free_device_memory(torch)
    log(f"[epd] {card}: qwen2-vl tower {json.dumps(out['tower'])}; "
        f"qwen2.5-vl tower {json.dumps(out['tower_v25'])}; tower file "
        f"{json.dumps(out['tower_io'])}")
    # c.
    procs, ws = [], []
    try:
        store = RefProcess(["xllm_service_tpu_torch.service.coordination_net",
                            "--port", "0"], "coordination store serving on",
                           logs / "store.log")
        procs.append(store)
        store_addr = store.line.split()[-1]
        master, m_http, m_rpc = start_master(store_addr, False,
                                             logs / "master.log")
        procs.append(master)
        common = ["--model", EPD_MODEL, "--model-dir", str(mdir),
                  "--device", EPD_DEVICE, *EPD_ARGS,
                  "--store-addr", store_addr, "--service-addr", m_rpc]
        enc_box = {}

        def spawn_encoder() -> None:
            try:
                enc_box["p"] = RefProcess(
                    ["xllm_service_tpu_torch.runtime.worker", "--role",
                     "encode", "--instance-type", "ENCODE", *common],
                    "XLLM_TORCH_WORKER_UP", logs / "encode_child.log",
                    timeout=240.0, env=EPD_ENV)
            except Exception as e:  # noqa: BLE001 — raised below
                enc_box["err"] = e
        t_enc = threading.Thread(target=spawn_encoder)
        t0 = time.perf_counter()
        t_enc.start()
        w, out["mix_start_s"] = _start(
            worker, [*common, "--instance-type", "MIX"], EPD_ENV)
        ws.append(w)
        t_enc.join(300)
        if "err" in enc_box or "p" not in enc_box:
            raise AssertionError(f"phase 14: the ENCODE child did not "
                                 f"start: {enc_box.get('err')}")
        enc = enc_box["p"]
        procs.append(enc)
        out["both_up_s"] = time.perf_counter() - t0
        enc_addr = enc.line.split("http=")[1].split()[0]
        # A lone MIX instance takes the decode seat and prefills too.
        wait_for(lambda: (master_row(m_http, w.name) or {}).get(
            "models", {}).get(EPD_MODEL) == "awake", 60.0,
            "the MIX worker's beat in the master's books")
        wait_for(lambda: master_row(m_http, enc_addr) is not None, 60.0,
                 "the ENCODE worker in the master's books")
        eng = w.engine
        graphs = sum(eng.compile_report().values())
        reqs, streams, steps = {}, collections.defaultdict(list), []
        add, step = eng.add_request, eng.step

        def add_request(req):
            if req.mm_embeds is not None:
                reqs[req.request_id] = req
            return add(req)

        def timed_step():
            t1 = time.perf_counter()
            outs = step()
            steps.append((eng.last_step_kind,
                          (time.perf_counter() - t1) * 1e3))
            for o in outs:
                streams[o.request_id].extend(o.new_token_ids)
            return outs
        eng.add_request, eng.step = add_request, timed_step
        spliced0 = eng.mm_spliced_tokens
        kernels.reset_launch_counts()
        texts = _concurrent(m_http, [_epd_chat(text=t) for t in (
            "Tell me about the weather in spring and autumn.",
            "Write two sentences about a quiet harbour town.")])
        imgs = _concurrent(m_http, [_epd_chat(f"random:{s}")
                                    for s in (1, 2, 3)])
        again = _concurrent(m_http, [_epd_chat("random:1")])
        launches = kernels.launch_counts()
        enc_rows = _metric_rows(enc_addr)
        out["wire"] = _epd_wire_round(w, enc_addr, m_http, card)
        st, resp = _post(enc_addr, "/admin/failpoint",
                         {"name": "worker.fail_encode", "mode": "count",
                          "n": 4})
        if st != 200:
            raise AssertionError(f"phase 14: arming failed: {st} {resp}")
        degraded = _concurrent(m_http, [_epd_chat("random:2")])
        fb = [e for e in w.events.since(0) if e["type"] == "encode_fallback"]
        mix_rows = _metric_rows(w.name)
        text_replies = [_epd_reply(r) for r in texts]
        img_replies = [_epd_reply(r) for r in imgs]
        again_text = _epd_reply(again[0])[0]
        degraded_text = _epd_reply(degraded[0])[0]
        decode_ms = [ms for kind, ms in steps if kind == "decode"]
        rep = eng.capture_report()
        late = sum(rep[p]["captures_after_warmup"]
                   for p in ("prefill", "ragged", "decode", "decode_multi"))
        eager = sum(sum(rep[p]["eager_steps"].values())
                    for p in ("prefill", "ragged", "decode", "decode_multi"))
        out.update({
            "graphs_at_warmup": graphs, "captures_after_warmup": late,
            "eager_steps": eager,
            "ttft_ms_text": [t for _, t in text_replies],
            "ttft_ms_image": [t for _, t in img_replies],
            "ttft_ms_image_cached": _epd_reply(again[0])[1],
            "ttft_ms_image_local_encode": _epd_reply(degraded[0])[1],
            "decode_step_ms_median": _median(decode_ms),
            "decode_steps": len(decode_ms),
            "launches": {k: launches.get(k, 0) for k in (
                "rope_kv_update_layer", "rope_prefill_kv_update_layer",
                "paged_decode_attention", "paged_prefill_attention",
                "ragged_paged_attention", "paged_kv_update_layer",
                "paged_prefill_kv_update_layer")},
            "spliced_tokens": eng.mm_spliced_tokens - spliced0,
            "tokens_per_image": vcfg.tokens_per_image,
            "encode_child": {
                "cache_hits": _metric(enc_rows,
                                      "xllm_encode_cache_hits_total"),
                "cache_misses": _metric(enc_rows,
                                        "xllm_encode_cache_misses_total"),
                "encode_seconds": _metric(
                    enc_rows, "xllm_worker_encode_seconds_total"),
                "images": _metric(enc_rows,
                                  "xllm_worker_encode_images_total")},
            "fallback": {
                "events": [e["attrs"] for e in fb],
                "counted": _metric(mix_rows, "xllm_encode_fallback_total"),
                "same_text": degraded_text == img_replies[1][0]},
            "repeat_same_text": again_text == img_replies[0][0],
            "margins": _mm_margins(torch, eng, reqs, streams, err),
        })
        ec = out["encode_child"]
        ec["ms_per_image"] = (1e3 * ec["encode_seconds"] / ec["images"]
                              if ec["images"] else None)
        la = out["launches"]
        problems = []
        if min(la["rope_kv_update_layer"], la["rope_prefill_kv_update_layer"],
               la["paged_decode_attention"],
               la["paged_prefill_attention"]) <= 0:
            problems.append("a kernel of the path never launched")
        if la["ragged_paged_attention"] or la["paged_kv_update_layer"] \
                or la["paged_prefill_kv_update_layer"]:
            problems.append("K5 or an unfused writer launched")
        if late or eager:
            problems.append(f"{late} captures after warmup, {eager} eager "
                            f"steps")
        # Three images through the ENCODE child, one repeat, the wire
        # round's two and the local encode: every image's 64 tokens
        # spliced, the repeat a cache hit.
        if out["spliced_tokens"] != 7 * vcfg.tokens_per_image:
            problems.append(f"spliced {out['spliced_tokens']} tokens")
        if ec["cache_hits"] < 1 or ec["cache_misses"] < 3:
            problems.append(f"encode cache {ec}")
        if not (out["fallback"]["events"] and out["fallback"]["counted"] >= 1
                and out["fallback"]["same_text"]
                and out["repeat_same_text"]):
            problems.append(f"fallback {out['fallback']}, repeat "
                            f"{out['repeat_same_text']}")
        if any(m["verdict"] == "fault" for m in out["margins"]):
            problems.append(f"margins {out['margins']}")
        if not out["wire"]["ok"]:
            problems.append(f"wire round {out['wire']}")
        out["seconds"] = time.perf_counter() - t_phase
        if out["seconds"] > EPD_BUDGET_S:
            problems.append(f"{out['seconds']:.1f} s > {EPD_BUDGET_S} s")
        log(f"[epd] {card}: {json.dumps(out)}")
        if problems:
            raise AssertionError(f"phase 14: {problems}")
        out["records"] = records
        return out
    except BaseException:
        for p in procs:
            tail = p.tail() if hasattr(p, "tail") else ""
            if tail:
                log(f"[epd] {p.log_path.name} tail:\n{tail}")
        raise
    finally:
        for x in ws:
            x.stop()
        for p in reversed(procs):
            p.stop()



# ---------------------------------------------------------------------------
# Phase 15: the observability and coordination plane over etcd
# ---------------------------------------------------------------------------

OBS_MODEL = "llama3-1b"
OBS_DEVICE = "cuda"
OBS_ARGS = ["--page-size", "128", "--num-pages", "512", "--max-model-len",
            "1024", "--max-batch-size", "8", "--prefill-buckets",
            "128,256,512", "--max-prefill-tokens", "256",
            "--heartbeat-interval-s", "0.5"]
OBS_ENV = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1"}
# 1 in N lock acquisitions sampled on the cluster worker (what
# XLLM_LOCK_PROFILE_SAMPLE=N sets at import), so that its /metrics
# carries the lock-wait families.
OBS_LOCK_SAMPLE = 64
OBS_SECTIONS = ("span.write", "event.emit", "sse.assemble")
# The profiler-cost rounds, each the 8 chats direct to one child: on
# and off in turns, each first and last in turn.
OBS_COST_ROUNDS = ("profile_on", "profile_off", "profile_off", "profile_on",
                   "profile_on", "profile_off")
OBS_BUDGET_S = 90.0
# The shed round: a worker child at this cap, its slots held by streams
# the worker.slow_response_ms failpoint keeps in their handlers this long.
OBS_SHED_CAP = 2
OBS_SHED_HOLD_MS = 4000
WORKER_STAGES = ["received", "scheduled", "first_token", "finished"]


def shed_round(child, w, m_http: str, m_rpc: str, body: dict,
               card: str) -> dict:
    """Phase 15's shed round: ``child`` (a worker at ``OBS_SHED_CAP``)
    and ``w`` behind the master; the child's slots held by two streams
    the slow-response failpoint keeps in their handlers, then two chats
    through the master in turn (round robin offers the child one): each
    must be served (the master re-dispatches the child's 503 to ``w``),
    the child's ``xllm_worker_http_rejected_total`` must move and its
    front door be the native one. The child leaves the list after."""
    addr = child.line.split("http=")[1].split()[0]
    wait_for(lambda: addr in listed(m_rpc), 30.0,
             "phase 15: the shed child on the master's list")
    st, resp = _post(addr, "/admin/failpoint", {
        "name": "worker.slow_response_ms", "mode": "count",
        "n": OBS_SHED_CAP, "value": OBS_SHED_HOLD_MS})
    if st != 200:
        raise AssertionError(f"phase 15: arming the shed child: {st} {resp}")
    held = [{} for _ in range(OBS_SHED_CAP)]
    holders = [threading.Thread(target=_request, args=(
        addr, CHAT, dict(body), True, r)) for r in held]
    for t in holders:
        t.start()
    time.sleep(0.5)
    rows0 = _metric_rows(addr)
    rej0 = _metric(rows0, "xllm_worker_http_rejected_total")
    t0 = time.perf_counter()
    through = [_concurrent(m_http, [body])[0] for _ in range(2)]
    shed_s = time.perf_counter() - t0
    rows = _metric_rows(addr)
    for t in holders:
        t.join(120)
    out = {"rejected": _metric(rows, "xllm_worker_http_rejected_total")
           - rej0,
           "child_server": [dict(ls).get("kind") for (n, ls), v in
                            rows.items() if n == "xllm_worker_http_server"
                            and v == 1],
           "served_through_master": [r.get("status") for r in through],
           "ttft_ms_through_master": [_stream_rate(r)[0] for r in through],
           "held_served": [r.get("status") for r in held],
           "seconds": shed_s, "in_process_server": w._srv.kind}
    child.stop()
    wait_for(lambda: addr not in listed(m_rpc), 15.0,
             "phase 15: the shed child off the list")
    out["ok"] = (out["rejected"] >= 1 and out["child_server"] == ["native"]
                 and out["served_through_master"] == [200, 200]
                 and out["held_served"] == [200] * OBS_SHED_CAP)
    log(f"[obs] {card}: shed round: {json.dumps(out)}")
    return out


class EtcdProcess:
    """The native etcd v3 JSON-gateway server (``csrc/xllm_etcd.cpp``,
    built by ``build_etcd``) on ``port`` (0 = ephemeral); it prints
    ``LISTENING <port>`` once bound."""

    def __init__(self, binary: Path, port: int = 0) -> None:
        self.proc = subprocess.Popen([str(binary), str(port)],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        line = self.proc.stdout.readline()
        if not line.startswith("LISTENING "):
            self.stop()
            raise AssertionError(f"phase 15: xllm_etcd did not bind: "
                                 f"{line!r}")
        self.port = int(line.split()[1])
        self.address = f"127.0.0.1:{self.port}"

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=15)


def build_etcd() -> tuple:
    """The port's ``service/etcd_native.build_binary`` builds the native
    etcd server from the checkout with g++ (into ``build/native/``, once;
    a fresh binary is reused); returns (binary, seconds)."""
    from xllm_service_tpu_torch.service import etcd_native
    t0 = time.perf_counter()
    binary = etcd_native.build_binary()
    if binary is None:
        raise AssertionError("phase 15: the native etcd server did not "
                             "build (g++)")
    return Path(binary), time.perf_counter() - t0


def etcd_revision(addr: str) -> int:
    """The etcd server's current revision (a range's header)."""
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("POST", "/v3/kv/range", json.dumps(
            {"key": base64.b64encode(b"\0").decode()}),
            {"Content-Type": "application/json"})
        return int(json.loads(conn.getresponse().read())["header"]
                   ["revision"])
    finally:
        conn.close()


def pad_etcd_revision(client, addr: str, revision: int) -> int:
    """Write one scratch key until the server's revision passes
    ``revision``; returns the writes. An etcd client's watch resumes from
    the revision after the last it saw, so on a store restarted empty
    (its revisions counted from 1 again) the master's watches
    hear nothing until the new revision passes the old."""
    n = 0
    while etcd_revision(addr) <= revision:
        client.put("OBS:PAD", str(n))
        n += 1
    return n


def _stream_rate(result) -> tuple:
    """A 32-token streamed reply's (TTFT ms, decode tokens/s over its 31
    gaps)."""
    ttft = _ttft_ms(result)
    _, _, idx, _ = stream_tokens(result["frames"])
    return ttft, 31 / (result["times"][idx[-1]] - result["times"][idx[0]])


def _decode_steps_ms(addr: str, t0: float, t1: float) -> list:
    """The decode steps' ms a worker recorded between wall clocks t0 and
    t1 (its /admin/steptrace)."""
    status, st = _get(addr, "/admin/steptrace?n=4096")
    if status != 200:
        raise AssertionError(f"phase 15: steptrace of {addr}: {status}")
    return [r["step_ms"] for r in st["steps"]
            if r["kind"] == "decode" and t0 <= r["t_wall"] <= t1]


def obs_phase(torch, kernels, card: str) -> dict:
    """Phase 15: llama3-1b at full width and depth (16 layers, random
    bf16 weights from the engine's seed) behind the port's master
    over etcd, on the card.

    a. The native etcd server built from ``csrc/xllm_etcd.cpp`` with g++
       and started on an ephemeral port.
    b. The port's master (a child) on ``etcd://``; the port worker
       in-process on ``--store-addr etcd://...`` (lock contention sampled
       1 in ``OBS_LOCK_SAMPLE``): the seconds until it is listed.
    c. ``CHAT_ROUND``'s 8 streamed chats through the master at
       temperature 0, each with its ``x-request-id``: every master trace
       holds the worker-plane stages received, scheduled, first_token,
       finished in that order beside the service's; the delay from the
       worker's ``finished`` to the spans at the master; the path's
       kernels launched.
    d. The worker's ``/admin/steptrace`` sections (count and mean us of
       span.write, event.emit, sse.assemble) and its ``/metrics`` with
       the profiler's families, parsed.
    e. The profiler's cost: two standalone worker children, the default
       and ``XLLM_HOTPATH_PROFILE=0``, the same chats direct in the
       rounds of ``OBS_COST_ROUNDS``: decode step medians (each round's
       too) and tokens/s per stream.
    f. The etcd process killed: ``xllm_store_health`` 0 and chats still
       served through the master; the server restarted empty on its
       port: the seconds until the worker re-registered in it and is on
       the master's list.
    g. ``stop()``: the seconds until the worker is off the list.

    At most ``OBS_BUDGET_S`` on the script's clock."""
    from xllm_service_tpu_torch.obs import profiler
    from xllm_service_tpu_torch.runtime import worker
    from xllm_service_tpu_torch.service.etcd_store import EtcdStore
    from xllm_service_tpu_torch.utils import locks
    t_phase, t_wall0 = time.perf_counter(), time.time()
    logs = ROOT / "build" / "obs_logs"
    logs.mkdir(parents=True, exist_ok=True)
    out = {"card": card}
    procs, children, w, etcd = [], {}, None, None
    problems = []
    sample = locks.PROFILE_SAMPLE

    def spawn_child(tag: str, env: dict, args=()) -> None:
        try:
            children[tag] = RefProcess(
                ["xllm_service_tpu_torch.runtime.worker", "--model",
                 OBS_MODEL, "--device", OBS_DEVICE, *OBS_ARGS, *args],
                "XLLM_TORCH_WORKER_UP",
                logs / f"{tag}_child.log", timeout=240.0,
                env={**OBS_ENV, **env})
        except Exception as e:  # noqa: BLE001 — raised after the join
            children[tag + "_err"] = e
    starters = [threading.Thread(target=spawn_child, args=(tag, env))
                for tag, env in (("profile_on", {}),
                                 ("profile_off",
                                  {"XLLM_HOTPATH_PROFILE": "0"}))]
    try:
        for t in starters:
            t.start()
        # a.
        binary, out["etcd_build_s"] = build_etcd()
        etcd = EtcdProcess(binary)
        store = f"etcd://{etcd.address}"
        log(f"[obs] {card}: xllm_etcd built in {out['etcd_build_s']:.2f} s,"
            f" listening on {etcd.address}")
        # b.
        master, m_http, m_rpc = start_master(store, False,
                                             logs / "master.log")
        procs.append(master)
        locks.PROFILE_SAMPLE = OBS_LOCK_SAMPLE
        t0 = time.perf_counter()
        w, out["worker_boot_s"] = _start(
            worker, ["--model", OBS_MODEL, "--device", OBS_DEVICE,
                     *OBS_ARGS, "--store-addr", store,
                     "--service-addr", m_rpc], OBS_ENV)
        if type(w.store.inner) is not EtcdStore:
            raise AssertionError(f"phase 15: the worker's store is "
                                 f"{type(w.store.inner)}")
        if w._srv.kind != "native":
            problems.append(f"the worker's front door is {w._srv.kind}")
        wait_for(lambda: w.name in listed(m_rpc), 30.0,
                 "phase 15: the worker on the master's list")
        out["listed_s"] = time.perf_counter() - t0
        out["listed_after_start_s"] = out["listed_s"] - out["worker_boot_s"]
        # c.
        rng = random.Random(15)
        bodies = [_chat_body(_token_ids(w.tokenizer, rng, n))
                  for n in CHAT_ROUND]
        rids = [f"obs-{i}" for i in range(len(bodies))]
        kernels.reset_launch_counts()
        results = _concurrent(m_http, bodies,
                              [{"x-request-id": r} for r in rids])
        launches = kernels.launch_counts()
        out["through_master"] = chat_summary(
            [_stream_rate(r) for r in results])
        pending, delays = set(rids), {}
        traces = {}
        deadline = time.monotonic() + 15.0
        while pending and time.monotonic() < deadline:
            for rid in sorted(pending):
                status, tr = _get(m_http, f"/admin/trace/{rid}")
                if status != 200:
                    continue
                wk = [e for e in tr["events"] if e["plane"] == "worker"]
                fin = [e for e in wk if e["stage"] == "finished"]
                if fin:
                    delays[rid] = (time.time() - fin[0]["t_wall"]) * 1e3
                    traces[rid] = tr
                    pending.discard(rid)
            time.sleep(0.02)
        if pending:
            raise AssertionError(f"phase 15: no worker spans at the master "
                                 f"for {sorted(pending)}")
        for rid, tr in traces.items():
            wk = [e["stage"] for e in tr["events"] if e["plane"] == "worker"]
            svc = {e["stage"] for e in tr["events"]
                   if e["plane"] == "service"}
            if wk != WORKER_STAGES or not {"received", "finished"} <= svc:
                problems.append(f"trace {rid}: worker {wk}, service "
                                f"{sorted(svc)}")
        out["spans_at_master_after_finished_ms"] = {
            "median": _median(list(delays.values())),
            "max": max(delays.values()),
            "each": [delays[r] for r in rids]}
        out["launches"] = {k: launches.get(k, 0) for k in (
            "rope_kv_update_layer", "rope_prefill_kv_update_layer",
            "paged_decode_attention", "paged_prefill_attention")}
        if min(out["launches"].values()) <= 0:
            problems.append(f"a kernel of the path never launched: "
                            f"{out['launches']}")
        # The shed round's child joins the master after (c), so that the
        # 8 chats all reach the in-process worker; it boots during (d)-(e).
        shed_starter = threading.Thread(target=spawn_child, args=(
            "shed", {}, ["--store-addr", store, "--service-addr", m_rpc,
                         "--max-concurrency", str(OBS_SHED_CAP),
                         "--no-warmup"]))
        shed_starter.start()
        starters.append(shed_starter)
        log(f"[obs] {card}: listed {out['listed_s']:.2f} s after boot "
            f"began ({out['listed_after_start_s']:.2f} s after start()); "
            f"8 chats through the master {json.dumps(out['through_master'])}"
            f"; worker spans at the master ms after finished "
            f"{json.dumps(out['spans_at_master_after_finished_ms'])}")
        # d.
        def section_stats() -> dict:
            status, st = _get(w.name, "/admin/steptrace")
            if status != 200 or not st["sections"]:
                raise AssertionError(f"phase 15: steptrace sections "
                                     f"{status} {st and st['sections']}")
            stats = {}
            for name in OBS_SECTIONS:
                ms = [e["dur_ms"] for e in st["sections"]
                      if e["name"] == name and e["t_wall"] >= t_wall0]
                stats[name] = {"count": len(ms), "mean_us": (
                    1e3 * sum(ms) / len(ms) if ms else None)}
            return stats
        out["sections"] = section_stats()
        if not out["sections"]["span.write"]["count"] or \
                not out["sections"]["sse.assemble"]["count"]:
            problems.append(f"sections {out['sections']}")
        rows = _metric_rows(w.name)
        names = {n for n, _ in rows}
        want = {"xllm_service_hotpath_ms_bucket",
                "xllm_service_hotpath_ops_total", "xllm_lock_wait_ms_bucket",
                "xllm_lock_contended_total", "xllm_thread_cpu_seconds_total",
                "xllm_gc_pause_ms_bucket", "xllm_process_rss_bytes",
                "xllm_span_evictions_total", "xllm_http_conn_pool_hits_total"}
        out["metrics_missing"] = sorted(want - names)
        if out["metrics_missing"]:
            problems.append(f"/metrics lacks {out['metrics_missing']}")
        out["thread_cpu_s"] = {dict(ls)["root"]: v for (n, ls), v in
                               rows.items()
                               if n == "xllm_thread_cpu_seconds_total"}
        log(f"[obs] {card}: sections since the phase began "
            f"{json.dumps(out['sections'])}; CPU s per thread root "
            f"{json.dumps(out['thread_cpu_s'])}")
        # e.
        for t in starters:
            t.join(300)
        for tag in ("profile_on", "profile_off"):
            if tag not in children:
                raise AssertionError(f"phase 15: the {tag} child did not "
                                     f"start: {children.get(tag + '_err')}")
            procs.append(children[tag])
        addrs = {tag: children[tag].line.split("http=")[1].split()[0]
                 for tag in ("profile_on", "profile_off")}
        cost = {tag: {"steps": [], "streams": [], "round_step_ms": []}
                for tag in addrs}
        for tag in OBS_COST_ROUNDS:
            t0 = time.time()
            res = _concurrent(addrs[tag], bodies)
            steps = _decode_steps_ms(addrs[tag], t0, time.time())
            cost[tag]["streams"] += [_stream_rate(r) for r in res]
            cost[tag]["steps"] += steps
            cost[tag]["round_step_ms"].append(_median(steps))
        out["profiler_cost"] = {
            tag: {"decode_step_ms_median": _median(c["steps"]),
                  "decode_steps": len(c["steps"]),
                  "round_decode_step_ms_median": c["round_step_ms"],
                  **chat_summary(c["streams"])}
            for tag, c in cost.items()}
        on, off = (out["profiler_cost"][t]["decode_step_ms_median"]
                   for t in ("profile_on", "profile_off"))
        out["profiler_cost"]["decode_step_ms_delta"] = on - off
        log(f"[obs] {card}: profiler cost, XLLM_HOTPATH_PROFILE on vs off:"
            f" decode step median ms {on} vs {off}; decode tokens/s per "
            f"stream median "
            f"{out['profiler_cost']['profile_on']['decode_tokens_per_s_median']}"
            f" vs "
            f"{out['profiler_cost']['profile_off']['decode_tokens_per_s_median']}")
        # e2. The shed round.
        shed_starter.join(300)
        if "shed" not in children:
            raise AssertionError(f"phase 15: the shed child did not start: "
                                 f"{children.get('shed_err')}")
        procs.append(children["shed"])
        out["shed"] = shed_round(children["shed"], w, m_http, m_rpc,
                                 bodies[0], card)
        if not out["shed"]["ok"]:
            problems.append(f"shed round {out['shed']}")
        # f.
        old_revision = etcd_revision(etcd.address)
        etcd.stop()
        t0 = time.perf_counter()
        wait_for(lambda: _metric(_metric_rows(w.name),
                                 "xllm_store_health") == 0, 15.0,
                 "phase 15: the worker's store health 0")
        out["outage_seen_s"] = time.perf_counter() - t0
        during = _concurrent(m_http, bodies[:2])
        out["served_during_outage"] = [_stream_rate(r)[0] for r in during]
        etcd = EtcdProcess(binary, etcd.port)
        t0 = time.perf_counter()
        client = EtcdStore(etcd.address)
        key = f"XLLM:DEFAULT:{w.name}"
        wait_for(lambda: client.get(key) is not None, 20.0,
                 "phase 15: the re-registration in the restarted store")
        out["reregistered_s"] = time.perf_counter() - t0
        out["etcd_revision_padding"] = pad_etcd_revision(
            client, etcd.address, old_revision)
        wait_for(lambda: w.name in listed(m_rpc) and _metric(
            _metric_rows(w.name), "xllm_store_health") == 2, 20.0,
            "phase 15: the worker back on the master's list")
        out["relisted_s"] = time.perf_counter() - t0
        out["sections_after_outage"] = section_stats()
        if not out["sections_after_outage"]["event.emit"]["count"]:
            problems.append("no event.emit section after the outage")
        log(f"[obs] {card}: etcd killed: store health 0 after "
            f"{out['outage_seen_s']:.2f} s, TTFT ms during the outage "
            f"{out['served_during_outage']}; restarted empty: re-registered "
            f"after {out['reregistered_s']:.2f} s, on the list after "
            f"{out['relisted_s']:.2f} s (revision padded by "
            f"{out['etcd_revision_padding']} writes); sections "
            f"{json.dumps(out['sections_after_outage'])}")
        # g.
        t0 = time.perf_counter()
        w.stop()
        wait_for(lambda: w.name not in listed(m_rpc), 15.0,
                 "phase 15: the worker off the list after stop()")
        out["unlisted_after_stop_s"] = time.perf_counter() - t0
        if client.get(key) is not None:
            problems.append("the registration outlived stop()")
        # The profiler's books: one per thread that ever recorded, which
        # the front door's handler pool bounds.
        out["thread_books"] = profiler.thread_books()
        out["handler_pool_cap"] = w._srv._pool_cap
        out["seconds"] = time.perf_counter() - t_phase
        if out["seconds"] > OBS_BUDGET_S:
            problems.append(f"{out['seconds']:.1f} s > {OBS_BUDGET_S} s")
        log(f"[obs] {card}: {json.dumps(out)}")
        if problems:
            raise AssertionError(f"phase 15: {problems}")
        return out
    except BaseException:
        for p in list(procs) + [c for c in children.values()
                                if isinstance(c, RefProcess)]:
            tail = p.tail()
            if tail:
                log(f"[obs] {p.log_path.name} tail:\n{tail}")
        raise
    finally:
        locks.PROFILE_SAMPLE = sample
        for t in starters:
            t.join(300)
        if w is not None:
            w.stop()
        for p in reversed(procs):
            p.stop()
        for c in children.values():
            if isinstance(c, RefProcess) and c not in procs:
                c.stop()
        if etcd is not None:
            etcd.stop()


# ---------------------------------------------------------------------------
# Phase 16: Gemma-3-12B (per-layer rope bases, D = 256) and Gemma-2-9B
# ---------------------------------------------------------------------------

GEMMA3_MODEL = "gemma3-12b"
GEMMA2_MODEL = "gemma2-9b"
GEMMA_DEVICE = "cuda"
GEMMA3_WINDOW = 1024          # Gemma-3's local layers
GEMMA2_SOFTCAP = 50.0         # Gemma-2's attention logit soft-cap
# The logits check's depth: Gemma-3-12B's first six layers, five local
# (the 1024-token window) and one global.
GEMMA_CHECK_LAYERS = 6
# Gemma-2-9B's served depth (of 42, alternating local and global): the
# soft-capped D = 256 path at published widths, one served batch.
GEMMA2_SERVE_LAYERS = 8
# The served pool: 4 slots of 2,048 tokens (16 pages of 128 each, and
# the NULL page), buckets 128/256/512. The prefill budget is 3 + 256:
# the warmup ladder holds the pairs (B, T) with (B - 1) + T within the
# budget (or T alone), and a prefill-first step packs windows by their
# sum and pads to the longest one's bucket, so at a budget of 512 a 300-
# and a 200-token window (B = 2, T = 512) were captured after warmup;
# at 259 only a lone first window reaches T = 512.
GEMMA_ARGS = ["--page-size", "128", "--num-pages", "72",
              "--max-model-len", "2048", "--max-batch-size", "4",
              "--prefill-buckets", "128,256,512",
              "--max-prefill-tokens", "259"]
# Two of the four prompts past the 1024-token window.
GEMMA_PLAN = (("/v1/chat/completions", True, 1400),
              ("/v1/completions", False, 300),
              ("/v1/chat/completions", True, 1150),
              ("/v1/completions", False, 200))
# (tag, ragged, write-then-attend, layers): both write orders at all 48
# layers; the ragged step (K5's launches) at the first 6 layers (5
# local, 1 global) of the same weights, since its warmup captures twice
# the split path's graphs (87.3 s at 48 layers on an H100, against 38.1
# s for the split path).
GEMMA_PATHS = (("split", False, True, 48),
               ("attend_then_write", False, False, 48),
               ("ragged", True, True, 6))


def gemma_kernel_rows(torch) -> list:
    """Phase 3's D = 256 records, the forms phase 16 serves: Gemma-3-12B's
    (16 query heads, Hkv 8; 16 pages a row, contexts past the 1024-token
    window of its local layers) fused rope writers, K3, K3', K4, K4' and
    K5, and K3 / K4 with Gemma-2-9B's soft-cap 50."""
    from xllm_service_tpu_torch.config import ModelConfig
    from xllm_service_tpu_torch.ops import attention, rope
    from xllm_service_tpu_torch.ops.kernels import (kv_update,
                                                    paged_attention,
                                                    prefill_attention,
                                                    ragged_attention)
    long_ctx = (117, 1205, 1298, 2011, 150, 1860, 0, 1390)
    g3 = KernelBench(torch, ModelConfig.gemma3_12b(), "cuda",
                     suffix="_gemma3", mp=16)
    g3.rope_decode_writer(kv_update, rope)
    g3.rope_prefill_writer(kv_update, rope)
    g3.windowed_attention(
        paged_attention, prefill_attention, ragged_attention, attention,
        ({"sliding_window": GEMMA3_WINDOW}, {}), "sdpa_without_window_ms",
        ctx_list=long_ctx, prefill_starts=(0, 1280, 1024, 0),
        ragged_ctx=tuple(c for c in long_ctx if c), ragged_start=1152,
        lib_window=False, sliding_window=GEMMA3_WINDOW)
    rows = g3.results
    del g3
    free_device_memory(torch)
    g2 = KernelBench(torch, ModelConfig.gemma2_9b(), "cuda",
                     suffix="_gemma2", mp=16)
    g2.windowed_attention(
        paged_attention, prefill_attention, ragged_attention, attention,
        ({"logits_soft_cap": GEMMA2_SOFTCAP},
         {"logits_soft_cap": GEMMA2_SOFTCAP, "sliding_window": 4096}),
        "sdpa_without_softcap_ms",
        forms=("paged_decode_attention", "paged_prefill_attention"),
        ctx_list=long_ctx, prefill_starts=(0, 1280, 1024, 0),
        logits_soft_cap=GEMMA2_SOFTCAP)
    rows += g2.results
    del g2
    free_device_memory(torch)
    return rows


def gemma_forward_check(torch, cfg, device) -> tuple:
    """Gemma-3-12B cut to ``cfg.num_layers`` through the kernels (bf16
    on the card) against the plain path (float32 on the CPU, the same
    weights): a 1,100-token prefill (past the local window) in
    write-then-attend order, a decode step, a ragged step (that row
    decoding at 1,100 beside a fresh 40-token window), then on a fresh
    pool the attend-then-write order (256- and 200-token windows, 40 and
    30 more at q_start > 0, a decode step). Returns (the relative L2
    errors, the largest absolute logit error)."""
    from xllm_service_tpu_torch.models import transformer as tf
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = tf.init_params(cfg, gen, dev)
    cpu_params = cpu_float(params)
    P, ps, B, T = 24, 128, 2, 1152
    pt = torch.arange(1, 1 + 2 * 10, dtype=torch.int32).reshape(2, 10)
    rng = random.Random(16)

    def toks(n):
        return [rng.randrange(3, 259) for _ in range(n)]
    tokens = torch.tensor([toks(T)])
    one = torch.zeros(1, dtype=torch.int32)
    long_len = torch.tensor([1100], dtype=torch.int32)
    rg_tokens = torch.zeros(B, 64, dtype=torch.long)
    rg_tokens[1, :40] = torch.tensor(toks(40))
    rg_start = torch.tensor([1100, 0], dtype=torch.int32)
    rg_lens = torch.tensor([1, 40], dtype=torch.int32)
    start = torch.zeros(B, dtype=torch.int32)
    aw_first = torch.tensor([toks(256) for _ in range(B)])
    aw_lens0 = torch.tensor([256, 200], dtype=torch.int32)
    aw_tokens = torch.tensor([toks(64) for _ in range(B)])
    aw_lens = torch.tensor([40, 30], dtype=torch.int32)
    results = []
    with torch.inference_mode():
        for device, p, dtype in ((dev, params, tf.torch_dtype(cfg)),
                                 (torch.device("cpu"), cpu_params,
                                  torch.float32)):
            kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
            pre, kv = tf.forward_prefill(p, cfg, tokens.to(device),
                                         one.to(device), long_len.to(device),
                                         kv, pt[:1].to(device))
            nxt = pre.argmax(-1) if not results else results[0][0].argmax(-1)
            dec, kv = tf.forward_decode(
                p, cfg, nxt.to(device), long_len.to(device),
                torch.ones(1, dtype=torch.bool, device=device), kv,
                pt[:1].to(device))
            rg_tokens[0, 0] = (dec if not results else results[0][1]).argmax(
                -1)[0].item()
            rag, kv = tf.forward_prefill(p, cfg, rg_tokens.to(device),
                                         rg_start.to(device),
                                         rg_lens.to(device), kv,
                                         pt.to(device), ragged=True)
            kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
            first, kv = tf.forward_prefill(
                p, cfg, aw_first.to(device), start.to(device),
                aw_lens0.to(device), kv, pt.to(device),
                write_then_attend=False)
            second, kv = tf.forward_prefill(
                p, cfg, aw_tokens.to(device), aw_lens0.to(device),
                aw_lens.to(device), kv, pt.to(device),
                write_then_attend=False)
            nxt = second.argmax(-1) if not results else \
                results[0][4].argmax(-1)
            aw_dec, kv = tf.forward_decode(
                p, cfg, nxt.to(device), (aw_lens0 + aw_lens).to(device),
                torch.ones(B, dtype=torch.bool, device=device), kv,
                pt.to(device), write_then_attend=False)
            results.append(tuple(x.float().cpu() for x in (
                pre, dec, rag, first, second, aw_dec)))
            del kv
    del params, cpu_params
    return logit_errors(torch, results)


def gemma_phase(torch, kernels, card: str) -> dict:
    """Phase 16: the first served D = 256 models.

    a. Gemma-3-12B at its published widths cut to ``GEMMA_CHECK_LAYERS``
       (five local layers, one global; per-layer rope bases): the
       kernels in bf16 against the float32 plain path
       (``gemma_forward_check``), relative L2 under ``FORWARD_REL_L2``.
    b. Gemma-3-12B at its published widths on random bf16 weights made
       on the card from seed 0, served in-process by the worker in each
       of ``GEMMA_PATHS`` (the split path and attend-then-write at all 48
       layers, the ragged step at the first 6) with ``GEMMA_PLAN``'s
       four requests (two prompts past the window, 32 new tokens at
       temperature 0) on ``GEMMA_ARGS``' pool: every step's launches, no
       capture after warmup, TTFT, decode step median, tokens/s per
       stream; attend-then-write's streams against the split path's
       under the margins rule (limit: 10 x (a)'s largest logit
       error).
    c. Gemma-2-9B at its published widths and ``GEMMA2_SERVE_LAYERS``
       layers (random bf16 weights from the engine's seed), phase 5's
       requests in the split path: the soft-capped D = 256 kernels."""
    from xllm_service_tpu_torch.config import ModelConfig
    from xllm_service_tpu_torch.models import transformer as tf
    t_phase = time.perf_counter()
    out = {"card": card}
    cfg = ModelConfig.gemma3_12b()
    cut = dataclasses.replace(
        cfg, num_layers=GEMMA_CHECK_LAYERS,
        layer_sliding=cfg.layer_sliding[:GEMMA_CHECK_LAYERS])
    # a.
    t0 = time.perf_counter()
    rels, err = gemma_forward_check(torch, cut, GEMMA_DEVICE)
    free_device_memory(torch)
    out["check"] = {"layers": GEMMA_CHECK_LAYERS,
                    "local_layers": sum(cut.layer_sliding),
                    "rel_l2": rels, "max_abs_logit_err": err,
                    "seconds": time.perf_counter() - t0}
    log(f"[gemma] {card}: gemma3-12b x{GEMMA_CHECK_LAYERS} rel L2 (kernels "
        f"bf16 vs plain fp32): write-then-attend prefill/decode/ragged "
        f"{rels[:3]}, attend-then-write prefill/prefill/decode {rels[3:]};"
        f" largest logit error {err}")
    if max(rels) > FORWARD_REL_L2:
        raise AssertionError(f"phase 16: gemma3-12b logits rel L2 "
                             f"{max(rels)} > {FORWARD_REL_L2}")
    # b.
    t0 = time.perf_counter()
    g = torch.Generator(device=GEMMA_DEVICE).manual_seed(0)
    params = tf.init_params(cfg, g, GEMMA_DEVICE)
    torch.cuda.synchronize()
    leaves = [params["embed"], params["final_norm"],
              *params["layers"].values()]
    out["init_s"] = time.perf_counter() - t0
    out["param_bytes"] = sum(t.numel() * t.element_size() for t in leaves)
    out["params"] = sum(t.numel() for t in leaves)
    split = {"ragged": False, "write_then_attend": True}
    served, tok = {}, {}
    for tag, ragged, wta, layers in GEMMA_PATHS:
        on_engine = None
        if layers == cfg.num_layers and tag != "split":
            def on_engine(eng, tok_x, path={"ragged": ragged,
                                            "write_then_attend": wta},
                          tag=tag):
                return divergence_margins(torch, eng, [(
                    tag, tok["split"], split, tok_x, path,
                    served["split"]["prompts"])], err)
        # A cut depth serves the first layers of the same weights (views).
        served[tag] = serve(
            torch, kernels, GEMMA3_MODEL, GEMMA_DEVICE, ragged=ragged,
            write_then_attend=wta, tag=f"_gemma3_{tag}",
            params=dict(params, layers={k: v[:layers] for k, v in
                                        params["layers"].items()}),
            model_cfg=dataclasses.replace(
                cfg, num_layers=layers,
                layer_sliding=cfg.layer_sliding[:layers]),
            on_engine=on_engine, engine_args=GEMMA_ARGS, profile=False,
            plan=GEMMA_PLAN)
        tok[tag] = served[tag].pop("tokens")
    for tag in served:
        served[tag].pop("prompts")
        served[tag].pop("params", None)
    margins = [m for tag in served for m in (served[tag].pop("on_engine")
                                             or [])]
    same = {}
    for tag, _, _, layers in GEMMA_PATHS:
        if tag == "split" or layers != cfg.num_layers:
            continue
        pairs = [(x, y) for n in tok["split"]
                 for x, y in zip(tok["split"][n], tok[tag].get(n, []))]
        same[tag] = sum(x == y for x, y in pairs) / len(pairs)
    del params, leaves
    free_device_memory(torch)
    out.update(serve=served, margins=margins, equal_token_share=same,
               served_s=time.perf_counter() - t0)
    if any(m["verdict"] == "fault" for m in margins):
        raise AssertionError(f"phase 16: a gemma3-12b stream diverged past "
                             f"the margins rule: {margins}")
    s = served["split"]
    log(f"[gemma] {card}: gemma3-12b x{cfg.num_layers} layers, "
        f"{out['params']} parameters ({out['param_bytes']} B) made in "
        f"{out['init_s']:.2f} s; TTFT ms split {s['ttft_ms_streams']}, "
        f"attend-then-write "
        f"{served['attend_then_write']['ttft_ms_streams']}, ragged (6 "
        f"layers) {served['ragged']['ttft_ms_streams']}; decode step ms "
        f"median split {s['decode_step_ms_median']}, attend-then-write "
        f"{served['attend_then_write']['decode_step_ms_median']}, ragged "
        f"(6 layers) {served['ragged']['decode_step_ms_median']}; tokens/s "
        f"per stream split {s['decode_tokens_per_s_streams']}; equal tokens "
        f"{same}; margins {json.dumps(margins)}")
    # c.
    t0 = time.perf_counter()
    cfg2 = ModelConfig.gemma2_9b()
    cut2 = dataclasses.replace(
        cfg2, num_layers=GEMMA2_SERVE_LAYERS,
        layer_sliding=cfg2.layer_sliding[:GEMMA2_SERVE_LAYERS])
    out["gemma2"] = serve(torch, kernels, GEMMA2_MODEL, GEMMA_DEVICE,
                          ragged=False, tag="_gemma2", model_cfg=cut2,
                          engine_args=GEMMA_ARGS, profile=False)
    out["gemma2"].pop("tokens")
    out["gemma2"].pop("prompts")
    out["gemma2"].pop("params", None)
    out["gemma2"].pop("on_engine", None)
    out["gemma2_s"] = time.perf_counter() - t0
    free_device_memory(torch)
    out["seconds"] = time.perf_counter() - t_phase
    g2 = out["gemma2"]
    log(f"[gemma] {card}: gemma2-9b x{GEMMA2_SERVE_LAYERS} layers: TTFT ms "
        f"{g2['ttft_ms_streams']}, decode step ms median "
        f"{g2['decode_step_ms_median']}; phase 16 {out['seconds']:.1f} s "
        f"(check {out['check']['seconds']:.1f}, gemma3 served "
        f"{out['served_s']:.1f}, gemma2 {out['gemma2_s']:.1f})")
    return out


# ---------------------------------------------------------------------------
# Phase 17: parallelism on one card (gloo, eager steps)
# ---------------------------------------------------------------------------

PAR_DEVICE = "cuda"
# The shape model of the *_tp2 records: llama3-1b's rank at tp = 2.
PAR_TP2_MODEL = "llama3-1b-tp2"
PAR_ENV = {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
           "XLLM_CUDA_GRAPHS": "0"}
# Phase 5's flags; eager steps (a mesh runs no graphs), no warmup.
PAR_ARGS = SERVE_ARGS + ["--dist-backend", "gloo", "--no-warmup"]
PAR_RING_CHARS = 900                    # one ring prompt: > 512, <= 1024
PAR_DS_LONG = (1800, 1790)              # DeepSeek prompts, 512-token windows
PAR_BUDGET_S = 150.0


def _par_engine_cfg(**kw):
    from xllm_service_tpu_torch.config import EngineConfig
    base = dict(page_size=128, num_pages=512, max_model_len=1024,
                max_batch_size=8, prefill_buckets=(128, 256, 512),
                max_prefill_tokens=256, cuda_graphs=False,
                ragged_attn=False, write_then_attend=True,
                enable_prefix_cache=False)
    base.update(kw)
    return EngineConfig(**base)


def _par_mesh(spec, cfg, ecfg):
    """Rank 0 of a mesh on this card (this process) and its followers,
    started as a worker starts them; returns (engine, mesh, processes)."""
    from xllm_service_tpu_torch.runtime import ranks
    from xllm_service_tpu_torch.runtime.engine import Engine
    guard_child_argv([sys.executable, "-m",
                      "xllm_service_tpu_torch.runtime.ranks"])
    mesh, procs = ranks.start_mesh(spec, cfg, ecfg, PAR_DEVICE, "gloo")
    try:
        return Engine(cfg, ecfg, device=PAR_DEVICE, mesh=mesh), mesh, procs
    except BaseException:
        _par_close(None, mesh, procs)
        raise


def _par_close(eng, mesh, procs) -> None:
    from xllm_service_tpu_torch.runtime import ranks
    try:
        ranks.stop_followers(mesh)
    finally:
        ranks.stop_processes(procs)
        mesh.close()


def _par_collectives(reports, forwards: int) -> list:
    """Per rank: its kernel launches, collectives a forward and the
    staged all-reduce's ms."""
    out = []
    for rep in reports:
        c, s = rep["collectives"], rep["staged_s"]
        n_ar = c.get("all_reduce", 0)
        out.append({
            "rank": rep["rank"],
            "launches": {k: v for k, v in rep["launches"].items() if v},
            "collectives_per_forward": (sum(c.values()) / forwards
                                        if forwards else None),
            "by_op": c,
            "staged_all_reduce_ms": (1e3 * s.get("all_reduce", 0.0) / n_ar
                                     if n_ar else None),
            "staged_ms_by_op": {k: 1e3 * v for k, v in s.items()}})
    return out


def _par_same_launches(reports) -> None:
    """Every rank launched each hand-written kernel as often as rank 0
    (each runs the same forwards at the shard's shapes)."""
    base = reports[0]["launches"]
    for rep in reports[1:]:
        if rep["launches"] != base:
            raise AssertionError(f"rank {rep['rank']} launched "
                                 f"{rep['launches']}, rank 0 {base}")


def _rel_l2(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ref_logits(torch, params, cfg, ids, next_id, windows=None):
    """Unsharded logits after ``ids`` (prefilled in ``windows`` tokens at
    a time, default whole) and after ``next_id`` (one decode), on the
    card in write-then-attend."""
    from xllm_service_tpu_torch.models import transformer as tf
    dev = torch.device(PAR_DEVICE)
    ps, T = 128, len(ids)
    pages = -(-(T + 1) // ps)
    kv = tf.init_kv_cache(cfg, pages + 1, ps, dev)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    i32 = dict(dtype=torch.int32, device=dev)
    step = windows or T
    for s in range(0, T, step):
        chunk = ids[s:s + step]
        logits, kv = tf.forward_prefill(
            params, cfg, torch.tensor([chunk], device=dev),
            torch.tensor([s], **i32), torch.tensor([len(chunk)], **i32), kv,
            table, write_then_attend=True)
    dec = None
    if next_id is not None:
        dec, _ = tf.forward_decode(
            params, cfg, torch.tensor([next_id], device=dev),
            torch.tensor([T], **i32),
            torch.ones(1, dtype=torch.bool, device=dev), kv, table,
            write_then_attend=True)
        dec = dec[0].float().cpu().numpy()
    return logits[0].float().cpu().numpy(), dec


def _par_streams(eng, reqs, steplog, max_steps: int = 400):
    """Serve ``reqs`` (rid, ids, max_tokens) greedily on ``eng`` (whose
    ``step`` ``steplog`` wraps), all added before the first step;
    returns (tokens by rid, the steps' rows)."""
    from xllm_service_tpu_torch.runtime.engine import EngineRequest
    from xllm_service_tpu_torch.utils.types import SamplingParams
    for rid, ids, n in reqs:
        eng.add_request(EngineRequest(rid, list(ids), sampling=SamplingParams(
            max_tokens=n, temperature=0.0, ignore_eos=True)))
    toks = {rid: [] for rid, _, _ in reqs}
    n0 = len(steplog.rows)
    for _ in range(max_steps):
        if not eng.has_work():
            break
        for o in eng.step():
            toks[o.request_id].extend(o.new_token_ids)
    return toks, steplog.rows[n0:]


def _par_per_forward(rows, launches) -> dict:
    """Each kernel's launches per forward of its kind: a prefill
    kernel's per prefill forward, a decode kernel's per decode forward."""
    dec = sum(r["decode_forwards"] for r in rows)
    pre = sum(int(r["kind"] in ("prefill", "mixed")) for r in rows)
    return {k: v / (pre if "prefill" in k else dec)
            for k, v in launches.items()
            if v and (pre if "prefill" in k else dec)}


def _par_margins(torch, params, cfg, prompts, tok_a, tok_b, err, tag):
    """Each stream's first divergent token between two runs, with the
    unsharded top-2 margin there: drift under 10 x ``err``, else a
    fault (``divergence_margins``'s rule)."""
    import numpy as np
    out = []
    for rid in sorted(tok_a):
        a, b = tok_a[rid], tok_b.get(rid, [])
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None and len(a) == len(b):
            continue
        if i is None:
            raise AssertionError(f"{tag}: {rid} has {len(b)} tokens, "
                                 f"want {len(a)}")
        logits, _ = _ref_logits(torch, params, cfg, prompts[rid] + a[:i],
                                None)
        top = np.sort(logits)[-2:]
        margin = float(top[1] - top[0])
        out.append({"pair": tag, "request": rid, "position": i,
                    "served": [a[i], b[i]], "margin": margin,
                    "limit": 10 * err,
                    "verdict": "fault" if margin > 10 * err else "drift"})
    bad = [m for m in out if m["verdict"] == "fault"]
    if bad:
        raise AssertionError(f"{tag}: streams diverge at a wide margin: "
                             f"{bad}")
    return out


def check_ring_step(row, census, layers: int) -> dict:
    """The ring step: one eager ``prefill_ring`` step in the census, a
    prefill forward that launched the fused rope writer in its pool-less
    form once per layer and K7 once, and no other kernel (its attention
    is the ring's online softmax). Returns its launches."""
    want = {"rope_prefill_kv_update_layer": layers,
            "paged_prefill_kv_update": 1}
    got = {k: v for k, v in row["launches"].items() if v}
    if census != {"graphs_off": 1} or row["kind"] != "prefill" or \
            row["forwards"] != 1 or got != want:
        raise AssertionError(f"the ring step: census {census}, row {row}, "
                             f"want launches {want}")
    return got


def parallel_phase(torch, kernels, card: str, err: float,
                   err_mla: float) -> dict:
    """Phase 17: the sharded paths on the one card, two ranks each over
    gloo (collectives staged through the host), eager steps.

    a. llama3-1b at full width and depth at tp = 2 behind a worker
       (``--tp 2 --dist-backend gloo``; rank 1 a child it starts): phase
       5's four requests; every step's launches exactly (the fused
       writer and K3/K4 at the shard's 16 query and 4 KV heads), rank 1
       launching what rank 0 did; collectives a forward and the staged
       all-reduce's ms; rank 0's prefill and decode logits against the
       unsharded forward on the same weights (rel L2 under
       ``FORWARD_REL_L2``); the four streams against an unsharded eager
       engine's (equal, or drift under the margins rule), and the eager
       decode step beside the unsharded eager one.
    b. sp = 2 on llama3-1b: a ~900-token prompt in one ``prefill_ring``
       step (the step census; per rank the fused rope writer in its
       pool-less form x 16 and K7 once, nothing else), its first token
       and its logits against the unsharded engine's chunked windows;
       the ring step's ms.
    c. DeepSeek-V2-Lite at its published widths and
       ``DEEPSEEK_SERVE_LAYERS`` layers at ep = 2 (32 experts a rank):
       four requests, then two ~1,800-token prompts in 512-token
       windows; streams and ``moe_dropped`` against the unsharded
       engine's on the same weights, every step's launches exactly, and
       the MLA prefill calls that took ``mha_prefill_chunked`` (past the
       64 MiB cut) counted per rank, with the chunked form's largest
       error against the dense ``mha_prefill`` at such a call's shape.
    """
    import dataclasses as dc
    import numpy as np
    from xllm_service_tpu_torch.config import ModelConfig
    from xllm_service_tpu_torch.models import transformer as tf
    from xllm_service_tpu_torch.ops import attention
    from xllm_service_tpu_torch.parallel.mesh import MeshSpec
    from xllm_service_tpu_torch.runtime import ranks, worker
    from xllm_service_tpu_torch.runtime.engine import Engine
    t_phase = time.perf_counter()
    cfg = ModelConfig.llama3_1b()
    out = {}

    # a. tp = 2 behind a worker.
    t0 = time.perf_counter()
    argv = ["--model", "llama3-1b", "--device", PAR_DEVICE, *PAR_ARGS,
            "--tp", "2"]
    guard_child_argv(argv)
    w, build_s = _start(worker, argv, PAR_ENV)
    eng = w.engine
    if eng.mesh is None or eng.shard_cfg.num_heads != 16 or \
            eng.shard_cfg.num_kv_heads != 4:
        raise AssertionError(f"tp=2 rank 0 holds {eng.shard_cfg}")
    steplog = StepLog(eng, kernels)
    try:
        rng = random.Random(0)
        warm = {}
        _request(w.name, "/v1/completions",
                 {"prompt": _prompt(rng, 64), "max_tokens": 4,
                  "temperature": 0.0}, False, warm)
        if warm["status"] != 200:
            raise AssertionError(f"warm-up request failed: {warm}")
        bodies = serve_bodies(rng)
        # Calls on every rank take the engine lock, as the worker's
        # steps do: one broadcast at a time on the world.
        with w._engine_lock:
            ranks.control(eng, "reset")
        steplog.clear()
        results, wall = run_concurrent(w.name, bodies)
        with w._engine_lock:
            reps = ranks.control(eng, "report")
        rows = list(steplog.rows)
        tokens = {n: list(t) for n, t in steplog.tokens.items()}
        prompts = {n: steplog.prompts[n] for n in tokens}
        n_max = max(prompts)
        with w._engine_lock:
            lp, ld = ranks.control(eng, "forward_logits", prompts[n_max],
                                   tokens[n_max][0])
            # The staged all-reduce alone at a decode step's rows and at
            # a 512-token window.
            ar_ms = ranks.control(eng, "all_reduce_ms",
                                  [(8, 1, cfg.hidden_size),
                                   (1, 512, cfg.hidden_size)])
    finally:
        w.stop()
    del w, eng, steplog
    free_device_memory(torch)
    check_replies(SERVE_PLAN, results)
    check_step_launches(rows, reps[0]["launches"], cfg.num_layers, False,
                        True, False)
    _par_same_launches(reps)
    forwards = sum(r["forwards"] for r in rows)
    gen = torch.Generator(device=PAR_DEVICE).manual_seed(0)
    full = tf.init_params(cfg, gen, PAR_DEVICE)
    rp, rd = _ref_logits(torch, full, cfg, prompts[n_max], tokens[n_max][0])
    rel = {"prefill": _rel_l2(lp, rp), "decode": _rel_l2(ld, rd)}
    if max(rel.values()) > FORWARD_REL_L2:
        raise AssertionError(f"tp=2 logits rel L2 {rel} over "
                             f"{FORWARD_REL_L2}")
    ref_eng = Engine(cfg, _par_engine_cfg(), params=full, device=PAR_DEVICE)
    reqs = [(f"n{n}", prompts[n], 32) for n in sorted(prompts)]
    ref_tok, ref_rows = _par_streams(ref_eng, reqs,
                                     StepLog(ref_eng, kernels))
    del ref_eng
    free_device_memory(torch)
    mine = {f"n{n}": tokens[n] for n in prompts}
    margins = _par_margins(torch, full, cfg,
                           {f"n{n}": prompts[n] for n in prompts}, ref_tok,
                           mine, err, "tp2")
    launches = {k: v for k, v in reps[0]["launches"].items() if v}
    decode_ms = _median([r["ms"] for r in rows if r["kind"] == "decode"])
    ref_decode_ms = _median([r["ms"] for r in ref_rows
                             if r["kind"] == "decode"])
    out["tp2"] = {
        "worker_build_s": build_s, "wall_s": wall,
        "launches": reps[0]["launches"],
        "launches_per_forward": _par_per_forward(rows, launches),
        "forwards": forwards,
        "staged_all_reduce_ms_by_shape": ar_ms,
        "ranks": _par_collectives(reps, forwards),
        "logits_rel_l2": rel,
        "equal_streams": sum(mine[k] == ref_tok[k] for k in ref_tok),
        "margins": margins,
        "eager_decode_step_ms_median": decode_ms,
        "unsharded_eager_decode_step_ms_median": ref_decode_ms,
        "prefill_step_ms_median": _median(
            [r["ms"] for r in rows if r["kind"] == "prefill"]),
        "seconds": time.perf_counter() - t0}
    log(f"[parallel] {card}: tp=2 {json.dumps(out['tp2'])}")

    # b. sp = 2: one long prompt in a ring step.
    t0 = time.perf_counter()
    eng, mesh, procs = _par_mesh(MeshSpec(sp=2), cfg, _par_engine_cfg(
        sp=2, max_prefill_tokens=512))
    try:
        ids = [int(b) + 3 for b in
               _prompt(random.Random(7), PAR_RING_CHARS).encode()]
        ranks.control(eng, "reset")
        ring_tok, ring_rows = _par_streams(eng, [("ring", ids, 4)],
                                           StepLog(eng, kernels))
        reps = ranks.control(eng, "report")
        census = eng.capture_report()["prefill_ring"]["eager_steps"]
        T = eng._bucket(-(-len(ids) // 2)) * 2
        lr = ranks.control(eng, "ring_logits", ids, T)
    finally:
        _par_close(eng, mesh, procs)
    del eng
    free_device_memory(torch)
    ring_row = ring_rows[0]
    got = check_ring_step(ring_row, census, cfg.num_layers)
    _par_same_launches(reps)
    rl, _ = _ref_logits(torch, full, cfg, ids, None, windows=512)
    rel_ring = _rel_l2(lr, rl)
    if rel_ring > FORWARD_REL_L2:
        raise AssertionError(f"ring logits rel L2 {rel_ring}")
    first_ref = int(np.argmax(rl))
    ring_margin = None
    if ring_tok["ring"][0] != first_ref:
        top = np.sort(rl)[-2:]
        ring_margin = float(top[1] - top[0])
        if ring_margin > 10 * err:
            raise AssertionError(f"ring first token {ring_tok['ring'][0]}"
                                 f" vs {first_ref}, margin {ring_margin}")
    out["sp2"] = {
        "prompt_tokens": len(ids), "ring_positions": T,
        "ring_step_ms": ring_row["ms"], "census": census,
        "launches_ring_step": got, "logits_rel_l2": rel_ring,
        "first_token": [ring_tok["ring"][0], first_ref],
        "first_token_margin": ring_margin,
        "ranks": _par_collectives(reps, len(ring_rows)),
        "seconds": time.perf_counter() - t0}
    log(f"[parallel] {card}: sp=2 {json.dumps(out['sp2'])}")
    del full
    free_device_memory(torch)

    # c. DeepSeek-V2-Lite at ep = 2.
    t0 = time.perf_counter()
    ds = dc.replace(ModelConfig.deepseek_v2_lite(),
                    num_layers=DEEPSEEK_SERVE_LAYERS)
    ecfg = _par_engine_cfg(max_model_len=2048, num_pages=256,
                           max_prefill_tokens=1024)
    rng = random.Random(3)
    short = [(f"s{n}", [rng.randrange(3, 259) for _ in range(n)], 32)
             for _, _, n in SERVE_PLAN]
    long = [(f"l{n}", [rng.randrange(3, 259) for _ in range(n)], 4)
            for n in PAR_DS_LONG]
    eng, mesh, procs = _par_mesh(MeshSpec(ep=2), ds, ecfg)
    try:
        if eng.params["layers_moe"]["gate_proj"].shape[1] != \
                ds.num_experts // 2:
            raise AssertionError("ep=2 rank 0 does not hold half the "
                                 "experts")
        ranks.control(eng, "reset")
        log_e = StepLog(eng, kernels)
        tok_s, rows_s = _par_streams(eng, short, log_e)
        tok_l, rows_l = _par_streams(eng, long, log_e)
        reps = ranks.control(eng, "report")
        dropped = eng.moe_dropped_tokens
    finally:
        _par_close(eng, mesh, procs)
    del eng
    free_device_memory(torch)
    check_step_launches(rows_s + rows_l, reps[0]["launches"], ds.num_layers,
                        True, True, False)
    _par_same_launches(reps)
    chunked = [rep["prefill_branch"]["chunked"] for rep in reps]
    if min(chunked) < 1:
        raise AssertionError(f"no MLA prefill call took the chunked "
                             f"path: {[r['prefill_branch'] for r in reps]}")
    ref_eng = Engine(ds, ecfg, device=PAR_DEVICE)
    log_r = StepLog(ref_eng, kernels)
    ref_s, _ = _par_streams(ref_eng, short, log_r)
    ref_l, _ = _par_streams(ref_eng, long, log_r)
    ref_dropped = ref_eng.moe_dropped_tokens
    ds_params = ref_eng.params
    del ref_eng
    if dropped != ref_dropped:
        raise AssertionError(f"moe_dropped {dropped} vs unsharded "
                             f"{ref_dropped}")
    mine, ref_all = {**tok_s, **tok_l}, {**ref_s, **ref_l}
    ds_margins = _par_margins(torch, ds_params, ds,
                              {rid: ids for rid, ids, _ in short + long},
                              ref_all, mine, err_mla, "ep2")
    del ds_params
    free_device_memory(torch)
    # The chunked form against the dense one at a chunked call's shape
    # (2 rows of a 512-token window over 2,048 latent keys).
    g = torch.Generator(device=PAR_DEVICE).manual_seed(17)
    B, T, S, H, D = 2, 512, 2048, ds.num_heads, ds.kv_cache_dim
    q = torch.randn((B, T, H, D), generator=g, device=PAR_DEVICE).to(
        torch.bfloat16)
    lat = torch.randn((B, S, 1, D), generator=g, device=PAR_DEVICE).to(
        torch.bfloat16)
    kvl = torch.tensor([S - 200, S - 400], dtype=torch.int32,
                       device=PAR_DEVICE)
    st = kvl - T
    scale = tf._mla_scale(ds)
    chunk = attention.prefill_chunk(B, T, H, S)
    a = attention.mha_prefill_chunked(q, lat, lat, kvl, st, chunk_size=chunk,
                                      scale=scale)
    b = attention.mha_prefill(q, lat, lat, kvl, st, scale=scale)
    chunk_err = float((a.float() - b.float()).abs().max())
    if chunk_err > ATTN_TOL:
        raise AssertionError(f"chunked MLA prefill off the dense one by "
                             f"{chunk_err}")
    del q, lat, a, b
    forwards = sum(r["forwards"] for r in rows_s + rows_l)
    out["ep2"] = {
        "experts_per_rank": ds.num_experts // 2,
        "launches": reps[0]["launches"],
        "launches_per_forward": _par_per_forward(
            rows_s + rows_l, reps[0]["launches"]),
        "equal_streams": sum(mine[k] == ref_all[k] for k in ref_all),
        "margins": ds_margins, "moe_dropped": [dropped, ref_dropped],
        "chunked_prefill_calls": chunked,
        "dense_prefill_calls": [rep["prefill_branch"]["dense"]
                                for rep in reps],
        "chunk": chunk, "chunked_vs_dense_max_abs_err": chunk_err,
        "ranks": _par_collectives(reps, forwards),
        "prefill_step_ms": [r["ms"] for r in rows_l],
        "seconds": time.perf_counter() - t0}
    log(f"[parallel] {card}: ep=2 {json.dumps(out['ep2'])}")
    free_device_memory(torch)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[parallel] {card}: the phase took {out['seconds']:.1f} s (budget "
        f"{PAR_BUDGET_S} s)")
    return out


def parallel_kernel_rows(torch) -> list:
    """K3 and K4 at llama3-1b's rank shape at tp = 2 (16 query heads, 4
    KV heads, D 64): ``*_tp2`` records, each with its bound and its
    library time."""
    from xllm_service_tpu_torch.config import ModelConfig
    from xllm_service_tpu_torch.ops import attention
    from xllm_service_tpu_torch.ops.kernels import (paged_attention,
                                                    prefill_attention)
    cfg = dataclasses.replace(ModelConfig.llama3_1b(), name=PAR_TP2_MODEL,
                              num_heads=16, num_kv_heads=4, head_dim=64)
    bench = KernelBench(torch, cfg, "cuda", suffix="_tp2")
    bench.decode_attention(paged_attention, attention)
    bench.prefill_attention(prefill_attention, attention)
    rows = bench.results
    del bench
    free_device_memory(torch)
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    if not (ROOT / "xllm_service_tpu_torch").is_dir():
        log("chip_smoke: run it from a checkout of the repository (the "
            "xllm_service_tpu_torch package is not beside this script)")
        return 2
    sys.path.insert(0, str(ROOT))
    guard_no_jax_modules()
    from xllm_service_tpu_torch.config import ModelConfig
    from xllm_service_tpu_torch.models import transformer
    from xllm_service_tpu_torch.ops import attention, kernels, rope
    from xllm_service_tpu_torch.ops.kernels import (_build, kv_update,
                                                    paged_attention,
                                                    prefill_attention,
                                                    ragged_attention)

    t_start = time.perf_counter()
    # Seconds on the script's clock at the end of each phase (the
    # summary's ``phase_end_s``).
    marks = {}

    def mark(phase: str) -> None:
        marks[phase] = time.perf_counter() - t_start
    # 1. Device.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # 2. Build.
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    mark("2_build")
    log(f"[build] {build_s:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "wgmma")):
                log(f"[ptxas] {name}: {line.strip()}")

    # 3. Kernels against their plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.llama3_1b()
    bench = KernelBench(torch, cfg, "cuda")
    bench.decode_writer(kv_update)
    bench.prefill_writer(kv_update)
    bench.rope_decode_writer(kv_update, rope)
    bench.rope_prefill_writer(kv_update, rope)
    bench.decode_attention(paged_attention, attention)
    bench.decode_attention_null_lead(paged_attention, attention)
    bench.prefill_attention(prefill_attention, attention)
    bench.ragged_attention(ragged_attention, paged_attention,
                           prefill_attention, attention)
    bench.ragged_attention_long(ragged_attention, paged_attention,
                                prefill_attention, attention)
    bench.ragged_attention_wide(ragged_attention)
    bench.ragged_attention_rows(ragged_attention)
    bench.all_layer_writers(kv_update, cfg.num_layers, cfg.num_kv_heads,
                            cfg.head_dim, record=True)
    bench.all_layer_writers(kv_update, 4, 1, 576, record=False)  # MLA row
    bench.decode_attention_current(paged_attention, attention)
    bench.decode_attention_long(paged_attention, attention)
    bench.prefill_attention_fresh(prefill_attention, attention)
    bench.cached_start(prefill_attention, ragged_attention, paged_attention,
                       kv_update, attention)
    bench.head_dims(prefill_attention, ragged_attention, paged_attention)
    bench.prefill_long(prefill_attention, ragged_attention, attention)
    mla_cfg = ModelConfig.deepseek_v2_lite()
    bench.mla_decode_attention(paged_attention, attention, mla_cfg,
                               transformer._mla_scale(mla_cfg))
    bench.latent_writers(kv_update, rope, mla_cfg)
    bench.fold_writers(kv_update, rope, mla_cfg)
    bench.poison_current_slot(paged_attention, transformer._mla_scale(mla_cfg))
    latent = bench.latent_pools()                 # K1/K2 at the latent row
    bench.decode_writer(kv_update, latent)
    bench.prefill_writer(kv_update, latent)
    del bench.kp, bench.vp, latent
    free_device_memory(torch)
    # K1-K4 as phase 12 serves them at llama3-8b's D = 128 (Hkv 8, 32
    # query heads): the fused rope writers, K3 and K4.
    big = KernelBench(torch, ModelConfig.llama3_8b(), "cuda", suffix="_d128")
    big.rope_decode_writer(kv_update, rope)
    big.rope_prefill_writer(kv_update, rope)
    big.decode_attention(paged_attention, attention)
    big.prefill_attention(prefill_attention, attention)
    bench.results += big.results
    del big
    free_device_memory(torch)
    # K3, K3', K4, K4', K5 with sinks and the 128-token window, and the
    # fused rope writers at D = 64 with yarn tables, at GPT-OSS-20B's
    # shapes (64 query heads, Hkv 8), which phase 13 serves.
    oss = KernelBench(torch, ModelConfig.gpt_oss_20b(), "cuda",
                      suffix="_gptoss")
    oss.rope_decode_writer(kv_update, rope)
    oss.rope_prefill_writer(kv_update, rope)
    oss.gptoss_attention(paged_attention, prefill_attention,
                         ragged_attention, attention)
    bench.results += oss.results
    del oss
    free_device_memory(torch)
    bench.results += gemma_kernel_rows(torch)
    mark("3_kernels")

    # 4. Forward pass: llama3-1b, then DeepSeek-V2-Lite cut to 4 layers.
    rel, err, graph = forward_check(torch, cfg, "cuda")
    free_device_memory(torch)
    rel_mla, err_mla, graph_mla = mla_forward_check(
        torch, kernels, dataclasses.replace(mla_cfg, num_layers=4), "cuda")
    free_device_memory(torch)
    mark("4_forward")

    # 5. Serving, split path; 5b. serving, ragged step; 5c. serving,
    # attend-then-write; 5d/5e. DeepSeek-V2-Lite, DEEPSEEK_SERVE_LAYERS
    # layers, in the GPU
    # default order and in attend-then-write.
    # Each phase's path; every llama3-1b phase serves the same weights
    # (the engine's seed), and so does every DeepSeek one. The margins of
    # the streams' first divergent tokens are read on the live engine of
    # each model's last phase (5c, 5e).
    split_wta = {"ragged": False, "write_then_attend": True}
    ragged_path = {"ragged": True, "write_then_attend": True}
    split_atw = {"ragged": False, "write_then_attend": False}
    served = serve(torch, kernels, "llama3-1b", "cuda", ragged=False,
                   keep_params=True)
    ladders = {"llama3-1b": ladder_warmup(torch, "llama3-1b",
                                          served.pop("params"), card)}
    free_device_memory(torch)
    served_b = serve(torch, kernels, "llama3-1b", "cuda", ragged=True,
                     tag="b")
    free_device_memory(torch)
    tok_a, tok_b = served.pop("tokens"), served_b.pop("tokens")
    served_c = serve(
        torch, kernels, "llama3-1b", "cuda", ragged=False,
        write_then_attend=False, tag="c",
        on_engine=lambda eng, tok_c: divergence_margins(
            torch, eng, [("ragged", tok_a, split_wta, tok_b, ragged_path,
                          served["prompts"]),
                         ("attend_then_write", tok_a, split_wta, tok_c,
                          split_atw, served["prompts"])],
            err, cpu_float(eng.params)))
    free_device_memory(torch)
    ds_cfg = dataclasses.replace(mla_cfg, num_layers=DEEPSEEK_SERVE_LAYERS)
    served_d = serve(torch, kernels, "deepseek-v2-lite", "cuda",
                     ragged=False, tag="d", model_cfg=ds_cfg)
    free_device_memory(torch)
    tok_d = served_d.pop("tokens")
    served_e = serve(
        torch, kernels, "deepseek-v2-lite", "cuda", ragged=False,
        write_then_attend=False, tag="e", model_cfg=ds_cfg,
        on_engine=lambda eng, tok_e: divergence_margins(
            torch, eng, [("deepseek_orders", tok_d, split_wta, tok_e,
                          split_atw, served_d["prompts"])], err_mla))
    free_device_memory(torch)
    mark("5_5e_serve")
    same = {}
    for tag, tok_x, tok_y in (("ragged", tok_a, tok_b),
                              ("attend_then_write", tok_a,
                               served_c.pop("tokens"))):
        pairs = [(x, y) for n in tok_x for x, y in zip(tok_x[n],
                                                       tok_y.get(n, []))]
        same[tag] = (sum(x == y for x, y in pairs) / len(pairs)
                     if pairs else None)
    log(f"[serve] {card}: split vs ragged: TTFT ms "
        f"{served['ttft_ms_streams']} vs {served_b['ttft_ms_streams']}; "
        f"decode tokens/s per stream {served['decode_tokens_per_s_streams']}"
        f" vs {served_b['decode_tokens_per_s_streams']}; engine steps "
        f"{served['engine_steps']} vs {served_b['engine_steps']}; forwards "
        f"per request {served['forwards_per_request']} vs "
        f"{served_b['forwards_per_request']}; kernel launches per mixed "
        f"iteration {served['kernel_launches_per_mixed_step']} vs "
        f"{served_b['kernel_launches_per_mixed_step']}; share of equal "
        f"tokens {same['ragged']}")
    log(f"[serve] {card}: write-then-attend (5) vs attend-then-write (5c): "
        f"TTFT ms {served['ttft_ms_streams']} vs "
        f"{served_c['ttft_ms_streams']}; decode tokens/s per stream "
        f"{served['decode_tokens_per_s_streams']} vs "
        f"{served_c['decode_tokens_per_s_streams']}; hand-written kernel "
        f"launches per decode step "
        f"{served['kernel_launches_per_decode_step']} vs "
        f"{served_c['kernel_launches_per_decode_step']}; median decode "
        f"step ms {served['decode_step_ms_median']} vs "
        f"{served_c['decode_step_ms_median']}; share of equal tokens "
        f"{same['attend_then_write']}")
    p5, p5c = served["profile"], served_c["profile"]
    log(f"[profile] {card}: one profiled stream, write-then-attend (5) vs "
        f"attend-then-write (5c): device kernel launches "
        f"{p5['kernel_launches']} vs {p5c['kernel_launches']} in "
        f"{p5['forwards']} vs {p5c['forwards']} forwards "
        f"({p5['kernel_launches_per_forward']} vs "
        f"{p5c['kernel_launches_per_forward']} per forward); device busy ms "
        f"{p5['device_busy_ms']} vs {p5c['device_busy_ms']}; idle share "
        f"{p5['idle_share']} vs {p5c['idle_share']}")
    tok_e = served_e.pop("tokens")
    pairs = [(x, y) for n in tok_d for x, y in zip(tok_d[n],
                                                   tok_e.get(n, []))]
    same["deepseek_orders"] = (sum(x == y for x, y in pairs) / len(pairs)
                               if pairs else None)
    p5d, p5e = served_d["profile"], served_e["profile"]
    log(f"[serve] {card}: deepseek-v2-lite write-then-attend (5d) vs "
        f"attend-then-write (5e): TTFT ms {served_d['ttft_ms_streams']} vs "
        f"{served_e['ttft_ms_streams']}; decode tokens/s per stream "
        f"{served_d['decode_tokens_per_s_streams']} vs "
        f"{served_e['decode_tokens_per_s_streams']}; median decode step ms "
        f"{served_d['decode_step_ms_median']} vs "
        f"{served_e['decode_step_ms_median']}; device busy ms per profiled "
        f"stream {p5d['device_busy_ms']} vs {p5e['device_busy_ms']}, of it "
        f"K3'' {p5d['decode_attention_device_ms']['mla']} vs "
        f"{p5e['decode_attention_device_ms']['mla']}; idle "
        f"share {p5d['idle_share']} vs {p5e['idle_share']}; share of equal "
        f"tokens {same['deepseek_orders']}")

    log(f"[profile] {card}: one profiled stream, kernel launches per "
        f"forward: llama3-1b 5 {p5['kernel_launches_per_forward']}, 5c "
        f"{p5c['kernel_launches_per_forward']}; deepseek-v2-lite 5d "
        f"{p5d['kernel_launches_per_forward']}, 5e "
        f"{p5e['kernel_launches_per_forward']}; PyTorch elementwise device "
        f"ms 5 {p5['elementwise_device_ms']}, 5c "
        f"{p5c['elementwise_device_ms']}, 5d {p5d['elementwise_device_ms']}, "
        f"5e {p5e['elementwise_device_ms']}; cat/copy device ms 5 "
        f"{p5['cat_copy_device_ms']}, 5c {p5c['cat_copy_device_ms']}, 5d "
        f"{p5d['cat_copy_device_ms']}, 5e {p5e['cat_copy_device_ms']}")
    # 5f/5g. The decode modes beside phase 5's and 5d's serves.
    served_f = decode_modes(torch, kernels, "llama3-1b", "f", err, card,
                            served, tok_a)
    served_g = decode_modes(torch, kernels, "deepseek-v2-lite", "g",
                            err_mla, card, served_d, tok_d, model_cfg=ds_cfg)
    free_device_memory(torch)
    mark("5f_5g_decode_modes")
    # 6. The cluster: the port's master in front of the port's worker.
    clustered = cluster_phase(torch, kernels, card)
    free_device_memory(torch)
    mark("6_cluster")
    # 7. Prefix reuse on each path; 7b. spill and restore; 6b. the
    # cache-aware master over two workers, on phase 7's weights.
    prefixed = prefix_phase(torch, kernels, card, err)
    prefix_params = prefixed.pop("params")
    spilled = spill_phase(torch, kernels, card, prefix_params, err)
    routed = routed_cluster_phase(torch, kernels, card, prefix_params)
    del prefix_params
    free_device_memory(torch)
    mark("7_7b_6b_prefix")
    # 8. The OpenAI sampling surface.
    sampled = sampling_phase(torch, kernels, card, err)
    free_device_memory(torch)
    mark("8_sampling")
    # 9. Faults and the flight recorder.
    faulted = fault_phase(torch, kernels, card, err)
    free_device_memory(torch)
    mark("9_faults")
    # 10. PD disaggregation behind the port's master.
    disaggregated = pd_phase(torch, kernels, card, err)
    free_device_memory(torch)
    mark("10_pd")
    # 11. The cross-worker block fetch behind the port's master.
    fetched = fetch_phase(torch, kernels, card, err)
    free_device_memory(torch)
    mark("11_fetch")
    # 12. The worker's lifecycle: sleep, wake, several models, drain and
    # the supervised heartbeat.
    lifecycle = lifecycle_phase(torch, kernels, card, err)
    free_device_memory(torch)
    mark("12_lifecycle")
    # 13. Serving from a model directory: llama3-1b from disk, GPT-OSS in
    # MXFP4 at full width, GPT-OSS-20B at full width and depth.
    from_disk = checkpoint_phase(torch, kernels, card, tok_a,
                                 served["prompts"], err)
    free_device_memory(torch)
    mark("13_checkpoint")
    # 14. The EPD multimodal path: Qwen2-VL-7B with images.
    epd = epd_phase(torch, kernels, card, err)
    bench.results += epd.pop("records")
    free_device_memory(torch)
    mark("14_epd")
    # 15. The observability and coordination plane, over etcd.
    observed = obs_phase(torch, kernels, card)
    free_device_memory(torch)
    mark("15_obs")
    # 16. Gemma-3-12B and Gemma-2-9B: the D = 256 path served.
    gemma = gemma_phase(torch, kernels, card)
    free_device_memory(torch)
    mark("16_gemma")
    # 17. Parallelism on the one card: tp = 2, sp = 2, ep = 2.
    bench.results += parallel_kernel_rows(torch)
    parallel = parallel_phase(torch, kernels, card, err, err_mla)
    free_device_memory(torch)
    mark("17_parallel")
    margins = served_c["on_engine"] + served_e["on_engine"]
    for phase in (served, served_b, served_c, served_d, served_e):
        phase.pop("prompts")
        phase.pop("on_engine")
        phase.pop("params", None)
    log(f"[margins] {card}: top-2 logit margin at each stream's first "
        f"divergent token between served paths (limit: 10 x phase 4's "
        f"largest logit error, llama3-1b {err}, deepseek-v2-lite "
        f"{err_mla}): {json.dumps(margins)}")

    # 18. Summary.
    woken = lifecycle["wake"]["launches"]
    for r in bench.results:
        name = r.get("entry", r["name"])       # a record at another shape
        if r.get("shape_model") == PAR_TP2_MODEL:
            # Served by phase 17's tp = 2 round (rank 0's count; rank 1
            # launched as many).
            r["launches"] = parallel["tp2"]["launches"][name]
            continue
        if r.get("shape_model") == GEMMA3_MODEL:
            # Served by phase 16's Gemma-3-12B rounds: each path's kernels.
            tag = ("ragged" if name == "ragged_paged_attention" else
                   "attend_then_write" if name in ATTEND_THEN_WRITE_KERNELS
                   else "split")
            r["launches"] = gemma["serve"][tag]["launches"][name]
            r["launches_served_path"] = tag
            continue
        if r.get("shape_model") == GEMMA2_MODEL:
            r["launches"] = gemma["gemma2"]["launches"][name]
            continue
        if r.get("shape_model") == EPD_MODEL:
            # Served only by phase 14's Qwen2-VL-7B worker.
            r["launches"] = epd["launches"][name]
            continue
        if r.get("shape_model") == LIFE_BIG:
            # Served only by phase 12's llama3-8b round.
            r["launches"] = lifecycle["swap"]["big_launches"][name]
            continue
        if r.get("shape_model") == GPTOSS_MODEL:
            # Served by phase 13's GPT-OSS-20B rounds: each path's kernels.
            oss = from_disk["gptoss"]["serve"]
            tag = ("ragged" if name == "ragged_paged_attention" else
                   "attend_then_write" if name in ATTEND_THEN_WRITE_KERNELS
                   else "split")
            r["launches"] = oss[tag]["launches"][name]
            r["launches_served_path"] = tag
            base = next((b for b in bench.results
                         if b["name"] == name), None)
            if base is not None and r.get("bytes_moved") and \
                    base["bound_by"] == "bytes":
                # Time per byte against the llama3-1b record's (whose
                # bound is its bytes over the memory rate).
                per_byte = r["ms"] / r["bytes_moved"]
                base_per_byte = base["ms"] / (base["bound_ms"] * 1e-3
                                              * HBM_BYTES_PER_S)
                r["ms_per_byte_vs_llama3_1b"] = per_byte / base_per_byte
            continue
        phase = (served_b if name == "ragged_paged_attention" else
                 served_c if name in ATTEND_THEN_WRITE_KERNELS else
                 served_e if name in ("paged_decode_attention_mla_current",
                                      "latent_kv_update_all_layers")
                 else served_d if name in MLA_KERNELS else
                 served)
        r["launches"] = phase["launches"][name]
        # And the woken llama3-1b engine's round in phase 12.
        r["launches_lifecycle"] = woken[name]
    summary = {"card": card, "build_s": build_s, "forward_rel_l2": rel,
               "forward_rel_l2_deepseek": rel_mla,
               "forward_max_abs_logit_err": err,
               "forward_max_abs_logit_err_deepseek": err_mla,
               "divergence_margins": margins,
               "serve": served, "serve_ragged": served_b,
               "serve_attend_then_write": served_c,
               "serve_deepseek": served_d,
               "serve_deepseek_attend_then_write": served_e,
               "serve_decode_modes": served_f,
               "serve_deepseek_decode_modes": served_g,
               "cluster": clustered,
               "prefix_reuse": prefixed, "spill_restore": spilled,
               "cluster_cache_aware": routed, "sampling": sampled,
               "faults": faulted, "pd": disaggregated, "fetch": fetched,
               "lifecycle": lifecycle, "checkpoint": from_disk,
               "epd": epd, "obs": observed, "gemma": gemma,
               "parallel": parallel,
               "graph_decode_check": {"llama3-1b": graph,
                                      "deepseek-v2-lite": graph_mla},
               "warmup_ladders": ladders,
               "equal_token_share": same,
               "phase_end_s": marks,
               "seconds": time.perf_counter() - t_start}
    log(f"[summary] {json.dumps(summary)}")
    log(f"[seconds] {card}: phase 17 {parallel['seconds']:.1f} s, the "
        f"script {summary['seconds']:.1f} s")
    guard_no_jax_modules()
    print(json.dumps({"kernels": bench.results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
