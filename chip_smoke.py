#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xllm_service_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port starts, that its hand-written
kernels build and agree with their plain versions, and that the engine
serves Llama-3-8B, its variants, Qwen2-VL-2B's image chats, Mixtral-8x7B
and DeepSeek-V2-Lite through them, behind stub masters and behind the
port's own master.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
1. environment: torch/CUDA versions, the card's name and power limit;
2. the compile gate (``xllm_service_tpu_torch/benchmarks/compile_gate.py``):
   build the six CUDA libraries from ``xllm_service_tpu_torch/csrc`` (one
   nvcc per source, in parallel) into ``build/torch_kernels`` and launch
   each kernel arm once at the bench-1b shapes; its JSON line is printed
   and every arm must be ``ok``;
3. each kernel against its plain PyTorch version on the card at Llama-3-8B
   shapes, timed beside its plain version and a PyTorch yardstick: the two
   attention kernels and the fused append-and-attend (bf16 and f32, ragged
   contexts, NaN garbage past every context; for the three split-K decode
   kernels also contexts shorter than a split, a split holding part of one
   page, empty splits and a lone row, windows for kernel 1; for the
   tensor-core prefill kernel a suffix that is no multiple of its tile and
   a row with no block; their splits, registers, blocks per SM, splits
   sweeps and shares of the library's time and of the bound are logged;
   ``scaled_dot_product_attention`` on the K/V already gathered dense), the
   page movers at one hash block (bit for bit; ``index_select`` /
   ``index_copy_``; also on the pool sharded four ways, one launch per
   call; the copy floor, a contiguous ``copy_`` of the same bytes; the
   sweep of the bulk route's stages, chunk and blocks per SM) and the
   context-parallel partial per shard at seq 2
   and 4 (NaN in every page a shard does not own and occupy, a shard that
   owns only a row's last, partial page; the whole CP op against
   single-device attention, and timed against kernel 1); kernel 2 also at
   the speculative verify's shapes (B 8, Sq 5, block lengths 5, 1 and 0 in
   one call behind prefixes 256-1536, bf16 and f32), timed beside SDPA and
   the bound there and at a uniform context of 1024; kernels 1, 3 and 6
   at head dim 256 (Gemma's 16/8 and 8/1 heads, both types; kernel 1 also
   with a window of 300, Gemma-2's softcap 50 and scale 1/16, and all
   three, and timed at Gemma-2-9B's decode behind 1024 and 4608 tokens,
   local and global layers; kernel 6 on shard 0 of four), kernel 1 at the
   GQA groups of Qwen2-7B (28/4) and Qwen2-VL-2B (12/2), and kernel 2's
   f32 walk at the shapes its tensor-core route does not take (Gemma-2B's
   head dim 256, Qwen2-7B's group of 7, Qwen2-VL-2B's group of 6 at Sq 256
   behind 256), timed beside SDPA; the page movers again at
   DeepSeek-V2-Lite's MLA block ``[27, 2, 8, 1, 16, 576]`` (one pool and
   four shards, bit for bit, timed beside ``index_select`` /
   ``index_copy_`` and the copy floor) and kernel 6 at Qwen2-VL-2B's 12/2
   heads (per shard at seq 2 and 4, the whole op, timed on shard 0 of
   four beside SDPA over the owned K/V); each of these two shapes is a
   row of its own in the ``kernels`` line, as are phase 4o's shapes
   (kernel 1 at 8/2 and 8/1 heads, kernel 2 at groups 4 and 8, the movers
   at a ``model=4`` shard's block ``[TP_LAYERS, 2, 8, 2, 16, 128]``) and
   phase 4q's: kernel 6 at a ``model=2`` shard's 16/4 heads (per shard at
   seq 2 and 4, timed on shard 0 of two) and the movers at a ``seq=2 x
   model=2`` grid shard's block ``[GRID_LAYERS, 2, 8, 4, 16, 128]`` (one
   pool and two shards): 4o (b)'s and 4q (c)'s blocks;
4. serving at Llama-3-8B's full width and depth (random weights from a
   fixed seed) through ``InferenceEngine`` with its background loop: ten
   greedy requests (two of them sharing a 512-token prefix with the first,
   submitted after its prefill) and one seeded sampled request, run twice
   on fresh engines; every decode step after a variant's first is a replay
   of the engine's captured step (``engine/decode_graph.py``), and the
   launch counts include the replays; checks lengths, determinism, prefix
   hits, kernel launches, the replays, and one prompt's logits by the
   cold, cached-prefix and decode routes;
4a. KV tiers at the same width: a 1024-token prompt served from HBM, its
   blocks evicted into a DRAM arena of four blocks and an SSD spill file,
   then served again from the tiers (TIER_NEW tokens each time; the
   requests that only fill and evict stop at TIER_FILL_NEW); the tokens
   must match, both tiers must have onloaded, and the restored pages must
   equal the evicted ones;
4b. the fused decode writeback (``XLLM_KV_WRITEBACK=fused``): phase 4's
   batch served twice through the fused kernel (replayed in the captured
   step), with kernel 1 idle, and the decode-step logits checked again;
4c. context-parallel serving at the same width and CP_LAYERS layers
   (``depth_view`` of phase 4's weights): the KV pool sharded four ways
   over a ``seq`` mesh (on one card, ``cuda:0`` four times); a long
   prefix-free prompt (ring prefill), a short one, one sharing the long
   one's first 512 tokens (a prefix hit through kernel 2) and a seeded
   sampled one, CP_NEW tokens each, run twice on fresh engines; every
   decode step through kernel 6, kernels 1 and 3 idle; one decode step's
   logits against the single-device engine's (the step stays eager under
   the mesh);
4d. KV tiers under that seq mesh, at 4c's depth: phase 4a's round trip
   on a pool sharded four ways, with hash blocks that straddle shards; both tiers must have
   been used, the restored pages must equal the evicted ones, A's first
   token after the onload must equal its first from HBM, a decode step
   over the restored pages must agree with one over the evicted bytes on
   one device, and kernels 4, 5 and 6 must have launched, kernel 4 once
   per offloaded block;
4e. the decode step's host path: from the same state at full width, one
   replay of the captured step and the same step run op by op must agree
   bit for bit (packed rows, KV pool, slot state; greedy, seeded sampled
   and logprob rows, on both writeback routes); then the bench twin
   (``xllm_service_tpu_torch/bench.py``, Llama-3-8B, B 16, ctx 512,
   horizon 32) and the decode-profile twin
   (``xllm_service_tpu_torch/benchmarks/decode_profile.py``): tok/s and
   pct_roofline, eager and graphed ``full_step_ms``, kernels per step and
   the device's busy share from a ``torch.profiler`` trace;
4f. serving through the agent: the port's ``EngineAgent`` on the card,
   with phase 4's engine configuration and weights, behind a stub master
   of the standard library here (it writes its address under
   ``XLLM:SERVICE:MASTER`` in the agent's in-process coordination store and
   takes ``/rpc/heartbeat`` and ``/rpc/generations`` in msgpack or JSON as
   the reference master does; it has no ``/rpc/telemetry``, so the agent's
   default mux mode demotes itself to those routes, which is checked).
   Phase 4's eleven requests are posted as enriched JSON dispatches
   on one kept-alive connection, in phase 4's order, then an ``n: 2`` seeded request, a logprob request,
   a request cancelled through ``/rpc/cancel`` after its first delta, a
   dispatch past its deadline (504) and an embeddings call; checks the
   registration, every request's deltas (``delta_seq`` 1..k, instance and
   incarnation, one ``finished`` with usage), the greedy and sampled tokens
   against phase 4's, the heartbeats (load, latency, KV events), the
   launches of kernels 1 and 2, the graph's replays, the embeddings
   against ``engine.embed``, and the first against plain f32 math (within
   4x the error of the same math in bf16). Information only: the host's
   split of phase 4 run 1 and of phase 4f (``StepClock``, ``CallClock``);
4g. the admission path at the same width and depth: kernel 2 at the chunk
   shapes (Sq 256 behind 0-1536 written tokens, Sq 1024 behind 0, 256 and
   1024, the 1100-token prompt's ragged ride of 76 rows behind 768 and its
   install behind 844) against its plain version, timed beside SDPA; the
   prefix-free prefill's SDPA route against the f32 path on a 2048-token
   prompt's shapes (valid rows, within 4x a bf16 control); one 1792-token
   prompt's first-token logits with its chunks riding mixed steps and as
   standalone chunks against the prompt installed whole; the mixed step's
   decode-row logits against ``decode_forward`` from one state, and
   unchanged bit for bit by the chunk; the captured mixed step against
   the same step op by op, bit for bit, at spans 256 and 1024; then six
   short requests decoding while two 1792-token prompts and one of 1100
   arrive, three times at ADMISSION_LAYERS layers (chunks of 256 riding
   the decode steps, ``XLLM_SARATHI=0``, whole installs): rides happen,
   kernel 2 runs inside every captured mixed step, every request gets
   its budget, and the
   chunked runs' greedy streams equal the whole installs' but at a
   near-tie (the token taken at one of the two largest logit values,
   within TIE_STEPS bf16 steps of the top); an online request preempting
   an offline one on a 100-page pool (the offline stream equal to its
   unpreempted run up to the preemption in bf16, and in full in f32 at
   full width and 4 layers); and phase 4's eleven requests submitted at
   once (the burst's admission split, information);
4h. speculative decoding at the same width and depth (``speculate_k`` 4,
   ``speculate_cycles`` 4, batch 10): eight greedy requests on the
   reference spec bench's repetitive prompts (256 ids plus the request's
   index), a seeded sampled one and a logprob one, 128 new tokens each,
   served with speculation and without after a warm pass: every budget
   met, the spec path taken (a spy on ``_spec_multi``), a cycle accepting
   a draft, kernel 2 in every layer of the captured spec cycle, each
   greedy stream equal to the plain run's but at a near-tie (as in 4g);
   the same traffic in f32 at full width and 4 layers, every stream and
   logprob (1e-4) equal with and without speculation; the captured spec
   cycle against the same cycle op by op, bit for bit; the
   ``spec_bench`` twin (``bench_1b_config``). Tokens per cycle and tokens/s
   are information;
4i. PD disaggregation at the same width and depth: a PREFILL agent in this
   process on phase 4's params (chunks of 256) and a DECODE agent in a
   second process on the same card, started through the agent's entry
   point (``python3 chip_smoke.py --decode-agent``, which runs
   ``engine/agent.py::main`` with two probes this script reads), behind
   the stub master (which links them both ways and dispatches each
   request to the prefill agent with ``routing.decode_name``) and a
   coordination server of the standard library here. Phase 4's eleven
   requests and a logprob one go through the pair; checks: (a) the greedy
   streams equal phase 4's but at a near-tie (as in 4g); (b) every
   handoff took the CUDA IPC path (``device_sent`` and ``device_received``
   equal the request count, the host counts 0); (c) kernel 4's extract at
   every handoff equals the plain gather of the same pages bit for bit,
   and one request's pages in the decode pool after its install, read
   through the plain gather, equal the prefill side's extracted buffer
   bit for bit; (d) kernel 4
   once a handoff and kernel 2 on the prefill side, kernel 5 once a
   handoff and kernel 1 on the decode side; (e) the decode agent's
   heartbeat reports the donated blocks; (f) every request's trace, under
   the trace context its dispatch carried: ``engine.prefill`` and
   ``kv_transfer.offer`` in the prefill agent, ``kv_transfer.pull`` and
   the injected ``engine.decode`` in the decode agent; (g) one more
   request sent down the streamed path by a fault rule on the device
   offer here, its streamed pull failed by a rule in the decode process
   (``fault`` on the child's standard input): the inline fallback gives
   phase 4's tokens but at a near-tie, and the prefill agent's
   ``/admin/flightrecorder/recent`` holds exactly one
   ``kv_stream_fallback`` bundle with its ``engine`` context. Then the
   ``pd_handoff_bench`` twin (device, streamed and inline paths at
   ``bench_1b_config``'s KV shapes, PD_TWIN_CTXS tokens). Handoff ms, the
   pair's TTFT beside
   phase 4f's and tokens/s are information;
4j. the llama family's variants at full width and depth, one after the
   other on random weights with drawn norm scales and biases: Gemma-2-9B
   (a 4600-token prompt past its 4096-token window beside phase 4's kind
   of requests, two prefix hits), Qwen2-7B (qkv biases, a prefix hit
   through kernel 2's walk) and Llama-3-8B in weight-only int8 (phase 4's
   weights and requests). Each leg checks kernel 1 at one launch a layer
   per step, one decode step against kernel 1's plain version, and every
   greedy token against its recomputation at the near-tie rule; Gemma-2's
   prefills take the dense route (counted, kernel 2 idle). Then the bench
   twin in int8 beside phase 4e's bf16 figure (information);
4k. checkpoint loading: phase 4's Llama-3-8B weights at full width, cut to
   K_LLAMA_DEPTH layers (``depth_view``), written as a Hugging
   Face model directory through the port's safetensors writer (four bf16
   shards named as Meta's with their index, ``config.json`` with the
   published values, a Llama-3-shaped ``tokenizer.json`` of 128000 ranks
   drawn from a seed and the 256 special tokens at their published ids,
   ``tokenizer_config.json``), under ``tempfile.mkdtemp()``; loaded here
   (every leaf bit for bit against phase 4's; with ``quant="int8"`` against
   ``quantize_tree`` of phase 4's); then served by the agent in a second
   process started from its command line (``--model-config hf
   --checkpoint-path D --tokenizer-path D``, through ``python3
   chip_smoke.py --checkpoint-agent``, which runs ``engine/agent.py::main``
   with probes) behind the stub master: after a warm pass on other
   prompts, phase 4's requests give exactly the tokens of an engine here
   on the same cut tree (their host split beside phase 4f's), two text
   requests are tokenised there as here and stream the decode of their
   ids, kernels 1 and 2 launch there. Then
   Qwen2-7B and Gemma-2-9B (tied, no ``lm_head``) at full width and
   K_DEPTH layers, norms and biases drawn: written, loaded bit for bit,
   one rollout (kernel 2 behind a cached prefix for Qwen2, kernel 1 on
   every decode step) giving the tree in memory's tokens and logits
   exactly. Write and load times and rates, the time to registration,
   the tokenizer's encode rate and the detokeniser's share of the engine
   loop beside phase 4f's split are information;
4l. the agent at the reference's defaults: one agent with ``dp_size`` 2
   (both replicas on this card, sharing phase 4's weight tensors, each with
   its pool and captured steps) in the mux telemetry mode, behind two
   stub masters A and B of the standard library (both registered as
   service members, A also the elected master; each takes
   ``/rpc/telemetry`` frames, relays ``gens`` frames for the other, and
   answers an ``owner`` hint). Phase 4's eleven requests as msgpack
   dispatches with trace contexts, their deltas for A and B in turn;
   checks: the registration (``dp_size`` 2, ``wire_formats`` msgpack and
   json), every request's deltas, the greedy and sampled tokens equal to
   phase 4's (as phase 4f's), each request on the
   replica its first hash block names unless the load guard spilled it
   (spills counted), the shared-prefix requests' cache hits there through
   kernel 2, kernel 1 in both replicas' captured steps, beats and pushes
   only to the rendezvous owner (computed here from blake2b), the traces
   of every request (``/admin/trace``, ``/admin/trace/recent``), an owner
   hint adopted for the next beat, the owner stopped while three long
   requests stream: the successor gets the next beat and the pending
   deltas within one heartbeat interval plus one resolver window and no
   request is lost, ``/metrics`` (the reference's families,
   ``engine_dp_size`` 2, ``engine_generated_tokens_total`` the summed
   usage) and ``/admin/profile`` (the engine loop's role; the folded text
   parses back). Tokens/s against phase 4f's, the telemetry counts and
   the sampler thread's CPU share are information;
4s. the port's own master (after 4l, on phase 4's weights): the port's
   coordination server on a loopback port, the port's master at the
   reference's defaults (CAR, brownout, breaker, ownership, the journal),
   two MIX agents here, each with its engine and pool. Phase 4's eleven
   requests as ``/v1/completions`` on ``http.client`` (streamed and
   whole, in phase 4's order): greedy tokens equal to phase 4's (at a
   near-tie, ``compare_streams``), well-formed SSE with usage on the last
   event, the two shared-prefix requests sent once request 0's blocks are
   in the master's index and routed by CAR to the agent holding them, its
   prefix hits up by two and kernel 2 launched; chats streamed and whole
   (the same text, usage and tokens); ``/v1/models``, ``/hello`` and the
   master's ``/metrics`` families; several masters: (f) a second master
   as ``python -m xllm_service_tpu_torch.master --load-balance-policy
   SLO_AWARE``, a replica whose load view holds both agents ACTIVE, and
   four of phase 4's requests (streamed and whole, ``ownership_key``s by
   rendezvous) each sent to the frontend that does not own it: phase 4's
   tokens, the handoff counters of both masters; (g) that master SIGKILLed
   after MASTER_KILL_AFTER frames of a relayed 64-token stream: the stream
   completes through the survivor with phase 4's tokens and exactly the
   successor's frames, a ``handoff_recovery`` record names the successor,
   and the agents whose telemetry it owned pass over without SUSPECT;
   (h) a second master in this process, then the elected one stopped
   with no drain: the survivor holds ``XLLM:SERVICE:MASTER`` within the
   lease TTL plus one sync and serves phase 4's tokens, and is the master
   of the rest of the phase; (j)-(m), on a master of this process beside
   it (``plane_master``: RR, admission at SHED_LIMIT a live agent, the
   breaker's cooldown at BREAKER_COOLDOWN_S, OUTAGE_OPTS' outage
   timings): (j) a burst of four times the admission limit, every answer
   200 or 429, each 429 with ``Retry-After`` and counted as
   ``requests_cancelled_total{reason="shed"}``, every served stream equal
   to phase 4's, the gate drained; (k) a DEADLINE_NEW-token stream with
   ``x-request-deadline-ms`` DEADLINE_BUDGET_MS: the client's end the CPU
   twin's (DEADLINE_END), the agent's engine stopped within two decode
   calls of the deadline with its running set empty, a concurrent stream
   on the other agent whole, an expired relayed deadline 504 with no
   dispatch; (l) ``rpc.post`` and ``rpc.get`` failing for one agent's
   name through ``/admin/faults`` and its accepts failing: its
   dispatches fail over to the other agent, its breaker opens and
   routing leaves it out, and once cleared a half-open probe closes it
   and it serves again; (m) the coordination server killed while
   OUTAGE_NEW-token streams run on both agents: the streams complete,
   no agent SUSPECT or evicted, the plane master DEGRADED, the elected
   master keeps its mastership; restarted empty on the same port: both
   agents re-register, both monitors CONNECTED, both masters serve; (d)
   the agent serving a MASTER_NEW-token stream killed mid-stream (its
   lease left to lapse): the stream completes through failover on the
   survivor, which prefills the prompt plus the replayed tokens (the
   client's tokens phase 4's, no duplicate, no gap, a failover record),
   the agent LEASE_LOST or SUSPECT, evicted at the default timeouts, the
   next requests on the survivor, which the master then drains; a
   PREFILL and a DECODE agent at MASTER_PD_LAYERS layers (``depth_view``)
   linked by the master, every handoff on the host path (one process:
   the device path is between processes, 4i), kernels 4 and 5 once a
   handoff, the streams equal to an in-process MIX engine's; (i) a master
   process at SLO_AWARE routes that pair (the same streams, kernels 4 and
   5 once a handoff), and a flip hint posted to it (a replica) reaches
   the elected master, which flips the prefill agent to DECODE (its
   registration moves) and back, and the next PD request streams equal.
   Client TTFT and inter-token latency (p50, p99), the relay's added
   TTFT, the client's gap at the owner's death, the seconds to takeover,
   the master's hot-path stages, the share of (j)'s burst shed, the ms
   from (k)'s deadline to the engine's stop, the seconds for (l)'s
   breaker to open and close, the client's largest gap in (m)'s outage
   and at (d)'s kill and the seconds to re-register after (m)'s restart
   are information;
4t. the autoscaler's closed loop (after 4s): the port's coordination
   server and the port's master with the autoscaler on and the local
   actuator, whose spawn command launches port agents of this script
   (``--autoscaled-agent``: Llama-3-8B at full width and AUTO_LAYERS
   layers, drawn from seed 0 by the agent's engine, each process with its
   own CUDA context and AUTO_PAGES pages), minimum 1 and maximum 2, a TTFT
   objective of 1 ms over windows of 2 and 3 s: (a) the controller
   launches the first agent (cold start), registered inside the pending
   window; (b) a burst of four of phase 4's prompts and a shared-prefix
   one (sent once the first's blocks are in the master's index) breaches
   the objective and the controller launches the second agent, which
   registers inside the window while short requests keep coming (one
   every TRICKLE_S), and takes the prefix-free requests of a
   second wave while the other shared-prefix request goes to the block
   holder; ``/admin/autoscaler`` shows both scale-outs with their reasons,
   ``/metrics`` ``autoscaler_actions_total``, ``/metrics/fleet`` both
   agents' series and ``/admin/trace?scope=fleet`` one tree with an
   agent's ``engine.*`` spans under the master's root; (c) with no
   traffic the controller drains the least-loaded agent, which leaves the
   fleet and, reaped, exits 0 by itself; two launches in all; every
   stream held to an in-process engine on the same configuration and
   seed (``compare_streams``), kernel 1 in both agents and kernel 2 on
   the prefix hits (their launches and memory from each agent's REPORT);
   (d) a master with no spawn command launches the port's fake engine
   (the default launcher), which is killed and replaced;
4m. MoE and MLA at full width and depth, phase 4's weights freed first:
   (a) one MoE layer at Mixtral-8x7B's width (eight experts of 14336,
   top 2), 16 tokens, bf16 and int8: the dense dispatch against an
   independent f32 loop over each token's two experts (within 4x the same
   loop in bf16 plus 1e-3 of max |ref|; a token whose 2nd and 3rd router
   logits lie within ROUTE_EPS is excused and counted), timed;
   (b) Mixtral-8x7B in weight-only int8, all 32 layers, its weights drawn
   in int8 one layer of one leaf at a time by the engine (the build's
   seconds and ``max_memory_allocated``), served by the port's agent from
   its command line (``--model-config mixtral_8x7b --quant int8``) behind
   phase 4f's stub master: six requests of MOE_AGENT_NEW tokens, two
   sharing a 512-token prefix;
   checks the deltas, kernel 1 at 32 launches a replayed step, kernel 2
   on the prefix hits, the replays, every greedy token against its
   recomputation (the near-tie rule of 4g, and routing near-ties: a
   layer's router margin below two routes' rounding, at most
   ROUTED_SHARE of the tokens, counted) and, exactly, against a replay at
   the serving path's own shapes (each install as dispatched, then
   decode steps at the batch width); (c) DeepSeek-V2-Lite in bf16,
   all 27 layers and 64 experts, through ``InferenceEngine``: phase 4j's
   kind of requests (two prefix hits) and an embeddings call; checks the
   latent pool ``[27, 2, P, 1, 16, 576]``, kernels 1, 2 and 3 idle, the
   MLA decode route (``paged_attention_xla``) once a layer a step, the
   prefix hits on the dense route, each embedding row unmoved by its
   batch's padding, every greedy token against its recomputation and its
   replay as in (b); the MLA decode route timed at B 16 (information);
   (d) the bench twin at ``XLLM_BENCH_MODEL=moe``. Tokens/s, TTFT and KV
   bytes a token are information. Then, MOE_NEW tokens a request: (f)
   Mixtral-8x7B int8 on a ``seq=4`` pool (phase 4c's mesh) on (b)'s
   weights cut to MOE_MESH_LAYERS layers (``depth_view``): a 1101-token
   prompt (the ring), two short ones and a prefix hit (kernel 2 on the
   gathered table); kernel 6 once a layer a step and shard,
   kernels 1 and 3 idle, the tokens against the one-device engine's (each
   parting a counted near-tie, ``held_to``); (i) Mixtral-8x7B int8 under
   ``speculate_k=4`` against the plain engine: tokens a cycle, kernel 2 in
   every layer of the captured cycle, the tokens held as in (f); (e)
   DeepSeek-V2-Lite as (f) on (c)'s weights at the same depth: the MLA
   decode route once a layer a step over the sharded pool, the prefix hit on the dense route,
   kernels 1, 2, 3 and 6 idle; (g) phase 4a's tier round trip at
   DeepSeek-V2-Lite (hash blocks of 7,962,624 bytes): the restored pages
   bit for bit, the tier hit's tokens equal to the hot run's; (j) the
   ``kvtier_bench`` twin's leg 2 (capacity) at DeepSeek-V2-Lite at
   KVTIER_PREFIXES prefixes (information; its leg 1, the tier-aware TTFT,
   is not run here);
   (h) a PREFILL agent here and a DECODE agent in a second process, both
   DeepSeek-V2-Lite at full width cut to MLA_PD_LAYERS layers (two
   processes at full depth would hold about 63 GB of weights), the KV
   over CUDA IPC: every handoff on the device path, kernel 4 once a
   handoff and bit for bit against the plain gather, kernel 5 once a
   handoff there, one request's installed pages equal to its extracted
   buffer, the tokens against an in-process MIX engine;
4n. multimodal and EPD (run before 4m): Qwen2-VL-2B at full width and
   depth (random weights, seed 0, bf16, page 16): (a) ``encode_images``
   on four seeded 224 px images against the same encoder in f32 (within
   VL_ENC_REL_TOL of max |f32|; ``[4, 64, 1536]``; ms an image is
   information); (b) a MIX and an ENCODE agent on this card sharing the
   weights, behind phase 4f's stub master, which sets
   ``routing.encode_name`` for image requests: eight greedy image chats
   (one or two PNG data URIs each, two chats differing only in their
   image) and two text chats; checks the deltas, every image chat's
   tokens against an in-process ``InferenceEngine`` on the same token ids
   and visual rows, the ENCODE agent's ``encode_count`` equal to the image
   chats and the MIX agent's 0, the two chats' tokens differing,
   ``cached_blocks`` unmoved by image chats, kernel 1 at 28 launches a
   replayed step and the replays, and a non-zero ``mrope_delta`` on a
   slot while image chats decode (read on the engine thread); TTFT and
   tok/s are information; (c) a 360-token two-image prompt chunked by 128
   against its whole install, in f32 at full width and depth: equal
   tokens, kernel 2 on the chunks behind the first; (d) a ``seq=4`` pool:
   two image prompts (no ring) and a 1101-token text prompt (the ring,
   its M-RoPE rows padded), kernel 6 at group 6, 28 a step and shard,
   kernels 1-3 idle, the tokens against the one-device engine's (a
   parting holds only where both streams pass their recomputation); (e)
   a PREFILL agent here and a DECODE agent in a second process (the
   agent's entry point, ``--model-config qwen2_vl_2b``), six of (b)'s
   image chats over CUDA IPC, checked as 4m (h) and every stream equal to
   (b)'s;
4o. the tensor, expert and data axes in one process, on meshes of this
   card repeated (phase 4c's way), eager, at most six requests of TP_NEW
   tokens a leg, each stream held to another route by ``held_to``'s rule:
   (a) Llama-3-8B bf16 at TP_LAYERS layers (``depth_view``) on
   ``model=4`` (phase 4's weights as views, 8/2 heads a shard): kernel 1
   at 4 x TP_LAYERS launches a step, kernel 2 on the prefix hits, the
   tokens against a one-device engine's at that depth, one decode step's
   logits and the
   joined pool against the one-device route (PREFILL_REL_TOL); (b) phase
   4a's tier round trip on that pool at the same depth, kernels 4 and 5
   once a shard on blocks of [TP_LAYERS, 2, 8, 2, 16, 128]; (f) a ``model=2`` PREFILL agent here
   and a ``model=2`` DECODE agent in a second process
   (``--tp-decode-agent``), every handoff over CUDA IPC one handle a
   shard (kernel 4 twice a handoff here, kernel 5 twice there), then the
   same PREFILL agent and an unmeshed DECODE agent here on the host path,
   both against an in-process MIX engine on ``model=2``; inside 4m, (d)
   Mixtral-8x7B int8 and (e) DeepSeek-V2-Lite on ``expert=2 x model=2``
   at 4m (f)'s depth against 4m's one-device streams (kernel 1 at 2 a
   layer a step; MLA's route once a layer a step a model shard over its
   replicated latent pool); after 4m,
   (c) Llama-3-70B int8 at full width and TP70_LAYERS of its 80 layers on
   ``model=8``, drawn straight into int8 (kernel 1 at 8 a layer and step,
   every token against
   its recomputation; build seconds, ``max_memory_allocated`` and tok/s
   are information) and (g) ``parallel/dryrun.py`` at the north-star
   sizes;
4p. one engine instance over processes (``parallel/multihost.py``,
   ``engine/multihost_driver.py``), after 4o (f): every rank a process of
   this script (``--mh-rank``, ``--mh-agent``) with its coordinates on
   ``cuda:0``, so the data plane is gloo (NCCL refuses two ranks on one
   device); each rank draws the weights from seed 0 and keeps only its
   shards. (a) Llama-3-8B bf16 at full width and MH_TP_LAYERS layers on
   ``model=2`` as two ranks, six greedy streams of MH_NEW["a"] tokens and
   a seeded sampled one, against the one-process ``model=2`` engine on the
   same draw driven by the same schedule (``mh_drive``; greedy streams by
   ``held_to``'s rule, the sampled one equal where they all are); (b) the
   agent as two ranks (``--tp 2``, Llama-3-8B cut to MH_AGENT_LAYERS
   layers in its engine configuration) behind the stub master, four
   completions, the follower exiting 0 at the primary's shutdown event;
   (c) Mixtral-8x7B int8 at full width and MH_MOE_LAYERS layers on
   ``expert=2 x model=2`` as four ranks, against the one-process engine
   on that mesh; (d) Llama-3-8B at MH_SEQ_LAYERS layers on ``seq=2`` as
   two ranks (the ring over the ranks, kernel 6 on each), every stream
   equal to the one-process ``seq=2`` engine's. Each rank prints its
   launches (kernels 1 and 2 once a layer a step and on prefix hits,
   kernel 6 once a layer a step on (d)), its memory after the build and
   at the peaks, the ms of ``broadcast_bytes`` a tick and of the
   collectives a decode step, and the backend; every follower emits the
   primary's tokens in the same ticks and steps;
4q. ``seq`` together with ``model`` or ``expert``, after 4p, on this card
   repeated, eager: (a) Llama-3-8B bf16 at full width and GRID_LAYERS
   layers (``depth_view``) on ``seq=2 x model=2`` (phase 4's weights as
   views), its pool the page-and-head grid (four shards ``[GRID_LAYERS, 2,
   1024, 4, 16, 128]``): phase
   4's first four prompts (those of GRID_RING_MIN tokens or more on the
   ring), the first one's re-send and a shared prompt (prefix hits,
   kernel 2) and a seeded sampled request, GRID_NEW tokens each; kernel 6
   at 2 x 2 x GRID_LAYERS launches a step, the greedy streams held to a
   one-device engine's at that depth by ``held_to``'s rule, one decode
   step's logits and the grid against
   the one-device route; tok/s and peak GiB are information; (c) phase
   4a's tier round trip on that grid, kernels 4 and 5 once a model shard
   over both its seq shards; (b) Mixtral-8x7B int8 at MH_MOE_LAYERS layers
   on ``seq=2 x expert=2`` against the ``expert=2`` engine on the same
   weights (the 700-token prompt on the ring; streams by ``held_to``'s
   rule); (d) Llama-3-8B at MH_SEQ_LAYERS layers on ``seq=2 x model=2``
   as four ranks over gloo (``--mh-rank qd``), every stream equal to the
   one-process engine's on that mesh, kernel 6 once a layer a step on
   each rank; (e) a ``seq=2 x model=2`` PREFILL agent here and a
   ``seq=2 x model=2`` DECODE agent in a second process
   (``--tp-decode-agent seq=2,model=2``), 4o (f)'s six requests over CUDA
   IPC, one handle a model shard (kernel 4 twice a handoff here, bit for
   bit against the plain gather; kernel 5 twice there; the probe's
   installed pages equal to its extracted block; the decode side on
   kernel 6), the streams held to an in-process engine on the grid;
4r. after 4q, on this card repeated: (a) Llama-3-8B bf16 at full width
   and depth on ``model=2`` (phase 4's weights as views) with chunks of
   CHUNK: four greedy streams and a seeded sampled one decoding while a
   RIDE_LONG-token prompt is admitted, its chunks riding their decode
   steps (the eager mixed step, once a model shard), against the
   unmeshed chunked engine on the same schedule: as many rides, kernel 2
   once a layer and model shard in every ride step (a shard's 16/4
   heads), kernel 1 once a layer and model shard a step, the greedy
   streams by 4g's rule (every parting a near-tie) and each parted
   stream of the mesh against its recomputation there, one mixed step's
   logits and pool
   against the one-device route; (b) ``ops/pipeline.py`` at Llama-3-8B's
   width, PP_LAYERS layers in f32 (the train loss's layer body), on
   ``pipe`` 2 and 4 with 2 and 4 microbatches against the sequential
   stack; (c) ``parallel/train.py``'s step at Llama-3-8B's width,
   TRAIN_LAYERS layers in f32 (TF32 off), TRAIN_STEPS steps on one batch
   on ``data=2 x model=4`` against the unsharded step: the losses and
   every updated leaf within F32_REL_TOL (a leaf by its norm), the loss
   falling, every copy of a slice equal; tok/s, ms a forward, s a step and peak GiB are
   information;
4u. last, the runtime verifiers (``devtools/``: locks, RCU, state
   ownership, lifecycle pairs) armed in the port's master and agent, and
   the native hot core (``common/native.py``, ``csrc/hotcore.c``) on and
   off (``verified_phase``): masters A (``XLLM_NATIVE=1``) and B
   (``XLLM_NATIVE=0``) and a Llama-3-8B agent at AUTO_LAYERS layers as
   processes of this script (``--verified-master``, ``--verified-agent``,
   started before 4o (c)) on the port's coordination server; phase 4t's
   requests (phase 4's prompts) through A with one client leaving
   mid-stream, then through B (bodies byte-identical but for ids and
   timestamps where the tokens are equal, greedy streams equal to 4t's
   in-process engine's or parting at near-ties), the agent SIGKILLed,
   evicted and replaced by a warm one, xlint over the port's tree clean;
   every process's verifiers must record nothing;
4v. after 4u, the eight service-plane bench twins
   (``xllm_service_tpu_torch/benchmarks/``: ``master_hotpath_bench``,
   ``kvcache_routing_bench``, ``generations_bench``,
   ``bench_tracing_overhead``, ``bench_profile_overhead``,
   ``overload_bench``, ``outage_bench``, ``fleet_bench``), each as
   ``python -m`` on this card's host at the sizes of SERVICE_TWINS against
   the port's master, coordination server and fake engines
   (``services_phase``; the outage twin's paced drive beside the overload
   twin's, the rest one at a time): a line each with its headline keys and wall
   seconds beside the card line and the host's CPUs, each held to the
   reference bench's gate (the profile twin's 1 % gate is printed, not
   held: a timing);
5. a ``kernels`` JSON line, the card line, and the result line.

It needs one card; without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import math
import os
import re
import sys
import threading
import time

import numpy as np
import torch

# Tolerances of the kernel checks, with their reasons.
# f32: kernel and plain version both accumulate in f32 and differ only in
#      summation order; outputs are weighted means of N(0, 1) values.
# bf16: both compute in f32 from identical bf16 inputs and round the output
#      once, so they differ by at most one bf16 ulp: 2**-6 for outputs in
#      [2, 4) (plus the f32 ordering noise).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Cold prefill versus the paged routes (cached prefix, decode step) through
# the full bf16 model: 32 layers of bf16 rounding (unit roundoff 2**-9) on
# differently ordered computations drift by a few percent of the logit
# scale; a masking or page bug moves logits by their whole scale. Bound:
# 10% of max |logit|.
PREFILL_REL_TOL = 0.1
# Two routes' greedy streams may part at a near-tie that bf16 rounding
# breaks either way. A parting passes only where the token taken holds one
# of the reference's two largest logit values (bf16 values tie exactly) and
# trails its top by at most TIE_STEPS bf16 steps at max |logit| (a step is
# 2**-5 for logits in [4, 8)).
TIE_STEPS = 4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, same source
F32_FLOPS = 67e12                # f32 outside the tensor cores, same source
N_Q, N_KV, HD, PS, B, MAX_PAGES = 32, 8, 128, 16, 8, 128


T_START = time.monotonic()


def log(msg: str) -> None:
    """One line of the report; a phase's heading carries the seconds since
    the script started, so a run's log shows where its time went."""
    if msg.startswith("["):
        msg += f"  (at {time.monotonic() - T_START:.1f} s)"
    print(msg, flush=True)


# ---------------------------------------------------------------- helpers
def ptxas_report(text: str) -> list[str]:
    """ptxas -v's output, one line per kernel: its (mangled) name, registers
    and spills."""
    out, fn, spills = [], "", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            used = line[line.index("Used"):].strip()
            out.append(f"{fn}: {used}; {spills}")
    return out


KERNEL_WRAPPERS = []     # every kernel wrapper with a launch count


def reset_counts() -> None:
    """Zero every kernel's launch count (just before a path is driven)."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, with L2 flushed before each (the
    serving path finds K/V cold: other layers ran in between). A spin
    kernel keeps the card busy while the host enqueues the call, so the
    events time the call's kernels and not the host's launch overhead."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)      # ~1 ms of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sweep_splits(module, name, counts, fn):
    """The same call with the host's choice of splits overridden by each of
    ``counts`` (``module.name`` replaced by a constant), timed; information
    only, the timed row is the wrapper's own choice."""
    real = getattr(module, name)
    sweep = {}
    try:
        for n in counts:
            setattr(module, name, lambda *args, n=n: n)
            sweep[n] = time_ms(fn)
    finally:
        setattr(module, name, real)
    return ", ".join(f"{n}: {t:.4f} ms" for n, t in sweep.items())


def paged_inputs(dtype, ctxs, n_pages=MAX_PAGES, seed=0, n_kv=N_KV, hd=HD):
    """Pool with a private page span per row, NaN in every slot past each
    row's context (a pool made with torch.empty can hold NaN there)."""
    rows = len(ctxs)
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = rows * n_pages + 1
    k = torch.randn((P, n_kv, PS, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((P, n_kv, PS, hd), generator=g, device="cuda").to(dtype)
    pt = (torch.arange(rows * n_pages, dtype=torch.int32, device="cuda")
          .reshape(rows, n_pages) + 1)
    pos = torch.arange(n_pages * PS, device="cuda")
    dead = pos[None, :] >= torch.tensor(ctxs, device="cuda")[:, None]
    b_idx, p_idx = dead.nonzero(as_tuple=True)
    page = pt[b_idx, p_idx // PS].long()
    k[page, :, p_idx % PS] = float("nan")
    v[page, :, p_idx % PS] = float("nan")
    return k, v, pt


def gathered(pages, pt, T):
    """[P, n_kv, ps, hd] x [B, mp] -> dense [B, n_kv, T, hd] (first T)."""
    g = pages[pt.long()]                              # [B, mp, n_kv, ps, hd]
    Bn, mp, n_kv, ps, hd = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(Bn, n_kv, mp * ps, hd)[:, :, :T]


def sdpa(q, k, v, mask=None):
    """The yardstick: PyTorch's fused attention (GQA-aware) on K/V already
    gathered dense. Timed here only: no kernel route of the port calls it
    (the port's one SDPA call is the prefix-free prefill, work that no
    Pallas kernel did, held against the f32 path in phase 4g)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


# ---------------------------------------------------------------- phase 3
def check_decode_kernel(paged_attention, paged_attention_plain, split_count,
                        kernel_fn):
    from xllm_service_tpu_torch.ops.paged_attention import (
        planned_blocks_per_sm,
    )

    err = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # Ragged contexts up to the full table, then what split-K brings: a
    # context shorter than one split (3), one whose last split holds part of
    # one page (67: units 0-1, 2-3, 4 and an empty split at four splits),
    # one row alone (the most splits), and a window that starts inside a
    # later split's unit (ctx 1000, window 300: position 700).
    cases = [
        ([0, 1, 7, 16, 17, 500, 1000, MAX_PAGES * PS], {}),
        ([67, 3, 33, MAX_PAGES * PS, 1029, 515, 130, 64], {}),
        ([777], {}),
        ([1000, 67, 301, 0, 2048, 300, 16, 1500], {"window": 300}),
        ([1000], {"window": 300, "softcap": 30.0}),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        plan = planned_blocks_per_sm("paged_attention", HD, N_Q // N_KV,
                                     dtype == torch.bfloat16)
        for ctxs, opts in cases:
            rows = len(ctxs)
            k, v, pt = paged_inputs(dtype, ctxs)
            q = torch.randn((rows, N_Q, HD), device="cuda").to(dtype)
            cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
            got = paged_attention(q, k, v, pt, cl, **opts)
            want = paged_attention_plain(q, k, v, pt, cl, **opts)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), "decode kernel: non-finite"
            for b, c in enumerate(ctxs):
                assert c > 0 or (got[b] == 0).all(), \
                    "decode kernel: ctx 0 row not zero"
            e = (got.float() - want.float()).abs().max().item()
            log(f"  paged_attention {str(dtype)[6:]:8s} ctx={ctxs} {opts} "
                f"splits={split_count(rows, N_KV, MAX_PAGES, PS, sms, plan)} "
                f"max_abs_err={e:.3g} (tol {TOL[dtype]})")
            assert e <= TOL[dtype], "decode kernel disagrees with plain"
            err = max(err, e)

    # Timing at the decode step's shapes: B 8, ctx 1024, bf16.
    ctx = 1024
    k, v, pt = paged_inputs(torch.bfloat16, [ctx] * B, seed=1)
    q = torch.randn((B, N_Q, HD), device="cuda").to(torch.bfloat16)
    cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    kd, vd = gathered(k, pt, ctx).contiguous(), gathered(v, pt, ctx).contiguous()
    qd = q[:, :, None, :]
    ms = time_ms(lambda: paged_attention(q, k, v, pt, cl))
    plain_ms = time_ms(lambda: paged_attention_plain(q, k, v, pt, cl))
    lib_ms = time_ms(lambda: sdpa(qd, kd, vd))
    nbytes = (2 * q.numel() * 2 + B * ctx * N_KV * HD * 2 * 2
              + B * (ctx // PS) * 4 + B * 4)
    ops = 4 * N_Q * HD * B * ctx
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
    log(f"  paged_attention bf16 B={B} ctx={ctx}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    per_sm = kernel_fn("paged_attention", "paged_attention_blocks_per_sm",
                       [ctypes.c_int] * 3)(HD, N_Q // N_KV, 1)
    log(f"  paged_attention: splits "
        f"{split_count(B, N_KV, MAX_PAGES, PS, sms, 2)} on {sms} SMs, "
        f"{per_sm} blocks per SM (the plan takes 2); "
        f"{ms / lib_ms:.2f}x the library's time, "
        f"{ms / bound:.1f}x the bound, "
        f"{nbytes / ms / 1e9 / (HBM_BYTES_PER_S / 1e12):.1%} of "
        f"{HBM_BYTES_PER_S / 1e12} TB/s")
    # What the host's choice of splits is worth.
    from xllm_service_tpu_torch.ops import paged_attention as pa_mod
    log("  paged_attention: splits sweep " + sweep_splits(
        pa_mod, "split_count", (1, 2, 4, 8),
        lambda: paged_attention(q, k, v, pt, cl)))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_FLOPS else "operations", library_ms=lib_ms)


def check_mq_kernel(mq_paged_attention, mq_paged_attention_plain, kernel_fn):
    err = 0.0
    # Sq 70 is no multiple of the 16-query tile; its second row has a block
    # length of 0 (every query padding, so the row comes out zero).
    for dtype in (torch.bfloat16, torch.float32):
        for s_q in (1, 17, 70, 512):
            for prefix in (0, 5, 384):      # none, a partial page, 3 blocks
                blocks = [s_q, 0 if s_q == 70 else max(1, s_q - 3)]
                ends = [prefix + b for b in blocks]
                k, v, pt = paged_inputs(dtype, ends, seed=2)
                q = torch.randn((2, s_q, N_Q, HD), device="cuda").to(dtype)
                pre = torch.full((2,), prefix, dtype=torch.int32,
                                 device="cuda")
                blk = torch.tensor(blocks, dtype=torch.int32, device="cuda")
                got = mq_paged_attention(q, k, v, pt, pre, blk)
                want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), "mq kernel: non-finite"
                assert blocks[1] > 0 or (got[1] == 0).all(), \
                    "mq kernel: a row with no block is not zero"
                e = (got.float() - want.float()).abs().max().item()
                log(f"  mq_paged_attention {str(dtype)[6:]:8s} Sq={s_q:3d} "
                    f"prefix={prefix:3d} max_abs_err={e:.3g} "
                    f"(tol {TOL[dtype]})")
                assert e <= TOL[dtype], "mq kernel disagrees with plain"
                err = max(err, e)

    # Timing at a prefix-hit prefill's shapes: one row, 512 new tokens
    # behind a 512-token cached prefix, bf16.
    s_q, prefix = 512, 512
    k, v, pt = paged_inputs(torch.bfloat16, [prefix + s_q], seed=3)
    q = torch.randn((1, s_q, N_Q, HD), device="cuda").to(torch.bfloat16)
    pre = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    blk = torch.tensor([s_q], dtype=torch.int32, device="cuda")
    T = prefix + s_q
    kd, vd = gathered(k, pt, T).contiguous(), gathered(v, pt, T).contiguous()
    qd = q.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :]
            <= prefix + torch.arange(s_q, device="cuda")[:, None])
    ms = time_ms(lambda: mq_paged_attention(q, k, v, pt, pre, blk))
    plain_ms = time_ms(lambda: mq_paged_attention_plain(q, k, v, pt, pre, blk))
    lib_ms = time_ms(lambda: sdpa(qd, kd, vd, mask))
    nbytes = 2 * q.numel() * 2 + T * N_KV * HD * 2 * 2 + (T // PS) * 4 + 8
    pairs = s_q * prefix + s_q * (s_q + 1) // 2
    ops = 4 * N_Q * HD * pairs
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
    log(f"  mq_paged_attention bf16 Sq={s_q} prefix={prefix}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    per_sm = kernel_fn("mq_paged_attention",
                       "mq_paged_attention_blocks_per_sm", [ctypes.c_int])(HD)
    log(f"  mq_paged_attention: {per_sm} blocks per SM; "
        f"{ms / lib_ms:.2f}x the library's time, "
        f"{ms / bound:.1f}x the bound, {ops / ms / 1e9:.1f} TFLOP/s")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_FLOPS else "operations", library_ms=lib_ms)


VERIFY_SQ = 5                          # a verify block at speculate_k=4
VERIFY_BLOCKS = [5, 5, 1, 0, 5, 5, 1, 5]   # eligible, ineligible, idle rows
VERIFY_PREFIXES = [256, 512, 768, 1024, 1280, 1536, 384, 1152]


def check_mq_verify(mq_paged_attention, mq_paged_attention_plain):
    """Kernel 2 at the speculative verify's shapes (B 8, Sq 5, block
    lengths 5, 1 and 0 in one call, prefixes 256-1536), bf16 (the
    tensor-core route) and f32 (the walk), each against its plain version,
    and timed beside one masked SDPA call on the same K/V gathered dense
    and the bound; bf16 also at a uniform prefix of 1024, every block 5
    (kernel 1's timing context). Returns the timings by case."""
    out = {}
    for dtype, name, prefixes, blocks in (
            (torch.bfloat16, "mixed", VERIFY_PREFIXES, VERIFY_BLOCKS),
            (torch.float32, "mixed", VERIFY_PREFIXES, VERIFY_BLOCKS),
            (torch.bfloat16, "ctx 1024", [1024] * B, [VERIFY_SQ] * B)):
        ends = [p + b for p, b in zip(prefixes, blocks)]
        k, v, pt = paged_inputs(dtype, ends, seed=8)
        q = torch.randn((B, VERIFY_SQ, N_Q, HD), device="cuda").to(dtype)
        pre = torch.tensor(prefixes, dtype=torch.int32, device="cuda")
        blk = torch.tensor(blocks, dtype=torch.int32, device="cuda")
        got = mq_paged_attention(q, k, v, pt, pre, blk)
        want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "mq kernel: non-finite (verify)"
        e = (got.float() - want.float()).abs().max().item()
        for b_, n in enumerate(blocks):
            assert (got[b_, n:] == 0).all(), "a padding query is not zero"
        assert e <= TOL[dtype], "mq kernel disagrees with plain (verify)"
        T = max(ends)
        kd = gathered(k, pt, T).contiguous()
        vd = gathered(v, pt, T).contiguous()
        qd = q.transpose(1, 2).contiguous()
        s_idx = torch.arange(VERIFY_SQ, device="cuda")
        # Query s of row b sees keys <= prefix_b + s; a padding query sees
        # key 0 only (its output is dropped; an empty row would be NaN).
        hi = torch.where(s_idx[None, :] < blk[:, None],
                         pre[:, None] + s_idx[None, :], 0)
        mask = (torch.arange(T, device="cuda")[None, None, :]
                <= hi[:, :, None])[:, None]
        ms = time_ms(lambda: mq_paged_attention(q, k, v, pt, pre, blk))
        plain_ms = time_ms(
            lambda: mq_paged_attention_plain(q, k, v, pt, pre, blk))
        lib = time_ms(lambda: sdpa(qd, kd, vd, mask))
        eb = q.element_size()
        nbytes = (2 * q.numel() * eb
                  + sum(e_ for e_, bl in zip(ends, blocks) if bl > 0)
                  * N_KV * HD * 2 * eb + B * MAX_PAGES * 4 + 2 * B * 4)
        ops = 4 * N_Q * HD * sum(bl * p + bl * (bl + 1) // 2
                                 for p, bl in zip(prefixes, blocks))
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / peak)
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak \
            else "operations"
        out[(str(dtype)[6:], name)] = dict(ms=ms, plain_ms=plain_ms,
                                           library_ms=lib, bound_ms=bound,
                                           bound_by=by, max_abs_err=e)
        log(f"  mq_paged_attention {str(dtype)[6:]} verify B={B} "
            f"Sq={VERIFY_SQ} ({name}: blocks {blocks}, prefixes "
            f"{min(prefixes)}-{max(prefixes)}): max_abs_err={e:.3g} (tol "
            f"{TOL[dtype]}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib:.4f} ms ({ms / lib:.2f}x), bound {bound:.4f} ms "
            f"({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), "
            f"{ms / bound:.1f}x the bound")
    return out


def check_fused_kernel(fused_decode_attention, fused_decode_attention_plain,
                       split_count, kernel_fn):
    """Kernel 3 against its plain version: the output within TOL, both pools
    after the call equal bit for bit (the append is a copy). Its walk covers
    ctx - 1 pooled tokens, so the split-K edges sit one token later than
    kernel 1's: a walk shorter than one split (ctx 4), one whose last split
    holds part of one page (68: units 0-1, 2-3, 4 and an empty split at four
    splits), a full table, and one row alone (the most splits)."""
    from xllm_service_tpu_torch.ops import fused_decode_attention as fd_mod
    from xllm_service_tpu_torch.ops.paged_attention import (
        planned_blocks_per_sm,
    )

    err = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [[0, 1, 16, 17, 500, 777, 1024, MAX_PAGES * PS],
             [68, 4, 34, MAX_PAGES * PS, 1030, 516, 131, 65],
             [778]]
    for dtype in (torch.bfloat16, torch.float32):
        plan = planned_blocks_per_sm("fused_decode_attention", HD,
                                     N_Q // N_KV, dtype == torch.bfloat16)
        for ctxs in cases:
            rows = len(ctxs)
            k, v, pt = paged_inputs(dtype, ctxs, seed=4)
            q = torch.randn((rows, N_Q, HD), device="cuda").to(dtype)
            k_new = torch.randn((rows, N_KV, HD), device="cuda").to(dtype)
            v_new = torch.randn((rows, N_KV, HD), device="cuda").to(dtype)
            cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
            kp, vp = k.clone(), v.clone()
            got = fused_decode_attention(q, k_new, v_new, kp, vp, pt, cl)[0]
            want = fused_decode_attention_plain(q, k_new, v_new, k, v, pt,
                                                cl)[0]
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), "fused kernel: non-finite output"
            e = (got.float() - want.float()).abs().max().item()
            same_pools = all(
                torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in ((kp, k), (vp, v)))
            log(f"  fused_decode_attention {str(dtype)[6:]:8s} ctx={ctxs} "
                f"splits={split_count(rows, N_KV, MAX_PAGES, PS, sms, plan)} "
                f"max_abs_err={e:.3g} (tol {TOL[dtype]}), pools "
                f"bit-identical {same_pools}")
            assert e <= TOL[dtype], "fused kernel disagrees with plain"
            assert same_pools, "fused kernel's append differs from plain"
            err = max(err, e)

    # Timing at the decode step's shapes: B 8, ctx 1024, bf16.
    ctx = 1024
    k, v, pt = paged_inputs(torch.bfloat16, [ctx] * B, seed=5)
    q = torch.randn((B, N_Q, HD), device="cuda").to(torch.bfloat16)
    k_new = torch.randn((B, N_KV, HD), device="cuda").to(torch.bfloat16)
    v_new = torch.randn((B, N_KV, HD), device="cuda").to(torch.bfloat16)
    cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    kd, vd = gathered(k, pt, ctx).contiguous(), gathered(v, pt, ctx).contiguous()
    qd = q[:, :, None, :]

    def call():
        return fused_decode_attention(q, k_new, v_new, k, v, pt, cl)

    ms = time_ms(call)
    plain_ms = time_ms(lambda: fused_decode_attention_plain(
        q, k_new, v_new, k, v, pt, cl))
    lib_ms = time_ms(lambda: sdpa(qd, kd, vd))
    # q and the output, the new rows read and written, ctx - 1 pooled tokens
    # of K and V, one page-table entry per page read, the lengths.
    nbytes = (2 * q.numel() * 2 + 2 * 2 * k_new.numel() * 2
              + B * (ctx - 1) * N_KV * HD * 2 * 2
              + B * (-(-(ctx - 1) // PS)) * 4 + B * 4)
    ops = 4 * N_Q * HD * B * ctx
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
    log(f"  fused_decode_attention bf16 B={B} ctx={ctx}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    per_sm = kernel_fn("fused_decode_attention",
                       "fused_decode_attention_blocks_per_sm",
                       [ctypes.c_int] * 3)(HD, N_Q // N_KV, 1)
    log(f"  fused_decode_attention: splits "
        f"{split_count(B, N_KV, MAX_PAGES, PS, sms, 2)} on {sms} SMs, "
        f"{per_sm} blocks per SM (the plan takes 2); {ms / lib_ms:.2f}x the "
        f"library's time, "
        f"{ms / bound:.1f}x the bound")
    log("  fused_decode_attention: splits sweep "
        + sweep_splits(fd_mod, "split_count", (1, 2, 4, 8), call))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_FLOPS else "operations", library_ms=lib_ms)


def mover_case(page_dma, kv, ids, untouched, block, tag):
    """Gather and scatter of ``ids`` on pool ``kv`` (a tensor or a
    ``ShardedPages``) against the plain versions, bit for bit; the pages
    in ``untouched`` must keep their bits, and each call must be one
    launch."""
    full = (lambda t: t.full()) if hasattr(kv, "shards") else (lambda t: t)
    clone = ((lambda t: type(t)([s.clone() for s in t.shards], t.mesh))
             if hasattr(kv, "shards") else (lambda t: t.clone()))
    dtype = block.dtype
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    g0 = page_dma.gather_kv_pages.launches
    s0 = page_dma.scatter_kv_pages.launches
    got = page_dma.gather_kv_pages(kv, ids)
    want = page_dma.gather_kv_pages_plain(kv, ids)
    pool, ref = clone(kv), clone(kv)
    page_dma.scatter_kv_pages(pool, ids, block)
    page_dma.scatter_kv_pages_plain(ref, ids, block)
    torch.cuda.synchronize()
    launches = (page_dma.gather_kv_pages.launches - g0,
                page_dma.scatter_kv_pages.launches - s0)
    g_ok = torch.equal(got.view(bits), want.view(bits))
    s_ok = torch.equal(full(pool).view(bits), full(ref).view(bits))
    kept = torch.equal(full(pool)[:, :, untouched].view(bits),
                       full(kv)[:, :, untouched].view(bits))
    log(f"  page movers {tag} {str(dtype)[6:]:8s} block {tuple(want.shape)}: "
        f"gather bit-identical {g_ok}, scatter bit-identical {s_ok}, other "
        f"pages untouched {kept}, launches gather/scatter {launches}")
    assert g_ok and s_ok and kept, "a page mover disagrees with plain"
    assert launches == (1, 1), "a page mover call took more than one launch"


def sweep_movers(page_dma, gather, scatter):
    """The movers with the bulk route's shape overridden (stages x chunk x
    blocks per SM, every combination whose ring fits the SM's shared
    memory), each timed; information only, the timed rows use the
    module's own shape."""
    keys = ("STAGES", "CHUNK_BYTES", "BLOCKS_PER_SM")
    real = {k: getattr(page_dma, k) for k in keys}
    configs = [(st, ck << 10, bps) for bps in (1, 2) for st in (2, 4, 8)
               for ck in (4, 8, 16, 32) if bps * st * ck <= 220]
    out = []
    try:
        for cfg in configs:
            for k, val in zip(keys, cfg):
                setattr(page_dma, k, val)
            g_ms, s_ms = time_ms(gather), time_ms(scatter)
            log(f"  page movers sweep stages={cfg[0]} chunk={cfg[1] >> 10}K "
                f"blocks/SM={cfg[2]}: gather {g_ms:.4f} ms, scatter "
                f"{s_ms:.4f} ms")
            out.append((g_ms + s_ms, cfg))
    finally:
        for k, val in real.items():
            setattr(page_dma, k, val)
    best = min(out)
    log(f"  page movers sweep: fastest {best[1]} ({best[0] / 2:.4f} ms "
        f"mean); shipped {tuple(real.values())}")


def check_page_movers(page_dma, build_mesh, MeshConfig, ShardedPages,
                      L=32, n_kv=N_KV, hd=HD, what="llama3-8b", sweep=True,
                      seq=4):
    """Kernels 4-5 against their plain versions at one hash block of 128
    tokens, ``[L, 2, 8, n_kv, 16, hd]`` (Llama-3-8B's [32, 2, 8, 8, 16,
    128] by default; DeepSeek-V2-Lite's MLA block is [27, 2, 8, 1, 16,
    576]; a ``seq=2 x model=2`` grid shard's is [GRID_LAYERS, 2, 8, 4, 16,
    128] on ``seq=2``): bit for bit, with NaN in every page they must not touch,
    on one pool and on the same pool sharded ``seq`` ways on one card (the
    block's eight pages on every shard), one launch per call. Then times,
    the bulk route's sweep (``sweep``) and the copy floor. Returns
    (gather row, scatter row)."""
    ppb, n_pages = 8, 40
    ids = [17, 3, 29, 8, 35, 1, 22, 12]                  # shuffled, 8 pages
    untouched = [p for p in range(n_pages) if p not in ids]
    mesh = build_mesh(MeshConfig(seq=seq), ["cuda:0"] * seq)
    assert sorted({p // (n_pages // seq) for p in ids}) == list(range(seq))
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(6)
        kv = torch.randn((L, 2, n_pages, n_kv, PS, hd), generator=g,
                         device="cuda").to(dtype)
        kv[:, :, untouched] = float("nan")
        block = torch.randn((L, 2, ppb, n_kv, PS, hd), generator=g,
                            device="cuda").to(dtype)
        mover_case(page_dma, kv, ids, untouched, block, f"{what} pool")
        sharded = ShardedPages([c.contiguous()
                                for c in kv.chunk(seq, dim=2)], mesh)
        mover_case(page_dma, sharded, ids, untouched, block,
                   f"{what} {seq} shards")

    # Timing at one bf16 hash block (the offload and onload of one block).
    kv = torch.randn((L, 2, n_pages, n_kv, PS, hd), device="cuda").to(
        torch.bfloat16)
    block = torch.randn((L, 2, ppb, n_kv, PS, hd), device="cuda").to(
        torch.bfloat16)
    ids_d = torch.tensor(ids, device="cuda")
    # Each byte of the block read once and written once, and the ids.
    nbytes = 2 * block.numel() * 2 + len(ids) * 4
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    sharded = ShardedPages([c.contiguous() for c in kv.chunk(seq, dim=2)],
                           mesh)
    # The copy floor: the card's own contiguous copy of the same bytes (a
    # yardstick only; the port never calls it).
    src = torch.empty_like(block)
    dst = torch.empty_like(block)
    floor_ms = time_ms(lambda: dst.copy_(src))
    rows = []
    for name, kernel, plain, lib, shard_call in (
            ("gather_kv_pages",
             lambda: page_dma.gather_kv_pages(kv, ids),
             lambda: page_dma.gather_kv_pages_plain(kv, ids_d),
             lambda: kv.index_select(2, ids_d),
             lambda: page_dma.gather_kv_pages(sharded, ids)),
            ("scatter_kv_pages",
             lambda: page_dma.scatter_kv_pages(kv, ids, block),
             lambda: page_dma.scatter_kv_pages_plain(kv, ids_d, block),
             lambda: kv.index_copy_(2, ids_d, block),
             lambda: page_dma.scatter_kv_pages(sharded, ids, block))):
        ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(lib)
        shard_ms = time_ms(shard_call)
        log(f"  {name} {what} bf16 block {tuple(block.shape)}: kernel "
            f"{ms:.4f} ms "
            f"({seq} shards {shard_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, copy floor {floor_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{nbytes / ms / 1e9:.3f} TB/s, {bound / ms:.1%} of the bound)")
        rows.append(dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by="bytes", library_ms=lib_ms))
    if sweep:
        sweep_movers(page_dma, lambda: page_dma.gather_kv_pages(kv, ids),
                     lambda: page_dma.scatter_kv_pages(kv, ids, block))
    return rows


def poison_unowned(k, v, pt, ctxs):
    """NaN into every (page, slot) of the pool that no row occupies below
    its context: what a shard holds outside its owned, occupied pages."""
    P = k.shape[0]
    keep = torch.zeros((P, PS), dtype=torch.bool, device="cuda")
    pos = torch.arange(pt.shape[1] * PS, device="cuda")
    for b, ctx in enumerate(ctxs):
        live = pos[:ctx]
        keep[pt[b, live // PS].long(), live % PS] = True
    k.masked_fill_(~keep[:, None, :, None], float("nan"))
    v.masked_fill_(~keep[:, None, :, None], float("nan"))


def cp_case(dtype, ctxs, seed, tail_row=None, n_q=N_Q, n_kv=N_KV, hd=HD):
    """Inputs of kernel 6's check: a pool of B * MAX_PAGES + 8 pages (the
    count divides by 2 and 4), tables a permutation of pages 4..P-2 across
    every shard, NaN in every slot no row occupies below its context. Row 1
    (when there are two rows or more) sits on the garbage page. Row
    ``tail_row`` (four pages long) holds pages 1, 2, 3 of shard 0's range
    and, for its last, partial page, page P - 1 of the last shard's range,
    so that shard owns only that page of the row."""
    rows = len(ctxs)
    P = B * MAX_PAGES + 8
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn((P, n_kv, PS, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((P, n_kv, PS, hd), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(P - 5, generator=torch.Generator().manual_seed(seed))
    pt = (perm[:rows * MAX_PAGES] + 4).reshape(rows, MAX_PAGES).to(
        torch.int32).cuda()
    if rows > 1:
        pt[1] = 0
    if tail_row is not None:
        assert -(-ctxs[tail_row] // PS) == 4, "the tail row holds four pages"
        pt[tail_row, :4] = torch.tensor([1, 2, 3, P - 1], dtype=torch.int32)
    poison_unowned(k, v, pt, ctxs)
    q = torch.randn((rows, n_q, hd), device="cuda").to(dtype)
    cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    return q, k, v, pt, cl


def check_cp_kernel(cp, paged_attention, paged_attention_plain,
                    build_mesh, MeshConfig, kernel_fn, n_q=N_Q, n_kv=N_KV,
                    what="llama3-8b's 32/8 heads", extras=True, seq=4):
    """Kernel 6 against its plain version, shard by shard, at seq 2 and 4;
    the whole CP op against single-device attention on the same pool; then
    times at the decode step's shapes, with ``n_q``/``n_kv`` heads at head
    dim 128, on shard 0 of ``seq`` (``extras``: the splits sweep and the
    whole op's time beside kernel 1's).

    Cases: ragged contexts up to the full table; kernel 1's split-K edges
    (a context shorter than one split, 3; one whose last split holds part
    of one page, 67; a row whose last, partial page is all one shard owns
    of it, 3 * 16 + 5) beside empty rows; one row alone (the most splits).
    Checks: rows where the plain version sees nothing (m <= NEG_INF / 2)
    must match exactly (m = NEG_INF, l = 0, acc = 0); elsewhere m within
    TOL, and l and acc within TOL after dividing by max(l, 1): both are
    sums of up to ctx terms weighted by p <= 1, so their rounding grows
    with l. The merged output is compared within TOL."""
    from xllm_service_tpu_torch.ops.paged_attention import (
        NEG_INF,
        planned_blocks_per_sm,
    )

    err = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [([0, 1, 16, 17, 500, 777, 1024, MAX_PAGES * PS], None),
             ([67, 3, 33, 3 * PS + 5, 0, 1029, 130, MAX_PAGES * PS], 3),
             ([777], None)]
    for dtype in (torch.bfloat16, torch.float32):
        for ci, (ctxs, tail_row) in enumerate(cases):
            q, k, v, pt, cl = cp_case(dtype, ctxs, 8 + ci, tail_row,
                                      n_q=n_q, n_kv=n_kv)
            rows, P = len(ctxs), k.shape[0]
            want = paged_attention_plain(q, k, v, pt, cl)
            for n in (2, 4):
                mesh = build_mesh(MeshConfig(seq=n), ["cuda:0"] * n)
                k_sh, v_sh = list(k.chunk(n)), list(v.chunk(n))
                P_loc = P // n
                splits = cp.partial_split_count(
                    rows, n_kv, MAX_PAGES, PS, sms, n, planned_blocks_per_sm(
                        "cp_paged_partial", HD, n_q // n_kv,
                        dtype == torch.bfloat16))
                for d in range(n):
                    tables = cp.compact_local_table(pt, cl, d * P_loc, P_loc,
                                                    PS)
                    m, l, acc = cp.paged_partial(q, k_sh[d], v_sh[d],
                                                 *tables, cl, shards=n)
                    m0, l0, a0 = cp.paged_partial_plain(q, k_sh[d], v_sh[d],
                                                        *tables, cl)
                    torch.cuda.synchronize()
                    dead = m0 <= NEG_INF / 2
                    assert torch.equal(dead, m <= NEG_INF / 2), \
                        "cp partial: masked rows differ"
                    assert (m[dead] == m0[dead]).all() and \
                        (l[dead] == 0).all() and (acc[dead] == 0).all(), \
                        "cp partial: a row the shard does not touch is not " \
                        "empty"
                    assert torch.isfinite(acc).all() and \
                        torch.isfinite(l).all()
                    lsc = l0.clamp_min(1.0)
                    e = max((m - m0)[~dead].abs().max().item()
                            if (~dead).any() else 0.0,
                            ((l - l0).abs() / lsc).max().item(),
                            ((acc - a0).abs() / lsc[..., None]).max().item())
                    log(f"  cp_paged_partial {what} {str(dtype)[6:]:8s} "
                        f"ctx={ctxs} "
                        f"seq={n} shard {d} splits={splits}: n_local "
                        f"{tables[2].tolist()}, err={e:.3g} "
                        f"(tol {TOL[dtype]})")
                    assert e <= TOL[dtype], "cp partial disagrees with plain"
                    err = max(err, e)
                got = cp.cp_paged_attention(q, k_sh, v_sh, pt, cl, mesh)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                log(f"  cp_paged_attention {what} {str(dtype)[6:]:8s} "
                    f"ctx={ctxs} "
                    f"seq={n} vs single-device plain: max_abs_err={e:.3g} "
                    f"(tol {TOL[dtype]})")
                assert torch.isfinite(got).all()
                for b, c in enumerate(ctxs):
                    assert c > 0 or (got[b] == 0).all(), \
                        "cp op: a ctx-0 row is not zero"
                assert e <= TOL[dtype], "cp op disagrees with single-device"
                err = max(err, e)

    # Timing at the decode step's shapes over ``seq`` shards: B 8, ctx
    # 1024, bf16; entry j of every row on shard j % seq, so each shard owns
    # 64 / seq of a row's 64 pages, at positions that are not contiguous.
    n, ctx, mp = seq, 1024, 1024 // PS
    P = 4 * B * mp + 4
    P_loc = P // n
    k = torch.randn((P, n_kv, PS, HD), device="cuda").to(torch.bfloat16)
    v = torch.randn((P, n_kv, PS, HD), device="cuda").to(torch.bfloat16)
    j = torch.arange(mp, device="cuda")
    pt = ((j % n) * P_loc + 1 + torch.arange(B, device="cuda")[:, None] * mp
          // n + j // n).to(torch.int32)                   # [B, 64], unique
    q = torch.randn((B, n_q, HD), device="cuda").to(torch.bfloat16)
    cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    mesh = build_mesh(MeshConfig(seq=n), ["cuda:0"] * n)
    k_sh, v_sh = list(k.chunk(n)), list(v.chunk(n))
    tabs = cp.cp_tables(pt, cl, cp.ShardedPages(k_sh, mesh))
    t0 = tabs[0]
    own = int(t0[2].sum())                      # pages shard 0 walks
    assert own == B * mp // n

    def call():
        return cp.paged_partial(q, k_sh[0], v_sh[0], *t0, shards=n)

    ms = time_ms(call)
    plain_ms = time_ms(lambda: cp.paged_partial_plain(q, k_sh[0], v_sh[0],
                                                      *t0))
    # The yardstick: SDPA over shard 0's owned pages of each row, gathered
    # dense (each row owns the same count here).
    local = t0[0][:, :mp // n].long()
    kd = k_sh[0][local].permute(0, 2, 1, 3, 4).reshape(
        B, n_kv, mp // n * PS, HD).contiguous()
    vd = v_sh[0][local].permute(0, 2, 1, 3, 4).reshape(
        B, n_kv, mp // n * PS, HD).contiguous()
    lib_ms = time_ms(lambda: sdpa(q[:, :, None, :], kd, vd))
    # q, the f32 outputs (m, l, acc), the owned K/V, the owned entries of
    # local_pt and starts, n_local and the lengths.
    tok = own * PS
    nbytes = (q.numel() * 2 + B * n_q * (2 + HD) * 4 + tok * n_kv * HD * 2 * 2
              + own * 4 * 2 + B * 4 * 2)
    ops = 4 * n_q * HD * tok
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
    log(f"  cp_paged_partial {what} bf16 B={B} ctx={ctx} shard 0 of {n} "
        f"({own} owned pages): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} GFLOP)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = kernel_fn("cp_paged_partial", "cp_paged_partial_blocks_per_sm",
                       [ctypes.c_int] * 3)(HD, n_q // n_kv, 1)
    log(f"  cp_paged_partial {what}: splits "
        f"{cp.partial_split_count(B, n_kv, mp, PS, sms, n, 2)} on {sms} SMs, "
        f"{per_sm} blocks per SM (the plan takes 2); {ms / lib_ms:.2f}x the "
        f"library's time, "
        f"{ms / bound:.1f}x the bound")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S
               >= ops / BF16_FLOPS else "operations", library_ms=lib_ms)
    if not extras:
        return row
    log("  cp_paged_partial: splits sweep "
        + sweep_splits(cp, "partial_split_count", (1, 2, 4), call))
    # The whole CP op (n partial launches and the merge) against kernel 1
    # at the same B and ctx on the unsharded pool; the step's compaction,
    # shared by all layers, apart.
    op_ms = time_ms(lambda: cp.cp_paged_attention(q, k_sh, v_sh, pt, cl, mesh,
                                                  tables=tabs))
    tab_ms = time_ms(lambda: cp.cp_tables(pt, cl, cp.ShardedPages(k_sh, mesh)))
    k1_ms = time_ms(lambda: paged_attention(q, k, v, pt, cl))
    log(f"  cp_paged_attention bf16 B={B} ctx={ctx} seq={n}: {op_ms:.4f} ms "
        f"(4 partials + merge), tables {tab_ms:.4f} ms per step; kernel 1 "
        f"on the unsharded pool {k1_ms:.4f} ms")
    return row



# ------------------------------------------------ phase 3, head dim 256
# Gemma-2-9B's attention options (query_pre_attn_scalar 256: scale 1/16)
# and the two Gemma groups, as (n_q, n_kv): Gemma-2-9B's 16/8, Gemma-2B's
# 8/1.
GEMMA2_OPTS = {"softcap": 50.0, "scale": 1 / 16}
HD256_GROUPS = ((16, 8), (8, 1))
HD256_CASES = [[0, 1, 7, 16, 17, 500, 1000, MAX_PAGES * PS],
               [67, 3, 33, MAX_PAGES * PS, 1029, 515, 130, 64], [777]]
HD256_OPTS = [{}, {"window": 300}, GEMMA2_OPTS,
              {**GEMMA2_OPTS, "window": 300}]
# Cases where the cap bites, as (gain on q, options): with N(0, 1) q and k
# the scores at scale 1/16 have a deviation of 1, where a cap of 50 moves
# them by under 0.01; q scaled up brings them to a good share of the cap.
# Each case first shows, on the plain version, that dropping the cap moves
# the output by more than CAP_MOVES, so a kernel without it fails there.
HD256_CAPPED = [(4.0, {"softcap": 5.0, "scale": 1 / 16}),
                (16.0, GEMMA2_OPTS),
                (16.0, {**GEMMA2_OPTS, "window": 300})]
CAP_MOVES = 0.2                         # ten times the bf16 tolerance


def bound_of(nbytes, ops, peak=BF16_FLOPS):
    """(bound ms, what bounds it) of a call moving ``nbytes`` and doing
    ``ops`` operations at ``peak``."""
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / peak), by


def check_hd256_decode(paged_attention, paged_attention_plain, split_count):
    """Kernel 1 at head dim 256 against its plain version: both Gemma
    groups, both types, phase 3's context mixes, each with no option, a
    window of 300, Gemma-2's softcap and scale, and all three, and each
    with q scaled so that the cap bites (HD256_CAPPED); then timed
    at Gemma-2-9B's decode (B 8, 16/8 heads): behind 1024 tokens, and
    behind 4608 with the softcap and scale on a local layer (window 4096)
    and a global one. No PyTorch call computes a softcapped attention, so
    the softcapped shapes have no library time; SDPA at the same shape
    without cap or window is logged as information. Returns the timings
    by case."""
    from xllm_service_tpu_torch.ops.paged_attention import blocks_per_sm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        for n_q, n_kv in HD256_GROUPS:
            err, cap_moved = 0.0, float("inf")
            for ctxs in HD256_CASES:
                k, v, pt = paged_inputs(dtype, ctxs, seed=20, n_kv=n_kv,
                                        hd=256)
                q = torch.randn((len(ctxs), n_q, 256), device="cuda").to(
                    dtype)
                cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
                for opts in HD256_OPTS:
                    got = paged_attention(q, k, v, pt, cl, **opts)
                    want = paged_attention_plain(q, k, v, pt, cl, **opts)
                    torch.cuda.synchronize()
                    assert torch.isfinite(got).all(), "hd 256: non-finite"
                    for b, c in enumerate(ctxs):
                        assert c > 0 or (got[b] == 0).all(), \
                            "hd 256: ctx 0 row not zero"
                    e = (got.float() - want.float()).abs().max().item()
                    assert e <= TOL[dtype], \
                        f"decode kernel at hd 256 disagrees ({ctxs}, {opts})"
                    err = max(err, e)
                for gain, opts in HD256_CAPPED:
                    qc = (q.float() * gain).to(dtype)
                    got = paged_attention(qc, k, v, pt, cl, **opts)
                    want = paged_attention_plain(qc, k, v, pt, cl, **opts)
                    uncapped = paged_attention_plain(
                        qc, k, v, pt, cl,
                        **{o: x for o, x in opts.items() if o != "softcap"})
                    torch.cuda.synchronize()
                    moved = (want.float() - uncapped.float()).abs().max(
                    ).item()
                    assert moved > CAP_MOVES, \
                        f"hd 256: the cap moves plain by only {moved:.3g}"
                    e = (got.float() - want.float()).abs().max().item()
                    assert torch.isfinite(got).all() and e <= TOL[dtype], \
                        f"decode kernel at hd 256 disagrees where the cap " \
                        f"bites ({ctxs}, q x {gain}, {opts}): {e:.3g}"
                    err = max(err, e)
                    cap_moved = min(cap_moved, moved)
            per_sm = blocks_per_sm("paged_attention", 256, n_q // n_kv,
                                   dtype == torch.bfloat16)
            log(f"  paged_attention hd 256 {str(dtype)[6:]:8s} {n_q}/{n_kv} "
                f"heads: {len(HD256_CASES)} context mixes x "
                f"{len(HD256_OPTS)} option sets (none, window 300, softcap "
                f"50 + scale 1/16, all) + {len(HD256_CAPPED)} where the cap "
                f"bites (the cap moves plain by >= {cap_moved:.3g}), "
                f"max_abs_err={err:.3g} (tol "
                f"{TOL[dtype]}); {per_sm} block(s) per SM, splits "
                f"{split_count(8, n_kv, MAX_PAGES, PS, sms, per_sm)} at "
                "B 8")

    out = {}
    n_q, n_kv = HD256_GROUPS[0]
    for name, ctx, opts in (("ctx 1024", 1024, {}),
                            ("gemma2 local", 4608,
                             {**GEMMA2_OPTS, "window": 4096}),
                            ("gemma2 global", 4608, GEMMA2_OPTS)):
        k, v, pt = paged_inputs(torch.bfloat16, [ctx] * B, n_pages=ctx // PS,
                                seed=21, n_kv=n_kv, hd=256)
        q = torch.randn((B, n_q, 256), device="cuda").to(torch.bfloat16)
        cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
        got = paged_attention(q, k, v, pt, cl, **opts)
        want = paged_attention_plain(q, k, v, pt, cl, **opts)
        e = (got.float() - want.float()).abs().max().item()
        assert e <= TOL[torch.bfloat16], f"hd 256 {name}: disagrees"
        visible = min(ctx, opts.get("window", ctx))
        kd = gathered(k, pt, ctx)[:, :, ctx - visible:].contiguous()
        vd = gathered(v, pt, ctx)[:, :, ctx - visible:].contiguous()
        qd = q[:, :, None, :]
        ms = time_ms(lambda: paged_attention(q, k, v, pt, cl, **opts))
        plain_ms = time_ms(
            lambda: paged_attention_plain(q, k, v, pt, cl, **opts))
        sdpa_ms = time_ms(lambda: sdpa(qd, kd, vd))
        nbytes = (2 * q.numel() * 2 + B * visible * n_kv * 256 * 2 * 2
                  + B * (-(-visible // PS)) * 4 + B * 4)
        bound, by = bound_of(nbytes, 4 * n_q * 256 * B * visible)
        lib = None if opts else sdpa_ms
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, library_ms=lib, max_abs_err=e)
        log(f"  paged_attention hd 256 bf16 B={B} {n_q}/{n_kv} heads "
            f"{name} (ctx {ctx}, {visible} visible, {opts}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({by}, {nbytes / 1e6:.1f} MB), {ms / bound:.2f}x the bound; "
            f"library {'none (softcap)' if opts else f'{sdpa_ms:.4f} ms'}"
            f"{f', sdpa without cap or window {sdpa_ms:.4f} ms' if opts else ''}"
            f"; max_abs_err={e:.3g}")
    return out


QWEN2_TABLE = 2048 // PS     # phase 4j's Qwen2-7B engine: max_seq_len 2048


def check_gqa_decode(paged_attention, paged_attention_plain, n_q, n_kv):
    """Kernel 1 at a Qwen decode's GQA group: Qwen2-7B's 28/4 heads (a
    group of 7, the rows of one tensor-core tile) or Qwen2-VL-2B's 12/2
    (a group of 6), head dim 128 and a table of 128 pages of 16 (phase 4j's
    Qwen2-7B engine, phase 4n's engines hold fewer), against its plain
    version at both types on phase 3's context mixes (a window of 300 too,
    for the split-K edges), then timed at B 8 behind 1024 tokens beside
    one SDPA call and the bound."""
    from xllm_service_tpu_torch.ops.paged_attention import (
        planned_blocks_per_sm,
        split_count,
    )

    hd, tag = 128, f"group {n_q // n_kv}"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [([0, 1, 7, 16, 17, 500, 1000, QWEN2_TABLE * PS], {}),
             ([67, 3, 33, QWEN2_TABLE * PS, 1029, 515, 130, 64], {}),
             ([777], {}),
             ([1000, 67, 301, 0, 2048, 300, 16, 1500], {"window": 300})]
    for dtype in (torch.bfloat16, torch.float32):
        err = 0.0
        for ctxs, opts in cases:
            k, v, pt = paged_inputs(dtype, ctxs, n_pages=QWEN2_TABLE,
                                    seed=28, n_kv=n_kv, hd=hd)
            q = torch.randn((len(ctxs), n_q, hd), device="cuda").to(dtype)
            cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
            got = paged_attention(q, k, v, pt, cl, **opts)
            want = paged_attention_plain(q, k, v, pt, cl, **opts)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), f"{tag}: non-finite"
            for b, c in enumerate(ctxs):
                assert c > 0 or (got[b] == 0).all(), \
                    f"{tag}: ctx 0 row not zero"
            e = (got.float() - want.float()).abs().max().item()
            assert e <= TOL[dtype], \
                f"decode kernel at {tag} disagrees ({ctxs}, {opts})"
            err = max(err, e)
        plan = planned_blocks_per_sm("paged_attention", hd, n_q // n_kv,
                                     dtype == torch.bfloat16)
        log(f"  paged_attention {str(dtype)[6:]:8s} {n_q}/{n_kv} heads hd "
            f"{hd}, {QWEN2_TABLE}-page table: {len(cases)} context mixes, "
            f"max_abs_err={err:.3g} (tol {TOL[dtype]}); splits "
            f"{split_count(B, n_kv, QWEN2_TABLE, PS, sms, plan)} at B {B}")
    ctx = 1024
    k, v, pt = paged_inputs(torch.bfloat16, [ctx] * B, n_pages=QWEN2_TABLE,
                            seed=29, n_kv=n_kv, hd=hd)
    q = torch.randn((B, n_q, hd), device="cuda").to(torch.bfloat16)
    cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    kd, vd = gathered(k, pt, ctx).contiguous(), gathered(v, pt, ctx).contiguous()
    qd = q[:, :, None, :]
    ms = time_ms(lambda: paged_attention(q, k, v, pt, cl))
    plain_ms = time_ms(lambda: paged_attention_plain(q, k, v, pt, cl))
    lib_ms = time_ms(lambda: sdpa(qd, kd, vd))
    nbytes = (2 * q.numel() * 2 + B * ctx * n_kv * hd * 2 * 2
              + B * (ctx // PS) * 4 + B * 4)
    bound, by = bound_of(nbytes, 4 * n_q * hd * B * ctx)
    log(f"  paged_attention bf16 B={B} {n_q}/{n_kv} heads hd {hd} ctx {ctx}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
        f"({ms / lib_ms:.2f}x), bound {bound:.4f} ms ({by}, "
        f"{nbytes / 1e6:.1f} MB), {ms / bound:.2f}x the bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, max_abs_err=err)


def check_hd256_fused_and_partial(fused, fused_plain, cp):
    """Kernel 3 at head dim 256 (both groups, both types: output within
    TOL, the pools bit for bit after the append) and kernel 6 at head dim
    256 on shard 0 of four (Gemma-2-9B's group, scale 1/16), each timed at
    B 8, ctx 1024 beside its bound."""
    from xllm_service_tpu_torch.ops.paged_attention import NEG_INF

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for n_q, n_kv in HD256_GROUPS:
            err = 0.0
            for ctxs in ([0, 1, 16, 17, 500, 777, 1024, MAX_PAGES * PS],
                         [778]):
                k, v, pt = paged_inputs(dtype, ctxs, seed=22, n_kv=n_kv,
                                        hd=256)
                q = torch.randn((len(ctxs), n_q, 256), device="cuda").to(
                    dtype)
                kn = torch.randn((len(ctxs), n_kv, 256), device="cuda").to(
                    dtype)
                vn = torch.randn((len(ctxs), n_kv, 256), device="cuda").to(
                    dtype)
                cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
                kp, vp = k.clone(), v.clone()
                got = fused(q, kn, vn, kp, vp, pt, cl)[0]
                want = fused_plain(q, kn, vn, k, v, pt, cl)[0]
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                assert e <= TOL[dtype], "fused kernel at hd 256 disagrees"
                assert all(torch.equal(a.view(torch.int16),
                                       b.view(torch.int16))
                           for a, b in ((kp, k), (vp, v))), \
                    "fused kernel's append at hd 256 differs"
                err = max(err, e)
            log(f"  fused_decode_attention hd 256 {str(dtype)[6:]:8s} "
                f"{n_q}/{n_kv} heads: max_abs_err={err:.3g} (tol "
                f"{TOL[dtype]}), pools bit-identical")
    n_q, n_kv = HD256_GROUPS[0]
    ctx = 1024
    k, v, pt = paged_inputs(torch.bfloat16, [ctx] * B, seed=23, n_kv=n_kv,
                            hd=256)
    q = torch.randn((B, n_q, 256), device="cuda").to(torch.bfloat16)
    kn = torch.randn((B, n_kv, 256), device="cuda").to(torch.bfloat16)
    vn = torch.randn((B, n_kv, 256), device="cuda").to(torch.bfloat16)
    cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    ms = time_ms(lambda: fused(q, kn, vn, k, v, pt, cl))
    plain_ms = time_ms(lambda: fused_plain(q, kn, vn, k, v, pt, cl))
    nbytes = (2 * q.numel() * 2 + 2 * 2 * kn.numel() * 2
              + B * (ctx - 1) * n_kv * 256 * 2 * 2
              + B * (-(-(ctx - 1) // PS)) * 4 + B * 4)
    bound, by = bound_of(nbytes, 4 * n_q * 256 * B * ctx)
    out["fused"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by)
    log(f"  fused_decode_attention hd 256 bf16 B={B} {n_q}/{n_kv} heads "
        f"ctx {ctx}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}), {ms / bound:.2f}x the bound")

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, pt, cl = cp_case(dtype, [0, 1, 16, 17, 500, 777, 1024,
                                          MAX_PAGES * PS], 24, n_q=n_q,
                                  n_kv=n_kv, hd=256)
        P_loc = k.shape[0] // 4
        tables = cp.compact_local_table(pt, cl, 0, P_loc, PS)
        k0, v0 = k[:P_loc].contiguous(), v[:P_loc].contiguous()
        m, l, acc = cp.paged_partial(q, k0, v0, *tables, cl, scale=1 / 16,
                                     shards=4)
        m0, l0, a0 = cp.paged_partial_plain(q, k0, v0, *tables, cl,
                                            scale=1 / 16)
        torch.cuda.synchronize()
        dead = m0 <= NEG_INF / 2
        assert torch.equal(dead, m <= NEG_INF / 2), "hd 256 cp: masked rows"
        lsc = l0.clamp_min(1.0)
        e = max((m - m0)[~dead].abs().max().item() if (~dead).any() else 0.0,
                ((l - l0).abs() / lsc).max().item(),
                ((acc - a0).abs() / lsc[..., None]).max().item())
        assert e <= TOL[dtype], "cp partial at hd 256 disagrees"
        log(f"  cp_paged_partial hd 256 {str(dtype)[6:]:8s} {n_q}/{n_kv} "
            f"heads, shard 0 of 4: n_local {tables[2].tolist()}, "
            f"err={e:.3g} (tol {TOL[dtype]})")
    q, k, v, pt, cl = cp_case(torch.bfloat16, [ctx] * B, 25, n_q=n_q,
                              n_kv=n_kv, hd=256)
    P_loc = k.shape[0] // 4
    tables = cp.compact_local_table(pt, cl, 0, P_loc, PS)
    k0, v0 = k[:P_loc].contiguous(), v[:P_loc].contiguous()
    ms = time_ms(lambda: cp.paged_partial(q, k0, v0, *tables, cl,
                                          scale=1 / 16, shards=4))
    plain_ms = time_ms(lambda: cp.paged_partial_plain(q, k0, v0, *tables,
                                                      cl, scale=1 / 16))
    owned = int(tables[2].sum()) * PS
    nbytes = (q.numel() * 2 + B * n_q * (256 + 2) * 4
              + owned * n_kv * 256 * 2 * 2 + int(tables[2].sum()) * 8
              + 2 * B * 4)
    bound, by = bound_of(nbytes, 4 * n_q * 256 * owned)
    # The yardstick: one SDPA call over each row's owned pages on shard 0,
    # gathered dense and padded to the longest row (a key mask), scale
    # 1/16. The rows own different counts here (ctx 1024 each, pages drawn
    # from the whole pool).
    n_loc = tables[2].long()
    T = int(n_loc.max()) * PS
    idx = tables[0][:, :T // PS].long()
    kd = k0[idx].permute(0, 2, 1, 3, 4).reshape(B, n_kv, T, 256).contiguous()
    vd = v0[idx].permute(0, 2, 1, 3, 4).reshape(B, n_kv, T, 256).contiguous()
    keep = (torch.arange(T, device="cuda")[None, :]
            < (n_loc * PS)[:, None])[:, None, None, :]
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=keep, scale=1 / 16,
        enable_gqa=True))
    out["partial"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, library_ms=lib_ms)
    log(f"  cp_paged_partial hd 256 bf16 B={B} ctx {ctx}, shard 0 of 4 "
        f"({owned} owned slots): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa {lib_ms:.4f} ms (owned K/V gathered dense, padded to "
        f"{T} keys), bound {bound:.4f} ms ({by}), {ms / bound:.2f}x the "
        f"bound, {ms / lib_ms:.2f}x the library's time")
    return out


def check_mq_walk_shapes(mq_paged_attention, mq_paged_attention_plain,
                         mq_route):
    """Kernel 2's f32 walk at the shapes the tensor-core route does not
    take: Gemma-2B's head dim 256 (8/1 heads), Qwen2-7B's group of 7
    (28/4 heads, hd 128), each Sq 512 behind 512 (bf16), Qwen2-7B also
    at the verify shape (B 8, Sq 5 behind 1024), and Qwen2-VL-2B's group
    of 6 (12/2 heads, hd 128) at a chunk of phase 4n's chunked prompt, Sq
    256 behind 256, against the plain version (also f32 at Sq 17 behind
    384), and timed beside one masked SDPA call and the bound."""
    out = {}
    for n_q, n_kv, hd in ((8, 1, 256), (28, 4, 128), (12, 2, 128)):
        assert mq_route(torch.bfloat16, hd, PS, n_q // n_kv) == "walk"
        k, v, pt = paged_inputs(torch.float32, [384 + 17, 384 + 14],
                                seed=26, n_kv=n_kv, hd=hd)
        q = torch.randn((2, 17, n_q, hd), device="cuda")
        pre = torch.full((2,), 384, dtype=torch.int32, device="cuda")
        blk = torch.tensor([17, 14], dtype=torch.int32, device="cuda")
        e32 = (mq_paged_attention(q, k, v, pt, pre, blk)
               - mq_paged_attention_plain(q, k, v, pt, pre, blk)).abs().max(
               ).item()
        assert e32 <= TOL[torch.float32], "mq walk (f32) disagrees"
        shapes = [("Sq 512 behind 512", 1, 512, 512)]
        if n_q == 28:
            shapes.append(("verify B 8, Sq 5 behind 1024", B, VERIFY_SQ,
                           1024))
        if n_q == 12:
            shapes = [("Sq 256 behind 256", 1, 256, 256)]
        for name, rows, s_q, prefix in shapes:
            T = prefix + s_q
            k, v, pt = paged_inputs(torch.bfloat16, [T] * rows, seed=27,
                                    n_kv=n_kv, hd=hd)
            q = torch.randn((rows, s_q, n_q, hd), device="cuda").to(
                torch.bfloat16)
            pre = torch.full((rows,), prefix, dtype=torch.int32,
                             device="cuda")
            blk = torch.full((rows,), s_q, dtype=torch.int32, device="cuda")
            got = mq_paged_attention(q, k, v, pt, pre, blk)
            want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            assert e <= TOL[torch.bfloat16], f"mq walk {name} disagrees"
            kd = gathered(k, pt, T).contiguous()
            vd = gathered(v, pt, T).contiguous()
            qd = q.transpose(1, 2).contiguous()
            mask = (torch.arange(T, device="cuda")[None, :]
                    <= prefix + torch.arange(s_q, device="cuda")[:, None])
            ms = time_ms(lambda: mq_paged_attention(q, k, v, pt, pre, blk))
            plain_ms = time_ms(
                lambda: mq_paged_attention_plain(q, k, v, pt, pre, blk))
            lib = time_ms(lambda: sdpa(qd, kd, vd, mask))
            nbytes = (2 * q.numel() * 2 + rows * T * n_kv * hd * 2 * 2
                      + rows * (-(-T // PS)) * 4 + 2 * rows * 4)
            ops = 4 * n_q * hd * rows * (s_q * prefix
                                         + s_q * (s_q + 1) // 2)
            bound, by = bound_of(nbytes, ops)
            key = f"{n_q}/{n_kv} hd {hd} {name}"
            out[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                            bound_ms=bound, bound_by=by, max_abs_err=e)
            log(f"  mq_paged_attention walk bf16 {key}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, sdpa {lib:.4f} ms "
                f"({ms / lib:.2f}x), bound {bound:.4f} ms ({by}), "
                f"{ms / bound:.1f}x the bound; max_abs_err={e:.3g} (f32 "
                f"at Sq 17 behind 384: {e32:.3g})")
    return out


# ---------------------------------------------------------------- phase 4
class Collector:
    def __init__(self):
        self.tokens: list[int] = []
        self.times: list[float] = []     # arrival of each delta with tokens
        self.reason = ""
        self.t_first = 0.0
        self.first = threading.Event()
        self.done = threading.Event()

    def __call__(self, out) -> None:
        if not out.status.ok():
            self.reason = f"error: {out.status.message}"
        for s in out.outputs:
            self.tokens.extend(s.token_ids)
            self.reason = s.finish_reason or self.reason
        if any(s.token_ids for s in out.outputs):
            self.times.append(time.monotonic())
        if not self.first.is_set():
            self.t_first = time.monotonic()
            self.first.set()
        if out.finished:
            self.done.set()


class StepClock:
    """Where a serving run's wall time goes on the host (information only).
    Wraps one engine's ``submit``, ``_admit``, ``_start_sequence`` (one
    admission's prefix match and install dispatch, inside an admission
    pass, whose end waits once for the burst) and ``_decode``: the calls
    that did work, each with its wall time and the engine thread's CPU
    time (a call still running when the window closes counts up to then),
    the rest of the window as the loop's idle time, the time of the last
    submit, and the CPU time of the process outside the engine thread (the
    agent's, the stub master's and the driver's threads)."""

    def __init__(self, eng):
        self.eng = eng
        self.parts = {"admit": [0, 0.0, 0.0], "prefill": [0, 0.0, 0.0],
                      "decode": [0, 0.0, 0.0]}
        self.admit_walls: list[float] = []
        self.submits: list[float] = []
        self.lock = threading.Lock()
        self.closed = False
        self.inflight = None   # (part, wall at entry, thread CPU at entry)
        for part, name in (("admit", "_admit"), ("decode", "_decode"),
                           ("prefill", "_start_sequence")):
            setattr(eng, name, self._timed(getattr(eng, name), part))
        submit = eng.submit

        def timed_submit(req):
            self.submits.append(time.perf_counter())
            submit(req)

        eng.submit = timed_submit

    def _timed(self, fn, part):
        outer = part != "prefill"

        def wrapped(*args):
            w, c = time.perf_counter(), time.thread_time()
            if outer:
                self.inflight = (part, w, c)
            did = fn(*args)
            with self.lock:
                if outer:
                    self.inflight = None
                if did and not self.closed:
                    self._add(part, time.perf_counter() - w,
                              time.thread_time() - c)
            return did
        return wrapped

    def _add(self, part, wall, cpu):
        acc = self.parts[part]
        acc[0] += 1
        acc[1] += wall
        acc[2] += cpu
        if part == "admit":
            self.admit_walls.append(wall * 1e3)

    def _engine_cpu(self) -> float:
        return time.clock_gettime(
            time.pthread_getcpuclockid(self.eng._thread.ident))

    def begin(self) -> None:
        self.t0 = time.perf_counter()
        self.cpu0 = time.process_time()
        self.eng_cpu0 = self._engine_cpu()

    def end(self) -> dict:
        with self.lock:
            self.closed = True
            now, eng_now = time.perf_counter(), self._engine_cpu()
            if self.inflight is not None:
                part, w, c = self.inflight
                self._add(part, now - w, eng_now - c)
        wall = now - self.t0
        eng_cpu = eng_now - self.eng_cpu0
        out = {"wall_ms": wall * 1e3,
               "last_submit_ms": (max(self.submits) - self.t0) * 1e3,
               "engine_cpu_ms": eng_cpu * 1e3,
               "other_cpu_ms": (time.process_time() - self.cpu0 - eng_cpu)
               * 1e3,
               "admit_walls_ms": list(self.admit_walls)}
        for part, (n, w, c) in self.parts.items():
            out[part] = (n, w * 1e3, c * 1e3)
        out["idle_ms"] = wall * 1e3 - out["admit"][1] - out["decode"][1]
        return out

    @staticmethod
    def line(r: dict) -> str:
        return (f"wall {r['wall_ms']:.1f} ms, last submit at "
                f"+{r['last_submit_ms']:.1f} ms; admissions "
                f"{r['admit'][0]} calls {r['admit'][1]:.1f} ms wall ("
                + " + ".join(f"{w:.1f}" for w in r["admit_walls_ms"])
                + f") {r['admit'][2]:.1f} ms engine CPU, of which "
                f"{r['prefill'][0]} install dispatches {r['prefill'][1]:.1f} "
                f"ms wall; "
                f"decode {r['decode'][0]} calls {r['decode'][1]:.1f} ms "
                f"wall {r['decode'][2]:.1f} ms engine CPU; loop idle "
                f"{r['idle_ms']:.1f} ms; engine thread CPU "
                f"{r['engine_cpu_ms']:.1f} ms, other threads CPU "
                f"{r['other_cpu_ms']:.1f} ms")


def serve_once(engine_mod, cfg, params, prompts, shared, sampled_prompt,
               mesh=None, clocks=None, new=64):
    """One serving run on a fresh engine (on ``mesh`` if given) with its
    background loop, ``new`` tokens a request. Returns (tokens per
    request, finish reasons, stats with the count of ring prefills, ttft
    ms, generated tokens/s over the run). With a ``clocks`` list, a
    ``StepClock`` summary of the run is appended to it."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params, mesh=mesh)
    clock = StepClock(eng) if clocks is not None else None
    greedy = SamplingParams(max_tokens=new, temperature=0.0, ignore_eos=True)
    samp = SamplingParams(max_tokens=new, temperature=0.8, top_p=0.9,
                          seed=1234, ignore_eos=True)
    cols = {}
    t_sub = {}
    eng.start()
    try:
        t0 = time.monotonic()
        if clock is not None:
            clock.begin()

        def submit(name, toks, sp):
            cols[name] = Collector()
            t_sub[name] = time.monotonic()
            eng.submit(engine_mod.EngineRequest(name, token_ids=toks,
                                                sampling=sp,
                                                on_output=cols[name]))

        for i, p in enumerate(prompts):
            submit(f"g{i}", p, greedy)
        submit("sampled", sampled_prompt, samp)
        # The two prefix-sharing requests arrive after request 0's prefill
        # has finished (its blocks are donated before its first token).
        assert cols["g0"].first.wait(600), "request 0 never started"
        for j, p in enumerate(shared):
            submit(f"s{j}", p, greedy)
        for name, c in cols.items():
            assert c.done.wait(900), f"{name} never finished"
        wall = time.monotonic() - t0
        if clock is not None:
            clocks.append(clock.end())
    finally:
        eng.stop()
    stats = dict(eng.stats(), ring_prefills=eng.ring_prefills)
    ttft = sorted((c.t_first - t_sub[n]) * 1e3 for n, c in cols.items())
    toks = {n: c.tokens for n, c in cols.items()}
    reasons = {n: c.reason for n, c in cols.items()}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return toks, reasons, stats, ttft, sum(map(len, toks.values())) / wall


def check_replays(stats, name):
    """The run decoded through the captured step: a variant is captured at
    its first use (greedy; with a sampled request, sampling), every later
    step is a replay."""
    graph = stats["decode_graph"]
    log(f"  {name}: decode graph captures {graph['captures']}, replays "
        f"{graph['replays']}")
    assert 1 <= graph["captures"] <= 4, "unexpected captures"
    assert graph["replays"] > 10 * graph["captures"], "few replays"


def check_logits(llama, cfg, params, prompt, prefix):
    """Last-token logits of one shared prompt three ways: a cold prefill
    (dense attention), a prefill behind its first ``prefix`` tokens cached
    (the multi-query kernel), and a prefill of all but the last token then
    one decode step (the decode kernel). The two paged routes must agree
    with the cold one."""
    mcfg = cfg.model
    n = len(prompt)
    n_pages = -(-n // PS)
    i32 = dict(dtype=torch.int32, device="cuda")

    def pool():
        return torch.zeros((mcfg.num_layers, 2, n_pages + 1, N_KV, PS, HD),
                           dtype=mcfg.dtype, device="cuda")

    def prefill(kv, lo, hi):
        return llama.prefill_forward(
            params, mcfg, toks[:, lo:hi], torch.arange(lo, hi, **i32)[None],
            kv, pt, torch.tensor([lo], **i32), torch.tensor([hi - lo], **i32),
            has_prefix=lo > 0)[0]

    pt = torch.arange(1, n_pages + 1, **i32)[None]
    toks = torch.tensor([prompt], **i32)
    cold = prefill(pool(), 0, n)
    kv = pool()
    prefill(kv, 0, prefix)
    routes = {"cached prefix": prefill(kv, prefix, n)}
    kv = pool()
    prefill(kv, 0, n - 1)
    routes["decode step"] = llama.decode_forward(
        params, mcfg, toks[:, n - 1], torch.tensor([n - 1], **i32), kv, pt,
        torch.tensor([n], **i32))[0]
    scale = cold.abs().max().item()
    for name, got in routes.items():
        err = (cold - got).abs().max().item()
        log(f"  logits cold vs {name} ({prefix}/{n} tokens): max_abs_err="
            f"{err:.4g}, max|logit|={scale:.4g} (tol {PREFILL_REL_TOL} x "
            f"max|logit|), argmax {int(cold.argmax())} vs {int(got.argmax())}")
        assert torch.isfinite(got).all(), name
        assert err <= PREFILL_REL_TOL * scale, f"{name} logits drifted"


# --------------------------------------------------------------- phase 4a
def serve_one(eng, engine_mod, name, toks, max_tokens=16):
    """One greedy request through a running engine; returns its tokens."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    col = Collector()
    eng.submit(engine_mod.EngineRequest(
        name, token_ids=toks, on_output=col,
        sampling=SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                ignore_eos=True)))
    assert col.done.wait(600), f"{name} never finished"
    assert len(col.tokens) == max_tokens and col.reason == "length", \
        f"{name}: {len(col.tokens)} tokens, reason {col.reason!r}"
    return col.tokens


# The tier round trips' tokens a request: A's two compared runs (A1 from
# HBM, A2 from the tiers) take TIER_NEW, the requests that only fill and
# evict (A0, A-half, U1, U2) TIER_FILL_NEW. A 1024-token prompt takes 65
# pages with either, so the evictions and the tiers' contents are those
# of 16 tokens a request; on an eager mesh each token is a decode step.
TIER_NEW = 8
TIER_FILL_NEW = 2


def wait_for(pred, what, timeout=120.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"
        time.sleep(0.01)


def depth_view(cfg, params, layers):
    """Engine configuration ``cfg`` cut to its first ``layers`` layers, and
    those layers of ``params`` as views (no copy): the stacked ``layers``
    and ``moe`` groups sliced on their leading axis (``moe`` holds no
    stack for a family's leading dense layers), every other leaf shared.
    An earlier phase's leg runs at this depth where its time grows with
    the layers and its reference is drawn in the same leg."""
    from dataclasses import replace

    m = cfg.model
    cut = {"layers": layers,
           "moe": layers - (getattr(m, "first_dense_layers", 0) or 0)}

    def head(tree, n):
        if isinstance(tree, dict):
            return {k: head(v, n) for k, v in tree.items()}
        return tree[:n]

    view = {k: head(v, cut[k]) if k in cut else v for k, v in params.items()}
    return replace(cfg, model=replace(m, num_layers=layers)), view


def tier_phase(engine_mod, cfg, params, page_dma, card, mesh=None):
    """Prompt A (1024 tokens = 8 hash blocks) served from HBM, evicted into
    the tiers by two unrelated prompts, served again from the tiers.

    The pool holds A's 65 pages plus one more request's, so the second
    unrelated prompt evicts exactly A's eight blocks. A request on A's
    first four blocks in between makes blocks 4-7 the least recently used:
    they are evicted first, so the DRAM arena (four blocks) ends holding
    blocks 0-3 and blocks 4-7 are demoted to the SSD file. The onload walk
    then reads 0-3 from DRAM, each fetch freeing the arena slot that the
    walk's own evictions refill, and 4-6 from SSD (block 7 is prefilled: a
    prefill keeps at least one token).

    One tier worker: installs land in eviction order, and an install that
    the walk's own eviction starts cannot demote the next block before the
    walk fetches it (with two workers, two installs could race one
    fetch). With ``mesh`` the engine's pool is sharded on it (4o (b)).
    """
    from dataclasses import replace

    from xllm_service_tpu_torch.common.hashing import prefix_block_hashes

    hbs = cfg.hash_block_size
    rng = np.random.default_rng(7)
    V = cfg.model.vocab_size
    prompt_a = rng.integers(3, V, size=8 * hbs).tolist()
    m = cfg.model
    blk = (m.num_layers * 2 * hbs * m.num_kv_heads * m.head_dim
           * torch.empty((), dtype=m.dtype).element_size())
    # 129 usable pages: A's 65 (1024 + TIER_NEW tokens) and U1's 64 cached
    # pages.
    tcfg = replace(cfg, num_pages=130, kv_tier_dram_bytes=4 * blk,
                   kv_tier_ssd_bytes=16 * blk, kv_tier_threads=1)
    eng = engine_mod.InferenceEngine(tcfg, params=params, mesh=mesh)
    store = eng.tier_store
    assert store is not None and store.block_nbytes == blk
    log(f"  block {blk / (1 << 20):.0f} MiB; DRAM arena 4 blocks, SSD file "
        "16 blocks, one tier worker")
    hashes = [h.hex() for h in prefix_block_hashes(prompt_a, hbs)]
    reset_counts()
    eng.start()
    try:
        serve_one(eng, engine_mod, "A0", prompt_a, TIER_FILL_NEW)
        t_hbm = serve_one(eng, engine_mod, "A1", prompt_a,        # HBM hit
                          TIER_NEW)
        # The bytes to be evicted, for the check after the onload (plain
        # gather; looking the blocks up refreshes them in LRU order).
        before = {}
        for h in hashes[:7]:
            pages = eng.page_mgr.match_block(h)
            before[h] = page_dma.gather_kv_pages_plain(eng.kv_pages, pages)
            eng.page_mgr.release_prefix([h])
        serve_one(eng, engine_mod, "A-half",
                  prompt_a[:4 * hbs] + rng.integers(3, V, 100).tolist(),
                  TIER_FILL_NEW)
        t0 = time.monotonic()
        serve_one(eng, engine_mod, "U1", rng.integers(3, V, 8 * hbs).tolist(),
                  TIER_FILL_NEW)
        serve_one(eng, engine_mod, "U2", rng.integers(3, V, 8 * hbs).tolist(),
                  TIER_FILL_NEW)
        wait_for(lambda: all(store.ready(h) for h in hashes),
                 "A's blocks in the tiers")
        t_off = time.monotonic() - t0
        st0 = store.stats()
        tiers = [store.tier_of(h) for h in hashes]
        log(f"  after eviction: A's blocks in tiers {tiers}, stats {st0}")
        t0 = time.monotonic()
        t_tier = serve_one(eng, engine_mod, "A2", prompt_a,      # tiers
                           TIER_NEW)
        t_on = time.monotonic() - t0
        launches = (page_dma.gather_kv_pages.launches,
                    page_dma.scatter_kv_pages.launches)
        wait_for(lambda: not store._pending, "the tier pump settling")
        st = store.stats()
        ev = eng.drain_kv_events()
        after = {}
        for h in hashes[:7]:
            pages = eng.page_mgr.match_block(h)
            assert pages is not None, "an onloaded block is not in HBM"
            after[h] = page_dma.gather_kv_pages_plain(eng.kv_pages, pages)
    finally:
        eng.stop()
    same = all(torch.equal(before[h].view(torch.int16),
                           after[h].view(torch.int16)) for h in before)
    log(f"  tier stats {st}; events stored {len(ev.stored)} offloaded "
        f"{len(ev.offloaded)} removed {len(ev.removed)}; launches "
        f"gather/scatter {launches}")
    log(f"  T_hbm == T_tier: {t_hbm == t_tier}; restored pages bit-identical "
        f"to the evicted ones: {same}")
    mb = 1 << 20
    log(f"  offload {st0['bytes_offloaded'] / mb:.0f} MiB in {t_off:.2f} s "
        f"(two 1024-token requests and the downloads: "
        f"{st0['bytes_offloaded'] / mb / t_off:.0f} MiB/s); onload "
        f"{(st['bytes_onloaded']) / mb:.0f} MiB within A's second request "
        f"of {t_on:.2f} s ({st['bytes_onloaded'] / mb / t_on:.0f} MiB/s, "
        f"prefill and decode included); information only, {card}")
    assert t_tier == t_hbm, "tokens after the tier round trip differ"
    assert same, "restored pages differ from the evicted ones"
    assert "dram" in tiers and "ssd" in tiers, "not both tiers were used"
    assert st["onload_total"] >= 7 and st["demote_total"] >= 1
    assert ev.offloaded, "no offloaded events were drained"
    assert launches[0] > 0 and launches[1] > 0, "a page mover never ran"
    return launches


# --------------------------------------------------------------- phase 4b
def fused_phase(engine_mod, cfg, params, prompts, shared, sampled_prompt,
                kernels, llama):
    """Phase 4's batch twice under XLLM_KV_WRITEBACK=fused: every decode step
    through kernel 3 and none through kernel 1."""
    fused, paged = kernels
    os.environ["XLLM_KV_WRITEBACK"] = "fused"
    try:
        runs = []
        for r in range(2):
            reset_counts()
            t = time.monotonic()
            toks, reasons, stats, ttft, tps = serve_once(
                engine_mod, cfg, params, prompts, shared, sampled_prompt)
            launches = (fused.launches, paged.launches)
            log(f"  fused run {r}: {time.monotonic() - t:.1f} s, launches "
                f"fused/decode {launches}, {tps:.1f} generated tok/s "
                f"(information only)")
            for name, tk in toks.items():
                assert len(tk) == 64 and reasons[name] == "length", \
                    f"{name}: {len(tk)} tokens, reason {reasons[name]!r}"
            assert launches[0] > 0, "the fused kernel never launched"
            assert launches[1] == 0, "kernel 1 launched under fused mode"
            check_replays(stats, f"fused run {r}")
            runs.append((toks, launches))
        assert runs[0][0] == runs[1][0], "two fused runs differ"
        log("  both fused runs gave identical tokens for all 11 requests")
        check_logits(llama, cfg, params, shared[0], 512)
    finally:
        del os.environ["XLLM_KV_WRITEBACK"]
    return runs[0]


# --------------------------------------------------------------- phase 4c
def check_cp_logits(llama, cfg, params, prompt, mesh, ShardedPages):
    """One prompt's decode-step logits two ways: the single-device route
    (dense prefill, kernel 1) and the context-parallel route the engine
    takes (ring prefill over the suffix padded to the axis, then the CP op
    over a pool sharded four ways). They must agree within PREFILL_REL_TOL
    of max |logit|."""
    mcfg = cfg.model
    n = len(prompt)
    n_pages = -(-n // PS)
    shards = len(mesh.axis_devices("seq"))
    n_pool = -(-(n_pages + 1) // shards) * shards
    i32 = dict(dtype=torch.int32, device="cuda")
    shape = (mcfg.num_layers, 2, n_pool, N_KV, PS, HD)
    pt = torch.arange(1, n_pages + 1, **i32)[None]
    toks = torch.tensor([prompt], **i32)

    def route(kv, ring):
        pre = list(prompt[:-1])
        if ring:
            pre += [0] * (-len(pre) % shards)
        llama.prefill_forward(
            params, mcfg, torch.tensor([pre], **i32),
            torch.arange(len(pre), **i32)[None], kv, pt,
            torch.zeros((1,), **i32), torch.tensor([n - 1], **i32),
            has_prefix=False, ring=ring)
        return llama.decode_forward(
            params, mcfg, toks[:, n - 1], torch.tensor([n - 1], **i32), kv,
            pt, torch.tensor([n], **i32))[0]

    single = route(torch.zeros(shape, dtype=mcfg.dtype, device="cuda"), False)
    cp = route(ShardedPages.zeros(shape, mcfg.dtype, mesh), True)
    scale = single.abs().max().item()
    err = (single - cp).abs().max().item()
    log(f"  logits single-device vs context-parallel decode step ({n} "
        f"tokens, ring prefill): max_abs_err={err:.4g}, max|logit|="
        f"{scale:.4g} (tol {PREFILL_REL_TOL} x max|logit|), argmax "
        f"{int(single.argmax())} vs {int(cp.argmax())}")
    assert torch.isfinite(cp).all()
    assert err <= PREFILL_REL_TOL * scale, "CP decode-step logits drifted"


# Phases 4c and 4d: tokens a request (each an eager decode step on
# seq=4) and Llama-3-8B's depth there (``depth_view`` of phase 4's).
CP_NEW = 32
CP_LAYERS = 8


def cp_phase(engine_mod, cfg, params, llama, kernels, card):
    """Context-parallel serving of Llama-3-8B on a seq=4 mesh, twice on
    fresh engines, CP_NEW tokens a request: ring prefill for the long
    prompt, a prefix hit through kernel 2, every decode step through
    kernel 6, kernels 1 and 3 idle. Returns (the first run's tokens and launches, single-device tokens)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    partial, paged, mq, fused = kernels
    count = torch.cuda.device_count()
    mesh = build_mesh(MeshConfig(seq=4),
                      [torch.device("cuda", i % count) for i in range(4)])
    log(f"  mesh seq=4 on {[str(d) for d in mesh.devices]}")
    cp_cfg = replace(cfg, seq_parallel_min_tokens=1024)
    rng = np.random.default_rng(11)
    V = cfg.model.vocab_size
    long = rng.integers(3, V, size=int(rng.integers(1100, 1501))).tolist()
    short = rng.integers(3, V, size=int(rng.integers(64, 513))).tolist()
    shared = [long[:512] + rng.integers(3, V, size=200).tolist()]
    sampled_prompt = rng.integers(3, V, size=200).tolist()
    log(f"  prompts: long {len(long)}, short {len(short)}, shared 512 + 200, "
        f"sampled 200 tokens; {CP_NEW} generated each")
    runs = []
    for r in range(2):
        reset_counts()
        t = time.monotonic()
        toks, reasons, stats, ttft, tps = serve_once(
            engine_mod, cp_cfg, params, [long, short], shared,
            sampled_prompt, mesh=mesh, new=CP_NEW)
        launches = dict(partial=partial.launches, decode=paged.launches,
                        mq=mq.launches, fused=fused.launches)
        log(f"  cp run {r}: {time.monotonic() - t:.1f} s, ring prefills "
            f"{stats['ring_prefills']}, prefix hits {stats['prefix_hits']}, "
            f"launches {launches}")
        log(f"  cp run {r}: TTFT ms p50 {ttft[len(ttft) // 2]:.1f} max "
            f"{ttft[-1]:.1f}; {tps:.1f} generated tok/s over the run "
            f"(information only; {card})")
        for name, tk in toks.items():
            assert len(tk) == CP_NEW and reasons[name] == "length", \
                f"{name}: {len(tk)} tokens, reason {reasons[name]!r}"
        assert launches["partial"] > 0, "kernel 6 never launched"
        assert "decode_graph" not in stats, "a graph under the seq mesh"
        assert launches["decode"] == 0 and launches["fused"] == 0, \
            "kernel 1 or 3 launched under the seq mesh"
        assert launches["mq"] > 0, "the prefix hit did not take kernel 2"
        assert stats["ring_prefills"] == 1, "the ring route did not run once"
        assert stats["prefix_hits"] >= 1 and \
            stats["prefix_hit_tokens"] >= 512, "no prefix hit"
        runs.append((toks, launches))
    assert runs[0][0] == runs[1][0], "two CP runs of the same batch differ"
    log("  both CP runs gave identical tokens for all 4 requests")
    single, *_ = serve_once(engine_mod, cfg, params, [long, short], shared,
                            sampled_prompt, new=CP_NEW)
    same = sum(single[n] == runs[0][0][n] for n in single)
    log(f"  CP vs single-device engine: {same}/{len(single)} requests with "
        "identical tokens (information only: random bf16 weights give "
        "near-ties, and the two sum in another order)")
    check_cp_logits(llama, cfg, params, long[:1100], mesh, ShardedPages)
    return runs[0]


# --------------------------------------------------------------- phase 4d
def restored_decode_check(llama, cfg, params, eng, pages, blocks, token):
    """One decode step of prompt A at position 1024 two ways: on the
    engine's sharded pool, whose rows ``pages`` (A's 64) hold blocks
    restored from the tiers (kernel 6 per shard, then the merge), and on a
    single-device pool filled with ``blocks``, the bytes gathered before
    the eviction (kernel 1). They must agree within PREFILL_REL_TOL of max
    |logit|."""
    mcfg = cfg.model
    i32 = dict(dtype=torch.int32, device=eng.device)
    n = len(pages)
    extra = eng.page_mgr.allocate(1)             # the new token's page
    tok = torch.tensor([token], **i32)
    pos = torch.tensor([n * cfg.page_size], **i32)
    cp_logits = llama.decode_forward(
        params, mcfg, tok, pos, eng.kv_pages,
        torch.tensor([pages + extra], **i32), pos + 1)[0]
    single = torch.zeros((*blocks[0].shape[:2], n + 2, *blocks[0].shape[3:]),
                         dtype=mcfg.dtype, device=eng.device)
    single[:, :, 1:n + 1] = torch.cat(blocks, dim=2)
    one_logits = llama.decode_forward(
        params, mcfg, tok, pos, single,
        torch.arange(1, n + 2, **i32)[None], pos + 1)[0]
    scale = one_logits.abs().max().item()
    err = (one_logits - cp_logits).abs().max().item()
    log(f"  logits of the decode step after A's prompt, restored sharded "
        f"pool vs the evicted bytes on one device: max_abs_err={err:.4g}, "
        f"max|logit|={scale:.4g} (tol {PREFILL_REL_TOL} x max|logit|), "
        f"argmax {int(one_logits.argmax())} vs {int(cp_logits.argmax())}")
    assert torch.isfinite(cp_logits).all()
    assert err <= PREFILL_REL_TOL * scale, "decode over restored pages drifted"


def tier_cp_phase(engine_mod, cfg, params, llama, page_dma, partial,
                  devices, card):
    """Phase 4a's round trip on a pool sharded four ways over a seq mesh
    (``devices``, four of them): prompt A (1024 tokens, 8 hash blocks)
    served from HBM, evicted into a DRAM arena of four blocks and an SSD
    file by two unrelated prompts, served again from the tiers.

    136 pages (34 a shard): A's 65 and U1's 64 fit with 6 to spare, and
    U2 evicts A's eight blocks in phase 4a's order (blocks 4-7 first, so
    they are demoted to SSD when 0-3 fill the arena). A's block 4 lies on
    pages 33-40, across shards 0 and 1, and the onload walk restores
    blocks across shards too (the phase logs each block's shards): one
    launch moves pages of two shards.

    Checks: the restored pages equal the evicted ones bit for bit; A's
    first token after the onload (the prefill behind the restored prefix,
    whose pages are gathered in table order) equals its first token from
    HBM; a decode step over the restored sharded pages agrees with one
    over the evicted bytes on one device (``restored_decode_check``). The
    later tokens are compared for information only: each decode step sums
    every shard's partial, and the restored pages lie on other shards than
    before, so the f32 sums run in another order and random bf16 weights
    give near-ties. Returns the gather and scatter launch counts."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.hashing import prefix_block_hashes
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    hbs = cfg.hash_block_size
    rng = np.random.default_rng(13)
    V = cfg.model.vocab_size
    prompt_a = rng.integers(3, V, size=8 * hbs).tolist()
    m = cfg.model
    blk = (m.num_layers * 2 * hbs * m.num_kv_heads * m.head_dim
           * torch.empty((), dtype=m.dtype).element_size())
    tcfg = replace(cfg, num_pages=136, kv_tier_dram_bytes=4 * blk,
                   kv_tier_ssd_bytes=16 * blk, kv_tier_threads=1)
    mesh = build_mesh(MeshConfig(seq=4), devices)
    eng = engine_mod.InferenceEngine(tcfg, params=params, mesh=mesh)
    store = eng.tier_store
    P_loc = eng.kv_pages.pages_per_shard
    assert store is not None and P_loc == 34
    log(f"  mesh seq=4 on {[str(d) for d in mesh.devices]}, {P_loc} pages a "
        "shard; DRAM arena 4 blocks, SSD file 16 blocks, one tier worker")
    hashes = [h.hex() for h in prefix_block_hashes(prompt_a, hbs)]
    reset_counts()
    eng.start()
    try:
        serve_one(eng, engine_mod, "A0", prompt_a, TIER_FILL_NEW)
        t_hbm = serve_one(eng, engine_mod, "A1", prompt_a,        # HBM hit
                          TIER_NEW)
        before, spans = {}, []
        for h in hashes[:7]:
            pages = eng.page_mgr.match_block(h)
            spans.append(sorted({p // P_loc for p in pages}))
            before[h] = page_dma.gather_kv_pages_plain(eng.kv_pages, pages)
            eng.page_mgr.release_prefix([h])
        serve_one(eng, engine_mod, "A-half",
                  prompt_a[:4 * hbs] + rng.integers(3, V, 100).tolist(),
                  TIER_FILL_NEW)
        t0 = time.monotonic()
        serve_one(eng, engine_mod, "U1", rng.integers(3, V, 8 * hbs).tolist(),
                  TIER_FILL_NEW)
        serve_one(eng, engine_mod, "U2", rng.integers(3, V, 8 * hbs).tolist(),
                  TIER_FILL_NEW)
        wait_for(lambda: all(store.ready(h) for h in hashes),
                 "A's blocks in the tiers")
        t_off = time.monotonic() - t0
        st0 = store.stats()
        tiers = [store.tier_of(h) for h in hashes]
        log(f"  A's blocks on shards {spans} (blocks 0-6); after eviction in "
            f"tiers {tiers}")
        t0 = time.monotonic()
        t_tier = serve_one(eng, engine_mod, "A2", prompt_a,      # tiers
                           TIER_NEW)
        t_on = time.monotonic() - t0
        launches = (page_dma.gather_kv_pages.launches,
                    page_dma.scatter_kv_pages.launches, partial.launches)
        wait_for(lambda: not store._pending, "the tier pump settling")
        st = store.stats()
        ev = eng.drain_kv_events()
        after, spans, rows = {}, [], []
        for h in hashes:
            pages = eng.page_mgr.match_block(h)
            assert pages is not None, "an onloaded block is not in HBM"
            spans.append(sorted({p // P_loc for p in pages}))
            after[h] = page_dma.gather_kv_pages_plain(eng.kv_pages, pages)
            rows += pages
    finally:
        eng.stop()
    same = all(torch.equal(before[h].view(torch.int16),
                           after[h].view(torch.int16)) for h in before)
    restored_decode_check(llama, cfg, params, eng, rows,
                          [before[h] for h in hashes[:7]] + [after[hashes[7]]],
                          t_tier[0])
    del eng
    torch.cuda.empty_cache()
    agree = [a == b for a, b in zip(t_hbm, t_tier)]
    log(f"  restored on shards {spans}; tier stats {st}; events stored "
        f"{len(ev.stored)} offloaded {len(ev.offloaded)} removed "
        f"{len(ev.removed)}; launches gather/scatter/partial {launches}")
    log(f"  A's first token from HBM and from the tiers equal: "
        f"{t_hbm[0] == t_tier[0]}; restored pages bit-identical to the "
        f"evicted ones: {same}; decode tokens equal {sum(agree)}/{len(agree)}"
        f" (information only), first difference at "
        f"{agree.index(False) if not all(agree) else None}")
    mb = 1 << 20
    log(f"  offload {st0['bytes_offloaded'] / mb:.0f} MiB in {t_off:.2f} s "
        f"({st0['bytes_offloaded'] / mb / t_off:.0f} MiB/s, two 1024-token "
        f"requests included); onload {st['bytes_onloaded'] / mb:.0f} MiB "
        f"within A's second request of {t_on:.2f} s "
        f"({st['bytes_onloaded'] / mb / t_on:.0f} MiB/s, prefill and decode "
        f"included); information only, {card}")
    assert t_tier[0] == t_hbm[0], "the first token after the onload differs"
    assert same, "restored pages differ from the evicted ones"
    assert "dram" in tiers and "ssd" in tiers, "not both tiers were used"
    assert st["onload_total"] >= 7 and st["demote_total"] >= 1
    assert ev.offloaded, "no offloaded events were drained"
    assert launches[0] == st["offload_total"], \
        "not one gather launch per offloaded block"
    assert launches[1] > 0 and launches[2] > 0, "kernel 5 or 6 never ran"
    return launches[:2]


# --------------------------------------------------------------- phase 4e
def graph_step_check(engine_mod, cfg, params):
    """From one state at full width, the captured step's replay and the
    same step run op by op must agree bit for bit: the packed rows, the KV
    pool and the slot state, for greedy rows, seeded sampled rows and
    logprob rows, on both writeback routes. Every slot is busy (an idle
    slot's write to the garbage page races the others' in either run)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    B_ = cfg.max_batch_size
    gcfg = replace(cfg, num_pages=B_ * 24 + 8)
    rng = np.random.default_rng(5)
    V = cfg.model.vocab_size
    cases = [("default", False, False), ("default", False, True),
             ("default", True, True), ("fused", False, True)]
    for route, want_lp, sample in cases:
        if route == "fused":
            os.environ["XLLM_KV_WRITEBACK"] = "fused"
        try:
            eng = engine_mod.InferenceEngine(gcfg, params=params)
            for i in range(B_):
                sp = (dict(temperature=0.8, top_p=0.9, seed=100 + i)
                      if sample and i % 2 else dict(temperature=0.0))
                eng.submit(engine_mod.EngineRequest(
                    f"c{i}", token_ids=rng.integers(3, V, 200).tolist(),
                    sampling=SamplingParams(max_tokens=100, ignore_eos=True,
                                            logprobs=want_lp, **sp)))
            eng._admit()
            assert len(eng._running) == B_
            st = [eng._row, eng.kv_pages, eng._last, eng._clens,
                  eng._active, eng._st.token_counts]

            def restore(snap):
                for t_, v in zip(st, snap):
                    t_.copy_(v)
                for b, g in enumerate(eng._gens):
                    g.manual_seed(1000 + b)

            snap = [t_.clone() for t_ in st]
            restore(snap)
            eng._decode_step(want_lp, sample)
            eager = [t_.clone() for t_ in st]
            same = []
            # The first step of the variant (warm-up, capture, replay),
            # then a plain replay, each from the same state.
            for _ in range(2):
                restore(snap)
                eng._graphs.run(want_lp, sample)
                torch.cuda.synchronize()
                same.append([torch.equal(a.view(torch.uint8),
                                         b.view(torch.uint8))
                             if a.is_floating_point() else torch.equal(a, b)
                             for a, b in zip(eager, st)])
            toks = eager[0][:, 0].long().tolist()
            log(f"  {route}, logprobs {want_lp}, sampled rows {sample}: "
                f"eager == graphed bit for bit (row, pool, last, clens, "
                f"active, counts; first replay, second) {same}; tokens "
                f"{toks}")
            assert all(map(all, same)), \
                "the replayed step differs from the eager one"
            assert eng._graphs.captures == 1 and eng._graphs.replays == 2
            assert torch.equal(st[3], snap[3] + 1), "a row did not advance"
            eng.stop()
            del eng, st, snap, eager
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            os.environ.pop("XLLM_KV_WRITEBACK", None)


def twins_phase(params, card):
    """The two benchmark twins at Llama-3-8B on the card (the weights are
    the smoke's own, which are the twins' seed-0 weights)."""
    from xllm_service_tpu_torch import bench
    from xllm_service_tpu_torch.benchmarks import decode_profile

    os.environ["XLLM_BENCH_MODEL"] = "8b"
    try:
        t = time.monotonic()
        b = bench.run("cuda", params=params)
        log(f"  bench twin (8b, B {b['batch']}, ctx {b['ctx']}, horizon "
            f"{b['decode_horizon']}): {b['value']:.1f} tok/s, pct_roofline "
            f"{b['pct_roofline']:.2f}, {b['ms_per_token_step']:.3f} ms a "
            f"token-step, {time.monotonic() - t:.1f} s; {card}")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.monotonic()
        prof = decode_profile.run("cuda", params=params, iters=5,
                                  trace_steps=2)
        log(f"  profile twin (8b): full_step_ms eager "
            f"{prof['full_step_ms']:.3f}, graphed "
            f"{prof['full_step_graphed_ms']:.3f}; forward "
            f"{prof['forward_only_ms']:.3f}, attention "
            f"{prof['attention_only_ms']:.3f}, sampling "
            f"{prof['sampling_only_ms']:.3f}; ideal weight stream "
            f"{prof['ideal_weight_stream_ms']:.3f} ms; "
            f"{time.monotonic() - t:.1f} s; {card}")
        for name in ("trace", "trace_graphed"):
            tr = prof[name]
            log(f"  {name}: kernels/step {tr['kernels_per_step']}, busy "
                f"share {tr['busy_share']}, device busy ms/step "
                f"{tr['device_busy_ms_per_step']}, host ms/step "
                f"{tr['host_ms_per_step']:.3f} (/layer "
                f"{tr['host_ms_per_layer']:.4f}), matrix products' share "
                f"{tr['gemm_share_of_device_time']}")
        log(f"  engine loop per step (host, untraced): {prof['engine_loop']}")
        log("  bench " + json.dumps(b))
        log("  profile " + json.dumps(prof))
        assert b["value"] > 0 and b["tokens"] > 0
        assert prof["full_step_graphed_ms"] < prof["full_step_ms"], \
            "the graphed step is not faster than the eager one"
        return b["value"]
    finally:
        del os.environ["XLLM_BENCH_MODEL"]
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4f
class CallClock:
    """Calls, wall time and the calling thread's CPU time of one wrapped
    callable (information only). For a thread that does no blocking I/O
    in the call, wall minus CPU is time spent waiting for the GIL or a
    core."""

    def __init__(self, fn):
        self.fn = fn
        self.n, self.wall, self.cpu = 0, 0.0, 0.0
        self.lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        w, c = time.perf_counter(), time.thread_time()
        try:
            return self.fn(*args, **kwargs)
        finally:
            dw, dc = time.perf_counter() - w, time.thread_time() - c
            with self.lock:
                self.n += 1
                self.wall += dw
                self.cpu += dc

    def line(self, what: str) -> str:
        return (f"{what} {self.n} calls {self.wall * 1e3:.1f} ms wall "
                f"{self.cpu * 1e3:.1f} ms CPU")


def plain_embedding(params, mcfg, ids, dtype):
    """One row's embedding by plain tensor math in ``dtype``, weights cast
    one layer at a time: rotate-half rope, causal GQA attention through an
    explicit f32 softmax, SwiGLU, the final norm, the mean over the row.
    It shares no code with the port's forwards or attention ops."""
    dev = params["final_norm"]["scale"].device
    S, H, G, hd = len(ids), mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim

    def norm(x, w):
        x = x.float()
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + mcfg.rms_eps)
        return (x * w.float()).to(dtype)

    inv = 1.0 / mcfg.rope_theta ** (
        torch.arange(0, hd, 2, device=dev, dtype=torch.float64) / hd)
    ang = torch.arange(S, device=dev, dtype=torch.float64)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]

    def rope(t):
        a, b = t.float()[..., :hd // 2], t.float()[..., hd // 2:]
        return torch.cat([a * cos - b * sin, a * sin + b * cos], -1).to(dtype)

    x = params["embed"]["embedding"][torch.tensor(ids, device=dev)].to(dtype)
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    for l in range(mcfg.num_layers):
        w = {name: next(iter(leaf.values()))[l].to(dtype)
             for name, leaf in params["layers"].items()}
        h = norm(x, w["input_norm"])
        q = rope((h @ w["q_proj"]).view(S, H, hd))
        k = rope((h @ w["k_proj"]).view(S, G, hd)).repeat_interleave(H // G, 1)
        v = (h @ w["v_proj"]).view(S, G, hd).repeat_interleave(H // G, 1)
        p = (torch.einsum("qhd,khd->hqk", q.float(), k.float()) * hd ** -0.5
             ).masked_fill(~causal, float("-inf")).softmax(-1)
        a = torch.einsum("hqk,khd->qhd", p, v.float()).to(dtype)
        x = x + a.reshape(S, H * hd) @ w["o_proj"]
        h = norm(x, w["post_attn_norm"])
        x = x + (torch.nn.functional.silu(h @ w["gate_proj"])
                 * (h @ w["up_proj"])) @ w["down_proj"]
    return norm(x, params["final_norm"]["scale"]).float().mean(0)


class StubMaster:
    """The master's ingest routes on the standard library:
    ``/rpc/generations`` (deltas per request, in ``delta_seq`` order, a
    replayed delta dropped as the master drops it) and ``/rpc/heartbeat``,
    in msgpack (read with the port's ``msgpack_lite``) or JSON, each
    answered ``{"ok": true, "alive": {...}}``. Without ``mux`` it has no
    ``/rpc/telemetry`` (404), as a master that predates the multiplexed
    session: the agent demotes itself to the per-endpoint routes. With
    ``mux`` it takes the tagged frames there: ``hb`` frames are beats
    (answered with ``owner``, the one-shot ``hint`` when one is set),
    ``gens`` frames are delivered to their ``dest``: here, or relayed to
    ``peer`` (another stub) on its ``/rpc/generations``, with ``dest_ok``
    per dest. ``close()`` also drops its kept-alive connections, so a
    stopped stub is gone for the agent as a killed master is."""

    def __init__(self, mux=False):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from xllm_service_tpu_torch.rpc import msgpack_lite

        self.gens: dict[str, list] = {}
        self.first: dict[str, float] = {}
        self.posts = 0
        self.busy = [0, 0.0, 0.0]   # handled POSTs, wall s, thread CPU s
        self.heartbeats: list = []
        self.beat_times: list = []  # arrival of each beat (any route)
        self.gens_times: list = []  # arrival of each batch from an agent
        self.telemetry_posts = 0
        self.direct_posts = 0       # /rpc/generations from an agent
        self.relayed_in = 0         # /rpc/generations relayed by the peer
        self.relayed_out = 0
        self.mux = mux
        self.peer = None
        self.hint = ""
        self.hinted_at = None       # when the hint went out
        self.dead = False
        self.lock = threading.Lock()
        self.changed = threading.Condition(self.lock)
        self.conns: set = set()
        stub = self

        def take_gens(gens, relayed=False):
            now = time.monotonic()
            with stub.changed:
                if not relayed:
                    stub.gens_times.append(now)
                for g in gens:
                    sid = g["service_request_id"]
                    seen = stub.gens.setdefault(sid, [])
                    if seen and g["delta_seq"] <= seen[-1]["delta_seq"]:
                        continue            # a retried delta
                    stub.first.setdefault(sid, now)
                    seen.append(g)
                stub.changed.notify_all()

        def take_beat(beat):
            with stub.changed:
                stub.heartbeats.append(beat)
                stub.beat_times.append(time.monotonic())
                stub.changed.notify_all()

        def relay(gens):
            import http.client

            host, _, port = stub.peer.addr.rpartition(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            try:
                conn.request("POST", "/rpc/generations",
                             body=msgpack_lite.packb({"gens": gens}),
                             headers={"Content-Type":
                                      msgpack_lite.CONTENT_TYPE,
                                      "X-Relayed": "1"})
                r = conn.getresponse()
                r.read()
                ok = r.status == 200
            except OSError:
                ok = False
            finally:
                conn.close()
            with stub.lock:
                stub.relayed_out += 1
            return ok

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # As the master's server: a reply written in two pieces must
            # not wait on Nagle for the ACK of the first.
            disable_nagle_algorithm = True

            def setup(self):
                super().setup()
                with stub.lock:
                    stub.conns.add(self.connection)

            def finish(self):
                with stub.lock:
                    stub.conns.discard(self.connection)
                super().finish()

            def do_POST(self):
                w, c = time.perf_counter(), time.thread_time()
                n = int(self.headers.get("Content-Length") or 0)
                data = self.rfile.read(n)
                if stub.dead:
                    self.close_connection = True
                    return
                if "msgpack" in self.headers.get("Content-Type", ""):
                    body = msgpack_lite.unpackb(data)
                else:
                    body = json.loads(data)
                status, reply = 200, {"ok": True, "alive": {}}
                if self.path == "/rpc/generations":
                    relayed = bool(self.headers.get("X-Relayed"))
                    with stub.lock:
                        stub.posts += 1
                        if relayed:
                            stub.relayed_in += 1
                        else:
                            stub.direct_posts += 1
                    take_gens(body["gens"], relayed)
                elif self.path == "/rpc/heartbeat":
                    take_beat(body)
                elif self.path == "/rpc/telemetry" and not stub.mux:
                    with stub.lock:
                        stub.telemetry_posts += 1
                    status, reply = 404, {"error": "no /rpc/telemetry"}
                elif self.path == "/rpc/telemetry":
                    dest_ok = {}
                    with stub.lock:
                        stub.telemetry_posts += 1
                    for fr in body["frames"]:
                        if fr["t"] == "hb":
                            take_beat(fr["d"])
                            with stub.changed:
                                reply["owner"] = stub.hint or stub.addr
                                if stub.hint:
                                    stub.hint = ""
                                    stub.hinted_at = time.monotonic()
                                stub.changed.notify_all()
                        elif fr["dest"] == stub.addr:
                            with stub.lock:
                                stub.posts += 1
                            take_gens(fr["d"]["gens"])
                            dest_ok[fr["dest"]] = True
                        else:
                            dest_ok[fr["dest"]] = \
                                stub.peer is not None and \
                                fr["dest"] == stub.peer.addr and \
                                relay(fr["d"]["gens"])
                    reply["dest_ok"] = dest_ok
                else:
                    status, reply = 404, {"error": f"no route {self.path}"}
                out = json.dumps(reply).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)
                with stub.lock:
                    stub.busy[0] += 1
                    stub.busy[1] += time.perf_counter() - w
                    stub.busy[2] += time.thread_time() - c

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"

    def wait(self, pred, what, timeout=300.0):
        with self.changed:
            assert self.changed.wait_for(pred, timeout), f"timed out: {what}"

    @staticmethod
    def routing(coord, has_images):
        """The ``routing`` a dispatch carries, as the master's scheduler
        sets it: an image request's vision stage goes to a registered
        ENCODE instance (``encode_name``; the first, by name, here)."""
        from xllm_service_tpu_torch.rpc import instance_key

        prefix = instance_key("ENCODE", "")
        names = sorted(k[len(prefix):] for k in coord.get_prefix(prefix))
        return {"encode_name": names[0] if has_images and names else ""}

    def finished(self, sid):
        return any(g["finished"] for g in self.gens.get(sid, ()))

    def close(self):
        import socket

        self.dead = True
        self.server.shutdown()
        self.server.server_close()
        with self.lock:
            conns = list(self.conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class Poster:
    """POSTs to one address on one kept-alive connection, as the master's
    client does, in JSON or (``packed``) msgpack: ``post(path, obj)`` ->
    (status, parsed reply)."""

    def __init__(self, addr, packed=False):
        import http.client

        host, _, port = addr.rpartition(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=300)
        self.packed = packed

    def __call__(self, path, obj):
        from xllm_service_tpu_torch.rpc import msgpack_lite

        if self.packed:
            body, ctype = msgpack_lite.packb(obj), msgpack_lite.CONTENT_TYPE
        else:
            body, ctype = json.dumps(obj).encode(), "application/json"
        self.conn.request("POST", path, body=body,
                          headers={"Content-Type": ctype})
        r = self.conn.getresponse()
        return r.status, json.loads(r.read())

    def close(self):
        self.conn.close()


def check_deltas(name, gens, agent):
    """Every delta of one request: delta_seq 1..k in order, stamped with
    the agent's instance and incarnation, exactly one finished (the last),
    carrying usage. Returns the token ids per choice."""
    assert gens, f"{name}: no deltas"
    assert [g["delta_seq"] for g in gens] == list(range(1, len(gens) + 1)), \
        f"{name}: delta_seq out of order"
    assert all(g["instance"] == agent.name
               and g["incarnation"] == agent.incarnation_id for g in gens), \
        f"{name}: unstamped delta"
    assert [g["finished"] for g in gens].count(True) == 1 \
        and gens[-1]["finished"] and "usage" in gens[-1], \
        f"{name}: not one finished delta with usage"
    toks: dict[int, list] = {}
    for g in gens:
        for o in g["outputs"]:
            toks.setdefault(o["index"], []).extend(o["token_ids"])
    return toks


def agent_phase(cfg, params, prompts, shared, sampled_prompt, phase4,
                kernels, card):
    """Phase 4's traffic through the agent's HTTP routes, then the
    agent-only requests. ``phase4`` = phase 4's runs, each (tokens per
    request, launches, tok/s, sorted TTFTs, ``StepClock`` summary); the
    first is the cold one. Returns the launches of kernels 1 and 2 in this
    phase, the client-side TTFT (dispatch to first delta at the stub
    master, ms) of phase 4's requests, the host split of their window
    (``StepClock``) and its generated tokens/s."""
    from xllm_service_tpu_torch.common.types import InstanceMetaInfo, now_ms
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.rpc import MASTER_KEY, instance_key

    mcfg = cfg.model
    store = MemoryStore()
    master = StubMaster()
    InMemoryCoordination(store).set(MASTER_KEY, master.addr)
    agent = EngineAgent(cfg, AgentConfig(model_id="llama3-8b",
                                         heartbeat_interval_s=1.0),
                        coord=InMemoryCoordination(store), params=params,
                        device="cuda")
    greedy = dict(max_tokens=64, temperature=0.0, ignore_eos=True)
    samp = dict(max_tokens=64, temperature=0.8, top_p=0.9, seed=1234,
                ignore_eos=True)

    rtts: list[float] = []
    sent: dict[str, float] = {}

    def dispatch(sid, toks, **sp):
        sent[sid] = time.monotonic()
        t_ = time.perf_counter()
        reply = post("/v1/completions", dict(
            service_request_id=sid, request_id=sid, token_ids=toks,
            source_service_addr=master.addr, **sp))
        rtts.append((time.perf_counter() - t_) * 1e3)
        return reply

    # Where the wall time of phase 4's traffic goes (information only).
    clock = StepClock(agent.engine)
    agent._route = routes = CallClock(agent._route)
    agent.streamer._send = sends = CallClock(agent.streamer._send)
    reset_counts()
    agent.start()
    post = Poster(agent.name)
    try:
        meta = InstanceMetaInfo.from_json(
            store.get(instance_key("MIX", agent.name)))
        assert meta.wire_formats == ["msgpack", "json"] and \
            (meta.num_layers, meta.num_kv_heads, meta.head_dim) == (
                mcfg.num_layers, mcfg.num_kv_heads, mcfg.head_dim), meta
        log(f"  registered {instance_key('MIX', agent.name)}: wire "
            f"{meta.wire_formats}, layers {meta.num_layers}, kv heads "
            f"{meta.num_kv_heads}, head dim {meta.head_dim}")
        with master.lock:
            master.busy = [0, 0.0, 0.0]
        t0 = time.monotonic()
        clock.begin()
        for i, p in enumerate(prompts):
            assert dispatch(f"g{i}", p, **greedy)[0] == 200
        assert dispatch("sampled", sampled_prompt, **samp)[0] == 200
        master.wait(lambda: "g0" in master.first, "request 0's first delta")
        for j, p in enumerate(shared):
            assert dispatch(f"s{j}", p, **greedy)[0] == 200
        names = [f"g{i}" for i in range(len(prompts))] + ["sampled"] + \
            [f"s{j}" for j in range(len(shared))]
        master.wait(lambda: all(map(master.finished, names)),
                    "phase 4's requests")
        wall = time.monotonic() - t0
        split = clock.end()
        log(f"  host split, phase 4's traffic through the agent: "
            f"{StepClock.line(split)}")
        log(f"  same split, phase 4 run 1: {StepClock.line(phase4[1][4])}")
        r_ = sorted(rtts)
        log(f"  dispatch POSTs {len(r_)} (one kept-alive connection): round "
            f"trip sum {sum(r_):.1f} ms, p50 {r_[len(r_) // 2]:.1f} max "
            f"{r_[-1]:.1f} ms; {routes.line('agent handlers')}; "
            f"{sends.line('streamer sends')}; stub master {master.busy[0]} "
            f"POSTs {master.busy[1] * 1e3:.1f} ms wall "
            f"{master.busy[2] * 1e3:.1f} ms CPU (information only)")
        toks = {n: check_deltas(n, master.gens[n], agent)[0] for n in names}
        tps = sum(map(len, toks.values())) / wall
        same = [n for n in names if toks[n] == phase4[0][0][n]]
        log(f"  phase 4's 11 requests through the agent: {len(same)}/"
            f"{len(names)} with phase 4's tokens")
        assert len(same) == len(names), \
            f"tokens differ from phase 4's: {sorted(set(names) - set(same))}"

        # The agent-only requests, together.
        assert dispatch("n2", sampled_prompt, max_tokens=16, temperature=0.8,
                        seed=7, n=2, ignore_eos=True)[0] == 200
        assert dispatch("lp", prompts[1], max_tokens=8, temperature=0.0,
                        logprobs=True, top_logprobs=2,
                        ignore_eos=True)[0] == 200
        assert dispatch("cancel", prompts[2], max_tokens=1024,
                        temperature=0.0, ignore_eos=True)[0] == 200
        status, reply = dispatch("late", prompts[3], max_tokens=8,
                                 deadline_ms=now_ms() - 1000)
        assert status == 504, (status, reply)
        master.wait(lambda: "cancel" in master.first, "the first delta")
        assert post("/rpc/cancel",
                         {"service_request_id": "cancel"})[0] == 200
        texts = ["the agent serves embeddings", "a second input, longer "
                 "than the first one by a few words"]
        status, emb = post("/v1/embeddings",
                                {"input": texts})
        assert status == 200, emb
        master.wait(lambda: all(map(master.finished, ("n2", "lp", "cancel"))),
                    "the agent-only requests")
        n2 = check_deltas("n2", master.gens["n2"], agent)
        assert sorted(n2) == [0, 1] and all(len(v) == 16 for v in n2.values())
        lp = master.gens["lp"]
        check_deltas("lp", lp, agent)
        rows = [r for g in lp for o in g["outputs"] for r in o["logprobs"]]
        assert len(rows) == 8 and all(len(r["top_logprobs"]) == 2
                                      for r in rows), "logprob rows"
        cancel = master.gens["cancel"]
        n_cancel = sum(len(o["token_ids"]) for g in cancel
                       for o in g["outputs"])
        assert cancel[-1]["finished"] and n_cancel < 1024, "not cancelled"
        assert "late" not in master.gens, "an expired dispatch streamed"
        vecs = np.asarray([d["embedding"] for d in emb["data"]], np.float32)
        want = agent.engine.embed([agent.engine.tokenizer.encode(t)
                                   for t in texts])
        emb_err = float(np.abs(vecs - want).max())
        assert vecs.shape == (2, mcfg.hidden_size) and \
            np.isfinite(vecs).all(), vecs.shape
        assert emb_err <= 1e-4, f"embeddings differ from engine.embed: " \
            f"{emb_err}"
        # An independent check of the bf16 embed forward: the first row
        # against plain f32 math, held within 4x the error of the same
        # plain math in bf16 (the control), plus 1e-3 of the row's largest
        # value so that a small control cannot fail it by chance.
        ids = agent.engine.tokenizer.encode(texts[0])
        ref = plain_embedding(params, mcfg, ids, torch.float32)
        ctl = plain_embedding(params, mcfg, ids, mcfg.dtype)
        got = torch.from_numpy(vecs[0]).to(ref.device)
        f32_err = float((got - ref).abs().max())
        ctl_err = float((ctl - ref).abs().max())
        scale = float(ref.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=0))
        log(f"  embedding row 0 ({len(ids)} tokens) vs plain f32 math: "
            f"max_abs_err {f32_err:.4g}, cosine {cos:.6f}; bf16 control "
            f"max_abs_err {ctl_err:.4g}; max|ref| {scale:.4g} (tol "
            f"4 x control + 1e-3 x max|ref|)")
        assert f32_err <= 4 * ctl_err + 1e-3 * scale, \
            f"embed forward off the plain f32 math: {f32_err}"
        log(f"  n 2 choices {sorted(n2)}; logprob rows {len(rows)}; "
            f"cancelled after {n_cancel} tokens (status "
            f"{cancel[-1]['status']}); expired dispatch 504; embeddings "
            f"{vecs.shape} vs engine.embed max_abs_err {emb_err:.3g} "
            f"(tol 1e-4)")

        # Heartbeats: load, latency and the 512-token prompts' KV events.
        master.wait(lambda: any(
            h["latency_metrics"]["recent_max_ttft"] > 0
            for h in master.heartbeats) and any(
            h["kv_cache_event"]["stored"] for h in master.heartbeats),
            "a heartbeat with latency and KV events", timeout=30)
        beats = list(master.heartbeats)
        assert all("load_metrics" in h and "latency_metrics" in h
                   and h["name"] == agent.name for h in beats)
        # The stub has no /rpc/telemetry: the agent's default mux mode
        # demoted itself to the per-endpoint routes, in msgpack.
        tel = agent.telemetry_stats()
        assert tel["mode"] == "master" and master.telemetry_posts >= 1 \
            and master.direct_posts == master.posts, tel
        log(f"  telemetry: mux demoted to the elected-master funnel by the "
            f"stub's 404 ({master.telemetry_posts} /rpc/telemetry POSTs); "
            f"{tel}")
        stats = agent.engine.stats()
        launches = (kernels[0].launches, kernels[1].launches)
        check_replays(stats, "4f")
        assert launches[0] > 0 and launches[1] > 0, \
            f"kernels 1/2 launches {launches}"
        spans = sorted(agent.ttft_spans)
        n_gens = sum(map(len, master.gens.values()))
        log(f"  launches decode/mq {launches}; stats {stats}")
        before = "; ".join(
            f"run {r}: TTFT p50 {t_[len(t_) // 2]:.1f} max {t_[-1]:.1f} ms, "
            f"{tps_:.1f} tok/s" for r, (_, _, tps_, t_, _) in enumerate(phase4))
        log(f"  agent-side TTFT (accept -> first delta) ms p50 "
            f"{spans[len(spans) // 2]:.1f} max {spans[-1]:.1f}; "
            f"{tps:.1f} generated tok/s through the agent (phase 4 {before}); "
            f"{n_gens / master.posts:.2f} deltas per "
            f"POST ({n_gens} in {master.posts}); {len(beats)} heartbeats, "
            f"max recent_max_ttft "
            f"{max(h['latency_metrics']['recent_max_ttft'] for h in beats):.1f}"
            f" ms, {sum(len(h['kv_cache_event']['stored']) for h in beats)} "
            f"stored blocks (information only; {card})")
        return launches, {n: (master.first[n] - sent[n]) * 1e3
                          for n in names}, split, tps
    finally:
        post.close()
        agent.stop()
        master.close()
        store.close()
        del agent
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4g
CHUNK = 256                  # phase 4g's prefill_chunk_tokens
ADMISSION_LAYERS = 16        # phase 4g: the three admission runs' depth


def time_mq_chunk_shapes(mq_paged_attention, mq_paged_attention_plain):
    """Kernel 2 at the chunked path's shapes, bf16, one row, each held
    against its plain version and timed beside SDPA on the same K/V
    gathered dense (the times are information). (Sq, prefix, valid rows):
    a chunk of C behind 256-1536 written tokens; 4C (a pressure ride)
    behind 256 and 1024; the first chunk, C or 4C, at prefix 0 (the
    mixed step's route for every chunk); the 1100-token prompt's ragged
    ride (76 valid rows of C behind 768) and its install (C behind the
    unaligned prefix 844)."""
    for s_q, prefix, valid in ((CHUNK, 256, CHUNK), (CHUNK, 1024, CHUNK),
                               (CHUNK, 1536, CHUNK),
                               (4 * CHUNK, 256, 4 * CHUNK),
                               (4 * CHUNK, 1024, 4 * CHUNK),
                               (CHUNK, 0, CHUNK), (4 * CHUNK, 0, 4 * CHUNK),
                               (CHUNK, 768, 76), (CHUNK, 844, CHUNK)):
        k, v, pt = paged_inputs(torch.bfloat16, [prefix + valid], seed=7)
        q = torch.randn((1, s_q, N_Q, HD), device="cuda").to(torch.bfloat16)
        pre = torch.tensor([prefix], dtype=torch.int32, device="cuda")
        blk = torch.tensor([valid], dtype=torch.int32, device="cuda")
        got = mq_paged_attention(q, k, v, pt, pre, blk)
        want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16], (
            f"mq kernel disagrees with plain at Sq {s_q}, prefix {prefix}, "
            f"{valid} valid rows")
        T = prefix + valid
        kd = gathered(k, pt, T).contiguous()
        vd = gathered(v, pt, T).contiguous()
        qd = q[:, :valid].transpose(1, 2).contiguous()
        mask = (torch.arange(T, device="cuda")[None, :]
                <= prefix + torch.arange(valid, device="cuda")[:, None])
        ms = time_ms(lambda: mq_paged_attention(q, k, v, pt, pre, blk))
        lib = time_ms(lambda: sdpa(qd, kd, vd, mask))
        nbytes = 2 * q.numel() * 2 + T * N_KV * HD * 2 * 2 + (-(-T // PS)) * 4
        ops = 4 * N_Q * HD * (valid * prefix + valid * (valid + 1) // 2)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
        log(f"  mq_paged_attention bf16 Sq={s_q} prefix={prefix} valid="
            f"{valid}: kernel {ms:.4f} ms, sdpa {lib:.4f} ms "
            f"({ms / lib:.2f}x), bound {bound:.4f} ms, max_abs_err {err:.3g}")


def sdpa_route_check(attention):
    """The prefix-free prefill's card route (one causal SDPA call) against
    the f32 path (``dense_prefill_attention``) at one 2048-token prompt's
    shapes, bf16, two rows (valid lengths 2048 and 1100), on the valid
    rows (the padding rows' outputs are dropped by every caller).
    Tolerance: 4x the error of the same attention computed in bf16 (the
    products and the softmax in bf16, a control of bf16 rounding alone)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    S = 2048

    def rnd(heads):
        return torch.randn((2, S, heads, HD), generator=g,
                           device="cuda").to(torch.bfloat16)

    q, k, v = rnd(N_Q), rnd(N_KV), rnd(N_KV)
    lens = torch.tensor([S, 1100], dtype=torch.int32, device="cuda")
    zero = torch.zeros((2,), dtype=torch.int32, device="cuda")
    got = attention.prefill_attention(q, k, v, None, None, None, zero, lens)
    want = attention.dense_prefill_attention(q, k, v, None, None, None, zero,
                                             lens)
    rep = N_Q // N_KV
    kk, vv = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    pos = torch.arange(S, device="cuda")
    s_ = torch.einsum("bqhd,bkhd->bhqk", q, kk) * (HD ** -0.5)
    s_ = s_.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    ctrl = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, dim=-1), vv)
    err = ctl = 0.0
    for b, n in enumerate(lens.tolist()):
        err = max(err, (got[b, :n].float() - want[b, :n].float())
                  .abs().max().item())
        ctl = max(ctl, (ctrl[b, :n].float() - want[b, :n].float())
                  .abs().max().item())
    ms = time_ms(lambda: attention.prefill_attention(q, k, v, None, None,
                                                     None, zero, lens))
    f32_ms = time_ms(lambda: attention.dense_prefill_attention(
        q, k, v, None, None, None, zero, lens), reps=5, warmup=1)
    log(f"  prefix-free prefill, SDPA route vs the f32 path (2 rows, S "
        f"{S}, lengths 2048/1100, valid rows): max_abs_err {err:.4g} (tol "
        f"4 x bf16 control {ctl:.4g}); {ms:.4f} ms against {f32_ms:.4f} ms")
    assert torch.isfinite(got).all(), "SDPA route: non-finite"
    assert err <= 4 * ctl, "the SDPA route disagrees with the f32 path"
    del s_, ctrl, want


def chunked_logits_check(llama, cfg, params, prompt):
    """One long prompt's first-token logits, its non-final chunks written
    as the engine writes them, against the same prompt installed whole
    (the SDPA route): (a) each chunk riding a mixed step beside eight idle
    decode rows (kernel 2 at every start, kernel 1 on the rows), (b) each
    as a standalone chunk (the first prefix-free, the later ones through
    kernel 2); the final chunk is an install behind its written prefix
    (kernel 2). Tolerance: PREFILL_REL_TOL of max |logit|, as phase 4's
    check_logits."""
    n = len(prompt)
    n_pages = -(-n // cfg.page_size)
    i32 = dict(dtype=torch.int32, device=params["final_norm"]["scale"].device)
    mcfg = cfg.model
    toks = torch.tensor([prompt], **i32)
    pt = torch.arange(1, n_pages + 1, **i32)[None]
    B_ = cfg.max_batch_size
    idle = torch.zeros((B_,), **i32)
    idle_pt = torch.zeros((B_, cfg.pages_per_seq), **i32)

    def pool():
        return empty_pool(cfg, n_pages + 1, i32["device"])

    def prefill(kv, lo, hi):
        return llama.prefill_forward(
            params, mcfg, toks[:, lo:hi], torch.arange(lo, hi, **i32)[None],
            kv, pt, torch.tensor([lo], **i32), torch.tensor([hi - lo], **i32),
            has_prefix=lo > 0)[0]

    whole = prefill(pool(), 0, n)
    last = (n - 1) // CHUNK * CHUNK
    routes = {}
    for name in ("riding", "standalone"):
        kv = pool()
        for lo in range(0, last, CHUNK):
            if name == "riding":
                llama.mixed_decode_chunk_forward(
                    params, mcfg, idle, idle - 1, toks[0, lo:lo + CHUNK],
                    torch.arange(lo, lo + CHUNK, **i32), kv, idle_pt, pt,
                    idle, torch.tensor([lo], **i32),
                    torch.tensor([CHUNK], **i32))
            else:
                prefill(kv, lo, lo + CHUNK)
        routes[name] = prefill(kv, last, n)
    scale = whole.abs().max().item()
    for name, got in routes.items():
        err = (whole - got).abs().max().item()
        log(f"  first-token logits, whole install vs {name} chunks of "
            f"{CHUNK} ({n} tokens): max_abs_err={err:.4g}, max|logit|="
            f"{scale:.4g} (tol {PREFILL_REL_TOL} x max|logit|), argmax "
            f"{int(whole.argmax())} vs {int(got.argmax())}")
        assert torch.isfinite(got).all(), name
        assert err <= PREFILL_REL_TOL * scale, f"{name} chunks drifted"


def mixed_rows_check(llama, cfg, params):
    """The mixed step's decode rows against ``decode_forward`` from one
    state at full width: eight decode rows (contexts 200-1500 tokens, the
    pool's K/V random) and one chunk of C at start 512 of its prompt.
    (a) With that chunk and with an empty one (``chunk_valid`` 0), the
    decode rows' logits and every page but the chunk's and the garbage
    page are equal bit for bit: the chunk reaches no decode row. (b) The
    decode rows' logits against ``decode_forward``'s, within
    PREFILL_REL_TOL of max |logit|: the two differ in the row count of
    every GEMM (B + C against B), so by bf16 rounding alone."""
    mcfg = cfg.model
    dev = params["final_norm"]["scale"].device
    i32 = dict(dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(13)
    B_, P_ = cfg.max_batch_size, cfg.pages_per_seq
    ctxs = [200, 333, 517, 700, 901, 1100, 1300, 1500][:B_]
    per_row = -(-max(ctxs) // cfg.page_size)
    chunk_pages = -(-(512 + CHUNK) // cfg.page_size)
    n_pages = 1 + B_ * per_row + chunk_pages
    base = torch.randn((mcfg.num_layers, 2, n_pages, mcfg.num_kv_heads,
                        cfg.page_size, mcfg.head_dim), generator=g,
                       device=dev).to(mcfg.dtype)
    dec_pt = torch.zeros((B_, P_), **i32)
    dec_pt[:, :per_row] = torch.arange(1, 1 + B_ * per_row,
                                       **i32).reshape(B_, per_row)
    chunk_pt = torch.zeros((1, P_), **i32)
    chunk_pt[0, :chunk_pages] = torch.arange(1 + B_ * per_row, n_pages, **i32)
    V = mcfg.vocab_size
    tok = torch.randint(3, V, (B_,), generator=g, device=dev).to(torch.int32)
    clens = torch.tensor(ctxs, **i32)
    chunk_tok = torch.randint(3, V, (CHUNK,), generator=g,
                              device=dev).to(torch.int32)
    chunk_pos = torch.arange(512, 512 + CHUNK, **i32)
    start = torch.tensor([512], **i32)

    def mixed(valid):
        kv = base.clone()
        logits = llama.mixed_decode_chunk_forward(
            params, mcfg, tok, clens - 1, chunk_tok, chunk_pos, kv, dec_pt,
            chunk_pt, clens, start, torch.tensor([valid], **i32))[0]
        return logits, kv

    with_chunk, kv_c = mixed(CHUNK)
    empty, kv_e = mixed(0)
    decode = llama.decode_forward(params, mcfg, tok, clens - 1, base.clone(),
                                  dec_pt, clens)[0]
    rows = 1 + B_ * per_row
    same_logits = torch.equal(with_chunk, empty)
    same_pages = torch.equal(kv_c[:, :, 1:rows].view(torch.int16),
                             kv_e[:, :, 1:rows].view(torch.int16))
    scale = decode.abs().max().item()
    err = (with_chunk - decode).abs().max().item()
    log(f"  mixed step's decode rows (contexts {ctxs}, a chunk of {CHUNK} "
        f"at 512): with the chunk == with an empty one bit for bit: logits "
        f"{same_logits}, decode rows' pages {same_pages}; against "
        f"decode_forward max_abs_err={err:.4g}, max|logit|={scale:.4g} (tol "
        f"{PREFILL_REL_TOL} x max|logit|), argmax equal "
        f"{int((with_chunk.argmax(-1) == decode.argmax(-1)).sum())}/{B_}")
    assert same_logits and same_pages, "the chunk reached a decode row"
    assert torch.isfinite(with_chunk).all(), "mixed step: non-finite"
    assert err <= PREFILL_REL_TOL * scale, \
        "the mixed step's decode rows disagree with decode_forward"
    del base, kv_c, kv_e
    gc.collect()
    torch.cuda.empty_cache()


def empty_pool(cfg, n_pages, device, mesh=None):
    """A zeroed KV pool of ``n_pages`` pages for ``cfg``'s model (its
    shards over the model axis of ``mesh``, when that axis is over 1; a
    page-and-head grid, its pages rounded up to a multiple of the seq
    axis, when the seq axis is too)."""
    from xllm_service_tpu_torch.parallel.sharding import ModelShardedPages

    m = cfg.model
    if mesh is not None:
        n_pages += -n_pages % mesh.shape["seq"]
    shape = (m.num_layers, 2, n_pages, m.num_kv_heads, cfg.page_size,
             m.head_dim)
    if mesh is not None and mesh.shape["model"] > 1:
        return ModelShardedPages.zeros(shape, m.dtype, mesh)
    return torch.zeros(shape, dtype=m.dtype, device=device)


def next_token_logits(llama, cfg, params, context):
    """The logits of the token after ``context``, installed whole."""
    n = len(context)
    n_pages = -(-n // cfg.page_size)
    i32 = dict(dtype=torch.int32, device=params["final_norm"]["scale"].device)
    kv = empty_pool(cfg, n_pages + 1, i32["device"])
    return llama.prefill_forward(
        params, cfg.model, torch.tensor([context], **i32),
        torch.arange(n, **i32)[None], kv,
        torch.arange(1, n_pages + 1, **i32)[None],
        torch.zeros((1,), **i32), torch.tensor([n], **i32),
        has_prefix=False)[0][0]


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def tie_rank(logits, tok):
    """(the rank of token ``tok``'s value among the distinct values of
    ``logits`` (bf16 logits tie exactly), its gap below the top, the
    near-tie tolerance: TIE_STEPS bf16 steps at max |logit|)."""
    values = torch.unique(logits)
    took = logits[tok]
    return (int((values > took).sum()) + 1, (values[-1] - took).item(),
            TIE_STEPS * bf16_step(logits.abs().max().item()))


def compare_streams(llama, cfg, params, prompts, got, want, what):
    """Greedy streams ``got`` against ``want`` (name -> tokens). At the
    first difference the logits after the shared context (installed
    whole) must show a near-tie: the token taken holds one of their two
    largest values and trails the top by at most TIE_STEPS bf16 steps at
    max |logit|. Logs each parting; returns how many streams parted."""
    diverged = 0
    for name, w in want.items():
        g = got[name]
        assert len(g) == len(w), f"{what}: {name} length {len(g)}"
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            continue
        diverged += 1
        logits = next_token_logits(llama, cfg, params, prompts[name] + w[:i])
        rank, gap, tol = tie_rank(logits, g[i])
        log(f"  {what}: {name} parts at token {i}: took {g[i]} (value rank "
            f"{rank} there, {int((logits == logits[g[i]]).sum())} token(s) "
            f"at that "
            f"value), {gap:.4g} below the top (tol {TIE_STEPS} bf16 steps "
            f"= {tol:.4g})")
        assert rank <= 2 and gap <= tol, \
            f"{what}: {name} parts at a decided token"
    log(f"  {what}: {len(want) - diverged}/{len(want)} streams identical")
    return diverged


def admission_run(engine_mod, cfg, params, passes, chunk, sarathi, kernels):
    """``passes`` = [(shorts, longs), ...] served one after the other on
    one engine: six short greedy requests (128 new tokens) decoding, then
    the long prompts (16 new tokens each) arriving at once. The first pass
    warms the engine (its mixed-step captures, first-use costs); the last
    is the measured one: the counts are set to 0 before its shorts are
    submitted and read after its last request ends. Returns a dict of the
    last pass: tokens per request, the longs' TTFT ms, the shorts' largest
    gap between deltas while the longs install, rides and standalone
    chunks, kernel launches (``kernels`` order), and the engine's
    mixed-step graph variants with their launches per replay."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    rcfg = replace(cfg, prefill_chunk_tokens=chunk, max_concurrent_prefills=2)
    os.environ["XLLM_SARATHI"] = "1" if sarathi else "0"
    try:
        eng = engine_mod.InferenceEngine(rcfg, params=params)
    finally:
        del os.environ["XLLM_SARATHI"]
    chunks = [0]
    prefill_chunk = eng._prefill_chunk

    def counted(*args):
        chunks[0] += 1
        return prefill_chunk(*args)

    eng._prefill_chunk = counted

    def serve(shorts, longs):
        cols, t_sub = {}, {}

        def submit(name, toks, n):
            cols[name] = Collector()
            t_sub[name] = time.monotonic()
            eng.submit(engine_mod.EngineRequest(
                name, token_ids=toks, on_output=cols[name],
                sampling=SamplingParams(max_tokens=n, temperature=0.0,
                                        ignore_eos=True)))

        for name, toks in shorts.items():
            submit(name, toks, 128)
        for name in shorts:
            assert cols[name].first.wait(600), f"{name} never started"
        t_long = time.monotonic()
        for name, toks in longs.items():
            submit(name, toks, 16)
        for name, c in cols.items():
            assert c.done.wait(900), f"{name} never finished"
        return cols, t_sub, t_long

    eng.start()
    try:
        for i, (shorts, longs) in enumerate(passes):
            if i == len(passes) - 1:
                reset_counts()
                rides0, chunks[0] = eng.sarathi_rides, 0
            cols, t_sub, t_long = serve(shorts, longs)
        launches = tuple(fn.launches for fn in kernels)
    finally:
        eng.stop()
    t_end = max(cols[n].t_first for n in longs)
    gaps = []
    for name in shorts:
        ts = [t for t in cols[name].times if t_long <= t <= t_end]
        before = [t for t in cols[name].times if t < t_long]
        ts = before[-1:] + ts
        gaps += [b - a for a, b in zip(ts, ts[1:])]
    mixed = {key: deltas for key, (_, deltas) in eng._graphs._graphs.items()
             if len(key) == 3}
    out = dict(tokens={n: c.tokens for n, c in cols.items()},
               reasons={n: c.reason for n, c in cols.items()},
               ttft={n: (cols[n].t_first - t_sub[n]) * 1e3 for n in longs},
               gap_ms=max(gaps, default=0.0) * 1e3,
               rides=eng.sarathi_rides - rides0, chunks=chunks[0],
               launches=launches, mixed=mixed)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def preemption_phase(engine_mod, llama, cfg, params, rng, card):
    """An engine with 100 pages: an offline request (512-token prompt, 128
    new tokens: 40 pages) runs; an online one (1024 + 16: 65 pages) finds
    59 free and preempts it; the offline request resumes as a continuation
    once the online one is done. Checks the preemption and the offline
    output against an unpreempted run of the same request: at the phase's
    model in bf16, equal up to the preemption (the same work); in f32, at
    full width and 4 layers, equal in full (lossless resume). In bf16 the
    continuation's prefill of its emitted tokens rounds their K/V
    otherwise than the decode steps that wrote them, and the streams part
    at the next near-tie (information); in f32 that difference is far
    below any logit gap."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    V = cfg.model.vocab_size
    off_prompt = rng.integers(3, V, size=512).tolist()
    on_prompt = rng.integers(3, V, size=1024).tolist()

    def run(rcfg, rparams, num_pages, with_online):
        eng = engine_mod.InferenceEngine(replace(rcfg, num_pages=num_pages),
                                         params=rparams)
        off, on = Collector(), Collector()
        resumed_at = []
        preempt = eng._preempt_one_offline

        def recorded_preempt():
            # The continuation is queued last; it carries the tokens known
            # at the preemption.
            done = preempt()
            if done:
                with eng._lock:
                    resumed_at.append(len(eng._waiting[-1].resume_output_ids))
            return done

        eng._preempt_one_offline = recorded_preempt
        eng.start()
        try:
            eng.submit(engine_mod.EngineRequest(
                "off", token_ids=off_prompt, offline=True, on_output=off,
                sampling=SamplingParams(max_tokens=128, temperature=0.0,
                                        ignore_eos=True)))
            if with_online:
                wait_for(lambda: len(off.tokens) >= 16, "offline tokens")
                eng.submit(engine_mod.EngineRequest(
                    "on", token_ids=on_prompt, on_output=on,
                    sampling=SamplingParams(max_tokens=16, temperature=0.0,
                                            ignore_eos=True)))
                assert on.done.wait(600), "online request never finished"
            assert off.done.wait(600), "offline request never finished"
        finally:
            eng.stop()
        out = (off.tokens, on.tokens, off.reason, eng.preemption_count,
               resumed_at)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return out

    f32 = replace(cfg, model=replace(cfg.model, dtype=torch.float32,
                                     num_layers=4))
    f32_params = llama.init_params(
        f32.model, torch.Generator(device="cuda").manual_seed(5))
    for name, rcfg, rparams in (("bf16", cfg, params),
                                ("f32, 4 layers", f32, f32_params)):
        t = time.monotonic()
        off_tok, on_tok, reason, preempted, resumed_at = run(
            rcfg, rparams, 100, True)
        alone = run(rcfg, rparams, cfg.num_pages, False)[0]
        parts = next((i for i, (a, b) in enumerate(zip(off_tok, alone))
                      if a != b), None)
        log(f"  preemption, {name}: {preempted} preemption(s), resumed "
            f"after {resumed_at} tokens; offline {len(off_tok)} tokens "
            f"({reason}, {len(set(off_tok))} distinct), online "
            f"{len(on_tok)}; against the unpreempted run: first difference "
            f"at {parts}; {time.monotonic() - t:.1f} s; {card}")
        assert preempted >= 1, f"{name}: the online request preempted nothing"
        assert len(on_tok) == 16 and len(off_tok) == 128 \
            and reason == "length", name
        assert off_tok[:resumed_at[0]] == alone[:resumed_at[0]], \
            f"{name}: the tokens before the preemption differ"
        if rcfg is f32:
            assert off_tok == alone, f"{name}: the resumed stream differs"
    del f32_params
    gc.collect()
    torch.cuda.empty_cache()
    return preempted


def mixed_graph_check(engine_mod, cfg, params):
    """From one state at full width, the captured mixed step's replay and
    the same step run op by op must agree bit for bit (packed row, KV
    pool, slot state): eight busy slots and one prompt chunk-prefilling,
    for each span (C and 4C)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    B_ = cfg.max_batch_size
    rng = np.random.default_rng(9)
    V = cfg.model.vocab_size
    gcfg = replace(cfg, num_pages=512, prefill_chunk_tokens=CHUNK,
                   max_batch_size=B_ + 1)
    eng = engine_mod.InferenceEngine(gcfg, params=params)
    greedy = SamplingParams(max_tokens=100, temperature=0.0, ignore_eos=True)
    for i in range(B_):
        eng.submit(engine_mod.EngineRequest(
            f"c{i}", token_ids=rng.integers(3, V, 200).tolist(),
            sampling=greedy))
    eng._admit()
    assert len(eng._running) == B_
    for span_chunks in (1, 4):
        eng.submit(engine_mod.EngineRequest(
            f"long{span_chunks}",
            token_ids=rng.integers(3, V, 6 * CHUNK).tolist(),
            sampling=greedy))
        eng._admit()
        if span_chunks == 4:
            eng.submit(engine_mod.EngineRequest(       # queue pressure
                "waiting", token_ids=[5, 6, 7], sampling=greedy))
        assert eng._prefillings
        span = eng._ride_chunk_args()
        assert span == span_chunks * CHUNK, span
        st = [eng._row, eng.kv_pages, eng._last, eng._clens, eng._active,
              eng._st.token_counts]
        snap = [t_.clone() for t_ in st]
        eng._decode_step(False, False, span)
        eager = [t_.clone() for t_ in st]
        for t_, v in zip(st, snap):
            t_.copy_(v)
        eng._graphs.run(False, False, span)
        torch.cuda.synchronize()
        same = [torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                if a.is_floating_point() else torch.equal(a, b)
                for a, b in zip(eager, st)]
        log(f"  mixed step, span {span}: eager == graphed bit for bit "
            f"(row, pool, last, clens, active, counts) {same}")
        assert all(same), "the replayed mixed step differs from the eager one"
        with eng._lock:
            eng._waiting.clear()
        eng.cancel(f"long{span_chunks}")
        eng._process_cancellations()
    eng.stop()
    del eng, st, snap, eager
    gc.collect()
    torch.cuda.empty_cache()


def admission_phase(engine_mod, llama, attention, cfg, params, prompts,
                    shared, sampled_prompt, phase4_clock, paged_attention,
                    mq, mq_plain, card):
    """Phase 4g: the admission path at Llama-3-8B. Returns the launches of
    kernels 1 and 2 in the chunked run with rides (the path's main run)."""
    time_mq_chunk_shapes(mq, mq_plain)
    sdpa_route_check(attention)
    rng = np.random.default_rng(4)
    V = cfg.model.vocab_size
    chunked_logits_check(llama, cfg, params,
                         rng.integers(3, V, size=1792).tolist())
    mixed_rows_check(llama, cfg, params)
    mixed_graph_check(engine_mod, cfg, params)

    # Two sets of prompts of the same lengths: the first warms each engine
    # (distinct tokens, so the second misses the prefix cache), the second
    # is measured and checked.
    passes = [({f"short{i}": rng.integers(3, V, size=128).tolist()
                for i in range(6)},
               {f"long{i}": rng.integers(3, V, size=n).tolist()
                for i, n in enumerate((1792, 1792, 1100))})
              for _ in range(2)]
    prompts_4g = {**passes[-1][0], **passes[-1][1]}
    counters = (paged_attention, mq)
    # The three runs at ADMISSION_LAYERS layers of phase 4's weights: the
    # rides, chunks, mixed-step captures and streams they compare do not
    # depend on the depth.
    rcfg, rparams = depth_view(cfg, params, ADMISSION_LAYERS)
    runs = {}
    for name, chunk, sarathi in (("chunked, rides", CHUNK, True),
                                 ("chunked, XLLM_SARATHI=0", CHUNK, False),
                                 ("whole installs", 0, True)):
        t = time.monotonic()
        r = runs[name] = admission_run(engine_mod, rcfg, rparams, passes,
                                       chunk, sarathi, counters)
        for n, tk in r["tokens"].items():
            want = 16 if n.startswith("long") else 128
            assert len(tk) == want and r["reasons"][n] == "length", \
                f"{name}: {n}: {len(tk)} tokens, reason {r['reasons'][n]!r}"
        log(f"  {name} (warm pass, then this one): "
            f"{time.monotonic() - t:.1f} s; longs' TTFT ms "
            + ", ".join(f"{v:.1f}" for v in r["ttft"].values())
            + f"; shorts' largest inter-token gap while they install "
            f"{r['gap_ms']:.1f} ms; rides {r['rides']}, standalone chunks "
            f"{r['chunks']}; launches kernel 1 / kernel 2 {r['launches']}; "
            f"mixed-step variants {sorted(r['mixed'])} (information only; "
            f"{card})")
    main = runs["chunked, rides"]
    assert main["rides"] > 0, "no chunk rode a decode step"
    assert runs["chunked, XLLM_SARATHI=0"]["rides"] == 0
    assert runs["whole installs"]["chunks"] == 0
    assert main["mixed"], "no mixed step was captured"
    for key, deltas in main["mixed"].items():
        per_replay = dict((fn.__name__, n) for fn, n in deltas)
        assert per_replay.get("mq_paged_attention", 0) == \
            rcfg.model.num_layers, f"kernel 2 not in the mixed step {key}"
    assert main["launches"][1] >= main["rides"] * rcfg.model.num_layers
    for name in ("chunked, rides", "chunked, XLLM_SARATHI=0"):
        compare_streams(llama, rcfg, rparams, prompts_4g,
                        runs[name]["tokens"],
                        runs["whole installs"]["tokens"],
                        f"{name} vs whole installs")

    log("  preemption at llama3-8b")
    preemption_phase(engine_mod, llama, cfg, params, rng, card)

    # The burst: phase 4's eleven requests submitted at once.
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params)
    clock = StepClock(eng)
    cols = {}
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    samp = SamplingParams(max_tokens=64, temperature=0.8, top_p=0.9,
                          seed=1234, ignore_eos=True)
    reqs = ([(f"g{i}", p, greedy) for i, p in enumerate(prompts)]
            + [("sampled", sampled_prompt, samp)]
            + [(f"s{j}", p, greedy) for j, p in enumerate(shared)])
    eng.start()
    try:
        clock.begin()
        for name, toks, sp in reqs:
            cols[name] = Collector()
            eng.submit(engine_mod.EngineRequest(name, token_ids=toks,
                                                sampling=sp,
                                                on_output=cols[name]))
        for name, c in cols.items():
            assert c.done.wait(900), f"{name} never finished"
        split = clock.end()
    finally:
        eng.stop()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    assert all(len(c.tokens) == 64 for c in cols.values())
    log(f"  the burst (11 requests at once), host split: "
        f"{StepClock.line(split)}")
    log(f"  phase 4 run 1 (9 at once, then 2), admissions ms: "
        + " + ".join(f"{w:.1f}" for w in phase4_clock["admit_walls_ms"])
        + f"; the burst's: "
        + " + ".join(f"{w:.1f}" for w in split["admit_walls_ms"])
        + f" (information only; {card})")
    return main["launches"]


# --------------------------------------------------------------- phase 4h
SPEC_UNIT = list(range(11, 19))     # the reference spec bench's id unit
SPEC_NEW = 128                      # new tokens per phase 4h request


class LpCollector(Collector):
    """A Collector that also keeps each token's (id, logprob)."""

    def __init__(self):
        super().__init__()
        self.logprobs: list[tuple[int, float]] = []

    def __call__(self, out) -> None:
        super().__call__(out)
        for s in out.outputs:
            self.logprobs.extend((lp.token_id, lp.logprob)
                                 for lp in (s.logprobs or []))


def spec_requests(unit):
    """Phase 4h's traffic: eight greedy requests on the reference spec
    bench's repetitive prompts (``unit`` repeated to 256 ids, plus the
    request's index), a seeded sampled request and a logprob request on
    prompts of the same kind. Returns {name: (prompt, sampling fields)}."""
    body = (unit * (256 // len(unit)))[:256]
    reqs = {f"g{i}": (body + [i], dict(temperature=0.0)) for i in range(8)}
    reqs["sampled"] = (body + [8], dict(temperature=0.8, top_p=0.9,
                                        seed=4321))
    reqs["logprobs"] = (body + [9], dict(temperature=0.0, logprobs=True,
                                         top_logprobs=5))
    return reqs


def spec_serve(engine_mod, cfg, params, passes, kernels,
               max_tokens=SPEC_NEW):
    """Serve each request set of ``passes`` (``max_tokens`` each) to the
    end, one after the other, on one engine with its loop; the last pass
    is measured (the counts set to 0 just before its submits, read after
    its last request ends; earlier passes take the captures and first
    uses). Returns the last pass's tokens, finish reasons, logprobs,
    generated tokens/s over the pass and over the greedy requests' window
    (their tokens until the last of them ends: the sampled and logprob
    streams emit one token a cycle, so they bound the pass either way),
    spec calls (a spy on ``_spec_multi``, as the reference's tests),
    tokens emitted per cycle per request (from the drained rows), the
    launches of ``kernels`` and the engine's captured spec variants with
    their launches per replay."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params)
    calls, per_cycle = [0], {}
    spec_multi, drain_one = eng._spec_multi, eng._drain_one_spec

    def counted(*args):
        calls[0] += 1
        return spec_multi(*args)

    def drained(pend):
        drain_one(pend)
        rows, _, _, snapshot = pend
        out = rows.numpy()
        for slot, seq in snapshot.items():
            per_cycle.setdefault(seq.req.service_request_id, []).extend(
                int(n) for n in out[:, slot, 0] if n > 0)

    eng._spec_multi, eng._drain_one_spec = counted, drained
    eng.start()
    try:
        for i, reqs in enumerate(passes):
            if i == len(passes) - 1:
                reset_counts()
                calls[0] = 0
                per_cycle.clear()
                t0 = time.monotonic()
            cols = {}
            for name, (prompt, sp) in reqs.items():
                cols[name] = LpCollector()
                eng.submit(engine_mod.EngineRequest(
                    name, token_ids=prompt, on_output=cols[name],
                    sampling=SamplingParams(max_tokens=max_tokens,
                                            ignore_eos=True, **sp)))
            for name, c in cols.items():
                assert c.done.wait(900), f"{name} never finished"
        wall = time.monotonic() - t0
        launches = tuple(fn.launches for fn in kernels)
    finally:
        eng.stop()
    graphs = {} if eng._graphs is None else {
        key: dict((fn.__name__, n) for fn, n in deltas)
        for key, (_, deltas) in eng._graphs._graphs.items()
        if key[0] == "spec"}
    greedy = [c for n, c in cols.items() if n.startswith("g")]
    out = dict(tokens={n: c.tokens for n, c in cols.items()},
               reasons={n: c.reason for n, c in cols.items()},
               logprobs={n: c.logprobs for n, c in cols.items()},
               tps=sum(len(c.tokens) for c in cols.values()) / wall,
               greedy_tps=sum(len(c.tokens) for c in greedy)
               / (max(c.times[-1] for c in greedy) - t0),
               calls=calls[0], per_cycle=per_cycle, launches=launches,
               graphs=graphs)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_graph_check(engine_mod, cfg, params):
    """From one state at full width, the captured spec cycle's replay and
    the same cycle run op by op must agree bit for bit (packed row, KV
    pool, slot state, history, room), for a greedy-only variant and one
    with sampled and logprob rows; phase 4h's ten requests admitted."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    reqs = spec_requests(SPEC_UNIT)
    gcfg = replace(cfg, num_pages=512)
    for want_lp, sample in ((False, False), (True, True)):
        eng = engine_mod.InferenceEngine(gcfg, params=params)
        for name, (prompt, sp) in reqs.items():
            eng.submit(engine_mod.EngineRequest(
                name, token_ids=prompt, sampling=SamplingParams(
                    max_tokens=100, ignore_eos=True, **sp)))
        eng._admit()
        assert len(eng._running) == len(reqs)
        eng._room.fill_(60)
        st = [eng._srow, eng.kv_pages, eng._last, eng._clens, eng._active,
              eng._st.token_counts, eng._hist_buf, eng._room]

        def restore(snap):
            for t_, v in zip(st, snap):
                t_.copy_(v)
            for b, g in enumerate(eng._gens):
                g.manual_seed(1000 + b)

        snap = [t_.clone() for t_ in st]
        restore(snap)
        eng._spec_cycle(want_lp, sample)
        eager = [t_.clone() for t_ in st]
        same = []
        for _ in range(2):        # the first use (capture), then a replay
            restore(snap)
            eng._graphs.run("spec", want_lp, sample)
            torch.cuda.synchronize()
            same.append([torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                         if a.is_floating_point() else torch.equal(a, b)
                         for a, b in zip(eager, st)])
        emitted = eager[0][:, 0].long().tolist()
        log(f"  spec cycle, logprobs {want_lp}, sampled rows {sample}: "
            f"eager == graphed bit for bit (row, pool, last, clens, active, "
            f"counts, history, room; first use, replay) {same}; tokens "
            f"emitted per slot {emitted}")
        assert all(map(all, same)), \
            "the replayed spec cycle differs from the eager one"
        eng.stop()
        del eng, st, snap, eager
        gc.collect()
        torch.cuda.empty_cache()


def spec_phase(engine_mod, llama, cfg, params, kernels, card):
    """Phase 4h: speculative decoding at Llama-3-8B. Returns the launches
    of ``kernels`` in the measured speculative run (the path's main run)."""
    from dataclasses import replace

    L = cfg.model.num_layers
    scfg = replace(cfg, max_batch_size=10, speculate_k=4, speculate_cycles=4)
    pcfg = replace(cfg, max_batch_size=10)
    warm, reqs = spec_requests(list(range(21, 29))), spec_requests(SPEC_UNIT)
    prompts = {n: p for n, (p, _) in reqs.items()}

    # (a) Serving, bf16, speculation on and off, each after a warm pass.
    runs = {}
    for name, rcfg in (("speculate_k=4", scfg), ("plain", pcfg)):
        t = time.monotonic()
        r = runs[name] = spec_serve(engine_mod, rcfg, params, [warm, reqs],
                                    kernels)
        for n, tk in r["tokens"].items():
            assert len(tk) == SPEC_NEW and r["reasons"][n] == "length", \
                f"{name}: {n}: {len(tk)} tokens, reason {r['reasons'][n]!r}"
        log(f"  {name} (warm pass, then this one): {r['tps']:.1f} generated "
            f"tok/s over the pass, {r['greedy_tps']:.1f} over the greedy "
            f"requests' window, spec calls {r['calls']}, launches kernel "
            f"1 / kernel 2 {r['launches']}, {time.monotonic() - t:.1f} s "
            f"(information only; {card})")
    spec, plain = runs["speculate_k=4"], runs["plain"]
    assert spec["calls"] > 0, "the spec path never ran"
    assert plain["calls"] == 0
    for n in reqs:
        # The cycles until the stream's budget (the install gave its first
        # token; rows past the budget are overshoot, and a stream left
        # with no eligible neighbour finishes on the plain path).
        c, got = [], 1
        for e in spec["per_cycle"].get(n, []):
            if got >= SPEC_NEW:
                break
            c.append(min(e, SPEC_NEW - got))
            got += e
        log(f"  {n}: {sum(c)} tokens in {len(c)} spec cycles, "
            f"{sum(c) / max(1, len(c)):.2f} per cycle, most {max(c or [0])}")
    assert max(max(spec["per_cycle"].get(f"g{i}", [0])) for i in range(8)) \
        >= 2, "no cycle accepted a draft"
    assert spec["graphs"], "no spec cycle was captured"
    for key, per_replay in spec["graphs"].items():
        assert per_replay.get("mq_paged_attention", 0) == L, \
            f"kernel 2 not in every layer of the spec cycle {key}"
    assert spec["launches"][1] >= spec["calls"] * scfg.speculate_cycles * L
    log(f"  speculation against the plain path: {spec['tps']:.1f} / "
        f"{plain['tps']:.1f} tok/s = {spec['tps'] / plain['tps']:.3f}x over "
        f"the pass; greedy window {spec['greedy_tps']:.1f} / "
        f"{plain['greedy_tps']:.1f} = "
        f"{spec['greedy_tps'] / plain['greedy_tps']:.3f}x (information "
        f"only; {card})")
    greedy = [n for n in reqs if n != "sampled"]
    compare_streams(llama, cfg, params, prompts,
                    {n: spec["tokens"][n] for n in greedy},
                    {n: plain["tokens"][n] for n in greedy},
                    "speculation vs plain, bf16")
    log(f"  sampled stream, bf16: identical "
        f"{spec['tokens']['sampled'] == plain['tokens']['sampled']} "
        "(information only)")

    # (b) Exactness in f32 at full width and 4 layers.
    t = time.monotonic()
    f32 = replace(cfg.model, dtype=torch.float32, num_layers=4)
    f32_params = llama.init_params(
        f32, torch.Generator(device="cuda").manual_seed(5))
    exact = [spec_serve(engine_mod, replace(rcfg, model=f32), f32_params,
                        [reqs], kernels) for rcfg in (scfg, pcfg)]
    lp_err = max(abs(a[1] - b[1]) for a, b in zip(
        exact[0]["logprobs"]["logprobs"], exact[1]["logprobs"]["logprobs"]))
    same = sum(exact[0]["tokens"][n] == exact[1]["tokens"][n] for n in reqs)
    log(f"  f32, full width, 4 layers: {same}/{len(reqs)} streams identical "
        f"with and without speculation (greedy, sampled, logprobs); spec "
        f"calls {exact[0]['calls']}; logprobs max diff {lp_err:.3g} (tol "
        f"1e-4); {time.monotonic() - t:.1f} s")
    assert exact[0]["calls"] > 0
    assert same == len(reqs), "speculation changed a stream in f32"
    assert [a[0] for a in exact[0]["logprobs"]["logprobs"]] == \
        [b[0] for b in exact[1]["logprobs"]["logprobs"]]
    assert len(exact[0]["logprobs"]["logprobs"]) == SPEC_NEW
    assert lp_err <= 1e-4, "logprobs moved under speculation"

    # (e) Budgets that fill the context, on the same f32 weights. The room
    # lags one call, so the last verify blocks run past max_seq_len: the
    # history's and the pool's writes there must go nowhere, with every
    # stream still equal to the plain path's.
    t = time.monotonic()
    L_end = 384                            # 24 pages: the table's end
    g_reqs = {n: r for n, r in reqs.items() if n.startswith("g")}
    new = L_end - len(g_reqs["g0"][0])
    ends = [spec_serve(engine_mod, replace(rcfg, model=f32,
                                           max_seq_len=L_end),
                       f32_params, [g_reqs], kernels, max_tokens=new)
            for rcfg in (scfg, pcfg)]
    assert ends[0]["calls"] > 0, "the spec path never ran"
    most = max(max(v) for v in ends[0]["per_cycle"].values())
    same = sum(ends[0]["tokens"][n] == ends[1]["tokens"][n] for n in g_reqs)
    log(f"  f32, budgets filling max_seq_len {L_end}: {same}/{len(g_reqs)} "
        f"greedy streams identical with and without speculation; spec "
        f"calls {ends[0]['calls']}, most tokens in a cycle {most}; "
        f"{time.monotonic() - t:.1f} s")
    for r in ends:
        assert all(len(tk) == new for tk in r["tokens"].values())
    assert same == len(g_reqs), "a stream moved at the context's end"
    del f32_params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The captured spec cycle against the eager one.
    spec_graph_check(engine_mod, scfg, params)

    # (d) The spec_bench twin (bench_1b_config, B 8).
    from xllm_service_tpu_torch.benchmarks import spec_bench

    t = time.monotonic()
    for rec in spec_bench.run("cuda"):
        log("  spec_bench " + json.dumps(rec))
    log(f"  spec_bench twin: {time.monotonic() - t:.1f} s; {card}")
    return spec["launches"]


# --------------------------------------------------------------- phase 4i
PD_PROBE = "s0"      # the request whose pages phase 4i holds bit for bit
# The pd_handoff_bench twin's contexts here: the host paths at 8192 tokens
# took 4.1 and 1.6 s a handoff, best of three, a half of phase 4i.
PD_TWIN_CTXS = (2048,)


class CoordServer:
    """The newline-JSON protocol of the coordination server, as far as the
    port's TCP client speaks it (put with a lease, refresh, get,
    get_prefix, rm, ping), over a port ``MemoryStore`` on the standard
    library: phase 4i's decode agent registers here from its own process
    and finds the stub master's address here."""

    def __init__(self, store):
        import socketserver

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    req = json.loads(line)
                    op, key = req.get("op"), req.get("key", "")
                    out = {"id": req.get("id"), "ok": True}
                    if op == "put":
                        store.put(key, req["value"], req.get("ttl"))
                    elif op == "refresh":
                        out["ok"] = store.refresh(key, req.get("ttl") or 0)
                    elif op == "get":
                        out["value"] = store.get(key)
                    elif op == "get_prefix":
                        out["kvs"] = store.get_prefix(req.get("prefix", ""))
                    elif op == "rm":
                        store.rm(key)
                    elif op != "ping":
                        out = {"id": req.get("id"), "ok": False,
                               "error": f"unknown op {op!r}"}
                    self.wfile.write((json.dumps(out) + "\n").encode())
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self.server = Server(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def decode_agent_child(argv) -> int:
    """``python3 chip_smoke.py --decode-agent SID ARGS...``: phase 4i's
    decode agent, started in this process through the agent's own entry
    point (``engine/agent.py::main`` with ARGS), with two probes the script
    reads: after the install of request SID, a digest of its pages read
    through the plain gather; and, for each line on standard input, one
    line ``REPORT {...}`` on standard output with this process's kernel
    launch counts and the digests. A line ``fault {...}`` first adds that
    rule to this process's fault plane. End of input stops the agent
    (SIGTERM: its drain)."""
    import hashlib
    import logging
    import signal

    from xllm_service_tpu_torch.common.faults import FAULTS
    from xllm_service_tpu_torch.engine import agent as agent_mod
    from xllm_service_tpu_torch.engine import engine as engine_mod
    from xllm_service_tpu_torch.engine.kv_transfer import tensor_bytes
    from xllm_service_tpu_torch.ops import page_dma
    from xllm_service_tpu_torch.ops.cp_paged_attention import paged_partial
    from xllm_service_tpu_torch.ops.mq_paged_attention import (
        mq_paged_attention,
    )
    from xllm_service_tpu_torch.ops.paged_attention import paged_attention

    probe_sid, args = argv[0], argv[1:]
    digests: dict[str, str] = {}
    install = engine_mod.InferenceEngine._dispatch_injected_install

    def probed_install(self, seq, blob, first_token):
        install(self, seq, blob, first_token)
        if seq.req.service_request_id == probe_sid:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            pages = seq.pages.all_pages[:blob.shape[2]]
            got = page_dma.gather_kv_pages_plain(self.kv_pages, pages)
            digests[probe_sid] = hashlib.blake2b(
                tensor_bytes(got), digest_size=16).hexdigest()

    engine_mod.InferenceEngine._dispatch_injected_install = probed_install

    def reports():
        for line in sys.stdin:
            if line.startswith("fault "):
                FAULTS.add(**json.loads(line[6:]))
            print("REPORT " + json.dumps({"launches": {
                "paged_attention": paged_attention.launches,
                "mq_paged_attention": mq_paged_attention.launches,
                "gather_kv_pages": page_dma.gather_kv_pages.launches,
                "scatter_kv_pages": page_dma.scatter_kv_pages.launches,
                "cp_paged_partial": paged_partial.launches},
                "digests": dict(digests)}), flush=True)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=reports, daemon=True).start()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)"
                        ".1s %(name)s: %(message)s")
    agent_mod.main(args)
    return 0


class DecodeChild:
    """A DECODE agent in a second process: ``python3 chip_smoke.py
    HEAD... --type DECODE ... AGENT_ARGS...`` (``HEAD`` is
    ``--decode-agent SID``, or ``--mla-decode-agent LAYERS SID``), with
    its log under ``build/``. ``link(store, pre)`` waits for its
    registration in ``store`` (through the ``CoordServer`` at
    ``coord_addr``) and links it and the PREFILL agent ``pre`` both ways,
    as the master does; ``report(cmd)`` writes ``cmd`` to its standard
    input and reads its ``REPORT`` line (launch counts, the probe
    request's page digest)."""

    def __init__(self, head, agent_args, coord_addr, log_name):
        import subprocess

        from xllm_service_tpu_torch.common.net import pick_free_port

        root = os.path.dirname(os.path.abspath(__file__))
        self.name = f"127.0.0.1:{pick_free_port('127.0.0.1')}"
        os.makedirs(os.path.join(root, "build"), exist_ok=True)
        self.log_path = os.path.join(root, "build", log_name)
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *head, "--type",
             "DECODE", "--coordination-addr", coord_addr, "--port",
             self.name.rpartition(":")[2], *agent_args],
            cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, stderr=open(self.log_path, "w"))

    def tail(self):
        with open(self.log_path) as f:
            return "".join(f.readlines()[-30:])

    def link(self, store, pre):
        from xllm_service_tpu_torch.common.types import InstanceMetaInfo
        from xllm_service_tpu_torch.rpc import instance_key

        key = instance_key("DECODE", self.name)
        deadline = time.monotonic() + 600
        while store.get(key) is None:
            assert self.proc.poll() is None and time.monotonic() < deadline, \
                f"the decode agent did not register:\n{self.tail()}"
            time.sleep(0.5)
        meta = InstanceMetaInfo.from_json(store.get(key))
        assert meta.topology.kv_transfer_addr == pre.kv_transfer.address, \
            "the two agents do not name the same card"
        for addr, peer in ((pre.name, meta), (self.name, pre.meta())):
            post = Poster(addr)
            try:
                status, reply = post("/rpc/link",
                                     {"peer": json.loads(peer.to_json())})
            finally:
                post.close()
            assert status == 200 and reply["ok"], reply
        self.meta = meta
        return time.monotonic() - self.t0

    def report(self, cmd="report"):
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        while True:
            line = self.proc.stdout.readline()
            assert line, f"the decode agent exited:\n{self.tail()}"
            if line.startswith("REPORT "):
                return json.loads(line[7:])

    def close(self):
        import subprocess

        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def http_get(addr, path):
    import http.client

    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def pd_phase(cfg, params, llama, prompts, shared, sampled_prompt, want,
             mix_ttft, kernels, card):
    """Phase 4i: PD disaggregation at Llama-3-8B on one card. A PREFILL
    agent in this process on phase 4's params (chunks of CHUNK), a DECODE
    agent in a second process (the agent's entry point, the same seed,
    phase 4's engine shape), both behind the stub master, which links them
    both ways and dispatches each request to the prefill agent with
    ``routing.decode_name``. ``want`` = phase 4's tokens per request,
    ``mix_ttft`` = phase 4f's client-side TTFT per request. Every
    dispatch carries a trace context. After the checks of the device
    path, one more request is sent down the streamed path by a fault rule
    on the prefill side's device offer, and its streamed pull is failed
    by a rule in the decode process: the handoff falls back inline.
    Returns the launches of kernels 1, 2, 4 and 5 in this phase (both
    processes)."""
    import dataclasses
    import hashlib
    import types
    import uuid

    from xllm_service_tpu_torch.common.faults import FAULTS
    from xllm_service_tpu_torch.common.types import InstanceType
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.engine.kv_transfer import (
        tensor_bytes,
        transfer_uuid,
    )
    from xllm_service_tpu_torch.ops import page_dma
    from xllm_service_tpu_torch.rpc import MASTER_KEY

    paged_attention, mq_paged_attention = kernels
    store = MemoryStore()
    coord = CoordServer(store)
    master = StubMaster()
    InMemoryCoordination(store).set(MASTER_KEY, master.addr)
    child = DecodeChild(
        ["--decode-agent", PD_PROBE],
        ["--model-config", "llama3_8b", "--model-id", "llama3-8b",
         "--num-pages", str(cfg.num_pages),
         "--page-size", str(cfg.page_size),
         "--max-batch-size", str(cfg.max_batch_size),
         "--max-seq-len", str(cfg.max_seq_len),
         "--decode-horizon", str(cfg.decode_horizon)], coord.addr,
        "phase4i_decode_agent.log")
    dec_name, report = child.name, child.report
    pre = None
    try:
        pre = EngineAgent(
            dataclasses.replace(cfg, prefill_chunk_tokens=CHUNK),
            AgentConfig(instance_type=InstanceType.PREFILL,
                        model_id="llama3-8b", heartbeat_interval_s=1.0),
            coord=InMemoryCoordination(store), params=params, device="cuda")
        pre.start()
        reg_s = child.link(store, pre)
        dmeta = child.meta
        log(f"  decode agent {dec_name} (pid {child.proc.pid}) registered "
            f"after {reg_s:.1f} s; transfer address "
            f"{dmeta.topology.kv_transfer_addr}")
        post_pre = Poster(pre.name)
        offered: dict[str, str] = {}
        offer = pre.kv_transfer.offer

        def probed_offer(sid, blob, incarnation="", ready=None, ctx=None):
            desc = offer(sid, blob, incarnation, ready=ready, ctx=ctx)
            if sid == PD_PROBE:      # the extract has run (offer waited)
                offered[sid] = hashlib.blake2b(
                    tensor_bytes(blob), digest_size=16).hexdigest()
            return desc

        pre.kv_transfer.offer = probed_offer
        # Kernel 4 at the handoff's shapes: right after each extract's
        # gather, before its pages are recycled, the plain gather of the
        # same pages; the count of differing elements stays on the card
        # until the run is over (no wait on the engine thread).
        extract = pre.engine.extract_kv_pages_device
        gathers: list = []

        def probed_extract(pages):
            got = extract(pages)
            want = page_dma.gather_kv_pages_plain(pre.engine.kv_pages, pages)
            bits = torch.int16 if got.element_size() == 2 else torch.int32
            gathers.append((tuple(got.shape),
                            (got.view(bits) != want.view(bits)).sum()))
            return got

        pre.engine.extract_kv_pages_device = probed_extract
        before = report()["launches"]
        greedy = dict(max_tokens=64, temperature=0.0, ignore_eos=True)
        samp = dict(max_tokens=64, temperature=0.8, top_p=0.9, seed=1234,
                    ignore_eos=True)
        sent: dict[str, float] = {}
        ctxs: dict[str, dict] = {}

        def dispatch(sid, toks, **sp):
            sent[sid] = time.monotonic()
            ctxs[sid] = {"trace_id": uuid.uuid4().hex,
                         "span_id": uuid.uuid4().hex[:16]}
            status, reply = post_pre("/v1/completions", dict(
                service_request_id=sid, request_id=sid, token_ids=toks,
                source_service_addr=master.addr, trace_context=ctxs[sid],
                routing={"decode_name": dec_name}, **sp))
            assert status == 200, reply

        reset_counts()
        t0 = time.monotonic()
        for i, p in enumerate(prompts):
            dispatch(f"g{i}", p, **greedy)
        dispatch("sampled", sampled_prompt, **samp)
        master.wait(lambda: "g0" in master.first, "request 0's first delta")
        for j, p in enumerate(shared):
            dispatch(f"s{j}", p, **greedy)
        dispatch("lp", prompts[1], max_tokens=8, temperature=0.0,
                 logprobs=True, top_logprobs=2, ignore_eos=True)
        names = [f"g{i}" for i in range(len(prompts))] + ["sampled"] + \
            [f"s{j}" for j in range(len(shared))] + ["lp"]
        master.wait(lambda: all(map(master.finished, names)),
                    "phase 4i's requests", timeout=600)
        wall = time.monotonic() - t0
        after = report()
        n = len(names)
        dec = types.SimpleNamespace(name=dec_name,
                                    incarnation_id=dmeta.incarnation_id)
        toks = {nm: check_deltas(nm, master.gens[nm], dec)[0]
                for nm in names}
        tps = sum(map(len, toks.values())) / wall

        # (a) The greedy streams against phase 4's (MIX, whole installs on
        # one engine): equal but at a bf16 near-tie (the prefill side
        # chunks by CHUNK, which rounds otherwise).
        ctx = {f"g{i}": p for i, p in enumerate(prompts)}
        ctx.update({f"s{j}": p for j, p in enumerate(shared)})
        parted = compare_streams(llama, cfg, params, ctx,
                                 {nm: toks[nm] for nm in ctx},
                                 {nm: want[nm] for nm in ctx},
                                 "4i PD pair vs phase 4")
        rows = [r for g in master.gens["lp"] for o in g["outputs"]
                for r in o["logprobs"]]
        assert len(toks["lp"]) == 8 and len(rows) == 8 and all(
            len(r["top_logprobs"]) == 2 for r in rows), "logprob rows"
        assert len(toks["sampled"]) == 64
        log(f"  (a) {len(ctx) - parted}/{len(ctx)} greedy streams equal to "
            f"phase 4's; the seeded sampled stream "
            f"{'equals' if toks['sampled'] == want['sampled'] else 'differs from'}"
            f" phase 4's (information: chunked bf16 logits); 8 logprob rows "
            f"with 2 alternatives")
        # (b) Every handoff on the device path.
        status, dstats = http_get(dec_name, "/stats")
        assert status == 200, dstats
        kvt = dstats["kv_transfer"]
        assert (pre.kv_device_sent, pre.kv_host_sent) == (n, 0) and \
            (kvt["device_received"], kvt["host_received"]) == (n, 0), \
            f"handoffs off the device path: sent {pre.kv_device_sent} " \
            f"device / {pre.kv_host_sent} host, received {kvt}"
        log(f"  (b) {n} handoffs, all on the CUDA IPC path: device_sent "
            f"{pre.kv_device_sent}, device_received "
            f"{kvt['device_received']}, host_sent {pre.kv_host_sent}, "
            f"host_received {kvt['host_received']}")
        # (c) Kernel 4 against the plain gather at every handoff's pages,
        # and one request's pages: the decode side's after the install
        # (the plain gather) against the prefill side's extracted buffer.
        bad = [(shape, int(d)) for shape, d in gathers if int(d)]
        assert len(gathers) == n and not bad, \
            f"kernel 4 at the handoffs: {len(gathers)} gathers for {n} " \
            f"handoffs; differing elements (shape, count) {bad}"
        shapes = sorted({shape for shape, _ in gathers},
                        key=lambda sh: sh[2])
        log(f"  (c) kernel 4 bit-identical to the plain gather at all {n} "
            f"handoffs, {len(shapes)} shapes from {shapes[0]} to "
            f"{shapes[-1]}")
        got = after["digests"].get(PD_PROBE)
        assert got is not None and got == offered.get(PD_PROBE), \
            f"{PD_PROBE}: decode pages {got} != extracted {offered}"
        log(f"      {PD_PROBE}: the decode side's installed pages equal the "
            f"prefill side's extracted buffer bit for bit (blake2b {got})")
        # (d) The kernels on each side.
        dl = {k: after["launches"][k] - before[k] for k in before}
        mine = (page_dma.gather_kv_pages.launches,
                mq_paged_attention.launches,
                page_dma.scatter_kv_pages.launches, paged_attention.launches)
        assert mine[0] == n and mine[1] > 0 and mine[3] == 0, \
            f"prefill side: gather/mq/scatter/decode launches {mine}"
        assert dl["scatter_kv_pages"] == n and dl["paged_attention"] > 0, \
            f"decode side: launches {dl}"
        log(f"  (d) prefill side: kernel 4 {mine[0]} (one a handoff), kernel "
            f"2 {mine[1]}, kernel 1 {mine[3]}; decode side: kernel 5 "
            f"{dl['scatter_kv_pages']} (one a handoff), kernel 1 "
            f"{dl['paged_attention']}, kernel 2 {dl['mq_paged_attention']}")
        # (e) The decode side's heartbeat reports the donated blocks.
        master.wait(lambda: any(h["name"] == dec_name
                                and h["kv_cache_event"]["stored"]
                                for h in master.heartbeats),
                    "a decode heartbeat with stored blocks", timeout=30)
        stored = sum(len(h["kv_cache_event"]["stored"])
                     for h in master.heartbeats if h["name"] == dec_name)
        log(f"  (e) the decode agent's heartbeats report {stored} stored "
            "blocks")
        pd_ttft = sorted((master.first[nm] - sent[nm]) * 1e3 for nm in ctx)
        mx = sorted(mix_ttft[nm] for nm in ctx)
        log(f"  client-side TTFT ms over phase 4's greedy requests: PD pair "
            f"p50 {pd_ttft[len(pd_ttft) // 2]:.1f} max {pd_ttft[-1]:.1f}; "
            f"phase 4f MIX p50 {mx[len(mx) // 2]:.1f} max {mx[-1]:.1f}; "
            f"{tps:.1f} generated tok/s through the pair (information only; "
            f"{card})")

        # (f) The spans of every handoff under its dispatched trace: the
        # prefill stage and the device offer here, the device pull and
        # the injected decode stage in the decode process.
        def spans_of(addr, sid):
            status, body = http_get(addr, f"/admin/trace?request_id={sid}")
            assert status == 200, (addr, sid, body)
            tid = ctxs[sid]["trace_id"]
            assert body["trace_id"] == tid and all(
                s_["trace_id"] == tid for s_ in body["spans"]), body
            return {(s_["point"], s_["attrs"].get("path")): s_
                    for s_ in body["spans"]}

        for nm in names:
            mine_, theirs = spans_of(pre.name, nm), spans_of(dec_name, nm)
            root = ctxs[nm]["span_id"]
            assert mine_[("engine.prefill", None)]["parent_span_id"] == root
            assert ("kv_transfer.offer", "device") in mine_, sorted(mine_)
            assert ("kv_transfer.pull", "device") in theirs, sorted(theirs)
            dspan = theirs[("engine.decode", None)]
            assert dspan["parent_span_id"] == root and \
                dspan["attrs"]["injected"] is True
        log(f"  (f) {n} traces: engine.prefill and kv_transfer.offer (device) "
            f"in the prefill agent, kv_transfer.pull (device) and the "
            f"injected engine.decode in the decode agent, each under its "
            f"dispatched trace id and parented on the carried span")

        # (g) A streamed handoff whose pull fails falls back inline: the
        # device offer of "fb" is failed here (so it streams), its
        # streamed pull in the decode process.
        fb = "fb"
        FAULTS.add("kv_transfer.offer", match={"sid": fb}, max_fires=1)
        report("fault " + json.dumps({
            "point": "kv_transfer.pull", "max_fires": 1, "match": {
                "uuid": transfer_uuid(fb, "stream:" + pre.incarnation_id)}}))
        sent0 = (pre.kv_device_sent, pre.kv_host_sent, pre.kv_stream_sent)
        recv0 = http_get(dec_name, "/stats")[1]["kv_transfer"]
        dispatch(fb, prompts[0], **greedy)
        master.wait(lambda: master.finished(fb), "the fallback request",
                    timeout=300)
        final = report()
        fb_toks = check_deltas(fb, master.gens[fb], dec)[0]
        compare_streams(llama, cfg, params, {fb: prompts[0]}, {fb: fb_toks},
                        {fb: want["g0"]}, "4i inline fallback vs phase 4")
        recv1 = http_get(dec_name, "/stats")[1]["kv_transfer"]
        assert (pre.kv_device_sent, pre.kv_host_sent, pre.kv_stream_sent) \
            == (sent0[0], sent0[1] + 1, sent0[2]), "the fallback's path"
        assert (recv1["host_received"] - recv0["host_received"],
                recv1["stream_received"] - recv0["stream_received"],
                recv1["device_received"] - recv0["device_received"]) == \
            (1, 0, 0), (recv0, recv1)
        status, fr = http_get(
            pre.name, "/admin/flightrecorder/recent?kind=kv_stream_fallback")
        assert status == 200 and fr["num_records"] == 1, fr
        rec = fr["records"][0]
        assert rec["request_id"] == fb and \
            rec["trace_id"] == ctxs[fb]["trace_id"] and \
            rec["engine"]["instance"] == pre.name and \
            "kv_transfer" in rec["engine"], rec
        mine_, theirs = spans_of(pre.name, fb), spans_of(dec_name, fb)
        pull = theirs[("kv_transfer.pull", "stream")]
        assert pull["status"].startswith("ERROR") and \
            pull["events"][0]["name"] == "fault", pull
        assert mine_[("kv_transfer.offer", "device")]["status"] \
            .startswith("ERROR")
        assert {("kv_transfer.offer", "stream"),
                ("kv_transfer.offer", "host")} <= set(mine_)
        log(f"  (g) the fault rules sent {fb} down the streamed path and "
            f"failed its pull: inline fallback (host_sent +1, stream_sent "
            f"+0), its 64 tokens equal phase 4's g0 but at a near-tie, one "
            f"kv_stream_fallback record with the engine context "
            f"({rec['engine']['stats']}), the stream pull span ERROR with "
            f"its fault event, the offer spans of the three paths")
        dl = {k: final["launches"][k] - before[k] for k in before}
        mine = (page_dma.gather_kv_pages.launches,
                mq_paged_attention.launches,
                page_dma.scatter_kv_pages.launches)
        return (dl["paged_attention"], mine[1] + dl["mq_paged_attention"],
                mine[0] + dl["gather_kv_pages"],
                mine[2] + dl["scatter_kv_pages"])
    except BaseException:
        log(f"  the decode agent's log, last lines:\n{child.tail()}")
        raise
    finally:
        FAULTS.clear()
        child.close()
        if pre is not None:
            pre.stop()
        master.close()
        coord.close()
        store.close()
        del pre
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4j
def draw_norms_and_biases(params, seed):
    """Every norm scale and qkv bias of a random tree drawn from N(0, 0.1)
    (plus 1 for a plain norm): zero biases and identity norms would hide a
    bias or (1 + w) fault. In place."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    unit = params["final_norm"]["scale"].float().mean().item()

    def draw(t, base):
        t.copy_(base + 0.1 * torch.randn(t.shape, generator=g, device="cuda",
                                          dtype=torch.float32))

    draw(params["final_norm"]["scale"], unit)
    for name, leaf in params["layers"].items():
        if name.endswith("_norm"):
            draw(leaf["scale"], unit)
        if "bias" in leaf:
            draw(leaf["bias"], 0.0)


def serve_variant(engine_mod, cfg, params, prompts, shared, sampled_prompt,
                  long_prompt, after=None, attach=None):
    """One serving run of phase 4j on a fresh engine with its loop: the
    greedy ``prompts``, one seeded sampled and one greedy logprob request,
    ``long_prompt`` (if any) with them, and the ``shared`` prompts once
    request 0 has its first token (prefix hits). 64 new tokens each.
    ``attach(engine)`` runs before the loop starts (phase 4m's install
    spy), ``after(engine)`` once every request has finished, before the
    loop stops (phase 4m's embeddings call). Returns (tokens and prompts
    by name, stats, TTFT ms sorted, generated tok/s, the engine's params:
    quantized if the config says so, ``after``'s result)."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params)
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    samp = SamplingParams(max_tokens=64, temperature=0.8, top_p=0.9,
                          seed=1234, ignore_eos=True)
    lp = SamplingParams(max_tokens=64, temperature=0.0, logprobs=True,
                        top_logprobs=2, ignore_eos=True)
    cols, sent, t_sub = {}, {}, {}
    if attach is not None:
        attach(eng)
    eng.start()
    try:
        t0 = time.monotonic()

        def submit(name, toks, sp):
            cols[name], sent[name] = Collector(), toks
            t_sub[name] = time.monotonic()
            eng.submit(engine_mod.EngineRequest(name, token_ids=toks,
                                                sampling=sp,
                                                on_output=cols[name]))

        for i, p in enumerate(prompts):
            submit(f"g{i}", p, greedy)
        submit("sampled", sampled_prompt, samp)
        submit("logprobs", prompts[-1][:300], lp)
        if long_prompt is not None:
            submit("long", long_prompt, greedy)
        assert cols["g0"].first.wait(600), "request 0 never started"
        for j, p in enumerate(shared):
            submit(f"s{j}", p, greedy)
        for name, c in cols.items():
            assert c.done.wait(900), f"{name} never finished"
        wall = time.monotonic() - t0
        extra = after(eng) if after is not None else None
    finally:
        eng.stop()
    for name, c in cols.items():
        assert len(c.tokens) == 64 and c.reason == "length", \
            f"{name}: {len(c.tokens)} tokens, reason {c.reason!r}"
    stats = eng.stats()
    ttft = sorted((c.t_first - t_sub[n]) * 1e3 for n, c in cols.items())
    toks = {n: c.tokens for n, c in cols.items()}
    eng_params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return (toks, sent, stats, ttft, sum(map(len, toks.values())) / wall,
            eng_params, extra)


def decode_step_vs_plain(llama, attention, cfg, params, context,
                         paged_attention_plain):
    """One decode step after ``context`` (its last token decoded behind
    the rest, installed whole): its logits with kernel 1, then the same
    step on the same pool with kernel 1's plain version in its place.
    Returns (max abs difference, max |logit|)."""
    m = cfg.model
    n = len(context)
    n_pages = -(-n // cfg.page_size)
    i32 = dict(dtype=torch.int32, device="cuda")
    kv = empty_pool(cfg, n_pages + 1, "cuda")
    pt = torch.arange(1, n_pages + 1, **i32)[None]
    toks = torch.tensor([context], **i32)
    llama.prefill_forward(params, m, toks[:, :n - 1],
                          torch.arange(n - 1, **i32)[None], kv, pt,
                          torch.zeros((1,), **i32),
                          torch.tensor([n - 1], **i32), has_prefix=False)

    def step():
        return llama.decode_forward(params, m, toks[:, n - 1],
                                    torch.tensor([n - 1], **i32), kv, pt,
                                    torch.tensor([n], **i32))[0]

    got = step()
    real = attention.paged_attention
    attention.paged_attention = paged_attention_plain
    try:
        want = step()
    finally:
        attention.paged_attention = real
    assert torch.isfinite(got).all(), "decode step: non-finite logits"
    return (got - want).abs().max().item(), want.abs().max().item()


@contextlib.contextmanager
def router_logits(moe):
    """The f32 router logits [T, E] of every MoE layer the forwards of
    module ``moe`` (models/deepseek_moe.py) run inside the block, in
    call order (its gate map's, on one device or over expert shards)."""
    real = moe._gate_map
    rec = []

    def logged(router, x2, cfg):
        rec.append(x2.float() @ router.float())
        return real(router, x2, cfg)

    moe._gate_map = logged
    try:
        yield rec
    finally:
        moe._gate_map = real


def check_streams_recomputed(llama, cfg, params, sent, toks, what,
                             moe=None):
    """Each greedy stream against its recomputation: the prompt but its
    last token installed whole, then one verify forward over the last
    prompt token and the stream's tokens but the last gives the logits
    that predict every stream token. Each token must be the argmax, or a
    near-tie as in ``compare_streams`` (one of the two largest values,
    within TIE_STEPS bf16 steps of the top).

    With ``moe`` (the MoE families' module) a token may also be a routing
    near-tie: the expert choice is discontinuous, so where two routes
    round a position's hidden state apart, a layer whose k-th and
    (k+1)-th router logits lie closer than the routes' difference may
    take another expert there, and the logits move by more than
    rounding. The route drift is measured on the stream itself: per
    layer, the median over the block's positions of the largest
    difference between the router logits of the verify forward and those
    of one prefill of the prompt and the stream (the dense route, other
    matmul shapes). A token that fails the rule above is excused, and
    counted, only if some layer's margin at its position is below that
    layer's drift, and at most ROUTED_SHARE of the tokens may be excused:
    a fault of the serving path (a wrong page, position or gate) moves
    most tokens, not a few. With random weights over 26-32 MoE layers most
    positions have such a layer (the count is logged), so the share is
    what holds the run. ``params`` may be sharded over a mesh (phase 4o):
    the recomputation then runs on its shards. Returns (tokens checked,
    argmax tokens)."""
    m = cfg.model
    i32 = dict(dtype=torch.int32, device="cuda")
    checked = exact = routed = excusable = 0
    drifts = []
    for name, gen in toks.items():
        if name == "sampled":
            continue
        prompt = sent[name]
        n = len(prompt)
        n_pages = -(-(n + len(gen)) // cfg.page_size)
        mesh = getattr(params, "mesh", None)
        kv = empty_pool(cfg, n_pages + 1, "cuda", mesh)
        pt = torch.arange(1, n_pages + 1, **i32)[None]
        llama.prefill_forward(params, m, torch.tensor([prompt[:-1]], **i32),
                              torch.arange(n - 1, **i32)[None], kv, pt,
                              torch.zeros((1,), **i32),
                              torch.tensor([n - 1], **i32), has_prefix=False)
        block = [prompt[-1]] + gen[:-1]
        with (router_logits(moe) if moe is not None
              else contextlib.nullcontext([])) as rec:
            logits = llama.verify_forward(
                params, m, torch.tensor([block], **i32),
                torch.arange(n - 1, n - 1 + len(block), **i32)[None], kv,
                pt, torch.tensor([n - 1], **i32),
                torch.tensor([len(block)], **i32))[0][0]
        if moe is not None:
            k = m.num_experts_per_token
            r1 = torch.stack(rec)                                 # [L, S, E]
            top = r1.topk(k + 1, dim=-1).values
            margin = top[..., k - 1] - top[..., k]                # [L, S]
            whole = prompt + gen[:-1]
            kv2 = empty_pool(cfg, n_pages + 1, "cuda", mesh)
            with router_logits(moe) as rec2:
                llama.prefill_forward(
                    params, m, torch.tensor([whole], **i32),
                    torch.arange(len(whole), **i32)[None], kv2, pt,
                    torch.zeros((1,), **i32),
                    torch.tensor([len(whole)], **i32), has_prefix=False)
            r2 = torch.stack([b[n - 1:] for b in rec2])
            drift = (r1 - r2).abs().amax(dim=-1).median(dim=1).values  # [L]
            near = (margin < drift[:, None]).any(dim=0)           # [S]
            drifts.append(drift)
            excusable += int(near.sum())
            del kv2, rec2, r1, r2
        for j, tok in enumerate(gen):
            rank, gap, tol = tie_rank(logits[j], tok)
            checked += 1
            if rank <= 2 and gap <= tol:
                exact += rank == 1
                continue
            if moe is not None and bool(near[j]):
                routed += 1
                continue
            raise AssertionError(
                f"{what}: {name} token {j} ({tok}) is no near-tie: rank "
                f"{rank}, {gap:.4g} below the top (tol {tol:.4g})" + (
                    f"; router margin / route drift at its position "
                    f"{(margin[:, j] / drifts[-1]).min().item():.4g}"
                    if moe is not None else ""))
    if moe is None:
        log(f"  {what}: {checked} greedy tokens against their "
            f"recomputation: {exact} the argmax, {checked - exact} "
            f"near-ties")
        return checked, exact
    d = torch.stack(drifts)
    log(f"  {what}: {checked} greedy tokens against their recomputation: "
        f"{exact} the argmax, {checked - exact - routed} near-ties, "
        f"{routed} routing near-ties (tol {ROUTED_SHARE} of the tokens; "
        f"{excusable} positions had a layer's router margin below its "
        f"route drift, which is {d.min().item():.4g}-{d.max().item():.4g} "
        f"by layer)")
    assert routed <= ROUTED_SHARE * checked, \
        f"{what}: {routed} of {checked} tokens only routing near-ties"
    return checked, exact


def variant_leg(engine_mod, llama, attention, name, cfg, params, requests,
                kernels, card, logit_context):
    """One leg of phase 4j: serve ``requests`` = (prompts, shared,
    sampled_prompt, long_prompt) with the counts set to 0 just before and
    read just after; check the replays and kernel 1's launches (one per
    layer per step: every step is a replay or a capture's warm-up), one
    decode step's logits against kernel 1's plain version after
    ``logit_context``, and the greedy streams against their
    recomputation. Returns (kernel 1 and kernel 2 launches, dense-route
    prefills, prefix hits)."""
    paged_attention, mq_paged_attention, paged_attention_plain = kernels
    reset_counts()
    dense0 = attention.dense_prefill_route.launches
    t = time.monotonic()
    toks, sent, stats, ttft, tps, eng_params, _ = serve_variant(
        engine_mod, cfg, params, *requests)
    k1, k2 = paged_attention.launches, mq_paged_attention.launches
    dense = attention.dense_prefill_route.launches - dense0
    L = cfg.model.num_layers
    graph = stats["decode_graph"]
    log(f"  {name}: served {len(toks)} requests in "
        f"{time.monotonic() - t:.1f} s: TTFT ms p50 {ttft[len(ttft) // 2]:.1f}"
        f" max {ttft[-1]:.1f}; {tps:.1f} generated tok/s over the run "
        f"(information only; {card}); prefix hits {stats['prefix_hits']}; "
        f"decode graph captures {graph['captures']}, replays "
        f"{graph['replays']}; launches: kernel 1 {k1}, kernel 2 {k2}; "
        f"prefill attention calls on the dense route {dense}")
    check_replays(stats, name)
    assert k1 == L * (graph["replays"] + graph["captures"]), \
        f"{name}: kernel 1 launched {k1} times, not {L} a step"
    e, scale = decode_step_vs_plain(llama, attention, cfg, eng_params,
                                    logit_context, paged_attention_plain)
    log(f"  {name}: a decode step after {len(logit_context)} tokens, kernel "
        f"1 vs its plain version: max_abs_err={e:.4g}, max|logit|="
        f"{scale:.4g} (tol {PREFILL_REL_TOL} x max|logit|)")
    assert e <= PREFILL_REL_TOL * scale, f"{name}: decode logits drifted"
    check_streams_recomputed(llama, cfg, eng_params, sent, toks, name)
    del eng_params
    gc.collect()
    torch.cuda.empty_cache()
    return k1, k2, dense, stats["prefix_hits"]


def bench_twin_int8(params, card):
    """The bench twin (B 16, ctx 512) at Llama-3-8B in weight-only int8 on
    ``params``; logs and returns its record (information only, beside phase
    4e's bf16 figure)."""
    from xllm_service_tpu_torch import bench

    os.environ["XLLM_BENCH_MODEL"] = "8b"
    os.environ["XLLM_QUANT"] = "int8"
    try:
        b = bench.run("cuda", params=params)
    finally:
        del os.environ["XLLM_BENCH_MODEL"], os.environ["XLLM_QUANT"]
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  bench twin (8b int8, B {b['batch']}, ctx {b['ctx']}): "
        f"{b['value']:.1f} tok/s, {b['ms_per_token_step']:.3f} ms a "
        f"token-step, pct_roofline {b['pct_roofline']:.2f} "
        f"({b['bytes_per_step_mb']:.1f} MB a step; information only; {card})")
    return b


def variants_phase(engine_mod, llama, attention, llama_cfg, llama_params,
                   prompts, shared, sampled_prompt, kernels, card, bench_bf16):
    """Phase 4j: the llama family's variants at full width and depth, each
    on random weights from a seed with drawn norm scales and biases:
    (a) Gemma-2-9B with a prompt past its 4096-token window, (b) Qwen2-7B
    with qkv biases, (c) Llama-3-8B in weight-only int8 (phase 4's weights,
    quantized by the engine, then the bench twin in int8). Returns the
    summed launches of kernels 1 and 2."""
    from dataclasses import replace

    from xllm_service_tpu_torch.models.gemma import gemma2_9b_config
    from xllm_service_tpu_torch.models.qwen2 import qwen2_7b_config

    total = [0, 0]
    rng = np.random.default_rng(12)

    # (a) Gemma-2-9B.
    t = time.monotonic()
    mcfg = gemma2_9b_config()
    V = mcfg.vocab_size
    gcfg = engine_config_4j(mcfg, num_pages=1024, max_seq_len=8192)
    params = llama.init_params(mcfg, torch.Generator(device="cuda")
                               .manual_seed(1), "cuda")
    draw_norms_and_biases(params, 2)
    g_prompts = [rng.integers(3, V, size=int(n)).tolist()
                 for n in rng.integers(64, 1025, size=5)]
    g_shared = [g_prompts[0][:512] + rng.integers(3, V, size=int(n)).tolist()
                for n in rng.integers(64, 513, size=2)]
    long_prompt = rng.integers(3, V, size=4600).tolist()
    log(f"  gemma2-9b: {mcfg.num_layers} layers, hidden {mcfg.hidden_size}, "
        f"{mcfg.num_heads}/{mcfg.num_kv_heads} heads of {mcfg.head_dim}, "
        f"window {mcfg.sliding_window} on even layers; weights drawn in "
        f"{time.monotonic() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    k1, k2, dense, hits = variant_leg(
        engine_mod, llama, attention, "gemma2-9b", gcfg, params,
        (g_prompts, g_shared, rng.integers(3, V, size=200).tolist(),
         long_prompt), kernels, card, long_prompt)
    assert hits >= 2, "gemma2-9b: no prefix hits"
    assert dense > 0 and k2 == 0, \
        "gemma2-9b: a softcapped prefill left the dense route"
    total[0] += k1
    total[1] += k2
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  gemma2-9b leg: {time.monotonic() - t:.1f} s")

    # (b) Qwen2-7B.
    t = time.monotonic()
    mcfg = qwen2_7b_config()
    V = mcfg.vocab_size
    qcfg = engine_config_4j(mcfg, num_pages=2048, max_seq_len=2048)
    params = llama.init_params(mcfg, torch.Generator(device="cuda")
                               .manual_seed(3), "cuda")
    draw_norms_and_biases(params, 4)
    q_prompts = [rng.integers(3, V, size=int(n)).tolist()
                 for n in rng.integers(64, 1025, size=6)]
    q_shared = [q_prompts[0][:512] + rng.integers(3, V, size=300).tolist()]
    k1, k2, dense, hits = variant_leg(
        engine_mod, llama, attention, "qwen2-7b", qcfg, params,
        (q_prompts, q_shared, rng.integers(3, V, size=200).tolist(), None),
        kernels, card, q_prompts[1])
    assert hits >= 1 and k2 > 0, "qwen2-7b: no prefix hit through kernel 2"
    assert dense == 0
    log(f"  qwen2-7b: kernel 2 (the f32 walk: group "
        f"{mcfg.num_heads // mcfg.num_kv_heads}) launched {k2} times")
    total[0] += k1
    total[1] += k2
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  qwen2-7b leg: {time.monotonic() - t:.1f} s")

    # (c) Llama-3-8B in int8, phase 4's weights and requests.
    t = time.monotonic()
    icfg = replace(llama_cfg, model=replace(llama_cfg.model, quant="int8"))
    k1, k2, dense, hits = variant_leg(
        engine_mod, llama, attention, "llama3-8b int8", icfg, llama_params,
        (prompts, shared, sampled_prompt, None), kernels, card, shared[0])
    assert hits >= 2 and dense == 0
    total[0] += k1
    total[1] += k2
    b = bench_twin_int8(llama_params, card)
    log(f"  int8 against bf16 at Llama-3-8B: {b['value']:.1f} against phase "
        f"4e's {bench_bf16:.1f} tok/s, {b['value'] / bench_bf16:.3f}x")
    log(f"  llama3-8b int8 leg: {time.monotonic() - t:.1f} s")
    return total


def engine_config_4j(mcfg, num_pages, max_seq_len):
    """Phase 4j's engine shape for model ``mcfg``: batch 8, page 16, hash
    block 128, horizon 8, whole installs, seed 0."""
    from xllm_service_tpu_torch.engine import EngineConfig

    return EngineConfig(model=mcfg, model_family=mcfg.name,
                        num_pages=num_pages, page_size=16,
                        hash_block_size=128, max_batch_size=8,
                        max_seq_len=max_seq_len, decode_horizon=8,
                        admission_horizon=8, seed=0)


# --------------------------------------------------------------- phase 4k
# Llama-3's published pre-tokenizer split pattern.
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
K_DEPTH = 4          # phase 4k (b): layers of Qwen2-7B and Gemma-2-9B
# Phase 4k (a): layers of phase 4's Llama-3-8B in the checkpoint. The
# directory is written to and read back from the disk three times over;
# at all 32 layers it held 16.06 GB.
K_LLAMA_DEPTH = 8
K_PROBE_NEW = 16     # phase 4k (b): greedy tokens per rollout


def llama3_specials() -> dict[int, str]:
    """Llama-3's 256 special tokens at their published ids."""
    names = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
             128006: "<|start_header_id|>", 128007: "<|end_header_id|>",
             128009: "<|eot_id|>"}
    reserved = iter(range(251))
    return {i: names.get(i) or f"<|reserved_special_token_{next(reserved)}|>"
            for i in range(128000, 128256)}


def llama3_tokenizer_files(d, seed, n_ranks=128000) -> None:
    """A ``tokenizer.json`` of Llama-3's shape in ``d``: a byte-level BPE
    with ``ignore_merges`` under Llama-3's split pattern, ``n_ranks`` ranks
    drawn from ``seed`` (the 256 bytes, then each token the merge of two
    lower-ranked ones, drawn toward the low ranks), the 256 special tokens
    after them; and a ``tokenizer_config.json`` whose eos is
    ``<|eot_id|>``."""
    from xllm_service_tpu_torch.tokenizer.hf_json import BYTE_TO_CHAR

    rng = np.random.default_rng(seed)
    toks = [BYTE_TO_CHAR[b] for b in range(256)]
    vocab = {t: i for i, t in enumerate(toks)}
    merges = []
    while len(toks) < n_ranks:
        u = rng.random((2, 4096)) ** 3
        for a_u, b_u in zip(*u):
            r = len(toks)
            if r == n_ranks:
                break
            a, b = toks[int(a_u * r)], toks[int(b_u * r)]
            if a + b in vocab:
                continue
            vocab[a + b] = r
            toks.append(a + b)
            merges.append([a, b])
    specials = llama3_specials() if n_ranks == 128000 else {
        n_ranks + i: s for i, s in enumerate(
            ("<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"))}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": s, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, s in sorted(specials.items())],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "ByteLevel", "add_prefix_space": True,
                           "trim_offsets": False, "use_regex": True},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges}}
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
                   "added_tokens_decoder": {
                       str(i): {"content": s, "special": True}
                       for i, s in specials.items()}}, f)


def hf_config_json(mcfg, model_type) -> dict:
    """The ``config.json`` that publishes ``mcfg`` (HF's field names)."""
    out = {"model_type": model_type,
           "architectures": [{"llama": "LlamaForCausalLM",
                              "qwen2": "Qwen2ForCausalLM",
                              "gemma2": "Gemma2ForCausalLM"}[model_type]],
           "vocab_size": mcfg.vocab_size, "hidden_size": mcfg.hidden_size,
           "num_hidden_layers": mcfg.num_layers,
           "num_attention_heads": mcfg.num_heads,
           "num_key_value_heads": mcfg.num_kv_heads,
           "head_dim": mcfg.head_dim, "intermediate_size": mcfg.ffn_size,
           "rope_theta": mcfg.rope_theta, "rms_norm_eps": mcfg.rms_eps,
           "max_position_embeddings": mcfg.max_context_len,
           "tie_word_embeddings": mcfg.tie_embeddings,
           "torch_dtype": "bfloat16"}
    if model_type == "gemma2":
        out.update(hidden_activation="gelu_pytorch_tanh",
                   query_pre_attn_scalar=mcfg.query_pre_attn_scalar,
                   attn_logit_softcapping=mcfg.attn_logit_softcap,
                   final_logit_softcapping=mcfg.final_logit_softcap,
                   sliding_window=mcfg.sliding_window)
    return out


def tree_leaf(params, path):
    node = params
    for part in path.split("/"):
        node = node[part]
    return node


def hf_tensors(params, mcfg) -> list:
    """(HF name, tensor view) of every leaf of ``params`` in an HF
    checkpoint's order (the embedding, the layers, the final norm, the
    head), each layer's projection transposed to HF's ``[out, in]`` (the
    port's loader maps, inverted)."""
    from xllm_service_tpu_torch.models import loader

    top = {name: where for name, where in loader._HF_TOP_MAP.items()}
    out = []

    def add(name, path, layer, transpose):
        try:
            leaf = tree_leaf(params, path)
        except KeyError:
            return                       # a tied head, no biases, ...
        t = leaf if layer is None else leaf[layer]
        out.append((name, t.t() if transpose else t))

    path, transpose = top["model.embed_tokens.weight"]
    add("model.embed_tokens.weight", path, None, transpose)
    for layer in range(mcfg.num_layers):
        for leaf, (path, transpose) in loader._HF_LAYER_MAP.items():
            add(f"model.layers.{layer}.{leaf}", "layers/" + path, layer,
                transpose)
    for name in ("model.norm.weight", "lm_head.weight"):
        path, transpose = top[name]
        add(name, path, None, transpose)
    return out


def write_hf_dir(d, params, mcfg, model_type, n_shards) -> int:
    """``params`` as an HF model directory in ``d`` through the port's
    writer: bf16 tensors under HF names in ``n_shards`` shards named as the
    published ones, ``model.safetensors.index.json`` and ``config.json``.
    Returns the bytes of the shards."""
    from xllm_service_tpu_torch.models.safetensors_io import save_file

    os.makedirs(d, exist_ok=True)
    tensors = hf_tensors(params, mcfg)
    total = sum(t.numel() * t.element_size() for _, t in tensors)
    shards, acc = [[] for _ in range(n_shards)], 0
    for name, t in tensors:
        shards[min(n_shards - 1, acc * n_shards // total)].append((name, t))
        acc += t.numel() * t.element_size()
    weight_map = {}
    for k, part in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{n_shards:05d}.safetensors"
        save_file(dict(part), os.path.join(d, fname),
                  metadata={"format": "pt"})
        weight_map.update({name: fname for name, _ in part})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_config_json(mcfg, model_type), f)
    return total


def assert_trees_bit_equal(got, want, what):
    """Every leaf of ``got`` equal to ``want``'s bit for bit, same keys."""
    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w), f"{what}: leaves {sorted(set(g) ^ set(w))}"
    for path, t in w.items():
        bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
            t.element_size()]
        assert g[path].dtype == t.dtype and g[path].shape == t.shape and \
            torch.equal(g[path].view(bits), t.view(bits)), f"{what}: {path}"
    return len(w)


def rollout(llama, mcfg, params, prompt, prefix):
    """``prompt`` installed in two prefills, its first ``prefix`` tokens
    cold and the rest behind them (kernel 2 where the family's prefill
    takes it), then K_PROBE_NEW greedy decode steps (kernel 1). Returns
    (the tokens, the last step's logits)."""
    n = len(prompt) + K_PROBE_NEW
    n_pages = -(-n // PS)
    dev = params["final_norm"]["scale"].device
    i32 = dict(dtype=torch.int32, device=dev)
    kv = torch.zeros((mcfg.num_layers, 2, n_pages + 1, mcfg.num_kv_heads, PS,
                      mcfg.head_dim), dtype=mcfg.dtype, device=dev)
    pt = torch.arange(1, n_pages + 1, **i32)[None]
    toks = torch.tensor([prompt], **i32)
    for lo, hi in ((0, prefix), (prefix, len(prompt))):
        logits = llama.prefill_forward(
            params, mcfg, toks[:, lo:hi], torch.arange(lo, hi, **i32)[None],
            kv, pt, torch.tensor([lo], **i32), torch.tensor([hi - lo], **i32),
            has_prefix=lo > 0)[0]
    out = []
    for _ in range(K_PROBE_NEW):
        out.append(int(logits[0].argmax()))
        pos = len(prompt) + len(out) - 1
        logits = llama.decode_forward(
            params, mcfg, torch.tensor([out[-1]], **i32),
            torch.tensor([pos], **i32), kv, pt,
            torch.tensor([pos + 1], **i32))[0]
    return out, logits.float().cpu()


def checkpoint_agent_child(argv) -> int:
    """``python3 chip_smoke.py --checkpoint-agent ARGS...``: phase 4k's
    agent, started in this process through the agent's own entry point
    (``engine/agent.py::main`` with ARGS), with probes driven by lines on
    standard input, each answered by one line ``REPORT {...}`` on standard
    output: ``begin`` puts a ``StepClock`` on its engine and a
    ``CallClock`` on its tokenizer's ``decode``, and records what its
    tokenizer encodes (``{}``); ``report`` gives this process's kernel
    launch counts, the load's seconds, the encoded texts with their ids
    and, the first time after a ``begin``, the split and the decode clock.
    End of input stops the agent (SIGTERM: its drain)."""
    import logging
    import signal

    from xllm_service_tpu_torch.engine import agent as agent_mod
    from xllm_service_tpu_torch.ops.mq_paged_attention import (
        mq_paged_attention,
    )
    from xllm_service_tpu_torch.ops.paged_attention import paged_attention

    built, state = [], {}
    build, load = agent_mod.build_agent, agent_mod.checkpoint_params

    def probed_build(args, coord=None):
        built.append(build(args, coord))
        return built[-1]

    def timed_load(*args, **kw):
        t = time.perf_counter()
        params = load(*args, **kw)
        torch.cuda.synchronize()
        state["load_s"] = time.perf_counter() - t
        return params

    agent_mod.build_agent = probed_build
    agent_mod.checkpoint_params = timed_load

    def commands():
        for line in sys.stdin:
            eng = built[0].engine
            if line.strip() == "begin":
                tok = eng.tokenizer
                state["decode"] = tok.decode = CallClock(tok.decode)
                encodes = state["encodes"] = {}
                encode = tok.encode

                def recording_encode(text):
                    ids = encode(text)
                    encodes[text] = ids
                    return ids

                tok.encode = recording_encode
                state["clock"] = StepClock(eng)
                state["clock"].begin()
                print("REPORT {}", flush=True)
                continue
            rec = {"launches": {
                "paged_attention": paged_attention.launches,
                "mq_paged_attention": mq_paged_attention.launches},
                "load_s": state.get("load_s"),
                "tokenizer": type(eng.tokenizer).__name__,
                "encodes": state.get("encodes", {})}
            if "clock" in state:
                d = state["decode"]
                rec.update(split=state.pop("clock").end(),
                           decode=[d.n, d.wall * 1e3, d.cpu * 1e3])
            print("REPORT " + json.dumps(rec), flush=True)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=commands, daemon=True).start()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)"
                        ".1s %(name)s: %(message)s")
    agent_mod.main(argv)
    return 0


def sample_text(seed, n_chars) -> str:
    """Text to tokenize: words of Latin, accented, Cyrillic and CJK letters,
    numbers and punctuation, with runs of spaces and newlines."""
    rng = np.random.default_rng(seed)
    alphabets = ["etaoinshrdlucmfwypvbgkqjxz", "àéîõüçñß", "привет", "世界中文",
                 "0123456789", ".,;:!?'\"()-"]
    p = np.asarray([80, 3, 4, 2, 6, 5], float)
    p /= p.sum()
    parts, n = [], 0
    while n < n_chars:
        a = alphabets[rng.choice(len(alphabets), p=p)]
        w = "".join(rng.choice(list(a), size=int(rng.integers(1, 9))))
        sep = " " if rng.random() < 0.93 else rng.choice(["\n", "\n\n", "  "])
        parts.append(w + sep)
        n += len(parts[-1])
    return "".join(parts)[:n_chars]


def checkpoint_phase(engine_mod, llama, cfg, params, prompts, shared,
                     sampled_prompt, split_4f, kernels, card):
    """Phase 4k: checkpoint loading. (a) Phase 4's Llama-3-8B weights at
    full width, cut to their first K_LLAMA_DEPTH layers (``depth_view``),
    written as an HF model directory (four bf16 shards with their index,
    ``config.json``, a Llama-3-shaped ``tokenizer.json``), loaded in this
    process (every leaf bit for bit, and in int8 against ``quantize_tree``),
    then served by the agent in a second process from its command line
    (``--model-config hf --checkpoint-path D --tokenizer-path D``) behind
    the stub master: after a warm pass on other prompts, phase 4's requests
    give the tokens of an engine here on the same cut tree (run, with the
    in-process loads, while the agent starts), two text requests are
    tokenised as here, kernels 1 and 2 launch there. (b) Qwen2-7B and
    Gemma-2-9B at full width and K_DEPTH layers: written, loaded bit for
    bit, and one rollout's tokens and logits equal to the tree in memory's.
    ``split_4f`` = phase 4f's host split (the byte tokenizer). Returns the
    launches of kernels 1 and 2 in this phase (both processes)."""
    import dataclasses
    import shutil
    import subprocess
    import tempfile
    import types

    from xllm_service_tpu_torch.common.net import pick_free_port
    from xllm_service_tpu_torch.common.types import InstanceMetaInfo
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from xllm_service_tpu_torch.models import hf_config
    from xllm_service_tpu_torch.models.gemma import gemma2_9b_config
    from xllm_service_tpu_torch.models.quant import quantize_tree
    from xllm_service_tpu_torch.models.qwen2 import qwen2_7b_config
    from xllm_service_tpu_torch.rpc import MASTER_KEY, instance_key
    from xllm_service_tpu_torch.tokenizer import HFTokenizer

    paged_attention, mq_paged_attention = kernels
    cfg, params = depth_view(cfg, params, K_LLAMA_DEPTH)
    mcfg = cfg.model
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="phase4k-")
    total = [0, 0]
    try:
        free = shutil.disk_usage(root).free
        log(f"  scratch {root}: {free / 1e9:.1f} GB free")
        d = os.path.join(root, "llama3_8b")
        t = time.monotonic()
        nbytes = write_hf_dir(d, params, mcfg, "llama", 4)
        write_s = time.monotonic() - t
        t = time.monotonic()
        llama3_tokenizer_files(d, seed=0)
        tok_s = time.monotonic() - t
        log(f"  wrote {nbytes / 1e9:.2f} GB of bf16 shards in {write_s:.1f} s "
            f"({nbytes / 1e9 / write_s:.2f} GB/s, the card to the disk) and "
            f"a tokenizer of 128256 tokens in {tok_s:.1f} s; files "
            f"{sorted(os.listdir(d))} ({card})")
        assert hf_config.model_config_from_hf(d) == mcfg, "config.json"

        # Served through the agent's command line in a second process.
        store = MemoryStore()
        coord = CoordServer(store)
        master = StubMaster()
        InMemoryCoordination(store).set(MASTER_KEY, master.addr)
        name = f"127.0.0.1:{pick_free_port('127.0.0.1')}"
        os.makedirs(os.path.join(here, "build"), exist_ok=True)
        log_path = os.path.join(here, "build", "phase4k_agent.log")
        t_spawn = time.monotonic()
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--checkpoint-agent",
             "--model-config", "hf", "--model-id", "llama3-8b",
             "--checkpoint-path", d, "--tokenizer-path", d,
             "--coordination-addr", coord.addr,
             "--port", name.rpartition(":")[2],
             "--num-pages", str(cfg.num_pages),
             "--page-size", str(cfg.page_size),
             "--max-batch-size", str(cfg.max_batch_size),
             "--max-seq-len", str(cfg.max_seq_len),
             "--decode-horizon", str(cfg.decode_horizon)],
            cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, stderr=open(log_path, "w"))

        def child_log():
            with open(log_path) as f:
                return "".join(f.readlines()[-30:])

        def command(cmd):
            child.stdin.write(cmd + "\n")
            child.stdin.flush()
            while True:
                line = child.stdout.readline()
                assert line, f"the agent exited:\n{child_log()}"
                if line.startswith("REPORT "):
                    return json.loads(line[7:])

        post = None
        try:
            # While the agent starts: the tokens of an engine here on the
            # same tree, the in-process loads and the tokenizer.
            want, *_ = serve_once(engine_mod, cfg, params, prompts, shared,
                                  sampled_prompt)
            # In-process loads: bf16 bit for bit, then int8.
            torch.cuda.synchronize()
            t = time.perf_counter()
            loaded = hf_config.load_checkpoint(d, mcfg, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            n = assert_trees_bit_equal(loaded, params, "llama3-8b")
            del loaded
            t = time.perf_counter()
            q8 = hf_config.load_checkpoint(
                d, dataclasses.replace(mcfg, quant="int8"), device="cuda")
            torch.cuda.synchronize()
            q8_s = time.perf_counter() - t
            n8 = assert_trees_bit_equal(q8, quantize_tree(params),
                                        "llama3-8b int8")
            del q8
            gc.collect()
            torch.cuda.empty_cache()
            log(f"  in-process load: {n} leaves bit-identical to phase 4's "
                f"in {load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} GB/s, "
                "shards just written: the page cache; the agent starting "
                f"beside it); int8: {n8} leaves bit-identical to "
                f"quantize_tree of phase 4's in {q8_s:.2f} s ({card})")

            # The tokenizer: the parent's copy, and its encode rate.
            t = time.perf_counter()
            tok = HFTokenizer(os.path.join(d, "tokenizer.json"))
            build_s = time.perf_counter() - t
            text = sample_text(1, 1 << 20)
            t = time.perf_counter()
            ids = tok.encode(text)
            enc_s = time.perf_counter() - t
            log(f"  tokenizer: built in {build_s:.2f} s; encode of "
                f"{len(text.encode()) / 1e6:.2f} MB: {enc_s:.2f} s, "
                f"{len(text.encode()) / 1e6 / enc_s:.3f} MB/s, "
                f"{len(ids) / enc_s:.0f} tokens/s ({len(ids)} tokens; the "
                f"host's CPU, the agent starting beside it)")
            assert tok.decode(tok.encode("Hello world, ¡hola!")) == \
                "Hello world, ¡hola!"

            key = instance_key("MIX", name)
            deadline = time.monotonic() + 600
            while store.get(key) is None:
                assert child.poll() is None and time.monotonic() < deadline, \
                    f"the agent did not register:\n{child_log()}"
                time.sleep(0.25)
            reg_s = time.monotonic() - t_spawn
            before = command("report")
            log(f"  agent {name} (pid {child.pid}) registered {reg_s:.1f} s "
                f"after its start; its load {before['load_s']:.2f} s "
                f"({nbytes / 1e9 / before['load_s']:.2f} GB/s), tokenizer "
                f"{before['tokenizer']} ({card})")
            assert before["tokenizer"] == "HFTokenizer"
            post = Poster(name)
            greedy = dict(max_tokens=64, temperature=0.0, ignore_eos=True)
            samp = dict(max_tokens=64, temperature=0.8, top_p=0.9, seed=1234,
                        ignore_eos=True)

            def dispatch(sid, toks=None, **sp):
                body = dict(service_request_id=sid, request_id=sid,
                            source_service_addr=master.addr, **sp)
                if toks is not None:
                    body["token_ids"] = toks
                status, reply = post("/v1/completions", body)
                assert status == 200, reply

            # A warm pass: phase 4's shapes on other prompts, so that the
            # measured window finds the process warm (first prefills,
            # captures, library handles), as phase 4f's did, and the
            # engine's prefix cache holds nothing of phase 4's prompts.
            warm = np.random.default_rng(99)
            for i, p in enumerate(prompts + [sampled_prompt]):
                dispatch(f"warm{i}", warm.integers(
                    3, mcfg.vocab_size, size=len(p)).tolist(),
                    **(samp if i == len(prompts) else greedy))
            master.wait(lambda: all(master.finished(f"warm{i}")
                                    for i in range(len(prompts) + 1)),
                        "the warm pass", timeout=600)
            mid = command("report")
            command("begin")
            for i, p in enumerate(prompts):
                dispatch(f"g{i}", p, **greedy)
            dispatch("sampled", sampled_prompt, **samp)
            master.wait(lambda: "g0" in master.first,
                        "request 0's first delta")
            for j, p in enumerate(shared):
                dispatch(f"s{j}", p, **greedy)
            names = [f"g{i}" for i in range(len(prompts))] + ["sampled"] + \
                [f"s{j}" for j in range(len(shared))]
            master.wait(lambda: all(map(master.finished, names)),
                        "phase 4's requests", timeout=600)
            after = command("report")
            texts = ["The capital of France is Paris, and " * 12,
                     sample_text(2, 1500)]
            for i, text in enumerate(texts):
                dispatch(f"text{i}", prompt=text, max_tokens=48,
                         temperature=0.0, ignore_eos=True)
            master.wait(lambda: all(master.finished(f"text{i}")
                                    for i in range(len(texts))),
                        "the text requests", timeout=300)
            last = command("report")
            dec = types.SimpleNamespace(
                name=name, incarnation_id=InstanceMetaInfo.from_json(
                    store.get(key)).incarnation_id)
            got = {n_: check_deltas(n_, master.gens[n_], dec)[0]
                   for n_ in names}
            same = [n_ for n_ in names if got[n_] == want[n_]]
            log(f"  phase 4's {len(names)} requests through the checkpoint "
                f"agent: {len(same)}/{len(names)} with the tokens of an "
                f"engine here on the same {K_LLAMA_DEPTH} layers")
            assert len(same) == len(names), \
                f"tokens differ from the engine's here: " \
                f"{sorted(set(names) - set(same))}"
            for i, text in enumerate(texts):
                gens = master.gens[f"text{i}"]
                out_ids = check_deltas(f"text{i}", gens, dec)[0]
                streamed = "".join(o["text"] for g in gens
                                   for o in g["outputs"])
                assert last["encodes"][text] == tok.encode(text), \
                    f"text{i}: the agent tokenised it otherwise"
                assert streamed == tok.decode(out_ids), \
                    f"text{i}: streamed text {streamed!r} is not the decode"
                log(f"  text{i}: {len(text)} chars -> "
                    f"{len(last['encodes'][text])} tokens as here; "
                    f"{len(out_ids)} tokens streamed, their text the decode "
                    f"of their ids ({len(streamed)} chars)")
            k1 = after["launches"]["paged_attention"] - \
                mid["launches"]["paged_attention"]
            k2 = after["launches"]["mq_paged_attention"] - \
                mid["launches"]["mq_paged_attention"]
            log(f"  launches in the agent over phase 4's requests: kernel 1 "
                f"{k1}, kernel 2 {k2}")
            assert k1 > 0 and k2 > 0, "kernels 1 and 2 in the agent"
            total[0] += last["launches"]["paged_attention"] - \
                before["launches"]["paged_attention"]
            total[1] += last["launches"]["mq_paged_attention"] - \
                before["launches"]["mq_paged_attention"]
            split, (n_dec, dec_wall, dec_cpu) = after["split"], after["decode"]
            log(f"  host split, phase 4's traffic through the checkpoint "
                f"agent (its tokenizer), after a warm pass: "
                f"{StepClock.line(split)}")
            log(f"  same split, phase 4f (the byte tokenizer): "
                f"{StepClock.line(split_4f)}")
            log(f"  the detokeniser in the agent: {n_dec} decode calls, "
                f"{dec_wall:.1f} ms wall, {dec_cpu:.1f} ms CPU: "
                f"{dec_cpu / split['engine_cpu_ms']:.3f} of the engine "
                f"thread's CPU, {dec_wall / split['wall_ms']:.3f} of the "
                f"window's wall (information only; {card})")
        finally:
            if post is not None:
                post.close()
            child.stdin.close()
            try:
                child.wait(timeout=120)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
            master.close()
            coord.close()
            store.close()
        shutil.rmtree(d)

        # (b) Qwen2-7B and Gemma-2-9B at full width, K_DEPTH layers.
        rng = np.random.default_rng(13)
        for name, make, model_type, seed in (
                ("qwen2-7b", qwen2_7b_config, "qwen2", 3),
                ("gemma2-9b", gemma2_9b_config, "gemma2", 1)):
            t = time.monotonic()
            vcfg = dataclasses.replace(make(), num_layers=K_DEPTH)
            vparams = llama.init_params(
                vcfg, torch.Generator(device="cuda").manual_seed(seed),
                "cuda")
            draw_norms_and_biases(vparams, seed + 1)
            vd = os.path.join(root, name)
            vbytes = write_hf_dir(vd, vparams, vcfg, model_type, 2)
            assert hf_config.model_config_from_hf(vd) == vcfg, \
                f"{name}: config.json"
            reset_counts()
            t_ = time.perf_counter()
            loaded = hf_config.load_checkpoint(vd, vcfg, device="cuda")
            torch.cuda.synchronize()
            vload_s = time.perf_counter() - t_
            n = assert_trees_bit_equal(loaded, vparams, name)
            prompt = rng.integers(3, vcfg.vocab_size, size=700).tolist()
            got = rollout(llama, vcfg, loaded, prompt, 512)
            ref = rollout(llama, vcfg, vparams, prompt, 512)
            k1, k2 = paged_attention.launches, mq_paged_attention.launches
            assert got[0] == ref[0], f"{name}: greedy tokens differ"
            assert torch.equal(got[1], ref[1]), f"{name}: logits differ"
            assert torch.isfinite(got[1]).all()
            log(f"  {name} ({K_DEPTH} of {make().num_layers} layers, full "
                f"width, {vbytes / 1e9:.2f} GB, "
                f"{'tied, no lm_head' if vcfg.tie_embeddings else 'untied'}"
                f"): {n} leaves bit-identical, loaded in {vload_s:.2f} s; "
                f"{K_PROBE_NEW} greedy tokens and the last logits equal to "
                f"the tree in memory's (max|logit| "
                f"{got[1].abs().max().item():.4g}); kernel 1 {k1}, kernel 2 "
                f"{k2} launches over both rollouts; "
                f"{time.monotonic() - t:.1f} s")
            assert k1 > 0, f"{name}: kernel 1"
            if model_type == "qwen2":
                assert k2 > 0, "qwen2-7b: the prefix prefill skipped kernel 2"
            total[0] += k1
            total[1] += k2
            del loaded, vparams
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(vd)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


# --------------------------------------------------------------- phase 4l
# The reference agent's /metrics families with their types (its
# ``_h_metrics``), less the KV-tier, stream-link and PD-peer rows, which a
# run without tiers and links does not render.
METRIC_FAMILIES = {
    "engine_waiting_requests": "gauge", "engine_running_requests": "gauge",
    "engine_kv_usage_perc": "gauge", "engine_cached_prefix_blocks": "gauge",
    "engine_generated_tokens_total": "counter",
    "engine_preemptions_total": "counter",
    "engine_recent_max_ttft_milliseconds": "gauge",
    "engine_recent_max_tbt_milliseconds": "gauge",
    "engine_dp_size": "gauge", "engine_sarathi_rides_total": "counter",
    "engine_telemetry_session_hosts": "gauge",
    "engine_telemetry_connections_created": "counter",
    "engine_telemetry_mux_sends_total": "counter",
    "engine_telemetry_direct_sends_total": "counter",
    "engine_ttft_span_p50_milliseconds": "gauge",
    "engine_heartbeats_total": "counter",
}
RESOLVER_WINDOW_S = 2.0   # the agent's owner cache (TelemetryOwnerResolver)


def rendezvous_owner(members, name):
    """The telemetry owner of instance ``name`` over ``members``, computed
    here from the shard map's definition: the highest blake2b-8 score of
    ``<member>|hb|<name>`` (big-endian), the first on a tie."""
    import hashlib

    best, best_score = "", -1
    for m in members:
        score = int.from_bytes(hashlib.blake2b(
            f"{m}|hb|{name}".encode(), digest_size=8).digest(), "big")
        if score > best_score:
            best, best_score = m, score
    return best


def http_text(addr, path):
    """GET ``path``: (status, body text, content type)."""
    import http.client

    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode(), r.getheader("Content-Type", "")
    finally:
        conn.close()


def thread_cpu_s(thread) -> float:
    return time.clock_gettime(time.pthread_getcpuclockid(thread.ident))


def dp_mux_phase(cfg, params, llama, prompts, shared, sampled_prompt, want,
                 tps_4f, kernels, card):
    """Phase 4l: the agent at the reference's defaults on the card. One
    agent with ``dp_size`` 2 (both replicas on this card, sharing the
    weights) in the mux telemetry mode behind two stub masters A and B
    (both under ``XLLM:SERVICE:<addr>``, A also the elected master). Phase
    4's eleven requests go in as msgpack dispatches with trace contexts,
    their deltas destined for A and B in turn. Returns the launches of
    kernels 1 and 2 in this phase."""
    import uuid

    from xllm_service_tpu_torch.common.types import InstanceMetaInfo
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.profiling.sampler import (
        PROFILER,
        parse_folded,
    )
    from xllm_service_tpu_torch.rpc import (
        MASTER_KEY,
        SERVICE_KEY_PREFIX,
        instance_key,
    )

    paged_attention, mq_paged_attention = kernels
    hb_s = 1.0
    store = MemoryStore()
    stubs = {}
    for _ in range(2):
        stub = StubMaster(mux=True)
        stubs[stub.addr] = stub
    a, b = stubs.values()
    a.peer, b.peer = b, a
    coord = InMemoryCoordination(store)
    for addr in stubs:
        coord.set(SERVICE_KEY_PREFIX + addr, "{}")
    coord.set(MASTER_KEY, a.addr)
    agent = post = None
    try:
        agent = EngineAgent(cfg, AgentConfig(
            model_id="llama3-8b", heartbeat_interval_s=hb_s, dp_size=2,
            telemetry_mode="mux"), coord=InMemoryCoordination(store),
            params=params, device="cuda")
        owner = stubs[rendezvous_owner(list(stubs), agent.name)]
        other = b if owner is a else a
        e0, e1 = agent.engines
        assert e1.params["embed"]["embedding"] is \
            e0.params["embed"]["embedding"], "replica 1 copied the weights"
        log(f"  {agent.name}: replicas on {e0.device} and {e1.device}, the "
            f"weights shared ({torch.cuda.memory_allocated() / 2**30:.1f} "
            f"GiB allocated with both pools); telemetry owner "
            f"{owner.addr} ({'A' if owner is a else 'B'}) of A {a.addr}, B "
            f"{b.addr}")
        # Which replica each request lands on, and the depths the dispatch
        # saw.
        served: dict[str, int] = {}
        for i, eng in enumerate(agent.engines):
            def probed_submit(req, i=i, submit=eng.submit):
                served.setdefault(req.service_request_id, i)
                submit(req)
            eng.submit = probed_submit
        picks: list = []
        pick = agent._pick_engine

        def probed_pick(token_ids):
            depths = [sum(e.stats()[k] for k in ("waiting", "running"))
                      for e in agent.engines]
            eng = pick(token_ids)
            picks.append((token_ids, depths, agent.engines.index(eng)))
            return eng

        agent._pick_engine = probed_pick
        reset_counts()
        agent.start()
        meta = InstanceMetaInfo.from_json(
            store.get(instance_key("MIX", agent.name)))
        assert meta.dp_size == 2 and meta.wire_formats == \
            ["msgpack", "json"], meta
        sampler = PROFILER._thread
        post = Poster(agent.name, packed=True)
        greedy = dict(max_tokens=64, temperature=0.0, ignore_eos=True)
        samp = dict(max_tokens=64, temperature=0.8, top_p=0.9, seed=1234,
                    ignore_eos=True)
        ctxs: dict[str, dict] = {}
        dests: dict[str, StubMaster] = {}

        def dispatch(sid, toks, dest, **sp):
            ctxs[sid] = {"trace_id": uuid.uuid4().hex,
                         "span_id": uuid.uuid4().hex[:16]}
            dests[sid] = dest
            status, reply = post("/v1/completions", dict(
                service_request_id=sid, request_id=sid, token_ids=toks,
                source_service_addr=dest.addr, trace_context=ctxs[sid],
                **sp))
            assert status == 200, reply

        def finished(sid):
            return dests[sid].finished(sid)

        def wait_all(sids, what, timeout=600.0):
            deadline = time.monotonic() + timeout
            while not all(map(finished, sids)):
                assert time.monotonic() < deadline, f"timed out: {what}"
                time.sleep(0.01)

        names = [f"g{i}" for i in range(len(prompts))] + ["sampled"] + \
            [f"s{j}" for j in range(len(shared))]
        order = [a, b]
        t0 = time.monotonic()
        cpu0 = thread_cpu_s(sampler)
        for i, p in enumerate(prompts):
            dispatch(f"g{i}", p, order[i % 2], **greedy)
        dispatch("sampled", sampled_prompt, order[len(prompts) % 2], **samp)
        deadline = time.monotonic() + 600
        while "g0" not in dests["g0"].first:
            assert time.monotonic() < deadline, "request 0's first delta"
            time.sleep(0.005)
        for j, p in enumerate(shared):
            dispatch(f"s{j}", p, order[j % 2], **greedy)
        wait_all(names, "phase 4's requests through the two replicas")
        wall = time.monotonic() - t0
        sampler_share = (thread_cpu_s(sampler) - cpu0) / wall
        toks = {n: check_deltas(n, dests[n].gens[n], agent)[0]
                for n in names}
        same = [n for n in names if toks[n] == want[n]]
        log(f"  phase 4's 11 requests as msgpack dispatches through the two "
            f"replicas: {len(same)}/{len(names)} with phase 4's tokens")
        if len(same) != len(names):
            # Where they part, and whether at a near-tie (information for
            # the failure below).
            ctx = {f"g{i}": p for i, p in enumerate(prompts)}
            ctx.update({f"s{j}": p for j, p in enumerate(shared)})
            try:
                compare_streams(llama, cfg, params, ctx,
                                {n: toks[n] for n in ctx},
                                {n: want[n] for n in ctx}, "4l")
            except AssertionError as e:
                log(f"  4l: {e}")
        assert len(same) == len(names), \
            f"tokens differ from phase 4's: {sorted(set(names) - set(same))}"
        tps = sum(map(len, toks.values())) / wall

        # Placement: the replica hash(tuple(ids[:block])) % 2 names, unless
        # the load guard spilled the request.
        block, B = cfg.hash_block_size, cfg.max_batch_size
        spilled = []
        for ids, depths, chosen in picks:
            affine = hash(tuple(ids[:block])) % 2
            if chosen != affine:
                assert depths[affine] > min(depths) + B, \
                    f"a spill without the guard: depths {depths}"
                spilled.append(depths)
        placed = {n: served[n] for n in names}
        hit = agent.engines[placed["s0"]].stats()
        assert placed["s0"] == placed["s1"] == placed["g0"] or spilled, \
            placed
        assert hit["prefix_hits"] >= 2 and \
            hit["prefix_hit_tokens"] >= 2 * 512, hit
        launches = (paged_attention.launches, mq_paged_attention.launches)
        assert launches[0] > 0 and launches[1] > 0, launches
        for i, eng in enumerate(agent.engines):
            check_replays(eng.stats(), f"4l replica {i}")
            assert any(fn is paged_attention and n > 0
                       for _, deltas in eng._graphs._graphs.values()
                       for fn, n in deltas), f"replica {i}: no kernel 1"
        log(f"  placement {placed} (replica 0 {sum(v == 0 for v in placed.values())}, "
            f"replica 1 {sum(v == 1 for v in placed.values())}), "
            f"{len(spilled)} spilled by the load guard; the shared-prefix "
            f"requests hit replica {placed['s0']}'s cache ({hit['prefix_hits']} "
            f"hits, {hit['prefix_hit_tokens']} tokens) through kernel 2; "
            f"launches decode/mq {launches}, kernel 1 in both replicas' "
            f"captured steps")

        # Telemetry: beats and pushes only to the owner; the other stub
        # gets its requests' deltas by the owner's relay.
        tel = agent.telemetry_stats()
        assert tel["mode"] == "mux" and tel["owner"] == owner.addr and \
            tel["direct_sends"] == 0 and tel["mux_sends"] > 0 and \
            tel["hosts"] == 1, tel
        assert not other.heartbeats and other.telemetry_posts == 0 and \
            other.direct_posts == 0 and other.relayed_in > 0, \
            (other.telemetry_posts, other.direct_posts, other.relayed_in)
        assert owner.heartbeats and owner.direct_posts == 0 and \
            owner.relayed_out == other.relayed_in
        log(f"  telemetry: {tel['mux_sends']} mux sends, "
            f"{tel['direct_sends']} direct; beats A {len(a.heartbeats)} B "
            f"{len(b.heartbeats)}; /rpc/telemetry POSTs owner "
            f"{owner.telemetry_posts} other {other.telemetry_posts}; "
            f"relayed to the other {other.relayed_in}; connections created "
            f"{tel['connections_created']} to {tel['hosts']} host")

        # The traces: each request's stage spans under its dispatched
        # context; the recent list holds them all.
        for n in names:
            status, body = http_get(agent.name,
                                    f"/admin/trace?request_id={n}")
            assert status == 200, body
            spans = {s_["point"]: s_ for s_ in body["spans"]}
            for point in ("engine.prefill", "engine.decode"):
                sp = spans[point]
                assert sp["trace_id"] == ctxs[n]["trace_id"] and \
                    sp["parent_span_id"] == ctxs[n]["span_id"] and \
                    sp["instance"] == agent.name and sp["end_ms"], sp
        status, recent = http_get(agent.name, "/admin/trace/recent?limit=64")
        listed = {r["trace_id"] for r in recent["traces"]}
        assert status == 200 and {c["trace_id"] for c in ctxs.values()} \
            <= listed, recent
        log(f"  traces: engine.prefill and engine.decode of all "
            f"{len(names)} requests under their dispatched trace ids, "
            f"parented on the carried spans; /admin/trace/recent lists "
            f"{len(listed)} traces")

        # The owner hint: the owner answers one beat naming the other
        # stub, which takes the next beat; then the beats come back.
        with owner.lock:
            owner.hint = other.addr
            n_other = len(other.heartbeats)
        owner.wait(lambda: owner.hinted_at is not None, "the hinted beat",
                   timeout=10)
        other.wait(lambda: len(other.heartbeats) > n_other,
                   "a beat at the hinted master", timeout=10)
        dt_hint = other.beat_times[n_other] - owner.hinted_at
        assert dt_hint <= hb_s + 0.5, dt_hint
        n_owner = len(owner.heartbeats)
        owner.wait(lambda: len(owner.heartbeats) > n_owner,
                   "the beats back at the owner",
                   timeout=RESOLVER_WINDOW_S + 2 * hb_s + 1)
        log(f"  owner hint adopted: the next beat went to the other stub "
            f"{dt_hint * 1e3:.0f} ms after the hinted reply; the beats were "
            f"back at the owner after the pin's window")

        # Owner death: three long requests whose deltas go to the other
        # stub (by the owner's relay); the owner stops mid-stream.
        rng = np.random.default_rng(4)
        longs = [f"long{i}" for i in range(3)]
        for sid in longs:
            dispatch(sid, rng.integers(3, cfg.model.vocab_size,
                                       size=96).tolist(), other,
                     max_tokens=384, temperature=0.0, ignore_eos=True)
        other.wait(lambda: all(len(other.gens.get(s_, ())) >= 2
                               for s_ in longs), "the long requests' deltas")
        n_beats, n_gens = len(other.beat_times), len(other.gens_times)
        owner.close()
        t_kill = time.monotonic()
        coord.rm(SERVICE_KEY_PREFIX + owner.addr)   # its lease lapses
        coord.set(MASTER_KEY, other.addr)
        other.wait(lambda: len(other.beat_times) > n_beats,
                   "a beat at the successor", timeout=30)
        other.wait(lambda: len(other.gens_times) > n_gens,
                   "pending deltas at the successor", timeout=30)
        dt_beat = other.beat_times[n_beats] - t_kill
        dt_gens = other.gens_times[n_gens] - t_kill
        assert dt_beat <= hb_s + RESOLVER_WINDOW_S and \
            dt_gens <= hb_s + RESOLVER_WINDOW_S, (dt_beat, dt_gens)
        wait_all(longs, "the long requests after the owner's death")
        long_toks = {s_: check_deltas(s_, other.gens[s_], agent)[0]
                     for s_ in longs}
        assert all(len(t_) == 384 for t_ in long_toks.values())
        tel2 = agent.telemetry_stats()
        assert tel2["owner"] == other.addr and tel2["direct_sends"] == 0
        log(f"  owner stopped mid-stream: the successor had the next beat "
            f"after {dt_beat * 1e3:.0f} ms and the pending deltas after "
            f"{dt_gens * 1e3:.0f} ms (bound {hb_s + RESOLVER_WINDOW_S:.1f} "
            f"s: one heartbeat interval plus one resolver window); all 3 "
            f"long requests finished with 384 tokens, delta_seq unbroken")

        # /metrics: Prometheus text with the reference's families.
        status, text, ctype = http_text(agent.name, "/metrics")
        assert status == 200 and ctype.startswith("text/plain"), ctype
        types = {}
        values = {}
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, fam, kind = line.split()
                types[fam] = kind
                continue
            name_, value = line.rsplit(" ", 1)
            assert re.fullmatch(r'[a-z0-9_]+(\{[a-z_]+="[^"]*"'
                                r'(,[a-z_]+="[^"]*")*\})?', name_), line
            values[name_] = float(value)
        assert types == METRIC_FAMILIES, sorted(set(types) ^
                                                set(METRIC_FAMILIES))
        usage = sum(g["usage"]["num_generated_tokens"]
                    for sid, st in dests.items()
                    for g in st.gens[sid] if g["finished"])
        assert values["engine_dp_size"] == 2 and \
            values["engine_generated_tokens_total"] == usage, \
            (values["engine_generated_tokens_total"], usage)
        log(f"  /metrics: {len(types)} families, the reference's; "
            f"engine_dp_size 2, engine_generated_tokens_total {usage:.0f} = "
            f"the summed usage")

        # The profiler: the engine loop's role, and the folded text parses.
        status, prof = http_get(agent.name, "/admin/profile")
        assert status == 200 and prof["roles"].get(
            "engine-pump", {}).get("samples", 0) > 0, sorted(prof["roles"])
        status, folded, _ = http_text(agent.name,
                                      "/admin/profile?format=folded")
        counts = parse_folded(folded)
        assert status == 200 and any(k[0] == "engine-pump" for k in counts), \
            sorted({k[0] for k in counts})
        log(f"  /admin/profile: {prof['samples']} samples over "
            f"{prof['ticks']} ticks, engine-pump "
            f"{prof['roles']['engine-pump']['samples']}, roles "
            f"{sorted(prof['roles'])}; the folded text parses back "
            f"({len(counts)} stacks)")
        log(f"  {tps:.1f} generated tok/s over phase 4's requests with two "
            f"replicas time-sharing the card, against {tps_4f:.1f} through "
            f"phase 4f's one; the sampler thread's CPU {sampler_share:.4f} "
            f"of the window's wall (information only; {card})")
        return paged_attention.launches, mq_paged_attention.launches
    finally:
        if post is not None:
            post.close()
        if agent is not None:
            agent.stop()
        for stub in stubs.values():
            stub.close()
        coord.close()
        store.close()
        del agent
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4m
# A routing near-tie: the k-th and (k+1)-th router logits of a token within
# ROUTE_EPS. Both sides compute the f32 router logits from the same bf16
# rows and f32 router in another summation order (about 1e-6 apart at
# logits of order 1), so only such a token may pick other experts.
ROUTE_EPS = 1e-3
# The largest share of a run's greedy tokens that may pass their
# recomputation only as routing near-ties (check_streams_recomputed).
ROUTED_SHARE = 0.2


def dequantized(kern):
    """A plain or int8 kernel as f32 (q8 * scale over the output dim)."""
    if isinstance(kern, dict):
        return kern["q8"].float() * kern["scale"][..., None, :]
    return kern.float()


def moe_layer_check(deepseek_moe, mixtral, card):
    """4m (a): one MoE layer at Mixtral-8x7B's width (hidden 4096, eight
    experts of 14336, top 2), 16 tokens, in bf16 and in int8: the dense
    dispatch (``_moe_mlp``) against an independent f32 loop (each token's
    top-2 experts, each expert's SwiGLU on the dequantized weights,
    weighted by the softmax of the two logits), held within 4x the error
    of the same loop in bf16 (the control) plus 1e-3 of max |ref|. A token
    whose 2nd and 3rd router logits lie within ROUTE_EPS is excused and
    counted. Times the layer (information). Returns {mode: ms}."""
    from dataclasses import replace

    one = replace(mixtral.mixtral_8x7b_config(), num_layers=1,
                  vocab_size=16)
    k = one.num_experts_per_token
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((16, one.hidden_size), generator=g, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    times = {}
    for mode in ("", "int8"):
        p = deepseek_moe.init_params(replace(one, quant=mode),
                                     torch.Generator(device="cuda")
                                     .manual_seed(22), "cuda")
        mp = deepseek_moe._at(p["moe"], 0)
        got = deepseek_moe._moe_mlp(mp, x, one).float()
        logits = x.float() @ mp["router"]["kernel"].float()
        top, idx = logits.sort(dim=-1, descending=True)
        ties = (top[:, k - 1] - top[:, k]) < ROUTE_EPS
        ex = mp["experts"]
        w = [dequantized(ex[n]["kernel"])
             for n in ("gate_proj", "up_proj", "down_proj")]
        ref = torch.zeros((16, one.hidden_size), device="cuda")
        ctl = torch.zeros_like(ref)
        for t in range(16):
            gates = torch.softmax(top[t, :k], dim=-1)
            for j in range(k):
                e = int(idx[t, j])
                for out, dt in ((ref, torch.float32), (ctl, torch.bfloat16)):
                    xt = x[t].to(dt)
                    wg, wu, wd = (m[e].to(dt) for m in w)
                    h = torch.nn.functional.silu(xt @ wg) * (xt @ wu)
                    out[t] += gates[j] * (h @ wd).float()
        keep = ~ties
        err = (got - ref).abs()[keep].max().item()
        ctl_err = (ctl - ref).abs()[keep].max().item()
        scale = ref.abs().max().item()
        ms = time_ms(lambda: deepseek_moe._moe_mlp(mp, x, one))
        times[mode or "bf16"] = ms
        log(f"  (a) MoE layer at mixtral-8x7b's width, 16 tokens, "
            f"{mode or 'bf16'}: dense dispatch vs the f32 loop max_abs_err "
            f"{err:.4g}; bf16 loop (control) {ctl_err:.4g}; max|ref| "
            f"{scale:.4g} (tol 4 x control + 1e-3 x max|ref|); routing "
            f"near-ties (within {ROUTE_EPS}) {int(ties.sum())} of 16; "
            f"{ms:.4f} ms a layer ({card})")
        assert int(keep.sum()) >= 12, "too many routing near-ties"
        assert err <= 4 * ctl_err + 1e-3 * scale, \
            f"MoE dispatch ({mode or 'bf16'}) off the f32 loop: {err}"
        del p, mp, ex, w
        gc.collect()
        torch.cuda.empty_cache()
    return times


MOE_AGENT_NEW = 32    # 4m (b): tokens a request through the agent


def mixtral_agent_leg(deepseek_moe, kernels, card):
    """4m (b): Mixtral-8x7B in weight-only int8, all 32 layers and eight
    experts, random weights drawn in their int8 form from the engine's
    seed, served by the port's agent built from its command line
    (``--model-config mixtral_8x7b --quant int8``) behind phase 4f's stub
    master: four greedy requests, then two sharing the first's 512-token
    prefix once it streams, MOE_AGENT_NEW tokens each. Checks the deltas,
    kernel 1 at 32 launches a replayed step, kernel 2 on the prefix hits,
    the captured step's replays, and every greedy token against its
    recomputation. Returns the
    launches of kernels 1 and 2, the engine's configuration and its int8
    weights (legs (f) and (i) serve on them)."""
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from xllm_service_tpu_torch.engine.agent import _parser, build_agent
    from xllm_service_tpu_torch.rpc import MASTER_KEY

    paged_attention, mq_paged_attention = kernels
    store = MemoryStore()
    master = StubMaster()
    InMemoryCoordination(store).set(MASTER_KEY, master.addr)
    args = _parser().parse_args([
        "--model-config", "mixtral_8x7b", "--quant", "int8",
        "--model-id", "mixtral-8x7b", "--num-pages", "1024",
        "--max-batch-size", "8", "--max-seq-len", "2048",
        "--decode-horizon", "8"])
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    agent = build_agent(args, coord=InMemoryCoordination(store))
    torch.cuda.synchronize()
    cfg = agent.engine.cfg
    m = cfg.model
    n_params = sum(t_.numel() for t_ in _tree_tensors(agent.engine.params))
    log(f"  (b) mixtral-8x7b int8: {m.num_layers} layers, {m.num_experts} "
        f"experts of {m.moe_ffn_size}, {m.num_heads}/{m.num_kv_heads} "
        f"heads: {n_params / 1e9:.2f} B weights built one layer of one "
        f"leaf at a time in {time.monotonic() - t:.1f} s (the agent's "
        f"engine); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(31)
    V = m.vocab_size
    lens = [640] + [int(n) for n in rng.integers(64, 769, size=3)]
    prompts = [rng.integers(3, V, size=n).tolist() for n in lens]
    shared = [prompts[0][:512] + rng.integers(3, V, size=int(n)).tolist()
              for n in rng.integers(32, 257, size=2)]
    greedy = dict(max_tokens=MOE_AGENT_NEW, temperature=0.0,
                  ignore_eos=True)
    sent_at, sent = {}, {}
    installs = spy_installs(agent.engine)
    reset_counts()
    agent.start()
    post = Poster(agent.name)
    try:
        def dispatch(sid, toks):
            sent_at[sid], sent[sid] = time.monotonic(), toks
            status, reply = post("/v1/completions", dict(
                service_request_id=sid, request_id=sid, token_ids=toks,
                source_service_addr=master.addr, **greedy))
            assert status == 200, (sid, status, reply)

        t0 = time.monotonic()
        for i, p in enumerate(prompts):
            dispatch(f"g{i}", p)
        master.wait(lambda: "g0" in master.first, "request 0's first delta")
        for j, p in enumerate(shared):
            dispatch(f"s{j}", p)
        names = list(sent)
        master.wait(lambda: all(map(master.finished, names)),
                    "mixtral's requests", timeout=600)
        wall = time.monotonic() - t0
        toks = {n: check_deltas(n, master.gens[n], agent)[0] for n in names}
        stats = agent.engine.stats()
        k1, k2 = paged_attention.launches, mq_paged_attention.launches
        graph = stats["decode_graph"]
        assert all(len(v) == MOE_AGENT_NEW for v in toks.values()), \
            "short streams"
        ttft = sorted((master.first[n] - sent_at[n]) * 1e3 for n in names)
        tps = sum(map(len, toks.values())) / wall
        kv_tok = m.num_layers * 2 * m.kv_size * m.dtype_bytes
        log(f"  (b) {len(names)} requests through the agent in {wall:.1f} "
            f"s: TTFT ms p50 {ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f};"
            f" {tps:.1f} generated tok/s; KV {kv_tok} bytes a token "
            f"(information only; {card}); prefix hits "
            f"{stats['prefix_hits']}; launches: kernel 1 {k1}, kernel 2 "
            f"{k2}")
        check_replays(stats, "mixtral-8x7b")
        assert k1 == m.num_layers * (graph["replays"] + graph["captures"]), \
            f"mixtral: kernel 1 launched {k1} times, not {m.num_layers} a step"
        assert stats["prefix_hits"] >= 2 and k2 > 0, \
            "mixtral: no prefix hit through kernel 2"
        check_streams_recomputed(deepseek_moe, cfg, agent.engine.params,
                                 sent, toks, "(b) mixtral-8x7b int8",
                                 moe=deepseek_moe)
        replay_streams(deepseek_moe, cfg, agent.engine.params, sent, toks,
                       installs, "(b) mixtral-8x7b int8")
        return k1, k2, cfg, agent.engine.params
    finally:
        post.close()
        agent.stop()
        master.close()
        store.close()
        del agent
        gc.collect()
        torch.cuda.empty_cache()


def _tree_tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_tensors(v)
        else:
            yield v


def deepseek_leg(engine_mod, deepseek_moe, attention, kernels, card):
    """4m (c): DeepSeek-V2-Lite in bf16, all 27 layers and 64 routed
    experts (two shared, layer 0 dense), random weights from a seed,
    through ``InferenceEngine`` (the reference agent has no config for
    it): phase 4j's kind of requests (two prefix hits) and an embeddings
    call. Checks the latent pool's shape ``[27, 2, P, 1, ps, 576]``,
    kernels 1, 2 and 3 idle, the MLA decode route (``paged_attention_xla``)
    once a layer every step, the prefix hits on the dense route, the
    embeddings (finite, each row independent of its batch's padding), and
    every greedy token against its recomputation. Returns the MLA route's
    calls, the engine's configuration and its weights (legs (e), (g) and
    (j) serve on them)."""
    from xllm_service_tpu_torch.models.deepseek_moe import (
        deepseek_v2_lite_config,
    )

    mcfg = deepseek_v2_lite_config()
    cfg = engine_config_4j(mcfg, num_pages=1024, max_seq_len=2048)
    rng = np.random.default_rng(41)
    V = mcfg.vocab_size
    prompts = [rng.integers(3, V, size=int(n)).tolist()
               for n in rng.integers(64, 1025, size=4)]
    shared = [prompts[0][:512] + rng.integers(3, V, size=int(n)).tolist()
              for n in rng.integers(64, 513, size=2)]
    texts = [rng.integers(3, V, size=n).tolist() for n in (40, 300)]

    def after(eng):
        both = eng.embed(texts)
        alone = eng.embed(texts[:1])
        return tuple(eng.kv_pages.shape), both, alone

    spied = {}

    def attach(eng):
        spied["installs"] = spy_installs(eng)

    reset_counts()
    xla0 = attention.paged_attention_xla.launches
    dense0 = attention.dense_prefill_route.launches
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    toks, sent, stats, ttft, tps, params, (shape, both, alone) = \
        serve_variant(engine_mod, cfg, None, prompts, shared,
                      rng.integers(3, V, size=200).tolist(), None,
                      after=after, attach=attach)
    xla = attention.paged_attention_xla.launches - xla0
    dense = attention.dense_prefill_route.launches - dense0
    k1, k2, k3 = (fn.launches for fn in kernels)
    graph = stats["decode_graph"]
    L = mcfg.num_layers
    pool_tok = L * 2 * mcfg.kv_size * mcfg.dtype_bytes
    log(f"  (c) deepseek-v2-lite bf16 ({L} layers, {mcfg.num_experts} "
        f"experts of {mcfg.moe_ffn_size} + {mcfg.num_shared_experts} "
        f"shared, MLA latent {mcfg.kv_lora_rank} + rope "
        f"{mcfg.qk_rope_head_dim}): served {len(toks)} requests in "
        f"{time.monotonic() - t:.1f} s (weights drawn by the engine); "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; TTFT ms p50 "
        f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; {tps:.1f} generated "
        f"tok/s; MLA pool {pool_tok} bytes a token (information only; "
        f"{card}); pool {shape}; prefix hits {stats['prefix_hits']}; MLA "
        f"decode route calls {xla}, dense-route prefills {dense}; kernels "
        f"1/2/3 {k1}/{k2}/{k3}")
    assert shape == (L, 2, cfg.num_pages, 1, cfg.page_size, 576), shape
    assert (k1, k2, k3) == (0, 0, 0), "a GQA kernel ran on the MLA engine"
    check_replays(stats, "deepseek-v2-lite")
    assert xla == L * (graph["replays"] + graph["captures"]), \
        f"MLA decode route called {xla} times, not {L} a step"
    assert stats["prefix_hits"] >= 2 and dense >= 2 * L, \
        "deepseek: the prefix hits did not take the dense route"
    err = float(np.abs(both[0] - alone[0]).max())
    cos = float(both[0] @ alone[0] / (np.linalg.norm(both[0])
                                       * np.linalg.norm(alone[0])))
    log(f"  (c) embeddings {both.shape}: row 0 (40 tokens) beside a "
        f"300-token row vs alone: cosine {cos:.6f} (tol >= 0.999: pooling "
        f"the 260 padded positions would move it far more), max_abs_err "
        f"{err:.4g}")
    assert both.shape == (2, mcfg.hidden_size) and np.isfinite(both).all()
    assert cos >= 0.999, "an embedding row saw its batch's padding"
    check_streams_recomputed(deepseek_moe, cfg, params, sent, toks,
                             "(c) deepseek-v2-lite bf16", moe=deepseek_moe)
    replay_streams(deepseek_moe, cfg, params, sent, toks, spied["installs"],
                   "(c) deepseek-v2-lite bf16")
    mla_route_timing(attention, card)
    return xla, cfg, params


def spy_installs(engine):
    """Record each install the engine dispatches, in order, as (request
    id, tokens of its prompt already in the pages); returns the list."""
    installs = []
    real = engine._dispatch_prefill_install

    def spied(seq, prompt, matched):
        installs.append((seq.req.service_request_id, matched))
        return real(seq, prompt, matched)

    engine._dispatch_prefill_install = spied
    return installs


def replay_streams(family, cfg, params, sent, toks, installs, what):
    """Every greedy stream fed back through the serving path's own shapes:
    each install as the engine dispatched it (a prefill at B 1 of the
    prompt past its ``installs`` prefix, behind the donor request's pages
    that hold that prefix, on the prefix route when it is not empty), then
    decode steps at the engine's batch width over full-width page tables,
    row r fed stream r's tokens. Every op of the step computes each row on
    its own, so each row's logits are the served step's bit for bit, and
    every greedy token must be the replay's argmax: no tolerance. Returns
    the tokens checked."""
    m = cfg.model
    B, W, ps = cfg.max_batch_size, cfg.pages_per_seq, cfg.page_size
    i32 = dict(dtype=torch.int32, device="cuda")
    order = [(n, k) for n, k in installs if n in toks and n != "sampled"]
    assert len(order) <= B, order
    pool = empty_pool(cfg, 1 + len(order) * W, "cuda")
    tables = {}
    checked = 0
    for i, (name, matched) in enumerate(order):
        prompt = sent[name]
        table = torch.arange(1 + i * W, 1 + (i + 1) * W, **i32)
        if matched:
            donor = next(d for d, _ in order[:i]
                         if sent[d][:matched] == prompt[:matched])
            table[:matched // ps] = tables[donor][:matched // ps]
        tables[name] = table
        logits, _ = family.prefill_forward(
            params, m, torch.tensor([prompt[matched:]], **i32),
            torch.arange(matched, len(prompt), **i32)[None], pool,
            table[None], torch.tensor([matched], **i32),
            torch.tensor([len(prompt) - matched], **i32),
            has_prefix=matched > 0)
        assert int(logits[0].argmax()) == toks[name][0], \
            f"{what}: {name}'s first token differs from its replay"
        checked += 1
    pt = torch.zeros((B, W), **i32)
    for r, (name, _) in enumerate(order):
        pt[r] = tables[name]
    n_prompt = torch.tensor([len(sent[n]) for n, _ in order] + [0] * (
        B - len(order)), **i32)
    steps = min(len(toks[n]) for n, _ in order)
    for j in range(1, steps):
        last = torch.tensor([toks[n][j - 1] for n, _ in order] + [0] * (
            B - len(order)), **i32)
        logits, _ = family.decode_forward(
            params, m, last, n_prompt + j - 1, pool, pt, n_prompt + j)
        got = logits[:len(order)].argmax(dim=-1).tolist()
        want = [toks[n][j] for n, _ in order]
        assert got == want, f"{what}: step {j} differs from its replay: " \
            f"{got} != {want}"
        checked += len(order)
    log(f"  {what}: {checked} greedy tokens equal to a replay at the "
        f"serving path's shapes ({len(order)} installs as dispatched, "
        f"{sum(1 for _, k in order if k)} behind a cached prefix, then "
        f"decode steps at batch {B}), exactly")
    return checked


def mla_route_timing(attention, card):
    """The MLA decode route (``paged_attention_xla``: the whole table
    gathered dense, f32) at DeepSeek-V2-Lite's decode, one layer: B 16,
    16 heads over one 576-wide latent head, 1024 tokens of context each in
    a 128-page table (the engine's 2048 tokens), beside its bound (the
    visible K and V read once, q and the output once) and one SDPA call
    over the same K/V gathered dense. Information only; returns the
    route's ms."""
    B, H, D, ps, mp, ctx = 16, 16, 576, 16, 128, 1024
    g = torch.Generator(device="cuda").manual_seed(51)
    pool = torch.randn((B * mp + 1, 1, ps, D), generator=g, device="cuda"
                       ).to(torch.bfloat16)
    pt = torch.arange(1, B * mp + 1, dtype=torch.int32,
                      device="cuda").reshape(B, mp)
    clens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=g, device="cuda").to(torch.bfloat16)
    scale = 1.0 / 192 ** 0.5
    ms = time_ms(lambda: attention.paged_attention_xla(q, pool, pool, pt,
                                                       clens, scale=scale))
    kv = pool[pt[:, :ctx // ps].long()].reshape(B, 1, ctx, D)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kv.expand(B, H, ctx, D), kv.expand(B, H, ctx, D),
        scale=scale))
    bound = bound_of(2 * (2 * B * ctx * D + 2 * B * H * D),
                     4 * B * H * ctx * D)
    log(f"  (c) MLA decode route at B {B}, {H} heads over one {D}-wide "
        f"latent, ctx {ctx} in a {mp * ps}-token table: {ms:.4f} ms a "
        f"layer; bound {bound[0]:.4f} ms ({bound[1]}); one SDPA call on "
        f"the K/V gathered dense {lib:.4f} ms ({card})")
    return ms


def moe_bench_twin(card):
    """4m (d): the bench twin at ``XLLM_BENCH_MODEL=moe`` (the reference's
    MLA+MoE bench shape in int8, B 16, ctx 512); information only."""
    from xllm_service_tpu_torch import bench

    os.environ["XLLM_BENCH_MODEL"] = "moe"
    try:
        b = bench.run("cuda")
    finally:
        del os.environ["XLLM_BENCH_MODEL"]
        gc.collect()
        torch.cuda.empty_cache()
    log("  bench " + json.dumps(b))
    log(f"  (d) bench twin (moe {b['quant']}, B {b['batch']}, ctx "
        f"{b['ctx']}): {b['value']:.1f} tok/s, {b['ms_per_token_step']:.3f} "
        f"ms a token-step, pct_roofline {b['pct_roofline']:.2f} of the "
        f"active experts' stream ({b['bytes_per_step_mb']:.1f} MB a step; "
        f"information only; {card})")
    return b


# ------------------------------------------------- phase 4m, legs (e)-(j)
# The later legs run eager on a seq mesh (phase 4c served 14.7-29.4 tok/s
# there), so each serves at most six requests of MOE_NEW tokens.
MOE_NEW = 16
# (f), (e) and 4o (d), (e) run eager on four shards, every prefill and
# step layer by layer on each: they take (b)'s and (c)'s weights cut to
# this depth (``depth_view``).
MOE_MESH_LAYERS = 8
# Leg (h) runs two DeepSeek-V2-Lite engines, one in each process: at full
# depth their weights alone take about 63 GB, so the pair runs layer 0
# (dense) and the first three MoE layers at full width.
MLA_PD_LAYERS = 4
MLA_PD_PROBE = "s0"


def seq_mesh4():
    """Phase 4c's mesh: a seq axis of four over the cards round robin
    (``cuda:0`` four times on one card)."""
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    count = torch.cuda.device_count()
    return build_mesh(MeshConfig(seq=4),
                      [torch.device("cuda", i % count) for i in range(4)])


def serve_greedy(engine_mod, cfg, params, prompts, shared=None, mesh=None,
                 max_tokens=MOE_NEW, mm=None):
    """One greedy run on a fresh engine with its loop (on ``mesh`` if
    given): ``prompts`` (name -> ids) at once, then ``shared`` once the
    first prompt has its first token (its blocks are donated by then);
    ``mm`` maps an image prompt's name to its visual rows. Returns (tokens
    by name, stats with the ring count, the eager decode steps (a spy on
    ``_decode_step``: under a seq mesh every step is one call) and the
    pool's shard shapes, wall s)."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params, mesh=mesh)
    steps = [0]
    step = eng._decode_step

    def counted(*args):
        steps[0] += 1
        return step(*args)

    eng._decode_step = counted
    sp = SamplingParams(max_tokens=max_tokens, temperature=0.0,
                        ignore_eos=True)
    cols = {}
    eng.start()
    try:
        t0 = time.monotonic()

        def submit(name, toks):
            cols[name] = Collector()
            eng.submit(engine_mod.EngineRequest(
                name, token_ids=toks, sampling=sp, on_output=cols[name],
                mm_embeds=(mm or {}).get(name)))

        for name, toks in prompts.items():
            submit(name, toks)
        if shared:
            assert cols[next(iter(prompts))].first.wait(600), \
                "the first request never started"
            for name, toks in shared.items():
                submit(name, toks)
        for name, c in cols.items():
            assert c.done.wait(900), f"{name} never finished"
        wall = time.monotonic() - t0
    finally:
        eng.stop()
    for name, c in cols.items():
        assert len(c.tokens) == max_tokens and c.reason == "length", \
            f"{name}: {len(c.tokens)} tokens, reason {c.reason!r}"
    kv = eng.kv_pages
    stats = dict(eng.stats(), ring_prefills=eng.ring_prefills,
                 eager_steps=steps[0],
                 pool=[tuple(s.shape) for s in getattr(kv, "shards", [kv])])
    toks = {n: c.tokens for n, c in cols.items()}
    del eng, kv
    gc.collect()
    torch.cuda.empty_cache()
    return toks, stats, wall


def held_to(moe, cfg, params, sent, got, want, what, routed=True,
            served_params=None):
    """MoE streams ``got`` against ``want``, served by another route on the
    same weights (PERF.md's rule): equal streams are counted; a stream
    that parts, and the one it parts from, must each pass
    ``check_streams_recomputed`` (every token its recomputation's argmax,
    a logit near-tie or a counted routing near-tie), so every parting is
    a reported near-tie. ``routed=False`` (a dense family, ``moe`` its
    module) admits no routing near-tie. ``served_params`` (the served
    route's sharded tree, phase 4o) recomputes the served streams on that
    route, the other side's on ``params``. Returns the count of streams
    that parted."""
    parted = [n for n in got if got[n] != want[n]]
    for n in parted:
        j = next(i for i, (a, b) in enumerate(zip(got[n], want[n]))
                 if a != b)
        log(f"  {what}: {n} parts at token {j} ({got[n][j]} against "
            f"{want[n][j]})")
    for side, streams, p in (("served", got, served_params or params),
                             ("other route", want, params)):
        if not parted:
            break
        check_streams_recomputed(moe, cfg, p, sent,
                                 {n: streams[n] for n in parted},
                                 f"{what}, the parted streams ({side})",
                                 moe=moe if routed else None)
    log(f"  {what}: {len(got) - len(parted)}/{len(got)} greedy streams "
        f"equal to the other route's; every parting a near-tie")
    return len(parted)


def seq_prompts(V, seed):
    """A seq-mesh leg's traffic: a 1101-token prefix-free prompt (the ring,
    its suffix padded by three to a multiple of four), two short ones and,
    once the long one has its first token, one sharing its first 512
    tokens (a prefix hit). Returns (prompts, shared)."""
    rng = np.random.default_rng(seed)
    long = rng.integers(3, V, size=1101).tolist()
    prompts = {"long": long, "a": rng.integers(3, V, size=90).tolist(),
               "b": rng.integers(3, V, size=300).tolist()}
    shared = {"hit": long[:512] + rng.integers(3, V, size=100).tolist()}
    return prompts, shared


def moe_seq_leg(engine_mod, moe, attention, kernels, cfg, params, tag,
                seed, card):
    """4m (e) and (f): an MoE model on a seq=4 pool (``seq_mesh4``), then
    on one device on the same weights, ``seq_prompts``' four requests of
    MOE_NEW tokens each, the ring taking prompts of 1024 tokens or more.
    Checks: one shard ``[L, 2, P/4, n_kv, 16, hd]`` a device of the axis,
    one ring route, the prefix hit, the routes of every decode step (MLA:
    ``paged_attention_xla`` once a layer over the sharded pool, kernels 1,
    2, 3 and 6 idle; GQA: kernel 6 once a layer and shard, kernel 2 on the
    prefix hit, kernels 1 and 3 idle), and the tokens against the
    one-device engine's (``held_to``). Returns (kernel 6's launches, the
    MLA route's calls, the launches of kernels 1 and 2 on one device, and
    the requests with the one-device streams, which 4o (d) and (e) are
    held to)."""
    from dataclasses import replace

    paged, mq, fused, partial = kernels
    m = cfg.model
    L, mla = m.num_layers, m.kv_lora_rank > 0
    prompts, shared = seq_prompts(m.vocab_size, seed)
    sent = {**prompts, **shared}
    scfg = replace(cfg, seq_parallel_min_tokens=1024)
    reset_counts()
    xla0 = attention.paged_attention_xla.launches
    dense0 = attention.dense_prefill_route.launches
    toks, st, wall = serve_greedy(engine_mod, scfg, params, prompts, shared,
                                  mesh=seq_mesh4())
    xla = attention.paged_attention_xla.launches - xla0
    dense = attention.dense_prefill_route.launches - dense0
    k1, k2, k3, k6 = (fn.launches for fn in (paged, mq, fused, partial))
    steps = st["eager_steps"]
    tps = sum(map(len, toks.values())) / wall
    log(f"  {tag} on a seq=4 pool, shards {st['pool']}: {len(toks)} "
        f"requests of {MOE_NEW} tokens in {wall:.1f} s ({tps:.1f} generated "
        f"tok/s, eager; information only, {card}); ring prefills "
        f"{st['ring_prefills']}, prefix hits {st['prefix_hits']}, "
        f"{steps} decode steps; MLA decode route calls {xla}, dense-route "
        f"prefills {dense}; kernels 1/2/3/6 {k1}/{k2}/{k3}/{k6}")
    shard = (L, 2, cfg.num_pages // 4, m.num_kv_heads, cfg.page_size,
             m.head_dim)
    assert st["pool"] == [shard] * 4, st["pool"]
    assert st["ring_prefills"] == 1, "the ring did not take the long prompt"
    assert st["prefix_hits"] >= 1, "no prefix hit on the seq mesh"
    assert k1 == 0 and k3 == 0, "kernel 1 or 3 ran on the seq mesh"
    if mla:
        assert xla == L * steps, \
            f"the MLA route ran {xla} times, not {L} a step for {steps}"
        assert (k2, k6) == (0, 0), "a GQA kernel ran on the MLA engine"
        assert dense >= L, "the prefix hit did not take the dense route"
    else:
        assert k6 == 4 * L * steps, \
            f"kernel 6 launched {k6} times, not {4 * L} a step for {steps}"
        assert k2 >= L, "the prefix hit did not take kernel 2"
    reset_counts()
    want, st1, _ = serve_greedy(engine_mod, cfg, params, prompts, shared)
    one = (paged.launches, mq.launches)
    assert st1["ring_prefills"] == 0 and st1["prefix_hits"] >= 1
    held_to(moe, cfg, params, sent, toks, want, f"{tag}, seq=4 vs one device")
    return k6, xla, one, ((prompts, shared), want)


def mixtral_spec_leg(engine_mod, moe, kernels, cfg, params, card):
    """4m (i): Mixtral-8x7B int8 under ``speculate_k=4`` (four cycles a
    call) and plain, on (b)'s weights: four greedy requests on phase 4h's
    repetitive prompts (the id unit repeated to 256 tokens plus the
    request's index), MOE_NEW tokens each. Checks: a cycle accepted a
    draft, kernel 2 once a layer in every captured spec variant and at
    least once a layer a cycle run, and the greedy tokens against the
    plain engine's (``held_to``). Returns the spec run's launches of
    kernels 1 and 2."""
    from dataclasses import replace

    L = cfg.model.num_layers
    scfg = replace(cfg, speculate_k=4, speculate_cycles=4)
    body = (SPEC_UNIT * (256 // len(SPEC_UNIT)))[:256]
    reqs = {f"g{i}": (body + [i], dict(temperature=0.0)) for i in range(4)}
    runs = {}
    for name, rcfg in (("speculate_k=4", scfg), ("plain", cfg)):
        t = time.monotonic()
        runs[name] = spec_serve(engine_mod, rcfg, params, [reqs], kernels,
                                max_tokens=MOE_NEW)
        r = runs[name]
        log(f"  (i) mixtral-8x7b int8, {name}: {r['tps']:.1f} generated "
            f"tok/s, spec calls {r['calls']}, launches kernel 1 / kernel 2 "
            f"{r['launches']}, {time.monotonic() - t:.1f} s (information "
            f"only; {card})")
    spec, plain = runs["speculate_k=4"], runs["plain"]
    per = [e for n in reqs for e in spec["per_cycle"].get(n, [])]
    log(f"  (i) tokens a spec cycle: {sum(per)} in {len(per)} stream-"
        f"cycles, {sum(per) / max(1, len(per)):.2f} a cycle, most "
        f"{max(per or [0])}; captured spec variants' launches a replay "
        f"{spec['graphs']}")
    assert spec["calls"] > 0 and plain["calls"] == 0
    assert max(per) >= 2, "no spec cycle accepted a draft"
    assert spec["graphs"] and all(
        g.get("mq_paged_attention", 0) == L for g in spec["graphs"].values()
    ), "kernel 2 not in every layer of a spec cycle"
    assert spec["launches"][1] >= spec["calls"] * scfg.speculate_cycles * L
    prompts = {n: p for n, (p, _) in reqs.items()}
    held_to(moe, cfg, params, prompts, spec["tokens"], plain["tokens"],
            "(i) mixtral-8x7b int8, speculation vs plain")
    return spec["launches"]


def mla_decode_agent_child(argv) -> int:
    """``python3 chip_smoke.py --mla-decode-agent LAYERS SID ARGS...``:
    ``decode_agent_child`` with the agent's engine configuration made for
    DeepSeek-V2-Lite cut to LAYERS layers at full width (the agent's
    ``--model-config`` table has no DeepSeek entry, as the reference
    agent's has none); the rest of the configuration from ARGS. The
    engine draws the weights from its seed, as the prefill side's."""
    from dataclasses import replace

    from xllm_service_tpu_torch.engine import agent as agent_mod
    from xllm_service_tpu_torch.models.deepseek_moe import (
        deepseek_v2_lite_config,
    )

    layers, rest = int(argv[0]), argv[1:]
    real = agent_mod.engine_config

    def engine_config(args):
        mcfg = replace(deepseek_v2_lite_config(), num_layers=layers)
        return replace(real(args), model=mcfg, model_family=mcfg.name,
                       max_seq_len=args.max_seq_len)

    agent_mod.engine_config = engine_config
    return decode_agent_child(rest)


def pd_pair_run(pre, child, master, store, requests, probe, body):
    """Dispatch ``requests`` (name -> body fields) to the PREFILL agent
    ``pre`` with ``routing.decode_name`` set to ``child``'s agent and a
    trace context each, after linking the pair; probes kernel 4 against
    the plain gather at every extract and digests the probe request's
    extracted buffer. ``body`` is the route (``/v1/completions`` or
    ``/v1/chat/completions``). Returns (tokens by name, handoff ms by
    name: the device offer's span here plus the device pull's span in the
    decode process, the differing elements of every extract, the probe's
    digests (extracted, installed), the decode side's launches during the
    run, seconds to the decode agent's registration)."""
    import hashlib
    import types
    import uuid

    from xllm_service_tpu_torch.engine.kv_transfer import tensor_bytes
    from xllm_service_tpu_torch.ops import page_dma
    from xllm_service_tpu_torch.parallel.sharding import ShardedBlock

    reg_s = child.link(store, pre)
    offered = {}
    offer = pre.kv_transfer.offer

    def joined(blob):
        return blob.join() if isinstance(blob, ShardedBlock) else blob

    def probed_offer(sid, blob, incarnation="", ready=None, ctx=None):
        desc = offer(sid, blob, incarnation, ready=ready, ctx=ctx)
        if sid == probe:
            offered[sid] = hashlib.blake2b(tensor_bytes(joined(blob)),
                                           digest_size=16).hexdigest()
        return desc

    pre.kv_transfer.offer = probed_offer
    extract = pre.engine.extract_kv_pages_device
    gathers = []

    def probed_extract(pages):
        got = extract(pages)
        full = joined(got)
        want = page_dma.gather_kv_pages_plain(pre.engine.kv_pages, pages)
        bits = torch.int16 if full.element_size() == 2 else torch.int32
        gathers.append((full.view(bits) != want.view(bits)).sum())
        return got

    pre.engine.extract_kv_pages_device = probed_extract
    before = child.report()["launches"]
    post = Poster(pre.name)
    ctxs = {}
    try:
        reset_counts()
        for sid, fields in requests.items():
            ctxs[sid] = {"trace_id": uuid.uuid4().hex,
                         "span_id": uuid.uuid4().hex[:16]}
            status, reply = post(body, dict(
                service_request_id=sid, request_id=sid,
                source_service_addr=master.addr, trace_context=ctxs[sid],
                routing={"decode_name": child.name}, **fields))
            assert status == 200, (sid, status, reply)
        master.wait(lambda: all(map(master.finished, requests)),
                    "the PD pair's requests", timeout=600)
    finally:
        post.close()
    after = child.report()
    dec = types.SimpleNamespace(name=child.name,
                                incarnation_id=child.meta.incarnation_id)
    toks = {n: check_deltas(n, master.gens[n], dec)[0] for n in requests}
    status, dstats = http_get(child.name, "/stats")
    kvt = dstats["kv_transfer"]
    n = len(requests)
    assert (pre.kv_device_sent, pre.kv_host_sent) == (n, 0) and \
        (kvt["device_received"], kvt["host_received"]) == (n, 0), \
        f"handoffs off the device path: {pre.kv_device_sent} device / " \
        f"{pre.kv_host_sent} host sent, received {kvt}"

    def span_ms(addr, sid, point):
        status, out = http_get(addr, f"/admin/trace?request_id={sid}")
        assert status == 200, out
        return next(s["duration_ms"] for s in out["spans"]
                    if s["point"] == point
                    and s["attrs"].get("path") == "device")

    handoff = {sid: span_ms(pre.name, sid, "kv_transfer.offer")
               + span_ms(child.name, sid, "kv_transfer.pull")
               for sid in requests}
    dl = {k: after["launches"][k] - before[k] for k in before}
    return (toks, handoff, [int(d) for d in gathers],
            (offered.get(probe), after["digests"].get(probe)), dl, reg_s)


def decode_plane(head, model_args, cfg, log_name):
    """A PD leg's store, coordination server, stub master (holding
    ``XLLM:SERVICE:MASTER``) and ``DecodeChild`` (``head``, the agent's
    ``model_args`` and ``cfg``'s engine sizes), made ahead of the leg so
    the child's start overlaps the legs before it. Returns (store, coord,
    master, child); ``close_plane`` closes them."""
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from xllm_service_tpu_torch.rpc import MASTER_KEY

    store = MemoryStore()
    coord = CoordServer(store)
    master = StubMaster()
    InMemoryCoordination(store).set(MASTER_KEY, master.addr)
    child = DecodeChild(
        head, [*model_args, "--num-pages", str(cfg.num_pages),
               "--page-size", str(cfg.page_size),
               "--max-batch-size", str(cfg.max_batch_size),
               "--max-seq-len", str(cfg.max_seq_len),
               "--decode-horizon", str(cfg.decode_horizon)], coord.addr,
        log_name)
    return store, coord, master, child


def close_plane(plane):
    store, coord, master, child = plane
    child.close()
    master.close()
    coord.close()
    store.close()


def tp_decode_plane(cfg, axes, log_name):
    """4o (f)'s (``axes`` "2") or 4q (e)'s ("seq=2,model=2") plane: a
    Llama-3-8B DECODE agent on that mesh of this card repeated."""
    return decode_plane(["--tp-decode-agent", axes, TP_PROBE],
                        ["--model-config", "llama3_8b", "--model-id",
                         "llama3-8b", "--tp", "2"], cfg, log_name)


def mla_pd_plane(moe):
    """4m (h)'s configuration and plane (DeepSeek-V2-Lite at
    MLA_PD_LAYERS layers). Returns (cfg, plane)."""
    from dataclasses import replace

    mcfg = replace(moe.deepseek_v2_lite_config(), num_layers=MLA_PD_LAYERS)
    cfg = engine_config_4j(mcfg, num_pages=512, max_seq_len=2048)
    return cfg, decode_plane(
        ["--mla-decode-agent", str(MLA_PD_LAYERS), MLA_PD_PROBE],
        ["--model-config", "tiny", "--model-id", "deepseek-v2-lite"], cfg,
        "phase4m_decode_agent.log")


def mla_pd_leg(engine_mod, moe, card, cfg_plane):
    """4m (h): a PREFILL agent here and a DECODE agent in a second process
    (``--mla-decode-agent``), both DeepSeek-V2-Lite at full width cut to
    MLA_PD_LAYERS layers (layer 0 dense, then MoE), bf16, weights drawn
    from seed 0 on each side, behind the stub master, the KV over CUDA
    IPC (one 576-wide latent head a page). Four prompts at once, then two
    sharing the first's 512 tokens; MOE_NEW tokens each. Checks: every
    handoff on the device path, kernel 4 once a handoff here and bit for
    bit equal to the plain gather, kernel 5 once a handoff there, the
    probe request's installed pages equal to its extracted buffer bit for
    bit, and the tokens against an in-process MIX engine on the same
    weights (``held_to``). ``cfg_plane`` is ``mla_pd_plane``'s; the leg
    closes the plane. Returns the launches of kernels 4 and 5."""
    from xllm_service_tpu_torch.common.types import InstanceType
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
    )
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.ops import page_dma

    cfg, plane = cfg_plane
    store, coord, master, child = plane
    mcfg = cfg.model
    params = moe.init_params(mcfg, torch.Generator(device="cuda")
                             .manual_seed(cfg.seed), "cuda")
    rng = np.random.default_rng(71)
    V = mcfg.vocab_size
    prompts = {f"g{i}": rng.integers(3, V, size=int(n)).tolist()
               for i, n in enumerate([640, 200, 700, 96])}
    shared = {f"s{j}": prompts["g0"][:512] + rng.integers(3, V, size=int(n))
              .tolist() for j, n in enumerate([80, 150])}
    pre = None
    try:
        # The reference streams while the decode agent starts.
        want, _, _ = serve_greedy(engine_mod, cfg, params, prompts, shared)
        pre = EngineAgent(cfg, AgentConfig(
            instance_type=InstanceType.PREFILL, model_id="deepseek-v2-lite",
            heartbeat_interval_s=1.0), coord=InMemoryCoordination(store),
            params=params, device="cuda")
        pre.start()
        greedy = dict(max_tokens=MOE_NEW, temperature=0.0, ignore_eos=True)
        reqs = {n: dict(token_ids=p, **greedy)
                for n, p in {**prompts, **shared}.items()}
        toks, handoff, bad, digests, dl, reg_s = pd_pair_run(
            pre, child, master, store, reqs, MLA_PD_PROBE, "/v1/completions")
        n = len(reqs)
        g4 = page_dma.gather_kv_pages.launches
        ms = sorted(handoff.values())
        log(f"  (h) deepseek-v2-lite at {MLA_PD_LAYERS} layers: decode agent "
            f"registered after {reg_s:.1f} s; {n} handoffs on the CUDA IPC "
            f"path, handoff ms (device offer + pull spans) p50 "
            f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f} (information only; "
            f"{card}); kernel 4 here {g4}, kernel 5 there "
            f"{dl['scatter_kv_pages']}; extracts differing from the plain "
            f"gather {sum(bad)}; {MLA_PD_PROBE} extracted / installed "
            f"{digests}")
        assert len(bad) == n and not any(bad), "kernel 4 at a handoff"
        assert g4 == n and dl["scatter_kv_pages"] == n, \
            "not one gather here and one scatter there a handoff"
        assert digests[0] is not None and digests[0] == digests[1], \
            "the installed latent pages differ from the extracted buffer"
        held_to(moe, cfg, params, {**prompts, **shared}, toks, want,
                f"(h) deepseek-v2-lite PD pair ({MLA_PD_LAYERS} layers) vs "
                "an in-process MIX engine")
        return g4, dl["scatter_kv_pages"]
    except BaseException:
        log(f"  the decode agent's log, last lines:\n{child.tail()}")
        raise
    finally:
        if pre is not None:
            pre.stop()
        close_plane(plane)
        del pre, params
        gc.collect()
        torch.cuda.empty_cache()


# 4m (j): the capacity leg's prefixes (28 blocks fed to a 16-block pool;
# the bench's default is 14).
KVTIER_PREFIXES = 7


def kvtier_twin(params, card):
    """4m (j): the ``kvtier_bench`` twin at DeepSeek-V2-Lite (bf16, (c)'s
    weights): leg 2 (capacity, at KVTIER_PREFIXES prefixes); information
    only. Its leg 1 (tier-aware TTFT) is left to the twin's own runs:
    (g) holds the tier round trip at this model."""
    from xllm_service_tpu_torch.benchmarks import kvtier_bench

    t = time.monotonic()
    rec = kvtier_bench.run("cuda", "deepseek_v2_lite", rounds=1,
                           prefixes=KVTIER_PREFIXES, legs=("capacity",),
                           params=params)
    log("  kvtier_bench " + json.dumps(rec))
    cap = rec["capacity"]
    log(f"  (j) kvtier_bench twin at deepseek-v2-lite: capacity x"
        f"{cap['capacity_multiplier']} ({cap['tiered_addressable_blocks']} "
        f"/ {cap['hbm_only_addressable_blocks']} blocks); "
        f"{time.monotonic() - t:.1f} s (information only; {card})")
    assert cap["tiered_addressable_blocks"] > cap["hbm_only_addressable_blocks"]
    return rec


def moe_phase(engine_mod, attention, page_dma, kernels, card):
    """Phase 4m: MoE and MLA at full width, (a) to (j), in the order that
    keeps one model's weights on the card at a time: (a), (b) and on
    Mixtral-8x7B's weights (f), 4o (d) and (i); (c) and on
    DeepSeek-V2-Lite's (e), 4o (e), (g) and (j); then (h) and (d), each
    drawing its own. Returns the launches of kernels 1, 2, 4, 5 and 6 in
    its serving legs (4o (d)'s apart)."""
    from xllm_service_tpu_torch.models import deepseek_moe, mixtral

    paged_attention, mq_paged_attention, fused_decode_attention, partial = \
        kernels
    moe_layer_check(deepseek_moe, mixtral, card)

    def leg(name, fn, *args):
        t = time.monotonic()
        out = fn(*args)
        log(f"  {name} leg: {time.monotonic() - t:.1f} s")
        return out

    k1, k2, xcfg, xparams = leg("(b)", mixtral_agent_leg, deepseek_moe,
                                (paged_attention, mq_paged_attention), card)
    mesh_cfg, mesh_params = depth_view(xcfg, xparams, MOE_MESH_LAYERS)
    tag = f"mixtral-8x7b int8 at {MOE_MESH_LAYERS} layers"
    k6, _, (f1, f2), x_one = leg("(f)", moe_seq_leg, engine_mod,
                                 deepseek_moe, attention, kernels, mesh_cfg,
                                 mesh_params, f"(f) {tag}", 81, card)
    log(f"[4o] (d) {tag} on expert=2 x model=2, (b)'s weights:")
    d1, d2 = leg("4o (d)", ep_leg, engine_mod, deepseek_moe, attention,
                 kernels, mesh_cfg, mesh_params, f"4o (d) {tag}", x_one,
                 card)
    i1, i2 = leg("(i)", mixtral_spec_leg, engine_mod, deepseek_moe,
                 (paged_attention, mq_paged_attention), xcfg, xparams, card)
    del xparams, mesh_params
    gc.collect()
    torch.cuda.empty_cache()
    _, dcfg, dparams = leg("(c)", deepseek_leg, engine_mod, deepseek_moe,
                           attention, kernels[:3], card)
    mesh_cfg, mesh_params = depth_view(dcfg, dparams, MOE_MESH_LAYERS)
    tag = f"deepseek-v2-lite bf16 at {MOE_MESH_LAYERS} layers"
    # (h)'s decode agent starts now: its start overlaps (e) to (j).
    plane = mla_pd_plane(deepseek_moe)
    try:
        *_, d_one = leg("(e)", moe_seq_leg, engine_mod, deepseek_moe,
                        attention, kernels, mesh_cfg, mesh_params,
                        f"(e) {tag}", 61, card)
        log(f"[4o] (e) {tag} on expert=2 x model=2, (c)'s weights:")
        leg("4o (e)", ep_leg, engine_mod, deepseek_moe, attention, kernels,
            mesh_cfg, mesh_params, f"4o (e) {tag}", d_one, card)
        del mesh_params
        log("  (g) deepseek-v2-lite bf16 through the KV tiers:")
        g4, g5 = leg("(g)", tier_phase, engine_mod, dcfg, dparams,
                     page_dma, card)
        leg("(j)", kvtier_twin, dparams, card)
    except BaseException:
        close_plane(plane[1])
        raise
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    h4, h5 = leg("(h)", mla_pd_leg, engine_mod, deepseek_moe, card, plane)
    moe_bench_twin(card)
    return dict(paged=k1 + f1 + i1, mq=k2 + f2 + i2, partial=k6,
                gather=g4 + h4, scatter=g5 + h5, mla_gather=g4 + h4,
                mla_scatter=g5 + h5, ep_paged=d1, ep_mq=d2)


# --------------------------------------------------------------- phase 4o
# The tensor, expert and data axes in one process, on meshes of the cards
# round robin (the one card repeated, phase 4c's way). The legs are eager
# and carry at most six requests of TP_NEW tokens (8: the script's time
# went to phase 4s's several masters).
TP_NEW = 8
# Llama-3-70B int8's pool: 512 pages of 16 tokens at 327,680 bytes a token
# (80 layers x K and V x 8 heads x 128 x bf16), 2.68 GB.
TP70_PAGES = 512
# 4o (c)'s depth: every eager step runs each layer on eight shards, so the
# leg's time grows with it; at all 80 layers it took a twelfth of the
# script.
TP70_LAYERS = 8
TP_LAYERS = 8        # 4o (a): Llama-3-8B cut to these layers on model=4
TP_PROBE = "s0"      # the request whose pages leg (f) holds bit for bit


def card_mesh(**axes):
    """A mesh of ``axes`` over the cards round robin (``cuda:0`` repeated
    on one card)."""
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    cfg = MeshConfig(**axes)
    count = torch.cuda.device_count()
    return build_mesh(cfg, [torch.device("cuda", i % count)
                            for i in range(cfg.num_devices())])


def tp_traffic(prompts, shared):
    """Phase 4's requests cut to six: its first four prompts (by their
    names there) and its two prefix hits. Returns (prompts, shared)."""
    return ({f"g{i}": prompts[i] for i in range(4)},
            {f"s{j}": p for j, p in enumerate(shared)})


def check_mq_groups(mq_paged_attention, mq_paged_attention_plain, mq_route,
                    groups=((8, 2), (8, 1))):
    """Kernel 2 at a model shard's groups: Llama-3-8B at ``model=4`` (8/2
    heads, a group of 4) and Llama-3-70B at ``model=8`` (8/1, a group of
    8), head dim 128, on the tensor-core route: against the plain version
    (f32 at Sq 17 behind 384, bf16 at Sq 512 behind 512), then timed at Sq
    512 behind 512 beside one masked SDPA call and the bound. Returns a
    row per group."""
    out = {}
    hd = HD
    for n_q, n_kv in groups:
        assert mq_route(torch.bfloat16, hd, PS, n_q // n_kv) == "mma", \
            f"group {n_q // n_kv} is not on the tensor-core route"
        k, v, pt = paged_inputs(torch.float32, [384 + 17, 384 + 14],
                                seed=36, n_kv=n_kv, hd=hd)
        q = torch.randn((2, 17, n_q, hd), device="cuda")
        pre = torch.full((2,), 384, dtype=torch.int32, device="cuda")
        blk = torch.tensor([17, 14], dtype=torch.int32, device="cuda")
        e32 = (mq_paged_attention(q, k, v, pt, pre, blk)
               - mq_paged_attention_plain(q, k, v, pt, pre, blk)).abs().max(
               ).item()
        assert e32 <= TOL[torch.float32], "mq at a shard's group (f32)"
        s_q = prefix = 512
        T = prefix + s_q
        k, v, pt = paged_inputs(torch.bfloat16, [T], seed=37, n_kv=n_kv,
                                hd=hd)
        q = torch.randn((1, s_q, n_q, hd), device="cuda").to(torch.bfloat16)
        pre = torch.tensor([prefix], dtype=torch.int32, device="cuda")
        blk = torch.tensor([s_q], dtype=torch.int32, device="cuda")
        got = mq_paged_attention(q, k, v, pt, pre, blk)
        want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        assert e <= TOL[torch.bfloat16], "mq at a shard's group (bf16)"
        kd, vd = gathered(k, pt, T).contiguous(), gathered(v, pt, T
                                                           ).contiguous()
        qd = q.transpose(1, 2).contiguous()
        mask = (torch.arange(T, device="cuda")[None, :]
                <= prefix + torch.arange(s_q, device="cuda")[:, None])
        ms = time_ms(lambda: mq_paged_attention(q, k, v, pt, pre, blk))
        plain_ms = time_ms(
            lambda: mq_paged_attention_plain(q, k, v, pt, pre, blk))
        lib = time_ms(lambda: sdpa(qd, kd, vd, mask))
        nbytes = (2 * q.numel() * 2 + T * n_kv * hd * 2 * 2 + (T // PS) * 4
                  + 8)
        ops = 4 * n_q * hd * (s_q * prefix + s_q * (s_q + 1) // 2)
        bound, by = bound_of(nbytes, ops)
        out[(n_q, n_kv)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                                bound_ms=bound, bound_by=by, max_abs_err=e)
        log(f"  mq_paged_attention mma bf16 {n_q}/{n_kv} heads (group "
            f"{n_q // n_kv}) Sq 512 behind 512: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib:.4f} ms ({ms / lib:.2f}x), bound "
            f"{bound:.4f} ms ({by}), {ms / bound:.1f}x the bound; "
            f"max_abs_err={e:.3g} (f32 at Sq 17 behind 384: {e32:.3g})")
    return out


def check_tp_logits(llama, cfg, params, prompt, mesh, sharded):
    """One prompt's decode-step logits and pool two ways on the same
    weights: the one-device route (``params``) and the sharded one the
    engine takes (``sharded``, ``params`` on ``mesh``: each shard's heads
    against its pool, the partials summed, the vocabulary shards joined;
    the experts over their shards). ``llama`` is the family's module. The
    logits must agree within PREFILL_REL_TOL of max |logit| and the
    shards, joined on the head axis, the one-device pool within
    PREFILL_REL_TOL of max |K/V| (the same layers of bf16 rounding in
    another order reach both)."""
    from xllm_service_tpu_torch.parallel.sharding import ModelShardedPages

    mcfg = cfg.model
    n = len(prompt)
    n_pages = -(-n // PS)
    i32 = dict(dtype=torch.int32, device="cuda")
    # A page-and-head grid's pages divide over the seq axis.
    shape = (mcfg.num_layers, 2, n_pages + 1 + (-(n_pages + 1)
                                                 % mesh.shape["seq"]),
             mcfg.num_kv_heads, PS, mcfg.head_dim)
    pt = torch.arange(1, n_pages + 1, **i32)[None]
    toks = torch.tensor([prompt], **i32)

    def route(p, kv):
        llama.prefill_forward(
            p, mcfg, toks[:, :n - 1], torch.arange(n - 1, **i32)[None], kv,
            pt, torch.zeros((1,), **i32), torch.tensor([n - 1], **i32),
            has_prefix=False)
        return llama.decode_forward(
            p, mcfg, toks[:, n - 1], torch.tensor([n - 1], **i32), kv, pt,
            torch.tensor([n], **i32))[0]

    one_kv = torch.zeros(shape, dtype=mcfg.dtype, device="cuda")
    single = route(params, one_kv)
    tp_kv = (ModelShardedPages.zeros(shape, mcfg.dtype, mesh)
             if mesh.shape["model"] > 1
             else torch.zeros(shape, dtype=mcfg.dtype, device="cuda"))
    tp = route(sharded, tp_kv)
    joined = tp_kv.full() if mesh.shape["model"] > 1 else tp_kv
    scale = single.abs().max().item()
    err = (single - tp).abs().max().item()
    kv_scale = one_kv[:, :, 1:].abs().max().item()
    kv_err = (joined - one_kv)[:, :, 1:].abs().max().item()
    log(f"  one-device vs {dict(mesh.shape)} decode step ({n} tokens): "
        f"logits max_abs_err={err:.4g}, max|logit|={scale:.4g}; pool "
        f"{tuple(getattr(tp_kv, 'shards', [tp_kv])[0].shape)} a shard, "
        f"joined max_abs_err="
        f"{kv_err:.4g}, max|K/V|={kv_scale:.4g} (tol {PREFILL_REL_TOL} x "
        f"max each); argmax {int(single.argmax())} vs {int(tp.argmax())}")
    assert torch.isfinite(tp).all()
    assert err <= PREFILL_REL_TOL * scale, "sharded decode logits drifted"
    assert kv_err <= PREFILL_REL_TOL * kv_scale, "sharded pool drifted"


def tp_leg(engine_mod, llama, cfg, params, prompts, shared, kernels, card):
    """4o (a): Llama-3-8B bf16 at full width and TP_LAYERS layers
    (``depth_view`` of phase 4's weights) on ``model=4``, resharded
    (views: no memory): 8/2 heads and ffn 3584 a shard, phase 4's requests
    cut to six (two prefix hits), TP_NEW tokens each. Checks: four shards
    ``[TP_LAYERS, 2, P, 2, 16, 128]``, kernel 1 at 4 x TP_LAYERS launches
    a step, kernel 2 on the prefix hits, kernels 3 and 6 idle, the tokens
    held to a one-device engine's streams at that depth (``held_to``), one
    decode step's logits and the pool (``check_tp_logits``). Returns
    (kernel 1's and 2's launches, the mesh)."""
    from xllm_service_tpu_torch.parallel.sharding import shard_params

    paged, mq, fused, partial = kernels
    cfg, params = depth_view(cfg, params, TP_LAYERS)
    mesh = card_mesh(model=4)
    log(f"  mesh model=4 on {[str(d) for d in mesh.devices]}")
    sharded = shard_params(params, mesh, llama.LLAMA_STACKED_RULES)
    reqs, hits = tp_traffic(prompts, shared)
    sent = {**reqs, **hits}
    want = serve_greedy(engine_mod, cfg, params, reqs, hits,
                        max_tokens=TP_NEW)[0]
    reset_counts()
    toks, st, wall = serve_greedy(engine_mod, cfg, sharded, reqs, hits,
                                  mesh=mesh, max_tokens=TP_NEW)
    k1, k2, k3, k6 = (fn.launches for fn in (paged, mq, fused, partial))
    steps = st["eager_steps"]
    m = cfg.model
    log(f"  (a) llama3-8b on model=4, shards {st['pool']}: {len(toks)} "
        f"requests of {TP_NEW} tokens in {wall:.1f} s "
        f"({sum(map(len, toks.values())) / wall:.1f} generated tok/s, "
        f"eager; information only, {card}); prefix hits "
        f"{st['prefix_hits']}, {steps} decode steps, route "
        f"{st['decode_route']}; kernels 1/2/3/6 {k1}/{k2}/{k3}/{k6}")
    assert st["pool"] == [(m.num_layers, 2, cfg.num_pages, 2, PS, HD)] * 4
    assert st["decode_route"] == "eager" and st["prefix_hits"] >= 2
    assert k1 == 4 * m.num_layers * steps, \
        f"kernel 1 launched {k1} times, not {4 * m.num_layers} a step"
    assert k2 >= 4 * m.num_layers, "the prefix hits did not take kernel 2"
    assert k3 == 0 and k6 == 0, "kernel 3 or 6 ran on the model axis"
    held_to(llama, cfg, params, sent, toks, want,
            f"(a) llama3-8b model=4 vs a one-device engine, {TP_LAYERS} "
            "layers", routed=False)
    check_tp_logits(llama, cfg, params, shared[0], mesh, sharded)
    return (k1, k2), mesh


def tp_decode_agent_child(argv) -> int:
    """``python3 chip_smoke.py --tp-decode-agent AXES SID ARGS...``:
    ``decode_agent_child`` with the agent's engine handed a mesh of this
    card repeated, as ``InferenceEngine`` takes one (the agent's ``mesh``
    argument; ``--tp N`` alone takes N distinct cards). AXES is N
    (``model=N``) or ``axis=n,...`` (``seq=2,model=2``: the page-and-head
    grid)."""
    import functools

    from xllm_service_tpu_torch.engine import agent as agent_mod

    spec, rest = argv[0], argv[1:]
    axes = (dict(model=int(spec)) if spec.isdigit() else
            {k: int(v) for k, v in (a.split("=") for a in spec.split(","))})
    agent_mod.EngineAgent = functools.partial(agent_mod.EngineAgent,
                                              mesh=card_mesh(**axes))
    return decode_agent_child(rest)


def pd_host_pair(pre, dec, master, requests):
    """``requests`` through a PREFILL agent ``pre`` and a DECODE agent
    ``dec`` of this process, linked both ways as the master does, behind
    the stub master. Returns the tokens by name."""
    for addr, peer in ((pre.name, dec.meta()), (dec.name, pre.meta())):
        post = Poster(addr)
        try:
            status, reply = post("/rpc/link",
                                 {"peer": json.loads(peer.to_json())})
        finally:
            post.close()
        assert status == 200 and reply["ok"], reply
    post = Poster(pre.name)
    try:
        for sid, fields in requests.items():
            status, reply = post("/v1/completions", dict(
                service_request_id=sid, request_id=sid,
                source_service_addr=master.addr,
                routing={"decode_name": dec.name}, **fields))
            assert status == 200, (sid, status, reply)
        master.wait(lambda: all(map(master.finished, requests)),
                    "the host pair's requests", timeout=600)
    finally:
        post.close()
    return {n: check_deltas(n, master.gens[n], dec)[0] for n in requests}


def tp_pd_leg(cfg, params, llama, prompts, shared, engine_mod, card,
              plane):
    """4o (f): PD pairs of Llama-3-8B bf16 at full depth. A ``model=2``
    PREFILL agent here, handed its mesh as ``InferenceEngine`` takes one,
    and a ``model=2`` DECODE agent in a second process
    (``--tp-decode-agent``, weights from the same seed): every handoff on
    CUDA IPC, one handle a shard; kernel 4 once a shard a handoff here,
    bit for bit against the plain gather; kernel 5 once a shard there; the
    probe request's installed pages equal to its extracted block. Then the
    same PREFILL agent and an unmeshed DECODE agent of this process: the
    meshes differ, so every handoff rides the host path (the reference's
    topology rule). Both pairs' streams are held to an in-process MIX
    engine's on ``model=2`` (``held_to``). ``plane`` is
    ``tp_decode_plane``'s, which the leg closes. Returns the launches of
    kernels 4 and 5."""
    from xllm_service_tpu_torch.common.types import InstanceType
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
    )
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.ops import page_dma

    mesh = card_mesh(model=2)
    reqs, hits = tp_traffic(prompts, shared)
    sent = {**reqs, **hits}
    greedy = dict(max_tokens=TP_NEW, temperature=0.0, ignore_eos=True)
    requests = {n: dict(token_ids=p, **greedy) for n, p in sent.items()}
    store, coord, master, child = plane
    pre = dec = None
    try:
        # The reference streams while the decode agent starts.
        want, _, _ = serve_greedy(engine_mod, cfg, params, reqs, hits,
                                  mesh=mesh, max_tokens=TP_NEW)
        pre = EngineAgent(cfg, AgentConfig(
            instance_type=InstanceType.PREFILL, model_id="llama3-8b",
            heartbeat_interval_s=1.0), coord=InMemoryCoordination(store),
            params=params, device="cuda", mesh=mesh)
        pre.start()
        toks, handoff, bad, digests, dl, reg_s = pd_pair_run(
            pre, child, master, store, requests, TP_PROBE,
            "/v1/completions")
        n = len(requests)
        g4 = page_dma.gather_kv_pages.launches
        ms = sorted(handoff.values())
        log(f"  (f) model=2 pair over CUDA IPC: decode agent registered "
            f"after {reg_s:.1f} s; {n} handoffs, two handles each; handoff "
            f"ms (device offer + pull spans) p50 {ms[len(ms) // 2]:.3f} max "
            f"{ms[-1]:.3f} (information only; {card}); kernel 4 here {g4}, "
            f"kernel 5 there {dl['scatter_kv_pages']}, kernel 1 there "
            f"{dl['paged_attention']}; extracts differing from the plain "
            f"gather {sum(bad)}; {TP_PROBE} extracted / installed {digests}")
        assert len(bad) == n and not any(bad), "kernel 4 at a handoff"
        assert g4 == 2 * n and dl["scatter_kv_pages"] == 2 * n, \
            "not one gather here and one scatter there a shard a handoff"
        assert digests[0] is not None and digests[0] == digests[1], \
            "the installed pages differ from the extracted block"
        held_to(llama, cfg, params, sent, toks, want,
                "(f) model=2 PD pair vs an in-process MIX engine",
                routed=False)
        scatters = dl["scatter_kv_pages"]
        dec = EngineAgent(cfg, AgentConfig(
            instance_type=InstanceType.DECODE, model_id="llama3-8b",
            heartbeat_interval_s=1.0), coord=InMemoryCoordination(store),
            params=params, device="cuda")
        dec.start()
        reset_counts()
        host = pd_host_pair(pre, dec, master, {
            f"h{k}": v for k, v in requests.items()})
        h4 = page_dma.gather_kv_pages.launches
        h5 = page_dma.scatter_kv_pages.launches
        log(f"  (f) model=2 -> unmeshed pair: {pre.kv_host_sent} host "
            f"handoffs ({pre.kv_stream_sent} streamed), {pre.kv_device_sent} "
            f"device; kernels 4/5 {h4}/{h5}")
        assert (pre.kv_device_sent, pre.kv_host_sent) == (n, n), \
            "a mismatched pair's handoff left the host path"
        assert dec.kv_host_received == n
        assert h4 == 2 * n and h5 == n, "not two gathers and one scatter"
        held_to(llama, cfg, params, sent,
                {k[1:]: v for k, v in host.items()}, want,
                "(f) model=2 -> unmeshed pair vs the MIX engine",
                routed=False)
        return g4 + h4, scatters + h5
    except BaseException:
        log(f"  the decode agent's log, last lines:\n{child.tail()}")
        raise
    finally:
        child.close()
        for a in (pre, dec):
            if a is not None:
                a.stop()
        master.close()
        coord.close()
        store.close()
        del pre, dec
        gc.collect()
        torch.cuda.empty_cache()


def ep_leg(engine_mod, moe, attention, kernels, cfg, params, tag, sent_want,
           card):
    """4o (d) and (e): an MoE model on ``expert=2 x model=2`` (the
    reference's EP-PD layout) on 4m's weights: the requests of its seq
    leg (``seq_prompts``), TP_NEW tokens each, held to that leg's
    one-device streams: every stream's first token (the prefill's argmax)
    equal to one device's, and each parting a near-tie or a counted
    routing near-tie where each side is recomputed on its own route
    (``held_to``; recomputed on one device, the served streams take more
    routing near-ties than ROUTED_SHARE allows: the shards' partial sums
    round apart, and random weights leave many router margins below
    that). GQA (Mixtral, 8 KV heads): two shards of 4 heads, kernel 1
    at 2 launches a layer a step (2 model shards), kernel 2 on the
    prefix hit. MLA (DeepSeek-V2-Lite): the one-head latent pool
    replicated, its route (``paged_attention_xla``) once a layer a step a
    model shard, kernels 1-3 idle. Returns (kernel 1's and 2's
    launches)."""
    from xllm_service_tpu_torch.parallel.sharding import shard_params

    paged, mq, fused, partial = kernels
    (prompts, shared), want = sent_want
    m = cfg.model
    L, mla = m.num_layers, m.kv_lora_rank > 0
    mesh = card_mesh(expert=2, model=2)
    sharded = shard_params(params, mesh, moe.MOE_STACKED_RULES)
    reset_counts()
    xla0 = attention.paged_attention_xla.launches
    toks, st, wall = serve_greedy(engine_mod, cfg, sharded, prompts, shared,
                                  mesh=mesh, max_tokens=TP_NEW)
    xla = attention.paged_attention_xla.launches - xla0
    k1, k2, k3, k6 = (fn.launches for fn in (paged, mq, fused, partial))
    steps = st["eager_steps"]
    log(f"  {tag} on expert=2 x model=2, pool {st['pool']}: {len(toks)} "
        f"requests of {TP_NEW} tokens in {wall:.1f} s "
        f"({sum(map(len, toks.values())) / wall:.1f} generated tok/s, eager; "
        f"information only, {card}); prefix hits {st['prefix_hits']}, "
        f"{steps} decode steps; MLA route calls {xla}; kernels 1/2/3/6 "
        f"{k1}/{k2}/{k3}/{k6}")
    heads = m.num_kv_heads if mla else m.num_kv_heads // 2
    assert st["pool"] == [(L, 2, cfg.num_pages, heads, PS, m.head_dim)] * 2
    assert st["prefix_hits"] >= 1 and k3 == 0 and k6 == 0
    if mla:
        assert xla == 2 * L * steps, \
            f"the MLA route ran {xla} times, not {2 * L} a step"
        assert k1 == 0 and k2 == 0, "a GQA kernel ran on the MLA engine"
    else:
        assert k1 == 2 * L * steps, \
            f"kernel 1 launched {k1} times, not {2 * L} a step"
        assert k2 >= 2 * L, "the prefix hit did not take kernel 2"
    assert all(toks[n][0] == want[n][0] for n in toks), \
        "a prefill on the expert mesh took another first token"
    held_to(moe, cfg, params, {**prompts, **shared}, toks,
            {n: want[n][:TP_NEW] for n in toks},
            f"{tag}, expert=2 x model=2 vs one device",
            served_params=sharded)
    return k1, k2


def tp70b_leg(engine_mod, llama, prompts, shared, kernels, card):
    """4o (c): Llama-3-70B in weight-only int8 (``llama3_70b_config``) at
    full width and TP70_LAYERS of its 80 layers on ``model=8`` of this
    card: 8/1 heads a shard, the weights drawn straight into int8 (one
    layer of one projection at a time) and sharded as views, a pool of
    TP70_PAGES pages; phase 4's requests cut to six (two prefix hits),
    TP_NEW tokens each. Checks: eight shards ``[TP70_LAYERS, 2, 512, 1, 16,
    128]``, kernel 1 at 8 x TP70_LAYERS launches a step, kernel 2 on the
    prefix hits, every greedy token against its recomputation by the same
    sharded weights. The build's
    seconds, ``max_memory_allocated`` and tok/s are information. Returns
    (kernel 1's and 2's launches)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.engine import EngineConfig
    from xllm_service_tpu_torch.models.base import llama3_70b_config
    from xllm_service_tpu_torch.parallel.sharding import shard_params

    paged, mq, fused, partial = kernels
    mcfg = replace(llama3_70b_config(), quant="int8", num_layers=TP70_LAYERS)
    L = mcfg.num_layers
    cfg = EngineConfig(model=mcfg, num_pages=TP70_PAGES, page_size=PS,
                       hash_block_size=128, max_batch_size=8,
                       max_seq_len=2048, decode_horizon=8,
                       admission_horizon=8, seed=0)
    mesh = card_mesh(model=8)
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    params = shard_params(
        llama.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda"), mesh, llama.LLAMA_STACKED_RULES)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t
    log(f"  (c) llama3-70b int8 at {L} layers drawn and sharded eight "
        f"ways in {build_s:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated ({card})")
    reqs, hits = tp_traffic(prompts, shared)
    sent = {**reqs, **hits}
    reset_counts()
    toks, st, wall = serve_greedy(engine_mod, cfg, params, reqs, hits,
                                  mesh=mesh, max_tokens=TP_NEW)
    k1, k2, k3, k6 = (fn.launches for fn in (paged, mq, fused, partial))
    steps = st["eager_steps"]
    peak = torch.cuda.max_memory_allocated()
    log(f"  (c) llama3-70b int8 on model=8, shards {st['pool'][:1]} x "
        f"{len(st['pool'])}: {len(toks)} requests of {TP_NEW} tokens in "
        f"{wall:.1f} s ({sum(map(len, toks.values())) / wall:.2f} generated "
        f"tok/s, eager; information only, {card}); max_memory_allocated "
        f"{peak / 1e9:.2f} GB; prefix hits {st['prefix_hits']}, {steps} "
        f"decode steps; kernels 1/2/3/6 {k1}/{k2}/{k3}/{k6}")
    assert st["pool"] == [(L, 2, TP70_PAGES, 1, PS, HD)] * 8
    assert st["prefix_hits"] >= 2
    assert k1 == 8 * L * steps, \
        f"kernel 1 launched {k1} times, not {8 * L} a step for {steps}"
    assert k2 >= 8 * L, "the prefix hits did not take kernel 2"
    assert k3 == 0 and k6 == 0
    check_streams_recomputed(llama, cfg, params, sent, toks,
                             "(c) llama3-70b int8 on model=8")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return k1, k2


def dryrun_leg(card):
    """4o (g): ``parallel/dryrun.py`` at the north-star sizes on this card
    repeated eight times: the decode step on ``model=8``, the MoE decode
    on ``expert=8``, the ring and context-parallel decode on ``seq=8``,
    each against its unsharded run."""
    from xllm_service_tpu_torch.parallel.dryrun import TOL, dryrun

    t = time.monotonic()
    out = dryrun([torch.device("cuda", i % torch.cuda.device_count())
                  for i in range(8)], northstar=True)
    log(f"  (g) dry run at the north-star sizes: {json.dumps(out)} (tol "
        f"{TOL}); {time.monotonic() - t:.1f} s ({card})")
    return out


# --------------------------------------------------------------- phase 4n
# The encoder in bf16 against its f32 path: 32 layers of bf16 rounding
# (unit roundoff 2**-9) on a residual stream through LayerNorms drift by a
# few percent of the embeddings' scale; a patchify, rope or merge fault
# moves them by their whole scale. Bound: 10% of max |f32 embedding|.
VL_ENC_REL_TOL = 0.1
VL_CHAT_TEXT = ("Describe what you see in the picture and name the "
                "colours that stand out, in one short and plain sentence. ")


def vl_png_uri(seed, size=224):
    """A seeded size x size RGB PNG as a data URI (PIL, as a client
    encodes one)."""
    import base64
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                       dtype=np.uint8), "RGB")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def vl_messages(text, seeds):
    parts = [{"type": "text", "text": text}]
    parts += [{"type": "image_url", "image_url": {"url": vl_png_uri(s)}}
              for s in seeds]
    return [{"role": "user", "content": parts}]


def cast_tree(tree, dtype):
    """A copy of a weight tree with every leaf in ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def vl_encoder_check(qwen2_vl, mcfg, params, card):
    """4n (a): ``encode_images`` on four seeded 224 px images in bf16
    against the same encoder in f32 (the vision weights cast up), timed.
    Returns the bf16 embeddings [4, 64, D]."""
    from dataclasses import replace

    px = torch.from_numpy(np.random.default_rng(41).uniform(
        size=(4, 224, 224, 3)).astype(np.float32)).cuda()
    got = qwen2_vl.encode_images(params, mcfg, px)
    f32 = {"vision": cast_tree(params["vision"], torch.float32)}
    want = qwen2_vl.encode_images(f32, replace(mcfg, dtype=torch.float32),
                                  px)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (4, mcfg.vision.out_tokens, mcfg.hidden_size)
    assert torch.isfinite(got).all(), "encoder: non-finite embeddings"
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    ms = time_ms(lambda: qwen2_vl.encode_images(params, mcfg, px), reps=5,
                 warmup=1)
    log(f"  (a) encode_images bf16 [4, 224, 224, 3] -> {list(got.shape)}: "
        f"max_abs_err {err:.4g} against f32 (max |f32| {scale:.4g}, tol "
        f"{VL_ENC_REL_TOL} of it); {ms / 4:.2f} ms an image (information "
        f"only; {card})")
    assert err <= VL_ENC_REL_TOL * scale, "encoder bf16 disagrees with f32"
    del f32, want
    return got


def vl_agents_leg(engine_mod, cfg, params, kernels, card):
    """4n (b): a MIX and an ENCODE agent on the card, sharing the weights,
    behind phase 4f's stub master, which routes each image chat's vision
    stage to the ENCODE agent (``routing.encode_name``). Eight greedy image
    chats (one or two PNG data URIs, two of them differing only in their
    image) and two text chats; checks in the module docstring. Returns
    the launches of kernels 1 and 2, the image chats and their tokens
    (equal to the in-process engine's)."""
    from xllm_service_tpu_torch.common.types import InstanceType
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from dataclasses import replace

    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.rpc import MASTER_KEY

    paged_attention, mq_paged_attention = kernels
    mcfg = cfg.model
    store = MemoryStore()
    coord = InMemoryCoordination(store)
    master = StubMaster()
    coord.set(MASTER_KEY, master.addr)

    def agent(itype, c):
        return EngineAgent(c, AgentConfig(model_id="qwen2-vl-2b",
                                          instance_type=itype,
                                          heartbeat_interval_s=1.0),
                           coord=InMemoryCoordination(store), params=params,
                           device="cuda")

    mix = agent(InstanceType.MIX, cfg)
    enc = agent(InstanceType.ENCODE, replace(cfg, num_pages=256,
                                             max_batch_size=1))
    chats = {f"i{k}": vl_messages(VL_CHAT_TEXT[:60 + 7 * k],
                                  [100 + k] + ([200 + k] if k % 2 else []))
             for k in range(6)}
    chats["same-a"] = vl_messages(VL_CHAT_TEXT, [300])
    chats["same-b"] = vl_messages(VL_CHAT_TEXT, [301])
    texts = {"t0": [{"role": "user", "content": VL_CHAT_TEXT * 2}],
             "t1": [{"role": "user", "content": VL_CHAT_TEXT[::-1]}]}
    greedy = dict(max_tokens=32, temperature=0.0, ignore_eos=True)
    sent_at = {}
    mix.start()
    enc.start()
    post = Poster(mix.name)
    try:
        assert coord.get_prefix("XLLM:INSTANCE:ENCODE:"), "no ENCODE agent"
        reset_counts()
        cached0 = mix.engine.stats()["cached_blocks"]

        def dispatch(sid, msgs, images):
            sent_at[sid] = time.monotonic()
            status, reply = post("/v1/chat/completions", dict(
                service_request_id=sid, request_id=sid, messages=msgs,
                source_service_addr=master.addr,
                routing=StubMaster.routing(coord, images), **greedy))
            assert status == 200, (sid, status, reply)

        deltas = []
        poll = threading.Event()

        def watch():
            # The slot registers on the engine thread, between steps.
            while not poll.is_set():
                d = mix.engine._on_loop(
                    lambda: [mix.engine._mrope_delta[s].item()
                             for s in list(mix.engine._running)])
                deltas.extend(x for x in d if x)
                time.sleep(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t0 = time.monotonic()
        for sid, msgs in chats.items():
            dispatch(sid, msgs, True)
        master.wait(lambda: all(map(master.finished, chats)),
                    "the image chats")
        wall = time.monotonic() - t0
        poll.set()
        watcher.join()
        cached1 = mix.engine.stats()["cached_blocks"]
        for sid, msgs in texts.items():
            dispatch(sid, msgs, False)
        master.wait(lambda: all(map(master.finished, texts)),
                    "the text chats")
        names = list(chats) + list(texts)
        toks = {n: check_deltas(n, master.gens[n], mix)[0] for n in names}
        stats = mix.engine.stats()
        graph = stats["decode_graph"]
        k1, k2 = paged_attention.launches, mq_paged_attention.launches
        ttft = sorted((master.first[n] - sent_at[n]) * 1e3 for n in chats)
        tps = sum(len(toks[n]) for n in chats) / wall
        log(f"  (b) {len(chats)} image chats through the MIX agent, vision "
            f"on the ENCODE agent: TTFT ms p50 {ttft[len(ttft) // 2]:.1f} "
            f"max {ttft[-1]:.1f}; {tps:.1f} generated tok/s (information "
            f"only; {card}); encodes {enc.encode_count} there, "
            f"{mix.encode_count} here; cached blocks {cached0} -> "
            f"{cached1} over the image chats; launches: kernel 1 {k1}, "
            f"kernel 2 {k2}; graph {graph}; non-zero deltas seen "
            f"{sorted(set(deltas))}")
        assert all(len(toks[n]) == 32 for n in names), "short streams"
        assert enc.encode_count == len(chats) and mix.encode_count == 0, \
            "the vision stage did not run on the ENCODE agent"
        assert cached1 == cached0, "an image chat donated prefix blocks"
        assert deltas, "no slot held a non-zero M-RoPE delta"
        check_replays(stats, "qwen2-vl-2b")
        assert k1 == mcfg.num_layers * (graph["replays"]
                                        + graph["captures"]), \
            f"qwen2-vl: kernel 1 launched {k1} times, not " \
            f"{mcfg.num_layers} a step"
        assert toks["same-a"] != toks["same-b"], \
            "two chats differing only in their image gave the same tokens"

        # Each image chat's tokens against an in-process engine on the
        # same token ids and visual rows (the agent's own tokens and
        # pixels, encoded by the ENCODE agent's encoder).
        ref = engine_mod.InferenceEngine(cfg, params=params)
        try:
            cols = {}
            for sid, msgs in chats.items():
                ids = mix._build_mm_token_ids(msgs)
                mm = enc._encode_local(mix._extract_images(msgs))
                cols[sid] = Collector()
                ref.submit(engine_mod.EngineRequest(
                    sid, token_ids=ids, mm_embeds=mm.reshape(
                        -1, mm.shape[-1]),
                    sampling=_greedy_sampling(32), on_output=cols[sid]))
            ref.start()
            for c in cols.values():
                assert c.done.wait(300), "in-process engine stalled"
        finally:
            ref.stop()
        same = [n for n in chats if cols[n].tokens == toks[n]]
        log(f"  (b) {len(same)}/{len(chats)} image chats equal the "
            "in-process engine's tokens")
        assert len(same) == len(chats), \
            f"agent and engine differ: {sorted(set(chats) - set(same))}"
        return k1, k2, chats, {n: toks[n] for n in chats}
    finally:
        post.close()
        mix.stop()
        enc.stop()
        master.close()
        store.close()
        del mix, enc
        gc.collect()
        torch.cuda.empty_cache()


def _greedy_sampling(n):
    from xllm_service_tpu_torch.common.request import SamplingParams

    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True)


def vl_chunked_leg(engine_mod, cfg, params, mm, kernels, card):
    """4n (c): a two-image prompt of 360 tokens chunked by 128 against the
    same prompt installed whole, in f32 at full width and depth (the LM's
    weights cast up; the visual rows are (a)'s first two images): the
    greedy tokens must be equal, and the chunks behind the first run
    kernel 2 (its f32 walk at group 6). Returns kernel 2's launches."""
    from dataclasses import replace

    paged_attention, mq_paged_attention = kernels
    f32 = cast_tree({k: v for k, v in params.items() if k != "vision"},
                    torch.float32)
    mcfg = replace(cfg.model, dtype=torch.float32)
    img = mcfg.image_token_id
    n_img = mcfg.vision.out_tokens
    rng = np.random.default_rng(43)
    text = [int(x) for x in rng.integers(3, 150000, size=232)]
    prompt = text[:70] + [img] * n_img + text[70:150] + [img] * n_img \
        + text[150:]
    assert len(prompt) >= 300
    rows = mm[:2].reshape(-1, mm.shape[-1]).float().cpu().numpy()
    out = {}
    for chunk in (0, 128):
        c = replace(cfg, model=mcfg, prefill_chunk_tokens=chunk,
                    max_batch_size=2)
        eng = engine_mod.InferenceEngine(c, params=f32)
        reset_counts()
        try:
            col = Collector()
            eng.submit(engine_mod.EngineRequest(
                f"c{chunk}", token_ids=prompt, mm_embeds=rows,
                sampling=_greedy_sampling(16), on_output=col))
            eng.start()
            assert col.done.wait(300), "chunked VL prompt stalled"
        finally:
            eng.stop()
        out[chunk] = (col.tokens, mq_paged_attention.launches,
                      paged_attention.launches)
    log(f"  (c) {len(prompt)}-token prompt with two images, f32: chunks of "
        f"128 {out[128][0][:8]}... whole {out[0][0][:8]}...; kernel 2 "
        f"launches {out[128][1]} chunked, {out[0][1]} whole")
    assert len(out[128][0]) == 16 and out[128][0] == out[0][0], \
        "the chunked VL prompt's tokens differ from the whole install's"
    assert out[128][1] >= 2 * mcfg.num_layers, \
        "the chunks did not run kernel 2"
    del f32
    return out[128][1], out[128][2] + out[0][2]


VL_PD_PROBE = "i0"   # the image chat whose pages phase 4n (e) holds


def vl_streams_recomputed(llama, qwen2_vl, cfg, params, sent, rows, toks,
                          what):
    """Qwen2-VL streams against their recomputation: each prompt and its
    stream but the last token through one prefill (the visual rows
    spliced in, M-RoPE positions of the whole sequence), whose logits at
    every position must give each stream token as the argmax or a
    near-tie (``compare_streams``' rule: one of the two largest values,
    within TIE_STEPS bf16 steps of the top)."""
    m = cfg.model
    i32 = dict(dtype=torch.int32, device="cuda")
    checked = exact = 0
    for name, gen in toks.items():
        prompt = sent[name]
        whole = prompt + gen[:-1]
        pos, _ = qwen2_vl.mrope_positions(whole, m.image_token_id)
        n_pages = -(-len(whole) // cfg.page_size)
        kv = empty_pool(cfg, n_pages + 1, "cuda")
        pt = torch.arange(1, n_pages + 1, **i32)[None]
        mm = rows.get(name)
        x = qwen2_vl.splice_mm_embeds(
            params, m, torch.tensor([whole], **i32),
            None if mm is None else torch.from_numpy(mm).cuda()[None])
        logits = llama.prefill_from_embeddings(
            params, m, x, torch.from_numpy(pos).cuda()[None], kv, pt,
            torch.zeros((1,), **i32), torch.tensor([len(whole)], **i32),
            has_prefix=False, all_logits=True)[0][0]
        for j, tok in enumerate(gen):
            rank, gap, tol = tie_rank(logits[len(prompt) - 1 + j], tok)
            assert rank <= 2 and gap <= tol, \
                f"{what}: {name} token {j} ({tok}) is no near-tie: rank " \
                f"{rank}, {gap:.4g} below the top (tol {tol:.4g})"
            checked += 1
            exact += rank == 1
        del kv, logits
    log(f"  {what}: {checked} greedy tokens against their recomputation: "
        f"{exact} the argmax, {checked - exact} near-ties")


def vl_seq_leg(engine_mod, llama, qwen2_vl, cfg, params, mm, kernels, card):
    """4n (d): Qwen2-VL-2B on a seq=4 pool (``seq_mesh4``), then on one
    device on the same weights: two image prompts ((a)'s visual rows; an
    image prompt never takes the ring) and a 1101-token text prompt (the
    ring: its suffix and its M-RoPE rows padded by three), MOE_NEW tokens
    each. Checks: one ring route, kernel 6 at group 6 (12/2 heads) once a
    layer and shard every step, kernels 1, 2 and 3 idle, and the tokens
    against the one-device engine's: equal, or parted where both streams
    pass their recomputation (``vl_streams_recomputed``). Returns kernel
    6's launches and the one-device run's launches of kernel 1."""
    from dataclasses import replace

    paged, mq, fused, partial = kernels
    m = cfg.model
    L, img, n_img = m.num_layers, m.image_token_id, m.vision.out_tokens
    rng = np.random.default_rng(47)
    text = [int(x) for x in rng.integers(3, 150000, size=1101)]
    prompts = {"text": text,
               "i0": text[:40] + [img] * n_img + text[40:100],
               "i1": text[200:230] + [img] * n_img + text[230:260]
               + [img] * n_img + text[260:300]}
    D = m.hidden_size
    rows = {"i0": mm[0].float().cpu().numpy(),
            "i1": mm[1:3].reshape(-1, D).float().cpu().numpy()}
    scfg = replace(cfg, seq_parallel_min_tokens=1024)
    reset_counts()
    toks, st, wall = serve_greedy(engine_mod, scfg, params, prompts,
                                  mesh=seq_mesh4(), mm=rows)
    k1, k2, k3, k6 = (fn.launches for fn in (paged, mq, fused, partial))
    steps = st["eager_steps"]
    log(f"  (d) qwen2-vl-2b on a seq=4 pool, shards {st['pool']}: "
        f"{len(toks)} requests of {MOE_NEW} tokens in {wall:.1f} s "
        f"({sum(map(len, toks.values())) / wall:.1f} generated tok/s, "
        f"eager; information only, {card}); ring prefills "
        f"{st['ring_prefills']}, {steps} decode steps; kernels 1/2/3/6 "
        f"{k1}/{k2}/{k3}/{k6}")
    assert st["ring_prefills"] == 1, "the ring did not take the text prompt"
    assert (k1, k2, k3) == (0, 0, 0), "kernel 1, 2 or 3 ran on the seq mesh"
    assert k6 == 4 * L * steps, \
        f"kernel 6 launched {k6} times, not {4 * L} a step for {steps}"
    reset_counts()
    want, _, _ = serve_greedy(engine_mod, cfg, params, prompts, mm=rows)
    one = paged.launches
    parted = [n for n in toks if toks[n] != want[n]]
    log(f"  (d) seq=4 vs one device: {len(toks) - len(parted)}/{len(toks)} "
        f"greedy streams equal; parted {parted}")
    for side, streams in (("seq=4", toks), ("one device", want)):
        if not parted:
            break
        vl_streams_recomputed(llama, qwen2_vl, cfg, params, prompts, rows,
                              {n: streams[n] for n in parted},
                              f"(d) the parted streams ({side})")
    return k6, one


def vl_pd_plane(cfg):
    """4n (e)'s plane (``decode_plane``): the DECODE agent of
    ``--model-config qwen2_vl_2b``, started ahead of 4n's legs."""
    return decode_plane(["--decode-agent", VL_PD_PROBE],
                        ["--model-config", "qwen2_vl_2b", "--model-id",
                         "qwen2-vl-2b"], cfg, "phase4n_decode_agent.log")


def vl_pd_leg(cfg, params, chats, want, card, plane):
    """4n (e): a PREFILL agent here (encoding its images itself) and a
    DECODE agent in a second process (``plane``'s: the agent's entry
    point, ``--model-config qwen2_vl_2b``, the same seed), behind the
    stub master, the KV over CUDA IPC: six of (b)'s image chats, MOE_NEW
    tokens each. Checks: every handoff on the device path, kernel 4 once
    a handoff here and bit for bit equal to the plain gather, kernel 5
    once a handoff there and kernel 1 there, the probe chat's installed
    pages equal to its extracted buffer bit for bit, and every stream
    equal to the first MOE_NEW tokens of (b)'s (its in-process engine's).
    Returns the launches of kernels 1, 4 and 5."""
    from xllm_service_tpu_torch.common.types import InstanceType
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
    )
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.ops import page_dma

    store, coord, master, child = plane
    pre = None
    try:
        pre = EngineAgent(cfg, AgentConfig(
            instance_type=InstanceType.PREFILL, model_id="qwen2-vl-2b",
            heartbeat_interval_s=1.0), coord=InMemoryCoordination(store),
            params=params, device="cuda")
        pre.start()
        names = list(chats)[:6]
        assert VL_PD_PROBE in names
        reqs = {n: dict(messages=chats[n], max_tokens=MOE_NEW,
                        temperature=0.0, ignore_eos=True) for n in names}
        toks, handoff, bad, digests, dl, reg_s = pd_pair_run(
            pre, child, master, store, reqs, VL_PD_PROBE,
            "/v1/chat/completions")
        n = len(reqs)
        g4 = page_dma.gather_kv_pages.launches
        ms = sorted(handoff.values())
        same = [nm for nm in names if toks[nm] == want[nm][:MOE_NEW]]
        log(f"  (e) qwen2-vl-2b PD pair: decode agent registered after "
            f"{reg_s:.1f} s; {n} image chats handed off on the CUDA IPC "
            f"path, handoff ms (device offer + pull spans) p50 "
            f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f} (information only; "
            f"{card}); kernel 4 here {g4}, "
            f"kernel 5 there {dl['scatter_kv_pages']}, kernel 1 there "
            f"{dl['paged_attention']}; extracts differing from the plain "
            f"gather {sum(bad)}; {VL_PD_PROBE} extracted / installed "
            f"{digests}; {len(same)}/{n} streams equal to (b)'s")
        assert len(bad) == n and not any(bad), "kernel 4 at a handoff"
        assert g4 == n and dl["scatter_kv_pages"] == n, \
            "not one gather here and one scatter there a handoff"
        assert dl["paged_attention"] > 0, "kernel 1 idle on the decode side"
        assert digests[0] is not None and digests[0] == digests[1], \
            "the installed pages differ from the extracted buffer"
        assert len(same) == n, \
            f"PD streams differ from (b)'s: {sorted(set(names) - set(same))}"
        return dl["paged_attention"], g4, dl["scatter_kv_pages"]
    except BaseException:
        log(f"  the decode agent's log, last lines:\n{child.tail()}")
        raise
    finally:
        child.close()
        if pre is not None:
            pre.stop()
        master.close()
        coord.close()
        store.close()
        del pre
        gc.collect()
        torch.cuda.empty_cache()


def vl_phase(engine_mod, kernels, card):
    """Phase 4n: Qwen2-VL-2B at full width and depth on random weights
    (seed 0), bf16, page 16: (a) the encoder, (b) EPD through a MIX and an
    ENCODE agent, (c) a chunked multimodal prompt, (d) a seq=4 pool, (e) a
    PD pair over CUDA IPC. Returns the launches of kernels 1, 2, 4, 5 and
    6 in (b) to (e)."""
    from xllm_service_tpu_torch.engine import EngineConfig
    from xllm_service_tpu_torch.models import llama, qwen2_vl

    mcfg = qwen2_vl.qwen2_vl_2b_config()
    t = time.monotonic()
    params = qwen2_vl.init_params(
        mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n = sum(x.numel() for x in _tree_tensors(params))
    nv = sum(x.numel() for x in _tree_tensors(params["vision"]))
    log(f"  qwen2-vl-2b: {n / 1e9:.2f} B weights ({nv / 1e9:.2f} B in the "
        f"vision tower) in {time.monotonic() - t:.1f} s; "
        f"{mcfg.num_heads}/{mcfg.num_kv_heads} heads (group "
        f"{mcfg.num_heads // mcfg.num_kv_heads}), mrope {mcfg.mrope_section}")
    cfg = EngineConfig(model=mcfg, model_family="qwen2_vl", num_pages=1024,
                       page_size=16, hash_block_size=128, max_batch_size=8,
                       max_seq_len=2048, decode_horizon=8, seed=0)
    # (e)'s decode agent starts now: its start overlaps (a) to (d).
    plane = vl_pd_plane(cfg)
    try:
        t = time.monotonic()
        mm = vl_encoder_check(qwen2_vl, mcfg, params, card)
        log(f"  (a) {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        b1, b2, chats, chat_toks = vl_agents_leg(engine_mod, cfg, params,
                                                 kernels[:2], card)
        log(f"  (b) {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        c2, c1 = vl_chunked_leg(engine_mod, cfg, params, mm, kernels[:2],
                                card)
        log(f"  (c) {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        d6, d1 = vl_seq_leg(engine_mod, llama, qwen2_vl, cfg, params, mm,
                            kernels, card)
        log(f"  (d) {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        e1, e4, e5 = vl_pd_leg(cfg, params, chats, chat_toks, card, plane)
        plane = None             # closed by the leg
        log(f"  (e) {time.monotonic() - t:.1f} s")
        return dict(paged=b1 + c1 + d1 + e1, mq=b2 + c2, partial=d6,
                    gather=e4, scatter=e5)
    finally:
        if plane is not None:
            close_plane(plane)
        del params
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4p
MH_NEW = {"a": 16, "c": 16, "d": 16}     # tokens a stream, by leg
MH_TP_LAYERS = 4      # (a): Llama-3-8B cut to these layers
MH_MOE_LAYERS = 4     # (c): Mixtral-8x7B int8 cut to these layers
MH_SEQ_LAYERS = 4     # (d): Llama-3-8B cut to these layers
MH_AGENT_NEW = 8      # (b): tokens a completion
MH_AGENT_LAYERS = 4   # (b): Llama-3-8B cut to these layers in both ranks
MH_WORLD = {"a": 2, "c": 4, "d": 2}
MH_AXES = {"a": dict(model=2), "c": dict(expert=2, model=2),
           "d": dict(seq=2)}
# Phase 4q's legs on the same machinery: (b) Mixtral-8x7B int8 at
# MH_MOE_LAYERS layers on seq=2 x expert=2 in one process, its first
# prompt of 700 tokens on the ring (GRID_RING_MIN); (d) Llama-3-8B at
# MH_SEQ_LAYERS layers on seq=2 x model=2 as four ranks.
GRID_RING_MIN = 512
MH_NEW.update(qb=16, qd=16)
MH_WORLD.update(qd=4)
MH_AXES.update(qb=dict(seq=2, expert=2), qd=dict(seq=2, model=2))
MH_SAMPLING = dict(temperature=0.8, top_p=0.95, seed=5, ignore_eos=True)


def phase4_config():
    """Phase 4's engine configuration: Llama-3-8B at full width and
    depth."""
    from xllm_service_tpu_torch.engine import EngineConfig
    from xllm_service_tpu_torch.models.base import llama3_8b_config

    return EngineConfig(model=llama3_8b_config(),
                        num_pages=2048, page_size=16, hash_block_size=128,
                        max_batch_size=8, max_seq_len=2048, decode_horizon=8,
                        admission_horizon=8, seed=0)


def mh_config(leg):
    """The engine configuration of phase 4p's leg ``leg``, the same in this
    process and in its ranks (random weights from seed 0)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.engine import EngineConfig
    from xllm_service_tpu_torch.models import mixtral
    from xllm_service_tpu_torch.models.base import llama3_8b_config

    if leg == "a":
        cfg = phase4_config()
        return replace(cfg, model=replace(cfg.model,
                                          num_layers=MH_TP_LAYERS))
    if leg in ("c", "qb"):
        mcfg = replace(mixtral.mixtral_8x7b_config(), quant="int8",
                       num_layers=MH_MOE_LAYERS)
        cfg = EngineConfig(model=mcfg, model_family="mixtral",
                           num_pages=512, page_size=16, hash_block_size=128,
                           max_batch_size=8, max_seq_len=2048,
                           decode_horizon=8, admission_horizon=8, seed=0)
        return (replace(cfg, seq_parallel_min_tokens=GRID_RING_MIN)
                if leg == "qb" else cfg)
    return EngineConfig(model=replace(llama3_8b_config(),
                                      num_layers=MH_SEQ_LAYERS),
                        num_pages=2048, page_size=16, hash_block_size=128,
                        max_batch_size=8, max_seq_len=2048, decode_horizon=8,
                        admission_horizon=8, seed=0)


def mh_traffic(leg, V):
    """Phase 4p's (and 4q's) requests of leg ``leg``: four prompts at once
    (on 4p (d) and 4q (d) the first is 1101 tokens and prefix-free: the
    ring; on 4q (b) its 700 take the ring too), two more sharing the
    first's first 512 tokens once it has its first token (prefix hits),
    and one seeded sampled request. Returns (prompts, shared, sampled)."""
    rng = np.random.default_rng({"a": 40, "c": 41, "d": 42, "qb": 44,
                                 "qd": 45}[leg])
    first = 1101 if leg in ("d", "qd") else 700
    lens = [first, 300, 90, 500]
    prompts = {f"g{i}": rng.integers(3, V, size=n).tolist()
               for i, n in enumerate(lens)}
    shared = {f"s{j}": prompts["g0"][:512]
              + rng.integers(3, V, size=n).tolist()
              for j, n in enumerate((100, 60))}
    return prompts, shared, rng.integers(3, V, size=200).tolist()


def mh_drive(submit, step, prompts, shared, sampled, max_tokens):
    """Phase 4p's schedule, the same for a one-process engine (``step`` its
    ``step``) and for the ranks' primary (the driver's ``tick``): the
    prompts and the sampled request at once, the shared ones once the
    first prompt has its first token, then steps until every request is
    done. Returns the collectors by name."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    greedy = SamplingParams(max_tokens=max_tokens, temperature=0.0,
                            ignore_eos=True)
    cols = {}
    for name, toks in prompts.items():
        cols[name] = Collector()
        submit(name, toks, greedy, cols[name])
    cols["sampled"] = Collector()
    submit("sampled", sampled,
           SamplingParams(max_tokens=max_tokens, **MH_SAMPLING),
           cols["sampled"])
    first = cols[next(iter(prompts))]
    for _ in range(100000):
        if shared and first.first.is_set() and \
                not any(n in cols for n in shared):
            for name, toks in shared.items():
                cols[name] = Collector()
                submit(name, toks, greedy, cols[name])
        if len(cols) == len(prompts) + len(shared) + 1 and \
                all(c.done.is_set() for c in cols.values()):
            return cols
        step()
    raise AssertionError("phase 4p's requests never finished")


def mh_kernels():
    """The kernel wrappers a rank counts: kernels 1, 2, 3 and 6."""
    from xllm_service_tpu_torch.ops.cp_paged_attention import paged_partial
    from xllm_service_tpu_torch.ops.fused_decode_attention import (
        fused_decode_attention,
    )
    from xllm_service_tpu_torch.ops.mq_paged_attention import (
        mq_paged_attention,
    )
    from xllm_service_tpu_torch.ops.paged_attention import paged_attention

    return {"paged_attention": paged_attention,
            "mq_paged_attention": mq_paged_attention,
            "fused_decode_attention": fused_decode_attention,
            "cp_paged_partial": paged_partial}


def mh_rank_child(argv) -> int:
    """``python3 chip_smoke.py --mh-rank LEG RANK WORLD PORT``: one rank of
    phase 4p's leg LEG, a process of a gloo group of WORLD over
    ``127.0.0.1:PORT``, its coordinates of the leg's mesh on ``cuda:0``
    (``process_mesh``: the card shared by every rank). It builds the leg's
    engine (the weights drawn from seed 0, only its shards kept), then the
    primary drives ``mh_drive``'s schedule through the lockstep driver and
    the followers run its loop until the shutdown event. It prints one
    line ``RESULT {...}``: its tokens (a follower's are the deltas its
    sink drops), its kernel launches, the driver's ticks and the eager
    decode steps, the control plane's and the collectives' calls and
    seconds, its memory and the data plane's backend."""
    import logging

    from xllm_service_tpu_torch.common.request import RequestOutput
    from xllm_service_tpu_torch.engine import engine as engine_mod
    from xllm_service_tpu_torch.engine import multihost_driver as md
    from xllm_service_tpu_torch.parallel import multihost
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, process_mesh

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)"
                        ".1s %(name)s: %(message)s")
    leg, rank, world, port = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = mh_kernels()
    KERNEL_WRAPPERS.extend(kernels.values())
    multihost.initialize(f"127.0.0.1:{port}", world, rank, timeout_s=300)
    cfg = mh_config(leg)
    mcfg = MeshConfig(**MH_AXES[leg])
    mesh = process_mesh(mcfg, [torch.device("cuda", 0)]
                        * (mcfg.num_devices() // world))
    t = time.monotonic()
    eng = engine_mod.InferenceEngine(cfg, mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t
    load_peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps = [0]
    decode_step = eng._decode_step

    def counted(*args):
        steps[0] += 1
        return decode_step(*args)

    eng._decode_step = counted
    drv = md.MultihostEngineDriver(eng)
    prompts, shared, sampled = mh_traffic(leg, cfg.model.vocab_size)
    streams: dict = {}

    def sink(out: RequestOutput):
        streams.setdefault(out.service_request_id, []).extend(
            tk for s in out.outputs for tk in s.token_ids)

    md._drop = sink
    reset_counts()
    multihost.reset_stats()
    ticks = [0]
    tick = drv.tick

    def counted_tick():
        ticks[0] += 1
        return tick()

    drv.tick = counted_tick
    t0 = time.monotonic()
    if rank == 0:
        cols = mh_drive(
            lambda n, toks, sp, col: drv.submit(engine_mod.EngineRequest(
                n, token_ids=toks, sampling=sp, on_output=col)),
            drv.tick, prompts, shared, sampled, MH_NEW[leg])
        wall = time.monotonic() - t0
        streams = {n: c.tokens for n, c in cols.items()}
        drv.shutdown()
        while drv.tick():
            pass
    else:
        drv.follower_loop()
        wall = time.monotonic() - t0
    torch.cuda.synchronize()
    report = {
        "rank": rank, "tokens": streams, "wall_s": wall, "build_s": build_s,
        "launches": {k: fn.launches for k, fn in kernels.items()},
        "ticks": ticks[0], "decode_steps": steps[0],
        "ring_prefills": eng.ring_prefills,
        "prefix_hits": eng.stats()["prefix_hits"],
        "stats": dict(multihost.STATS), "backend": multihost.backend(),
        "load_peak": load_peak, "held": held,
        "serve_peak": torch.cuda.max_memory_allocated(),
        "pool": [list(s.shape) for s in eng.kv_pages.shards],
        "shards": (eng.params.coords if hasattr(eng.params, "coords")
                   else None)}
    eng.stop()
    print("RESULT " + json.dumps(report), flush=True)
    return 0


def mh_spawn(head, world, log_name, env=None):
    """``world`` processes of this script (``head`` + the rank's index +
    the rest of its arguments, as ``head(rank)`` gives them), each logging
    to ``build/<log_name>.<rank>.log``. Returns [(process, log path)]."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    out = []
    for r in range(world):
        path = os.path.join(root, "build", f"{log_name}.{r}.log")
        out.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *head(r)], cwd=root,
            stdout=subprocess.PIPE, stderr=open(path, "w"), text=True,
            env={**os.environ, **(env(r) if env else {})}), path))
    return out


def mh_reap(procs, timeout, tag="RESULT "):
    """Each process's ``tag`` line, parsed, once every process has exited
    0 (a non-zero exit or the time limit fails the phase with the last
    lines of every failed process's log). Every process is gone when this
    returns."""
    import subprocess

    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p, _ in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = []
    for (p, path), out in zip(procs, outs):
        if p.returncode != 0:
            with open(path) as f:
                tail = "".join(f.readlines()[-25:])
            failed.append(f"{path} exited {p.returncode}:\n{tail}")
    assert not failed, "\n".join(failed)
    results = []
    for (_, path), out in zip(procs, outs):
        line = next((ln for ln in out.splitlines() if ln.startswith(tag)),
                    None)
        assert line is not None, f"{path} printed no {tag.strip()}"
        results.append(json.loads(line[len(tag):]))
    return results


def mh_start(leg):
    """Leg ``leg``'s ranks, started together: (processes, start time)."""
    from xllm_service_tpu_torch.common.net import pick_free_port

    port = str(pick_free_port("127.0.0.1"))
    world = MH_WORLD[leg]
    return (mh_spawn(lambda r: ["--mh-rank", leg, str(r), str(world), port],
                     world, f"phase4p_{leg}"), time.monotonic())


def mh_ranks(leg, card, started=None):
    """Leg ``leg``'s ranks (``started`` by ``mh_start`` while this process
    drew its reference, or started now): their RESULTs, rank order."""
    procs, t = started or mh_start(leg)
    res = mh_reap(procs, 600)
    log(f"  ({leg}) {MH_WORLD[leg]} ranks done in {time.monotonic() - t:.1f}"
        " s (their start, the draw and the serving)")
    return res


def mh_reference(leg, started, one_process):
    """``one_process()`` while ``started``'s ranks start; the ranks are
    killed if it fails."""
    try:
        return one_process()
    except BaseException:
        for p, _ in started[0]:
            p.kill()
            p.wait()
        raise


def mh_report(leg, ranks, card, what):
    """Log each rank's figures and check the lockstep: every follower
    emitted the primary's tokens, every rank the same steps, prefix hits
    and backend. Returns the launches summed over the ranks."""
    primary = ranks[0]
    gib = 2 ** 30
    for r in ranks:
        st = r["stats"]
        ticks = max(1, r["ticks"])
        log(f"  ({leg}) rank {r['rank']} {r['shards'] or ''}: pool "
            f"{r['pool']}; weights and pool {r['held'] / gib:.2f} GiB held "
            f"after the build ({r['build_s']:.1f} s; peak while building "
            f"{r['load_peak'] / gib:.2f} GiB), peak while serving "
            f"{r['serve_peak'] / gib:.2f} GiB; launches {r['launches']}; "
            f"{r['ticks']} ticks, {r['decode_steps']} decode steps; "
            f"broadcast_bytes "
            f"{1e3 * st['broadcast_s'] / max(1, st['broadcast_calls']):.3f} "
            f"ms a tick ({st['broadcast_calls']} calls); collectives "
            f"{1e3 * st['collective_s'] / max(1, r['decode_steps']):.2f} ms "
            f"a decode step, the prefills' included "
            f"({1e3 * st['collective_s'] / ticks:.2f} ms a tick; "
            f"{st['collective_calls']} calls, "
            f"{st['collective_bytes'] / 2**20:.1f} MiB sent, "
            f"{1e3 * st['collective_s'] / max(1, st['collective_calls']):.3f} ms a call); "
            f"backend {r['backend']} (information only; {card})")
    n_tok = sum(map(len, primary["tokens"].values()))
    log(f"  ({leg}) {what}: {len(primary['tokens'])} requests, {n_tok} "
        f"tokens in {primary['wall_s']:.1f} s ({n_tok / primary['wall_s']:.1f} "
        f"generated tok/s over the ranks' lockstep; information only, "
        f"{card})")
    for r in ranks:
        assert r["backend"] == "gloo", "ranks on one card took another backend"
        assert r["tokens"] == primary["tokens"], \
            f"rank {r['rank']} emitted other tokens than the primary"
        assert (r["ticks"], r["decode_steps"], r["prefix_hits"]) == \
            (primary["ticks"], primary["decode_steps"],
             primary["prefix_hits"]), f"rank {r['rank']} left the lockstep"
    assert primary["prefix_hits"] >= 2, "no prefix hits over the ranks"
    return {k: sum(r["launches"][k] for r in ranks)
            for k in primary["launches"]}


def mh_one_process(engine_mod, leg, params, mesh):
    """Leg ``leg``'s schedule on one process's engine over ``mesh`` (this
    card repeated): (tokens by name, the engine's params, stats)."""
    cfg = mh_config(leg)
    eng = engine_mod.InferenceEngine(cfg, params=params, mesh=mesh)
    prompts, shared, sampled = mh_traffic(leg, cfg.model.vocab_size)
    cols = mh_drive(
        lambda n, toks, sp, col: eng.submit(engine_mod.EngineRequest(
            n, token_ids=toks, sampling=sp, on_output=col)),
        eng.step, prompts, shared, sampled, MH_NEW[leg])
    out = ({n: c.tokens for n, c in cols.items()}, eng.params,
           dict(eng.stats(), ring_prefills=eng.ring_prefills))
    eng.stop()
    return out


def mh_compare(moe_or_llama, leg, got, want, params, served, routed, what):
    """The ranks' streams against one process's: the greedy ones by
    ``held_to``'s rule; the sampled one must be equal where every greedy
    stream is (the same logits then drew the same tokens), else it is
    logged. Returns the greedy streams that parted."""
    cfg = mh_config(leg)
    prompts, shared, _ = mh_traffic(leg, cfg.model.vocab_size)
    sent = {**prompts, **shared}
    greedy = {n: got[n] for n in sent}
    for n, t in got.items():
        assert len(t) == MH_NEW[leg], f"{n}: {len(t)} tokens"
    parted = held_to(moe_or_llama, cfg, params, sent, greedy,
                     {n: want[n] for n in sent}, what, routed=routed,
                     served_params=served)
    same = got["sampled"] == want["sampled"]
    log(f"  {what}: the seeded sampled stream "
        f"{'equal' if same else 'parted'} ({MH_SAMPLING})")
    if not parted:
        assert same, "the sampled stream parted where every greedy " \
            "stream held"
    return parted


def mh_agent_child(argv) -> int:
    """``python3 chip_smoke.py --mh-agent RANK WORLD PORT ARGS...``: one
    rank of phase 4p (b)'s agent, the agent's own entry point
    (``engine/agent.py::main`` with ARGS) under ``XLLM_MH_COORDINATOR``,
    ``XLLM_MH_NUM_HOSTS`` and ``XLLM_MH_HOST_ID``, the engine's mesh
    placed on ``cuda:0`` as ``process_mesh`` takes one (``--tp 2`` alone
    gives each rank a card of its own), the model cut to MH_AGENT_LAYERS
    layers (the agent's ``engine_config``). When the agent's main returns (a
    follower at the shutdown event) or exits (the primary after SIGTERM's
    drain) it prints ``REPORT {...}``: its kernel launches, the control
    plane's and collectives' figures and its memory."""
    import logging

    from xllm_service_tpu_torch.engine import agent as agent_mod
    from xllm_service_tpu_torch.engine import engine as engine_mod
    from xllm_service_tpu_torch.parallel import multihost
    from xllm_service_tpu_torch.parallel.mesh import process_mesh

    from dataclasses import replace

    rank, world, port, args = argv[0], argv[1], argv[2], argv[3:]
    os.environ.update(XLLM_MH_COORDINATOR=f"127.0.0.1:{port}",
                      XLLM_MH_NUM_HOSTS=world, XLLM_MH_HOST_ID=rank)
    engine_config = agent_mod.engine_config

    def cut(a):
        ecfg = engine_config(a)
        return replace(ecfg, model=replace(ecfg.model,
                                           num_layers=MH_AGENT_LAYERS))
    agent_mod.engine_config = cut
    kernels = mh_kernels()
    KERNEL_WRAPPERS.extend(kernels.values())

    def on_card(config, device, offset=0):
        return process_mesh(config, [torch.device("cuda", 0)]
                            * (config.num_devices()
                               // multihost.process_count()))

    engine_mod.mesh_from_config = on_card
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)"
                        ".1s %(name)s: %(message)s")
    try:
        agent_mod.main(args)
    finally:
        print("REPORT " + json.dumps({
            "rank": int(rank),
            "launches": {k: fn.launches for k, fn in kernels.items()},
            "stats": dict(multihost.STATS), "backend": multihost.backend(),
            "peak": torch.cuda.max_memory_allocated(),
            "held": torch.cuda.memory_allocated()}), flush=True)
    return 0


def mh_agent_leg(card):
    """4p (b): Llama-3-8B bf16 at full width and MH_AGENT_LAYERS layers
    served by the port's agent as two ranks on this card (``--tp 2``,
    ``--mh-agent``):
    the primary registers with the stub master through a coordination
    server here and serves four completions of MH_AGENT_NEW greedy
    tokens, dispatched as the master dispatches them; the follower mirrors
    them and exits 0 at the shutdown event that the primary's drain sends
    (SIGTERM). Returns the launches summed over both ranks."""
    import signal

    from xllm_service_tpu_torch.common.net import pick_free_port
    from xllm_service_tpu_torch.common.types import InstanceMetaInfo
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from xllm_service_tpu_torch.rpc import MASTER_KEY, instance_key

    cfg = phase4_config()
    store = MemoryStore()
    coord = CoordServer(store)
    master = StubMaster()
    InMemoryCoordination(store).set(MASTER_KEY, master.addr)
    port, http = pick_free_port("127.0.0.1"), pick_free_port("127.0.0.1")
    name = f"127.0.0.1:{http}"
    args = ["--coordination-addr", coord.addr, "--port", str(http),
            "--model-config", "llama3_8b", "--model-id", "llama3-8b",
            "--tp", "2", "--num-pages", "512",
            "--page-size", str(cfg.page_size),
            "--max-batch-size", str(cfg.max_batch_size),
            "--max-seq-len", str(cfg.max_seq_len),
            "--decode-horizon", str(cfg.decode_horizon)]
    procs = mh_spawn(lambda r: ["--mh-agent", str(r), "2", str(port), *args],
                     2, "phase4p_b")
    post = None
    try:
        t = time.monotonic()
        key = instance_key("MIX", name)
        while store.get(key) is None:
            assert all(p.poll() is None for p, _ in procs) and \
                time.monotonic() - t < 600, "the primary did not register"
            time.sleep(0.5)
        meta = InstanceMetaInfo.from_json(store.get(key))
        log(f"  (b) the primary registered after {time.monotonic() - t:.1f} "
            "s (both ranks' start and draw)")
        rng = np.random.default_rng(43)
        V = cfg.model.vocab_size
        requests = {f"c{i}": rng.integers(3, V, size=n).tolist()
                    for i, n in enumerate((400, 200, 120, 64))}
        post = Poster(name)
        t = time.monotonic()
        for sid, toks in requests.items():
            status, reply = post("/v1/completions", dict(
                service_request_id=sid, request_id=sid,
                source_service_addr=master.addr, token_ids=toks,
                max_tokens=MH_AGENT_NEW, temperature=0.0, ignore_eos=True))
            assert status == 200, (sid, status, reply)
        master.wait(lambda: all(map(master.finished, requests)),
                    "the ranks' completions", timeout=600)
        wall = time.monotonic() - t
        import types

        agent = types.SimpleNamespace(name=name,
                                      incarnation_id=meta.incarnation_id)
        toks = {n: check_deltas(n, master.gens[n], agent)[0]
                for n in requests}
        for n, tk in toks.items():
            assert len(tk) == MH_AGENT_NEW, f"{n}: {len(tk)} tokens"
            assert master.gens[n][-1]["outputs"][-1].get(
                "finish_reason") == "length", f"{n}: not 'length'"
        log(f"  (b) four completions through the primary: "
            f"{len(toks)} x {MH_AGENT_NEW} tokens in {wall:.1f} s "
            f"(information only; {card})")
        procs[0][0].send_signal(signal.SIGTERM)
        reports = mh_reap(procs, 300, tag="REPORT ")
        gib = 2 ** 30
        for r in reports:
            st = r["stats"]
            log(f"  (b) rank {r['rank']}: launches {r['launches']}; "
                f"{st['broadcast_calls']} ticks, broadcast_bytes "
                f"{1e3 * st['broadcast_s'] / max(1, st['broadcast_calls']):.3f} "
                f"ms a tick; collectives {st['collective_calls']} calls, "
                f"{st['collective_s']:.2f} s; peak {r['peak'] / gib:.2f} "
                f"GiB, held at exit {r['held'] / gib:.2f} GiB; backend "
                f"{r['backend']} ({card})")
        assert all(r["backend"] == "gloo" for r in reports)
        assert reports[0]["launches"] == reports[1]["launches"], \
            "the ranks launched other kernels"
        assert reports[0]["launches"]["paged_attention"] > 0
        log("  (b) the follower exited 0 at the shutdown event")
        return {k: sum(r["launches"][k] for r in reports)
                for k in reports[0]["launches"]}
    finally:
        if post is not None:
            post.close()
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        master.close()
        coord.close()
        store.close()


def mh_leg_a(engine_mod, llama, card):
    """4p (a): Llama-3-8B bf16 at full width and MH_TP_LAYERS layers on
    ``model=2`` as two ranks, against the one-process ``model=2`` engine
    (its weights drawn from seed 0 as the ranks draw theirs) driven by
    the same schedule: kernel 1 once a layer a step and kernel 2 on the
    prefix hits on each rank, each rank holding about half the weights
    and its half of the pool. Returns the launches summed over the
    ranks."""
    mesh = card_mesh(model=2)
    started = mh_start("a")
    want, served, st = mh_reference("a", started, lambda: mh_one_process(
        engine_mod, "a", None, mesh))
    log(f"  (a) the one-process model=2 engine: {st['prefix_hits']} prefix "
        f"hits, route {st['decode_route']}")
    torch.cuda.empty_cache()
    ranks = mh_ranks("a", card, started)
    launches = mh_report("a", ranks, card,
                         f"llama3-8b bf16 at {MH_TP_LAYERS} layers on "
                         "model=2 as two ranks")
    m = mh_config("a").model
    pool = 2048 * PS * 2 * m.num_layers * m.num_kv_heads * m.head_dim
    D, V = m.hidden_size, m.vocab_size
    tree = (m.num_layers * (D * (2 * m.q_size + 2 * m.kv_size)
                            + 3 * D * m.ffn_size + 2 * D)
            + 2 * V * D + D) * m.dtype_bytes
    for r in ranks:
        assert r["launches"]["paged_attention"] == \
            m.num_layers * r["decode_steps"], \
            "kernel 1 not once a layer a step on a rank"
        assert r["launches"]["mq_paged_attention"] >= m.num_layers
        assert r["pool"] == [[m.num_layers, 2, 2048, m.num_kv_heads // 2,
                              PS, m.head_dim]]
        assert r["held"] < 0.6 * tree + pool, \
            "a rank holds more than its half of the weights and pool"
    mh_compare(llama, "a", ranks[0]["tokens"], want, served, served,
               False, "(a) two ranks vs the one-process model=2 engine")
    return launches


def mh_leg_c(engine_mod, moe, card):
    """4p (c): Mixtral-8x7B int8 at full width, MH_MOE_LAYERS layers, on
    ``expert=2 x model=2`` as four ranks (each rank one (expert, model)
    coordinate), against the one-process engine on that mesh. The ranks
    run first: each draws the whole cut tree before it keeps its shards.
    Returns the launches summed over the ranks."""
    ranks = mh_ranks("c", card)
    launches = mh_report("c", ranks, card, f"mixtral-8x7b int8 at "
                         f"{MH_MOE_LAYERS} layers on expert=2 x model=2 as "
                         "four ranks")
    assert [tuple(r["shards"][0]) for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    m = mh_config("c").model
    for r in ranks:
        assert r["launches"]["paged_attention"] == \
            m.num_layers * r["decode_steps"]
    want, served, _ = mh_one_process(engine_mod, "c", None,
                                     card_mesh(expert=2, model=2))
    mh_compare(moe, "c", ranks[0]["tokens"], want, served, served, True,
               "(c) four ranks vs the one-process expert=2 x model=2 engine")
    return launches


def mh_leg_d(engine_mod, card):
    """4p (d): Llama-3-8B at MH_SEQ_LAYERS layers on ``seq=2`` as two
    ranks: the 1101-token prompt through the ring over the ranks (its K/V
    handed on through host memory), every decode step through kernel 6
    on each rank's pages and the partials merged over the ranks; every
    stream equal to the one-process ``seq=2`` engine's. Returns the
    launches summed over the ranks."""
    started = mh_start("d")
    want, _, st = mh_reference("d", started, lambda: mh_one_process(
        engine_mod, "d", None, card_mesh(seq=2)))
    torch.cuda.empty_cache()
    ranks = mh_ranks("d", card, started)
    launches = mh_report("d", ranks, card, f"llama3-8b at {MH_SEQ_LAYERS} "
                         "layers on seq=2 as two ranks")
    m = mh_config("d").model
    assert st["ring_prefills"] == 1
    for r in ranks:
        assert r["ring_prefills"] == 1, "the long prompt missed the ring"
        assert r["launches"]["cp_paged_partial"] == \
            m.num_layers * r["decode_steps"], \
            "kernel 6 not once a layer a step on a rank"
        assert r["launches"]["paged_attention"] == 0
    same = sum(ranks[0]["tokens"][n] == want[n] for n in want)
    log(f"  (d) two ranks vs the one-process seq=2 engine: {same}/"
        f"{len(want)} streams equal")
    assert ranks[0]["tokens"] == want, "a stream of the seq ranks parted"
    return launches


def mh_phase(engine_mod, llama, moe, card, before_d=None):
    """Phase 4p: one engine instance over processes, each rank a process on
    this card (gloo: NCCL refuses two ranks on one device): legs (a)-(d)
    (``mh_leg_a``, ``mh_agent_leg``, ``mh_leg_c``, ``mh_leg_d``).
    ``before_d`` runs before (d), whose two ranks leave room on the card
    for a later phase's processes to start. Returns the launches of
    kernels 1, 2 and 6 summed over every rank of every leg."""
    total = {"paged_attention": 0, "mq_paged_attention": 0,
             "cp_paged_partial": 0}
    for tag, leg in (("a", lambda: mh_leg_a(engine_mod, llama, card)),
                     ("b", lambda: mh_agent_leg(card)),
                     ("c", lambda: mh_leg_c(engine_mod, moe, card)),
                     ("d", lambda: mh_leg_d(engine_mod, card))):
        if tag == "d" and before_d is not None:
            before_d()
        t = time.monotonic()
        launches = leg()
        for k in total:
            total[k] += launches.get(k, 0)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  ({tag}): {time.monotonic() - t:.1f} s")
    return total


# ---------------------------------------------------------------- phase 4q
GRID_NEW = 8          # tokens a stream in 4q (a)
GRID_LAYERS = 8       # 4q (a): Llama-3-8B cut to these layers on the grid


def grid_serve(engine_mod, cfg, params, mesh, prompts, shared, sampled,
               new, kernels):
    """One engine on ``mesh`` (``params`` its tree, sharded or not) driven
    by ``mh_drive``'s schedule, its kernel counts zeroed just before.
    Returns (tokens by name, stats with the ring count and the eager decode
    steps, the launches of ``kernels`` by wrapper, wall s, peak bytes
    allocated while built and serving, the pool's shard shapes, the
    engine's tree)."""
    torch.cuda.reset_peak_memory_stats()
    eng = engine_mod.InferenceEngine(cfg, params=params, mesh=mesh)
    steps = [0]
    step = eng._decode_step

    def counted(*args):
        steps[0] += 1
        return step(*args)

    eng._decode_step = counted
    reset_counts()
    t0 = time.monotonic()
    cols = mh_drive(
        lambda n, toks, sp, col: eng.submit(engine_mod.EngineRequest(
            n, token_ids=toks, sampling=sp, on_output=col)),
        eng.step, prompts, shared, sampled, new)
    wall = time.monotonic() - t0
    launches = {fn: fn.launches for fn in kernels}
    stats = dict(eng.stats(), ring_prefills=eng.ring_prefills,
                 eager_steps=steps[0])
    pool = eng.kv_pages
    shapes = [tuple(x.shape) for part in getattr(pool, "shards", [pool])
              for x in getattr(part, "shards", [part])]
    served = eng.params
    eng.stop()
    peak = torch.cuda.max_memory_allocated()
    toks = {n: c.tokens for n, c in cols.items()}
    for n, t in toks.items():
        assert len(t) == new, f"{n}: {len(t)} tokens"
    del eng, pool
    gc.collect()
    torch.cuda.empty_cache()
    return toks, stats, launches, wall, peak, shapes, served


def grid_leg(engine_mod, llama, cfg, params, prompts, shared, sampled,
             kernels, card):
    """4q (a): Llama-3-8B bf16 at full width and GRID_LAYERS layers
    (``depth_view`` of phase 4's weights) on ``seq=2 x model=2``, as views
    (16/4 heads and ffn 7168 a model shard), its pool the page-and-head
    grid (each model shard's heads, their pages split over its seq line:
    four shards ``[GRID_LAYERS, 2, 1024, 4, 16, 128]``). Phase 4's first four prompts at once (each of
    GRID_RING_MIN tokens or more, prefix-free, on the ring), then, once the
    first has its first token, its re-send and phase 4's first shared
    prompt (two prefix hits), and a seeded sampled request, GRID_NEW tokens
    each. Checks: kernel 6 at 2 x 2 x GRID_LAYERS launches a step, kernels
    1 and 3 idle, kernel 2 on the prefix hits, the ring count, every greedy
    stream held to a one-device engine's on the same schedule and depth
    (``held_to``), one decode step's
    logits and the grid joined against the one-device route
    (``check_tp_logits``). Returns (kernel 2's and 6's launches, the
    mesh)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.parallel.sharding import shard_params

    paged, mq, fused, partial = kernels
    cfg, params = depth_view(cfg, params, GRID_LAYERS)
    mesh = card_mesh(seq=2, model=2)
    log(f"  mesh seq=2 x model=2 on {[str(d) for d in mesh.devices]}")
    sharded = shard_params(params, mesh, llama.LLAMA_STACKED_RULES)
    reqs = {f"g{i}": prompts[i] for i in range(4)}
    hits = {"r0": prompts[0], "s0": shared[0]}
    sent = {**reqs, **hits}
    want = grid_serve(engine_mod, cfg, params, None, reqs, hits, sampled,
                      GRID_NEW, kernels)[0]
    want = {n: want[n] for n in sent}
    rings = sum(len(p) >= GRID_RING_MIN for p in reqs.values())
    before = torch.cuda.memory_allocated()
    toks, st, launches, wall, peak, shapes, _ = grid_serve(
        engine_mod, replace(cfg, seq_parallel_min_tokens=GRID_RING_MIN),
        sharded, mesh, reqs, hits, sampled, GRID_NEW, kernels)
    k1, k2, k3, k6 = (launches[fn] for fn in (paged, mq, fused, partial))
    steps = st["eager_steps"]
    m = cfg.model
    gib = 2 ** 30
    n_tok = sum(map(len, toks.values()))
    log(f"  (a) llama3-8b on seq=2 x model=2, grid shards {shapes}: "
        f"{len(toks)} requests, {n_tok} tokens in {wall:.1f} s "
        f"({n_tok / wall:.1f} generated tok/s, eager; information only, "
        f"{card}); peak {peak / gib:.2f} GiB allocated ({before / gib:.2f} "
        f"before the engine: phase 4's weights); prefix hits "
        f"{st['prefix_hits']}, rings {st['ring_prefills']}, {steps} decode "
        f"steps, route {st['decode_route']}; kernels 1/2/3/6 "
        f"{k1}/{k2}/{k3}/{k6} ({k6 / max(1, steps):.0f} of kernel 6 a "
        "step)")
    assert shapes == [(m.num_layers, 2, cfg.num_pages // 2,
                       m.num_kv_heads // 2, PS, HD)] * 4, shapes
    assert st["decode_route"] == "eager" and st["prefix_hits"] >= 2
    assert st["ring_prefills"] == rings >= 1, \
        f"{st['ring_prefills']} rings, {rings} prompts long enough"
    assert k6 == 4 * m.num_layers * steps, \
        f"kernel 6 launched {k6} times, not {4 * m.num_layers} a step"
    assert k2 >= 2 * 2 * m.num_layers, "the prefix hits did not take kernel 2"
    assert k1 == 0 and k3 == 0, "kernel 1 or 3 ran on the grid"
    held_to(llama, cfg, params, sent, {n: toks[n] for n in sent}, want,
            f"(a) llama3-8b seq=2 x model=2 vs a one-device engine, "
            f"{GRID_LAYERS} layers", routed=False)
    check_tp_logits(llama, cfg, params, shared[0], mesh, sharded)
    return (k2, k6), mesh


def grid_moe_leg(engine_mod, moe, kernels, card):
    """4q (b): Mixtral-8x7B int8 at full width and MH_MOE_LAYERS layers
    on ``seq=2 x expert=2`` (its experts over ``expert``, its pool split
    over ``seq`` and held once), against the one-process ``expert=2``
    engine on the same weights (drawn once from seed 0; each engine's
    shards are views), both driven by ``mh_drive``'s schedule of leg
    ``qb`` (its 700-token first prompt on the ring): kernel 6 at 2 x 4 a
    step, kernel 1 idle, the ring once, the greedy streams by ``held_to``'s
    rule (routing near-ties counted); the seeded sampled stream's equality
    is information (two attention routes round apart). Returns (kernel
    2's and 6's launches)."""
    from xllm_service_tpu_torch.models.base import get_model_family

    paged, mq, fused, partial = kernels
    cfg = mh_config("qb")
    m = cfg.model
    tree = get_model_family("mixtral").init_params(
        m, torch.Generator(device="cuda").manual_seed(cfg.seed), "cuda")
    prompts, shared, sampled = mh_traffic("qb", m.vocab_size)
    want, st_e, *_, ep_params = grid_serve(
        engine_mod, cfg, tree, card_mesh(expert=2), prompts, shared,
        sampled, MH_NEW["qb"], kernels)
    toks, st, launches, wall, peak, shapes, served = grid_serve(
        engine_mod, cfg, tree, card_mesh(seq=2, expert=2), prompts, shared,
        sampled, MH_NEW["qb"], kernels)
    k1, k2, k6 = (launches[fn] for fn in (paged, mq, partial))
    steps = st["eager_steps"]
    n_tok = sum(map(len, toks.values()))
    log(f"  (b) mixtral-8x7b int8 at {m.num_layers} layers on seq=2 x "
        f"expert=2, pool shards {shapes}: {n_tok} tokens in {wall:.1f} s "
        f"({n_tok / wall:.1f} generated tok/s, eager; information only, "
        f"{card}); peak {peak / 2 ** 30:.2f} GiB; prefix hits "
        f"{st['prefix_hits']}, rings {st['ring_prefills']}, {steps} decode "
        f"steps; kernels 1/2/6 {k1}/{k2}/{k6}")
    assert shapes == [(m.num_layers, 2, cfg.num_pages // 2, m.num_kv_heads,
                       PS, m.head_dim)] * 2, shapes
    assert st["ring_prefills"] == 1 and st_e["ring_prefills"] == 0
    assert st["prefix_hits"] >= 2
    assert k6 == 2 * m.num_layers * steps and k1 == 0
    sent = {**prompts, **shared}
    held_to(moe, cfg, ep_params, sent, {n: toks[n] for n in sent},
            {n: want[n] for n in sent},
            "(b) mixtral int8 seq=2 x expert=2 vs the expert=2 engine",
            routed=True, served_params=served)
    log(f"  (b) the seeded sampled stream "
        f"{'equal' if toks['sampled'] == want['sampled'] else 'parted'} "
        "(information: kernel 6 and the merge against kernel 1)")
    del tree, ep_params, served
    return k2, k6


def grid_ranks_leg(engine_mod, card):
    """4q (d): Llama-3-8B at MH_SEQ_LAYERS layers on ``seq=2 x model=2``
    as four ranks (rank r holds grid shard (seq r // 2, model r % 2): its
    model shard of the weights, its pages of its heads): the 1101-token
    prompt through the ring of each model shard over the ranks, every
    decode step through kernel 6 on each rank's pages and the merge over
    its seq group; every stream equal to the one-process engine's on that
    mesh. Returns the launches summed over the ranks."""
    started = mh_start("qd")
    want, _, st = mh_reference("qd", started, lambda: mh_one_process(
        engine_mod, "qd", None, card_mesh(seq=2, model=2)))
    torch.cuda.empty_cache()
    ranks = mh_ranks("qd", card, started)
    launches = mh_report("qd", ranks, card, f"llama3-8b at {MH_SEQ_LAYERS} "
                         "layers on seq=2 x model=2 as four ranks")
    m = mh_config("qd").model
    assert st["ring_prefills"] == 1
    assert [tuple(r["shards"][0]) for r in ranks] == \
        [(0, 0), (0, 1), (0, 0), (0, 1)]
    for r in ranks:
        assert r["ring_prefills"] == 1, "the long prompt missed the ring"
        assert r["launches"]["cp_paged_partial"] == \
            m.num_layers * r["decode_steps"], \
            "kernel 6 not once a layer a step on a rank"
        assert r["launches"]["paged_attention"] == 0
        assert r["pool"] == [[m.num_layers, 2, 2048, m.num_kv_heads // 2,
                              PS, m.head_dim]]
    same = sum(ranks[0]["tokens"][n] == want[n] for n in want)
    log(f"  (d) four ranks vs the one-process seq=2 x model=2 engine: "
        f"{same}/{len(want)} streams equal; kernel 6 "
        f"{ranks[0]['launches']['cp_paged_partial'] // ranks[0]['decode_steps']}"
        " a step a rank")
    assert ranks[0]["tokens"] == want, "a stream of the grid ranks parted"
    return launches


def grid_pd_leg(cfg, params, llama, prompts, shared, engine_mod, kernels,
                card, plane):
    """4q (e): a PD pair of Llama-3-8B bf16 at full depth on the
    page-and-head grid. A ``seq=2 x model=2`` PREFILL agent here (phase
    4's weights as views, handed its mesh as ``InferenceEngine`` takes
    one) and a ``seq=2 x model=2`` DECODE agent in a second process
    (``--tp-decode-agent seq=2,model=2``, weights from the same seed),
    4o (f)'s six requests: every handoff on CUDA IPC, one handle a model
    shard (each extract a ``ShardedBlock`` of two parts, each part one
    model shard's heads of both its seq shards' pages); kernel 4 once a
    model shard a handoff here, bit for bit against the plain gather;
    kernel 5 once a model shard there; the probe request's installed pages
    equal to its extracted block; the decode side's steps through kernel
    6; the streams held to an in-process MIX engine on the grid
    (``held_to``). ``plane`` is ``tp_decode_plane``'s, which the leg
    closes. Returns the launches of kernels 2, 4, 5 and 6 (the
    in-process engine's and the pair's, both processes)."""
    from xllm_service_tpu_torch.common.types import InstanceType
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
    )
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.ops import page_dma

    paged, mq, fused, partial = kernels
    mesh = card_mesh(seq=2, model=2)
    reqs, hits = tp_traffic(prompts, shared)
    sent = {**reqs, **hits}
    greedy = dict(max_tokens=TP_NEW, temperature=0.0, ignore_eos=True)
    requests = {n: dict(token_ids=p, **greedy) for n, p in sent.items()}
    store, coord, master, child = plane
    pre = None
    try:
        # The reference streams while the decode agent starts.
        reset_counts()
        want, st, _ = serve_greedy(engine_mod, cfg, params, reqs, hits,
                                   mesh=mesh, max_tokens=TP_NEW)
        ref = (mq.launches, partial.launches)
        pre = EngineAgent(cfg, AgentConfig(
            instance_type=InstanceType.PREFILL, model_id="llama3-8b",
            heartbeat_interval_s=1.0), coord=InMemoryCoordination(store),
            params=params, device="cuda", mesh=mesh)
        pre.start()
        parts = []
        extract = pre.engine.extract_kv_pages_device

        def counted_extract(pages):
            got = extract(pages)
            parts.append(len(getattr(got, "parts", [got])))
            return got

        pre.engine.extract_kv_pages_device = counted_extract
        toks, handoff, bad, digests, dl, reg_s = pd_pair_run(
            pre, child, master, store, requests, TP_PROBE,
            "/v1/completions")
        n = len(requests)
        # pd_pair_run set the counts to 0 just before its dispatches.
        g4, k2 = page_dma.gather_kv_pages.launches, mq.launches
        ms = sorted(handoff.values())
        log(f"  (e) seq=2 x model=2 pair over CUDA IPC: decode agent "
            f"registered after {reg_s:.1f} s; {n} handoffs, parts a handoff "
            f"{sorted(set(parts))}; handoff ms (device offer + pull spans) "
            f"p50 {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f} (information "
            f"only; {card}); kernel 4 here {g4}, kernel 2 here {k2}; there "
            f"kernel 5 {dl['scatter_kv_pages']}, kernel 6 "
            f"{dl['cp_paged_partial']}, kernel 1 {dl['paged_attention']}; "
            f"extracts differing from the plain gather {sum(bad)}; "
            f"{TP_PROBE} extracted / installed {digests}")
        assert parts == [2] * n, "not one IPC handle a model shard"
        assert len(bad) == n and not any(bad), "kernel 4 at a handoff"
        assert g4 == 2 * n and dl["scatter_kv_pages"] == 2 * n, \
            "not one gather here and one scatter there a model shard a " \
            "handoff"
        assert digests[0] is not None and digests[0] == digests[1], \
            "the installed pages differ from the extracted block"
        assert dl["cp_paged_partial"] > 0 and dl["paged_attention"] == 0, \
            "the decode side did not attend through kernel 6"
        held_to(llama, cfg, params, sent, toks, want,
                "(e) seq=2 x model=2 PD pair vs an in-process MIX engine "
                "on the grid", routed=False)
        return dict(mq=ref[0] + k2, gather=g4,
                    scatter=dl["scatter_kv_pages"],
                    partial=ref[1] + dl["cp_paged_partial"])
    except BaseException:
        log(f"  the decode agent's log, last lines:\n{child.tail()}")
        raise
    finally:
        child.close()
        if pre is not None:
            pre.stop()
        master.close()
        coord.close()
        store.close()
        del pre
        gc.collect()
        torch.cuda.empty_cache()


def grid_phase(engine_mod, llama, moe, page_dma, cfg, params, prompts,
               shared, sampled, kernels, card, plane=None):
    """Phase 4q: ``seq`` together with ``model`` or ``expert``, legs (a),
    (c), (e), (b), (d) (``grid_leg``, phase 4a's ``tier_phase`` on (a)'s
    grid, ``grid_pd_leg``, ``grid_moe_leg``, ``grid_ranks_leg``). Returns
    the launches of kernels 2 and 6 and of the movers: ``partial_16_4``
    counts kernel 6 at a model shard's 16/4 heads ((a), (e) and (d)),
    ``gather`` and ``scatter`` the movers at a grid shard's block ((c)),
    ``pd_gather`` and ``pd_scatter`` at (e)'s handoffs."""
    out = {}
    t = time.monotonic()
    # (e)'s decode agent (``plane``, or started now): its start overlaps
    # the legs before (e).
    plane = plane or tp_decode_plane(cfg, "seq=2,model=2",
                                     "phase4q_decode_agent.log")
    try:
        (mq_a, k6_a), mesh = grid_leg(engine_mod, llama, cfg, params,
                                      prompts, shared, sampled, kernels,
                                      card)
        log(f"  (a): {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        log("  (c) phase 4a's tier round trip on (a)'s grid pool:")
        c = tier_phase(engine_mod, *depth_view(cfg, params, GRID_LAYERS),
                       page_dma, card, mesh=mesh)
        assert c[0] % 2 == 0 and c[1] % 2 == 0, \
            "a mover did not launch once a model shard"
        log(f"  (c): {time.monotonic() - t:.1f} s; kernels 4/5 {c} (one "
            "launch a model shard over both its seq shards, blocks of "
            f"[{GRID_LAYERS}, 2, 8, 4, 16, 128] a model shard)")
    except BaseException:
        close_plane(plane)
        raise
    t = time.monotonic()
    e = grid_pd_leg(cfg, params, llama, prompts, shared, engine_mod,
                    kernels, card, plane)
    log(f"  (e): {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    mq_b, k6_b = grid_moe_leg(engine_mod, moe, kernels, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (b): {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    d = grid_ranks_leg(engine_mod, card)
    log(f"  (d): {time.monotonic() - t:.1f} s")
    out["mq"] = mq_a + mq_b + d["mq_paged_attention"] + e["mq"]
    out["partial"] = k6_a + k6_b + d["cp_paged_partial"] + e["partial"]
    out["partial_16_4"] = k6_a + d["cp_paged_partial"] + e["partial"]
    out["gather"], out["scatter"] = c
    out["pd_gather"], out["pd_scatter"] = e["gather"], e["scatter"]
    return out


# ---------------------------------------------------------------- phase 4r
RIDE_NEW = 40          # 4r (a): tokens of each short stream and the sampled
RIDE_SHORT = 128       # 4r (a): the short prompts' length
RIDE_LONG = 1280       # 4r (a): the prompt whose chunks ride
RIDE_LONG_NEW = 8      # 4r (a): its tokens
PP_LAYERS = 4          # 4r (b): Llama-3-8B's layers through the pipeline
PP_B, PP_S = 8, 128
TRAIN_LAYERS = 2       # 4r (c): Llama-3-8B's layers in the train step
TRAIN_B, TRAIN_S = 4, 128
TRAIN_STEPS = 3
# (b), (c) in f32 (TF32 off): a sharded or pipelined route differs from
# the one-device one in summation order and GEMM shapes only, about 1e-6
# of the values; a misplaced shard or microbatch moves them by their
# whole scale. (c) measures a leaf by its norm: AdamW's update is about
# lr times the sign of the gradient wherever the gradient is well above
# eps, so an element whose gradient is at f32 noise may step either way
# (up to about lr apart on a few thousand of a leaf's 10^8 elements), and
# those elements, not a wrong gradient, set the largest element error.
F32_REL_TOL = 1e-4


def ride_serve(engine_mod, cfg, params, mesh, shorts, long_prompt, sampled,
               kernels):
    """One engine (on ``mesh`` if given) stepped here, with no loop
    thread, so two engines take the same schedule: the short greedy
    prompts and a seeded sampled one at once, then, once each has its
    first token, the long prompt, whose chunks ride their decode steps;
    steps until every request is done. Returns (tokens by name, rides,
    eager decode steps, kernel 2's launches in each eager ride step, the
    launches of kernels 1 and 2 over the run, wall s)."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    paged, mq = kernels
    eng = engine_mod.InferenceEngine(cfg, params=params, mesh=mesh)
    steps, ride_k2 = [0], []
    step = eng._decode_step

    def counted(want_lp, sample, span=0):
        steps[0] += 1
        before = mq.launches
        step(want_lp, sample, span)
        if span:
            ride_k2.append(mq.launches - before)

    eng._decode_step = counted
    cols = {}

    def submit(name, toks, sp):
        cols[name] = Collector()
        eng.submit(engine_mod.EngineRequest(name, token_ids=toks,
                                            sampling=sp,
                                            on_output=cols[name]))

    def run_until(pred, what):
        for _ in range(100000):
            if pred():
                return
            eng.step()
        raise AssertionError(f"4r (a): {what} never happened")

    reset_counts()
    t0 = time.monotonic()
    for name, toks in shorts.items():
        submit(name, toks, SamplingParams(max_tokens=RIDE_NEW,
                                          temperature=0.0, ignore_eos=True))
    submit("sampled", sampled,
           SamplingParams(max_tokens=RIDE_NEW, **MH_SAMPLING))
    run_until(lambda: all(c.first.is_set() for c in cols.values()),
              "the first tokens")
    submit("long", long_prompt, SamplingParams(
        max_tokens=RIDE_LONG_NEW, temperature=0.0, ignore_eos=True))
    run_until(lambda: all(c.done.is_set() for c in cols.values()),
              "the end of the requests")
    wall = time.monotonic() - t0
    launches = (paged.launches, mq.launches)
    rides = eng.sarathi_rides
    eng.stop()
    toks = {n: c.tokens for n, c in cols.items()}
    for n, c in cols.items():
        assert c.reason == "length", f"{n}: reason {c.reason!r}"
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return toks, rides, steps[0], ride_k2, launches, wall


def mixed_tp_check(llama, cfg, params, mesh, sharded):
    """One mixed step at full width on one device and on ``mesh``
    (``sharded``, ``params`` on it; the pool a ``ModelShardedPages`` of the
    same random K/V): four decode rows (contexts 200-1300) and one chunk
    of CHUNK at start 512. The logits must agree within PREFILL_REL_TOL of
    max |logit| and the pools, joined on the head axis, within
    PREFILL_REL_TOL of max |K/V| (bf16 rounding in another order)."""
    from xllm_service_tpu_torch.parallel.sharding import ModelShardedPages

    mcfg = cfg.model
    i32 = dict(dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(17)
    ctxs = [200, 517, 901, 1300]
    B_, P_, ps = len(ctxs), cfg.pages_per_seq, cfg.page_size
    per_row = -(-max(ctxs) // ps)
    chunk_pages = -(-(512 + CHUNK) // ps)
    n_pages = 1 + B_ * per_row + chunk_pages
    base = torch.randn((mcfg.num_layers, 2, n_pages, mcfg.num_kv_heads, ps,
                        mcfg.head_dim), generator=g,
                       device="cuda").to(mcfg.dtype)
    dec_pt = torch.zeros((B_, P_), **i32)
    dec_pt[:, :per_row] = torch.arange(1, 1 + B_ * per_row,
                                       **i32).reshape(B_, per_row)
    chunk_pt = torch.zeros((1, P_), **i32)
    chunk_pt[0, :chunk_pages] = torch.arange(1 + B_ * per_row, n_pages, **i32)
    V = mcfg.vocab_size
    tok = torch.randint(3, V, (B_,), generator=g, device="cuda").to(
        torch.int32)
    clens = torch.tensor(ctxs, **i32)
    chunk_tok = torch.randint(3, V, (CHUNK,), generator=g,
                              device="cuda").to(torch.int32)
    args = (tok, clens - 1, chunk_tok, torch.arange(512, 512 + CHUNK, **i32))
    rest = (dec_pt, chunk_pt, clens, torch.tensor([512], **i32),
            torch.tensor([CHUNK], **i32))
    one = base.clone()
    single = llama.mixed_decode_chunk_forward(params, mcfg, *args, one,
                                              *rest)[0]
    tp = ModelShardedPages.zeros(base.shape, mcfg.dtype, mesh)
    for shard, part in zip(tp.shards, tp.split(base)):
        shard.copy_(part)
    del base
    got = llama.mixed_decode_chunk_forward(sharded, mcfg, *args, tp,
                                           *rest)[0]
    scale = single.abs().max().item()
    err = (single - got).abs().max().item()
    kv_scale = one[:, :, 1:].abs().max().item()
    kv_err = (tp.full() - one)[:, :, 1:].abs().max().item()
    log(f"  one-device vs {dict(mesh.shape)} mixed step ({B_} decode rows, "
        f"a chunk of {CHUNK} at 512): logits max_abs_err={err:.4g}, "
        f"max|logit|={scale:.4g}; pool joined max_abs_err={kv_err:.4g}, "
        f"max|K/V|={kv_scale:.4g} (tol {PREFILL_REL_TOL} x max each); "
        f"argmax equal {int((single.argmax(-1) == got.argmax(-1)).sum())}"
        f"/{B_}")
    assert torch.isfinite(got).all(), "mixed step on the mesh: non-finite"
    assert err <= PREFILL_REL_TOL * scale, "sharded mixed logits drifted"
    assert kv_err <= PREFILL_REL_TOL * kv_scale, "sharded mixed pool drifted"
    del one, tp
    gc.collect()
    torch.cuda.empty_cache()


def ride_leg(engine_mod, llama, cfg, params, prompts, kernels, card):
    """4r (a): Llama-3-8B bf16 at full width and depth on ``model=2``
    (phase 4's weights as views, 16/4 heads a shard) with chunks of CHUNK:
    four greedy streams of RIDE_SHORT-token prompts and a seeded sampled
    one decoding while a RIDE_LONG-token prompt is admitted, against the
    unmeshed chunked engine (captured steps) on the same schedule.
    Checks: rides above 0 and as many as the unmeshed engine's; kernel 2
    once a layer and model shard in every ride step; kernel 1 once a layer
    and model shard in every step; the greedy streams against the
    unmeshed engine's (``compare_streams``, each parted stream of the
    mesh then against its recomputation on the mesh); one mixed step's
    logits and pool against the one-device route (``mixed_tp_check``).
    Tok/s is information. Returns the launches of kernels 1 and 2 (both
    runs)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.parallel.sharding import shard_params

    rcfg = replace(cfg, prefill_chunk_tokens=CHUNK)
    rng = np.random.default_rng(21)
    V = cfg.model.vocab_size
    shorts = {f"r{i}": prompts[i][:RIDE_SHORT] for i in range(4)}
    long_prompt = rng.integers(3, V, size=RIDE_LONG).tolist()
    sampled = rng.integers(3, V, size=200).tolist()
    want, rides_1, _, _, one, wall_1 = ride_serve(
        engine_mod, rcfg, params, None, shorts, long_prompt, sampled,
        kernels)
    mesh = card_mesh(model=2)
    sharded = shard_params(params, mesh, llama.LLAMA_STACKED_RULES)
    toks, rides, steps, ride_k2, (k1, k2), wall = ride_serve(
        engine_mod, rcfg, sharded, mesh, shorts, long_prompt, sampled,
        kernels)
    m = cfg.model
    n_tok = sum(map(len, toks.values()))
    log(f"  (a) llama3-8b on model=2, chunks of {CHUNK}: {rides} rides "
        f"(unmeshed {rides_1}), {steps} decode steps, kernel 2 in the ride "
        f"steps {sorted(set(ride_k2))} a step, kernels 1/2 {k1}/{k2} "
        f"(unmeshed {one[0]}/{one[1]}); {n_tok} tokens in {wall:.1f} s "
        f"({n_tok / wall:.1f} generated tok/s, eager; unmeshed "
        f"{n_tok / wall_1:.1f}, captured; information only, {card})")
    assert rides == rides_1 > 0, "the chunks rode differently on the mesh"
    assert ride_k2 == [2 * m.num_layers] * rides, \
        "kernel 2 not once a layer and model shard in a ride step"
    assert k1 == 2 * m.num_layers * steps, \
        f"kernel 1 launched {k1} times, not {2 * m.num_layers} a step"
    greedy = [n for n in toks if n != "sampled"]
    sent = {**shorts, "long": long_prompt}
    # Phase 4g's rule for streams with rides against others: each parting
    # at a near-tie of the one-device logits after the shared context;
    # then each parted stream of the mesh against its recomputation on
    # the mesh's own route (held_to's rule for the served side). The
    # unmeshed side is not recomputed: its mixed steps' rounding can put
    # a token at a three-way near-tie there (rank 3, 1.5 bf16 steps below
    # the top, on the card), which held_to's two-value rule refuses.
    what = "(a) llama3-8b model=2 with rides vs the unmeshed chunked engine"
    compare_streams(llama, cfg, params, sent, {n: toks[n] for n in greedy},
                    {n: want[n] for n in greedy}, what)
    parted = {n: toks[n] for n in greedy if toks[n] != want[n]}
    if parted:
        check_streams_recomputed(llama, cfg, sharded, sent, parted,
                                 f"{what}, the parted streams on the mesh")
    log(f"  (a) the seeded sampled stream "
        f"{'equal' if toks['sampled'] == want['sampled'] else 'parted'} "
        "(information: two routes round apart)")
    mixed_tp_check(llama, rcfg, params, mesh, sharded)
    return one[0] + k1, one[1] + k2


def pipeline_leg(params, card):
    """4r (b): ``ops/pipeline.py`` at Llama-3-8B's width: PP_LAYERS of
    phase 4's layers in f32 as ``layer_fn`` (the train loss's layer body,
    ``parallel/train.py::layer``: no KV pool), B PP_B, S PP_S, on ``pipe``
    2 and 4 with 2 and 4 microbatches, each against the sequential stack
    within F32_REL_TOL of max |out|. Ms a forward is information."""
    from dataclasses import replace

    from xllm_service_tpu_torch.models.base import llama3_8b_config
    from xllm_service_tpu_torch.ops.pipeline import pipeline_forward
    from xllm_service_tpu_torch.parallel import train

    mcfg = replace(llama3_8b_config(), num_layers=PP_LAYERS,
                   dtype=torch.float32)
    layers = {k: {kk: vv[:PP_LAYERS].float() for kk, vv in v.items()}
              for k, v in params["layers"].items()}
    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn((PP_B, PP_S, mcfg.hidden_size), generator=g,
                    device="cuda") * mcfg.hidden_size ** -0.5

    def layer_fn(h, lp):
        return train.layer(lp, h, mcfg)

    def sequential():
        h = x
        for l in range(PP_LAYERS):
            h = layer_fn(h, {k: {kk: vv[l] for kk, vv in v.items()}
                             for k, v in layers.items()})
        return h

    want = sequential()
    scale = want.abs().max().item()
    seq_ms = time_ms(sequential, reps=3, warmup=1)
    parts = []
    for pipe in (2, 4):
        mesh = card_mesh(pipe=pipe)
        for micro in (2, 4):
            def run():
                return pipeline_forward(layer_fn, layers, x, mesh, micro)

            got = run()
            err = (got - want).abs().max().item()
            ms = time_ms(run, reps=3, warmup=1)
            parts.append(f"pipe {pipe} x {micro} microbatches "
                         f"max_abs_err={err:.3g} {ms:.1f} ms")
            assert torch.isfinite(got).all() and \
                err <= F32_REL_TOL * scale, \
                f"pipeline pipe={pipe} micro={micro} off the stack"
    log(f"  (b) pipeline_forward, llama3-8b's width, {PP_LAYERS} layers "
        f"f32, B {PP_B} S {PP_S}, max|out|={scale:.4g} (tol {F32_REL_TOL} x "
        f"max): " + "; ".join(parts) + f"; the sequential stack {seq_ms:.1f}"
        f" ms (information only; {card})")
    del layers, x, want
    gc.collect()
    torch.cuda.empty_cache()


def train_leg(llama, card):
    """4r (c): ``parallel/train.py``'s step at Llama-3-8B's width,
    TRAIN_LAYERS of its layers in f32 (seed 7; TF32 off for matmuls, as
    PyTorch's default and ``main`` keep it), B TRAIN_B, S TRAIN_S,
    TRAIN_STEPS steps on one batch, unsharded and on ``data=2 x model=4``
    of this card repeated: each step's loss and every updated leaf within
    F32_REL_TOL (relative: the norm of a leaf's difference against the
    leaf's norm), the loss falling, every copy of a slice (replicated over
    ``model`` or over ``data``) equal. Each leaf's largest difference in
    units of lr and the elements past 1e-5 of its largest magnitude, peak
    GiB and seconds a step are information."""
    from dataclasses import replace

    from xllm_service_tpu_torch.models.base import llama3_8b_config
    from xllm_service_tpu_torch.parallel.train import TrainState

    mcfg = replace(llama3_8b_config(), num_layers=TRAIN_LAYERS,
                   dtype=torch.float32)
    tree = llama.init_params(mcfg, torch.Generator(device="cuda").manual_seed(
        7), "cuda")
    g = torch.Generator(device="cuda").manual_seed(24)
    batch = torch.randint(0, mcfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                          generator=g, device="cuda")
    gib = 2 ** 30
    for name, mesh in (("unsharded", None),
                       ("data=2 x model=4", card_mesh(data=2, model=4))):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        state = TrainState(tree, mcfg, mesh)
        if mesh is not None:
            del tree                        # the shards are copies
        losses, secs = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.monotonic()
            losses.append(state.step(batch).item())
            secs.append(time.monotonic() - t)
        state.opt.zero_grad(set_to_none=True)
        peak = torch.cuda.max_memory_allocated()
        log(f"  (c) train step {name}: losses {losses}, s a step "
            f"{[round(x, 3) for x in secs]}, peak {peak / gib:.2f} GiB "
            f"({before / gib:.2f} before; information only, {card})")
        if mesh is None:
            want_losses = losses
            want = {k: v.cpu() for k, v in state.full().items()}
            del state
            gc.collect()
            torch.cuda.empty_cache()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    worst, worst_leaf, stats = 0.0, "", []
    got = state.full()
    lr = state.opt.defaults["lr"]
    for path, w in want.items():
        d = got[path].cpu() - w
        e = (d.norm() / w.norm()).item()
        stats.append(f"{path.split('/')[-2]} {e:.3g} (max "
                     f"{d.abs().max() / lr:.3g} lr, "
                     f"{int((d.abs() > 1e-5 * w.abs().max()).sum())} of "
                     f"{w.numel()} past 1e-5 x max)")
        if e > worst:
            worst, worst_leaf = e, path
    log("  (c) per leaf, |sharded - unsharded| / |unsharded|: "
        + "; ".join(stats))
    equal = all(torch.equal(x, grp[0]) for grp in state.groups
                for x in grp[1:])
    shared = sum(len(grp) > 1 for grp in state.groups)
    log(f"  (c) sharded vs unsharded after {TRAIN_STEPS} steps: loss "
        f"rel err {loss_err:.3g}, worst leaf {worst_leaf} rel err "
        f"{worst:.3g} over {len(want)} leaves (tol {F32_REL_TOL}); "
        f"{shared} groups of copies, every copy equal: {equal}")
    assert loss_err <= F32_REL_TOL, "the sharded loss drifted"
    assert worst <= F32_REL_TOL, f"leaf {worst_leaf} drifted"
    assert losses[-1] < losses[0], "the loss did not fall"
    assert equal, "copies of a replicated slice parted"
    del state, got, want
    gc.collect()
    torch.cuda.empty_cache()


def ride_phase(engine_mod, llama, cfg, params, prompts, kernels, card):
    """Phase 4r: legs (a) ``ride_leg``, (b) ``pipeline_leg``, (c)
    ``train_leg``. Returns (a)'s launches of kernels 1 and 2."""
    t = time.monotonic()
    out = ride_leg(engine_mod, llama, cfg, params, prompts, kernels, card)
    log(f"  (a): {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    pipeline_leg(params, card)
    log(f"  (b): {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    train_leg(llama, card)
    log(f"  (c): {time.monotonic() - t:.1f} s")
    return out


# --------------------------------------------------------------- phase 4s
MASTER_NEW = 64        # 4s (a): tokens of phase 4's requests (phase 4's)
MASTER_AFTER_NEW = 16  # 4s (d): tokens of each request after the death
MASTER_PD_LAYERS = 8   # 4s (e): Llama-3-8B cut to these layers for PD
MASTER_PD_NEW = 16     # 4s (e): tokens of each request of the PD pair
MASTER_TTFT_NEW = 4    # 4s (f): tokens of each request that times TTFT
MASTER_KILL_AFTER = 2  # 4s (g): frames the client takes before the kill
# 4s (k): the last data frame of a stream whose deadline passes
# mid-decode, under either master (the CPU twin:
# tests/test_torch_overload_drills.py::
# test_agent_deadline_mid_decode_ends_as_under_the_jax_master).
DEADLINE_END = {"error": {"message": "deadline exceeded", "code": 504}}
DEADLINE_DONE = False   # ... and no ``[DONE]`` after it


class MasterCall:
    """One request to the master's HTTP port on ``http.client``, read as
    it arrives: ``status``, ``headers``, the ``body`` bytes and, for a
    stream, each SSE frame with its arrival time (``frames``). ``hook``
    runs once, after ``after`` frames of a stream."""

    def __init__(self, port, path, body, stream=False, hook=None, after=0,
                 headers=None):
        import http.client

        self.t_send = time.monotonic()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request("POST" if body is not None else "GET", path,
                         body=json.dumps(body) if body is not None else None,
                         headers={"Content-Type": "application/json",
                                  **(headers or {})})
            r = conn.getresponse()
            self.status = r.status
            self.headers = {k.lower(): v for k, v in r.getheaders()}
            self.frames: list = []
            if not stream or r.status != 200:
                self.body = r.read()    # a whole answer or a refusal
                return
            buf = b""
            while True:
                piece = r.read1(1 << 16)
                if not piece:
                    break
                now = time.monotonic()
                buf += piece
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    self.frames.append((now, frame))
                    if hook is not None and len(self.frames) >= after:
                        hook()
                        hook = None
            assert not buf, f"a partial SSE frame at the end: {buf[:80]!r}"
            self.body = b"".join(f + b"\n\n" for _, f in self.frames)
        finally:
            conn.close()

    def json(self):
        return json.loads(self.body)

    def events(self):
        """The stream's data payloads in order (``[DONE]`` last)."""
        out = []
        for _, frame in self.frames:
            assert frame.startswith(b"data: "), frame[:80]
            data = frame[6:]
            out.append(data if data == b"[DONE]" else json.loads(data))
        return out

    def content_times(self):
        """Arrival of each frame that carries generated text."""
        ts = []
        for t, frame in self.frames:
            if frame == b"data: [DONE]":
                continue
            obj = json.loads(frame[6:])
            for c in obj.get("choices") or ():
                piece = c.get("text")
                if piece is None:
                    piece = (c.get("delta") or {}).get("content")
                if piece:
                    ts.append(t)
                    break
        return ts


def record_tokens(agents, by_dest=None, by_agent=None, times=None):
    """Token ids each agent's streamer pushes, by service request id, and
    which agent pushed them; with a ``by_dest`` dict, also by (service
    request id, destination master), with a ``by_agent`` dict by (agent
    index, service request id), and with a ``times`` dict each push's
    (unix ms, tokens, finished) by service request id."""
    toks: dict = {}
    served: dict = {}
    for i, agent in enumerate(agents):
        push = agent.streamer.push

        def recording(dest, out, i=i, push=push):
            sid = out.service_request_id
            served.setdefault(sid, i)
            for o in out.outputs:
                toks.setdefault(sid, []).extend(o.token_ids)
                if by_dest is not None:
                    by_dest.setdefault((sid, dest), []).extend(o.token_ids)
                if by_agent is not None:
                    by_agent.setdefault((i, sid), []).extend(o.token_ids)
            if times is not None:
                times.setdefault(sid, []).append((
                    time.time() * 1e3,
                    sum(len(o.token_ids) for o in out.outputs),
                    out.finished))
            push(dest, out)
        agent.streamer.push = recording
    return toks, served


def check_sse(call, name, n_new):
    """A streamed completion or chat: 200, text/event-stream, chunked, data
    frames then ``[DONE]``, usage on the last data event."""
    assert call.status == 200, (name, call.status, call.body[:200])
    assert call.headers["content-type"] == "text/event-stream" and \
        call.headers.get("transfer-encoding") == "chunked" and \
        call.headers.get("x-request-id"), (name, call.headers)
    ev = call.events()
    assert ev[-1] == b"[DONE]" and len(ev) >= 3, (name, ev[-2:])
    usage = ev[-2].get("usage")
    assert usage and usage["completion_tokens"] == n_new and \
        ev[-2]["choices"] == [], (name, ev[-2])
    return ev


class MasterProcess:
    """``python -m xllm_service_tpu_torch.master`` on the coordination
    server at ``coord_addr``, beside this process's master (a process, so
    SIGKILL-able as a master is in a deployment), its log under
    ``build/``."""

    def __init__(self, coord_addr, log_name, *extra, rpc_port=0):
        import subprocess

        from xllm_service_tpu_torch.common.net import pick_free_port

        root = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(os.path.join(root, "build"), exist_ok=True)
        self.log_path = os.path.join(root, "build", log_name)
        self.http_port = pick_free_port("127.0.0.1")
        self.rpc_port = rpc_port or pick_free_port("127.0.0.1")
        self.addr = f"127.0.0.1:{self.rpc_port}"
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "xllm_service_tpu_torch.master",
             "--host", "127.0.0.1", "--http-port", str(self.http_port),
             "--rpc-port", str(self.rpc_port),
             "--coordination-addr", coord_addr, *extra],
            cwd=root, stdout=open(self.log_path, "w"),
            stderr=subprocess.STDOUT)

    def tail(self):
        with open(self.log_path) as f:
            return "".join(f.readlines()[-30:])

    def metrics(self):
        """The master's ``/metrics`` text, or None while it is not up."""
        assert self.proc.poll() is None, \
            f"master {self.addr} exited:\n{self.tail()}"
        try:
            c = MasterCall(self.http_port, "/metrics", None)
        except OSError:
            return None
        return c.body.decode() if c.status == 200 else None

    def kill(self):
        self.proc.kill()
        self.proc.wait(timeout=30)

    def stop(self):
        """SIGTERM; the exit code."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except Exception:  # noqa: BLE001 — a hung master is killed
                self.proc.kill()
                self.proc.wait(timeout=30)
        return self.proc.returncode


def prom_value(text, name, **labels):
    """The sum of the samples of ``name`` whose labels include ``labels``
    in a Prometheus text (None when there is none)."""
    total = None
    for line in (text or "").splitlines():
        m = re.match(r"^(\w+)(?:\{(.*)\})? (\S+)$", line)
        if not m or m.group(1) != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2) or ""))
        if all(got.get(k) == v for k, v in labels.items()):
            total = (total or 0.0) + float(m.group(3))
    return total


def owned_keys(router, addr, n, prefix):
    """``n`` ownership keys whose rendezvous owner is ``addr``."""
    keys = [k for k in (f"{prefix}-{i}" for i in range(20000))
            if router.owner_of(k) == addr][:n]
    assert len(keys) == n, f"no {n} keys owned by {addr}"
    return keys


def scrub_frame(frame):
    """An SSE frame with the random ids and the timestamps dropped."""
    if frame.rstrip(b"\n") == b"data: [DONE]":
        return "[DONE]"
    obj = json.loads(frame.rstrip(b"\n")[6:])
    return {k: v for k, v in obj.items() if k not in ("id", "created")}


def master_greedy(prompt, key, stream, new):
    body = {"model": "llama3-8b", "prompt": prompt, "max_tokens": new,
            "temperature": 0.0, "ignore_eos": True, "stream": stream}
    if key:
        body["ownership_key"] = key
    if stream:
        body["stream_options"] = {"include_usage": True}
    return body


def check_call(c, name, n_new, stream):
    if stream:
        check_sse(c, name, n_new)
    else:
        assert c.status == 200, (name, c.status, c.body[:200])
        usage = c.json()["usage"]
        assert usage["completion_tokens"] == n_new, (name, usage)


def relay_leg(master, mix, toks, prompts, want, coord_addr, ttft_a, cmp,
              card, procs):
    """4s (f): a second master as a process at SLO_AWARE, a replica; four
    of phase 4's requests, streamed and whole, each sent to the frontend
    that does not own it (keys by rendezvous), relayed to its owner.
    Returns the second master."""
    from xllm_service_tpu_torch.common.metrics import (
        HANDOFF_FORWARDED_TOTAL,
        HANDOFF_SERVED_TOTAL,
    )

    from xllm_service_tpu_torch.common.net import pick_free_port
    from xllm_service_tpu_torch.multimaster.ownership import telemetry_owner

    sched, mgr = master.scheduler, master.scheduler.instance_mgr
    names = [a.name for a in mix]
    # B's address is drawn until the telemetry shard map gives it one of
    # the two agents, so that (g)'s handover of ingest is not empty.
    for _ in range(200):
        port = pick_free_port("127.0.0.1")
        owners = [telemetry_owner([sched.self_addr, f"127.0.0.1:{port}"], n)
                  for n in names]
        if sorted(owners) == sorted([sched.self_addr, f"127.0.0.1:{port}"]):
            break
    t = time.monotonic()
    b = MasterProcess(coord_addr, "phase4s_master_b.log",
                      "--load-balance-policy", "SLO_AWARE", rpc_port=port)
    procs.append(b)

    def b_sees_both():
        text = b.metrics()
        return text is not None and \
            prom_value(text, "fleet_size", role="prefill") == 2 and \
            prom_value(text, "fleet_size", role="decode") == 2 and \
            all((prom_value(text, "loadinfo_age_seconds", instance=n)
                 or -1) >= 0 for n in names)
    wait_for(b_sees_both, "master B's load view of both agents", timeout=90)
    wait_for(lambda: set(sched.ownership.members())
             == {sched.self_addr, b.addr}, "the two masters' membership",
             timeout=60)
    hello = MasterCall(b.http_port, "/hello", None).json()
    assert hello == {"status": "ok", "master": False}, hello
    assert sched.is_master
    states = [mgr.get_instance_state(n).name for n in names]
    assert states == ["ACTIVE", "ACTIVE"], states
    log(f"  (f) master B {b.addr} (python -m, --load-balance-policy "
        f"SLO_AWARE) up as a replica in {time.monotonic() - t:.1f} s; both "
        "frontends' load views hold both agents ACTIVE")

    fwd0, srv0 = HANDOFF_FORWARDED_TOTAL.value(), HANDOFF_SERVED_TOTAL.value()
    text0 = b.metrics()
    bf0 = prom_value(text0, "handoff_forwarded_total") or 0.0
    bs0 = prom_value(text0, "handoff_served_total") or 0.0
    to_b = owned_keys(sched.ownership, b.addr, 5, "4s-f")
    to_a = owned_keys(sched.ownership, sched.self_addr, 5, "4s-f")
    plan = [("g1", master.http_port, to_b[0], True),
            ("g2", master.http_port, to_b[1], False),
            ("g3", b.http_port, to_a[0], True),
            ("g4", b.http_port, to_a[1], False)]
    calls = {}

    def send(n, port, key, stream):
        calls[n] = MasterCall(port, "/v1/completions", master_greedy(
            prompts[int(n[1:])], key, stream, MASTER_NEW), stream)
    threads = [threading.Thread(target=send, args=p) for p in plan]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    got = {}
    for n, _, _, stream in plan:
        check_call(calls[n], n, MASTER_NEW, stream)
        got[n] = toks[calls[n].headers["x-request-id"]]
    ctx = {n: prompts[int(n[1:])] for n in got}
    cmp(ctx, got, {n: want[n] for n in got}, "4s (f) relayed requests")
    text1 = b.metrics()
    counts = (HANDOFF_FORWARDED_TOTAL.value() - fwd0,
              HANDOFF_SERVED_TOTAL.value() - srv0,
              (prom_value(text1, "handoff_forwarded_total") or 0.0) - bf0,
              (prom_value(text1, "handoff_served_total") or 0.0) - bs0)
    assert counts == (2, 2, 2, 2), \
        f"handoffs forwarded/served on A, forwarded/served on B: {counts}"
    log("  (f) g1-g4 relayed to their owners (A->B streamed and whole, "
        "B->A streamed and whole): greedy tokens equal to phase 4's; "
        f"forwarded/served A {counts[0]:.0f}/{counts[1]:.0f}, B "
        f"{counts[2]:.0f}/{counts[3]:.0f}")

    # The relay's added TTFT: the same cached prompts through A, owned by
    # A and then owned by B, one at a time.
    ttft = {"direct": [], "relayed": []}
    for i, n in enumerate(("g5", "g6", "g7")):
        for kind, key in (("direct", to_a[2 + i]), ("relayed", to_b[2 + i])):
            c = MasterCall(master.http_port, "/v1/completions", master_greedy(
                prompts[int(n[1:])], key, True, MASTER_TTFT_NEW), True)
            check_sse(c, f"{n} {kind}", MASTER_TTFT_NEW)
            ttft[kind].append((c.content_times()[0] - c.t_send) * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in ttft.items()}
    batch = [(calls[n].content_times()[0] - calls[n].t_send) * 1e3
             for n in ("g1", "g3")]
    log(f"  (f) TTFT ms through A, one request at a time on cached prompts: "
        f"relayed p50 {med['relayed']:.1f} vs owned p50 {med['direct']:.1f} "
        f"(the relay adds {med['relayed'] - med['direct']:.1f}); the two "
        f"relayed streams of the batch {batch[0]:.1f}, {batch[1]:.1f} "
        f"against 4s (a)'s p50 {ttft_a:.1f} (information only; {card})")
    return b


def owner_death_leg(master, b, mix, by_dest, prompts, want, cmp, card):
    """4s (g): a relayed 64-token stream accepted by A and owned by B; B
    SIGKILLed after MASTER_KILL_AFTER frames. The stream completes
    through A with phase 4's tokens and exactly the successor's frames; a
    ``handoff_recovery`` record names A; the agents whose telemetry B
    owned pass to A without a SUSPECT transition."""
    from xllm_service_tpu_torch.common.flightrecorder import RECORDER
    from xllm_service_tpu_torch.common.metrics import HANDOFF_RECOVERIES_TOTAL

    sched, mgr = master.scheduler, master.scheduler.instance_mgr
    names = [a.name for a in mix]
    owned_b = [n for n in names if not mgr.owns_telemetry(n)]
    assert owned_b, "master B owns no agent's telemetry"
    key = owned_keys(sched.ownership, b.addr, 1, "4s-g")[0]
    states = {n: [] for n in names}
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            for n in names:
                st = mgr.get_instance_state(n)
                st = st.name if st is not None else "GONE"
                if not states[n] or states[n][-1] != st:
                    states[n].append(st)
            time.sleep(0.02)
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    rec0 = HANDOFF_RECOVERIES_TOTAL.value()
    killed = []

    def kill():
        killed.append(time.monotonic())
        b.kill()
    try:
        c = MasterCall(master.http_port, "/v1/completions", master_greedy(
            prompts[5], key, True, MASTER_NEW), True,
            hook=kill, after=MASTER_KILL_AFTER)
        check_sse(c, "g5 (g)", MASTER_NEW)
        assert killed, "the stream ended before the owner's death"
        sid = c.headers["x-request-id"]
        got = by_dest.get((sid, sched.self_addr), [])
        cmp({"g5": prompts[5]}, {"g5": got}, {"g5": want["g5"]},
            "4s (g) the successor's stream")
        entry = master.service._journal.get(sid)
        assert entry is not None and entry.finished, \
            "the successor kept no journal of the re-owned stream"
        client = [scrub_frame(f) for _, f in c.frames]
        succ = [scrub_frame(f) for f in entry.frames]
        assert client == succ, \
            f"client frames {len(client)} vs the successor's {len(succ)}"
        recs = [r["detail"] for r in RECORDER.recent(
            limit=50, kind="handoff_recovery") if r["request_id"] == sid]
        assert recs and recs[-1]["successor"] == sched.self_addr and \
            recs[-1]["dead_owner"] == b.addr, recs
        assert HANDOFF_RECOVERIES_TOTAL.value() - rec0 >= 1
        ts = [t for t, _ in c.frames]
        k = MASTER_KILL_AFTER
        gap = (ts[k] - ts[k - 1]) * 1e3
        # Frame gaps after the resumption, the usage and [DONE] left out.
        steady = sorted((y - x) * 1e3
                        for x, y in zip(ts[k:-3], ts[k + 1:-2]))
        t = time.monotonic()
        wait_for(lambda: all(mgr.owns_telemetry(n) for n in names),
                 "A's telemetry ownership of every agent", timeout=60)
        wait_for(lambda: all(0 <= mgr.load_info_ages_s().get(n, -1) < 2.5
                             for n in names),
                 "fresh telemetry of every agent at A", timeout=30)
    finally:
        stop.set()
        watcher.join(timeout=5)
    suspect = {n: s for n, s in states.items() if "SUSPECT" in s
               or s[-1] != "ACTIVE"}
    assert not suspect, f"states during the handoff: {states}"
    log(f"  (g) owner B SIGKILLed after {k} frames of a relayed "
        f"{MASTER_NEW}-token stream: completed through A, {len(client)} "
        f"frames equal to the successor's, tokens equal to phase 4's; "
        f"handoff_recovery names {recs[-1]['successor']}; the client's gap "
        f"at the death {gap:.1f} ms (frame gaps after it p50 "
        f"{steady[len(steady) // 2] if steady else 0:.1f} ms); agents B "
        f"owned {owned_b} ingested by A {time.monotonic() - t:.1f} s after "
        f"the stream, states {states} ({card})")


def takeover_leg(master, coord_addr, mix, toks, prompts, want, cmp, card):
    """4s (h): a second master in this process (a replica) beside A; A
    stopped with no drain (its sockets reset, its coordination client
    closed, its lease left to lapse). The survivor must hold
    ``XLLM:SERVICE:MASTER`` within the lease TTL plus one sync, and serve
    phase 4's requests with phase 4's tokens. Returns the survivor (A is
    then marked ``_killed``)."""
    from xllm_service_tpu_torch.common.config import ServiceOptions
    from xllm_service_tpu_torch.master import Master

    names = [a.name for a in mix]
    a2 = Master(ServiceOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                               coordination_addr=coord_addr))
    a2.start()
    try:
        return _takeover(master, a2, coord_addr, names, toks, prompts, want,
                         cmp, card)
    except BaseException:
        a2.stop()
        raise


def _takeover(master, a2, coord_addr, names, toks, prompts, want, cmp,
              card):
    from xllm_service_tpu_torch.coordination.client import (
        TcpCoordinationClient,
    )
    from xllm_service_tpu_torch.rpc import MASTER_KEY

    s2 = a2.scheduler
    wait_for(lambda: not s2.is_master and all(
        s2.instance_mgr.get_instance_meta(n) for n in names)
        and set(s2.ownership.members())
        == {s2.self_addr, master.scheduler.self_addr},
        "the second in-process master's view", timeout=60)
    watch = TcpCoordinationClient(coord_addr)
    try:
        opts = master.scheduler._opts
        limit = opts.lease_ttl_s + opts.sync_interval_s
        t0 = time.monotonic()
        reaper = master.kill()
        master._killed = True
        wait_for(lambda: watch.get(MASTER_KEY) == s2.self_addr
                 and s2.is_master, "the survivor's takeover", timeout=60)
        took = time.monotonic() - t0
        reaper.join(timeout=30)
    finally:
        watch.close()
    assert took <= limit, \
        f"takeover in {took:.2f} s, beyond the lease TTL plus a sync {limit}"
    calls = {}

    def send(n):
        calls[n] = MasterCall(a2.http_port, "/v1/completions", master_greedy(
            prompts[int(n[1:])], None, n == "g6", MASTER_NEW), n == "g6")
    threads = [threading.Thread(target=send, args=(n,)) for n in ("g6", "g7")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    got = {}
    for n, c in calls.items():
        check_call(c, n, MASTER_NEW, n == "g6")
        got[n] = toks[c.headers["x-request-id"]]
    cmp({n: prompts[int(n[1:])] for n in got}, got,
        {n: want[n] for n in got}, "4s (h) after the takeover")
    log(f"  (h) A stopped with no drain: {s2.self_addr} held "
        f"{MASTER_KEY} after {took:.2f} s (limit: lease TTL "
        f"{opts.lease_ttl_s} s + sync {opts.sync_interval_s} s); g6, g7 "
        f"through it equal to phase 4's ({card})")
    return a2


def slo_flip_leg(master, coord_addr, pre, dec, pd_toks, pd_served, prompts,
                 want_pd, page_dma, cmp, check_launches, card, procs):
    """4s (i): a master process at SLO_AWARE (a replica) routes the PD
    pair; a flip hint posted to it reaches the elected master, which flips
    the prefill agent to DECODE and back; the next PD request streams as
    before. Returns the launches of kernels 4 and 5."""
    from xllm_service_tpu_torch.common.types import InstanceType
    from xllm_service_tpu_torch.rpc import instance_key

    sched, mgr = master.scheduler, master.scheduler.instance_mgr
    t = time.monotonic()
    c_proc = MasterProcess(coord_addr, "phase4s_master_c.log",
                           "--load-balance-policy", "SLO_AWARE")
    procs.append(c_proc)

    def pair_seen():
        text = c_proc.metrics()
        return text is not None and \
            prom_value(text, "fleet_size", role="prefill") == 1 and \
            prom_value(text, "fleet_size", role="decode") == 1
    wait_for(pair_seen, "master C's view of the PD pair", timeout=90)
    wait_for(lambda: c_proc.addr in sched.ownership.members(),
             "master C in the membership", timeout=60)
    keys = owned_keys(sched.ownership, c_proc.addr, 5, "4s-i")
    log(f"  (i) master C {c_proc.addr} (python -m, SLO_AWARE, a "
        f"replica) up in {time.monotonic() - t:.1f} s")

    def run(names, first):
        reset_counts()
        got = {}
        for i, n in enumerate(names):
            stream = (first + i) % 2 == 1
            call = MasterCall(c_proc.http_port, "/v1/completions",
                              master_greedy(prompts[int(n[1:])],
                                            keys[first + i], stream,
                                            MASTER_PD_NEW), stream)
            check_call(call, n, MASTER_PD_NEW, stream)
            sid = call.headers["x-request-id"]
            assert pd_served[sid] == 1, f"{n} not streamed by decode"
            got[n] = pd_toks[sid]
        g4 = page_dma.gather_kv_pages.launches
        g5 = page_dma.scatter_kv_pages.launches
        if check_launches:
            assert g4 == g5 == len(names), \
                f"kernels 4/5 {g4}/{g5} for {len(names)} handoffs"
        cmp({n: prompts[int(n[1:])] for n in got}, got,
            {n: want_pd[n] for n in got}, f"4s (i) {names}")
        return g4, g5
    k1 = run(["g0", "g1", "g2", "g3"], 0)
    log(f"  (i) g0-g3 routed by C's SLO_AWARE policy over the pair: "
        f"streams equal to the in-process MIX engine's, kernels 4/5 "
        f"{k1[0]}/{k1[1]}")

    def flip(to):
        t_ = time.monotonic()
        hint = MasterCall(c_proc.rpc_port, "/rpc/flip_hint",
                          {"name": pre.name, "type": to})
        assert (hint.status, hint.json()) == (
            200, {"ok": True, "master": False}), hint.body
        want_t = InstanceType.parse(to)
        other = "PREFILL" if to == "DECODE" else "DECODE"
        wait_for(lambda: (m := mgr.get_instance_meta(pre.name))
                 is not None and m.type == want_t
                 and pre.instance_type == want_t
                 and sched._coord.get(instance_key(to, pre.name))
                 and not sched._coord.get(instance_key(other, pre.name)),
                 f"the flip of {pre.name} to {to}", timeout=60)
        return time.monotonic() - t_
    to_d = flip("DECODE")
    to_p = flip("PREFILL")
    wait_for(lambda: pre.name in dec.linked_peers
             and dec.name in pre.linked_peers and pair_seen(),
             "the pair linked again", timeout=60)
    log(f"  (i) flip hints posted to replica C, enacted by the elected "
        f"master {sched.self_addr}: {pre.name} PREFILL -> DECODE in "
        f"{to_d:.2f} s (its registration moved), back in {to_p:.2f} s")
    k2 = run(["g4"], 4)
    log(f"  (i) g4 after the flips: equal, kernels 4/5 {k2[0]}/{k2[1]}")
    procs.remove(c_proc)
    rc = c_proc.stop()
    assert rc in (0, -15), f"master C exited {rc}:\n{c_proc.tail()}"
    return k1[0] + k2[0], k1[1] + k2[1]


# 4s (j)-(m): the overload, outage and failover planes, on a master of
# this process with the options those legs need (``plane_master``).
SHED_LIMIT = 2          # (j): admission_max_inflight_per_instance
SHED_NEW = 16           # (j): tokens of each request of the burst
DEADLINE_NEW = 512      # (k): tokens the deadline stream asks for
DEADLINE_BUDGET_MS = 800   # (k): its x-request-deadline-ms
BREAKER_COOLDOWN_S = 1.0   # (l): circuit_breaker_open_cooldown_s
BREAKER_NEW = 16        # (l): tokens of each request
OUTAGE_NEW = 64         # (m): tokens of the streams the outage runs under
# (m): outage timings near the reference drills' (a sync tick of 0.5 s,
# DEGRADED after two failed probes, a 0.5 s reconnect jitter window).
OUTAGE_OPTS = dict(sync_interval_s=0.5, coordination_degraded_after_ticks=2,
                   coordination_reconnect_jitter_s=0.5)


def route_spy(agents):
    """Wrap each agent's ``POST /v1/completions`` route: every dispatch's
    decoded body is logged as (agent index, body), and an agent whose name
    is in ``broken`` answers 500 without serving (the failing engine of
    (l)). Returns (log, broken, restore)."""
    from xllm_service_tpu_torch.rpc import wire

    key = ("POST", "/v1/completions")
    log: list = []
    broken: set = set()
    originals = [a._routes[key] for a in agents]
    for i, a in enumerate(agents):
        def spied(req, i=i, a=a, orig=originals[i]):
            try:
                body = wire.decode_body(req.ctype, req.body)
            except ValueError:
                body = {}
            log.append((i, body if isinstance(body, dict) else {}))
            if a.name in broken:
                return 500, {"error": "injected accept fault (4s (l))"}
            return orig(req)
        a._routes[key] = spied

    def restore():
        for a, orig in zip(agents, originals):
            a._routes[key] = orig
    return log, broken, restore


def plane_master(addr):
    """A master of this process on 4s's coordination server for (j)-(m):
    RR (requests alternate the agents), admission at SHED_LIMIT a live
    agent, the breaker's cooldown at BREAKER_COOLDOWN_S, OUTAGE_OPTS, and
    brownout off (its state, like the admission gate's, is one per
    process and would act on the other master's traffic too)."""
    from xllm_service_tpu_torch.common.config import ServiceOptions
    from xllm_service_tpu_torch.master import Master

    m = Master(ServiceOptions(
        host="127.0.0.1", http_port=0, rpc_port=0, coordination_addr=addr,
        load_balance_policy="RR",
        admission_max_inflight_per_instance=SHED_LIMIT,
        circuit_breaker_open_cooldown_s=BREAKER_COOLDOWN_S,
        brownout_enabled=False, **OUTAGE_OPTS))
    m.start()
    return m


def restore_overload(opts):
    """The process's overload singletons back to ``opts`` (the 4s
    master's), as its service configured them."""
    from xllm_service_tpu_torch.common.faults import FAULTS
    from xllm_service_tpu_torch.overload import (
        ADMISSION,
        BROWNOUT,
        RETRY_BUDGET,
    )

    FAULTS.clear()
    ADMISSION.configure(
        per_instance_limit=opts.admission_max_inflight_per_instance,
        batch_watermark=opts.admission_batch_watermark,
        retry_after_s=opts.admission_retry_after_s)
    BROWNOUT.configure(
        enabled=opts.brownout_enabled,
        batch_max_tokens=opts.brownout_batch_max_tokens,
        recover_ticks=opts.brownout_recover_ticks,
        trace_sample_rate=opts.brownout_trace_sample_rate,
        restore_rate_fn=lambda: opts.trace_sample_rate)
    RETRY_BUDGET.configure(ratio=opts.retry_budget_ratio,
                           cap=opts.retry_budget_cap)


def shed_leg(m, toks, prompts, want, cmp, card):
    """4s (j): a burst of four times the admission limit (SHED_LIMIT a
    live agent), phase 4's prompts at SHED_NEW tokens, all at once."""
    from xllm_service_tpu_torch.common.metrics import REQUESTS_CANCELLED_TOTAL

    shed0 = REQUESTS_CANCELLED_TOTAL.labels(reason="shed").value()
    n = 4 * SHED_LIMIT * 2
    go = threading.Barrier(n)
    calls: dict = {}

    def send(k):
        stream = k % 2 == 0
        body = master_greedy(prompts[k % len(prompts)], None, stream,
                             SHED_NEW)
        go.wait()
        calls[k] = MasterCall(m.http_port, "/v1/completions", body, stream)
    threads = [threading.Thread(target=send, args=(k,)) for k in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    codes = sorted(c.status for c in calls.values())
    shed = [c for c in calls.values() if c.status == 429]
    assert set(codes) <= {200, 429}, f"(j) answers {codes}"
    assert shed, "(j) nothing shed by a burst of four times the limit"
    for c in shed:
        assert c.headers.get("retry-after"), c.headers
        assert time.monotonic() - c.t_send < 60
    got, ctx, wants = {}, {}, {}
    for k, c in calls.items():
        if c.status != 200:
            continue
        check_call(c, f"(j) {k}", SHED_NEW, k % 2 == 0)
        name = f"g{k % len(prompts)}"
        got[f"j{k}"] = toks[c.headers["x-request-id"]]
        ctx[f"j{k}"] = prompts[k % len(prompts)]
        wants[f"j{k}"] = want[name][:SHED_NEW]
    cmp(ctx, got, wants, "4s (j) the admitted requests")
    counted = REQUESTS_CANCELLED_TOTAL.labels(reason="shed").value() - shed0
    assert counted == len(shed), (counted, len(shed))

    def drained():
        rep = MasterCall(m.http_port, "/admin/overload", None).json()
        return rep["admission"]["pending"] == 0 and rep
    wait_for(drained, "(j) the admission gate drained", timeout=60)
    rep = drained()
    body = shed[0].json()
    log(f"  (j) a burst of {n} (four times the limit of {SHED_LIMIT} a "
        f"live agent): {len(got)} served whole and equal to phase 4's, "
        f"{len(shed)} shed with 429 and Retry-After "
        f"{shed[0].headers['retry-after']} s (shared {len(shed) / n:.3f} of "
        f"the burst; {card}); requests_cancelled_total{{reason=\"shed\"}} "
        f"+{counted:.0f}; /admin/overload pending 0, shed_total "
        f"{rep['admission']['shed_total']}; body {body}")
    return len(shed) / n


def deadline_leg(m, mix, toks, served, spy, times, prompts, want, cmp,
                 card):
    """4s (k): a DEADLINE_NEW-token greedy stream with
    ``x-request-deadline-ms`` DEADLINE_BUDGET_MS beside two concurrent
    streams on the other agent; then a relayed request whose deadline
    has already passed."""
    from xllm_service_tpu_torch.common.metrics import REQUESTS_CANCELLED_TOTAL
    from xllm_service_tpu_torch.common.types import now_ms

    H = mix[0].engine.cfg.decode_horizon
    d0 = REQUESTS_CANCELLED_TOTAL.labels(reason="deadline").value()
    calls: dict = {}

    def send(name, body, headers=None):
        calls[name] = MasterCall(m.http_port, "/v1/completions", body, True,
                                 headers=headers)
    # c1, then the deadline request, then c2: RR alternates the two
    # agents, so the deadline stream has its agent to itself and both
    # concurrent streams run on the other.
    body = master_greedy(prompts[0], None, True, DEADLINE_NEW)
    ths = [threading.Thread(target=send, args=("c1", master_greedy(
        prompts[1], None, True, MASTER_NEW))),
        threading.Thread(target=send, args=("deadline", body, {
            "x-request-deadline-ms": str(DEADLINE_BUDGET_MS)})),
        threading.Thread(target=send, args=("c2", master_greedy(
            prompts[2], None, True, MASTER_NEW)))]
    for th in ths:
        th.start()
        time.sleep(0.02)
    for th in ths:
        th.join()
    d = calls["deadline"]
    sid = d.headers["x-request-id"]
    i = served[sid]
    others = [n for n in ("c1", "c2")
              if served[calls[n].headers["x-request-id"]] != i]
    assert others, "(k) no concurrent stream on the other agent"
    # The client's end: the one the CPU twin gets under both masters.
    assert d.status == 200, (d.status, d.body[:200])
    ev = d.events()
    done = ev[-1] == b"[DONE]"
    end = ev[-2] if done else ev[-1]
    assert (end, done) == (DEADLINE_END, DEADLINE_DONE), (end, done)
    wait_for(lambda: REQUESTS_CANCELLED_TOTAL.labels(reason="deadline")
             .value() == d0 + 1, "(k) one deadline cancellation",
             timeout=30)
    # The agent's engine dropped the sequence within two decode calls
    # (each DECODE_HORIZON tokens) of the deadline it was dispatched with.
    deadline = next(b["deadline_ms"] for j, b in spy
                    if b.get("service_request_id") == sid)
    pushes = times[sid]
    assert pushes[0][0] < deadline, (
        "(k) no token before the deadline: pushes (ms from the deadline, "
        "tokens, finished) "
        f"{[(round(t - deadline, 1), n, f) for t, n, f in pushes]}, the "
        f"concurrent streams' first tokens (ms after the deadline) "
        f"{[round(times[calls[n].headers['x-request-id']][0][0] - deadline, 1) for n in ('c1', 'c2')]}, "
        f"agents' stats {[a.engine.stats() for a in mix]}")
    late = sum(n for t, n, _ in pushes if t > deadline)
    stop_ms = pushes[-1][0] - deadline
    assert pushes[-1][2], "(k) no final output from the agent"
    assert late <= 2 * H, f"(k) {late} tokens after the deadline"
    n_tok = len(toks[sid])
    assert 0 < n_tok < DEADLINE_NEW // 2, n_tok
    wait_for(lambda: mix[i].engine.stats()["running"] == 0,
             "(k) the deadline agent's running set empty", timeout=30)
    k = min(n_tok, MASTER_NEW)
    cmp({"k": prompts[0], "c1": prompts[1], "c2": prompts[2]},
        {"k": toks[sid][:k],
         **{n: toks[calls[n].headers["x-request-id"]] for n in ("c1", "c2")}},
        {"k": want["g0"][:k], "c1": want["g1"], "c2": want["g2"]}, "4s (k)")
    for n in ("c1", "c2"):
        check_sse(calls[n], f"(k) concurrent {n}", MASTER_NEW)
    # An expired deadline at the owner's hop: 504, never an engine.
    d0 = REQUESTS_CANCELLED_TOTAL.labels(reason="deadline").value()
    n_spy = len(spy)
    exp = MasterCall(m.rpc_port,
                     "/rpc/handoff?kind=completion&sid=4s-k-expired",
                     master_greedy(prompts[2], None, False, 4),
                     headers={"x-xllm-deadline-ms": str(now_ms() - 5000)})
    assert exp.status == 504 and b"expired" in exp.body, exp.body[:200]
    assert REQUESTS_CANCELLED_TOTAL.labels(reason="deadline").value() \
        == d0 + 1
    assert len(spy) == n_spy, "(k) the expired request reached an agent"
    gaps = [(b - a) for (a, _, _), (b, _, _) in zip(pushes, pushes[1:])]
    log(f"  (k) a {DEADLINE_NEW}-token stream with x-request-deadline-ms "
        f"{DEADLINE_BUDGET_MS} on agent {i}: {n_tok} tokens (equal to phase "
        f"4's), the agent's stop {stop_ms:.1f} ms after the deadline with "
        f"{late} tokens pushed past it (limit two decode calls, {2 * H}; "
        f"push gaps p50 {sorted(gaps)[len(gaps) // 2] if gaps else 0:.1f} "
        f"ms; {card}), its engine's running set empty; the client's end "
        f"{end} as under the JAX master; two concurrent streams whole and "
        f"equal ({len(others)} of them on the other agent); an expired "
        f"relayed "
        f"deadline 504 with no dispatch")
    return stop_ms


def breaker_leg(m, mix, toks, served, spy, broken, prompts, want, cmp,
                card):
    """4s (l): ``rpc.post`` (and ``rpc.get``, the half-open probe's) fail
    for one agent's name through ``/admin/faults``, and its accepts fail
    (the failing engine): dispatches to it fail over to the other agent,
    its breaker opens and routing leaves it out; the fault cleared, a
    half-open probe after the cooldown closes the breaker and it serves
    again."""
    from xllm_service_tpu_torch.common.flightrecorder import RECORDER
    from xllm_service_tpu_torch.common.metrics import (
        CIRCUIT_BREAKER_OPEN,
        FAILOVER_SUCCESS_TOTAL,
    )
    from xllm_service_tpu_torch.common.types import InstanceRuntimeState

    mgr = m.scheduler.instance_mgr
    x, y = mix[0], mix[1]
    ch = mgr.get_channel(x.name)
    opened0 = ch.breaker.snapshot()["open_total"]
    rules = [{"point": p, "action": "error", "match": {"instance": x.name}}
             for p in ("rpc.post", "rpc.get")]
    r = MasterCall(m.http_port, "/admin/faults", {"seed": 0,
                                                  "rules": rules})
    assert r.status == 200 and len(r.json()["rules"]) == 2, r.body
    broken.add(x.name)
    t0 = time.monotonic()
    f0 = FAILOVER_SUCCESS_TOTAL.value()
    got, ctx, wants, moved = {}, {}, {}, []

    def one(tag, k):
        n_spy = len(spy)
        stream = k % 2 == 1
        c = MasterCall(m.http_port, "/v1/completions", master_greedy(
            prompts[k % len(prompts)], None, stream, BREAKER_NEW), stream)
        check_call(c, f"(l) {tag}", BREAKER_NEW, stream)
        sid = c.headers["x-request-id"]
        got[tag] = toks[sid]
        ctx[tag] = prompts[k % len(prompts)]
        wants[tag] = want[f"g{k % len(prompts)}"][:BREAKER_NEW]
        firsts = [j for j, b in spy[n_spy:]
                  if b.get("service_request_id") == sid]
        return sid, firsts
    k = 0
    while mgr.get_instance_state(x.name) != InstanceRuntimeState.BREAKER_OPEN \
            and k < 8:
        sid, firsts = one(f"l{k}", k)
        assert served[sid] == 1, f"(l) {sid} streamed by the failing agent"
        if firsts and firsts[0] == 0:
            moved.append(sid)
        k += 1
    wait_for(lambda: mgr.get_instance_state(x.name)
             == InstanceRuntimeState.BREAKER_OPEN,
             "(l) the failing agent's breaker OPEN", timeout=30)
    open_s = time.monotonic() - t0
    snap = ch.breaker.snapshot()
    assert snap["state"] == "open" and snap["open_total"] == opened0 + 1
    opts = m.scheduler._opts
    assert snap["window_samples"] >= opts.circuit_breaker_min_samples and \
        snap["window_failures"] >= opts.circuit_breaker_failure_ratio \
        * snap["window_samples"], snap
    assert moved, "(l) no request was first dispatched to the failing agent"
    assert FAILOVER_SUCCESS_TOTAL.value() - f0 == len(moved)
    recs = {r_["request_id"] for r_ in RECORDER.recent(limit=100,
                                                        kind="failover")}
    assert set(moved) <= recs, "(l) a failover without its record"
    assert CIRCUIT_BREAKER_OPEN.labels(instance=x.name).value() == 1
    over = MasterCall(m.http_port, "/admin/overload", None).json()
    assert over["breakers"][x.name]["state"] == "open", over["breakers"]
    # Routing leaves it out: the next requests reach only the other agent.
    assert x.name not in mgr.routing_snapshot().schedulable
    for j in range(2):
        sid, firsts = one(f"l{k}", k)
        assert firsts == [1] and served[sid] == 1, (firsts, served[sid])
        k += 1
    # The fault cleared: after the cooldown a half-open probe closes it.
    r = MasterCall(m.http_port, "/admin/faults", {"clear": True})
    assert r.status == 200 and r.json()["rules"] == [], r.body
    broken.clear()
    t1 = time.monotonic()
    wait_for(lambda: mgr.get_instance_state(x.name)
             == InstanceRuntimeState.ACTIVE
             and ch.breaker.state() == "closed",
             "(l) the half-open probe closing the breaker", timeout=60)
    close_s = time.monotonic() - t1
    assert CIRCUIT_BREAKER_OPEN.labels(instance=x.name).value() == 0
    back = []
    for _ in range(3):
        sid, _ = one(f"l{k}", k)
        k += 1
        if served[sid] == 0:
            back.append(sid)
            break
    assert back, "(l) the recovered agent served nothing"
    cmp(ctx, got, wants, "4s (l)")
    log(f"  (l) rpc.post and rpc.get failing for {x.name} and its accepts "
        f"500: {len(moved)} dispatches to it failed over to the other "
        f"agent (failover_success_total +{len(moved)}, each with its "
        f"flight record); its breaker OPEN {open_s:.2f} s after the fault "
        f"({snap['window_failures']} failures of {snap['window_samples']} "
        f"calls in the window), routing left "
        f"it out (2 requests, no dispatch to it); fault cleared: breaker "
        f"closed by the half-open probe {close_s:.2f} s later (cooldown "
        f"{BREAKER_COOLDOWN_S} s), then it served again; {k} requests, all "
        f"equal to phase 4's ({card})")
    return open_s, close_s


def outage_leg(masters, servers, addr, mix, toks, served, prompts, want,
               cmp, card):
    """4s (m): the port's coordination server stopped while four
    OUTAGE_NEW-token streams run on both agents, then restarted empty on
    the same port.
    ``masters``: (the elected 4s master, the plane master), the second
    with OUTAGE_OPTS; ``servers[0]`` is replaced by the new server."""
    from xllm_service_tpu_torch.coordination.client import (
        TcpCoordinationClient,
    )
    from xllm_service_tpu_torch.coordination.memory import MemoryStore
    from xllm_service_tpu_torch.coordination.server import (
        CoordinationServer,
    )
    from xllm_service_tpu_torch.rpc import instance_key

    a2, m = masters
    names = [a.name for a in mix]
    port = int(addr.rsplit(":", 1)[1])
    bad: list = []
    sticky: list = []
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            for mm in masters:
                st = mm.scheduler.instance_mgr.get_instance_state
                for n in names:
                    s_ = st(n)
                    if s_ is None or s_.name in ("SUSPECT", "EVICTED"):
                        bad.append((mm.scheduler.self_addr, n, s_))
            sticky.append((time.monotonic(), a2.scheduler.is_master))
            time.sleep(0.02)
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    killed: list = []
    go = threading.Event()

    def kill():
        # Off the client's thread, so the kill does not pause its reads.
        go.wait(60)
        wait_for(lambda: all(a.engine.stats()["running"] >= 1 for a in mix),
                 "(m) a stream running on each agent", timeout=30)
        killed.append(time.monotonic())
        servers[0].kill()
    killer = threading.Thread(target=kill, daemon=True)
    killer.start()
    calls: dict = {}

    def send(name, k, hook=None):
        calls[name] = MasterCall(m.http_port, "/v1/completions",
                                 master_greedy(prompts[k], None, True,
                                               OUTAGE_NEW), True,
                                 hook=hook, after=MASTER_KILL_AFTER)
    try:
        # Four streams (RR over two agents), so each agent runs some.
        ths = [threading.Thread(target=send, args=(
            f"m{k}", k + 2, go.set if k == 0 else None)) for k in range(4)]
        for th in ths:
            th.start()
            time.sleep(0.02)
        for th in ths:
            th.join()
        killer.join(timeout=60)
        assert killed, "(m) the server was not killed"
        assert min(c.frames[-1][0] for c in calls.values()) > killed[0], \
            "(m) a stream ended before the outage"
        got = {}
        for n, c in calls.items():
            check_sse(c, f"(m) {n}", OUTAGE_NEW)
            got[n] = toks[c.headers["x-request-id"]]
        assert {served[c.headers["x-request-id"]] for c in calls.values()} \
            == {0, 1}, "(m) the streams did not run on both agents"
        mon = m.scheduler.coordination_health
        wait_for(lambda: mon.state() == "DEGRADED",
                 "(m) the plane master's monitor DEGRADED", timeout=30)
        report = MasterCall(m.http_port, "/admin/coordination", None).json()
        assert report["state"] == "DEGRADED", report
        during = MasterCall(m.http_port, "/v1/completions", master_greedy(
            prompts[6], None, False, SHED_NEW))
        check_call(during, "(m) during the outage", SHED_NEW, False)
        got["during"] = toks[during.headers["x-request-id"]]
        assert a2.scheduler.is_master and not m.scheduler.is_master
        outage_states = {n: a2.scheduler.instance_mgr.get_instance_state(
            n).name for n in names}
        gaps = [b - a for c in calls.values()
                for a, b in zip(c.content_times(), c.content_times()[1:])]
        # The server back, empty, on the same port.
        t_r = time.monotonic()
        srv2 = CoordinationServer(host="127.0.0.1", port=port,
                                  store=MemoryStore())
        srv2.start_background()
        servers[0] = srv2
        down_s = t_r - killed[0]
        probe = TcpCoordinationClient(addr)
        try:
            wait_for(lambda: all(probe.get(instance_key("MIX", n))
                                 for n in names),
                     "(m) both agents re-registered", timeout=60)
            rereg_s = time.monotonic() - t_r
        finally:
            probe.close()
        wait_for(lambda: all(mm.scheduler.coordination_health.state()
                             == "CONNECTED"
                             and mm.scheduler._coord.connected
                             for mm in masters),
                 "(m) both monitors CONNECTED", timeout=60)
        conn_s = time.monotonic() - t_r
    finally:
        stop.set()
        watcher.join(timeout=5)
    assert not bad, f"(m) SUSPECT or evicted: {bad[:5]}"
    assert all(held for t_, held in sticky if t_ <= t_r), \
        "(m) the elected master lost its mastership during the outage"
    after = {}
    for n, mm, k in (("after0", m, 7), ("after1", a2, 1)):
        c = MasterCall(mm.http_port, "/v1/completions", master_greedy(
            prompts[k], None, False, SHED_NEW))
        check_call(c, f"(m) {n} after the restart", SHED_NEW, False)
        after[n] = toks[c.headers["x-request-id"]]
    got.update(after)
    ctx = {f"m{k}": prompts[k + 2] for k in range(4)}
    wants = {f"m{k}": want[f"g{k + 2}"] for k in range(4)}
    for n, k in (("during", 6), ("after0", 7), ("after1", 1)):
        ctx[n], wants[n] = prompts[k], want[f"g{k}"][:SHED_NEW]
    cmp(ctx, got, wants, "4s (m)")
    holder = "the 4s master" if a2.scheduler.is_master else \
        "the plane master" if m.scheduler.is_master else "no master yet"
    log(f"  (m) the coordination server killed after {MASTER_KILL_AFTER} "
        f"frames of four {OUTAGE_NEW}-token streams (on both agents): "
        f"all complete equal to phase 4's, a request served during the "
        f"outage, the plane master DEGRADED (held {report['held']['depth']}"
        f" actions), the 4s master still elected, no agent SUSPECT or "
        f"evicted on either master (4s master's states {outage_states}); "
        f"the client's largest inter-token gap {max(gaps) * 1e3:.1f} ms; "
        f"the server back empty after {down_s:.2f} s: both agents "
        f"re-registered in {rereg_s:.2f} s, both monitors CONNECTED in "
        f"{conn_s:.2f} s, {holder} holds the election key; requests served "
        f"through both masters ({card})")
    return max(gaps), rereg_s


def failover_stream(master, mix, toks, served, pushed, prompts, want, cmp,
                    card):
    """4s (d): the agent serving a MASTER_NEW-token greedy stream killed
    (its server, engine and heartbeats stopped, its lease left to lapse)
    after MASTER_KILL_AFTER frames. The stream completes through failover
    on the survivor, which prefills the prompt plus the replayed tokens
    and continues: the client's tokens are phase 4's with no duplicate
    and no gap. Returns (the dead agent's index, the client's largest
    inter-token gap in s). ``pushed``: ``record_tokens``'s ``by_agent``."""
    from xllm_service_tpu_torch.common.flightrecorder import RECORDER
    from xllm_service_tpu_torch.common.metrics import FAILOVER_SUCCESS_TOTAL

    spy, _, restore = route_spy(mix)
    killed: list = []

    def kill():
        busy = [i for i, a in enumerate(mix)
                if a.engine.stats()["running"]]
        assert len(busy) == 1, f"(d) agents running the stream: {busy}"
        killed.append(busy[0])
        victim = mix[busy[0]]
        victim.coord.rm = lambda key: True     # no deregistration
        victim.stop()
    f0 = FAILOVER_SUCCESS_TOTAL.value()
    try:
        c = MasterCall(master.http_port, "/v1/completions", master_greedy(
            prompts[0], None, True, MASTER_NEW), True, hook=kill,
            after=MASTER_KILL_AFTER)
    finally:
        restore()
    assert killed, "(d) the stream ended before the kill"
    v = killed[0]
    victim = mix[v]
    check_sse(c, "(d) the failed-over stream", MASTER_NEW)
    sid = c.headers["x-request-id"]
    assert served[sid] == v, "(d) the stream did not start on the victim"
    replays = [b for j, b in spy if j == 1 - v
               and b.get("service_request_id") == sid]
    assert len(replays) == 1, f"(d) {len(replays)} dispatches to the survivor"
    resume = list(replays[0]["resume_generated_token_ids"])
    assert replays[0]["token_ids"] == prompts[0] + resume
    client = resume + pushed.get((1 - v, sid), [])
    assert len(client) == MASTER_NEW and \
        pushed[(v, sid)][:len(resume)] == resume, \
        (len(resume), len(client), len(pushed.get((v, sid), ())))
    cmp({"d": prompts[0]}, {"d": client}, {"d": want["g0"]},
        "4s (d) the failed-over stream")
    assert FAILOVER_SUCCESS_TOTAL.value() - f0 == 1
    recs = [r["detail"] for r in RECORDER.recent(limit=100, kind="failover")
            if r["request_id"] == sid]
    assert recs and recs[0]["dead_instance"] == victim.name and \
        recs[0]["resumed_tokens"] == len(resume), recs
    ts = c.content_times()
    gap = max(b - a for a, b in zip(ts, ts[1:]))
    log(f"  (d) agent {victim.name} killed after {MASTER_KILL_AFTER} frames "
        f"of a {MASTER_NEW}-token stream on it: the survivor prefilled the "
        f"prompt plus {len(resume)} replayed tokens and streamed the other "
        f"{MASTER_NEW - len(resume)}; the client's tokens equal phase 4's, "
        f"no duplicate or gap; failover_success_total +1, a failover record "
        f"names the dead agent; the client's largest gap {gap * 1e3:.1f} ms "
        f"({card})")
    return v, gap


def plane_legs(master, addr, servers, mix, toks, served, times, prompts,
               want, cmp, card):
    """4s (j)-(m) on a ``plane_master`` beside the 4s master, both agents
    live; the plane master stopped afterwards, the 4s master elected again
    and the process's overload state given back. ``times``:
    ``record_tokens``'s. Returns the numbers the legs log."""
    mix_names = [a.name for a in mix]
    spy, broken, restore = route_spy(mix)
    t0 = time.monotonic()
    m = plane_master(addr)
    try:
        mgr = m.scheduler.instance_mgr
        wait_for(lambda: all(mgr.get_instance_meta(n) for n in mix_names)
                 and set(m.scheduler.ownership.members())
                 == {m.scheduler.self_addr, master.scheduler.self_addr}
                 and all(0 <= mgr.load_info_ages_s().get(n, -1) < 5
                         for n in mix_names),
                 "the plane master's view of both agents", timeout=60)
        log(f"  the plane master {m.scheduler.self_addr} up with both agents "
            f"in view in {time.monotonic() - t0:.1f} s")
        out = {}
        t = time.monotonic()
        out["shed_share"] = shed_leg(m, toks, prompts, want, cmp, card)
        log(f"  (j): {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        out["deadline_stop_ms"] = deadline_leg(m, mix, toks, served, spy,
                                               times, prompts, want, cmp,
                                               card)
        log(f"  (k): {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        out["breaker_s"] = breaker_leg(m, mix, toks, served, spy, broken,
                                       prompts, want, cmp, card)
        log(f"  (l): {time.monotonic() - t:.1f} s")
        t = time.monotonic()
        out["outage"] = outage_leg((master, m), servers, addr, mix, toks,
                                   served, prompts, want, cmp, card)
        log(f"  (m): {time.monotonic() - t:.1f} s")
    finally:
        broken.clear()
        restore()
        m.stop()
        restore_overload(master.scheduler._opts)
    t1 = time.monotonic()
    sched, mgr = master.scheduler, master.scheduler.instance_mgr
    wait_for(lambda: sched.is_master and set(sched.ownership.members())
             == {sched.self_addr} and all(
                 mgr.get_instance_state(n) is not None
                 and mgr.get_instance_state(n).name == "ACTIVE"
                 for n in mix_names),
             "the 4s master elected alone with both agents ACTIVE",
             timeout=60)
    log(f"  the plane master stopped; the 4s master elected, alone in its "
        f"membership view, with both agents ACTIVE {time.monotonic() - t1:.1f}"
        f" s later")
    return out


def master_phase(cfg, params, llama, engine_mod, prompts, shared,
                 sampled_prompt, want, kernels, card, device="cuda",
                 pd_layers=MASTER_PD_LAYERS, check_launches=True):
    """Phase 4s: the port's own master on the card. The port's coordination
    server on a loopback port and the port's master at the reference's
    defaults (CAR, brownout, breaker, ownership, the journal), two MIX
    agents of this process on phase 4's weights, each with its engine and
    pool. (a) phase 4's eleven requests as ``/v1/completions`` (token-id
    prompts; streamed and whole) in phase 4's order: the greedy tokens
    against phase 4's (``compare_streams``), the two shared-prefix
    requests sent once their first request's blocks are in the master's
    index: routed by CAR to the agent holding them, its prefix hits up
    by two, kernel 2 launched; (b) chats streamed and whole (the same
    text); (c) ``/v1/models``, ``/hello``, the master's ``/metrics``
    families; several masters: (f) ``relay_leg``, (g) ``owner_death_leg``
    and (h) ``takeover_leg``, after which the survivor of (h) is the
    master of the rest; (j)-(m) ``plane_legs``; (d) ``failover_stream``,
    one agent killed mid-stream (its lease left to lapse): the master
    evicts it and the next requests complete on the survivor;
    (e) a PREFILL and a DECODE agent at ``pd_layers`` layers linked by
    the master, every handoff on the host path (two agents of one
    process; the device path is between processes, phase 4i): kernel 4
    once and kernel 5 once a handoff, the streams held to an in-process
    MIX engine at that depth; (i) ``slo_flip_leg`` over that pair.
    Client TTFT and inter-token latency (p50, p99) and the master's
    hot-path stages are information. Returns the launches of kernels 1,
    2, 4 and 5 in (a), (f)-(h), (j)-(m) with (d), (e) and (i)."""
    from xllm_service_tpu_torch.common.config import ServiceOptions
    from xllm_service_tpu_torch.common.hotpath import HOTPATH
    from xllm_service_tpu_torch.common.types import InstanceType
    from xllm_service_tpu_torch.coordination.client import (
        TcpCoordinationClient,
    )
    from xllm_service_tpu_torch.coordination.memory import MemoryStore
    from xllm_service_tpu_torch.coordination.server import (
        CoordinationServer,
    )
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.common.tracing import TRACER
    from xllm_service_tpu_torch.master import Master
    from xllm_service_tpu_torch.ops import page_dma
    from xllm_service_tpu_torch.overload import BROWNOUT

    paged_attention, mq_paged_attention = kernels
    # The master configures the process's tracer, and its brownout may
    # lower the sampling rate: both are given back for the later phases'
    # agents in this process.
    tracing_before = (TRACER.enabled, TRACER.sample_rate,
                      TRACER.store.capacity)
    srv = CoordinationServer(host="127.0.0.1", port=0, store=MemoryStore())
    srv.start_background()
    servers = [srv]        # (m) replaces it with a restarted one
    addr = f"127.0.0.1:{srv.port}"
    master = Master(ServiceOptions(host="127.0.0.1", http_port=0,
                                   rpc_port=0, coordination_addr=addr))
    master.start()
    sched = master.scheduler
    mgr, kvm = sched.instance_mgr, sched.kvcache_mgr
    port = master.http_port
    agents: list = []
    procs: list = []       # master processes of (f) and (i)

    def cmp(ctx, got, want_, what):
        if device == "cuda":
            compare_streams(llama, cfg, params, ctx, got, want_, what)
        else:
            assert got == want_, what

    def start_agent(c, p, itype=InstanceType.MIX, host_path=False):
        a = EngineAgent(c, AgentConfig(
            model_id="llama3-8b", instance_type=itype,
            heartbeat_interval_s=1.0), coord=TcpCoordinationClient(addr),
            params=p, device=device)
        if host_path and a.kv_transfer is not None:
            a.kv_transfer.close()
            a.kv_transfer = None
        agents.append(a.start())
        return a

    def registered(*names):
        wait_for(lambda: all(mgr.get_instance_meta(n) for n in names),
                 "the agents' registration at the master", timeout=60)

    try:
        log(f"  coordination server {addr}; master HTTP :{port} RPC "
            f":{master.rpc_port}, policy {sched._opts.load_balance_policy}, "
            f"elected {sched.is_master}")
        t = time.monotonic()
        mix = [start_agent(cfg, params), start_agent(cfg, params)]
        registered(*(a.name for a in mix))
        by_dest: dict = {}
        by_agent: dict = {}
        times: dict = {}
        toks, served = record_tokens(mix, by_dest, by_agent, times)
        log(f"  two MIX agents {[a.name for a in mix]} registered in "
            f"{time.monotonic() - t:.1f} s")

        # (a) phase 4's requests through the master.
        greedy = dict(max_tokens=MASTER_NEW, temperature=0.0,
                      ignore_eos=True)
        samp = dict(max_tokens=MASTER_NEW, temperature=0.8, top_p=0.9,
                    seed=1234, ignore_eos=True)
        calls: dict = {}

        def send(name, ids, stream, sp):
            body = {"model": "llama3-8b", "prompt": ids, "stream": stream,
                    **sp}
            if stream:
                body["stream_options"] = {"include_usage": True}
            calls[name] = MasterCall(port, "/v1/completions", body, stream)

        def send_all(batch):
            threads = [threading.Thread(target=send, args=b)
                       for b in batch]
            for th in threads:
                th.start()
            for th in threads:
                th.join()

        reset_counts()
        HOTPATH.clear()
        t0 = time.monotonic()
        send_all([(f"g{i}", p, i % 2 == 0, greedy)
                  for i, p in enumerate(prompts)]
                 + [("sampled", sampled_prompt, False, samp)])
        sid0 = calls["g0"].headers["x-request-id"]
        holder = served[sid0]
        blocks = 512 // cfg.hash_block_size
        wait_for(lambda: kvm.match(prompts[0][:512]).scores.get(
            mix[holder].name, 0) >= blocks,
            "request 0's blocks in the master's index", timeout=60)
        hits0 = mix[holder].engine.stats()["prefix_hits"]
        mq0 = mq_paged_attention.launches
        send_all([(f"s{j}", p, True, greedy) for j, p in enumerate(shared)])
        wall = time.monotonic() - t0
        mq_s = mq_paged_attention.launches - mq0
        names = list(calls)
        got = {}
        for n in names:
            c = calls[n]
            if n.startswith("g") and int(n[1:]) % 2 or n == "sampled":
                assert c.status == 200, (n, c.status, c.body[:200])
                body = c.json()
                assert body["usage"]["completion_tokens"] == MASTER_NEW \
                    and body["choices"][0]["finish_reason"] == "length", \
                    (n, body["usage"])
            else:
                check_sse(c, n, MASTER_NEW)
            got[n] = toks[c.headers["x-request-id"]]
        placed = {n: served[calls[n].headers["x-request-id"]]
                  for n in names}
        hits = mix[holder].engine.stats()["prefix_hits"] - hits0
        log(f"  (a) phase 4's 11 requests through the master in "
            f"{wall:.1f} s; placement {placed}; the shared-prefix requests "
            f"on agent {holder} (request 0's) with {hits} prefix hits, "
            f"kernel 2 launches during them {mq_s}")
        assert placed["s0"] == placed["s1"] == holder, \
            f"CAR did not route the shared prefix to its holder: {placed}"
        assert hits >= 2, f"no prefix hits on the holder: {hits}"
        if check_launches:
            assert mq_s > 0, "kernel 2 not launched for the prefix hits"
        ctx = {f"g{i}": p for i, p in enumerate(prompts)}
        ctx.update({f"s{j}": p for j, p in enumerate(shared)})
        if device == "cuda":
            compare_streams(llama, cfg, params, ctx,
                            {n: got[n] for n in ctx},
                            {n: want[n] for n in ctx}, "4s (a)")
        else:
            assert {n: got[n] for n in ctx} == {n: want[n] for n in ctx}
        log(f"  (a) sampled request equal to phase 4's: "
            f"{got['sampled'] == want['sampled']} (information)")
        launches = [paged_attention.launches, mq_paged_attention.launches]
        if check_launches:
            assert launches[0] > 0 and launches[1] > 0, launches

        # Client-side TTFT and inter-token latency of the streams.
        ttft, itl, gaps = [], [], []
        for n in names:
            c = calls[n]
            if not c.frames:
                continue
            ts = c.content_times()
            ttft.append((ts[0] - c.t_send) * 1e3)
            itl.append((ts[-1] - ts[0]) * 1e3 / (MASTER_NEW - 1))
            gaps += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]

        def pct(xs, p):
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]

        log(f"  (a) client TTFT ms p50 {pct(ttft, 50):.1f} p99 "
            f"{pct(ttft, 99):.1f}; inter-token ms (a stream's span over "
            f"its tokens) p50 {pct(itl, 50):.2f} p99 {pct(itl, 99):.2f}; "
            f"SSE frame gaps ms p50 {pct(gaps, 50):.2f} p99 "
            f"{pct(gaps, 99):.2f}; {len(ttft)} streams "
            f"(information only; {card})")
        log("  (a) master hot path ms: " + "; ".join(
            f"{k} n {v['n']} p50 {v['p50']} p99 {v['p99']}"
            for k, v in HOTPATH.summary().items()) + f" ({card})")

        # (b) chats, whole and streamed.
        chat = dict(model="llama3-8b", max_tokens=24, temperature=0.0,
                    ignore_eos=True)
        for k, text in enumerate(("Tell me about the port of a serving "
                                  "system.", "Count from one to ten.")):
            msgs = [{"role": "user", "content": text}]
            whole = MasterCall(port, "/v1/chat/completions",
                               {**chat, "messages": msgs})
            assert whole.status == 200, whole.body[:200]
            w = whole.json()
            streamed = MasterCall(port, "/v1/chat/completions", {
                **chat, "messages": msgs, "stream": True,
                "stream_options": {"include_usage": True}}, stream=True)
            ev = check_sse(streamed, f"chat{k}", 24)
            text_s = "".join((c.get("delta") or {}).get("content") or ""
                             for e in ev[:-1] for c in e["choices"])
            assert ev[0]["choices"][0]["delta"].get("role") == "assistant"
            assert text_s == w["choices"][0]["message"]["content"] and \
                w["usage"] == ev[-2]["usage"], (text_s, w)
            assert toks[whole.headers["x-request-id"]] == \
                toks[streamed.headers["x-request-id"]]
        log("  (b) two chats: streamed content, usage and token ids equal "
            "to the whole responses'")

        # (c) the other routes.
        models = MasterCall(port, "/v1/models", None)
        assert models.status == 200 and [m["id"] for m in models.json()[
            "data"]] == ["llama3-8b"], models.body
        hello = MasterCall(port, "/hello", None)
        assert hello.status == 200 and hello.json() == \
            {"status": "ok", "master": True}
        metrics = MasterCall(port, "/metrics", None)
        fams = set(re.findall(r"^# TYPE (\S+) ", metrics.body.decode(),
                              re.M))
        need = {"server_request_in_total",
                "time_to_first_token_latency_milliseconds",
                "inter_token_latency_milliseconds",
                "instance_inflight_requests", "requests_cancelled_total",
                "coordination_connected", "admission_pending_requests"}
        assert metrics.status == 200 and need <= fams, need - fams
        served_n = re.search(r'^server_request_in_total\{kind="completion"\}'
                             r' (\S+)$', metrics.body.decode(), re.M)
        assert served_n and float(served_n.group(1)) >= len(names)
        log(f"  (c) /v1/models, /hello and /metrics ({len(fams)} families, "
            f"{float(served_n.group(1)):.0f} completions counted)")

        # (f)-(h): several masters.
        t = time.monotonic()
        reset_counts()
        b = relay_leg(master, mix, toks, prompts, want, addr,
                      pct(ttft, 50), cmp, card, procs)
        owner_death_leg(master, b, mix, by_dest, prompts, want, cmp, card)
        procs.remove(b)
        master = takeover_leg(master, addr, mix, toks, prompts, want, cmp,
                              card)
        sched = master.scheduler
        mgr, kvm = sched.instance_mgr, sched.kvcache_mgr
        port = master.http_port
        fh = [paged_attention.launches, mq_paged_attention.launches]
        if check_launches:
            assert fh[0] > 0 and fh[1] > 0, f"kernels 1/2 in (f)-(h): {fh}"
        log(f"  (f)-(h): {time.monotonic() - t:.1f} s, kernels 1/2 {fh}; "
            f"the rest of 4s on the survivor {sched.self_addr} ({card})")

        # (j)-(m): the overload, outage and failover planes.
        t = time.monotonic()
        reset_counts()
        planes = plane_legs(master, addr, servers, mix, toks, served, times,
                            prompts, want, cmp, card)
        log(f"  (j)-(m): {time.monotonic() - t:.1f} s")

        # (d) an agent's death with a stream in flight on it.
        t = time.monotonic()
        hist: dict = {a.name: [] for a in mix}
        stop_h = threading.Event()

        def sample():
            while not stop_h.is_set():
                for n_, h in hist.items():
                    e_ = mgr._instances.get(n_)
                    st_ = e_.state.value if e_ is not None else "EVICTED"
                    if not h or h[-1] != st_:
                        h.append(st_)
                stop_h.wait(0.02)
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        try:
            dead_i, gap_d = failover_stream(master, mix, toks, served,
                                            by_agent, prompts, want, cmp,
                                            card)
        finally:
            stop_h.set()
            sampler.join(timeout=5)
        victim, survivor = mix[dead_i], mix[1 - dead_i]
        states = list(hist[victim.name])

        def evicted():
            entry = mgr._instances.get(victim.name)
            st = entry.state.value if entry is not None else "EVICTED"
            if not states or states[-1] != st:
                states.append(st)
            return st == "EVICTED"

        wait_for(evicted, "the dead agent's eviction", timeout=120)
        dead_s = time.monotonic() - t
        after = {f"g{i}": prompts[i] for i in range(1, 4)}
        after_got = {}
        for n, ids in after.items():
            c = MasterCall(port, "/v1/completions", {
                "model": "llama3-8b", "prompt": ids,
                "max_tokens": MASTER_AFTER_NEW, "temperature": 0.0,
                "ignore_eos": True})
            assert c.status == 200, (n, c.status, c.body[:200])
            sid = c.headers["x-request-id"]
            assert served[sid] == 1 - dead_i, "served by the dead agent"
            after_got[n] = toks[sid]
        after_want = {n: want[n][:MASTER_AFTER_NEW] for n in after}
        if device == "cuda":
            compare_streams(llama, cfg, params, after, after_got,
                            after_want, "4s (d) after the death")
        else:
            assert after_got == after_want
        jm = [paged_attention.launches, mq_paged_attention.launches]
        if check_launches:
            assert jm[0] > 0 and jm[1] > 0, \
                f"kernels 1/2 in (j)-(m), (d): {jm}"
        log(f"  (d) agent {victim.name} stopped with its lease left to "
            f"lapse: states {states}, evicted after {dead_s:.1f} s (the "
            f"reference's default timeouts); {len(after)} requests then "
            f"served by the survivor; kernels 1/2 in (j)-(m) and (d) {jm}; "
            f"logged: shed share {planes['shed_share']:.3f}, deadline to "
            f"the engine's stop {planes['deadline_stop_ms']:.1f} ms, breaker "
            f"open/closed after {planes['breaker_s'][0]:.2f}/"
            f"{planes['breaker_s'][1]:.2f} s, the largest inter-token gap "
            f"in the outage {planes['outage'][0] * 1e3:.1f} ms and at the "
            f"kill {gap_d * 1e3:.1f} ms, re-registration "
            f"{planes['outage'][1]:.2f} s ({card})")
        # The survivor retires by the master's graceful drain (DRAINING at
        # once, deregistered when idle, no eviction), so the PD pair's
        # links meet no stale peer.
        t = time.monotonic()
        mgr.request_drain(survivor.name)
        wait_for(lambda: mgr.get_instance_meta(survivor.name) is None,
                 "the drained agent's deregistration", timeout=60)
        survivor.stop()
        log(f"  (d) the survivor drained by the master and deregistered in "
            f"{time.monotonic() - t:.1f} s")
        agents.clear()
        del mix, victim, survivor

        # (e) a PD pair linked by the master.
        pd_cfg, pd_params = depth_view(cfg, params, pd_layers)
        pre = start_agent(pd_cfg, pd_params, InstanceType.PREFILL, True)
        dec = start_agent(pd_cfg, pd_params, InstanceType.DECODE, True)
        registered(pre.name, dec.name)
        wait_for(lambda: pre.name in dec.linked_peers
                 and dec.name in pre.linked_peers,
                 "the master's PD link", timeout=60)
        pd_toks, pd_served = record_tokens([pre, dec])
        sent = {f"g{i}": prompts[i] for i in range(6)}
        reset_counts()
        pd_calls = {}
        for i, (n, ids) in enumerate(sent.items()):
            body = {"model": "llama3-8b", "prompt": ids,
                    "max_tokens": MASTER_PD_NEW, "temperature": 0.0,
                    "ignore_eos": True, "stream": i % 2 == 1}
            pd_calls[n] = MasterCall(port, "/v1/completions", body,
                                     stream=i % 2 == 1)
        g4 = page_dma.gather_kv_pages.launches
        g5 = page_dma.scatter_kv_pages.launches
        pd_got = {}
        for n, c in pd_calls.items():
            assert c.status == 200, (n, c.status, c.body[:200])
            sid = c.headers["x-request-id"]
            assert pd_served[sid] == 1, f"{n} not streamed by the decode agent"
            pd_got[n] = pd_toks[sid]
        n_pd = len(sent)
        log(f"  (e) PD pair at {pd_layers} layers linked by the master: "
            f"{pre.kv_host_sent} host handoffs ({pre.kv_stream_sent} "
            f"streamed), {pre.kv_device_sent} device; kernels 4/5 {g4}/{g5}")
        assert (pre.kv_host_sent, dec.kv_host_received) == (n_pd, n_pd)
        if check_launches:
            assert g4 == n_pd and g5 == n_pd, \
                "not one gather and one scatter a handoff"
        want_pd = serve_greedy(engine_mod, pd_cfg, pd_params, sent,
                               max_tokens=MASTER_PD_NEW)[0]
        if device == "cuda":
            compare_streams(llama, pd_cfg, pd_params, sent, pd_got, want_pd,
                            "4s (e) PD pair vs an in-process MIX engine")
        else:
            assert pd_got == want_pd

        # (i) SLO_AWARE over the pair, and a flip hint through a replica.
        t = time.monotonic()

        def cmp_pd(ctx, got, want_, what):
            if device == "cuda":
                compare_streams(llama, pd_cfg, pd_params, ctx, got, want_,
                                what)
            else:
                assert got == want_, what
        i4, i5 = slo_flip_leg(master, addr, pre, dec, pd_toks, pd_served,
                              prompts, want_pd, page_dma, cmp_pd,
                              check_launches, card, procs)
        log(f"  (i): {time.monotonic() - t:.1f} s")
        return [launches[0] + fh[0] + jm[0], launches[1] + fh[1] + jm[1],
                g4 + i4, g5 + i5]
    finally:
        for mp in procs:
            mp.kill()
        for a in agents:
            a.stop()
        if not getattr(master, "_killed", False):
            master.stop()
        servers[0].stop()
        BROWNOUT.reset()
        TRACER.configure(enabled=tracing_before[0],
                         sample_rate=tracing_before[1],
                         capacity=tracing_before[2], mirror=None)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4t
AUTO_LAYERS = 8        # 4t: Llama-3-8B cut to these layers in the agents
AUTO_NEW = 16          # 4t: tokens of each request
AUTO_PAGES = 1024      # 4t: pages of each spawned agent's pool
AUTO_HEARTBEAT_S = 1.0  # 4t: the spawned agents' heartbeat (4s (a)'s)
# 4t: the scale-out cooldown is the actuator's pending window. While the
# fleet is empty the planner's scale hint reads as pressure over the
# threshold, so a cold start would otherwise launch the second agent as
# soon as the cooldown of its own launch ran out; an agent that takes
# longer than the window to register fails the phase anyway.
AUTO_COOLDOWN_S = 20.0
# 4t: idle ticks before a scale-in (0.5 s at the 0.25 s sync). Idle means
# no bad sample in the window: the trickle below keeps one there until
# the second wave's own samples arrive.
AUTO_IDLE_TICKS = 2
# 4t: the TTFT objective's slow window; the burst goes out this long minus
# a second before the cold start's cooldown ends.
AUTO_WINDOW_S = 3.0
# 4t: requests that keep the objective breached while the second agent
# starts, one a TRICKLE_S (short prompts drawn from a seed; at most
# AUTO_TRICKLE, past which the agent took longer than the pending window).
AUTO_TRICKLE = 48
TRICKLE_S = 1.0


def auto_agent_args(cfg):
    """The spawned agents' command line after the script's path (the
    actuator fills ``{coordination_addr}`` and ``{port}``)."""
    return ["--autoscaled-agent", "--coordination-addr",
            "{coordination_addr}", "--port", "{port}",
            "--model-config", "llama3_8b", "--model-id", "llama3-8b",
            "--num-pages", str(AUTO_PAGES), "--page-size", str(cfg.page_size),
            "--max-batch-size", str(cfg.max_batch_size),
            "--max-seq-len", str(cfg.max_seq_len),
            "--decode-horizon", str(cfg.decode_horizon)]


def auto_cut(ecfg):
    """An agent's engine configuration cut to AUTO_LAYERS layers: the
    engine then draws those layers from its seed, as any engine draws
    random weights."""
    from dataclasses import replace

    return replace(ecfg, model=replace(ecfg.model, num_layers=AUTO_LAYERS))


def autoscaled_agent_child(argv) -> int:
    """``python3 chip_smoke.py --autoscaled-agent ARGS...`` (phase 4t runs it
    through ``python3 -c``, importing this script): the agent phase
    4t's master launches through its local actuator (its spawn command):
    the agent's own entry point (``engine/agent.py::main`` with ARGS) on
    Llama-3-8B at AUTO_LAYERS layers, beating every AUTO_HEARTBEAT_S, the
    token ids it pushes recorded by service request id. When the agent
    exits (SIGTERM's drain, from the actuator's reap or stop) it prints
    ``REPORT {...}``: its name, the launches of kernels 1 and 2, the
    tokens, the seconds from start to registration and its memory."""
    import logging

    from xllm_service_tpu_torch.engine import agent as agent_mod

    t0 = time.monotonic()
    kernels = mh_kernels()
    KERNEL_WRAPPERS.extend(kernels.values())
    engine_config = agent_mod.engine_config
    build_agent = agent_mod.build_agent
    box: dict = {"toks": {}, "entered": time.time()}

    def build(args, coord=None):
        agent = build_agent(args, coord)
        agent.cfg.heartbeat_interval_s = AUTO_HEARTBEAT_S
        register = agent.register

        def registered():
            register()
            box.setdefault("registered_s", time.monotonic() - t0)
        agent.register = registered
        push = agent.streamer.push

        def recording(dest, out):
            for o in out.outputs:
                box["toks"].setdefault(out.service_request_id, []).extend(
                    o.token_ids)
            push(dest, out)
        agent.streamer.push = recording
        box["name"] = agent.name
        return agent

    agent_mod.engine_config = lambda args: auto_cut(engine_config(args))
    agent_mod.build_agent = build
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)"
                        ".1s %(name)s: %(message)s")
    try:
        agent_mod.main(argv)
    finally:
        print("REPORT " + json.dumps({
            **box, "launches": {k: fn.launches for k, fn in kernels.items()},
            "peak": torch.cuda.max_memory_allocated(),
            "exit_s": time.monotonic() - t0}), flush=True)
    return 0


def auto_report(log_path):
    """The REPORT line of a spawned agent's log (None before it exits)."""
    with open(log_path) as f:
        for line in f:
            if line.startswith("REPORT "):
                return json.loads(line[len("REPORT "):])
    return None


def decision_actions(report, kind):
    """The ``kind`` actions of an ``/admin/autoscaler`` report, oldest
    first, each with its decision's ``ts_ms``."""
    return [dict(a, ts_ms=d["ts_ms"]) for d in reversed(report["decisions"])
            for a in d["actions"] if a["kind"] == kind]


def default_launcher_leg(card, slo):
    """4t (d): a master with the local actuator and no spawn command on a
    coordination server of its own (minimum and maximum 1, the failure
    detection of the CPU drills, the SLO options ``slo`` of the phase's
    master: the objectives are the process's, and a master sets them when
    it starts): its controller launches the port's fake engine (``python
    -m xllm_service_tpu_torch.testing.fake_engine``, the default
    launcher), a completion comes back with its reply, the fake engine's
    process is killed, and the controller replaces it with a second fake
    engine that serves the next completion."""
    from xllm_service_tpu_torch.common.config import ServiceOptions
    from xllm_service_tpu_torch.coordination.memory import MemoryStore
    from xllm_service_tpu_torch.coordination.server import (
        CoordinationServer,
    )
    from xllm_service_tpu_torch.master import Master

    srv = CoordinationServer(host="127.0.0.1", port=0,
                             store=MemoryStore(expiry_tick_s=0.05))
    srv.start_background()
    master = Master(ServiceOptions(
        host="127.0.0.1", http_port=0, rpc_port=0,
        coordination_addr=f"127.0.0.1:{srv.port}", lease_ttl_s=1.0,
        sync_interval_s=0.2, reconcile_interval_s=0.05,
        heartbeat_silence_to_suspect_s=0.3,
        detect_disconnected_instance_interval_s=0.3,
        health_probe_attempts=1, health_probe_timeout_s=0.2,
        autoscaler_enabled=True, autoscaler_actuator="local",
        autoscaler_min_instances=1, autoscaler_max_instances=1,
        autoscaler_stale_hold_s=30.0, autoscaler_spawn_retry_base_s=0.2,
        autoscaler_spawn_retry_max_s=1.0, brownout_enabled=False, **slo))
    master.start()
    mgr = master.scheduler.instance_mgr
    act = master.scheduler.autoscaler.actuator
    try:
        t = time.monotonic()
        names = []
        texts = []
        for round_ in range(2):
            wait_for(lambda: len(mgr.routing_snapshot().schedulable) == 1
                     and not set(mgr.routing_snapshot().schedulable)
                     & set(names),
                     "a fake engine from the default launcher", timeout=30)
            names.append(sorted(mgr.routing_snapshot().schedulable)[0])
            c = MasterCall(master.http_port, "/v1/completions", {
                "model": "fake-model", "prompt": "autoscale",
                "max_tokens": 64})
            assert c.status == 200, (c.status, c.body[:200])
            texts.append(c.json()["choices"][0]["text"])
            if round_ == 0:
                took = time.monotonic() - t
                t = time.monotonic()
                act._procs[names[0]].kill()
        replaced = time.monotonic() - t
        assert texts == ["Hello from the fake engine!"] * 2, texts
        assert act.launched_total == 2 and names[0] != names[1], \
            (act.launched_total, names)
        log(f"  (d) default launcher: fake engine {names[0]} up and serving "
            f"{took:.1f} s after the master's start; killed; replaced by "
            f"{names[1]}, serving {replaced:.1f} s after the kill; "
            f"{act.launched_total} launches ({card})")
    finally:
        master.stop()
        srv.stop()


def autoscale_phase(cfg, llama, engine_mod, prompts, shared,
                    kernels, card, on_full=None, refs=None):
    """Phase 4t: the autoscaler's closed loop on the card. The port's
    coordination server on a loopback port and the port's master with the
    autoscaler on and the local actuator, whose spawn command launches
    port agents of this script (``--autoscaled-agent``): Llama-3-8B at
    full width and AUTO_LAYERS layers, each process with its own engine,
    pool and CUDA context. ``min_instances`` 1, ``max_instances`` 2, the
    TTFT objective 1 ms over windows of 2 and AUTO_WINDOW_S s, one breach
    tick,
    AUTO_IDLE_TICKS idle ticks, a scale-out cooldown of AUTO_COOLDOWN_S (the pending
    window). (a) cold start: the controller launches the first agent
    (live 0 below the minimum); the seconds from the decision to the
    registration are logged. (b) scale out: once the cooldown is about to
    end (the samples of a burst sent earlier would have left the window),
    a burst of four of phase 4's
    prompts, then its first shared-prefix prompt once the first's blocks
    are in the master's index, breaches the objective; the controller
    launches the second agent, which registers while short requests keep
    the objective breached (one every TRICKLE_S); a second wave (three
    prompts and the other shared-prefix prompt) goes to both agents.
    ``/admin/autoscaler`` shows the scale-out and its reason, ``/metrics``
    ``autoscaler_actions_total``, ``/metrics/fleet`` both agents' series,
    ``/admin/trace?scope=fleet`` an agent's ``engine.*`` spans under the
    master's root. (c) scale in: with no traffic the controller drains the
    least-loaded agent (``/rpc/drain``), which leaves the fleet and is
    reaped (SIGTERM: it exits 0 by itself), with no further launch. The
    streams are held to an in-process engine on the same configuration
    and seed (``compare_streams``); kernel 1 must run in both agents and
    kernel 2 on the prefix hits. (d) ``default_launcher_leg``, while the
    first agent starts. ``on_full`` runs once the second agent reports
    (a later phase starts its processes there). ``refs`` (a dict), if
    given, receives the burst's, wave's and shared-prefix prompts and
    their reference streams (phase 4u serves them again). Returns the
    agents' launches of kernels 1 and 2."""
    import shlex

    from xllm_service_tpu_torch.common.config import ServiceOptions
    from xllm_service_tpu_torch.common.slo import SLO_MONITOR
    from xllm_service_tpu_torch.common.tracing import TRACER
    from xllm_service_tpu_torch.coordination.memory import MemoryStore
    from xllm_service_tpu_torch.coordination.server import (
        CoordinationServer,
    )
    from xllm_service_tpu_torch.engine import agent as agent_mod
    from xllm_service_tpu_torch.master import Master
    from xllm_service_tpu_torch.overload import BROWNOUT

    paged_attention, mq_paged_attention = kernels
    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    logdir = os.path.join(root, "build")
    os.makedirs(logdir, exist_ok=True)
    args = auto_agent_args(cfg)
    # The agents import this script as a module (its bytecode cached after
    # the first), not run it as __main__.
    boot = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "sys.exit(chip_smoke.autoscaled_agent_child(sys.argv[2:]))"
            % root)
    spawn = " ".join(shlex.quote(a) for a in
                     [sys.executable, "-c", boot, *args])
    acfg = auto_cut(agent_mod.engine_config(agent_mod._parser().parse_args(
        [a.format(coordination_addr="127.0.0.1:1", port=0)
         for a in args[1:]])))
    tracing_before = (TRACER.enabled, TRACER.sample_rate,
                      TRACER.store.capacity)
    slo = dict(slo_ttft_ms=1.0, slo_tpot_ms=60000.0, slo_fast_window_s=2.0,
               slo_slow_window_s=AUTO_WINDOW_S)
    logdir_before = os.environ.get("XLLM_AUTOSCALER_LOGDIR")
    os.environ["XLLM_AUTOSCALER_LOGDIR"] = logdir
    srv = CoordinationServer(host="127.0.0.1", port=0, store=MemoryStore())
    srv.start_background()
    addr = f"127.0.0.1:{srv.port}"
    master = Master(ServiceOptions(
        host="127.0.0.1", http_port=0, rpc_port=0, coordination_addr=addr,
        sync_interval_s=0.25, reconcile_interval_s=0.25,
        detect_disconnected_instance_interval_s=0.5,
        autoscaler_drain_grace_s=0.5, brownout_enabled=False,
        autoscaler_enabled=True, autoscaler_actuator="local",
        autoscaler_spawn_cmd=spawn, autoscaler_min_instances=1,
        autoscaler_max_instances=2, autoscaler_breach_ticks=1,
        autoscaler_idle_ticks=AUTO_IDLE_TICKS,
        autoscaler_scale_out_cooldown_s=AUTO_COOLDOWN_S,
        autoscaler_scale_in_cooldown_s=0.5, autoscaler_stale_hold_s=30.0,
        autoscaler_decision_log_capacity=1024, **slo))
    if logdir_before is None:
        os.environ.pop("XLLM_AUTOSCALER_LOGDIR")
    else:
        os.environ["XLLM_AUTOSCALER_LOGDIR"] = logdir_before
    master.start()
    sched = master.scheduler
    mgr, kvm, ctl = sched.instance_mgr, sched.kvcache_mgr, sched.autoscaler
    act = ctl.actuator
    port = master.http_port
    procs: dict = {}          # name -> Popen, kept past the actuator's reap
    logs: dict = {}

    def report():
        return MasterCall(port, "/admin/autoscaler", None).json()

    def fleet():
        return sorted(mgr.routing_snapshot().schedulable)

    def launched(n):
        wait_for(lambda: len(act.live_children()) >= n,
                 f"launch {n} by the controller", timeout=30)
        for name in act.live_children():
            procs.setdefault(name, act._procs[name])
            logs.setdefault(name, os.path.join(
                logdir, f"autoscaled_{name.rsplit(':', 1)[1]}.log"))

    def registered(n, what):
        t = time.monotonic()
        wait_for(lambda: len(fleet()) == n and all(
            mgr.load_info_ages_s().get(x, -1) >= 0 for x in fleet()),
            what, timeout=60)
        return time.monotonic() - t

    calls: dict = {}

    def send_all(batch):
        def send(name, ids, stream):
            body = {"model": "llama3-8b", "prompt": ids, "stream": stream,
                    "max_tokens": AUTO_NEW, "temperature": 0.0,
                    "ignore_eos": True}
            if stream:
                body["stream_options"] = {"include_usage": True}
            calls[name] = MasterCall(port, "/v1/completions", body, stream)
        threads = [threading.Thread(target=send, args=b) for b in batch]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    try:
        # (a) cold start; the reference streams are drawn meanwhile.
        log(f"  coordination server {addr}; master HTTP :{port}, local "
            f"actuator, spawn {' '.join(args[:1])} ... (llama3-8b at "
            f"{AUTO_LAYERS} layers, {AUTO_PAGES} pages)")
        launched(1)
        first = act.live_children()[0]
        # (d) and the reference streams run while the first agent starts
        # ((d)'s samples leave the window long before the cooldown ends).
        default_launcher_leg(card, slo)
        ref_params = llama.init_params(
            acfg.model, torch.Generator(device="cuda").manual_seed(acfg.seed),
            "cuda")
        burst = {f"b{i}": prompts[i] for i in range(4)}
        wave = {f"w{i}": prompts[4 + i] for i in range(3)}
        hits = {"s0": shared[0], "s1": shared[1]}
        rng = np.random.default_rng(24)
        trickle = {f"t{i}": rng.integers(3, acfg.model.vocab_size,
                                         size=int(n)).tolist()
                   for i, n in enumerate(rng.integers(64, 129,
                                                      size=AUTO_TRICKLE))}
        want = serve_greedy(engine_mod, acfg, ref_params,
                            {**burst, **wave, **trickle}, hits,
                            max_tokens=AUTO_NEW)[0]
        if refs is not None:
            refs["prompts"] = {**burst, **wave, **hits}
            refs["want"] = {n: want[n] for n in refs["prompts"]}
        wait_s = registered(1, "the first agent's registration")
        rep = report()
        cold = decision_actions(rep, "scale_out")
        assert len(cold) == 1 and "replacing lost capacity" in \
            cold[0]["reason"], cold
        up_s = time.time() - cold[0]["ts_ms"] / 1000
        log(f"  (a) cold start: {first} launched by the controller "
            f"({cold[0]['reason']!r}); registered and reporting "
            f"{up_s:.1f} s after the decision ((d) and the reference "
            f"streams ran meanwhile; waited {wait_s:.1f} s after them)")
        assert up_s < act.SPAWN_PENDING_TIMEOUT_S, \
            f"the first agent took {up_s:.1f} s, past the pending window"

        # (b) the burst breaches; the second agent joins.
        time.sleep(max(0.0, cold[0]["ts_ms"] / 1000 + AUTO_COOLDOWN_S
                       - (AUTO_WINDOW_S - 1.0) - time.time()))
        t_burst = time.time()
        send_all([(n, p, i % 2 == 0) for i, (n, p) in enumerate(
            burst.items())])
        blocks = 512 // acfg.hash_block_size
        wait_for(lambda: kvm.match(prompts[0][:512]).scores.get(
            first, 0) >= blocks, "b0's blocks in the master's index",
            timeout=30)
        send_all([("s0", shared[0], True)])
        # The traffic goes on while the second agent starts and the fleet
        # is checked (one request a TRICKLE_S): the objective stays
        # breached, so an idle streak cannot retire an agent before then.
        stop_trickle = threading.Event()

        def trickle_on():
            for n, p in trickle.items():
                if stop_trickle.wait(TRICKLE_S):
                    return
                send_all([(n, p, False)])
        trickler = threading.Thread(target=trickle_on)
        trickler.start()
        try:
            launched(2)
            second = [n for n in act.live_children() if n != first][0]
            out = [a for a in decision_actions(report(), "scale_out")
                   if a["ts_ms"] > cold[0]["ts_ms"]]
            # The burst breaches through its TTFT samples or through the
            # planner's pressure (its queue), whichever the tick sees first.
            assert len(out) == 1 and out[0]["ts_ms"] / 1000 >= t_burst \
                and out[0]["reason"] in ("SLO burn over alert",
                                         "fleet pressure over threshold"), \
                out
            wait_s = registered(2, "the second agent's registration")
            out_s = time.time() - out[0]["ts_ms"] / 1000
            if on_full is not None:
                on_full()
            log(f"  (b) the burst ({len(burst) + 1} requests) breached: "
                f"scale_out ({out[0]['reason']!r}) "
                f"{out[0]['ts_ms'] / 1000 - t_burst:.1f} s after the burst "
                f"began; {second} registered and reporting {out_s:.1f} s "
                f"after the decision (waited {wait_s:.1f} s)")
            assert out_s < act.SPAWN_PENDING_TIMEOUT_S, \
                f"the second agent took {out_s:.1f} s, past the pending " \
                "window"
            # The wave and the fleet's surface, while the trickle keeps
            # both agents in the fleet.
            send_all([(n, p, i % 2 == 1) for i, (n, p) in enumerate(
                [*wave.items(), ("s1", shared[1])])])
            metrics = MasterCall(port, "/metrics", None).body.decode()
            actions = prom_value(metrics, "autoscaler_actions_total",
                                 action="scale_out")
            assert actions is not None and actions >= 2, actions
            fleet_text = MasterCall(port, "/metrics/fleet",
                                    None).body.decode()
            for name in (first, second):
                assert prom_value(fleet_text, "fleet_scrape_up",
                                  instance=name, role="engine") == 1, name
                assert prom_value(fleet_text, "engine_heartbeats_total",
                                  instance=name) is not None, name
            sid = calls["w0"].headers["x-request-id"]
            tr = MasterCall(
                port, f"/admin/trace?request_id={sid}&scope=fleet",
                None).json()
            assert len(tr["tree"]) == 1 and \
                tr["tree"][0]["point"] == "frontend.request", tr["tree"]
            engine_spans = sorted({(s["point"], s.get("instance", ""))
                                   for s in tr["spans"]
                                   if s["point"].startswith("engine.")})
            assert engine_spans and all(
                i in (first, second) for _, i in engine_spans), engine_spans
        finally:
            stop_trickle.set()
            trickler.join()
        t_quiet = time.time()    # the last request has ended
        sent = {n: p for n, p in {**burst, **wave, **hits,
                                  **trickle}.items() if n in calls}
        for n, c in calls.items():
            if c.headers.get("content-type") == "text/event-stream":
                check_sse(c, n, AUTO_NEW)
            else:
                assert c.status == 200, (n, c.status, c.body[:200])
                assert c.json()["usage"]["completion_tokens"] == AUTO_NEW
        log(f"  (b) /metrics autoscaler_actions_total{{scale_out}} "
            f"{actions:.0f}; /metrics/fleet scrapes both agents; the fleet "
            f"trace of w0: one tree, {tr['num_spans']} spans, the agent's "
            f"{engine_spans}")

        # (c) quiet: the controller drains one agent, which is reaped.
        wait_for(lambda: decision_actions(report(), "scale_in"),
                 "the scale-in decision", timeout=30)
        scale_in = decision_actions(report(), "scale_in")[0]
        victim = scale_in["instance"]
        drain_s = scale_in["ts_ms"] / 1000 - t_quiet
        wait_for(lambda: mgr.get_instance_meta(victim) is None,
                 "the drained agent leaving the fleet", timeout=30)
        left_s = time.time() - scale_in["ts_ms"] / 1000
        t_left = time.monotonic()
        wait_for(lambda: victim not in act.live_children()
                 and procs[victim].poll() is not None,
                 "the drained agent's reap", timeout=30)
        reap_s = time.monotonic() - t_left
        assert procs[victim].returncode == 0, \
            f"the reaped agent exited {procs[victim].returncode}"
        survivor = first if victim == second else second
        time.sleep(1.0)          # a few more ticks: nothing re-launched
        assert act.launched_total == 2 and act.live_children() == \
            [survivor], (act.launched_total, act.live_children())
        assert fleet() == [survivor] and \
            len(decision_actions(report(), "scale_out")) == 2
        log(f"  (c) quiet: scale_in of {victim} ({scale_in['reason']!r}) "
            f"{drain_s:.1f} s after the last stream; it left the fleet "
            f"within {left_s:.1f} s of the decision and exited 0 "
            f"{reap_s:.1f} s after we saw it leave (SIGTERM's drain; the "
            "reap waits 5 s before it kills); 2 launches in all")
    finally:
        master.stop()            # the actuator's stop ends the survivor
        srv.stop()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        BROWNOUT.reset()
        d = ServiceOptions()
        SLO_MONITOR.configure(ttft_ms=d.slo_ttft_ms, tpot_ms=d.slo_tpot_ms,
                              budget=d.slo_error_budget,
                              fast_s=d.slo_fast_window_s,
                              slow_s=d.slo_slow_window_s,
                              alert=d.slo_burn_alert)
        TRACER.configure(enabled=tracing_before[0],
                         sample_rate=tracing_before[1],
                         capacity=tracing_before[2], mirror=None)

    # The agents' reports: tokens, launches, memory.
    reports = {n: auto_report(path) for n, path in logs.items()}
    assert all(reports.values()), \
        {n: r is not None for n, r in reports.items()}
    gib = 2 ** 30
    served, got = {}, {}
    launches_at = {first: cold[0]["ts_ms"] / 1000,
                   second: out[0]["ts_ms"] / 1000}
    for name, r in reports.items():
        log(f"  agent {name}: its code ran "
            f"{r['entered'] - launches_at[name]:.1f} s after the launch "
            f"decision (the interpreter's start and imports), registered "
            f"{r['registered_s']:.1f} s later, launches {r['launches']}, peak "
            f"{r['peak'] / gib:.2f} GiB allocated, exit at "
            f"{r['exit_s']:.1f} s ({card})")
        for n, c in calls.items():
            sid_ = c.headers["x-request-id"]
            if sid_ in r["toks"]:
                served[n] = name
                got[n] = r["toks"][sid_]
    assert sorted(served) == sorted(sent), served
    assert served["s0"] == served["s1"] == first, \
        f"CAR did not send the shared prefixes to their holder: {served}"
    assert any(served[n] == second for n in wave), \
        f"no request of the second wave reached the second agent: {served}"
    k1 = {n: r["launches"]["paged_attention"] for n, r in reports.items()}
    k2 = {n: r["launches"]["mq_paged_attention"]
          for n, r in reports.items()}
    assert all(v > 0 for v in k1.values()), f"kernel 1 idle in an agent {k1}"
    assert k2[first] > 0, f"kernel 2 not launched on the prefix hits {k2}"
    log(f"  placement {served}; kernels 1 {k1}, 2 {k2}")
    compare_streams(llama, acfg, ref_params, sent, got,
                    {n: want[n] for n in sent},
                    "4t: the spawned agents vs an in-process engine")
    del ref_params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 4t: {time.monotonic() - t_phase:.1f} s")
    return sum(k1.values()), sum(k2.values())


# --------------------------------------------------------------- phase 4u
VERIFIED_NEW = 16          # 4u: tokens of each request (4t's)
VERIFIED_CANCEL_AFTER = 2  # 4u (a): frames the cancelled client reads
VERIFIED_CANCEL_NEW = 512  # 4u (a): tokens the cancelled request asks for
#: The four runtime verifiers (devtools/), armed in 4u's processes.
VERIFIERS = {"XLLM_LOCK_DEBUG": "1", "XLLM_RCU_DEBUG": "1",
             "XLLM_STATE_DEBUG": "1", "XLLM_LEAK_DEBUG": "1"}
#: 4u's masters: failure detection in tenths of a second, so that (c)'s
#: eviction follows the lease (AUTO_HEARTBEAT_S beats, a 1 s lease).
VERIFIED_MASTER_ARGS = [
    "--host", "127.0.0.1", "--sync-interval-s", "0.25",
    "--reconcile-interval-s", "0.25",
    "--detect-disconnected-instance-interval-s", "0.5",
    "--heartbeat-silence-to-suspect-s", "1.0",
    "--health-probe-attempts", "1", "--health-probe-timeout-s", "0.2"]
VERIFIED_LEASE_S = 1.0


def verifier_report(strict=True):
    """This process's verifier findings: violation counts by verifier and
    kind, a few messages, and (with ``strict``) the unbalanced strict
    lifecycle pairs."""
    import collections

    from xllm_service_tpu_torch.devtools import (lifecycle, locks,
                                                  ownership, rcu)

    out = {"armed": [m.debug_enabled() for m in (locks, rcu, ownership,
                                                 lifecycle)]}
    for name, mod in (("locks", locks), ("rcu", rcu), ("state", ownership),
                      ("leak", lifecycle)):
        vs = mod.violations()
        out[name] = dict(collections.Counter(v.kind for v in vs))
        out[name + "_first"] = [str(v)[:400] for v in vs[:3]]
    if strict:
        out["strict"] = [str(v)[:400] for v in lifecycle.strict_imbalances()]
    return out


def verified_master_child(argv) -> int:
    """``python3 chip_smoke.py --verified-master ARGS...``: phase 4u's
    master, the port's ``Master`` with ``ServiceOptions`` from ARGS, in a
    process whose environment arms the four verifiers (VERIFIERS) and sets
    ``XLLM_NATIVE``. Once serving it prints ``NATIVE {...}``: the native
    core's status and the block hash's. SIGTERM stops it; then it prints
    ``REPORT {...}``: ``verifier_report`` and the native status."""
    import argparse
    import logging
    import signal

    from xllm_service_tpu_torch.common import hashing, native
    from xllm_service_tpu_torch.common.config import ServiceOptions
    from xllm_service_tpu_torch.master import Master

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)"
                        ".1s %(name)s: %(message)s")
    p = argparse.ArgumentParser()
    ServiceOptions.add_cli_args(p)
    master = Master(ServiceOptions.from_cli_args(p.parse_args(argv)))
    master.start()
    print("NATIVE " + json.dumps({
        "status": native.status(), "blockhash": hashing.native_available(),
        "blockhash_error": hashing.native_error()}), flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    master.stop()
    print("REPORT " + json.dumps({**verifier_report(),
                                  "native": native.status()}), flush=True)
    return 0


def verified_agent_child(argv) -> int:
    """``python3 chip_smoke.py --verified-agent ARGS...``: phase 4u's
    agent, the agent's own entry point (``engine/agent.py::main`` with
    ARGS) on Llama-3-8B at AUTO_LAYERS layers, beating every
    AUTO_HEARTBEAT_S on a VERIFIED_LEASE_S lease, in a process whose
    environment arms the four verifiers. It imports and starts CUDA at
    once, then waits for a ``go`` line on standard input before it builds
    the agent (a replacement starts warm). Each ``report`` line is
    answered with ``REPORT {...}`` (the verifier findings so far, the
    token ids it pushed by service request id, the launches of kernels 1
    and 2); end of input drains and stops it, and it prints a last
    ``REPORT`` with the strict pairs' balance."""
    import logging
    import signal

    from xllm_service_tpu_torch.engine import agent as agent_mod

    kernels = mh_kernels()
    torch.cuda.init()
    box: dict = {"toks": {}}
    go = threading.Event()

    def rep(strict):
        return "REPORT " + json.dumps({
            **verifier_report(strict), "toks": box["toks"],
            "name": box.get("name"),
            "launches": {k: fn.launches for k, fn in kernels.items()}})

    def commands():
        for line in sys.stdin:
            if line.strip() == "go":
                go.set()
            elif line.strip() == "report":
                print(rep(False), flush=True)
        go.set()
        os.kill(os.getpid(), signal.SIGTERM)

    engine_config = agent_mod.engine_config
    build_agent = agent_mod.build_agent

    def build(args, coord=None):
        agent = build_agent(args, coord)
        agent.cfg.heartbeat_interval_s = AUTO_HEARTBEAT_S
        agent.cfg.lease_ttl_s = VERIFIED_LEASE_S
        push = agent.streamer.push

        def recording(dest, out):
            for o in out.outputs:
                box["toks"].setdefault(out.service_request_id, []).extend(
                    o.token_ids)
            push(dest, out)
        agent.streamer.push = recording
        box["name"] = agent.name
        return agent

    agent_mod.engine_config = lambda args: auto_cut(engine_config(args))
    agent_mod.build_agent = build
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)"
                        ".1s %(name)s: %(message)s")
    threading.Thread(target=commands, daemon=True).start()
    print("WARM", flush=True)
    go.wait()
    try:
        agent_mod.main(argv)
    finally:
        print(rep(True), flush=True)
    return 0


class VerifiedChild:
    """One of phase 4u's processes (``--verified-master`` or
    ``--verified-agent`` of this script) with the verifiers armed by its
    environment; its output in a log under ``build/``, whose tagged lines
    (``NATIVE``, ``REPORT``, ``WARM``) the phase reads."""

    def __init__(self, mode, args, log_name, **env):
        import subprocess

        root = os.path.dirname(os.path.abspath(__file__))
        self.log_path = os.path.join(root, "build", log_name)
        self.is_master = mode == "--verified-master"
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, *args],
            cwd=root, stdin=subprocess.PIPE, text=True,
            stdout=open(self.log_path, "w"), stderr=subprocess.STDOUT,
            env={**os.environ, **VERIFIERS, **env})

    def tail(self):
        with open(self.log_path) as f:
            return "".join(f.readlines()[-30:])

    def tagged(self, tag):
        with open(self.log_path) as f:
            return [json.loads(ln[len(tag) + 1:]) if ln[len(tag) + 1:].strip()
                    else {} for ln in f if ln.startswith(tag + " ")
                    or ln.rstrip("\n") == tag]

    def wait_tag(self, tag, n=1, timeout=120.0):
        t0 = time.monotonic()
        while len(self.tagged(tag)) < n:
            assert self.proc.poll() is None, \
                f"{self.log_path} exited {self.proc.returncode}:\n" \
                f"{self.tail()}"
            assert time.monotonic() - t0 < timeout, \
                f"no {tag} line in {self.log_path}:\n{self.tail()}"
            time.sleep(0.02)
        return self.tagged(tag)[n - 1]

    def send(self, line):
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def ask(self):
        """The agent's findings so far."""
        n = len(self.tagged("REPORT"))
        self.send("report")
        return self.wait_tag("REPORT", n + 1, timeout=30)

    def finish(self, timeout=60):
        """End of input (an agent drains), SIGTERM (a master stops); the
        last REPORT."""
        if self.proc.poll() is None:
            self.proc.stdin.close()
            if self.is_master:
                self.proc.terminate()
            self.proc.wait(timeout=timeout)
        assert self.proc.returncode == 0, \
            f"{self.log_path} exited {self.proc.returncode}:\n{self.tail()}"
        return self.tagged("REPORT")[-1]

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def hotpath_of(port):
    return MasterCall(port, "/admin/hotpath", None).json()


def cancelled_stream(port, prompt):
    """A streamed request whose client hangs up after
    VERIFIED_CANCEL_AFTER frames; its service request id."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(
            {"model": "llama3-8b", "prompt": prompt, "stream": True,
             "max_tokens": VERIFIED_CANCEL_NEW, "temperature": 0.0,
             "ignore_eos": True}),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200, r.status
        sid = r.getheader("x-request-id")
        frames = 0
        while frames < VERIFIED_CANCEL_AFTER:
            if r.fp.readline() == b"\n":
                frames += 1
        return sid
    finally:
        conn.close()


_ID_TS = re.compile(rb'"(id|created)": ?("[^"]*"|\d+)')


def scrub_ids(body: bytes) -> bytes:
    """A response's bytes with its random ids and timestamps blanked."""
    return _ID_TS.sub(rb'"\1":_', body)


def verified_start(cfg):
    """Start phase 4u's processes (a phase early, so that they warm up
    while it runs): the port's coordination server here, xlint over the
    port's tree, master A (``XLLM_NATIVE=1``) and master B
    (``XLLM_NATIVE=0``), the agent and its replacement (which waits for
    ``go``), each a process of this script with the verifiers armed from
    its start. Returns the phase's state for :func:`verified_phase`;
    :func:`verified_stop` ends what it started."""
    import subprocess

    from xllm_service_tpu_torch.common.net import pick_free_port
    from xllm_service_tpu_torch.coordination.memory import MemoryStore
    from xllm_service_tpu_torch.coordination.server import (
        CoordinationServer,
    )
    from xllm_service_tpu_torch.engine import agent as agent_mod

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    u: dict = {"t0": time.monotonic(), "root": root, "procs": [],
               "masters": {}}
    u["lint"] = subprocess.Popen(
        [sys.executable, "-m", "xllm_service_tpu_torch.devtools.xlint",
         "--format", "json", "xllm_service_tpu_torch"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    srv = u["srv"] = CoordinationServer(host="127.0.0.1", port=0,
                                        store=MemoryStore())
    srv.start_background()
    addr = u["addr"] = f"127.0.0.1:{srv.port}"
    try:
        for which, native_on in (("A", "1"), ("B", "0")):
            http_port = pick_free_port("127.0.0.1")
            u["masters"][which] = (http_port, VerifiedChild(
                "--verified-master", [
                    *VERIFIED_MASTER_ARGS, "--coordination-addr", addr,
                    "--http-port", str(http_port), "--rpc-port",
                    str(pick_free_port("127.0.0.1"))],
                f"phase4u_master_{which}.log", XLLM_NATIVE=native_on))
            u["procs"].append(u["masters"][which][1])
        for key in ("first", "spare"):
            port = pick_free_port("127.0.0.1")
            args = [a.format(coordination_addr=addr, port=port)
                    for a in auto_agent_args(cfg)[1:]]
            u[key] = VerifiedChild("--verified-agent", args,
                                   f"phase4u_agent_{key}.log")
            u["procs"].append(u[key])
            u[key + "_name"] = f"127.0.0.1:{port}"
            u["acfg"] = auto_cut(agent_mod.engine_config(
                agent_mod._parser().parse_args(args)))
        u["first"].send("go")
    except BaseException:
        verified_stop(u)
        raise
    return u


def verified_stop(u):
    for p in u["procs"]:
        p.kill()
    u["srv"].stop()
    if u["lint"].poll() is None:
        u["lint"].kill()
        u["lint"].wait()


def verified_phase(u, llama, engine_mod, refs, card):
    """Phase 4u: the port's master and agent with the four runtime
    verifiers armed (locks, RCU, state ownership, lifecycle pairs), the
    native hot core on and off, and xlint over the port, on the processes
    :func:`verified_start` started: two masters and an agent (Llama-3-8B
    at AUTO_LAYERS layers, random bf16 weights from its seed). ``refs``:
    the prompts phase 4t served through its agents (phase 4's, its
    shared-prefix pair among them) and their streams from an in-process
    engine on the same configuration and seed (drawn here when ``refs``
    holds only the prompts).
    (a) those requests through A, streamed and whole, and one stream its
    client leaves after VERIFIED_CANCEL_AFTER frames: A's native status
    shows all four components and the block hash loaded, every greedy
    stream equal to the reference's or parting at a near-tie
    (``compare_streams``), the cancelled one stopped early; (b) the same
    requests through B: each body whose tokens equal A's is
    byte-identical to A's but for ids and timestamps; (c) the agent
    SIGKILLed (its findings taken first), evicted by both masters, the
    replacement (started warm) registered and serving; (d) xlint over the
    port's tree, run beside the phase, clean. Every process's verifiers
    must have recorded nothing, and no strict pair may stay unbalanced
    where its process stops. The masters' route and stream CPU a request
    under (a) and (b), tok/s with the verifiers armed and the phase's
    seconds are logged. Returns the agents' launches of kernels 1 and
    2."""
    t_phase = time.monotonic()
    masters, first, spare = u["masters"], u["first"], u["spare"]
    name1, name2, acfg = u["first_name"], u["spare_name"], u["acfg"]
    try:
        ref_params = llama.init_params(
            acfg.model, torch.Generator(device="cuda").manual_seed(acfg.seed),
            "cuda")
        if "want" not in refs:
            refs["want"] = serve_greedy(engine_mod, acfg, ref_params,
                                        refs["prompts"],
                                        max_tokens=VERIFIED_NEW)[0]
        reqs, want = refs["prompts"], refs["want"]
        natives = {w: m[1].wait_tag("NATIVE") for w, m in masters.items()}
        st_a = natives["A"]
        log(f"  coordination server {u['addr']}; masters A (XLLM_NATIVE=1) "
            f"HTTP :{masters['A'][0]}, B (XLLM_NATIVE=0) HTTP "
            f":{masters['B'][0]}; A's native core "
            f"{st_a['status']['components']} from "
            f"{os.path.relpath(st_a['status']['so'], u['root'])}, block "
            f"hash {st_a['blockhash']}; B's "
            f"{natives['B']['status']['components']}")
        assert st_a["status"]["loaded"] and all(
            st_a["status"]["components"].values()) and \
            not st_a["status"]["error"], st_a
        assert st_a["blockhash"], st_a
        assert not any(natives["B"]["status"]["components"].values()), \
            natives["B"]

        def registered(name, present=True, timeout=90):
            t = time.monotonic()
            wait_for(lambda: all(
                (hotpath_of(p)["loadinfo"]["ages_s"].get(name, -1) >= 0)
                == present for p, _ in masters.values()),
                f"{name} {'in' if present else 'out of'} both masters' "
                "fleets", timeout=timeout)
            return time.monotonic() - t

        wait_s = registered(name1)
        log(f"  agent {name1} (llama3-8b at {AUTO_LAYERS} layers) registered "
            f"at both masters {time.monotonic() - u['t0']:.1f} s after its "
            f"start (waited {wait_s:.1f} s here)")

        streamed = {n for i, n in enumerate(reqs) if i % 2 == 0}
        cancel_prompt = next(iter(reqs.values()))

        def serve(port, cancel):
            calls: dict = {}

            def send(n, ids, stream):
                body = master_greedy(ids, "", stream, VERIFIED_NEW)
                calls[n] = MasterCall(port, "/v1/completions", body, stream)
            threads = [threading.Thread(target=send,
                                        args=(n, ids, n in streamed))
                       for n, ids in reqs.items()]
            box = {}
            if cancel:
                threads.append(threading.Thread(target=lambda: box.setdefault(
                    "sid", cancelled_stream(port, cancel_prompt))))
            t = time.monotonic()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.monotonic() - t
            for n, c in calls.items():
                check_call(c, n, VERIFIED_NEW, n in streamed)
            return calls, wall, box.get("sid")

        cpu0 = {w: hotpath_of(p)["cpu"] for w, (p, _) in masters.items()}
        calls_a, wall_a, cancel_sid = serve(masters["A"][0], True)
        calls_b, wall_b, _ = serve(masters["B"][0], False)
        cpu1 = {w: hotpath_of(p)["cpu"] for w, (p, _) in masters.items()}
        per_req = {"A": len(reqs) + 1, "B": len(reqs)}

        def cpu_ms(w, k):
            d = cpu1[w][k]["cpu_s"] - cpu0[w][k]["cpu_s"]
            return d * 1e3 / per_req[w]
        cpu_line = "; ".join(
            f"{w} ({'native' if w == 'A' else 'python'}) route "
            f"{cpu_ms(w, 'route'):.3f} ms, stream {cpu_ms(w, 'stream'):.3f}"
            " ms" for w in ("A", "B"))
        rep1 = first.ask()
        toks = rep1["toks"]
        got_a = {n: toks[c.headers["x-request-id"]]
                 for n, c in calls_a.items()}
        got_b = {n: toks[c.headers["x-request-id"]]
                 for n, c in calls_b.items()}
        compare_streams(llama, acfg, ref_params, reqs, got_a, want,
                        "4u (a): master A's streams vs an in-process engine")
        # B's requests find A's prefixes cached, so the agent computes
        # their first tokens by another route: a stream may part at a
        # near-tie. Where the tokens are equal, the bodies must be too.
        compare_streams(llama, acfg, ref_params, reqs, got_b, want,
                        "4u (b): master B's streams vs an in-process engine")
        n_cancelled = len(toks.get(cancel_sid, []))
        assert n_cancelled < VERIFIED_CANCEL_NEW, \
            f"the cancelled stream ran to its end ({n_cancelled} tokens)"
        same = [n for n in calls_a if got_a[n] == got_b[n]]
        assert any(n in streamed for n in same) and any(
            n not in streamed for n in same), f"4u (b): too few equal " \
            f"streams to compare bodies: {same}"
        differ = [n for n in same
                  if scrub_ids(calls_a[n].body) != scrub_ids(calls_b[n].body)]
        assert not differ, f"4u (b): bodies differ between A and B: {differ}"
        tps = len(reqs) * VERIFIED_NEW / wall_a
        log(f"  (a) {len(reqs)} requests through A in {wall_a:.2f} s, "
            f"{tps:.1f} generated tok/s with the verifiers armed; the client "
            f"that left after {VERIFIED_CANCEL_AFTER} frames: its stream "
            f"stopped at {n_cancelled} of {VERIFIED_CANCEL_NEW} tokens "
            f"({card})")
        log(f"  (b) the same through B in {wall_b:.2f} s: {len(same)} of "
            f"{len(reqs)} with A's tokens, and each of those bodies equal to "
            f"A's byte for byte but for ids and timestamps; "
            f"master CPU a request (CPU_ATTR): {cpu_line} (information; "
            f"{card})")

        # (c) the agent dies; the replacement joins.
        t = time.monotonic()
        first.kill()
        spare.send("go")
        evict_s = registered(name1, present=False)
        reg_s = registered(name2)
        name0, prompt0 = next(iter(reqs.items()))
        c = MasterCall(masters["A"][0], "/v1/completions",
                       master_greedy(prompt0, "", True, VERIFIED_NEW), True)
        check_sse(c, "after", VERIFIED_NEW)
        rep2 = spare.ask()
        after = rep2["toks"][c.headers["x-request-id"]]
        compare_streams(llama, acfg, ref_params, {name0: prompt0},
                        {name0: after}, {name0: want[name0]},
                        "4u (c): the replacement vs an in-process engine")
        log(f"  (c) {name1} SIGKILLed: out of both masters' fleets "
            f"{evict_s:.2f} s later; the replacement {name2} registered "
            f"{reg_s:.2f} s after that and served {name0} "
            f"({time.monotonic() - t:.1f} s; {card})")
        del ref_params
        gc.collect()
        torch.cuda.empty_cache()
        final2 = spare.finish()
        finals = {"agent 1 (at its kill)": rep1, "agent 2": final2}
        for w in ("A", "B"):
            finals[f"master {w}"] = masters[w][1].finish()
        launches = [rep1["launches"][k] + final2["launches"][k]
                    for k in ("paged_attention", "mq_paged_attention")]
        # (d) xlint over the port's tree, on this machine's Python.
        out, _ = u["lint"].communicate(timeout=120)
    finally:
        verified_stop(u)
    lint_rep = json.loads(out.strip().splitlines()[-1])
    assert u["lint"].returncode == 0 and lint_rep["count"] == 0, out[-2000:]
    log(f"  (d) xlint over xllm_service_tpu_torch: {lint_rep['files']} "
        f"files, {lint_rep['count']} violations, "
        f"{len(lint_rep['hatches'])} hatches, every one with its reason")

    bad = {}
    for who, r in finals.items():
        assert all(r["armed"]), f"{who}: verifiers not armed {r['armed']}"
        counts = {k: r[k] for k in ("locks", "rcu", "state", "leak")}
        log(f"  violations, {who}: {counts}; strict imbalances "
            f"{len(r.get('strict', []))} ({card})")
        if any(counts.values()) or r.get("strict"):
            bad[who] = {k: r[k] for k in r if k.endswith("_first")
                        or k == "strict"}
    assert not bad, f"4u: verifier findings {bad}"
    log(f"  kernels 1 and 2 launched {launches[0]} and {launches[1]} times "
        "in the two agents")
    log(f"  phase 4u: {time.monotonic() - t_phase:.1f} s here, "
        f"{time.monotonic() - u['t0']:.1f} s from its processes' start "
        f"({card})")
    return launches


# --------------------------------------------------------------- phase 4v
# The eight service-plane bench twins, each as ``python -m`` at these
# sizes: (module, argv, the report's headline keys to print).
SERVICE_TWINS = (
    ("master_hotpath_bench", ["--quick"]),
    ("kvcache_routing_bench", ["--quick"]),
    ("generations_bench", ["--quick"]),
    ("bench_tracing_overhead", ["--quick"]),
    ("bench_profile_overhead", ["--quick"]),
    ("overload_bench", ["--steady-s", "3", "--burst-s", "6",
                        "--skip-noshed", "--skip-autoscale",
                        "--skip-overhead"]),
    ("outage_bench", ["--steady-s", "3", "--outage-s", "5",
                      "--recovery-s", "3", "--skip-control"]),
    ("fleet_bench", ["--quick"]),
)


def start_twin(name, argv):
    """One twin as ``python -m`` in a session of its own (its children
    are reaped by the twin). The profile twin's exit gate (a timing of
    1 %) is lifted: its verdict is printed, not held."""
    import subprocess

    env = {**os.environ, "OMP_NUM_THREADS": "1", "PROFILE_GATE_PCT": "1e9"}
    p = subprocess.Popen(
        [sys.executable, "-m", f"xllm_service_tpu_torch.benchmarks.{name}",
         *argv], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return p, time.monotonic()


def finish_twin(name, started, timeout=300):
    """A started twin's standard output and its wall seconds."""
    import signal

    p, t = started
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    assert p.returncode == 0, f"4v {name}: exit {p.returncode}: {err[-3000:]}"
    return out, time.monotonic() - t


def twin_headline(name, out):
    """(the headline keys of a twin's output, the reference's acceptance
    failures: empty when it meets its gate)."""
    from xllm_service_tpu_torch.benchmarks import (
        bench_profile_overhead,
        fleet_bench,
        master_hotpath_bench,
        outage_bench,
        overload_bench,
    )

    lines = out.strip().splitlines()
    docs = [json.loads(ln[len("BENCH_DOC "):]) for ln in lines
            if ln.startswith("BENCH_DOC ")]
    if name == "master_hotpath_bench":
        r = json.loads(out)
        stages = {k: v["p50"] for k, v in r.get("master_stages_ms",
                                                {}).items()}
        return ({"requests": r["requests"], "errors": r["errors"],
                 "req_per_s": r["req_per_s"],
                 "master_wire_ttft_ms": r["master_wire_ttft_ms"],
                 "stage_p50_ms": stages,
                 "master_cpu_ms_per_request":
                     r["master_cpu_ms_per_request"]},
                master_hotpath_bench.gate(r))
    if name == "kvcache_routing_bench":
        r = json.loads(out)
        idx, h = r["index"], r["hashing"]
        return ({"match_speedup_1t": idx["match_speedup_1t"],
                 "match_speedup_4t": idx["match_speedup_4t"],
                 "match_new_p50_ms": idx["match_new"]["p50_ms"],
                 "index_blocks": idx["config"]["index_blocks"],
                 "ingest_new_keys_per_s": idx["ingest_new_keys_per_s"],
                 "remove_instance_new_ms": idx["remove_instance_new_ms"],
                 "hash_new_us_per_prompt": h["new_us_per_prompt"],
                 "hash_speedup": h["speedup"],
                 "native_hash": h["native_hash"]}, [])
    if name == "generations_bench":
        rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
        return ({"json_deltas_per_s": rows[0]["deltas_per_s"],
                 "msgpack_deltas_per_s": rows[1]["deltas_per_s"],
                 "msgpack_vs_json": rows[2]["value"]}, [])
    if name == "bench_tracing_overhead":
        d = docs[-1]
        first = json.loads(lines[0])
        return ({**d["headline"], **d["fleet_endpoint_cost"],
                 "disabled_span_call_ns": first["disabled_span_call_ns"],
                 "off_p50_ms": d["modes"]["off"]["p50_ms"]}, [])
    if name == "bench_profile_overhead":
        d = docs[-1]
        return ({**d["headline"],
                 "overall_p50_delta_pct": d["overall_p50_delta_pct"],
                 "sample_tick_us": d["sample_tick_us"],
                 "amortized_cpu_pct": d["amortized_cpu_pct"],
                 "within_reference_1pct_gate":
                     bench_profile_overhead.passes(d, 1.0)}, [])
    if name == "overload_bench":
        r = json.loads(out)
        s = r["shed"]
        return ({**{k: v for k, v in r["headline"].items()
                    if v is not None},
                 "steady_ttft_p50_ms": s["steady_ttft_p50_ms"],
                 "burst_admitted_ttft_p50_ms":
                     s["burst_admitted_ttft_p50_ms"],
                 "burst_shed_count": s["burst_shed_count"],
                 "burst_admitted_count": s["burst_admitted_count"],
                 "burst_shed_p50_ms": s["burst_shed_p50_ms"],
                 "errors": s["errors"]}, overload_bench.gate(r))
    if name == "outage_bench":
        r = json.loads(out)
        d = r["degraded"]
        return ({**r["headline"],
                 "rps": [d[p]["rps"] for p in ("steady", "outage",
                                               "recovery")],
                 "errors": [d[p]["errors"] for p in ("steady", "outage",
                                                     "recovery")],
                 "evictions_total": d["evictions_total"],
                 "final_monitor_state": d["final_monitor_state"],
                 "reconnect_spread_s": d["reconnect_spread_s"]},
                outage_bench.gate(r))
    r = json.loads(out)   # fleet_bench
    return ({**r["headline"],
             "served": {("on" if leg["native_on"] else "off"):
                        f"{leg['served']}/{leg['windows'][0]['requests']}"
                        for leg in r["legs"]},
             "mode": r["legs"][0]["mode"],
             "agg_req_per_s": {("on" if leg["native_on"] else "off"):
                               leg["agg_req_per_s"] for leg in r["legs"]}},
            fleet_bench.gate(r))


def services_phase(card):
    """Phase 4v: the eight service-plane bench twins on this card's host
    (none of them touches the card), each once at the sizes of
    SERVICE_TWINS, the outage twin beside the overload twin and the rest
    one after another: a line each with its headline keys and wall seconds,
    beside the card line and the host's CPUs; each held to the
    reference bench's acceptance gate (master_hotpath: no errors and the
    four stages; overload: 429s, their p99 under 50 ms; outage: no
    eviction, the monitor CONNECTED again; fleet: both sides of the
    native A/B served every request). Returns the wall seconds by twin."""
    host = (f"host: os.cpu_count() {os.cpu_count()}, affinity "
            f"{sorted(os.sched_getaffinity(0))}")
    walls, failed = {}, {}
    # The outage twin's paced drive (8 requests a second, 11 s) mostly
    # waits: it runs beside the overload twin's, started 2 s ahead so its
    # stack holds its ports before the other picks free ones.
    argvs = dict(SERVICE_TWINS)
    outage = start_twin("outage_bench", argvs["outage_bench"])
    time.sleep(2.0)
    order = ["overload_bench", "outage_bench"] + [
        n for n in argvs if n not in ("overload_bench", "outage_bench")]
    for name in order:
        argv = argvs[name]
        out, wall = finish_twin(name, outage if name == "outage_bench"
                                else start_twin(name, argv))
        head, bad = twin_headline(name, out)
        walls[name] = round(wall, 1)
        log(f"  4v {name} {' '.join(argv)}: {json.dumps(head)}; wall "
            f"{wall:.1f} s ({card}; {host})")
        if bad:
            failed[name] = bad
    assert not failed, f"4v: twins below the reference's gate: {failed}"
    return walls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from xllm_service_tpu_torch.common.device import card_line
    from xllm_service_tpu_torch.engine import engine as engine_mod
    from xllm_service_tpu_torch.models import llama
    from xllm_service_tpu_torch.ops import _build, page_dma
    from xllm_service_tpu_torch.ops import cp_paged_attention as cp
    from xllm_service_tpu_torch.ops.fused_decode_attention import (
        fused_decode_attention,
        fused_decode_attention_plain,
    )
    from xllm_service_tpu_torch.ops.mq_paged_attention import (
        mq_paged_attention,
        mq_paged_attention_plain,
        mq_route,
    )
    from xllm_service_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_plain,
        split_count,
    )
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    KERNEL_WRAPPERS.extend([paged_attention, mq_paged_attention,
                            fused_decode_attention, page_dma.gather_kv_pages,
                            page_dma.scatter_kv_pages, cp.paged_partial])

    # Phase 1: environment.
    card = card_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {card} | "
        f"devices {torch.cuda.device_count()}")

    # Phase 2: the compile gate builds the six libraries in parallel and
    # launches each kernel arm once.
    from xllm_service_tpu_torch.benchmarks import compile_gate

    t = time.monotonic()
    logs: dict = {}
    gate = compile_gate.run_gate(logs=logs)
    log(f"[2] compile gate: built {sorted(logs) or 'nothing (up to date)'} "
        f"in {time.monotonic() - t:.1f} s into {_build.BUILD_DIR}; arms "
        f"launched once each")
    print(json.dumps(gate), flush=True)
    assert gate["backend"] == "cuda" and not gate["failed_arms"] and all(
        v["ok"] for v in gate["arms"].values()), gate
    for name, text in logs.items():
        for line in ptxas_report(text):
            log(f"  {name}: {line}")
        for line in text.splitlines():
            if "Performance Loss" in line:       # e.g. serialized wgmma
                log(f"  {name}: {line.strip()[:200]}")

    # Phase 3: kernels against plain, and times.
    log("[3] kernels against their plain versions")
    k1 = check_decode_kernel(paged_attention, paged_attention_plain,
                             split_count, _build.kernel_fn)
    k2 = check_mq_kernel(mq_paged_attention, mq_paged_attention_plain,
                         _build.kernel_fn)
    check_mq_verify(mq_paged_attention, mq_paged_attention_plain)
    k3 = check_fused_kernel(fused_decode_attention,
                            fused_decode_attention_plain, split_count,
                            _build.kernel_fn)
    k4, k5 = check_page_movers(page_dma, build_mesh, MeshConfig,
                               cp.ShardedPages)
    k6 = check_cp_kernel(cp, paged_attention, paged_attention_plain,
                         build_mesh, MeshConfig, _build.kernel_fn)
    log("[3] kernels 4-5 at DeepSeek-V2-Lite's MLA block, kernel 6 at "
        "Qwen2-VL-2B's group 6")
    k4_mla, k5_mla = check_page_movers(
        page_dma, build_mesh, MeshConfig, cp.ShardedPages, L=27, n_kv=1,
        hd=576, what="deepseek-v2-lite MLA", sweep=False)
    k6_g6 = check_cp_kernel(cp, paged_attention, paged_attention_plain,
                            build_mesh, MeshConfig, _build.kernel_fn,
                            n_q=12, n_kv=2, what="qwen2-vl-2b's 12/2 heads",
                            extras=False)
    log("[3] head dim 256 (Gemma) and kernel 2's walk shapes")
    t = time.monotonic()
    check_hd256_decode(paged_attention, paged_attention_plain, split_count)
    check_gqa_decode(paged_attention, paged_attention_plain, 28, 4)
    check_gqa_decode(paged_attention, paged_attention_plain, 12, 2)
    check_hd256_fused_and_partial(fused_decode_attention,
                                  fused_decode_attention_plain, cp)
    check_mq_walk_shapes(mq_paged_attention, mq_paged_attention_plain,
                         mq_route)
    log(f"  head dim 256 and walk shapes: {time.monotonic() - t:.1f} s")
    log("[3] a model shard's shapes: kernel 1 at 8/2 and 8/1 heads, "
        "kernel 2 at groups 4 and 8, kernels 4-5 at a model=4 shard's block")
    t = time.monotonic()
    k1_82 = check_gqa_decode(paged_attention, paged_attention_plain, 8, 2)
    k1_81 = check_gqa_decode(paged_attention, paged_attention_plain, 8, 1)
    k2_groups = check_mq_groups(mq_paged_attention, mq_paged_attention_plain,
                                mq_route)
    k4_tp, k5_tp = check_page_movers(
        page_dma, build_mesh, MeshConfig, cp.ShardedPages, L=TP_LAYERS,
        n_kv=2, hd=HD, what="llama3-8b model=4 shard", sweep=False)
    log(f"  a model shard's shapes: {time.monotonic() - t:.1f} s")
    log("[3] a seq x model grid shard's shapes: kernel 6 at a model=2 "
        "shard's 16/4 heads, kernels 4-5 at a seq=2 x model=2 grid shard's "
        "block")
    t = time.monotonic()
    k6_16_4 = check_cp_kernel(cp, paged_attention, paged_attention_plain,
                              build_mesh, MeshConfig, _build.kernel_fn,
                              n_q=16, n_kv=4,
                              what="llama3-8b model=2 shard's 16/4 heads",
                              extras=False, seq=2)
    k4_grid, k5_grid = check_page_movers(
        page_dma, build_mesh, MeshConfig, cp.ShardedPages, L=GRID_LAYERS,
        n_kv=4, hd=HD, what="llama3-8b seq=2 x model=2 grid shard",
        sweep=False,
        seq=2)
    log(f"  a grid shard's shapes: {time.monotonic() - t:.1f} s")

    # Phase 4: serving Llama-3-8B at full width and depth.
    log("[4] serving llama3-8b (32 layers, random weights, seed 0)")
    cfg = phase4_config()
    t = time.monotonic()
    params = llama.init_params(cfg.model,
                               torch.Generator(device="cuda").manual_seed(0),
                               "cuda")
    torch.cuda.synchronize()
    n_params = sum(t_.numel() for group in params.values()
                   for leaf in group.values()
                   for t_ in (leaf.values() if isinstance(leaf, dict)
                              else [leaf]))
    log(f"  weights: {n_params / 1e9:.2f} B parameters in "
        f"{time.monotonic() - t:.1f} s")
    rng = np.random.default_rng(0)
    V = cfg.model.vocab_size
    lens = [int(rng.integers(640, 1025))] + \
        [int(x) for x in rng.integers(64, 1025, size=7)]
    prompts = [rng.integers(3, V, size=n).tolist() for n in lens]
    shared = [prompts[0][:512] + rng.integers(3, V, size=int(n)).tolist()
              for n in rng.integers(64, 513, size=2)]
    sampled_prompt = rng.integers(3, V, size=200).tolist()

    runs = []
    for r in range(2):
        reset_counts()
        t = time.monotonic()
        clocks = []
        toks, reasons, stats, ttft, tps = serve_once(
            engine_mod, cfg, params, prompts, shared, sampled_prompt,
            clocks=clocks)
        launches = (paged_attention.launches, mq_paged_attention.launches)
        log(f"  run {r}: {time.monotonic() - t:.1f} s, stats {stats}, "
            f"launches decode/mq {launches}")
        log(f"  run {r}: TTFT ms p50 {ttft[len(ttft) // 2]:.1f} max "
            f"{ttft[-1]:.1f}; {tps:.1f} generated tok/s over the run "
            f"(information only; {card})")
        log(f"  run {r}, host split: {StepClock.line(clocks[0])}")
        for name, tk in toks.items():
            assert len(tk) == 64 and reasons[name] == "length", \
                f"{name}: {len(tk)} tokens, reason {reasons[name]!r}"
        assert stats["prefix_hits"] >= 2 and \
            stats["prefix_hit_tokens"] >= 2 * 512, "no prefix hits"
        assert launches[0] > 0 and launches[1] > 0, "a kernel never launched"
        check_replays(stats, f"run {r}")
        runs.append((toks, launches, tps, ttft, clocks[0]))
    assert runs[0][0] == runs[1][0], "two runs of the same batch differ"
    log("  both runs gave identical tokens for all 11 requests")
    check_logits(llama, cfg, params, shared[0], 512)

    # Phase 4a: KV tiers at full width.
    log("[4a] KV tiers: HBM -> DRAM -> SSD and back, llama3-8b")
    tier_launches = tier_phase(engine_mod, cfg, params, page_dma, card)

    # Phase 4b: the fused decode writeback.
    log("[4b] serving under XLLM_KV_WRITEBACK=fused")
    fused_toks, fused_launches = fused_phase(
        engine_mod, cfg, params, prompts, shared, sampled_prompt,
        (fused_decode_attention, paged_attention), llama)
    same = sum(fused_toks[n] == runs[0][0][n] for n in fused_toks)
    log(f"  fused vs default route: {same}/{len(fused_toks)} requests with "
        "identical tokens (information only: the two sum in another order)")

    # Phase 4c: context-parallel serving.
    log(f"[4c] context-parallel serving on a seq=4 mesh, llama3-8b at "
        f"{CP_LAYERS} layers")
    cp_cfg, cp_params = depth_view(cfg, params, CP_LAYERS)
    _, cp_launches = cp_phase(
        engine_mod, cp_cfg, cp_params, llama,
        (cp.paged_partial, paged_attention, mq_paged_attention,
         fused_decode_attention), card)

    # Phase 4d: KV tiers under the seq mesh.
    log("[4d] KV tiers on a seq=4 mesh: HBM -> DRAM -> SSD and back, "
        f"llama3-8b at {CP_LAYERS} layers")
    count = torch.cuda.device_count()
    tier_cp_phase(engine_mod, cp_cfg, cp_params, llama, page_dma,
                  cp.paged_partial,
                  [torch.device("cuda", i % count) for i in range(4)], card)
    del cp_params

    # Phase 4e: the decode step's host path.
    log("[4e] the captured decode step against the eager one; the bench "
        "and decode-profile twins, llama3-8b")
    graph_step_check(engine_mod, cfg, params)
    bench_bf16 = twins_phase(params, card)

    # Phase 4f: serving through the agent.
    log("[4f] serving llama3-8b through the engine agent behind a stub "
        f"master ({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated "
        "before: the weights alone)")
    t = time.monotonic()
    agent_launches, mix_ttft, split_4f, tps_4f = agent_phase(
        cfg, params, prompts, shared, sampled_prompt,
        runs, (paged_attention, mq_paged_attention),
        card)
    log(f"  phase 4f: {time.monotonic() - t:.1f} s")

    # Phase 4g: the admission path.
    log("[4g] the admission path at llama3-8b: chunked prefill, the "
        "Sarathi mixed step, offline preemption, the asynchronous install")
    t = time.monotonic()
    from xllm_service_tpu_torch.ops import attention
    g_launches = admission_phase(
        engine_mod, llama, attention, cfg, params, prompts, shared,
        sampled_prompt, runs[1][4], paged_attention, mq_paged_attention,
        mq_paged_attention_plain, card)
    log(f"  phase 4g: {time.monotonic() - t:.1f} s")

    # Phase 4h: speculative decoding.
    log("[4h] speculative decoding at llama3-8b: device-side n-gram "
        "drafts, the batched verify through kernel 2")
    t = time.monotonic()
    h_launches = spec_phase(engine_mod, llama, cfg, params,
                            (paged_attention, mq_paged_attention), card)
    log(f"  phase 4h: {time.monotonic() - t:.1f} s")

    # Phase 4i: PD disaggregation.
    log("[4i] PD disaggregation at llama3-8b: a prefill agent here and a "
        "decode agent in a second process, the KV over CUDA IPC "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    i_launches = pd_phase(cfg, params, llama, prompts, shared,
                          sampled_prompt, runs[0][0], mix_ttft,
                          (paged_attention, mq_paged_attention), card)
    from xllm_service_tpu_torch.benchmarks import pd_handoff_bench
    t_ = time.monotonic()
    rec = pd_handoff_bench.run("cuda", ctxs=PD_TWIN_CTXS)
    log("  pd_handoff_bench " + json.dumps(rec))
    log(f"  pd_handoff_bench twin: {time.monotonic() - t_:.1f} s; per-path "
        "handoff ms " + "; ".join(
            f"ctx {r['ctx']}: device {r['device_ms']:.3f} (open "
            f"{r['device_open_ms']:.3f}, copy {r['device_copy_ms']:.3f}), "
            f"stream {r['stream_ms']:.1f}, inline {r['inline_ms']:.1f}"
            for r in (rec[f"ctx_{c}"] for c in PD_TWIN_CTXS)) + f" ({card})")
    log(f"  phase 4i: {time.monotonic() - t:.1f} s")

    # Phase 4j: the llama family's variants.
    log("[4j] the llama family's variants at full width and depth: "
        "Gemma-2-9B, Qwen2-7B, Llama-3-8B in int8 "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    j_launches = variants_phase(
        engine_mod, llama, attention, cfg, params, prompts, shared,
        sampled_prompt, (paged_attention, mq_paged_attention,
                         paged_attention_plain), card, bench_bf16)
    log(f"  phase 4j: {time.monotonic() - t:.1f} s")

    # Phase 4k: checkpoint loading.
    log(f"[4k] checkpoint loading: llama3-8b at {K_LLAMA_DEPTH} layers as an "
        "HF model directory, loaded here and served by the agent from its "
        "command line; "
        f"qwen2-7b and gemma2-9b at {K_DEPTH} layers "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    k_launches = checkpoint_phase(
        engine_mod, llama, cfg, params, prompts, shared, sampled_prompt,
        split_4f, (paged_attention, mq_paged_attention), card)
    log(f"  phase 4k: {time.monotonic() - t:.1f} s")

    # Phase 4l: the agent at the reference's defaults.
    log("[4l] the agent at the reference's defaults: dp_size 2 on this "
        "card behind two stub masters, mux telemetry, msgpack dispatches, "
        "/metrics, traces, the profiler, an owner's death "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    l_launches = dp_mux_phase(cfg, params, llama, prompts, shared,
                              sampled_prompt, runs[0][0], tps_4f,
                              (paged_attention, mq_paged_attention), card)
    log(f"  phase 4l: {time.monotonic() - t:.1f} s")

    # Phase 4s: the port's own master.
    log("[4s] the port's master at the reference's defaults on the port's "
        "coordination server: two MIX agents, phase 4's requests and chats "
        "through it, CAR's prefix routing, several masters (the relay, an "
        "owner's death mid-stream, a takeover), shedding, a deadline "
        "mid-decode, a failing agent's breaker, a coordination outage, an "
        "agent's death mid-stream, a PD pair "
        f"at {MASTER_PD_LAYERS} layers under CAR and SLO_AWARE with a flip "
        "hint "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    s_launches = master_phase(cfg, params, llama, engine_mod, prompts,
                              shared, sampled_prompt, runs[0][0],
                              (paged_attention, mq_paged_attention), card)
    log(f"  phase 4s: {time.monotonic() - t:.1f} s")

    # Phase 4t: the autoscaler's closed loop.
    log("[4t] the autoscaler's closed loop: the port's master with the "
        "local actuator launches, drains and reaps port agents "
        f"(llama3-8b at {AUTO_LAYERS} layers), then replaces a killed "
        "fake engine through the default launcher "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    # 4o (f)'s decode agent starts once 4t's second agent reports: its
    # start overlaps the rest of 4t and 4o (a), (b).
    planes: dict = {}
    u_refs: dict = {}        # 4t's reference streams, which 4u serves
    try:
        t_launches = autoscale_phase(
            cfg, llama, engine_mod, prompts, shared,
            (paged_attention, mq_paged_attention), card,
            on_full=lambda: planes.setdefault("o", tp_decode_plane(
                cfg, "2", "phase4o_decode_agent.log")), refs=u_refs)
    except BaseException:
        if "o" in planes:
            close_plane(planes["o"])
        raise

    # Phase 4o (a), (b), (f): the model axis on phase 4's weights.
    log("[4o] the tensor, expert and data axes in one process on this card "
        "repeated: (a) llama3-8b bf16 on model=4, (b) its tier round trip, "
        "(f) model=2 PD pairs "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    o_plane = planes.get("o") or tp_decode_plane(
        cfg, "2", "phase4o_decode_agent.log")
    try:
        o_a, tp_mesh = tp_leg(engine_mod, llama, cfg, params, prompts,
                              shared,
                              (paged_attention, mq_paged_attention,
                               fused_decode_attention, cp.paged_partial),
                              card)
        log(f"  (a): {time.monotonic() - t:.1f} s")
        t_ = time.monotonic()
        log("  (b) phase 4a's tier round trip on (a)'s model=4 pool:")
        o_b = tier_phase(engine_mod, *depth_view(cfg, params, TP_LAYERS),
                         page_dma, card, mesh=tp_mesh)
        assert o_b[0] % 4 == 0 and o_b[1] % 4 == 0, \
            "a mover did not launch once a shard"
        log(f"  (b): {time.monotonic() - t_:.1f} s; kernels 4/5 {o_b} (one "
            f"launch a shard, blocks of [{TP_LAYERS}, 2, 8, 2, 16, 128] a "
            "shard)")
    except BaseException:
        close_plane(o_plane)
        raise
    t_ = time.monotonic()
    o_f = tp_pd_leg(cfg, params, llama, prompts, shared, engine_mod, card,
                    o_plane)
    log(f"  (f): {time.monotonic() - t_:.1f} s")
    log(f"  phase 4o (a), (b), (f): {time.monotonic() - t:.1f} s")

    # Phase 4p: one engine instance over processes, ranks on this card.
    log("[4p] the mesh over processes, ranks on this card over gloo: (a) "
        f"llama3-8b at {MH_TP_LAYERS} layers on model=2 as two ranks, (b) "
        f"the agent as two ranks at {MH_AGENT_LAYERS} layers, "
        f"(c) mixtral-8x7b int8 at {MH_MOE_LAYERS} layers on expert=2 x "
        f"model=2 as four ranks, (d) llama3-8b at {MH_SEQ_LAYERS} layers "
        "on seq=2 as two ranks "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    from xllm_service_tpu_torch.models import deepseek_moe
    # 4q (e)'s decode agent starts before 4p (d): its start overlaps (d)
    # and 4q (a), (c).
    try:
        p_launches = mh_phase(
            engine_mod, llama, deepseek_moe, card,
            before_d=lambda: planes.setdefault("q", tp_decode_plane(
                cfg, "seq=2,model=2", "phase4q_decode_agent.log")))
    except BaseException:
        if "q" in planes:
            close_plane(planes["q"])
        raise
    log(f"  phase 4p: {time.monotonic() - t:.1f} s")

    # Phase 4q: seq together with model or expert.
    log("[4q] seq together with model or expert on this card repeated: (a) "
        "llama3-8b bf16 on seq=2 x model=2 (the page-and-head grid), (c) "
        "its tier round trip, (e) a PD pair on that grid over CUDA IPC, "
        f"(b) mixtral-8x7b int8 at {MH_MOE_LAYERS} "
        f"layers on seq=2 x expert=2, (d) llama3-8b at {MH_SEQ_LAYERS} "
        "layers on seq=2 x model=2 as four ranks "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    q_launches = grid_phase(engine_mod, llama, deepseek_moe, page_dma, cfg,
                            params, prompts, shared, sampled_prompt,
                            (paged_attention, mq_paged_attention,
                             fused_decode_attention, cp.paged_partial), card,
                            plane=planes.get("q"))
    log(f"  phase 4q: {time.monotonic() - t:.1f} s")

    # Phase 4r: chunks riding on a model axis, the pipeline, the train step.
    log("[4r] (a) llama3-8b bf16 on model=2 with chunks riding decode "
        f"steps, (b) the pipeline over pipe at llama3-8b's width, {PP_LAYERS}"
        f" layers f32, (c) the train step at llama3-8b's width, "
        f"{TRAIN_LAYERS} layers f32 (TF32 off for matmuls), on data=2 x "
        "model=4 ("
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    r_launches = ride_phase(engine_mod, llama, cfg, params, prompts,
                            (paged_attention, mq_paged_attention), card)
    log(f"  phase 4r: {time.monotonic() - t:.1f} s")

    # Phase 4n: multimodal and EPD.
    log("[4n] Qwen2-VL-2B at full width and depth: the vision encoder, "
        "EPD through a MIX and an ENCODE agent, chunked multimodal, a seq=4 "
        "pool, a PD pair over CUDA IPC "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    n_launches = vl_phase(engine_mod, (paged_attention, mq_paged_attention,
                                       fused_decode_attention,
                                       cp.paged_partial), card)
    log(f"  phase 4n: {time.monotonic() - t:.1f} s")

    # Phase 4m: MoE and MLA. Phase 4's weights go first: Mixtral-8x7B's
    # int8 weights alone take about 47 GB.
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("[4m] MoE and MLA at full width: one MoE layer at mixtral-8x7b's "
        "width; mixtral-8x7b int8 through the agent, on a seq=4 pool and "
        "under speculation; deepseek-v2-lite bf16, on a seq=4 pool, "
        "through the KV tiers, the kvtier_bench twin, a PD pair over CUDA "
        f"IPC at {MLA_PD_LAYERS} layers; the moe bench twin "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    m_launches = moe_phase(engine_mod, attention, page_dma,
                           (paged_attention, mq_paged_attention,
                            fused_decode_attention, cp.paged_partial), card)
    log(f"  phase 4m: {time.monotonic() - t:.1f} s")

    # Phase 4o (c), (g): Llama-3-70B int8 once every other weight is gone,
    # then the dry run.
    log(f"[4o] (c) llama3-70b int8 at full width, {TP70_LAYERS} of 80 "
        "layers, on model=8; (g) "
        "the dry run at the north-star sizes "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    t = time.monotonic()
    # 4u's processes start here: they warm up while (c) and (g) run.
    u_state = verified_start(phase4_config())
    try:
        o_c = tp70b_leg(engine_mod, llama, prompts, shared,
                        (paged_attention, mq_paged_attention,
                         fused_decode_attention, cp.paged_partial), card)
        log(f"  (c): {time.monotonic() - t:.1f} s")
        dryrun_leg(card)
    except BaseException:
        verified_stop(u_state)
        raise
    log(f"  phase 4o (c), (g): {time.monotonic() - t:.1f} s")

    # Phase 4u: the master and agent under the runtime verifiers, the
    # native hot core on and off, xlint over the port.
    log("[4u] the port's master and agent with the four runtime verifiers "
        "armed: master A on the native hot core, master B on its Python "
        f"path, an agent (llama3-8b at {AUTO_LAYERS} layers) SIGKILLed and "
        "replaced, xlint over the port "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated before)")
    u_launches = verified_phase(u_state, llama, engine_mod, u_refs, card)

    # Phase 4v: the service-plane bench twins on this card's host.
    log("[4v] the eight service-plane bench twins (master hot path, KV "
        "routing, generations ingest, tracing and profiler overhead, "
        "overload, outage, fleet), each against the port's master, "
        "coordination server and fake engines, held to the reference "
        "bench's gate")
    t = time.monotonic()
    services_phase(card)
    log(f"  phase 4v: {time.monotonic() - t:.1f} s")

    # Phase 5: the kernels line, the card line, the result.
    rows = []
    csrc = "xllm_service_tpu_torch/csrc/"
    for name, src, tpu, res, n in (
            ("paged_attention", csrc + "paged_attention.cu",
             "xllm_service_tpu/ops/pallas_paged_attention.py:107", k1,
             runs[0][1][0] + agent_launches[0] + g_launches[0]
             + h_launches[0] + i_launches[0] + j_launches[0]
             + k_launches[0] + l_launches[0] + s_launches[0]
             + m_launches["paged"]
             + n_launches["paged"] + o_a[0] + o_c[0]
             + m_launches["ep_paged"] + p_launches["paged_attention"]
             + r_launches[0] + t_launches[0] + u_launches[0]),
            ("mq_paged_attention", csrc + "mq_paged_attention.cu",
             "xllm_service_tpu/ops/pallas_mq_paged_attention.py:100", k2,
             runs[0][1][1] + agent_launches[1] + g_launches[1]
             + h_launches[1] + i_launches[1] + j_launches[1]
             + k_launches[1] + l_launches[1] + s_launches[1]
             + m_launches["mq"]
             + n_launches["mq"] + o_a[1] + o_c[1] + m_launches["ep_mq"]
             + p_launches["mq_paged_attention"] + q_launches["mq"]
             + r_launches[1] + t_launches[1] + u_launches[1]),
            ("fused_decode_attention", csrc + "fused_decode_attention.cu",
             "xllm_service_tpu/ops/pallas_fused_decode_attention.py:158", k3,
             fused_launches[0]),
            ("gather_kv_pages", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:222", k4,
             tier_launches[0] + i_launches[2] + s_launches[2]
             + m_launches["gather"]
             + n_launches["gather"] + o_b[0] + o_f[0] + q_launches["gather"]
             + q_launches["pd_gather"]),
            ("scatter_kv_pages", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:250", k5,
             tier_launches[1] + i_launches[3] + s_launches[3]
             + m_launches["scatter"]
             + n_launches["scatter"] + o_b[1] + o_f[1]
             + q_launches["scatter"] + q_launches["pd_scatter"]),
            ("cp_paged_partial", csrc + "cp_paged_partial.cu",
             "xllm_service_tpu/ops/cp_paged_attention.py:179", k6,
             cp_launches["partial"] + m_launches["partial"]
             + n_launches["partial"] + p_launches["cp_paged_partial"]
             + q_launches["partial"]),
            # The same kernels at this slice's new shapes, counted where
            # the main path runs them at those shapes.
            ("gather_kv_pages@mla_block", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:222", k4_mla,
             m_launches["mla_gather"]),
            ("scatter_kv_pages@mla_block", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:250", k5_mla,
             m_launches["mla_scatter"]),
            ("cp_paged_partial@group6", csrc + "cp_paged_partial.cu",
             "xllm_service_tpu/ops/cp_paged_attention.py:179", k6_g6,
             n_launches["partial"]),
            # A model shard's shapes (phase 4o): Llama-3-8B at model=4
            # (8/2 heads, group 4, its tier blocks) and Llama-3-70B at
            # model=8 (8/1, group 8).
            ("paged_attention@8/2_heads", csrc + "paged_attention.cu",
             "xllm_service_tpu/ops/pallas_paged_attention.py:107", k1_82,
             o_a[0]),
            ("paged_attention@8/1_heads", csrc + "paged_attention.cu",
             "xllm_service_tpu/ops/pallas_paged_attention.py:107", k1_81,
             o_c[0]),
            ("mq_paged_attention@group4", csrc + "mq_paged_attention.cu",
             "xllm_service_tpu/ops/pallas_mq_paged_attention.py:100",
             k2_groups[(8, 2)], o_a[1]),
            ("mq_paged_attention@group8", csrc + "mq_paged_attention.cu",
             "xllm_service_tpu/ops/pallas_mq_paged_attention.py:100",
             k2_groups[(8, 1)], o_c[1]),
            ("gather_kv_pages@model4_shard", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:222", k4_tp, o_b[0]),
            ("scatter_kv_pages@model4_shard", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:250", k5_tp,
             o_b[1]),
            # A seq x model grid shard's shapes (phase 4q): kernel 6 at a
            # model=2 shard's 16/4 heads ((a), (d)), the movers at a seq=2
            # x model=2 grid shard's block ((c)).
            ("cp_paged_partial@16/4_heads", csrc + "cp_paged_partial.cu",
             "xllm_service_tpu/ops/cp_paged_attention.py:179", k6_16_4,
             q_launches["partial_16_4"]),
            ("gather_kv_pages@grid_shard", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:222", k4_grid,
             q_launches["gather"]),
            ("scatter_kv_pages@grid_shard", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:250", k5_grid,
             q_launches["scatter"])):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": n, **res})
    log(f"  total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--decode-agent"]:
        sys.exit(decode_agent_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--checkpoint-agent"]:
        sys.exit(checkpoint_agent_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--mla-decode-agent"]:
        sys.exit(mla_decode_agent_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-decode-agent"]:
        sys.exit(tp_decode_agent_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--mh-rank"]:
        sys.exit(mh_rank_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--mh-agent"]:
        sys.exit(mh_agent_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--autoscaled-agent"]:
        sys.exit(autoscaled_agent_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--verified-master"]:
        sys.exit(verified_master_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--verified-agent"]:
        sys.exit(verified_agent_child(sys.argv[2:]))
    sys.exit(main())
